"""PyTorch port: solid obstacles (``models/solid_masks.py`` and the Brinkman
penalization of ``Navier2D.set_solid``) against the JAX package, on the
CPU.

The mask builders are the same numpy code in both packages (1e-15, and
1e-13 for the spectrally interpolated porosity mask: two 513-point
transforms and a 65-point one in another summation order); the
penalization factors are built from the same host math and the lift's
physical values (1e-14); the penalized step, five steps on every route,
is held in ``tests/test_torch_scenarios.py``.  Here: the factors on every
layout, the ``solid`` accessor, a removed obstacle giving back the plain
step bit for bit, the captured chunks dropped, and the physics checks of
the JAX package's ``tests/test_solid_masks.py`` (the flow stopped and the
temperature held inside a cylinder) on the port.
"""

import gc

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu.models import navier as jnavier
from rustpde_mpi_tpu.models import solid_masks as jmasks

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import workloads
from rustpde_mpi_tpu_torch.models import navier as tnavier
from rustpde_mpi_tpu_torch.models import solid_masks as tmasks
from rustpde_mpi_tpu_torch.models.boundary_conditions import bc_rbc_values

FIELDS = ("temp", "velx", "vely", "pres", "pseu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread (tiny grids); drop the JAX objects this module
    built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _cheb_grid(n):
    return -np.cos(np.pi * np.arange(n) / (n - 1))


def _assert_pair_equal(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.max(np.abs(g - w))) <= tol * max(float(np.max(np.abs(w))), 1.0)


# -- the mask builders -------------------------------------------------------------------


@pytest.mark.parametrize("grid", ["chebyshev", "uniform"])
def test_mask_builders_match_reference(grid):
    x = _cheb_grid(65) if grid == "chebyshev" else np.linspace(-1.0, 1.0, 64)
    y = _cheb_grid(33) if grid == "chebyshev" else np.linspace(-1.0, 1.0, 48)
    for name, args in (("solid_cylinder_inner", (0.2, -0.1, 0.3)),
                       ("solid_rectangle", (0.0, 0.5, 0.2, 0.1)),
                       ("solid_roughness_sinusoid", (0.1, 10.0)),
                       ("solid_porosity", (0.4, 0.8))):
        _assert_pair_equal(getattr(tmasks, name)(x, y, *args),
                           getattr(jmasks, name)(x, y, *args), 1e-15)
    d = np.linspace(-0.2, 0.2, 9)
    np.testing.assert_array_equal(tmasks._smooth_layer(d, 0.05), jmasks._smooth_layer(d, 0.05))


def test_porosity_interpolate_matches_reference():
    got = tmasks.solid_porosity_interpolate(65, 65, 0.4, 0.8)
    _assert_pair_equal(got, jmasks.solid_porosity_interpolate(65, 65, 0.4, 0.8), 1e-13)
    assert got[0].shape == (65, 65) and -0.3 < got[0].min() and got[0].max() < 1.3


# -- the penalization factors ------------------------------------------------------------


@pytest.mark.parametrize("layout", ["confined", "periodic_hc", "mesh"])
def test_brinkman_factors_match_reference(layout):
    periodic = layout == "periodic_hc"
    nx, bc = (16, "hc") if periodic else (17, "rbc")
    ref = rp.Navier2D(nx, 17, 1e4, 1.0, 5e-3, 1.0, bc, periodic=periodic)
    kw = dict(mesh=pt.make_mesh(4, "cpu")) if layout == "mesh" else dict(device="cpu")
    port = pt.Navier2D(nx, 17, 1e4, 1.0, 5e-3, 1.0, bc, periodic=periodic, **kw)
    mask, value = tmasks.solid_roughness_sinusoid(*port.x, 0.1, 10.0)
    for eta in (None, 2e-3):
        want = jnavier.brinkman_factors(ref, mask, value, eta)
        got = tnavier.brinkman_factors(port, mask, value, eta)
        also = workloads.penalization_factors(port, mask, value, eta)
        sp = port.field_space
        for g, a, w in zip(got, also, want):
            assert torch.equal(g, a)
            g = sp.gather_physical(g).numpy()
            w = np.asarray(w)
            assert float(np.max(np.abs(g - w))) <= 1e-14 * float(np.max(np.abs(w)))
        if layout == "mesh":
            # y-pencils: the pad holds 0 in both, so penalized pads stay zero
            pad = got[0] == 0
            assert torch.any(pad) and torch.all(got[1][pad] == 0)
    # no value: the solid relaxes the full temperature toward 0
    _, add = tnavier.brinkman_factors(port, mask)
    _, jadd = jnavier.brinkman_factors(ref, mask)
    _assert_pair_equal([port.field_space.gather_physical(add).numpy()], [jadd], 1e-14)


# -- set_solid and the solid accessor ----------------------------------------------------


@pytest.mark.parametrize("route", ["fused", "dense", "mesh"])
def test_set_solid_none_restores_the_plain_step(route):
    """An obstacle set and removed leaves the plain step bit for bit; the
    accessor round trips; each set_solid drops the captured chunks (they
    hold the old factors)."""
    kw = dict(mesh=pt.make_mesh(4, "cpu")) if route == "mesh" else dict(
        device="cpu", step_kernel=route, conv_kernel=route)
    model = pt.Navier2D.new_confined(17, 17, 1e4, 1.0, 0.01, 1.0, "rbc", **kw)
    plain = pt.Navier2D.new_confined(17, 17, 1e4, 1.0, 0.01, 1.0, "rbc", **kw)
    mask, value = tmasks.solid_cylinder_inner(*model.x, 0.0, 0.0, 0.3)
    model.update_n(1)
    plain.update_n(1)
    assert model._runners and model.solid is None
    model.solid = (mask, value)
    assert not model._runners
    np.testing.assert_array_equal(model.solid[0], mask)
    np.testing.assert_array_equal(model.solid[1], value)
    stepped = model._step(model.state)
    assert not torch.equal(stepped.velx, plain._step(plain.state).velx)
    model.update_n(1)
    model.solid = None
    assert model.solid is None and not model._runners
    model.state = plain.state
    model.update_n(4)
    plain.update_n(4)
    for name, a, b in zip(FIELDS, model.state, plain.state):
        assert torch.equal(a, b), name


def test_penalization_forces_zero_velocity():
    """A cylinder in a driven RBC cell (the JAX package's
    ``test_solid_masks.py`` check): after 100 steps the flow deep inside
    the solid is orders of magnitude weaker than in the fluid."""
    model = pt.Navier2D.new_confined(33, 33, 1e5, 1.0, 0.01, 1.0, "rbc", device="cpu")
    mask, value = tmasks.solid_cylinder_inner(*model.x, 0.0, 0.0, 0.3)
    model.set_solid(mask, value)
    model.set_velocity(0.2, 1.0, 1.0)
    model.set_temperature(0.2, 1.0, 1.0)
    model.update_n(100)
    assert not model.exit()
    speed = np.sqrt(model.get_field("velx") ** 2 + model.get_field("vely") ** 2)
    deep = mask > 0.99
    assert speed[deep].max() < 2e-3
    assert speed[~deep].max() > 50 * speed[deep].max()


def test_penalization_enforces_temperature():
    """A heated cylinder (0.3) holds the total temperature (the state plus
    the lift) at its value inside, to 5e-3 after 200 steps."""
    model = pt.Navier2D.new_confined(33, 33, 1e4, 1.0, 0.01, 1.0, "rbc", device="cpu",
                                     step_kernel="dense", conv_kernel="dense")
    mask, _ = tmasks.solid_cylinder_inner(*model.x, 0.0, 0.0, 0.25)
    model.set_solid(mask, np.full_like(mask, 0.3))
    model.update_n(200)
    xs, ys = (b.points for b in model.field_space.bases)
    total = model.get_field("temp") + bc_rbc_values(xs, ys)
    np.testing.assert_allclose(total[mask > 0.99], 0.3, atol=5e-3)

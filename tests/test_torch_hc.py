"""PyTorch port: horizontal-convection (HC) boundary conditions against the
JAX package.

``bc="hc"`` heats the bottom plate with a cosine profile and insulates the
top, so the temperature's y base is Dirichlet-Neumann
(``cheb_dirichlet_neumann``), whose stencil couples rows of both parities:
its Helmholtz solve along y runs the banded kernel's general path (one
chain a lane) on the dense and meshed routes.  The same numpy-seeded inputs
go through the JAX package (on the CPU, in f64; its Pallas kernels in
interpret mode on the fused route) and the port (``device="cpu"``, every
kernel wrapper its plain version).  Tolerances, relative to each result's
max magnitude: 1e-14 for the host operators and the lift (the same numpy
math; the lift's derivatives to 1e-13 and 1e-12), 1e-12 for the solves,
1e-11 for five steps of each route (the same algebra summed in other
orders).  Grids are 17^2 (confined) and 16x17
(periodic); the meshed route runs on 4 ranks against the JAX meshed model
on 4 of the conftest's virtual devices.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu import bases as jb
from rustpde_mpi_tpu import solver as jsolver
from rustpde_mpi_tpu.models import boundary_conditions as jbcs
from rustpde_mpi_tpu.parallel.mesh import AXIS

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import bases as tb
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch import solver as tsolver
from rustpde_mpi_tpu_torch.models import boundary_conditions as tbcs

FIELDS = ("temp", "velx", "vely", "pres", "pseu")
MODEL = dict(ra=1e4, pr=1.0, dt=5e-3, aspect=1.0)
NRANKS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread (tiny grids); drop the JAX bases this module
    built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    diff = float(np.max(np.abs(got - want)))
    assert diff <= tol * scale, (diff, scale)


def _assert_state_close(got, ref, tol):
    for name in FIELDS:
        want = np.asarray(getattr(ref.state, name))
        scale = max(float(np.max(np.abs(want))), 1e-300)
        diff = float(np.max(np.abs(got[name] - want)))
        assert diff <= tol * scale, (name, diff, scale)


def _ref(nx, periodic, fused=False, mesh=None):
    """The JAX package's HC model: its default (dense) step, or its fused
    route with both Pallas kernels (interpret mode)."""
    with pytest.MonkeyPatch.context() as mp:
        if fused:
            mp.setenv("RUSTPDE_STEP_KERNEL", "pallas")
            mp.setenv("RUSTPDE_CONV_KERNEL", "pallas")
        model = rp.Navier2D(nx, 17, *MODEL.values(), "hc", periodic=periodic, mesh=mesh)
    assert (model._step_impl is not None) == fused
    return model


# -- the base, its solves and the lift ---------------------------------------------------


@pytest.mark.parametrize("n", [17, 33])
def test_dirichlet_neumann_base_matches_reference(n):
    tbase, jbase = tb.cheb_dirichlet_neumann(n), jb.cheb_dirichlet_neumann(n)
    assert tbase.kind.value == jbase.kind.value and tbase.m == jbase.m == n - 2
    np.testing.assert_array_equal(tbase.stencil, jbase.stencil)
    _close(tbase.projection, jbase.projection, 1e-14)
    np.testing.assert_array_equal(tbase.points, jbase.points)
    np.testing.assert_array_equal(tbase.dealias_cut(), jbase.dealias_cut())
    for order in (1, 2):
        _close(tbase.gradient_matrix(order), jbase.gradient_matrix(order), 1e-14)
    for key in ("fwd", "fwd_cut", "bwd", "synthesis", "stencil", "proj", ("bwd_grad", 1),
                ("grad", 2)):
        _close(tbase.axis_operator(key).matrix, jbase.axis_operator(key).matrix, 1e-14)
    # every composite function vanishes at x = -1 and is flat at x = +1
    ortho = tbase.stencil
    k = np.arange(n)
    assert np.abs(((-1.0) ** k) @ ortho).max() < 1e-13
    assert np.abs((k**2.0) @ ortho).max() < 1e-13 * n**2
    # its stencil has terms off the diagonal's parity: the general banded path
    assert np.any(ortho[1:, :][np.arange(n - 2), np.arange(n - 2)])


def test_lift_profiles_match_reference():
    xs, ys = tb.chebyshev(17).points, tb.chebyshev(13).points
    xp = tb.fourier_r2c(16).points
    for x in (xs, xp):
        for name in ("bc_rbc_values", "bc_hc_values", "pres_bc_rbc_values"):
            np.testing.assert_array_equal(getattr(tbcs, name)(x, ys), getattr(jbcs, name)(x, ys))
        np.testing.assert_array_equal(tbcs.bc_zero_values(x, ys, 3.0),
                                      jbcs.bc_zero_values(x, ys, 3.0))
    np.testing.assert_array_equal(tbcs.transfer_function(ys, 0.5, 0.0, -0.5, 2.0),
                                  jbcs.transfer_function(ys, 0.5, 0.0, -0.5, 2.0))
    assert set(tbcs.TEMPERATURE_LIFTS) == {"rbc", "hc"}


@pytest.mark.parametrize("periodic", [False, True], ids=["confined", "periodic"])
def test_model_lift_matches_reference(periodic):
    nx = 16 if periodic else 17
    ref = _ref(nx, periodic)
    port = pt.Navier2D(nx, 17, *MODEL.values(), "hc", periodic=periodic, device="cpu")
    assert port.temp_space.bases[1].kind == tb.BaseKind.CHEB_DIRICHLET_NEUMANN
    # the lift to 1e-14; its derivatives to 1e-13 (first) and 1e-12 (the
    # second-derivative diffusion source): a Chebyshev derivative of order
    # k amplifies the transforms' rounding by up to n^(2k)
    for key, want, tol in (("ortho", ref.tempbc_ortho, 1e-14), ("dx", ref._tempbc_dx, 1e-13),
                           ("dy", ref._tempbc_dy, 1e-13), ("diff", ref._tempbc_diff, 1e-12)):
        _close(port.host_bc[key], want, tol)
    # the lift heats the bottom plate with the cosine and leaves the top at 0
    lift = tbcs.bc_hc_values(*(b.points for b in port.field_space.bases))
    assert np.abs(lift[:, -1]).max() == 0.0 and abs(lift[0, 0] + 0.5) < 1e-15


def test_modal_data_of_the_dirichlet_neumann_axis_matches_reference():
    """The fast-diagonal data of the HC temperature's y axis: no parity
    blocks (its pencil is not a checkerboard), real eigenvalues."""
    tsp = tb.Space2(tb.cheb_neumann(17), tb.cheb_dirichlet_neumann(17), device="cpu",
                    dtype=torch.float64)
    jsp = jb.Space2(jb.cheb_neumann(17), jb.cheb_dirichlet_neumann(17))
    mat_c, mat_a, precond = tsolver.ingredients_for_hholtz(tsp, 1)
    assert tsolver._checker_shift(mat_c) is None and tsolver._checker_shift(mat_a) is None
    for sign in (1.0, -1.0):
        lam, fwd, bwd = tsolver._axis_modal_data(tsp, 1, 2e-3, sign)
        jlam, jfwd, jbwd = jsolver._axis_modal_data(jsp, 1, 2e-3, sign)
        _close(lam, jlam, 1e-12)
        _close(bwd @ np.diag(lam) @ fwd, jbwd @ np.diag(jlam) @ jfwd, 1e-12)
        # the maps undo each other: bwd @ fwd is the preconditioned inverse
        _close(bwd @ fwd, np.linalg.solve(mat_c, precond), 1e-12)
    # the Helmholtz solver of the whole space (fast diagonalisation) agrees
    # with the reference's
    rhs = np.random.default_rng(4).standard_normal(tsp.shape_physical)
    got = tsolver.Hholtz(tsp, (1e-3, 2e-3), method="fd").solve(torch.as_tensor(rhs))
    want = jsolver.Hholtz(jsp, (1e-3, 2e-3), method="fd").solve(jnp.asarray(rhs))
    _close(got, want, 1e-12)


def test_temperature_solve_runs_the_general_banded_path():
    """HC's ADI temperature solve: the y axis's band couples both parities,
    so its kernel takes the general path (one chain a lane); the chain
    layout's plain version equals the plain recurrence bit for bit, the
    solve equals the dense inverse's and the reference's HholtzAdi to
    1e-12."""
    tsp = tb.Space2(tb.cheb_neumann(17), tb.cheb_dirichlet_neumann(17), device="cpu",
                    dtype=torch.float64)
    jsp = jb.Space2(jb.cheb_neumann(17), jb.cheb_dirichlet_neumann(17))
    c = (2e-3, 3e-3)
    adi = pt.HholtzAdi(tsp, c)
    assert [k.path for k in adi.kernels()] == ["parity", "general"]
    kernel = adi.solvers[1].solver.kernel
    assert kernel.systems == 1 and kernel.chain_lower.shape[0] == 4
    rng = np.random.default_rng(5)
    b = torch.as_tensor(rng.standard_normal((3, 15, 17)))
    assert torch.equal(kernel.plain_chains(b), kernel.plain(b))
    rhs = rng.standard_normal(tsp.shape_physical)
    got = adi.solve(torch.as_tensor(rhs))
    _close(got, pt.HholtzAdi(tsp, c, method="dense").solve(torch.as_tensor(rhs)), 1e-12)
    _close(got, jsolver.HholtzAdi(jsp, c).solve(jnp.asarray(rhs)), 1e-12)


# -- the whole model ------------------------------------------------------------------


@pytest.mark.parametrize("route", ["dense", "fused"])
@pytest.mark.parametrize("periodic", [False, True], ids=["confined", "periodic"])
def test_five_steps_match_reference(route, periodic):
    nx = 16 if periodic else 17
    ref = _ref(nx, periodic, fused=route == "fused")
    ref.init_random(0.1, seed=0)
    port = pt.Navier2D(nx, 17, *MODEL.values(), "hc", periodic=periodic, device="cpu",
                       step_kernel=route, conv_kernel=route)
    port.init_random(0.1, seed=0)
    _assert_state_close(convert.state_to_numpy(port), ref, 1e-13)
    ref.update_n(5)
    for _ in range(5):
        port.update()
    _assert_state_close(convert.state_to_numpy(port), ref, 1e-11)
    for g, w in zip(port.get_observables(), ref.get_observables()):
        assert g == pytest.approx(float(w), rel=1e-10)
    kernels = port.kernels()
    if route == "dense":
        paths = [k.path for k in kernels["banded_solve"]]
        # the temperature's y solve is the one general-path kernel
        assert paths.count("general") == 1
    assert sum(k.launches for ks in kernels.values() for k in ks) == 0


def test_meshed_confined_matches_reference_meshed():
    jmesh = JaxMesh(np.array(jax.devices()[:NRANKS]), (AXIS,))
    ref = _ref(17, False, mesh=jmesh)
    ref.init_random(0.1, seed=0)
    port = pt.Navier2D(17, 17, *MODEL.values(), "hc", device="cpu",
                       mesh=pt.make_mesh(NRANKS, "cpu"))
    port.init_random(0.1, seed=0)
    ref.update_n(5)
    port.update_n(5)
    _assert_state_close(convert.state_to_numpy(port), ref, 1e-11)
    assert [k.path for k in port.kernels()["banded_solve"]].count("general") == 1


def test_jax_hc_state_carried_through_convert():
    ref = _ref(17, False)
    ref.init_random(0.1, seed=3)
    ref.update_n(2)
    arrays = {f: np.asarray(getattr(ref.state, f)) for f in FIELDS}
    port = pt.Navier2D(17, 17, *MODEL.values(), "hc", device="cpu", step_kernel="dense",
                       conv_kernel="dense")
    convert.state_from_numpy(port, arrays)
    _assert_state_close(convert.state_to_numpy(port), ref, 0.0)
    ref.update_n(3)
    port.update_n(3)
    _assert_state_close(convert.state_to_numpy(port), ref, 1e-11)


# -- the JAX package's physics checks ---------------------------------------------------


def test_hc_boundary_condition_runs():
    model = pt.Navier2D.new_confined(17, 17, 1e4, 1.0, 0.01, 1.0, "hc", device="cpu")
    model.update_n(10)
    for arr in model.state:
        assert torch.all(torch.isfinite(arr))


def test_periodic_hc_runs_and_convects():
    """Horizontally periodic horizontal convection (the reference's
    ``navier_periodic_hc_mpi`` configuration): the cosine bottom heating
    drives a finite circulation."""
    model = pt.Navier2D.new_periodic(16, 17, 1e5, 1.0, 0.01, 1.0, "hc", device="cpu",
                                     step_kernel="dense", conv_kernel="dense")
    model.set_velocity(0.2, 1.0, 1.0)
    model.set_temperature(0.2, 1.0, 1.0)
    model.update_n(100)
    nu, nuvol, re, div = model.get_observables()
    assert np.isfinite([nu, nuvol, re, div]).all()
    assert re > 0.1  # the flow moves
    assert div < 1e-1


def test_set_velocity_and_temperature_match_reference():
    ref = _ref(16, True)
    port = pt.Navier2D(16, 17, *MODEL.values(), "hc", periodic=True, device="cpu")
    for m in (ref, port):
        m.set_velocity(0.2, 1.0, 1.0)
        m.set_temperature(0.2, 1.0, 1.0)
    _assert_state_close(convert.state_to_numpy(port), ref, 1e-13)


# -- the two routes against each other, as the reference's own routes differ ---------------


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, whose card checks hold the
    routes to the limits this file measures."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", ["hc129", "hc_periodic128"])
def test_routes_differ_as_the_reference_routes_do(cell):
    """The fused route against the dense one after 10 steps at the card's
    HC correctness sizes, in the JAX package (its fused route in interpret
    mode) and in the port on the CPU: the two routes solve the Poisson
    problem by other algorithms (fast diagonalisation against the banded
    tensor solver), whose roundings the nudged singular mode amplifies, so
    ``pseu`` differs by more than 1e-11 of its scale in the reference
    itself.  The port's difference stays within twice the reference's (or
    1e-11), and the reference's within the limits ``chip_smoke.py`` holds
    the card's routes to (1e-11, pseu ``PSEU_ROUTES_LIMIT``), near the
    values it prints as the reference's (``REFERENCE_ROUTES_DIFF``)."""
    smoke = _chip_smoke()
    cfg = dict(smoke.HC_CELLS[cell])
    periodic = cfg.pop("periodic", False)
    states = {}
    for route in ("fused", "dense"):
        with pytest.MonkeyPatch.context() as mp:
            if route == "fused":
                mp.setenv("RUSTPDE_STEP_KERNEL", "pallas")
                mp.setenv("RUSTPDE_CONV_KERNEL", "pallas")
            ref = rp.Navier2D(*cfg.values(), periodic=periodic)
        port = pt.Navier2D(*cfg.values(), periodic=periodic, device="cpu", step_kernel=route,
                           conv_kernel=route)
        for m in (ref, port):
            m.init_random(0.1, seed=0)
            m.update_n(10)
        states[route] = ({f: np.asarray(getattr(ref.state, f)) for f in FIELDS},
                         convert.state_to_numpy(port))

    def rel(which, name):
        a, b = states["fused"][which][name], states["dense"][which][name]
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    limits = {"pseu": smoke.PSEU_ROUTES_LIMIT}
    for name in FIELDS:
        ref_diff, port_diff = rel(0, name), rel(1, name)
        print(f"{cell} fused vs dense, 10 steps, {name}: reference {ref_diff:.3e}, "
              f"port {port_diff:.3e}")
        assert ref_diff <= limits.get(name, 1e-11), (name, ref_diff)
        assert port_diff <= max(2.0 * ref_diff, 1e-11), (name, port_diff, ref_diff)
        recorded = smoke.REFERENCE_ROUTES_DIFF[cell].get(name)
        if recorded is not None:  # the reference's difference chip_smoke.py prints
            assert 0.5 * recorded <= ref_diff <= 2.0 * recorded, (name, ref_diff, recorded)

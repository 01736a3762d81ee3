"""PyTorch port: the meshed periodic model (Fourier r2c x Chebyshev on
pencils) against the JAX package, on the CPU.

``Navier2D(..., periodic=True, mesh=make_mesh(P))`` holds its complex
spectral state in x-pencils: the Fourier x axis transforms on ``torch.fft``
on the x-pencil (which holds it whole), the y-axis factors and the
per-mode solves run on complex y-pencils, so the pencil flips move complex
pencils and the banded kernel takes the real and imaginary parts as two
planes whose lanes' factor sets are offset by the rank.  On a CPU tensor
every wrapper runs its plain version.  These tests hold, on the same numpy
inputs:

* the complex flip's plain ring bit for bit against ``permute(...)
  .contiguous()`` and the JAX package's transposes, and complex placement
  and gather exactly;
* every transform of a Fourier x pencil space and its solvers against the
  port's serial space to 1e-12 of the result's scale;
* 10 meshed steps (``"rbc"`` and ``"hc"`` at 32x17, the non-divisible
  20x17 on 2 and 4 ranks) within 1e-11 of each field's scale of the JAX
  package's meshed periodic model (``tests/test_parallel.py:203-241``) on
  as many of the conftest's virtual devices, and of the port's serial dense
  route;
* ``update_n(7)`` chunks, the sentinels armed against the plain chunk bit
  for bit, and ``convert.py`` round trips of the meshed complex state (the
  JAX TPU's split Re/Im layout too).

The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py).
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
from rustpde_mpi_tpu.parallel import decomp as jdecomp
from rustpde_mpi_tpu.parallel.mesh import AXIS

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch.parallel import decomp as tdecomp
from rustpde_mpi_tpu_torch.parallel import make_mesh

FIELDS = ("temp", "velx", "vely", "pres", "pseu")
NY = 17


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread (tiny grids); drop the JAX bases this module
    built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _jax_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), (AXIS,))


def _close(got, want, tol, scale=None):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-300) if scale is None else scale
    diff = float(np.max(np.abs(got - want)))
    assert diff <= tol * scale, (diff, scale)


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# -- the complex flip, placement and gather ---------------------------------------------


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("nranks", [2, 4])
def test_complex_flip_plain_equals_the_permuted_copy(dtype, nranks):
    mesh = make_mesh(nranks, "cpu")
    ring = mesh.ring
    c, w = 3, 5
    x = torch.as_tensor(_cplx((nranks, nranks * c, w), 1)).to(dtype)
    y = ring.x_to_y(x)
    want = x.view(nranks, nranks, c, w).permute(1, 2, 0, 3).contiguous().view(nranks, c, nranks * w)
    assert y.dtype == dtype and torch.equal(y, want)
    back = ring.y_to_x(y)
    assert torch.equal(back, x)
    want_back = y.view(nranks, c, nranks, w).permute(2, 0, 1, 3).contiguous().view(
        nranks, nranks * c, w)
    assert torch.equal(back, want_back)
    assert ring.launches == 0  # the plain ring on the CPU
    with pytest.raises(ValueError, match="dtype"):
        ring.x_to_y(x.real.to(torch.float16))


@pytest.mark.parametrize("nx", [16, 15, 20])
def test_complex_placement_and_transposes_match_jax(nx):
    """The periodic spectral shape (nx//2+1 modes, padded to the rank
    count) placed, gathered and repartitioned: exactly, and as the JAX
    package's transposes move the same complex values."""
    shape = (nx // 2 + 1, NY - 2)
    a = _cplx(shape, nx)
    port = tdecomp.Decomp2d(shape, make_mesh(4, "cpu"))
    ref = jdecomp.Decomp2d(shape, _jax_mesh(4))
    for pencil in ("x", "y"):
        placed = tdecomp.scatter_root(a, port, pencil, torch.complex128)
        assert placed.dtype == torch.complex128
        np.testing.assert_array_equal(tdecomp.gather_root(placed, port, pencil), a)
    xy = jax.jit(lambda v: ref.transpose_x_to_y(v, method="ring"))(jnp.asarray(a))
    yx = jax.jit(lambda v: ref.transpose_y_to_x(v, method="ring"))(jnp.asarray(a))
    np.testing.assert_array_equal(port.transpose_x_to_y(torch.as_tensor(a)).numpy(),
                                  np.asarray(xy))
    np.testing.assert_array_equal(port.transpose_y_to_x(torch.as_tensor(a)).numpy(),
                                  np.asarray(yx))


# -- the pencil space of a Fourier x axis, and its solvers ---------------------------------


def _spaces(nx, by, nranks=4):
    bases = (pt.fourier_r2c(nx), by(NY))
    serial = pt.Space2(*bases, device="cpu", dtype=torch.float64)
    mesh = make_mesh(nranks, "cpu")
    return serial, pt.parallel.PencilSpace2(pt.Space2(*bases, device="cpu", dtype=torch.float64),
                                            mesh)


@pytest.mark.parametrize("nx", [16, 15])
def test_fourier_pencil_space_matches_serial(nx):
    serial, space = _spaces(nx, pt.cheb_dirichlet)
    assert space.spectral_is_complex and space.ndarray_spectral().dtype == torch.complex128
    rng = np.random.default_rng(3)
    phys = torch.as_tensor(rng.standard_normal(serial.shape_physical))
    spec = serial.forward(phys)
    ortho = serial.to_ortho(spec)
    ps, pp = space.place_spectral(spec.numpy()), space.place_physical(phys)
    cases = [
        ("forward", space.forward(pp), serial.forward(phys), True),
        ("backward", space.backward(ps), serial.backward(spec), False),
        ("backward_fast", space.backward_fast(ps), serial.backward_fast(spec), False),
        ("backward_ortho", space.backward_ortho(space.place_spectral(ortho.numpy())),
         serial.backward_ortho(ortho), False),
        ("to_ortho", space.to_ortho(ps), ortho, True),
    ]
    for deriv in ((1, 0), (0, 1), (2, 0), (1, 1)):
        cases.append((f"gradient{deriv}", space.gradient(ps, deriv, (2.0, 1.0)),
                      serial.gradient(spec, deriv, (2.0, 1.0)), True))
        cases.append((f"backward_gradient{deriv}", space.backward_gradient(ps, deriv, (2.0, 1.0)),
                      serial.backward_gradient(spec, deriv, (2.0, 1.0)), False))
    cases.append(("pin_zero_mode", space.pin_zero_mode(ps), serial.pin_zero_mode(spec), True))
    for name, got, want, spectral in cases:
        decomp = tdecomp.Decomp2d(tuple(want.shape), space.mesh)
        gathered = decomp.gather_x_pencil(got) if spectral else decomp.gather_y_pencil(got)
        _close(gathered, want, 1e-12, max(float(want.abs().max()), 1e-300))
        placed = decomp.place_x_pencil(gathered) if spectral else decomp.place_y_pencil(gathered)
        assert torch.equal(placed, got), f"{name}: nonzero pad"
    pinned = space.gather_spectral(space.pin_zero_mode(ps))
    assert pinned[0, 0] == 0 and torch.equal(pinned[1:], spec[1:])
    w = space.place_physical(np.ones(serial.shape_physical))
    assert float(space.weighted_sum(pp, w)) == pytest.approx(float(phys.sum()), rel=1e-13)


@pytest.mark.parametrize("nx", [16, 20])
@pytest.mark.parametrize("by", ["cheb_dirichlet", "cheb_dirichlet_neumann"])
def test_fourier_pencil_solvers_match_serial(nx, by):
    serial, space = _spaces(nx, getattr(pt, by))
    rhs = torch.as_tensor(_cplx(serial.shape_spectral, 5))
    ortho = tdecomp.Decomp2d(serial.shape_spectral, space.mesh)
    for make in (lambda sp: pt.HholtzAdi(sp, (1e-3, 2e-3)),
                 lambda sp: pt.Poisson(sp, (1.0, 1.0)),
                 lambda sp: pt.Hholtz(sp, (0.1, 0.1))):
        serial_solver, pencil_solver = make(serial), make(space)
        # a composite rhs stands in for the ortho one: both spaces take the
        # same (m0, m1) complex array
        want = serial_solver.solve(serial.to_ortho(rhs))
        got = pencil_solver.solve(space.to_ortho(ortho.place_x_pencil(rhs)))
        _close(space.gather_spectral(got), want, 1e-12)
        assert torch.equal(space.place_spectral(space.gather_spectral(got).numpy()), got)
        # the Fourier axis solves by a diagonal: one banded kernel a solver
        assert len(pencil_solver.kernels()) == 1
        assert [k.path for k in pencil_solver.kernels()] == \
            [k.path for k in serial_solver.kernels()]


# -- the meshed model against the JAX meshed model --------------------------------------------


def _build(model_cls, nx, bc, **kw):
    model = model_cls(nx, NY, 1e4, 1.0, 5e-3, 1.0, bc, periodic=True, **kw)
    model.set_velocity(0.1, 1.0, 1.0)
    model.set_temperature(0.1, 1.0, 1.0)
    return model


def _assert_state_close(got, want, tol):
    for name in FIELDS:
        scale = max(float(np.max(np.abs(want[name]))), 1e-300)
        diff = float(np.max(np.abs(got[name] - want[name])))
        assert diff <= tol * scale, (name, diff, scale)


@pytest.mark.parametrize("nx, bc, nranks", [(32, "rbc", 4), (32, "hc", 4), (20, "rbc", 4),
                                            (20, "hc", 2)],
                         ids=["32x17-rbc-4", "32x17-hc-4", "20x17-rbc-4", "20x17-hc-2"])
def test_meshed_periodic_matches_jax_meshed_and_serial(nx, bc, nranks):
    ref = _build(rp.Navier2D, nx, bc, mesh=_jax_mesh(nranks))
    port = _build(pt.Navier2D, nx, bc, device="cpu", mesh=make_mesh(nranks, "cpu"))
    serial = _build(pt.Navier2D, nx, bc, device="cpu", step_kernel="dense", conv_kernel="dense")
    assert port.state.temp.dtype == torch.complex128 and port.state.temp.shape[0] == nranks
    ref.update_n(10)
    port.update_n(10)
    serial.update_n(10)
    want = {f: np.asarray(getattr(ref.state, f)) for f in FIELDS}
    _assert_state_close(convert.state_to_numpy(port), want, 1e-11)
    # the serial route to 1e-11 too: the trigonometric velocities are nearly
    # divergence-free, so pseu is ~1e-6 of the other fields and its relative
    # rounding reaches 2.5e-12 at 20x17
    _assert_state_close(convert.state_to_numpy(port), convert.state_to_numpy(serial), 1e-11)
    for g, w in zip(port.get_observables(), ref.get_observables()):
        assert g == pytest.approx(float(w), rel=1e-10, abs=1e-13)
    for name in ("temp", "velx"):
        _close(port.get_field(name), ref.get_field(name), 1e-12)
    assert port.time == pytest.approx(ref.time)


def test_meshed_periodic_step_flips_and_solves():
    """A meshed periodic step flips 37 times (26 of them complex pencils)
    and runs 4 banded solves, each one launch of a complex y-pencil as two
    planes of real lanes (the counts chip_smoke.py pins on the card); the
    HC temperature's solve takes the general path."""
    for bc, paths in (("rbc", ["parity"] * 4), ("hc", ["parity"] * 3 + ["general"])):
        mesh = make_mesh(4, "cpu")
        model = pt.Navier2D(16, NY, 1e4, 1.0, 5e-3, 1.0, bc, periodic=True, device="cpu",
                            mesh=mesh)
        model.init_random(0.1)
        flips = []
        plain = mesh.ring.plain
        mesh.ring.plain = lambda b, x_to_y: flips.append(b.dtype) or plain(b, x_to_y)
        solves = []
        for k in model.kernels()["banded_solve"]:
            kplain = k.plain
            k.plain = lambda b, f=0, q=0, kp=kplain, k=k: solves.append((tuple(b.shape), f, k.path)) \
                or kp(b, f, q)
        model.update()
        assert len(flips) == 37 and flips.count(torch.complex128) == 26
        # 9 modes pad to 12: 3 a rank; 15 rows pad to 16
        assert [s[0] for s in solves] == [(2, 4, 16, 3)] * 4
        assert [s[1] for s in solves] == [0, 0, 3, 0]  # the Poisson lanes offset by the rank
        assert [s[2] for s in solves] == paths
        flips.clear()
        model.get_observables()
        assert len(flips) == 10


def test_meshed_periodic_chunks_and_sentinels():
    ref = _build(rp.Navier2D, 32, "rbc", mesh=_jax_mesh(4))
    port = _build(pt.Navier2D, 32, "rbc", device="cpu", mesh=make_mesh(4, "cpu"))
    ref.update_n(7)
    port.update_n(7)
    want = {f: np.asarray(getattr(ref.state, f)) for f in FIELDS}
    _assert_state_close(convert.state_to_numpy(port), want, 1e-11)
    start, t0 = port.state, port.time
    port.update_n(3)
    plain = port.state
    port.state, port.time = start, t0
    port.set_stability(pt.StabilityConfig())
    status = port.update_n(3)
    assert status.steps_done == 3 and status.finite and status.cfl_ok
    assert all(isinstance(v, float) and np.isfinite(v)
               for v in (status.cfl_max, status.ke, status.div_max))
    for a, b in zip(port.state, plain):
        assert torch.equal(a, b)
    # the freeze: a NaN in temp's mode 0 stops the chunk after one step
    bad = start._replace(temp=start.temp.clone())
    bad.temp.view(-1)[0] = float("nan")
    port.set_stability(None)
    _, done = port.step_n(bad, 5)
    assert int(done) == 1


@pytest.mark.parametrize("split", [False, True])
def test_meshed_complex_state_carried_through_convert(split):
    ref = _build(rp.Navier2D, 20, "hc", mesh=_jax_mesh(4))
    ref.update_n(2)
    arrays = {f: np.asarray(getattr(ref.state, f)) for f in FIELDS}
    if split:  # the JAX package's TPU layout of the Fourier axis
        arrays = {f: jb.fourier_r2c_split(20).from_complex(a, axis=0) for f, a in arrays.items()}
        assert not np.iscomplexobj(arrays["temp"])
    port = _build(pt.Navier2D, 20, "hc", device="cpu", mesh=make_mesh(4, "cpu"))
    convert.state_from_numpy(port, arrays, split=split)
    back = convert.state_to_numpy(port)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(ref.state, f)))
    # the pads stay zero: the state placed again is the same pencils
    again = _build(pt.Navier2D, 20, "hc", device="cpu", mesh=make_mesh(4, "cpu"))
    convert.state_from_numpy(again, back)
    for a, b in zip(again.state, port.state):
        assert torch.equal(a, b)
    ref.update_n(3)
    port.update_n(3)
    _assert_state_close(convert.state_to_numpy(port),
                        {f: np.asarray(getattr(ref.state, f)) for f in FIELDS}, 1e-11)


@pytest.mark.parametrize("periodic", [False, True], ids=["confined", "periodic"])
def test_meshed_flips_get_the_kernels_layout(periodic, monkeypatch):
    """The pencil-transpose kernel takes pencils whose last axis has unit
    stride (an FFT along axis 1 leaves its output's strides permuted, so
    the pencil space makes its FFT factors' results contiguous).  With the
    banded solves' results in their input's layout, as the banded kernel
    leaves them on a card, every flip of a meshed step and of the
    observables meets that contract on the CPU too."""
    from rustpde_mpi_tpu_torch.ops import banded_solve

    plain = banded_solve.BandedSolve.plain

    def kernel_layout(self, b, factor_batch_stride=0, factor_batch_period=0):
        return torch.empty_like(b).copy_(plain(self, b, factor_batch_stride, factor_batch_period))

    monkeypatch.setattr(banded_solve.BandedSolve, "apply", kernel_layout)
    mesh = make_mesh(4, "cpu")
    strides = []
    ring_plain = mesh.ring.plain
    mesh.ring.plain = lambda b, x_to_y: strides.append(b.stride(2)) or ring_plain(b, x_to_y)
    model = pt.Navier2D(16 if periodic else 17, NY, 1e4, 1.0, 5e-3, 1.0, "hc", periodic=periodic,
                        device="cpu", mesh=mesh)
    model.init_random(0.1)
    model.update()
    model.get_observables()
    assert len(strides) == 3 + 37 + 10 and set(strides) == {1}

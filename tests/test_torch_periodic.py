"""PyTorch port: the horizontally periodic cell (Fourier r2c x Chebyshev)
against the JAX package.

The same numpy-seeded inputs go through the JAX functions (on the CPU, in
f64; its Pallas kernels in interpret mode) and the port's (``device="cpu"``,
where every kernel wrapper runs its plain version).  Tolerances, relative
to each result's max magnitude: 1e-12 for the transforms (FFTs against
FFTs and against the dense products), the solvers and the plain kernel
chains (the same algebra, summed in another order); 1e-11 for five steps
and a chunk of the whole model on each route (the port transforms its
Chebyshev axis by FFT on the CPU, as the reference does).  Grids are 16x17
and, for the odd-n Nyquist branch, 15x17.
"""

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu import bases as jb
from rustpde_mpi_tpu import field as jfield
from rustpde_mpi_tpu import solver as jsolver
from rustpde_mpi_tpu.ops import chebyshev as jchb
from rustpde_mpi_tpu.ops import fourier as jfou
from rustpde_mpi_tpu.ops import transforms as jtr
from rustpde_mpi_tpu.ops.pallas_conv import FusedConv as JFusedConv

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import bases as tb
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch import field as tfield
from rustpde_mpi_tpu_torch import solver as tsolver
from rustpde_mpi_tpu_torch.ops import banded as tbanded
from rustpde_mpi_tpu_torch.ops import fourier as tfou
from rustpde_mpi_tpu_torch.ops import transforms as ttr
from rustpde_mpi_tpu_torch.ops.fused_conv import FusedConv

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


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    diff = float(np.max(np.abs(got - want)))
    assert diff <= tol * scale, (diff, scale)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rand(shape, seed, cplx=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    return a + 1j * rng.standard_normal(shape) if cplx else a


# -- host builders and transforms -------------------------------------------------------


@pytest.mark.parametrize("n", [15, 16])
def test_fourier_host_builders_match_reference(n):
    for fn in ("fourier_points", "wavenumbers_r2c", "wavenumbers_c2c", "split_forward_matrix",
               "split_backward_matrix"):
        np.testing.assert_array_equal(getattr(tfou, fn)(n), getattr(jfou, fn)(n))
    for order in (1, 2, 3, 4):
        np.testing.assert_array_equal(tfou.split_diff_matrix(n, order),
                                      jfou.split_diff_matrix(n, order))
        for r2c in (True, False):
            k = tfou.wavenumbers_r2c(n) if r2c else tfou.wavenumbers_c2c(n)
            np.testing.assert_array_equal(tfou.diff_diag(k, order, n, r2c),
                                          jfou.diff_diag(k, order, n, r2c))
    # the split matrices are the r2c transform pair
    v = _rand(n, 1)
    np.testing.assert_allclose(tb.to_complex(tfou.split_forward_matrix(n) @ v),
                               np.fft.rfft(v) / n, rtol=0, atol=1e-14)
    np.testing.assert_allclose(tfou.split_backward_matrix(n) @ tfou.split_forward_matrix(n) @ v,
                               v, rtol=0, atol=1e-13)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("cplx", [False, True])
def test_chebyshev_fft_transforms_match_reference_and_products(axis, cplx):
    a = _rand((NY, 9) if axis == 0 else (9, NY), 2, cplx)
    fwd = ttr.cheb_forward_fft(_t(a), axis)
    _close(fwd, jtr.cheb_forward_fft(jnp.asarray(a), axis), 1e-12)
    _close(fwd, jtr.apply_matrix(jchb.analysis_matrix(NY), jnp.asarray(a), axis), 1e-12)
    bwd = ttr.cheb_backward_fft(_t(a), axis)
    _close(bwd, jtr.cheb_backward_fft(jnp.asarray(a), axis), 1e-12)
    _close(bwd, jtr.apply_matrix(jchb.synthesis_matrix(NY), jnp.asarray(a), axis), 1e-12)
    for order in (1, 2):
        der = ttr.cheb_derivative(_t(a), order, axis)
        _close(der, jtr.cheb_derivative(jnp.asarray(a), order, axis), 1e-12)
        _close(der, jtr.apply_matrix(jchb.diff_matrix(NY, order), jnp.asarray(a), axis), 1e-12)


@pytest.mark.parametrize("n", [15, 16])
def test_fourier_fft_transforms_match_reference_and_products(n):
    v = _rand((n, 5), 3)
    fwd = ttr.fourier_r2c_forward_fft(_t(v), 0)
    _close(fwd, jtr.fourier_r2c_forward_fft(jnp.asarray(v), 0), 1e-12)
    _close(fwd, tb.to_complex(jfou.split_forward_matrix(n) @ v), 1e-12)
    c = np.asarray(fwd)
    bwd = ttr.fourier_r2c_backward_fft(_t(c), 0, n)
    _close(bwd, jtr.fourier_r2c_backward_fft(jnp.asarray(c), 0, n), 1e-12)
    _close(bwd, jfou.split_backward_matrix(n) @ tb.from_complex(c), 1e-12)
    _close(bwd, v, 1e-12)
    z = _rand((5, n), 4, cplx=True)
    _close(ttr.fourier_c2c_forward_fft(_t(z), 1), jtr.fourier_c2c_forward_fft(jnp.asarray(z), 1),
           1e-12)
    _close(ttr.fourier_c2c_backward_fft(_t(z), 1, n),
           jtr.fourier_c2c_backward_fft(jnp.asarray(z), 1, n), 1e-12)


def test_apply_along_runs_complex_fields_on_real_products():
    z = _rand((6, 7), 5, cplx=True)
    m = _rand((4, 7), 6)
    got = ttr.apply_along(_t(m), _t(z), 1)
    np.testing.assert_allclose(got.numpy(), z @ m.T, rtol=0, atol=1e-14)
    got0 = ttr.apply_along(_t(m[:, :6]), _t(z), 0)
    np.testing.assert_allclose(got0.numpy(), m[:, :6] @ z, rtol=0, atol=1e-14)


# -- bases and spaces ----------------------------------------------------------------


def _space_pairs(nx, method):
    """(port space, reference space) for every space of the periodic cell."""
    pairs = []
    for ky in ("cheb_dirichlet", "chebyshev", "cheb_neumann"):
        tsp = tb.Space2(tb.fourier_r2c(nx), getattr(tb, ky)(NY), device="cpu",
                        dtype=torch.float64, method=method)
        jsp = jb.Space2(jb.fourier_r2c(nx), getattr(jb, ky)(NY))
        pairs.append((tsp, jsp))
    return pairs


@pytest.mark.parametrize("nx", [15, 16])
def test_periodic_base_operators_match_reference(nx):
    tbase, jbase = tb.fourier_r2c(nx), jb.fourier_r2c(nx)
    assert tbase.m == jbase.m and tbase.is_periodic and jbase.spectral_is_complex
    np.testing.assert_array_equal(tbase.points, jbase.points)
    np.testing.assert_array_equal(tbase.laplace(), jbase.laplace())
    np.testing.assert_array_equal(tbase.dealias_cut(), jbase.dealias_cut())
    for order in (1, 2):
        np.testing.assert_array_equal(tbase.gradient_matrix(order), jbase.gradient_matrix(order))
    for key in ("fwd", "fwd_cut", "bwd", "synthesis", "stencil", "proj", ("bwd_grad", 1),
                ("grad", 1), ("grad", 2)):
        top, jop = tbase.axis_operator(key), jbase.axis_operator(key)
        np.testing.assert_array_equal(top.matrix, jop.matrix)
        assert top.dealias_rows == jop.dealias_rows
        if jop.kept_rows is None:
            assert top.kept_rows is None
        else:
            np.testing.assert_array_equal(top.kept_rows, jop.kept_rows)
    with pytest.raises(ValueError, match="c2c"):
        tb.fourier_c2c(nx).axis_operator("fwd")
    # the split layout round trip
    c = _rand((tbase.m, 3), 7, cplx=True)
    np.testing.assert_array_equal(tb.from_complex(c), jb.fourier_r2c_split(nx).from_complex(c))
    np.testing.assert_array_equal(tb.to_complex(tb.from_complex(c)), c)


@pytest.mark.parametrize("nx", [15, 16])
@pytest.mark.parametrize("method", ["fft", "matmul"])
def test_periodic_space_transforms_match_reference(nx, method):
    for k, (tsp, jsp) in enumerate(_space_pairs(nx, method)):
        assert tsp.shape_spectral == jsp.shape_spectral
        assert tsp.spectral_dtype == torch.complex128
        v = _rand(tsp.shape_physical, 10 + k)
        jvhat = jsp.forward(jnp.asarray(v))
        vhat = tsp.forward(_t(v))
        _close(vhat, jvhat, 1e-12)
        c = np.asarray(jvhat)
        _close(tsp.backward(_t(c)), jsp.backward(jvhat), 1e-12)
        _close(tsp.to_ortho(_t(c)), jsp.to_ortho(jvhat), 1e-12)
        ortho = np.asarray(jsp.to_ortho(jvhat))
        _close(tsp.backward_ortho(_t(ortho)), jsp.backward_ortho(jnp.asarray(ortho)), 1e-12)
        _close(tsp.from_ortho(_t(ortho)), jsp.from_ortho(jnp.asarray(ortho)), 1e-12)
        for deriv in ((1, 0), (0, 1), (2, 0), (0, 2)):
            _close(tsp.gradient(_t(c), deriv, (1.5, 1.0)), jsp.gradient(jvhat, deriv, (1.5, 1.0)),
                   1e-12)
            _close(tsp.backward_gradient(_t(c), deriv, (1.5, 1.0)),
                   jsp.backward_gradient(jvhat, deriv, (1.5, 1.0)), 1e-12)
        np.testing.assert_array_equal(tsp.dealias_mask(), jsp.dealias_mask())
        np.testing.assert_array_equal(tsp.pin_zero_mode(_t(c)).numpy(),
                                      np.asarray(jsp.pin_zero_mode(jvhat)))
        np.testing.assert_array_equal(tsp.vhat_as_complex(_t(c)), jsp.vhat_as_complex(jvhat))


def test_float32_derivative_recurrence_engages_from_fast_deriv_min(monkeypatch):
    """In float32 from ``FAST_DERIV_MIN`` points on, a Chebyshev gradient
    runs the O(n) recurrence (the JAX package's rule), and agrees with the
    product; in float64 it never does."""
    calls = []
    real = ttr.cheb_derivative
    monkeypatch.setattr(ttr, "cheb_derivative", lambda *a: calls.append(a[1]) or real(*a))
    monkeypatch.setattr(tb, "FAST_DERIV_MIN", NY)
    for dtype in (torch.float32, torch.float64):
        sp = tb.Space2(tb.fourier_r2c(16), tb.cheb_dirichlet(NY), device="cpu", dtype=dtype,
                       method="matmul")
        vhat = sp.forward(_t(_rand(sp.shape_physical, 50)).to(dtype))
        got = sp.gradient(vhat, (1, 2))
        ref = tb.Space2(tb.fourier_r2c(16), tb.cheb_dirichlet(NY), device="cpu",
                        dtype=torch.float64, method="matmul")
        want = ref.gradient(vhat.to(torch.complex128), (1, 2))
        _close(got.to(torch.complex128), want, 1e-5 if dtype == torch.float32 else 1e-13)
    assert calls == [2]  # once, in float32


def test_space_rejects_periodic_y_and_unknown_method():
    with pytest.raises(ValueError, match="periodic y-axis"):
        tb.Space2(tb.chebyshev(9), tb.fourier_r2c(8), device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="transform method"):
        tb.Space2(tb.chebyshev(9), tb.chebyshev(9), device="cpu", dtype=torch.float64,
                  method="dct")
    assert tb.default_method("cpu") == "fft"


@pytest.mark.parametrize("n", [15, 16])
def test_periodic_weights_match_reference(n):
    x = tfou.fourier_points(n)
    np.testing.assert_array_equal(tfield.grid_deltas(x, True), jfield.grid_deltas(x, True))
    np.testing.assert_allclose(tfield.average_weights(x, True), jfield.average_weights(x, True),
                               rtol=0, atol=1e-16)
    assert tfield.average_weights(x, True).sum() == pytest.approx(1.0, abs=1e-14)
    z = _t(_rand((3, 4), 8, cplx=True))
    assert float(tfield.norm_l2(z)) == pytest.approx(float(jfield.norm_l2(jnp.asarray(z.numpy()))),
                                                     rel=1e-14)


# -- solvers -----------------------------------------------------------------------


@pytest.mark.parametrize("nx", [15, 16])
def test_periodic_modal_data_match_reference(nx):
    for tsp, jsp in _space_pairs(nx, "fft"):
        for ci in (1e-3, 0.25):
            np.testing.assert_allclose(tsolver.hholtz_axis_solve_matrix(tsp, 0, ci),
                                       jsolver.hholtz_axis_solve_matrix(jsp, 0, ci), rtol=1e-15)
        if tsp.base_y.kind == tb.BaseKind.CHEBYSHEV:
            continue
        for ci, sign in ((1.0, 1.0), (0.5, -1.0)):
            tl, tf, tq = tsolver.modal_data_split(tsp, 0, ci, sign)
            jl, jf, jq = jsolver.modal_data_split(jsp, 0, ci, sign)
            np.testing.assert_array_equal(tl, jl)
            assert tf is None and tq is None and jf is None and jq is None


@pytest.mark.parametrize("nx", [15, 16])
@pytest.mark.parametrize("method", ["banded", "dense"])
def test_periodic_hholtz_adi_matches_reference(nx, method):
    tsp, jsp = _space_pairs(nx, "fft")[0]
    c = (2e-3, 5e-3)
    port = tsolver.HholtzAdi(tsp, c, method=method)
    ref = jsolver.HholtzAdi(jsp, c)
    rhs = _rand((tsp.base_x.m, NY), 20, cplx=True)
    _close(port.solve(_t(rhs)), ref.solve(jnp.asarray(rhs)), 1e-12)
    assert len(port.kernels()) == (1 if method == "banded" else 0)


@pytest.mark.parametrize("nx", [15, 16])
@pytest.mark.parametrize("method", ["banded", "fd"])
def test_periodic_poisson_and_hholtz_match_reference(nx, method):
    pairs = _space_pairs(nx, "fft")
    for cls, (tsp, jsp) in ((tsolver.Poisson, pairs[2]), (tsolver.Hholtz, pairs[0])):
        c = (1.0, 1.0) if cls is tsolver.Poisson else (0.1, 0.1)
        port = cls(tsp, c, method=method)
        ref = getattr(jsolver, cls.__name__)(jsp, c, method=method)
        rhs = _rand((tsp.base_x.m, NY), 21, cplx=True)
        got = port.solve(_t(rhs))
        want = np.asarray(ref.solve(jnp.asarray(rhs)))
        # the k=0 lane (the nudged singular system of Poisson, ~1e10 times
        # the others) and the other lanes, each to its own scale
        _close(got[:1], want[:1], 1e-12)
        _close(got[1:], want[1:], 1e-12)


def test_complex_banded_solve_is_one_launch_of_real_lanes():
    """A complex right-hand side runs as the real and imaginary parts of one
    strided view, per-mode factors read by both: bit for bit the two real
    solves."""
    rng = np.random.default_rng(30)
    lanes, n = 5, 11
    dense = np.zeros((lanes, n, n))
    for d in (-2, 0, 2, 4):
        for lane in range(lanes):
            dense[lane] += np.diag(rng.uniform(0.1, 0.3, n - abs(d)) + (4.0 if d == 0 else 0.0), d)
    solver = tbanded.BandedSolver(*tbanded.banded_lu_factor(dense, 2, 4), device="cpu",
                                  dtype=torch.float64)
    assert solver.kernel.path == "parity"
    b = _t(_rand((lanes, n), 31, cplx=True))
    views = []
    solver._along(lambda v: views.append(v) or v, b, 1)
    assert views[0].shape == (2, 1, n, lanes) and views[0].stride() == (1, 2 * n * lanes, 2, 2 * n)
    got = solver.solve(b, 1)
    torch.testing.assert_close(got.real, solver.solve(b.real.contiguous(), 1), rtol=0, atol=0)
    torch.testing.assert_close(got.imag, solver.solve(b.imag.contiguous(), 1), rtol=0, atol=0)
    for lane in range(lanes):
        np.testing.assert_allclose(dense[lane] @ got[lane].numpy(), b[lane].numpy(), atol=1e-13)


# -- the fused kernels' plain versions ------------------------------------------------


def _ref_periodic(nx, fused):
    """The reference's periodic model: its default (dense) step, or its
    fused route with both Pallas kernels (interpret mode)."""
    with pytest.MonkeyPatch.context() as mp:
        if fused:
            mp.setenv("RUSTPDE_STEP_KERNEL", "pallas")
            mp.setenv("RUSTPDE_CONV_KERNEL", "pallas")
        model = rp.Navier2D(nx, NY, 1e4, 1.0, 5e-3, 1.0, "rbc", periodic=True)
    assert (model._step_impl is not None) == fused
    return model


@pytest.mark.parametrize("nx", [15, 16])
def test_fused_conv_plain_matches_reference_kernel(nx):
    tsp = tb.Space2(tb.fourier_r2c(nx), tb.cheb_dirichlet(NY), device="cpu", dtype=torch.float64)
    tfs = tb.Space2(tb.fourier_r2c(nx), tb.chebyshev(NY), device="cpu", dtype=torch.float64)
    jsp = jb.Space2(jb.fourier_r2c(nx), jb.cheb_dirichlet(NY))
    jfs = jb.Space2(jb.fourier_r2c(nx), jb.chebyshev(NY))
    port, ref = FusedConv(tsp, tfs, (1.5, 1.0)), JFusedConv(jsp, jfs, (1.5, 1.0), interpret=True)
    assert port.complex and (port.kx, port.ky) == (ref.kx, ref.ky)
    rng = np.random.default_rng(40)
    args = [rng.standard_normal((nx, NY)) for _ in range(2)]
    args.append(np.asarray(jsp.forward(jnp.asarray(rng.standard_normal((nx, NY))))))
    bcs = [rng.standard_normal((nx, NY)) for _ in range(2)]
    for extra in ([], bcs):
        got = port.plain(*(_t(a) for a in args + extra))
        want = ref.apply(*(jnp.asarray(a) for a in args + extra))
        assert got.dtype == torch.complex128
        _close(got, want, 1e-12)
        _close(port.apply(*(_t(a) for a in args + extra)), want, 1e-12)
    assert port.launches == 0


def test_fused_stages_plain_match_reference_kernels():
    ref = _ref_periodic(16, fused=True)
    port = pt.Navier2D(16, NY, 1e4, 1.0, 5e-3, 1.0, "rbc", periodic=True, device="cpu")
    assert sorted(port._stages) == sorted(ref._step_impl)
    assert not port._stages["poisson"].has_l and port._stages["velx"].has_l
    rng = np.random.default_rng(41)
    for tag, st in port._stages.items():
        jst = ref._step_impl[tag]
        xs = [(rng.standard_normal((k0 // 2, k1)) + 1j * rng.standard_normal((k0 // 2, k1)))
              for k0, k1 in zip(st.k0, st.k1)]
        got = st.plain(*(_t(x) for x in xs))
        want = jst.apply(*(jnp.asarray(x) for x in xs))
        assert got.dtype == torch.complex128, tag
        _close(got, want, 1e-12)
    pin = port._stages["poisson"].mask
    assert pin[0, 0] == 0 and pin[pin.shape[0] // 2, 0] == 0 and pin.sum() == pin.numel() - 2


# -- the whole model ------------------------------------------------------------------


def _assert_state_close(got, ref, tol):
    for name in FIELDS:
        want = np.asarray(getattr(ref.state, name))
        scale = max(float(np.max(np.abs(want))), 1e-300)
        diff = float(np.max(np.abs(got[name] - want)))
        assert diff <= tol * scale, (name, diff, scale)


@pytest.mark.parametrize("route", ["dense", "fused"])
def test_five_steps_match_periodic_reference(route):
    ref = _ref_periodic(16, fused=route == "fused")
    ref.init_random(0.1, seed=0)
    port = pt.Navier2D(16, NY, 1e4, 1.0, 5e-3, 1.0, "rbc", periodic=True, device="cpu",
                       step_kernel=route, conv_kernel=route)
    port.init_random(0.1, seed=0)
    _assert_state_close(convert.state_to_numpy(port), ref, 1e-13)
    for name in ("temp", "velx", "vely"):
        np.testing.assert_allclose(port.get_field(name), ref.get_field(name), rtol=0, atol=1e-14)
    ref.update_n(2)  # a state with pressure, so every leaf is carried
    convert.state_from_numpy(port, {f: np.asarray(getattr(ref.state, f)) for f in FIELDS})
    _assert_state_close(convert.state_to_numpy(port), ref, 0.0)
    ref.update_n(5)
    for _ in range(5):
        port.update()
    _assert_state_close(convert.state_to_numpy(port), ref, 1e-11)
    for g, w in zip(port.get_observables(), ref.get_observables()):
        assert g == pytest.approx(float(w), rel=1e-10)
    kernels = port.kernels()
    if route == "dense":
        # velx/vely share the ADI solver: one banded solve on its Chebyshev
        # axis, one for temp, one for Poisson; the Fourier axes are diagonal
        assert sorted(kernels) == ["banded_solve"] and len(kernels["banded_solve"]) == 3
        assert all(k.path == "parity" for k in kernels["banded_solve"])
    else:
        assert sorted(kernels) == ["fused_conv", "fused_stage"]
    assert sum(k.launches for ks in kernels.values() for k in ks) == 0


def test_chunk_matches_reference_update_n():
    ref = _ref_periodic(16, fused=False)
    ref.init_random(0.1, seed=0)
    port = pt.Navier2D.new_periodic(16, NY, 1e4, 1.0, 5e-3, 1.0, "rbc", device="cpu",
                                    step_kernel="dense", conv_kernel="dense")
    ref.update_n(7)
    port.update_n(7)
    assert port.get_time() == pytest.approx(ref.get_time())
    _assert_state_close(convert.state_to_numpy(port), ref, 1e-11)
    # the sentinel chunk on complex fields: armed equals plain bit for bit,
    # its scalars real and finite
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
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("split", [False, True])
def test_convert_reads_complex_and_split_states(split):
    ref = _ref_periodic(16, fused=False)
    ref.init_random(0.1, seed=2)
    ref.update_n(1)
    arrays = {f: np.asarray(getattr(ref.state, f)) for f in FIELDS}
    if split:  # the JAX package's TPU layout of the Fourier axis
        arrays = {f: jb.fourier_r2c_split(16).from_complex(a, axis=0) for f, a in arrays.items()}
        assert not np.iscomplexobj(arrays["temp"])
    port = pt.Navier2D(16, NY, 1e4, 1.0, 5e-3, 1.0, "rbc", periodic=True, device="cpu")
    convert.state_from_numpy(port, arrays, split=split)
    _assert_state_close(convert.state_to_numpy(port), ref, 0.0)
    assert port.get_observables()[0] == pytest.approx(float(ref.get_observables()[0]), rel=1e-10)

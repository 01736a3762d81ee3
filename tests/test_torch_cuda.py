"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (here, on the CPU
test run) and runs on a machine with one.  This file imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the kernels and ``torch.matmul`` sum the same products in
another order, and the banded kernel may fuse the multiply-subtracts its
plain recurrence rounds twice; 1e-12 of max|plain| in f64 and 1e-4 in f32.
"""

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.models.solid_masks import solid_roughness_sinusoid
from rustpde_mpi_tpu_torch.ops import _build
from rustpde_mpi_tpu_torch.workloads import ScenarioConfig

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _rel(got, want):
    torch.cuda.synchronize()
    return float(torch.max(torch.abs(got - want))) / float(torch.max(torch.abs(want)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generic_gemm_ragged_jobs(device, dtype):
    """Ragged M, N, K (no multiple of a tile), several jobs of different
    shapes in one launch, every epilogue, and the zero fill to Mout x Nout."""
    fn = _build.gemm(dtype)
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float64).to(device, dtype) - 0.5

    a1, b1, a2, b2 = rand(70, 33), rand(33, 130), rand(70, 5), rand(5, 130)
    e, f, m = rand(70, 130), rand(70, 130), (rand(70, 130) > 0).to(dtype)
    out1 = torch.full((75, 131), 7.0, device=device, dtype=dtype)
    out2 = torch.full((17, 3), 7.0, device=device, dtype=dtype)
    a3, b3 = rand(17, 200), rand(200, 3)
    _build.launch_jobs(fn, [
        _build.job(out1, [(a1, b1), (a2, b2)], M=70, N=130, Mout=75, Nout=131, E=e, F=f, mask=m),
        _build.job(out2, [(a3, b3)], M=17, N=3),
    ], device)
    want1 = torch.zeros_like(out1)
    want1[:70, :130] = ((a1 @ b1 + a2 @ b2) * e + f) * m
    assert _rel(out1, want1) <= TOL[dtype]
    assert _rel(out2, a3 @ b3) <= TOL[dtype]


#: extents that cross the DMMA fragment (16 x 8 x 8) and block tile (64 x 64;
#: depth 16 and 32) edges
EDGES = (1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 127, 128, 129)


def _operand(rows, cols, aligned, rng, dtype, device):
    """A ``rows x cols`` operand as a view of a wider buffer: rows on 16
    bytes (even leading dimension, aligned base) when ``aligned``, else an
    odd leading dimension and a base one element past 16 bytes."""
    per = 16 // dtype.itemsize
    if aligned:
        ld, off = -(-cols // per) * per + per, 0
    else:
        ld, off = cols + 1 + cols % 2, 1
    buf = torch.empty(rows * ld + off, dtype=dtype, device=device)
    view = buf[off:].view(rows, ld)[:, :cols]
    view.copy_(torch.as_tensor(rng.uniform(-1.0, 1.0, (rows, cols)), dtype=dtype))
    return view


@pytest.mark.parametrize("aligned", [True, False], ids=["copy16", "copy_elem"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generic_gemm_edge_sweep(device, dtype, aligned):
    """Every M x N x K over the fragment and tile edges, four jobs (four
    depths) in each launch, on strided views whose rows all start on 16
    bytes (the 16-byte copies) or none do (the element copies)."""
    fn = _build.gemm(dtype)
    rng = np.random.default_rng(7)
    want_vec = 0b11 if aligned else 0
    for m in EDGES:
        for n in EDGES:
            for k0 in range(0, len(EDGES), 4):
                jobs, checks = [], []
                for k in EDGES[k0:k0 + 4]:
                    a = _operand(m, k, aligned, rng, dtype, device)
                    b = _operand(k, n, aligned, rng, dtype, device)
                    out = _operand(m, n, aligned, rng, dtype, device)
                    j = _build.job(out, [(a, b)], M=m, N=n)
                    assert j.vec == want_vec
                    jobs.append(j)
                    checks.append((out, a, b))
                _build.launch_jobs(fn, jobs, device)
                for out, a, b in checks:
                    assert _rel(out, a @ b) <= TOL[dtype], (m, n, a.shape[1])


@pytest.mark.parametrize("epilogue", range(8), ids=lambda e: f"E{e & 1}F{e >> 1 & 1}mask{e >> 2}")
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generic_gemm_terms_and_epilogues(device, dtype, epilogue):
    """Four terms of different depth in one output (odd and aligned operands
    mixed), each epilogue combination of E, F and mask, the zero fill to
    Mout x Nout, and the same input run twice gives bit-identical output."""
    fn = _build.gemm(dtype)
    rng = np.random.default_rng(epilogue)
    m, n, mo, no = 131, 97, 140, 100
    terms = [(_operand(m, k, k % 2 == 0, rng, dtype, device),
              _operand(k, n, k % 3 == 0, rng, dtype, device)) for k in (1, 17, 64, 129)]

    def rand(rows, cols):
        return torch.as_tensor(rng.uniform(-1.0, 1.0, (rows, cols)), dtype=dtype).to(device)

    e = rand(m, n) if epilogue & 1 else None
    f = rand(m, n) if epilogue & 2 else None
    mask = (rand(m, n) > 0).to(dtype) if epilogue & 4 else None
    want = torch.zeros((mo, no), dtype=dtype, device=device)
    v = sum(a @ b for a, b in terms)
    v = v * e if e is not None else v
    v = v + f if f is not None else v
    want[:m, :n] = v * mask if mask is not None else v
    outs = []
    for _ in range(2):
        out = torch.full((mo, no), 7.0, dtype=dtype, device=device)
        _build.launch_jobs(fn, [_build.job(out, terms, M=m, N=n, Mout=mo, Nout=no,
                                           E=e, F=f, mask=mask)], device)
        outs.append(out)
    assert _rel(outs[0], want) <= TOL[dtype]
    assert torch.equal(outs[0], outs[1])


def _dual_case(n0, n1, k, aligned, with_bc, rng, dtype, device):
    ops = [_operand(n0, k, aligned, rng, dtype, device) for _ in range(2)]
    ops += [_operand(k, n1, aligned, rng, dtype, device) for _ in range(2)]
    ops += [torch.as_tensor(rng.uniform(-1.0, 1.0, (n0, n1)), dtype=dtype).to(device)
            for _ in range(4 if with_bc else 2)]
    return ops


def _dual(ops, n0, n1, k, dtype, device):
    a1, a0, g0t, g1t, ux, uy, *bc = ops
    lib = _build.load("fused_conv")
    fn = lib.rp_conv_dual_f64 if dtype == torch.float64 else lib.rp_conv_dual_f32
    out = torch.full((n0, n1 + 3), 7.0, dtype=dtype, device=device)[:, :n1]
    bcx, bcy = (bc[0].data_ptr(), bc[1].data_ptr()) if bc else (None, None)
    vec = _build.rows_aligned(a1, a0) | _build.rows_aligned(g0t, g1t) << 1
    _build.call(fn, device, n0, n1, k, a1.data_ptr(), a0.data_ptr(), a1.stride(0),
                g0t.data_ptr(), g1t.data_ptr(), g0t.stride(0), ux.data_ptr(), uy.data_ptr(),
                bcx, bcy, ux.stride(0), out.data_ptr(), out.stride(0), vec, 1, 0, 0, 0)
    dx, dy = a1 @ g0t, a0 @ g1t
    if bc:
        dx, dy = dx + bc[0], dy + bc[1]
    return out, ux * dx + uy * dy, vec


@pytest.mark.parametrize("aligned", [True, False], ids=["copy16", "copy_elem"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_conv_dual_edges(device, dtype, aligned):
    """The two-accumulator kernel over fragment and tile edges, with and
    without the bc terms, on both copy paths; bit-identical on a repeat."""
    rng = np.random.default_rng(11)
    shapes = [(n0, n1, k) for n0 in (1, 17, 64, 129) for n1 in (8, 63, 65, 128)
              for k in (1, 15, 16, 65)]
    for i, (n0, n1, k) in enumerate(shapes):
        ops = _dual_case(n0, n1, k, aligned, i % 2 == 1, rng, dtype, device)
        got, want, vec = _dual(ops, n0, n1, k, dtype, device)
        assert vec == (3 if aligned else 0)
        assert _rel(got, want) <= TOL[dtype], (n0, n1, k)
        again, _, _ = _dual(ops, n0, n1, k, dtype, device)
        assert torch.equal(got, again)


def test_stage_repeat_is_bit_identical(device):
    """A whole fused stage and a conv chain at 129^2 run twice on one input
    give bit-identical output (the kernels are deterministic)."""
    model = pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", device=device)
    rng = np.random.default_rng(3)
    for st in model._stages.values():
        xs = [torch.tensor(rng.uniform(-1.0, 1.0, (k0, k1)), device=device)
              for k0, k1 in zip(st.k0, st.k1)]
        assert torch.equal(st.apply(*xs), st.apply(*xs)), st.name
    fc = model._convs[id(model.temp_space)]
    args = [torch.tensor(rng.uniform(-1.0, 1.0, s), device=device)
            for s in [(129, 129)] * 2 + [(fc.mx, fc.my)] + [(129, 129)] * 2]
    assert torch.equal(fc.apply(*args), fc.apply(*args))


@pytest.mark.parametrize("n", [17, 33])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stages_and_convs_match_plain(device, n, dtype):
    model = pt.Navier2D(n, n, 1e5, 1.0, 2e-3, 1.0, "rbc", device=device, dtype=dtype)
    rng = np.random.default_rng(n)

    def rand(shape):
        return torch.tensor(rng.uniform(-1.0, 1.0, shape), dtype=dtype, device=device)

    for tag, st in model._stages.items():
        xs = [rand((k0, k1)) for k0, k1 in zip(st.k0, st.k1)]
        assert _rel(st.apply(*xs), st.plain(*xs)) <= TOL[dtype], tag
        assert st.launches == 1
    for fc, with_bc in ((model._convs[id(model.velx_space)], False),
                        (model._convs[id(model.temp_space)], True)):
        args = [rand((n, n)), rand((n, n)), rand((fc.mx, fc.my))]
        if with_bc:
            args += [rand((n, n)), rand((n, n))]
        assert _rel(fc.apply(*args), fc.plain(*args)) <= TOL[dtype]
        assert fc.launches == 1


def test_fused_kernels_on_a_second_card(device):
    """The fused stages and conv chains on a second card, after they ran on
    the first (their shared-memory attributes are set per card), launched
    with either card current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    rng = np.random.default_rng(5)
    for index in (0, 1):
        dev = torch.device("cuda", index)
        model = pt.Navier2D(65, 65, 1e5, 1.0, 2e-3, 1.0, "rbc", device=dev)
        for current in (0, 1):
            with torch.cuda.device(current):
                for tag, st in model._stages.items():
                    xs = [torch.tensor(rng.uniform(-1.0, 1.0, (k0, k1)), device=dev)
                          for k0, k1 in zip(st.k0, st.k1)]
                    assert _rel(st.apply(*xs), st.plain(*xs)) <= TOL[torch.float64], (dev, tag)
                fc = model._convs[id(model.temp_space)]
                args = [torch.tensor(rng.uniform(-1.0, 1.0, s), device=dev)
                        for s in [(65, 65)] * 2 + [(fc.mx, fc.my)] + [(65, 65)] * 2]
                assert _rel(fc.apply(*args), fc.plain(*args)) <= TOL[torch.float64], dev


def _prepare_chunks(model):
    """Build the model's chunk runner (on the card: warm every kernel
    wrapper up, one eager step, and capture the step as a CUDA graph), then
    zero its launch counters, so they count the chunk's replays only."""
    model.chunk_runner()
    for ks in model.kernels().values():
        for k in ks:
            k.launches = 0


def test_step_on_card_matches_cpu(device):
    """Ten steps through the kernels agree with ten plain steps on the CPU
    (rel 1e-11 of each field's scale), with 3 conv and 7 stage launches a
    step."""
    states = {}
    for dev in (device, torch.device("cpu")):
        m = pt.Navier2D.new_confined(33, 33, 1e5, 1.0, 2e-3, 1.0, "rbc", device=dev)
        _prepare_chunks(m)
        m.update_n(10)
        states[dev.type] = (pt.state_to_numpy(m), m)
    card = states["cuda"][1]
    assert sum(c.launches for c in card._convs.values()) == 30
    assert sum(s.launches for s in card._stages.values()) == 70
    for name, ref in states["cpu"][0].items():
        scale = max(float(np.max(np.abs(ref))), 1e-300)
        assert float(np.max(np.abs(states["cuda"][0][name] - ref))) <= 1e-11 * scale, name


# -- the banded-substitution kernel ------------------------------------------------


def _banded_system(n, lanes=None, seed=0):
    """LU factors of diagonally dominant banded matrices (p=2, q=4), one
    set or one per lane."""
    from rustpde_mpi_tpu_torch.ops.banded import banded_lu_factor

    rng = np.random.default_rng(seed)
    batch = (lanes,) if lanes else ()
    band = np.tril(np.triu(np.ones((n, n)), -2), 4)
    return banded_lu_factor(rng.uniform(0.2, 0.6, batch + (n, n)) * band + 4.0 * np.eye(n), 2, 4)


def _band_factors(n, lanes=None, seed=0, parity=False):
    """The systems of :func:`_banded_system` built in band storage (no
    dense ``(lanes, n, n)`` batch): the full band, the kernel's general
    path, or, with ``parity``, the odd offsets zero, as in the solvers'
    Chebyshev systems (its parity path)."""
    from rustpde_mpi_tpu_torch.ops.banded import band_lu_factor

    rng = np.random.default_rng(seed)
    band = rng.uniform(0.2, 0.6, ((lanes,) if lanes else ()) + (n, 7))
    band[..., 2] += 4.0
    for k in range(-2, 5):  # band[..., i, 2 + k] holds A[i, i + k]
        rows = np.arange(n)
        band[..., (rows + k < 0) | (rows + k >= n), 2 + k] = 0.0
        if parity and k % 2:
            band[..., 2 + k] = 0.0
    return band_lu_factor(band, 2, 4)


def _lane_rel(got, plain, axis):
    """Max over lanes of |got - plain| relative to that lane's max|plain|."""
    torch.cuda.synchronize()
    scale = torch.amax(torch.abs(plain), dim=axis, keepdim=True)
    return float(torch.max(torch.abs(got - plain) / scale))


@pytest.mark.parametrize("n,lanes", [(37, 130), (64, 32), (1025, 1023)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("parity", [True, False])
def test_banded_paths_match_plain(device, parity, per_lane, dtype, n, lanes):
    """Both paths of the kernel (parity-split chains for an even band, one
    chain a lane for the full band) against the plain recurrence, per
    lane: both axes, a batch dim, the factor batch stride for per-lane
    factors; n and lanes that do and do not divide the tile (8 lanes) and
    the ring stage (32 rows), copies of 16 bytes (64 x 32) and of one
    element; a repeat is bit-identical."""
    from rustpde_mpi_tpu_torch.ops.banded import BandedSolver

    factors = _band_factors(n, lanes if per_lane else None, seed=n, parity=parity)
    rng = np.random.default_rng(4)
    cases = [(rng.uniform(-1, 1, (n, lanes)), 0, 0), (rng.uniform(-1, 1, (lanes, n)), 1, 0)]
    if per_lane:
        ranks = next(r for r in (4, 3, 2) if lanes % r == 0)
        cases.append((rng.uniform(-1, 1, (ranks, lanes // ranks, n)), 2, lanes // ranks))
    else:
        cases += [(rng.uniform(-1, 1, (3, lanes, n)), 2, 0), (rng.uniform(-1, 1, (2, n, lanes)), 1, 0)]
    solver = BandedSolver(*factors, device=device, dtype=dtype)
    assert solver.kernel.path == ("parity" if parity else "general")
    for i, (b, axis, stride) in enumerate(cases):
        bt = torch.tensor(b, dtype=dtype, device=device)
        got = solver.solve(bt, axis, stride)
        again = solver.solve(bt, axis, stride)
        assert solver.kernel.launches == 2 * (i + 1)
        assert tuple(got.shape) == tuple(bt.shape)
        rel = _lane_rel(got, solver.plain(bt, axis, stride), axis)
        assert rel <= TOL[dtype], (b.shape, axis, rel)
        assert torch.equal(again, got)


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_kernel_matches_plain(device, per_lane, dtype):
    """Both factor modes, both axes of a row-major field (axis 1 through a
    strided view), a batch dim, ragged n and lanes."""
    from rustpde_mpi_tpu_torch.ops.banded import BandedSolver

    n, lanes = 37, 130
    solver = BandedSolver(*_banded_system(n, lanes if per_lane else None), device=device,
                          dtype=dtype)
    assert solver.kernel.path == "general"
    rng = np.random.default_rng(1)
    cases = [(rng.uniform(-1, 1, (n, lanes)), 0), (rng.uniform(-1, 1, (lanes, n)), 1),
             (rng.uniform(-1, 1, (3, lanes, n)), 2)]
    if not per_lane:
        cases.append((rng.uniform(-1, 1, (2, n, lanes)), 1))
    kern = solver.kernel
    for i, (b, axis) in enumerate(cases):
        bt = torch.tensor(b, dtype=dtype, device=device)
        got = solver.solve(bt, axis)
        assert kern.launches == i + 1
        assert tuple(got.shape) == tuple(bt.shape)
        plain = solver.plain(bt, axis)
        scale = torch.amax(torch.abs(plain), dim=axis, keepdim=True)  # each lane's own
        assert float(torch.max(torch.abs(got - plain) / scale)) <= TOL[dtype], (b.shape, axis)


def test_banded_kernel_rejects_wide_bands(device):
    from rustpde_mpi_tpu_torch.ops.banded_solve import BandedSolve

    bs = BandedSolve(np.ones((5, 8)), np.ones((2, 8)), device=device, dtype=torch.float64)
    with pytest.raises(ValueError, match="p, q <= 4"):
        bs.apply(torch.zeros((1, 8, 4), dtype=torch.float64, device=device))
    assert bs.launches == 0


def test_dense_route_on_card_matches_cpu(device):
    """Ten steps of the dense route through the banded kernel agree with
    ten plain steps on the CPU (rel 1e-11 of each field's scale), with 7
    banded launches a step."""
    states = {}
    for dev in (device, torch.device("cpu")):
        m = pt.Navier2D.new_confined(33, 33, 1e5, 1.0, 2e-3, 1.0, "rbc", device=dev,
                                     step_kernel="dense", conv_kernel="dense")
        _prepare_chunks(m)
        m.update_n(10)
        states[dev.type] = (pt.state_to_numpy(m), m)
    card = states["cuda"][1]
    assert sum(k.launches for k in card.kernels()["banded_solve"]) == 70
    assert all(k.path == "parity" for k in card.kernels()["banded_solve"])
    for name, ref in states["cpu"][0].items():
        scale = max(float(np.max(np.abs(ref))), 1e-300)
        assert float(np.max(np.abs(states["cuda"][0][name] - ref))) <= 1e-11 * scale, name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_kernel_factor_batch_stride(device, dtype):
    """Per-lane factors read with a factor batch stride (the meshed Poisson
    solve: batch k = rank k's slice of the lanes) against the plain
    recurrence, and against the unbatched kernel solve bit for bit."""
    from rustpde_mpi_tpu_torch.ops.banded import BandedSolver

    n, ranks, per_rank = 37, 4, 33
    solver = BandedSolver(*_banded_system(n, ranks * per_rank), device=device, dtype=dtype)
    assert solver.kernel.path == "general"
    b = torch.tensor(np.random.default_rng(2).uniform(-1, 1, (ranks * per_rank, n)),
                     dtype=dtype, device=device)
    want = solver.solve(b, 1)
    stacked = b.view(ranks, per_rank, n)
    got = solver.solve(stacked, 2, factor_batch_stride=per_rank)
    assert solver.kernel.launches == 2
    plain = solver.plain(stacked, 2, factor_batch_stride=per_rank)
    scale = torch.amax(torch.abs(plain), dim=2, keepdim=True)
    assert float(torch.max(torch.abs(got - plain) / scale)) <= TOL[dtype]
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_kernel_zero_pad(device, dtype, parity):
    """An identity-padded system on a right-hand side with a zero pad (a
    meshed pencil's pad rows and lanes), on both paths: the pad solves to
    zero, the real lanes as the plain recurrence does, and an all-zero rhs
    to zero."""
    from rustpde_mpi_tpu_torch.ops.banded import BandedSolver, band_lu_factor, dense_to_band, pad_band

    n, n_pad, lanes, lanes_pad = 37, 40, 30, 32
    rng = np.random.default_rng(3)
    band = np.tril(np.triu(np.ones((n, n)), -2), 4)
    if parity:
        band *= np.subtract.outer(np.arange(n), np.arange(n)) % 2 == 0
    dense = rng.uniform(0.2, 0.6, (n, n)) * band + 4.0 * np.eye(n)
    padded = pad_band(dense_to_band(dense, 2, 4), 2, n_pad)
    solver = BandedSolver(*band_lu_factor(padded, 2, 4), device=device, dtype=dtype)
    assert solver.kernel.path == ("parity" if parity else "general")
    b = torch.zeros((n_pad, lanes_pad), dtype=dtype, device=device)
    b[:n, :lanes] = torch.tensor(rng.uniform(-1, 1, (n, lanes)), dtype=dtype, device=device)
    got = solver.solve(b, 0)
    assert not got[n:].any() and not got[:, lanes:].any()
    plain = solver.plain(b, 0)
    scale = torch.amax(torch.abs(plain[:, :lanes]), dim=0, keepdim=True)
    assert float(torch.max(torch.abs(got[:, :lanes] - plain[:, :lanes]) / scale)) <= TOL[dtype]
    assert not solver.solve(torch.zeros_like(b), 0).any()
    assert solver.kernel.launches == 2


# -- the pencil-transpose kernel and the meshed route --------------------------------


@pytest.mark.parametrize("nranks", [1, 2, 4, 8, 3])
@pytest.mark.parametrize("shape", [(17, 17), (33, 20), (64, 64), (129, 129), (5, 130)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ring_transpose_matches_plain(device, shape, dtype, nranks):
    """A copy, so bit-equal (tolerance 0) to the plain ring in both
    directions: ragged widths (8-byte or 4-byte words), aligned ones (16-byte
    words), a row stride wider than the row and an unaligned base pointer,
    on 1, 2, 4 and 8 ranks (the kernel's shift instances) and 3 (its
    generic one); one launch a flip."""
    from rustpde_mpi_tpu_torch.parallel import Decomp2d, make_mesh

    mesh = make_mesh(nranks, device)
    decomp = Decomp2d(shape, mesh)
    a = torch.as_tensor(np.random.default_rng(0).standard_normal(shape))
    x, y = decomp.place_x_pencil(a, dtype), decomp.place_y_pencil(a, dtype)
    got_y, got_x = mesh.ring.x_to_y(x), mesh.ring.y_to_x(y)
    assert mesh.ring.launches == 2
    torch.cuda.synchronize()
    assert torch.equal(got_y, mesh.ring.plain(x, True)) and torch.equal(got_y, y)
    assert torch.equal(got_x, mesh.ring.plain(y, False)) and torch.equal(got_x, x)
    wide = torch.zeros(x.shape[:2] + (x.shape[2] + 3,), dtype=dtype, device=device)
    for off in (0, 1):  # a strided view; off=1 also moves the base pointer
        wide[..., off:off + x.shape[2]] = x
        view = wide[..., off:off + x.shape[2]]
        assert torch.equal(mesh.ring.x_to_y(view), y)
    assert mesh.ring.launches == 4


def test_ring_transpose_rejects_bad_input(device):
    from rustpde_mpi_tpu_torch.parallel import make_mesh

    mesh = make_mesh(4, device)
    with pytest.raises(ValueError, match="unit stride"):
        mesh.ring.x_to_y(torch.zeros((4, 8, 6), dtype=torch.float64, device=device)[..., ::2])
    with pytest.raises(ValueError, match="shape"):
        mesh.ring.y_to_x(torch.zeros((4, 2, 6), dtype=torch.float64, device=device))
    assert mesh.ring.launches == 0


def test_meshed_route_on_card_matches_cpu(device):
    """Ten meshed steps (4 ranks on the card) through the kernels agree
    with ten plain meshed steps on the CPU (rel 1e-11 of each field's
    scale), with 37 pencil flips and 7 banded launches a step."""
    from rustpde_mpi_tpu_torch.parallel import make_mesh

    states = {}
    for dev in (device, torch.device("cpu")):
        m = pt.Navier2D.new_confined(33, 33, 1e5, 1.0, 2e-3, 1.0, "rbc", mesh=make_mesh(4, dev))
        # init_random's three forward transforms flip once each on the card
        assert m.mesh.ring.launches == (3 if dev.type == "cuda" else 0)
        _prepare_chunks(m)
        m.update_n(10)
        states[dev.type] = (pt.state_to_numpy(m), m)
    card = states["cuda"][1].kernels()
    assert sum(k.launches for k in card["ring_transpose"]) == 370
    assert sum(k.launches for k in card["banded_solve"]) == 70
    assert all(k.path == "parity" for k in card["banded_solve"])
    for name, ref in states["cpu"][0].items():
        scale = max(float(np.max(np.abs(ref))), 1e-300)
        assert float(np.max(np.abs(states["cuda"][0][name] - ref))) <= 1e-11 * scale, name


# -- chunked stepping: a CUDA graph of the step ---------------------------------------


#: kernel launches a step of each route (the periodic dense and meshed
#: routes: one banded solve on the Chebyshev axis for velx, vely and temp
#: each, one for every Fourier mode of the Poisson solve; an ``hc_`` route
#: runs horizontal-convection boundary conditions, its temperature's y
#: solve on the banded kernel's general path; an ``scn_`` route runs the
#: scenario modifiers and an obstacle: a fourth conv chain and an eighth
#: stage for the scalar, its two banded solves on the temperature's solver,
#: and on the mesh 19 more flips for the Coriolis, scalar and penalization
#: transforms)
PER_STEP = {"fused": {"fused_conv": 3, "fused_stage": 7}, "dense": {"banded_solve": 7},
            "mesh": {"banded_solve": 7, "ring_transpose": 37},
            "periodic_fused": {"fused_conv": 3, "fused_stage": 7},
            "periodic_dense": {"banded_solve": 4},
            "periodic_mesh": {"banded_solve": 4, "ring_transpose": 37},
            "hc_fused": {"fused_conv": 3, "fused_stage": 7}, "hc_dense": {"banded_solve": 7},
            "hc_mesh": {"banded_solve": 7, "ring_transpose": 37},
            "scn_fused": {"fused_conv": 4, "fused_stage": 8}, "scn_dense": {"banded_solve": 9},
            "scn_mesh": {"banded_solve": 9, "ring_transpose": 56}}
ROUTES = sorted(PER_STEP)


def _route_model(route, device, n=33, method=None):
    if route.endswith("mesh"):
        kw = dict(mesh=pt.make_mesh(4, device), method=method)
    else:
        kw = dict(device=device, method=method)
        if route.endswith("dense"):
            kw.update(step_kernel="dense", conv_kernel="dense")
    bc = "hc" if route.startswith("hc") else "rbc"
    if route.startswith("periodic"):
        return pt.Navier2D.new_periodic(n - 1, n, 1e5, 1.0, 2e-3, 1.0, bc, **kw)
    if route.startswith("scn"):
        return _scenario_model(n, ScenarioConfig(coriolis=2.0, passive_scalar=True), **kw)
    return pt.Navier2D.new_confined(n, n, 1e5, 1.0, 2e-3, 1.0, bc, **kw)


def _scenario_model(n, scenario, **kw):
    """A confined model with ``scenario``, the roughness obstacle and, with
    a scalar, the scalar released as half the temperature."""
    m = pt.Navier2D.new_confined(n, n, 1e5, 1.0, 2e-3, 1.0, "rbc", scenario=scenario, **kw)
    m.set_solid(*solid_roughness_sinusoid(*m.x, 0.1, 10.0))
    if "scal" in m.state._fields:
        m.state = m.state._replace(scal=0.5 * m.state.temp)
    return m


def _launches_by_kernel(model):
    return {name: sum(k.launches for k in ks) for name, ks in model.kernels().items()}


def _assert_bit_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("route", ROUTES)
def test_chunk_graph_matches_eager_steps(device, route):
    """``update_n(10)`` (buckets 8 and 2, each step one replay of the
    captured step) equals ten eager ``update()`` calls bit for bit, and the
    launch counters advance by the captured step's launches per replay."""
    a, b = _route_model(route, device), _route_model(route, device)
    runner = a.chunk_runner()
    assert runner.captured and runner.pool_bytes >= 0
    assert sum(runner.delta) == sum(PER_STEP[route].values())
    _prepare_chunks(a)
    a.update_n(10)
    for _ in range(10):
        b.update()
    _assert_bit_equal(a.state, b.state)
    assert _launches_by_kernel(a) == {k: 10 * v for k, v in PER_STEP[route].items()}
    a.update_n(3)
    assert _launches_by_kernel(a) == {k: 13 * v for k, v in PER_STEP[route].items()}


@pytest.mark.parametrize("route", ROUTES)
def test_chunk_graph_nan_freeze(device, route):
    """With temp mode 0 NaN a chunk of 8 executes one step: the state it
    returns is the eager step's, NaN where that one is and bit for bit
    elsewhere."""
    m = _route_model(route, device)
    temp = m.state.temp.clone()
    temp.view(-1)[0] = float("nan")
    bad = m.state._replace(temp=temp)
    stepped, done = m.step_n(bad, 8)
    assert int(done) == 1
    want = m._step(bad)
    for name, x, y in zip(want._fields, stepped, want):
        assert torch.equal(torch.isfinite(x), torch.isfinite(y)), name
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), name
    m.state = bad
    m.update_n(7)
    assert m.exit()


@pytest.mark.parametrize("route", ROUTES)
def test_chunk_graph_sentinels_bit_identical(device, route):
    """The sentinel chunk's state is the plain chunk's bit for bit, and its
    status agrees with the CPU's (rel 1e-10: reductions of states that
    agree to 1e-11 of their scale)."""
    from rustpde_mpi_tpu_torch.config import StabilityConfig

    armed, plain = _route_model(route, device), _route_model(route, device)
    cpu = _route_model(route, torch.device("cpu"))
    for m in (armed, cpu):
        m.set_stability(StabilityConfig())
    status = armed.update_n(10)
    plain.update_n(10)
    _assert_bit_equal(armed.state, plain.state)
    want = cpu.update_n(10)
    assert (status.steps_done, status.finite, status.cfl_ok) == (10, True, True)
    for key in ("cfl_max", "ke", "ke_growth_max", "div_max"):
        assert getattr(status, key) == pytest.approx(getattr(want, key), rel=1e-10), key


def test_chunk_capture_failure_raises(device):
    """A step that syncs with the host cannot be captured: ``update_n``
    raises, keeps no runner, and runs no step eagerly instead."""
    m = _route_model("fused", device, n=17)
    step = m._step

    def syncing_step(state, with_sentinels=False):
        out = step(state, with_sentinels)
        float(torch.sum(out.temp))
        return out

    m._step = syncing_step
    before = m.state
    with pytest.raises(RuntimeError):
        m.update_n(2)
    assert not m._runners and m.state is before and m.time == 0.0


# -- the periodic cell (Fourier r2c x Chebyshev) ---------------------------------------


@pytest.mark.parametrize("nx", [16, 31])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_periodic_stages_and_convs_match_plain(device, nx, dtype):
    """Every stage (the L-less Poisson stage included) and both conv
    variants on complex inputs, stacked to [Re; Im] planes for the kernels."""
    model = pt.Navier2D(nx, 33, 1e5, 1.0, 2e-3, 1.0, "rbc", periodic=True, device=device,
                        dtype=dtype)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    rng = np.random.default_rng(nx)

    def rand(shape, cplx=False):
        a = rng.uniform(-1.0, 1.0, shape) + (1j * rng.uniform(-1.0, 1.0, shape) if cplx else 0)
        return torch.tensor(a, dtype=cdt if cplx else dtype, device=device)

    assert not model._stages["poisson"].has_l
    for tag, st in model._stages.items():
        xs = [rand((k0 // 2, k1), True) for k0, k1 in zip(st.k0, st.k1)]
        out = st.apply(*xs)
        assert out.dtype == cdt and _rel(out, st.plain(*xs)) <= TOL[dtype], tag
        assert st.launches == 1
    for fc, with_bc in ((model._convs[id(model.velx_space)], False),
                        (model._convs[id(model.temp_space)], True)):
        args = [rand((nx, 33)), rand((nx, 33)), rand((fc.mx // 2, fc.my), True)]
        if with_bc:
            args += [rand((nx, 33)), rand((nx, 33))]
        out = fc.apply(*args)
        assert out.dtype == cdt and _rel(out, fc.plain(*args)) <= TOL[dtype]
        assert fc.launches == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_periodic_banded_solves_match_plain(device, dtype):
    """The periodic dense route's banded solves on complex right-hand
    sides: the ADI Chebyshev axis (one factor set) and the Poisson solve
    (one set per Fourier mode, read by its Re and Im lanes), each one
    launch, on the parity path."""
    model = pt.Navier2D(32, 65, 1e5, 1.0, 2e-3, 1.0, "rbc", periodic=True, device=device,
                        dtype=dtype, step_kernel="dense", conv_kernel="dense")
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    rng = np.random.default_rng(7)
    cases = [(model.solver_velx.solvers[1].solver, model.velx_space.shape_spectral),
             (model.solver_pres._solver.banded, model.pseu_space.shape_spectral)]
    for solver, shape in cases:
        b = torch.tensor(rng.uniform(-1.0, 1.0, shape) + 1j * rng.uniform(-1.0, 1.0, shape),
                         dtype=cdt, device=device)
        before = solver.kernel.launches
        got = solver.solve(b, 1)
        assert solver.kernel.launches == before + 1 and solver.kernel.path == "parity"
        want = solver.plain(b, 1)
        assert _lane_rel(got.real, want.real, 1) <= TOL[dtype]
        assert _lane_rel(got.imag, want.imag, 1) <= TOL[dtype]


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_periodic_route_on_card_matches_cpu(device, route):
    """Ten periodic steps through the kernels agree with ten plain steps on
    the CPU (rel 1e-11 of each field's scale), with the route's launches."""
    states = {}
    for dev in (device, torch.device("cpu")):
        m = _route_model(f"periodic_{route}", dev)
        _prepare_chunks(m)
        m.update_n(10)
        states[dev.type] = (pt.state_to_numpy(m), m)
    want = {k: 10 * v for k, v in PER_STEP[f"periodic_{route}"].items()}
    assert _launches_by_kernel(states["cuda"][1]) == want
    for name, ref in states["cpu"][0].items():
        assert np.iscomplexobj(ref)
        scale = max(float(np.max(np.abs(ref))), 1e-300)
        assert float(np.max(np.abs(states["cuda"][0][name] - ref))) <= 1e-11 * scale, name


@pytest.mark.parametrize("periodic", [False, True])
def test_transform_methods_agree_on_card(device, periodic):
    """The FFT and the matmul transform paths of the Chebyshev axes give
    the same transforms on the card (1e-12 of the result's scale)."""
    from rustpde_mpi_tpu_torch import bases as tb

    bx = tb.fourier_r2c(64) if periodic else tb.cheb_dirichlet(65)
    spaces = {m: tb.Space2(bx, tb.cheb_dirichlet(65), device=device, dtype=torch.float64,
                           method=m) for m in ("fft", "matmul")}
    v = torch.tensor(np.random.default_rng(3).uniform(-1.0, 1.0, spaces["fft"].shape_physical),
                     device=device)
    vhat = {m: sp.forward(v) for m, sp in spaces.items()}
    assert _rel(vhat["fft"], vhat["matmul"]) <= 1e-12
    for fn in ("backward", "to_ortho"):
        got = {m: getattr(sp, fn)(vhat["matmul"]) for m, sp in spaces.items()}
        assert _rel(got["fft"], got["matmul"]) <= 1e-12, fn
    for deriv in ((1, 0), (0, 1)):
        got = {m: sp.backward_gradient(vhat["matmul"], deriv) for m, sp in spaces.items()}
        assert _rel(got["fft"], got["matmul"]) <= 1e-12, deriv


# -- complex flips, the general banded path, HC and the meshed periodic cell ---------------


@pytest.mark.parametrize("nranks", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(17, 15), (9, 16), (33, 64), (65, 129)])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_ring_transpose_complex_matches_plain(device, shape, dtype, nranks):
    """Complex pencils (the periodic cell's spectral state: nx/2+1 modes
    padded to the rank count), a complex element the unit: bit for bit the
    plain ring and the permuted copy, both directions, in 16-byte words
    (complex128; complex64 pairs on even widths) and 8-byte ones."""
    from rustpde_mpi_tpu_torch.parallel import Decomp2d, make_mesh

    mesh = make_mesh(nranks, device)
    decomp = Decomp2d(shape, mesh)
    rng = np.random.default_rng(1)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x, y = decomp.place_x_pencil(a, dtype), decomp.place_y_pencil(a, dtype)
    got_y, got_x = mesh.ring.x_to_y(x), mesh.ring.y_to_x(y)
    assert mesh.ring.launches == 2 and got_y.dtype == dtype
    torch.cuda.synchronize()
    assert torch.equal(got_y, mesh.ring.plain(x, True)) and torch.equal(got_y, y)
    assert torch.equal(got_x, mesh.ring.plain(y, False)) and torch.equal(got_x, x)
    p, c, w = nranks, x.shape[1] // nranks, x.shape[2]
    assert torch.equal(got_y, x.view(p, p, c, w).permute(1, 2, 0, 3).contiguous().view(p, c, p * w))
    wide = torch.zeros(x.shape[:2] + (x.shape[2] + 3,), dtype=dtype, device=device)
    wide[..., 1:1 + x.shape[2]] = x  # a strided view one element past the base
    assert torch.equal(mesh.ring.x_to_y(wide[..., 1:1 + x.shape[2]]), y)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_general_path_on_the_hc_temperature_solve(device, dtype):
    """HC's temperature y solve couples both parities: its kernel runs the
    general path (one chain a lane) and matches the plain recurrence per
    lane, real and complex (two planes) alike."""
    model = pt.Navier2D(33, 33, 1e5, 1.0, 2e-3, 1.0, "hc", device=device, dtype=dtype,
                        step_kernel="dense", conv_kernel="dense")
    solver = model.solver_temp.solvers[1].solver
    assert solver.kernel.path == "general"
    rng = np.random.default_rng(11)
    b = torch.tensor(rng.uniform(-1.0, 1.0, model.temp_space.shape_spectral), dtype=dtype,
                     device=device)
    assert _lane_rel(solver.solve(b, 1), solver.plain(b, 1), 1) <= TOL[dtype]
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    z = torch.tensor(rng.uniform(-1.0, 1.0, (17, 31)) + 1j * rng.uniform(-1.0, 1.0, (17, 31)),
                     dtype=cdt, device=device)
    got, want = solver.solve(z, 1), solver.plain(z, 1)
    assert _lane_rel(got.real, want.real, 1) <= TOL[dtype]
    assert _lane_rel(got.imag, want.imag, 1) <= TOL[dtype]
    assert solver.kernel.launches == 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_planes_with_a_factor_batch_stride(device, dtype):
    """The meshed periodic Poisson solve: complex y-pencils whose lanes'
    factor sets are offset by the rank, Re and Im two planes of one
    launch."""
    model = pt.Navier2D(32, 33, 1e5, 1.0, 2e-3, 1.0, "rbc", periodic=True,
                        mesh=pt.make_mesh(4, device), dtype=dtype)
    solver = model.solver_pres._solver.banded
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    rng = np.random.default_rng(12)
    shape = (4, 5, 32)  # 17 modes padded to 20: 5 a rank; 31 rows padded to 32
    b = torch.tensor(rng.uniform(-1.0, 1.0, shape) + 1j * rng.uniform(-1.0, 1.0, shape),
                     dtype=cdt, device=device)
    got, want = solver.solve(b, 2, 5), solver.plain(b, 2, 5)
    assert solver.kernel.launches == 1
    assert _lane_rel(got.real, want.real, 2) <= TOL[dtype]
    assert _lane_rel(got.imag, want.imag, 2) <= TOL[dtype]


@pytest.mark.parametrize("route", ["hc_fused", "hc_dense", "hc_mesh", "periodic_mesh"])
def test_hc_and_meshed_periodic_routes_on_card_match_cpu(device, route):
    """Ten steps of the HC routes and of the meshed periodic route through
    the kernels agree with ten plain steps on the CPU (rel 1e-11 of each
    field's scale), with the route's launches."""
    states = {}
    for dev in (device, torch.device("cpu")):
        m = _route_model(route, dev)
        _prepare_chunks(m)
        m.update_n(10)
        states[dev.type] = (pt.state_to_numpy(m), m)
    want = {k: 10 * v for k, v in PER_STEP[route].items()}
    assert _launches_by_kernel(states["cuda"][1]) == want
    for name, ref in states["cpu"][0].items():
        scale = max(float(np.max(np.abs(ref))), 1e-300)
        assert float(np.max(np.abs(states["cuda"][0][name] - ref))) <= 1e-11 * scale, name


# -- the scenario modifiers and solid obstacles ------------------------------------------


@pytest.mark.parametrize("n", [17, 33])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scenario_stages_and_convs_match_plain(device, n, dtype):
    """The stages of a rotating model with a scalar at another diffusivity:
    the five-term ``vely`` stage (its five ``L @ x`` products in one launch,
    the five products summed in one accumulator), the four-term ``velx``
    and the scalar's stage, each against its plain version and bit for bit
    on a repeat."""
    model = pt.Navier2D(n, n, 1e5, 1.0, 2e-3, 1.0, "rbc", device=device, dtype=dtype,
                        scenario=ScenarioConfig(coriolis=2.0, passive_scalar=True,
                                                scalar_kappa=0.01))
    assert [len(model._stages[t].terms) for t in ("velx", "vely", "scal")] == [4, 5, 2]
    rng = np.random.default_rng(n + 1)
    for tag, st in model._stages.items():
        xs = [torch.tensor(rng.uniform(-1.0, 1.0, (k0, k1)), dtype=dtype, device=device)
              for k0, k1 in zip(st.k0, st.k1)]
        got = st.apply(*xs)
        assert _rel(got, st.plain(*xs)) <= TOL[dtype], tag
        assert torch.equal(got, st.apply(*xs)), tag
        assert st.launches == 2, tag


@pytest.mark.parametrize("route", ["scn_fused", "scn_dense", "scn_mesh"])
def test_scenario_routes_on_card_match_cpu(device, route):
    """Ten steps with Coriolis, the scalar and the obstacle through the
    kernels agree with ten plain steps on the CPU (rel 1e-11 of each
    field's scale, ``scal`` included), with the route's launches."""
    states = {}
    for dev in (device, torch.device("cpu")):
        m = _route_model(route, dev)
        _prepare_chunks(m)
        m.update_n(10)
        states[dev.type] = (pt.state_to_numpy(m), m)
    assert _launches_by_kernel(states["cuda"][1]) == {k: 10 * v for k, v in PER_STEP[route].items()}
    assert "scal" in states["cpu"][0]
    for name, ref in states["cpu"][0].items():
        scale = max(float(np.max(np.abs(ref))), 1e-300)
        assert float(np.max(np.abs(states["cuda"][0][name] - ref))) <= 1e-11 * scale, name


@pytest.mark.parametrize("route", ["fused", "dense", "mesh"])
def test_chunk_graph_recaptured_after_set_solid_and_set_scenario(device, route):
    """``set_solid`` and ``set_scenario`` drop the captured chunk (it holds
    the old factors, stages and state fields); the next ``update_n``
    captures the new step, which equals eager steps bit for bit."""
    a, b = _route_model(route, device), _route_model(route, device)
    a.update_n(2)
    for _ in range(2):
        b.update()
    first = a.chunk_runner()
    changes = [("set_solid", solid_roughness_sinusoid(*a.x, 0.1, 10.0)),
               ("set_scenario", (ScenarioConfig(coriolis=2.0, passive_scalar=True),)),
               ("set_solid", (None,)), ("set_scenario", (None,))]
    for name, args in changes:
        for m in (a, b):
            getattr(m, name)(*args)
        assert not a._runners, name
        a.update_n(3)
        for _ in range(3):
            b.update()
        assert a.chunk_runner() is not first and a.chunk_runner().captured, name
        _assert_bit_equal(a.state, b.state)
        first = a.chunk_runner()


# -- ensembles: the member axis of every kernel ------------------------------------------


def _rand_like_io(rng, shape, dtype, device):
    if dtype.is_complex:
        parts = rng.uniform(-1.0, 1.0, tuple(shape) + (2,))
        return torch.view_as_complex(torch.tensor(parts, device=device)).to(dtype)
    return torch.tensor(rng.uniform(-1.0, 1.0, shape), dtype=dtype, device=device)


@pytest.mark.parametrize("cell", ["confined", "periodic"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_member_stages_and_convs_match_plain(device, dtype, cell):
    """Every stage (the Coriolis five-term ``vely`` and the scalar's
    included) and both conv variants on K = 3 member-stacked inputs at 33^2
    (32x33 periodic): one kernel application for all members, against the
    plain version, and each member bit for bit its own one-member launch."""
    k, n = 3, 33
    model = pt.Navier2D(n - 1 if cell == "periodic" else n, n, 1e5, 1.0, 2e-3, 1.0, "rbc",
                        periodic=cell == "periodic", device=device, dtype=dtype,
                        scenario=ScenarioConfig(coriolis=2.0, passive_scalar=True))
    rng = np.random.default_rng(21)
    for tag, st in model._stages.items():
        rows = [k0 // 2 if st.complex_io else k0 for k0 in st.k0]
        xs = [_rand_like_io(rng, (k, r, k1), st.io_dtype, device) for r, k1 in zip(rows, st.k1)]
        got = st.apply(*xs)
        assert st.launches == 1
        assert _rel(got, st.plain(*xs)) <= TOL[dtype], tag
        for i in range(k):
            assert torch.equal(got[i], st.apply(*(x[i] for x in xs))), (tag, i)
    shape = model.field_space.shape_physical
    ux, uy = (_rand_like_io(rng, (k,) + shape, dtype, device) for _ in range(2))
    for space in (model.velx_space, model.temp_space):
        fc = model._convs[id(space)]
        vhat = _rand_like_io(rng, (k,) + space.shape_spectral, space.spectral_dtype, device)
        for bc in ((), (model._tempbc_dx, model._tempbc_dy)):
            before = fc.launches
            got = fc.apply(ux, uy, vhat, *bc)
            assert fc.launches == before + 1
            assert _rel(got, fc.plain(ux, uy, vhat, *bc)) <= TOL[dtype]
            for i in range(k):
                assert torch.equal(got[i], fc.apply(ux[i], uy[i], vhat[i], *bc)), i


@pytest.mark.parametrize("complex_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_members_with_a_factor_batch_period(device, dtype, complex_rhs):
    """K members of a meshed Poisson solve in one launch: ``(K, P, c, n)``
    pencils, per-lane factors offset by the rank (stride c, period P), real
    or complex (two planes), against the plain recurrence and against each
    member's own launch bit for bit."""
    from rustpde_mpi_tpu_torch.ops.banded import BandedSolver

    k, ranks, per_rank, n = 3, 4, 33, 37
    solver = BandedSolver(*_banded_system(n, ranks * per_rank), device=device, dtype=dtype)
    rng = np.random.default_rng(4)
    io = (torch.complex128 if dtype == torch.float64 else torch.complex64) if complex_rhs else dtype
    b = _rand_like_io(rng, (k, ranks, per_rank, n), io, device)
    got = solver.solve(b, -1, factor_batch_stride=per_rank, factor_batch_period=ranks)
    assert solver.kernel.launches == 1
    plain = solver.plain(b, -1, factor_batch_stride=per_rank, factor_batch_period=ranks)
    g, p = (torch.view_as_real(x) if complex_rhs else x for x in (got, plain))
    scale = torch.amax(torch.abs(p), dim=(-1,) if not complex_rhs else (-2, -1), keepdim=True)
    assert float(torch.max(torch.abs(g - p) / scale)) <= TOL[dtype]
    for i in range(k):
        assert torch.equal(got[i], solver.solve(b[i], -1, factor_batch_stride=per_rank)), i


@pytest.mark.parametrize("k,p,c,w", [(3, 4, 9, 9), (1, 4, 33, 33), (2, 4, 257, 257),
                                     (32, 4, 33, 33), (32, 4, 32, 32), (2, 2, 5, 64),
                                     (3, 8, 3, 17), (2, 1, 7, 65)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.complex128,
                                   torch.complex64])
def test_ring_transpose_members_match_plain(device, dtype, k, p, c, w):
    """K members' pencils flipped by one launch, both directions, bit for
    bit against the plain ring, the permuted copy and each member's own
    launch (the ``ensemble129`` K = 32 and ``rbc1025`` K = 2 pencils among
    them)."""
    ring = pt.make_mesh(p, device).ring
    rng = np.random.default_rng(6)
    x = _rand_like_io(rng, (k, p, p * c, w), dtype, device)
    y = ring.x_to_y(x)
    assert ring.launches == 1
    assert torch.equal(y, ring.plain(x, True))
    assert torch.equal(y, x.view(k, p, p, c, w).permute(0, 2, 3, 1, 4).contiguous()
                       .view(k, p, c, p * w))
    assert torch.equal(ring.y_to_x(y), x)
    for i in range(k):
        assert torch.equal(y[i], ring.x_to_y(x[i]))
    assert ring.launches == 2 + k


#: ragged chunk extents ``(c, w)`` from 1 to 65, odd and even, for the
#: flip sweep
FLIP_CHUNKS = [(1, 1), (1, 65), (65, 1), (2, 17), (33, 33), (16, 16), (64, 3), (65, 64),
               (7, 32)]


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("c,w", FLIP_CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.complex128,
                                   torch.complex64])
def test_ring_transpose_sweep_matches_plain(device, dtype, c, w, p):
    """Every copy width and edge of the flat tiling: K = 0 (no member dim),
    1, 2, 3 and 32 members, both directions, each from a contiguous pencil,
    from a view into rows padded by 3 elements, and from that view one
    element past the base (off 16-byte alignment): bit for bit the plain
    ring and the permuted copy, one launch a flip."""
    ring = pt.make_mesh(p, device).ring
    rng = np.random.default_rng(c * 100 + w)
    for k in (0, 1, 2, 3, 32):
        lead = (k,) if k else ()
        for x_to_y in (True, False):
            shape = lead + ((p, p * c, w) if x_to_y else (p, c, p * w))
            wide = _rand_like_io(rng, shape[:-1] + (shape[-1] + 3,), dtype, device)
            for block in (wide[..., :shape[-1]].contiguous(), wide[..., :shape[-1]],
                          wide[..., 1:1 + shape[-1]]):
                before = ring.launches
                got = ring.apply(block, x_to_y)
                assert ring.launches == before + 1
                torch.cuda.synchronize()
                assert torch.equal(got, ring.plain(block, x_to_y)), (k, x_to_y, block.stride())
                view = block if k else block[None]
                if x_to_y:
                    want = view.reshape(max(k, 1), p, p, c, w).permute(0, 2, 3, 1, 4)
                else:
                    want = view.reshape(max(k, 1), p, c, p, w).permute(0, 3, 1, 2, 4)
                assert torch.equal(got.reshape(-1), want.reshape(-1))


def _ensemble_route(route, device, k=3, n=33):
    model = _route_model(route, device, n)
    return pt.NavierEnsemble.from_seeds(model, range(k))


@pytest.mark.parametrize("route", ROUTES)
def test_ensemble_chunk_graph_matches_eager_steps(device, route):
    """An ensemble's ``update_n(10)`` (each step one replay of the captured
    K-member step) equals ten eager K-member steps bit for bit, and a step
    of K = 3 members launches exactly what a solo step of the route does."""
    ens = _ensemble_route(route, device)
    model = ens.model
    runner = ens.chunk_runner()
    assert runner.captured
    assert sum(runner.delta) == sum(PER_STEP[route].values())
    _prepare_chunks(model)
    start = ens.state
    ens.update_n(10)
    assert _launches_by_kernel(model) == {k: 10 * v for k, v in PER_STEP[route].items()}
    state = start
    for _ in range(10):
        state = model._step(state)
    _assert_bit_equal(ens.state, state)
    assert ens.steps_done.tolist() == [10, 10, 10] and ens.alive().all()


@pytest.mark.parametrize("route", ["fused", "dense", "mesh", "periodic_fused", "scn_dense"])
def test_ensemble_members_match_solo_models_on_card(device, route):
    """After 10 steps member i equals a solo model of seed i on the same
    route and card (rel 1e-12 of each field's scale; the fused kernels give
    each member its one-member launch's tile loop, so bit for bit there)."""
    ens = _ensemble_route(route, device)
    ens.update_n(10)
    for i in range(3):
        solo = _route_model(route, device)
        solo.init_random(0.1, seed=i)
        solo.update_n(10)
        for name, x, y in zip(ens.state._fields, ens.state, solo.state):
            if route.endswith("fused"):
                assert torch.equal(x[i], y), (i, name)
            else:
                assert _rel(x[i], y) <= 1e-12, (i, name)


def test_ensemble_nan_isolation_on_card(device):
    """A member poisoned in temp mode 0 dies with no step counted; the
    others are bit for bit those of an unpoisoned ensemble."""
    ens, clean = _ensemble_route("fused", device), _ensemble_route("fused", device)
    bad = ens.member_state(0)
    temp = bad.temp.clone()
    temp[0, 0] = float("nan")
    ens.set_member(0, bad._replace(temp=temp))
    ens.update_n(7)
    clean.update_n(7)
    assert ens.alive().tolist() == [False, True, True]
    assert ens.steps_done.tolist() == [0, 7, 7]
    for x, y in zip(ens.state, clean.state):
        assert torch.equal(x[1:], y[1:])


# -- checkpoints: staging on the card, restores into captured chunks ---------------------


def _stored(snap):
    from rustpde_mpi_tpu_torch.utils import checkpoint as ck

    out = {}
    for path, data, kind in snap.datasets:
        out.update(ck._stored_arrays(path, data, kind))
    return out


@pytest.mark.parametrize("route", ["fused", "dense", "mesh", "periodic_fused", "periodic_mesh",
                                   "hc_dense", "scn_fused"])
def test_card_staging_matches_cpu_staging(device, route):
    """A snapshot staged on the card equals the CPU staging of the same
    state (the CPU model on the card's transform method): every ``vhat``,
    coordinate and scalar dataset bit for bit, each backward transform
    ``v`` to 1e-12 of its scale."""
    from rustpde_mpi_tpu_torch.utils import checkpoint as ck

    card = _route_model(route, device)
    card.update_n(3)
    snap = ck.snapshot_to_host(card)
    cpu = _route_model(route, "cpu", method=pt.bases.CARD_METHOD)
    ck._restore_snapshot(cpu, ck._host_group(snap))
    got, want = _stored(snap), _stored(ck.snapshot_to_host(cpu))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.rsplit("/", 1)[-1] == "v":
            assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max(), name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("route", ["fused", "dense", "mesh"])
def test_same_shape_restore_keeps_the_captured_graph(device, route):
    """A restore of a staged snapshot into a model whose chunk graph is
    captured keeps the graph; its steps equal eager steps from the
    restored state bit for bit."""
    from rustpde_mpi_tpu_torch.utils import checkpoint as ck

    src = _route_model(route, device)
    src.update_n(3)
    snap = ck.snapshot_to_host(src)
    a, b = _route_model(route, device), _route_model(route, device)
    runner = a.chunk_runner()
    for m in (a, b):
        ck._restore_snapshot(m, ck._host_group(snap))
    assert a.chunk_runner() is runner and runner.captured
    a.update_n(5)
    for _ in range(5):
        b.update()
    _assert_bit_equal(a.state, b.state)


@pytest.mark.parametrize("route", ["fused", "mesh"])
def test_ensemble_restore_at_another_k_recaptures(device, route):
    """An ensemble of K = 5 restores a K = 3 snapshot: K, mask and counts
    come back, the captured graph is dropped, and the next ``update_n``
    captures the 3-member step, which equals eager steps bit for bit."""
    from rustpde_mpi_tpu_torch.utils import checkpoint as ck

    src = _ensemble_route(route, device)
    src.update_n(2)
    src.mark_dead([1])
    snap = ck.ensemble_snapshot_to_host(src)
    ens = _ensemble_route(route, device, k=5)
    first = ens.chunk_runner()
    ck._restore_ensemble_snapshot(ens, ck._host_group(snap))
    assert ens.k == 3 and not ens._runners
    assert ens.alive().tolist() == [True, False, True] and ens.steps_done.tolist() == [2, 2, 2]
    start = ens.state
    ens.update_n(4)
    assert ens.chunk_runner() is not first and ens.chunk_runner().captured
    assert ens.steps_done.tolist() == [6, 2, 6]
    state = ens.model._step(start)
    for _ in range(3):
        state = ens.model._step(state)
    for x, y in zip(ens.state, state):
        assert torch.equal(x[0], y[0]) and torch.equal(x[2], y[2])


# -- the statistics chunk and set_dt (the statistics engine, the dt governor) ----------------


def _eager_stats(model, steps, stride):
    """``steps`` eager ``update()`` calls, sampling the statistics where
    the tick hits the stride (the plain chunk's rule on a healthy run)."""
    eng = model.stats_engine
    sums = model.stats_state
    for tick in range(1, steps + 1):
        model.update()
        if tick % stride == 0:
            sums = eng.accumulate(sums, model.state)
    return sums


@pytest.mark.parametrize("route", ["fused", "dense", "mesh", "periodic_fused", "periodic_mesh"])
def test_stats_chunk_graph_matches_eager_steps(device, route):
    """The captured statistics chunk (the step graph, and the step plus
    sample graph on the stride's steps) equals eager steps with eager
    samples bit for bit, state and sums; a replay of either graph launches
    a step's kernels (the sample's own launches on top, on a mesh)."""
    a, b = _route_model(route, device), _route_model(route, device)
    for m in (a, b):
        m.set_stats(pt.StatsConfig(stride=3))
    runner = a.chunk_runner()
    assert runner.captured and runner.n_stats == len(a.stats_state) + 1
    assert sum(runner.deltas[0]) == sum(PER_STEP[route].values())
    assert sum(runner.deltas[1]) >= sum(runner.deltas[0])
    _prepare_chunks(a)
    a.update_n(10)
    want = _eager_stats(b, 10, 3)
    _assert_bit_equal(a.state, b.state)
    _assert_bit_equal(a.stats_state, want)
    assert int(a._stats_tick[0]) == 10 and float(a.stats_state.samples[0]) == 3
    extra = [d1 - d0 for d0, d1 in zip(runner.deltas[0], runner.deltas[1])]
    names = [n for n, ks in a.kernels().items() for _ in ks]
    got = {}
    for name, d0, d1 in zip(names, runner.deltas[0], extra):
        got[name] = got.get(name, 0) + 10 * d0 + 3 * d1
    assert _launches_by_kernel(a) == got


@pytest.mark.parametrize("route", ["fused", "dense", "mesh"])
def test_no_stale_graph_after_set_dt(device, route):
    """After ``set_dt`` one graph step equals one eager step at the new dt
    bit for bit (and not the old dt's step); back at the old dt the cached
    graph is replayed again, equal to an eager step there."""
    m = _route_model(route, device)
    m.update_n(2)
    s0, old = m.state, m.chunk_runner()
    stale = m._step(s0)
    m.set_dt(m.dt / 2)
    assert m.chunk_runner() is not old
    m.update_n(1)
    graph = m.state
    _assert_bit_equal(graph, m._step(s0))
    assert not torch.equal(graph.temp, stale.temp)
    m.set_dt(m.dt * 2)
    assert m.chunk_runner() is old
    m.state = s0
    m.update_n(1)
    _assert_bit_equal(m.state, stale)


def test_ensemble_stats_chunk_matches_solo_on_card(device):
    """K = 3 members' statistics through the captured ensemble chunk equal
    solo models' (33^2, fused route): the states bit for bit, the sums to
    1e-12 of each leaf's scale (a member-batched reduction sums in another
    order than a solo one)."""
    model = _route_model("fused", device)
    model.set_stats(pt.StatsConfig(stride=2))
    ens = pt.NavierEnsemble.from_seeds(model, range(3))
    ens.update_n(6)
    for i in range(3):
        solo = _route_model("fused", device)
        solo.init_random(0.1, seed=i)
        solo.set_stats(pt.StatsConfig(stride=2))
        solo.update_n(6)
        _assert_bit_equal(ens.member_state(i), solo.state)
        for a, b in zip(ens.stats_state, solo.stats_state):
            scale = max(float(b.abs().max()), 1e-300)
            assert float((a[i] - b).abs().max()) <= 1e-12 * scale


# -- the banded solve's backward, the linearised models, the finder ---------------------


@pytest.mark.parametrize("case", ["adi", "poisson", "hc_general", "periodic_planes", "mesh_period"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_backward_matches_plain(device, dtype, case):
    """The solve's backward through autograd (``BandedSolveFn``) launches
    the kernel once on ``A^T``'s factors, and agrees with the plain
    recurrence on those factors: the parity path's lanes (ADI, tensor
    Poisson lanes), HC's general path, the periodic cell's complex planes,
    and a meshed member batch (factor batch stride and period)."""
    from rustpde_mpi_tpu_torch.ops.banded import BandedSolver

    kw = dict(device=device, dtype=dtype, step_kernel="dense", conv_kernel="dense")
    stride = period = 0
    if case == "adi":
        solver, shape, axis = pt.Navier2D(65, 65, 1e5, 1.0, 1e-2, 1.0, "rbc", **kw) \
            .solver_velx.solvers[1].solver, (2, 65, 63), 2
    elif case == "hc_general":
        solver = pt.Navier2D(65, 65, 1e5, 1.0, 1e-2, 1.0, "hc", **kw).solver_temp.solvers[1].solver
        shape, axis = (65, solver.n), 1
    elif case == "mesh_period":
        model = pt.Navier2D(65, 65, 1e5, 1.0, 1e-2, 1.0, "rbc", mesh=pt.make_mesh(4, device),
                            dtype=dtype)
        solver = model.solver_pres._solver.banded
        per = solver.kernel.lanes // 4
        shape, axis, stride, period = (3, 4, per, solver.n), 3, per, 4
    else:
        periodic = case == "periodic_planes"
        model = pt.Navier2D(64 if periodic else 65, 65, 1e5, 1.0, 1e-2, 1.0, "rbc",
                            periodic=periodic, **kw)
        solver = model.solver_pres._solver.banded
        shape, axis = (2, solver.kernel.lanes, solver.n), 2
    cplx = case == "periodic_planes"
    io = (torch.complex128 if dtype == torch.float64 else torch.complex64) if cplx else dtype
    rng = np.random.default_rng(8)
    b = _rand_like_io(rng, shape, io, device).requires_grad_(True)
    g = _rand_like_io(rng, shape, io, device)
    x = solver.solve(b, axis, factor_batch_stride=stride, factor_batch_period=period)
    (grad,) = torch.autograd.grad(x, b, g)
    back = solver.kernel.transposed()
    assert solver.kernel.launches == 1 and back.launches == 1
    plain = BandedSolver._along(lambda v: back.plain(v, stride, period), g, axis)
    got, want = (torch.view_as_real(t) if cplx else t for t in (grad, plain))
    assert _rel(got, want) <= TOL[dtype]


def _lnse_card(device, cls=None, n=17):
    cls = cls or pt.Navier2DLnse
    model = cls(n, n, 3e3, 1.0, 1e-2, 1.0, "rbc", mean=pt.MeanFields.new_rbc(n, n, device=device),
                device=device)
    model.init_random(1e-3, seed=1)
    return model


@pytest.mark.parametrize("nonlinear", [False, True], ids=["lnse", "nonlin"])
def test_lnse_gradient_directional_check_on_card(device, nonlinear):
    """``grad_autodiff`` at 17^2 (5 steps) on the card: every banded solve
    of the forward and of the backward is a kernel launch, and the
    gradient's directional derivative matches a central difference of the
    objective (rel 1e-6), and the CPU model's gradient (rel 1e-10)."""
    cls = pt.Navier2DNonLin if nonlinear else pt.Navier2DLnse
    model = _lnse_card(device, cls)
    val, grads = model.grad_autodiff(0.05)
    kernels = model.kernels()["banded_solve"]
    assert all(k.launches > 0 and k.transposed().launches > 0 for k in kernels)
    cpu = _lnse_card("cpu", cls)
    cval, cgrads = cpu.grad_autodiff(0.05)
    assert val == pytest.approx(cval, rel=1e-10)
    for g, c in zip(grads, cgrads):
        assert np.max(np.abs(g - c)) <= 1e-10 * np.max(np.abs(c))
    base = model._host_phys(model.state)
    objective = model._objective(5, 0.5, 0.5, None)
    rng = np.random.default_rng(0)
    dirs = [rng.standard_normal(a.shape) for a in base]
    eps = 1e-6

    def at(sign):
        return float(objective(*(model._place_physical(a + sign * eps * d)
                                 for a, d in zip(base, dirs))))

    fd = (at(1.0) - at(-1.0)) / (2 * eps)
    ad = -sum(float(np.sum(g * d)) for g, d in zip(grads, dirs))
    assert ad == pytest.approx(fd, rel=1e-6)


@pytest.mark.parametrize("route", ["fused", "dense", "mesh"])
def test_finder_ensemble_freezes_under_the_captured_graph(device, route):
    """A K = 2 finder ensemble at Ra 100 (``res_tol`` 1e-5; member 0 from
    rest, member 1 from a 1e-4 disturbance) on the card: the chunk replays
    the captured K-member step, each member freezes at its own convergence
    inside it, and counts, flags and states equal the CPU ensemble's."""
    kw = {"mesh": pt.make_mesh(4, device)} if route == "mesh" else {"device": device}
    if route == "dense":
        kw.update(step_kernel="dense", conv_kernel="dense")

    def members(**where):
        model = pt.build_model("adjoint", 17, 17, 100.0, 1.0, 1e-3, 1.0, "rbc", False,
                               scenario={"res_tol": 1e-5}, **where)
        rest = model.state
        model.init_random(1e-4, seed=1)
        return model, [rest, model.state]

    ens = pt.NavierEnsemble(*members(**kw))
    assert ens.chunk_runner().captured
    ens.update_n(64)
    route_kw = {} if route == "fused" else dict(step_kernel="dense", conv_kernel="dense")
    cpu = pt.NavierEnsemble(*members(device="cpu", **route_kw))
    cpu.update_n(64)
    assert ens.steps_done.tolist() == cpu.steps_done.tolist()
    assert 0 < ens.steps_done[0] < ens.steps_done[1] < 64
    assert ens.done_ok_members().tolist() == [True, True]
    assert not ens.alive().any() and ens.exit()
    # near rest the fields are 1e-7 and carry the roundoff of the O(1)
    # conduction lift (1.7e-16 absolute, card against CPU): the scale floor
    # is 1e-3
    for name in ("temp", "velx", "vely", "pres_adj"):
        space = ens.model.pres_space if name == "pres_adj" else getattr(ens.model, f"{name}_space")
        for i in range(2):
            got = space.gather_spectral(getattr(ens.state, name)[i]).cpu()
            want = getattr(cpu.state, name)[i]
            assert float(torch.max(torch.abs(got - want))) <= 1e-11 * max(
                float(torch.max(torch.abs(want))), 1e-3), (name, i)


# -- the flip's backward, Swift-Hohenberg, futures, digests ---------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.complex128,
                                   torch.complex64])
@pytest.mark.parametrize("members", [0, 3, 32])
@pytest.mark.parametrize("p,c,w", [(4, 3, 5), (2, 33, 33), (8, 1, 65)])
def test_flip_backward_matches_plain(device, dtype, members, p, c, w):
    """The flip's backward (``FlipFn``: the inverse flip, one launch) bit for
    bit its plain ring, both directions, with and without a member dim, on
    ragged pencils of 2, 4 and 8 ranks."""
    mesh = pt.make_mesh(p, device)
    ring = mesh.ring
    g = torch.Generator(device="cpu").manual_seed(5)
    for shape, x_to_y in (((p, p * c, w), True), ((p, c, p * w), False)):
        full = ((members,) if members else ()) + shape
        x = torch.randn(full, generator=g, dtype=torch.float64).to(device, dtype)
        x.requires_grad_(True)
        y = ring.apply(x, x_to_y)
        ct = torch.randn(tuple(y.shape), generator=g, dtype=torch.float64).to(device, dtype)
        before = (ring.launches, ring.backward_launches)
        (grad,) = torch.autograd.grad(y, x, ct)
        torch.cuda.synchronize()
        assert torch.equal(grad, ring.plain(ct, not x_to_y))
        assert (ring.launches - before[0], ring.backward_launches - before[1]) == (1, 1)
    plain = torch.zeros((p, p * c, w), dtype=torch.float64, device=device)
    assert ring.apply(plain, True).grad_fn is None


def test_meshed_gradient_matches_dense_on_card(device):
    """``grad_autodiff`` on the meshed route (4 ranks on the card) against
    the dense route's, 3 steps at 17^2: rel 1e-9 of each field's gradient."""
    grads = {}
    for route in ("dense", "mesh"):
        where = {"mesh": pt.make_mesh(4, device)} if route == "mesh" else {"device": device}
        model = pt.Navier2DLnse(17, 17, 3e3, 1.0, 1e-2, 1.0, "rbc",
                                mean=pt.MeanFields.new_rbc(17, 17, device="cpu"), **where)
        model.init_random(1e-3, seed=1)
        grads[route] = model.grad_autodiff(0.03)
    (vd, gd), (vm, gm) = grads["dense"], grads["mesh"]
    assert abs(vm - vd) <= 1e-9 * abs(vd)
    for a, b in zip(gm, gd):
        assert float(np.max(np.abs(a - b))) <= 1e-9 * float(np.max(np.abs(b)))


@pytest.mark.parametrize("dim", [1, 2])
def test_swift_hohenberg_card_matches_cpu(device, dim):
    """SH1D (nx = 256) and SH2D (64^2): 40 steps (one captured graph a
    bucket on the card) against the CPU, 1e-12 of the spectrum's scale."""
    if dim == 1:
        make = lambda dev: pt.SwiftHohenberg1D(256, 0.35, 0.02, 20.0, device=dev)  # noqa: E731
    else:
        make = lambda dev: pt.SwiftHohenberg2D(64, 64, 0.35, 0.02, 20.0, device=dev)  # noqa: E731
    card, cpu = make(device), make("cpu")
    card.update_n(40)
    cpu.update_n(40)
    assert card.chunk_runner(32).captured
    assert _rel(card.theta.cpu(), cpu.theta) <= 1e-12
    assert not card.exit()


def test_futures_do_not_read_a_later_chunk(device):
    """A pending chunk's sentinel scalars and an observables future are
    copied out when made: a later chunk replaying the same graph does not
    reach them."""
    a = pt.Navier2D(33, 33, 1e5, 1.0, 1e-3, 1.0, "rbc", device=device)
    b = pt.Navier2D(33, 33, 1e5, 1.0, 1e-3, 1.0, "rbc", device=device)
    for m in (a, b):
        m.init_random(0.1, seed=0)
        m.set_stability(pt.StabilityConfig())
    want = a.update_n(5)
    want_obs = a.get_observables()
    first = b.update_n_pending(5)
    obs = b.get_observables_async()
    later = b.update_n_pending(7)  # the same graph, the same carry buffers
    assert first.resolve() == want
    assert obs.result() == want_obs
    assert later.resolve().steps_done == 7


def test_digest_card_matches_cpu(device):
    """The digest of a state on the card equals the CPU digest of its copy,
    bit for bit, and per member."""
    model = pt.Navier2D(33, 33, 1e5, 1.0, 1e-3, 1.0, "rbc", device=device)
    model.init_random(0.1, seed=0)
    model.set_integrity(pt.IntegrityConfig())
    model.update_n(3)
    card = int(model.state_digest_async().result())
    assert card == int(pt.digest_tree([t.cpu() for t in model.state]))
    ens = pt.NavierEnsemble.from_seeds(model, range(3))
    np.testing.assert_array_equal(ens.state_digest_async().result(),
                                  pt.digest_tree([t.cpu() for t in ens.state], lead=1))


def test_digest_graph_outlives_other_shapes(device):
    """A captured digest keeps what its graph reads: after digests of 40
    other shapes and device memory reused by other tensors, a replay of the
    first state's digest graph still equals the CPU digest."""
    model = pt.Navier2D(33, 33, 1e5, 1.0, 1e-3, 1.0, "rbc", device=device)
    model.init_random(0.1, seed=0)
    model.set_integrity(pt.IntegrityConfig())
    first = int(model.state_digest_async().result())
    g = torch.Generator(device="cpu").manual_seed(7)
    for n in range(40):
        leaf = torch.randn((3 + n, 5), generator=g, dtype=torch.float64).to(device)
        assert int(pt.digest_tree([leaf])) == int(pt.digest_tree([leaf.cpu()]))
    filler = [torch.full((1 << 16,), -1, dtype=torch.int64, device=device) for _ in range(64)]
    model.update_n(2)
    again = int(model.state_digest_async().result())
    assert again == int(pt.digest_tree([t.cpu() for t in model.state]))
    assert first != again
    del filler


def test_event_watchdog_on_the_card(device):
    """The runner's dispatch watchdog waits on a CUDA event recorded after
    the enqueued work: a card spin past the deadline raises ``DispatchHang``
    at the deadline (the caller gets control back while the card is still
    busy), a short one returns its value, and with no deadline nothing
    waits for the card."""
    import time

    from rustpde_mpi_tpu_torch.utils.resilience import DispatchHang, dispatch_with_watchdog

    torch.cuda.synchronize()
    t0 = time.monotonic()
    with pytest.raises(DispatchHang, match="spin"):
        dispatch_with_watchdog(lambda: torch.cuda._sleep(4_000_000_000), 0.3, label="spin",
                               device=device)
    assert time.monotonic() - t0 < 1.5
    torch.cuda.synchronize()
    assert dispatch_with_watchdog(lambda: torch.cuda._sleep(1000) or 7, 5.0, device=device) == 7
    t0 = time.monotonic()
    dispatch_with_watchdog(lambda: torch.cuda._sleep(2_000_000_000), None, device=device)
    assert time.monotonic() - t0 < 0.5  # enqueued, not waited for
    torch.cuda.synchronize()


def _runner_card(device, tmp_path, name, **kw):
    from rustpde_mpi_tpu_torch.telemetry.metrics import ThroughputMonitor
    from rustpde_mpi_tpu_torch.utils import resilience

    model = pt.Navier2D(129, 129, 1e7, 1.0, kw.pop("dt", 2e-3), 1.0, "rbc", device=device)
    model.init_random(0.1, seed=0)
    model.write_intervall = 1e9
    run_dir = str(tmp_path / name)
    runner = pt.ResilientRunner(model, run_dir=run_dir, checkpoint_every_s=None,
                                _store=resilience._MemoryStore(run_dir), **kw)
    runner.slo = ThroughputMonitor(warmup=10**9)
    return model, runner


def test_runner_nan_rollback_on_card(device, tmp_path):
    """A NaN at step 50 of a 129^2 fused run rolls back to the anchor (the
    in-memory store: the card's machine may lack h5py) and retries at
    dt/2: the run ends bit for bit a clean run at dt/2."""
    model, runner = _runner_card(device, tmp_path, "nan", max_time=0.2, max_retries=1,
                                 fault="nan@50")
    summary = runner.run()
    assert summary["outcome"] == "done" and summary["retries"] == 1 and summary["dt"] == 1e-3
    clean = pt.Navier2D(129, 129, 1e7, 1.0, 1e-3, 1.0, "rbc", device=device)
    clean.init_random(0.1, seed=0)
    clean.update_n(summary["step"])
    assert all(torch.equal(a, b) for a, b in zip(model.state, clean.state))


def test_runner_telemetry_on_equals_off_on_card(device, tmp_path):
    """Telemetry never touches the captured graphs: the runner's state with
    metrics and tracing on equals the state with them off, bit for bit."""
    from rustpde_mpi_tpu_torch import telemetry

    states = []
    try:
        for on in (True, False):
            telemetry.set_enabled(on)
            model, runner = _runner_card(device, tmp_path, f"tele{on}", max_time=0.1,
                                         max_chunk_steps=10)
            assert runner.run()["outcome"] == "done"
            states.append([t.clone() for t in model.state])
    finally:
        telemetry.set_enabled(True)
    assert all(torch.equal(a, b) for a, b in zip(*states))


def _card_leaves(model):
    return {name: space.gather_spectral(getattr(model.state, name))
            for name, space in model._state_fields()}


def test_sharded_stage_and_restore_on_four_two_and_one_ranks(device):
    """A sharded snapshot staged from 4 ranks on the card restores, through
    the in-memory slab catalog (no ``h5py``), onto 4 ranks, 2 ranks and a
    serial dense model bit for bit, the manifest's digest verified."""
    from rustpde_mpi_tpu_torch.utils import checkpoint as ck

    def build(**kw):
        m = pt.Navier2D(65, 65, 1e5, 1.0, 0.01, 1.0, "rbc", **kw)
        m.set_integrity(pt.IntegrityConfig())
        return m

    model = build(mesh=pt.make_mesh(4))
    model.init_random(0.1, seed=1)
    model.update_n(5)
    snap = ck.sharded_snapshot_to_host(model, step=5)
    ck.stage_shard_digest(snap)
    want = _card_leaves(model)
    for kw in (dict(mesh=pt.make_mesh(4)), dict(mesh=pt.make_mesh(2)),
               dict(device=device, step_kernel="dense", conv_kernel="dense")):
        target = build(**kw)
        ck.restore_sharded_snapshots(target, [snap])
        got = _card_leaves(target)
        assert all(torch.equal(got[k], want[k]) for k in want) and target.time == model.time


def test_two_process_root_decides_on_the_card(tmp_path):
    """Two processes, each holding a tensor on the card, agree on the
    root's flag (the one on rank 1 alone is ignored)."""
    import os
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_mp_worker import spawn

    for rc, _, err, res in spawn(str(tmp_path), "card_root_decides", timeout=120.0):
        assert rc == 0, err[-3000:]
        assert res["flag_on_0"] is True and res["flag_on_1"] is False and res["on_card"]


def _spanning_on_cards(tmp_path, layout):
    """A mesh of 4 ranks over two processes (``tests/torch_mp_worker.py``,
    mode ``spanning_card``): every flip bit for bit its plain version, 37
    remote flips, one rank gather and 7 banded launches a step on each
    process, and the 129^2 state after 10 captured steps bit for bit the
    one-process ``make_mesh(4)`` run's on the card."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_mp_worker import spawn

    results = spawn(str(tmp_path), "spanning_card", layout, timeout=240.0)
    for rank, (rc, _, err, res) in enumerate(results):
        assert rc == 0 and res is not None, err[-3000:]
        assert len(res["flips"]) == 8 and all(res["flips"].values()), res["flips"]
        assert res["launches"] == {"banded_solve": 70, "ring_transpose": 370, "ring_gather": 10}
        assert res["device"] == f"cuda:{rank if layout == 'per_card' else 0}"
    one = pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", mesh=pt.make_mesh(4))
    one.init_random(0.1, seed=0)
    one.update_n(10)
    want = pt.state_to_numpy(one)
    got = np.load(os.path.join(str(tmp_path), "card.npz"))
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_spanning_mesh_of_two_processes_on_one_card(device, tmp_path):
    _spanning_on_cards(tmp_path, "shared")


def test_spanning_mesh_with_a_card_a_process(device, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    _spanning_on_cards(tmp_path, "per_card")


# -- serving (the scheduler, the warm pool) ------------------------------------------------------


def _serve_cfg(tmp_path, name, **kw):
    from rustpde_mpi_tpu_torch.config import ServeConfig

    kw.setdefault("run_dir", str(tmp_path / name))
    kw.setdefault("slots", 4)
    kw.setdefault("chunk_steps", 8)
    kw.setdefault("checkpoint_every_s", None)
    return ServeConfig(**kw)


_SERVE129 = dict(ra=1e7, pr=1.0, nx=129, ny=129, dt=2e-3, aspect=1.0, bc="rbc")


class _Kept(pt.SimServer):
    """A server that keeps each request's final member state as its lane is
    released (its observables are reduced over the batch, in another order
    than a solo run's: the states are compared bit for bit)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.final = {}

    def _release(self, ens, slot):
        if slot.req is not None:
            self.final[slot.req.id] = ens.member_state(slot.index)
        return super()._release(ens, slot)


def _same_as_solo(srv, rid, device):
    res = srv.result(rid)
    solo = _solo_state(res, device)
    assert all(torch.equal(a, b) for a, b in zip(srv.final[rid], solo.state))
    assert res["nu"] == pytest.approx(float(solo.eval_nu()), rel=1e-13)
    return res


def _solo_state(res, device):
    m = pt.Navier2D(129, 129, 1e7, 1.0, res["dt"], 1.0, "rbc", device=device)
    m.init_random(res["amp"] or 0.1, seed=res["seed"])
    m.update_n(res["steps"])
    return m


def test_served_results_equal_solo_runs_on_card(device, tmp_path):
    """Six requests through four lanes on the fused route at 129^2 (two
    refills): each result's Nu equals its solo run's bit for bit (members
    are their solo runs at 129^2)."""
    srv = _Kept(_serve_cfg(tmp_path, "s"), device=device)
    ids = [srv.submit(dict(_SERVE129, horizon=(8 + s) * 2e-3, seed=s)).id for s in range(6)]
    assert srv.serve()["completed"] == 6
    for rid in ids:
        _same_as_solo(srv, rid, device)


def test_warm_capture_concurrent_with_a_running_campaign(device, tmp_path):
    """The warm pool captures the dt/2 bucket's graphs on its thread while
    the first bucket's campaign replays its own (``nan@4`` sends every
    request there): both buckets are pool hits, the retried requests equal
    their solo runs, and a capture on a thread beside replays leaves the
    replaying run bit for bit undisturbed."""
    import threading

    key = pt.SimRequest(**_SERVE129, horizon=0.1).compat_key
    key2 = pt.SimRequest(**dict(_SERVE129, dt=1e-3), horizon=0.1).compat_key
    cfg = _serve_cfg(tmp_path, "w", warm_profile=[{"key": list(key), "k": 4},
                                                  {"key": list(key2), "k": 4}])
    srv = _Kept(cfg, device=device, fault="nan@4")
    ids = [srv.submit(dict(_SERVE129, horizon=32 * 2e-3, seed=s)).id for s in range(4)]
    assert srv.serve()["completed"] == 4
    import os

    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    names = [e["event"] for e in read_journal(os.path.join(cfg.run_dir, "journal.jsonl"))]
    assert names.count("warm_pool_hit") == 2 and "request_retry" in names
    for rid in ids:
        assert _same_as_solo(srv, rid, device)["retries"] == 1
    cell = dict(_SERVE129)
    runs = []
    for concurrent in (False, True):
        ens = pt.NavierEnsemble.from_seeds(pt.Navier2D(**cell, device=device), range(4))
        ens.chunk_runner()
        other = threading.Thread(target=lambda: pt.NavierEnsemble.from_seeds(
            pt.Navier2D(**dict(cell, dt=5e-4), device=device), range(4)).chunk_runner())
        if concurrent:
            other.start()
        for _ in range(20):
            ens.update_n(8)
        if concurrent:
            other.join()
        runs.append(ens.state)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_graphs_freed_beside_a_capture_on_card(device):
    """A captured ensemble is dropped and collected on this thread while
    another thread is inside a capture: its graphs are not freed there but
    left to the next capture (:data:`..campaign.CAPTURE_LOCK`), and both the
    dropped ensemble's run and the run of the graph captured meanwhile are
    bit for bit those of the same runs without the overlap."""
    import gc
    import threading

    from rustpde_mpi_tpu_torch.models import campaign

    def ensemble(dt):
        return pt.NavierEnsemble.from_seeds(pt.Navier2D(**dict(_SERVE129, dt=dt),
                                                        device=device), range(4))

    runs = []
    for overlap in (False, True):
        doomed = ensemble(2e-3)
        doomed.update_n(16)
        first = [t.clone() for t in doomed.state]
        other = ensemble(1e-3)
        capturing, resume, built = threading.Event(), threading.Event(), []
        calls, inner = [], other.model._advance_members

        def advance(*a, **kw):
            calls.append(1)
            if len(calls) == 2:  # the captured call (the first is the warm-up)
                capturing.set()
                resume.wait(60)
            return inner(*a, **kw)

        other.model._advance_members = advance
        thread = threading.Thread(target=lambda: built.append(other.chunk_runner()))
        thread.start()
        assert capturing.wait(60)
        if overlap:
            graphs = len(doomed.chunk_runner()._graphs)
            del doomed
            gc.collect()
            assert len(campaign._RETIRED) == graphs  # not freed inside the capture
        resume.set()
        thread.join(60)
        assert built and built[0].captured
        del other.model._advance_members
        other.update_n(16)
        runs.append((first, list(other.state)))
        if not overlap:
            del doomed
        ensemble(2e-3).chunk_runner()  # the next capture frees the retired graphs
        assert not campaign._RETIRED
    (a1, b1), (a2, b2) = runs
    assert all(torch.equal(x, y) for x, y in zip(a1 + b1, a2 + b2))


def test_drain_and_restart_bit_for_bit_on_card(device, tmp_path):
    """A SIGTERM drain (``kill@8``) checkpoints the slot table through the
    default store (``.npz`` files where ``h5py`` does not import); a second
    server restores the drained lanes mid-trajectory, and every result
    equals its undrained solo run bit for bit."""
    cfg = _serve_cfg(tmp_path, "d", slots=2, chunk_steps=4)
    first = pt.SimServer(cfg, device=device, fault="kill@8")
    ids = [first.submit(dict(_SERVE129, horizon=20 * 2e-3, seed=s)).id for s in range(3)]
    assert first.serve()["outcome"] == "drained"
    second = _Kept(cfg, device=device)
    assert second.serve()["completed"] == 3
    for rid in ids:
        assert _same_as_solo(second, rid, device)["steps"] == 20


def test_served_spanning_campaigns_of_two_processes_on_one_card(device, tmp_path):
    """``SimServer`` on two processes sharing the card
    (``tests/torch_mp_worker.py``, mode ``served_spanning_card``): every
    campaign on a mesh spanning both processes (the whole-fleet mesh of 16
    rank slots for 129^2, the gang's 2-slot sub-mesh for 130^2), every
    request done, and each result's observables within 1e-12 of a solo run
    of the request on a one-process mesh of the same rank count on the
    card."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_mp_worker import CARD_SERVE_REQ, spawn

    results = spawn(str(tmp_path), "served_spanning_card", timeout=300.0)
    for rc, _, err, res in results:
        assert rc == 0 and res is not None, err[-3000:]
    root = results[0][3]
    want_meshes = {"fleet": {(129, 129): 16}, "gang": {(130, 130): 2, (129, 129): 16}}
    for part, meshes in want_meshes.items():
        rec = root[part]
        assert rec["outcome"] == "idle" and rec["completed"] == len(rec["results"])
        assert {(nx, ny): p for nx, ny, p, spanning in rec["meshes"] if spanning} == meshes
        for i, res in enumerate(rec["results"]):
            n = 130 if part == "gang" and i == 0 else 129  # the gang request goes first
            model = pt.Navier2D(n, n, CARD_SERVE_REQ["ra"], 1.0, res["dt"], 1.0, "rbc",
                                mesh=pt.make_mesh(meshes[(n, n)]))
            model.init_random(res["amp"] or 0.1, seed=res["seed"])
            model.update_n(res["steps"])
            want = dict(zip(model.observable_names, model.get_observables()))
            for name in ("nu", "nuvol", "re", "div"):
                assert abs(res[name] - want[name]) <= 1e-12 * max(abs(want[name]), 1e-300), \
                    (part, res["seed"], name, res[name], want[name])


@pytest.mark.parametrize("arg", ["cuda", "cuda_stall"])
def test_spanning_gang_loss_on_the_card_within_the_deadline(device, tmp_path, arg):
    """A 34^2 gang on a 2-slot sub-mesh spanning two processes on card 0
    (``tests/torch_mp_worker.py``, mode ``gang_kill``) loses member 1 at
    step 6: SIGKILLed (``cuda``), or stalled past the dispatch watchdog's
    deadline before its next chunk, so that it never pushes its chunks
    (``cuda_stall``: the survivor's chunk waits in a remote flip on the
    card until its watchdog releases the waits).  The survivor's serve ends
    in the typed gang loss (a ``gang_member_lost`` row, the request
    requeued with its progress) within the deadline (``GANG_DEADLINE_S``)
    plus 10 s of the fault, not in a hang."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_mp_worker import GANG_DEADLINE_S, spawn

    outs = spawn(str(tmp_path), "gang_kill", arg, timeout=180.0)
    (rc0, _, err0, res), (rc1, _, err1, other) = outs
    assert rc0 == 0 and res is not None, err0[-3000:]
    rows = {e["event"]: e for e in res["events"]}
    if arg == "cuda":
        assert rc1 == -9, err1[-3000:]
        with open(tmp_path / "killed_at", encoding="utf-8") as fh:
            fault_at = float(fh.read())
    else:
        assert rc1 == 0 and other["error"][0] == "DispatchHang", err1[-3000:]
        assert res["error"][0] == "DispatchHang"
        fault_at = rows["fault_injected"]["t"]
    assert res["error"] is not None
    assert 0.0 <= res["ended_at"] - fault_at <= GANG_DEADLINE_S + 10.0, res["ended_at"] - fault_at
    assert rows["gang_member_lost"]["gang"] == rows["gang_formed"]["gang"] == 0
    requeued = rows["request_requeued"]
    assert requeued["id"] == res["ids"][0] and "progress" in requeued
    assert res["queue"]["queued"] == 1 and res["queue"]["running"] == 0

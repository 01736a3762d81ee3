"""PyTorch port: the fused convection and fused stage wrappers on the CPU.

Each wrapper of the port holds a hand-written CUDA kernel and, beside it,
a plain PyTorch version of the same function.  On the CPU the wrapper runs
the plain version; these tests hold it to the JAX package's Pallas kernels
(``FusedStage.apply`` / ``FusedConv.apply``, run in interpret mode as the
JAX package's own tests run them) on the same numpy inputs, at 17^2 and
33^2 in f64.  Tolerance: 1e-12 of max|out| -- the same linear maps summed
in another order.  The kernels themselves run only on a CUDA card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.ops import _build
from rustpde_mpi_tpu_torch.ops.fused_conv import FusedConv
from rustpde_mpi_tpu_torch.ops.fused_step import FusedStage, StageTerm

STAGES = ("velx", "vely", "temp", "div", "poisson", "projx", "projy")
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The grids are tiny: one intra-op thread keeps torch from competing
    with the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(n):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RUSTPDE_CONV_KERNEL", "pallas")
        mp.setenv("RUSTPDE_STEP_KERNEL", "pallas")
        ref = rp.Navier2D(n, n, 1e5, 1.0, 2e-3, 1.0, "rbc", periodic=False)
    assert ref._step_impl is not None and ref._conv_impl is not None
    port = pt.Navier2D(n, n, 1e5, 1.0, 2e-3, 1.0, "rbc", device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def pair17():
    return _pair(17)


@pytest.fixture(scope="module")
def pair33():
    return _pair(33)


@pytest.fixture(params=[17, 33])
def pair(request, pair17, pair33):
    return {17: pair17, 33: pair33}[request.param]


def _assert_close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want)))
    assert scale > 0.0
    assert float(np.max(np.abs(got - want))) <= TOL * scale


# -- (b) every stage and both conv variants against the Pallas kernels ---------


@pytest.mark.parametrize("tag", STAGES)
def test_stage_plain_matches_pallas_stage(pair, tag):
    ref, port = pair
    st = port._stages[tag]
    rng = np.random.default_rng(len(tag))
    xs = [rng.uniform(-1.0, 1.0, (k0, k1)) for k0, k1 in zip(st.k0, st.k1)]
    want = ref._step_impl[tag].apply(*[np.asarray(x) for x in xs])
    got = st.apply(*[torch.as_tensor(x) for x in xs])
    _assert_close(got, want)
    torch.testing.assert_close(got, st.plain(*[torch.as_tensor(x) for x in xs]), rtol=0, atol=0)
    assert st.flops == ref._step_impl[tag].flops
    assert st.launches == 0


@pytest.mark.parametrize("with_bc", [False, True])
def test_conv_plain_matches_pallas_conv(pair, with_bc):
    ref, port = pair
    space = "temp_space" if with_bc else "velx_space"
    fc = port._convs[id(getattr(port, space))]
    jfc = ref._conv_impl[id(getattr(ref, space))]
    n = (port.nx, port.ny)
    rng = np.random.default_rng(5)
    args = [rng.uniform(-1.0, 1.0, n), rng.uniform(-1.0, 1.0, n),
            rng.uniform(-1.0, 1.0, (fc.mx, fc.my))]
    if with_bc:
        args += [rng.uniform(-1.0, 1.0, n), rng.uniform(-1.0, 1.0, n)]
    want = jfc.apply(*args)
    got = fc.apply(*[torch.as_tensor(a) for a in args])
    _assert_close(got, want)
    assert fc.flops == jfc.flops
    assert fc.launches == 0


def test_model_builds_seven_stages_and_two_convs(pair17):
    ref, port = pair17
    assert sorted(port._stages) == sorted(ref._step_impl)
    assert len(port._convs) == len(ref._conv_impl) == 2
    assert port._convs[id(port.velx_space)] is port._convs[id(port.vely_space)]


# -- the wrappers refuse what their kernels do not take -------------------------


def test_stage_wrapper_checks_inputs(pair17):
    _, port = pair17
    st = port._stages["temp"]
    good = [torch.zeros((k0, k1), dtype=torch.float64) for k0, k1 in zip(st.k0, st.k1)]
    with pytest.raises(ValueError, match="takes 2 inputs"):
        st.apply(good[0])
    with pytest.raises(ValueError, match="shape"):
        st.apply(good[0][:-1], good[1])
    with pytest.raises(ValueError, match="float32"):
        st.apply(good[0].float(), good[1])


def test_conv_wrapper_checks_inputs(pair17):
    _, port = pair17
    fc = port._convs[id(port.temp_space)]
    n = (port.nx, port.ny)
    ux = torch.zeros(n, dtype=torch.float64)
    vhat = torch.zeros((fc.mx, fc.my), dtype=torch.float64)
    with pytest.raises(ValueError, match="both bc"):
        fc.apply(ux, ux, vhat, ux)
    with pytest.raises(ValueError, match="shape"):
        fc.apply(ux, ux, ux)
    with pytest.raises(ValueError, match="float32"):
        fc.apply(ux.float(), ux, vhat)


def test_stage_and_conv_rules():
    eye = np.eye(3)
    # five terms (the Coriolis vely stage) is the most one output sums
    five = FusedStage("x", [StageTerm(eye, eye)] * 5, device="cpu", dtype=torch.float64)
    x = torch.ones((3, 3), dtype=torch.float64)
    assert torch.equal(five.apply(*[x] * 5), 5.0 * x)
    with pytest.raises(ValueError, match="1..5 terms"):
        FusedStage("x", [StageTerm(eye, eye)] * 6, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="share their output"):
        FusedStage("x", [StageTerm(eye, eye), StageTerm(np.eye(4), eye)],
                   device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="post-solve"):
        FusedStage("x", [StageTerm(eye, eye)], device="cpu", dtype=torch.float64,
                   const=eye, modal=(eye, eye, eye))
    a = pt.Space2(pt.cheb_dirichlet(9), pt.chebyshev(9), device="cpu", dtype=torch.float64)
    b = pt.Space2(pt.chebyshev(11), pt.chebyshev(11), device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="physical grid"):
        FusedConv(a, b, (1.0, 1.0))


def test_no_fallback_off_the_cpu():
    """A tensor on a device with no kernel raises; it never takes the plain
    version."""
    eye = np.eye(4)
    st = FusedStage("meta", [StageTerm(eye, eye)], device="meta", dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no fused-stage kernel"):
        st.apply(torch.empty((4, 4), dtype=torch.float64, device="meta"))
    assert st.launches == 0
    sp = pt.Space2(pt.cheb_dirichlet(9), pt.cheb_dirichlet(9), device="meta", dtype=torch.float64)
    fs = pt.Space2(pt.chebyshev(9), pt.chebyshev(9), device="meta", dtype=torch.float64)
    fc = FusedConv(sp, fs, (1.0, 1.0))
    u = torch.empty((9, 9), dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="no fused-conv kernel"):
        fc.apply(u, u, torch.empty((7, 7), dtype=torch.float64, device="meta"))
    assert fc.launches == 0


# -- the build and the C interface, as far as they run without a card ----------


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_named_by_source_hash(monkeypatch):
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert _build.source_hash(name) in path.name
    before = _build.source_hash("fused_stage")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX",))
    assert _build.source_hash("fused_stage") != before
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_signatures_name_each_libraries_entry_points():
    """Every C entry point of a source has a ctypes signature and each is
    exported by exactly one library."""
    seen = []
    for name in _build.KERNELS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        exported = re.findall(r'extern "C" int (\w+)\(', text)
        assert sorted(exported) == sorted(_build._SIGNATURES[name]), name
        seen += exported
    assert len(seen) == len(set(seen))


def test_job_struct_mirrors_the_c_layout():
    """``RpJob`` in csrc/fused_stage.cu: four pointers, two arrays of five
    pointers, the member strides (two arrays of five ``long long`` and four
    more), then 25 ints (the last the copy-width flags ``vec``), padded to
    pointer alignment; ``MAX_TERMS`` and ``MAX_JOBS`` (5, the Coriolis
    ``vely`` stage's five products and its five ``L @ x`` jobs) equal the
    C constants, and a launch's five jobs stay far inside the 4 KB kernel
    parameter limit."""
    p, i = ctypes.sizeof(ctypes.c_void_p), ctypes.sizeof(ctypes.c_int)
    q = ctypes.sizeof(ctypes.c_longlong)
    raw = 14 * p + 14 * q + 25 * i
    assert ctypes.sizeof(_build.RpJob) == -(-raw // p) * p
    assert _build.RpJob.sA.offset == 14 * p
    assert _build.RpJob.sM.offset == 14 * p + 13 * q
    assert _build.RpJob.M.offset == 14 * p + 14 * q
    assert _build.RpJob.ldm.offset == 14 * p + 14 * q + 23 * i
    assert _build.RpJob.vec.offset == 14 * p + 14 * q + 24 * i
    assert _build.MAX_JOBS * ctypes.sizeof(_build.RpJob) + i <= 4096
    names = [f[0] for f in _build.RpJob._fields_]
    text = (_build.CSRC / "fused_stage.cu").read_text()
    for name in ("MAX_TERMS", "MAX_JOBS"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == \
            getattr(_build, name) == 5, name
    body = text[text.index("struct RpJob {"):text.index("};", text.index("struct RpJob {"))]
    pos = [body.index(f" {n}") for n in names]
    assert pos == sorted(pos), "field order differs from the C struct"


def test_job_validates_operands():
    a = torch.zeros((5, 3), dtype=torch.float64)
    b = torch.zeros((3, 4), dtype=torch.float64)
    out = torch.zeros((6, 7), dtype=torch.float64)
    j = _build.job(out, [(a, b)], M=5, N=4, Mout=6, Nout=7, E=out)
    assert (j.M, j.N, j.Mout, j.Nout, j.nt) == (5, 4, 6, 7, 1)
    assert (j.K[0], j.lda[0], j.ldb[0], j.ldc, j.lde) == (3, 3, 4, 7, 7)
    assert j.F is None and j.mask is None
    with pytest.raises(ValueError, match="do not give"):
        _build.job(out, [(a, b.T.contiguous())], M=5, N=4)
    with pytest.raises(ValueError, match="unit column stride"):
        _build.job(out, [(a, b[:, ::2])], M=5, N=2)
    assert _build.job(out, [(a, b)] * 5, M=5, N=4).nt == 5
    with pytest.raises(ValueError, match="1..5 products"):
        _build.job(out, [(a, b)] * 6, M=5, N=4)
    with pytest.raises(ValueError, match="depth 0"):
        _build.job(out, [(a[:, :0], b[:0])], M=5, N=4)
    with pytest.raises(ValueError, match="smaller than"):
        _build.job(out, [(a, b)], M=5, N=4, mask=torch.zeros((2, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="1..5 jobs"):
        _build.launch_jobs(None, [], torch.device("cpu"))
    with pytest.raises(ValueError, match="1..5 jobs"):
        _build.launch_jobs(None, [j] * 6, torch.device("cpu"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_padded_rows_start_on_16_bytes(dtype):
    """``padded`` rounds the row length up to 16 bytes and hands back a view
    of the asked width; ``aligned`` copies only what is not aligned yet."""
    per = 16 // dtype.itemsize
    for cols in (1, per - 1, per, per + 1, 1023, 1025):
        x = _build.padded(5, cols, device="cpu", dtype=dtype)
        assert x.shape == (5, cols) and x.stride(1) == 1
        assert x.stride(0) % per == 0 and x.stride(0) - cols < per
        assert _build.rows_aligned(x)
        y = torch.arange(5.0 * cols, dtype=dtype).view(5, cols)
        z = _build.aligned(y)
        assert _build.rows_aligned(z) and torch.equal(z, y)
        assert (z is y) == (cols % per == 0)
        assert _build.aligned(z) is z


def test_job_sets_the_copy_width_per_operand():
    """Bit 2t of ``vec`` for A[t], bit 2t+1 for B[t]: set only when the base
    pointer and the row stride are both multiples of 16 bytes."""
    f64 = torch.float64
    even = _build.padded(8, 8, device="cpu", dtype=f64)          # 64-byte rows
    odd = torch.zeros((8, 7), dtype=f64)                          # 56-byte rows
    shifted = _build.padded(8, 10, device="cpu", dtype=f64)[:, 1:9]  # base 8 bytes in
    out = torch.zeros((8, 8), dtype=f64)
    assert _build.rows_aligned(even) and not _build.rows_aligned(odd)
    assert not _build.rows_aligned(shifted)
    assert _build.job(out, [(even, even)], M=8, N=8).vec == 0b11
    assert _build.job(out, [(even, odd)], M=8, N=7).vec == 0b01
    assert _build.job(out, [(shifted, even)], M=8, N=8).vec == 0b10
    j = _build.job(out, [(even, even), (shifted, even), (even, odd), (odd, even[:7])], M=8, N=7)
    assert j.vec == 0b10_01_10_11  # B[3], A[2], B[1], A[0] and B[0]


@pytest.mark.parametrize("current", [0, 1])
def test_call_makes_the_launch_device_current(monkeypatch, current):
    """An entry point gets its arguments and then the launch device's
    stream; the call switches to that device only when another one is
    current, and raises on a non-zero return."""
    entered = []

    class Switch:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", Switch)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 1000 + device.index)
    got = []

    def entry(*args):
        got.append(args)
        return 0

    entry.__name__ = "rp_entry"
    dev = torch.device("cuda", 1)
    _build.call(entry, dev, 3, 4)
    assert got == [(3, 4, 1001)]
    assert entered == ([] if current == 1 else [dev])
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _build.call(lambda *a: 700, dev)


def test_signatures_match_the_c_parameter_types():
    """Each ctypes ``argtypes`` entry matches its C parameter: ``int`` ->
    c_int, ``long long`` -> c_longlong (the banded and pencil-transpose
    kernels' strides, which a 32-bit int would cut), a pointer -> c_void_p
    (or the job or push struct, or the address of a pointer the call
    sets)."""
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "const RpJob*": ctypes.POINTER(_build.RpJob),
             "const RpPush*": ctypes.POINTER(_build.RpPush),
             "void**": ctypes.POINTER(ctypes.c_void_p)}
    assert "banded_solve" in _build.KERNELS and "ring_transpose" in _build.KERNELS
    assert _build._SIGNATURES["ring_transpose"]["rp_ring_transpose_f64"] == \
        _build._SIGNATURES["ring_transpose"]["rp_ring_transpose_f32"]
    for name in _build.KERNELS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = [" ".join(p.split()[:-1]) for p in params.split(",")]
            want = [ctypes.c_void_p if t.endswith("void*") else ctype[t] for t in types]
            argtypes, restype = _build._SIGNATURES[name][fn]
            assert argtypes == want, fn
            assert restype is ctypes.c_int

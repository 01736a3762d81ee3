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
    with pytest.raises(ValueError, match="1..4 terms"):
        FusedStage("x", [StageTerm(eye, eye)] * 5, device="cpu", dtype=torch.float64)
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
    """``RpJob`` in csrc/fused_stage.cu: four pointers, two arrays of four
    pointers, then 21 ints, padded to pointer alignment."""
    p, i = ctypes.sizeof(ctypes.c_void_p), ctypes.sizeof(ctypes.c_int)
    raw = 12 * p + 21 * i
    assert ctypes.sizeof(_build.RpJob) == -(-raw // p) * p
    assert _build.RpJob.M.offset == 12 * p
    assert _build.RpJob.ldm.offset == 12 * p + 20 * i
    names = [f[0] for f in _build.RpJob._fields_]
    text = (_build.CSRC / "fused_stage.cu").read_text()
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
    with pytest.raises(ValueError, match="1..4 products"):
        _build.job(out, [(a, b)] * 5, M=5, N=4)
    with pytest.raises(ValueError, match="smaller than"):
        _build.job(out, [(a, b)], M=5, N=4, mask=torch.zeros((2, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="1..4 jobs"):
        _build.launch_jobs(None, [], torch.device("cpu"))

"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (here, on the CPU
test run) and runs on a machine with one.  This file imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the kernels and ``torch.matmul`` sum the same products in
another order; 1e-12 of max|plain| in f64 and 1e-4 in f32.
"""

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.ops import _build

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


def test_step_on_card_matches_cpu(device):
    """Ten steps through the kernels agree with ten plain steps on the CPU
    (rel 1e-11 of each field's scale), with 3 conv and 7 stage launches a
    step."""
    states = {}
    for dev in (device, torch.device("cpu")):
        m = pt.Navier2D.new_confined(33, 33, 1e5, 1.0, 2e-3, 1.0, "rbc", device=dev)
        m.update_n(10)
        states[dev.type] = (pt.state_to_numpy(m), m)
    card = states["cuda"][1]
    assert sum(c.launches for c in card._convs.values()) == 30
    assert sum(s.launches for s in card._stages.values()) == 70
    for name, ref in states["cpu"][0].items():
        scale = max(float(np.max(np.abs(ref))), 1e-300)
        assert float(np.max(np.abs(states["cuda"][0][name] - ref))) <= 1e-11 * scale, name

"""PyTorch port: the banded LU solve against the JAX package, on the CPU.

``rustpde_mpi_tpu_torch.ops.banded`` factors on the host and solves through
the wrapper of the hand-written CUDA kernel (``ops/banded_solve.py``); on a
CPU tensor the wrapper runs its plain PyTorch recurrence.  These tests hold
it to the JAX package's ``BandedSolver`` (the ``lax.scan`` recurrence) and
``PallasBandedSolver`` (the Pallas kernel in interpret mode, as the JAX
package's own tests run it) on the same numpy inputs, at the shapes of
``tests/test_pallas_banded.py``.  Tolerances: the host factors are the same
numpy arithmetic, so they agree bit for bit; the solves agree to 1e-12 of
max|x| (the same recurrence, its multiply-subtracts possibly fused); the
``A x = b`` round trip to 1e-12 of max|b| (well-conditioned systems).  The
kernel itself runs only on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rustpde_mpi_tpu.ops import banded as jbanded
from rustpde_mpi_tpu.ops.pallas_banded import PallasBandedSolver
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.ops import banded as tbanded
from rustpde_mpi_tpu_torch.ops.banded_solve import (
    BandedSolve, couples_one_parity, reciprocals, shared_bytes, tile_lanes, vector_copies)

P, Q = 2, 4
SHAPES = [(16, 8), (33, 130), (64, 128)]
TOL = 1e-12


def _system(n, seed=0, batch=()):
    """Diagonally dominant banded matrices, (*batch, n, n)."""
    rng = np.random.default_rng(seed)
    band = np.tril(np.triu(np.ones((n, n)), -P), Q)
    return rng.uniform(0.2, 0.6, batch + (n, n)) * band + 4.0 * np.eye(n)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= tol * float(np.max(np.abs(want)))


def _solver(dense):
    return tbanded.BandedSolver.from_dense(dense, P, Q, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("n", [16, 33])
def test_lu_factor_matches_reference_bit_for_bit(n, batch):
    dense = _system(n, seed=n, batch=batch)
    got, want = tbanded.banded_lu_factor(dense, P, Q), jbanded.banded_lu_factor(dense, P, Q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,lanes", SHAPES)
def test_axis0_matches_scan_and_pallas(n, lanes):
    dense = _system(n)
    b = np.random.default_rng(1).standard_normal((n, lanes))
    got = _solver(dense).solve(torch.as_tensor(b), 0).numpy()
    _close(got, jbanded.BandedSolver(dense, P, Q).solve(jnp.asarray(b), 0))
    _close(got, PallasBandedSolver(dense, P, Q, interpret=True).solve(jnp.asarray(b), 0))


@pytest.mark.parametrize("n,lanes", SHAPES)
def test_axis1_matches_scan(n, lanes):
    dense = _system(n, seed=2)
    b = np.random.default_rng(3).standard_normal((lanes, n))
    got = _solver(dense).solve(torch.as_tensor(b), 1).numpy()
    _close(got, jbanded.BandedSolver(dense, P, Q).solve(jnp.asarray(b), 1))


@pytest.mark.parametrize("per_lane", [False, True])
def test_batch_dims_match_unbatched(per_lane):
    """Leading batch dims ride along: each item solves as it would alone
    (the per-lane factors align with the lanes of every item)."""
    n, lanes = 16, 8
    solver = _solver(_system(n, seed=12, batch=(lanes,) if per_lane else ()))
    rng = np.random.default_rng(13)
    bb = torch.as_tensor(rng.standard_normal((3, n, lanes)))
    got = solver.solve(bb, 1)
    for i in range(3):
        torch.testing.assert_close(got[i], solver.solve(bb[i], 0), rtol=0, atol=1e-15)
    bb = torch.as_tensor(rng.standard_normal((2, lanes, n)))
    got = solver.solve(bb, -1)
    for i in range(2):
        torch.testing.assert_close(got[i], solver.solve(bb[i], 1), rtol=0, atol=1e-15)


@pytest.mark.parametrize("n,lanes", SHAPES)
def test_per_lane_factors_match_batched_scan(n, lanes):
    """One factor set per lane (the tensor solver's use) against the JAX
    ``BandedSolver`` with batched factors; along axis 0 the lanes are the
    columns."""
    dense = _system(n, seed=4, batch=(lanes,))
    solver = _solver(dense)
    assert solver.kernel.per_lane and tuple(solver.kernel.lower.shape) == (P, n, lanes)
    b = np.random.default_rng(5).standard_normal((lanes, n))
    got = solver.solve(torch.as_tensor(b), 1)
    _close(got.numpy(), jbanded.BandedSolver(dense, P, Q).solve(jnp.asarray(b), 1))
    got0 = solver.solve(torch.as_tensor(b.T.copy()), 0)
    torch.testing.assert_close(got0, got.T, rtol=0, atol=1e-15)


@pytest.mark.parametrize("per_lane", [False, True])
def test_solution_reconstructs_rhs(per_lane):
    """``A x = b`` round trip."""
    n, lanes = 24, 5
    dense = _system(n, seed=6, batch=(lanes,) if per_lane else ())
    b = np.random.default_rng(7).standard_normal((lanes, n))
    x = _solver(dense).solve(torch.as_tensor(b), 1).numpy()
    back = np.einsum("...ij,...j->...i", dense, x)
    _close(back, b)


def test_dense_solver_and_apply_along_match_reference():
    n = 17
    dense = _system(n, seed=8)
    rng = np.random.default_rng(9)
    b = rng.standard_normal((2, n, n))
    solver = tbanded.DenseSolver(dense, device="cpu", dtype=torch.float64)
    ref = jbanded.DenseSolver(dense)
    torch.testing.assert_close(solver.solve(torch.as_tensor(b), 1),
                               torch.as_tensor(np.linalg.solve(dense, b)), rtol=0, atol=1e-14)
    _close(solver.solve(torch.as_tensor(b), 2).numpy(), ref.solve(jnp.asarray(b), 2))
    m = torch.as_tensor(rng.standard_normal((n, n)))
    x = torch.as_tensor(b)
    torch.testing.assert_close(tbanded.apply_along(m, x, 1), m @ x, rtol=0, atol=0)
    torch.testing.assert_close(tbanded.apply_along(m, x, -1), x @ m.T, rtol=0, atol=0)
    want = torch.einsum("ij,jkl->ikl", m[:2, :2], x)
    torch.testing.assert_close(tbanded.apply_along(m[:2, :2], x, 0), want, rtol=1e-14, atol=1e-14)


# -- the wrapper ------------------------------------------------------------------


def _wrapper(n=9, lanes=None, device="cpu"):
    batch = (lanes,) if lanes else ()
    lower, upper = tbanded.banded_lu_factor(_system(n, seed=10, batch=batch), P, Q)
    return BandedSolve(lower, upper, device=device, dtype=torch.float64)


def test_wrapper_plain_on_cpu_and_checks_inputs():
    bs = _wrapper()
    b = torch.as_tensor(np.random.default_rng(11).standard_normal((2, 9, 3)))
    torch.testing.assert_close(bs.apply(b), bs.plain(b), rtol=0, atol=0)
    assert bs.launches == 0
    with pytest.raises(ValueError, match="shape"):
        bs.apply(b[:, :8])
    with pytest.raises(ValueError, match="float32"):
        bs.apply(b.float())
    with pytest.raises(ValueError, match="lanes"):
        _wrapper(lanes=4).apply(b)
    with pytest.raises(ValueError, match="disagree"):
        BandedSolve(np.zeros((2, 9)), np.zeros((5, 8)), device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="unsupported dtype"):
        BandedSolve(np.zeros((2, 9)), np.ones((5, 9)), device="cpu", dtype=torch.float16)


def test_wrapper_raises_off_cpu_and_cuda():
    bs = _wrapper(device="meta")
    with pytest.raises(RuntimeError, match="no banded-solve kernel"):
        bs.apply(torch.empty((1, 9, 4), dtype=torch.float64, device="meta"))
    assert bs.launches == 0


def test_wrapper_accounting():
    """Flops count each band term a row has (2 flops) and one division a
    row; bytes count the rhs, the solution and the factors once."""
    n, lanes = 16, 8
    for bs, factor_values in ((_wrapper(n), 7 * n), (_wrapper(n, lanes), 7 * n * lanes)):
        dense_terms = sum(min(i, P) + min(n - 1 - i, Q) for i in range(n))
        assert bs.flops((3, n, lanes)) == 3 * lanes * (2 * dense_terms + n)
        assert bs.bytes_moved((3, n, lanes)) == 8 * (2 * 3 * n * lanes + factor_values)


@pytest.mark.parametrize("per_lane", [False, True])
def test_plain_skips_zero_couplings_exactly(per_lane):
    """A system that couples rows of one parity only (the Chebyshev case):
    the plain recurrence leaves out the zero off-diagonals and still
    matches a dense solve (1e-12 of max|x|), leaving the rhs untouched."""
    n, lanes = 20, 6
    dense = _system(n, seed=14, batch=(lanes,) if per_lane else ())
    offsets = np.subtract.outer(np.arange(n), np.arange(n))
    dense = np.where(offsets % 2 == 0, dense, 0.0)
    bs = BandedSolve(*tbanded.banded_lu_factor(dense, P, Q), device="cpu", dtype=torch.float64)
    low, upp, _ = bs._row_coefs()
    assert all(d % 2 == 0 for terms in low + upp for d, _ in terms)
    b = torch.as_tensor(np.random.default_rng(15).standard_normal((1, n, lanes)))
    before = b.clone()
    x = bs.apply(b)
    torch.testing.assert_close(b, before, rtol=0, atol=0)
    want = np.linalg.solve(dense, b[0].numpy().T[..., None])[..., 0].T if per_lane else \
        np.linalg.solve(dense, b[0].numpy())
    _close(x[0].numpy(), want)


# -- the kernel's parity-split chain layout -----------------------------------------


def _parity_system(n, seed=0, batch=()):
    """A banded system that couples rows of one parity only (odd offsets
    zero), as the Chebyshev operators of the solvers do."""
    offsets = np.subtract.outer(np.arange(n), np.arange(n))
    return np.where(offsets % 2 == 0, _system(n, seed=seed, batch=batch), 0.0)


@pytest.mark.parametrize("per_lane", [False, True])
def test_parity_detection(per_lane):
    """An even band takes the parity path; one odd-offset term, nonzero in
    one lane at one row (lower d=1, upper d=1 or d=3), refuses it."""
    n, lanes = 21, 5
    batch = (lanes,) if per_lane else ()
    lower, upper = tbanded.banded_lu_factor(_parity_system(n, seed=20, batch=batch), P, Q)
    assert BandedSolve(lower, upper, device="cpu", dtype=torch.float64).path == "parity"
    assert couples_one_parity(lower.reshape(-1, P, n)[0], upper.reshape(-1, Q + 1, n)[0])
    for which, d, row in (("lower", 0, 7), ("upper", 1, 5), ("upper", 3, 2)):
        low, upp = lower.copy(), upper.copy()
        target = low if which == "lower" else upp
        target[(3,) * per_lane + (d, row)] = 1e-3
        bs = BandedSolve(low, upp, device="cpu", dtype=torch.float64)
        assert bs.path == "general" and bs.systems == 1, (which, d)
    assert _wrapper().path == "general"  # the full band of _system


@pytest.mark.parametrize("n", [20, 21])
@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("parity", [True, False])
def test_chain_layout_reconstructs_band(parity, per_lane, n):
    """Scattering the chain layout back to rows gives the factors bit for
    bit, every chain row past a system's end is zero, and the last upper
    term holds the diagonal's reciprocals."""
    lanes = 3
    batch = (lanes,) if per_lane else ()
    dense = (_parity_system if parity else _system)(n, seed=21, batch=batch)
    bs = BandedSolve(*tbanded.banded_lu_factor(dense, P, Q), device="cpu", dtype=torch.float64)
    assert bs.path == ("parity" if parity else "general")
    sys_ = bs.systems
    low, upp = bs.chain_lower.numpy(), bs.chain_upper.numpy()
    # the parity path's bands are halved, the general path's widened to 4
    # with zero terms (its kernel's one instance)
    pp, qq = (P // 2, Q // 2) if parity else (4, 4)
    assert low.shape[:3] == (pp, low.shape[1], sys_) and upp.shape[0] == qq + 2
    np.testing.assert_array_equal(upp[-1], np.divide(1.0, upp[0], out=np.zeros_like(upp[0]),
                                                     where=upp[0] != 0))
    upp = upp[:-1]
    assert low.shape[1] % 8 == 0 and low.shape[1] >= -(-n // sys_)
    lower, upper = np.zeros((P, n, low.shape[-1])), np.zeros((Q + 1, n, low.shape[-1]))
    for s in range(sys_):
        ns = len(range(s, n, sys_))
        for t in range(P // sys_):
            lower[sys_ * (t + 1) - 1, s::sys_] = low[t, :ns, s]
        for t in range(Q // sys_ + 1):
            upper[sys_ * t, s::sys_] = upp[t, :ns, s]
        assert not low[:, ns:, s].any() and not upp[:, ns:, s].any()
    assert not low[P // sys_:].any() and not upp[Q // sys_ + 1:].any()
    np.testing.assert_array_equal(lower, bs.lower.numpy().reshape(lower.shape))
    np.testing.assert_array_equal(upper, bs.upper.numpy().reshape(upper.shape))


@pytest.mark.parametrize("n,lanes", [(33, 130), (16, 8)])
@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("parity", [True, False])
def test_chain_solve_matches_plain_and_scan(parity, per_lane, n, lanes):
    """The solve from the chain layout (each system on its own) equals the
    plain full solve bit for bit along both axes, and the JAX package's
    scan to 1e-12 of max|x|."""
    dense = (_parity_system if parity else _system)(n, seed=22, batch=(lanes,) if per_lane else ())
    solver = _solver(dense)
    assert solver.kernel.path == ("parity" if parity else "general")
    b = np.random.default_rng(23).standard_normal((lanes, n))
    want = jbanded.BandedSolver(dense, P, Q).solve(jnp.asarray(b), 1)
    for bt, axis in ((torch.as_tensor(b), 1), (torch.as_tensor(b.T.copy()), 0)):
        chains = solver._along(solver.kernel.plain_chains, bt, axis)
        assert torch.equal(chains, solver.plain(bt, axis)), axis
        _close(chains.numpy() if axis == 1 else chains.numpy().T, want)


@pytest.mark.parametrize("parity", [True, False])
def test_chain_solve_factor_batch_stride(parity):
    """Per-lane chain factors read with a factor batch stride equal the
    plain solve with it bit for bit."""
    n, ranks, per_rank = 19, 3, 4
    dense = (_parity_system if parity else _system)(n, seed=24, batch=(ranks * per_rank,))
    bs = BandedSolve(*tbanded.banded_lu_factor(dense, P, Q), device="cpu", dtype=torch.float64)
    b = torch.as_tensor(np.random.default_rng(25).standard_normal((ranks, n, per_rank)))
    got = bs.plain_chains(b, per_rank)
    assert torch.equal(got, bs.plain(b, per_rank))
    assert torch.equal(got, bs.plain(b.transpose(0, 1).reshape(1, n, -1)).view(n, ranks, per_rank)
                       .transpose(0, 1))


def test_parity_accounting():
    """The parity path counts the terms and factors of its two systems:
    for p=2, q=4 one lower and two upper terms a row, the odd ones left
    out."""
    n, lanes = 16, 8
    for per_lane, sets in ((False, 1), (True, lanes)):
        dense = _parity_system(n, seed=26, batch=(lanes,) if per_lane else ())
        bs = BandedSolve(*tbanded.banded_lu_factor(dense, P, Q), device="cpu", dtype=torch.float64)
        assert bs.path == "parity"
        per_system = (8 - 1) + (2 * 8 - 3)  # 8 rows: 1 lower term, 2 upper terms
        assert bs.flops((3, n, lanes)) == 3 * lanes * (2 * 2 * per_system + n)
        assert bs.bytes_moved((3, n, lanes)) == 8 * (2 * 3 * n * lanes + 4 * n * sets)


def test_kernel_tile_and_copy_width():
    """The block tile and the copy width the wrapper gives the kernel: 8
    lanes at the rbc1025 shapes (one column of 1026 padded rows and a
    64 KB ring of four upper terms a row), fewer for long columns, none
    past shared memory; 16-byte copies only where every copied run starts
    on 16 bytes."""
    assert shared_bytes(1023, 8, 2, 8, True, 4) == 8 * 1026 * 8 + 8 * (4 * 16 * 2 * 8) * 8
    assert shared_bytes(1023, 8, 2, 8, True, 4, rows_contiguous=False) == 1023 * 8 * 8 + 65536
    assert tile_lanes(1023, 8, 2, True, 4) == 8 and tile_lanes(1024, 8, 2, False, 4) == 8
    assert tile_lanes(5000, 8, 2, True, 4) == 4
    assert tile_lanes(40000, 8, 2, False, 4) is None
    f64 = torch.float64
    assert vector_copies(torch.zeros((2, 64, 32), dtype=f64), 8)
    assert vector_copies(torch.zeros((1, 32, 64), dtype=f64).transpose(1, 2), 8)
    assert not vector_copies(torch.zeros((1, 37, 33), dtype=f64), 8)
    assert not vector_copies(torch.zeros((1, 33, 37), dtype=f64).transpose(1, 2), 8)
    assert not vector_copies(torch.zeros((1, 64, 33), dtype=f64)[:, :, 1:], 8)
    assert not vector_copies(torch.zeros((1, 64, 32), dtype=torch.float32), 2)
    assert vector_copies(torch.zeros((1, 64, 32), dtype=torch.float32), 4)


@pytest.mark.parametrize("route", ["dense", "mesh"])
def test_step_systems_take_parity_path(route):
    """Every banded solve of the dense and the meshed step couples rows of
    one parity only, so each takes the parity path."""
    kw = dict(mesh=pt.make_mesh(4, "cpu")) if route == "mesh" else \
        dict(step_kernel="dense", conv_kernel="dense")
    model = pt.Navier2D.new_confined(33, 33, 1e5, 1.0, 2e-3, 1.0, "rbc", device="cpu", **kw)
    kernels = model.kernels()["banded_solve"]
    assert len(kernels) == 5 and all(k.path == "parity" for k in kernels)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reciprocals_round_in_the_working_dtype(dtype):
    """The kernel's reciprocals are ``1 / u_0`` rounded once in the working
    dtype (not rounded in f64 and again in f32), and zero where the
    diagonal is zero (rows past a system's end)."""
    d = np.random.default_rng(27).uniform(0.5, 8.0, 200)
    d[::17] = 0.0
    got = reciprocals(d, dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    nz = d != 0
    want = np_dtype(1) / d[nz].astype(np_dtype)
    np.testing.assert_array_equal(got[nz].astype(np_dtype), want)
    assert not got[~nz].any()
    bs = _wrapper()
    assert bs.path == "general" and bs.chain_upper.shape[0] == Q + 2
    torch.testing.assert_close(bs.chain_upper[-1, :9, 0, 0], 1.0 / bs.upper[0], rtol=0, atol=0)

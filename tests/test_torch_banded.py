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
from rustpde_mpi_tpu_torch.ops import banded as tbanded
from rustpde_mpi_tpu_torch.ops.banded_solve import BandedSolve

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

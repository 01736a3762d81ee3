"""Host-side (numpy f64) modal data of the implicit solves.

Counterpart of the public modal contract of the JAX package's
``solver.py``: the dense ADI Helmholtz axis factor and the fast-diagonal
eigen-data of the pressure Poisson solve.  The fused stage kernels
(:mod:`rustpde_mpi_tpu_torch.ops.fused_step`) build their matrices from
these; the device never runs a separate solver object.  Chebyshev axes
only (the confined cell).
"""

from __future__ import annotations

import numpy as np

from .bases import BaseKind, Space2


def ingredients_for_hholtz(space: Space2, axis: int):
    """``(mat_a, mat_b, precond)`` of one Chebyshev axis: preconditioned with
    the restricted quasi-inverse, ``mat_a - c*mat_b`` is banded."""
    base = space.bases[axis]
    peye = base.laplace_inv_eye()
    pinv = peye @ base.laplace_inv()
    S = base.mass()
    if base.kind == BaseKind.CHEBYSHEV:
        S = S[:, 2:]
    return pinv @ S, peye @ S, pinv


def hholtz_axis_solve_matrix(space: Space2, axis: int, ci: float) -> np.ndarray:
    """Dense ADI Helmholtz axis factor ``A = (mat_a - ci*mat_b)^-1 @
    precond`` in natural order: the 2-D solve is ``A0 @ rhs @ A1^T``."""
    mat_a, mat_b, precond = ingredients_for_hholtz(space, axis)
    return np.linalg.solve(mat_a - ci * mat_b, precond)


def _checker_shift(m: np.ndarray) -> int | None:
    """Shift s in {0, 1} such that ``m[i, j] == 0`` (exactly) whenever
    ``(i + j + s)`` is odd; None if neither holds."""
    r, c = m.shape
    i = np.arange(r)[:, None]
    j = np.arange(c)[None, :]
    for s in (0, 1):
        if not np.any(m[(i + j + s) % 2 == 1]):
            return s
    return None


def _real_eig_desc(x: np.ndarray):
    """Real eigendecomposition sorted by descending eigenvalue."""
    lam, q = np.linalg.eig(x)
    if np.abs(lam.imag).max(initial=0.0) > 1e-8 * max(np.abs(lam.real).max(), 1.0):
        raise ValueError("tensor-solver eigenvalues are significantly complex")
    lam = lam.real
    q = q.real if np.iscomplexobj(q) else q
    order = np.argsort(lam)[::-1]
    return lam[order], q[:, order]


def _axis_modal_data(space: Space2, axis: int, ci: float, sign: float):
    """Modal diagonalization of one axis of the preconditioned operator:
    ``(lam, fwd, bwd)`` with ``lam`` scaled by ``sign * ci``, ``fwd`` mapping
    the ortho-space rhs into eigenspace (``Q^-1 C^-1 pinv``) and ``bwd = Q``
    mapping back to composite coefficients.  Parity-preserving pencils are
    decomposed per parity block, so the maps carry exact checkerboard
    zeros."""
    mat_c, mat_a, precond = ingredients_for_hholtz(space, axis)
    if (
        _checker_shift(mat_c) == 0
        and _checker_shift(mat_a) == 0
        and _checker_shift(precond) == 0
    ):
        m = mat_c.shape[0]
        n_cols = precond.shape[1]
        lam = np.empty(m)
        q = np.zeros((m, m))
        fwd = np.zeros((m, n_cols))
        for par in (0, 1):
            sl = slice(par, None, 2)
            c_b = mat_c[sl, sl]
            lam_b, q_b = _real_eig_desc(np.linalg.solve(c_b, mat_a[sl, sl]))
            fwd_b = np.linalg.solve(q_b, np.linalg.solve(c_b, precond[sl, sl]))
            lam[sl] = lam_b
            q[sl, sl] = q_b
            fwd[sl, sl] = fwd_b
        return sign * ci * lam, fwd, q
    lam, q = _real_eig_desc(np.linalg.solve(mat_c, mat_a))
    fwd = np.linalg.solve(q, np.linalg.solve(mat_c, precond))
    return sign * ci * lam, fwd, q


def modal_data_split(space: Space2, axis: int, ci: float, sign: float = 1.0):
    """``(lam, fwd, bwd)`` of one axis, eigenvalues in natural order (the
    JAX package's contract of the same name, Chebyshev axes)."""
    return _axis_modal_data(space, axis, ci, sign)

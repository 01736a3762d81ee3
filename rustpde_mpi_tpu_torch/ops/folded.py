"""Dense per-axis operators and the parity-separated ("sep") index order.

The port stores spectral axes in natural order and applies every operator
as one dense matrix.  The JAX package's TPU layout stores Chebyshev axes
parity-permuted (``[evens..., odds...]``); these helpers describe that
permutation so a state taken from the TPU layout can be converted
(:mod:`rustpde_mpi_tpu_torch.convert`), and so ``Base.axis_operator`` keeps
the same contract as the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def parity_perm(m: int) -> np.ndarray:
    """Natural -> sep order: position p holds natural index perm[p]."""
    return np.concatenate([np.arange(0, m, 2), np.arange(1, m, 2)])


def parity_perm_inv(m: int) -> np.ndarray:
    """Sep -> natural: position i holds the sep position of natural index i."""
    return np.argsort(parity_perm(m))


class AxisOperator(NamedTuple):
    """One per-axis operator in its storage layout.

    * ``matrix`` — dense host matrix: sep permutations baked into the
      rows/columns, dealias-dead output rows zeroed.
    * ``parity`` — ``(sep_in, sep_out)``: which sides are stored in the
      parity-separated order.
    * ``dealias_rows`` — number of kept NATURAL-order output rows under the
      2/3-rule cut (None: no cut baked in).
    * ``kept_rows`` — storage-layout indices of the rows that stay nonzero
      under the cut (None: all rows)."""

    matrix: np.ndarray
    parity: tuple
    dealias_rows: int | None
    kept_rows: np.ndarray | None


def dense_operator(
    mat: np.ndarray,
    sep_in: bool = False,
    sep_out: bool = False,
    keep_rows: int | None = None,
) -> np.ndarray:
    """The dense storage-layout matrix: dead dealias rows zeroed in NATURAL
    order, then the parity permutation applied to the sep sides."""
    mat = np.asarray(mat)
    r, c = mat.shape
    if keep_rows is not None and keep_rows < r:
        mat = np.where(np.arange(r)[:, None] < max(0, keep_rows), mat, 0.0)
    if sep_out:
        mat = mat[parity_perm(r), :]
    if sep_in:
        mat = mat[:, parity_perm(c)]
    return mat


def kept_storage_rows(r: int, keep_rows: int, sep_out: bool) -> np.ndarray:
    """Storage-layout row indices that survive a ``keep_rows`` natural-order
    prefix cut: ``arange(keep_rows)`` in natural order; under the sep
    permutation the kept rows form one contiguous run per parity block."""
    if not sep_out:
        return np.arange(max(0, min(keep_rows, r)))
    return np.where(parity_perm(r) < keep_rows)[0]

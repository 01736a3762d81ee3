"""Banded and dense axis solvers of the implicit solves.

Counterpart of the JAX package's ``ops/banded.py`` for Chebyshev axes:

* :func:`banded_lu_factor` — LU (no pivoting) of banded matrices on the
  host in numpy f64, batched over leading dims, with the JAX package's
  arithmetic and factor layout.  The elimination runs on the band only
  (:func:`band_lu_factor`), which stays exact because an unpivoted LU of a
  banded matrix has no fill outside the band; it lets the tensor solver
  factor one matrix per eigenvalue lane without a dense ``(lanes, n, n)``
  batch.
* :class:`BandedSolver` — the forward/backward substitution along one axis
  of a device tensor, through the wrapper of the hand-written CUDA kernel
  (:class:`..ops.banded_solve.BandedSolve`).  On the card the recurrence
  *is* the kernel, so the JAX package's ``method="pallas"`` selects this
  class too.
* :class:`DenseSolver` — the precomputed dense inverse applied with
  ``torch.matmul`` along the axis.
* :class:`DiagSolver` — the diagonal solve of a Fourier axis.

A complex right-hand side (a field of a periodic space) is solved by the
banded kernel in one launch: its real and imaginary parts are two planes
of one strided real view, both read with the same factors (no copy, no
second launch), so a pencil solve whose factor sets are offset by the rank
stays one launch too.  The parity-separated adapter of the JAX package
is a TPU layout device and is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import to_device
from .banded_solve import BandedSolve
from .transforms import apply_along


def dense_to_band(dense: np.ndarray, p: int, q: int) -> np.ndarray:
    """Band storage ``(..., n, p+q+1)`` of ``dense`` ``(..., n, n)``:
    ``band[..., i, p + k] = dense[..., i, i + k]`` for ``-p <= k <= q``,
    zero where the column falls outside the matrix."""
    a = np.asarray(dense, dtype=np.float64)
    n = a.shape[-1]
    band = np.zeros(a.shape[:-2] + (n, p + q + 1))
    for k in range(-p, q + 1):
        rows = np.arange(max(0, -k), min(n, n - k))
        band[..., rows, p + k] = a[..., rows, rows + k]
    return band


def pad_band(band: np.ndarray, p: int, n_pad: int, lanes_pad: int | None = None) -> np.ndarray:
    """Band storage ``(..., n, p+q+1)`` of the system padded with identity
    rows up to ``n_pad`` and, for per-lane bands ``(lanes, n, p+q+1)``,
    with identity systems up to ``lanes_pad`` lanes.  The pad rows couple
    to no real row, so an unpivoted LU of the padded band gives the real
    rows' factors bit for bit, and a solve leaves a zero pad zero: the
    form of a system on pencils padded to a multiple of the rank count."""
    band = np.asarray(band, dtype=np.float64)
    n = band.shape[-2]
    widths = [(0, 0)] * band.ndim
    widths[-2] = (0, n_pad - n)
    if lanes_pad is not None:
        widths[0] = (0, lanes_pad - band.shape[0])
    out = np.pad(band, widths)
    out[..., n:, p] = 1.0
    if lanes_pad is not None:
        out[band.shape[0]:, :, p] = 1.0
    return out


def band_lu_factor(band: np.ndarray, p: int, q: int):
    """LU-factor (no pivoting) matrices given in band storage (see
    :func:`dense_to_band`), batched over leading dims.  The same operations
    in the same order as the JAX package's dense ``banded_lu_factor``.
    Returns ``(lower (..., p, n), upper (..., q+1, n))``: lower holds
    ``L[i, i-d]`` at ``[d-1, i]``, upper holds ``U[i, i+d]`` at ``[d, i]``."""
    ab = np.array(band, dtype=np.float64, copy=True)
    n = ab.shape[-2]
    for i in range(n - 1):
        piv = ab[..., i, p]
        if np.any(np.abs(piv) < 1e-300):
            raise ZeroDivisionError(f"zero pivot at row {i}")
        kmax = min(i + q, n - 1)
        for j in range(i + 1, min(i + p, n - 1) + 1):
            m = ab[..., j, i - j + p] / piv
            ab[..., j, i - j + p] = m
            ab[..., j, i + 1 - j + p : kmax - j + p + 1] -= m[..., None] * ab[..., i, p + 1 : kmax - i + p + 1]
    batch = ab.shape[:-2]
    lower = np.zeros(batch + (p, n))
    upper = np.zeros(batch + (q + 1, n))
    for d in range(1, p + 1):
        lower[..., d - 1, d:] = ab[..., d:, p - d]
    for d in range(0, q + 1):
        upper[..., d, : n - d] = ab[..., : n - d, p + d]
    return lower, upper


def banded_lu_factor(dense: np.ndarray, p: int, q: int):
    """LU-factor a banded ``(..., n, n)`` matrix with lower bandwidth ``p``
    and upper bandwidth ``q`` (the JAX package's contract of the same
    name)."""
    return band_lu_factor(dense_to_band(dense, p, q), p, q)


class BandedSolver:
    """Solves ``A x = b`` along one axis of a device tensor, real or
    complex, with the LU factors of ``A``: one set, ``(p, n)``/``(q+1,
    n)``, or one per lane, ``(lanes, p, n)``/``(lanes, q+1, n)``.  Per-lane
    factors align with the lanes the solve runs over: the axes after the
    solve axis, or, when it is the last axis, the axis before it."""

    def __init__(self, lower, upper, *, device, dtype):
        self.kernel = BandedSolve(lower, upper, device=device, dtype=dtype)
        self.p, self.q, self.n = self.kernel.p, self.kernel.q, self.kernel.n

    @classmethod
    def from_dense(cls, dense, p: int, q: int, *, device, dtype) -> "BandedSolver":
        return cls(*banded_lu_factor(dense, p, q), device=device, dtype=dtype)

    def solve(self, b: torch.Tensor, axis: int, factor_batch_stride: int = 0,
              factor_batch_period: int = 0) -> torch.Tensor:
        """The solve along ``axis``, as one kernel launch on a strided
        ``(batch, n, lanes)`` view of ``b`` (every dim before ``axis``, a
        member dim included, goes into the batch).  ``factor_batch_stride``
        and ``factor_batch_period``: see
        :meth:`..ops.banded_solve.BandedSolve.apply`.  The solve runs
        through :class:`BandedSolveFn`, whose backward is the same kernel on
        ``A^T``'s factors (built only when autograd asks for it)."""
        return self._along(lambda v: BandedSolveFn.apply(
            v, self.kernel, factor_batch_stride, factor_batch_period), b, axis)

    def plain(self, b: torch.Tensor, axis: int, factor_batch_stride: int = 0,
              factor_batch_period: int = 0) -> torch.Tensor:
        """The same solve through the kernel's plain PyTorch version, on
        any device (the kernel's yardstick on the card)."""
        return self._along(
            lambda v: self.kernel.plain(v, factor_batch_stride, factor_batch_period), b, axis)

    @classmethod
    def _along(cls, fn, b: torch.Tensor, axis: int) -> torch.Tensor:
        """``fn`` on the ``(batch, n, lanes)`` view of ``b`` whose axis 1 is
        ``b``'s ``axis``: lanes are the dims after it or, when it is the
        last, the one before (which per-lane factors align with).  A
        complex ``b`` goes in as the real view of that view, ``(2, batch,
        n, lanes)``, its real and imaginary parts two planes of one launch
        that read the same factor sets (no copy)."""
        shape = b.shape
        axis %= b.ndim
        pre, post = math.prod(shape[:axis]), math.prod(shape[axis + 1 :])
        n = shape[axis]
        if post > 1 or axis == 0:
            view = b.reshape(pre, n, post)

            def undo(out):
                return out.reshape(shape)
        else:
            lanes = shape[axis - 1]
            view = b.reshape(pre // lanes, lanes, n).transpose(1, 2)

            def undo(out):
                return out.transpose(1, 2).reshape(shape)
        if not b.is_complex():
            return undo(fn(view))
        out = fn(torch.view_as_real(view).movedim(-1, 0)).movedim(0, -1)
        return undo(torch.view_as_complex(out if out.stride(-1) == 1 else out.contiguous()))


class BandedSolveFn(torch.autograd.Function):
    """The banded solve ``x = A^-1 b`` along the rows of a ``([planes,]
    batch, n, lanes)`` view, as autograd sees it: the forward is
    :meth:`..ops.banded_solve.BandedSolve.apply` (the kernel on the card,
    the plain recurrence on the CPU), the backward ``A^-T g`` through the
    same call on the transposed factors (:meth:`..ops.banded_solve.
    BandedSolve.transposed`), with the same factor sets per lane, batch
    stride, period and planes.  ``A`` is real, so a complex cotangent's
    parts, the planes of its real view, take the same transposed solve."""

    @staticmethod
    def forward(ctx, b, kernel, factor_batch_stride, factor_batch_period):
        ctx.solve = (kernel, factor_batch_stride, factor_batch_period)
        return kernel.apply(b, factor_batch_stride, factor_batch_period)

    @staticmethod
    def backward(ctx, g):
        kernel, stride, period = ctx.solve
        return kernel.transposed().apply(g.contiguous(), stride, period), None, None, None


class DenseSolver:
    """The precomputed dense inverse, applied along the axis by one
    ``torch.matmul``."""

    def __init__(self, dense, *, device, dtype):
        self.inv = to_device(np.linalg.inv(np.asarray(dense, dtype=np.float64)), device, dtype)

    def solve(self, b: torch.Tensor, axis: int) -> torch.Tensor:
        return apply_along(self.inv, b, axis)


class DiagSolver:
    """The diagonal solve of a Fourier axis (the reference's Sdma): ``b``
    divided by the diagonal along the axis."""

    def __init__(self, diag, *, device, dtype):
        self.diag = to_device(diag, device, dtype)

    def solve(self, b: torch.Tensor, axis: int) -> torch.Tensor:
        shape = [1] * b.ndim
        shape[axis] = self.diag.shape[0]
        return b / self.diag.reshape(shape)

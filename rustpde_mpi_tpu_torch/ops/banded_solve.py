"""Banded LU substitution, on a CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_banded.py`` (and of the
``lax.scan`` recurrence of its ``ops/banded.py``).  A :class:`BandedSolve`
holds the LU factors of one banded matrix (lower bandwidth ``p``, upper
``q``), or of one matrix per lane, on a device, and solves along axis 1 of a
``(batch, n, lanes)`` view of the right-hand side:

    forward:   y_i = b_i - sum_{d=1..p} L[d-1, i] * y_{i-d}
    backward:  x_i = (y_i - sum_{d=1..q} U[d, i] * x_{i+d}) / U[0, i]

On a CUDA tensor :meth:`BandedSolve.apply` launches the hand-written kernel
of ``csrc/banded_solve.cu`` once (the view's strides go to the kernel, so no
transpose is copied) and adds one to ``BandedSolve.launches``; on a CPU
tensor it runs :meth:`BandedSolve.plain`, the same recurrence vectorised
over lanes.  Any other device raises.

Per-lane factors may be read with a factor batch stride ``k``: lane ``l`` of
batch ``j`` then solves with factor set ``j * k + l``.  The
pencil-decomposed Poisson solve uses it to solve the y-pencils of all ranks
of a mesh, each holding its own slice of the eigenvalue lanes, in one
launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import check_dtype, to_device
from . import _build

#: the largest bandwidths the kernel takes (csrc/banded_solve.cu MAXB)
MAX_BAND = 4


class BandedSolve:
    """The substitution with the factors ``lower`` ``(p, n)`` / ``upper``
    ``(q+1, n)`` of :func:`..ops.banded.banded_lu_factor`, or one set per
    lane, ``(lanes, p, n)`` / ``(lanes, q+1, n)``.  Per-lane factors are
    stored ``(p, n, lanes)`` so that a warp's lanes read neighbouring
    addresses; the values are cast from host f64 to ``dtype``.

    ``pad_zeros``: the right-hand sides may hold lanes of exact zeros (the
    pad lanes of a mesh's padded pencils).  The kernel then never divides a
    zero, whose IEEE division takes a slow path on every row of such a
    lane; without them it keeps the plain division, which is faster."""

    def __init__(self, lower, upper, *, device, dtype, pad_zeros: bool = False):
        lower, upper = np.asarray(lower, dtype=np.float64), np.asarray(upper, dtype=np.float64)
        if lower.ndim != upper.ndim or lower.ndim not in (2, 3):
            raise ValueError("factors are (p, n)/(q+1, n) or (lanes, p, n)/(lanes, q+1, n)")
        if lower.shape[-1] != upper.shape[-1] or lower.shape[:-2] != upper.shape[:-2]:
            raise ValueError("lower and upper factors disagree in n or lanes")
        self.p, self.q = lower.shape[-2], upper.shape[-2] - 1
        self.n = lower.shape[-1]
        self.per_lane = lower.ndim == 3
        #: number of factor sets (None: one set for every lane)
        self.lanes = lower.shape[0] if self.per_lane else None
        if self.per_lane:
            lower, upper = np.moveaxis(lower, 0, -1), np.moveaxis(upper, 0, -1)
        self.device = torch.device(device)
        self.dtype = check_dtype(dtype)
        self.lower = to_device(lower, self.device, dtype)
        self.upper = to_device(upper, self.device, dtype)
        self._coefs = None
        self.pad_zeros = bool(pad_zeros)
        #: kernel launches on CUDA tensors
        self.launches = 0

    # -- accounting -------------------------------------------------------

    def flops(self, shape) -> float:
        """Flops of one solve of a ``(batch, n, lanes)`` rhs: a multiply and
        a subtraction per band term that exists in that row, one division
        per row."""
        nb, n, lanes = shape
        p, q = min(self.p, n - 1), min(self.q, n - 1)
        terms = p * n - p * (p + 1) // 2 + q * n - q * (q + 1) // 2
        return float(nb * lanes) * (2.0 * terms + n)

    def bytes_moved(self, shape) -> float:
        """Bytes one solve must move at least: the rhs read once, the
        solution written once, every factor read once."""
        nb, n, lanes = shape
        return float(2 * nb * n * lanes + self.lower.numel() + self.upper.numel()) * \
            torch.finfo(self.dtype).bits / 8

    # -- the solve --------------------------------------------------------

    def _check(self, b, factor_batch_stride: int) -> None:
        if b.device != self.device or b.dtype != self.dtype:
            raise ValueError(f"banded solve input: {b.dtype} on {b.device}, "
                             f"expected {self.dtype} on {self.device}")
        if b.ndim != 3 or b.shape[1] != self.n:
            raise ValueError(f"banded solve input: shape {tuple(b.shape)}, expected "
                             f"(batch, {self.n}, lanes)")
        if factor_batch_stride and not self.per_lane:
            raise ValueError("a factor batch stride needs per-lane factors")
        if factor_batch_stride < 0:
            raise ValueError(f"negative factor batch stride {factor_batch_stride}")
        if self.per_lane:
            nb, lanes = b.shape[0], b.shape[2]
            if factor_batch_stride:
                fits = (nb - 1) * factor_batch_stride + lanes <= self.lanes
            else:
                fits = lanes == self.lanes
            if not fits:
                raise ValueError(f"banded solve input: {nb} x {lanes} lanes at factor "
                                 f"batch stride {factor_batch_stride}, the factors "
                                 f"hold {self.lanes}")

    def apply(self, b, factor_batch_stride: int = 0) -> torch.Tensor:
        """Solve along axis 1 of ``b`` ``(batch, n, lanes)``: the CUDA
        kernel on a CUDA device (the result has ``b``'s strides), the plain
        recurrence on the CPU.  ``factor_batch_stride`` (per-lane factors
        only): lane ``l`` of batch ``j`` takes factor set ``j * stride +
        l``; 0 gives every batch the same ``lanes`` sets."""
        self._check(b, factor_batch_stride)
        if self.device.type == "cpu":
            return self.plain(b, factor_batch_stride)
        if self.device.type != "cuda":
            raise RuntimeError(f"no banded-solve kernel for device {self.device}")
        out = self._launch(b, factor_batch_stride)
        self.launches += 1
        return out

    def plain(self, b, factor_batch_stride: int = 0) -> torch.Tensor:
        """The recurrence in plain PyTorch, row by row and in place on one
        ``(n, batch, lanes)`` copy of ``b``, vectorised over batch and lanes
        (the CPU path and the kernel's yardstick)."""
        if factor_batch_stride:
            nb, _, lanes = b.shape
            idx = (torch.arange(nb, device=self.device)[:, None] * factor_batch_stride
                   + torch.arange(lanes, device=self.device)[None, :])
            low, upp, diag = self._row_coefs(self.lower[..., idx], self.upper[..., idx])
        else:
            if self._coefs is None:
                self._coefs = self._row_coefs()
            low, upp, diag = self._coefs
        x = b.movedim(1, 0).clone(memory_format=torch.contiguous_format)
        rows = x.unbind(0)
        for i, terms in enumerate(low):
            for d, c in terms:
                rows[i].addcmul_(c, rows[i - d], value=-1)
        for i in range(self.n - 1, -1, -1):
            for d, c in upp[i]:
                rows[i].addcmul_(c, rows[i + d], value=-1)
            rows[i].div_(diag[i])
        return x.movedim(0, 1)

    def _row_coefs(self, lower=None, upper=None):
        """Per row of the factors ``lower`` ``(p, n, ...)`` and ``upper``
        ``(q+1, n, ...)`` (default: this solve's own), the ``(d,
        coefficient)`` band terms inside the
        matrix and the diagonal: 0-d tensors for one factor set, the
        factors' trailing lane dims for per-lane ones.  A term whose
        coefficient is zero in every lane is left out: the Chebyshev
        systems couple rows of one parity only, so half the off-diagonals
        are zero, and leaving them out changes no finite result."""
        n, p, q = self.n, self.p, self.q
        lower = self.lower if lower is None else lower
        upper = self.upper if upper is None else upper
        nz_low = (lower != 0).reshape(p, n, -1).any(-1).tolist()
        nz_upp = (upper != 0).reshape(q + 1, n, -1).any(-1).tolist()
        low = [[(d, lower[d - 1, i]) for d in range(1, min(i, p) + 1) if nz_low[d - 1][i]]
               for i in range(n)]
        upp = [[(d, upper[d, i]) for d in range(1, min(n - 1 - i, q) + 1) if nz_upp[d][i]]
               for i in range(n)]
        return low, upp, upper[0].unbind(0)

    def _launch(self, b, factor_batch_stride: int) -> torch.Tensor:
        if max(self.p, self.q) > MAX_BAND:
            raise ValueError(f"the banded kernel takes p, q <= {MAX_BAND}, got {self.p}, {self.q}")
        lib = _build.load("banded_solve")
        fn = lib.rp_banded_solve_f64 if self.dtype == torch.float64 else lib.rp_banded_solve_f32
        x = torch.empty_like(b)  # keeps b's strides when b is dense
        nb, n, lanes = b.shape
        # per-lane factors are stored (p, n, self.lanes): lane l of batch j
        # reads set j * factor_batch_stride + l
        _build.call(fn, self.device, nb, n, lanes, self.p, self.q, self.lower.data_ptr(),
                    self.upper.data_ptr(), int(self.per_lane), self.lanes or 1,
                    factor_batch_stride, int(self.pad_zeros), b.data_ptr(),
                    *b.stride(), x.data_ptr(), *x.stride())
        return x


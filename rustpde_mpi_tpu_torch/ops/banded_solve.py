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

The kernel runs each lane as independent chains of rows.  When every
odd-offset factor term is zero in every lane (the Chebyshev systems of the
solvers couple rows of one parity only), the even and the odd rows are two
systems of half the length and half the bandwidths, and a lane is two
chains (``BandedSolve.path == "parity"``); otherwise one chain of all rows
(``"general"``).  The path is fixed when the solve is built, and the
factors are stored for the kernel in that path's chain layout
(:func:`chain_factors`), followed by the diagonal's :func:`reciprocals`,
from which the kernel forms the correctly rounded quotients without a
division.  A block of the kernel keeps a tile of lanes' whole columns in
shared memory (:func:`tile_lanes` picks the tile), so a column of more
rows than fit there (about 28,000 in f64) raises.

Per-lane factors may be read with a factor batch stride ``k``: lane ``l`` of
batch ``j`` then solves with factor set ``j * k + l``.  The
pencil-decomposed Poisson solve uses it to solve the y-pencils of all ranks
of a mesh, each holding its own slice of the eigenvalue lanes, in one
launch.  A factor batch period ``P`` makes batch ``j`` read the sets of
batch ``j mod P``: an ensemble of K members (the JAX package's ``jax.vmap``
of the solve) stacks its members' pencils, K x P ranks, into the batch, and
each member's rank ``r`` reads rank ``r``'s sets, so K members are one
launch too.  A second batch level, ``(planes, batch, n, lanes)``, gives every
plane the same factor sets: a complex right-hand side's real and imaginary
parts, so that the periodic cell's per-mode solve on complex y-pencils is
one launch too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import check_dtype, to_device
from . import _build

#: the largest bandwidths the kernel takes (csrc/banded_solve.cu MAXB)
MAX_BAND = 4
#: chain rows of each system a ring stage carries, by number of systems
#: (csrc/banded_solve.cu ``Path<NSYS>::RK``)
STAGE_ROWS = {1: 8, 2: 16}
#: stages in the kernel's ring (csrc/banded_solve.cu RING)
RING = 8
#: shared memory a block may use on the H100 (csrc/banded_solve.cu SMEM_LIMIT)
SMEM_LIMIT = 232448
#: the lanes of a block's tile, widest first
TILE_LANES = (8, 4, 2, 1)


def transpose_factors(lower, upper):
    """The LU factors of ``A^T`` from those of ``A = L U`` (``lower`` ``(...,
    p, n)``, ``upper`` ``(..., q+1, n)``, the layout of
    :func:`..ops.banded.band_lu_factor`), in host f64: with ``D =
    diag(U)``, ``A^T = (U^T D^-1) (D L^T)``, a unit lower factor of
    bandwidth ``q`` and an upper one of bandwidth ``p`` whose diagonal is
    ``D``.  Returns ``(lower (..., q, n), upper (..., p+1, n))``."""
    lower, upper = np.asarray(lower, dtype=np.float64), np.asarray(upper, dtype=np.float64)
    p, n, q = lower.shape[-2], lower.shape[-1], upper.shape[-2] - 1
    diag = upper[..., 0, :]
    lower_t = np.zeros(upper.shape[:-2] + (q, n))
    upper_t = np.zeros(lower.shape[:-2] + (p + 1, n))
    upper_t[..., 0, :] = diag
    for d in range(1, q + 1):  # (U^T D^-1)[i, i-d] = U[i-d, i] / D[i-d]
        lower_t[..., d - 1, d:] = upper[..., d, : n - d] / diag[..., : n - d]
    for d in range(1, p + 1):  # (D L^T)[i, i+d] = D[i] L[i+d, i]
        upper_t[..., d, : n - d] = diag[..., : n - d] * lower[..., d - 1, d:]
    return lower_t, upper_t


def couples_one_parity(lower, upper) -> bool:
    """Whether every odd-offset term of the factors ``lower`` ``(p, n,
    ...)`` / ``upper`` ``(q+1, n, ...)`` is zero in every lane: then row
    ``i`` couples only to rows of its own parity."""
    return not (np.any(lower[0::2]) or np.any(upper[1::2]))


def chain_factors(lower, upper, systems: int):
    """The factors ``lower`` ``(p, n, sets)`` / ``upper`` ``(q+1, n, sets)``
    in the kernel's chain layout, ``(pp, nk, systems, sets)`` and ``(qq+1,
    nk, systems, sets)``: chain row ``k`` of system ``s`` is row ``s +
    systems * k``, chain term ``t`` is offset ``systems * t`` (the lower
    terms from offset ``systems``), so ``pp = p // systems`` and ``qq = q //
    systems``, each at least 1 (the kernel's chains always take the
    neighbour's term) and :data:`MAX_BAND` for one system (the general
    path's kernel has one instance, for the widest band); ``nk`` is the
    longest chain rounded up to whole ring stages.  A term that reaches
    outside its system or past the band, and every row past a system's
    end, is zero."""
    p, n, sets = lower.shape
    q = upper.shape[0] - 1
    rk = STAGE_ROWS[systems]
    ns0 = -(-n // systems)
    nk = -(-ns0 // rk) * rk
    pp, qq = (MAX_BAND, MAX_BAND) if systems == 1 else (max(p // 2, 1), max(q // 2, 1))
    low = np.zeros((max(pp, p // systems), nk, systems, sets))
    upp = np.zeros((max(qq, q // systems) + 1, nk, systems, sets))
    for s in range(systems):
        ns = len(range(s, n, systems))
        k = np.arange(ns)[:, None]
        for t in range(p // systems):
            low[t, :ns, s] = np.where(k >= t + 1, lower[systems * (t + 1) - 1, s::systems], 0.0)
        for t in range(q // systems + 1):
            upp[t, :ns, s] = np.where(k + t < ns, upper[systems * t, s::systems], 0.0)
    return low, upp


def reciprocals(diag, dtype) -> np.ndarray:
    """``1 / diag`` rounded in ``dtype`` (zero where ``diag`` is zero): the
    kernel's correctly rounded quotients start from it."""
    d = np.asarray(diag).astype(np.float64 if dtype == torch.float64 else np.float32)
    return np.divide(d.dtype.type(1), d, out=np.zeros_like(d), where=d != 0).astype(np.float64)


def shared_bytes(n: int, itemsize: int, systems: int, lanes: int, per_lane: bool,
                 terms: int, rows_contiguous: bool = True) -> int:
    """Shared memory of one block of the kernel: the tile's ``lanes`` whole
    columns of ``n`` rows (stored lane by lane, each padded to 16 bytes past
    a multiple of 128, when the rows are contiguous; else row by row) and a
    ring of ``RING`` slots of ``terms`` factor terms (csrc/banded_solve.cu
    ``launch``)."""
    if rows_contiguous:
        ld = (-(-n * itemsize // 128) * 128 + 16) // itemsize
        tile = lanes * ld
    else:
        tile = n * lanes
    per16 = 16 // itemsize
    tile = -(-tile // per16) * per16
    slot = terms * STAGE_ROWS[systems] * systems * (lanes if per_lane else 1)
    return (tile + RING * slot) * itemsize


def tile_lanes(n: int, itemsize: int, systems: int, per_lane: bool, terms: int) -> int | None:
    """The widest tile of :data:`TILE_LANES` whose block fits in
    :data:`SMEM_LIMIT` in either storage order; None when not even one
    lane's column fits."""
    for lanes in TILE_LANES:
        if shared_bytes(n, itemsize, systems, lanes, per_lane, terms) <= SMEM_LIMIT:
            return lanes
    return None


def vector_copies(b: torch.Tensor, lanes: int) -> bool:
    """Whether the kernel may copy the ``(batch, n, lanes)`` or ``(planes,
    batch, n, lanes)`` view ``b`` 16 bytes at a time with a tile of
    ``lanes`` lanes: every run it copies (a lane's rows when the row stride
    is 1, else a tile row of lanes with lane stride 1) starts on 16 bytes,
    by the base pointer and the strides."""
    es = b.element_size()
    if b.ndim == 4:
        if b.shape[0] > 1 and b.stride(0) * es % 16:
            return False
        b = b[0]
    sb, sr, sl = b.stride()
    if b.data_ptr() % 16 or (b.shape[0] > 1 and sb * es % 16):
        return False
    if sr == 1 and sl != 1:
        return sl * es % 16 == 0
    return sl == 1 and sr * es % 16 == 0 and lanes * es % 16 == 0


class BandedSolve:
    """The substitution with the factors ``lower`` ``(p, n)`` / ``upper``
    ``(q+1, n)`` of :func:`..ops.banded.banded_lu_factor`, or one set per
    lane, ``(lanes, p, n)`` / ``(lanes, q+1, n)``.  ``lower``/``upper`` keep
    them ``(p, n)``, or ``(p, n, lanes)`` per lane, cast from host f64 to
    ``dtype`` (the plain version's); ``chain_lower``/``chain_upper`` hold
    the kernel's chain layout of :attr:`path`, the upper terms followed by
    the :func:`reciprocals` of the diagonal."""

    def __init__(self, lower, upper, *, device, dtype):
        lower, upper = np.asarray(lower, dtype=np.float64), np.asarray(upper, dtype=np.float64)
        if lower.ndim != upper.ndim or lower.ndim not in (2, 3):
            raise ValueError("factors are (p, n)/(q+1, n) or (lanes, p, n)/(lanes, q+1, n)")
        if lower.shape[-1] != upper.shape[-1] or lower.shape[:-2] != upper.shape[:-2]:
            raise ValueError("lower and upper factors disagree in n or lanes")
        self.device = torch.device(device)
        self.dtype = check_dtype(dtype)
        self.p, self.q = lower.shape[-2], upper.shape[-2] - 1
        self.n = lower.shape[-1]
        self.per_lane = lower.ndim == 3
        #: number of factor sets (None: one set for every lane)
        self.lanes = lower.shape[0] if self.per_lane else None
        # the host f64 factors, from which :meth:`transposed` builds A^T's
        self._host_factors = (lower, upper)
        self._transposed = None
        if self.per_lane:
            lower, upper = np.moveaxis(lower, 0, -1), np.moveaxis(upper, 0, -1)
        self.lower = to_device(lower, self.device, dtype)
        self.upper = to_device(upper, self.device, dtype)
        #: "parity": two chains a lane (even and odd rows); "general": one
        self.path = "parity" if couples_one_parity(lower, upper) else "general"
        self.systems = 2 if self.path == "parity" else 1
        nsets = self.lanes or 1
        low, upp = chain_factors(lower.reshape(self.p, self.n, nsets),
                                 upper.reshape(self.q + 1, self.n, nsets), self.systems)
        upp = np.concatenate([upp, reciprocals(upp[0], self.dtype)[None]])
        self.chain_lower = to_device(low, self.device, dtype)
        self.chain_upper = to_device(upp, self.device, dtype)
        #: the kernel's lanes a block (None: a column does not fit)
        self.tile_lanes = tile_lanes(self.n, self.dtype.itemsize, self.systems, self.per_lane,
                                     max(low.shape[0], upp.shape[0]))
        self._coefs = None
        #: kernel launches on CUDA tensors
        self.launches = 0

    def transposed(self) -> "BandedSolve":
        """The solve with the factors of ``A^T`` (:func:`transpose_factors`),
        bandwidths ``(q, p)``, in the same per-lane layout, built on the host
        at the first call and kept: the backward of the solve
        (:class:`..ops.banded.BandedSolveFn`) runs it through the same kernel,
        with the same factor batch stride, period and planes."""
        if self._transposed is None:
            self._transposed = BandedSolve(*transpose_factors(*self._host_factors),
                                           device=self.device, dtype=self.dtype)
        return self._transposed

    # -- accounting -------------------------------------------------------

    def flops(self, shape) -> float:
        """Flops of one solve of a ``(batch, n, lanes)`` rhs (planes counted
        into the batch): a multiply and
        a subtraction per band term of the path that exists in that row,
        one division per row."""
        nb, n, lanes = shape
        terms = 0
        for s in range(self.systems):
            ns = len(range(s, n, self.systems))
            for b in (self.p // self.systems, self.q // self.systems):
                b = min(b, ns - 1)
                terms += b * ns - b * (b + 1) // 2
        return float(nb * lanes) * (2.0 * terms + n)

    def bytes_moved(self, shape) -> float:
        """Bytes one solve must move at least: the rhs read once, the
        solution written once, every factor of the path's terms read
        once."""
        nb, n, lanes = shape
        pp, qq = self.p // self.systems, self.q // self.systems
        factors = (pp + qq + 1) * n * (self.lanes if self.per_lane else 1)
        return float(2 * nb * n * lanes + factors) * self.dtype.itemsize

    # -- the solve --------------------------------------------------------

    def _check(self, b, factor_batch_stride: int, period: int) -> None:
        if b.device != self.device or b.dtype != self.dtype:
            raise ValueError(f"banded solve input: {b.dtype} on {b.device}, "
                             f"expected {self.dtype} on {self.device}")
        if b.ndim not in (3, 4) or b.shape[-2] != self.n:
            raise ValueError(f"banded solve input: shape {tuple(b.shape)}, expected "
                             f"([planes,] batch, {self.n}, lanes)")
        if factor_batch_stride and not self.per_lane:
            raise ValueError("a factor batch stride needs per-lane factors")
        if factor_batch_stride < 0:
            raise ValueError(f"negative factor batch stride {factor_batch_stride}")
        if period < 0 or (period and not factor_batch_stride):
            raise ValueError(f"a factor batch period of {period} needs a factor batch stride")
        if self.per_lane:
            nb, lanes = b.shape[-3], b.shape[-1]
            if period and nb % period:
                raise ValueError(f"banded solve input: {nb} batch entries are no whole number "
                                 f"of factor batch periods of {period}")
            if factor_batch_stride:
                sets = min(nb, period) if period else nb
                fits = (sets - 1) * factor_batch_stride + lanes <= self.lanes
            else:
                fits = lanes == self.lanes
            if not fits:
                raise ValueError(f"banded solve input: {nb} x {lanes} lanes at factor "
                                 f"batch stride {factor_batch_stride}, the factors "
                                 f"hold {self.lanes}")

    def apply(self, b, factor_batch_stride: int = 0, factor_batch_period: int = 0) -> torch.Tensor:
        """Solve along the rows of ``b`` ``(batch, n, lanes)`` or ``(planes,
        batch, n, lanes)``: the CUDA kernel on a CUDA device (the result has
        ``b``'s strides), the plain recurrence on the CPU.
        ``factor_batch_stride`` (per-lane factors only): lane ``l`` of batch
        ``j`` takes factor set ``(j mod factor_batch_period) * stride + l``
        (no period: ``j * stride + l``); 0 gives every batch the same
        ``lanes`` sets.  Every plane takes the same sets as the others."""
        self._check(b, factor_batch_stride, factor_batch_period)
        if self.device.type == "cpu":
            return self.plain(b, factor_batch_stride, factor_batch_period)
        if self.device.type != "cuda":
            raise RuntimeError(f"no banded-solve kernel for device {self.device}")
        out = self._launch(b, factor_batch_stride, factor_batch_period)
        self.launches += 1
        return out

    def plain(self, b, factor_batch_stride: int = 0, factor_batch_period: int = 0) -> torch.Tensor:
        """The recurrence in plain PyTorch, row by row and in place on one
        ``(n, [planes,] batch, lanes)`` copy of ``b``, vectorised over
        planes, batch and lanes (the CPU path and the kernel's
        yardstick)."""
        idx = self._sets(b, factor_batch_stride, factor_batch_period)
        if idx is not None:
            coefs = self._row_coefs(self.lower[..., idx], self.upper[..., idx])
        else:
            if self._coefs is None:
                self._coefs = self._row_coefs()
            coefs = self._coefs
        x = b.movedim(-2, 0).clone(memory_format=torch.contiguous_format)
        _substitute(x.unbind(0), *coefs)
        return x.movedim(0, -2)

    def plain_chains(self, b, factor_batch_stride: int = 0,
                     factor_batch_period: int = 0) -> torch.Tensor:
        """The same recurrence from the kernel's chain layout: each of the
        path's systems (rows ``s, s + systems, ...``) solved on its own with
        its chain factors, the terms that are zero in every lane left out as
        in :meth:`plain` (whose result it equals bit for bit)."""
        idx = self._sets(b, factor_batch_stride, factor_batch_period)
        low, upp = self.chain_lower, self.chain_upper[:-1]
        if idx is not None:
            low, upp = low[..., idx], upp[..., idx]
        elif not self.per_lane:
            low, upp = low[..., 0], upp[..., 0]
        x = b.movedim(-2, 0).clone(memory_format=torch.contiguous_format)
        for s in range(self.systems):
            rows = x[s :: self.systems].unbind(0)
            _substitute(rows, *_coef_lists(low[:, : len(rows), s], upp[:, : len(rows), s]))
        return x.movedim(0, -2)

    def _sets(self, b, factor_batch_stride: int, period: int = 0):
        """``(batch, lanes)`` factor-set index of each lane of ``b`` under a
        factor batch stride (and period), or None without one."""
        if not factor_batch_stride:
            return None
        nb, _, lanes = b.shape[-3:]
        batch = torch.arange(nb, device=self.device)
        if period:
            batch = batch % period
        return batch[:, None] * factor_batch_stride + torch.arange(lanes, device=self.device)[None, :]

    def _row_coefs(self, lower=None, upper=None):
        """Per row of the factors ``lower`` ``(p, n, ...)`` and ``upper``
        ``(q+1, n, ...)`` (default: this solve's own), the ``(d,
        coefficient)`` band terms inside the matrix and the diagonal: 0-d
        tensors for one factor set, the factors' trailing lane dims for
        per-lane ones.  A term whose coefficient is zero in every lane is
        left out: the Chebyshev systems couple rows of one parity only, so
        half the off-diagonals are zero, and leaving them out changes no
        finite result."""
        lower = self.lower if lower is None else lower
        upper = self.upper if upper is None else upper
        return _coef_lists(lower, upper)

    def _launch(self, b, factor_batch_stride: int, period: int = 0) -> torch.Tensor:
        if max(self.p, self.q) > MAX_BAND:
            raise ValueError(f"the banded kernel takes p, q <= {MAX_BAND}, got {self.p}, {self.q}")
        if self.tile_lanes is None:
            raise ValueError(f"the banded kernel holds a column of {self.n} rows of "
                             f"{self.dtype} in shared memory, which does not fit")
        lib = _build.load("banded_solve")
        fn = lib.rp_banded_solve_f64 if self.dtype == torch.float64 else lib.rp_banded_solve_f32
        x = torch.empty_like(b)  # keeps b's strides when b is dense
        b4, x4 = (b, x) if b.ndim == 4 else (b[None], x[None])
        planes, nb, n, lanes = b4.shape
        low, upp = self.chain_lower, self.chain_upper
        # per-lane chain factors are (terms, nk, systems, self.lanes): lane l
        # of batch j reads set j * factor_batch_stride + l, in every plane
        _build.call(fn, self.device, nb, n, lanes, self.systems, low.shape[0], upp.shape[0] - 2,
                    self.tile_lanes, int(vector_copies(b, self.tile_lanes)),
                    low.data_ptr(), upp.data_ptr(), int(self.per_lane), self.lanes or 1,
                    factor_batch_stride, low.shape[1], b.data_ptr(), *b4.stride()[1:],
                    x.data_ptr(), *x4.stride()[1:], planes, b4.stride(0), x4.stride(0),
                    period or nb)
        return x


def _coef_lists(lower, upper):
    """Per row of ``lower`` ``(p, n, ...)`` / ``upper`` ``(q+1, n, ...)``
    the ``(d, coefficient)`` terms that stay inside the rows and are
    nonzero in some lane, lower and upper, and the diagonal."""
    p, n, q = lower.shape[0], lower.shape[1], upper.shape[0] - 1
    nz_low, nz_upp = ((f != 0).flatten(2).any(-1).tolist() if f.ndim > 2 else (f != 0).tolist()
                      for f in (lower, upper))
    low = [[(d, lower[d - 1, i]) for d in range(1, min(i, p) + 1) if nz_low[d - 1][i]]
           for i in range(n)]
    upp = [[(d, upper[d, i]) for d in range(1, min(n - 1 - i, q) + 1) if nz_upp[d][i]]
           for i in range(n)]
    return low, upp, upper[0].unbind(0)


def _substitute(rows, low, upp, diag) -> None:
    """Forward and backward substitution in place on the row tensors
    ``rows`` with the term lists of :func:`_coef_lists`."""
    for i, terms in enumerate(low):
        for d, c in terms:
            rows[i].addcmul_(c, rows[i - d], value=-1)
    for i in range(len(rows) - 1, -1, -1):
        for d, c in upp[i]:
            rows[i].addcmul_(c, rows[i + d], value=-1)
        rows[i].div_(diag[i])

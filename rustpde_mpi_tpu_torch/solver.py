"""Composite Helmholtz / Poisson solvers over Galerkin spectral spaces.

Counterpart of the JAX package's ``solver.py``, on Chebyshev axes and
on the Fourier x axis of the horizontally periodic cell:

* host modal data: the dense ADI Helmholtz axis factor and the
  fast-diagonal eigen-data, from which the fused stage kernels
  (:mod:`rustpde_mpi_tpu_torch.ops.fused_step`) build their matrices;
* the solver objects the dense route of the step runs on:
  :class:`HholtzAdi` (axis-by-axis ADI Helmholtz), :class:`TensorSolver`
  (axis 0 eigen-diagonalised, one banded system per eigenvalue lane along
  axis 1), :class:`FastDiag` (both axes diagonalised: matrix products and
  one division), and :class:`Poisson` / :class:`Hholtz` on top of the
  last two.

A Fourier axis is already modal: its Helmholtz factor is a diagonal
(:class:`..ops.banded.DiagSolver`), its eigenvalues ``-k^2`` with no maps,
so on a Fourier x Chebyshev space the Poisson solve is one banded system
per Fourier mode along the Chebyshev axis, all modes (their real and
imaginary parts) in one launch of the banded kernel.

Every device solve is ``torch.matmul`` plus, on the ``"banded"`` method,
the banded substitution of :mod:`rustpde_mpi_tpu_torch.ops.banded`, whose
CUDA kernel runs on the card.  Solvers take their device and dtype from
the space they solve on.

On a :class:`..parallel.spaces.PencilSpace2` (a space on a mesh of ranks)
:class:`HholtzAdi`, :class:`TensorSolver` and :class:`FastDiag` solve
rank-stacked pencils, on every method: each axis solve or eigen map runs on
the pencil whose axis is local, with one pencil flip between the two axes
and one back, and each banded solve is one kernel launch for all ranks.
The systems are padded with identity rows to the pencil extents (the dense
inverse of the padded system, the banded factors; the fast-diagonalisation
divisor with ones), so pad rows couple to nothing and a zero pad stays
zero.
"""

from __future__ import annotations

import numpy as np
import torch

from .bases import BaseKind, Space2
from .config import to_device
from .ops.banded import (BandedSolver, DenseSolver, DiagSolver, apply_along, band_lu_factor,
                         dense_to_band, pad_band)
from .parallel.mesh import pad_matrix, padded

_P, _Q = 2, 4  # lower/upper bandwidth of every preconditioned Chebyshev operator


def ingredients_for_hholtz(space: Space2, axis: int):
    """``(mat_a, mat_b, precond)`` of one axis: a Chebyshev axis is
    preconditioned with the restricted quasi-inverse, so that ``mat_a -
    c*mat_b`` is banded; a Fourier axis is already diagonal (``(I,
    diag(-k^2), None)``)."""
    base = space.bases[axis]
    if base.is_periodic:
        return np.eye(base.m), base.laplace(), None
    peye = base.laplace_inv_eye()
    pinv = peye @ base.laplace_inv()
    S = base.mass()
    if base.kind == BaseKind.CHEBYSHEV:
        S = S[:, 2:]
    return pinv @ S, peye @ S, pinv


def hholtz_axis_solve_matrix(space: Space2, axis: int, ci: float) -> np.ndarray:
    """Dense ADI Helmholtz axis factor ``A = (mat_a - ci*mat_b)^-1 @
    precond`` in natural order: the 2-D solve is ``A0 @ rhs @ A1^T``.  A
    Fourier axis gives the diagonal ``1/(1 + ci*k^2)`` in the split Re/Im
    form over ``2m`` rows (each eigenvalue twice), what
    ``Base.axis_operator`` gives for that axis."""
    mat_a, mat_b, precond = ingredients_for_hholtz(space, axis)
    if space.bases[axis].is_periodic:
        d = 1.0 / np.diag(mat_a - ci * mat_b)
        return np.diag(np.concatenate([d, d]))
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
    zeros.  A Fourier axis is already modal: ``lam = sign*ci*(-k^2)``, no
    maps."""
    base = space.bases[axis]
    if base.is_periodic:
        return sign * ci * (-(base.wavenumbers**2)), None, None
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
    """``(lam, fwd, bwd)`` of one axis, eigenvalues in natural order, in
    the split Re/Im convention of the fused stages (the JAX package's
    contract of the same name): a Fourier axis's eigenvalues duplicated
    over the Re and Im blocks, its maps None."""
    lam, fwd, bwd = _axis_modal_data(space, axis, ci, sign)
    if space.bases[axis].is_periodic:
        lam = np.concatenate([lam, lam])
    return lam, fwd, bwd


# -- solver objects -------------------------------------------------------------


#: the method of every solver built without one, on the CPU and the card
#: alike; ``"pallas"`` is the JAX package's name for the same banded solve,
#: accepted so that a call written with that package's method names runs
#: unchanged
DEFAULT_METHOD = "banded"
_AXIS_METHODS = ("banded", "pallas", "dense")
_TENSOR_METHODS = ("banded", "pallas", "fd")


def _check_method(method: str, allowed) -> str:
    if method not in allowed:
        raise ValueError(f"unknown solver method {method!r}; use one of {allowed}")
    return method


def _check_rhs(rhs: torch.Tensor) -> int:
    """The axis of the rhs's first spectral dim (extra leading dims are
    batch)."""
    if rhs.ndim < 2:
        raise ValueError(
            f"2-D tensor solver needs rhs.ndim >= 2, got {rhs.ndim} (a rank-1 rhs "
            "would silently solve both axes over the same axis; batch dims go in front)")
    return rhs.ndim - 2


class _AxisSolver:
    """1-D solver of one axis: on a Chebyshev axis ``"banded"`` (and its
    alias ``"pallas"``) runs the banded substitution kernel, ``"dense"``
    the precomputed inverse; a Fourier axis is a :class:`DiagSolver`
    whatever the method.  The system (banded or dense) is padded with
    identity rows, and the diagonal with ones, to a multiple of ``nranks``,
    the pencil extent on a mesh of that many ranks (no padding for one
    rank)."""

    def __init__(self, mat: np.ndarray, method: str, nranks: int, *, device, dtype,
                 periodic: bool = False):
        kw = dict(device=device, dtype=dtype)
        method = _check_method(method, _AXIS_METHODS)
        if periodic:
            diag = np.diag(mat)
            self.solver = DiagSolver(np.pad(diag, (0, padded(len(diag), nranks) - len(diag)),
                                            constant_values=1.0), **kw)
        elif method == "dense":
            self.solver = DenseSolver(_pad_identity(mat, nranks), **kw)
        else:
            band = pad_band(dense_to_band(mat, _P, _Q), _P, padded(mat.shape[0], nranks))
            self.solver = BandedSolver(*band_lu_factor(band, _P, _Q), **kw)

    def solve(self, b, axis: int):
        return self.solver.solve(b, axis)

    def kernels(self) -> list:
        return [self.solver.kernel] if isinstance(self.solver, BandedSolver) else []


def _pad_identity(mat: np.ndarray, nranks: int) -> np.ndarray:
    """The square system ``mat`` padded with identity rows and columns up to
    a multiple of ``nranks``: the pad rows couple to nothing (the dense
    counterpart of :func:`..ops.banded.pad_band`)."""
    n = mat.shape[0]
    out = pad_matrix(mat, nranks)
    pad = np.arange(n, out.shape[0])
    out[pad, pad] = 1.0
    return out


def _apply(mat, x, axis):
    """``mat`` along ``axis`` of ``x``; None: the identity (the
    preconditioner of a Fourier axis, the modal maps of one)."""
    return x if mat is None else apply_along(mat, x, axis)


def default_method() -> str:
    """Method of the solves: :data:`DEFAULT_METHOD` on the CPU and on the
    card alike (on the card the recurrence runs as the CUDA kernel).
    Override per solver with ``method=``."""
    return DEFAULT_METHOD


class HholtzAdi:
    """ADI Helmholtz: ``(I - c*D2) vhat = A f`` solved axis by axis, each
    axis preconditioned with the restricted quasi-inverse (a matrix product)
    and then solved by its :class:`_AxisSolver` (a Fourier axis: no
    preconditioner, a diagonal solve)."""

    def __init__(self, space: Space2, c, method: str | None = None):
        method = method or default_method()
        self.space = space
        self.c = tuple(c)
        kw = dict(device=space.device, dtype=space.dtype)
        self.matvec = []
        self.solvers = []
        for axis, ci in enumerate(c):
            mat_a, mat_b, precond = ingredients_for_hholtz(space, axis)
            self.solvers.append(_AxisSolver(mat_a - ci * mat_b, method, space.nranks, **kw,
                                            periodic=space.bases[axis].is_periodic))
            self.matvec.append(None if precond is None else space.operator(precond))

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """rhs in ortho space -> solution in composite space; extra leading
        dims are batch.  On a pencil space: x-pencil in, x-pencil out, in
        the JAX package's order under a mesh (``solver.py:304-313``): the
        axis-0 preconditioner on the x-pencil, flip, the axis-1
        preconditioner and solve on the y-pencil, flip back, the axis-0
        solve (the flips are the identity on a serial space)."""
        ax = _check_rhs(rhs)
        out = _apply(self.matvec[0], rhs, ax)
        out = _apply(self.matvec[1], self.space.x_to_y(out), ax + 1)
        out = self.solvers[1].solve(out, ax + 1)  # axis-1 recurrence
        return self.solvers[0].solve(self.space.y_to_x(out), ax)  # axis-0 recurrence

    def kernels(self) -> list:
        return [k for s in self.solvers for k in s.kernels()]


class TensorSolver:
    """2-D tensor-product solver ``[(A_x x C_y) + (C_x x A_y) + alpha (C_x x
    C_y)] u = B2 f``: axis 0 diagonalised through the preconditioned pencil,
    axis 1 one banded system per eigenvalue lane, factored at build time.

    ``modal0 = (lam0, fwd0, bwd0)`` from :func:`_axis_modal_data`; ``fwd0``
    maps the axis-0 ortho-space rhs into eigenspace (preconditioner folded
    in).  ``mesh``: solve rank-stacked pencils of that mesh."""

    def __init__(self, modal0, a1, c1, precond1, alpha: float, fix_singular=False,
                 *, device, dtype, mesh=None):
        lam, fwd0, bwd0 = modal0
        kw = dict(device=device, dtype=dtype)
        self.mesh = mesh
        nranks = 1 if mesh is None else mesh.nranks
        # operators zero-padded, systems identity-padded to the pencil extents
        # the eigen maps (None on a Fourier axis, already modal)
        self.fwd = None if fwd0 is None else to_device(pad_matrix(fwd0, nranks), **kw)
        self.bwd = None if bwd0 is None else to_device(pad_matrix(bwd0, nranks), **kw)
        if fix_singular and abs(lam[0]) < 1e-10:
            # pure-Neumann problems: nudge the zero mode so the banded
            # factorization exists
            lam = lam - 1e-10
        self.lam = lam
        self.alpha = alpha
        self.matvec1 = to_device(pad_matrix(precond1, nranks), **kw)
        # (A_y + (lam_i + alpha) C_y) factored for every eigenvalue lane i,
        # assembled and eliminated on the band only
        band = dense_to_band(a1, _P, _Q)[None] + \
            (lam[:, None, None] + alpha) * dense_to_band(c1, _P, _Q)[None]
        lanes, n = band.shape[:2]
        band = pad_band(band, _P, padded(n, nranks), padded(lanes, nranks))
        lower, upper = band_lu_factor(band, _P, _Q)
        if mesh is not None and mesh.spanning:
            # this process's ranks' lanes (each lane's factors are its own)
            per = lower.shape[0] // nranks
            lanes = slice(mesh.rank0 * per, (mesh.rank0 + mesh.nlocal) * per)
            lower, upper = lower[lanes], upper[lanes]
        self.banded = BandedSolver(lower, upper, **kw)

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """rhs in ortho space -> solution in composite space; extra leading
        dims are batch (the per-lane factors align with axis 0 of the
        2-D problem).  On a mesh: x-pencil in, x-pencil out."""
        if self.mesh is not None:
            return self._solve_pencil(rhs)
        ax = _check_rhs(rhs)
        out = _apply(self.matvec1, rhs, ax + 1)
        out = _apply(self.fwd, out, ax)
        out = self.banded.solve(out, ax + 1)
        return _apply(self.bwd, out, ax)

    def _solve_pencil(self, rhs: torch.Tensor) -> torch.Tensor:
        """The eigen map on the x-pencil, flip, the axis-1 preconditioner
        and the per-eigenvalue banded solves on the y-pencil, whose ranks
        hold consecutive slices of the eigenvalue lanes (one launch, factor
        batch stride = the lanes a rank holds), flip back, the inverse eigen
        map.  The JAX package (``solver.py:385-395``) applies the axis-1
        preconditioner before the eigen map; the two act on different axes
        and commute, and this order needs one flip each way.  It differs
        from the serial solve in that order and in the lanes' factor
        offsets, so it is a path of its own.  A Fourier axis 0 has no eigen
        maps (its modes are the lanes), and its complex y-pencil goes to the
        banded kernel as two planes of real lanes.  An ensemble's pencils,
        ``(K, P, n0, n1)``, solve in the same one launch: the factor batch
        period P gives every member's rank ``r`` rank ``r``'s lanes."""
        if rhs.ndim not in (3, 4):
            raise ValueError(f"a pencil solve takes a rank-stacked ([K,] P, n0, n1) x-pencil, "
                             f"got rank {rhs.ndim}")
        out = _apply(self.fwd, rhs, -2)
        out = apply_along(self.matvec1, self.mesh.ring.x_to_y(out), -1)
        out = self.banded.solve(out, out.ndim - 1, factor_batch_stride=out.shape[-2],
                                factor_batch_period=self.mesh.nlocal)
        return _apply(self.bwd, self.mesh.ring.y_to_x(out), -2)

    def kernels(self) -> list:
        return [self.banded.kernel]


class FastDiag:
    """Fast-diagonalisation 2-D solver: both axes eigendecomposed through
    the preconditioned pencils, so the solve is four matrix products and one
    elementwise division.  The same discrete system as
    :class:`TensorSolver`.  ``mesh``: solve rank-stacked pencils of that
    mesh (the maps zero-padded, the divisor padded with ones)."""

    def __init__(self, modal0, modal1, alpha: float, fix_singular=False, *, device, dtype,
                 mesh=None):
        kw = dict(device=device, dtype=dtype)
        self.mesh = mesh
        nranks = 1 if mesh is None else mesh.nranks
        lams = [modal0[0], modal1[0]]
        self.fwd = [None if m[1] is None else to_device(pad_matrix(m[1], nranks), **kw)
                    for m in (modal0, modal1)]
        self.bwd = [None if m[2] is None else to_device(pad_matrix(m[2], nranks), **kw)
                    for m in (modal0, modal1)]
        if fix_singular and abs(lams[0][0]) < 1e-10:
            # pure-Neumann zero mode: same nudge as TensorSolver
            lams[0] = lams[0] - 1e-10
        denom = lams[0][:, None] + lams[1][None, :] + alpha
        if mesh is not None:
            # ones on the pad lanes, which hold zeros; the y-pencil's rank r
            # holds rows r*c.. of the padded divisor
            denom = np.pad(denom, [(0, padded(n, nranks) - n) for n in denom.shape],
                           constant_values=1.0)
            denom = denom.reshape(nranks, -1, denom.shape[1])
            denom = denom[mesh.rank0: mesh.rank0 + mesh.nlocal]  # this process's ranks
        self.denom = to_device(denom, **kw)

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """rhs in ortho space -> solution in composite space (extra leading
        dims are batch).  On a mesh: x-pencil in, x-pencil out."""
        if self.mesh is not None:
            return self._solve_pencil(rhs)
        ax = _check_rhs(rhs)
        out = _apply(self.fwd[0], rhs, ax)
        out = _apply(self.fwd[1], out, ax + 1)
        out = out / self.denom
        out = _apply(self.bwd[1], out, ax + 1)
        return _apply(self.bwd[0], out, ax)

    def _solve_pencil(self, rhs: torch.Tensor) -> torch.Tensor:
        """The JAX package's order under a mesh (``solver.py:440-461``): the
        axis-0 eigen map on the x-pencil, flip, the axis-1 map, the division
        by the rank's rows of the divisor and the inverse axis-1 map on the
        y-pencil, flip back, the inverse axis-0 map.  A Fourier axis 0 has
        no maps; an ensemble's ``(K, P, n0, n1)`` pencils solve in the same
        calls."""
        if rhs.ndim not in (3, 4):
            raise ValueError(f"a pencil solve takes a rank-stacked ([K,] P, n0, n1) x-pencil, "
                             f"got rank {rhs.ndim}")
        out = _apply(self.fwd[0], rhs, -2)
        out = _apply(self.fwd[1], self.mesh.ring.x_to_y(out), -1)
        out = _apply(self.bwd[1], out / self.denom, -1)
        return _apply(self.bwd[0], self.mesh.ring.y_to_x(out), -2)

    def kernels(self) -> list:
        return []


class _TensorBased:
    """Shared assembly of Poisson/Hholtz: ``"banded"`` (the default, alias
    ``"pallas"``) builds the eig-axis-0 + banded-axis-1 :class:`TensorSolver`,
    ``"fd"`` the :class:`FastDiag`.  Both diagonalise the same
    preconditioned pencils, so they solve the same discrete system."""

    def __init__(self, space: Space2, c, alpha: float, negate_lap: bool,
                 fix_singular=False, method: str | None = None):
        method = _check_method(method or default_method(), _TENSOR_METHODS)
        kw = dict(device=space.device, dtype=space.dtype)
        sign = -1.0 if negate_lap else 1.0
        modal0 = _axis_modal_data(space, 0, c[0], sign)
        if method == "fd":
            modal1 = _axis_modal_data(space, 1, c[1], sign)
            self._solver = FastDiag(modal0, modal1, alpha, fix_singular, mesh=space.mesh, **kw)
        else:
            # mat_c1 = preconditioned mass (pinv S), mat_a1 = preconditioned
            # laplacian (peye S)
            mat_c1, mat_a1, precond1 = ingredients_for_hholtz(space, 1)
            self._solver = TensorSolver(modal0, sign * c[1] * mat_a1, mat_c1, precond1,
                                        alpha, fix_singular=fix_singular, mesh=space.mesh, **kw)

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._solver.solve(rhs)

    def kernels(self) -> list:
        return self._solver.kernels()


class Poisson(_TensorBased):
    """Pressure Poisson ``c * D2 u = A f`` with the singular mode
    regularised (lam -= 1e-10)."""

    def __init__(self, space: Space2, c, method: str | None = None):
        super().__init__(space, c, alpha=0.0, negate_lap=False, fix_singular=True,
                         method=method)


class Hholtz(_TensorBased):
    """Exact (non-ADI) Helmholtz ``(I - c*D2) u = A f`` via the tensor
    solver with alpha=1."""

    def __init__(self, space: Space2, c, method: str | None = None):
        super().__init__(space, c, alpha=1.0, negate_lap=True, method=method)

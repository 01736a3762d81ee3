"""Spectral bases and 2-D tensor-product spaces (Chebyshev family).

Counterpart of the JAX package's ``bases.py``.  A :class:`Base` is a host
factory of numpy f64 operator matrices; a :class:`Space2` holds two bases
plus a device and a dtype, and applies every transform as a pair of dense
matrix products ``M_x @ v @ M_y^T`` on tensors of that device and dtype.

Spectral arrays are stored in natural index order (the JAX package's
CPU layout, ``Space2.sep == (False, False)``).  The parity-separated TPU
layout and the folded GEMM classes are TPU GEMM-shape devices and have no
counterpart here; :mod:`rustpde_mpi_tpu_torch.convert` reads a state
stored in that layout.

Only the confined (Chebyshev x Chebyshev) bases of the Rayleigh-Benard
step are ported: ``chebyshev``, ``cheb_dirichlet`` and ``cheb_neumann``.
"""

from __future__ import annotations

import enum
import weakref
from functools import cached_property

import numpy as np
import torch

from . import config
from .ops import chebyshev as chb
from .ops.folded import AxisOperator, dense_operator, kept_storage_rows


class BaseKind(enum.Enum):
    CHEBYSHEV = "chebyshev"
    CHEB_DIRICHLET = "cheb_dirichlet"
    CHEB_NEUMANN = "cheb_neumann"


_STENCILS = {
    BaseKind.CHEBYSHEV: chb.stencil_chebyshev,
    BaseKind.CHEB_DIRICHLET: chb.stencil_dirichlet,
    BaseKind.CHEB_NEUMANN: chb.stencil_neumann,
}


class Base:
    """One Chebyshev-family base along one axis.

    ``n``: physical grid size; ``m``: number of spectral modes (n for the
    orthogonal base, n-2 for the composite Galerkin bases)."""

    def __init__(self, kind: BaseKind, n: int):
        self.kind = kind
        self.n = n
        self.m = n if kind == BaseKind.CHEBYSHEV else n - 2
        self._diff_cache: dict = {}
        self._grad_cache: dict = {}

    def __repr__(self):
        return f"Base({self.kind.value}, n={self.n})"

    @cached_property
    def points(self) -> np.ndarray:
        return chb.cgl_points(self.n)

    # -- host operator matrices ---------------------------------------------

    @cached_property
    def stencil(self) -> np.ndarray:
        """S, (n x m): composite coefficients -> orthogonal coefficients."""
        return _STENCILS[self.kind](self.n)

    @cached_property
    def projection(self) -> np.ndarray:
        """P, (m x n): weighted Galerkin projection ortho -> composite."""
        return chb.projection_matrix(self.stencil)

    def diff_ortho(self, order: int) -> np.ndarray:
        """Dense (n x n) derivative operator in orthogonal coefficient space."""
        if order not in self._diff_cache:
            self._diff_cache[order] = chb.diff_matrix(self.n, order)
        return self._diff_cache[order]

    def gradient_matrix(self, order: int) -> np.ndarray:
        """D^order @ S: composite coefficients -> ortho derivative coeffs."""
        if order not in self._grad_cache:
            self._grad_cache[order] = self.diff_ortho(order) @ self.stencil
        return self._grad_cache[order]

    def mass(self) -> np.ndarray:
        """The stencil S."""
        return self.stencil

    def laplace(self) -> np.ndarray:
        """D2 in ortho coefficient space."""
        return self.diff_ortho(2)

    def laplace_inv(self) -> np.ndarray:
        """Chebyshev quasi-inverse B2 of D2 (rows 0,1 zero)."""
        return chb.quasi_inverse_b2(self.n)

    def laplace_inv_eye(self) -> np.ndarray:
        """(n-2) x n restriction selecting rows 2.. (B2 @ D2 restricted = I)."""
        return chb.restricted_eye(self.n)

    def dealias_cut(self) -> np.ndarray:
        """1-D 2/3-rule mask over this base's spectral rows."""
        cut = np.ones(self.m)
        cut[self.m * 2 // 3 :] = 0.0
        return cut

    def axis_operator(self, key, sep: bool = False) -> AxisOperator:
        """The dense per-axis operator matrix in this base's storage layout.
        ``key``: ``"fwd" | "fwd_cut" | "bwd" | "synthesis" | "stencil" |
        "proj" | ("bwd_grad", order) | ("grad", order)``; ``sep`` selects the
        parity-separated order on the spectral sides (the JAX package's TPU
        layout; the port itself runs with ``sep=False``)."""
        keep = None
        if key in ("fwd", "fwd_cut"):
            mat, sin, sout = self.projection @ chb.analysis_matrix(self.n), False, sep
            if key == "fwd_cut":
                keep = self.m * 2 // 3
        elif key == "bwd":
            mat, sin, sout = chb.synthesis_matrix(self.n) @ self.stencil, sep, False
        elif key == "synthesis":
            mat, sin, sout = chb.synthesis_matrix(self.n), sep, False
        elif key == "stencil":
            mat, sin, sout = self.stencil, sep, sep
        elif key == "proj":
            mat, sin, sout = self.projection, sep, sep
        elif isinstance(key, tuple) and key[0] == "bwd_grad":
            mat = chb.synthesis_matrix(self.n) @ self.gradient_matrix(key[1])
            sin, sout = sep, False
        elif isinstance(key, tuple) and key[0] == "grad":
            mat, sin, sout = self.gradient_matrix(key[1]), sep, sep
        else:
            raise ValueError(f"unknown axis_operator key {key!r}")
        kept = None if keep is None else kept_storage_rows(mat.shape[0], keep, sout)
        return AxisOperator(
            dense_operator(mat, sep_in=sin, sep_out=sout, keep_rows=keep),
            (sin, sout),
            keep,
            kept,
        )


_BASE_CACHE: "weakref.WeakValueDictionary[tuple[BaseKind, int], Base]" = (
    weakref.WeakValueDictionary()
)


def _cached_base(kind: BaseKind, n: int) -> Base:
    """One shared instance per (kind, n) while any space holds it, so the
    host matrices of e.g. the velx and vely spaces are built once."""
    key = (kind, n)
    base = _BASE_CACHE.get(key)
    if base is None:
        base = Base(kind, n)
        _BASE_CACHE[key] = base
    return base


def chebyshev(n: int) -> Base:
    return _cached_base(BaseKind.CHEBYSHEV, n)


def cheb_dirichlet(n: int) -> Base:
    return _cached_base(BaseKind.CHEB_DIRICHLET, n)


def cheb_neumann(n: int) -> Base:
    return _cached_base(BaseKind.CHEB_NEUMANN, n)


class Space2:
    """Tensor product of two bases (axis 0 = x, axis 1 = y) on one device in
    one dtype.  Arrays are ``(..., n_x, n_y)`` physical or ``(..., m_x,
    m_y)`` spectral; leading batch dimensions broadcast through the matrix
    products."""

    def __init__(self, base_x: Base, base_y: Base, *, device, dtype):
        self.bases = (base_x, base_y)
        self.device = torch.device(device)
        self.dtype = config.check_dtype(dtype)
        self._mats: dict = {}

    @property
    def base_x(self) -> Base:
        return self.bases[0]

    @property
    def base_y(self) -> Base:
        return self.bases[1]

    @property
    def shape_physical(self) -> tuple[int, int]:
        return (self.bases[0].n, self.bases[1].n)

    @property
    def shape_spectral(self) -> tuple[int, int]:
        return (self.bases[0].m, self.bases[1].m)

    def ndarray_spectral(self) -> torch.Tensor:
        return torch.zeros(self.shape_spectral, device=self.device, dtype=self.dtype)

    def _mat(self, axis: int, key) -> torch.Tensor | None:
        """Device copy of one axis operator (None: the identity, which the
        orthogonal base's stencil and projection are)."""
        ck = (axis, key)
        if ck not in self._mats:
            base = self.bases[axis]
            if key in ("stencil", "proj") and base.kind == BaseKind.CHEBYSHEV:
                self._mats[ck] = None
            else:
                mat = base.axis_operator(key).matrix
                self._mats[ck] = config.to_device(mat, self.device, self.dtype)
        return self._mats[ck]

    def _apply(self, v: torch.Tensor, kx, ky) -> torch.Tensor:
        """``M_x @ v @ M_y^T`` for the axis operators named ``kx``, ``ky``."""
        if v.ndim < 2:
            raise ValueError(f"Space2 expects a (..., nx, ny) array, got rank {v.ndim}")
        mx, my = self._mat(0, kx), self._mat(1, ky)
        out = v if mx is None else torch.matmul(mx, v)
        return out if my is None else torch.matmul(out, my.T)

    # -- transforms ---------------------------------------------------------

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """Physical (..., n_x, n_y) -> composite spectral (..., m_x, m_y)."""
        return self._apply(v, "fwd", "fwd")

    def backward(self, vhat: torch.Tensor) -> torch.Tensor:
        """Composite spectral -> physical."""
        return self._apply(vhat, "bwd", "bwd")

    def backward_fast(self, vhat: torch.Tensor) -> torch.Tensor:
        """The step's convection-velocity synthesis.  The JAX package runs a
        reduced-pass synthesis here on the TPU in f32; the port keeps the
        full-precision ``backward``."""
        return self.backward(vhat)

    def backward_ortho(self, c: torch.Tensor) -> torch.Tensor:
        """Physical values from orthogonal-space coefficients."""
        return self._apply(c, "synthesis", "synthesis")

    def to_ortho(self, vhat: torch.Tensor) -> torch.Tensor:
        return self._apply(vhat, "stencil", "stencil")

    def from_ortho(self, c: torch.Tensor) -> torch.Tensor:
        return self._apply(c, "proj", "proj")

    @staticmethod
    def _divide_scale(out, deriv, scale):
        if scale is not None:
            factor = (scale[0] ** deriv[0]) * (scale[1] ** deriv[1])
            if factor != 1.0:
                out = out / factor
        return out

    def gradient(self, vhat: torch.Tensor, deriv, scale=None) -> torch.Tensor:
        """d^deriv[0]/dx d^deriv[1]/dy in ortho space, divided by
        scale^deriv."""
        kx, ky = (("grad", d) if d else "stencil" for d in deriv)
        return self._divide_scale(self._apply(vhat, kx, ky), deriv, scale)

    def backward_gradient(self, vhat: torch.Tensor, deriv, scale=None) -> torch.Tensor:
        """Physical values of the derivative: ``backward_ortho(gradient(.))``
        as one synthesis-of-derivative product per axis."""
        kx, ky = (("bwd_grad", d) if d else "bwd" for d in deriv)
        return self._divide_scale(self._apply(vhat, kx, ky), deriv, scale)

    # -- helpers --------------------------------------------------------------

    def dealias_mask(self) -> np.ndarray:
        """2/3-rule mask over this space's spectral shape (host numpy)."""
        cx, cy = (base.dealias_cut() for base in self.bases)
        return cx[:, None] * cy[None, :]

    def pin_zero_mode(self, vhat: torch.Tensor) -> torch.Tensor:
        """Zero the constant mode (the pressure singularity pin)."""
        out = vhat.clone()
        out[..., 0, 0] = 0.0
        return out

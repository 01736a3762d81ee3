"""Spectral bases and 1-D and 2-D tensor-product spaces.

Counterpart of the JAX package's ``bases.py``.  A :class:`Base` is a host
factory of numpy f64 operator matrices; a :class:`Space2` holds two bases
plus a device, a dtype and a transform method, and runs every transform
axis by axis on tensors of that device; a :class:`Space1` does the same
for one base, and :class:`BiPeriodicSpace2` is the doubly periodic space
(Fourier c2c x r2c) of the Swift-Hohenberg model.

Bases: the Chebyshev family of the confined cell (``chebyshev``,
``cheb_dirichlet``, ``cheb_neumann``, and ``cheb_dirichlet_neumann`` of the
horizontal-convection temperature) and the Fourier bases of the
horizontally periodic cell (``fourier_r2c``, complex half spectrum of a
real field, and ``fourier_c2c``).  A Fourier axis always runs on
``torch.fft`` (cuFFT on the card); its derivative is a diagonal.  A
Chebyshev axis runs by ``method``: ``"matmul"``, one dense product per
axis, or ``"fft"``, the DCT-I through the rfft of the even extension (the
composite bases' stencil and projection stay products), as the JAX
package's ``Space2(method=...)`` does.

Spectral arrays are stored in natural index order (the JAX package's CPU
layout, ``Space2.sep == (False, False)``); a space with a Fourier axis has
a complex spectral dtype.  The parity-separated TPU layout, the split
Re/Im Fourier base as a model layout and the folded GEMM classes are TPU
devices with no counterpart here; the split form survives as
``Base.axis_operator``'s matrices of a Fourier axis (what the fused
kernels take), and :func:`to_complex`/:func:`from_complex` read a state
stored in it (:mod:`rustpde_mpi_tpu_torch.convert`).
"""

from __future__ import annotations

import enum
import weakref
from functools import cached_property

import numpy as np
import torch

from . import config
from .ops import chebyshev as chb
from .ops import fourier as fou
from .ops import transforms as tr
from .ops.folded import AxisOperator, dense_operator, kept_storage_rows

#: the Chebyshev transform method of a space on the CPU (the JAX package's
#: off-TPU choice) and on a CUDA card (the faster of the two on the H100 at
#: ``rbc1025`` and ``periodic1024``, PERF.md §6)
CPU_METHOD = "fft"
CARD_METHOD = "matmul"
METHODS = ("fft", "matmul")
#: the Chebyshev derivative runs the O(n) recurrence
#: (:func:`.ops.transforms.cheb_derivative`) from this size on, in float32
#: only (the JAX package's ``_fast_deriv_enabled``: its cumulative sums lose
#: to the product in f64 and below this size)
FAST_DERIV_MIN = 2048


class BaseKind(enum.Enum):
    CHEBYSHEV = "chebyshev"
    CHEB_DIRICHLET = "cheb_dirichlet"
    CHEB_NEUMANN = "cheb_neumann"
    CHEB_DIRICHLET_NEUMANN = "cheb_dirichlet_neumann"
    FOURIER_R2C = "fourier_r2c"
    FOURIER_C2C = "fourier_c2c"

    @property
    def is_periodic(self) -> bool:
        return self in (BaseKind.FOURIER_R2C, BaseKind.FOURIER_C2C)


_STENCILS = {
    BaseKind.CHEBYSHEV: chb.stencil_chebyshev,
    BaseKind.CHEB_DIRICHLET: chb.stencil_dirichlet,
    BaseKind.CHEB_NEUMANN: chb.stencil_neumann,
    BaseKind.CHEB_DIRICHLET_NEUMANN: chb.stencil_dirichlet_neumann,
}


class Base:
    """One spectral base along one axis.

    ``n``: physical grid size; ``m``: number of spectral modes (n for the
    orthogonal Chebyshev base and c2c, n-2 for the composite Galerkin
    bases, n//2+1 for r2c)."""

    def __init__(self, kind: BaseKind, n: int):
        self.kind = kind
        self.n = n
        if kind in (BaseKind.CHEBYSHEV, BaseKind.FOURIER_C2C):
            self.m = n
        elif kind == BaseKind.FOURIER_R2C:
            self.m = n // 2 + 1
        else:
            self.m = n - 2
        self._diff_cache: dict = {}
        self._grad_cache: dict = {}

    def __repr__(self):
        return f"Base({self.kind.value}, n={self.n})"

    @property
    def is_periodic(self) -> bool:
        """A Fourier base, whose spectral coefficients are complex."""
        return self.kind.is_periodic

    @cached_property
    def points(self) -> np.ndarray:
        if self.is_periodic:
            return fou.fourier_points(self.n)
        return chb.cgl_points(self.n)

    @cached_property
    def wavenumbers(self) -> np.ndarray:
        if self.kind == BaseKind.FOURIER_R2C:
            return fou.wavenumbers_r2c(self.n)
        if self.kind == BaseKind.FOURIER_C2C:
            return fou.wavenumbers_c2c(self.n)
        raise ValueError("wavenumbers only defined for Fourier bases")

    # -- host operator matrices ---------------------------------------------

    @cached_property
    def stencil(self) -> np.ndarray:
        """S, (n x m): composite coefficients -> orthogonal coefficients
        (the identity for Fourier bases)."""
        if self.is_periodic:
            return np.eye(self.m)
        return _STENCILS[self.kind](self.n)

    @cached_property
    def projection(self) -> np.ndarray:
        """P, (m x n): weighted Galerkin projection ortho -> composite."""
        if self.is_periodic:
            return np.eye(self.m)
        return chb.projection_matrix(self.stencil)

    def diff_ortho(self, order: int) -> np.ndarray:
        """The derivative in orthogonal coefficient space: dense (n x n) for
        Chebyshev, the diagonal (1-D, complex) ``(ik)^order`` for Fourier."""
        if order not in self._diff_cache:
            if self.is_periodic:
                self._diff_cache[order] = fou.diff_diag(
                    self.wavenumbers, order, self.n, self.kind == BaseKind.FOURIER_R2C)
            else:
                self._diff_cache[order] = chb.diff_matrix(self.n, order)
        return self._diff_cache[order]

    def gradient_matrix(self, order: int) -> np.ndarray:
        """D^order @ S: composite coefficients -> ortho derivative coeffs
        (1-D diagonal for Fourier bases)."""
        if order not in self._grad_cache:
            d = self.diff_ortho(order)
            self._grad_cache[order] = d if self.is_periodic else d @ self.stencil
        return self._grad_cache[order]

    def mass(self) -> np.ndarray:
        """The stencil S (the identity for the orthogonal and Fourier bases)."""
        return self.stencil

    def laplace(self) -> np.ndarray:
        """D2 in ortho coefficient space (dense for Chebyshev, ``diag(-k^2)``
        for Fourier)."""
        if self.is_periodic:
            return np.diag(-(self.wavenumbers**2))
        return self.diff_ortho(2)

    def laplace_inv(self) -> np.ndarray:
        """Chebyshev quasi-inverse B2 of D2 (rows 0,1 zero)."""
        if self.is_periodic:
            raise ValueError("laplace_inv only defined for Chebyshev bases")
        return chb.quasi_inverse_b2(self.n)

    def laplace_inv_eye(self) -> np.ndarray:
        """(n-2) x n restriction selecting rows 2.. (B2 @ D2 restricted = I)."""
        if self.is_periodic:
            raise ValueError("laplace_inv_eye only defined for Chebyshev bases")
        return chb.restricted_eye(self.n)

    def dealias_cut(self) -> np.ndarray:
        """1-D 2/3-rule mask over this base's spectral rows (for r2c, per
        complex mode)."""
        cut = np.ones(self.m)
        cut[self.m * 2 // 3 :] = 0.0
        return cut

    def axis_operator(self, key, sep: bool = False) -> AxisOperator:
        """The dense per-axis operator matrix in this base's storage layout.
        ``key``: ``"fwd" | "fwd_cut" | "bwd" | "synthesis" | "stencil" |
        "proj" | ("bwd_grad", order) | ("grad", order)``; ``sep`` selects the
        parity-separated order on the spectral sides (the JAX package's TPU
        layout; the port itself runs with ``sep=False``).

        An r2c base returns the split Re/Im real-matrix form over ``2m``
        rows ``[Re(c); Im(c)]``, the only dense form of the r2c transform
        (what the fused kernels take); its ``fwd_cut`` keeps rows ``[0:kc]``
        and ``[m:m+kc]``, kc = m*2//3, not a prefix."""
        if self.is_periodic:
            return self._split_operator(key, sep)
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

    def _split_operator(self, key, sep: bool) -> AxisOperator:
        if self.kind == BaseKind.FOURIER_C2C:
            raise ValueError("axis_operator is not defined for c2c bases")
        if sep:
            raise ValueError("sep layout is not defined for Fourier axes")
        n, mc = self.n, self.m
        if key == "fwd":
            return AxisOperator(fou.split_forward_matrix(n), (False, False), None, None)
        if key == "fwd_cut":
            # the per-complex-mode 2/3 cut on the Re and Im blocks alike
            cut = np.concatenate([self.dealias_cut(), self.dealias_cut()])
            mat = fou.split_forward_matrix(n) * cut[:, None]
            return AxisOperator(mat, (False, False), mc * 2 // 3, np.where(cut > 0)[0])
        if key in ("bwd", "synthesis"):
            return AxisOperator(fou.split_backward_matrix(n), (False, False), None, None)
        if isinstance(key, tuple) and key[0] == "bwd_grad":
            mat = fou.split_backward_matrix(n) @ fou.split_diff_matrix(n, key[1])
            return AxisOperator(mat, (False, False), None, None)
        if isinstance(key, tuple) and key[0] == "grad":
            return AxisOperator(fou.split_diff_matrix(n, key[1]), (False, False), None, None)
        if key in ("stencil", "proj"):
            return AxisOperator(np.eye(2 * mc), (False, False), None, None)
        raise ValueError(f"unknown axis_operator key {key!r}")


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


def cheb_dirichlet_neumann(n: int) -> Base:
    """Dirichlet at x = -1, Neumann at x = +1 (the horizontal-convection
    temperature's y base): a stencil that couples rows of both parities."""
    return _cached_base(BaseKind.CHEB_DIRICHLET_NEUMANN, n)


def fourier_r2c(n: int) -> Base:
    """Real-to-complex Fourier base (complex half spectrum, n//2+1 modes)."""
    return _cached_base(BaseKind.FOURIER_R2C, n)


def fourier_c2c(n: int) -> Base:
    """Complex-to-complex Fourier base (n modes, FFT order)."""
    return _cached_base(BaseKind.FOURIER_C2C, n)


def to_complex(vhat_split: np.ndarray, axis: int = 0) -> np.ndarray:
    """Host coefficients of an r2c axis in the split layout ``[Re(c_0..);
    Im(c_0..)]`` (2m rows along ``axis``) -> complex (m rows)."""
    a = np.moveaxis(np.asarray(vhat_split), axis, 0)
    mc = a.shape[0] // 2
    return np.moveaxis(a[:mc] + 1j * a[mc:], 0, axis)


def from_complex(vhat_c: np.ndarray, axis: int = 0) -> np.ndarray:
    """Inverse of :func:`to_complex`."""
    a = np.moveaxis(np.asarray(vhat_c), axis, 0)
    return np.moveaxis(np.concatenate([a.real, a.imag], axis=0), 0, axis)


def default_method(device) -> str:
    """The Chebyshev transform method of a space on ``device`` built without
    one: :data:`CPU_METHOD` on the CPU, :data:`CARD_METHOD` on a card."""
    return CPU_METHOD if torch.device(device).type == "cpu" else CARD_METHOD


class _AxisSpace:
    """What a 1-D and a 2-D tensor-product space share: the bases on one
    device in one real working dtype with one Chebyshev transform method,
    the device copies of the axis operators, and the transforms of one axis
    (:meth:`_axis`), the last ``len(bases)`` dims of an array being the
    space's axes and any dims in front batch dims."""

    #: no mesh: one rank holds the whole field
    mesh = None
    nranks = 1

    def __init__(self, bases, *, device, dtype, method: str | None = None):
        self.bases = tuple(bases)
        self.device = config.resolve_device(device)
        self.dtype = config.check_dtype(dtype)
        method = default_method(self.device) if method is None else method
        if method not in METHODS:
            raise ValueError(f"unknown transform method {method!r}; use one of {METHODS}")
        self.method = method
        self._mats: dict = {}

    @property
    def shape_physical(self) -> tuple:
        return tuple(b.n for b in self.bases)

    @property
    def shape_spectral(self) -> tuple:
        return tuple(b.m for b in self.bases)

    @property
    def spectral_is_complex(self) -> bool:
        return any(b.is_periodic for b in self.bases)

    @property
    def spectral_dtype(self) -> torch.dtype:
        if not self.spectral_is_complex:
            return self.dtype
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64

    def ndarray_spectral(self) -> torch.Tensor:
        return torch.zeros(self.shape_spectral, device=self.device, dtype=self.spectral_dtype)

    def axis_matrix(self, axis: int, key) -> np.ndarray | None:
        """Host f64 matrix of one Chebyshev axis operator (None: the
        identity, which the orthogonal base's stencil and projection are)."""
        base = self.bases[axis]
        if base.is_periodic:
            raise ValueError("a Fourier axis has no dense operator here; it runs on torch.fft")
        if key in ("stencil", "proj") and base.kind == BaseKind.CHEBYSHEV:
            return None
        return base.axis_operator(key).matrix

    def operator(self, mat: np.ndarray) -> torch.Tensor:
        """A host operator matrix (or diagonal) in this space's device and
        its real dtype, or its complex one for a complex host array."""
        if np.iscomplexobj(mat):
            return torch.as_tensor(np.ascontiguousarray(mat), dtype=self.spectral_dtype,
                                   device=self.device)
        return config.to_device(mat, self.device, self.dtype)

    def _mat(self, axis: int, key) -> torch.Tensor | None:
        """Device copy of one axis operator (None: the identity); the
        diagonal of ``("diag", order)`` on a Fourier axis."""
        ck = (axis, key)
        if ck not in self._mats:
            if isinstance(key, tuple) and key[0] == "diag":
                mat = self.bases[axis].gradient_matrix(key[1])
            else:
                mat = self.axis_matrix(axis, key)
            self._mats[ck] = None if mat is None else self.operator(mat)
        return self._mats[ck]

    # -- one axis ---------------------------------------------------------------

    def _fast_deriv(self, base: Base) -> bool:
        return self.dtype == torch.float32 and base.n >= FAST_DERIV_MIN

    def _axis(self, v: torch.Tensor, axis: int, key) -> torch.Tensor:
        """The operator named ``key`` (an :meth:`Base.axis_operator` key)
        applied along ``axis`` of ``v``."""
        ax = v.ndim - len(self.bases) + axis
        base = self.bases[axis]
        if base.is_periodic:
            return self._fourier(v, axis, ax, key)
        if key in ("stencil", "proj"):
            mat = self._mat(axis, key)
            return v if mat is None else tr.apply_along(mat, v, ax)
        if isinstance(key, tuple) and key[0] == "grad" and self._fast_deriv(base):
            return tr.cheb_derivative(self._axis(v, axis, "stencil"), key[1], ax)
        if self.method == "matmul":
            return tr.apply_along(self._mat(axis, key), v, ax)
        if key == "fwd":
            return self._axis(tr.cheb_forward_fft(v, ax), axis, "proj")
        if key == "bwd":
            return tr.cheb_backward_fft(self._axis(v, axis, "stencil"), ax)
        if key == "synthesis":
            return tr.cheb_backward_fft(v, ax)
        if key[0] == "bwd_grad":
            return tr.cheb_backward_fft(self._axis(v, axis, ("grad", key[1])), ax)
        return tr.apply_along(self._mat(axis, key), v, ax)  # ("grad", order)

    def _fourier(self, v, axis: int, ax: int, key) -> torch.Tensor:
        base = self.bases[axis]
        r2c = base.kind == BaseKind.FOURIER_R2C
        if key == "fwd":
            fn = tr.fourier_r2c_forward_fft if r2c else tr.fourier_c2c_forward_fft
            return fn(v, ax)
        if key in ("bwd", "synthesis"):
            fn = tr.fourier_r2c_backward_fft if r2c else tr.fourier_c2c_backward_fft
            return fn(v, ax, base.n)
        if key in ("stencil", "proj"):
            return v
        if key[0] == "grad":
            return tr.apply_diag(self._mat(axis, ("diag", key[1])), v, ax)
        if key[0] == "bwd_grad":
            return self._fourier(self._fourier(v, axis, ax, ("grad", key[1])), axis, ax, "bwd")
        raise ValueError(f"unknown axis operator key {key!r}")

    # -- layout ---------------------------------------------------------------

    def place_physical(self, values) -> torch.Tensor:
        """Global physical values (host array or tensor) as this space
        holds them: a copy in its device and real dtype."""
        return torch.tensor(np.ascontiguousarray(values), dtype=self.dtype, device=self.device)

    def place_spectral(self, values, dtype=None) -> torch.Tensor:
        """Global spectral (or ortho-space) values as this space holds
        them: a copy in its spectral dtype (or ``dtype``)."""
        return torch.tensor(np.ascontiguousarray(values), dtype=dtype or self.spectral_dtype,
                            device=self.device)

    def gather_physical(self, v: torch.Tensor) -> torch.Tensor:
        """The global physical field of ``v`` (``v`` itself)."""
        return v

    def gather_spectral(self, vhat: torch.Tensor) -> torch.Tensor:
        """The global spectral field of ``vhat`` (``vhat`` itself)."""
        return vhat

    def vhat_as_complex(self, vhat: torch.Tensor) -> np.ndarray:
        """Host copy of the coefficients in the complex convention (the
        port's own storage, so a copy)."""
        return vhat.detach().cpu().numpy()

    def vhat_from_complex(self, vhat_c) -> torch.Tensor:
        """Host coefficients in the complex convention (natural order) as
        this space holds them: the reading counterpart of
        :meth:`vhat_as_complex`, a copy on the space's device in its
        spectral dtype."""
        return self.place_spectral(vhat_c)


class Space2(_AxisSpace):
    """Tensor product of two bases (axis 0 = x, axis 1 = y) on one device in
    one dtype.  Arrays are ``(..., n_x, n_y)`` physical or ``(..., m_x,
    m_y)`` spectral; leading batch dimensions broadcast through the
    transforms.  ``device`` goes through :func:`..config.resolve_device`,
    so ``"cuda"`` names the current card (and raises without one);
    ``dtype`` is the real working dtype, the spectral dtype its complex
    counterpart when an axis is Fourier (:attr:`spectral_dtype`).
    ``method``: the Chebyshev axes' transform path, ``"fft"`` or
    ``"matmul"`` (default :func:`default_method`); a Fourier axis always
    runs on ``torch.fft``.

    A field of this space is held whole.  The pencil space of
    :mod:`.parallel.spaces` splits it over a mesh of ranks; both answer the
    layout calls (``place_*``, ``gather_*``, ``x_to_y``/``y_to_x``,
    ``weighted_sum``, ``apply_operators``), which are the identity or one
    product here, so a model or solver never asks which layout it runs
    on."""

    def __init__(self, base_x: Base, base_y: Base, *, device, dtype, method: str | None = None):
        if base_y.is_periodic and not base_x.is_periodic:
            raise ValueError("periodic y-axis under non-periodic x is unsupported")
        super().__init__((base_x, base_y), device=device, dtype=dtype, method=method)

    @property
    def base_x(self) -> Base:
        return self.bases[0]

    @property
    def base_y(self) -> Base:
        return self.bases[1]

    def _apply(self, v: torch.Tensor, kx, ky, y_first: bool = False) -> torch.Tensor:
        """The axis operators named ``kx`` and ``ky``, axis 0 first (axis 1
        first with ``y_first``, the forward's order)."""
        if v.ndim < 2:
            raise ValueError(f"Space2 expects a (..., nx, ny) array, got rank {v.ndim}")
        if y_first:
            return self._axis(self._axis(v, 1, ky), 0, kx)
        return self._axis(self._axis(v, 0, kx), 1, ky)

    # -- layout ---------------------------------------------------------------

    def x_to_y(self, v: torch.Tensor) -> torch.Tensor:
        """The flip to the layout with axis 1 local: the identity, as both
        axes are."""
        return v

    def y_to_x(self, v: torch.Tensor) -> torch.Tensor:
        """The flip to the layout with axis 0 local: the identity."""
        return v

    def weighted_sum(self, v: torch.Tensor, w: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """``sum(v * w)`` over the field, a 0-d tensor (``w`` placed as
        ``v`` is); the first ``lead`` dims of ``v`` are members, each summed
        apart (a tensor of those dims)."""
        if not lead:
            return torch.sum(v * w)
        p = v * w
        return p.reshape(*p.shape[:lead], -1).sum(dim=-1)

    def apply_operators(self, v: torch.Tensor, a0, a1) -> torch.Tensor:
        """``A0 @ v @ A1^T`` of the device operators ``a0``, ``a1`` (from
        :meth:`operator`; None: the identity; a 1-D one: a diagonal).
        Callers outside this class give it a spectral field and get one
        back, which is what the pencil space's counterpart takes and
        gives."""
        ax = v.ndim - 2
        for i, a in enumerate((a0, a1)):
            if a is not None:
                v = tr.apply_diag(a, v, ax + i) if a.ndim == 1 else tr.apply_along(a, v, ax + i)
        return v

    # -- transforms ---------------------------------------------------------

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """Physical (..., n_x, n_y) -> composite spectral (..., m_x, m_y)."""
        return self._apply(v, "fwd", "fwd", y_first=True)

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

    def gradient(self, vhat: torch.Tensor, deriv, scale=None) -> torch.Tensor:
        """d^deriv[0]/dx d^deriv[1]/dy in ortho space, divided by
        scale^deriv."""
        kx, ky = (("grad", d) if d else "stencil" for d in deriv)
        return divide_scale(self._apply(vhat, kx, ky), deriv, scale)

    def backward_gradient(self, vhat: torch.Tensor, deriv, scale=None) -> torch.Tensor:
        """Physical values of the derivative: ``backward_ortho(gradient(.))``
        as one synthesis of the derivative per axis."""
        kx, ky = (("bwd_grad", d) if d else "bwd" for d in deriv)
        return divide_scale(self._apply(vhat, kx, ky), deriv, scale)

    def synthesize(self, c: torch.Tensor, derivs, scale=None) -> list:
        """Physical values of the derivatives ``derivs`` (``(order x, order
        y)`` pairs) of orthogonal-space coefficients ``c``, each as
        ``backward_gradient`` gives it, with one x factor applied per
        distinct x order."""
        along_x = {dx: self._axis(c, 0, ("bwd_grad", dx) if dx else "synthesis")
                   for dx in dict.fromkeys(d[0] for d in derivs)}
        return [divide_scale(self._axis(along_x[dx], 1, ("bwd_grad", dy) if dy else "synthesis"),
                             (dx, dy), scale) for dx, dy in derivs]

    # -- helpers --------------------------------------------------------------

    def dealias_mask(self) -> np.ndarray:
        """2/3-rule mask over this space's spectral shape (host numpy; per
        complex mode on an r2c axis)."""
        cx, cy = (base.dealias_cut() for base in self.bases)
        return cx[:, None] * cy[None, :]

    def pin_zero_mode(self, vhat: torch.Tensor) -> torch.Tensor:
        """Zero the constant mode (the pressure singularity pin; on an r2c
        axis its real and imaginary parts)."""
        out = vhat.clone()
        out[..., 0, 0].zero_()  # in place on the device (capturable in a CUDA graph)
        return out


class Space1(_AxisSpace):
    """One-dimensional spectral space (the JAX package's ``Space1``): one
    base of any kind on one device in one dtype.  Arrays are ``(..., n)``
    physical or ``(..., m)`` spectral, leading dims batch.  ``method`` is
    the Chebyshev transform path, as :class:`Space2`'s; a Fourier base runs
    on ``torch.fft`` (the JAX package's split Re/Im r2c layout is a TPU
    device and is not ported: an r2c spectrum is complex)."""

    def __init__(self, base: Base, *, device, dtype, method: str | None = None):
        super().__init__((base,), device=device, dtype=dtype, method=method)

    @property
    def base(self) -> Base:
        return self.bases[0]

    def base_kind(self, axis: int = 0) -> BaseKind:
        del axis
        return self.base.kind

    def coords(self) -> list:
        return [self.base.points]

    def ndarray_physical(self) -> torch.Tensor:
        return torch.zeros(self.shape_physical, device=self.device, dtype=self.dtype)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """Physical -> (composite) spectral."""
        return self._axis(v, 0, "fwd")

    def backward(self, vhat: torch.Tensor) -> torch.Tensor:
        """(Composite) spectral -> physical."""
        return self._axis(vhat, 0, "bwd")

    def backward_ortho(self, c: torch.Tensor) -> torch.Tensor:
        """Physical values from orthogonal-space coefficients."""
        return self._axis(c, 0, "synthesis")

    def to_ortho(self, vhat: torch.Tensor) -> torch.Tensor:
        return self._axis(vhat, 0, "stencil")

    def from_ortho(self, c: torch.Tensor) -> torch.Tensor:
        return self._axis(c, 0, "proj")

    def gradient(self, vhat: torch.Tensor, deriv, scale=None) -> torch.Tensor:
        """d^deriv/dx in ortho space, divided by scale^deriv (``deriv`` and
        ``scale`` a number or a 1-element sequence)."""
        order = deriv if isinstance(deriv, int) else deriv[0]
        out = self._axis(vhat, 0, ("grad", order) if order else "stencil")
        if scale is not None:
            factor = float(scale if isinstance(scale, (int, float)) else scale[0]) ** order
            if factor != 1.0:
                out = out / factor
        return out

    def dealias_mask(self) -> np.ndarray:
        """The 2/3-rule mask over the spectral rows (host numpy)."""
        return self.base.dealias_cut()

    def pin_zero_mode(self, vhat: torch.Tensor) -> torch.Tensor:
        """Zero the constant mode (in place on a copy: capturable)."""
        out = vhat.clone()
        out[..., 0].zero_()
        return out


class BiPeriodicSpace2:
    """Doubly periodic real 2-D space (the JAX package's
    ``BiPeriodicSpace2``): Fourier c2c along x times r2c along y, spectral
    arrays complex ``(..., nx, my)``, ``my = ny//2 + 1``, on ``torch.fft``
    with the amplitude normalisation (a forward divides by the length of
    each axis).  The JAX package's split Re/Im layout and its matrix and
    four-step FFT paths are TPU devices: here the spectrum is complex, and
    :meth:`vhat_as_complex`/:meth:`vhat_from_complex` read and write the
    reference's complex coefficients.

    Every operator a captured step reads (the derivative factors, the
    conjugate-pair index of :meth:`enforce_hermitian_x`) is put on the
    device when it is first asked for, so a step's warm-up puts them
    there before a capture."""

    mesh = None
    nranks = 1

    def __init__(self, nx: int, ny: int, *, device, dtype):
        self.nx, self.ny = int(nx), int(ny)
        self.my = self.ny // 2 + 1
        self.device = config.resolve_device(device)
        self.dtype = config.check_dtype(dtype)
        self.kx = fou.wavenumbers_c2c(self.nx)
        self.ky = fou.wavenumbers_r2c(self.ny)
        self._grad: dict = {}
        #: the conjugate partner of each kx row, ``(-k) mod nx``
        self.conj_index = (-torch.arange(self.nx, device=self.device)) % self.nx

    @property
    def shape_physical(self) -> tuple[int, int]:
        return (self.nx, self.ny)

    @property
    def shape_spectral(self) -> tuple[int, int]:
        return (self.nx, self.my)

    @property
    def spectral_dtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64

    def coords(self) -> list:
        return [fou.fourier_points(self.nx), fou.fourier_points(self.ny)]

    def ndarray_physical(self) -> torch.Tensor:
        return torch.zeros(self.shape_physical, device=self.device, dtype=self.dtype)

    def ndarray_spectral(self) -> torch.Tensor:
        return torch.zeros(self.shape_spectral, device=self.device, dtype=self.spectral_dtype)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """Real physical ``(..., nx, ny)`` -> spectral ``(..., nx, my)``."""
        return tr.fourier_c2c_forward_fft(tr.fourier_r2c_forward_fft(v, -1), -2)

    def backward(self, s: torch.Tensor) -> torch.Tensor:
        """Spectral ``(..., nx, my)`` -> real physical ``(..., nx, ny)``."""
        return tr.fourier_r2c_backward_fft(tr.fourier_c2c_backward_fft(s, -2, self.nx), -1,
                                           self.ny)

    def _grad_factor(self, deriv) -> np.ndarray:
        """``(i kx)^dx (i ky)^dy`` over the ``(nx, my)`` modes (complex host
        array), odd-order Nyquist modes zeroed (:func:`.ops.fourier.diff_diag`)."""
        fx = fou.diff_diag(self.kx, deriv[0], self.nx, r2c=False)
        fy = fou.diff_diag(self.ky, deriv[1], self.ny, r2c=True)
        return fx[:, None] * fy[None, :]

    def gradient(self, s: torch.Tensor, deriv, scale=None) -> torch.Tensor:
        """The mixed derivative in spectral space, divided by
        ``scale^deriv``."""
        key = (tuple(int(d) for d in deriv), None if scale is None else tuple(scale))
        if key not in self._grad:
            f = self._grad_factor(deriv)
            if scale is not None:
                f = f / ((scale[0] ** deriv[0]) * (scale[1] ** deriv[1]))
            self._grad[key] = torch.as_tensor(f, dtype=self.spectral_dtype, device=self.device)
        return s * self._grad[key]

    def dealias_mask(self) -> np.ndarray:
        """The 2/3 rule over both axes, ``(nx, my)`` host numpy: the c2c x
        axis cut by wavenumber magnitude (keep ``|k| < (2 mx) // 3``, ``mx
        = nx//2 + 1``), the r2c y axis as :meth:`Base.dealias_cut`."""
        mx = self.nx // 2 + 1
        cx = (np.abs(self.kx) < (mx * 2) // 3).astype(np.float64)
        cy = np.ones(self.my)
        cy[(self.my * 2) // 3:] = 0.0
        return cx[:, None] * cy[None, :]

    def pin_zero_mode(self, s: torch.Tensor) -> torch.Tensor:
        """Zero the (0, 0) mode (in place on a copy: capturable)."""
        out = s.clone()
        out[..., 0, 0].zero_()
        return out

    def enforce_hermitian_x(self, s: torch.Tensor) -> torch.Tensor:
        """Make the self-conjugate ky columns conjugate-symmetric in kx: a
        real field has ``c(-kx, ky) = conj(c(kx, ky))`` at ky = 0 and, for
        even ny, at the ky Nyquist column, and the implicit update amplifies
        an anti-Hermitian roundoff there wherever the mode is unstable.  Each
        such column becomes ``(c + conj(c[-kx])) / 2``."""
        out = s.clone()
        cols = [0] + ([self.my - 1] if self.ny % 2 == 0 else [])
        for c in cols:
            col = s[..., :, c]
            out[..., :, c] = 0.5 * (col + col.index_select(-1, self.conj_index).conj())
        return out

    def vhat_as_complex(self, s: torch.Tensor) -> np.ndarray:
        """Host copy of the complex coefficients."""
        return s.detach().cpu().numpy()

    def vhat_from_complex(self, c) -> torch.Tensor:
        """Complex host coefficients as this space holds them."""
        return torch.tensor(np.ascontiguousarray(c), dtype=self.spectral_dtype,
                            device=self.device)


def divide_scale(out: torch.Tensor, deriv, scale) -> torch.Tensor:
    """A derivative in unit coordinates divided by ``scale^deriv``, the
    derivative in scaled coordinates (unchanged without a scale)."""
    if scale is None:
        return out
    factor = (scale[0] ** deriv[0]) * (scale[1] ** deriv[1])
    return out if factor == 1.0 else out / factor


def fused_projection_gradient(space_out: Space2, space_in: Space2, deriv) -> tuple:
    """Per-axis device operators that apply
    ``space_out.from_ortho(space_in.gradient(., deriv))`` as one product per
    axis: ``P_out @ D^order @ S_in`` (the JAX package's function of the same
    name, as one dense matrix per axis; the pressure-projection velocity
    correction of the dense step).  A Fourier axis gives its derivative's
    diagonal (1-D, complex; None for order 0), which
    :meth:`Space2.apply_operators` multiplies.  The result is ``M0 @ v @
    M1^T``, not yet divided by the scale; the operators are in
    ``space_out``'s device, dtype and layout (``space_out.operator``)."""
    mats = []
    for axis, order in enumerate(deriv):
        b_out, b_in = space_out.bases[axis], space_in.bases[axis]
        if b_out.is_periodic:
            mats.append(space_out.operator(b_in.gradient_matrix(order)) if order else None)
        else:
            mats.append(space_out.operator(b_out.projection @ b_in.gradient_matrix(order)))
    return tuple(mats)

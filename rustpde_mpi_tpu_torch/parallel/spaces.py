"""Spectral transforms of a 2-D space on pencil fields.

The counterpart of the JAX package's ``Space2`` under an active mesh: the
same transforms, on fields split over a :class:`..parallel.mesh.Mesh` as
rank-stacked pencils (spectral data in x-pencils, physical data in
y-pencils).  Each transform is the serial space's pair of axis operators,
zero-padded to the pencil extents, applied by
:func:`..parallel.mesh.apply_separable` (spectral input) or
:func:`..parallel.mesh.forward_separable` (physical input), which flip the
pencil between the two factors where the JAX package places its
``constrain`` calls (``bases.py:905-1010``).  It answers the serial
space's layout calls (``place_*``, ``gather_*``, ``x_to_y``/``y_to_x``,
``weighted_sum``, ``apply_operators``) on pencils, so a model or solver
runs on either space unchanged.

A Fourier x axis (the periodic cell) keeps its serial form: its forward
and backward run on ``torch.fft`` on the x-pencil, which holds axis 0
whole (the pad rows sliced off before, zeros appended after), and its
derivative is a diagonal; its spectral fields are complex x-pencils, which
the y-axis factors reach through a flip of complex pencils.

Every transform takes a leading member dim in front of the rank (an
ensemble's K members, ``(K, P, ...)``), as the serial space takes leading
batch dims.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..bases import Space2, divide_scale
from ..ops import transforms as tr
from .decomp import Decomp2d, all_gather_sum
from .mesh import (Mesh, apply_axis, apply_separable, forward_separable, pad_matrix,
                   padded, x_pencil_shape)


class PencilSpace2:
    """A :class:`..bases.Space2` on ``mesh``: its transforms take and give
    stacked pencils.  The space's device must be the mesh's."""

    def __init__(self, space: Space2, mesh: Mesh):
        if space.device != mesh.device:
            raise ValueError(f"space on {space.device}, mesh on {mesh.device}")
        self.space = space
        self.mesh = mesh
        self.nranks = mesh.nranks
        self.bases = space.bases
        self.device, self.dtype = space.device, space.dtype
        self.physical = Decomp2d(space.shape_physical, mesh)
        self.spectral = Decomp2d(space.shape_spectral, mesh)
        self._mats: dict = {}

    @property
    def shape_physical(self) -> tuple[int, int]:
        return self.space.shape_physical

    @property
    def shape_spectral(self) -> tuple[int, int]:
        return self.space.shape_spectral

    @property
    def spectral_is_complex(self) -> bool:
        return self.space.spectral_is_complex

    @property
    def spectral_dtype(self) -> torch.dtype:
        return self.space.spectral_dtype

    def ndarray_spectral(self) -> torch.Tensor:
        """Zero spectral x-pencil (this process's ranks on a spanning
        mesh)."""
        shape = x_pencil_shape(self.shape_spectral, self.mesh.nranks)
        return torch.zeros((self.mesh.nlocal, *shape[1:]), device=self.device,
                           dtype=self.spectral_dtype)

    # -- placement -------------------------------------------------------------

    def place_physical(self, values) -> torch.Tensor:
        """Global physical values -> y-pencil in the space's dtype."""
        return self.physical.place_y_pencil(values, self.dtype)

    def place_spectral(self, values, dtype=None) -> torch.Tensor:
        """Global spectral (or ortho-space, same extents) values -> x-pencil
        in the space's spectral dtype (complex on a Fourier x axis), or in
        ``dtype``."""
        return Decomp2d(np.shape(values), self.mesh).place_x_pencil(
            values, dtype or self.spectral_dtype)

    def gather_physical(self, block: torch.Tensor) -> torch.Tensor:
        return self.physical.gather_y_pencil(block)

    def gather_spectral(self, block: torch.Tensor) -> torch.Tensor:
        return self.spectral.gather_x_pencil(block)

    def vhat_as_complex(self, block: torch.Tensor) -> np.ndarray:
        """Host copy of the global coefficients of a spectral x-pencil, in
        the complex convention (gathered, the pad sliced away)."""
        return self.gather_spectral(block).detach().cpu().numpy()

    def vhat_from_complex(self, vhat_c) -> torch.Tensor:
        """Global host coefficients -> spectral x-pencil in the space's
        spectral dtype (the reading counterpart of
        :meth:`vhat_as_complex`)."""
        return self.place_spectral(vhat_c)

    def x_to_y(self, block: torch.Tensor) -> torch.Tensor:
        """x-pencil -> y-pencil, through the mesh's transpose."""
        return self.mesh.ring.x_to_y(block)

    def y_to_x(self, block: torch.Tensor) -> torch.Tensor:
        """y-pencil -> x-pencil."""
        return self.mesh.ring.y_to_x(block)

    def weighted_sum(self, v: torch.Tensor, w: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """``sum(v * w)`` over the field: per rank, then across the ranks
        in rank order (:func:`.decomp.all_gather_sum`, through the ring's
        rank gather on a spanning mesh); ``w`` is zero on the pad.  The
        first ``lead`` dims of ``v`` are members, each summed apart."""
        return all_gather_sum(v * w, self.mesh, lead)

    def apply_operators(self, vhat: torch.Tensor, a0, a1) -> torch.Tensor:
        """``A0 @ vhat @ A1^T`` of padded device matrices (from
        :meth:`operator`), x-pencil in, x-pencil out."""
        return apply_separable(self.mesh, vhat, a0, a1, spectral_out=True)

    def operator(self, mat: np.ndarray) -> torch.Tensor:
        """A host operator matrix (or a diagonal, 1-D), zero-padded to the
        pencil extents, in the space's device and dtype (its complex one
        for a complex host array)."""
        if np.ndim(mat) == 1:
            return self.space.operator(np.pad(mat, (0, padded(len(mat), self.nranks) - len(mat))))
        return self.space.operator(pad_matrix(mat, self.mesh.nranks))

    def _mat(self, axis: int, key):
        """The axis factor named ``key`` (see :func:`.mesh.apply_axis`):
        a padded device matrix of a Chebyshev axis (None: the identity), or
        the FFT or diagonal of a Fourier one."""
        ck = (axis, key)
        if ck not in self._mats:
            if self.bases[axis].is_periodic:
                self._mats[ck] = self._fourier(axis, key)
            else:
                mat = self.space.axis_matrix(axis, key)
                self._mats[ck] = None if mat is None else self.operator(mat)
        return self._mats[ck]

    def _fourier(self, axis: int, key):
        """The axis factor of an r2c x axis, which the x-pencil (axis 1 of
        the stacked tensor) holds whole: the transforms on ``torch.fft``,
        the pad rows sliced off before and zeros appended after, the result
        contiguous; the
        derivative a padded diagonal; the stencil and projection the
        identity."""
        base = self.bases[axis]
        if axis != 0:
            raise ValueError("a Fourier axis on pencils is axis 0")
        n, m = base.n, base.m
        pad_m, pad_n = padded(m, self.nranks) - m, padded(n, self.nranks) - n
        if key in ("stencil", "proj"):
            return None
        # contiguous: an FFT along axis 1 returns its result with the axes'
        # strides permuted, and a flip needs the last axis at unit stride
        if key == "fwd":
            return lambda v: F.pad(tr.fourier_r2c_forward_fft(v[..., :n, :], -2),
                                   (0, 0, 0, pad_m)).contiguous()
        if key in ("bwd", "synthesis"):
            return lambda c: F.pad(tr.fourier_r2c_backward_fft(c[..., :m, :], -2, n),
                                   (0, 0, 0, pad_n)).contiguous()
        if key[0] == "grad":
            return self.operator(base.gradient_matrix(key[1]))
        if key[0] == "bwd_grad":
            diag, bwd = self._mat(axis, ("grad", key[1])), self._mat(axis, "bwd")
            return lambda c: bwd(tr.apply_diag(diag, c, -2))
        raise ValueError(f"unknown axis operator key {key!r}")

    def _apply(self, vhat, kx, ky, spectral_out: bool) -> torch.Tensor:
        return apply_separable(self.mesh, vhat, self._mat(0, kx), self._mat(1, ky), spectral_out)

    # -- transforms -------------------------------------------------------------

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """Physical y-pencil -> composite spectral x-pencil."""
        return forward_separable(self.mesh, v, self._mat(0, "fwd"), self._mat(1, "fwd"))

    def backward(self, vhat: torch.Tensor) -> torch.Tensor:
        """Composite spectral x-pencil -> physical y-pencil."""
        return self._apply(vhat, "bwd", "bwd", False)

    def backward_fast(self, vhat: torch.Tensor) -> torch.Tensor:
        """The step's convection-velocity synthesis (``backward``)."""
        return self.backward(vhat)

    def backward_ortho(self, c: torch.Tensor) -> torch.Tensor:
        """Physical y-pencil from orthogonal-space coefficients."""
        return self._apply(c, "synthesis", "synthesis", False)

    def to_ortho(self, vhat: torch.Tensor) -> torch.Tensor:
        return self._apply(vhat, "stencil", "stencil", True)

    def from_ortho(self, c: torch.Tensor) -> torch.Tensor:
        """Orthogonal-space coefficients -> composite ones (x-pencils)."""
        return self._apply(c, "proj", "proj", True)

    def gradient(self, vhat: torch.Tensor, deriv, scale=None) -> torch.Tensor:
        """d^deriv[0]/dx d^deriv[1]/dy in ortho space (x-pencil), divided
        by scale^deriv."""
        kx, ky = (("grad", d) if d else "stencil" for d in deriv)
        return divide_scale(self._apply(vhat, kx, ky, True), deriv, scale)

    def backward_gradient(self, vhat: torch.Tensor, deriv, scale=None) -> torch.Tensor:
        """Physical values (y-pencil) of the derivative."""
        kx, ky = (("bwd_grad", d) if d else "bwd" for d in deriv)
        return divide_scale(self._apply(vhat, kx, ky, False), deriv, scale)

    def synthesize(self, c: torch.Tensor, derivs, scale=None) -> list:
        """Physical values (y-pencils) of the derivatives ``derivs`` of
        orthogonal-space coefficients ``c``, each as ``backward_gradient``
        gives it, with one x factor and one flip per distinct x order."""
        along_x = {dx: self.mesh.ring.x_to_y(apply_axis(
            self._mat(0, ("bwd_grad", dx) if dx else "synthesis"), c, -2))
            for dx in dict.fromkeys(d[0] for d in derivs)}
        return [divide_scale(apply_axis(self._mat(1, ("bwd_grad", dy) if dy else "synthesis"),
                                        along_x[dx], -1), (dx, dy), scale) for dx, dy in derivs]

    # -- helpers ----------------------------------------------------------------

    def dealias_mask(self) -> np.ndarray:
        """2/3-rule mask over the global spectral shape (host numpy)."""
        return self.space.dealias_mask()

    def pin_zero_mode(self, vhat: torch.Tensor) -> torch.Tensor:
        """Zero the constant mode, which rank 0 of the x-pencil holds (on
        an r2c axis its real and imaginary parts; on a spanning mesh only
        the process that holds rank 0 has it)."""
        out = vhat.clone()
        if self.mesh.rank0 == 0:
            out[..., 0, 0, 0].zero_()  # in place on the device (capturable in a CUDA graph)
        return out

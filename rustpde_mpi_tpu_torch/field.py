"""The field layer: quadrature weights, norms, volume averages,
:class:`Field1` and :class:`Field2` (counterpart of the JAX package's
``field.py``).

The spectral coefficients ``vhat`` are a field's single source of truth;
its physical values are computed on demand.
"""

from __future__ import annotations

import numpy as np
import torch

from .bases import BaseKind


def grid_deltas(x: np.ndarray, periodic: bool = False) -> np.ndarray:
    """Midpoint cell widths of a grid, used for volume averages; a periodic
    grid's uniform spacing."""
    if periodic:
        return np.full(x.shape, x[2] - x[1])
    xs_left = np.concatenate([[x[0]], 0.5 * (x[1:] + x[:-1])])
    xs_right = np.concatenate([0.5 * (x[1:] + x[:-1]), [x[-1]]])
    return xs_right - xs_left


def _axis_length(x, dx, axis: int, periodic: bool) -> float:
    """Axis length of the average weights: a periodic axis spans a full
    period (|x[-1]-x[0]| + dx), so its weights sum to 1."""
    span = abs(float(x[axis][-1] - x[axis][0]))
    if periodic:
        span += float(dx[axis][0])
    return span


def average_weights(x: np.ndarray, periodic: bool = False) -> np.ndarray:
    """dx/L quadrature weights along one axis, summing to 1; a periodic
    axis spans a full period (|x[-1]-x[0]| + dx)."""
    dx = grid_deltas(x, periodic)
    return dx / _axis_length([x], [dx], 0, periodic)


def _weights(v: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """Host weights as a tensor beside ``v`` (its device, its real dtype)."""
    real = v.real.dtype if v.is_complex() else v.dtype
    return torch.as_tensor(w, dtype=real, device=v.device)


def average_axis(v: torch.Tensor, x, dx, axis: int, periodic: bool = False) -> torch.Tensor:
    """Volume-weighted average of the physical field ``v`` along ``axis``
    (dx/L weights; ``x``/``dx`` the per-axis host coordinates and
    deltas)."""
    w = _weights(v, dx[axis] / _axis_length(x, dx, axis, periodic))
    shape = [1, 1]
    shape[axis] = w.shape[0]
    return torch.sum(v * w.reshape(shape), dim=axis)


def average(v: torch.Tensor, x, dx, periodic: tuple[bool, bool] = (False, False)) -> torch.Tensor:
    """Full volume-weighted average of the physical field ``v``, a 0-d
    tensor."""
    ax = average_axis(v, x, dx, 0, periodic=periodic[0])
    w = _weights(ax, dx[1] / _axis_length(x, dx, 1, periodic[1]))
    return torch.sum(ax * w)


def norm_l2(a: torch.Tensor) -> torch.Tensor:
    """Frobenius norm (a 0-d tensor on the input's device; of the real and
    imaginary parts of a complex one)."""
    if a.is_complex():
        a = torch.view_as_real(a)
    return torch.sqrt(torch.sum(a * a))


class Field1:
    """One-dimensional field on a :class:`..bases.Space1`, in the space's
    device and dtype: ``vhat`` (spectral, the state), ``v`` (physical,
    computed from ``vhat``; assigning it runs the forward transform), ``x``
    and ``dx`` (host coordinates and grid deltas, one-element lists)."""

    def __init__(self, space):
        self.space = space
        self.vhat = space.ndarray_spectral()
        self.x = [space.base.points.copy()]
        self.dx = [grid_deltas(space.base.points, space.base.is_periodic)]

    def scale(self, scale) -> None:
        """Stretch the coordinates (a number or a 1-element sequence)."""
        s = scale if isinstance(scale, (int, float)) else scale[0]
        self.x[0] = self.x[0] * s
        self.dx[0] = self.dx[0] * s

    @property
    def v(self) -> torch.Tensor:
        return self.space.backward(self.vhat)

    @v.setter
    def v(self, values) -> None:
        # the physical dtype is complex only on a c2c base
        dtype = (self.space.spectral_dtype if self.space.base.kind == BaseKind.FOURIER_C2C
                 else self.space.dtype)
        self.vhat = self.space.forward(torch.as_tensor(values, dtype=dtype,
                                                       device=self.space.device))

    def forward(self, v: torch.Tensor) -> None:
        self.vhat = self.space.forward(v)

    def backward(self) -> torch.Tensor:
        return self.space.backward(self.vhat)

    def to_ortho(self) -> torch.Tensor:
        return self.space.to_ortho(self.vhat)

    def from_ortho(self, c: torch.Tensor) -> None:
        self.vhat = self.space.from_ortho(c)

    def gradient(self, deriv, scale=None) -> torch.Tensor:
        return self.space.gradient(self.vhat, deriv, scale)

    def average(self) -> torch.Tensor:
        """Volume-weighted average of ``v``, a 0-d tensor."""
        periodic = self.space.base.is_periodic
        v = self.v
        return torch.sum(v * _weights(v, self.dx[0] / _axis_length(self.x, self.dx, 0,
                                                                      periodic)))


class Field2:
    """Two-dimensional field on a :class:`..bases.Space2`, in the space's
    device and dtype.

    ``vhat`` (spectral, the state), ``v`` (physical, computed from
    ``vhat``; assigning it runs the forward transform), ``x`` (host
    coordinates per axis), ``dx`` (host grid deltas).  ``scale`` stretches
    the coordinates only; spectral operators receive the scale
    explicitly."""

    def __init__(self, space):
        self.space = space
        self.vhat = space.ndarray_spectral()
        self.x = [b.points.copy() for b in space.bases]
        self.dx = [grid_deltas(b.points, b.is_periodic) for b in space.bases]

    def scale(self, scale) -> None:
        for i, s in enumerate(scale):
            self.x[i] = self.x[i] * s
            self.dx[i] = self.dx[i] * s

    # -- transforms ------------------------------------------------------------

    @property
    def v(self) -> torch.Tensor:
        return self.space.backward(self.vhat)

    @v.setter
    def v(self, values) -> None:
        # the physical dtype is complex only on a c2c x axis
        dtype = (self.space.spectral_dtype if self.space.base_x.kind == BaseKind.FOURIER_C2C
                 else self.space.dtype)
        self.vhat = self.space.forward(torch.as_tensor(values, dtype=dtype,
                                                       device=self.space.device))

    def forward(self, v: torch.Tensor) -> None:
        self.vhat = self.space.forward(v)

    def backward(self) -> torch.Tensor:
        return self.space.backward(self.vhat)

    def to_ortho(self) -> torch.Tensor:
        return self.space.to_ortho(self.vhat)

    def from_ortho(self, c: torch.Tensor) -> None:
        self.vhat = self.space.from_ortho(c)

    def gradient(self, deriv, scale=None) -> torch.Tensor:
        return self.space.gradient(self.vhat, deriv, scale)

    # -- volume-weighted averages ----------------------------------------------

    def average_axis(self, axis: int) -> torch.Tensor:
        periodic = self.space.bases[axis].is_periodic
        return average_axis(self.v, self.x, self.dx, axis, periodic=periodic)

    def average(self) -> torch.Tensor:
        periodic = tuple(b.is_periodic for b in self.space.bases)
        return average(self.v, self.x, self.dx, periodic=periodic)

    # -- per-field HDF5 IO (needs h5py) ----------------------------------------

    def write(self, filename: str, group: str) -> None:
        """Write this field as a ``{group}/{x,dx,y,dy,v,vhat}`` HDF5 group
        (create-or-append file semantics, the reference's)."""
        import h5py

        from .utils import checkpoint

        with h5py.File(filename, "a") as h5:
            checkpoint.write_field(h5, group, self.space, self.vhat, self.x, self.dx)

    def read(self, filename: str, group: str) -> None:
        """Restore the spectral coefficients from a snapshot group (spectral
        interpolation on a resolution mismatch)."""
        import h5py

        from .utils import checkpoint

        with h5py.File(filename, "r") as h5:
            vhat = checkpoint.read_field_vhat(h5, group, self.space)
        self.vhat = self.space.vhat_from_complex(vhat)

"""MeanFields: the base state of the linearised and perturbation models.

Counterpart of the JAX package's ``models/meanfield.py``: the velx/vely/temp
base state as spectral coefficients of the full orthogonal space (Chebyshev
x Chebyshev confined, Fourier r2c x Chebyshev periodic), with the analytic
Rayleigh-Benard (linear conduction profile) and horizontal-convection
(cos-bottom parabola) constructors and a read-from-file variant that falls
back to the analytic profile when the file is missing.  The coefficients
live in the space's device and dtype; a model places them in its own
layout (a mesh's pencils).
"""

from __future__ import annotations

import os

import numpy as np

from .. import config
from ..bases import Space2, chebyshev, fourier_r2c


class MeanFields:
    """velx/vely/temp spectral coefficients on the full ortho space."""

    _VARS = (("ux", "velx"), ("uy", "vely"), ("temp", "temp"))

    def __init__(self, space: Space2, velx=None, vely=None, temp=None):
        self.space = space
        self.velx = space.ndarray_spectral() if velx is None else velx
        self.vely = space.ndarray_spectral() if vely is None else vely
        self.temp = space.ndarray_spectral() if temp is None else temp

    # -- constructors ------------------------------------------------------------

    @classmethod
    def _space(cls, nx: int, ny: int, periodic: bool, device=None,
               dtype=config.DEFAULT_DTYPE, method: str | None = None) -> Space2:
        x_base = fourier_r2c if periodic else chebyshev
        return Space2(x_base(nx), chebyshev(ny), device=device, dtype=dtype, method=method)

    @classmethod
    def new_rbc(cls, nx: int, ny: int, periodic: bool = False, **kw) -> "MeanFields":
        """Linear conduction profile, T = 0.5 at the bottom to -0.5 at the
        top.  Keyword arguments (``device``, ``dtype``, ``method``) go to
        the space."""
        space = cls._space(nx, ny, periodic, **kw)
        y = space.bases[1].points
        profile = -(y - y[0]) / (y[-1] - y[0]) + 0.5
        v = np.broadcast_to(profile[None, :], space.shape_physical)
        return cls(space, temp=space.forward(space.place_physical(v)))

    @classmethod
    def new_hc(cls, nx: int, ny: int, periodic: bool = False, **kw) -> "MeanFields":
        """Horizontal convection: T = -0.5 cos(2 pi x~) at the bottom, a
        parabola in y with its vertex at the top wall."""
        space = cls._space(nx, ny, periodic, **kw)
        x, y = space.bases[0].points, space.bases[1].points
        f_x = -0.5 * np.cos(2.0 * np.pi * (x - x[0]) / (x[-1] - x[0]))
        a = f_x / (y[0] - y[-1]) ** 2
        v = a[:, None] * (y[None, :] - y[-1]) ** 2
        return cls(space, temp=space.forward(space.place_physical(v)))

    @classmethod
    def read_from(cls, nx: int, ny: int, filename: str, bc: str | None = None,
                  periodic: bool = False, **kw) -> "MeanFields":
        """Read a mean field from a flow snapshot; fall back to the analytic
        profile of ``bc`` when the file does not exist."""
        if os.path.isfile(filename):
            mean = cls(cls._space(nx, ny, periodic, **kw))
            mean.read(filename)
            return mean
        print(f"File {filename!r} does not exist. Use {bc!r} meanfield.")
        if bc == "hc":
            return cls.new_hc(nx, ny, periodic, **kw)
        return cls.new_rbc(nx, ny, periodic, **kw)

    # -- IO (the snapshot layout, variables ux/uy/temp) ---------------------------

    def read(self, filename: str) -> None:
        """Read the base state from a flow snapshot (needs ``h5py``): the
        stored physical values ``{var}/v`` forward-transformed in the ortho
        space, exact for any source space (the JAX package's fix over the
        reference); ``vhat`` when ``v`` is absent (then the source must be
        ortho-space data, as this class writes)."""
        import h5py

        from ..utils.checkpoint import read_field_vhat

        with h5py.File(filename, "r") as h5:
            for varname, attr in self._VARS:
                if f"{varname}/v" in h5:
                    v = np.asarray(h5[f"{varname}/v"])
                    if v.shape != self.space.shape_physical:
                        raise ValueError(f"{varname}/v shape {v.shape} != grid "
                                         f"{self.space.shape_physical}; resample the "
                                         "snapshot first")
                    vhat = self.space.forward(self.space.place_physical(v))
                else:
                    vhat = self.space.vhat_from_complex(read_field_vhat(h5, varname, self.space))
                setattr(self, attr, vhat)
        print(f" <== {filename}")

    def write(self, filename: str) -> None:
        """Append the base state to ``filename`` in the snapshot layout
        (needs ``h5py``)."""
        import h5py

        from ..field import grid_deltas
        from ..utils.checkpoint import write_field

        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        xs = [b.points for b in self.space.bases]
        dxs = [grid_deltas(b.points, b.is_periodic) for b in self.space.bases]
        with h5py.File(filename, "a") as h5:
            for varname, attr in self._VARS:
                write_field(h5, varname, self.space, getattr(self, attr), xs, dxs)

    def physical(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host physical values of velx, vely, temp."""
        return tuple(self.space.backward_ortho(getattr(self, attr)).cpu().numpy()
                     for attr in ("velx", "vely", "temp"))

    def host_coefficients(self) -> dict:
        """``{attr: host complex-convention coefficients}`` (a model places
        them in its own layout)."""
        return {attr: self.space.vhat_as_complex(getattr(self, attr))
                for attr in ("velx", "vely", "temp")}


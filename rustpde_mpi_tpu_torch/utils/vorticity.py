"""Vorticity post-processing: append ``omega = dv/dx - du/dy`` to a flow
snapshot (counterpart of the JAX package's ``utils/vorticity.py``, the
reference's ``vorticity.rs``): read the velocities' coefficients, take the
vorticity in spectral space, dealias it (2/3 rule) and append
``vorticity/{v,vhat}`` to the same file.  Runs on the CPU (it is file IO,
as the checkpoint readers are) and needs ``h5py``.  The confined or
periodic cell is detected from the stored data (complex ``vhat`` pairs:
a periodic x axis), or named by the function.
"""

from __future__ import annotations

import torch

from ..bases import Space2, cheb_dirichlet, chebyshev, fourier_r2c
from .checkpoint import _write_array, read_field_vhat


def vorticity_from_file(fname: str) -> None:
    """Confined cell (``vorticity.rs:40-57``)."""
    _vorticity(fname, periodic=False)


def vorticity_from_file_periodic(fname: str) -> None:
    """Periodic x axis (``vorticity.rs:65-81``)."""
    _vorticity(fname, periodic=True)


def vorticity_auto(fname: str) -> None:
    """The cell detected from the snapshot itself."""
    import h5py

    with h5py.File(fname, "r") as h5:
        periodic = "ux/vhat_re" in h5
    _vorticity(fname, periodic=periodic)


def _vorticity(fname: str, periodic: bool) -> None:
    import h5py

    kw = dict(device="cpu", dtype=torch.float64)
    with h5py.File(fname, "r") as h5:
        nx = h5["ux/x"].shape[0]
        ny = h5["ux/y"].shape[0]
        x_base = fourier_r2c if periodic else cheb_dirichlet
        x_full = fourier_r2c if periodic else chebyshev
        vel_space = Space2(x_base(nx), cheb_dirichlet(ny), **kw)
        vort_space = Space2(x_full(nx), chebyshev(ny), **kw)
        uxhat = vel_space.vhat_from_complex(read_field_vhat(h5, "ux", vel_space))
        uyhat = vel_space.vhat_from_complex(read_field_vhat(h5, "uy", vel_space))
    dudz = vel_space.gradient(uxhat, (0, 1), (1.0, 1.0))
    dvdx = vel_space.gradient(uyhat, (1, 0), (1.0, 1.0))
    mask = torch.as_tensor(vort_space.dealias_mask(), dtype=torch.float64)
    vort = (dvdx - dudz) * mask
    v = vort_space.backward_ortho(vort).numpy()
    with h5py.File(fname, "a") as h5:
        grp = h5.require_group("vorticity")
        _write_array(grp, "v", v)
        _write_array(grp, "vhat", vort_space.vhat_as_complex(vort))

"""Carry a Navier2D state between the JAX package and the port.

The state is the five spectral leaves ``temp, velx, vely, pres, pseu`` as
host numpy arrays (complex for the periodic model).  The port stores
spectral axes in natural order; the JAX package does too on the CPU, but
on the TPU it stores Chebyshev axes in the parity-separated order
``[evens..., odds...]``, which ``sep=(True, True)`` reads, and a periodic
model's Fourier axis in the split Re/Im layout (real ``[Re(c); Im(c)]``
rows, no complex dtypes there), which ``split=True`` reads through
:func:`..bases.to_complex`.  A complex state (the JAX package's off the
TPU) is read as it is.  The operator constants are not carried: both
packages rebuild them from the same host math.

A meshed model (``Navier2D(..., mesh=...)``) holds its leaves as spectral
x-pencils (complex ones in the periodic cell); they are gathered to, and
scattered from, the global arrays here, so a JAX meshed model's state
(gathered to numpy, in either layout) carries over as a serial one does.
"""

from __future__ import annotations

import numpy as np
import torch

from .bases import to_complex
from .ops.folded import parity_perm_inv

STATE_FIELDS = ("temp", "velx", "vely", "pres", "pseu")


def state_to_numpy(model) -> dict:
    """``{leaf: float64 (complex128 for the periodic model) numpy array}``
    of the model's state, natural order, global (gathered from the pencils
    on a mesh)."""
    out = {}
    for name, space in model._state_fields():
        leaf = space.gather_spectral(getattr(model.state, name)).detach().cpu()
        out[name] = leaf.to(torch.complex128 if leaf.is_complex() else torch.float64).numpy()
    return out


def state_from_numpy(model, arrays, sep=(False, False), split: bool = False) -> None:
    """Load ``arrays`` (a mapping leaf -> 2-D array) into ``model.state``.
    ``sep[axis]`` marks an axis stored in the parity-separated order, which
    is undone here; ``split``: axis 0 (a periodic model's Fourier axis) is
    in the split Re/Im layout, read as complex."""
    leaves = {}
    for name, space in model._state_fields():
        a = np.asarray(arrays[name])
        if split:
            a = to_complex(a, axis=0)
        if a.shape != space.shape_spectral:
            raise ValueError(f"{name}: shape {a.shape}, expected {space.shape_spectral}")
        for axis, s in enumerate(sep):
            if s:
                a = np.take(a, parity_perm_inv(a.shape[axis]), axis=axis)
        leaves[name] = space.place_spectral(a)
    model.state = model.state._replace(**leaves)

"""Carry a Navier2D state between the JAX package and the port.

The state is the five spectral leaves ``temp, velx, vely, pres, pseu`` as
host numpy arrays.  The port stores spectral axes in natural order; the JAX
package does too on the CPU, but on the TPU it stores Chebyshev axes in the
parity-separated order ``[evens..., odds...]``.  ``sep=(True, True)`` reads
an array in that order.  The operator constants are not carried: both
packages rebuild them from the same host math.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.folded import parity_perm_inv

STATE_FIELDS = ("temp", "velx", "vely", "pres", "pseu")


def state_to_numpy(model) -> dict:
    """``{leaf: float64 numpy array}`` of the model's state, natural order."""
    return {
        name: getattr(model.state, name).detach().cpu().double().numpy()
        for name in STATE_FIELDS
    }


def state_from_numpy(model, arrays, sep=(False, False)) -> None:
    """Load ``arrays`` (a mapping leaf -> 2-D array) into ``model.state``.
    ``sep[axis]`` marks an axis stored in the parity-separated order, which
    is undone here."""
    leaves = {}
    for name, space in model._state_fields():
        a = np.asarray(arrays[name])
        if a.shape != space.shape_spectral:
            raise ValueError(f"{name}: shape {a.shape}, expected {space.shape_spectral}")
        for axis, s in enumerate(sep):
            if s:
                a = np.take(a, parity_perm_inv(a.shape[axis]), axis=axis)
        leaves[name] = torch.tensor(a, dtype=model.dtype, device=model.device)
    model.state = model.state._replace(**leaves)

"""Inhomogeneous-boundary-condition lift profiles (counterpart of the JAX
package's ``models/boundary_conditions.py``): physical values on the grid
as numpy arrays, transformed once at build time into ortho-space device
constants by the model."""

from __future__ import annotations

import numpy as np


def bc_rbc_values(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Rayleigh-Benard temperature lift: T = +0.5 at the bottom plate,
    -0.5 at the top (linear conduction profile)."""
    y1, y2 = 0.5, -0.5
    x1, x2 = y[0], y[-1]
    m = (y2 - y1) / (x2 - x1)
    n = (y1 * x2 - y2 * x1) / (x2 - x1)
    profile = m * y + n
    return np.broadcast_to(profile[None, :], (x.shape[0], y.shape[0])).copy()

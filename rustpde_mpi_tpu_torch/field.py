"""Quadrature weights and norms (counterpart of the JAX package's
``field.py``, confined axes only)."""

from __future__ import annotations

import numpy as np
import torch


def grid_deltas(x: np.ndarray) -> np.ndarray:
    """Midpoint cell widths of a non-periodic grid, used for volume averages."""
    xs_left = np.concatenate([[x[0]], 0.5 * (x[1:] + x[:-1])])
    xs_right = np.concatenate([0.5 * (x[1:] + x[:-1]), [x[-1]]])
    return xs_right - xs_left


def average_weights(x: np.ndarray) -> np.ndarray:
    """dx/L quadrature weights along one non-periodic axis, summing to 1."""
    return grid_deltas(x) / abs(float(x[-1] - x[0]))


def norm_l2(a: torch.Tensor) -> torch.Tensor:
    """Frobenius norm (a 0-d tensor on the input's device)."""
    return torch.sqrt(torch.sum(a * a))

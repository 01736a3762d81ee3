"""Quadrature weights and norms (counterpart of the JAX package's
``field.py``)."""

from __future__ import annotations

import numpy as np
import torch


def grid_deltas(x: np.ndarray, periodic: bool = False) -> np.ndarray:
    """Midpoint cell widths of a grid, used for volume averages; a periodic
    grid's uniform spacing."""
    if periodic:
        return np.full(x.shape, x[2] - x[1])
    xs_left = np.concatenate([[x[0]], 0.5 * (x[1:] + x[:-1])])
    xs_right = np.concatenate([0.5 * (x[1:] + x[:-1]), [x[-1]]])
    return xs_right - xs_left


def average_weights(x: np.ndarray, periodic: bool = False) -> np.ndarray:
    """dx/L quadrature weights along one axis, summing to 1; a periodic
    axis spans a full period (|x[-1]-x[0]| + dx)."""
    dx = grid_deltas(x, periodic)
    span = abs(float(x[-1] - x[0]))
    if periodic:
        span += float(dx[0])
    return dx / span


def norm_l2(a: torch.Tensor) -> torch.Tensor:
    """Frobenius norm (a 0-d tensor on the input's device; of the real and
    imaginary parts of a complex one)."""
    if a.is_complex():
        a = torch.view_as_real(a)
    return torch.sqrt(torch.sum(a * a))

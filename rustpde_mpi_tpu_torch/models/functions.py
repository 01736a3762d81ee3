"""Physics helper functions: dimensionless groups and the random and
trigonometric initial values (counterpart of the JAX package's
``models/functions.py``)."""

from __future__ import annotations

import numpy as np


def get_nu(ra: float, pr: float, height: float) -> float:
    """Viscosity from Ra, Pr and cell height: sqrt(Pr / (Ra/h^3))."""
    return float(np.sqrt(pr / (ra / height**3)))


def get_ka(ra: float, pr: float, height: float) -> float:
    """Diffusivity from Ra, Pr and cell height: sqrt(1 / (Ra/h^3 * Pr))."""
    return float(np.sqrt(1.0 / ((ra / height**3) * pr)))


def _normalized_coords(x: np.ndarray) -> np.ndarray:
    """``x`` mapped affinely onto [0, 1]."""
    return (x - x[0]) / (x[-1] - x[0])


def sin_cos_values(x: np.ndarray, y: np.ndarray, amp: float, m: float, n: float) -> np.ndarray:
    """``amp * sin(pi m x~) cos(pi n y~)`` on the normalized coordinates."""
    xn, yn = _normalized_coords(x), _normalized_coords(y)
    return amp * np.sin(np.pi * m * xn)[:, None] * np.cos(np.pi * n * yn)[None, :]


def cos_sin_values(x: np.ndarray, y: np.ndarray, amp: float, m: float, n: float) -> np.ndarray:
    """``amp * cos(pi m x~) sin(pi n y~)`` on the normalized coordinates."""
    xn, yn = _normalized_coords(x), _normalized_coords(y)
    return amp * np.cos(np.pi * m * xn)[:, None] * np.sin(np.pi * n * yn)[None, :]


def random_values(shape: tuple[int, int], amp: float, rng: np.random.Generator) -> np.ndarray:
    """Uniform disturbance in [-amp, amp] from a numpy ``Generator`` — the
    same stream as the JAX package, so both start from identical states."""
    return rng.uniform(-amp, amp, size=shape)

"""Physics helper functions: dimensionless groups and random initial
values (counterpart of the JAX package's ``models/functions.py``)."""

from __future__ import annotations

import numpy as np


def get_nu(ra: float, pr: float, height: float) -> float:
    """Viscosity from Ra, Pr and cell height: sqrt(Pr / (Ra/h^3))."""
    return float(np.sqrt(pr / (ra / height**3)))


def get_ka(ra: float, pr: float, height: float) -> float:
    """Diffusivity from Ra, Pr and cell height: sqrt(1 / (Ra/h^3 * Pr))."""
    return float(np.sqrt(1.0 / ((ra / height**3) * pr)))


def random_values(shape: tuple[int, int], amp: float, rng: np.random.Generator) -> np.ndarray:
    """Uniform disturbance in [-amp, amp] from a numpy ``Generator`` — the
    same stream as the JAX package, so both start from identical states."""
    return rng.uniform(-amp, amp, size=shape)

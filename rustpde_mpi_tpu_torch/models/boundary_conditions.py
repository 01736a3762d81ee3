"""Inhomogeneous-boundary-condition lift profiles (counterpart of the JAX
package's ``models/boundary_conditions.py``): physical values on the grid
as numpy arrays, transformed once at build time into ortho-space device
constants by the model.  ``TEMPERATURE_LIFTS`` names the temperature lift
of each boundary-condition type (``"rbc"``, ``"hc"``)."""

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


def pres_bc_rbc_values(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Rayleigh-Benard pressure lift: the parabola a*y^2 + b*y whose
    derivative matches the hydrostatic buoyancy +-0.5 at the plates."""
    df_l, df_r = 0.5, -0.5
    y_l, y_r = y[0], y[-1]
    a = 0.5 * (df_r - df_l) / (y_r - y_l)
    b = df_l - 2.0 * a * y_l
    parabola = a * y**2 + b * y
    return np.broadcast_to(parabola[None, :], (x.shape[0], y.shape[0])).copy()


def bc_hc_values(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Horizontal-convection temperature lift: T = -0.5*cos(2 pi (x-x0)/L)
    at the bottom, T = T' = 0 at the top, as a parabola in y with its
    vertex at the top wall."""
    x0 = x[0]
    length = x[-1] - x[0]
    f_x = -0.5 * np.cos(2.0 * np.pi * (x - x0) / length)  # bottom value per column
    y_l, y_r = y[0], y[-1]
    a = f_x / (y_l - y_r) ** 2  # parabola through (y_l, f_x) with vertex at y_r
    return a[:, None] * (y[None, :] - y_r) ** 2


def transfer_function(x: np.ndarray, v_l: float, v_m: float, v_r: float, k: float) -> np.ndarray:
    """Smooth transition profile from ``v_l`` through ``v_m`` to ``v_r``
    of steepness ``k``."""
    length = x[-1] - x[0]
    xs = x * 2.0 / length
    neg = -1.0 * k * xs / (k + xs + 1.0) * (v_l - v_m) + v_m
    pos = 1.0 * k * xs / (k - xs + 1.0) * (v_r - v_m) + v_m
    return np.where(xs < 0.0, neg, pos)


def bc_zero_values(x: np.ndarray, y: np.ndarray, k: float) -> np.ndarray:
    """Zero-sidewall temperature lift with a smooth transfer to the +-0.5
    plates."""
    profile = transfer_function(y, 0.5, 0.0, -0.5, k)
    return np.broadcast_to(profile[None, :], (x.shape[0], y.shape[0])).copy()


#: the temperature lift of each boundary-condition type a model takes
TEMPERATURE_LIFTS = {"rbc": bc_rbc_values, "hc": bc_hc_values}

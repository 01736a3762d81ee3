"""Gradient-based optimization routines (counterpart of the JAX package's
``models/opt_routines.py``), in numpy on host arrays."""

from __future__ import annotations

import numpy as np

from .lnse import l2_norm


def steepest_descent_energy_constrained(velx_0: np.ndarray, vely_0: np.ndarray,
                                        temp_0: np.ndarray, grad_velx: np.ndarray,
                                        grad_vely: np.ndarray, grad_temp: np.ndarray,
                                        beta1: float, beta2: float, alpha: float):
    """Steepest descent without energy increase: project the gradient
    perpendicular to the state, then rotate on the constant-energy sphere by
    the angle ``alpha``.  Returns ``(velx_new, vely_new, temp_new)``."""
    if alpha > 2.0 * np.pi:
        raise ValueError("alpha must be less than 2 pi")
    n = velx_0.size
    e0 = float(l2_norm(velx_0, velx_0, vely_0, vely_0, temp_0, temp_0, beta1, beta2)) / n
    eg = float(l2_norm(grad_velx, velx_0, grad_vely, vely_0, grad_temp, temp_0,
                       beta1, beta2)) / n
    # the gradient projected perpendicular to the state
    ee = eg / e0
    gu = grad_velx - ee * velx_0
    gv = grad_vely - ee * vely_0
    gt = grad_temp - ee * temp_0
    # a combination of the old fields and the gradient on the energy sphere
    eg = float(l2_norm(gu, gu, gv, gv, gt, gt, beta1, beta2)) / n
    ee2 = np.sqrt(e0 / eg)
    ca, sa = np.cos(alpha), np.sin(alpha)
    return (velx_0 * ca + gu * (ee2 * sa), vely_0 * ca + gv * (ee2 * sa),
            temp_0 * ca + gt * (ee2 * sa))

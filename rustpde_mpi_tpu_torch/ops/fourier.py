"""Host-side (numpy, f64) operator builders for Fourier bases (r2c and c2c).

A copy of the JAX package's ``ops/fourier.py`` host math, so the port
imports nothing of that package.  Domain convention: x in [0, 2*pi),
uniform points, integer wavenumbers; the aspect ratio enters through the
``scale`` argument of gradients and solvers, never through the base.

The split forms (``[Re(c); Im(c)]`` stacked as real rows, m = n//2+1 modes
each) are the dense-matrix form of the r2c transform: the fused kernels take
a complex field as those stacked real planes, and a state saved in the JAX
package's split layout is read through them (:mod:`..convert`).
"""

from __future__ import annotations

import numpy as np


def fourier_points(n: int) -> np.ndarray:
    """Uniform grid on [0, 2*pi)."""
    return 2.0 * np.pi * np.arange(n) / n


def wavenumbers_r2c(n: int) -> np.ndarray:
    """k = 0..n//2 (real-to-complex half spectrum)."""
    return np.arange(n // 2 + 1, dtype=np.float64)


def wavenumbers_c2c(n: int) -> np.ndarray:
    """Standard FFT ordering 0, 1, ..., -1."""
    return np.fft.fftfreq(n, d=1.0 / n)


def split_forward_matrix(n: int) -> np.ndarray:
    """(2m x n) real matrix F with ``[Re(c); Im(c)] = F @ v`` equal to the
    amplitude-normalized r2c transform (rfft/n), m = n//2+1.  The right
    column half is mirror-constructed from the exact circular identities
    ``cos(2pi k (n-j)/n) = cos(2pi k j/n)`` / ``sin -> -sin``, and the sines
    that are zero exactly (the Nyquist column and row of an even n) are
    written as zeros."""
    m = n // 2 + 1
    half = n // 2 + 1  # columns 0..n//2; the rest mirror j -> n-j
    j = np.arange(half)[None, :]
    k = np.arange(m)[:, None]
    ang = 2.0 * np.pi * k * j / n
    cos_l = np.cos(ang)
    sin_l = -np.sin(ang)
    if n % 2 == 0:
        # sin(pi*k) / sin(pi*j) are 0 exactly but evaluate to ~1e-13
        sin_l[:, half - 1] = 0.0
        sin_l[m - 1, :] = 0.0
    cos = np.empty((m, n))
    sin = np.empty((m, n))
    cos[:, :half] = cos_l
    sin[:, :half] = sin_l
    cos[:, half:] = cos_l[:, 1 : n - half + 1][:, ::-1]
    sin[:, half:] = -sin_l[:, 1 : n - half + 1][:, ::-1]
    return np.concatenate([cos, sin], axis=0) / n


def split_backward_matrix(n: int) -> np.ndarray:
    """(n x 2m) real synthesis matrix B with ``v = B @ [Re(c); Im(c)]``
    (inverse of :func:`split_forward_matrix`; mode weights 1/2/1 for
    k = 0 / interior / Nyquist-of-even-n), bottom row half
    mirror-constructed."""
    m = n // 2 + 1
    half = n // 2 + 1
    j = np.arange(half)[:, None]
    k = np.arange(m)[None, :]
    ang = 2.0 * np.pi * j * k / n
    w = np.full(m, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    cos_t = w * np.cos(ang)
    sin_t = -w * np.sin(ang)
    if n % 2 == 0:
        sin_t[:, m - 1] = 0.0  # Nyquist mode: sin(pi*j) = 0 exactly
        sin_t[half - 1, :] = 0.0  # self-mirror row j = n/2: sin(pi*k) = 0
    B = np.empty((n, 2 * m))
    B[:half] = np.concatenate([cos_t, sin_t], axis=1)
    B[half:] = np.concatenate([cos_t, -sin_t], axis=1)[1 : n - half + 1][::-1]
    return B


def split_diff_matrix(n: int, order: int) -> np.ndarray:
    """(2m x 2m) real matrix of ``(ik)^order`` on the split Re/Im blocks:
    ``i^order`` cycles (re, im) through the four quadrants, times
    ``k^order``; the Nyquist mode of odd derivatives is zeroed as in
    :func:`diff_diag`."""
    m = n // 2 + 1
    k = wavenumbers_r2c(n) ** order
    if order % 2 == 1 and n % 2 == 0:
        k = k.copy()
        k[-1] = 0.0
    K = np.diag(k)
    Z = np.zeros((m, m))
    quadrant = order % 4
    if quadrant == 0:
        blocks = [[K, Z], [Z, K]]
    elif quadrant == 1:
        blocks = [[Z, -K], [K, Z]]
    elif quadrant == 2:
        blocks = [[-K, Z], [Z, -K]]
    else:
        blocks = [[Z, K], [-K, Z]]
    return np.block(blocks)


def diff_diag(k: np.ndarray, order: int, n: int, r2c: bool) -> np.ndarray:
    """Diagonal of (d/dx)^order in spectral space: (i k)^order.  The Nyquist
    mode of an even-length transform cannot represent odd derivatives of a
    real signal; it is zeroed for odd orders."""
    d = (1j * k) ** order
    if order % 2 == 1 and n % 2 == 0:
        d = d.copy()
        if r2c:
            d[-1] = 0.0
        else:
            d[n // 2] = 0.0
    return d

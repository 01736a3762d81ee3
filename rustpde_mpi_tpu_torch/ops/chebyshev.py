"""Host-side (numpy, f64) operator builders for Chebyshev bases.

A copy of the JAX package's ``ops/chebyshev.py`` host math, so the port
imports nothing of that package.  Everything here runs once at model-build
time on the host; the matrices go to the device as constants.

Conventions:

* Grid: Chebyshev-Gauss-Lobatto points in ascending order,
  ``x_j = -cos(pi j / (n-1))`` so ``x[0] = -1`` (bottom) and ``x[-1] = +1``
  (top).
* Spectral coefficients are genuine Chebyshev coefficients: ``u(x) = sum_k
  uhat_k T_k(x)``.  Because the points ascend, the DCT-I picks up a
  ``(-1)^k`` diagonal relative to the classic descending-point transform;
  that diagonal is folded into the transform, never into operators.
"""

from __future__ import annotations

import numpy as np

# ----------------------------------------------------------------------------
# grid + transform matrices
# ----------------------------------------------------------------------------


def cgl_points(n: int) -> np.ndarray:
    """Ascending Chebyshev–Gauss–Lobatto points on [-1, 1]."""
    if n < 2:
        raise ValueError("need at least 2 points")
    return -np.cos(np.pi * np.arange(n) / (n - 1))


def synthesis_matrix(n: int) -> np.ndarray:
    """B[j, k] = T_k(x_j) at ascending CGL points (backward transform).

    The bottom half is mirror-constructed from the top via the exact identity
    ``B[N-j, k] = (-1)^k B[j, k]`` so the reflection symmetry holds to the
    *bit* (the same matrix the JAX package builds, entry for entry)."""
    N = n - 1
    half = N // 2 + 1
    j = np.arange(half)[:, None]
    k = np.arange(n)[None, :]
    # T_k(-cos t) = (-1)^k cos(k t)
    sgn = (-1.0) ** k
    top = sgn * np.cos(np.pi * k * j / N)
    if N % 2 == 0:
        # self-mirror row j = N/2: odd-k entries are cos(pi*k/2) = 0 exactly,
        # but evaluate to ~1e-13 argument-rounding garbage at large k
        top[N // 2, 1::2] = 0.0
    B = np.empty((n, n))
    B[:half] = top
    B[half:] = (sgn * top[: n - half])[::-1]
    return B


def analysis_matrix(n: int) -> np.ndarray:
    """F such that ``uhat = F @ u`` (forward transform), exact inverse of
    :func:`synthesis_matrix` via DCT-I orthogonality (no matrix inversion).
    Right half mirror-constructed from the exact identity
    ``F[k, N-j] = (-1)^k F[k, j]``; for even N the bottom row half is also
    mirror-constructed from ``F[N-k, j] = (-1)^j F[k, j]`` (sigma and the
    column weights are reflection-symmetric), so F carries BOTH reflection
    structures bit-exactly."""
    N = n - 1
    half = N // 2 + 1
    if N % 2 == 0:
        # quarter construction: rows k=0..N/2, cols j=0..N/2
        k = np.arange(half)[:, None]
        j = np.arange(half)[None, :]
        sgnk = (-1.0) ** k
        q = sgnk * np.cos(np.pi * k * j / N)
        q[1::2, N // 2] = 0.0  # cos(pi*k/2) = 0 exactly for odd k
        q[N // 2, 1::2] = 0.0  # cos(pi*j/2) = 0 exactly for odd j
        top = np.empty((half, n))
        top[:, :half] = q
        top[:, half:] = (sgnk * q[:, : n - half])[:, ::-1]
        F = np.empty((n, n))
        F[:half] = top
        sgnj = (-1.0) ** np.arange(n)[None, :]
        F[half:] = (sgnj * top[: n - half])[::-1]
    else:
        j = np.arange(half)[None, :]
        k = np.arange(n)[:, None]
        sgn = (-1.0) ** k
        left = sgn * np.cos(np.pi * k * j / N)
        F = np.empty((n, n))
        F[:, :half] = left
        F[:, half:] = (sgn * left[:, : n - half])[:, ::-1]
    F[:, 1:-1] *= 2.0
    sigma = np.full(n, 1.0 / N)
    sigma[0] = sigma[-1] = 1.0 / (2.0 * N)
    return sigma[:, None] * F


def diff_matrix(n: int, order: int = 1) -> np.ndarray:
    """Differentiation in coefficient space: ``(d/dx)^order`` as an
    upper-triangular n x n matrix acting on Chebyshev coefficients.

    Uses T'_p = 2p * sum_{k < p, p-k odd} T_k / ctilde_k  (ctilde_0 = 2).
    """
    D = np.zeros((n, n))
    for p in range(1, n):
        for k in range(p - 1, -1, -2):
            D[k, p] = 2.0 * p
    D[0, :] *= 0.5
    out = np.eye(n)
    for _ in range(order):
        out = D @ out
    return out


# ----------------------------------------------------------------------------
# quasi-inverse of D2 ("laplace_inv" in funspace terms)
# ----------------------------------------------------------------------------


def quasi_inverse_b2(n: int) -> np.ndarray:
    """Banded pseudo-inverse B2 of the second-derivative operator D2.

    Rows 0,1 are zero; row k >= 2 has entries at columns k-2, k, k+2 chosen so
    that ``(B2 @ D2)[k, :] = e_k`` for all k >= 2 (``laplace_inv_eye``).

    Classic closed form (ctilde_0 = 2, else 1):
        B2[k, k-2] = ctilde_{k-2} / (4 k (k-1))
        B2[k, k]   = -1 / (2 (k^2 - 1))
        B2[k, k+2] = 1 / (4 k (k+1))

    Columns n-2 and n-1 are zeroed: they would multiply second-derivative
    modes that a degree-(n-1) polynomial cannot have (rows n-2, n-1 of D2 are
    zero, so the ``laplace_inv_eye`` identity is unaffected).  This matches
    the funspace/pypde convention — and it makes the
    B2-preconditioned eigenpencil exactly real-diagonalizable for every
    composite Chebyshev base (with the untruncated B2 the Neumann pencil has
    complex pairs, which the reference's utils::eig would silently drop).
    """
    B2 = np.zeros((n, n))
    for k in range(2, n):
        ct = 2.0 if k - 2 == 0 else 1.0
        B2[k, k - 2] = ct / (4.0 * k * (k - 1.0))
        B2[k, k] = -1.0 / (2.0 * (k * k - 1.0))
        if k + 2 < n:
            B2[k, k + 2] = 1.0 / (4.0 * k * (k + 1.0))
    B2[:, n - 2 :] = 0.0
    return B2


def restricted_eye(n: int) -> np.ndarray:
    """(n-2) x n matrix selecting rows 2..n ('laplace_inv_eye' restricted)."""
    return np.eye(n)[2:, :]


# ----------------------------------------------------------------------------
# composite (Galerkin) bases: stencil matrices S, n x (n-2)
# u_ortho = S @ u_composite
# ----------------------------------------------------------------------------


def stencil_chebyshev(n: int) -> np.ndarray:
    """Orthogonal base: identity stencil."""
    return np.eye(n)


def stencil_dirichlet(n: int) -> np.ndarray:
    """phi_k = T_k - T_{k+2};  u(-1) = u(1) = 0."""
    m = n - 2
    S = np.zeros((n, m))
    for k in range(m):
        S[k, k] = 1.0
        S[k + 2, k] = -1.0
    return S


def stencil_neumann(n: int) -> np.ndarray:
    """phi_k = T_k - (k/(k+2))^2 T_{k+2};  u'(-1) = u'(1) = 0."""
    m = n - 2
    S = np.zeros((n, m))
    for k in range(m):
        S[k, k] = 1.0
        S[k + 2, k] = -((k / (k + 2.0)) ** 2)
    return S


def stencil_dirichlet_neumann(n: int) -> np.ndarray:
    """phi_k = T_k + a_k T_{k+1} + b_k T_{k+2};  u(-1) = 0, u'(1) = 0.

    Solving phi_k(-1) = 0 and phi_k'(1) = 0 with T_k(-1) = (-1)^k and
    T_k'(1) = k^2 gives
        b_k = -(k^2 + (k+1)^2) / ((k+1)^2 + (k+2)^2),   a_k = 1 + b_k.
    (Leads to a 7-diagonal Helmholtz system.)
    """
    m = n - 2
    S = np.zeros((n, m))
    for k in range(m):
        b = -(k**2 + (k + 1.0) ** 2) / ((k + 1.0) ** 2 + (k + 2.0) ** 2)
        a = 1.0 + b
        S[k, k] = 1.0
        S[k + 1, k] += a
        S[k + 2, k] += b
    return S


def cheb_weights(n: int) -> np.ndarray:
    """Diagonal of the T-space inner-product Gram matrix, up to the constant
    pi/2 (which cancels in every projection built from it): diag(ctilde)."""
    w = np.ones(n)
    w[0] = 2.0
    return w


def projection_matrix(S: np.ndarray) -> np.ndarray:
    """P with ``u_composite = P @ u_ortho``: the weighted Galerkin projection
    (S^T W S)^{-1} S^T W  (funspace's `from_ortho`)."""
    n = S.shape[0]
    W = np.diag(cheb_weights(n))
    G = S.T @ W @ S
    return np.linalg.solve(G, S.T @ W)

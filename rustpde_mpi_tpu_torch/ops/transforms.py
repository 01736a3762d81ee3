"""Spectral transforms on ``torch.fft`` (cuFFT on the card), and the matrix
and diagonal applications along one axis.

Counterpart of the JAX package's ``ops/transforms.py``:

* the Chebyshev transform as a DCT-I realised through the rfft of the even
  extension (:func:`cheb_forward_fft`, :func:`cheb_backward_fft`);
* the Fourier r2c and c2c transforms with the amplitude normalisation
  (forward divided by n, backward multiplied by it);
* :func:`cheb_derivative`, the O(n) parity-split cumulative-sum recurrence
  of the Chebyshev coefficient derivative;
* :func:`apply_along` (the JAX package's ``apply_matrix``) and
  :func:`apply_diag`.

Every function works along ``axis`` of a tensor with any other dims.  A
real operator applied to a complex tensor runs on its real and imaginary
parts as one real product (:func:`apply_along` views them as a leading
dim of two), so no complex copy of a real matrix is made.
"""

from __future__ import annotations

import numpy as np
import torch


def _move(a, axis):
    return torch.movedim(a, axis, -1)


def _unmove(a, axis):
    return torch.movedim(a, -1, axis)


#: device copies of the transforms' constant vectors, by (name, n, dtype,
#: device): made at the first call, so a later call (one captured in a
#: CUDA graph) copies nothing from the host
_CONSTS: dict = {}


def _real_const(name: str, n: int, like) -> torch.Tensor:
    """The constant vector ``name`` of length ``n`` (:func:`_host_const`)
    in ``like``'s real dtype on its device."""
    dtype = like.real.dtype if like.is_complex() else like.dtype
    key = (name, n, dtype, like.device)
    out = _CONSTS.get(key)
    if out is None:
        out = torch.as_tensor(_host_const(name, n), dtype=dtype, device=like.device)
        _CONSTS[key] = out
    return out


def _host_const(name: str, n: int) -> np.ndarray:
    N = n - 1
    if name == "sigma":  # the DCT-I analysis weights
        sigma = np.full(n, 1.0 / N)
        sigma[0] = sigma[-1] = 1.0 / (2.0 * N)
        return sigma
    if name == "synth":  # the DCT-I synthesis weights
        return np.concatenate([[2.0 * N], np.full(n - 2, float(N)), [2.0 * N]])
    if name == "signs":
        return (-1.0) ** np.arange(n)
    if name == "index":
        return np.arange(n, dtype=np.float64)
    raise ValueError(name)


# -- DCT-I (Chebyshev at ascending CGL points) --------------------------------------


def _dct1_real(u):
    """DCT-I along the last axis of a real tensor: ``c`` with ``u_j = sum_k
    c_k cos(pi j k / N)``, N = n-1."""
    n = u.shape[-1]
    ext = torch.cat([u, torch.flip(u[..., 1:-1], (-1,))], dim=-1)  # even extension, 2N
    R = torch.fft.rfft(ext, dim=-1).real  # N+1 values
    return R * _real_const("sigma", n, R)


def _idct1_real(c):
    """Inverse of :func:`_dct1_real` (synthesis) along the last axis."""
    n = c.shape[-1]
    N = n - 1
    H = c * _real_const("synth", n, c)
    v = torch.fft.irfft(H.to(torch.complex128 if c.dtype == torch.float64 else torch.complex64),
                        n=2 * N, dim=-1)
    return v[..., :n]


def _complex_map(fn, a):
    if a.is_complex():
        return torch.complex(fn(a.real), fn(a.imag))
    return fn(a)


def cheb_forward_fft(u, axis: int):
    """Physical values at ascending CGL points -> Chebyshev coefficients."""
    x = _move(u, axis)
    c = _complex_map(_dct1_real, x)
    signs = _real_const("signs", x.shape[-1], c)
    return _unmove(c * signs, axis)


def cheb_backward_fft(uh, axis: int):
    """Chebyshev coefficients -> physical values at ascending CGL points."""
    x = _move(uh, axis)
    signs = _real_const("signs", x.shape[-1], x)
    return _unmove(_complex_map(_idct1_real, x * signs), axis)


# -- Fourier r2c / c2c ----------------------------------------------------------------


def fourier_r2c_forward_fft(u, axis: int):
    return torch.fft.rfft(u, dim=axis) / u.shape[axis]


def fourier_r2c_backward_fft(uh, axis: int, n: int):
    return torch.fft.irfft(uh * n, n=n, dim=axis)


def fourier_c2c_forward_fft(u, axis: int):
    return torch.fft.fft(u, dim=axis) / u.shape[axis]


def fourier_c2c_backward_fft(uh, axis: int, n: int):
    return torch.fft.ifft(uh * n, dim=axis)


# -- Chebyshev coefficient-space derivative via parity-split reversed cumsums ---------


def _interleave0(even, odd, n: int):
    """Rows 0, 2, 4, .. from ``even`` and 1, 3, 5, .. from ``odd`` along
    dim 0."""
    batch = tuple(even.shape[1:])
    if n % 2 == 0:
        return torch.stack([even, odd], dim=1).reshape((n,) + batch)
    h_o = odd.shape[0]
    body = torch.stack([even[:h_o], odd], dim=1).reshape((2 * h_o,) + batch)
    return torch.cat([body, even[h_o:]], dim=0)


def _rev_cumsum(w):
    """``out[t] = sum_{t' >= t} w[t']`` along dim 0."""
    return torch.flip(torch.cumsum(torch.flip(w, (0,)), dim=0), (0,))


def cheb_derivative(c, order: int, axis: int):
    """(d/dx)^order on Chebyshev coefficients via the coefficient recurrence,
    O(n) work a lane instead of the O(n^2) upper-triangular product: the
    dense operator is ``(Dc)_k = 2 * sum_{p>k, p-k odd} p c_p`` (halved at
    k=0), two parity-split reversed cumulative sums of ``p * c_p`` (the same
    reduction as the product, reassociated)."""
    x = torch.movedim(c, axis, 0)
    n = x.shape[0]
    j = _real_const("index", n, x).reshape((n,) + (1,) * (x.ndim - 1))
    ne, no = (n + 1) // 2, n // 2
    for _ in range(order):
        w = x * j
        rev_e = _rev_cumsum(w[0::2])  # sum_{p even >= k}
        rev_o = _rev_cumsum(w[1::2])  # sum_{p odd >= k}
        # even outputs k=2t: odd p > k  <->  odd-index t' >= t
        out_e = 2.0 * rev_o
        if ne > no:  # odd n: the top even mode has an empty sum
            out_e = torch.cat([out_e, torch.zeros_like(out_e[:1])], dim=0)
        # odd outputs k=2t+1: even p > k  <->  even-index t' >= t+1
        out_o = 2.0 * rev_e[1:]
        if no > ne - 1:  # even n: the top odd mode has an empty sum
            out_o = torch.cat([out_o, torch.zeros_like(out_o[:1])], dim=0)
        x = _interleave0(out_e, out_o, n)
        x = torch.cat([0.5 * x[:1], x[1:]], dim=0)
    return torch.movedim(x, 0, axis)


# -- matrix and diagonal applications -------------------------------------------------


def apply_along(mat: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """``mat`` applied along ``axis`` of ``x``: ``x`` contracted with the
    columns of ``mat`` there (one ``torch.matmul``).  A complex ``x`` with a
    real ``mat`` runs as one real product on ``x``'s real and imaginary
    parts, a leading dim of two of its real view."""
    axis %= x.ndim
    if x.is_complex() and not mat.is_complex():
        parts = torch.view_as_real(x).movedim(-1, 0)
        out = apply_along(mat, parts, axis + 1)
        return torch.view_as_complex(out.movedim(0, -1).contiguous())
    if axis == x.ndim - 1:
        return torch.matmul(x, mat.T)
    return torch.movedim(torch.matmul(mat, torch.movedim(x, axis, -2)), -2, axis)


def apply_diag(d: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x`` times the diagonal ``d`` along ``axis``."""
    shape = [1] * x.ndim
    shape[axis] = d.shape[0]
    return x * d.reshape(shape)

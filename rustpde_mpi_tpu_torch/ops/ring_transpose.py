"""The x <-> y pencil transpose of a rank-stacked field, on a CUDA kernel.

Counterpart of the JAX package's ``parallel/decomp.py``
``_ring_transpose_kernel`` (the Pallas TPU kernel) and of its off-TPU form
``_ring_transpose_ppermute``.  A mesh of ``P`` ranks on one device holds a
field as one tensor with the rank as its leading dimension
(:mod:`..parallel.mesh`):

* x-pencil ``(P, P*c, w)``: rank ``s`` holds columns ``s*w ..`` of the
  padded ``(P*c, P*w)`` field;
* y-pencil ``(P, c, P*w)``: rank ``r`` holds rows ``r*c ..``;

and the flip is ``y[r, i, s*w + j] = x[s, r*c + i, j]`` (x -> y) or its
inverse.  A pencil may carry a leading member dim, ``(K, P, ...)``: the
pencils of an ensemble's K members, all flipped by one launch (the JAX
package's ``jax.vmap`` of the flip).  On a CUDA tensor :meth:`RingTranspose.apply` launches the
hand-written kernel of ``csrc/ring_transpose.cu`` once and adds one to
``RingTranspose.launches``; on a CPU tensor it runs
:meth:`RingTranspose.plain`, the ring schedule of the JAX package in torch
indexing: the diagonal copy, then P-1 shift steps in which every rank sends
the chunk meant for the rank ``shift`` ahead.  Any other device raises.

The flip is a permutation, so its adjoint is the inverse flip: autograd
sees it as :class:`FlipFn`, whose backward is the same call with the
direction reversed (one more launch on the card, ``backward_launches``).

The kernel moves the launch's elements as one flat range in words of 16, 8
or 4 bytes (:func:`word_bytes`, the widest the row width, the strides and
the base pointers allow) and splits a flat index into its row and column,
and a row into its chunk and row in the chunk, by a multiply-high with the
magic constants of :func:`fast_divmod`, computed here for each launch.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import _build

#: the kernel's entry point for each dtype it moves: a complex element (a
#: periodic cell's spectral pencil) is the unit of the permutation
ENTRY = {torch.float64: "rp_ring_transpose_f64", torch.float32: "rp_ring_transpose_f32",
         torch.complex128: "rp_ring_transpose_c128", torch.complex64: "rp_ring_transpose_c64"}


@lru_cache(maxsize=None)
def fast_divmod(d: int) -> tuple[int, int]:
    """The magic pair ``(mul, shr)`` of the divisor ``d`` (CUTLASS's
    ``FastDivmod``): ``n // d == (n * mul) >> (32 + shr)`` for every ``0 <=
    n < 2**31``, ``mul`` a 32-bit unsigned; ``(0, 0)`` for ``d == 1``, which
    the kernel passes through undivided."""
    if not 1 <= d < 2**31:
        raise ValueError(f"fast_divmod: divisor {d} out of range")
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()  # 31 + ceil(log2 d)
    return -(-(1 << p) // d), p - 32


def word_bytes(itemsize: int, w: int, strides, pointers) -> int:
    """The copy width of a launch: the widest word of 16, 8 or 4 bytes, at
    least one element, that divides the row's ``w`` elements, every element
    stride in ``strides`` and both base ``pointers`` (bytes)."""
    for word in (16, 8, 4):
        if word < itemsize:
            break
        nv = word // itemsize
        if w % nv == 0 and all(st % nv == 0 for st in strides) and \
                all(ptr % word == 0 for ptr in pointers):
            return word
    return itemsize


def pencil_strides(t) -> tuple[int, int]:
    """The rank and row strides of a pencil ``([K,] P, rows, cols)`` as the
    kernel reads them: a dim of extent 1 (one rank, one row) gets the
    stride a dense one would have, since the kernel never steps along it
    and PyTorch leaves its stride arbitrary (a ``.contiguous()`` tensor
    keeps whatever stride its view had there)."""
    row = t.stride(-2) if t.shape[-2] > 1 else t.shape[-1]
    rank = t.stride(-3) if t.shape[-3] > 1 else t.shape[-2] * row
    return rank, row


def transposed_shape(shape, nranks: int, x_to_y: bool) -> tuple:
    """The pencil shape a flip of a ``shape`` pencil (a member dim, if any,
    in front) gives."""
    *lead, p, a, b = shape
    if x_to_y:
        return (*lead, p, a // nranks, b * nranks)
    return (*lead, p, a * nranks, b // nranks)


class RingTranspose:
    """The pencil flip of one mesh: ``nranks`` ranks on ``device``, any
    pencil extents, float64, float32, complex128 or complex64."""

    def __init__(self, nranks: int, device):
        self.nranks = int(nranks)
        self.device = torch.device(device)
        #: kernel launches on CUDA tensors, forward and backward flips alike
        self.launches = 0
        #: of those, the launches of backward passes (:class:`FlipFn`)
        self.backward_launches = 0

    def _check(self, block, x_to_y: bool) -> None:
        if block.device != self.device:
            raise ValueError(f"pencil transpose input on {block.device}, the mesh is on "
                             f"{self.device}")
        if block.dtype not in ENTRY:
            raise ValueError(f"pencil transpose input of dtype {block.dtype}: the kernel moves "
                             f"{', '.join(map(str, ENTRY))}")
        split = -2 if x_to_y else -1
        if block.ndim not in (3, 4) or block.shape[-3] != self.nranks or \
                block.shape[split] % self.nranks:
            want = "([K,] P, P*c, w)" if x_to_y else "([K,] P, c, P*w)"
            raise ValueError(f"pencil transpose input: shape {tuple(block.shape)}, expected "
                             f"{want} with P = {self.nranks}")

    def x_to_y(self, block) -> torch.Tensor:
        """x-pencil ``(P, P*c, w)`` -> y-pencil ``(P, c, P*w)``."""
        return self.apply(block, True)

    def y_to_x(self, block) -> torch.Tensor:
        """y-pencil ``(P, c, P*w)`` -> x-pencil ``(P, P*c, w)``."""
        return self.apply(block, False)

    def apply(self, block, x_to_y: bool) -> torch.Tensor:
        """The flip of ``block``: the CUDA kernel on a CUDA device, the
        plain ring on the CPU; differentiable through :class:`FlipFn` (an
        input that needs no gradient records nothing)."""
        return FlipFn.apply(block, self, bool(x_to_y))

    def flip(self, block, x_to_y: bool) -> torch.Tensor:
        """The flip of ``block`` outside autograd."""
        self._check(block, x_to_y)
        if self.device.type == "cpu":
            return self.plain(block, x_to_y)
        if self.device.type != "cuda":
            raise RuntimeError(f"no pencil-transpose kernel for device {self.device}")
        out = self._launch(block, x_to_y)
        self.launches += 1
        return out

    def plain(self, block, x_to_y: bool) -> torch.Tensor:
        """The ring in plain PyTorch: at shift ``t`` (0 the diagonal copy)
        every rank ``d`` sends its chunk for rank ``(d + t) % P``, which
        stores it at slot ``d`` (every member's chunk at once).  Every
        element of the output is written once, so it starts empty."""
        p = self.nranks
        out = torch.empty(transposed_shape(block.shape, p, x_to_y), device=block.device,
                          dtype=block.dtype)
        k = block.shape[0] if block.ndim == 4 else 1
        # xv[s, r] is chunk (s, r) in the x layout, yv[r, :, s] in the y
        # layout, each with the members behind the rank indices
        if x_to_y:
            c, w = block.shape[-2] // p, block.shape[-1]
            xv, yv = block.reshape(k, p, p, c, w), out.view(k, p, c, p, w)
        else:
            c, w = block.shape[-2], block.shape[-1] // p
            xv, yv = out.view(k, p, p, c, w), block.reshape(k, p, c, p, w)
        xv, yv = xv.permute(1, 2, 3, 0, 4), yv.permute(1, 2, 3, 0, 4)  # (P, P, c, K, w)
        ranks = torch.arange(p, device=block.device)
        for shift in range(p):
            peer = (ranks + shift) % p
            if x_to_y:
                yv[peer, :, ranks] = xv[ranks, peer]
            else:
                xv[peer, ranks] = yv[ranks, :, peer]
        return out

    def bytes_moved(self, block) -> float:
        """Bytes a flip of ``block`` must move: read once, written once."""
        return 2.0 * block.numel() * block.element_size()

    def _launch(self, block, x_to_y: bool) -> torch.Tensor:
        if block.stride(-1) != 1:
            raise ValueError("the pencil-transpose kernel needs a unit stride along the "
                             "last axis")
        lib = _build.load("ring_transpose")
        fn = getattr(lib, ENTRY[block.dtype])
        p = self.nranks
        out = torch.empty(transposed_shape(block.shape, p, x_to_y), device=block.device,
                          dtype=block.dtype)
        xp, yp = (block, out) if x_to_y else (out, block)
        c, w = yp.shape[-2], xp.shape[-1]
        k = block.shape[0] if block.ndim == 4 else 1
        ms = (xp.stride(0), yp.stride(0)) if block.ndim == 4 and k > 1 else (0, 0)
        strides = pencil_strides(xp) + pencil_strides(yp)
        word = word_bytes(block.element_size(), w, strides + ms,
                          (block.data_ptr(), out.data_ptr()))
        divs = fast_divmod(w // (word // block.element_size())) + fast_divmod(c)
        _build.call(fn, self.device, p, c, w, *strides, block.data_ptr(), out.data_ptr(),
                    int(x_to_y), k, *ms, word, *divs)
        return out


class FlipFn(torch.autograd.Function):
    """The pencil flip as autograd sees it: the forward is
    :meth:`RingTranspose.flip`, the backward the inverse flip of the
    cotangent through the same call (the kernel on the card, the plain
    ring on the CPU).  A permutation's adjoint is its inverse, for real
    and complex pencils alike."""

    @staticmethod
    def forward(ctx, block, ring, x_to_y):
        ctx.flip = (ring, x_to_y)
        return ring.flip(block, x_to_y)

    @staticmethod
    def backward(ctx, g):
        ring, x_to_y = ctx.flip
        out = ring.flip(g.contiguous(), not x_to_y)
        if g.device.type == "cuda":
            ring.backward_launches += 1
        return out, None, None

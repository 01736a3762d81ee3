"""PyTorch port: the pencil flip's launch arithmetic, on the CPU.

The flip kernel (``csrc/ring_transpose.cu``) moves a launch's elements as
one flat range of words and splits a flat index into (row, word) and a row
into (chunk, row in chunk) by multiply-highs with magic constants that its
wrapper computes (``ops/ring_transpose.py::fast_divmod``); the copy width
is the wrapper's too (``word_bytes``).  The kernel runs only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``), so these tests hold the
wrapper's side exactly: the constants give ``n // d`` for every index the
kernel divides at the pencil shapes of the ``rbc1025``, ``periodic1024``,
``ensemble129`` (K = 32) and ``rbc1025`` K = 2 cells and of the 17^2 test
meshes, and the arguments a launch passes.
"""

import numpy as np
import pytest
import torch

from rustpde_mpi_tpu_torch.ops import _build
from rustpde_mpi_tpu_torch.ops import ring_transpose as rt
from rustpde_mpi_tpu_torch.parallel.mesh import padded

#: ``(ranks, K members, axis-0 extents, axis-1 extents)`` of each cell's
#: flips: a pencil of a step flips some pair of the cell's padded extents
#: (physical, composite; the periodic cell's Fourier modes); every pair is
#: taken
CELLS = {
    "rbc1025": (4, 1, (1025, 1023), (1025, 1023)),
    "rbc1025_K2": (4, 2, (1025, 1023), (1025, 1023)),
    "periodic1024": (4, 1, (1024, 513), (1025, 1023)),
    "ensemble129_K32": (4, 32, (129, 127), (129, 127)),
    "mesh17_4": (4, 1, (17, 15), (17, 15)),
    "mesh17_2": (2, 1, (17, 15), (17, 15)),
}


def _quotients(n, d):
    """The kernel's quotients of ``n`` (uint64 array) by ``d``."""
    mul, shr = rt.fast_divmod(d)
    if d == 1:
        return n
    return (n * np.uint64(mul)) >> np.uint64(32 + shr)


def _launches(cell):
    """``(K, c, words a row)`` of every launch of ``cell``: each pair of
    padded extents, and each copy width that divides the row (a word of 1,
    2 or 4 elements)."""
    p, k, ext0, ext1 = CELLS[cell]
    out = set()
    for n0 in ext0:
        for n1 in ext1:
            c, w = padded(n0, p) // p, padded(n1, p) // p
            out.update((k, p, c, w // nv) for nv in (1, 2, 4) if w % nv == 0)
    return sorted(out)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fast_divmod_exact_over_each_launch_range(cell):
    """Every flat index of a launch divided by the row's words, and every
    row index by the chunk's rows: the kernel's multiply-high equals the
    integer quotient for all of them."""
    for k, p, c, wv in _launches(cell):
        n = k * p * p * c * wv
        g = np.arange(n, dtype=np.uint64)
        q = _quotients(g, wv)
        np.testing.assert_array_equal(q, g // np.uint64(wv), err_msg=f"{cell} words {wv}")
        rows = np.arange(n // wv, dtype=np.uint64)
        np.testing.assert_array_equal(_quotients(rows, c), rows // np.uint64(c),
                                      err_msg=f"{cell} rows {c}")


@pytest.mark.parametrize("d", [1, 2, 3, 7, 32, 33, 255, 257, 1028, 2**16 + 1, 2**30, 2**31 - 1])
def test_fast_divmod_constants(d):
    """32-bit multipliers, exact at the ends of the kernel's index range
    ``[0, 2^31)``; the divisor 1 passes through; out of range raises."""
    mul, shr = rt.fast_divmod(d)
    assert 0 <= mul < 2**32 and 0 <= shr < 32
    n = np.concatenate([np.arange(0, 1 << 16), np.arange((1 << 31) - (1 << 16), 1 << 31),
                        np.arange(d - 2, d + 3).clip(0) * 5]).astype(np.uint64)
    n = n[n < 1 << 31]
    np.testing.assert_array_equal(_quotients(n, d), n // np.uint64(d))
    with pytest.raises(ValueError, match="out of range"):
        rt.fast_divmod(0)


@pytest.mark.parametrize("itemsize,w,strides,pointers,want", [
    (8, 256, (1024, 256, 256, 1024), (0, 4096), 16),  # rbc1025 spectral, f64
    (8, 257, (1028 * 257, 257, 257 * 1028, 1028), (0, 4096), 8),  # an odd row
    (8, 256, (1024, 256, 256, 1024), (8, 4096), 8),  # a base one element past 16 bytes
    (8, 256, (1024 * 257, 257, 256, 1024), (0, 4096), 8),  # an odd row stride
    (4, 6, (48, 6, 12, 24), (0, 64), 8),  # f32 pairs
    (4, 5, (40, 5, 10, 20), (0, 64), 4),
    (4, 8, (64, 8, 16, 32), (0, 64), 16),
    (16, 33, (33 * 132, 33, 33 * 132, 132), (0, 16), 16),  # complex128
])
def test_word_bytes(itemsize, w, strides, pointers, want):
    assert rt.word_bytes(itemsize, w, strides, pointers) == want


def test_launch_passes_the_word_and_the_divisors(monkeypatch):
    """The arguments of one launch: strides in elements, the copy width,
    and the magic pairs of the row's words and of the chunk's rows; a
    member-stacked pencil passes its member strides."""
    calls = []
    monkeypatch.setattr(_build, "load", lambda name: type("Lib", (), {
        e: staticmethod(lambda *a: 0) for e in rt.ENTRY.values()}))
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append(args))
    ring = rt.RingTranspose(4, "cpu")
    x = torch.zeros((2, 4, 4 * 33, 33), dtype=torch.float64)
    out = ring._launch(x, True)
    assert out.shape == (2, 4, 33, 132)
    (args,) = calls
    p, c, w, xs0, xs1, ys0, ys1, src, dst, x_to_y, k, xsm, ysm, word, *divs = args
    assert (p, c, w, x_to_y, k) == (4, 33, 33, 1, 2)
    assert (xs0, xs1, ys0, ys1, xsm, ysm) == (132 * 33, 33, 33 * 132, 132, 4 * 132 * 33,
                                               4 * 33 * 132)
    assert (src, dst) == (x.data_ptr(), out.data_ptr())
    assert word == 8 and divs == [*rt.fast_divmod(33), *rt.fast_divmod(33)]
    calls.clear()
    y = torch.zeros((4, 256, 1024), dtype=torch.float64)
    ring._launch(y, False)
    (args,) = calls
    assert args[9:] == (0, 1, 0, 0, 16, *rt.fast_divmod(128), *rt.fast_divmod(256))


def test_launch_strides_of_one_rank_and_one_row(monkeypatch):
    """A pencil of one rank, or of one row, passes the strides of a dense
    one there: PyTorch's stride of an extent-1 dim is arbitrary (the
    placement's ``.contiguous()`` keeps its view's), and the launch checks
    each stride against the extents."""
    from rustpde_mpi_tpu_torch.parallel import Decomp2d, make_mesh

    calls = []
    monkeypatch.setattr(_build, "load", lambda name: type("Lib", (), {
        e: staticmethod(lambda *a: 0) for e in rt.ENTRY.values()}))
    monkeypatch.setattr(_build, "call", lambda fn, device, *args: calls.append(args))
    x = Decomp2d((17, 9), make_mesh(1, "cpu")).place_x_pencil(np.ones((17, 9)))
    assert x.shape == (1, 17, 9) and x.stride(0) != 17 * 9  # the view's stride survives
    rt.RingTranspose(1, "cpu")._launch(x, True)
    assert calls[-1][3:7] == (17 * 9, 9, 17 * 9, 9)
    row = torch.zeros((4, 1, 8), dtype=torch.float64)[:, :, :]
    row = row.as_strided(row.shape, (8, 5, 1))  # a one-row y-pencil with an odd row stride
    rt.RingTranspose(4, "cpu")._launch(row, False)
    assert calls[-1][3:7] == (8, 2, 8, 8) and calls[-1][13] == 16


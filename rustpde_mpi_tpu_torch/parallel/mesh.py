"""Rank mesh and pencil layout of the port.

Counterpart of the JAX package's ``parallel/mesh.py``.  The reference's
pencil convention is kept:

* **physical** data in y-pencils: axis 0 (x) split over the ranks, ``PHYS``;
* **spectral** data in x-pencils: axis 1 (y) split over the ranks, ``SPEC``.

A :class:`Mesh` is ``P`` ranks on one device under one controller, as a
JAX ``Mesh`` is.  A field split over it is ONE tensor with the rank as its
leading dimension, its extents zero-padded up to a multiple of ``P`` (as
the JAX package's ``Decomp2d._pad``):

* x-pencil ``(P, n0p, n1p / P)``: rank ``r`` holds columns ``r * n1p/P ..``;
* y-pencil ``(P, n0p / P, n1p)``: rank ``r`` holds rows ``r * n0p/P ..``.

So a product along a rank's local axis is one batched ``torch.matmul`` for
all ranks.  A field of an ensemble's K members carries a member dim in
front of the rank, ``(K, P, ...)``: the pencil axes are addressed from the
end, so every function here takes it unchanged.  The JAX package pins these layouts with sharding constraints
and lets XLA insert the all-to-alls; PyTorch has no such compiler, so each
flip is explicit here: :func:`apply_separable` and :func:`forward_separable`
apply a 2-D separable operator with the flip between its two factors, and
every flip runs the pencil-transpose kernel of :mod:`..ops.ring_transpose`.
Pad rows and columns of every operator are zero, so pad entries never enter
a product and stay exactly zero.  A complex field (the periodic cell's
spectral state) is split and flipped the same way, a complex element the
unit.

A mesh may span the processes of one host (:func:`.multihost.global_pencil_mesh`):
``P`` ranks held by ``nproc`` processes joined in one group
(:func:`.multihost.initialize_distributed`), each process ``P / nproc``
consecutive ranks stacked as above on its own card (one card shared by all
of them, or one card a process).  A field then is each process's ranks'
blocks, ``(P / nproc, ...)``; ``nranks`` stays the global ``P``, which the
padding and the splits use, and ``nlocal``/``rank0`` name this process's
ranks.  Its flips go through the kernel's remote form
(:class:`..ops.ring_transpose.SpanningRing`) and its sums through the
ring's rank gather, in rank order, so a spanning mesh computes what the
one-process mesh of the same ``P`` computes, bit for bit.  One process's
ranks on distinct devices still raise: a card a process is the layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import transforms as tr
from ..ops.ring_transpose import RingTranspose, SpanningRing

AXIS = "p"

# pencil specs (the reference convention)
PHYS = (AXIS, None)  # y-pencil: x distributed
SPEC = (None, AXIS)  # x-pencil: y distributed


class Mesh:
    """``P`` ranks on one device, or spread over the processes of one
    group, each holding consecutive ranks on its own device.  ``devices``
    lists each rank's device: plain devices (``"cuda"``, a
    ``torch.device``) are this process's, all one device; a device that
    carries its ``process_index`` (a :class:`.multihost.HostDevice`) names
    its process.  ``ring`` is the mesh's pencil transpose (``ring.x_to_y``,
    ``ring.y_to_x``), with its launch counter.

    ``nranks`` is the mesh's rank count ``P``; ``nlocal`` the ranks of this
    process, ``rank0`` the first of them, and ``spanning`` whether other
    processes hold the rest."""

    def __init__(self, devices):
        devices = list(devices)
        if not devices:
            raise ValueError("a mesh needs at least one rank")
        me = _this_process()
        procs = [int(getattr(d, "process_index", me)) for d in devices]
        self.nproc = len(set(procs))
        self.spanning = set(procs) != {me}
        if self.spanning:
            nproc = _process_count()
            if sorted(set(procs)) != list(range(nproc)):
                raise NotImplementedError(
                    f"ranks in processes {sorted(set(procs))}: a mesh spans every process of "
                    f"its group (processes 0..{nproc - 1}, "
                    "multihost.initialize_distributed) and none outside it")
            counts = [procs.count(q) for q in range(nproc)]
            if procs != sorted(procs) or len(set(counts)) > 1:
                raise ValueError(f"a spanning mesh gives each process the same number of "
                                 f"consecutive ranks, got processes {procs}")
        mine = [d for d, q in zip(devices, procs) if q == me]
        devs = [torch.device(getattr(d, "device", d)) for d in mine]
        if len(set(devs)) > 1:
            raise NotImplementedError(
                f"ranks on distinct devices {sorted(set(map(str, devs)))} in one process: a "
                "process holds its ranks on one device (a card a process is a spanning mesh, "
                "multihost.global_pencil_mesh)")
        self.device = config.resolve_device(devs[0])
        self.nranks = len(devices)
        self.nlocal = len(mine)
        self.rank0 = procs.index(me)
        if self.spanning:
            self.ring = SpanningRing(self.nranks, self.device, self.nproc, me)
        else:
            self.ring = RingTranspose(self.nranks, self.device)

    def close(self) -> None:
        """Free a spanning mesh's receive slabs (collective, every process
        together; :meth:`..ops.ring_transpose.SpanningRing.close`); nothing
        to free on one process."""
        if self.spanning:
            self.ring.close()

    def __repr__(self):
        if self.spanning:
            return (f"Mesh({self.nranks} ranks over {self.nproc} processes, ranks "
                    f"{self.rank0}..{self.rank0 + self.nlocal - 1} on {self.device})")
        return f"Mesh({self.nranks} ranks on {self.device})"


def _this_process() -> int:
    from .multihost import process_index

    return process_index()


def _process_count() -> int:
    from .multihost import process_count

    return process_count()


def make_mesh(nranks: int, device=None) -> Mesh:
    """A mesh of ``nranks`` ranks on ``device`` (``"cuda"`` unless the
    caller names another; raises without a card)."""
    if nranks < 1:
        raise ValueError(f"a mesh needs at least one rank, got {nranks}")
    return Mesh([config.resolve_device(device)] * nranks)


def padded(n: int, nranks: int) -> int:
    """``n`` rounded up to a multiple of ``nranks``."""
    return n + (-n) % nranks


def pad_matrix(mat: np.ndarray, nranks: int) -> np.ndarray:
    """``mat`` with zero rows and columns appended up to multiples of
    ``nranks`` (the JAX package's ``pad_dense``)."""
    r, c = mat.shape
    return np.pad(np.asarray(mat), ((0, padded(r, nranks) - r), (0, padded(c, nranks) - c)))


def x_pencil_shape(shape, nranks: int) -> tuple[int, int, int]:
    """Stacked x-pencil shape of a global ``shape``."""
    n0p, n1p = (padded(n, nranks) for n in shape)
    return (nranks, n0p, n1p // nranks)


def y_pencil_shape(shape, nranks: int) -> tuple[int, int, int]:
    """Stacked y-pencil shape of a global ``shape``."""
    n0p, n1p = (padded(n, nranks) for n in shape)
    return (nranks, n0p // nranks, n1p)


def apply_axis(op, block: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis factor of a separable operator along ``dim`` of a pencil:
    None (the identity), a 1-D device tensor (a diagonal, as a Fourier
    derivative or Helmholtz factor is), a 2-D one (a matrix; a complex
    block under a real matrix runs as the serial port's real product,
    :func:`..ops.transforms.apply_along`), or a function of the block (an
    FFT along the axis that the pencil holds whole)."""
    if op is None:
        return block
    if not torch.is_tensor(op):
        return op(block)
    if op.ndim == 1:
        return tr.apply_diag(op, block, dim)
    return tr.apply_along(op, block, dim)


def apply_separable(mesh: Mesh, block: torch.Tensor, a0, a1, spectral_out: bool) -> torch.Tensor:
    """``A0 @ v @ A1^T`` of the x-pencil ``block``: ``a0`` on the x-pencil,
    the flip to the y-pencil, ``a1`` there, and the flip back only when the
    result is spectral (``spectral_out``); a physical result stays a
    y-pencil.  ``a0``/``a1`` are axis factors of :func:`apply_axis` (None:
    the identity); an identity ``a1`` with a spectral result needs no flip.
    The flip points are those of the JAX package's ``Space2`` transforms
    (``bases.py:905-1010``)."""
    out = apply_axis(a0, block, -2)
    if a1 is None and spectral_out:
        return out
    out = apply_axis(a1, mesh.ring.x_to_y(out), -1)
    return mesh.ring.y_to_x(out) if spectral_out else out


def forward_separable(mesh: Mesh, block: torch.Tensor, a0, a1) -> torch.Tensor:
    """``A0 @ v @ A1^T`` of the y-pencil ``block`` (physical data):
    ``a1`` on the y-pencil, the flip, ``a0`` on the x-pencil; the result is
    an x-pencil."""
    return apply_axis(a0, mesh.ring.y_to_x(apply_axis(a1, block, -1)), -2)

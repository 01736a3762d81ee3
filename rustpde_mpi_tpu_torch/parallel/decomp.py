"""Pencil bookkeeping, explicit repartitions and collectives.

Counterpart of the JAX package's ``parallel/decomp.py`` (its ``Decomp2d``,
``Pencil``, ``_split`` and the collectives ``all_gather_sum``,
``broadcast_scalar``, ``gather_root`` and ``scatter_root``).  A field split
over a :class:`..parallel.mesh.Mesh` is one stacked tensor with the rank as
its leading dimension (see that module); this module places global arrays
into that layout, takes them back out, and flips them, real fields and
complex ones (the periodic cell's spectral state) alike.

The JAX package names two schedules of one repartition, ``method="alltoall"``
and ``method="ring"``.  On one device under one controller the port has one
flip: the pencil-transpose kernel on a CUDA tensor, its plain ring version on
a CPU tensor.  So there is no ``method`` switch.

On a mesh whose ranks span processes (``mesh.spanning``) a stacked pencil
holds this process's ranks only: ``place_*`` gives their blocks of the
global array, ``gather_*`` assembles the global array from every process's
(a host collective), and the collectives gather each rank's partial
through the ring's :class:`..ops.ring_transpose.RankGather` and reduce in
rank order, as the one-process mesh does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mesh import Mesh, padded, x_pencil_shape, y_pencil_shape


@dataclass(frozen=True)
class Pencil:
    """One rank's slab of one pencil orientation (the reference's
    ``Decomp2d`` pencils expose st/en/sz)."""

    st: tuple[int, int]  # global start index per axis (inclusive)
    en: tuple[int, int]  # global end index per axis (inclusive)
    sz: tuple[int, int]  # local shape
    dist_axis: int  # which axis is distributed

    @property
    def axis_contig(self) -> int:
        """The undivided axis."""
        return 1 - self.dist_axis


def _split(n: int, nprocs: int, rank: int) -> tuple[int, int]:
    """Balanced contiguous split: the first ``n % nprocs`` ranks get one
    extra."""
    base, extra = divmod(n, nprocs)
    st = rank * base + min(rank, extra)
    sz = base + (1 if rank < extra else 0)
    return st, sz


class Decomp2d:
    """Pencil bookkeeping and explicit repartitions of a ``global_shape``
    field over ``mesh``.

    ``x_pencil(rank)`` / ``y_pencil(rank)`` give each rank's slab of the
    balanced split, as the reference's decomp object does.  The stacked
    layout the port computes on pads both extents to multiples of the rank
    count instead (``padded_shape``); ``place_*`` and ``gather_*`` move a
    global array into and out of it, and ``transpose_x_to_y`` /
    ``transpose_y_to_x`` repartition a global array through one flip."""

    def __init__(self, global_shape: tuple[int, int], mesh: Mesh):
        self.mesh = mesh
        self.nprocs = mesh.nranks
        self.global_shape = tuple(global_shape)
        self.padded_shape = tuple(padded(n, self.nprocs) for n in self.global_shape)

    # -- bookkeeping ---------------------------------------------------------

    def _pencil(self, rank: int, dist_axis: int) -> Pencil:
        n0, n1 = self.global_shape
        if dist_axis == 0:
            st0, sz0 = _split(n0, self.nprocs, rank)
            return Pencil((st0, 0), (st0 + sz0 - 1, n1 - 1), (sz0, n1), 0)
        st1, sz1 = _split(n1, self.nprocs, rank)
        return Pencil((0, st1), (n0 - 1, st1 + sz1 - 1), (n0, sz1), 1)

    def y_pencil(self, rank: int) -> Pencil:
        """Axis 0 distributed (physical-data layout)."""
        return self._pencil(rank, 0)

    def x_pencil(self, rank: int) -> Pencil:
        """Axis 1 distributed (spectral-data layout)."""
        return self._pencil(rank, 1)

    # -- placement -----------------------------------------------------------

    def _padded(self, arr, dtype) -> torch.Tensor:
        """The global array zero-padded to ``padded_shape`` on the mesh's
        device."""
        a = arr if torch.is_tensor(arr) else torch.from_numpy(np.array(arr))
        if tuple(a.shape) != self.global_shape:
            raise ValueError(f"global array of shape {tuple(a.shape)}, expected "
                             f"{self.global_shape}")
        out = torch.zeros(self.padded_shape, device=self.mesh.device,
                          dtype=dtype if dtype is not None else a.dtype)
        out[: self.global_shape[0], : self.global_shape[1]] = a
        return out

    def _local(self, stacked: torch.Tensor) -> torch.Tensor:
        """This process's ranks of a stacked pencil of every rank."""
        mesh = self.mesh
        if not mesh.spanning:
            return stacked
        return stacked[mesh.rank0: mesh.rank0 + mesh.nlocal].contiguous()

    def _every_rank(self, block: torch.Tensor) -> torch.Tensor:
        """The stacked pencil of every rank from this process's ranks' (a
        host collective on a spanning mesh: every process calls it)."""
        if not self.mesh.spanning:
            return block
        from . import multihost

        return multihost.global_array(block, self.mesh)

    def place_x_pencil(self, arr, dtype=None) -> torch.Tensor:
        """Global ``(n0, n1)`` array -> stacked x-pencil ``(P, n0p,
        n1p/P)``, pad zero (this process's ranks on a spanning mesh)."""
        shape = x_pencil_shape(self.global_shape, self.nprocs)
        g = self._padded(arr, dtype)
        return self._local(g.view(shape[1], self.nprocs, shape[2]).transpose(0, 1).contiguous())

    def place_y_pencil(self, arr, dtype=None) -> torch.Tensor:
        """Global ``(n0, n1)`` array -> stacked y-pencil ``(P, n0p/P,
        n1p)``, pad zero (this process's ranks on a spanning mesh)."""
        return self._local(self._padded(arr, dtype).view(
            y_pencil_shape(self.global_shape, self.nprocs)))

    def gather_x_pencil(self, block: torch.Tensor) -> torch.Tensor:
        """Stacked x-pencil -> global ``(n0, n1)`` (pad sliced away; on a
        spanning mesh assembled from every process's ranks)."""
        n0, n1 = self.global_shape
        g = self._every_rank(block).transpose(0, 1).reshape(self.padded_shape)
        return g[:n0, :n1]

    def gather_y_pencil(self, block: torch.Tensor) -> torch.Tensor:
        """Stacked y-pencil -> global ``(n0, n1)`` (pad sliced away; on a
        spanning mesh assembled from every process's ranks)."""
        n0, n1 = self.global_shape
        return self._every_rank(block).reshape(self.padded_shape)[:n0, :n1]

    # -- explicit repartitions ----------------------------------------------

    def transpose_x_to_y(self, arr) -> torch.Tensor:
        """Global-view repartition: axis-1-split -> axis-0-split, any
        extents (pad, one flip, slice).  The values are the input's."""
        return self.gather_y_pencil(self.mesh.ring.x_to_y(self.place_x_pencil(arr)))

    def transpose_y_to_x(self, arr) -> torch.Tensor:
        """Global-view repartition: axis-0-split -> axis-1-split."""
        return self.gather_x_pencil(self.mesh.ring.y_to_x(self.place_y_pencil(arr)))


# ---------------------------------------------------------------------------
# collectives (the reference's src/mpi re-exports)
# ---------------------------------------------------------------------------


def _every_partial(partials: torch.Tensor, mesh: Mesh, lead: int) -> torch.Tensor:
    """``partials`` ``(*members, PL)``, one value a member of each of this
    process's ranks, as ``(*members, P)`` of every rank (the ring's rank
    gather on a spanning mesh; the values themselves on one process)."""
    if not mesh.spanning:
        return partials
    members = partials.shape[:lead]
    rows = partials.reshape(-1, mesh.nlocal).transpose(0, 1)  # (PL, members)
    every = mesh.ring.gather(rows)  # (P, members)
    return every.transpose(0, 1).reshape(*members, mesh.nranks)


def _ranks_of(blocks: torch.Tensor, mesh: Mesh, lead: int, what: str) -> int:
    ranks = mesh.nlocal
    if blocks.shape[lead] != ranks:
        raise ValueError(f"{what}: leading dim {blocks.shape[lead]} of the rank-stacked "
                         f"blocks, the mesh holds {ranks} ranks here")
    return ranks


def all_gather_sum(blocks: torch.Tensor, mesh: Mesh, lead: int = 0) -> torch.Tensor:
    """Sum every rank's contribution so every rank holds the global sum
    (the reference's ``all_gather_sum``): ``blocks`` is rank-stacked (the
    rank leading; this process's ranks on a spanning mesh), each rank's
    block is summed, then the rank sums, in rank order.  A 0-d tensor on
    the mesh's device; with ``lead`` member dims in front of the rank, one
    sum per member (a tensor of those dims)."""
    shape = blocks.shape[:lead]
    ranks = _ranks_of(blocks, mesh, lead, "all_gather_sum")
    if not lead:
        return torch.sum(_every_partial(blocks.reshape(ranks, -1).sum(dim=1), mesh, 0))
    partials = blocks.reshape(*shape, ranks, -1).sum(dim=-1)
    return _every_partial(partials, mesh, lead).sum(dim=-1)


def all_gather_max(blocks: torch.Tensor, mesh: Mesh, lead: int = 0) -> torch.Tensor:
    """The maximum over every rank's block, on every rank (as
    :func:`all_gather_sum`, the rank maxima then their maximum)."""
    shape = blocks.shape[:lead]
    ranks = _ranks_of(blocks, mesh, lead, "all_gather_max")
    partials = blocks.reshape(*shape, ranks, -1).amax(dim=-1)
    return _every_partial(partials, mesh, lead).amax(dim=-1)


def broadcast_scalar(value, mesh: Mesh) -> torch.Tensor:
    """Rank 0's value to all ranks (the reference's ``broadcast_scalar``):
    ``value`` is one host scalar, which every rank holds, or a tensor of
    per-rank values (``(P,)``; this process's ranks' on a spanning mesh).
    A 0-d tensor of rank 0's value."""
    per_rank = torch.as_tensor(value, device=mesh.device)
    if per_rank.ndim == 0:
        per_rank = per_rank.expand(mesh.nlocal)
    if tuple(per_rank.shape) != (mesh.nlocal,):
        raise ValueError(f"broadcast_scalar: one value or one per rank, got shape "
                         f"{tuple(per_rank.shape)}")
    return _every_partial(per_rank.contiguous(), mesh, 0)[0].clone()


def all_gather_pencils(blocks, mesh: Mesh, x_pencil: bool) -> list:
    """The padded global arrays, on this process's device, of pencils of a
    mesh whose ranks span processes: ``blocks`` are this process's ranks'
    x-pencils (``x_pencil``) or y-pencils, ``(*members, PL, ...)``; each
    comes back as ``(*members, n0p, n1p)``, a fresh tensor laid out as the
    one-process mesh's reshape of its stacked pencil.  The blocks of one
    shape and dtype move together, as members of one flip of the ring, so
    a call costs one push a shape on the card and no host collective (it
    can be captured).  The trick: a process tiles its x-pencil ``nproc``
    times along the rows before an x -> y flip, so each of its ranks
    receives its own rows of every rank's block, and the ranks' y-pencils
    stacked are the global array; a y-pencil is tiled along the columns
    before a y -> x flip alike."""
    ring, nproc = mesh.ring, mesh.nproc
    out = [None] * len(blocks)
    groups: dict = {}
    for i, b in enumerate(blocks):
        groups.setdefault((tuple(b.shape), b.dtype), []).append(i)
    for (shape, _), idx in groups.items():
        lead, (pl, r, c) = shape[:-3], shape[-3:]
        stack = torch.stack([blocks[i] for i in idx]).reshape(-1, pl, r, c)
        if x_pencil:
            flipped = ring.apply(torch.cat([stack] * nproc, dim=-2), True)
            full = flipped.reshape(len(stack), pl * flipped.shape[-2], -1)
        else:
            flipped = ring.apply(torch.cat([stack] * nproc, dim=-1), False)
            full = flipped.transpose(-3, -2).reshape(len(stack), flipped.shape[-2], -1)
        full = full.reshape(len(idx), *lead, *full.shape[-2:])
        for j, i in enumerate(idx):
            out[i] = full[j].clone()
    return out


def gather_root(blocks: torch.Tensor, decomp: Decomp2d, pencil: str = "y") -> np.ndarray:
    """Full global array on the host from a stacked pencil (the
    reference's gather-to-root IO path; on a spanning mesh every process
    takes part and every one gets the array)."""
    gather = decomp.gather_y_pencil if pencil == "y" else decomp.gather_x_pencil
    return gather(blocks).cpu().numpy()


def scatter_root(values, decomp: Decomp2d, pencil: str = "y", dtype=None) -> torch.Tensor:
    """Host array -> stacked pencil on the mesh's device (the reference's
    scatter; on a spanning mesh this process's ranks of it, from the global
    array every process holds)."""
    if pencil == "y":
        return decomp.place_y_pencil(values, dtype)
    return decomp.place_x_pencil(values, dtype)

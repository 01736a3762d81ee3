"""Hyperslab (slice) HDF5 IO (counterpart of the JAX package's
``utils/slice_io.py``): create or open a dataset of a known global shape
and read or write one rank's rectangular slab, the reference's
rank-sequential parallel IO.  ``write_pencils`` streams a meshed field to
disk one rank's slab at a time, so the host never holds the global array.
Complex data is stored as ``{name}_re``/``{name}_im`` pairs like the rest
of the checkpoint layer.  Every function needs ``h5py``, imported where a
file is opened.

A meshed field of the port is one rank-stacked tensor (:mod:`..parallel`),
whose ranks hold equal padded extents; the slabs written here are the
balanced split of :class:`..parallel.decomp.Decomp2d` (``y_pencil`` /
``x_pencil``, the JAX package's), gathered from the stacked block one slab
at a time.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .checkpoint import snapshot_digest


def _h5():
    import h5py

    return h5py


def write_slice(filename, dsname: str, data, offset, global_shape) -> None:
    """Write ``data`` into the hyperslab at ``offset`` of dataset ``dsname``
    (created with ``global_shape`` on first touch; the file appended to or
    created)."""
    data = data.detach().cpu().numpy() if torch.is_tensor(data) else np.asarray(data)
    if np.iscomplexobj(data):
        write_slice(filename, dsname + "_re", data.real, offset, global_shape)
        write_slice(filename, dsname + "_im", data.imag, offset, global_shape)
        return
    sel = tuple(slice(o, o + s) for o, s in zip(offset, data.shape))
    with _h5().File(filename, "a") as f:
        ds = _require_dataset(f, dsname, tuple(global_shape), data.dtype)
        ds[sel] = data


def read_slice(filename, dsname: str, offset, shape, is_complex: bool = False) -> np.ndarray:
    """Read the hyperslab at ``offset`` of extent ``shape``."""
    if is_complex:
        re = read_slice(filename, dsname + "_re", offset, shape)
        im = read_slice(filename, dsname + "_im", offset, shape)
        return re + 1j * im
    sel = tuple(slice(o, o + s) for o, s in zip(offset, shape))
    with _h5().File(filename, "r") as f:
        return np.asarray(f[dsname][sel])


def _require_dataset(f, dsname: str, global_shape: tuple, dtype):
    if dsname in f:
        ds = f[dsname]
        if tuple(ds.shape) != global_shape:
            raise ValueError(f"dataset {dsname} exists with shape {ds.shape}, "
                             f"expected {global_shape}")
        return ds
    return f.create_dataset(dsname, shape=global_shape, dtype=dtype)


def _slab_reader(arr, decomp, pencil: str):
    """``read(sel) -> host ndarray`` of one global selection of ``arr``:
    a global array (host or tensor, of ``decomp.global_shape``), or the
    port's rank-stacked block in ``pencil`` layout (a y-pencil ``(P,
    n0p/P, n1p)`` or an x-pencil ``(P, n0p, n1p/P)``), read one rank block
    at a time."""
    global_shape = tuple(decomp.global_shape)
    if tuple(arr.shape) == global_shape:
        if torch.is_tensor(arr):
            return lambda sel: arr[sel].detach().cpu().numpy()
        return lambda sel: np.asarray(arr[sel])
    if not torch.is_tensor(arr) or arr.ndim != 3 or arr.shape[0] != decomp.nprocs:
        raise ValueError(f"write_pencils takes a global array of shape {global_shape} or a "
                         f"rank-stacked pencil of {decomp.nprocs} ranks, got "
                         f"{tuple(arr.shape)}")
    axis = 0 if pencil == "y" else 1  # the axis the ranks split
    local = arr.shape[1 + axis]

    def read(sel):
        lo, hi = sel[axis].start, sel[axis].stop
        parts = []
        for rank in range(lo // local, (hi - 1) // local + 1):
            a, b = max(lo, rank * local) - rank * local, min(hi, (rank + 1) * local) - rank * local
            block = arr[rank, a:b, sel[1]] if axis == 0 else arr[rank, sel[0], a:b]
            parts.append(block.detach().cpu())
        return torch.cat(parts, dim=axis).numpy()

    return read


def _is_complex(arr) -> bool:
    return arr.is_complex() if torch.is_tensor(arr) else np.iscomplexobj(arr)


def write_pencils(filename, dsname: str, arr, decomp, pencil: str = "y") -> None:
    """Write a meshed field to dataset ``dsname`` one rank's slab at a time
    (the reference's rank-serialized writer): ``arr`` is the port's
    rank-stacked block in ``pencil`` layout, or a global array; the slabs
    are ``decomp``'s ``y_pencil``/``x_pencil`` split.  Peak host memory is
    one slab.  The file is opened once for the whole dataset; complex data
    goes to the ``_re``/``_im`` pair."""
    if _is_complex(arr):
        write_pencils(filename, dsname + "_re", arr.real, decomp, pencil)
        write_pencils(filename, dsname + "_im", arr.imag, decomp, pencil)
        return
    get = decomp.y_pencil if pencil == "y" else decomp.x_pencil
    read = _slab_reader(arr, decomp, pencil)
    global_shape = tuple(decomp.global_shape)
    with _h5().File(filename, "a") as f:
        ds = None
        for rank in range(decomp.nprocs):
            p = get(rank)
            sel = tuple(slice(st, st + s) for st, s in zip(p.st, p.sz))
            block = read(sel)
            if ds is None:
                ds = _require_dataset(f, dsname, global_shape, block.dtype)
            ds[sel] = block


def read_pencil(filename, dsname: str, decomp, rank: int, pencil: str = "y",
                is_complex: bool = False) -> np.ndarray:
    """One rank's slab of a dataset (``decomp``'s balanced split)."""
    p = (decomp.y_pencil if pencil == "y" else decomp.x_pencil)(rank)
    return read_slice(filename, dsname, p.st, p.sz, is_complex=is_complex)


def write_pencils_concurrent(filename, dsname: str, arr, decomp, pencil: str = "y",
                             max_workers=None) -> None:
    """Concurrent pencil writer (the reference's MPIO path, which it ships
    disabled): each rank's slab goes to its own shard file
    ``{filename}.{dsname}.shard{rank}`` from a thread pool, stamped with
    its digest, and the main file exposes the global dataset as an HDF5
    virtual dataset over the shards, so readers see what
    :func:`write_pencils` writes.  h5py serializes its library calls
    behind one lock, so in one process the pool overlaps the slab copies
    with the writes, not the writes with each other.  The shard files
    travel with the main file (HDF5 resolves them relative to it)."""
    if _is_complex(arr):
        write_pencils_concurrent(filename, dsname + "_re", arr.real, decomp, pencil, max_workers)
        write_pencils_concurrent(filename, dsname + "_im", arr.imag, decomp, pencil, max_workers)
        return
    h5py = _h5()
    get = decomp.y_pencil if pencil == "y" else decomp.x_pencil
    read = _slab_reader(arr, decomp, pencil)
    global_shape = tuple(decomp.global_shape)
    pencils = [get(rank) for rank in range(decomp.nprocs)]
    base = os.path.basename(filename)
    shard_name = dsname.replace("/", "_")

    def write_shard(rank, block):
        with h5py.File(f"{filename}.{shard_name}.shard{rank}", "w") as f:
            f.create_dataset("slab", data=block)
            f.attrs["digest"] = snapshot_digest([("slab", block, "raw")])
        return rank, block.dtype

    # slab copies run on this thread; in-flight slabs are bounded by the
    # worker count, so peak host memory stays O(workers) slabs
    workers = max_workers or min(8, len(pencils))
    dtypes = {}
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = []
        for rank, p in enumerate(pencils):
            sel = tuple(slice(st, st + s) for st, s in zip(p.st, p.sz))
            pending.append(ex.submit(write_shard, rank, np.ascontiguousarray(read(sel))))
            if len(pending) > workers:
                r, dt = pending.pop(0).result()
                dtypes[r] = dt
        for fut in pending:
            r, dt = fut.result()
            dtypes[r] = dt
    layout = h5py.VirtualLayout(shape=global_shape, dtype=dtypes[0])
    for rank, p in enumerate(pencils):
        sel = tuple(slice(st, st + s) for st, s in zip(p.st, p.sz))
        layout[sel] = h5py.VirtualSource(f"./{base}.{shard_name}.shard{rank}", "slab",
                                         shape=tuple(p.sz))
    with h5py.File(filename, "a") as f:
        if dsname in f:
            del f[dsname]
        f.create_virtual_dataset(dsname, layout)

"""Multi-process controllers (counterpart of the JAX package's
``parallel/multihost.py``; the port imports nothing of that package and
reads no environment).

The reference scales across nodes with MPI ranks; the JAX package runs one
controller per host over one global device mesh.  The port runs one
controller per process on ``torch.distributed`` with the gloo backend,
which carries host objects only.  Either every process holds its own model
on its own :class:`.mesh.Mesh` on its own card, and the processes agree on
every decision that leads into a collective through the functions here; or
one model spans them (:func:`global_pencil_mesh`), each process holding
some of its ranks, whose flips and sums go card to card through CUDA IPC
(:class:`..ops.ring_transpose.SpanningRing`; on the CPU through gloo).

* :func:`initialize_distributed`: ``torch.distributed.init_process_group``
  on gloo (the ``MPI_Init`` analog), given its address, size and rank;
* :func:`global_pencil_mesh`: the mesh of every process's ranks (one
  process: :func:`.mesh.make_mesh` on its card);
* :func:`host_local_array` / :func:`global_array`: on a spanning mesh,
  this process's ranks' blocks of a global array and the global array of
  every process's blocks; the whole array otherwise;
* :func:`process_slab` / :func:`slab_blocks` / :func:`join_slabs`: this
  process's columns of a global spectral array (pad sliced away) from its
  x-pencil blocks and back, and every process's joined (a parked
  member's continuation shard and its resume);
* :func:`sync_hosts`: the barrier;
* :func:`allgather_host` / :func:`allgather_bytes` / :func:`broadcast` /
  :func:`broadcast_obj` / :func:`root_decides`: small host-value
  collectives (the sharded checkpoints' digest exchange, the runner's
  root-decided flags, the telemetry gathers);
* :func:`any_process` / :func:`agree_flags`: the runner's break flag across
  processes, and a boundary's flags in one exchange.

Every collective is one exchange of pickled envelopes (:func:`_exchange`):
one gloo allgather of 256-byte frames, a second only for a payload that
outgrows them.

A process that never called :func:`initialize_distributed` is one process
and every function here degrades to the local value.  The JAX package's
``RUSTPDE_SYNC_TIMEOUT_S`` is :func:`set_sync_timeout`: with a timeout every
collective waits on the transport at most that long, and a peer that never
arrives, or whose transport failed, raises
:class:`..utils.resilience.DispatchHang` (every thread's stack dumped, as
:func:`..utils.resilience.call_with_watchdog` does) instead of wedging the
job.
Every entry point records into :mod:`.sanitizer` where the JAX one does.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import pickle
import time

import numpy as np
import torch
import torch.distributed as _td

from . import sanitizer as _sanitizer
from .mesh import make_mesh

#: seconds a collective may wait (0: no deadline; the process group's own
#: timeout still bounds a wait)
_SYNC_TIMEOUT_S = 0.0

#: pre-collective device fence (see :func:`set_device_fence`)
_device_fence = None


def set_device_fence(fn) -> None:
    """Install (``fn``) or clear (None) the pre-collective device fence: a
    callable every entry point runs before it touches the wire (the serving
    layer's guard for a campaign on a proper sub-mesh)."""
    global _device_fence
    _device_fence = fn


def _fence() -> None:
    fence = _device_fence
    if fence is not None:
        fence()


def set_sync_timeout(seconds: float | None) -> None:
    """The deadline of every collective here (None or 0: none; the process
    group's own timeout still bounds a wait); :func:`sync_hosts` may pass
    its own."""
    global _SYNC_TIMEOUT_S
    _SYNC_TIMEOUT_S = float(seconds or 0.0)


def _dist():
    """``torch.distributed`` when a process group is up, else None."""
    if _td.is_available() and _td.is_initialized():
        return _td
    return None


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           timeout_s: float = 600.0) -> bool:
    """Join the multi-process runtime (the ``MPI_Init`` analog): a gloo
    process group at ``tcp://<coordinator_address>`` (``host:port``) of
    ``num_processes`` processes, this one ``process_id``.  ``timeout_s`` is
    the process group's own bound on any collective.

    Returns False when no cluster is configured (no argument given: one
    process) and whether more than one process joined otherwise; when a
    cluster was asked for, a failure to form it raises."""
    import torch.distributed as dist

    if num_processes is not None and coordinator_address is None:
        raise ValueError("num_processes given but no coordinator address")
    if coordinator_address is None and num_processes is None and process_id is None:
        return process_count() > 1
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes is None or process_id is None:
        raise ValueError("a cluster needs coordinator_address, num_processes and process_id")
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group("gloo", init_method=address, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=float(timeout_s)))
    return dist.get_world_size() > 1


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    """This process's rank (the reference's ``nrank``)."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def is_root() -> bool:
    """The rank-0 check for root-guarded IO and logging."""
    return process_index() == 0


@dataclasses.dataclass(frozen=True)
class HostDevice:
    """One process's card as the planners see it: its global ``id`` (the
    process-major order of :func:`global_devices`), the ``process_index``
    that owns it and the ``device`` string within that process."""

    id: int
    process_index: int
    device: str

    def __str__(self):
        return f"{self.device}@proc{self.process_index}"


def global_devices(device=None) -> list:
    """Every process's card, in rank order (one allgather of the device
    names; the local card alone in one process)."""
    from .. import config

    local = str(config.resolve_device(device))
    names = [local] if process_count() == 1 else [
        bytes(b).decode("utf-8") for b in allgather_bytes(local.encode("utf-8"))]
    return [HostDevice(i, p, name) for i, (p, name) in enumerate(enumerate(names))]


def global_pencil_mesh(ranks_per_process: int = 1, device=None):
    """The pencil mesh over every process of the group, each holding
    ``ranks_per_process`` consecutive ranks on its card (``device``, the
    card by default; every process may name the same one): a spanning
    :class:`.mesh.Mesh` of ``ranks_per_process * process_count()`` ranks
    (one allgather of the device names).  One process: :func:`.mesh.make_mesh`."""
    if process_count() == 1:
        return make_mesh(ranks_per_process, device)
    if ranks_per_process < 1:
        raise ValueError(f"a mesh needs at least one rank a process, got {ranks_per_process}")
    from .mesh import Mesh

    return Mesh([d for d in global_devices(device) for _ in range(ranks_per_process)])


def _host(arr) -> np.ndarray:
    return arr.detach().cpu().numpy() if hasattr(arr, "detach") else np.asarray(arr)


def global_array(host_local, sharding=None):
    """The global array of a mesh whose ranks span processes (the
    scatter's inverse, a gather): ``sharding`` is that mesh and
    ``host_local`` this process's ranks' blocks, rank leading; every
    process's blocks are concatenated in rank order on every process (one
    allgather).  A tensor gives a tensor on its device, anything else
    numpy.  Without a spanning mesh, one process or many, each process
    holds the whole array: ``host_local`` itself."""
    if not getattr(sharding, "spanning", False):
        return host_local
    whole = np.concatenate(list(allgather_host(_host(host_local))), axis=0)
    if torch.is_tensor(host_local):
        return torch.from_numpy(whole).to(host_local.device)
    return whole


def host_local_array(arr, spec=None) -> np.ndarray:
    """This process's slab of a global array as numpy: ``spec`` a mesh whose
    ranks span processes and ``arr`` every rank's blocks, rank leading, its
    ranks' blocks.  Without a spanning mesh, one process or many, each
    process holds the whole array (a parked member's state on every
    process of a fleet replica): the whole array."""
    host = _host(arr)
    if not getattr(spec, "spanning", False):
        return host
    return host[spec.rank0: spec.rank0 + spec.nlocal]


def slab_columns(mesh, shape) -> slice:
    """The columns of a global ``shape`` array (``(n0, n1)``) whose x-pencil
    blocks this process's ranks of ``mesh`` hold, the pad left out (every
    column on a mesh of one process)."""
    from .mesh import padded

    n1 = int(shape[1])
    w = padded(n1, mesh.nranks) // mesh.nranks
    c0 = min(n1, mesh.rank0 * w)
    return slice(c0, min(n1, c0 + mesh.nlocal * w))


def process_slab(blocks, mesh, shape) -> np.ndarray:
    """This process's columns (:func:`slab_columns`) of a global ``shape``
    array from its x-pencil ``blocks`` on ``mesh`` (``([K,] PL, n0p, w)``,
    this process's ranks'), as numpy: its ranks' blocks side by side, the
    pad sliced away, so the slabs of every process joined along the last
    axis in process order are the global array (the JAX package's
    ``host_local_array`` of a spectral pencil).  On a mesh of one process
    that is the whole global array; with no mesh, ``blocks`` are the
    global array already."""
    host = _host(blocks)
    if mesh is None:
        return host
    cols = slab_columns(mesh, shape)
    pl, n0p, w = host.shape[-3:]
    joined = np.moveaxis(host, -3, -2).reshape(*host.shape[:-3], n0p, pl * w)
    return np.ascontiguousarray(joined[..., : int(shape[0]), : cols.stop - cols.start])


def slab_blocks(slab, mesh, shape, dtype, device) -> torch.Tensor:
    """The x-pencil blocks of this process's ranks on ``mesh`` from its
    slab of a global ``shape`` array (:func:`process_slab`'s inverse, the
    pad zero); the global array itself with no mesh.  A slab of another
    width than ``mesh`` gives this process raises ``ValueError``: it was
    cut for another layout."""
    from .mesh import padded

    host = torch.as_tensor(_host(slab))
    if mesh is None:
        return host.to(device=device, dtype=dtype)
    n0 = int(shape[0])
    cols = slab_columns(mesh, shape)
    p, pl = mesh.nranks, mesh.nlocal
    n0p, w = padded(n0, p), padded(int(shape[1]), p) // p
    width = cols.stop - cols.start
    if tuple(host.shape[-2:]) != (n0, width):
        raise ValueError(f"a slab of shape {tuple(host.shape[-2:])}, this process's ranks "
                         f"{mesh.rank0}..{mesh.rank0 + pl - 1} of {p} hold ({n0}, {width})")
    lead = tuple(host.shape[:-2])
    out = torch.zeros((*lead, n0p, pl * w), dtype=dtype, device=device)
    out[..., :n0, :width] = host.to(device=device, dtype=dtype)
    return out.reshape(*lead, n0p, pl, w).movedim(-2, -3).contiguous()


def join_slabs(slab) -> np.ndarray:
    """Every process's :func:`process_slab` joined along the last axis in
    process order: the global array on every process (one exchange; one
    process: the slab)."""
    host = np.ascontiguousarray(_host(slab))
    if process_count() == 1:
        return host
    import io

    buf = io.BytesIO()
    np.save(buf, host, allow_pickle=False)
    parts = [np.load(io.BytesIO(b), allow_pickle=False)
             for b in allgather_bytes(buf.getvalue())]
    return np.concatenate(parts, axis=-1)


#: the deadline (seconds, 0: none) and label of the collective in progress
_watch = None


def _watched(fn, timeout_s: float | None, label: str):
    """Run the collective ``fn()`` with its exchanges under a deadline
    (``timeout_s``, else :func:`set_sync_timeout`'s) and ``label``; an
    outer collective's deadline and label hold over an inner one's."""
    global _watch
    if _watch is not None:
        return fn()
    _watch = (_SYNC_TIMEOUT_S if timeout_s is None else float(timeout_s), label)
    try:
        return fn()
    finally:
        _watch = None


def _all_gather(outs: list, inp) -> None:
    """One gloo allgather, waited on under the deadline in force (the sync
    timeout outside :func:`_watched`): past it, or when the transport
    reports a lost peer, every thread's stack is dumped and
    :class:`..utils.resilience.DispatchHang` raised.  The wait is gloo's
    own timed wait on the calling thread (a watchdog thread a call cost
    more than the exchange itself, ``scripts/exchange_times.py``)."""
    timeout, label = _watch if _watch is not None else (_SYNC_TIMEOUT_S, "allgather")
    work = _td.all_gather(outs, inp, async_op=True)
    if timeout <= 0:
        work.wait()
        return
    from ..utils.resilience import _hang

    t0 = time.monotonic()
    try:
        work.wait(timeout=datetime.timedelta(seconds=timeout))
    except RuntimeError as exc:
        if time.monotonic() - t0 < timeout:  # gloo: a peer closed its connection
            raise _hang(f"{label} (transport failed: {exc})", timeout) from exc
        raise _hang(label, timeout) from exc


#: bytes of the fixed frame every exchange starts with (a length header and
#: a payload that fits; a longer payload rides a second, padded allgather)
_FRAME = 256

#: the frames of the last exchange, kept for the next one: the sent frame,
#: then one a process (``(tensor, numpy view)`` pairs; every received
#: frame is read before the exchange returns)
_frames: list = []


def _frame_buffers(nproc: int) -> list:
    global _frames
    if len(_frames) != nproc + 1:
        tensors = [torch.zeros(_FRAME, dtype=torch.uint8) for _ in range(nproc + 1)]
        _frames = [(t, t.numpy()) for t in tensors]
    return _frames


def _exchange(value, source: bool = False, kind: str = "allgather") -> list:
    """The one transport of every collective here: an allgather of pickled
    ``(kind, source flag, value)`` envelopes, as one fixed-size frame each,
    and when any envelope outgrows its frame a second allgather padded to
    the longest (every process sees every length, so all take it
    together).  Returns the ``(source flag, value)`` pairs in rank order.

    Every collective is the same transport, so the processes stay paired
    even when one of them skipped a call: the sanitizer then reports the
    desync at its next verify, or at once, on every process, where the
    paired calls are of different kinds (every process sees every kind)."""
    frames = _frame_buffers(_td.get_world_size())
    payload = pickle.dumps((kind, bool(source), value), protocol=4)
    size = len(payload)
    send = frames[0][1]
    send[:8] = np.frombuffer(np.int64(size).tobytes(), np.uint8)
    if size <= _FRAME - 8:
        send[8: 8 + size] = np.frombuffer(payload, np.uint8)
    _all_gather([t for t, _ in frames[1:]], frames[0][0])
    views = [v for _, v in frames[1:]]
    lengths = [int(v[:8].view(np.int64)[0]) for v in views]
    if max(lengths) <= _FRAME - 8:
        blobs = [v[8: 8 + n].tobytes() for v, n in zip(views, lengths)]
    else:
        buf = np.zeros(max(lengths), np.uint8)
        buf[:size] = np.frombuffer(payload, np.uint8)
        bufs = [torch.empty(buf.size, dtype=torch.uint8) for _ in views]
        _all_gather(bufs, torch.from_numpy(buf))
        blobs = [b.numpy()[:n].tobytes() for b, n in zip(bufs, lengths)]
    envelopes = [pickle.loads(b) for b in blobs]
    kinds = [env[0] for env in envelopes]
    if len(set(kinds)) > 1:
        _paired_apart(kinds)
    return [env[1:] for env in envelopes]


def _paired_apart(what: list) -> None:
    """The transport paired calls that differ (``what``: each process's
    kind or payload shape, in rank order): a desync on every process."""
    _sanitizer.transport_desync(", ".join(f"host{p}: {w}" for p, w in enumerate(what)))


def _schema_of(n: int):
    """A stand-in of ``n`` bytes for a sanitizer record (the schema of the
    JAX package's padded buffer, without allocating it)."""
    return np.broadcast_to(np.uint8(0), (n,))


def allgather_host(value) -> np.ndarray:
    """Allgather a small host value: every process gets the stacked
    ``(nproc, ...)`` array in rank order (one process: a leading axis of
    length 1)."""
    _sanitizer.record("allgather", payload=value)
    if process_count() == 1:
        return np.asarray(value)[None]
    _fence()
    values = [np.asarray(v) for _, v in _exchange(np.asarray(value))]
    if len({v.shape for v in values}) > 1:
        _paired_apart([f"allgather {_sanitizer.np_schema(v)}" for v in values])
    out = np.stack(values)
    _sanitizer.maybe_verify()
    return out


def broadcast(value, is_source: bool | None = None):
    """Root-decides broadcast of a small host value: every process returns
    the source's value as numpy (rank 0 is the source unless
    ``is_source`` marks another; one process: the value).  Runs under the
    sync timeout."""
    if _sanitizer.skip_broadcast_injected():
        # the armed desync injection: this process skips the collective
        return np.asarray(value)
    _sanitizer.record("broadcast", payload=value)
    if process_count() == 1:
        return np.asarray(value)
    _fence()
    source = is_root() if is_source is None else bool(is_source)

    def run():
        envelopes = _exchange(np.asarray(value), source, "broadcast")
        flagged = [i for i, (flag, _) in enumerate(envelopes) if flag]
        return np.asarray(envelopes[flagged[0] if flagged else 0][1])

    out = _watched(run, None, "broadcast")
    _sanitizer.maybe_verify()
    return out


def allgather_bytes(data: bytes) -> list[bytes]:
    """Allgather one variable-length blob a process: every process returns
    ``[proc0_bytes, proc1_bytes, ...]`` (one exchange; the sanitizer records
    the JAX package's two allgathers, a length and a padded buffer).  One
    process: ``[data]``."""
    if process_count() == 1:
        return [bytes(data)]
    _fence()
    blobs = [bytes(v) for _, v in _exchange(bytes(data), kind="bytes")]
    _sanitizer.record("allgather", payload=np.int64(0))
    _sanitizer.record("allgather", payload=_schema_of(max(1, max(map(len, blobs)))))
    _sanitizer.maybe_verify()
    return blobs


def broadcast_obj(obj=None):
    """Root-decides broadcast of a JSON-able host object: the other
    processes pass anything and every one returns root's object (one
    exchange under the sync timeout; the injection and the sanitizer count
    the JAX package's two inner broadcasts, a length and a padded buffer,
    and a skip of either skips the call).  JSON turns tuples into lists:
    re-tuple with :func:`tuplify`.  One process: the object."""
    if process_count() == 1:
        return obj
    if any([_sanitizer.skip_broadcast_injected() for _ in range(2)]):
        return obj
    _fence()
    root = is_root()
    payload = json.dumps(obj).encode("utf-8") if root else b""
    envelopes = _watched(lambda: _exchange(payload, root, "broadcast_obj"), None,
                         "broadcast_obj")
    data = envelopes[0][1]
    _sanitizer.record("broadcast", payload=np.int64(0))
    _sanitizer.record("broadcast", payload=_schema_of(len(data)))
    _sanitizer.maybe_verify()
    return json.loads(data.decode("utf-8"))


def root_decides(local: bool) -> bool:
    """Root's verdict on a flag that leads into a collective (a preemption
    stop, a cadence checkpoint, a write error): rank 0's value is broadcast
    so every process takes the same branch, and a flag raised on another
    process alone is IGNORED.  One process: the local flag."""
    _sanitizer.record("root_decides")
    if process_count() == 1:
        return bool(local)
    return bool(int(broadcast(np.int32(1 if local else 0))))


def any_process(local: bool) -> bool:
    """True when the flag is raised on any process (one allgather).  The
    runner's break criterion: each process holds its own replica, so a
    divergence on one of them (a host-scoped fault) stops them all, as a
    NaN spreading through a coupled step stops every JAX controller.  One
    process: the local flag."""
    if process_count() == 1:
        return bool(local)
    return bool(allgather_host(np.int32(1 if local else 0)).any())


def agree_flags(any_of=(), root=()) -> tuple:
    """Several flags in one exchange, for a boundary that would otherwise
    pay one handshake each: ``(any_of', root')``, each of ``any_of`` True
    where it is raised on any process (:func:`any_process`), each of
    ``root`` the root's (:func:`root_decides`).  Runs under the sync
    timeout.  The root's flags stand in for broadcasts, so the sanitizer's
    ``skip_broadcast`` injection counts this call as one (a skip: the
    local flags, no record, no exchange).  One process: the local flags."""
    any_of = tuple(bool(f) for f in any_of)
    root = tuple(bool(f) for f in root)
    if _sanitizer.skip_broadcast_injected():
        return any_of, root
    _sanitizer.record("agree", tag=f"{len(any_of)}+{len(root)}")
    if process_count() == 1:
        return any_of, root
    _fence()
    envelopes = _watched(lambda: _exchange((any_of, root), is_root(), "agree"), None,
                         "agree_flags")
    out = (tuple(any(env[1][0][i] for env in envelopes) for i in range(len(any_of))),
           envelopes[0][1][1])
    _sanitizer.maybe_verify()
    return out


def tuplify(obj):
    """Lists back to tuples, recursively (the inverse of JSON's
    tuple-to-list coercion of compat keys)."""
    if isinstance(obj, list):
        return tuple(tuplify(v) for v in obj)
    return obj


def sync_hosts(tag: str = "barrier", timeout_s: float | None = None) -> None:
    """The cross-process barrier (the reference's MPI barrier); a no-op in
    one process.  ``timeout_s`` overrides :func:`set_sync_timeout`'s; past the
    deadline every thread's stack is dumped and ``DispatchHang`` raised."""
    _sanitizer.record("sync", tag=tag)
    if process_count() == 1:
        return
    _fence()
    _watched(lambda: _exchange(tag, kind="sync"), timeout_s, f"sync_hosts({tag!r})")
    _sanitizer.maybe_verify()

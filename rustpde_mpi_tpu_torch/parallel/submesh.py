"""Sub-mesh carving: failure-domain partitioning of the fleet's devices
(a copy of the JAX package's ``parallel/submesh.py``, which is pure host
planning; the port imports nothing of that package).

The ROADMAP's two-level-serve item in mechanism form: the global device
set is carved into SUB-MESHES so one pencil-sharded flagship campaign (a
gang, serve/fleet/gang.py) claims a slice of the fleet while vmapped
small-grid buckets keep the remainder — one service, both regimes, and a
gang death is contained to its own slice.

Two halves, deliberately separated:

* **Canonicalization** (:func:`shape_for`, :func:`grid_fits`) is PURE —
  no torch, no devices: the admission tier (the stateless proxies above
  all, which never touch a card) stamps the sub-mesh shape
  into the request from the CONFIGURED shape list alone, so equal grids
  always land in the same bucket (`SimRequest.compat_key` gains the
  stamp) no matter which front admitted them.
* **Carving** (:func:`carve`) binds shapes to actual devices at campaign
  time, on the serving replica: devices are interleaved round-robin
  across processes so every process contributes equally to every
  sub-mesh — a multihost collective over any sub-mesh then involves
  every process (no process is ever absent from a barrier), while the
  DEVICES of different sub-meshes stay disjoint (the failure-domain
  boundary the gang lease fate-shares over).

A fleet that shrank below a stamped shape does not strand the bucket:
:meth:`SubmeshPlan.place` re-maps it onto the largest still-fitting
sub-mesh and reports the remap so the scheduler can journal a
``gang_replanned`` row (the elastic re-carve).
"""

from __future__ import annotations

import dataclasses


def grid_fits(nx: int, ny: int, shape: int) -> bool:
    """Can an ``nx`` x ``ny`` grid be pencil-sharded over ``shape``
    devices?  Conservative divisibility rule: each dimension must split
    evenly either as the full extent or as the interior (``n - 2``, the
    Chebyshev spectral extent the transpose pipeline actually shards).
    ``shape == 1`` always fits (unsharded)."""
    if shape <= 1:
        return True

    def dim_ok(n: int) -> bool:
        return n % shape == 0 or (n - 2) % shape == 0

    return dim_ok(int(nx)) and dim_ok(int(ny))


def shape_for(nx: int, ny: int, cfg) -> int:
    """The canonical sub-mesh stamp for one request grid under a
    :class:`..config.SubmeshConfig`: ``0`` (vmapped
    default traffic) for grids below ``shard_min_nx``, else the SMALLEST
    configured shape the grid divides onto — smallest, so flagship
    traffic takes no more of the fleet than it needs and the choice is
    deterministic across admission fronts.  Returns ``-1`` when the grid
    must shard (at/above ``shard_min_nx``) but no configured shape fits:
    the caller rejects at POST time (``reason="no_submesh"``) instead of
    durably enqueuing a poison pill no replica can ever serve."""
    if max(int(nx), int(ny)) < int(cfg.shard_min_nx):
        return 0
    for shape in sorted(int(s) for s in cfg.shapes):
        if shape > 1 and grid_fits(nx, ny, shape):
            return shape
    return -1


@dataclasses.dataclass(frozen=True)
class Submesh:
    """One carved slice: its ordinal (the gang index faults/journals name),
    its device count, and the devices themselves (process-interleaved)."""

    index: int
    shape: int
    devices: tuple

    def mesh(self):
        """The :class:`.mesh.Mesh` over exactly these devices (pencil axis
        ``p``).  Devices of more than one process raise
        ``NotImplementedError``: a mesh whose ranks span processes is ROADMAP
        Queue 1 item 17.1."""
        from .mesh import Mesh

        return Mesh(list(self.devices))


@dataclasses.dataclass
class SubmeshPlan:
    """The root plan's carve of the device set: gang sub-meshes first (in
    configured-shape order), the remainder as the DEFAULT sub-mesh serving
    vmapped traffic.  Built by :func:`carve`; root computes it once per
    serve incarnation and every process derives the identical plan from
    the identical (globally-consistent) device order
    (:func:`.multihost.global_devices`)."""

    submeshes: tuple  # gang-capable slices, disjoint devices
    default: Submesh | None  # the vmapped remainder (None: nothing left)
    nproc: int = 1

    def by_shape(self, shape: int) -> Submesh | None:
        """The first carved sub-mesh of exactly ``shape`` devices."""
        for sm in self.submeshes:
            if sm.shape == int(shape):
                return sm
        return None

    def place(self, nx: int, ny: int, shape: int):
        """Bind one stamped bucket to a carved sub-mesh.  Exact stamp
        match when the carve still has it; otherwise the elastic re-carve:
        the largest carved sub-mesh the grid still divides onto (fleet
        shrank between admission and service).  Returns
        ``(submesh, replanned)``; ``(None, False)`` when nothing fits —
        the bucket stays queued for a bigger fleet."""
        sm = self.by_shape(shape)
        if sm is not None and grid_fits(nx, ny, sm.shape):
            return sm, False
        best = None
        for cand in sorted(
            self.submeshes, key=lambda s: s.shape, reverse=True
        ):
            if grid_fits(nx, ny, cand.shape):
                best = cand
                break
        return best, best is not None


def interleave(devices, nproc: int | None = None) -> list:
    """Process-interleaved device order: position ``k`` holds the
    ``k // nproc``-th local device of process ``k % nproc``, so any
    contiguous chunk of ``m * nproc`` devices takes exactly ``m`` devices
    from EVERY process.  Devices without a ``process_index`` (CPU test
    doubles) are treated as one process."""
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(int(getattr(d, "process_index", 0)), []).append(d)
    procs = sorted(by_proc)
    out = []
    depth = max(len(v) for v in by_proc.values()) if by_proc else 0
    for i in range(depth):
        for p in procs:
            if i < len(by_proc[p]):
                out.append(by_proc[p][i])
    return out


def carve(devices, shapes, nproc: int | None = None) -> SubmeshPlan:
    """Partition ``devices`` into gang sub-meshes of the configured
    ``shapes`` (largest first, so big gangs claim contiguous interleaved
    runs before small ones fragment them) plus the default remainder.

    Shapes that no longer fit the device count are DROPPED, not an error:
    the plan serves what the fleet can actually hold and the scheduler's
    placement re-maps stamped buckets elastically.  On a multi-process
    runtime every shape must take equal devices from every process
    (``shape % nproc == 0``) — a sub-mesh missing a process entirely
    would break the every-process-participates collective contract."""
    devs = list(devices)
    nproc = int(nproc) if nproc else len(
        {int(getattr(d, "process_index", 0)) for d in devs} or {0}
    )
    ordered = interleave(devs, nproc)
    slices = []
    cursor = 0
    for shape in sorted((int(s) for s in shapes), reverse=True):
        if shape <= 1 or shape % nproc != 0 and nproc > 1:
            continue
        if cursor + shape > len(ordered):
            continue  # fleet too small for this shape now: dropped
        slices.append((shape, tuple(ordered[cursor : cursor + shape])))
        cursor += shape
    submeshes = tuple(
        Submesh(index=i, shape=shape, devices=devs)
        for i, (shape, devs) in enumerate(slices)
    )
    rest = tuple(ordered[cursor:])
    default = (
        Submesh(index=len(submeshes), shape=len(rest), devices=rest)
        if rest
        else None
    )
    return SubmeshPlan(submeshes=submeshes, default=default, nproc=nproc)


def serve_key(model_key: tuple, shape: int) -> tuple:
    """The serve-side bucket key: the model 10-tuple, extended by the
    sub-mesh stamp when (and only when) the request is gang traffic —
    ``shape == 0`` keeps the bare 10-tuple, so with sub-meshes disabled
    every key is byte-identical to today's."""
    key = tuple(model_key)
    return key + (int(shape),) if int(shape) > 0 else key


def model_key(key: tuple) -> tuple:
    """Strip a serve key back to the model 10-tuple the workloads
    registry builds from (identity for bare keys)."""
    key = tuple(key)
    return key[:10] if len(key) == 11 else key


def key_shape(key: tuple) -> int:
    """The sub-mesh stamp of a serve key (0 = vmapped default traffic)."""
    key = tuple(key)
    return int(key[10]) if len(key) == 11 else 0

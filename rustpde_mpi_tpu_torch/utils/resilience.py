"""The resilient run harness: what keeps a long DNS campaign alive
(counterpart of the JAX package's ``utils/resilience.py``; the port imports
nothing of that package and reads no environment).

:class:`ResilientRunner` wraps a model (``Navier2D`` on any route, the
linearised models, ``NavierEnsemble``) around the ``integrate`` driver:

* **durable checkpoints**: rolling, atomic, digest-stamped gathered
  snapshots (:mod:`.checkpoint`) on a wall-clock and/or sim-time cadence,
  a retention window, and auto-resume from the newest valid one; with the
  default :class:`..config.IOConfig` a cadence checkpoint is staged to the
  host on the calling thread and written on the pipeline's worker;
* **preemption**: SIGTERM/SIGINT finish the chunk in flight, checkpoint,
  journal and return ``"preempted"``;
* **the proactive governor**: with a :class:`..config.StabilityConfig` the
  chunks carry the CFL sentinels and a :class:`.governor.StabilityGovernor`
  rolls a ceiling trip back in memory and moves dt on its ladder
  (``set_dt``'s rung cache keeps every rung's captured graphs);
* **divergence recovery**: when the NaN break criterion fires, roll back to
  the newest valid checkpoint, shrink dt by ``dt_backoff`` (floored at
  ``dt_min``) and retry, up to ``max_retries``; an ensemble can respawn
  dead members from perturbed healthy donors;
* **the integrity audits**: with ``set_integrity`` armed, boundary digests
  chain every chunk, shadow re-executions audit at the config's cadence, a
  mismatch rolls back in memory to the last verified snapshot and strikes
  the device in the quarantine ledger;
* **the dispatch watchdog**: a chunk's work is enqueued on the calling
  thread and, when ``dispatch_timeout_s`` is set, waited for through a
  CUDA event polled against the deadline (:func:`dispatch_with_watchdog`);
  expiry dumps every thread's stack and raises :class:`DispatchHang`.  With
  no deadline nothing is fenced, so the overlapped pipeline stays full.  On
  a mesh spanning processes the hang first releases the remote flips' waits
  (a peer that never pushes would stall the card's stream for good);
* **deterministic fault injection**: ``fault="nan@<step>"`` / ``spike`` /
  ``kill`` / ``slow`` / ``bitflip`` (:mod:`.faults`) drives every recovery
  path; the injections write into the live state in place between chunks
  (:func:`poison_state`, :func:`spike_state`, :func:`bitflip_state`);
* **telemetry**: a JSONL journal of every event, spans into the flight
  recorder (dumped at every incident), a cadenced ``metrics.jsonl``, the
  statistics' health stream with latched ``resolution_warning`` /
  ``budget_drift`` events, and the throughput monitor's ``perf_degraded``
  row with a one-shot profiler capture.  None of it touches a captured
  graph: a run with telemetry on steps bit for bit as one with it off.

On more than one process (:mod:`..parallel.multihost`; each process holds
its own replica of the model) every flag that leads into a collective is
the root's (:meth:`ResilientRunner._root_decides`: the preemption stop, a
cadence checkpoint, a write failure and its ENOSPC verdict), the break
criterion is raised when any process diverged, the checkpoint to roll back
to or resume from is the root's choice, broadcast, and the journal, the
metrics file and the incident dumps are the root's.  Checkpoints are then
the sharded two-phase ones (:meth:`ResilientRunner._checkpoint_sharded`;
forced in one process with ``IOConfig(sharded_checkpoints=True)``), whose
cadence commit is deferred to the next chunk boundary when the writes
overlap.  A fault scoped to ``host<p>`` acts on process ``p``; the shard
crash spec (``shard_crash=``) kills a process inside the two-phase window.

The same holds for one model whose mesh spans the processes
(:func:`..parallel.multihost.global_pencil_mesh`): its sentinels, break
check and digests are global already, each process stages and restores its
own ranks in the sharded format (the only one there), a host-scoped fault
acts on that process's ranks while every process refreshes what depends
on the whole state, and an at-rest corruption is attributed to the process
whose ranks hold it (:meth:`ResilientRunner._integ_attribute`).

``_store`` (a private constructor argument) is where checkpoints live.
By default (:func:`file_store`) they are the gathered HDF5 files
(:class:`_FileStore`), or, where ``h5py`` does not import, ``.npz`` files
(:class:`_NpzStore`).  :class:`_MemoryStore` keeps each staged
:class:`.checkpoint.HostSnapshot` and its digest in memory and restores
through the file reader's group restore; the ``.npz`` store is that store
with every snapshot also written to disk and read back by a later run.
Retention, digest verification and the choice of the newest valid
checkpoint behave in each as with HDF5 files.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno as _errno
import faulthandler
import json
import os
import signal
import sys
import threading
import time as _time

import numpy as np
import torch

from ..parallel import sanitizer as _sanitizer
from ..telemetry import metrics as _tm
from ..telemetry import tracing as _tr
from ..telemetry.exporters import MetricsDumper
from . import checkpoint
from .faults import FaultPlan, FaultSpecError, parse_shard_crash_spec  # noqa: F401
from .governor import StabilityGovernor
from .integrate import integrate
from .io_pipeline import AsyncWriteError, IOPipeline
from .journal import JournalWriter, read_journal

#: seconds between polls of a dispatch's CUDA event under a deadline
_POLL_S = 2e-4


class DispatchHang(RuntimeError):
    """A dispatch exceeded its watchdog deadline.  Raised with every
    thread's stack already dumped to stderr; the card may still be busy
    with the abandoned work, so the process should checkpoint what it can
    and exit rather than keep dispatching."""

    def __init__(self, label: str, timeout_s: float):
        super().__init__(f"{label} did not complete within {timeout_s:.1f}s "
                         "(all-thread stacks dumped to stderr)")
        self.label = label
        self.timeout_s = timeout_s


class DivergenceError(RuntimeError):
    """A run diverged and could not be recovered (retries exhausted, or no
    valid checkpoint to roll back to)."""


def _hang(label: str, timeout_s: float):
    sys.stderr.write(f"[resilience] {label} stuck past its {timeout_s:.1f}s deadline; "
                     "all-thread stacks:\n")
    sys.stderr.flush()
    faulthandler.dump_traceback(all_threads=True)
    return DispatchHang(label, timeout_s)


def call_with_watchdog(fn, timeout_s: float | None, label: str = "dispatch"):
    """Run the host callable ``fn()`` under a deadline, as the JAX
    package's: the call runs on a worker thread while the caller waits
    ``timeout_s``; on expiry every thread's stack is dumped and
    :class:`DispatchHang` raised (the worker, a daemon, is left to finish
    or hang).  A None or non-positive timeout calls ``fn()`` directly.

    Device work is not watched this way: a CUDA stream is per thread, so a
    graph replayed on a worker would run on the worker's stream, and a
    thread stuck in a card synchronisation cannot be cancelled.  The runner
    uses :func:`dispatch_with_watchdog` for that."""
    if not timeout_s or timeout_s <= 0:
        return fn()
    result: list = []
    error: list = []

    def target():
        try:
            result.append(fn())
        except BaseException as exc:  # re-raised in the caller below
            error.append(exc)

    worker = threading.Thread(target=target, name=f"watchdog:{label}", daemon=True)
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        raise _hang(label, timeout_s)
    if error:
        raise error[0]
    return result[0]


def _wait_for_card(device, t_end: float, label: str, timeout_s: float) -> None:
    """Wait, on the calling thread, for the work enqueued so far on
    ``device``'s current stream, polling a CUDA event until the monotonic
    ``t_end``; past it raise :class:`DispatchHang` (stacks dumped).  On a
    CPU device the work already ran: only the clock is checked."""
    device = torch.device(device)
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        while not event.query():
            if _time.monotonic() >= t_end:
                raise _hang(label, timeout_s)
            _time.sleep(_POLL_S)
    elif _time.monotonic() > t_end:
        raise _hang(label, timeout_s)


def dispatch_with_watchdog(fn, timeout_s: float | None, label: str = "dispatch", device=None,
                           stall_s: float = 0.0):
    """Enqueue ``fn()`` on the calling thread and, with a deadline, wait for
    the card under it (:func:`_wait_for_card`; on the CPU, where the work ran
    inside ``fn()``, only the clock is checked): the event-based watchdog of
    the runner's dispatches.  ``stall_s`` is a host stall before the
    dispatch (the ``slow`` fault), charged to the same deadline: a stall
    that outlasts it raises at the deadline.  With no deadline nothing is
    fenced (``fn()`` only)."""
    if not timeout_s or timeout_s <= 0:
        if stall_s:
            _time.sleep(stall_s)
        return fn()
    t_end = _time.monotonic() + timeout_s
    if stall_s:
        _time.sleep(min(stall_s, max(0.0, t_end - _time.monotonic())))
        if _time.monotonic() >= t_end:
            raise _hang(label, timeout_s)
    result = fn()
    _wait_for_card(device if device is not None else "cpu", t_end, label, timeout_s)
    return result


# -- fault injection ------------------------------------------------------------------


def _single_process() -> bool:
    from ..parallel import multihost

    return multihost.process_count() == 1


def _is_root() -> bool:
    from ..parallel import multihost

    return multihost.is_root()


def _acts_here(host) -> bool:
    """Whether a fault scoped to ``host`` (None: every process) acts on this
    process."""
    from ..parallel import multihost

    return host is None or int(host) == multihost.process_index()


def _spanning(pde) -> bool:
    """Whether ``pde`` is one model on a mesh whose ranks span processes
    (each process holds some of its ranks, not a replica)."""
    return bool(getattr(checkpoint._pde_mesh(pde), "spanning", False))


def _release_remote_waits(pde) -> None:
    """After a :class:`DispatchHang` on a mesh spanning processes: let every
    wait of its remote flips pass
    (:meth:`..ops.ring_transpose.SpanningRing.release_waits`), so that the
    stream a peer left stalled drains; a no-op on any other mesh."""
    if _spanning(pde):
        checkpoint._pde_mesh(pde).ring.release_waits()


def _touched(pde, acted: bool) -> bool:
    """After a host-scoped fault: whether this process must refresh what
    depends on the whole state (it acted, or it holds other ranks of the
    same model, whose state the fault changed)."""
    return acted or _spanning(pde)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bits (NaNs included)."""
    a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8),
                                              b.contiguous().view(torch.uint8))


def _sentinels_across_processes(rows: np.ndarray) -> np.ndarray:
    """A sentinel chunk's host rows as one coupled model reads them (the
    JAX package's sentinels reduce over the global state), so that every
    process's governor sees the same status and takes the same verdict,
    and every replica commits or rolls back its chunk together: the
    finite and under-ceiling flags and the step counts (rows 0-2, and an
    ensemble's counts before the chunk, row 7) the least over the
    processes, the CFL, growth, divergence and energy maxima (rows 3-6)
    the largest."""
    from ..parallel import multihost

    gathered = multihost.allgather_host(np.asarray(rows, np.float64))
    out = gathered.max(axis=0)
    out[:3] = gathered[:, :3].min(axis=0)
    out[7:] = gathered[:, 7:].min(axis=0)
    return out


def poison_state(pde, host: int | None = None) -> None:
    """Multiply every state leaf by NaN, in place (the deterministic stand-in
    for a blow-up).  The buffers are written where they are, as ``set_dt``
    and the integrity restore leave them: the next chunk copies them into
    its graph's carry.  An ensemble's alive mask is re-derived, as the JAX
    package's.  ``host``: the process it acts on (None: every one; each
    process holds its own replica, and the runner's break criterion stops
    them all when one diverged).  On a mesh whose ranks span processes it
    poisons that process's ranks, the JAX package's host columns, and every
    process re-derives the mask (a collective) and drops its cached
    observables."""
    acted = _acts_here(host)
    if acted:
        for t in pde.state:
            t.mul_(float("nan"))
    if not _touched(pde, acted):
        return
    if hasattr(pde, "mask") and hasattr(pde, "_finite_mask"):
        pde.mask = pde._finite_mask(pde.state)
    pde._obs_cache = None


def spike_state(pde, factor: float = 50.0, host: int | None = None) -> None:
    """Scale the velocities by ``factor`` in place: a finite state far past
    the CFL ceiling (every member of an ensemble).  Governed, it is caught
    before NaNs appear and rolled back in memory; ungoverned, the
    over-CFL convection grows it into the NaN path.  ``host``: the process
    it acts on (None: every one; on a mesh whose ranks span processes, its
    ranks, and every process drops its cached observables)."""
    acted = _acts_here(host)
    if acted:
        pde.state.velx.mul_(factor)
        pde.state.vely.mul_(factor)
    if _touched(pde, acted):
        pde._obs_cache = None


def bitflip_state(pde, step: int, host: int | None = None, member: int | None = None,
                  bit: int | None = None) -> dict:
    """Flip one mantissa bit of one spectral coefficient in place, at the
    position :func:`..integrity.flip_state_bit` picks from ``step`` (in
    member ``member`` only, for an ensemble): finite and CFL-sane, seen only
    by the integrity digests.  Returns the flip's info (leaf, index, bit,
    member, host) for the journal; on a process ``host`` does not name
    nothing is flipped and the info says so (``leaf`` None).  On a mesh
    whose ranks span processes the bit is in ``host``'s ranks (the index
    is into its pencils, which every process's info names)."""
    from ..integrity import flip_state_bit

    acted = _acts_here(host)
    if not _touched(pde, acted):
        return {"leaf": None, "index": (), "bit": None, "member": member, "host": host}
    flipped, info = flip_state_bit(pde.state, step, member=member, bit=bit)
    if acted:
        getattr(pde.state, info["leaf"]).copy_(getattr(flipped, info["leaf"]))
    pde._obs_cache = None
    info["host"] = host
    return info


# -- where checkpoints live ------------------------------------------------------------


class _FileStore:
    """Gathered HDF5 checkpoint files in ``run_dir`` (:mod:`.checkpoint`)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir

    def path(self, step: int) -> str:
        return checkpoint.checkpoint_path(self.run_dir, step)

    def files(self) -> list:
        return checkpoint.checkpoint_files(self.run_dir)

    def latest(self) -> str | None:
        return checkpoint.latest_checkpoint(self.run_dir)

    def attrs(self, path: str) -> dict:
        return checkpoint.read_attrs(path)

    def write(self, snap, path: str) -> None:
        checkpoint.write_host_snapshot(snap, path)

    def rotate(self, keep: int) -> None:
        checkpoint.rotate_checkpoints(self.run_dir, keep)

    def restore(self, pde, path: str) -> None:
        pde.read(path)

    def remove(self, path: str) -> None:
        checkpoint.remove_checkpoint(path)

    def root_data(self, path: str) -> dict:
        return checkpoint.read_root_data(path)

    def write_shard(self, snap, path: str, crash=None) -> None:
        checkpoint.write_shard_file(snap, path, crash=crash)

    def commit_shards(self, snap, path: str, local_ok: bool, crash=None) -> dict:
        return checkpoint.commit_sharded_snapshot(snap, path, local_ok=local_ok, crash=crash)


class _MemoryStore:
    """Checkpoints kept in memory: each staged :class:`.checkpoint.HostSnapshot`
    (the leaves the file would hold), or this process's staged
    :class:`.checkpoint.ShardSnapshot` of a sharded checkpoint, under the
    path a file would have, with the digest its file would carry.  The
    newest one whose recomputed digest matches is the newest valid
    checkpoint; a restore goes through the file reader's group restore (the
    slab catalog for a sharded one).  Thread-safe (the async writer stores
    from its worker)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._snaps: dict = {}
        self._lock = threading.Lock()

    def path(self, step: int) -> str:
        return checkpoint.checkpoint_path(self.run_dir, step)

    def files(self) -> list:
        with self._lock:
            return sorted(self._snaps)

    def latest(self) -> str | None:
        for path in reversed(self.files()):
            try:
                snap, digest = self._entry(path)
            except (OSError, ValueError, KeyError) as exc:  # an unreadable file
                print(f"skipping unreadable checkpoint: {path}: {exc}")
                continue
            items = (snap.items() if isinstance(snap, checkpoint.ShardSnapshot)
                     else snap.datasets)
            if checkpoint.snapshot_digest(items) == digest:
                return path
            print(f"skipping corrupt checkpoint: {path}: digest mismatch")
        return None

    def attrs(self, path: str) -> dict:
        snap, digest = self._entry(path)
        out = {"schema": checkpoint.SCHEMA_VERSION, "digest": digest, "time": snap.time,
               "dt": snap.dt}
        if isinstance(snap, checkpoint.ShardSnapshot):
            out["sharded"] = snap.shard_count
        if snap.step is not None:
            out["step"] = snap.step
        return out

    def _entry(self, path: str) -> tuple:
        """``(snapshot, digest)`` kept under ``path``."""
        with self._lock:
            return self._snaps[path]

    def write(self, snap, path: str) -> None:
        self._keep(path, snap, checkpoint.snapshot_digest(snap.datasets))

    def _keep(self, path: str, snap, digest: str) -> None:
        with self._lock:
            self._snaps[path] = (snap, digest)

    def rotate(self, keep: int) -> None:
        if keep <= 0:
            return
        for path in self.files()[:-keep]:
            self.remove(path)

    def write_shard(self, snap, path: str, crash=None) -> None:
        """Stage this process's shard with the digest its file would carry
        (the ``after_shard`` crash point fires here as at a file write)."""
        checkpoint.stage_shard_digest(snap)
        checkpoint._shard_crash_hook("after_shard", snap.step, crash)

    def commit_shards(self, snap, path: str, local_ok: bool, crash=None) -> dict:
        """The files' two-phase commit with the manifest kept in memory:
        every process keeps its shard under ``path`` (a shard that failed
        is dropped)."""

        return checkpoint.commit_sharded_snapshot(
            snap, path, local_ok=local_ok, crash=crash,
            keep=lambda: self._keep(path, snap, snap.digest))

    def restore(self, pde, path: str) -> None:
        snap, _ = self._entry(path)
        if isinstance(snap, checkpoint.ShardSnapshot):
            # every process's shard: the local one, or all of them gathered
            # (a collective, as every restore is)
            from ..parallel import multihost

            shards = [snap]
            if multihost.process_count() > 1:
                import pickle

                shards = [pickle.loads(b) for b in multihost.allgather_bytes(pickle.dumps(snap))]
            checkpoint.restore_sharded_snapshots(pde, shards, label=path)
            return
        group = checkpoint._host_group(snap)
        if hasattr(pde, "member_state"):
            checkpoint._restore_ensemble_snapshot(pde, group)
        else:
            checkpoint._restore_snapshot(pde, group)

    def remove(self, path: str) -> None:
        with self._lock:
            self._snaps.pop(path, None)

    def root_data(self, path: str) -> dict:
        """The root-level datasets :func:`.checkpoint.read_root_data` reads
        from the file (``members``, ``alive``, ``steps_done``, ...)."""
        snap, _ = self._entry(path)
        items = (snap.root_datasets if isinstance(snap, checkpoint.ShardSnapshot)
                 else snap.datasets)
        return {name: np.asarray(arr) for name, arr, _ in items if "/" not in name}


class _NpzStore(_MemoryStore):
    """Checkpoints as uncompressed ``.npz`` files, where ``h5py`` does not
    import (the card's machine): the memory store's snapshots, each also
    written (fsynced, atomically renamed) beside where its HDF5 file would
    be, ``ckpt_<step>.npz`` (``ckpt_<step>.p<process>.npz`` on more than one
    process, each holding its own), with the digest the HDF5 file would
    carry; a store opened on the directory later reads each back at its
    first use (a file that does not load is skipped with a message).  Restores go through the
    memory store's readers; only the ``.h5`` form is the JAX package's."""

    def __init__(self, run_dir: str):
        super().__init__(run_dir)
        suffix = self._suffix()
        try:
            names = sorted(os.listdir(run_dir))
        except OSError:
            names = []
        for name in names:
            stem = name[: -len(suffix)]
            if not (name.startswith("ckpt_") and name.endswith(suffix)) or "." in stem:
                continue  # not a checkpoint, or another process's
            self._snaps[os.path.join(run_dir, stem + ".h5")] = None  # read at first use

    @staticmethod
    def _suffix() -> str:
        nproc = checkpoint._process_count()
        return f".p{checkpoint._process_index():05d}.npz" if nproc > 1 else ".npz"

    def _file(self, path: str) -> str:
        return path[: -len(".h5")] + self._suffix()

    def _keep(self, path: str, snap, digest: str) -> None:
        head = {"digest": digest, "step": snap.step, "time": snap.time, "dt": snap.dt}
        arrays = {}
        if isinstance(snap, checkpoint.ShardSnapshot):
            head.update(kind="shard", shard_index=snap.shard_index,
                        shard_count=snap.shard_count, meta=snap.meta,
                        slabs=[[st, list(off)] for st, off, _ in snap.slabs],
                        root=[[n, k] for n, _, k in snap.root_datasets])
            arrays.update({f"s{i}": a for i, (_, _, a) in enumerate(snap.slabs)})
            arrays.update({f"r{i}": np.asarray(a) for i, (_, a, _) in
                           enumerate(snap.root_datasets)})
        else:
            head.update(kind="host", datasets=[[n, k] for n, _, k in snap.datasets])
            arrays.update({f"d{i}": np.asarray(a) for i, (_, a, _) in enumerate(snap.datasets)})
        arrays["head"] = np.array(json.dumps(head))
        checkpoint._atomic_npz_write(self._file(path), arrays)
        super()._keep(path, snap, digest)

    def _entry(self, path: str) -> tuple:
        with self._lock:
            entry = self._snaps[path]
            if entry is None:
                entry = self._snaps[path] = self._load(self._file(path))
            return entry

    @staticmethod
    def _load(filename: str) -> tuple:
        with np.load(filename, allow_pickle=False) as npz:
            head = json.loads(str(npz["head"]))
            arrays = {k: np.asarray(npz[k]) for k in npz.files if k != "head"}
        if head["kind"] == "shard":
            snap = checkpoint.ShardSnapshot(
                shard_index=head["shard_index"], shard_count=head["shard_count"],
                slabs=[(st, tuple(off), arrays[f"s{i}"])
                       for i, (st, off) in enumerate(head["slabs"])],
                root_datasets=[(n, arrays[f"r{i}"], k) for i, (n, k) in enumerate(head["root"])],
                meta=head["meta"], step=head["step"], time=head["time"], dt=head["dt"],
                digest=head["digest"])
        else:
            snap = checkpoint.HostSnapshot(
                datasets=[(n, arrays[f"d{i}"], k) for i, (n, k) in enumerate(head["datasets"])],
                step=head["step"], time=head["time"], dt=head["dt"])
        return snap, head["digest"]

    def remove(self, path: str) -> None:
        super().remove(path)
        try:
            os.remove(self._file(path))
        except FileNotFoundError:
            pass


def file_store(run_dir: str):
    """The durable checkpoint store of ``run_dir``: HDF5 files where
    ``h5py`` imports, else ``.npz`` files (:class:`_NpzStore`)."""
    return _FileStore(run_dir) if checkpoint._have_h5py() else _NpzStore(run_dir)


# -- the runner ---------------------------------------------------------------------------


class ResilientRunner:
    """Wrap a model in the resilience harness: cadenced atomic checkpoints,
    the JSONL journal, auto-resume, checkpoint-then-exit on SIGTERM/SIGINT,
    divergence retries with dt backoff, the governor, the integrity audits
    and the dispatch watchdog (the JAX package's ``ResilientRunner``, same
    arguments)::

        model = Navier2D.new_confined(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc")
        runner = ResilientRunner(model, max_time=100.0, save_intervall=1.0,
                                 run_dir="data/run1", checkpoint_every_s=300)
        summary = runner.run()   # resumes if run1 holds checkpoints

    ``run()`` returns a summary whose ``outcome`` is ``"done"`` or
    ``"preempted"`` and raises :class:`DivergenceError` /
    :class:`DispatchHang` when recovery is impossible.  Beyond the JAX
    package's arguments: ``shard_crash`` (the JAX package's
    ``RUSTPDE_SHARD_CRASH``, :func:`..utils.checkpoint._shard_crash_hook`)
    and the private ``_store`` (see the module docstring)."""

    def __init__(self, pde, max_time: float, save_intervall: float | None = None, *,
                 run_dir: str = "data/resilient", checkpoint_every_s: float | None = 300.0,
                 checkpoint_every_t: float | None = None, keep: int = 3, max_retries: int = 3,
                 dt_backoff: float = 0.5, dt_min: float = 0.0, respawn_members: bool = False,
                 respawn_amp: float = 1e-3, respawn_seed: int | None = None,
                 dispatch_timeout_s: float | None = None, fault: str | None = None,
                 spike_factor: float | None = None, resume: bool = True,
                 max_chunk_steps: int = 1024, stability=None, io=None,
                 shard_crash: str | None = None, _store=None):
        from ..config import IOConfig

        self.pde = pde
        self.max_time = float(max_time)
        self.save_intervall = save_intervall
        self.run_dir = run_dir
        self.checkpoint_every_s = checkpoint_every_s
        self.checkpoint_every_t = checkpoint_every_t
        self.keep = int(keep)
        self.max_retries = int(max_retries)
        self.dt_backoff = float(dt_backoff)
        # the floor under the compounding backoff and the governor's ladder
        self.dt_min = float(dt_min)
        self.respawn_members = bool(respawn_members)
        self.respawn_amp = float(respawn_amp)
        self.respawn_seed = respawn_seed
        self.dispatch_timeout_s = dispatch_timeout_s
        # strict parse at construction: a spec that cannot fire dies here
        self.fault = FaultPlan.from_spec(fault)
        # the two-phase window's crash spec, strict as well
        parse_shard_crash_spec(shard_crash)
        self.shard_crash = shard_crash
        self.spike_factor = 50.0 if spike_factor is None else float(spike_factor)
        self.resume = bool(resume)
        self.max_chunk_steps = int(max_chunk_steps)
        # an explicit StabilityConfig wins; else the model's armed sentinels
        self.stability = stability if stability is not None else getattr(pde, "_stability", None)
        self.governor: StabilityGovernor | None = None
        self._dt0 = float(pde.get_dt())  # the governor ladder's anchor
        self.io = io if io is not None else IOConfig()
        self._io: IOPipeline | None = None
        self._async_ckpt = False
        self._overlap = False
        self._store = _store if _store is not None else file_store(run_dir)
        # disk full: the run degrades to in-memory rollback only
        self._ckpt_disabled = False
        self._io_snapshot_s = 0.0  # calling-thread seconds staging snapshots
        self._sharded = False  # the sharded two-phase format (picked in _setup_io)
        self._pending_commit = None  # a deferred sharded cadence commit
        self._lock = threading.Lock()  # checkpoint-path updates
        self.journal_path = os.path.join(run_dir, "journal.jsonl")
        self._journal_writer: JournalWriter | None = None
        self._journal_owned = True

        self.slo = _tm.ThroughputMonitor()
        self._slo_last_step = 0
        self._metrics_dumper: MetricsDumper | None = None
        self._exit_disarm = None

        # the statistics' health stream: one future in flight, read a
        # boundary later; warnings latch once per excursion
        self._stats_health_pending = None
        self._stats_res_latched = False
        self._stats_budget_latched = False
        self._saved_pde_journal = None
        self._saved_pde_io = None

        # integrity: (step, digest future) at the last commit, the last
        # audit-verified (step, snapshot), committed chunks, the ledger
        self._integ_prev = None
        self._integ_verified = None
        self._integ_chunks = 0
        self._integ_ledger = None

        self.step = 0  # the run's step counter (a checkpoint's ``step`` attr)
        self.attempt = 0  # divergence retries so far
        self.resumed = False
        self._interrupt: int | None = None
        # (step, stop, cadence due): the root's verdicts agreed at a boundary
        self._verdict: tuple | None = None
        self._slow_pending = False
        self._t0 = _time.monotonic()
        self._last_ckpt_wall = self._t0
        self._last_ckpt_time = 0.0
        self._last_ckpt_path: str | None = None
        self._prev_handlers: dict = {}
        self._is_ensemble = hasattr(pde, "member_state")

    @classmethod
    def from_config(cls, pde, rcfg, max_time, save_intervall=None, **overrides):
        """Build from a :class:`..config.ResilienceConfig` (None: the
        defaults); keyword overrides win.  A shallow field copy, so a
        nested ``StabilityConfig`` arrives as the dataclass."""
        kwargs = ({f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
                  if rcfg is not None else {})
        kwargs.update(overrides)
        return cls(pde, max_time, save_intervall, **kwargs)

    # -- journal -------------------------------------------------------------------

    def set_journal(self, writer: JournalWriter) -> None:
        """Adopt an externally owned journal writer (never closed here)."""
        self._journal_writer = writer
        self._journal_owned = False
        self.journal_path = writer.path

    def _journal(self, event: dict) -> None:
        """Append one JSON line to ``<run_dir>/journal.jsonl`` (flushed per
        event; an event carrying its own ``step``/``time`` keeps them); the
        root's only, the run directory being shared."""
        if not _is_root():
            return
        if self._journal_writer is None:
            self._journal_writer = JournalWriter(self.journal_path)
            self._journal_owned = True
        record = {"wall_s": round(_time.monotonic() - self._t0, 3), "step": self.step,
                  "time": round(float(self.pde.get_time()), 9), "attempt": self.attempt,
                  **event}
        self._journal_writer.append(record)

    def _nu(self):
        """Nu for the journal: the model's, or the alive members' mean; None
        when not finite or unavailable."""
        try:
            nu = self.pde.eval_nu()
        except Exception:
            return None
        if self._is_ensemble:
            alive = np.asarray(self.pde.alive())
            nu = np.asarray(nu)
            return float(nu[alive].mean()) if alive.any() else None
        nu = float(nu)
        return nu if np.isfinite(nu) else None

    # -- signals -------------------------------------------------------------------

    def _install_signals(self) -> None:
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
        except ValueError:  # not the main thread: run unguarded
            self._prev_handlers = {}

    def _restore_signals(self) -> None:
        for sig, handler in self._prev_handlers.items():
            signal.signal(sig, handler)
        self._prev_handlers = {}

    def _on_signal(self, signum, frame) -> None:
        # acted on at the next chunk boundary, at a consistent step
        self._interrupt = signum

    def _root_decides(self, local: bool) -> bool:
        """The root's verdict on a flag that leads into a collective (a
        preemption stop, a cadence checkpoint, a write failure): every
        process takes the same branch, and a flag raised on another process
        alone is ignored (:func:`..parallel.multihost.root_decides`; one
        process: the local flag)."""
        from ..parallel import multihost

        return multihost.root_decides(local)

    def _preempt_agreed(self) -> bool:
        """Whether a stop was requested: the root's signal (a stray signal on
        another process is ignored; a real preemption hits every one)."""
        return self._root_decides(self._interrupt is not None)

    # -- checkpointing -------------------------------------------------------------

    def _state_ok(self) -> bool:
        """Never checkpoint a dead state over the rollback target; a model
        that tells success from death (``state_healthy``) decides."""
        healthy = getattr(self.pde, "state_healthy", None)
        try:
            if healthy is not None:
                return bool(healthy())
            return not self.pde.exit()
        except Exception:
            return False

    @staticmethod
    def _is_enospc(exc) -> bool:
        """Whether a write failure's cause chain ends in an out-of-space
        errno."""
        hops = 0
        while exc is not None and hops < 8:
            if getattr(exc, "errno", None) == _errno.ENOSPC:
                return True
            exc = exc.__cause__ if exc.__cause__ is not None else exc.__context__
            hops += 1
        return False

    def _degrade_checkpoints(self, exc, reason: str) -> None:
        """Disk full: journal ``checkpoint_failed`` with the errno, consume
        the writer's failures, and go on with in-memory rollback only (the
        last durable checkpoint stays valid)."""
        self._ckpt_disabled = True
        if self._io is not None:
            try:
                self._io.writer.drain(raise_errors=False)
            except Exception:
                pass
            self._io.writer.consume_errors()
        _tm.counter("checkpoints_degraded_total",
                    "runs degraded to in-memory rollback after ENOSPC").inc()
        self._journal({"event": "checkpoint_failed", "reason": reason, "errno": _errno.ENOSPC,
                       "error": str(exc) if exc is not None else "no space left on device",
                       "degraded": "in_memory_rollback_only", "step": self.step})

    def _stage(self):
        """The run's state staged in host memory (the checkpoint's leaves)."""
        if self._is_ensemble:
            return checkpoint.ensemble_snapshot_to_host(self.pde, step=self.step)
        return checkpoint.snapshot_to_host(self.pde, step=self.step)

    def _checkpoint(self, reason: str) -> str | None:
        """Write a rolling checkpoint: the overlapped path with
        ``io.async_checkpoints`` (staged here, written on the worker; an
        anchor, final or preempt checkpoint is drained at once), else
        synchronously."""
        if not self._state_ok():
            self._journal({"event": "checkpoint_skipped", "reason": reason})
            return None
        if self._ckpt_disabled:
            self._journal({"event": "checkpoint_skipped", "reason": reason,
                           "cause": "storage_full"})
            return None
        path = self._store.path(self.step)
        if self._sharded:
            return self._checkpoint_sharded(path, reason)
        if self._async_ckpt and self._io is not None:
            return self._checkpoint_async(path, reason)
        if self._io is not None:
            # settle a queued background write before this one and the rotation
            try:
                self._io.writer.drain()
            except AsyncWriteError as exc:
                if not self._is_enospc(exc):
                    raise
                self._degrade_checkpoints(exc, reason)
                return None
        t0 = _time.monotonic()
        write_error = None
        if _is_root():
            try:
                self._store.write(self._stage(), path)
                self._store.rotate(self.keep)
            except Exception as exc:  # must not skip the barrier below
                write_error = exc
        if not _single_process():
            from ..parallel import multihost

            multihost.sync_hosts("rustpde-checkpoint")
        # every process must agree on a failure (the root alone raising
        # would leave the others waiting at the next collective)
        if self._root_decides(write_error is not None):
            if self._root_decides(self._is_enospc(write_error)):
                # disk full is contained: every process degrades together
                self._degrade_checkpoints(write_error, reason)
                return None
            self._journal({"event": "checkpoint_failed", "reason": reason,
                           "error": str(write_error)})
            if write_error is not None:
                raise write_error
            raise RuntimeError("checkpoint write failed on the root process")
        self._last_ckpt_wall = _time.monotonic()
        self._last_ckpt_time = float(self.pde.get_time())
        self._last_ckpt_path = path
        write_s = _time.monotonic() - t0
        _tm.histogram("checkpoint_write_seconds", "serialize+digest+fsync seconds").observe(write_s)
        _tm.counter("checkpoints_total", "checkpoints written", reason=reason).inc()
        self._journal({"event": "checkpoint", "reason": reason, "path": path,
                       "write_s": round(write_s, 3), "nu": self._nu()})
        return path

    def _checkpoint_async(self, path: str, reason: str) -> str | None:
        """Overlapped checkpoint: the staging (device to host) and the Nu
        readout here, the serialization, digest and rotation on the
        worker.  ``_last_ckpt_path`` advances only once the write is
        durable, and every rollback or resume drains the writer first."""
        t0 = _time.monotonic()
        with _tr.span("checkpoint_stage", reason=reason, step=self.step):
            snap = self._stage()
        snapshot_s = _time.monotonic() - t0
        self._io_snapshot_s += snapshot_s
        _tm.histogram("checkpoint_snapshot_seconds",
                      "main-thread device->host staging").observe(snapshot_s)
        event = {"event": "checkpoint", "reason": reason, "path": path, "async": True,
                 "step": self.step, "time": round(float(self.pde.get_time()), 9),
                 "snapshot_s": round(snapshot_s, 3), "nu": self._nu()}

        def work():
            w0 = _time.monotonic()
            try:
                self._store.write(snap, path)
                self._store.rotate(self.keep)
            except BaseException as exc:
                self._journal({"event": "checkpoint_failed", "reason": reason,
                               "error": str(exc), "step": event["step"],
                               **({"errno": _errno.ENOSPC} if self._is_enospc(exc) else {})})
                raise
            with self._lock:
                self._last_ckpt_path = path
            write_s = _time.monotonic() - w0
            _tm.histogram("checkpoint_write_seconds",
                          "serialize+digest+fsync seconds").observe(write_s)
            _tm.counter("checkpoints_total", "checkpoints written", reason=reason).inc()
            self._journal({**event, "write_s": round(write_s, 3)})

        try:
            self._io.submit_write(work, path, nbytes=snap.nbytes)
        except AsyncWriteError as exc:
            if not self._is_enospc(exc):
                raise
            self._degrade_checkpoints(exc, reason)
            return None
        # the cadence clocks restart at the snapshot, which bounds data loss
        self._last_ckpt_wall = _time.monotonic()
        self._last_ckpt_time = float(self.pde.get_time())
        if reason != "cadence":
            try:
                self._io.writer.drain()
            except AsyncWriteError as exc:
                if not self._is_enospc(exc):
                    raise
                self._degrade_checkpoints(exc, reason)
                return None
        return path

    def _checkpoint_sharded(self, path: str, reason: str) -> str:
        """The two-phase sharded checkpoint (every process enters together:
        the decision was the root's): stage this process's slabs, write its
        shard, then the collective commit (:mod:`.checkpoint`).  With the
        pipeline armed a CADENCE checkpoint's shard is written on the worker
        while the card steps on, and its commit is deferred to the next
        chunk boundary (:meth:`_commit_pending`), after a local drain, so
        the barrier only ever sees fsynced shards; an anchor, final or
        preempt checkpoint writes and commits at once."""
        self._commit_pending()  # at most one deferred commit in flight
        t0 = _time.monotonic()
        with _tr.span("checkpoint_stage", reason=reason, step=self.step):
            snap = checkpoint.sharded_snapshot_to_host(self.pde, step=self.step)
        snapshot_s = _time.monotonic() - t0
        self._io_snapshot_s += snapshot_s
        _tm.histogram("checkpoint_snapshot_seconds",
                      "main-thread device->host staging").observe(snapshot_s)
        event = {"event": "checkpoint", "reason": reason, "path": path,
                 "sharded": snap.shard_count, "step": self.step,
                 "time": round(float(self.pde.get_time()), 9),
                 "snapshot_s": round(snapshot_s, 3), "nu": self._nu()}
        if self._async_ckpt and self._io is not None and reason == "cadence":
            self._io.submit_write(lambda: self._store.write_shard(snap, path, self.shard_crash),
                                  checkpoint.shard_path(path, snap.shard_index),
                                  nbytes=snap.nbytes)
            self._pending_commit = (snap, path, reason, dict(event, async_=True))
            self._last_ckpt_wall = _time.monotonic()
            self._last_ckpt_time = float(self.pde.get_time())
            return path
        local_ok = True
        try:
            self._store.write_shard(snap, path, self.shard_crash)
        except Exception as exc:
            local_ok = False
            self._journal({"event": "checkpoint_failed", "reason": reason, "error": str(exc),
                           **({"errno": _errno.ENOSPC} if self._is_enospc(exc) else {})})
        self._finish_sharded_commit(snap, path, reason, event, local_ok)
        return path

    def _commit_pending(self) -> None:
        """Settle a deferred sharded cadence commit (every process calls this
        at the same points: each chunk boundary, before any checkpoint scan,
        before the next checkpoint, at the run's end), draining the local
        writer first."""
        if self._pending_commit is None:
            return
        snap, path, reason, event = self._pending_commit
        self._pending_commit = None
        local_ok = True
        if self._io is not None:
            try:
                self._io.writer.drain()
            except Exception as exc:
                local_ok = False
                self._journal({"event": "checkpoint_failed", "reason": reason, "error": str(exc),
                               "step": event["step"],
                               **({"errno": _errno.ENOSPC} if self._is_enospc(exc) else {})})
        is_async = event.pop("async_", False)
        self._finish_sharded_commit(snap, path, reason,
                                    dict(event, **({"async": True} if is_async else {})),
                                    local_ok)

    def _finish_sharded_commit(self, snap, path: str, reason: str, event: dict,
                               local_ok: bool) -> None:
        """The collective half: the commit (barrier, digest allgather, the
        root's manifest), the rotation on success, and the
        ``checkpoint_sharded`` journal row (shards, bytes, barrier wait)."""
        w0 = _time.monotonic()
        with _tr.span("checkpoint_commit", step=self.step):
            stats = self._store.commit_shards(snap, path, local_ok, self.shard_crash)
        _tm.counter("checkpoint_barrier_seconds_total",
                    "seconds waiting at the two-phase commit barrier").inc(
                        float(stats.get("barrier_s") or 0.0))
        if not stats["ok"]:
            if local_ok:
                # the failing process journaled its own cause already
                self._journal({"event": "checkpoint_failed", "reason": reason,
                               "error": "sharded checkpoint aborted (a host failed its shard "
                               "write); no manifest committed",
                               "step": event.get("step", self.step)})
            raise checkpoint.CheckpointError(
                path, "sharded checkpoint aborted: a host failed its shard write (no manifest "
                "committed; the previous checkpoint is intact)")
        if _is_root():
            self._store.rotate(self.keep)
        _tm.counter("checkpoints_total", "checkpoints written", reason=reason).inc()
        with self._lock:
            self._last_ckpt_path = path
        self._last_ckpt_wall = _time.monotonic()
        self._last_ckpt_time = event.get("time", float(self.pde.get_time()))
        self._journal({**event, "commit_s": round(_time.monotonic() - w0, 3),
                       "checkpoint_sharded": {"shards": stats["shards"],
                                              "bytes_host": stats["bytes_host"],
                                              "bytes_total": stats["bytes_total"],
                                              "barrier_s": stats["barrier_s"]}})

    def _pick_checkpoint(self) -> str | None:
        """The newest valid checkpoint, after a deferred sharded commit and
        the writer settled (a rollback or resume never reads past a write in
        flight; a disk-full failure degrades and the scan goes on over what
        is durable).  On more than one process the root scans and broadcasts
        the step: the step-coded name is the cross-process contract."""
        self._commit_pending()
        if self._io is not None:
            try:
                self._io.writer.drain()
            except AsyncWriteError as exc:
                if not self._is_enospc(exc):
                    raise
                self._degrade_checkpoints(exc, "scan")
        if _single_process():
            return self._store.latest()
        from ..parallel import multihost

        step = -1
        if _is_root():
            path = self._store.latest()
            if path is not None:
                step = int(self._store.attrs(path).get("step", -1))
        step = int(multihost.broadcast(np.int64(step)))
        return None if step < 0 else self._store.path(step)

    def _maybe_resume(self) -> bool:
        if not self.resume:
            return False
        path = self._pick_checkpoint()
        if path is None:
            return False
        attrs = self._store.attrs(path)
        self._store.restore(self.pde, path)
        self.step = int(attrs.get("step", 0))
        self._restore_dt(attrs)
        self._last_ckpt_time = float(self.pde.get_time())
        self._last_ckpt_path = path
        self._journal({"event": "resumed", "path": path})
        return True

    def _restore_dt(self, attrs: dict) -> None:
        """Resume at the dt the checkpoint was written at (a backed-off run
        preempted and resumed must not re-diverge at the original dt)."""
        dt = attrs.get("dt")
        if dt is None or not hasattr(self.pde, "set_dt"):
            return
        dt = float(dt)
        if dt != float(self.pde.get_dt()):
            self.pde.set_dt(dt)
            self._journal({"event": "dt_restored", "dt": dt})

    # -- dispatch (fault injection and the watchdog) ------------------------------------

    def _stall_s(self) -> float:
        """The ``slow`` fault's host stall, consumed by the next dispatch:
        twice the deadline (at least 1 s)."""
        if not self._slow_pending:
            return 0.0
        self._slow_pending = False
        return max(2.0 * (self.dispatch_timeout_s or 0.0), 1.0)

    def _device(self, pde):
        from .profiling import _model_device

        return _model_device(pde)

    def _update(self, pde, n: int):
        """One watchdog-guarded dispatch (:func:`dispatch_with_watchdog`);
        returns the model's chunk status with sentinels armed, else
        None."""

        def work():
            if hasattr(pde, "update_n"):
                return pde.update_n(n)
            for _ in range(n):
                pde.update()
            return None

        with _tr.span("dispatch", steps=n, step=self.step):
            return dispatch_with_watchdog(work, self.dispatch_timeout_s,
                                          label=f"update_n({n}) @ step {self.step}",
                                          device=self._device(pde), stall_s=self._stall_s())

    def _advance(self, pde, n: int) -> None:
        """Advance ``n`` steps in sub-chunks of at most ``max_chunk_steps``
        (control returns at a bounded cadence for signals and checkpoints).
        With the governor each sub-chunk's sentinel status goes through it:
        a rollback or a dt change hands control back, and the driver
        re-plans at the new dt (that is the retry)."""
        cap = self.max_chunk_steps if self.max_chunk_steps > 0 else n
        if self._overlap and self.governor is not None and hasattr(pde, "update_n_pending"):
            return self._advance_lagged(pde, n, cap)
        while n > 0:
            k = min(n, cap)
            rec = self._integ_predispatch(pde, self.step)
            dt_before = pde.get_dt()
            status = self._update(pde, k)
            if status is not None and self.governor is not None:
                committed = self._govern(pde, status)
                if committed:
                    self._commit_steps(k)
                    n -= k
                    if not self._integ_commit(pde, k, rec):
                        return  # integrity rollback: the driver re-plans
                else:
                    self._integ_drop()
                if not committed or pde.get_dt() != dt_before:
                    return
            elif status is not None and status.pre_divergence:
                # sentinels without a governor: the latch goes to the
                # reactive path (exit() fires at the boundary)
                self._integ_drop()
                return
            else:
                self._commit_steps(k)
                n -= k
                if not self._integ_commit(pde, k, rec):
                    return
            if n > 0 and self._root_decides(self._interrupt is not None):
                return  # integrate()'s on_chunk acts at the boundary

    def _commit_steps(self, k: int) -> None:
        self.step += k
        _tm.counter("runner_steps_total", "committed simulation steps").inc(k)

    def _advance_lagged(self, pde, n: int, cap: int) -> None:
        """Governed sub-chunking with the next chunk dispatched before the
        previous one's sentinels are read (the lag-1 contract): a trip of
        chunk i rolls back to its start and the speculative chunk i+1 is
        discarded unresolved; a dt change decided from chunk i commits
        chunk i+1 (valid physics at the old dt; the governor rescales its
        CFL) and hands control back.  ``self.step`` counts resolved and
        committed chunks only."""
        pending: tuple | None = None
        disp_step = self.step
        while n > 0 or pending is not None:
            nxt = None
            if n > 0:
                k = min(n, cap)
                rec = self._integ_predispatch(pde, disp_step)
                chunk = self._update_pending(pde, k)
                live = pde.state_digest_async() if rec is not None else None
                nxt = (chunk, k, rec, live)
                disp_step += k
                n -= k
            if pending is not None:
                chunk, kprev, rec_p, live_p = pending
                dt_before = pde.get_dt()
                status = self._resolve_pending(pde, chunk, kprev)
                committed = self._govern(pde, status)
                if committed:
                    self._commit_steps(kprev)
                    if not self._integ_commit(pde, kprev, rec_p, live=live_p):
                        if nxt is not None:
                            nxt[0].discard()
                        return
                if not committed:
                    self._integ_drop()
                    if nxt is not None:
                        nxt[0].discard()
                    return
                if pde.get_dt() != dt_before:
                    if nxt is not None:
                        chunk2, k2, rec2, live2 = nxt
                        status2 = self._resolve_pending(pde, chunk2, k2)
                        if self._govern(pde, status2):
                            self._commit_steps(k2)
                            self._integ_commit(pde, k2, rec2, live=live2)
                        else:
                            self._integ_drop()
                    return
            pending = nxt
            if pending is not None and n > 0 and self._interrupt is not None:
                n = 0  # settle the chunk in flight, then return

    def _update_pending(self, pde, k: int):
        """The dispatch of one deferred-commit sentinel chunk: enqueue only,
        so only the clock is checked (a ``slow`` fault's stall is charged to
        the deadline); the wait for the card is :meth:`_resolve_pending`'s."""
        with _tr.span("dispatch_pending", steps=k, step=self.step):
            return dispatch_with_watchdog(lambda: pde.update_n_pending(k),
                                          self.dispatch_timeout_s,
                                          label=f"update_n_pending({k}) @ step {self.step}",
                                          stall_s=self._stall_s())

    def _resolve_pending(self, pde, chunk, k: int):
        """The watchdog-guarded resolve: a deadline polls the chunk's
        readiness (its scalars' copy event) before the fetch."""
        label = f"resolve({k}) @ step {self.step}"
        with _tr.span("resolve", steps=k, step=self.step):
            if self.dispatch_timeout_s and self.dispatch_timeout_s > 0:
                t_end = _time.monotonic() + self.dispatch_timeout_s
                while not chunk.ready():
                    if _time.monotonic() >= t_end:
                        raise _hang(label, self.dispatch_timeout_s)
                    _time.sleep(_POLL_S)
            return chunk.resolve()

    def _govern(self, pde, status) -> bool:
        """Feed one chunk's sentinel status to the governor and apply its
        decision; True when the chunk committed, False when it was rolled
        back in memory."""
        gov = self.governor
        decision = gov.on_chunk(status, step=self.step)
        _tm.gauge("governor_cfl", "chunk-max advective CFL").set(status.cfl_max)
        _tm.gauge("governor_rung", "dt-ladder rung index").set(gov.rung)
        _tm.gauge("governor_dt", "current governed dt").set(status.dt)
        if status.pre_divergence:
            _tm.counter("runner_pre_divergence_total", "CFL-ceiling sentinel catches").inc()
        self._journal({"event": "cfl", "cfl_max": status.cfl_max, "ke": status.ke,
                       "ke_growth_max": status.ke_growth_max, "div_max": status.div_max,
                       "dt": status.dt, "rung": gov.rung,
                       "pre_divergence": status.pre_divergence})
        if status.pre_divergence:
            self._journal({"event": "pre_divergence", "cfl_max": status.cfl_max,
                           "dt": status.dt, "steps_done": status.steps_done,
                           "pinned": list(status.pinned) if status.pinned else None})
            if decision.action == "retry":
                pde.set_dt(decision.dt)
                _tm.counter("runner_dt_adjust_total", "governor dt changes").inc()
                self._journal({"event": "dt_adjust", "dt": decision.dt, "rung": gov.rung,
                               "reason": decision.reason})
                pde.clear_pre_divergence()
                return False
            if decision.action == "kill_members":
                pde.mark_dead(decision.members)
                self._journal({"event": "member_killed", "members": list(decision.members),
                               "reason": decision.reason})
                if self.respawn_members and hasattr(pde, "respawn_dead"):
                    respawned = pde.respawn_dead(amp=self.respawn_amp,
                                                 seed=self._respawn_seed_arg())
                    self._journal({"event": "respawn", "respawned": respawned})
                pde.clear_pre_divergence()
                return False
            # give_up: the latch stays, integrate() breaks, and the
            # reactive checkpoint rollback takes over
            self._journal({"event": "governor_giveup", "reason": decision.reason})
            return False
        if decision.action == "adjust":
            pde.set_dt(decision.dt)
            _tm.counter("runner_dt_adjust_total", "governor dt changes").inc()
            self._journal({"event": "dt_adjust", "dt": decision.dt, "rung": gov.rung,
                           "reason": decision.reason})
        return True

    # -- integrity (integrity/) ---------------------------------------------------------

    def _integrity_on(self, pde) -> bool:
        return bool(getattr(pde, "integrity_armed", False))

    def _integrity_ledger(self):
        if self._integ_ledger is None:
            from ..integrity import QuarantineLedger

            cfg = getattr(self.pde, "integrity_config", None)
            self._integ_ledger = QuarantineLedger(
                self.run_dir, strikes=getattr(cfg, "strikes", 2),
                strike_ttl_s=getattr(cfg, "strike_ttl_s", 3600.0))
        return self._integ_ledger

    def _integ_device(self) -> str:
        """The ledger's device key ``<type>:<index>@proc<p>`` (the JAX
        package's ``<platform>:<id>@proc<p>``)."""
        from ..parallel import multihost

        dev = self._device(self.pde)
        return f"{dev.type}:{dev.index or 0}@proc{multihost.process_index()}"

    def _integ_predispatch(self, pde, start_step: int):
        """Chunk-start bookkeeping: anchor the first verified snapshot,
        stream the chunk-start digest for the chain check, and keep the
        chunk-start copy when the chunk is audit-due.  The record
        :meth:`_integ_commit` consumes, or None."""
        if not self._integrity_on(pde):
            return None
        cad = max(1, int(pde.integrity_config.resolved_cadence()))
        due = (self._integ_chunks + 1) % cad == 0
        snap = None
        if due or self._integ_verified is None:
            snap = pde.integrity_snapshot()
            if self._integ_verified is None:
                self._integ_verified = (start_step, snap)
        start_fut = pde.state_digest_async()
        return (start_step, start_fut, snap if due else None, pde.get_dt())

    def _integ_commit(self, pde, k: int, rec, live=None) -> bool:
        """Commit-side audit: stream the end digest, chain-check every
        boundary (the chunk-start digest must equal the previous commit's),
        and at the cadence re-execute the chunk from its start copy
        (``shadow``).  False when a mismatch was contained by an in-memory
        rollback."""
        if rec is None:
            return True
        start_step, start_fut, snap, disp_dt = rec
        prev = self._integ_prev
        if live is None:
            with _tr.span("integrity_digest", step=self.step):
                live = pde.state_digest_async()
        self._integ_prev = (self.step, live)
        self._integ_chunks += 1
        checks = {}
        if prev is not None and prev[0] == start_step:
            checks["chain"] = (np.asarray(prev[1].result()), np.asarray(start_fut.result()))
        if snap is not None and pde.get_dt() == disp_dt:
            with _tr.span("integrity_shadow", steps=k, step=self.step):
                d_shadow = np.asarray(pde.shadow_digest_async(snap, k).result())
            checks["shadow"] = (d_shadow, np.asarray(live.result()))
        failed = {c: p for c, p in checks.items() if not np.array_equal(*p)}
        if not _single_process():
            # one replica a process: a mismatch on any of them rolls every
            # one back, so the step counts and the collectives stay paired
            from ..parallel import multihost

            flags = multihost.allgather_host(np.int32(1 if failed else 0)).reshape(-1)
            if flags.any() and not failed:
                failed = {"peer": [int(p) for p in np.flatnonzero(flags)]}
        if failed:
            return self._integ_contain(pde, k, rec, failed)
        if snap is not None:
            self._integ_verified = (self.step, pde.integrity_snapshot())
            _tm.counter("runner_integrity_audit_total", "shadow audits passed").inc()
            self._journal({"event": "integrity_audit", "result": "ok", "chunk_steps": k,
                           "checks": sorted(checks),
                           "digest": [int(x) for x in np.asarray(live.result()).reshape(-1)]})
        return True

    def _integ_contain(self, pde, k: int, rec, failed) -> bool:
        """Containment: journal the mismatch, strike the device in the
        ledger, roll back to the last verified snapshot, or raise
        :class:`..integrity.IntegrityError` when none exists or the device
        just crossed the quarantine threshold.  On more than one process a
        replica whose own audit passed (``failed`` holds only ``"peer"``,
        the processes that failed) rolls back with the others, striking
        nothing, and every process raises when any one must."""
        from ..integrity import IntegrityError

        start_step = rec[0]
        verified = self._integ_verified
        device = self._integ_device()
        _tm.counter("runner_integrity_mismatch_total", "digest audit mismatches").inc()
        newly, members = False, None
        if "peer" in failed:
            check, where = "peer", {"processes": failed["peer"]}
        else:
            check = "chain" if "chain" in failed else "shadow"
            want, got = failed[check]
            members = [int(i) for i in np.flatnonzero(got != want)] if got.ndim else None
            where = {"members": members}
        spanning = _spanning(pde)
        if spanning:
            where["host"], device = self._integ_attribute(rec, verified, check)
        _tr.instant("integrity_mismatch", check=check, step=self.step)
        self._journal({"event": "integrity_mismatch", "check": check, "chunk_steps": k,
                       "start_step": start_step, **where, "device": device})
        if spanning:
            # one model: the root strikes the attributed device, and every
            # process takes its verdict
            if _is_root():
                newly = self._integrity_ledger().strike(device, step=self.step, detail=check)
            newly = self._root_decides(newly)
        elif check != "peer":
            newly = self._integrity_ledger().strike(device, step=self.step, detail=check)
        if newly and _is_root():
            self._journal({"event": "device_quarantined", "device": device,
                           "strikes": self._integrity_ledger().strikes_for(device)})
        self._integ_prev = None
        must_raise = verified is None or newly
        if not _single_process():
            from ..parallel import multihost

            must_raise = multihost.any_process(must_raise)
        if must_raise:
            why = ("the device crossed the quarantine threshold" if newly
                   else "no verified snapshot exists to roll back to" if verified is None
                   else "another process cannot roll back")
            raise IntegrityError(
                f"digest {check} audit failed at step {self.step} and {why}",
                check=check, step=self.step, chunk_steps=k,
                member=members[0] if members else None, device=device)
        v_step, v_snap = verified
        pde.integrity_restore(v_snap)
        self.step = v_step
        self._slo_last_step = min(self._slo_last_step, v_step)
        _tm.counter("runner_integrity_rollback_total", "in-memory integrity rollbacks").inc()
        self._journal({"event": "integrity_rollback", "to_step": v_step})
        return False

    def _integ_attribute(self, rec, verified, check: str) -> tuple:
        """On a mesh whose ranks span processes: the process whose ranks
        hold an at-rest corruption and its device key, or None and this
        process's key.  As the JAX runner (``_integ_localize_host``), only a
        chain mismatch whose chunk-start copy (corrupt) and verified
        snapshot (clean) are of the same step is attributed: each process
        compares its own ranks of the two bit for bit, and one exchange
        (collective) names the first that differs."""
        from ..parallel import multihost

        here = self._integ_device()
        differs = False
        if check == "chain" and rec[2] is not None and verified is not None and \
                verified[0] == rec[0]:
            differs = not all(_same_bits(a, b) for a, b in
                              zip(rec[2]["state"], verified[1]["state"]))
        rows = [json.loads(b) for b in multihost.allgather_bytes(
            json.dumps([differs, here]).encode("utf-8"))]
        for proc, (hit, device) in enumerate(rows):
            if hit:
                return proc, device
        return None, here

    def _integ_drop(self) -> None:
        """A chunk was rolled back in memory: restart the digest chain at the
        next commit (the verified snapshot stays valid)."""
        self._integ_prev = None

    def _dispatch(self, pde, n: int) -> None:
        fault = self.fault
        fire_at = None
        if fault is not None and not fault.fired and (
                fault.gang is None or fault.bound_gang == fault.gang):
            if self.step < fault.step <= self.step + n:
                fire_at = fault.step
            elif fault.gang is not None and fault.step <= self.step:
                fire_at = self.step
        if fire_at is None:
            self._advance(pde, n)
            return
        pre = fire_at - self.step
        if pre > 0:
            self._advance(pde, pre)
        if self.step != fire_at:
            return  # the pre-advance stopped early (signal, re-plan): fire later
        fault.fired = True
        _tr.instant("fault_injected", kind=fault.kind, step=self.step)
        row = {"event": "fault_injected", "kind": fault.kind, "host": fault.host}
        if fault.gang is not None:
            row["gang"] = fault.gang
            row["member"] = fault.member
        self._journal(row)
        if fault.kind == "nan":
            poison_state(pde, host=fault.host)
            return  # exit() fires at the boundary
        if fault.kind == "kill":
            if fault.host is None and fault.gang is None:
                os.kill(os.getpid(), signal.SIGTERM)
            elif fault.scoped_here():
                os.kill(os.getpid(), signal.SIGKILL)
        elif fault.kind == "slow":
            if fault.scoped_here():
                self._slow_pending = True
        elif fault.kind == "spike":
            spike_state(pde, self.spike_factor, host=fault.host)
            # a loud, intended mutation: restart the digest chain
            self._integ_drop()
        elif fault.kind == "bitflip":
            # silent: the digest chain is not reset, only an audit may see it
            info = bitflip_state(pde, fire_at, host=fault.host, member=fault.only_member)
            self._journal({"event": "bitflip_injected",
                           **{kk: vv for kk, vv in info.items() if kk != "index"},
                           "index": list(info["index"])})
        rem = n - pre
        if rem > 0:
            self._dispatch(pde, rem)

    def _on_chunk(self, pde) -> bool:
        # settle a deferred sharded commit first (collective: the cadence
        # decision that deferred it was the root's, so every process is here)
        self._commit_pending()
        delta = self.step - self._slo_last_step
        self._slo_last_step = self.step
        degraded = self.slo.record(delta)
        if degraded is not None:
            _tm.counter("runner_perf_degraded_total", "SLO throughput regressions").inc()
            _tr.instant("perf_degraded", **degraded)
            self._journal({"event": "perf_degraded", **degraded})
            from ..telemetry import compile_log as _cl

            capture = _cl.capture_on_perf_degraded(self.run_dir)
            if capture is not None:
                self._journal({"event": "profile_capture", **capture})
        if self._metrics_dumper is not None:
            self._metrics_dumper.maybe_dump(step=self.step)
        self._stats_boundary()
        # the root's stop and cadence verdicts: agreed with the break flag in
        # this boundary's one exchange (:meth:`_agree`); a boundary driven
        # from outside ``integrate`` (:meth:`on_boundary`) takes one handshake each
        verdict, self._verdict = self._verdict, None
        if verdict is None or verdict[0] != self.step:
            verdict = None
        if verdict[1] if verdict else self._preempt_agreed():
            return True  # integrate() returns "stopped"; run() checkpoints
        # the wall clock is host-local and the checkpoint enters a collective:
        # the decision is the root's
        if verdict[2] if verdict else self._root_decides(self._cadence_due(pde)):
            self._checkpoint("cadence")
        return False

    # -- the statistics' health stream (models/stats.py) --------------------------------

    def _stats_boundary(self) -> None:
        """Resolve the previous boundary's health future (one boundary old,
        so it waits for nothing), export its gauges and latched events, and
        enqueue a fresh readout."""
        if not getattr(self.pde, "stats_armed", False):
            self._stats_health_pending = None
            return
        fut = self._stats_health_pending
        self._stats_health_pending = None
        if fut is not None:
            try:
                self._stats_health_report(fut.result())
            except Exception:
                pass  # health telemetry never ends the run
        try:
            self._stats_health_pending = self.pde.stats_health_async()
        except Exception:
            self._stats_health_pending = None

    def _stats_health_report(self, vals) -> None:
        """Gauges and the typed events (:func:`..models.stats.health_events`:
        an ensemble's readout reduces to its worst member) from one health
        readout; an event latches until its signal falls below half its
        limit."""
        from ..models.stats import HEALTH_NAMES, health_events

        d = {}
        for name, v in zip(HEALTH_NAMES, vals):
            arr = np.asarray(v, dtype=np.float64).reshape(-1)
            red = np.min if name.startswith("bl_") else np.max
            d[name] = float(red(arr)) if arr.size else 0.0
        if d["samples"] < 1.0:
            return
        tails = {(field, axis): d[f"tail_{key}_{axis}"]
                 for field, key in (("temp", "t"), ("ux", "ux"), ("uy", "uy"))
                 for axis in ("x", "y")}
        for (field, axis), val in tails.items():
            _tm.gauge("stats_tail_energy_fraction",
                      "energy fraction in the top third of the ortho spectrum",
                      field=field, axis=axis).set(val)
        for layer, key in (("thermal", "bl_thermal_pts"), ("viscous", "bl_visc_pts")):
            _tm.gauge("stats_bl_points", "grid points inside the boundary layer",
                      layer=layer).set(d[key])
        for budget in ("ke", "nu"):
            _tm.gauge("stats_budget_residual", "budget-closure residual",
                      budget=budget).set(d[f"{budget}_residual"])
        _tm.gauge("stats_samples", "in-scan stats samples accumulated").set(d["samples"])
        eng = self.pde.stats_engine
        events = {e["event"]: e for e in health_events(eng, vals)}
        for kind, latch, value, limit, counter in (
                ("resolution_warning", "_stats_res_latched", max(tails.values()), eng.tail_warn,
                 ("stats_resolution_warnings_total", "spectral-tail under-resolution warnings")),
                ("budget_drift", "_stats_budget_latched", d["nu_residual"], eng.budget_warn,
                 ("stats_budget_drift_total", "Nu budget-closure drift warnings"))):
            if kind in events:
                if not getattr(self, latch):
                    setattr(self, latch, True)
                    _tm.counter(*counter).inc()
                    self._journal(events[kind])
            elif value < 0.5 * limit:
                setattr(self, latch, False)

    # -- divergence recovery -------------------------------------------------------------

    def _respawn_seed_arg(self):
        """The seed handed to ``respawn_dead``: the configured campaign seed
        folded with step and attempt, the ensemble's own stream (None), or
        step + attempt."""
        if self.respawn_seed is not None:
            return (int(self.respawn_seed), self.step, self.attempt)
        if getattr(self.pde, "respawn_seed", None) is not None:
            return None
        return self.step + self.attempt

    def _dt_trajectory(self) -> list:
        """Every journaled dt change as ``(event, step, dt)``."""
        traj = []
        for rec in read_journal(self.journal_path, on_error="skip"):
            dt = rec.get("dt")
            if dt is not None and rec.get("event") in ("start", "dt_restored", "dt_adjust",
                                                        "retry", "divergence"):
                traj.append((rec["event"], rec.get("step"), dt))
        return traj

    def _rollback(self) -> None:
        _tm.counter("runner_rollbacks_total", "reactive checkpoint rollbacks").inc()
        _tr.instant("rollback", step=self.step, attempt=self.attempt)
        path = self._pick_checkpoint()
        if path is None:
            raise DivergenceError(
                f"diverged at step {self.step} with no valid checkpoint in {self.run_dir!r} "
                f"to roll back to; journaled dt trajectory: {self._dt_trajectory()}")
        attrs = self._store.attrs(path)
        self._store.restore(self.pde, path)
        self.step = int(attrs.get("step", 0))
        # the restored state predates the integrity layer's chain and
        # verified snapshot: the next chunk re-anchors both
        self._integ_prev = None
        self._integ_verified = None
        self._slo_last_step = min(self._slo_last_step, self.step)
        if hasattr(self.pde, "clear_pre_divergence"):
            self.pde.clear_pre_divergence()
        # no _restore_dt: the backoff compounds from the current dt, floored
        new_dt = None
        if hasattr(self.pde, "set_dt") and 0.0 < self.dt_backoff < 1.0:
            new_dt = max(self.pde.get_dt() * self.dt_backoff, self.dt_min)
            if new_dt != float(self.pde.get_dt()):
                self.pde.set_dt(new_dt)
        if self.governor is not None:
            aligned = self.governor.align(float(self.pde.get_dt()), self.step)
            if aligned is not None:
                self.pde.set_dt(aligned)
        respawned = 0
        if self.respawn_members and hasattr(self.pde, "respawn_dead"):
            respawned = self.pde.respawn_dead(amp=self.respawn_amp, seed=self._respawn_seed_arg())
        self._last_ckpt_time = float(self.pde.get_time())
        self._last_ckpt_path = path
        self._journal({"event": "retry", "rollback_path": path,
                       "dt": float(self.pde.get_dt()) if new_dt is not None else None,
                       "dt_floor": bool(self.dt_min and new_dt == self.dt_min),
                       "respawned": respawned})

    # -- the harness loop ----------------------------------------------------------------

    @contextlib.contextmanager
    def session(self, install_signals: bool = True, resume: bool | None = None):
        """Arm the harness without the driver loop, for a caller that
        schedules its own work (:meth:`advance`, :meth:`checkpoint_now`,
        :meth:`drain_requested`): the IO pipeline, the governor, the signal
        handlers (``install_signals``), the journal handed to the model, the
        metrics dumper and the exit dump, and a resume (``resume``
        overrides the constructor's; the result is ``self.resumed``).  The
        exit settles the pipeline and restores the handlers; an exception
        leaving the block dumps the flight recorder first."""
        self.resumed = False
        if install_signals:
            self._install_signals()
        self._setup_io()
        self._stats_health_pending = None
        self._saved_pde_journal = getattr(self.pde, "journal_writer", None)
        # the journal, the metrics file and the exit dump are the root's (the
        # run directory is shared across processes)
        if _is_root():
            if self._journal_writer is None:
                self._journal_writer = JournalWriter(self.journal_path)
            self.pde.journal_writer = self._journal_writer
            if hasattr(self.pde, "model"):
                self.pde.model.journal_writer = self._journal_writer
            self._metrics_dumper = MetricsDumper(os.path.join(self.run_dir, "metrics.jsonl"))
            self._exit_disarm = _tr.arm_exit_dump(self.run_dir, lambda: self.step)
        # a collective desync dumps its flight record next to the journal
        _sanitizer.set_run_dir(self.run_dir)
        saved_reduce = getattr(self.pde, "sentinel_reduce", None)
        if not _single_process() and hasattr(self.pde, "sentinel_reduce"):
            self.pde.sentinel_reduce = _sentinels_across_processes
        try:
            if self.resume if resume is None else resume:
                self.resumed = self._maybe_resume()
            self._setup_governor()
            yield self
        except DispatchHang:
            # the card is wedged: on a mesh spanning processes a remote
            # flip waits in the stream for a peer's push with no deadline of
            # its own, so let its waits pass (the chunk runs on with stale
            # chunks; nothing of it is used after a hang); drop the lagged
            # diagnostics rather than resolve them against the card
            _release_remote_waits(self.pde)
            if self._io is not None:
                self._io.abandon_diags()
            self.incident_dump("dispatch_hang")
            raise
        except BaseException as exc:
            self.incident_dump(type(exc).__name__)
            raise
        finally:
            if hasattr(self.pde, "sentinel_reduce"):
                self.pde.sentinel_reduce = saved_reduce
            if self._exit_disarm is not None:
                self._exit_disarm()
                self._exit_disarm = None
            self._teardown_io()
            if install_signals:
                self._restore_signals()

    def incident_dump(self, reason: str) -> None:
        """Best-effort flight-recorder dump into ``run_dir`` and a journal
        row pointing at it (the root's)."""
        if not _is_root():
            return
        try:
            path = _tr.dump_flight_record(self.run_dir, reason, step=self.step)
            if path is not None:
                import re

                m = re.search(r"_n(\d+)\.json$", path)
                self._journal({"event": "flight_record", "reason": reason, "path": path,
                               "seq": int(m.group(1)) if m else None, "trace_ids": None})
        except Exception:
            pass

    def advance(self, n: int) -> None:
        """Advance up to ``n`` steps through the whole dispatch stack (fault
        injection, the watchdog, sub-chunks, the governor); ``self.step``
        counts what committed."""
        self._dispatch(self.pde, n)

    def checkpoint_now(self, reason: str = "manual") -> str | None:
        """Write a checkpoint outside the cadence."""
        return self._checkpoint(reason)

    def request_drain(self) -> None:
        """A programmatic SIGTERM: the next boundary sees
        :meth:`drain_requested`."""
        self._interrupt = signal.SIGTERM

    def drain_requested(self) -> bool:
        """Whether a signal (or :meth:`request_drain`) asked for a stop."""
        return self._preempt_agreed()

    def on_boundary(self) -> bool:
        """The chunk-boundary housekeeping ``integrate`` drives (a cadence
        checkpoint when due); True when a stop was requested."""
        return bool(self._on_chunk(self.pde))

    def run(self) -> dict:
        """Drive the model to ``max_time``, surviving what can be survived;
        returns the summary (``outcome`` ``"done"`` or ``"preempted"``)."""
        pde = self.pde
        if not self.resume and self._store.files():
            raise ValueError(f"resume=False but {self.run_dir!r} already holds checkpoints "
                             "from a previous run; clear the directory or drop resume=False")
        with self.session():
            self._journal({"event": "start", "resumed": self.resumed, "dt": float(pde.get_dt()),
                           "max_time": self.max_time, "governed": self.governor is not None,
                           "io": {"async_checkpoints": self._async_ckpt,
                                  "overlap_dispatch": self._overlap,
                                  "sharded_checkpoints": self._sharded},
                           "fault": dataclasses.asdict(self.fault) if self.fault else None})
            if self._last_ckpt_path is None:
                self._checkpoint("anchor")  # the rollback anchor
            while True:
                try:
                    status = integrate(pde, self.max_time, self.save_intervall,
                                       dispatch=self._dispatch, on_chunk=self._on_chunk,
                                       overlap=self._overlap, agree=self._agree)
                    self._verdict = None  # a boundary integrate() left unvisited
                except DispatchHang as exc:
                    self._journal({"event": "dispatch_hang", "label": exc.label,
                                   "timeout_s": exc.timeout_s})
                    raise
                if status in ("time_limit", "timestep_limit"):
                    self._checkpoint("final")
                    self._drain_io()
                    self._journal_health()
                    self._journal({"event": "done", "status": status, "nu": self._nu()})
                    return self._summary("done")
                if status == "stopped":
                    self._checkpoint("preempt")
                    self._drain_io()
                    self._journal_health()
                    self._journal({"event": "preempted", "signal": self._interrupt})
                    self.incident_dump("preempt")
                    return self._summary("preempted")
                # "break": the NaN criterion (or a catch the governor gave up on)
                self._journal({"event": "divergence", "dt": float(pde.get_dt())})
                if self.attempt >= self.max_retries:
                    self._journal({"event": "giveup", "retries": self.attempt})
                    self._journal_health()
                    raise DivergenceError(
                        f"diverged at step {self.step} and exhausted {self.max_retries} "
                        f"retries (dt now {pde.get_dt():g}); journaled dt trajectory: "
                        f"{self._dt_trajectory()}")
                self.attempt += 1
                self._rollback()

    def _agree(self, local: bool) -> bool:
        """The break criterion across processes: each holds its own replica,
        so a divergence on any of them stops every one.  The same exchange
        carries the root's stop and cadence-checkpoint flags, which the
        boundary's :meth:`_on_chunk` then acts on without a handshake of its
        own (one process: the local flags)."""
        from ..parallel import multihost

        (hit,), (stop, due) = multihost.agree_flags(
            any_of=(local,), root=(self._interrupt is not None, self._cadence_due(self.pde)))
        self._verdict = (self.step, stop, due)
        return hit

    def _cadence_due(self, pde) -> bool:
        """Whether this process's clocks say a cadence checkpoint is due."""
        if self.checkpoint_every_s is not None:
            if _time.monotonic() - self._last_ckpt_wall >= self.checkpoint_every_s:
                return True
        if self.checkpoint_every_t is not None:
            return (pde.get_time() - self._last_ckpt_time
                    >= self.checkpoint_every_t - pde.get_dt() / 2.0)
        return False

    def _setup_io(self) -> None:
        """The run's IO pipeline and checkpoint format.  ``io.sharded_
        checkpoints`` None picks the sharded two-phase format on more than
        one process and the gathered one otherwise (True or False force
        either).  Async checkpoints run in one process or sharded; the
        lagged break check (for a model with ``exit_future``) in one process
        only, since a flag resolved on per-process timing would split the
        collective sequence.  The model's ``io_pipeline`` points at the
        pipeline for the session."""
        io = self.io
        single = _single_process()
        if _spanning(self.pde) and io.sharded_checkpoints is False:
            raise ValueError("a model on a mesh whose ranks span processes checkpoints in the "
                             "sharded format (each process stages its own ranks)")
        self._sharded = bool(io.sharded_checkpoints if io.sharded_checkpoints is not None
                             else not single) and hasattr(self.pde, "snapshot_state_items")
        self._async_ckpt = bool(io.async_checkpoints and (single or self._sharded))
        self._overlap = bool(io.overlap_dispatch and single and hasattr(self.pde, "exit_future"))
        self._pending_commit = None
        self._io_snapshot_s = 0.0
        self._saved_pde_io = getattr(self.pde, "io_pipeline", None)
        if self._async_ckpt or self._overlap:
            self._io = IOPipeline(queue_depth=io.queue_depth, diag_lag=io.diag_lag,
                                  timeout_s=getattr(io, "timeout_s", None))
            self.pde.io_pipeline = self._io

    @property
    def last_checkpoint(self) -> str | None:
        """The newest written checkpoint's path (None before the first)."""
        return self._last_ckpt_path

    def drain_io(self) -> None:
        """Settle the IO pipeline (lagged diagnostics, background writes),
        surfacing the first write failure."""
        self._drain_io()

    def _drain_io(self) -> None:
        self._commit_pending()
        if self._io is not None:
            try:
                self._io.drain()
            except AsyncWriteError as exc:
                if not self._is_enospc(exc):
                    raise
                self._degrade_checkpoints(exc, "drain")
            self._journal({"event": "io_overlap", **self._io.stats(),
                           "snapshot_s": round(self._io_snapshot_s, 3),
                           "queue_depth": self.io.queue_depth, "diag_lag": self.io.diag_lag})
        if self._metrics_dumper is not None:
            self._metrics_dumper.dump(step=self.step)

    def _teardown_io(self) -> None:
        """Settle the pipeline without masking an exception in flight, stop
        its worker, and give the model back its pipeline and journal."""
        if self._io is not None:
            try:
                self._io.drain(raise_errors=False)
            finally:
                self._io.close()
        if getattr(self.pde, "io_pipeline", None) is not self._saved_pde_io:
            self.pde.io_pipeline = self._saved_pde_io
        if getattr(self.pde, "journal_writer", None) is not self._saved_pde_journal:
            self.pde.journal_writer = self._saved_pde_journal
            if hasattr(self.pde, "model"):
                self.pde.model.journal_writer = self._saved_pde_journal
        self._stats_health_pending = None
        if self._journal_writer is not None and self._journal_owned:
            self._journal_writer.close()

    def _setup_governor(self) -> None:
        """Arm the sentinels and build the governor, its ladder anchored at
        the dt the runner was built with (``dt_min`` floors it too); a
        resumed off-ladder dt is quantized onto it."""
        if self.stability is None or not hasattr(self.pde, "set_stability"):
            return
        if getattr(self.pde, "_stability", None) is not self.stability:
            self.pde.set_stability(self.stability)
        cfg = self.stability
        if cfg.dt_min is None and self.dt_min > 0.0:
            cfg = dataclasses.replace(cfg, dt_min=min(self.dt_min, self._dt0))
        self.governor = StabilityGovernor(cfg, self._dt0)
        aligned = self.governor.align(float(self.pde.get_dt()), self.step)
        if aligned is not None:
            self.pde.set_dt(aligned)
            self._journal({"event": "dt_adjust", "dt": aligned, "rung": self.governor.rung,
                           "reason": "resumed dt quantized to the governor ladder"})

    def _journal_health(self) -> None:
        """The end-of-run health row (governed runs)."""
        if self.governor is not None:
            self._journal({"event": "run_health", **self.governor.health.asdict()})

    def _summary(self, outcome: str) -> dict:
        return {
            "outcome": outcome,
            "step": self.step,
            "time": float(self.pde.get_time()),
            "dt": float(self.pde.get_dt()),
            "retries": self.attempt,
            "nu": self._nu(),
            "journal": self.journal_path,
            "checkpoint": self._last_ckpt_path,
            "health": self.governor.health.asdict() if self.governor is not None else None,
            "io": self._io.stats() if self._io is not None else None,
            "stats": (self.pde.stats_summary() if getattr(self.pde, "stats_armed", False)
                      else None),
        }

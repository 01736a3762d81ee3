"""The stepping contract Navier2D exposes (counterpart of the part of the
JAX package's ``models/campaign.py`` that the single-device DNS uses):
``time``, ``update``, ``update_n``, ``step_n``, ``get_observables``,
``exit``, the stability sentinels (``set_stability``,
``clear_pre_divergence``, ``last_chunk_status``, ``update_n_pending``), the
in-scan statistics (``set_stats`` and its family, :mod:`.stats`), the dt
rung cache (``set_dt``), and the overlapped-IO and integrity surface
(:class:`FuturesAndIntegrity`: observable and break-check futures, state
digests, shadow audits).

A chunk of steps advances a *carry*, the state and a few 0-d device
tensors, one step at a time in place (:class:`ChunkRunner`).  Each step
keeps the reference's divergence freeze: the stepped state is committed
only while the continue flag is up, and the flag drops at the first step
whose ``sum(temp)`` is not finite.  Flags and counters stay on the device,
so a chunk has no host sync.  On a CUDA device the step, the freeze and
(when armed) the sentinel reductions are captured once as a CUDA graph and
each step of a chunk replays it; on the CPU the same arithmetic runs
eagerly.  There is no eager fallback on the card: a capture or a replay
that fails raises.

The ensemble's chunks (:class:`.ensemble.NavierEnsemble`, the JAX
package's ``models/ensemble.py``) run on the same runner with a carry of
member-stacked fields and ``(K,)`` flags: ``_advance_members`` and
``_advance_members_sentinels`` keep a per-member mask (a member whose
stepped state is not finite freezes at its last finite state and stops
counting; with sentinels armed, a member over the CFL ceiling freezes too)
and every kernel launch of a step serves all members.

With the statistics engine armed the carry also holds its running sums
and its sample tick.  The tick advances on every executed step (the
freezing step included), and a step whose tick hits the stride folds one
sample of the stepped state into the sums, where that state is committed
and finite (and under the CFL ceiling in a sentinel chunk).  The sample
is not computed on the other steps: the runner holds a second graph, the
step plus the sample, which the host replays on the steps where its own
count of the tick hits the stride, and the device's ``take`` mask decides
whether the sample is added (``torch.where``, so a NaN sample never
leaks).  The host reads the device's tick once as a chunk starts and
counts from there.  A chunk rolled back by the sentinels discards its samples and
its tick with its steps.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from functools import partial

import numpy as np
import torch

from ..telemetry import compile_log
from ..utils.governor import ChunkStatus
from ..utils.jit import scan_buckets
from .stats import StatsState


#: the attribute surface of a campaign model that the workloads registry
#: validates (:func:`..workloads.registry.validate_campaign_model`): the
#: JAX package's list less its compiled-entry-point names, which the port
#: does not have
CAMPAIGN_MODEL_ATTRS = (
    "MODEL_KIND",
    "observable_names",
    "state",
    "compat_key",
    "update_n",
    "update_n_pending",
    "set_stability",
    "clear_pre_divergence",
    "set_stats",
    "stats_armed",
    "set_integrity",
    "integrity_armed",
    "state_digest_async",
    "set_dt",
    "get_dt",
    "get_time",
    "get_observables",
    "get_observables_async",
    "exit",
    "exit_future",
    "init_random",
    "snapshot_state_items",
    "snapshot_root_items",
    "apply_restored_state",
    "read",
    "write",
    "kernels",
    "_step",
    "_observables",
    "_scan_ok",
    "_scan_done_ok",
    "_scan_commit_ok",
)


def _kind_of(advance) -> str:
    """The model kind a chunk's ``advance`` steps: the ``MODEL_KIND`` of the
    object it is bound to (through any ``partial``), else ``"chunk"``."""
    fn = advance
    while isinstance(fn, partial):
        fn = fn.func
    owner = getattr(fn, "__self__", None)
    return str(getattr(owner, "MODEL_KIND", None) or "chunk")


def _health_values(vals: np.ndarray) -> tuple:
    """A fetched health vector as :meth:`StatsAndRungs.stats_health` gives
    it: floats (one model) or float arrays of shape (K,) (an ensemble)."""
    if vals.ndim == 1:
        return tuple(float(v) for v in vals)
    return tuple(vals[..., i].astype(float) for i in range(vals.shape[-1]))


#: one CUDA-graph capture, or the freeing of captured graphs, at a time in
#: a process (see :class:`ChunkRunner`)
CAPTURE_LOCK = threading.RLock()
#: graphs whose runner was finalized while another thread held
#: :data:`CAPTURE_LOCK`: freed under it by the next capture or release
_RETIRED: list = []


def _free_retired() -> None:
    """Free the retired graphs (the caller holds :data:`CAPTURE_LOCK`)."""
    while _RETIRED:
        _RETIRED.pop().reset()


#: each card's and thread's stream of the captures (:func:`_capture_stream`)
_CAPTURE_STREAMS: dict = {}


def _capture_stream(dev) -> "torch.cuda.Stream":
    """The side stream the calling thread's captures on ``dev`` warm up and
    capture on, made at its first: cuBLAS keeps a workspace (32 MiB on the
    card) for each stream it has run on for the life of the process, so a
    fresh stream a capture would add one a campaign to a serve, until the
    pool's streams were all used.  A stream a thread, so a capture on the
    warm pool's thread never shares its stream with the serving thread."""
    key = (dev, threading.get_ident())
    side = _CAPTURE_STREAMS.get(key)
    if side is None:
        side = _CAPTURE_STREAMS[key] = torch.cuda.Stream(dev)
    return side


class ChunkRunner:
    """The carry of a chunk (``carry``: the state's fields, then the
    scalars ``advance`` reads, then the statistics slots, if any) and one
    or more *variants* of ``advance(carry)``, each of which steps it once
    in place (the statistics chunk's: the step, and the step plus the
    sample).

    On the CPU :meth:`run` calls a variant eagerly.  On a CUDA device the
    constructor runs each variant once on a scratch copy of the carry on a
    side stream (each kernel wrapper then has its library loaded and its
    attributes set on the card, and every operator the step reads is on
    the device), captures one call of each on ``carry`` as a CUDA graph
    (the graphs share one memory pool: they are never replayed at once),
    and :meth:`run` replays one.  The graphs read and write the carry's
    own buffers, so consecutive replays are consecutive steps.

    Captures may run on any thread (the serving warm pool captures on a
    background thread while the serving thread replays other graphs, frees
    finished campaigns and copies counters to the host): one capture runs
    at a time in a process (:data:`CAPTURE_LOCK`), on its thread's own
    capture stream of the card (:func:`_capture_stream`) and in the
    thread-local capture mode, so another thread's device work does not
    join the capture.  Graphs are freed only under the same
    lock (:meth:`release`, which finalization calls too: a runner that dies
    while another thread captures hands its graphs to the next capture),
    and the garbage collector is off during a capture, so no graph dies
    inside one.

    ``kernels`` are the wrappers the step launches, each with a
    ``launches`` counter.  The capture launches nothing, so their counters
    are put back after it, and the launches one captured step of a variant
    made are added on every replay of it (``deltas``; ``delta`` is the
    first variant's)."""

    def __init__(self, advance, carry, kernels, n_stats: int = 0, kind: str | None = None):
        self.carry = carry
        self.device = carry[0].device
        self._advances = tuple(advance) if isinstance(advance, (tuple, list)) else (advance,)
        self._kernels = list(kernels)
        self._graphs: list = []
        self._released = False
        #: the carry's trailing statistics slots (running sums and tick)
        self.n_stats = int(n_stats)
        #: kernel launches of one step of each variant, per wrapper
        self.deltas = [[0] * len(self._kernels) for _ in self._advances]
        #: bytes the captures added to the device's reserved memory (the
        #: graphs' private pool); 0 on the CPU
        self.pool_bytes = 0
        #: the compile log's label (the model kind whose step this runs)
        self.kind = kind or _kind_of(self._advances[0])
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            self._capture()
        # the port's counterpart of a jit entry point's compile: the
        # warm-up and capture (nothing to capture on the CPU)
        compile_log.observe_entry_compile(self.kind, time.perf_counter() - t0)

    @property
    def delta(self) -> list:
        """Kernel launches of one step of the first variant, per wrapper."""
        return self.deltas[0]

    def _capture(self) -> None:
        with CAPTURE_LOCK:
            self._capture_locked()

    def _capture_locked(self) -> None:
        dev = self.device
        with torch.cuda.device(dev):
            side = _capture_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for advance in self._advances:
                    advance([t.clone() for t in self.carry])
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            # a CUDA graph that dies while another is being captured (its
            # reset frees memory) invalidates that capture: collect any
            # unreachable one now, and no collection runs until the end
            gc.collect()
            _free_retired()
            torch.cuda.empty_cache()  # as the capture does: what it reserves is its pool
            reserved = torch.cuda.memory_reserved(dev)
            pool = None
            collecting = gc.isenabled()
            gc.disable()
            try:
                self._capture_variants(side, pool)
            finally:
                if collecting:
                    gc.enable()
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def _capture_variants(self, side, pool) -> None:
        for i, advance in enumerate(self._advances):
            before = [k.launches for k in self._kernels]
            graph = torch.cuda.CUDAGraph()
            try:
                # the captures' own stream (not the class-wide default
                # capture stream another thread might hold)
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    advance(self.carry)
            except BaseException:
                # free the failed graphs here, not whenever the traceback
                # that holds them is dropped (maybe inside a later capture)
                graph.reset()
                for g in self._graphs:
                    g.reset()
                self._graphs = []
                raise
            finally:
                after = [k.launches for k in self._kernels]
                for k, n in zip(self._kernels, before):
                    k.launches = n
            self.deltas[i] = [a - b for a, b in zip(after, before)]
            self._graphs.append(graph)
            pool = graph.pool()

    def release(self, wait: bool = True) -> None:
        """Free the captured graphs under :data:`CAPTURE_LOCK`; :meth:`run`
        raises after it.  The serving scheduler calls it as a campaign
        closes (``wait``: for a capture in flight on another thread to
        end); finalization calls it without waiting, and where another
        thread holds the lock the graphs are left to the next capture or
        release to free."""
        graphs, self._graphs = getattr(self, "_graphs", None), []
        if not graphs or CAPTURE_LOCK is None:  # (None: the interpreter's exit)
            return
        self._released = True
        _RETIRED.extend(graphs)
        if CAPTURE_LOCK.acquire(blocking=wait):
            try:
                _free_retired()
            finally:
                CAPTURE_LOCK.release()

    def __del__(self):
        self.release(wait=False)

    @property
    def captured(self) -> bool:
        """Whether :meth:`run` replays CUDA graphs."""
        return bool(self._graphs)

    def run(self, n: int, variant: int = 0) -> None:
        """Advance the carry ``n`` steps of one variant.  A wrapper that
        learns of a failure off the card (a remote flip's exchange across
        hosts, ``raise_if_failed``: its peer's connection broke while an
        earlier chunk ran) raises first."""
        for k in self._kernels:
            check = getattr(k, "raise_if_failed", None)
            if check is not None:
                check()
        if not self._graphs:
            if self._released:
                raise RuntimeError("the chunk runner's graphs were released")
            for _ in range(n):
                self._advances[variant](self.carry)
            return
        graph = self._graphs[variant]
        with torch.cuda.device(self.device):
            for _ in range(n):
                graph.replay()
        for k, d in zip(self._kernels, self.deltas[variant]):
            k.launches += d * n

    def run_sampled(self, n: int, tick: int, stride: int) -> int:
        """Advance the carry ``n`` steps of a statistics chunk: the second
        variant (step and sample) on the steps where ``tick``, the host's
        count of the device's tick, reaches a multiple of ``stride``, the
        first (the step, the tick) on the others.  Returns the count
        after the ``n`` steps."""
        done = 0
        while done < n:
            plain = min((-(tick + done + 1)) % stride, n - done)
            if plain:
                self.run(plain)
                done += plain
            if done < n:
                self.run(1, variant=1)
                done += 1
        return tick + n


class StatsAndRungs:
    """What a single model and an ensemble share around their chunks: the
    chunk runners and their per-dt-rung cache (:meth:`set_dt`), and the
    statistics carry (running sums ``stats_state`` and the sample tick
    ``_stats_tick``, int32 ``(1,)``) with its readouts and snapshot rows.

    A class using it calls :meth:`_init_stats_and_rungs`, supplies
    ``dt``, ``state``, ``_stats_engine`` (the armed
    :class:`.stats.StatsEngine` or None) and :meth:`_stats_members`, and
    lists in ``_DT_ARTIFACTS`` the attributes a dt change swaps out
    (:meth:`_rebuild_dt_artifacts` rebuilds them at a first visit)."""

    #: the resilient runner's journal (the JAX package's ``journal_writer``):
    #: statistics-flow failures and warnings are appended to it when one is
    #: attached
    journal_writer = None

    #: attributes a dt change swaps out, cached per dt rung (a subclass
    #: adds whatever else dt is baked into)
    _DT_ARTIFACTS = ("_runners",)

    def _init_stats_and_rungs(self) -> None:
        # (armed, stats) -> ChunkRunner
        self._runners: dict = {}
        self._obs_cache = None  # (state, values) of the last read
        # per-rung cache of the dt-baked artifacts (set_dt), and the number
        # of times they were built (construction is the first)
        self._dt_cache: dict = {}
        self.recompile_count = 1
        self.stats_state = None
        self._stats_tick = None

    def _drop_chunks(self) -> None:
        """Forget the chunk runners (of every dt rung) and the observables
        cache: a change of the step's constants (an obstacle's factors, a
        scenario's stages or solvers, the statistics' stride, an
        ensemble's per-member factors) or of the state's fields leaves a
        captured step stale."""
        self._runners.clear()
        self._dt_cache.clear()
        self._obs_cache = None

    def release_chunks(self) -> None:
        """Free the captured graphs of every chunk runner (of every dt
        rung) now, under the capture lock (:meth:`ChunkRunner.release`):
        the serving scheduler calls it as a campaign's ensemble is let go.
        The runners stay, with their counts; running one raises."""
        for runners in [self._runners] + [c["_runners"] for c in self._dt_cache.values()]:
            for runner in runners.values():
                runner.release()

    # -- the statistics carry ----------------------------------------------------

    def _stats_runner(self, advance, carry, kernels) -> ChunkRunner:
        """A runner whose carry ends with the statistics slots (copies of
        the running sums and the tick) and whose two variants are
        ``advance`` without and with the sample."""
        carry = carry + [t.clone() for t in self.stats_state] + [self._stats_tick.clone()]
        return ChunkRunner((partial(advance, sample=False), partial(advance, sample=True)),
                           carry, kernels, n_stats=len(self.stats_state) + 1)

    def _load_stats(self, runner: ChunkRunner) -> int:
        """Copy the running sums and the tick into the runner's statistics
        slots; returns the tick, read from the device (0 without
        statistics), which :meth:`ChunkRunner.run_sampled` counts on."""
        if not runner.n_stats:
            return 0
        for buf, t in zip(runner.carry[-runner.n_stats:], (*self.stats_state, self._stats_tick)):
            buf.copy_(t)
        return int(self._stats_tick[0])

    def _unload_stats(self, runner: ChunkRunner) -> None:
        """Fresh tensors of the carry's statistics slots as the running
        sums and the tick."""
        if runner.n_stats:
            *sums, tick = (t.clone() for t in runner.carry[-runner.n_stats:])
            self.stats_state = type(self.stats_state)(*sums)
            self._stats_tick = tick

    def _drop_stats_runners(self) -> None:
        """Forget the statistics chunk runners of every dt rung."""
        for runners in [self._runners] + [c["_runners"] for c in self._dt_cache.values()]:
            for key in [key for key in runners if key[1]]:
                del runners[key]

    def reset_stats(self) -> None:
        """Zero the running sums and the tick (a fresh averaging window);
        None while the engine is disarmed."""
        if self._stats_engine is None:
            self.stats_state = self._stats_tick = None
            return
        self.stats_state = self._stats_engine.init_state(k=self._stats_members())
        self._stats_tick = torch.zeros((1,), dtype=torch.int32, device=self.stats_state[0].device)

    def _stats_members(self):
        """The statistics' leading member count (None for one model)."""
        return None

    @property
    def stats_engine(self):
        """The armed :class:`.stats.StatsEngine` (None when disarmed)."""
        return self._stats_engine

    @property
    def stats_armed(self) -> bool:
        return self._stats_engine is not None and self.stats_state is not None

    def stats_health(self) -> tuple:
        """The :data:`.stats.HEALTH_NAMES` readout of the running sums,
        fetched to the host in one transfer: floats (one model) or float
        arrays of shape (K,) (an ensemble).  Raises when disarmed."""
        return self.stats_health_async().result()

    def stats_health_async(self):
        """:meth:`stats_health` as an :class:`..utils.io_pipeline.ObservableFuture`:
        the health vector is computed and its copy to the host enqueued
        without a wait (the resilient runner resolves it one chunk boundary
        later).  Raises when disarmed."""
        from ..utils.io_pipeline import ObservableFuture

        if not self.stats_armed:
            raise RuntimeError("stats_health needs an armed stats engine (set_stats)")
        return ObservableFuture(self._stats_engine.health(self.stats_state),
                                convert=_health_values)

    def stats_summary(self) -> dict | None:
        """The health readout as a dict (None when disarmed)."""
        if not self.stats_armed:
            return None
        from .stats import HEALTH_NAMES

        return {name: (float(v) if np.ndim(v) == 0 else [float(x) for x in v])
                for name, v in zip(HEALTH_NAMES, self.stats_health())}

    def stats_warnings(self) -> list:
        """The health readout held against the engine's limits
        (``StatsConfig.tail_warn``, ``budget_warn``): the
        ``resolution_warning`` and ``budget_drift`` events that cross them
        now (:func:`.stats.health_events`), each also appended to an
        attached ``journal_writer``.  Empty when disarmed."""
        if not self.stats_armed:
            return []
        from .stats import health_events, report_stats_event

        events = health_events(self._stats_engine, self.stats_health())
        for event in events:
            report_stats_event(self, event)
        return events

    def stats_host_items(self) -> list:
        """Gathered-snapshot rows of the running sums and the tick
        (:meth:`.stats.StatsEngine.host_items`); empty when disarmed."""
        if not self.stats_armed:
            return []
        return self._stats_engine.host_items(self.stats_state, self._stats_tick)

    def apply_restored_stats(self, data: dict | None) -> None:
        """Install running sums read back from a snapshot (leaf names and
        ``tick``; :meth:`.stats.StatsEngine.restore_state`): missing leaves,
        or leaves of another resolution, restart the window at zero."""
        if not self.stats_armed:
            return
        self.stats_state, self._stats_tick = self._stats_engine.restore_state(
            data, k=self._stats_members())

    # -- the dt rung cache ---------------------------------------------------------

    def set_dt(self, dt: float) -> None:
        """Change the step size of a live model (the governor's dt ladder).

        dt is baked into the step's operators and its captured graphs, so a
        first visit to a dt rebuilds them (:meth:`_rebuild_dt_artifacts`,
        ``recompile_count`` + 1; the chunks are captured again at the next
        ``update_n``), and every rung's artifacts are cached under its dt:
        a revisit swaps the cached objects back in.  State, time and the
        statistics are untouched."""
        dt = float(dt)
        if not dt > 0.0:
            raise ValueError(f"dt must be positive, got {dt}")
        if dt == self.dt:
            return
        self._dt_cache[self.dt] = {k: getattr(self, k, None) for k in self._DT_ARTIFACTS}
        self.dt = dt
        cached = self._dt_cache.get(dt)
        if cached is not None:
            for key, value in cached.items():
                setattr(self, key, value)
        else:
            self._runners = {}
            self._rebuild_dt_artifacts()
            self.recompile_count += 1
        self._obs_cache = None

    def _rebuild_dt_artifacts(self) -> None:
        """Rebuild everything ``self.dt`` is baked into beyond the runners
        (a first visit to a dt rung), after ``self.dt`` was set."""


def global_leaves(model, state) -> tuple:
    """The leaves of a meshed ``model``'s ``state`` (its members' too), each
    leaf of a spectral space gathered to its global array: by the space's
    gather on one process, through the ring on a mesh whose ranks span
    processes (:func:`..parallel.decomp.all_gather_pencils`: one push a
    shape of leaves, no host collective)."""
    spaces = [getattr(model, f"{name}_space", None) for name in state._fields]
    if not model.mesh.spanning:
        return tuple(x if sp is None else
                     (sp.gather_spectral(x) if x.ndim == 3 else
                      torch.stack([sp.gather_spectral(m) for m in x]))
                     for sp, x in zip(spaces, state))
    from ..parallel.decomp import all_gather_pencils

    idx = [i for i, sp in enumerate(spaces) if sp is not None]
    full = all_gather_pencils([state[i] for i in idx], model.mesh, x_pencil=True)
    out = list(state)
    for i, g in zip(idx, full):
        n0, n1 = spaces[i].spectral.global_shape
        out[i] = g[..., :n0, :n1]
    return tuple(out)


class FuturesAndIntegrity:
    """What a single model and an ensemble share around the overlapped IO
    and integrity layers: the observables as a future
    (:meth:`get_observables_async`, cached per state and shared with
    :meth:`get_observables`), the break check as a future
    (:meth:`exit_future`), and the on-device state digests, shadow audits
    and in-memory snapshots of the integrity layer (:mod:`..integrity`).

    The digest of a state runs as one captured graph on a card
    (:meth:`_digest_runner`).  A class using it supplies ``state``,
    ``time``, ``_obs_cache`` (None or
    ``(state, future)``), ``_pre_div_latch``, :meth:`_observables_tensor`,
    :meth:`_convert_observables`, :meth:`_exit_of`, :meth:`_digest_fields`
    and :meth:`_shadow_state`.

    ``io_pipeline`` (an :class:`..utils.io_pipeline.IOPipeline`) routes the
    callback's IO through the background writer and the diagnostics lag
    queue; ``io_overlap`` makes :func:`..utils.integrate.integrate` check
    the break criterion one chunk late by default.  Both are off on a plain
    model."""

    io_pipeline = None
    io_overlap = False
    _integrity_cfg = None

    # -- observables as futures -------------------------------------------------

    def _observables_tensor(self):
        """The observables of the current state as one device tensor."""
        raise NotImplementedError

    def _convert_observables(self, host):
        """The caller's form of the fetched observables (numpy)."""
        raise NotImplementedError

    def get_observables_async(self):
        """The observables of the current state as an
        :class:`..utils.io_pipeline.ObservableFuture`: computed and copied
        to the host without a wait, cached per state and shared with
        :meth:`get_observables` and :meth:`exit_future`, so a boundary's
        diagnostics and break check cost one transfer."""
        from ..utils.io_pipeline import ObservableFuture

        if self._obs_cache is None or self._obs_cache[0] is not self.state:
            fut = ObservableFuture(self._observables_tensor(),
                                   convert=self._convert_observables)
            self._obs_cache = (self.state, fut)
        return self._obs_cache[1]

    def get_observables(self) -> tuple:
        """The observables (``observable_names``) of the current state,
        fetched to the host in one transfer and cached per state."""
        return self.get_observables_async().result()

    def exit_future(self):
        """:meth:`exit` as a future for the overlapped ``integrate``: a latched
        sentinel catch resolves at once; otherwise the break criterion
        rides a device readout (:meth:`_exit_of`)."""
        from ..utils.io_pipeline import immediate

        if self._pre_div_latch:
            return immediate(True)
        return self._exit_of()

    def _exit_of(self):
        """The future of the break criterion without a latch."""
        raise NotImplementedError

    # -- integrity (integrity/) ------------------------------------------------------

    def set_integrity(self, cfg) -> None:
        """Arm (an :class:`..config.IntegrityConfig`) or disarm (None) the
        integrity layer.  The digest only reads the state: stepping is the
        same, bit for bit, armed or not, and no captured graph changes."""
        self._integrity_cfg = cfg

    @property
    def integrity_config(self):
        """The armed :class:`..config.IntegrityConfig` (None: disarmed)."""
        return self._integrity_cfg

    @property
    def integrity_armed(self) -> bool:
        return self._integrity_cfg is not None

    def _need_integrity(self, what: str) -> None:
        if not self.integrity_armed:
            raise RuntimeError(f"{what} needs an armed integrity layer (set_integrity)")

    def _digest_fields(self, state) -> tuple:
        """The state's fields as the digest reads them (their global
        arrays), and the number of member dims in front."""
        raise NotImplementedError

    def _digest_runner(self, leaves, lead: int) -> ChunkRunner:
        """The digest of leaves of these shapes and dtypes as a
        :class:`ChunkRunner` whose carry is a static copy of the leaves and
        the digest word(s): on a card one captured graph (the digest is a
        few dozen small launches a leaf, too many to enqueue one by one
        after every chunk), built at the first digest of such a state.  The
        positional mixes the graph reads are built here and held by
        ``advance``, so they live as long as the runner."""
        from ..integrity.digest import digest_words, position_mixes

        key = (tuple((tuple(t.shape), t.dtype) for t in leaves), lead)
        runners = self.__dict__.setdefault("_digest_runners", {})
        runner = runners.get(key)
        if runner is None:
            carry = [t.clone(memory_format=torch.contiguous_format) for t in leaves]
            carry.append(torch.zeros(tuple(leaves[0].shape[:lead]), dtype=torch.int64,
                                     device=leaves[0].device))
            mixes = position_mixes(leaves, lead)

            def advance(c):
                c[-1].copy_(digest_words(c[:-1], lead, mixes))

            runner = runners[key] = ChunkRunner(advance, carry, [], kind="digest")
        return runner

    def _digest_future(self, state):
        from ..utils.io_pipeline import ObservableFuture

        leaves, lead = self._digest_fields(state)
        runner = self._digest_runner(leaves, lead)
        for buf, leaf in zip(runner.carry[:-1], leaves):
            buf.copy_(leaf)
        runner.run(1)
        return ObservableFuture(runner.carry[-1], convert=lambda v: v.astype(np.uint32))

    def state_digest_async(self):
        """The digest of the current state as a future: a numpy uint32 (one
        per member, shape ``(K,)``, for an ensemble), equal to the JAX
        package's digest of the same arrays."""
        self._need_integrity("state_digest_async")
        return self._digest_future(self.state)

    def digest_of_async(self, state):
        """The digest of another state (a retained chunk-start copy)."""
        self._need_integrity("digest_of_async")
        return self._digest_future(state)

    def shadow_digest_async(self, snap: dict, n: int):
        """The shadow audit: ``n`` steps from a retained
        :meth:`integrity_snapshot` through the plain chunk (the snapshot is
        not consumed), then the digest.  A live chunk of the same steps,
        sentinels or statistics armed or not, must digest equal."""
        self._need_integrity("shadow_digest_async")
        return self._digest_future(self._shadow_state(snap, int(n)))

    def _shadow_state(self, snap: dict, n: int):
        """The state ``n`` plain steps after ``snap``."""
        raise NotImplementedError

    def integrity_snapshot(self) -> dict:
        """A device copy of what an in-memory rollback restores: the state,
        the time and, when armed, the statistics' sums and tick."""
        snap = {"state": type(self.state)(*(t.clone() for t in self.state)), "time": self.time}
        if self.stats_armed:
            snap["stats"] = (type(self.stats_state)(*(t.clone() for t in self.stats_state)),
                             self._stats_tick.clone())
        return snap

    def integrity_restore(self, snap: dict) -> None:
        """Roll back to a verified :meth:`integrity_snapshot` (copied in, so
        the snapshot can be restored again)."""
        self.state = type(snap["state"])(*(t.clone() for t in snap["state"]))
        self.time = snap["time"]
        if "stats" in snap and self.stats_armed:
            sums, tick = snap["stats"]
            self.stats_state = type(sums)(*(t.clone() for t in sums))
            self._stats_tick = tick.clone()
        self._obs_cache = None
        self._pre_div_latch = False


class ShardedSurface:
    """The sharded-checkpoint surface a model and an ensemble share (the JAX
    package's ``snapshot_state_items``/``snapshot_root_items``/
    ``apply_restored_state``; :mod:`..utils.checkpoint` drives it).  A
    subclass names the model whose spaces and mesh lay its leaves out
    (``_layout_model``) and its member dims (``_layout_lead``)."""

    _layout_lead = 0

    def _layout_model(self):
        return self

    def _leaf_spaces(self) -> dict:
        """Each state leaf's pencil space on a mesh (nothing when serial)."""
        model = self._layout_model()
        if getattr(model, "mesh", None) is None:
            return {}
        return dict(model._state_fields())

    def snapshot_state_items(self) -> list:
        """``(name, leaf)`` for every leaf the sharded checkpoint carries:
        the state's fields (:class:`..utils.checkpoint.StateLeaf`, pencils
        on a mesh) and, with the statistics armed, their running sums and
        sample tick, so long averages survive a kill and resume bit for
        bit."""
        from ..utils.checkpoint import StateLeaf

        spaces = self._leaf_spaces()
        items = [(f"state/{name}", StateLeaf(getattr(self.state, name), spaces.get(name),
                                             self._layout_lead))
                 for name in self.state._fields]
        if self.stats_armed:
            items += [(f"stats/{name}", getattr(self.stats_state, name))
                      for name in self.stats_state._fields]
            items.append(("stats/tick", self._stats_tick))
        return items

    def _root_extra_items(self) -> list:
        return []

    def snapshot_root_items(self) -> list:
        """The manifest's root data: time, the parameters (an ensemble's
        bookkeeping too), and with the integrity layer armed the state's
        digest, which a restore recomputes (:meth:`_verify_restored_digest`)."""
        items = [("time", np.asarray(float(self.time), dtype=np.float64), "raw")]
        items += self._root_extra_items()
        params = getattr(self._layout_model(), "params", {}) or {}
        for key, value in params.items():
            items.append((key, np.asarray(float(value), dtype=np.float64), "raw"))
        if self.integrity_armed:
            items.append(("integrity_digest", np.asarray(self.state_digest_async().result()),
                          "raw"))
        return items

    def _place_restored(self, updates: dict):
        """The state from the assembled global leaves, laid out as the model
        holds it (each member's pencils placed as the gathered reader and
        ``convert.state_from_numpy`` place them)."""
        spaces = self._leaf_spaces()
        fields = {}
        for name in self.state._fields:
            old = getattr(self.state, name)
            arr = np.asarray(updates.pop(name))
            space = spaces.get(name)
            if space is None:
                fields[name] = torch.as_tensor(arr).to(device=old.device, dtype=old.dtype)
            elif self._layout_lead:
                fields[name] = torch.stack([space.place_spectral(a, dtype=old.dtype)
                                            for a in arr])
            else:
                fields[name] = space.place_spectral(arr, dtype=old.dtype)
        return type(self.state)(**fields)

    def _apply_restored_extra(self, root: dict) -> None:
        pass

    def apply_restored_state(self, updates: dict, attrs: dict, root: dict) -> None:
        """Install the leaves the sharded reader assembled (global host
        arrays) and the manifest's time: the statistics' leaves are split
        off first (restored exactly, or zero when the checkpoint predates
        their arming), then the state is placed, then the integrity digest
        is verified."""
        from ..utils.checkpoint import _install_state

        del attrs
        updates = dict(updates)
        if self.stats_armed:
            self.apply_restored_stats(self.stats_engine.split_restored(updates))
        _install_state(self, self._place_restored(updates))
        self._apply_restored_extra(root)
        self.time = float(np.asarray(root["time"]))
        self._obs_cache = None
        self._pre_div_latch = False
        self._verify_restored_digest(root.get("integrity_digest"))

    def _verify_restored_digest(self, expected) -> None:
        """Recompute the state digest after a (bit-exact, sharded) restore
        and compare it with the manifest's, closing the device to disk to
        device loop; a no-op when the checkpoint carries none or the
        integrity layer is disarmed."""
        if expected is None or not self.integrity_armed:
            return
        got = np.asarray(self.state_digest_async().result())
        exp = np.asarray(expected).astype(got.dtype).reshape(got.shape)
        if not np.array_equal(got, exp):
            from ..integrity import IntegrityError

            raise IntegrityError(
                f"restored state digest {got.tolist()} does not match the checkpoint manifest "
                f"digest {exp.tolist()} — the snapshot was corrupted between device and disk",
                check="checkpoint")


class CampaignModelBase(StatsAndRungs, FuturesAndIntegrity, ShardedSurface):
    """Subclasses supply ``dt``, ``dtype`` (the real working dtype; the
    state's fields may be complex), ``state`` (a NamedTuple of tensors),
    ``_step(state, with_sentinels=False)`` (with sentinels it returns
    ``(state, (cfl, ke, div_norm))``, 0-d tensors), ``_observables(state)``
    (a 1-D tensor whose index 3 is |div|), ``kernels()``, and
    ``_rebuild_dt_artifacts()`` with the ``_DT_ARTIFACTS`` it rebuilds
    (:meth:`set_dt`)."""

    #: maps a sentinel chunk's host rows (numpy, one row a scalar, members
    #: along the last axis) to the rows the chunk acts on: the resilient
    #: runner's reduction across processes, each holding its own replica
    #: (None: the local rows)
    sentinel_reduce = None

    def _init_campaign(self) -> None:
        self._init_stats_and_rungs()
        self.time = 0.0
        self._stability = None
        self._ceiling = None  # the CFL ceiling, a 0-d tensor the sentinel step reads
        self.last_chunk_status = None
        self._pre_div_latch = False
        # the statistics engine (models/stats.py): None = off
        self._stats_engine = None

    # -- one step, and the freeze ----------------------------------------------

    def update(self) -> None:
        """One step, eagerly (no freeze, no graph)."""
        self.state = self._step(self.state)
        self.time += self.dt

    def _scan_ok(self, state, lead: int = 0) -> torch.Tensor:
        """The continue criterion of a chunk, a 0-d bool tensor: the
        temperature's sum is finite (a NaN anywhere in the flow reaches
        temp within a step through buoyancy and convection; a complex sum
        is finite when both its parts are), and so is the passive scalar's,
        where the state has one (the flow never reads it, so a NaN in the
        scalar alone would not reach temp).  With ``lead`` member dims, one
        flag per member.  On a mesh the sums run over the ranks (every rank
        of a mesh whose ranks span processes, so every process takes the
        same verdict and issues the same flips)."""

        from ..parallel.decomp import all_gather_sum

        mesh = getattr(self, "mesh", None)

        def total(x):
            if mesh is not None:
                return all_gather_sum(x, mesh, lead)
            return torch.sum(x) if not lead else x.reshape(*x.shape[:lead], -1).sum(dim=-1)

        probe = total(state.temp)
        if "scal" in state._fields:
            probe = probe + total(state.scal)
        return torch.isfinite(probe)

    def _scan_done_ok(self, state, lead: int = 0) -> torch.Tensor:
        """Whether a state that stopped advancing (``_scan_ok`` False)
        stopped by success (the adjoint finder's convergence) rather than
        by divergence: never, for the DNS (a False of ``_scan_ok``'s
        shape)."""
        return torch.zeros_like(self._scan_ok(state, lead))

    def _scan_commit_ok(self, state, lead: int = 0) -> torch.Tensor:
        """Whether an ensemble member commits its stepped state: the
        continue criterion by default (a NaN state is never committed); a
        model whose ``_scan_ok`` also stops on success commits every finite
        state, so its converged state lands in the carry before the member
        freezes."""
        return self._scan_ok(state, lead)

    @staticmethod
    def _commit(fields, stepped, keep) -> None:
        """The freeze: each field of the carry takes its stepped value
        where ``keep`` (a 0-d bool, or one per member) is set and keeps its
        own otherwise."""
        for f, f2 in zip(fields, stepped):
            torch.where(keep.reshape(keep.shape + (1,) * (f.ndim - keep.ndim)), f2, f, out=f)

    def _advance(self, carry, sample=None) -> None:
        """One step of a plain chunk on ``carry = [*state, ok, done]``:
        while ``ok``, commit the stepped state and count the step; ``ok``
        drops after the first step whose state is not finite (that state
        is committed, as the reference's ``lax.cond`` commits it).  A
        frozen state is still stepped, and its result discarded: the
        reference skips the step there, but a graph has no branch, and
        the cost falls only after a divergence.

        ``sample``: None without statistics; else the carry ends with the
        statistics slots, the tick advances while ``ok``, and with
        ``sample=True`` the stepped state is sampled where it is finite and
        the tick hits the stride (:meth:`_stats_advance`)."""
        nf = len(self.state)
        stepped = self._step(type(self.state)(*carry[:nf]))
        ok2 = self._scan_ok(stepped)
        if sample is not None:
            ok = carry[nf]
            self._stats_advance(carry[nf + 2:], stepped, ok, ok & ok2, sample)
        self._freeze(carry[:nf + 2], stepped, ok2)

    def _freeze(self, carry, stepped, ok2=None) -> None:
        """The plain chunk's bookkeeping of one step: the finite check of
        ``stepped`` (``ok2``, when the caller has it), the count, the
        commit and the flag."""
        *fields, ok, done = carry
        if ok2 is None:
            ok2 = self._scan_ok(stepped)
        done.add_(ok)
        self._commit(fields, stepped, ok)
        ok.logical_and_(ok2)

    def _advance_sentinels(self, carry, sample=None) -> None:
        """One step of a sentinel chunk on ``carry = [*state, finite,
        cfl_ok, done, cfl_max, ke_growth_max, div_max, ke]``, as the
        reference's ``step_n_sent``: while ``finite and cfl_ok``, commit
        the stepped state, its flags, the step and the running maxima.  A
        NaN CFL reads as the NaN path (``NaN > ceiling`` is False), not as a
        ceiling trip.  ``sample``: as :meth:`_advance` (a sample needs the
        stepped state finite and under the ceiling)."""
        nf = len(self.state)
        fields = carry[:nf]
        fin, cok, done, cfl_max, growth_max, div_max, ke_prev = carry[nf:nf + 7]
        go = fin & cok
        stepped, (cfl, ke, div) = self._step(type(self.state)(*fields), with_sentinels=True)
        fin2 = self._scan_ok(stepped)
        cok2 = torch.logical_not(cfl > self._ceiling)
        if sample is not None:
            self._stats_advance(carry[nf + 7:], stepped, go, go & fin2 & cok2, sample)
        torch.where(go, fin2, fin, out=fin)
        torch.where(go, cok2, cok, out=cok)
        done.add_(go)
        growth = torch.where(ke_prev > 0.0, ke / ke_prev, torch.ones_like(ke))
        torch.where(go, torch.maximum(cfl_max, cfl), cfl_max, out=cfl_max)
        torch.where(go, torch.maximum(growth_max, growth), growth_max, out=growth_max)
        torch.where(go, torch.maximum(div_max, div), div_max, out=div_max)
        torch.where(go, ke, ke_prev, out=ke_prev)
        self._commit(fields, stepped, go)

    def _stats_advance(self, slots, stepped, advanced, commit, sample: bool) -> None:
        """The statistics' part of one step on ``slots = [*sums, tick]``:
        the tick advances when the step ran (``advanced``, 0-d), and with
        ``sample`` the sample of ``stepped`` is folded into the sums where
        ``commit`` (0-d, or one per member) is set and the tick is a
        multiple of the stride, as the reference's ``take``."""
        *sums, tick = slots
        tick.add_(advanced)
        if not sample:
            return
        eng = self._stats_engine
        take = commit & (torch.remainder(tick[0], eng.stride) == 0)
        new = eng.fold(StatsState(*sums), eng.sample(stepped))
        for old, nv in zip(sums, new):
            lead = take.ndim
            torch.where(take.reshape(take.shape + (1,) * (old.ndim - lead)), nv, old, out=old)

    # -- the ensemble's chunks ---------------------------------------------------

    def _advance_members(self, carry, solid=None, sample=None) -> None:
        """One step of an ensemble's plain chunk on ``carry = [*state, ok,
        done]`` (member-stacked fields, ``(K,)`` flags and counts), as the
        JAX package's ensemble chunk: a member commits its stepped state and
        counts the step while ``ok`` and the stepped state is finite; ``ok``
        drops at its first non-finite step, whose state is not committed (a
        frozen member keeps its last finite state).  Every member is
        stepped; a frozen member's result is discarded.  ``solid``: the
        members' penalization factors (:meth:`_step`).  ``sample``: as
        :meth:`_advance`, with one tick for all members (it advances while
        any member is alive) and one sample a member, folded where it
        commits."""
        nf = len(self.state)
        fields = carry[:nf]
        ok, done = carry[nf:nf + 2]
        stepped = self._step(type(self.state)(*fields), solid=solid)
        cont = ok & self._scan_ok(stepped, lead=1)
        keep = self._member_commit(ok, stepped, cont)
        if sample is not None:
            self._stats_advance(carry[nf + 2:], stepped, ok.any(), keep, sample)
        done.add_(keep)
        self._commit(fields, stepped, keep)
        ok.copy_(cont)

    def _member_commit(self, active, stepped, cont) -> torch.Tensor:
        """The members that commit their stepped state: the active ones
        whose state passes ``_scan_commit_ok``; ``cont`` (the active ones
        that go on) when the model keeps the default rule, so the DNS graph
        computes no second criterion."""
        if type(self)._scan_commit_ok is CampaignModelBase._scan_commit_ok:
            return cont
        return active & self._scan_commit_ok(stepped, lead=1)

    def _advance_members_sentinels(self, carry, solid=None, sample=None) -> None:
        """One step of an ensemble's sentinel chunk on ``carry = [*state,
        finite, cfl_ok, done, cfl_max, ke_growth_max, div_max, ke]`` (each
        scalar ``(K,)``), as the JAX package's ensemble sentinel chunk: a
        member is active while finite and under the CFL ceiling; an active
        member's flags, running maxima and kinetic energy take the step's,
        and it commits the stepped state and counts the step when that is
        finite and under the ceiling (a member over the ceiling freezes at
        its last state under it, still finite).  ``sample``: as
        :meth:`_advance_members` (the tick advances while any member is
        active)."""
        nf = len(self.state)
        fields = carry[:nf]
        fin, cok, done, cfl_max, growth_max, div_max, ke_prev = carry[nf:nf + 7]
        active = fin & cok
        stepped, (cfl, ke, div) = self._step(type(self.state)(*fields), with_sentinels=True,
                                             solid=solid)
        finite = self._scan_ok(stepped, lead=1)
        torch.where(active, finite, fin, out=fin)
        torch.where(active, torch.logical_not(cfl > self._ceiling), cok, out=cok)
        keep = self._member_commit(active, stepped, active & finite) & cok
        if sample is not None:
            self._stats_advance(carry[nf + 7:], stepped, active.any(), keep, sample)
        done.add_(keep)
        growth = torch.where(ke_prev > 0.0, ke / ke_prev, torch.ones_like(ke))
        torch.where(active, torch.maximum(cfl_max, cfl), cfl_max, out=cfl_max)
        torch.where(active, torch.maximum(growth_max, growth), growth_max, out=growth_max)
        torch.where(active, torch.maximum(div_max, div), div_max, out=div_max)
        torch.where(active, ke, ke_prev, out=ke_prev)
        self._commit(fields, stepped, keep)

    # -- the chunk runner ------------------------------------------------------

    def chunk_runner(self, armed: bool | None = None, stats: bool | None = None) -> ChunkRunner:
        """The chunk runner of the plain (``armed=False``) or the sentinel
        chunk (``True``; default: as :meth:`set_stability` left it),
        without or with the statistics (``stats``; default: as
        :meth:`set_stats` left it), built at the first call: on a CUDA
        device that warms up every kernel wrapper and captures the step
        (and, with statistics, the step plus the sample), so a caller who
        wants the capture out of a timed or counted run calls this
        first."""
        armed = self._stability is not None if armed is None else armed
        stats = self.stats_armed if stats is None else stats
        if armed and self._stability is None:
            raise RuntimeError("the sentinel chunk needs set_stability(cfg) first")
        if stats and not self.stats_armed:
            raise RuntimeError("the statistics chunk needs set_stats(cfg) first")
        runner = self._runners.get((armed, stats))
        if runner is None:
            carry = [f.clone(memory_format=torch.contiguous_format) for f in self.state]
            dev, dtype = carry[0].device, self.dtype
            # the flags (ok; or finite and cfl_ok), the step counter and, when
            # armed, the running maxima and the last step's kinetic energy
            carry += [torch.ones((), dtype=torch.bool, device=dev) for _ in range(1 + armed)]
            carry.append(torch.zeros((), dtype=torch.int32, device=dev))
            carry += [torch.zeros((), dtype=dtype, device=dev) for _ in range(4 * armed)]
            kernels = [k for ks in self.kernels().values() for k in ks]
            advance = self._advance_sentinels if armed else self._advance
            runner = self._stats_runner(advance, carry, kernels) if stats else \
                ChunkRunner(advance, carry, kernels)
            self._runners[(armed, stats)] = runner
        return runner

    def _load(self, runner: ChunkRunner, state) -> None:
        """Copy ``state`` into the runner's carry and reset its scalars
        (flags up, counters and maxima zero), with no host sync; the
        statistics slots are :meth:`_load_stats`'s."""
        nf = len(state)
        for buf, f in zip(runner.carry[:nf], state):
            buf.copy_(f)
        end = len(runner.carry) - runner.n_stats
        for t in runner.carry[nf:end]:
            if t.dtype == torch.bool:
                t.fill_(True)
            else:
                t.zero_()

    def _unload(self, runner: ChunkRunner):
        """Fresh tensors of the carry's state (a caller's reference to an
        earlier state, and the observables cache keyed on it, stay
        valid)."""
        return type(self.state)(*(t.clone() for t in runner.carry[: len(self.state)]))

    def restart_fill(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The value a restart gives a state leaf that a gathered snapshot
        does not carry (``pseu``; a scenario leaf an older file lacks):
        zero."""
        del name
        return torch.zeros_like(like)

    # -- chunks -----------------------------------------------------------------

    def step_n(self, state, n: int):
        """One bucket of ``n`` plain steps from ``state`` (the reference's
        ``_step_n``; the statistics are not touched): ``(state,
        steps_done)``, ``steps_done`` a 0-d int32 device tensor, the steps
        executed before the freeze (the first non-finite step included)."""
        runner = self.chunk_runner(armed=False, stats=False)
        self._load(runner, state)
        runner.run(n)
        return self._unload(runner), runner.carry[-1].clone()

    def update_n(self, n: int):
        """Advance ``n`` steps in the reference's bucket schedule
        (:func:`..utils.jit.scan_buckets`).  The freeze flag restarts at
        the start of every bucket, as the reference's does.  ``time``
        counts the scheduled steps, frozen or not.  With the statistics
        armed (:meth:`set_stats`) the running sums and the tick ride the
        chunk.

        With sentinels armed (:meth:`set_stability`) the flags run through
        the whole chunk, and the chunk's scalars come to the host in one
        transfer at its end.  It returns the :class:`ChunkStatus` (also
        ``last_chunk_status``), else None.  When the CFL ceiling tripped
        while the state stayed finite (``pre_divergence``), ``state``,
        ``time`` and the statistics stay at the chunk start and :meth:`exit`
        latches True until :meth:`clear_pre_divergence`."""
        if self._stability is not None:
            return self._update_n_sentinels(n)
        runner = self.chunk_runner(armed=False)
        nf = len(self.state)
        self._load(runner, self.state)
        tick = self._load_stats(runner)
        for bucket in scan_buckets(n):
            runner.carry[nf].fill_(True)
            if runner.n_stats:
                tick = runner.run_sampled(bucket, tick, self._stats_engine.stride)
            else:
                runner.run(bucket)
        self.state = self._unload(runner)
        self._unload_stats(runner)
        self.time += n * self.dt
        return None

    def _update_n_sentinels(self, n: int) -> ChunkStatus:
        return self.update_n_pending(n).resolve()

    def update_n_pending(self, n: int):
        """A sentinel chunk whose commit is decided later: the chunk is
        run, its scalars are copied to the host without a wait, ``state``,
        ``time`` and the statistics advance provisionally to its end, and
        the returned :class:`..utils.io_pipeline.PendingChunkStatus`'s
        ``resolve()`` reads the scalars and confirms the advance, or, when
        the CFL ceiling tripped on a finite state, restores the chunk start
        and latches :meth:`exit`: what :meth:`update_n` returns, one round
        trip later (``update_n`` is ``update_n_pending(n).resolve()``).

        The chunk start needs no copy of its own: the runner steps a copy
        of the state in its carry, and the model's state tensors are not
        written."""
        from ..utils.io_pipeline import PendingChunkStatus

        if self._stability is None:
            raise RuntimeError("update_n_pending needs armed stability sentinels "
                               "(set_stability)")
        self._pre_div_latch = False
        runner = self.chunk_runner(armed=True)
        nf = len(self.state)
        start = (self.state, self.time, self.stats_state, self._stats_tick)
        self._load(runner, self.state)
        tick = self._load_stats(runner)
        # the sentinel carry is not reset between buckets, so the schedule
        # does not change what the chunk computes
        if runner.n_stats:
            runner.run_sampled(n, tick, self._stats_engine.stride)
        else:
            runner.run(n)
        # float64: exact for the flags and the counts, and for the f32 maxima
        scalars = torch.stack([t.to(torch.float64) for t in runner.carry[nf:nf + 7]])
        self.state = self._unload(runner)
        self._unload_stats(runner)
        self.time += n * self.dt
        dt = self.dt

        def finish(host):
            if self.sentinel_reduce is not None:
                host = self.sentinel_reduce(np.asarray(host))
            fin, cok, done, cfl_max, growth_max, div_max, ke = host.tolist()
            fin, cok = bool(fin), bool(cok)
            pre_div = fin and not cok
            if pre_div:
                self.state, self.time, self.stats_state, self._stats_tick = start
                self._pre_div_latch = True
            status = ChunkStatus(requested=int(n), steps_done=int(done), finite=fin, cfl_ok=cok,
                                 pre_divergence=pre_div, cfl_max=cfl_max, ke=ke,
                                 ke_growth_max=growth_max, div_max=div_max, dt=dt)
            self.last_chunk_status = status
            return status

        return PendingChunkStatus(scalars, finish)

    def set_stability(self, cfg) -> None:
        """Arm (a :class:`..config.StabilityConfig`) or disarm (None) the
        stability sentinels of :meth:`update_n`.  The ceiling lives in a
        device tensor that the sentinel step reads, so a captured sentinel
        step stays valid across configs (and is kept while disarmed)."""
        if cfg is not None:
            if self._ceiling is None:
                self._ceiling = torch.full((), cfg.max_cfl, dtype=self.dtype,
                                           device=self.state[0].device)
            else:
                self._ceiling.fill_(cfg.max_cfl)
        self._stability = cfg
        self.last_chunk_status = None
        self._pre_div_latch = False

    def clear_pre_divergence(self) -> None:
        """Acknowledge a ``pre_divergence`` catch: unlatch :meth:`exit`."""
        self._pre_div_latch = False

    # -- in-scan statistics (models/stats.py) ------------------------------------

    def set_stats(self, cfg) -> None:
        """Arm (a :class:`..config.StatsConfig`) or disarm (None) the
        statistics engine: zeroed running sums and tick, the engine's
        operators built and put on the device now (a capture cannot upload
        them), and the captured statistics chunks of every dt rung dropped
        (the stride is baked into them)."""
        self._drop_stats_runners()
        if cfg is None:
            self._stats_engine = None
        else:
            from .stats import StatsEngine

            self._stats_engine = StatsEngine(self, cfg)
            # one sample builds its operators now: a capture cannot upload them
            self._stats_engine.sample(self.state)
        self.reset_stats()

    # -- observables -----------------------------------------------------------

    def get_time(self) -> float:
        return self.time

    def get_dt(self) -> float:
        return self.dt

    def reset_time(self) -> None:
        self.time = 0.0

    def _observables_tensor(self):
        return self._observables(self.state)

    @staticmethod
    def _convert_observables(host) -> tuple:
        return tuple(float(v) for v in host.tolist())

    def _exit_of(self):
        from ..utils.io_pipeline import MappedFuture

        return MappedFuture(self.get_observables_async(), lambda vals: math.isnan(vals[3]))

    def _digest_fields(self, state):
        """The fields, each gathered to its global array on a mesh (so a
        meshed state digests as the same state on one rank does)."""
        if self.mesh is None:
            return tuple(state), 0
        return global_leaves(self, state), 0

    def _shadow_state(self, snap: dict, n: int):
        return self.step_n(snap["state"], n)[0]

    def div_norm(self) -> float:
        """The divergence norm, the observable that turns non-finite first."""
        return self.get_observables()[3]

    def exit(self) -> bool:
        """Break criterion, as the reference's: a latched pre-divergence
        catch, or a NaN |div| (an infinite one does not break)."""
        if self._pre_div_latch:
            return True
        return math.isnan(self.div_norm())

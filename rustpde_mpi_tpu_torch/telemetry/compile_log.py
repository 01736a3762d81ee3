"""Compile and device attribution: where a run's non-stepping time goes
(counterpart of the JAX package's ``telemetry/compile_log.py``; the port
imports nothing of that package and reads no environment).

The seams call in, the metrics registry carries the labeled series, and
each observer returns the journal-ready row:

* :func:`observe_build`: the model-build seam
  (:func:`..workloads.registry.build_model_for_key`): build wall per
  compat key, and a recompile counter (the first build of a key in a
  process is a build, every later one a rebuild);
* :func:`observe_entry_compile`: the port's counterpart of a jit entry
  point, the capture of a :class:`..models.campaign.ChunkRunner`'s CUDA
  graphs (and the eager warm-up before it), recorded per model kind at
  every capture, so ``set_dt``'s first visit to a rung counts again;
* :func:`observe_first_chunk`, :func:`observe_warm_pool`: copies of the
  JAX package's, fed by the serving scheduler and its warm pool
  (:mod:`..serve`);
* :func:`update_device_memory_gauges`: live per-card memory from
  ``torch.cuda.memory_stats`` (no card: nothing reported, nothing fails);
* :class:`ProfilerCapture`: a bounded, single-flight ``torch.profiler``
  capture writing a Chrome trace into a directory, fired once per process
  by :func:`capture_on_perf_degraded` when the throughput monitor reports
  ``perf_degraded``.

All of it is host-side bookkeeping around seams that exist anyway.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time as _time

from . import metrics as _tm

_builds: dict[str, int] = {}  # compat-key tag -> builds in this process
_last_walls: dict[str, float] = {}  # compat-key tag -> last build wall
_warm_pool: dict[str, int] = {"hit": 0, "miss": 0, "evict": 0, "aot": 0}
_entry_compiles: dict[str, int] = {}  # model kind -> captures in this process
_lock = threading.Lock()


def key_tag(key) -> str:
    """The short stable label of a compat key (sha1, 12 hex digits), the
    JAX package's tag for the same key."""
    return hashlib.sha1(repr(tuple(key)).encode()).hexdigest()[:12]


def observe_build(key, wall_s: float, kind: str = "", phase: str = "build") -> dict:
    """Record one model build for a compat key; returns the journal row.
    Only ``phase="build"`` counts builds and rebuilds."""
    tag = key_tag(key)
    with _lock:
        if phase == "build":
            _builds[tag] = _builds.get(tag, 0) + 1
            _last_walls[tag] = wall_s
            count = _builds[tag]
        else:
            count = _builds.get(tag, 1)
    _tm.histogram("compile_build_seconds", "model build + jit wall per compat key",
                  key=tag, phase=phase).observe(wall_s)
    if phase == "build" and count > 1:
        _tm.counter("compile_recompiles_total", "model rebuilds of an already-built compat key",
                    key=tag).inc()
    return {"event": "compile_build", "key_tag": tag, "kind": kind, "phase": phase,
            "wall_s": round(wall_s, 4), "builds": count,
            "recompile": phase == "build" and count > 1}


def build_counts() -> dict:
    """Builds per key tag in this process (a copy)."""
    with _lock:
        return dict(_builds)


def last_build_wall(key) -> float:
    """The latest build wall of a compat key (0.0 when it never built)."""
    with _lock:
        return _last_walls.get(key_tag(key), 0.0)


def observe_warm_pool(event: str, key=None, k: int | None = None, **extra) -> dict:
    """Warm-pool accounting (``hit`` / ``miss`` / ``evict`` / ``aot``);
    returns the journal row."""
    with _lock:
        _warm_pool[event] = _warm_pool.get(event, 0) + 1
    _tm.counter("serve_warm_pool_events_total", "warm campaign pool events (hit/miss/evict/aot)",
                event=event).inc()
    payload = {"event": {"hit": "warm_pool_hit", "miss": "warm_pool_miss",
                         "evict": "warm_pool_evict", "aot": "aot_build"}.get(
                             event, f"warm_pool_{event}")}
    if key is not None:
        payload["key_tag"] = key_tag(key)
    if k is not None:
        payload["k"] = int(k)
    payload.update(extra)
    return payload


def warm_pool_counts() -> dict:
    """Warm-pool event counts (a copy)."""
    with _lock:
        return dict(_warm_pool)


def observe_entry_compile(model_kind: str, wall_s: float) -> None:
    """One entry-point compile: in the port, one chunk runner's warm-up and
    graph capture (a ``set_dt`` first visit captures again without a model
    rebuild, so it is counted apart from :func:`observe_build`)."""
    with _lock:
        _entry_compiles[model_kind] = _entry_compiles.get(model_kind, 0) + 1
    _tm.histogram("model_entry_compile_seconds", "entry-point hoist+jit wall per model kind",
                  model=model_kind).observe(wall_s)
    _tm.counter("model_entry_compiles_total", "entry-point compile passes per model kind",
                model=model_kind).inc()


def entry_compile_counts() -> dict:
    """Entry-point compiles (chunk-runner captures) per model kind in this
    process (a copy)."""
    with _lock:
        return dict(_entry_compiles)


def observe_first_chunk(key, wall_s: float) -> dict:
    """Time to the first chunk: campaign open to its first committed
    chunk, per compat key; returns the journal row."""
    tag = key_tag(key)
    _tm.histogram("serve_time_to_first_chunk_seconds",
                  "campaign open to first committed chunk per compat key", key=tag).observe(wall_s)
    return {"event": "first_chunk", "key_tag": tag, "wall_s": round(wall_s, 4)}


# -- device memory ------------------------------------------------------------


def update_device_memory_gauges() -> int:
    """Refresh ``device_memory_bytes_in_use`` / ``device_memory_peak_bytes``
    per CUDA card from its allocator's statistics; returns how many cards
    reported (0 without a card)."""
    from ..utils.profiling import device_memory_stats

    reported = 0
    for dev, stats in device_memory_stats().items():
        if not stats:
            continue
        reported += 1
        if "bytes_in_use" in stats:
            _tm.gauge("device_memory_bytes_in_use", "live backend memory per device",
                      device=dev).set(float(stats["bytes_in_use"]))
        peak = stats.get("peak_bytes_in_use")
        if peak is not None:
            _tm.gauge("device_memory_peak_bytes", "peak backend memory watermark per device",
                      device=dev).set(float(peak))
    return reported


# -- the torch.profiler capture -----------------------------------------------


def _profiler_fns():
    """``(start(logdir), stop())`` around one capture of
    :func:`..utils.profiling.trace` (``torch.profiler``: CPU activity, and
    CUDA activity where a card is visible); ``stop`` writes ``trace.json``
    (Chrome format) into the directory."""
    from ..utils.profiling import trace

    state = {}

    def start(logdir):
        ctx = trace(logdir)
        ctx.__enter__()
        state["ctx"] = ctx

    def stop():
        state.pop("ctx").__exit__(None, None, None)

    return start, stop


class ProfilerCapture:
    """Bounded, single-flight ``torch.profiler`` capture.

    :meth:`start` runs the capture around a sleep on a daemon thread; a
    second start while one runs is refused.  Seconds are capped at
    ``max_s``.  ``start_fn(logdir)``/``stop_fn()`` replace the profiler
    (tests)."""

    def __init__(self, start_fn=None, stop_fn=None, max_s: float = 60.0):
        self._lock = threading.Lock()
        self._busy = False
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self.max_s = float(max_s)
        self.captures = 0
        self.last: dict | None = None

    @property
    def busy(self) -> bool:
        return self._busy

    def max_seconds(self) -> float:
        return self.max_s

    def start(self, logdir: str, seconds: float, reason: str = "manual") -> dict:
        """Begin a capture; returns the status row (``started`` False with
        the reason of a refusal)."""
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            return {"started": False, "error": f"bad seconds {seconds!r}"}
        if seconds <= 0:
            return {"started": False, "error": "seconds must be positive"}
        seconds = min(seconds, self.max_seconds())
        with self._lock:
            if self._busy:
                return {"started": False, "error": "capture already running"}
            self._busy = True
        status = {"started": True, "dir": logdir, "seconds": seconds, "reason": reason}
        self.last = status
        threading.Thread(target=self._run, args=(logdir, seconds, status),
                         name="profile-capture", daemon=True).start()
        return dict(status)

    def _run(self, logdir: str, seconds: float, status: dict) -> None:
        start, stop = self._start_fn, self._stop_fn
        if start is None or stop is None:
            start, stop = _profiler_fns()
        try:
            os.makedirs(logdir, exist_ok=True)
            start(logdir)
            try:
                _time.sleep(seconds)
            finally:
                stop()
            status["done"] = True
            self.captures += 1
            _tm.counter("profiler_captures_total", "completed torch.profiler captures").inc()
        except Exception as exc:  # recorded, never raised
            status["done"] = False
            status["error"] = f"{type(exc).__name__}: {exc}"
        finally:
            with self._lock:
                self._busy = False


#: the process-wide capture the perf_degraded hook uses
CAPTURE = ProfilerCapture()

_degrade_fired = False


def capture_on_perf_degraded(run_dir: str) -> dict | None:
    """One automatic capture per process when the throughput monitor
    reports ``perf_degraded``: a short window into
    ``<run_dir>/profiles/degraded_h<p>`` (one directory a process: the run
    directory is shared).  Returns the status row on the call that started
    it, else None; a refused start keeps the shot."""
    global _degrade_fired
    if _degrade_fired or not _tm.enabled():
        return None
    from ..parallel.multihost import process_index

    logdir = os.path.join(run_dir, "profiles", f"degraded_h{process_index()}")
    status = CAPTURE.start(logdir, min(2.0, CAPTURE.max_seconds()), reason="perf_degraded")
    if status.get("started"):
        _degrade_fired = True
        return status
    return None

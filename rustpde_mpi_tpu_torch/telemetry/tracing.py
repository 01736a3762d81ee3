"""Flight-recorder tracing: Chrome/Perfetto trace events in a bounded ring
(a copy of the JAX package's ``telemetry/tracing.py``; the port imports
nothing of that package and reads no environment).

The runner's host-side seams (a chunk's dispatch and resolve, a
checkpoint's staging, the integrity digests) are wrapped in :func:`span`
context managers.  Every span lands in a process-wide ring, the *flight
recorder*, whose contents are dumped as a ``traceEvents`` JSON file
(loadable in Perfetto or ``chrome://tracing``) when something goes wrong:
a ``DispatchHang`` or ``DivergenceError``, a SIGTERM drain, any other
exception leaving a runner session, and an unclean process exit while a
session is armed (:func:`arm_exit_dump`).  The ring's size is the
recorder's ``capacity`` argument (4096 events by default); a dump never
clears it.

With tracing off (:func:`set_enabled`) :func:`span` returns one shared
no-op context manager.  An enabled span costs two ``perf_counter`` reads
and a deque append.  Spans wrap host code only and add no device work, so
a traced run steps bit for bit as an untraced one; nothing here touches a
captured CUDA graph."""

from __future__ import annotations

import json
import os
import threading
import time as _time
from collections import deque

_ENABLED = True


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool) -> None:
    """Turn span recording on or off for the process."""
    global _ENABLED
    _ENABLED = bool(flag)


class FlightRecorder:
    """Bounded ring of Chrome trace events (host side, thread-safe):
    complete spans (``ph=X``, microsecond ``ts``/``dur`` from the
    recorder's start) and instant markers (``ph=i``); ``tid`` a small
    integer per thread."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(16, int(capacity))
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._t0 = _time.perf_counter()
        self._tids: dict[int, int] = {}
        self._pid = os.getpid()
        self.dumped = 0  # dump() calls
        self._dump_seq = 0  # monotonic dump ids

    def alloc_seq(self) -> int:
        """The next dump sequence number (under the lock, so two incident
        dumps at once never share a file)."""
        with self._lock:
            self._dump_seq += 1
            return self._dump_seq

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids)
                self._tids[ident] = tid
            return tid

    def now_us(self) -> float:
        return (_time.perf_counter() - self._t0) * 1e6

    def add_complete(self, name: str, t0_us: float, dur_us: float, args=None) -> None:
        event = {"name": name, "ph": "X", "ts": round(t0_us, 3), "dur": round(dur_us, 3),
                 "pid": self._pid, "tid": self._tid()}
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)

    def add_instant(self, name: str, args=None) -> None:
        event = {"name": name, "ph": "i", "s": "g", "ts": round(self.now_us(), 3),
                 "pid": self._pid, "tid": self._tid()}
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def dump(self, path: str, reason: str = "", extra: dict | None = None) -> str:
        """Write the ring as a Perfetto-loadable trace file (a ``.tmp``
        sibling replaced over the target; the ring is kept)."""
        payload = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"reason": reason, "pid": self._pid, "capacity": self.capacity,
                          **(extra or {})},
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{self._pid}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
        self.dumped += 1
        return path


#: the process-wide recorder every span records into
RECORDER = FlightRecorder()

#: optional span-args annotator: called once per completed span, its dict
#: is merged into the span's args
_ANNOTATOR = None


def set_span_annotator(fn) -> None:
    """Install (``fn() -> dict | None``) or clear (None) the span
    annotator."""
    global _ANNOTATOR
    _ANNOTATOR = fn


class _Span:
    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: dict | None):
        self.name = name
        self.args = args or None

    def __enter__(self):
        self._t0 = RECORDER.now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        args = self.args
        if exc_type is not None:
            args = dict(args or {})
            args["error"] = exc_type.__name__
        if _ANNOTATOR is not None:
            extra = _ANNOTATOR()
            if extra:
                args = dict(args or {})
                args.update(extra)
        RECORDER.add_complete(self.name, self._t0, RECORDER.now_us() - self._t0, args)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, **args):
    """Context manager recording one complete trace event; the shared no-op
    object when tracing is off."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, args or None)


def instant(name: str, **args) -> None:
    """Record an instant marker (a fault injected, a rollback, a drain)."""
    if _ENABLED:
        RECORDER.add_instant(name, args or None)


def dump_flight_record(run_dir: str, reason: str, step: int | None = None,
                       extra: dict | None = None) -> str | None:
    """Dump the flight recorder into ``run_dir`` as
    ``flight_<reason>[_step<N>]_n<SEQ>.json`` (``SEQ`` a process-monotonic
    dump number); best effort, returns the path or None (and None while
    tracing is off).  The dump carries the trace ids of the requests on
    the card (:mod:`.reqtrace`)."""
    if not _ENABLED:
        return None
    from . import reqtrace as _reqtrace

    seq = RECORDER.alloc_seq()
    trace_ids = _reqtrace.active_ids()
    tag = reason.replace(" ", "_").replace("/", "_")
    name = f"flight_{tag}" + (f"_step{step}" if step is not None else "") + f"_n{seq:04d}.json"
    path = os.path.join(run_dir, name)
    try:
        info = dict(extra or {})
        if step is not None:
            info["step"] = step
        info["seq"] = seq
        if trace_ids:
            info["trace_ids"] = trace_ids
        return RECORDER.dump(path, reason=reason, extra=info)
    except OSError:
        return None


# -- unclean-exit arming -------------------------------------------------------

_exit_hooks: dict[int, tuple] = {}
_exit_lock = threading.Lock()
_exit_registered = False
_hook_seq = 0


def _run_exit_hooks() -> None:
    with _exit_lock:
        hooks = list(_exit_hooks.values())
        _exit_hooks.clear()
    for run_dir, step_fn in hooks:
        try:
            dump_flight_record(run_dir, "unclean_exit", step=step_fn() if step_fn else None)
        except Exception:
            pass


def arm_exit_dump(run_dir: str, step_fn=None):
    """Arm an ``atexit`` dump for an in-flight session: a process that
    exits while armed dumps the ring into ``run_dir`` with reason
    ``unclean_exit``.  Returns the disarm callable, which a session's clean
    exit calls."""
    global _exit_registered, _hook_seq
    with _exit_lock:
        if not _exit_registered:
            import atexit

            atexit.register(_run_exit_hooks)
            _exit_registered = True
        _hook_seq += 1
        token = _hook_seq
        _exit_hooks[token] = (run_dir, step_fn)

    def disarm() -> None:
        with _exit_lock:
            _exit_hooks.pop(token, None)

    return disarm

"""Per-request distributed tracing: one trace_id from HTTP admission to the
last chunk, across drains, restarts, re-buckets and fleet incarnations (a
copy of the JAX package's ``telemetry/reqtrace.py``, whose only device
call is the process index; the port imports nothing of that package and
reads no environment: the log's capacity is an argument and recording is
:func:`set_enabled`).

The flight recorder (telemetry/tracing.py) answers "what was THIS PROCESS
doing just before the incident"; this module answers the orthogonal serving
question — "what happened to THIS REQUEST", whose lifecycle spans several
campaigns, possibly several process incarnations, and (multihost) several
hosts.  Three pieces:

* **trace context** — :func:`mint` creates ``{"trace_id", "span"}`` at
  admission (:meth:`SimRequest.__post_init__` calls it, so EVERY request
  carries one); the context is a plain dict riding the durable request
  file, so it survives drain/requeue/re-bucket/restart by the same rename
  atomicity the request itself does,
* **request trace log** — a bounded per-process event list (16384
  events unless built with another ``capacity``) the serve scheduler feeds per-slot chunk
  spans into; :func:`write_campaign_trace` drains it at campaign close,
  gathers every host's events over ``multihost.allgather_bytes`` (root-only
  file write, like the journal) and drops one Perfetto ``traceEvents`` file
  per campaign next to its checkpoints,
* **assembly** — :func:`assemble_request_trace` reconstructs one request's
  full timeline (admission → queued → scheduled → N chunks → re-bucket →
  done) from the journal's lifecycle rows (absolute ``t`` stamps) plus the
  per-campaign trace files, keyed by the single trace_id — the
  ``GET /requests/<id>/trace`` endpoint serves exactly this payload.

The binding surface (:func:`bind_slots` / :func:`active_ids`) tells the
rest of the telemetry layer which requests are on the device RIGHT NOW:
flight-recorder spans are annotated with the active trace ids (see
``tracing.set_span_annotator``) and incident dumps carry them, so a chaos
soak's dump pile is attributable to requests.

Overhead contract: same as the rest of telemetry — host-side bookkeeping
only, no captured graph changes; :func:`set_enabled` (or the telemetry
master switch) turns recording off while trace ids keep being minted (ids
are durability metadata, not instrumentation).
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
import uuid

_ENABLED = True


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool) -> None:
    """Toggle request-trace recording (``telemetry.set_enabled`` calls
    this too)."""
    global _ENABLED
    _ENABLED = bool(flag)


def mint(request_id: str | None = None) -> dict:
    """A fresh trace context: ``trace_id`` names the request's whole
    lifecycle (all incarnations), ``span`` the admission root span.  The
    request id seeds nothing — ids must stay unique across re-submits of
    the same request payload."""
    del request_id
    return {"trace_id": uuid.uuid4().hex[:16], "span": uuid.uuid4().hex[:8]}


class RequestTraceLog:
    """Bounded, thread-safe event list (host-side).  Events are Chrome
    ``traceEvents`` dicts with ABSOLUTE wall-clock microsecond ``ts`` so
    events recorded by different processes/incarnations align on one
    timeline without any clock exchange beyond NTP."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = 16384
        self.capacity = max(64, int(capacity))
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self.dropped = 0

    def record(
        self,
        trace_id: str,
        name: str,
        t0_wall: float,
        dur_s: float | None = None,
        args: dict | None = None,
    ) -> None:
        event = {
            "name": name,
            "ph": "X" if dur_s is not None else "i",
            "ts": round(t0_wall * 1e6, 1),
            "pid": _host_index(),
            "tid": 0,
            "args": {"trace_id": trace_id, **(args or {})},
        }
        if dur_s is not None:
            event["dur"] = round(dur_s * 1e6, 1)
        else:
            event["s"] = "g"
        with self._lock:
            if len(self._events) >= self.capacity:
                self.dropped += 1
                return
            self._events.append(event)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def drain(self) -> list[dict]:
        with self._lock:
            out, self._events = self._events, []
            return out


#: process-wide log the serve scheduler records chunk spans into
LOG = RequestTraceLog()


def _host_index() -> int:
    from ..parallel.multihost import process_index

    return process_index()


# -- active-request binding (annotates spans + flight dumps) ------------------

_active: dict[int, str] = {}  # slot index -> trace_id
_active_lock = threading.Lock()


def bind_slots(mapping: dict) -> None:
    """Declare which trace ids are on the device right now (the scheduler
    rebinds at every chunk boundary); installs the span annotator so the
    flight recorder's dispatch/resolve/checkpoint spans carry them."""
    from . import tracing as _tr

    with _active_lock:
        _active.clear()
        _active.update({int(k): str(v) for k, v in mapping.items()})
        have = bool(_active)
    _tr.set_span_annotator(_annotate if (have and _ENABLED) else None)


def clear_active() -> None:
    bind_slots({})


def active_ids() -> list[str]:
    """The distinct active trace ids, sorted (stable for journal rows)."""
    with _active_lock:
        return sorted(set(_active.values()))


def _annotate() -> dict | None:
    ids = active_ids()
    return {"trace_ids": ids} if ids else None


def chunk_span(trace_id: str, t0_wall: float, dur_s: float, **args) -> None:
    """One slot's share of a campaign chunk (the scheduler's per-boundary
    record): a complete span on the request's own timeline."""
    if _ENABLED:
        LOG.record(trace_id, "chunk", t0_wall, dur_s, args or None)


def instant(trace_id: str, name: str, **args) -> None:
    if _ENABLED:
        LOG.record(trace_id, name, _time.time(), None, args or None)


# -- per-campaign gather + root write -----------------------------------------


def write_campaign_trace(run_dir: str, tag: str) -> str | None:
    """Drain every host's request-trace events for the closing campaign and
    (root only) write one Perfetto file under ``run_dir``.

    COLLECTIVE when recording is enabled: every host drains + allgathers
    together (the call sites are the campaign-close and drain paths, where
    the fleet is already aligned); :func:`enabled` must be set alike on
    every process, so the skip is aligned too.  Returns the
    written path on root, None elsewhere / when nothing was recorded."""
    if not _ENABLED:
        return None
    local = LOG.drain()
    from ..parallel import multihost

    blobs = multihost.allgather_bytes(json.dumps(local).encode("utf-8"))
    if not multihost.is_root():
        return None
    events: list[dict] = []
    for blob in blobs:
        try:
            events.extend(json.loads(blob.decode("utf-8")))
        except ValueError:
            continue
    if not events:
        return None
    # monotonic per-campaign-dir sequence: incarnations append, never clobber
    n = len(
        [f for f in _listdir(run_dir) if f.startswith("trace_") and f.endswith(".json")]
    )
    path = os.path.join(run_dir, f"trace_{n:04d}.json")
    payload = {
        "traceEvents": sorted(events, key=lambda e: e.get("ts", 0.0)),
        "displayTimeUnit": "ms",
        "otherData": {"campaign": tag, "hosts": len(blobs)},
    }
    try:
        os.makedirs(run_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
    except OSError:
        return None  # trace IO must never kill the campaign
    return path


def _listdir(path: str) -> list[str]:
    try:
        return os.listdir(path)
    except OSError:
        return []


# -- request-timeline assembly (GET /requests/<id>/trace) ---------------------

#: journal lifecycle rows that belong on a request's timeline
_LIFECYCLE_EVENTS = (
    "request_admitted",
    "request_scheduled",
    "request_requeued",
    "request_retry",
    "request_failed",
    "request_done",
    "bucket_dt_adjust",
)

#: rows that OPEN a queued wait / a running phase (for derived "X" spans)
_QUEUE_OPENERS = ("request_admitted", "request_requeued", "bucket_dt_adjust")
_RUN_CLOSERS = (
    "request_done",
    "request_requeued",
    "request_retry",
    "request_failed",
    "bucket_dt_adjust",
)


def _journal_trace_id(journal: list, request_id: str) -> str | None:
    """The trace_id a request's journal rows carry (None: not journaled —
    the queue's lifecycle files are the fallback source)."""
    for rec in journal:
        if rec.get("id") == request_id and rec.get("trace_id"):
            return rec["trace_id"]
    return None


def _queue_trace_id(run_dir: str, request_id: str) -> str | None:
    qroot = os.path.join(run_dir, "queue")
    for state in ("running", "done", "failed", "queued"):
        sdir = os.path.join(qroot, state)
        for name in _listdir(sdir):
            if request_id not in name or not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(sdir, name), encoding="utf-8") as fh:
                    data = json.load(fh)
            except (OSError, ValueError):
                continue
            req = data.get("request", data)
            trace = req.get("trace") or {}
            if trace.get("trace_id"):
                return trace["trace_id"]
    return None


def assemble_request_trace(run_dir: str, request_id: str) -> dict | None:
    """One request's full lifecycle as a Perfetto ``traceEvents`` payload,
    reconstructed from durable state alone (journal + per-campaign trace
    files) — so it works across any number of process incarnations and
    after every in-memory recorder is gone.  None for an unknown request."""
    from ..utils.journal import read_journal

    # ONE journal parse serves both the trace-id lookup and the lifecycle
    # rows — the file is O(whole run) and this backs a per-request endpoint
    journal = read_journal(
        os.path.join(run_dir, "journal.jsonl"), on_error="skip"
    )
    tid = _journal_trace_id(journal, request_id) or _queue_trace_id(
        run_dir, request_id
    )
    if tid is None:
        return None
    rows = [
        r
        for r in journal
        if r.get("id") == request_id
        and r.get("event") in _LIFECYCLE_EVENTS
        and isinstance(r.get("t"), (int, float))
    ]
    rows.sort(key=lambda r: r["t"])
    events: list[dict] = []
    for r in rows:
        args = {
            k: v
            for k, v in r.items()
            if k not in ("event", "t", "wall_s") and _jsonable_scalar(v)
        }
        args["trace_id"] = tid
        events.append(
            {
                "name": r["event"],
                "ph": "i",
                "s": "g",
                "ts": round(r["t"] * 1e6, 1),
                "pid": 0,
                "tid": 0,
                "args": args,
            }
        )
    # derived phases: queued waits (admission/requeue -> next scheduled) and
    # running windows (scheduled -> next terminal/requeue row)
    for i, r in enumerate(rows):
        if r["event"] in _QUEUE_OPENERS:
            nxt = _next_of(rows, i, ("request_scheduled",))
            if nxt is not None:
                events.append(_phase("queued", tid, r["t"], nxt["t"]))
        elif r["event"] == "request_scheduled":
            nxt = _next_of(rows, i, _RUN_CLOSERS)
            if nxt is not None:
                events.append(_phase("running", tid, r["t"], nxt["t"]))
    # per-campaign chunk spans carrying this trace id
    campaigns = os.path.join(run_dir, "campaigns")
    for cdir in sorted(_listdir(campaigns)):
        full = os.path.join(campaigns, cdir)
        for name in sorted(_listdir(full)):
            if not (name.startswith("trace_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(full, name), encoding="utf-8") as fh:
                    payload = json.load(fh)
            except (OSError, ValueError):
                continue
            for ev in payload.get("traceEvents", ()):
                if (ev.get("args") or {}).get("trace_id") == tid:
                    events.append(ev)
    if not events:
        return None
    t0 = min(e["ts"] for e in events)
    for e in events:
        e["ts"] = round(e["ts"] - t0, 1)
    events.sort(key=lambda e: e["ts"])
    incarnations = sum(1 for r in journal if r.get("event") == "server_start")
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "request_id": request_id,
            "trace_id": tid,
            "t0_unix": round(t0 / 1e6, 6),
            "incarnations": incarnations,
        },
    }


def _fleet_sources(run_dir: str) -> list[tuple[str, str, str]]:
    """Every journal-bearing lane of a fleet run as ``(lane, journal,
    campaigns_dir)`` triples: the root journal (single-replica runs /
    pre-fleet rows) plus one lane per ``replicas/<id>/`` subtree —
    replicas AND proxies, whoever journaled the request's rows."""
    sources = [
        (
            "root",
            os.path.join(run_dir, "journal.jsonl"),
            os.path.join(run_dir, "campaigns"),
        )
    ]
    rroot = os.path.join(run_dir, "replicas")
    for name in sorted(_listdir(rroot)):
        sub = os.path.join(rroot, name)
        if not os.path.isdir(sub):
            continue  # heartbeat files (<id>.json) live beside the dirs
        sources.append(
            (
                name,
                os.path.join(sub, "journal.jsonl"),
                os.path.join(sub, "campaigns"),
            )
        )
    return sources


def assemble_fleet_request_trace(run_dir: str, request_id: str) -> dict | None:
    """Cross-replica request timeline: one Perfetto payload stitching the
    rows every fleet process journaled about ``request_id`` — proxy
    admission, each replica's scheduled/requeued/done lifecycle, and the
    per-campaign chunk spans from whichever ``replicas/<rid>/campaigns``
    subtree ran it.  Each journal source gets its own Perfetto process
    lane (``pid``) named via metadata rows, so a request that migrated
    across replicas (lease break, preemption, autoscale retire) renders
    as a handoff between lanes.  None for an unknown request."""
    from ..utils.journal import read_journal

    sources = _fleet_sources(run_dir)
    journals = [
        (lane, read_journal(jpath, on_error="skip"), cdir)
        for lane, jpath, cdir in sources
    ]
    tid = None
    for _, journal, _ in journals:
        tid = _journal_trace_id(journal, request_id)
        if tid is not None:
            break
    tid = tid or _queue_trace_id(run_dir, request_id)
    if tid is None:
        return None
    events: list[dict] = []
    lanes: dict[int, str] = {}
    merged: list[tuple[int, dict]] = []  # (lane_pid, row) across sources
    for pid, (lane, journal, cdir) in enumerate(journals):
        rows = [
            r
            for r in journal
            if r.get("id") == request_id
            and r.get("event") in _LIFECYCLE_EVENTS
            and isinstance(r.get("t"), (int, float))
        ]
        chunk_events = []
        for sub in sorted(_listdir(cdir)):
            full = os.path.join(cdir, sub)
            for name in sorted(_listdir(full)):
                if not (name.startswith("trace_") and name.endswith(".json")):
                    continue
                try:
                    with open(
                        os.path.join(full, name), encoding="utf-8"
                    ) as fh:
                        payload = json.load(fh)
                except (OSError, ValueError):
                    continue
                for ev in payload.get("traceEvents", ()):
                    if (ev.get("args") or {}).get("trace_id") == tid:
                        chunk_events.append({**ev, "pid": pid})
        if not rows and not chunk_events:
            continue  # lane never touched this request: no empty track
        lanes[pid] = lane
        events.extend(chunk_events)
        for r in rows:
            merged.append((pid, r))
            args = {
                k: v
                for k, v in r.items()
                if k not in ("event", "t", "wall_s") and _jsonable_scalar(v)
            }
            args["trace_id"] = tid
            args["lane"] = lane
            events.append(
                {
                    "name": r["event"],
                    "ph": "i",
                    "s": "g",
                    "ts": round(r["t"] * 1e6, 1),
                    "pid": pid,
                    "tid": 0,
                    "args": args,
                }
            )
    # derived queued/running phases span lanes (admitted on a proxy,
    # scheduled on a replica): derive over the time-merged row sequence,
    # pin each phase to the lane of the row that OPENED it
    merged.sort(key=lambda pr: pr[1]["t"])
    mrows = [r for _, r in merged]
    for i, (pid, r) in enumerate(merged):
        if r["event"] in _QUEUE_OPENERS:
            nxt = _next_of(mrows, i, ("request_scheduled",))
            if nxt is not None:
                events.append({**_phase("queued", tid, r["t"], nxt["t"]), "pid": pid})
        elif r["event"] == "request_scheduled":
            nxt = _next_of(mrows, i, _RUN_CLOSERS)
            if nxt is not None:
                events.append({**_phase("running", tid, r["t"], nxt["t"]), "pid": pid})
    if not events:
        return None
    t0 = min(e["ts"] for e in events)
    for e in events:
        e["ts"] = round(e["ts"] - t0, 1)
    events.sort(key=lambda e: e["ts"])
    for pid, lane in sorted(lanes.items()):
        events.insert(
            0,
            {
                "name": "process_name",
                "ph": "M",
                "ts": 0.0,
                "pid": pid,
                "tid": 0,
                "args": {"name": lane},
            },
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "request_id": request_id,
            "trace_id": tid,
            "t0_unix": round(t0 / 1e6, 6),
            "lanes": {str(p): n for p, n in sorted(lanes.items())},
        },
    }


def _phase(name: str, tid: str, t0: float, t1: float) -> dict:
    return {
        "name": name,
        "ph": "X",
        "ts": round(t0 * 1e6, 1),
        "dur": round(max(0.0, t1 - t0) * 1e6, 1),
        "pid": 0,
        "tid": 0,
        "args": {"trace_id": tid},
    }


def _next_of(rows: list, start: int, names: tuple) -> dict | None:
    for r in rows[start + 1 :]:
        if r["event"] in names:
            return r
    return None


def _jsonable_scalar(v) -> bool:
    return isinstance(v, (str, int, float, bool)) or v is None

"""Runtime collective-sequence sanitizer (counterpart of the JAX package's
``parallel/sanitizer.py``; the port imports nothing of that package and
reads no environment: :func:`configure` takes what the JAX package reads
from ``RUSTPDE_SANITIZE``, ``_CADENCE``, ``_RING`` and ``_INJECT``).

The multi-process contract is that EVERY process executes the identical
sequence of collectives: each decision that leads into one is made by
the root and broadcast first.  A host-local decision that slips past it
leaves one process's collectives out of phase, and the symptom is a
silent wedge: every process blocked in a collective its peers never
entered.

Armed, every collective entry point of :mod:`.multihost` (``broadcast``,
``broadcast_obj`` and ``allgather_bytes`` as the JAX package's two inner
calls each, ``allgather_host``, ``sync_hosts``, ``root_decides``,
``agree_flags``) records ``(seq, kind, tag, call site,
payload schema)`` into a bounded per-process ring and a running sha256
over the whole history.  Every ``cadence`` executed collectives a
fixed-shape hash compare rides one extra ``allgather_host``.  The trigger
counts EXECUTED collectives, which stay paired across processes at the
transport level even when one process skipped a call, so the verification
exchange always pairs with itself.  On a mismatch the processes exchange
their rings and every one raises :class:`CollectiveDesyncError` naming the
first divergent call site (and dumps the flight recorder into the run
directory :func:`set_run_dir` armed), within one cadence.  Where the
transport itself paired calls of different kinds (or allgathers of
different shapes), every process sees it at that exchange: the
verification runs at once (:func:`transport_desync`), and disarmed the
error names what was paired.

Disarmed (the default), a collective costs one branch here and nothing is
recorded: runs are bit for bit the same.  The sanitizer is host code and
never touches a captured graph, so an armed run steps bit for bit as well.

Injection (tests): ``inject="skip_broadcast@<n>[:host<p>]"`` makes the
scoped process skip its ``<n>``-th broadcast entirely (no record, no
collective; :func:`.multihost.agree_flags`, which carries the root's
flags, counts as one).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
from collections import deque

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SKIP_FILES = (os.sep + "multihost.py", os.sep + "sanitizer.py")


class CollectiveDesyncError(RuntimeError):
    """The processes' collective sequences diverged.  ``seq`` is the global
    index of the first divergent record, ``sites`` maps process index to
    that process's record at ``seq`` (None where it has none, e.g. it
    skipped the call), ``site`` the first divergent call site as
    ``file:line``."""

    def __init__(self, message: str, seq: int | None = None, sites: dict | None = None,
                 site: str | None = None):
        super().__init__(message)
        self.seq = seq
        self.sites = sites or {}
        self.site = site


class _InjectPlan:
    """A parsed injection spec (strict, as :mod:`..utils.faults` is)."""

    EXPECTED = "skip_broadcast@<n>[:host<p>]"

    def __init__(self, call: int, host: int | None):
        self.call = call
        self.host = host
        self.seen = 0

    @classmethod
    def from_spec(cls, spec: str | None) -> "_InjectPlan | None":
        if not spec:
            return None
        kind, sep, rest = spec.partition("@")
        if kind != "skip_broadcast" or not sep:
            raise ValueError(f"bad sanitizer injection {spec!r}: expected {cls.EXPECTED}")
        at, hsep, host = rest.partition(":")
        if not at.isdigit():
            raise ValueError(f"bad sanitizer injection {spec!r}: bad call index {at!r}")
        hostidx = None
        if hsep:
            if not host.startswith("host") or not host[4:].isdigit():
                raise ValueError(f"bad sanitizer injection {spec!r}: bad host scope {host!r}")
            hostidx = int(host[4:])
        return cls(int(at), hostidx)


class _State:
    def __init__(self):
        self.lock = threading.RLock()
        self.enabled = False
        self.cadence = 32
        self.capacity = 256
        self.inject_spec: str | None = None
        self.run_dir: str | None = None
        self.clear()

    def clear(self):
        self.ring: deque = deque(maxlen=self.capacity)
        self.seq = 0
        self.hash = hashlib.sha256()
        # the trigger counts EXECUTED collectives (paired across processes
        # at the transport), not records: a root_decides record carries
        # intent without a transport slot of its own
        self.executed = 0
        self.last_verify_exec = 0
        self.in_verify = False
        self.records = 0
        self.verifies = 0
        self.desyncs = 0
        self.inject = _InjectPlan.from_spec(self.inject_spec)


_STATE = _State()


def configure(enabled: bool | None = None, cadence: int | None = None, ring: int | None = None,
              inject: str | None = None) -> None:
    """Set the knobs (None keeps a knob as it is; ``inject=""`` clears the
    injection) and clear the history.  The defaults: disarmed, cadence 32,
    a ring of 256 records, no injection."""
    st = _STATE
    _InjectPlan.from_spec(inject)  # strict parse before anything changes
    with st.lock:
        if enabled is not None:
            st.enabled = bool(enabled)
        if cadence is not None:
            st.cadence = max(1, int(cadence))
        if ring is not None:
            st.capacity = max(8, int(ring))
        if inject is not None:
            st.inject_spec = inject or None
        st.clear()


def enabled() -> bool:
    return _STATE.enabled


def set_enabled(flag: bool) -> None:
    """Arm or disarm in-process, keeping the history."""
    _STATE.enabled = bool(flag)


def reset() -> None:
    """Clear the ring and the counters and re-arm the injection plan (a
    fresh run that wants a clean sequence history)."""
    with _STATE.lock:
        _STATE.clear()


def set_run_dir(path: str | None) -> None:
    """Where a desync dumps the flight record (the runner arms this with
    its own run directory)."""
    _STATE.run_dir = path


def stats() -> dict:
    """This process's counters: records, verifies, desyncs, seq."""
    st = _STATE
    return {"enabled": st.enabled, "records": st.records, "executed": st.executed,
            "verifies": st.verifies, "desyncs": st.desyncs, "seq": st.seq,
            "cadence": st.cadence}


def np_schema(value) -> str:
    """The payload's schema: dtype and shape (the same on every process
    while they are in step; values may differ, shapes may not)."""
    try:
        a = np.asarray(value)
        return f"{a.dtype}{list(a.shape)}"
    except Exception:
        return type(value).__name__


def _call_site() -> str:
    """The first stack frame outside multihost.py and sanitizer.py, relative
    to the repository (every process runs the same tree)."""
    frame = sys._getframe(1)
    while frame is not None:
        fname = frame.f_code.co_filename
        if not fname.endswith(_SKIP_FILES):
            try:
                rel = os.path.relpath(fname, _REPO_ROOT)
            except ValueError:
                rel = fname
            if not rel.startswith(".."):
                fname = rel
            return f"{fname}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


def skip_broadcast_injected() -> bool:
    """Whether the injection plan says THIS broadcast is skipped on THIS
    process."""
    plan = _STATE.inject
    if plan is None:
        return False
    with _STATE.lock:
        plan.seen += 1
        if plan.seen != plan.call:
            return False
    if plan.host is None:
        return True
    from .multihost import process_index

    return process_index() == plan.host


def record(kind: str, tag: str = "", payload=None) -> None:
    """Append one collective record to the ring and the running hash.
    Disarmed (or inside the verification exchange) it returns at once; the
    payload schema is computed after that branch."""
    st = _STATE
    if not st.enabled or st.in_verify:
        return
    schema = np_schema(payload) if payload is not None else ""
    site = _call_site()
    with st.lock:
        st.seq += 1
        st.records += 1
        st.ring.append({"seq": st.seq, "kind": kind, "tag": tag, "site": site,
                        "schema": schema})
        st.hash.update(f"{st.seq}|{kind}|{tag}|{site}|{schema}".encode("utf-8", "replace"))


def _hash_words() -> tuple[int, int]:
    digest = _STATE.hash.digest()
    return int.from_bytes(digest[:8], "big"), int.from_bytes(digest[8:16], "big")


def _gather(value):
    """The verification exchange: one ``allgather_host`` under the
    multi-process timeout (a peer that died mid-window becomes a
    ``DispatchHang``, not a wedge)."""
    from . import multihost

    return multihost._watched(lambda: multihost.allgather_host(value), None,
                              "sanitizer_verify")


def maybe_verify() -> None:
    """The cadenced verification, called by :mod:`.multihost` after each
    EXECUTED collective: every process crosses the cadence after the same
    paired collective, so the exchange pairs with itself even when the
    recorded sequences already diverged."""
    st = _STATE
    if not st.enabled or st.in_verify:
        return
    st.executed += 1
    if st.executed - st.last_verify_exec < st.cadence:
        return
    verify()


def verify() -> None:
    """One verification round: the fixed-shape hash compare; on a mismatch
    exchange the rings, locate the first divergent record, dump the flight
    recorder and raise :class:`CollectiveDesyncError` on EVERY process."""
    st = _STATE
    if not st.enabled or st.in_verify:
        return
    from .multihost import process_count

    if process_count() == 1:
        st.last_verify_exec = st.executed
        return
    st.in_verify = True
    try:
        st.verifies += 1
        st.last_verify_exec = st.executed
        h0, h1 = _hash_words()
        rows = np.asarray(_gather(np.array([st.seq, h0, h1], dtype=np.uint64)))
        if bool((rows == rows[0]).all()):
            return
        st.desyncs += 1
        _raise_desync(rows)
    finally:
        st.in_verify = False


def transport_desync(paired: str) -> None:
    """The transport paired calls that differ (``paired`` names each
    process's side); every process sees the same envelopes, so every one
    gets here at the same exchange.  Armed, the verification runs at once
    and raises the located report; disarmed (or when the recorded
    sequences agree) the error names what was paired."""
    st = _STATE
    if st.enabled and not st.in_verify:
        verify()
    st.desyncs += 1
    raise CollectiveDesyncError(f"collective sequence desync: the transport paired {paired} "
                                "— a host-local decision reached a collective without going "
                                "through root_decides/broadcast_obj")


def _raise_desync(rows) -> None:
    """The rings ride a second (length-padded) exchange; every process runs
    the same comparison on the same gathered rings, so every one raises the
    same diagnosis."""
    payload = json.dumps(list(_STATE.ring)).encode("utf-8")
    lengths = np.asarray(_gather(np.int64(len(payload)))).reshape(-1)
    width = int(lengths.max())
    buf = np.zeros(width, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    gathered = np.asarray(_gather(buf)).astype(np.uint8)
    rings: dict[int, dict[int, dict]] = {}
    for proc in range(gathered.shape[0]):
        raw = gathered[proc, : int(lengths[proc])].tobytes().decode("utf-8")
        rings[proc] = {e["seq"]: e for e in json.loads(raw)}
    # compare only the COMMON seq window: where the processes recorded
    # different amounts their rings evicted at different points
    lo = max((min(r) for r in rings.values() if r), default=0)
    all_seqs = sorted(s for s in set().union(*[set(r) for r in rings.values()]) if s >= lo)
    first_seq, sites = None, {}
    for seq in all_seqs:
        entries = {p: rings[p].get(seq) for p in rings}
        keys = {p: (e["kind"], e["tag"], e["site"], e["schema"]) if e else None
                for p, e in entries.items()}
        if len(set(keys.values())) > 1:
            first_seq, sites = seq, entries
            break
    if first_seq is None:
        counts = ", ".join(f"host{int(p)}: seq={int(rows[p][0])}" for p in range(len(rows)))
        message = ("collective sequences diverged BEFORE the ring window "
                   f"({counts}); configure a larger ring or a smaller cadence to catch the "
                   "first divergent call")
        site = None
    else:
        parts = []
        for p in sorted(sites):
            e = sites[p]
            parts.append(f"host{p}: {e['kind']}[{e['tag']}] at {e['site']} ({e['schema']})"
                         if e else f"host{p}: <no collective recorded at seq {first_seq}>")
        site = next((e["site"] for e in sites.values() if e), None)
        message = (f"collective sequence desync at global call #{first_seq}: "
                   + "; ".join(parts)
                   + " — a host-local decision reached a collective without going through "
                   "root_decides/broadcast_obj")
    try:
        from ..telemetry import tracing

        tracing.instant("collective_desync", seq=first_seq, site=site)
        # dump only into an armed run directory: bare multihost use must not
        # litter the working directory
        if _STATE.run_dir:
            tracing.dump_flight_record(_STATE.run_dir, "collective_desync",
                                       extra={"seq": first_seq, "site": site})
    except Exception:
        pass
    raise CollectiveDesyncError(message, seq=first_seq, sites=sites, site=site)

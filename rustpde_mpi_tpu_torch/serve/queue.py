"""Durable on-disk request queue with admission control (a copy of the
JAX package's ``serve/queue.py``: the same rows on disk, so either package
reads the other's queue directory).

One JSON file per request, one directory per lifecycle state::

    <root>/queued/<seq>-<id>.json     FIFO order rides the seq prefix
    <root>/running/<id>.json          claimed by a campaign slot
    <root>/done/<id>.json             request + result record
    <root>/failed/<id>.json           request + terminal RequestFailed record

Every transition is ``os.replace`` of a file that was fsynced at admission
— atomic on POSIX — so a crash at ANY point leaves each request in exactly
one state: the durability story is the filesystem's rename atomicity, not
a database.  The parent lifecycle DIRECTORY is fsynced after each rename
too: ``os.replace`` alone leaves the new directory entry in the page cache,
so a power loss right after an acknowledged submit (or a claim) could
silently undo the rename — the request-never-lost guarantee needs the
directory inode durable, not just the file bytes.  Restart-time :meth:`recover` re-enqueues whatever was left in
``running/`` (the campaign that claimed it died), which is the "accepted
requests are never lost" half of the serve contract; the scheduler's
checkpoint + journal restore the *progress* half.

Admission control is the queue's job too: :meth:`submit` rejects — with a
typed :class:`.request.AdmissionError` naming the
reason — once ``max_queue`` requests are waiting, so a client burst
degrades into clean 429-style rejections instead of an OOM or an unbounded
latency tail.  All public methods are thread-safe (the HTTP front submits
from handler threads while the scheduler claims from the campaign loop).
"""

from __future__ import annotations

import bisect
import errno
import hashlib
import json
import os
import threading
import time

from .request import AdmissionError, RequestError, SimRequest
from ..utils.fsutil import atomic_write_text, fsync_dir

_STATES = ("queued", "running", "done", "failed")


# shared durability primitives (utils/fsutil): os.replace alone leaves
# the new dirent in page cache — the request-never-lost guarantee would
# rest on the filesystem journaling renames by luck
_fsync_dir = fsync_dir
_atomic_write = atomic_write_text


class DurableQueue:
    """The on-disk request queue (see module docstring)."""

    def __init__(self, root: str, max_queue: int = 256):
        self.root = root
        self.max_queue = int(max_queue)
        self._lock = threading.RLock()
        self._seq = 0  # in-process tiebreak under one time.time_ns() tick
        # queued-dir scan cache: the scheduler consults the queue several
        # times per chunk boundary (bucket order, fairness probe, claims)
        # and each consult was an O(all files) listdir + a JSON parse per
        # file — a 10k-deep queue taxed every boundary.  The listing is
        # kept incrementally coherent across own mutations (enqueue
        # inserts, claim/recover evict, a lost claim race invalidates);
        # queued files are immutable once placed (a requeue writes a NEW
        # seq-name), so parsed requests are cached by name too.  External
        # writers (fleet proxies, peer replicas over the shared dir) are
        # handled by invalidate() + the claim-race eviction path.
        self._listing: list[str] | None = None
        self._req_cache: dict[str, SimRequest] = {}
        for state in _STATES:
            os.makedirs(os.path.join(root, state), exist_ok=True)

    def _dir(self, state: str) -> str:
        return os.path.join(self.root, state)

    # -- admission ------------------------------------------------------------

    def submit(self, req: SimRequest, *, admit_open: bool = True) -> SimRequest:
        """Validate + admit one request into ``queued/``.

        Raises :class:`RequestError` (malformed — never admitted) or
        :class:`AdmissionError` (``queue_full`` backpressure, ``draining``
        when the owning service flipped ``admit_open`` off, or
        ``storage_full`` when the durable write itself hit ENOSPC — an
        un-fsyncable admission must never be acknowledged).
        Returns the request with its id/submit-time stamped.

        **Idempotent retries**: a request carrying an ``idempotency_key``
        already present in the durable dedupe index is NOT re-enqueued —
        the returned request bears the ORIGINAL submit's id/trace and
        ``req.deduped`` is set, so the front replays the original ack.
        The dedupe check runs BEFORE every admission bound: a retry of
        already-accepted work must get its ack back even through a full
        queue or a draining service."""
        req.validate()
        with self._lock:
            key = getattr(req, "idempotency_key", None)
            if key:
                prior = self.dedupe_lookup(key)
                if prior is not None:
                    return self._dedupe_into(req, prior)
            if not admit_open:
                raise AdmissionError(
                    "draining",
                    "the service is draining and admits no new work",
                    retry_after_s=30.0,
                )
            if len(self._queued_files()) >= self.max_queue:
                raise AdmissionError(
                    "queue_full",
                    f"{self.max_queue} requests already queued; retry with "
                    "backoff",
                    retry_after_s=5.0,
                )
            try:
                self._enqueue(req)
            except OSError as exc:
                if exc.errno == errno.ENOSPC:
                    raise AdmissionError(
                        "storage_full",
                        "the queue volume has no space left; admission "
                        "refused until storage is reclaimed",
                        retry_after_s=30.0,
                    ) from exc
                raise
            if key:
                winner = self._idem_claim(req)
                if winner is not None and winner.get("id") != req.id:
                    # lost a concurrent same-key race by one dirent:
                    # withdraw our duplicate and answer with the winner
                    self._withdraw_queued(req.id)
                    return self._dedupe_into(req, winner)
        return req

    # -- idempotency (the dedupe index) ---------------------------------------

    def _idem_dir(self) -> str:
        return os.path.join(self.root, "idempotency")

    def _idem_path(self, key: str) -> str:
        digest = hashlib.sha256(key.encode("utf-8")).hexdigest()[:40]
        return os.path.join(self._idem_dir(), f"{digest}.json")

    def dedupe_lookup(self, key) -> dict | None:
        """The durable index record for one idempotency key — ``{"id",
        "trace_id", "key"}`` of the submit that claimed it — or None for
        an unseen (or falsy) key."""
        if not key:
            return None
        try:
            with open(self._idem_path(key), encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def _idem_claim(self, req: SimRequest) -> dict | None:
        """Claim ``req``'s key in the index via O_EXCL dirent creation —
        exactly one of N racing same-key submits wins.  Returns None on a
        win, the winner's record on a loss.  The index is written AFTER
        the enqueue: a crash between the two degrades to at-least-once
        (the retry re-runs the physics — a dup result, never a lost or
        ghost request), which is the right failure direction.  An index
        write that itself fails is swallowed the same way."""
        path = self._idem_path(req.idempotency_key)
        record = {
            "id": req.id,
            "trace_id": req.trace_id,
            "key": req.idempotency_key,
        }
        try:
            os.makedirs(self._idem_dir(), exist_ok=True)
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL)
        except FileExistsError:
            return self.dedupe_lookup(req.idempotency_key)
        except OSError:
            return None  # degraded: no index entry, dedupe waived
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                fh.write(json.dumps(record, sort_keys=True))
                fh.flush()
                os.fsync(fh.fileno())
            _fsync_dir(self._idem_dir())
        except OSError:
            pass
        return None

    def _dedupe_into(self, req: SimRequest, prior: dict) -> SimRequest:
        """Rewrite ``req`` into the original submit's identity so the
        caller's ack (id/steps/trace_id) replays the first answer; the
        ``deduped`` marker tells fronts to journal ``request_deduped``
        instead of admitting."""
        req.deduped = True
        req.id = prior.get("id") or req.id
        if prior.get("trace_id"):
            req.trace = {"trace_id": prior["trace_id"]}
        return req

    def _withdraw_queued(self, request_id: str) -> None:
        """Remove our just-enqueued file for ``request_id`` (the loser of
        an idempotency race): the winner's copy is the one true submit."""
        for name in list(self._queued_files()):
            if name.endswith(f"-{request_id}.json"):
                try:
                    os.remove(os.path.join(self._dir("queued"), name))
                except OSError:
                    pass
                self._evict(name)

    def _enqueue(self, req: SimRequest) -> None:
        """Write the queued file (caller holds the lock).  The FIRST durable
        enqueue stamps ``enqueued_s`` — the admission-to-first-observable
        histogram's clock start; requeues (drain/retry/re-bucket) keep it."""
        if not req.enqueued_s:
            req.enqueued_s = time.time()
        self._seq += 1
        name = f"{time.time_ns():020d}{self._seq:04d}-{req.id}.json"
        _atomic_write(os.path.join(self._dir("queued"), name), req.to_json())
        if self._listing is not None:
            bisect.insort(self._listing, name)
        self._req_cache[name] = req

    def _state_files(self, state: str) -> list[str]:
        """Committed request files only: a crash inside ``_atomic_write``
        can leave ``*.tmp`` corpses next to them, which must never count
        toward admission, scheduling or the lifecycle totals."""
        try:
            return sorted(
                n for n in os.listdir(self._dir(state)) if n.endswith(".json")
            )
        except OSError:
            return []

    def _queued_files(self) -> list[str]:
        if self._listing is None:
            self._listing = self._state_files("queued")
            self._req_cache = {
                n: r for n, r in self._req_cache.items() if n in set(self._listing)
            }
        return self._listing

    def _evict(self, name: str) -> None:
        """Drop one name from the cached listing (claimed/raced away)."""
        if self._listing is not None:
            try:
                self._listing.remove(name)
            except ValueError:
                pass
        self._req_cache.pop(name, None)

    def invalidate(self) -> None:
        """Forget the cached queued-dir listing: the next scan re-lists.
        Fleet replicas call this once per scheduler boundary — proxies and
        peer replicas write the shared dir behind this process's back."""
        with self._lock:
            self._listing = None

    # -- scheduling -----------------------------------------------------------

    def _load_queued(self) -> list[tuple[str, SimRequest]]:
        out = []
        for name in list(self._queued_files()):
            req = self._req_cache.get(name)
            if req is not None:
                out.append((name, req))
                continue
            path = os.path.join(self._dir("queued"), name)
            try:
                with open(path, encoding="utf-8") as fh:
                    req = SimRequest.from_json(fh.read())
            except FileNotFoundError:
                # a peer replica claimed it between our listdir and this
                # read (fleet mode: the shared dir has other writers)
                self._evict(name)
                continue
            except (OSError, ValueError, RequestError):
                # unreachable in practice: submit() fsyncs before the
                # atomic rename and .tmp corpses are filtered out — but a
                # truly unreadable file must not wedge scheduling forever
                continue
            self._req_cache[name] = req
            out.append((name, req))
        return out

    def snapshot_queued(self) -> list[tuple[str, SimRequest]]:
        """The queued scan as ``(name, request)`` pairs (names sort by
        enqueue order) — the fleet QoS planner's input; served from the
        listing/request caches like every other consult."""
        with self._lock:
            return list(self._load_queued())

    def buckets(self) -> dict[tuple, int]:
        """Pending request count per compatibility bucket, FIFO-weighted:
        the scheduler opens a campaign for the bucket holding the OLDEST
        queued request (no starvation), refilling slots from that bucket."""
        with self._lock:
            counts: dict[tuple, int] = {}
            for _, req in self._load_queued():
                counts.setdefault(req.compat_key, 0)
                counts[req.compat_key] += 1
            return counts

    def oldest_bucket(self) -> tuple | None:
        with self._lock:
            for _, req in self._load_queued():
                return req.compat_key
        return None

    def bucket_order(self) -> list[tuple]:
        """Distinct pending bucket keys ordered by their OLDEST queued
        request (FIFO over buckets) — the scheduler's round-robin rotation
        walks this list so no bucket waits more than one full cycle."""
        with self._lock:
            order: list[tuple] = []
            for _, req in self._load_queued():
                if req.compat_key not in order:
                    order.append(req.compat_key)
            return order

    def other_bucket_waiting(self, key: tuple) -> bool:
        """True when some OTHER bucket holds queued work (the fairness
        quantum only caps a campaign while someone is actually waiting)."""
        with self._lock:
            for _, req in self._load_queued():
                if req.compat_key != key:
                    return True
        return False

    def _claim_name(self, name: str, req: SimRequest) -> bool:
        """Move one queued file into ``running/``; False when a peer
        replica raced the claim (the source vanished under us — fleet
        mode's shared dir), in which case the stale cache is dropped."""
        src = os.path.join(self._dir("queued"), name)
        dst = os.path.join(self._dir("running"), f"{req.id}.json")
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            self._evict(name)
            return False
        _fsync_dir(self._dir("running"))
        _fsync_dir(self._dir("queued"))
        self._evict(name)
        return True

    def claim(self, key: tuple | None = None, qos: bool = False) -> SimRequest | None:
        """Atomically move the oldest queued request (matching ``key`` when
        given) into ``running/`` and return it; None when nothing matches.
        ``qos=True`` picks by (priority class, deadline slack, FIFO)
        instead of pure FIFO — the fleet traffic contract's claim order."""
        with self._lock:
            candidates = [
                (name, req)
                for name, req in self._load_queued()
                if key is None or req.compat_key == key
            ]
            if qos:
                now = time.time()
                candidates.sort(
                    key=lambda nr: (
                        nr[1].class_rank,
                        nr[1].deadline_slack(now),
                        nr[0],
                    )
                )
            for name, req in candidates:
                if self._claim_name(name, req):
                    return req
        return None

    def claim_id(self, request_id: str) -> SimRequest | None:
        """Claim one SPECIFIC queued request by id (the campaign-restore
        path: the slot table names the request whose member state the
        checkpoint restored).  None when the id is not queued — e.g. it
        completed after the checkpoint was written."""
        with self._lock:
            for name, req in self._load_queued():
                if req.id != request_id:
                    continue
                if self._claim_name(name, req):
                    return req
        return None

    # -- resolution -----------------------------------------------------------

    def _resolve(self, req: SimRequest, state: str, record: dict) -> str:
        with self._lock:
            path = os.path.join(self._dir(state), f"{req.id}.json")
            _atomic_write(path, json.dumps(record, sort_keys=True))
            running = os.path.join(self._dir("running"), f"{req.id}.json")
            try:
                os.remove(running)
                _fsync_dir(self._dir("running"))
            except OSError:
                pass  # recovery may already have re-enqueued it
            return path

    def complete(self, req: SimRequest, result: dict) -> str:
        """Move a running request to ``done/`` with its result record."""
        return self._resolve(req, "done", {"request": json.loads(req.to_json()), "result": result})

    def fail(self, req: SimRequest, reason: str) -> str:
        """Move a running request to its terminal ``failed/`` state."""
        record = {
            "request": json.loads(req.to_json()),
            "error": {"type": "RequestFailed", "reason": reason, "dts": req.dts},
        }
        return self._resolve(req, "failed", record)

    def requeue(self, req: SimRequest) -> None:
        """Put a running request back on the queue (drain, crash recovery,
        or a dt-backoff retry — the caller updates the request first).
        Requeues bypass the admission bound: the work was already
        accepted."""
        with self._lock:
            self._enqueue(req)
            running = os.path.join(self._dir("running"), f"{req.id}.json")
            try:
                os.remove(running)
                _fsync_dir(self._dir("running"))
            except OSError:
                pass

    def recover(self) -> list[str]:
        """Re-enqueue every ``running/`` request (startup: whatever claimed
        them died before resolving).  Progress is NOT reset here — the
        scheduler restores it from the campaign checkpoint when it can.
        Returns the recovered ids."""
        recovered = []
        with self._lock:
            for name in self._state_files("running"):
                path = os.path.join(self._dir("running"), name)
                try:
                    with open(path, encoding="utf-8") as fh:
                        req = SimRequest.from_json(fh.read())
                except (OSError, ValueError, RequestError):
                    continue
                self._enqueue(req)
                os.remove(path)
                recovered.append(req.id)
            if recovered:
                _fsync_dir(self._dir("running"))
        return recovered

    def recover_bucket(self, key: tuple) -> list[str]:
        """Re-enqueue the ``running/`` requests of ONE compat bucket — the
        fleet lease-break path: a dead replica's claims are scoped by the
        bucket lease the survivor just broke, never the whole running dir
        (peer replicas' live claims must not be stolen).  Returns the
        recovered ids."""
        recovered = []
        with self._lock:
            for name in self._state_files("running"):
                path = os.path.join(self._dir("running"), name)
                try:
                    with open(path, encoding="utf-8") as fh:
                        req = SimRequest.from_json(fh.read())
                except (OSError, ValueError, RequestError):
                    continue
                if req.compat_key != key:
                    continue
                self._enqueue(req)
                try:
                    os.remove(path)
                except OSError:
                    pass  # queued copy wins either way: duplicate beats lost
                recovered.append(req.id)
            if recovered:
                _fsync_dir(self._dir("running"))
        return recovered

    def tenant_counts(self) -> dict[str, int]:
        """Waiting + in-flight request count per tenant — the QoS quota
        denominator (done/failed are resolved: they no longer charge)."""
        with self._lock:
            counts: dict[str, int] = {}
            for _, req in self._load_queued():
                counts[req.tenant] = counts.get(req.tenant, 0) + 1
            for name in self._state_files("running"):
                path = os.path.join(self._dir("running"), name)
                try:
                    with open(path, encoding="utf-8") as fh:
                        req = SimRequest.from_json(fh.read())
                except (OSError, ValueError, RequestError):
                    continue
                counts[req.tenant] = counts.get(req.tenant, 0) + 1
            return counts

    # -- introspection --------------------------------------------------------

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {
                state: len(self._state_files(state)) for state in _STATES
            }

    def lookup(self, request_id: str) -> tuple[str, dict] | None:
        """(state, record) for one id; queued records are the bare request.
        A record that another process moves on while it is looked up (a
        fleet replica claiming, settling or requeueing it) is looked up
        again in the states after it, and the whole lookup once more if it
        slipped past all of them."""
        with self._lock:
            for _ in range(2):
                for state in ("running", "done", "failed"):
                    path = os.path.join(self._dir(state), f"{request_id}.json")
                    try:
                        with open(path, encoding="utf-8") as fh:
                            data = json.load(fh)
                    except FileNotFoundError:
                        continue
                    return state, (data if state != "running" else {"request": data})
                for name, req in self._load_queued():
                    if req.id == request_id:
                        return "queued", {"request": json.loads(req.to_json())}
        return None

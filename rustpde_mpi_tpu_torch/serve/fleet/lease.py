"""Queue-level bucket leases: how N replicas share one durable queue.

A fleet of :class:`~rustpde_mpi_tpu_torch.serve.SimServer` replicas coordinates
through lease files next to the queue they share — no consensus service,
the same fsynced atomic-dirent lifecycle the queue itself rides::

    <root>/<tag>.json            the live lease for bucket <tag>
    <root>/<tag>.gen             token escrow: highest fencing token ever
                                 issued for the bucket (survives lease-file
                                 deletion, so tokens stay monotonic)
    <root>/<tag>.json.breaking.* a break in progress (crash-tolerant
                                 intermediate; adopted by the next claim)

The protocol, one atomic dirent operation per transition:

* **claim** — write the new lease to a unique tmp file (fsynced), then
  ``os.link`` it to the lease path: dirent creation is atomic and
  EXCLUSIVE, so when two replicas race one bucket exactly one link
  succeeds and the loser sees EEXIST.  The fencing token is
  ``escrow + 1`` — strictly greater than every token the bucket has ever
  issued.
* **renew** (heartbeat) — the owner atomically rewrites the lease file
  (tmp + ``os.replace``) with a bumped sequence number, after verifying
  the on-disk ``(owner, token)`` still match its own: a mismatch means a
  survivor broke this lease while the owner stalled — the owner is FENCED
  and must stop writing (:class:`LeaseLost`).
* **break** — a survivor that observed a stale heartbeat renames the
  lease file away (``os.replace`` of a shared source: the loser of a
  break race gets FileNotFoundError — exactly one breaker wins), writes
  the broken token into the escrow, and removes the intermediate.  The
  bucket's queued+running requests are then re-claimable.
* **release** — the clean-shutdown path: verify ownership, park the
  token in the escrow, remove the lease file.

**Clock robustness** (the NTP-step satellite): staleness is never
computed as ``wall_now - heartbeat_stamp``.  The observer remembers, per
lease, the last *observed change* ``(token, seq, mtime_ns)`` and its own
``time.monotonic()`` at that observation; a lease is stale only when the
observation has not changed for ``ttl`` of OBSERVER-monotonic time.  Any
change — including an mtime that jumps BACKWARDS after a clock step —
resets the window, so a skewed-clock heartbeat reads as live for one
extra TTL instead of being instantly broken.  Heartbeats carry
``(hb_unix, hb_mono)`` pairs for diagnosis, not for the verdict.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

from ...utils.fsutil import atomic_write_text as _atomic_write
from ...utils.fsutil import fsync_dir


class LeaseLost(RuntimeError):
    """This process's lease was broken and possibly re-claimed by a peer:
    every write it was about to make is FENCED (the on-disk token moved
    past ours).  The holder must drop the bucket — its requests already
    belong to whoever holds the new token."""

    def __init__(self, tag: str, detail: str):
        super().__init__(f"lease {tag} lost: {detail}")
        self.tag = tag


def bucket_tag(key: tuple) -> str:
    """Stable 12-hex tag for one compat bucket (matches the scheduler's
    campaign-dir tagging)."""
    return hashlib.sha1(repr(tuple(key)).encode()).hexdigest()[:12]


def _read_json(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


class Lease:
    """One held bucket lease.  All methods are fencing-checked: they
    verify the on-disk ``(owner, token)`` before acting and raise
    :class:`LeaseLost` when a survivor broke + re-claimed the bucket."""

    def __init__(self, mgr: "LeaseManager", key: tuple, token: int):
        self.mgr = mgr
        self.key = tuple(key)
        self.tag = bucket_tag(key)
        self.token = int(token)
        self.owner = mgr.owner
        self._seq = 0

    @property
    def path(self) -> str:
        return os.path.join(self.mgr.root, f"{self.tag}.json")

    def _on_disk(self) -> dict | None:
        return _read_json(self.path)

    def _escrow_fenced(self) -> bool:
        """True when the token escrow has advanced TO OR PAST our token:
        some survivor broke (or we released) this lease at some point, so
        our authority is gone even if the lease file currently shows us —
        the defense against the guard-then-write resurrection race (a
        holder that stalls between its ownership read and its rewrite
        would otherwise recreate a broken lease over the new owner's)."""
        rec = _read_json(self.mgr._gen_path(self.tag)) or {}
        return int(rec.get("token", 0)) >= self.token

    def guard(self) -> None:
        """Fencing check (cheap reads): raise :class:`LeaseLost` unless
        this process still owns the bucket AND the token escrow has not
        moved past our token — called before every queue write the lease
        is supposed to authorize."""
        rec = self._on_disk()
        if (
            rec is None
            or rec.get("owner") != self.owner
            or int(rec.get("token", -1)) != self.token
        ):
            raise LeaseLost(
                self.tag,
                f"on-disk holder is {rec and rec.get('owner')!r} token "
                f"{rec and rec.get('token')}, we hold token {self.token}",
            )
        if self._escrow_fenced():
            # a record bearing our owner+token past the escrow can only
            # be our own resurrection (the legit new holder's token is
            # strictly greater): retract it so the bucket frees NOW
            # instead of after another observer TTL
            self._retract()
            raise LeaseLost(
                self.tag,
                f"token escrow reached {self.token}: this lease was broken "
                "while we stalled",
            )

    def _retract(self) -> None:
        """Best-effort removal of a lease file WE resurrected after being
        broken (only when it still bears our owner+token — never touch a
        legitimate newer holder's record)."""
        rec = self._on_disk()
        if (
            rec is not None
            and rec.get("owner") == self.owner
            and int(rec.get("token", -1)) == self.token
        ):
            try:
                os.remove(self.path)
                fsync_dir(self.mgr.root)
            except OSError:
                pass

    def renew(self) -> None:
        """Heartbeat: atomically rewrite the lease with a bumped sequence
        (mtime + content both advance, so observers see the change).
        Fencing-checked before AND after the write: a break that lands
        inside the guard→write window is caught by the escrow re-check,
        and the resurrected file is retracted — the zombie stands down
        within one heartbeat instead of fencing the legitimate owner."""
        self.guard()
        self._seq += 1
        _atomic_write(self.path, json.dumps(self.mgr._record(self, self._seq)))
        if self._escrow_fenced():
            self._retract()
            raise LeaseLost(
                self.tag,
                "broken during renewal (escrow advanced mid-write); "
                "resurrected record retracted",
            )

    def release(self) -> None:
        """Clean hand-back: escrow our token (monotonicity across the
        file's deletion), then remove the lease."""
        self.guard()
        self.mgr._escrow(self.tag, self.token)
        try:
            os.remove(self.path)
            fsync_dir(self.mgr.root)
        except OSError:
            pass


class LeaseManager:
    """Claim / renew / break / sweep over one lease directory.

    ``journal`` is an optional callable receiving event dicts
    (``lease_claimed`` / ``lease_broken`` / ``lease_released`` rows ride
    the replica's run journal).  ``ttl_s`` is the break threshold in
    observer-monotonic seconds (see module docstring)."""

    def __init__(
        self,
        root: str,
        owner: str,
        ttl_s: float,
        journal=None,
        mono_fn=time.monotonic,
    ):
        self.root = root
        self.owner = str(owner)
        self.ttl_s = float(ttl_s)
        self.journal = journal
        self._mono = mono_fn
        # observer bookkeeping: tag -> ((token, seq, mtime_ns), mono_seen)
        self._seen: dict[str, tuple[tuple, float]] = {}
        os.makedirs(root, exist_ok=True)

    # -- record helpers -------------------------------------------------------

    def _record(self, lease: Lease, seq: int) -> dict:
        return {
            "bucket": list(lease.key),
            "owner": lease.owner,
            "token": lease.token,
            "seq": int(seq),
            # monotonic-epoch PAIR: wall time for humans, the writer's
            # monotonic clock for skew diagnosis — neither is the
            # staleness verdict (that is observer-side, see sweep)
            "hb_unix": time.time(),
            "hb_mono": self._mono(),
        }

    def _gen_path(self, tag: str) -> str:
        return os.path.join(self.root, f"{tag}.gen")

    def _escrow(self, tag: str, token: int) -> None:
        """Advance the token escrow to at least ``token`` (never backward:
        a crashed breaker may have left it behind the broken lease)."""
        cur = _read_json(self._gen_path(tag)) or {}
        if int(cur.get("token", 0)) < int(token):
            _atomic_write(
                self._gen_path(tag), json.dumps({"token": int(token)})
            )

    def _next_token(self, tag: str) -> int:
        """escrow + 1, also adopting any crashed break's intermediate file
        (its token may exceed the escrow the breaker never wrote)."""
        best = int((_read_json(self._gen_path(tag)) or {}).get("token", 0))
        try:
            names = os.listdir(self.root)
        except OSError:
            names = []
        for name in names:
            if name.startswith(f"{tag}.json.breaking."):
                rec = _read_json(os.path.join(self.root, name)) or {}
                best = max(best, int(rec.get("token", 0)))
                self._escrow(tag, int(rec.get("token", 0)))
                try:
                    os.remove(os.path.join(self.root, name))
                    fsync_dir(self.root)
                except OSError:
                    pass
        return best + 1

    # -- the protocol ---------------------------------------------------------

    def claim(self, key: tuple) -> Lease | None:
        """Try to claim one bucket.  None when a lease file already exists
        (held — maybe stale: that is sweep's business, never claim's) or
        when we lost the creation race by one dirent."""
        tag = bucket_tag(key)
        path = os.path.join(self.root, f"{tag}.json")
        if os.path.exists(path):
            return None
        lease = Lease(self, key, self._next_token(tag))
        tmp = f"{path}.{self.owner}.{os.getpid()}.claimtmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(self._record(lease, 0)))
            fh.flush()
            os.fsync(fh.fileno())
        try:
            # atomic EXCLUSIVE dirent creation: exactly one racer links
            os.link(tmp, path)
        except FileExistsError:
            return None
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        fsync_dir(self.root)
        self._note(tag, path)
        if self.journal:
            self.journal(
                {
                    "event": "lease_claimed",
                    "bucket": tag,
                    "key": list(key),
                    "owner": self.owner,
                    "token": lease.token,
                }
            )
        return lease

    def _observe(self, tag: str, path: str) -> tuple | None:
        """(token, seq, mtime_ns) of the on-disk lease, None when gone."""
        try:
            mtime_ns = os.stat(path).st_mtime_ns
        except OSError:
            return None
        rec = _read_json(path)
        if rec is None:
            return None
        return (int(rec.get("token", 0)), int(rec.get("seq", 0)), mtime_ns)

    def _note(self, tag: str, path: str) -> None:
        obs = self._observe(tag, path)
        if obs is not None:
            self._seen[tag] = (obs, self._mono())

    def holders(self) -> dict[str, dict]:
        """tag -> lease record for every live lease file (introspection:
        the proxy's /stats aggregates this next to replica heartbeats)."""
        out = {}
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            rec = _read_json(os.path.join(self.root, name))
            if rec is not None:
                out[name[: -len(".json")]] = rec
        return out

    def stale(self, tag: str) -> bool:
        """True when ``tag``'s lease observation has not changed for a
        full TTL of observer-monotonic time.  ANY change — token, seq, or
        an mtime that moved in EITHER direction (an mtime jumping
        backwards is a clock step, not a death) — restarts the window, so
        the verdict never rides the wall clock."""
        path = os.path.join(self.root, f"{tag}.json")
        obs = self._observe(tag, path)
        if obs is None:
            self._seen.pop(tag, None)
            return False
        seen = self._seen.get(tag)
        if seen is None or seen[0] != obs:
            self._seen[tag] = (obs, self._mono())
            return False
        return (self._mono() - seen[1]) > self.ttl_s

    def break_lease(self, tag: str) -> dict | None:
        """Break one stale lease: rename it away (exactly one breaker wins
        — the source dirent vanishes for the loser), escrow its token,
        clean up.  Returns the broken record, or None when a peer raced us
        to it (or the holder revived and renewed first — the rename is the
        linearization point either way)."""
        path = os.path.join(self.root, f"{tag}.json")
        breaking = f"{path}.breaking.{self.owner}.{os.getpid()}"
        try:
            os.replace(path, breaking)
        except FileNotFoundError:
            return None
        fsync_dir(self.root)
        rec = _read_json(breaking) or {}
        self._escrow(tag, int(rec.get("token", 0)))
        try:
            os.remove(breaking)
            fsync_dir(self.root)
        except OSError:
            pass
        self._seen.pop(tag, None)
        if self.journal:
            self.journal(
                {
                    "event": "lease_broken",
                    "bucket": tag,
                    "key": rec.get("bucket"),
                    "owner": rec.get("owner"),
                    "token": rec.get("token"),
                    "breaker": self.owner,
                }
            )
        return rec

    def sweep(self) -> list[dict]:
        """Break every stale lease in the directory; returns the broken
        records (each carries the bucket key the caller re-claims requests
        for).  Run between campaigns — survivors are the failure detector,
        there is no central one."""
        broken = []
        for tag in list(self.holders()):
            if self.stale(tag):
                rec = self.break_lease(tag)
                if rec is not None:
                    broken.append(rec)
        return broken

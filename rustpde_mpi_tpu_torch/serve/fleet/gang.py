"""Gang scheduling: fate-shared lease groups for sub-mesh campaigns.

A GANG is the unit that serves one pencil-sharded bucket: K ensemble
members × one sharded grid, gang-scheduled onto a carved sub-mesh
(parallel/submesh.py).  Its failure contract is fate-sharing — the gang
runs as a whole and dies as a whole:

* **One gang lease** over the bucket (key ``("gang",) + serve_key``)
  authorizes the campaign; **per-member leases** (``("gang-member", i) +
  serve_key``) carry individual fencing tokens so a survivor that breaks
  the gang fences EVERY member's writes, not just the root's.  All token
  escrows are per-tag and never move backward (lease.py), so member
  tokens stay monotonic across gang GENERATIONS — generation = the gang
  lease's own fencing token.
* **Formation is all-or-nothing**: if any member lease cannot be claimed
  the partial claims are rolled back and :meth:`GangLease.form` reports
  failure — there is never a half-formed gang holding real capacity.
* **Breaking is gang-first**: :func:`break_gang` breaks the GROUP lease
  before any member lease.  The group break is the linearization point
  (``os.replace`` — exactly one breaker wins); member breaks after it
  are cleanup, and a member mid-renew loses to the breaker through the
  ordinary escrow fence (`Lease.renew`'s post-write re-check).

The other half of fate-sharing is the BARRIER: a sharded step is a
collective, and a dead member turns every survivor's next collective
into a silent forever-hang.  :func:`gang_sync` is the campaign barrier
with its own (tighter) deadline — the ``timeout_s`` argument — that
converts the hang into a typed :class:`GangMemberLost` the scheduler can
contain: break own gang lease, requeue-with-state, keep co-resident
sub-meshes streaming.
"""

from __future__ import annotations

from ...parallel import multihost
from .lease import Lease, LeaseLost, LeaseManager, bucket_tag


class GangMemberLost(RuntimeError):
    """A gang member stopped participating (missed the gang barrier or
    was fenced): the GANG is dead as a unit.  The holder must park what
    it can host-locally, break only its own gang lease, and requeue the
    bucket's requests — co-resident sub-meshes are untouched."""

    def __init__(self, tag: str, member: int | None, detail: str):
        who = f"member {member}" if member is not None else "a member"
        super().__init__(f"gang {tag}: {who} lost: {detail}")
        self.tag = tag
        self.member = member
        self.detail = detail


def gang_key(key: tuple) -> tuple:
    """The gang (group) lease key for one serve bucket."""
    return ("gang",) + tuple(key)


def member_key(key: tuple, member: int) -> tuple:
    """The per-member lease key: distinct tag per member, so each member
    carries its own fencing token under the shared gang generation."""
    return ("gang-member", int(member)) + tuple(key)


class GangLease:
    """One formed gang: the group lease plus K member leases, claimed and
    released as a unit through a shared :class:`LeaseManager`.

    The scheduler holds exactly one of these per gang campaign; every
    heartbeat renews group-then-members (:meth:`renew`), and any
    :class:`LeaseLost` from any constituent lease is raised as-is — the
    caller treats it exactly like a bucket-lease fence today."""

    def __init__(self, mgr: LeaseManager, key: tuple, group: Lease,
                 members: list[Lease]):
        self.mgr = mgr
        self.key = tuple(key)
        self.tag = bucket_tag(gang_key(key))
        self.group = group
        self.members = list(members)

    @property
    def generation(self) -> int:
        """The gang generation = the group lease's fencing token: strictly
        increases every time the gang is re-formed (escrow-monotonic)."""
        return self.group.token

    @classmethod
    def form(cls, mgr: LeaseManager, key: tuple, k: int) -> "GangLease | None":
        """All-or-nothing formation: claim the group lease, then every
        member lease.  Any failure rolls the partial claims back (release,
        not break — our own tokens go to escrow so the next generation's
        tokens still advance) and returns None."""
        group = mgr.claim(gang_key(key))
        if group is None:
            return None
        members: list[Lease] = []
        for i in range(int(k)):
            m = mgr.claim(member_key(key, i))
            if m is None:
                for held in members:
                    try:
                        held.release()
                    except (LeaseLost, OSError):
                        pass
                try:
                    group.release()
                except (LeaseLost, OSError):
                    pass
                return None
            members.append(m)
        return cls(mgr, key, group, members)

    def renew(self) -> None:
        """Heartbeat the whole gang, GROUP FIRST: if a survivor broke the
        gang, the group renew fences before any member write happens —
        members never outlive their gang by even one heartbeat."""
        self.group.renew()
        for m in self.members:
            m.renew()

    def renew_member(self, member: int) -> None:
        """Renew one member under the gang's authority: guard the group
        lease first (a broken gang fences the member immediately), then
        renew the member's own lease.  In the break-vs-renew race exactly
        one side wins: the breaker's ``os.replace`` or this renew's
        escrow re-check decides, never both."""
        self.group.guard()
        self.members[int(member)].renew()

    def guard(self) -> None:
        """Fencing check over the whole gang (cheap reads, no writes)."""
        self.group.guard()
        for m in self.members:
            m.guard()

    def release(self) -> None:
        """Clean hand-back, members first then group — the group lease is
        the last thing standing, so an observer never sees a groupless
        member.  Escrow advances for every tag (token monotonicity)."""
        err: Exception | None = None
        for m in self.members:
            try:
                m.release()
            except LeaseLost as exc:
                err = exc
        try:
            self.group.release()
        except LeaseLost as exc:
            err = exc
        if err is not None:
            raise err


def break_gang(mgr: LeaseManager, key: tuple, k: int) -> dict | None:
    """Break a dead gang as a unit, group lease FIRST: the group break is
    the single linearization point (one winner), then every member lease
    is broken as cleanup — their escrows advance so the next generation's
    member tokens are strictly greater.  Returns the broken group record,
    or None when a peer won the break race (the peer does the member
    cleanup too)."""
    rec = mgr.break_lease(bucket_tag(gang_key(key)))
    if rec is None:
        return None
    for i in range(int(k)):
        mgr.break_lease(bucket_tag(member_key(key, i)))
    return rec


def stale_gangs(mgr: LeaseManager, max_members: int = 64) -> list[dict]:
    """Sweep helper: break every stale GANG lease (group-first fate
    sharing) and return the broken group records.  Member leases of a
    broken gang are broken unconditionally — a live-looking member of a
    dead gang is still dead (fate-sharing is the contract)."""
    broken = []
    for tag, rec in mgr.holders().items():
        bucket = rec.get("bucket") or []
        if not (isinstance(bucket, list) and bucket[:1] == ["gang"]):
            continue
        if not mgr.stale(tag):
            continue
        got = mgr.break_lease(tag)
        if got is None:
            continue
        key = multihost.tuplify(bucket[1:])
        for i in range(int(max_members)):
            mtag = bucket_tag(member_key(key, i))
            if mtag not in mgr.holders():
                break
            mgr.break_lease(mtag)
        broken.append(got)
    return broken


def gang_sync(tag: str, gang_tag: str, member: int | None = None,
              timeout_s: float = 0.0) -> None:
    """The gang barrier: a cross-host sync fence with the gang deadline
    ``timeout_s`` (seconds; 0: the job-wide sync's own, the JAX package's
    default).  A peer that never arrives (a SIGKILLed member) trips the
    deadline and surfaces as a typed :class:`GangMemberLost` instead of a
    wedged collective: one dead sub-mesh, not a wedged fleet."""
    from ...utils.resilience import DispatchHang

    timeout = float(timeout_s or 0.0)
    try:
        multihost.sync_hosts(tag, timeout_s=timeout if timeout > 0 else None)
    except DispatchHang as exc:
        raise GangMemberLost(
            gang_tag, member, f"barrier {tag!r} timed out: {exc}"
        ) from exc

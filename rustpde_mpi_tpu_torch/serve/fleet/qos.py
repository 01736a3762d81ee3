"""The fleet traffic contract: tenants, priority classes, deadlines.

Pure host-side policy — no device work, no collectives, no file writes.
The scheduler calls these helpers from inside its root-plan closures (the
decisions are broadcast like every other scheduling verdict) and the
stateless proxy calls them at admission; both journal the outcomes
themselves.

Four levers:

* **sub-mesh admission** — :func:`admit_submesh` stamps sharded-grid
  requests with the sub-mesh shape they gang onto (two-level serving)
  and converts the two mismatch shapes into typed rejects: permanently
  unservable grids into ``reason="no_submesh"`` 400s, transient sharded
  backlog into ``reason="capacity"`` 429s with a queue-depth-derived
  ``Retry-After``,
* **per-tenant quotas** — :func:`check_quota` bounds one tenant's
  queued+running footprint; past it the submit is rejected with the typed
  ``reason="quota"`` :class:`~rustpde_mpi_tpu_torch.serve.AdmissionError`
  (HTTP: 429 + ``Retry-After`` + the live queue depth), so one noisy
  tenant degrades into clean backpressure instead of starving the fleet,
* **priority-ordered scheduling** — :func:`bucket_order` replaces the
  single-replica FIFO/round-robin bucket pick: buckets sort by the best
  priority class waiting in them, then by the tightest deadline slack,
  then by arrival.  Within a bucket the queue's ``claim(qos=True)``
  applies the same order to individual requests,
* **deadline-driven preemption** — :func:`find_at_risk` flags the queued
  interactive request whose remaining slack dropped below the configured
  threshold; :func:`preempt_victims` picks the running best-effort lanes
  to park for it (requeue-WITH-state through the durable continuation
  machinery, so preemption is loss-free).  Only strictly-lower classes
  are ever victims: interactive preempts best-effort, batch preempts
  nothing and is preempted by nothing.
"""

from __future__ import annotations

import dataclasses
import time

from ...parallel import submesh as _submesh
from ..request import AdmissionError, RequestError, SimRequest

#: wall-step threshold for the deadline clock: steps smaller than this are
#: ordinary NTP slew/drift the deadline math can absorb; larger ones are
#: corrections that would blow every queued deadline at once
CLOCK_STEP_THRESHOLD_S = 30.0


def qos_now() -> float:
    """The deadline clock: wall time, with forward steps compensated for
    the detecting scan (fleet/clock.py — one-shot ``clock_skew`` warning,
    then the step is absorbed as the new normal).  Without this, an NTP
    forward correction would flag every queued deadline as at-risk in the
    same boundary and preemption would evict the whole best-effort tier
    for requests that were comfortably on time a second earlier."""
    from .clock import MONITOR

    now = time.time()
    skew = MONITOR.check(CLOCK_STEP_THRESHOLD_S, where="qos_deadlines")
    return now - skew if skew > 0.0 else now


def admit_submesh(
    req: SimRequest, pending_sharded: int, cfg
) -> SimRequest:
    """Two-level-serving admission (parallel/submesh.py): stamp ``req``
    with the sub-mesh device count its grid needs, or reject it typed.

    ``cfg`` is the service's :class:`~rustpde_mpi_tpu_torch.config.SubmeshConfig`
    (None = feature off: the request passes through untouched, byte-
    identical default).  Small grids stay unstamped (vmapped traffic).  A
    grid at/above the sharding threshold that fits NO configured shape is
    a permanent mismatch for this service — typed ``reason="no_submesh"``
    :class:`RequestError` (HTTP 400) at POST time, not a durable poison
    pill that wedges every later serve pass.  A grid that DOES fit but
    finds the sharded backlog at ``max_pending`` is a transient capacity
    reject — ``reason="capacity"`` :class:`AdmissionError` (HTTP 429)
    whose ``Retry-After`` scales with the live sharded queue depth.
    ``pending_sharded`` is the caller's census of queued stamped requests.
    """
    if cfg is None:
        return req
    shape = _submesh.shape_for(int(req.nx), int(req.ny), cfg)
    if shape == 0:
        return req
    if shape < 0:
        raise RequestError(
            f"grid {req.nx}x{req.ny} needs sharding (>= {cfg.shard_min_nx}"
            f" points) but fits none of the configured sub-mesh shapes "
            f"{tuple(cfg.shapes)}",
            reason="no_submesh",
        )
    pending = int(pending_sharded)
    if pending >= int(cfg.max_pending):
        raise AdmissionError(
            "capacity",
            f"{pending} sharded requests already queued "
            f"(max_pending={cfg.max_pending}); retry once gangs drain",
            retry_after_s=2.0 * max(1, pending),
        )
    if int(req.submesh) == shape:
        return req
    return dataclasses.replace(req, submesh=shape)


def check_quota(req: SimRequest, tenant_counts: dict, fleet_cfg) -> None:
    """Raise the typed quota rejection when ``req``'s tenant is at its
    bound (``tenant_counts`` is the queue's queued+running census)."""
    quota = fleet_cfg.resolved_quota(req.tenant)
    if quota is None:
        return
    held = int(tenant_counts.get(req.tenant, 0))
    if held >= quota:
        raise AdmissionError(
            "quota",
            f"tenant {req.tenant!r} holds {held}/{quota} queued+running "
            "requests; retry after some resolve",
            retry_after_s=2.0,
        )


def bucket_order(loaded: list, now: float | None = None) -> list[tuple]:
    """Distinct bucket keys ordered by the QoS contract: best waiting
    priority class first, tightest deadline slack second, oldest arrival
    third.  ``loaded`` is the queue's ``(name, SimRequest)`` scan (names
    sort by enqueue time by construction)."""
    now = qos_now() if now is None else now
    best: dict[tuple, list] = {}
    for name, req in loaded:
        cand = [req.class_rank, req.deadline_slack(now), name]
        cur = best.get(req.compat_key)
        if cur is None or cand < cur:
            best[req.compat_key] = cand
    return [k for k, _ in sorted(best.items(), key=lambda kv: kv[1])]


def find_at_risk(
    loaded: list, slack_s: float, now: float | None = None
) -> SimRequest | None:
    """The most urgent queued deadline-carrying request whose remaining
    slack is below ``slack_s`` — the preemption trigger.  None when every
    deadline still has room (the common case: preemption stays idle)."""
    now = qos_now() if now is None else now
    at_risk = [
        req
        for _, req in loaded
        if req.deadline_s is not None and req.deadline_slack(now) < slack_s
    ]
    if not at_risk:
        return None
    return min(at_risk, key=lambda r: (r.class_rank, r.deadline_slack(now)))


def preempt_victims(
    running: list, at_risk: SimRequest, current_key: tuple
) -> list[int]:
    """Slot indices to park for ``at_risk``: only lanes running a STRICTLY
    lower class are candidates (best-effort under an interactive emergency
    — batch is never preempted).  Same-bucket emergencies free exactly one
    lane (the at-risk request refills it this boundary); cross-bucket ones
    park every candidate lane, so the campaign drains toward its end and
    the priority-ordered bucket pick takes the urgent bucket next.
    ``running`` is ``[(slot_index, SimRequest), ...]``."""
    if at_risk.class_rank > 0:
        # only the interactive class may preempt: a late BATCH deadline
        # is a scheduling miss, not an emergency worth evicting for
        return []
    now = qos_now()
    victims = sorted(
        (
            (req.class_rank, req.deadline_slack(now), i)
            for i, req in running
            if req.class_rank > at_risk.class_rank
            and req.class_rank >= 2  # only the best-effort lane is fair game
        ),
        reverse=True,  # worst class first, then MOST slack (the lane best
    )  # able to absorb a park) — never the one nearest its own deadline
    if not victims:
        return []
    if tuple(at_risk.compat_key) == tuple(current_key):
        return [victims[0][2]]
    return [v[2] for v in victims]

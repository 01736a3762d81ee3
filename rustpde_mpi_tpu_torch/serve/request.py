"""Simulation requests: the unit of work the service admits, batches,
retries and resolves (a copy of the JAX package's ``serve/request.py``,
which is host code; the port imports nothing of that package).

A :class:`SimRequest` names everything a campaign needs to reproduce the
run — grid, physics parameters, dt, geometry, horizon, IC seed — plus the
bookkeeping the robustness contract rides on (retry budget and count, dt
trajectory, progress at the last drain).  Its :meth:`compat_key` mirrors
:attr:`..models.navier.Navier2D.compat_key`: requests with
equal keys share one compiled ensemble step and can co-batch / refill each
other's slots without recompiling.

Lifecycle (the queue directories in serve/queue.py map 1:1)::

    queued ── claim ──> running ── complete ──> done
      ^                   │ │
      │   requeue (drain/ │ └─ fail (retries exhausted) ──> failed
      └── crash/dt-retry)─┘

Every transition is an atomic file rename, so a crash at any point leaves
each request in exactly one state and restart-time recovery re-enqueues
whatever was ``running`` — accepted requests are never lost.
"""

from __future__ import annotations

import dataclasses
import json
import time
import uuid


class RequestError(ValueError):
    """A submitted request is malformed (bad grid/dt/horizon/bc): rejected
    at admission, before it can poison a batch.  ``reason`` optionally
    names a machine-readable rejection class the HTTP fronts surface in
    the 400 body (``"no_submesh"``: a sharded grid fits none of the
    configured sub-mesh shapes — permanently unservable here, distinct
    from the retryable 429 capacity reject)."""

    def __init__(self, message: str, reason: str | None = None):
        super().__init__(message)
        self.reason = reason


class AdmissionError(RuntimeError):
    """The service refused to admit a request — bounded-queue backpressure
    (``reason="queue_full"``), a draining/stopped service
    (``reason="draining"``), a tenant over its QoS quota
    (``reason="quota"``), or a queue volume with no space left
    (``reason="storage_full"`` — the durable-enqueue write hit ENOSPC;
    admitting without the fsynced file would break the never-lost
    contract, so the reject is typed and the HTTP front answers 503).
    Typed reject-with-reason instead of an unbounded backlog: the client
    backs off or routes elsewhere.  ``retry_after_s`` is the back-off
    hint the HTTP 429/503 surfaces as a ``Retry-After`` header."""

    def __init__(self, reason: str, detail: str, retry_after_s: float = 5.0):
        super().__init__(f"request rejected ({reason}): {detail}")
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


#: QoS priority classes, best first — the rank orders bucket selection
#: and decides who may preempt whom (interactive preempts best-effort;
#: batch neither preempts nor is preempted by batch)
PRIORITY_CLASSES = ("interactive", "batch", "best-effort")


def priority_rank(priority: str) -> int:
    """0 = most urgent.  Unknown classes sort last (defensive: validation
    rejects them at admission, but durable files outlive code)."""
    try:
        return PRIORITY_CLASSES.index(priority)
    except ValueError:
        return len(PRIORITY_CLASSES)


class RequestFailed(RuntimeError):
    """Terminal per-request failure: the request diverged (or was killed)
    and exhausted its retry budget.  Carries the request id, the journaled
    dt trajectory it was retried along, and the terminal reason — the
    per-request analogue of
    :class:`..utils.resilience.DivergenceError`."""

    def __init__(self, request_id: str, reason: str, dt_trajectory=()):
        super().__init__(
            f"request {request_id} failed terminally ({reason}); "
            f"dt trajectory: {list(dt_trajectory)}"
        )
        self.request_id = request_id
        self.reason = reason
        self.dt_trajectory = list(dt_trajectory)


@dataclasses.dataclass
class SimRequest:
    """One simulation request (model kind + Ra/Pr/resolution/geometry/horizon).

    ``model`` names the physics through the workloads registry (``"dns"``
    DNS, ``"lnse"`` linearized eigenmode run, ``"adjoint"`` steady-state
    find) — it PREFIXES :attr:`compat_key`, so mixed-model traffic buckets
    into separate campaigns by construction.  ``scenario`` optionally adds
    DNS step modifiers (``coriolis`` / ``passive_scalar`` /
    ``scalar_kappa`` — workloads/modifiers.ScenarioConfig.to_dict()); the
    modifier terms are operator constants, so the scenario signature joins
    the bucket key too.

    ``horizon`` is sim-time; the scheduler converts it to a step count at
    admission (``steps = max(1, round(horizon / dt))``).  ``dt`` may be
    rewritten by the per-request divergence retry (backoff re-queues the
    request at a smaller dt — a different compatibility bucket); ``dts``
    records the trajectory for the terminal :class:`RequestFailed` report.
    ``progress`` carries steps already completed in a drained campaign
    whose checkpoint will restore the member state on resume."""

    ra: float
    horizon: float
    pr: float = 1.0
    nx: int = 129
    ny: int = 129
    dt: float = 2e-3
    aspect: float = 1.0
    bc: str = "rbc"
    periodic: bool = False
    model: str = "dns"  # workloads-registry kind
    scenario: dict | None = None  # DNS step modifiers (compat-key signed)
    # QoS traffic contract (serve/fleet/qos.py): the tenant the quota is
    # charged to, the priority class (PRIORITY_CLASSES) ordering bucket
    # selection + preemption, and an optional soft deadline in seconds
    # from submission — a queued interactive request whose deadline slack
    # runs low preempts a running best-effort lane.  None of these joins
    # compat_key: requests of different tenants/classes co-batch freely.
    tenant: str = "default"
    priority: str = "batch"
    deadline_s: float | None = None
    # client-chosen idempotency key (serve/queue.py dedupe index): a retry
    # of an acked-but-unobserved submit (timeout, dropped 202, LB failover
    # to another proxy) carrying the same key is answered with the ORIGINAL
    # request's id instead of enqueueing duplicate work.  Never joins
    # compat_key; None (the default) opts out entirely.
    idempotency_key: str | None = None
    seed: int = 0
    amp: float | None = None  # IC amplitude (None: ServeConfig.default_amp)
    # sub-mesh stamp (two-level serving, parallel/submesh.py): 0 = vmapped
    # default traffic (compat_key stays the bare 10-tuple — byte-identical
    # to a service without SubmeshConfig); >0 = the device count of the
    # sub-mesh this sharded request is gang-scheduled onto, stamped at
    # admission from the configured shapes so every front buckets equal
    # grids identically.  Clients never set it; admission owns the stamp.
    submesh: int = 0
    id: str = ""
    submitted_s: float = 0.0  # unix time at admission (latency accounting)
    enqueued_s: float = 0.0  # unix time of the FIRST durable enqueue
    retries: int = 0  # divergence retries consumed
    dts: list = dataclasses.field(default_factory=list)  # dt trajectory
    progress: int = 0  # steps completed before the last drain/requeue
    # distributed trace context (telemetry/reqtrace.mint): trace_id names
    # the request's whole lifecycle across retries/re-buckets/incarnations;
    # riding the durable request file it survives exactly what the id does
    trace: dict | None = None

    def __post_init__(self):
        if not self.id:
            self.id = uuid.uuid4().hex[:12]
        if not self.submitted_s:
            self.submitted_s = time.time()
        if not self.dts:
            self.dts = [float(self.dt)]
        if self.trace is None:
            from ..telemetry import reqtrace

            self.trace = reqtrace.mint(self.id)

    @property
    def trace_id(self) -> str | None:
        """The lifecycle trace id (journal rows and chunk spans carry it)."""
        return (self.trace or {}).get("trace_id")

    def validate(self) -> "SimRequest":
        """Admission-time sanity: reject malformed work before it costs a
        compile or poisons a batch.  Raises :class:`RequestError`."""
        if self.bc not in ("rbc", "hc"):
            raise RequestError(f"bc must be 'rbc' or 'hc', got {self.bc!r}")
        if not (self.nx >= 4 and self.ny >= 4):
            raise RequestError(f"grid too small: {self.nx}x{self.ny}")
        if not (self.dt > 0.0):
            raise RequestError(f"dt must be positive, got {self.dt}")
        if not (self.horizon > 0.0):
            raise RequestError(f"horizon must be positive, got {self.horizon}")
        if not (self.ra > 0.0 and self.pr > 0.0):
            raise RequestError(f"Ra/Pr must be positive, got {self.ra}/{self.pr}")
        if self.priority not in PRIORITY_CLASSES:
            raise RequestError(
                f"priority must be one of {PRIORITY_CLASSES}, "
                f"got {self.priority!r}"
            )
        if not self.tenant or not isinstance(self.tenant, str):
            raise RequestError(f"tenant must be a non-empty string, got {self.tenant!r}")
        if self.deadline_s is not None and not (float(self.deadline_s) > 0.0):
            raise RequestError(
                f"deadline_s must be positive (or null), got {self.deadline_s}"
            )
        if int(self.submesh) < 0:
            raise RequestError(
                f"submesh stamp must be >= 0, got {self.submesh}"
            )
        if self.idempotency_key is not None:
            if (
                not isinstance(self.idempotency_key, str)
                or not self.idempotency_key.strip()
            ):
                raise RequestError(
                    "idempotency_key must be a non-empty string (or null), "
                    f"got {self.idempotency_key!r}"
                )
            if len(self.idempotency_key) > 256:
                raise RequestError(
                    "idempotency_key longer than 256 characters "
                    f"({len(self.idempotency_key)})"
                )
        from ..workloads.registry import model_kinds

        if self.model not in model_kinds():
            raise RequestError(
                f"unknown model kind {self.model!r}; known: {list(model_kinds())}"
            )
        if self.scenario is not None:
            if self.model != "dns":
                raise RequestError(
                    "scenario modifiers are a DNS axis (model='dns')"
                )
            known = {"coriolis", "passive_scalar", "scalar_kappa"}
            unknown = set(self.scenario) - known
            if unknown:
                raise RequestError(
                    f"unknown scenario fields: {sorted(unknown)}"
                )
            # VALUE validation: the signature computation must succeed —
            # compat_key is evaluated after admission (journal, bucket
            # ordering), so a bad-typed value admitted here would become a
            # durable poison pill that crashes every serve() pass
            from ..models.navier import scenario_signature

            try:
                scenario_signature(self.scenario)
            except (TypeError, ValueError) as exc:
                raise RequestError(f"bad scenario values: {exc}") from exc
        return self

    @property
    def compat_key(self) -> tuple:
        """Operator-constant bucket key — equal keys co-batch (mirrors
        :attr:`..models.campaign.CampaignModelBase.compat_key`:
        model kind first, canonical scenario signature last)."""
        from ..models.navier import scenario_signature

        key = (
            str(self.model),
            int(self.nx),
            int(self.ny),
            float(self.ra),
            float(self.pr),
            float(self.dt),
            float(self.aspect),
            str(self.bc),
            bool(self.periodic),
            scenario_signature(self.scenario),
        )
        # gang traffic gains the sub-mesh stamp as an 11th element so
        # sharded buckets never co-batch with vmapped ones; unstamped
        # requests keep the bare 10-tuple (byte-identical default)
        if int(self.submesh) > 0:
            key = key + (int(self.submesh),)
        return key

    @property
    def steps(self) -> int:
        """Total steps this request needs at its current dt."""
        return max(1, round(float(self.horizon) / float(self.dt)))

    @property
    def steps_remaining(self) -> int:
        """Steps still owed after any drained-campaign progress."""
        return max(0, self.steps - int(self.progress))

    @property
    def class_rank(self) -> int:
        """QoS priority rank (0 = interactive, most urgent)."""
        return priority_rank(self.priority)

    def deadline_slack(self, now: float) -> float:
        """Seconds of deadline slack left at wall time ``now`` (may be
        negative: already late); +inf for deadline-free requests."""
        if self.deadline_s is None:
            return float("inf")
        return (self.submitted_s + float(self.deadline_s)) - float(now)

    def backed_off(self, factor: float) -> "SimRequest":
        """The retry copy: dt shrunk, retry counted, progress DISCARDED —
        a diverged trajectory is not worth resuming — and the dt recorded
        on the trajectory."""
        new_dt = float(self.dt) * float(factor)
        return dataclasses.replace(
            self,
            dt=new_dt,
            retries=self.retries + 1,
            dts=self.dts + [new_dt],
            progress=0,
        )

    def rebucketed(self, new_dt: float, progress: int = 0) -> "SimRequest":
        """The PROACTIVE dt re-bucket copy (per-bucket stability ladder,
        serve/scheduler): dt moved to a new ladder rung, the dt recorded on
        the trajectory, progress PRESERVED — the member state was finite
        when the CFL sentinel tripped, so the scheduler parks it and the
        trajectory continues at the new rung.  Unlike :meth:`backed_off`
        this consumes no retry: nothing failed, the governor acted early."""
        new_dt = float(new_dt)
        return dataclasses.replace(
            self,
            dt=new_dt,
            dts=self.dts + [new_dt],
            progress=int(progress),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SimRequest":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise RequestError(f"unknown request fields: {sorted(unknown)}")
        return cls(**data)

    @classmethod
    def from_dict(cls, data: dict) -> "SimRequest":
        return cls.from_json(json.dumps(data))

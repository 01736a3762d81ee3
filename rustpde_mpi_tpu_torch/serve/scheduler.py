"""Continuously-batched ensemble scheduler: the fault-isolated simulation
service.

The serving layer the ROADMAP's multi-tenant north star needs: a
persistent driver that accepts :class:`~.request.SimRequest` work through
the durable queue (serve/queue.py, plus the thin HTTP front in
serve/http_front.py), bucket-batches compatible requests into
:class:`~rustpde_mpi_tpu_torch.models.ensemble.NavierEnsemble` slots, and
streams per-request observables back through observable futures as
each request resolves.  The batching is LLM-style CONTINUOUS batching:

* requests bucket by :attr:`SimRequest.compat_key` (the operator constants
  one ensemble step can serve: grid, Ra/Pr, dt, geometry, BC),
* a campaign opens one K-slot ensemble per bucket; each chunk advances
  every running slot together as ONE member-stacked dispatch (on the card,
  one replay of the ensemble's captured chunk graph a step),
* the chunk length is ``min(remaining steps of any running slot,
  chunk_steps)``, so completions land exactly on chunk boundaries,
* a finished, diverged or idle slot is REFILLED from the queue at the
  boundary via ``set_member`` — the existing respawn machinery — without
  rebuilding anything (equal keys share the operators by construction).

Robustness is the spec, not a bolt-on:

* **per-request fault isolation** — one member's NaN freezes that member
  only (the ensemble's per-member finite mask); co-batched requests keep
  stepping bit-exactly like their solo runs (CI-asserted),
* **per-request retry** — a diverged request is re-queued at
  ``dt * request_dt_backoff`` (a different bucket: dt is an operator
  constant) with a bounded budget, then lands in the typed
  :class:`~.request.RequestFailed` terminal state,
* **admission control** — the queue bounds admissions and a submit past
  the bound is rejected with a reason (queue.py),
* **graceful drain** — SIGTERM (or :meth:`SimServer.request_drain`)
  finishes the in-flight chunk, checkpoints every slot via the sharded
  two-phase writer — WITH the slot table riding the manifest as
  digest-covered root data — re-enqueues unfinished requests and exits
  clean,
* **crash recovery** — on restart the queue re-enqueues whatever was
  ``running`` (accepted requests are never lost) and the campaign restore
  rebuilds the slot table from the newest valid checkpoint, so drained or
  killed requests resume mid-trajectory instead of restarting.

The device-facing machinery is the embedded
:class:`~rustpde_mpi_tpu_torch.utils.resilience.ResilientRunner` (its
``session``/``advance``/``checkpoint_now`` surface): fault injection,
dispatch watchdogs, the async/sharded checkpoint pipeline and the journal
all come from there — the service adds scheduling, not a second harness.

**Multihost campaigns** (root-coordinated scheduling): every process of a
multi-process mesh runs ``serve()`` together, but the durable queue, the
journal, the HTTP front and result flushing are ROOT-ONLY, and every
per-boundary decision the scheduler makes — bucket selection, slot
claim/refill assignments, completion/death verdicts, chunk length, the
dt-re-bucket plan, the drain flag — is computed on root and broadcast
(:func:`~rustpde_mpi_tpu_torch.parallel.multihost.broadcast_obj`) BEFORE any
collective dispatch, exactly the treatment the runner's cadence decisions
already get.  Every host therefore executes the identical
``set_member``/``mark_dead``/``update_n`` sequence, ``sync_hosts`` fences
service start/stop and campaign open/close, and the two-phase slot-table
checkpoint carries the state.

**Elastic fleets**: a restart may resize ``cfg.slots``.  The scheduler
peeks the checkpoint's member count first, restores onto a fleet of THAT
size (topology-elastic restore reassembles the state onto whatever mesh
this incarnation has), then RE-PLANS onto the configured size: kept
requests move into the new lanes mid-trajectory (``set_member``), surplus
requests (shrink) are parked — member state held for the lane that will
next claim them — and re-enqueued at their checkpointed progress, grown
fleets refill the extra lanes from the queue, and a ``campaign_replanned``
journal event records old/new K.

**Governed campaign dt** (``cfg.stability``): per-request dt is part of
the request contract AND the bucket key, so the batch-wide governor stays
off; instead the on-device CFL sentinels are armed and a per-bucket
:class:`~rustpde_mpi_tpu_torch.utils.governor.DtLadder` turns a ceiling catch
into a PROACTIVE re-bucket — the chunk was already rolled back in memory
while every member is still finite, the pinned requests are requeued WITH
their state at the next rung down (journal ``bucket_dt_adjust``), and the
reactive NaN + retry path remains the last resort underneath.

**The port** (this module is the JAX package's ``serve/scheduler.py``,
decision for decision and journal row for journal row).  What differs is
what the device is:

* a campaign's warm state is its ensemble's captured CUDA graphs (the
  chunk runner, :meth:`..models.ensemble.NavierEnsemble.chunk_runner`),
  not XLA executables; the warm pool captures them on a background
  thread (:mod:`.warmpool`);
* the step route (``route``: ``"fused"`` or ``"dense"``; None: the
  model's default, fused on one card, dense on a mesh) and the device are
  constructor arguments that reach the model's constructor through
  :func:`..workloads.registry.build_model_for_key`;
* the device counters an ensemble holds (``steps_done``, the alive mask)
  are copied to the host once per state they describe
  (:meth:`SimServer._host_steps`);
* a JAX device is a rank slot of a process's card (:data:`RANK_SLOTS` of
  them a process, the carve's "devices"): a mesh over rank slots of
  several processes spans them (:class:`..parallel.mesh.Mesh`, its flips
  the kernel's remote form), so on more than one process a campaign's
  members are split over the processes' ranks, not replicated, and a
  parked member's state or continuation shard is this process's ranks'
  part of it; a campaign's close frees its mesh's receive slabs;
* the JAX package's environment knobs are arguments: the fault spec
  (``fault=``), the preemption notice and the profile cap
  (:class:`..config.ServeConfig` fields).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import threading
import time

import numpy as np

from .. import config
from ..config import IOConfig, ServeConfig
from ..models.ensemble import NavierEnsemble
from ..parallel import multihost
from ..parallel import submesh as _sm
from ..telemetry import compile_log as _cl
from ..telemetry import metrics as _tm
from ..telemetry import reqtrace as _rt
from ..telemetry import tracing as _tr
from ..telemetry.exporters import MetricsDumper
from ..utils import checkpoint
from ..workloads.registry import build_model_for_key
from ..utils.faults import FaultPlan
from ..utils.journal import JournalWriter, read_journal
from ..integrity import IntegrityError
from ..utils.resilience import DispatchHang, ResilientRunner
from .fleet.gang import GangMemberLost
from .queue import DurableQueue
from .request import AdmissionError, RequestFailed, SimRequest

#: rank slots a process's card offers the sub-mesh carve (the devices of
#: two-level serving: the JAX package's test harness and a TPU host both
#: show eight)
RANK_SLOTS = 8


class _ServedEnsemble(NavierEnsemble):
    """Ensemble whose checkpoints are self-describing for the scheduler:
    ``serve_meta`` (one dict per slot: request json + step target, None =
    idle) rides the sharded manifest as digest-covered root data, so a
    restore rebuilds the slot table from the checkpoint alone — no side
    file that could go stale against the state it describes."""

    def __init__(self, model, states):
        super().__init__(model, states)
        self.serve_meta: list[dict | None] = [None] * self.k
        self.restored_meta: list[dict | None] | None = None

    def snapshot_root_items(self) -> list:
        items = super().snapshot_root_items()
        blob = np.frombuffer(
            json.dumps(self.serve_meta).encode("utf-8"), np.uint8
        ).copy()
        items.append(("serve_slots", blob, "raw"))
        return items

    def apply_restored_state(self, updates, attrs, root) -> None:
        super().apply_restored_state(updates, attrs, root)
        if "serve_slots" in root:
            meta = json.loads(
                bytes(np.asarray(root["serve_slots"], dtype=np.uint8)).decode("utf-8")
            )
            self.serve_meta = meta
            self.restored_meta = meta


def _transport_death(exc: BaseException) -> bool:
    """A collective-transport failure that means a PEER process died (gloo
    connection reset, socket closed, coordination-service abort): the
    survivors' view of a gang member's death when it strikes mid-dispatch
    instead of at a gang barrier."""
    msg = str(exc).lower()
    return any(
        marker in msg
        for marker in (
            "connection reset",
            "connection refused",
            "socket closed",
            "gloo",
            "coordination service",
            "distributed service",
        )
    )


@dataclasses.dataclass
class _Slot:
    """One ensemble lane: IDLE (masked dead, waiting for work) or RUNNING
    a request toward ``target`` TOTAL member-steps.  ``base`` counts steps
    the trajectory completed in EARLIER lane assignments (an elastic
    re-plan or a dt re-bucket resets the ensemble's per-member counter via
    ``set_member``), and ``time_base`` the sim-time those steps covered —
    possibly at a different dt than the current bucket's — so total
    progress is ``base + steps_done[index]`` and completion is
    ``base + steps_done >= target``."""

    index: int
    req: SimRequest | None = None
    target: int = 0
    base: int = 0
    time_base: float = 0.0

    @property
    def running(self) -> bool:
        return self.req is not None


class SimServer:
    """The service front: durable queue + continuous-batching scheduler.

    Batch mode (``cfg.idle_exit=True``, the default) drains the queue and
    returns a summary; daemon mode keeps polling for new work (the HTTP
    front feeds the queue concurrently) until :meth:`request_drain` or
    SIGTERM.  One instance per process — it installs signal handlers while
    :meth:`serve` runs."""

    def __init__(self, cfg: ServeConfig | None = None, *, device=None,
                 route: str | None = None, fault: str | None = None):
        self.cfg = cfg or ServeConfig()
        # the campaign models' device and step route (constructor arguments
        # of every model the registry builds); the card unless the caller
        # names another
        self.device = config.resolve_device(device)
        if route not in (None, "fused", "dense"):
            raise ValueError(f"route must be 'fused', 'dense' or None, got {route!r}")
        self.route = route
        # malformed fault specs die here, not silently
        self._fault = FaultPlan.from_spec(fault)
        self._steps_cache: tuple | None = None  # (steps_done tensor, host copy)
        self.queue = DurableQueue(
            os.path.join(self.cfg.run_dir, "queue"), max_queue=self.cfg.max_queue
        )
        # fleet mode (cfg.fleet): this server is ONE replica of a fleet
        # sharing run_dir — its journal/campaigns/metrics move under
        # replicas/<id>/ (the queue + leases + parked continuations stay
        # shared), buckets are claimed through queue-level leases, and
        # parked member states persist durably.  fleet=None leaves every
        # path below byte-identical to the single-replica behavior.
        self._fleet = self.cfg.fleet
        self._lease = None  # the ACTIVE campaign's bucket lease (root)
        self._lease_mgr = None
        self._fenced = False  # lost our lease mid-campaign (root flag)
        self._claims_closed = False  # cross-bucket preemption: drain, don't refill
        self._hb_mark = 0.0
        self._cont_mark = 0.0  # cadence mark for running-slot continuations
        # lease liveness must not ride the campaign loop's cadence: a
        # model build or first-chunk compile stalls boundaries for many
        # seconds, which would read as replica death and thrash the
        # fleet with spurious breaks.  Root runs a daemon HEARTBEAT
        # THREAD instead (pure host-side file IO — never a collective):
        # process alive == lease renewed, exactly the failure-detector
        # semantics the sweep wants.  _hb_lock serializes the thread
        # against the main loop's claim/release/fence transitions.
        self._hb_lock = threading.Lock()
        self._hb_stop: threading.Event | None = None
        self._hb_thread: threading.Thread | None = None
        self._preempted = 0
        self._quota_rejected = 0
        self._leases_broken = 0
        self._continuations = 0
        if self._fleet is not None:
            self._replica_id = self._fleet.resolved_replica_id()
            self._replica_dir = os.path.join(
                self.cfg.run_dir, "replicas", self._replica_id
            )
            self.journal_path = os.path.join(self._replica_dir, "journal.jsonl")
        else:
            self._replica_id = ""
            self._replica_dir = self.cfg.run_dir
            self.journal_path = os.path.join(self.cfg.run_dir, "journal.jsonl")
        self._journal_writer = JournalWriter(self.journal_path)
        if self._fleet is not None:
            from .fleet.lease import LeaseManager

            self._lease_mgr = LeaseManager(
                os.path.join(self.cfg.run_dir, "queue", "leases"),
                self._replica_id,
                self._fleet.resolved_ttl(),
                journal=self._journal,
            )
        self._drain = False
        # preemption notice (cfg.preempt_notice_s, fleet mode): a
        # SIGTERM arms a monotonic deadline; the drain path then parks
        # running slots as durable continuations instead of the full
        # campaign checkpoint — sized to finish inside the window, with
        # the already-loss-free SIGKILL path as the clock-ran-out
        # fallback.  The handler only sets the deadline: journaling is
        # deferred to the next safe point (_log_preempt_notice).
        self._notice_s = float(self.cfg.preempt_notice_s or 0.0)
        self._notice_deadline: float | None = None
        self._notice_logged = False
        # embedded fleet autoscaler (cfg.autoscale; None = nothing runs)
        self._autoscaler = None
        self._runner: ResilientRunner | None = None
        # bucket fairness: the key served by the previous campaign (the
        # round-robin cursor) + this campaign's claim budget consumption
        self._last_bucket: tuple | None = None
        self._campaign_claims = 0
        self._t0 = time.monotonic()
        self._global_step = 0  # member-chunk steps across campaigns
        self._member_steps = 0  # aggregate member-steps actually computed
        self._completed = 0
        self._failed = 0
        self._retried = 0
        self._pending_results: list[tuple] = []  # (obs_future, [(slot,req,..)])
        # sub-mesh campaign fence (multihost.set_device_fence): the active
        # campaign's ensemble plus every boundary dispatch whose future is
        # still unfetched — blocked on before any host-level collective so
        # full-device barriers cannot interleave with sub-mesh programs
        self._fence_ens = None
        self._inflight_futs: list = []
        self._prev_handlers: dict = {}
        self._http = None
        # live serve telemetry (telemetry/metrics.py): slot occupancy of the
        # ACTIVE campaign, the member-rate mark for the steps/s + MFU gauges,
        # and the per-member step flops of the campaign model (trace-only
        # wrappers' analytic count, computed once per campaign build)
        self._slots_state: tuple[int, int] = (0, int(self.cfg.slots))
        self._rate_mark: tuple[float, int] = (time.monotonic(), 0)
        self._flops_member: float | None = None
        # compile/device attribution bookkeeping (telemetry/compile_log):
        # the active bucket's label, the campaign-open stamp the
        # time-to-first-chunk histogram measures from, and its one-shot flag
        self._bucket_tag = ""
        self._campaign_open = time.monotonic()
        self._first_chunk_done = True
        # parked mid-flight member states: request id -> (state pytree,
        # steps completed, sim time completed, the mesh the state is laid
        # out on).  An elastic shrink or a dt re-bucket releases a lane but
        # keeps the trajectory — the next lane to claim the id continues it
        # instead of restarting.  Every host holds the same entries
        # (parking decisions are broadcast); on a mesh spanning processes
        # each holds its own ranks' blocks of the state.
        self._parked: dict[str, tuple] = {}
        self._replans = 0
        self._dt_adjusts = 0  # proactive bucket_dt_adjust events
        # two-level serving (cfg.submesh, parallel/submesh.py): the lazily
        # carved device plan, the mesh cache per carved slice, the ACTIVE
        # campaign's mesh + local-device share (telemetry), and the gang
        # chapter of the running campaign — placement resolved at model
        # build, lease group formed at open, fault scope bound for the
        # campaign's duration.  submesh=None leaves ALL of it inert: no
        # plan is carved, no gang row is journaled (CI-asserted).
        self._submesh = self.cfg.submesh
        # warm campaign pool (cfg.warm_profile, serve/warmpool.py): prebuilt
        # campaigns handed over at bucket-open; None = inert (the default)
        self._warm = None
        # admission canonicalization (cfg.canonicalize): the service-wide
        # dt ladder requests are snapped onto; None = exact-dt admission
        self._canon_ladder = None
        if self.cfg.canonicalize is not None:
            from ..utils.governor import DtLadder

            canon = self.cfg.canonicalize
            self._canon_ladder = DtLadder(
                canon.dt_anchor,
                ratio=canon.ladder_ratio,
                dt_min=canon.dt_min,
                dt_max=canon.dt_max,
            )
        self._submesh_plan: _sm.SubmeshPlan | None = None
        self._submesh_meshes: dict[int, object] = {}
        # the whole-fleet pencil mesh (several processes), built once a
        # serve; meshes of a dropped carve, whose slabs the next campaign
        # close frees
        self._mesh_cache = None
        self._retired_meshes: list = []
        # flipped by _contain_integrity when a device of THIS replica is
        # quarantined: the heartbeat carries it so the fleet proxy routes
        # new work to healthy replicas (the autoscaler replaces us)
        self._integrity_unhealthy = False
        self._active_mesh = None
        self._active_share: tuple[int, int] | None = None
        self._gang_placement: tuple | None = None  # (Submesh, replanned)
        self._gang_active: dict | None = None
        self._gang_lease = None  # fate-shared lease group (root, fleet)
        self._gangs_formed = 0
        self._gang_members_lost = 0

    # -- multihost coordination ----------------------------------------------

    @staticmethod
    def _nproc() -> int:
        return int(multihost.process_count())

    @staticmethod
    def _is_root() -> bool:
        return multihost.is_root()

    def _root_plan(self, build):
        """Compute one JSON-able scheduling decision on ROOT and broadcast
        it, so every host executes the identical collective sequence (the
        queue and the host-fetched counters may only be consulted inside
        ``build``, which runs on root alone).  Identity single-process."""
        if self._nproc() == 1:
            return build()
        return multihost.broadcast_obj(build() if multihost.is_root() else None)

    def _root_decides(self, local: bool) -> bool:
        """Root's flag, broadcast (drain/stop handshakes) — the shared
        :func:`~rustpde_mpi_tpu_torch.parallel.multihost.root_decides` primitive
        the runner's cadence/preempt handshakes also ride."""
        return multihost.root_decides(local)

    def _sync(self, tag: str) -> None:
        """Cross-host fence (service start/stop, campaign open/close)."""
        if self._nproc() == 1:
            return
        multihost.sync_hosts(tag)

    def _host_steps(self, ens) -> np.ndarray:
        """The ensemble's per-member step counts on the host: one device
        copy per counts tensor (``update_n`` and ``set_member`` make fresh
        ones), kept until the next; the lane ops here keep the copy in
        step with the tensor (:meth:`_set_member`).  The counts are the
        whole members' on every process (on a mesh spanning processes the
        alive mask reduces over every rank), so the copies are identical."""
        cached = self._steps_cache
        if cached is not None and cached[0] is ens.steps_done:
            return cached[1]
        host = ens.steps_done.cpu().numpy()
        self._steps_cache = (ens.steps_done, host)
        return host

    def _set_member(self, ens, i: int, state) -> None:
        """``ens.set_member`` with the host copy of the step counts kept
        current (the set lane's count is 0; the others do not change)."""
        host = self._host_steps(ens).copy()
        ens.set_member(i, state)
        host[i] = 0
        self._steps_cache = (ens.steps_done, host)

    @staticmethod
    def _field_layouts(model, state) -> list:
        """``(leaf, mesh, global shape)`` of every field of ``state``: the
        model's mesh and the field's spectral shape, or ``None, None`` for
        a field without a space (held whole)."""
        out = []
        for name, leaf in zip(state._fields, state):
            space = getattr(model, f"{name}_space", None)
            out.append((leaf, None, None) if space is None else
                       (leaf, model.mesh, space.shape_spectral))
        return out

    def _member_slabs(self, model, state):
        """This process's slab of each field of one member's ``state``
        (``model``'s layout; numpy): on a mesh its ranks' columns of the
        global array, the pad sliced away, so that the slabs of every
        process joined in process order are the member's global state
        (:func:`..parallel.multihost.process_slab`; the whole global array
        on one process), without a mesh the fields themselves."""
        return type(state)(*(multihost.process_slab(leaf, mesh, shape)
                             for leaf, mesh, shape in self._field_layouts(model, state)))

    def _slabs_member(self, model, slabs, like):
        """One member's state in ``model``'s layout from this process's
        slabs (:meth:`_member_slabs`' inverse); ``like``: a member state of
        the model (its dtypes and device)."""
        return type(like)(*(multihost.slab_blocks(slab, mesh, shape, leaf.dtype, leaf.device)
                            for slab, (leaf, mesh, shape)
                            in zip(slabs, self._field_layouts(model, like))))

    def _member_in(self, ens, state, mesh):
        """A member ``state`` laid out on ``mesh`` (where a park took it)
        in ``ens``'s layout: as it is on the same mesh; else through the
        member's global arrays, each process's slab joined with every
        other's (a host collective on several processes: every process
        takes the same parks in the plan's order) and placed onto ``ens``'s
        mesh, not copied block for block."""
        if mesh is ens.model.mesh:
            return state
        fields = []
        for leaf, (dst, into, shape) in zip(state, self._field_layouts(ens.model, ens.state)):
            if shape is None:
                fields.append(leaf)
                continue
            whole = multihost.process_slab(leaf, mesh, shape)
            if getattr(mesh, "spanning", False):
                whole = multihost.join_slabs(whole)
            if into is not None:
                whole = whole[..., multihost.slab_columns(into, shape)]
            fields.append(multihost.slab_blocks(whole, into, shape, dst.dtype, dst.device))
        return type(ens.state)(*fields)

    def _device_fence(self) -> None:
        """Block until the active campaign's device dispatches complete —
        installed via :func:`~rustpde_mpi_tpu_torch.parallel.multihost
        .set_device_fence` while a campaign occupies a PROPER sub-mesh.
        Host-level collectives run over EVERY device, so on a sub-mesh
        campaign their programs start immediately on the idle complement
        and the wire traffic interleaves nondeterministically with the
        campaign's in-flight collectives on the same transport pairs (gloo
        aborts with a size-mismatched op).  A full-mesh campaign never
        needs this — the barrier cannot start until the step program
        releases the devices — which is why the fence is armed only when
        ``cfg.submesh`` carves the fleet."""
        ens = self._fence_ens
        if ens is not None:
            ens.device_fence()
        futs, self._inflight_futs = self._inflight_futs, []
        for fut in futs:
            fut.result()

    def _arm_device_fence(self, ens) -> None:
        """Arm (or re-point, on a fleet swap/replan) the sub-mesh fence."""
        if self._submesh is None or self._nproc() == 1:
            return
        self._fence_ens = ens
        multihost.set_device_fence(self._device_fence)

    def _disarm_device_fence(self, drain: bool = True) -> None:
        """Remove the fence at campaign teardown.  ``drain=False`` on the
        gang-loss path: in-flight sub-mesh programs can never complete (a
        peer is dead), so containment must not block on them.  Every other
        exit drains first, so the campaign-close barrier and the next
        campaign's collectives start with an idle wire."""
        if self._fence_ens is None:
            return
        multihost.set_device_fence(None)
        if drain:
            try:
                self._device_fence()
            except Exception:
                pass  # poisoned buffers on an exceptional exit: disarm anyway
        self._fence_ens = None
        self._inflight_futs = []

    # -- client surface -------------------------------------------------------

    def submit(self, req: SimRequest | dict) -> SimRequest:
        """Admit one request (validation + bounded-queue admission control;
        raises RequestError / AdmissionError).  Thread-safe — the HTTP
        front calls this from handler threads."""
        if isinstance(req, dict):
            req = SimRequest.from_dict(req)
        elif not isinstance(req, SimRequest):
            from .request import RequestError

            raise RequestError(
                f"request must be a dict or SimRequest, got {type(req).__name__}"
            )
        if req.amp is None:
            req.amp = float(self.cfg.default_amp)
        if self._canon_ladder is not None:
            self._canonicalize(req)
        if (
            self.queue.dedupe_lookup(getattr(req, "idempotency_key", None))
            is not None
        ):
            # a retry of already-accepted work: admission policy (quota,
            # sub-mesh stamping, backpressure) must not re-judge it — the
            # queue replays the original submit's identity, nothing is
            # enqueued, and the front re-acks the first answer
            return self._ack_deduped(self.queue.submit(req))
        if self._submesh is not None:
            # two-level serving admission: stamp the sub-mesh shape the
            # grid needs (compat_key gains the stamp, so sharded buckets
            # never co-batch with vmapped ones) or reject TYPED — a grid
            # no configured shape fits is a 400 at POST time, never a
            # durable poison pill; a full sharded backlog is a 429 whose
            # Retry-After scales with the live queue depth
            from .fleet import qos as _qos

            try:
                self.queue.invalidate()
                pending = sum(
                    1
                    for _, r in self.queue.snapshot_queued()
                    if int(getattr(r, "submesh", 0)) > 0
                )
                req = _qos.admit_submesh(req, pending, self._submesh)
            except (AdmissionError, ValueError) as exc:
                reason = getattr(exc, "reason", None)
                if reason not in ("no_submesh", "capacity"):
                    raise
                _tm.counter(
                    "serve_admission_rejected_total",
                    "submits rejected by admission control",
                    reason=reason,
                ).inc()
                self._journal(
                    {
                        "event": "submesh_rejected",
                        "id": req.id,
                        "reason": reason,
                        "grid": [int(req.nx), int(req.ny)],
                    }
                )
                raise
        if self._fleet is not None:
            # the QoS quota half of the traffic contract: one tenant's
            # burst degrades into typed 429s before it can starve peers
            from .fleet import qos as _qos

            try:
                # refresh first: proxies + peer replicas write the shared
                # dir behind this process's listing cache, and a stale
                # census would under-count the tenant (the proxy path
                # invalidates before its quota check for the same reason)
                self.queue.invalidate()
                _qos.check_quota(req, self.queue.tenant_counts(), self._fleet)
            except AdmissionError as exc:
                self._quota_rejected += 1
                _tm.counter(
                    "serve_admission_rejected_total",
                    "submits rejected by admission control",
                    reason=exc.reason,
                ).inc()
                self._journal(
                    {
                        "event": "quota_rejected",
                        "id": req.id,
                        "tenant": req.tenant,
                        "priority": req.priority,
                    }
                )
                raise
        try:
            self.queue.submit(req, admit_open=not self._drain)
        except AdmissionError as exc:
            _tm.counter(
                "serve_admission_rejected_total",
                "submits rejected by admission control",
                reason=exc.reason,
            ).inc()
            raise
        if getattr(req, "deduped", False):
            # lost a concurrent same-key race inside queue.submit
            return self._ack_deduped(req)
        queued = self.queue.counts()["queued"]
        _tm.counter("serve_requests_admitted_total", "requests admitted").inc()
        _tm.gauge("serve_queue_depth", "requests waiting in queued/").set(queued)
        self._journal(
            {
                "event": "request_admitted",
                "id": req.id,
                "trace_id": req.trace_id,
                "key": list(req.compat_key),
                "steps": req.steps,
                "queued": queued,
            }
        )
        return req

    def _ack_deduped(self, req: SimRequest) -> SimRequest:
        """Journal + count one idempotent-retry hit; the returned request
        bears the ORIGINAL submit's id/trace (queue._dedupe_into)."""
        _tm.counter(
            "serve_requests_deduped_total",
            "retries answered from the idempotency index",
        ).inc()
        self._journal(
            {
                "event": "request_deduped",
                "id": req.id,
                "trace_id": req.trace_id,
                "idempotency_key": req.idempotency_key,
            }
        )
        return req

    def _canonicalize(self, req: SimRequest) -> None:
        """Admission canonicalization (cfg.canonicalize): snap ``req.dt``
        onto the service-wide dt ladder so the live compat-key space stays
        small enough for the warm pool to cover traffic.  The contract
        (README "Cold starts"): admission may move dt (within
        ``max_rel_dt_shift``, journaled ``request_canonicalized``, result
        within the documented rtol) but NEVER the simulated horizon —
        ``SimRequest.steps`` derives from horizon/dt, so the step count
        re-derives at the same physical end time — nor the physics of the
        key, seeds, priority, or deadlines.  An off-ladder dt outside the
        shift bound keeps its exact value and pays its own compile."""
        canon = self.cfg.canonicalize
        dt0 = float(req.dt)
        try:
            rung = self._canon_ladder.rung_for(dt0)
            dt1 = float(self._canon_ladder.dt(rung))
        except (ValueError, ZeroDivisionError):
            return
        if dt1 == dt0:
            return
        if abs(dt1 - dt0) / dt0 > float(canon.max_rel_dt_shift):
            return
        req.dt = dt1
        _tm.counter(
            "serve_requests_canonicalized_total",
            "requests whose dt admission snapped onto the service ladder",
        ).inc()
        self._journal(
            {
                "event": "request_canonicalized",
                "id": req.id,
                "dt_from": dt0,
                "dt_to": dt1,
                "rung": int(rung),
                "steps": req.steps,
            }
        )

    def _canonical_k(self) -> int:
        """The campaign slot count after canonicalization: ``cfg.slots``
        rounded UP to the nearest configured pool size (extra lanes start
        dead and refill from the queue like any other slot), so prebuilt
        warm-pool ensembles fit live campaigns."""
        k = int(self.cfg.slots)
        canon = self.cfg.canonicalize
        if canon is None or not canon.slot_sizes:
            return k
        sizes = sorted(int(s) for s in canon.slot_sizes)
        for size in sizes:
            if size >= k:
                return size
        return sizes[-1]

    def status(self, request_id: str) -> dict | None:
        """Lifecycle state + record for one request id (None: unknown)."""
        found = self.queue.lookup(request_id)
        if found is None:
            return None
        state, record = found
        return {"id": request_id, "state": state, **record}

    def result(self, request_id: str) -> dict | None:
        """A done request's result record; raises the typed
        :class:`RequestFailed` for a terminally failed one; None while the
        request is still queued/running."""
        found = self.queue.lookup(request_id)
        if found is None:
            raise KeyError(f"unknown request id {request_id!r}")
        state, record = found
        if state == "done":
            return record["result"]
        if state == "failed":
            err = record["error"]
            raise RequestFailed(request_id, err["reason"], err.get("dts", ()))
        return None

    def request_trace(self, request_id: str) -> dict | None:
        """One request's assembled Perfetto timeline (admission → queued →
        scheduled → chunks → re-bucket → done, across incarnations) from
        durable state alone — ``GET /requests/<id>/trace`` serves this.
        None for an unknown request; thread-safe (reads files only)."""
        return _rt.assemble_request_trace(self.cfg.run_dir, request_id)

    def profile_capture(self, seconds: float = 5.0) -> dict:
        """Start an on-demand ``torch.profiler`` capture into
        ``<run_dir>/profiles/`` (``POST /profile?seconds=N``); bounded by
        ``cfg.profile_max_s``, single-flight (a second request while one
        runs is refused in the status payload).  The profiler records on
        its own thread while chunk graphs replay: it reads the device's
        activity, never its tensors."""
        logdir = os.path.join(self.cfg.run_dir, "profiles", "manual")
        try:
            seconds = min(float(seconds), float(self.cfg.profile_max_s))
        except (TypeError, ValueError):
            pass  # the capture refuses it with its own message
        status = _cl.CAPTURE.start(logdir, seconds, reason="http")
        self._journal({"event": "profile_capture", **status})
        return status

    def request_drain(self) -> None:
        """Ask the service to drain: stop admitting, checkpoint in-flight
        slots, re-enqueue unfinished requests, return from serve()."""
        self._drain = True
        runner = self._runner
        if runner is not None:
            runner.request_drain()

    @property
    def draining(self) -> bool:
        """Public drain flag (the HTTP front's ``/healthz`` reads this —
        handlers must never reach into scheduler internals)."""
        return self._drain

    def slot_info(self) -> dict:
        """Occupancy of the ACTIVE campaign's ensemble lanes (between
        campaigns: 0 running over the configured slot count), plus the
        fleet shape — process count and mesh topology — so an operator
        probing ``/healthz`` sees WHAT is serving, not just that it is."""
        running, total = self._slots_state
        info = {
            "running": running,
            "total": total,
            "utilization": (running / total) if total else 0.0,
            "process_count": self._nproc(),
        }
        # one card a process (host state only: /healthz must not run a
        # collective or read a device tensor)
        info["devices"] = self._nproc()
        mesh = self._campaign_mesh()
        info["mesh"] = (
            {"shape": [int(mesh.nranks)], "axes": ["p"]}
            if mesh is not None
            else None
        )
        return info

    def _campaign_mesh(self, key: tuple | None = None):
        """The mesh campaign models are built on.

        Single-level serving (``cfg.submesh=None``, the default): the
        whole-fleet pencil mesh on a multi-process runtime (every rank
        slot of every process, :meth:`_fleet_mesh`: the campaign's members
        are split over the processes), None on one process.

        Two-level serving: the bucket ``key`` resolves through the carved
        :class:`~rustpde_mpi_tpu_torch.parallel.submesh.SubmeshPlan` — a stamped
        (gang) bucket is PLACED onto its carved sub-mesh (elastically
        re-mapped when the fleet shrank under the stamp, recorded for the
        ``gang_replanned`` journal row), vmapped default traffic rides the
        remainder slice when its grid divides onto it, else (several
        processes) the whole-fleet mesh.  Every carved slice holds rank
        slots of every process, so a mesh of several processes spans all
        of them.  ``key=None`` (the ``/healthz`` probe between builds)
        reports the ACTIVE campaign's mesh."""
        if self._submesh is None:
            return self._fleet_mesh() if self._nproc() > 1 else None
        if key is None:
            return self._active_mesh
        plan = self._carve_plan()
        shape = _sm.key_shape(key)
        self._gang_placement = None
        self._active_share = None
        if shape > 0:
            sub, replanned = plan.place(int(key[1]), int(key[2]), shape)
            if sub is None:
                # fleet too small for ANY carved slice: the default
                # remainder (or solo) serves it unsharded — the request
                # still resolves, only the sharding is waived
                sub, replanned = plan.default, plan.default is not None
            self._gang_placement = (sub, bool(replanned))
            self._active_mesh = self._submesh_mesh(sub)
            return self._active_mesh
        sub = plan.default
        if (
            sub is not None
            and self._nproc() > 1
            and _sm.grid_fits(int(key[1]), int(key[2]), len(sub.devices))
        ):
            self._active_mesh = self._submesh_mesh(sub)
        elif self._nproc() > 1:
            # the vmapped grid divides no carved remainder: fall back to
            # the whole-fleet pencil mesh (servability beats isolation
            # for unstamped traffic)
            self._active_mesh = self._fleet_mesh()
        else:
            self._active_mesh = None  # single-controller vmapped path
        return self._active_mesh

    def _fleet_mesh(self):
        """The whole-fleet pencil mesh, cached for the serve (the JAX
        package's ``multihost.global_pencil_mesh()``): every process's
        :data:`RANK_SLOTS` rank slots, as
        ``multihost.global_pencil_mesh(RANK_SLOTS, device)`` builds it, but
        from the carve's rank slots (host state only, so ``/healthz`` may
        ask for it without a collective)."""
        if self._mesh_cache is None:
            from ..parallel.mesh import Mesh

            self._mesh_cache = Mesh(self._rank_slot_devices())
        return self._mesh_cache

    def _carve_plan(self) -> _sm.SubmeshPlan:
        """The carved device plan, built once per incarnation.  Every
        process derives the IDENTICAL plan from the rank slots of every
        process's card in rank order (:meth:`_rank_slot_devices`) — and
        from the root-broadcast quarantine
        verdict: devices the integrity ledger quarantined are excluded
        from the carve, so later campaigns route around suspect silicon.
        A restart after a fleet resize re-carves automatically (the
        elastic re-planner: stamped buckets re-place through
        ``plan.place``); an integrity quarantine drops the cached plan
        (:meth:`_contain_integrity`) to force the same re-carve."""
        if self._submesh_plan is None:
            devices = self._rank_slot_devices()
            bad = self._quarantined_devices()
            if bad and devices:
                # the ledger strikes a card (the runner's device key); every
                # rank slot of a struck card leaves the carve with it
                keep = [d for d in devices if self._slot_card_key(d) not in bad]
                # never carve an EMPTY fleet: with every device struck the
                # quarantine is waived (servability beats suspicion) and
                # the journal row records the overridden verdict
                if keep and len(keep) < len(devices):
                    devices = keep
                self._journal(
                    {
                        "event": "carve_excluded_quarantined",
                        "devices": sorted(bad),
                        "kept": len(devices),
                        "waived": not keep,
                    }
                )
            self._submesh_plan = _sm.carve(
                devices, self._submesh.shapes, nproc=self._nproc()
            )
        return self._submesh_plan

    def _quarantined_devices(self) -> frozenset:
        """The durable quarantine verdict (integrity/ledger.py), read on
        ROOT and broadcast — the carve below must be identical on every
        host, and the ledger file lives in root's run dir."""

        def read():
            from ..integrity import QuarantineLedger

            icfg = self.cfg.integrity
            led = QuarantineLedger(
                self.cfg.run_dir,
                strikes=icfg.strikes if icfg else 2,
                strike_ttl_s=icfg.strike_ttl_s if icfg else 3600.0,
            )
            return list(led.quarantined())

        return frozenset(self._root_plan(read))

    def _rank_slot_devices(self) -> list:
        """The carve's devices: :data:`RANK_SLOTS` rank slots on each
        process's card, in rank order (a
        :class:`..parallel.multihost.HostDevice` each; ids process-major).
        Host state only: the device of every process is its own card, so
        no collective is needed."""
        dev = str(self.device)
        return [
            multihost.HostDevice(p * RANK_SLOTS + r, p, dev)
            for p in range(self._nproc())
            for r in range(RANK_SLOTS)
        ]

    @staticmethod
    def _slot_card_key(d) -> str:
        """The quarantine ledger's key of the card a rank slot lies on
        (``<type>:<index>@proc<p>``, the runner's device key)."""
        import torch

        card = torch.device(d.device)
        return f"{card.type}:{card.index or 0}@proc{int(d.process_index)}"

    def _submesh_mesh(self, sub):
        """The (cached) mesh of one carved slice, ``sub.mesh()``: its rank
        slots of every process, each process's consecutive on its card (a
        mesh spanning the processes; on one process ``make_mesh`` of the
        slice's size).  None for an empty slice or a one-slot slice in one
        process (the plain ensemble path needs no mesh)."""
        if sub is None or not sub.devices:
            return None
        if self._nproc() == 1 and len(sub.devices) <= 1:
            return None
        if sub.index not in self._submesh_meshes:
            self._submesh_meshes[sub.index] = sub.mesh()
        self._active_share = self._local_share(sub)
        return self._submesh_meshes[sub.index]

    def _close_meshes(self, meshes) -> None:
        """Free the receive slabs of ``meshes`` (each once; collective on
        a mesh spanning processes, so every process calls it at the same
        point of the root's plan; a one-process mesh holds none).  A ring
        stays usable: its next flip of a shape registers the slab again.
        The captured graphs that hold a slab's pointers go first
        (:meth:`..models.campaign.StatsAndRungs.release_chunks`)."""
        seen = set()
        for mesh in meshes:
            if mesh is not None and id(mesh) not in seen:
                seen.add(id(mesh))
                mesh.close()

    def _local_share(self, sub) -> tuple[int, int] | None:
        """(this process's rank slots inside ``sub``, its total rank
        slots) — the fleet-utilization gauges report the sub-mesh's share
        of the fleet, not all-or-nothing."""
        pidx = int(multihost.process_index())
        total = RANK_SLOTS
        mine = sum(
            1
            for d in (sub.devices if sub is not None else ())
            if int(getattr(d, "process_index", 0)) == pidx
        )
        return (mine, total)

    def stats(self) -> dict:
        out = {
            "queue": self.queue.counts(),
            "completed": self._completed,
            "failed": self._failed,
            "retried": self._retried,
            "replans": self._replans,
            "bucket_dt_adjusts": self._dt_adjusts,
            "member_steps": self._member_steps,
            "wall_s": round(time.monotonic() - self._t0, 3),
            "draining": self._drain,
            "slots": self.slot_info(),
        }
        if self._submesh is not None:
            out["gangs"] = {
                "formed": self._gangs_formed,
                "members_lost": self._gang_members_lost,
            }
        if self._fleet is not None:
            out["fleet"] = {
                "replica": self._replica_id,
                "lease": self._lease.tag if self._lease else None,
                "leases_broken": self._leases_broken,
                "preempted": self._preempted,
                "quota_rejected": self._quota_rejected,
                "continuations_persisted": self._continuations,
            }
            if self._autoscaler is not None:
                out["fleet"]["autoscale"] = self._autoscaler.stats()
        return out

    # -- service loop ---------------------------------------------------------

    def serve(self) -> dict:
        """Run the service until the queue drains (batch mode), or until a
        drain is requested (daemon mode).  Returns a summary dict.

        On a multi-process runtime every host calls this together: root
        owns the queue/journal/HTTP/results, every scheduling decision is
        root-broadcast before the collective dispatch it leads into, and
        ``sync_hosts`` fences the service open/close."""
        root = self._is_root()
        self._install_signals()
        if root:
            self._start_http()
        unclean = self._detect_unclean_shutdown() if root else False
        # fleet mode NEVER runs the global running/ recovery: peer
        # replicas' live claims would be stolen.  Recovery is scoped by
        # lease instead — the sweep breaks stale leases (our own previous
        # incarnation's included, once their TTL lapses) and re-enqueues
        # exactly those buckets' requests.
        recovered = (
            self.queue.recover() if root and self._fleet is None else []
        )
        self._journal(
            {
                "event": "server_start",
                "slots": self.cfg.slots,
                "max_queue": self.cfg.max_queue,
                "processes": self._nproc(),
                "recovered": recovered,
                "unclean_shutdown": unclean,
                "replica": self._replica_id or None,
                "fault": dataclasses.asdict(self._fault) if self._fault else None,
            }
        )
        self._fleet_heartbeat(force=True)
        self._start_heartbeat_thread()
        self._start_autoscaler()
        self._start_warm_pool()
        self._sync("serve-start")
        try:
            while not self._drain_agreed():
                key = self._next_bucket_agreed()
                if key is None:
                    if self.cfg.idle_exit and self._idle_done_agreed():
                        break
                    time.sleep(self.cfg.poll_s)
                    continue
                self._run_campaign(key)
            if self._drain:
                self._log_preempt_notice()
                self._journal({"event": "drain"})
        finally:
            import sys as _sys

            if _sys.exc_info()[0] is None:
                if root:
                    self._flush_results(force=True)
            elif self._pending_results:
                # an exception (DispatchHang above all) is propagating:
                # forcing the pending observable futures would device_get
                # against a possibly-wedged runtime with no watchdog and eat
                # the structured raise — drop them instead; the requests
                # stay claimed and queue.recover() re-runs them on restart
                self._journal(
                    {
                        "event": "results_abandoned",
                        "batches": len(self._pending_results),
                    }
                )
                self._pending_results = []
            summary = {
                # an exception exit (DispatchHang after a peer died, a
                # wedged collective) is an ERROR outcome: requests may
                # still be claimed in running/ — the next incarnation must
                # see this as an unclean shutdown and recover them
                "outcome": (
                    "error"
                    if _sys.exc_info()[0] is not None
                    else ("drained" if self._drain else "idle")
                ),
                **self.stats(),
                "journal": self.journal_path,
            }
            self._journal({"event": "server_stop", **summary})
            if root:
                # service-level metrics flush: one jsonl line at the service
                # root (campaign runners dump their own under campaigns/<key>;
                # fleet replicas dump under replicas/<id>/ so peers sharing
                # the run_dir never interleave files)
                MetricsDumper(
                    os.path.join(self._replica_dir, "metrics.jsonl")
                ).dump(step=self._global_step)
            self._stop_warm_pool()
            self._stop_autoscaler()
            self._stop_heartbeat_thread()
            self._fleet_heartbeat(force=True, stopping=True)
            self._journal_writer.close()  # reopens lazily if used again
            self._stop_http()
            if _sys.exc_info()[0] is None:
                # clean close fences (an exception path must NOT barrier:
                # the peer that caused it may already be gone); the serve's
                # meshes free their receive slabs, every process together
                self._close_meshes([self._mesh_cache, *self._submesh_meshes.values(),
                                    *self._retired_meshes])
                self._retired_meshes = []
                self._sync("serve-stop")
            self._restore_signals()
        return summary

    def _drain_agreed(self) -> bool:
        """The service-level drain flag, root-decided: a drain request (or
        signal) lands on root; every host leaves the serve loop together.
        The broadcast verdict OVERWRITES the local flag — a stray signal on
        a non-root host must be ignored (the runner's preempt handshake
        rule), not let that host leave the loop alone and wedge the
        fleet's next collective."""
        self._drain = self._root_decides(self._drain)
        return self._drain

    def _idle_done_agreed(self) -> bool:
        """Is an idle-exit (batch mode) really DONE?  Single-replica:
        yes — an empty bucket scan means an empty queue.  Fleet mode: only
        once nothing is queued, nothing is running and no bucket lease
        exists — a peer may still be serving (its lease pins its work),
        and a DEAD peer's lease needs one observer TTL before the sweep
        may break it, so a batch replica must keep polling rather than
        exit under work it will be able to reclaim.  Root decides,
        broadcast (the queue and the lease dir are root's to read)."""
        if self._fleet is None:
            return True

        def decide():
            counts = self.queue.counts()
            if counts["queued"] or counts["running"]:
                return False
            return not self._lease_mgr.holders()

        return bool(self._root_plan(decide))

    def _next_bucket_agreed(self) -> tuple | None:
        """Root picks the bucket (the queue is root's); the key is
        broadcast so every host builds the identical campaign model."""
        def pick():
            key = self._next_bucket()
            return None if key is None else list(key)

        key = self._root_plan(pick)
        return multihost.tuplify(key) if key is not None else None

    def _detect_unclean_shutdown(self) -> bool:
        """True when the previous incarnation died without a server_stop —
        read through the torn-tail-tolerant reader, since the very crash
        being detected may have torn the final journal line.  A
        ``server_stop`` with ``outcome: "error"`` counts as UNCLEAN too:
        the root of a multihost fleet that lost a peer exits structured
        (watchdogged collective -> journaled stop) but leaves claimed
        requests behind exactly like a hard kill would."""
        records = [
            r
            for r in read_journal(self.journal_path, on_error="skip")
            if r.get("event") in ("server_start", "server_stop")
        ]
        if not records:
            return False
        last = records[-1]
        return last["event"] != "server_stop" or last.get("outcome") == "error"

    # -- signals / http -------------------------------------------------------

    def _install_signals(self) -> None:
        def handler(signum, frame):
            # flag-sets only: journaling from a signal handler could
            # deadlock on a writer lock the interrupted frame holds
            if (
                signum == signal.SIGTERM
                and self._notice_s > 0
                and self._fleet is not None
                and self._notice_deadline is None
            ):
                self._notice_deadline = time.monotonic() + self._notice_s
            self.request_drain()

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev_handlers[sig] = signal.signal(sig, handler)
        except ValueError:  # not the main thread
            self._prev_handlers = {}

    def _restore_signals(self) -> None:
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers = {}

    def _start_http(self) -> None:
        if self.cfg.http_port is None:
            return
        from .http_front import HttpFront

        self._http = HttpFront(self, self.cfg.http_host, self.cfg.http_port)
        self._http.start()
        self._journal({"event": "http_listen", "address": self._http.address})

    def _stop_http(self) -> None:
        if self._http is not None:
            self._http.stop()
            self._http = None

    @property
    def http_address(self) -> tuple[str, int] | None:
        return self._http.address if self._http is not None else None

    # -- journal --------------------------------------------------------------

    def _journal(self, event: dict) -> None:
        if not self._is_root():
            return  # run_dir is shared on multihost: one journal, root's
        self._journal_writer.append(
            {"wall_s": round(time.monotonic() - self._t0, 3), **event}
        )

    # -- campaign -------------------------------------------------------------

    def _next_bucket(self) -> tuple | None:
        """Round-robin bucket selection (the fairness half of the ROADMAP
        item): buckets are ordered by their oldest queued request, and the
        pick ROTATES past the previously-served bucket — so under a
        daemon-mode mixed workload a hot bucket whose requests keep
        arriving cannot be re-picked while other buckets wait.  With one
        bucket (or none after it) this degrades to oldest-first.

        Fleet mode replaces both halves: buckets order by the QoS
        contract (priority class, then deadline slack, then arrival) and
        a bucket is only returned once its LEASE is claimed — runs on
        root (inside the broadcast pick), like the queue scan itself."""
        if self._fleet is not None:
            return self._next_bucket_fleet()
        order = self.queue.bucket_order()
        _tm.gauge(
            "serve_bucket_occupancy", "distinct compat buckets with queued work"
        ).set(len(order))
        if not order:
            return None
        if self._last_bucket in order and len(order) > 1:
            i = order.index(self._last_bucket)
            return order[(i + 1) % len(order)]
        return order[0]

    def _next_bucket_fleet(self) -> tuple | None:
        """Fleet bucket pick (root): sweep-break stale peer leases and
        re-claim their requests, then walk the QoS-ordered buckets and
        return the first whose lease this replica wins.  A bucket leased
        to a live peer is skipped — two replicas can never own one bucket
        (the lease claim is an exclusive dirent creation)."""
        from ..parallel import multihost
        from .fleet import qos as _qos
        from .fleet.lease import bucket_tag

        self._fleet_heartbeat()
        self.queue.invalidate()  # proxies + peer replicas write behind us
        if self._submesh is not None:
            from .fleet import gang as _gang

            # fate-shared gang sweep FIRST: a stale gang breaks group-
            # then-members as a unit, so no member lease of a dead gang
            # ever looks live on its own.  The bucket lease underneath is
            # swept by the ordinary pass below, which re-enqueues the
            # bucket's requests.
            for rec in _gang.stale_gangs(self._lease_mgr):
                self._journal(
                    {
                        "event": "gang_swept",
                        "bucket": rec.get("bucket"),
                        "owner": rec.get("owner"),
                    }
                )
        for rec in self._lease_mgr.sweep():
            # the dead holder's claims come back: queued again, scoped to
            # exactly the broken bucket — live peers' claims are untouched
            self._leases_broken += 1
            _tm.counter(
                "serve_leases_broken_total",
                "stale peer leases broken by this replica",
            ).inc()
            key = rec.get("bucket")
            if key and key[0] in ("gang", "gang-member"):
                continue  # gang bookkeeping: fate-shared by the gang sweep
            if key:
                key = multihost.tuplify(key)
                ids = self.queue.recover_bucket(key)
                self._journal(
                    {
                        "event": "requests_reclaimed",
                        "bucket": bucket_tag(key),
                        "owner": rec.get("owner"),
                        "ids": ids,
                    }
                )
        order = _qos.bucket_order(self.queue.snapshot_queued())
        _tm.gauge(
            "serve_bucket_occupancy", "distinct compat buckets with queued work"
        ).set(len(order))
        for key in order:
            lease = self._lease_mgr.claim(key)
            if lease is not None:
                with self._hb_lock:
                    self._lease = lease
                return key
        return None

    def _fleet_heartbeat(self, force: bool = False, stopping: bool = False) -> None:
        """Root-only liveness publication: rewrite this replica's
        heartbeat file (the proxies' /stats source) and renew the held
        bucket lease.  Cadenced by ``FleetConfig.heartbeat_s``; pure
        host-side file IO, no collectives (safe anywhere on root).  A
        renewal that discovers the lease was broken + re-claimed marks
        this replica FENCED — the boundary fence check abandons the
        campaign before any further queue write."""
        if self._fleet is None or not self._is_root():
            return
        now = time.monotonic()
        if not force and (now - self._hb_mark) < self._fleet.resolved_heartbeat():
            return
        self._hb_mark = now
        from .fleet.lease import LeaseLost
        from .fleet.proxy import write_replica_heartbeat

        try:
            write_replica_heartbeat(
                self.cfg.run_dir,
                self._replica_id,
                {
                    "draining": self._drain,
                    "stopping": bool(stopping),
                    "unhealthy": self._integrity_unhealthy,
                    "slots": list(self._slots_state),
                    "completed": self._completed,
                    "failed": self._failed,
                    "queue": self.queue.counts(),
                },
            )
        except OSError:
            pass  # heartbeat loss degrades to lease staleness, not a crash
        with self._hb_lock:
            lease = self._lease
            if lease is not None:
                try:
                    lease.renew()
                except LeaseLost as exc:
                    self._journal(
                        {
                            "event": "lease_fenced",
                            "bucket": lease.tag,
                            "detail": str(exc),
                        }
                    )
                    self._lease = None
                    self._fenced = True
            # the gang lease group renews on the same heartbeat: group
            # lease first, then every member's fencing token (gang.py) —
            # losing ANY of them fences this replica exactly like losing
            # the bucket lease (the campaign is abandoned at the next
            # boundary, no further queue write)
            glease = self._gang_lease
            if glease is not None:
                try:
                    glease.renew()
                except LeaseLost as exc:
                    self._journal(
                        {
                            "event": "lease_fenced",
                            "bucket": glease.tag,
                            "gang": True,
                            "detail": str(exc),
                        }
                    )
                    self._gang_lease = None
                    self._fenced = True

    def _start_heartbeat_thread(self) -> None:
        """Root-only, fleet-only: renew the lease + replica heartbeat on
        a daemon thread so liveness never depends on how long a compile
        or a chunk keeps the main thread busy.  File IO only — the thread
        must never touch device state or collectives."""
        if self._fleet is None or not self._is_root():
            return
        self._hb_stop = threading.Event()

        def loop():
            while not self._hb_stop.wait(self._fleet.resolved_heartbeat()):
                try:
                    self._fleet_heartbeat(force=True)
                except Exception:  # noqa: BLE001 — liveness must not crash serve
                    pass

        self._hb_thread = threading.Thread(
            target=loop, name="fleet-heartbeat", daemon=True
        )
        self._hb_thread.start()

    def _stop_heartbeat_thread(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
            if self._hb_thread is not None:
                self._hb_thread.join(timeout=5.0)
            self._hb_thread = None
            self._hb_stop = None

    def _start_autoscaler(self) -> None:
        """Embedded fleet controller (``cfg.autoscale``; root + fleet
        only): an Autoscaler daemon thread driving a local-subprocess
        launcher — pure host-side file IO + process control, never a
        collective.  With ``autoscale=None`` (the default) NOTHING here
        runs: serve behavior stays byte-identical (CI-asserted)."""
        if (
            self.cfg.autoscale is None
            or self._fleet is None
            or not self._is_root()
        ):
            return
        from .fleet.autoscaler import Autoscaler
        from .fleet.launcher import LocalProcessLauncher

        self._autoscaler = Autoscaler(
            self.cfg.run_dir,
            LocalProcessLauncher(
                self.cfg.run_dir,
                notice_s=self.cfg.autoscale.notice_s,
                device=str(self.device),
            ),
            self.cfg.autoscale,
            fleet=self._fleet,
            controller_id=f"autoscaler-{self._replica_id}",
        )
        self._autoscaler.start()

    def _stop_autoscaler(self) -> None:
        if self._autoscaler is not None:
            # the embedded controller dies with its host replica: retire
            # the replicas it launched (graceful drain — their running
            # slots park durably and their leases release) so a serve()
            # exit never orphans subprocesses
            self._autoscaler.stop(retire_fleet=True)
            self._autoscaler = None

    def _log_preempt_notice(self) -> None:
        """Journal the armed preemption notice ONCE, at the first safe
        point after the signal (never from the handler itself — the
        interrupted frame may hold the journal writer's lock)."""
        if self._notice_deadline is None or self._notice_logged:
            return
        self._notice_logged = True
        self._journal(
            {
                "event": "preempt_notice",
                "notice_s": self._notice_s,
                "remaining_s": round(
                    self._notice_deadline - time.monotonic(), 3
                ),
            }
        )

    def _campaign_dir(self, key: tuple) -> str:
        tag = hashlib.sha1(repr(key).encode()).hexdigest()[:12]
        # fleet replicas keep campaign checkpoints under their own
        # replicas/<id>/ subtree: two replicas must never rotate/sweep
        # each other's checkpoint files (cross-replica continuity rides
        # the SHARED parked/<id>/ continuation dirs instead)
        return os.path.join(self._replica_dir, "campaigns", tag)

    def _start_warm_pool(self) -> None:
        """Arm the warm campaign pool (cfg.warm_profile, serve/warmpool.py):
        resolve the traffic profile — the ``"journal"`` sentinel learns it
        from this run_dir's historical compile_build rows, anything else
        goes through ``warmpool.load_profile`` (durable JSON path or inline
        list) — and start the non-blocking background build.  Gated to
        single-process, non-submesh runtimes: a background model build on a
        mesh would run collectives off the agreed schedule and desync
        hosts.  ``warm_profile=None`` leaves all of it inert (no thread, no
        journal rows — byte-identical serve, CI-asserted)."""
        if self.cfg.warm_profile is None or self._warm is not None:
            return
        if self._nproc() != 1 or self._submesh is not None:
            return
        from . import warmpool as _wp

        source = self.cfg.warm_profile
        if isinstance(source, str) and source == "journal":
            entries = _wp.learn_profile(self.journal_path)
        else:
            entries = _wp.load_profile(source)
        if not entries:
            return
        self._warm = _wp.WarmPool(
            entries, self._warm_build, journal=self._journal
        )
        self._warm.start()

    def _stop_warm_pool(self) -> None:
        if self._warm is not None:
            self._warm.stop()

    def _model_kw(self, key: tuple) -> dict:
        """The constructor arguments of a bucket's model: the device and,
        for the kinds with a step route (``dns``, ``adjoint``), the
        route."""
        kw = {"device": self.device}
        if self.route is not None and key[0] in ("dns", "adjoint"):
            kw.update(step_kernel=self.route, conv_kernel=self.route)
        return kw

    def _warm_build(self, key: tuple, k: int | None):
        """Build one prebuilt campaign for the warm pool (background
        thread): EXACTLY the ``_build_runner`` arming — registry build
        (phase="aot" attribution), sentinels, stats, the K-member served
        ensemble with all lanes dead — plus its chunk runner (on a card:
        every kernel wrapper warmed and the chunk step captured as CUDA
        graphs, the sentinel and statistics variants where ``cfg``
        arms them; :meth:`..models.ensemble.NavierEnsemble.chunk_runner`)
        and a prewarmed observables path.  Returns ``(model, ens,
        graphs)``; the count is 0 on the CPU, where nothing is captured."""
        key = tuple(key)
        model = build_model_for_key(key, mesh=None, phase="aot", **self._model_kw(key))
        model.write_intervall = float("inf")
        if self.cfg.stability is not None:
            model.set_stability(self.cfg.stability)
        if (
            self.cfg.stats is not None
            and getattr(model, "MODEL_KIND", "") == "dns"
        ):
            model.set_stats(self.cfg.stats)
        if self.cfg.integrity is not None:
            model.set_integrity(self.cfg.integrity)
        kk = int(k) if k else self._canonical_k()
        ens = _ServedEnsemble(model, [model.state] * kk)
        ens.mark_dead(range(ens.k))
        graphs = len(ens.chunk_runner()._graphs)
        try:
            # populate the member observables path too (the
            # first-chunk path fetches observables right after the chunk)
            ens.get_observables()
        except Exception:
            pass
        ens._obs_cache = None
        return model, ens, graphs

    def _build_runner(
        self, key: tuple, k: int | None = None
    ) -> tuple[ResilientRunner, _ServedEnsemble]:
        # the bucket key IS the model spec: kind-prefixed, scenario-signed —
        # the workloads registry builds whatever physics the bucket needs
        # (DNS with/without modifiers, lnse, adjoint); on a multi-process
        # runtime the model spans the global pencil mesh, so campaign
        # dispatches are the same collective SPMD programs the runner's
        # standalone multihost runs execute.  The build seam records the
        # per-compat-key compile attribution (telemetry/compile_log.py);
        # the journal rows here are the durable copies of that observation.
        # A warm-pool hit skips ALL of it: the prebuilt campaign (model +
        # ensemble + captured chunk graphs) is handed over as-is, and the
        # only row at bucket-open is warm_pool_hit — the recompile
        # accounting stays flat by construction.
        t_build = time.perf_counter()
        if k is None:
            # canonicalization's K rounding (no checkpoint pinning the
            # size): prebuilt warm-pool ensembles then fit live campaigns
            k = self._canonical_k()
        k = int(k)
        mesh = self._campaign_mesh(key)
        warm = (
            self._warm.take(key, k)
            if self._warm is not None and mesh is None
            else None
        )
        if warm is not None:
            model, ens = warm
        else:
            model = build_model_for_key(key, mesh=mesh, **self._model_kw(key))
            model.write_intervall = float("inf")  # no flow-file callback IO
            if self.cfg.stability is not None:
                # governed campaigns: arm the on-device sentinels BEFORE the
                # ensemble builds its chunk runner (per-member CFL + pinned
                # masks); the dt response is the scheduler's per-bucket ladder
                # (_settle_predivergence), never a batch-wide governor
                model.set_stability(self.cfg.stability)
            if (
                self.cfg.stats is not None
                and getattr(model, "MODEL_KIND", "") == "dns"
            ):
                # in-scan per-member physics stats (models/stats.py): armed
                # before the ensemble's runner too; each done record then carries
                # the member's health summary.  A lane refill (set_member)
                # resets that member's averaging window — per-request stats
                # start at claim time.
                model.set_stats(self.cfg.stats)
            if self.cfg.integrity is not None:
                # SDC defense (integrity/): on-device state digests streamed
                # at every chunk boundary + sampled shadow re-execution
                # audits.  Armed before the ensemble's runner so the digest
                # entry point compiles per-member; model-kind agnostic (the
                # digest folds whatever the state pytree holds).
                model.set_integrity(self.cfg.integrity)
            ens = _ServedEnsemble(model, [model.state] * k)
            ens.mark_dead(range(ens.k))  # all lanes idle until request lands
            # two phase-stamped compile_build rows cover the campaign build
            # window: "build" is the registry seam's model construction,
            # "entry_points" the campaign-level remainder (armed sentinels +
            # the K-member ensemble trace) — they SUM to the serving path's
            # real cold cost, so TTFC attribution adds up instead of ~2x
            builds = _cl.build_counts().get(_cl.key_tag(key), 1)
            wall_total = time.perf_counter() - t_build
            wall_build = min(_cl.last_build_wall(key), wall_total)
            base = {
                "event": "compile_build",
                "key": list(key),
                "key_tag": _cl.key_tag(key),
                "builds": builds,
                "k": ens.k,
            }
            self._journal(
                {
                    **base,
                    "phase": "build",
                    "wall_s": round(wall_build, 4),
                    "recompile": builds > 1,
                }
            )
            self._journal(
                {
                    **base,
                    "phase": "entry_points",
                    "wall_s": round(max(0.0, wall_total - wall_build), 4),
                    "recompile": False,
                }
            )
        # per-member step flops for the live MFU gauge: the kernel
        # wrappers' analytic counts (no device work)
        try:
            from ..utils.profiling import step_flops

            self._flops_member = step_flops(model)
        except Exception:
            self._flops_member = None
        rcfg = self.cfg.resilience
        runner = ResilientRunner.from_config(
            ens,
            rcfg,
            max_time=float("inf"),
            save_intervall=None,
            run_dir=self._campaign_dir(key),
            checkpoint_every_s=self.cfg.checkpoint_every_s,
            # divergence policy is PER REQUEST here (backoff re-queue);
            # whole-campaign checkpoint rollback stays the reactive last
            # resort behind it
            max_retries=getattr(rcfg, "max_retries", 3) if rcfg else 3,
            _store=self._store_for(self._campaign_dir(key)),
            # serve checkpoints must carry the slot table in a manifest:
            # force the sharded two-phase format (single- or multi-process)
            io=IOConfig(sharded_checkpoints=True, overlap_dispatch=False),
            fault="",  # the server owns ONE plan across campaigns (below)
            # NO governor inside a campaign: its batch-wide set_dt would
            # silently rewrite every co-batched request's dt (dt is part of
            # the request contract AND the bucket key) — the per-request
            # dt-backoff retry is the serve-layer stability policy
            stability=None,
        )
        # the constructor inherits armed sentinels from the model as its
        # stability config — pin it back off so session() never builds the
        # batch-wide governor (the sentinels stay armed; the scheduler's
        # per-bucket ladder consumes their statuses instead)
        runner.stability = None
        runner.fault = self._fault
        runner.step = self._global_step
        runner.set_journal(self._journal_writer)
        if self.cfg.integrity is not None:
            # the quarantine ledger lives at the SERVE root, not in the
            # per-bucket campaign dir the runner would default to: strikes
            # must accumulate across campaigns (and replicas sharing the
            # run dir) for the carve filter to ever see them
            from ..integrity import QuarantineLedger

            icfg = self.cfg.integrity
            runner._integ_ledger = QuarantineLedger(
                self.cfg.run_dir,
                strikes=icfg.strikes,
                strike_ttl_s=icfg.strike_ttl_s,
            )
        return runner, ens

    def _store_for(self, run_dir: str):
        """The checkpoint store of one campaign directory: HDF5 files, or
        ``.npz`` files where ``h5py`` does not import."""
        from ..utils.resilience import file_store

        return file_store(run_dir)

    def _peek_checkpoint_members(self, run_dir: str) -> int | None:
        """The member count of the newest valid campaign checkpoint (root
        scans + broadcasts; None when no checkpoint exists or it carries no
        ensemble bookkeeping).  The fleet is BUILT at this size so the
        K-fixed sharded restore always fits, then re-planned onto the
        configured size (:meth:`_replan_fleet`)."""

        store = self._store_for(run_dir)

        def peek():
            path = store.latest()
            if path is None:
                return None
            try:
                root = store.root_data(path)
            except checkpoint.CheckpointError:
                return None
            if "members" not in root:
                return None
            return int(np.asarray(root["members"]))

        return self._root_plan(peek)

    def _run_campaign(self, key: tuple) -> None:
        # time-to-first-chunk clock starts at campaign open (model build
        # included — at production request rates compile time IS the p99)
        self._campaign_open = time.monotonic()
        self._first_chunk_done = False
        self._bucket_tag = _cl.key_tag(key)
        # discard request-trace events a PREVIOUS campaign failed to flush
        # (an exception skipped its campaign-close gather): carrying them
        # forward would misattribute that work to THIS campaign's file
        _rt.LOG.drain()
        ck_k = self._peek_checkpoint_members(self._campaign_dir(key))
        runner, ens = self._build_runner(key, k=ck_k)
        self._runner = runner
        self._arm_device_fence(ens)
        self._last_bucket = key  # round-robin cursor
        self._campaign_claims = 0  # fairness quantum consumption
        self._claims_closed = False  # re-opened per campaign
        if not self._open_gang(key):
            # gang formation lost its race (a stale generation still holds
            # the group lease until the sweep breaks it): hand the bucket
            # back and let a later pass retry — no campaign may run
            # half-gang.  Every host took this branch together (the
            # verdict is broadcast), so skipping the fences is aligned.
            self._release_bucket_lease()
            return
        if self._drain:  # a signal raced the build
            runner.request_drain()
        self._gang_fence("serve-campaign-open")
        slots: list[_Slot] = []
        try:
            with runner.session(install_signals=False, resume=False):
                self._try_resume(runner)
                if not runner.resumed and ens.k != int(self.cfg.slots):
                    # the peeked checkpoint was swept (restore failed): no
                    # state to carry — restart at the configured fleet size
                    runner, ens = self._swap_fleet(runner, ens)
                slots = self._restore_slots(runner, ens, key)
                if ens.k != int(self.cfg.slots):
                    runner, ens, slots = self._replan_fleet(
                        runner, ens, slots, key
                    )
                _tm.gauge(
                    "serve_fleet_size", "slot count of the active campaign"
                ).set(ens.k)
                self._journal(
                    {
                        "event": "campaign_start",
                        "key": list(key),
                        "dir": runner.run_dir,
                        "restored": runner.resumed,
                        "fleet": ens.k,
                        "slots_restored": sum(1 for s in slots if s.running),
                    }
                )
                self._fill_slots(runner, ens, slots, key)
                self._refresh_slot_state(slots, ens.k)
                self._campaign_loop(runner, ens, slots, key)
        except IntegrityError as exc:
            # SDC containment (integrity/): the runner detected corruption
            # it could not roll back past — a device crossed the quarantine
            # threshold, or no digest-verified state existed.  The raise is
            # collectively agreed (the quarantine verdict is root-broadcast
            # in the runner), so every host lands here together: requeue
            # the running slots from their durable parked progress (device
            # state is untrusted, never drained), drop the carve plan so
            # the next campaign excludes the quarantined device, and flag
            # the replica unhealthy.  Serve CONTINUES — unlike a gang
            # death, the collective runtime is intact.
            self._disarm_device_fence(drain=False)
            self._contain_integrity(key, slots, exc)
        except (GangMemberLost, DispatchHang) as exc:
            # gang fate-sharing: a dead member turned a barrier (typed
            # GangMemberLost from the gang watchdog) or a chunk dispatch
            # (DispatchHang) into a structured failure.  Containment is
            # HOST-LOCAL — the peer is gone, so no collective may run —
            # and only breaks THIS gang's lease: co-resident buckets'
            # requests requeue with their durable parked state and the
            # next incarnation reclaims them immediately, no TTL wait.
            # Non-gang campaigns keep the existing structured-exit path.
            self._disarm_device_fence(drain=False)
            if self._gang_active is not None:
                self._contain_gang_loss(key, slots, exc)
            raise
        except Exception as exc:
            # a gang member that dies MID-DISPATCH surfaces on the
            # survivors as the collective transport's runtime error (gloo
            # connection reset / socket closed), not as a gang barrier
            # timeout — same fate-sharing containment, same typed journal
            # row, so the bucket's requests requeue with their parked
            # progress immediately instead of waiting for the next
            # incarnation's lease sweep.
            if self._gang_active is not None and _transport_death(exc):
                self._disarm_device_fence(drain=False)
                info = self._gang_active
                self._contain_gang_loss(
                    key,
                    slots,
                    GangMemberLost(str(info.get("gang", "?")), None, str(exc)),
                )
            raise
        finally:
            self._global_step = runner.step
            self._runner = None
            self._slots_state = (0, int(self.cfg.slots))
            # host-local teardown only on this path (no collectives on a
            # possibly-exceptional exit): unbind the active trace ids and
            # zero the fleet + this bucket's MFU gauges between campaigns
            # (a labeled gauge left at its last in-flight value would read
            # as phantom utilization on every later scrape)
            _rt.clear_active()
            _tm.gauge(
                "serve_mfu",
                "model-flops utilization per compat bucket",
                bucket=self._bucket_tag,
            ).set(0.0)
            _tm.gauge(
                "serve_fleet_utilization",
                "running-slot fraction of the fleet (0 between campaigns)",
            ).set(0.0)
            _tm.gauge(
                "serve_fleet_devices_busy",
                "devices executing campaign work right now",
            ).set(0)
            self._close_gang()
            # hand the bucket lease back (root's file, host-local IO —
            # safe on the exception path too).  The release is ordered
            # AFTER every queue write of this campaign; a fenced lease
            # (LeaseLost) means a survivor already owns the bucket.
            self._release_bucket_lease()
            self._fenced = False
            self._disarm_device_fence()
            # the campaign's graphs freed here, under the capture lock, not
            # whenever the collector finds them (a warm capture in flight
            # on the pool's thread)
            ens.release_chunks()
        # the campaign's mesh (and a dropped carve's) frees its receive
        # slabs, whose shapes K, the grid and the route set: a long serve
        # would collect them campaign after campaign.  Collective, so only
        # here, where every process arrives (an exception propagating past
        # the finally above never does)
        self._close_meshes([ens.model.mesh, *self._retired_meshes])
        self._retired_meshes = []
        self._gang_fence("serve-campaign-close")

    def _release_bucket_lease(self) -> None:
        if self._fleet is None or self._lease is None:
            return
        from .fleet.lease import LeaseLost

        with self._hb_lock:
            lease, self._lease = self._lease, None
        if lease is not None:
            try:
                lease.release()
                self._journal(
                    {"event": "lease_released", "bucket": lease.tag}
                )
            except LeaseLost:
                self._journal(
                    {"event": "lease_fenced", "bucket": lease.tag}
                )

    # -- gang campaigns (two-level serving) -----------------------------------

    def _gang_fence(self, tag: str) -> None:
        """The campaign open/close fence: the plain sync for ordinary
        campaigns, the GANG barrier (its own watchdog,
        ``cfg.gang_sync_timeout_s`` -> typed
        :class:`~rustpde_mpi_tpu_torch.serve.fleet.gang.GangMemberLost`) while a
        gang campaign is open — a member SIGKILLed between fences surfaces
        structured instead of wedging every survivor."""
        if self._gang_active is None:
            self._sync(tag)
            return
        if self._nproc() == 1:
            return
        from .fleet import gang as _gang

        _gang.gang_sync(
            tag,
            str(self._gang_active["gang"]),
            member=self._gang_active.get("member"),
            timeout_s=self.cfg.gang_sync_timeout_s,
        )

    def _open_gang(self, key: tuple) -> bool:
        """Open the gang chapter of a sub-mesh campaign: resolve the
        placement the model build made, form the fate-shared lease group
        (fleet mode, root — one group lease + one fencing token per
        member), bind the fault-injection scope, journal ``gang_formed``
        (plus ``gang_replanned`` when the carve re-mapped a stamped
        bucket).  True for ordinary campaigns (nothing happens) and for a
        formed gang; False when formation lost the claim race — the
        verdict is root-broadcast, so every host refuses together."""
        self._gang_active = None
        shape = _sm.key_shape(key) if self._submesh is not None else 0
        if shape <= 0:
            return True
        sub, replanned = self._gang_placement or (None, False)
        gindex = int(sub.index) if sub is not None else 0
        member = int(multihost.process_index())

        def plan_open():
            out = {"formed": True, "generation": None}
            if self._fleet is not None:
                from .fleet.gang import GangLease

                glease = GangLease.form(
                    self._lease_mgr, key, self._nproc()
                )
                if glease is None:
                    out["formed"] = False
                else:
                    with self._hb_lock:
                        self._gang_lease = glease
                    out["generation"] = glease.generation
            return out

        plan = self._root_plan(plan_open)
        if not plan["formed"]:
            self._journal(
                {"event": "gang_form_failed", "key": list(key), "gang": gindex}
            )
            return False
        self._gang_active = {
            "gang": gindex,
            "member": member,
            "shape": int(shape),
            "devices": int(len(sub.devices)) if sub is not None else 0,
            "generation": plan["generation"],
        }
        if self._fault is not None:
            self._fault.bind_gang(gindex, member)
        self._gangs_formed += 1
        _tm.counter(
            "serve_gangs_formed_total", "gang campaigns formed"
        ).inc()
        self._journal(
            {
                "event": "gang_formed",
                "key": list(key),
                "gang": gindex,
                "shape": int(shape),
                "devices": self._gang_active["devices"],
                "members": self._nproc(),
                "generation": plan["generation"],
            }
        )
        if replanned:
            # elastic re-carve: the fleet no longer holds the stamped
            # shape — the bucket was re-placed on what fits now
            self._journal(
                {
                    "event": "gang_replanned",
                    "key": list(key),
                    "gang": gindex,
                    "stamped": int(shape),
                    "devices": self._gang_active["devices"],
                }
            )
        return True

    def _close_gang(self) -> None:
        """Host-local gang teardown on every campaign exit path: unbind
        the fault scope, zero the per-gang gauges, release the lease
        group (LeaseLost = a survivor already broke us: fine, its
        cleanup is authoritative)."""
        if self._gang_active is None:
            return
        info, self._gang_active = self._gang_active, None
        if self._fault is not None:
            self._fault.bind_gang(None, None)
        _tm.gauge(
            "serve_gang_mfu",
            "model-flops utilization per gang sub-mesh",
            gang=str(info["gang"]),
        ).set(0.0)
        if self._fleet is None:
            return
        from .fleet.lease import LeaseLost

        with self._hb_lock:
            glease, self._gang_lease = self._gang_lease, None
        if glease is not None:
            try:
                glease.release()
            except (LeaseLost, OSError):
                pass  # broken by containment or a surviving peer

    def _contain_gang_loss(self, key: tuple, slots: list[_Slot], exc) -> None:
        """Gang-death containment, HOST-LOCAL ONLY — a member is dead, so
        not one collective may run here.  Root journals the typed loss,
        requeues every running slot WITH the progress its durable parked
        continuation carries (the cadence persist is the real resume
        state; the device runtime may be wedged and is never touched),
        and breaks ONLY this gang's lease group so the next incarnation
        reclaims immediately instead of waiting out a TTL.  Queue writes
        happen only under a live bucket lease (fencing: a survivor that
        broke us already requeued these requests itself)."""
        info = self._gang_active or {}
        self._gang_members_lost += 1
        _tm.counter(
            "serve_gang_members_lost_total",
            "gang members lost (barrier watchdog / dispatch hang)",
        ).inc()
        if not self._is_root():
            return
        self._journal(
            {
                "event": "gang_member_lost",
                "key": list(key),
                "gang": info.get("gang"),
                "member": getattr(exc, "member", None),
                "generation": info.get("generation"),
                "detail": str(exc),
            }
        )
        if self._fleet is not None:
            from .fleet.lease import LeaseLost

            with self._hb_lock:
                lease = self._lease
            try:
                if lease is not None:
                    lease.guard()
            except LeaseLost:
                return
        for s in slots:
            if not s.running:
                continue
            progress, parked = int(s.base), False
            meta = checkpoint.continuation_meta(
                checkpoint.continuation_dir(self.cfg.run_dir, s.req.id)
            )
            if meta is not None:
                progress, parked = int(meta[0]), True
            self.queue.requeue(
                dataclasses.replace(s.req, progress=progress)
            )
            self._journal(
                {
                    "event": "request_requeued",
                    "id": s.req.id,
                    "trace_id": s.req.trace_id,
                    "slot": s.index,
                    "progress": progress,
                    "target": s.target,
                    "parked": parked,
                    "checkpoint": None,
                    "gang": info.get("gang"),
                }
            )
        if self._fleet is not None:
            from .fleet.gang import break_gang

            break_gang(self._lease_mgr, key, self._nproc())
            with self._hb_lock:
                self._gang_lease = None

    def _contain_integrity(self, key: tuple, slots: list[_Slot], exc) -> None:
        """Silent-data-corruption containment: every host runs this
        together (the IntegrityError raise is collectively agreed).  The
        cached carve plan is dropped so the NEXT campaign excludes the
        quarantined device; root requeues every running slot with the
        progress its durable parked continuation carries — the live device
        state failed its digest audit and is never drained into a result —
        and the replica turns unhealthy in its fleet heartbeat."""
        self._submesh_plan = None
        # their slabs are freed at the campaign's close, after its graphs
        self._retired_meshes.extend(self._submesh_meshes.values())
        self._submesh_meshes.clear()
        if getattr(exc, "device", None):
            self._integrity_unhealthy = True
        _tm.counter(
            "serve_integrity_contained_total",
            "campaigns abandoned on an unrecoverable integrity failure",
        ).inc()
        if not self._is_root():
            return
        self._journal(
            {
                "event": "integrity_contained",
                "key": list(key),
                "check": getattr(exc, "check", None),
                "step": getattr(exc, "step", None),
                "member": getattr(exc, "member", None),
                "device": getattr(exc, "device", None),
                "detail": str(exc),
            }
        )
        if self._fleet is not None:
            from .fleet.lease import LeaseLost

            with self._hb_lock:
                lease = self._lease
            try:
                if lease is not None:
                    lease.guard()
            except LeaseLost:
                return
        for s in slots:
            if not s.running:
                continue
            progress, parked = int(s.base), False
            meta = checkpoint.continuation_meta(
                checkpoint.continuation_dir(self.cfg.run_dir, s.req.id)
            )
            if meta is not None:
                progress, parked = int(meta[0]), True
            self.queue.requeue(
                dataclasses.replace(s.req, progress=progress)
            )
            self._journal(
                {
                    "event": "request_requeued",
                    "id": s.req.id,
                    "trace_id": s.req.trace_id,
                    "slot": s.index,
                    "progress": progress,
                    "target": s.target,
                    "parked": parked,
                    "checkpoint": None,
                    "integrity": True,
                }
            )
        self._fleet_heartbeat(force=True)

    def _try_resume(self, runner) -> None:
        """Campaign restore with graceful degradation: a checkpoint that no
        longer fits (slot-count/config change between incarnations — the
        sharded format is K-fixed) must NOT brick the service.  The
        incompatible checkpoints are swept (their slot geometry can never
        be restored by this server) and the campaign starts fresh — every
        request is still durably queued, so nothing is lost, only the
        drained progress."""
        try:
            runner.resumed = runner._maybe_resume()
        except checkpoint.CheckpointError as exc:
            self._journal(
                {
                    "event": "campaign_restore_failed",
                    "dir": runner.run_dir,
                    "error": str(exc),
                }
            )
            if self._is_root():
                for path in runner._store.files():
                    runner._store.remove(path)
            runner.resumed = False
            runner._last_ckpt_path = None

    def _restore_slots(self, runner, ens, key: tuple) -> list[_Slot]:
        """Rebuild the slot table after a checkpoint restore: a restored
        slot whose request is back in the queue (drain re-enqueued it, or
        crash recovery did) is RE-CLAIMED into its old lane — the member
        state is already sitting there, bit-equal — and continues from its
        checkpointed step counter.  Restored slots whose request is gone
        (completed after the checkpoint, durably recorded) go idle.

        The claims touch the queue, so ROOT builds the restore plan and
        broadcasts it; every host then applies the identical lane ops."""
        slots = [_Slot(i) for i in range(ens.k)]
        meta = ens.restored_meta if runner.resumed else None
        if not meta:
            return slots
        alive = ens.alive()  # replicated (K,) fetches: identical per host
        done = self._host_steps(ens)

        def plan_restore():
            plan = []
            for i, m in enumerate(meta[: ens.k]):
                if not m:
                    continue
                if not alive[i]:
                    # the member was dead in the checkpoint: leave the
                    # request queued — a fresh lane (fresh IC) will claim it
                    # instead of resuming a doomed trajectory
                    plan.append({"slot": i, "action": "dead"})
                    continue
                req = self.queue.claim_id(m["id"])
                if req is None:
                    # the request resolved after this checkpoint was
                    # written (durably recorded in done/): lane goes idle
                    plan.append({"slot": i, "action": "resolved"})
                    continue
                if req.compat_key != key:
                    # same id, DIFFERENT bucket: the request was re-queued
                    # at a new dt after this checkpoint (backoff retry or a
                    # dt re-bucket) — the old-dt member must not resume it;
                    # its new bucket's campaign will
                    self.queue.requeue(req)
                    plan.append({"slot": i, "action": "rebucketed"})
                    continue
                plan.append(
                    {
                        "slot": i,
                        "action": "resume",
                        "req": req.to_json(),
                        "target": int(m["target"]),
                        "base": int(m.get("base", 0)),
                        "time_base": float(m.get("time_base", 0.0)),
                    }
                )
            return plan

        for entry in self._root_plan(plan_restore):
            i = entry["slot"]
            if entry["action"] != "resume":
                ens.serve_meta[i] = None
                if entry["action"] in ("resolved", "rebucketed"):
                    ens.mark_dead([i])
                continue
            req = SimRequest.from_json(entry["req"])
            slots[i] = _Slot(
                i,
                req=req,
                target=entry["target"],
                base=entry["base"],
                time_base=entry["time_base"],
            )
            self._journal(
                {
                    "event": "request_scheduled",
                    "id": req.id,
                    "trace_id": req.trace_id,
                    "slot": i,
                    "target": slots[i].target,
                    "restored": True,
                    "steps_done": entry["base"] + int(done[i]),
                }
            )
        return slots

    def _swap_fleet(self, runner, ens) -> tuple:
        """A fresh all-idle fleet at the configured size over the SAME
        campaign model (no state carried — used when the peeked checkpoint
        turned out unrestorable)."""
        model = ens.model
        new_ens = _ServedEnsemble(model, [model.state] * int(self.cfg.slots))
        new_ens.mark_dead(range(new_ens.k))
        new_ens.io_pipeline = getattr(ens, "io_pipeline", None)
        ens.release_chunks()
        runner.pde = new_ens
        if self._fence_ens is not None:
            self._fence_ens = new_ens
        return runner, new_ens

    def _replan_fleet(
        self, runner, old_ens, old_slots: list[_Slot], key: tuple
    ) -> tuple:
        """Elastic fleet re-planning: the restored fleet's slot count
        differs from the configured one.  Restored mid-flight trajectories
        move into the new lanes (``set_member`` — no recompile, the model
        is shared); on a SHRINK the surplus trajectories are PARKED (member
        state held in memory for the next lane to claim them) and their
        requests re-enqueued at their checkpointed progress; on a GROW the
        extra lanes refill from the queue through the normal path.  A
        ``campaign_replanned`` journal event records old/new K, and a fresh
        checkpoint at the new geometry replaces the stale-K ones (which
        could never restore this fleet)."""
        want = int(self.cfg.slots)
        old_k = old_ens.k
        new_ens = _ServedEnsemble(old_ens.model, [old_ens.model.state] * want)
        new_ens.mark_dead(range(new_ens.k))
        new_ens.time = old_ens.time
        new_ens.io_pipeline = getattr(old_ens, "io_pipeline", None)
        done = self._host_steps(old_ens)
        running = [s for s in old_slots if s.running]  # identical per host

        def plan_replan():
            plan = []
            for j, s in enumerate(running):
                steps = s.base + int(done[s.index])
                tdone = s.time_base + int(done[s.index]) * float(s.req.dt)
                entry = {
                    "old": s.index,
                    "req": s.req.to_json(),
                    "target": int(s.target),
                    "base": steps,
                    "time_base": tdone,
                }
                if j < want:
                    entry.update(op="keep", new=j)
                else:
                    entry.update(op="park")
                plan.append(entry)
            return plan

        kept = parked = 0
        new_slots = [_Slot(i) for i in range(want)]
        for entry in self._root_plan(plan_replan):
            req = SimRequest.from_json(entry["req"])
            state = old_ens.member_state(entry["old"])  # device op, all hosts
            if entry["op"] == "keep":
                j = entry["new"]
                # the new fleet shares the model, so its mesh: a block copy
                self._set_member(new_ens, j, state)
                new_slots[j] = _Slot(
                    j,
                    req=req,
                    target=entry["target"],
                    base=entry["base"],
                    time_base=entry["time_base"],
                )
                new_ens.serve_meta[j] = {
                    "id": req.id,
                    "target": entry["target"],
                    "base": entry["base"],
                    "time_base": entry["time_base"],
                    "req": json.loads(req.to_json()),
                }
                kept += 1
            else:
                # park: the trajectory stays continuable in this process
                # (and, fleet mode, durably in parked/<id>/ — a crash
                # before the park is re-claimed no longer restarts it)
                self._park_member(
                    req, old_ens, state, int(entry["base"]), float(entry["time_base"])
                )
                parked += 1
                if self._is_root():
                    self.queue.requeue(
                        dataclasses.replace(req, progress=int(entry["base"]))
                    )
                self._journal(
                    {
                        "event": "request_requeued",
                        "id": req.id,
                        "trace_id": req.trace_id,
                        "slot": entry["old"],
                        "progress": entry["base"],
                        "target": entry["target"],
                        "parked": True,
                        "checkpoint": None,
                    }
                )
        old_ens.release_chunks()
        runner.pde = new_ens
        if self._fence_ens is not None:
            self._fence_ens = new_ens
        self._replans += 1
        _tm.counter(
            "serve_replans_total", "elastic fleet re-plans across restarts"
        ).inc()
        _tm.gauge(
            "serve_fleet_size", "slot count of the active campaign"
        ).set(new_ens.k)
        self._journal(
            {
                "event": "campaign_replanned",
                "key": list(key),
                "old_slots": old_k,
                "new_slots": want,
                "kept": kept,
                "parked": parked,
            }
        )
        # anchor the new geometry, then sweep the stale-K checkpoints (a
        # reactive rollback must never hand this fleet an old-K manifest)
        path = runner.checkpoint_now("replan")
        if self._is_root():
            for p in runner._store.files():
                if p != path:
                    runner._store.remove(p)
        return runner, new_ens, new_slots

    def _refresh_slot_state(self, slots: list[_Slot], total: int) -> None:
        """Keep ``slot_info()`` (/healthz) AND the Prometheus gauge honest
        the moment lanes are claimed/released — not just at chunk
        boundaries, where the first (compile-heavy) chunk would report 0
        running for many seconds and a post-settle sample would
        under-report lanes the refill is about to reclaim."""
        running = sum(1 for s in slots if s.running)
        self._slots_state = (running, total)
        util = (running / total) if total else 0.0
        _tm.gauge(
            "serve_slot_utilization", "running slots / campaign slot count"
        ).set(util)
        # this process's card (gauges stay per-host in the fleet snapshot,
        # so per-host values must sum to the global count)
        devices = 1
        # fleet-level view (the mesh-sharded-serve item's gate gauges): a
        # single-level campaign spans every device (all-or-nothing); a
        # sub-mesh campaign reports only ITS slice's share of the fleet,
        # so co-resident gauges sum to the true fleet utilization
        fleet_util = util
        if self._active_share is not None:
            mine, local_total = self._active_share
            if local_total:
                fleet_util = util * (mine / local_total)
            devices = mine
        _tm.gauge(
            "serve_fleet_utilization",
            "running-slot fraction of the fleet (0 between campaigns)",
        ).set(fleet_util)
        _tm.gauge(
            "serve_fleet_devices_busy",
            "devices executing campaign work right now",
        ).set(devices if running else 0)

    def _fill_slots(self, runner, ens, slots: list[_Slot], key: tuple) -> None:
        """Refill every idle lane from this bucket's queue (fresh IC via
        the template model's generator; ``set_member`` installs it without
        recompiling).

        Bucket fairness: one campaign visit claims at most
        ``cfg.bucket_quantum`` requests while OTHER buckets hold queued
        work — past the quantum the refill stops, the campaign drains its
        running slots and ends, and the round-robin pick serves the next
        bucket (this bucket's tail gets its next turn).  With no competing
        bucket the quantum is waived (no reason to cycle)."""
        quantum = int(self.cfg.bucket_quantum)
        idle = [s.index for s in slots if not s.running]
        if not idle:  # identical slot tables on every host: consistent skip
            return
        if self._claims_closed:
            # a cross-bucket preemption closed this campaign: freed lanes
            # stay idle so the campaign drains (flag is derived from a
            # broadcast plan — identical on every host, consistent skip)
            return

        def plan_fill():
            plan = {"assign": [], "quantum": False, "claims": self._campaign_claims}
            if self._drain:  # lint-ok: RPD001 root-only plan closure; the returned plan is broadcast_obj'd before any host acts
                # drain check lives INSIDE the root plan: a host-local
                # early-return here would skip the broadcast on the host
                # the signal landed on while its peers enter it — one
                # collective out of phase, wedged fleet
                return plan
            if self._fleet is not None:
                self.queue.invalidate()  # proxies feed this bucket live
            for i in idle:
                if (
                    quantum > 0
                    and plan["claims"] >= quantum
                    and self.queue.other_bucket_waiting(key)
                ):
                    plan["quantum"] = True
                    break
                req = self.queue.claim(key, qos=self._fleet is not None)
                if req is None:
                    break
                if req.amp is None:
                    # proxy-admitted requests bypass SimServer.submit's
                    # default-amp stamping: stamp at claim so the done
                    # record names the IC amplitude solo reruns need
                    req.amp = float(self.cfg.default_amp)
                plan["claims"] += 1
                parked = req.id in self._parked
                durable = False
                base, tdone = 0, 0.0
                if parked:
                    _, base, tdone, _ = self._parked[req.id]
                elif self._fleet is not None:
                    # cross-replica continuation: the park was persisted
                    # by a (possibly dead) peer — the manifest carries the
                    # progress accounting, the shards the member state
                    meta = checkpoint.continuation_meta(
                        checkpoint.continuation_dir(self.cfg.run_dir, req.id)
                    )
                    if meta is not None:
                        durable = True
                        base, tdone = meta
                if parked or durable:
                    # requeue-with-state continuation (elastic shrink / dt
                    # re-bucket / preemption): the remaining debt is the
                    # request's horizon minus the sim time already
                    # covered, at the CURRENT bucket's dt
                    target = base + max(
                        1, round((float(req.horizon) - tdone) / float(req.dt))
                    )
                else:
                    target = req.steps
                plan["assign"].append(
                    {
                        "slot": i,
                        "req": req.to_json(),
                        "parked": parked,
                        "durable": durable,
                        "base": base,
                        "time_base": tdone,
                        "target": target,
                    }
                )
            return plan

        plan = self._root_plan(plan_fill)
        self._campaign_claims = int(plan["claims"])
        if plan["quantum"]:
            self._journal(
                {
                    "event": "bucket_quantum",
                    "key": list(key),
                    "claims": self._campaign_claims,
                }
            )
        for a in plan["assign"]:
            req = SimRequest.from_json(a["req"])
            slot = slots[a["slot"]]
            if a["parked"]:
                # every host holds the parked entry (parking decisions are
                # broadcast) — a missing one is a bug, not a fallback case;
                # a park from another mesh is re-placed through its global
                # arrays
                state, _, _, mesh = self._parked.pop(req.id)
                state = self._member_in(ens, state, mesh)
            elif a.get("durable"):
                # a peer's durable park (it may be dead — that is the
                # point): restore mid-flight; a failed verification
                # degrades to a fresh trajectory with the debt reset —
                # by FLEET-AGREED verdict, so no host can restore while
                # a peer with a torn shard starts over
                state = self._load_continuation(req, ens, slot.index)
                if self._continuation_agreed(state is not None):
                    _tm.counter(
                        "serve_continuations_resumed_total",
                        "requests resumed mid-flight from durable parked state",
                    ).inc()
                    self._journal(
                        {
                            "event": "continuation_resumed",
                            "id": req.id,
                            "trace_id": req.trace_id,
                            "steps": int(a["base"]),
                            "time": float(a["time_base"]),
                        }
                    )
                else:
                    if state is not None:
                        self._journal(
                            {
                                "event": "continuation_restore_failed",
                                "id": req.id,
                                "error": "a peer host failed its shard read",
                            }
                        )
                    a = {**a, "base": 0, "time_base": 0.0, "target": req.steps}
                    state = ens.fresh_member_state(
                        req.seed, req.amp or self.cfg.default_amp
                    )
            else:
                state = ens.fresh_member_state(
                    req.seed, req.amp or self.cfg.default_amp
                )
            self._set_member(ens, slot.index, state)
            slot.req = req
            slot.target = int(a["target"])
            slot.base = int(a["base"])
            slot.time_base = float(a["time_base"])
            ens.serve_meta[slot.index] = {
                "id": req.id,
                "target": slot.target,
                "base": slot.base,
                "time_base": slot.time_base,
                "req": json.loads(req.to_json()),
            }
            self._journal(
                {
                    "event": "request_scheduled",
                    "id": req.id,
                    "trace_id": req.trace_id,
                    "slot": slot.index,
                    "target": slot.target,
                    "restored": False,
                    "parked": bool(a["parked"]),
                    "base": slot.base,
                    "step": runner.step,
                }
            )

    def _boundary_gauges(self) -> None:
        """Refresh the live queue/throughput gauges at one chunk boundary —
        host-side bookkeeping the scheduler already holds (slot occupancy
        is kept by :meth:`_refresh_slot_state` at claim/release time, so
        the gauge and ``slot_info()`` can never disagree).  MFU is labeled
        PER BUCKET (``profiling.step_flops`` of this campaign's model ×
        measured member rate), and the per-device memory watermarks refresh
        here too (None-safe: CPU backends report nothing)."""
        _tm.gauge("serve_queue_depth", "requests waiting in queued/").set(
            self.queue.counts()["queued"]
        )
        now = time.monotonic()
        mark_t, mark_steps = self._rate_mark
        if now > mark_t and self._member_steps > mark_steps:
            rate = (self._member_steps - mark_steps) / (now - mark_t)
            _tm.gauge(
                "serve_member_steps_per_sec",
                "aggregate member-steps/s across running slots",
            ).set(rate)
            if self._flops_member:
                from ..utils.profiling import PEAK_FLOPS, peak_flops_key

                mfu = (
                    self._flops_member
                    * rate
                    / PEAK_FLOPS[peak_flops_key(self.device)]
                )
                _tm.gauge(
                    "serve_mfu",
                    "model-flops utilization per compat bucket",
                    bucket=self._bucket_tag,
                ).set(mfu)
                if self._gang_active is not None:
                    # the per-gang view of the same quantity: one labeled
                    # series per carved sub-mesh, zeroed at campaign close
                    _tm.gauge(
                        "serve_gang_mfu",
                        "model-flops utilization per gang sub-mesh",
                        gang=str(self._gang_active["gang"]),
                    ).set(mfu)
        self._rate_mark = (now, self._member_steps)
        _cl.update_device_memory_gauges()

    def _campaign_loop(self, runner, ens, slots: list[_Slot], key: tuple) -> None:
        root = self._is_root()
        while True:
            running = [s for s in slots if s.running]
            if not running:
                break
            done = self._host_steps(ens)
            n = int(
                self._root_plan(
                    lambda: max(
                        1,
                        min(
                            min(
                                s.target - (s.base + int(done[s.index]))
                                for s in running
                            ),
                            int(self.cfg.chunk_steps),
                        ),
                    )
                )
            )
            before = runner.step
            # bind the on-device trace ids for this dispatch: flight spans
            # and incident dumps during the chunk are request-attributable
            _rt.bind_slots(
                {s.index: s.req.trace_id for s in running if s.req.trace_id}
            )
            t0_wall = time.time()
            with _tr.span("serve_chunk", steps=n, slots=len(running)):
                runner.advance(n)
            advanced = runner.step - before
            if self._first_chunk_done is False and advanced > 0:
                self._first_chunk_done = True
                self._journal(
                    {
                        **_cl.observe_first_chunk(
                            key, time.monotonic() - self._campaign_open
                        ),
                        "key": list(key),
                        "step": runner.step,
                    }
                )
            if _rt.enabled() and advanced > 0:
                dur = time.time() - t0_wall
                for s in running:
                    if s.req.trace_id:
                        _rt.chunk_span(
                            s.req.trace_id,
                            t0_wall,
                            dur,
                            slot=s.index,
                            steps=advanced,
                            step=runner.step,
                        )
            self._member_steps += advanced * len(running)
            if self.cfg.stability is not None and ens.pre_divergence_latched:
                # the chunk rolled back in memory while every member is
                # still finite: re-bucket the pinned requests down the
                # per-bucket dt ladder (proactive — no NaN, no checkpoint)
                self._settle_predivergence(runner, ens, slots, key)
            if self._fleet is not None:
                # fleet boundary work (config-aligned guard: every host
                # holds the same cfg, so the broadcasts inside stay in
                # lockstep): liveness heartbeat + lease renewal and the
                # fencing verdict BEFORE the settle's queue writes (a
                # replica that stalled past its TTL must not complete
                # requests a peer has reclaimed), then deadline-driven
                # preemption after it
                self._fleet_heartbeat()
                if self._fence_check(ens, slots, key):
                    return
            with _tr.span("serve_settle", step=runner.step):
                self._settle_boundary(runner, ens, slots, key)
            if self._fleet is not None:
                self._maybe_preempt(runner, ens, slots, key)
                self._persist_running_continuations(ens, slots)
            self._refresh_slot_state(slots, ens.k)
            self._boundary_gauges()
            # boundary housekeeping: deferred sharded commit + cadence
            # checkpoint + the drain/preemption flag — runner.on_boundary is
            # the same hook integrate() would drive, and its verdict is
            # root-broadcast (a local self._drain on root rides the
            # runner's interrupt flag via request_drain)
            if runner.on_boundary():
                self._drain = True
                self._drain_campaign(runner, ens, slots, key)
                return
            self._fill_slots(runner, ens, slots, key)
            self._refresh_slot_state(slots, ens.k)
            if root:
                self._flush_results()
        if root:
            self._flush_results(force=True)
        self._flush_reqtrace(runner, key)
        self._journal({"event": "campaign_end", "key": list(key),
                       "step": runner.step})
        # a cleanly finished campaign leaves no work to restore: settle the
        # async writer FIRST (a background shard write must never race the
        # sweep), then remove its checkpoints so a LATER campaign in this
        # bucket starts fresh instead of restoring a stale slot table
        runner._drain_io()
        if root:
            for path in runner._store.files():
                runner._store.remove(path)

    def _fence_check(self, ens, slots: list[_Slot], key: tuple) -> bool:
        """Fleet fencing at a chunk boundary: did a survivor break this
        replica's lease (we stalled past the TTL) and re-claim the bucket?
        Root's verdict is broadcast; a fenced campaign is ABANDONED — the
        lanes go idle in memory and NOT one queue write is made, because
        every request now durably belongs to the new lease holder (the
        breaker already re-enqueued them): results still pending are
        dropped.  The verdict reads the lease itself (:meth:`.Lease.guard`),
        not only the heartbeat thread's last renewal, which a stalled
        process may not have made yet."""
        from .fleet.lease import LeaseLost

        def verdict():
            if self._fenced:
                return True
            with self._hb_lock:
                lease = self._lease
            if lease is None:
                return False
            try:
                lease.guard()
            except LeaseLost as exc:
                self._journal({"event": "lease_fenced", "bucket": lease.tag,
                               "detail": str(exc)})
                with self._hb_lock:
                    self._lease = None
                return True
            return False

        fenced = bool(self._root_plan(verdict))
        if not fenced:
            return False
        self._pending_results = []
        for s in slots:
            if s.running:
                self._release(ens, s)
        # the in-memory parks are stale the moment we are fenced: the new
        # lease holder may progress/re-bucket those requests and write
        # NEWER durable continuations, which a surviving _parked entry
        # would shadow on a later re-claim (plan_fill prefers the memory
        # fast path).  Durable state is authoritative across a fence.
        self._parked.clear()
        self._journal({"event": "campaign_fenced", "key": list(key)})
        self._fenced = False
        return True

    def _maybe_preempt(self, runner, ens, slots: list[_Slot], key: tuple) -> None:
        """Deadline-driven preemption (the QoS contract's teeth): when a
        queued deadline request's slack runs below the configured
        threshold, park running best-effort lanes for it — through the
        SAME requeue-with-state machinery as an elastic shrink, now
        durable, so the preempted request loses nothing.  Root plans
        (queue scan + policy), the plan is broadcast, every host executes
        the identical lane ops."""
        if not self._fleet.preempt:
            return
        done = self._host_steps(ens)

        def decide():
            from .fleet import qos as _qos

            self.queue.invalidate()
            loaded = self.queue.snapshot_queued()
            at_risk = _qos.find_at_risk(
                loaded, float(self._fleet.preempt_slack_s)
            )
            if at_risk is None:
                return {"victims": [], "for": None}
            running = [(s.index, s.req) for s in slots if s.running]
            victims = _qos.preempt_victims(running, at_risk, key)
            by_index = {s.index: s for s in slots}
            return {
                "for": at_risk.id,
                "for_priority": at_risk.priority,
                # a CROSS-bucket emergency must also close this campaign's
                # claims: the parked victims land back in THIS bucket's
                # queue, and an open refill would re-claim them at the
                # same boundary — park/requeue churn forever, the urgent
                # bucket never reached
                "cross_bucket": tuple(at_risk.compat_key) != tuple(key),
                "victims": [
                    {
                        "slot": i,
                        "steps": by_index[i].base + int(done[i]),
                        "time": by_index[i].time_base
                        + int(done[i]) * float(by_index[i].req.dt),
                    }
                    for i in victims
                ],
            }

        plan = self._root_plan(decide)
        if plan["victims"] and plan.get("cross_bucket"):
            # every host computes this from the broadcast plan: the
            # campaign stops claiming, drains its remaining lanes, and
            # ends — the QoS-ordered bucket pick then takes the urgent one
            self._claims_closed = True
        for entry in plan["victims"]:
            s = slots[entry["slot"]]
            req = s.req
            state = ens.member_state(s.index)  # device op, all hosts
            self._release(ens, s)
            self._park_member(req, ens, state, entry["steps"], entry["time"])
            if self._is_root():
                self.queue.requeue(
                    dataclasses.replace(req, progress=int(entry["steps"]))
                )
            self._preempted += 1
            _tm.counter(
                "serve_preemptions_total",
                "best-effort lanes parked for at-risk deadline requests",
            ).inc()
            self._journal(
                {
                    "event": "request_preempted",
                    "id": req.id,
                    "trace_id": req.trace_id,
                    "slot": entry["slot"],
                    "priority": req.priority,
                    "steps_done": entry["steps"],
                    "preempted_for": plan["for"],
                }
            )

    def _flush_reqtrace(self, runner, key: tuple) -> None:
        """Gather every host's request-trace events for the closing
        campaign and write one Perfetto file next to its checkpoints
        (root-only write, allgather underneath — so the call sites are the
        campaign-close and drain paths, where the fleet is aligned; the
        env-pinned reqtrace flag makes the skip aligned too)."""
        path = _rt.write_campaign_trace(runner.run_dir, self._bucket_tag)
        if path is not None:
            self._journal(
                {"event": "campaign_trace", "key": list(key), "path": path}
            )

    def _settle_boundary(self, runner, ens, slots: list[_Slot], key: tuple) -> None:
        """Process completions and deaths at a chunk boundary.  The
        observables for every slot that finished here ride ONE member-stacked
        async dispatch (observable futures) captured BEFORE any lane is refilled,
        so the fetched values are the finished members' final states.

        Root decides who finished/died (broadcast); every host executes the
        identical release/refill lane ops and the observable dispatch."""
        alive = ens.alive()
        done = self._host_steps(ens)
        # a member that stopped advancing via the model's SUCCESS criterion
        # (the adjoint finder's residual convergence) finished early — it is
        # a completion, not a death, even below its step target.  The
        # done-ok probe is a device dispatch: EVERY host executes it (a
        # root-only dispatch would desynchronize the collective program
        # sequence on a multi-process mesh).
        done_ok = ens.done_ok_members()

        def decide():
            finished, dead = [], []
            for s in slots:
                if not s.running:
                    continue
                total = s.base + int(done[s.index])
                if (alive[s.index] and total >= s.target) or done_ok[s.index]:
                    finished.append({"slot": s.index, "steps": total})
                elif not alive[s.index]:
                    dead.append({"slot": s.index, "steps": total})
            return {"finished": finished, "dead": dead}

        plan = self._root_plan(decide)
        if plan["finished"]:
            obs_fut = ens.get_observables_async()  # one dispatch, all hosts
            names = tuple(ens.observable_names)
            # per-request physics-stats summary (cfg.stats armed): the
            # health readout is captured HERE, before any lane is released
            # or refilled (a refill zeroes that member's sums) — collective
            # dispatch on all hosts, like the observables
            stats_fut = stats_names = None
            if getattr(ens, "stats_armed", False):
                from ..models.stats import HEALTH_NAMES

                stats_fut = ens.stats_health_async()
                stats_names = HEALTH_NAMES
            # end-state digest per finished member (integrity armed):
            # captured with the observables, before any refill — the done
            # record carries it so the fleet proxy's cross-replica vote can
            # compare two replicas' results without shipping state
            dig_fut = None
            if getattr(ens, "integrity_armed", False):
                dig_fut = ens.state_digest_async()
            if self._fence_ens is not None:
                # EVERY host stashes the dispatch handles for the sub-mesh
                # fence (root alone keeps them in _pending_results): the
                # lanes refill right after this, so the ensemble's obs
                # cache rebinds and can no longer fence THESE programs
                self._inflight_futs.append(obs_fut)
                if stats_fut is not None:
                    self._inflight_futs.append(stats_fut)
                if dig_fut is not None:
                    self._inflight_futs.append(dig_fut)
            batch = []
            for d in plan["finished"]:
                s = slots[d["slot"]]
                batch.append(
                    {
                        "slot": s.index,
                        "req": s.req,
                        "names": names,
                        "stats_fut": stats_fut,
                        "stats_names": stats_names,
                        "dig_fut": dig_fut,
                        "steps": int(d["steps"]),
                        "finished_wall": time.time(),
                        "step": runner.step,
                    }
                )
                self._release(ens, s)
            if self._is_root():
                self._pending_results.append((obs_fut, batch))
        for d in plan["dead"]:
            self._handle_death(runner, ens, slots[d["slot"]], int(d["steps"]))

    def _release(self, ens, slot: _Slot) -> None:
        """Lane back to idle (masked dead until refilled)."""
        ens.serve_meta[slot.index] = None
        ens.mark_dead([slot.index])
        slot.req = None
        slot.target = 0
        slot.base = 0
        slot.time_base = 0.0

    def _park_member(self, req, ens, state, base: int, time_base: float) -> None:
        """Park one mid-flight member state for later continuation (an
        elastic shrink, a dt re-bucket, a QoS preemption).  Always held in
        memory — the fast path for a park re-claimed by THIS process — and
        in fleet mode ALSO persisted through the two-phase continuation
        writer into the shared ``parked/<id>/`` dir, so requeue-with-state
        survives replica SIGKILL: any replica resumes the trajectory
        mid-flight instead of restarting it from step 0.  (On a
        multi-process replica the persist is collective, and every host
        reaches it through the same broadcast plan that parked the lane.)
        ``state`` is ``ens``'s member state, which the park keeps with its
        mesh: this process's ranks' blocks on a mesh spanning processes."""
        self._parked[req.id] = (state, int(base), float(time_base), ens.model.mesh)
        if self._fleet is None or not self._fleet.durable_park:
            return
        self._write_continuation(req, ens, state, int(base), float(time_base))

    def _write_continuation(self, req, ens, state, base: int, time_base: float) -> bool:
        """Persist one member state of ``ens`` into the shared
        ``parked/<id>/`` continuation dir (two-phase; collective on
        multi-process — every host reaches this through a broadcast plan):
        each process's shard is its slab of the member's global state
        (:meth:`_member_slabs`: its ranks' columns, the pad sliced away; the
        whole state on one process, the JAX package's format)."""
        cdir = checkpoint.continuation_dir(self.cfg.run_dir, req.id)
        try:
            checkpoint.write_continuation(
                cdir,
                self._member_slabs(ens.model, state),
                base=int(base),
                time_base=float(time_base),
                meta={
                    "id": req.id,
                    "dt": float(req.dt),
                    # the sub-mesh stamp rides the manifest so a resuming
                    # gang can verify the parked shards' topology matches
                    # the bucket it re-forms under (checkpoint.
                    # continuation_record reads it back)
                    "submesh": int(getattr(req, "submesh", 0)),
                },
            )
        except (checkpoint.CheckpointError, OSError) as exc:
            # degrade to the in-memory park (held here + the queued
            # record): the request survives, only the mid-flight resume
            # across a replica death is lost for this persist
            self._journal(
                {
                    "event": "continuation_persist_failed",
                    "id": req.id,
                    "error": str(exc),
                }
            )
            return False
        self._continuations += 1
        _tm.counter(
            "serve_continuations_persisted_total",
            "parked member states persisted into parked/<id>/ dirs",
        ).inc()
        self._journal(
            {
                "event": "continuation_persisted",
                "id": req.id,
                "trace_id": req.trace_id,
                "steps": int(base),
                "time": float(time_base),
            }
        )
        return True

    def _persist_running_continuations(self, ens, slots: list[_Slot]) -> None:
        """Fleet cadence persist: flow every RUNNING slot's member state
        into its ``parked/<id>/`` continuation dir, so a replica SIGKILL
        loses at most one cadence window of progress — the survivor that
        breaks our lease re-claims the requests and resumes them
        MID-FLIGHT from this state (campaign checkpoints cannot serve
        that role: they live under the dead replica's private subtree and
        restore only onto its exact slot geometry).  The cadence verdict
        is root-decided and broadcast (wall clocks are host-local); the
        per-slot work then executes identically everywhere."""
        running = [s for s in slots if s.running]
        if not running:
            return
        cadence = self._fleet.resolved_heartbeat()
        due = bool(
            self._root_plan(
                lambda: (time.monotonic() - self._cont_mark) > cadence
            )
        )
        if not due:
            return
        self._cont_mark = time.monotonic()
        done = self._host_steps(ens)
        for s in running:
            state = ens.member_state(s.index)  # device op, all hosts
            self._write_continuation(
                s.req,
                ens,
                state,
                s.base + int(done[s.index]),
                s.time_base + int(done[s.index]) * float(s.req.dt),
            )

    def _load_continuation(self, req, ens, slot_index: int):
        """Restore one durable continuation for a claimed request (the
        cross-replica resume path: the park was made by a replica that is
        gone).  None on verification failure.  The caller must agree the
        use/degrade verdict ACROSS HOSTS before acting (a per-host fall
        back would hand different lanes different states) — so success is
        journaled there, not here."""
        cdir = checkpoint.continuation_dir(self.cfg.run_dir, req.id)
        rec = checkpoint.continuation_record(cdir)
        if rec is not None:
            # topology fence for gang parks: a SHARDED continuation only
            # resumes into a bucket of the same sub-mesh stamp — a fleet
            # that re-carved under the park degrades to a fresh
            # trajectory instead of reading shards at the wrong geometry
            want = int(getattr(req, "submesh", 0) or 0)
            got = int((rec.get("meta") or {}).get("submesh", 0) or 0)
            if got != want:
                self._journal(
                    {
                        "event": "continuation_restore_failed",
                        "id": req.id,
                        "error": (
                            f"sub-mesh stamp mismatch: parked at {got}, "
                            f"bucket wants {want}"
                        ),
                    }
                )
                return None
        # this process's shard against its slab of a donor member: a shard
        # cut for another layout (process count, rank count) does not fit
        # and raises, as the JAX reader does (written under a different
        # topology)
        like = ens.member_state(slot_index)
        try:
            slabs, _, _ = checkpoint.read_continuation(
                cdir, self._member_slabs(ens.model, like)
            )
            state = self._slabs_member(ens.model, slabs, like)
        except checkpoint.CheckpointError as exc:
            self._journal(
                {
                    "event": "continuation_restore_failed",
                    "id": req.id,
                    "error": str(exc),
                }
            )
            return None
        return state

    def _continuation_agreed(self, ok: bool) -> bool:
        """Every host restored its continuation shard, fleet-agreed: the
        allgather makes the degrade verdict identical everywhere (one
        host's torn shard must not leave it on a fresh trajectory while
        its peers resume mid-flight).  Identity single-process."""
        if self._nproc() == 1:
            return ok
        flags = multihost.allgather_host(
            np.asarray([1 if ok else 0], np.uint8)
        )
        return bool(np.asarray(flags).all())  # lint-ok: RPD005 allgather output is host numpy already

    def _retire_continuation(self, req) -> None:
        """Root-only cleanup once a request terminally resolved (or
        discarded its trajectory): the parked continuation no longer
        describes anything resumable."""
        if self._fleet is None or not self._is_root():
            return
        checkpoint.remove_continuation(
            checkpoint.continuation_dir(self.cfg.run_dir, req.id)
        )

    def _settle_predivergence(
        self, runner, ens, slots: list[_Slot], key: tuple
    ) -> None:
        """Per-bucket governed dt (``cfg.stability``): the sentinel chunk
        tripped the hard CFL ceiling and was already rolled back in memory
        — every member is still FINITE.  Root sizes the drop on the
        bucket's :class:`~rustpde_mpi_tpu_torch.utils.governor.DtLadder` (rung
        floats are exact, so every re-bucketed request lands in the SAME
        new bucket and co-batches there) and broadcasts the plan; the
        pinned requests are requeued WITH their state (parked, like an
        elastic shrink) at the new rung, journal-typed ``bucket_dt_adjust``.
        A ladder with no rung left falls back to the reactive per-request
        retry path — the proactive ladder sits ABOVE it, never replaces it."""
        status = ens.last_chunk_status
        stab = self.cfg.stability
        done = self._host_steps(ens)

        def decide():
            from ..utils.governor import DtLadder

            bucket_dt = float(ens.get_dt())
            pinned = [
                s
                for s in slots
                if s.running and status.pinned and status.pinned[s.index]
            ]
            new_dt = rung = None
            floor = stab.dt_min
            if floor is None or bucket_dt > floor * (1.0 + 1e-12):
                ladder = DtLadder(
                    bucket_dt,
                    ratio=stab.ladder_ratio,
                    dt_min=floor,
                    dt_max=bucket_dt,
                )
                down = ladder.rungs_to_target(status.cfl_max, stab.target_cfl)
                rung = ladder.clamp(-down)
                new_dt = ladder.dt(rung) if rung < 0 else None
            return {
                "new_dt": new_dt,
                "rung": rung,
                "cfl": float(status.cfl_max),
                "slots": [
                    {
                        "slot": s.index,
                        "steps": s.base + int(done[s.index]),
                        "time": s.time_base
                        + int(done[s.index]) * float(s.req.dt),
                    }
                    for s in pinned
                ],
            }

        plan = self._root_plan(decide)
        for entry in plan["slots"]:
            s = slots[entry["slot"]]
            if plan["new_dt"] is None:
                # ladder exhausted (dt_min floor): the reactive per-request
                # dt-backoff/terminal-failure policy takes over
                self._handle_death(runner, ens, s, int(entry["steps"]))
                continue
            req = s.req
            state = ens.member_state(s.index)  # finite: rolled-back chunk
            self._release(ens, s)
            self._park_member(req, ens, state, int(entry["steps"]), float(entry["time"]))
            if self._is_root():
                self.queue.requeue(
                    req.rebucketed(plan["new_dt"], progress=int(entry["steps"]))
                )
            self._dt_adjusts += 1
            _tm.counter(
                "serve_bucket_dt_adjusts_total",
                "proactive per-bucket dt re-buckets",
            ).inc()
            _tm.gauge(
                "serve_bucket_dt_rung",
                "ladder rung of the latest dt re-bucket (relative, <0)",
            ).set(plan["rung"])
            self._journal(
                {
                    "event": "bucket_dt_adjust",
                    "id": req.id,
                    "trace_id": req.trace_id,
                    "slot": entry["slot"],
                    "prev_dt": float(req.dt),
                    "dt": plan["new_dt"],
                    "rung": plan["rung"],
                    "cfl": plan["cfl"],
                    "steps_done": entry["steps"],
                }
            )
        ens.clear_pre_divergence()

    def _handle_death(self, runner, ens, slot: _Slot, steps_done: int) -> None:
        """Per-request divergence policy: bounded dt-backoff retry, then
        the typed terminal state.  The lane itself is immediately reusable
        — one member's NaN never perturbs its co-batched neighbours."""
        req = slot.req
        self._release(ens, slot)
        # a diverged trajectory is not worth resuming: whatever durable
        # continuation described it is poison for the retry (which
        # restarts from a fresh IC at a smaller dt) and noise after a
        # terminal failure — retire it either way
        self._retire_continuation(req)
        if req.retries < self.cfg.request_max_retries:
            retry = req.backed_off(self.cfg.request_dt_backoff)
            if self._is_root():
                self.queue.requeue(retry)
            self._retried += 1
            _tm.counter(
                "serve_requests_retried_total", "diverged requests re-queued backed off"
            ).inc()
            self._journal(
                {
                    "event": "request_retry",
                    "id": req.id,
                    "trace_id": req.trace_id,
                    "slot": slot.index,
                    "steps_done": steps_done,
                    "dt": retry.dt,
                    "retries": retry.retries,
                }
            )
        else:
            reason = (
                f"diverged at member-step {steps_done}/{req.steps} and "
                f"exhausted {self.cfg.request_max_retries} retries"
            )
            if self._is_root():
                self.queue.fail(req, reason)
            self._failed += 1
            _tm.counter(
                "serve_requests_failed_total", "requests in the typed terminal state"
            ).inc()
            self._journal(
                {
                    "event": "request_failed",
                    "id": req.id,
                    "trace_id": req.trace_id,
                    "slot": slot.index,
                    "reason": reason,
                    "dts": req.dts,
                }
            )

    def _flush_results(self, force: bool = False) -> None:
        """Resolve finished-request observable futures and write the done
        records.  Non-blocking by default (a future still in flight stays
        pending — the stream, not the device, waits); ``force`` resolves
        everything (campaign end / server stop).  Root-only: results and
        the queue belong to root."""
        if not self._is_root():
            return
        keep = []
        for fut, batch in self._pending_results:
            if not force and not fut.ready():
                keep.append((fut, batch))
                continue
            values = fut.result()
            for item in batch:
                req: SimRequest = item["req"]
                i = item["slot"]
                # result scalars carry the MODEL's observable vocabulary
                # (dns: nu/nuvol/re/div; lnse: energy/ke/te/div; adjoint:
                # res/res_u/res_t/div) — recorded under those names
                names = item["names"]
                result = {
                    name: float(vals[i]) for name, vals in zip(names, values)
                }
                result.update(
                    {
                        "model": str(req.model),
                        "steps": item["steps"],
                        "dt": float(req.dt),
                        # the QoS contract's accounting axes: per-class
                        # latency percentiles in the fleet bench read these
                        "tenant": str(req.tenant),
                        "priority": str(req.priority),
                        "deadline_s": (
                            float(req.deadline_s)
                            if req.deadline_s is not None
                            else None
                        ),
                        "seed": int(req.seed),
                        # IC amplitude rides the record so solo-equivalence
                        # checks rerun the exact trajectory
                        "amp": float(req.amp) if req.amp else None,
                        "retries": int(req.retries),
                        "slot": i,
                        "latency_s": round(
                            item["finished_wall"] - req.submitted_s, 6
                        ),
                    }
                )
                # the HA front-door gate metric: durable-queue enqueue to
                # the FIRST streamed observable for this request (the
                # result values just fetched are that first observable —
                # later than finished_wall, which only marks the device
                # reaching the step target)
                first_obs_s = max(
                    0.0, time.time() - (req.enqueued_s or req.submitted_s)
                )
                result["admission_to_first_observable_s"] = round(
                    first_obs_s, 6
                )
                # per-request physics-stats summary (cfg.stats): the
                # member's health vector at completion time — samples, Nu
                # estimators, budget residuals, spectral-tail fractions
                sfut = item.get("stats_fut")
                if sfut is not None:
                    svals = sfut.result()
                    result["stats"] = {
                        name: float(np.asarray(v).reshape(-1)[i])  # lint-ok: RPD005 future already converted to host numpy
                        for name, v in zip(item["stats_names"], svals)
                    }
                # end-state integrity digest (cfg.integrity): a content
                # fingerprint of the member's final spectral state — the
                # fleet proxy's cross-replica vote compares two replicas'
                # digests for the same request to catch SDC neither
                # replica's own audits saw
                dfut = item.get("dig_fut")
                if dfut is not None:
                    result["state_digest"] = int(
                        np.asarray(dfut.result()).reshape(-1)[i]  # lint-ok: RPD005 future already converted to host numpy
                    )
                self.queue.complete(req, result)
                self._completed += 1
                _tm.counter(
                    "serve_requests_completed_total", "requests resolved into done/"
                ).inc()
                _tm.histogram(
                    "serve_request_latency_seconds",
                    "submit-to-finish latency per completed request",
                ).observe(result["latency_s"])
                _tm.histogram(
                    "serve_admission_to_first_observable_seconds",
                    "durable enqueue to first streamed observable",
                ).observe(first_obs_s)
                # the per-class view of the same clock: the QoS contract's
                # gate metric (interactive p99 under mixed traffic)
                _tm.histogram(
                    "serve_class_latency_seconds",
                    "enqueue to first observable per QoS priority class",
                    **{"class": str(req.priority)},
                ).observe(first_obs_s)
                self._retire_continuation(req)
                self._journal(
                    {
                        "event": "request_done",
                        "id": req.id,
                        "trace_id": req.trace_id,
                        "slot": i,
                        "steps": item["steps"],
                        names[0]: result[names[0]],
                        "latency_s": result["latency_s"],
                        "first_observable_s": result[
                            "admission_to_first_observable_s"
                        ],
                        "step": item["step"],
                    }
                )
        self._pending_results = keep

    def _drain_campaign(self, runner, ens, slots: list[_Slot], key: tuple = ()) -> None:
        """The graceful-drain path: flush resolved results, checkpoint the
        slot table + member states through the sharded two-phase writer
        (collective — every host is here together, the drain verdict was
        root-broadcast), then re-enqueue every unfinished request on root
        (progress stamped for the record; the checkpoint is what actually
        restores it).

        Under an ARMED preemption notice (``cfg.preempt_notice_s``,
        fleet mode) the drain turns urgent — park everything, release
        leases, exit: running slots persist as durable per-request
        continuations (O(slots) small two-phase writes, the exact state
        a lease-breaking survivor resumes from) instead of the sharded
        campaign checkpoint the notice window may not afford, and the
        trace/incident flushes are skipped when the remaining clock is
        short.  Both verdicts ride one root plan so every host takes the
        same branch; if the window still runs out, the SIGKILL that
        follows is the already-loss-free path."""

        def _plan():
            if self._notice_deadline is None:
                return [0, 1]
            remaining = self._notice_deadline - time.monotonic()
            return [1, 1 if remaining > 1.0 else 0]

        urgent, full_io = (
            (bool(v) for v in self._root_plan(_plan))
            if self._fleet is not None
            else (False, True)
        )
        self._log_preempt_notice()
        self._flush_results(force=True)
        _tr.instant("drain", step=runner.step)
        running = [s for s in slots if s.running]
        done = self._host_steps(ens)
        path = None
        if running and not urgent:
            path = runner.checkpoint_now("drain")
        if running and urgent:
            for s in running:
                state = ens.member_state(s.index)
                self._write_continuation(
                    s.req,
                    ens,
                    state,
                    s.base + int(done[s.index]),
                    s.time_base + int(done[s.index]) * float(s.req.dt),
                )
            if self._gang_active is not None:
                # the gang's SHARDED state just went through the same
                # two-phase continuation writer (one shard per member):
                # the whole gang parks as a unit inside the notice window
                self._journal(
                    {
                        "event": "gang_parked",
                        "key": list(key),
                        "gang": self._gang_active.get("gang"),
                        "generation": self._gang_active.get("generation"),
                        "slots": len(running),
                    }
                )
        for s in running:
            req = dataclasses.replace(
                s.req, progress=s.base + int(done[s.index])
            )
            if self._is_root():
                self.queue.requeue(req)
            self._journal(
                {
                    "event": "request_requeued",
                    "id": req.id,
                    "trace_id": req.trace_id,
                    "slot": s.index,
                    "progress": req.progress,
                    "target": s.target,
                    "checkpoint": path,
                    **({"parked": True} if urgent else {}),
                }
            )
        runner._drain_io()
        if full_io:
            # the drained campaign's request-trace events must land durably
            # NOW (this incarnation is about to exit — the gather is
            # collective and every host reaches this drain path together)
            self._flush_reqtrace(runner, key)
            # the SIGTERM-drain incident ships with its timeline, like the
            # standalone runner's preempt path
            runner.incident_dump("drain")

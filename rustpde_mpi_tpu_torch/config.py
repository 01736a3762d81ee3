"""Device and dtype policy of the PyTorch port.

The JAX package reads its precision from the environment (``X64``); here the
dtype and the device are explicit constructor arguments instead.  The
defaults are float64 (the reference default) on the CUDA card.  A caller
who wants the CPU says so with ``device="cpu"``: an entry point never falls
back to the CPU on its own.

Importing this module turns TF32 off for matrix products and convolutions,
the counterpart of the reference pinning HIGHEST matmul precision.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the reference default precision
DEFAULT_DTYPE = torch.float64

#: dtypes the port (and its kernels) support
SUPPORTED_DTYPES = (torch.float64, torch.float32)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and no
    card is visible.  A CUDA device without an index gets the current one,
    so it compares equal to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(mat, device, dtype) -> torch.Tensor:
    """A contiguous copy of the host array ``mat`` in ``dtype`` on ``device``
    (the form every operator constant of the port takes)."""
    return torch.as_tensor(np.ascontiguousarray(mat), dtype=dtype).to(device)


def check_dtype(dtype) -> torch.dtype:
    """Validate a real working dtype (float64 or float32)."""
    if dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"unsupported dtype {dtype}; use torch.float64 or torch.float32")
    return dtype


@dataclass
class StabilityConfig:
    """Knobs of the on-device stability sentinels that a model's
    ``set_stability`` arms (the JAX package's ``StabilityConfig``, same
    fields and defaults).  The port's chunk reads ``max_cfl``, the hard
    ceiling: a chunk whose per-step CFL exceeds it freezes while the state
    is still finite, is rolled back, and reports ``pre_divergence``.  The
    other fields are the dt governor's
    (:class:`..utils.governor.StabilityGovernor`):

    * ``target_cfl``: the Courant number the dt controller drives toward;
    * ``ladder_ratio``: geometric spacing of the dt ladder;
    * ``dt_min``/``dt_max``: ladder bounds (None: ``dt_max`` is the run's
      initial dt, ``dt_min`` ``dt_max * ladder_ratio**-10``);
    * ``grow_after``: healthy chunks at a rung before climbing back up;
    * ``shrink_cfl``: proactive shrink threshold (None: ``0.85 * max_cfl``);
    * ``member_pin_patience``: pre-divergence catches pinned on one
      ensemble member before it is declared dead."""

    target_cfl: float = 0.5
    max_cfl: float = 1.0
    ladder_ratio: float = 2.0
    dt_min: float | None = None
    dt_max: float | None = None
    grow_after: int = 4
    shrink_cfl: float | None = None
    member_pin_patience: int = 3


@dataclass
class StatsConfig:
    """Knobs of the in-scan statistics engine that a model's ``set_stats``
    arms (:class:`..models.stats.StatsEngine`; the JAX package's
    ``StatsConfig``, whose None defaults read ``RUSTPDE_STATS_*`` from the
    environment; the port reads no environment, so the defaults are
    plain values):

    * ``stride``: steps between samples (the sample costs a handful of
      extra syntheses, so its share of a step falls as 1/stride);
    * ``tail_warn``: the spectral-tail energy fraction (top third of the
      stored modes, per field and axis) that reads as under-resolution;
    * ``budget_warn``: the Nu budget-closure residual (plate-flux Nu
      against ``1 + <uy T> 2 sy / ka``) that reads as drift.

    A model's ``stats_warnings()`` holds its health readout against the
    two limits and reports the ``resolution_warning``/``budget_drift``
    events that cross them, as the JAX package's resilient runner
    journals them.

    The engine reads the state and never feeds back: the trajectory is bit
    for bit the same with statistics on and off."""

    stride: int = 16
    tail_warn: float = 1e-3
    budget_warn: float = 0.5


@dataclass
class IntegrityConfig:
    """The integrity layer's knobs (the JAX package's ``IntegrityConfig``,
    same fields and defaults), armed by a model's ``set_integrity``: an
    on-device state digest (:func:`..integrity.digest_tree`) streamed with
    the observables futures, and shadow audits that replay a chunk from its
    retained start and compare digests.

    * ``cadence``: committed chunks between audits (None: 8; 0 streams
      digests and never audits);
    * ``strikes``: audit mismatches charged to one device before the
      quarantine ledger quarantines it;
    * ``strike_ttl_s``: how long a strike counts.

    The digest reads the state and never feeds back: a trajectory is bit
    for bit the same with the layer armed and disarmed."""

    cadence: int | None = None
    strikes: int = 2
    strike_ttl_s: float = 3600.0

    def resolved_cadence(self) -> int:
        """The audit cadence, 8 when unset."""
        return 8 if self.cadence is None else int(self.cadence)


@dataclass
class IOConfig:
    """The overlapped IO pipeline's knobs (the JAX package's ``IOConfig``,
    same fields and defaults; :mod:`..utils.io_pipeline`).

    * ``async_checkpoints``: a checkpoint is staged to the host on the
      calling thread and written on a background worker;
    * ``overlap_dispatch``: ``integrate``'s break check and the
      callback's observables ride futures, one chunk late
      (``integrate(overlap=True)``);
    * ``sharded_checkpoints``: the checkpoint format: None picks the
      sharded two-phase one on more than one process and the gathered one
      otherwise, True or False force either;
    * ``queue_depth``: background writes in flight before a submit blocks;
    * ``diag_lag``: boundaries a diagnostics line may trail the device
      (0 prints synchronously);
    * ``timeout_s``: how long a submit or a drain may wait on the writer
      before it raises (None waits for ever)."""

    async_checkpoints: bool = True
    overlap_dispatch: bool = True
    sharded_checkpoints: bool | None = None
    queue_depth: int = 1
    diag_lag: int = 1
    timeout_s: float | None = None

    @classmethod
    def blocking(cls) -> "IOConfig":
        """Fully synchronous IO."""
        return cls(async_checkpoints=False, overlap_dispatch=False, diag_lag=0)

    def pipeline(self):
        """The :class:`..utils.io_pipeline.IOPipeline` these knobs describe."""
        from .utils.io_pipeline import IOPipeline

        return IOPipeline(queue_depth=self.queue_depth, diag_lag=self.diag_lag,
                          timeout_s=self.timeout_s)


@dataclass
class SubmeshConfig:
    """Two-level serving's sub-mesh carve (the JAX package's
    ``SubmeshConfig``, same fields and defaults; :mod:`.parallel.submesh`).

    * ``shapes``: sub-mesh sizes (device counts) to carve; a shape the
      fleet cannot hold is dropped from the carve, and on more than one
      process a shape must be a multiple of the process count;
    * ``shard_min_nx``: grids at or above this extent are sharded traffic,
      stamped at admission with the smallest fitting configured shape;
    * ``max_pending``: the admission bound on queued sharded requests a
      stamped shape."""

    shapes: tuple = (2,)
    shard_min_nx: int = 257
    max_pending: int = 32


@dataclass
class ResilienceConfig:
    """The resilient runner's knobs (the JAX package's ``ResilienceConfig``,
    same fields and defaults; field names match the keyword arguments of
    :class:`..utils.resilience.ResilientRunner`, built from it by
    ``ResilientRunner.from_config(pde, cfg.resilience, max_time)``).

    * ``checkpoint_every_s``/``checkpoint_every_t``: the wall-clock and
      sim-time checkpoint cadences (either may be None);
    * ``keep``: the rolling retention window;
    * ``max_retries``, ``dt_backoff``, ``dt_min``: divergence retries, the
      step shrink of each, and its floor;
    * ``respawn_members``/``respawn_amp``/``respawn_seed``: an ensemble's
      dead members respawned from perturbed healthy donors at a rollback;
    * ``dispatch_timeout_s``: the dispatch watchdog's deadline (None: off;
      the port reads no environment default);
    * ``stability``: the proactive dt governor (a :class:`StabilityConfig`);
    * ``io``: the overlapped IO knobs (None: ``IOConfig()``)."""

    run_dir: str = "data/resilient"
    checkpoint_every_s: float | None = 300.0
    checkpoint_every_t: float | None = None
    keep: int = 3
    max_retries: int = 3
    dt_backoff: float = 0.5
    dt_min: float = 0.0
    respawn_members: bool = False
    respawn_amp: float = 1e-3
    respawn_seed: int | None = None
    dispatch_timeout_s: float | None = None
    resume: bool = True
    stability: StabilityConfig | None = None
    io: IOConfig | None = None


@dataclass
class FleetConfig:
    """The fleet layer's knobs (the JAX package's ``FleetConfig``, same
    fields and defaults; :mod:`.serve.fleet`): N stateless proxies and M
    ``SimServer`` replicas over one shared durable queue, coordinated by
    queue-level lease files.  The JAX package's environment fallbacks are
    the fields' own defaults here.

    * ``replica_id``: stable identity for lease and heartbeat files
      (empty: ``<hostname>-<pid>``);
    * ``lease_ttl_s``: a lease whose heartbeat has not advanced for this
      long (observer-monotonic) is stale: survivors break it and re-claim
      its requests (None: 15 s);
    * ``heartbeat_s``: the lease and replica-status heartbeat cadence
      (None: ``lease_ttl_s / 3``);
    * ``default_quota``: the per-tenant admission bound over queued and
      running requests (None: unlimited); ``quotas`` per-tenant overrides;
    * ``preempt``/``preempt_slack_s``: an at-risk deadline request (slack
      under ``preempt_slack_s``) parks a running best-effort lane;
    * ``durable_park``: parked member states persist into ``parked/<id>/``
      continuation directories, so requeue-with-state survives a SIGKILL."""

    replica_id: str = ""
    lease_ttl_s: float | None = None
    heartbeat_s: float | None = None
    default_quota: int | None = None
    quotas: dict = field(default_factory=dict)
    preempt: bool = True
    preempt_slack_s: float = 30.0
    durable_park: bool = True

    def resolved_replica_id(self) -> str:
        if self.replica_id:
            return str(self.replica_id)
        import os
        import socket

        return f"{socket.gethostname()}-{os.getpid()}"

    def resolved_ttl(self) -> float:
        return 15.0 if self.lease_ttl_s is None else float(self.lease_ttl_s)

    def resolved_heartbeat(self) -> float:
        if self.heartbeat_s is not None:
            return float(self.heartbeat_s)
        return self.resolved_ttl() / 3.0

    def resolved_quota(self, tenant: str) -> int | None:
        if tenant in self.quotas:
            q = self.quotas[tenant]
            return None if q is None else int(q)
        return None if self.default_quota is None else int(self.default_quota)


@dataclass
class AutoscaleConfig:
    """The fleet autoscaler's control law (the JAX package's
    ``AutoscaleConfig``, same fields and defaults;
    :mod:`.serve.fleet.autoscaler`).

    Scale out one replica a decision (up to ``max_replicas``) on deadline
    pressure (a queued deadline's slack under ``slack_low_s``, at once), on
    queue pressure (queued depth over ``queue_high`` for ``sustain_s``) or
    to repair capacity (live replicas under ``min_replicas``, at once and
    exempt from the cooldown).  Scale in one replica (down to
    ``min_replicas``) after the fleet was fully idle for
    ``idle_sustain_s``, by SIGTERM through the replica's own drain.
    ``cooldown_s`` spaces elective actions, ``decide_s`` is the
    evaluation cadence, and a spawned replica counts for ``spawn_grace_s``
    before its first heartbeat.  ``notice_s`` is handed to launched
    replicas as their preemption-notice window (``--preempt-notice-s``;
    None: none).  ``gang_size`` moves capacity in fate-shared gangs of
    that many replicas."""

    min_replicas: int = 1
    max_replicas: int = 4
    queue_high: int = 8
    sustain_s: float = 5.0
    idle_sustain_s: float = 15.0
    slack_low_s: float = 30.0
    cooldown_s: float = 30.0
    decide_s: float = 2.0
    spawn_grace_s: float = 60.0
    notice_s: float | None = None
    replica_prefix: str = "auto"
    gang_size: int = 1


@dataclass
class CanonicalConfig:
    """Admission canonicalization (the JAX package's ``CanonicalConfig``,
    same fields and defaults; ``SimServer.submit``): a request's ``dt``
    snaps to the nearest rung of a service-wide geometric ladder anchored
    at ``dt_anchor`` (ratio ``ladder_ratio``, bounds ``dt_min``/``dt_max``)
    when the relative shift stays within ``max_rel_dt_shift``, and the
    campaign slot count rounds up to the next of ``slot_sizes``, so that
    warm-pool campaigns cover live traffic.  The horizon, the physics,
    seeds, priorities and deadlines never change; ``rtol`` is the stated
    tolerance between a canonicalized run and the exact-dt one."""

    dt_anchor: float = 2e-3
    ladder_ratio: float = 2.0
    dt_min: float = 1e-6
    dt_max: float = 1e-1
    max_rel_dt_shift: float = 0.5
    slot_sizes: tuple = ()
    rtol: float = 5e-2


@dataclass
class ServeConfig:
    """The simulation service's knobs (the JAX package's ``ServeConfig``,
    same fields and defaults, plus the three of its environment knobs that
    the port takes as fields; :class:`.serve.SimServer`).

    * ``run_dir``: the service root (``queue/``, ``campaigns/<tag>``,
      ``journal.jsonl``);
    * ``slots``: ensemble members a campaign (K); a finished, failed or
      idle lane is refilled from the queue at a chunk boundary;
    * ``max_queue``: the admission bound; ``chunk_steps``: the most steps a
      dispatch between schedule points; ``bucket_quantum``: the most claims
      one campaign visit makes while other buckets wait (0: unlimited);
    * ``checkpoint_every_s``: the slot-table checkpoint cadence (None:
      drain and edge checkpoints only; always sharded two-phase);
    * ``request_max_retries``/``request_dt_backoff``: a diverged request
      is requeued at ``dt * backoff`` up to the budget, then fails typed;
    * ``default_amp``, ``idle_exit``, ``poll_s``, ``http_host``/
      ``http_port`` (None: no HTTP front; 0: an ephemeral port);
    * ``resilience``, ``stats``, ``stability``, ``fleet``, ``autoscale``,
      ``submesh``, ``warm_profile``, ``canonicalize``, ``integrity``: the
      optional layers, each off at None;
    * ``preempt_notice_s``: a fleet replica's preemption-notice window (a
      SIGTERM then parks running slots as continuations; 0: off);
    * ``profile_max_s``: the cap on one ``POST /profile`` capture;
    * ``gang_sync_timeout_s``: the gang barrier's deadline (0: the
      ordinary sync)."""

    run_dir: str = "data/serve"
    slots: int = 8
    max_queue: int = 256
    chunk_steps: int = 256
    bucket_quantum: int = 32
    checkpoint_every_s: float | None = 60.0
    request_max_retries: int = 2
    request_dt_backoff: float = 0.5
    default_amp: float = 0.1
    idle_exit: bool = True
    poll_s: float = 0.2
    http_host: str = "127.0.0.1"
    http_port: int | None = None
    resilience: ResilienceConfig | None = None
    stats: StatsConfig | None = None
    stability: StabilityConfig | None = None
    fleet: FleetConfig | None = None
    autoscale: AutoscaleConfig | None = None
    submesh: SubmeshConfig | None = None
    warm_profile: object | None = None
    canonicalize: CanonicalConfig | None = None
    integrity: IntegrityConfig | None = None
    preempt_notice_s: float = 0.0
    profile_max_s: float = 60.0
    gang_sync_timeout_s: float = 0.0


@dataclass
class NavierConfig:
    """The Navier models' configuration in one object (the JAX package's
    ``NavierConfig``, same fields and defaults), for
    ``Navier2D.from_config`` / ``NavierEnsemble.from_config``.

    ``integrity`` (an :class:`IntegrityConfig`) arms ``set_integrity``.
    ``resilience`` (a :class:`ResilienceConfig`) holds the resilient
    runner's knobs, which ``ResilientRunner.from_config`` reads; the model
    itself ignores it."""

    nx: int = 129
    ny: int = 129
    ra: float = 1e7
    pr: float = 1.0
    dt: float = 2e-3
    aspect: float = 1.0
    bc: str = "rbc"  # "rbc" | "hc"
    periodic: bool = False
    write_intervall: float | None = None
    init_random_amp: float | None = 0.1
    params: dict = field(default_factory=dict)  # extra parameters written to snapshots
    #: member count for ``NavierEnsemble.from_config`` (seeds ``0..ensemble-1``)
    ensemble: int = 1
    resilience: ResilienceConfig | None = None
    #: the stability sentinels (None: plain stepping); ``from_config`` arms them
    stability: StabilityConfig | None = None
    #: the statistics engine (None: off); ``from_config`` arms it
    stats: StatsConfig | None = None
    #: scenario step modifiers (a ``ScenarioConfig`` or a dict with its keys)
    scenario: object | None = None
    #: the integrity layer (None: off); ``from_config`` arms it
    integrity: IntegrityConfig | None = None

    def __post_init__(self):
        if self.resilience is not None and not isinstance(self.resilience, ResilienceConfig):
            raise TypeError(f"NavierConfig.resilience must be a ResilienceConfig or None, "
                            f"got {type(self.resilience).__name__}")
        if self.integrity is not None and not isinstance(self.integrity, IntegrityConfig):
            raise TypeError(f"NavierConfig.integrity must be an IntegrityConfig or None, "
                            f"got {type(self.integrity).__name__}")

    def ctor_args(self) -> tuple:
        return (self.nx, self.ny, self.ra, self.pr, self.dt, self.aspect, self.bc)

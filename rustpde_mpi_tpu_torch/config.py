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

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
class NavierConfig:
    """The Navier models' configuration in one object (the JAX package's
    ``NavierConfig``, same fields and defaults), for
    ``Navier2D.from_config`` / ``NavierEnsemble.from_config``.

    ``resilience`` and ``integrity`` are the JAX package's resilient-runner
    and integrity-layer knobs, which the port does not have yet (ROADMAP
    Queue 1 item 15): they must stay None, and any other value raises
    ``NotImplementedError``."""

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
    resilience: object | None = None
    #: the stability sentinels (None: plain stepping); ``from_config`` arms them
    stability: StabilityConfig | None = None
    #: the statistics engine (None: off); ``from_config`` arms it
    stats: StatsConfig | None = None
    #: scenario step modifiers (a ``ScenarioConfig`` or a dict with its keys)
    scenario: object | None = None
    integrity: object | None = None

    def __post_init__(self):
        for name in ("resilience", "integrity"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"NavierConfig.{name} is not ported yet (ROADMAP Queue 1 item 15); "
                    "leave it None")

    def ctor_args(self) -> tuple:
        return (self.nx, self.ny, self.ra, self.pr, self.dt, self.aspect, self.bc)

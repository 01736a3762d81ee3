"""The proactive stability governor: CFL-targeting dt control on a rung
ladder (counterpart of the JAX package's ``utils/governor.py``; plain
host code, the same classes and control law).

* :class:`ChunkStatus`: what the on-device sentinels saw in one chunk
  (``update_n`` with ``set_stability`` armed returns it);
* :class:`DtLadder`: geometric dt rungs ``dt_anchor * ratio**rung``, each
  rung's dt computed once, so every visit to a rung yields the identical
  float the models' per-rung caches (``set_dt``) key on;
* :class:`StabilityGovernor`: fed every chunk's status, it shrinks dt when
  the chunk CFL crosses ``shrink_cfl``, drops hard (the chunk was rolled
  back) on a ``pre_divergence`` catch, and after ``grow_after`` healthy
  chunks climbs one rung when the predicted CFL stays at or under
  ``target_cfl``; it returns a :class:`GovernorDecision`, which the caller
  applies (``set_dt``, ``clear_pre_divergence``, ``mark_dead``);
* :class:`RunHealth`: the run's dt trajectory, sentinel extrema, catches
  and adjustments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple


class ChunkStatus(NamedTuple):
    """What the stability sentinels saw in one ``update_n`` chunk.

    ``cfl_max``/``ke``/``ke_growth_max``/``div_max`` are chunk reductions
    of the per-step sentinels.  ``pre_divergence`` means the hard CFL
    ceiling tripped while the state was still finite: the chunk was rolled
    back (state and time untouched) and the model's ``exit()`` latches True
    until ``clear_pre_divergence()``."""

    requested: int  # steps asked of update_n
    steps_done: int  # steps executed before the chunk froze
    finite: bool  # state finite at chunk end
    cfl_ok: bool  # no CFL-ceiling trip
    pre_divergence: bool  # ceiling tripped while finite -> chunk rolled back
    cfl_max: float  # max per-step CFL seen this chunk
    ke: float  # volume-averaged kinetic energy of the last stepped state
    ke_growth_max: float  # max per-step KE growth factor
    div_max: float  # max pre-projection |div| residual seen this chunk
    dt: float  # the dt the chunk ran at
    cfl_members: tuple | None = None  # per-member chunk-max CFL (ensembles)
    pinned: tuple | None = None  # per-member ceiling-trip mask (ensembles)


class GovernorDecision(NamedTuple):
    """What the governor wants done about one chunk.

    ``action``: ``"ok"`` (commit, no change) | ``"adjust"`` (commit, then
    ``set_dt(dt)``) | ``"retry"`` (chunk was rolled back: ``set_dt(dt)``,
    clear the latch, redo the chunk) | ``"kill_members"`` (roll-back case
    where the same ensemble members keep pinning the ceiling: mark
    ``members`` dead, clear the latch, redo the chunk) | ``"give_up"``
    (ladder exhausted: leave the latch set so the reactive
    checkpoint-rollback path takes over)."""

    action: str
    dt: float | None = None
    members: tuple = ()
    reason: str = ""


@dataclasses.dataclass
class RunHealth:
    """End-of-run physics health summary (journaled as ``run_health``)."""

    chunks: int = 0
    steps: int = 0
    cfl_max: float = 0.0
    ke_growth_max: float = 0.0
    div_max: float = 0.0
    pre_divergence_catches: int = 0
    rollbacks_avoided: int = 0  # catches recovered in-memory (no checkpoint)
    dt_adjusts: int = 0
    members_killed: int = 0
    dt_min_seen: float | None = None
    dt_max_seen: float | None = None
    # (step, dt) at every change, starting with the anchor
    dt_trajectory: list = dataclasses.field(default_factory=list)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


class DtLadder:
    """Geometric dt rungs ``dt_anchor * ratio**rung``, rung 0 = the anchor.

    Rungs run from ``bottom`` (<= 0, the ``dt_min`` side) to ``top`` (>= 0,
    the ``dt_max`` side); the anchor — the dt the run was configured with —
    is always rung 0 exactly, so an already-stable run never has its dt
    perturbed by quantization.  Rung dt values are computed once and reused,
    so every visit to a rung yields the *identical float* — the contract the
    per-rung solver/jit cache keys on."""

    def __init__(
        self,
        dt_anchor: float,
        ratio: float = 2.0,
        dt_min: float | None = None,
        dt_max: float | None = None,
    ):
        if not dt_anchor > 0.0:
            raise ValueError(f"dt_anchor must be positive, got {dt_anchor}")
        if not ratio > 1.0:
            raise ValueError(f"ladder ratio must exceed 1, got {ratio}")
        self.anchor = float(dt_anchor)
        self.ratio = float(ratio)
        if dt_max is None:
            dt_max = self.anchor
        if dt_min is None:
            dt_min = dt_max * self.ratio**-10
        if not 0.0 < dt_min <= self.anchor <= dt_max:
            raise ValueError(
                f"need 0 < dt_min <= dt_anchor <= dt_max, got "
                f"dt_min={dt_min}, dt_anchor={dt_anchor}, dt_max={dt_max}"
            )
        # rung counts from exact log ratios, tolerant of float representation
        self.top = int(math.floor(math.log(dt_max / self.anchor) / math.log(self.ratio) + 1e-9))
        self.bottom = -int(math.floor(math.log(self.anchor / dt_min) / math.log(self.ratio) + 1e-9))
        self._dts = {r: self.anchor * self.ratio**r for r in range(self.bottom, self.top + 1)}

    def __len__(self) -> int:
        return self.top - self.bottom + 1

    def dt(self, rung: int) -> float:
        return self._dts[self.clamp(rung)]

    def clamp(self, rung: int) -> int:
        return max(self.bottom, min(self.top, int(rung)))

    def rung_for(self, dt: float) -> int:
        """Nearest rung (in log space) to an arbitrary dt, clamped."""
        if not dt > 0.0:
            raise ValueError(f"dt must be positive, got {dt}")
        return self.clamp(round(math.log(dt / self.anchor) / math.log(self.ratio)))

    def rung_floor_for(self, dt: float) -> int:
        """Largest rung whose dt is <= the given dt (log-space floor, with a
        tolerance so an exactly-on-ladder dt maps to its own rung), clamped.
        Aligning a reactively backed-off dt must round DOWN: nearest-rung
        rounding would restore the very dt that just diverged whenever the
        backoff factor is milder than sqrt(ratio)."""
        if not dt > 0.0:
            raise ValueError(f"dt must be positive, got {dt}")
        return self.clamp(
            math.floor(math.log(dt / self.anchor) / math.log(self.ratio) + 1e-9)
        )

    def rungs_to_target(self, cfl: float, target: float) -> int:
        """How many rungs DOWN bring an observed CFL to <= target (>= 1)."""
        if not (cfl > target) or not math.isfinite(cfl):
            return 1 if math.isfinite(cfl) else len(self)
        return max(1, int(math.ceil(math.log(cfl / target) / math.log(self.ratio) - 1e-9)))


class StabilityGovernor:
    """Drive dt toward ``target_cfl`` on the rung ladder, with hysteresis.

    One instance per run; feed every chunk's :class:`ChunkStatus` through
    :meth:`on_chunk` and apply the returned :class:`GovernorDecision`.  The
    governor assumes the model's dt currently equals ``ladder.dt(rung)`` —
    the caller must apply every ``retry``/``adjust`` dt before the next
    chunk."""

    def __init__(self, cfg, dt_anchor: float):
        self.cfg = cfg
        self.ladder = DtLadder(
            dt_anchor,
            ratio=cfg.ladder_ratio,
            dt_min=cfg.dt_min,
            dt_max=cfg.dt_max,
        )
        self.shrink_cfl = (
            cfg.shrink_cfl if cfg.shrink_cfl is not None else 0.85 * cfg.max_cfl
        )
        self.rung = self.ladder.rung_for(dt_anchor)
        self.healthy = 0  # consecutive committed chunks at the current rung
        self._member_pins: dict[int, int] = {}  # member -> consecutive pins
        self.health = RunHealth()
        self.health.dt_trajectory.append((0, self.ladder.dt(self.rung)))
        self.health.dt_min_seen = self.health.dt_max_seen = self.ladder.dt(self.rung)

    # -- bookkeeping ---------------------------------------------------------

    def align(self, dt: float, step: int = 0) -> float | None:
        """Re-anchor the governor on an externally-set dt (a resume restored
        a reactive backoff, or a reactive rollback just shrank dt off the
        ladder): snap to the largest rung NOT ABOVE it — rounding to nearest
        would hand back the very dt that just diverged — and record the
        change in the health trajectory.  Returns the rung dt when the
        caller must ``set_dt`` it (off-ladder input), else None."""
        self.rung = self.ladder.rung_floor_for(dt)
        self.healthy = 0
        ladder_dt = self.ladder.dt(self.rung)
        last_dt = self.health.dt_trajectory[-1][1]
        if ladder_dt != last_dt:
            # an on-ladder external change (0.5 backoff on a ratio-2 ladder)
            # still belongs in the trajectory/extrema bookkeeping
            self._note_dt(step, ladder_dt)
        elif len(self.health.dt_trajectory) == 1 and self.health.dt_adjusts == 0:
            # initial call only: stamp the true starting step, no adjustment
            self.health.dt_trajectory[-1] = (int(step), ladder_dt)
        return ladder_dt if ladder_dt != float(dt) else None

    def _note_dt(self, step: int, dt: float) -> None:
        self.health.dt_adjusts += 1
        self.health.dt_trajectory.append((int(step), float(dt)))
        self.health.dt_min_seen = min(self.health.dt_min_seen, dt)
        self.health.dt_max_seen = max(self.health.dt_max_seen, dt)

    def _record(self, status: ChunkStatus) -> None:
        self.health.chunks += 1
        for field, value in (
            ("cfl_max", status.cfl_max),
            ("ke_growth_max", status.ke_growth_max),
            ("div_max", status.div_max),
        ):
            if math.isfinite(value):
                setattr(self.health, field, max(getattr(self.health, field), value))

    # -- the control law -----------------------------------------------------

    def on_chunk(self, status: ChunkStatus, step: int = 0) -> GovernorDecision:
        """Decide what to do about one chunk's sentinel record.

        **lag=1 contract** (an overlapped integration loop): the status
        may describe a chunk that was already in flight when the previous
        decision's dt landed, so its CFL was observed at its OWN
        ``status.dt``, not the current rung's.  CFL is linear in dt — the
        thresholds below act on the observation rescaled to the current
        rung dt, otherwise a just-shrunk dt would be shrunk twice for the
        same cause (and a stale larger-dt chunk would block regrowth).  At
        lag 0 (``status.dt`` equals the rung dt — every synchronous run)
        the rescale is exactly 1 and the control law is unchanged."""
        cfg, ladder = self.cfg, self.ladder
        self._record(status)
        cfl_now = status.cfl_max
        cur_dt = ladder.dt(self.rung)
        if status.dt > 0.0 and status.dt != cur_dt and math.isfinite(cfl_now):
            cfl_now = cfl_now * (cur_dt / status.dt)

        if not status.finite:
            # genuine NaN divergence: not the governor's event — the reactive
            # checkpoint-rollback machinery owns it
            self.healthy = 0
            return GovernorDecision("ok", reason="nan_divergence")

        if status.pre_divergence:
            self.health.pre_divergence_catches += 1
            self.healthy = 0
            persistent = self._update_member_pins(status)
            if persistent and status.pinned is not None and not all(status.pinned):
                # the same members keep pinning the ceiling while the rest of
                # the batch is fine: dt drops haven't helped them, so feed
                # them to the respawn machinery instead of stalling the batch
                self._member_pins = {
                    m: c for m, c in self._member_pins.items() if m not in persistent
                }
                self.health.members_killed += len(persistent)
                self.health.rollbacks_avoided += 1
                return GovernorDecision(
                    "kill_members",
                    members=tuple(persistent),
                    reason=f"members {persistent} pinned the CFL ceiling "
                    f"{cfg.member_pin_patience}x despite dt drops",
                )
            if self.rung > ladder.bottom:
                down = ladder.rungs_to_target(cfl_now, cfg.target_cfl)
                self.rung = ladder.clamp(self.rung - down)
                new_dt = ladder.dt(self.rung)
                self._note_dt(step, new_dt)
                self.health.rollbacks_avoided += 1
                return GovernorDecision(
                    "retry",
                    dt=new_dt,
                    reason=f"cfl {status.cfl_max:.3g} > ceiling {cfg.max_cfl:g}",
                )
            # bottom rung still trips: nothing left on the ladder
            return GovernorDecision(
                "give_up",
                reason=f"CFL ceiling tripped at the bottom rung "
                f"(dt={ladder.dt(self.rung):g}, cfl {status.cfl_max:.3g})",
            )

        # committed chunk
        self.health.steps += status.steps_done
        self._member_pins.clear()
        cfl = cfl_now
        if math.isfinite(cfl) and cfl > self.shrink_cfl and self.rung > ladder.bottom:
            down = ladder.rungs_to_target(cfl, cfg.target_cfl)
            self.rung = ladder.clamp(self.rung - down)
            new_dt = ladder.dt(self.rung)
            self._note_dt(step, new_dt)
            self.healthy = 0
            return GovernorDecision(
                "adjust",
                dt=new_dt,
                reason=f"cfl {cfl:.3g} > shrink threshold {self.shrink_cfl:g}",
            )
        self.healthy += 1
        if (
            self.rung < ladder.top
            and self.healthy >= cfg.grow_after
            and math.isfinite(cfl)
            and cfl * ladder.ratio <= cfg.target_cfl
        ):
            self.rung += 1
            new_dt = ladder.dt(self.rung)
            self._note_dt(step, new_dt)
            self.healthy = 0
            return GovernorDecision(
                "adjust",
                dt=new_dt,
                reason=f"healthy {cfg.grow_after} chunks, predicted cfl "
                f"{cfl * ladder.ratio:.3g} <= target {cfg.target_cfl:g}",
            )
        return GovernorDecision("ok")

    def _update_member_pins(self, status: ChunkStatus) -> list[int]:
        """Track consecutive per-member ceiling pins; returns the members at
        or past ``member_pin_patience`` (candidates for respawn)."""
        if status.pinned is None:
            return []
        pins = {}
        for i, pinned in enumerate(status.pinned):
            if pinned:
                pins[i] = self._member_pins.get(i, 0) + 1
        self._member_pins = pins
        return sorted(i for i, c in pins.items() if c >= self.cfg.member_pin_patience)

"""SLO-holding fleet autoscaler: the controller that lets the fleet run
on preemptible capacity.

Replica death is loss-free (queue leases + fencing tokens,
durable parked continuations); this controller exploits it.  It consumes
ONLY signals the fleet already exports — queue depth and the queued
snapshot from :class:`~rustpde_mpi_tpu_torch.serve.queue.DurableQueue`,
deadline slack from the QoS request contract, replica heartbeats via
:func:`~rustpde_mpi_tpu_torch.serve.fleet.proxy.read_replica_status` — and
drives a pluggable
:class:`~rustpde_mpi_tpu_torch.serve.fleet.launcher.ReplicaLauncher`.

The control law lives in :class:`~rustpde_mpi_tpu_torch.config.AutoscaleConfig`
(scale-out on deadline-slack pressure / sustained queue depth / capacity
repair below the floor; scale-in only from a sustained fully-idle fleet,
by SIGTERM through the replica's own park-and-release drain).  Every
evaluation that acts — and every verdict transition — is journaled as a
typed ``autoscale_decision`` row under
``<run_dir>/replicas/<controller>/journal.jsonl``, with
``replica_spawned`` / ``replica_retired`` rows for the actions and live
``autoscale_*`` gauges for dashboards.

Pure host-side file IO + subprocess control: the controller never touches
device state or collectives, so it can ride a daemon thread inside a
root ``SimServer`` (``ServeConfig.autoscale``) or run standalone
(``examples/navier_rbc_autoscale.py``).
"""

from __future__ import annotations

import os
import threading
import time

from ...config import AutoscaleConfig
from ...telemetry import metrics as _tm
from ...utils.journal import JournalWriter
from ..queue import DurableQueue
from .launcher import ReplicaLauncher
from .proxy import read_replica_status


class Autoscaler:
    """One controller over one fleet ``run_dir``.

    ``step()`` is a single observe → decide → act evaluation (pure,
    deterministic given the injected clocks — the unit-test surface);
    ``start()``/``stop()`` wrap it in a daemon thread at
    ``cfg.decide_s`` cadence.  ``mono``/``wall`` inject clocks for
    tests."""

    def __init__(
        self,
        run_dir: str,
        launcher: ReplicaLauncher,
        cfg: AutoscaleConfig | None = None,
        *,
        fleet=None,
        controller_id: str = "",
        registry=None,
        mono=time.monotonic,
        wall=time.time,
        lease_ttl_s: float = 15.0,
    ):
        self.run_dir = run_dir
        self.launcher = launcher
        self.cfg = cfg or AutoscaleConfig()
        self._mono = mono
        self._wall = wall
        if fleet is not None:
            self._ttl = float(fleet.resolved_ttl())
        else:
            self._ttl = float(lease_ttl_s)
        self.controller_id = controller_id or f"autoscaler-{os.getpid()}"
        self.registry = registry if registry is not None else _tm.default_registry()
        self._journal_writer = JournalWriter(
            os.path.join(
                run_dir, "replicas", self.controller_id, "journal.jsonl"
            )
        )
        self.queue = DurableQueue(
            os.path.join(run_dir, "queue"), max_queue=1 << 30
        )
        # sustain-window marks (None = the pressure is not present) and
        # the elective-action cooldown anchor
        self._high_since: float | None = None
        self._idle_since: float | None = None
        self._last_action_mono: float | None = None
        self._seq = 0
        self._last_logged: tuple | None = None
        self.decisions = 0  # acted decisions (scale_out + scale_in)
        self.spawned = 0
        self.retired = 0
        self._stop_evt: threading.Event | None = None
        self._thread: threading.Thread | None = None

    # -- observe ---------------------------------------------------------------

    def observe(self) -> dict:
        """One snapshot of every control input, all from durable state:
        queue census, tightest deadline slack among queued requests,
        heartbeat-fresh replicas, and the launcher's own spawn ledger
        (a just-spawned replica has no heartbeat yet — it counts toward
        capacity for ``spawn_grace_s`` so a slow interpreter start cannot
        read as missing capacity and storm spawns)."""
        self.queue.invalidate()  # proxies + replicas write behind us
        counts = self.queue.counts()
        now_wall = self._wall()
        min_slack = float("inf")
        for _, req in self.queue.snapshot_queued():
            slack = req.deadline_slack(now_wall)
            if slack < min_slack:
                min_slack = slack
        self.launcher.reap()
        status = read_replica_status(self.run_dir, self._ttl)
        fresh = {
            r.get("replica"): r
            for r in status
            if not r.get("stale") and not r.get("stopping")
        }
        now = self._mono()
        pending = 0
        for h in getattr(self.launcher, "handles", list)():
            if h.retired or h.replica_id in fresh:
                continue
            if self.launcher.alive(h) and (
                now - h.spawned_mono
            ) < self.cfg.spawn_grace_s:
                pending += 1
        return {
            "queued": counts["queued"],
            "running": counts["running"],
            "alive": len(fresh),
            "pending": pending,
            "min_slack_s": min_slack,
            "replicas": fresh,
        }

    # -- decide ----------------------------------------------------------------

    def _in_cooldown(self, now: float) -> bool:
        return (
            self._last_action_mono is not None
            and (now - self._last_action_mono) < self.cfg.cooldown_s
        )

    def _pick_victims(self, obs: dict, n: int) -> list:
        """Scale-in victims: launcher-owned, heartbeat-fresh, not-yet-
        retired replicas with the fewest occupied slots (the cheapest
        drains).  Returns exactly ``n`` handles or ``[]`` — gang-shaped
        capacity (``gang_size > 1``) retires a whole gang or nothing,
        and the controller never signals replicas it did not launch."""
        victims = []
        for h in getattr(self.launcher, "handles", list)():
            if h.retired or not self.launcher.alive(h):
                continue
            rec = obs["replicas"].get(h.replica_id)
            if rec is None or rec.get("draining"):
                continue
            occupied = (rec.get("slots") or [0])[0]
            victims.append((occupied, h.replica_id, h))
        if len(victims) < n:
            return []
        victims.sort(key=lambda v: (v[0], v[1]))
        return [v[2] for v in victims[:n]]

    def decide(self, obs: dict) -> dict:
        """Apply the control law to one observation.  Returns the typed
        decision record (the ``autoscale_decision`` journal row body);
        ``action`` is ``scale_out`` / ``scale_in`` / ``hold``."""
        cfg = self.cfg
        # gang-shaped capacity: every scale action moves `unit` replicas
        # as one fate-shared group (1 = the pre-gang control law)
        unit = max(1, int(getattr(cfg, "gang_size", 1)))
        now = self._mono()
        capacity = obs["alive"] + obs["pending"]
        busy = obs["queued"] > 0 or obs["running"] > 0

        # sustain windows first: they must advance on every evaluation,
        # whatever the verdict, or pressure could never accumulate
        if obs["queued"] > cfg.queue_high:
            if self._high_since is None:
                self._high_since = now
        else:
            self._high_since = None
        if not busy:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None

        action, reason, victims = "hold", "steady", []
        if capacity < cfg.min_replicas:
            # capacity repair (a preempted replica died): immediate and
            # cooldown-exempt — replacement is not elective growth
            action, reason = "scale_out", "below_min"
        elif capacity > cfg.max_replicas:
            action, reason = "scale_in", "above_max"
            victims = self._pick_victims(obs, unit)
        elif (
            obs["min_slack_s"] < cfg.slack_low_s
            and capacity + unit <= cfg.max_replicas
        ):
            if self._in_cooldown(now):
                action, reason = "hold", "cooldown"
            else:
                action, reason = "scale_out", "deadline_slack"
        elif (
            self._high_since is not None
            and (now - self._high_since) >= cfg.sustain_s
        ):
            if capacity + unit > cfg.max_replicas:
                action, reason = "hold", "at_max"
            elif self._in_cooldown(now):
                action, reason = "hold", "cooldown"
            else:
                action, reason = "scale_out", "queue_depth"
        elif (
            self._idle_since is not None
            and (now - self._idle_since) >= cfg.idle_sustain_s
            and capacity - unit >= cfg.min_replicas
        ):
            if self._in_cooldown(now):
                action, reason = "hold", "cooldown"
            else:
                action, reason = "scale_in", "idle"
                victims = self._pick_victims(obs, unit)
                if not victims:
                    action, reason = "hold", "no_owned_victim"
        elif self._high_since is not None:
            action, reason = "hold", "pressure_building"
        elif (
            self._idle_since is not None
            and capacity - unit >= cfg.min_replicas
        ):
            action, reason = "hold", "idle_building"

        desired = capacity
        if action == "scale_out":
            desired = min(
                capacity + unit, max(cfg.max_replicas, cfg.min_replicas)
            )
        elif action == "scale_in":
            desired = max(capacity - unit, cfg.min_replicas)
        return {
            "action": action,
            "reason": reason,
            "desired": desired,
            "alive": obs["alive"],
            "pending": obs["pending"],
            "queued": obs["queued"],
            "running": obs["running"],
            "min_slack_s": (
                None
                if obs["min_slack_s"] == float("inf")
                else round(obs["min_slack_s"], 3)
            ),
            "victim": victims[0].replica_id if victims else None,
            "victims": [h.replica_id for h in victims],
            "_victim_handles": victims,
        }

    # -- act -------------------------------------------------------------------

    def _journal(self, event: dict) -> None:
        self._journal_writer.append(
            {"controller": self.controller_id, **event}
        )

    def _log_decision(self, decision: dict) -> None:
        """Journal the decision.  Actions always land; holds land only on
        a verdict TRANSITION (action/reason/desired changed) so a
        long-lived steady controller does not grow the journal without
        bound while every state change stays on the record."""
        key = (decision["action"], decision["reason"], decision["desired"])
        if decision["action"] == "hold" and key == self._last_logged:
            return
        self._last_logged = key
        row = {k: v for k, v in decision.items() if not k.startswith("_")}
        self._journal({"event": "autoscale_decision", **row})

    def act(self, decision: dict) -> None:
        cfg = self.cfg
        unit = max(1, int(getattr(cfg, "gang_size", 1)))
        if decision["action"] == "scale_out":
            rids = []
            for _ in range(unit):
                self._seq += 1
                rids.append(f"{cfg.replica_prefix}-{os.getpid()}-{self._seq}")
            if unit > 1:
                # all-or-nothing: a spawn failure rolls the partial gang
                # back inside the launcher and re-raises
                handles = self.launcher.spawn_gang(rids)
            else:
                handles = [self.launcher.spawn(rids[0])]
            self.spawned += len(handles)
            self.decisions += 1
            if decision["reason"] != "below_min":
                self._last_action_mono = self._mono()
            for handle in handles:
                row = {
                    "event": "replica_spawned",
                    "replica": handle.replica_id,
                    "pid": handle.pid,
                    "reason": decision["reason"],
                }
                if unit > 1:
                    row["gang"] = rids
                self._journal(row)
                self.registry.counter(
                    "autoscale_spawned_total",
                    "replicas spawned by the autoscaler",
                ).inc()
        elif decision["action"] == "scale_in":
            handles = decision.get("_victim_handles") or []
            if not handles:
                return
            if len(handles) > 1:
                self.launcher.retire_gang(handles)
            else:
                self.launcher.retire(handles[0])
            self.retired += len(handles)
            self.decisions += 1
            self._last_action_mono = self._mono()
            for handle in handles:
                row = {
                    "event": "replica_retired",
                    "replica": handle.replica_id,
                    "pid": handle.pid,
                    "reason": decision["reason"],
                }
                if len(handles) > 1:
                    row["gang"] = [h.replica_id for h in handles]
                self._journal(row)
                self.registry.counter(
                    "autoscale_retired_total",
                    "replicas retired (drained) by the autoscaler",
                ).inc()

    def step(self) -> dict:
        """One control evaluation: observe → decide → journal → act →
        gauges.  Returns the decision record."""
        obs = self.observe()
        decision = self.decide(obs)
        self._log_decision(decision)
        self.act(decision)
        self.registry.gauge(
            "autoscale_desired_replicas", "controller's current fleet target"
        ).set(decision["desired"])
        self.registry.gauge(
            "autoscale_alive_replicas", "heartbeat-fresh replicas observed"
        ).set(obs["alive"])
        self.registry.gauge(
            "autoscale_pending_spawns",
            "spawned replicas inside the grace window, no heartbeat yet",
        ).set(obs["pending"])
        return decision

    def stats(self) -> dict:
        return {
            "controller": self.controller_id,
            "decisions": self.decisions,
            "spawned": self.spawned,
            "retired": self.retired,
        }

    # -- daemon ----------------------------------------------------------------

    def start(self) -> None:
        """Run the control loop on a daemon thread (file IO + subprocess
        control only — safe inside a root SimServer next to the
        heartbeat thread)."""
        if self._thread is not None:
            return
        self._stop_evt = threading.Event()

        def loop():
            while not self._stop_evt.wait(self.cfg.decide_s):
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — control must not crash serve
                    pass

        self._thread = threading.Thread(
            target=loop, name="fleet-autoscale", daemon=True
        )
        self._thread.start()

    def stop(self, retire_fleet: bool = False, timeout_s: float = 30.0) -> None:
        """Stop the control loop; ``retire_fleet`` additionally drains
        every launcher-owned replica (the embedded-controller teardown —
        a standalone controller's driver owns that choice itself)."""
        if self._stop_evt is not None:
            self._stop_evt.set()
            if self._thread is not None:
                self._thread.join(timeout=10.0)
            self._thread = None
            self._stop_evt = None
        if retire_fleet:
            shutdown = getattr(self.launcher, "shutdown", None)
            if shutdown is not None:
                shutdown(timeout_s=timeout_s)
        self._journal_writer.close()

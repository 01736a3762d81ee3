"""The port's fleet autoscaler against the JAX package's: the same signal
traces (queue files, replica heartbeat files, fake clocks, an in-memory
launcher) go through both packages' ``Autoscaler`` and give the same
decisions, row for row: the action, reason, target, observed capacity and
victims of every evaluation, and the same journal.  Both launchers'
command lines and the jittered ``Retry-After`` are compared too.  Host
code only: the comparisons are exact."""

import json
import os

import pytest

from rustpde_mpi_tpu.config import AutoscaleConfig as JaxAutoscaleConfig
from rustpde_mpi_tpu.serve import DurableQueue as JaxQueue
from rustpde_mpi_tpu.serve import SimRequest as JaxRequest
from rustpde_mpi_tpu.serve.fleet import Autoscaler as JaxAutoscaler
from rustpde_mpi_tpu.serve.fleet import ReplicaHandle as JaxHandle
from rustpde_mpi_tpu.serve.fleet import ReplicaLauncher as JaxLauncher
from rustpde_mpi_tpu.serve.fleet.proxy import write_replica_heartbeat as jax_heartbeat
from rustpde_mpi_tpu.serve import http_front as jax_front

from rustpde_mpi_tpu_torch.config import AutoscaleConfig, FleetConfig
from rustpde_mpi_tpu_torch.serve import DurableQueue, SimRequest
from rustpde_mpi_tpu_torch.serve import http_front
from rustpde_mpi_tpu_torch.serve.fleet import (Autoscaler, LocalProcessLauncher, ReplicaHandle,
                                               ReplicaLauncher)
from rustpde_mpi_tpu_torch.serve.fleet.proxy import write_replica_heartbeat
from rustpde_mpi_tpu_torch.serve.fleet.replica_main import build_parser
from rustpde_mpi_tpu_torch.utils.journal import read_journal

_REQ = dict(ra=1e4, pr=1.0, nx=17, ny=17, dt=0.01, horizon=0.1, bc="rbc")

PORT = dict(Autoscaler=Autoscaler, Config=AutoscaleConfig, Handle=ReplicaHandle,
            Launcher=ReplicaLauncher, Queue=DurableQueue, Request=SimRequest,
            heartbeat=write_replica_heartbeat)
JAX = dict(Autoscaler=JaxAutoscaler, Config=JaxAutoscaleConfig, Handle=JaxHandle,
           Launcher=JaxLauncher, Queue=JaxQueue, Request=JaxRequest, heartbeat=jax_heartbeat)


class Clock:
    """A hand-advanced clock (monotonic and wall alike)."""

    def __init__(self, t):
        self.t = float(t)

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def fake_launcher(pkg):
    """An in-memory launcher over the package's ``ReplicaLauncher``:
    spawns are ledger entries, retire and kill are recorded."""

    class Fake(pkg["Launcher"]):
        def __init__(self):
            self._handles = {}
            self.log = []

        def handles(self):
            return list(self._handles.values())

        def spawn(self, replica_id):
            h = pkg["Handle"](replica_id=replica_id, pid=1000 + len(self._handles),
                              spawned_mono=CLOCK.t)
            self._handles[replica_id] = h
            self.log.append(("spawn", replica_id))
            return h

        def retire(self, handle):
            handle.retired = True
            self.log.append(("retire", handle.replica_id))

        def kill(self, handle):
            handle.retired = True
            self.log.append(("kill", handle.replica_id))

        def alive(self, handle):
            return not getattr(handle, "dead", False)

        def reap(self):
            gone = [h for h in self._handles.values() if not self.alive(h)]
            for h in gone:
                del self._handles[h.replica_id]
            return gone

    return Fake()


CLOCK = Clock(1000.0)
WALL = 1.7e9

#: each trace: the control law's config and the steps, each a list of
#: operations on the fleet's state followed by one evaluation.  Operations:
#: ("submit", seed, extra request fields), ("heartbeat", replica id,
#: payload), ("spawn", replica id), ("die", replica id), ("claim",),
#: ("complete",), ("tick", seconds)
TRACES = {
    "queue_depth_sustain_and_cooldown": (
        dict(min_replicas=0, max_replicas=3, queue_high=2, sustain_s=5.0, cooldown_s=30.0),
        [[("submit", s, {}) for s in range(4)], [("tick", 3.0)], [("tick", 3.0)],
         [("tick", 1.0)], [("tick", 10.0)], [("tick", 30.0)]]),
    "deadline_slack_at_once": (
        dict(min_replicas=0, max_replicas=2, queue_high=50, slack_low_s=30.0),
        [[("submit", 0, {"deadline_s": 10.0})], [("tick", 1.0)], [("tick", 1.0)]]),
    "below_min_repair_in_cooldown": (
        dict(min_replicas=1, max_replicas=3, cooldown_s=3600.0),
        [[], [("die", 0), ("tick", 1.0)], [("tick", 1.0)]]),
    "idle_scale_in_fewest_occupied": (
        dict(min_replicas=1, max_replicas=3, idle_sustain_s=10.0, cooldown_s=0.0),
        [[("spawn", "auto-a"), ("spawn", "auto-b"), ("heartbeat", "auto-a", {"slots": [2, 2]}),
          ("heartbeat", "auto-b", {"slots": [0, 2]})], [("tick", 11.0)],
         [("tick", 11.0), ("heartbeat", "auto-a", {"slots": [0, 2]}),
          ("heartbeat", "auto-b", {"stopping": True})]]),
    "holds_at_max_journal_once": (
        dict(min_replicas=0, max_replicas=1, queue_high=1, sustain_s=0.0, cooldown_s=0.0),
        [[("submit", s, {}) for s in range(3)] + [("tick", 1.0)]]
        + [[("tick", 1.0)] for _ in range(5)]),
    "gang_shaped_moves": (
        dict(min_replicas=2, max_replicas=4, gang_size=2, queue_high=1, sustain_s=0.0,
             cooldown_s=0.0, idle_sustain_s=5.0),
        [[], [("submit", s, {}) for s in range(3)] + [("tick", 1.0)], [("claim",), ("claim",),
                                                                       ("claim",)],
         [("complete",), ("complete",), ("complete",), ("tick", 6.0)], [("tick", 6.0)]]),
    "spawn_grace_and_stale_heartbeats": (
        dict(min_replicas=2, max_replicas=2, spawn_grace_s=5.0),
        [[("spawn", "r0"), ("spawn", "r1")], [("tick", 2.0), ("heartbeat", "r0", {})],
         [("tick", 4.0)], [("die", "r1"), ("tick", 1.0)], [("tick", 20.0)]]),
}


def run_trace(pkg, tmp_path, name):
    """Drive one trace through one package; returns the decision rows,
    the launcher's log and the controller's journal events."""
    CLOCK.t = 1000.0
    cfg_kw, steps = TRACES[name]
    run_dir = str(tmp_path / name / ("port" if pkg is PORT else "jax") / "fleet")
    launcher = fake_launcher(pkg)
    asc = pkg["Autoscaler"](run_dir, launcher, pkg["Config"](**cfg_kw), controller_id="asc",
                            mono=CLOCK, wall=lambda: WALL)
    queue = pkg["Queue"](os.path.join(run_dir, "queue"), max_queue=64)
    claimed, out = [], []
    for ops in steps:
        for op in ops:
            if op[0] == "submit":
                queue.submit(pkg["Request"](**_REQ, seed=op[1], submitted_s=WALL - 1.0, **op[2]))
            elif op[0] == "heartbeat":
                pkg["heartbeat"](run_dir, op[1], op[2])
            elif op[0] == "spawn":
                launcher.spawn(op[1])
            elif op[0] == "die":
                victim = op[1] if isinstance(op[1], str) else launcher.handles()[op[1]].replica_id
                launcher._handles[victim].dead = True
            elif op[0] == "claim":
                queue.invalidate()
                claimed.append(queue.claim())
            elif op[0] == "complete":
                queue.complete(claimed.pop(), {"nu": 1.0})
            elif op[0] == "tick":
                CLOCK.tick(op[1])
        d = asc.step()
        out.append({k: v for k, v in d.items() if not k.startswith("_")})
    asc.stop()
    rows = read_journal(os.path.join(run_dir, "replicas", "asc", "journal.jsonl"))
    # replica ids carry the controller's pid: compare them by position
    ids = {}
    for _, rid in launcher.log:
        ids.setdefault(rid, f"spawn{len(ids)}")
    norm = json.loads(json.dumps(out))
    text = json.dumps([norm, launcher.log, [(r["event"], r.get("reason")) for r in rows],
                       asc.stats()["spawned"], asc.stats()["retired"]])
    for rid, tag in ids.items():
        text = text.replace(rid, tag)
    return json.loads(text)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_control_law_decisions_as_jax(tmp_path, name):
    port, jax_side = run_trace(PORT, tmp_path, name), run_trace(JAX, tmp_path, name)
    assert port == jax_side
    decisions = port[0]
    assert len(decisions) == len(TRACES[name][1])
    assert any(d["action"] != "hold" for d in decisions) or name == "spawn_grace_and_stale_heartbeats"


def test_autoscale_config_and_fleet_defaults_as_jax():
    from dataclasses import asdict

    from rustpde_mpi_tpu.config import FleetConfig as JaxFleetConfig

    assert asdict(AutoscaleConfig()) == asdict(JaxAutoscaleConfig())
    port, jax_cfg = FleetConfig(replica_id="r"), JaxFleetConfig(replica_id="r")
    assert asdict(port) == asdict(jax_cfg)
    assert (port.resolved_ttl(), port.resolved_heartbeat(), port.resolved_quota("t")) == \
        (15.0, 5.0, None)
    q = FleetConfig(lease_ttl_s=3.0, default_quota=2, quotas={"vip": None, "x": 5})
    assert (q.resolved_heartbeat(), q.resolved_quota("a"), q.resolved_quota("vip"),
            q.resolved_quota("x")) == (1.0, 2, None, 5)


def test_autoscaler_ttl_without_fleet_is_an_argument(tmp_path):
    asc = Autoscaler(str(tmp_path / "f"), fake_launcher(PORT), AutoscaleConfig(),
                     lease_ttl_s=4.0)
    assert asc._ttl == 4.0
    assert Autoscaler(str(tmp_path / "g"), fake_launcher(PORT), AutoscaleConfig())._ttl == 15.0
    asc = Autoscaler(str(tmp_path / "h"), fake_launcher(PORT), AutoscaleConfig(),
                     fleet=FleetConfig(lease_ttl_s=2.0))
    assert asc._ttl == 2.0


def test_launcher_children_take_flags_not_environment(tmp_path):
    """A launched replica's device and preemption notice are flags; the
    launcher leaves the environment as given and the replica's parser
    reads them."""
    env = {"PATH": "/usr/bin"}
    la = LocalProcessLauncher(str(tmp_path), serve_args=["--slots", "3"], notice_s=2.5, env=env,
                              device="cpu", python="python3")
    argv = la.argv("r7")
    assert argv[:3] == ["python3", "-m", "rustpde_mpi_tpu_torch.serve.fleet.replica_main"]
    assert la.env == env
    args = build_parser().parse_args(argv[3:])
    assert (args.run_dir, args.replica_id, args.daemon, args.device, args.preempt_notice_s,
            args.slots) == (str(tmp_path), "r7", True, "cpu", 2.5, 3)
    assert "--preempt-notice-s" not in LocalProcessLauncher(str(tmp_path), env=env).argv("r")
    assert LocalProcessLauncher(str(tmp_path), env=env).device == "cuda"


def test_retry_after_jitter_as_jax():
    from rustpde_mpi_tpu.serve.request import AdmissionError as JaxAdmission

    from rustpde_mpi_tpu_torch.serve import AdmissionError

    for depth in (0, 3, 40):
        http_front.seed_retry_jitter(7)
        jax_front.seed_retry_jitter(7)
        port = [http_front.rejection_payload(AdmissionError("quota", "x", retry_after_s=2.0),
                                             depth) for _ in range(5)]
        jax_side = [jax_front.rejection_payload(JaxAdmission("quota", "x", retry_after_s=2.0),
                                                depth) for _ in range(5)]
        assert port == jax_side
        assert all(p["retry_after_s"] == h["Retry-After"] >= 1 for p, h in port)

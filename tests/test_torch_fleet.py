"""The port's fleet layer against the JAX package's: bucket leases, the
QoS policy, the clock monitor and the gang lease group decide alike on the
same inputs (each package's module driven by the same script, on its own
directory, and on one shared directory for the lease files); the
stateless proxy answers the same HTTP exchange with the same codes and
bodies (voting and bearer tokens included); replica heartbeats read
across packages; two in-process replicas of the port share one run
directory under leases; a launched replica on the CPU serves and drains;
continuations persist without ``h5py``.  Everything compared is host
data: the comparisons are exact, except the served results (1e-9 of a
solo run of the port)."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rustpde_mpi_tpu.config import FleetConfig as JaxFleetConfig
from rustpde_mpi_tpu.config import SubmeshConfig as JaxSubmeshConfig
from rustpde_mpi_tpu.serve import FleetProxy as JaxProxy
from rustpde_mpi_tpu.serve import SimRequest as JaxRequest
from rustpde_mpi_tpu.serve import http_front as jax_front
from rustpde_mpi_tpu.serve.fleet import clock as jax_clock
from rustpde_mpi_tpu.serve.fleet import gang as jax_gang
from rustpde_mpi_tpu.serve.fleet import lease as jax_lease
from rustpde_mpi_tpu.serve.fleet import qos as jax_qos
from rustpde_mpi_tpu.serve.fleet.proxy import read_replica_status as jax_read_status
from rustpde_mpi_tpu.serve.fleet.proxy import write_replica_heartbeat as jax_heartbeat

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.config import FleetConfig, ServeConfig, SubmeshConfig
from rustpde_mpi_tpu_torch.serve import FleetProxy, SimRequest, SimServer
from rustpde_mpi_tpu_torch.serve import http_front
from rustpde_mpi_tpu_torch.serve.fleet import LocalProcessLauncher
from rustpde_mpi_tpu_torch.serve.fleet import clock, gang, lease, qos
from rustpde_mpi_tpu_torch.serve.fleet.proxy import read_replica_status, write_replica_heartbeat
from rustpde_mpi_tpu_torch.utils import checkpoint
from rustpde_mpi_tpu_torch.utils.journal import read_journal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REQ = dict(ra=1e4, pr=1.0, nx=17, ny=17, dt=0.01, horizon=0.1, bc="rbc")
_KEY = SimRequest(**_REQ).compat_key
PORT = dict(lease=lease, qos=qos, clock=clock, gang=gang, Request=SimRequest,
            Fleet=FleetConfig, Submesh=SubmeshConfig, Proxy=FleetProxy, front=http_front,
            heartbeat=write_replica_heartbeat, status=read_replica_status)
JAX = dict(lease=jax_lease, qos=jax_qos, clock=jax_clock, gang=jax_gang, Request=JaxRequest,
           Fleet=JaxFleetConfig, Submesh=JaxSubmeshConfig, Proxy=JaxProxy, front=jax_front,
           heartbeat=jax_heartbeat, status=jax_read_status)


def outcome(fn):
    """``fn()``'s value, or the name of the exception it raised."""
    try:
        return fn()
    except Exception as exc:  # the type name is compared
        return type(exc).__name__


# -- leases --------------------------------------------------------------------------------------


def lease_script(pkg, root):
    """Claim, renew, release, the stale break and fencing, a resurrection
    retracted at the escrow, and a crashed breaker's intermediate adopted:
    the observable outcomes in order."""
    LM, LeaseLost = pkg["lease"].LeaseManager, pkg["lease"].LeaseLost
    out = []
    m1, m2 = LM(root, "r1", ttl_s=60.0), LM(root, "r2", ttl_s=60.0)
    a = m1.claim(_KEY)
    out += [a.token, a.tag == pkg["lease"].bucket_tag(_KEY), m2.claim(_KEY) is None]
    a.renew()
    a.guard()
    a.release()
    b = m2.claim(_KEY)
    out += [b.token, outcome(a.guard), outcome(a.renew)]
    with open(b.path, encoding="utf-8") as fh:
        rec = json.load(fh)
    out.append(sorted(rec))
    b.release()
    dead, live = LM(root, "dead", ttl_s=0.1), LM(root, "live", ttl_s=0.1)
    c = dead.claim(_KEY)
    out += [c.token, live.stale(c.tag)]
    time.sleep(0.15)
    out.append(live.stale(c.tag))
    broken = live.break_lease(c.tag)
    out += [broken["owner"], live.break_lease(c.tag) is None]
    d = live.claim(_KEY)
    out += [d.token, outcome(c.renew), outcome(c.guard)]
    with open(c.path, "w", encoding="utf-8") as fh:  # a zombie's late write
        json.dump(dead._record(c, 1), fh)
    out += [outcome(c.renew), os.path.exists(c.path), outcome(d.guard)]
    e = m1.claim(_KEY)
    out.append(None if e is None else e.token)
    if e is not None:
        os.replace(e.path, e.path + ".breaking.crashed.1")  # a breaker crashed mid-break
        f = m2.claim(_KEY)
        out += [f.token, sorted(r["owner"] for r in m2.holders().values())]
    return out


def test_lease_protocol_as_jax(tmp_path):
    assert lease_script(PORT, str(tmp_path / "port")) == lease_script(JAX, str(tmp_path / "jax"))


def test_lease_files_shared_across_packages(tmp_path):
    """One lease directory, a replica of each package: a lease either
    claims is held for the other, the tokens escrow across them, and a
    stale one is broken by the other."""
    root = str(tmp_path / "leases")
    port, jax_mgr = lease.LeaseManager(root, "p", ttl_s=0.1), jax_lease.LeaseManager(root, "j",
                                                                                      ttl_s=0.1)
    held = port.claim(_KEY)
    assert held.token == 1 and jax_mgr.claim(_KEY) is None
    held.release()
    theirs = jax_mgr.claim(_KEY)
    assert theirs.token == 2 and port.claim(_KEY) is None
    assert port.stale(theirs.tag) is False
    time.sleep(0.15)
    assert port.sweep()[0]["owner"] == "j"
    with pytest.raises(jax_lease.LeaseLost):
        theirs.renew()
    assert port.claim(_KEY).token == 3


# -- QoS, clock, gangs ---------------------------------------------------------------------------


def qos_script(pkg):
    Request, q = pkg["Request"], pkg["qos"]
    now = 2e9
    mk = lambda i, **kw: (f"{i:020d}-x.json", Request(**dict(_REQ, submitted_s=now - 5.0, **kw)))
    be = mk(1, dt=0.01, priority="best-effort")
    ia = mk(2, dt=0.005, priority="interactive", deadline_s=60.0)
    ba = mk(3, dt=0.0025)
    tight = mk(4, dt=0.02, priority="interactive", deadline_s=8.0)
    loaded = [be, ia, ba, tight]
    out = [q.bucket_order(loaded, now), q.bucket_order([ia, tight], now)]
    for slack in (1.0, 30.0, 100.0):
        r = q.find_at_risk(loaded, slack, now)
        out.append(None if r is None else r.compat_key)
    at_risk = Request(**_REQ, priority="interactive", deadline_s=1.0, submitted_s=now)
    running = [(0, Request(**_REQ, priority="best-effort")), (1, Request(**_REQ)),
               (2, Request(**_REQ, priority="best-effort", deadline_s=5.0))]
    other = ("lnse",) + _KEY[1:]
    out += [q.preempt_victims(running, at_risk, _KEY), sorted(q.preempt_victims(running, at_risk,
                                                                                 other)),
            q.preempt_victims(running, Request(**_REQ, deadline_s=1.0), other)]
    fleet = pkg["Fleet"](default_quota=2, quotas={"vip": None, "small": 1})
    for tenant, held in (("a", 1), ("a", 2), ("vip", 99), ("small", 1), ("small", 0)):
        out.append(outcome(lambda: q.check_quota(Request(**_REQ, tenant=tenant),
                                                 {tenant: held}, fleet)))
    sub = pkg["Submesh"](shapes=(4, 2), shard_min_nx=34, max_pending=2)
    for nx, pending in ((17, 0), (34, 0), (34, 2), (66, 0), (35, 0)):
        r = Request(**dict(_REQ, nx=nx, ny=nx))
        got = outcome(lambda: q.admit_submesh(r, pending, sub))
        out.append(got if isinstance(got, str) else (got.submesh, got.compat_key))
    out.append(q.admit_submesh(Request(**_REQ), 0, None).compat_key)
    return out


def test_qos_decisions_as_jax():
    assert qos_script(PORT) == qos_script(JAX)


def test_clock_monitor_as_jax():
    def script(pkg):
        wall, mono = [100.0], [50.0]
        rows = []
        mon = pkg["clock"].ClockMonitor(wall=lambda: wall[0], mono=lambda: mono[0])
        out = []
        for dw, dm in ((0, 0), (1, 1), (40, 1), (2, 2), (-60, 1), (1, 1)):
            wall[0] += dw
            mono[0] += dm
            with pytest.warns(RuntimeWarning) if abs(dw - dm) > 30 and not rows else \
                    _nullcontext():
                out.append(mon.check(30.0, journal=rows.append, where="t"))
        return out, rows

    assert script(PORT) == script(JAX)


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def gang_script(pkg, root):
    LM, g = pkg["lease"].LeaseManager, pkg["gang"]
    out = [g.gang_key(_KEY), g.member_key(_KEY, 1)]
    m1, m2 = LM(root, "a", ttl_s=0.1), LM(root, "b", ttl_s=0.1)
    blocker = m2.claim(g.member_key(_KEY, 1))
    out.append(g.GangLease.form(m1, _KEY, 2) is None)  # all or nothing: rolled back
    out.append(sorted(r["owner"] for r in m1.holders().values()))
    blocker.release()
    gl = g.GangLease.form(m1, _KEY, 2)
    out += [gl.generation, [m.token for m in gl.members], gl.tag]
    gl.renew()
    gl.renew_member(0)
    gl.guard()
    m2.stale(gl.group.tag)
    time.sleep(0.15)
    broken = g.stale_gangs(m2)
    out += [[r["owner"] for r in broken], outcome(gl.renew), outcome(gl.guard)]
    gl2 = g.GangLease.form(m2, _KEY, 2)
    out += [gl2.generation, [m.token for m in gl2.members]]
    out.append(g.break_gang(m1, _KEY, 2)["owner"])
    out.append(g.break_gang(m1, _KEY, 2))
    out.append(outcome(gl2.release))
    g.gang_sync("t", "gang0")  # one process: the ordinary (no-op) sync
    return out


def test_gang_decisions_as_jax(tmp_path):
    assert gang_script(PORT, str(tmp_path / "port")) == gang_script(JAX, str(tmp_path / "jax"))


def test_gang_sync_timeout_is_an_argument():
    gang.gang_sync("t", "gang0", member=0, timeout_s=5.0)
    assert "timeout_s" in gang.gang_sync.__code__.co_varnames
    assert not hasattr(gang, "gang_sync_timeout_s")


# -- heartbeats and the proxy --------------------------------------------------------------------


def test_replica_heartbeats_read_across_packages(tmp_path):
    run_dir = str(tmp_path / "fleet")
    write_replica_heartbeat(run_dir, "rA", {"draining": False, "slots": [1, 2]})
    jax_heartbeat(run_dir, "rB", {"draining": True})
    with open(os.path.join(run_dir, "replicas", "rC.json"), "w") as fh:
        fh.write('{"replica": "rC", "hb_unix"')  # torn
    past = time.time() - 120.0
    os.utime(os.path.join(run_dir, "replicas", "rB.json"), (past, past))

    def norm(rows):
        return [{k: v for k, v in r.items() if k not in ("hb_age_s",)} for r in rows]

    with pytest.warns(RuntimeWarning, match="torn"):
        port = read_replica_status(run_dir, ttl_s=60.0)
    with pytest.warns(RuntimeWarning, match="torn"):
        jax_rows = jax_read_status(run_dir, ttl_s=60.0)
    assert norm(port) == norm(jax_rows)
    assert [(r["replica"], r["stale"]) for r in port] == [("rA", False), ("rB", True),
                                                          ("rC", True)]


def http(base, path, payload=None, token=None, raw=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    headers = {} if token is None else {"Authorization": f"Bearer {token}"}
    req = urllib.request.Request(base + path, data=data, headers=headers,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = resp.read()
            code, hdrs = resp.status, dict(resp.headers)
    except urllib.error.HTTPError as err:
        body, code, hdrs = err.read(), err.code, dict(err.headers)
    try:
        body = json.loads(body)
    except ValueError:
        body = body.decode()
    return code, body, hdrs.get("Retry-After")


def proxy_script(pkg, run_dir):
    """One HTTP exchange with a proxy: admission, quota and queue-full 429s
    with ``Retry-After``, malformed 400s, status and trace reads, stats and
    health, bearer tokens on mutations, cross-replica voting."""
    pkg["front"].seed_retry_jitter(3)
    fleet = pkg["Fleet"](replica_id="p1", default_quota=2)
    proxy = pkg["Proxy"](run_dir, max_queue=4, fleet=fleet, auth_tokens=["s3cret"],
                         vote_rate=1.0)
    proxy.start()
    out, ids = [], []
    try:
        host, port = proxy.address
        base = f"http://{host}:{port}"

        def post(payload, token="s3cret", raw=None):
            code, body, retry = http(base, "/requests", payload, token, raw)
            if isinstance(body, dict) and "id" in body:
                ids.append(body["id"])
                body = {k: v for k, v in body.items() if k not in ("id", "trace_id")}
            return code, body, retry

        out.append(post(dict(_REQ, seed=0, tenant="t1"), token=None))
        out.append(post(dict(_REQ, seed=0, tenant="t1"), token="wrong"))
        out.append(post(dict(_REQ, seed=0, tenant="t1")))
        out.append(post(dict(_REQ, dt=-1.0)))
        out.append(post(None, raw=b"not json"))
        out.append(post(dict(_REQ, priority="nope")))
        out.append(post(dict(_REQ, seed=1, tenant="t1")))
        out.append(post(dict(_REQ, seed=2, tenant="t2")))
        out.append(post(dict(_REQ, seed=3, tenant="t2")))
        code, status, _ = http(base, f"/requests/{ids[0]}")
        out.append((code, status["state"], status.get("steps")))
        out.append(http(base, "/requests/nope")[:2])
        code, stats, _ = http(base, "/stats")
        out.append((code, stats["queue"], stats["tenants"], stats["leases"], stats["replicas"],
                    sorted(stats)))
        code, health, _ = http(base, "/healthz")
        out.append((code, sorted(health), health["ok"], health["replicas_alive"]))
        code, text, _ = http(base, "/metrics")
        out.append((code, "fleet_proxy_requests_total" in text))
    finally:
        proxy.stop()
    rows = read_journal(os.path.join(run_dir, "replicas", "proxy-p1", "journal.jsonl"))
    out.append([r["event"] for r in rows])
    out.append(sorted(n.endswith(".vote.json") for n in os.listdir(
        os.path.join(run_dir, "queue", "queued"))))
    return out


def test_proxy_endpoints_and_voting_as_jax(tmp_path):
    port = proxy_script(PORT, str(tmp_path / "port"))
    jax_side = proxy_script(JAX, str(tmp_path / "jax"))
    assert port == jax_side
    assert port[0][0] == 401 and port[1][0] == 403 and port[2][0] == 202
    assert any(code == 429 and body["reason"] == "quota" and retry for code, body, retry in
               port[3:9])


def test_proxy_defaults_serve_open_and_vote_nothing(tmp_path):
    proxy = FleetProxy(str(tmp_path / "f"))
    assert proxy.auth_tokens == () and proxy.vote_rate == 0.0
    proxy._httpd.server_close()


# -- serving in fleet mode -----------------------------------------------------------------------


def _solo_nu(res):
    m = pt.Navier2D(17, 17, 1e4, 1.0, res["dt"], 1.0, "rbc", device="cpu")
    m.init_random(res["amp"] or 0.1, seed=res["seed"])
    m.update_n(res["steps"])
    return float(m.eval_nu())


def test_two_in_process_replicas_share_one_run_dir(tmp_path):
    """Two fleet replicas of the port in one process (threads) over one run
    directory and two buckets: each bucket is leased by one replica at a
    time, every request resolves exactly once, results match solo runs."""
    run_dir = str(tmp_path / "fleet")

    def cfg(rid):
        return ServeConfig(run_dir=run_dir, slots=2, chunk_steps=4, checkpoint_every_s=None,
                           fleet=FleetConfig(replica_id=rid, lease_ttl_s=30.0))

    a, b = SimServer(cfg("rA"), device="cpu"), SimServer(cfg("rB"), device="cpu")
    ids = [a.submit(dict(_REQ, seed=s, dt=0.01 if s % 2 else 0.005)).id for s in range(6)]
    summaries = {}
    threads = [threading.Thread(target=lambda s=s, n=n: summaries.update({n: s.serve()}))
               for s, n in ((a, "rA"), (b, "rB"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sum(s["completed"] for s in summaries.values()) == 6
    assert a.queue.counts() == {"queued": 0, "running": 0, "done": 6, "failed": 0}
    done = {}
    for rid in ("rA", "rB"):
        rows = read_journal(os.path.join(run_dir, "replicas", rid, "journal.jsonl"))
        for r in rows:
            if r["event"] == "request_done":
                done[r["id"]] = done.get(r["id"], 0) + 1
        claimed = [r["bucket"] for r in rows if r["event"] == "lease_claimed"]
        released = [r["bucket"] for r in rows if r["event"] == "lease_released"]
        assert sorted(claimed) == sorted(released)
    assert done == {i: 1 for i in ids}
    for rid in ids[:2]:
        res = a.result(rid)
        assert res["nu"] == pytest.approx(_solo_nu(res), rel=1e-9)


def test_a_fenced_replica_settles_nothing(tmp_path):
    """A peer breaks a replica's bucket lease while the replica is inside a
    chunk (a stall past the TTL) and requeues its requests: at the next
    boundary the replica is fenced before it settles anything, so the
    requests that chunk finished are done once, by the next lease holder
    (here the same replica, in its next campaign)."""
    run_dir = str(tmp_path / "fleet")
    cfg = ServeConfig(run_dir=run_dir, slots=2, chunk_steps=4, checkpoint_every_s=None,
                      fleet=FleetConfig(replica_id="rZ", lease_ttl_s=30.0))
    broken = []

    class Stalled(SimServer):
        def _build_runner(self, key, k=None):
            runner, ens = super()._build_runner(key, k)
            inner = runner.advance

            def advance(n):
                out = inner(n)
                if not broken:  # the peer, while this replica was in the chunk
                    peer = lease.LeaseManager(os.path.join(run_dir, "queue", "leases"), "peer",
                                              30.0)
                    broken.append(peer.break_lease(self._lease.tag))
                    broken.append(self.queue.recover_bucket(key))
                return out

            runner.advance = advance
            return runner, ens

    srv = Stalled(cfg, device="cpu")
    ids = [srv.submit(dict(_REQ, seed=s, horizon=0.04)).id for s in range(2)]
    assert srv.serve()["completed"] == 2
    assert broken[0] is not None and sorted(broken[1]) == sorted(ids)
    rows = [r["event"] for r in read_journal(os.path.join(run_dir, "replicas", "rZ",
                                                          "journal.jsonl"))]
    fenced = rows.index("campaign_fenced")
    assert "request_done" not in rows[:fenced] and "lease_fenced" in rows[:fenced]
    assert rows.count("request_done") == 2
    assert srv.queue.counts() == {"queued": 0, "running": 0, "done": 2, "failed": 0}


def test_launched_replica_serves_and_drains_on_the_cpu(tmp_path):
    """``LocalProcessLauncher`` starts ``replica_main`` with ``--device
    cpu``; the replica serves two requests and a retire (SIGTERM) drains it
    to exit 0 within the test's deadline."""
    run_dir = str(tmp_path / "fleet")
    q = pt.serve.DurableQueue(os.path.join(run_dir, "queue"))
    ids = [q.submit(SimRequest(**dict(_REQ, seed=s))).id for s in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    la = LocalProcessLauncher(run_dir, device="cpu", env=env, log_dir=str(tmp_path / "logs"),
                              serve_args=["--slots", "2", "--lease-ttl-s", "30"])
    h = la.spawn("r0")
    deadline = time.monotonic() + 90.0
    try:
        while time.monotonic() < deadline:
            q.invalidate()
            if q.counts()["done"] == 2:
                break
            assert la.alive(h), open(str(tmp_path / "logs" / "r0.log")).read()[-2000:]
            time.sleep(0.2)
        la.retire(h)
        h.proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if la.alive(h):
            la.kill(h)
            h.proc.wait()
    assert h.proc.returncode == 0, open(str(tmp_path / "logs" / "r0.log")).read()[-2000:]
    assert [q.lookup(i)[0] for i in ids] == ["done", "done"]
    rows = read_journal(os.path.join(run_dir, "replicas", "r0", "journal.jsonl"))
    assert [r["event"] for r in rows][-2:] == ["drain", "server_stop"]


# -- continuations without h5py ------------------------------------------------------------------


def test_continuations_persist_as_npz_without_h5py(tmp_path, monkeypatch):
    """Where ``h5py`` does not import (the card's machine) a continuation
    shard is an ``.npz`` with the same digest as the HDF5 one; it reads
    back bit for bit, and a corrupted one is refused."""
    model = pt.Navier2D(17, 17, 1e4, 1.0, 0.01, 1.0, "rbc", device="cpu")
    model.init_random(0.1, seed=3)
    state = model.state
    h5_dir, npz_dir = str(tmp_path / "h5"), str(tmp_path / "npz")
    checkpoint.write_continuation(h5_dir, state, base=7, time_base=0.07, meta={"id": "x"})
    monkeypatch.setattr(checkpoint, "_have_h5py", lambda: False)
    checkpoint.write_continuation(npz_dir, state, base=7, time_base=0.07, meta={"id": "x"})
    rec_h5, rec_npz = checkpoint.continuation_record(h5_dir), checkpoint.continuation_record(npz_dir)
    assert rec_npz["shards"][0]["file"] == "shard_00000.npz"
    assert rec_npz["shards"][0]["digest"] == rec_h5["shards"][0]["digest"]
    assert {k: v for k, v in rec_npz.items() if k != "shards"} == \
        {k: v for k, v in rec_h5.items() if k != "shards"}
    got, base, tb = checkpoint.read_continuation(npz_dir, state)
    assert (base, tb) == (7, 0.07)
    assert all(torch.equal(a, b) for a, b in zip(got, state))
    path = os.path.join(npz_dir, "shard_00000.npz")
    with np.load(path) as npz:
        arrays = {k: npz[k].copy() for k in npz.files}
    arrays["temp"].flat[3] += 1.0
    np.savez(path, **arrays)
    with pytest.raises(checkpoint.CheckpointError, match="content mismatch"):
        checkpoint.read_continuation(npz_dir, state)


@pytest.mark.parametrize("sub", ["serve", "serve/fleet"])
def test_serve_packages_export_the_jax_names(sub):
    """``rustpde_mpi_tpu_torch.serve`` and ``.serve.fleet`` export every
    name the JAX package's ``__init__`` imports."""
    import ast
    import importlib

    with open(os.path.join(REPO, "rustpde_mpi_tpu", *sub.split("/"), "__init__.py")) as fh:
        tree = ast.parse(fh.read())
    names = {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             for a in node.names}
    module = importlib.import_module("rustpde_mpi_tpu_torch." + sub.replace("/", "."))
    assert names and not [n for n in sorted(names) if not hasattr(module, n)]

"""The port's ``SimServer`` against the JAX package's, on the CPU at 17^2:
the same requests, seeds and fault specs go through both servers (the
JAX one on the conftest's CPU devices, the port's with
``device="cpu"``), and they must agree: every result's observables to
1e-11 of their scale (steps, dt, slot, retries exactly), the journal's
event types in the same order (the wall-clock ``perf_degraded`` and
``profile_capture`` rows left out), the queue's rows exactly.  Here: a
batch with refills, a divergent member isolated and failed typed, a NaN
fault retried, the SIGTERM drain and its restart, the elastic grow and
shrink re-plans, the HTTP front's endpoints and error paths (same codes
and bodies) and its profile endpoint.  The port's results are also held
to solo runs of the port (1e-9, as the JAX tests hold theirs).

Two processes on gloo (``tests/torch_mp_worker.py``) serve on meshes
spanning both, as the JAX scheduler places its campaigns on several
processes: each result bit for bit a solo run of its request on a
one-process mesh of the same rank count, a gang parked through the
continuation writer and resumed bit for bit, the continuation's shards
joined into the member's global state, a gang re-placed onto a slice of
another shape, and a gang member's death ending in the typed loss within
the gang deadline."""

import gc
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from rustpde_mpi_tpu.config import ServeConfig as JaxServeConfig
from rustpde_mpi_tpu.serve import SimServer as JaxServer
from rustpde_mpi_tpu.serve.http_front import HttpFront as JaxFront
from rustpde_mpi_tpu.serve import http_front as jax_front

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.config import ServeConfig
from rustpde_mpi_tpu_torch.serve import RequestFailed, SimServer
from rustpde_mpi_tpu_torch.serve.scheduler import RANK_SLOTS
from rustpde_mpi_tpu_torch.serve import http_front
from rustpde_mpi_tpu_torch.serve.http_front import HttpFront
from rustpde_mpi_tpu_torch.telemetry import compile_log
from rustpde_mpi_tpu_torch.utils.journal import read_journal

_REQ = dict(ra=1e4, pr=1.0, nx=17, ny=17, dt=0.01, horizon=0.1, bc="rbc")
CLOCKED = ("perf_degraded", "profile_capture")
#: results: each observable to this of its scale
OBS_REL = 1e-11


@pytest.fixture(autouse=True)
def _collect():
    yield
    gc.collect()


def _cfg(cls, tmp_path, name, **kw):
    kw.setdefault("run_dir", str(tmp_path / name))
    kw.setdefault("slots", 2)
    kw.setdefault("chunk_steps", 4)
    kw.setdefault("checkpoint_every_s", None)
    kw.setdefault("http_port", None)
    return cls(**kw)


def _servers(tmp_path, fault=None, **kw):
    return (JaxServer(_cfg(JaxServeConfig, tmp_path, "jax", **kw), fault=fault),
            SimServer(_cfg(ServeConfig, tmp_path, "port", **kw), device="cpu", fault=fault))


def events(run_dir):
    return [e for e in read_journal(os.path.join(run_dir, "journal.jsonl"))
            if e["event"] not in CLOCKED]


def _solo_nu(res):
    m = pt.Navier2D(17, 17, 1e4, 1.0, res["dt"], 1.0, "rbc", device="cpu")
    m.init_random(res.get("amp") or 0.1, seed=res["seed"])
    m.update_n(res["steps"])
    return float(m.eval_nu())


def same_results(jax_srv, port_srv, id_pairs):
    """Each request's lifecycle state, and its result or typed failure,
    alike in both servers."""
    for jid, pid in id_pairs:
        js, ps = jax_srv.status(jid), port_srv.status(pid)
        assert js["state"] == ps["state"]
        if js["state"] == "failed":
            with pytest.raises(RequestFailed) as exc:
                port_srv.result(pid)
            assert exc.value.dt_trajectory == js["error"].get("dts")
            assert ps["error"]["reason"] == js["error"]["reason"]
            continue
        a, b = port_srv.result(pid), jax_srv.result(jid)
        assert {k for k in a} == {k for k in b}
        for key in ("steps", "dt", "slot", "retries", "seed", "amp", "model", "tenant",
                    "priority", "deadline_s"):
            assert a[key] == b[key], key
        for name, v in b.items():
            if key_is_observable(name):
                assert abs(a[name] - v) <= OBS_REL * max(abs(v), 1e-300), (name, a[name], v)


def key_is_observable(name):
    return name not in ("steps", "dt", "slot", "retries", "seed", "amp", "model", "tenant",
                        "priority", "deadline_s", "latency_s",
                        "admission_to_first_observable_s")


def same_journals(jax_srv, port_srv):
    a = [e["event"] for e in events(port_srv.cfg.run_dir)]
    b = [e["event"] for e in events(jax_srv.cfg.run_dir)]
    assert a == b
    return a


def same_summaries(sj, sp):
    for key in ("outcome", "completed", "failed", "retried", "replans", "bucket_dt_adjusts",
                "member_steps", "queue"):
        assert sp[key] == sj[key], key


def serve_both(tmp_path, reqs, fault=None, **kw):
    jax_srv, port_srv = _servers(tmp_path, fault=fault, **kw)
    pairs = [(jax_srv.submit(r).id, port_srv.submit(r).id) for r in reqs]
    sj, sp = jax_srv.serve(), port_srv.serve()
    same_summaries(sj, sp)
    same_results(jax_srv, port_srv, pairs)
    names = same_journals(jax_srv, port_srv)
    return jax_srv, port_srv, pairs, sp, names


# -- batching, isolation, retries ------------------------------------------------------------------


CASES = {
    # 5 requests through 2 lanes: refills mid-campaign
    "batch": (dict(slots=2), None, [dict(_REQ, seed=s) for s in range(5)]),
    # a co-batched member diverges (an absurd amplitude): isolated, retried
    # once, failed typed; its neighbours match their solo runs
    "divergent": (dict(slots=3, request_max_retries=1), None,
                  [dict(_REQ, seed=0), dict(_REQ, seed=1), dict(_REQ, seed=7, amp=1e12)]),
    # nan@6 poisons the running batch: every in-flight request retries at dt/2
    "nan_fault": (dict(slots=2), "nan@6", [dict(_REQ, seed=s) for s in range(3)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_serving_as_jax(tmp_path, case):
    kw, fault, reqs = CASES[case]
    jax_srv, port_srv, pairs, summary, names = serve_both(tmp_path, reqs, fault=fault, **kw)
    results = [port_srv.status(p) for _, p in pairs]
    if case == "batch":
        assert summary["completed"] == 5 and names.count("request_scheduled") == 5
        assert {r["result"]["slot"] for r in results} == {0, 1}
    elif case == "divergent":
        assert summary["completed"] == 2 and summary["failed"] == 1
        with pytest.raises(RequestFailed) as exc:
            port_srv.result(pairs[2][1])
        assert exc.value.dt_trajectory == [0.01, 0.005]
        assert "request_failed" in names
    else:
        assert summary["retried"] == 2
        assert sorted(port_srv.result(p)["dt"] for _, p in pairs) == [0.005, 0.005, 0.01]
    for _, pid in pairs[:2]:
        res = port_srv.result(pid)
        assert res["nu"] == pytest.approx(_solo_nu(res), rel=1e-9)


def test_sigterm_drain_restart_resumes_as_jax(tmp_path):
    """``kill@8`` fires a real SIGTERM mid-campaign: both servers drain
    (the slot table rides the sharded checkpoint), a second server on each
    run directory restores the drained requests mid-trajectory, and the
    two packages agree row for row and result for result."""
    reqs = [dict(_REQ, seed=s, horizon=0.2) for s in range(3)]
    jax_srv, port_srv = _servers(tmp_path, fault="kill@8", slots=2)
    pairs = [(jax_srv.submit(r).id, port_srv.submit(r).id) for r in reqs]
    same_summaries(jax_srv.serve(), port_srv.serve())
    assert port_srv.queue.counts() == jax_srv.queue.counts()
    jax2, port2 = _servers(tmp_path, slots=2)
    same_summaries(jax2.serve(), port2.serve())
    same_results(jax2, port2, pairs)
    names = same_journals(jax2, port2)
    assert names.count("drain") == 1
    evs = events(port2.cfg.run_dir)
    restored = [e for e in evs if e["event"] == "request_scheduled" and e.get("restored")]
    requeued = [e for e in evs if e["event"] == "request_requeued"]
    assert restored and all(e["steps_done"] > 0 for e in restored)
    assert {e["id"] for e in restored} == {e["id"] for e in requeued}
    assert all(e["checkpoint"] for e in requeued)
    for _, pid in pairs:
        res = port2.result(pid)
        assert res["steps"] == 20 and res["nu"] == pytest.approx(_solo_nu(res), rel=1e-9)


def test_drain_restart_on_npz_checkpoints(tmp_path, monkeypatch):
    """Where ``h5py`` does not import (the card's machine) the campaign
    checkpoints are ``.npz`` files: the same ``kill@8`` drain and restart
    gives the results, bit for bit, and the journal that it gives through
    HDF5 files."""
    from rustpde_mpi_tpu_torch.utils import checkpoint

    reqs = [dict(_REQ, seed=s, horizon=0.2) for s in range(3)]
    runs = {}
    for fmt in ("h5", "npz"):
        if fmt == "npz":
            monkeypatch.setattr(checkpoint, "_have_h5py", lambda: False)
        cfg = _cfg(ServeConfig, tmp_path, fmt, slots=2)
        first = SimServer(cfg, device="cpu", fault="kill@8")
        ids = [first.submit(r).id for r in reqs]
        assert first.serve()["outcome"] == "drained"
        files = sorted(f for _, _, fs in os.walk(cfg.run_dir) for f in fs
                       if f.startswith("ckpt_"))
        assert files and all(f.endswith(".npz") == (fmt == "npz") for f in files)
        second = SimServer(cfg, device="cpu")
        assert second.serve()["completed"] == 3
        results = [{k: v for k, v in second.result(i).items() if not k.endswith("_s")}
                   for i in ids]
        runs[fmt] = results, [e["event"] for e in events(cfg.run_dir)]
    assert runs["npz"] == runs["h5"]


@pytest.mark.parametrize("old,new,n", [(2, 3, 4), (3, 2, 3)], ids=["grow", "shrink"])
def test_drain_restart_replans_as_jax(tmp_path, old, new, n):
    """A restart at another slot count restores at the checkpoint's count,
    then re-plans: kept requests move lanes mid-trajectory, a surplus one
    is parked and continues mid-flight (shrink), grown lanes refill."""
    reqs = [dict(_REQ, seed=s, horizon=0.2) for s in range(n)]
    jax_srv, port_srv = _servers(tmp_path, fault="kill@8", slots=old)
    pairs = [(jax_srv.submit(r).id, port_srv.submit(r).id) for r in reqs]
    same_summaries(jax_srv.serve(), port_srv.serve())
    jax2, port2 = _servers(tmp_path, slots=new)
    sj, sp = jax2.serve(), port2.serve()
    same_summaries(sj, sp)
    assert sp["replans"] == 1 and sp["completed"] == n
    same_results(jax2, port2, pairs)
    same_journals(jax2, port2)
    evs = events(port2.cfg.run_dir)
    (replan,) = [e for e in evs if e["event"] == "campaign_replanned"]
    assert (replan["old_slots"], replan["new_slots"], replan["kept"], replan["parked"]) == \
        (old, new, min(old, new), max(0, old - new))
    if old > new:
        parked = [e for e in evs if e["event"] == "request_scheduled" and e.get("parked")]
        assert len(parked) == 1 and parked[0]["base"] > 0


# -- the HTTP front --------------------------------------------------------------------------------


def _http(base, path, payload=None, raw=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data, method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            body, code, headers = resp.read(), resp.status, dict(resp.headers)
    except urllib.error.HTTPError as err:
        body, code, headers = err.read(), err.code, dict(err.headers)
    ctype = headers.get("Content-Type", "")
    return code, (json.loads(body) if ctype == "application/json" else body.decode()), \
        headers.get("Retry-After"), ctype


def front_script(server_cls, front_cls, front_mod, cfg_cls, tmp_path, name, **srv_kw):
    """One exchange with a server's HTTP front (no campaign runs):
    admission, malformed bodies, the bounded queue's 429 with Retry-After,
    status and trace reads, stats, health, metrics, drain and the 429
    while draining.  Returns the normalized replies."""
    front_mod.seed_retry_jitter(11)
    srv = server_cls(_cfg(cfg_cls, tmp_path, name, max_queue=3), **srv_kw)
    front = front_cls(srv)
    front.start()
    out, ids = [], []
    try:
        host, port = front.address
        base = f"http://{host}:{port}"

        def post(payload=None, raw=None, path="/requests"):
            code, body, retry, ctype = _http(base, path, payload, raw)
            if isinstance(body, dict) and "id" in body:
                ids.append(body["id"])
                body = {k: v for k, v in body.items() if k not in ("id", "trace_id")}
            return code, body, retry

        code, health, _, _ = _http(base, "/healthz")
        out.append((code, health_sans_devices(health)))
        out.append(post(dict(_REQ, seed=0)))
        out.append(post(dict(_REQ, dt=-1.0)))
        out.append(post(raw=b"not a dict"))
        out.append(post(raw=b'"a string"'))
        out.append(post(dict(_REQ, bogus=1)))
        out.append(post(dict(_REQ, model="nope")))
        for seed in range(1, 5):
            out.append(post(dict(_REQ, seed=seed)))
        code, status, _, _ = _http(base, f"/requests/{ids[0]}")
        out.append((code, status["state"], sorted(status)))
        out.append(_http(base, "/requests/unknown-id")[:2])
        out.append(_http(base, "/requests/unknown-id/trace")[:2])
        code, trace, _, _ = _http(base, f"/requests/{ids[0]}/trace")
        out.append((code, sorted(trace)))
        out.append(_http(base, "/nope")[:2])
        out.append(post(dict(_REQ), path="/nope"))
        code, stats, _, _ = _http(base, "/stats")
        out.append((code, sorted(stats), stats["queue"], health_sans_devices(stats)["slots"],
                    stats["draining"]))
        code, text, _, ctype = _http(base, "/metrics")
        out.append((code, ctype, "serve_requests_admitted_total" in text))
        out.append(post({}, path="/drain"))
        out.append(post(dict(_REQ, seed=99)))
        code, health, _, _ = _http(base, "/healthz")
        out.append((code, health_sans_devices(health)))
    finally:
        front.stop()
    return out


def health_sans_devices(payload):
    """``payload`` without its slots' device count: the port counts one card
    a process, the JAX package its devices (the conftest's 8 virtual CPU
    devices)."""
    slots = dict(payload["slots"])
    assert slots.pop("devices") >= slots["process_count"]
    return dict(payload, slots=slots)


def test_http_front_as_jax(tmp_path):
    port = front_script(SimServer, HttpFront, http_front, ServeConfig, tmp_path, "port",
                        device="cpu")
    jax_side = front_script(JaxServer, JaxFront, jax_front, JaxServeConfig, tmp_path, "jax")
    assert port == jax_side
    codes = [o[0] for o in port]
    assert codes[1] == 202 and codes[2:7] == [400, 400, 400, 400, 400]
    assert 429 in codes[7:11] and port[-2][0] == 429 and port[-2][1]["reason"] == "draining"


def raw_frames(front):
    host, port = front.address

    def raw(request: bytes) -> str:
        with socket.create_connection((host, port), timeout=30) as sock:
            sock.sendall(request)
            sock.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                data = sock.recv(65536)
                if not data:
                    break
                chunks.append(data)
        text = b"".join(chunks).decode("utf-8", "replace")
        head, _, body = text.partition("\r\n\r\n")
        return head.splitlines()[0], body

    def post_head(extra: str, body: bytes = b""):
        return raw((f"POST /requests HTTP/1.1\r\nHost: {host}\r\nConnection: close\r\n"
                    f"{extra}\r\n").encode() + body)

    return [post_head("Content-Length: nope\r\n"), post_head("Content-Length: -5\r\n"),
            post_head(f"Content-Length: {(1 << 20) + 1}\r\n"),
            post_head("Content-Length: 100\r\n", b'{"ra": 1e4, ')]


def test_http_front_error_paths_as_jax(tmp_path):
    """Broken frames map to the same typed statuses and bodies: a bad or
    negative Content-Length 400, an oversized body 413 (before any read),
    a truncated body 400; nothing is admitted."""
    replies = []
    for srv, cls in ((SimServer(_cfg(ServeConfig, tmp_path, "port"), device="cpu"), HttpFront),
                     (JaxServer(_cfg(JaxServeConfig, tmp_path, "jax")), JaxFront)):
        front = cls(srv)
        front.start()
        try:
            replies.append(raw_frames(front))
        finally:
            front.stop()
        assert srv.queue.counts()["queued"] == 0
    port, jax_side = replies
    assert [(p[0].split()[1], p[1]) for p in port] == [(j[0].split()[1], j[1]) for j in jax_side]
    assert [p[0].split()[1] for p in port] == ["400", "400", "413", "400"]


def test_profile_endpoint_single_flight_capped_and_harmless(tmp_path, monkeypatch):
    """``POST /profile`` starts one capture at a time (409 while one runs),
    caps its seconds at ``profile_max_s``, refuses bad arguments (400), and
    a capture running while the server serves leaves the results bit for
    bit unchanged."""
    started = []
    capture = compile_log.ProfilerCapture(start_fn=lambda d: started.append(d),
                                          stop_fn=lambda: None)
    monkeypatch.setattr(compile_log, "CAPTURE", capture)
    cfg = _cfg(ServeConfig, tmp_path, "prof", idle_exit=False, poll_s=0.02, http_port=0,
               profile_max_s=0.3)
    srv = SimServer(cfg, device="cpu")
    ids = [srv.submit(dict(_REQ, seed=s)).id for s in range(3)]
    done = {}
    thread = threading.Thread(target=lambda: done.update(srv.serve()))
    thread.start()
    try:
        for _ in range(200):
            if srv.http_address is not None:
                break
            time.sleep(0.02)
        base = "http://%s:%d" % srv.http_address
        code, first, _, _ = _http(base, "/profile?seconds=30", {})
        code2, second, _, _ = _http(base, "/profile?seconds=1", {})
        code3, bad, _, _ = _http(base, "/profile?seconds=abc", {})
        code4, neg, _, _ = _http(base, "/profile?seconds=-1", {})
        assert (code, first["started"], first["seconds"]) == (202, True, 0.3)
        assert (code2, second["error"]) == (409, "capture already running")
        assert code3 == 400 and code4 == 400
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            srv.queue.invalidate()
            if srv.queue.counts()["done"] == 3:
                break
            time.sleep(0.02)
    finally:
        srv.request_drain()
        thread.join(timeout=120)
    assert not thread.is_alive() and started == [os.path.join(cfg.run_dir, "profiles", "manual")]
    plain = SimServer(_cfg(ServeConfig, tmp_path, "plain"), device="cpu")
    pids = [plain.submit(dict(_REQ, seed=s)).id for s in range(3)]
    plain.serve()
    drop = ("latency_s", "admission_to_first_observable_s")
    for a, b in zip(ids, pids):
        ra, rb = srv.result(a), plain.result(b)
        assert {k: v for k, v in ra.items() if k not in drop} == \
            {k: v for k, v in rb.items() if k not in drop}
    rows = [e for e in read_journal(os.path.join(cfg.run_dir, "journal.jsonl"))
            if e["event"] == "profile_capture"]
    assert [r["started"] for r in rows[:2]] == [True, False]


def test_server_takes_device_route_and_fault_as_arguments(tmp_path):
    from rustpde_mpi_tpu_torch.utils.faults import FaultSpecError

    with pytest.raises(FaultSpecError):
        SimServer(_cfg(ServeConfig, tmp_path, "a"), device="cpu", fault="boom@3")
    with pytest.raises(ValueError, match="route"):
        SimServer(_cfg(ServeConfig, tmp_path, "b"), device="cpu", route="fast")
    srv = SimServer(_cfg(ServeConfig, tmp_path, "c", preempt_notice_s=2.0), device="cpu",
                    route="dense", fault="nan@4")
    assert (str(srv.device), srv.route, srv._fault.kind, srv._notice_s) == ("cpu", "dense",
                                                                            "nan", 2.0)
    key = pt.SimRequest(**_REQ).compat_key
    assert srv._model_kw(key) == {"device": srv.device, "step_kernel": "dense",
                                  "conv_kernel": "dense"}
    assert "step_kernel" not in srv._model_kw(("lnse",) + key[1:])
    rid = srv.submit(dict(_REQ, seed=0)).id
    assert srv.serve()["completed"] == 1
    res = srv.result(rid)  # the nan@4 fault retried it once at dt/2
    assert (res["retries"], res["steps"], res["dt"]) == (1, 20, 0.005)
    assert res["nu"] == pytest.approx(_solo_nu(res), rel=1e-9)


# -- the served ensemble's checkpoint ----------------------------------------------------------------


def test_slot_table_rides_the_manifest_across_packages(tmp_path):
    """The served ensemble's slot table is manifest root data: a port
    checkpoint restores into the JAX package's served ensemble with the
    same slot table and states, and back; both packages write the same
    ``serve_slots`` bytes and, for the same member states, the same
    manifest digest."""
    import numpy as np

    from rustpde_mpi_tpu import Navier2D as JaxNavier
    from rustpde_mpi_tpu.serve.scheduler import _ServedEnsemble as JaxServed
    from rustpde_mpi_tpu.utils import checkpoint as jck

    from rustpde_mpi_tpu_torch.serve.scheduler import _ServedEnsemble
    from rustpde_mpi_tpu_torch.utils import checkpoint as tck

    meta = [{"id": "a", "target": 20, "base": 3, "time_base": 0.03,
             "req": {"ra": 1e4, "horizon": 0.2}}, None, {"id": "c", "target": 10, "base": 0,
                                                         "time_base": 0.0, "req": {}}]
    model = pt.Navier2D(17, 17, 1e4, 1.0, 0.01, 1.0, "rbc", device="cpu")
    jmodel = JaxNavier(17, 17, 1e4, 1.0, 0.01, 1.0, "rbc", False)
    rng = np.random.default_rng(5)
    members = []
    for _ in range(3):
        arrays = {name: rng.standard_normal(space.shape_spectral)
                  for name, space in model._state_fields()}
        members.append(arrays)
    states, jstates = [], []
    for m in members:
        pt.convert.state_from_numpy(model, m)
        states.append(model.state)
        with jmodel._scope():
            jmodel.state = jmodel.state._replace(**{k: jnp.asarray(v) for k, v in m.items()})
        jstates.append(jmodel.state)
    ens = _ServedEnsemble(model, states)
    jens = JaxServed(jmodel, jstates)
    for e in (ens, jens):
        e.serve_meta = list(meta)
        e.mark_dead([1])
        e.time = 0.5
    tpath = tck.checkpoint_path(str(tmp_path / "t"), 6)
    jpath = jck.checkpoint_path(str(tmp_path / "j"), 6)
    tck.write_sharded_snapshot(ens, tpath, step=6)
    jck.write_sharded_snapshot(jens, jpath, step=6)
    assert bytes(tck.read_root_data(tpath)["serve_slots"]) == \
        bytes(jck.read_root_data(jpath)["serve_slots"])
    assert tck.read_attrs(tpath)["digest"] == tck.read_attrs(jpath)["digest"]
    back = JaxServed(jmodel, [jmodel.state] * 3)
    back.read(tpath)
    assert back.restored_meta == meta and list(back.alive()) == [True, False, True]
    port_back = _ServedEnsemble(model, [model.state] * 3)
    port_back.read(jpath)
    assert port_back.restored_meta == port_back.serve_meta == meta
    for name in ens.state._fields:
        np.testing.assert_array_equal(getattr(port_back.state, name).numpy(),
                                      np.asarray(getattr(jens.state, name)))


# -- two processes -------------------------------------------------------------------------------


#: a served result's observables against a one-process solo run on a mesh
#: of the campaign's rank count, where the K-member batching rounds apart
#: from the solo run's (the CPU measured none: bit for bit)
SOLO_REL = 1e-12
OBSERVABLES = ("nu", "nuvol", "re", "div")


def mesh_solo(req, res, nranks):
    """A served request rerun alone on ``make_mesh(nranks, "cpu")`` from its
    initial condition for its steps at its dt: its observables by name."""
    model = pt.Navier2D(req["nx"], req["ny"], req["ra"], req["pr"], res["dt"], 1.0, req["bc"],
                        device="cpu", mesh=pt.make_mesh(nranks, "cpu"))
    model.init_random(res["amp"] or 0.1, seed=res["seed"])
    model.update_n(res["steps"])
    return dict(zip(model.observable_names, model.get_observables()))


def same_as_mesh_solo(got, req, nranks):
    """Each observable of a served result equals its solo run's on a
    one-process mesh of the same rank count, bit for bit, or within
    ``SOLO_REL`` of its scale; returns whether every one was bit for bit."""
    want = mesh_solo(req, got, nranks)
    exact = True
    for name in OBSERVABLES:
        exact &= got[name] == want[name]
        assert abs(got[name] - want[name]) <= SOLO_REL * max(abs(want[name]), 1e-300), \
            (name, got[name], want[name])
    return exact


@pytest.mark.parametrize("mode", ["serve_campaign", "gang_serve"])
def test_two_process_serving_equals_one_process(tmp_path, mode):
    """Two processes on gloo serve together (``tests/torch_mp_worker.py``,
    a deadline of 90 s): the root plans every boundary and broadcasts it,
    and every campaign runs on a mesh spanning both processes, its members
    split over them (single level: the whole-fleet mesh of both processes'
    rank slots; the gang mode: the gang on its 2-slot sub-mesh, the
    unstamped 18^2 grid on the whole-fleet mesh, which the remainder does
    not divide).  Each done record equals a one-process server's on the
    same requests but for its observables, which equal a solo run of the
    request on a one-process mesh of the campaign's rank count."""
    import torch_mp_worker as mpw

    outs = mpw.spawn(str(tmp_path / "mp"), mode, timeout=90.0)
    for rc, out, err, res in outs:
        assert rc == 0 and res is not None, err[-3000:]
    root = outs[0][3]
    assert root["outcome"] == outs[1][3]["outcome"] == "idle" and root["processes"] == 2
    assert outs[1][3]["meshes"] == root["meshes"]
    meshes = {(nx, ny): (p, spanning) for nx, ny, p, spanning in root["meshes"]}
    fleet = 2 * RANK_SLOTS
    if mode == "serve_campaign":
        reqs = [dict(mpw.SERVE_REQ, horizon=0.08 + (s % 3) * 0.02, seed=s) for s in range(5)]
        kw = {}
        assert meshes == {(17, 17): (fleet, True)}
    else:
        reqs = [dict(mpw.SERVE_REQ, nx=34, ny=34, horizon=0.08, seed=100)] + \
            [dict(mpw.SERVE_REQ, nx=18, ny=18, horizon=0.06, seed=s) for s in range(2)]
        kw = dict(submesh=pt.config.SubmeshConfig(shapes=(2,), shard_min_nx=34))
        assert "gang_formed" in root["events"]
        assert meshes == {(34, 34): (2, True), (18, 18): (fleet, True)}
    one = SimServer(_cfg(ServeConfig, tmp_path, "one", **kw), device="cpu")
    ids = [one.submit(r).id for r in reqs]
    assert one.serve()["completed"] == root["completed"] == len(reqs)
    drop = ("latency_s", "admission_to_first_observable_s") + OBSERVABLES
    for rid, req, got in zip(ids, reqs, root["results"]):
        want = one.result(rid)
        assert {k: v for k, v in got.items() if k not in drop} == \
            {k: v for k, v in want.items() if k not in drop}
        assert same_as_mesh_solo(got, req, meshes[(req["nx"], req["ny"])][0])


@pytest.fixture(scope="module")
def gang_park(tmp_path_factory):
    """One spawn of ``tests/torch_mp_worker.py``'s ``gang_park`` mode (a
    deadline of 45 s): the root's record and its output directory."""
    import torch_mp_worker as mpw

    out_dir = str(tmp_path_factory.mktemp("gang_park"))
    outs = mpw.spawn(out_dir, "gang_park", timeout=45.0)
    for rc, out, err, res in outs:
        assert rc == 0 and res is not None, err[-3000:]
    return outs[0][3], outs[1][3], out_dir


def test_spanning_gang_parks_and_resumes(gang_park):
    """A gang on a 2-slot sub-mesh spanning both processes, drained under a
    fleet replica's preemption notice, parks its lane through the
    continuation writer (``gang_parked``); the restarted replica resumes it
    from the park, and its result equals the un-drained run (a solo run on
    ``make_mesh(2)``) bit for bit, as the co-served 18^2 request equals its
    own on the whole-fleet mesh.  A plain server's drained gang, restarted
    on a carve of 4-slot sub-meshes and 3 slots, is re-placed onto a slice
    of another shape (``gang_replanned``: its checkpoint restored onto 4
    ranks) and re-planned onto 3 lanes (``campaign_replanned``), and ends
    within ``SOLO_REL`` of the un-drained run.  A member moved between
    spanning meshes of 2 and 16 ranks keeps its global state bit for bit."""
    import torch_mp_worker as mpw

    root, other, _ = gang_park
    for part, outcome in (("drain", "drained"), ("resume", "idle"), ("drain_plain", "drained"),
                          ("replan", "idle")):
        assert root[part]["outcome"] == other[part]["outcome"] == outcome, part
    drain = root["drain"]["events"]
    assert {"gang_formed", "preempt_notice", "gang_parked", "continuation_persisted"} <= set(drain)
    assert root["drain"]["results"] == [None, None]
    resumed = root["resume"]["events"][len(drain):]
    assert "continuation_resumed" in resumed and resumed.count("request_done") == 2
    gang, small = root["resume"]["results"]
    assert same_as_mesh_solo(gang, dict(mpw.GANG_REQ, seed=100), 2)
    assert same_as_mesh_solo(small, dict(mpw.SERVE_REQ, nx=18, ny=18, seed=1), 2 * RANK_SLOTS)
    replanned = root["replan"]["events"][len(root["drain_plain"]["events"]):]
    assert {"gang_replanned", "resumed", "campaign_replanned", "request_done"} <= set(replanned)
    same_as_mesh_solo(root["replan"]["results"][0], dict(mpw.GANG_REQ, seed=101), 2)
    assert other["moved_bit_for_bit"]


def test_spanning_continuation_shards_join_to_the_member_state(gang_park):
    """The parked gang's continuation holds one shard a process, each its
    ranks' columns of the member's global state with the pad sliced away:
    joined in process order they are that state, bit for bit.  Read on
    another topology (one process, whose shard would be the whole state)
    it raises ``CheckpointError``, as the JAX reader does, so the scheduler
    restarts the request fresh."""
    import h5py

    from rustpde_mpi_tpu_torch.models.navier import NavierState
    from rustpde_mpi_tpu_torch.utils import checkpoint

    _, _, out_dir = gang_park
    park = os.path.join(out_dir, "park")
    with open(os.path.join(park, checkpoint.CONTINUATION_MANIFEST), encoding="utf-8") as fh:
        record = json.load(fh)
    assert len(record["shards"]) == 2
    want = np.load(os.path.join(out_dir, "park_global.npz"))
    shards = [h5py.File(os.path.join(park, s["file"]), "r") for s in record["shards"]]
    try:
        for name in record["fields"]:
            parts = [np.asarray(h5["state"][name]) for h5 in shards]
            assert all(0 < p.shape[-1] < want[name].shape[-1] for p in parts), name
            np.testing.assert_array_equal(np.concatenate(parts, axis=-1), want[name],
                                          err_msg=name)
    finally:
        for h5 in shards:
            h5.close()
    whole = NavierState(**{name: want[name] for name in record["fields"]})
    with pytest.raises(checkpoint.CheckpointError, match="continuation"):
        checkpoint.read_continuation(park, whole)


def test_spanning_gang_member_lost_within_the_deadline(tmp_path):
    """Gang member 1 SIGKILLed mid-campaign (``kill@6:gang0member1``) on a
    sub-mesh spanning both processes: the survivor's serve ends in the typed
    gang loss (a ``gang_member_lost`` row; the request requeued with its
    progress, under its gang) within the deadline plus 5 s of the kill, not
    in a hang: on the CPU the survivor's next gloo exchange fails as the
    peer's connection closes (a card that waits in a remote flip instead is
    bounded by the dispatch watchdog, ``tests/test_torch_cuda.py``'s
    ``test_spanning_gang_loss_on_the_card_within_the_deadline``).  One
    spawn, a deadline of 45 s."""
    import torch_mp_worker as mpw

    outs = mpw.spawn(str(tmp_path / "mp"), "gang_kill", timeout=45.0)
    (rc0, _, err0, res), (rc1, _, _, _) = outs
    assert rc1 == -9 and rc0 == 0 and res is not None, err0[-3000:]
    assert res["error"] is not None
    with open(tmp_path / "mp" / "killed_at", encoding="utf-8") as fh:
        killed = float(fh.read())
    assert 0.0 <= res["ended_at"] - killed <= mpw.GANG_DEADLINE_S + 5.0
    rows = {e["event"]: e for e in res["events"]}
    assert rows["gang_member_lost"]["gang"] == rows["gang_formed"]["gang"] == 0
    requeued = rows["request_requeued"]
    assert requeued["id"] == res["ids"][0] and requeued["gang"] == 0 and "progress" in requeued
    assert res["queue"]["queued"] == 1 and res["queue"]["running"] == 0


def test_flip_deadline_releases_the_waits_and_raises_gang_lost(tmp_path, monkeypatch):
    """A gang's served chunk past the dispatch watchdog's deadline
    (``ResilienceConfig.dispatch_timeout_s``; a ``slow`` fault stalls it)
    first lets the waits of its mesh's remote flips pass
    (``resilience._release_remote_waits``: on a mesh spanning processes
    ``SpanningRing.release_waits``, elsewhere nothing), then ends in the
    typed gang loss before the boundary: no request completes and no
    continuation is persisted, so nothing the released chunk computed is
    used.  The gang deadline stays the barrier's (``gang_sync_timeout_s``,
    which this serve's boundaries outlast without tripping it)."""
    import torch_mp_worker as mpw

    from rustpde_mpi_tpu_torch.config import ResilienceConfig, SubmeshConfig
    from rustpde_mpi_tpu_torch.utils import resilience
    from rustpde_mpi_tpu_torch.utils.resilience import DispatchHang

    released = []

    class Ring:
        def release_waits(self):
            released.append(True)

    class Spanning:
        spanning, ring = True, Ring()

    class Model:
        def __init__(self, mesh):
            self.mesh = mesh

    for pde in (Model(None), Model(pt.make_mesh(2, "cpu")), object()):
        resilience._release_remote_waits(pde)
    assert not released
    resilience._release_remote_waits(Model(Spanning()))
    assert released == [True]

    hooked = []
    release = resilience._release_remote_waits
    monkeypatch.setattr(resilience, "_release_remote_waits",
                        lambda pde: (hooked.append(pde), release(pde)))
    srv = SimServer(_cfg(ServeConfig, tmp_path, "hang",
                         submesh=SubmeshConfig(shapes=(2,), shard_min_nx=34),
                         resilience=ResilienceConfig(dispatch_timeout_s=5.0),
                         gang_sync_timeout_s=0.05),
                    device="cpu", fault="slow@6")
    rid = srv.submit(dict(mpw.GANG_REQ, horizon=0.16, seed=100)).id
    with pytest.raises(DispatchHang):
        srv.serve()
    assert len(hooked) == 1
    events = [e["event"] for e in read_journal(srv.journal_path)]
    assert {"gang_formed", "fault_injected", "gang_member_lost", "request_requeued"} <= set(events)
    assert "request_done" not in events and "continuation_persisted" not in events
    assert srv.result(rid) is None
    assert srv.queue.counts()["queued"] == 1 and srv.queue.counts()["done"] == 0

"""The port's ``SimServer`` against the JAX package's on its scheduling
policies, on the CPU at 17^2 (the same requests and faults through both;
results to 1e-11 of each observable's scale, journal event types in the
same order, the wall-clock rows left out): the governed per-bucket dt
re-bucket and the governed run's bit identity at a stable dt, a mixed
DNS and lnse campaign, the passive scalar's Sherwood number, bucket
fairness, one trace id across a drain, a restart and a re-bucket, and
the compile attribution rows."""

import gc
import glob
import math
import os

import pytest

from rustpde_mpi_tpu.config import ServeConfig as JaxServeConfig
from rustpde_mpi_tpu.config import StabilityConfig as JaxStability
from rustpde_mpi_tpu.serve import SimServer as JaxServer

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.config import ServeConfig, StabilityConfig
from rustpde_mpi_tpu_torch.serve import RequestError, SimServer
from rustpde_mpi_tpu_torch.utils.journal import read_journal

_REQ = dict(ra=1e4, pr=1.0, nx=17, ny=17, dt=0.01, horizon=0.1, bc="rbc")
CLOCKED = ("perf_degraded", "profile_capture")
OBS_REL = 1e-11
SKIP = ("latency_s", "admission_to_first_observable_s")
#: the spike fault's velocity factor on both sides (the JAX package reads
#: it from the environment, the port's runner takes it as an argument)
SPIKE = 500.0


@pytest.fixture(autouse=True)
def _collect():
    yield
    gc.collect()


class SpikedServer(SimServer):
    """The port's server with its campaign runners' spike factor set, as
    the JAX package's environment sets its runners'."""

    def _build_runner(self, key, k=None):
        runner, ens = super()._build_runner(key, k)
        runner.spike_factor = SPIKE
        return runner, ens


def _cfg(cls, tmp_path, name, **kw):
    kw.setdefault("run_dir", str(tmp_path / name))
    kw.setdefault("slots", 2)
    kw.setdefault("chunk_steps", 4)
    kw.setdefault("checkpoint_every_s", None)
    kw.setdefault("http_port", None)
    return cls(**kw)


def events(run_dir):
    return [e for e in read_journal(os.path.join(run_dir, "journal.jsonl"))
            if e["event"] not in CLOCKED]


def servers(tmp_path, fault=None, governed=None, tag="", **kw):
    jkw, pkw = dict(kw), dict(kw)
    if governed is not None:
        jkw["stability"], pkw["stability"] = JaxStability(**governed), StabilityConfig(**governed)
    return (JaxServer(_cfg(JaxServeConfig, tmp_path, "jax" + tag, **jkw), fault=fault),
            SpikedServer(_cfg(ServeConfig, tmp_path, "port" + tag, **pkw), device="cpu",
                         fault=fault))


def compare(jax_srv, port_srv, pairs, sj, sp):
    for key in ("outcome", "completed", "failed", "retried", "bucket_dt_adjusts",
                "member_steps", "queue"):
        assert sp[key] == sj[key], key
    for jid, pid in pairs:
        a, b = port_srv.result(pid), jax_srv.result(jid)
        assert set(a) == set(b)
        for name, v in b.items():
            if name in SKIP:
                continue
            if isinstance(v, float) and name not in ("dt", "amp", "deadline_s"):
                assert abs(a[name] - v) <= OBS_REL * max(abs(v), 1e-300), (name, a[name], v)
            else:
                assert a[name] == v, name
    names = [e["event"] for e in events(port_srv.cfg.run_dir)]
    assert names == [e["event"] for e in events(jax_srv.cfg.run_dir)]
    return names


def serve_both(tmp_path, reqs, fault=None, governed=None, tag="", **kw):
    jax_srv, port_srv = servers(tmp_path, fault, governed, tag, **kw)
    pairs = [(jax_srv.submit(r).id, port_srv.submit(r).id) for r in reqs]
    sj, sp = jax_srv.serve(), port_srv.serve()
    return jax_srv, port_srv, pairs, sp, compare(jax_srv, port_srv, pairs, sj, sp)


def test_governed_bucket_dt_rebucket_as_jax(tmp_path, monkeypatch):
    """A velocity spike trips the CFL sentinels while every member is
    finite: the pinned requests re-bucket down the per-bucket ladder with
    their state (``bucket_dt_adjust``), no reactive retry."""
    monkeypatch.setenv("RUSTPDE_SPIKE_FACTOR", str(SPIKE))
    _, port_srv, pairs, sp, names = serve_both(
        tmp_path, [dict(_REQ, seed=s) for s in range(2)], fault="spike@6",
        governed=dict(ladder_ratio=4.0))
    assert sp["completed"] == 2 and sp["retried"] == 0 and sp["bucket_dt_adjusts"] >= 2
    assert "bucket_dt_adjust" in names and "request_retry" not in names
    evs = events(port_srv.cfg.run_dir)
    adjusts = [e for e in evs if e["event"] == "bucket_dt_adjust"]
    assert all(e["dt"] < e["prev_dt"] and e["rung"] < 0 for e in adjusts)
    sched = [e for e in evs if e["event"] == "request_scheduled" and e.get("parked")]
    assert len(sched) >= 2 and all(e["base"] > 0 for e in sched)
    for _, pid in pairs:
        res = port_srv.result(pid)
        assert res["dt"] < 0.01 and res["steps"] > 10 and math.isfinite(res["nu"])


def test_governed_stable_dt_bit_identical(tmp_path):
    """At a stable dt the governed campaign equals the ungoverned one bit
    for bit (and the JAX package's governed run to 1e-11)."""
    reqs = [dict(_REQ, seed=s) for s in range(3)]
    _, governed, pairs, _, _ = serve_both(tmp_path, reqs, governed={})
    plain = SimServer(_cfg(ServeConfig, tmp_path, "plain"), device="cpu")
    ids = [plain.submit(r).id for r in reqs]
    assert plain.serve()["completed"] == 3
    for (_, pid), rid in zip(pairs, ids):
        a, b = governed.result(pid), plain.result(rid)
        assert {k: v for k, v in a.items() if k not in SKIP} == \
            {k: v for k, v in b.items() if k not in SKIP}


def test_mixed_model_campaign_as_jax(tmp_path):
    """DNS and lnse requests through one server: two campaigns by the
    kind-prefixed key, each result in its model's observable names; bad
    kinds and scenarios die at admission in both packages alike."""
    reqs = [dict(_REQ, seed=s) for s in range(2)] + \
        [dict(_REQ, model="lnse", seed=s, amp=1e-3) for s in range(2)]
    jax_srv, port_srv, pairs, sp, _ = serve_both(tmp_path, reqs)
    assert sp["completed"] == 4
    assert "energy" in port_srv.result(pairs[2][1]) and "nu" not in port_srv.result(pairs[2][1])
    keys = {tuple(e["key"])[0] for e in events(port_srv.cfg.run_dir)
            if e["event"] == "campaign_start"}
    assert keys == {"dns", "lnse"}
    for bad in (dict(_REQ, model="nope"), dict(_REQ, model="lnse", scenario={"coriolis": 1.0}),
                dict(_REQ, scenario={"coriolis": "fast"}),
                dict(_REQ, scenario={"passive_scalar": True, "scalar_kappa": 0.0})):
        with pytest.raises(RequestError) as got:
            port_srv.submit(bad)
        with pytest.raises(Exception) as want:
            jax_srv.submit(bad)
        assert str(got.value) == str(want.value)
    assert port_srv.queue.counts()["queued"] == 0


def test_passive_scalar_sherwood_as_jax(tmp_path):
    _, port_srv, pairs, sp, _ = serve_both(
        tmp_path, [dict(_REQ, seed=0, scenario={"passive_scalar": True}), dict(_REQ, seed=0)])
    assert sp["completed"] == 2
    res = port_srv.result(pairs[0][1])
    assert {"nu", "nuvol", "re", "div", "sherwood"} <= set(res) and math.isfinite(res["sherwood"])
    assert "sherwood" not in port_srv.result(pairs[1][1])


def test_bucket_fairness_as_jax(tmp_path):
    """Six hot-bucket requests queued ahead of two cold-bucket ones, a claim
    quantum of 2: the cold bucket is served after one quantum of the hot
    one, in the same order in both packages."""
    hot = [dict(_REQ, seed=s) for s in range(6)]
    cold = [dict(_REQ, dt=0.005, seed=s) for s in range(2)]
    _, port_srv, pairs, sp, names = serve_both(tmp_path, hot + cold, bucket_quantum=2)
    assert sp["completed"] == 8 and "bucket_quantum" in names
    cold_ids = {p for _, p in pairs[6:]}
    hot_ids = {p for _, p in pairs[:6]}
    order = [(e["event"], e["id"]) for e in events(port_srv.cfg.run_dir)
             if e["event"] in ("request_scheduled", "request_done")]
    last_cold = max(i for i, (ev, rid) in enumerate(order)
                    if ev == "request_done" and rid in cold_ids)
    assert sum(1 for i, (ev, rid) in enumerate(order)
               if ev == "request_scheduled" and rid in hot_ids and i > last_cold) >= 2


def test_trace_context_across_drain_restart_and_rebucket_as_jax(tmp_path, monkeypatch):
    """Admission, a SIGTERM drain, the restart's re-claim and a governed
    re-bucket give one trace id on every row of both incarnations, and the
    assembled timeline spans both, as in the JAX package."""
    monkeypatch.setenv("RUSTPDE_SPIKE_FACTOR", str(SPIKE))
    governed = dict(ladder_ratio=4.0)
    jax_srv, port_srv = servers(tmp_path, "kill@8", governed)
    req = dict(_REQ, seed=0, horizon=0.2)
    jreq, preq = jax_srv.submit(req), port_srv.submit(req)
    assert jax_srv.serve()["outcome"] == port_srv.serve()["outcome"] == "drained"
    jax2, port2 = servers(tmp_path, "spike@14", governed)
    compare(jax2, port2, [(jreq.id, preq.id)], jax2.serve(), port2.serve())
    mine = [e for e in events(port2.cfg.run_dir) if e.get("id") == preq.id]
    names = [e["event"] for e in mine]
    for expected in ("request_admitted", "request_scheduled", "request_requeued",
                     "bucket_dt_adjust", "request_done"):
        assert expected in names
    assert {e["trace_id"] for e in mine if e.get("trace_id")} == {preq.trace_id}
    trace, jtrace = port2.request_trace(preq.id), jax2.request_trace(jreq.id)
    assert trace["otherData"]["incarnations"] == jtrace["otherData"]["incarnations"] == 2
    assert [e["name"] for e in trace["traceEvents"]] == [e["name"] for e in jtrace["traceEvents"]]
    assert all(e["args"]["trace_id"] == preq.trace_id for e in trace["traceEvents"])
    ts = [e["ts"] for e in trace["traceEvents"]]
    assert ts == sorted(ts) and ts[0] == 0.0
    assert len(glob.glob(os.path.join(port2.cfg.run_dir, "campaigns", "*", "trace_*.json"))) >= 2


def test_compile_attribution_rows_as_jax(tmp_path):
    """Each campaign build journals its ``compile_build`` rows (a build and
    an entry-points row, key-tagged, the campaign's K) and its first chunk
    a ``first_chunk`` row, in both packages alike."""
    reqs = [dict(_REQ, ra=1.3e4, seed=0), dict(_REQ, ra=1.3e4, dt=0.005, seed=1)]
    jax_srv, port_srv, _, sp, names = serve_both(tmp_path, reqs)
    assert sp["completed"] == 2

    def rows(srv):
        return [(e["phase"], e["key_tag"], e["k"], e["builds"], e["recompile"])
                for e in events(srv.cfg.run_dir) if e["event"] == "compile_build"]

    assert rows(port_srv) == rows(jax_srv)
    assert names.count("first_chunk") == 2 and len(rows(port_srv)) == 4
    evs = events(port_srv.cfg.run_dir)
    assert all(e["wall_s"] > 0 for e in evs if e["event"] in ("first_chunk",))
    assert all(e["first_observable_s"] > 0 for e in evs if e["event"] == "request_done")
    assert pt.SimServer is SimServer

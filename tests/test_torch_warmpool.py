"""The port's warm campaign pool and admission canonicalization against
the JAX package's: traffic profiles load, learn and save to the same rows
(the saved files byte for byte), the pool's hit/miss/eviction accounting
and journal rows follow the same operations alike, and canonicalization
snaps the same requests to the same rungs.  End to end on the CPU: a warm
hit serves exactly what a cold build serves, with no ``compile_build``
row, the warm build's chunk runner ready before the campaign opens; and a
canonicalized serve gives the JAX package's results (1e-11 of each
observable's scale)."""

import json
import os
import threading

from rustpde_mpi_tpu.config import CanonicalConfig as JaxCanonical
from rustpde_mpi_tpu.config import ServeConfig as JaxServeConfig
from rustpde_mpi_tpu.serve import SimServer as JaxServer
from rustpde_mpi_tpu.serve import warmpool as jwp

from rustpde_mpi_tpu_torch.config import CanonicalConfig, ServeConfig
from rustpde_mpi_tpu_torch.serve import SimServer
from rustpde_mpi_tpu_torch.serve import warmpool as wp
from rustpde_mpi_tpu_torch.telemetry import compile_log
from rustpde_mpi_tpu_torch.utils.journal import read_journal

_REQ = dict(ra=1e4, pr=1.0, nx=17, ny=17, dt=0.01, horizon=0.1, bc="rbc")
CLOCKED = ("perf_degraded", "profile_capture")


def _key(**kw):
    base = dict(kind="dns", nx=17, ny=17, ra=1e4, pr=1.0, dt=1e-2, aspect=1.0, bc="rbc",
                periodic=False, scen=())
    base.update(kw)
    return tuple(base.values())


class _FakeEns:
    def __init__(self, k):
        self.k = k


def _events(run_dir):
    return [r for r in read_journal(os.path.join(run_dir, "journal.jsonl"))
            if r["event"] not in CLOCKED]


# -- profiles --------------------------------------------------------------------------------------


def test_profiles_load_learn_and_save_as_jax(tmp_path):
    journal = str(tmp_path / "journal.jsonl")
    rows = ([{"event": "compile_build", "key": list(_key(nx=17)), "k": 2, "phase": "build"}] * 3
            + [{"event": "compile_build", "key": list(_key(nx=33)), "k": 4, "phase": "build"}]
            + [{"event": "compile_build", "key": list(_key(nx=65)), "phase": "aot"}] * 9
            + [{"event": "compile_build", "key": list(_key(nx=9))}]
            + [{"event": "request_done", "id": "x"}])
    with open(journal, "w") as fh:
        for row in rows:
            fh.write(json.dumps(row) + "\n")
        fh.write("{torn\n")
    for mod_max in (8, 2):
        assert wp.learn_profile(journal, mod_max) == jwp.learn_profile(journal, mod_max)
    learned = wp.learn_profile(journal)
    assert [e["key"][1] for e in learned] == [17, 33, 9] and learned[0]["k"] == 2
    assert wp.learn_profile(str(tmp_path / "missing.jsonl")) == []
    port_path, jax_path = str(tmp_path / "p" / "profile.json"), str(tmp_path / "j" / "profile.json")
    wp.save_profile(port_path, learned)
    jwp.save_profile(jax_path, learned)
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for source in (port_path, [{"key": list(_key()), "k": "4"}, {"k": 2}, {"key": []},
                               {"key": "x"}], str(tmp_path / "nope.json"), str(bad), None, []):
        assert wp.load_profile(source) == jwp.load_profile(source)
    thawed = json.loads(json.dumps(list(_key())))
    assert wp.freeze_key(thawed) == jwp.freeze_key(thawed) == _key()


# -- the pool's accounting -------------------------------------------------------------------------


def pool_script(mod):
    """The same operations on one package's ``WarmPool``: the counts after
    each and the journal rows emitted."""
    rows, out = [], []
    release = threading.Event()

    def build(key, k):
        if key[1] == 9:
            raise RuntimeError("boom")
        if key[1] == 33:
            release.wait(10)
        return object(), _FakeEns(k or 2), 3

    pool = mod.WarmPool([{"key": _key(nx=17), "k": 2}, {"key": _key(nx=9)},
                         {"key": _key(nx=33), "k": 2}], build, journal=rows.append,
                        max_entries=2)
    pool.start()
    got = {}
    taker = threading.Thread(target=lambda: got.update(e=pool.take(_key(nx=33), 2)))
    taker.start()
    taker.join(0.2)
    out.append(taker.is_alive())  # waits on the in-flight build
    release.set()
    taker.join(10)
    out.append(got["e"][1].k)
    assert pool.wait(timeout=10)
    out.append(pool.counts())
    out.append(pool.take(_key(nx=17), 4) is None)  # K mismatch: miss and eviction
    out.append(pool.take(_key(nx=65)) is None)
    pool.put(_key(nx=5), object(), _FakeEns(2))
    pool.put(_key(nx=7), object(), _FakeEns(2))
    pool.put(_key(nx=11), object(), _FakeEns(2))  # capacity: the oldest goes
    out.append(pool.take(_key(nx=5)) is None)
    out.append(pool.take(_key(nx=11))[1].k)
    out.append(pool.counts())
    pool.stop()
    stopped = mod.WarmPool([{"key": _key(nx=n)} for n in (17, 33)], build)
    stopped.stop()
    stopped.start()
    assert stopped.wait(timeout=10)
    out.append(stopped.take(_key(nx=33)) is None)
    out.append([{k: v for k, v in r.items() if k not in ("wall_s", "error")} for r in rows])
    out.append(sum("boom" in r.get("error", "") for r in rows))
    return out


def test_warm_pool_accounting_as_jax():
    port, jax_side = pool_script(wp), pool_script(jwp)
    assert port == jax_side
    assert port[0] is True and port[-1] == 1


# -- canonicalization ------------------------------------------------------------------------------


def test_canonicalization_as_jax(tmp_path):
    canon = dict(dt_anchor=1e-2, slot_sizes=(2, 8))
    port = SimServer(ServeConfig(run_dir=str(tmp_path / "p"), slots=3, http_port=None,
                                 canonicalize=CanonicalConfig(**canon)), device="cpu")
    jax_srv = JaxServer(JaxServeConfig(run_dir=str(tmp_path / "j"), slots=3, http_port=None,
                                       canonicalize=JaxCanonical(**canon)))
    assert port._canonical_k() == jax_srv._canonical_k() == 8
    for dt in (1e-2, 9e-3, 5.2e-3, 3e-3, 2.4e-2, 1e-7):
        a = port.submit(dict(_REQ, dt=dt, horizon=0.12))
        b = jax_srv.submit(dict(_REQ, dt=dt, horizon=0.12))
        assert (a.dt, a.steps, a.horizon, a.compat_key) == (b.dt, b.steps, b.horizon, b.compat_key)

    def rows(run_dir):
        return [{k: v for k, v in r.items() if k not in ("wall_s", "t", "id", "trace_id")}
                for r in _events(run_dir)]

    assert rows(str(tmp_path / "p")) == rows(str(tmp_path / "j"))


# -- warm serving end to end -----------------------------------------------------------------------


def _serve(tmp_path, name, profile=None, **kw):
    cfg = ServeConfig(run_dir=str(tmp_path / name), slots=2, chunk_steps=8,
                      checkpoint_every_s=None, http_port=None, warm_profile=profile, **kw)
    srv = SimServer(cfg, device="cpu")
    ids = [srv.submit(dict(_REQ, seed=s, horizon=0.08)).id for s in range(3)]
    summary = srv.serve()
    return srv, summary, [srv.result(i) for i in ids], _events(cfg.run_dir)


def test_warm_hit_serves_what_a_cold_build_serves(tmp_path):
    key = _key()
    before = dict(compile_log.warm_pool_counts())
    warm, s_warm, r_warm, e_warm = _serve(tmp_path, "warm", [{"key": list(key), "k": 2}])
    cold, s_cold, r_cold, e_cold = _serve(tmp_path, "cold")
    assert s_warm["completed"] == s_cold["completed"] == 3
    drop = ("latency_s", "admission_to_first_observable_s")
    assert [{k: v for k, v in r.items() if k not in drop} for r in r_warm] == \
        [{k: v for k, v in r.items() if k not in drop} for r in r_cold]
    names = [e["event"] for e in e_warm]
    assert names.count("warm_pool_hit") == 1 and names.count("aot_build") == 1
    assert "compile_build" not in names
    assert "compile_build" in [e["event"] for e in e_cold]
    assert not any(e["event"].startswith("warm_pool") or e["event"] == "aot_build"
                   for e in e_cold)
    after = compile_log.warm_pool_counts()
    assert after["hit"] - before.get("hit", 0) == 1 and after["aot"] - before.get("aot", 0) == 1
    assert cold._warm is None and warm._warm.counts()["hits"] == 1


def test_warm_build_prepares_the_campaign(tmp_path):
    """The warm build is ``_build_runner``'s arming plus the chunk runner:
    a K-lane served ensemble with every lane dead, its runner built (on
    the card, the captured chunk graphs; none on the CPU), the model's
    route and device the server's."""
    srv = SimServer(ServeConfig(run_dir=str(tmp_path / "s"), slots=3, http_port=None),
                    device="cpu", route="dense")
    model, ens, graphs = srv._warm_build(list(_key()), None)
    assert ens.k == 3 and not ens.alive().any() and graphs == 0
    assert (model.step_kernel, model.conv_kernel, str(model.device)) == ("dense", "dense", "cpu")
    assert (False, False) in ens._runners
    assert type(ens).__name__ == "_ServedEnsemble" and ens.serve_meta == [None] * 3


def test_canonicalized_warm_serve_matches_jax(tmp_path):
    """An off-rung request canonicalizes into the warm bucket in both
    packages; the served results agree to 1e-11 of each observable."""
    profile = [{"key": list(_key()), "k": 2}]
    canon = dict(dt_anchor=1e-2, slot_sizes=(2,))
    reqs = [dict(_REQ, dt=dt, horizon=0.08, seed=s) for s, dt in enumerate((1e-2, 9e-3))]
    port = SimServer(ServeConfig(run_dir=str(tmp_path / "p"), slots=2, chunk_steps=8,
                                 checkpoint_every_s=None, warm_profile=profile,
                                 canonicalize=CanonicalConfig(**canon)), device="cpu")
    jax_srv = JaxServer(JaxServeConfig(run_dir=str(tmp_path / "j"), slots=2, chunk_steps=8,
                                       checkpoint_every_s=None, warm_profile=profile,
                                       canonicalize=JaxCanonical(**canon)))
    pids = [port.submit(r).id for r in reqs]
    jids = [jax_srv.submit(r).id for r in reqs]
    assert port.serve()["completed"] == jax_srv.serve()["completed"] == 2
    for p, j in zip(pids, jids):
        a, b = port.result(p), jax_srv.result(j)
        assert (a["steps"], a["dt"], a["slot"]) == (b["steps"], b["dt"], b["slot"])
        for name in ("nu", "nuvol", "re", "div"):
            assert abs(a[name] - b[name]) <= 1e-11 * max(abs(b[name]), 1e-300)
    names = [e["event"] for e in _events(str(tmp_path / "p"))]
    assert names.count("warm_pool_hit") == 1 and names.count("request_canonicalized") == 1
    assert "compile_build" not in names

"""PyTorch port: the resilient runner, its fault injection and its
workloads, on the CPU, against the JAX package.

Every model is the JAX package's canonical tiny harness model (17^2,
Ra=1e4, dt=1e-2, ``set_velocity``/``set_temperature`` at 0.1), its state
copied into the port; the JAX side runs its default dense route, the port
its fused route (the plain kernel chains on the CPU) unless a test says
otherwise.  One JAX runner per parity case; the rest is held port to port.
Tolerances: the stored fields (temp, velx, vely, pres) within 1e-11 of
their scale and ``pseu`` within 1e-10 (no checkpoint stores it and the
routes' Poisson algorithms differ in its last digits; PR 11's checkpoint
limit), Nu rel 1e-10, growth rates and residuals rel 1e-9.  Journal events
whose presence depends on the wall clock (``perf_degraded``,
``profile_capture``) are kept out: the runners get a throughput monitor
that never reports.

* fault specs: the same specs accepted and rejected by both parsers, with
  equal parsed fields; the shard-crash grammar too;
* ``call_with_watchdog`` as the JAX package's; the event-based dispatch
  watchdog charges the ``slow`` stall to the deadline;
* NaN rollback: the same journal, ``retries``, ``dt``, ``time``, final
  state and Nu as the JAX runner, and bit for bit a clean run at the
  backed-off dt on every port route, the periodic cell, an ensemble (with
  respawn) and through the in-memory checkpoint store;
* a governed spike: the same event kinds and dt trajectory;
* ``bitflip`` under integrity: the same mismatch (check, step, device) and
  rollback step; the final state bit for bit the clean run's in each
  package, so the rollback restored the verified digest;
* SIGTERM preemption then resume equals an uninterrupted run bit for bit,
  with the checkpoint's dt restored; retries exhausted, a stale run
  directory refused, the sim-time cadence and its retention window, the
  ``slow`` fault's ``DispatchHang``;
* ``ResilienceConfig``/``NavierConfig.resilience`` round trips, the
  statistics' health stream (latched events as the JAX runner's),
  ``stats_health_async``;
* ``eigenmode_sweep`` growth rates and a small ``steady_state_find``
  against the JAX package; the find's kill and resume;
* the package exports every name the JAX package's ``__init__`` does,
  except a listed set that waits for later items.
"""

import ast
import gc
import json
import os
import signal
import time
import types

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu.config import IntegrityConfig as JaxIntegrityConfig
from rustpde_mpi_tpu.config import ResilienceConfig as JaxResilienceConfig
from rustpde_mpi_tpu.config import StabilityConfig as JaxStabilityConfig
from rustpde_mpi_tpu.telemetry.metrics import ThroughputMonitor as JaxMonitor
from rustpde_mpi_tpu.utils import faults as jfaults
from rustpde_mpi_tpu.utils import resilience as jres

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch.config import (IntegrityConfig, NavierConfig, ResilienceConfig,
                                          StabilityConfig, StatsConfig)
from rustpde_mpi_tpu_torch.telemetry.metrics import ThroughputMonitor
from rustpde_mpi_tpu_torch.utils import faults as tfaults
from rustpde_mpi_tpu_torch.utils import resilience as tres
from rustpde_mpi_tpu_torch.utils.journal import read_journal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = (1e4, 1.0, 1e-2, 1.0, "rbc")
DT = PARAMS[2]
TOL = 1e-11
PSEU_TOL = 1e-10
NU_REL = 1e-10
RATE_REL = 1e-9
DENSE = dict(step_kernel="dense", conv_kernel="dense")
#: events whose presence depends on the wall clock
CLOCKED = ("perf_degraded", "profile_capture")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _jax_model(dt=DT, periodic=False, nx=17):
    model = rp.Navier2D(nx, 17, *PARAMS[:2], dt, *PARAMS[3:], periodic=periodic)
    model.set_velocity(0.1, 1.0, 1.0)
    model.set_temperature(0.1, 1.0, 1.0)
    model.write_intervall = 1e9
    return model


_START = {}


def _start(periodic=False):
    """The JAX harness model's initial state (numpy), made once a cell."""
    if periodic not in _START:
        ref = _jax_model(periodic=periodic, nx=16 if periodic else 17)
        _START[periodic] = {f: np.asarray(getattr(ref.state, f)) for f in ref.state._fields}
    return _START[periodic]


def _port(dt=DT, route="fused", periodic=False):
    kw = dict(DENSE) if route == "dense" else {}
    if route == "mesh":
        kw["mesh"] = pt.make_mesh(4, "cpu")
    else:
        kw["device"] = "cpu"
    model = pt.Navier2D(16 if periodic else 17, 17, *PARAMS[:2], dt, *PARAMS[3:],
                        periodic=periodic, **kw)
    convert.state_from_numpy(model, _start(periodic))
    model.write_intervall = 1e9
    return model


def _runner(pde, run_dir, jax=False, **kw):
    cls = jres.ResilientRunner if jax else tres.ResilientRunner
    runner = cls(pde, run_dir=str(run_dir), **kw)
    runner.slo = (JaxMonitor if jax else ThroughputMonitor)(warmup=10**9)
    return runner


def _events(run_dir, full=False):
    rows = [e for e in read_journal(os.path.join(str(run_dir), "journal.jsonl"))
            if e["event"] not in CLOCKED]
    return rows if full else [e["event"] for e in rows]


def _close(port, ref):
    got = convert.state_to_numpy(port)
    for name in ref.state._fields:
        want = np.asarray(getattr(ref.state, name))
        scale = max(float(np.max(np.abs(want))), 1e-300)
        tol = PSEU_TOL if name == "pseu" else TOL
        assert float(np.max(np.abs(got[name] - want))) <= tol * scale, name


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.state, b.state))


def _clean(dt, steps, route="fused", periodic=False):
    model = _port(dt, route, periodic)
    model.update_n(steps)
    return model


# -- fault specs ----------------------------------------------------------------------

SPECS = ["nan@12", "spike@0", "kill@7", "slow@3", "bitflip@40", "nan@-3", "nan@+5",
         "nan@12:host0", "kill@9:host3", "bitflip@4:member2", "kill@5:gang1",
         "kill@5:gang2member0", "", None,
         "nan", "typo@3", "nan@x", "nan@1.5", "@4", "nan@", "nan@3:host", "nan@3:hostx",
         "nan@3:member", "nan@3:memberx", "nan@3:gang", "nan@3:gangmember1",
         "nan@3:gang1member", "nan@3:gang1x", "nan@3:gang1memberx", "nan@3:node1", "NAN@3",
         "nan@3:host1:x"]


def _parse(mod, spec):
    try:
        plan = mod.FaultPlan.from_spec(spec)
    except ValueError as exc:
        return ("error", type(exc).__name__, str(exc))
    return None if plan is None else ("plan", {k: v for k, v in vars(plan).items()})


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: repr(s))
def test_fault_specs_parse_as_jax(spec):
    want, got = _parse(jfaults, spec), _parse(tfaults, spec)
    assert got == want
    if got is not None and got[0] == "error":
        with pytest.raises(tfaults.FaultSpecError):
            tfaults.FaultPlan.from_spec(spec)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS


@pytest.mark.parametrize("spec", ["after_shard@3", "before_manifest@0:host1", "", None,
                                  "during@3", "after_shard", "after_shard@x",
                                  "after_shard@2:hostq"], ids=lambda s: repr(s))
def test_shard_crash_specs_parse_as_jax(spec):
    def parse(mod):
        try:
            return mod.parse_shard_crash_spec(spec)
        except ValueError as exc:
            return str(exc)

    assert parse(tfaults) == parse(jfaults)


def test_gang_and_host_scopes():
    plan = tfaults.FaultPlan.from_spec("kill@5:gang2member1")
    assert not plan.scoped_here()
    plan.bind_gang(2, 1)
    assert plan.scoped_here()
    plan.bind_gang(2, 0)
    assert not plan.scoped_here()
    assert tfaults.FaultPlan.from_spec("nan@3:host0").scoped_here()
    assert not tfaults.FaultPlan.from_spec("nan@3:host1").scoped_here()
    # a host scope acts on that process only: in one process (process 0)
    # host1 builds and injects nothing
    model = _port()
    runner = tres.ResilientRunner(model, 0.1, fault="nan@3:host1")
    assert runner.fault.host == 1 and not runner.fault.scoped_here()
    before = [t.clone() for t in model.state]
    tres.poison_state(model, host=1)
    tres.spike_state(model, host=1)
    assert tres.bitflip_state(model, 3, host=1)["leaf"] is None
    assert all(torch.equal(a, b) for a, b in zip(before, model.state))
    tres.poison_state(model, host=0)
    assert all(torch.isnan(t).all() for t in model.state)
    with pytest.raises(tfaults.FaultSpecError):
        tres.ResilientRunner(_port(), 0.1, fault="nan@x")


# -- the watchdogs ------------------------------------------------------------------------


def test_call_with_watchdog_as_jax():
    for mod in (jres, tres):
        assert mod.call_with_watchdog(lambda: 42, None) == 42
        assert mod.call_with_watchdog(lambda: 42, 5.0) == 42
        with pytest.raises(ValueError, match="boom"):
            mod.call_with_watchdog(lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0)
        t0 = time.monotonic()
        with pytest.raises(mod.DispatchHang, match="deadline-test") as info:
            mod.call_with_watchdog(lambda: time.sleep(3.0), 0.2, label="deadline-test")
        assert time.monotonic() - t0 < 2.0 and info.value.timeout_s == 0.2


def test_dispatch_watchdog_charges_the_stall():
    assert tres.dispatch_with_watchdog(lambda: 7, None, stall_s=0.01) == 7
    assert tres.dispatch_with_watchdog(lambda: 7, 5.0, device="cpu") == 7
    t0 = time.monotonic()
    with pytest.raises(tres.DispatchHang, match="stalled"):
        tres.dispatch_with_watchdog(lambda: 7, 0.3, label="stalled", stall_s=2.0)
    assert 0.3 <= time.monotonic() - t0 < 1.5  # raised at the deadline, not after the stall
    with pytest.raises(tres.DispatchHang):  # CPU work that overran its deadline
        tres.dispatch_with_watchdog(lambda: time.sleep(0.3), 0.1, device="cpu")


# -- NaN rollback -----------------------------------------------------------------------------

NAN_RUN = dict(max_time=0.1, save_intervall=0.05, checkpoint_every_s=None, max_retries=2,
               dt_backoff=0.5, fault="nan@4")
NAN_EVENTS = ["start", "checkpoint", "fault_injected", "divergence", "retry", "checkpoint",
              "io_overlap", "done"]


def test_nan_rollback_matches_jax(tmp_path):
    ref = _jax_model()
    want = _runner(ref, tmp_path / "jax", jax=True, **NAN_RUN).run()
    model = _port()
    got = _runner(model, tmp_path / "port", **NAN_RUN).run()
    assert _events(tmp_path / "port") == _events(tmp_path / "jax") == NAN_EVENTS
    for key in ("outcome", "retries", "step"):
        assert got[key] == want[key]
    assert got["dt"] == want["dt"] == DT / 2 and got["time"] == pytest.approx(want["time"],
                                                                               abs=1e-12)
    assert got["nu"] == pytest.approx(want["nu"], rel=NU_REL)
    _close(model, ref)
    retry = [e for e in _events(tmp_path / "port", full=True) if e["event"] == "retry"][0]
    assert retry["dt"] == DT / 2 and retry["attempt"] == 1 and retry["dt_floor"] is False
    assert pt.utils.checkpoint.verify_snapshot(got["checkpoint"])["digest"]


@pytest.mark.parametrize("case", ["fused", "dense", "mesh", "periodic", "memory_store"])
def test_nan_rollback_equals_a_clean_run(tmp_path, case):
    """The rollback target is the step-0 anchor, so the recovered run is the
    clean run at dt/2, bit for bit, on every route, the periodic cell and
    through the in-memory store (whose journal is the file store's)."""
    route = case if case in ("fused", "dense", "mesh") else "fused"
    periodic = case == "periodic"
    model = _port(route=route, periodic=periodic)
    store = tres._MemoryStore(str(tmp_path)) if case == "memory_store" else None
    summary = _runner(model, tmp_path, _store=store, **NAN_RUN).run()
    assert _events(tmp_path) == NAN_EVENTS
    assert summary["retries"] == 1 and summary["dt"] == DT / 2 and summary["step"] == 20
    clean = _clean(DT / 2, 20, route, periodic)
    assert _same(model, clean) and summary["nu"] == clean.eval_nu()
    if store is not None:
        assert store.files() == [os.path.join(str(tmp_path), "ckpt_0000000000.h5"),
                                 os.path.join(str(tmp_path), "ckpt_0000000020.h5")]
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".h5")]
        assert store.attrs(summary["checkpoint"])["dt"] == DT / 2


def test_runner_drives_an_ensemble_with_respawn(tmp_path):
    ens = pt.NavierEnsemble.from_seeds(_port(), range(2))
    summary = _runner(ens, tmp_path, max_time=0.1, save_intervall=0.05, checkpoint_every_s=None,
                      max_retries=1, fault="nan@4", respawn_members=True).run()
    assert summary["outcome"] == "done" and summary["retries"] == 1
    assert ens.alive().all() and summary["dt"] == DT / 2 and np.isfinite(summary["nu"])
    import h5py

    with h5py.File(summary["checkpoint"], "r") as h5:
        assert "member0" in h5 and "member1" in h5


def test_retries_exhausted_raises(tmp_path):
    class AlwaysDiverges(tres.ResilientRunner):
        def _rollback(self):
            super()._rollback()
            self.fault = tfaults.FaultPlan.from_spec(f"nan@{self.step + 4}")

    runner = AlwaysDiverges(_port(), max_time=0.5, save_intervall=0.05, run_dir=str(tmp_path),
                            checkpoint_every_s=None, max_retries=1, fault="nan@4")
    runner.slo = ThroughputMonitor(warmup=10**9)
    with pytest.raises(pt.DivergenceError, match="exhausted"):
        runner.run()
    events = _events(tmp_path)
    assert events.count("divergence") == 2
    assert [e for e in events if e != "flight_record"][-1] == "giveup"
    assert events[-1] == "flight_record"
    with pytest.raises(pt.DivergenceError, match="no valid checkpoint"):
        bare = tres.ResilientRunner(_port(), 0.1, run_dir=str(tmp_path / "empty"))
        bare._rollback()


# -- the governor ----------------------------------------------------------------------------


def test_governed_spike_matches_jax(tmp_path):
    """``governor129``'s logic at 17^2: the spike sized at 3x the ceiling
    from a probe's CFL four steps in, caught within ``max_chunk_steps``
    (the lagged, overlapped path of both runners); no regrowth in the
    window (``grow_after`` past it), so the JAX side compiles few rungs."""
    probe = _port()
    probe.set_stability(StabilityConfig())
    factor = 3.0 / probe.update_n(4).cfl_max
    run = dict(max_time=12 * DT, save_intervall=None, checkpoint_every_s=None, max_retries=2,
               fault="spike@4", spike_factor=factor, max_chunk_steps=2)
    ref = _jax_model()
    want = _runner(ref, tmp_path / "jax", jax=True, stability=JaxStabilityConfig(grow_after=100),
                   **run).run()
    model = _port()
    got = _runner(model, tmp_path / "port", stability=StabilityConfig(grow_after=100),
                  **run).run()
    jrows, trows = _events(tmp_path / "jax", full=True), _events(tmp_path / "port", full=True)
    assert [e["event"] for e in trows] == [e["event"] for e in jrows]
    assert "pre_divergence" in [e["event"] for e in trows]
    dts = [[e["dt"] for e in rows if e["event"] == "dt_adjust"] for rows in (jrows, trows)]
    assert dts[1] == dts[0] and dts[1]
    for key in ("outcome", "retries", "step", "dt"):
        assert got[key] == want[key]
    assert got["health"]["pre_divergence_catches"] == want["health"]["pre_divergence_catches"] >= 1
    _close(model, ref)


# -- integrity ----------------------------------------------------------------------------------

INTEG_RUN = dict(max_time=0.2, save_intervall=0.05, checkpoint_every_s=None)


def test_bitflip_under_integrity_matches_jax(tmp_path):
    rows = {}
    finals = {}
    for pkg in ("jax", "port"):
        for fault in ("bitflip@10", None):
            if pkg == "jax":
                pde = _jax_model()
                pde.set_integrity(JaxIntegrityConfig(cadence=1))
            else:
                pde = _port()
                pde.set_integrity(IntegrityConfig(cadence=1))
            d = tmp_path / f"{pkg}_{fault is not None}"
            _runner(pde, d, jax=pkg == "jax", fault=fault, **INTEG_RUN).run()
            if fault is not None:
                rows[pkg] = _events(d, full=True)
            finals[pkg, fault is not None] = (pde, {f: np.asarray(getattr(pde.state, f))
                                                    for f in pde.state._fields})
    strip = ("wall_s", "t", "digest")
    kinds = [e["event"] for e in rows["port"]]
    assert kinds == [e["event"] for e in rows["jax"]]
    assert "integrity_mismatch" in kinds and "integrity_rollback" in kinds
    for jrow, trow in zip(rows["jax"], rows["port"]):
        if trow["event"] in ("bitflip_injected", "integrity_mismatch", "integrity_rollback"):
            assert {k: v for k, v in trow.items() if k not in strip} == \
                {k: v for k, v in jrow.items() if k not in strip}
    mismatch = [e for e in rows["port"] if e["event"] == "integrity_mismatch"][0]
    assert mismatch["check"] == "chain" and mismatch["device"] == "cpu:0@proc0"
    for pkg in ("jax", "port"):
        faulted, clean = finals[pkg, True][1], finals[pkg, False][1]
        for name in clean:
            np.testing.assert_array_equal(faulted[name], clean[name])
    _close(finals["port", True][0], finals["jax", True][0])
    ledger = pt.QuarantineLedger(str(tmp_path / "port_True"))
    assert ledger.strikes_for("cpu:0@proc0") == 1


# -- preemption and resume -----------------------------------------------------------------------


@pytest.mark.parametrize("store", ["files", "memory", "npz"])
def test_sigterm_preempt_then_resume_equals_uninterrupted(tmp_path, store, monkeypatch):
    run = dict(max_time=0.3, save_intervall=0.05, checkpoint_every_s=None)
    mem = tres._MemoryStore(str(tmp_path)) if store == "memory" else None
    if store == "npz":  # the default store where h5py does not import: .npz files
        monkeypatch.setattr(tres.checkpoint, "_have_h5py", lambda: False)
    first = _runner(_port(), tmp_path, fault="kill@12", _store=mem, **run).run()
    assert first["outcome"] == "preempted" and first["step"] >= 12
    if store == "npz":
        names = [n for n in os.listdir(tmp_path) if n.startswith("ckpt_")]
        assert names and all(n.endswith(".npz") for n in names)
    model = _port()  # a fresh model: the resume restores state, time and step
    second = _runner(model, tmp_path, _store=mem, **run).run()
    assert second["outcome"] == "done" and second["step"] == 30
    events = _events(tmp_path)
    assert "preempted" in events and "resumed" in events and events[-1] == "done"
    resumed = [e for e in _events(tmp_path, full=True) if e["event"] == "resumed"][0]
    assert resumed["step"] == first["step"]
    assert _same(model, _clean(DT, 30))
    assert signal.getsignal(signal.SIGTERM) is not None


def test_resume_restores_the_checkpoint_dt(tmp_path):
    donor = _port(DT / 2)
    donor.update_n(4)
    pt.utils.checkpoint.write_snapshot(donor, pt.utils.checkpoint.checkpoint_path(
        str(tmp_path), 4), step=4)
    summary = _runner(_port(DT), tmp_path, max_time=0.1, save_intervall=0.05,
                      checkpoint_every_s=None).run()
    assert summary["outcome"] == "done" and summary["dt"] == DT / 2
    assert summary["time"] == pytest.approx(0.1) and "dt_restored" in _events(tmp_path)


def test_sim_time_cadence_keeps_its_window(tmp_path):
    summary = _runner(_port(), tmp_path, max_time=0.3, save_intervall=0.05,
                      checkpoint_every_s=None, checkpoint_every_t=0.1, keep=2).run()
    assert summary["outcome"] == "done"
    assert len(pt.utils.checkpoint.checkpoint_files(str(tmp_path))) == 2
    assert len([e for e in _events(tmp_path, full=True) if e.get("reason") == "cadence"]) >= 2


def test_fresh_run_refuses_a_stale_run_dir(tmp_path):
    pt.utils.checkpoint.write_snapshot(_port(), pt.utils.checkpoint.checkpoint_path(
        str(tmp_path), 7), step=7)
    with pytest.raises(ValueError, match="previous run"):
        tres.ResilientRunner(_port(), 0.1, run_dir=str(tmp_path), resume=False).run()


def test_slow_fault_trips_the_dispatch_watchdog(tmp_path):
    model = _port()
    model.update_n(7)  # build the chunk runner outside the deadline
    convert.state_from_numpy(model, _start())
    model.reset_time()
    runner = _runner(model, tmp_path, max_time=0.3, save_intervall=0.05,
                     checkpoint_every_s=None, fault="slow@7", dispatch_timeout_s=1.0)
    t0 = time.monotonic()
    with pytest.raises(pt.DispatchHang, match="update_n"):
        runner.run()
    assert time.monotonic() - t0 < 1.0 + 2.0
    events = _events(tmp_path)
    assert [e for e in events if e != "flight_record"][-1] == "dispatch_hang"
    assert "fault_injected" in events and events[-1] == "flight_record"


# -- configuration, statistics --------------------------------------------------------------------


def test_resilience_config_round_trips(tmp_path):
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(ResilienceConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JaxResilienceConfig)]
    rcfg = ResilienceConfig(run_dir=str(tmp_path / "run"), checkpoint_every_s=None,
                            checkpoint_every_t=0.1, keep=2, max_retries=1,
                            stability=StabilityConfig(max_cfl=0.9))
    cfg = NavierConfig(nx=17, ny=17, ra=1e4, dt=0.01, resilience=rcfg)
    model = pt.Navier2D.from_config(cfg, device="cpu")
    model.write_intervall = 1e9
    runner = tres.ResilientRunner.from_config(model, cfg.resilience, max_time=0.1,
                                              save_intervall=0.05, keep=3)
    assert runner.keep == 3 and runner.max_retries == 1 and runner.run_dir == rcfg.run_dir
    assert runner.stability is rcfg.stability  # the dataclass, not a dict
    runner.slo = ThroughputMonitor(warmup=10**9)
    summary = runner.run()
    assert summary["outcome"] == "done" and summary["health"] is not None
    assert tres.ResilientRunner.from_config(model, None, 1.0).keep == 3
    with pytest.raises(TypeError, match="ResilienceConfig"):
        NavierConfig(resilience=object())


def test_stats_health_async_and_the_latched_stream(tmp_path):
    model = _port()
    model.set_stats(StatsConfig(stride=2, tail_warn=0.0, budget_warn=0.0))
    ens = pt.NavierEnsemble.from_seeds(_port(), range(2))
    ens.set_stats(StatsConfig(stride=2))
    for pde in (model, ens):
        pde.update_n(6)
        fut = pde.stats_health_async()
        got, want = fut.result(), pde.stats_health()
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    summary = _runner(model, tmp_path, max_time=0.2, save_intervall=0.02,
                      checkpoint_every_s=None).run()
    assert summary["stats"]["samples"] > 0
    events = _events(tmp_path)
    # thresholds at zero: each warning fires once and stays latched
    assert events.count("resolution_warning") == 1 and events.count("budget_drift") == 1


#: health readouts (HEALTH_NAMES order): a tail over its limit, then the
#: Nu residual over its own while the tail stays latched, both below half
#: their limits (re-armed), both over again, nothing sampled
_SEQUENCE = [
    [1e-4, 2e-4, 3e-4, 5e-3, 1e-5, 0.0, 4.0, 6.0, 0.1, 0.2, 2.0, 2.1, 7.0],
    [1e-4, 2e-4, 3e-4, 6e-3, 1e-5, 0.0, 4.0, 6.0, 0.1, 0.9, 2.0, 2.1, 8.0],
    [1e-4, 2e-4, 3e-4, 1e-4, 1e-5, 0.0, 4.0, 6.0, 0.1, 0.1, 2.0, 2.1, 9.0],
    [1e-4, 2e-4, 3e-4, 5e-3, 1e-5, 0.0, 4.0, 6.0, 0.1, 0.7, 2.0, 2.1, 10.0],
    [0.0] * 13,
]


def test_health_report_latches_as_jax():
    """The same sequence of health readouts through both runners' report:
    the same journal rows (a warning once per excursion, re-armed below
    half its limit)."""
    engine = types.SimpleNamespace(tail_warn=1e-3, budget_warn=0.5)
    out = {}
    for mod in (jres, tres):
        rows = []
        runner = types.SimpleNamespace(pde=types.SimpleNamespace(stats_engine=engine),
                                       _stats_res_latched=False, _stats_budget_latched=False,
                                       _journal=rows.append)
        for vals in _SEQUENCE:
            mod.ResilientRunner._stats_health_report(runner, tuple(vals))
        out[mod] = rows
    assert out[tres] == out[jres]
    assert [e["event"] for e in out[tres]] == ["resolution_warning", "budget_drift",
                                               "resolution_warning", "budget_drift"]


# -- the workloads ---------------------------------------------------------------------------------


def test_eigenmode_sweep_growth_rates_match_jax(tmp_path):
    from rustpde_mpi_tpu.workloads import eigenmode_sweep as jax_sweep

    kw = dict(nx=8, ny=17, dt=0.05, horizon=8.0, samples=4)
    want = jax_sweep([4000.0], run_dir=None, **kw)
    got = pt.eigenmode_sweep([800.0, 4000.0], run_dir=str(tmp_path / "eig"), device="cpu", **kw)
    assert got[1]["steps"] == want[0]["steps"] and got[1]["times"] == want[0]["times"]
    assert got[1]["sigma_max"] == pytest.approx(want[0]["sigma_max"], rel=RATE_REL)
    assert got[0]["sigma_max"] < 0.0 < got[1]["sigma_max"]
    # the spent checkpoints are removed; the journal stays
    assert sorted(os.listdir(tmp_path / "eig" / "ra4000")) == ["journal.jsonl", "metrics.jsonl"]
    again = pt.eigenmode_sweep([800.0], run_dir=str(tmp_path / "eig"), device="cpu", **kw)
    assert not again[0]["resumed"] and again[0]["sigma_max"] == got[0]["sigma_max"]
    assert pt.critical_rayleigh(got) == pytest.approx(
        800.0 - got[0]["sigma_max"] * 3200.0 / (got[1]["sigma_max"] - got[0]["sigma_max"]))


FIND = dict(nx=17, ny=17, ra=100.0, dt=1e-3, res_tol=1e-5, k=1, amp=0.005, chunk=200,
            install_signals=False)


def test_steady_state_find_matches_jax(tmp_path):
    from rustpde_mpi_tpu.workloads import steady_state_find as jax_find

    want = jax_find(run_dir=str(tmp_path / "jax"), max_iters=200, **FIND)
    got = pt.steady_state_find(run_dir=str(tmp_path / "port"), max_iters=200, device="cpu",
                               **FIND)
    assert got["iterations"] == want["iterations"] == 200
    assert got["converged"] == want["converged"] == [False]
    assert got["residuals"][0] == pytest.approx(want["residuals"][0], rel=RATE_REL)
    assert got["nu"][0] == pytest.approx(want["nu"][0], rel=NU_REL)


def test_steady_state_find_kill_then_resume(tmp_path):
    run = dict(FIND, install_signals=True, run_dir=str(tmp_path), max_iters=400, chunk=100,
               device="cpu")
    first = pt.steady_state_find(fault="kill@100", **run)
    assert first["preempted"] and first["checkpoint"] and first["iterations"] >= 100
    second = pt.steady_state_find(**run)
    assert second["resumed"] and second["iterations"] == 400 and not second["preempted"]
    assert second["residuals"][0] < first["residuals"][0]
    events = [e["event"] for e in read_journal(os.path.join(str(tmp_path), "journal.jsonl"))]
    assert "checkpoint" in events and "resumed" in events


# -- exports ---------------------------------------------------------------------------------------

#: names of the JAX package's __init__ that are TPU-only: the split
#: Fourier layout (not ported by design)
NOT_YET = {"fourier_r2c_split"}


def test_the_package_exports_the_jax_names():
    with open(os.path.join(REPO, "rustpde_mpi_tpu", "__init__.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets)
    missing = sorted(n for n in names - NOT_YET if not hasattr(pt, n))
    assert not missing, missing
    assert NOT_YET <= names  # the list names real JAX exports
    from rustpde_mpi_tpu_torch import CheckpointError  # noqa: F401  (the motivating import)

    assert pt.config.ResilienceConfig is ResilienceConfig  # in config, as in the JAX package
    assert issubclass(pt.FaultSpecError, ValueError) and pt.telemetry.prometheus_text
    assert json.loads(json.dumps(pt.__version__)) == rp.__version__

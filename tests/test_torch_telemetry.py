"""PyTorch port: the telemetry layer and the profiling helpers, on the CPU,
against the JAX package where both have the same function.

* ``prometheus_text`` renders the same text as the JAX package's for the
  same registry contents, labels escaped alike;
* the flight recorder: the same ``traceEvents`` JSON as the JAX
  recorder's for the same events (spans, instants, the ring bound), and
  the same file name and payload from ``dump_flight_record``; disabled
  spans are one shared no-op object;
* ``MetricsDumper``'s cadence and ``read_metrics_jsonl`` (torn tail);
* the compile log: ``key_tag`` and ``observe_build``'s rows equal the JAX
  package's, builds and rebuilds counted, ``build_model_for_key`` records
  a build, a chunk runner's capture counts one entry compile (again after
  ``set_dt`` moves to a new rung, not after a move back to a cached one);
  the device memory gauges report nothing without a card; the profiler
  capture is single-flight, bounded and one-shot on ``perf_degraded``;
* the runner with telemetry on steps bit for bit as with it off, and its
  ``perf_degraded`` row and incident dumps (divergence, preemption,
  dispatch hang) land in the run directory;
* ``utils/profiling``: ``benchmark_steps``, ``StepTimer``, ``trace``, the
  peak table's key, ``mfu_estimate``; ``step_flops`` of the fused route is
  the wrappers' sum, and the dense route's analytic GEMM count equals the
  JAX package's ``_analytic_step_flops`` for the same model with its
  folding off (the port's products are unfolded).
"""

import gc
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from rustpde_mpi_tpu.telemetry import compile_log as jcl
from rustpde_mpi_tpu.telemetry import exporters as jexp
from rustpde_mpi_tpu.telemetry import metrics as jmetrics
from rustpde_mpi_tpu.telemetry import tracing as jtr

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import telemetry
from rustpde_mpi_tpu_torch.telemetry import compile_log as tcl
from rustpde_mpi_tpu_torch.telemetry import exporters as texp
from rustpde_mpi_tpu_torch.telemetry import metrics as tmetrics
from rustpde_mpi_tpu_torch.telemetry import tracing as ttr
from rustpde_mpi_tpu_torch.utils import profiling
from rustpde_mpi_tpu_torch.utils.journal import read_journal
from rustpde_mpi_tpu_torch.workloads import build_model_for_key

PARAMS = (1e4, 1.0, 1e-2, 1.0, "rbc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _model(seed=0, **kw):
    model = pt.Navier2D(17, 17, *PARAMS, device="cpu", **kw)
    model.init_random(0.1, seed=seed)
    model.write_intervall = 1e9
    return model


def _calm():
    """A throughput monitor that never reports (its verdicts depend on the
    wall clock)."""
    return tmetrics.ThroughputMonitor(warmup=10**9)


# -- the exposition and the recorder against the JAX package ---------------------------


def _fill(reg):
    reg.counter("a_total", "things", kind='x"y\\z\nw').inc(2)
    reg.counter("a_total", "things", kind="plain").inc(0.5)
    reg.gauge("b").set(1.5)
    reg.gauge("b_inf", "infinite").set(float("inf"))
    reg.gauge("b_nan").set(float("nan"))
    h = reg.histogram("c_seconds", "hist help", phase="p")
    for v in (0.1, 0.2, 3.0, 1e-7, 250.0):
        h.observe(v)
    return reg


def test_prometheus_text_matches_jax():
    want = jexp.prometheus_text(_fill(jmetrics.MetricsRegistry()))
    got = texp.prometheus_text(_fill(tmetrics.MetricsRegistry()))
    assert got == want
    assert "# TYPE c_seconds histogram" in got and '\\"' in got and "\\n" in got
    assert texp.prometheus_text(tmetrics.MetricsRegistry()) == ""
    assert texp.PROMETHEUS_CONTENT_TYPE == jexp.PROMETHEUS_CONTENT_TYPE


def _record(rec):
    rec.add_complete("dispatch", 12.5, 125.0, {"steps": 4})
    rec.add_instant("fault_injected", {"kind": "nan"})
    for i in range(40):  # past the ring's bound
        rec.add_complete("spam", 100.0 + i, 1.0)
    rec._events = type(rec._events)(
        ({**e, "ts": round(float(i), 3)} if e["ph"] == "i" else e
         for i, e in enumerate(rec._events)), maxlen=rec.capacity)
    return rec


def test_flight_record_json_matches_jax(tmp_path):
    jrec, trec = _record(jtr.FlightRecorder(capacity=32)), _record(ttr.FlightRecorder(capacity=32))
    assert trec.events() == jrec.events() and len(trec.events()) == 32
    jpath = jrec.dump(str(tmp_path / "j" / "flight.json"), reason="test", extra={"a": 1})
    tpath = trec.dump(str(tmp_path / "t" / "flight.json"), reason="test", extra={"a": 1})
    with open(jpath) as fj, open(tpath) as ft:
        assert json.load(ft) == json.load(fj)
    assert trec.dumped == 1 and ttr.FlightRecorder(capacity=3).capacity == 16
    # dump_flight_record: the same name and payload from the process recorders
    prev = (jtr.RECORDER, ttr.RECORDER)
    try:
        jtr.RECORDER, ttr.RECORDER = _record(jtr.FlightRecorder()), _record(ttr.FlightRecorder())
        jp = jtr.dump_flight_record(str(tmp_path / "jr"), "dispatch hang", step=7)
        tp = ttr.dump_flight_record(str(tmp_path / "tr"), "dispatch hang", step=7)
        assert os.path.basename(tp) == os.path.basename(jp) == "flight_dispatch_hang_step7_n0001.json"
        with open(jp) as fj, open(tp) as ft:
            assert json.load(ft) == json.load(fj)
    finally:
        jtr.RECORDER, ttr.RECORDER = prev


def test_spans_and_the_disabled_path():
    before = len(ttr.RECORDER.events())
    with telemetry.span("outer", step=3):
        pass
    with pytest.raises(RuntimeError):
        with telemetry.span("failing"):
            raise RuntimeError("boom")
    telemetry.instant("marker", kind="x")
    events = ttr.RECORDER.events()
    assert len(events) >= before + 3
    named = {e["name"]: e for e in events[-3:]}
    assert named["outer"]["args"] == {"step": 3} and named["outer"]["ph"] == "X"
    assert named["failing"]["args"]["error"] == "RuntimeError"
    assert named["marker"]["ph"] == "i"
    ttr.set_span_annotator(lambda: {"req": "r1"})
    try:
        with telemetry.span("annotated"):
            pass
        assert ttr.RECORDER.events()[-1]["args"] == {"req": "r1"}
    finally:
        ttr.set_span_annotator(None)
    prev = tmetrics.enabled()
    try:
        telemetry.set_enabled(False)
        assert not telemetry.enabled()
        c = telemetry.counter("nope_total")
        c.inc(100)
        assert c.value == 0.0
        assert ttr.span("a") is ttr.span("b")  # the shared null span
        n = len(ttr.RECORDER.events())
        with ttr.span("silent"):
            telemetry.instant("silent")
        assert len(ttr.RECORDER.events()) == n
        assert telemetry.dump_flight_record("/nonexistent", "x") is None
    finally:
        telemetry.set_enabled(prev)


def test_exit_dump_arms_and_disarms(tmp_path):
    disarm = ttr.arm_exit_dump(str(tmp_path / "a"), lambda: 5)
    disarm()
    keep = ttr.arm_exit_dump(str(tmp_path / "b"), lambda: 9)
    ttr._run_exit_hooks()  # what atexit runs
    assert not os.path.exists(tmp_path / "a")
    assert [f for f in os.listdir(tmp_path / "b") if f.startswith("flight_unclean_exit_step9")]
    keep()


def test_metrics_dumper_cadence_and_reader(tmp_path):
    reg = tmetrics.MetricsRegistry()
    reg.counter("x_total").inc(3)
    path = str(tmp_path / "metrics.jsonl")
    d = texp.MetricsDumper(path, every_s=1e9, registry=reg)
    assert d.path == path
    assert d.maybe_dump() is False  # the first call arms the clock
    assert d.maybe_dump() is False  # cadence not elapsed
    assert d.dump(step=7) is True
    reg.counter("x_total").inc(2)
    assert d.dump(step=9) is True
    records = texp.read_metrics_jsonl(path)
    assert [r["step"] for r in records] == [7, 9] and d.dumps == 2
    assert records[1]["delta"]["x_total"]["series"][0]["value"] == 2.0
    assert records[1]["snapshot"] == reg.snapshot()
    fast = texp.MetricsDumper(str(tmp_path / "fast.jsonl"), every_s=0.0, registry=reg)
    assert fast.maybe_dump(step=1) is False and fast.maybe_dump(step=2) is True
    with open(path, "a") as fh:
        fh.write('{"torn')
    assert len(texp.read_metrics_jsonl(path)) == 2
    assert texp.read_metrics_jsonl(str(tmp_path / "missing.jsonl")) == []
    prev = tmetrics.enabled()
    try:
        tmetrics.set_enabled(False)
        assert d.dump(step=11) is False
    finally:
        tmetrics.set_enabled(prev)


# -- the compile log ------------------------------------------------------------------


def test_compile_log_rows_match_jax():
    key = ("dns", 17, 17, 1e4, 1.0, 0.0987654, 1.0, "rbc", False, ())
    assert tcl.key_tag(key) == jcl.key_tag(key)
    for phase, wall in (("build", 0.5), ("build", 0.25), ("entry_points", 0.1)):
        want = jcl.observe_build(key, wall, kind="dns", phase=phase)
        got = tcl.observe_build(key, wall, kind="dns", phase=phase)
        assert got == want
    assert tcl.build_counts()[tcl.key_tag(key)] == 2 and tcl.last_build_wall(key) == 0.25
    assert tcl.observe_first_chunk(key, 1.5) == jcl.observe_first_chunk(key, 1.5)
    for event in ("hit", "miss", "aot"):
        assert tcl.observe_warm_pool(event, key=key, k=4) == \
            jcl.observe_warm_pool(event, key=key, k=4)
    snap = telemetry.snapshot()
    tag = tcl.key_tag(key)
    assert any(s["labels"] == {"key": tag} for s in snap["compile_recompiles_total"]["series"])
    assert tcl.warm_pool_counts()["hit"] >= 1


def test_compile_log_counts_builds_and_captures():
    key = ("dns", 17, 17, 1e4, 1.0, 0.0123, 1.0, "rbc", False, ())
    before = tcl.build_counts().get(tcl.key_tag(key), 0)
    model = build_model_for_key(key, device="cpu")
    build_model_for_key(key, device="cpu")
    assert tcl.build_counts()[tcl.key_tag(key)] == before + 2
    model.init_random(0.1)
    count = lambda: tcl.entry_compile_counts().get("dns", 0)  # noqa: E731
    n0 = count()
    model.update_n(2)  # builds the plain chunk's runner
    model.update_n(2)
    assert count() == n0 + 1
    model.set_dt(0.00617)  # a new rung: its runner is built at the next chunk
    model.update_n(2)
    model.set_dt(0.0123)  # back to a cached rung: nothing is built
    model.update_n(2)
    assert count() == n0 + 2
    series = telemetry.snapshot()["model_entry_compiles_total"]["series"]
    assert any(s["labels"] == {"model": "dns"} and s["value"] >= 2 for s in series)


def test_device_memory_and_profiler_capture(tmp_path, monkeypatch):
    assert profiling.device_memory_stats() == {}  # no card here
    assert tcl.update_device_memory_gauges() == 0
    started, stopped = [], []
    cap = tcl.ProfilerCapture(start_fn=started.append, stop_fn=lambda: stopped.append(1),
                              max_s=5.0)
    assert cap.start(str(tmp_path), "nope")["started"] is False
    assert cap.start(str(tmp_path), -1)["started"] is False
    status = cap.start(str(tmp_path / "p"), 0.3, reason="test")
    assert status["started"] is True and status["seconds"] == 0.3
    refused = cap.start(str(tmp_path / "p2"), 0.1)
    assert refused["started"] is False and "already running" in refused["error"]
    for _ in range(300):
        if not cap.busy:
            break
        time.sleep(0.01)
    assert not cap.busy and cap.captures == 1 and cap.last.get("done") is True
    assert started == [str(tmp_path / "p")] and stopped == [1]
    assert cap.start(str(tmp_path / "p3"), 1e9)["seconds"] == 5.0
    for _ in range(300):
        if not cap.busy:
            break
        time.sleep(0.01)
    monkeypatch.setattr(tcl, "CAPTURE", tcl.ProfilerCapture(start_fn=lambda d: None,
                                                            stop_fn=lambda: None))
    monkeypatch.setattr(tcl, "_degrade_fired", False)
    first = tcl.capture_on_perf_degraded(str(tmp_path))
    assert first is not None and first["reason"] == "perf_degraded"
    assert first["dir"] == os.path.join(str(tmp_path), "profiles", "degraded_h0")
    assert tcl.capture_on_perf_degraded(str(tmp_path)) is None  # one shot


def test_the_torch_profiler_capture_writes_a_chrome_trace(tmp_path):
    cap = tcl.ProfilerCapture()
    assert cap.start(str(tmp_path / "prof"), 0.2)["started"]
    x = torch.ones(64, 64)
    for _ in range(300):
        x = x @ x * 1e-2
        if not cap.busy:
            break
        time.sleep(0.01)
    assert cap.last.get("done") is True, cap.last
    with open(tmp_path / "prof" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


# -- the runner's telemetry -----------------------------------------------------------


def test_runner_telemetry_on_equals_off_bit_for_bit(tmp_path):
    states = {}
    prev = tmetrics.enabled()
    try:
        for key, on in (("on", True), ("off", False)):
            telemetry.set_enabled(on)
            model = _model(seed=3)
            runner = pt.ResilientRunner(model, max_time=0.12, run_dir=str(tmp_path / key),
                                        checkpoint_every_s=None, max_chunk_steps=4)
            runner.slo = _calm()
            assert runner.run()["outcome"] == "done"
            states[key] = [t.clone() for t in model.state]
    finally:
        telemetry.set_enabled(prev)
    for a, b in zip(states["on"], states["off"]):
        assert torch.equal(a, b)
    assert os.path.exists(tmp_path / "on" / "metrics.jsonl")
    assert not os.path.exists(tmp_path / "off" / "metrics.jsonl")
    recs = telemetry.read_metrics_jsonl(str(tmp_path / "on" / "metrics.jsonl"))
    assert recs[-1]["snapshot"]["runner_steps_total"]["series"][0]["value"] >= 12


def test_runner_journals_perf_degraded(tmp_path, monkeypatch):
    monkeypatch.setattr(tcl, "CAPTURE", tcl.ProfilerCapture(start_fn=lambda d: None,
                                                            stop_fn=lambda: None))
    monkeypatch.setattr(tcl, "_degrade_fired", False)
    runner = pt.ResilientRunner(_model(seed=4), max_time=0.1, save_intervall=0.01,
                                run_dir=str(tmp_path / "run"), checkpoint_every_s=None)
    seq = iter([0.0, 1.0, 2.0, 3.0, 103.0, 104.0, 105.0, 106.0, 107.0, 108.0])
    runner.slo = tmetrics.ThroughputMonitor(window=4, warmup=2, tolerance=0.5,
                                            min_interval_s=0.0,
                                            clock=lambda: next(seq, 1000.0))
    assert runner.run()["outcome"] == "done"
    events = read_journal(str(tmp_path / "run" / "journal.jsonl"))
    degraded = [e for e in events if e["event"] == "perf_degraded"]
    assert degraded and degraded[0]["ratio"] < 0.5
    captures = [e for e in events if e["event"] == "profile_capture"]
    assert len(captures) == 1 and captures[0]["reason"] == "perf_degraded"


@pytest.mark.parametrize("case", ["divergence", "preempt", "dispatch_hang"])
def test_incidents_dump_the_flight_record(tmp_path, case):
    kw = {"divergence": dict(max_retries=0, fault="nan@4"),
          "preempt": dict(fault="kill@6"),
          "dispatch_hang": dict(fault="slow@4", dispatch_timeout_s=0.3)}[case]
    runner = pt.ResilientRunner(_model(seed=1), max_time=0.5, run_dir=str(tmp_path / "run"),
                                checkpoint_every_s=None, max_chunk_steps=4, **kw)
    runner.slo = _calm()
    if case == "divergence":
        with pytest.raises(pt.DivergenceError):
            runner.run()
    elif case == "dispatch_hang":
        with pytest.raises(pt.DispatchHang):
            runner.run()
    else:
        assert runner.run()["outcome"] == "preempted"
    reason = {"divergence": "DivergenceError"}.get(case, case)
    dumps = [f for f in os.listdir(tmp_path / "run") if f.startswith(f"flight_{reason}")]
    assert dumps, os.listdir(tmp_path / "run")
    with open(tmp_path / "run" / dumps[0]) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]}
    assert "dispatch" in names and "fault_injected" in names
    rows = [e for e in read_journal(str(tmp_path / "run" / "journal.jsonl"))
            if e["event"] == "flight_record"]
    assert rows and rows[0]["reason"] == reason and rows[0]["path"].endswith(dumps[0])


# -- profiling --------------------------------------------------------------------------


def test_profiling_helpers(tmp_path):
    model = _model()
    res = profiling.benchmark_steps(model, 2, warmup=0, reps=1)
    assert res["steps"] == 2 and res["steps_total"] == 2 + 8 + 10
    assert res["ms_per_step"] > 0 and res["steps_per_sec"] == pytest.approx(
        1e3 / res["ms_per_step"])
    ens = pt.NavierEnsemble.from_seeds(model, range(2))
    assert profiling.benchmark_steps(ens, 1, warmup=0, reps=1)["ensemble_size"] == 2
    timer = profiling.StepTimer(sync=model)
    for _ in range(3):
        model.update_n(1)
        timer.tick(1)
    summary = timer.summary()
    assert summary["chunks"] == 3 and summary["steps"] == 3
    assert profiling.StepTimer().summary() == {"chunks": 0}
    with profiling.trace(str(tmp_path / "tr")) as prof:
        model.update_n(1)
    assert prof is not None and os.path.exists(tmp_path / "tr" / "trace.json")
    assert profiling.peak_flops_key() == "cpu" and profiling.peak_flops_key("cpu") == "cpu"
    assert profiling.PEAK_FLOPS["h100_sxm_f64"] == 67e12
    mfu = profiling.mfu_estimate(model, 100.0)
    assert mfu["peak_key"] == "cpu" and mfu["flops_per_step"] == profiling.step_flops(model)
    assert mfu["mfu"] == pytest.approx(mfu["flops_per_step"] * 100.0 / 1e11)


def test_step_flops_counts_the_wrappers():
    fused = _model()
    kernels = fused.kernels()
    launches = [k.launches for ks in kernels.values() for k in ks]
    state = [t.clone() for t in fused.state]
    # a step convects velx, vely and temp, each through its space's instance
    want = sum(st.flops for st in kernels["fused_stage"])
    want += sum(fused._convs[id(getattr(fused, f"{name}_space"))].flops
                for name in ("velx", "vely", "temp"))
    assert profiling.step_flops(fused) == pytest.approx(want, rel=1e-15)
    assert [k.launches for ks in kernels.values() for k in ks] == launches
    assert all(torch.equal(a, b) for a, b in zip(fused.state, state))  # the state is untouched
    ens = pt.NavierEnsemble.from_seeds(fused, range(3))
    assert profiling.step_flops(ens) == 3 * profiling.step_flops(fused)
    dense = _model(step_kernel="dense", conv_kernel="dense")
    banded = profiling.step_flops(dense) - profiling._analytic_step_flops(dense)
    assert banded > 0 and banded < 0.05 * profiling._analytic_step_flops(dense)


def test_analytic_step_flops_matches_jax(monkeypatch):
    import rustpde_mpi_tpu as rp
    from rustpde_mpi_tpu.utils import profiling as jprof

    monkeypatch.setenv("RUSTPDE_FOLDED", "0")  # the port's products are unfolded
    for nx, ny, periodic in ((17, 17, False), (16, 17, True)):
        ref = rp.Navier2D(nx, ny, *PARAMS, periodic=periodic)
        port = pt.Navier2D(nx, ny, *PARAMS, periodic=periodic, device="cpu",
                           step_kernel="dense", conv_kernel="dense")
        assert profiling._analytic_step_flops(port) == jprof._analytic_step_flops(ref)


def test_metrics_are_thread_safe_under_the_runner_threads():
    reg = tmetrics.MetricsRegistry()

    def work():
        for _ in range(500):
            reg.counter("t_total").inc()

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.counter("t_total").value == 2000.0
    assert np.isfinite(reg.snapshot()["t_total"]["series"][0]["value"])

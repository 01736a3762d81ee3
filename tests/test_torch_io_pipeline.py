"""PyTorch port: the overlapped-IO layer, the journal and the metrics
registry, on the CPU.

* futures: ``ObservableFuture``/``MappedFuture``/``immediate``, the
  observables future cached per state and shared with ``get_observables``
  and ``exit_future``;
* ``update_n_pending``: ``resolve()`` gives the synchronous ``update_n``'s
  status, state, time and latch, on a healthy chunk and on a CFL-ceiling
  trip (rolled back), with statistics riding along; ``discard``;
* ``integrate(overlap=True)`` ends at the same state as ``overlap=False``
  (a model, a meshed model, an ensemble), and a poisoned state breaks at
  most one chunk late;
* the async writer: errors re-raised at the next submit or drain, the
  back-pressure window, the timeout; FIFO diagnostics; the callback with a
  pipeline writes what the synchronous callback writes;
* journal lines written by the port are read by the JAX ``read_journal``
  (and the other way round), torn tails and bad lines as the JAX reader
  treats them;
* the metrics registry: the same snapshot keys and values as the JAX
  registry after the same calls, ``delta``, ``merge_snapshots``,
  ``set_enabled`` and ``ThroughputMonitor``.
"""

import gc
import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from rustpde_mpi_tpu.telemetry import metrics as jmetrics
from rustpde_mpi_tpu.utils import journal as jjournal

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.config import IOConfig, StabilityConfig, StatsConfig
from rustpde_mpi_tpu_torch.telemetry import metrics as tmetrics
from rustpde_mpi_tpu_torch.utils import io_pipeline as iop
from rustpde_mpi_tpu_torch.utils import journal as tjournal
from rustpde_mpi_tpu_torch.utils.integrate import integrate


@pytest.fixture(autouse=True, scope="module")
def _gc():
    yield
    gc.collect()


def _model(mesh=False, seed=0):
    where = {"mesh": pt.make_mesh(4, "cpu")} if mesh else {"device": "cpu"}
    model = pt.Navier2D(17, 17, 1e5, 1.0, 1e-2, 1.0, "rbc", **where)
    model.init_random(0.1, seed)
    model.write_intervall = 1e9  # no snapshot files unless a test asks
    return model


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.state, b.state))


# -- futures ------------------------------------------------------------------------


def test_futures_on_the_cpu():
    t = torch.arange(4.0)
    fut = iop.ObservableFuture((t, t * 2), convert=lambda h: float(h[1].sum()))
    t.zero_()  # the future copied the values when it was made
    assert fut.ready() and fut.result() == 12.0 and fut.result() == 12.0
    mapped = iop.MappedFuture(fut, lambda v: v + 1)
    assert mapped.ready() and mapped.result() == 13.0
    done = iop.immediate("x")
    assert done.ready() and done.result() == "x"
    model = _model()
    fut = model.get_observables_async()
    assert model.get_observables_async() is fut  # cached per state
    assert model.get_observables() == fut.result()
    assert model.exit_future().result() is False and model.exit() is False
    model.update_n(2)
    assert model.get_observables_async() is not fut


# -- the deferred sentinel chunk --------------------------------------------------------


@pytest.mark.parametrize("case", ["healthy", "tripped", "stats"])
def test_pending_chunk_resolves_as_update_n(case):
    a, b = _model(), _model()
    cfl = 1e-6 if case == "tripped" else 0.8
    for m in (a, b):
        m.set_stability(StabilityConfig(max_cfl=cfl))
        if case == "stats":
            m.set_stats(StatsConfig(stride=2))
    want = a.update_n(6)
    pending = b.update_n_pending(6)
    assert b.time == pytest.approx(0.06)  # provisional
    got = pending.resolve()
    assert pending.resolve() is got and pending.ready()
    assert got == want and b.last_chunk_status == want
    assert _same(a, b) and a.time == b.time and a.exit() == b.exit()
    assert want.pre_divergence == (case == "tripped")
    if case == "stats":
        assert all(torch.equal(x, y) for x, y in zip(a.stats_state, b.stats_state))
    stale = b.update_n_pending(3)
    stale.discard()
    assert stale.ready()
    with pytest.raises(RuntimeError, match="discarded"):
        stale.resolve()
    with pytest.raises(RuntimeError, match="set_stability"):
        _model().update_n_pending(1)


# -- the overlapped integrate -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["model", "mesh", "ensemble"])
def test_overlap_ends_at_the_same_state(kind, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def build():
        if kind == "ensemble":
            ens = pt.NavierEnsemble.from_seeds(_model(), range(3))
            ens.write_intervall = 1e9
            return ens
        return _model(mesh=kind == "mesh")

    a, b = build(), build()
    calls = []
    assert integrate(a, 0.15, 0.05) == "time_limit"
    assert integrate(b, 0.15, 0.05, overlap=True,
                     on_chunk=lambda pde: calls.append(pde.time) and False) == "time_limit"
    assert _same(a, b) and a.time == b.time
    assert len(calls) == 2  # the last boundary ends the run before the hook
    b.io_overlap = True
    assert integrate(b, 0.2, dispatch=lambda pde, n: pde.update_n(n)) == "time_limit"


def test_overlap_breaks_at_most_one_chunk_late(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for overlap in (False, True):
        model = _model()
        chunks = []

        def dispatch(pde, n, chunks=chunks):
            pde.update_n(n)
            chunks.append(pde.time)
            if len(chunks) == 2:
                pde.state = type(pde.state)(*(f * float("nan") for f in pde.state))

        assert integrate(model, 1.0, 0.05, dispatch=dispatch, overlap=overlap) == "break"
        assert len(chunks) <= 2 + overlap
    model = _model()
    model.state = type(model.state)(*(f * float("nan") for f in model.state))
    assert integrate(model, 0.05, 0.05, overlap=True) == "break"  # the last chunk is judged


def test_stop_hook_and_statuses(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = _model()
    assert integrate(model, 1.0, 0.05, on_chunk=lambda pde: True) == "stopped"
    assert model.time == pytest.approx(0.05)


# -- the async writer and the diagnostics queue -----------------------------------------


def test_writer_reraises_at_the_next_submit_and_drain():
    writer = iop.AsyncCheckpointWriter(depth=1)
    done = []
    writer.submit(lambda: done.append(1), "a", nbytes=8)

    def boom():
        raise OSError("disk full")

    writer.submit(boom, "b")
    writer.drain(raise_errors=False)
    with pytest.raises(iop.AsyncWriteError, match="disk full") as err:
        writer.submit(lambda: done.append(2), "c")
    assert err.value.path == "b" and isinstance(err.value.__cause__, OSError)
    writer.submit(boom, "d")
    with pytest.raises(iop.AsyncWriteError, match="'d'"):
        writer.drain()
    assert done == [1] and writer.writes == 3 and writer.bytes == 8
    writer.submit(boom, "e")
    writer.drain(raise_errors=False)
    assert writer.pending_errors() and len(writer.consume_errors()) == 1
    assert not writer.pending_errors()
    writer.close()


def test_writer_back_pressure_and_timeout():
    gate = threading.Event()
    writer = iop.AsyncCheckpointWriter(depth=1, timeout_s=0.2)
    writer.submit(gate.wait, "slow")
    with pytest.raises(iop.AsyncWriteError, match="back-pressure"):
        writer.submit(lambda: None, "next")
    gate.set()
    writer.drain()
    ticket = writer.submit(lambda: time.sleep(0.01), "ok")
    ticket.wait()
    assert ticket.done()
    writer.close()
    pipe = IOConfig(queue_depth=2, diag_lag=1, timeout_s=5.0).pipeline()
    assert pipe.writer.depth == 2 and pipe.writer.timeout_s == 5.0 and pipe.diag_lag == 1
    assert IOConfig.blocking().diag_lag == 0
    with pytest.raises(NotImplementedError, match="17.2"):
        IOConfig(sharded_checkpoints=True)


class _Slow:
    """A future that becomes ready when told to."""

    def __init__(self, value):
        self.value, self.done = value, False

    def ready(self):
        return self.done

    def result(self):
        return self.value


def test_diagnostics_are_fifo_and_lag_at_most_diag_lag():
    pipe = iop.IOPipeline(diag_lag=1)
    out = []
    first, second, third = _Slow(1), _Slow(2), _Slow(3)
    pipe.push_diag(out.append, first)
    assert out == []  # young enough to wait
    pipe.push_diag(out.append, second)
    assert out == [1]  # the lag forced the oldest out, in order
    third.done = True
    pipe.push_diag(out.append, third)
    assert out == [1, 2, 3]
    pipe.push_diag(out.append, _Slow(4))
    assert pipe.abandon_diags() == 1 and pipe.stats()["dropped_diags"] == 1
    pipe.push_diag(out.append, _Slow(5))
    pipe.drain()
    assert out == [1, 2, 3, 5] and pipe.stats()["pending_diags"] == 0
    pipe.close()


@pytest.mark.parametrize("kind", ["model", "ensemble"])
def test_callback_through_the_pipeline_writes_what_the_synchronous_one_does(
        kind, tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    outs = {}
    for mode in ("sync", "pipeline"):
        work = tmp_path / mode
        work.mkdir()
        monkeypatch.chdir(work)
        model = _model()
        pde = pt.NavierEnsemble.from_seeds(model, range(2)) if kind == "ensemble" else model
        pde.write_intervall = None
        if mode == "pipeline":
            pde.io_pipeline = iop.IOPipeline(diag_lag=1)
        integrate(pde, 0.1, 0.05, overlap=mode == "pipeline")
        if mode == "pipeline":
            pde.io_pipeline.drain()
            stats = pde.io_pipeline.stats()
            assert stats["writes"] == 2 and stats["bytes"] > 0
            pde.io_pipeline.close()
        files = sorted(os.listdir(work / "data"))
        outs[mode] = (files, pde.diagnostics)
        if kind == "model":
            outs[mode] += ((work / "data" / "info.txt").read_text(),)
    assert outs["sync"][0] == outs["pipeline"][0]
    assert outs["sync"][1:] == outs["pipeline"][1:]


# -- the journal ----------------------------------------------------------------------------


def test_journal_crosses_packages(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    writer = tjournal.JournalWriter(path)
    writer.append({"event": "chunk", "step": 1})
    writer.append({"event": "stats_write_failed", "t": 5.0})
    writer.close()
    rows = jjournal.read_journal(path)
    assert [r["event"] for r in rows] == ["chunk", "stats_write_failed"]
    assert rows[1]["t"] == 5.0 and "t" in rows[0]
    jw = jjournal.JournalWriter(path)
    jw.append({"event": "from_jax"})
    jw.close()
    assert tjournal.read_journal(path) == jjournal.read_journal(path)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"event": "torn"')
    assert tjournal.read_journal(path) == jjournal.read_journal(path) == rows + [
        jjournal.read_journal(path)[-1]]
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w", encoding="utf-8") as fh:
        fh.write('{"a": 1}\nnot json\n{"b": 2}\n')
    with pytest.raises(tjournal.JournalError):
        tjournal.read_journal(bad)
    assert tjournal.read_journal(bad, on_error="skip") == \
        jjournal.read_journal(bad, on_error="skip")
    assert tjournal.read_journal(str(tmp_path / "none.jsonl")) == []
    model = _model()
    path = str(tmp_path / "model.jsonl")
    model.journal_writer = tjournal.JournalWriter(path)
    from rustpde_mpi_tpu_torch.models.stats import report_stats_event

    tmetrics.REGISTRY.clear()
    report_stats_event(model, {"event": "stats_write_failed", "path": "x"})
    model.journal_writer.close()
    assert jjournal.read_journal(path)[-1]["event"] == "stats_write_failed"
    assert tmetrics.snapshot()["stats_write_failed_total"]["series"][0]["value"] == 1.0
    tmetrics.REGISTRY.clear()


# -- the metrics registry --------------------------------------------------------------------


def _exercise(mod, reg):
    reg.counter("io_writes_total", "writes", route="fused").inc()
    reg.counter("io_writes_total", "writes", route="fused").inc(2.5)
    reg.counter("io_writes_total", "writes", route="dense").inc()
    reg.gauge("queue_depth", "depth").set(3)
    reg.gauge("queue_depth", "depth").dec(0.5)
    hist = reg.histogram("chunk_seconds", "s")
    for v in (0.001, 0.02, 0.02, 0.5, 0.0, float("nan"), 3.0):
        hist.observe(v)
    with pytest.raises(ValueError):
        reg.gauge("io_writes_total")
    with pytest.raises(ValueError):
        reg.counter("io_writes_total").inc(-1)
    return reg.snapshot()


def test_metrics_match_jax():
    port = _exercise(tmetrics, tmetrics.MetricsRegistry())
    ref = _exercise(jmetrics, jmetrics.MetricsRegistry())
    assert port == ref
    preg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _exercise(tmetrics, preg)
    _exercise(jmetrics, jreg)
    prev_p, prev_j = preg.snapshot(), jreg.snapshot()
    preg.counter("io_writes_total", "writes", route="fused").inc(4)
    jreg.counter("io_writes_total", "writes", route="fused").inc(4)
    assert preg.delta(prev_p) == jreg.delta(prev_j)
    assert tmetrics.merge_snapshots([port, port]) == jmetrics.merge_snapshots([ref, ref])
    assert tmetrics.gather_global_snapshot(preg) == preg.snapshot()
    h = tmetrics.Histogram()
    for v in (1, 2, 3, 4, 100):
        h.observe(v)
    j = jmetrics.Histogram()
    for v in (1, 2, 3, 4, 100):
        j.observe(v)
    assert [h.quantile(q) for q in (0.0, 0.5, 0.9, 1.0)] == [j.quantile(q) for q in
                                                             (0.0, 0.5, 0.9, 1.0)]
    assert h.buckets() == j.buckets() and math.isclose(h.mean, j.mean)


def test_metrics_off_switch_and_writer_counters():
    tmetrics.REGISTRY.clear()
    try:
        tmetrics.set_enabled(False)
        assert not tmetrics.enabled()
        tmetrics.counter("x").inc()
        assert tmetrics.snapshot() == {}
    finally:
        tmetrics.set_enabled(True)
    writer = iop.AsyncCheckpointWriter()
    writer.submit(lambda: None, "p", nbytes=100)
    writer.drain()
    writer.close()
    snap = tmetrics.snapshot()
    assert snap["io_writes_total"]["series"][0]["value"] >= 1
    assert snap["io_bytes_total"]["series"][0]["value"] >= 100
    tmetrics.REGISTRY.clear()


def test_throughput_monitor_matches_jax():
    now = [0.0]

    def clock():
        return now[0]

    port = tmetrics.ThroughputMonitor(window=4, warmup=2, tolerance=0.5, min_interval_s=0.0,
                                      clock=clock)
    ref = jmetrics.ThroughputMonitor(window=4, warmup=2, tolerance=0.5, min_interval_s=0.0,
                                     clock=clock)
    for steps, dt in [(0, 0.0), (10, 1.0), (10, 1.0), (10, 1.0), (10, 5.0), (10, 1.0)]:
        now[0] += dt
        assert port.record(steps) == ref.record(steps)
    assert port.events == ref.events == 1 and np.isclose(port.baseline, ref.baseline)

"""The serving layer's host-side groundwork of the port against the JAX
package's: request validation and compatibility keys, the durable queue's
rows (each package reads the other's queue directory), the request trace
assembled from a journal and campaign trace files, and parked
continuations written by either package.  Everything here is host data:
the comparisons are exact."""

import gc
import json
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpde_mpi_tpu.serve.queue import DurableQueue as JaxQueue
from rustpde_mpi_tpu.serve.request import SimRequest as JaxRequest
from rustpde_mpi_tpu.models.navier import NavierState as JaxState
from rustpde_mpi_tpu.telemetry import reqtrace as jrt
from rustpde_mpi_tpu.utils import checkpoint as jck

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.models.navier import NavierState
from rustpde_mpi_tpu_torch.serve import (AdmissionError, DurableQueue, RequestError,
                                         SimRequest, priority_rank)
from rustpde_mpi_tpu_torch.telemetry import reqtrace as trt
from rustpde_mpi_tpu_torch.utils import checkpoint as tck
from rustpde_mpi_tpu_torch.utils.journal import JournalWriter

REQUESTS = [
    dict(ra=1e4, horizon=1.0),
    dict(ra=1e7, horizon=0.5, nx=257, ny=257, dt=1e-3, bc="hc", periodic=True),
    dict(ra=2e3, horizon=2.0, model="lnse"),
    dict(ra=1e5, horizon=1.0, scenario={"coriolis": 2.0, "passive_scalar": True}),
    dict(ra=1e5, horizon=1.0, submesh=4, priority="interactive", tenant="t1", deadline_s=30.0),
    dict(ra=1e5, horizon=1.0, idempotency_key="k-1"),
    # malformed: each raises RequestError in both packages
    dict(ra=1e4, horizon=1.0, bc="xx"),
    dict(ra=1e4, horizon=1.0, nx=3),
    dict(ra=1e4, horizon=0.0),
    dict(ra=-1.0, horizon=1.0),
    dict(ra=1e4, horizon=1.0, dt=0.0),
    dict(ra=1e4, horizon=1.0, priority="urgent"),
    dict(ra=1e4, horizon=1.0, tenant=""),
    dict(ra=1e4, horizon=1.0, deadline_s=-1.0),
    dict(ra=1e4, horizon=1.0, submesh=-2),
    dict(ra=1e4, horizon=1.0, idempotency_key="  "),
    dict(ra=1e4, horizon=1.0, model="nope"),
    dict(ra=1e4, horizon=1.0, model="lnse", scenario={"coriolis": 1.0}),
    dict(ra=1e4, horizon=1.0, scenario={"wind": 1.0}),
    dict(ra=1e4, horizon=1.0, scenario={"coriolis": "fast"}),
]


def _outcome(cls, kw):
    req = cls(**kw)
    try:
        req.validate()
    except Exception as exc:  # the type name and message are compared
        return type(exc).__name__, str(exc)
    return "ok", req.compat_key, req.steps, req.steps_remaining, req.class_rank


@pytest.mark.parametrize("kw", REQUESTS, ids=[str(i) for i in range(len(REQUESTS))])
def test_request_validation_and_compat_key_as_jax(kw):
    assert _outcome(SimRequest, kw) == _outcome(JaxRequest, kw)


def test_request_copies_and_json_as_jax():
    kw = dict(ra=1e5, horizon=1.0, dt=2e-3, submesh=2, id="abc", submitted_s=10.0)
    t, j = SimRequest(**kw), JaxRequest(**kw)
    for a, b in ((t.backed_off(0.5), j.backed_off(0.5)), (t.rebucketed(5e-4, 7),
                                                            j.rebucketed(5e-4, 7))):
        assert (a.dt, a.dts, a.retries, a.progress, a.compat_key) == \
            (b.dt, b.dts, b.retries, b.progress, b.compat_key)
    back = SimRequest.from_json(j.to_json())
    assert back.compat_key == j.compat_key and back.trace == j.trace
    assert JaxRequest.from_json(t.to_json()).trace == t.trace
    with pytest.raises(RequestError, match="unknown request fields"):
        SimRequest.from_dict({"ra": 1.0, "horizon": 1.0, "bogus": 1})
    assert t.trace_id and len(t.trace["trace_id"]) == 16
    assert [priority_rank(p) for p in ("interactive", "batch", "best-effort", "x")] == [0, 1, 2, 3]
    assert t.deadline_slack(0.0) == float("inf")


def test_durable_queue_rows_read_by_either_package(tmp_path):
    root = str(tmp_path / "queue")
    tq, jq = DurableQueue(root, max_queue=4), JaxQueue(root, max_queue=4)
    a = tq.submit(SimRequest(ra=1e4, horizon=1.0, nx=17, ny=17))
    b = jq.submit(JaxRequest(ra=2e4, horizon=1.0, nx=17, ny=17))
    c = tq.submit(SimRequest(ra=1e4, horizon=1.0, nx=17, ny=17, idempotency_key="same"))
    dup = jq.submit(JaxRequest(ra=1e4, horizon=1.0, nx=17, ny=17, idempotency_key="same"))
    assert getattr(dup, "deduped", False) and dup.id == c.id
    for q in (tq, jq):
        q.invalidate()
        assert q.counts() == {"queued": 3, "running": 0, "done": 0, "failed": 0}
        assert q.bucket_order() == [a.compat_key, b.compat_key]
    first = jq.claim(key=a.compat_key)  # the JAX queue claims the port's row
    assert first.id == a.id
    second = tq.claim()  # and the port the JAX one's
    assert second.id == b.id and second.compat_key == b.compat_key
    jq.invalidate()
    tq.complete(second, {"nu": 1.5})  # ack
    jq.requeue(first.backed_off(0.5))  # a retry row, re-enqueued
    tq.invalidate()
    third = tq.claim(key=first.backed_off(0.5).compat_key)
    assert third.id == a.id and third.retries == 1 and third.dts == [2e-3, 1e-3]
    jq.fail(JaxRequest.from_json(third.to_json()), "diverged")
    assert tq.lookup(b.id)[0] == "done" and jq.lookup(b.id)[1]["result"] == {"nu": 1.5}
    assert jq.lookup(a.id)[0] == tq.lookup(a.id)[0] == "failed"
    running = tq.claim()
    assert running.id == c.id
    assert jq.recover() == [c.id]  # a crashed claim goes back on the queue
    tq.invalidate()
    assert tq.counts() == jq.counts() == {"queued": 1, "running": 0, "done": 1, "failed": 1}
    with pytest.raises(AdmissionError, match="draining"):
        tq.submit(SimRequest(ra=1e4, horizon=1.0), admit_open=False)
    with open(os.path.join(root, "done", f"{b.id}.json")) as fh:
        assert json.load(fh)["request"]["trace"] == b.trace


def test_lookup_follows_a_record_moved_while_it_is_read(tmp_path, monkeypatch):
    """A fleet replica settles a running request (``running/`` -> ``done/``)
    between a proxy's look at ``running/`` and its read of the file: the
    lookup finds it done, as it found it in ``running/`` before the move."""
    import builtins

    from rustpde_mpi_tpu_torch.serve import queue as tqueue

    q = DurableQueue(str(tmp_path / "queue"))
    req = q.submit(SimRequest(ra=1e4, horizon=1.0, nx=17, ny=17))
    claimed = q.claim()
    assert q.lookup(req.id)[0] == "running"
    running = os.path.join(q._dir("running"), f"{req.id}.json")
    real_open = builtins.open

    def settling_open(path, *a, **kw):
        if path == running and os.path.exists(running):
            q.complete(claimed, {"nu": 2.0})  # the peer's settle, just before the read
        return real_open(path, *a, **kw)

    monkeypatch.setattr(tqueue, "open", settling_open, raising=False)
    state, record = q.lookup(req.id)
    assert state == "done" and record["result"] == {"nu": 2.0}


def test_a_request_trace_is_assembled_from_a_journal(tmp_path):
    """The lifecycle rows of a journal and a campaign's chunk spans make the
    same Perfetto payload in both packages."""
    run_dir = str(tmp_path)
    req = SimRequest(ra=1e4, horizon=1.0, id="r1")
    tid = req.trace_id
    writer = JournalWriter(os.path.join(run_dir, "journal.jsonl"))
    for i, event in enumerate(("server_start", "request_admitted", "request_scheduled",
                               "request_requeued", "request_scheduled", "request_done")):
        writer.append({"event": event, "id": "r1", "trace_id": tid, "t": 100.0 + i,
                       "wall_s": float(i)})
    writer.close()
    trt.LOG.drain()
    trt.chunk_span(tid, 101.5, 0.25, slot=0, steps=10)
    trt.instant(tid, "rebucket", dt=1e-3)
    campaign = os.path.join(run_dir, "campaigns", "c0")
    path = trt.write_campaign_trace(campaign, "c0")
    assert path is not None and os.path.basename(path) == "trace_0000.json"
    want = jrt.assemble_request_trace(run_dir, "r1")
    got = trt.assemble_request_trace(run_dir, "r1")
    assert got == want and got["otherData"]["trace_id"] == tid
    names = [e["name"] for e in got["traceEvents"]]
    assert names.count("chunk") == 1 and names.count("queued") == 2 and "running" in names
    assert trt.assemble_request_trace(run_dir, "nope") is None
    assert trt.assemble_fleet_request_trace(run_dir, "r1") == \
        jrt.assemble_fleet_request_trace(run_dir, "r1")
    trt.bind_slots({0: tid})
    assert trt.active_ids() == [tid]
    trt.clear_active()


def _states(seed):
    rng = np.random.default_rng(seed)
    arrays = {k: rng.standard_normal((15, 15)) for k in NavierState._fields}
    return (NavierState(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()}),
            JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}), arrays)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_continuations_round_trip_across_the_packages(tmp_path, writer):
    tstate, jstate, arrays = _states(3)
    cont = tck.continuation_dir(str(tmp_path), "req-9")
    assert cont == jck.continuation_dir(str(tmp_path), "req-9")
    meta = {"request": "req-9", "submesh": 2}
    if writer == "port":
        tck.write_continuation(cont, tstate, base=40, time_base=0.4, meta=meta)
    else:
        jck.write_continuation(cont, jstate, base=40, time_base=0.4, meta=meta)
    for mod in (tck, jck):
        assert mod.continuation_exists(cont) and mod.continuation_meta(cont) == (40, 0.4)
        assert mod.continuation_record(cont)["meta"] == meta
    got, base, time_base = tck.read_continuation(cont, _states(4)[0])
    assert (base, time_base) == (40, 0.4)
    for k in NavierState._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(), arrays[k])
    jgot, _, _ = jck.read_continuation(cont, _states(5)[1])
    for k in NavierState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jgot, k)), arrays[k])
    with pytest.raises(tck.CheckpointError, match="continuation"):
        tck.read_continuation(cont, NavierState(*(t[:3] for t in tstate)))
    with h5py.File(os.path.join(cont, "shard_00000.h5"), "r+") as h5:
        h5["state/temp"][0, 0] += 1.0  # bit rot: the stamp no longer matches
    with pytest.raises(tck.CheckpointError, match="content mismatch"):
        tck.read_continuation(cont, tstate)
    tck.remove_continuation(cont)
    assert not os.path.exists(cont) and tck.continuation_meta(cont) is None
    with pytest.raises(tck.CheckpointError, match="no committed continuation"):
        tck.read_continuation(cont, tstate)
    gc.collect()


def test_the_new_names_are_exported():
    assert pt.SimRequest is SimRequest and pt.RequestFailed and pt.AdmissionError
    assert pt.telemetry.mint_trace_context()["trace_id"]

"""One process of a two-process job of the port, for the CPU tests
(``tests/test_torch_multihost.py``, ``tests/test_torch_sharded_ckpt.py``,
``tests/test_torch_serve.py``).

    python tests/torch_mp_worker.py <port> <rank> <nproc> <out_dir> <mode> [arg]

Each process joins a gloo group at ``localhost:<port>``, runs ``mode`` and
writes ``<out_dir>/result_<rank>.json``; the parent (:func:`spawn`) checks
the exit codes and kills any process still alive at its deadline.  The
worker imports the port only (no JAX), on the CPU, one thread.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(out_dir: str, mode: str, arg: str = "", nproc: int = 2, timeout: float = 60.0):
    """Run ``nproc`` workers as one job; returns ``[(rc, stdout, stderr,
    result or None), ...]`` in rank order.  A worker still alive at the
    deadline is killed (its rc is then negative); none outlives the call."""
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(_REPO, "tests", "torch_mp_worker.py"),
                               str(port), str(i), str(nproc), out_dir, mode, arg],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=_REPO)
             for i in range(nproc)]
    t_end = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(0.1, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for i, (rc, out, err) in enumerate(outs):
        path = os.path.join(out_dir, f"result_{i}.json")
        res = None
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                res = json.load(fh)
        results.append((rc, out, err, res))
    return results


# -- the worker side -------------------------------------------------------------------


def _model(nx=17, ny=17, dt=0.01):
    import rustpde_mpi_tpu_torch as pt

    model = pt.Navier2D(nx, ny, 1e4, 1.0, dt, 1.0, "rbc", device="cpu")
    model.set_velocity(0.1, 1.0, 1.0)
    model.set_temperature(0.1, 1.0, 1.0)
    model.write_intervall = 1e9
    return model


def mode_collectives(mh, rank, arg):
    """broadcast_obj with tuples, allgather_bytes of unequal lengths,
    root_decides, allgather_host, broadcast from another source."""
    obj = {"key": ("dns", 17, (1.5, "rbc")), "n": 3} if rank == 0 else None
    got = mh.broadcast_obj(obj)
    blobs = mh.allgather_bytes(b"p" * (3 + 5 * rank))
    return {
        "obj": got,
        "key": list(map(repr, mh.tuplify(got["key"]))),
        "key_is_tuple": isinstance(mh.tuplify(got["key"]), tuple),
        "blobs": [b.decode() for b in blobs],
        "flag_on_1": mh.root_decides(rank == 1),
        "flag_on_0": mh.root_decides(rank == 0),
        "gathered": mh.allgather_host(np.int64(10 + rank)).tolist(),
        "from_1": int(mh.broadcast(np.int32(100 + rank), is_source=rank == 1)),
        "devices": [str(d) for d in mh.global_devices("cpu")],
        **_telemetry(rank),
    }


def _telemetry(rank):
    """The fleet's metrics snapshot gathered over both processes, the
    metrics file's per-process name, the compile log's capture directory."""
    from rustpde_mpi_tpu_torch import telemetry
    from rustpde_mpi_tpu_torch.telemetry.exporters import MetricsDumper

    telemetry.counter("mp_test_total", "a test counter").inc(1 + rank)
    snap = telemetry.gather_global_snapshot()
    fam = snap["mp_test_total"]["series"][0]
    return {"merged_counter": fam["value"],
            "metrics_file": os.path.basename(MetricsDumper("run/metrics.jsonl").path)}


def mode_card_root_decides(mh, rank, arg):
    """Each process raises a flag computed on the card; the root's wins."""
    import torch

    flag = torch.full((4,), float(rank), device="cuda").sum() > 0  # rank 1's only
    return {"flag_on_1": mh.root_decides(bool(flag)), "flag_on_0": mh.root_decides(not flag),
            "on_card": flag.device.type == "cuda"}


def mode_dead_peer(mh, rank, arg):
    """Rank 1 leaves (``exited``: at once; ``wedged``: alive, never at the
    barrier); rank 0's barrier must raise DispatchHang within its deadline."""
    from rustpde_mpi_tpu_torch.utils.resilience import DispatchHang

    if rank == 1:
        if arg == "wedged":
            time.sleep(4.0)
        os._exit(0)
    t0 = time.monotonic()
    try:
        mh.sync_hosts("peer-check", timeout_s=1.5)
    except DispatchHang as exc:
        return {"hang": True, "label": exc.label, "seconds": time.monotonic() - t0}
    return {"hang": False}


def mode_sanitizer(mh, rank, arg):
    """A clean armed run that does not trip, then ``skip_broadcast@2:host1``:
    every process must raise CollectiveDesyncError within one cadence."""
    from rustpde_mpi_tpu_torch.parallel import sanitizer as san

    def rounds(n):
        for i in range(n):
            mh.broadcast(np.int64(i))  # site A
            mh.root_decides(i % 2 == 0)  # site B
            mh.allgather_host(np.float64(i))  # site C

    san.configure(enabled=True, cadence=4, ring=64, inject="")
    rounds(8)
    clean = san.stats()
    # the skipped call and its successors are broadcasts of one shape, so
    # the transport stays paired while the recorded call sites diverge
    san.configure(enabled=True, cadence=4, ring=64, inject="skip_broadcast@2:host1")
    raised, site, seq, executed = None, None, None, None
    try:
        for i in range(8):
            mh.broadcast(np.int64(i))  # site D
            mh.broadcast(np.int64(-i))  # site E
    except san.CollectiveDesyncError as exc:
        raised, site, seq, executed = str(exc), exc.site, exc.seq, san.stats()["executed"]
    san.configure(enabled=False, inject="")
    return {"clean": clean, "raised": raised, "site": site, "seq": seq,
            "executed_at_raise": executed}


def mode_paired_apart(mh, rank, arg):
    """Calls that differ paired at the transport: a ``root_decides`` against
    a ``sync_hosts`` (disarmed, then armed) and allgathers of two shapes;
    each must raise the desync on both processes at that exchange, after
    which the processes are still paired for the next case."""
    from rustpde_mpi_tpu_torch.parallel import sanitizer as san

    mh.set_sync_timeout(20.0)
    cases = {
        "kinds_disarmed": (False, lambda: mh.root_decides(True) if rank == 0
                           else mh.sync_hosts("apart")),
        "kinds_armed": (True, lambda: mh.root_decides(True) if rank == 0
                        else mh.sync_hosts("apart")),
        "shapes": (False, lambda: mh.allgather_host(np.zeros(2 + rank))),
    }
    out = {}
    for name, (armed, call) in cases.items():
        san.configure(enabled=armed, cadence=100, inject="")
        try:
            call()
            out[name] = None
        except san.CollectiveDesyncError as exc:
            out[name] = {"message": str(exc), "seq": exc.seq}
    out["after"] = mh.allgather_host(np.int64(rank)).tolist()
    san.configure(enabled=False)
    return out


def mode_runner_skip(mh, rank, arg):
    """The runner in two processes, the sanitizer armed at cadence 8 and
    ``skip_broadcast@5:host1`` (``chip_smoke.py`` phase 33's desync at
    17^2); ``arg`` the run's length.  Both must raise the desync."""
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.parallel import sanitizer as san

    mh.set_sync_timeout(20.0)
    san.configure(enabled=True, cadence=8, inject="skip_broadcast@5:host1")
    out_dir = sys.argv[4]
    runner = pt.ResilientRunner(_model(), max_time=float(arg), save_intervall=0.05,
                                run_dir=os.path.join(out_dir, "run"), checkpoint_every_s=None)
    try:
        runner.run()
        return {"desync": None}
    except san.CollectiveDesyncError as exc:
        return {"desync": {"seq": exc.seq, "site": exc.site, "message": str(exc),
                           "executed": san.stats()["executed"]}}
    finally:
        san.configure(enabled=False, inject="")


def mode_runner_stop(mh, rank, arg):
    """The runner in two processes; rank ``arg`` alone asks for a stop at
    step 10: rank 0's request stops both at the same step, rank 1's is
    ignored and the run completes."""
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.parallel import sanitizer as san

    san.configure(enabled=True, cadence=8)
    out_dir = sys.argv[4]
    runner = pt.ResilientRunner(_model(), max_time=0.2, save_intervall=0.05,
                                run_dir=os.path.join(out_dir, "run"), checkpoint_every_s=None)
    dispatch = runner._dispatch

    def hooked(pde, n):  # the request arrives while the chunk runs
        dispatch(pde, n)
        if runner.step >= 10 and rank == int(arg):
            runner.request_drain()

    runner._dispatch = hooked
    summary = runner.run()
    return {"outcome": summary["outcome"], "step": summary["step"],
            "verifies": san.stats()["verifies"], "desyncs": san.stats()["desyncs"]}


def mode_host_fault(mh, rank, arg):
    """A fault scoped to rank 1 alone: ``spike`` under the governor (its
    sentinel status goes through the reduction across processes) or
    ``bitflip`` under the integrity audits (a mismatch on one replica rolls
    both back).  Both replicas must take the same verdicts: the same step,
    dt and outcome, no desync."""
    import hashlib

    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.config import IntegrityConfig, StabilityConfig
    from rustpde_mpi_tpu_torch.parallel import sanitizer as san
    from rustpde_mpi_tpu_torch.telemetry.metrics import ThroughputMonitor
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    san.configure(enabled=True, cadence=4)
    mh.set_sync_timeout(20.0)
    out_dir = sys.argv[4]
    model = _model()
    if arg == "spike":
        probe = _model()
        probe.set_stability(StabilityConfig())
        factor = 3.0 / probe.update_n(4).cfl_max  # 3x the ceiling
        kw = dict(max_time=0.12, save_intervall=None, fault="spike@4:host1", spike_factor=factor,
                  stability=StabilityConfig(grow_after=100), max_chunk_steps=2, max_retries=2)
    else:
        model.set_integrity(IntegrityConfig(cadence=1))
        kw = dict(max_time=0.2, save_intervall=0.05, fault="bitflip@10:host1")
    run_dir = os.path.join(out_dir, "run")
    runner = pt.ResilientRunner(model, run_dir=run_dir, checkpoint_every_s=None, **kw)
    runner.slo = ThroughputMonitor(warmup=10**9)
    summary = runner.run()
    digest = hashlib.sha256(b"".join(t.numpy().tobytes() for t in model.state)).hexdigest()
    events = [] if rank else [
        {k: e[k] for k in ("event", "check", "processes", "dt", "host", "leaf") if k in e}
        for e in read_journal(os.path.join(run_dir, "journal.jsonl"))
        if e["event"] in ("fault_injected", "bitflip_injected", "pre_divergence", "dt_adjust",
                          "integrity_mismatch", "integrity_rollback", "divergence")]
    return {"outcome": summary["outcome"], "step": summary["step"], "dt": summary["dt"],
            "digest": digest, "events": events, "desyncs": san.stats()["desyncs"],
            "verifies": san.stats()["verifies"]}


def mode_sharded_run(mh, rank, arg):
    """A 20-step sharded run with a cadence checkpoint every 5 steps; ``arg``
    the shard crash spec (empty: none).  Rank 0 dumps the final state."""
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.parallel import sanitizer as san

    san.configure(enabled=True, cadence=8)
    mh.set_sync_timeout(20.0)
    out_dir = sys.argv[4]
    model = _model()
    runner = pt.ResilientRunner(model, max_time=0.2, save_intervall=0.05,
                                run_dir=os.path.join(out_dir, "run"), checkpoint_every_s=None,
                                checkpoint_every_t=0.05, shard_crash=arg or None)
    summary = runner.run()
    if rank == 0:
        np.savez(os.path.join(out_dir, "final_state.npz"),
                 **{k: v.numpy() for k, v in zip(model.state._fields, model.state)},
                 time=model.time)
    return {"outcome": summary["outcome"], "step": summary["step"],
            "checkpoint": summary["checkpoint"], "resumed": runner.resumed,
            "desyncs": san.stats()["desyncs"]}


def _served(rank, reqs, **cfg_kw):
    """Serve ``reqs`` (submitted on the root) with a ``SimServer`` on every
    process at once; the root returns the summary, each request's result
    and the journal's event types."""
    from rustpde_mpi_tpu_torch.config import ServeConfig
    from rustpde_mpi_tpu_torch.serve import SimServer
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    out_dir = sys.argv[4]
    cfg = ServeConfig(run_dir=os.path.join(out_dir, "serve"), chunk_steps=4,
                      checkpoint_every_s=None, http_port=None, **cfg_kw)
    srv = SimServer(cfg, device="cpu")
    ids = [srv.submit(r).id for r in reqs] if rank == 0 else []
    summary = srv.serve()
    if rank != 0:
        return {"outcome": summary["outcome"]}
    events = [e["event"] for e in read_journal(os.path.join(cfg.run_dir, "journal.jsonl"))
              if e["event"] not in ("perf_degraded", "profile_capture")]
    return {"outcome": summary["outcome"], "completed": summary["completed"],
            "processes": summary["slots"]["process_count"],
            "results": [srv.result(i) for i in ids], "events": events}


SERVE_REQ = dict(ra=1e4, pr=1.0, nx=17, ny=17, dt=0.01, bc="rbc")


def mode_serve_campaign(mh, rank, arg):
    """Two processes serve five 17^2 requests through two lanes: the root
    decides every boundary and broadcasts it, every process steps its own
    replica of the campaign."""
    mh.set_sync_timeout(30.0)
    reqs = [dict(SERVE_REQ, horizon=0.08 + (s % 3) * 0.02, seed=s) for s in range(5)]
    return _served(rank, reqs, slots=2)


def mode_gang_serve(mh, rank, arg):
    """Two processes, a 34^2 request stamped for a 2-slot sub-mesh (a gang:
    one rank slot of each process, each process a 2-rank replica of the
    gang's model on its device) beside two unstamped 18^2 requests."""
    from rustpde_mpi_tpu_torch.config import SubmeshConfig

    mh.set_sync_timeout(30.0)
    reqs = [dict(SERVE_REQ, nx=34, ny=34, horizon=0.08, seed=100)] + \
        [dict(SERVE_REQ, nx=18, ny=18, horizon=0.06, seed=s) for s in range(2)]
    return _served(rank, reqs, slots=2, submesh=SubmeshConfig(shapes=(2,), shard_min_nx=34))


def main():
    port, rank, nproc, out_dir, mode = sys.argv[1:6]
    arg = sys.argv[6] if len(sys.argv) > 6 else ""
    rank, nproc = int(rank), int(nproc)
    sys.path.insert(0, _REPO)
    import torch

    torch.set_num_threads(1)
    from rustpde_mpi_tpu_torch.parallel import multihost as mh

    assert mh.initialize_distributed(f"localhost:{port}", nproc, rank, timeout_s=60.0)
    result = globals()[f"mode_{mode}"](mh, rank, arg)
    with open(os.path.join(out_dir, f"result_{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(result, fh)
    sys.stdout.flush()
    # leave without the group's teardown handshake: a peer may be gone
    os._exit(0)


if __name__ == "__main__":
    main()

"""One process of a two-process job of the port, for the CPU tests
(``tests/test_torch_multihost.py``, ``tests/test_torch_sharded_ckpt.py``,
``tests/test_torch_serve.py``, ``tests/test_torch_spanning_mesh.py``,
``tests/test_torch_spanning_paths.py``, ``tests/test_torch_lnse.py``,
``tests/test_torch_host_exchange.py``) and the card tests of
``tests/test_torch_cuda.py``.

    python tests/torch_mp_worker.py <port> <rank> <nproc> <out_dir> <mode> [arg]

Each process joins a gloo group at ``localhost:<port>``, runs ``mode`` and
writes ``<out_dir>/result_<rank>.json``; the parent (:func:`spawn`) checks
the exit codes and kills any process still alive at its deadline.  An
``arg`` that names :data:`TWO_HOSTS` declares the processes on two hosts
(the first half ``host0``, the rest ``host1``: ``initialize_distributed``'s
``host=``), so a spanning mesh moves their chunks as it would between
machines.  The worker imports the port only (no JAX), on the CPU, one
thread.
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
    return collect(start(out_dir, mode, arg, nproc), out_dir, timeout)


def start(out_dir: str, mode: str, arg: str = "", nproc: int = 2) -> list:
    """Start ``nproc`` workers as one job and return their processes
    (:func:`collect` waits for them; the caller may work meanwhile)."""
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    return [subprocess.Popen([sys.executable, os.path.join(_REPO, "tests", "torch_mp_worker.py"),
                              str(port), str(i), str(nproc), out_dir, mode, arg],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                             cwd=_REPO)
            for i in range(nproc)]


def collect(procs: list, out_dir: str, timeout: float) -> list:
    """Wait for the workers of :func:`start` until ``timeout`` seconds from
    now, kill any still alive then, and return what :func:`spawn`
    returns."""
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
        **_durable_park(mh, rank),
    }


def _durable_park(mh, rank):
    """A fleet replica's durable park on both processes: each holds a whole
    17^2 member state (its own), writes it as a continuation and reads it
    back; the slab calls without a spanning mesh give whole arrays."""
    import torch

    from rustpde_mpi_tpu_torch.utils import checkpoint

    model = _model()
    state = type(model.state)(*(x * (1.0 + rank) for x in model.state))
    cont = os.path.join(sys.argv[4], "parked")
    checkpoint.write_continuation(cont, state, base=11, time_base=0.11, meta={"id": "m"})
    got, base, time_base = checkpoint.read_continuation(cont, state)
    return {"park_equal": all(bool(torch.equal(a, b)) for a, b in zip(got, state)),
            "park_base": [base, time_base],
            "park_shape": list(state.temp.shape),
            "whole_slab": bool(np.array_equal(mh.host_local_array(state.temp),
                                              state.temp.numpy())),
            "whole_global": mh.global_array(state.temp) is state.temp}


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


def _recorded_server():
    """``SimServer`` recording each campaign's mesh: its grid, rank count
    and whether it spans the processes."""
    from rustpde_mpi_tpu_torch.serve import SimServer

    class Recorded(SimServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.meshes = []

        def _build_runner(self, key, k=None):
            runner, ens = super()._build_runner(key, k)
            mesh = ens.model.mesh
            self.meshes.append([int(key[1]), int(key[2]), mesh.nranks if mesh else 0,
                                bool(getattr(mesh, "spanning", False))])
            return runner, ens

    return Recorded


def _served(rank, reqs, device="cpu", run_dir="serve", **cfg_kw):
    """Serve ``reqs`` (submitted on the root) with a ``SimServer`` on every
    process at once; the root returns the summary, each request's result,
    the journal's event types and each campaign's mesh
    (:func:`_recorded_server`)."""
    from rustpde_mpi_tpu_torch.config import ServeConfig
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    out_dir = sys.argv[4]
    cfg = ServeConfig(run_dir=os.path.join(out_dir, run_dir), chunk_steps=4,
                      checkpoint_every_s=None, http_port=None, **cfg_kw)
    srv = _recorded_server()(cfg, device=device)
    ids = [srv.submit(r).id for r in reqs] if rank == 0 else []
    summary = srv.serve()
    if rank != 0:
        return {"outcome": summary["outcome"], "meshes": srv.meshes}
    events = [e["event"] for e in read_journal(os.path.join(cfg.run_dir, "journal.jsonl"))
              if e["event"] not in ("perf_degraded", "profile_capture")]
    return {"outcome": summary["outcome"], "completed": summary["completed"],
            "processes": summary["slots"]["process_count"], "meshes": srv.meshes,
            "results": [srv.result(i) for i in ids], "events": events}


SERVE_REQ = dict(ra=1e4, pr=1.0, nx=17, ny=17, dt=0.01, bc="rbc")


def mode_serve_campaign(mh, rank, arg):
    """Two processes serve five 17^2 requests through two lanes: the root
    decides every boundary and broadcasts it, and the campaign runs on the
    whole-fleet mesh, every rank slot of both processes."""
    mh.set_sync_timeout(30.0)
    reqs = [dict(SERVE_REQ, horizon=0.08 + (s % 3) * 0.02, seed=s) for s in range(5)]
    return _served(rank, reqs, slots=2)


def mode_gang_serve(mh, rank, arg):
    """Two processes, a 34^2 request stamped for a 2-slot sub-mesh (a gang:
    one rank slot of each process, one model spanning them) beside two
    unstamped 18^2 requests (a grid the 14-slot remainder does not divide:
    the whole-fleet mesh)."""
    from rustpde_mpi_tpu_torch.config import SubmeshConfig

    mh.set_sync_timeout(30.0)
    reqs = [dict(SERVE_REQ, nx=34, ny=34, horizon=0.08, seed=100)] + \
        [dict(SERVE_REQ, nx=18, ny=18, horizon=0.06, seed=s) for s in range(2)]
    return _served(rank, reqs, slots=2, submesh=SubmeshConfig(shapes=(2,), shard_min_nx=34))


#: the gang cell of the spanning-serve spawns: a 34^2 request stamped for a
#: 2-slot sub-mesh (``GANG_SHAPES``), 12 steps, beside an unstamped 18^2 one
GANG_REQ = dict(SERVE_REQ, nx=34, ny=34, horizon=0.12)
GANG_SHAPES = (2,)
#: the deadlines of the gang-loss spawns: the gang barrier's
#: (``gang_sync_timeout_s``) and a chunk's wait for the card
#: (``ResilienceConfig.dispatch_timeout_s``)
GANG_DEADLINE_S = 10.0


def _gang_server(run_dir, shapes, slots, fleet, fault=None, device="cpu", **kw):
    """A ``SimServer`` on ``device`` for the gang spawns, with gang traffic
    from 34^2 up; ``fleet``: one replica of a fleet (both processes under
    one replica id) with a preemption notice, so a SIGTERM parks the
    running lanes as continuations.  Each continuation it writes is also
    kept as the member's global state (``parked_global``, the root's)."""
    from rustpde_mpi_tpu_torch.config import FleetConfig, ServeConfig, SubmeshConfig
    from rustpde_mpi_tpu_torch.models.campaign import global_leaves
    from rustpde_mpi_tpu_torch.serve import SimServer

    class Parking(SimServer):
        parked_global = {}

        def _write_continuation(self, req, ens, state, base, time_base):
            # the ring gather is a collective: every process, in plan order
            leaves = global_leaves(ens.model, state)
            self.parked_global[req.id] = {name: leaf.numpy().copy()
                                          for name, leaf in zip(state._fields, leaves)}
            return super()._write_continuation(req, ens, state, base, time_base)

    cfg = ServeConfig(run_dir=run_dir, slots=slots, chunk_steps=4, checkpoint_every_s=None,
                      http_port=None, submesh=SubmeshConfig(shapes=shapes, shard_min_nx=34),
                      fleet=FleetConfig(replica_id="gang", lease_ttl_s=60.0) if fleet else None,
                      preempt_notice_s=30.0 if fleet else 0.0, **kw)
    return Parking(cfg, device=device, fault=fault)


def _serve_rows(srv, ids) -> dict:
    """The root's record of one serve: its summary's outcome, each
    request's result (None while unresolved) and the journal's events."""
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    summary = srv.serve()
    events = [e["event"] for e in read_journal(srv.journal_path)
              if e["event"] not in ("perf_degraded", "profile_capture")]
    return {"outcome": summary["outcome"], "events": events,
            "results": [srv.result(i) for i in ids]}


def _member_move(mh):
    """A member of an ensemble on a 2-rank spanning mesh moved onto one of
    16 ranks (``SimServer._member_in``): its global state after the move
    against before, bit for bit."""
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.models.campaign import global_leaves
    from rustpde_mpi_tpu_torch.serve import SimServer

    small, big = (span_model("confined", mh.global_pencil_mesh(n, "cpu")) for n in (1, 8))
    src = pt.NavierEnsemble.from_seeds(small, [3, 4])
    dst = pt.NavierEnsemble(big, [big.state])
    state = src.member_state(1)
    moved = SimServer._member_in(SimServer.__new__(SimServer), dst, state, small.mesh)
    before, after = global_leaves(small, state), global_leaves(big, moved)
    same = all(bool((a == b).all()) for a, b in zip(before, after))
    small.mesh.close()
    big.mesh.close()
    return same


def mode_gang_park(mh, rank, arg):
    """A gang on a mesh spanning the two processes, parked and resumed:

    1. a fleet replica (both processes) serves a 34^2 gang request and an
       18^2 one; ``kill@4`` (SIGTERM on both) drains it under the notice:
       the gang's lane parks through the continuation writer, each process
       its slab (the root copies the continuation directory and keeps the
       member's global state);
    2. the same replica again: the gang resumes from its park, both done;
    3. a plain server drains a second gang request the same way, into its
       campaign checkpoint;
    4. restarted on another carve (a 4-slot sub-mesh) and 3 slots: the
       gang re-placed onto a slice of another shape (``gang_replanned``),
       its checkpoint restored there, the fleet re-planned, done;

    and one member moved between meshes of 2 and 16 ranks."""
    import shutil

    from rustpde_mpi_tpu_torch.utils import checkpoint

    mh.set_sync_timeout(30.0)
    out_dir = sys.argv[4]
    root = rank == 0
    out = {}
    fleet_dir, plain_dir = os.path.join(out_dir, "fleet"), os.path.join(out_dir, "plain")
    srv = _gang_server(fleet_dir, GANG_SHAPES, 2, True, fault="kill@4")
    ids = [srv.submit(dict(GANG_REQ, seed=100)).id,
           srv.submit(dict(SERVE_REQ, nx=18, ny=18, horizon=0.06, seed=1)).id] if root else []
    out["drain"] = _serve_rows(srv, ids) if root else {"outcome": srv.serve()["outcome"]}
    if root:
        cdir = checkpoint.continuation_dir(fleet_dir, ids[0])
        shutil.copytree(cdir, os.path.join(out_dir, "park"))
        np.savez(os.path.join(out_dir, "park_global.npz"), **srv.parked_global[ids[0]])
    srv = _gang_server(fleet_dir, GANG_SHAPES, 2, True)
    out["resume"] = _serve_rows(srv, ids) if root else {"outcome": srv.serve()["outcome"]}
    srv = _gang_server(plain_dir, GANG_SHAPES, 2, False, fault="kill@4")
    ids = [srv.submit(dict(GANG_REQ, seed=101)).id] if root else []
    out["drain_plain"] = _serve_rows(srv, ids) if root else {"outcome": srv.serve()["outcome"]}
    srv = _gang_server(plain_dir, (4,), 3, False)
    out["replan"] = _serve_rows(srv, ids) if root else {"outcome": srv.serve()["outcome"]}
    out["moved_bit_for_bit"] = _member_move(mh)
    return out


def mode_gang_kill(mh, rank, arg):
    """A gang on a mesh spanning the two processes loses member 1 mid-run:
    ``kill@6:gang0member1`` (a SIGKILL; it notes the wall time first), or
    with ``arg`` ``"cuda_stall"`` ``slow@6:gang0member1`` (member 1 stalls
    its next dispatch past the watchdog's deadline and never pushes its
    chunks, so the survivor's chunk waits in a remote flip on the card).
    ``arg`` ``"cuda..."`` serves on card 0.  The survivor's serve must end
    in the typed gang loss within the deadlines (``GANG_DEADLINE_S``).  The
    survivor returns the error, its wall time and the journal's events."""
    import signal

    from rustpde_mpi_tpu_torch.config import ResilienceConfig
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    kind = arg.split(",")[0]
    device = "cpu"
    if kind.startswith("cuda"):
        import torch

        device = "cuda:0"
        torch.cuda.set_device(torch.device("cuda", 0))
    mh.set_sync_timeout(60.0)
    out_dir = sys.argv[4]
    if rank == 1:
        kill = os.kill

        def noted(pid, sig):
            if sig == signal.SIGKILL:
                with open(os.path.join(out_dir, "killed_at"), "w", encoding="utf-8") as fh:
                    fh.write(repr(time.time()))
            kill(pid, sig)

        os.kill = noted
    fault = "slow@6:gang0member1" if kind == "cuda_stall" else "kill@6:gang0member1"
    srv = _gang_server(os.path.join(out_dir, "serve"), GANG_SHAPES, 2, False, fault=fault,
                       device=device, gang_sync_timeout_s=GANG_DEADLINE_S,
                       resilience=ResilienceConfig(dispatch_timeout_s=GANG_DEADLINE_S))
    ids = [srv.submit(dict(GANG_REQ, horizon=0.16, seed=100)).id] if rank == 0 else []
    try:
        srv.serve()
        error = None
    except Exception as exc:  # the survivor's gang loss
        error = [type(exc).__name__, str(exc)[:500]]
    ended = time.time()
    events = [e for e in read_journal(srv.journal_path)
              if e["event"] in ("gang_member_lost", "request_requeued", "gang_formed",
                                "fault_injected")]
    return {"error": error, "ended_at": ended, "events": events,
            "queue": srv.queue.counts(), "ids": ids}


#: the card's serving spawn: the ``ensemble129`` cell (129^2, Ra 1e7)
CARD_SERVE_REQ = dict(ra=1e7, pr=1.0, nx=129, ny=129, dt=2e-3, bc="rbc")


def mode_served_spanning_card(mh, rank, arg):
    """Two processes on card 0 serve together: three 129^2 requests through
    two lanes on the whole-fleet mesh (the third refills a lane), then a
    130^2 request stamped for a 2-slot sub-mesh (a gang, one rank a
    process) beside a 129^2 one.  The root returns each part's record
    (:func:`_served`)."""
    import torch

    from rustpde_mpi_tpu_torch.config import SubmeshConfig

    torch.cuda.set_device(torch.device("cuda", 0))
    mh.set_sync_timeout(120.0)
    fleet = [dict(CARD_SERVE_REQ, horizon=(8 + 2 * s) * 2e-3, seed=s) for s in range(3)]
    gang = [dict(CARD_SERVE_REQ, nx=130, ny=130, horizon=8 * 2e-3, seed=5),
            dict(CARD_SERVE_REQ, horizon=6 * 2e-3, seed=6)]
    return {"fleet": _served(rank, fleet, "cuda", "fleet", slots=2),
            "gang": _served(rank, gang, "cuda", "gang", slots=2,
                            submesh=SubmeshConfig(shapes=(2,), shard_min_nx=130))}


#: the spanning-mesh cells: 4 ranks over the processes, the confined cell at
#: 17^2 and the periodic one at 16x17
SPAN_RANKS = 4
SPAN_CELLS = {"confined": dict(nx=17, ny=17, periodic=False),
              "periodic": dict(nx=16, ny=17, periodic=True)}
SPAN_MODEL = dict(ra=1e4, pr=1.0, dt=0.01, aspect=1.0, bc="rbc")
SPAN_STEPS = 5


def span_model(cell, mesh):
    """A model of a spanning-mesh cell on ``mesh`` (the CPU), its state
    set from the trigonometric fields."""
    import rustpde_mpi_tpu_torch as pt

    c = SPAN_CELLS[cell]
    model = pt.Navier2D(c["nx"], c["ny"], *SPAN_MODEL.values(), periodic=c["periodic"],
                        device="cpu", mesh=mesh)
    model.set_velocity(0.1, 1.0, 1.0)
    model.set_temperature(0.1, 1.0, 1.0)
    model.write_intervall = 1e9
    return model


def _span_flips(mesh, one):
    """Every flip of real and complex pencils, one state and K = 3
    members, both directions: the spanning mesh's local blocks against the
    one-process mesh's blocks of this process's ranks."""
    import torch

    from rustpde_mpi_tpu_torch.parallel import Decomp2d

    rng = np.random.default_rng(3)
    out = {}
    lo, hi = mesh.rank0, mesh.rank0 + mesh.nlocal
    for dtype in (torch.float64, torch.complex128, torch.float32, torch.complex64):
        for members in (0, 3):
            for x_to_y in (True, False):
                shape = (13, 22)
                values = rng.standard_normal((max(members, 1),) + shape)
                if dtype.is_complex:
                    values = values + 1j * rng.standard_normal(values.shape)
                place = "place_x_pencil" if x_to_y else "place_y_pencil"
                span = [getattr(Decomp2d(shape, mesh), place)(v, dtype) for v in values]
                full = [getattr(Decomp2d(shape, one), place)(v, dtype) for v in values]
                span = torch.stack(span) if members else span[0]
                full = torch.stack(full) if members else full[0]
                got = mesh.ring.apply(span, x_to_y)
                want = one.ring.apply(full, x_to_y)[..., lo:hi, :, :]
                out[f"{dtype}_{members}_{x_to_y}"] = bool(torch.equal(got, want))
    return out


def _span_collectives(mh, mesh, one):
    import torch

    from rustpde_mpi_tpu_torch.parallel import decomp

    a = np.random.default_rng(7).standard_normal((16, 24))
    span, full = decomp.Decomp2d(a.shape, mesh), decomp.Decomp2d(a.shape, one)
    out = {}
    for pencil in ("x", "y"):
        s, f = decomp.scatter_root(a, span, pencil), decomp.scatter_root(a, full, pencil)
        out[f"place_{pencil}"] = bool(torch.equal(s, f[mesh.rank0: mesh.rank0 + mesh.nlocal]))
        out[f"gather_{pencil}"] = bool(np.array_equal(decomp.gather_root(s, span, pencil), a))
        out[f"global_array_{pencil}"] = bool(torch.equal(mh.global_array(s, mesh), f))
        out[f"host_local_{pencil}"] = bool(np.array_equal(mh.host_local_array(f, mesh),
                                                          s.numpy()))
    y = decomp.scatter_root(a, span, "y")
    out["sum"] = float(decomp.all_gather_sum(y, mesh))
    out["sum_one"] = float(decomp.all_gather_sum(decomp.scatter_root(a, full, "y"), one))
    members = torch.stack([y, 2.0 * y])
    out["sum_members"] = decomp.all_gather_sum(members, mesh, 1).tolist()
    out["max"] = float(decomp.all_gather_max(y, mesh))
    per_rank = torch.tensor([2.5 + 4.0 * mesh.rank0 + r for r in range(mesh.nlocal)],
                            dtype=torch.float64)
    out["broadcast_rank0"] = float(decomp.broadcast_scalar(per_rank, mesh))
    out["broadcast_host"] = float(decomp.broadcast_scalar(3.25, mesh))
    return out


def mode_spanning(mh, rank, arg):
    """A mesh of 4 ranks over the processes on the CPU: the flips, the
    collectives and the layout calls against the one-process mesh; 5 steps
    of each cell's model (the global states and observables written by
    rank 0 for the parent's comparisons); a chunk of ``update_n`` against
    eager steps; a NaN on rank 1's ranks alone under the sentinels; a
    sharded checkpoint of both processes and a gathered snapshot through
    the root."""
    import torch

    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.parallel import make_mesh
    from rustpde_mpi_tpu_torch.utils import checkpoint

    mh.set_sync_timeout(30.0)
    out_dir = sys.argv[4]
    mesh = mh.global_pencil_mesh(SPAN_RANKS // mh.process_count(), "cpu")
    one = make_mesh(SPAN_RANKS, "cpu")
    out = {"mesh": [mesh.nranks, mesh.nlocal, mesh.rank0, mesh.spanning, repr(mesh)],
           "flips": _span_flips(mesh, one), "collectives": _span_collectives(mh, mesh, one)}
    for cell in SPAN_CELLS:
        model = span_model(cell, mesh)
        out[f"{cell}_shape"] = list(model.state.temp.shape)
        out[f"{cell}_kernels"] = sorted(model.kernels())
        model.update_n(SPAN_STEPS)
        state = pt.state_to_numpy(model)
        obs = [float(v) for v in model.get_observables()]
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{cell}.npz"), obs=np.asarray(obs), **state)
    # a chunk of update_n against as many eager steps
    chunked, eager = span_model("confined", mesh), span_model("confined", mesh)
    chunked.update_n(SPAN_STEPS)
    for _ in range(SPAN_STEPS):
        eager.update()
    out["chunk_equals_eager"] = all(bool(torch.equal(a, b))
                                    for a, b in zip(chunked.state, eager.state))
    # the checkpoints of the stepped confined model
    chunked.write(os.path.join(out_dir, "snapshot.h5"))
    checkpoint.write_sharded_snapshot(chunked, os.path.join(out_dir, "sharded.h5"), step=5)
    # a NaN on this process's ranks alone (rank 1), under the sentinels and
    # in a plain chunk: both processes freeze at the same step
    model = span_model("confined", mesh)
    model.update_n(2)
    if rank == 1:
        temp = model.state.temp.clone()
        temp[0, 3, 1] = float("nan")
        model.state = model.state._replace(temp=temp)
    start = model.state
    model.set_stability(pt.StabilityConfig())
    status = model.update_n(SPAN_STEPS)
    out["nan_sentinels"] = [status.steps_done, status.finite]
    model.set_stability(None)
    model.state = start
    model.update_n(SPAN_STEPS)
    runner = model.chunk_runner(armed=False)
    nf = len(model.state)
    out["nan_plain"] = [int(runner.carry[nf + 1]), bool(runner.carry[nf])]
    out["not_ported"] = _span_not_ported(pt, mesh, span_model("confined", mesh), out_dir)
    mesh.close()
    return out


def _span_not_ported(pt, mesh, model, out_dir):
    """What raised on a spanning mesh before its port (an ensemble, the
    resilient runner, the statistics and a flip's backward): each entry
    None, or the message of the ``NotImplementedError`` it still raises."""
    import torch

    block = torch.zeros((mesh.nlocal, 8, 2), dtype=torch.float64, requires_grad=True)
    cases = {"ensemble": lambda: pt.NavierEnsemble(model, [model.state]),
             "runner": lambda: pt.ResilientRunner(model, 0.1, run_dir=os.path.join(out_dir, "r")),
             "stats": lambda: model.set_stats(pt.StatsConfig()),
             "backward": lambda: mesh.ring.apply(block, True).sum().backward()}
    out = {}
    for name, call in cases.items():
        try:
            call()
            out[name] = None
        except NotImplementedError as exc:
            out[name] = str(exc)
    return out


#: the paths of a spanning mesh (:func:`mode_spanning_paths`), each run
#: the same way on the one-process mesh by the tests: the runner over
#: ``PATH_RUN_TIME`` with a NaN at ``PATH_NAN_STEP`` (on rank 1's process,
#: every rank of the one-process mesh) and, under the integrity audits,
#: with a bit flipped at ``PATH_FLIP_STEP``, the statistics at stride
#: ``PATH_STRIDE`` over ``PATH_STATS_STEPS``, an ensemble of
#: ``PATH_MEMBERS`` over ``SPAN_STEPS``, and the linearised model's
#: ``grad_autodiff`` at ``PATH_GRAD`` (the 10x9 cell of
#: ``tests/test_torch_lnse.py``)
PATH_RUN_TIME = 0.1
PATH_NAN_STEP = 6
PATH_FLIP_STEP = 4
PATH_STRIDE = 2
PATH_STATS_STEPS = 10
PATH_MEMBERS = 3
PATH_GRAD = dict(nx=10, ny=9, ra=3e3, pr=1.0, dt=1e-2, aspect=1.0, time=0.03)


def path_runner(mesh, run_dir, fault):
    """The resilient runner on ``mesh`` with ``fault``: the model, the
    summary and the journal's event types (the root's)."""
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.parallel import multihost
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    model = span_model("confined", mesh)
    runner = pt.ResilientRunner(model, max_time=PATH_RUN_TIME, run_dir=run_dir, fault=fault,
                                checkpoint_every_s=None)
    summary = runner.run()
    events = [e["event"] for e in read_journal(os.path.join(run_dir, "journal.jsonl"))] \
        if multihost.is_root() else None
    return model, summary, events


def path_bitflip(mesh, run_dir, fault):
    """The runner on ``mesh`` with the integrity audits at every chunk and
    the bitflip ``fault``: the model and the root's journal rows of the
    audits (event, and the mismatch's host and device)."""
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.config import IntegrityConfig
    from rustpde_mpi_tpu_torch.parallel import multihost
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    model = span_model("confined", mesh)
    model.set_integrity(IntegrityConfig(cadence=1))
    pt.ResilientRunner(model, max_time=PATH_RUN_TIME, run_dir=run_dir, fault=fault,
                       checkpoint_every_s=None).run()
    rows = [{k: e[k] for k in ("event", "check", "host", "device", "leaf") if k in e}
            for e in read_journal(os.path.join(run_dir, "journal.jsonl"))] \
        if multihost.is_root() else None
    return model, rows


def path_stats(mesh):
    """A model on ``mesh`` with its statistics armed, stepped."""
    import rustpde_mpi_tpu_torch as pt

    model = span_model("confined", mesh)
    model.set_stats(pt.StatsConfig(stride=PATH_STRIDE))
    model.update_n(PATH_STATS_STEPS)
    return model


def path_ensemble(mesh):
    """An ensemble of ``PATH_MEMBERS`` seeded members on ``mesh``, with the
    integrity layer armed, stepped."""
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.config import IntegrityConfig

    ens = pt.NavierEnsemble.from_seeds(span_model("confined", mesh), range(PATH_MEMBERS))
    ens.set_integrity(IntegrityConfig())
    ens.update_n(SPAN_STEPS)
    return ens


def path_grad(mesh):
    """The linearised model's ``grad_autodiff`` on ``mesh`` (``None``: the
    serial dense route), from the random state of seed 1."""
    import rustpde_mpi_tpu_torch as pt

    g = PATH_GRAD
    where = {"mesh": mesh} if mesh is not None else {}
    model = pt.Navier2DLnse(g["nx"], g["ny"], g["ra"], g["pr"], g["dt"], g["aspect"], "rbc",
                            mean=pt.MeanFields.new_rbc(g["nx"], g["ny"], device="cpu"),
                            device="cpu", **where)
    model.init_random(1e-3, seed=1)
    return model.grad_autodiff(g["time"])


def path_results(model, ens, stats, flipped) -> dict:
    """The global arrays the tests compare, by name."""
    import rustpde_mpi_tpu_torch as pt

    out = {f"run_{k}": v for k, v in pt.state_to_numpy(model).items()}
    out.update({f"flip_{k}": v for k, v in pt.state_to_numpy(flipped).items()})
    for name in stats.stats_state._fields:
        out[f"stats_{name}"] = getattr(stats.stats_state, name).numpy()
    out["stats_health"] = np.asarray(stats.stats_health(), dtype=np.float64)
    for name, space in ens.model._state_fields():
        leaf = getattr(ens.state, name)
        out[f"ens_{name}"] = np.stack([space.gather_spectral(leaf[i]).numpy()
                                       for i in range(ens.k)])
    out["ens_digest"] = np.asarray(ens.state_digest_async().result()).astype(np.int64)
    return out


def mode_spanning_paths(mh, rank, arg):
    """The paths that span the processes' ranks, on a spanning mesh of 4
    ranks over the processes on the CPU: the resilient runner with a NaN
    on rank 1's process, the statistics engine, an ensemble with its
    digests.  Rank 0 writes the global arrays (:func:`path_results`) for
    the parent's comparisons."""
    mh.set_sync_timeout(30.0)
    out_dir = sys.argv[4]
    os.chdir(out_dir)  # anything written relative lands here
    mesh = mh.global_pencil_mesh(SPAN_RANKS // mh.process_count(), "cpu")
    model, summary, events = path_runner(mesh, os.path.join(out_dir, "run"),
                                         f"nan@{PATH_NAN_STEP}:host1")
    flipped, audits = path_bitflip(mesh, os.path.join(out_dir, "flip"),
                                   f"bitflip@{PATH_FLIP_STEP}:host1")
    stats = path_stats(mesh)
    ens = path_ensemble(mesh)
    arrays = path_results(model, ens, stats, flipped)
    if rank == 0:
        np.savez(os.path.join(out_dir, "paths.npz"), **arrays)
    out = {"summary": {k: summary[k] for k in ("outcome", "step", "dt", "retries")},
           "events": events, "audits": audits, "alive": ens.alive().tolist(),
           "stats_tick": int(stats._stats_tick[0])}
    mesh.close()
    return out


def mode_spanning_grad(mh, rank, arg):
    """The linearised model's ``grad_autodiff`` (:func:`path_grad`) on a
    spanning mesh of 4 ranks over the processes on the CPU: every forward
    flip differentiated by the inverse flip, a collective too.  Rank 0
    writes the value and the global gradients."""
    from rustpde_mpi_tpu_torch.ops import ring_transpose

    mh.set_sync_timeout(30.0)
    mesh = mh.global_pencil_mesh(SPAN_RANKS // mh.process_count(), "cpu")
    counts = {"backward": 0}
    backward = ring_transpose.FlipFn.backward

    def counted(ctx, g):  # the plain ring counts no launches: count the calls
        counts["backward"] += 1
        return backward(ctx, g)

    ring_transpose.FlipFn.backward = staticmethod(counted)
    val, grads = path_grad(mesh)
    if rank == 0:
        np.savez(os.path.join(sys.argv[4], "grad.npz"), value=np.asarray(val),
                 **{f"grad_{i}": g for i, g in enumerate(grads)})
    mesh.close()
    return {"backward_flips": counts["backward"]}


def mode_spanning_card(mh, rank, arg):
    """A spanning mesh of 4 ranks on the card (``arg``: ``shared``, every
    process on card 0; ``per_card``, process ``p`` on card ``p``): the
    remote flip bit for bit against its plain version, real and complex,
    one state and K = 2 members; 10 captured steps of a 129^2 model with
    their launches (rank 0 writes the global state)."""
    import torch

    import rustpde_mpi_tpu_torch as pt

    device = torch.device("cuda", rank if arg.split(",")[0] == "per_card" else 0)
    torch.cuda.set_device(device)
    mh.set_sync_timeout(60.0)
    mesh = mh.global_pencil_mesh(SPAN_RANKS // mh.process_count(), device)
    rng = np.random.default_rng(rank)
    flips = {}
    for dtype in (torch.float64, torch.complex128):
        for shape in ((mesh.nlocal, 132, 33), (2, mesh.nlocal, 132, 33)):
            for x_to_y in (True, False):
                block = torch.as_tensor(rng.standard_normal(shape), device=device).to(dtype)
                if not x_to_y:
                    block = block.reshape(*shape[:-2], 33, 132).contiguous()
                out = mesh.ring.apply(block, x_to_y)
                flips[f"{dtype}_{len(shape)}_{x_to_y}"] = bool(
                    torch.equal(out, mesh.ring.plain(block, x_to_y)))
    model = pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", mesh=mesh)
    model.init_random(0.1, seed=0)
    model.chunk_runner(armed=False)
    for ks in model.kernels().values():
        for k in ks:
            k.launches = 0
    model.update_n(10)
    launches = {name: sum(k.launches for k in ks) for name, ks in model.kernels().items()}
    state = pt.state_to_numpy(model)
    if rank == 0:
        np.savez(os.path.join(sys.argv[4], "card.npz"), **state)
    torch.cuda.synchronize()
    mesh.close()
    return {"flips": flips, "launches": launches, "device": str(mesh.device)}


def mode_mesh_contract(mh, rank, arg):
    """The meshes of a group of processes: every process's device, and a
    carved sub-mesh of both, build a mesh that spans them; one that names a
    process outside the group raises."""
    from rustpde_mpi_tpu_torch.parallel import submesh
    from rustpde_mpi_tpu_torch.parallel.mesh import Mesh

    devices = mh.global_devices("cpu")
    both = Mesh(devices)
    carved = submesh.carve(devices, (2,)).by_shape(2).mesh()
    try:
        Mesh(devices + [mh.HostDevice(2, 2, "cpu")])
        outside = None
    except NotImplementedError as exc:
        outside = str(exc)
    return {"both": [both.nranks, both.nlocal, both.rank0, both.spanning],
            "carved": [carved.nranks, carved.nlocal, carved.rank0, carved.spanning],
            "outside": outside}


#: the ``arg`` entry (comma-separated) that declares the processes on two
#: hosts (see the module docstring)
TWO_HOSTS = "two_hosts"


def _exchange_buffers(hx, links, rank, nbytes, run, stride):
    """A plan of one peer between raw host buffers: the staging (two
    buffers, runs of ``run`` bytes every ``stride``), the received bytes
    and the epoch's word, as numpy."""
    nrun = nbytes // run
    stage = np.zeros((2, nrun * stride), np.uint8)
    recv = np.zeros(nrun * run, np.uint8)
    word = np.zeros(1, np.int32)
    lay = hx.Layout((1, nrun, 1), (0, stride, 0), run, 0, nrun * run, nrun * stride)
    plan = hx.make_plan(links, lay, 7, 0, [1 - rank], [stage.ctypes.data],
                        [recv.ctypes.data], word.ctypes.data, lay.buf_bytes)
    return plan, stage, recv, word


def mode_host_exchange(mh, rank, arg):
    """The socket exchange between two processes declared on two hosts
    (``csrc/host_exchange.cpp``, built here by the system C++ compiler):

    * bytes: ``EXCHANGE_ROUNDS`` exchanges of runs out of a strided staging,
      the epoch naming the buffer, a small size and sizes that overflow the
      socket buffers both ways, every received byte the peer's;
    * release: a spanning mesh declared over the two hosts whose process 1
      stalls before a flip; process 0's flip waits in the exchange until
      another thread calls its ring's ``release_waits`` (raises at once,
      long before the deadline), and process 1's flip then fails too;
    * deadline: process 1 never enters an exchange while process 0's
      waits out ``set_sync_timeout``;
    * gone: process 1 leaves (``os._exit``) before an exchange; process 0's
      raises at once."""
    import threading

    import torch

    from rustpde_mpi_tpu_torch.ops import _build
    from rustpde_mpi_tpu_torch.ops import host_exchange as hx
    from rustpde_mpi_tpu_torch.utils.resilience import DispatchHang

    out = {"compiler": _build._command("host_exchange")[0]}
    mh.set_sync_timeout(30.0)
    links = hx.connect(rank, 2, [1 - rank])
    rows = []
    for nbytes, run, stride in EXCHANGE_SIZES:
        plan, stage, recv, word = _exchange_buffers(hx, links, rank, nbytes, run, stride)
        ok = True
        for r in range(EXCHANGE_ROUNDS):
            fill = np.random.default_rng(1000 * r + rank).integers(0, 256, stage.shape[1],
                                                                   dtype=np.uint8)
            word[0] = r
            stage[r & 1] = fill
            t0 = time.perf_counter()
            rc = hx.run(plan)
            dt = time.perf_counter() - t0
            peer = np.random.default_rng(1000 * r + 1 - rank).integers(
                0, 256, stage.shape[1], dtype=np.uint8).reshape(-1, stride)[:, :run]
            ok = ok and rc == 0 and bool(np.array_equal(recv.reshape(-1, run), peer))
        rows.append({"bytes": nbytes, "ok": ok, "seq": plan.seq, "last_s": dt})
    out["bytes"] = rows
    links.close()

    def raised(fn):
        t0 = time.monotonic()
        try:
            fn()
        except DispatchHang as exc:
            return [time.monotonic() - t0, str(exc)]
        return [time.monotonic() - t0, None]

    # release: a flip stalled in the exchange, released from another thread
    mesh = mh.global_pencil_mesh(2, "cpu")
    block = torch.zeros((2, 16, 2), dtype=torch.float64)
    mesh.ring.apply(block, True)  # the links and the plan, both processes
    if rank == 1:
        time.sleep(1.0)
    else:
        threading.Timer(0.3, mesh.ring.release_waits).start()
    out["release"] = raised(lambda: mesh.ring.apply(block, True))
    out["after_release"] = raised(lambda: mesh.ring.apply(block, True))
    mesh.close()
    # the deadline: process 1 stays out of the exchange past process 0's
    mh.sync_hosts("deadline")
    mh.set_sync_timeout(1.0)
    mesh = mh.global_pencil_mesh(2, "cpu")
    mesh.ring.apply(block, True)
    if rank == 1:
        time.sleep(2.0)
    out["deadline"] = raised(lambda: mesh.ring.apply(block, True))
    mesh.close()
    # gone: process 1 leaves before the exchange
    mh.set_sync_timeout(30.0)
    mesh = mh.global_pencil_mesh(2, "cpu")
    mesh.ring.apply(block, True)
    if rank == 1:
        os._exit(0)
    out["gone"] = raised(lambda: mesh.ring.apply(block, True))
    return out


#: the exchange's rounds and sizes (bytes each way, run bytes, run stride):
#: one small, two past any socket buffer (16 MiB each way; the runs of the
#: last strided as an x -> y flip's rows are)
EXCHANGE_ROUNDS = 3
EXCHANGE_SIZES = ((4096, 64, 64), (16 << 20, 1 << 20, 1 << 20), (16 << 20, 4096, 8192))


def mode_cross_host(mh, rank, arg):
    """A 2 x 2 mesh declared over two hosts on the CPU and the same two
    processes' mesh declared on one host: 5 steps of each spanning-mesh
    cell on each (every flip and rank gather of the cross-host mesh
    counted, and each call of the exchange), the global states written by
    rank 0 for the parent's comparisons."""
    import torch

    from rustpde_mpi_tpu_torch.ops import host_exchange as hx
    from rustpde_mpi_tpu_torch.ops import ring_transpose as rt
    from rustpde_mpi_tpu_torch.parallel.mesh import Mesh

    import rustpde_mpi_tpu_torch as pt

    mh.set_sync_timeout(30.0)
    out_dir = sys.argv[4]
    across = mh.global_pencil_mesh(SPAN_RANKS // 2, "cpu")
    one_host = Mesh([mh.HostDevice(d.id, d.process_index, d.device, "one")
                     for d in mh.global_devices("cpu") for _ in range(SPAN_RANKS // 2)])
    counts = {"flips": 0, "gathers": 0, "exchanges": 0}
    flip, gather, run = rt.SpanningRing.flip, rt.RankGather.gather, hx.run

    def counted(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    out = {"across": [across.hosts, list(across.ring.remote), repr(across)],
           "one_host": [one_host.hosts, list(one_host.ring.remote)]}
    for cell in SPAN_CELLS:
        for label, mesh in (("across", across), ("one_host", one_host)):
            model = span_model(cell, mesh)
            if label == "across":
                for k in counts:
                    counts[k] = 0
                rt.SpanningRing.flip = counted("flips", flip)
                rt.RankGather.gather = counted("gathers", gather)
                hx.run = counted("exchanges", run)
            try:
                model.update_n(SPAN_STEPS)
            finally:
                rt.SpanningRing.flip, rt.RankGather.gather, hx.run = flip, gather, run
            if label == "across":
                out[f"{cell}_counts"] = dict(counts)
            state = pt.state_to_numpy(model)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{label}_{cell}.npz"), **state)
    out["plans"] = len(across.ring._host_slabs)
    torch.distributed.barrier()
    across.close()
    one_host.close()
    return out


def main():
    port, rank, nproc, out_dir, mode = sys.argv[1:6]
    arg = sys.argv[6] if len(sys.argv) > 6 else ""
    rank, nproc = int(rank), int(nproc)
    sys.path.insert(0, _REPO)
    import torch

    torch.set_num_threads(1)
    from rustpde_mpi_tpu_torch.parallel import multihost as mh

    host = f"host{rank * 2 // nproc}" if TWO_HOSTS in arg.split(",") else None
    assert mh.initialize_distributed(f"localhost:{port}", nproc, rank, timeout_s=60.0, host=host)
    result = globals()[f"mode_{mode}"](mh, rank, arg)
    with open(os.path.join(out_dir, f"result_{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(result, fh)
    sys.stdout.flush()
    # leave without the group's teardown handshake: a peer may be gone
    os._exit(0)


if __name__ == "__main__":
    main()

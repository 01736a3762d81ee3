#!/usr/bin/env python3
"""Device time of a meshed ``rbc1025`` step's remote pencil flips with a
card a process (``csrc/ring_transpose.cu`` ``rp_ring_push_*``), beside
NCCL's ``all_to_all_single`` of the same blocks.

    python3 scripts/span_flip_times.py [--rounds R]

It spawns 4 processes, process ``r`` on card ``r``, joined
by gloo over localhost, and builds the spanning mesh of one rank a process
(``multihost.global_pencil_mesh``).  The flips are those of one step of
meshed ``rbc1025`` f64 on 4 ranks (:data:`STEP_FLIPS`, the local pencil
shapes and counts ``chip_smoke.py``'s ``span_step_flips`` logs on that
layout), on random values.  Every flip runs once against its plain
version (the gloo all-to-all; bit for bit) and ``WARMUP`` times untimed,
then is timed in ``R`` rounds (default 2), each flip warm, a captured graph
of :data:`WARM_REPS` calls every process replays together (median of 3
windows, each opened after a rank gather on the card, so no process's
window holds the others' lag behind the host barrier), and cold as
``chip_smoke.py`` phase 37 times it (the L2 flushed, each window opened
after a rank gather); the sums over the step's counts.  NCCL is timed in
each round as phase 37 times it (20 calls back to back).  It prints the
card's name and power limit, then one JSON line a round from every
process.  It needs 4 CUDA cards and exits non-zero without them.
"""

import argparse
import importlib.util
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: processes, one rank and one card each
PROCS = 4
#: ``{(local pencil shape, x_to_y, dtype): flips a step}`` of meshed
#: ``rbc1025`` f64 with one rank a process, 4 ranks
STEP_FLIPS = {((1, 256, 1024), False, "float64"): 6, ((1, 257, 1028), False, "float64"): 10,
              ((1, 1024, 256), True, "float64"): 2, ((1, 1024, 257), True, "float64"): 4,
              ((1, 1028, 256), True, "float64"): 14, ((1, 1028, 257), True, "float64"): 1}
#: flips in a warm window's graph
WARM_REPS = 100
#: untimed flips of each shape in each form before the rounds
WARMUP = 200
TIMEOUT_S = 600


def chip_smoke():
    """This repo's ``chip_smoke.py`` as a module (its timing helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def warm_ms(torch, mh, cs, ring, fn) -> float:
    """Device ms of one ``fn()``, back to back: ``WARM_REPS`` calls captured
    as one graph, replayed once, then in ``cs.SPAN_WINDOWS`` windows, each
    after a host barrier and a rank gather; the median."""
    import statistics

    token = torch.zeros((ring.nlocal, 1), dtype=torch.float64, device=ring.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(WARM_REPS):
            fn()
    try:
        graph.replay()
        times = []
        for i in range(cs.SPAN_WINDOWS):
            cs.span_barrier(torch, mh, f"warm {i}")
            ring.gather(token)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / WARM_REPS)
        return statistics.median(times)
    finally:
        torch.cuda.synchronize()
        graph.reset()


def child(rank, nproc, port, rounds):
    """One process: its rank of the mesh, the checks and the timed rounds."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from rustpde_mpi_tpu_torch.parallel import multihost as mh

    cs = chip_smoke()
    device = f"cuda:{rank}"
    torch.cuda.set_device(torch.device(device))
    mh.initialize_distributed(f"localhost:{port}", nproc, rank, timeout_s=cs.SPAN_SYNC_S)
    mh.set_sync_timeout(cs.SPAN_SYNC_S)
    mesh = mh.global_pencil_mesh(1, device)
    ring = mesh.ring
    nccl = torch.distributed.new_group(backend="nccl")
    rng = np.random.default_rng(37 + rank)
    blocks = {key: torch.as_tensor(rng.uniform(-1.0, 1.0, size=key[0]),
                                   dtype=getattr(torch, key[2]), device=device)
              for key in STEP_FLIPS}
    for (shape, x_to_y, _), block in blocks.items():
        out = ring.apply(block, x_to_y)
        torch.cuda.synchronize()
        if not torch.equal(out, ring.plain(block, x_to_y)):
            raise AssertionError(f"the flip of {shape} x_to_y={x_to_y} differs from its "
                                 "plain version")
        for _ in range(WARMUP):
            ring.apply(block, x_to_y)
    lines = []
    for r in range(rounds):
        cs.span_barrier(torch, mh, f"round {r}")
        warm = cold = nccl_ms = 0.0
        for key, block in blocks.items():
            count, x_to_y = STEP_FLIPS[key], key[1]

            def fn(block=block, x_to_y=x_to_y):
                ring.apply(block, x_to_y)

            warm += count * warm_ms(torch, mh, cs, ring, fn)
            cs.span_barrier(torch, mh, "cold")
            cold += count * cs.span_cold_ms(torch, ring, fn, cs.SPAN_REPS)
            send = block.reshape(-1).clone()
            recv = torch.empty_like(send)
            cs.span_barrier(torch, mh, "nccl")
            nccl_ms += count * cs.time_queued_ms(torch, lambda: torch.distributed.all_to_all_single(
                recv, send, group=nccl), cs.SPAN_REPS)[0]
        lines.append({"rank": rank, "round": r, "warm_ms": warm, "cold_ms": cold,
                      "nccl_ms": nccl_ms})
    cs.span_barrier(torch, mh, "done")
    mesh.close()
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        for line in child(args.child, PROCS, args.port, args.rounds):
            print(json.dumps(line), flush=True)
        os._exit(0)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < PROCS:
        print(f"span_flip_times: needs {PROCS} CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from rustpde_mpi_tpu_torch.ops import _build

    _build.build(("ring_transpose",))
    print(chip_smoke().card_line(), flush=True)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen([sys.executable, __file__, "--rounds", str(args.rounds), "--child",
                               str(r), "--port", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(PROCS)]
    rc = 0
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            print(out, end="", flush=True)
            if p.returncode != 0:
                print(f"span_flip_times: process {r} rc={p.returncode}\n{err[-4000:]}",
                      file=sys.stderr)
                rc = 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())

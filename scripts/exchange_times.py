#!/usr/bin/env python3
"""Split the cost of one host collective of the port's multi-process layer
(``rustpde_mpi_tpu_torch/parallel/multihost.py``) between two processes
joined by gloo over localhost.

    python3 scripts/exchange_times.py [<tree> ...] [--iters N] [--out FILE]

Each ``<tree>`` (default: this checkout) is the root of a checkout of the
repo, e.g. another commit unpacked with ``git archive``; the trees are
timed one after the other, each in a fresh pair of processes, so list
them alternately (A B B A) to compare two.  Per tree, rank 0 prints one
JSON line of medians in microseconds over ``N`` calls (default 2000):

* ``all_gather_raw``: ``torch.distributed.all_gather`` of 256-byte frames
  allocated once (the transport alone);
* ``all_gather_alloc``: the same with the frames allocated each call;
* ``pickle``: one envelope pickled and unpickled twice (a 2-process
  exchange's host work, no transport);
* ``exchange``: the module's ``_exchange`` of a 0-d int32;
* ``root_decides`` / ``root_decides_watched``: one root-decided flag
  without and with a sync timeout (``set_sync_timeout``: the call runs on
  a watchdog thread);
* ``any_process``: one allgather of a flag;
* ``boundary_3`` / ``boundary_1``: a runner boundary's three agreements
  (the break flag on any process, the root's stop and cadence flags) as
  three calls, and as one ``agree_flags`` (where the tree has it);
* ``barrier``: ``torch.distributed.barrier``.

It needs no card; it runs the processes on the CPU with one intra-op
thread each.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(tree: str, port: int, rank: int, iters: int) -> None:
    sys.path.insert(0, tree)
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from rustpde_mpi_tpu_torch.parallel import multihost as mh

    mh.initialize_distributed(f"localhost:{port}", 2, rank, timeout_s=120.0)
    frames = [torch.zeros(256, dtype=torch.uint8) for _ in range(2)]
    send = torch.zeros(256, dtype=torch.uint8)

    def raw():
        dist.all_gather(frames, send)

    def alloc():
        dist.all_gather([torch.empty(256, dtype=torch.uint8) for _ in range(2)],
                        torch.zeros(256, dtype=torch.uint8))

    def pick():
        blob = pickle.dumps((True, np.int32(1)), protocol=4)
        for _ in range(2):
            pickle.loads(blob)

    def boundary_3():
        mh.any_process(False)
        mh.root_decides(False)
        mh.root_decides(False)

    cases = {"all_gather_raw": raw, "all_gather_alloc": alloc, "pickle": pick,
             "exchange": lambda: mh._exchange(np.int32(1)),
             "root_decides": lambda: mh.root_decides(False),
             "any_process": lambda: mh.any_process(False),
             "boundary_3": boundary_3, "barrier": dist.barrier}
    if hasattr(mh, "agree_flags"):
        cases["boundary_1"] = lambda: mh.agree_flags((False,), (False, False))
    cases["root_decides_watched"] = lambda: mh.root_decides(False)
    out = {"tree": tree}
    for name, fn in cases.items():
        if name == "root_decides_watched":
            mh.set_sync_timeout(60.0)
        for _ in range(50):
            fn()
        dist.barrier()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        out[name] = round(statistics.median(times) * 1e6, 2)
    if rank == 0:
        print(json.dumps(out), flush=True)
    os._exit(0)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        _child(args[1], int(args[2]), int(args[3]), int(args[4]))
        return 0
    iters, out_path, trees = 2000, None, []
    while args:
        a = args.pop(0)
        if a == "--iters":
            iters = int(args.pop(0))
        elif a == "--out":
            out_path = args.pop(0)
        else:
            trees.append(os.path.abspath(a))
    lines = []
    for tree in trees or [ROOT]:
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", tree,
                                   str(port), str(rank), str(iters)],
                                  stdout=subprocess.PIPE, text=True, env=env)
                 for rank in range(2)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            print(f"exchange_times: a child failed on {tree}", file=sys.stderr)
            return 1
        line = outs[0].strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if out_path:
        with open(out_path, "a", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The host's loopback rate through the remote flip's socket exchange.

    python3 scripts/loopback_rates.py            # no card needed

The cross-host form of a remote flip (``csrc/host_exchange.cpp``) moves a
flip's chunks for another host over one TCP connection a peer.  This
script times that exchange alone, between processes of this machine
declared on two hosts, with the byte counts of a meshed ``rbc1025`` flip
(1028 x 257 f64 a rank, half of a process's chunks for the other host):

* ``2 processes``: 2 ranks each, 2.1 MB each way to the one peer (the 2 x 2
  layout of ``chip_smoke.py`` phase 40);
* ``4 processes``: 1 rank each, two a host, 0.53 MB each way to each of the
  two other-host peers (``scripts/cross_host_times.py``'s layout).

each in three forms of the same bytes: ``contiguous`` (one run a peer,
plain host memory), ``rows`` (the x -> y flip's runs: a row of the peer's
ranks' block, ``PL * w`` elements, every ``P * w``) and, where a card is,
``rows_pinned`` (the same out of and into pinned memory, as the flip's
staging and receive memory are).  Each process runs ``ROUNDS`` exchanges
after one untimed, from one plan (no CUDA call in the exchange); it prints
each process's mean ms an exchange, the bytes it moved each way and the
aggregate rate over every process's sends, and a JSON line of it.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: bytes of one rank's pencil of a meshed rbc1025 flip (1028 x 257 f64)
RANK_BYTES = 1028 * 257 * 8
ROUNDS = 20
#: the layouts: (processes, ranks a process)
LAYOUTS = ((2, 2), (4, 1))
#: a flip's rows (c = w = 257 at 1028 over 4 ranks) and ranks
ROWS, RANKS = 257, 4
TIMEOUT_S = 120.0


def child(port: int, rank: int, nproc: int, ranks: int) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from rustpde_mpi_tpu_torch.ops import host_exchange as hx
    from rustpde_mpi_tpu_torch.parallel import multihost as mh

    host = f"host{2 * rank // nproc}"
    mh.initialize_distributed(f"localhost:{port}", nproc, rank, timeout_s=TIMEOUT_S, host=host)
    mh.set_sync_timeout(TIMEOUT_S)
    hosts = mh.process_hosts()
    remote = [q for q in range(nproc) if hosts[q] != hosts[rank]]
    links = hx.connect(rank, nproc, remote)
    # this process's chunks for one peer: the peer's share of its ranks'
    # pencils; as rows, a row of the peer's ranks' block every RANKS * w
    nbytes = ranks * RANK_BYTES // nproc
    run, stride = ranks * ROWS * 8, RANKS * ROWS * 8
    forms = {"contiguous": (hx.Layout((1, 1, 1), (0, 0, 0), nbytes, 0, nbytes, nbytes), False),
             "rows": (hx.Layout((1, 1, ranks * ROWS), (0, 0, stride), run, 0, nbytes,
                                ranks * ROWS * stride), False)}
    if torch.cuda.is_available():
        forms["rows_pinned"] = (forms["rows"][0], True)
    out = {}
    for name, (lay, pinned) in forms.items():
        def buffer(n):
            return torch.ones(n, dtype=torch.uint8, pin_memory=pinned)

        send = [buffer(2 * lay.buf_bytes) for _ in remote]
        recv = [buffer(lay.wire_bytes) for _ in remote]
        word = np.zeros(1, np.int32)
        plan = hx.make_plan(links, lay, 1, 0, remote, [b.data_ptr() for b in send],
                            [b.data_ptr() for b in recv], word.ctypes.data, lay.buf_bytes)
        if hx.run(plan):
            raise RuntimeError(links.failure())
        mh.sync_hosts(f"timed {name}")
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            if hx.run(plan):
                raise RuntimeError(links.failure())
        ms = (time.perf_counter() - t0) / ROUNDS * 1e3
        rows = mh.allgather_host(np.array([ms, nbytes * len(remote)], dtype=np.float64))
        out[name] = {"ms": rows[:, 0].tolist(), "bytes_out": rows[:, 1].tolist()}
    if rank == 0:
        print(json.dumps(out), flush=True)
    links.close()
    os._exit(0)


def layout(nproc: int, ranks: int) -> dict:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", str(port),
                               str(r), str(nproc), str(ranks)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(err[-2000:] for _, err in outs))
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    for form in res.values():
        form["aggregate_gb_per_s"] = sum(form["bytes_out"]) / (max(form["ms"]) * 1e-3) / 1e9
    return res


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(*(int(a) for a in sys.argv[2:6]))
        return 0
    smi = shutil.which("nvidia-smi")
    machine = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip().splitlines()[0] \
        if smi else "no card"
    print(f"machine: {machine}; {os.cpu_count()} cores")
    out = {"machine": machine, "cores": os.cpu_count()}
    for nproc, ranks in LAYOUTS:
        out[f"{nproc}_processes"] = res = layout(nproc, ranks)
        for name, form in res.items():
            print(f"{nproc} processes on two declared hosts, {name}: an exchange "
                  + ", ".join(f"{v:.3f}" for v in form["ms"]) + " ms, "
                  f"{form['bytes_out'][0] / 1e6:.3f} MB out a process; aggregate "
                  f"{form['aggregate_gb_per_s']:.2f} GB/s over every process's sends")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Meshed ``rbc1025`` on four cards across two declared hosts, beside its
yardsticks, in one call.

    python3 scripts/cross_host_times.py      # on a machine with four cards

Four processes, a card each, run phase 37's spanning child of
``chip_smoke.py`` (50 captured steps of bare ``update_n``, ms/step; every
flip a step makes bit for bit its plain version, timed cold and warm; the
split of a step's flips) in two layouts:

* ``4x1_one_host``: the four processes on one host, every chunk through
  CUDA IPC (the remote flip's IPC form), with NCCL's
  ``all_to_all_single`` of each flip beside it over NCCL's default
  transport;
* ``2x2cards_two_hosts``: processes 0-1 declared on ``host0`` and 2-3 on
  ``host1`` (``initialize_distributed(..., host=)``), so a chunk crosses
  through CUDA IPC within a host and through the cross-host form (pinned
  staging, the socket exchange as a host node, the copy-in) between them,
  with NCCL's ``all_to_all_single`` of each flip beside it over its network
  transport on the same medium (the children's ``NCCL_P2P_DISABLE=1``,
  ``NCCL_SHM_DISABLE=1``, ``NCCL_IB_DISABLE=1``, ``NCCL_SOCKET_IFNAME=lo``:
  sockets on the loopback interface).

The two layouts run the same products on the same cards, so their states
must agree bit for bit; it fails otherwise.  It prints the card's name and
power limit, the measured pinned-copy rates, each process's ms/step, a
step's flips summed (cold, warm, NCCL, bound) and the split, and a JSON
line of it all.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

#: the layouts: (label, the declared hosts by rank or None, NCCL's
#: environment in the children)
LAYOUTS = (
    ("4x1_one_host", None, {}),
    ("2x2cards_two_hosts", cs.cross_host_hosts(4),
     {"NCCL_P2P_DISABLE": "1", "NCCL_SHM_DISABLE": "1", "NCCL_IB_DISABLE": "1",
      "NCCL_SOCKET_IFNAME": "lo"}),
)


def step_sums(records) -> dict:
    """A step's flips summed: each record's time times its flips a step."""
    out = {}
    for key in ("kernel_ms", "kernel_warm_ms", "nccl_ms", "bound_ms", "plain_ms"):
        vals = [(r["per_step"], r.get(key)) for r in records if r["per_step"]]
        out[key] = None if any(v is None for _, v in vals) else sum(k * v for k, v in vals)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("cross_host_times: needs four CUDA cards", file=sys.stderr)
        return 2
    from rustpde_mpi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    card = cs.card_line()
    print(f"card: {card}; build {time.perf_counter() - t0:.1f} s")
    pinned = cs.pinned_rates(torch)
    print(f"pinned copies of {cs.PINNED_BYTES >> 20} MiB: device to host "
          f"{pinned['d2h'] / 1e9:.2f} GB/s, host to device {pinned['h2d'] / 1e9:.2f} GB/s")
    summary = {"card": card, "pinned": pinned}
    with tempfile.TemporaryDirectory(prefix="cross_host_times_") as work:
        os.chdir(work)
        for label, hosts, env in LAYOUTS:
            t1 = time.perf_counter()
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                results = cs.span_spawn(label, 4, True, True, work, phase="cross_host_times",
                                        extra={"hosts": hosts, "cells": ["rbc1025"],
                                               "pinned": pinned})
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            want = {k: v * cs.SPAN_STEPS["rbc1025"] for k, v in cs.PER_STEP["mesh"].items()}
            want["ring_gather"] = cs.SPAN_STEPS["rbc1025"]
            for r in results:
                if r["rbc1025_launches"] != want:
                    raise AssertionError(f"{label} rank {r['rank']} launched "
                                         f"{r['rbc1025_launches']}, expected {want}")
            row = {"mesh": results[0]["mesh"], "remote": [r["remote"] for r in results],
                   "ms": [r["rbc1025_ms"] for r in results],
                   "flips": [step_sums(r["rbc1025_flips"]) for r in results],
                   "split": [r["split"]["step"] for r in results],
                   "seconds": time.perf_counter() - t1}
            summary[label] = row
            print(f"{label} ({row['mesh']}; other-host peers by rank {row['remote']}): meshed "
                  f"rbc1025 ms/step " + ", ".join(f"{v:.4f}" for v in row["ms"])
                  + f"; {row['seconds']:.1f} s ({card})")
            for r, sums in zip(results, row["flips"]):
                print(f"{label} rank {r['rank']} a step's 37 flips: cold {sums['kernel_ms']:.4f}, "
                      f"warm {sums['kernel_warm_ms']:.4f}, NCCL {sums['nccl_ms']:.4f}, bound "
                      f"{sums['bound_ms']:.4f}, plain (gloo) {sums['plain_ms']:.4f} ms")
            cs.print_split(label, results, card, "cross_host_times")
        a, b = (dict(np.load(os.path.join(work, f"{label}_rbc1025.npz")))
                for label, _, _ in LAYOUTS)
        exact = {k: bool(np.array_equal(a[k], b[k])) for k in a}
        print(f"the two layouts' states after {cs.SPAN_STEPS['rbc1025']} steps bit for bit: "
              f"{json.dumps(exact)}")
        if not all(exact.values()):
            raise AssertionError(f"the layouts' states differ: {exact}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

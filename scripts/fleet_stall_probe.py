#!/usr/bin/env python3
"""Where a fleet replica's lease renewals stall: ``chip_smoke.py`` phase
36's fleet run (a proxy, two replicas on one card, a SIGKILL, the
autoscaler's repair; its drain and gang parts left out) with three probes.

    python3 scripts/fleet_stall_probe.py [--device cuda|cpu] [--out DIR]

* This process polls every 25 ms the lease files (``queue/leases``) and the
  replicas' heartbeat files and reports each one's longest time between
  two changes (a renewal gap; the TTL is ``chip_smoke.FLEET_TTL_S``).
* It times an fsynced write and rename in the run directory every 0.1 s
  (the disk's latency beside the replicas' fsyncs).
* Each replica runs ``scripts/stall_hook/sitecustomize.py``: a sampler
  thread that logs when no Python thread of the replica could run for
  more than 0.3 s, and where the heartbeat thread sat while busy.

``--device cpu`` runs the same at 17^2 (a rehearsal).  It prints the
card's name and power limit, phase 36's summary line, the gaps and the
20 longest sampler lines, and writes ``events.json`` and the replicas'
``*.gaps`` files under ``--out`` (default ``fleet_stall_probe_out``).
On the card it needs a CUDA device and exits non-zero without one."""

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def monitor(work, events, stop):
    """Record every change of a lease or heartbeat file and an fsync probe."""
    run_dir = os.path.join(work, "fleet")
    probe = os.path.join(work, "probe.json")
    seen, last_probe = {}, 0.0
    while not stop.is_set():
        now = time.monotonic()
        for sub in ("queue/leases", "replicas"):
            root = os.path.join(run_dir, sub)
            try:
                names = [n for n in os.listdir(root) if n.endswith(".json")]
            except OSError:
                names = []
            for name in names:
                try:
                    with open(os.path.join(root, name), encoding="utf-8") as fh:
                        rec = json.load(fh)
                except (OSError, ValueError):
                    continue
                sig = (rec.get("seq"), rec.get("token"), rec.get("hb_mono"), rec.get("owner"))
                if seen.get((sub, name)) != sig:
                    seen[(sub, name)] = sig
                    events.append([now, sub, name, rec.get("owner") or rec.get("replica")])
        if now - last_probe > 0.1:
            t0 = time.monotonic()
            with open(probe + ".tmp", "w", encoding="utf-8") as fh:
                fh.write("x")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(probe + ".tmp", probe)
            fd = os.open(work, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            events.append([t0, "fsync", "probe", time.monotonic() - t0])
            last_probe = now
        time.sleep(0.025)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="fleet_stall_probe_out")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    import rustpde_mpi_tpu_torch as pt

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("fleet_stall_probe: no CUDA device is available", file=sys.stderr)
            return 2
        from rustpde_mpi_tpu_torch.ops import _build

        _build.build()
        card = cs.card_line()
    else:
        cs.CARD = "cpu"
        cs.ENSEMBLE129 = dict(ra=1e4, pr=1.0, nx=17, ny=17, dt=0.01, aspect=1.0, bc="rbc")
        cs.FLEET_CHUNK = 8
        torch.cuda.synchronize = lambda *a: None
        card = "cpu"
    print(f"card: {card}")
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    os.environ["STALL_PROBE_DIR"] = os.path.join(out, "gaps")
    # the replicas' PYTHONPATH (phase 36 passes chip_smoke.ROOT): the hook first
    cs.ROOT = os.path.join(ROOT, "scripts", "stall_hook") + os.pathsep + ROOT
    cs.phase36_drain = lambda *a, **k: None
    cs.phase36_gang = lambda *a, **k: {}
    work = tempfile.mkdtemp(prefix="phase36_")
    made = tempfile.TemporaryDirectory

    class Kept(made):  # phase 36's work directory, here, kept for the monitor
        def __init__(self, *a, **k):
            self.name = work

        def __enter__(self):
            return work

        def __exit__(self, *exc):
            return False

        def cleanup(self):
            pass

    events, stop = [], threading.Event()
    thread = threading.Thread(target=monitor, args=(work, events, stop), daemon=True)
    thread.start()
    tempfile.TemporaryDirectory = Kept
    os.chdir(tempfile.mkdtemp(prefix="fleet_stall_probe_"))
    t0 = time.monotonic()
    try:
        cs.phase36(torch, pt, card)
    finally:
        tempfile.TemporaryDirectory = made
        stop.set()
        thread.join()
        with open(os.path.join(out, "events.json"), "w", encoding="utf-8") as fh:
            json.dump(events, fh)
        times = {}
        for e in events:
            if e[1] != "fsync":
                times.setdefault((e[1], e[2], e[3]), []).append(e[0])
        for key, ts in sorted(times.items()):
            gaps = [b - a for a, b in zip(ts, ts[1:])]
            if gaps:
                i = max(range(len(gaps)), key=gaps.__getitem__)
                print(f"renewals {key}: {len(ts)} changes, longest gap {gaps[i]:.3f} s "
                      f"at +{ts[i] - t0:.3f} s")
        probes = sorted((e[3] for e in events if e[1] == "fsync"), reverse=True)
        if probes:
            print(f"fsync probe: {len(probes)} writes, longest {probes[0]:.4f} s, "
                  f"median {probes[len(probes) // 2]:.4f} s")
        lines = []
        gaps_dir = os.path.join(out, "gaps")
        for name in sorted(os.listdir(gaps_dir)) if os.path.isdir(gaps_dir) else []:
            with open(os.path.join(gaps_dir, name), encoding="utf-8") as fh:
                for line in fh:
                    part = line.split()
                    if part[0] in ("gap", "hb_done"):
                        lines.append((float(part[2] if part[0] == "gap" else part[3]),
                                      name, line.strip()))
        for dur, name, line in sorted(lines, reverse=True)[:20]:
            print(f"sampler {name}: {line[:600]}")
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device time of the pencil flips of three meshed steps, for comparing two
source trees, or builds of one tree's flip kernel, on one card.

    python3 scripts/flip_times.py <tree> [DEFINES ...]

``<tree>`` is the root of a checkout of the repo (this one, or another
commit unpacked with ``git archive``).  The script imports that tree's
``rustpde_mpi_tpu_torch`` and logs the flips of one step of the meshed
``rbc1025`` model (4 ranks on the card, f64), of ``ensemble129`` with
K = 32 members and of ``rbc1025`` with K = 2 members.  Each ``DEFINES`` is
a build of the tree's ``csrc/ring_transpose.cu`` with extra macros, written
``NAME=VALUE,NAME=VALUE`` (``default``: none); with none given, the
default build alone.  Every build runs each flip once against its plain
version (bit for bit, one launch), then, in two rounds over the builds,
times each step's flips summed over their counts: with the L2 flushed
(``cold_ms``, a 512 MB write and a GPU spin before each launch, CUDA
events around it, as ``chip_smoke.py`` times them), with the L2 emptied by
a 512 MB read (``cold_clean_ms``: no dirty lines to write back) and back
to back behind a GPU spin (``warm_ms``), beside
``.contiguous()`` of the permuted view timed the same two ways
(``library_*``) and the bytes bound at 3.35 TB/s.  It prints one JSON line
a build and round, and the card's name and power limit first.  It needs a
CUDA card and exits non-zero without one.
"""

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLD_REPS = 20
WARM_REPS = 50


def chip_smoke():
    """This repo's ``chip_smoke.py`` as a module (its timers and the step
    loggers), whichever tree is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_flips(torch, pt, cs):
    """``{cell: [(block, x_to_y, count), ...]}``: one step's flips of each
    meshed cell, each distinct input once with random values."""
    out = {}
    model = pt.Navier2D.new_confined(**cs.RBC1025, mesh=pt.make_mesh(cs.MESH_RANKS))
    flips, _, _ = cs.step_inputs(torch, model)
    gen = torch.Generator(device="cuda").manual_seed(16)
    out["rbc1025"] = [(torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
                       .to(getattr(torch, dtype)), x_to_y, count)
                      for (shape, x_to_y, dtype), count in sorted(flips.items())]
    for cell, cfg, k in (("ensemble129_K32", cs.ENSEMBLE129, 32), ("rbc1025_K2", cs.RBC1025, 2)):
        ens = pt.NavierEnsemble.from_seeds(cs.route_model(pt, cfg, "mesh"), range(k))
        log = cs.logged_step_inputs(torch, ens)
        out[cell] = [(given.clone(), key[2], count) for key, (count, given) in sorted(
            log.items(), key=str) if key[0] == "flip"]
        del ens
    ring = model.mesh.ring
    del model
    torch.cuda.empty_cache()
    return out, ring


def library(cs, block, p, x_to_y):
    """``.contiguous()`` of the permuted view, with or without members."""
    if block.ndim == 4:
        return cs.member_ring_library(block, p, x_to_y)
    return cs.ring_library(block, p, x_to_y)


def check(torch, ring, cells):
    for cell, flips in cells.items():
        for block, x_to_y, _ in flips:
            before = ring.launches
            out = ring.apply(block, x_to_y)
            torch.cuda.synchronize()
            if not torch.equal(out, ring.plain(block, x_to_y)) or ring.launches != before + 1:
                raise AssertionError(f"{cell} {tuple(block.shape)} x_to_y={x_to_y}: the kernel "
                                     "differs from its plain version or did not launch once")


def clean_cold_ms(torch, cs, fn) -> float:
    """As ``time_cold_ms``, with the L2 emptied of the flip's data by a
    512 MB read in place of a write: the cache then holds clean lines, and
    the reading leaves out the write-back of the flush's dirty ones."""
    flush = torch.ones(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(COLD_REPS):
        flush.sum()
        torch.cuda._sleep(cs.SLEEP_CYCLES // 50)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / COLD_REPS


def times(torch, cs, ring, cells) -> dict:
    out = {}
    p = ring.nranks
    for cell, flips in cells.items():
        row = dict(cold_ms=0.0, cold_clean_ms=0.0, warm_ms=0.0, library_cold_ms=0.0,
                   library_cold_clean_ms=0.0, library_warm_ms=0.0, bound_ms=0.0,
                   flips=sum(n for _, _, n in flips))
        for block, x_to_y, n in flips:
            def run(b=block, d=x_to_y):
                return ring.apply(b, d)

            def lib(b=block, d=x_to_y):
                return library(cs, b, p, d)

            row["cold_ms"] += n * cs.time_cold_ms(torch, run, COLD_REPS)
            row["cold_clean_ms"] += n * clean_cold_ms(torch, cs, run)
            row["warm_ms"] += n * cs.time_queued_ms(torch, run, WARM_REPS)[0]
            row["library_cold_ms"] += n * cs.time_cold_ms(torch, lib, COLD_REPS)
            row["library_cold_clean_ms"] += n * clean_cold_ms(torch, cs, lib)
            row["library_warm_ms"] += n * cs.time_queued_ms(torch, lib, WARM_REPS)[0]
            row["bound_ms"] += n * ring.bytes_moved(block) / (cs.HBM_TB_PER_S * 1e12) * 1e3
        out[cell] = row
    return out


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree = sys.argv[1]
    builds = sys.argv[2:] or ["default"]
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("flip_times: no CUDA device is available", file=sys.stderr)
        return 2
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.ops import _build

    cs = chip_smoke()
    print(f"card: {cs.card_line()}", flush=True)
    base_flags = _build.NVCC_FLAGS
    cells, ring = step_flips(torch, pt, cs)

    def use(build):
        defines = [] if build == "default" else [f"-D{d}" for d in build.split(",")]
        _build.NVCC_FLAGS = (*base_flags, *defines)
        _build._loaded.pop("ring_transpose", None)
        _build.load("ring_transpose")

    for build in builds:
        use(build)
        check(torch, ring, cells)
    for rnd in range(2):
        for build in builds:
            use(build)
            print(json.dumps({"tree": tree, "build": build, "round": rnd,
                              **times(torch, cs, ring, cells)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

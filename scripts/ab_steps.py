#!/usr/bin/env python3
"""Time the port's bare ``update_n`` on full-size cells, for comparing two
source trees on one card.

    python3 scripts/ab_steps.py <tree> [CELL ...]

``<tree>`` is the root of a checkout of the repo (this one, or another
commit unpacked with ``git archive``).  The script imports that tree's
``rustpde_mpi_tpu_torch``, builds its kernels, and for each cell builds
the model, captures its chunk graph, runs 5 steps, then times 7 chunks of
``update_n(50)`` (host clock, ended by ``torch.cuda.synchronize``).  The
cells (``chip_smoke.py``'s configurations, meshes of 4 ranks on the card):

* ``mesh``, ``dense``, ``fused``: ``rbc1025`` on that route (the default,
  all three);
* ``periodic1024_mesh``: ``periodic1024`` on the mesh;
* ``rbc1025_scn_mesh``: ``rbc1025`` with the Coriolis term, the matched
  scalar and the roughness obstacle, on the mesh;
* ``ensemble129_K32_mesh``: ``ensemble129`` with K = 32 members on the
  mesh, read as member-steps/s (its K-member step one graph replay).

It prints one line: the tree, and per cell the median ms/step (and, for an
ensemble, member-steps/s) and the 7 readings.  Run the trees alternately
in one call on one card (A, B, B, A, ...): two calls may land on two cards.
It needs a CUDA card and exits non-zero without one.
"""

import importlib.util
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ("mesh", "dense", "fused")


def chip_smoke():
    """This repo's ``chip_smoke.py`` as a module (its configurations and
    model builders), whichever tree is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(pt, cs, cell):
    """``(stepper, members)`` of ``cell``: an object with ``update_n``."""
    if cell in ROUTES:
        return pt.Navier2D.new_confined(**cs.RBC1025, **(
            dict(mesh=pt.make_mesh(cs.MESH_RANKS)) if cell == "mesh" else
            dict(device="cuda", **(cs.DENSE if cell == "dense" else {})))), 1
    if cell == "periodic1024_mesh":
        model = pt.Navier2D(**cs.PERIODIC1024, mesh=pt.make_mesh(cs.MESH_RANKS))
        model.init_random(0.1, seed=0)
        return model, 1
    if cell == "rbc1025_scn_mesh":
        return cs.scenario_model(pt, cs.RBC1025, "mesh"), 1
    if cell == "ensemble129_K32_mesh":
        model = cs.route_model(pt, cs.ENSEMBLE129, "mesh")
        return pt.NavierEnsemble.from_seeds(model, range(32), amp=0.1), 32
    raise SystemExit(f"ab_steps: unknown cell {cell!r}")


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = sys.argv[1]
    cells = sys.argv[2:] or list(ROUTES)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("ab_steps: no CUDA device is available", file=sys.stderr)
        return 2
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.ops import _build

    cs = chip_smoke()
    _build.build()
    out = {}
    for cell in cells:
        model, k = build(pt, cs, cell)
        model.chunk_runner()
        model.update_n(5)
        readings = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.update_n(50)
            torch.cuda.synchronize()
            readings.append((time.perf_counter() - t0) / 50 * 1e3)
        ms = statistics.median(readings)
        out[cell] = (round(ms, 4), [round(x, 4) for x in readings])
        if k > 1:
            out[cell] += (round(k * 1e3 / ms, 1),)
        del model
        torch.cuda.empty_cache()
    print(root, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's bare ``update_n`` at ``rbc1025`` on the meshed, dense and
fused routes, for comparing two source trees on one card.

    python3 scripts/ab_steps.py <tree>

``<tree>`` is the root of a checkout of the repo (this one, or another
commit unpacked with ``git archive``).  The script imports that tree's
``rustpde_mpi_tpu_torch``, builds its kernels, and for each route builds
the model, captures its chunk graph, runs 5 steps, then times 7 chunks of
``update_n(50)`` (host clock, ended by ``torch.cuda.synchronize``).  It
prints one line: the tree, and per route the median ms/step and the 7
readings.  Run the trees alternately in one call on one card (A, B, B, A,
...): two calls may land on two cards.  It needs a CUDA card and exits
non-zero without one.
"""

import statistics
import sys
import time


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("ab_steps: no CUDA device is available", file=sys.stderr)
        return 2
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.ops import _build

    _build.build()
    cfg = dict(nx=1025, ny=1025, ra=1e9, pr=1.0, dt=1e-4, aspect=1.0, bc="rbc")
    routes = (("mesh", dict(mesh=pt.make_mesh(4))),
              ("dense", dict(device="cuda", step_kernel="dense", conv_kernel="dense")),
              ("fused", dict(device="cuda")))
    out = {}
    for route, kw in routes:
        model = pt.Navier2D.new_confined(**cfg, **kw)
        model.chunk_runner()
        model.update_n(5)
        readings = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.update_n(50)
            torch.cuda.synchronize()
            readings.append((time.perf_counter() - t0) / 50 * 1e3)
        out[route] = (round(statistics.median(readings), 4), [round(x, 4) for x in readings])
        del model
        torch.cuda.empty_cache()
    print(root, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

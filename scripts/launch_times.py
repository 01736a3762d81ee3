#!/usr/bin/env python3
"""Device time of single kernel launches of the port at the ``rbc1025`` step
shapes, for comparing two source trees on one card.

    python3 scripts/launch_times.py <tree>

``<tree>`` is the root of a checkout of the repo (this one, or another
commit unpacked with ``git archive``).  The script imports that tree's
``rustpde_mpi_tpu_torch``, builds its kernels, and times each operation as
100 launches captured in one CUDA graph (the best of 5 replays, in µs a
launch): the pencil flips of a meshed step (16-byte and 8-byte paths), the
meshed Poisson and ADI banded solves, the freeze's select with a 0-d and a
broadcast flag, four fused stages and a convection chain at 1025², and a
16x16x16 generic GEMM (the launch's own cost).  It prints one line: the
tree and a JSON object of the times.  Run the trees alternately in one call
on one card; it needs a CUDA card.
"""

import json
import sys


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = sys.argv[1]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("launch_times: no CUDA device is available", file=sys.stderr)
        return 2
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.ops import _build

    _build.build()

    def graph_us(fn, reps=100):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / reps)
        return best * 1e3

    rng = np.random.default_rng(0)

    def rand(shape):
        return torch.tensor(rng.uniform(-1.0, 1.0, shape), device="cuda")

    out = {}
    mesh = pt.make_mesh(4)
    ring = mesh.ring
    for shape, x_to_y in (((4, 1024, 256), True), ((4, 1028, 257), True),
                          ((4, 256, 1024), False), ((4, 257, 1028), False)):
        block = rand(shape)
        out[f"flip{list(shape)}"] = graph_us(lambda b=block, d=x_to_y: ring.apply(b, d))
    meshed = pt.Navier2D(1025, 1025, 1e9, 1.0, 1e-4, 1.0, "rbc", mesh=mesh)
    poisson = meshed.solver_pres._solver.banded
    adi = meshed.solver_velx.solvers[1].solver
    rhs, rhs2 = rand((4, 256, 1024)), rand((4, 256, 1024))
    out["banded_poisson_meshed"] = graph_us(lambda: poisson.solve(rhs, 2, factor_batch_stride=256))
    out["banded_adi_meshed"] = graph_us(lambda: adi.solve(rhs2, 2))
    f, f2 = rand((4, 256, 1024)), rand((4, 256, 1024))
    keep = torch.ones((), dtype=torch.bool, device="cuda")
    out["where_0d_flag"] = graph_us(lambda: torch.where(keep, f2, f, out=f))
    out["where_broadcast_flag"] = graph_us(lambda: torch.where(keep.reshape(1, 1, 1), f2, f, out=f))
    fused = pt.Navier2D(1025, 1025, 1e9, 1.0, 1e-4, 1.0, "rbc", device="cuda")
    for tag in ("velx", "div", "poisson", "projx"):
        st = fused._stages[tag]
        xs = [rand((k0, k1)) for k0, k1 in zip(st.k0, st.k1)]
        out[f"stage_{tag}"] = graph_us(lambda st=st, xs=xs: st.apply(*xs), 20)
    fc = fused._convs[id(fused.velx_space)]
    args = [rand(s) for s in ((1025, 1025), (1025, 1025), (fc.mx, fc.my))]
    out["conv"] = graph_us(lambda: fc.apply(*args), 20)
    a = torch.ones((16, 16), device="cuda", dtype=torch.float64)
    c = torch.empty((16, 16), device="cuda", dtype=torch.float64)
    gemm = _build.gemm(torch.float64)
    job = _build.job(c, [(a, a)], M=16, N=16)
    out["gemm_16x16x16"] = graph_us(lambda: _build.launch_jobs(gemm, [job], c.device), 200)
    print(root, json.dumps({k: round(v, 3) for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

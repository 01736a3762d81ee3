#!/usr/bin/env python3
"""Whether a batched cuBLAS product rounds as the lone one does, on the card.

    python3 scripts/batched_gemm_bits.py

An ensemble's members go through the transforms as one product over a
member dim, a solo model as a lone product.  For n in 129, 513 and 1025 it
checks, member by member against four lone ``torch.matmul`` calls, whether
these forms of the same products are bit for bit equal: the folded product
``x @ mat.T`` of a ``(4, n, n)`` stack, ``torch.bmm`` with the matrix
expanded, ``mat @ x``, and the members side by side as one wide product;
and a 1-member stack.  Then the ``rbc1025`` dense model's temperature
solve (``HholtzAdi``) of a 2-member stack against the lone solve of member
0: its relative difference, which the preconditioned Chebyshev systems
amplify from the transforms' last bits.  It needs a CUDA card.
"""

import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("batched_gemm_bits: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import rustpde_mpi_tpu_torch as pt

    torch.manual_seed(0)
    for n in (129, 513, 1025):
        mat = torch.randn(n, n, dtype=torch.float64, device="cuda")
        x = torch.randn(4, n, n, dtype=torch.float64, device="cuda")
        last = [torch.matmul(x[i], mat.T) for i in range(4)]
        first = [torch.matmul(mat, x[i]) for i in range(4)]

        def same(a, lone):
            return all(torch.equal(a[i], lone[i]) for i in range(4))

        wide = torch.matmul(mat, x.permute(1, 0, 2).reshape(n, 4 * n))
        print(n, "x @ mat.T: folded", same(torch.matmul(x, mat.T), last),
              "bmm", same(torch.bmm(x, mat.T.expand(4, n, n)), last),
              "| mat @ x: matmul", same(torch.matmul(mat, x), first),
              "bmm", same(torch.bmm(mat.expand(4, n, n), x), first),
              "wide", same(wide.reshape(n, 4, n).permute(1, 0, 2), first),
              "| one member", torch.equal(torch.matmul(x[:1], mat.T)[0], last[0]))
    model = pt.Navier2D(1025, 1025, 1e9, 1.0, 1e-4, 1.0, "rbc", device="cuda",
                        step_kernel="dense", conv_kernel="dense")
    model.init_random(0.1, seed=0)
    rhs = model.temp_space.to_ortho(model.state.temp)
    both = model.solver_temp.solve(torch.stack([rhs, 0.7 * rhs]))[0]
    lone = model.solver_temp.solve(rhs)
    rel = float(torch.max(torch.abs(both - lone)) / torch.max(torch.abs(lone)))
    print(f"rbc1025 dense temperature solve, member 0 of 2 against the lone solve: "
          f"bit for bit {torch.equal(both, lone)}, rel {rel:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

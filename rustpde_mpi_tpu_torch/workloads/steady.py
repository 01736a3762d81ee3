"""Steady-state finds as a batched workload (counterpart of the part of
the JAX package's ``workloads/steady.py`` that runs without its resilient
runner): K adjoint-descent finders as one ensemble, whose residual
convergence is the chunk's continue criterion, so a converged member
freezes at its converged state inside the chunk
(:meth:`..models.ensemble.NavierEnsemble.done_ok_members` names it).  The
checkpointed find (``steady_state_find``) runs under the resilient
runner, which is not ported yet."""

from __future__ import annotations


def build_steady_ensemble(*, nx: int, ny: int, ra: float, pr: float = 1.0, dt: float = 5e-3,
                          aspect: float = 1.0, bc: str = "rbc", periodic: bool = False,
                          res_tol: float | None = None, k: int = 1, amp: float = 0.5,
                          seeds=None, mesh=None, **kw):
    """K finders: member 0 seeded on the large-scale circulation mode,
    further members on random initial conditions (``seeds``, default 1 ..
    K-1), whose basins of attraction differ.  Keyword arguments
    (``device``, ``dtype``, the step routes) go to the model."""
    from ..models.ensemble import NavierEnsemble
    from ..models.steady_adjoint import RES_TOL
    from .registry import build_model

    model = build_model("adjoint", nx, ny, ra, pr, dt, aspect, bc, periodic, mesh=mesh,
                        scenario={"res_tol": float(res_tol if res_tol is not None else RES_TOL)},
                        **kw)
    model.set_temperature(amp, 1.0, 1.0)
    model.set_velocity(amp, 1.0, 1.0)
    members = [model.state]
    seeds = list(seeds) if seeds is not None else list(range(1, k))
    for seed in seeds[: max(0, k - 1)]:
        model.init_random(amp, seed=int(seed))
        members.append(model.state)
    return NavierEnsemble(model, members)

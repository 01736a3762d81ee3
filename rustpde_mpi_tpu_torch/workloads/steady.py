"""Steady-state finds as a batched workload (counterpart of the part of
the JAX package's ``workloads/steady.py`` that runs without its resilient
runner): K adjoint-descent finders as one ensemble, whose residual
convergence is the chunk's continue criterion, so a converged member
freezes at its converged state inside the chunk
(:meth:`..models.ensemble.NavierEnsemble.done_ok_members` names it).
:func:`steady_state_find` drives the find under
:class:`..utils.resilience.ResilientRunner`: checkpoints on a cadence,
auto-resume (a killed find continues its descent), per-member fault
isolation.  As in the JAX package the find's checkpoints are sharded
two-phase ones."""

from __future__ import annotations

import numpy as np


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


def steady_state_find(*, nx: int = 17, ny: int = 17, ra: float = 100.0, pr: float = 1.0,
                      dt: float = 1e-3, aspect: float = 1.0, bc: str = "rbc",
                      periodic: bool = False, res_tol: float = 1e-7, k: int = 1,
                      amp: float = 0.5, seeds=None, max_iters: int = 20000, chunk: int = 200,
                      run_dir: str = "data/steady_find", checkpoint_every_s: float | None = None,
                      checkpoint_every_iters: int | None = None, fault: str | None = None,
                      stability=None, mesh=None, install_signals: bool = True, _store=None,
                      **kw) -> dict:
    """Run a K-member find to convergence (or ``max_iters``): each chunk's
    per-member residuals arrive with the observables, members freeze at
    convergence inside the chunk, and the campaign ends when every member is
    converged or dead.  Checkpoints and auto-resume live in ``run_dir``
    (``_store``: the runner's private checkpoint store, None for files); a
    converged or preempted find checkpoints its state.  Keyword arguments
    (``device``, ``dtype``, the step routes) go to the model.

    Returns ``{"converged" (per member), "residuals", "nu", "iterations",
    "preempted", "resumed", "checkpoint"}``."""
    from ..config import IOConfig
    from ..utils.resilience import ResilientRunner

    ens = build_steady_ensemble(nx=nx, ny=ny, ra=ra, pr=pr, dt=dt, aspect=aspect, bc=bc,
                                periodic=periodic, res_tol=res_tol, k=k, amp=amp, seeds=seeds,
                                mesh=mesh, **kw)
    runner = ResilientRunner(ens, max_time=float("inf"), run_dir=run_dir,
                             checkpoint_every_s=checkpoint_every_s, stability=stability,
                             fault=fault if fault is not None else "",
                             io=IOConfig(sharded_checkpoints=True, overlap_dispatch=False),
                             _store=_store)
    preempted = False
    with runner.session(install_signals=install_signals):
        last_ckpt_step = runner.step
        while runner.step < max_iters:
            res = np.asarray(ens.get_observables()[0])
            done = ens.done_ok_members()
            # finished: converged (done) or dead (NaN); +inf means not yet
            if bool((done | np.isnan(res) | (res < res_tol)).all()):
                break
            before = runner.step
            runner.advance(min(chunk, max_iters - runner.step))
            if runner.step == before:
                break  # no progress (every member frozen inside the chunk)
            if runner.on_boundary() or runner.drain_requested():
                preempted = True
                break
            if checkpoint_every_iters and runner.step - last_ckpt_step >= checkpoint_every_iters:
                runner.checkpoint_now("cadence_iters")
                last_ckpt_step = runner.step
        final_res = np.asarray(ens.get_observables()[0])
        converged = np.isfinite(final_res) & (final_res < res_tol)
        if converged.any() or preempted:
            # the converged state is the answer; a preempted one resumes
            runner.checkpoint_now("preempt" if preempted else "final")
    nus = []
    model = ens.model
    keep = model.state
    for i in range(ens.k):
        try:
            # the Nusselt number of each member's final iterate
            model.state = ens.member_state(i)
            model._obs_cache = None
            nus.append(float(model.eval_nu()))
        except Exception:
            nus.append(float("nan"))
    model.state = keep
    model._obs_cache = None
    return {
        "converged": [bool(c) for c in converged],
        "residuals": [float(r) for r in final_res],
        "nu": nus,
        "iterations": int(runner.step),
        "preempted": preempted,
        "resumed": bool(runner.resumed),
        "checkpoint": runner.last_checkpoint,
    }

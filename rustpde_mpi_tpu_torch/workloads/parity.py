"""Per-model solo-vs-ensemble parity (counterpart of the JAX package's
``workloads/parity.py``): one tiny campaign per model kind, K = 2 members
stepped as an ensemble against the same trajectories stepped solo, the
largest relative deviation of any state leaf recorded per kind."""

from __future__ import annotations

import numpy as np

#: tiny shapes: parity is about code paths, not physics
_DEFAULTS = dict(nx=17, ny=17, ra=1e4, pr=1.0, aspect=1.0, bc="rbc")


def _build(kind: str, dt: float, **kw):
    from .registry import build_model

    d = _DEFAULTS
    return build_model(kind, d["nx"], d["ny"], d["ra"], d["pr"], dt, d["aspect"], d["bc"],
                       False, **kw)


def _seed(model, kind: str, seed: int) -> None:
    if kind == "adjoint":
        model.set_temperature(0.3 + 0.1 * seed, 1.0, 1.0)
        model.set_velocity(0.3 + 0.1 * seed, 1.0, 1.0)
    else:
        model.init_random(1e-2, seed=seed)


def solo_ensemble_parity(kinds=("dns", "lnse", "adjoint"), steps: int = 8, **kw) -> dict:
    """``{kind: {"max_rel_diff", "steps", "k"}}``: the largest relative
    deviation of every state leaf between a K = 2 ensemble and the members'
    solo runs after ``steps`` steps (the same initial conditions and dt).
    Keyword arguments (``device``, the routes) go to the models."""
    from ..models.ensemble import NavierEnsemble

    out = {}
    for kind in kinds:
        dt = 5e-3 if kind == "adjoint" else 1e-2
        model = _build(kind, dt, **kw)
        members = []
        for seed in (0, 1):
            _seed(model, kind, seed)
            members.append(model.state)
        ens = NavierEnsemble(model, members)
        ens.update_n(steps)
        worst = 0.0
        for i, seed in enumerate((0, 1)):
            # a fresh model per member: seeding rewrites only the initial
            # fields, and a reused model would carry over pres and pseu
            solo = _build(kind, dt, **kw)
            _seed(solo, kind, seed)
            solo.update_n(steps)
            for got, want in zip(ens.member_state(i), solo.state):
                got, want = got.cpu().numpy(), want.cpu().numpy()
                scale = float(np.max(np.abs(want)))
                if scale == 0.0 or not np.isfinite(scale):
                    continue
                worst = max(worst, float(np.max(np.abs(got - want))) / scale)
        out[kind] = {"max_rel_diff": worst, "steps": int(steps), "k": 2}
    return out

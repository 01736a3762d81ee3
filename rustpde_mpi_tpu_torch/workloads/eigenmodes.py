"""Linear stability analysis as a batched workload (counterpart of the
part of the JAX package's ``workloads/eigenmodes.py`` that runs without
its resilient runner): the linearised model evolves a perturbation about a
base state, and after the transient the energy of the leading eigenmode
behaves as ``E(t) ~ exp(2 sigma t)``, so the leading growth rate is half
the slope of ``ln E`` over the sampled trajectory.

* :func:`build_eigenmode_ensemble`: one Rayleigh number's ensemble, K
  members of the linearised model seeded on different horizontal modes;
* :func:`growth_rates`: per-member rates from sampled energies;
* :func:`critical_rayleigh`: the zero crossing of the leading rate over a
  sweep, for the rigid-rigid layer near Chandrasekhar's ``Ra_c =
  1707.76`` at ``k_c = 3.117``.

* :func:`eigenmode_sweep`: the sweep over Rayleigh numbers, each one an
  ensemble campaign under :class:`..utils.resilience.ResilientRunner`
  (checkpoints and auto-resume per Ra with a ``run_dir``; a completed Ra's
  checkpoints are removed).  As in the JAX package the sweep's checkpoints
  are sharded two-phase ones, which restore at the same K bit for bit.
"""

from __future__ import annotations

import math
import os

import numpy as np

#: Chandrasekhar's rigid-rigid critical Rayleigh number and wavenumber
#: ``a_c = k_c d`` (d the layer depth)
RAC_RIGID = 1707.762
AC_RIGID = 3.117


def critical_aspect(mode: int = 1) -> float:
    """The aspect ratio that puts horizontal mode ``mode`` at the
    rigid-rigid critical wavenumber (the layer depth is 2, so ``k_c = a_c /
    2``)."""
    return float(mode) / (AC_RIGID / 2.0)


def build_eigenmode_ensemble(*, nx: int, ny: int, ra: float, pr: float = 1.0, dt: float = 0.05,
                             aspect: float | None = None, bc: str = "rbc", periodic: bool = True,
                             modes=(1,), amp: float = 1e-4, mesh=None, **kw):
    """One Rayleigh number of the sweep: K = ``len(modes)`` members of the
    linearised model, member ``i`` seeded on horizontal mode ``modes[i]``
    (a velocity and temperature eigenmode shape, close to the
    eigenfunction, so the transient is short).  Keyword arguments
    (``device``, ``dtype``) go to the model."""
    from ..models.ensemble import NavierEnsemble
    from .registry import build_model

    if aspect is None:
        aspect = critical_aspect(1)
    model = build_model("lnse", nx, ny, ra, pr, dt, aspect, bc, periodic, mesh=mesh, **kw)
    members = []
    for m in modes:
        model.set_velocity(amp, float(m), 1.0)
        model.set_temperature(amp, float(m), 1.0)
        members.append(model.state)
    return NavierEnsemble(model, members)


def growth_rates(times, energies, fit_fraction: float = 0.5) -> np.ndarray:
    """Per-member leading growth rates from sampled energies ``(samples,
    K)``: the least-squares slope of ``ln E`` over the last
    ``fit_fraction`` of the samples, halved (the energy grows at twice the
    amplitude's rate).  A member whose energy is not finite and positive
    reports NaN."""
    times = np.asarray(times, dtype=np.float64)
    energies = np.asarray(energies, dtype=np.float64)
    n = len(times)
    start = max(0, min(n - 2, int(round(n * (1.0 - fit_fraction)))))
    t = times[start:]
    out = np.full(energies.shape[1], np.nan)
    for i in range(energies.shape[1]):
        e = energies[start:, i]
        if not (np.isfinite(e).all() and (e > 0).all()):
            continue
        out[i] = 0.5 * np.polyfit(t, np.log(e), 1)[0]
    return out


def critical_rayleigh(results) -> float:
    """The zero crossing of the leading growth rate over a sweep (rows
    ``{"ra", "sigma_max"}``), interpolated linearly in Ra.  Raises
    ``ValueError`` when the sweep does not bracket the sign change."""
    rows = sorted((r for r in results if math.isfinite(r["sigma_max"])), key=lambda r: r["ra"])
    for lo, hi in zip(rows, rows[1:]):
        s0, s1 = lo["sigma_max"], hi["sigma_max"]
        if s0 <= 0.0 <= s1:
            if s1 == s0:
                return 0.5 * (lo["ra"] + hi["ra"])
            return lo["ra"] - s0 * (hi["ra"] - lo["ra"]) / (s1 - s0)
    raise ValueError("sweep does not bracket the growth-rate sign change: "
                     + ", ".join(f"Ra={r['ra']:g}: sigma={r['sigma_max']:.3e}" for r in rows))


def eigenmode_sweep(ras, *, nx: int = 8, ny: int = 17, pr: float = 1.0, dt: float = 0.05,
                    aspect: float | None = None, bc: str = "rbc", periodic: bool = True,
                    modes=(1,), amp: float = 1e-4, horizon: float = 40.0, samples: int = 16,
                    run_dir: str | None = None, checkpoint_every_s: float | None = None,
                    stability=None, fault: str | None = None, mesh=None, _store=None,
                    **kw) -> list[dict]:
    """The leading growth rate over ``ras``, each Ra an ensemble campaign
    (:func:`build_eigenmode_ensemble`) driven by
    :class:`..utils.resilience.ResilientRunner`: energies sampled at
    ``samples`` chunk boundaries over ``horizon`` time units and fitted by
    :func:`growth_rates`.  With a ``run_dir`` each Ra checkpoints into
    ``<run_dir>/ra<Ra>`` and resumes from it (a killed sweep continues
    mid-sweep), and a completed Ra removes its spent checkpoints, so a later
    sweep over the directory measures afresh; ``run_dir=None`` runs without
    resume in a temporary directory.  ``_store``: a factory ``run_dir ->
    store`` for the runner's private checkpoint store (None: files).
    Keyword arguments (``device``, ``dtype``) go to the model.

    Returns one dict per Ra: ``{"ra", "modes", "sigma" (per member),
    "sigma_max", "steps", "times", "energies", "resumed"}``."""
    import shutil
    import tempfile

    from ..config import IOConfig
    from ..utils.resilience import ResilientRunner

    results = []
    steps_total = max(samples, int(round(horizon / dt)))
    chunk = max(1, steps_total // samples)
    tmp_root = tempfile.mkdtemp(prefix="eigenmode_sweep_") if run_dir is None else None
    try:
        for ra in ras:
            ens = build_eigenmode_ensemble(nx=nx, ny=ny, ra=float(ra), pr=pr, dt=dt,
                                           aspect=aspect, bc=bc, periodic=periodic, modes=modes,
                                           amp=amp, mesh=mesh, **kw)
            ra_dir = os.path.join(tmp_root or run_dir, f"ra{float(ra):g}")
            runner = ResilientRunner(ens, max_time=float("inf"), run_dir=ra_dir,
                                     checkpoint_every_s=checkpoint_every_s, stability=stability,
                                     fault=fault if fault is not None else "",
                                     resume=tmp_root is None,
                                     io=IOConfig(sharded_checkpoints=True, overlap_dispatch=False),
                                     _store=None if _store is None else _store(ra_dir))
            times, energies = [], []
            drained = False
            with runner.session(install_signals=False):
                # a resumed run re-enters mid-trajectory: skip what is done
                while runner.step < steps_total:
                    before = runner.step
                    runner.advance(min(chunk, steps_total - runner.step))
                    if runner.step == before:
                        break  # a governor re-plan made no progress
                    times.append(float(ens.get_time()))
                    energies.append(np.asarray(ens.get_observables()[0]))
                    if runner.drain_requested():
                        drained = True
                        runner.checkpoint_now("preempt")
                        break
                if runner.step >= steps_total and not drained:
                    # done and fitted: the checkpoints were insurance, now spent
                    runner.drain_io()
                    for path in runner._store.files():
                        runner._store.remove(path)
            sigma = (growth_rates(times, np.stack(energies)) if len(times) >= 2
                     else np.full(len(tuple(modes)), np.nan))
            results.append({
                "ra": float(ra),
                "modes": list(modes),
                "sigma": [float(s) for s in sigma],
                "sigma_max": float(np.nanmax(sigma)) if np.isfinite(sigma).any()
                else float("nan"),
                "steps": int(runner.step),
                "times": [float(t) for t in times],
                "energies": [[float(v) for v in row] for row in energies],
                "resumed": bool(runner.resumed),
            })
    finally:
        if tmp_root is not None:
            shutil.rmtree(tmp_root, ignore_errors=True)
    return results

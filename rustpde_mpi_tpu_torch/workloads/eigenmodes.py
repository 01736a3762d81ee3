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

The sweep itself (``eigenmode_sweep``) runs under the JAX package's
resilient runner, which is not ported yet.
"""

from __future__ import annotations

import math

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

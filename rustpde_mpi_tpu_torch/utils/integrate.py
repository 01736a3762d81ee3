"""Time-integration driver (counterpart of the JAX package's
``utils/integrate.py``, chunked form).

The model advances whole save intervals per ``update_n`` call; the callback
fires when the time lands inside the half-dt window around a save boundary,
and the model's ``exit()`` is checked at every boundary.  Statuses:
``"time_limit"`` | ``"timestep_limit"`` | ``"break"`` (``exit()`` fired).
"""

from __future__ import annotations

import math

MAX_TIMESTEP = 10_000_000


def _next_boundary(t: float, dt: float, save_intervall: float) -> float:
    """First absolute save boundary ``k * save_intervall`` strictly after
    ``t`` (half-dt tolerance, so a time that just landed on a boundary
    targets the following one)."""
    return (math.floor((t + dt / 2.0) / save_intervall) + 1) * save_intervall


def integrate(pde, max_time: float, save_intervall: float | None = None) -> str:
    """Advance ``pde`` until ``max_time``, calling ``pde.callback()`` at each
    save boundary; returns the stop status."""
    timestep = 0
    while True:
        dt = pde.get_dt()
        t = pde.get_time()
        if t + dt * 1e-4 >= max_time:
            break
        boundary = None
        target = max_time
        if save_intervall is not None:
            boundary = _next_boundary(t, dt, save_intervall)
            target = min(boundary, max_time)
        n = min(max(1, round((target - t) / dt)), MAX_TIMESTEP - timestep)
        pde.update_n(n)
        timestep += n
        if boundary is not None and abs(pde.get_time() - boundary) < dt / 2.0:
            pde.callback()
        if timestep >= MAX_TIMESTEP:
            print(f"timestep limit reached: {timestep}")
            return "timestep_limit"
        if pde.exit():
            print("break criteria triggered")
            return "break"
    print(f"time limit reached: {pde.get_time()}")
    return "time_limit"

"""Time-integration driver (counterpart of the JAX package's
``utils/integrate.py``, chunked form).

The model advances whole save intervals per ``update_n`` call; the callback
fires when the time lands inside the half-dt window around a save boundary,
and the model's break criterion is checked at every boundary.

Two hooks let a supervising harness wrap the loop without forking it:

* ``dispatch(pde, n)`` replaces the ``pde.update_n(n)`` call;
* ``on_chunk(pde)`` runs after each chunk's callback and break check;
  a truthy return stops the loop with status ``"stopped"``.

With ``overlap`` the break check rides the model's ``exit_future`` and is
read one chunk late, so the next chunk is enqueued before the previous
one's flag is fetched (see :func:`integrate`).

Statuses: ``"time_limit"`` | ``"timestep_limit"`` | ``"break"`` (the break
criterion fired) | ``"stopped"`` (``on_chunk`` asked).
"""

from __future__ import annotations

import math

MAX_TIMESTEP = 10_000_000


def _next_boundary(t: float, dt: float, save_intervall: float) -> float:
    """First absolute save boundary ``k * save_intervall`` strictly after
    ``t`` (half-dt tolerance, so a time that just landed on a boundary
    targets the following one)."""
    return (math.floor((t + dt / 2.0) / save_intervall) + 1) * save_intervall


def integrate(pde, max_time: float, save_intervall: float | None = None, *,
              dispatch=None, on_chunk=None, overlap: bool | None = None) -> str:
    """Advance ``pde`` until ``max_time``, calling ``pde.callback()`` at each
    save boundary; returns the stop status.

    ``overlap`` (None: the model's ``io_overlap``; only for a model with
    ``exit_future``): at each boundary the break check takes a fresh
    ``exit_future``; when it is already resolved (a latch, or a device that
    has caught up) it decides at once, else the previous boundary's future,
    whose device work was enqueued before the chunk just run, decides.  A
    divergence is then seen at most one chunk late (the frozen state stays
    non-finite, so the next boundary still reads it), and the final state
    is judged exactly before a ``"time_limit"`` return."""
    if overlap is None:
        overlap = bool(getattr(pde, "io_overlap", False))
    overlap = overlap and hasattr(pde, "exit_future")
    pending = None  # the previous boundary's unresolved exit future
    dispatched = False

    def break_hit() -> bool:
        nonlocal pending
        fut = pde.exit_future()
        if fut.ready():
            pending = None
            return bool(fut.result())
        hit = bool(pending.result()) if pending is not None else False
        pending = fut
        return hit

    timestep = 0
    while True:
        # dt is read every chunk: a supervising hook may have changed it
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
        if dispatch is not None:
            dispatch(pde, n)
        else:
            pde.update_n(n)
        timestep += n
        dispatched = True
        if boundary is not None and abs(pde.get_time() - boundary) < dt / 2.0:
            pde.callback()
        if timestep >= MAX_TIMESTEP:
            print(f"timestep limit reached: {timestep}")
            return "timestep_limit"
        if break_hit() if overlap else pde.exit():
            print("break criteria triggered")
            return "break"
        if pde.get_time() + dt * 1e-4 >= max_time:
            break  # completed: the time limit beats a late stop request
        if on_chunk is not None and on_chunk(pde):
            return "stopped"
    if overlap and dispatched and bool(pde.exit_future().result()):
        print("break criteria triggered")
        return "break"
    print(f"time limit reached: {pde.get_time()}")
    return "time_limit"

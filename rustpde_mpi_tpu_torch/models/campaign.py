"""The stepping contract Navier2D exposes (counterpart of the part of the
JAX package's ``models/campaign.py`` that the single-device DNS uses):
``time``, ``update``, ``update_n``, ``get_observables`` and ``exit``.

PyTorch runs eagerly, so ``update_n`` is a plain Python loop over the step;
the kernels it launches queue on the current CUDA stream and the host only
waits where it reads a value back (``get_observables``).
"""

from __future__ import annotations

import math


class CampaignModelBase:
    """Subclasses supply ``dt``, ``state``, ``_step(state)`` and
    ``_observables(state)`` (a 1-D tensor whose index 3 is |div|)."""

    def _init_campaign(self) -> None:
        self.time = 0.0
        self._obs_cache = None  # (state, values) of the last read

    def update(self) -> None:
        self.state = self._step(self.state)
        self.time += self.dt

    def update_n(self, n: int) -> None:
        """Advance ``n`` steps."""
        state = self.state
        for _ in range(n):
            state = self._step(state)
        self.state = state
        self.time += n * self.dt

    def get_time(self) -> float:
        return self.time

    def get_dt(self) -> float:
        return self.dt

    def get_observables(self) -> tuple:
        """The model's scalars (``observable_names``) of the current state,
        fetched to the host in one transfer and cached per state."""
        if self._obs_cache is None or self._obs_cache[0] is not self.state:
            vals = self._observables(self.state)
            self._obs_cache = (self.state, tuple(float(v) for v in vals.tolist()))
        return self._obs_cache[1]

    def div_norm(self) -> float:
        """The divergence norm, the observable that turns non-finite first."""
        return self.get_observables()[3]

    def exit(self) -> bool:
        """Break criterion: the state has gone non-finite."""
        return not math.isfinite(self.div_norm())

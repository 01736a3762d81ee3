"""Scenario step modifiers (counterpart of the JAX package's
``workloads/modifiers.py``, less its vmapped geometry sweep).

Config-carried terms built into the ``Navier2D`` step:

* **rotating frame**: the f-plane Coriolis force ``(+f v, -f u)`` added
  explicitly to the momentum equations.  In exactly incompressible 2-D
  flow it is irrotational (its curl is ``-f div(u) = 0``) and absorbed by
  the pressure: velocity and temperature follow the non-rotating run while
  the pressure carries the geostrophic correction.
* **passive scalar**: an advected and diffused scalar on the
  temperature's composite space and BC lift, at its own diffusivity
  (``scalar_kappa``, default the thermal one).  At matched diffusivity a
  scalar released equal to the temperature stays equal to it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ScenarioConfig:
    """The scenario modifiers of a ``Navier2D`` (its ``scenario=``
    argument; a dict with the same keys does too):

    * ``coriolis``: the f-plane rate ``f`` (0 = off), adding ``(+f v, -f
      u)`` to the momentum equations;
    * ``passive_scalar``: add the advected scalar ``scal`` to the state;
    * ``scalar_kappa``: its diffusivity (None: the thermal one, the matched
      configuration whose scalar mirrors the temperature)."""

    coriolis: float = 0.0
    passive_scalar: bool = False
    scalar_kappa: float | None = None

    @property
    def signature(self) -> tuple:
        """The canonical signature (:func:`..models.navier.scenario_signature`)."""
        from ..models.navier import scenario_signature

        return scenario_signature(self)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def penalization_factors(model, mask, value=None, eta: float | None = None):
    """The pointwise implicit-Brinkman factors ``(fac, temp_add)`` of one
    obstacle: :func:`..models.navier.brinkman_factors`, the implementation
    ``Navier2D.set_solid`` uses."""
    from ..models.navier import brinkman_factors

    return brinkman_factors(model, mask, value, eta)

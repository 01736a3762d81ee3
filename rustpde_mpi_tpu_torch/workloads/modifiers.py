"""Scenario step modifiers and the geometry sweep (counterpart of the JAX
package's ``workloads/modifiers.py``).

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

The **geometry sweep** batches solid obstacles: the Brinkman penalization
is a pointwise map after the step (the pressure update never reads the
penalized fields), so a solid step is the plain step followed by the
penalization, and K obstacle geometries run as one ensemble of the plain
template model (:class:`..models.ensemble.NavierEnsemble`), each member
with its own penalization factors, every kernel launch serving all K.
Each member equals a solo ``set_solid`` run of its geometry.
"""

from __future__ import annotations

import dataclasses

import torch


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


def geometry_sweep(model, geometries, steps: int, states=None):
    """Advance K obstacle geometries as one ensemble of the plain template
    ``model`` (no ``set_solid``; one with an obstacle raises), ``steps``
    steps in the ensemble's chunks.  ``geometries``: ``(mask, value)``
    pairs (the ``solid_*`` builders) or ``mask`` arrays; ``states``:
    per-member initial states (default: K copies of ``model.state``).

    Returns ``(stacked_state, observables)``: the final states, each field
    with a leading K dim, and the model's observables, each of shape
    (K,)."""
    from ..models.ensemble import NavierEnsemble

    if getattr(model, "_solid", None) is not None:
        raise ValueError(
            "geometry_sweep needs a plain template model; the sweep itself supplies the "
            "per-member penalization (set_solid(None) first)")
    pairs = []
    for geom in geometries:
        mask, value = geom if isinstance(geom, tuple) else (geom, None)
        pairs.append(penalization_factors(model, mask, value))
    if not pairs:
        raise ValueError("geometry_sweep needs at least one geometry")
    k = len(pairs)
    members = [model.state] * k if states is None else list(states)
    if len(members) != k:
        raise ValueError(f"{len(members)} states for {k} geometries")
    ens = NavierEnsemble(model, members)
    ens._set_solids(torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]))
    ens.update_n(int(steps))
    return ens.state, ens.get_observables()

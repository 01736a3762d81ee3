"""The workloads (counterpart of the JAX package's ``workloads/``, less
the functions that run under its resilient runner):

* ``modifiers``: the scenario axis of the DNS, config-carried step
  modifiers (:class:`.modifiers.ScenarioConfig`), the Brinkman
  penalization factors of a solid obstacle, and the geometry sweep, K
  obstacles as one ensemble;
* ``registry``: one table of campaign-model constructors by kind (``dns``,
  ``lnse``, ``adjoint``);
* ``eigenmodes``: linear stability ensembles, growth rates, the critical
  Rayleigh number;
* ``steady``: K adjoint steady-state finders as one ensemble;
* ``parity``: the per-kind solo-vs-ensemble drift probe.
"""

from .eigenmodes import (AC_RIGID, RAC_RIGID, build_eigenmode_ensemble,  # noqa: F401
                         critical_aspect, critical_rayleigh, growth_rates)
from .modifiers import ScenarioConfig, geometry_sweep, penalization_factors  # noqa: F401
from .parity import solo_ensemble_parity  # noqa: F401
from .registry import (build_model, build_model_for_key, model_kinds,  # noqa: F401
                       register_model_kind, validate_campaign_model)
from .steady import build_steady_ensemble  # noqa: F401

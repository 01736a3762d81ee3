"""The scenario axis of the DNS (counterpart of the part of the JAX
package's ``workloads/`` that a single model uses): config-carried step
modifiers (:class:`.modifiers.ScenarioConfig`), the Brinkman
penalization factors of a solid obstacle, and the geometry sweep, K
obstacles as one ensemble (:func:`.modifiers.geometry_sweep`)."""

from .modifiers import ScenarioConfig, geometry_sweep, penalization_factors  # noqa: F401

"""The scenario axis of the DNS (counterpart of the part of the JAX
package's ``workloads/`` that a single model uses): config-carried step
modifiers (:class:`.modifiers.ScenarioConfig`) and the Brinkman
penalization factors of a solid obstacle."""

from .modifiers import ScenarioConfig, penalization_factors  # noqa: F401

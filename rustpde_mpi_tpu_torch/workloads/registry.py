"""Model-kind registry: one table of campaign-model constructors (counterpart
of the JAX package's ``workloads/registry.py``).

Every model that keeps the campaign contract
(:data:`..models.campaign.CAMPAIGN_MODEL_ATTRS`) registers a constructor
under its ``MODEL_KIND``, and the workloads build models through
:func:`build_model`.  A compat key starts with the kind, so models of
different kinds never share a bucket.  Built-in kinds:

* ``dns``: :class:`..models.navier.Navier2D` (scenario modifiers allowed);
* ``lnse``: :class:`..models.lnse.Navier2DLnse` linearised about the
  analytic conduction (``rbc``) or cos-bottom (``hc``) base state;
* ``adjoint``: :class:`..models.steady_adjoint.Navier2DAdjoint`, whose
  variant slot carries a non-default ``res_tol``.

The port's constructors take keyword arguments beyond the JAX package's
(``device``, ``dtype``, ``method``; the step routes for ``dns`` and
``adjoint``), which go to the model's constructor.
"""

from __future__ import annotations

from ..models.campaign import CAMPAIGN_MODEL_ATTRS

_REGISTRY: dict = {}


def register_model_kind(kind: str, build) -> None:
    """Register ``build(nx, ny, ra, pr, dt, aspect, bc, periodic, *,
    mesh=None, scenario=None, **kw) -> model`` under ``kind``."""
    _REGISTRY[str(kind)] = build


def model_kinds() -> tuple:
    """The registered kinds, sorted."""
    return tuple(sorted(_REGISTRY))


def build_model(kind: str, nx: int, ny: int, ra: float, pr: float, dt: float, aspect: float,
                bc: str, periodic: bool, *, mesh=None, scenario=None, **kw):
    """A campaign model of ``kind`` (an unknown kind raises ``KeyError``
    naming the registered ones)."""
    try:
        build = _REGISTRY[str(kind)]
    except KeyError:
        raise KeyError(f"unknown model kind {kind!r}; registered: {list(model_kinds())}") from None
    return build(nx, ny, ra, pr, dt, aspect, bc, periodic, mesh=mesh, scenario=scenario, **kw)


def build_model_for_key(key: tuple, *, mesh=None, phase: str = "build", **kw):
    """The model one compat-key bucket needs: ``key`` is ``(kind, nx, ny,
    ra, pr, dt, aspect, bc, periodic, scenario_sig)``, or that with a
    serving stamp appended (stripped here).  The built model's
    ``compat_key`` must equal the key; a non-canonical DNS scenario
    signature raises.  The build's wall time is recorded per compat key
    (:func:`..telemetry.compile_log.observe_build`, stamped ``phase``)."""
    import time

    from ..telemetry import compile_log

    t0 = time.perf_counter()
    key = tuple(key)
    if len(key) == 11:
        key = key[:10]
    kind, nx, ny, ra, pr, dt, aspect, bc, periodic, scenario_sig = key
    scenario = dict(scenario_sig) if scenario_sig else None
    if scenario and "passive_scalar" in scenario:
        # the signature packs the kappa into the value slot (0.0: thermal)
        kappa = scenario.pop("passive_scalar")
        scenario["passive_scalar"] = True
        scenario["scalar_kappa"] = kappa or None
    if scenario and kind == "dns":
        from ..models.navier import scenario_signature

        if scenario_signature(scenario) != tuple(scenario_sig):
            raise ValueError(f"non-canonical scenario signature {scenario_sig}")
    model = build_model(kind, nx, ny, ra, pr, dt, aspect, bc, periodic, mesh=mesh,
                        scenario=scenario, **kw)
    if model.compat_key != key:
        raise ValueError(f"registry entry for {kind!r} produced compat_key "
                         f"{model.compat_key} for requested key {key}")
    compile_log.observe_build(key, time.perf_counter() - t0, kind=str(kind), phase=phase)
    return model


def validate_campaign_model(model) -> list:
    """The names of :data:`..models.campaign.CAMPAIGN_MODEL_ATTRS` that
    ``model`` lacks (empty: it keeps the contract)."""
    return [name for name in CAMPAIGN_MODEL_ATTRS if not hasattr(model, name)]


# -- the built-in kinds ----------------------------------------------------------


def _build_dns(nx, ny, ra, pr, dt, aspect, bc, periodic, *, mesh=None, scenario=None, **kw):
    from ..models.navier import Navier2D

    return Navier2D(nx, ny, ra, pr, dt, aspect, bc, periodic=periodic, mesh=mesh,
                    scenario=scenario, **kw)


def _build_lnse(nx, ny, ra, pr, dt, aspect, bc, periodic, *, mesh=None, scenario=None, **kw):
    from ..models.lnse import Navier2DLnse
    from ..models.meanfield import MeanFields

    if scenario:
        raise ValueError("scenario modifiers are a DNS axis (model='dns')")
    # the deterministic analytic base state (no file): the conduction
    # profile for rbc, the cos-bottom parabola for hc, built on the host
    # (the model places it in its own device and layout)
    mean = (MeanFields.new_hc if bc == "hc" else MeanFields.new_rbc)(nx, ny, periodic, device="cpu")
    return Navier2DLnse(nx, ny, ra, pr, dt, aspect, bc, periodic=periodic, mean=mean, mesh=mesh,
                        **kw)


def _build_adjoint(nx, ny, ra, pr, dt, aspect, bc, periodic, *, mesh=None, scenario=None, **kw):
    from ..models.steady_adjoint import RES_TOL, Navier2DAdjoint

    res_tol = RES_TOL
    if scenario:
        extra = dict(scenario)
        # the variant slot carries the convergence tolerance
        res_tol = float(extra.pop("res_tol", res_tol))
        if extra:
            raise ValueError(f"unsupported adjoint variant fields: {sorted(extra)}")
    return Navier2DAdjoint(nx, ny, ra, pr, dt, aspect, bc, periodic=periodic, mesh=mesh,
                           res_tol=res_tol, **kw)


register_model_kind("dns", _build_dns)
register_model_kind("lnse", _build_lnse)
register_model_kind("adjoint", _build_adjoint)

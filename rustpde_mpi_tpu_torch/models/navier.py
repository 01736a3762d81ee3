"""Navier2D — 2-D Boussinesq convection DNS.

Counterpart of the JAX package's ``models/navier.py``, with Rayleigh-Benard
(``bc="rbc"``) or horizontal-convection (``bc="hc"``: a cosine temperature
at the bottom, an insulated top, the temperature's y base
Dirichlet-Neumann) boundary conditions, in the confined cell (Chebyshev x
Chebyshev, ``new_confined``) and the horizontally periodic one (Fourier
r2c x Chebyshev, ``periodic=True``/``new_periodic``, whose spectral state
is complex).  Two routes of each half of the step, chosen by constructor
arguments (the JAX package's ``RUSTPDE_CONV_KERNEL`` /
``RUSTPDE_STEP_KERNEL``, its ``"pallas"`` being ``"fused"`` here):

* ``conv_kernel="fused"``: three fused convection chains a step
  (:mod:`..ops.fused_conv`); ``"dense"``: the derivative syntheses, the
  products and the dealiased forward transform as plain matrix products.
* ``step_kernel="fused"``: seven fused implicit stages a step
  (:mod:`..ops.fused_step`); ``"dense"``: the JAX package's default step
  on the solver objects of :mod:`..solver` (ADI Helmholtz for the
  velocities and the temperature, the tensor Poisson solver for the
  pseudo-pressure), whose banded substitutions run the kernel of
  :mod:`..ops.banded_solve`: seven launches a step in the confined cell,
  four in the periodic one (its Fourier axis solves are diagonals; the
  Poisson solve is one launch for every Fourier mode).  HC's temperature
  solve along y couples rows of both parities, so it runs the kernel's
  general path (one chain a lane).

``method`` picks the transform path of the Chebyshev axes (``"fft"`` or
``"matmul"``, :class:`..bases.Space2`); a Fourier axis always runs on
``torch.fft``.

``scenario=`` (a :class:`..workloads.modifiers.ScenarioConfig`, or a
dict with its keys) adds the JAX package's scenario modifiers to the step
on every route: the f-plane Coriolis cross terms (on the fused route two
more terms of the velocity stages, the ``vely`` stage then summing five
products) and a passive scalar ``scal`` (the temperature's convection,
through the same fused convection instance, and its own implicit stage or
solve, shared with the temperature's solver at matched diffusivity).
``set_solid`` adds a solid obstacle as an implicit pointwise Brinkman
penalization after each step (``forward(backward(.) * fac [+ temp_add])``
on ``velx``, ``vely``, ``temp`` and ``scal``).

``mesh=`` (a :class:`..parallel.mesh.Mesh`) runs the dense route on fields
split over the mesh's ranks, as the JAX package's meshed model does, in
either cell: the state lives in spectral x-pencils (complex ones in the
periodic cell), physical data in y-pencils, every pencil flip runs the
pencil-transpose kernel of :mod:`..ops.ring_transpose`, and every banded
solve one launch for all ranks.  The JAX package builds no fused stages
under a mesh, so the fused kernels are refused there.  A mesh whose ranks
span processes (:func:`..parallel.multihost.global_pencil_mesh`) runs the
same step in every process on its ranks, its flips through the kernel's
remote form and its sums and maxima (the freeze probe, the sentinels,
the observables) over every rank, so all processes take the same path.

The step, the sentinels and the observables also take states whose fields
carry a leading member dim, the K members of an ensemble
(:class:`.ensemble.NavierEnsemble`): every operator, solver and kernel
launch then serves all K members (the JAX package's ``jax.vmap`` of the
step), and the reductions run per member.

Each kernel runs as hand-written CUDA on a CUDA device and as its plain
PyTorch version on the CPU.  ``update_n`` advances chunks of steps with
the reference's divergence freeze and, when ``set_stability`` armed them,
its stability sentinels (:mod:`.campaign`); on the card each step of a
chunk replays the step captured as a CUDA graph.

Numerical scheme (as the JAX package):

* implicit Euler diffusion via ADI Helmholtz solves,
* explicit convection with 2/3-rule dealiasing,
* pressure projection: Poisson solve for a pseudo-pressure, velocity
  correction, pressure update ``pres += -nu*div + pseu/dt``,
* inhomogeneous BCs through constant lift fields.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..bases import (Space2, cheb_dirichlet, cheb_dirichlet_neumann, cheb_neumann, chebyshev,
                     default_method, fourier_r2c, fused_projection_gradient)
from ..field import average_weights, grid_deltas
from ..ops.fused_conv import build_model_convs
from ..ops.fused_step import build_model_step
from ..parallel.decomp import all_gather_max, all_gather_sum
from ..parallel.spaces import PencilSpace2
from ..solver import HholtzAdi, Poisson
from ..utils import checkpoint, navier_io
from . import boundary_conditions as bcs
from . import functions as fns
from .campaign import CampaignModelBase


class NavierState(NamedTuple):
    """Spectral coefficients of the five evolved fields."""

    temp: torch.Tensor
    velx: torch.Tensor
    vely: torch.Tensor
    pres: torch.Tensor
    pseu: torch.Tensor


class NavierScalarState(NamedTuple):
    """:class:`NavierState` plus the passive scalar of a ``passive_scalar``
    scenario: ``scal`` is advected by the flow and diffused at the scalar
    diffusivity, with the temperature's BC lift as its boundary forcing, so
    a scalar released equal to the temperature at matched diffusivity stays
    equal to it."""

    temp: torch.Tensor
    velx: torch.Tensor
    vely: torch.Tensor
    pres: torch.Tensor
    pseu: torch.Tensor
    scal: torch.Tensor


def scenario_signature(scenario) -> tuple:
    """The canonical signature of a scenario (any object carrying
    ``coriolis`` / ``passive_scalar`` / ``scalar_kappa``, or a dict with
    those keys), as the JAX package signs it: an empty or default scenario
    signs as ``()``, equal to no scenario at all.  A non-positive
    ``scalar_kappa`` raises."""
    if scenario is None:
        return ()
    get = (scenario.get if isinstance(scenario, dict)
           else lambda k, d=None: getattr(scenario, k, d))
    items = []
    f = float(get("coriolis", 0.0) or 0.0)
    if f:
        items.append(("coriolis", f))
    if get("passive_scalar", False):
        kappa = get("scalar_kappa", None)
        if kappa is not None and float(kappa) <= 0.0:
            # 0.0 would collide with the thermal-default sentinel below
            raise ValueError(f"scalar_kappa must be positive (got {kappa}); omit it for "
                             "the thermal diffusivity")
        items.append(("passive_scalar", float(kappa) if kappa is not None else 0.0))
    return tuple(items)


def brinkman_factors(model, mask, value=None, eta: float | None = None):
    """The pointwise implicit-Brinkman penalization factors ``(fac,
    temp_add)`` of one obstacle on ``model``'s grid: ``fac = 1 / (1 +
    (dt/eta) mask)``, and ``temp_add`` relaxes the temperature toward
    ``value`` minus the BC lift (the temperature state excludes the lift).
    Built in numpy f64 on the host and placed as physical fields of the
    model's field space (on a mesh y-pencils, whose pad gets 0 in both, so
    the pad's zeros stay zeros)."""
    mask = np.asarray(mask, dtype=np.float64)
    if value is None:
        value = np.zeros_like(mask)
    if eta is None:
        eta = model.dt / 10.0
    a = (model.dt / float(eta)) * mask
    fac = 1.0 / (1.0 + a)
    temp_add = a * (value - model.host_bc["phys"]) * fac
    place = model.field_space.place_physical
    return place(fac), place(temp_add)


class Navier2D(CampaignModelBase):
    """2-D Rayleigh-Benard convection solver, confined or horizontally
    periodic.

    Parameters follow the JAX package (nx, ny, ra, pr, dt, aspect, bc,
    periodic); ``bc`` is ``"rbc"`` or ``"hc"``, any other raises.  ``device`` defaults to ``"cuda"``
    and raises without a card unless ``"cpu"`` is passed; ``dtype`` is
    float64 or float32.  ``conv_kernel`` and ``step_kernel`` are each
    ``"fused"`` (the default) or ``"dense"`` (see the module docstring).
    ``method``: the Chebyshev axes' transform path (default
    :func:`..bases.default_method` of the device).  ``mesh``: split the
    fields over its ranks (dense route only; the device is the mesh's).
    ``scenario``: the step modifiers (see the module docstring)."""

    #: the model kind prefix of :attr:`compat_key`
    MODEL_KIND = "dns"

    @property
    def observable_names(self) -> tuple:
        """The observables' names: a passive-scalar scenario appends
        ``sherwood`` after the conventional four (index 3 stays |div|, the
        NaN detector)."""
        base = ("nu", "nuvol", "re", "div")
        return base + ("sherwood",) if self._scalar_active() else base

    def __init__(self, nx: int, ny: int, ra: float, pr: float, dt: float,
                 aspect: float, bc: str = "rbc", periodic: bool = False, *, device=None,
                 dtype=config.DEFAULT_DTYPE, conv_kernel: str | None = None,
                 step_kernel: str | None = None, mesh=None, method: str | None = None,
                 scenario=None):
        if bc not in bcs.TEMPERATURE_LIFTS:
            raise ValueError(f"boundary condition type {bc!r} not recognized")
        default = "fused" if mesh is None else "dense"
        conv_kernel = default if conv_kernel is None else conv_kernel
        step_kernel = default if step_kernel is None else step_kernel
        for name, value in (("conv_kernel", conv_kernel), ("step_kernel", step_kernel)):
            if value not in ("fused", "dense"):
                raise ValueError(f"{name} must be 'fused' or 'dense', got {value!r}")
            if mesh is not None and value == "fused":
                raise ValueError(f"{name}='fused' has no pencil form: a meshed model runs "
                                 "the dense route")
        if mesh is not None:
            if device is not None and config.resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        #: dims of one state's field: (nx, ny), or (ranks, ...) pencils on a
        #: mesh; a state with more carries a leading member dim
        self.field_ndim = 2 if mesh is None else 3
        self.conv_kernel, self.step_kernel = conv_kernel, step_kernel
        self.device = config.resolve_device(device)
        self.dtype = config.check_dtype(dtype)
        self.nx, self.ny = nx, ny
        self.dt = dt
        self.bc = bc
        self.periodic = bool(periodic)
        self.scale = (float(aspect), 1.0)
        nu = fns.get_nu(ra, pr, self.scale[1] * 2.0)
        ka = fns.get_ka(ra, pr, self.scale[1] * 2.0)
        self.params = {"ra": ra, "pr": pr, "nu": nu, "ka": ka}
        self.diagnostics: dict[str, list[float]] = {}
        #: the callback writes a flow snapshot every save boundary unless
        #: this throttles it (a boundary writes when ``(t + dt/2) %
        #: write_intervall < dt``)
        self.write_intervall: float | None = None
        self._init_campaign()
        self._solid = None  # the penalization factors of set_solid
        self._scenario = scenario

        self.method = default_method(self.device) if method is None else method
        kw = dict(device=self.device, dtype=self.dtype, method=self.method)

        def space(bx, by):
            sp = Space2(bx, by, **kw)
            return sp if mesh is None else PencilSpace2(sp, mesh)

        # the x bases (a Fourier r2c axis for every field of the periodic cell)
        x_base, x_full, x_neumann = ((fourier_r2c,) * 3 if periodic
                                     else (cheb_dirichlet, chebyshev, cheb_neumann))
        self.velx_space = space(x_base(nx), cheb_dirichlet(ny))
        self.vely_space = self.velx_space
        # horizontal convection: Dirichlet at the heated bottom, Neumann at
        # the insulated top
        temp_ybase = cheb_dirichlet(ny) if bc == "rbc" else cheb_dirichlet_neumann(ny)
        self.temp_space = space(x_neumann(nx), temp_ybase)
        self.pres_space = space(x_full(nx), chebyshev(ny))
        self.pseu_space = space(x_neumann(nx), cheb_neumann(ny))
        self.field_space = space(x_full(nx), chebyshev(ny))

        xs, ys = (b.points for b in self.field_space.bases)
        self.x = [xs * self.scale[0], ys * self.scale[1]]
        w0, w1 = average_weights(xs, self.periodic), average_weights(ys)
        # physical fields of the plate (x only) and the volume weights (on a
        # mesh the pad gets weight 0)
        self._w_plate = self.field_space.place_physical(np.repeat(w0[:, None], ny, axis=1))
        self._w_vol = self.field_space.place_physical(w0[:, None] * w1[None, :])
        # per-point inverse grid spacing (physical, scaled) of the CFL
        # sentinel dt*max(|ux|/dx + |uy|/dy), as physical fields (on a mesh
        # the pad gets 0)
        inv_dx = 1.0 / (grid_deltas(xs, self.periodic) * self.scale[0])
        inv_dy = 1.0 / (grid_deltas(ys) * self.scale[1])
        self._inv_dx = self.field_space.place_physical(np.repeat(inv_dx[:, None], ny, axis=1))
        self._inv_dy = self.field_space.place_physical(np.repeat(inv_dy[None, :], nx, axis=0))

        self._build_bc_fields(xs, ys)
        self._convs = build_model_convs(self) if conv_kernel == "fused" else None
        if conv_kernel == "dense":
            self._dealias = self.field_space.place_spectral(self.field_space.dealias_mask())
        self._stages = build_model_step(self) if step_kernel == "fused" else None
        if step_kernel == "dense":
            self._build_helmholtz_solvers()
            sx2, sy2 = self.scale[0] ** 2, self.scale[1] ** 2
            self.solver_pres = Poisson(self.pseu_space, (1.0 / sx2, 1.0 / sy2))
            self._proj_grad = (
                fused_projection_gradient(self.velx_space, self.pseu_space, (1, 0))
                + fused_projection_gradient(self.vely_space, self.pseu_space, (0, 1)))
        self.solver_scal = self._build_scalar_solver()
        self.state = self._state_cls()(*(
            space.ndarray_spectral() for _, space in self._state_fields()
        ))

    @classmethod
    def new_confined(cls, nx, ny, ra, pr, dt, aspect, bc="rbc", **kwargs) -> "Navier2D":
        """Chebyshev x Chebyshev cell with the random initial condition of
        the JAX package's ``new_confined`` (amplitude 0.1, seed 0); keyword
        arguments go to the constructor."""
        model = cls(nx, ny, ra, pr, dt, aspect, bc, **kwargs)
        model.init_random(0.1)
        return model

    @classmethod
    def new_periodic(cls, nx, ny, ra, pr, dt, aspect, bc="rbc", **kwargs) -> "Navier2D":
        """Fourier x Chebyshev (horizontally periodic) cell with the random
        initial condition of the JAX package's ``new_periodic`` (amplitude
        0.1, seed 0); keyword arguments go to the constructor."""
        model = cls(nx, ny, ra, pr, dt, aspect, bc, periodic=True, **kwargs)
        model.init_random(0.1)
        return model

    @classmethod
    def from_config(cls, cfg, mesh=None, **kwargs) -> "Navier2D":
        """A model from a :class:`..config.NavierConfig`, as the JAX
        package's ``from_config``: the random initial condition at
        ``init_random_amp`` (none when it is falsy), ``write_intervall`` and
        the extra ``params``, then the sentinels (``stability``), the
        statistics (``stats``) and the integrity layer (``integrity``) armed; keyword arguments (``device``,
        ``dtype``, the routes) go to the constructor."""
        model = cls(*cfg.ctor_args(), periodic=cfg.periodic, mesh=mesh,
                    scenario=getattr(cfg, "scenario", None), **kwargs)
        if cfg.init_random_amp:
            model.init_random(cfg.init_random_amp)
        model.write_intervall = cfg.write_intervall
        model.params.update(cfg.params)
        if cfg.stability is not None:
            model.set_stability(cfg.stability)
        if cfg.stats is not None:
            model.set_stats(cfg.stats)
        if cfg.integrity is not None:
            model.set_integrity(cfg.integrity)
        return model

    @property
    def compat_key(self) -> tuple:
        """The operator-constant key, as the JAX package's: the model kind,
        grid, physics parameters, dt, geometry, BC family and scenario
        signature.  Models of equal keys step with the same constants, so
        their states can share one ensemble."""
        return (self.MODEL_KIND, int(self.nx), int(self.ny), float(self.params["ra"]),
                float(self.params["pr"]), float(self.dt), float(self.scale[0]), str(self.bc),
                bool(self.periodic), scenario_signature(self._scenario))

    def members_of(self, state) -> int:
        """The leading member dims of ``state`` (0 for one state, 1 for an
        ensemble's stacked members)."""
        return state.temp.ndim - self.field_ndim

    def kernels(self) -> dict:
        """``{kernel name: [wrappers]}`` of the kernels this model's step
        launches, each wrapper once, with its ``launches`` counter (on a
        mesh whose ranks span processes, ``ring_gather`` counts the
        remote kernel's launches under its sums apart from the flips)."""
        out = {}
        if self._convs is not None:
            out["fused_conv"] = list(self._convs.values())
        if self._stages is not None:
            out["fused_stage"] = list(self._stages.values())
        if self.step_kernel == "dense":
            solvers = (self.solver_velx, self.solver_temp, self.solver_pres)
            if self.solver_scal is not None and self.solver_scal is not self.solver_temp:
                solvers += (self.solver_scal,)
            out["banded_solve"] = [k for s in solvers for k in s.kernels()]
        if self.mesh is not None:
            out["ring_transpose"] = [self.mesh.ring]
            if self.mesh.spanning:
                out["ring_gather"] = [self.mesh.ring.gather]
        return out

    def _state_fields(self) -> list:
        """Ordered ``(field, space)`` of the state (the scenario decides
        whether ``scal`` is one)."""
        fields = [
            ("temp", self.temp_space),
            ("velx", self.velx_space),
            ("vely", self.vely_space),
            ("pres", self.pres_space),
            ("pseu", self.pseu_space),
        ]
        if self._scalar_active():
            fields.append(("scal", self.temp_space))
        return fields

    def _state_cls(self):
        return NavierScalarState if self._scalar_active() else NavierState

    @property
    def snapshot_vars(self) -> tuple:
        """``(snapshot variable, state field)`` rows of the JAX package's
        gathered snapshot format, ``scal`` included when the scenario
        carries one."""
        base = (("ux", "velx"), ("uy", "vely"), ("temp", "temp"), ("pres", "pres"))
        return base + (("scal", "scal"),) if self._scalar_active() else base

    # -- scenario modifiers --------------------------------------------------

    def _scn(self, key, default=None):
        """A scenario attribute (of a dataclass or a dict)."""
        scn = self._scenario
        if scn is None:
            return default
        if isinstance(scn, dict):
            return scn.get(key, default)
        return getattr(scn, key, default)

    def _coriolis(self) -> float:
        return float(self._scn("coriolis", 0.0) or 0.0)

    def _scalar_active(self) -> bool:
        return bool(self._scn("passive_scalar", False))

    def _scalar_kappa(self) -> float:
        """The scalar diffusivity (None: the thermal one); a non-positive
        one raises."""
        kappa = self._scn("scalar_kappa", None)
        if kappa is None:
            return float(self.params["ka"])
        kappa = float(kappa)
        if kappa <= 0.0:
            raise ValueError(f"scalar_kappa must be positive, got {kappa}")
        return kappa

    def _build_helmholtz_solvers(self) -> None:
        """The dense route's implicit Helmholtz solvers at this dt, as the
        JAX package builds them; velx and vely share one solver (identical
        operator)."""
        dt, nu, ka = self.dt, self.params["nu"], self.params["ka"]
        sx2, sy2 = self.scale[0] ** 2, self.scale[1] ** 2
        self.solver_velx = HholtzAdi(self.velx_space, (dt * nu / sx2, dt * nu / sy2))
        self.solver_vely = self.solver_velx
        self.solver_temp = HholtzAdi(self.temp_space, (dt * ka / sx2, dt * ka / sy2))

    def _build_scalar_solver(self):
        """The scalar's implicit solver on the dense route (None without a
        scalar or on the fused route): the temperature's own solver at
        matched diffusivity (the same operator, shared factors), as the JAX
        package shares it."""
        if self.step_kernel != "dense" or not self._scalar_active():
            return None
        kc = self._scalar_kappa()
        if kc == float(self.params["ka"]):
            return self.solver_temp
        sx2, sy2 = self.scale[0] ** 2, self.scale[1] ** 2
        return HholtzAdi(self.temp_space, (self.dt * kc / sx2, self.dt * kc / sy2))

    @property
    def scal_space(self):
        """The passive scalar rides the temperature's composite space."""
        return self.temp_space

    @property
    def scenario(self):
        return self._scenario

    def set_scenario(self, scenario) -> None:
        """Install (or clear, ``None``) the scenario modifiers on a live
        model: the scalar's solver or stage and the fused stages are rebuilt,
        the captured chunks dropped, and toggling the passive scalar adds a
        zero ``scal`` to the state or drops it; the other fields are
        kept."""
        self._scenario = scenario
        if self._stages is not None:
            self._stages = build_model_step(self)
        self.solver_scal = self._build_scalar_solver()
        want, have = self._scalar_active(), "scal" in self.state._fields
        if want and not have:
            self.state = NavierScalarState(*self.state, scal=self.temp_space.ndarray_spectral())
        elif have and not want:
            self.state = NavierState(*self.state[:5])
        self._drop_chunks()

    # -- solid obstacles (volume penalization) -------------------------------

    def set_solid(self, mask, value=None, eta: float | None = None) -> None:
        """Add a solid obstacle by Brinkman volume penalization, as the JAX
        package's ``set_solid``: ``mask`` (nx, ny) is 1 inside the solid, 0
        in the fluid (the :mod:`.solid_masks` builders); ``value`` the
        temperature the solid enforces (default 0); ``eta`` the penalty time
        scale (default dt/10).  Each step ends with the implicit pointwise
        relaxation

            u    <- u / (1 + dt/eta * mask)
            temp <- (temp + dt/eta * mask * (value - lift)) / (1 + dt/eta * mask)

        (and the scalar as the temperature), stable for any eta.
        ``mask=None`` removes the obstacle.  The captured chunks, which hold
        the old factors, are dropped."""
        self._drop_chunks()
        if mask is None:
            self._solid = None
            return
        mask = np.asarray(mask, dtype=np.float64)
        value = np.zeros_like(mask) if value is None else value
        eta = self.dt / 10.0 if eta is None else eta
        fac, temp_add = brinkman_factors(self, mask, value, eta)
        self._solid = {"mask": mask, "value": value, "eta": float(eta), "fac": fac,
                       "temp_add": temp_add}

    @property
    def solid(self):
        """``(mask, value)`` of the obstacle, or None; assigning one calls
        :meth:`set_solid`."""
        if self._solid is None:
            return None
        return (self._solid["mask"], self._solid["value"])

    @solid.setter
    def solid(self, mask_value) -> None:
        if mask_value is None:
            self.set_solid(None)
        else:
            self.set_solid(mask_value[0], mask_value[1])

    # -- the dt rung cache (StatsAndRungs.set_dt) -----------------------------

    #: what a dt change swaps out, cached per rung: the fused stages (dt is in
    #: every Helmholtz stage's matrices and the lift constants), the dense
    #: route's Helmholtz solvers, the lift fields (the diffusion source
    #: scales with dt), the obstacle's factors (dt/eta) and the chunk
    #: runners (their graphs replay the old operators); the pressure solver
    #: and the convection chains have no dt
    _DT_ARTIFACTS = ("_stages", "solver_velx", "solver_vely", "solver_temp", "solver_scal",
                     "host_bc", "tempbc_ortho", "_tempbc_dx", "_tempbc_dy", "_tempbc_diff",
                     "_solid") + CampaignModelBase._DT_ARTIFACTS

    def _rebuild_dt_artifacts(self) -> None:
        """A first visit to a dt rung: the lift fields, the fused stages or
        the Helmholtz solvers, the scalar's solver, and the obstacle's
        factors at the kept ``eta`` (the JAX package runs ``set_solid``
        again; here the factors alone, as the chunks of the new rung are
        captured afresh anyway)."""
        xs, ys = (b.points for b in self.field_space.bases)
        self._build_bc_fields(xs, ys)
        if self._stages is not None:
            self._stages = build_model_step(self)
        if self.step_kernel == "dense":
            self._build_helmholtz_solvers()
        self.solver_scal = self._build_scalar_solver()
        if self._solid is not None:
            solid = self._solid
            fac, temp_add = brinkman_factors(self, solid["mask"], solid["value"], solid["eta"])
            self._solid = {**solid, "fac": fac, "temp_add": temp_add}

    def _build_bc_fields(self, xs: np.ndarray, ys: np.ndarray) -> None:
        """Transform the BC lift profile into ortho-space constants and its
        derivatives, in f64 on the host (``host_bc`` keeps those copies for
        the stage builder; complex ortho-space ones in the periodic cell),
        then place them in the model's device and dtype."""
        base_x, base_y = self.field_space.bases
        sp = Space2(base_x, base_y, device="cpu", dtype=torch.float64, method=self.method)
        scale = self.scale
        dt, ka = self.dt, self.params["ka"]
        lift = bcs.TEMPERATURE_LIFTS[self.bc](xs, ys)
        that = sp.forward(torch.as_tensor(lift, dtype=torch.float64))
        host = {
            "ortho": that,
            "dx": sp.backward_ortho(sp.gradient(that, (1, 0), scale)),
            "dy": sp.backward_ortho(sp.gradient(that, (0, 1), scale)),
            "diff": dt * ka * (sp.gradient(that, (2, 0), scale) + sp.gradient(that, (0, 2), scale)),
        }
        self.host_bc = {k: v.numpy() for k, v in host.items()}
        # the lift's physical values as the transforms give them back (the
        # Brinkman factors' temperature target excludes the lift)
        self.host_bc["phys"] = sp.backward_ortho(that).numpy()
        # ortho-space constants placed as spectral fields, the physical ones
        # as physical fields
        place = {"ortho": self.field_space.place_spectral, "diff": self.field_space.place_spectral,
                 "dx": self.field_space.place_physical, "dy": self.field_space.place_physical}
        dev = {k: place[k](v) for k, v in host.items()}
        self.tempbc_ortho = dev["ortho"]
        self._tempbc_dx, self._tempbc_dy = dev["dx"], dev["dy"]
        self._tempbc_diff = dev["diff"]

    # -- initial conditions --------------------------------------------------

    def init_random(self, amp: float, seed: int = 0) -> None:
        """Uniform random disturbance on temp/velx/vely from numpy's
        ``default_rng(seed)``, the same stream as the JAX package."""
        rng = np.random.default_rng(seed)
        for name in ("temp", "velx", "vely"):
            space = getattr(self, f"{name}_space")
            self.set_field(name, fns.random_values(space.shape_physical, amp, rng))

    def set_velocity(self, amp: float, m: float, n: float) -> None:
        """``velx = amp sin(pi m x~) cos(pi n y~)``, ``vely = -amp cos sin``
        on the normalized grid, as the JAX package's."""
        xs, ys = (b.points for b in self.field_space.bases)
        self.set_field("velx", fns.sin_cos_values(xs, ys, amp, m, n))
        self.set_field("vely", fns.cos_sin_values(xs, ys, -amp, m, n))

    def set_temperature(self, amp: float, m: float, n: float) -> None:
        """``temp = -amp cos(pi m x~) sin(pi n y~)``, as the JAX package's."""
        xs, ys = (b.points for b in self.field_space.bases)
        self.set_field("temp", fns.cos_sin_values(xs, ys, -amp, m, n))

    def set_field(self, name: str, values: np.ndarray) -> None:
        """Set one variable from physical values (host -> device forward;
        on a mesh scattered to y-pencils first)."""
        space = getattr(self, f"{name}_space")
        v = space.place_physical(np.asarray(values))
        # contiguous, as the step's outputs are (an FFT along axis 0 keeps
        # its input's strides permuted)
        self.state = self.state._replace(**{name: space.forward(v).contiguous()})

    def get_field(self, name: str) -> np.ndarray:
        """Physical values of one variable (device backward -> host; on a
        mesh gathered from the y-pencils)."""
        space = getattr(self, f"{name}_space")
        return space.gather_physical(space.backward(getattr(self.state, name))).cpu().numpy()

    # -- the time step -------------------------------------------------------

    def _conv(self, ux, uy, space, vhat, with_bc=False):
        """u . grad(v), dealiased, in scratch-ortho space: the fused chain,
        or the same chain as plain matrix products."""
        if self._convs is not None:
            fc = self._convs[id(space)]
            if with_bc:
                return fc.apply(ux, uy, vhat, self._tempbc_dx, self._tempbc_dy)
            return fc.apply(ux, uy, vhat)
        dvdx = space.backward_gradient(vhat, (1, 0), self.scale)
        dvdy = space.backward_gradient(vhat, (0, 1), self.scale)
        total = ux * dvdx + uy * dvdy
        if with_bc:
            total = total + ux * self._tempbc_dx + uy * self._tempbc_dy
        return self.field_space.forward(total) * self._dealias

    def _step(self, state: NavierState, with_sentinels: bool = False, solid=None):
        """One step.  ``with_sentinels``: return ``(state, (cfl, ke,
        div_norm))`` (:meth:`_sentinels`), read from arrays the step builds
        anyway, so the state's arithmetic is the plain step's.  ``solid``:
        the penalization factors ``(fac, temp_add)`` to apply instead of the
        model's own (:meth:`_penalize`).  A member-stacked state steps every
        member, the sentinels then one per member."""
        if self._stages is None:
            return self._step_dense(state, with_sentinels, solid)
        st = self._stages
        sp_u, sp_v, sp_t, sp_q = self.velx_space, self.vely_space, self.temp_space, self.pseu_space
        temp, velx, vely, pres = state.temp, state.velx, state.vely, state.pres
        # convection velocities in physical space (old time level)
        ux = sp_u.backward_fast(velx)
        uy = sp_v.backward_fast(vely)
        # Coriolis: the cross velocity as one more term of each velocity
        # stage, in the JAX package's argument order
        coriolis = self._coriolis()
        cross_x, cross_y = ((vely,), (velx,)) if coriolis else ((), ())
        velx_n = st["velx"].apply(velx, pres, self._conv(ux, uy, sp_u, velx), *cross_x)
        vely_n = st["vely"].apply(vely, pres, temp, self._conv(ux, uy, sp_v, vely), *cross_y)
        div = st["div"].apply(velx_n, vely_n)
        pseu_n = sp_q.pin_zero_mode(st["poisson"].apply(div))
        velx_n = velx_n - st["projx"].apply(pseu_n)
        vely_n = vely_n - st["projy"].apply(pseu_n)
        pres_n = pres - self.params["nu"] * div + sp_q.to_ortho(pseu_n) / self.dt
        temp_n = st["temp"].apply(temp, self._conv(ux, uy, sp_t, temp, with_bc=True))
        fields = [temp_n, velx_n, vely_n, pres_n, pseu_n]
        if self._scalar_active():
            fields.append(st["scal"].apply(
                state.scal, self._conv(ux, uy, sp_t, state.scal, with_bc=True)))
        state_n = self._penalize(type(state)(*fields), solid)
        return (state_n, self._sentinels(ux, uy, div)) if with_sentinels else state_n

    def _step_dense(self, state: NavierState, with_sentinels: bool = False, solid=None):
        """The JAX package's default step: right-hand sides in ortho space,
        then the implicit solves through the solver objects."""
        sp_u, sp_v, sp_t = self.velx_space, self.vely_space, self.temp_space
        sp_p, sp_q = self.pres_space, self.pseu_space
        dt, scale, nu = self.dt, self.scale, self.params["nu"]
        temp, velx, vely, pres = state.temp, state.velx, state.vely, state.pres
        temp_ortho = sp_t.to_ortho(temp)
        # buoyancy (full ortho space, includes the lift field)
        that = temp_ortho + self.tempbc_ortho
        ux = sp_u.backward_fast(velx)
        uy = sp_v.backward_fast(vely)
        # horizontal momentum
        rhs = sp_u.to_ortho(velx)
        rhs = rhs - dt * sp_p.gradient(pres, (1, 0), scale)
        rhs = rhs - dt * self._conv(ux, uy, sp_u, velx)
        coriolis = self._coriolis()
        if coriolis:
            # the f-plane term +f v (velx and vely share one space, so the
            # cross term is an ortho-space add)
            rhs = rhs + dt * coriolis * sp_v.to_ortho(vely)
        velx_n = self.solver_velx.solve(rhs)
        # vertical momentum + buoyancy
        rhs = sp_v.to_ortho(vely)
        rhs = rhs - dt * sp_p.gradient(pres, (0, 1), scale)
        rhs = rhs + dt * that
        rhs = rhs - dt * self._conv(ux, uy, sp_v, vely)
        if coriolis:
            rhs = rhs - dt * coriolis * sp_u.to_ortho(velx)
        vely_n = self.solver_vely.solve(rhs)
        # pressure projection
        div = sp_u.gradient(velx_n, (1, 0), scale) + sp_v.gradient(vely_n, (0, 1), scale)
        pseu_n = sp_q.pin_zero_mode(self.solver_pres.solve(div))
        velx_n = velx_n - self._project(pseu_n, 0) / scale[0]
        vely_n = vely_n - self._project(pseu_n, 1) / scale[1]
        pres_n = pres - nu * div + sp_q.to_ortho(pseu_n) / dt
        # temperature
        rhs = temp_ortho + self._tempbc_diff
        rhs = rhs - dt * self._conv(ux, uy, sp_t, temp, with_bc=True)
        temp_n = self.solver_temp.solve(rhs)
        fields = [temp_n, velx_n, vely_n, pres_n, pseu_n]
        if self._scalar_active():
            # the temperature's advection-diffusion at the scalar
            # diffusivity, with its lift scaled by kc/ka (dt*kc*lap(lift))
            kc_over_ka = self._scalar_kappa() / self.params["ka"]
            rhs = sp_t.to_ortho(state.scal) + kc_over_ka * self._tempbc_diff
            rhs = rhs - dt * self._conv(ux, uy, sp_t, state.scal, with_bc=True)
            fields.append(self.solver_scal.solve(rhs))
        state_n = self._penalize(type(state)(*fields), solid)
        return (state_n, self._sentinels(ux, uy, div)) if with_sentinels else state_n

    def _penalize(self, state, solid=None):
        """The implicit pointwise Brinkman penalization of :meth:`set_solid`
        on a stepped state: ``forward(backward(v) * fac)`` on the
        velocities, ``+ temp_add`` on the temperature and the scalar (the
        pressures are untouched); ``state`` itself without an obstacle.
        ``solid``: ``(fac, temp_add)`` instead of the model's own (an
        ensemble's per-member factors carry a leading member dim)."""
        if solid is None:
            if self._solid is None:
                return state
            solid = (self._solid["fac"], self._solid["temp_add"])
        fac, add = solid
        sp_u, sp_t = self.velx_space, self.temp_space
        out = {name: sp_u.forward(sp_u.backward(getattr(state, name)) * fac).contiguous()
               for name in ("velx", "vely")}
        for name in ("temp", "scal") if "scal" in state._fields else ("temp",):
            out[name] = sp_t.forward(sp_t.backward(getattr(state, name)) * fac + add).contiguous()
        return state._replace(**out)

    def _sentinels(self, ux, uy, div) -> tuple:
        """The stability sentinels of one step, 0-d tensors, as the JAX
        package's ``_make_step(with_sentinels=True)``: the pointwise
        advective CFL ``dt * max(|ux|/dx + |uy|/dy)`` and the volume-averaged
        kinetic energy ``0.5 <ux^2 + uy^2>`` of the consumed state's
        physical convection velocities, and the norm of the uncorrected
        divergence.  On a mesh the sums run across the ranks and the pad
        adds nothing (zero weights and inverse spacings), and so does the
        maximum (over every rank of a mesh whose ranks span processes).
        Member-stacked fields give one of each per member, ``(K,)`` tensors."""
        sp_f = self.field_space
        lead = ux.ndim - self.field_ndim
        speed = torch.abs(ux) * self._inv_dx + torch.abs(uy) * self._inv_dy
        if self.mesh is not None:
            cfl = self.dt * all_gather_max(speed, self.mesh, lead)
        elif lead:
            cfl = self.dt * speed.reshape(*speed.shape[:lead], -1).amax(dim=-1)
        else:
            cfl = self.dt * torch.max(speed)
        ke = 0.5 * sp_f.weighted_sum(ux**2 + uy**2, self._w_vol, lead)
        return cfl, ke, self._norm(div)

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        """The Frobenius norm of a spectral field (of its real and
        imaginary parts in the periodic cell; on a mesh summed across the
        ranks); one per member of a member-stacked field."""
        lead = v.ndim - self.field_ndim
        if v.is_complex():
            v = torch.view_as_real(v)
        return torch.sqrt(self.field_space.weighted_sum(v, v, lead))

    def _project(self, pseu: torch.Tensor, axis: int) -> torch.Tensor:
        """The pressure-projection correction of the velocity along
        ``axis``, not yet divided by the scale: one matrix product per axis
        (on a mesh with the pencil flip between them)."""
        return self.velx_space.apply_operators(pseu, *self._proj_grad[2 * axis: 2 * axis + 2])

    # -- observables ---------------------------------------------------------

    def _div(self, state: NavierState) -> torch.Tensor:
        return self.velx_space.gradient(state.velx, (1, 0), self.scale) + \
            self.vely_space.gradient(state.vely, (0, 1), self.scale)

    def _observables(self, state: NavierState) -> torch.Tensor:
        """(Nu, Nuvol, Re, |div|[, Sherwood]) as one tensor on the model's device.  Every
        sum is the space's ``weighted_sum``: on a mesh per rank, then across
        ranks (:func:`..parallel.decomp.all_gather_sum`), the pad with
        weight 0.  A member-stacked state gives one column per member,
        ``(observables, K)``."""
        sp_f = self.field_space
        scale = self.scale
        nu, ka = self.params["nu"], self.params["ka"]
        lead = self.members_of(state)

        def avg(v):
            return sp_f.weighted_sum(v, self._w_vol, lead)

        def plates(v):  # x-averages at the bottom and top plates, y = 0 and ny - 1
            return tuple(sp_f.weighted_sum(v[..., j], self._w_plate[..., j], lead)
                         * (-2.0 / scale[1]) for j in (0, self.ny - 1))

        that = self.temp_space.to_ortho(state.temp) + self.tempbc_ortho
        dtdy_p = sp_f.backward_gradient(that, (0, 1), None)
        # Nu: plate heat flux <-2/sy * dT/dy>_x averaged over both plates
        bottom, top = plates(dtdy_p)
        nu_plate = 0.5 * (bottom + top)
        # Nuvol: <2 sy (uy T / ka - dT/dy / sy)>_V
        temp_p = sp_f.backward_ortho(that)
        uy = self.vely_space.backward(state.vely)
        nu_vol = avg((dtdy_p / (-scale[1]) + uy * temp_p / ka) * 2.0 * scale[1])
        # Re: <sqrt(ux^2+uy^2) * 2 sy / nu>_V
        ux = self.velx_space.backward(state.velx)
        re = avg(torch.sqrt(ux**2 + uy**2) * 2.0 * scale[1] / nu)
        dnorm = self._norm(self._div(state))
        if not self._scalar_active():
            return torch.stack([nu_plate, nu_vol, re, dnorm])
        # the scalar's finiteness folds into |div|, the NaN detector (a
        # NaN in the scalar alone never reaches the flow)
        if self.mesh is not None:
            scal_sum = all_gather_sum(torch.abs(state.scal), self.mesh, lead)
        else:
            scal_sum = (torch.sum(torch.abs(state.scal)) if not lead else
                        torch.abs(state.scal).reshape(*state.scal.shape[:lead], -1).sum(dim=-1))
        dnorm = dnorm + 0.0 * scal_sum
        # Sherwood: the scalar's plate flux, as Nu is the temperature's
        # (the scalar shares its space and BC lift)
        shat = self.temp_space.to_ortho(state.scal) + self.tempbc_ortho
        bottom, top = plates(sp_f.backward_gradient(shat, (0, 1), None))
        return torch.stack([nu_plate, nu_vol, re, dnorm, 0.5 * (bottom + top)])

    def eval_nu(self) -> float:
        return self.get_observables()[0]

    def eval_nuvol(self) -> float:
        return self.get_observables()[1]

    def eval_re(self) -> float:
        return self.get_observables()[2]

    # -- snapshots -------------------------------------------------------------

    def write(self, filename: str) -> None:
        """Write a flow snapshot in the reference's HDF5 layout (needs
        ``h5py``; :mod:`..utils.checkpoint`)."""
        checkpoint.write_snapshot(self, filename)

    def read(self, filename: str) -> None:
        """Restore from a snapshot: the spectral coefficients, interpolated
        on a resolution change, and ``time`` (needs ``h5py``)."""
        checkpoint.read_snapshot(self, filename)

    def read_unwrap(self, filename: str) -> None:
        """:meth:`read`, printing the error of an unreadable file instead of
        raising it."""
        try:
            self.read(filename)
        except (OSError, KeyError, checkpoint.CheckpointError) as exc:
            print(f"error while reading file {filename}: {exc}")

    def callback(self) -> None:
        """Save-boundary hook of :func:`..utils.integrate.integrate`
        (:func:`..utils.navier_io.callback`): the flow snapshot
        ``data/flow{t:08.2f}.h5`` when ``write_intervall`` lets it, then
        the observables appended to ``diagnostics``, printed and appended
        to ``data/info.txt``."""
        navier_io.callback(self)

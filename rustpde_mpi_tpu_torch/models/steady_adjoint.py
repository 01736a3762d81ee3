"""Navier2DAdjoint: a steady-state finder by adjoint descent.

Counterpart of the JAX package's ``models/steady_adjoint.py``.  Each step

1. takes one forward ``Navier2D`` step at the fixed inner time step
   ``DT_NAVIER = 1e-3`` (on whatever route the embedded model runs: the
   fused kernels, the dense solvers or the mesh),
2. forms the residual ``res_q = (q_new - q_old) / DT_NAVIER`` of each
   evolved variable,
3. smooths it with the norm ``q_adj = -(I - 0.1 D2)^-1 res_q`` (a tensor
   Helmholtz solve, whose banded substitutions run the kernel of
   :mod:`..ops.banded_solve`), and
4. takes one explicit adjoint-descent step of pseudo-time ``dt`` that
   drives the physical fields toward a steady state, with the adjoint
   convection terms, explicit adjoint diffusion and a pressure projection.

The residual norms ride the state (:class:`AdjointState`), so convergence
(their mean below ``res_tol``) is the chunk's continue criterion: a
converged state is committed and the run, or the ensemble member, stops
there inside the chunk (a captured graph on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import config
from ..bases import fused_projection_gradient
from ..solver import Hholtz, Poisson
from ..utils import navier_io
from .campaign import CampaignModelBase
from .navier import Navier2D, NavierState

RES_TOL = 1e-7
WEIGHT_LAPLACIAN = 1e-1
DT_NAVIER = 1e-3


class AdjointState(NamedTuple):
    """The physical fields, the adjoint pressure and the last residual
    norms ``(|u*_x|, |u*_y|, |theta*|)``."""

    temp: torch.Tensor
    velx: torch.Tensor
    vely: torch.Tensor
    pres: torch.Tensor
    pseu: torch.Tensor
    pres_adj: torch.Tensor
    res_norms: torch.Tensor


class Navier2DAdjoint(CampaignModelBase):
    """Steady-state finder in ``Navier2D``'s parameter vocabulary; ``dt`` is
    the descent's pseudo-time step (the embedded model steps at
    ``DT_NAVIER``), ``res_tol`` the convergence tolerance.  ``device``,
    ``dtype``, ``conv_kernel``, ``step_kernel``, ``mesh`` and ``method`` go
    to the embedded model, as ``Navier2D`` takes them."""

    MODEL_KIND = "adjoint"
    observable_names = ("res", "res_u", "res_t", "div")

    def __init__(self, nx: int, ny: int, ra: float, pr: float, dt: float, aspect: float,
                 bc: str, periodic: bool = False, mesh=None, res_tol: float = RES_TOL, *,
                 device=None, dtype=config.DEFAULT_DTYPE, conv_kernel: str | None = None,
                 step_kernel: str | None = None, method: str | None = None):
        # the embedded model is built at DT_NAVIER: its implicit solvers or
        # stages carry that dt
        self.navier = nav = Navier2D(nx, ny, ra, pr, DT_NAVIER, aspect, bc, periodic,
                                     device=device, dtype=dtype, conv_kernel=conv_kernel,
                                     step_kernel=step_kernel, mesh=mesh, method=method)
        self.device, self.dtype, self.mesh = nav.device, nav.dtype, mesh
        self.field_ndim = nav.field_ndim
        self.dt = dt
        self.res_tol = float(res_tol)
        self.params = nav.params
        self.scale = nav.scale
        self.write_intervall: float | None = None
        self.statistics = None
        self._init_campaign()
        sx2, sy2 = self.scale[0] ** 2, self.scale[1] ** 2
        c_norm = (WEIGHT_LAPLACIAN / sx2, WEIGHT_LAPLACIAN / sy2)
        # the smoothing norms (I - 0.1 D2)^-1; velx and vely share a space
        self._norm_vel = Hholtz(nav.velx_space, c_norm)
        self._norm_temp = Hholtz(nav.temp_space, c_norm)
        # the descent's projection: the dense route's own Poisson solver and
        # projection operators, built here on the fused route, which has
        # neither
        if nav.step_kernel == "dense":
            self.solver_pres, self._proj_grad = nav.solver_pres, nav._proj_grad
        else:
            self.solver_pres = Poisson(nav.pseu_space, (1.0 / sx2, 1.0 / sy2))
            self._proj_grad = (
                fused_projection_gradient(nav.velx_space, nav.pseu_space, (1, 0))
                + fused_projection_gradient(nav.vely_space, nav.pseu_space, (0, 1)))
        sp_f = nav.field_space
        self._dealias = (nav._dealias if nav.conv_kernel == "dense"
                         else sp_f.place_spectral(sp_f.dealias_mask()))
        ns = nav.state
        self.state = AdjointState(ns.temp, ns.velx, ns.vely, ns.pres, ns.pseu,
                                  pres_adj=nav.pres_space.ndarray_spectral(),
                                  res_norms=self._inf_norms())

    def _inf_norms(self) -> torch.Tensor:
        """Residual norms of an unknown iterate: +inf (zero would read as
        converged)."""
        return torch.full((3,), math.inf, dtype=self.dtype, device=self.device)

    @classmethod
    def new_confined(cls, nx, ny, ra, pr, dt, aspect, bc, mesh=None, **kw) -> "Navier2DAdjoint":
        return cls(nx, ny, ra, pr, dt, aspect, bc, periodic=False, mesh=mesh, **kw)

    @classmethod
    def new_periodic(cls, nx, ny, ra, pr, dt, aspect, bc, mesh=None, **kw) -> "Navier2DAdjoint":
        return cls(nx, ny, ra, pr, dt, aspect, bc, periodic=True, mesh=mesh, **kw)

    @classmethod
    def from_config(cls, cfg, mesh=None, **kwargs) -> "Navier2DAdjoint":
        """A finder from a :class:`..config.NavierConfig`, as the JAX
        package's: the random initial condition at ``init_random_amp``,
        ``write_intervall`` and the extra ``params``; keyword arguments go
        to the constructor."""
        model = cls(*cfg.ctor_args(), periodic=cfg.periodic, mesh=mesh, **kwargs)
        if cfg.init_random_amp:
            model.init_random(cfg.init_random_amp)
        model.write_intervall = cfg.write_intervall
        model.navier.params.update(cfg.params)
        return model

    # -- the embedded model's vocabulary --------------------------------------------

    @property
    def nx(self) -> int:
        return self.navier.nx

    @property
    def ny(self) -> int:
        return self.navier.ny

    @property
    def temp_space(self):
        return self.navier.temp_space

    @property
    def velx_space(self):
        return self.navier.velx_space

    @property
    def vely_space(self):
        return self.navier.vely_space

    @property
    def pres_space(self):
        return self.navier.pres_space

    @property
    def pseu_space(self):
        return self.navier.pseu_space

    @property
    def field_space(self):
        return self.navier.field_space

    @property
    def x(self):
        return self.navier.x

    @property
    def compat_key(self) -> tuple:
        """The operator-constant key, as the JAX package's: ``dt`` is the
        descent's, and a tolerance other than ``RES_TOL`` takes the variant
        slot (it is compiled into the chunk's continue criterion)."""
        variant = () if self.res_tol == RES_TOL else (("res_tol", float(self.res_tol)),)
        return (self.MODEL_KIND, int(self.nx), int(self.ny), float(self.params["ra"]),
                float(self.params["pr"]), float(self.dt), float(self.scale[0]),
                str(self.navier.bc), bool(self.navier.periodic), variant)

    def members_of(self, state) -> int:
        return self.navier.members_of(state)

    def kernels(self) -> dict:
        """The embedded model's kernels, with the smoothing norms' and the
        projection's banded solves under ``banded_solve``."""
        out = dict(self.navier.kernels())
        banded = list(out.get("banded_solve", []))
        for solver in (self._norm_vel, self._norm_temp, self.solver_pres):
            banded += [k for k in solver.kernels() if all(k is not b for b in banded)]
        out["banded_solve"] = banded
        return out

    def _state_fields(self) -> list:
        return self.navier._state_fields() + [("pres_adj", self.navier.pres_space)]

    def restart_fill(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """A leaf a gathered snapshot does not carry: the residual norms
        restart at +inf, everything else at zero."""
        if name == "res_norms":
            return torch.full_like(like, math.inf)
        return torch.zeros_like(like)

    # -- the chunk's criteria --------------------------------------------------------

    def _total(self, x, lead):
        return torch.sum(x) if not lead else x.reshape(*x.shape[:lead], -1).sum(dim=-1)

    def _scan_ok(self, state, lead: int = 0) -> torch.Tensor:
        """Continue while the temperature is finite and the mean residual
        norm is at least ``res_tol``: a converged state stops the chunk."""
        finite = torch.isfinite(self._total(state.temp, lead))
        return finite & (state.res_norms.mean(dim=-1) >= self.res_tol)

    def _scan_done_ok(self, state, lead: int = 0) -> torch.Tensor:
        """A state that stopped by convergence: its mean residual finite and
        below ``res_tol``."""
        res = state.res_norms.mean(dim=-1)
        return torch.isfinite(res) & (res < self.res_tol)

    def _scan_commit_ok(self, state, lead: int = 0) -> torch.Tensor:
        """Commit every finite state: the converged one is the answer."""
        return torch.isfinite(self._total(state.temp, lead))

    # -- the iteration ------------------------------------------------------------------

    def _step(self, state, with_sentinels: bool = False, solid=None):
        """One adjoint-descent iteration.  ``with_sentinels``: also ``(cfl,
        ke, |div|)`` of the embedded forward step (its CFL at
        ``DT_NAVIER``, the flow's kinetic energy) and the uncorrected
        divergence of the descent."""
        if solid is not None:
            raise ValueError("the steady-state finder takes no obstacle")
        nav = self.navier
        sp_t, sp_u, sp_v = nav.temp_space, nav.velx_space, nav.vely_space
        sp_p, sp_q, sp_f = nav.pres_space, nav.pseu_space, nav.field_space
        dt, scale = self.dt, self.scale
        nu, ka = self.params["nu"], self.params["ka"]

        def gphys(space, vhat, deriv):
            return sp_f.backward_ortho(space.gradient(vhat, deriv, scale))

        def lap(space, vhat):
            return space.gradient(vhat, (2, 0), scale) + space.gradient(vhat, (0, 2), scale)

        def conv(total):
            return sp_f.forward(total) * self._dealias

        # the forward step at DT_NAVIER, the residuals and their smoothing
        ns = nav._step(NavierState(*state[:5]))
        res_u = (sp_u.to_ortho(ns.velx) - sp_u.to_ortho(state.velx)) / DT_NAVIER
        res_v = (sp_v.to_ortho(ns.vely) - sp_v.to_ortho(state.vely)) / DT_NAVIER
        res_t = (sp_t.to_ortho(ns.temp) - sp_t.to_ortho(state.temp)) / DT_NAVIER
        velx_adj = -self._norm_vel.solve(res_u)
        vely_adj = -self._norm_vel.solve(res_v)
        temp_adj = -self._norm_temp.solve(res_t)
        res_norms = torch.stack([nav._norm(velx_adj), nav._norm(vely_adj), nav._norm(temp_adj)],
                                dim=-1)

        # the descent step
        ux = sp_u.backward(ns.velx)
        uy = sp_v.backward(ns.vely)
        ta = sp_t.backward(temp_adj)
        that_full = sp_t.to_ortho(ns.temp) + nav.tempbc_ortho
        conv_x = conv(ux * gphys(sp_u, velx_adj, (1, 0)) + uy * gphys(sp_u, velx_adj, (0, 1))
                      + ux * gphys(sp_u, velx_adj, (1, 0)) + uy * gphys(sp_v, vely_adj, (1, 0))
                      - ta * gphys(sp_f, that_full, (1, 0)))
        conv_y = conv(ux * gphys(sp_v, vely_adj, (1, 0)) + uy * gphys(sp_v, vely_adj, (0, 1))
                      + ux * gphys(sp_u, velx_adj, (0, 1)) + uy * gphys(sp_v, vely_adj, (0, 1))
                      - ta * gphys(sp_f, that_full, (0, 1)))
        conv_t = conv(ux * gphys(sp_t, temp_adj, (1, 0)) + uy * gphys(sp_t, temp_adj, (0, 1)))

        rhs = sp_u.to_ortho(ns.velx)
        rhs = rhs - dt * sp_p.gradient(state.pres_adj, (1, 0), scale)
        rhs = rhs + dt * conv_x
        rhs = rhs + dt * nu * lap(sp_u, velx_adj)
        velx_n = sp_u.from_ortho(rhs)

        rhs = sp_v.to_ortho(ns.vely)
        rhs = rhs - dt * sp_p.gradient(state.pres_adj, (0, 1), scale)
        rhs = rhs + dt * conv_y
        rhs = rhs + dt * nu * lap(sp_v, vely_adj)
        vely_n = sp_v.from_ortho(rhs)

        div = sp_u.gradient(velx_n, (1, 0), scale) + sp_v.gradient(vely_n, (0, 1), scale)
        pseu_n = sp_q.pin_zero_mode(self.solver_pres.solve(div))
        pg = self._proj_grad
        velx_n = velx_n - sp_u.apply_operators(pseu_n, *pg[:2]) / scale[0]
        vely_n = vely_n - sp_v.apply_operators(pseu_n, *pg[2:]) / scale[1]
        pres_adj_n = state.pres_adj + sp_q.to_ortho(pseu_n) / dt

        rhs = sp_t.to_ortho(ns.temp)
        rhs = rhs + dt * conv_t
        rhs = rhs + dt * sp_v.to_ortho(vely_adj)  # the adjoint buoyancy
        rhs = rhs + dt * ka * lap(sp_t, temp_adj)
        temp_n = sp_t.from_ortho(rhs)

        state_n = AdjointState(temp_n, velx_n, vely_n, ns.pres, pseu_n, pres_adj_n, res_norms)
        if not with_sentinels:
            return state_n
        lead = ux.ndim - self.field_ndim
        speed = torch.abs(ux) * nav._inv_dx + torch.abs(uy) * nav._inv_dy
        cfl = DT_NAVIER * (speed.reshape(*speed.shape[:lead], -1).amax(dim=-1) if lead
                           else torch.max(speed))
        ke = 0.5 * sp_f.weighted_sum(ux**2 + uy**2, nav._w_vol, lead)
        return state_n, (cfl, ke, nav._norm(div))

    def _observables(self, state) -> torch.Tensor:
        """``(res, res_u, res_t, |div|)``: the mean residual norm (the
        convergence measure), its velocity and temperature parts, and the
        velocity divergence's norm; one column per member."""
        res = state.res_norms
        return torch.stack([res.mean(dim=-1), res[..., 0], res[..., 2],
                            self.navier._norm(self.navier._div(state))])

    # -- field access -------------------------------------------------------------------

    def _sync_navier(self) -> None:
        """Mirror the physical fields into the embedded model (its
        observables and IO read its state)."""
        self.navier.state = NavierState(*self.state[:5])
        self.navier.time = self.time
        self.navier._obs_cache = None

    def _pull_navier(self) -> None:
        """Adopt the embedded model's state (after ``set_field`` or a read);
        the residual norms restart at +inf."""
        ns = self.navier.state
        self.state = self.state._replace(temp=ns.temp, velx=ns.velx, vely=ns.vely, pres=ns.pres,
                                         pseu=ns.pseu, res_norms=self._inf_norms())
        self._obs_cache = None

    def set_velocity(self, amp, m, n) -> None:
        self.navier.set_velocity(amp, m, n)
        self._pull_navier()

    def set_temperature(self, amp, m, n) -> None:
        self.navier.set_temperature(amp, m, n)
        self._pull_navier()

    def init_random(self, amp, seed: int = 0) -> None:
        self.navier.init_random(amp, seed)
        self._pull_navier()

    def get_field(self, name: str):
        self._sync_navier()
        return self.navier.get_field(name)

    def read(self, filename: str) -> None:
        """Restore the physical fields from a gathered snapshot (the
        adjoint pressure kept, the residual norms at +inf)."""
        from ..utils import checkpoint

        if checkpoint.is_sharded_checkpoint(filename):
            # a manifest restores THIS model's leaves (state/...), not the
            # embedded DNS's
            checkpoint.read_sharded_snapshot(self, filename)
            return
        self.navier.read(filename)
        self._pull_navier()
        self.time = self.navier.time

    def write(self, filename: str) -> None:
        """The embedded model's gathered snapshot of the current iterate."""
        self._sync_navier()
        self.navier.write(filename)

    # -- readouts -------------------------------------------------------------------------

    def norm_residual(self) -> tuple[float, float, float]:
        """The smoothed-residual norms ``(|u*_x|, |u*_y|, |theta*|)``."""
        return tuple(float(v) for v in self.state.res_norms.tolist())

    def residual(self) -> float:
        """The mean residual norm, the convergence measure."""
        return float(self.state.res_norms.mean())

    def eval_nu(self):
        """The Nusselt number of the current iterate (through the embedded
        model)."""
        self._sync_navier()
        return self.navier.get_observables()[0]

    def eval_nuvol(self):
        self._sync_navier()
        return self.navier.get_observables()[1]

    def eval_re(self):
        self._sync_navier()
        return self.navier.get_observables()[2]

    def callback(self) -> None:
        """The save-boundary hook: the embedded model's callback with the
        finder's snapshot and info names and its residual on the line."""
        self._sync_navier()
        self.navier.write_intervall = self.write_intervall
        self.navier.statistics = self.statistics
        navier_io.callback(self.navier, flowname=f"data/adjoint{self.time:08.2f}.h5",
                           io_name="data/info_adjoint.txt", extra=f"res = {self.residual():5.3e}")

    def exit(self) -> bool:
        """A NaN divergence or a latched sentinel catch, or convergence (a
        success)."""
        if super().exit():
            return True
        if self.residual() < self.res_tol:
            print("Steady state converged!")
            return True
        return False

"""Navier2DLnse and Navier2DNonLin: the linearised and the perturbation-form
Navier-Stokes equations about a base state, with their gradients.

Counterpart of the JAX package's ``models/lnse.py``:

* :class:`Navier2DLnse`: the equations linearised about a
  :class:`.meanfield.MeanFields` base state, convection ``u . grad(U) + U .
  grad(u)``, with the implicit diffusion and pressure projection of the
  dense ``Navier2D`` step (the embedded model's solvers, whose banded
  substitutions run the kernel of :mod:`..ops.banded_solve`).
* :class:`Navier2DNonLin`: the full equations stated as a perturbation
  about the base state (adds ``u . grad(u)`` and the mean-balance terms);
  its hand adjoint consumes the recorded forward trajectory.
* ``grad_adjoint``: the reference's discrete hand adjoint (forward loop,
  energy functional, backward adjoint loop, gradient with respect to the
  initial condition); ``grad_autodiff``: the exact gradient of the
  discrete objective by ``torch.autograd`` through the eager forward loop,
  each step under ``torch.utils.checkpoint``; ``grad_fd``: finite
  differences, the perturbations a member-stacked batch through the same
  step.

The embedded ``Navier2D`` runs the dense route (``step_kernel="dense"``,
``conv_kernel="dense"``), or the meshed one with ``mesh=``: the JAX
package has no fused linearised step.  The step takes states with a
leading member dim, as ``Navier2D._step`` does, so the models run as
:class:`.ensemble.NavierEnsemble` templates and ``grad_fd`` batches its
perturbations.  Gradients flow through the banded solves by
:class:`..ops.banded.BandedSolveFn`, whose backward is the same kernel on
the transposed factors; the pencil flips have no backward yet, so
``grad_autodiff`` on a mesh raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import config
from ..utils import checkpoint as ckpt
from ..utils import navier_io
from .campaign import CampaignModelBase
from .meanfield import MeanFields
from .navier import Navier2D, NavierState

#: Solve the maximization problem instead of the minimization one
MAXIMIZE = False


def l2_norm(a1, a2, b1, b2, c1, c2, beta1: float, beta2: float):
    """``0.5 * sum(beta1 (a1 a2 + b1 b2) + beta2 c1 c2)`` over the grid
    points (numpy arrays or tensors)."""
    return 0.5 * (beta1 * (a1 * a2 + b1 * b2) + beta2 * (c1 * c2)).sum()


class Navier2DLnse(CampaignModelBase):
    """Linearised Navier-Stokes about a mean field, in ``Navier2D``'s
    parameter vocabulary plus ``mean`` (default: ``mean.h5`` in the working
    directory, else the analytic profile of ``bc``).  ``device``, ``dtype``
    and ``method`` go to the embedded model; ``mesh`` puts it on the
    meshed route.

    A campaign model: ``update_n`` chunks (graph-captured on the card),
    sentinels, ``set_dt`` and the ensemble.  Its observables are the
    perturbation energies ``(energy, ke, te, div)``, whose trajectory the
    eigenmode workload fits growth rates from."""

    MODEL_KIND = "lnse"
    observable_names = ("energy", "ke", "te", "div")

    #: include the perturbation self-convection and the mean-balance terms
    NONLINEAR = False

    def __init__(self, nx: int, ny: int, ra: float, pr: float, dt: float, aspect: float,
                 bc: str, periodic: bool = False, mean: MeanFields | None = None, mesh=None, *,
                 device=None, dtype=config.DEFAULT_DTYPE, method: str | None = None):
        self.navier = nav = Navier2D(nx, ny, ra, pr, dt, aspect, bc, periodic, device=device,
                                     dtype=dtype, conv_kernel="dense", step_kernel="dense",
                                     mesh=mesh, method=method)
        self.device, self.dtype, self.mesh = nav.device, nav.dtype, mesh
        self.field_ndim = nav.field_ndim
        if mean is None:
            mean = MeanFields.read_from(nx, ny, "mean.h5", bc=bc, periodic=periodic,
                                        device=nav.device, dtype=nav.dtype, method=nav.method)
        if mean.space.shape_physical != nav.field_space.shape_physical:
            raise ValueError(f"mean field grid {mean.space.shape_physical} != model grid "
                             f"{nav.field_space.shape_physical}")
        self.mean = mean
        self.dt = dt
        self.params = nav.params
        self.scale = nav.scale
        self.write_intervall: float | None = None
        self.statistics = None
        self._init_campaign()
        self._build_mean_constants()
        self.state = NavierState(*nav.state)

    @classmethod
    def new_confined(cls, nx, ny, ra, pr, dt, aspect, bc, mean=None, mesh=None, **kw):
        return cls(nx, ny, ra, pr, dt, aspect, bc, periodic=False, mean=mean, mesh=mesh, **kw)

    @classmethod
    def new_periodic(cls, nx, ny, ra, pr, dt, aspect, bc, mean=None, mesh=None, **kw):
        return cls(nx, ny, ra, pr, dt, aspect, bc, periodic=True, mean=mean, mesh=mesh, **kw)

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
        """The operator-constant key, as the JAX package's: the kind, grid,
        physics, dt, geometry, BC family and an empty scenario slot."""
        return (self.MODEL_KIND, int(self.nx), int(self.ny), float(self.params["ra"]),
                float(self.params["pr"]), float(self.dt), float(self.scale[0]),
                str(self.navier.bc), bool(self.navier.periodic), ())

    def members_of(self, state) -> int:
        return self.navier.members_of(state)

    def kernels(self) -> dict:
        """The embedded model's kernels (the banded solve; the pencil flip on
        a mesh)."""
        return self.navier.kernels()

    def _state_fields(self) -> list:
        return self.navier._state_fields()

    # -- the base state's device constants -------------------------------------------

    def _gphys(self, space, vhat, deriv):
        """Physical values of a derivative, as the JAX package forms them:
        the field space's synthesis of ``space``'s ortho-space gradient."""
        return self.field_space.backward_ortho(space.gradient(vhat, deriv, self.scale))

    def _conv(self, total):
        """The dealiased forward transform of a physical product."""
        return self.field_space.forward(total) * self.navier._dealias

    def _lap(self, space, vhat):
        return space.gradient(vhat, (2, 0), self.scale) + space.gradient(vhat, (0, 2), self.scale)

    def _build_mean_constants(self) -> None:
        """The base state placed in the model's layout (``_mean``, ortho
        space), its physical values and gradients (``_mc``), and, for the
        perturbation form, the mean-balance terms of every step."""
        sp_f = self.field_space
        mean = {k: sp_f.place_spectral(v) for k, v in self.mean.host_coefficients().items()}
        self._mean = mean
        self._mc = {"U": sp_f.backward_ortho(mean["velx"]),
                    "V": sp_f.backward_ortho(mean["vely"]),
                    "T": sp_f.backward_ortho(mean["temp"])}
        for name, attr in (("U", "velx"), ("V", "vely"), ("T", "temp")):
            self._mc[f"d{name}dx"] = self._gphys(sp_f, mean[attr], (1, 0))
            self._mc[f"d{name}dy"] = self._gphys(sp_f, mean[attr], (0, 1))
        # plain grid-point sums (the energies) as weighted sums, 0 on a pad
        self._ones = sp_f.place_physical(np.ones(sp_f.shape_physical))
        if self.NONLINEAR:
            mc = self._mc
            self._conv_mm = [self._conv(mc["U"] * mc[f"d{v}dx"] + mc["V"] * mc[f"d{v}dy"])
                             for v in ("U", "V", "T")]
            self._lap_m = [self._lap(sp_f, mean[a]) for a in ("velx", "vely", "temp")]

    # -- the direct step ------------------------------------------------------------

    def _step(self, state, with_sentinels: bool = False, solid=None):
        """The linearised (perturbation-form) step.  ``with_sentinels``:
        also ``(cfl, ke, |div|)``, the CFL of the total velocity (the mean
        advects the perturbation), the perturbation's kinetic energy and the
        uncorrected divergence.  A member-stacked state steps every
        member."""
        if solid is not None:
            raise ValueError("the linearised models take no obstacle")
        nav, mc, nl = self.navier, self._mc, self.NONLINEAR
        sp_t, sp_u, sp_v = nav.temp_space, nav.velx_space, nav.vely_space
        sp_p, sp_q = nav.pres_space, nav.pseu_space
        dt, scale = self.dt, self.scale
        nu, ka = self.params["nu"], self.params["ka"]
        temp, velx, vely, pres = state.temp, state.velx, state.vely, state.pres
        that = sp_t.to_ortho(temp)
        if nl:
            that = that + self._mean["temp"]  # buoyancy of the base state too
        ux = sp_u.backward(velx)
        uy = sp_v.backward(vely)
        du_dx, du_dy = self._gphys(sp_u, velx, (1, 0)), self._gphys(sp_u, velx, (0, 1))
        dv_dx, dv_dy = self._gphys(sp_v, vely, (1, 0)), self._gphys(sp_v, vely, (0, 1))
        dt_dx, dt_dy = self._gphys(sp_t, temp, (1, 0)), self._gphys(sp_t, temp, (0, 1))
        cx = ux * mc["dUdx"] + uy * mc["dUdy"] + mc["U"] * du_dx + mc["V"] * du_dy
        cy = ux * mc["dVdx"] + uy * mc["dVdy"] + mc["U"] * dv_dx + mc["V"] * dv_dy
        ct = ux * mc["dTdx"] + uy * mc["dTdy"] + mc["U"] * dt_dx + mc["V"] * dt_dy
        if nl:
            cx = cx + ux * du_dx + uy * du_dy
            cy = cy + ux * dv_dx + uy * dv_dy
            ct = ct + ux * dt_dx + uy * dt_dy
        conv_x, conv_y, conv_t = self._conv(cx), self._conv(cy), self._conv(ct)
        if nl:
            conv_x = conv_x + self._conv_mm[0]
            conv_y = conv_y + self._conv_mm[1]
            conv_t = conv_t + self._conv_mm[2]

        rhs = sp_u.to_ortho(velx)
        rhs = rhs - dt * sp_p.gradient(pres, (1, 0), scale)
        rhs = rhs - dt * conv_x
        if nl:
            rhs = rhs + dt * nu * self._lap_m[0]
        velx_n = nav.solver_velx.solve(rhs)

        rhs = sp_v.to_ortho(vely)
        rhs = rhs - dt * sp_p.gradient(pres, (0, 1), scale)
        rhs = rhs + dt * that
        rhs = rhs - dt * conv_y
        if nl:
            rhs = rhs + dt * nu * self._lap_m[1]
        vely_n = nav.solver_vely.solve(rhs)

        div = sp_u.gradient(velx_n, (1, 0), scale) + sp_v.gradient(vely_n, (0, 1), scale)
        pseu_n = sp_q.pin_zero_mode(nav.solver_pres.solve(div))
        velx_n = velx_n - nav._project(pseu_n, 0) / scale[0]
        vely_n = vely_n - nav._project(pseu_n, 1) / scale[1]
        pres_n = pres - nu * div + sp_q.to_ortho(pseu_n) / dt

        rhs = sp_t.to_ortho(temp)
        rhs = rhs - dt * conv_t
        if nl:
            rhs = rhs + dt * ka * self._lap_m[2]
        temp_n = nav.solver_temp.solve(rhs)

        state_n = NavierState(temp_n, velx_n, vely_n, pres_n, pseu_n)
        if not with_sentinels:
            return state_n
        lead = ux.ndim - self.field_ndim
        speed = torch.abs(mc["U"] + ux) * nav._inv_dx + torch.abs(mc["V"] + uy) * nav._inv_dy
        cfl = dt * (speed.reshape(*speed.shape[:lead], -1).amax(dim=-1) if lead
                    else torch.max(speed))
        ke = 0.5 * self.field_space.weighted_sum(ux**2 + uy**2, nav._w_vol, lead)
        return state_n, (cfl, ke, nav._norm(div))

    def _observables(self, state) -> torch.Tensor:
        """``(energy, ke, te, |div|)``: the plain grid-point sums
        :meth:`energy` uses (``energy == energy(0.5, 0.5)``); one column per
        member of a member-stacked state."""
        nav = self.navier
        lead = self.members_of(state)
        u, v, t = self._phys(state)
        ke = 0.5 * self.field_space.weighted_sum(u * u + v * v, self._ones, lead)
        te = 0.5 * self.field_space.weighted_sum(t * t, self._ones, lead)
        return torch.stack([0.5 * (ke + te), ke, te, nav._norm(nav._div(state))])

    # -- the adjoint step -------------------------------------------------------------

    def _adjoint_step(self, state, history=None):
        """One backward (adjoint) step; ``history`` ``(uh, vh, th)``, the
        ortho-space forward state of this step, for the perturbation
        form."""
        nav, mc = self.navier, self._mc
        sp_t, sp_u, sp_v = nav.temp_space, nav.velx_space, nav.vely_space
        sp_p, sp_q, sp_f = nav.pres_space, nav.pseu_space, nav.field_space
        dt, scale, nu = self.dt, self.scale, self.params["nu"]
        temp, velx, vely, pres = state.temp, state.velx, state.vely, state.pres
        uyhat = sp_v.to_ortho(vely)  # the adjoint buoyancy source (pre-update)
        us, vs, ts = sp_u.backward(velx), sp_v.backward(vely), sp_t.backward(temp)
        U, V = mc["U"], mc["V"]
        cx = (U * self._gphys(sp_u, velx, (1, 0)) + V * self._gphys(sp_u, velx, (0, 1))
              - us * mc["dUdx"] - vs * mc["dVdx"] - ts * mc["dTdx"])
        cy = (U * self._gphys(sp_v, vely, (1, 0)) + V * self._gphys(sp_v, vely, (0, 1))
              - us * mc["dUdy"] - vs * mc["dVdy"] - ts * mc["dTdy"])
        ct = U * self._gphys(sp_t, temp, (1, 0)) + V * self._gphys(sp_t, temp, (0, 1))
        if history is not None:
            uh, vh, th = history
            Uh, Vh = sp_f.backward_ortho(uh), sp_f.backward_ortho(vh)
            cx = cx + (Uh * self._gphys(sp_u, velx, (1, 0)) + Vh * self._gphys(sp_u, velx, (0, 1))
                       - us * self._gphys(sp_f, uh, (1, 0)) - vs * self._gphys(sp_f, vh, (1, 0))
                       - ts * self._gphys(sp_f, th, (1, 0)))
            cy = cy + (Uh * self._gphys(sp_v, vely, (1, 0)) + Vh * self._gphys(sp_v, vely, (0, 1))
                       - us * self._gphys(sp_f, uh, (0, 1)) - vs * self._gphys(sp_f, vh, (0, 1))
                       - ts * self._gphys(sp_f, th, (0, 1)))
            ct = ct + Uh * self._gphys(sp_t, temp, (1, 0)) + Vh * self._gphys(sp_t, temp, (0, 1))
        conv_x, conv_y, conv_t = self._conv(cx), self._conv(cy), self._conv(ct)

        rhs = sp_u.to_ortho(velx)
        rhs = rhs - dt * sp_p.gradient(pres, (1, 0), scale)
        rhs = rhs + dt * conv_x
        velx_n = nav.solver_velx.solve(rhs)

        rhs = sp_v.to_ortho(vely)
        rhs = rhs - dt * sp_p.gradient(pres, (0, 1), scale)
        rhs = rhs + dt * conv_y
        vely_n = nav.solver_vely.solve(rhs)

        div = sp_u.gradient(velx_n, (1, 0), scale) + sp_v.gradient(vely_n, (0, 1), scale)
        pseu_n = sp_q.pin_zero_mode(nav.solver_pres.solve(div))
        velx_n = velx_n - nav._project(pseu_n, 0) / scale[0]
        vely_n = vely_n - nav._project(pseu_n, 1) / scale[1]
        pres_n = pres - nu * div + sp_q.to_ortho(pseu_n) / dt

        rhs = sp_t.to_ortho(temp)
        rhs = rhs + dt * conv_t
        rhs = rhs + dt * uyhat
        temp_n = nav.solver_temp.solve(rhs)
        return NavierState(temp_n, velx_n, vely_n, pres_n, pseu_n)

    # -- dt ----------------------------------------------------------------------------

    def set_dt(self, dt: float) -> None:
        """Change the step size: this model's runners per rung, and the
        embedded model's ``set_dt`` (whose Helmholtz solvers the step
        shares, cached per rung there)."""
        super().set_dt(dt)
        self.navier.set_dt(self.dt)

    # -- field access --------------------------------------------------------------------

    def _sync_navier(self) -> None:
        self.navier.state = NavierState(*self.state)
        self.navier.time = self.time
        self.navier._obs_cache = None

    def _pull_navier(self) -> None:
        self.state = NavierState(*self.navier.state)
        self._obs_cache = None

    def update_direct(self) -> None:
        self.update()

    def init_random(self, amp: float, seed: int = 0) -> None:
        self.navier.init_random(amp, seed)
        self._pull_navier()

    def set_velocity(self, amp: float, m: float, n: float) -> None:
        """Seed one velocity eigenmode shape (the eigenmode-sweep initial
        condition)."""
        self._sync_navier()
        self.navier.set_velocity(amp, m, n)
        self._pull_navier()

    def set_temperature(self, amp: float, m: float, n: float) -> None:
        self._sync_navier()
        self.navier.set_temperature(amp, m, n)
        self._pull_navier()

    def set_field(self, name: str, values) -> None:
        self._sync_navier()
        self.navier.set_field(name, values)
        self._pull_navier()

    def get_field(self, name: str) -> np.ndarray:
        self._sync_navier()
        return self.navier.get_field(name)

    def eval_nu(self) -> float:
        """The DNS-vocabulary Nusselt number of the perturbation state (the
        campaign observables are the perturbation energies)."""
        self._sync_navier()
        return self.navier.get_observables()[0]

    def callback(self) -> None:
        self._sync_navier()
        self.navier.write_intervall = self.write_intervall
        self.navier.statistics = self.statistics
        navier_io.callback(self.navier)

    def write(self, filename: str) -> None:
        """The embedded model's gathered snapshot of this state (needs
        ``h5py``)."""
        self._sync_navier()
        self.navier.write(filename)

    def read(self, filename: str) -> None:
        if ckpt.is_sharded_checkpoint(filename):
            # a manifest restores THIS model's leaves (state/...), not the
            # embedded DNS's
            ckpt.read_sharded_snapshot(self, filename)
            return
        self.navier.read(filename)
        self._pull_navier()
        self.time = self.navier.time

    # -- energy and gradients -----------------------------------------------------------

    def _phys(self, state):
        nav = self.navier
        return (nav.velx_space.backward(state.velx), nav.vely_space.backward(state.vely),
                nav.temp_space.backward(state.temp))

    def _host_phys(self, state) -> tuple:
        sp = self.field_space
        return tuple(sp.gather_physical(a).detach().cpu().numpy() for a in self._phys(state))

    def _place_physical(self, values) -> torch.Tensor:
        """Global physical values (host), with any leading dims, in the
        model's layout."""
        values = np.asarray(values)
        sp = self.field_space
        if values.ndim == 2 or sp.mesh is None:
            return sp.place_physical(values)
        return torch.stack([self._place_physical(v) for v in values])

    def _energy(self, state, beta1, beta2, target=None) -> torch.Tensor:
        """The objective of ``state``: :func:`l2_norm` of its physical
        fields (minus the placed target's, a ``(u, v, t)`` of tensors), one
        per member."""
        u, v, t = self._phys(state)
        if target is not None:
            u, v, t = u - target[0], v - target[1], t - target[2]
        w = beta1 * (u * u + v * v) + beta2 * (t * t)
        return 0.5 * self.field_space.weighted_sum(w, self._ones, self.members_of(state))

    def _target(self, target: MeanFields | None):
        if target is None:
            return None
        return tuple(self._place_physical(a) for a in target.physical())

    def energy(self, beta1: float, beta2: float, target: MeanFields | None = None) -> float:
        """:func:`l2_norm` of the current (optionally target-shifted) state."""
        return float(self._energy(self.state, beta1, beta2, self._target(target)))

    def _zero_state(self, lead: tuple = ()) -> NavierState:
        return NavierState(*(torch.zeros(lead + tuple(x.shape), dtype=x.dtype, device=x.device)
                             for x in self.state))

    def _adjoint_ic(self, state, beta1, beta2, target):
        """The adjoint loop's terminal condition: the fields scaled by the
        norm weights (less the target), the pressure kept."""
        velx, vely, temp = state.velx, state.vely, state.temp
        if target is not None:
            sp_f = self.field_space
            coef = {k: sp_f.place_spectral(v) for k, v in target.host_coefficients().items()}
            velx = velx - self.velx_space.from_ortho(coef["velx"])
            vely = vely - self.vely_space.from_ortho(coef["vely"])
            temp = temp - self.temp_space.from_ortho(coef["temp"])
        return state._replace(velx=velx * beta1, vely=vely * beta1, temp=temp * beta2)

    def _steps(self, max_time: float) -> int:
        return max(1, round(max_time / self.dt))

    def _finish_adjoint(self, fun_val: float, outfile: str | None):
        self.reset_time()
        fac = 1.0 if MAXIMIZE else -1.0
        grads = tuple(fac * g for g in self._host_phys(self.state))
        if outfile:
            self._write_grad(outfile, grads)
        return fun_val, grads

    def grad_adjoint(self, max_time: float, save_intervall: float | None = None,
                     beta1: float = 0.5, beta2: float = 0.5, target: MeanFields | None = None,
                     outfile: str | None = None):
        """The hand-adjoint gradient of the final energy with respect to the
        initial condition: ``update_n`` to ``max_time``, the energy, then as
        many adjoint steps from the weighted final state.  Returns
        ``(fun_val, (grad_u, grad_v, grad_t))``, physical host arrays, the
        descent direction (``MAXIMIZE`` flips the sign); ``outfile``:
        written there too (needs ``h5py``)."""
        del save_intervall  # intermediate snapshots are not written
        n = self._steps(max_time)
        self.update_n(n)
        fun_val = self.energy(beta1, beta2, target)
        with torch.no_grad():
            state = self._adjoint_ic(self.state, beta1, beta2, target)
            for _ in range(n):
                state = self._adjoint_step(state)
        self.state = state
        return self._finish_adjoint(fun_val, outfile)

    def _write_grad(self, filename: str, grads) -> None:
        """The gradient fields as a snapshot's ``ux``, ``uy``, ``temp``
        groups (needs ``h5py``)."""
        import os

        import h5py

        from ..field import grid_deltas

        nav = self.navier
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        bases = nav.field_space.bases
        xs = [b.points * s for b, s in zip(bases, self.scale)]
        dxs = [grid_deltas(b.points, b.is_periodic) * s for b, s in zip(bases, self.scale)]
        spaces = (nav.velx_space, nav.vely_space, nav.temp_space)
        with h5py.File(filename, "a") as h5:
            for name, space, g in zip(("ux", "uy", "temp"), spaces, grads):
                ckpt.write_field(h5, name, space, space.forward(space.place_physical(g)), xs, dxs)

    def _objective(self, n: int, beta1, beta2, target, checkpointed: bool = False):
        """``J(u0, v0, t0)``: the energy after ``n`` forward steps from the
        physical initial fields (zero pressures), one value per member when
        the fields carry a leading batch dim; ``checkpointed``: each step
        under ``torch.utils.checkpoint`` (its activations recomputed in the
        backward pass)."""
        nav = self.navier
        placed = self._target(target)

        def one(*fields):
            return tuple(self._step(NavierState(*fields)))

        def objective(u0, v0, t0):
            lead = tuple(u0.shape[: u0.ndim - self.field_ndim])
            state = self._zero_state(lead)._replace(
                velx=nav.velx_space.forward(u0), vely=nav.vely_space.forward(v0),
                temp=nav.temp_space.forward(t0))
            for _ in range(n):
                state = NavierState(*(checkpoint(one, *state, use_reentrant=False)
                                      if checkpointed else one(*state)))
            return self._energy(state, beta1, beta2, placed)

        return objective

    def grad_autodiff(self, max_time: float, beta1: float = 0.5, beta2: float = 0.5,
                      target: MeanFields | None = None):
        """The exact gradient of the discrete objective with respect to the
        physical initial condition, by ``torch.autograd`` through the eager
        forward loop (each step checkpointed).  Starts from the current
        state and does not advance the model; the sign follows
        ``grad_adjoint``'s (``MAXIMIZE``)."""
        n = self._steps(max_time)
        init = [a.detach().clone().requires_grad_(True) for a in self._phys(self.state)]
        with torch.enable_grad():
            val = self._objective(n, beta1, beta2, target, checkpointed=True)(*init)
            grads = torch.autograd.grad(val, init)
        fac = 1.0 if MAXIMIZE else -1.0
        gather = self.field_space.gather_physical
        return float(val.detach()), tuple(fac * gather(g).detach().cpu().numpy() for g in grads)

    def grad_fd(self, max_time: float, beta1: float = 0.5, beta2: float = 0.5,
                eps: float = 1e-5, batch: int = 64):
        """The finite-difference gradient: every physical grid point of
        every field perturbed by ``eps``, forward differences ``(E(x + eps)
        - E(x)) / eps``; the perturbations run ``batch`` at a time as one
        member-stacked state through the step.  Physical host arrays."""
        n = self._steps(max_time)
        base = self._host_phys(self.state)
        objective = self._objective(n, beta1, beta2, None)
        with torch.no_grad():
            e_base = float(objective(*(self._place_physical(a) for a in base)))
            grads = []
            for idx, field in enumerate(base):
                grad = np.zeros(field.size)
                for start in range(0, field.size, batch):
                    count = min(batch, field.size - start)
                    pert = np.tile(field.ravel(), (count, 1))
                    pert[np.arange(count), start + np.arange(count)] += eps
                    args = [np.broadcast_to(a, (count,) + a.shape) for a in base]
                    args[idx] = pert.reshape((count,) + field.shape)
                    energies = objective(*(self._place_physical(a) for a in args))
                    grad[start: start + count] = (energies.cpu().numpy() - e_base) / eps
                grads.append(grad.reshape(field.shape))
        return tuple(grads)


class Navier2DNonLin(Navier2DLnse):
    """The full equations as a perturbation about the base state; its hand
    adjoint consumes the forward trajectory it records."""

    NONLINEAR = True

    def grad_adjoint(self, max_time: float, save_intervall: float | None = None,
                     beta1: float = 0.5, beta2: float = 0.5, target: MeanFields | None = None,
                     outfile: str | None = None):
        """The perturbation form's hand adjoint: the forward loop records
        the ortho-space fields after every step (``n`` x 3 fields, eager on
        the card), and the adjoint loop consumes them in reverse."""
        del save_intervall
        nav = self.navier
        n = self._steps(max_time)
        history = []
        with torch.no_grad():
            state = self.state
            for _ in range(n):
                state = self._step(state)
                history.append((nav.velx_space.to_ortho(state.velx),
                                nav.vely_space.to_ortho(state.vely),
                                nav.temp_space.to_ortho(state.temp)))
            self.state = state
            self.time += n * self.dt
            fun_val = self.energy(beta1, beta2, target)
            state = self._adjoint_ic(self.state, beta1, beta2, target)
            for hist in reversed(history):
                state = self._adjoint_step(state, hist)
        self.state = state
        return self._finish_adjoint(fun_val, outfile)

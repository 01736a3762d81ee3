"""Navier2D — 2-D Boussinesq Rayleigh-Benard DNS in a confined cell.

Counterpart of the JAX package's ``models/navier.py`` for the confined
(Chebyshev x Chebyshev) cell with ``rbc`` boundary conditions, running the
fused route of the step: per step three fused convection chains
(:mod:`..ops.fused_conv`) and seven fused implicit stages
(:mod:`..ops.fused_step`), which launch the hand-written CUDA kernels on a
CUDA device and run their plain PyTorch versions on the CPU.

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
from ..bases import Space2, cheb_dirichlet, cheb_neumann, chebyshev
from ..field import average_weights, norm_l2
from ..ops.fused_conv import build_model_convs
from ..ops.fused_step import build_model_step
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


class Navier2D(CampaignModelBase):
    """Confined 2-D Rayleigh-Benard convection solver.

    Parameters follow the JAX package (nx, ny, ra, pr, dt, aspect, bc);
    ``bc`` must be ``"rbc"``.  ``device`` defaults to ``"cuda"`` and raises
    without a card unless ``"cpu"`` is passed; ``dtype`` is float64 or
    float32."""

    observable_names = ("nu", "nuvol", "re", "div")

    def __init__(self, nx: int, ny: int, ra: float, pr: float, dt: float,
                 aspect: float, bc: str = "rbc", *, device=None,
                 dtype=config.DEFAULT_DTYPE):
        if bc != "rbc":
            raise ValueError(f"boundary condition type {bc!r} is not ported (only 'rbc')")
        self.device = config.resolve_device(device)
        self.dtype = config.check_dtype(dtype)
        self.nx, self.ny = nx, ny
        self.dt = dt
        self.bc = bc
        self.scale = (float(aspect), 1.0)
        nu = fns.get_nu(ra, pr, self.scale[1] * 2.0)
        ka = fns.get_ka(ra, pr, self.scale[1] * 2.0)
        self.params = {"ra": ra, "pr": pr, "nu": nu, "ka": ka}
        self.diagnostics: dict[str, list[float]] = {}
        self._init_campaign()

        kw = dict(device=self.device, dtype=self.dtype)
        self.velx_space = Space2(cheb_dirichlet(nx), cheb_dirichlet(ny), **kw)
        self.vely_space = self.velx_space
        self.temp_space = Space2(cheb_neumann(nx), cheb_dirichlet(ny), **kw)
        self.pres_space = Space2(chebyshev(nx), chebyshev(ny), **kw)
        self.pseu_space = Space2(cheb_neumann(nx), cheb_neumann(ny), **kw)
        self.field_space = Space2(chebyshev(nx), chebyshev(ny), **kw)

        xs, ys = (b.points for b in self.field_space.bases)
        self.x = [xs * self.scale[0], ys * self.scale[1]]
        self._w0 = config.to_device(average_weights(xs), **kw)
        self._w1 = config.to_device(average_weights(ys), **kw)

        self._build_bc_fields(xs, ys)
        self._convs = build_model_convs(self)
        self._stages = build_model_step(self)
        self.state = NavierState(*(
            space.ndarray_spectral() for _, space in self._state_fields()
        ))

    @classmethod
    def new_confined(cls, nx, ny, ra, pr, dt, aspect, bc="rbc", *, device=None,
                     dtype=config.DEFAULT_DTYPE) -> "Navier2D":
        """Chebyshev x Chebyshev cell with the random initial condition of
        the JAX package's ``new_confined`` (amplitude 0.1, seed 0)."""
        model = cls(nx, ny, ra, pr, dt, aspect, bc, device=device, dtype=dtype)
        model.init_random(0.1)
        return model

    def _state_fields(self) -> list:
        return [
            ("temp", self.temp_space),
            ("velx", self.velx_space),
            ("vely", self.vely_space),
            ("pres", self.pres_space),
            ("pseu", self.pseu_space),
        ]

    def _build_bc_fields(self, xs: np.ndarray, ys: np.ndarray) -> None:
        """Transform the BC lift profile into ortho-space constants and its
        derivatives, in f64 on the host (``host_bc`` keeps those copies for
        the stage builder), then place them in the model's device and
        dtype."""
        base_x, base_y = self.field_space.bases
        sp = Space2(base_x, base_y, device="cpu", dtype=torch.float64)
        scale = self.scale
        dt, ka = self.dt, self.params["ka"]
        that = sp.forward(torch.as_tensor(bcs.bc_rbc_values(xs, ys), dtype=torch.float64))
        host = {
            "ortho": that,
            "dx": sp.backward_ortho(sp.gradient(that, (1, 0), scale)),
            "dy": sp.backward_ortho(sp.gradient(that, (0, 1), scale)),
            "diff": dt * ka * (sp.gradient(that, (2, 0), scale) + sp.gradient(that, (0, 2), scale)),
        }
        self.host_bc = {k: v.numpy() for k, v in host.items()}
        dev = {k: v.to(device=self.device, dtype=self.dtype) for k, v in host.items()}
        self.tempbc_ortho = dev["ortho"]
        self._tempbc_dx, self._tempbc_dy = dev["dx"], dev["dy"]
        self._tempbc_diff = dev["diff"]

    # -- initial conditions --------------------------------------------------

    def init_random(self, amp: float, seed: int = 0) -> None:
        """Uniform random disturbance on temp/velx/vely from numpy's
        ``default_rng(seed)``, the same stream as the JAX package."""
        rng = np.random.default_rng(seed)
        for name in ("temp", "velx", "vely"):
            space: Space2 = getattr(self, f"{name}_space")
            self.set_field(name, fns.random_values(space.shape_physical, amp, rng))

    def set_field(self, name: str, values: np.ndarray) -> None:
        """Set one variable from physical values (host -> device forward)."""
        space: Space2 = getattr(self, f"{name}_space")
        v = torch.tensor(np.asarray(values), dtype=self.dtype, device=self.device)
        self.state = self.state._replace(**{name: space.forward(v)})

    def get_field(self, name: str) -> np.ndarray:
        """Physical values of one variable (device backward -> host)."""
        space: Space2 = getattr(self, f"{name}_space")
        return space.backward(getattr(self.state, name)).cpu().numpy()

    # -- the time step -------------------------------------------------------

    def _conv(self, ux, uy, space, vhat, with_bc=False):
        """u . grad(v), dealiased, in scratch-ortho space (fused chain)."""
        fc = self._convs[id(space)]
        if with_bc:
            return fc.apply(ux, uy, vhat, self._tempbc_dx, self._tempbc_dy)
        return fc.apply(ux, uy, vhat)

    def _step(self, state: NavierState) -> NavierState:
        st = self._stages
        sp_u, sp_v, sp_t, sp_q = self.velx_space, self.vely_space, self.temp_space, self.pseu_space
        temp, velx, vely, pres = state.temp, state.velx, state.vely, state.pres
        # convection velocities in physical space (old time level)
        ux = sp_u.backward_fast(velx)
        uy = sp_v.backward_fast(vely)
        velx_n = st["velx"].apply(velx, pres, self._conv(ux, uy, sp_u, velx))
        vely_n = st["vely"].apply(vely, pres, temp, self._conv(ux, uy, sp_v, vely))
        div = st["div"].apply(velx_n, vely_n)
        pseu_n = sp_q.pin_zero_mode(st["poisson"].apply(div))
        velx_n = velx_n - st["projx"].apply(pseu_n)
        vely_n = vely_n - st["projy"].apply(pseu_n)
        pres_n = pres - self.params["nu"] * div + sp_q.to_ortho(pseu_n) / self.dt
        temp_n = st["temp"].apply(temp, self._conv(ux, uy, sp_t, temp, with_bc=True))
        return NavierState(temp_n, velx_n, vely_n, pres_n, pseu_n)

    # -- observables ---------------------------------------------------------

    def _div(self, state: NavierState) -> torch.Tensor:
        return self.velx_space.gradient(state.velx, (1, 0), self.scale) + \
            self.vely_space.gradient(state.vely, (0, 1), self.scale)

    def _observables(self, state: NavierState) -> torch.Tensor:
        """(Nu, Nuvol, Re, |div|) as one tensor on the model's device."""
        sp_f = self.field_space
        scale = self.scale
        nu, ka = self.params["nu"], self.params["ka"]
        w0, w1 = self._w0, self._w1

        def avg(v):
            return torch.sum(v * w0[:, None] * w1[None, :])

        that = self.temp_space.to_ortho(state.temp) + self.tempbc_ortho
        dtdy_p = sp_f.backward_gradient(that, (0, 1), None)
        # Nu: plate heat flux <-2/sy * dT/dy>_x averaged over both plates
        x_avg = torch.sum(dtdy_p * w0[:, None], dim=0) * (-2.0 / scale[1])
        nu_plate = 0.5 * (x_avg[0] + x_avg[-1])
        # Nuvol: <2 sy (uy T / ka - dT/dy / sy)>_V
        temp_p = sp_f.backward_ortho(that)
        uy = self.vely_space.backward(state.vely)
        nu_vol = avg((dtdy_p / (-scale[1]) + uy * temp_p / ka) * 2.0 * scale[1])
        # Re: <sqrt(ux^2+uy^2) * 2 sy / nu>_V
        ux = self.velx_space.backward(state.velx)
        re = avg(torch.sqrt(ux**2 + uy**2) * 2.0 * scale[1] / nu)
        return torch.stack([nu_plate, nu_vol, re, norm_l2(self._div(state))])

    def eval_nu(self) -> float:
        return self.get_observables()[0]

    def eval_nuvol(self) -> float:
        return self.get_observables()[1]

    def eval_re(self) -> float:
        return self.get_observables()[2]

    def callback(self) -> None:
        """Save-boundary hook of :func:`..utils.integrate.integrate`: append
        the observables to ``diagnostics`` and print them (flow snapshots
        are not ported yet)."""
        t = self.get_time()
        nu, nuvol, re, div = self.get_observables()
        for key, val in (("time", t), ("nu", nu), ("nuvol", nuvol), ("re", re), ("div", div)):
            self.diagnostics.setdefault(key, []).append(float(val))
        print(f"time = {t:9.3f}      |div| = {div:4.2e}      "
              f"Nu = {nu:5.3e}      Nuv = {nuvol:5.3e}      Re = {re:5.3e}")

"""The in-scan physics-statistics engine: running sums carried through the
chunks beside the state, their health readout, and their export
(counterpart of the JAX package's ``models/stats.py``).

A :class:`StatsState` of running sums rides the chunk's carry
(:mod:`.campaign`): every ``stride`` steps one sample of the stepped state
is folded in on the device, per member in an ensemble, on pencils on a
mesh.  The sums ride the gathered snapshots (``stats_state/``) and restore
bit for bit.  The engine only reads the state: the trajectory is bit for
bit the same with statistics on and off.

What is accumulated (per member), as the JAX package accumulates it:

* the legacy set: spectral sums of T (ortho, no BC lift), ux, uy, and the
  pointwise Nusselt field (with the lift, dealiased), which
  :func:`export_stats` writes in the reference's ``statistics.h5`` layout;
* x-averaged profiles: mean T, second moments of T/ux/uy, the convective
  flux ``uy T``;
* per-axis energy spectra of T/ux/uy in natural mode order (the port
  stores every spectral axis in natural order: a Chebyshev axis by degree,
  a Fourier r2c axis by wavenumber, so no fold is needed);
* budget scalars: plate-flux Nu, volume Nu, the flux Nu ``1 + <uy T> 2
  sy / ka``, kinetic energy (first, last and sum), buoyancy production and
  viscous dissipation, and the window's span in simulated time (each
  sample adds its own ``stride * dt``, so a window that crosses a dt rung
  move stays exact).

The leaves hold the global arrays on the model's device (a meshed model's
pencils are gathered inside the sample; on a mesh whose ranks span
processes through the ring, three pushes a sample), so the snapshot rows
and a restore need no layout.  :data:`HEALTH_NAMES` are the readout's scalars:
spectral-tail fractions, boundary-layer point counts, budget residuals.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bases import BaseKind
from ..field import average_weights


class StatsState(NamedTuple):
    """The running sums of one model (an ensemble's carry a leading K dim
    on every leaf).  Scalars have shape ``(1,)``."""

    t_sum: torch.Tensor  # T composite -> ortho, no BC lift
    ux_sum: torch.Tensor
    uy_sum: torch.Tensor
    nusselt_sum: torch.Tensor  # pointwise Nusselt field (with the lift, dealiased)
    spec_x: torch.Tensor  # (3, x modes): |coeff|^2 summed over y, rows (T, ux, uy)
    spec_y: torch.Tensor  # (3, y modes): |coeff|^2 summed over x
    t_prof_sum: torch.Tensor  # x-averaged profiles (ny,): mean T (with the lift)
    t2_prof_sum: torch.Tensor
    ux2_prof_sum: torch.Tensor
    uy2_prof_sum: torch.Tensor
    flux_prof_sum: torch.Tensor  # uy * T
    nu_plate_sum: torch.Tensor  # budget scalars, shape (1,)
    nuvol_sum: torch.Tensor
    flux_vol_sum: torch.Tensor  # <uy T> 2 sy / ka
    ke_sum: torch.Tensor
    buoy_sum: torch.Tensor  # <uy T>
    diss_sum: torch.Tensor  # nu <|grad u|^2>
    ke_first: torch.Tensor  # KE at the window's first sample
    ke_last: torch.Tensor  # KE at its newest sample
    span_sum: torch.Tensor  # sum of each sample's stride * dt
    span_first: torch.Tensor  # span_sum at the first sample
    samples: torch.Tensor  # sample count (real dtype)


#: the health readout's scalars, in order (:meth:`StatsEngine.health`)
HEALTH_NAMES = (
    "tail_t_x",
    "tail_t_y",
    "tail_ux_x",
    "tail_ux_y",
    "tail_uy_x",
    "tail_uy_y",
    "bl_thermal_pts",
    "bl_visc_pts",
    "ke_residual",
    "nu_residual",
    "nu_plate_avg",
    "nu_flux_avg",
    "samples",
)


#: the metrics counter of each statistics-flow failure (the JAX package's)
_EVENT_COUNTERS = {
    "stats_mismatch": ("stats_mismatch_total",
                       "legacy statistics time-mismatch rejections (averages NOT updated)"),
    "stats_write_failed": ("stats_write_failed_total",
                           "statistics.h5 write failures (averages survive in memory only)"),
}


def report_stats_event(model, event: dict) -> None:
    """Count a statistics-flow failure (``stats_mismatch``,
    ``stats_write_failed``) on its metrics counter and append it to the
    model's attached ``journal_writer``, when it has one."""
    from ..telemetry import metrics as _tm

    counter = _EVENT_COUNTERS.get(event.get("event"))
    if counter is not None:
        _tm.counter(*counter).inc()
    writer = getattr(model, "journal_writer", None)
    if writer is not None:
        writer.append(dict(event))


def health_events(engine, vals) -> list:
    """The events the JAX package's resilient runner journals from one
    health readout (``vals`` in :data:`HEALTH_NAMES` order, floats or (K,)
    arrays, reduced to the worst member: the least boundary-layer point
    count, the greatest of the rest):

    * ``resolution_warning`` when the largest spectral-tail fraction
      exceeds ``engine.tail_warn`` (``field``, ``axis``, ``tail_fraction``,
      ``threshold``, ``samples``);
    * ``budget_drift`` when ``nu_residual`` exceeds ``engine.budget_warn``
      after two samples or more, every number from the one member with the
      largest residual (``member``, ``nu_residual``, ``ke_residual``,
      ``nu_plate_avg``, ``nu_flux_avg``, ``threshold``, ``samples``).

    None before the first sample.  The runner also latches each event
    until its value falls below half the limit; this function reports
    what is crossed now."""
    arrs, d = {}, {}
    for name, v in zip(HEALTH_NAMES, vals):
        arr = np.asarray(v, dtype=np.float64).reshape(-1)
        arrs[name] = arr
        red = np.min if name.startswith("bl_") else np.max
        d[name] = float(red(arr)) if arr.size else 0.0
    if d["samples"] < 1.0:
        return []
    events = []
    tails = {(f, a): d[f"tail_{key}_{a}"]
             for f, key in (("temp", "t"), ("ux", "ux"), ("uy", "uy")) for a in ("x", "y")}
    worst = max(tails, key=tails.get)
    if tails[worst] > engine.tail_warn:
        events.append({"event": "resolution_warning", "field": worst[0], "axis": worst[1],
                       "tail_fraction": tails[worst], "threshold": engine.tail_warn,
                       "samples": d["samples"]})
    if d["nu_residual"] > engine.budget_warn and d["samples"] >= 2:
        m = int(arrs["nu_residual"].argmax()) if arrs["nu_residual"].size else 0
        budget = {name: float(arrs[name][m]) for name in
                  ("nu_residual", "ke_residual", "nu_plate_avg", "nu_flux_avg", "samples")}
        events.append({"event": "budget_drift", "member": m, **budget,
                       "threshold": engine.budget_warn})
    return events


def _global_spectral(space, x: torch.Tensor) -> torch.Tensor:
    """The global array of a spectral field (a pencil space's x-pencils,
    ``(..., P, n0p, n1p/P)``, gathered and the pad sliced away; a serial
    space's field itself).  Leading member dims are kept."""
    if space.mesh is None:
        return x
    d = space.spectral
    n0, n1 = d.global_shape
    g = x.transpose(-3, -2).reshape(*x.shape[:-3], *d.padded_shape)
    return g[..., :n0, :n1]


def _pencil_spectral(space, g: torch.Tensor) -> torch.Tensor:
    """The x-pencils of a global spectral array (the inverse of
    :func:`_global_spectral`, this process's ranks of a spanning mesh; a
    serial space's array itself)."""
    if space.mesh is None:
        return g
    d = space.spectral
    (n0, n1), (p0, p1) = d.global_shape, d.padded_shape
    g = torch.nn.functional.pad(g, (0, p1 - n1, 0, p0 - n0))
    mesh = space.mesh
    nr = mesh.nranks
    g = g.reshape(*g.shape[:-1], nr, p1 // nr).transpose(-3, -2)
    return g[..., mesh.rank0: mesh.rank0 + mesh.nlocal, :, :].contiguous()


def _global_arrays(spaces, blocks, spectral: bool) -> list:
    """The global arrays of ``blocks``, each a pencil of its space in
    ``spaces``: spectral x-pencils (:func:`_global_spectral`) or physical
    y-pencils (:func:`_global_physical`).  On a mesh whose ranks span
    processes every rank's blocks come through the ring
    (:func:`..parallel.decomp.all_gather_pencils`: one push a shape,
    capturable), laid out as the one-process mesh's, so a sample is its
    sample bit for bit."""
    mesh = spaces[0].mesh
    one = _global_spectral if spectral else _global_physical
    if not getattr(mesh, "spanning", False):
        return [one(sp, x) for sp, x in zip(spaces, blocks)]
    from ..parallel.decomp import all_gather_pencils

    full = all_gather_pencils(blocks, mesh, x_pencil=spectral)
    return [g[..., :n0, :n1] for g, (n0, n1) in
            zip(full, ((sp.spectral if spectral else sp.physical).global_shape for sp in spaces))]


def _stencil_diagonals(space, dev, rdt) -> list:
    """Per axis of ``space``, its stencil S (composite -> orthogonal
    coefficients, n x m, nonzero only at rows ``j + o`` of column j for a
    few offsets o >= 0) as ``(n, [(o, S[j + o, j] over j), ...])``, or None
    where S is the identity (a Fourier or an orthogonal axis)."""
    axes = []
    for base in space.bases:
        if base.is_periodic or base.kind == BaseKind.CHEBYSHEV:
            axes.append(None)
            continue
        s = base.stencil
        n, m = s.shape
        rows, cols = np.nonzero(s)
        diags = [(int(o), torch.as_tensor(np.diagonal(s, -o)[:m].copy(), dtype=rdt, device=dev))
                 for o in sorted(set((rows - cols).tolist()))]
        axes.append((n, diags))
    return axes


def _apply_stencil(axes, v: torch.Tensor) -> torch.Tensor:
    """``to_ortho`` of a global composite array ``v`` (leading member dims
    kept) by the diagonals of :func:`_stencil_diagonals`: a few
    multiply-adds along each axis in place of a dense product."""
    for axis, band in enumerate(axes):
        if band is None:
            continue
        n, diags = band
        ax = v.ndim - 2 + axis
        m = v.shape[ax]
        out = v.new_zeros((*v.shape[:ax], n, *v.shape[ax + 1:]))
        tail = (1,) * (v.ndim - 1 - ax)
        for o, d in diags:
            out.narrow(ax, o, m).addcmul_(v, d.reshape(m, *tail))
        v = out
    return v


def _global_physical(space, v: torch.Tensor) -> torch.Tensor:
    """The global array of a physical field (a pencil space's y-pencils,
    ``(..., P, n0p/P, n1p)``; a serial space's field itself)."""
    if space.mesh is None:
        return v
    d = space.physical
    n0, n1 = d.global_shape
    return v.reshape(*v.shape[:-3], *d.padded_shape)[..., :n0, :n1]


class StatsEngine:
    """The statistics of one DNS model (``MODEL_KIND == "dns"``): the
    sample of a state (:meth:`sample`), the fold of a sample into the sums
    (:meth:`fold`), the health readout (:meth:`health`), the zero sums
    (:meth:`init_state`) and the snapshot rows (:meth:`host_items`,
    :meth:`restore_state`).  The threading through the chunks lives in
    :class:`.campaign.CampaignModelBase` and the ensemble.

    Every operator and constant the sample reads is on the device once it
    ran (``set_stats`` runs it), so the sample can be captured in a CUDA
    graph."""

    def __init__(self, model, cfg=None):
        if getattr(model, "MODEL_KIND", "") != "dns":
            raise TypeError(
                "the stats engine reads DNS fields (temp/velx/vely); model kind "
                f"{getattr(model, 'MODEL_KIND', '?')!r} is not supported")
        from ..config import StatsConfig

        defaults = StatsConfig()
        self.model = model
        self.cfg = cfg
        stride = getattr(cfg, "stride", None)
        self.stride = max(1, int(defaults.stride if stride is None else stride))
        tail_warn = getattr(cfg, "tail_warn", None)
        self.tail_warn = float(defaults.tail_warn if tail_warn is None else tail_warn)
        budget_warn = getattr(cfg, "budget_warn", None)
        self.budget_warn = float(defaults.budget_warn if budget_warn is None else budget_warn)
        sp = model.field_space
        dev, rdt = model.state.temp.device, model.dtype
        xs, ys = (b.points for b in sp.bases)
        self._w0 = torch.as_tensor(average_weights(xs, model.periodic), dtype=rdt, device=dev)
        self._w1 = torch.as_tensor(average_weights(ys), dtype=rdt, device=dev)
        self._mask = sp.place_spectral(sp.dealias_mask(), dtype=rdt)
        y = np.asarray(ys, dtype=np.float64) * model.scale[1]
        # distance from the nearest plate, per y grid point
        self._dist = torch.as_tensor(np.minimum(y - y.min(), y.max() - y), dtype=rdt,
                                     device=dev)
        self._dy0, self._dy1 = abs(y[1] - y[0]), abs(y[-1] - y[-2])
        # each field's stencil as its diagonals: two or three multiply-adds
        # an axis where a dense product would be a 1025^2 GEMM
        self._stencils = tuple(_stencil_diagonals(space, dev, rdt)
                               for space in (model.temp_space, model.velx_space, model.vely_space))

    # -- the sample --------------------------------------------------------------

    def sample(self, state) -> StatsState:
        """One state's contribution (``samples == 1``), with the state's
        leading member dims: the JAX package's ``sample_fn`` (the legacy
        accumulator's and the observables' ingredients).  The x averages
        are products with the x weights, and the volume averages the
        profiles' products with the y weights."""
        m = self.model
        sp_t, sp_u, sp_v, sp_f = m.temp_space, m.velx_space, m.vely_space, m.field_space
        scale, nu, ka = m.scale, m.params["nu"], m.params["ka"]
        w1 = self._w1
        lead = state.temp.ndim - m.field_ndim

        def avg_x(v):
            return torch.matmul(self._w0, v)

        def spec_pair(c):
            e = torch.abs(c) ** 2 if c.is_complex() else c * c
            return e.sum(dim=-1), e.sum(dim=-2)

        def s1(v):
            return v.reshape(*v.shape, 1)

        def dot_y(prof):
            return s1(torch.matmul(prof, w1))

        # the orthogonal coefficients, global (a meshed model's composite
        # pencils gathered first), then as the field space holds them
        that_g, uxhat_g, uyhat_g = (
            _apply_stencil(axes, g) for axes, g in zip(
                self._stencils, _global_arrays((sp_t, sp_u, sp_v),
                                               (state.temp, state.velx, state.vely), True)))
        uxhat, uyhat = _pencil_spectral(sp_f, uxhat_g), _pencil_spectral(sp_f, uyhat_g)
        # the physical temperature (with the lift)
        that = _pencil_spectral(sp_f, that_g) + m.tempbc_ortho
        # the syntheses of the ortho coefficients, sharing each x factor
        temp_pen, dtdy_pen = sp_f.synthesize(that, ((0, 0), (0, 1)))
        ux_pen, duxdx, duxdy = sp_f.synthesize(uxhat, ((0, 0), (1, 0), (0, 1)), scale)
        uy_pen, duydx, duydy = sp_f.synthesize(uyhat, ((0, 0), (1, 0), (0, 1)), scale)
        nusselt_pen = (dtdy_pen / (-scale[1]) + uy_pen * temp_pen / ka) * 2.0 * scale[1]
        nusselt, = _global_arrays((sp_f,), (sp_f.forward(nusselt_pen) * self._mask,), True)
        temp_p, ux_p, uy_p, dtdy_p, nusselt_p, *grads = _global_arrays(
            (sp_f,) * 9, (temp_pen, ux_pen, uy_pen, dtdy_pen, nusselt_pen,
                          duxdx, duxdy, duydx, duydy), False)
        tx, ty = spec_pair(that_g)
        uxx, uxy = spec_pair(uxhat_g)
        uyx, uyy = spec_pair(uyhat_g)
        x_avg = avg_x(dtdy_p) * (-2.0 / scale[1])
        nu_plate = 0.5 * (x_avg[..., 0] + x_avg[..., -1])
        flux_prof = avg_x(uy_p * temp_p)
        ux2_prof, uy2_prof = avg_x(ux_p**2), avg_x(uy_p**2)
        ke = 0.5 * (dot_y(ux2_prof) + dot_y(uy2_prof))
        grad2 = sum(g ** 2 for g in grads)
        span = torch.full((*state.temp.shape[:lead], 1), float(self.stride) * float(m.dt),
                          dtype=m.dtype, device=ke.device)
        buoy = dot_y(flux_prof)
        return StatsState(
            t_sum=that_g,
            ux_sum=uxhat_g,
            uy_sum=uyhat_g,
            nusselt_sum=nusselt,
            spec_x=torch.stack([tx, uxx, uyx], dim=-2),
            spec_y=torch.stack([ty, uxy, uyy], dim=-2),
            t_prof_sum=avg_x(temp_p),
            t2_prof_sum=avg_x(temp_p**2),
            ux2_prof_sum=ux2_prof,
            uy2_prof_sum=uy2_prof,
            flux_prof_sum=flux_prof,
            nu_plate_sum=s1(nu_plate),
            nuvol_sum=dot_y(avg_x(nusselt_p)),
            flux_vol_sum=buoy * (2.0 * scale[1] / ka),
            ke_sum=ke,
            buoy_sum=buoy,
            diss_sum=nu * dot_y(avg_x(grad2)),
            ke_first=ke,
            ke_last=ke,
            span_sum=span,
            span_first=span,
            samples=torch.ones_like(span),
        )

    @staticmethod
    def fold(ss: StatsState, c: StatsState) -> StatsState:
        """The sums after one sample ``c``: every leaf adds; ``ke_first`` and
        ``span_first`` keep the window's first sample's, ``ke_last`` takes
        the newest (the JAX package's ``accum_fn``)."""
        out = StatsState(*(a + b for a, b in zip(ss, c)))
        first = ss.samples > 0
        return out._replace(
            ke_first=torch.where(first, ss.ke_first, c.ke_first),
            ke_last=c.ke_last,
            span_first=torch.where(first, ss.span_first, out.span_sum),
        )

    def accumulate(self, ss: StatsState, state) -> StatsState:
        """``fold(ss, sample(state))``."""
        return self.fold(ss, self.sample(state))

    # the JAX package's accessors, which return its compiled functions
    def sample_fn(self):
        """``state -> StatsState``: :meth:`sample`."""
        return self.sample

    def accum_fn(self):
        """``(stats_state, state) -> stats_state``: :meth:`accumulate`."""
        return self.accumulate

    def health_fn(self):
        """``stats_state ->`` the :data:`HEALTH_NAMES` values: :meth:`health`."""
        return self.health

    # -- the health readout --------------------------------------------------------

    def health(self, ss: StatsState) -> torch.Tensor:
        """The :data:`HEALTH_NAMES` scalars of the running sums, as one
        tensor with a last dim of 13 (after any member dims): no field
        transforms, the JAX package's ``health_fn``."""
        dist = self._dist
        n = torch.clamp(ss.samples[..., 0], min=1.0)
        has = ss.samples[..., 0] > 0

        def tails(spec):
            """Energy fraction in the top third of the modes, rows (T, ux,
            uy): energy piling at the dealias cut reads as
            under-resolution."""
            tot = spec.sum(dim=-1)
            cut = (2 * int(spec.shape[-1])) // 3
            t = spec[..., cut:].sum(dim=-1) / torch.clamp(tot, min=1e-300)
            return torch.where(tot > 0, t, torch.zeros_like(t))

        tx, ty = tails(ss.spec_x), tails(ss.spec_y)
        t_prof = ss.t_prof_sum / n[..., None]
        # thermal boundary layer from the mean profile's wall slope
        slope = 0.5 * (torch.abs(t_prof[..., 1] - t_prof[..., 0]) / self._dy0
                       + torch.abs(t_prof[..., -1] - t_prof[..., -2]) / self._dy1)
        d_temp = torch.abs(t_prof[..., -1] - t_prof[..., 0])
        delta_t = 0.5 * d_temp / torch.clamp(slope, min=1e-300)
        bl_thermal = (dist < delta_t[..., None]).to(dist.dtype).sum(dim=-1)
        # viscous boundary layer: the horizontal-velocity RMS peak's distance
        ux_rms = torch.sqrt(torch.clamp(ss.ux2_prof_sum / n[..., None], min=0.0))
        delta_u = dist[torch.argmax(ux_rms, dim=-1)]
        bl_visc = (dist < delta_u[..., None]).to(dist.dtype).sum(dim=-1)
        nu_plate = ss.nu_plate_sum[..., 0] / n
        nu_flux = 1.0 + ss.flux_vol_sum[..., 0] / n
        nu_resid = torch.abs(nu_plate - nu_flux) / torch.clamp(torch.abs(nu_flux), min=1.0)
        prod = ss.buoy_sum[..., 0] / n
        dis = ss.diss_sum[..., 0] / n
        span = torch.clamp(ss.span_sum[..., 0] - ss.span_first[..., 0], min=1e-300)
        dkedt = (ss.ke_last[..., 0] - ss.ke_first[..., 0]) / span
        ke_resid = torch.abs(prod - dis - dkedt) / torch.clamp(
            torch.maximum(torch.abs(prod), torch.abs(dis)), min=1e-9)
        vals = torch.stack([tx[..., 0], ty[..., 0], tx[..., 1], ty[..., 1], tx[..., 2], ty[..., 2],
                            bl_thermal, bl_visc, ke_resid, nu_resid, nu_plate, nu_flux], dim=-1)
        vals = torch.where(has[..., None], vals, torch.zeros_like(vals))
        return torch.cat([vals, ss.samples], dim=-1)

    # -- zero sums and snapshot rows ----------------------------------------------------

    def init_state(self, k: int | None = None) -> StatsState:
        """Zero sums (``k`` adds a leading member dim)."""
        m = self.model
        sp = m.field_space
        dev, rdt = self._w0.device, m.dtype
        lead = () if k is None else (int(k),)
        mx, my = sp.shape_spectral
        ny = sp.shape_physical[1]

        def z(*shape, dtype=rdt):
            return torch.zeros((*lead, *shape), dtype=dtype, device=dev)

        spec = sp.spectral_dtype
        return StatsState(
            z(mx, my, dtype=spec), z(mx, my, dtype=spec), z(mx, my, dtype=spec),
            z(mx, my, dtype=spec), z(3, mx), z(3, my),
            *(z(ny) for _ in range(5)), *(z(1) for _ in range(11)))

    def host_items(self, stats_state: StatsState, tick) -> list:
        """``(h5path, numpy array, "raw")`` rows of the gathered snapshot for
        the running sums and the tick (exact dtypes: the restore is bit
        for bit)."""
        items = [(f"stats_state/{name}", getattr(stats_state, name).detach().cpu().numpy(), "raw")
                 for name in stats_state._fields]
        items.append(("stats_state/tick", tick.detach().cpu().numpy(), "raw"))
        return items

    def split_restored(self, updates: dict) -> dict:
        """Pull the leaf entries (and ``tick``) out of a restore dict
        (mutated in place) for :meth:`restore_state`."""
        names = StatsState._fields + ("tick",)
        return {n: updates.pop(n) for n in names if n in updates}

    def restore_state(self, data: dict | None, k: int | None = None):
        """``(stats_state, tick)`` from a restore dict (leaf names and
        ``tick``).  No data, or missing leaves, restart at zero (a snapshot
        written without statistics); a leaf of another shape (a restart at
        another resolution or member count) restarts the whole window."""
        init = self.init_state(k=k)
        dev = init.samples.device
        zero_tick = torch.zeros((1,), dtype=torch.int32, device=dev)
        if not data:
            return init, zero_tick
        for name in init._fields:
            arr = data.get(name)
            want = tuple(getattr(init, name).shape)
            if arr is not None and tuple(np.shape(arr)) != want:
                print(f"restored stats leaf {name!r} has shape {tuple(np.shape(arr))} != {want}; "
                      "running averages restart from zero")
                return init, zero_tick
        fields = {}
        for name in init._fields:
            arr = data.get(name)
            like = getattr(init, name)
            fields[name] = (like if arr is None else
                            torch.as_tensor(np.asarray(arr)).to(device=dev, dtype=like.dtype))
        tick = data.get("tick")
        tick = zero_tick if tick is None else torch.as_tensor(
            np.asarray(tick).astype(np.int32).reshape(1), device=dev)
        return StatsState(**fields), tick


# -- host-side export ---------------------------------------------------------------


def _host_state(ss: StatsState) -> StatsState:
    return StatsState(*(t.detach().cpu().numpy() for t in ss))


def _averages(host: StatsState) -> dict:
    """Running averages from host (numpy) sums."""
    n = max(float(np.asarray(host.samples).reshape(-1)[0]), 1.0)
    out = {"samples": int(np.asarray(host.samples).reshape(-1)[0])}
    for name in ("t_sum", "ux_sum", "uy_sum", "nusselt_sum"):
        out[name[:-4] + "_avg"] = np.asarray(getattr(host, name)) / n
    out["t_prof"] = np.asarray(host.t_prof_sum) / n
    out["t_rms"] = np.sqrt(np.maximum(np.asarray(host.t2_prof_sum) / n - out["t_prof"] ** 2, 0.0))
    out["ux_rms"] = np.sqrt(np.maximum(np.asarray(host.ux2_prof_sum) / n, 0.0))
    out["uy_rms"] = np.sqrt(np.maximum(np.asarray(host.uy2_prof_sum) / n, 0.0))
    out["flux_prof"] = np.asarray(host.flux_prof_sum) / n
    out["spec_x"] = np.asarray(host.spec_x) / n
    out["spec_y"] = np.asarray(host.spec_y) / n
    return out


def serial_space(space):
    """The serial space of a field space (a pencil space's own)."""
    return getattr(space, "space", space)


def _write_member(h5, prefix: str, model, host: StatsState, tot_time: float) -> None:
    """One member's export: the reference's ``statistics.h5`` groups
    (``{temp,ux,uy,nusselt}/{x,dx,y,dy,v,vhat}``, the counters, the
    parameters) and the engine's ``profiles/`` and ``spectra/``.
    ``tot_time`` is the running object's clock."""
    from ..field import grid_deltas
    from ..utils.checkpoint import write_field

    avgs = _averages(host)
    sp = serial_space(model.field_space)
    xs = [b.points * s for b, s in zip(sp.bases, model.scale)]
    dxs = [grid_deltas(b.points, b.is_periodic) * s for b, s in zip(sp.bases, model.scale)]
    root = h5.require_group(prefix) if prefix else h5
    for varname, key in (("temp", "t_avg"), ("ux", "ux_avg"), ("uy", "uy_avg"),
                         ("nusselt", "nusselt_avg")):
        vhat = torch.as_tensor(avgs[key]).to(device=sp.device, dtype=sp.spectral_dtype)
        write_field(root, varname, sp, vhat, xs, dxs)
    for key, value in (
        ("tot_time", float(tot_time)),
        # each sample's own stride*dt: exact across dt rung moves
        ("avg_time", float(np.asarray(host.span_sum).reshape(-1)[0])),
        ("num_save", float(avgs["samples"])),
    ):
        if key in root:
            del root[key]
        root.create_dataset(key, data=value)
    for key, value in model.params.items():
        if key in root:
            del root[key]
        root.create_dataset(key, data=float(value))
    prof = root.require_group("profiles")
    for key, data in (("y", xs[1]), ("t_mean", avgs["t_prof"]), ("t_rms", avgs["t_rms"]),
                      ("ux_rms", avgs["ux_rms"]), ("uy_rms", avgs["uy_rms"]),
                      ("flux", avgs["flux_prof"])):
        if key in prof:
            del prof[key]
        prof.create_dataset(key, data=np.asarray(data, dtype=np.float64))
    spec = root.require_group("spectra")
    for key, data in (("x", avgs["spec_x"]), ("y", avgs["spec_y"])):
        if key in spec:
            del spec[key]
        spec.create_dataset(key, data=np.asarray(data, dtype=np.float64))


def export_stats(pde, filename: str) -> None:
    """Write the running averages to HDF5 (needs ``h5py``), as the JAX
    package's ``export_stats``: a model writes the reference's
    ``statistics.h5`` root layout plus ``profiles``/``spectra``; an
    ensemble writes groups ``member{i}/`` of the same layout and a root
    ``members``.  ``plot/plot_statistics.py`` reads both.  On a mesh whose
    ranks span processes every process holds the same sums, and the root
    writes them (the others return)."""
    import os

    if not getattr(pde, "stats_armed", False):
        raise RuntimeError("export_stats needs an armed stats engine (set_stats)")
    from ..utils.checkpoint import writes_here

    if not writes_here(pde):
        return
    import h5py

    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    is_ens = hasattr(pde, "member_state")
    model = pde.model if is_ens else pde
    host = _host_state(pde.stats_state)
    with h5py.File(filename, "a") as h5:
        h5.attrs["stats_engine"] = 1
        h5.attrs["stride"] = int(model.stats_engine.stride)
        if is_ens:
            if "members" in h5:
                del h5["members"]
            h5.create_dataset("members", data=int(pde.k))
            for i in range(pde.k):
                member = StatsState(*(x[i] for x in host))
                _write_member(h5, f"member{i}", model, member, pde.get_time())
        else:
            _write_member(h5, "", model, host, pde.get_time())

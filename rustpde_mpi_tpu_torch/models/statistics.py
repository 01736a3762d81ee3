"""Running-average flow statistics with HDF5 persistence, the eager form
(counterpart of the JAX package's ``models/statistics.py``, the
reference's ``statistics.rs``): spectral running averages of the
temperature (ortho, no BC lift), the velocities and the pointwise Nusselt
field, updated with the reference's ``(avg*n + new) / (n+1)`` weighting and
written in its layout (``{temp,ux,uy,nusselt}/{x,dx,y,dy,v,vhat}``, the
counters ``tot_time``/``avg_time``/``num_save`` and the parameters).

As the JAX package (two fixes over the reference): all four averages run,
and the Nusselt field includes the temperature's BC lift.  The averages
are host numpy arrays of the global coefficients (a meshed model's
gathered); the Nusselt field is built on the model's device.  The
in-scan engine (:mod:`.stats`) is the form that runs inside the chunks.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .stats import report_stats_event, serial_space


class Statistics:
    """Attach with ``model.statistics = Statistics(model, save_stat,
    write_stat)``; the ``integrate`` callback then updates the averages
    every ``save_stat`` and writes ``data/statistics.h5`` every
    ``write_stat`` time units (:mod:`..utils.navier_io`)."""

    _MEMBERS = (("temp", "t_avg"), ("ux", "ux_avg"), ("uy", "uy_avg"), ("nusselt", "nusselt"))

    def __init__(self, model, save_stat: float, write_stat: float):
        self.save_stat = save_stat
        self.write_stat = write_stat
        self.space = serial_space(model.field_space)
        self.scale = model.scale
        self.params = dict(model.params)
        dtype = self.space.ndarray_spectral().cpu().numpy().dtype
        zeros = np.zeros(self.space.shape_spectral, dtype=dtype)
        self.t_avg = zeros.copy()
        self.ux_avg = zeros.copy()
        self.uy_avg = zeros.copy()
        self.nusselt = zeros.copy()
        self.avg_time = 0.0
        self.tot_time = float(model.time)
        self.num_save = 0
        self._mask = self.space.place_spectral(self.space.dealias_mask(), dtype=model.dtype)

    def _nusselt_field(self, that: torch.Tensor, uyhat: torch.Tensor) -> torch.Tensor:
        """The pointwise Nusselt field ``2 sy (uy T / ka - dT/dy / sy)`` in
        the scratch-ortho space, dealiased (``statistics.rs:246-270``)."""
        sp, scale, ka = self.space, self.scale, self.params["ka"]
        temp_p = sp.backward_ortho(that)
        uy_p = sp.backward_ortho(uyhat)
        dtdz = sp.backward_ortho(sp.gradient(that, (0, 1), None)) / (-scale[1])
        return sp.forward((dtdz + uy_p * temp_p / ka) * 2.0 * scale[1]) * self._mask

    def update(self, model) -> None:
        """Fold the model's current state into the running averages
        (``statistics.rs:84-108``).  A model time before the averages' own
        is refused (printed, and a ``stats_mismatch`` event on the model's
        journal)."""
        time = float(model.time)
        if time < self.tot_time:
            print(f"Statistics time mismatch (navier < stat): {time} < {self.tot_time}")
            report_stats_event(model, {"event": "stats_mismatch", "navier_time": time,
                                       "stat_time": float(self.tot_time)})
            return
        glob = model.field_space.gather_spectral
        that_h = glob(model.temp_space.to_ortho(model.state.temp))
        uxhat = glob(model.velx_space.to_ortho(model.state.velx))
        uyhat = glob(model.vely_space.to_ortho(model.state.vely))
        nu_hat = self._nusselt_field(that_h + glob(model.tempbc_ortho), uyhat)
        w = float(self.num_save)
        for attr, new in (("t_avg", that_h), ("ux_avg", uxhat), ("uy_avg", uyhat),
                          ("nusselt", nu_hat)):
            avg = getattr(self, attr)
            setattr(self, attr, (avg * w + new.detach().cpu().numpy()) / (w + 1.0))
        self.num_save += 1
        self.avg_time += time - self.tot_time
        self.tot_time = time

    def write(self, filename: str) -> None:
        """Write the averages in the reference's layout
        (``statistics.rs:140-158``; needs ``h5py``)."""
        import h5py

        from ..field import grid_deltas
        from ..utils.checkpoint import write_field

        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        sp = self.space
        xs = [b.points * s for b, s in zip(sp.bases, self.scale)]
        dxs = [grid_deltas(b.points, b.is_periodic) * s for b, s in zip(sp.bases, self.scale)]
        with h5py.File(filename, "a") as h5:
            for varname, attr in self._MEMBERS:
                vhat = torch.as_tensor(getattr(self, attr)).to(device=sp.device,
                                                               dtype=sp.spectral_dtype)
                write_field(h5, varname, sp, vhat, xs, dxs)
            for key, value in (("tot_time", self.tot_time), ("avg_time", self.avg_time),
                               ("num_save", float(self.num_save))):
                if key in h5:
                    del h5[key]
                h5.create_dataset(key, data=value)
            for key, value in self.params.items():
                if key in h5:
                    del h5[key]
                h5.create_dataset(key, data=float(value))

    def read(self, filename: str) -> None:
        """Restore the averages and counters (``statistics.rs:119-134``;
        needs ``h5py``)."""
        import h5py

        from ..utils.checkpoint import read_field_vhat

        with h5py.File(filename, "r") as h5:
            for varname, attr in self._MEMBERS:
                setattr(self, attr, read_field_vhat(h5, varname, self.space).astype(
                    getattr(self, attr).dtype))
            self.tot_time = float(np.asarray(h5["tot_time"]))
            self.avg_time = float(np.asarray(h5["avg_time"]))
            self.num_save = int(np.asarray(h5["num_save"]))
        print(f" <== {filename}")

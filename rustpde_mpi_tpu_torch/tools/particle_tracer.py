"""Passive Lagrangian particle tracer (counterpart of the JAX package's
``tools/particle_tracer.py``, the reference's ``particle_tracer`` crate):
a swarm of tracers advanced by RK4 through a static 2-D velocity field,
sampled by bilinear interpolation on the tensor grid; a particle whose
midpoint or endpoint leaves the grid freezes where it is.

The swarm's positions and the velocity fields live in float64 tensors on
the swarm's device (the card unless ``device="cpu"``), and every RK4 stage
is a handful of vectorized tensor operations over all particles.  The
JAX package's vectorized numpy path is the reference it is held against
(its native g++ core is not carried over).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device


def _bilinear(x, y, ux, uy, px, py):
    """Bilinear samples of ``ux``, ``uy`` at ``(px, py)`` (clamped to the
    grid's cells)."""
    i = torch.clamp(torch.searchsorted(x, px, right=True) - 1, 0, x.numel() - 2)
    j = torch.clamp(torch.searchsorted(y, py, right=True) - 1, 0, y.numel() - 2)
    tx = (px - x[i]) / (x[i + 1] - x[i])
    ty = (py - y[j]) / (y[j + 1] - y[j])
    w00 = (1 - tx) * (1 - ty)
    w01 = (1 - tx) * ty
    w10 = tx * (1 - ty)
    w11 = tx * ty

    def samp(f):
        return w00 * f[i, j] + w01 * f[i, j + 1] + w10 * f[i + 1, j] + w11 * f[i + 1, j + 1]

    return samp(ux), samp(uy)


def _inside(x, y, px, py):
    return (px >= x[0]) & (px <= x[-1]) & (py >= y[0]) & (py <= y[-1])


def _advect(x, y, ux, uy, px, py, dt: float, n_steps: int) -> int:
    """``n_steps`` RK4 steps of the positions in place; returns the number
    of frozen particles.  A frozen particle's stages are computed and
    discarded (no host check a step)."""
    alive = _inside(x, y, px, py)
    for _ in range(n_steps):
        cx, cy = px.clone(), py.clone()
        k1x, k1y = _bilinear(x, y, ux, uy, cx, cy)
        mx, my = cx + 0.5 * dt * k1x, cy + 0.5 * dt * k1y
        alive &= _inside(x, y, mx, my)
        k2x, k2y = _bilinear(x, y, ux, uy, mx, my)
        mx, my = cx + 0.5 * dt * k2x, cy + 0.5 * dt * k2y
        alive &= _inside(x, y, mx, my)
        k3x, k3y = _bilinear(x, y, ux, uy, mx, my)
        mx, my = cx + dt * k3x, cy + dt * k3y
        alive &= _inside(x, y, mx, my)
        k4x, k4y = _bilinear(x, y, ux, uy, mx, my)
        nx_ = cx + dt / 6.0 * (k1x + 2 * k2x + 2 * k3x + k4x)
        ny_ = cy + dt / 6.0 * (k1y + 2 * k2y + 2 * k3y + k4y)
        alive &= _inside(x, y, nx_, ny_)
        torch.where(alive, nx_, px, out=px)
        torch.where(alive, ny_, py, out=py)
    return int((~alive).sum())


class ParticleSwarm:
    """A swarm of passive tracers on a 2-D tensor grid (the reference's
    ``ParticleSwarm``): from explicit positions, a random rectangle or a
    file; :meth:`update` advances it through one velocity field,
    :meth:`trace_files` replays a run's snapshots."""

    def __init__(self, positions, x, y, timestep: float, device=None):
        self.device = resolve_device(device)
        kw = dict(dtype=torch.float64, device=self.device)
        self.x = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64), **kw)
        self.y = torch.as_tensor(np.ascontiguousarray(y, dtype=np.float64), **kw)
        positions = np.asarray(positions, dtype=np.float64)
        self.px = torch.as_tensor(np.ascontiguousarray(positions[:, 0]), **kw)
        self.py = torch.as_tensor(np.ascontiguousarray(positions[:, 1]), **kw)
        self.timestep = float(timestep)
        self.time = 0.0
        self.history: list[tuple[float, np.ndarray, np.ndarray]] = []

    @classmethod
    def from_rectangle(cls, x0, y0, range_, n, x, y, timestep, seed: int = 0, device=None):
        """``n`` particles uniform in the square of half-width ``range_``
        around ``(x0, y0)``, drawn by numpy's ``default_rng(seed)`` as the
        JAX package draws them."""
        rng = np.random.default_rng(seed)
        pos = np.stack([x0 + rng.uniform(-range_, range_, n),
                        y0 + rng.uniform(-range_, range_, n)], axis=1)
        return cls(pos, x, y, timestep, device=device)

    @classmethod
    def from_file(cls, fname, x, y, timestep, device=None):
        """Positions from ``time x y`` rows (the :meth:`write` format)."""
        data = np.loadtxt(fname, ndmin=2)
        return cls(data[:, 1:3], x, y, timestep, device=device)

    def positions(self) -> np.ndarray:
        """Host copy of the positions, shape (n, 2)."""
        return torch.stack([self.px, self.py], dim=1).cpu().numpy()

    def _field(self, u) -> torch.Tensor:
        return torch.as_tensor(np.asarray(u) if not torch.is_tensor(u) else u).to(
            device=self.device, dtype=torch.float64)

    def update(self, ux, uy, n_steps: int = 1) -> int:
        """Advance ``n_steps`` RK4 steps through one static velocity field
        (host arrays or tensors of the grid's shape); returns the number of
        frozen (out-of-bounds) particles."""
        ux, uy = self._field(ux), self._field(uy)
        grid = (self.x.numel(), self.y.numel())
        if tuple(ux.shape) != grid or tuple(uy.shape) != grid:
            raise ValueError(f"velocity shapes {tuple(ux.shape)}/{tuple(uy.shape)} != grid {grid}")
        frozen = _advect(self.x, self.y, ux, uy, self.px, self.py, self.timestep, int(n_steps))
        self.time += n_steps * self.timestep
        return frozen

    def sample(self, ux, uy) -> tuple[np.ndarray, np.ndarray]:
        """The velocity at the current positions (0 outside), host arrays."""
        ux, uy = self._field(ux), self._field(uy)
        inside = _inside(self.x, self.y, self.px, self.py)
        su, sv = _bilinear(self.x, self.y, ux, uy, self.px, self.py)
        zero = torch.zeros_like(su)
        return (torch.where(inside, su, zero).cpu().numpy(),
                torch.where(inside, sv, zero).cpu().numpy())

    def record(self) -> None:
        self.history.append((self.time, self.px.cpu().numpy().copy(), self.py.cpu().numpy().copy()))

    def trace_files(self, files, snapshot_dt: float, ux_key="ux/v", uy_key="uy/v",
                    record_every: int = 1) -> None:
        """Replay a run: through each snapshot file's (frozen) velocity
        field advance ``snapshot_dt`` worth of RK4 steps, recording the
        positions every ``record_every`` files (needs ``h5py``)."""
        import h5py

        steps_per_file = max(1, round(snapshot_dt / self.timestep))
        self.record()
        for idx, fname in enumerate(files):
            with h5py.File(fname, "r") as f:
                ux = np.asarray(f[ux_key])
                uy = np.asarray(f[uy_key])
            self.update(ux, uy, steps_per_file)
            if (idx + 1) % record_every == 0:
                self.record()

    def write(self, fname: str) -> None:
        """The current positions, one ``time x y`` row per particle."""
        with open(fname, "w") as f:
            for xp, yp in self.positions():
                f.write(f"{self.time} {xp} {yp}\n")

    def write_history(self, fname: str) -> None:
        """The recorded trajectory: blocks of ``time x y`` per record."""
        with open(fname, "w") as f:
            for t, xs, ys in self.history:
                for xp, yp in zip(xs, ys):
                    f.write(f"{t} {xp} {yp}\n")

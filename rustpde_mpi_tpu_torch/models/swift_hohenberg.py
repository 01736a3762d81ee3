"""Swift-Hohenberg pattern-formation models, 1-D and 2-D periodic
(counterpart of the JAX package's ``models/swift_hohenberg.py``):

    du/dt = [r - (lap + 1)^2] u - u^3

with the reference's IMEX step, the stiff linear operator implicit (a
diagonal in Fourier space, so one elementwise divide) and the cubic term
explicit:

    u_{n+1} = (u_n - dt * F[(F^-1 u_n)^3]) / (1 + dt*((1 - K^2)^2 - r))

with K^2 = (kx/Lx)^2 + (ky/Ly)^2.  A step is transforms on ``torch.fft``
(cuFFT on the card) and elementwise arithmetic: the JAX package runs no
Pallas kernel here, and the port adds no hand-written one.

As in the reference: the 1-D model dealiases the cubic term and does not pin
the mean mode; the 2-D model pins the (0, 0) mode and makes the ky = 0
column (and, for even ny, the Nyquist column) Hermitian in kx every step.

``update_n`` runs the bucket schedule of :func:`..utils.jit.scan_buckets`;
each bucket length is one :class:`.campaign.ChunkRunner` whose variant
steps the spectrum that many times in place, so on the card a bucket is one
replay of one captured CUDA graph.  Every constant the step reads (the
implicit factor, the dealias mask, the conjugate-pair index) is on the
device from construction.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import config
from ..bases import BiPeriodicSpace2, Space1, fourier_r2c
from ..field import grid_deltas
from ..utils.jit import scan_buckets
from .campaign import ChunkRunner


class _SwiftHohenbergBase:
    """Time bookkeeping, the chunked stepping, the diagnostics and the
    reference-layout snapshot shared by the two models.  A subclass sets
    ``space``, ``x``, ``theta`` and ``_norm_len`` and supplies
    :meth:`_step`."""

    def __init__(self, r: float, dt: float, device, dtype):
        self.r = float(r)
        self.dt = float(dt)
        self.time = 0.0
        self.write_intervall: float | None = None
        self.device = config.resolve_device(device)
        self.dtype = config.check_dtype(dtype)
        #: chunk runners by bucket length
        self._runners: dict = {}

    def _real(self, values) -> torch.Tensor:
        return config.to_device(values, self.device, self.dtype)

    def _step(self, theta: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _advance(self, n: int, carry) -> None:
        """``n`` steps of the spectrum ``carry[0]``, in place."""
        theta = carry[0]
        for _ in range(n):
            theta = self._step(theta)
        carry[0].copy_(theta)

    def chunk_runner(self, n: int) -> ChunkRunner:
        """The runner of an ``n``-step bucket, built (and on the card
        warmed up and captured) at the first call."""
        runner = self._runners.get(n)
        if runner is None:
            runner = ChunkRunner(lambda carry: self._advance(n, carry), [self.theta.clone()], [])
            self._runners[n] = runner
        return runner

    def update(self) -> None:
        """One step, eagerly."""
        self.theta = self._step(self.theta)
        self.time += self.dt

    def update_n(self, n: int) -> None:
        """``n`` steps in the bucket schedule, one chunk replay a bucket."""
        for bucket in scan_buckets(n):
            runner = self.chunk_runner(bucket)
            runner.carry[0].copy_(self.theta)
            runner.run(1)
            self.theta = runner.carry[0].clone()
        self.time += n * self.dt

    def get_time(self) -> float:
        return self.time

    def get_dt(self) -> float:
        return self.dt

    def set_theta(self, values) -> None:
        """The spectrum of physical host values."""
        self.theta = self.space.forward(self._real(values))

    def theta_physical(self) -> np.ndarray:
        return self.space.backward(self.theta).cpu().numpy()

    def norm(self) -> float:
        """|F|: the coefficients' L2 norm over the complex mode count (the
        reference's ``norm_l2_c64`` diagnostic)."""
        return float(torch.sqrt(torch.sum(torch.abs(self.theta) ** 2))) / self._norm_len

    def exit(self) -> bool:
        return bool(torch.isnan(self.theta).any())

    def callback(self) -> None:
        print(f"Time = {self.time:6.2e}")
        os.makedirs("data", exist_ok=True)
        self.write(f"data/flow{self.time:0>8.2f}.h5")
        print(f"|F| = {self.norm():6.2e}")

    def write(self, filename: str) -> None:
        """Snapshot in the reference layout: ``temp/{v, vhat_re, vhat_im, x,
        dx[, y, dy]}`` and the scalars ``time``, ``dt``, ``r`` (needs
        ``h5py``)."""
        try:
            self._write(filename)
            print(f" ==> {filename}")
        except OSError as exc:
            print(f"Error while writing file {filename}: {exc}")

    def _write(self, filename: str) -> None:
        import h5py

        with h5py.File(filename, "w") as f:
            g = f.create_group("temp")
            g.create_dataset("v", data=self.theta_physical())
            vc = self.space.vhat_as_complex(self.theta)
            g.create_dataset("vhat_re", data=vc.real)
            g.create_dataset("vhat_im", data=vc.imag)
            for name, arr in zip(("x", "y"), self.x):
                g.create_dataset(name, data=arr)
                g.create_dataset("d" + name, data=grid_deltas(arr, True))
            f.create_dataset("time", data=self.time)
            f.create_dataset("dt", data=self.dt)
            f.create_dataset("r", data=self.r)

    def read(self, filename: str) -> None:
        """Restore the spectrum and the time from a snapshot of either
        package (``vhat_re``/``vhat_im``, or a complex ``vhat``)."""
        import h5py

        with h5py.File(filename, "r") as f:
            g = f["temp"]
            if "vhat_re" in g:
                vhat_c = np.asarray(g["vhat_re"]) + 1j * np.asarray(g["vhat_im"])
            else:
                vhat_c = np.asarray(g["vhat"])
            self.theta = self.space.vhat_from_complex(vhat_c)
            self.time = float(np.asarray(f["time"]))


class SwiftHohenberg1D(_SwiftHohenbergBase):
    """1-D Swift-Hohenberg on a periodic domain of length ``2*pi*length``
    (the reference's ``swift_hohenberg_1d`` example)."""

    def __init__(self, nx: int, r: float, dt: float, length: float, *, device=None,
                 dtype=config.DEFAULT_DTYPE):
        super().__init__(r, dt, device, dtype)
        self.nx = int(nx)
        self.space = Space1(fourier_r2c(self.nx), device=self.device, dtype=self.dtype)
        self.scale = (float(length),)
        self.x = [self.space.base.points * length]
        k = self.space.base.wavenumbers / length
        self._matl = self._real(1.0 + dt * ((1.0 - k**2) ** 2 - r))
        self._dealias = self._real(self.space.dealias_mask())
        self._norm_len = self.space.base.m
        self.theta = self.space.ndarray_spectral()
        self.init_cos(1e-5)

    def init_cos(self, c: float) -> None:
        """One cosine over the domain span (the reference's ``init_cos``)."""
        x = self.x[0]
        span = x[-1] - x[0]
        self.set_theta(c * np.cos((x - x[0]) / span * 2.0 * np.pi))

    def init_random(self, c: float, seed: int = 0) -> None:
        """Uniform noise in ``[-c, c)`` from numpy's ``default_rng(seed)``."""
        self.set_theta(np.random.default_rng(seed).uniform(-c, c, size=self.nx))

    def _step(self, theta: torch.Tensor) -> torch.Tensor:
        v = self.space.backward(theta)
        cubic = self.space.forward(v * v * v) * self._dealias
        return (theta - self.dt * cubic) / self._matl


class SwiftHohenberg2D(_SwiftHohenbergBase):
    """2-D Swift-Hohenberg on a doubly periodic square of side
    ``2*pi*length`` (the reference's ``swift_hohenberg_2d`` example; the
    JAX benchmark's ``sh2048`` at 2048^2)."""

    def __init__(self, nx: int, ny: int, r: float, dt: float, length: float, *, device=None,
                 dtype=config.DEFAULT_DTYPE):
        super().__init__(r, dt, device, dtype)
        self.nx, self.ny = int(nx), int(ny)
        self.space = BiPeriodicSpace2(self.nx, self.ny, device=self.device, dtype=self.dtype)
        self.scale = (float(length), float(length))
        self.x = [p * length for p in self.space.coords()]
        kx, ky = self.space.kx / length, self.space.ky / length
        k2 = kx[:, None] ** 2 + ky[None, :] ** 2
        self._matl = self._real(1.0 + dt * ((1.0 - k2) ** 2 - r))
        self._norm_len = self.nx * self.space.my
        self.theta = self.space.ndarray_spectral()
        self.init_random(1e-1)

    def init_random(self, c: float, seed: int = 0) -> None:
        """Uniform noise in ``[-c, c)`` from numpy's ``default_rng(seed)``."""
        self.set_theta(np.random.default_rng(seed).uniform(-c, c, size=(self.nx, self.ny)))

    def init_cos(self, c: float, kx: float, ky: float) -> None:
        x, y = self.x
        sx, sy = x[-1] - x[0], y[-1] - y[0]
        self.set_theta(c * np.cos((x[:, None] - x[0]) / sx * kx * np.pi)
                       * np.cos((y[None, :] - y[0]) / sy * ky * np.pi))

    def _step(self, theta: torch.Tensor) -> torch.Tensor:
        space = self.space
        v = space.backward(theta)
        out = (theta - self.dt * space.forward(v * v * v)) / self._matl
        return space.enforce_hermitian_x(space.pin_zero_mode(out))

    def pattern_energy(self) -> float:
        """The domain average of theta^2 (the ``sh2048`` benchmark's
        pattern-amplitude trace)."""
        v = self.space.backward(self.theta)
        return float(torch.mean(v * v))

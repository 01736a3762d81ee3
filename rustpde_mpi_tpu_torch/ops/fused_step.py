"""The implicit half of the Navier step as fused stages, on a CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_step.py``.  One generic
stage computes

    o = mask * B0 @ ((sum_t L_t @ x_t @ R_t^T) * dinv @ B1^T + const)

with every bracketed piece optional, and the confined Rayleigh-Benard step
runs seven instances of it: ``velx``/``vely``/``temp`` (Helmholtz solves
with the inverse folded into the term matrices), ``div``, ``poisson``
(fast-diagonal solve with the singular-mode pin as the output mask),
``projx``/``projy`` (the pressure-gradient correction).  A passive-scalar
scenario adds an eighth, ``scal``; with Coriolis each velocity stage takes
the cross velocity as one more term, so ``vely`` sums five products, the
most one output of the kernel sums (``_build.MAX_TERMS``).

On a periodic space the stage's inputs and output are complex: each
complex input goes to the kernel as its ``[Re; Im]`` real rows (one
row-aligned copy, ``_build.stack_planes``), the x-axis factors are the
split Re/Im matrices of the JAX builder (diagonals and 2x2-block
rotations, multiplied as dense products, as the TPU kernel does), and the
output's two halves are put back together as the complex result (one
copy), as the JAX wrapper does (``pallas_step.py:505-509``).  The pressure Poisson stage of a
Fourier x axis has no left factor (the Fourier modes are already modal):
its kernel launches skip the ``L @ x`` product.

The inputs may carry a leading member dim (an ensemble of K states of one
model, :mod:`..models.ensemble`): the stage then runs for every member with
the constants shared, each launch of the kernel serving all K members (the
JAX package's ``jax.vmap`` over ``pallas_call``), and the ``[Re; Im]``
stacking is one copy for all members.

On a CUDA tensor :meth:`FusedStage.apply` runs the hand-written kernel of
``csrc/fused_stage.cu`` as 2-4 launches (see that file for the design) and
adds one to ``FusedStage.launches``; on a CPU tensor it runs
:meth:`FusedStage.plain`, the same chain in ``torch.matmul``.  Any other
device raises.  The operator constants and the kernel's scratch keep their
rows on 16-byte boundaries (``_build.padded``), so the kernel copies them
16 bytes at a time; the inputs and the output are plain contiguous
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import to_device
from . import _build


class StageTerm(NamedTuple):
    """One ``L @ x @ R^T`` term of a fused stage (host f64 matrices).  ``l``
    may be None for a single-term stage whose input is already in the
    stage's row space (the periodic Poisson stage)."""

    l: np.ndarray | None
    r: np.ndarray


class FusedStage:
    """One fused step stage on ``device`` in ``dtype``: ``apply(*xs) ==
    sum_t L_t @ xs[t] @ R_t^T [* dinv] [@ B1^T] [+ const]``, then ``B0 @ .``
    and ``* mask`` when given.  ``modal=(dinv, b0, b1)`` is the fast-diag
    solve; ``const`` and ``modal`` exclude each other, as in the JAX
    package.  ``complex_io``: the inputs and the output are complex (a
    periodic space), stacked to ``[Re; Im]`` rows for the kernel."""

    def __init__(self, name, terms, *, device, dtype, const=None, modal=None,
                 mask=None, complex_io=False):
        self.name = name
        self.terms = list(terms)
        if not 1 <= len(self.terms) <= _build.MAX_TERMS:
            raise ValueError(f"a fused stage takes 1..{_build.MAX_TERMS} terms")
        dinv = b0 = b1 = None
        if modal is not None:
            dinv, b0, b1 = modal
            if const is not None:
                raise ValueError("const is a post-solve fold; modal stages "
                                 "carry their lift in the rhs terms instead")
        #: the terms carry their left factor (False: the L-less stage)
        self.has_l = self.terms[0].l is not None
        if any((t.l is None) == self.has_l for t in self.terms):
            raise ValueError("terms must uniformly carry or omit L matrices")
        if not self.has_l and (len(self.terms) != 1 or dinv is None):
            raise ValueError("an L-less stage is one term of a modal solve")
        self.complex_io = bool(complex_io)
        self.r0 = int(self.terms[0].l.shape[0]) if self.has_l else int(dinv.shape[0])
        self.q1 = int(self.terms[0].r.shape[0])
        if any(self.has_l and t.l.shape[0] != self.r0 or t.r.shape[0] != self.q1
               for t in self.terms):
            raise ValueError("stage terms must share their output rows and columns")
        self.k0 = [int(t.l.shape[1]) if self.has_l else self.r0 for t in self.terms]
        self.k1 = [int(t.r.shape[1]) for t in self.terms]
        self.p0 = int(b0.shape[0]) if b0 is not None else self.r0
        self.p1 = int(b1.shape[0]) if b1 is not None else self.q1
        self.device = torch.device(device)
        self.dtype = dtype

        def put(m):
            return None if m is None else _build.aligned(to_device(m, self.device, dtype))

        self.ls = [put(t.l) for t in self.terms] if self.has_l else []
        self.rts = [put(t.r.T) for t in self.terms]
        self.const = put(const)
        self.dinv = put(dinv)
        self.b1t = put(None if b1 is None else b1.T)
        self.b0 = put(b0)
        self.mask = put(mask)
        #: kernel applications on CUDA tensors (each is 2-4 grid launches)
        self.launches = 0

    # -- accounting -------------------------------------------------------

    @property
    def flops(self) -> float:
        """Multiply-add flops (2 per FMA) of one application."""
        return self.cost()[0]

    @property
    def bytes_moved(self) -> float:
        """Bytes one application must move at least: every operand (matrix
        constants and inputs) read once, the output written once."""
        return self.cost()[1]

    def cost(self, members: int = 1) -> tuple[float, float]:
        """``(flops, bytes)`` of one application to ``members`` members:
        each member's products, the matrix constants read once, each
        member's inputs read once and its output written once."""
        f = 0.0
        for k0, k1 in zip(self.k0, self.k1):
            if self.has_l:
                f += 2.0 * self.r0 * k0 * k1
            f += 2.0 * self.r0 * k1 * self.q1
        if self.b1t is not None:
            f += 2.0 * self.r0 * self.q1 * self.p1
        if self.b0 is not None:
            f += 2.0 * self.p0 * self.r0 * self.p1
        n = sum(x.numel() for x in self.ls + self.rts)
        for extra in (self.const, self.dinv, self.b1t, self.b0, self.mask):
            if extra is not None:
                n += extra.numel()
        n += members * sum(k0 * k1 for k0, k1 in zip(self.k0, self.k1))
        n += members * self.p0 * self.p1
        return members * f, float(n) * torch.finfo(self.dtype).bits / 8

    # -- the stage --------------------------------------------------------

    @property
    def io_dtype(self) -> torch.dtype:
        """The dtype of the inputs and the output."""
        if not self.complex_io:
            return self.dtype
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64

    def _check(self, xs) -> tuple:
        """Validate the inputs; returns their leading member shape (``()``
        for one state, ``(K,)`` for K members)."""
        if len(xs) != len(self.terms):
            raise ValueError(f"stage {self.name!r} takes {len(self.terms)} inputs, got {len(xs)}")
        lead = tuple(xs[0].shape[:-2])
        if len(lead) > 1:
            raise ValueError(f"stage {self.name!r}: inputs carry at most one member dim, got "
                             f"shape {tuple(xs[0].shape)}")
        for t, x in enumerate(xs):
            if x.device != self.device or x.dtype != self.io_dtype:
                raise ValueError(
                    f"stage {self.name!r} input {t}: {x.dtype} on {x.device}, "
                    f"expected {self.io_dtype} on {self.device}")
            rows = self.k0[t] // 2 if self.complex_io else self.k0[t]
            if tuple(x.shape) != lead + (rows, self.k1[t]):
                raise ValueError(
                    f"stage {self.name!r} input {t}: shape {tuple(x.shape)}, "
                    f"expected {lead + (rows, self.k1[t])}")
        return lead

    def _stack(self, x) -> torch.Tensor:
        """The kernel's real input: ``x`` itself, or a complex one's ``[Re;
        Im]`` rows in one row-aligned copy (for all members at once)."""
        return _build.stack_planes(x) if self.complex_io else x.contiguous()

    def _unstack(self, o) -> torch.Tensor:
        """The output from the kernel's real one (a complex output's Re rows
        then Im rows)."""
        return _build.unstack_planes(o) if self.complex_io else o

    def apply(self, *xs) -> torch.Tensor:
        """The stage: the CUDA kernel on a CUDA device, the plain chain on
        the CPU.  Inputs of shape ``(K, rows, cols)`` run K members, every
        kernel launch serving all of them."""
        lead = self._check(xs)
        if self.device.type == "cpu":
            return self.plain(*xs)
        if self.device.type != "cuda":
            raise RuntimeError(f"no fused-stage kernel for device {self.device}")
        out = self._unstack(self._launch([self._stack(x) for x in xs], lead))
        self.launches += 1
        return out

    def plain(self, *xs) -> torch.Tensor:
        """The same chain in plain ``torch.matmul`` (the CPU path and the
        kernel's yardstick in the tests and the chip smoke run)."""
        m = None
        for t, (rt, x) in enumerate(zip(self.rts, xs)):
            x = self._stack(x)
            y = torch.matmul(torch.matmul(self.ls[t], x) if self.has_l else x, rt)
            m = y if m is None else m + y
        if self.dinv is not None:
            m = m * self.dinv
        if self.b1t is not None:
            m = torch.matmul(m, self.b1t)
        if self.const is not None:
            m = m + self.const
        if self.b0 is not None:
            m = torch.matmul(self.b0, m)
        if self.mask is not None:
            m = m * self.mask
        return self._unstack(m)

    def _launch(self, xs, lead=()) -> torch.Tensor:
        """The stage's 2-4 grid launches on real operands; ``lead`` is
        ``(K,)`` for K members (every scratch and the output then carry the
        member dim, the constants do not)."""
        fn = _build.gemm(self.dtype)
        kw = dict(device=self.device, dtype=self.dtype)
        r0, q1 = self.r0, self.q1
        k = lead[0] if lead else 1
        dev = self.device
        # 1. Y_t = L_t @ x_t, every term in one grid (an L-less stage takes
        # its input as Y)
        ys = xs
        if self.has_l:
            ys = [_build.padded(*lead, r0, k1, **kw) for k1 in self.k1]
            _build.launch_jobs(fn, [
                _build.job(y, [(l, x)], M=r0, N=y.shape[-1], members=k)
                for y, l, x in zip(ys, self.ls, xs)
            ], dev, k)
        # 2. M = sum_t Y_t @ R_t^T, with the elementwise epilogue; the mask
        # lands here unless a backward map follows
        last2 = self.b1t is None and self.b0 is None
        m = torch.empty((*lead, r0, q1), **kw) if last2 else _build.padded(*lead, r0, q1, **kw)
        _build.launch_jobs(fn, [_build.job(
            m, list(zip(ys, self.rts)), M=r0, N=q1, E=self.dinv, F=self.const,
            mask=self.mask if last2 else None, members=k)], dev, k)
        # 3. M @ B1^T
        if self.b1t is not None:
            m2 = torch.empty((*lead, r0, self.p1), **kw) if self.b0 is None else \
                _build.padded(*lead, r0, self.p1, **kw)
            _build.launch_jobs(fn, [_build.job(
                m2, [(m, self.b1t)], M=r0, N=self.p1,
                mask=self.mask if self.b0 is None else None, members=k)], dev, k)
            m = m2
        # 4. B0 @ M * mask
        if self.b0 is not None:
            o = torch.empty((*lead, self.p0, self.p1), **kw)
            _build.launch_jobs(fn, [_build.job(
                o, [(self.b0, m)], M=self.p0, N=self.p1, mask=self.mask, members=k)], dev, k)
            m = o
        return m


# -- model builder --------------------------------------------------------------


def _stack_host(arr) -> np.ndarray:
    """A host array as the kernels' real rows: a complex one's ``[Re;
    Im]``."""
    a = np.asarray(arr)
    return np.concatenate([a.real, a.imag], axis=0) if np.iscomplexobj(a) else a


def build_model_step(model) -> dict:
    """The fused stages of a Navier2D model, keyed by stage tag: ``velx``
    (inputs: velx, pres, conv[, vely]), ``vely`` (vely, pres, temp,
    conv[, velx]; the cross velocity when the scenario has Coriolis),
    ``temp`` (temp, conv), ``scal`` (scal, conv; a passive-scalar scenario
    only), ``div`` (velx_n, vely_n), ``poisson`` (div), ``projx``/``projy``
    (pseu_n).  All host matrices are built in numpy f64 from the same math
    as the JAX package's builder, a Fourier x axis in its split Re/Im form
    (``pallas_step.py:427-443, 505-509, 578-619, 629-659``)."""
    from .. import solver as slv

    sp_u, sp_t = model.velx_space, model.temp_space
    sp_p, sp_q = model.pres_space, model.pseu_space
    dt = model.dt
    nu, ka = model.params["nu"], model.params["ka"]
    scale = model.scale
    sx2, sy2 = scale[0] ** 2, scale[1] ** 2

    def nat(space, axis, key):
        return space.bases[axis].axis_operator(key).matrix

    A0u = slv.hholtz_axis_solve_matrix(sp_u, 0, dt * nu / sx2)
    A1u = slv.hholtz_axis_solve_matrix(sp_u, 1, dt * nu / sy2)
    A0t = slv.hholtz_axis_solve_matrix(sp_t, 0, dt * ka / sx2)
    A1t = slv.hholtz_axis_solve_matrix(sp_t, 1, dt * ka / sy2)

    st0u, st1u = nat(sp_u, 0, "stencil"), nat(sp_u, 1, "stencil")
    st0p, st1p = nat(sp_p, 0, "stencil"), nat(sp_p, 1, "stencil")
    st0t, st1t = nat(sp_t, 0, "stencil"), nat(sp_t, 1, "stencil")
    st0q, st1q = nat(sp_q, 0, "stencil"), nat(sp_q, 1, "stencil")
    g1p0, g1p1 = nat(sp_p, 0, ("grad", 1)), nat(sp_p, 1, ("grad", 1))
    g1u0, g1u1 = nat(sp_u, 0, ("grad", 1)), nat(sp_u, 1, ("grad", 1))
    g1q0, g1q1 = nat(sp_q, 0, ("grad", 1)), nat(sp_q, 1, ("grad", 1))
    p0u, p1u = nat(sp_u, 0, "proj"), nat(sp_u, 1, "proj")

    def lift_const(L, R, arr, factor):
        """Post-solve BC-lift fold: ``A (rhs + c*lift) == A rhs + c * A lift
        A^T`` baked on the host."""
        return factor * (L @ _stack_host(arr) @ R.T)

    cplx = sp_u.spectral_is_complex
    kw = dict(device=model.device, dtype=model.dtype, complex_io=cplx)
    nx, ny = model.nx, model.ny
    T = StageTerm
    # velocity stages: state + pressure gradient + convection (+ buoyancy,
    # +/- the Coriolis cross velocity: five products in vely), the
    # Helmholtz inverse folded into L and R
    terms_vx = [
        T(A0u @ st0u, A1u @ st1u),
        T((-dt / scale[0]) * (A0u @ g1p0), A1u @ st1p),
        T(-dt * A0u, A1u),
    ]
    terms_vy = [
        T(A0u @ st0u, A1u @ st1u),
        T((-dt / scale[1]) * (A0u @ st0p), A1u @ g1p1),
        T(dt * (A0u @ st0t), A1u @ st1t),
        T(-dt * A0u, A1u),
    ]
    coriolis = model._coriolis()
    if coriolis:
        terms_vx.append(T(dt * coriolis * (A0u @ st0u), A1u @ st1u))
        terms_vy.append(T(-dt * coriolis * (A0u @ st0u), A1u @ st1u))
    stages = {
        "velx": FusedStage(f"velx_{nx}x{ny}", terms_vx, **kw),
        "vely": FusedStage(f"vely_{nx}x{ny}", terms_vy,
                           const=lift_const(A0u, A1u, model.host_bc["ortho"], dt), **kw),
        "temp": FusedStage(f"temp_{nx}x{ny}", [
            T(A0t @ st0t, A1t @ st1t),
            T(-dt * A0t, A1t),
        ], const=lift_const(A0t, A1t, model.host_bc["diff"], 1.0), **kw),
    }
    if model._scalar_active():
        # the passive scalar: the temperature's stage at the scalar
        # diffusivity, its lift scaled by kc/ka
        kc = model._scalar_kappa()
        A0c = slv.hholtz_axis_solve_matrix(sp_t, 0, dt * kc / sx2)
        A1c = slv.hholtz_axis_solve_matrix(sp_t, 1, dt * kc / sy2)
        stages["scal"] = FusedStage(f"scal_{nx}x{ny}", [
            T(A0c @ st0t, A1c @ st1t),
            T(-dt * A0c, A1c),
        ], const=lift_const(A0c, A1c, model.host_bc["diff"], kc / ka), **kw)
    stages["div"] = FusedStage(f"div_{nx}x{ny}", [
        T(g1u0 / scale[0], st1u),
        T(st0u, g1u1 / scale[1]),
    ], **kw)

    # pressure Poisson: fast-diag modal solve, singular pin as output mask;
    # a Fourier x axis is already modal (no left factor, no B0), its k=0
    # mode pinned in both the Re and the Im row
    lam0, f0, b0m = slv.modal_data_split(sp_q, 0, 1.0 / sx2, 1.0)
    lam1, f1, b1m = slv.modal_data_split(sp_q, 1, 1.0 / sy2, 1.0)
    if abs(lam0[0]) < 1e-10:
        lam0 = lam0 - 1e-10  # singular-mode nudge, as the JAX FastDiag
    dinv = 1.0 / (lam0[:, None] + lam1[None, :])
    pin = np.ones((len(lam0), b1m.shape[0]))
    pin[0, 0] = 0.0
    if sp_q.bases[0].is_periodic:
        pin[len(lam0) // 2, 0] = 0.0  # the Im row of the k=0 mode
    stages["poisson"] = FusedStage(f"poisson_{nx}x{ny}", [T(f0, f1)],
                                   modal=(dinv, b0m, b1m), mask=pin, **kw)

    # pressure-gradient projection (subtracted from the velocities outside)
    stages["projx"] = FusedStage(
        f"projx_{nx}x{ny}", [T((p0u @ g1q0) / scale[0], p1u @ st1q)], **kw)
    stages["projy"] = FusedStage(
        f"projy_{nx}x{ny}", [T(p0u @ st0q, (p1u @ g1q1) / scale[1])], **kw)
    return stages

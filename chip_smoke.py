#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rustpde_mpi_tpu_torch/csrc`` with
``nvcc`` (sm_90a) and then, raising on the first failure, drives the fused
route of the step (``Navier2D``'s default) in phases 1-5 and the dense
route (``step_kernel="dense", conv_kernel="dense"``, the JAX package's
default step on its solver objects) in phases 6-11:

1. holds every fused kernel against its plain PyTorch version on the card:
   every stage instance and both convection variants at 129^2 and 1025^2
   in f64 (limit 1e-12 of max|plain|) and at 129^2 in f32 (limit 1e-4),
   and times the kernel, the plain version and the chain in the fewest
   cuBLAS calls PyTorch offers (``library_ms``) at 1025^2 f64;
2. reruns the head of the f64 golden Nusselt trajectory of PARITY.json at
   129^2 through the kernels (rel 1e-6);
3. steps the same 129^2 model 10 steps on the card and on the CPU (plain
   versions) and compares the states (rel 1e-11);
4. drives the main path, the ``rbc1025`` configuration (1025^2, Ra=1e9,
   Pr=1, dt=1e-4, f64), for 50 steps through ``integrate`` (two save
   windows, each one ``Navier2D.update_n``), checks that every step
   launched 3 fused convection chains and 7 fused stages, then times 50
   more steps of bare ``update_n`` (ms/step) and checks the observables;
5. profiles 5 more steps (device time by kernel, device busy share);
6. holds the banded-substitution kernel against its plain version: every
   banded solve the dense step builds (ADI axes 0 and 1 with one factor
   set, the Poisson tensor solver's per-lane factors along axis 1, and the
   same factors along axis 0) at 129^2 (f64, f32) and 1025^2 (f64), same
   limits as phase 1 but relative to each lane's own scale, and times
   kernel, plain version and one ``torch.matmul`` with precomputed inverses
   (``library_ms``: the axis's dense inverse for one factor set, the batch
   of every lane's inverse for per-lane factors) at 1025^2 f64;
7. checks the confined manufactured solutions of the JAX package's
   ``examples/solve_hholtz.py`` (HholtzAdi, 257^2) and
   ``examples/solve_poisson.py`` (Poisson, Hholtz c=0.1, 65^2) on the card,
   with methods banded and dense/fd (tol 1e-6);
8. reruns the golden head of phase 2 on the dense route;
9. compares card and CPU after 10 dense-route steps at 129^2 (rel 1e-11);
10. drives ``rbc1025`` on the dense route as phase 4 does (exactly 7 banded
    launches a step) and profiles it as phase 5 does;
11. times one ``HholtzAdi.solve`` and one ``Poisson.solve`` at the
    ``rbc1025`` shapes with the banded recurrence and with dense/fd.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line
and, as its last line, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): FP64
#: with tensor cores, FP32 without them (TF32 is off), HBM3 bandwidth
F64_TFLOPS = 67.0
F32_TFLOPS = 67.0
HBM_TB_PER_S = 3.35

RBC1025 = dict(nx=1025, ny=1025, ra=1e9, pr=1.0, dt=1e-4, aspect=1.0, bc="rbc")
MAIN_STEPS = 50
STAGE_TAGS = ("velx", "vely", "temp", "div", "poisson", "projx", "projy")
DENSE = dict(step_kernel="dense", conv_kernel="dense")
#: kernel launches a step of each route
PER_STEP = {"fused": {"fused_conv": 3, "fused_stage": 7}, "dense": {"banded_solve": 7}}
#: how far a banded case's library yardstick may stray from the kernel,
#: relative to each lane's scale: a product with a precomputed inverse
#: rounds otherwise than the substitution, more so as n grows
LIBRARY_LIMIT = 1e-8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(torch, a, b) -> tuple[float, float]:
    diff = float(torch.max(torch.abs(a - b)))
    scale = float(torch.max(torch.abs(b)))
    if not (math.isfinite(diff) and math.isfinite(scale)):
        raise AssertionError("non-finite kernel or plain output")
    return diff, diff / scale if scale else diff


def lane_rel_err(torch, a, b, axis) -> tuple[float, float]:
    """Max abs diff, and the max over lanes of the diff relative to that
    lane's max|b| along the solve ``axis``: the per-lane systems differ in
    scale by many orders (the Poisson solver's nudged singular lane), and a
    global scale would hide the small lanes."""
    diff, _ = rel_err(torch, a, b)
    scale = torch.amax(torch.abs(b), dim=axis, keepdim=True)
    rel = torch.abs(a - b) / torch.where(scale > 0, scale, torch.ones_like(scale))
    return diff, float(torch.max(rel))


# -- library yardsticks (timed here only; the port never calls them) ---------


def stage_library(torch, st, xs):
    m = sum(torch.linalg.multi_dot([l, x, rt]) for l, x, rt in zip(st.ls, xs, st.rts))
    if st.dinv is not None:
        m = m * st.dinv
    if st.b1t is not None:
        m = torch.linalg.multi_dot([st.b0, m, st.b1t]) if st.b0 is not None else m @ st.b1t
    if st.const is not None:
        m = m + st.const
    if st.mask is not None:
        m = m * st.mask
    return m


def conv_library(torch, fc, ux, uy, vhat, bcdx=None, bcdy=None):
    gx = torch.stack([fc.gx1, fc.gx0])
    gy = torch.stack([fc.gy0t, fc.gy1t])
    d = torch.matmul(torch.matmul(gx, vhat), gy)
    if bcdx is not None:
        d = d + torch.stack([bcdx, bcdy])
    total = ux * d[0] + uy * d[1]
    out = torch.zeros(fc.out_shape, device=fc.device, dtype=fc.dtype)
    out[: fc.kx, : fc.ky] = torch.linalg.multi_dot([fc.fx, total, fc.fyt])
    return out


# -- phases -------------------------------------------------------------------


def kernel_cases(torch, model, rng):
    """``(kernel, label, run_kernel, run_plain, run_library, flops, bytes)``
    for every stage instance and both conv variants of ``model``, on random
    inputs made from ``rng``."""

    def rand(shape):
        return torch.as_tensor(rng.uniform(-1.0, 1.0, size=shape), dtype=model.dtype).to(model.device)

    cases = []
    for tag in STAGE_TAGS:
        st = model._stages[tag]
        xs = [rand((k0, k1)) for k0, k1 in zip(st.k0, st.k1)]
        cases.append(("fused_stage", tag, lambda st=st, xs=xs: st.apply(*xs),
                      lambda st=st, xs=xs: st.plain(*xs),
                      lambda st=st, xs=xs: stage_library(torch, st, xs),
                      st.flops, st.bytes_moved))
    fc_u = model._convs[id(model.velx_space)]
    fc_t = model._convs[id(model.temp_space)]
    n = (model.nx, model.ny)
    for label, fc, with_bc in (("conv", fc_u, False), ("conv_bc", fc_t, True)):
        args = [rand(n), rand(n), rand((fc.mx, fc.my))]
        if with_bc:
            args += [rand(n), rand(n)]
        cases.append(("fused_conv", label, lambda fc=fc, a=args: fc.apply(*a),
                      lambda fc=fc, a=args: fc.plain(*a),
                      lambda fc=fc, a=args: conv_library(torch, fc, *a),
                      fc.flops, fc.bytes_moved(with_bc)))
    return cases


def phase_kernels(torch, model, limit, timing):
    """Phase 1 at one model size/dtype; returns per-case records."""
    import numpy as np

    rng = np.random.default_rng(1)
    records = []
    f64 = model.dtype == torch.float64
    peak = (F64_TFLOPS if f64 else F32_TFLOPS) * 1e12
    for kernel, label, run_k, run_p, run_l, flops, nbytes in kernel_cases(torch, model, rng):
        out_k = run_k()
        torch.cuda.synchronize()
        out_p = run_p()
        diff, rel = rel_err(torch, out_k, out_p)
        rec = {"kernel": kernel, "case": label, "n": model.nx,
               "per_step": {"conv": 2, "conv_bc": 1}.get(label, 1),
               "dtype": str(model.dtype).replace("torch.", ""),
               "max_abs_err": diff, "max_rel_err": rel}
        if timing:
            t_op = flops / peak * 1e3
            t_mem = nbytes / (HBM_TB_PER_S * 1e12) * 1e3
            rec.update(kernel_ms=time_ms(torch, run_k, 10), plain_ms=time_ms(torch, run_p, 10),
                       library_ms=time_ms(torch, run_l, 10), flops=flops, bytes=nbytes,
                       bound_ms=max(t_op, t_mem),
                       bound_by="operations" if t_op >= t_mem else "bytes")
        print("phase1 " + json.dumps(rec))
        if not rel <= limit:
            raise AssertionError(f"{kernel}/{label} at {model.nx}^2: rel err {rel:.3e} > {limit:g}")
        records.append(rec)
    return records


def phase_golden(pt, phase="phase2", **route):
    with open(os.path.join(ROOT, "PARITY.json"), encoding="utf-8") as fh:
        gold = json.load(fh)
    cfg = gold["config"]
    model = pt.Navier2D(cfg["nx"], cfg["ny"], cfg["ra"], cfg["pr"], cfg["dt"],
                        cfg["aspect"], cfg["bc"], device="cuda", **route)
    model.init_random(cfg["amp"], seed=0)
    worst = 0.0
    for row in gold["nu_f64"][:4]:
        model.update_n(cfg["sample_every"])
        vals = dict(zip(("nu", "nuvol", "re"), model.get_observables()[:3]))
        if abs(model.time - row["time"]) > 1e-9:
            raise AssertionError(f"time {model.time} != {row['time']}")
        for key, val in vals.items():
            rel = abs(val / row[key] - 1.0)
            worst = max(worst, rel)
            if not rel <= 1e-6:
                raise AssertionError(f"golden {key} at t={row['time']}: {val} vs {row[key]}")
    if not all(k.launches for ks in model.kernels().values() for k in ks):
        raise AssertionError("the golden run did not launch every kernel")
    print(f"{phase} golden 129^2 f64 200 steps {route or 'fused'}: max rel dev {worst:.3e} "
          "(limit 1e-6)")


def phase_card_vs_cpu(pt, phase="phase3", **route):
    models = {}
    for dev in ("cuda", "cpu"):
        m = pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", device=dev, **route)
        m.init_random(0.1, seed=0)
        m.update_n(10)
        models[dev] = pt.convert.state_to_numpy(m)
    worst = 0.0
    for name, ref in models["cpu"].items():
        rel = float(abs(models["cuda"][name] - ref).max() / max(abs(ref).max(), 1e-300))
        worst = max(worst, rel)
        if not rel <= 1e-11:
            raise AssertionError(f"card vs cpu {name}: rel {rel:.3e} > 1e-11")
    print(f"{phase} card vs cpu 129^2 f64 10 steps {route or 'fused'}: max rel diff "
          f"{worst:.3e} (limit 1e-11)")


def reset_counts(model):
    for ks in model.kernels().values():
        for k in ks:
            k.launches = 0


def count_launches(model) -> dict:
    return {name: sum(k.launches for k in ks) for name, ks in model.kernels().items()}


def phase_main(torch, pt, model, phase="phase4"):
    """The main path as a user drives it: ``integrate`` over two save
    windows of 25 steps (each one ``update_n``), launch counts set to 0
    just before and read just after.  Its wall time includes the two
    save-window callbacks (observables read back to the host, a print), so
    the step time is taken apart, over 50 more steps of bare ``update_n``."""
    reset_counts(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = pt.integrate(model, MAIN_STEPS * model.dt, MAIN_STEPS // 2 * model.dt)
    torch.cuda.synchronize()
    wall_integrate = time.perf_counter() - t0
    launches = count_launches(model)
    if status != "time_limit" or abs(model.time - MAIN_STEPS * model.dt) > model.dt / 2:
        raise AssertionError(f"integrate ended with {status!r} at t={model.time}")
    want = {k: v * MAIN_STEPS for k, v in PER_STEP[model.step_kernel].items()}
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    t0 = time.perf_counter()
    model.update_n(MAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nu, nuvol, re, div = model.get_observables()
    print(f"{phase} rbc1025 f64 {model.step_kernel} route: update_n {MAIN_STEPS} steps in {wall:.4f} s = "
          f"{wall / MAIN_STEPS * 1e3:.4f} ms/step; integrate {MAIN_STEPS} steps with 2 "
          f"save-window callbacks in {wall_integrate:.4f} s = "
          f"{wall_integrate / MAIN_STEPS * 1e3:.4f} ms/step; launches in integrate "
          f"{launches}; at t={model.time:.4f}: Nu={nu!r} Nuvol={nuvol!r} "
          f"Re={re!r} |div|={div!r}")
    if not all(math.isfinite(v) for v in (nu, nuvol, re, div)) or not nu > 0.0:
        raise AssertionError("rbc1025 observables not finite or Nu <= 0")
    return launches


def phase_profile(torch, model, steps=5, phase="phase5"):
    """Where the time of a main-path step goes: device time by kernel name
    and the device's busy share over ``steps`` steps, from torch.profiler
    (run after the counted main-path run, so its launches are not read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.update_n(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.update_n(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        tot, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + (end - start), cnt + 1)
    if not spans:
        print(f"{phase} profile: the profiler recorded no device events (not measured)")
        return
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(t for t, _ in by_name.values())
    print(f"{phase} profile rbc1025 f64 {model.step_kernel} route {steps} steps: wall {wall_us / steps / 1e3:.4f} ms/step, "
          f"device busy {busy / steps / 1e3:.4f} ms/step ({busy / wall_us:.4f} of wall), "
          f"kernel time {total / steps / 1e3:.4f} ms/step")
    for name, (t, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"{phase}   {t / steps / 1e3:9.4f} ms/step {cnt / steps:6.1f} calls/step "
              f"{t / total:7.4f}  {name[:90]}")


# -- the dense route ------------------------------------------------------------


def per_lane_inverses(torch, kernel, chunk=128):
    """``(lanes, n, n)``: the inverse ``U_j^-1 L_j^-1`` of every lane's
    matrix, from the banded factors of ``kernel`` (a per-lane
    ``BandedSolve``), built on its device ``chunk`` lanes at a time."""
    n, p, q = kernel.n, kernel.p, kernel.q
    eye = torch.eye(n, device=kernel.device, dtype=kernel.dtype)
    out = torch.empty((kernel.lanes, n, n), device=kernel.device, dtype=kernel.dtype)
    for j0 in range(0, kernel.lanes, chunk):
        lanes = slice(j0, min(j0 + chunk, kernel.lanes))
        low = eye.repeat(lanes.stop - j0, 1, 1)
        upp = torch.zeros_like(low)
        for d in range(1, p + 1):
            low.diagonal(-d, 1, 2).copy_(kernel.lower[d - 1, d:, lanes].T)
        for d in range(q + 1):
            upp.diagonal(d, 1, 2).copy_(kernel.upper[d, : n - d, lanes].T)
        linv = torch.linalg.solve_triangular(low, eye, upper=False, unitriangular=True)
        out[lanes] = torch.linalg.solve_triangular(upp, linv, upper=True)
    return out


def banded_cases(torch, pt, model, rng, timing):
    """``(label, solver, b, axis, per_step, library)`` for every banded
    solve of ``model``'s dense step on random inputs: the ADI axes of the
    velocity solver (applied twice a step, velx and vely) and of the
    temperature solver, the Poisson tensor solver's per-lane factors along
    axis 1 and, off the step (``per_step`` 0), along axis 0.  When
    ``timing``, ``library`` is one ``torch.matmul`` that solves the same
    systems with precomputed inverses: the dense inverse of the axis (one
    factor set) or the batch of every lane's inverse (per-lane factors)."""

    def rand(shape):
        return torch.as_tensor(rng.uniform(-1.0, 1.0, size=shape), dtype=model.dtype).to(model.device)

    cases = []
    for tag, adi, per_step in (("velx", model.solver_velx, 2), ("temp", model.solver_temp, 1)):
        dense = pt.solver.HholtzAdi(adi.space, adi.c, method="dense") if timing else None
        for axis in (1, 0):
            b = rand(adi.space.shape_spectral)
            lib = None if dense is None else (
                lambda d=dense.solvers[axis], b=b, axis=axis: d.solve(b, axis))
            cases.append((f"{tag}_axis{axis}", adi.solvers[axis].solver, b, axis, per_step, lib))
    banded = model.solver_pres._solver.banded
    b = rand(model.pseu_space.shape_spectral)
    inv = per_lane_inverses(torch, banded.kernel) if timing else None
    for label, rhs, axis, per_step in (("poisson_axis1", b, 1, 1),
                                       ("poisson_axis0", b.T.contiguous(), 0, 0)):
        lib = None if inv is None else (
            lambda rhs=rhs, axis=axis: torch.matmul(inv, rhs.movedim(axis, -1)[..., None])[..., 0]
            .movedim(-1, axis))
        cases.append((label, banded, rhs, axis, per_step, lib))
    return cases


def phase_banded(torch, pt, model, limit, timing):
    """Phase 6 at one model size/dtype; returns per-case records."""
    import numpy as np

    rng = np.random.default_rng(2)
    peak = (F64_TFLOPS if model.dtype == torch.float64 else F32_TFLOPS) * 1e12
    records = []
    for label, solver, b, axis, per_step, lib in banded_cases(torch, pt, model, rng, timing):
        out_k = solver.solve(b, axis)
        torch.cuda.synchronize()
        diff, rel = lane_rel_err(torch, out_k, solver.plain(b, axis), axis)
        rec = {"kernel": "banded_solve", "case": label, "n": model.nx, "per_step": per_step,
               "per_lane": solver.kernel.per_lane,
               "dtype": str(model.dtype).replace("torch.", ""),
               "max_abs_err": diff, "max_rel_err": rel}
        if lib is not None:
            rec["library_max_rel_err"] = lane_rel_err(torch, lib(), out_k, axis)[1]
        if timing:
            n = b.shape[axis]
            shape3 = (1, n, b.numel() // n)
            flops, nbytes = solver.kernel.flops(shape3), solver.kernel.bytes_moved(shape3)
            t_op = flops / peak * 1e3
            t_mem = nbytes / (HBM_TB_PER_S * 1e12) * 1e3
            rec.update(kernel_ms=time_ms(torch, lambda: solver.solve(b, axis), 10),
                       plain_ms=time_ms(torch, lambda: solver.plain(b, axis), 10),
                       library_ms=None if lib is None else time_ms(torch, lib, 10),
                       flops=flops, bytes=nbytes, bound_ms=max(t_op, t_mem),
                       bound_by="operations" if t_op >= t_mem else "bytes")
        print("phase6 " + json.dumps(rec))
        if not rel <= limit:
            raise AssertionError(f"banded_solve/{label} at {model.nx}^2: rel err {rel:.3e} > {limit:g}")
        if not rec.get("library_max_rel_err", 0.0) <= LIBRARY_LIMIT:
            raise AssertionError(f"banded_solve/{label}: the library yardstick solves another "
                                 f"system (rel err {rec['library_max_rel_err']:.3e})")
        records.append(rec)
    return records


def phase_mms(torch, pt):
    """The confined manufactured solutions of the JAX package's
    examples/solve_hholtz.py and examples/solve_poisson.py, on the card."""
    import numpy as np

    hn = math.pi / 2.0

    def setup(n):
        sp = pt.Space2(pt.cheb_dirichlet(n), pt.cheb_dirichlet(n), device="cuda",
                       dtype=torch.float64)
        xs, ys = (b.points for b in sp.bases)
        return sp, np.cos(hn * xs)[:, None] * np.cos(hn * ys)[None, :]

    def solve(sp, solver, f):
        rhs = sp.to_ortho(sp.forward(torch.as_tensor(f, device=sp.device)))
        return sp.backward(solver.solve(rhs)).cpu().numpy()

    checks = []
    sp, u = setup(257)
    alpha = 1e-5
    for method in ("banded", "dense"):
        solver = pt.solver.HholtzAdi(sp, (alpha, alpha), method=method)
        err = float(np.abs(solve(sp, solver, u) - u / (1.0 + alpha * 2.0 * hn * hn)).max())
        checks.append((f"hholtz_adi 257^2 {method}", err, solver))
    sp, u = setup(65)
    for method in ("banded", "fd"):
        solver = pt.solver.Poisson(sp, (1.0, 1.0), method=method)
        checks.append((f"poisson 65^2 {method}",
                       float(np.abs(solve(sp, solver, -2.0 * hn * hn * u) - u).max()), solver))
        solver = pt.solver.Hholtz(sp, (0.1, 0.1), method=method)
        checks.append((f"hholtz 65^2 c=0.1 {method}",
                       float(np.abs(solve(sp, solver, u * (1.0 + 0.2 * hn * hn)) - u).max()), solver))
    for label, err, solver in checks:
        launched = sum(k.launches for k in solver.kernels())
        print(f"phase7 {label}: max |err| {err:.3e} (tol 1e-6), banded launches {launched}")
        if not err < 1e-6:
            raise AssertionError(f"{label}: max |err| {err:.3e}")
        if launched != len(solver.kernels()):
            raise AssertionError(f"{label}: each banded solver should launch once")


def phase_solvers(torch, pt, model):
    """Phase 11: one whole solve at the rbc1025 shapes, the banded
    recurrence against the dense inverse (ADI) and fast diagonalisation
    (Poisson), 10 reps each by CUDA events."""
    import numpy as np

    rng = np.random.default_rng(3)
    adi = model.solver_velx
    pres_space = model.pseu_space
    times = {}
    for label, solvers, shape in (
            ("hholtz_adi", {"banded": adi, "dense": pt.solver.HholtzAdi(adi.space, adi.c, method="dense")},
             adi.space.shape_physical),
            ("poisson", {"banded": model.solver_pres,
                         "fd": pt.solver.Poisson(pres_space, (1.0, 1.0), method="fd")},
             pres_space.shape_physical)):
        rhs = torch.as_tensor(rng.uniform(-1.0, 1.0, shape), dtype=model.dtype).to(model.device)
        for method, solver in solvers.items():
            times[f"{label}_{method}_ms"] = time_ms(torch, lambda s=solver: s.solve(rhs), 10)
    print("phase11 " + json.dumps(times))
    return times


# -- the kernels line --------------------------------------------------------------


KERNEL_META = {
    "fused_conv": ("rustpde_mpi_tpu_torch/csrc/fused_conv.cu",
                   "rustpde_mpi_tpu/ops/pallas_conv.py:64"),
    "fused_stage": ("rustpde_mpi_tpu_torch/csrc/fused_stage.cu",
                    "rustpde_mpi_tpu/ops/pallas_step.py:95"),
    "banded_solve": ("rustpde_mpi_tpu_torch/csrc/banded_solve.cu",
                     "rustpde_mpi_tpu/ops/pallas_banded.py:36"),
}


def kernels_line(records, launches, solver_times):
    """One entry per kernel, its times summed over one step of the route
    that runs it (fused: 3 conv chains, 2 without bc and 1 with, the 7
    stages once each; dense: the 7 banded solves)."""
    out = []
    for kernel, (source, replaces) in KERNEL_META.items():
        rows = [r for r in records if r["kernel"] == kernel]

        def total(key, rows=rows):
            vals = [(r["per_step"], r[key]) for r in rows if r["per_step"]]
            if any(v is None for _, v in vals):
                return None
            return sum(k * v for k, v in vals)

        entry = {
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes",
            "library_ms": total("library_ms"),
            "per": "one step of rbc1025 f64",
        }
        if kernel == "banded_solve":
            entry.update(solver_times)
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "rustpde_mpi_tpu_torch")):
        print("chip_smoke: the rustpde_mpi_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
          + " ".join(f"{k}={v['seconds']:.2f}s" for k, v in built.items()))
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    main_model = pt.Navier2D.new_confined(**RBC1025, device="cuda")
    print(f"rbc1025 model build: {time.perf_counter() - t0:.2f} s")
    small = {dt: pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", device="cuda", dtype=dt)
             for dt in (torch.float64, torch.float32)}
    phase_kernels(torch, small[torch.float64], 1e-12, False)
    phase_kernels(torch, small[torch.float32], 1e-4, False)
    records = phase_kernels(torch, main_model, 1e-12, True)
    print("phase1 ok")
    phase_golden(pt)
    phase_card_vs_cpu(pt)
    launches = phase_main(torch, pt, main_model)
    phase_profile(torch, main_model)

    t0 = time.perf_counter()
    dense_model = pt.Navier2D.new_confined(**RBC1025, device="cuda", **DENSE)
    print(f"rbc1025 dense-route model build: {time.perf_counter() - t0:.2f} s")
    for dt in (torch.float64, torch.float32):
        small = pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", device="cuda", dtype=dt, **DENSE)
        phase_banded(torch, pt, small, 1e-12 if dt == torch.float64 else 1e-4, False)
    records += phase_banded(torch, pt, dense_model, 1e-12, True)
    print("phase6 ok")
    phase_mms(torch, pt)
    phase_golden(pt, "phase8", **DENSE)
    phase_card_vs_cpu(pt, "phase9", **DENSE)
    launches.update(phase_main(torch, pt, dense_model, "phase10"))
    phase_profile(torch, dense_model, phase="phase10")
    solver_times = phase_solvers(torch, pt, dense_model)
    print(f"card: {card}")
    print(json.dumps(kernels_line(records, launches, solver_times)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rustpde_mpi_tpu_torch/csrc`` with
``nvcc`` (sm_90a) and then, raising on the first failure:

1. holds every kernel against its plain PyTorch version on the card: every
   stage instance and both convection variants at 129^2 and 1025^2 in f64
   (limit 1e-12 of max|plain|) and at 129^2 in f32 (limit 1e-4), and times
   the kernel, the plain version and the chain in the fewest cuBLAS calls
   PyTorch offers (``library_ms``) at 1025^2 f64;
2. reruns the head of the f64 golden Nusselt trajectory of PARITY.json at
   129^2 through the kernels (rel 1e-6);
3. steps the same 129^2 model 10 steps on the card and on the CPU (plain
   versions) and compares the states (rel 1e-11);
4. drives the main path, the ``rbc1025`` configuration (1025^2, Ra=1e9,
   Pr=1, dt=1e-4, f64), for 50 steps through ``integrate`` (two save
   windows, each one ``Navier2D.update_n``), checks that every step
   launched 3 fused convection chains and 7 fused stages, then times 50
   more steps of bare ``update_n`` (ms/step) and checks the observables;
5. profiles 5 more steps (device time by kernel, device busy share).

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


def phase_golden(pt):
    with open(os.path.join(ROOT, "PARITY.json"), encoding="utf-8") as fh:
        gold = json.load(fh)
    cfg = gold["config"]
    model = pt.Navier2D(cfg["nx"], cfg["ny"], cfg["ra"], cfg["pr"], cfg["dt"],
                        cfg["aspect"], cfg["bc"], device="cuda")
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
    if not all(k.launches for k in list(model._stages.values()) + list(model._convs.values())):
        raise AssertionError("the golden run did not launch every kernel")
    print(f"phase2 golden 129^2 f64 200 steps: max rel dev {worst:.3e} (limit 1e-6)")


def phase_card_vs_cpu(pt):
    models = {}
    for dev in ("cuda", "cpu"):
        m = pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", device=dev)
        m.init_random(0.1, seed=0)
        m.update_n(10)
        models[dev] = pt.convert.state_to_numpy(m)
    worst = 0.0
    for name, ref in models["cpu"].items():
        rel = float(abs(models["cuda"][name] - ref).max() / max(abs(ref).max(), 1e-300))
        worst = max(worst, rel)
        if not rel <= 1e-11:
            raise AssertionError(f"card vs cpu {name}: rel {rel:.3e} > 1e-11")
    print(f"phase3 card vs cpu 129^2 f64 10 steps: max rel diff {worst:.3e} (limit 1e-11)")


def reset_counts(model):
    for k in list(model._stages.values()) + list(model._convs.values()):
        k.launches = 0


def phase_main(torch, pt, model):
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
    conv = sum(k.launches for k in model._convs.values())
    stage = sum(k.launches for k in model._stages.values())
    if status != "time_limit" or abs(model.time - MAIN_STEPS * model.dt) > model.dt / 2:
        raise AssertionError(f"integrate ended with {status!r} at t={model.time}")
    if conv != 3 * MAIN_STEPS or stage != 7 * MAIN_STEPS:
        raise AssertionError(f"expected {3 * MAIN_STEPS} conv and {7 * MAIN_STEPS} stage "
                             f"launches, got {conv} and {stage}")
    t0 = time.perf_counter()
    model.update_n(MAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nu, nuvol, re, div = model.get_observables()
    print(f"phase4 rbc1025 f64: update_n {MAIN_STEPS} steps in {wall:.4f} s = "
          f"{wall / MAIN_STEPS * 1e3:.4f} ms/step; integrate {MAIN_STEPS} steps with 2 "
          f"save-window callbacks in {wall_integrate:.4f} s = "
          f"{wall_integrate / MAIN_STEPS * 1e3:.4f} ms/step; launches in integrate "
          f"conv={conv} stage={stage}; at t={model.time:.4f}: Nu={nu!r} Nuvol={nuvol!r} "
          f"Re={re!r} |div|={div!r}")
    if not all(math.isfinite(v) for v in (nu, nuvol, re, div)) or not nu > 0.0:
        raise AssertionError("rbc1025 observables not finite or Nu <= 0")
    return {"fused_conv": conv, "fused_stage": stage}


def phase_profile(torch, model, steps=5):
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
        print("phase5 profile: the profiler recorded no device events (not measured)")
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
    print(f"phase5 profile rbc1025 f64 {steps} steps: wall {wall_us / steps / 1e3:.4f} ms/step, "
          f"device busy {busy / steps / 1e3:.4f} ms/step ({busy / wall_us:.4f} of wall), "
          f"kernel time {total / steps / 1e3:.4f} ms/step")
    for name, (t, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"phase5   {t / steps / 1e3:9.4f} ms/step {cnt / steps:6.1f} calls/step "
              f"{t / total:7.4f}  {name[:90]}")


def kernels_line(records, launches):
    """One entry per kernel, its times summed over one step of the main
    path (3 conv chains: 2 without bc, 1 with; the 7 stages once each)."""
    per_step = {"conv": 2, "conv_bc": 1}
    meta = {
        "fused_conv": ("rustpde_mpi_tpu_torch/csrc/fused_conv.cu",
                       "rustpde_mpi_tpu/ops/pallas_conv.py:64"),
        "fused_stage": ("rustpde_mpi_tpu_torch/csrc/fused_stage.cu",
                        "rustpde_mpi_tpu/ops/pallas_step.py:95"),
    }
    out = []
    for kernel, (source, replaces) in meta.items():
        rows = [r for r in records if r["kernel"] == kernel]
        w = [per_step.get(r["case"], 1) for r in rows]

        def total(key, rows=rows, w=w):
            return sum(k * r[key] for k, r in zip(w, rows))

        out.append({
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes",
            "library_ms": total("library_ms"),
            "per": "one step of rbc1025 f64",
        })
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
    print(f"card: {card}")
    print(json.dumps(kernels_line(records, launches)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

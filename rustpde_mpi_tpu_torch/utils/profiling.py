"""Profiling and benchmarking helpers (counterpart of the JAX package's
``utils/profiling.py``).

* :func:`benchmark_steps`: the slope-timed step rate (two window lengths,
  so the fixed cost of a call cancels), each window ended by a
  synchronisation of the model's card;
* :class:`StepTimer`: a rolling per-chunk rate history;
* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace;
* :func:`device_memory_stats`: per-card allocator statistics, None-safe;
* :func:`step_flops` / :func:`mfu_estimate`: the flops of one step and the
  model-flops utilisation against the card's peak (:data:`PEAK_FLOPS`).

:func:`step_flops` counts from the kernel wrappers' own accounting
(``FusedConv.flops``, ``FusedStage.cost``, ``BandedSolve.flops``), each
wrapper priced once per application one step makes (counted by running
one step), plus, for the dense and meshed routes, the analytic GEMM count
of the transforms and dense solves (:func:`_analytic_step_flops`, the JAX
package's formula with the port's unfolded products).  The JAX package's
jaxpr readers (``register_pallas_flops``, ``_pallas_eqn_flops``,
``_jaxpr_dot_flops``) price XLA programs and Pallas calls; a PyTorch step
has no jaxpr, so they have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _model_device(model):
    """The device the model's state lives on."""
    state = getattr(model, "state", None)
    if state is not None:
        return state[0].device
    return getattr(model, "device", torch.device("cpu"))


def _sync(model) -> None:
    """Wait for the model's card (nothing to wait for on the CPU)."""
    dev = _model_device(model)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def benchmark_steps(model, steps: int, warmup: int | None = None, reps: int = 3) -> dict:
    """Slope-timed step rate: ``update_n`` timed at ``L = steps`` and
    ``4L`` steps (both run once untimed first), ``(t_4L - t_L) / 3L`` the
    per-step time with the fixed cost of a call cancelled; the median of
    ``reps`` slopes.  Returns ``{steps_per_sec, ms_per_step,
    fixed_overhead_ms, elapsed_s, steps, steps_total, slope_reps_ms}`` and,
    for an ensemble, its member-step rate."""
    L = int(steps)
    L4 = 4 * L
    if warmup is None:
        warmup = L
    executed = 0
    if warmup:
        model.update_n(warmup)
        _sync(model)
        executed += warmup
    for n in (L, L4):
        model.update_n(n)
        _sync(model)
        executed += n
    slopes, fixeds = [], []
    t4 = 0.0
    t_all = time.perf_counter()
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        model.update_n(L)
        _sync(model)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.update_n(L4)
        _sync(model)
        t4 = time.perf_counter() - t0
        executed += L + L4
        slopes.append((t4 - t1) / (L4 - L))
        fixeds.append(t1 - L * slopes[-1])
    elapsed = time.perf_counter() - t_all
    slope = float(np.median(slopes))
    if slope <= 0:  # timer noise on a trivial model: the naive rate
        slope = t4 / L4
    res = {
        "steps_per_sec": 1.0 / slope,
        "ms_per_step": 1e3 * slope,
        "fixed_overhead_ms": 1e3 * float(np.median(fixeds)),
        "elapsed_s": elapsed,
        "steps": L,
        "steps_total": executed,
        "slope_reps_ms": [round(1e3 * s, 4) for s in slopes],
    }
    k = int(getattr(model, "ensemble_size", 0) or 0)
    if k:
        res["ensemble_size"] = k
        res["member_steps_per_sec"] = k * res["steps_per_sec"]
        res["ms_per_member_step"] = res["ms_per_step"] / k
    return res


class StepTimer:
    """Rolling per-chunk step-rate history: ``tick(n)`` after each chunk
    (``sync=model`` waits for its card first, so the chunk's device work
    lands in its window), ``summary()`` the mean/min/max steps/s."""

    def __init__(self, sync=None):
        self.history: list[tuple[int, float]] = []  # (steps, seconds)
        self._sync_model = sync
        self._last = time.perf_counter()

    def reset(self) -> None:
        self._last = time.perf_counter()

    def tick(self, steps: int) -> float:
        if self._sync_model is not None:
            _sync(self._sync_model)
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.history.append((steps, dt))
        return steps / dt if dt > 0 else float("inf")

    def summary(self) -> dict:
        if not self.history:
            return {"chunks": 0}
        rates = [s / t for s, t in self.history if t > 0]
        return {
            "chunks": len(self.history),
            "steps": sum(s for s, _ in self.history),
            "seconds": sum(t for _, t in self.history),
            "steps_per_sec_mean": float(np.mean(rates)),
            "steps_per_sec_min": float(np.min(rates)),
            "steps_per_sec_max": float(np.max(rates)),
        }


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """``torch.profiler`` around the block (CPU activity, and CUDA activity
    where a card is visible); the Chrome trace lands in
    ``<logdir>/trace.json``.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> dict:
    """``{"cuda:<i>": {"bytes_in_use", "peak_bytes_in_use",
    "bytes_reserved"}}`` for every visible card, from its caching
    allocator; an empty dict without a card (callers treat a missing entry
    as no data, never as zero)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            stats = None
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        } if stats else None
    return out


# -- flops and MFU ---------------------------------------------------------------------

#: peak flop rates: the H100 SXM's data-sheet figures (FP64 with tensor
#: cores; f32 without TF32, which the port turns off) and, as data, the JAX
#: package's TPU entries, which no measurement of the port uses
PEAK_FLOPS = {
    "h100_sxm_f64": 67e12,
    "h100_sxm_f32": 67e12,
    "tpu_v5e_bf16": 197e12,
    "tpu_v5e_f32": 49e12,
    "cpu": 1e11,
}


def peak_flops_key(device=None, dtype=torch.float64) -> str:
    """The :data:`PEAK_FLOPS` entry of a device (default: the current CUDA
    card when one is visible, else the CPU): an H100 by
    ``torch.cuda.get_device_name``, at the working dtype's precision."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return "cpu"
    if "H100" in torch.cuda.get_device_name(dev):
        return "h100_sxm_f32" if dtype == torch.float32 else "h100_sxm_f64"
    return "cpu"


def _step_applications(model) -> list:
    """``(wrapper, members or banded shape)`` of every kernel application
    one step of ``model`` makes, found by running one step (on a copy of
    the state; the state is not changed).  The wrappers' ``launches``
    counters are put back afterwards, so the step does not count as a
    launch of the run."""
    kernels = [k for ks in model.kernels().values() for k in ks]
    calls: list = []
    saved = {}
    for k in kernels:
        kind = type(k).__name__
        if kind not in ("FusedConv", "FusedStage", "BandedSolve") or id(k) in saved:
            continue
        saved[id(k)] = (k, k.launches)
        orig = k.apply

        def counted(*args, _k=k, _orig=orig, _kind=kind, **kw):
            x = args[0]
            if _kind == "BandedSolve":
                shape = tuple(x.shape)
                if len(shape) == 4:  # planes counted into the batch
                    shape = (shape[0] * shape[1],) + shape[2:]
                calls.append((_k, shape))
            else:  # the members in front of a (rows, cols) input
                calls.append((_k, int(np.prod(x.shape[:-2]))))
            return _orig(*args, **kw)

        k.apply = counted
    try:
        with torch.no_grad():
            model._step(type(model.state)(*(t.clone() for t in model.state)))
    finally:
        for k, launches in saved.values():
            del k.apply  # the class's apply again
            k.launches = launches
    return calls


def _analytic_step_flops(model) -> float:
    """The JAX package's analytic GEMM count of one dense-route step:
    2 velocity backwards, 6 convection gradient syntheses and 3 forwards,
    3 implicit ADI solves and the fast-diagonalisation Poisson solve, at 2
    GEMMs of ``2 n^3`` a 2-D transform (``n`` the mean of nx and ny),
    times the ensemble size.  The port applies each axis as one unfolded
    product (``ops/folded.py``), so its folding factor is 1."""
    n = 0.5 * (model.nx + model.ny)
    gemms = 2 * 2 + 6 * 2 + 3 * 2 + 3 * 3 + 4
    k = max(1, int(getattr(model, "ensemble_size", 1) or 1))
    return k * gemms * 1.0 * 2.0 * n**3


def step_flops(model) -> float:
    """Flops of one step: every fused-kernel and banded-solve application
    one step makes, priced by its wrapper, plus :func:`_analytic_step_flops`
    on the dense and meshed routes (their transforms and dense solves run
    on library products).  An ensemble's is K times its template's."""
    k = int(getattr(model, "ensemble_size", 0) or 0)
    if k and hasattr(model, "model"):
        return k * step_flops(model.model)
    total = 0.0
    for wrapper, arg in _step_applications(model):
        kind = type(wrapper).__name__
        if kind == "FusedConv":
            total += wrapper.flops * arg
        elif kind == "FusedStage":
            total += wrapper.cost(arg)[0]
        else:
            total += wrapper.flops(arg)
    if getattr(model, "step_kernel", "dense") == "dense":
        total += _analytic_step_flops(model)
    return total


def mfu_estimate(model, steps_per_sec: float) -> dict:
    """Model-flops utilisation: :func:`step_flops` times the rate over the
    peak of the model's card and working dtype."""
    flops = step_flops(model)
    dtype = getattr(model, "dtype", torch.float64)
    key = peak_flops_key(_model_device(model), dtype)
    peak = PEAK_FLOPS[key]
    return {
        "flops_per_step": flops,
        "achieved_flops": flops * steps_per_sec,
        "peak_flops_assumed": peak,
        "peak_key": key,
        "mfu": flops * steps_per_sec / peak,
    }

"""Callback-side IO of the Navier models (counterpart of the JAX package's
``utils/navier_io.py``): at a save boundary write the
flow snapshot (throttled by ``write_intervall``), print time, |div|, Nu,
Nuvol and Re, and append a ``time nu nuvol re`` row to ``data/info.txt``;
an ensemble writes its K-member snapshot instead of the row.

A failed write (``OSError``) is printed and never fatal, as the
reference's.  A missing ``h5py`` is not caught: a callback that must write
a snapshot raises ``ImportError`` where ``h5py`` is not installed, so a run
that should save never goes on without its files (set ``write_intervall``
past the run's end to write none).  A model with an attached legacy
:class:`..models.statistics.Statistics` (``model.statistics``) updates it
every ``save_stat`` and writes ``data/statistics.h5`` every
``write_stat``, as the reference's callback; a failed statistics write is
printed and appended to the model's journal as ``stats_write_failed``.
With an ``io_pipeline`` attached to the model (:mod:`.io_pipeline`) the
snapshot's file write runs on the pipeline's worker and the printed line
comes from the observables future, at most ``diag_lag`` boundaries late.
"""

from __future__ import annotations

import os

import numpy as np

from . import checkpoint


def _due(t: float, dt: float, write_intervall) -> bool:
    """Whether the boundary at ``t`` writes a snapshot: every save boundary
    unless ``write_intervall`` throttles it, as the reference throttles."""
    return write_intervall is None or (t + dt / 2.0) % write_intervall < dt


def _emit_info_line(model, t: float, vals, io_name: str, extra: str | None) -> None:
    """Append one boundary's observables to ``model.diagnostics``, print
    them and append the ``info.txt`` row (the synchronous path and the
    pipeline's lagged emission alike)."""
    nu, nuvol, re, div = (float(v) for v in vals[:4])
    # an extended vocabulary (the passive scalar's sherwood) rides along by
    # name behind the conventional four; index 3 stays the NaN detector
    extras = [(name, float(v)) for name, v in zip(model.observable_names[4:], vals[4:])]
    for key, val in [("time", t), ("nu", nu), ("nuvol", nuvol), ("re", re), ("div", div)] + extras:
        model.diagnostics.setdefault(key, []).append(float(val))
    print(f"time = {t:9.3f}      |div| = {div:4.2e}      "
          f"Nu = {nu:5.3e}      Nuv = {nuvol:5.3e}      Re = {re:5.3e}"
          + "".join(f"      {name.capitalize()} = {val:5.3e}" for name, val in extras)
          + (f"      {extra}" if extra else ""))
    if not checkpoint.writes_here(model):
        return
    try:
        with open(io_name, "a", encoding="utf-8") as fh:
            fh.write(f"{t} {nu} {nuvol} {re}\n")
    except OSError as exc:
        print(f"unable to write {io_name}: {exc}")


def _submit_snapshot(pde, pipeline, snap, fname: str) -> None:
    """Hand a staged snapshot's file write to the pipeline's worker (a
    failed write printed, never fatal; the root's alone on a mesh whose
    ranks span processes)."""
    if not checkpoint.writes_here(pde):
        return

    def write(snap=snap, fname=fname):
        try:
            checkpoint.write_host_snapshot(snap, fname)
        except OSError as exc:
            print(f"unable to write {fname}: {exc}")

    pipeline.submit_write(write, fname, nbytes=snap.nbytes)


def callback(model, flowname: str | None = None, io_name: str = "data/info.txt",
             extra: str | None = None) -> None:
    """The save-boundary hook of a model (``Navier2D.callback``): the flow
    snapshot ``flowname`` (default ``data/flow{t:08.2f}.h5``) when due, then
    the observables appended to ``model.diagnostics``, printed (with
    ``extra`` at the end of the line), and appended to ``io_name`` as a
    ``time nu nuvol re`` row.

    With an attached ``model.io_pipeline`` the snapshot is staged to the
    host here and written on the pipeline's worker, and the line rides the
    observables future (:meth:`..utils.io_pipeline.IOPipeline.push_diag`:
    emitted once the values are on the host, at most ``diag_lag``
    boundaries late, in order)."""
    t = model.get_time()
    os.makedirs("data", exist_ok=True)
    pipeline = getattr(model, "io_pipeline", None)
    if _due(t, model.get_dt(), model.write_intervall):
        flowname = flowname or f"data/flow{t:08.2f}.h5"
        if pipeline is not None:
            _submit_snapshot(model, pipeline, checkpoint.snapshot_to_host(model), flowname)
        else:
            try:
                checkpoint.write_snapshot(model, flowname)
            except OSError as exc:  # never fatal, matching the reference
                print(f"unable to write {flowname}: {exc}")
    stats = getattr(model, "statistics", None)
    if stats is not None:
        dt = model.get_dt()
        if (t + dt / 2.0) % stats.save_stat < dt:
            stats.update(model)
        if (t + dt / 2.0) % stats.write_stat < dt:
            try:
                stats.write("data/statistics.h5")
            except OSError as exc:  # never fatal, but journaled
                from ..models.stats import report_stats_event

                print(f"unable to write statistics: {exc}")
                report_stats_event(model, {"event": "stats_write_failed",
                                           "path": "data/statistics.h5", "error": str(exc)})
    if pipeline is not None:
        pipeline.push_diag(lambda vals, t=t: _emit_info_line(model, t, vals, io_name, extra),
                           model.get_observables_async())
        return
    _emit_info_line(model, t, model.get_observables(), io_name, extra)


def _emit_ensemble_line(ens, t: float, vals, alive) -> None:
    """Append every member's observables and alive flag to
    ``ens.diagnostics`` and print one aggregate line."""
    nu, nuvol, re, div = vals[:4]
    for key, val in (("time", [t] * ens.k), ("nu", nu), ("nuvol", nuvol), ("re", re),
                     ("div", div), *zip(tuple(ens.observable_names)[4:], vals[4:]),
                     ("alive", alive.astype(float))):
        ens.diagnostics.setdefault(key, []).append([float(v) for v in val])
    n_alive = int(alive.sum())
    if n_alive:
        live = np.asarray(nu)[alive]
        nu_info = f"Nu = {live.mean():5.3e} [{live.min():5.3e}, {live.max():5.3e}]"
    else:
        nu_info = "Nu = --- (all members diverged)"
    print(f"time = {t:9.3f}      alive = {n_alive}/{ens.k}      {nu_info}")


def ensemble_callback(ens) -> None:
    """The save-boundary hook of an ensemble (``NavierEnsemble.callback``):
    append every member's observables and alive flag to ``diagnostics``,
    print one aggregate line, and write ``data/ensemble{t:08.2f}.h5`` when
    ``write_intervall`` says so.  With an attached ``ens.io_pipeline`` the
    line rides the observables and mask futures and the snapshot is staged
    here and written on the worker, as :func:`callback` does."""
    t = ens.time
    pipeline = getattr(ens, "io_pipeline", None)
    if pipeline is not None:
        from .io_pipeline import ObservableFuture

        # the mask's copy is enqueued behind the observables': when their
        # future is ready, so is this one
        mask = ObservableFuture(ens.mask, convert=lambda m: np.asarray(m, dtype=bool))
        pipeline.push_diag(lambda vals, t=t: _emit_ensemble_line(ens, t, vals, mask.result()),
                           ens.get_observables_async())
    else:
        _emit_ensemble_line(ens, t, ens.get_observables(), ens.alive())
    if _due(t, ens.dt, ens.write_intervall):
        fname = f"data/ensemble{t:08.2f}.h5"
        if pipeline is not None:
            _submit_snapshot(ens, pipeline, checkpoint.ensemble_snapshot_to_host(ens), fname)
            return
        try:
            checkpoint.write_ensemble_snapshot(ens, fname)
        except OSError as exc:  # never fatal, like the single-run callback
            print(f"unable to write ensemble snapshot: {exc}")

"""The paths of a model whose mesh spans processes, on the CPU: two
processes joined by gloo (``tests/torch_mp_worker.py``, mode
``spanning_paths``), each holding 2 of the 4 ranks of
``parallel.multihost.global_pencil_mesh(2, "cpu")``, run through the entry
points a user calls:

* ``ResilientRunner(model, ...).run()`` with a NaN on rank 1's process: the
  journal's event types in order, the summary and the recovered state bit
  for bit the same runner's on the one-process ``make_mesh(4)`` (a NaN on
  every rank there), and the recovered state bit for bit a clean run at
  dt/2;
* ``model.set_stats(StatsConfig(stride=2))`` through ``update_n``: the
  running sums bit for bit the one-process mesh's, and within 1e-11 of
  each leaf's scale of the JAX meshed model's on 4 of the conftest's
  virtual devices (the health readout within 1e-11 of each entry, counts
  exactly, as ``tests/test_torch_stats.py`` holds it);
* the runner under the integrity audits with a bit flipped on rank 1's
  process: the mismatch attributed to that process and its device, the
  rollback, and the state bit for bit the one-process runner's;
* ``NavierEnsemble.from_seeds(model, range(3)).update_n``: every member bit
  for bit the one-process meshed ensemble's, its digests equal, and within
  1e-11 of each field's scale of the JAX meshed ensemble.

The JAX references are computed while the workers run.  The gradient on a
spanning mesh is held in ``tests/test_torch_lnse.py``, beside the JAX
gradient it shares.
"""

import gc
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import rustpde_mpi_tpu as rp
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu.config import StatsConfig as JaxStatsConfig
from rustpde_mpi_tpu.parallel.mesh import AXIS
from rustpde_mpi_tpu_torch.models.stats import HEALTH_NAMES
from rustpde_mpi_tpu_torch.parallel import make_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mp_worker import (PATH_FLIP_STEP, PATH_MEMBERS, PATH_NAN_STEP,  # noqa: E402
                             PATH_RUN_TIME, PATH_STATS_STEPS, PATH_STRIDE, SPAN_CELLS, SPAN_MODEL,
                             SPAN_RANKS, SPAN_STEPS, collect, path_bitflip, path_ensemble,
                             path_results, path_runner, path_stats, span_model, start)

#: the spawn's deadline: two imports of the port and the four paths, ≈15 s here
DEADLINE_S = 90.0
TOL = 1e-11
#: health entries that count grid points or samples: equal exactly
EXACT_HEALTH = ("bl_thermal_pts", "bl_visc_pts", "samples")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread, as the workers run; drop the JAX objects this
    module built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _jax_model():
    c = SPAN_CELLS["confined"]
    model = rp.Navier2D(c["nx"], c["ny"], *SPAN_MODEL.values(), periodic=c["periodic"],
                        mesh=JaxMesh(np.array(jax.devices()[:SPAN_RANKS]), (AXIS,)))
    model.set_velocity(0.1, 1.0, 1.0)
    model.set_temperature(0.1, 1.0, 1.0)
    return model


def _jax_references() -> dict:
    """The JAX meshed model's statistics (leaves and health) and the JAX
    meshed ensemble's members, as the paths run them."""
    stats = _jax_model()
    stats.set_stats(JaxStatsConfig(stride=PATH_STRIDE))
    stats.update_n(PATH_STATS_STEPS)
    out = {f"stats_{name}": np.asarray(getattr(stats.stats_state, name))
           for name in stats.stats_state._fields}
    out["stats_health"] = np.array([float(v) for v in stats.stats_health_async().result()])
    ens = rp.NavierEnsemble.from_seeds(_jax_model(), range(PATH_MEMBERS))
    ens.update_n(SPAN_STEPS)
    out.update({f"ens_{name}": np.asarray(getattr(ens.state, name)) for name in ens.state._fields})
    return out


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The spawn's global arrays and records, and the JAX references
    computed while it ran."""
    out = str(tmp_path_factory.mktemp("spanning_paths"))
    procs = start(out, "spanning_paths")
    try:
        refs = _jax_references()
    finally:
        results = collect(procs, out, DEADLINE_S)
    for rc, _, err, res in results:
        assert rc == 0 and res is not None, err[-3000:]
    return dict(np.load(os.path.join(out, "paths.npz"))), [r for *_, r in results], refs


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The same paths on the one-process ``make_mesh(4)``: the runner with a
    NaN on every rank, and a clean run at dt/2."""
    run_dir = str(tmp_path_factory.mktemp("one_process_run"))
    model, summary, events = path_runner(make_mesh(SPAN_RANKS, "cpu"), run_dir,
                                         f"nan@{PATH_NAN_STEP}")
    flipped, audits = path_bitflip(make_mesh(SPAN_RANKS, "cpu"),
                                   str(tmp_path_factory.mktemp("one_process_flip")),
                                   f"bitflip@{PATH_FLIP_STEP}")
    arrays = path_results(model, path_ensemble(make_mesh(SPAN_RANKS, "cpu")),
                          path_stats(make_mesh(SPAN_RANKS, "cpu")), flipped)
    clean = span_model("confined", make_mesh(SPAN_RANKS, "cpu"))
    clean.set_dt(SPAN_MODEL["dt"] / 2)
    clean.update_n(round(PATH_RUN_TIME / clean.dt))
    return arrays, summary, events, pt.state_to_numpy(clean), audits


def _arrays(d: dict, prefix: str) -> dict:
    return {k: v for k, v in d.items() if k.startswith(prefix)}


def test_runner_recovers_a_nan_on_one_process_as_the_one_process_runner(paths, one_process):
    arrays, (r0, r1), _ = paths
    want, summary, events = one_process[:3]
    for res in (r0, r1):
        assert res["summary"] == {k: summary[k] for k in ("outcome", "step", "dt", "retries")}
        assert res["summary"]["retries"] == 1
        assert res["summary"]["dt"] == SPAN_MODEL["dt"] / 2
    assert r0["events"] == events and r1["events"] is None  # the root's journal
    assert events.index("fault_injected") < events.index("divergence") < events.index("retry")
    for name, w in _arrays(want, "run_").items():
        np.testing.assert_array_equal(arrays[name], w, err_msg=name)


def test_runner_recovered_state_is_the_clean_run_at_half_dt(paths, one_process):
    arrays, _, _ = paths
    clean = one_process[3]
    for f, w in clean.items():
        np.testing.assert_array_equal(arrays[f"run_{f}"], w, err_msg=f)


def test_integrity_mismatch_is_attributed_to_the_process_holding_the_rank(paths, one_process):
    arrays, (r0, r1), _ = paths
    want, audits = one_process[0], one_process[4]
    assert r1["audits"] is None  # the root's journal
    assert [e["event"] for e in r0["audits"]] == [e["event"] for e in audits]
    flips = [e for e in r0["audits"] if e["event"] == "bitflip_injected"]
    assert len(flips) == 1 and flips[0]["host"] == 1 and flips[0]["leaf"] == "temp"
    mismatch = [e for e in r0["audits"] if e["event"] == "integrity_mismatch"]
    assert len(mismatch) == 1 and mismatch[0]["check"] == "chain"
    assert mismatch[0]["host"] == 1 and mismatch[0]["device"].endswith("@proc1")
    assert "integrity_rollback" in [e["event"] for e in r0["audits"]]
    for name, w in _arrays(want, "flip_").items():
        np.testing.assert_array_equal(arrays[name], w, err_msg=name)


def test_stats_equal_the_one_process_mesh_bit_for_bit(paths, one_process):
    arrays, results, _ = paths
    want = one_process[0]
    assert all(r["stats_tick"] == PATH_STATS_STEPS for r in results)
    for name, w in _arrays(want, "stats_").items():
        np.testing.assert_array_equal(arrays[name], w, err_msg=name)


def test_stats_match_the_jax_meshed_model(paths):
    arrays, _, refs = paths
    for name, w in _arrays(refs, "stats_").items():
        if name == "stats_health":
            continue
        g = arrays[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = max(float(np.max(np.abs(w))), 1e-300)
        assert float(np.max(np.abs(g - w))) <= TOL * scale, name
    assert np.array_equal(arrays["stats_samples"], refs["stats_samples"])
    for name, g, w in zip(HEALTH_NAMES, arrays["stats_health"], refs["stats_health"]):
        if name in EXACT_HEALTH:
            assert g == w, name
        else:
            assert abs(g - w) <= TOL * max(abs(w), 1e-300), (name, g, w)


def test_ensemble_members_and_digests_equal_the_one_process_mesh(paths, one_process):
    arrays, results, _ = paths
    want = one_process[0]
    assert all(r["alive"] == [True] * PATH_MEMBERS for r in results)
    for name, w in _arrays(want, "ens_").items():
        np.testing.assert_array_equal(arrays[name], w, err_msg=name)
    assert arrays["ens_digest"].shape == (PATH_MEMBERS,)


def test_ensemble_matches_the_jax_meshed_ensemble(paths):
    arrays, _, refs = paths
    for name, w in _arrays(refs, "ens_").items():
        scale = max(float(np.max(np.abs(w))), 1e-300)
        assert float(np.max(np.abs(arrays[name] - w))) <= TOL * scale, name


def test_member_digest_is_its_solo_model_digest(paths):
    """Each member's digest (through the ring on the spanning mesh) is the
    digest a one-process solo model holding its state gives."""
    from rustpde_mpi_tpu_torch.config import IntegrityConfig
    from rustpde_mpi_tpu_torch.convert import state_from_numpy

    arrays, _, _ = paths
    for i in range(PATH_MEMBERS):
        solo = span_model("confined", make_mesh(SPAN_RANKS, "cpu"))
        state_from_numpy(solo, {f: arrays[f"ens_{f}"][i] for f in solo.state._fields})
        solo.set_integrity(IntegrityConfig())
        assert int(solo.state_digest_async().result()) == int(arrays["ens_digest"][i]), i

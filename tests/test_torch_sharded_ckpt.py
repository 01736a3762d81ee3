"""The port's sharded two-phase checkpoints against the JAX package's
(``utils/checkpoint.py``, the sharded half): manifests either package
writes read in the other bit for bit, serial and on 2 and 4 ranks (the JAX
side on its virtual CPU mesh, as ``tests/test_sharded_ckpt.py``), at 17²
and 33×32, and for an ensemble of K = 3; the topology-elastic matrix; the
rejections and the rotation; the runner's sharded path (blocking and
overlapped digests the same, NaN rollback, resume, the in-memory store);
and a two-process crash inside the commit window, after which the run
resumes from the previous checkpoint bit for bit.

Every comparison is exact (``np.array_equal`` of the leaves, equal SHA-256
digests): the sharded format stores raw bytes, so no tolerance applies.
"""

import gc
import json
import os
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rustpde_mpi_tpu.utils import checkpoint as jck

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.config import IOConfig, IntegrityConfig, StatsConfig
from rustpde_mpi_tpu_torch.integrity import IntegrityError
from rustpde_mpi_tpu_torch.utils import checkpoint as tck
from rustpde_mpi_tpu_torch.utils import resilience as tres
from rustpde_mpi_tpu_torch.utils.journal import read_journal

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mp_worker import spawn  # noqa: E402

PARAMS = (1e4, 1.0, 0.01, 1.0)
DENSE = dict(step_kernel="dense", conv_kernel="dense")
TOPOLOGIES = ["serial", "mesh2", "mesh4"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _port(nx=33, ny=32, topo="serial", periodic=False, dtype=torch.float64):
    kw = dict(DENSE, mesh=pt.make_mesh(int(topo[4:]), "cpu")) if topo != "serial" else \
        dict(device="cpu")
    model = pt.Navier2D(nx, ny, *PARAMS, "rbc", periodic=periodic, dtype=dtype, **kw)
    model.write_intervall = 1e9
    return model


def _jax(nx=33, ny=32, topo="serial", periodic=False):
    mesh = jax_make_mesh(jax.devices()[: int(topo[4:])]) if topo != "serial" else None
    model = rp.Navier2D(nx, ny, *PARAMS, "rbc", periodic, mesh=mesh)
    model.write_intervall = 1e9
    return model


def _random_state(model, seed):
    """Random leaves (every one nonzero, ``pseu`` too) in the model's
    spectral shapes, as global numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, space in model._state_fields():
        shape = space.shape_spectral
        a = rng.standard_normal(shape)
        out[name] = a + 1j * rng.standard_normal(shape) if space.spectral_is_complex else a
    return out


def _set_jax(jmodel, arrays):
    with jmodel._scope():
        jmodel.state = jmodel.state._replace(**{
            k: jax.device_put(np.asarray(v), getattr(jmodel.state, k).sharding)
            for k, v in arrays.items()})


def _leaves(model):
    return pt.convert.state_to_numpy(model)


def _ens_leaves(ens):
    """An ensemble's leaves as global ``(K, ...)`` numpy arrays."""
    spaces = dict(ens.model._state_fields())
    return {k: np.stack([spaces[k].gather_spectral(m).numpy() for m in getattr(ens.state, k)])
            for k in ens.state._fields}


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


# -- across the packages -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """A JAX model on 4 virtual devices with a random state, written
    sharded (its slabs follow the JAX sharding)."""
    jmodel = _jax(topo="mesh4")
    arrays = _random_state(_port(), 1)
    _set_jax(jmodel, arrays)
    jmodel.time = 0.37
    path = jck.checkpoint_path(str(tmp_path_factory.mktemp("jax")), 4)
    stats = jck.write_sharded_snapshot(jmodel, path, step=4)
    assert stats["ok"]
    return arrays, path


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_a_jax_manifest_reads_into_the_port_bit_for_bit(jax_written, topo):
    arrays, path = jax_written
    assert int(tck.verify_snapshot(path)["sharded"]) == 1
    model = _port(topo=topo)
    model.read(path)
    _assert_equal(_leaves(model), arrays)
    assert model.time == 0.37


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_a_port_manifest_reads_into_jax_bit_for_bit(tmp_path, topo):
    model = _port(topo=topo)
    arrays = _random_state(model, 2)
    pt.convert.state_from_numpy(model, arrays)
    model.time = 0.5
    path = tck.checkpoint_path(str(tmp_path), 7)
    stats = tck.write_sharded_snapshot(model, path, step=7)
    assert stats["ok"] and stats["shards"] == 1 and stats["bytes_host"] > 0
    assert int(jck.verify_snapshot(path)["step"]) == 7
    for jtopo in ("serial", "mesh2"):
        jmodel = _jax(topo=jtopo)
        jmodel.read(path)
        _assert_equal({k: np.asarray(getattr(jmodel.state, k)) for k in arrays}, arrays)
        assert jmodel.time == 0.5


@pytest.mark.parametrize("case", ["confined", "periodic"])
def test_serial_manifests_are_the_same_bytes_in_both_packages(tmp_path, case):
    """One state written serially by each package: the shards and the
    manifests hash to the same content digest (the periodic cell's complex
    state through ``convert.py``, as the gathered format)."""
    nx, periodic = (16, True) if case == "periodic" else (17, False)
    model, jmodel = _port(nx, 17, periodic=periodic), _jax(nx, 17, periodic=periodic)
    arrays = _random_state(model, 3)
    pt.convert.state_from_numpy(model, arrays)
    _set_jax(jmodel, arrays)
    model.time = jmodel.time = 0.25
    tpath = tck.checkpoint_path(str(tmp_path / "t"), 2)
    jpath = jck.checkpoint_path(str(tmp_path / "j"), 2)
    tck.write_sharded_snapshot(model, tpath, step=2)
    jck.write_sharded_snapshot(jmodel, jpath, step=2)
    tattrs, jattrs = tck.read_attrs(tpath), tck.read_attrs(jpath)
    assert tattrs["digest"] == jattrs["digest"]
    for ts, js in zip(tck.checkpoint_shard_files(tpath), tck.checkpoint_shard_files(jpath)):
        assert tck.read_attrs(ts)["digest"] == tck.read_attrs(js)["digest"]


def test_an_ensemble_of_three_both_ways(tmp_path):
    jens = rp.NavierEnsemble.from_seeds(_jax(17, 17), seeds=range(3))
    jpath = jck.checkpoint_path(str(tmp_path / "j"), 4)
    jck.write_sharded_snapshot(jens, jpath, step=4)
    want = {k: np.asarray(getattr(jens.state, k)) for k in jens.state._fields}
    for topo in ("serial", "mesh2"):
        ens = pt.NavierEnsemble.from_seeds(_port(17, 17, topo=topo), range(5, 8))
        ens.read(jpath)
        _assert_equal(_ens_leaves(ens), want)
        assert (ens.alive() == jens.alive()).all()
        np.testing.assert_array_equal(ens.steps_done.numpy(), np.asarray(jens.steps_done))
    # the reverse: a meshed port ensemble read by the JAX one
    ens = pt.NavierEnsemble.from_seeds(_port(17, 17, topo="mesh2"), range(3))
    ens.mark_dead([1])
    tpath = tck.checkpoint_path(str(tmp_path / "t"), 4)
    tck.write_sharded_snapshot(ens, tpath, step=4)
    jens2 = rp.NavierEnsemble.from_seeds(_jax(17, 17), seeds=range(6, 9))
    jens2.read(tpath)
    _assert_equal({k: np.asarray(getattr(jens2.state, k)) for k in want}, _ens_leaves(ens))
    assert (jens2.alive() == np.array([True, False, True])).all()
    # a member-count mismatch is refused with its own message
    with pytest.raises(tck.CheckpointError, match="members"):
        pt.NavierEnsemble.from_seeds(_port(17, 17), range(2)).read(tpath)


# -- the port's own matrix -----------------------------------------------------------


@pytest.mark.parametrize("writer", TOPOLOGIES)
def test_the_elastic_matrix(tmp_path, writer):
    """Written on serial, 2 or 4 ranks, read onto each of them, bit for bit;
    the 2-rank reader then steps as the writer does."""
    model = _port(topo=writer)
    model.init_random(0.1, seed=4)
    model.update_n(2)
    path = tck.checkpoint_path(str(tmp_path), 2)
    tck.write_sharded_snapshot(model, path, step=2)
    want = _leaves(model)
    targets = {}
    for reader in TOPOLOGIES:
        targets[reader] = target = _port(topo=reader)
        target.read(path)
        _assert_equal(_leaves(target), want)
        assert target.time == model.time
    if writer != "serial":  # the meshed routes step alike on any rank count
        model.update_n(2)
        targets["mesh2"].update_n(2)
        _assert_equal(_leaves(targets["mesh2"]), _leaves(model))


def test_the_in_memory_catalog_restores_as_the_files(tmp_path):
    model = _port(topo="mesh4")
    model.init_random(0.1, seed=5)
    snap = tck.sharded_snapshot_to_host(model, step=1)
    digest = tck.stage_shard_digest(snap)
    path = tck.checkpoint_path(str(tmp_path), 1)
    tck.write_shard_file(tck.sharded_snapshot_to_host(model, step=1), path)
    assert tck.read_attrs(tck.shard_path(path, 0))["digest"] == digest
    for topo in TOPOLOGIES:
        target = _port(topo=topo)
        tck.restore_sharded_snapshots(target, [snap])
        _assert_equal(_leaves(target), _leaves(model))
    snap.slabs[0][2][0, 0] += 1.0  # a flipped value no longer hashes to its digest
    with pytest.raises(tck.CheckpointError, match="digest mismatch"):
        tck.restore_sharded_snapshots(_port(), [snap])


def test_statistics_and_the_integrity_digest_ride_the_manifest(tmp_path):
    def armed():
        m = _port(17, 17)
        m.set_stats(StatsConfig(stride=2))
        m.set_integrity(IntegrityConfig())
        return m

    model = armed()
    model.init_random(0.1, seed=6)
    model.update_n(5)
    names = [n for n, _ in model.snapshot_state_items()]
    assert "stats/t_sum" in names and names[-1] == "stats/tick"
    assert [r[0] for r in model.snapshot_root_items()][-1] == "integrity_digest"
    path = tck.checkpoint_path(str(tmp_path), 5)
    tck.write_sharded_snapshot(model, path, step=5)
    target = armed()
    target.read(path)  # the digest is recomputed and verified
    for a, b in zip(model.stats_state, target.stats_state):
        assert torch.equal(a, b)
    assert torch.equal(model._stats_tick, target._stats_tick)
    # an unarmed reader restarts the window; a tampered digest is caught
    plain = _port(17, 17)
    plain.read(path)
    _assert_equal(_leaves(plain), _leaves(model))
    snap = tck.sharded_snapshot_to_host(model, step=5)
    snap.root_datasets = [(p, d + 1 if p == "integrity_digest" else d, k)
                          for p, d, k in snap.root_datasets]
    with pytest.raises(IntegrityError, match="does not match"):
        tck.restore_sharded_snapshots(armed(), [snap])


def test_resolution_and_dtype_mismatches_are_refused(tmp_path):
    model = _port(17, 17)
    path = tck.checkpoint_path(str(tmp_path), 1)
    tck.write_sharded_snapshot(model, path, step=1)
    with pytest.raises(tck.CheckpointError, match="resolution-fixed"):
        _port(33, 32).read(path)
    with pytest.raises(tck.CheckpointError, match="precision mode mismatch"):
        _port(17, 17, dtype=torch.float32).read(path)


def test_a_corrupt_or_missing_shard_fails_the_whole_checkpoint(tmp_path):
    model = _port(17, 17, topo="mesh2")
    model.init_random(0.1, seed=7)
    good = tck.checkpoint_path(str(tmp_path), 2)
    tck.write_sharded_snapshot(model, good, step=2)
    bad = tck.checkpoint_path(str(tmp_path), 4)
    tck.write_sharded_snapshot(model, bad, step=4)
    shard = tck.checkpoint_shard_files(bad)[0]
    with h5py.File(shard, "r+") as h5:
        grp = h5["state/temp"]
        name = next(iter(grp))
        grp[name][(0,) * grp[name].ndim] = 1e9  # bit rot inside one slab
    for mod in (tck, jck):
        with pytest.raises(mod.CheckpointError, match="shard .* digest mismatch"):
            mod.verify_snapshot(bad)
    with pytest.raises(tck.CheckpointError):
        _port(17, 17).read(bad)
    assert tck.latest_checkpoint(str(tmp_path)) == good
    os.remove(shard)
    with pytest.raises(tck.CheckpointError, match="missing shard"):
        tck.verify_snapshot(bad)
    os.remove(bad)  # a shard set without its manifest is invisible
    assert tck.latest_checkpoint(str(tmp_path)) == good


def test_rotation_removes_shard_sets_and_orphans(tmp_path):
    model = _port(17, 17)
    for step in range(5):
        tck.write_sharded_snapshot(model, tck.checkpoint_path(str(tmp_path), step), step=step)
    orphan = tck.shard_path(tck.checkpoint_path(str(tmp_path), 0), 7)
    open(orphan, "w").close()
    os.remove(tck.checkpoint_path(str(tmp_path), 0))
    removed = tck.rotate_checkpoints(str(tmp_path), keep=2)
    assert [os.path.basename(p) for p in removed] == ["ckpt_0000000001.h5", "ckpt_0000000002.h5"]
    assert sorted(os.listdir(str(tmp_path))) == [
        "ckpt_0000000003.h5", "ckpt_0000000003.h5.shard0",
        "ckpt_0000000004.h5", "ckpt_0000000004.h5.shard0"]
    for step in (3, 4):
        jck.verify_snapshot(tck.checkpoint_path(str(tmp_path), step))


# -- the runner's sharded path -------------------------------------------------------


def _runner(run_dir, io, **kw):
    model = _port(17, 17)
    model.set_velocity(0.1, 1.0, 1.0)
    model.set_temperature(0.1, 1.0, 1.0)
    return pt.ResilientRunner(model, max_time=kw.pop("max_time", 0.2), save_intervall=0.05,
                              run_dir=run_dir, checkpoint_every_s=None, io=io, **kw)


def _events(run_dir):
    return read_journal(os.path.join(run_dir, "journal.jsonl"))


def test_runner_sharded_overlapped_matches_blocking(tmp_path):
    def run(io, sub):
        run_dir = str(tmp_path / sub)
        summary = _runner(run_dir, io, checkpoint_every_t=0.05).run()
        assert summary["outcome"] == "done"
        return summary, run_dir

    s_async, rd_async = run(IOConfig(sharded_checkpoints=True), "overlapped")
    s_block, rd_block = run(IOConfig(async_checkpoints=False, overlap_dispatch=False, diag_lag=0,
                                     sharded_checkpoints=True), "blocking")
    assert s_async["nu"] == s_block["nu"]
    assert tck.verify_snapshot(s_async["checkpoint"])["digest"] == \
        tck.verify_snapshot(s_block["checkpoint"])["digest"]
    shards_a = tck.checkpoint_shard_files(s_async["checkpoint"])
    shards_b = tck.checkpoint_shard_files(s_block["checkpoint"])
    assert len(shards_a) == len(shards_b) == 1
    assert tck.read_attrs(shards_a[0])["digest"] == tck.read_attrs(shards_b[0])["digest"]
    ev = _events(rd_async)
    async_commits = [e for e in ev if e.get("checkpoint_sharded") and e.get("async")]
    assert async_commits, [e["event"] for e in ev]
    row = async_commits[0]["checkpoint_sharded"]
    assert row["shards"] == 1 and row["bytes_host"] > 0 and "barrier_s" in row
    assert next(e for e in ev if e["event"] == "start")["io"]["sharded_checkpoints"] is True
    assert not any(e["event"] == "checkpoint_failed" for e in ev)
    jck.verify_snapshot(s_block["checkpoint"])  # the JAX reader verifies it too


def test_runner_sharded_nan_rollback_and_resume(tmp_path):
    summary = _runner(str(tmp_path / "nan"), IOConfig(sharded_checkpoints=True), max_retries=2,
                      fault="nan@6").run()
    assert summary["outcome"] == "done" and summary["retries"] == 1
    assert np.isfinite(summary["nu"])
    assert int(tck.verify_snapshot(summary["checkpoint"])["sharded"]) == 1
    run_dir = str(tmp_path / "kill")
    r1 = _runner(run_dir, IOConfig(sharded_checkpoints=True), max_time=0.3, fault="kill@12")
    assert r1.run()["outcome"] == "preempted"
    s2 = _runner(run_dir, IOConfig(sharded_checkpoints=True), max_time=0.3).run()
    assert s2["outcome"] == "done" and s2["step"] == 30
    assert any(e["event"] == "resumed" for e in _events(run_dir))


def test_runner_sharded_on_the_memory_store(tmp_path):
    """The card's store (no ``h5py`` there): the same sharded path, the
    checkpoints staged in memory; a NaN rolls back to one bit for bit."""
    run_dir = str(tmp_path)
    store = tres._MemoryStore(run_dir)
    runner = _runner(run_dir, IOConfig(sharded_checkpoints=True), fault="nan@6",
                     checkpoint_every_t=0.05, _store=store)
    summary = runner.run()
    assert summary["outcome"] == "done" and summary["retries"] == 1
    assert all(isinstance(store._snaps[p][0], tck.ShardSnapshot) for p in store.files())
    assert store.attrs(store.latest())["sharded"] == 1
    assert not any(f.startswith("ckpt_") for f in os.listdir(run_dir))


def test_runner_sharded_on_npz_files(tmp_path):
    """The durable store where ``h5py`` does not import: the same sharded
    path with each staged shard also an ``.npz`` file; a NaN rolls back to
    one, and a store opened later on the directory finds the same newest
    checkpoint with the same digest and restores it bit for bit."""
    run_dir = str(tmp_path)
    store = tres._NpzStore(run_dir)
    runner = _runner(run_dir, IOConfig(sharded_checkpoints=True), fault="nan@6",
                     checkpoint_every_t=0.05, _store=store)
    summary = runner.run()
    assert summary["outcome"] == "done" and summary["retries"] == 1
    names = sorted(n for n in os.listdir(run_dir) if n.startswith("ckpt_"))
    assert names and all(n.endswith(".npz") for n in names)
    reread = tres._NpzStore(run_dir)
    assert reread.files() == store.files()
    latest = store.latest()
    assert reread.latest() == latest and reread.attrs(latest) == store.attrs(latest)
    assert reread.root_data(latest).keys() == store.root_data(latest).keys()
    a, b = _port(17, 17), _port(17, 17)
    store.restore(a, latest)
    reread.restore(b, latest)
    assert all(torch.equal(x, y) for x, y in zip(a.state, b.state))


@pytest.mark.parametrize("crash", ["after_shard@10:host1", "before_manifest@10:host0"])
def test_two_process_crash_in_the_commit_window_then_resume(tmp_path, crash):
    """Two processes, a cadence checkpoint every 5 steps; one dies inside the
    step-10 commit window (host 1 after its shard landed; the root before
    the manifest: only the root reaches that point).  No manifest for step
    10 appears, the survivor exits nonzero, a rerun resumes from step 5 and
    ends bit for bit where an uninterrupted run ends."""
    out_dir = str(tmp_path)
    run_dir = os.path.join(out_dir, "run")
    results = spawn(out_dir, "sharded_run", crash, timeout=60.0)
    dead = int(crash[-1])
    assert results[dead][0] == 9, results[dead][2][-2000:]
    assert results[1 - dead][0] != 0
    assert not os.path.exists(tck.checkpoint_path(run_dir, 10))
    latest = tck.latest_checkpoint(run_dir)
    attrs = tck.verify_snapshot(latest)
    assert int(attrs["step"]) == 5 and int(attrs["sharded"]) == 2
    for rc, _, err, res in spawn(out_dir, "sharded_run", "", timeout=60.0):
        assert rc == 0, err[-3000:]
        assert res["outcome"] == "done" and res["step"] == 20 and res["resumed"]
        assert res["desyncs"] == 0
    events = read_journal(os.path.join(run_dir, "journal.jsonl"), on_error="skip")
    assert [e["step"] for e in events if e["event"] == "resumed"][-1] == 5
    row = [e for e in events if e.get("checkpoint_sharded")][-1]["checkpoint_sharded"]
    assert row["shards"] == 2 and row["bytes_host"] > 0
    ref = _port(17, 17)
    ref.set_velocity(0.1, 1.0, 1.0)
    ref.set_temperature(0.1, 1.0, 1.0)
    ref.update_n(20)
    dumped = np.load(os.path.join(out_dir, "final_state.npz"))
    for name, leaf in zip(ref.state._fields, ref.state):
        np.testing.assert_array_equal(dumped[name], leaf.numpy(), err_msg=name)
    # the final manifest, written by two processes, restores onto 2 ranks
    target = _port(17, 17, topo="mesh2")
    target.read(os.path.join(run_dir, "ckpt_0000000020.h5"))
    _assert_equal(_leaves(target), _leaves(ref))
    with open(os.path.join(out_dir, "result_0.json")) as fh:
        assert json.load(fh)["checkpoint"].endswith("ckpt_0000000020.h5")

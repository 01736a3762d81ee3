"""PyTorch port: checkpoints and restart in the reference's HDF5 layout
against the JAX package, on the CPU.

The port writes and reads the JAX package's gathered snapshot files
dataset for dataset.  Here, at 17^2 (16x17 periodic), on the confined
(fused route), periodic, HC, scenario (Coriolis and a passive scalar)
and meshed (4 ranks, confined and periodic) models and an ensemble of
K = 3:

* a file the port writes is read and digest-verified by the JAX package,
  and a file the JAX package writes by the port; the restored stored
  leaves are bit for bit the writer's; both packages' files of one state
  have the same dataset paths, shapes, dtypes and root attrs, every
  dataset bit for bit equal except the backward transforms ``v`` and the
  BC lift's coefficients ``tempbc/vhat`` (each package's own transform of
  the lift profile, with its own summation order), which agree to 1e-12
  of their scale;
* both packages restart from one file and step 5 (dense route; the
  meshed model on its own) to 1e-11 of each field's scale, at the file's
  resolution and at another (17^2 -> 25^2 and 33^2, periodic 16 -> 32,
  the r2c parity flip 16 -> 17), where the restored coefficients are bit
  for bit the JAX package's;
* durability: a truncated file, a missing group and a sharded manifest
  raise ``CheckpointError``, ``latest_checkpoint`` skips a corrupt file,
  ``rotate_checkpoints`` removes what the JAX one removes;
* the in-memory restore of a staged snapshot equals the file's, and a
  process without ``h5py`` stages, digests and restores;
* the callback writes the JAX callback's files and ``info.txt`` rows;
* ``slice_io`` pencils and ``tools/xdmf.py`` sidecars across packages.
"""

import gc
import os
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu.parallel.decomp import Decomp2d as JaxDecomp2d
from rustpde_mpi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rustpde_mpi_tpu.tools import xdmf as jxdmf
from rustpde_mpi_tpu.utils import checkpoint as jck
from rustpde_mpi_tpu.utils import slice_io as jslice
from rustpde_mpi_tpu.utils.integrate import integrate as jintegrate
from rustpde_mpi_tpu.workloads import ScenarioConfig as JaxScenarioConfig

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.tools import xdmf as txdmf
from rustpde_mpi_tpu_torch.utils import checkpoint as tck
from rustpde_mpi_tpu_torch.utils import slice_io as tslice
from rustpde_mpi_tpu_torch.utils.integrate import integrate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = (1e4, 1.0, 1e-2, 1.0)
DENSE = dict(step_kernel="dense", conv_kernel="dense")
SCN = dict(coriolis=2.0, passive_scalar=True)
#: case -> (grid, model arguments; ``mesh``: the port's ranks, the JAX
#: model is serial)
CASES = {
    "confined": ((17, 17), {}),
    "periodic": ((16, 17), {"periodic": True}),
    "hc": ((17, 17), {"bc": "hc"}),
    "scenario": ((17, 17), {"scenario": SCN}),
    "mesh": ((17, 17), {"mesh": 4}),
    "periodic_mesh": ((16, 17), {"periodic": True, "mesh": 4}),
}
STEPS = 3
CONTINUE = 5
TOL = 1e-11
V_TOL = 1e-12
K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread (tiny grids); drop the JAX objects this module
    built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _port(case, grid=None, **extra):
    (nx, ny), kw = CASES[case]
    nx, ny = grid or (nx, ny)
    kw = dict(kw, **extra)
    if "scenario" in kw:
        kw["scenario"] = pt.ScenarioConfig(**kw["scenario"])
    if "mesh" in kw:
        kw["mesh"] = pt.make_mesh(kw["mesh"], "cpu")
    else:
        kw["device"] = "cpu"
    return pt.Navier2D(nx, ny, *PARAMS, **kw)


def _jax(case, grid=None):
    (nx, ny), kw = CASES[case]
    nx, ny = grid or (nx, ny)
    kw = {k: v for k, v in kw.items() if k != "mesh"}
    bc, periodic = kw.pop("bc", "rbc"), kw.pop("periodic", False)
    if "scenario" in kw:
        kw["scenario"] = JaxScenarioConfig(**kw["scenario"])
    return rp.Navier2D(nx, ny, *PARAMS, bc, periodic, **kw)


def _port_leaves(model):
    """The snapshot leaves of a port model as global numpy arrays."""
    return {attr: getattr(model, f"{attr}_space").gather_spectral(getattr(model.state, attr)).numpy()
            for _, attr in model.snapshot_vars}


def _jax_leaves(model):
    return {attr: np.asarray(getattr(model.state, attr)) for _, attr in model.snapshot_vars}


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as h5:
        h5.visititems(lambda n, o: out.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset)
                      else None)
        attrs = dict(h5.attrs)
    return out, attrs


def _derived(name):
    """Datasets each package computes with its own transforms: ``v``, and
    the BC lift's coefficients."""
    return name.rsplit("/", 1)[-1] == "v" or name.startswith("tempbc/vhat")


def _assert_same_files(port_file, jax_file):
    got, got_attrs = _datasets(port_file)
    want, want_attrs = _datasets(jax_file)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if _derived(name):
            scale = max(float(np.max(np.abs(w))), 1e-300)
            assert float(np.max(np.abs(g - w))) <= V_TOL * scale, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert sorted(got_attrs) == sorted(want_attrs)
    for key, val in want_attrs.items():
        if key != "digest":
            assert got_attrs[key] == val and type(got_attrs[key]) is type(val), key


def _assert_close(got: dict, want: dict, tol):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = max(float(np.max(np.abs(w))), 1e-300)
        err = float(np.max(np.abs(got[name] - w)))
        assert err <= tol * scale, (name, err / scale)


def _assert_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Per case, built on first use: the port's stepped writer model and
    its file, the JAX model that read it and the JAX file it wrote, and
    the port model that read the JAX file."""
    root = tmp_path_factory.mktemp("ckpt")
    cache = {}

    def get(case):
        if case not in cache:
            writer = _port(case)
            writer.init_random(0.1, seed=1)
            writer.update_n(STEPS)
            port_file, jax_file = str(root / f"{case}_port.h5"), str(root / f"{case}_jax.h5")
            writer.write(port_file)
            jmodel = _jax(case)
            jmodel.read(port_file)
            jmodel.write(jax_file)
            reader = _port(case)
            reader.read(jax_file)
            cache[case] = dict(writer=writer, port_file=port_file, jax=jmodel,
                               jax_file=jax_file, reader=reader)
        return cache[case]

    return get


# -- files across packages ---------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_files_cross_packages(files, case, capsys):
    f = files(case)
    writer, jmodel, reader = f["writer"], f["jax"], f["reader"]
    # each package verifies the other's file
    assert jck.verify_snapshot(f["port_file"])["schema"] == 1
    assert tck.verify_snapshot(f["jax_file"])["schema"] == 1
    # the restored stored leaves are the writer's, bit for bit
    want = _port_leaves(writer)
    _assert_equal(_jax_leaves(jmodel), want)
    _assert_equal(_port_leaves(reader), want)
    assert float(reader.state.pseu.abs().max()) == 0.0
    assert reader.time == jmodel.time == writer.time == pytest.approx(STEPS * PARAMS[2])
    _assert_same_files(f["port_file"], f["jax_file"])
    capsys.readouterr()


@pytest.mark.parametrize("case", sorted(CASES))
def test_restart_continues_as_the_jax_package(files, case, capsys):
    f = files(case)
    port = _port(case, **({} if "mesh" in CASES[case][1] else DENSE))
    port.read(f["port_file"])
    jmodel = _jax(case)
    jmodel.read(f["port_file"])
    port.update_n(CONTINUE)
    jmodel.update_n(CONTINUE)
    want = {name: np.asarray(getattr(jmodel.state, name)) for name in jmodel.state._fields}
    got = {name: space.gather_spectral(getattr(port.state, name)).numpy()
           for name, space in port._state_fields()}
    _assert_close(got, want, TOL)
    assert port.time == pytest.approx(jmodel.time)
    capsys.readouterr()


RESOLUTIONS = {
    "confined_25": ("confined", (25, 25)),
    "confined_33": ("confined", (33, 33)),
    "periodic_32": ("periodic", (32, 17)),
    "parity_flip_17": ("periodic", (17, 17)),
}


@pytest.mark.parametrize("target", sorted(RESOLUTIONS))
def test_resolution_change_matches_jax_package(files, target, capsys):
    case, grid = RESOLUTIONS[target]
    source = files(case)["port_file"]
    port = _port(case, grid, **DENSE)
    port.read(source)
    jmodel = _jax(case, grid)
    jmodel.read(source)
    _assert_equal(_port_leaves(port), _jax_leaves(jmodel))
    port.update_n(CONTINUE)
    jmodel.update_n(CONTINUE)
    want = {name: np.asarray(getattr(jmodel.state, name)) for name in jmodel.state._fields}
    _assert_close({name: getattr(port.state, name).numpy() for name in want}, want, TOL)
    capsys.readouterr()


def test_interpolate_2d_matches_jax_package():
    rng = np.random.default_rng(3)
    old = rng.standard_normal((9, 15)) + 1j * rng.standard_normal((9, 15))
    for shape, old_nx, new_nx in (((9, 15), 16, 17), ((17, 20), 16, 32), ((5, 7), 17, 8),
                                  ((9, 15), 17, 16)):
        got = tck.interpolate_2d(old, shape, pt.BaseKind.FOURIER_R2C, old_nx, new_nx)
        want = jck.interpolate_2d(old, shape, rp.bases.BaseKind.FOURIER_R2C, old_nx, new_nx)
        np.testing.assert_array_equal(got, want)
    real = rng.standard_normal((15, 15))
    np.testing.assert_array_equal(
        tck.interpolate_2d(real, (23, 10), pt.BaseKind.CHEB_DIRICHLET),
        jck.interpolate_2d(real, (23, 10), rp.bases.BaseKind.CHEB_DIRICHLET))


# -- ensembles ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def ens_files(tmp_path_factory):
    """A port ensemble of K = 3 on the dense route, stepped, its file, the
    JAX ensemble that read it and the file that one wrote."""
    root = tmp_path_factory.mktemp("ens")
    port = pt.NavierEnsemble.from_seeds(_port("confined", **DENSE), range(K))
    port.update_n(STEPS)
    port.mark_dead([2])
    port_file, jax_file = str(root / "ens_port.h5"), str(root / "ens_jax.h5")
    port.write(port_file)
    jens = rp.NavierEnsemble.from_seeds(_jax("confined"), seeds=[5])
    jens.read(port_file)
    jens.write(jax_file)
    return dict(port=port, port_file=port_file, jax=jens, jax_file=jax_file)


def _port_members(ens):
    """Every member's fields as global numpy arrays, stacked on K."""
    return {f: np.stack([space.gather_spectral(getattr(ens.state, f)[i]).numpy()
                         for i in range(ens.k)])
            for f, space in ens.model._state_fields()}


def test_ensemble_files_cross_packages(ens_files, capsys):
    port, jens = ens_files["port"], ens_files["jax"]
    assert jck.verify_snapshot(ens_files["port_file"])
    assert tck.verify_snapshot(ens_files["jax_file"])
    assert jens.k == K
    assert np.asarray(jens.mask).tolist() == port.alive().tolist() == [True, True, False]
    assert np.asarray(jens.steps_done).tolist() == port.steps_done.tolist() == [STEPS] * K
    assert jens.time == port.time
    want = _port_members(port)
    for _, attr in port.model.snapshot_vars:
        np.testing.assert_array_equal(np.asarray(getattr(jens.state, attr)), want[attr])
    _assert_same_files(ens_files["port_file"], ens_files["jax_file"])
    # the port reads the JAX file into an ensemble of another K
    back = pt.NavierEnsemble.from_seeds(_port("confined", **DENSE), range(2))
    back.read(ens_files["jax_file"])
    assert back.k == K and back.steps_done.dtype == torch.int32
    assert back.alive().tolist() == [True, True, False]
    assert back.steps_done.tolist() == [STEPS] * K
    got = _port_members(back)
    for _, attr in port.model.snapshot_vars:
        np.testing.assert_array_equal(got[attr], want[attr])
    assert float(back.state.pseu.abs().max()) == 0.0
    root = _datasets(ens_files["port_file"])[0]
    assert root["alive"].dtype == np.int8 and root["steps_done"].dtype == np.int64
    assert root["members"].dtype == np.int64 and root["time"].dtype == np.float64
    capsys.readouterr()


def test_ensemble_restart_continues_as_the_jax_package(ens_files, capsys):
    port = pt.NavierEnsemble.from_seeds(_port("confined", **DENSE), range(2))
    runner = port.chunk_runner()
    port.read(ens_files["port_file"])
    assert port.k == K and not port._runners  # another K: the chunks are rebuilt
    jens = rp.NavierEnsemble.from_seeds(_jax("confined"), seeds=[7])
    jens.read(ens_files["port_file"])
    port.update_n(CONTINUE)
    jens.update_n(CONTINUE)
    assert port.chunk_runner() is not runner
    assert port.steps_done.tolist() == np.asarray(jens.steps_done).tolist() == \
        [STEPS + CONTINUE] * 2 + [STEPS]
    want = {f: np.asarray(getattr(jens.state, f)) for f in jens.state._fields}
    _assert_close(_port_members(port), want, TOL)
    capsys.readouterr()


def test_scenario_ensemble_restore_at_another_k_recaptures(tmp_path, capsys):
    model = _port("scenario")
    src = pt.NavierEnsemble.from_seeds(model, range(3))
    src.update_n(2)
    fname = str(tmp_path / "scn.h5")
    src.write(fname)
    with h5py.File(fname, "r") as h5:
        assert "member2/scal/vhat" in h5
    dst = pt.NavierEnsemble.from_seeds(model, range(2))
    dst.update_n(1)
    assert dst._runners
    dst.read(fname)
    assert dst.k == 3 and not dst._runners
    for f in ("temp", "scal", "velx"):
        assert torch.equal(getattr(dst.state, f), getattr(src.state, f))
    dst.update_n(2)
    src.update_n(2)
    for x, y in zip(dst.state[:4], src.state[:4]):
        assert torch.equal(x, y)
    capsys.readouterr()


def test_same_shape_restore_keeps_the_captured_chunks(files, capsys):
    f = files("confined")
    model = _port("confined")
    model.init_random(0.1, seed=4)
    runner = model.chunk_runner()
    model.read(f["port_file"])
    assert model.chunk_runner() is runner
    fresh = _port("confined")
    fresh.read(f["port_file"])
    model.update_n(CONTINUE)
    fresh.update_n(CONTINUE)
    for x, y in zip(model.state, fresh.state):
        assert torch.equal(x, y)
    capsys.readouterr()


# -- staging in memory, and no h5py ---------------------------------------------------


@pytest.mark.parametrize("case", ["confined", "periodic_mesh", "scenario"])
def test_host_snapshot_restores_as_its_file(files, case, tmp_path, capsys):
    writer = files(case)["writer"]
    snap = tck.snapshot_to_host(writer, step=7)
    fname = str(tmp_path / "snap.h5")
    tck.write_host_snapshot(snap, fname)
    with h5py.File(fname, "r") as h5:
        assert h5.attrs["digest"] == tck.snapshot_digest(snap.datasets) == tck.content_digest(h5)
        assert int(h5.attrs["step"]) == 7
    assert snap.nbytes == sum(int(np.asarray(d).nbytes) for _, d, _ in snap.datasets)
    from_file, from_memory = _port(case), _port(case)
    from_file.read(fname)
    tck._restore_snapshot(from_memory, tck._host_group(snap))
    for x, y in zip(from_file.state, from_memory.state):
        assert torch.equal(x, y)
    assert from_file.time == from_memory.time == writer.time
    capsys.readouterr()


def test_ensemble_host_snapshot_restores_as_its_file(ens_files, capsys):
    snap = tck.ensemble_snapshot_to_host(ens_files["port"])
    a = pt.NavierEnsemble.from_seeds(_port("confined", **DENSE), [0])
    b = pt.NavierEnsemble.from_seeds(_port("confined", **DENSE), [0])
    a.read(ens_files["port_file"])
    tck._restore_ensemble_snapshot(b, tck._host_group(snap))
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert torch.equal(a.mask, b.mask) and torch.equal(a.steps_done, b.steps_done)
    with h5py.File(ens_files["port_file"], "r") as h5:
        assert h5.attrs["digest"] == tck.snapshot_digest(snap.datasets)
    capsys.readouterr()


NO_H5PY = """
import os, sys, tempfile
sys.modules["h5py"] = None
import torch
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.utils import checkpoint as ck
m = pt.Navier2D.new_confined(17, 17, 1e4, 1.0, 1e-2, 1.0, "rbc", device="cpu")
m.update_n(2)
snap = ck.snapshot_to_host(m)
digest = ck.snapshot_digest(snap.datasets)
m2 = pt.Navier2D(17, 17, 1e4, 1.0, 1e-2, 1.0, "rbc", device="cpu")
ck._restore_snapshot(m2, ck._host_group(snap))
assert all(torch.equal(a, b) for a, b in zip(m.state[:4], m2.state[:4])) and m2.time == m.time
ens = pt.NavierEnsemble.from_seeds(m, range(2))
esnap = ck.ensemble_snapshot_to_host(ens)
ens2 = pt.NavierEnsemble.from_seeds(m, range(3))
ck._restore_ensemble_snapshot(ens2, ck._host_group(esnap))
assert ens2.k == 2 and all(torch.equal(a, b) for a, b in zip(ens.state[:4], ens2.state[:4]))
os.chdir(tempfile.mkdtemp())
try:
    m.callback()
except ImportError:
    pass
else:
    raise SystemExit("a due snapshot without h5py did not raise ImportError")
m.write_intervall = 1e9
m.callback()
assert os.listdir("data") == ["info.txt"]
assert "h5py" not in [k for k, v in sys.modules.items() if v is not None]
print("ok", digest)
"""


def test_staging_and_restore_run_without_h5py():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", NO_H5PY], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[-1].startswith("ok ")


def test_port_modules_import_no_h5py():
    code = ("import importlib, pkgutil, sys\n"
            "import rustpde_mpi_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'h5py' not in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# -- durability ----------------------------------------------------------------------


def test_truncated_file_and_missing_group_raise(files, tmp_path, capsys):
    src = files("confined")["port_file"]
    data = open(src, "rb").read()
    truncated = tmp_path / "truncated.h5"
    truncated.write_bytes(data[: len(data) // 2])
    model = _port("confined")
    for fn in (tck.verify_snapshot, lambda p: model.read(p)):
        with pytest.raises(tck.CheckpointError, match="truncated"):
            fn(str(truncated))
    # a missing group: the digest names the damage first, and without a
    # digest the reader names the group
    broken = tmp_path / "broken.h5"
    broken.write_bytes(data)
    with h5py.File(broken, "a") as h5:
        del h5["temp"]
    with pytest.raises(tck.CheckpointError, match="digest mismatch"):
        model.read(str(broken))
    with h5py.File(broken, "a") as h5:
        del h5.attrs["digest"]
    with pytest.raises(tck.CheckpointError, match="'/temp'"):
        model.read(str(broken))
    snap = tck.snapshot_to_host(files("confined")["writer"])
    snap.datasets = [d for d in snap.datasets if not d[0].startswith("uy/")]
    with pytest.raises(tck.CheckpointError, match="'/uy'"):
        tck._restore_snapshot(model, tck._host_group(snap))
    model.read_unwrap(str(truncated))
    assert "error while reading file" in capsys.readouterr().out


def test_sharded_manifest_is_refused(tmp_path):
    """A manifest that names no dataset is refused by the reader (the
    sharded format is ported: a real one reads back bit for bit)."""
    fname = str(tmp_path / "ckpt_0000000004.h5")
    with h5py.File(fname, "w") as h5:
        h5.create_dataset("sharded_manifest", data=np.bytes_("{}"))
        h5.create_dataset("time", data=np.float64(0.0))
        h5.attrs["sharded"] = 1
    assert tck.is_sharded_checkpoint(fname)
    assert int(tck.verify_snapshot(fname)["sharded"]) == 1  # an empty shard map verifies
    with pytest.raises(tck.CheckpointError, match="manifest lacks dataset 'state/temp'"):
        _port("confined").read(fname)
    writer = _port("confined")
    writer.update_n(2)
    good = str(tmp_path / "ckpt_0000000002.h5")
    tck.write_sharded_snapshot(writer, good, step=2)
    reader = _port("confined")
    reader.read(good)
    for a, b in zip(writer.state, reader.state):
        assert torch.equal(a, b)


def test_latest_checkpoint_skips_a_corrupt_file(files, tmp_path, capsys):
    writer = files("confined")["writer"]
    run = str(tmp_path / "run")
    for step in (10, 20):
        tck.write_snapshot(writer, tck.checkpoint_path(run, step), step=step)
    newest = tck.checkpoint_path(run, 20)
    with open(newest, "r+b") as fh:  # a copy cut short
        fh.truncate(os.path.getsize(newest) // 2)
    assert tck.latest_checkpoint(run) == jck.latest_checkpoint(run) == \
        tck.checkpoint_path(run, 10)
    assert "skipping corrupt checkpoint" in capsys.readouterr().out
    assert tck.read_attrs(tck.checkpoint_path(run, 10))["step"] == 10
    assert tck.read_root_data(tck.checkpoint_path(run, 10))["ra"] == PARAMS[0]


def _rotation_dir(path):
    os.makedirs(path)
    names = [f"ckpt_{s:010d}.h5" for s in (1, 2, 3, 4, 5)]
    names += ["ckpt_0000000002.h5.shard0", "ckpt_0000000002.h5.shard1",  # a sharded set
              "ckpt_0000000000.h5.shard0",  # an orphan below the window
              "ckpt_0000000009.h5.shard0",  # an orphan above it (a write in flight)
              "ckpt_0000000003.h5.1234.tmp", "notes.txt"]
    for name in names:
        with open(os.path.join(path, name), "w") as fh:
            fh.write(name)


def test_rotate_checkpoints_matches_jax_package(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _rotation_dir(a)
    _rotation_dir(b)
    got = [os.path.basename(p) for p in tck.rotate_checkpoints(a, 2)]
    want = [os.path.basename(p) for p in jck.rotate_checkpoints(b, 2)]
    assert got == want == [f"ckpt_{s:010d}.h5" for s in (1, 2, 3)]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert "ckpt_0000000000.h5.shard0" not in os.listdir(a)
    assert "ckpt_0000000009.h5.shard0" in os.listdir(a)
    assert tck.rotate_checkpoints(a, 0) == []
    assert tck.checkpoint_files(a) == [os.path.join(a, f"ckpt_{s:010d}.h5") for s in (4, 5)]


# -- the callback --------------------------------------------------------------------


def test_callback_writes_the_jax_package_files(tmp_path, monkeypatch, capsys):
    runs = {}
    for lib in ("port", "jax"):
        workdir = tmp_path / lib
        workdir.mkdir()
        monkeypatch.chdir(workdir)
        if lib == "port":
            model = _port("confined", **DENSE)
            model.init_random(0.1)
            model.write_intervall = 0.02
            assert integrate(model, 0.05, 0.01) == "time_limit"
        else:
            model = _jax("confined")
            model.init_random(0.1)
            model.write_intervall = 0.02
            assert jintegrate(model, 0.05, 0.01) == "time_limit"
        rows = np.loadtxt(workdir / "data" / "info.txt")
        runs[lib] = (sorted(os.listdir(workdir / "data")), rows)
    assert runs["port"][0] == runs["jax"][0] == ["flow00000.02.h5", "flow00000.04.h5", "info.txt"]
    assert runs["port"][1].shape == (5, 4)
    np.testing.assert_allclose(runs["port"][1], runs["jax"][1], rtol=1e-11, atol=0)
    out = capsys.readouterr().out
    assert out.count("Nu =") == 10


def test_ensemble_callback_writes_the_jax_package_files(tmp_path, monkeypatch, capsys):
    names = {}
    for lib in ("port", "jax"):
        workdir = tmp_path / lib
        workdir.mkdir()
        monkeypatch.chdir(workdir)
        if lib == "port":
            ens = pt.NavierEnsemble.from_seeds(_port("confined", **DENSE), range(2))
            ens.write_intervall = 0.02
            integrate(ens, 0.04, 0.01)
        else:
            ens = rp.NavierEnsemble.from_seeds(_jax("confined"), seeds=range(2))
            ens.write_intervall = 0.02
            jintegrate(ens, 0.04, 0.01)
        names[lib] = sorted(os.listdir(workdir / "data"))
    assert names["port"] == names["jax"] == ["ensemble00000.02.h5", "ensemble00000.04.h5"]
    jck.verify_snapshot(str(tmp_path / "port" / "data" / "ensemble00000.04.h5"))
    capsys.readouterr()


# -- slabs and sidecars ----------------------------------------------------------------


def _jax_decomp(shape):
    return JaxDecomp2d(shape, jax_make_mesh(jax.devices()[:4]))


def test_pencils_cross_packages(files, tmp_path):
    model = files("periodic_mesh")["writer"]
    sp = model.temp_space
    phys = sp.backward(model.state.temp)  # a stacked y-pencil
    glob_phys = sp.gather_physical(phys).numpy()
    glob_spec = sp.gather_spectral(model.state.temp).numpy()  # complex
    fname = str(tmp_path / "pencils.h5")
    tslice.write_pencils(fname, "temp/v", phys, sp.physical, "y")
    tslice.write_pencils(fname, "temp/vhat", model.state.temp, sp.spectral, "x")
    jphys, jspec = _jax_decomp(glob_phys.shape), _jax_decomp(glob_spec.shape)
    for rank in range(4):
        p, q = jphys.y_pencil(rank), jspec.x_pencil(rank)
        sel = tuple(slice(s, s + n) for s, n in zip(p.st, p.sz))
        np.testing.assert_array_equal(jslice.read_pencil(fname, "temp/v", jphys, rank, "y"),
                                      glob_phys[sel])
        sel = tuple(slice(s, s + n) for s, n in zip(q.st, q.sz))
        np.testing.assert_array_equal(
            jslice.read_pencil(fname, "temp/vhat", jspec, rank, "x", is_complex=True),
            glob_spec[sel])
    # the other way: the JAX writer's slabs read by the port
    other = str(tmp_path / "jax_pencils.h5")
    jslice.write_pencils(other, "v", glob_phys, jphys, "y")
    full = np.concatenate([tslice.read_pencil(other, "v", sp.physical, r, "y") for r in range(4)])
    np.testing.assert_array_equal(full, glob_phys)
    # the concurrent writer: shard files under a virtual dataset
    conc = str(tmp_path / "concurrent.h5")
    tslice.write_pencils_concurrent(conc, "temp/v", phys, sp.physical, "y", max_workers=2)
    for rank in range(4):
        np.testing.assert_array_equal(jslice.read_pencil(conc, "temp/v", jphys, rank, "y"),
                                      tslice.read_pencil(fname, "temp/v", sp.physical, rank))
        with h5py.File(f"{conc}.temp_v.shard{rank}", "r") as h5:
            assert h5.attrs["digest"] == jck.snapshot_digest([("slab", h5["slab"][()], "raw")])
    # a global host array and single slabs
    tslice.write_slice(str(tmp_path / "s.h5"), "a", glob_spec[:3, :4], (2, 1), glob_spec.shape)
    np.testing.assert_array_equal(
        jslice.read_slice(str(tmp_path / "s.h5"), "a", (2, 1), (3, 4), is_complex=True),
        glob_spec[:3, :4])


def test_xdmf_sidecars_match_jax_package(files, tmp_path, capsys):
    dirs = {lib: tmp_path / lib for lib in ("port", "jax")}
    for d in dirs.values():
        d.mkdir()
    for i, case in enumerate(("confined", "hc")):
        for lib, d in dirs.items():
            model = _port(case) if lib == "port" else _jax(case)
            model.read(files(case)["port_file"])
            model.time = 0.01 * (i + 1)
            model.write(str(d / f"flow{model.time:08.2f}.h5"))
    written = {"port": txdmf.create_xmf(str(dirs["port"])),
               "jax": jxdmf.create_xmf(str(dirs["jax"]))}
    assert [os.path.basename(p) for p in written["port"]] == \
        [os.path.basename(p) for p in written["jax"]] == ["xmf000000.xmf", "xmf000001.xmf"]
    for a, b in zip(written["port"], written["jax"]):
        assert open(a).read() == open(b).read()
    for axis in ("x", "y"):
        with h5py.File(dirs["port"] / "cartesian.nc", "r") as pa, \
                h5py.File(dirs["jax"] / "cartesian.nc", "r") as ja:
            np.testing.assert_array_equal(pa[axis][()], ja[axis][()])
    assert txdmf.sorted_h5_files(str(dirs["port"]))[0][0] == \
        jxdmf.sorted_h5_files(str(dirs["jax"]))[0][0]
    capsys.readouterr()

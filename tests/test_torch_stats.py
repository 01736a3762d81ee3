"""PyTorch port: the in-scan statistics engine, its snapshots and export,
the legacy ``Statistics``, vorticity and the particle tracer, against the
JAX package on the CPU.

The JAX reference runs its default (dense) route at 17^2 (confined) and
16x17 (periodic), Ra=1e4, dt=1e-2, in f64, with ``set_stats(StatsConfig(
stride=2))`` and 10 steps of ``update_n``; the port runs each of its routes
(fused, dense, meshed on 4 ranks) from the same state (``convert.py``).
The statistics engine reads the state, so its sums are held to the
step's own parity limit: every leaf and the health vector within rel
1e-11 of each leaf's scale (the routes' states agree to ~1e-13 here), the
tick and the sample count exactly, the boundary-layer point counts
exactly.  Where the text says bit for bit (statistics on against off, the
snapshot rows across packages), ``torch.equal``/``np.array_equal``.
"""

import gc
import importlib.util
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu.config import StatsConfig as JaxStatsConfig
from rustpde_mpi_tpu.models.statistics import Statistics as JaxStatistics
from rustpde_mpi_tpu.tools.particle_tracer import ParticleSwarm as JaxSwarm
from rustpde_mpi_tpu.utils import checkpoint as jcp
from rustpde_mpi_tpu.utils.resilience import ResilientRunner
from rustpde_mpi_tpu.utils import vorticity as jvort
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch.config import StabilityConfig, StatsConfig
from rustpde_mpi_tpu_torch.models.statistics import Statistics
from rustpde_mpi_tpu_torch.models.stats import (HEALTH_NAMES, StatsState, export_stats,
                                                health_events)
from rustpde_mpi_tpu_torch.tools.particle_tracer import ParticleSwarm
from rustpde_mpi_tpu_torch.utils import checkpoint
from rustpde_mpi_tpu_torch.utils import vorticity as tvort

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = (1e4, 1.0, 1e-2, 1.0, "rbc")
SHAPES = {"confined": (17, 17), "periodic": (16, 17)}
FIELDS = ("temp", "velx", "vely", "pres", "pseu")
STRIDE = 2
STEPS = 10
TOL = 1e-11
DENSE = dict(step_kernel="dense", conv_kernel="dense")
ROUTES = {"fused": {}, "dense": DENSE, "mesh": {"mesh": 4}}
#: health entries that count grid points or samples: equal exactly
EXACT_HEALTH = ("bl_thermal_pts", "bl_visc_pts", "samples")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny grids; afterwards the JAX objects
    this module built are collected."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _port(cell="confined", route="dense", state=None, **kw):
    """A port model on the CPU, holding ``state`` (numpy fields) exactly
    when given."""
    nx, ny = SHAPES[cell]
    kw = dict(kw, **{k: v for k, v in ROUTES[route].items() if k != "mesh"})
    if route == "mesh":
        kw["mesh"] = pt.make_mesh(4, "cpu")
    else:
        kw["device"] = "cpu"
    model = pt.Navier2D(nx, ny, *PARAMS, periodic=cell == "periodic", **kw)
    if state is not None:
        convert.state_from_numpy(model, state)
    return model


def _jax_fields(model):
    return {f: np.asarray(getattr(model.state, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def jax_stats():
    """The JAX package's armed models after STEPS steps, per cell, with
    their starting states (built on first use)."""
    cache = {}

    def get(cell):
        if cell not in cache:
            nx, ny = SHAPES[cell]
            model = rp.Navier2D(nx, ny, *PARAMS, periodic=cell == "periodic")
            model.init_random(0.1)
            start = _jax_fields(model)
            model.set_stats(JaxStatsConfig(stride=STRIDE))
            model.update_n(STEPS)
            cache[cell] = (model, start)
        return cache[cell]

    return get


def _jax_health(model):
    return np.array([float(v) for v in model.stats_health_async().result()])


def _assert_stats_close(got, want, tol=TOL):
    """Every leaf of ``got`` (a port StatsState) within ``tol`` of each
    leaf's scale of ``want`` (host arrays by leaf name); the sample count
    exactly."""
    for name in StatsState._fields:
        g = getattr(got, name).detach().cpu().numpy()
        w = np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
        scale = max(float(np.max(np.abs(w))), 1e-300)
        assert float(np.max(np.abs(g - w))) <= tol * scale, (name, np.max(np.abs(g - w)) / scale)
    assert np.array_equal(got.samples.numpy(), want["samples"])


def _assert_health_close(got, want, tol=TOL):
    for name, g, w in zip(HEALTH_NAMES, got, want):
        if name in EXACT_HEALTH:
            assert g == w, name
        else:
            assert abs(g - w) <= tol * max(abs(w), 1e-300), (name, g, w)


def _jax_leaves(model):
    return {name: np.asarray(getattr(model.stats_state, name))
            for name in model.stats_state._fields}


# -- the engine against the JAX package's --------------------------------------------------


@pytest.mark.parametrize("cell", ["confined", "periodic"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stats_match_jax_engine(jax_stats, cell, route):
    ref, start = jax_stats(cell)
    model = _port(cell, route, start)
    model.set_stats(StatsConfig(stride=STRIDE))
    assert model.stats_armed and model.stats_engine.stride == STRIDE
    model.update_n(STEPS)
    assert int(model._stats_tick[0]) == int(np.asarray(ref._stats_tick)[0]) == STEPS
    _assert_stats_close(model.stats_state, _jax_leaves(ref))
    _assert_health_close(model.stats_health(), _jax_health(ref))
    summary = model.stats_summary()
    assert list(summary) == list(HEALTH_NAMES) and summary["samples"] == STEPS // STRIDE


@pytest.mark.parametrize("cell", ["confined", "periodic"])
@pytest.mark.parametrize("route", ["dense", "mesh"])
def test_synthesize_equals_backward_gradient(cell, route):
    """The sample's shared syntheses equal the field space's
    ``backward_gradient`` of each derivative bit for bit."""
    model = _port(cell, route)
    model.init_random(0.1)
    sp = model.field_space
    c = model.temp_space.to_ortho(model.state.temp)
    derivs = ((0, 0), (1, 0), (0, 1), (1, 1))
    for got, d in zip(sp.synthesize(c, derivs, model.scale), derivs):
        assert torch.equal(got, sp.backward_gradient(c, d, model.scale)), d


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stats_on_and_off_step_bit_for_bit(route):
    """The statistics only read: the plain and the sentinel chunk give
    the same state with statistics on and off."""
    plain, armed = _port(route=route), _port(route=route)
    for m in (plain, armed):
        m.init_random(0.1)
    armed.set_stats(StatsConfig(stride=3))
    for cfg in (None, StabilityConfig()):
        for m in (plain, armed):
            m.set_stability(cfg)
            m.update_n(7)
            m.update_n(5)
        for a, b in zip(plain.state, armed.state):
            assert torch.equal(a, b)
    assert int(armed._stats_tick[0]) == 24 and float(armed.stats_state.samples[0]) == 8


def test_freezing_step_advances_the_tick_as_jax(jax_stats):
    """A NaN freezes the plain chunk: the tick advances on the freezing
    step (and once more in the next bucket, which steps the frozen state
    again), and no sample is taken, as the JAX package's chunk does."""
    ref, start = jax_stats("confined")
    model = _port("confined", "dense", start)
    model.set_stats(StatsConfig(stride=STRIDE))
    model.update_n(STEPS)
    convert.state_from_numpy(model, _jax_fields(ref))  # the same state, set from outside
    before = model.stats_state
    keep = (ref.state, ref.stats_state, ref._stats_tick, ref.time)
    ref_before = _jax_leaves(ref)
    try:
        ref.state = ref.state._replace(temp=ref.state.temp.at[0, 0].set(jnp.nan))
        ref.update_n(STEPS)  # buckets 8 + 2, compiled by the fixture
        want_tick = int(np.asarray(ref._stats_tick)[0])
        want = _jax_leaves(ref)
    finally:
        ref.state, ref.stats_state, ref._stats_tick, ref.time = keep
    temp = model.state.temp.clone()
    temp[0, 0] = float("nan")
    model.state = model.state._replace(temp=temp)
    model.update_n(STEPS)
    assert want_tick == STEPS + 2 == int(model._stats_tick[0])
    for name in StatsState._fields:  # nothing sampled: the sums as they were
        assert torch.equal(getattr(model.stats_state, name), getattr(before, name))
        assert np.array_equal(ref_before[name], want[name]), name


@pytest.mark.parametrize("route", ["fused", "mesh"])
def test_sentinel_rollback_discards_samples_and_tick(route):
    """A chunk rolled back on a CFL-ceiling trip leaves the sums and the
    tick at the chunk start, as it leaves the state and the time; a
    healthy sentinel chunk samples as the plain chunk does."""
    model = _port(route=route)
    model.init_random(0.1)
    model.set_stats(StatsConfig(stride=STRIDE))
    model.set_stability(StabilityConfig())
    model.update_n(4)
    sums, tick = model.stats_state, model._stats_tick.clone()
    assert int(tick[0]) == 4 and float(sums.samples[0]) == 2
    start = model.state
    model.state = start._replace(velx=start.velx * 1e4, vely=start.vely * 1e4)
    status = model.update_n(4)
    assert status.pre_divergence and model.exit()
    assert model.stats_state is sums and torch.equal(model._stats_tick, tick)
    model.clear_pre_divergence()
    model.state = start
    model.update_n(4)
    assert int(model._stats_tick[0]) == 8 and float(model.stats_state.samples[0]) == 4


# -- the ensemble ------------------------------------------------------------------------------


def test_ensemble_stats_match_jax_with_a_refill():
    """K = 3 members against the JAX ``NavierEnsemble``'s per-member sums,
    with member 1 refilled (``set_member``: its window restarts, the
    shared tick runs on) between two chunks; each member's sums also
    equal a solo port model's where no refill intervened."""
    k, nx, ny = 3, *SHAPES["confined"]
    jmodel = rp.Navier2D(nx, ny, *PARAMS, periodic=False)
    jmodel.set_stats(JaxStatsConfig(stride=STRIDE))
    jens = rp.NavierEnsemble.from_seeds(jmodel, range(k))
    jens.update_n(4)
    fresh = jens.fresh_member_state(7)
    jens.set_member(1, fresh)
    jens.update_n(4)
    model = _port("confined", "dense")
    model.set_stats(StatsConfig(stride=STRIDE))
    ens = pt.NavierEnsemble.from_seeds(model, range(k))
    assert ens.stats_armed and ens.stats_state.samples.shape == (k, 1)
    ens.update_n(4)
    ens.set_member(1, ens.fresh_member_state(7))
    assert float(ens.stats_state.samples[1, 0]) == 0 and float(ens.stats_state.samples[0, 0]) == 2
    ens.update_n(4)
    assert int(ens._stats_tick[0]) == int(np.asarray(jens._stats_tick)[0]) == 8
    _assert_stats_close(ens.stats_state, _jax_leaves(jens))
    health = ens.stats_health()
    jhealth = [np.asarray(v) for v in jens.stats_health_async().result()]
    for name, g, w in zip(HEALTH_NAMES, health, jhealth):
        assert g.shape == (k,)
        tol = 0.0 if name in EXACT_HEALTH else TOL
        assert np.all(np.abs(g - w) <= tol * np.maximum(np.abs(w), 1e-300)), name
    solo = _port("confined", "dense")
    solo.init_random(0.1, seed=2)
    solo.set_stats(StatsConfig(stride=STRIDE))
    solo.update_n(8)
    for a, b in zip(solo.stats_state, ens.stats_state):
        scale = max(float(torch.max(torch.abs(a))), 1e-300)
        assert float(torch.max(torch.abs(a - b[2]))) <= 1e-12 * scale


# -- snapshots ------------------------------------------------------------------------------


def _armed_port(cell="confined", n=None):
    nx, ny = SHAPES[cell] if n is None else (n, n)
    model = pt.Navier2D(nx, ny, *PARAMS, periodic=cell == "periodic", device="cpu")
    model.set_stats(StatsConfig(stride=STRIDE))
    return model


@pytest.mark.parametrize("cell", ["confined", "periodic"])
def test_snapshot_stats_cross_packages(jax_stats, tmp_path, cell, capsys):
    """A snapshot's ``stats_state/`` group written by either package is
    read by the other bit for bit (leaves and tick)."""
    ref, _ = jax_stats(cell)
    want = _jax_leaves(ref)
    jfile = str(tmp_path / "jax.h5")
    jcp.write_snapshot(ref, jfile)
    port = _armed_port(cell)
    port.read(jfile)
    assert int(port._stats_tick[0]) == STEPS
    for name in StatsState._fields:
        assert np.array_equal(getattr(port.stats_state, name).numpy(), want[name]), name
    # and back: the port's file into an armed JAX model
    port.update_n(2)
    pfile = str(tmp_path / "port.h5")
    port.write(pfile)
    nx, ny = SHAPES[cell]
    back = rp.Navier2D(nx, ny, *PARAMS, periodic=cell == "periodic")
    back.set_stats(JaxStatsConfig(stride=STRIDE))
    jcp.read_snapshot(back, pfile)
    assert int(np.asarray(back._stats_tick)[0]) == STEPS + 2
    for name in StatsState._fields:
        assert np.array_equal(np.asarray(getattr(back.stats_state, name)),
                              getattr(port.stats_state, name).numpy()), name
    capsys.readouterr()


def test_unarmed_file_and_resolution_change_restart_the_window(tmp_path, capsys):
    """A snapshot written without statistics, or at another resolution,
    restarts the window at zero (the JAX package's rules), on a file and
    on the in-memory restore."""
    unarmed = _port("confined", "dense")
    unarmed.init_random(0.1)
    path = str(tmp_path / "plain.h5")
    unarmed.write(path)
    armed = _armed_port()
    armed.update_n(4)
    assert float(armed.stats_state.samples[0]) == 2
    armed.read(path)
    assert float(armed.stats_state.samples[0]) == 0 and int(armed._stats_tick[0]) == 0
    armed.update_n(4)
    snap = checkpoint.snapshot_to_host(armed)
    fine = _armed_port(n=33)
    fine.update_n(2)
    checkpoint._restore_snapshot(fine, checkpoint._host_group(snap))
    assert float(fine.stats_state.samples[0]) == 0 and int(fine._stats_tick[0]) == 0
    assert "restart from zero" in capsys.readouterr().out
    same = _armed_port()
    checkpoint._restore_snapshot(same, checkpoint._host_group(snap))
    for a, b in zip(same.stats_state, armed.stats_state):
        assert torch.equal(a, b)
    assert torch.equal(same._stats_tick, armed._stats_tick)


def test_ensemble_snapshot_carries_the_stats(tmp_path, capsys):
    """An ensemble's staged and written snapshots carry its per-member sums
    and tick; restored into an armed ensemble they are bit for bit, and
    the restored run samples on at the same ticks."""
    model = _port("confined", "dense")
    model.set_stats(StatsConfig(stride=STRIDE))
    ens = pt.NavierEnsemble.from_seeds(model, range(3))
    ens.update_n(5)
    path = str(tmp_path / "ens.h5")
    ens.write(path)
    other = pt.NavierEnsemble.from_seeds(model, range(2))
    other.read(path)
    assert other.k == 3 and int(other._stats_tick[0]) == 5
    for a, b in zip(other.stats_state, ens.stats_state):
        assert torch.equal(a, b)
    again = pt.NavierEnsemble.from_seeds(model, range(2))
    checkpoint._restore_ensemble_snapshot(
        again, checkpoint._host_group(checkpoint.ensemble_snapshot_to_host(ens)))
    for e in (ens, again):
        e.update_n(3)
    for a, b in zip(again.stats_state, ens.stats_state):
        assert torch.equal(a, b)
    capsys.readouterr()


# -- export, the legacy statistics, vorticity, particles ---------------------------------------


def _plot_statistics():
    spec = importlib.util.spec_from_file_location(
        "plot_statistics", os.path.join(REPO, "plot", "plot_statistics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_stats_matches_jax_and_plot_reader(jax_stats, tmp_path):
    """``export_stats`` writes the JAX package's layout (model and
    ensemble), which ``plot/plot_statistics.py`` reads; the model's
    datasets equal the JAX export's to the engine's tolerance."""
    import h5py

    ref, start = jax_stats("confined")
    model = _port("confined", "dense", start)
    model.set_stats(StatsConfig(stride=STRIDE))
    model.update_n(STEPS)
    model.time = ref.time
    mine, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    export_stats(model, mine)
    rp.export_stats(ref, theirs)
    plot = _plot_statistics()
    with h5py.File(mine, "r") as a, h5py.File(theirs, "r") as b:
        names = []
        b.visit(lambda n: names.append(n) if isinstance(b[n], h5py.Dataset) else None)
        assert names
        for name in names:
            w, g = np.asarray(b[name]), np.asarray(a[name])
            scale = max(float(np.max(np.abs(w))), 1e-300)
            assert g.shape == w.shape and float(np.max(np.abs(g - w))) <= TOL * scale, name
        assert dict(a.attrs) == dict(b.attrs)
        root = plot.stats_root(a, 0)
        assert root["temp/v"].shape == SHAPES["confined"] and "profiles" in root
    ens = pt.NavierEnsemble.from_seeds(model, range(2))
    ens.update_n(4)
    path = str(tmp_path / "ens.h5")
    export_stats(ens, path)
    with h5py.File(path, "r") as f:
        assert int(np.asarray(f["members"])) == 2
        assert plot.stats_root(f, 1)["nusselt/v"].shape == SHAPES["confined"]
    with pytest.raises(RuntimeError, match="armed"):
        export_stats(_port(), str(tmp_path / "no.h5"))


@pytest.mark.parametrize("cell", ["confined", "periodic"])
def test_legacy_statistics_match_jax(cell, tmp_path, capsys):
    """The eager ``Statistics`` against the JAX package's: two updates at
    two times, the averages, the counters and the written file; a time
    mismatch is refused and journaled."""
    nx, ny = SHAPES[cell]
    ref = rp.Navier2D(nx, ny, *PARAMS, periodic=cell == "periodic")
    ref.init_random(0.1)
    model = _port(cell, "fused", _jax_fields(ref))
    jst, st = JaxStatistics(ref, 0.1, 0.2), Statistics(model, 0.1, 0.2)
    for t, seed in ((0.1, 3), (0.2, 4)):
        ref.init_random(0.1, seed=seed)
        convert.state_from_numpy(model, _jax_fields(ref))
        ref.time = model.time = t
        jst.update(ref)
        st.update(model)
    for attr in ("t_avg", "ux_avg", "uy_avg", "nusselt"):
        w, g = np.asarray(getattr(jst, attr)), getattr(st, attr)
        assert g.dtype == w.dtype and np.max(np.abs(g - w)) <= TOL * np.max(np.abs(w)), attr
    assert (st.num_save, st.tot_time, st.avg_time) == (jst.num_save, jst.tot_time, jst.avg_time)
    import h5py

    jst.write(str(tmp_path / "j.h5"))
    st.write(str(tmp_path / "p.h5"))
    with h5py.File(tmp_path / "j.h5", "r") as b, h5py.File(tmp_path / "p.h5", "r") as a:
        for name in ("temp/vhat", "nusselt/v", "ux/x", "num_save", "avg_time", "ka"):
            name = name if name in b else name + "_re"
            w = np.asarray(b[name])
            assert np.max(np.abs(np.asarray(a[name]) - w)) <= TOL * max(np.max(np.abs(w)), 1e-300)
    back = Statistics(model, 0.1, 0.2)
    back.read(str(tmp_path / "j.h5"))
    assert back.num_save == 2 and np.array_equal(back.t_avg, np.asarray(jst.t_avg))
    events = []
    model.journal_writer = type("W", (), {"append": lambda self, e: events.append(e)})()
    model.time = 0.05
    st.update(model)
    assert events and events[0]["event"] == "stats_mismatch" and st.num_save == 2
    capsys.readouterr()


def test_callback_updates_and_writes_the_legacy_statistics(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    model = _port("confined", "dense")
    model.init_random(0.1)
    model.write_intervall = 1e9
    model.statistics = Statistics(model, 0.05, 0.1)
    pt.integrate(model, 0.1, 0.05)
    assert model.statistics.num_save == 2 and os.path.exists("data/statistics.h5")
    capsys.readouterr()


@pytest.mark.parametrize("cell", ["confined", "periodic"])
def test_vorticity_appended_to_a_jax_snapshot(jax_stats, tmp_path, cell, capsys):
    import h5py

    ref, _ = jax_stats(cell)
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    jcp.write_snapshot(ref, a)
    shutil.copy(a, b)
    jvort.vorticity_auto(a)
    tvort.vorticity_auto(b)
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        keys = [k for k in fa["vorticity"]]
        assert sorted(keys) == sorted(fb["vorticity"]) and keys
        for k in keys:
            w = np.asarray(fa["vorticity"][k])
            err = np.max(np.abs(np.asarray(fb["vorticity"][k]) - w))
            assert err <= 1e-12 * np.max(np.abs(w)), k
    capsys.readouterr()


def test_particle_tracer_matches_jax_numpy_backend(tmp_path):
    rng = np.random.default_rng(0)
    x, y = np.sort(rng.uniform(0, 2, 17)), np.sort(rng.uniform(-1, 1, 13))
    x[0], x[-1], y[0], y[-1] = 0.0, 2.0, -1.0, 1.0
    ux, uy = rng.standard_normal((17, 13)), rng.standard_normal((17, 13))
    ref = JaxSwarm.from_rectangle(1.0, 0.0, 0.9, 200, x, y, 0.02, seed=3, backend="numpy")
    swarm = ParticleSwarm.from_rectangle(1.0, 0.0, 0.9, 200, x, y, 0.02, seed=3, device="cpu")
    assert np.array_equal(swarm.positions(), ref.positions())
    for _ in range(3):
        assert swarm.update(ux, uy, 7) == ref.update(ux, uy, 7)
        np.testing.assert_allclose(swarm.positions(), ref.positions(), rtol=0, atol=1e-14)
    for g, w in zip(swarm.sample(ux, uy), ref.sample(ux, uy)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-14)
    assert swarm.time == pytest.approx(ref.time)
    path = str(tmp_path / "p.txt")
    swarm.write(path)
    again = ParticleSwarm.from_file(path, x, y, 0.02, device="cpu")
    np.testing.assert_array_equal(again.positions(), swarm.positions())
    with pytest.raises(ValueError, match="grid"):
        swarm.update(ux[:3], uy, 1)


def test_engine_contract():
    """The engine reads DNS models only; the stride floor and defaults are
    the JAX package's; a disarmed model reports no statistics."""
    model = _port()
    assert model.stats_summary() is None and model.stats_host_items() == []
    with pytest.raises(RuntimeError, match="set_stats"):
        model.stats_health()
    model.set_stats(StatsConfig(stride=0))
    assert model.stats_engine.stride == 1
    model.set_stats(StatsConfig())
    eng = model.stats_engine
    assert (eng.stride, eng.tail_warn, eng.budget_warn) == (16, 1e-3, 0.5)
    ss = eng.accum_fn()(eng.init_state(), model.state)
    assert float(ss.samples[0]) == 1 and eng.health_fn()(ss).shape == (len(HEALTH_NAMES),)
    assert torch.equal(eng.sample_fn()(model.state).t_sum, ss.t_sum)
    model.set_stats(None)
    assert not model.stats_armed and model.stats_state is None

    class Other:
        MODEL_KIND = "lnse"

    with pytest.raises(TypeError, match="DNS"):
        pt.StatsEngine(Other())
    assert jax.devices()[0].platform == "cpu"


def _jax_runner_events(engine, vals) -> list:
    """The events the JAX package's resilient runner journals from one
    health readout, with no latch set (its ``_stats_health_report`` on a
    stand-in runner whose journal is a list)."""
    events = []
    runner = types.SimpleNamespace(pde=types.SimpleNamespace(stats_engine=engine),
                                   _stats_res_latched=False, _stats_budget_latched=False,
                                   _journal=events.append)
    ResilientRunner._stats_health_report(runner, vals)
    return events


#: scripted health readouts (HEALTH_NAMES order): a tail over the limit
#: on ux's y axis; the budget over it after one sample only; nothing yet
_SCRIPTED = {
    "tail": [1e-4, 2e-4, 3e-4, 5e-3, 1e-5, 0.0, 4.0, 6.0, 0.1, 0.2, 2.0, 2.1, 7.0],
    "one_sample": [0.0] * 8 + [0.1, 0.9, 2.0, 3.0, 1.0],
    "no_sample": [0.0] * 13,
}


@pytest.mark.parametrize("case", ["defaults", "crossed", "ensemble", *_SCRIPTED])
def test_stats_warnings_match_jax_runner(case):
    """``StatsConfig.tail_warn``/``budget_warn`` are read as the JAX
    package's resilient runner reads them: the events ``stats_warnings``
    reports (and journals) equal those the runner journals from the same
    health readout, field for field."""
    if case in _SCRIPTED:
        engine = types.SimpleNamespace(tail_warn=1e-3, budget_warn=0.5)
        vals = tuple(_SCRIPTED[case])
        got = health_events(engine, vals)
        assert got == _jax_runner_events(engine, vals)
        assert [e["event"] for e in got] == {"tail": ["resolution_warning"]}.get(case, [])
        return
    model = _port()
    model.init_random(0.1)
    limits = {} if case == "defaults" else {"tail_warn": 0.0, "budget_warn": 0.0}
    pde = pt.NavierEnsemble.from_seeds(model, range(3)) if case == "ensemble" else model
    assert pde.stats_warnings() == []
    pde.set_stats(StatsConfig(stride=STRIDE, **limits))
    pde.journal_writer = []
    pde.update_n(STEPS)
    got = pde.stats_warnings()
    assert got == _jax_runner_events(pde.stats_engine, pde.stats_health())
    assert pde.journal_writer == got
    if case != "defaults":
        assert [e["event"] for e in got] == ["resolution_warning", "budget_drift"]

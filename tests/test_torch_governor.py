"""PyTorch port: the dt governor (``DtLadder``, ``StabilityGovernor``,
``RunHealth``), ``set_dt`` with its per-rung cache, and ``from_config``,
against the JAX package on the CPU.

The governor is host code: its rung floats, decisions and health records
must be identical to the JAX package's.  ``set_dt`` is held against the
JAX model's ``set_dt`` on the JAX package's dense route at 17^2 (Ra=1e5,
dt=1e-2 -> 5e-3 -> 1e-2, two steps at each rung) with a roughness
obstacle and the passive scalar at the thermal diffusivity, on every
port route: each field within 1e-11 of its scale (the routes' parity
limit); ``recompile_count`` grows as the JAX model's over a ladder cycle.
"""

import gc
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu.config import NavierConfig as JaxNavierConfig
from rustpde_mpi_tpu.config import StabilityConfig as JaxStabilityConfig
from rustpde_mpi_tpu.config import StatsConfig as JaxStatsConfig
from rustpde_mpi_tpu.models.solid_masks import solid_roughness_sinusoid as jax_roughness
from rustpde_mpi_tpu.utils import governor as jgov
from rustpde_mpi_tpu.workloads import geometry_sweep as jax_sweep
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch.config import NavierConfig, StabilityConfig, StatsConfig
from rustpde_mpi_tpu_torch.models.solid_masks import solid_roughness_sinusoid
from rustpde_mpi_tpu_torch.utils import governor as tgov
from rustpde_mpi_tpu_torch.workloads import ScenarioConfig
from rustpde_mpi_tpu_torch.workloads.modifiers import penalization_factors

N = 17
PARAMS = (1e5, 1.0, 1e-2, 1.0, "rbc")
DT = PARAMS[2]
TOL = 1e-11
DENSE = dict(step_kernel="dense", conv_kernel="dense")
ROUTES = {"fused": {}, "dense": DENSE, "mesh": {"mesh": 4}}
SCENARIO = dict(passive_scalar=True, scalar_kappa=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _port(route="dense", **kw):
    kw = dict(kw, **{k: v for k, v in ROUTES[route].items() if k != "mesh"})
    if route == "mesh":
        kw["mesh"] = pt.make_mesh(4, "cpu")
    else:
        kw["device"] = "cpu"
    return pt.Navier2D(N, N, *PARAMS, **kw)


def _close(port, want, tol=TOL):
    got = convert.state_to_numpy(port)
    for name, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.max(np.abs(w))), 1e-300)
        assert float(np.max(np.abs(got[name] - w))) <= tol * scale, (name, got[name].shape)


# -- the ladder and the governor ------------------------------------------------------------


@pytest.mark.parametrize("args", [(1e-3,), (2e-3, 2.0, None, 8e-3), (3e-4, 1.5, 1e-5, 1e-3),
                                  (0.1, 3.0, 0.1 / 81, None)])
def test_dt_ladder_floats_are_the_jax_ones(args):
    a, b = tgov.DtLadder(*args), jgov.DtLadder(*args)
    assert (a.top, a.bottom, len(a)) == (b.top, b.bottom, len(b))
    for rung in range(a.bottom - 2, a.top + 3):
        assert a.dt(rung) == b.dt(rung) and a.clamp(rung) == b.clamp(rung)
    for dt in (a.anchor * 0.37, a.anchor, a.anchor * 2.0, a.dt(a.bottom) * 0.9):
        assert a.rung_for(dt) == b.rung_for(dt)
        assert a.rung_floor_for(dt) == b.rung_floor_for(dt)
    for cfl in (0.1, 0.6, 3.7, float("inf"), float("nan")):
        assert a.rungs_to_target(cfl, 0.5) == b.rungs_to_target(cfl, 0.5)
    with pytest.raises(ValueError):
        tgov.DtLadder(1e-3, ratio=1.0)


def _statuses(mod):
    """A scripted chunk record: healthy chunks (regrowth), a proactive
    shrink, a lagged status observed at an older dt (rescaled), a NaN
    chunk, ceiling catches with the same ensemble members pinned (killed
    after the patience), and catches at the bottom rung (give_up)."""
    S = mod.ChunkStatus

    def ok(cfl, dt, **kw):
        return S(50, 50, True, True, False, cfl, 0.1, 1.01, 1e-9, dt, **kw)

    def trip(cfl, dt, pinned=None):
        return S(50, 7, True, False, True, cfl, 0.1, 1.5, 1e-9, dt,
                 cfl_members=None if pinned is None else tuple(cfl * p for p in pinned),
                 pinned=pinned)

    seq = [ok(0.2, 1e-3)] * 5 + [ok(0.9, 1e-3), ok(0.95, 2e-3), ok(0.3, 5e-4)]
    seq += [S(50, 3, False, True, False, float("nan"), float("nan"), 1.0, 1.0, 5e-4)]
    pinned = (True, False, False)
    seq += [trip(1.4, 5e-4, pinned), trip(1.3, 2.5e-4, pinned), trip(1.2, 1.25e-4, pinned)]
    seq += [ok(0.1, 1.25e-4)] * 3 + [trip(50.0, 1.25e-4)] * 6
    return seq


def test_governor_decisions_and_health_match_jax():
    cfg_t = StabilityConfig(grow_after=2, dt_min=1e-3 / 16)
    cfg_j = JaxStabilityConfig(grow_after=2, dt_min=1e-3 / 16)
    a, b = tgov.StabilityGovernor(cfg_t, 1e-3), jgov.StabilityGovernor(cfg_j, 1e-3)
    assert a.align(1e-3, step=3) == b.align(1e-3, step=3)
    actions = set()
    for step, (sa, sb) in enumerate(zip(_statuses(tgov), _statuses(jgov))):
        da, db = a.on_chunk(sa, step=step), b.on_chunk(sb, step=step)
        assert tuple(da) == tuple(db), step
        actions.add(da.action)
        assert a.rung == b.rung and a.healthy == b.healthy
    assert actions == {"ok", "adjust", "retry", "kill_members", "give_up"}
    assert a.health.asdict() == b.health.asdict()
    assert a.align(3e-4, step=99) == b.align(3e-4, step=99)
    assert a.health.asdict() == b.health.asdict()


# -- set_dt ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ladder():
    """The JAX model (dense route, obstacle, matched scalar) stepped two
    steps at each rung of dt -> dt/2 -> dt, with its states and recompile
    counts."""
    ref = rp.Navier2D(N, N, *PARAMS, periodic=False, scenario=SCENARIO)
    ref.init_random(0.1)
    ref.set_solid(*jax_roughness(*ref.x, 0.1, 10.0))
    ref.state = ref.state._replace(scal=ref.state.temp)
    start = {f: np.asarray(getattr(ref.state, f)) for f in ref.state._fields}
    out, counts = [], [ref.recompile_count]
    for dt in (DT, DT / 2, DT):
        ref.set_dt(dt)
        counts.append(ref.recompile_count)
        for _ in range(2):
            ref.update()
        out.append({f: np.asarray(getattr(ref.state, f)) for f in ref.state._fields})
    return start, out, counts


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_set_dt_ladder_matches_jax(jax_ladder, route):
    start, want, counts = jax_ladder
    model = _port(route, scenario=ScenarioConfig(**SCENARIO))
    model.set_solid(*solid_roughness_sinusoid(*model.x, 0.1, 10.0))
    convert.state_from_numpy(model, start)
    got = [model.recompile_count]
    for dt, w in zip((DT, DT / 2, DT), want):
        model.set_dt(dt)
        got.append(model.recompile_count)
        model.update_n(2)
        _close(model, w)
    assert np.diff(got).tolist() == np.diff(counts).tolist() == [0, 1, 0]
    assert model.time == pytest.approx(2 * DT + DT + 2 * DT)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_set_dt_swaps_rungs_and_keeps_the_state(route):
    """A revisited rung swaps the same objects back in (no rebuild); the
    chunk after each move equals eager steps at the new dt bit for bit;
    state, time and statistics are untouched by the move itself."""
    model = _port(route)
    model.init_random(0.1)
    model.set_stats(StatsConfig(stride=2))
    model.update_n(4)
    first_kernels = model.kernels()
    runner = model.chunk_runner()
    state, time, sums = model.state, model.time, model.stats_state
    model.set_dt(DT / 2)
    assert model.state is state and model.time == time and model.stats_state is sums
    assert model.dt == DT / 2 and model.chunk_runner() is not runner
    ref = [t.clone() for t in model.state]
    model.update_n(3)
    for _ in range(3):
        ref = list(model._step(type(model.state)(*ref)))
    for a, b in zip(model.state, ref):
        assert torch.equal(a, b)
    n = model.recompile_count
    model.set_dt(DT)
    assert model.recompile_count == n and model.chunk_runner() is runner
    assert all(x is y for k in first_kernels for x, y in zip(first_kernels[k], model.kernels()[k]))
    model.set_dt(DT / 4)
    model.set_dt(DT / 2)
    assert model.recompile_count == n + 1
    with pytest.raises(ValueError):
        model.set_dt(0.0)


def test_stats_span_exact_across_dt_rung_moves():
    model = _port("dense")
    model.init_random(0.1)
    model.set_stats(StatsConfig(stride=2))
    model.update_n(8)
    model.set_dt(DT / 2)
    model.update_n(8)
    ss = model.stats_state
    assert float(ss.span_sum[0]) == pytest.approx(4 * 2 * DT + 4 * 2 * DT / 2)
    assert float(ss.span_first[0]) == pytest.approx(2 * DT)
    assert float(ss.samples[0]) == 8


def test_governed_spike_backs_off_and_climbs_back():
    """A CFL spike (velocities at 4x the ceiling) is caught and retried
    three rungs down; once the spike has passed (the calm state put back),
    the run climbs back to the anchor, one rung after every ``grow_after``
    healthy chunks, the model's dt following the decisions."""
    model = _port("fused")
    model.init_random(0.1)
    cfg = StabilityConfig(grow_after=2)
    gov = tgov.StabilityGovernor(cfg, model.dt)
    model.set_stability(cfg)
    model.update_n(1)
    calm = model.state
    factor = 4.0 * cfg.max_cfl / model.update_n(1).cfl_max  # the CFL of the consumed state
    model.state = calm._replace(velx=calm.velx * factor, vely=calm.vely * factor)
    trajectory = []
    for _ in range(12):
        status = model.update_n(5)
        decision = gov.on_chunk(status)
        if decision.action in ("retry", "adjust"):
            model.set_dt(decision.dt)
            model.clear_pre_divergence()
        if status.pre_divergence:
            model.state = calm  # the spike passes
        trajectory.append((decision.action, model.dt))
    assert trajectory[0] == ("retry", DT / 8)
    assert [dt for _, dt in trajectory][-1] == DT and gov.health.dt_adjusts == 4
    assert gov.health.pre_divergence_catches == 1 and model.recompile_count == 4
    assert all(math.isfinite(v) for v in model.get_observables())


# -- the ensemble and the sweep ------------------------------------------------------------


def test_ensemble_set_dt_matches_solo_and_caches_its_runners():
    model = _port("dense")
    ens = pt.NavierEnsemble.from_seeds(model, range(2))
    ens.update_n(2)
    runners = ens._runners
    ens.set_dt(DT / 2)
    assert ens.dt == model.dt == DT / 2 and ens.recompile_count == 2
    ens.update_n(3)
    solo = _port("dense")
    solo.init_random(0.1, seed=1)
    solo.update_n(2)
    solo.set_dt(DT / 2)
    solo.update_n(3)
    for a, b in zip(solo.state, ens.member_state(1)):
        assert torch.equal(a, b)
    ens.set_dt(DT)
    assert ens._runners is runners and ens.recompile_count == 2


def test_geometry_sweep_factors_after_set_dt_match_jax():
    """After ``set_dt`` an ensemble keeps the sweep's per-member factors:
    at the sweep's default ``eta = dt / 10`` they do not depend on dt, so
    stepping on equals a JAX ``geometry_sweep`` run at the new dt."""
    geoms = [(0.1, 10.0), (0.2, 6.0)]
    ref = rp.Navier2D(N, N, *PARAMS, periodic=False)
    ref.init_random(0.1)
    start = {f: np.asarray(getattr(ref.state, f)) for f in ref.state._fields}
    ref.set_dt(DT / 2)
    final, _ = jax_sweep(ref, [jax_roughness(*ref.x, *g)[0] for g in geoms], 3)
    model = _port("dense")
    convert.state_from_numpy(model, start)
    pairs = [penalization_factors(model, solid_roughness_sinusoid(*model.x, *g)[0]) for g in geoms]
    ens = pt.NavierEnsemble(model, [model.state] * 2)
    ens._set_solids(torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]))
    ens.set_dt(DT / 2)
    ens.update_n(3)
    for i in range(2):
        member = convert.state_to_numpy(_with(model, ens.member_state(i)))
        for f in ("temp", "velx", "vely", "pres"):
            w = np.asarray(getattr(final, f))[i]
            assert np.max(np.abs(member[f] - w)) <= TOL * np.max(np.abs(w)), (i, f)


def _with(model, state):
    model.state = state
    return model


# -- from_config -----------------------------------------------------------------------------


@pytest.mark.parametrize("ensemble", [1, 3])
def test_from_config_matches_jax(ensemble):
    kw = dict(nx=N, ny=N, ra=1e5, dt=5e-3, write_intervall=0.5, init_random_amp=0.05,
              params={"tag": 2.0}, ensemble=ensemble)
    jcfg = JaxNavierConfig(stability=JaxStabilityConfig(max_cfl=0.8),
                           stats=JaxStatsConfig(stride=4), **kw)
    tcfg = NavierConfig(stability=StabilityConfig(max_cfl=0.8), stats=StatsConfig(stride=4), **kw)
    assert tcfg.ctor_args() == jcfg.ctor_args()
    if ensemble == 1:
        ref, got = rp.Navier2D.from_config(jcfg), pt.Navier2D.from_config(tcfg, device="cpu")
        model, jmodel, members = got, ref, [(ref.state, got.state)]
    else:
        ref = rp.NavierEnsemble.from_config(jcfg)
        got = pt.NavierEnsemble.from_config(tcfg, device="cpu")
        assert got.k == ref.k == ensemble
        model, jmodel = got.model, ref.model
        members = [(jnp_member(ref, i), got.member_state(i)) for i in range(ensemble)]
    assert model.write_intervall == jmodel.write_intervall == 0.5
    assert model.params == {k: float(v) for k, v in jmodel.params.items()}
    assert model._stability.max_cfl == 0.8 and model.stats_engine.stride == 4
    assert got.stats_armed
    keep = model.state
    for jstate, state in members:
        model.state = state
        _close(model, {f: np.asarray(getattr(jstate, f)) for f in ("temp", "velx", "vely")}, 1e-13)
    model.state = keep
    with pytest.raises(NotImplementedError, match="item 15"):
        NavierConfig(resilience=object())
    with pytest.raises(TypeError, match="IntegrityConfig"):
        NavierConfig(integrity=object())


def jnp_member(ens, i):
    return type(ens.state)(*(jnp.asarray(x)[i] for x in ens.state))

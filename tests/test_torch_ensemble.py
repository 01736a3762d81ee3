"""PyTorch port: ``NavierEnsemble`` and ``geometry_sweep`` against the JAX
package, on the CPU.

The JAX package advances K member states as one ``jax.vmap`` of the step
(its fused route with the Pallas kernels in interpret mode, as its own
tests run them, or its default dense route); the port steps the
member-stacked state through the model's own step, every kernel launch
serving all K members.  Here, at 17^2 (16x17 periodic) with K <= 3:

* ``from_seeds`` K = 3, 7 steps, on the fused, dense and meshed (2 and 4
  ranks) routes of the confined cell and the fused and dense routes of the
  periodic one: every member within 1e-11 of each field's scale of the
  JAX ensemble (the meshed routes against its serial dense ensemble, which
  the JAX package holds equal to its meshed one), the ``(K,)`` observables
  within rel 1e-11 (|div| within 1e-11 of the largest member's);
* the port's ensemble against its own solo runs within 1e-12 of each
  field's scale (the JAX package's own test: ``rtol=1e-9, atol=1e-12``);
* NaN isolation (a member poisoned in temp mode 0): alive masks,
  ``steps_done`` and NaN masks exactly, the survivors bit for bit those of
  an unpoisoned port ensemble; an all-dead ensemble's ``exit()`` and
  ``integrate``'s ``"break"``; the retained-reference contract;
* ``respawn_dead`` with a fixed seed and with a ``respawn_seed`` stream,
  bit for bit against the JAX ensemble from the same states;
* the sentinel chunk: ``cfl_members`` within rel 1e-11, ``pinned``,
  ``pre_divergence`` and the rollback exactly;
* ``geometry_sweep`` against the JAX one (1e-11 of each field's scale) and
  against solo ``set_solid`` runs (``rtol=1e-9, atol=1e-13``, the JAX
  package's ``tests/test_workloads.py`` limits);
* one HC and one scenario (Coriolis + a scalar at 3x the thermal
  diffusivity) ensemble of K = 2 against the JAX ones;
* each kernel wrapper's plain version on member-stacked inputs equal to K
  unbatched calls.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu.config import StabilityConfig as JaxStabilityConfig
from rustpde_mpi_tpu.workloads import ScenarioConfig as JaxScenarioConfig
from rustpde_mpi_tpu.workloads.modifiers import geometry_sweep as jax_geometry_sweep

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch.config import StabilityConfig
from rustpde_mpi_tpu_torch.ops import _build
from rustpde_mpi_tpu_torch.ops.banded import BandedSolver, banded_lu_factor
from rustpde_mpi_tpu_torch.ops.ring_transpose import RingTranspose
from rustpde_mpi_tpu_torch.utils.integrate import integrate

K, STEPS = 3, 7
PARAMS = (1e4, 1.0, 1e-2, 1.0)
SHAPES = {"confined": (17, 17), "periodic": (16, 17)}
TOL = 1e-11
SOLO_TOL = 1e-12
FUSED_ENV = {"RUSTPDE_CONV_KERNEL": "pallas", "RUSTPDE_STEP_KERNEL": "pallas"}
DENSE = dict(step_kernel="dense", conv_kernel="dense")
#: the port's routes: (cell, constructor arguments, the JAX run it is held to)
ROUTES = {
    "fused": ("confined", {}, "fused"),
    "dense": ("confined", DENSE, "dense"),
    "mesh2": ("confined", {"mesh": 2}, "dense"),
    "mesh4": ("confined", {"mesh": 4}, "dense"),
    "periodic_fused": ("periodic", {}, "fused"),
    "periodic_dense": ("periodic", DENSE, "dense"),
}
#: a velocity factor that lifts member 1's CFL after 4 steps (0.0077 at
#: this size) to about 4x the ceiling of 1
SPIKE = 520.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread (tiny grids); drop the JAX objects this module
    built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _jax_model(cell="confined", route="dense", bc="rbc", **kw):
    nx, ny = SHAPES[cell]
    with pytest.MonkeyPatch.context() as mp:
        if route == "fused":
            for key, value in FUSED_ENV.items():
                mp.setenv(key, value)
        return rp.Navier2D(nx, ny, *PARAMS, bc, periodic=cell == "periodic", **kw)


def _port_model(cell="confined", bc="rbc", **kw):
    nx, ny = SHAPES[cell]
    kw = dict(kw)
    if "mesh" in kw:
        kw["mesh"] = pt.make_mesh(kw["mesh"], "cpu")
    else:
        kw["device"] = "cpu"
    return pt.Navier2D(nx, ny, *PARAMS, bc, periodic=cell == "periodic", **kw)


def _jax_numpy(ens):
    return {f: np.asarray(getattr(ens.state, f)) for f in ens.state._fields}


def _port_member(ens, i):
    """Member ``i``'s fields as global numpy arrays (gathered on a mesh)."""
    out = {}
    for name, space in ens.model._state_fields():
        out[name] = space.gather_spectral(getattr(ens.state, name)[i]).numpy()
    return out


def _assert_members_close(port, want, tol, members=None):
    """Every member's fields within ``tol`` of each field's scale."""
    for i in range(port.k) if members is None else members:
        got = _port_member(port, i)
        for name, w in want.items():
            w = np.asarray(w[i])
            scale = max(float(np.max(np.abs(w))), 1e-300)
            err = float(np.max(np.abs(got[name] - w)))
            assert err <= tol * scale, (i, name, err / scale)


def _assert_obs_close(got, want, tol):
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        scale = np.max(np.abs(w)) if j == 3 else np.abs(w)  # |div|: the largest member's
        assert np.all(np.abs(g - w) <= tol * scale), (j, g, w)


def _port_from_jax(jens, model):
    """A port ensemble on ``model`` holding the JAX ensemble's member states
    exactly (and its alive mask and counts)."""
    members = []
    for i in range(jens.k):
        convert.state_from_numpy(model, {f: np.asarray(getattr(jens.state, f))[i]
                                         for f in jens.state._fields})
        members.append(model.state)
    ens = pt.NavierEnsemble(model, members)
    ens.mask = torch.as_tensor(np.array(jens.mask))
    ens.steps_done = torch.as_tensor(np.array(jens.steps_done), dtype=torch.int32)
    return ens


def _nan_mode0(state, lib):
    """``state`` with its temperature's mode (0, 0) NaN."""
    if lib == "jax":
        return state._replace(temp=state.temp.at[0, 0].set(jnp.nan))
    temp = state.temp.clone()
    temp[0, 0] = float("nan")
    return state._replace(temp=temp)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's ``from_seeds(range(K))`` ensembles after STEPS
    steps, by (cell, route), built on first use."""
    cache = {}

    def get(cell, route):
        if (cell, route) not in cache:
            ens = rp.NavierEnsemble.from_seeds(_jax_model(cell, route), seeds=range(K))
            ens.update_n(STEPS)
            cache[cell, route] = (_jax_numpy(ens), tuple(np.asarray(v) for v in ens.get_observables()),
                                  np.asarray(ens.steps_done), np.asarray(ens.mask))
        return cache[cell, route]

    return get


# -- the ensemble against the JAX package's and against solo runs -------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_members_match_jax_ensemble(jax_runs, route):
    cell, kw, ref = ROUTES[route]
    states, obs, steps_done, mask = jax_runs(cell, ref)
    ens = pt.NavierEnsemble.from_seeds(_port_model(cell, **kw), range(K))
    assert ens.k == ens.ensemble_size == K
    ens.update_n(STEPS)
    assert ens.steps_done.tolist() == steps_done.tolist() == [STEPS] * K
    assert ens.alive().tolist() == mask.tolist()
    _assert_members_close(ens, states, TOL)
    _assert_obs_close(ens.get_observables(), obs, TOL)
    assert ens.time == pytest.approx(STEPS * PARAMS[2])


@pytest.mark.parametrize("route", ["fused", "dense", "mesh4", "periodic_fused", "periodic_dense"])
def test_members_match_port_solo_runs(route):
    cell, kw, _ = ROUTES[route]
    ens = pt.NavierEnsemble.from_seeds(_port_model(cell, **kw), range(K))
    ens.update_n(STEPS)
    for i in range(K):
        solo = _port_model(cell, **kw)
        solo.init_random(0.1, seed=i)
        solo.update_n(STEPS)
        got = _port_member(ens, i)
        for name, want in convert.state_to_numpy(solo).items():
            scale = max(float(np.max(np.abs(want))), 1e-300)
            assert float(np.max(np.abs(got[name] - want))) <= SOLO_TOL * scale, (i, name)
        obs = [v[i] for v in ens.get_observables()]
        np.testing.assert_allclose(obs, solo.get_observables(), rtol=1e-9, atol=1e-12)


# -- fault isolation and the ensemble's contracts ------------------------------------------


def test_nan_isolation_matches_jax():
    jens = rp.NavierEnsemble.from_seeds(_jax_model(), seeds=range(K))
    port = pt.NavierEnsemble.from_seeds(_port_model(), range(K))
    clean = pt.NavierEnsemble.from_seeds(_port_model(), range(K))
    jens.set_member(0, _nan_mode0(jens.member_state(0), "jax"))
    port.set_member(0, _nan_mode0(port.member_state(0), "torch"))
    for ens in (jens, port, clean):
        ens.update_n(5)
    assert port.alive().tolist() == np.asarray(jens.alive()).tolist() == [False, True, True]
    assert port.steps_done.tolist() == np.asarray(jens.steps_done).tolist() == [0, 5, 5]
    # the dead member stays frozen at its poisoned state, NaN exactly where
    # the reference's is
    want = _jax_numpy(jens)
    got = _port_member(port, 0)
    for name in want:
        assert np.array_equal(np.isfinite(got[name]), np.isfinite(want[name][0])), name
    _assert_members_close(port, want, TOL, members=[1, 2])
    for name, x, y in zip(port.state._fields, port.state, clean.state):
        assert torch.equal(x[1:], y[1:]), name
    nu = port.eval_nu()
    assert not np.isfinite(nu[0]) and np.isfinite(nu[1:]).all()
    assert not port.exit() and not jens.exit()


def test_all_dead_ensemble_exits(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the callback writes data/ in the working directory
    jens = rp.NavierEnsemble.from_seeds(_jax_model(), seeds=[0])
    jens.set_member(0, _nan_mode0(jens.member_state(0), "jax"))
    jens.update_n(3)
    ens = pt.NavierEnsemble.from_seeds(_port_model(), [0])
    ens.set_member(0, _nan_mode0(ens.member_state(0), "torch"))
    ens.update_n(3)
    assert ens.exit() and jens.exit()
    assert ens.steps_done.tolist() == np.asarray(jens.steps_done).tolist() == [0]
    assert not ens.state_healthy()
    again = pt.NavierEnsemble.from_seeds(_port_model(), [0, 1])
    again.mark_dead([0, 1])
    assert integrate(again, 0.05, 0.02) == "break"
    assert again.steps_done.tolist() == [0, 0] and again.get_time() == pytest.approx(0.02)


def test_update_n_leaves_retained_references_alone():
    ens = pt.NavierEnsemble.from_seeds(_port_model(), range(2))
    e0, m0, d0 = ens.state, ens.mask, ens.steps_done
    copies = [x.clone() for x in e0]
    ens.update_n(4)
    assert ens.state is not e0
    for x, y in zip(e0, copies):
        assert torch.equal(x, y)
    assert m0.all() and d0.tolist() == [0, 0]
    assert ens.steps_done.tolist() == [4, 4]
    member = ens.member_state(1)
    ens.set_member(0, member)
    assert torch.equal(ens.state.temp[0], member.temp)
    assert ens.steps_done.tolist() == [0, 4]


def test_constructor_rules():
    model = _port_model()
    with pytest.raises(TypeError, match="unbatched"):
        pt.NavierEnsemble(model, model.state)
    with pytest.raises(ValueError, match="at least one"):
        pt.NavierEnsemble(model, [])
    rep = pt.NavierEnsemble.replicate(model, 2)
    stacked = pt.NavierEnsemble(model, rep.state)
    assert stacked.k == 2 and torch.equal(stacked.state.velx[1], model.state.velx)
    assert rep.compat_key == model.compat_key == ("dns", 17, 17, 1e4, 1.0, 1e-2, 1.0, "rbc",
                                                  False, ())
    fresh = rep.fresh_member_state(5)
    assert not torch.equal(fresh.temp, model.state.temp)
    assert torch.equal(rep.member_state(0).temp, model.state.temp)
    assert rep.get_field("temp", 1).shape == (17, 17)
    assert rep.observable_names == ("nu", "nuvol", "re", "div")


@pytest.mark.parametrize("use_stream", [False, True], ids=["seed", "respawn_seed"])
def test_respawn_dead_matches_jax(use_stream):
    jens = rp.NavierEnsemble.from_seeds(_jax_model(), seeds=range(K))
    jens.update_n(2)
    port = _port_from_jax(jens, _port_model())
    for ens in (jens, port):
        ens.mark_dead([0, 2])
        if use_stream:
            ens.respawn_seed = 11
            assert ens.respawn_dead(amp=1e-3) == 2
            ens.mark_dead([1])
            assert ens.respawn_dead(amp=1e-3) == 1
        else:
            assert ens.respawn_dead(amp=1e-3, seed=(4, 2)) == 2
    assert port.alive().all() and port.steps_done.tolist() == np.asarray(jens.steps_done).tolist()
    want = _jax_numpy(jens)
    for i in range(K):
        got = _port_member(port, i)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name][i])


def test_sentinel_chunk_matches_jax():
    jmodel = _jax_model()
    jmodel.set_stability(JaxStabilityConfig())
    jens = rp.NavierEnsemble.from_seeds(jmodel, seeds=range(K))
    port = _port_from_jax(jens, _port_model())
    port.set_stability(StabilityConfig())
    healthy = [e.update_n(4) for e in (jens, port)]
    for key in ("requested", "steps_done", "finite", "cfl_ok", "pre_divergence", "pinned"):
        assert getattr(healthy[1], key) == getattr(healthy[0], key), key
    np.testing.assert_allclose(healthy[1].cfl_members, healthy[0].cfl_members, rtol=TOL)
    for key in ("cfl_max", "ke", "ke_growth_max", "div_max"):
        assert getattr(healthy[1], key) == pytest.approx(getattr(healthy[0], key), rel=TOL), key
    # member 1's velocities at about 4x the ceiling: the chunk rolls back
    jspike = jens.member_state(1)
    jens.set_member(1, jspike._replace(velx=jspike.velx * SPIKE, vely=jspike.vely * SPIKE))
    spike = port.member_state(1)
    port.set_member(1, spike._replace(velx=spike.velx * SPIKE, vely=spike.vely * SPIKE))
    before = [x.clone() for x in port.state]
    t0 = port.time
    tripped = [e.update_n(4) for e in (jens, port)]
    assert tripped[1].pinned == tripped[0].pinned == (False, True, False)
    assert tripped[1].pre_divergence and tripped[0].pre_divergence
    assert tripped[1].steps_done == tripped[0].steps_done
    assert 3.0 < tripped[1].cfl_members[1] < 5.0
    np.testing.assert_allclose(tripped[1].cfl_members, tripped[0].cfl_members, rtol=TOL)
    assert port.exit() and jens.exit() and port.time == t0
    for x, y in zip(port.state, before):
        assert torch.equal(x, y)
    port.clear_pre_divergence()
    assert not port.exit()


def test_public_accessors_match_jax():
    """``nx``, ``ny`` and ``pre_divergence_latched`` as the JAX ensemble's:
    the latch is set by a sentinel catch and cleared by acknowledgement."""
    jmodel = _jax_model()
    jmodel.set_stability(JaxStabilityConfig())
    jens = rp.NavierEnsemble.from_seeds(jmodel, seeds=range(2))
    port = _port_from_jax(jens, _port_model())
    port.set_stability(StabilityConfig())
    assert (port.nx, port.ny) == (jens.nx, jens.ny) == SHAPES["confined"]
    assert port.pre_divergence_latched is jens.pre_divergence_latched is False
    for ens in (jens, port):
        spike = ens.member_state(1)
        ens.set_member(1, spike._replace(velx=spike.velx * SPIKE, vely=spike.vely * SPIKE))
        assert ens.update_n(4).pre_divergence
    assert port.pre_divergence_latched is jens.pre_divergence_latched is True
    for ens in (jens, port):
        ens.clear_pre_divergence()
    assert port.pre_divergence_latched is jens.pre_divergence_latched is False


# -- the geometry sweep --------------------------------------------------------------------


def test_geometry_sweep_matches_jax_and_solo_set_solid():
    template = _port_model()
    template.init_random(0.1)
    jtemplate = _jax_model()
    jtemplate.init_random(0.1)
    xs, ys = (b.points for b in template.field_space.bases)
    geoms = [pt.solid_cylinder_inner(xs, ys, 0.0, 0.0, 0.3),
             pt.solid_cylinder_inner(xs, ys, 0.4, -0.2, 0.2),
             pt.solid_rectangle(xs, ys, 0.0, 0.6, 0.3, 0.1)]
    steps = 5
    final, obs = pt.geometry_sweep(template, geoms, steps)
    jfinal, jobs = jax_geometry_sweep(jtemplate, geoms, steps)
    assert obs[0].shape == (3,)
    for name in final._fields:
        want = np.asarray(getattr(jfinal, name))
        got = getattr(final, name).numpy()
        for i in range(3):
            scale = float(np.max(np.abs(want[i])))
            assert float(np.max(np.abs(got[i] - want[i]))) <= TOL * scale, (name, i)
    _assert_obs_close(obs, jobs, TOL)
    for i, (mask, value) in enumerate(geoms):
        solo = _port_model()
        solo.init_random(0.1)
        solo.set_solid(mask, value)
        solo.update_n(steps)
        for name in final._fields:
            np.testing.assert_allclose(getattr(final, name)[i].numpy(),
                                       getattr(solo.state, name).numpy(), rtol=1e-9, atol=1e-13)
    with pytest.raises(ValueError, match="plain template"):
        solid = _port_model()
        solid.set_solid(geoms[0][0])
        pt.geometry_sweep(solid, geoms, 1)


@pytest.mark.parametrize("route", ["dense", "mesh4"])
def test_geometry_sweep_on_other_routes_matches_solo(route):
    _, kw, _ = ROUTES[route]
    template = _port_model(**kw)
    template.init_random(0.1)
    geoms = [pt.solid_roughness_sinusoid(*template.x, 0.1, 10.0),
             pt.solid_cylinder_inner(*template.x, 0.2, 0.1, 0.25)]
    final, _ = pt.geometry_sweep(template, geoms, 4)
    for i, (mask, value) in enumerate(geoms):
        solo = _port_model(**kw)
        solo.init_random(0.1)
        solo.set_solid(mask, value)
        solo.update_n(4)
        for name, x in zip(final._fields, final):
            assert torch.equal(x[i], getattr(solo.state, name)), (route, i, name)


# -- HC and the scenario modifiers ---------------------------------------------------------


@pytest.mark.parametrize("case", ["hc_dense", "scenario_fused"])
def test_hc_and_scenario_ensembles_match_jax(case):
    if case == "hc_dense":
        jkw, kw, route = dict(bc="hc"), dict(bc="hc", **DENSE), "dense"
    else:
        # the scalar at 3x the thermal diffusivity, released as half the
        # temperature
        scn = dict(coriolis=2.0, passive_scalar=True,
                   scalar_kappa=3.0 * _port_model().params["ka"])
        jkw = dict(scenario=JaxScenarioConfig(**scn))
        kw, route = dict(scenario=pt.ScenarioConfig(**scn)), "fused"
    jens = rp.NavierEnsemble.from_seeds(_jax_model(route=route, **jkw), seeds=[0, 1])
    if "scal" in jens.state._fields:
        jens.state = jens.state._replace(scal=0.5 * jens.state.temp)
    port = _port_from_jax(jens, _port_model(**kw))
    for ens in (jens, port):
        ens.update_n(5)
    _assert_members_close(port, _jax_numpy(jens), TOL)
    _assert_obs_close(port.get_observables(), [np.asarray(v) for v in jens.get_observables()], TOL)
    assert port.observable_names == tuple(jens.observable_names)


# -- the driver and the callback -----------------------------------------------------------


def test_integrate_drives_an_ensemble(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the callback writes data/ in the working directory
    ens = pt.NavierEnsemble.from_seeds(_port_model(), range(2))
    assert integrate(ens, 0.04, 0.02) == "time_limit"
    assert ens.steps_done.tolist() == [4, 4]
    assert len(ens.diagnostics["nu"]) == 2 and len(ens.diagnostics["nu"][0]) == 2
    assert ens.diagnostics["alive"][-1] == [1.0, 1.0]
    assert "alive = 2/2" in capsys.readouterr().out


# -- the kernels' plain versions on member-stacked inputs ----------------------------------


def _rng_like(rng, x):
    if x.is_complex():
        parts = rng.standard_normal(tuple(x.shape) + (2,))
        return torch.view_as_complex(torch.as_tensor(parts))
    return torch.as_tensor(rng.standard_normal(tuple(x.shape)), dtype=x.dtype)


@pytest.mark.parametrize("cell", ["confined", "periodic"])
def test_stage_and_conv_plain_members_equal_unbatched_calls(cell):
    model = _port_model(cell, scenario=pt.ScenarioConfig(coriolis=2.0, passive_scalar=True))
    rng = np.random.default_rng(3)
    for tag, st in model._stages.items():
        rows = [k0 // 2 if st.complex_io else k0 for k0 in st.k0]
        dtype = st.io_dtype
        xs = [_rng_like(rng, torch.empty((3, r, k1), dtype=dtype)) for r, k1 in zip(rows, st.k1)]
        batched = st.apply(*xs)
        assert batched.shape[0] == 3
        for i in range(3):
            assert torch.equal(batched[i], st.apply(*(x[i] for x in xs))), tag
    ux, uy = (torch.as_tensor(rng.standard_normal((3,) + model.field_space.shape_physical))
              for _ in range(2))
    for space in (model.velx_space, model.temp_space):
        fc = model._convs[id(space)]
        vhat = _rng_like(rng, torch.empty((3,) + space.shape_spectral,
                                          dtype=space.spectral_dtype))
        for bc in ((), (model._tempbc_dx, model._tempbc_dy)):
            batched = fc.apply(ux, uy, vhat, *bc)
            for i in range(3):
                assert torch.equal(batched[i], fc.apply(ux[i], uy[i], vhat[i], *bc))


@pytest.mark.parametrize("complex_rhs", [False, True])
def test_banded_plain_members_equal_unbatched_calls(complex_rhs):
    """Per-lane factors with a factor batch stride: a member-stacked pencil
    ``(K, P, n, lanes)`` in one call with the factor batch period P equals
    each member's own call, and the period is what keeps member k's rank r
    on rank r's factor sets."""
    rng = np.random.default_rng(5)
    p, n, c = 4, 13, 3
    dense = rng.standard_normal((p * c, n, n)) * 0.1 + 4.0 * np.eye(n)
    band = np.triu(np.tril(dense, 4), -2)
    solver = BandedSolver(*banded_lu_factor(band, 2, 4), device="cpu", dtype=torch.float64)
    shape = (K, p, c, n)
    b = _rng_like(rng, torch.empty(shape, dtype=torch.complex128 if complex_rhs
                                   else torch.float64))
    got = solver.solve(b, -1, factor_batch_stride=c, factor_batch_period=p)
    for i in range(K):
        assert torch.equal(got[i], solver.solve(b[i], -1, factor_batch_stride=c))
    with pytest.raises(ValueError, match="factor"):
        solver.solve(b, -1, factor_batch_stride=c)  # K x P entries past the sets
    shared = BandedSolver(*banded_lu_factor(band[0], 2, 4), device="cpu", dtype=torch.float64)
    b2 = torch.as_tensor(rng.standard_normal((K, n, 7)))
    got = shared.solve(b2, 1)
    for i in range(K):
        assert torch.equal(got[i], shared.solve(b2[i], 0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_ring_plain_members_equal_unbatched_calls(dtype):
    ring = RingTranspose(4, "cpu")
    rng = np.random.default_rng(9)
    x = _rng_like(rng, torch.empty((K, 4, 12, 5), dtype=dtype))
    y = ring.x_to_y(x)
    assert y.shape == (K, 4, 3, 20)
    for i in range(K):
        assert torch.equal(y[i], ring.x_to_y(x[i]))
    assert torch.equal(ring.y_to_x(y), x)


def test_job_sets_member_strides():
    """A member-stacked operand gets its leading stride as the member
    stride, a 2-D one (shared by the members) 0; the copy-width bit of a
    member-stacked operand needs its member stride on 16 bytes too."""
    f64 = torch.float64
    shared = _build.padded(8, 8, device="cpu", dtype=f64)
    per = _build.padded(3, 8, 8, device="cpu", dtype=f64)
    # rows on 16 bytes, the member stride (65 elements, 520 bytes) not
    odd = torch.zeros(3 * 65, dtype=f64).as_strided((3, 8, 8), (65, 8, 1))
    out = _build.padded(3, 8, 8, device="cpu", dtype=f64)
    j = _build.job(out, [(shared, per), (odd, shared)], M=8, N=8, members=3, E=shared)
    assert (j.sA[0], j.sB[0], j.sA[1], j.sB[1], j.sC, j.sE) == (0, per.stride(0),
                                                               odd.stride(0), 0,
                                                               out.stride(0), 0)
    assert j.vec == 0b1011  # B[1], A[0] and B[0]; not A[1]
    with pytest.raises(ValueError, match="member-stacked output"):
        _build.job(shared, [(shared, shared)], M=8, N=8, members=3)
    with pytest.raises(ValueError, match="2 members in a launch of 3"):
        _build.job(out, [(shared, per[:2])], M=8, N=8, members=3)
    with pytest.raises(ValueError, match="members"):
        _build.launch_jobs(None, [j], torch.device("cpu"), 0)

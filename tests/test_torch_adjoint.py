"""PyTorch port: the steady-state finder ``Navier2DAdjoint``, its ensembles
and the workload registry, against the JAX package on the CPU.

* 10 iterations at 17^2 (16x17 periodic) on the fused, dense and meshed (4
  ranks) routes, rbc in both cells and hc confined, against the JAX finder
  on its fused route (Pallas kernels in interpret mode) or its default
  dense one: every leaf within 1e-11 of its scale but the pseudo-pressure
  ``pseu`` (1e-10: the descent's projection of a nearly divergence-free
  field, its scale 4e4 times below the velocities'; the JAX package's own
  two routes differ there by 1.35e-11), the residual norms and the
  observables within rel 1e-11;
* a K = 2 finder ensemble converging at Ra 100 with ``res_tol`` 1e-5, one
  member at step 12 and one later: ``steps_done``, ``done_ok_members`` and
  the alive mask exactly the JAX ensemble's, the members frozen at their
  converged states (within 1e-11 of each leaf's scale, at least res_tol:
  near rest the fields are 1e-7), a converged solo run equal to its member
  bit for bit;
* the solo-vs-ensemble parity probe for all three kinds below 1e-9;
* gathered snapshots of a finder and of its ensembles written by either
  package and read by the other (the residual norms restart at +inf);
* ``respawn_dead`` on a finder ensemble bit for bit against the JAX one,
  but the respawned member's residual norms, which restart at +inf;
* the registry: kinds, compat keys equal to the JAX models', key round
  trips, the contract check, the registry's refusals.
"""

import gc

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu.models.steady_adjoint import Navier2DAdjoint as JaxAdjoint
from rustpde_mpi_tpu.workloads import registry as jax_registry
from rustpde_mpi_tpu.workloads import steady as jax_steady

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.models.steady_adjoint import DT_NAVIER, RES_TOL
from rustpde_mpi_tpu_torch.workloads import registry, steady

TOL = 1e-11
PSEU_TOL = 1e-10
STEPS = 10
PARAMS = (1e4, 1.0, 5e-3, 1.0)
SHAPES = {"confined": (17, 17), "periodic": (16, 17)}
FUSED_ENV = {"RUSTPDE_CONV_KERNEL": "pallas", "RUSTPDE_STEP_KERNEL": "pallas"}
DENSE = dict(step_kernel="dense", conv_kernel="dense")
#: the port's routes: constructor arguments and the JAX route they are held to
ROUTES = {"fused": ({}, "fused"), "dense": (DENSE, "dense"), "mesh": ({"mesh": True}, "dense")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread (tiny grids); drop the JAX objects this module
    built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _seed(model, amp=0.3):
    model.set_temperature(amp, 1.0, 1.0)
    model.set_velocity(amp, 1.0, 1.0)


def _jax_model(route="dense", cell="confined", bc="rbc", **kw):
    nx, ny = SHAPES[cell]
    with pytest.MonkeyPatch.context() as mp:
        if route == "fused":
            for key, value in FUSED_ENV.items():
                mp.setenv(key, value)
        return JaxAdjoint(nx, ny, *PARAMS, bc, periodic=cell == "periodic", **kw)


def _port_model(route="dense", cell="confined", bc="rbc", **kw):
    nx, ny = SHAPES[cell]
    kw = {**ROUTES[route][0], **kw}
    if kw.pop("mesh", False):
        kw["mesh"] = pt.make_mesh(4, "cpu")
    else:
        kw["device"] = "cpu"
    return pt.Navier2DAdjoint(nx, ny, *PARAMS, bc, periodic=cell == "periodic", **kw)


def _space_of(model, name):
    return getattr(model, f"{'pres' if name == 'pres_adj' else name}_space")


def _port_leaf(model, state, name):
    leaf = getattr(state, name)
    return leaf.numpy() if name == "res_norms" else _space_of(model, name).gather_spectral(leaf).numpy()


def _assert_states_close(model, state, want, tol=TOL, fields=None, floor=1e-300):
    """Every leaf within ``tol`` of its scale, at least ``floor`` (``pseu``
    within PSEU_TOL); infinite residual norms must be infinite in both."""
    for name in fields or state._fields:
        if name == "res_norms" and np.isinf(np.asarray(want.res_norms)).any():
            assert np.array_equal(_port_leaf(model, state, name), np.asarray(want.res_norms))
            continue
        w = np.asarray(getattr(want, name))
        got = _port_leaf(model, state, name)
        scale = max(float(np.max(np.abs(w))), floor)
        limit = (PSEU_TOL if name == "pseu" else tol) * scale
        assert float(np.max(np.abs(got - w))) <= limit, (name, float(np.max(np.abs(got - w))) / scale)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX finder after STEPS iterations, by (route, cell, bc), stepped
    by ``update()`` (its step compiles once)."""
    cache = {}

    def get(route, cell, bc):
        if (route, cell, bc) not in cache:
            jm = _jax_model(route, cell, bc)
            _seed(jm)
            for _ in range(STEPS):
                jm.update()
            cache[route, cell, bc] = (jm.state, np.asarray(jm.get_observables()),
                                      jm.norm_residual())
        return cache[route, cell, bc]

    return get


CASES = [(r, "confined", "rbc") for r in ROUTES] + [(r, "periodic", "rbc") for r in ROUTES] \
    + [("fused", "confined", "hc"), ("dense", "confined", "hc")]


@pytest.mark.parametrize("route,cell,bc", CASES, ids=["-".join(c) for c in CASES])
def test_finder_matches_jax(jax_runs, route, cell, bc):
    state, obs, norms = jax_runs(ROUTES[route][1], cell, bc)
    pm = _port_model(route, cell, bc)
    _seed(pm)
    pm.update_n(STEPS)
    _assert_states_close(pm, pm.state, state)
    np.testing.assert_allclose(pm.norm_residual(), norms, rtol=TOL, atol=0.0)
    np.testing.assert_allclose(pm.get_observables(), obs, rtol=TOL, atol=0.0)
    assert pm.residual() == pytest.approx(float(np.mean(norms)), rel=TOL)
    assert pm.navier.dt == DT_NAVIER
    # the smoothing norms' and the projection's solves are banded launches
    assert len(pm.kernels()["banded_solve"]) >= 3


# -- convergence inside the chunk ---------------------------------------------------


#: a converging finder pair: member 0 from rest (the conduction state),
#: member 1 from a 1e-4 random disturbance, at Ra 100 with res_tol 1e-5
STEADY_ARGS = (17, 17, 100.0, 1.0, 1e-3, 1.0, "rbc", False)
STEADY_VARIANT = {"res_tol": 1e-5}
STEADY_STEPS = 64


def _steady_members(build, **kw):
    model = build("adjoint", *STEADY_ARGS, scenario=STEADY_VARIANT, **kw)
    rest = model.state
    model.init_random(1e-4, seed=1)
    return model, [rest, model.state]


@pytest.fixture(scope="module")
def jax_steady_run():
    ens = rp.NavierEnsemble(*_steady_members(jax_registry.build_model))
    ens.update_n(STEADY_STEPS)
    return (ens.state, np.asarray(ens.steps_done), ens.done_ok_members(), ens.alive(),
            np.asarray(ens.get_observables()[0]))


def test_steady_ensemble_freezes_members_at_convergence(jax_steady_run):
    """Member 0 converges at step 12 and freezes there, inside the chunk,
    while member 1 goes on to its own convergence; each is frozen at its
    converged (committed) state, and the counts, the success flags and the
    alive mask are the JAX ensemble's."""
    state, steps_done, done_ok, alive, res = jax_steady_run
    ens = pt.NavierEnsemble(*_steady_members(registry.build_model, device="cpu"))
    ens.update_n(STEADY_STEPS)
    assert ens.steps_done.tolist() == steps_done.tolist()
    assert 0 < steps_done[0] < steps_done[1] < STEADY_STEPS
    assert ens.done_ok_members().tolist() == done_ok.tolist() == [True, True]
    assert ens.alive().tolist() == alive.tolist() == [False, False]
    assert ens.state_healthy() and ens.exit()
    np.testing.assert_allclose(ens.get_observables()[0], res, rtol=1e-9, atol=0.0)
    assert (ens.get_observables()[0] < STEADY_VARIANT["res_tol"]).all()
    # near rest the perturbation fields are 1e-7 while their roundoff
    # comes from the O(1) conduction lift: the scale floor is res_tol
    for i in range(ens.k):
        _assert_states_close(ens.model, ens.member_state(i),
                             type(state)(*(np.asarray(x)[i] for x in state)),
                             floor=STEADY_VARIANT["res_tol"])
    # a solo run from rest stops where member 0 froze
    solo, (rest, _) = _steady_members(registry.build_model, device="cpu")
    solo.state = rest
    solo.update_n(STEADY_STEPS)
    assert solo.exit()
    for a, b in zip(solo.state, ens.member_state(0)):
        assert torch.equal(a, b)


def test_solo_ensemble_parity_of_every_kind():
    deltas = pt.solo_ensemble_parity(steps=5, device="cpu")
    assert set(deltas) == {"dns", "lnse", "adjoint"}
    for kind, row in deltas.items():
        assert row["max_rel_diff"] < 1e-9, (kind, row)


def test_set_dt_keeps_the_embedded_model():
    """The finder's dt is the descent's pseudo-time step: ``set_dt`` leaves
    the embedded model at ``DT_NAVIER`` and an iteration then equals a
    finder built at the new dt."""
    pm, fresh = _port_model(), _port_model()
    fresh = pt.Navier2DAdjoint(*SHAPES["confined"], PARAMS[0], PARAMS[1], PARAMS[2] / 2,
                               PARAMS[3], "rbc", device="cpu", **DENSE)
    for m in (pm, fresh):
        _seed(m)
    pm.set_dt(PARAMS[2] / 2)
    assert pm.navier.dt == DT_NAVIER and pm.navier.recompile_count == 1
    assert pm.compat_key == fresh.compat_key
    pm.update_n(3)
    fresh.update_n(3)
    for a, b in zip(pm.state, fresh.state):
        assert torch.equal(a, b)


def test_sentinel_chunk_matches_the_plain_chunk():
    plain, armed = _port_model(), _port_model()
    for m in (plain, armed):
        _seed(m)
    armed.set_stability(pt.StabilityConfig(max_cfl=10.0))
    plain.update_n(6)
    status = armed.update_n(6)
    assert status.steps_done == 6 and not status.pre_divergence
    for a, b in zip(plain.state, armed.state):
        assert torch.equal(a, b)


# -- snapshots -------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_finder_snapshots_cross_read(tmp_path, writer):
    """A finder's snapshot (the embedded model's gathered layout) written
    by either package restores into the other: the fields to 1e-14 of
    their scale, the residual norms at +inf, the adjoint pressure kept."""
    pytest.importorskip("h5py")
    jm, pm = _jax_model(), _port_model()
    for m in (jm, pm):
        _seed(m)
    jm.update_n(4)
    pm.update_n(4)
    path = str(tmp_path / "adjoint.h5")
    (jm if writer == "jax" else pm).write(path)
    target = _port_model() if writer == "jax" else _jax_model()
    keep = target.state.pres_adj
    target.read(path)
    src = jm if writer == "jax" else pm
    fields = ("temp", "velx", "vely", "pres")
    if writer == "jax":
        _assert_states_close(target, target.state, jm.state, 1e-14, fields)
        assert torch.isinf(target.state.res_norms).all()
        assert target.state.pres_adj is keep
    else:
        _assert_states_close(pm, pm.state, target.state, 1e-14, fields)
        assert np.isinf(np.asarray(target.state.res_norms)).all()
    assert target.time == pytest.approx(src.time)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["adjoint", "lnse"])
def test_ensemble_snapshots_cross_read(tmp_path, kind, writer):
    """A K = 2 ensemble snapshot of a finder or a linearised model written
    by either package restores into the other: the stored fields to 1e-14
    of their scale, the leaves the layout does not store (``pseu``,
    ``pres_adj``; ``res_norms`` at +inf) by the restart rule, mask, counts
    and time as stored."""
    pytest.importorskip("h5py")
    args = (17, 17, *PARAMS, "rbc", False)
    jens = rp.NavierEnsemble.from_seeds(jax_registry.build_model(kind, *args), seeds=[1, 2],
                                        amp=0.1)
    pens = pt.NavierEnsemble.from_seeds(registry.build_model(kind, *args, device="cpu"),
                                        seeds=[1, 2], amp=0.1)
    jens.update_n(3)
    pens.update_n(3)
    path = str(tmp_path / "ens.h5")
    (jens if writer == "jax" else pens).write(path)
    src = jens if writer == "jax" else pens
    dst_j = rp.NavierEnsemble.from_seeds(jax_registry.build_model(kind, *args), seeds=[0], amp=0.1)
    dst_p = pt.NavierEnsemble.from_seeds(registry.build_model(kind, *args, device="cpu"),
                                         seeds=[0], amp=0.1)
    dst_j.read(path)
    dst_p.read(path)
    assert dst_p.k == dst_j.k == 2 and dst_p.time == pytest.approx(src.time)
    assert dst_p.alive().tolist() == list(np.asarray(dst_j.alive()))
    for i in range(2):
        want = type(dst_j.state)(*(np.asarray(x)[i] for x in dst_j.state))
        _assert_states_close(dst_p.model, dst_p.member_state(i), want, 1e-14)
        if kind == "adjoint":
            assert torch.isinf(dst_p.state.res_norms).all()
            assert not dst_p.state.pres_adj.any()


def test_respawn_dead_finder_matches_jax():
    """A dead finder member respawned from a donor with seed 7: every
    field bit for bit the JAX ensemble's, its residual norms +inf."""
    import jax.numpy as jnp

    jens = jax_steady.build_steady_ensemble(nx=17, ny=17, ra=1e4, k=2)
    jens.update_n(2)
    template = steady.build_steady_ensemble(nx=17, ny=17, ra=1e4, k=1, device="cpu").model
    # the port's ensemble holds the JAX ensemble's states exactly
    pens = pt.NavierEnsemble(template, type(template.state)(
        *(torch.as_tensor(np.array(x)) for x in jens.state)))
    jens.mask = jnp.asarray([True, False])
    pens.mark_dead([1])
    assert jens.respawn_dead(amp=1e-3, seed=7) == pens.respawn_dead(amp=1e-3, seed=7) == 1
    for name in pens.state._fields[:-1]:
        assert np.array_equal(getattr(pens.state, name).numpy(),
                              np.asarray(getattr(jens.state, name))), name
    # the respawned member is a new iterate: its residual norms restart at
    # +inf (the JAX package perturbs the donor's norms like a field)
    assert torch.isinf(pens.state.res_norms[1]).all()
    assert torch.equal(pens.state.res_norms[0], torch.as_tensor(np.array(jens.state.res_norms[0])))


# -- the registry ------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dns", "lnse", "adjoint"])
def test_registry_builds_models_of_the_jax_keys(kind):
    args = (17, 17, 1e4, 1.0, 5e-3, 1.0, "rbc", False)
    scenario = {"res_tol": 1e-6} if kind == "adjoint" else None
    jm = jax_registry.build_model(kind, *args, scenario=scenario)
    pm = registry.build_model(kind, *args, scenario=scenario, device="cpu")
    assert pm.compat_key == tuple(jm.compat_key)
    assert pm.MODEL_KIND == kind and pm.observable_names == tuple(jm.observable_names)
    assert registry.validate_campaign_model(pm) == []
    again = registry.build_model_for_key(pm.compat_key + ("stamp",), device="cpu")
    assert again.compat_key == pm.compat_key and type(again) is type(pm)
    assert registry.model_kinds() == jax_registry.model_kinds()


def test_registry_refusals():
    args = (17, 17, 1e4, 1.0, 5e-3, 1.0, "rbc", False)
    with pytest.raises(KeyError, match="registered"):
        registry.build_model("swift", *args, device="cpu")
    with pytest.raises(ValueError, match="DNS axis"):
        registry.build_model("lnse", *args, scenario={"coriolis": 1.0}, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        registry.build_model("adjoint", *args, scenario={"eta": 1.0}, device="cpu")
    assert registry.build_model("adjoint", *args, device="cpu").res_tol == RES_TOL
    assert "kernels" in registry.validate_campaign_model(object())
    with pytest.raises(TypeError, match="not supported"):
        registry.build_model("lnse", *args, device="cpu").set_stats(pt.StatsConfig())


def test_callback_writes_the_finder_files(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    monkeypatch.chdir(tmp_path)
    pm = _port_model()
    _seed(pm)
    pm.update_n(2)
    pm.callback()
    assert (tmp_path / "data" / f"adjoint{pm.time:08.2f}.h5").is_file()
    assert (tmp_path / "data" / "info_adjoint.txt").read_text().count("\n") == 1
    assert not pm.exit()

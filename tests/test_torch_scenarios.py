"""PyTorch port: the scenario modifiers (Coriolis, the passive scalar and
its Sherwood number) and solid obstacles in the step, against the JAX
package, on the CPU.

The same numpy-seeded state goes through the JAX package (f64 on the CPU;
its fused route with both Pallas kernels in interpret mode, as
``tests/test_pallas_step.py`` runs them, its default dense route with
neither set) and the port (``device="cpu"``: every kernel wrapper runs its
plain version).  Tolerances: the fused stages to 1e-12 of max|out| (the
same linear maps summed in another order); five steps of each route to
1e-11 of each field's scale, ``scal`` included, and the observables,
``sherwood`` included, to rel 1e-11 (the same algebra summed in other
orders, five steps of growth); step counts, flags and non-finite masks
exactly; the port against itself (a zero Coriolis rate, a removed obstacle)
bit for bit.  Grids: 17^2 (confined), 16x17 (periodic); the meshed route
on 2 and 4 ranks against the JAX serial model.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu import bases as jb
from rustpde_mpi_tpu.models import navier as jnavier
from rustpde_mpi_tpu.models.solid_masks import solid_roughness_sinusoid as jax_roughness
from rustpde_mpi_tpu.workloads import ScenarioConfig as JaxScenario

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch.models import navier as tnavier
from rustpde_mpi_tpu_torch.models.functions import get_ka
from rustpde_mpi_tpu_torch.models.solid_masks import solid_roughness_sinusoid
from rustpde_mpi_tpu_torch.workloads import ScenarioConfig

PARAMS = dict(ra=1e4, pr=1.0, dt=5e-3, aspect=1.0)
KA = get_ka(PARAMS["ra"], PARAMS["pr"], 2.0)  # the thermal diffusivity
#: the modifier sets of the step parity cases: (scenario keys, obstacle)
MODIFIERS = {
    "solid": ({}, True),
    "coriolis": (dict(coriolis=2.0), False),
    "scalar": (dict(passive_scalar=True), False),
    "scalar_kappa3": (dict(passive_scalar=True, scalar_kappa=3.0 * KA), False),
    "all": (dict(coriolis=2.0, passive_scalar=True, scalar_kappa=3.0 * KA), True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread (tiny grids); drop the JAX objects this module
    built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _ref(nx, periodic, scenario, fused=False, bc="rbc"):
    """The JAX package's model: its default (dense) step, or its fused route
    with both Pallas kernels (interpret mode)."""
    with pytest.MonkeyPatch.context() as mp:
        if fused:
            mp.setenv("RUSTPDE_STEP_KERNEL", "pallas")
            mp.setenv("RUSTPDE_CONV_KERNEL", "pallas")
        model = rp.Navier2D(nx, 17, *PARAMS.values(), bc, periodic=periodic,
                            scenario=JaxScenario(**scenario) if scenario else None)
    assert (model._step_impl is not None) == fused
    return model


def _port(nx, periodic, scenario, route="dense", bc="rbc", **kw):
    if route != "mesh":
        kw.update(device="cpu", step_kernel=route, conv_kernel=route)
    return pt.Navier2D(nx, 17, *PARAMS.values(), bc, periodic=periodic,
                       scenario=ScenarioConfig(**scenario) if scenario else None, **kw)


def _start(models, solid, seed=0):
    """The same initial state in each model: ``init_random``, a scalar
    released apart from the temperature, and the roughness obstacle."""
    for m in models:
        m.init_random(0.1, seed=seed)
        if "scal" in m.state._fields:
            rng = np.random.default_rng(seed + 7)
            m.set_field("scal", 0.1 * rng.uniform(-1.0, 1.0, m.temp_space.shape_physical))
        if solid:
            builder = jax_roughness if isinstance(m, rp.Navier2D) else solid_roughness_sinusoid
            m.set_solid(*builder(*m.x, 0.1, 10.0))


def _jax_steps(ref, n):
    """``n`` steps of the JAX model, each one call of its jitted step (one
    compile; its ``update_n`` compiles a scan for each bucket length)."""
    for _ in range(n):
        ref.update()


def _jax_state(ref) -> dict:
    return {f: np.asarray(v) for f, v in zip(ref.state._fields, ref.state)}


def _assert_state_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for name in want:
        scale = max(float(np.max(np.abs(want[name]))), 1e-300)
        diff = float(np.max(np.abs(got[name] - want[name])))
        assert diff <= tol * scale, (name, diff, scale)


def _assert_obs_close(port, ref, rel=1e-11):
    assert port.observable_names == ref.observable_names
    got, want = port.get_observables(), ref.get_observables()
    assert len(got) == len(want) == len(port.observable_names)
    for name, g, w in zip(port.observable_names, got, want):
        assert g == pytest.approx(float(w), rel=rel), name


def _assert_bit_equal(a, b):
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


# -- the scenario surface ---------------------------------------------------------


def test_scenario_signature_matches_reference():
    cases = [None, {}, ScenarioConfig(), ScenarioConfig(coriolis=0.0),
             ScenarioConfig(coriolis=2.0), ScenarioConfig(passive_scalar=True),
             ScenarioConfig(passive_scalar=True, scalar_kappa=0.25),
             {"coriolis": 1.5, "passive_scalar": True},
             {"coriolis": None, "passive_scalar": False, "scalar_kappa": 3.0}]
    for scn in cases:
        jscn = JaxScenario(**scn.to_dict()) if isinstance(scn, ScenarioConfig) else scn
        assert tnavier.scenario_signature(scn) == jnavier.scenario_signature(jscn), scn
    assert ScenarioConfig(coriolis=2.0).signature == (("coriolis", 2.0),)
    assert ScenarioConfig().to_dict() == JaxScenario().to_dict()
    for kappa in (0.0, -1.0):
        for sign, cfg in ((tnavier.scenario_signature, ScenarioConfig),
                          (jnavier.scenario_signature, JaxScenario)):
            with pytest.raises(ValueError, match="scalar_kappa must be positive"):
                sign(cfg(passive_scalar=True, scalar_kappa=kappa))
    with pytest.raises(ValueError, match="scalar_kappa must be positive"):
        _port(17, False, dict(passive_scalar=True, scalar_kappa=-1.0))


def test_scenario_state_and_vocabulary():
    ref = _ref(17, False, dict(passive_scalar=True))
    for route in ("fused", "dense"):
        port = _port(17, False, dict(passive_scalar=True), route)
        assert port.state._fields == ref.state._fields == tnavier.NavierScalarState._fields
        assert port.observable_names == ref.observable_names == \
            ("nu", "nuvol", "re", "div", "sherwood")
        assert port.snapshot_vars == ref.snapshot_vars
        assert port.scal_space is port.temp_space
        plain = _port(17, False, None, route)
        assert plain.observable_names == ("nu", "nuvol", "re", "div")
        assert plain.snapshot_vars == ref.snapshot_vars[:4] and plain.scenario is None
    # matched diffusivity on the dense route: the temperature's solver, shared
    assert port.solver_scal is port.solver_temp
    assert len(port.kernels()["banded_solve"]) == 5
    assert "scal" not in plain.state._fields and plain.solver_scal is None


# -- the fused stages: five terms, and the scalar's stage ------------------------------


def test_coriolis_and_scalar_stages_match_pallas_stages():
    scn = MODIFIERS["all"][0]
    ref = _ref(17, False, scn, fused=True)
    port = _port(17, False, scn, "fused")
    assert [len(port._stages[t].terms) for t in ("velx", "vely", "scal")] == [4, 5, 2]
    assert sorted(port._stages) == sorted(ref._step_impl)
    for tag in ("velx", "vely", "temp", "scal"):
        st = port._stages[tag]
        rng = np.random.default_rng(len(tag))
        xs = [rng.uniform(-1.0, 1.0, (k0, k1)) for k0, k1 in zip(st.k0, st.k1)]
        want = np.asarray(ref._step_impl[tag].apply(*[jnp.asarray(x) for x in xs]))
        got = st.apply(*[torch.as_tensor(x) for x in xs]).numpy()
        scale = float(np.max(np.abs(want)))
        assert float(np.max(np.abs(got - want))) <= 1e-12 * scale, tag
        assert st.flops == ref._step_impl[tag].flops, tag
    # the scalar at 3x the thermal diffusivity solves another system
    scal, temp = port._stages["scal"], port._stages["temp"]
    assert not torch.allclose(scal.ls[0], temp.ls[0], rtol=1e-6, atol=0.0)


# -- five steps on each route, against the JAX package ---------------------------------


@pytest.mark.parametrize("mods", sorted(MODIFIERS))
@pytest.mark.parametrize("periodic", [False, True], ids=["confined", "periodic"])
@pytest.mark.parametrize("route", ["fused", "dense"])
def test_five_steps_match_reference(route, periodic, mods):
    scenario, solid = MODIFIERS[mods]
    nx = 16 if periodic else 17
    ref = _ref(nx, periodic, scenario, fused=route == "fused")
    port = _port(nx, periodic, scenario, route)
    _start((ref, port), solid)
    _assert_state_close(convert.state_to_numpy(port), _jax_state(ref), 1e-13)
    _jax_steps(ref, 5)
    port.update_n(5)
    _assert_state_close(convert.state_to_numpy(port), _jax_state(ref), 1e-11)
    _assert_obs_close(port, ref)
    assert sum(k.launches for ks in port.kernels().values() for k in ks) == 0


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_hc_with_every_modifier_matches_reference(route):
    scenario, _ = MODIFIERS["all"]
    ref = _ref(17, False, scenario, fused=route == "fused", bc="hc")
    port = _port(17, False, scenario, route, bc="hc")
    _start((ref, port), True)
    _jax_steps(ref, 5)
    for _ in range(5):
        port.update()
    _assert_state_close(convert.state_to_numpy(port), _jax_state(ref), 1e-11)
    _assert_obs_close(port, ref)
    if route == "dense":
        # the temperature's and (another diffusivity) the scalar's y solves
        # run the banded kernel's general path
        paths = [k.path for k in port.kernels()["banded_solve"]]
        assert len(paths) == 7 and paths.count("general") == 2


@pytest.mark.parametrize("periodic, nranks, bc", [(False, 4, "rbc"), (True, 2, "hc"),
                                                  (True, 4, "rbc")],
                         ids=["confined-4-rbc", "periodic-2-hc", "periodic-4-rbc"])
def test_meshed_route_matches_serial_reference(periodic, nranks, bc):
    """The port's meshed route (every modifier, the scalar at matched
    diffusivity) against the JAX package's serial model."""
    scenario = dict(coriolis=2.0, passive_scalar=True)
    nx = 16 if periodic else 17
    ref = _ref(nx, periodic, scenario, bc=bc)
    port = _port(nx, periodic, scenario, "mesh", bc=bc, mesh=pt.make_mesh(nranks, "cpu"))
    _start((ref, port), True)
    _jax_steps(ref, 5)
    port.update_n(5)
    _assert_state_close(convert.state_to_numpy(port), _jax_state(ref), 1e-11)
    _assert_obs_close(port, ref)


def test_meshed_step_flips_and_solves():
    """One meshed step with every modifier flips 56 pencils (37 + 4 for the
    Coriolis terms' ortho transforms + 7 for the scalar's convection,
    ortho transform and solve + 8 for the penalization's four round trips)
    and runs 9 banded solves (the scalar's two on the temperature's
    solver); an observables read flips 13 (10 + 3 for Sherwood).  These
    are the counts ``chip_smoke.py`` pins on the card."""
    mesh = pt.make_mesh(4, "cpu")
    model = _port(17, False, dict(coriolis=2.0, passive_scalar=True), "mesh", mesh=mesh)
    _start((model,), True)
    flips = []
    plain = mesh.ring.plain
    mesh.ring.plain = lambda b, x_to_y: flips.append(b.dtype) or plain(b, x_to_y)
    solves = []
    for k in model.kernels()["banded_solve"]:
        kplain = k.plain
        k.plain = lambda b, f=0, q=0, kp=kplain: solves.append(b.shape) or kp(b, f, q)
    model.update()
    assert (len(flips), len(solves)) == (56, 9)
    flips.clear()
    model.get_observables()
    assert len(flips) == 13


# -- the mirror, the freeze and the toggles ----------------------------------------------


@pytest.mark.parametrize("route", ["fused", "dense", "mesh"])
def test_scalar_mirrors_temperature(route):
    """A scalar released equal to the temperature at matched diffusivity
    stays equal to it bit for bit (the same operators on the same inputs),
    obstacle and Coriolis included, and Sherwood equals Nu."""
    kw = dict(mesh=pt.make_mesh(4, "cpu")) if route == "mesh" else {}
    port = _port(17, False, dict(coriolis=2.0, passive_scalar=True), route, **kw)
    _start((port,), True)
    port.state = port.state._replace(scal=port.state.temp.clone())
    port.update_n(10)
    assert torch.equal(port.state.scal, port.state.temp)
    obs = dict(zip(port.observable_names, port.get_observables()))
    assert obs["sherwood"] == pytest.approx(obs["nu"], rel=1e-11)


def _masks(state) -> dict:
    return {f: np.isfinite(np.asarray(v)).tolist() for f, v in zip(state._fields, state)}


@pytest.fixture(scope="module")
def jax_scalar_nan():
    """The reference's chunks from a state whose scalar alone holds a NaN
    (mode 0): ``_step_n(state, 8)`` and ``update_n(7)`` (buckets 4 and 3),
    their step counts, non-finite masks and ``exit()``."""
    ref = _ref(17, False, dict(passive_scalar=True))
    _start((ref,), False)
    bad = ref.state._replace(scal=ref.state.scal.at[0, 0].set(jnp.nan))
    frozen, done = ref._step_n(jax.tree.map(jnp.copy, bad), 8)
    ref.state = bad
    ref.update_n(7)
    return {"done": int(done), "masks_step_n": _masks(frozen), "masks_update_n": _masks(ref.state),
            "exit": ref.exit()}


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_nan_in_scalar_freezes_as_reference(jax_scalar_nan, route):
    """A NaN only in the scalar: the flow never reads it, so the freeze
    probe adds the scalar's sum, and the chunk stops after one step as the
    reference's does, with its non-finite masks; |div| turns NaN and
    ``exit()`` fires."""
    want = jax_scalar_nan
    port = _port(17, False, dict(passive_scalar=True), route)
    _start((port,), False)
    scal = port.state.scal.clone()
    scal[0, 0] = float("nan")
    bad = port.state._replace(scal=scal)
    stepped, done = port.step_n(bad, 8)
    assert int(done) == want["done"] == 1
    assert _masks(stepped) == want["masks_step_n"]
    port.state = bad
    port.update_n(7)
    assert _masks(port.state) == want["masks_update_n"]
    assert want["exit"] is True and port.exit() is True


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_zero_coriolis_is_no_scenario(route):
    a = _port(17, False, dict(coriolis=0.0), route)
    b = _port(17, False, None, route)
    assert tnavier.scenario_signature(a.scenario) == ()
    _start((a, b), False)
    a.update_n(5)
    b.update_n(5)
    _assert_bit_equal(a.state, b.state)


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_set_scenario_toggles_the_scalar_as_reference(route):
    """``set_scenario`` adds a zero ``scal`` (and keeps every other field),
    drops it again, rebuilds the stages or solvers and drops the captured
    chunks; the steps after each toggle match the reference's."""
    ref = _ref(17, False, None, fused=route == "fused")
    port = _port(17, False, None, route)
    _start((ref, port), False)
    port.update_n(2)
    _jax_steps(ref, 2)
    assert port._runners
    before = port.state
    scenario = dict(coriolis=1.0, passive_scalar=True, scalar_kappa=2.0 * KA)
    ref.set_scenario(JaxScenario(**scenario))
    port.set_scenario(ScenarioConfig(**scenario))
    assert not port._runners and port.scenario.coriolis == 1.0
    assert port.state._fields == ref.state._fields
    assert all(a is b for a, b in zip(port.state[:5], before))
    assert not torch.any(port.state.scal) and not np.any(np.asarray(ref.state.scal))
    for m in (ref, port):
        m.set_field("scal", m.get_field("temp"))
    _jax_steps(ref, 3)
    port.update_n(3)
    _assert_state_close(convert.state_to_numpy(port), _jax_state(ref), 1e-11)
    _assert_obs_close(port, ref)
    ref.set_scenario(None)
    port.set_scenario(None)
    assert port.state._fields == ref.state._fields == tnavier.NavierState._fields
    assert port.observable_names == ref.observable_names
    _jax_steps(ref, 2)
    port.update_n(2)
    _assert_state_close(convert.state_to_numpy(port), _jax_state(ref), 1e-11)


# -- convert.py carries the scalar -------------------------------------------------------


@pytest.mark.parametrize("layout", ["confined", "complex", "split", "mesh"])
def test_scalar_state_carried_through_convert(layout):
    periodic = layout != "confined"
    nx = 16 if periodic else 17
    scenario = dict(passive_scalar=True, scalar_kappa=3.0 * KA)
    ref = _ref(nx, periodic, scenario)
    _start((ref,), False, seed=3)
    _jax_steps(ref, 2)
    arrays = _jax_state(ref)
    assert "scal" in arrays
    if layout == "split":  # the JAX package's TPU layout of the Fourier axis
        arrays = {f: jb.fourier_r2c_split(nx).from_complex(a, axis=0) for f, a in arrays.items()}
    kw = dict(mesh=pt.make_mesh(4, "cpu")) if layout == "mesh" else {}
    port = _port(nx, periodic, scenario, "mesh" if kw else "dense", **kw)
    convert.state_from_numpy(port, arrays, split=layout == "split")
    back = convert.state_to_numpy(port)
    for f, want in _jax_state(ref).items():
        np.testing.assert_array_equal(back[f], want)
    with pytest.raises(KeyError):
        convert.state_from_numpy(port, {f: a for f, a in arrays.items() if f != "scal"},
                                 split=layout == "split")
    _jax_steps(ref, 3)
    port.update_n(3)
    _assert_state_close(convert.state_to_numpy(port), _jax_state(ref), 1e-11)

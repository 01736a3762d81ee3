"""PyTorch port: chunked stepping, the divergence freeze and the stability
sentinels against the JAX package, on the CPU.

The port's ``update_n`` runs the JAX package's bucket schedule
(``utils/jit.py::scan_buckets``), freezes a chunk at the first step whose
``sum(temp)`` is not finite (restarting the freeze flag at every bucket, as
the reference's ``lax.scan`` chunks do), and, with ``set_stability`` armed,
carries the CFL, kinetic-energy and |div| sentinels through the chunk and
rolls a chunk back when the CFL ceiling trips while the state is finite.
On the CPU the chunk runs eagerly; on a card it replays a CUDA graph
(tests/test_torch_cuda.py, chip_smoke.py).

The reference is the JAX package's default (dense) route at 17^2 in f64;
the port runs its dense route from the same state (carried through
``convert.py``) and, where only the counts and masks are compared, its fused
route too.  Tolerances: healthy chunks to 1e-11 of each field's scale (the
dense-route parity limit: the reference transforms by FFT, the port by
dense products); the sentinel scalars to rel 1e-11 (reductions of those
states); a meshed model's sentinels to rel 1e-12 of the serial port's
(tests/test_torch_parallel.py's limit, other blockings of the same
products); step counts, flags and non-finite masks exactly; the port's
chunk against its own eager steps bit for bit.
"""

import gc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu.config import StabilityConfig as JaxStabilityConfig
from rustpde_mpi_tpu.utils import integrate as jintegrate
from rustpde_mpi_tpu.utils.jit import scan_buckets as jax_scan_buckets
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch.config import StabilityConfig
from rustpde_mpi_tpu_torch.utils import integrate as tintegrate
from rustpde_mpi_tpu_torch.utils.governor import ChunkStatus
from rustpde_mpi_tpu_torch.utils.jit import scan_buckets

MODEL = (17, 17, 1e4, 1.0, 1e-2, 1.0, "rbc")
FIELDS = ("temp", "velx", "vely", "pres", "pseu")
ROUTES = {"fused": {}, "dense": dict(step_kernel="dense", conv_kernel="dense")}
#: a velocity factor that makes |div| overflow to inf while every field
#: stays finite (|div|^2 sums squares of ~1e160)
HUGE = 1e160


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny grids; afterwards the JAX objects
    this module built are collected (the JAX package shares its bases
    through a weak cache, which must not carry into the next test file of
    the worker)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


@pytest.fixture(scope="module")
def jax_plain():
    """The reference's dense-route model, shared so its compiled chunks
    are; each test starts it from ``start`` at t = 0."""
    model = rp.Navier2D.new_confined(*MODEL)
    model.start = model.state
    return model


@pytest.fixture(scope="module")
def jax_armed():
    model = rp.Navier2D.new_confined(*MODEL)
    model.set_stability(JaxStabilityConfig())
    model.start = model.state
    return model


def _restart(model, state=None):
    model.state = model.start if state is None else state
    model.time = 0.0
    model._obs_cache = None
    return model


def _port(ref, route="dense", **kw):
    """A port model on the CPU holding the reference's state exactly."""
    model = pt.Navier2D(*MODEL, device="cpu", **ROUTES.get(route, {}), **kw)
    convert.state_from_numpy(model, {f: np.asarray(getattr(ref.state, f)) for f in FIELDS})
    return model


def _dup(state):
    """A copy of a JAX state: the reference's chunk donates its input."""
    return jax.tree.map(jnp.copy, state)


def _nan_temp(ref):
    return ref.state._replace(temp=ref.state.temp.at[0, 0].set(jnp.nan))


def _nan_temp_port(model):
    temp = model.state.temp.clone()
    temp.view(-1)[0] = float("nan")
    return model.state._replace(temp=temp)


def _masks(state):
    return {f: np.isfinite(np.asarray(getattr(state, f))) for f in FIELDS}


def _port_masks(model, state):
    return {f: np.isfinite(convert.state_to_numpy(_with(model, state))[f]) for f in FIELDS}


def _with(model, state):
    model.state = state
    return model


def _assert_close(port, ref, tol):
    got = convert.state_to_numpy(port)
    for name in FIELDS:
        want = np.asarray(getattr(ref.state, name))
        scale = float(np.max(np.abs(want)))
        assert float(np.max(np.abs(got[name] - want))) <= tol * scale, name


def _assert_bit_equal(a, b):
    for name, x, y in zip(FIELDS, a, b):
        assert torch.equal(x, y), name


# -- the bucket schedule and healthy chunks ------------------------------------------


def test_scan_buckets_match_reference():
    for n in range(300):
        assert scan_buckets(n) == jax_scan_buckets(n), n
    assert scan_buckets(25) == [16, 4, 2, 3] and scan_buckets(50) == [32, 16, 2]


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_step_n_counts_and_freeze_match_reference(jax_plain, route):
    """64 healthy steps run in full; with temp mode 0 NaN the first step
    is the last, and its non-finite masks are the reference's."""
    ref = _restart(jax_plain)
    port = _port(ref, route)
    _, done = ref._step_n(_dup(ref.state), 64)
    _, got = port.step_n(port.state, 64)
    assert int(done) == int(got) == 64 and got.dtype == torch.int32
    frozen, done = ref._step_n(_dup(_nan_temp(ref)), 64)
    stepped, got = port.step_n(_nan_temp_port(port), 64)
    assert int(done) == int(got) == 1
    assert {f: m.tolist() for f, m in _port_masks(port, stepped).items()} == \
        {f: m.tolist() for f, m in _masks(frozen).items()}


@pytest.mark.parametrize("n", [7, 25])
def test_update_n_matches_reference(jax_plain, n):
    ref = _restart(jax_plain)
    port = _port(ref)
    ref.update_n(n)
    port.update_n(n)
    assert port.time == pytest.approx(ref.time, abs=1e-12)
    _assert_close(port, ref, 1e-11)


@pytest.mark.parametrize("route", ["fused", "dense", "mesh"])
def test_update_n_is_bitwise_update_steps(route):
    """The chunk (freeze arithmetic included) commits exactly the eager
    step's state: ``update_n(k)`` equals ``k`` calls of ``update()``."""
    kw = dict(mesh=pt.make_mesh(4, "cpu")) if route == "mesh" else ROUTES[route]
    a, b = (pt.Navier2D.new_confined(*MODEL, device="cpu", **kw) for _ in range(2))
    a.update_n(7)
    for _ in range(7):
        b.update()
    _assert_bit_equal(a.state, b.state)
    assert a.time == pytest.approx(b.time, abs=1e-15)
    assert not a.chunk_runner().captured and a.chunk_runner().pool_bytes == 0


# -- the divergence freeze and exit() --------------------------------------------------


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_nan_freeze_across_buckets_matches_reference(jax_plain, route):
    """``update_n(7)`` runs buckets 4 and 3: the NaN state is stepped once
    in each, as the freeze flag restarts, and frozen after; the masks and
    ``exit()`` are the reference's."""
    ref = _restart(jax_plain, _nan_temp(jax_plain))
    port = _port(ref, route)
    ref.update_n(7)
    port.update_n(7)
    assert port.time == pytest.approx(ref.time, abs=1e-12)
    assert {f: m.tolist() for f, m in _port_masks(port, port.state).items()} == \
        {f: m.tolist() for f, m in _masks(ref.state).items()}
    assert ref.exit() is True and port.exit() is True


def test_exit_on_nan_but_not_on_infinite_div(jax_plain):
    ref = _restart(jax_plain)
    port = _port(ref)
    huge = {f: getattr(ref.state, f) * (HUGE if f in ("velx", "vely") else 1.0) for f in FIELDS}
    ref.state = ref.state._replace(**huge)
    convert.state_from_numpy(port, {f: np.asarray(v) for f, v in huge.items()})
    for model in (ref, port):
        assert math.isinf(model.div_norm())
        assert model.exit() is False
    for name in FIELDS:
        assert np.isfinite(convert.state_to_numpy(port)[name]).all()
    ref.state = ref.state._replace(velx=ref.state.velx * jnp.nan)
    ref._obs_cache = None
    port.state = port.state._replace(velx=port.state.velx * float("nan"))
    assert ref.exit() is True and port.exit() is True


# -- the stability sentinels -----------------------------------------------------------


def _assert_status_matches(got, want, rel):
    assert isinstance(got, ChunkStatus) and got._fields == want._fields
    for key in ("requested", "steps_done", "finite", "cfl_ok", "pre_divergence", "dt"):
        assert getattr(got, key) == getattr(want, key), key
    for key in ("cfl_max", "ke", "ke_growth_max", "div_max"):
        assert getattr(got, key) == pytest.approx(getattr(want, key), rel=rel), key


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_sentinels_match_reference(jax_armed, route):
    ref = _restart(jax_armed)
    armed = _port(ref, route)
    plain = _port(ref, route)
    armed.set_stability(StabilityConfig())
    assert StabilityConfig() == StabilityConfig(**vars(JaxStabilityConfig()))
    want = ref.update_n(4)
    got = armed.update_n(4)
    assert armed.last_chunk_status is got and plain.update_n(4) is None
    _assert_status_matches(got, want, 1e-11)
    assert got.steps_done == 4 and got.finite and got.cfl_ok
    # the sentinel reductions only read the step's arrays
    _assert_bit_equal(armed.state, plain.state)
    assert armed.time == plain.time


def test_cfl_spike_rolls_back_and_breaks(jax_armed, capsys):
    """Velocities x200 after a healthy chunk: the first step trips the CFL
    ceiling while the state is finite, the chunk rolls back, ``exit()``
    latches and ``integrate`` stops at the chunk start, on both packages."""
    ref = _restart(jax_armed)
    port = _port(ref)
    port.set_stability(StabilityConfig())
    ref.update_n(4)
    port.update_n(4)
    ref.state = ref.state._replace(velx=ref.state.velx * 200.0, vely=ref.state.vely * 200.0)
    ref._obs_cache = None
    port.state = port.state._replace(velx=port.state.velx * 200.0, vely=port.state.vely * 200.0)
    spiked, t_spike = port.state, port.time
    assert jintegrate.integrate(ref, t_spike + 4 * ref.dt, None) == "break"
    assert tintegrate.integrate(port, t_spike + 4 * port.dt, None) == "break"
    _assert_status_matches(port.last_chunk_status, ref.last_chunk_status, 1e-11)
    assert port.last_chunk_status.pre_divergence and port.last_chunk_status.steps_done == 1
    assert ref.time == port.time == t_spike
    assert port.state is spiked
    assert bool(np.isfinite(np.asarray(ref.state.temp)).all())
    for model in (ref, port):
        assert model.exit() is True
        model.clear_pre_divergence()
        assert model.exit() is False
    capsys.readouterr()


def test_meshed_sentinels_match_serial():
    """On a mesh of 4 ranks the pencils' zero pad adds nothing to the CFL,
    the kinetic energy or |div|; the armed meshed trajectory is its plain
    one bit for bit."""
    kw = dict(device="cpu")
    serial = pt.Navier2D.new_confined(*MODEL, **kw, **ROUTES["dense"])
    meshed = pt.Navier2D.new_confined(*MODEL, **kw, mesh=pt.make_mesh(4, "cpu"))
    plain = pt.Navier2D.new_confined(*MODEL, **kw, mesh=pt.make_mesh(4, "cpu"))
    assert meshed._inv_dx.shape == meshed._w_vol.shape == (4, 5, 20)
    for const in (meshed._inv_dx, meshed._inv_dy, meshed._w_vol):
        full = const.reshape(20, 20)  # rank r holds rows 5r..5r+4
        assert full[:17, :17].all() and not full[17:].any() and not full[:, 17:].any()
    for model in (serial, meshed):
        model.set_stability(StabilityConfig())
    want, got = serial.update_n(4), meshed.update_n(4)
    plain.update_n(4)
    _assert_status_matches(got, want, 1e-12)
    _assert_bit_equal(meshed.state, plain.state)


def test_stability_contract():
    model = pt.Navier2D.new_confined(*MODEL, device="cpu")
    with pytest.raises(RuntimeError, match="set_stability"):
        model.chunk_runner(armed=True)
    plain = model.chunk_runner()
    model.set_stability(StabilityConfig(max_cfl=1e-6))
    status = model.update_n(3)
    assert status.pre_divergence and status.steps_done == 1 and model.time == 0.0
    assert model.exit() is True
    model.set_stability(StabilityConfig(max_cfl=1e-6))  # re-arming clears the latch
    assert model.exit() is False and model.last_chunk_status is None
    sentinels = model.chunk_runner()
    model.set_stability(None)
    assert model.update_n(3) is None and model.time == pytest.approx(0.03)
    assert model.chunk_runner() is plain
    # a new ceiling reaches the kept sentinel step through its tensor
    model.set_stability(StabilityConfig())
    assert model.chunk_runner() is sentinels
    status = model.update_n(3)
    assert not status.pre_divergence and status.steps_done == 3
    assert model.time == pytest.approx(0.06)

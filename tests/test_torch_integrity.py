"""PyTorch port: the integrity layer against the JAX package on the CPU.

* ``digest_tree`` equal to the JAX package's, bit for bit, on float64,
  float32, complex128, complex64, bool, int32 and int64 leaves from 0-d to
  4-d, on multi-leaf states, and per member (a leading member axis against
  JAX's ``vmap``), with the positional mixes built here or passed in;
* a confined ``Navier2D``: the port's ``state_digest_async`` equals the JAX
  digest of the same arrays, and the JAX model's digest of its own state
  equals the port's digest of that state; a meshed model digests as its
  gathered state does; an ensemble's per-member digests equal the solo
  digests of its members;
* ``flip_one_bit`` equal to JAX's, and the digest of the flipped array
  equal to JAX's; a one-bit flip at any position moves the digest when it
  is below bit 28 of its 32-bit word (above, the fold can wrap to the same
  value: the JAX package's blind spot too); ``flip_state_bit`` picks
  JAX's position and bit, which always moves it;
* shadow audits: equal to the live digest after plain, sentinel and
  statistics chunks, unequal after a flipped bit; snapshots restore;
* ``QuarantineLedger``: the same strike, expiry and quarantine answers and
  the same file as JAX's under the same clock.
"""

import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu import integrity as jint
from rustpde_mpi_tpu.integrity import digest as jdig

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import integrity as tint
from rustpde_mpi_tpu_torch.config import IntegrityConfig, StabilityConfig, StatsConfig
from rustpde_mpi_tpu_torch.integrity import digest as tdig


@pytest.fixture(autouse=True, scope="module")
def _gc():
    """Drop the JAX objects this module built before the worker runs
    another file."""
    yield
    gc.collect()


def _leaf(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random(shape) > 0.5
    if kind in ("int32", "int64"):
        return rng.integers(-2**30, 2**30, shape).astype(kind)
    if kind.startswith("complex"):
        real = "float64" if kind == "complex128" else "float32"
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(kind) \
            if shape else np.asarray(rng.standard_normal() + 1j * rng.standard_normal(),
                                     dtype=kind).astype(kind, copy=False) + np.zeros((), real)
    return np.asarray(rng.standard_normal(shape)).astype(kind)


KINDS = ("float64", "float32", "complex128", "complex64", "bool", "int32", "int64")
SHAPES = ((), (7,), (5, 6), (3, 4, 5), (2, 3, 4, 3))


def _jax_digest(leaves):
    return int(np.asarray(jint.digest_tree([jnp.asarray(a) for a in leaves])))


def _port_digest(leaves):
    return int(tint.digest_tree([torch.from_numpy(np.array(a)) for a in leaves]))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
@pytest.mark.parametrize("kind", KINDS)
def test_leaf_digest_matches_jax(kind, shape):
    a = _leaf(kind, shape, seed=len(shape))
    assert _port_digest([a]) == _jax_digest([a])


def test_multi_leaf_and_member_digests_match_jax():
    leaves = [_leaf(k, s, i) for i, (k, s) in enumerate(zip(KINDS, SHAPES + ((4,), (2, 2))))]
    assert _port_digest(leaves) == _jax_digest(leaves)
    assert _port_digest(leaves[::-1]) != _port_digest(leaves)  # the fold is ordered
    members = [_leaf("float64", (3, 5, 4), 8), _leaf("complex128", (3, 6), 9),
               _leaf("bool", (3,), 10)]
    want = np.asarray(jax.vmap(jint.digest_tree)([jnp.asarray(a) for a in members]))
    got = tint.digest_tree([torch.from_numpy(a) for a in members], lead=1)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint32


@pytest.mark.parametrize("lead", [0, 1])
@pytest.mark.parametrize("shape", [(3,), (3, 4)], ids=lambda s: f"{len(s)}d")
@pytest.mark.parametrize("kind", KINDS)
def test_digest_with_kept_mixes_matches_jax(kind, shape, lead):
    """The positional mixes a captured digest builds once and keeps
    (``position_mixes``, passed to ``digest_words``) give JAX's digest,
    whole or per member (a member of shape ``()`` too)."""
    a = _leaf(kind, shape, seed=12)
    leaves = [torch.from_numpy(np.array(a))]
    mixes = tdig.position_mixes(leaves, lead)
    got = tdig.digest_words(leaves, lead, mixes).numpy().astype(np.uint32)
    fn = jax.vmap(jint.digest_tree) if lead else jint.digest_tree
    np.testing.assert_array_equal(got, np.asarray(fn([jnp.asarray(a)])))


def _models():
    jm = rp.Navier2D(17, 17, 1e5, 1.0, 1e-2, 1.0, "rbc", False)
    pm = pt.Navier2D(17, 17, 1e5, 1.0, 1e-2, 1.0, "rbc", device="cpu")
    for m in (jm, pm):
        m.init_random(0.1, 0)
    return jm, pm


def test_navier_state_digest_matches_jax():
    jm, pm = _models()
    pm.set_integrity(IntegrityConfig())
    jm.set_integrity(rp.config.IntegrityConfig())
    pm.update_n(3)
    port_arrays = [t.numpy() for t in pm.state]
    assert int(pm.state_digest_async().result()) == _jax_digest(port_arrays)
    jax_arrays = [np.asarray(a) for a in jm.state]
    assert int(np.asarray(jm.state_digest_async().result())) == _port_digest(jax_arrays)
    assert int(pm.digest_of_async(pt.NavierState(*map(torch.from_numpy, jax_arrays))).result()) \
        == int(np.asarray(jm.state_digest_async().result()))


def test_meshed_and_member_digests():
    _, pm = _models()
    mm = pt.Navier2D(17, 17, 1e5, 1.0, 1e-2, 1.0, "rbc", mesh=pt.make_mesh(4, "cpu"))
    mm.init_random(0.1, 0)
    mm.set_integrity(IntegrityConfig())
    gathered = [getattr(mm, f"{n}_space").gather_spectral(f).numpy()
                for n, f in zip(mm.state._fields, mm.state)]
    assert int(mm.state_digest_async().result()) == _jax_digest(gathered)
    ens = pt.NavierEnsemble.from_seeds(pm, range(3))
    ens.set_integrity(IntegrityConfig())
    assert pm.integrity_armed and ens.integrity_armed
    per = ens.state_digest_async().result()
    for i in range(3):
        assert int(per[i]) == int(pm.digest_of_async(ens.member_state(i)).result())
    ens.update_n(4)
    mens = pt.NavierEnsemble.from_seeds(mm, range(2))
    mens.update_n(2)
    per = mens.state_digest_async().result()
    for i in range(2):
        assert int(per[i]) == int(mm.digest_of_async(mens.member_state(i)).result())


def test_flip_one_bit_matches_jax_and_always_moves_the_digest():
    rng = np.random.default_rng(11)
    for kind in ("float64", "float32", "complex128"):
        a = _leaf(kind, (4, 5), 12)
        base = _port_digest([a])
        bits = 64 if kind != "float32" else 32
        for _ in range(40):
            idx = (int(rng.integers(4)), int(rng.integers(5)))
            bit = int(rng.integers(bits))
            got = tdig.flip_one_bit(torch.from_numpy(a), idx, bit).numpy()
            want = np.asarray(jdig.flip_one_bit(jnp.asarray(a), idx, bit))
            np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
            assert _port_digest([got]) == _jax_digest([want])
            # a flip of word bit b moves the XOR and the sum by 2^b each, so
            # the digest by 2^b (+-1 +- K), K = 2654435761: 1 - K is 16 times
            # an odd number, and from b = 28 on that can wrap to 0 (the JAX
            # digest's blind spot too); every lower bit moves it
            if bit % 32 < 28:
                assert _port_digest([got]) != base
    _, pm = _models()
    for step in (0, 3, 17):
        got, info = tint.flip_state_bit(pm.state, step)
        want = jint.flip_state_bit(rp.NavierState(*(jnp.asarray(t.numpy()) for t in pm.state)),
                                   step)[1]
        assert info == {**want, "index": tuple(want["index"])}
        assert np.isfinite(got.temp.numpy()).all()
        assert tint.digest_tree(got) != tint.digest_tree(pm.state)
    assert tdig.default_flip_bit(torch.complex64) == jdig.default_flip_bit(np.complex64) == 22
    assert tdig.default_flip_bit(torch.float64) == jdig.default_flip_bit(np.float64) == 51


@pytest.mark.parametrize("chunk", ["plain", "sentinels", "stats"])
def test_shadow_audit_equals_the_live_digest(chunk):
    _, pm = _models()
    pm.set_integrity(IntegrityConfig(cadence=None))
    assert pm.integrity_config.resolved_cadence() == 8
    if chunk == "sentinels":
        pm.set_stability(StabilityConfig())
    if chunk == "stats":
        pm.set_stats(StatsConfig(stride=2))
    snap = pm.integrity_snapshot()
    pm.update_n(7)
    live = int(pm.state_digest_async().result())
    assert int(pm.shadow_digest_async(snap, 7).result()) == live
    # a flipped bit at rest shows in the chain digest; the restore puts the start back
    bad, _ = tint.flip_state_bit(snap["state"], 5)
    assert int(pm.digest_of_async(bad).result()) != int(pm.digest_of_async(snap["state"]).result())
    assert int(pm.shadow_digest_async({"state": bad}, 7).result()) != live
    pm.integrity_restore(snap)
    assert pm.time == 0.0 and all(torch.equal(a, b) for a, b in zip(pm.state, snap["state"]))
    pm.update_n(7)
    assert int(pm.state_digest_async().result()) == live


def test_ensemble_shadow_audit_and_restore():
    _, pm = _models()
    ens = pt.NavierEnsemble.from_seeds(pm, range(3))
    ens.set_integrity(IntegrityConfig())
    snap = ens.integrity_snapshot()
    ens.update_n(5)
    live = ens.state_digest_async().result()
    np.testing.assert_array_equal(ens.shadow_digest_async(snap, 5).result(), live)
    bad, info = tint.flip_state_bit(snap["state"], 2, member=1)
    got = ens.shadow_digest_async({**snap, "state": bad}, 5).result()
    assert [bool(g != w) for g, w in zip(got, live)] == [False, True, False]
    assert info["member"] == 1
    ens.integrity_restore(snap)
    ens.update_n(5)
    np.testing.assert_array_equal(ens.state_digest_async().result(), live)


def test_integrity_needs_arming_and_keeps_the_trajectory():
    _, a = _models()
    _, b = _models()
    with pytest.raises(RuntimeError, match="set_integrity"):
        a.state_digest_async()
    b.set_integrity(IntegrityConfig())
    for model in (a, b):
        model.update_n(4)
    b.state_digest_async().result()
    a.update_n(3)
    b.update_n(3)
    assert all(torch.equal(x, y) for x, y in zip(a.state, b.state))
    cfg = pt.NavierConfig(nx=17, ny=17, ra=1e5, dt=1e-2, integrity=IntegrityConfig(cadence=3))
    model = pt.Navier2D.from_config(cfg, device="cpu")
    assert model.integrity_armed and model.integrity_config.resolved_cadence() == 3


def test_quarantine_ledger_matches_jax(tmp_path):
    now = [1000.0]

    def clock():
        return now[0]

    port = tint.QuarantineLedger(str(tmp_path / "port"), strikes=2, strike_ttl_s=10.0,
                                 clock=clock)
    ref = jint.QuarantineLedger(str(tmp_path / "jax"), strikes=2, strike_ttl_s=10.0,
                                clock=clock)
    script = [("gpu:0", 0.0), ("gpu:1", 1.0), ("gpu:0", 20.0), ("gpu:0", 1.0),
              ("gpu:1", 30.0), ("gpu:1", 2.0), ("gpu:1", 1.0)]
    for step, (dev, dt) in enumerate(script):
        now[0] += dt
        assert port.strike(dev, step=step, detail="audit") == \
            ref.strike(dev, step=step, detail="audit")
        for d in ("gpu:0", "gpu:1"):
            assert port.strikes_for(d) == ref.strikes_for(d)
            assert port.is_quarantined(d) == ref.is_quarantined(d)
        assert port.quarantined() == ref.quarantined()
    with open(port.path, encoding="utf-8") as fh, open(ref.path, encoding="utf-8") as gh:
        assert json.load(fh) == json.load(gh)
    assert os.path.basename(port.path) == "quarantine.json"
    err = tint.IntegrityError("mismatch", check="chain", step=3, chunk_steps=8, member=1,
                              device="gpu:0")
    assert (err.check, err.step, err.chunk_steps, err.member, err.device) == \
        ("chain", 3, 8, 1, "gpu:0")

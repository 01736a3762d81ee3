"""PyTorch port: ``Space1``, ``Field1``, ``BiPeriodicSpace2`` and the
Swift-Hohenberg models against the JAX package on the CPU (f64, the same
numpy-seeded inputs).

* ``Space1`` forward/backward/backward_ortho/to_ortho/from_ortho round trips
  and gradients (orders 1, 2, with a scale) for chebyshev, cheb_dirichlet,
  fourier_r2c and fourier_c2c at n = 16 and 17: rel 1e-12 of each result's
  scale; the dealias mask and the zero-mode pin exactly;
* ``Field1``: ``v``, ``gradient``, ``average``, ``scale``;
* ``BiPeriodicSpace2`` at 32x36 and 16x16: forward, backward, gradients,
  the dealias mask and ``enforce_hermitian_x``, compared through
  ``vhat_as_complex``: rel 1e-12;
* ``SwiftHohenberg1D`` (nx = 64) and ``SwiftHohenberg2D`` (16^2) after 20
  and 200 steps: rel 1e-11 of the spectrum's scale, norms and pattern
  energies rel 1e-11;
* the linear growth factor of one mode (rtol 1e-6, the JAX package's own
  check);
* a snapshot written by the port and read by the JAX model, and one
  written by the JAX model and read by the port.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpde_mpi_tpu import bases as jb
from rustpde_mpi_tpu.field import Field1 as JaxField1
from rustpde_mpi_tpu.models import swift_hohenberg as jsh

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.utils.jit import scan_buckets

TOL = 1e-12
MODEL_TOL = 1e-11
KINDS = ("chebyshev", "cheb_dirichlet", "fourier_r2c", "fourier_c2c")


@pytest.fixture(autouse=True, scope="module")
def _gc():
    """Drop the JAX objects this module built before the worker runs
    another file."""
    yield
    gc.collect()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) <= tol * scale


def _spaces(kind, n):
    return jb.Space1(getattr(jb, kind)(n)), pt.Space1(getattr(pt, kind)(n), device="cpu",
                                                      dtype=torch.float64)


def _physical(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    if kind == "fourier_c2c":
        v = v + 1j * rng.standard_normal(n)
    return v


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("kind", KINDS)
def test_space1_matches_jax(kind, n):
    js, ps = _spaces(kind, n)
    v = _physical(kind, n)
    pv = torch.as_tensor(v)
    jhat, phat = js.forward(jnp.asarray(v)), ps.forward(pv)
    _close(phat.numpy(), jhat)
    _close(ps.backward(phat).numpy(), np.asarray(js.backward(jhat)))
    _close(ps.to_ortho(phat).numpy(), np.asarray(js.to_ortho(jhat)))
    c = js.to_ortho(jhat)
    pc = torch.tensor(np.array(c))
    _close(ps.backward_ortho(pc).numpy(), np.asarray(js.backward_ortho(c)))
    _close(ps.from_ortho(pc).numpy(), np.asarray(js.from_ortho(c)))
    for order, scale in ((1, None), (2, None), (1, 2.5), (2, (0.5,))):
        _close(ps.gradient(phat, order, scale).numpy(), np.asarray(js.gradient(jhat, order, scale)))
    np.testing.assert_array_equal(ps.dealias_mask(), js.dealias_mask())
    _close(ps.pin_zero_mode(phat).numpy(), np.asarray(js.pin_zero_mode(jhat)))
    np.testing.assert_array_equal(ps.vhat_as_complex(phat), phat.numpy())
    assert torch.equal(ps.vhat_from_complex(ps.vhat_as_complex(phat)), phat)
    assert ps.shape_physical == js.shape_physical and ps.shape_spectral == js.shape_spectral
    assert ps.spectral_is_complex == js.spectral_is_complex
    if kind.startswith("cheb"):  # a Chebyshev round trip is exact to roundoff
        _close(ps.backward(ps.forward(pv)).numpy(), v if kind == "chebyshev"
               else np.asarray(js.backward(js.forward(jnp.asarray(v)))))


@pytest.mark.parametrize("kind", ["chebyshev", "fourier_r2c", "fourier_c2c"])
def test_field1_matches_jax(kind):
    js, ps = _spaces(kind, 16)
    jf, pf = JaxField1(js), pt.Field1(ps)
    jf.scale(3.0)
    pf.scale(3.0)
    v = _physical(kind, 16, seed=2)
    jf.v, pf.v = jnp.asarray(v), v
    _close(pf.vhat.numpy(), np.asarray(jf.vhat))
    _close(pf.v.numpy(), np.asarray(jf.v))
    _close(pf.gradient(1, (3.0,)).numpy(), np.asarray(jf.gradient(1, (3.0,))))
    assert complex(pf.average()) == pytest.approx(complex(jf.average()), rel=TOL, abs=1e-14)
    np.testing.assert_allclose(pf.x[0], jf.x[0], rtol=0, atol=0)
    np.testing.assert_allclose(pf.dx[0], jf.dx[0], rtol=0, atol=0)
    c = pf.to_ortho()
    pf.from_ortho(c)
    _close(pf.vhat.numpy(), np.asarray(jf.vhat))


@pytest.mark.parametrize("shape", [(32, 36), (16, 16)])
def test_biperiodic_space_matches_jax(shape):
    nx, ny = shape
    js = jb.BiPeriodicSpace2(nx, ny)
    ps = pt.BiPeriodicSpace2(nx, ny, device="cpu", dtype=torch.float64)
    v = np.random.default_rng(5).standard_normal(shape)
    jhat, phat = js.forward(jnp.asarray(v)), ps.forward(torch.as_tensor(v))
    _close(ps.vhat_as_complex(phat), js.vhat_as_complex(jhat))
    _close(ps.backward(phat).numpy(), np.asarray(js.backward(jhat)))
    for deriv, scale in (((1, 0), None), ((0, 1), None), ((2, 1), (2.0, 3.0)), ((1, 3), None)):
        _close(ps.vhat_as_complex(ps.gradient(phat, deriv, scale)),
               js.vhat_as_complex(js.gradient(jhat, deriv, scale)))
    np.testing.assert_array_equal(ps.dealias_mask(), js.dealias_mask())
    _close(ps.vhat_as_complex(ps.pin_zero_mode(phat)), js.vhat_as_complex(js.pin_zero_mode(jhat)))
    # a spectrum with anti-Hermitian parts in the self-conjugate columns
    rng = np.random.default_rng(6)
    c = rng.standard_normal((nx, ps.my)) + 1j * rng.standard_normal((nx, ps.my))
    got = ps.vhat_as_complex(ps.enforce_hermitian_x(ps.vhat_from_complex(c)))
    want = js.vhat_as_complex(js.enforce_hermitian_x(jnp.asarray(js.vhat_from_complex(c))))
    _close(got, want)
    np.testing.assert_allclose(got[(-np.arange(nx)) % nx, 0], np.conj(got[:, 0]), rtol=0,
                               atol=1e-15)
    assert ps.shape_spectral == (nx, ny // 2 + 1)
    for a, b in zip(ps.coords(), js.coords()):
        np.testing.assert_array_equal(a, b)


def _sh_pair(dim):
    if dim == 1:
        jm, pm = jsh.SwiftHohenberg1D(64, 0.35, 0.02, 20.0), \
            pt.SwiftHohenberg1D(64, 0.35, 0.02, 20.0, device="cpu")
        jm.init_random(0.1, 1)
        pm.init_random(0.1, 1)
    else:
        jm, pm = jsh.SwiftHohenberg2D(16, 16, 0.35, 0.02, 20.0), \
            pt.SwiftHohenberg2D(16, 16, 0.35, 0.02, 20.0, device="cpu")
    return jm, pm


@pytest.mark.parametrize("dim", [1, 2])
def test_sh_models_match_jax(dim):
    jm, pm = _sh_pair(dim)
    _close(pm.theta.numpy(), jm.space.vhat_as_complex(jm.theta), TOL)
    for steps in (20, 180):
        jm.update_n(steps)
        pm.update_n(steps)
        _close(pm.theta.numpy(), jm.space.vhat_as_complex(jm.theta), MODEL_TOL)
        _close(pm.theta_physical(), jm.theta_physical(), MODEL_TOL)
        assert pm.norm() == pytest.approx(jm.norm(), rel=MODEL_TOL)
        assert pm.time == pytest.approx(jm.time, rel=1e-15)
    if dim == 2:
        assert pm.pattern_energy() == pytest.approx(jm.pattern_energy(), rel=MODEL_TOL)
    assert not pm.exit()
    pm.update()
    jm.update()
    _close(pm.theta.numpy(), jm.space.vhat_as_complex(jm.theta), MODEL_TOL)


def test_sh_linear_growth_factor():
    """A tiny single mode grows by the exact IMEX modal factor (the JAX
    package's checks, rtol 1e-6), in 1-D and 2-D."""
    nx, length, r, dt = 64, 2.0, 0.3, 0.05
    model = pt.SwiftHohenberg1D(nx, r, dt, length, device="cpu")
    x = model.x[0]
    model.set_theta(1e-8 * np.cos(2 * x / length))
    a0 = np.max(np.abs(model.theta_physical()))
    model.update_n(20)
    k = 2 / length
    factor = (1.0 / (1.0 + dt * ((1.0 - k**2) ** 2 - r))) ** 20
    np.testing.assert_allclose(np.max(np.abs(model.theta_physical())) / a0, factor, rtol=1e-6)
    length, r, dt = 2.0, 0.25, 0.02
    model = pt.SwiftHohenberg2D(32, 32, r, dt, length, device="cpu")
    x, y = model.x
    model.set_theta(1e-8 * np.cos(2 * x[:, None] / length) * np.cos(y[None, :] / length))
    a0 = np.max(np.abs(model.theta_physical()))
    model.update_n(10)
    k2 = (2 / length) ** 2 + (1 / length) ** 2
    factor = (1.0 / (1.0 + dt * ((1.0 - k2) ** 2 - r))) ** 10
    np.testing.assert_allclose(np.max(np.abs(model.theta_physical())) / a0, factor, rtol=1e-6)


@pytest.mark.parametrize("dim", [1, 2])
def test_sh_snapshots_cross_packages(tmp_path, dim):
    jm, pm = _sh_pair(dim)
    pm.update_n(5)
    jm.update_n(5)
    path = str(tmp_path / "port.h5")
    pm.write(path)
    fresh = _sh_pair(dim)[0]
    fresh.read(path)
    assert fresh.time == pytest.approx(pm.time)
    _close(fresh.theta_physical(), pm.theta_physical())
    path = str(tmp_path / "jax.h5")
    jm._write(path)
    back = _sh_pair(dim)[1]
    back.read(path)
    _close(back.theta.numpy(), jm.space.vhat_as_complex(jm.theta))
    assert back.time == pytest.approx(jm.time)


def test_sh_update_n_is_bucketed_like_update():
    """``update_n`` (one chunk runner a bucket) equals eager ``update()``
    steps bit for bit on the CPU, and caches one runner per bucket length."""
    a = pt.SwiftHohenberg2D(16, 16, 0.35, 0.02, 20.0, device="cpu")
    b = pt.SwiftHohenberg2D(16, 16, 0.35, 0.02, 20.0, device="cpu")
    a.update_n(11)
    for _ in range(11):
        b.update()
    assert torch.equal(a.theta, b.theta)
    assert sorted(a._runners) == sorted(set(scan_buckets(11)))

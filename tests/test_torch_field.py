"""PyTorch port: ``Field2`` and the field layer's averages against the JAX
package's ``field.py``, on the CPU.

The same physical values (numpy, seeded) go into both packages' fields on
a confined (Chebyshev x Dirichlet) and a periodic (Fourier r2c x
Dirichlet) space: the forward and backward transforms, ``to_ortho``,
``from_ortho`` and ``gradient`` agree to 1e-13 of each result's scale (the
two transform their axes in another summation order), the volume averages
to 1e-13.  Per-field HDF5 IO: a field the port writes is read by the JAX
package and the other way round, and a read at another resolution (r2c
16 -> 32, Chebyshev 17 -> 25) gives the JAX package's coefficients bit for
bit (the JAX package's own ``tests/test_io.py`` case).
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu import field as jfield

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch import field as tfield

h5py = pytest.importorskip("h5py")

TOL = 1e-13
#: name -> (x base, y base) constructors and grid
SPACES = {
    "confined": ("chebyshev", "cheb_dirichlet", (17, 17)),
    "periodic": ("fourier_r2c", "cheb_dirichlet", (16, 17)),
}


@pytest.fixture(autouse=True, scope="module")
def _gc_after():
    yield
    gc.collect()


def _spaces(name, grid=None):
    bx, by, (nx, ny) = SPACES[name]
    nx, ny = grid or (nx, ny)
    jsp = rp.Space2(getattr(rp, bx)(nx), getattr(rp, by)(ny))
    tsp = pt.Space2(getattr(pt, bx)(nx), getattr(pt, by)(ny), device="cpu",
                    dtype=torch.float64)
    return jsp, tsp


def _fields(name, seed=0):
    jsp, tsp = _spaces(name)
    values = np.random.default_rng(seed).standard_normal(tsp.shape_physical)
    jf, tf = rp.Field2(jsp), pt.Field2(tsp)
    jf.v = values
    tf.v = values
    return jf, tf


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.mark.parametrize("name", sorted(SPACES))
def test_transforms_match_jax_field(name):
    jf, tf = _fields(name)
    _close(tf.vhat, jf.vhat)
    _close(tf.v, jf.v)
    _close(tf.backward(), jf.backward())
    _close(tf.to_ortho(), jf.to_ortho())
    for deriv in ((1, 0), (0, 1), (2, 0)):
        _close(tf.gradient(deriv, (2.0, 1.0)), jf.gradient(deriv, (2.0, 1.0)))
    c = tf.to_ortho()
    jf.from_ortho(jnp.asarray(c.numpy()))
    tf.from_ortho(c)
    _close(tf.vhat, jf.vhat)
    phys = tf.v
    tf.forward(phys)
    jf.forward(jnp.asarray(phys.numpy()))
    _close(tf.vhat, jf.vhat)


@pytest.mark.parametrize("name", sorted(SPACES))
def test_averages_match_jax_field(name):
    jf, tf = _fields(name, seed=1)
    for f in (jf, tf):
        f.scale((1.5, 0.5))
    for i in range(2):
        np.testing.assert_array_equal(tf.x[i], jf.x[i])
        np.testing.assert_array_equal(tf.dx[i], jf.dx[i])
    for axis in (0, 1):
        _close(tf.average_axis(axis), jf.average_axis(axis))
    _close(tf.average(), jf.average())
    periodic = (name == "periodic", False)
    v = np.random.default_rng(2).standard_normal(tf.space.shape_physical)
    _close(tfield.average(torch.as_tensor(v), tf.x, tf.dx, periodic),
           jfield.average(jnp.asarray(v), jf.x, jf.dx, periodic))
    x = tf.space.bases[0].points
    np.testing.assert_array_equal(tfield.average_weights(x, periodic[0]),
                                  jfield.average_weights(x, periodic[0]))


def test_physical_dtype_follows_the_space():
    tsp = pt.Space2(pt.fourier_c2c(8), pt.chebyshev(9), device="cpu", dtype=torch.float64)
    f = pt.Field2(tsp)
    values = np.random.default_rng(3).standard_normal((8, 9))
    f.v = values + 1j * values
    assert f.vhat.dtype == torch.complex128
    np.testing.assert_allclose(f.v.numpy(), values + 1j * values, atol=1e-13)
    g = pt.Field2(_spaces("confined")[1])
    g.v = np.ones((17, 17), dtype=np.float32)
    assert g.vhat.dtype == torch.float64


@pytest.mark.parametrize("name,fine", [("periodic", (32, 17)), ("confined", (25, 25))])
def test_field_io_across_packages_and_resolutions(name, fine, tmp_path):
    jf, tf = _fields(name, seed=8)
    port_file, jax_file = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    tf.write(port_file, "temp")
    jf.write(jax_file, "temp")
    with h5py.File(port_file, "r") as a, h5py.File(jax_file, "r") as b:
        assert sorted(a["temp"]) == sorted(b["temp"])
    # the JAX package reads the port's field, the port the JAX package's
    jback, tback = rp.Field2(_spaces(name)[0]), pt.Field2(_spaces(name)[1])
    jback.read(port_file, "temp")
    tback.read(jax_file, "temp")
    np.testing.assert_array_equal(np.asarray(jback.vhat), tf.vhat.numpy())
    np.testing.assert_array_equal(tback.vhat.numpy(), np.asarray(jf.vhat))
    # a read at another resolution gives the JAX package's coefficients
    jfine, tfine = _spaces(name, fine)
    jh, th = rp.Field2(jfine), pt.Field2(tfine)
    jh.read(port_file, "temp")
    th.read(port_file, "temp")
    np.testing.assert_array_equal(th.vhat.numpy(), np.asarray(jh.vhat))
    if name == "periodic":
        # the coarse field on the fine grid: every second point is shared
        np.testing.assert_allclose(th.v.numpy()[::2, :], tf.v.numpy(), atol=1e-10)

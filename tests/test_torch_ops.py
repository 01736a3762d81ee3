"""PyTorch port: host operator builders, spaces and package hygiene.

The port (``rustpde_mpi_tpu_torch``) keeps its own copies of the JAX
package's host math; these tests hold them to the reference on the CPU in
f64.  Host matrices are built by the same numpy expressions in both
packages, so they agree to 1e-14 (in practice bit for bit); the device
transforms compare the port's dense products against the reference's FFT
path, which reassociates, so they agree to 1e-13 of the data scale.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu import bases as jb
from rustpde_mpi_tpu import solver as jsolver
from rustpde_mpi_tpu.ops import chebyshev as jchb
from rustpde_mpi_tpu.ops import folded as jfolded
from rustpde_mpi_tpu_torch import bases as tb
from rustpde_mpi_tpu_torch import config as tconfig
from rustpde_mpi_tpu_torch import convert, field as tfield
from rustpde_mpi_tpu_torch import solver as tsolver
from rustpde_mpi_tpu_torch.models import boundary_conditions as tbcs
from rustpde_mpi_tpu_torch.models import functions as tfns
from rustpde_mpi_tpu_torch.ops import chebyshev as tchb
from rustpde_mpi_tpu_torch.ops import folded as tfolded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("chebyshev", "cheb_dirichlet", "cheb_neumann")
AXIS_KEYS = ("fwd", "fwd_cut", "bwd", "synthesis", "stencil", "proj",
             ("bwd_grad", 1), ("bwd_grad", 2), ("grad", 1), ("grad", 2))
HOST_TOL = 1e-14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The grids are tiny: one intra-op thread keeps torch from competing
    with the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(a, b, tol, scale=None):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    ref = float(np.max(np.abs(b))) if scale is None else scale
    assert float(np.max(np.abs(a - b))) <= tol * max(ref, 1.0)


# -- (a) host matrices ----------------------------------------------------------


@pytest.mark.parametrize("n", [17, 32, 33])
def test_chebyshev_builders_match_reference(n):
    for name in ("cgl_points", "synthesis_matrix", "analysis_matrix",
                 "quasi_inverse_b2", "restricted_eye", "stencil_chebyshev",
                 "stencil_dirichlet", "stencil_neumann",
                 "stencil_dirichlet_neumann", "cheb_weights"):
        _close(getattr(tchb, name)(n), getattr(jchb, name)(n), HOST_TOL)
    for order in (1, 2):
        _close(tchb.diff_matrix(n, order), jchb.diff_matrix(n, order), HOST_TOL)
    for st in ("stencil_dirichlet", "stencil_neumann"):
        s = getattr(jchb, st)(n)
        _close(tchb.projection_matrix(s), jchb.projection_matrix(s), HOST_TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sep", [False, True])
def test_axis_operator_matches_reference_for_every_key(kind, sep):
    for n in (17, 33):
        tbase = getattr(tb, kind)(n)
        jbase = getattr(jb, kind)(n)
        for key in AXIS_KEYS:
            top, jop = tbase.axis_operator(key, sep=sep), jbase.axis_operator(key, sep=sep)
            _close(top.matrix, jop.matrix, HOST_TOL)
            assert top.parity == jop.parity and top.dealias_rows == jop.dealias_rows
            if jop.kept_rows is None:
                assert top.kept_rows is None
            else:
                np.testing.assert_array_equal(top.kept_rows, jop.kept_rows)


def test_axis_operator_rejects_unknown_key():
    with pytest.raises(ValueError, match="unknown axis_operator key"):
        tb.chebyshev(9).axis_operator("nope")


@pytest.mark.parametrize("m", [7, 8, 15])
def test_parity_perm_matches_reference(m):
    np.testing.assert_array_equal(tfolded.parity_perm(m), jfolded.parity_perm(m))
    np.testing.assert_array_equal(tfolded.parity_perm_inv(m), jfolded.parity_perm_inv(m))
    x = np.arange(m)
    np.testing.assert_array_equal(x[tfolded.parity_perm(m)][tfolded.parity_perm_inv(m)], x)


def _space_pairs(n):
    """(port space, reference space) for every space of the confined cell."""
    pairs = []
    for kx, ky in (("cheb_dirichlet", "cheb_dirichlet"), ("cheb_neumann", "cheb_dirichlet"),
                   ("chebyshev", "chebyshev"), ("cheb_neumann", "cheb_neumann")):
        tsp = tb.Space2(getattr(tb, kx)(n), getattr(tb, ky)(n), device="cpu", dtype=torch.float64)
        jsp = jb.Space2(getattr(jb, kx)(n), getattr(jb, ky)(n))
        pairs.append((tsp, jsp))
    return pairs


@pytest.mark.parametrize("n", [17, 33])
def test_hholtz_axis_solve_matrix_matches_reference(n):
    for tsp, jsp in _space_pairs(n):
        for axis in (0, 1):
            for ci in (1e-4, 1e-3, 0.25):
                _close(tsolver.hholtz_axis_solve_matrix(tsp, axis, ci),
                       jsolver.hholtz_axis_solve_matrix(jsp, axis, ci), HOST_TOL)


@pytest.mark.parametrize("n", [17, 33])
def test_modal_data_split_matches_reference(n):
    # the orthogonal Chebyshev pencil is singular (no solver uses it)
    for tsp, jsp in _space_pairs(n):
        if tsp.base_x.kind == tb.BaseKind.CHEBYSHEV:
            continue
        for axis in (0, 1):
            for ci, sign in ((1.0, 1.0), (0.5, -1.0)):
                tl, tf, tq = tsolver.modal_data_split(tsp, axis, ci, sign)
                jl, jf, jq = jsolver.modal_data_split(jsp, axis, ci, sign)
                _close(tl, jl, HOST_TOL)
                _close(tf, jf, HOST_TOL)
                _close(tq, jq, HOST_TOL)


def test_checker_shift_and_real_eig_match_reference():
    rng = np.random.default_rng(3)
    for m in (np.diag(rng.standard_normal(5)), np.ones((3, 3)), np.eye(4)[:, ::-1]):
        assert tsolver._checker_shift(m) == jsolver._checker_shift(m)
    x = rng.standard_normal((6, 6))
    x = x @ x.T
    tl, tq = tsolver._real_eig_desc(x)
    jl, jq = jsolver._real_eig_desc(x)
    _close(tl, jl, HOST_TOL)
    _close(tq, jq, HOST_TOL)
    with pytest.raises(ValueError, match="complex"):
        tsolver._real_eig_desc(np.array([[0.0, -1.0], [1.0, 0.0]]))


def test_model_functions_and_bc_match_reference():
    from rustpde_mpi_tpu.field import grid_deltas as j_grid_deltas
    from rustpde_mpi_tpu.models import boundary_conditions as jbcs
    from rustpde_mpi_tpu.models import functions as jfns

    for ra, pr in ((1e4, 1.0), (1e9, 0.7)):
        assert tfns.get_nu(ra, pr, 2.0) == jfns.get_nu(ra, pr, 2.0)
        assert tfns.get_ka(ra, pr, 2.0) == jfns.get_ka(ra, pr, 2.0)
    x, y = tchb.cgl_points(9), tchb.cgl_points(11)
    np.testing.assert_array_equal(tbcs.bc_rbc_values(x, y), jbcs.bc_rbc_values(x, y))
    np.testing.assert_array_equal(tfield.grid_deltas(y), j_grid_deltas(y, False))
    a = tfns.random_values((4, 5), 0.1, np.random.default_rng(7))
    b = jfns.random_values((4, 5), 0.1, np.random.default_rng(7))
    np.testing.assert_array_equal(a, b)


# -- device transforms ----------------------------------------------------------


@pytest.mark.parametrize("n", [17, 33])
def test_space_transforms_match_reference(n):
    rng = np.random.default_rng(n)
    for tsp, jsp in _space_pairs(n):
        assert jsp.sep == (False, False)
        v = rng.standard_normal(tsp.shape_physical)
        vhat = rng.standard_normal(tsp.shape_spectral)
        ortho = rng.standard_normal(tsp.shape_physical)
        cases = [
            (tsp.forward(torch.as_tensor(v)), jsp.forward(jnp.asarray(v))),
            (tsp.backward(torch.as_tensor(vhat)), jsp.backward(jnp.asarray(vhat))),
            (tsp.backward_fast(torch.as_tensor(vhat)), jsp.backward_fast(jnp.asarray(vhat))),
            (tsp.to_ortho(torch.as_tensor(vhat)), jsp.to_ortho(jnp.asarray(vhat))),
            (tsp.from_ortho(torch.as_tensor(ortho)), jsp.from_ortho(jnp.asarray(ortho))),
            (tsp.backward_ortho(torch.as_tensor(ortho)), jsp.backward_ortho(jnp.asarray(ortho))),
        ]
        for deriv in ((1, 0), (0, 1), (2, 0), (0, 2)):
            cases.append((tsp.gradient(torch.as_tensor(vhat), deriv, (1.5, 1.0)),
                          jsp.gradient(jnp.asarray(vhat), deriv, (1.5, 1.0))))
            cases.append((tsp.backward_gradient(torch.as_tensor(vhat), deriv, (1.5, 1.0)),
                          jsp.backward_gradient(jnp.asarray(vhat), deriv, (1.5, 1.0))))
        for got, want in cases:
            want = np.asarray(want)
            _close(got.numpy(), want, 1e-13, scale=float(np.max(np.abs(want))))
        np.testing.assert_array_equal(tsp.dealias_mask(), jsp.dealias_mask())
        pinned = tsp.pin_zero_mode(torch.as_tensor(vhat))
        np.testing.assert_array_equal(pinned.numpy(), np.asarray(jsp.pin_zero_mode(jnp.asarray(vhat))))


def test_space_batches_and_rejects_rank_one():
    sp = tb.Space2(tb.cheb_dirichlet(9), tb.chebyshev(9), device="cpu", dtype=torch.float64)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 9, 9)))
    batched = sp.forward(v)
    for i in range(3):
        torch.testing.assert_close(batched[i], sp.forward(v[i]), rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="rank"):
        sp.forward(v[0, 0])


def test_average_weights_and_norm():
    x = tchb.cgl_points(17)
    w = tfield.average_weights(x)
    assert w.sum() == pytest.approx(1.0, abs=1e-15)
    a = torch.tensor([[3.0, 4.0]], dtype=torch.float64)
    assert float(tfield.norm_l2(a)) == 5.0


# -- dtype/device policy ----------------------------------------------------------


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconfig.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Navier2D(9, 9, 1e4, 1.0, 1e-2, 1.0, "rbc")
    assert tconfig.resolve_device("cpu") == torch.device("cpu")


def test_dtype_policy():
    assert tconfig.DEFAULT_DTYPE == torch.float64
    assert tconfig.check_dtype(torch.float32) == torch.float32
    with pytest.raises(ValueError, match="unsupported dtype"):
        tconfig.check_dtype(torch.float16)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# -- state carried across ---------------------------------------------------------


def test_convert_reads_the_reference_sep_layout():
    """A state stored in the JAX package's parity-separated TPU layout loads
    into the port in natural order.  The sep-layout state is each field's
    physical values taken forward by the JAX package's own sep-layout
    ``Space2`` (``sep=True``, matmul transforms)."""
    n = 33
    nat = rp.Navier2D(n, n, 1e4, 1.0, 5e-3, 1.0, "rbc", periodic=False)
    nat.init_random(0.1, seed=4)
    arrays = {}
    for f in convert.STATE_FIELDS:
        space = getattr(nat, f"{f}_space")
        sep = jb.Space2(*space.bases, method="matmul", sep=True)
        assert sep.sep == (True, True) and space.sep == (False, False)
        arrays[f] = np.asarray(sep.forward(space.backward(getattr(nat.state, f))))
    model = pt.Navier2D(n, n, 1e4, 1.0, 5e-3, 1.0, "rbc", device="cpu")
    convert.state_from_numpy(model, arrays, sep=(True, True))
    got = convert.state_to_numpy(model)
    for f in convert.STATE_FIELDS:
        want = np.asarray(getattr(nat.state, f))
        _close(got[f], want, 1e-13, scale=float(np.max(np.abs(want))))
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy(model, dict(arrays, temp=np.zeros((3, 3))))


# -- (f) the port stands alone ----------------------------------------------------


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX or the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rustpde_mpi_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'rustpde_mpi_tpu' or m.startswith('rustpde_mpi_tpu.'))\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")

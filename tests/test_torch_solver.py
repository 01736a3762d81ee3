"""PyTorch port: the Helmholtz / Poisson solver objects against the JAX
package, on the CPU.

``rustpde_mpi_tpu_torch.solver`` builds ``HholtzAdi``, ``Poisson`` and
``Hholtz`` from the same host math as the JAX package; their banded method
runs the banded-substitution wrapper (plain PyTorch on the CPU, the CUDA
kernel on a card), the dense/fd methods run matrix products.  Each is held
to the JAX solver of the same method at 17^2 and 33^2 on the same numpy
rhs, to 1e-12 of max|out| (the same linear algebra summed in another
order).  The manufactured solutions of the JAX package's
``examples/solve_hholtz.py`` / ``examples/solve_poisson.py`` hold at 33^2
to their own tolerance, 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rustpde_mpi_tpu import bases as jb
from rustpde_mpi_tpu import solver as jsolver
from rustpde_mpi_tpu_torch import bases as tb
from rustpde_mpi_tpu_torch import solver as tsolver

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The grids are tiny: one intra-op thread keeps torch from competing
    with the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spaces(n, kx, ky):
    tsp = tb.Space2(getattr(tb, kx)(n), getattr(tb, ky)(n), device="cpu", dtype=torch.float64)
    return tsp, jb.Space2(getattr(jb, kx)(n), getattr(jb, ky)(n))


def _close(got, want, tol=TOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= tol * float(np.max(np.abs(want)))


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal((n, n))


@pytest.mark.parametrize("n", [17, 33])
@pytest.mark.parametrize("kx", ["cheb_dirichlet", "cheb_neumann"])
def test_hholtz_adi_matches_reference(n, kx):
    """Both axes of the velocity (Dirichlet) and temperature (Neumann x
    Dirichlet) spaces, every method."""
    tsp, jsp = _spaces(n, kx, "cheb_dirichlet")
    c = (3e-3, 2e-3)
    rhs = _rhs(n, n)
    want = {m: jsolver.HholtzAdi(jsp, c, method=m).solve(jnp.asarray(rhs)) for m in ("banded", "dense")}
    for method, ref in (("banded", "banded"), ("pallas", "banded"), ("dense", "dense")):
        solver = tsolver.HholtzAdi(tsp, c, method=method)
        _close(solver.solve(torch.as_tensor(rhs)), want[ref])
        assert len(solver.kernels()) == (0 if method == "dense" else 2)


@pytest.mark.parametrize("n", [17, 33])
@pytest.mark.parametrize("kind", ["poisson_neumann", "poisson_dirichlet", "hholtz_dirichlet"])
def test_tensor_solvers_match_reference(n, kind):
    """Poisson on the pseudo-pressure (Neumann^2) and Dirichlet^2 spaces,
    Helmholtz (c=0.1) on Dirichlet^2; methods banded (the tensor solver)
    and fd (fast diagonalisation)."""
    name, k = kind.split("_")
    tsp, jsp = _spaces(n, f"cheb_{k}", f"cheb_{k}")
    c = (0.1, 0.1) if name == "hholtz" else (1.0, 0.8)
    rhs = _rhs(n, 2 * n)
    tcls = {"poisson": tsolver.Poisson, "hholtz": tsolver.Hholtz}[name]
    jcls = {"poisson": jsolver.Poisson, "hholtz": jsolver.Hholtz}[name]
    for method in ("banded", "fd"):
        want = np.array(jcls(jsp, c, method=method).solve(jnp.asarray(rhs)))
        if k == "neumann":
            want[0, 0] = 0.0  # the singular mode, pinned by the step in both packages
        solver = tcls(tsp, c, method=method)
        got = solver.solve(torch.as_tensor(rhs))
        if k == "neumann":
            got[0, 0] = 0.0
        _close(got, want)
        assert len(solver.kernels()) == (1 if method == "banded" else 0)


def test_solvers_batch_and_reject_bad_input():
    tsp, _ = _spaces(17, "cheb_dirichlet", "cheb_dirichlet")
    rng = np.random.default_rng(4)
    rhs = torch.as_tensor(rng.standard_normal((2, 17, 17)))
    for solver in (tsolver.HholtzAdi(tsp, (1e-3, 1e-3)), tsolver.Poisson(tsp, (1.0, 1.0)),
                   tsolver.Poisson(tsp, (1.0, 1.0), method="fd")):
        got = solver.solve(rhs)
        for i in range(2):
            torch.testing.assert_close(got[i], solver.solve(rhs[i]), rtol=0, atol=1e-14)
        with pytest.raises(ValueError, match="rhs.ndim >= 2"):
            solver.solve(rhs[0, 0])
    assert tsolver.default_method() == "banded"
    with pytest.raises(ValueError, match="unknown solver method"):
        tsolver.HholtzAdi(tsp, (1e-3, 1e-3), method="fd")
    with pytest.raises(ValueError, match="unknown solver method"):
        tsolver.Poisson(tsp, (1.0, 1.0), method="dense")


@pytest.mark.parametrize("method", ["banded", "dense"])
def test_hholtz_adi_manufactured_solution(method):
    """examples/solve_hholtz.py (confined): (I - alpha lap) u = f with
    f = cos(pi/2 x) cos(pi/2 y), so u = f / (1 + 2 alpha (pi/2)^2)."""
    n, alpha, hn = 33, 1e-5, np.pi / 2.0
    sp = tb.Space2(tb.cheb_dirichlet(n), tb.cheb_dirichlet(n), device="cpu", dtype=torch.float64)
    xs, ys = (b.points for b in sp.bases)
    f = np.cos(hn * xs)[:, None] * np.cos(hn * ys)[None, :]
    rhs = sp.to_ortho(sp.forward(torch.as_tensor(f)))
    out = sp.backward(tsolver.HholtzAdi(sp, (alpha, alpha), method=method).solve(rhs)).numpy()
    assert float(np.abs(out - f / (1.0 + alpha * 2.0 * hn * hn)).max()) < 1e-6


@pytest.mark.parametrize("method", ["banded", "fd"])
def test_poisson_and_hholtz_manufactured_solutions(method):
    """examples/solve_poisson.py (confined): Poisson and Helmholtz (c=0.1)
    with u = cos(pi/2 x) cos(pi/2 y)."""
    n, hn, c = 33, np.pi / 2.0, 0.1
    sp = tb.Space2(tb.cheb_dirichlet(n), tb.cheb_dirichlet(n), device="cpu", dtype=torch.float64)
    xs, ys = (b.points for b in sp.bases)
    u = np.cos(hn * xs)[:, None] * np.cos(hn * ys)[None, :]
    for solver, f in ((tsolver.Poisson(sp, (1.0, 1.0), method=method), -2.0 * hn * hn * u),
                      (tsolver.Hholtz(sp, (c, c), method=method), u * (1.0 + c * 2.0 * hn * hn))):
        out = sp.backward(solver.solve(sp.to_ortho(sp.forward(torch.as_tensor(f))))).numpy()
        assert float(np.abs(out - u).max()) < 1e-6


def test_space_names_the_current_card(monkeypatch):
    """A space made with ``device="cuda"`` carries the card's index, so the
    solvers built on it accept the tensors made on it; without a card it
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    sp = tb.Space2(tb.cheb_dirichlet(9), tb.cheb_dirichlet(9), device="cuda", dtype=torch.float64)
    assert sp.device == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.Space2(tb.cheb_dirichlet(9), tb.cheb_dirichlet(9), device="cuda", dtype=torch.float64)

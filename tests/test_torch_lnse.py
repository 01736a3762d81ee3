"""PyTorch port: the linearised and perturbation models, their gradients,
the banded solve's backward and the eigenmode workload, against the JAX
package on the CPU.

* ``Navier2DLnse`` after 5 steps at 10x9 (16x17 periodic), rbc and hc
  base states in both cells, and ``Navier2DNonLin`` in two of them, on the
  dense and meshed (4 ranks) routes, against the JAX models (its default
  dense route): every field within 1e-11 of its scale, the observables
  within rel 1e-11;
* ``Navier2DNonLin`` on the conduction mean equal to ``Navier2D`` (the JAX
  package's own test, ``atol=1e-13``);
* ``grad_autodiff`` and ``grad_adjoint`` against the JAX ones at 10x9, n =
  3 (values and gradients within rel 1e-9), and the meshed route's
  ``grad_autodiff`` (4 ranks, both cells) against the JAX gradient,
  with the pencil flip's backward (the inverse flip) against its plain
  form, and on a mesh whose ranks span two processes (rel 1e-12 of the
  one-process mesh's, rel 1e-9 of the JAX gradient), ``grad_fd`` against the
  port's own ``grad_autodiff`` (the JAX package's bound, 1e-2, for forward
  differences at eps = 1e-5), and ``grad_autodiff`` held to a central
  directional difference of the port's objective (rel 1e-6);
* the banded solve's backward (``BandedSolveFn``, the kernel on ``A^T``'s
  factors) against ``torch.linalg.solve(A^T, g)`` for every solver's
  banded systems: ADI axis solves and the tensor Poisson/Helmholtz lanes
  (parity path), HC's Dirichlet-Neumann temperature (general path), the
  periodic cell's complex planes, a mesh's per-rank factor offsets and a
  member period (1e-12);
* ``build_eigenmode_ensemble`` against the JAX one, ``growth_rates`` and
  ``critical_rayleigh`` on the same samples equal to the JAX ones;
* ``MeanFields`` files written by either package and read by the other;
* ``steepest_descent_energy_constrained`` against the JAX one.
"""

import gc
import importlib.util
import os

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
from rustpde_mpi_tpu.workloads import eigenmodes as jax_eigen

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.workloads import eigenmodes

TOL = 1e-11
GRAD_TOL = 1e-9
BACKWARD_TOL = 1e-12
STEPS = 5
PARAMS = (3e3, 1.0, 1e-2, 1.0)
SHAPES = {"confined": (10, 9), "periodic": (16, 17)}
MODELS = {"lnse": (rp.Navier2DLnse, pt.Navier2DLnse),
          "nonlin": (rp.Navier2DNonLin, pt.Navier2DNonLin)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread (tiny grids); drop the JAX objects this module
    built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _means(bc, cell):
    nx, ny = SHAPES[cell]
    periodic = cell == "periodic"
    jax_mean = (rp.MeanFields.new_hc if bc == "hc" else rp.MeanFields.new_rbc)(nx, ny, periodic)
    port_mean = (pt.MeanFields.new_hc if bc == "hc" else pt.MeanFields.new_rbc)(
        nx, ny, periodic, device="cpu")
    return jax_mean, port_mean


def _model(lib, kind, bc="rbc", cell="confined", mesh=False, params=PARAMS):
    """The JAX package's (``lib == "jax"``) or the port's model, from the
    random initial condition of seed 1."""
    nx, ny = SHAPES[cell]
    periodic = cell == "periodic"
    jmean, pmean = _means(bc, cell)
    if lib == "jax":
        model = MODELS[kind][0](nx, ny, *params, bc, periodic=periodic, mean=jmean)
    else:
        where = {"mesh": pt.make_mesh(4, "cpu")} if mesh else {"device": "cpu"}
        model = MODELS[kind][1](nx, ny, *params, bc, periodic=periodic, mean=pmean, **where)
    model.init_random(1e-3, seed=1)
    return model


def _assert_fields_close(port, jax_state, tol, fields=("temp", "velx", "vely", "pres")):
    for name in fields:
        space = getattr(port, f"{name}_space")
        got = space.gather_spectral(getattr(port.state, name)).numpy()
        want = np.asarray(getattr(jax_state, name))
        scale = max(float(np.max(np.abs(want))), 1e-300)
        assert float(np.max(np.abs(got - want))) <= tol * scale, name


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX models after STEPS steps, by (kind, bc, cell), built on first
    use (each stepped by ``update()``, so that its step compiles once)."""
    cache = {}

    def get(kind, bc, cell):
        if (kind, bc, cell) not in cache:
            jm = _model("jax", kind, bc, cell)
            for _ in range(STEPS):
                jm.update()
            cache[kind, bc, cell] = (jm.state, np.asarray(jm.get_observables()))
        return cache[kind, bc, cell]

    return get


# -- the models against the JAX package ------------------------------------------


#: (kind, bc, cell) of the model comparisons: the linearised model in every
#: base state and cell, the perturbation form in two
MODEL_CASES = [("lnse", bc, cell) for bc in ("rbc", "hc") for cell in ("confined", "periodic")] \
    + [("nonlin", "rbc", "confined"), ("nonlin", "hc", "periodic")]


@pytest.mark.parametrize("mesh", [False, True], ids=["dense", "mesh"])
@pytest.mark.parametrize("kind,bc,cell", MODEL_CASES, ids=["-".join(c) for c in MODEL_CASES])
def test_models_match_jax(jax_runs, kind, bc, cell, mesh):
    state, obs = jax_runs(kind, bc, cell)
    pm = _model("port", kind, bc, cell, mesh)
    pm.update_n(STEPS)
    _assert_fields_close(pm, state, TOL)
    np.testing.assert_allclose(pm.get_observables(), obs, rtol=TOL, atol=0.0)
    assert pm.observable_names == ("energy", "ke", "te", "div")
    assert pm.kernels().keys() == ({"banded_solve", "ring_transpose"} if mesh else {"banded_solve"})


@pytest.mark.parametrize("mesh", [False, True], ids=["dense", "mesh"])
def test_nonlin_on_conduction_mean_equals_navier2d(mesh):
    """The perturbation form about the conduction profile is the DNS: its
    mean convection and diffusion are the DNS's lift terms (the JAX
    package's test, atol 1e-13 after 50 steps at 17^2)."""
    n = 17
    where = {"mesh": pt.make_mesh(4, "cpu")} if mesh else {"device": "cpu"}
    nav = pt.Navier2D(n, n, 1e4, 1.0, 0.01, 1.0, "rbc", step_kernel="dense",
                      conv_kernel="dense", **where)
    nav.set_velocity(0.1, 1.0, 1.0)
    nav.set_temperature(0.1, 1.0, 1.0)
    nl = pt.Navier2DNonLin.new_confined(n, n, 1e4, 1.0, 0.01, 1.0, "rbc",
                                        mean=pt.MeanFields.new_rbc(n, n, device="cpu"), **where)
    for name in ("velx", "vely", "temp"):
        nl.set_field(name, nav.get_field(name))
    nav.update_n(50)
    nl.update_n(50)
    for name in ("temp", "velx", "vely"):
        np.testing.assert_allclose(nl.get_field(name), nav.get_field(name), atol=1e-13)


def test_set_dt_reaches_the_embedded_model():
    """``set_dt`` on the linearised model rebuilds the embedded model's
    solvers (the JAX package's ``_dt_changed``): a step after ``dt -> dt/2``
    equals a model built at dt/2, and a revisit of dt restores it."""
    pm = _model("port", "lnse")
    fresh = _model("port", "lnse", params=(PARAMS[0], PARAMS[1], PARAMS[2] / 2, PARAMS[3]))
    pm.set_dt(PARAMS[2] / 2)
    assert pm.navier.dt == PARAMS[2] / 2
    assert pm.compat_key == fresh.compat_key
    pm.update_n(3)
    fresh.update_n(3)
    for a, b in zip(pm.state, fresh.state):
        assert torch.equal(a, b)
    pm.set_dt(PARAMS[2])
    assert pm.navier.dt == PARAMS[2] and pm.recompile_count == 2


# -- gradients --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's ``grad_autodiff`` and ``grad_adjoint`` at 10x9, n
    = 3, by kind."""
    cache = {}

    def get(kind):
        if kind not in cache:
            jm = _model("jax", kind)
            ic = jm.state
            auto = jm.grad_autodiff(0.03)
            jm.state = ic
            jm.reset_time()
            cache[kind] = (auto, jm.grad_adjoint(0.03))
        return cache[kind]

    return get


def _assert_grads_close(got, want, tol):
    val, grads = got
    assert val == pytest.approx(want[0], rel=tol)
    for g, w in zip(grads, want[1]):
        w = np.asarray(w)
        assert float(np.max(np.abs(g - w))) <= tol * float(np.max(np.abs(w)))


@pytest.mark.parametrize("method", ["grad_autodiff", "grad_adjoint"])
@pytest.mark.parametrize("kind", ["lnse", "nonlin"])
def test_gradients_match_jax(jax_grads, kind, method):
    auto, adjoint = jax_grads(kind)
    pm = _model("port", kind)
    got = getattr(pm, method)(0.03)
    _assert_grads_close(got, auto if method == "grad_autodiff" else adjoint, GRAD_TOL)
    if method == "grad_adjoint":
        assert pm.time == 0.0  # the adjoint loop resets the clock


@pytest.mark.parametrize("kind", ["lnse", "nonlin"])
def test_grad_fd_matches_autodiff(kind):
    """Forward differences at eps = 1e-5 against the exact gradient (the
    JAX package's bound, 1e-2 of the gradient's norm per field)."""
    pm = _model("port", kind)
    ic = pm.state
    _, auto = pm.grad_autodiff(0.03)
    pm.state = ic
    fd = pm.grad_fd(0.03, eps=1e-5, batch=40)
    for a, f in zip(auto, fd):
        assert np.linalg.norm(f + a) / np.linalg.norm(f) < 1e-2


@pytest.mark.parametrize("kind", ["lnse", "nonlin"])
def test_grad_autodiff_matches_directional_difference(kind):
    """The exact gradient against a central difference of the port's own
    objective along a random direction (the JAX package's check)."""
    pm = _model("port", kind)
    _, grads = pm.grad_autodiff(0.03)
    base = pm._host_phys(pm.state)
    objective = pm._objective(3, 0.5, 0.5, None)
    rng = np.random.default_rng(0)
    dirs = [rng.standard_normal(a.shape) for a in base]
    eps = 1e-6

    def at(sign):
        return float(objective(*(pm._place_physical(a + sign * eps * d)
                                 for a, d in zip(base, dirs))))

    fd = (at(1.0) - at(-1.0)) / (2 * eps)
    ad = -sum(float(np.sum(g * d)) for g, d in zip(grads, dirs))
    assert ad == pytest.approx(fd, rel=1e-6)


_JAX_GRADS = {}


def _jax_dense_grads(kind, cell):
    """The JAX package's ``grad_autodiff`` and ``grad_adjoint`` at n = 3 on
    its dense route (cached across the tests of this module)."""
    if (kind, cell) not in _JAX_GRADS:
        jm = _model("jax", kind, cell=cell)
        ic = jm.state
        auto = jm.grad_autodiff(0.03)
        jm.state = ic
        jm.reset_time()
        _JAX_GRADS[kind, cell] = (auto, jm.grad_adjoint(0.03))
    return _JAX_GRADS[kind, cell]


@pytest.mark.parametrize("kind,cell", [("lnse", "confined"), ("lnse", "periodic"),
                                       ("nonlin", "confined")])
def test_meshed_grad_autodiff_matches_jax(kind, cell):
    """The meshed route (4 ranks) against the JAX package's gradient in
    both cells: every flip of the forward loop is differentiated by the
    inverse flip, and the returned gradients are the global arrays."""
    auto, _ = _jax_dense_grads(kind, cell)
    pm = _model("port", kind, cell=cell, mesh=True)
    val, grads = pm.grad_autodiff(0.03)
    assert all(g.shape == SHAPES[cell] for g in grads)
    _assert_grads_close((val, grads), auto, GRAD_TOL)
    assert pm.mesh.ring.launches == pm.mesh.ring.backward_launches == 0  # the plain ring


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, whose phase 30b holds a meshed
    gradient's flip counts on the card."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("steps", [1, 3])
def test_meshed_gradient_flip_counts(monkeypatch, steps):
    """The flips of a meshed ``grad_autodiff`` (confined cell), forward and
    backward, are ``chip_smoke.GRAD_FLIPS_FWD``/``GRAD_FLIPS_BWD``'s
    ``a + b * steps``, counted here on the plain ring (the card's counters
    count launches only)."""
    from rustpde_mpi_tpu_torch.ops import ring_transpose

    cs = _chip_smoke()
    counts = {"all": 0, "backward": 0}
    backward = ring_transpose.FlipFn.backward

    def counted_backward(ctx, g):
        counts["backward"] += 1
        return backward(ctx, g)

    monkeypatch.setattr(ring_transpose.FlipFn, "backward", staticmethod(counted_backward))
    pm = _model("port", "lnse", mesh=True)
    ring = pm.mesh.ring
    flip = ring.flip

    def counted(block, x_to_y):
        counts["all"] += 1
        return flip(block, x_to_y)

    ring.flip = counted
    pm.grad_autodiff(steps * PARAMS[2])
    assert counts["all"] - counts["backward"] == cs.GRAD_FLIPS_FWD[0] + cs.GRAD_FLIPS_FWD[1] * steps
    assert counts["backward"] == cs.GRAD_FLIPS_BWD[0] + cs.GRAD_FLIPS_BWD[1] * steps


def test_spanning_grad_autodiff_matches_one_process_and_jax(tmp_path):
    """``grad_autodiff`` on a mesh whose 4 ranks span two processes
    (``tests/torch_mp_worker.py``, mode ``spanning_grad``, gloo): every
    flip of the forward loop differentiated by the inverse flip across the
    processes, the objective's sums through the rank gather.  Its value and
    gradients within rel 1e-12 of the one-process ``make_mesh(4)``
    gradient, with as many backward flips, and within rel 1e-9 of the JAX
    dense gradient (the JAX meshed one does not run on the CPU)."""
    import sys

    from rustpde_mpi_tpu_torch.ops import ring_transpose

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_mp_worker import path_grad, spawn

    results = spawn(str(tmp_path), "spanning_grad", timeout=60.0)
    for rc, _, err, res in results:
        assert rc == 0 and res is not None, err[-3000:]
    got = np.load(os.path.join(str(tmp_path), "grad.npz"))
    got = (float(got["value"]), tuple(got[f"grad_{i}"] for i in range(3)))
    counts = {"backward": 0}
    backward = ring_transpose.FlipFn.backward

    def counted(ctx, g):
        counts["backward"] += 1
        return backward(ctx, g)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ring_transpose.FlipFn, "backward", staticmethod(counted))
        one = path_grad(pt.make_mesh(4, "cpu"))
    assert [res["backward_flips"] for *_, res in results] == [counts["backward"]] * 2
    _assert_grads_close(got, one, BACKWARD_TOL)
    _assert_grads_close(got, _jax_dense_grads("lnse", "confined")[0], GRAD_TOL)


def test_flip_backward_is_the_inverse_flip():
    """``FlipFn``: the gradient of ``<w, flip(x)>`` is ``flip^-1(w)``, on
    real and complex pencils with and without a member dim; an input that
    needs no gradient records nothing."""
    mesh = pt.make_mesh(4, "cpu")
    ring = mesh.ring
    rng = np.random.default_rng(3)
    for shape, x_to_y in [((4, 8, 3), True), ((4, 2, 12), False), ((2, 4, 8, 3), True)]:
        for dtype in (torch.float64, torch.complex128):
            x = torch.tensor(rng.standard_normal(shape), dtype=torch.float64).to(dtype)
            x.requires_grad_(True)
            y = ring.apply(x, x_to_y)
            w = torch.tensor(rng.standard_normal(tuple(y.shape)), dtype=torch.float64).to(dtype)
            (g,) = torch.autograd.grad(torch.sum((y * w.conj()).real), x)
            assert torch.equal(g, ring.plain(w, not x_to_y))
    plain = torch.zeros((4, 8, 3), dtype=torch.float64)
    assert ring.apply(plain, True).grad_fn is None


# -- the banded solve's backward ----------------------------------------------------


def _dense(kernel, lane=None):
    """The dense matrix ``L U`` of one factor set of a banded solve."""
    lower, upper = kernel._host_factors
    if lane is not None:
        lower, upper = lower[lane], upper[lane]
    p, n, q = lower.shape[0], lower.shape[1], upper.shape[0] - 1
    L, U = np.eye(n), np.zeros((n, n))
    for d in range(1, p + 1):
        L[np.arange(d, n), np.arange(n - d)] = lower[d - 1, d:]
    for d in range(q + 1):
        U[np.arange(n - d), np.arange(d, n)] = upper[d, : n - d]
    return L @ U


def _solves(case):
    """``(BandedSolver, rhs shape, axis, factor batch stride, period,
    complex)`` of one case, from the solvers of a small model."""
    if case.startswith("periodic"):
        model = pt.Navier2D(8, 17, 1e4, 1.0, 1e-2, 1.0, "rbc", periodic=True, device="cpu",
                            step_kernel="dense", conv_kernel="dense")
    else:
        model = pt.Navier2D(10, 9, 1e4, 1.0, 1e-2, 1.0, "hc" if case.startswith("hc") else "rbc",
                            device="cpu", step_kernel="dense", conv_kernel="dense")
    if case in ("adi_x", "adi_y"):
        axis = 0 if case == "adi_x" else 1
        return model.solver_velx.solvers[axis].solver, (2, 8, 7), axis + 1, 0, 0, False
    if case == "hc_temp_y":
        return model.solver_temp.solvers[1].solver, (10, 7), 1, 0, 0, False
    if case == "poisson_lanes":
        solver = model.solver_pres._solver.banded
        return solver, (2, solver.kernel.lanes, solver.n), 2, 0, 0, False
    if case == "hholtz_members":
        solver = pt.Hholtz(model.temp_space, (0.1, 0.1))._solver.banded
        return solver, (3, solver.kernel.lanes, solver.n), 2, 0, 0, False
    if case == "periodic_complex":
        solver = model.solver_pres._solver.banded
        return solver, (2, solver.kernel.lanes, solver.n), 2, 0, 0, True
    mesh = pt.make_mesh(4, "cpu")
    if case == "mesh_lanes":  # rank-stacked y-pencils, rank r's slice of the lanes
        solver = pt.Poisson(pt.Navier2D(10, 9, 1e4, 1.0, 1e-2, 1.0, "rbc", mesh=mesh).pseu_space,
                            (1.0, 1.0))._solver.banded
        per = solver.kernel.lanes // 4
        return solver, (2, 4, per, solver.n), 3, per, 4, False
    raise ValueError(case)


BACKWARD_CASES = ("adi_x", "adi_y", "hc_temp_y", "poisson_lanes", "hholtz_members",
                  "periodic_complex", "mesh_lanes")


@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_banded_backward_matches_transposed_dense_solve(case):
    solver, shape, axis, stride, period, cplx = _solves(case)
    kernel = solver.kernel
    rng = np.random.default_rng(3)

    def rand():
        x = rng.standard_normal(shape)
        return torch.tensor(x + 1j * rng.standard_normal(shape) if cplx else x)

    b, g = rand().requires_grad_(True), rand()
    x = solver.solve(b, axis, factor_batch_stride=stride, factor_batch_period=period)
    (grad,) = torch.autograd.grad(x, b, g)
    assert kernel.path == kernel.transposed().path
    assert (kernel.transposed().p, kernel.transposed().q) == (kernel.q, kernel.p)
    # every lane against A^T's dense solve: move the solve axis last
    gl, got = g.movedim(axis, -1), grad.movedim(axis, -1)
    per_lane = kernel.per_lane
    err, scale = 0.0, float(torch.max(torch.abs(got)))
    for idx in np.ndindex(*gl.shape[:-1]):
        lane = None
        if per_lane:
            lane = idx[-1] + (stride * (idx[-2] % (period or 10**9)) if stride else 0)
        at = torch.tensor(_dense(kernel, lane).T, dtype=gl.dtype)
        want = torch.linalg.solve(at, gl[idx])
        err = max(err, float(torch.max(torch.abs(got[idx] - want))))
    assert err <= BACKWARD_TOL * scale, (case, err / scale)


def test_banded_solve_without_grad_records_nothing():
    """On an input that needs no gradient (the DNS step's path, and every
    captured graph's) the solve records no graph node and builds no
    transposed factors, and gives the same result as on one that does."""
    solver, shape, axis, *_ = _solves("adi_y")
    b = torch.randn(shape, dtype=torch.float64)
    x = solver.solve(b, axis)
    assert x.grad_fn is None
    assert solver.kernel._transposed is None
    y = solver.solve(b.clone().requires_grad_(True), axis)
    assert torch.equal(x, y.detach())
    y.sum().backward()
    assert solver.kernel._transposed is not None  # the backward's solve


# -- the eigenmode workload ----------------------------------------------------------------


def test_eigenmode_ensemble_matches_jax():
    """``build_eigenmode_ensemble`` at Ra 800 and 4000 (8x17, dt 0.05, two
    modes), stepped 12 steps in 4 samples: every member within 1e-11 of
    the JAX ensemble's fields, the energies within rel 1e-11, and
    ``growth_rates`` of the same samples equal."""
    kw = dict(nx=8, ny=17, dt=0.05, modes=(1, 2))
    for ra in (800.0, 4000.0):
        jens = jax_eigen.build_eigenmode_ensemble(ra=ra, **kw)
        pens = eigenmodes.build_eigenmode_ensemble(ra=ra, device="cpu", **kw)
        times, jen, pen = [], [], []
        for _ in range(4):
            jens.update_n(3)
            pens.update_n(3)
            times.append(pens.get_time())
            jen.append(np.asarray(jens.get_observables()[0]))
            pen.append(pens.get_observables()[0])
        np.testing.assert_allclose(pen, jen, rtol=TOL, atol=0.0)
        for i in range(pens.k):
            for name in ("temp", "velx", "vely", "pres"):
                want = np.asarray(getattr(jens.state, name))[i]
                got = getattr(pens.state, name)[i].numpy()
                assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))
        np.testing.assert_array_equal(eigenmodes.growth_rates(times, np.stack(jen)),
                                      jax_eigen.growth_rates(times, np.stack(jen)))


def test_growth_rates_and_critical_rayleigh_match_jax():
    rng = np.random.default_rng(4)
    times = np.linspace(0.0, 10.0, 9)
    energies = np.exp(np.outer(times, [-0.2, 0.1, 0.4]) + 1e-3 * rng.standard_normal((9, 3)))
    energies[3, 2] = np.nan  # a member that died reports NaN
    np.testing.assert_array_equal(eigenmodes.growth_rates(times, energies),
                                  jax_eigen.growth_rates(times, energies))
    rows = [{"ra": 1500.0, "sigma_max": -0.02}, {"ra": 1800.0, "sigma_max": 0.01},
            {"ra": 900.0, "sigma_max": float("nan")}]
    assert eigenmodes.critical_rayleigh(rows) == jax_eigen.critical_rayleigh(rows)
    assert eigenmodes.critical_aspect(2) == jax_eigen.critical_aspect(2)
    with pytest.raises(ValueError, match="bracket"):
        eigenmodes.critical_rayleigh(rows[:1])


# -- files and the optimization routine -----------------------------------------------------


@pytest.mark.parametrize("cell", ["confined", "periodic"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_meanfield_files_cross_read(tmp_path, writer, cell):
    """A mean written by either package is read by the other (the physical
    ``v`` forward-transformed, and ``vhat`` when ``v`` is absent) to 1e-13,
    and ``read_from`` falls back to the analytic profile without a file."""
    pytest.importorskip("h5py")
    import h5py

    jmean, pmean = _means("hc", cell)
    path = str(tmp_path / "mean.h5")
    (jmean if writer == "jax" else pmean).write(path)
    nx, ny = SHAPES[cell]
    periodic = cell == "periodic"
    got_p = pt.MeanFields.read_from(nx, ny, path, "hc", periodic, device="cpu")
    got_j = rp.MeanFields.read_from(nx, ny, path, "hc", periodic)
    for attr in ("velx", "vely", "temp"):
        want = np.asarray(getattr(jmean, attr))
        scale = max(float(np.max(np.abs(want))), 1.0)
        for got in (getattr(got_p, attr).numpy(), np.asarray(getattr(got_j, attr))):
            assert np.max(np.abs(got - want)) <= 1e-13 * scale
    with h5py.File(path, "a") as h5:  # the vhat fallback
        for var in ("ux", "uy", "temp"):
            del h5[f"{var}/v"]
    vhat_only = pt.MeanFields.read_from(nx, ny, path, "hc", periodic, device="cpu")
    assert np.max(np.abs(vhat_only.temp.numpy() - np.asarray(jmean.temp))) <= 1e-13
    missing = pt.MeanFields.read_from(nx, ny, str(tmp_path / "none.h5"), "hc", periodic,
                                      device="cpu")
    assert torch.equal(missing.temp, pmean.temp)
    for a, b in zip(missing.physical(), pmean.physical()):
        assert np.array_equal(a, b)


def test_steepest_descent_matches_jax():
    rng = np.random.default_rng(5)
    args = [rng.standard_normal((12, 12)) for _ in range(6)]
    got = pt.steepest_descent_energy_constrained(*args, 0.5, 0.5, alpha=0.7)
    want = rp.steepest_descent_energy_constrained(*args, 0.5, 0.5, alpha=0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-14, atol=1e-14)
    with pytest.raises(ValueError):
        pt.steepest_descent_energy_constrained(*args, 0.5, 0.5, 7.0)


def test_write_grad_and_snapshots_read_by_jax(tmp_path):
    """``grad_adjoint(outfile=...)`` writes the gradient in the snapshot
    layout, and an lnse snapshot written by the port restores into the JAX
    model (and back) to 1e-14 of each field's scale."""
    pytest.importorskip("h5py")
    jm, pm = _model("jax", "lnse"), _model("port", "lnse")
    pm.update_n(3)
    path = str(tmp_path / "lnse.h5")
    pm.write(path)
    jm.read(path)
    _assert_fields_close(pm, jm.state, 1e-14)
    back = str(tmp_path / "back.h5")
    jm.write(back)
    fresh = _model("port", "lnse")
    fresh.read(back)
    _assert_fields_close(fresh, jm.state, 1e-14)
    assert fresh.time == pytest.approx(pm.time)
    gpath = str(tmp_path / "grad.h5")
    _, grads = pm.grad_adjoint(0.02, outfile=gpath)
    import h5py

    with h5py.File(gpath, "r") as h5:
        assert set(h5) >= {"ux", "uy", "temp"}
        np.testing.assert_allclose(np.asarray(h5["temp/v"]), grads[2], atol=1e-12)
    assert os.path.isfile(gpath)

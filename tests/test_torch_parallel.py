"""PyTorch port: the pencil-decomposed layer against the JAX package, on the CPU.

``rustpde_mpi_tpu_torch.parallel`` splits a field over a mesh of P ranks on
one device as one rank-stacked tensor and flips pencils through the
pencil-transpose kernel's wrapper (``ops/ring_transpose.py``), which runs
its plain ring version on a CPU tensor.  These tests hold it to the JAX
package's ``parallel/`` on the 8-device virtual CPU mesh that
``tests/conftest.py`` sets up (4 of its devices, as ``tests/test_parallel.py``
builds them), on the same numpy inputs:

* the bookkeeping and the transposes exactly (the transposes under both of
  the JAX package's methods, ``"alltoall"`` and ``"ring"``, which move the
  same values);
* the collectives to 1e-14 of the sum's scale (another summation order);
* 5 meshed steps of ``Navier2D(..., mesh=...)`` within 1e-11 of each
  field's scale of the JAX meshed ``Navier2D`` at 17^2 and 33x32 (the
  tolerance of the dense-route parity tests: the same algebra, other
  blockings of the products and of the padded pencils), and within 1e-12
  of the port's serial dense steps;
* a JAX meshed state carried through ``convert.py`` and stepped 3 more
  times in both packages, to 1e-11;
* the solvers on pencils on every method (the dense ``HholtzAdi``, the
  fast-diagonalisation ``Poisson`` and ``Hholtz`` too) on 2 and 4 ranks,
  confined and periodic, one member and K: within 1e-12 of the scale of
  the port's serial solve and 1e-11 of the JAX package's solve under a
  mesh of as many devices.

The kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec

import rustpde_mpi_tpu as rp
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu import solver as jsolver
from rustpde_mpi_tpu.parallel import decomp as jdecomp
from rustpde_mpi_tpu.parallel import use_mesh
from rustpde_mpi_tpu.parallel.mesh import AXIS
from rustpde_mpi_tpu_torch.ops.banded import band_lu_factor, dense_to_band, pad_band
from rustpde_mpi_tpu_torch.ops.banded_solve import BandedSolve
from rustpde_mpi_tpu_torch.parallel import decomp as tdecomp
from rustpde_mpi_tpu_torch.parallel import make_mesh
from rustpde_mpi_tpu_torch.parallel.mesh import Mesh

NRANKS = 4
FIELDS = ("temp", "velx", "vely", "pres", "pseu")
GRIDS = [(17, 17), (33, 32)]
MODEL = dict(ra=1e4, pr=1.0, dt=0.01, aspect=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The grids are tiny: one intra-op thread keeps torch from competing
    with the other test workers for the cores.  Afterwards the JAX objects
    this module built are collected: the JAX package shares its bases
    through a weak cache, and a base that outlived this module would carry
    its transform choices into the next test file of the worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


def _jax_mesh(n=NRANKS):
    devices = jax.devices()
    assert len(devices) >= n
    return JaxMesh(np.array(devices[:n]), (AXIS,))


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) if scale is None else scale
    assert float(np.max(np.abs(got - want))) <= tol * scale


# -- bookkeeping, transposes, collectives -----------------------------------------


def test_bookkeeping_matches_jax():
    shape = (20, 17)
    ref = jdecomp.Decomp2d(shape, _jax_mesh(8))
    port = tdecomp.Decomp2d(shape, make_mesh(8, "cpu"))
    assert port.nprocs == ref.nprocs == 8
    for rank in range(8):
        for name in ("x_pencil", "y_pencil"):
            got, want = getattr(port, name)(rank), getattr(ref, name)(rank)
            assert (got.st, got.en, got.sz, got.dist_axis, got.axis_contig) == \
                (want.st, want.en, want.sz, want.dist_axis, want.axis_contig), (name, rank)
    assert port.padded_shape == (24, 24)


def _jax_transposes(decomp, method):
    """The JAX package's global-view transposes and the per-device blocks
    of its pencil flip on the padded array, jitted once per shape."""
    mesh, nprocs = decomp.mesh, decomp.nprocs
    spec, phys = PartitionSpec(*jdecomp.SPEC), PartitionSpec(*jdecomp.PHYS)

    def blocks(x_to_y):
        local = jdecomp.make_transpose_local(nprocs, x_to_y=x_to_y, method=method)
        return jax.shard_map(local, mesh=mesh, in_specs=spec if x_to_y else phys,
                             out_specs=phys if x_to_y else spec)

    def fn(a, padded):
        return (decomp.transpose_x_to_y(a, method=method), decomp.transpose_y_to_x(a, method=method),
                blocks(True)(padded), blocks(False)(padded))

    return jax.jit(fn)


def _device_blocks(arr):
    """Each mesh device's local block of a sharded JAX array, in rank order."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
    return np.stack([np.asarray(s.data) for s in shards])


@pytest.mark.parametrize("shape", [(16, 24), (17, 17), (33, 20)])
def test_transposes_equal_jax_both_methods(shape):
    """Global view and per-rank blocks, both directions, exactly, against
    ``method="alltoall"`` and ``method="ring"``."""
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal(shape)
    ref = jdecomp.Decomp2d(shape, _jax_mesh())
    port = tdecomp.Decomp2d(shape, make_mesh(NRANKS, "cpu"))
    padded = np.zeros(port.padded_shape)
    padded[: shape[0], : shape[1]] = a
    got_xy = port.transpose_x_to_y(torch.as_tensor(a)).numpy()
    got_yx = port.transpose_y_to_x(torch.as_tensor(a)).numpy()
    mesh = port.mesh
    got_blocks_xy = mesh.ring.x_to_y(port.place_x_pencil(a)).numpy()
    got_blocks_yx = mesh.ring.y_to_x(port.place_y_pencil(a)).numpy()
    for method in ("alltoall", "ring"):
        xy, yx, blocks_xy, blocks_yx = _jax_transposes(ref, method)(jnp.asarray(a),
                                                                    jnp.asarray(padded))
        np.testing.assert_array_equal(got_xy, np.asarray(xy), err_msg=method)
        np.testing.assert_array_equal(got_yx, np.asarray(yx), err_msg=method)
        np.testing.assert_array_equal(got_blocks_xy, _device_blocks(blocks_xy), err_msg=method)
        np.testing.assert_array_equal(got_blocks_yx, _device_blocks(blocks_yx), err_msg=method)
    assert mesh.ring.launches == 0  # the plain ring on the CPU


def test_collectives_match_jax():
    shape = (16, 24)
    a = np.random.default_rng(7).standard_normal(shape)
    jmesh = _jax_mesh()
    ref = jdecomp.Decomp2d(shape, jmesh)
    port = tdecomp.Decomp2d(shape, make_mesh(NRANKS, "cpu"))
    placed = tdecomp.scatter_root(a, port, "y")
    want = float(jdecomp.all_gather_sum(jdecomp.scatter_root(a, ref, "y"), jmesh))
    got = float(tdecomp.all_gather_sum(placed, port.mesh))
    assert abs(got - want) <= 1e-14 * float(np.sum(np.abs(a)))
    assert float(tdecomp.broadcast_scalar(3.25, port.mesh)) == \
        float(jdecomp.broadcast_scalar(3.25, jmesh))
    per_rank = torch.tensor([2.5, 7.0, 8.0, 9.0], dtype=torch.float64)
    assert float(tdecomp.broadcast_scalar(per_rank, port.mesh)) == 2.5
    for pencil in ("x", "y"):
        back = tdecomp.gather_root(tdecomp.scatter_root(a, port, pencil), port, pencil)
        np.testing.assert_array_equal(back, jdecomp.gather_root(jdecomp.scatter_root(a, ref, pencil)))
    with pytest.raises(ValueError, match="leading dim"):
        tdecomp.all_gather_sum(placed[:2], port.mesh)


# -- the meshed model against the JAX meshed model ---------------------------------


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def jax_meshed(request):
    """The JAX meshed model on 4 virtual devices: its state after 5 steps
    and after 3 more, gathered to numpy, and its observables after 5."""
    nx, ny = request.param
    model = rp.Navier2D.new_confined(nx, ny, *MODEL.values(), "rbc", mesh=_jax_mesh())
    assert model.temp_space.sep == (False, False)
    model.update_n(5)
    at5 = {f: np.asarray(getattr(model.state, f)) for f in FIELDS}
    obs5 = (model.eval_nu(), model.eval_nuvol(), model.eval_re())
    model.update_n(3)
    at8 = {f: np.asarray(getattr(model.state, f)) for f in FIELDS}
    return (nx, ny), at5, obs5, at8


def _port(nx, ny, **kw):
    return pt.Navier2D.new_confined(nx, ny, *MODEL.values(), "rbc", device="cpu", **kw)


def test_meshed_steps_match_jax_meshed_and_serial(jax_meshed):
    (nx, ny), at5, obs5, _ = jax_meshed
    meshed = _port(nx, ny, mesh=make_mesh(NRANKS, "cpu"))
    serial = _port(nx, ny, step_kernel="dense", conv_kernel="dense")
    meshed.update_n(5)
    serial.update_n(5)
    got, ser = pt.state_to_numpy(meshed), pt.state_to_numpy(serial)
    for f in FIELDS:
        scale = float(np.max(np.abs(at5[f])))
        _close(got[f], at5[f], 1e-11, scale)
        _close(got[f], ser[f], 1e-12, scale)
    nu, nuvol, re, div = meshed.get_observables()
    for val, want in zip((nu, nuvol, re), obs5):
        assert val == pytest.approx(want, rel=1e-10)
    assert div == pytest.approx(serial.get_observables()[3], rel=1e-9)
    assert meshed.time == pytest.approx(5 * MODEL["dt"])


def test_jax_meshed_state_carried_through_convert(jax_meshed):
    (nx, ny), at5, _, at8 = jax_meshed
    meshed = _port(nx, ny, mesh=make_mesh(NRANKS, "cpu"))
    pt.state_from_numpy(meshed, at5)
    np.testing.assert_array_equal(pt.state_to_numpy(meshed)["temp"], at5["temp"])
    meshed.update_n(3)
    got = pt.state_to_numpy(meshed)
    for f in FIELDS:
        _close(got[f], at8[f], 1e-11)


# -- the port's pencil layer against its own serial path -------------------------------


def _counted_flips(mesh):
    """Count the mesh's flips on the CPU (the ``launches`` counter counts
    kernel launches on a card only)."""
    calls = []
    plain = mesh.ring.plain
    mesh.ring.plain = lambda block, x_to_y: calls.append(x_to_y) or plain(block, x_to_y)
    return calls


def test_meshed_step_flips_and_solves():
    """A meshed dense step flips 37 times and runs 7 banded solves, one
    for all ranks each (the counts chip_smoke.py checks on the card)."""
    mesh = make_mesh(NRANKS, "cpu")
    model = _port(17, 17, mesh=mesh)
    calls = _counted_flips(mesh)
    kernels = model.kernels()
    assert set(kernels) == {"banded_solve", "ring_transpose"}
    solves = []
    for k in kernels["banded_solve"]:
        plain = k.plain
        k.plain = lambda b, fbs=0, fbp=0, plain=plain: solves.append(b.shape[0]) or plain(b, fbs, fbp)
    model.update()
    assert len(calls) == 37
    assert calls.count(True) == 21 and calls.count(False) == 16
    assert solves == [NRANKS] * 7


@pytest.mark.parametrize("shape", [(17, 17), (33, 32)])
def test_pencil_space_matches_serial(shape):
    """Every transform of a pencil space equals the serial space's on the
    gathered field, and leaves the pad exactly zero."""
    mesh = make_mesh(NRANKS, "cpu")
    bases = (pt.cheb_dirichlet(shape[0]), pt.cheb_neumann(shape[1]))
    serial = pt.Space2(*bases, device="cpu", dtype=torch.float64)
    space = pt.parallel.PencilSpace2(pt.Space2(*bases, device="cpu", dtype=torch.float64), mesh)
    rng = np.random.default_rng(3)
    phys = torch.as_tensor(rng.standard_normal(serial.shape_physical))
    spec = torch.as_tensor(rng.standard_normal(serial.shape_spectral))
    ps, pp = space.place_spectral(spec), space.place_physical(phys)
    cases = [
        ("forward", space.forward(pp), serial.forward(phys), True),
        ("backward", space.backward(ps), serial.backward(spec), False),
        ("backward_fast", space.backward_fast(ps), serial.backward_fast(spec), False),
        ("backward_ortho", space.backward_ortho(space.place_spectral(serial.to_ortho(spec))),
         serial.backward_ortho(serial.to_ortho(spec)), False),
        ("to_ortho", space.to_ortho(ps), serial.to_ortho(spec), True),
        ("gradient", space.gradient(ps, (1, 1), (2.0, 1.0)), serial.gradient(spec, (1, 1), (2.0, 1.0)),
         True),
        ("backward_gradient", space.backward_gradient(ps, (2, 0), (2.0, 1.0)),
         serial.backward_gradient(spec, (2, 0), (2.0, 1.0)), False),
        ("pin_zero_mode", space.pin_zero_mode(ps), serial.pin_zero_mode(spec), True),
    ]
    for name, got, want, spectral in cases:
        decomp = tdecomp.Decomp2d(tuple(want.shape), mesh)
        gathered = decomp.gather_x_pencil(got) if spectral else decomp.gather_y_pencil(got)
        _close(gathered, want, 1e-13, max(float(want.abs().max()), 1e-300))
        placed = decomp.place_x_pencil(gathered) if spectral else decomp.place_y_pencil(gathered)
        assert torch.equal(placed, got), f"{name}: nonzero pad"
    np.testing.assert_array_equal(space.dealias_mask(), serial.dealias_mask())


@pytest.mark.parametrize("shape", [(17, 17), (33, 32)])
def test_pencil_solvers_match_serial(shape):
    mesh = make_mesh(NRANKS, "cpu")
    bases = (pt.cheb_dirichlet(shape[0]), pt.cheb_dirichlet(shape[1]))
    serial = pt.Space2(*bases, device="cpu", dtype=torch.float64)
    space = pt.parallel.PencilSpace2(pt.Space2(*bases, device="cpu", dtype=torch.float64), mesh)
    rhs = torch.as_tensor(np.random.default_rng(5).standard_normal(serial.shape_physical))
    ortho = tdecomp.Decomp2d(serial.shape_physical, mesh)
    out = tdecomp.Decomp2d(serial.shape_spectral, mesh)
    for make in (lambda sp: pt.HholtzAdi(sp, (1e-3, 2e-3)),
                 lambda sp: pt.Poisson(sp, (1.0, 1.0)),
                 lambda sp: pt.Hholtz(sp, (0.1, 0.1))):
        serial_solver, pencil_solver = make(serial), make(space)
        want = serial_solver.solve(rhs)
        got = pencil_solver.solve(ortho.place_x_pencil(rhs))
        _close(out.gather_x_pencil(got), want, 1e-12)
        assert torch.equal(out.place_x_pencil(out.gather_x_pencil(got)), got)
        # the spectral extents (15 or 31 and 30) pad to multiples of 4 with
        # identity rows, which couple to nothing: the padded systems still
        # couple rows of one parity only, as the serial ones do
        assert all(k.path == "parity" for k in pencil_solver.kernels())
        assert all(k.path == "parity" for k in serial_solver.kernels())
    # the dense and fast-diagonalisation methods, on 2 and 4 ranks
    _dense_fd_parity(bases, (rp.cheb_dirichlet(shape[0]), rp.cheb_dirichlet(shape[1])),
                     rhs.numpy())


#: the methods whose pencil solves are dense products: ``(solver, c,
#: method)``, the same names in both packages
DENSE_FD = (("HholtzAdi", (1e-3, 2e-3), "dense"), ("Poisson", (1.0, 1.0), "fd"),
            ("Hholtz", (0.1, 0.1), "fd"))


def _jax_solve(jspace, name, c, method, rhs, nranks):
    """The JAX package's solve of the global ``rhs`` under a mesh of
    ``nranks`` of the conftest's virtual devices (jitted, so that its pencil
    constraints shard), gathered to numpy."""
    solver = getattr(jsolver, name)(jspace, c, method=method)
    with use_mesh(_jax_mesh(nranks)):
        return np.asarray(jax.jit(solver.solve)(jnp.asarray(rhs)))


def _close_lanes(got, want, tol):
    """``_close`` on lane 0 of axis 0 and on the rest apart: a Fourier axis
    0's k = 0 lane of ``Poisson`` is the nudged singular system, ~1e10
    times the others."""
    _close(got[:1], want[:1], tol)
    _close(got[1:], want[1:], tol)


def _dense_fd_parity(bases, jbases, rhs, members=0):
    """Each solver of ``DENSE_FD`` on a pencil space over ``bases`` on 2 and
    ``NRANKS`` ranks against the port's serial solve (1e-12 of the scale)
    and the JAX package's solve under a mesh of as many devices (1e-11), on
    the global ortho-space ``rhs``; the pad stays zero.  ``members`` K > 0:
    K members (``rhs`` times 1..K) as one ``(K, P, n0, n1)`` pencil solve,
    each member against its own serial and JAX solves."""
    serial = pt.Space2(*bases, device="cpu", dtype=torch.float64)
    jspace = rp.Space2(*jbases)
    rhss = [rhs * (i + 1) for i in range(max(members, 1))]
    for nranks in (2, NRANKS):
        mesh = make_mesh(nranks, "cpu")
        space = pt.parallel.PencilSpace2(pt.Space2(*bases, device="cpu", dtype=torch.float64),
                                         mesh)
        ortho = tdecomp.Decomp2d(rhs.shape, mesh)
        block = torch.stack([ortho.place_x_pencil(r) for r in rhss])
        for name, c, method in DENSE_FD:
            solver = getattr(pt, name)(space, c, method=method)
            assert solver.kernels() == []  # matrix products and a division only
            got = solver.solve(block) if members else solver.solve(block[0])[None]
            for i, r in enumerate(rhss):
                want = getattr(pt, name)(serial, c, method=method).solve(torch.as_tensor(r))
                out = tdecomp.Decomp2d(tuple(want.shape), mesh)
                gathered = out.gather_x_pencil(got[i])
                what = f"{name} {method} on {nranks} ranks, member {i}"
                assert torch.equal(out.place_x_pencil(gathered), got[i]), f"{what}: nonzero pad"
                _close_lanes(gathered.numpy(), want.numpy(), 1e-12)
                _close_lanes(gathered.numpy(), _jax_solve(jspace, name, c, method, r, nranks),
                             1e-11)


@pytest.mark.parametrize("n0", [16, 20])
def test_pencil_dense_and_fd_periodic(n0):
    """A Fourier axis 0 (r2c, complex pencils; its Helmholtz factor and
    eigenvalues diagonal, no maps) by a Chebyshev axis 1: the dense and
    fast-diagonalisation methods on 2 and 4 ranks against the serial solve
    and the JAX package's under a mesh."""
    bases = (pt.fourier_r2c(n0), pt.cheb_dirichlet(17))
    space = pt.Space2(*bases, device="cpu", dtype=torch.float64)
    shape = (space.shape_spectral[0], space.shape_physical[1])  # the ortho extents
    rng = np.random.default_rng(n0)
    rhs = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    _dense_fd_parity(bases, (rp.fourier_r2c(n0), rp.cheb_dirichlet(17)), rhs)


@pytest.mark.parametrize("periodic", [False, True], ids=["confined", "periodic"])
def test_pencil_dense_and_fd_members(periodic):
    """K = 3 members' ``(K, P, n0, n1)`` pencils through one solve of each
    dense or fast-diagonalisation solver, every member within 1e-12 of its
    serial solve and 1e-11 of the JAX package's under a mesh."""
    n0 = 16 if periodic else 17
    tb0, jb0 = ((pt.fourier_r2c, rp.fourier_r2c) if periodic
                else (pt.cheb_dirichlet, rp.cheb_dirichlet))
    bases = (tb0(n0), pt.cheb_dirichlet(18))
    space = pt.Space2(*bases, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(40)
    # the ortho extents: a Fourier axis's modes, a Chebyshev axis's points
    shape = (space.shape_spectral[0] if periodic else n0, space.shape_physical[1])
    rhs = rng.standard_normal(shape)
    if periodic:
        rhs = rhs + 1j * rng.standard_normal(shape)
    _dense_fd_parity(bases, (jb0(n0), rp.cheb_dirichlet(18)), rhs, members=3)


def test_banded_factor_batch_stride():
    """Per-lane factors read with a factor batch stride give, for batch k,
    the solves of lanes k*stride.. -- bit for bit the unbatched solve; and
    identity padding leaves the real rows' factors and results exact."""
    rng = np.random.default_rng(9)
    n, lanes, p, q = 13, 12, 2, 4
    band_mask = np.tril(np.triu(np.ones((n, n)), -p), q)
    dense = rng.uniform(0.2, 0.6, (lanes, n, n)) * band_mask + 4.0 * np.eye(n)
    lower, upper = band_lu_factor(dense_to_band(dense, p, q), p, q)
    solve = BandedSolve(lower, upper, device="cpu", dtype=torch.float64)
    b = torch.as_tensor(rng.standard_normal((1, n, lanes)))
    want = solve.apply(b)
    stacked = b.view(n, NRANKS, lanes // NRANKS).transpose(0, 1)
    got = solve.apply(stacked, factor_batch_stride=lanes // NRANKS)
    assert torch.equal(got.transpose(0, 1).reshape(1, n, lanes), want)
    with pytest.raises(ValueError, match="factor batch stride"):
        solve.apply(stacked, factor_batch_stride=lanes // NRANKS + 1)
    with pytest.raises(ValueError, match="per-lane"):
        BandedSolve(lower[0], upper[0], device="cpu", dtype=torch.float64).apply(
            stacked, factor_batch_stride=3)
    # identity padding: rows to 16, lanes to 16
    plow, pupp = band_lu_factor(pad_band(dense_to_band(dense, p, q), p, 16, 16), p, q)
    np.testing.assert_array_equal(plow[:lanes, :, :n], lower)
    np.testing.assert_array_equal(pupp[:lanes, :, :n], upper)
    padded = BandedSolve(plow, pupp, device="cpu", dtype=torch.float64)
    bp = torch.zeros((1, 16, 16), dtype=torch.float64)
    bp[:, :n, :lanes] = b
    out = padded.apply(bp)
    assert torch.equal(out[:, :n, :lanes], want)
    assert not out[:, n:].any() and not out[:, :, lanes:].any()


# -- the contract of the mesh -----------------------------------------------------------


def test_mesh_contract():
    with pytest.raises(NotImplementedError, match="distinct devices"):
        Mesh(["cuda:0", "cuda:1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(NRANKS)
    mesh = make_mesh(NRANKS, "cpu")
    assert mesh.nranks == NRANKS and mesh.ring.nranks == NRANKS
    for kw in (dict(step_kernel="fused"), dict(conv_kernel="fused")):
        with pytest.raises(ValueError, match="fused"):
            _port(17, 17, mesh=mesh, **kw)
    model = _port(17, 17, mesh=mesh)
    assert (model.conv_kernel, model.step_kernel) == ("dense", "dense")
    assert model.device == mesh.device
    assert tuple(model.state.temp.shape) == (NRANKS, 16, 4)
    values = model.get_field("temp")
    assert values.shape == (17, 17) and np.all(np.isfinite(values))
    with pytest.raises(ValueError, match="shape"):
        mesh.ring.x_to_y(torch.zeros((3, 8, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        mesh.ring.x_to_y(torch.zeros((NRANKS, 6, 2), dtype=torch.float64))

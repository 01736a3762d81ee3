"""The port's sub-mesh planner against the JAX package's
(``parallel/submesh.py``, pure host planning): the same answers over a grid
of grids, configured shapes and device sets of one to four processes.  The
planners are integer logic: the comparison is exact."""

import dataclasses
import itertools
import os
import sys

import pytest

from rustpde_mpi_tpu.config import SubmeshConfig as JaxSubmeshConfig
from rustpde_mpi_tpu.parallel import submesh as jsm

from rustpde_mpi_tpu_torch.config import SubmeshConfig
from rustpde_mpi_tpu_torch.parallel import multihost as mh
from rustpde_mpi_tpu_torch.parallel import submesh as tsm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mp_worker import spawn  # noqa: E402

GRIDS = [(17, 17), (33, 32), (34, 34), (64, 66), (129, 129), (257, 257), (258, 258), (513, 514),
         (1025, 1025), (1026, 1026)]
SHAPES = [(2,), (4,), (8, 4), (2, 4, 8), (3,), (6, 2)]


@dataclasses.dataclass(frozen=True)
class _Dev:
    id: int
    process_index: int


def _devices(nproc: int, per: int):
    return [_Dev(p * per + i, p) for p in range(nproc) for i in range(per)]


@pytest.mark.parametrize("nx,ny", GRIDS)
def test_grid_fits_and_shape_for_as_jax(nx, ny):
    for shape in (1, 2, 3, 4, 6, 8, 16):
        assert tsm.grid_fits(nx, ny, shape) == jsm.grid_fits(nx, ny, shape)
    for shapes, min_nx in itertools.product(SHAPES, (1, 129, 257)):
        want = jsm.shape_for(nx, ny, JaxSubmeshConfig(shapes=shapes, shard_min_nx=min_nx))
        got = tsm.shape_for(nx, ny, SubmeshConfig(shapes=shapes, shard_min_nx=min_nx))
        assert got == want, (shapes, min_nx)


def _plan_view(plan):
    def sm(s):
        return None if s is None else (s.index, s.shape, tuple(d.id for d in s.devices))

    return (tuple(sm(s) for s in plan.submeshes), sm(plan.default), plan.nproc)


@pytest.mark.parametrize("nproc,per", [(1, 1), (1, 4), (1, 8), (2, 2), (2, 4), (4, 2), (4, 4),
                                       (3, 2)])
def test_carve_interleave_and_place_as_jax(nproc, per):
    devs = _devices(nproc, per)
    assert [d.id for d in tsm.interleave(devs, nproc)] == [d.id for d in jsm.interleave(devs,
                                                                                        nproc)]
    for shapes in SHAPES + [(), (16,), (2, 2)]:
        for n in (None, nproc):
            tplan, jplan = tsm.carve(devs, shapes, n), jsm.carve(devs, shapes, n)
            assert _plan_view(tplan) == _plan_view(jplan), shapes
            for shape in (0, 1, 2, 4, 8):
                tb, jb = tplan.by_shape(shape), jplan.by_shape(shape)
                assert (tb and tb.index) == (jb and jb.index)
                for nx, ny in GRIDS[::3]:
                    (tp, tr), (jp, jr) = tplan.place(nx, ny, shape), jplan.place(nx, ny, shape)
                    assert (tp and tp.index, tr) == (jp and jp.index, jr)


@pytest.mark.parametrize("shape", [0, 2, 4])
def test_serve_keys_as_jax(shape):
    key = ("dns", 129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", False, ())
    skey = tsm.serve_key(key, shape)
    assert skey == jsm.serve_key(key, shape)
    assert tsm.model_key(skey) == jsm.model_key(skey) == key
    assert tsm.key_shape(skey) == jsm.key_shape(skey) == shape


def test_a_carved_submesh_of_this_process_builds_a_mesh(tmp_path):
    plan = tsm.carve(mh.global_devices("cpu"), (1,))
    assert plan.submeshes == () and plan.default.shape == 1
    assert plan.default.mesh().nranks == 1
    # a sub-mesh of two processes' devices spans them: it builds in a group
    # of the two (a worker pair), and raises in this lone process, whose
    # group holds no process 1
    spanning = tsm.carve(_devices(2, 1), (2,)).by_shape(2)
    with pytest.raises(NotImplementedError, match="group"):
        spanning.mesh()
    results = spawn(str(tmp_path), "mesh_contract", timeout=45.0)
    for rank, (rc, _, err, res) in enumerate(results):
        assert rc == 0 and res is not None, err[-3000:]
        assert res["carved"] == [2, 1, rank, True]

"""A mesh whose ranks span processes, on the CPU: two processes joined by
gloo over localhost (``tests/torch_mp_worker.py``, mode ``spanning``), each
holding 2 of the 4 ranks of ``parallel.multihost.global_pencil_mesh(2,
"cpu")``, whose flips go through ``torch.distributed.all_to_all_single``
(the remote kernel's plain version) and whose sums gather every rank's
partial in rank order.  One spawn, with its own deadline, runs every case;
the tests read its results:

* the flips, real and complex, one state and K = 3 members, both
  directions, exactly the one-process ``make_mesh(4)`` flips of the same
  ranks;
* ``place_*``/``gather_*``, ``global_array``/``host_local_array``,
  ``all_gather_sum``/``all_gather_max`` and ``broadcast_scalar`` exactly
  their one-process values;
* 5 steps of the confined cell at 17^2 and of the periodic cell at 16x17
  bit for bit the one-process ``make_mesh(4)`` run (each flip is a copy and
  each sum keeps the rank order) and within 1e-11 of each field's scale of
  the JAX meshed ``Navier2D`` on 4 of the conftest's virtual devices (the
  tolerance of ``tests/test_torch_parallel.py``: the same algebra, other
  blockings of the products);
* a chunk of ``update_n`` bit for bit its eager steps;
* a NaN on rank 1's process alone: both processes freeze at the same step,
  under the sentinels and in a plain chunk, and the spawn ends (no hang);
* a sharded checkpoint written by the two processes, restored in one
  process bit for bit, and a gathered snapshot written through the root and
  read by the JAX package's reader;
* what raised on a spanning mesh before its port (an ensemble, the
  resilient runner, the statistics, a flip's backward) raises no more.
"""

import gc
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import rustpde_mpi_tpu as rp
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu.parallel.mesh import AXIS
from rustpde_mpi_tpu_torch.parallel import make_mesh
from rustpde_mpi_tpu_torch.utils import checkpoint as tck

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mp_worker import (SPAN_CELLS, SPAN_MODEL, SPAN_RANKS, SPAN_STEPS,  # noqa: E402
                             span_model, spawn)

FIELDS = ("temp", "velx", "vely", "pres", "pseu")
#: the spawn's deadline: two imports of the port and every case, ≈7 s here
DEADLINE_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    """One intra-op thread, as the workers run; drop the JAX bases this
    module built before the worker runs another file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


@pytest.fixture(scope="module")
def spanning(tmp_path_factory):
    out = tmp_path_factory.mktemp("spanning")
    results = spawn(str(out), "spanning", timeout=DEADLINE_S)
    for rc, _, err, res in results:
        assert rc == 0 and res is not None, err[-3000:]
    return str(out), [res for *_, res in results]


@pytest.fixture(scope="module")
def one_process():
    """Each cell's model on the one-process ``make_mesh(4)``, stepped as the
    spawn's: global states and observables."""
    out = {}
    for cell in SPAN_CELLS:
        model = span_model(cell, make_mesh(SPAN_RANKS, "cpu"))
        model.update_n(SPAN_STEPS)
        out[cell] = (pt.state_to_numpy(model), [float(v) for v in model.get_observables()])
    return out


def _jax_meshed(cell):
    c = SPAN_CELLS[cell]
    model = rp.Navier2D(c["nx"], c["ny"], *SPAN_MODEL.values(), periodic=c["periodic"],
                        mesh=JaxMesh(np.array(jax.devices()[:SPAN_RANKS]), (AXIS,)))
    model.set_velocity(0.1, 1.0, 1.0)
    model.set_temperature(0.1, 1.0, 1.0)
    model.update_n(SPAN_STEPS)
    return {f: np.asarray(getattr(model.state, f)) for f in FIELDS}


def test_the_mesh_spans_both_processes(spanning):
    _, (r0, r1) = spanning
    assert r0["mesh"][:4] == [4, 2, 0, True] and r1["mesh"][:4] == [4, 2, 2, True]
    assert "over 2 processes" in r0["mesh"][4]
    for res in (r0, r1):
        assert res["confined_shape"] == [2, 16, 4] and res["periodic_shape"] == [2, 12, 4]
        assert res["confined_kernels"] == ["banded_solve", "ring_gather", "ring_transpose"]


def test_flips_equal_the_one_process_flips(spanning):
    for res in spanning[1]:
        assert len(res["flips"]) == 16 and all(res["flips"].values()), res["flips"]


def test_collectives_and_layout_equal_the_one_process_values(spanning):
    a = np.random.default_rng(7).standard_normal((16, 24))
    for res in spanning[1]:
        c = res["collectives"]
        for key in ("place", "gather", "global_array", "host_local"):
            assert c[f"{key}_x"] and c[f"{key}_y"], key
        assert c["sum"] == c["sum_one"]
        assert c["sum_members"] == [c["sum_one"], 2.0 * c["sum_one"]]
        assert c["max"] == float(a.max())
        assert c["broadcast_rank0"] == 2.5 and c["broadcast_host"] == 3.25


@pytest.mark.parametrize("cell", list(SPAN_CELLS))
def test_steps_equal_the_one_process_mesh_bit_for_bit(spanning, one_process, cell):
    out_dir, _ = spanning
    got = np.load(os.path.join(out_dir, f"{cell}.npz"))
    want, obs = one_process[cell]
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert got["obs"].tolist() == obs


@pytest.mark.parametrize("cell", list(SPAN_CELLS))
def test_steps_match_the_jax_meshed_model(spanning, cell):
    out_dir, _ = spanning
    got = np.load(os.path.join(out_dir, f"{cell}.npz"))
    want = _jax_meshed(cell)
    for f in FIELDS:
        scale = max(float(np.max(np.abs(want[f]))), 1e-300)
        assert float(np.max(np.abs(got[f] - want[f]))) <= 1e-11 * scale, f


def test_a_chunk_equals_eager_steps(spanning):
    assert all(res["chunk_equals_eager"] for res in spanning[1])


def test_a_nan_on_one_process_freezes_both_at_the_same_step(spanning):
    r0, r1 = spanning[1]
    assert r0["nan_sentinels"] == r1["nan_sentinels"] == [1, False]
    assert r0["nan_plain"] == r1["nan_plain"] and r0["nan_plain"][1] is False


def test_what_is_not_ported_raises(spanning):
    """Nothing raises any more: an ensemble, the resilient runner, the
    statistics and a flip's backward were the last to wait for their
    port, and each now runs on a spanning mesh (their results are held in
    ``tests/test_torch_spanning_paths.py`` and ``tests/test_torch_lnse.py``)."""
    for res in spanning[1]:
        assert set(res["not_ported"]) == {"ensemble", "runner", "stats", "backward"}
        assert all(msg is None for msg in res["not_ported"].values()), res["not_ported"]


def test_a_sharded_checkpoint_of_two_processes_restores_in_one(spanning, one_process):
    out_dir, _ = spanning
    want, _ = one_process["confined"]
    for mesh in (make_mesh(SPAN_RANKS, "cpu"), make_mesh(2, "cpu"), None):
        model = span_model("confined", mesh) if mesh is not None else pt.Navier2D(
            17, 17, *SPAN_MODEL.values(), device="cpu", step_kernel="dense",
            conv_kernel="dense")
        tck.read_sharded_snapshot(model, os.path.join(out_dir, "sharded.h5"))
        got = pt.state_to_numpy(model)
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_a_gathered_snapshot_through_the_root_reads_in_jax(spanning, one_process):
    out_dir, _ = spanning
    want, _ = one_process["confined"]
    model = rp.Navier2D(17, 17, *SPAN_MODEL.values(), False)
    model.read(os.path.join(out_dir, "snapshot.h5"))
    for f in FIELDS[:4]:  # the snapshot carries the four flow fields
        np.testing.assert_array_equal(np.asarray(getattr(model.state, f)), want[f], err_msg=f)
    assert model.time == pytest.approx(SPAN_STEPS * SPAN_MODEL["dt"])

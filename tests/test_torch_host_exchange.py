"""The remote flip across hosts, on the CPU.

Two processes joined by gloo over localhost (``tests/torch_mp_worker.py``)
are declared on two hosts (``initialize_distributed(..., host=)``), so a
spanning mesh moves their chunks as between machines: through the socket
exchange of ``csrc/host_exchange.cpp``, which :mod:`..ops._build` compiles
here with the system C++ compiler, the very code the card runs as a host
function.  Two spawns, each with its own deadline, run every case at once;
the tests read their results:

* the transport between the two processes, byte for byte over several
  rounds and the two staging buffers, at sizes that overflow the socket
  buffers both ways (mode ``host_exchange``);
* a flip stalled in the exchange, released from another thread
  (``release_waits``); a peer that stays away past the deadline; a peer
  that is gone: each raises ``DispatchHang``, within its deadline;
* a 2 x 2 mesh declared over two hosts (mode ``cross_host``): 5 steps of
  the confined cell at 17^2 and of the periodic cell at 16x17 bit for bit
  the one-process ``make_mesh(4)`` run and the same processes' mesh
  declared on one host, within 1e-11 of each field's scale of the JAX
  meshed ``Navier2D`` (run as ``tests/test_torch_spanning_mesh.py`` runs
  it), with 37 flips and 1 rank gather a step, every one through the
  exchange.
"""

import ctypes
import gc
import os
import re
import sys

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.ops import _build
from rustpde_mpi_tpu_torch.ops import host_exchange as hx
from rustpde_mpi_tpu_torch.ops import ring_transpose as rt
from rustpde_mpi_tpu_torch.parallel import make_mesh, multihost

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_spanning_mesh import FIELDS, _jax_meshed  # noqa: E402
from torch_mp_worker import (EXCHANGE_ROUNDS, EXCHANGE_SIZES, SPAN_CELLS,  # noqa: E402
                             SPAN_STEPS, TWO_HOSTS, collect, span_model, start)

#: each spawn's deadline: two imports of the port and its cases (≈7 s and
#: ≈10 s here, run side by side)
DEADLINE_S = 90.0
SOURCE = (_build.CSRC / "host_exchange.cpp").read_text()


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_gc():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    gc.collect()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawns, started together: ``{mode: (out_dir, results)}``."""
    jobs = {}
    for mode in ("host_exchange", "cross_host"):
        out = str(tmp_path_factory.mktemp(mode))
        jobs[mode] = (out, start(out, mode, TWO_HOSTS))
    return {mode: (out, collect(procs, out, DEADLINE_S)) for mode, (out, procs) in jobs.items()}


@pytest.fixture(scope="module")
def exchange(spawned):
    _, results = spawned["host_exchange"]
    (rc0, _, err0, r0), (rc1, _, err1, _) = results
    assert rc0 == 0 and r0 is not None, err0[-3000:]
    assert rc1 == 0, err1[-3000:]  # process 1 leaves by os._exit before the last case
    return r0


@pytest.fixture(scope="module")
def cross_host(spawned):
    out, results = spawned["cross_host"]
    for rc, _, err, res in results:
        assert rc == 0 and res is not None, err[-3000:]
    return out, [res for *_, res in results]


@pytest.fixture(scope="module")
def one_process():
    out = {}
    for cell in SPAN_CELLS:
        model = span_model(cell, make_mesh(4, "cpu"))
        model.update_n(SPAN_STEPS)
        out[cell] = pt.state_to_numpy(model)
    return out


def test_the_exchange_is_built_by_the_cpp_compiler_here(exchange):
    assert os.path.basename(exchange["compiler"]) in ("c++", "g++")
    assert not re.search(r"#include\s*[<\"]cuda", SOURCE)


@pytest.mark.parametrize("size", range(len(EXCHANGE_SIZES)))
def test_the_transport_moves_every_byte(exchange, size):
    """Every round's runs arrive byte for byte, out of the buffer the epoch
    names; the 16 MiB rounds overflow any socket buffer both ways, so a
    transport that sent before it received would deadlock here."""
    row = exchange["bytes"][size]
    assert row["bytes"] == EXCHANGE_SIZES[size][0]
    assert row["ok"] and row["seq"] == EXCHANGE_ROUNDS


@pytest.mark.parametrize("case, within", [("release", 5.0), ("deadline", 3.0), ("gone", 3.0)])
def test_a_stalled_or_lost_peer_raises_within_the_deadline(exchange, case, within):
    """A release from another thread lets the stalled exchange go at once
    (its deadline is 30 s); a peer that stays away fails the exchange at
    its 1 s deadline; a peer that is gone fails it at once.  Each raises
    ``DispatchHang``, and a released ring fails its next flip at once."""
    seconds, message = exchange[case]
    assert message is not None and seconds <= within, (case, seconds, message)
    assert "exchange across hosts" in message
    if case == "release":
        assert seconds >= 0.25 and "released" in message
        after, again = exchange["after_release"]
        assert again is not None and after < 0.5
    if case == "deadline":
        assert seconds >= 0.9 and "deadline" in message


def test_the_mesh_declares_its_processes_on_two_hosts(cross_host):
    _, (r0, r1) = cross_host
    assert r0["across"][:2] == [["host0", "host1"], [1]]
    assert r1["across"][:2] == [["host0", "host1"], [0]]
    assert "on 2 hosts" in r0["across"][2]
    assert r0["one_host"] == r1["one_host"] == [["one", "one"], []]


@pytest.mark.parametrize("cell", list(SPAN_CELLS))
def test_every_flip_and_gather_crosses_through_the_exchange(cross_host, cell):
    """37 flips and 1 rank gather a step, and one exchange each: every
    chunk of process 0 for process 1 crossed the socket."""
    for res in cross_host[1]:
        counts = res[f"{cell}_counts"]
        assert counts == {"flips": 37 * SPAN_STEPS, "gathers": SPAN_STEPS,
                          "exchanges": 38 * SPAN_STEPS}, counts


@pytest.mark.parametrize("cell", list(SPAN_CELLS))
def test_steps_across_hosts_equal_one_process_and_one_host(cross_host, one_process, cell):
    out, _ = cross_host
    got = np.load(os.path.join(out, f"across_{cell}.npz"))
    same = np.load(os.path.join(out, f"one_host_{cell}.npz"))
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], one_process[cell][f], err_msg=f)
        np.testing.assert_array_equal(got[f], same[f], err_msg=f)


@pytest.mark.parametrize("cell", list(SPAN_CELLS))
def test_steps_across_hosts_match_the_jax_meshed_model(cross_host, cell):
    out, _ = cross_host
    got = np.load(os.path.join(out, f"across_{cell}.npz"))
    want = _jax_meshed(cell)
    for f in FIELDS:
        scale = max(float(np.max(np.abs(want[f]))), 1e-300)
        assert float(np.max(np.abs(got[f] - want[f]))) <= 1e-11 * scale, f


# -- the plan and the build, in this process ------------------------------------------


def test_plan_struct_mirrors_the_c_layout():
    """``HxPlan`` in csrc/host_exchange.cpp, field for field, laid out by
    the C rules; its peer bound is the remote flip's process bound."""
    body = SOURCE[SOURCE.index("struct HxPlan {"):SOURCE.index("};", SOURCE.index("struct HxPlan {"))]
    body = re.sub(r"//[^\n]*", "", body[len("struct HxPlan {"):])
    assert int(re.search(r"#define HX_MAX_PEERS (\d+)", SOURCE).group(1)) == hx.MAX_PEERS == \
        _build.PUSH_MAX_PROCS
    sizes = {"void*": 8, "long long": 8, "int": 4}
    want, pos = [], 0
    for ctype, names in re.findall(r"(void\*|long long|int)\s+([^;]+);", body):
        for name in (n.strip() for n in names.split(",")):
            count = 1
            if "[" in name:
                name, count = name.split("[")[0], hx.MAX_PEERS
            pos = -(-pos // sizes[ctype]) * sizes[ctype]
            want.append((name, pos, sizes[ctype] * count))
            pos += sizes[ctype] * count
    got = [(n, getattr(hx.HxPlan, n).offset, getattr(hx.HxPlan, n).size)
           for n, _ in hx.HxPlan._fields_]
    assert got == want
    assert ctypes.sizeof(hx.HxPlan) == -(-pos // 8) * 8


@pytest.mark.parametrize("x_to_y", [True, False])
@pytest.mark.parametrize("members", [0, 3])
def test_layout_runs_are_this_process_chunks_in_the_peer_slab(x_to_y, members):
    """The plan's runs, read out of a staging buffer in the peer's slab
    layout, are exactly this process's chunks for the peer's ranks, in the
    order the copy-in places them (and wire bytes = chunk bytes)."""
    p, pl, c, w = 4, 2, 3, 5
    k = max(members, 1)
    shape = (k, pl, c, p * w) if x_to_y else (k, pl, p * c, w)
    lay = hx.layout(shape if members else shape[1:], x_to_y, p, 8)
    staging = torch.arange(int(np.prod(shape)), dtype=torch.float64).view(shape)
    raw = staging.view(torch.uint8).reshape(-1).numpy()
    for g0 in (0, pl):
        runs = []
        for i0 in range(lay.counts[0]):
            for i1 in range(lay.counts[1]):
                for i2 in range(lay.counts[2]):
                    at = g0 * lay.base_per_rank + i0 * lay.strides[0] + i1 * lay.strides[1] + \
                        i2 * lay.strides[2]
                    runs.append(raw[at:at + lay.run_bytes])
        wire = np.concatenate(runs).view(np.float64)
        assert wire.size * 8 == lay.wire_bytes == k * pl * pl * c * w * 8
        blocks = rt._blocks(staging, p, x_to_y)[:, :, g0:g0 + pl]  # [m, lt, s, i, j]
        want = blocks.permute(0, 1, 3, 2, 4) if x_to_y else blocks  # the wire order
        np.testing.assert_array_equal(wire, want.reshape(-1).numpy())
    assert lay.buf_bytes == staging.numel() * 8


def test_host_sources_build_apart_from_the_kernels():
    """The exchange is a host source: not a kernel, named by a hash of its
    source and its compiler, built by nvcc where there is one and by the
    C++ compiler here; every entry point it exports has its signature."""
    assert "host_exchange" not in _build.KERNELS and "host_exchange" in _build.HOST_SOURCES
    assert _build.source_path("host_exchange").suffix == ".cpp"
    assert _build.source_hash("host_exchange") in _build.library_path("host_exchange").name
    exported = re.findall(r'extern "C" (?:int|void\*) (\w+)\(', SOURCE)
    assert sorted(exported) == sorted(_build._SIGNATURES["host_exchange"])
    assert 'extern "C" void hx_exchange(void* plan)' in SOURCE
    lib = _build.load("host_exchange")
    assert hx.exchange_address() == ctypes.cast(lib.hx_exchange, ctypes.c_void_p).value


def test_build_prefers_nvcc_for_a_host_source(monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    cmd = _build._command("host_exchange")
    assert cmd[0].endswith("nvcc") and "-gencode" not in cmd and "-Xcompiler" in cmd
    assert _build._command("ring_transpose")[1:] == list(_build.NVCC_FLAGS)


def test_run_refuses_a_plan_without_links():
    plan = hx.HxPlan()
    assert hx.run(plan) != 0


def test_one_process_records_this_machine_as_its_host():
    assert multihost.process_hosts() == [multihost.machine_host()]
    assert "/" in multihost.machine_host()
    dev = multihost.HostDevice(0, 0, "cpu")
    assert dev.host == multihost.machine_host()
    assert multihost.HostDevice(0, 0, "cpu", "elsewhere").host == "elsewhere"


def test_a_ring_on_one_host_has_no_remote_peers():
    ring = rt.SpanningRing(4, "cpu", 2, 0)
    assert ring.remote == () and ring._links is None
    ring = rt.SpanningRing(4, "cpu", 2, 1, hosts=["a", "b"])
    assert ring.remote == (0,)
    with pytest.raises(ValueError, match="hosts for"):
        rt.SpanningRing(4, "cpu", 2, 1, hosts=["a"])

"""The port's multi-process controllers on the CPU: two processes joined by
gloo over localhost (``tests/torch_mp_worker.py``), each test with its own
deadline, no process outliving its test; and the pieces that need no
second process (the one-process degradations, the sanitizer's parse and
disarmed cost, the mesh's refusal of another process's ranks), each held
against the JAX package's ``parallel/multihost.py`` and
``parallel/sanitizer.py`` driven in this process with the same inputs.

The JAX package's multi-process tests are ``slow``
(``tests/test_multiprocess.py``); these spawn two processes at 17², as the
tier-1 budget allows.  The results are exact (flags, bytes, step counts):
no tolerance applies.
"""

import os
import sys
from collections import deque

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu.parallel import multihost as jmh
from rustpde_mpi_tpu.parallel import sanitizer as jsan
from rustpde_mpi_tpu_torch.parallel import multihost as mh
from rustpde_mpi_tpu_torch.parallel import sanitizer as san
from rustpde_mpi_tpu_torch.parallel.mesh import Mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mp_worker import spawn  # noqa: E402

#: a two-process spawn's deadline (two imports of the port, a few s each)
DEADLINE_S = 45.0


def _ok(results):
    for rc, _, err, res in results:
        assert rc == 0 and res is not None, err[-3000:]
    return [res for *_, res in results]


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return _ok(spawn(str(tmp_path_factory.mktemp("coll")), "collectives", timeout=DEADLINE_S))


def test_broadcast_obj_carries_tuples_through_tuplify(collectives):
    for res in collectives:
        assert res["obj"] == {"key": ["dns", 17, [1.5, "rbc"]], "n": 3}
        assert res["key_is_tuple"] and res["key"] == ["'dns'", "17", "(1.5, 'rbc')"]


def test_allgather_bytes_of_unequal_lengths(collectives):
    for res in collectives:
        assert res["blobs"] == ["ppp", "pppppppp"]
        assert res["gathered"] == [10, 11]  # (nproc, ...) of a scalar
        assert res["devices"] == ["cpu@proc0", "cpu@proc1"]


def test_root_decides_ignores_a_flag_on_rank_1(collectives):
    for res in collectives:
        assert res["flag_on_1"] is False and res["flag_on_0"] is True
        assert res["from_1"] == 101  # a broadcast from the marked source


def test_telemetry_gathers_across_processes(collectives):
    for res in collectives:
        assert res["merged_counter"] == 3.0  # 1 on rank 0 + 2 on rank 1
    assert [res["metrics_file"] for res in collectives] == ["metrics.jsonl", "metrics.p1.jsonl"]


def test_durable_park_of_two_processes_reads_back_whole_states(collectives):
    """Each process of a fleet replica parks the whole member state it
    holds (an odd 17^2 grid): both shards read back bit for bit, and the
    slab calls without a spanning mesh leave whole arrays whole."""
    for res in collectives:
        assert res["park_equal"] and res["park_base"] == [11, 0.11]
        assert res["park_shape"][0] % 2 == 1
        assert res["whole_slab"] and res["whole_global"]


@pytest.mark.parametrize("how", ["exited", "wedged"])
def test_sync_hosts_with_a_dead_peer_raises_dispatch_hang(tmp_path, how):
    results = spawn(str(tmp_path), "dead_peer", how, timeout=DEADLINE_S)
    assert [rc for rc, *_ in results] == [0, 0], results[0][2][-3000:]
    res = _ok(results[:1])[0]  # rank 1 left without a result
    assert res["hang"] and "peer-check" in res["label"]
    assert res["seconds"] < 5.0  # the 1.5 s deadline, or the transport's report


@pytest.fixture(scope="module")
def sanitizer_run(tmp_path_factory):
    return _ok(spawn(str(tmp_path_factory.mktemp("san")), "sanitizer", timeout=DEADLINE_S))


def test_a_clean_armed_run_does_not_trip(sanitizer_run):
    for res in sanitizer_run:
        clean = res["clean"]
        assert clean["desyncs"] == 0 and clean["verifies"] == clean["executed"] // 4
        assert clean["records"] == 32  # 8 rounds of broadcast, root_decides, allgather


def test_skip_broadcast_raises_a_desync_on_both_ranks_within_a_cadence(sanitizer_run):
    first, second = sanitizer_run
    for res in sanitizer_run:
        assert res["raised"] and "desync at global call #2" in res["raised"]
        assert res["site"].startswith(os.path.join("tests", "torch_mp_worker.py"))
        assert res["executed_at_raise"] <= 4  # the first verify after the skip
    assert first["seq"] == second["seq"] == 2 and first["site"] == second["site"]


def test_calls_paired_apart_raise_on_both_ranks_at_that_exchange(tmp_path):
    first, second = _ok(spawn(str(tmp_path), "paired_apart", timeout=DEADLINE_S))
    for res in (first, second):
        assert "transport paired host0: broadcast, host1: sync" in \
            res["kinds_disarmed"]["message"]
        # armed, the verify runs at once and locates the first divergent call
        assert "desync at global call #1" in res["kinds_armed"]["message"]
        assert res["kinds_armed"]["seq"] == 1
        assert "host0: allgather float64[2], host1: allgather float64[3]" in \
            res["shapes"]["message"]
        assert res["after"] == [0, 1]  # still paired
    assert first["kinds_armed"] == second["kinds_armed"]


def test_runner_skip_broadcast_raises_on_both_ranks(tmp_path):
    """Rank 1 skips its fifth broadcast or boundary agreement (the fourth
    boundary of eight).  Every boundary's agreement is the same call, so
    the recorded sequences stay alike until rank 1, one exchange ahead,
    reaches the final checkpoint's barrier while rank 0 agrees its last
    boundary: the transport pairs the two and both raise there."""
    first, second = _ok(spawn(str(tmp_path), "runner_skip", "0.4", timeout=DEADLINE_S))
    assert first["desync"] is not None and second["desync"] is not None
    assert first["desync"]["seq"] == second["desync"]["seq"] is not None
    assert first["desync"]["executed"] == second["desync"]["executed"]
    assert first["desync"]["message"] == second["desync"]["message"]
    assert "host0: agree[1+2]" in first["desync"]["message"]
    assert "host1: sync[rustpde-ckpt-shards]" in first["desync"]["message"]


def test_runner_stop_on_rank_0_stops_both_at_one_step(tmp_path):
    for res in _ok(spawn(str(tmp_path), "runner_stop", "0", timeout=DEADLINE_S)):
        assert res["outcome"] == "preempted" and res["step"] == 10 and res["desyncs"] == 0


def test_runner_stop_on_rank_1_alone_is_ignored(tmp_path):
    for res in _ok(spawn(str(tmp_path), "runner_stop", "1", timeout=DEADLINE_S)):
        assert res["outcome"] == "done" and res["step"] == 20 and res["verifies"] >= 1


def test_governed_spike_on_rank_1_alone_keeps_the_replicas_in_step(tmp_path):
    first, second = _ok(spawn(str(tmp_path), "host_fault", "spike", timeout=DEADLINE_S))
    for res in (first, second):
        assert res["outcome"] == "done" and res["desyncs"] == 0 and res["verifies"] >= 1
    assert (first["step"], first["dt"]) == (second["step"], second["dt"])
    kinds = [e["event"] for e in first["events"]]
    # the spike reached rank 1's replica alone; both rolled back and backed off
    assert kinds[0] == "fault_injected" and first["events"][0]["host"] == 1
    assert "pre_divergence" in kinds and "dt_adjust" in kinds and "divergence" not in kinds
    assert first["dt"] < 0.01
    assert first["digest"] != second["digest"]  # rank 0's replica was never spiked


def test_bitflip_on_rank_1_alone_rolls_both_replicas_back(tmp_path):
    first, second = _ok(spawn(str(tmp_path), "host_fault", "bitflip", timeout=DEADLINE_S))
    for res in (first, second):
        assert res["outcome"] == "done" and res["desyncs"] == 0
    assert (first["step"], first["dt"]) == (second["step"], second["dt"]) == (20, 0.01)
    kinds = [e["event"] for e in first["events"]]
    mismatch = [e for e in first["events"] if e["event"] == "integrity_mismatch"]
    # rank 0's own audit passed: it rolled back on rank 1's verdict
    assert mismatch == [{"event": "integrity_mismatch", "check": "peer", "processes": [1]}]
    assert "integrity_rollback" in kinds
    assert first["digest"] == second["digest"]  # the flip was rolled back on rank 1


# -- one process --------------------------------------------------------------------


def test_one_process_degrades_to_the_local_value():
    assert not mh.initialize_distributed()
    assert mh.process_count() == 1 and mh.process_index() == 0 and mh.is_root()
    assert mh.broadcast_obj({"a": (1, 2)}) == {"a": (1, 2)}
    assert mh.allgather_bytes(b"xy") == [b"xy"]
    assert mh.allgather_host(np.int64(3)).tolist() == [3]
    assert mh.root_decides(True) and not mh.root_decides(False)
    assert mh.any_process(True) and not mh.any_process(False)
    mh.sync_hosts("alone", timeout_s=0.1)
    assert mh.tuplify([1, [2, [3]]]) == (1, (2, (3,)))
    arr = np.arange(4.0)
    assert mh.global_array(arr) is arr
    np.testing.assert_array_equal(mh.host_local_array(torch.arange(3.0)), np.arange(3.0))
    with pytest.raises(ValueError, match="coordinator"):
        mh.initialize_distributed(num_processes=2)
    assert mh.global_pencil_mesh(2, "cpu").nranks == 2
    [dev] = mh.global_devices("cpu")
    assert (dev.id, dev.process_index, dev.device) == (0, 0, "cpu")


def test_a_mesh_of_another_process_raises_naming_item_17_1(tmp_path):
    """A mesh spans the processes of its group and none outside it: in one
    process, a mesh naming process 1 raises; in a group of two, a mesh of
    both processes' devices builds, spanning them, and one naming a third
    process raises."""
    devs = [mh.HostDevice(0, 0, "cpu"), mh.HostDevice(1, 1, "cpu")]
    with pytest.raises(NotImplementedError, match="group"):
        Mesh(devs)
    with pytest.raises(NotImplementedError, match="group"):
        Mesh(devs[1:])
    assert Mesh(devs[:1]).nranks == 1 and not Mesh(devs[:1]).spanning
    r0, r1 = _ok(spawn(str(tmp_path), "mesh_contract", timeout=DEADLINE_S))
    assert r0["both"] == [2, 1, 0, True] and r1["both"] == [2, 1, 1, True]
    assert r0["outside"] and "group" in r0["outside"] and r1["outside"]


def test_the_sanitizer_parses_strictly_and_records_nothing_disarmed():
    for bad in ("skip@2", "skip_broadcast@x", "skip_broadcast@2:h1", "skip_broadcast"):
        with pytest.raises(ValueError):
            san.configure(inject=bad)
    san.configure(enabled=False, inject="")
    mh.broadcast(np.int64(1))
    mh.root_decides(True)
    assert san.stats()["records"] == 0 and san.stats()["executed"] == 0
    san.configure(enabled=True, cadence=2)
    try:
        mh.broadcast(np.int64(1))
        mh.sync_hosts("t")
        assert san.stats()["records"] == 2 and san.stats()["seq"] == 2
        assert san.np_schema(np.zeros((2, 3))) == "float64[2, 3]"
        assert san.np_schema(np.int64(1)) == "int64[]"
    finally:
        san.configure(enabled=False)
    assert issubclass(pt.CollectiveDesyncError, RuntimeError)


# -- against the JAX package's modules, in this process -------------------------------


@pytest.fixture
def armed(monkeypatch):
    """Arm both sanitizers with the same knobs (the JAX one reads them from
    its environment, the port's takes them as arguments); disarmed after."""

    def arm(cadence=32, ring=256, inject=""):
        for name, value in (("RUSTPDE_SANITIZE", "1"), ("RUSTPDE_SANITIZE_CADENCE", str(cadence)),
                            ("RUSTPDE_SANITIZE_RING", str(ring)),
                            ("RUSTPDE_SANITIZE_INJECT", inject)):
            monkeypatch.setenv(name, value)
        jsan.reset()
        san.configure(enabled=True, cadence=cadence, ring=ring, inject=inject)

    yield arm
    for name in ("RUSTPDE_SANITIZE", "RUSTPDE_SANITIZE_CADENCE", "RUSTPDE_SANITIZE_RING",
                 "RUSTPDE_SANITIZE_INJECT"):
        monkeypatch.delenv(name, raising=False)
    jsan.reset()
    san.configure(enabled=False, cadence=32, ring=256, inject="")


def _state(mod) -> dict:
    """A sanitizer's whole observable state: counters, ring, hash, trigger."""
    st = mod._STATE
    return {"stats": mod.stats(), "ring": list(st.ring), "hash": mod._hash_words(),
            "last_verify_exec": st.last_verify_exec}


#: a collective sequence: (kind, tag, payload); ``root_decides`` records
#: intent without a transport slot of its own, so no verify trigger follows it
OPS = [("broadcast", "", np.int64(1)), ("root_decides", "", None),
       ("allgather", "", np.zeros((2, 3))), ("sync", "ckpt", None),
       ("allgather", "", np.uint8(7)), ("broadcast", "", np.zeros(5, np.uint8))] * 7


def _drive(mod, ops):
    for kind, tag, payload in ops:
        mod.record(kind, tag=tag, payload=payload)  # one call site for both packages
        if kind != "root_decides":
            mod.maybe_verify()


@pytest.mark.parametrize("cadence,ring", [(1, 8), (4, 64), (7, 16), (32, 256)])
def test_sanitizer_records_hash_and_cadence_match_jax(armed, cadence, ring):
    armed(cadence=cadence, ring=ring)
    for mod in (jsan, san):
        _drive(mod, OPS)
    want, got = _state(jsan), _state(san)
    assert got == want
    assert got["stats"]["records"] == len(OPS) and len(got["ring"]) == min(ring, len(OPS))


@pytest.mark.parametrize("spec", ["skip_broadcast@3", "skip_broadcast@0", "skip_broadcast@12:host4",
                                  "skip@2", "skip_broadcast@x", "skip_broadcast@2:h1",
                                  "skip_broadcast", "skip_broadcast@2:host", "nan@3", ""])
def test_sanitizer_injection_parses_as_jax(spec):
    def parse(mod):
        try:
            plan = mod._InjectPlan.from_spec(spec)
        except ValueError as exc:
            return "error", str(exc).partition(f"{spec!r}: ")[2]
        return None if plan is None else (plan.call, plan.host, plan.seen)

    assert parse(san) == parse(jsan)


@pytest.mark.parametrize("spec", ["skip_broadcast@3", "skip_broadcast@1:host0",
                                  "skip_broadcast@2:host1"])
def test_skip_broadcast_counting_matches_jax(armed, spec):
    armed(inject=spec)
    verdicts = {mod: [mod.skip_broadcast_injected() for _ in range(5)] for mod in (jsan, san)}
    assert verdicts[san] == verdicts[jsan]
    armed(inject=spec)
    outs = {}
    for mod in (jmh, mh):
        outs[mod] = [int(mod.broadcast(np.int64(i))) for i in range(5)]  # one call site
    assert outs[mh] == outs[jmh] == list(range(5))
    assert _state(san) == _state(jsan)  # the skipped broadcast recorded nothing in both


@pytest.mark.parametrize("value", [np.zeros((2, 3)), np.int64(1), 3, 2.5, True, "abc", b"xy",
                                   [1, 2], (1.0, 2), np.array([], np.uint8), torch.zeros(2, 3),
                                   np.zeros((0, 4), np.complex128), {"a": 1}, None],
                         ids=lambda v: type(v).__name__)
def test_np_schema_matches_jax(value):
    assert san.np_schema(value) == jsan.np_schema(value)


def _ring(entries):
    return [{"seq": i + 1, "kind": k, "tag": t, "site": f"pkg/mod.py:{site}", "schema": sc}
            for i, (k, t, site, sc) in enumerate(entries)]


_CLEAN = [("broadcast", "", 10, "int64[]"), ("root_decides", "", 11, ""),
          ("allgather", "", 12, "float64[3]"), ("sync", "ckpt", 13, "")]

#: (host 0's ring, host 1's ring, the two processes' gathered hash rows)
DESYNCS = {
    "skipped_call": (_ring(_CLEAN), _ring([_CLEAN[0]] + _CLEAN[2:]), [[4, 1, 2], [3, 5, 6]]),
    "other_site": (_ring(_CLEAN), _ring(_CLEAN[:2] + [("allgather", "", 99, "float64[3]")]
                                        + _CLEAN[3:]), [[4, 1, 2], [4, 7, 8]]),
    "other_schema": (_ring(_CLEAN), _ring(_CLEAN[:2] + [("allgather", "", 12, "float64[4]")]
                                          + _CLEAN[3:]), [[4, 1, 2], [4, 7, 8]]),
    "before_the_window": (_ring(_CLEAN), _ring(_CLEAN), [[4, 1, 2], [4, 3, 2]]),
    "evicted_window": (_ring(_CLEAN)[2:], _ring(_CLEAN[:3] + [("sync", "x", 13, "")])[1:],
                       [[4, 1, 2], [4, 1, 3]]),
}


def _fake_gather(other: bytes):
    """The verify's ring exchange as two processes would run it, this
    process being host 0 and ``other`` host 1's ring."""

    def gather(value):
        value = np.asarray(value)
        if value.ndim == 0:
            return np.array([int(value), len(other)])
        peer = np.zeros(value.size, np.uint8)
        peer[: len(other)] = np.frombuffer(other, np.uint8)
        return np.stack([value.astype(np.uint8), peer])

    return gather


@pytest.mark.parametrize("case", sorted(DESYNCS))
def test_desync_report_matches_jax(armed, monkeypatch, case):
    import json

    mine, theirs, rows = DESYNCS[case]
    armed()
    errors = {}
    for mod in (jsan, san):
        mod._STATE.ring = deque(mine, maxlen=256)
        monkeypatch.setattr(mod, "_gather", _fake_gather(json.dumps(theirs).encode()))
        with pytest.raises(mod.CollectiveDesyncError) as info:
            mod._raise_desync(np.asarray(rows, np.uint64))
        errors[mod] = info.value
    want, got = errors[jsan], errors[san]
    assert (got.seq, got.sites, got.site) == (want.seq, want.sites, want.site)
    # the diagnosis up to the advice, which names each package's own knobs
    cut = "; " if case in ("before_the_window",) else " \u2014 "
    assert str(got).split(cut)[0] == str(want).split(cut)[0]
    if case != "before_the_window":
        assert got.seq is not None and "desync at global call" in str(got)


def _one_process_calls(mod):
    """Every collective entry point on one process, one call site each."""
    return [
        mod.broadcast_obj({"a": (1, 2), "b": [3.5]}),
        mod.allgather_bytes(b"xy"),
        mod.allgather_host(np.int64(3)).tolist(),
        mod.allgather_host(np.zeros((2, 3))).shape,
        mod.broadcast(np.int32(5)).tolist(),
        mod.broadcast(np.arange(3.0), is_source=True).tolist(),
        mod.root_decides(True),
        mod.root_decides(False),
        mod.sync_hosts("alone"),
        mod.sync_hosts("alone", timeout_s=0.1),
        mod.tuplify([1, [2, [3]], "x"]),
        mod.process_index(),
        mod.is_root(),
        mod.host_local_array(np.arange(4.0)).tolist(),
    ]


def test_one_process_collectives_match_jax(armed):
    armed(cadence=3)
    got, want = _one_process_calls(mh), _one_process_calls(jmh)
    assert got == want
    assert _state(san) == _state(jsan)  # the same records at the same sites

"""The remote flip's flag protocol, in plain Python, against the plain flip.

``csrc/ring_transpose.cu`` (the remote form's note) pushes each flip of a
mesh whose ranks span processes into the peers' receive slabs: two
buffers a slab, the buffer named by the slab's epoch, ``ready[q]`` a
semaphore of process ``q``'s pushes not yet consumed.  A flip on each
process is, in order: the push (this process's ranks' chunks straight
into its output, the peers' into buffer ``epoch & 1`` of their slabs), the
signal (``ready[me] += 1`` in every peer's slab), the wait (every
``ready[q] >= 1`` in its own), the copy-out (the peers' chunks from its
buffer into its output) and the release (every ``ready[q] -= 1``, the
epoch advanced).  The push and the signal are one launch, the copy-out
and the release another, and the wait runs between them in the card's
front end.

The model here runs that sequence on parameter blocks made by the real
wrapper (``SpanningRing._push`` with the card's calls stubbed: every
process's slab a numpy array at a made-up address), with the kernel's
index math over them, captured once and replayed with constant values as
a CUDA graph replays them.  Hypothesis draws the processes' interleaving
(2, 3 and 4 processes, at least six flips over two slab keys a replay);
every schedule must end (no deadlock), never write a buffer before its
owner read the last flip in it, never read a buffer's older flip, and give
every process the plain flip's output.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rustpde_mpi_tpu_torch.ops import _build
from rustpde_mpi_tpu_torch.ops import ring_transpose as rt
from rustpde_mpi_tpu_torch.parallel import multihost

SOURCE = (_build.CSRC / "ring_transpose.cu").read_text()
#: the control words after a slab's two buffers (the source's CTL_*)
EPOCH, READY = _build.PUSH_MAX_PROCS, 0
SLAB_BASE = 1 << 44  # made-up addresses of the slabs, far from any tensor's


class Memory:
    """Every region the parameter blocks point into: tensors (inputs and
    outputs, at their real addresses) and the made-up slabs (data, then
    the control words), as flat numpy arrays of elements or words."""

    def __init__(self):
        self.regions = []  # (start, bytes, array, element bytes)

    def add(self, start, array, elem):
        self.regions.append((start, array.size * elem, array, elem))

    def at(self, addr):
        for start, nbytes, array, elem in self.regions:
            if start <= addr < start + nbytes:
                return array, (addr - start) // elem
        raise AssertionError(f"address {addr:#x} lies in no region")


class Cluster:
    """``nproc`` processes of a spanning ring of ``P`` ranks, in one Python
    process: their rings, their slabs in :class:`Memory`, the card's calls
    stubbed so that ``_push`` only fills and hands back its parameter
    block."""

    def __init__(self, monkeypatch, nproc, nlocal):
        self.nproc, self.P = nproc, nproc * nlocal
        self.mem = Memory()
        self.current = 0
        self.registered = [0] * nproc
        self.captured = []
        self.rings = [rt.SpanningRing(self.P, "cpu", nproc, me) for me in range(nproc)]
        cluster = self

        def slab_alloc(data, ptr, handle):
            me, k = cluster.current, cluster.registered[cluster.current]
            cluster.registered[me] += 1
            base = cluster.slab_addr(me, k)
            ptr._obj.value = base
            ctypes.memmove(handle, base.to_bytes(8, "little"), 8)
            cluster.mem.add(base, np.zeros(2 * data // 8, dtype=np.float64), 8)
            cluster.mem.add(base + 2 * data, np.zeros(_build.SLAB_CTL_BYTES // 4, np.int64), 4)
            return 0

        def ipc_open(handle, ptr):
            ptr._obj.value = int.from_bytes(bytes(handle)[:8], "little")
            return 0

        lib = types.SimpleNamespace(rp_slab_alloc=slab_alloc, rp_ipc_open=ipc_open,
                                    **{e: None for e in rt.PUSH_ENTRY.values()})

        def allgather(data):  # a slab's handle
            k = cluster.registered[cluster.current] - 1
            return [cluster.slab_addr(q, k).to_bytes(8, "little").ljust(len(data), b"\0")
                    for q in range(nproc)]

        def call(fn, device, ref):
            cluster.captured.append(_build.RpPush.from_buffer_copy(ref._obj))

        monkeypatch.setattr(_build, "load", lambda name: lib)
        monkeypatch.setattr(_build, "call", call)
        monkeypatch.setattr(multihost, "allgather_bytes", allgather)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        monkeypatch.setattr(torch.cuda, "device", lambda *a: contextlib.nullcontext())

    @staticmethod
    def slab_addr(q, k):
        return SLAB_BASE + (q << 36) + (k << 28)

    def capture(self, me, block, x_to_y):
        """Process ``me``'s flip of ``block``: the wrapper's parameter block
        (as a graph would capture it) and the output tensor it names."""
        self.current = me
        out = self.rings[me]._push(block, x_to_y)
        f = self.captured.pop()
        for t in (block, out):
            self.mem.add(t.data_ptr(), t.view(-1).numpy(), t.element_size())
        return f, out


def word_offsets(f, nv):
    """The kernel's index math (``ring_push_kernel``) over the parameter
    block ``f``: for the push, each word's source offset, destination rank
    and destination offset; for the copy-out, each word's offset and its
    source process.  Offsets in words of ``nv`` elements."""
    P, PL, g0, c = f.P, f.PL, f.g0, f.c
    wv = f.w // nv
    is0, is1, ism = f.is0 // nv, f.is1 // nv, (f.ism // nv if f.members > 1 else 0)
    d1, dsm, blk = f.d1 // nv, (f.dsm // nv if f.members > 1 else 0), f.blk // nv
    g = np.arange(f.members * PL * P * c * wv)
    q, j = np.divmod(g, wv)
    k, i = np.divmod(q, c)
    ml, t = np.divmod(k, P)
    m, lr = np.divmod(ml, PL)
    if f.x_to_y:
        src = m * ism + lr * is0 + (t * c + i) * is1 + j
        off = m * dsm + i * d1 + (g0 + lr) * wv + j
    else:
        src = m * ism + lr * is0 + i * is1 + t * wv + j
        off = m * dsm + ((g0 + lr) * c + i) * d1 + j
    R = P - PL
    g = np.arange(f.members * PL * R * c * wv)
    q, j = np.divmod(g, wv)
    k, i = np.divmod(q, c)
    ml, sr = np.divmod(k, R)
    m, lt = np.divmod(ml, PL)
    s = np.where(sr < g0, sr, sr + PL)
    coff = m * dsm + lt * blk + np.where(bool(f.x_to_y), i * d1 + s * wv + j,
                                          (s * c + i) * d1 + j)
    return (src, t, off), (coff, s // PL)


class Model:
    """The per-flip sequence on every process over captured parameter
    blocks.  ``programs[p]`` is process ``p``'s list of ``(flip, f, inp,
    out)``; each flip runs as the ops ``push`` (one a destination
    process), ``signal``, ``wait``, ``copy`` (one a source process) and
    ``release``.  ``buffers``/``epoch_on_card`` let a test break the
    protocol and see the model catch it."""

    def __init__(self, mem, programs, buffers=2, epoch_on_card=True):
        self.mem, self.programs = mem, programs
        self.buffers, self.epoch_on_card = buffers, epoch_on_card
        self.pending = {}  # (receiver ctl, buffer, sender) -> the epoch of its unread chunks
        self.cache = {}
        self.ops = []
        for p, program in enumerate(programs):
            seq = []
            for n, (flip, f, inp, out) in enumerate(program):
                # the key's uses before this flip in its replay: the buffer a
                # capture would bake in
                uses = sum(1 for g, h, _, _ in program[:n] if h.ctl == f.ctl and g[0] == flip[0])
                seq += [(n, "start", uses)]
                seq += [(n, "push", q) for q in range(f.nproc)]
                seq += [(n, "signal", None), (n, "wait", None)]
                seq += [(n, "copy", q) for q in range(f.nproc) if q != f.me]
                seq += [(n, "release", None)]
            self.ops.append(seq)
        self.next = [0] * len(programs)
        self.first = [{n: k for k, (n, op, _) in reversed(list(enumerate(seq)))}
                      for seq in self.ops]

    def epoch(self, f, uses):
        array, index = self.mem.at(f.ctl)
        return int(array[index + EPOCH]) if self.epoch_on_card else uses

    def runnable(self, p):
        if self.next[p] == len(self.ops[p]):
            return False
        n, op, _ = self.ops[p][self.next[p]]
        if op != "wait":
            return True
        f = self.programs[p][n][1]
        array, index = self.mem.at(f.ctl)
        return all(array[index + READY + q] >= 1 for q in range(f.nproc) if q != f.me)

    def step(self, p, on_start, on_done):
        n, op, arg = self.ops[p][self.next[p]]
        self.next[p] += 1
        flip, f, inp, out = self.programs[p][n]
        nv = f.word // inp.element_size()
        e = self.epoch(f, self.ops[p][self.first[p][n]][2])
        buf = e % self.buffers
        if op == "start":
            on_start(p, flip, inp)
        elif op == "push":
            (src, t, off), _ = self.offsets(f, nv)
            q = arg
            mine = (t // f.PL) == q
            extra = 0
            if q != f.me:
                key = (self.remote_ctl(f, q), buf, f.me)
                assert self.pending.get(key) is None, (
                    f"process {f.me} wrote flip {e} into process {q}'s buffer {buf} before "
                    f"that process read flip {self.pending.get(key)} from it")
                self.pending[key] = e
                extra = buf * f.buf_bytes
            for sw, tw, ow in zip(src[mine], t[mine], off[mine]):
                self.move(f.inp + int(sw) * f.word, f.dst[tw] + extra + int(ow) * f.word, nv)
        elif op == "signal":
            for q in range(f.nproc):
                if q != f.me:
                    array, index = self.mem.at(f.ready_peer[q])
                    array[index] += 1
        elif op == "wait":
            pass  # runnable() held it until every peer's semaphore was >= 1
        elif op == "copy":
            _, (coff, sproc) = self.offsets(f, nv)
            key = (f.ctl, buf, arg)
            assert self.pending.get(key) == e, (
                f"process {f.me} read flip {e} from its buffer {buf}, which holds process "
                f"{arg}'s flip {self.pending.get(key)}")
            self.pending[key] = None
            for ow in coff[sproc == arg]:
                ow = int(ow) * f.word
                self.move(f.slab + buf * f.buf_bytes + ow, f.out + ow, nv)
        elif op == "release":
            array, index = self.mem.at(f.ctl)
            for q in range(f.nproc):
                if q != f.me:
                    array[index + READY + q] -= 1
                    assert array[index + READY + q] >= 0
            array[index + EPOCH] += 1
            on_done(p, flip, out)

    def offsets(self, f, nv):
        key = id(f)
        if key not in self.cache:
            self.cache[key] = word_offsets(f, nv)
        return self.cache[key]

    def remote_ctl(self, f, q):
        """Process ``q``'s control words as mapped here (its semaphore of
        this process sits ``4 * me`` bytes in)."""
        return f.ready_peer[q] - 4 * f.me

    def move(self, src, dst, nv):
        a, i = self.mem.at(src)
        b, j = self.mem.at(dst)
        b[j:j + nv] = a[i:i + nv]

    def run(self, choose, on_start, on_done):
        """Run every program to its end, ``choose(k)`` picking which of
        ``k`` runnable processes takes the next op; a state where none can
        run before all are done is a deadlock."""
        while any(nx < len(ops) for nx, ops in zip(self.next, self.ops)):
            ready = [p for p in range(len(self.programs)) if self.runnable(p)]
            assert ready, f"deadlock: every process waits ({self.next})"
            self.step(ready[choose(len(ready))], on_start, on_done)


KEYS = (True, False)  # the direction of slab key 0 (x -> y) and key 1 (y -> x)


def build(monkeypatch, nproc, nlocal, members, c, w, graph, replays):
    """The cluster, its programs (``graph`` of slab keys, captured once and
    replayed ``replays`` times) and the per-flip checks: every input is
    rewritten at its flip's start, every output held against the plain
    ring's at its flip's end."""
    cl = Cluster(monkeypatch, nproc, nlocal)
    P = cl.P
    shapes = {True: (members, nlocal, P * c, w), False: (members, nlocal, c, P * w)}
    programs = [[] for _ in range(nproc)]
    for n, key in enumerate(graph):
        x_to_y = KEYS[key]
        for me in range(nproc):
            block = torch.zeros(shapes[x_to_y], dtype=torch.float64)
            f, out = cl.capture(me, block, x_to_y)
            programs[me].append([n, f, block, out])
    prog = [[] for _ in range(nproc)]
    for r in range(replays):
        for me in range(nproc):
            prog[me] += [((r, n), f, inp, out) for n, f, inp, out in programs[me]]
    plain = rt.RingTranspose(P, "cpu")

    def values(flip, me, x_to_y):
        r, n = flip
        base = 1e6 * (r * len(graph) + n) + 1e4 * me
        return base + torch.arange(int(np.prod(shapes[x_to_y])), dtype=torch.float64).view(
            shapes[x_to_y])

    done = []

    def on_start(me, flip, inp):
        inp.copy_(values(flip, me, KEYS[graph[flip[1]]]))

    def on_done(me, flip, out):
        x_to_y = KEYS[graph[flip[1]]]
        whole = torch.cat([values(flip, q, x_to_y) for q in range(nproc)], dim=1)
        want = plain.plain(whole, x_to_y)[:, me * nlocal:(me + 1) * nlocal]
        assert torch.equal(out, want), f"process {me} flip {flip}: not the plain flip"
        done.append((me, flip))

    return cl, prog, on_start, on_done, done


@pytest.mark.parametrize("nproc", [2, 3, 4])
@settings(max_examples=25, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_every_schedule_ends_with_the_plain_flip_and_overwrites_nothing(monkeypatch, nproc, data):
    """Any interleaving of the processes' ops, over a graph of at least six
    flips of two slab keys replayed with constant parameter blocks: no
    deadlock, no buffer written before its owner read its last flip,
    every output the plain flip's."""
    nlocal = data.draw(st.sampled_from([1, 2]), label="ranks a process")
    members = data.draw(st.sampled_from([1, 2]), label="members")
    c, w = data.draw(st.integers(1, 2), label="c"), data.draw(st.integers(1, 3), label="w")
    graph = data.draw(st.lists(st.sampled_from([0, 1]), min_size=6, max_size=8), label="graph")
    replays = data.draw(st.integers(1, 3), label="replays")
    cl, prog, on_start, on_done, done = build(monkeypatch, nproc, nlocal, members, c, w, graph,
                                              replays)
    assert all(f.parts == rt.PUSH_ALL for p in prog for _, f, _, _ in p)
    seed = data.draw(st.integers(0, 2**32 - 1), label="schedule")
    rng = np.random.default_rng(seed)
    Model(cl.mem, prog).run(lambda k: int(rng.integers(k)), on_start, on_done)
    assert len(done) == nproc * replays * len(graph)


def greedy(k):
    return 0  # the lowest-numbered runnable process runs as far ahead as it can


@pytest.mark.parametrize("broken", ["one buffer", "epoch baked at capture"])
def test_the_model_catches_a_broken_protocol(monkeypatch, broken):
    """The model is not vacuous: one buffer a slab (the credit gone and
    nothing in its place), or the buffer chosen when the graph was
    captured (a key used an odd number of times a replay), lets a process
    that runs ahead overwrite a buffer its owner has not read."""
    graph = [0, 1, 0, 0, 1, 0, 0]  # key 0 five times a replay, twice in a row at its ends
    cl, prog, on_start, on_done, _ = build(monkeypatch, 2, 2, 1, 2, 2, graph, 2)
    model = Model(cl.mem, prog, buffers=1 if broken == "one buffer" else 2,
                  epoch_on_card=broken != "epoch baked at capture")
    with pytest.raises(AssertionError, match="before that process read"):
        model.run(greedy, on_start, on_done)


def test_a_lost_signal_deadlocks_in_the_model(monkeypatch):
    """A flip whose peer never signals waits for ever: the model reports
    the deadlock (on the card the front-end wait is bounded by the
    caller's deadline)."""
    cl, prog, on_start, on_done, _ = build(monkeypatch, 2, 1, 1, 1, 2, [0] * 6, 1)
    model = Model(cl.mem, prog)
    model.ops[1] = [op for op in model.ops[1] if not (op[0] == 2 and op[1] == "signal")]
    with pytest.raises(AssertionError, match="deadlock"):
        model.run(greedy, on_start, on_done)


def test_parameter_block_of_a_flip(monkeypatch):
    """The wrapper's block for process 1 of 2 x 2: its ranks' chunks go
    to its output's blocks, the peer's ranks' to buffer 0 of the peer's
    slab; the control words and the peer's semaphore of this process sit
    after the two buffers."""
    cl = Cluster(monkeypatch, 2, 2)
    x = torch.zeros((2, 4 * 3, 5), dtype=torch.float64)
    cl.capture(0, x, True)
    f, out = cl.capture(1, x, True)
    data = -(-2 * 3 * 20 * 8 // rt.SLAB_ALIGN) * rt.SLAB_ALIGN
    mine, peer = cl.slab_addr(1, 0), cl.slab_addr(0, 0)
    assert (f.slab, f.buf_bytes, f.ctl) == (mine, data, mine + 2 * data)
    assert f.ready_peer[0] == peer + 2 * data + 4 * 1
    assert [f.dst[t] for t in range(4)] == [peer, peer + 60 * 8, out.data_ptr(),
                                            out.data_ptr() + 60 * 8]
    assert (f.d1, f.blk, f.dsm, f.P, f.PL, f.g0, f.members) == (20, 60, 120, 4, 2, 2, 1)
    assert (f.parts, f.word, f.w, f.c) == (rt.PUSH_ALL, 8, 5, 3)
    assert (f.mul_r, f.shr_r) == rt.fast_divmod(2) and (f.mul_l, f.shr_l) == rt.fast_divmod(2)


def test_parts_and_control_words_mirror_the_source():
    """The parts bits and the slab's control layout are the source's."""
    for name in ("PUSH_DATA", "PUSH_SIGNAL", "PUSH_WAIT", "PUSH_COPY", "PUSH_RELEASE",
                 "PUSH_ALL"):
        assert int(re.search(rf"\b{name} = (\d+)", SOURCE).group(1)) == getattr(rt, name), name
    assert int(re.search(r"#define RT_CTL_BYTES (\d+)", SOURCE).group(1)) == \
        _build.SLAB_CTL_BYTES
    assert "CTL_EPOCH = RT_MAX_PROCS," in SOURCE
    assert rt.PUSH_ALL == rt.PUSH_DATA | rt.PUSH_SIGNAL | rt.PUSH_WAIT | rt.PUSH_COPY | \
        rt.PUSH_RELEASE
    assert "tests/test_torch_remote_protocol.py" in SOURCE

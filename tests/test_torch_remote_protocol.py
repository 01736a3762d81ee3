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

Processes declared on two hosts (the remote flip's cross-host form): a
peer on another host maps no slab.  The push writes its chunks into this
process's pinned staging for it and raises this process's own semaphore
of it; the exchange (after the card copied the epoch into the plan's
word) sends the plan's runs of the staging buffer that word names and
receives the peer's runs, in order, over a channel that delivers only
what the peer sent; the copy-in puts them, by the kernel's index math,
into buffer ``epoch & 1`` of this slab; the front-end wait covers the
same-host peers alone.  The model runs that over the wrapper's real plans
and parameter blocks for 2-4 processes over two hosts, and a release in
the middle of an exchange lets the survivor of a lost peer run on.
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
from rustpde_mpi_tpu_torch.ops import host_exchange as hx
from rustpde_mpi_tpu_torch.ops import ring_transpose as rt
from rustpde_mpi_tpu_torch.parallel import multihost

SOURCE = (_build.CSRC / "ring_transpose.cu").read_text()
#: the control words after a slab's two buffers (the source's CTL_*)
EPOCH, READY = _build.PUSH_MAX_PROCS, 0
SLAB_BASE = 1 << 44  # made-up addresses of the slabs, far from any tensor's
HOST_BASE = 1 << 45  # and of the pinned host allocations


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

    def raw(self, addr, nbytes):
        """The ``nbytes`` bytes at ``addr`` (one region's), as a writable
        byte view."""
        for start, size, array, elem in self.regions:
            if start <= addr and addr + nbytes <= start + size and array.itemsize == elem:
                return array.view(np.uint8)[addr - start: addr - start + nbytes]
        raise AssertionError(f"bytes {addr:#x}+{nbytes} lie in no data region")


class Cluster:
    """``nproc`` processes of a spanning ring of ``P`` ranks, in one Python
    process: their rings, their slabs in :class:`Memory`, the card's calls
    stubbed so that ``_push`` only fills and hands back its parameter
    block."""

    def __init__(self, monkeypatch, nproc, nlocal, hosts=None):
        self.nproc, self.P = nproc, nproc * nlocal
        self.mem = Memory()
        self.current = 0
        self.registered = [0] * nproc
        self.pinned = [0] * nproc
        self.captured = []
        self.rings = [rt.SpanningRing(self.P, "cpu", nproc, me, hosts) for me in range(nproc)]
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

        def host_alloc(nbytes, host, dev):  # pinned memory the card maps at the same address
            me, k = cluster.current, cluster.pinned[cluster.current]
            cluster.pinned[me] += 1
            host._obj.value = dev._obj.value = base = HOST_BASE + (me << 36) + (k << 28)
            cluster.mem.add(base, np.zeros(nbytes, dtype=np.uint8), 1)
            return 0

        lib = types.SimpleNamespace(rp_slab_alloc=slab_alloc, rp_ipc_open=ipc_open,
                                    rp_host_alloc=host_alloc,
                                    **{e: None for e in rt.PUSH_ENTRY.values()})
        links = types.SimpleNamespace(handle=1, failure=lambda: None)

        def allgather(data):  # a slab's handle
            k = cluster.registered[cluster.current] - 1
            return [cluster.slab_addr(q, k).to_bytes(8, "little").ljust(len(data), b"\0")
                    for q in range(nproc)]

        def call(fn, device, ref):
            cluster.captured.append(_build.RpPush.from_buffer_copy(ref._obj))

        monkeypatch.setattr(_build, "load", lambda name: lib)
        monkeypatch.setattr(_build, "call", call)
        monkeypatch.setattr(hx, "connect", lambda me, nproc, remote: links)
        monkeypatch.setattr(hx, "exchange_address", lambda: 0xE1)
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


def remote_of(f):
    """The processes on other hosts than ``f``'s (bits of ``RpPush.remote``)."""
    return [q for q in range(f.nproc) if (f.remote >> q) & 1]


def copy_in_offsets(f, nv):
    """The copy-in's index math (``copy_in_kernel`` and its launch in
    ``launch_push``) over ``f``: for each other-host peer k, the word
    offset in a slab buffer of each word it received, in the wire order;
    and the words from one peer."""
    wv = f.w // nv
    x2y = bool(f.x_to_y)
    run = f.PL * wv if x2y else f.PL * f.c * wv
    nr = f.c if x2y else 1
    wire = f.members * f.PL * nr * run
    dsm, blk, d1 = (f.dsm // nv if f.members > 1 else 0), f.blk // nv, f.d1 // nv
    g = np.arange(wire)
    runs, e = np.divmod(g, run)
    ml, r = np.divmod(runs, nr)
    m, lt = np.divmod(ml, f.PL)
    off = m * dsm + lt * blk + r * d1 + e
    base = [q * f.PL * wv if x2y else q * f.PL * f.c * wv for q in remote_of(f)]
    return [b + off for b in base], wire


def plan_of(f):
    """The exchange's plan a parameter block names (the ring keeps it)."""
    return ctypes.cast(f.hx_plan, ctypes.POINTER(hx.HxPlan)).contents


class Model:
    """The per-flip sequence on every process over captured parameter
    blocks.  ``programs[p]`` is process ``p``'s list of ``(flip, f, inp,
    out)``; each flip runs as the ops ``push`` (one a destination
    process), ``signal``, where peers lie on other hosts ``xsend`` (the
    epoch's copy, then this process's runs to each of them), ``xrecv``
    and ``copyin`` (one an other-host peer), ``wait``, ``copy`` (one a
    source process) and ``release``.  ``buffers``/``epoch_on_card`` let a
    test break the protocol and see the model catch it; :meth:`release`
    is the ring's ``release_waits``."""

    def __init__(self, mem, programs, buffers=2, epoch_on_card=True):
        self.mem, self.programs = mem, programs
        self.buffers, self.epoch_on_card = buffers, epoch_on_card
        self.pending = {}  # (receiver ctl, buffer, sender) -> the epoch of its unread chunks
        self.channel = {}  # (sender, receiver) -> what the sender's exchanges sent, in order
        self.received = {}  # (receiver, plan key) -> the exchanges received
        self.released = set()
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
                seq += [(n, "signal", None)]
                if f.remote:
                    seq += [(n, "xsend", None)]
                    seq += [(n, "xrecv", k) for k in range(len(remote_of(f)))]
                    seq += [(n, "copyin", k) for k in range(len(remote_of(f)))]
                seq += [(n, "wait", None)]
                seq += [(n, "copy", q) for q in range(f.nproc) if q != f.me]
                seq += [(n, "release", None)]
            self.ops.append(seq)
        self.next = [0] * len(programs)
        self.first = [{n: k for k, (n, op, _) in reversed(list(enumerate(seq)))}
                      for seq in self.ops]

    def release(self, p):
        """Process ``p``'s ``release_waits``: every ready word of its slabs
        far past any count, and its exchanges aborted (they pass with what
        their receive memory holds)."""
        self.released.add(p)
        for _, f, _, _ in self.programs[p]:
            array, index = self.mem.at(f.ctl)
            for q in range(f.nproc):
                array[index + READY + q] = rt.READY_RELEASED

    def epoch(self, f, uses):
        array, index = self.mem.at(f.ctl)
        return int(array[index + EPOCH]) if self.epoch_on_card else uses

    def runnable(self, p):
        if self.next[p] == len(self.ops[p]):
            return False
        n, op, arg = self.ops[p][self.next[p]]
        f = self.programs[p][n][1]
        if op == "xrecv":
            q = remote_of(f)[arg]
            return p in self.released or bool(self.channel.get((q, p)))
        if op != "wait":
            return True
        array, index = self.mem.at(f.ctl)
        return all(array[index + READY + q] >= 1 for q in range(f.nproc)
                   if q != f.me and q not in remote_of(f))

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
            if q in remote_of(f):  # this process's own staging for q
                extra = buf * f.buf_bytes
            elif q != f.me:
                key = (self.remote_ctl(f, q), buf, f.me)
                assert self.released or self.pending.get(key) is None, (
                    f"process {f.me} wrote flip {e} into process {q}'s buffer {buf} before "
                    f"that process read flip {self.pending.get(key)} from it")
                self.pending[key] = e
                extra = buf * f.buf_bytes
            for sw, tw, ow in zip(src[mine], t[mine], off[mine]):
                self.move(f.inp + int(sw) * f.word, f.dst[tw] + extra + int(ow) * f.word, f.word)
        elif op == "signal":
            for q in range(f.nproc):
                if q != f.me:
                    array, index = self.mem.at(f.ready_peer[q])
                    array[index] += 1
        elif op == "xsend":
            plan = plan_of(f)
            word = self.mem.raw(plan.epoch, 4)
            word[:] = np.frombuffer(np.int32(e).tobytes(), np.uint8)  # the epoch's copy
            start = int(word.view(np.int32)[0] & 1) * plan.buf_bytes + plan.base
            for k in range(plan.npeer):
                runs = [self.mem.raw(plan.send[k] + start + i0 * plan.stride0 + i1 * plan.stride1
                                     + i2 * plan.stride2, plan.run_bytes).copy()
                        for i0 in range(plan.count0) for i1 in range(plan.count1)
                        for i2 in range(plan.count2)]
                wire = np.concatenate(runs)
                assert wire.size == plan.wire_bytes
                self.channel.setdefault((f.me, plan.peer[k]), []).append((plan.key, wire))
        elif op == "xrecv":
            plan = plan_of(f)
            q = plan.peer[arg]
            assert q == remote_of(f)[arg]
            queue = self.channel.get((q, f.me))
            if queue:  # else released: the exchange passes with what is there
                key, wire = queue.pop(0)
                assert key == plan.key, f"process {f.me} got another flip's chunks from {q}"
                self.mem.raw(plan.recv[arg], plan.wire_bytes)[:] = wire
        elif op == "copyin":
            q = remote_of(f)[arg]
            offs, wire = self.copy_in(f, nv)
            key = (f.ctl, buf, q)
            assert p in self.released or self.pending.get(key) is None, (
                f"process {f.me} copied flip {e} of process {q} into its buffer {buf} before "
                f"it read flip {self.pending.get(key)} from it")
            self.pending[key] = e
            recv = f.recv + arg * wire * f.word
            for g, ow in enumerate(offs[arg]):
                self.move(recv + g * f.word, f.slab + buf * f.buf_bytes + int(ow) * f.word,
                          f.word)
        elif op == "wait":
            pass  # runnable() held it until every peer's semaphore was >= 1
        elif op == "copy":
            _, (coff, sproc) = self.offsets(f, nv)
            key = (f.ctl, buf, arg)
            # after a release the reads are stale: the caller discards them
            assert p in self.released or self.pending.get(key) == e, (
                f"process {f.me} read flip {e} from its buffer {buf}, which holds process "
                f"{arg}'s flip {self.pending.get(key)}")
            self.pending[key] = None
            for ow in coff[sproc == arg]:
                ow = int(ow) * f.word
                self.move(f.slab + buf * f.buf_bytes + ow, f.out + ow, f.word)
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

    def copy_in(self, f, nv):
        key = ("in", id(f))
        if key not in self.cache:
            self.cache[key] = copy_in_offsets(f, nv)
        return self.cache[key]

    def remote_ctl(self, f, q):
        """Process ``q``'s control words as mapped here (its semaphore of
        this process sits ``4 * me`` bytes in)."""
        return f.ready_peer[q] - 4 * f.me

    def move(self, src, dst, nbytes):
        self.mem.raw(dst, nbytes)[:] = self.mem.raw(src, nbytes)

    def run(self, choose, on_start, on_done, on_stuck=None):
        """Run every program to its end, ``choose(k)`` picking which of
        ``k`` runnable processes takes the next op; a state where none can
        run before all are done is a deadlock, unless ``on_stuck(model)``
        (a release) lets one run on."""
        while any(nx < len(ops) for nx, ops in zip(self.next, self.ops)):
            ready = [p for p in range(len(self.programs)) if self.runnable(p)]
            if not ready and on_stuck is not None:
                on_stuck(self)
                ready = [p for p in range(len(self.programs)) if self.runnable(p)]
            assert ready, f"deadlock: every process waits ({self.next})"
            self.step(ready[choose(len(ready))], on_start, on_done)


KEYS = (True, False)  # the direction of slab key 0 (x -> y) and key 1 (y -> x)


def two_hosts(nproc):
    """The first half of ``nproc`` processes on one host, the rest on another."""
    return [f"host{2 * q // nproc}" for q in range(nproc)]


def build(monkeypatch, nproc, nlocal, members, c, w, graph, replays, hosts=None):
    """The cluster, its programs (``graph`` of slab keys, captured once and
    replayed ``replays`` times) and the per-flip checks: every input is
    rewritten at its flip's start, every output held against the plain
    ring's at its flip's end."""
    cl = Cluster(monkeypatch, nproc, nlocal, hosts)
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


@pytest.mark.parametrize("nproc", [2, 3, 4])
@settings(max_examples=15, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_every_schedule_across_two_hosts_ends_with_the_plain_flip(monkeypatch, nproc, data):
    """Processes declared on two hosts: any interleaving of their ops, the
    exchanges' included, over a replayed graph of at least six flips of
    two slab keys: no deadlock (no front-end wait for an other-host peer;
    the exchange ordered in the stream before the copy-in and the wait),
    no buffer written before its owner read its last flip, every output
    the plain flip's."""
    nlocal = data.draw(st.sampled_from([1, 2]), label="ranks a process")
    members = data.draw(st.sampled_from([1, 2]), label="members")
    c, w = data.draw(st.integers(1, 2), label="c"), data.draw(st.integers(1, 3), label="w")
    graph = data.draw(st.lists(st.sampled_from([0, 1]), min_size=6, max_size=8), label="graph")
    replays = data.draw(st.integers(1, 2), label="replays")
    cl, prog, on_start, on_done, done = build(monkeypatch, nproc, nlocal, members, c, w, graph,
                                              replays, two_hosts(nproc))
    assert all(f.parts == rt.PUSH_ALL and f.remote for p in prog for _, f, _, _ in p)
    seed = data.draw(st.integers(0, 2**32 - 1), label="schedule")
    rng = np.random.default_rng(seed)
    model = Model(cl.mem, prog)
    model.run(lambda k: int(rng.integers(k)), on_start, on_done)
    assert len(done) == nproc * replays * len(graph)
    assert not any(model.channel.values())  # every run sent was received


def greedy(k):
    return 0  # the lowest-numbered runnable process runs as far ahead as it can


@pytest.mark.parametrize("nproc", [2, 4])
def test_a_release_mid_exchange_lets_the_survivor_run_on(monkeypatch, nproc):
    """The last process is lost in the middle of its third flip, after its
    push and before its exchange: every other process stalls (in the
    exchange, or in the front-end wait for a same-host peer that stalled
    there), which the model reports as the deadlock a peer's loss is.  A
    release of the stalled processes (``release_waits``: their exchanges
    aborted, their semaphores far past any count) lets each run every
    flip of its program to its end on stale chunks, which the caller
    discards."""
    graph = [0, 1, 0, 0, 1, 0]
    cl, prog, on_start, _, _ = build(monkeypatch, nproc, 1, 1, 2, 2, graph, 2,
                                     two_hosts(nproc))
    model = Model(cl.mem, prog)
    lost = nproc - 1
    cut = [k for k, (n, op, _) in enumerate(model.ops[lost]) if n == 2 and op == "xsend"][0]
    model.ops[lost] = model.ops[lost][:cut]
    with pytest.raises(AssertionError, match="deadlock"):
        model.run(greedy, on_start, lambda *a: None)
    cl, prog, on_start, _, _ = build(monkeypatch, nproc, 1, 1, 2, 2, graph, 2,
                                     two_hosts(nproc))
    model = Model(cl.mem, prog)
    model.ops[lost] = model.ops[lost][:cut]
    finished = []
    stuck = []

    def release(m):
        stuck.append(list(m.next))
        for p in range(nproc - 1):
            m.release(p)

    model.run(greedy, on_start, lambda p, flip, out: finished.append(p), release)
    assert len(stuck) == 1
    for p in range(nproc - 1):
        assert finished.count(p) == len(prog[p]), (p, finished)


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
                 "PUSH_EXCHANGE", "PUSH_COPY_IN", "PUSH_ALL"):
        assert int(re.search(rf"\b{name} = (\d+)", SOURCE).group(1)) == getattr(rt, name), name
    assert int(re.search(r"#define RT_CTL_BYTES (\d+)", SOURCE).group(1)) == \
        _build.SLAB_CTL_BYTES
    assert "CTL_EPOCH = RT_MAX_PROCS," in SOURCE
    assert rt.PUSH_ALL == rt.PUSH_DATA | rt.PUSH_SIGNAL | rt.PUSH_WAIT | rt.PUSH_COPY | \
        rt.PUSH_RELEASE | rt.PUSH_EXCHANGE | rt.PUSH_COPY_IN
    assert "tests/test_torch_remote_protocol.py" in SOURCE


def test_parameter_block_of_a_flip_across_hosts(monkeypatch):
    """Process 1 of 4 x 1 over two hosts (0 and 1 on one, 2 and 3 on the
    other): the same-host peer's rank goes to its mapped slab, the
    other-host peers' ranks to this process's pinned staging for each; an
    other-host peer's semaphore is this process's own word for it; the
    exchange's function, plan, epoch word and received chunks are set,
    and the plan sends this process's runs (the second rank's column of
    each row) to processes 2 and 3."""
    cl = Cluster(monkeypatch, 4, 1, two_hosts(4))
    x = torch.zeros((1, 4 * 3, 5), dtype=torch.float64)
    for me in (0, 2, 3):
        cl.capture(me, x, True)
    f, out = cl.capture(1, x, True)
    data = -(-3 * 20 * 8 // rt.SLAB_ALIGN) * rt.SLAB_ALIGN
    mine, peer0 = cl.slab_addr(1, 0), cl.slab_addr(0, 0)
    stage2, stage3, recv = (HOST_BASE + (1 << 36) + (k << 28) for k in range(3))
    assert [f.dst[t] for t in range(4)] == [peer0, out.data_ptr(), stage2, stage3]
    assert f.ready_peer[0] == peer0 + 2 * data + 4 * 1
    assert [f.ready_peer[q] for q in (2, 3)] == [mine + 2 * data + 4 * 2, mine + 2 * data + 4 * 3]
    assert f.remote == 0b1100 and f.hx_fn == 0xE1
    assert (f.hx_epoch, f.recv) == (recv, recv + rt.RECV_HEAD)
    plan = plan_of(f)
    assert [plan.peer[k] for k in range(plan.npeer)] == [2, 3]
    assert [plan.send[k] for k in range(2)] == [stage2, stage3]
    assert [plan.recv[k] for k in range(2)] == [recv + rt.RECV_HEAD,
                                                recv + rt.RECV_HEAD + 3 * 5 * 8]
    assert (plan.count0, plan.count1, plan.count2) == (1, 1, 3)
    assert (plan.run_bytes, plan.base, plan.stride2, plan.buf_bytes) == (5 * 8, 5 * 8, 20 * 8,
                                                                         data)
    assert plan.key == hx.slab_key(out.shape, torch.float64, True)

"""The remote flip's exchange across hosts, as Python sees it.

A mesh whose ranks span processes on several hosts moves the chunks for a
process on another host through pinned host memory and one TCP connection
between every two such processes (:class:`..ops.ring_transpose.SpanningRing`;
the exchange itself is C++, ``csrc/host_exchange.cpp``, built by
:mod:`._build` at first use, with ``nvcc`` on the card and the system C++
compiler elsewhere).  This module makes the connections of a mesh
(:func:`connect`, once a mesh, outside any capture: every process listens
on the interface that reaches the coordinator and swaps its port through
:func:`..parallel.multihost.allgather_bytes`), describes one (shape, dtype,
direction) of flip to the exchange (:func:`layout`, :func:`make_plan`) and
runs it on the CPU (:func:`run`); on the card a flip's stream runs it as a
host function (:func:`exchange_address`).
"""

from __future__ import annotations

import ctypes
import socket
import struct
import zlib
from dataclasses import dataclass

from . import _build

#: processes one exchange reaches (``HX_MAX_PEERS``, the remote flip's
#: ``PUSH_MAX_PROCS``)
MAX_PEERS = _build.PUSH_MAX_PROCS


class HxPlan(ctypes.Structure):
    """Mirror of ``struct HxPlan`` in ``csrc/host_exchange.cpp``: the links,
    the epoch's word, each other-host peer's staging buffer 0 (this
    process's runs for it) and where its runs land, the runs' pattern,
    the bytes each way, the exchanges made, the peers' processes and the
    slab's key."""

    _fields_ = [
        ("links", ctypes.c_void_p),
        ("epoch", ctypes.c_void_p),
        ("send", ctypes.c_void_p * MAX_PEERS),
        ("recv", ctypes.c_void_p * MAX_PEERS),
        ("buf_bytes", ctypes.c_longlong),
        ("base", ctypes.c_longlong),
        ("run_bytes", ctypes.c_longlong),
        ("stride0", ctypes.c_longlong),
        ("stride1", ctypes.c_longlong),
        ("stride2", ctypes.c_longlong),
        ("wire_bytes", ctypes.c_longlong),
        ("seq", ctypes.c_longlong),
        ("count0", ctypes.c_int),
        ("count1", ctypes.c_int),
        ("count2", ctypes.c_int),
        ("npeer", ctypes.c_int),
        ("peer", ctypes.c_int * MAX_PEERS),
        ("key", ctypes.c_int),
    ]


@dataclass(frozen=True)
class Layout:
    """The runs one process sends each other-host peer in a flip to the
    output pencil ``shape`` (``([K,] PL, a, b)``): along ``counts`` (member,
    destination rank, row) at ``strides`` bytes of a staging buffer laid
    out as the peer's receive slab, each ``run_bytes``, the first at
    ``rank0 * base_per_rank`` bytes for the sender of first rank ``rank0``;
    ``wire_bytes`` each way; ``buf_bytes`` the output's bytes (a card's
    staging buffer is a receive slab's, rounded up).  x -> y sends a run a
    row of each destination rank's block (``PL * w`` elements), y -> x a
    run a block (``PL * c`` rows of ``w``)."""

    counts: tuple
    strides: tuple
    run_bytes: int
    base_per_rank: int
    wire_bytes: int
    buf_bytes: int


def layout(shape, x_to_y: bool, nranks: int, elem: int) -> Layout:
    """The :class:`Layout` of a flip to the output pencil ``shape`` of a
    mesh of ``nranks`` ranks, ``elem`` bytes an element."""
    *lead, pl, a, b = (int(s) for s in shape)
    k = lead[0] if lead else 1
    blk, dsm = a * b, pl * a * b
    if x_to_y:
        c, w = a, b // nranks
        counts, strides = (k, pl, c), (dsm * elem, blk * elem, b * elem)
        run = pl * w * elem
        base = w * elem
    else:
        c, w = a // nranks, b
        counts, strides = (k, pl, 1), (dsm * elem, blk * elem, 0)
        run = pl * c * w * elem
        base = c * w * elem
    return Layout(counts, strides, run, base, k * pl * pl * c * w * elem, k * dsm * elem)


def slab_key(shape, dtype, x_to_y: bool) -> int:
    """A slab's key on the wire: the same on every process for the same
    flip, so a header from another flip fails the exchange."""
    return zlib.crc32(repr((tuple(int(s) for s in shape), str(dtype), bool(x_to_y))).encode()) \
        & 0x7FFFFFFF


def make_plan(links, lay: Layout, key: int, rank0: int, peers, send, recv, epoch,
              buf_bytes: int) -> HxPlan:
    """The plan of one flip's exchange: ``peers`` the other-host processes,
    ``send[k]`` peer k's staging buffer 0 and ``recv[k]`` where its runs
    land (host addresses), ``epoch`` the int32 word naming the staging
    buffer, ``buf_bytes`` from a staging buffer 0 to its buffer 1; this
    process's runs start at ``rank0`` (its first rank)."""
    if not 1 <= len(peers) <= MAX_PEERS:
        raise ValueError(f"an exchange reaches 1..{MAX_PEERS} peers, got {len(peers)}")
    if buf_bytes < lay.buf_bytes:
        raise ValueError(f"a staging buffer of {buf_bytes} bytes, the output needs "
                         f"{lay.buf_bytes}")
    p = HxPlan()
    p.links, p.epoch, p.key = links.handle, int(epoch), int(key)
    p.buf_bytes, p.base = int(buf_bytes), rank0 * lay.base_per_rank
    p.run_bytes, p.wire_bytes = lay.run_bytes, lay.wire_bytes
    p.stride0, p.stride1, p.stride2 = lay.strides
    p.count0, p.count1, p.count2 = lay.counts
    p.npeer = len(peers)
    for i, (q, s, r) in enumerate(zip(peers, send, recv)):
        p.peer[i], p.send[i], p.recv[i] = int(q), int(s), int(r)
    return p


def _lib():
    return _build.load("host_exchange")


def exchange_address() -> int:
    """The address of the exchange's host function (``hx_exchange``), which
    a flip's stream launches with its plan."""
    return ctypes.cast(_lib().hx_exchange, ctypes.c_void_p).value


class Links:
    """The connections of one mesh's processes to their other-host peers
    (the C side's links, ``handle``): :meth:`failure` reads a failed or
    released exchange, :meth:`abort` releases a stalled one and fails every
    later one, :meth:`close` closes the sockets."""

    def __init__(self, handle: int):
        self.handle = handle

    def failure(self) -> str | None:
        """None while no exchange failed, else what happened."""
        if self.handle is None:
            return None
        buf = ctypes.create_string_buffer(256)
        code = _lib().hx_error(self.handle, buf, len(buf))
        return (buf.value.decode(errors="replace") or f"code {code}") if code else None

    def abort(self) -> None:
        if self.handle is not None:
            _lib().hx_abort(self.handle)

    def close(self) -> None:
        if self.handle is not None:
            _lib().hx_close(self.handle)
            self.handle = None


def _recv_exact(s, n: int) -> bytes:
    out = b""
    while len(out) < n:
        part = s.recv(n - len(out))
        if not part:
            raise ConnectionError("a peer closed its connection while the mesh connected")
        out += part
    return out


def connect(me: int, nproc: int, remote) -> Links:
    """Connect this process to each of its other-host peers ``remote``
    (collective: every process of the group calls it together).  Each
    process listens on the address :func:`..parallel.multihost.process_address`
    recorded for it, the ports go round in one allgather, each process
    connects to the lower of its peers and takes the connections of the
    higher ones (a connection is queued by the listener's backlog before it
    is taken, so no order of arrival deadlocks)."""
    from ..parallel import multihost

    timeout = multihost.EXCHANGE_TIMEOUT_S.value
    remote = sorted(int(q) for q in remote)
    addr = multihost.process_address(me)
    family = socket.AF_INET6 if ":" in addr else socket.AF_INET
    socks: dict = {}
    with socket.socket(family, socket.SOCK_STREAM) as listener:
        listener.bind((addr, 0))
        listener.listen(max(1, nproc))
        listener.settimeout(timeout)
        ports = [int(b) for b in multihost.allgather_bytes(str(listener.getsockname()[1]).encode())]
        try:
            for q in remote:
                if q < me:
                    s = socket.create_connection((multihost.process_address(q), ports[q]),
                                                 timeout=timeout)
                    socks[q] = s
                    s.sendall(struct.pack("<ii", me, nproc))
            while len(socks) < len(remote):
                s, _ = listener.accept()
                s.settimeout(timeout)
                q, n = struct.unpack("<ii", _recv_exact(s, 8))
                if q not in remote or q <= me or q in socks or n != nproc:
                    s.close()
                    raise RuntimeError(f"process {me} took a connection from process {q} of "
                                       f"{n}, not one of its other-host peers {remote}")
                socks[q] = s
        except BaseException:
            for s in socks.values():
                s.close()
            raise
    fds = (ctypes.c_int * nproc)(*[socks[q].detach() if q in socks else -1 for q in range(nproc)])
    handle = _lib().hx_open(nproc, me, fds, ctypes.addressof(multihost.EXCHANGE_TIMEOUT_S))
    if not handle:
        raise RuntimeError(f"hx_open refused the links of process {me} of {nproc}")
    return Links(handle)


def run(plan: HxPlan) -> int:
    """One exchange of ``plan`` on the calling thread (the CPU path; the
    card runs it as a host function): 0, or the failure's code."""
    return _lib().hx_run(ctypes.byref(plan))

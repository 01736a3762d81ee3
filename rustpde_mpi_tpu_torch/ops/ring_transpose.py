"""The x <-> y pencil transpose of a rank-stacked field, on a CUDA kernel.

Counterpart of the JAX package's ``parallel/decomp.py``
``_ring_transpose_kernel`` (the Pallas TPU kernel) and of its off-TPU form
``_ring_transpose_ppermute``.  A mesh of ``P`` ranks on one device holds a
field as one tensor with the rank as its leading dimension
(:mod:`..parallel.mesh`):

* x-pencil ``(P, P*c, w)``: rank ``s`` holds columns ``s*w ..`` of the
  padded ``(P*c, P*w)`` field;
* y-pencil ``(P, c, P*w)``: rank ``r`` holds rows ``r*c ..``;

and the flip is ``y[r, i, s*w + j] = x[s, r*c + i, j]`` (x -> y) or its
inverse.  A pencil may carry a leading member dim, ``(K, P, ...)``: the
pencils of an ensemble's K members, all flipped by one launch (the JAX
package's ``jax.vmap`` of the flip).  On a CUDA tensor :meth:`RingTranspose.apply` launches the
hand-written kernel of ``csrc/ring_transpose.cu`` once and adds one to
``RingTranspose.launches``; on a CPU tensor it runs
:meth:`RingTranspose.plain`, the ring schedule of the JAX package in torch
indexing: the diagonal copy, then P-1 shift steps in which every rank sends
the chunk meant for the rank ``shift`` ahead.  Any other device raises.

The flip is a permutation, so its adjoint is the inverse flip: autograd
sees it as :class:`FlipFn`, whose backward is the same call with the
direction reversed (one more launch on the card, ``backward_launches``).

The kernel moves the launch's elements as one flat range in words of 16, 8
or 4 bytes (:func:`word_bytes`, the widest the row width, the strides and
the base pointers allow) and splits a flat index into its row and column,
and a row into its chunk and row in the chunk, by a multiply-high with the
magic constants of :func:`fast_divmod`, computed here for each launch.

A mesh whose ranks span processes (:class:`SpanningRing`) flips through the
kernel's remote form, ``rp_ring_push_*``: each process holds ``P / nproc``
consecutive ranks, writes its own ranks' chunks straight into its output
and pushes the peers' into their receive slabs (two buffers each, which
every peer mapped through CUDA IPC), from which each process copies them
out; completion rides semaphores in the slabs (the TPU kernel's send and
receive semaphores), waited on in the card's front end between the push
launch and the copy-out launch.  On the CPU the same flip is an
all-to-all through ``torch.distributed`` on gloo.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build

#: the kernel's entry point for each dtype it moves: a complex element (a
#: periodic cell's spectral pencil) is the unit of the permutation
ENTRY = {torch.float64: "rp_ring_transpose_f64", torch.float32: "rp_ring_transpose_f32",
         torch.complex128: "rp_ring_transpose_c128", torch.complex64: "rp_ring_transpose_c64"}
#: the remote form's entry point for each dtype (a spanning mesh)
PUSH_ENTRY = {torch.float64: "rp_ring_push_f64", torch.float32: "rp_ring_push_f32",
              torch.complex128: "rp_ring_push_c128", torch.complex64: "rp_ring_push_c64"}


@lru_cache(maxsize=None)
def fast_divmod(d: int) -> tuple[int, int]:
    """The magic pair ``(mul, shr)`` of the divisor ``d`` (CUTLASS's
    ``FastDivmod``): ``n // d == (n * mul) >> (32 + shr)`` for every ``0 <=
    n < 2**31``, ``mul`` a 32-bit unsigned; ``(0, 0)`` for ``d == 1``, which
    the kernel passes through undivided."""
    if not 1 <= d < 2**31:
        raise ValueError(f"fast_divmod: divisor {d} out of range")
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()  # 31 + ceil(log2 d)
    return -(-(1 << p) // d), p - 32


def word_bytes(itemsize: int, w: int, strides, pointers) -> int:
    """The copy width of a launch: the widest word of 16, 8 or 4 bytes, at
    least one element, that divides the row's ``w`` elements, every element
    stride in ``strides`` and both base ``pointers`` (bytes)."""
    for word in (16, 8, 4):
        if word < itemsize:
            break
        nv = word // itemsize
        if w % nv == 0 and all(st % nv == 0 for st in strides) and \
                all(ptr % word == 0 for ptr in pointers):
            return word
    return itemsize


def pencil_strides(t) -> tuple[int, int]:
    """The rank and row strides of a pencil ``([K,] P, rows, cols)`` as the
    kernel reads them: a dim of extent 1 (one rank, one row) gets the
    stride a dense one would have, since the kernel never steps along it
    and PyTorch leaves its stride arbitrary (a ``.contiguous()`` tensor
    keeps whatever stride its view had there)."""
    row = t.stride(-2) if t.shape[-2] > 1 else t.shape[-1]
    rank = t.stride(-3) if t.shape[-3] > 1 else t.shape[-2] * row
    return rank, row


def transposed_shape(shape, nranks: int, x_to_y: bool) -> tuple:
    """The pencil shape a flip of a ``shape`` pencil (a member dim, if any,
    in front) gives."""
    *lead, p, a, b = shape
    if x_to_y:
        return (*lead, p, a // nranks, b * nranks)
    return (*lead, p, a * nranks, b // nranks)


class RingTranspose:
    """The pencil flip of one mesh: ``nranks`` ranks on ``device``, any
    pencil extents, float64, float32, complex128 or complex64."""

    def __init__(self, nranks: int, device):
        self.nranks = int(nranks)
        self.device = torch.device(device)
        #: kernel launches on CUDA tensors, forward and backward flips alike
        self.launches = 0
        #: of those, the launches of backward passes (:class:`FlipFn`)
        self.backward_launches = 0

    def _check(self, block, x_to_y: bool) -> None:
        if block.device != self.device:
            raise ValueError(f"pencil transpose input on {block.device}, the mesh is on "
                             f"{self.device}")
        if block.dtype not in ENTRY:
            raise ValueError(f"pencil transpose input of dtype {block.dtype}: the kernel moves "
                             f"{', '.join(map(str, ENTRY))}")
        split = -2 if x_to_y else -1
        if block.ndim not in (3, 4) or block.shape[-3] != self.nranks or \
                block.shape[split] % self.nranks:
            want = "([K,] P, P*c, w)" if x_to_y else "([K,] P, c, P*w)"
            raise ValueError(f"pencil transpose input: shape {tuple(block.shape)}, expected "
                             f"{want} with P = {self.nranks}")

    def x_to_y(self, block) -> torch.Tensor:
        """x-pencil ``(P, P*c, w)`` -> y-pencil ``(P, c, P*w)``."""
        return self.apply(block, True)

    def y_to_x(self, block) -> torch.Tensor:
        """y-pencil ``(P, c, P*w)`` -> x-pencil ``(P, P*c, w)``."""
        return self.apply(block, False)

    def apply(self, block, x_to_y: bool) -> torch.Tensor:
        """The flip of ``block``: the CUDA kernel on a CUDA device, the
        plain ring on the CPU; differentiable through :class:`FlipFn` (an
        input that needs no gradient records nothing)."""
        return FlipFn.apply(block, self, bool(x_to_y))

    def flip(self, block, x_to_y: bool) -> torch.Tensor:
        """The flip of ``block`` outside autograd."""
        self._check(block, x_to_y)
        if self.device.type == "cpu":
            return self.plain(block, x_to_y)
        if self.device.type != "cuda":
            raise RuntimeError(f"no pencil-transpose kernel for device {self.device}")
        out = self._launch(block, x_to_y)
        self.launches += 1
        return out

    def plain(self, block, x_to_y: bool) -> torch.Tensor:
        """The ring in plain PyTorch: at shift ``t`` (0 the diagonal copy)
        every rank ``d`` sends its chunk for rank ``(d + t) % P``, which
        stores it at slot ``d`` (every member's chunk at once).  Every
        element of the output is written once, so it starts empty."""
        p = self.nranks
        out = torch.empty(transposed_shape(block.shape, p, x_to_y), device=block.device,
                          dtype=block.dtype)
        k = block.shape[0] if block.ndim == 4 else 1
        # xv[s, r] is chunk (s, r) in the x layout, yv[r, :, s] in the y
        # layout, each with the members behind the rank indices
        if x_to_y:
            c, w = block.shape[-2] // p, block.shape[-1]
            xv, yv = block.reshape(k, p, p, c, w), out.view(k, p, c, p, w)
        else:
            c, w = block.shape[-2], block.shape[-1] // p
            xv, yv = out.view(k, p, p, c, w), block.reshape(k, p, c, p, w)
        xv, yv = xv.permute(1, 2, 3, 0, 4), yv.permute(1, 2, 3, 0, 4)  # (P, P, c, K, w)
        ranks = torch.arange(p, device=block.device)
        for shift in range(p):
            peer = (ranks + shift) % p
            if x_to_y:
                yv[peer, :, ranks] = xv[ranks, peer]
            else:
                xv[peer, ranks] = yv[ranks, :, peer]
        return out

    def bytes_moved(self, block) -> float:
        """Bytes a flip of ``block`` must move: read once, written once."""
        return 2.0 * block.numel() * block.element_size()

    def _launch(self, block, x_to_y: bool) -> torch.Tensor:
        if block.stride(-1) != 1:
            raise ValueError("the pencil-transpose kernel needs a unit stride along the "
                             "last axis")
        lib = _build.load("ring_transpose")
        fn = getattr(lib, ENTRY[block.dtype])
        p = self.nranks
        out = torch.empty(transposed_shape(block.shape, p, x_to_y), device=block.device,
                          dtype=block.dtype)
        xp, yp = (block, out) if x_to_y else (out, block)
        c, w = yp.shape[-2], xp.shape[-1]
        k = block.shape[0] if block.ndim == 4 else 1
        ms = (xp.stride(0), yp.stride(0)) if block.ndim == 4 and k > 1 else (0, 0)
        strides = pencil_strides(xp) + pencil_strides(yp)
        word = word_bytes(block.element_size(), w, strides + ms,
                          (block.data_ptr(), out.data_ptr()))
        divs = fast_divmod(w // (word // block.element_size())) + fast_divmod(c)
        _build.call(fn, self.device, p, c, w, *strides, block.data_ptr(), out.data_ptr(),
                    int(x_to_y), k, *ms, word, *divs)
        return out


#: bytes a receive slab's buffer is rounded up to (two buffers, then the
#: control words)
SLAB_ALIGN = 256
#: the parts of a remote flip (``RpPush.parts``, ``csrc/ring_transpose.cu``
#: ``PUSH_*``): the push, its signal to the peers, the wait for theirs, the
#: copy-out of their chunks and the release; a flip issues them all
PUSH_DATA, PUSH_SIGNAL, PUSH_WAIT, PUSH_COPY, PUSH_RELEASE = 1, 2, 4, 8, 16
PUSH_ALL = 31


class _Slab:
    """One receive slab of a spanning mesh: this process's allocation
    (``ptr``: two buffers of ``data_bytes``, then the control words) and
    every process's as mapped here (``peers[q]``; this process's own pointer
    at ``me``), with the push's parameter block filled in but for the
    input, the output, this process's ranks' blocks of it and the launch's
    word (:meth:`SpanningRing._push`)."""

    def __init__(self, ptr: int, peers: list, data_bytes: int, params):
        self.ptr, self.peers, self.data_bytes, self.params = ptr, peers, data_bytes, params


class SpanningRing(RingTranspose):
    """The pencil flip of a mesh whose ``nranks`` ranks span ``nproc``
    processes of one host, each holding ``nranks / nproc`` consecutive
    ranks (this process, ``me``, the ranks from ``rank0``) stacked on its
    own ``device``.  A pencil here is this process's ranks'
    ``([K,] P / nproc, ...)``; its flip gives this process's ranks' blocks
    of the flipped pencil.

    On a CUDA device :meth:`flip` launches the remote form of the kernel
    (``rp_ring_push_*``): the chunks for this process's ranks go straight
    into a fresh output, the peers' ranks' chunks into their receive slabs,
    from which each process copies them into its output, so flipped
    pencils never alias each other.  The slabs are allocated in the
    extension (an IPC handle names a whole ``cudaMalloc`` allocation) at a
    shape's first flip, one per (shape, dtype, direction), two buffers each
    (a flip writes the buffer its epoch names, counted on the card), and
    their handles swapped once through
    :func:`..parallel.multihost.allgather_bytes`: a host collective, so the
    first flip of a shape runs outside a CUDA-graph capture (a chunk
    runner's warm-up step makes it).  A flip is two launches, the push and
    the copy-out, with the waits for the peers' pushes between them in the
    card's front end, so no kernel spins where processes share a card.
    Every process issues the same flips in the same order.  On the CPU :meth:`plain` is the same flip
    through ``torch.distributed.all_to_all_single`` on gloo (also on a CUDA
    tensor, through the host: the kernel's yardstick).

    :attr:`gather` is the mesh's reduction partner: each rank's few values
    to every rank, through the same push and flags."""

    def __init__(self, nranks: int, device, nproc: int, me: int):
        super().__init__(nranks, device)
        if nproc < 1 or self.nranks % nproc or not 0 <= me < nproc:
            raise ValueError(f"a spanning mesh of {nranks} ranks over {nproc} processes "
                             f"(process {me})")
        self.nproc, self.me = int(nproc), int(me)
        self.nlocal = self.nranks // self.nproc
        self.rank0 = self.me * self.nlocal
        self._slabs: dict = {}
        #: each rank's values to every rank (:class:`RankGather`)
        self.gather = RankGather(self)

    def _check(self, block, x_to_y: bool) -> None:
        if block.device != self.device:
            raise ValueError(f"pencil transpose input on {block.device}, the mesh is on "
                             f"{self.device}")
        if block.dtype not in PUSH_ENTRY:
            raise ValueError(f"pencil transpose input of dtype {block.dtype}: the kernel moves "
                             f"{', '.join(map(str, PUSH_ENTRY))}")
        split = -2 if x_to_y else -1
        if block.ndim not in (3, 4) or block.shape[-3] != self.nlocal or \
                block.shape[split] % self.nranks:
            want = "([K,] PL, P*c, w)" if x_to_y else "([K,] PL, c, P*w)"
            raise ValueError(f"pencil transpose input: shape {tuple(block.shape)}, expected "
                             f"{want} with P = {self.nranks}, PL = {self.nlocal}")

    def flip(self, block, x_to_y: bool) -> torch.Tensor:
        """The flip of this process's pencils outside autograd: the remote
        kernel on a CUDA device, the gloo all-to-all on the CPU."""
        self._check(block, x_to_y)
        if self.device.type == "cpu":
            return self.plain(block, x_to_y)
        if self.device.type != "cuda":
            raise RuntimeError(f"no pencil-transpose kernel for device {self.device}")
        out = self._push(block, x_to_y)
        self.launches += 1
        return out

    def plain(self, block, x_to_y: bool) -> torch.Tensor:
        """The flip in plain PyTorch: one ``all_to_all_single`` on gloo of
        each process's chunks for each process's ranks, through the host
        (every process calls it together).  ``send[q, m, lr, lt]`` is local
        rank ``lr``'s chunk for rank ``q * PL + lt``."""
        import torch.distributed as dist

        p, pl, n = self.nranks, self.nlocal, self.nproc
        x = block.detach().to("cpu")
        k = x.shape[0] if x.ndim == 4 else 1
        if x_to_y:
            c, w = x.shape[-2] // p, x.shape[-1]
            send = x.reshape(k, pl, n, pl, c, w).permute(2, 0, 1, 3, 4, 5)
        else:
            c, w = x.shape[-2], x.shape[-1] // p
            send = x.reshape(k, pl, c, n, pl, w).permute(3, 0, 1, 4, 2, 5)
        send = send.contiguous()
        recv = torch.empty_like(send)
        if n > 1:
            real = torch.view_as_real if send.is_complex() else (lambda t: t)
            dist.all_to_all_single(real(recv), real(send))
        else:
            recv.copy_(send)
        # recv[q, m, lq, lt]: global rank q * PL + lq's chunk for local rank lt
        if x_to_y:
            out = recv.permute(1, 3, 4, 0, 2, 5).reshape(k, pl, c, p * w)
        else:
            out = recv.permute(1, 3, 0, 2, 4, 5).reshape(k, pl, p * c, w)
        return (out if block.ndim == 4 else out[0]).to(block.device)

    def bytes_moved(self, block) -> float:
        """Bytes a flip of ``block`` must move: its input read once, its
        output written once (the peers' chunks' pass through the slabs is
        the design's, not the flip's)."""
        return 2.0 * block.numel() * block.element_size()

    def _slab(self, shape, dtype, x_to_y: bool) -> _Slab:
        """The receive slab of flips to ``shape``, registered at the first
        one (collective: every process registers the same slabs in the
        same order)."""
        key = (tuple(shape), dtype, bool(x_to_y))
        slab = self._slabs.get(key)
        if slab is None:
            slab = self._slabs[key] = self._register(shape, dtype, x_to_y)
        return slab

    def _register(self, shape, dtype, x_to_y: bool) -> _Slab:
        from ..parallel import multihost

        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"a first flip to {tuple(shape)} {dtype} inside a CUDA-graph "
                               "capture: a slab is registered by a host collective, so a "
                               "shape's first flip runs before the capture")
        if self.nproc > _build.PUSH_MAX_PROCS or self.nranks > _build.PUSH_MAX_RANKS:
            raise ValueError(f"the remote flip reaches {_build.PUSH_MAX_RANKS} ranks in "
                             f"{_build.PUSH_MAX_PROCS} processes, the mesh has "
                             f"{self.nranks} in {self.nproc}")
        lib = _build.load("ring_transpose")
        elem = torch.empty(0, dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= int(s)
        data = -(-numel * elem // SLAB_ALIGN) * SLAB_ALIGN
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(_build.IPC_HANDLE_BYTES)
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            _build.check(lib.rp_slab_alloc(data, ctypes.byref(ptr), handle), "rp_slab_alloc")
            handles = multihost.allgather_bytes(handle.raw)
            peers = []
            for q, h in enumerate(handles):
                if q == self.me:
                    peers.append(ptr.value)
                    continue
                mapped = ctypes.c_void_p()
                rc = lib.rp_ipc_open(h, ctypes.byref(mapped))
                if rc:
                    raise RuntimeError(
                        f"cudaIpcOpenMemHandle of process {q}'s receive slab failed on "
                        f"{self.device} (CUDA error {rc}): the spanning mesh cannot map its "
                        "peers (the other route, cuMemCreate with a POSIX fd handle passed "
                        "over a Unix socket, is not ported)")
                peers.append(mapped.value)
        f = _build.RpPush()
        f.slab, f.buf_bytes, f.ctl = ptr.value, data, ptr.value + 2 * data
        for q in range(self.nproc):
            f.ready_peer[q] = peers[q] + 2 * data + 4 * self.me
        lead, (a, b) = shape[:-2], shape[-2:]
        for t in range(self.nranks):
            q, lt = divmod(t, self.nlocal)
            if q != self.me:
                f.dst[t] = peers[q] + lt * a * b * elem
        f.d1, f.blk, f.dsm = b, a * b, self.nlocal * a * b
        f.P, f.PL, f.g0, f.nproc, f.me = self.nranks, self.nlocal, self.rank0, self.nproc, self.me
        f.x_to_y = int(x_to_y)
        f.members = int(lead[0]) if len(lead) == 2 else 1
        f.mul_p, f.shr_p = fast_divmod(self.nranks)
        f.mul_l, f.shr_l = fast_divmod(self.nlocal)
        f.mul_r, f.shr_r = fast_divmod(self.nranks - self.nlocal)
        return _Slab(ptr.value, peers, data, f)

    def _push(self, block, x_to_y: bool, parts: int = PUSH_ALL) -> torch.Tensor:
        if block.stride(-1) != 1:
            raise ValueError("the pencil-transpose kernel needs a unit stride along the "
                             "last axis")
        shape = transposed_shape(block.shape, self.nranks, x_to_y)
        slab = self._slab(shape, block.dtype, x_to_y)
        lib = _build.load("ring_transpose")
        out = torch.empty(shape, device=block.device, dtype=block.dtype)
        f = slab.params
        p, elem = self.nranks, block.element_size()
        c, w = (block.shape[-2] // p, block.shape[-1]) if x_to_y else \
            (block.shape[-2], block.shape[-1] // p)
        f.is0, f.is1 = pencil_strides(block)
        f.ism = block.stride(0) if block.ndim == 4 and f.members > 1 else 0
        f.inp, f.out = block.data_ptr(), out.data_ptr()
        for lt in range(self.nlocal):
            f.dst[self.rank0 + lt] = out.data_ptr() + lt * f.blk * elem
        f.c, f.w = c, w
        f.word = word_bytes(elem, w, (f.is0, f.is1, f.ism, f.d1, f.dsm, f.blk),
                            [block.data_ptr(), out.data_ptr(), f.slab, f.buf_bytes]
                            + [f.dst[t] for t in range(p)])
        f.mul_w, f.shr_w = fast_divmod(w // (f.word // elem))
        f.mul_c, f.shr_c = fast_divmod(c)
        f.parts = parts
        _build.call(getattr(lib, PUSH_ENTRY[block.dtype]), self.device, ctypes.byref(f))
        return out

    def close(self) -> None:
        """Unmap the peers' slabs and free this process's (collective):
        every process first finishes its flips and reaches a barrier, then
        closes its peers' handles, and frees its own slabs only after a
        second barrier, when no peer maps them any more."""
        from ..parallel import multihost

        if not self._slabs or self.device.type != "cuda":
            self._slabs.clear()
            return
        lib = _build.load("ring_transpose")
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            multihost.sync_hosts("ring_close")
            for slab in self._slabs.values():
                for q, ptr in enumerate(slab.peers):
                    if q != self.me:
                        _build.check(lib.rp_ipc_close(ptr), "rp_ipc_close")
            multihost.sync_hosts("ring_closed")
            for slab in self._slabs.values():
                _build.check(lib.rp_slab_free(slab.ptr), "rp_slab_free")
        self._slabs.clear()

    def release_waits(self) -> None:
        """Let every wait of this process's flips pass, those already in
        the card's front end included: the ready semaphores of every slab
        are set far past any count a peer reaches, from a stream of their
        own (a stream stalled in a wait holds no other).  A flip waits for
        its peers' pushes with no deadline, so a peer that is gone stalls
        this process's stream for good; after this the stalled work runs
        on with stale chunks, and the caller must discard what it computed
        (the resilient runner calls it on a ``DispatchHang``, which the
        serving scheduler turns into a gang loss).  Any thread may call
        it.  On the CPU a flip fails by itself when its peer's connection
        closes: nothing to do."""
        if self.device.type != "cuda":
            return
        side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(side):
            for slab in list(self._slabs.values()):
                words = torch.as_tensor(_ReadyWords(slab.ptr + 2 * slab.data_bytes, self.nproc),
                                        device=self.device)
                words.fill_(READY_RELEASED)
        side.synchronize()


#: the ready count :meth:`SpanningRing.release_waits` leaves: past any
#: count of pushes not yet consumed, and positive as the cyclic comparison
#: of the waits reads it
READY_RELEASED = 1 << 30


class _ReadyWords:
    """A slab's ready semaphores (one 32-bit word a process, at the start
    of its control words) as ``__cuda_array_interface__`` describes them."""

    def __init__(self, ptr: int, nproc: int):
        self.__cuda_array_interface__ = {"shape": (int(nproc),), "typestr": "<i4",
                                         "data": (int(ptr), False), "version": 3,
                                         "strides": None}


class RankGather:
    """A few values of each rank of a spanning mesh to every rank (the
    all-gather under the mesh's sums and maxima, :mod:`..parallel.decomp`):
    ``partials`` ``(PL, k)`` of this process's ranks give ``(P, k)`` in
    rank order on every process.  The values go as an x-pencil whose every
    chunk is the rank's row, through one flip of its ring: the remote
    kernel on the card (a capturable push and its flags, no host
    collective), the gloo all-to-all on the CPU.  ``launches`` counts the
    kernel launches, apart from the ring's flips."""

    def __init__(self, ring: SpanningRing):
        self.ring = ring
        #: kernel launches on CUDA tensors
        self.launches = 0

    def __call__(self, partials: torch.Tensor) -> torch.Tensor:
        ring = self.ring
        pl = ring.nlocal
        if partials.ndim != 2 or partials.shape[0] != pl:
            raise ValueError(f"a rank gather takes ({pl}, k) values, got {tuple(partials.shape)}")
        return GatherFn.apply(partials, self)

    def gather(self, partials: torch.Tensor) -> torch.Tensor:
        """The gather outside autograd."""
        ring = self.ring
        p, pl = ring.nranks, ring.nlocal
        k = partials.shape[1]
        x = partials[:, None, :].expand(pl, p, k).contiguous()
        ring._check(x, True)
        if ring.device.type == "cpu":
            y = ring.plain(x, True)
        else:
            y = ring._push(x, True)
            self.launches += 1
        return y[0, 0].view(p, k)


class GatherFn(torch.autograd.Function):
    """The rank gather as autograd sees it.  Every process computes the
    same reduction of the gathered values, so the objective each process
    differentiates is one function of every rank's partial, and the
    cotangent of this process's partials is its own rows of the gathered
    values' cotangent: no exchange in the backward."""

    @staticmethod
    def forward(ctx, partials, gather):
        ctx.rows = (gather.ring.rank0, gather.ring.nlocal)
        return gather.gather(partials)

    @staticmethod
    def backward(ctx, g):
        r0, n = ctx.rows
        return g[r0: r0 + n], None


class FlipFn(torch.autograd.Function):
    """The pencil flip as autograd sees it: the forward is
    :meth:`RingTranspose.flip`, the backward the inverse flip of the
    cotangent through the same call (the kernel on the card, the plain
    ring on the CPU).  A permutation's adjoint is its inverse, for real
    and complex pencils alike.  On a mesh whose ranks span processes the
    backward flip is a collective like the forward one: every process
    differentiates the same graph, and autograd runs its nodes in the same
    order on each, so the processes issue the same flips in the same
    order."""

    @staticmethod
    def forward(ctx, block, ring, x_to_y):
        ctx.flip = (ring, x_to_y)
        return ring.flip(block, x_to_y)

    @staticmethod
    def backward(ctx, g):
        ring, x_to_y = ctx.flip
        out = ring.flip(g.contiguous(), not x_to_y)
        if g.device.type == "cuda":
            ring.backward_launches += 1
        return out, None, None

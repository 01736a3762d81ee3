"""Build and load the port's CUDA kernels and its host-only C++.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``_build/`` (which
``.gitignore`` lists) at first use, and loaded with ``ctypes``.  A host-only
source (``csrc/<name>.cpp``, :data:`HOST_SOURCES`: the remote flip's socket
exchange across hosts, which includes no CUDA header) is compiled the same
way by ``nvcc`` where the CUDA toolkit is, and by the system C++ compiler
where it is not, so the CPU tests load the very code the card runs.  A
library is named by a hash of its source, the shared headers, the compiler
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("banded_solve", "fused_conv", "fused_stage", "ring_transpose")
#: host-only C++ sources (``csrc/<name>.cpp``), built with the kernels
HOST_SOURCES = ("host_exchange",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: a host-only source's flags after the compiler (``nvcc``, or the system
#: C++ compiler, which takes ``-fPIC`` itself)
HOST_FLAGS = ("-std=c++17", "-O3", "-shared")

#: products one output sums (the Coriolis ``vely`` stage sums five), and
#: outputs one launch computes (its ``L @ x`` products, one a term); the
#: same as in ``csrc/fused_stage.cu``
MAX_TERMS = 5
MAX_JOBS = 5
#: a row that starts on this many bytes may be copied 16 bytes at a time
ROW_ALIGN = 16


class RpJob(ctypes.Structure):
    """Mirror of ``struct RpJob`` in ``csrc/fused_stage.cu``: one output of
    one launch of the generic tiled GEMM,
    ``C[:M, :N] = ((sum_t A[t] @ B[t]) * E + F) * mask``, zero elsewhere in
    ``C[:Mout, :Nout]``, for each member of the launch (member ``m`` reads
    an operand ``X`` at ``X + m * sX``, ``sX`` 0 for an operand the members
    share); bit ``2t`` of ``vec`` says every row of ``A[t]`` starts on 16
    bytes, bit ``2t + 1`` the same of ``B[t]``."""

    _fields_ = [
        ("C", ctypes.c_void_p),
        ("E", ctypes.c_void_p),
        ("F", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
        ("A", ctypes.c_void_p * MAX_TERMS),
        ("B", ctypes.c_void_p * MAX_TERMS),
        ("sA", ctypes.c_longlong * MAX_TERMS),
        ("sB", ctypes.c_longlong * MAX_TERMS),
        ("sC", ctypes.c_longlong),
        ("sE", ctypes.c_longlong),
        ("sF", ctypes.c_longlong),
        ("sM", ctypes.c_longlong),
        ("M", ctypes.c_int),
        ("N", ctypes.c_int),
        ("Mout", ctypes.c_int),
        ("Nout", ctypes.c_int),
        ("nt", ctypes.c_int),
        ("K", ctypes.c_int * MAX_TERMS),
        ("lda", ctypes.c_int * MAX_TERMS),
        ("ldb", ctypes.c_int * MAX_TERMS),
        ("ldc", ctypes.c_int),
        ("lde", ctypes.c_int),
        ("ldf", ctypes.c_int),
        ("ldm", ctypes.c_int),
        ("vec", ctypes.c_int),
    ]


#: ranks of a spanning mesh, and processes, one remote flip reaches (the
#: same as in ``csrc/ring_transpose.cu``)
PUSH_MAX_RANKS = 64
PUSH_MAX_PROCS = 16
#: bytes of a CUDA IPC memory handle (``cudaIpcMemHandle_t``; the source
#: asserts it)
IPC_HANDLE_BYTES = 64
#: bytes of a receive slab's control words, after its two buffers (its
#: ready semaphores first, one a process); the same as ``RT_CTL_BYTES``
SLAB_CTL_BYTES = 256


class RpPush(ctypes.Structure):
    """Mirror of ``struct RpPush`` in ``csrc/ring_transpose.cu``: one flip
    of a mesh whose ranks span processes (the input, the output and this
    process's receive slab; each destination rank's block, a same-host
    peer's slab as mapped in this process, this process's pinned staging
    for an other-host peer, or the output; the slab's control words and
    the peers' ready semaphores of this process; strides and extents in
    elements, the magic pairs of the launch's divisors; the parts the call
    runs; and, where peers lie on other hosts, the exchange's host
    function and its plan, the pinned word the epoch is copied into, the
    received chunks as the card maps them and the mask of those
    processes)."""

    _fields_ = [
        ("inp", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("slab", ctypes.c_void_p),
        ("dst", ctypes.c_void_p * PUSH_MAX_RANKS),
        ("ctl", ctypes.c_void_p),
        ("ready_peer", ctypes.c_void_p * PUSH_MAX_PROCS),
        ("buf_bytes", ctypes.c_longlong),
        ("is0", ctypes.c_longlong),
        ("is1", ctypes.c_longlong),
        ("ism", ctypes.c_longlong),
        ("d1", ctypes.c_longlong),
        ("dsm", ctypes.c_longlong),
        ("blk", ctypes.c_longlong),
        ("mul_w", ctypes.c_longlong),
        ("mul_c", ctypes.c_longlong),
        ("mul_p", ctypes.c_longlong),
        ("mul_l", ctypes.c_longlong),
        ("mul_r", ctypes.c_longlong),
        ("shr_w", ctypes.c_int),
        ("shr_c", ctypes.c_int),
        ("shr_p", ctypes.c_int),
        ("shr_l", ctypes.c_int),
        ("shr_r", ctypes.c_int),
        ("P", ctypes.c_int),
        ("PL", ctypes.c_int),
        ("g0", ctypes.c_int),
        ("c", ctypes.c_int),
        ("w", ctypes.c_int),
        ("members", ctypes.c_int),
        ("x_to_y", ctypes.c_int),
        ("word", ctypes.c_int),
        ("nproc", ctypes.c_int),
        ("me", ctypes.c_int),
        ("parts", ctypes.c_int),
        ("hx_fn", ctypes.c_void_p),
        ("hx_plan", ctypes.c_void_p),
        ("hx_epoch", ctypes.c_void_p),
        ("recv", ctypes.c_void_p),
        ("remote", ctypes.c_longlong),
    ]


_P = ctypes.c_void_p
_I = ctypes.c_int
_JOBS_SIG = ([ctypes.POINTER(RpJob), _I, _I, _P], _I)
_L = ctypes.c_longlong
_DUAL_SIG = ([_I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _L, _L, _L,
              _P], _I)
_BANDED_SIG = ([_I] * 8 + [_P, _P, _I, _L, _L, _I, _P, _L, _L, _L, _P, _L, _L, _L, _I, _L, _L,
                          _I, _P], _I)
_RING_SIG = ([_I, _I, _I, _L, _L, _L, _L, _P, _P, _I, _I, _L, _L, _I, _L, _I, _L, _I, _P], _I)
_PUSH_SIG = ([ctypes.POINTER(RpPush), _P], _I)
_SIGNATURES = {
    "banded_solve": {
        "rp_banded_solve_f64": _BANDED_SIG,
        "rp_banded_solve_f32": _BANDED_SIG,
    },
    "fused_conv": {
        "rp_conv_dual_f64": _DUAL_SIG,
        "rp_conv_dual_f32": _DUAL_SIG,
    },
    "fused_stage": {
        "rp_gemm_f64": _JOBS_SIG,
        "rp_gemm_f32": _JOBS_SIG,
    },
    "ring_transpose": {
        "rp_ring_transpose_f64": _RING_SIG,
        "rp_ring_transpose_f32": _RING_SIG,
        "rp_ring_transpose_c128": _RING_SIG,
        "rp_ring_transpose_c64": _RING_SIG,
        "rp_ring_push_f64": _PUSH_SIG,
        "rp_ring_push_f32": _PUSH_SIG,
        "rp_ring_push_c128": _PUSH_SIG,
        "rp_ring_push_c64": _PUSH_SIG,
        "rp_slab_alloc": ([_L, ctypes.POINTER(_P), _P], _I),
        "rp_slab_free": ([_P], _I),
        "rp_ipc_open": ([_P, ctypes.POINTER(_P)], _I),
        "rp_ipc_close": ([_P], _I),
        "rp_host_alloc": ([_L, ctypes.POINTER(_P), ctypes.POINTER(_P)], _I),
        "rp_host_free": ([_P], _I),
        "rp_stamp": ([_P, _I, _P], _I),
    },
    "host_exchange": {
        "hx_open": ([_I, _I, _P, _P], _P),
        "hx_run": ([_P], _I),
        "hx_abort": ([_P], _I),
        "hx_error": ([_P, ctypes.c_char_p, _I], _I),
        "hx_close": ([_P], _I),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> Path:
    """The source of library ``name``: a kernel's ``.cu``, a host-only
    ``.cpp``."""
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _command(name: str) -> list:
    """The compiler and flags of library ``name`` (without ``-o``): every
    kernel through ``nvcc``; a host-only source through ``nvcc`` where it
    is found, else through the system C++ compiler."""
    if name not in HOST_SOURCES:
        return [_nvcc(), *NVCC_FLAGS]
    try:
        return [_nvcc(), *HOST_FLAGS, "-Wno-deprecated-gpu-targets", "-Xcompiler", "-fPIC"]
    except RuntimeError:
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"neither nvcc nor a C++ compiler found to build {name}") from None
        return [cxx, *HOST_FLAGS, "-fPIC"]


def source_hash(name: str) -> str:
    """Hash of one library's source, every shared header and the flags (a
    host-only source's: its compiler's name and flags)."""
    h = hashlib.sha256()
    for path in [source_path(name)] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    if name in HOST_SOURCES:
        cmd = _command(name)
        h.update(" ".join([Path(cmd[0]).name, *cmd[1:]]).encode())
    else:
        h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_hash(name)}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build(names=KERNELS + HOST_SOURCES) -> dict:
    """Compile the libraries of ``names`` that are not built yet, one
    compiler per source, all started together.  Returns ``{name: {"seconds":
    wall time or 0.0 if already built, "log": compiler output}}`` and
    raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    result = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            text = log.read_text() if log.exists() else ""
            result[name] = {"seconds": 0.0, "log": text}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [*_command(name), "-o", str(tmp), str(source_path(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failures = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        result[name] = {"seconds": time.perf_counter() - t0, "log": text}
        if proc.returncode != 0:
            failures.append(f"{Path(proc.args[0]).name} failed for {name} "
                            f"(rc={proc.returncode}):\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    ``argtypes``/``restype`` set on every entry point."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


def call(fn, device, *args) -> None:
    """Call the entry point ``fn(*args, stream)`` with ``device`` current
    and its current stream, and raise on the returned error.  A kernel
    launches on the current device (where the fused kernels also set their
    shared-memory attributes), so a launch on another card than the current
    one switches to it first."""
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream_handle(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream_handle(device))
    check(rc, fn.__name__)


def gemm(dtype):
    """The generic tiled GEMM's entry point for ``dtype`` (f64 or f32), from
    the ``fused_stage`` library; both fused wrappers launch it."""
    lib = load("fused_stage")
    return lib.rp_gemm_f64 if dtype == torch.float64 else lib.rp_gemm_f32


def rows_aligned(*xs) -> bool:
    """Whether every row of each 2-D (or member-stacked 3-D) tensor ``xs``
    starts on ``ROW_ALIGN`` bytes (its base pointer, its row stride and its
    member stride), so a kernel may copy it 16 bytes at a time; otherwise
    it copies one element at a time."""
    return all(x.data_ptr() % ROW_ALIGN == 0
               and all(x.stride(d) * x.element_size() % ROW_ALIGN == 0 for d in range(x.ndim - 1))
               for x in xs)


def padded(*shape, device, dtype) -> torch.Tensor:
    """An uninitialised tensor of ``shape`` (``rows x cols``, or ``members
    x rows x cols``) whose rows start on ``ROW_ALIGN`` bytes: a view of a
    buffer whose row length is ``cols`` rounded up (the kernels' scratch and
    operator constants)."""
    per = ROW_ALIGN // dtype.itemsize
    *lead, cols = shape
    return torch.empty((*lead, -(-cols // per) * per), device=device, dtype=dtype)[..., :cols]


def stack_planes(x) -> torch.Tensor:
    """The kernels' real form of a complex 2-D tensor ``x`` (m rows), or of
    each member of a member-stacked 3-D one: its real rows then its
    imaginary rows, ``[Re; Im]`` (2m rows), in a :func:`padded` buffer,
    written by one strided copy of its real view for all members."""
    *lead, m, k = x.shape
    dtype = x.real.dtype
    out = padded(*lead, 2 * m, k, device=x.device, dtype=dtype)
    rs = out.stride(-2)
    planes = out.as_strided((*lead, 2, m, k), (*out.stride()[:-2], m * rs, rs, 1))
    planes.copy_(torch.view_as_real(x).movedim(-1, -3))
    return out


def unstack_planes(o) -> torch.Tensor:
    """The complex tensor whose ``[Re; Im]`` rows :func:`stack_planes`
    gives: ``o``'s first half of rows as the real parts, the second as the
    imaginary ones (one copy, for all members)."""
    m = o.shape[-2] // 2
    return torch.complex(o[..., :m, :], o[..., m:, :])


def aligned(x) -> torch.Tensor:
    """``x`` (2-D) itself if :func:`rows_aligned`, else a copy of it in a
    :func:`padded` buffer."""
    if x.ndim == 2 and x.stride(1) == 1 and rows_aligned(x):
        return x
    out = padded(x.shape[0], x.shape[1], device=x.device, dtype=x.dtype)
    out.copy_(x)
    return out


def _member_stride(x, members: int) -> int:
    """The member stride of a job operand: 0 for a 2-D one (the members
    share it), its leading stride for a member-stacked 3-D one."""
    if x.ndim == 2:
        return 0
    if x.shape[0] != members:
        raise ValueError(f"a member-stacked operand of {x.shape[0]} members in a launch of "
                         f"{members}")
    return x.stride(0) if members > 1 else 0


def job(out, terms, *, M, N, Mout=None, Nout=None, E=None, F=None, mask=None,
        members: int = 1) -> RpJob:
    """One :class:`RpJob` from tensors: ``terms`` is a list of ``(A, B)``
    row-major tensors (unit column stride, any row stride) with ``A`` of
    ``M`` rows and ``B`` of ``N`` columns; ``E``, ``F`` and ``mask`` are
    ``M x N``-or-larger tensors.  With ``members`` K, an operand may carry a
    leading member dim of K (3-D: each member reads its own) or none (2-D:
    the members share it); ``out`` carries one when K > 1.  ``vec`` gets the
    bit of each term operand whose rows all start on 16 bytes
    (:func:`rows_aligned`)."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"a job sums 1..{MAX_TERMS} products, got {len(terms)}")
    operands = [out, E, F, mask] + [x for pair in terms for x in pair]
    if any(x is not None and (x.ndim not in (2, 3) or x.stride(-1) != 1) for x in operands):
        raise ValueError("kernel operands must be 2-D (or member-stacked 3-D) with unit "
                         "column stride")
    if members > 1 and out.ndim != 3:
        raise ValueError("a launch of several members writes a member-stacked output")
    j = RpJob()
    j.C = out.data_ptr()
    j.sC = _member_stride(out, members)
    j.M, j.N = int(M), int(N)
    j.Mout = int(M if Mout is None else Mout)
    j.Nout = int(N if Nout is None else Nout)
    j.nt = len(terms)
    j.ldc = out.stride(-2)
    for t, (a, b) in enumerate(terms):
        if a.shape[-2] < M or b.shape[-1] < N or a.shape[-1] != b.shape[-2]:
            raise ValueError(f"term {t}: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not give {M}x{N}")
        if a.shape[-1] < 1:
            raise ValueError(f"term {t}: a product of depth 0")
        j.A[t], j.B[t] = a.data_ptr(), b.data_ptr()
        j.sA[t], j.sB[t] = _member_stride(a, members), _member_stride(b, members)
        j.K[t], j.lda[t], j.ldb[t] = a.shape[-1], a.stride(-2), b.stride(-2)
        j.vec |= rows_aligned(a) << (2 * t) | rows_aligned(b) << (2 * t + 1)
    for name, ld, st, arr in (("E", "lde", "sE", E), ("F", "ldf", "sF", F),
                              ("mask", "ldm", "sM", mask)):
        if arr is not None:
            if arr.shape[-2] < M or arr.shape[-1] < N:
                raise ValueError(f"epilogue operand {name} is smaller than {M}x{N}")
            setattr(j, name, arr.data_ptr())
            setattr(j, ld, arr.stride(-2))
            setattr(j, st, _member_stride(arr, members))
    return j


def launch_jobs(fn, jobs, device, members: int = 1) -> None:
    """Launch the generic kernel entry point ``fn`` on ``jobs`` for
    ``members`` members (every job's member strides set by :func:`job`) on
    ``device``: one grid launch."""
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"a launch takes 1..{MAX_JOBS} jobs, got {len(jobs)}")
    if members < 1:
        raise ValueError(f"a launch of {members} members")
    call(fn, device, (RpJob * len(jobs))(*jobs), len(jobs), int(members))

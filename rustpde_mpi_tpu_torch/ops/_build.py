"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``_build/`` (which
``.gitignore`` lists) at first use, and loaded with ``ctypes``.  A library
is named by a hash of its source, the shared headers and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing is
built or loaded when this module is imported.
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
KERNELS = ("fused_conv", "fused_stage")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

MAX_TERMS = 4
MAX_JOBS = 4


class RpJob(ctypes.Structure):
    """Mirror of ``struct RpJob`` in ``csrc/fused_stage.cu``: one output of
    one launch of the generic tiled GEMM,
    ``C[:M, :N] = ((sum_t A[t] @ B[t]) * E + F) * mask``, zero elsewhere in
    ``C[:Mout, :Nout]``."""

    _fields_ = [
        ("C", ctypes.c_void_p),
        ("E", ctypes.c_void_p),
        ("F", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
        ("A", ctypes.c_void_p * MAX_TERMS),
        ("B", ctypes.c_void_p * MAX_TERMS),
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
    ]


_P = ctypes.c_void_p
_I = ctypes.c_int
_JOBS_SIG = ([ctypes.POINTER(RpJob), _I, _P], _I)
_DUAL_SIG = ([_I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _P], _I)
_SIGNATURES = {
    "fused_conv": {
        "rp_conv_dual_f64": _DUAL_SIG,
        "rp_conv_dual_f32": _DUAL_SIG,
    },
    "fused_stage": {
        "rp_gemm_f64": _JOBS_SIG,
        "rp_gemm_f32": _JOBS_SIG,
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def source_hash(name: str) -> str:
    """Hash of one kernel's source, every shared header and the flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
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


def build(names=KERNELS) -> dict:
    """Compile the libraries of ``names`` that are not built yet, one
    ``nvcc`` per source, all started together.  Returns ``{name: {"seconds":
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
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failures = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        result[name] = {"seconds": time.perf_counter() - t0, "log": text}
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc={proc.returncode}):\n{text}")
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


def gemm(dtype):
    """The generic tiled GEMM's entry point for ``dtype`` (f64 or f32), from
    the ``fused_stage`` library; both fused wrappers launch it."""
    lib = load("fused_stage")
    return lib.rp_gemm_f64 if dtype == torch.float64 else lib.rp_gemm_f32


def job(out, terms, *, M, N, Mout=None, Nout=None, E=None, F=None, mask=None) -> RpJob:
    """One :class:`RpJob` from tensors: ``terms`` is a list of ``(A, B)``
    row-major contiguous tensors with ``A`` of ``M`` rows and ``B`` of ``N``
    columns; ``E``, ``F`` and ``mask`` are ``M x N``-or-larger tensors."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"a job sums 1..{MAX_TERMS} products, got {len(terms)}")
    operands = [out, E, F, mask] + [x for pair in terms for x in pair]
    if any(x is not None and (x.ndim != 2 or x.stride(1) != 1) for x in operands):
        raise ValueError("kernel operands must be 2-D with unit column stride")
    j = RpJob()
    j.C = out.data_ptr()
    j.M, j.N = int(M), int(N)
    j.Mout = int(M if Mout is None else Mout)
    j.Nout = int(N if Nout is None else Nout)
    j.nt = len(terms)
    j.ldc = out.stride(0)
    for t, (a, b) in enumerate(terms):
        if a.shape[0] < M or b.shape[1] < N or a.shape[1] != b.shape[0]:
            raise ValueError(f"term {t}: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not give {M}x{N}")
        j.A[t], j.B[t] = a.data_ptr(), b.data_ptr()
        j.K[t], j.lda[t], j.ldb[t] = a.shape[1], a.stride(0), b.stride(0)
    for name, ld, arr in (("E", "lde", E), ("F", "ldf", F), ("mask", "ldm", mask)):
        if arr is not None:
            if arr.shape[0] < M or arr.shape[1] < N:
                raise ValueError(f"epilogue operand {name} is smaller than {M}x{N}")
            setattr(j, name, arr.data_ptr())
            setattr(j, ld, arr.stride(0))
    return j


def launch_jobs(fn, jobs, device) -> None:
    """Launch the generic kernel entry point ``fn`` on ``jobs``."""
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"a launch takes 1..{MAX_JOBS} jobs, got {len(jobs)}")
    arr = (RpJob * len(jobs))(*jobs)
    check(fn(arr, len(jobs), stream_handle(device)), fn.__name__)

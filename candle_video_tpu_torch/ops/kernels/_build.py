"""Build the hand-written CUDA kernels and bind them through ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started at
once, and the objects are linked into one shared library with a plain C
interface, at first use, into ``candle_video_tpu_torch/_build/``
(gitignored).  The library path is keyed on a hash of the sources and the
flags, so an edited kernel rebuilds and an unchanged one loads from disk.

Each kernel wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches
its kernel, and nowhere else: a run reads the counts to prove that its main
path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

LAUNCHES: collections.Counter = collections.Counter()

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, bias, cos, sin, out, B, S, K, H, D, rope_batch_stride, scale,
    # stream
    "cvt_flash_attention_packed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, ctypes.c_longlong, _F, _P],
    # q, k, v, bias, cos, sin, shift [B, G], out, B, S, K, H, D,
    # rope_batch_stride, scale, stream
    "cvt_flash_attention_packed_long": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _I, ctypes.c_longlong, _F, _P],
    # q, k, v, m, l, acc (the state, updated in place), B, Sq, Sc, H, D, scale,
    # stream
    "cvt_ring_chunk_update": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, bias, out, B, S, K, H, D, scale, stream
    "cvt_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # x, w_q, s, bias, workspace, out, M, K, N, qblock, splits, k_per_split,
    # stream
    "cvt_w8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, w_p, s, m, bias, workspace, out, M, K, N, qblock, scale_bf16, splits,
    # packed_rows_per_split, stream
    "cvt_w4_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


def reset_launches() -> None:
    LAUNCHES.clear()


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "libcvt_kernels.so"


def build() -> Path:
    """Compile the kernels if the hashed library is missing; return its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    jobs = []
    for src in _sources():
        obj = out.parent / f"{src.stem}.{pid}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{pid}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")

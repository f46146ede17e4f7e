"""Build the hand-written CUDA kernels and bind them through ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started at
once, and the objects are linked into one shared library with a plain C
interface, at first use, into ``candle_video_tpu_torch/_build/``
(gitignored).  The library path is keyed on a hash of the sources, the
headers they share (``csrc/*.cuh``) and the flags, so an edited kernel
rebuilds and an unchanged one loads from disk.  The TMA tensor maps are
encoded through ``cudaGetDriverEntryPoint``, so nothing links ``-lcuda``.
``ptxas`` reports every kernel's registers and spills (``-Xptxas -v``); the
report of each source is kept beside the library and read by
``ptxas_report``.

Each kernel wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches
its kernel, and nowhere else: a run reads the counts to prove that its main
path went through the kernels.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, bias, cos, sin, out, B, S, K, H, D, rope_batch_stride, scale,
    # consumers, stages, shared memory bytes, stream
    "cvt_flash_attention_packed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, ctypes.c_longlong, _F, _I, _I, _I, _P],
    # q, k, v, bias, cos, sin, shift [B, G], out, B, S, K, H, D,
    # rope_batch_stride, scale, consumers, stages, shared memory bytes, stream
    "cvt_flash_attention_packed_long": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _I, ctypes.c_longlong, _F, _I, _I, _I,
                                        _P],
    # q, k, v, m, l, acc (the state, updated in place), B, Sq, Sc, H, D, scale,
    # consumers, stages, shared memory bytes, stream
    "cvt_ring_chunk_update": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                              _I, _P],
    # q, k, v, bias, out, B, S, K, H, D, scale, consumers, stages, shared
    # memory bytes, stream
    "cvt_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # x, w_q, s, bias (bf16 or null), out, M, K, N, n_pad (the payload's
    # columns), qblock, bn, stages, split (the cluster), shared memory bytes,
    # stream
    "cvt_w8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w_p, s, m, bias (bf16 or null), out, M, K, N, n_pad, qblock,
    # scale_bf16, bn, stages, split, shared memory bytes, stream
    "cvt_w4_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # w_p, s, m, out (bf16 [K, N]), K, N, qblock, scale_bf16, order_bf16 (q·s
    # rounded to bf16 before + m), stream
    "cvt_w4_dequant": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # split, shared memory bytes, out (int*): clusters of split CTAs the
    # card holds at once
    "cvt_weight_only_max_clusters": [_I, _I, _P],
    # x_q, s_x, w_q [N, K], s_w, bias (f32 or null), workspace (int32 or
    # null), out, M, K (a multiple of 16), N, bn, stages, split, shared
    # memory bytes, stream
    "cvt_w8a8_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x (NDHWC), w [27, O, C], bias (f32 or null), out, workspace (f32 or
    # null), B, T, H, W, C, O, time mode, bh, bw, bn, split, stream
    "cvt_conv3d_igemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    # keys (host uint32 (hi, lo) pairs), rows, n values a row, bf16 (0 or 1),
    # out [rows, n], stream
    "cvt_threefry_normal": [_P, _I, ctypes.c_longlong, _I, _P, _P],
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
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
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
        said, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
        else:
            (out.parent / f"{src.stem}.ptxas.txt").write_text(said + err)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{pid}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def parse_ptxas(text: str) -> list:
    """``-Xptxas -v`` output -> one dict per entry function: its mangled
    name, registers, and spill store and load bytes."""
    rows, entry = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = dict(entry=m.group(1))
        elif entry is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            entry.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif entry is not None and (m := re.search(r"Used (\d+) registers", line)):
            entry["registers"] = int(m.group(1))
            rows.append(entry)
            entry = None
    return rows


def ptxas_report() -> dict:
    """Source file name -> ``parse_ptxas`` of its build (built if missing)."""
    out = build()
    return {src.name: parse_ptxas((out.parent / f"{src.stem}.ptxas.txt").read_text())
            for src in _sources()}


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


@contextlib.contextmanager
def patched(root, source: str, substitutions):
    """Within the block, ``lib()`` is a library built under ``root`` from a
    copy of ``csrc/`` in which ``source`` has each (old, new) pair of
    ``substitutions`` applied (each ``old`` must occur once): a kernel
    changed on purpose, to show that a check catches it or to time a
    variant.  The real library is restored after."""
    global CSRC, BUILD_DIR, _lib
    root = Path(root)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(CSRC, root / "csrc")
    src = root / "csrc" / source
    text = src.read_text()
    for old, new in substitutions:
        if text.count(old) != 1:
            raise AssertionError(f"{source}: the text to replace is not there once: {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    saved = CSRC, BUILD_DIR, _lib
    CSRC, BUILD_DIR, _lib = root / "csrc", root / "_build", None
    try:
        yield
    finally:
        CSRC, BUILD_DIR, _lib = saved


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, which the host plans fill."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")

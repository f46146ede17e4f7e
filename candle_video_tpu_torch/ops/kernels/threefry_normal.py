"""R1: ``jax.random.normal`` on the card — the CUDA kernel and its plain
version.

Not a TPU kernel: the JAX package draws ``jax.random.normal`` inside its XLA
programs.  ``threefry_normal(keys, n, dtype, device)`` draws R rows of n
values, row r from its own key ``(hi, lo)``, in one launch: value i of a row
is ``utils/rng.normal``'s, from the bits of threefry2x32 of the counter
``(i >> 32, i & 0xffffffff)`` (``jax_threefry_partitionable`` on), in
float32 or in bfloat16 (another stream, not the float32 draw rounded).
``csrc/threefry_normal.cu`` says what bounds the kernel.

Keys are host values (``utils/rng.split`` computes them on the host in
microseconds) and travel in the launch's parameters, up to ``MAX_ROWS`` a
launch, so a draw copies nothing to the card.  CPU devices take
``threefry_normal_plain``; CUDA devices launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils.rng import _ERFINV_LARGE, _ERFINV_SMALL, _ROTATIONS
from . import _build

NAME = "threefry_normal"
MAX_ROWS = 128  # csrc/threefry_normal.cu's MAX_ROWS: the keys one launch carries
_M32 = 0xFFFFFFFF
_F32_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))  # nextafter(-1, 0)
_BF16_LO = -0.99609375  # nextafter(-1, 0) in bfloat16
_DTYPES = (torch.float32, torch.bfloat16)


def as_keys(keys) -> np.ndarray:
    """One ``(hi, lo)`` key or a sequence of them -> uint32 [R, 2]."""
    arr = np.asarray(keys, dtype=np.uint64)
    arr = arr.reshape(-1, 2)
    if arr.size == 0 or (arr > _M32).any():
        raise ValueError(f"{NAME}: keys must be (hi, lo) pairs of 32-bit words, got {keys!r}")
    return arr.astype(np.uint32)


def threefry2x32_plain(k0: int, k1: int, x0, x1):
    """threefry2x32 of the counter words ``(x0, x1)`` (int64 tensors holding
    32-bit values) under the key ``(k0, k1)``, in int64 arithmetic masked to
    32 bits."""
    ks = (int(k0), int(k1), int(k0) ^ int(k1) ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def bits_plain(key, n: int, device="cpu"):
    """The 32 random bits of each of a row's ``n`` values (int64 [n]): the
    two threefry words of the flat index, xor-ed."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32_plain(key[0], key[1], idx >> 32, idx & _M32)
    return hi ^ lo


def _as_f32(bits):
    """int64 tensor of float32 bit patterns below 2**31 -> float32."""
    return bits.to(torch.int32).view(torch.float32)


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def erfinv_plain(x):
    """XLA's float32 erfinv, each product and sum rounded on its own.  The
    square root is taken in float64 and rounded once, which is the
    correctly rounded float32 root that NumPy and the card compute (torch's
    float32 ``sqrt`` on the CPU is not, in ~0.7% of values)."""
    w = -torch.log1p(-x * x)
    ws = w - 2.5
    wl = torch.sqrt(torch.clamp_min(w, 5.0).double()).float() - 3.0
    ps = torch.full_like(x, _ERFINV_SMALL[0])
    pl = torch.full_like(x, _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        ps = ps * ws + cs
        pl = pl * wl + cl
    return torch.where(w < 5.0, ps, pl) * x


def uniform_plain(bits, dtype):
    """The uniform in [nextafter(-1, 0), 1) that ``normal`` feeds the erfinv
    (float32 values; bfloat16 values for the bfloat16 stream)."""
    if dtype == torch.bfloat16:
        u01 = _as_f32((((bits & 0xFF) >> 1) | 0x3F80) << 16) - 1.0
        return torch.clamp_min(_round_bf16(_round_bf16(u01 * 2.0) + _BF16_LO), _BF16_LO)
    u01 = _as_f32((bits >> 9) | 0x3F800000) - 1.0
    return torch.clamp_min(u01 * float(np.float32(1.0) - np.float32(_F32_LO)) + _F32_LO,
                           _F32_LO)


def normal_plain(bits, dtype):
    """``jax.random.normal``'s value of each 32 random bits, in ``dtype``."""
    u = uniform_plain(bits, dtype)
    if dtype == torch.bfloat16:
        return (1.4140625 * _round_bf16(erfinv_plain(u))).to(torch.bfloat16)
    return float(np.float32(np.sqrt(2.0))) * erfinv_plain(u)


def threefry_normal_plain(keys, n: int, dtype=torch.float32, device="cpu"):
    """Plain PyTorch version: [R, n] rows, row r drawn from ``keys[r]``."""
    return torch.stack([normal_plain(bits_plain(k, n, device), dtype) for k in as_keys(keys)])


def _check(out):
    if not out.is_cuda:
        raise ValueError(f"{NAME}: no kernel for device {out.device}")
    if out.dtype not in _DTYPES or out.ndim != 2 or not out.is_contiguous():
        raise ValueError(f"{NAME}: out must be a contiguous [R, n] float32 or bfloat16 "
                         f"tensor, got {out.dtype} {tuple(out.shape)}")


def launch(keys, out):
    """Fill ``out`` [R, n] on the card, row r from ``keys[r]``: one launch
    for every ``MAX_ROWS`` rows."""
    _check(out)
    keys = as_keys(keys)
    if keys.shape[0] != out.shape[0]:
        raise ValueError(f"{NAME}: {keys.shape[0]} keys for {out.shape[0]} rows")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    for r in range(0, keys.shape[0], MAX_ROWS):
        part = np.ascontiguousarray(keys[r:r + MAX_ROWS])
        err = _build.lib().cvt_threefry_normal(
            part.ctypes.data_as(ctypes.c_void_p), part.shape[0], out.shape[1],
            int(out.dtype == torch.bfloat16), out[r].data_ptr(), stream)
        _build.check(err, NAME)
        _build.LAUNCHES[NAME] += 1
    return out


def threefry_normal(keys, n: int, dtype=torch.float32, device="cpu"):
    """keys: one (hi, lo) or R of them -> [R, n] ``dtype`` normals on
    ``device``, row r ``jax.random.normal(keys[r], (n,), dtype)``."""
    device = torch.device(device)
    if dtype not in _DTYPES:
        raise TypeError(f"{NAME}: dtype must be float32 or bfloat16, got {dtype}")
    if n < 1:
        raise ValueError(f"{NAME}: n must be positive, got {n}")
    if device.type == "cpu":
        return threefry_normal_plain(keys, n, dtype, device)
    keys = as_keys(keys)
    return launch(keys, torch.empty((keys.shape[0], n), dtype=dtype, device=device))

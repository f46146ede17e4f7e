"""K7: fused W8A8 matmul — CUDA kernel and its plain version.

Counterpart of ``candle_video_tpu/ops/pallas/int8_matmul.py``:
``y = cast(f32(int32(x_q · w_q)) · s_x[:, None] · s_w[None, :])``, the
int8 product summed exactly, the two scales applied in that order in f32,
the result rounded once to ``out_dtype``.  The kernel is
``csrc/int8_matmul.cu`` (int8 wgmma fed by a TMA ring); its source note
says what bounds it.  Its launch is decided here, per shape, by
``plan_w8a8``: the output tile's width, the ring, and the split of the
K-steps over CTAs where the output tiles alone leave the card's SMs idle.
TMA's row pitch must be a multiple of 16 bytes, so a K that is not is
padded with zeros, which add nothing to the int32 sum.

Layout: the weight is ``[N, K]``, K contiguous (the JAX function takes
``[K, N]``): the tensor cores read the second operand K-major and
``ldmatrix.trans`` does not transpose 8-bit elements.  ``nn.Linear``'s
``[out, in]`` weight is that layout already, so ``quantize_weight`` keeps
it; a JAX ``[K, N]`` payload is transposed once when it is carried over.

Bias, in two orders, each where the JAX package uses it: ``w8a8_matmul``
adds it after the cast, in the output dtype, as the JAX ``w8a8_matmul``
does; ``bias_before_cast=True`` adds it in f32 inside the epilogue, as the
JAX DiT tier ``_apply_linear_w8a8`` does.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ...utils import debug
from . import _build

NAME = "w8a8_matmul"
BLOCK_M = 128           # output rows per CTA: two consumer warpgroups of 64
STEP_K = 128            # K bytes per step: one 128-byte swizzled row of int8
STAGES = {128: 6, 256: 4}  # the ring built for each tile width, 192 KB either way
H100_SMS = 132
# K-steps are split over at most this many CTAs per tile: at M = 128 (16
# tiles) eight read slower than four on an H100 (chip_smoke.py's K7 sweep),
# their int32 partials costing the split pass more than the CTAs save
MAX_SPLIT = 4
SMEM_LIMIT = 232448     # one block's dynamic shared memory on the card (227 KB)


def quantize_activations(x):
    """x [..., K] -> (x_q int8 [..., K], s_x f32 [...]): symmetric per row,
    the JAX ``quantize_activations`` (the floor before the division:
    ``max(absmax, 1e-8) / 127``)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    return torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8), s


def quantize_activations_tier(x):
    """The DiT tier's per-token quantizer (``_apply_linear_w8a8``): the
    floor after the division, ``max(absmax / 127, 1e-8)``; round half to
    even on the quotient, as XLA does."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    return torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8), s


def quantize_weight(weight):
    """weight [N, K] (``nn.Linear``'s ``[out, in]``) -> (w_q int8 [N, K],
    s_w f32 [N]): symmetric per output channel over K with the scale floored
    at 1e-8 after the division, the JAX ``_quantize_linear`` bit for bit (on
    the device it sits on: every step is one IEEE f32 operation)."""
    w = weight.float()
    s = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-8)
    w_q = torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8)
    return w_q.contiguous(), s


def w8a8_matmul_plain(x_q, s_x, w_q, s_w, bias=None, out_dtype=torch.bfloat16,
                      bias_before_cast: bool = False):
    """Plain PyTorch version: the exact int product (in float64, exact for
    |sum| < 2**53), then the f32 epilogue."""
    acc = torch.matmul(x_q.double(), w_q.double().t()).float()
    y = acc * s_x.float()[:, None] * s_w.float()[None, :]
    if bias is not None and bias_before_cast:
        y = y + bias.float()
    y = y.to(out_dtype)
    if bias is not None and not bias_before_cast:
        y = y + bias.to(out_dtype)
    return y


@functools.lru_cache(maxsize=256)
def plan_w8a8(m: int, k: int, n: int, sms: int = H100_SMS, *, bn: int | None = None,
              split: int | None = None) -> dict:
    """The kernel's launch for ``[m, k] · [n, k]ᵀ`` on a card of ``sms``
    SMs, a pure function of the shape (cached: treat the result as
    read-only).  ``bn`` and ``split`` force those choices (for measuring
    the alternatives); by default:

    - ``k_pad``: K rounded up to 16 (TMA's stride rule); ``steps``: the
      128-byte K-steps, the last one zero-filled past ``k_pad``.
    - ``bn``: output columns per CTA, 256 where N is a multiple of 256 and
      the 128 x 256 tiles alone fill the SMs once (at M = 4992 they read
      faster than 128 x 128 ones on an H100: ``chip_smoke.py``'s K7
      sweep), else 128; ``stages``: the ring built for it.  The boxes are
      128 bytes of K by 128 rows of x_q and by ``bn`` rows of w_q.
    - ``split``: CTAs along the K-steps of each tile: 1 where the tiles
      fill the SMs, else as many as fill them, at most ``MAX_SPLIT`` and
      ``steps``; ``ranges`` are each split's K-steps, ``workspace`` the
      int32 partials' shape ``[split, m_tiles·128, n_tiles·bn]``.
    """
    k_pad = -(-k // 16) * 16
    steps = -(-k_pad // STEP_K)
    m_tiles = -(-m // BLOCK_M)
    if bn is None:
        bn = 256 if n % 256 == 0 and m_tiles * (n // 256) >= sms else 128
    if bn not in STAGES:
        raise ValueError(f"{NAME}: no kernel is built for {bn}-column tiles")
    n_tiles = -(-n // bn)
    tiles = m_tiles * n_tiles
    if split is None:
        split = 1 if tiles >= sms else min(sms // tiles, MAX_SPLIT, steps)
    if not 1 <= split <= steps:
        raise ValueError(f"{NAME}: a split of {split} over {steps} K-steps")
    stages = STAGES[bn]
    # the ring, the tile's s_w, bias and s_x in f32, the full, empty and
    # epilogue barriers, and 1024 bytes to align the base
    smem = (1024 + stages * (BLOCK_M + bn) * STEP_K + (2 * bn + BLOCK_M) * 4
            + (2 * stages + 1) * 8)
    ranges = [(z * steps // split, (z + 1) * steps // split) for z in range(split)]
    return dict(bm=BLOCK_M, bn=bn, stages=stages, smem_bytes=smem, k_pad=k_pad, steps=steps,
                box_x=(STEP_K, BLOCK_M), box_w=(STEP_K, bn), box_inner_bytes=STEP_K,
                m_tiles=m_tiles, n_tiles=n_tiles, tiles=tiles, split=split, ranges=ranges,
                ctas=tiles * split, waves=tiles * split / sms,
                workspace=(split, m_tiles * BLOCK_M, n_tiles * bn) if split > 1 else None)


def _check(x_q, s_x, w_q, s_w, bias):
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or \
            s_x.dtype != torch.float32 or s_w.dtype != torch.float32:
        raise TypeError(f"{NAME}: needs int8 x_q and w_q, f32 scales; got {x_q.dtype}, "
                        f"{w_q.dtype}, {s_x.dtype}, {s_w.dtype}")
    if w_q.ndim != 2 or w_q.shape[1] != k or s_x.shape != (m,) or s_w.shape != (n,):
        raise ValueError(f"{NAME}: x_q {tuple(x_q.shape)} s_x {tuple(s_x.shape)} "
                         f"w_q {tuple(w_q.shape)} (needs [N, K]) s_w {tuple(s_w.shape)}")
    tensors = [x_q, s_x, w_q, s_w]
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (n,):
            raise ValueError(f"{NAME}: the fused bias must be f32 [N]")
        tensors.append(bias)
    for t in tensors:
        if not t.is_cuda or t.device != x_q.device:
            raise ValueError(f"{NAME}: every input must be on {x_q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: inputs must be contiguous and 16-byte aligned")


def _launch(x_q, s_x, w_q, s_w, bias, plan=None):
    """One launch on ``plan`` (``plan_w8a8``'s for the shape unless one is
    given) of inputs the kernel takes as they are, or after padding K."""
    _check(x_q, s_x, w_q, s_w, bias)
    m, k = x_q.shape
    n = w_q.shape[0]
    if plan is None:
        plan = plan_w8a8(m, k, n, _build.sm_count(x_q.device.index))
    if plan["k_pad"] != k:
        x_q, w_q = (F.pad(t, (0, plan["k_pad"] - k)) for t in (x_q, w_q))
    with debug.span("matmul"):
        y = torch.empty((m, n), dtype=torch.bfloat16, device=x_q.device)
        ws = None
        if plan["workspace"] is not None:
            ws = torch.empty(plan["workspace"], dtype=torch.int32, device=x_q.device)
        err = _build.lib().cvt_w8a8_matmul(
            x_q.data_ptr(), s_x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
            None if bias is None else bias.data_ptr(), None if ws is None else ws.data_ptr(),
            y.data_ptr(), m, plan["k_pad"], n, plan["bn"], plan["stages"], plan["split"],
            plan["smem_bytes"], torch.cuda.current_stream(x_q.device).cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return y


def w8a8_matmul(x_q, s_x, w_q, s_w, bias=None, out_dtype=torch.bfloat16,
                bias_before_cast: bool = False):
    """x_q int8 [M, K], s_x f32 [M], w_q int8 [N, K], s_w f32 [N], bias [N]
    -> [M, N] in ``out_dtype`` (bf16 on the card)."""
    if x_q.device.type == "cpu":
        return w8a8_matmul_plain(x_q, s_x, w_q, s_w, bias, out_dtype, bias_before_cast)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"{NAME}: the kernel writes bfloat16, not {out_dtype}")
    if bias is not None and bias_before_cast:
        return _launch(x_q, s_x, w_q, s_w, bias.float().contiguous())
    y = _launch(x_q, s_x, w_q, s_w, None)
    return y if bias is None else y + bias.to(y.dtype)

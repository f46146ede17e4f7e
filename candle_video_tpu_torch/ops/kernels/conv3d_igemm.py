"""K8: implicit-GEMM 3x3x3 stride-1 conv — CUDA kernel and its plain version.

Counterpart of ``candle_video_tpu/ops/pallas/conv3d_igemm.py``
(``conv3d_igemm_cl``): each tap's partial product accumulated in f32, the
f32 bias fused, the output in the input dtype.  Time is padded by edge
replication (causal: two copies of the first frame before it; otherwise one
on each side) or not at all (``time_pad="valid"``, the streamed decode's
overlap-save), space by zeros.  The kernel is ``csrc/conv3d_igemm.cu``; its
source note says what bounds it.  It pads nothing in memory: the time
padding is a clamp of the frame index and the space padding a zero-fill of
the loads that fall outside the frame.

Layout: the kernel reads and writes ``torch.channels_last_3d`` tensors
(NDHWC in memory).  The VAE's channels-last walks (``ops/conv3d.py``
``causal_conv3d_cl``) hand it such views of their ``[B, T, H, W, C]``
activations, so they pay no copy; an input in another layout (the NCDHW
walks') is copied to channels last first, and ``RELAYOUT`` counts those
copies and their bytes.  The weight
``[O, C, 3, 3, 3]`` is packed once to ``[27, O, C]`` and kept beside it
(``packed_weight``): the copy is re-made only when the weight changes.

The kernel's tiling is chosen here, per shape, by ``plan_conv3d``: the
rectangle of one output frame each CTA owns, its output channels, and the
split of the K-steps over CTAs where the tiles alone leave the card's SMs
idle.

Eligibility (``eligible``) is the JAX kernel's rule without its TPU tile
rule (W a multiple of 16): a 3x3x3 kernel, stride 1, C and O multiples of
128.  CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F

from ...utils import debug
from . import _build

NAME = "conv3d_igemm"
_MODES = {"causal": 0, "same": 1, "valid": 2}
RELAYOUT: collections.Counter = collections.Counter()  # copies, bytes
STEP_C = 64               # channels per K-step
SPLIT_WAVES = 4           # a grid of fewer CTAs than this many waves splits ...
MAX_SPLIT = 4             # ... its K-steps over at most this many CTAs


def eligible(c_in: int, c_out: int, kernel) -> bool:
    """Whether K8 takes a stride-1 conv of this width and kernel size."""
    return tuple(kernel) == (3, 3, 3) and c_in % 128 == 0 and c_out % 128 == 0


def _mode(causal: bool, time_pad: str) -> str:
    if time_pad == "valid":
        return "valid"
    if time_pad != "edge":
        raise ValueError(f"{NAME}: time_pad must be 'edge' or 'valid', not {time_pad!r}")
    return "causal" if causal else "same"


def conv3d_igemm_plain(x, weight, bias=None, causal: bool = True, time_pad: str = "edge"):
    """Plain PyTorch version: f32 ``F.conv3d`` on the time-padded f32 input
    with zero space padding, plus the f32 bias, cast to x's dtype."""
    from ..conv3d import replicate_pad_time  # ops/conv3d imports this module

    xp = x.float()
    if _mode(causal, time_pad) != "valid":
        xp = replicate_pad_time(xp, 3, causal)
    y = F.conv3d(xp, weight.float(), padding=(0, 1, 1))
    if bias is not None:
        y = y + bias.float()[None, :, None, None, None]
    return y.to(x.dtype)


@functools.lru_cache(maxsize=256)
def plan_conv3d(b: int, t_out: int, h: int, w: int, c: int, o: int, sms: int) -> dict:
    """The kernel's tiling for one conv on a card of ``sms`` SMs, a pure
    function of the shape (cached: treat the result as read-only).

    - ``bn``: output channels per CTA, 256 where O allows, else 128.
    - ``bh x bw``: the rectangle of one output frame that a CTA owns,
      ``tile_m`` positions (256 at ``bn`` 128, 128 at ``bn`` 256: the
      kernel's tiles), ``bw`` in 8..128; the one that leaves the fewest
      positions of the tiles outside the frame, the widest among equals.
    - ``split``: CTAs along the ``27·C/64`` K-steps: 1 where the tiles alone
      make ``SPLIT_WAVES`` waves over the SMs, else the smallest split that
      does, at most ``MAX_SPLIT``.  ``ranges`` are each split's K-steps.
    """
    bn = 256 if o % 256 == 0 else 128
    tile_m = 256 if bn == 128 else 128
    best = None
    for bw in (128, 64, 32, 16, 8):
        bh = tile_m // bw
        tiles_h, tiles_w = -(-h // bh), -(-w // bw)
        waste = tiles_h * tiles_w * tile_m - h * w
        if best is None or waste < best[0]:
            best = (waste, bh, bw, tiles_h, tiles_w)
    _, bh, bw, tiles_h, tiles_w = best
    steps = 27 * c // STEP_C
    m_tiles = b * t_out * tiles_h * tiles_w
    tiles = m_tiles * (o // bn)
    split = min(-(-SPLIT_WAVES * sms // tiles), MAX_SPLIT, steps)
    ranges = [(z * steps // split, (z + 1) * steps // split) for z in range(split)]
    return dict(bh=bh, bw=bw, tile_m=tile_m, tiles_h=tiles_h, tiles_w=tiles_w, bn=bn,
                m_tiles=m_tiles, n_tiles=o // bn, steps=steps, split=split, ranges=ranges,
                ctas=tiles * split, waves=tiles * split / sms)


def pack_weight(weight):
    """[O, C, 3, 3, 3] -> [27, O, C] bf16, taps (dt, dh, dw) row-major, C
    contiguous: the kernel's second operand, K-major per output channel."""
    o, c = weight.shape[:2]
    return weight.to(torch.bfloat16).permute(2, 3, 4, 0, 1).reshape(27, o, c).contiguous()


def packed_weight(weight):
    """``pack_weight(weight)``, made once and kept on the weight itself, so
    it lives as long as the weight; made again after an in-place change of
    the weight (its ``_version``) or a new storage (``.data`` replaced).  An
    inference tensor keeps no version, so it is packed at every call."""
    if weight.is_inference():
        return pack_weight(weight)
    key = (weight.data_ptr(), weight._version, weight.dtype, weight.device)
    hit = getattr(weight, "_k8_packed", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_weight(weight.detach()))
        weight._k8_packed = hit
    return hit[1]


def conv3d_igemm(x, weight, bias=None, causal: bool = True, time_pad: str = "edge"):
    """x [B, C, T, H, W], weight [O, C, 3, 3, 3], bias [O] -> [B, O, T', H, W]
    in x's dtype (``T' = T - 2`` for ``time_pad="valid"``, else T); on the
    card a bf16 ``channels_last_3d`` tensor."""
    mode = _mode(causal, time_pad)
    if x.device.type == "cpu":
        return conv3d_igemm_plain(x, weight, bias, causal, time_pad)
    b, c, t, h, w = x.shape
    o = weight.shape[0]
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"{NAME}: needs bf16 x and weight, got {x.dtype}, {weight.dtype}")
    if weight.shape != (o, c, 3, 3, 3) or not eligible(c, o, weight.shape[2:]):
        raise ValueError(f"{NAME}: x {tuple(x.shape)} weight {tuple(weight.shape)}: needs a "
                         "3x3x3 kernel and C, O multiples of 128")
    t_out = t - 2 if mode == "valid" else t
    if t_out < 1:
        raise ValueError(f"{NAME}: {t} frames give no valid output")
    if bias is not None:
        if bias.shape != (o,):
            raise ValueError(f"{NAME}: bias must be [O]")
        bias = bias.float().contiguous()
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        RELAYOUT["copies"] += 1
        RELAYOUT["bytes"] += 2 * x.numel()
        x = x.contiguous(memory_format=torch.channels_last_3d)
    w27 = packed_weight(weight)
    for tensor in (x, w27, bias):
        if tensor is not None and (tensor.device != x.device or tensor.data_ptr() % 16):
            raise ValueError(f"{NAME}: every input must be on {x.device}, 16-byte aligned")
    with debug.span("conv"):
        y = torch.empty((b, o, t_out, h, w), dtype=torch.bfloat16, device=x.device,
                        memory_format=torch.channels_last_3d)
        plan = plan_conv3d(b, t_out, h, w, c, o, _build.sm_count(x.device.index))
        ws = None
        if plan["split"] > 1:
            ws = torch.empty((plan["split"], b * t_out * h * w, o), dtype=torch.float32,
                             device=x.device)
        err = _build.lib().cvt_conv3d_igemm(
            x.data_ptr(), w27.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), None if ws is None else ws.data_ptr(), b, t, h, w, c, o,
            _MODES[mode], plan["bh"], plan["bw"], plan["bn"], plan["split"],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return y

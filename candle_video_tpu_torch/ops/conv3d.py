"""3D convolution with replicate temporal padding
(``candle_video_tpu/ops/conv3d.py``: ``causal_conv3d``), in NCDHW.

Causal pads ``kt-1`` copies of the first frame on the left; non-causal
pads ``(kt-1)//2`` on each side; ``time_pad="valid"`` pads nothing in T.
Space is zero-padded by ``k//2``.  The conv itself is
``torch.nn.functional.conv3d`` (cuDNN on the card), as the JAX package
leaves it to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def replicate_pad_time(x, kt: int, causal: bool = True):
    """x [B,C,T,H,W] -> temporally padded with edge replication."""
    if kt <= 1:
        return x
    left, right = (kt - 1, 0) if causal else ((kt - 1) // 2, (kt - 1) // 2)
    first = x[:, :, :1].expand(-1, -1, left, -1, -1)
    last = x[:, :, -1:].expand(-1, -1, right, -1, -1)
    return torch.cat([first, x, last], dim=2)


def causal_conv3d(x, weight, bias=None, causal: bool = True, time_pad: str = "edge"):
    """Stride-1 conv: x [B,I,T,H,W], weight [O,I,kt,kh,kw] -> [B,O,T',H,W]
    in the weight's dtype.  ``time_pad="valid"`` skips the temporal padding:
    the caller has concatenated the boundary frames itself (the streamed
    decode's overlap-save), and the output is the valid convolution in T."""
    kt, kh, kw = weight.shape[2:]
    x = x.to(weight.dtype)
    if time_pad != "valid":
        x = replicate_pad_time(x, kt, causal)
    return F.conv3d(x, weight, bias, padding=(0, kh // 2, kw // 2))

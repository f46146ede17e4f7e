"""3D convolution with replicate temporal padding
(``candle_video_tpu/ops/conv3d.py``): ``causal_conv3d`` on NCDHW
``[B, C, T, H, W]`` and ``causal_conv3d_cl`` on channels-last
``[B, T, H, W, C]``, the layout of the VAE's default walks
(``CVT_DECODER_LAYOUT``, read by ``models/ltx_video/vae.py``).

Causal pads ``kt-1`` copies of the first frame on the left; non-causal
pads ``(kt-1)//2`` on each side; ``time_pad="valid"`` pads nothing in T.
Space is zero-padded by ``k//2``.

``causal_conv3d_cl`` views a contiguous ``[B, T, H, W, C]`` tensor as
``x.permute(0, 4, 1, 2, 3)``, which is a ``channels_last_3d`` NCDHW tensor
with no copy, and permutes the conv's ``channels_last_3d`` output back, for
free.  Unlike the JAX twin, which sums its ``kt`` tap convs in bf16, it
rounds once, as the NCDHW op.

The implementation is chosen as in the JAX package: ``impl="auto"`` reads
``CVT_CONV3D_IMPL`` (default ``"xla"``) at each call.

- ``"xla"``: ``torch.nn.functional.conv3d`` (cuDNN on the card), as the
  JAX package leaves the conv to XLA.  The default.
  In channels-last cuDNN runs NDHWC on the ``[O, I, kt, kh, kw]``
  weight as it is: no ``channels_last_3d`` copy of the conv weights is
  kept on the card beside them.
- ``"igemm"``: every conv K8 takes (``kernels.conv3d_igemm.eligible``: a
  3x3x3 kernel, C and O multiples of 128) goes to K8, the others to
  ``F.conv3d``.  That is routing by shape: an eligible conv on a CUDA tensor
  launches K8 or raises.  K8 reads and writes ``channels_last_3d``, so the
  channels-last op hands it its view as it is.

The JAX ``"taps"`` value (a TPU layout workaround, measured slower there)
is not ported.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..utils import debug
from .kernels import conv3d_igemm as K8

IMPLS = ("xla", "igemm")


def replicate_pad_time(x, kt: int, causal: bool = True, dim: int = 2):
    """x [B,C,T,H,W] (``dim=2``; ``dim=1`` for [B,T,H,W,C]) -> temporally
    padded with edge replication."""
    if kt <= 1:
        return x
    left, right = (kt - 1, 0) if causal else ((kt - 1) // 2, (kt - 1) // 2)
    t = x.shape[dim]
    first = x.narrow(dim, 0, 1).expand(*x.shape[:dim], left, *x.shape[dim + 1:])
    last = x.narrow(dim, t - 1, 1).expand(*x.shape[:dim], right, *x.shape[dim + 1:])
    return torch.cat([first, x, last], dim=dim)


def resolve_impl(impl: str = "auto") -> str:
    """``"auto"`` -> ``CVT_CONV3D_IMPL`` (default ``"xla"``); an explicit
    value wins over the variable."""
    if impl == "auto":
        impl = os.environ.get("CVT_CONV3D_IMPL", "auto")
    if impl == "auto":
        impl = "xla"
    if impl not in IMPLS:
        raise ValueError(f"conv3d impl {impl!r} is not one of {IMPLS} (the JAX 'taps' "
                         "layout workaround is not ported)")
    return impl


def causal_conv3d(x, weight, bias=None, causal: bool = True, time_pad: str = "edge",
                  impl: str = "auto"):
    """Stride-1 conv: x [B,I,T,H,W], weight [O,I,kt,kh,kw] -> [B,O,T',H,W]
    in the weight's dtype.  ``time_pad="valid"`` skips the temporal padding:
    the caller has concatenated the boundary frames itself (the streamed
    decode's overlap-save), and the output is the valid convolution in T."""
    kt, kh, kw = weight.shape[2:]
    x = x.to(weight.dtype)
    if resolve_impl(impl) == "igemm" and K8.eligible(weight.shape[1], weight.shape[0],
                                                     weight.shape[2:]):
        return K8.conv3d_igemm(x, weight, bias, causal=causal, time_pad=time_pad)
    if time_pad != "valid":
        x = replicate_pad_time(x, kt, causal)
    with debug.span("conv"):
        return F.conv3d(x, weight, bias, padding=(0, kh // 2, kw // 2))


def causal_conv3d_cl(x, weight, bias=None, causal: bool = True, time_pad: str = "edge",
                     impl: str = "auto"):
    """Stride-1 conv in channels-last: x [B,T,H,W,I], weight [O,I,kt,kh,kw]
    (the NCDHW op's weight) -> contiguous [B,T',H,W,O] in the weight's
    dtype, with the NCDHW op's padding and ``time_pad``.  A contiguous x
    reaches K8 or cuDNN with no copy, and both write ``channels_last_3d``,
    so the result costs no copy either (a CPU conv may write NCDHW: that
    one is copied)."""
    kt, kh, kw = weight.shape[2:]
    x = x.to(weight.dtype)
    if resolve_impl(impl) == "igemm" and K8.eligible(weight.shape[1], weight.shape[0],
                                                     weight.shape[2:]):
        y = K8.conv3d_igemm(x.permute(0, 4, 1, 2, 3), weight, bias, causal=causal,
                            time_pad=time_pad)
    else:
        if time_pad != "valid":
            x = replicate_pad_time(x, kt, causal, dim=1)
        with debug.span("conv"):
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight, bias,
                         padding=(0, kh // 2, kw // 2))
    return y.permute(0, 2, 3, 4, 1).contiguous()

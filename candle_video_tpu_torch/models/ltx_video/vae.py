"""LTX-Video VAE (``candle_video_tpu/models/ltx_video/vae.py``): the decoder
(``decoder_forward`` and its exact streamed modes), the encoder
(``encoder_forward`` / ``encoder_forward_cl``), the posterior, and spatial
and temporal tiling.

Decoder: conv_in → mid resnets → up blocks (depth-to-space upsampler with
channel-repeat residual and causal frame crop, then timestep-conditioned
resnets) → output RMSNorm + decoder-level scale/shift modulation → SiLU →
conv_out → unpatchify.  Encoder: patchify → conv_in → down blocks (causal
resnets, then a pixel-unshuffle downsampler with a grouped-mean residual) →
mid resnets → RMSNorm (affine when the checkpoint has ``norm_out``) → SiLU
→ conv_out to latent + 1 channels → the last (logvar) channel replicated to
2·latent moments.  Convolutions go through ``ops/conv3d.py``:
``torch.nn.functional.conv3d`` (cuDNN), or with ``CVT_CONV3D_IMPL=igemm``
K8 for every 3x3x3 conv whose widths are multiples of 128, in the encoder
as in the decoder.

Layout, as in the JAX package: every walk runs channels-last
(``[B, T, H, W, C]`` activations, ``causal_conv3d_cl``, norms over the last
axis) unless ``CVT_DECODER_LAYOUT=ncdhw``, read at each call of the
decoder's and the encoder's entry points; their ``channels_last=`` keyword
wins over the variable.  In channels-last every conv hands K8 or cuDNN a
``channels_last_3d`` view of its input, so K8 copies nothing.  The public
interfaces stay NCDHW: latents and video are transposed at the boundary.
The NCDHW walk is the parity oracle, as in the JAX package.  One body per
op: the modules take a ``cl`` flag (the norm's axis, the per-channel
broadcast, depth-to-space, the crop, the channel tile, unpatchify, the
noise) and only the walks choose it.

The decoder splits into a head (through the last upsampler) and a tail (the
last block's resnets, the output modulation, conv_out, unpatchify).  The
resnets and upsamplers take their temporal convs and residual alignment as
callables, so the dense and streamed walks share one body.  The streamed
(overlap-save) modes carry each kt=3 conv's last two input frames, and a
delay register on each residual branch, from one temporal chunk to the
next: every frame is convolved once and the result equals the dense decode.

- dense: ``LtxVaeDecoder.forward``, the head then the tail;
- tail stream: the dense head, then the tail in chunks
  (``decoder_tail_streamed``);
- ups-split stream: the dense head up to the last upsampler, then that
  upsampler and the tail in chunks (``decoder_ups_tail_streamed``);
- full stream: every stage in chunks of latent frames
  (``decoder_forward_fullstream``).

The streamed modes run channels-last only, as in the JAX package: the
NCDHW layout decodes densely, and asking it for a streamed mode raises.
``select_decode_mode`` picks the first mode whose measured peak fits the
card's free memory.  Tiling (``tiled_decode`` /
``tiled_encode`` in space, ``temporal_tiled_decode`` /
``temporal_tiled_encode`` in time) is approximate: tiles overlap and their
seams are blended with linear ramps.  The facades ``decode`` and ``encode``
dispatch as the JAX ones do (batch slicing, then temporal tiling, then
spatial tiling, then the direct call); each decode tile runs the exact mode
asked for.  One deliberate difference: ``decode`` is dense by default
(``use_tiling=False``, ``use_framewise_decoding=False``), where the JAX
facade defaults both to True; ``generate()`` passes both, as the JAX
``generate`` does.

Noise injection (``cfg.decoder_inject_noise``, one flag for the mid block
and each up block, in the config's order, which the decoder reverses as it
does its other lists): those blocks' resnets carry ``per_channel_scale1/2``
and, when a walk is given ``noise_key`` (a ``utils.rng`` key), add
per-channel scaled ``[H, W]`` noise after each of their two convs, drawn in
the activation's dtype where it lives (R1 on the card), the same draws in
either layout.  As in the JAX package every resnet starts from the same
``noise_key`` (split once before each of its two draws), and ``decode``
passes none.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional

import torch
from torch import nn

from ...ops.activations import silu
from ...ops.conv3d import causal_conv3d, causal_conv3d_cl
from ...ops.embeddings import sinusoidal_timestep_embedding
from ...ops.norms import rms_norm
from ...utils import debug
from ...utils import rng as R
from .configs import LtxVaeConfig


def _use_channels_last(channels_last=None) -> bool:
    """An explicit ``channels_last`` wins; else ``CVT_DECODER_LAYOUT``, read
    now: channels-last unless it is ``"ncdhw"``."""
    if channels_last is not None:
        return channels_last
    return os.environ.get("CVT_DECODER_LAYOUT", "cl") != "ncdhw"


def _to_cl(x):
    """[B, C, T, H, W] -> contiguous [B, T, H, W, C]."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def _from_cl(x):
    """[B, T, H, W, C] -> contiguous [B, C, T, H, W]."""
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _t_dim(cl: bool) -> int:
    return 1 if cl else 2


def _c_dim(cl: bool) -> int:
    return -1 if cl else 1


class Conv3d(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(c_out, dtype=dtype))

    def forward(self, x, causal: bool, time_pad: str = "edge", cl: bool = False):
        conv = causal_conv3d_cl if cl else causal_conv3d
        return conv(x, self.weight, self.bias, causal=causal, time_pad=time_pad)


class TimeEmbedder(nn.Module):
    """CombinedTimestepEmbedder: sinusoid(256) → linear → SiLU → linear."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.linear_1 = nn.Linear(256, dim, dtype=dtype)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, temb, dtype):
        proj = sinusoidal_timestep_embedding(temb, 256).to(dtype)
        return self.linear_2(silu(self.linear_1(proj)))


def _ch(t, cl: bool = False):
    """[B, C] -> [B, C, 1, 1, 1], or [B, 1, 1, 1, C] in channels-last
    (broadcast over T, H, W)."""
    return t[:, None, None, None, :] if cl else t[:, :, None, None, None]


def _same(x):
    return x


def _inject_noise(h, key, scale, cl: bool = False):
    """h + noise·scale: one ``[H, W]`` draw in h's dtype from the second half
    of ``split(key)``, shared by every batch row, channel and frame, scaled
    per channel.  Returns (h, the first half of the split)."""
    key, sub = R.split(key)
    hw = h.shape[2:4] if cl else h.shape[-2:]
    noise = R.normal_on(sub, hw, h.dtype, h.device)
    noise = noise[None, None, :, :, None] if cl else noise
    return h + noise * _ch(scale.reshape(1, -1).to(h.dtype), cl), key


class ResnetBlock(nn.Module):
    """LtxVideoResnetBlock3d with a per-block [4, C] scale/shift table
    (``conditioned``) and, with ``inject_noise``, the [C, 1, 1] scales of
    the noise added after each conv.  The encoder's and the decoder's
    resnets keep their width, so there is no shortcut conv.

    ``conv1``/``conv2`` (h -> y) and ``align`` (x -> x) replace the block
    convs and the identity shortcut in the streamed walks; ``cl`` is the
    activations' layout."""

    def __init__(self, c: int, dtype, conditioned: bool, inject_noise: bool = False):
        super().__init__()
        self.conv1 = Conv3d(c, c, 3, dtype)
        self.conv2 = Conv3d(c, c, 3, dtype)
        self.scale_shift_table = (nn.Parameter(torch.empty(4, c, dtype=dtype))
                                  if conditioned else None)
        self.per_channel_scale1 = self.per_channel_scale2 = None
        if inject_noise:
            self.per_channel_scale1 = nn.Parameter(torch.empty(c, 1, 1, dtype=dtype))
            self.per_channel_scale2 = nn.Parameter(torch.empty(c, 1, 1, dtype=dtype))

    def forward(self, x, temb, causal: bool, conv1=None, conv2=None, align=_same,
                noise_key=None, cl: bool = False):
        with debug.span("resnet"):
            return self._forward(x, temb, causal, conv1, conv2, align, noise_key, cl)

    def _forward(self, x, temb, causal, conv1, conv2, align, noise_key, cl):
        conv1 = conv1 or (lambda y: self.conv1(y, causal, cl=cl))
        conv2 = conv2 or (lambda y: self.conv2(y, causal, cl=cl))
        inject = self.per_channel_scale1 is not None and noise_key is not None
        h = rms_norm(x, eps=1e-8, dim=_c_dim(cl))
        mods = None
        if self.scale_shift_table is not None and temb is not None:
            t = temb.reshape(x.shape[0], 4, -1) + self.scale_shift_table[None].to(temb.dtype)
            mods = [_ch(t[:, i], cl).to(h.dtype) for i in range(4)]
        if mods:
            h = h * (1.0 + mods[1]) + mods[0]
        h = conv1(silu(h))
        if inject:
            h, noise_key = _inject_noise(h, noise_key, self.per_channel_scale1, cl)
        h = rms_norm(h, eps=1e-8, dim=_c_dim(cl))
        if mods:
            h = h * (1.0 + mods[3]) + mods[2]
        h = conv2(silu(h))
        if inject:
            h, _ = _inject_noise(h, noise_key, self.per_channel_scale2, cl)
        return align(x) + h


def _depth_to_space(y, st: int, sh: int, sw: int, cl: bool = False):
    """[B, C'·st·sh·sw, T, H, W] -> [B, C', T·st, H·sh, W·sw] (in
    channels-last [B, T, H, W, C'·st·sh·sw] -> [B, T·st, H·sh, W·sw, C']),
    channel order c_out-major then (st, sh, sw) in both layouts."""
    if cl:
        b, t, hgt, wid, c = y.shape
        c_out = c // (st * sh * sw)
        y = y.reshape(b, t, hgt, wid, c_out, st, sh, sw)
        y = y.permute(0, 1, 5, 2, 6, 3, 7, 4)
        return y.reshape(b, t * st, hgt * sh, wid * sw, c_out)
    b, c, t, hgt, wid = y.shape
    c_out = c // (st * sh * sw)
    y = y.reshape(b, c_out, st, sh, sw, t, hgt, wid)
    y = y.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return y.reshape(b, c_out, t * st, hgt * sh, wid * sw)


def _tile_channels(y, repeats: int, cl: bool):
    return y.repeat(1, 1, 1, 1, repeats) if cl else y.repeat(1, repeats, 1, 1, 1)


def _crop_t(y, n: int, cl: bool):
    return y.narrow(_t_dim(cl), n, y.shape[_t_dim(cl)] - n)


class Upsampler(nn.Module):
    """LtxVideoUpsampler3d: conv → depth-to-space, plus the depth-to-space
    of the input tiled over channels, both cropped by st-1 frames.

    ``conv`` and ``res_align`` (the residual's delay register) replace the
    block conv and the identity in the streamed walks; ``crop_start``
    applies the crop, which a stream does at its start only."""

    def __init__(self, c_in: int, c_out: int, dtype):
        super().__init__()
        self.conv = Conv3d(c_in, c_out, 3, dtype)

    def forward(self, x, stride, residual: bool, channel_repeats: int, causal: bool,
                conv=None, res_align=_same, crop_start: bool = True, cl: bool = False):
        st, sh, sw = stride
        crop = st - 1 if crop_start else 0
        conv = conv or (lambda y: self.conv(y, causal, cl=cl))
        with debug.span("upsampler"):
            h = _crop_t(_depth_to_space(conv(x), st, sh, sw, cl), crop, cl)
            if residual:
                res = _depth_to_space(res_align(x), st, sh, sw, cl)
                if channel_repeats > 1:
                    res = _tile_channels(res, channel_repeats, cl)
                h = h + _crop_t(res, crop, cl)
        return h


class Block(nn.Module):
    """Mid block (``upsampler=None``) or up block: resnets sharing one time
    embedder."""

    def __init__(self, resnets, time_embedder, upsampler=None):
        super().__init__()
        self.upsampler = upsampler
        self.resnets = nn.ModuleList(resnets)
        self.time_embedder = time_embedder

    def temb(self, temb_scaled, dtype):
        if temb_scaled is None or self.time_embedder is None:
            return None
        return self.time_embedder(temb_scaled, dtype)


def _unpatchify(x, p: int, pt: int, cl: bool = False):
    """[B, C·pt·p·p, F, H, W] -> [B, C, F·pt, H·p, W·p] (in channels-last
    [B, F, H, W, C·pt·p·p] -> [B, F·pt, H·p, W·p, C]), channel order
    [c, pt, pw, ph] in both layouts."""
    if cl:
        b, f, h, w, c = x.shape
        out_c = c // (pt * p * p)
        x = x.reshape(b, f, h, w, out_c, pt, p, p)
        x = x.permute(0, 1, 5, 2, 7, 3, 6, 4)
        return x.reshape(b, f * pt, h * p, w * p, out_c)
    b, c, f, h, w = x.shape
    out_c = c // (pt * p * p)
    x = x.reshape(b, out_c, pt, p, p, f, h, w)
    x = x.permute(0, 1, 5, 2, 6, 4, 7, 3)
    return x.reshape(b, out_c, f * pt, h * p, w * p)


class LtxVaeDecoder(nn.Module):
    """The decoder plus the latent statistics it denormalises with."""

    def __init__(self, cfg: LtxVaeConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        tc = cfg.timestep_conditioning
        boc, sts, upr, upf = self.geometry()
        lpb = list(cfg.decoder_layers_per_block)[::-1]
        inj = list(cfg.decoder_inject_noise)[::-1]
        if any(inj) and len(inj) < len(boc) + 1:
            raise ValueError(f"decoder_inject_noise {cfg.decoder_inject_noise} needs a flag "
                             f"for the mid block and each of the {len(boc)} up blocks")
        inj = inj + [False] * (len(boc) + 1 - len(inj))
        self.conv_in = Conv3d(cfg.latent_channels, boc[0], 3, dtype)
        self.mid_block = Block(
            [ResnetBlock(boc[0], dtype, tc, inj[0]) for _ in range(lpb[0])],
            TimeEmbedder(boc[0] * 4, dtype) if tc else None)
        ups = []
        for i in range(len(boc)):
            out_ch = boc[i] // upf[i]
            sp = 8 if sts[i] else 4
            ups.append(Block(
                [ResnetBlock(out_ch, dtype, tc, inj[i + 1]) for _ in range(lpb[i + 1])],
                TimeEmbedder(out_ch * 4, dtype) if tc else None,
                Upsampler(out_ch * upf[i], out_ch * sp, dtype)))
        self.up_blocks = nn.ModuleList(ups)
        final_ch = boc[-1] // upf[-1]
        self.conv_out = Conv3d(final_ch, cfg.out_channels * cfg.patch_size ** 2, 3, dtype)
        self.time_embedder = TimeEmbedder(final_ch * 2, dtype) if tc else None
        self.scale_shift_table = (nn.Parameter(torch.empty(2, final_ch, dtype=dtype))
                                  if tc else None)
        f32 = torch.float32
        self.register_buffer("timestep_scale_multiplier", torch.empty((), dtype=f32))
        self.register_buffer("latents_mean", torch.empty(cfg.latent_channels, dtype=f32))
        self.register_buffer("latents_std", torch.empty(cfg.latent_channels, dtype=f32))

    def geometry(self):
        cfg = self.cfg
        return (list(cfg.decoder_block_out_channels)[::-1],
                list(cfg.decoder_spatiotemporal_scaling)[::-1],
                list(cfg.decoder_upsample_residual)[::-1],
                list(cfg.decoder_upsample_factor)[::-1])

    def ups_args(self, i: int):
        """(stride, residual, channel_repeats) of up block ``i``'s upsampler."""
        boc, sts, upr, upf = self.geometry()
        stride = (2, 2, 2) if sts[i] else (1, 2, 2)
        return stride, upr[i], stride[0] * stride[1] * stride[2] // upf[i]

    @property
    def dtype(self):
        return self.conv_in.weight.dtype

    def temb_scaled(self, temb):
        if temb is None:
            return None
        return temb.reshape(-1).float() * self.timestep_scale_multiplier.float()

    def head_walk(self, z, temb, stop: str, walk):
        """conv_in → mid → up blocks on NCDHW latents ``z`` (transposed on
        entry when ``walk.cl``); the result is in the walk's layout.
        ``stop="tail"`` breaks after the last upsampler (its resnets belong
        to the tail), ``"last_ups"`` before it.  ``walk`` (``_BlockWalk`` or
        ``_StreamWalk``) runs each conv, resnet and upsampler, by site
        name."""
        dtype, t = self.dtype, self.temb_scaled(temb)
        z = z.to(dtype)
        h = walk.conv("conv_in", self.conv_in, _to_cl(z) if walk.cl else z)
        mt = self.mid_block.temb(t, dtype)
        for k, rp in enumerate(self.mid_block.resnets):
            h = walk.resnet(f"mid.{k}", rp, h, mt)
        n_up = len(self.up_blocks)
        for i, blk in enumerate(self.up_blocks):
            last = i == n_up - 1
            if last and stop == "last_ups":
                break
            h = walk.upsampler(f"up{i}", blk.upsampler, h, *self.ups_args(i))
            if last:
                break
            ut = blk.temb(t, dtype)
            for k, rp in enumerate(blk.resnets):
                h = walk.resnet(f"up{i}.{k}", rp, h, ut)
        return h

    def tail_walk(self, h, temb, walk):
        """Last up block's resnets → output RMSNorm + modulation → SiLU →
        conv_out → unpatchify, on ``h`` in the walk's layout; the video is
        NCDHW."""
        cfg, dtype, t, cl = self.cfg, self.dtype, self.temb_scaled(temb), walk.cl
        blk = self.up_blocks[-1]
        ut = blk.temb(t, dtype)
        for k, rp in enumerate(blk.resnets):
            h = walk.resnet(f"tail.{k}", rp, h, ut)
        h = rms_norm(h, eps=1e-8, dim=_c_dim(cl))
        if t is not None and self.time_embedder is not None:
            e = self.time_embedder(t, dtype).reshape(-1, 2, h.shape[_c_dim(cl)])
            e = e + self.scale_shift_table[None].to(dtype)
            h = h * (1.0 + _ch(e[:, 1], cl)) + _ch(e[:, 0], cl)
        h = walk.conv("conv_out", self.conv_out, silu(h))
        video = _unpatchify(h, cfg.patch_size, cfg.patch_size_t, cl)
        return _from_cl(video) if cl else video

    def forward(self, z, temb=None, noise_key=None, channels_last=None):
        """Dense decode: z [B, latent, F, H, W], temb [B] decode timesteps or
        None, ``noise_key`` the injection's key or None -> video [B, 3,
        (F-1)·8+1, H·32, W·32] in about [-1, 1].  ``channels_last`` (default
        ``CVT_DECODER_LAYOUT``) picks the walk's layout.  The head's output
        is handed straight to the tail walk, which drops it after the first
        resnet."""
        walk = _BlockWalk(self.cfg.decoder_causal, noise_key, _use_channels_last(channels_last))
        return self.tail_walk(self.head_walk(z, temb, "tail", walk), temb, walk)


class _BlockWalk:
    """The dense walk: every conv pads time itself."""

    def __init__(self, causal: bool, noise_key=None, cl: bool = False):
        self.causal = causal
        self.noise_key = noise_key
        self.cl = cl

    def conv(self, site, m: Conv3d, h):
        return m(h, self.causal, cl=self.cl)

    def resnet(self, site, m: ResnetBlock, h, temb):
        return m(h, temb, self.causal, noise_key=self.noise_key, cl=self.cl)

    def upsampler(self, site, m: Upsampler, h, stride, residual, reps):
        return m(h, stride, residual, reps, self.causal, cl=self.cl)


def decoder_head_forward(decoder: LtxVaeDecoder, z, temb=None, noise_key=None):
    """conv_in → mid → up blocks, through the last upsampler (NCDHW)."""
    return decoder.head_walk(z, temb, "tail",
                             _BlockWalk(decoder.cfg.decoder_causal, noise_key))


def decoder_head_forward_cl(decoder: LtxVaeDecoder, z, temb=None, noise_key=None):
    """The channels-last head: z [B, latent, F, H, W] -> h [B, T, H, W, C]."""
    return decoder.head_walk(z, temb, "tail",
                             _BlockWalk(decoder.cfg.decoder_causal, noise_key, cl=True))


def decoder_head_pre_ups_forward(decoder: LtxVaeDecoder, z, temb=None, noise_key=None):
    """The head stopped before the last upsampler: it runs at half the final
    resolution or less (NCDHW)."""
    return decoder.head_walk(z, temb, "last_ups",
                             _BlockWalk(decoder.cfg.decoder_causal, noise_key))


def decoder_head_pre_ups_forward_cl(decoder: LtxVaeDecoder, z, temb=None, noise_key=None):
    """The channels-last head stopped before the last upsampler -> h [B, T,
    H/2, W/2, C]."""
    return decoder.head_walk(z, temb, "last_ups",
                             _BlockWalk(decoder.cfg.decoder_causal, noise_key, cl=True))


def decoder_tail_forward(decoder: LtxVaeDecoder, h, temb=None, noise_key=None):
    """The last block's resnets, the output modulation, conv_out, unpatchify
    (NCDHW)."""
    return decoder.tail_walk(h, temb, _BlockWalk(decoder.cfg.decoder_causal, noise_key))


def decoder_tail_forward_cl(decoder: LtxVaeDecoder, h, temb=None, noise_key=None):
    """The channels-last tail: h [B, T, H, W, C] -> video [B, 3, F, H, W]."""
    return decoder.tail_walk(h, temb,
                             _BlockWalk(decoder.cfg.decoder_causal, noise_key, cl=True))


# ---------------------------------------------------------------------------
# streamed walks (overlap-save)
#
# A symmetric kt=3 conv fed chunk frames [a, b) after its cached inputs
# [a-2, a) emits outputs [a-1, b-1): a one-frame delay.  The first chunk
# replicates its first frame in place of the cache (emits t-1 frames), the
# last appends a copy of its last frame and flushes (emits t+1).  Residual
# branches re-align through pure delay registers: 2 frames across a resnet,
# 1 across an upsampler.  The walks are channels-last: ``state`` maps a site
# name to its carried frames [B, n, H, W, C], which the first chunk creates
# and the last drops; they are copies, so a chunk's activations are freed
# once its step returns.
# ---------------------------------------------------------------------------


class _StreamWalk:
    """One channels-last streaming step ("first", "mid", "last" or
    "single") that reads and updates the carried frames in ``state``."""

    cl = True

    def __init__(self, state: dict, mode: str, noise_key=None):
        self.state = state
        self.first = mode in ("first", "single")
        self.last = mode in ("last", "single")
        self.noise_key = noise_key

    def _carry(self, site, x):
        """The carried frames of ``site`` followed by ``x`` (``x`` alone on
        the first step)."""
        return x if self.first else torch.cat([self.state.pop(site), x], dim=1)

    def conv(self, site, m: Conv3d, x):
        base = self._carry(site, x)
        xin = torch.cat([base[:, :1], base], dim=1) if self.first else base
        if self.last:
            xin = torch.cat([xin, xin[:, -1:]], dim=1)
        else:
            self.state[site] = base[:, -2:].clone()
        return m(xin, causal=False, time_pad="valid", cl=True)

    def delay(self, site, x, n: int):
        buf = self._carry(site, x)
        if self.last:
            return buf
        self.state[site] = buf[:, -n:].clone()
        return buf[:, :-n]

    def resnet(self, site, m: ResnetBlock, h, temb):
        """Two one-frame conv delays; the shortcut delayed two frames."""
        return m(h, temb, False, conv1=lambda y: self.conv(f"{site}.c1", m.conv1, y),
                 conv2=lambda y: self.conv(f"{site}.c2", m.conv2, y),
                 align=lambda y: self.delay(f"{site}.sc", y, 2), noise_key=self.noise_key,
                 cl=True)

    def upsampler(self, site, m: Upsampler, h, stride, residual, reps):
        """A one-frame conv delay, the residual delayed one input frame, and
        the st-1 crop at the stream's start only."""
        return m(h, stride, residual, reps, False,
                 conv=lambda y: self.conv(f"{site}.conv", m.conv, y),
                 res_align=lambda y: self.delay(f"{site}.res", y, 1),
                 crop_start=stride[0] > 1 and self.first, cl=True)


def _refuse_causal(decoder):
    if decoder.cfg.decoder_causal:
        raise NotImplementedError(
            "streamed decode assumes the symmetric (non-causal) decoder padding; "
            "decoder_causal configs decode densely")


def _head_stream(decoder, z, state, mode, temb, noise_key):
    _refuse_causal(decoder)
    return decoder.head_walk(z, temb, "tail", _StreamWalk(state, mode, noise_key))


def _tail_stream(decoder, h, state, mode, temb, noise_key):
    _refuse_causal(decoder)
    return decoder.tail_walk(h, temb, _StreamWalk(state, mode, noise_key))


def decoder_head_stream_cl(decoder: LtxVaeDecoder, z, state: dict, mode: str, temb=None,
                           noise_key=None):
    """One streaming step of the head: ``z`` the next [B, latent, t, H, W]
    chunk of latent frames -> h [B, T, H, W, C].  ``state`` starts as
    ``{}``."""
    return _head_stream(decoder, z, state, mode, temb, noise_key)


def decoder_tail_stream_cl(decoder: LtxVaeDecoder, h, state: dict, mode: str, temb=None,
                           noise_key=None):
    """One streaming step of the tail: ``h`` [B, t, H, W, C] is the next
    chunk of the head's output; the NCDHW video chunk has t - delay / t /
    t + delay frames for the first / middle / last step (delay:
    ``tail_stream_delay``)."""
    return _tail_stream(decoder, h, state, mode, temb, noise_key)


def decoder_ups_tail_stream_cl(decoder: LtxVaeDecoder, h, state: dict, mode: str, temb=None,
                               noise_key=None):
    """One streaming step of the last upsampler and the tail, over a chunk of
    ``decoder_head_pre_ups_forward_cl``'s output."""
    _refuse_causal(decoder)
    i = len(decoder.up_blocks) - 1
    h = _StreamWalk(state, mode).upsampler(f"up{i}", decoder.up_blocks[i].upsampler, h,
                                           *decoder.ups_args(i))
    return _tail_stream(decoder, h, state, mode, temb, noise_key)


def _stream_geometry(cfg: LtxVaeConfig):
    """(mid-block resnet count, [(temporal stride, resnet count)] of each up
    block in decode order)."""
    lpb = list(cfg.decoder_layers_per_block)[::-1]
    sts = list(cfg.decoder_spatiotemporal_scaling)[::-1]
    return lpb[0], [(2 if s else 1, n) for s, n in zip(sts, lpb[1:])]


def tail_stream_delay(cfg: LtxVaeConfig) -> int:
    """The streamed tail's delay in input frames: 2 per resnet, 1 for conv_out."""
    return 2 * _stream_geometry(cfg)[1][-1][1] + 1


def ups_tail_first_chunk_min(cfg: LtxVaeConfig) -> int:
    """The smallest first chunk, in pre-upsample frames, that clears the
    last upsampler and the tail's pipeline fill."""
    st = _stream_geometry(cfg)[1][-1][0]
    delay, m = tail_stream_delay(cfg), 2
    while st * (m - 1) - (st - 1) <= delay:
        m += 1
    return m


def fullstream_first_chunk_min(cfg: LtxVaeConfig) -> int:
    """The smallest first chunk of latent frames for which every stage of
    the fully streamed decode emits a frame on the first step (each conv
    swallows one frame of fill; a temporal upsampler doubles the stream and
    crops st-1)."""
    n_mid, ups = _stream_geometry(cfg)

    def least(m: int) -> int:
        c = m - 1  # conv_in
        counts = [c]
        for _ in range(n_mid):
            c -= 2
            counts.append(c)
        for st, n_res in ups:
            c = st * (c - 1) - (st - 1)
            counts.append(c)
            for _ in range(n_res):  # the last block's resnets are the tail's
                c -= 2
                counts.append(c)
        counts.append(c - 1)  # conv_out
        return min(counts)

    m = 2
    while least(m) < 1:
        m += 1
    return m


def _stream_frames(cfg: LtxVaeConfig, t: int):
    """Frames of a dense decode of ``t`` latent frames before the last
    upsampler and after it (the inputs of the ups-split and tail streams)."""
    frames = [t]
    for st, _ in _stream_geometry(cfg)[1]:
        frames.append(st * frames[-1] - (st - 1))
    return frames[-2], frames[-1]


def stream_spans(t_total: int, n_chunks: int):
    """Uniform chunk spans [(start, end), ...]."""
    per = max(-(-t_total // n_chunks), 1)
    return [(s, min(s + per, t_total)) for s in range(0, t_total, per)]


def _stream_mode(i: int, n: int) -> str:
    if n == 1:
        return "single"
    return "first" if i == 0 else ("last" if i == n - 1 else "mid")


def _run_stream(step, x, spans, dim: int):
    """``step`` over the chunks of ``x`` along ``dim``; the NCDHW video
    chunks joined in time."""
    state: dict = {}
    outs = [step(x.narrow(dim, a, b - a), state, _stream_mode(i, len(spans)))
            for i, (a, b) in enumerate(spans)]
    return torch.cat(outs, dim=2)


def decoder_tail_streamed(decoder: LtxVaeDecoder, h, temb=None, n_chunks: int = 2,
                          noise_key=None):
    """The tail over ``n_chunks`` streaming steps of the channels-last
    head's output ``h`` (``decoder_head_forward_cl``'s [B, T, H, W, C]) ->
    NCDHW video."""
    spans = stream_spans(h.shape[1], n_chunks)
    delay = tail_stream_delay(decoder.cfg)
    if len(spans) > 1 and spans[0][1] - spans[0][0] <= delay:
        raise ValueError(f"streaming tail chunk size {spans[0][1] - spans[0][0]} must "
                         f"exceed the pipeline delay {delay}; use fewer chunks")
    return _run_stream(
        lambda c, st, mode: _tail_stream(decoder, c, st, mode, temb, noise_key), h, spans, 1)


def decoder_ups_tail_streamed(decoder: LtxVaeDecoder, h, temb=None, n_chunks: int = 4,
                              noise_key=None):
    """The last upsampler and the tail over ``n_chunks`` streaming steps of
    the channels-last pre-upsample head's output ``h``
    (``decoder_head_pre_ups_forward_cl``'s) -> NCDHW video."""
    spans = stream_spans(h.shape[1], n_chunks)
    need = ups_tail_first_chunk_min(decoder.cfg)
    if len(spans) > 1 and spans[0][1] - spans[0][0] < need:
        raise ValueError(f"ups+tail stream first chunk {spans[0][1] - spans[0][0]} "
                         f"frames < pipeline fill {need}; use fewer chunks")
    return _run_stream(
        lambda c, st, mode: decoder_ups_tail_stream_cl(decoder, c, st, mode, temb, noise_key),
        h, spans, 1)


def decoder_forward_fullstream(decoder: LtxVaeDecoder, z, temb=None, n_chunks: int = 2,
                               noise_key=None):
    """Every stage streamed over chunks of latent frames: activation memory
    O(chunk) everywhere, exact.  The first chunk needs at least
    ``fullstream_first_chunk_min`` latent frames.  The walk is
    channels-last; z and the video are NCDHW."""
    spans = stream_spans(z.shape[2], n_chunks)
    need = fullstream_first_chunk_min(decoder.cfg)
    if len(spans) > 1 and spans[0][1] - spans[0][0] < need:
        raise ValueError(f"full-stream first chunk {spans[0][1] - spans[0][0]} latent "
                         f"frames < pipeline fill {need}; use fewer chunks (or the "
                         f"tail-only streaming mode)")

    def step(c, state, mode):
        h = _head_stream(decoder, c, state, mode, temb, noise_key)
        return _tail_stream(decoder, h, state, mode, temb, noise_key)

    return _run_stream(step, z, spans, 2)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

_DOWNSAMPLE_STRIDES = {
    "conv": (2, 2, 2),
    "spatial": (1, 2, 2),
    "temporal": (2, 1, 1),
    "spatiotemporal": (2, 2, 2),
}


def _patchify(x, p: int, pt: int):
    """[B, C, F, H, W] -> [B, C·pt·p·p, F/pt, H/p, W/p], channel order
    [c, pt, p_w, p_h] (p_w before p_h)."""
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f // pt, pt, h // p, p, w // p, p)
    x = x.permute(0, 1, 3, 7, 5, 2, 4, 6)
    return x.reshape(b, c * pt * p * p, f // pt, h // p, w // p)


def _patchify_cl(x, p: int, pt: int):
    """[B, F, H, W, C] -> [B, F/pt, H/p, W/p, C·pt·p·p], the channel order
    of ``_patchify``, so weights load unchanged."""
    b, f, h, w, c = x.shape
    x = x.reshape(b, f // pt, pt, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 6, 4)
    return x.reshape(b, f // pt, h // p, w // p, c * pt * p * p)


def _unshuffle(y, st: int, sh: int, sw: int, cl: bool = False):
    """[B, C, T·st, H·sh, W·sw] -> [B, C·st·sh·sw, T, H, W] (in channels-last
    [B, T·st, H·sh, W·sw, C] -> [B, T, H, W, C·st·sh·sw]), channel order
    c-major then (st, sh, sw) in both layouts."""
    if cl:
        b, t, hgt, wid, c = y.shape
        tn, hn, wn = t // st, hgt // sh, wid // sw
        y = y.reshape(b, tn, st, hn, sh, wn, sw, c)
        y = y.permute(0, 1, 3, 5, 7, 2, 4, 6)
        return y.reshape(b, tn, hn, wn, c * st * sh * sw)
    b, c, t, hgt, wid = y.shape
    tn, hn, wn = t // st, hgt // sh, wid // sw
    y = y.reshape(b, c, tn, st, hn, sh, wn, sw)
    y = y.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return y.reshape(b, c * st * sh * sw, tn, hn, wn)


class Downsampler(nn.Module):
    """LtxVideoDownsampler3d: pad the front with st-1 copies of the first
    frame (apart from the conv's own causal padding), conv to
    ``out_channels / (st·sh·sw)``, unshuffle space and time into channels,
    and add the unshuffled input averaged over groups of channels."""

    def __init__(self, c_in: int, c_out: int, dtype):
        super().__init__()
        self.conv = Conv3d(c_in, c_out, 3, dtype)

    def forward(self, x, stride, out_channels: int, causal: bool, cl: bool = False):
        st, sh, sw = stride
        c, td = x.shape[_c_dim(cl)], _t_dim(cl)
        group = c * st * sh * sw // out_channels
        if st > 1:
            x = torch.cat([x.narrow(td, 0, st - 1), x], dim=td)
        res = _unshuffle(x, st, sh, sw, cl)
        if cl:
            res = res.reshape(*res.shape[:4], -1, group).mean(dim=-1)
        else:
            res = res.reshape(res.shape[0], -1, group, *res.shape[2:]).mean(dim=2)
        return _unshuffle(self.conv(x, causal, cl=cl), st, sh, sw, cl) + res


class DownBlock(nn.Module):
    """Causal resnets, then the downsampler (None where the block keeps its
    resolution)."""

    def __init__(self, resnets, downsampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.downsampler = downsampler


class LtxVaeEncoder(nn.Module):
    """LtxVideoEncoder3d.  ``norm_out`` gives the output RMSNorm an affine
    weight (a checkpoint's ``encoder.norm_out.weight``; the JAX random init
    has none)."""

    def __init__(self, cfg: LtxVaeConfig, dtype=torch.bfloat16, norm_out: bool = False):
        super().__init__()
        self.cfg = cfg
        boc, lpb = list(cfg.block_out_channels), list(cfg.layers_per_block)
        p_in = cfg.in_channels * cfg.patch_size ** 2 * cfg.patch_size_t
        self.conv_in = Conv3d(p_in, boc[0], 3, dtype)
        blocks = []
        for i in range(len(boc) - 1):
            ds = None
            if cfg.spatiotemporal_scaling[i]:
                st, sh, sw = self.stride(i)
                ds = Downsampler(boc[i], boc[i + 1] // (st * sh * sw), dtype)
            blocks.append(DownBlock([ResnetBlock(boc[i], dtype, False)
                                     for _ in range(lpb[i])], ds))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = Block([ResnetBlock(boc[-1], dtype, False)
                                for _ in range(max(lpb[-1] - 1, 0))], None)
        self.norm_out = nn.Parameter(torch.empty(boc[-1], dtype=dtype)) if norm_out else None
        self.conv_out = Conv3d(boc[-1], cfg.latent_channels + 1, 3, dtype)

    def stride(self, i: int):
        return _DOWNSAMPLE_STRIDES[self.cfg.downsample_types[i].lower()]

    @property
    def dtype(self):
        return self.conv_in.weight.dtype

    def forward(self, x, channels_last=None):
        """x [B, 3, F, H, W] in [-1, 1] -> moments [B, 2·latent, F', H', W']
        in the encoder's dtype: the mean, then the one logvar channel
        replicated.  ``channels_last`` (default ``CVT_DECODER_LAYOUT``) picks
        the walk's layout (``encoder_forward_cl`` or ``encoder_forward``);
        x and the moments are NCDHW either way."""
        cfg, causal = self.cfg, self.cfg.is_causal
        cl = _use_channels_last(channels_last)
        if cl:
            h = _patchify_cl(x.permute(0, 2, 3, 4, 1), cfg.patch_size, cfg.patch_size_t)
        else:
            h = _patchify(x, cfg.patch_size, cfg.patch_size_t)
        h = self.conv_in(h, causal, cl=cl)
        for i, blk in enumerate(self.down_blocks):
            for rp in blk.resnets:
                h = rp(h, None, causal, cl=cl)
            if blk.downsampler is not None:
                h = blk.downsampler(h, self.stride(i), cfg.block_out_channels[i + 1], causal,
                                    cl=cl)
        for rp in self.mid_block.resnets:
            h = rp(h, None, causal, cl=cl)
        h = rms_norm(h, eps=1e-8, dim=_c_dim(cl))
        if self.norm_out is not None:
            h = h * _ch(self.norm_out[None].to(h.dtype), cl)
        h = self.conv_out(silu(h), causal, cl=cl)
        c = h.shape[_c_dim(cl)]
        if cl:
            return _from_cl(torch.cat([h, h[..., c - 1:].expand(-1, -1, -1, -1, c - 2)], dim=-1))
        return torch.cat([h, h[:, c - 1:].expand(-1, c - 2, -1, -1, -1)], dim=1)


def gaussian_split(moments):
    """moments [B, 2C, ...] -> (mean, logvar)."""
    c = moments.shape[1] // 2
    return moments[:, :c], moments[:, c:]


def gaussian_sample(moments, key):
    """mean + exp(logvar / 2)·eps, eps ``jax.random.normal(key)`` drawn in
    the moments' dtype (float32 or bfloat16: another stream each) where the
    moments live (``utils/rng.normal_on``: R1 on the card)."""
    mean, logvar = gaussian_split(moments)
    eps = R.normal_on(key, mean.shape, mean.dtype, mean.device)
    return mean + torch.exp(0.5 * logvar) * eps


def normalize_latents(latents, mean, std, scaling_factor: float = 1.0):
    """(x - mean)·scaling / std per channel, in the latents' dtype."""
    c = latents.shape[1]
    mean = mean.reshape(1, c, 1, 1, 1).to(latents.dtype)
    std = std.reshape(1, c, 1, 1, 1).to(latents.dtype)
    return (latents - mean) * scaling_factor / std


# ---------------------------------------------------------------------------
# mode policy + facade
# ---------------------------------------------------------------------------


def _device_free_bytes(device) -> int | None:
    """Free card memory, counting what PyTorch's caching allocator holds
    unused; None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


# Peak bytes a bf16 decode allocates per output pixel-frame (B·F·H·W at
# sample resolution), the larger reading of ``chip_smoke.py`` at 512x768x97
# and x257 on an NVIDIA H100 80GB HBM3 at 700 W, rounded up: the dense
# decode (channels-last 104.5, 109.0; NCDHW 105.1, 109.3); the streams,
# channels-last only: the tail stream in 2 chunks, the fewest the ladder
# picks (79.3, 76.7), and the ups-split stream in 4, the fewest it picks
# (45.0, 42.3).  Their chunk counts only grow as the free memory falls.
_DENSE_PEAK_B_PER_PX = 110.0
_TAIL_STREAM_PEAK_B_PER_PX = 80.0
_UPS_STREAM_PEAK_B_PER_PX = 46.0


def select_decode_mode(cfg: LtxVaeConfig, z_shape, *, free_bytes: int | None = None,
                       device=None, channels_last=None) -> dict:
    """The decode-mode policy: keyword arguments for :func:`decode` naming
    the first exact mode whose peak fits 85% of the free card memory
    (``free_bytes``, else read from ``device``) and whose first chunk clears
    its pipeline fill: dense; the tail stream; the ups-split stream; the
    full stream.  Dense without a memory reading (the CPU), for a causal
    decoder, below 4 latent frames, or in the NCDHW layout
    (``channels_last``, default ``CVT_DECODER_LAYOUT``), which does not
    stream, as in the JAX policy.  Raises ValueError when only the full
    stream fits and ``z_shape`` has too few latent frames for two of its
    chunks."""
    cl = _use_channels_last(channels_last)
    b, _, t, h, w = z_shape
    px = (b * t * cfg.temporal_compression_ratio * h * cfg.spatial_compression_ratio
          * w * cfg.spatial_compression_ratio)
    if free_bytes is None and device is not None:
        free_bytes = _device_free_bytes(device)
    if free_bytes is None or not cl or cfg.decoder_causal or t < 4:
        return {}
    budget = 0.85 * free_bytes
    if _DENSE_PEAK_B_PER_PX * px <= budget:
        return {}
    n = math.ceil(_DENSE_PEAK_B_PER_PX * px / budget)
    t_pre, t_head = _stream_frames(cfg, t)
    most = min(t // 2, t_head // (tail_stream_delay(cfg) + 1))
    if _TAIL_STREAM_PEAK_B_PER_PX * px <= budget and most >= 2:
        return {"tail_stream_chunks": min(max(2, n), most)}
    most = min(t // 2, t_pre // ups_tail_first_chunk_min(cfg))
    if _UPS_STREAM_PEAK_B_PER_PX * px <= budget and most >= 2:
        return {"tail_stream_chunks": min(max(4, n), most), "tail_stream_from_ups": True}
    need = fullstream_first_chunk_min(cfg)
    if t // need < 2:
        raise ValueError(
            f"no exact decode mode fits {free_bytes / 2**30:.2f} GiB free for latents "
            f"{tuple(z_shape)}: the full stream needs {need} latent frames per chunk")
    return {"full_stream_chunks": t // need}


def _decode_mode_fn(decoder: LtxVaeDecoder, tail_stream_chunks: int = 0,
                    tail_stream_from_ups: bool = False, full_stream_chunks: int = 0):
    """The exact decode of one (tile of) latents, ``(z, temb, channels_last)
    -> video``, in the mode asked for: dense, tail stream, ups-split stream
    or full stream, in the layout asked for (default
    ``CVT_DECODER_LAYOUT``).  The streamed modes are channels-last only."""
    def run(z, temb, channels_last=None):
        cl = _use_channels_last(channels_last)
        streamed = full_stream_chunks > 1 or tail_stream_chunks > 1
        if streamed and not cl:
            raise ValueError("the streamed decode modes require the channels-last decoder")
        if full_stream_chunks > 1:
            return decoder_forward_fullstream(decoder, z, temb, n_chunks=full_stream_chunks)
        if tail_stream_chunks <= 1:
            return decoder(z, temb, channels_last=cl)
        if tail_stream_from_ups:
            return decoder_ups_tail_streamed(
                decoder, decoder_head_pre_ups_forward_cl(decoder, z, temb), temb,
                n_chunks=tail_stream_chunks)
        return decoder_tail_streamed(decoder, decoder_head_forward_cl(decoder, z, temb), temb,
                                     n_chunks=tail_stream_chunks)

    return run


# ---------------------------------------------------------------------------
# tiling (approximate: overlapping tiles, seams blended with linear ramps)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TilingConfig:
    """Tile sizes and strides in sample pixels and frames."""

    tile_sample_min_height: int = 512
    tile_sample_min_width: int = 512
    tile_sample_min_num_frames: int = 16
    tile_sample_stride_height: int = 384
    tile_sample_stride_width: int = 384
    tile_sample_stride_num_frames: int = 8


def _blend(a, b, blend: int, dim: int):
    """The first ``blend`` entries of ``b`` along ``dim`` ramp from ``a``'s
    last ones: ``a[-blend + x]·(1 - x/blend) + b[x]·(x/blend)``."""
    blend = min(blend, a.shape[dim], b.shape[dim])
    if blend == 0:
        return b
    shape = [1] * b.ndim
    shape[dim] = blend
    w = (torch.arange(blend, dtype=torch.float32, device=b.device) / blend).to(b.dtype)
    w = w.reshape(shape)
    mixed = a.narrow(dim, a.shape[dim] - blend, blend) * (1.0 - w) + b.narrow(dim, 0, blend) * w
    return torch.cat([mixed, b.narrow(dim, blend, b.shape[dim] - blend)], dim=dim)


def blend_h(a, b, blend: int):
    """Blend ``b``'s left columns from ``a``'s right ones."""
    return _blend(a, b, blend, 4)


def blend_v(a, b, blend: int):
    """Blend ``b``'s top rows from ``a``'s bottom ones."""
    return _blend(a, b, blend, 3)


def blend_t(a, b, blend: int):
    """Blend ``b``'s first frames from ``a``'s last ones."""
    return _blend(a, b, blend, 2)


def _stitch(rows, bh: int, bw: int, stride_h: int, stride_w: int):
    """Blend each tile against its already-blended upper and left
    neighbours, keep its top-left ``stride`` part, and concatenate."""
    prev, out = [], []
    for ri, row in enumerate(rows):
        cur, kept = [], []
        for cj, tile in enumerate(row):
            if ri > 0:
                tile = blend_v(prev[cj], tile, bh)
            if cj > 0:
                tile = blend_h(cur[cj - 1], tile, bw)
            cur.append(tile)
            kept.append(tile[:, :, :, :min(stride_h, tile.shape[3]),
                             :min(stride_w, tile.shape[4])])
        out.append(torch.cat(kept, dim=4))
        prev = cur
    return torch.cat(out, dim=3)


def tiled_decode(decoder: LtxVaeDecoder, z, temb, tiling: TilingConfig, decode_fn=None):
    """Spatial tiling: tiles of latents decoded one by one (``decode_fn``,
    default dense), blended in sample space."""
    decode_fn = decode_fn or _decode_mode_fn(decoder)
    height, width = z.shape[3], z.shape[4]
    sc = decoder.cfg.spatial_compression_ratio
    lat_min_h, lat_min_w = tiling.tile_sample_min_height // sc, tiling.tile_sample_min_width // sc
    lat_str_h = tiling.tile_sample_stride_height // sc
    lat_str_w = tiling.tile_sample_stride_width // sc
    rows = [[decode_fn(z[:, :, :, i:min(i + lat_min_h, height), j:min(j + lat_min_w, width)],
                       temb)
             for j in range(0, width, lat_str_w)] for i in range(0, height, lat_str_h)]
    dec = _stitch(rows, tiling.tile_sample_min_height - tiling.tile_sample_stride_height,
                  tiling.tile_sample_min_width - tiling.tile_sample_stride_width,
                  tiling.tile_sample_stride_height, tiling.tile_sample_stride_width)
    return dec[:, :, :, :height * sc, :width * sc]


def tiled_encode(encoder: LtxVaeEncoder, x, tiling: TilingConfig, channels_last=None):
    """Spatial tiling of the encode: tiles of samples encoded one by one (in
    the layout ``channels_last`` picks), blended in latent space."""
    height, width = x.shape[3], x.shape[4]
    sc = encoder.cfg.spatial_compression_ratio
    lat_min_h, lat_min_w = tiling.tile_sample_min_height // sc, tiling.tile_sample_min_width // sc
    lat_str_h = tiling.tile_sample_stride_height // sc
    lat_str_w = tiling.tile_sample_stride_width // sc
    rows = [[encoder(x[:, :, :, i:min(i + tiling.tile_sample_min_height, height),
                       j:min(j + tiling.tile_sample_min_width, width)], channels_last)
             for j in range(0, width, tiling.tile_sample_stride_width)]
            for i in range(0, height, tiling.tile_sample_stride_height)]
    enc = _stitch(rows, lat_min_h - lat_str_h, lat_min_w - lat_str_w, lat_str_h, lat_str_w)
    return enc[:, :, :, :height // sc, :width // sc]


def _join_t(tiles, blend: int, stride: int):
    """Blend each tile's first frames from the previous (unblended) tile and
    keep ``stride`` frames of it; the first tile keeps ``stride + 1``."""
    out = []
    for idx, tile in enumerate(tiles):
        if idx > 0:
            tile = blend_t(tiles[idx - 1], tile, blend)
            out.append(tile[:, :, :min(stride, tile.shape[2])])
        else:
            out.append(tile[:, :, :min(stride + 1, tile.shape[2])])
    return torch.cat(out, dim=2)


def temporal_tiled_decode(decoder: LtxVaeDecoder, z, temb, tiling: TilingConfig,
                          decode_fn=None):
    """Temporal tiling: tiles of ``tile_sample_min_num_frames / tc + 1``
    latent frames every ``stride / tc``, each spatially tiled when the frame
    exceeds a tile; every tile but the first drops its last sample frame."""
    num_frames, h, w = z.shape[2], z.shape[3], z.shape[4]
    cfg = decoder.cfg
    tc, sc = cfg.temporal_compression_ratio, cfg.spatial_compression_ratio
    lat_min_t = tiling.tile_sample_min_num_frames // tc
    lat_str_t = tiling.tile_sample_stride_num_frames // tc
    spatial = w > tiling.tile_sample_min_width // sc or h > tiling.tile_sample_min_height // sc
    fn = decode_fn or _decode_mode_fn(decoder)
    tiles = []
    for k, i in enumerate(range(0, num_frames, lat_str_t)):
        tile = z[:, :, i:min(i + lat_min_t + 1, num_frames)]
        dec = tiled_decode(decoder, tile, temb, tiling, decode_fn) if spatial else fn(tile, temb)
        if k > 0 and dec.shape[2] > 1:
            dec = dec[:, :, :-1]
        tiles.append(dec)
    dec = _join_t(tiles, tiling.tile_sample_min_num_frames - tiling.tile_sample_stride_num_frames,
                  tiling.tile_sample_stride_num_frames)
    return dec[:, :, :(num_frames - 1) * tc + 1]


def temporal_tiled_encode(encoder: LtxVaeEncoder, x, tiling: TilingConfig,
                          channels_last=None):
    """Temporal tiling of the encode: tiles of ``tile_sample_min_num_frames
    + 1`` frames every stride, each spatially tiled when the frame exceeds a
    tile; the first tile drops its first latent frame."""
    num_frames, h, w = x.shape[2], x.shape[3], x.shape[4]
    tc = encoder.cfg.temporal_compression_ratio
    lat_min_t = tiling.tile_sample_min_num_frames // tc
    lat_str_t = tiling.tile_sample_stride_num_frames // tc
    spatial = h > tiling.tile_sample_min_height or w > tiling.tile_sample_min_width
    tiles = []
    for i in range(0, num_frames, tiling.tile_sample_stride_num_frames):
        tile = x[:, :, i:min(i + tiling.tile_sample_min_num_frames + 1, num_frames)]
        enc = (tiled_encode(encoder, tile, tiling, channels_last) if spatial
               else encoder(tile, channels_last))
        tiles.append(enc[:, :, 1:] if i == 0 else enc)
    enc = _join_t(tiles, lat_min_t - lat_str_t, lat_str_t)
    return enc[:, :, :(num_frames - 1) // tc + 1]


def decode(decoder: LtxVaeDecoder, z, temb=None, *, tiling: Optional[TilingConfig] = None,
           use_tiling: bool = False, use_framewise_decoding: bool = False,
           use_slicing: bool = False, tail_stream_chunks: int = 0,
           tail_stream_from_ups: bool = False, full_stream_chunks: int = 0,
           auto_mode: bool = False, channels_last=None):
    """The decode facade, in the JAX dispatch order: with ``use_slicing``
    each batch row alone; then temporal tiling when ``use_framewise_decoding``
    and the latents have more frames than a tile; then spatial tiling when
    ``use_tiling`` and a side exceeds a tile; else the direct decode.  Every
    tile (and the direct call) runs the exact mode asked for: dense, or the
    streamed mode the chunk keywords name.  With ``auto_mode`` and no chunk
    keyword, ``select_decode_mode`` picks the mode from the latents' shape
    and the free memory of their device; chunk keywords always win.  Dense
    and untiled by default: the JAX facade defaults ``use_tiling`` and
    ``use_framewise_decoding`` to True.  The layout is read once per call
    (``channels_last``, default ``CVT_DECODER_LAYOUT``)."""
    tiling = tiling or TilingConfig()
    cl = _use_channels_last(channels_last)
    if auto_mode and not tail_stream_chunks and not full_stream_chunks:
        picked = select_decode_mode(decoder.cfg, z.shape, device=z.device, channels_last=cl)
        tail_stream_chunks = picked.get("tail_stream_chunks", 0)
        tail_stream_from_ups = picked.get("tail_stream_from_ups", False)
        full_stream_chunks = picked.get("full_stream_chunks", 0)
    fn = functools.partial(
        _decode_mode_fn(decoder, tail_stream_chunks, tail_stream_from_ups, full_stream_chunks),
        channels_last=cl)
    if use_slicing and z.shape[0] > 1:
        return torch.cat([_decode_tiled(decoder, z[i:i + 1],
                                        None if temb is None else temb[i:i + 1], tiling,
                                        use_tiling, use_framewise_decoding, fn)
                          for i in range(z.shape[0])])
    return _decode_tiled(decoder, z, temb, tiling, use_tiling, use_framewise_decoding, fn)


def _decode_tiled(decoder, z, temb, tiling, use_tiling, use_framewise_decoding, fn):
    t, h, w = z.shape[2:]
    sc, tc = decoder.cfg.spatial_compression_ratio, decoder.cfg.temporal_compression_ratio
    if use_framewise_decoding and t > tiling.tile_sample_min_num_frames // tc:
        return temporal_tiled_decode(decoder, z, temb, tiling, fn)
    if use_tiling and (w > tiling.tile_sample_min_width // sc
                       or h > tiling.tile_sample_min_height // sc):
        return tiled_decode(decoder, z, temb, tiling, fn)
    return fn(z, temb)


def encode(encoder: LtxVaeEncoder, x, *, tiling: Optional[TilingConfig] = None,
           use_tiling: bool = True, use_framewise_encoding: bool = False,
           channels_last=None):
    """The encode facade, with the JAX one's defaults and order: temporal
    tiling when ``use_framewise_encoding`` and x has more frames than a
    tile, then spatial tiling when ``use_tiling`` and a side exceeds a tile,
    else the direct encode.  x [B, 3, F, H, W] -> moments.  The layout is
    read at each call (``channels_last``, default ``CVT_DECODER_LAYOUT``):
    the JAX facade freezes it at its first call (``_jitted_encoder``'s
    doubled cache)."""
    tiling = tiling or TilingConfig()
    cl = _use_channels_last(channels_last)
    t, h, w = x.shape[2:]
    if use_framewise_encoding and t > tiling.tile_sample_min_num_frames:
        return temporal_tiled_encode(encoder, x, tiling, cl)
    if use_tiling and (h > tiling.tile_sample_min_height or w > tiling.tile_sample_min_width):
        return tiled_encode(encoder, x, tiling, cl)
    return encoder(x, cl)


def forward(encoder: LtxVaeEncoder, decoder: LtxVaeDecoder, sample, temb=None,
            sample_posterior: bool = False, key=None, **kwargs):
    """Encode, take the posterior's sample (``key``, a ``utils.rng`` key) or
    its mean, decode.  ``kwargs`` go to ``encode`` (``tiling``,
    ``use_tiling``, ``use_framewise_encoding``, ``channels_last``) and
    ``decode`` (``tiling``, ``use_tiling``, ``use_framewise_decoding``,
    ``use_slicing``, ``channels_last``)."""
    moments = encode(encoder, sample, **{k: v for k, v in kwargs.items() if k in (
        "tiling", "use_tiling", "use_framewise_encoding", "channels_last")})
    if sample_posterior:
        if key is None:
            raise ValueError("sample_posterior=True requires a PRNG key")
        z = gaussian_sample(moments, key)
    else:
        z, _ = gaussian_split(moments)
    return decode(decoder, z, temb, **{k: v for k, v in kwargs.items() if k in (
        "tiling", "use_tiling", "use_framewise_decoding", "use_slicing", "channels_last")})


def denormalize_latents(latents, mean, std, scaling_factor: float = 1.0):
    c = latents.shape[1]
    mean = mean.reshape(1, c, 1, 1, 1).to(latents.dtype)
    std = std.reshape(1, c, 1, 1, 1).to(latents.dtype)
    return latents * std / scaling_factor + mean


def empty_decoder(cfg: LtxVaeConfig, device, dtype=torch.bfloat16) -> LtxVaeDecoder:
    with torch.device("meta"):
        model = LtxVaeDecoder(cfg, dtype)
    return model.to_empty(device=device)


@torch.no_grad()
def init_random(cfg: LtxVaeConfig, device, dtype=torch.bfloat16,
                generator: torch.Generator | None = None) -> LtxVaeDecoder:
    """Random-init decoder with the JAX init's std values: convs N(0, 0.05),
    linears N(0, 0.02), biases 0, scale/shift tables N(0, 1/sqrt(C)),
    timestep multiplier 1000, latent mean 0 and std 1; the noise scales
    (which the JAX init does not make) N(0, 0.02)."""
    model = empty_decoder(cfg, device, dtype)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale_shift_table":
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        elif p.dim() == 5:
            p.normal_(0.0, 0.05, generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    model.timestep_scale_multiplier.fill_(1000.0)
    model.latents_mean.zero_()
    model.latents_std.fill_(1.0)
    return model.eval()


def empty_encoder(cfg: LtxVaeConfig, device, dtype=torch.bfloat16,
                  norm_out: bool = False) -> LtxVaeEncoder:
    with torch.device("meta"):
        model = LtxVaeEncoder(cfg, dtype, norm_out)
    return model.to_empty(device=device)


@torch.no_grad()
def init_random_encoder(cfg: LtxVaeConfig, device, dtype=torch.bfloat16,
                        generator: torch.Generator | None = None) -> LtxVaeEncoder:
    """Random-init encoder with the JAX init's std values: convs N(0, 0.05),
    biases 0 (and no ``norm_out``, as the JAX init)."""
    model = empty_encoder(cfg, device, dtype)
    for name, p in model.named_parameters():
        if name.endswith(".bias"):
            p.zero_()
        else:
            p.normal_(0.0, 0.05, generator=generator)
    return model.eval()

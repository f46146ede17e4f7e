"""LTX-Video VAE decoder, dense mode, NCDHW
(``candle_video_tpu/models/ltx_video/vae.py``: ``decoder_forward``).

conv_in → mid resnets → up blocks (depth-to-space upsampler with
channel-repeat residual and causal frame crop, then timestep-conditioned
resnets) → output RMSNorm + decoder-level scale/shift modulation → SiLU →
conv_out → unpatchify.  Convolutions go through ``ops/conv3d.py``
(``torch.nn.functional.conv3d``).  Streaming, tiling and decoder noise
injection are not ported: ``decode`` raises on a streaming or tiling request.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.activations import silu
from ...ops.conv3d import causal_conv3d
from ...ops.embeddings import sinusoidal_timestep_embedding
from ...ops.norms import rms_norm
from .configs import LtxVaeConfig


class Conv3d(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(c_out, dtype=dtype))

    def forward(self, x, causal: bool):
        return causal_conv3d(x, self.weight, self.bias, causal=causal)


class TimeEmbedder(nn.Module):
    """CombinedTimestepEmbedder: sinusoid(256) → linear → SiLU → linear."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.linear_1 = nn.Linear(256, dim, dtype=dtype)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, temb, dtype):
        proj = sinusoidal_timestep_embedding(temb, 256).to(dtype)
        return self.linear_2(silu(self.linear_1(proj)))


def _ch(t):
    """[B, C] -> [B, C, 1, 1, 1] (broadcast over T, H, W)."""
    return t[:, :, None, None, None]


class ResnetBlock(nn.Module):
    """LtxVideoResnetBlock3d with a per-block [4, C] scale/shift table.  The
    decoder's resnets keep their width, so there is no shortcut conv."""

    def __init__(self, c: int, dtype, conditioned: bool):
        super().__init__()
        self.conv1 = Conv3d(c, c, 3, dtype)
        self.conv2 = Conv3d(c, c, 3, dtype)
        self.scale_shift_table = (nn.Parameter(torch.empty(4, c, dtype=dtype))
                                  if conditioned else None)

    def forward(self, x, temb, causal: bool):
        h = rms_norm(x, eps=1e-8, dim=1)
        mods = None
        if self.scale_shift_table is not None and temb is not None:
            t = temb.reshape(x.shape[0], 4, -1) + self.scale_shift_table[None].to(temb.dtype)
            mods = [_ch(t[:, i]).to(h.dtype) for i in range(4)]
        if mods:
            h = h * (1.0 + mods[1]) + mods[0]
        h = self.conv1(silu(h), causal)
        h = rms_norm(h, eps=1e-8, dim=1)
        if mods:
            h = h * (1.0 + mods[3]) + mods[2]
        return x + self.conv2(silu(h), causal)


def _depth_to_space(y, st: int, sh: int, sw: int):
    """[B, C'·st·sh·sw, T, H, W] -> [B, C', T·st, H·sh, W·sw], channel order
    c_out-major then (st, sh, sw)."""
    b, c, t, hgt, wid = y.shape
    c_out = c // (st * sh * sw)
    y = y.reshape(b, c_out, st, sh, sw, t, hgt, wid)
    y = y.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return y.reshape(b, c_out, t * st, hgt * sh, wid * sw)


class Upsampler(nn.Module):
    """LtxVideoUpsampler3d: conv → depth-to-space, plus the depth-to-space
    of the input tiled over channels, both cropped by st-1 frames."""

    def __init__(self, c_in: int, c_out: int, dtype):
        super().__init__()
        self.conv = Conv3d(c_in, c_out, 3, dtype)

    def forward(self, x, stride, residual: bool, channel_repeats: int, causal: bool):
        st, sh, sw = stride
        h = _depth_to_space(self.conv(x, causal), st, sh, sw)[:, :, st - 1:]
        if residual:
            res = _depth_to_space(x, st, sh, sw)
            if channel_repeats > 1:
                res = res.repeat(1, channel_repeats, 1, 1, 1)
            h = h + res[:, :, st - 1:]
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


def _unpatchify(x, p: int, pt: int):
    """[B, C·pt·p·p, F, H, W] -> [B, C, F·pt, H·p, W·p], channel order
    [c, pt, pw, ph]."""
    b, c, f, h, w = x.shape
    out_c = c // (pt * p * p)
    x = x.reshape(b, out_c, pt, p, p, f, h, w)
    x = x.permute(0, 1, 5, 2, 6, 4, 7, 3)
    return x.reshape(b, out_c, f * pt, h * p, w * p)


class LtxVaeDecoder(nn.Module):
    """The decoder plus the latent statistics it denormalises with."""

    def __init__(self, cfg: LtxVaeConfig, dtype=torch.bfloat16):
        super().__init__()
        if any(cfg.decoder_inject_noise):
            raise NotImplementedError(
                "the port's decoder has no noise injection; decoder_inject_noise "
                "must be all False")
        self.cfg = cfg
        tc = cfg.timestep_conditioning
        boc, sts, upr, upf = self.geometry()
        lpb = list(cfg.decoder_layers_per_block)[::-1]
        self.conv_in = Conv3d(cfg.latent_channels, boc[0], 3, dtype)
        self.mid_block = Block(
            [ResnetBlock(boc[0], dtype, tc) for _ in range(lpb[0])],
            TimeEmbedder(boc[0] * 4, dtype) if tc else None)
        ups = []
        for i in range(len(boc)):
            out_ch = boc[i] // upf[i]
            sp = 8 if sts[i] else 4
            ups.append(Block(
                [ResnetBlock(out_ch, dtype, tc) for _ in range(lpb[i + 1])],
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

    def forward(self, z, temb=None):
        """z [B, latent, F, H, W], temb [B] decode timesteps or None ->
        video [B, 3, (F-1)·8+1, H·32, W·32] in about [-1, 1]."""
        cfg = self.cfg
        causal = cfg.decoder_causal
        dtype = self.conv_in.weight.dtype
        t = None
        if temb is not None:
            t = temb.reshape(-1).float() * self.timestep_scale_multiplier.float()

        h = self.conv_in(z.to(dtype), causal)
        mt = self.mid_block.temb(t, dtype)
        for rp in self.mid_block.resnets:
            h = rp(h, mt, causal)
        boc, sts, upr, upf = self.geometry()
        for i, blk in enumerate(self.up_blocks):
            stride = (2, 2, 2) if sts[i] else (1, 2, 2)
            out_ch = boc[i] // upf[i]
            reps = out_ch * stride[0] * stride[1] * stride[2] // (out_ch * upf[i])
            h = blk.upsampler(h, stride, upr[i], reps, causal)
            ut = blk.temb(t, dtype)
            for rp in blk.resnets:
                h = rp(h, ut, causal)

        h = rms_norm(h, eps=1e-8, dim=1)
        if t is not None and self.time_embedder is not None:
            e = self.time_embedder(t, dtype).reshape(-1, 2, h.shape[1])
            e = e + self.scale_shift_table[None].to(dtype)
            h = h * (1.0 + _ch(e[:, 1])) + _ch(e[:, 0])
        h = self.conv_out(silu(h), causal)
        return _unpatchify(h, cfg.patch_size, cfg.patch_size_t)


def decode(decoder: LtxVaeDecoder, z, temb=None, *, tiling: bool = False,
           stream_chunks: int = 0):
    """Dense decode.  Tiled and streamed decoding are not ported yet."""
    if tiling or stream_chunks:
        raise NotImplementedError(
            "the port decodes densely only; tiled and streamed VAE decoding "
            "are not ported")
    return decoder(z, temb)


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
    timestep multiplier 1000, latent mean 0 and std 1."""
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

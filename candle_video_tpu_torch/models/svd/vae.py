"""AutoencoderKLTemporalDecoder (SVD) (``candle_video_tpu/models/svd/vae.py``):
the 2D SD encoder and the temporal decoder, as ``nn.Module``s with the
diffusers checkpoint's names.

The encoder's downsamplers pad (0, 1, 0, 1) and convolve with stride 2 and no
padding, as diffusers does.  The decoder's resnets blend a spatial
ResnetBlock2D with a 3×1×1 temporal block, and a final 3×1×1
``time_conv_out`` mixes the frames.  The single-head mid-block attention
(D = the block's channels) stays plain f32 torch, as the JAX package
computes it in XLA: at 576×1024 it holds 14·9216² f32 scores (4.75 GB) when
the 14 frames decode in one chunk.  The decoder's spans are the UNet's
(``resnet`` ⊃ ``temporal``, ``conv``, ``matmul``) and ``attn1`` around the
mid-block attention.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import silu
from ...utils import debug
from ...utils.device import loader_device
from .configs import SvdVaeConfig
from .loader import count_keys, load_into
from .unet import (GroupNorm, ResnetBlock2D, SpatioTemporalResBlock, Block, Sampler,
                   conv2d, init_random_, linear, temporal_conv)


class AttentionBlock(nn.Module):
    """Single-head attention over the pixels, f32 scores and softmax."""

    def __init__(self, c: int, dtype=None):
        super().__init__()
        self.group_norm = GroupNorm(32, c, eps=1e-6, dtype=dtype)
        self.to_q = nn.Linear(c, c, dtype=dtype)
        self.to_k = nn.Linear(c, c, dtype=dtype)
        self.to_v = nn.Linear(c, c, dtype=dtype)
        self.to_out = nn.ModuleList([nn.Linear(c, c, dtype=dtype)])

    def forward(self, x):
        b, c, h, w = x.shape
        with debug.span("attn1"):
            y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
            q, k, v = (linear(lin, y).float() for lin in (self.to_q, self.to_k, self.to_v))
            att = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * c ** -0.5, dim=-1)
            out = linear(self.to_out[0], torch.bmm(att, v).to(x.dtype))
            return out.transpose(1, 2).reshape(b, c, h, w) + x


class Encoder(nn.Module):
    """[B,3,H,W] -> moments [B, 2·latent, H/8, W/8]."""

    def __init__(self, cfg: SvdVaeConfig, dtype=None):
        super().__init__()
        boc = list(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1, dtype=dtype)
        self.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i, c in enumerate(boc):
            blk = Block()
            for j in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(ch if j == 0 else c, c, None, dtype))
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList([Sampler(c, 2, 0, dtype)])
            self.down_blocks.append(blk)
            ch = c
        self.mid_block = Block()
        self.mid_block.resnets.extend([ResnetBlock2D(ch, ch, None, dtype),
                                       ResnetBlock2D(ch, ch, None, dtype)])
        self.mid_block.attentions = nn.ModuleList([AttentionBlock(ch, dtype)])
        self.conv_norm_out = GroupNorm(32, ch, eps=1e-6, dtype=dtype)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        h = conv2d(self.conv_in, x)
        for blk in self.down_blocks:
            for rp in blk.resnets:
                h = rp(h)
            if blk.downsamplers is not None:
                h = conv2d(blk.downsamplers[0].conv, F.pad(h, (0, 1, 0, 1)))
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))
        return conv2d(self.conv_out, silu(self.conv_norm_out(h)))


class TemporalDecoder(nn.Module):
    """[B·T, latent, h, w] -> [B·T, 3, 8h, 8w].  ``num_mid_resnets``
    defaults to diffusers' ``layers_per_block``."""

    def __init__(self, cfg: SvdVaeConfig, dtype=None, num_mid_resnets: int | None = None):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1, dtype=dtype)
        self.mid_block = Block()
        self.mid_block.resnets.extend(
            SpatioTemporalResBlock(rev[0], rev[0], None, dtype)
            for _ in range(num_mid_resnets or cfg.layers_per_block))
        self.mid_block.attentions = nn.ModuleList([AttentionBlock(rev[0], dtype)])
        self.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, c in enumerate(rev):
            blk = Block()
            for j in range(cfg.layers_per_block + 1):
                blk.resnets.append(SpatioTemporalResBlock(ch if j == 0 else c, c, None, dtype))
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Sampler(c, 1, 1, dtype)])
            self.up_blocks.append(blk)
            ch = c
        self.conv_norm_out = GroupNorm(32, rev[-1], eps=1e-6, dtype=dtype)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1, dtype=dtype)
        self.time_conv_out = nn.Conv3d(cfg.out_channels, cfg.out_channels, (3, 1, 1),
                                       padding=(1, 0, 0), dtype=dtype)

    def forward(self, z, num_frames: int):
        h = conv2d(self.conv_in, z)
        mid = self.mid_block
        h = mid.resnets[0](h, None, num_frames)
        for attn, rp in zip(mid.attentions, mid.resnets[1:]):
            h = rp(attn(h), None, num_frames)
        for blk in self.up_blocks:
            for rp in blk.resnets:
                h = rp(h, None, num_frames)
            if blk.upsamplers is not None:
                h = conv2d(blk.upsamplers[0].conv, F.interpolate(h, scale_factor=2.0,
                                                                 mode="nearest"))
        h = conv2d(self.conv_out, silu(self.conv_norm_out(h)))
        return temporal_conv(self.time_conv_out, h, num_frames)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, cfg: SvdVaeConfig, dtype=torch.bfloat16,
                 num_mid_resnets: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, dtype)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1,
                                    dtype=dtype)
        self.decoder = TemporalDecoder(cfg, dtype, num_mid_resnets)


def encoder_forward(vae: AutoencoderKLTemporalDecoder, x):
    """[B,3,H,W] -> moments [B, 2·latent, H/8, W/8] (before ``quant_conv``)."""
    return vae.encoder(x)


def decoder_forward(vae: AutoencoderKLTemporalDecoder, z, num_frames: int):
    """[B·T, latent, h, w] -> [B·T, 3, 8h, 8w]."""
    return vae.decoder(z, num_frames)


def encode_to_latent(vae: AutoencoderKLTemporalDecoder, x, noise=None):
    """The scaled latent of x: the posterior mean, or ``mean + std·noise``
    with a standard-normal ``noise``."""
    moments = conv2d(vae.quant_conv, encoder_forward(vae, x))
    c = moments.shape[1] // 2
    mean, logvar = moments[:, :c], moments[:, c:]
    z = mean if noise is None else mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
    return z * vae.cfg.scaling_factor


def decode(vae: AutoencoderKLTemporalDecoder, z, num_frames: int, chunk_size=None):
    """Unscale and decode ``[B·T, latent, h, w]`` in chunks of ``chunk_size``
    frames (all at once when None)."""
    z = z / vae.cfg.scaling_factor
    bt = z.shape[0]
    chunk_size = chunk_size or bt
    chunks = []
    for start in range(0, bt, chunk_size):
        end = min(start + chunk_size, bt)
        chunks.append(decoder_forward(vae, z[start:end], min(end - start, num_frames)))
    return torch.cat(chunks) if len(chunks) > 1 else chunks[0]


def empty_vae(cfg: SvdVaeConfig, device, dtype=torch.bfloat16,
              num_mid_resnets: int | None = None):
    with torch.device("meta"):
        vae = AutoencoderKLTemporalDecoder(cfg, dtype, num_mid_resnets)
    return vae.to_empty(device=device)


def init_random(cfg: SvdVaeConfig, device, dtype=torch.bfloat16,
                generator: torch.Generator | None = None):
    """A random-weight VAE on ``device`` (``unet.init_random_``)."""
    return init_random_(empty_vae(cfg, device, dtype), generator)


@torch.no_grad()
def vae_params_from_state_dict(sd: Dict[str, torch.Tensor], cfg: SvdVaeConfig | None = None,
                               device="cuda", dtype=torch.float32):
    """A diffusers AutoencoderKLTemporalDecoder state dict (name -> tensor
    or numpy) -> the module on ``device`` (the GPU unless told otherwise)
    in ``dtype``; the decoder's mid-block resnet count is read from the
    names."""
    device = loader_device(device)
    n_mid = count_keys(sd, "decoder.mid_block.resnets.{}.spatial_res_block.conv1.weight")
    return load_into(empty_vae(cfg or SvdVaeConfig(), device, dtype, n_mid), sd)

"""SVD UNet spatio-temporal condition model
(``candle_video_tpu/models/svd/unet.py``) as ``nn.Module``s.

Spatio-temporal resnets (a spatial ResnetBlock2D, then a temporal 3×1×1-conv
block, blended by a learned sigmoid mix), spatio-temporal transformers
(spatial block → + frame-position embedding → temporal block over the frame
axis → learned time mixer), cross-attention on the CLIP image embedding and
the fps / motion / noise-aug added-time conditioning.  Tensors ride a fused
``[B·T, C, H, W]`` layout.

Module and parameter names are the diffusers checkpoint's
(``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_out.0.weight``),
so ``loader.unet_params_from_state_dict`` is a ``load_state_dict``.

The JAX UNet pins its attention to plain XLA; here every attention goes
through the port's ``attention()`` dispatch, as the JAX
``attention(impl="pallas")`` would route it: at 576×1024 the level-0 spatial
self-attention (5 heads of 64, not lane-packable) takes K6, levels 1 and 2
(10 and 20 heads, more than 512 tokens) take K1, and the temporal (14
frames), cross (1 token) and mid-block (144 tokens) attention the plain
path.

While ``utils.debug`` records spans, each spatio-temporal resnet is a
``resnet`` span holding a ``temporal`` one around its temporal block, each
spatial transformer block opens ``attn1``, ``attn2`` and ``ff``, each temporal
transformer block is a ``temporal`` span, and every linear and conv a
``matmul`` or ``conv`` leaf (``linear``, ``conv2d``, ``temporal_conv``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import gelu, silu
from ...ops.attention import attention
from ...ops.embeddings import sinusoidal_timestep_embedding
from ...ops.norms import group_norm, layer_norm
from ...utils import debug
from .configs import SvdUnetConfig


def timestep_embedding(t, dim: int):
    """SVD sinusoid: downscale_freq_shift 1, [cos, sin]."""
    return sinusoidal_timestep_embedding(t, dim, downscale_freq_shift=1.0)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm``'s parameters with the JAX package's numerics (f32
    statistics, the affine in x's dtype)."""

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm``'s parameters with the JAX package's numerics."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def linear(lin: nn.Linear, x):
    """``lin(x)``; while spans are recorded, the product is a ``matmul``
    span.  The flag is tested here first: off, that is all it costs."""
    if debug.RECORDING:
        with debug.span("matmul"):
            return lin(x)
    return lin(x)


def _conv(conv, x):
    """``conv(x)``; while spans are recorded, a ``conv`` span."""
    if debug.RECORDING:
        with debug.span("conv"):
            return conv(x)
    return conv(x)


def conv2d(conv: nn.Conv2d, x):
    """``conv`` on x cast to the weight's dtype."""
    return _conv(conv, x.to(conv.weight.dtype))


def temporal_conv(conv: nn.Conv3d, x, num_frames: int):
    """The 3×1×1 temporal conv on ``[B·T, C, H, W]``, as one conv3d over
    ``[B, C, T, H, W]``; the output in x's dtype."""
    bt, c, hgt, wid = x.shape
    b = bt // num_frames
    x5 = x.to(conv.weight.dtype).reshape(b, num_frames, c, hgt, wid).transpose(1, 2)
    out = _conv(conv, x5).transpose(1, 2)
    return out.reshape(bt, -1, hgt, wid).to(x.dtype)


class TimestepEmbedding(nn.Module):
    def __init__(self, d_in: int, d: int, d_out: int | None = None, dtype=None):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d, dtype=dtype)
        self.linear_2 = nn.Linear(d, d_out or d, dtype=dtype)

    def forward(self, x):
        return linear(self.linear_2, silu(linear(self.linear_1, x)))


class ResnetBlock2D(nn.Module):
    """GroupNorm → SiLU → 3×3 conv (+ time projection) → GroupNorm → SiLU →
    3×3 conv, plus the (1×1-projected) input; ``temb_channels`` None for the
    VAE's blocks."""

    def __init__(self, c_in: int, c_out: int, temb_channels: int | None, dtype=None):
        super().__init__()
        self.norm1 = GroupNorm(32, c_in, eps=1e-6, dtype=dtype)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1, dtype=dtype)
        self.time_emb_proj = (None if temb_channels is None
                              else nn.Linear(temb_channels, c_out, dtype=dtype))
        self.norm2 = GroupNorm(32, c_out, eps=1e-6, dtype=dtype)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1, dtype=dtype)
        self.conv_shortcut = (nn.Conv2d(c_in, c_out, 1, dtype=dtype) if c_in != c_out
                              else None)

    def forward(self, x, temb=None):
        h = conv2d(self.conv1, silu(self.norm1(x)))
        if temb is not None and self.time_emb_proj is not None:
            h = h + linear(self.time_emb_proj, silu(temb))[:, :, None, None]
        h = conv2d(self.conv2, silu(self.norm2(h)))
        res = x if self.conv_shortcut is None else conv2d(self.conv_shortcut, x)
        return h + res


class TemporalResnetBlock(nn.Module):
    """ResnetBlock2D with 3×1×1 temporal convs, input = output channels."""

    def __init__(self, c: int, temb_channels: int | None, dtype=None):
        super().__init__()
        self.norm1 = GroupNorm(32, c, eps=1e-6, dtype=dtype)
        self.conv1 = nn.Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0), dtype=dtype)
        self.time_emb_proj = (None if temb_channels is None
                              else nn.Linear(temb_channels, c, dtype=dtype))
        self.norm2 = GroupNorm(32, c, eps=1e-6, dtype=dtype)
        self.conv2 = nn.Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0), dtype=dtype)

    def forward(self, x, temb, num_frames: int):
        h = temporal_conv(self.conv1, silu(self.norm1(x)), num_frames)
        if temb is not None and self.time_emb_proj is not None:
            h = h + linear(self.time_emb_proj, silu(temb))[:, :, None, None]
        h = temporal_conv(self.conv2, silu(self.norm2(h)), num_frames)
        return h + x


class AlphaBlender(nn.Module):
    """The learned sigmoid mix of a spatial and a temporal branch."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.empty(1, dtype=torch.float32))

    def forward(self, spatial, temporal, temporal_first: bool = False):
        """``temporal_first`` False: alpha·spatial + (1-alpha)·temporal (the
        resnets); True: alpha·temporal + (1-alpha)·spatial (the transformer's
        time mixer)."""
        alpha = torch.sigmoid(self.mix_factor.float()).to(spatial.dtype)
        if temporal_first:
            return temporal * alpha + spatial * (1.0 - alpha)
        return spatial * alpha + temporal * (1.0 - alpha)


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, temb_channels: int | None, dtype=None):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(c_in, c_out, temb_channels, dtype)
        self.temporal_res_block = TemporalResnetBlock(c_out, temb_channels, dtype)
        self.time_mixer = AlphaBlender()

    def forward(self, x, temb, num_frames: int):
        with debug.span("resnet"):
            hs = self.spatial_res_block(x, temb)
            with debug.span("temporal"):
                ht = self.temporal_res_block(hs, temb, num_frames)
            return self.time_mixer(hs, ht)


class Attention(nn.Module):
    """Multi-head attention, bias-less q/k/v projections, through the port's
    ``attention()`` dispatch."""

    def __init__(self, dim: int, heads: int, kv_dim: int | None = None, dtype=None):
        super().__init__()
        self.heads = heads
        kv_dim = kv_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False, dtype=dtype)
        self.to_k = nn.Linear(kv_dim, dim, bias=False, dtype=dtype)
        self.to_v = nn.Linear(kv_dim, dim, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim, dtype=dtype)])

    def forward(self, x, context=None):
        b, s, d = x.shape
        ctx = x if context is None else context
        h, hd = self.heads, d // self.heads
        q = linear(self.to_q, x).reshape(b, s, h, hd)
        k = linear(self.to_k, ctx).reshape(b, ctx.shape[1], h, hd)
        v = linear(self.to_v, ctx).reshape(b, ctx.shape[1], h, hd)
        out = attention(q, k, v, 1.0 / math.sqrt(hd))
        return linear(self.to_out[0], out.reshape(b, s, d))


class GEGLU(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype=None):
        super().__init__()
        self.proj = nn.Linear(d_in, 2 * d_out, dtype=dtype)

    def forward(self, x):
        gate, value = linear(self.proj, x).chunk(2, dim=-1)
        return gelu(gate) * value


class FeedForward(nn.Module):
    """GEGLU (exact GELU) feed-forward, 4× inner width."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim, dtype), nn.Identity(),
                                  nn.Linear(4 * dim, dim, dtype=dtype)])

    def forward(self, x):
        return linear(self.net[2], self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross_dim: int, dtype=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.attn1 = Attention(dim, heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.attn2 = Attention(dim, heads, cross_dim, dtype)
        self.norm3 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.ff = FeedForward(dim, dtype)

    def forward(self, x, context):
        with debug.span("attn1"):
            x = x + self.attn1(self.norm1(x))
        with debug.span("attn2"):
            x = x + self.attn2(self.norm2(x), context)
        with debug.span("ff"):
            return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    """The block over the frame axis: ``[B·T, S, D]`` → ``[B·S, T, D]``."""

    def __init__(self, dim: int, heads: int, cross_dim: int, dtype=None):
        super().__init__()
        self.norm_in = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.ff_in = FeedForward(dim, dtype)
        self.norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.attn1 = Attention(dim, heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.attn2 = Attention(dim, heads, cross_dim, dtype)
        self.norm3 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.ff = FeedForward(dim, dtype)

    def forward(self, x, time_context, num_frames: int):
        bt, s, d = x.shape
        b = bt // num_frames
        with debug.span("temporal"):
            h = x.reshape(b, num_frames, s, d).transpose(1, 2).reshape(b * s, num_frames, d)
            h = h + self.ff_in(self.norm_in(h))
            h = h + self.attn1(self.norm1(h))
            h = h + self.attn2(self.norm2(h), time_context)
            h = h + self.ff(self.norm3(h))
            return h.reshape(b, s, num_frames, d).transpose(1, 2).reshape(bt, s, d)


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(self, dim: int, heads: int, cross_dim: int, num_layers: int = 1,
                 dtype=None):
        super().__init__()
        self.norm = GroupNorm(32, dim, eps=1e-6, dtype=dtype)
        self.proj_in = nn.Linear(dim, dim, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(dim, heads, cross_dim, dtype) for _ in range(num_layers))
        self.temporal_transformer_blocks = nn.ModuleList(
            TemporalBasicTransformerBlock(dim, heads, cross_dim, dtype)
            for _ in range(num_layers))
        self.time_pos_embed = TimestepEmbedding(dim, 4 * dim, dim, dtype)
        self.time_mixer = AlphaBlender()
        self.proj_out = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, x, context, num_frames: int):
        bt, c, hgt, wid = x.shape
        b = bt // num_frames
        residual = x

        time_context = None
        if context is not None:
            d = context.shape[-1]
            first = context.reshape(b, num_frames, -1, d)[:, 0]  # [B, L, D]
            time_context = first[:, None].expand(b, hgt * wid, *first.shape[1:]).reshape(
                b * hgt * wid, -1, d)

        h = self.norm(x).reshape(bt, c, hgt * wid).transpose(1, 2)
        h = linear(self.proj_in, h)

        frame_idx = torch.arange(num_frames, dtype=torch.float32, device=x.device).repeat(b)
        emb = self.time_pos_embed(timestep_embedding(frame_idx, c).to(h.dtype))[:, None, :]

        for sp, tp in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h_spatial = sp(h, context)
            h_temporal = tp(h_spatial + emb, time_context, num_frames)
            h = self.time_mixer(h_spatial, h_temporal, temporal_first=True)

        h = linear(self.proj_out, h)
        return h.transpose(1, 2).reshape(bt, c, hgt, wid) + residual


class Sampler(nn.Module):
    """The 3×3 conv of a downsampler (stride 2) or upsampler (stride 1)."""

    def __init__(self, c: int, stride: int, padding: int = 1, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=stride, padding=padding, dtype=dtype)


class Block(nn.Module):
    """One down or up block: resnets, optional transformers, optional
    down- or upsampler."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = None
        self.downsamplers = None
        self.upsamplers = None


class UNetSpatioTemporalConditionModel(nn.Module):
    """The diffusers UNetSpatioTemporalConditionModel layout built from
    ``SvdUnetConfig``: down blocks with transformers except the last, a mid
    block of two resnets around one transformer, up blocks with
    ``layers_per_block + 1`` resnets and transformers except the first."""

    def __init__(self, cfg: SvdUnetConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        boc, heads = list(cfg.block_out_channels), cfg.num_attention_heads
        ted = 4 * boc[0]
        cross, layers = cfg.cross_attention_dim, cfg.transformer_layers_per_block

        def st_transformer(c, n_heads):
            return TransformerSpatioTemporalModel(c, n_heads, cross, layers, dtype)

        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1, dtype=dtype)
        self.time_embedding = TimestepEmbedding(boc[0], ted, dtype=dtype)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                               ted, dtype=dtype)

        self.down_blocks = nn.ModuleList()
        ch, skips = boc[0], [boc[0]]
        for i, c in enumerate(boc):
            last = i == len(boc) - 1
            blk = Block()
            if not last:
                blk.attentions = nn.ModuleList()
            for j in range(cfg.layers_per_block):
                blk.resnets.append(SpatioTemporalResBlock(ch if j == 0 else c, c, ted, dtype))
                if not last:
                    blk.attentions.append(st_transformer(c, heads[i]))
                skips.append(c)
            if not last:
                blk.downsamplers = nn.ModuleList([Sampler(c, 2, dtype=dtype)])
                skips.append(c)
            self.down_blocks.append(blk)
            ch = c

        self.mid_block = Block()
        self.mid_block.resnets.extend([SpatioTemporalResBlock(ch, ch, ted, dtype),
                                       SpatioTemporalResBlock(ch, ch, ted, dtype)])
        self.mid_block.attentions = nn.ModuleList([st_transformer(ch, heads[-1])])

        self.up_blocks = nn.ModuleList()
        rev_heads, rev_boc = tuple(reversed(heads)), list(reversed(boc))
        for i, c in enumerate(rev_boc):
            blk = Block()
            if i > 0:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(SpatioTemporalResBlock(ch + skips.pop(), c, ted, dtype))
                ch = c
                if i > 0:
                    blk.attentions.append(st_transformer(c, rev_heads[i]))
            if i < len(rev_boc) - 1:
                blk.upsamplers = nn.ModuleList([Sampler(c, 1, dtype=dtype)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(32, boc[0], eps=1e-6, dtype=dtype)
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1, dtype=dtype)

    def forward(self, sample, timestep, encoder_hidden_states, added_time_ids,
                num_frames: int):
        """sample [B·T, in_channels, H, W], timestep [B] or scalar (the
        continuous 0.25·ln σ), CLIP embeddings [B·T, L, cross_dim], added
        time ids [B, 3] (fps - 1, motion bucket, noise-aug strength) ->
        [B·T, out_channels, H, W] in the model dtype."""
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        b = sample.shape[0] // num_frames

        t = torch.as_tensor(timestep, dtype=torch.float32, device=sample.device)
        t = t.reshape(-1).expand(b)
        emb = self.time_embedding(timestep_embedding(t, cfg.block_out_channels[0]).to(dtype))
        ids = added_time_ids.float()
        aug = torch.cat([timestep_embedding(ids[:, i], cfg.addition_time_embed_dim)
                         for i in range(3)], dim=-1).to(dtype)
        emb = (emb + self.add_embedding(aug)).repeat_interleave(num_frames, dim=0)
        ctx = encoder_hidden_states.to(dtype)

        h = conv2d(self.conv_in, sample)
        res_stack = [h]
        for blk in self.down_blocks:
            for j, rp in enumerate(blk.resnets):
                h = rp(h, emb, num_frames)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, ctx, num_frames)
                res_stack.append(h)
            if blk.downsamplers is not None:
                h = conv2d(blk.downsamplers[0].conv, h)
                res_stack.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, emb, num_frames)
        h = mid.attentions[0](h, ctx, num_frames)
        h = mid.resnets[1](h, emb, num_frames)

        for blk in self.up_blocks:
            for j, rp in enumerate(blk.resnets):
                h = rp(torch.cat([h, res_stack.pop()], dim=1), emb, num_frames)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, ctx, num_frames)
            if blk.upsamplers is not None:
                h = conv2d(blk.upsamplers[0].conv, F.interpolate(h, scale_factor=2.0,
                                                                 mode="nearest"))

        h = self.conv_norm_out(h)
        return conv2d(self.conv_out, silu(h))


def empty_unet(cfg: SvdUnetConfig, device, dtype=torch.bfloat16):
    """The module with uninitialised storage on ``device``."""
    with torch.device("meta"):
        model = UNetSpatioTemporalConditionModel(cfg, dtype)
    return model.to_empty(device=device)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Random weights in place: every weight of two or more dims N(0,
    1/fan_in), other vectors (CLIP's class embedding) N(0, 0.02), biases 0,
    norm weights 1, mixing factors 0.5 (an even blend)."""
    norms = tuple(m for m in model.modules() if isinstance(m, (nn.GroupNorm, nn.LayerNorm)))
    norm_weights = {id(m.weight) for m in norms}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "mix_factor":
            p.fill_(0.5)
        elif id(p) in norm_weights:
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif p.ndim >= 2:
            p.normal_(0.0, math.prod(p.shape[1:]) ** -0.5, generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model.eval()


def init_random(cfg: SvdUnetConfig, device, dtype=torch.bfloat16,
                generator: torch.Generator | None = None):
    """A random-weight UNet on ``device`` (``init_random_``)."""
    return init_random_(empty_unet(cfg, device, dtype), generator)

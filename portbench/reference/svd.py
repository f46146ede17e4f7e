"""A plain PyTorch Stable Video Diffusion image-to-video request, the
yardstick of the ``svd`` family's `correct`.

It follows diffusers' ``StableVideoDiffusionPipeline`` with its
``UNetSpatioTemporalConditionModel``, ``AutoencoderKLTemporalDecoder``,
``CLIPVisionModelWithProjection`` and ``EulerDiscreteScheduler`` (Karras
sigmas, v-prediction, continuous timesteps): the CLIP embedding of the
image (zeros for the unconditional rows), the noise-augmented image encoded
to the posterior's mode and left unscaled as the conditioning latents, the
added time ids (fps − 1, motion bucket, noise augmentation), the per-frame
guidance ramp, the Euler loop and the decode of all frames at once.  It
reads the raw weights that ``families/svd.py`` makes, by their checkpoint
names (``unet/``, ``vae/``, ``image_encoder/`` and the name in that
component's file), and imports nothing of the program under test.  The
noise is ``jax.random.normal`` of the keys ``split(PRNGKey(seed), 3)``
(``rng.py``): the image noise from the second, the initial latents from
the third.

Everything runs in float32 with TF32 off (``Precision("f32")``); attention
takes blocks of (row, head) pairs whose scores fit in ``SCORE_BUDGET``
elements (the level-0 scores of a request, 28·5·9216² in float32, are
47.6 GB whole).  ``Precision("fp8")`` is the control: every UNet linear and
conv and every decoder conv takes float8 e4m3 operands (a scale per token or
pixel and per output channel), the products summed in float32.

Departures from diffusers.  Where the system under test (the JAX package
this port is held to) defines the model otherwise, the reference computes
the system's definition, so that a fault and not a convention shows in the
check; a run from a published checkpoint would need the system to follow
diffusers at each of these points first:

- the sinusoids (timestep, added time ids, frame positions) divide the
  exponent by half the width less one (diffusers' ``Timesteps`` here: by
  half the width, ``downscale_freq_shift=0``);
- the GEGLU feed-forwards take the GELU of the first half of the projection
  times the second (diffusers: the first half times the GELU of the
  second);
- the transformers' time mixer weights the temporal branch by
  sigmoid(mix_factor) (diffusers: the spatial branch);
- the decoder's resnets weight the spatial branch by sigmoid(mix_factor)
  (diffusers sets ``switch_spatial_to_temporal_mix`` there: the temporal
  branch);
- the temporal resnets' GroupNorms take their statistics frame by frame
  (diffusers normalises the clip's five-dimensional tensor: over all
  frames);
- the CLIP MLPs take quick-GELU (the image encoder's config names ``gelu``);
- the CLIP input is resized by the antialiased triangle-filter bilinear
  (``resize_bilinear``), not diffusers' ``_resize_with_antialiasing``
  (a Gaussian blur, then bicubic).

Norm epsilons are the system's (GroupNorm 1e-6, LayerNorm 1e-5).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from . import rng

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
SCORE_BUDGET = 1 << 28  # f32 attention scores held at once (1 GiB)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _fp8(x, dim):
    """x rounded through float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(FP8).float() * scale


class Precision:
    """``f32``: the reference; ``fp8``: the control (see the module note).
    ``low`` False keeps a call in float32 under either mode (the parts the
    control leaves alone)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision {mode!r}")
        self.mode = mode

    def linear(self, x, w, b=None, low=True):
        """x [..., K], w [N, K] -> [..., N]."""
        if low and self.mode == "fp8":
            x, w = _fp8(x, -1), _fp8(w, -1)
        y = x @ w.t()
        return y if b is None else y + b

    def conv(self, x, w, b=None, low=True, **kw):
        """conv2d (w [O, C, kh, kw]) or conv3d (w [O, C, kt, kh, kw])."""
        if low and self.mode == "fp8":
            x = _fp8(x, 1)
            w = _fp8(w.flatten(1), -1).view_as(w)
        return (F.conv2d if w.ndim == 4 else F.conv3d)(x, w, b, **kw)


F32 = Precision("f32")


def reference_settings():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Weights:
    """One component's raw weights as float32, by the name in its file."""

    def __init__(self, raw: Mapping, component: str):
        self.raw, self.pre = raw, component + "/"

    def __call__(self, name):
        return self.raw[self.pre + name].float()

    def has(self, name):
        return self.pre + name in self.raw

    def bias(self, name):
        return self(name) if self.has(name) else None


def sinusoid(t, dim):
    """[N] -> [N, dim] f32: [cos, sin] of t·10000**(-i/(half - 1))."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64,
                                                       device=t.device) / (half - 1))
    ang = t.double()[:, None] * freq[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).float()


def group_norm(w, p, x, eps=1e-6):
    return F.group_norm(x, 32, w(f"{p}.weight"), w(f"{p}.bias"), eps)


def layer_norm(w, p, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], w(f"{p}.weight"), w(f"{p}.bias"), eps)


def lin(w, p, x, prec=F32, low=True):
    return prec.linear(x, w(f"{p}.weight"), w.bias(f"{p}.bias"), low)


def conv(w, p, x, prec=F32, low=True, **kw):
    return prec.conv(x, w(f"{p}.weight"), w.bias(f"{p}.bias"), low, **kw)


def attend(q, k, v, heads):
    """softmax(q kᵀ/sqrt(d)) v over [N, S, H·D], in blocks of (row, head)
    pairs whose scores fit in ``SCORE_BUDGET``."""
    n, s, c = q.shape
    kv, d = k.shape[1], c // heads
    q, k, v = (t.reshape(n, -1, heads, d).transpose(1, 2).reshape(n * heads, -1, d)
               for t in (q, k, v))
    out = torch.empty_like(q)
    per = max(1, SCORE_BUDGET // (s * kv))
    for i in range(0, n * heads, per):
        sc = q[i:i + per] @ k[i:i + per].transpose(-1, -2) * d ** -0.5
        out[i:i + per] = torch.softmax(sc, -1) @ v[i:i + per]
        del sc
    return out.reshape(n, heads, s, d).transpose(1, 2).reshape(n, s, c)


# ---------------------------------------------------------------------------
# resnets
# ---------------------------------------------------------------------------


def resnet2d(w, p, x, temb, prec, low=True):
    """GroupNorm, SiLU, 3x3 conv (+ the time projection), GroupNorm, SiLU,
    3x3 conv, plus the (1x1-projected) input; [N, C, H, W]."""
    h = conv(w, f"{p}.conv1", F.silu(group_norm(w, f"{p}.norm1", x)), prec, low, padding=1)
    if temb is not None:
        h = h + lin(w, f"{p}.time_emb_proj", F.silu(temb), prec, low)[:, :, None, None]
    h = conv(w, f"{p}.conv2", F.silu(group_norm(w, f"{p}.norm2", h)), prec, low, padding=1)
    if w.has(f"{p}.conv_shortcut.weight"):
        x = conv(w, f"{p}.conv_shortcut", x, prec, low)
    return x + h


def temporal_conv(w, p, x, frames, prec, low=True):
    """The 3x1x1 conv over the frames of [B·F, C, H, W]."""
    n, c, hh, ww = x.shape
    x5 = x.reshape(n // frames, frames, c, hh, ww).transpose(1, 2)
    y = conv(w, p, x5, prec, low, padding=(1, 0, 0))
    return y.transpose(1, 2).reshape(n, -1, hh, ww)


def temporal_resnet(w, p, x, temb, frames, prec):
    h = temporal_conv(w, f"{p}.conv1", F.silu(group_norm(w, f"{p}.norm1", x)), frames, prec)
    if temb is not None:
        h = h + lin(w, f"{p}.time_emb_proj", F.silu(temb), prec)[:, :, None, None]
    h = temporal_conv(w, f"{p}.conv2", F.silu(group_norm(w, f"{p}.norm2", h)), frames, prec)
    return x + h


def blend(w, p, first, second):
    """sigmoid(mix_factor)·first + (1 - sigmoid(mix_factor))·second."""
    a = torch.sigmoid(w(f"{p}.mix_factor"))
    return a * first + (1.0 - a) * second


def st_resnet(w, p, x, temb, frames, prec):
    """A spatial resnet, its temporal block, the learned mix weighting the
    spatial branch (see the module note for the decoder's)."""
    hs = resnet2d(w, f"{p}.spatial_res_block", x, temb, prec)
    ht = temporal_resnet(w, f"{p}.temporal_res_block", hs, temb, frames, prec)
    return blend(w, f"{p}.time_mixer", hs, ht)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def attention(w, p, x, ctx, heads, prec):
    q = lin(w, f"{p}.to_q", x, prec)
    k = lin(w, f"{p}.to_k", ctx, prec)
    v = lin(w, f"{p}.to_v", ctx, prec)
    return lin(w, f"{p}.to_out.0", attend(q, k, v, heads), prec)


def geglu(w, p, x, prec):
    gate, value = lin(w, f"{p}.net.0.proj", x, prec).chunk(2, dim=-1)
    return lin(w, f"{p}.net.2", F.gelu(gate) * value, prec)


def spatial_block(w, p, x, ctx, heads, prec):
    x = x + _self(w, f"{p}.attn1", layer_norm(w, f"{p}.norm1", x), heads, prec)
    x = x + attention(w, f"{p}.attn2", layer_norm(w, f"{p}.norm2", x), ctx, heads, prec)
    return x + geglu(w, f"{p}.ff", layer_norm(w, f"{p}.norm3", x), prec)


def _self(w, p, x, heads, prec):
    return attention(w, p, x, x, heads, prec)


def temporal_block(w, p, x, time_ctx, frames, heads, prec):
    """[B·F, S, C] -> the same, attending over the frames of each token."""
    n, s, c = x.shape
    h = x.reshape(n // frames, frames, s, c).transpose(1, 2).reshape(-1, frames, c)
    h = h + geglu(w, f"{p}.ff_in", layer_norm(w, f"{p}.norm_in", h), prec)
    h = h + _self(w, f"{p}.attn1", layer_norm(w, f"{p}.norm1", h), heads, prec)
    h = h + attention(w, f"{p}.attn2", layer_norm(w, f"{p}.norm2", h), time_ctx, heads, prec)
    h = h + geglu(w, f"{p}.ff", layer_norm(w, f"{p}.norm3", h), prec)
    return h.reshape(n // frames, s, frames, c).transpose(1, 2).reshape(n, s, c)


def st_transformer(w, p, x, ctx, frames, heads, prec):
    """TransformerSpatioTemporalModel over [B·F, C, H, W]; ``ctx`` [B·F,
    L, D] (the temporal blocks take each clip's first frame's)."""
    n, c, hh, ww = x.shape
    b = n // frames
    first = ctx.reshape(b, frames, -1, ctx.shape[-1])[:, 0]
    time_ctx = first[:, None].expand(b, hh * ww, *first.shape[1:]).reshape(
        b * hh * ww, -1, ctx.shape[-1])
    h = group_norm(w, f"{p}.norm", x).reshape(n, c, hh * ww).transpose(1, 2)
    h = lin(w, f"{p}.proj_in", h, prec)
    pos = torch.arange(frames, dtype=torch.float32, device=x.device).repeat(b)
    emb = lin(w, f"{p}.time_pos_embed.linear_2",
              F.silu(lin(w, f"{p}.time_pos_embed.linear_1", sinusoid(pos, c), prec)),
              prec)[:, None]
    hs = spatial_block(w, f"{p}.transformer_blocks.0", h, ctx, heads, prec)
    ht = temporal_block(w, f"{p}.temporal_transformer_blocks.0", hs + emb, time_ctx, frames,
                        heads, prec)
    h = blend(w, f"{p}.time_mixer", ht, hs)  # the system's order: see the module note
    h = lin(w, f"{p}.proj_out", h, prec)
    return h.transpose(1, 2).reshape(n, c, hh, ww) + x


def unet(raw, cfg: Mapping, prec, sample, t, ctx, time_ids, frames):
    """sample [B·F, 8, h, w], t [B] (0.25·ln sigma), ctx [B·F, 1, cross],
    time ids [B, 3] -> v [B·F, 4, h, w] f32."""
    w = _Weights(raw, "unet")
    boc, heads = list(cfg["block_out_channels"]), list(cfg["num_attention_heads"])
    lpb, n_levels = cfg["layers_per_block"], len(boc)
    temb = lin(w, "time_embedding.linear_2",
               F.silu(lin(w, "time_embedding.linear_1", sinusoid(t, boc[0]), prec)), prec)
    aug = torch.cat([sinusoid(time_ids[:, i], cfg["addition_time_embed_dim"])
                     for i in range(3)], dim=-1)
    temb = temb + lin(w, "add_embedding.linear_2",
                      F.silu(lin(w, "add_embedding.linear_1", aug, prec)), prec)
    temb = temb.repeat_interleave(frames, dim=0)

    h = conv(w, "conv_in", sample, prec, padding=1)
    skips = [h]
    for i in range(n_levels):
        p = f"down_blocks.{i}"
        for j in range(lpb):
            h = st_resnet(w, f"{p}.resnets.{j}", h, temb, frames, prec)
            if i < n_levels - 1:
                h = st_transformer(w, f"{p}.attentions.{j}", h, ctx, frames, heads[i], prec)
            skips.append(h)
        if i < n_levels - 1:
            h = conv(w, f"{p}.downsamplers.0.conv", h, prec, stride=2, padding=1)
            skips.append(h)
    h = st_resnet(w, "mid_block.resnets.0", h, temb, frames, prec)
    h = st_transformer(w, "mid_block.attentions.0", h, ctx, frames, heads[-1], prec)
    h = st_resnet(w, "mid_block.resnets.1", h, temb, frames, prec)
    for i in range(n_levels):
        p = f"up_blocks.{i}"
        for j in range(lpb + 1):
            h = st_resnet(w, f"{p}.resnets.{j}", torch.cat([h, skips.pop()], 1), temb, frames,
                          prec)
            if i > 0:
                h = st_transformer(w, f"{p}.attentions.{j}", h, ctx, frames,
                                   heads[n_levels - 1 - i], prec)
        if i < n_levels - 1:
            h = conv(w, f"{p}.upsamplers.0.conv", F.interpolate(h, scale_factor=2.0,
                                                                 mode="nearest"),
                     prec, padding=1)
    h = F.silu(group_norm(w, "conv_norm_out", h))
    return conv(w, "conv_out", h, prec, padding=1)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def vae_attention(w, p, x, prec, low):
    """The single-head mid-block attention over each frame's pixels, with
    its residual; in blocks of frames."""
    n, c, hh, ww = x.shape
    y = group_norm(w, f"{p}.group_norm", x).reshape(n, c, hh * ww).transpose(1, 2)
    q, k, v = (lin(w, f"{p}.{m}", y, prec, low) for m in ("to_q", "to_k", "to_v"))
    out = lin(w, f"{p}.to_out.0", attend(q, k, v, 1), prec, low)
    return out.transpose(1, 2).reshape(n, c, hh, ww) + x


def vae_encode(raw, cfg: Mapping, x):
    """[B, 3, H, W] in about [-1, 1] -> the posterior's mode [B, latent,
    H/8, W/8] (unscaled), all in float32."""
    w = _Weights(raw, "vae")
    boc, lpb = list(cfg["block_out_channels"]), cfg["layers_per_block"]
    h = conv(w, "encoder.conv_in", x, F32, padding=1)
    for i in range(len(boc)):
        p = f"encoder.down_blocks.{i}"
        for j in range(lpb):
            h = resnet2d(w, f"{p}.resnets.{j}", h, None, F32)
        if i < len(boc) - 1:
            h = conv(w, f"{p}.downsamplers.0.conv", F.pad(h, (0, 1, 0, 1)), F32, stride=2)
    h = resnet2d(w, "encoder.mid_block.resnets.0", h, None, F32)
    h = vae_attention(w, "encoder.mid_block.attentions.0", h, F32, False)
    h = resnet2d(w, "encoder.mid_block.resnets.1", h, None, F32)
    h = conv(w, "encoder.conv_out", F.silu(group_norm(w, "encoder.conv_norm_out", h)), F32,
             padding=1)
    moments = conv(w, "quant_conv", h, F32)
    return moments[:, :cfg["latent_channels"]]


def vae_decode(raw, cfg: Mapping, z, frames, prec):
    """z [B·F, latent, h, w] (unscaled) -> [B·F, 3, 8h, 8w] in about [-1, 1]."""
    w = _Weights(raw, "vae")
    rev, lpb = list(cfg["block_out_channels"])[::-1], cfg["layers_per_block"]
    h = conv(w, "decoder.conv_in", z, prec, padding=1)
    h = st_resnet(w, "decoder.mid_block.resnets.0", h, None, frames, prec)
    for j in range(1, lpb):  # diffusers zips the attentions with resnets[1:]
        h = vae_attention(w, f"decoder.mid_block.attentions.{j - 1}", h, prec, False)
        h = st_resnet(w, f"decoder.mid_block.resnets.{j}", h, None, frames, prec)
    for i in range(len(rev)):
        p = f"decoder.up_blocks.{i}"
        for j in range(lpb + 1):
            h = st_resnet(w, f"{p}.resnets.{j}", h, None, frames, prec)
        if i < len(rev) - 1:
            h = conv(w, f"{p}.upsamplers.0.conv", F.interpolate(h, scale_factor=2.0,
                                                                 mode="nearest"),
                     prec, padding=1)
    h = conv(w, "decoder.conv_out", F.silu(group_norm(w, "decoder.conv_norm_out", h)), prec,
             padding=1)
    return temporal_conv(w, "decoder.time_conv_out", h, frames, prec)


# ---------------------------------------------------------------------------
# CLIP image encoder
# ---------------------------------------------------------------------------


def resize_weights(n_in: int, n_out: int, device):
    """[n_in, n_out] f32 weights of the triangle filter, widened by the
    scale when it shrinks (antialiased), each column summing to one."""
    scale = n_out / n_in
    width = max(1.0 / scale, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5
    dist = (centre[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]).abs() / width
    wts = (1.0 - dist).clamp_min(0.0)
    wts = wts / wts.sum(0, keepdim=True)
    return wts.float().to(device)


def resize_bilinear(x, height: int, width: int):
    """[B, C, H, W] -> [B, C, height, width] (``resize_weights`` on each
    axis)."""
    _, _, h, w = x.shape
    if w != width:
        x = x @ resize_weights(w, width, x.device)
    if h != height:
        x = resize_weights(h, height, x.device).t() @ x
    return x


def clip_embed(raw, cfg: Mapping, image):
    """image [B, 3, H, W] in [-1, 1] -> image embeddings [B, projection_dim]
    f32: resized to the encoder's size, CLIP-normalised, the vision tower,
    its pooled class token projected."""
    w = _Weights(raw, "image_encoder")
    size, heads, eps = cfg["image_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    x = resize_bilinear((image + 1.0) / 2.0, size, size)
    mean = torch.tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
    x = F.conv2d((x - mean) / std, w("vision_model.embeddings.patch_embedding.weight"),
                 stride=cfg["patch_size"]).flatten(2).transpose(1, 2)
    cls = w("vision_model.embeddings.class_embedding").expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], 1) + w("vision_model.embeddings.position_embedding.weight")[None]
    x = layer_norm(w, "vision_model.pre_layrnorm", x, eps)
    for i in range(cfg["num_hidden_layers"]):
        p = f"vision_model.encoder.layers.{i}"
        n = layer_norm(w, f"{p}.layer_norm1", x, eps)
        q, k, v = (lin(w, f"{p}.self_attn.{m}_proj", n) for m in "qkv")
        x = x + lin(w, f"{p}.self_attn.out_proj", attend(q, k, v, heads))
        n = layer_norm(w, f"{p}.layer_norm2", x, eps)
        m = lin(w, f"{p}.mlp.fc1", n)
        x = x + lin(w, f"{p}.mlp.fc2", m * torch.sigmoid(1.702 * m))
    pooled = layer_norm(w, "vision_model.post_layernorm", x[:, 0], eps)
    return pooled @ w("visual_projection.weight").t()


# ---------------------------------------------------------------------------
# scheduler and noise
# ---------------------------------------------------------------------------


def karras_sigmas(cfg: Mapping, steps: int) -> np.ndarray:
    """[steps + 1] f64: Karras (rho 7) from sigma_max to sigma_min, then 0."""
    ramp = np.linspace(0.0, 1.0, steps)
    lo, hi = cfg["sigma_min"] ** (1 / 7), cfg["sigma_max"] ** (1 / 7)
    return np.append((hi + ramp * (lo - hi)) ** 7, 0.0)


def split_keys(seed: int, num: int):
    """``jax.random.split(PRNGKey(seed), num)`` as 64-bit seeds of
    ``rng.threefry_normal``."""
    seed = int(seed) & ((1 << 64) - 1)
    hi, lo = rng.threefry2x32((seed >> 32, seed & 0xFFFFFFFF), np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
    return [(int(a) << 32) | int(b) for a, b in zip(hi, lo)]


# ---------------------------------------------------------------------------
# the request
# ---------------------------------------------------------------------------


@torch.no_grad()
def denoise(raw, config: Mapping, image, request: Mapping, *, seed: int,
            prec: Precision | None = None):
    """One request's denoise loop: image [1, 3, H, W] in [-1, 1] and a seed
    -> (the final latents, the scaled initial latents), each [F, 4, h, w]
    f32.  ``request`` holds the mix's settings (``num_frames``,
    ``num_inference_steps``, ``fps``, ``motion_bucket_id``,
    ``noise_aug_strength``, ``min_guidance_scale``, ``max_guidance_scale``)."""
    reference_settings()
    prec = prec or Precision()
    ucfg, vcfg, sch = config["unet"], config["vae"], config["scheduler"]
    dev = image.device
    frames, steps = request["num_frames"], request["num_inference_steps"]
    _, k_image, k_latents = split_keys(seed, 3)

    emb = clip_embed(raw, config["image_encoder"], image.float())[:, None]
    noise = torch.from_numpy(rng.threefry_normal(k_image, tuple(image.shape))).to(dev)
    cond = vae_encode(raw, vcfg, image.float() + request["noise_aug_strength"] * noise)
    ctx = torch.cat([torch.zeros_like(emb), emb]).repeat_interleave(frames, 0)
    cond = torch.cat([torch.zeros_like(cond), cond]).repeat_interleave(frames, 0)
    ids = torch.tensor([[request["fps"] - 1, request["motion_bucket_id"],
                         request["noise_aug_strength"]]] * 2, dtype=torch.float32, device=dev)
    guidance = torch.linspace(request["min_guidance_scale"], request["max_guidance_scale"],
                              frames, device=dev).reshape(frames, 1, 1, 1)

    sigmas = karras_sigmas(sch, steps)
    shape = (frames, vcfg["latent_channels"]) + tuple(cond.shape[2:])
    lat0 = torch.from_numpy(rng.threefry_normal(k_latents, shape)).to(dev)
    lat = lat0 = lat0 * math.sqrt(sigmas[0] ** 2 + 1.0)
    for i in range(steps):
        sigma, nxt = sigmas[i], sigmas[i + 1]
        x_in = lat / math.sqrt(sigma ** 2 + 1.0)
        t = torch.full((2,), 0.25 * math.log(sigma), device=dev)
        v = unet(raw, ucfg, prec, torch.cat([torch.cat([x_in, x_in]), cond], 1), t, ctx, ids,
                 frames)
        uncond, cond_v = v.chunk(2)
        v = uncond + guidance * (cond_v - uncond)
        x0 = v * (-sigma / math.sqrt(sigma ** 2 + 1.0)) + lat / (sigma ** 2 + 1.0)
        lat = lat + (nxt - sigma) * (lat - x0) / sigma
    return lat, lat0


@torch.no_grad()
def decode(raw, config: Mapping, lat, prec: Precision | None = None):
    """Final latents [F, 4, h, w] -> video [3, F, 8h, 8w] f32 in [0, 255]:
    unscaled, the frames decoded at once, then ``(x / 2 + 0.5)`` clamped."""
    reference_settings()
    prec = prec or Precision()
    vcfg = config["vae"]
    frames = lat.shape[0]
    video = vae_decode(raw, vcfg, lat.float() / vcfg["scaling_factor"], frames, prec)
    return (video * 0.5 + 0.5).clamp(0, 1).transpose(0, 1) * 255.0

"""A plain PyTorch LTX-Video text-to-video request, the yardstick of the
benchmark's `correct`.

It follows the published model (Lightricks LTX-Video 0.9.8, the diffusers
``LTXVideoTransformer3DModel`` / ``AutoencoderKLLTXVideo`` and the T5-XXL
encoder) and reads the raw weights that ``portbench/weights.py`` makes,
by their checkpoint names.  It imports nothing of the program under test.

Everything runs in float32 with TF32 off (``Precision("f32")``), one layer
at a time, quantized payloads dequantized where they are used, attention in
blocks of heads, so that the 13B model fits beside its inputs.
``Precision("fp8")`` is the control: every DiT block linear and every VAE
decoder conv takes float8 e4m3 operands (a scale per token or voxel and per
output channel; a 4-bit weight stays as it is), the products summed in
float32.  Its final latents, before the decode, differ from the
reference's by the DiT's linears alone: the step a later change to the
DiT would take.

Departures from the published model: none in the mathematics.  The
published T5 tokenizer is replaced by ids the benchmark draws itself.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from . import rng

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def _fp8(x, dim):
    """x rounded through float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(FP8).float() * scale


class Precision:
    """``f32``: the reference; ``fp8``: the control (see the module note)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision {mode!r}")
        self.mode = mode

    def block_linear(self, x, w, b=None, w_is_low=False):
        """x [..., K] f32, w [N, K] f32 -> [..., N] f32."""
        if self.mode != "f32":
            x = _fp8(x, -1)
            if not w_is_low:
                w = _fp8(w, -1)
        y = x @ w.t()
        return y if b is None else y + b

    def conv(self, x, w, b):
        """3x3x3 conv of an already time-padded x [B, C, T, H, W]."""
        if self.mode == "fp8":
            x = _fp8(x, 1)
            w = _fp8(w.flatten(1), -1).view_as(w)
        return F.conv3d(x, w, b, padding=(0, 1, 1))


def linear(x, w, b=None):
    y = x @ w.t()
    return y if b is None else y + b


def rms(x, eps, dim=-1):
    return x / torch.sqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def silu(x):
    return x * torch.sigmoid(x)


def sinusoid(t, dim=256):
    """[N] f32 -> [N, dim]: [cos, sin] of t·10000**(-i/half)."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64,
                                                       device=t.device) / half)
    ang = t.double()[:, None] * freq[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).float()


# ---------------------------------------------------------------------------
# quantized payloads
# ---------------------------------------------------------------------------


def int8_weight(w_q, s):
    """int8 [K, N] with a float scale per (group of K/G rows, column) ->
    f32 [N, K]."""
    k, n = w_q.shape
    g = k // s.shape[0]
    w = w_q.float().reshape(s.shape[0], g, n) * s.float()[:, None, :]
    return w.reshape(k, n).t()


def int4_weight(packed, s, m):
    """packed uint8 [K/2, N] (byte j holds row j in its low nibble and row
    K/2 + j in its high one), scale and min per (group, column) -> f32
    [N, K], w = code·scale + min."""
    codes = torch.cat([packed & 0xF, packed >> 4], dim=0).float()
    k, n = codes.shape
    g = k // s.shape[0]
    w = codes.reshape(s.shape[0], g, n) * s.float()[:, None, :] + m.float()[:, None, :]
    return w.reshape(k, n).t()


def block_weight(raw: Mapping, name: str):
    """(f32 [N, K] weight, whether it is below fp8) of a DiT block linear."""
    if f"{name}.weight" in raw:
        return raw[f"{name}.weight"].float(), False
    return int4_weight(raw[f"{name}.w4"], raw[f"{name}.w4_scale"], raw[f"{name}.w4_min"]), True


def _b(raw, name):
    t = raw.get(f"{name}.bias")
    return None if t is None else t.float()


# ---------------------------------------------------------------------------
# T5-XXL encoder
# ---------------------------------------------------------------------------


def t5_bucket(rel, num_buckets=32, max_distance=128):
    """The bidirectional relative-position bucket of T5."""
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.clamp_min(1).double() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp_max(num_buckets - 1)
    return out + torch.where(n < max_exact, n, large)


def t5_linear(raw, name, x):
    if f"{name}.w_q" in raw:
        w = int8_weight(raw[f"{name}.w_q"], raw[f"{name}.s"])
    else:
        w = int4_weight(raw[f"{name}.w4"], raw[f"{name}.w4_scale"], raw[f"{name}.w4_min"])
    return x @ w.t()


@torch.no_grad()
def t5_encode(raw: Mapping, cfg: Mapping, ids, mask):
    """ids [B, L] int64, mask [B, L] (1 keep) -> [B, L, d_model] f32."""
    eps, h, dk = cfg["layer_norm_epsilon"], cfg["num_heads"], cfg["d_kv"]
    b, s = ids.shape
    x = raw["t5.embedding"].float()[ids]
    pos = torch.arange(s, device=ids.device)
    buckets = t5_bucket(pos[None, :] - pos[:, None], cfg["relative_attention_num_buckets"],
                        cfg["relative_attention_max_distance"])
    bias = raw["t5.rel_bias"].float()[buckets].permute(2, 0, 1)[None]
    bias = bias + ((1.0 - mask.float()) * -1e9)[:, None, None, :]
    for i in range(cfg["num_layers"]):
        p = f"t5.blocks.{i}"
        n = rms(x, eps) * raw[f"{p}.attn_norm"].float()
        q, k, v = (t5_linear(raw, f"{p}.{w}", n).reshape(b, s, h, dk) for w in "qkv")
        att = torch.softmax(torch.einsum("bshd,bkhd->bhsk", q, k) + bias, dim=-1)
        out = torch.einsum("bhsk,bkhd->bshd", att, v).reshape(b, s, h * dk)
        x = x + t5_linear(raw, f"{p}.o", out)
        n = rms(x, eps) * raw[f"{p}.ffn_norm"].float()
        x = x + t5_linear(raw, f"{p}.wo", gelu_tanh(t5_linear(raw, f"{p}.wi_0", n))
                          * t5_linear(raw, f"{p}.wi_1", n))
    return rms(x, eps) * raw["t5.final_norm"].float()


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------


def video_coords(lf, lh, lw, frame_rate, tr, sr):
    """[S, 3] (frame time, pixel row, pixel column) of each latent token,
    tokens in (f, h, w) order; the first latent frame stands for one
    pixel frame."""
    f, h, w = torch.meshgrid(torch.arange(lf), torch.arange(lh), torch.arange(lw),
                             indexing="ij")
    ft = (f.double() * tr + 1 - tr).clamp(0, 1000) / frame_rate
    return torch.stack([ft, h.double() * sr, w.double() * sr], -1).reshape(-1, 3)


def rope_tables(coords, base, dim, theta):
    """cos, sin [S, dim] f32 for interleaved pairs: dim//6 frequencies a
    axis, theta**linspace(0, 1)·pi/2, on the grid 2·(coords / base) - 1,
    angles ordered frequency-major over the three axes, dim % 6 unrotated
    lanes first."""
    steps = dim // 6
    freqs = theta ** torch.linspace(0, 1, steps, dtype=torch.float64) * (math.pi / 2)
    g = coords / torch.tensor(base, dtype=torch.float64) * 2 - 1
    ang = (g[:, :, None] * freqs[None, None]).transpose(1, 2).reshape(len(coords), -1)
    cos, sin = torch.cos(ang).repeat_interleave(2, -1), torch.sin(ang).repeat_interleave(2, -1)
    pad = dim - cos.shape[1]
    cos = torch.cat([torch.ones(len(coords), pad, dtype=cos.dtype), cos], -1)
    sin = torch.cat([torch.zeros(len(coords), pad, dtype=sin.dtype), sin], -1)
    return cos.float(), sin.float()


def rotate(x, cos, sin):
    x2 = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], -1).flatten(-2)
    return x * cos + rot * sin


def attend(q, k, v, heads, bias=None, head_block=8):
    """softmax(q kᵀ/sqrt(d) + bias) v over [B, S, H·D], heads in blocks."""
    b, s, _ = q.shape
    kv = k.shape[1]
    d = q.shape[-1] // heads
    q, k, v = (t.reshape(b, -1, heads, d).transpose(1, 2) for t in (q, k, v))
    out = torch.empty_like(q)
    for h0 in range(0, heads, head_block):
        sl = slice(h0, h0 + head_block)
        sc = q[:, sl] @ k[:, sl].transpose(-1, -2) / math.sqrt(d)
        if bias is not None:
            sc = sc + bias
        out[:, sl] = torch.softmax(sc, -1) @ v[:, sl]
        del sc
    return out.transpose(1, 2).reshape(b, s, heads * d)


def dit_attention(raw, p, prec, x, enc, heads, rope=None, bias=None):
    ctx = x if enc is None else enc
    wq, lq = block_weight(raw, f"{p}.to_q")
    wk, lk = block_weight(raw, f"{p}.to_k")
    wv, lv = block_weight(raw, f"{p}.to_v")
    q = rms(prec.block_linear(x, wq, _b(raw, f"{p}.to_q"), lq), 1e-5) * \
        raw[f"{p}.norm_q.weight"].float()
    k = rms(prec.block_linear(ctx, wk, _b(raw, f"{p}.to_k"), lk), 1e-5) * \
        raw[f"{p}.norm_k.weight"].float()
    v = prec.block_linear(ctx, wv, _b(raw, f"{p}.to_v"), lv)
    if rope is not None:
        q, k = rotate(q, *rope), rotate(k, *rope)
    out = attend(q, k, v, heads, bias)
    wo, lo = block_weight(raw, f"{p}.to_out.0")
    return prec.block_linear(out, wo, _b(raw, f"{p}.to_out.0"), lo)


@torch.no_grad()
def dit_forward(raw, cfg, prec, lat, enc, enc_mask, t, rope, skip=()):
    """lat [B, S, C] f32, enc [B, K, caption] f32, mask [B, K], t [B] (the
    sigma·1000 of the step) -> velocity [B, S, C] f32."""
    g = lambda n: raw[n].float()  # noqa: E731
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    heads, eps = cfg["num_attention_heads"], cfg["norm_eps"]
    x = linear(lat, g("proj_in.weight"), g("proj_in.bias"))
    c = gelu_tanh(linear(enc, g("caption_projection.linear_1.weight"),
                         g("caption_projection.linear_1.bias")))
    c = linear(c, g("caption_projection.linear_2.weight"), g("caption_projection.linear_2.bias"))
    te = "time_embed.emb.timestep_embedder"
    emb = linear(silu(linear(sinusoid(t), g(f"{te}.linear_1.weight"), g(f"{te}.linear_1.bias"))),
                 g(f"{te}.linear_2.weight"), g(f"{te}.linear_2.bias"))
    t6 = linear(silu(emb), g("time_embed.linear.weight"), g("time_embed.linear.bias"))
    t6 = t6.reshape(-1, 1, 6, d)
    bias = ((1.0 - enc_mask.float()) * -10000.0)[:, None, None, :]
    for i in range(cfg["num_layers"]):
        if i in skip:
            continue
        p = f"transformer_blocks.{i}"
        ada = g(f"{p}.scale_shift_table")[None, None] + t6
        sh_a, sc_a, gt_a, sh_f, sc_f, gt_f = ada.unbind(2)
        n = rms(x, eps) * (1 + sc_a) + sh_a
        x = x + dit_attention(raw, f"{p}.attn1", prec, n, None, heads, rope=rope) * gt_a
        x = x + dit_attention(raw, f"{p}.attn2", prec, x, c, heads, bias=bias)
        n = rms(x, eps) * (1 + sc_f) + sh_f
        w0, l0 = block_weight(raw, f"{p}.ff.net.0.proj")
        w2, l2 = block_weight(raw, f"{p}.ff.net.2")
        hdn = gelu_tanh(prec.block_linear(n, w0, _b(raw, f"{p}.ff.net.0.proj"), l0))
        x = x + prec.block_linear(hdn, w2, _b(raw, f"{p}.ff.net.2"), l2) * gt_f
    ss = g("scale_shift_table")[None, None] + emb[:, None, None, :]
    xm = x - x.mean(-1, keepdim=True)
    x = xm / torch.sqrt(xm.square().mean(-1, keepdim=True) + 1e-6)
    x = x * (1 + ss[:, :, 1]) + ss[:, :, 0]
    return linear(x, g("proj_out.weight"), g("proj_out.bias"))


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


def distilled_sigmas(sigmas, shift_terminal):
    """The distilled presets' sigmas, stretched so that the last one is
    ``shift_terminal``, with 0 appended."""
    s = torch.tensor(sigmas, dtype=torch.float64)
    if shift_terminal is not None:
        s = 1 - (1 - s) / ((1 - s[-1]) / (1 - shift_terminal))
    return torch.cat([s, torch.zeros(1, dtype=s.dtype)])


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


def conv3d(raw, name, x, prec):
    """3x3x3, stride 1, non-causal: time padded by replicating the edge
    frames, space by zeros."""
    w = raw[f"{name}.conv.weight"].float()
    x = torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)
    return prec.conv(x, w, raw[f"{name}.conv.bias"].float())


def vae_time(raw, name, t):
    p = f"{name}.timestep_embedder"
    h = silu(linear(sinusoid(t), raw[f"{p}.linear_1.weight"].float(),
                    raw[f"{p}.linear_1.bias"].float()))
    return linear(h, raw[f"{p}.linear_2.weight"].float(), raw[f"{p}.linear_2.bias"].float())


def resnet(raw, p, x, temb, prec):
    c = x.shape[1]
    t = temb.reshape(-1, 4, c) + raw[f"{p}.scale_shift_table"].float()[None]
    m = [t[:, i][:, :, None, None, None] for i in range(4)]
    h = rms(x, 1e-8, dim=1) * (1 + m[1]) + m[0]
    h = conv3d(raw, f"{p}.conv1", silu(h), prec)
    h = rms(h, 1e-8, dim=1) * (1 + m[3]) + m[2]
    return x + conv3d(raw, f"{p}.conv2", silu(h), prec)


def depth_to_space(y, st, sh, sw):
    b, c, t, h, w = y.shape
    co = c // (st * sh * sw)
    y = y.reshape(b, co, st, sh, sw, t, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return y.reshape(b, co, t * st, h * sh, w * sw)


@torch.no_grad()
def vae_decode(raw, cfg, z, t, prec):
    """z [B, C, F, H, W] f32 (denormalised, noise mixed), t [B] decode
    timesteps -> video [B, 3, 8(F-1)+1, 32H, 32W] in about [-1, 1]."""
    if not (all(cfg["decoder_spatiotemporal_scaling"]) and all(cfg["decoder_upsample_residual"])
            and not any(cfg["decoder_inject_noise"]) and not cfg["decoder_causal"]):
        raise ValueError("the reference decodes the 0.9.8 decoder only: every up block "
                         "spatiotemporal with a residual, no noise injection, non-causal")
    ts = t * raw["decoder.timestep_scale_multiplier"].float()
    h = conv3d(raw, "decoder.conv_in", z, prec)
    mt = vae_time(raw, "decoder.mid_block.time_embedder", ts)
    n_mid = cfg["decoder_layers_per_block"][-1]
    for k in range(n_mid):
        h = resnet(raw, f"decoder.mid_block.resnets.{k}", h, mt, prec)
    boc = list(cfg["decoder_block_out_channels"])[::-1]
    lpb = list(cfg["decoder_layers_per_block"])[::-1][1:]
    upf = list(cfg["decoder_upsample_factor"])[::-1]
    for i in range(len(boc)):
        p = f"decoder.up_blocks.{i}"
        y = depth_to_space(conv3d(raw, f"{p}.upsamplers.0.conv", h, prec), 2, 2, 2)[:, :, 1:]
        res = depth_to_space(h, 2, 2, 2).repeat(1, 8 // upf[i], 1, 1, 1)[:, :, 1:]
        h = y + res
        ut = vae_time(raw, f"{p}.time_embedder", ts)
        for k in range(lpb[i]):
            h = resnet(raw, f"{p}.resnets.{k}", h, ut, prec)
    c = h.shape[1]
    e = vae_time(raw, "decoder.time_embedder", ts).reshape(-1, 2, c) + \
        raw["decoder.scale_shift_table"].float()[None]
    h = rms(h, 1e-8, dim=1) * (1 + e[:, 1][:, :, None, None, None]) + \
        e[:, 0][:, :, None, None, None]
    h = conv3d(raw, "decoder.conv_out", silu(h), prec)
    b, ch, f, hh, ww = h.shape
    p = cfg["patch_size"]
    h = h.reshape(b, ch // (p * p), 1, p, p, f, hh, ww).permute(0, 1, 5, 2, 6, 4, 7, 3)
    return h.reshape(b, ch // (p * p), f, hh * p, ww * p)


# ---------------------------------------------------------------------------
# the request
# ---------------------------------------------------------------------------


def reference_settings():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def denoise(raw, config: Mapping, *, seed: int, height: int, width: int, num_frames: int,
            ids=None, mask=None, embeds=None, prec: Precision | None = None, device="cpu"):
    """One request's denoise loop: text ids (or prompt embeddings) and a
    seed -> (the final packed latents, the initial noise), each [1, S, C]
    f32 with tokens in (frame, row, column) order; the final ones are what
    the decode takes."""
    reference_settings()
    prec = prec or Precision()
    tcfg, vcfg, inf = config["transformer"], config["vae"], config["inference"]
    sch = config["scheduler"]
    if embeds is None:
        embeds = t5_encode(raw, config["t5"], ids, mask)
    embeds, mask = embeds.float(), mask.float()
    tr, sr = vcfg["temporal_compression_ratio"], vcfg["spatial_compression_ratio"]
    lf, lh, lw = (num_frames - 1) // tr + 1, height // sr, width // sr
    c = tcfg["in_channels"]
    noise = torch.from_numpy(rng.pcg32_randn(seed, (1, c, lf, lh, lw))).to(device)
    lat = lat0 = noise.permute(0, 2, 3, 4, 1).reshape(1, lf * lh * lw, c)
    d = tcfg["num_attention_heads"] * tcfg["attention_head_dim"]
    coords = video_coords(lf, lh, lw, inf["frame_rate"], tr, sr)
    base = [tcfg["rope_base_num_frames"], tcfg["rope_base_height"], tcfg["rope_base_width"]]
    rope = tuple(r.to(device) for r in rope_tables(coords, base, d, tcfg["rope_theta"]))
    sig = distilled_sigmas(inf["timesteps"], sch["shift_terminal"]).tolist()
    for i in range(len(sig) - 1):
        t = torch.full((1,), sig[i] * sch["num_train_timesteps"], device=device)
        v = dit_forward(raw, tcfg, prec, lat, embeds, mask, t, rope,
                        skip=tuple(inf["skip_block_list"]))
        lat = lat + (sig[i + 1] - sig[i]) * v
    return lat, lat0


@torch.no_grad()
def decode(raw, config: Mapping, lat, *, seed: int, height: int, width: int, num_frames: int,
           prec: Precision | None = None, device="cpu"):
    """Packed latents [1, S, C] -> video [3, F, H, W] f32 in [0, 255]: the
    latents denormalised, the seed's decode noise mixed in, the decoder."""
    reference_settings()
    prec = prec or Precision()
    tcfg, vcfg, inf = config["transformer"], config["vae"], config["inference"]
    tr, sr = vcfg["temporal_compression_ratio"], vcfg["spatial_compression_ratio"]
    lf, lh, lw = (num_frames - 1) // tr + 1, height // sr, width // sr
    c = tcfg["in_channels"]
    z = lat.float().reshape(1, lf, lh, lw, c).permute(0, 4, 1, 2, 3)
    z = z * raw["latents_std"].float().reshape(1, -1, 1, 1, 1) / vcfg["scaling_factor"] + \
        raw["latents_mean"].float().reshape(1, -1, 1, 1, 1)
    dt, dns = inf["decode_timestep"][0], inf["decode_noise_scale"][0]
    dn = torch.from_numpy(rng.threefry_normal(seed + 2, z.shape)).to(device)
    z = (1 - dns) * z + dns * dn
    video = vae_decode(raw, vcfg, z, torch.full((1,), dt, device=device), prec)
    return ((video[0] * 0.5 + 0.5).clamp(0, 1) * 255.0)


def generate(raw, config: Mapping, *, seed: int, height: int, width: int, num_frames: int,
             ids=None, mask=None, embeds=None, prec: Precision | None = None,
             device="cpu"):
    """One request: text ids (or prompt embeddings) and a seed -> video
    [3, F, H, W] f32 in [0, 255]."""
    shape = dict(seed=seed, height=height, width=width, num_frames=num_frames, prec=prec,
                 device=device)
    lat, _ = denoise(raw, config, ids=ids, mask=mask, embeds=embeds, **shape)
    return decode(raw, config, lat, **shape)

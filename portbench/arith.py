"""The benchmark's frozen arithmetic: the card's peaks, the operations and
bytes of the work a configuration's shapes ask for, and the percentile.

Peaks are NVIDIA's data sheet figures for one H100 SXM (dense, no
sparsity), at its 700 W power limit: a share is stated against them with
the card's power limit printed beside it.
"""

from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latent_shape(config: dict, height: int, width: int, frames: int):
    v = config["vae"]
    return ((frames - 1) // v["temporal_compression_ratio"] + 1,
            height // v["spatial_compression_ratio"], width // v["spatial_compression_ratio"])


def dit_forward_flops(config: dict, tokens: int, caption_tokens: int) -> float:
    """Multiply-adds ×2 of one DiT forward of one row: the block linears,
    both attentions and the linears around the blocks; a layer the preset
    skips counts nothing."""
    t = config["transformer"]
    d = t["num_attention_heads"] * t["attention_head_dim"]
    s, k = tokens, caption_tokens
    per_layer = (2 * s * d * d * 4          # attn1 q, k, v, out
                 + 4 * s * s * d            # attn1 scores and values
                 + 2 * s * d * d * 2        # attn2 q, out
                 + 2 * k * d * d * 2        # attn2 k, v
                 + 4 * s * k * d            # attn2 scores and values
                 + 2 * s * d * 4 * d * 2)   # feed-forward
    layers = t["num_layers"] - len(config["inference"]["skip_block_list"])
    outer = (2 * s * t["in_channels"] * d + 2 * s * d * t["out_channels"]
             + 2 * k * (t["caption_channels"] * d + d * d)
             + 2 * (256 * d + d * d + 6 * d * d))
    return float(layers * per_layer + outer)


def self_attention_bound_s(config: dict, tokens: int, rows: int = 1) -> float:
    """Least seconds of one self-attention call: bf16 q, k, v read and the
    output written once, the f32 RoPE tables read once, 4·S²·H·D FLOPs."""
    t = config["transformer"]
    hd = t["num_attention_heads"] * t["attention_head_dim"]
    flops = 4.0 * rows * tokens * tokens * hd
    nbytes = 4 * rows * tokens * hd * 2 + 2 * tokens * hd * 4
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def decoder_convs(config: dict, lf: int, lh: int, lw: int):
    """(c_in, c_out, T, H, W) of each 3x3x3 conv of one dense decode (a
    streamed mode convolves every frame once, the same work)."""
    v = config["vae"]
    boc = list(v["decoder_block_out_channels"])[::-1]
    lpb = list(v["decoder_layers_per_block"])[::-1]
    upf = list(v["decoder_upsample_factor"])[::-1]
    t, h, w = lf, lh, lw
    convs = [(v["latent_channels"], boc[0], t, h, w)]
    convs += [(boc[0], boc[0], t, h, w)] * (2 * lpb[0])
    for i, c_in in enumerate(boc):
        c = c_in // upf[i]
        convs.append((c_in, 8 * c, t, h, w))
        t, h, w = 2 * t - 1, 2 * h, 2 * w
        convs += [(c, c, t, h, w)] * (2 * lpb[i + 1])
    convs.append((c, v["out_channels"] * v["patch_size"] ** 2, t, h, w))
    return convs


def conv_bound_s(c_in: int, c_out: int, t: int, h: int, w: int) -> float:
    """Least seconds of one bf16 3x3x3 conv: 2·27·C·O FLOPs an output
    voxel; input, weight and output moved once."""
    flops = 2.0 * 27 * c_in * c_out * t * h * w
    nbytes = 2 * (c_in * t * h * w + 27 * c_in * c_out + c_out * t * h * w)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)

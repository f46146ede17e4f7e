"""The frozen arithmetic of the ``svd`` family: the operations of one UNet
forward and the least time of its self-attention launches, counted from
the configuration's shapes (``portbench/arith.py`` holds the card's peaks).

FLOPs are 2 per multiply-add of every conv, linear and attention product;
norms, activations, softmax and the resampling are not counted, as
``torch.utils.flop_counter`` does not count them.
"""

from __future__ import annotations

from portbench import arith

HEAD_DIM = 64  # every SVD attention head (the widths over the heads)
SHORT_KV = 512  # at or below this many keys the port's attention runs unfused


def _levels(u: dict):
    """(channels, heads, has transformers) of each down level."""
    boc, heads = list(u["block_out_channels"]), list(u["num_attention_heads"])
    return [(c, heads[i], i < len(boc) - 1) for i, c in enumerate(boc)]


def _st_resnet(rows, p, c_in, c_out, temb):
    spatial = 2 * rows * p * 9 * (c_in * c_out + c_out * c_out) + 2 * rows * temb * c_out
    if c_in != c_out:
        spatial += 2 * rows * p * c_in * c_out
    temporal = 2 * rows * p * 3 * 2 * c_out * c_out + 2 * rows * temb * c_out
    return spatial + temporal


def _geglu(tokens, c):
    return 2 * tokens * (c * 8 * c + 4 * c * c)


def _st_transformer(rows, frames, p, c, cross, ctx_tokens):
    """Spatial block, temporal block (sequences of ``frames`` per token and
    clip), their context projections, proj_in/out and the frame-position
    MLP.  The temporal block's context is one per clip and token."""
    tokens = rows * p
    clips = rows // frames
    attn_proj = 2 * tokens * c * c * 4
    spatial = (attn_proj + 4 * rows * p * p * c                        # attn1
               + 2 * tokens * c * c * 2 + 2 * rows * ctx_tokens * cross * c * 2
               + 4 * rows * p * ctx_tokens * c                         # attn2
               + _geglu(tokens, c))
    temporal = (_geglu(tokens, c) + attn_proj + 4 * tokens * frames * c
                + 2 * tokens * c * c * 2 + 2 * clips * p * ctx_tokens * cross * c * 2
                + 4 * tokens * ctx_tokens * c + _geglu(tokens, c))
    outer = 2 * tokens * c * c * 2 + 2 * rows * (c * 4 * c + 4 * c * c)
    return spatial + temporal + outer


def unet_forward_flops(config: dict, rows: int, height: int, width: int, frames: int,
                       ctx_tokens: int = 1) -> float:
    """FLOPs of one UNet forward over ``rows`` = clips·``frames`` rows of
    ``height``×``width`` latents (28 rows a CFG step of 14 frames)."""
    u = config["unet"]
    boc, lpb = list(u["block_out_channels"]), u["layers_per_block"]
    cross, ted, clips = u["cross_attention_dim"], 4 * boc[0], rows // frames
    levels = _levels(u)
    p = [height * width // 4 ** i for i in range(len(boc))]
    total = 2 * clips * (boc[0] * ted + ted * ted + u["projection_class_embeddings_input_dim"]
                         * ted + ted * ted)
    total += 2 * rows * p[0] * 9 * u["in_channels"] * boc[0]
    ch, skips = boc[0], [boc[0]]
    for i, (c, heads, attn) in enumerate(levels):
        for j in range(lpb):
            total += _st_resnet(rows, p[i], ch, c, ted)
            if attn:
                total += _st_transformer(rows, frames, p[i], c, cross, ctx_tokens)
            ch = c
            skips.append(c)
        if i < len(levels) - 1:
            total += 2 * rows * p[i + 1] * 9 * c * c
            skips.append(c)
    total += 2 * _st_resnet(rows, p[-1], ch, ch, ted)
    total += _st_transformer(rows, frames, p[-1], ch, cross, ctx_tokens)
    for i, (c, heads, attn) in enumerate(levels[::-1]):
        level = len(levels) - 1 - i
        for j in range(lpb + 1):
            total += _st_resnet(rows, p[level], ch + skips.pop(), c, ted)
            ch = c
            if i > 0:
                total += _st_transformer(rows, frames, p[level], c, cross, ctx_tokens)
        if i < len(levels) - 1:
            total += 2 * rows * p[level - 1] * 9 * c * c
    total += 2 * rows * p[0] * 9 * boc[0] * u["out_channels"]
    return float(total)


def self_attention_calls(config: dict, height: int, width: int):
    """(tokens, heads) of each spatial self-attention call of one UNet
    forward, in call order (down, mid, up)."""
    u = config["unet"]
    lpb, levels = u["layers_per_block"], _levels(u)
    p = [height * width // 4 ** i for i in range(len(levels))]
    calls = [(p[i], h) for i, (_, h, attn) in enumerate(levels) if attn for _ in range(lpb)]
    calls.append((p[-1], levels[-1][1]))
    for i, (_, h, _) in enumerate(levels[::-1]):
        if i > 0:
            calls += [(p[len(levels) - 1 - i], h)] * (lpb + 1)
    return calls


def attention_kernel(tokens: int, heads: int) -> str | None:
    """The kernel the port's ``ops/attention.py`` takes for a self-attention
    of ``tokens`` keys and ``heads`` heads of 64: none (the unfused path) at
    or below ``SHORT_KV`` keys, K1 (``flash_attention_hopper_kernel`` mode 0)
    where the heads fill 128-lane groups, else K6 (mode 3)."""
    if tokens <= SHORT_KV:
        return None
    return "K1" if heads % (128 // HEAD_DIM) == 0 else "K6"


def self_attention_bound_s(tokens: int, heads: int, rows: int) -> float:
    """Least seconds of one self-attention launch over ``rows`` rows: bf16
    q, k, v read and the output written once, 4·S²·H·D FLOPs."""
    hd = heads * HEAD_DIM
    flops = 4.0 * rows * tokens * tokens * hd
    nbytes = 4 * rows * tokens * hd * 2
    return max(flops / arith.PEAK_BF16_FLOPS, nbytes / arith.PEAK_HBM_BYTES)


def latent_hw(config: dict, height: int, width: int):
    """The latents' height and width: the VAE halves them at each level but
    the last."""
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    return height // f, width // f


def unet_rows(mix: dict) -> int:
    """UNet rows a step: the frames, twice under guidance (CFG)."""
    return mix["num_frames"] * (2 if mix["max_guidance_scale"] > 1.0 else 1)

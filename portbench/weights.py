"""Raw weights of a configuration, made on the device from the seed.

The benchmark makes them and hands the same tensors to both sides: the
program under test takes them through its loaders (``program.py``), the
plain reference (``reference/ltx.py``) reads them by name.  Names are the
diffusers checkpoint's for the DiT and the VAE decoder, ``t5.*`` for the
text encoder.  A quantized linear is its payload as a checkpoint of that
tier would hold it:

- int8 (``<name>.w_q`` int8 [K, N], ``<name>.s`` f32 [K/32, N]):
  w = w_q·s, groups of 32 rows;
- 4-bit (``<name>.w4`` uint8 [K/2, N], byte j holding row j in its low
  nibble and row K/2 + j in its high one, ``<name>.w4_scale`` and
  ``<name>.w4_min`` [K/32, N]): w = code·scale + min.

Every tensor of one kind is drawn in one call (one normal, one uniform,
one byte draw) and cut into views, so set-up launches a handful of
generator kernels whatever the depth.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

BF16, F32 = torch.bfloat16, torch.float32
_ALIGN = 128  # elements: every view starts 256-byte aligned or better


def _block_linears(d: int):
    for attn in ("attn1", "attn2"):
        for w in ("to_q", "to_k", "to_v", "to_out.0"):
            yield f"{attn}.{w}", d, d
    yield "ff.net.0.proj", d, 4 * d
    yield "ff.net.2", 4 * d, d


class Spec:
    """(name, shape, dtype, how) rows; ``how`` is ("normal", mean, std),
    ("uniform", lo, hi), ("bytes", lo, hi) or ("fill", value)."""

    def __init__(self):
        self.rows: List[Tuple[str, tuple, torch.dtype, tuple]] = []

    def add(self, name, shape, dtype, *how):
        self.rows.append((name, tuple(shape), dtype, how))

    def dense_linear(self, name, k, n, std=0.02, bias=True):
        self.add(f"{name}.weight", (n, k), BF16, "normal", 0.0, std)
        if bias:
            self.add(f"{name}.bias", (n,), BF16, "normal", 0.0, 0.01)

    def int8_linear(self, name, k, n, scale):
        self.add(f"{name}.w_q", (k, n), torch.int8, "bytes", -127, 128)
        self.add(f"{name}.s", (k // 32, n), F32, "uniform", 0.5 * scale, 1.5 * scale)

    def int4_linear(self, name, k, n, scale, scale_dtype, bias_dtype=None):
        """Uniform codes (std 4.61, mean 7.5) around a min of -7.5·scale:
        weights of std about 4.61·scale centred at 0."""
        self.add(f"{name}.w4", (k // 2, n), torch.uint8, "bytes", 0, 256)
        self.add(f"{name}.w4_scale", (k // 32, n), scale_dtype, "uniform", 0.5 * scale,
                 1.5 * scale)
        self.add(f"{name}.w4_min", (k // 32, n), scale_dtype, "min_of", f"{name}.w4_scale")
        if bias_dtype is not None:
            self.add(f"{name}.bias", (n,), bias_dtype, "normal", 0.0, 0.01)


def dit_spec(spec: Spec, t: dict, tier: str):
    d = t["num_attention_heads"] * t["attention_head_dim"]
    spec.dense_linear("proj_in", t["in_channels"], d)
    te = "time_embed.emb.timestep_embedder"
    spec.dense_linear(f"{te}.linear_1", 256, d)
    spec.dense_linear(f"{te}.linear_2", d, d)
    spec.dense_linear("time_embed.linear", d, 6 * d)
    spec.dense_linear("caption_projection.linear_1", t["caption_channels"], d)
    spec.dense_linear("caption_projection.linear_2", d, d)
    spec.add("scale_shift_table", (2, d), BF16, "normal", 0.0, d ** -0.5)
    spec.dense_linear("proj_out", d, t["out_channels"])
    for i in range(t["num_layers"]):
        p = f"transformer_blocks.{i}"
        for attn in ("attn1", "attn2"):
            for nrm in ("norm_q", "norm_k"):
                spec.add(f"{p}.{attn}.{nrm}.weight", (d,), BF16, "normal", 1.0, 0.1)
        for name, k, n in _block_linears(d):
            if tier == "bf16":
                spec.dense_linear(f"{p}.{name}", k, n)
            elif tier == "w4":
                spec.int4_linear(f"{p}.{name}", k, n, 0.02 / 4.61, BF16, bias_dtype=BF16)
            else:
                raise ValueError(f"DiT tier {tier!r}")
        spec.add(f"{p}.scale_shift_table", (6, d), BF16, "normal", 0.0, d ** -0.5)


def _conv(spec: Spec, name, c_in, c_out, gain=1.0):
    spec.add(f"{name}.conv.weight", (c_out, c_in, 3, 3, 3), BF16, "normal", 0.0,
             gain / math.sqrt(27 * c_in))
    spec.add(f"{name}.conv.bias", (c_out,), BF16, "normal", 0.0, 0.01)


def _time_embedder(spec: Spec, name, dim):
    spec.dense_linear(f"{name}.timestep_embedder.linear_1", 256, dim)
    spec.dense_linear(f"{name}.timestep_embedder.linear_2", dim, dim)


def vae_decoder_spec(spec: Spec, v: dict):
    boc = list(v["decoder_block_out_channels"])[::-1]
    lpb = list(v["decoder_layers_per_block"])[::-1]
    upf = list(v["decoder_upsample_factor"])[::-1]
    spec.add("latents_mean", (v["latent_channels"],), F32, "normal", 0.0, 0.1)
    spec.add("latents_std", (v["latent_channels"],), F32, "uniform", 0.5, 1.5)
    spec.add("decoder.timestep_scale_multiplier", (), F32, "fill", 1000.0)
    _conv(spec, "decoder.conv_in", v["latent_channels"], boc[0])

    def resnets(prefix, c, n):
        for k in range(n):
            spec.add(f"{prefix}.resnets.{k}.scale_shift_table", (4, c), BF16, "normal", 0.0,
                     c ** -0.5)
            _conv(spec, f"{prefix}.resnets.{k}.conv1", c, c)
            _conv(spec, f"{prefix}.resnets.{k}.conv2", c, c)

    resnets("decoder.mid_block", boc[0], lpb[0])
    _time_embedder(spec, "decoder.mid_block.time_embedder", 4 * boc[0])
    for i, c_in in enumerate(boc):
        p = f"decoder.up_blocks.{i}"
        c = c_in // upf[i]
        _conv(spec, f"{p}.upsamplers.0.conv", c_in, 8 * c)
        resnets(p, c, lpb[i + 1])
        _time_embedder(spec, f"{p}.time_embedder", 4 * c)
    c = boc[-1] // upf[-1]
    _conv(spec, "decoder.conv_out", c, v["out_channels"] * v["patch_size"] ** 2, gain=0.5)
    _time_embedder(spec, "decoder.time_embedder", 2 * c)
    spec.add("decoder.scale_shift_table", (2, c), BF16, "normal", 0.0, c ** -0.5)


def t5_spec(spec: Spec, t: dict, tier: str):
    d, ff = t["d_model"], t["d_ff"]
    spec.add("t5.embedding", (t["vocab_size"], d), BF16, "normal", 0.0, 1.0)
    spec.add("t5.rel_bias", (t["relative_attention_num_buckets"], t["num_heads"]), F32,
             "normal", 0.0, 0.5)
    spec.add("t5.final_norm", (d,), BF16, "normal", 1.0, 0.1)
    for i in range(t["num_layers"]):
        p = f"t5.blocks.{i}"
        spec.add(f"{p}.attn_norm", (d,), BF16, "normal", 1.0, 0.1)
        spec.add(f"{p}.ffn_norm", (d,), BF16, "normal", 1.0, 0.1)
        for name, k, n in (("q", d, d), ("k", d, d), ("v", d, d), ("o", d, d),
                           ("wi_0", d, ff), ("wi_1", d, ff), ("wo", ff, d)):
            if tier == "int8":
                spec.int8_linear(f"{p}.{name}", k, n, 1e-4)
            elif tier == "w4":
                spec.int4_linear(f"{p}.{name}", k, n, 1e-4, F32)
            else:
                raise ValueError(f"T5 tier {tier!r}")


_PARTS = {"dit": lambda spec, c: dit_spec(spec, c["transformer"], c["precision"]["dit"]),
          "vae": lambda spec, c: vae_decoder_spec(spec, c["vae"]),
          "t5": lambda spec, c: t5_spec(spec, c["t5"], c["precision"]["t5"])}


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


@torch.no_grad()
def _make_part(spec: Spec, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    pools = {}  # (kind, dtype) -> rows, in the spec's order
    for row in spec.rows:
        kind = row[3][0]
        if kind in ("normal", "uniform", "bytes"):
            pools.setdefault((kind, row[2]), []).append(row)
    out: Dict[str, torch.Tensor] = {}
    for (kind, dtype), rows in pools.items():
        sizes = [_aligned(math.prod(r[1])) for r in rows]
        total = sum(sizes)
        if kind == "normal":
            flat = torch.randn(total, generator=g, device=device, dtype=dtype)
        elif kind == "uniform":
            flat = torch.rand(total, generator=g, device=device, dtype=dtype)
        else:
            lo, hi = rows[0][3][1:]
            flat = torch.randint(lo, hi, (total,), generator=g, device=device, dtype=dtype)
        off = 0
        for (name, shape, _, how), size in zip(rows, sizes):
            view = flat[off:off + math.prod(shape)].view(shape)
            off += size
            if kind == "normal":
                view.mul_(how[2]).add_(how[1])
            elif kind == "uniform":
                view.mul_(how[2] - how[1]).add_(how[1])
            out[name] = view
    for name, shape, dtype, how in spec.rows:
        if how[0] == "fill":
            out[name] = torch.full(shape, how[1], dtype=dtype, device=device)
        elif how[0] == "min_of":
            out[name] = out[how[1]] * -7.5
    return out


def make_from(table: dict, config: dict, seed: int, device, parts) -> Dict[str, torch.Tensor]:
    """The raw weights of ``config``'s ``parts`` on ``device``, where
    ``table`` maps each part a family has, in a fixed order, to the function
    that fills its ``Spec`` from the configuration.  Each part comes from
    its own generator, keyed by the seed and the part's place in ``table``,
    so a part is the same for the same seed whatever other parts are made."""
    out: Dict[str, torch.Tensor] = {}
    for part in parts:
        spec = Spec()
        table[part](spec, config)
        key = np.random.SeedSequence([int(seed), list(table).index(part)])
        g = torch.Generator(device=device).manual_seed(int(key.generate_state(1, np.uint64)[0]))
        out.update(_make_part(spec, g, device))
    return out


def make(config: dict, seed: int, device, parts=tuple(_PARTS)) -> Dict[str, torch.Tensor]:
    """LTX-Video's raw weights (``dit``, ``vae``, ``t5``): ``make_from``."""
    return make_from(_PARTS, config, seed, device, parts)

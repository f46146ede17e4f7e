"""Checkpoint format detection and the official <-> diffusers key maps — the
port's own copy of ``candle_video_tpu/models/ltx_video/weight_format.py``
(``detect_format``, ``remap_key``, ``is_transformer_key``, ``is_vae_key``,
``split_unified_state_dict``), itself derived from diffusers'
``convert_ltx_to_diffusers.py`` ``VAE_095_RENAME_DICT``.

``officialize_transformer_key`` and ``officialize_vae_key`` go the other
way, diffusers -> official (``remap_key``'s inverse, after the repository's
``scripts/officialize.py``): they name the tensors of an official-layout
file written from the port's modules.
"""

from __future__ import annotations

import os
import re
from typing import Dict

_ENCODER_BLOCK_RE = re.compile(r"encoder\.down_blocks\.(\d+)")
_DECODER_BLOCK_RE = re.compile(r"decoder\.up_blocks\.(\d+)")

_ENCODER_MAP = {
    0: "encoder.down_blocks.0",
    1: "encoder.down_blocks.0.downsamplers.0",
    2: "encoder.down_blocks.1",
    3: "encoder.down_blocks.1.downsamplers.0",
    4: "encoder.down_blocks.2",
    5: "encoder.down_blocks.2.downsamplers.0",
    6: "encoder.down_blocks.3",
    7: "encoder.down_blocks.3.downsamplers.0",
    8: "encoder.mid_block",
}

_DECODER_MAP = {
    0: "decoder.mid_block",
    1: "decoder.up_blocks.0.upsamplers.0",
    2: "decoder.up_blocks.0",
    3: "decoder.up_blocks.1.upsamplers.0",
    4: "decoder.up_blocks.1",
    5: "decoder.up_blocks.2.upsamplers.0",
    6: "decoder.up_blocks.2",
    7: "decoder.up_blocks.3.upsamplers.0",
    8: "decoder.up_blocks.3",
}


def detect_format(path: str) -> str:
    """file -> 'official' (unified), directory -> 'diffusers'."""
    return "official" if os.path.isfile(path) else "diffusers"


def remap_key(key: str) -> str:
    """Official -> diffusers key translation."""
    k = key
    k = k.replace("patchify_proj", "proj_in")
    k = k.replace("adaln_single", "time_embed")
    k = k.replace("q_norm", "norm_q")
    k = k.replace("k_norm", "norm_k")
    k = k.replace("res_blocks", "resnets")

    k = _ENCODER_BLOCK_RE.sub(lambda m: _ENCODER_MAP.get(int(m.group(1)), m.group(0)), k)
    k = _DECODER_BLOCK_RE.sub(lambda m: _DECODER_MAP.get(int(m.group(1)), m.group(0)), k)

    k = k.replace("last_time_embedder", "time_embedder")
    k = k.replace("last_scale_shift_table", "scale_shift_table")
    k = k.replace("norm3.norm", "norm3")
    k = k.replace("per_channel_statistics.mean-of-means", "latents_mean")
    k = k.replace("per_channel_statistics.std-of-means", "latents_std")
    return k


def is_transformer_key(key: str) -> bool:
    return (
        key.startswith("transformer.")
        or key.startswith("model.diffusion_model.")
        or "transformer_blocks" in key
        or "patchify_proj" in key
        or "proj_in" in key
        or "adaln_single" in key
        or "time_embed" in key
    )


def is_vae_key(key: str) -> bool:
    return (
        key.startswith("vae.")
        or key.startswith("encoder.")
        or key.startswith("decoder.")
        or "per_channel_statistics" in key
        or "latents_mean" in key
        or "latents_std" in key
    )


def split_unified_state_dict(sd: Dict) -> tuple[Dict, Dict]:
    """Split a unified (official single-file) checkpoint into remapped
    transformer and VAE state dicts.  The values are taken as they are
    (for a mapped file, views made here, one per key)."""
    transformer, vae = {}, {}
    for key, value in sd.items():
        new_key = remap_key(key)
        stripped = new_key
        for prefix in ("transformer.", "model.diffusion_model.", "vae."):
            if stripped.startswith(prefix):
                stripped = stripped[len(prefix):]
                break
        if is_transformer_key(key) and not is_vae_key(key):
            transformer[stripped] = value
        elif is_vae_key(key):
            vae[stripped] = value
    return transformer, vae


# ---------------------------------------------------------------------------
# diffusers -> official
# ---------------------------------------------------------------------------


def officialize_transformer_key(key: str) -> str:
    k = key
    k = k.replace("proj_in", "patchify_proj")
    k = k.replace("time_embed", "adaln_single")
    k = k.replace("norm_q", "q_norm")
    k = k.replace("norm_k", "k_norm")
    return "model.diffusion_model." + k


_ENC_INV = {diff[len("encoder."):]: f"down_blocks.{i}" for i, diff in _ENCODER_MAP.items()}
_DEC_INV = {diff[len("decoder."):]: f"up_blocks.{i}" for i, diff in _DECODER_MAP.items()}


def officialize_vae_key(key: str) -> str:
    """``encoder.*`` / ``decoder.*`` / ``latents_mean`` / ``latents_std`` ->
    the official name."""
    if key in ("latents_mean", "latents_std"):
        stat = "mean-of-means" if key == "latents_mean" else "std-of-means"
        return f"vae.per_channel_statistics.{stat}"
    section = "encoder" if key.startswith("encoder.") else "decoder"
    table = _ENC_INV if section == "encoder" else _DEC_INV
    body = key[len(section) + 1:]
    for diff, native in sorted(table.items(), key=lambda kv: -len(kv[0])):
        if body.startswith(diff + "."):
            body = native + body[len(diff):]
            break
    body = body.replace("resnets", "res_blocks")
    if body.startswith("time_embedder"):
        body = body.replace("time_embedder", "last_time_embedder", 1)
    if body.startswith("scale_shift_table"):
        body = body.replace("scale_shift_table", "last_scale_shift_table", 1)
    return f"vae.{section}.{body}"

"""The Stable Video Diffusion family (the port's ``models/svd``): one image
in, a clip of its frames out, one client at a time.

The family module's functions are those ``families/ltx_video.py`` lists.
The weights are made here, from the configuration's published widths,
under the checkpoint's names: ``unet/``, ``vae/`` and ``image_encoder/``
(the folders of the published repository) before the name in that
component's file.  The program is built from them by the port's own
``load_state_dict`` loaders and reached through
``registry.build_pipeline("svd")`` and ``pipeline.generate``; the
reference is ``reference/svd.py``.  Request i sends a seeded image, smooth
noise in [-1, 1] (``image``), with the generation seed
``traffic.request_seed(seed, i)``.

A port whose SVD ``generate`` takes no ``step_callback`` cannot hand its
final latents to the check: this module then ends the run with exit code
2 when it loads, before any weights are made.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import sys

import torch
import torch.nn.functional as F

from candle_video_tpu_torch.models.registry import build_pipeline
from candle_video_tpu_torch.models.svd import clip as C
from candle_video_tpu_torch.models.svd import configs as SC
from candle_video_tpu_torch.models.svd import loader as L
from candle_video_tpu_torch.models.svd import pipeline as P
from candle_video_tpu_torch.models.svd import vae as V
from portbench import traffic, weights

MODES = ("closed",)
CONTROL = "fp8"
BF16, F32 = torch.bfloat16, torch.float32
DTYPES = {"bf16": BF16, "f32": F32}

if "step_callback" not in inspect.signature(P.generate).parameters:
    print("portbench: the port's SVD generate takes no step_callback, so the check cannot "
          "read its final latents", file=sys.stderr, flush=True)
    sys.exit(2)


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------


def _conv(spec, name, c_in, c_out, kernel, gain=1.0, bias=True):
    spec.add(f"{name}.weight", (c_out, c_in) + kernel, BF16, "normal", 0.0,
             gain / math.sqrt(c_in * math.prod(kernel)))
    if bias:
        spec.add(f"{name}.bias", (c_out,), BF16, "normal", 0.0, 0.02)


def _linear(spec, name, k, n, bias=True):
    spec.add(f"{name}.weight", (n, k), BF16, "normal", 0.0, 1.0 / math.sqrt(k))
    if bias:
        spec.add(f"{name}.bias", (n,), BF16, "normal", 0.0, 0.02)


def _norm(spec, name, c):
    spec.add(f"{name}.weight", (c,), BF16, "normal", 1.0, 0.1)
    spec.add(f"{name}.bias", (c,), BF16, "normal", 0.0, 0.05)


def _mix(spec, name):
    """A learned blend, sigmoid(mix_factor) away from an even one."""
    spec.add(f"{name}.mix_factor", (1,), F32, "uniform", -3.0, 3.0)


def _resnet(spec, p, c_in, c_out, temb):
    _norm(spec, f"{p}.norm1", c_in)
    _conv(spec, f"{p}.conv1", c_in, c_out, (3, 3))
    if temb:
        _linear(spec, f"{p}.time_emb_proj", temb, c_out)
    _norm(spec, f"{p}.norm2", c_out)
    _conv(spec, f"{p}.conv2", c_out, c_out, (3, 3))
    if c_in != c_out:
        _conv(spec, f"{p}.conv_shortcut", c_in, c_out, (1, 1))


def _st_resnet(spec, p, c_in, c_out, temb=None):
    _resnet(spec, f"{p}.spatial_res_block", c_in, c_out, temb)
    q = f"{p}.temporal_res_block"
    _norm(spec, f"{q}.norm1", c_out)
    _conv(spec, f"{q}.conv1", c_out, c_out, (3, 1, 1))
    if temb:
        _linear(spec, f"{q}.time_emb_proj", temb, c_out)
    _norm(spec, f"{q}.norm2", c_out)
    _conv(spec, f"{q}.conv2", c_out, c_out, (3, 1, 1))
    _mix(spec, f"{p}.time_mixer")


def _attention(spec, p, c, kv):
    for m, k in (("to_q", c), ("to_k", kv), ("to_v", kv)):
        _linear(spec, f"{p}.{m}", k, c, bias=False)
    _linear(spec, f"{p}.to_out.0", c, c)


def _geglu(spec, p, c):
    _linear(spec, f"{p}.net.0.proj", c, 8 * c)
    _linear(spec, f"{p}.net.2", 4 * c, c)


def _st_transformer(spec, p, c, cross):
    _norm(spec, f"{p}.norm", c)
    _linear(spec, f"{p}.proj_in", c, c)
    s, t = f"{p}.transformer_blocks.0", f"{p}.temporal_transformer_blocks.0"
    for blk in (s, t):
        for n in ("norm1", "norm2", "norm3"):
            _norm(spec, f"{blk}.{n}", c)
        _attention(spec, f"{blk}.attn1", c, c)
        _attention(spec, f"{blk}.attn2", c, cross)
        _geglu(spec, f"{blk}.ff", c)
    _norm(spec, f"{t}.norm_in", c)
    _geglu(spec, f"{t}.ff_in", c)
    _linear(spec, f"{p}.time_pos_embed.linear_1", c, 4 * c)
    _linear(spec, f"{p}.time_pos_embed.linear_2", 4 * c, c)
    _mix(spec, f"{p}.time_mixer")
    _linear(spec, f"{p}.proj_out", c, c)


def unet_spec(spec, config):
    """UNetSpatioTemporalConditionModel's checkpoint at the configuration's
    widths."""
    u = config["unet"]
    boc, lpb, cross = list(u["block_out_channels"]), u["layers_per_block"], \
        u["cross_attention_dim"]
    ted, n = 4 * boc[0], len(boc)
    pre = "unet/"
    _conv(spec, pre + "conv_in", u["in_channels"], boc[0], (3, 3))
    _linear(spec, pre + "time_embedding.linear_1", boc[0], ted)
    _linear(spec, pre + "time_embedding.linear_2", ted, ted)
    _linear(spec, pre + "add_embedding.linear_1", u["projection_class_embeddings_input_dim"],
            ted)
    _linear(spec, pre + "add_embedding.linear_2", ted, ted)
    ch, skips = boc[0], [boc[0]]
    for i, c in enumerate(boc):
        p = f"{pre}down_blocks.{i}"
        for j in range(lpb):
            _st_resnet(spec, f"{p}.resnets.{j}", ch, c, ted)
            if i < n - 1:
                _st_transformer(spec, f"{p}.attentions.{j}", c, cross)
            ch = c
            skips.append(c)
        if i < n - 1:
            _conv(spec, f"{p}.downsamplers.0.conv", c, c, (3, 3))
            skips.append(c)
    _st_resnet(spec, f"{pre}mid_block.resnets.0", ch, ch, ted)
    _st_transformer(spec, f"{pre}mid_block.attentions.0", ch, cross)
    _st_resnet(spec, f"{pre}mid_block.resnets.1", ch, ch, ted)
    for i, c in enumerate(boc[::-1]):
        p = f"{pre}up_blocks.{i}"
        for j in range(lpb + 1):
            _st_resnet(spec, f"{p}.resnets.{j}", ch + skips.pop(), c, ted)
            ch = c
            if i > 0:
                _st_transformer(spec, f"{p}.attentions.{j}", c, cross)
        if i < n - 1:
            _conv(spec, f"{p}.upsamplers.0.conv", c, c, (3, 3))
    _norm(spec, pre + "conv_norm_out", boc[0])
    _conv(spec, pre + "conv_out", boc[0], u["out_channels"], (3, 3))


def _vae_attention(spec, p, c):
    _norm(spec, f"{p}.group_norm", c)
    for m in ("to_q", "to_k", "to_v", "to_out.0"):
        _linear(spec, f"{p}.{m}", c, c)


def vae_spec(spec, config):
    """AutoencoderKLTemporalDecoder's checkpoint: the 2D encoder, the
    quant conv, the temporal decoder; the decoder's output is scaled to
    keep the video inside [-1, 1] mostly."""
    v = config["vae"]
    boc, lpb, lat = list(v["block_out_channels"]), v["layers_per_block"], v["latent_channels"]
    e, d = "vae/encoder", "vae/decoder"
    _conv(spec, f"{e}.conv_in", v["in_channels"], boc[0], (3, 3))
    ch = boc[0]
    for i, c in enumerate(boc):
        for j in range(lpb):
            _resnet(spec, f"{e}.down_blocks.{i}.resnets.{j}", ch, c, None)
            ch = c
        if i < len(boc) - 1:
            _conv(spec, f"{e}.down_blocks.{i}.downsamplers.0.conv", c, c, (3, 3))
    _resnet(spec, f"{e}.mid_block.resnets.0", ch, ch, None)
    _vae_attention(spec, f"{e}.mid_block.attentions.0", ch)
    _resnet(spec, f"{e}.mid_block.resnets.1", ch, ch, None)
    _norm(spec, f"{e}.conv_norm_out", ch)
    _conv(spec, f"{e}.conv_out", ch, 2 * lat, (3, 3))
    _conv(spec, "vae/quant_conv", 2 * lat, 2 * lat, (1, 1))
    rev = boc[::-1]
    _conv(spec, f"{d}.conv_in", lat, rev[0], (3, 3))
    for j in range(lpb):
        _st_resnet(spec, f"{d}.mid_block.resnets.{j}", rev[0], rev[0])
    _vae_attention(spec, f"{d}.mid_block.attentions.0", rev[0])
    ch = rev[0]
    for i, c in enumerate(rev):
        for j in range(lpb + 1):
            _st_resnet(spec, f"{d}.up_blocks.{i}.resnets.{j}", ch, c)
            ch = c
        if i < len(rev) - 1:
            _conv(spec, f"{d}.up_blocks.{i}.upsamplers.0.conv", c, c, (3, 3))
    _norm(spec, f"{d}.conv_norm_out", ch)
    _conv(spec, f"{d}.conv_out", ch, v["out_channels"], (3, 3), gain=0.5)
    _conv(spec, f"{d}.time_conv_out", v["out_channels"], v["out_channels"], (3, 1, 1))


def clip_spec(spec, config):
    """CLIPVisionModelWithProjection's checkpoint."""
    c = config["image_encoder"]
    d, inner, p = c["hidden_size"], c["intermediate_size"], "image_encoder/vision_model"
    spec.add(f"{p}.embeddings.class_embedding", (d,), BF16, "normal", 0.0, 1.0)
    _conv(spec, f"{p}.embeddings.patch_embedding", c["num_channels"], d,
          (c["patch_size"], c["patch_size"]), bias=False)
    spec.add(f"{p}.embeddings.position_embedding.weight",
             ((c["image_size"] // c["patch_size"]) ** 2 + 1, d), BF16, "normal", 0.0, 0.5)
    _norm(spec, f"{p}.pre_layrnorm", d)
    for i in range(c["num_hidden_layers"]):
        q = f"{p}.encoder.layers.{i}"
        _norm(spec, f"{q}.layer_norm1", d)
        for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(spec, f"{q}.self_attn.{m}", d, d)
        _norm(spec, f"{q}.layer_norm2", d)
        _linear(spec, f"{q}.mlp.fc1", d, inner)
        _linear(spec, f"{q}.mlp.fc2", inner, d)
    _norm(spec, f"{p}.post_layernorm", d)
    _linear(spec, "image_encoder/visual_projection", d, c["projection_dim"], bias=False)


PARTS = {"unet": unet_spec, "vae": vae_spec, "image_encoder": clip_spec}


def make_weights(config: dict, seed: int, device):
    return weights.make_from(PARTS, config, seed, device, tuple(PARTS))


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def _dataclass(cls, group: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in group.items()
                  if k in names})


def port_config(config: dict) -> SC.SvdConfig:
    """The port's configuration from the file's groups (keys the port does
    not take stay with the benchmark)."""
    return SC.SvdConfig(unet=_dataclass(SC.SvdUnetConfig, config["unet"]),
                        vae=_dataclass(SC.SvdVaeConfig, config["vae"]),
                        scheduler=_dataclass(SC.EulerSchedulerConfig, config["scheduler"]),
                        clip=_dataclass(SC.ClipEncoderConfig, config["image_encoder"]))


def _part(raw: dict, component: str) -> dict:
    pre = component + "/"
    return {k[len(pre):]: v for k, v in raw.items() if k.startswith(pre)}


def build(config: dict, raw: dict, device, done):
    """The port's ``SvdPipeline`` through its checkpoint loaders; set-up
    phases ``build_unet``, ``build_vae``, ``build_clip``."""
    cfg, dtype = port_config(config), DTYPES[config["precision"]]
    unet = L.unet_params_from_state_dict(_part(raw, "unet"), cfg.unet, device, dtype)
    done("build_unet")
    vae = V.vae_params_from_state_dict(_part(raw, "vae"), cfg.vae, device, dtype)
    done("build_vae")
    clip = C.params_from_hf_state_dict(_part(raw, "image_encoder"), cfg.clip, device, dtype)
    done("build_clip")
    return build_pipeline("svd", config=cfg, unet=unet, vae=vae, clip=clip)


def image(seed: int, i: int, mix: dict, device):
    """Request i's image [1, 3, H, W] in [-1, 1]: uniform noise at a
    sixteenth of the size, upsampled bilinearly."""
    g = torch.Generator(device=device).manual_seed(traffic.request_seed(seed, i))
    h, w = mix["height"], mix["width"]
    coarse = torch.rand(1, 3, h // 16, w // 16, generator=g, device=device) * 2 - 1
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)


def inference(mix: dict, seed: int, i: int) -> P.SvdInferenceConfig:
    return P.SvdInferenceConfig(
        num_frames=mix["num_frames"], num_inference_steps=mix["num_inference_steps"],
        fps=mix["fps"], motion_bucket_id=mix["motion_bucket_id"],
        noise_aug_strength=mix["noise_aug_strength"],
        min_guidance_scale=mix["min_guidance_scale"],
        max_guidance_scale=mix["max_guidance_scale"],
        decode_chunk_size=mix["decode_chunk_size"], seed=traffic.request_seed(seed, i))


def request(pipe, config: dict, mix: dict, seed: int, i: int, stage_times, step_callback):
    """Request ``i`` through the port's ``generate``: the video as [1, 3, F,
    H, W] f32 in [0, 255]."""
    video = P.generate(pipe, image(seed, i, mix, pipe.device), inference(mix, seed, i),
                       stage_times=stage_times, step_callback=step_callback)
    return ((video.float() * 0.5 + 0.5).clamp(0, 1) * 255.0).transpose(0, 1)[None]


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def reference_weights(config: dict, seed: int, device, mix: dict):
    return make_weights(config, seed, device)


def _prec(control):
    from portbench.reference import svd as REF

    return None if control is None else REF.Precision(control)


def reference_latents(raw: dict, config: dict, mix: dict, seed: int, r: dict, device,
                      control=None):
    """Sampled request ``r``'s final latents and scaled initial latents,
    each [F, 4, h, w] f32, at the reference's precision or ``control``'s."""
    from portbench.reference import svd as REF

    i = r["index"]
    return REF.denoise(raw, config, image(seed, i, mix, device), mix,
                       seed=traffic.request_seed(seed, i), prec=_prec(control))


def reference_video(raw: dict, config: dict, mix: dict, seed: int, r: dict, lat, device,
                    control=None):
    """The video [3, F, H, W] f32 in [0, 255] that the final latents ``lat``
    decode to."""
    from portbench.reference import svd as REF

    return REF.decode(raw, config, lat, prec=_prec(control))

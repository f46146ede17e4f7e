"""The program under test, assembled from the benchmark's raw weights.

This file is the LTX-Video family's contact with the port
(``candle_video_tpu_torch``), reached through ``families/ltx_video.py``:
its configuration dataclasses, its checkpoint loaders and quantized-linear
modules, ``pipeline.generate`` and the serving runtime.  The port derives whatever it keeps (copies, layouts, packed
forms) from the tensors handed to it here.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from candle_video_tpu_torch.models.ltx_video import loader as L
from candle_video_tpu_torch.models.ltx_video import t5 as T5
from candle_video_tpu_torch.models.ltx_video import transformer as TF
from candle_video_tpu_torch.models.ltx_video.configs import (LtxFullConfig, LtxInferenceConfig,
                                                            LtxTransformerConfig, LtxVaeConfig,
                                                            T5Config)
from candle_video_tpu_torch.models.ltx_video.pipeline import generate  # noqa: F401
from candle_video_tpu_torch.models.ltx_video.scheduler import FlowMatchEulerSchedulerConfig
from candle_video_tpu_torch.models.registry import build_pipeline
from candle_video_tpu_torch.ops.quant_linear import Int4Linear, Int8Linear
from candle_video_tpu_torch.serving import Request, ShapeBucket, VideoGenerationServer  # noqa: F401


def _dataclass(cls, group: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in group.items() if k in names}
    return cls(**kw)


def port_config(config: dict) -> LtxFullConfig:
    """The port's configuration objects from the configuration file's
    groups (keys the port does not take, such as ``frame_rate``, stay with
    the benchmark)."""
    return LtxFullConfig(
        inference=_dataclass(LtxInferenceConfig, config["inference"]),
        transformer=_dataclass(LtxTransformerConfig, config["transformer"]),
        vae=_dataclass(LtxVaeConfig, config["vae"]),
        scheduler=_dataclass(FlowMatchEulerSchedulerConfig, config["scheduler"]))


def _ckpt(name: str) -> str:
    return L.dit_checkpoint_name(f"{name}.weight")[:-len(".weight")]


def _quant_linear(raw: dict, name: str, bias=None, compute_dtype=torch.float32):
    if f"{name}.w_q" in raw:
        return Int8Linear(raw[f"{name}.w_q"], raw[f"{name}.s"], bias=bias)
    return Int4Linear(raw[f"{name}.w4"], raw[f"{name}.w4_scale"], raw[f"{name}.w4_min"],
                      bias=bias, compute_dtype=compute_dtype)


@torch.no_grad()
def transformer(raw: dict, cfg: LtxTransformerConfig, tier: str, device, dtype=torch.bfloat16):
    if tier == "bf16":
        return L.transformer_from_state_dict(raw, cfg, device, dtype)
    model, slots = TF.quantized_skeleton(cfg, device, dtype)
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        t.copy_(raw[L.dit_checkpoint_name(name)])
    for parent, attr, name, *_ in slots:
        ck = _ckpt(name)
        setattr(parent, attr, _quant_linear(raw, ck, bias=raw.get(f"{ck}.bias"),
                                            compute_dtype=torch.bfloat16))
    return model.eval()


@torch.no_grad()
def text_encoder(raw: dict, cfg: T5Config):
    blocks = []
    for i in range(cfg.num_layers):
        p = f"t5.blocks.{i}"
        lins = {n: _quant_linear(raw, f"{p}.{n}") for n in ("q", "k", "v", "o", "wi_0",
                                                            "wi_1", "wo")}
        blocks.append(T5.T5Block(cfg, lins, raw[f"{p}.attn_norm"], raw[f"{p}.ffn_norm"]))
    return T5.T5Encoder(cfg, raw["t5.embedding"], blocks, raw["t5.rel_bias"],
                        raw["t5.final_norm"]).eval()


def build(config: dict, raw: dict, tokenizer, device, done=lambda phase: None):
    """The port's ``LtxPipeline`` on ``device`` from the raw weights;
    ``done(phase)`` is called after each module is built."""
    cfg = port_config(config)
    t5_cfg = _dataclass(T5Config, config["t5"])
    dit = transformer(raw, cfg.transformer, config["precision"]["dit"], device)
    done("build_dit")
    vae = L.vae_decoder_from_state_dict(raw, cfg.vae, device)
    done("build_vae")
    t5 = text_encoder(raw, t5_cfg)
    done("build_t5")
    return build_pipeline("ltx_video", config=cfg, transformer=dit, vae=vae, t5=t5,
                          t5_config=t5_cfg, tokenizer=tokenizer, vae_encoder=None)

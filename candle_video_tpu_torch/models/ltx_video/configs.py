"""Version presets for LTX-Video 0.9.5 - 0.9.8 (2B / 13B) and the model
configuration dataclasses, re-declared with the same fields and defaults as
the JAX package (``candle_video_tpu/models/ltx_video/configs.py``,
``transformer.py``, ``vae.py``, ``t5.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from .scheduler import FlowMatchEulerSchedulerConfig


@dataclasses.dataclass(frozen=True)
class LtxTransformerConfig:
    """Mirror of LtxVideoTransformer3DModelConfig (ltx_transformer.rs:22-59)."""

    in_channels: int = 128
    out_channels: int = 128
    patch_size: int = 1
    patch_size_t: int = 1
    num_attention_heads: int = 32
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    num_layers: int = 28
    qk_norm: str = "rms_norm_across_heads"
    norm_elementwise_affine: bool = False
    norm_eps: float = 1e-6
    caption_channels: int = 4096
    attention_bias: bool = True
    attention_out_bias: bool = True
    # RoPE bases (ltx_transformer.rs:976-984)
    rope_base_num_frames: int = 20
    rope_base_height: int = 2048
    rope_base_width: int = 2048
    rope_theta: float = 10000.0

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


@dataclasses.dataclass(frozen=True)
class LtxVaeConfig:
    """Mirror of AutoencoderKLLtxVideoConfig (vae.rs:30-103)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 128
    block_out_channels: tuple = (128, 256, 512, 1024, 2048)
    decoder_block_out_channels: tuple = (256, 512, 1024)
    spatiotemporal_scaling: tuple = (True, True, True, True)
    decoder_spatiotemporal_scaling: tuple = (True, True, True)
    layers_per_block: tuple = (4, 6, 6, 2, 2)
    decoder_layers_per_block: tuple = (5, 5, 5, 5)
    patch_size: int = 4
    patch_size_t: int = 1
    resnet_eps: float = 1e-6
    scaling_factor: float = 1.0
    spatial_compression_ratio: int = 32
    temporal_compression_ratio: int = 8
    decoder_inject_noise: tuple = (False, False, False, False)
    decoder_upsample_residual: tuple = (True, True, True)
    decoder_upsample_factor: tuple = (2, 2, 2)
    timestep_conditioning: bool = True
    downsample_types: tuple = ("spatial", "temporal", "spatiotemporal", "spatiotemporal")
    is_causal: bool = True
    decoder_causal: bool = False


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Mirror of T5EncoderConfig (quantized_t5_encoder.rs:19-47)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def t5_xxl() -> T5Config:
    return T5Config()


@dataclasses.dataclass(frozen=True)
class LtxInferenceConfig:
    """Mirror of LTXVInferenceConfig (configs.rs:11-37)."""

    guidance_scale: float = 3.0
    num_inference_steps: int = 40
    stg_scale: float = 1.0
    rescaling_scale: float = 0.7
    stochastic_sampling: bool = False
    skip_block_list: tuple = ()
    timesteps: Optional[tuple] = None  # distilled sigma lists (passed as sigmas)
    decode_timestep: Optional[tuple] = None
    decode_noise_scale: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class LtxFullConfig:
    inference: LtxInferenceConfig
    transformer: LtxTransformerConfig
    vae: LtxVaeConfig
    scheduler: FlowMatchEulerSchedulerConfig


def _common_vae() -> LtxVaeConfig:
    return LtxVaeConfig()


def _common_scheduler() -> FlowMatchEulerSchedulerConfig:
    """configs.rs:100-120: SD3 shifting, shift_terminal=0.1."""
    return FlowMatchEulerSchedulerConfig(
        num_train_timesteps=1000,
        shift=1.0,
        use_dynamic_shifting=False,
        base_shift=0.95,
        max_shift=2.05,
        base_image_seq_len=1024,
        max_image_seq_len=4096,
        shift_terminal=0.1,
        time_shift_type="exponential",
    )


def _transformer_2b() -> LtxTransformerConfig:
    return LtxTransformerConfig(
        num_layers=28,
        num_attention_heads=32,
        attention_head_dim=64,
        cross_attention_dim=2048,
        caption_channels=4096,
    )


def _transformer_13b() -> LtxTransformerConfig:
    return LtxTransformerConfig(
        num_layers=48,
        num_attention_heads=32,
        attention_head_dim=128,
        cross_attention_dim=4096,
        caption_channels=4096,
    )


_DISTILLED_SIGMAS = (1.0000, 0.9937, 0.9875, 0.9812, 0.9750, 0.9094, 0.7250)


def v0_9_5_2b() -> LtxFullConfig:
    return LtxFullConfig(
        inference=LtxInferenceConfig(
            guidance_scale=3.0, num_inference_steps=40, stg_scale=1.0,
            rescaling_scale=0.7, skip_block_list=(19,),
        ),
        transformer=_transformer_2b(),
        vae=_common_vae(),
        scheduler=_common_scheduler(),
    )


def v0_9_6_dev_2b() -> LtxFullConfig:
    return v0_9_5_2b()


def v0_9_6_distilled_2b() -> LtxFullConfig:
    return LtxFullConfig(
        inference=LtxInferenceConfig(
            guidance_scale=1.0, num_inference_steps=8, stg_scale=0.0,
            rescaling_scale=1.0, stochastic_sampling=True, skip_block_list=(),
        ),
        transformer=_transformer_2b(),
        vae=_common_vae(),
        scheduler=_common_scheduler(),
    )


def v0_9_8_distilled_2b() -> LtxFullConfig:
    return LtxFullConfig(
        inference=LtxInferenceConfig(
            guidance_scale=1.0, num_inference_steps=7, stg_scale=0.0,
            rescaling_scale=1.0, skip_block_list=(),
            timesteps=_DISTILLED_SIGMAS,
            decode_timestep=(0.05,), decode_noise_scale=(0.025,),
        ),
        transformer=_transformer_2b(),
        vae=_common_vae(),
        scheduler=_common_scheduler(),
    )


def v0_9_8_dev_13b() -> LtxFullConfig:
    return LtxFullConfig(
        inference=LtxInferenceConfig(
            guidance_scale=8.0, num_inference_steps=30, stg_scale=4.0,
            rescaling_scale=0.5, skip_block_list=(11, 25, 35, 39),
        ),
        transformer=_transformer_13b(),
        vae=_common_vae(),
        scheduler=_common_scheduler(),
    )


def v0_9_8_distilled_13b() -> LtxFullConfig:
    return LtxFullConfig(
        inference=LtxInferenceConfig(
            guidance_scale=1.0, num_inference_steps=7, stg_scale=0.0,
            rescaling_scale=1.0, skip_block_list=(42,),
            timesteps=_DISTILLED_SIGMAS,
            decode_timestep=(0.05,), decode_noise_scale=(0.025,),
        ),
        transformer=_transformer_13b(),
        vae=_common_vae(),
        scheduler=_common_scheduler(),
    )


_VERSIONS = {
    "0.9.5": v0_9_5_2b,
    "0.9.5-2b": v0_9_5_2b,
    "0.9.6-dev": v0_9_6_dev_2b,
    "0.9.6-2b-dev": v0_9_6_dev_2b,
    "0.9.6-distilled": v0_9_6_distilled_2b,
    "0.9.6-2b-distilled": v0_9_6_distilled_2b,
    "0.9.8-2b-distilled": v0_9_8_distilled_2b,
    "0.9.8-distilled": v0_9_8_distilled_2b,
    "0.9.8-13b-dev": v0_9_8_dev_13b,
    "0.9.8-13b-distilled": v0_9_8_distilled_13b,
    "0.9.8-13b": v0_9_8_distilled_13b,
}


def get_config_by_version(version: str) -> LtxFullConfig:
    """configs.rs:49-68 dispatch; unknown versions default to 0.9.5."""
    return _VERSIONS.get(version, v0_9_5_2b)()

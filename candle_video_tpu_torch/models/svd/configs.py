"""SVD (Stable Video Diffusion) configuration dataclasses
(``candle_video_tpu/models/svd/configs.py``, field for field): the
published image-to-video model, 576×1024 at 14 frames."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SvdUnetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    num_attention_heads: tuple = (5, 10, 20, 20)
    num_frames: int = 14
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    transformer_layers_per_block: int = 1
    sample_size: int = 96


@dataclasses.dataclass(frozen=True)
class SvdVaeConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    force_upcast: bool = True
    sample_size: int = 768


@dataclasses.dataclass(frozen=True)
class EulerSchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "leading"
    timestep_type: str = "continuous"
    steps_offset: int = 1
    use_karras_sigmas: bool = True
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    interpolation_type: str = "linear"


@dataclasses.dataclass(frozen=True)
class ClipEncoderConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    num_channels: int = 3
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class SvdConfig:
    unet: SvdUnetConfig = dataclasses.field(default_factory=SvdUnetConfig)
    vae: SvdVaeConfig = dataclasses.field(default_factory=SvdVaeConfig)
    scheduler: EulerSchedulerConfig = dataclasses.field(
        default_factory=EulerSchedulerConfig
    )
    clip: ClipEncoderConfig = dataclasses.field(default_factory=ClipEncoderConfig)

"""SVD image-to-video pipeline (``candle_video_tpu/models/svd/pipeline.py``).

CLIP image conditioning (antialiased resize to 224, normalise, encode),
noise-augmented VAE image latents concatenated on the channel axis (the
8-channel UNet input), the per-frame linear guidance ramp with the
unconditional and conditional rows batched on the batch axis, the
v-prediction Euler loop with ``scale_model_input``, and the chunked
temporal-VAE decode.  Latents stay f32 across steps and enter the UNet in
its dtype.

Noise comes from an explicit ``torch.Generator`` (seeded from
``SvdInferenceConfig.seed`` when none is given): first the image noise, then
the initial latents.  ``image_noise`` and ``latent_noise`` (standard-normal
draws of the image's and the latents' shapes) replace those draws, so a
test can feed the JAX package's ``jax.random`` ones.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from . import clip as CLIP
from . import scheduler as ES
from . import vae as SV
from .configs import SvdConfig


@dataclasses.dataclass(frozen=True)
class SvdInferenceConfig:
    num_frames: int = 14
    num_inference_steps: int = 25
    fps: int = 7
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 3.0
    decode_chunk_size: Optional[int] = None
    seed: int = 42


@dataclasses.dataclass
class SvdPipeline:
    """The modules of one SVD configuration on one device."""

    config: SvdConfig
    unet: Any
    vae: Any = None
    clip: Any = None

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(pipe: SvdPipeline, image, inference: Optional[SvdInferenceConfig] = None,
             image_embeddings=None, output_type: str = "tensor",
             generator: Optional[torch.Generator] = None, image_noise=None,
             latent_noise=None, stage_times: Optional[dict] = None):
    """image [B,3,H,W] in [-1,1] -> video [B·F, 3, H, W] in [-1,1] (or the
    latents [B·F, 4, H/8, W/8] with ``output_type="latent"``).

    ``stage_times``, when a dict, receives synchronised wall-clock seconds:
    ``clip_encode``, ``vae_encode``, ``unet_steps`` (a list) and
    ``vae_decode``."""
    inf = inference or SvdInferenceConfig()
    cfg = pipe.config
    dev = pipe.device
    timing = stage_times is not None
    image = image.to(dev, torch.float32)
    b, _, height, width = image.shape
    f = inf.num_frames
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(inf.seed)

    def mark():
        if timing:
            _sync(dev)
        return time.perf_counter()

    # 1. CLIP image embeddings [B, 1, D] -> per frame [B·F, 1, D]
    t0 = mark()
    if image_embeddings is None:
        size = cfg.clip.image_size
        clip_in = CLIP.normalize_for_clip(CLIP.resize_bilinear((image + 1.0) / 2.0, size, size))
        image_embeddings = pipe.clip(clip_in)[:, None]
    emb = image_embeddings.to(dev).repeat_interleave(f, dim=0)
    t1 = mark()

    # 2. VAE-encode the noise-augmented conditioning image; diffusers SVD
    # does not scale the conditioning latents, so the scaling is undone
    if image_noise is None:
        image_noise = torch.randn(image.shape, generator=generator, device=dev)
    image_aug = image + image_noise.to(dev, image.dtype) * inf.noise_aug_strength
    image_latents = SV.encode_to_latent(pipe.vae, image_aug)
    image_latents = image_latents / cfg.vae.scaling_factor
    image_cond = image_latents.repeat_interleave(f, dim=0)  # [B·F, 4, h, w]
    t2 = mark()

    # 3. schedule and initial noise (latent size from the VAE's output)
    schedule = ES.set_timesteps(cfg.scheduler, inf.num_inference_steps)
    lat_shape = (b * f, cfg.vae.latent_channels) + tuple(image_latents.shape[2:])
    if latent_noise is None:
        latent_noise = torch.randn(lat_shape, generator=generator, device=dev)
    latents = latent_noise.to(dev, torch.float32) * schedule.init_noise_sigma

    # 4. added time ids (fps - 1 conditioning)
    ids = torch.tensor([[inf.fps - 1, inf.motion_bucket_id, inf.noise_aug_strength]] * b,
                       dtype=torch.float32, device=dev)

    # 5. per-frame guidance ramp
    g = np.linspace(inf.min_guidance_scale, inf.max_guidance_scale, f, dtype=np.float32)
    guidance = torch.from_numpy(np.tile(g, b)).to(dev).reshape(b * f, 1, 1, 1)
    do_cfg = inf.max_guidance_scale > 1.0
    if do_cfg:
        cond_in = torch.cat([torch.zeros_like(image_cond), image_cond])
        emb_in, ids_in = torch.cat([torch.zeros_like(emb), emb]), torch.cat([ids, ids])

    steps = []
    for i in range(len(schedule.timesteps)):
        ts = mark()
        sigma, sigma_next = float(schedule.sigmas[i]), float(schedule.sigmas[i + 1])
        t = torch.tensor([schedule.timesteps[i]], dtype=torch.float32, device=dev)
        scaled = ES.scale_model_input(latents, sigma)
        if do_cfg:
            lat_in = torch.cat([torch.cat([scaled, scaled]), cond_in], dim=1)
            pred = pipe.unet(lat_in, t, emb_in, ids_in, f)
            uncond, cond = pred.chunk(2)
            noise_pred = uncond + guidance * (cond - uncond)
        else:
            noise_pred = pipe.unet(torch.cat([scaled, image_cond], dim=1), t, emb, ids, f)
        latents, _ = ES.step(latents, noise_pred, sigma, sigma_next,
                             cfg.scheduler.prediction_type)
        steps.append(mark() - ts)

    if timing:
        stage_times.update(clip_encode=t1 - t0, vae_encode=t2 - t1, unet_steps=steps)
    if output_type == "latent":
        return latents
    td = mark()
    video = SV.decode(pipe.vae, latents, f, chunk_size=inf.decode_chunk_size)
    if timing:
        stage_times["vae_decode"] = mark() - td
    return video

"""SVD image-to-video pipeline (``candle_video_tpu/models/svd/pipeline.py``).

CLIP image conditioning (antialiased resize to 224, normalise, encode),
noise-augmented VAE image latents concatenated on the channel axis (the
8-channel UNet input), the per-frame linear guidance ramp with the
unconditional and conditional rows batched on the batch axis, the
v-prediction Euler loop with ``scale_model_input``, and the chunked
temporal-VAE decode.  Latents stay f32 across steps and enter the UNet in
its dtype.

The noise follows the JAX package's keys, split on the host and drawn on
the pipeline's device (``utils/rng.normal_on``: R1 on the card):
``key, k1, k2 = split(PRNGKey(seed), 3)``, the image
noise from ``k1`` and the initial latents from ``k2``, so one seed gives
the JAX package's request on the CPU and on the card.  ``image_noise`` and
``latent_noise`` (standard-normal draws of the image's and the latents'
shapes) replace those draws.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ...utils import debug
from ...utils import rng as R
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
             image_embeddings=None, output_type: str = "tensor", image_noise=None,
             latent_noise=None, stage_times: Optional[dict] = None, step_callback=None):
    """image [B,3,H,W] in [-1,1] -> video [B·F, 3, H, W] in [-1,1] (or the
    latents [B·F, 4, H/8, W/8] with ``output_type="latent"``).

    ``stage_times``, when a dict, receives synchronised wall-clock seconds:
    ``clip_encode``, ``vae_encode``, ``unet_steps`` (a list) and
    ``vae_decode``.  ``step_callback(i, n, latents)`` is called after each
    of the n steps with the latents as [B, F, 4, h, w].  The request is a
    ``generate`` span (``utils.debug``) holding ``clip_encode``,
    ``vae_encode``, one ``denoise_step`` a step, closed before the step's
    ``stage_times`` sync, and ``vae_decode``."""
    inf = inference or SvdInferenceConfig()
    cfg = pipe.config
    dev = pipe.device
    timing = stage_times is not None
    timer = debug.StageTimer(enabled=timing)
    image = image.to(dev, torch.float32)
    b, _, height, width = image.shape
    f = inf.num_frames
    _, k1, k2 = R.split(R.prng_key(inf.seed), 3)

    with debug.span("generate", rows=b, frames=f):
        # 1. CLIP image embeddings [B, 1, D] -> per frame [B·F, 1, D]
        with timer.stage("clip_encode"):
            if image_embeddings is None:
                size = cfg.clip.image_size
                clip_in = CLIP.normalize_for_clip(
                    CLIP.resize_bilinear((image + 1.0) / 2.0, size, size))
                image_embeddings = pipe.clip(clip_in)[:, None]
            emb = image_embeddings.to(dev).repeat_interleave(f, dim=0)

        # 2. VAE-encode the noise-augmented conditioning image; diffusers SVD
        # does not scale the conditioning latents, so the scaling is undone
        with timer.stage("vae_encode"):
            if image_noise is None:
                image_noise = R.normal_on(k1, image.shape, device=dev)
            image_aug = image + image_noise.to(dev, image.dtype) * inf.noise_aug_strength
            image_latents = SV.encode_to_latent(pipe.vae, image_aug)
            image_latents = image_latents / cfg.vae.scaling_factor
            image_cond = image_latents.repeat_interleave(f, dim=0)  # [B·F, 4, h, w]

        # 3. schedule and initial noise (latent size from the VAE's output)
        schedule = ES.set_timesteps(cfg.scheduler, inf.num_inference_steps)
        lat_shape = (b * f, cfg.vae.latent_channels) + tuple(image_latents.shape[2:])
        if latent_noise is None:
            latent_noise = R.normal_on(k2, lat_shape, device=dev)
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
        n = len(schedule.timesteps)
        for i in range(n):
            if timing:
                _sync(dev)
                ts = time.perf_counter()
            with debug.span("denoise_step", step=i):
                sigma, sigma_next = float(schedule.sigmas[i]), float(schedule.sigmas[i + 1])
                t = torch.tensor([schedule.timesteps[i]], dtype=torch.float32, device=dev)
                scaled = ES.scale_model_input(latents, sigma)
                if do_cfg:
                    lat_in = torch.cat([torch.cat([scaled, scaled]), cond_in], dim=1)
                    pred = pipe.unet(lat_in, t, emb_in, ids_in, f)
                    uncond, cond = pred.chunk(2)
                    noise_pred = uncond + guidance * (cond - uncond)
                else:
                    noise_pred = pipe.unet(torch.cat([scaled, image_cond], dim=1), t, emb, ids,
                                           f)
                latents, _ = ES.step(latents, noise_pred, sigma, sigma_next,
                                     cfg.scheduler.prediction_type)
            if timing:
                _sync(dev)
                steps.append(time.perf_counter() - ts)
            if step_callback is not None:
                step_callback(i, n, latents.reshape(b, f, *latents.shape[1:]))

        if timing:
            stage_times.update(timer.stages, unet_steps=steps)
        if output_type == "latent":
            return latents
        with timer.stage("vae_decode"):
            video = SV.decode(pipe.vae, latents, f, chunk_size=inf.decode_chunk_size)
        if timing:
            stage_times["vae_decode"] = timer.stages["vae_decode"]
        return video

"""LTX-Video text-to-video pipeline
(``candle_video_tpu/models/ltx_video/pipeline.py``: ``generate``, t2v).

Prompt encode (T5) → PCG32 latents → flow-matching Euler steps of the DiT
with CFG/STG rows batched on the batch axis → unpack, denormalise and
decode-noise mix → VAE decode (dense or an exact streamed mode, resolved
once before the denoise) → [0, 255].  The denoise loop is a Python loop
over steps; latents stay f32 across steps and enter the DiT in its dtype.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ...ops.rope import rope_cos_sin
from ...parallel.sequence import denoise_loop_sp
from ...utils.rng import Pcg32
from . import scheduler as S
from . import vae as V
from .configs import LtxFullConfig, T5Config


def pack_latents(latents, patch_size: int = 1, patch_size_t: int = 1):
    """[B,C,F,H,W] -> [B, S, C·pt·p·p], tokens (f, h, w) row-major."""
    b, c, f, h, w = latents.shape
    p, pt = patch_size, patch_size_t
    x = latents.reshape(b, c, f // pt, pt, h // p, p, w // p, p)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // p) * (w // p), c * pt * p * p)


def unpack_latents(latents, num_frames: int, height: int, width: int,
                   patch_size: int = 1, patch_size_t: int = 1):
    """[B,S,D] -> [B,C,F,H,W] (inverse of pack_latents)."""
    b, _, d = latents.shape
    p, pt = patch_size, patch_size_t
    c = d // (pt * p * p)
    x = latents.reshape(b, num_frames, height, width, c, pt, p, p)
    x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, c, num_frames * pt, height * p, width * p)


def _row_std(x):
    """Unbiased std over everything but the batch axis, broadcastable to x."""
    return x.reshape(x.shape[0], -1).std(dim=1).reshape((x.shape[0],) + (1,) * (x.ndim - 1))


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float, std=_row_std):
    """std-ratio guidance rescale with the unbiased std; ``std`` computes it
    (the sequence-parallel loop passes one that reduces over the ring)."""
    rescaled = noise_cfg * (std(noise_pred_text) / std(noise_cfg))
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def guidance_combine(pred, b: int, num_conds: int, guidance_scale: float,
                     guidance_rescale: float, stg_scale: float, std=_row_std):
    """CFG/STG combination of batched rows [uncond; cond; perturbed]."""
    if num_conds == 1:
        return pred
    uncond, text = pred[:b], pred[b:2 * b]
    combined = uncond + guidance_scale * (text - uncond)
    if guidance_rescale > 0:
        combined = rescale_noise_cfg(combined, text, guidance_rescale, std)
    if num_conds == 3:
        combined = combined + stg_scale * (text - pred[2 * b:])
    return combined


def build_video_coords(latent_num_frames: int, latent_height: int,
                       latent_width: int, frame_rate: float,
                       temporal_ratio: int = 8, spatial_ratio: int = 32) -> np.ndarray:
    """[S, 3] coords with the causal frame fix ``(L·8 + 1 - 8).clamp(0) /
    frame_rate`` and spatial ``L·32``."""
    f = np.arange(latent_num_frames, dtype=np.float32)
    h = np.arange(latent_height, dtype=np.float32)
    w = np.arange(latent_width, dtype=np.float32)
    gf, gh, gw = np.meshgrid(f, h, w, indexing="ij")
    vf = np.clip(gf * temporal_ratio + 1.0 - temporal_ratio, 0.0, 1000.0) / frame_rate
    return np.stack([vf, gh * spatial_ratio, gw * spatial_ratio], axis=-1).reshape(-1, 3)


def postprocess_video(video):
    """[-1, 1] -> [0, 255] f32."""
    return (video.float() * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0


def prepare_decode(final, mean, std, noise, noise_scale, *, num_frames: int,
                   height: int, width: int, patch_size: int, patch_size_t: int,
                   scaling_factor: float):
    """unpack → denormalise → ``(1 - scale)·lat + scale·noise`` (noise None
    skips the mix)."""
    lat5 = unpack_latents(final, num_frames, height, width, patch_size, patch_size_t)
    lat5 = V.denormalize_latents(lat5, mean, std, scaling_factor)
    if noise is not None:
        lat5 = (1.0 - noise_scale) * lat5 + noise_scale * noise.to(lat5.dtype)
    return lat5


def denoise_loop(transformer, latents, encoder_hidden_states, encoder_attention_mask,
                 schedule: S.Schedule, rope_cos, rope_sin, *, num_conds: int = 1,
                 guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
                 stg_scale: float = 0.0, skip_layer_mask=None, stochastic: bool = False,
                 generator: Optional[torch.Generator] = None, step_callback=None,
                 step_seconds: Optional[list] = None):
    """Euler steps over ``schedule``; returns final latents [B, S, C] f32.
    ``step_seconds``, when a list, receives each step's synchronised time."""
    lat = latents.float()
    b = lat.shape[0]
    n = schedule.timesteps.shape[0]
    for i in range(n):
        t0 = time.perf_counter()
        t, sigma, sigma_next = (float(schedule.timesteps[i]), float(schedule.sigmas[i]),
                                float(schedule.sigmas[i + 1]))
        lat_in = lat.repeat(num_conds, 1, 1)
        timestep = torch.full((num_conds * b,), t, dtype=torch.float32, device=lat.device)
        pred = transformer(lat_in, encoder_hidden_states, timestep, rope_cos, rope_sin,
                           encoder_attention_mask=encoder_attention_mask,
                           skip_layer_mask=skip_layer_mask).float()
        combined = guidance_combine(pred, b, num_conds, guidance_scale,
                                    guidance_rescale, stg_scale)
        noise = None
        if stochastic:
            noise = torch.randn(lat.shape, generator=generator, device=lat.device)
        lat = S.step(lat, combined, sigma, sigma_next, stochastic=stochastic, noise=noise)
        if step_seconds is not None:
            _sync(lat.device)
            step_seconds.append(time.perf_counter() - t0)
        if step_callback is not None:
            step_callback(i, n, lat)
    return lat


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class LtxPipeline:
    """The modules of one LTX-Video configuration on one device."""

    config: LtxFullConfig
    transformer: Any
    vae: Any = None  # vae.LtxVaeDecoder
    t5: Any = None  # t5.T5Encoder
    t5_config: Optional[T5Config] = None
    tokenizer: Any = None  # utils.tokenizer.MockTokenizer or a T5 wrapper

    @property
    def device(self):
        return self.transformer.proj_in.weight.device

    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str], max_sequence_length: int = 128):
        """Returns (embeds [B, L, d_model], mask [B, L] f32)."""
        if self.tokenizer is None or self.t5 is None:
            raise ValueError("pipeline has no tokenizer/text encoder")
        ids, mask = self.tokenizer.encode_batch(list(prompts), max_sequence_length)
        ids = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        mask = torch.from_numpy(np.asarray(mask, np.float32)).to(self.device)
        return self.t5(ids, attention_mask=mask), mask

    def __call__(self, **kwargs):
        return generate(self, **kwargs)


def check_inputs(height: int, width: int, prompt, prompt_embeds,
                 prompt_attention_mask=None, negative_prompt_embeds=None,
                 negative_prompt_attention_mask=None):
    if height % 32 != 0 or width % 32 != 0:
        raise ValueError(
            f"`height` and `width` must be divisible by 32, got {height} and {width}")
    if prompt is not None and prompt_embeds is not None:
        raise ValueError("Cannot forward both `prompt` and `prompt_embeds`.")
    if prompt is None and prompt_embeds is None:
        raise ValueError("Provide either `prompt` or `prompt_embeds`.")
    if prompt_embeds is not None and prompt_attention_mask is None:
        raise ValueError(
            "Must provide `prompt_attention_mask` when specifying `prompt_embeds`.")
    if negative_prompt_embeds is not None and negative_prompt_attention_mask is None:
        raise ValueError("Must provide `negative_prompt_attention_mask` when "
                         "specifying `negative_prompt_embeds`.")


def _as_tensor(x, device, dtype=None):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


@torch.no_grad()
def generate(
    pipe: LtxPipeline,
    prompt: Optional[Sequence[str] | str] = None,
    negative_prompt: Optional[Sequence[str] | str] = None,
    height: int = 512,
    width: int = 768,
    num_frames: int = 97,
    frame_rate: float = 25.0,
    num_inference_steps: Optional[int] = None,
    sigmas: Optional[Sequence[float]] = None,
    timesteps: Optional[Sequence[float]] = None,
    guidance_scale: Optional[float] = None,
    guidance_rescale: Optional[float] = None,
    stg_scale: Optional[float] = None,
    skip_block_list: Optional[Sequence[int]] = None,
    num_videos_per_prompt: int = 1,
    seed: int = 42,
    latents=None,
    prompt_embeds=None,
    prompt_attention_mask=None,
    negative_prompt_embeds=None,
    negative_prompt_attention_mask=None,
    decode_timestep: Optional[Sequence[float]] = None,
    decode_noise_scale: Optional[Sequence[float]] = None,
    decode_noise=None,  # [B,C,F',H',W'] pre-drawn decode noise
    output_type: str = "tensor",  # "latent" | "tensor"
    max_sequence_length: int = 128,
    step_callback=None,
    stage_times: Optional[dict] = None,
    vae_tail_stream_chunks: int = 0,  # exact streamed tail (overlap-save)
    vae_tail_stream_from_ups: bool = False,  # ...started before the last upsampler
    vae_full_stream_chunks: int = 0,  # every decoder stage streamed
    sp_mesh=None,  # parallel.Mesh: the sequence-parallel denoise over its ring
):
    """Text-to-video generation.  Returns [B, 3, F, H, W] f32 in [0, 255],
    or the final packed latents [B, S, C] f32 for ``output_type="latent"``.

    ``stage_times``, when a dict, receives synchronised wall-clock seconds
    of the stages: ``t5_encode``, ``denoise_steps`` (a list), ``vae_decode``
    and ``total``, and ``decode_mode``, the decode keywords used.

    ``sp_mesh`` (``parallel.make_mesh``): every rank of the mesh calls
    ``generate`` with the same arguments; the denoise runs sequence-parallel
    (``parallel.denoise_loop_sp``) and every rank returns the same output."""
    cfg = pipe.config
    inf, tcfg, vcfg = cfg.inference, cfg.transformer, cfg.vae
    device = pipe.device
    stochastic = cfg.scheduler.stochastic_sampling or inf.stochastic_sampling
    if sp_mesh is not None:
        if step_callback is not None:
            raise ValueError("step_callback is not supported in SP mode")
        if stochastic:
            raise ValueError("stochastic sampling is not supported in SP mode (the loop "
                             "draws one full-sequence noise tensor; shards would need a "
                             "different stream)")
        if sp_mesh.device != device:
            raise ValueError(f"sp_mesh is on {sp_mesh.device}, the pipeline on {device}")
    timing = stage_times is not None
    t_start = time.perf_counter()

    if isinstance(prompt, str):
        prompt = [prompt]
    if isinstance(negative_prompt, str):
        negative_prompt = [negative_prompt]
    check_inputs(height, width, prompt, prompt_embeds, prompt_attention_mask,
                 negative_prompt_embeds, negative_prompt_attention_mask)
    if output_type not in ("tensor", "latent"):
        raise ValueError(f"unknown output_type {output_type!r}")

    num_inference_steps = num_inference_steps or inf.num_inference_steps
    guidance_scale = inf.guidance_scale if guidance_scale is None else guidance_scale
    guidance_rescale = inf.rescaling_scale if guidance_rescale is None else guidance_rescale
    stg_scale = inf.stg_scale if stg_scale is None else stg_scale
    if skip_block_list is None:
        skip_block_list = list(inf.skip_block_list)
    if sigmas is None and timesteps is None and inf.timesteps is not None:
        sigmas = list(inf.timesteps)  # distilled presets store sigmas here
    if decode_timestep is None and inf.decode_timestep is not None:
        decode_timestep = list(inf.decode_timestep)
    if decode_noise_scale is None and inf.decode_noise_scale is not None:
        decode_noise_scale = list(inf.decode_noise_scale)

    do_cfg = guidance_scale > 1.0
    do_stg = stg_scale > 0.0
    num_conds = 1 + int(do_cfg) + int(do_stg)
    batch = len(prompt) if prompt is not None else int(prompt_embeds.shape[0])
    eff_batch = batch * num_videos_per_prompt

    # ---- prompt embeddings ------------------------------------------------
    if prompt_embeds is None:
        p_emb, p_mask = pipe.encode_prompt(prompt, max_sequence_length)
    else:
        p_emb = _as_tensor(prompt_embeds, device)
        p_mask = _as_tensor(prompt_attention_mask, device, torch.float32)
    n_emb = n_mask = None
    if do_cfg:
        if negative_prompt_embeds is None:
            neg = negative_prompt if negative_prompt is not None else [""] * batch
            if len(neg) == 1 and batch > 1:
                neg = neg * batch
            n_emb, n_mask = pipe.encode_prompt(neg, max_sequence_length)
        else:
            n_emb = _as_tensor(negative_prompt_embeds, device)
            n_mask = _as_tensor(negative_prompt_attention_mask, device, torch.float32)
    if num_videos_per_prompt > 1:
        p_emb = p_emb.repeat_interleave(num_videos_per_prompt, 0)
        p_mask = p_mask.repeat_interleave(num_videos_per_prompt, 0)
        if do_cfg:
            n_emb = n_emb.repeat_interleave(num_videos_per_prompt, 0)
            n_mask = n_mask.repeat_interleave(num_videos_per_prompt, 0)
    rows = ([(n_emb, n_mask)] if do_cfg else []) + [(p_emb, p_mask)] + \
        ([(p_emb, p_mask)] if do_stg else [])
    enc_states = torch.cat([r[0] for r in rows])
    enc_mask = torch.cat([r[1] for r in rows])
    if timing:
        _sync(device)
        stage_times["t5_encode"] = time.perf_counter() - t_start

    # ---- latents ------------------------------------------------------------
    tr, sr = vcfg.temporal_compression_ratio, vcfg.spatial_compression_ratio
    if (num_frames - 1) % tr != 0:
        warnings.warn(f"num_frames should be {tr}*n+1; {num_frames} will produce "
                      f"{(num_frames - 1) // tr * tr + 1} frames", stacklevel=2)
    lf, lh, lw = (num_frames - 1) // tr + 1, height // sr, width // sr
    if latents is None:
        shape = (eff_batch, tcfg.in_channels, lf, lh, lw)
        lat5 = torch.from_numpy(Pcg32(seed, 0).randn(shape)).to(device)
        latents = pack_latents(lat5, tcfg.patch_size, tcfg.patch_size_t)
    else:
        latents = _as_tensor(latents, device, torch.float32)
        if latents.ndim == 5:
            latents = pack_latents(latents, tcfg.patch_size, tcfg.patch_size_t)

    # ---- decode mode: the one asked for, else resolved once, from the free
    # memory before the denoise ---------------------------------------------------
    decode_kw = dict(tail_stream_chunks=vae_tail_stream_chunks,
                     tail_stream_from_ups=vae_tail_stream_from_ups,
                     full_stream_chunks=vae_full_stream_chunks)
    if (output_type == "tensor" and pipe.vae is not None
            and not vae_tail_stream_chunks and not vae_full_stream_chunks):
        decode_kw = V.select_decode_mode(vcfg, (eff_batch, vcfg.latent_channels, lf, lh, lw),
                                         device=device)

    # ---- schedule -------------------------------------------------------------
    has_custom = sigmas is not None or timesteps is not None
    if not has_custom:
        sigmas = np.linspace(1.0, 1.0 / num_inference_steps,
                             num_inference_steps).astype(np.float32).tolist()
    mu = 0.0 if has_custom else S.calculate_shift(
        lf * lh * lw,
        cfg.scheduler.base_image_seq_len or 256,
        cfg.scheduler.max_image_seq_len or 4096,
        cfg.scheduler.base_shift or 0.5,
        cfg.scheduler.max_shift or 1.15,
    )
    schedule = S.set_timesteps(cfg.scheduler, num_inference_steps=num_inference_steps,
                               sigmas=sigmas, timesteps=timesteps, mu=mu)

    # ---- RoPE tables (once per video shape) -----------------------------------
    coords = build_video_coords(lf, lh, lw, frame_rate, tr, sr)
    base = np.asarray([tcfg.rope_base_num_frames, tcfg.rope_base_height,
                       tcfg.rope_base_width], np.float32)
    grid = torch.from_numpy(coords / base).to(device)[None]
    rope_cos, rope_sin = rope_cos_sin(grid, tcfg.inner_dim, tcfg.rope_theta)

    # ---- skip-layer mask (STG rows, or permanent skips without STG) -----------
    skip = np.zeros((tcfg.num_layers, num_conds * eff_batch), np.float32)
    for idx in skip_block_list or ():
        if 0 <= idx < tcfg.num_layers:
            skip[idx, (num_conds - 1) * eff_batch if do_stg else 0:] = 1.0
    skip_mask = torch.from_numpy(skip).to(device) if skip.any() else None

    # ---- denoise --------------------------------------------------------------
    step_seconds = [] if timing else None
    guidance = dict(num_conds=num_conds, guidance_scale=guidance_scale,
                    guidance_rescale=guidance_rescale if do_cfg else 0.0, stg_scale=stg_scale,
                    skip_layer_mask=skip_mask, step_seconds=step_seconds)
    if sp_mesh is not None:
        final = denoise_loop_sp(pipe.transformer, latents, enc_states, enc_mask, schedule,
                                rope_cos, rope_sin, mesh=sp_mesh, **guidance)
    else:
        gen = torch.Generator(device=device).manual_seed(seed + 1) if stochastic else None
        final = denoise_loop(pipe.transformer, latents, enc_states, enc_mask, schedule,
                             rope_cos, rope_sin, stochastic=stochastic, generator=gen,
                             step_callback=step_callback, **guidance)
    if timing:
        stage_times["denoise_steps"] = step_seconds
    if output_type == "latent":
        if timing:
            stage_times["total"] = time.perf_counter() - t_start
        return final

    # ---- decode -----------------------------------------------------------------
    if pipe.vae is None:
        raise ValueError("pipeline has no VAE; use output_type='latent'")
    t_dec = time.perf_counter()
    temb = noise = scale = None
    if vcfg.timestep_conditioning:
        dt = list(decode_timestep or [0.0])
        dt = dt * eff_batch if len(dt) == 1 else dt
        dns = list(decode_noise_scale or dt)
        dns = dns * eff_batch if len(dns) == 1 else dns
        temb = torch.tensor(dt, dtype=torch.float32, device=device)
        scale = torch.tensor(dns, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1, 1)
        shape = (eff_batch, vcfg.latent_channels, lf, lh, lw)
        if decode_noise is not None:
            noise = _as_tensor(decode_noise, device, torch.float32)
        else:
            g = torch.Generator(device=device).manual_seed(seed + 2)
            noise = torch.randn(shape, generator=g, device=device)
    lat5 = prepare_decode(final, pipe.vae.latents_mean, pipe.vae.latents_std, noise,
                          scale, num_frames=lf, height=lh, width=lw,
                          patch_size=tcfg.patch_size, patch_size_t=tcfg.patch_size_t,
                          scaling_factor=vcfg.scaling_factor)
    video = V.decode(pipe.vae, lat5, temb, **decode_kw)
    video = postprocess_video(video)
    if timing:
        stage_times["decode_mode"] = decode_kw
        _sync(device)
        stage_times["vae_decode"] = time.perf_counter() - t_dec
        stage_times["total"] = time.perf_counter() - t_start
    return video

"""LTX-Video text- and image-to-video pipeline
(``candle_video_tpu/models/ltx_video/pipeline.py``: ``generate``).

Prompt encode (T5) → PCG32 latents → flow-matching Euler steps of the DiT
with CFG/STG rows batched on the batch axis → unpack, denormalise and
decode-noise mix → VAE decode (dense or an exact streamed mode, resolved
once before the denoise; tiled and sliced on request) → [0, 255].  The
denoise loop is a Python loop over steps; latents stay f32 across steps and
enter the DiT in its dtype.

Image conditioning (``image=``, ``image_latents=``, ``conditioning=``): each
anchor is VAE-encoded (``LtxPipeline.vae_encoder``), sampled from its
posterior or taken at its mean, normalised with the decoder's latent
statistics and mixed into the initial latents at its frame with its
strength; ``denoise_loop_i2v`` then runs each token at its own timestep
``t·(1 - strength)`` and holds the tokens below their noise floor.

Every seeded draw follows the JAX package's key sequence, so one seed gives
the JAX package's numbers on the CPU and on the card: the initial latents
(PCG32 on the host, or ``PRNGKey(seed)`` with ``use_pcg_rng=False``), the
stochastic step noise (``PRNGKey(seed + 1)``, split once per step), the
decode noise (``PRNGKey(seed + 2)``) and anchor ``idx``'s posterior sample
(``PRNGKey(seed + 3 + idx)``, in the encoder's dtype).  The ``jax.random``
draws are made where the latents live (``utils/rng.normal_on``: R1 on the
card); keys are split on the host.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ...ops.rope import rope_cos_sin
from ...parallel.pipeline import denoise_loop_pp
from ...parallel.sequence import denoise_loop_sp
from ...utils import debug
from ...utils import rng as R
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


def _initial_noise(seed: int, shape, use_pcg_rng: bool, device):
    """The initial latents' noise: PCG32 on the host, uploaded, or
    ``jax.random.normal(PRNGKey(seed))`` drawn on ``device``."""
    if use_pcg_rng:
        return torch.from_numpy(R.Pcg32(seed, 0).randn(shape)).to(device)
    return R.normal_on(R.prng_key(seed), shape, device=device)


def denoise_loop(transformer, latents, encoder_hidden_states, encoder_attention_mask,
                 schedule: S.Schedule, rope_cos, rope_sin, *, num_conds: int = 1,
                 guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
                 stg_scale: float = 0.0, skip_layer_mask=None, stochastic: bool = False,
                 noise_key=None, step_callback=None, step_seconds: Optional[list] = None,
                 interrupted=None):
    """Euler steps over ``schedule``; returns final latents [B, S, C] f32.
    With ``stochastic``, step i draws its noise from the second half of
    ``split`` of the i-th key of the chain that starts at ``noise_key``
    (``utils.rng.prng_key``), as the JAX ``denoise_loop`` does.
    ``step_seconds``, when a list, receives each step's synchronised time.
    ``interrupted``, a callable, is asked before each step; when it answers
    true the loop stops and returns the latents of the steps so far (the
    JAX ``denoise_stepwise``'s cooperative interrupt)."""
    lat = latents.float()
    key = noise_key
    b = lat.shape[0]
    n = schedule.timesteps.shape[0]
    for i in range(n):
        if interrupted is not None and interrupted():
            break
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
            key, sub = R.split(key)
            noise = R.normal_on(sub, lat.shape, device=lat.device)
        lat = S.step(lat, combined, sigma, sigma_next, stochastic=stochastic, noise=noise)
        if step_seconds is not None:
            _sync(lat.device)
            step_seconds.append(time.perf_counter() - t0)
        if step_callback is not None:
            step_callback(i, n, lat)
    return lat


def denoise_loop_i2v(transformer, latents, cond_mask, encoder_hidden_states,
                     encoder_attention_mask, schedule: S.Schedule, rope_cos, rope_sin, *,
                     num_conds: int = 1, guidance_scale: float = 1.0,
                     guidance_rescale: float = 0.0, stg_scale: float = 0.0,
                     skip_layer_mask=None, num_train_timesteps: int = 1000,
                     step_callback=None, step_seconds: Optional[list] = None,
                     interrupted=None):
    """The image-conditioned Euler steps; returns final latents [B, S, C] f32.

    ``latents`` already hold the anchors' clean latents mixed with noise,
    ``cond_mask`` [B, S] each token's conditioning strength (1 = held).  At
    step timestep t every token runs at ``t·(1 - mask)`` through the
    per-token AdaLN (the guidance rows tile it), steps by
    ``scheduler.step_per_token`` over the whole schedule, and keeps its
    value while ``t / num_train_timesteps - 1e-6`` is not below its ``1 -
    mask``.  ``step_callback``, ``step_seconds`` and ``interrupted`` as in
    ``denoise_loop``."""
    lat = latents.float()
    inv_mask = 1.0 - cond_mask.float()
    b = lat.shape[0]
    n = schedule.timesteps.shape[0]
    for i in range(n):
        if interrupted is not None and interrupted():
            break
        t0 = time.perf_counter()
        t = torch.tensor(float(schedule.timesteps[i]), dtype=torch.float32, device=lat.device)
        tok_t = t * inv_mask
        pred = transformer(lat.repeat(num_conds, 1, 1), encoder_hidden_states,
                           tok_t.repeat(num_conds, 1), rope_cos, rope_sin,
                           encoder_attention_mask=encoder_attention_mask,
                           skip_layer_mask=skip_layer_mask).float()
        combined = guidance_combine(pred, b, num_conds, guidance_scale,
                                    guidance_rescale, stg_scale)
        denoised = S.step_per_token(lat, combined, schedule.sigmas, tok_t, num_train_timesteps)
        moving = ((t / num_train_timesteps - 1e-6) < inv_mask)[..., None]
        lat = torch.where(moving, denoised, lat)
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
    # vae.LtxVaeEncoder, for image conditioning (the latent statistics stay
    # the decoder's buffers)
    vae_encoder: Any = None
    # cooperative interrupt: generate() stops before the next denoise step
    # once it is set (the CLI's --progress sets it on Ctrl-C)
    interrupt: bool = False
    # prompt-embedding cache, first in first out; 0 turns it off
    embedding_cache_size: int = 16
    _embed_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self):
        return self.transformer.proj_in.weight.device

    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str], max_sequence_length: int = 128):
        """Returns (embeds [B, L, d_model], mask [B, L] f32), from the cache
        when the same prompts were encoded at the same length before."""
        if self.tokenizer is None or self.t5 is None:
            raise ValueError("pipeline has no tokenizer/text encoder")
        key = (tuple(prompts), max_sequence_length)
        if key in self._embed_cache:
            return self._embed_cache[key]
        ids, mask = self.tokenizer.encode_batch(list(prompts), max_sequence_length)
        ids = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        mask = torch.from_numpy(np.asarray(mask, np.float32)).to(self.device)
        result = (self.t5(ids, attention_mask=mask), mask)
        if self.embedding_cache_size > 0:
            if len(self._embed_cache) >= self.embedding_cache_size:
                self._embed_cache.pop(next(iter(self._embed_cache)))
            self._embed_cache[key] = result
        return result

    def __call__(self, **kwargs):
        return generate(self, **kwargs)


@dataclasses.dataclass
class ConditioningItem:
    """One conditioning anchor: ``image`` [B, 3, H, W] (or [3, H, W]) in
    [-1, 1], VAE-encoded at preparation, or ``latents`` [B, C, 1, h, w] as
    the encoder emits them (not normalised), placed at latent frame
    ``frame_index`` with ``strength`` in (0, 1]: 1 holds the frame through
    the whole loop; s < 1 mixes ``s·anchor + (1 - s)·noise`` and denoises the
    frame once the schedule falls below its noise floor.  Later items
    override earlier ones on the same frame."""

    image: Any = None
    latents: Any = None
    frame_index: int = 0
    strength: float = 1.0


def check_inputs(height: int, width: int, prompt, prompt_embeds,
                 negative_prompt_embeds=None, prompt_attention_mask=None,
                 negative_prompt_attention_mask=None):
    """The JAX ``check_inputs``, in its argument order and with its
    messages."""
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
    if (prompt_embeds is not None and negative_prompt_embeds is not None
            and tuple(prompt_embeds.shape) != tuple(negative_prompt_embeds.shape)):
        raise ValueError(
            "`prompt_embeds` and `negative_prompt_embeds` must have the same shape.")
    if (prompt_attention_mask is not None and negative_prompt_attention_mask is not None
            and tuple(prompt_attention_mask.shape)
            != tuple(negative_prompt_attention_mask.shape)):
        raise ValueError("`prompt_attention_mask` and `negative_prompt_attention_mask` "
                         "must have the same shape.")


def _as_tensor(x, device, dtype=None):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def _conditioning_mask(pipe, conditioning, shape):
    """Each latent frame's conditioning strength, [B, 1, F, H, W] f32, after
    the JAX refusals."""
    if pipe.vae is None:
        raise ValueError("image conditioning requires VAE params (encoder + latent stats)")
    cond = np.zeros(shape, np.float32)
    for item in conditioning:
        if not 0 <= item.frame_index < shape[2]:
            raise ValueError(f"frame_index {item.frame_index} outside latent range "
                             f"[0, {shape[2]})")
        if not 0.0 < item.strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {item.strength}")
        if item.image is None and item.latents is None:
            raise ValueError("ConditioningItem needs image or latents")
        if item.latents is None and pipe.vae_encoder is None:
            raise ValueError("a ConditioningItem with an image needs the pipeline's VAE "
                             "encoder (LtxPipeline.vae_encoder)")
        cond[:, :, item.frame_index] = item.strength
    return torch.from_numpy(cond).to(pipe.device)


def _anchor_latents(pipe, item, idx: int, seed: int, eff_batch: int,
                    num_videos_per_prompt: int, sample_mode: str, use_tiling: bool):
    """One anchor's normalised latents [eff_batch, C, 1, h, w] f32: its image
    encoded and sampled with ``PRNGKey(seed + 3 + idx)`` (or its posterior
    mean), or its given latents."""
    device = pipe.device
    if item.latents is None:
        img = _as_tensor(item.image, device, torch.float32)
        if img.ndim == 3:
            img = img[None]
        moments = V.encode(pipe.vae_encoder, img[:, :, None], use_tiling=use_tiling)
        if sample_mode == "sample":
            il = V.gaussian_sample(moments, R.prng_key(seed + 3 + idx))
        elif sample_mode == "argmax":
            il, _ = V.gaussian_split(moments)
        else:
            raise ValueError(f"unknown conditioning_sample_mode {sample_mode!r}")
    else:
        il = _as_tensor(item.latents, device, torch.float32)
    il = V.normalize_latents(il, pipe.vae.latents_mean, pipe.vae.latents_std,
                             pipe.config.vae.scaling_factor)
    if il.shape[0] == 1 and eff_batch > 1:
        il = il.expand(eff_batch, *il.shape[1:])
    elif num_videos_per_prompt > 1:
        il = il.repeat_interleave(num_videos_per_prompt, 0)
    return il.float()


# the attention routes ``generate(attn_impl=)`` and ``--attn-impl`` take
ATTN_IMPLS = ("auto", "pallas", "xla")


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
    image=None,  # [B,3,H,W] or [3,H,W] in [-1, 1]: one hard anchor on frame 0
    image_latents=None,  # [B,C,1,h,w] precomputed (not normalised) frame-0 latents
    conditioning: Optional[Sequence[ConditioningItem]] = None,  # the anchors
    conditioning_sample_mode: str = "sample",  # "sample" | "argmax" posterior
    prompt_embeds=None,
    prompt_attention_mask=None,
    negative_prompt_embeds=None,
    negative_prompt_attention_mask=None,
    decode_timestep: Optional[Sequence[float]] = None,
    decode_noise_scale: Optional[Sequence[float]] = None,
    decode_noise=None,  # [B,C,F',H',W'] pre-drawn decode noise
    output_type: str = "tensor",  # "latent" | "tensor"
    max_sequence_length: int = 128,
    use_pcg_rng: bool = True,  # initial latents from PCG32, else PRNGKey(seed)
    attn_impl: str = "auto",  # "auto" | "pallas" | "xla" (the plain path: CPU only)
    step_callback=None,
    stage_times: Optional[dict] = None,
    vae_tail_stream_chunks: int = 0,  # exact streamed tail (overlap-save)
    vae_tail_stream_from_ups: bool = False,  # ...started before the last upsampler
    vae_full_stream_chunks: int = 0,  # every decoder stage streamed
    vae_auto_decode: bool = True,  # no chunk keyword -> select_decode_mode
    vae_tiling: Optional[V.TilingConfig] = None,
    use_vae_tiling: bool = False,  # spatial and temporal tiling (approximate)
    use_vae_slicing: bool = False,  # decode the batch rows one at a time
    sp_mesh=None,  # parallel.Mesh: the sequence-parallel denoise over its ring
    pp_mesh=None,  # parallel.PipelineMesh: the DiT's block stack pipelined over it
    pp_microbatches: Optional[int] = None,
    pp_interleave: int = 1,
):
    """Text- or image-to-video generation.  Returns [B, 3, F, H, W] f32 in
    [0, 255], or the final packed latents [B, S, C] f32 for
    ``output_type="latent"``.

    ``stage_times``, when a dict, receives synchronised wall-clock seconds
    of the stages (``utils.debug.StageTimer``): ``t5_encode``,
    ``anchor_encode`` (with image conditioning), ``denoise_steps`` (a list),
    ``vae_decode`` and ``total``, and ``decode_mode``, the decode keywords
    used.  With ``CVT_DUMP_TENSORS=<dir>`` the packed initial and final
    latents are written there (``utils.debug.dump_tensor``).

    ``image`` / ``image_latents`` place one hard anchor on the first latent
    frame; ``conditioning`` is the general list of ``ConditioningItem``s (at
    most one of the two).  Anchors' images are encoded with
    ``use_tiling=use_vae_tiling``; caller-given ``latents`` are used as
    they are (assumed mixed already).  ``use_vae_tiling`` turns on both
    spatial and temporal tiling of the decode, as in the JAX ``generate``.

    ``sp_mesh`` (``parallel.make_mesh``): every rank of the mesh calls
    ``generate`` with the same arguments; the denoise runs sequence-parallel
    (``parallel.denoise_loop_sp``) and every rank returns the same output.

    ``attn_impl`` names the attention route as the JAX ``generate`` does:
    ``"auto"`` and ``"pallas"`` run the CUDA kernels (K1, K2, K5) on the
    card, ``"xla"`` the plain attention, which only the CPU runs; on the CPU
    every choice is the plain path.  ``"xla"`` on any other device raises
    ``ValueError`` before any work, as no tensor there falls back to a plain
    version, and the sequence- and pipeline-parallel loops run the kernels
    for ``"auto"`` too (JAX turns ``"auto"`` into ``"xla"`` under PP).

    ``vae_auto_decode`` (default True): with no chunk keyword the decode
    mode comes from ``vae.select_decode_mode`` and the free card memory
    before the denoise; False decodes dense unless a chunk keyword asks for
    a streamed mode.

    ``pp_mesh`` (``parallel.make_pipeline_mesh``): every rank of the mesh
    calls ``generate`` with the same arguments; the DiT is cut in place to
    the rank's stage (``parallel.shard_transformer_pp``, with
    ``pp_interleave`` virtual chunks a stage) and the denoise runs with its
    block stack pipelined (``parallel.denoise_loop_pp``, ``pp_microbatches``
    microbatches of the guidance rows, by default min(rows, pp)).  Every
    rank returns the same output.  A model cut by
    ``parallel.shard_transformer`` (tensor parallelism) runs through plain
    ``generate``."""
    cfg = pipe.config
    inf, tcfg, vcfg = cfg.inference, cfg.transformer, cfg.vae
    device = pipe.device
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    if attn_impl == "xla" and device.type != "cpu":
        raise ValueError(f"attn_impl='xla' runs the plain attention, and on {device} no "
                         "tensor falls back to a plain version: use 'auto' or 'pallas' (the "
                         "CUDA kernels), or a pipeline on the CPU")
    stochastic = cfg.scheduler.stochastic_sampling or inf.stochastic_sampling
    if pp_mesh is not None:
        if sp_mesh is not None:
            raise ValueError("pass at most one of pp_mesh / sp_mesh")
        if pp_mesh.device != device:
            raise ValueError(f"pp_mesh is on {pp_mesh.device}, the pipeline on {device}")
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
    timer = debug.StageTimer(enabled=timing)
    t_start = time.perf_counter()

    if isinstance(prompt, str):
        prompt = [prompt]
    if isinstance(negative_prompt, str):
        negative_prompt = [negative_prompt]
    check_inputs(height, width, prompt, prompt_embeds, negative_prompt_embeds,
                 prompt_attention_mask, negative_prompt_attention_mask)
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
    with timer.stage("t5_encode"):
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

    # ---- latents ------------------------------------------------------------
    tr, sr = vcfg.temporal_compression_ratio, vcfg.spatial_compression_ratio
    if (num_frames - 1) % tr != 0:
        warnings.warn(f"num_frames should be {tr}*n+1; {num_frames} will produce "
                      f"{(num_frames - 1) // tr * tr + 1} frames", stacklevel=2)
    lf, lh, lw = (num_frames - 1) // tr + 1, height // sr, width // sr
    if conditioning is not None and (image is not None or image_latents is not None):
        raise ValueError("pass either `conditioning` or `image`/`image_latents`")
    if image is not None or image_latents is not None:
        conditioning = [ConditioningItem(image=image, latents=image_latents)]
    i2v = bool(conditioning)
    if i2v and pp_mesh is not None:
        raise ValueError("image conditioning is not supported in PP mode")
    if i2v:
        cond5 = _conditioning_mask(pipe, conditioning, (eff_batch, 1, lf, lh, lw))
        cond_mask = pack_latents(cond5, tcfg.patch_size, tcfg.patch_size_t)[..., 0]
    if latents is None and i2v:
        with timer.stage("anchor_encode"):
            shape = (eff_batch, tcfg.in_channels, lf, lh, lw)
            noise5 = _initial_noise(seed, shape, use_pcg_rng, device)
            init5 = torch.zeros(shape, dtype=torch.float32, device=device)
            for idx, item in enumerate(conditioning):
                init5[:, :, item.frame_index:item.frame_index + 1] = _anchor_latents(
                    pipe, item, idx, seed, eff_batch, num_videos_per_prompt,
                    conditioning_sample_mode, use_vae_tiling)
            lat5 = init5 * cond5 + noise5 * (1.0 - cond5)
            latents = pack_latents(lat5, tcfg.patch_size, tcfg.patch_size_t)
    elif latents is None:
        shape = (eff_batch, tcfg.in_channels, lf, lh, lw)
        lat5 = _initial_noise(seed, shape, use_pcg_rng, device)
        latents = pack_latents(lat5, tcfg.patch_size, tcfg.patch_size_t)
    else:
        latents = _as_tensor(latents, device, torch.float32)
        if latents.ndim == 5:
            latents = pack_latents(latents, tcfg.patch_size, tcfg.patch_size_t)
    debug.dump_tensor("initial_latents", latents)

    # ---- decode mode: the one asked for, else (vae_auto_decode) resolved
    # once, from the free memory before the denoise --------------------------------
    decode_kw = dict(tail_stream_chunks=vae_tail_stream_chunks,
                     tail_stream_from_ups=vae_tail_stream_from_ups,
                     full_stream_chunks=vae_full_stream_chunks)
    if (vae_auto_decode and output_type == "tensor" and pipe.vae is not None
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
    if i2v:
        if sp_mesh is not None:
            raise ValueError("image conditioning is not supported in SP mode (per-token "
                             "timesteps are not wired through the ring loop)")
        if stochastic:
            raise ValueError("stochastic sampling is not supported with image conditioning "
                             "(per-token scheduler path)")
        final = denoise_loop_i2v(pipe.transformer, latents, cond_mask, enc_states, enc_mask,
                                 schedule, rope_cos, rope_sin,
                                 num_train_timesteps=cfg.scheduler.num_train_timesteps,
                                 step_callback=step_callback,
                                 interrupted=lambda: pipe.interrupt, **guidance)
    elif sp_mesh is not None:
        final = denoise_loop_sp(pipe.transformer, latents, enc_states, enc_mask, schedule,
                                rope_cos, rope_sin, mesh=sp_mesh, **guidance)
    elif pp_mesh is not None:
        if step_callback is not None:
            raise ValueError("step_callback is not supported in PP mode")
        final = denoise_loop_pp(pipe.transformer, latents, enc_states, enc_mask, schedule,
                                rope_cos, rope_sin, mesh=pp_mesh,
                                num_microbatches=pp_microbatches, interleave=pp_interleave,
                                stochastic=stochastic, noise_key=R.prng_key(seed + 1),
                                **guidance)
    else:
        final = denoise_loop(pipe.transformer, latents, enc_states, enc_mask, schedule,
                             rope_cos, rope_sin, stochastic=stochastic,
                             noise_key=R.prng_key(seed + 1), step_callback=step_callback,
                             interrupted=lambda: pipe.interrupt, **guidance)
    if timing:
        stage_times["denoise_steps"] = step_seconds
    debug.dump_tensor("final_latents", final)
    if output_type == "latent":
        if timing:
            stage_times.update(timer.stages, total=time.perf_counter() - t_start)
        return final

    # ---- decode -----------------------------------------------------------------
    if pipe.vae is None:
        raise ValueError("pipeline has no VAE; use output_type='latent'")
    with timer.stage("vae_decode"):
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
                noise = R.normal_on(R.prng_key(seed + 2), shape, device=device)
        lat5 = prepare_decode(final, pipe.vae.latents_mean, pipe.vae.latents_std, noise,
                              scale, num_frames=lf, height=lh, width=lw,
                              patch_size=tcfg.patch_size, patch_size_t=tcfg.patch_size_t,
                              scaling_factor=vcfg.scaling_factor)
        video = V.decode(pipe.vae, lat5, temb, tiling=vae_tiling, use_tiling=use_vae_tiling,
                         use_framewise_decoding=use_vae_tiling, use_slicing=use_vae_slicing,
                         **decode_kw)
        video = postprocess_video(video)
    if timing:
        stage_times.update(timer.stages, decode_mode=decode_kw,
                           total=time.perf_counter() - t_start)
    return video

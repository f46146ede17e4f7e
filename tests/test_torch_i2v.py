"""The PyTorch port's image-to-video slice against the JAX package's on the
CPU, in f32: the per-token scheduler, the DiT at [B, S] timesteps,
``denoise_loop_i2v``, ``generate(image= | image_latents= | conditioning=)``
with the posterior sampled or at its mean, at guidance 1 and with CFG, the
refusals, the step-wise path and the CLI's ``--image``.

Tiny DiT (2 layers, 4 heads x 64), tiny VAE whose encoder compresses 8x in
space and 4x in time (64x96x9 -> 3x8x12 latents, S = 288).  Tolerances:
scheduler steps atol 1e-6; the DiT's output atol 2e-4; final latents atol
1e-4 (f32, 3 steps); conditioned tokens held bit for bit; the bf16 anchor
draw bit-equal to ``jax.random.normal(..., bfloat16)``."""

import copy
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu import cli as JCLI
from candle_video_tpu.models.ltx_video import pipeline as JP
from candle_video_tpu.models.ltx_video import scheduler as JS
from candle_video_tpu.models.ltx_video import transformer as JTF
from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video.configs import LtxFullConfig, LtxInferenceConfig
from candle_video_tpu.models.ltx_video.scheduler import FlowMatchEulerSchedulerConfig
from candle_video_tpu.models.ltx_video.vae_init import init_vae_params
from candle_video_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from candle_video_tpu_torch import cli as PCLI
from candle_video_tpu_torch.models.ltx_video import configs as PC
from candle_video_tpu_torch.models.ltx_video import convert as PCV
from candle_video_tpu_torch.models.ltx_video import pipeline as PP
from candle_video_tpu_torch.models.ltx_video import scheduler as PS
from candle_video_tpu_torch.utils import rng as R

torch.set_num_threads(2)

TF_CFG = dict(in_channels=8, out_channels=8, num_attention_heads=4, attention_head_dim=64,
              cross_attention_dim=256, num_layers=2, caption_channels=64)
VAE_CFG = dict(latent_channels=8, block_out_channels=(8, 16, 32),
               decoder_block_out_channels=(8, 16), spatiotemporal_scaling=(True, True),
               decoder_spatiotemporal_scaling=(True, True), layers_per_block=(1, 1, 2),
               decoder_layers_per_block=(1, 1, 1), patch_size=2,
               downsample_types=("spatiotemporal", "spatiotemporal"),
               decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
               decoder_causal=False, spatial_compression_ratio=8, temporal_compression_ratio=4)
SCHED = dict(shift_terminal=0.1, base_shift=0.95, max_shift=2.05, base_image_seq_len=1024,
             max_image_seq_len=4096)
DISTILLED = dict(guidance_scale=1.0, num_inference_steps=3, stg_scale=0.0, rescaling_scale=1.0,
                 timesteps=(1.0, 0.9094, 0.725), decode_timestep=(0.05,),
                 decode_noise_scale=(0.025,))
CFG_RESCALE = dict(DISTILLED, guidance_scale=3.0, rescaling_scale=0.7)
H, W, F = 64, 96, 9  # latents 3 x 8 x 12
LAT = (3, 8, 12)


def _cfg(mod, inference):
    return mod.LtxFullConfig(inference=mod.LtxInferenceConfig(**inference),
                             transformer=mod.LtxTransformerConfig(**TF_CFG),
                             vae=mod.LtxVaeConfig(**VAE_CFG),
                             scheduler=mod.FlowMatchEulerSchedulerConfig(**SCHED))


@pytest.fixture(scope="module")
def trees():
    tparams = JTF.init_params(jax.random.PRNGKey(0), JTF.LtxTransformerConfig(**TF_CFG),
                              dtype=jnp.float32)
    vparams = init_vae_params(jax.random.PRNGKey(1), JV.LtxVaeConfig(**VAE_CFG),
                              dtype=jnp.float32)
    vparams["latents_mean"] = jnp.linspace(-0.1, 0.1, 8).astype(jnp.float32)
    vparams["latents_std"] = jnp.linspace(0.9, 1.1, 8).astype(jnp.float32)
    return tparams, vparams


def _pipelines(trees, inference=DISTILLED):
    tparams, vparams = trees
    jpipe = JP.LtxPipeline(config=_cfg(_JMOD, inference), transformer_params=tparams,
                           vae_params=vparams)
    pcfg = _cfg(PC, inference)
    np_tree = jax.tree.map(np.asarray, vparams)
    ppipe = PP.LtxPipeline(pcfg, PCV.transformer_from_jax(jax.tree.map(np.asarray, tparams),
                                                          pcfg.transformer, device="cpu"),
                           PCV.vae_decoder_from_jax(np_tree, pcfg.vae, device="cpu"),
                           vae_encoder=PCV.vae_encoder_from_jax(np_tree, pcfg.vae, device="cpu"))
    return jpipe, ppipe


_JMOD = types.SimpleNamespace(LtxFullConfig=LtxFullConfig, LtxInferenceConfig=LtxInferenceConfig,
                              LtxTransformerConfig=JTF.LtxTransformerConfig,
                              LtxVaeConfig=JV.LtxVaeConfig,
                              FlowMatchEulerSchedulerConfig=FlowMatchEulerSchedulerConfig)


def _embeds(seed=0, cfg=False):
    rng = np.random.default_rng(seed)
    kw = dict(prompt_embeds=(rng.normal(size=(1, 16, 64)) * 0.3).astype(np.float32),
              prompt_attention_mask=np.ones((1, 16), np.float32))
    if cfg:
        kw.update(negative_prompt_embeds=np.zeros((1, 16, 64), np.float32),
                  negative_prompt_attention_mask=np.ones((1, 16), np.float32))
    return kw


def _image(seed, batch=1):
    return np.random.default_rng(seed).uniform(-1, 1, size=(batch, 3, H, W)).astype(np.float32)


def _jax_kw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _items(mod, items):
    return [mod.ConditioningItem(**{k: (jnp.asarray(v) if mod is JP and isinstance(v, np.ndarray)
                                        else v) for k, v in it.items()}) for it in items]


# ---------------------------------------------------------------------------
# the scheduler's per-token path
# ---------------------------------------------------------------------------


def test_step_per_token_matches_jax(rng):
    sched = JS.set_timesteps(FlowMatchEulerSchedulerConfig(**SCHED), num_inference_steps=4,
                             sigmas=[1.0, 0.8, 0.55, 0.3], mu=0.0)
    lat = rng.normal(size=(2, 7, 3)).astype(np.float32)
    v = rng.normal(size=(2, 7, 3)).astype(np.float32)
    # tokens at schedule points, between them, at 0 (held) and below the last
    tok_t = np.concatenate([sched.timesteps[None, :4].repeat(2, 0),
                            np.array([[0.0, 412.5, 3.0]] * 2, np.float32)], 1)
    got = PS.step_per_token(torch.from_numpy(lat), torch.from_numpy(v), sched.sigmas,
                            torch.from_numpy(tok_t)).numpy()
    want = np.asarray(JS.step_per_token(jnp.asarray(lat), jnp.asarray(v), sched.sigmas,
                                        jnp.asarray(tok_t)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_scale_noise_and_index_for_timestep_match_jax(rng):
    x = rng.normal(size=(2, 5, 3)).astype(np.float32)
    n = rng.normal(size=(2, 5, 3)).astype(np.float32)
    for sigma in (0.3, np.array([0.2, 0.9], np.float32)):
        got = PS.scale_noise(torch.from_numpy(x), sigma, torch.from_numpy(n)).numpy()
        want = np.asarray(JS.scale_noise(jnp.asarray(x), sigma, jnp.asarray(n)))
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    sched = PS.Schedule(sigmas=np.array([1.0, 0.7, 0.7, 0.2, 0.0], np.float32),
                        timesteps=np.array([1000.0, 700.0, 700.0, 200.0], np.float32),
                        num_inference_steps=4)
    jsched = JS.Schedule(sigmas=sched.sigmas, timesteps=sched.timesteps, num_inference_steps=4)
    for t in (1000.0, 700.0, 200.0):
        for pos in (0, 1):
            assert PS.index_for_timestep(sched, t, pos) == JS.index_for_timestep(jsched, t, pos)
    with pytest.raises(ValueError, match="not found"):
        PS.index_for_timestep(sched, 500.0)


# ---------------------------------------------------------------------------
# the DiT at per-token timesteps, and the loop
# ---------------------------------------------------------------------------


def _rope(f=3, h=2, w=3):
    tcfg = JTF.LtxTransformerConfig(**TF_CFG)
    coords = JP.build_video_coords(f, h, w, 25.0, 4, 32)
    grid = jnp.asarray(coords)[None] / jnp.asarray(
        [tcfg.rope_base_num_frames, tcfg.rope_base_height, tcfg.rope_base_width], jnp.float32)
    cos, sin = j_rope_cos_sin(grid, tcfg.inner_dim, tcfg.rope_theta)
    return (cos, sin), (torch.from_numpy(np.asarray(cos)), torch.from_numpy(np.asarray(sin)))


def test_dit_per_token_timesteps_match_jax(trees, rng):
    jpipe, ppipe = _pipelines(trees)
    s = 3 * 2 * 3
    x = rng.normal(size=(2, s, 8)).astype(np.float32)
    emb = (rng.normal(size=(2, 5, 64)) * 0.3).astype(np.float32)
    tok_t = rng.uniform(0, 1000, size=(2, s)).astype(np.float32)
    (jcos, jsin), (cos, sin) = _rope()
    want = np.asarray(JTF.forward(jpipe.transformer_params, jpipe.config.transformer,
                                  jnp.asarray(x), jnp.asarray(emb), jnp.asarray(tok_t), jcos,
                                  jsin, attn_impl="xla"))
    with torch.no_grad():
        got = ppipe.transformer(torch.from_numpy(x), torch.from_numpy(emb),
                                torch.from_numpy(tok_t), cos, sin).numpy()
        # every token at one timestep: the [B] forward, to rounding
        same = ppipe.transformer(torch.from_numpy(x), torch.from_numpy(emb),
                                 torch.full((2, s), 437.0), cos, sin).numpy()
        scalar = ppipe.transformer(torch.from_numpy(x), torch.from_numpy(emb),
                                   torch.full((2,), 437.0), cos, sin).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(same, scalar, atol=1e-5, rtol=0)
    assert np.abs(got - scalar).max() > 1e-3  # the per-token timesteps do act


def test_denoise_loop_i2v_matches_jax(trees, rng):
    """CFG (2 rows, rescale), a hard anchor on frame 0 and a soft one (0.6)
    on frame 2, over the whole schedule; the hard tokens held exactly."""
    jpipe, ppipe = _pipelines(trees)
    s = 3 * 2 * 3
    lat = rng.normal(size=(1, s, 8)).astype(np.float32)
    cmask = np.zeros((1, s), np.float32)
    cmask[:, :6] = 1.0
    cmask[:, 12:] = 0.6
    enc = (rng.normal(size=(2, 5, 64)) * 0.3).astype(np.float32)
    mask = np.ones((2, 5), np.float32)
    sched = JS.set_timesteps(FlowMatchEulerSchedulerConfig(**SCHED), num_inference_steps=4,
                             sigmas=[1.0, 0.8, 0.55, 0.3], mu=0.0)
    (jcos, jsin), (cos, sin) = _rope()
    skip = jnp.zeros((2, 2), jnp.float32)
    want = np.asarray(JP.denoise_loop_i2v(
        jpipe.transformer_params, jpipe.config.transformer, jnp.asarray(lat),
        jnp.asarray(cmask), jnp.asarray(enc), jnp.asarray(mask), sched.sigmas_jnp,
        sched.timesteps_jnp, jcos, jsin, jnp.float32(3.0), jnp.float32(0.7),
        jnp.float32(0.0), skip, num_conds=2, attn_impl="xla"))
    psched = PS.Schedule(sigmas=sched.sigmas, timesteps=sched.timesteps, num_inference_steps=4)
    steps = []
    with torch.no_grad():
        got = PP.denoise_loop_i2v(ppipe.transformer, torch.from_numpy(lat),
                                  torch.from_numpy(cmask), torch.from_numpy(enc),
                                  torch.from_numpy(mask), psched, cos, sin, num_conds=2,
                                  guidance_scale=3.0, guidance_rescale=0.7,
                                  step_callback=lambda i, n, x: steps.append((i, n))).numpy()
    assert steps == [(i, 4) for i in range(4)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[:, :6], lat[:, :6])
    assert np.abs(got[:, 12:] - lat[:, 12:]).max() > 1e-3  # the soft anchor moved


# ---------------------------------------------------------------------------
# generate()
# ---------------------------------------------------------------------------

GENERATE_CASES = {
    "image-sample": (DISTILLED, dict(image=_image(1)), "sample"),
    "image-argmax-cfg": (CFG_RESCALE, dict(image=_image(2)[0]), "argmax"),
    "image_latents": (DISTILLED, dict(image_latents=np.random.default_rng(3).normal(
        size=(1, 8, 1, 8, 12)).astype(np.float32)), "sample"),
    "two-anchors": (DISTILLED, dict(conditioning=[
        dict(image=_image(4), frame_index=0),
        dict(latents=np.random.default_rng(5).normal(size=(1, 8, 1, 8, 12)).astype(np.float32),
             frame_index=2, strength=0.6)]), "sample"),
    "two-anchors-cfg": (CFG_RESCALE, dict(conditioning=[
        dict(image=_image(6), frame_index=2, strength=0.9),
        dict(image=_image(7), frame_index=1, strength=0.5)]), "argmax"),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_i2v_matches_jax(trees, case):
    inference, cond, mode = GENERATE_CASES[case]
    jpipe, ppipe = _pipelines(trees, inference)
    kw = dict(height=H, width=W, num_frames=F, seed=11, output_type="latent",
              conditioning_sample_mode=mode, **_embeds(cfg=inference["guidance_scale"] > 1))
    jcond = dict(cond)
    pcond = dict(cond)
    if "conditioning" in cond:
        jcond["conditioning"] = _items(JP, cond["conditioning"])
        pcond["conditioning"] = _items(PP, cond["conditioning"])
    want = np.asarray(JP.generate(jpipe, **_jax_kw(kw), **_jax_kw(jcond)))
    with torch.no_grad():
        got = PP.generate(ppipe, **kw, **pcond).numpy()
    assert got.shape == want.shape == (1, 3 * 8 * 12, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_generate_i2v_video_and_batch_match_jax(trees):
    """One prompt x two videos, the image broadcast to both rows, through
    the decode, tiled and sliced as ``use_vae_tiling`` and
    ``use_vae_slicing`` ask (2x2 spatial tiles a row)."""
    jpipe, ppipe = _pipelines(trees)
    noise = np.random.default_rng(8).normal(size=(2, 8) + LAT).astype(np.float32)
    tiling = dict(tile_sample_min_height=64, tile_sample_min_width=64,
                  tile_sample_min_num_frames=16, tile_sample_stride_height=48,
                  tile_sample_stride_width=48, tile_sample_stride_num_frames=8)
    kw = dict(height=H, width=W, num_frames=F, seed=12, num_videos_per_prompt=2,
              image=_image(9), use_vae_tiling=True, use_vae_slicing=True, **_embeds())
    want = np.asarray(JP.generate(jpipe, **_jax_kw(kw), decode_noise=jnp.asarray(noise),
                                  vae_tiling=JV.TilingConfig(**tiling)))
    with torch.no_grad():
        got = PP.generate(ppipe, **kw, decode_noise=torch.from_numpy(noise),
                          vae_tiling=PP.V.TilingConfig(**tiling)).numpy()
    assert got.shape == want.shape == (2, 3, F, H, W)
    mse = float(np.mean((got.astype(np.float64) - want) ** 2))
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 35.0


def test_bf16_anchor_draw_is_jax_bf16_draw(trees, monkeypatch):
    """A bf16 encoder samples its posterior with ``jax.random.normal(
    PRNGKey(seed + 3 + idx), shape, bfloat16)``, bit for bit; the anchor
    latents follow the JAX composition (bf16 encode, sample, normalise) to
    bf16 rounding."""
    _, vparams = trees
    _, ppipe = _pipelines(trees)
    ppipe.transformer.to(torch.bfloat16)
    ppipe.vae.to(torch.bfloat16)
    ppipe.vae_encoder.to(torch.bfloat16)
    drawn, anchors = [], []
    normal_on = R.normal_on
    monkeypatch.setattr(R, "normal_on", lambda key, shape, dtype=None, device="cpu": drawn.append(
        (key, shape, str(dtype))) or normal_on(key, shape, dtype, device))
    make = PP._anchor_latents
    monkeypatch.setattr(PP, "_anchor_latents", lambda *a, **k: anchors.append(make(*a, **k))
                        or anchors[-1])
    image = _image(10)
    with torch.no_grad():
        out = PP.generate(ppipe, height=H, width=W, num_frames=F, seed=13, image=image,
                          output_type="latent", **_embeds())
    assert torch.isfinite(out).all()
    draws = [d for d in drawn if d[2] == "torch.bfloat16"]
    assert len(draws) == 1 and tuple(draws[0][1]) == (1, 8, 1, 8, 12)
    key, shape, _ = draws[0]
    assert np.array_equal(np.asarray(key, np.uint32), np.asarray(R.prng_key(13 + 3), np.uint32))
    np.testing.assert_array_equal(
        normal_on(key, shape, torch.bfloat16).float().numpy(),
        np.asarray(jax.random.normal(jax.random.PRNGKey(13 + 3), shape, jnp.bfloat16)
                   .astype(jnp.float32)))
    jbf = dict(vparams, encoder=jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                             vparams["encoder"]))
    moments = JV.encode(jbf, JV.LtxVaeConfig(**VAE_CFG), jnp.asarray(image)[:, :, None],
                        use_tiling=False)
    assert moments.dtype == jnp.bfloat16
    want = JV.normalize_latents(JV.gaussian_sample(moments, jax.random.PRNGKey(13 + 3)),
                                vparams["latents_mean"], vparams["latents_std"])
    want = np.asarray(want.astype(jnp.float32))
    got = anchors[0].numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


# ---------------------------------------------------------------------------
# refusals, the step-wise path
# ---------------------------------------------------------------------------


def _refusal_cases():
    lat = np.zeros((1, 8, 1, 8, 12), np.float32)
    return {
        "both": (dict(image=_image(0), conditioning=[PP.ConditioningItem(latents=lat)]),
                 "either `conditioning` or"),
        "frame": (dict(conditioning=[PP.ConditioningItem(latents=lat, frame_index=3)]),
                  "outside latent range"),
        "strength0": (dict(conditioning=[PP.ConditioningItem(latents=lat, strength=0.0)]),
                      "strength must be in"),
        "strength>1": (dict(conditioning=[PP.ConditioningItem(latents=lat, strength=1.5)]),
                       "strength must be in"),
        "empty-item": (dict(conditioning=[PP.ConditioningItem()]), "needs image or latents"),
        "sample-mode": (dict(image=_image(0), conditioning_sample_mode="mode"),
                        "unknown conditioning_sample_mode"),
        "sp": (dict(image_latents=lat, sp_mesh=types.SimpleNamespace(device=torch.device("cpu"))),
               "not supported in SP mode"),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_generate_refuses_as_jax(trees, case):
    _, ppipe = _pipelines(trees)
    kw, match = _refusal_cases()[case]
    with pytest.raises(ValueError, match=match):
        PP.generate(ppipe, height=H, width=W, num_frames=F, output_type="latent",
                    **_embeds(), **kw)


def test_generate_refuses_stochastic_no_vae_and_no_encoder(trees):
    _, ppipe = _pipelines(trees)
    kw = dict(height=H, width=W, num_frames=F, output_type="latent", **_embeds())
    stoch = copy.copy(ppipe)
    stoch.config = _cfg(PC, dict(DISTILLED, stochastic_sampling=True))
    with pytest.raises(ValueError, match="stochastic sampling is not supported with image"):
        PP.generate(stoch, image_latents=np.zeros((1, 8, 1, 8, 12), np.float32), **kw)
    no_vae = copy.copy(ppipe)
    no_vae.vae = None
    with pytest.raises(ValueError, match="requires VAE params"):
        PP.generate(no_vae, image=_image(0), **kw)
    no_encoder = copy.copy(ppipe)
    no_encoder.vae_encoder = None
    with pytest.raises(ValueError, match="VAE encoder"):
        PP.generate(no_encoder, image=_image(0), **kw)
    # precomputed latents need no encoder
    out = PP.generate(no_encoder, image_latents=np.zeros((1, 8, 1, 8, 12), np.float32), **kw)
    assert out.shape == (1, 288, 8)


@pytest.mark.parametrize("k", [None, 1, 2])
def test_stepwise_path_matches_jax(trees, k):
    """``step_callback`` runs the loop step by step (each step's latents to
    the callback); the interrupt set after step k stops before step k + 1,
    as the JAX step-wise path does."""
    jpipe, ppipe = _pipelines(trees, CFG_RESCALE)
    kw = dict(height=H, width=W, num_frames=F, seed=14, image=_image(11),
              output_type="latent", **_embeds(cfg=True))
    seen = {"jax": [], "port": []}

    def callback(name, pipe):
        def fn(i, n, lat):
            seen[name].append((i, n))
            if k is not None and i + 1 == k:
                pipe.interrupt = True
        return fn

    want = np.asarray(JP.generate(jpipe, step_callback=callback("jax", jpipe), **_jax_kw(kw)))
    with torch.no_grad():
        got = PP.generate(ppipe, step_callback=callback("port", ppipe), **kw).numpy()
        ppipe.interrupt = jpipe.interrupt = False
        whole = PP.generate(ppipe, **kw).numpy()
    assert seen["port"] == seen["jax"] == [(i, 3) for i in range(k or 3)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if k is None:
        np.testing.assert_array_equal(got, whole)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["a.png", "a.png:12", "a.png:12:0.9", "C:/imgs/a.png",
                                  "C:/imgs/a.png:3", "C:/x/a.png:3:0.5", "dir:v2/a.png",
                                  "a.png:x:0.5", "a.png:2:y"])
def test_parse_image_spec_matches_jax(spec):
    assert PCLI.parse_image_spec(spec) == JCLI.parse_image_spec(spec)


@pytest.fixture
def tiny_i2v_cli(monkeypatch, tmp_path):
    """The CLI with the tiny configs patched in, an official single file of
    random weights with the encoder, one without it, and two PNG images."""
    from PIL import Image

    from candle_video_tpu_torch.models.ltx_video import loader as PL
    from candle_video_tpu_torch.models.ltx_video import transformer as PTF
    from candle_video_tpu_torch.models.ltx_video import vae as PV
    from candle_video_tpu_torch.models.ltx_video import weight_format as PW

    cfg = _cfg(PC, DISTILLED)
    monkeypatch.setattr(PCLI, "get_config_by_version", lambda version: cfg)
    gen = torch.Generator().manual_seed(0)
    dit = PTF.init_random(cfg.transformer, "cpu", torch.float32, gen)
    dec = PV.init_random(cfg.vae, "cpu", torch.float32, gen)
    enc = PV.init_random_encoder(cfg.vae, "cpu", torch.float32, gen)
    tensors = {PW.officialize_transformer_key(k): v
               for k, v in PL.transformer_state_dict(dit).items()}
    tensors.update({PW.officialize_vae_key(k): v for k, v in PL.vae_decoder_state_dict(dec).items()})
    PL.save_safetensors(tensors, str(tmp_path / "no_encoder.safetensors"))
    tensors.update({PW.officialize_vae_key(k): v for k, v in PL.vae_encoder_state_dict(enc).items()})
    PL.save_safetensors(tensors, str(tmp_path / "full.safetensors"))
    images = []
    for i in range(2):
        path = tmp_path / f"img{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(0, 256, (H, W, 3), np.uint8)).save(path)
        images.append(str(path))
    base = ["--device", "cpu", "--dtype", "float32", "--height", str(H), "--width", str(W),
            "--num-frames", str(F), "--max-sequence-length", "16", "--seed", "3"]
    return dict(cfg=cfg, dit=dit, dec=dec, enc=enc, full=str(tmp_path / "full.safetensors"),
                no_encoder=str(tmp_path / "no_encoder.safetensors"), images=images, base=base,
                out=tmp_path)


def _cli_embeds(cfg):
    shape = (1, 16, cfg.transformer.caption_channels)
    return dict(prompt_embeds=torch.from_numpy(np.random.default_rng(0).normal(size=shape)
                                               * 0.02).float(),
                prompt_attention_mask=torch.ones(shape[:2]))


def test_cli_image_runs_as_generate_with_conditioning(tiny_i2v_cli):
    """``--image a.png --image b.png:2:0.9`` from a file that holds the
    encoder equals ``generate(conditioning=...)`` on the in-memory modules;
    ``load_pipeline`` takes the encoder from the file."""
    from candle_video_tpu_torch.models.ltx_video import loader as PL
    from candle_video_tpu_torch.utils.video_io import load_image

    t = tiny_i2v_cli
    a, b = t["images"]
    out = t["out"] / "cli"
    assert PCLI.main([*t["base"], "--weights-path", t["full"], "--image", a, "--image",
                      f"{b}:2:0.9", "--output-type", "latent", "--output-dir", str(out)]) == 0
    got = PL.load_safetensors(str(out / "latents.safetensors"))["latents"]
    pipe = PP.LtxPipeline(t["cfg"], t["dit"], t["dec"], vae_encoder=t["enc"])
    items = [PP.ConditioningItem(image=load_image(a, H, W)),
             PP.ConditioningItem(image=load_image(b, H, W), frame_index=2, strength=0.9)]
    want = PP.generate(pipe, height=H, width=W, num_frames=F, seed=3, max_sequence_length=16,
                       output_type="latent", conditioning=items, **_cli_embeds(t["cfg"]))
    assert torch.equal(got, want)
    args = PCLI.build_parser().parse_args([*t["base"], "--weights-path", t["no_encoder"]])
    assert PCLI.load_pipeline(args, torch.device("cpu"), torch.float32).vae_encoder is None


def test_cli_vae_tiling_and_slicing_and_the_encoder_refusal(tiny_i2v_cli):
    import numpy as onp

    t = tiny_i2v_cli
    out = t["out"] / "tiled"
    assert PCLI.main([*t["base"], "--weights-path", t["full"], "--vae-tiling", "--vae-slicing",
                      "--output-dir", str(out)]) == 0
    frames = onp.load(out / "video_uint8.npy")
    pipe = PP.LtxPipeline(t["cfg"], t["dit"], t["dec"], vae_encoder=t["enc"])
    from candle_video_tpu_torch.utils import video_io

    video = PP.generate(pipe, height=H, width=W, num_frames=F, seed=3, max_sequence_length=16,
                        use_vae_tiling=True, use_vae_slicing=True, **_cli_embeds(t["cfg"]))
    assert onp.array_equal(frames, video_io.to_uint8_frames(video.numpy()))
    args = PCLI.build_parser().parse_args(["--image", "a.png", "--image", "b.png:4:0.5",
                                           "--vae-tiling", "--vae-slicing"])
    assert args.image == ["a.png", "b.png:4:0.5"] and args.vae_tiling and args.vae_slicing
    with pytest.raises(SystemExit, match="VAE encoder"):
        PCLI.main([*t["base"], "--weights-path", t["no_encoder"], "--image", t["images"][0],
                   "--output-dir", str(t["out"] / "refused")])


def test_random_pipeline_has_an_encoder(monkeypatch):
    cfg = _cfg(PC, DISTILLED)
    monkeypatch.setattr(PCLI, "get_config_by_version", lambda version: cfg)
    monkeypatch.setattr(PCLI, "t5_xxl", lambda: PC.T5Config(vocab_size=64, d_model=64, d_kv=16,
                                                            d_ff=128, num_layers=1, num_heads=4))
    pipe = PCLI.build_random_pipeline("tiny", "cpu", torch.float32, seed=0)
    assert pipe.vae_encoder is not None and pipe.vae_encoder.dtype == torch.float32
    out = PP.generate(pipe, height=H, width=W, num_frames=F, image=_image(0),
                      output_type="latent", **_embeds())
    assert out.shape == (1, 288, 8) and torch.isfinite(out).all()

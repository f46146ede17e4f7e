"""The SVD modules of the PyTorch port against the JAX package on the CPU,
in f32, from one parameter set.

The parameters are the state dicts of the repository's torch mirrors
(``scripts/torch_svd.py`` UNet, ``scripts/torch_svd_vae.py`` VAE) and of HF
``CLIPVisionModelWithProjection``, as the JAX SVD tests build them.  Each
goes through the JAX loader, through ``convert.py`` from the JAX tree, and
through the port's own loader.  Envelopes: CLIP <= 2e-4, UNet max-abs <=
2e-3 (the DiT envelope) against the JAX UNet's f32 XLA attention, VAE atol
5e-4; the ops, the scheduler and the resize at 1e-5 or tighter.

The UNet runs at 48×48 latents with heads (1, 2) of 64: level 0 (2304
tokens, one head) is not lane-packable and takes K6's route, the mid block
(576 tokens, two heads) K1's; both run their plain versions here."""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import torch_svd  # noqa: E402
import torch_svd_vae as tvv  # noqa: E402

from candle_video_tpu.models.svd import clip as JC  # noqa: E402
from candle_video_tpu.models.svd import configs as JCFG  # noqa: E402
from candle_video_tpu.models.svd import scheduler as JS  # noqa: E402
from candle_video_tpu.models.svd import unet as JU  # noqa: E402
from candle_video_tpu.models.svd import vae as JV  # noqa: E402
from candle_video_tpu.models.svd.loader import unet_params_from_state_dict as junet  # noqa: E402
from candle_video_tpu.ops import embeddings as JE  # noqa: E402
from candle_video_tpu.ops import norms as JN  # noqa: E402
from candle_video_tpu_torch.models.svd import clip as PC  # noqa: E402
from candle_video_tpu_torch.models.svd import configs as PCFG  # noqa: E402
from candle_video_tpu_torch.models.svd import convert as PCV  # noqa: E402
from candle_video_tpu_torch.models.svd import loader as PL  # noqa: E402
from candle_video_tpu_torch.models.svd import scheduler as PS  # noqa: E402
from candle_video_tpu_torch.models.svd import unet as PU  # noqa: E402
from candle_video_tpu_torch.models.svd import vae as PV  # noqa: E402
from candle_video_tpu_torch.ops import activations as PA  # noqa: E402
from candle_video_tpu_torch.ops import embeddings as PE  # noqa: E402
from candle_video_tpu_torch.ops import norms as PN  # noqa: E402
from candle_video_tpu_torch.ops.kernels import flash_attention as K6  # noqa: E402
from candle_video_tpu_torch.ops.kernels import flash_attention_packed as FAP  # noqa: E402

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# configs and ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SvdUnetConfig", "SvdVaeConfig", "EulerSchedulerConfig",
                                  "ClipEncoderConfig", "SvdConfig"])
def test_configs_match_jax(name):
    mine, theirs = getattr(PCFG, name), getattr(JCFG, name)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(mine()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize("shape,groups", [((2, 64, 5, 7), 32), ((3, 32, 4), 8),
                                          ((1, 96, 2, 3, 4), 32)])
def test_group_norm_matches_jax(rng, shape, groups):
    x = rng.normal(size=shape).astype(np.float32) * 3 + 1
    w = rng.normal(size=shape[1]).astype(np.float32)
    b = rng.normal(size=shape[1]).astype(np.float32)
    want = np.asarray(JN.group_norm(jnp.asarray(x), groups, jnp.asarray(w), jnp.asarray(b)))
    got = PN.group_norm(_t(x), groups, _t(w), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_gelu_and_quick_gelu_match_jax(rng):
    x = rng.normal(size=(4, 33)).astype(np.float32) * 4
    np.testing.assert_allclose(PA.gelu(_t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(PA.quick_gelu(_t(x)).numpy(),
                               np.asarray(JC._quick_gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dim,shift", [(320, 1.0), (256, 1.0), (8, 1.0), (256, 0.0),
                                       (33, 0.0)])
def test_timestep_embedding_matches_jax(dim, shift):
    t = np.asarray([0.0, 1.0, 6.0, 127.0, 0.02, -1.553, 999.0], np.float32)
    want = np.asarray(JE.sinusoidal_timestep_embedding(jnp.asarray(t), dim, True, shift))
    got = PE.sinusoidal_timestep_embedding(_t(t), dim, shift).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-6)


def test_ltx_timestep_embedding_default_is_unchanged():
    """The LTX call (flip, no shift) computes exactly what it did before the
    shift was added."""
    t = torch.tensor([0.0, 3.5, 999.0])
    half = 128
    exponent = -math.log(10000.0) * np.arange(half, dtype=np.float32) / np.float32(half)
    freqs = t[:, None] * torch.from_numpy(np.exp(exponent).astype(np.float32))[None, :]
    want = torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1)
    assert torch.equal(PE.sinusoidal_timestep_embedding(t, 256), want)


def test_unet_timestep_embedding_matches_jax():
    t = np.asarray([0.25 * math.log(700.0), 0.0, 3.0], np.float32)
    np.testing.assert_allclose(PU.timestep_embedding(_t(t), 320).numpy(),
                               np.asarray(JU.timestep_embedding(jnp.asarray(t), 320)),
                               atol=2e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spacing,karras,kind", [("leading", True, "continuous"),
                                                 ("trailing", True, "continuous"),
                                                 ("linspace", False, "discrete"),
                                                 ("leading", False, "discrete")])
@pytest.mark.parametrize("steps", [25, 7])
def test_set_timesteps_matches_jax(spacing, karras, kind, steps):
    kw = dict(timestep_spacing=spacing, use_karras_sigmas=karras, timestep_type=kind)
    want = JS.set_timesteps(JCFG.EulerSchedulerConfig(**kw), steps)
    got = PS.set_timesteps(PCFG.EulerSchedulerConfig(**kw), steps)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    assert got.init_noise_sigma == want.init_noise_sigma
    assert got.num_inference_steps == want.num_inference_steps == steps


@pytest.mark.parametrize("prediction", ["v_prediction", "epsilon", "sample"])
def test_step_scale_and_add_noise_match_jax(rng, prediction):
    x = rng.normal(size=(3, 4, 5, 6)).astype(np.float32) * 10
    mo = rng.normal(size=x.shape).astype(np.float32)
    sigma, sigma_next = 14.61, 9.7
    prev, x0 = PS.step(_t(x), _t(mo), sigma, sigma_next, prediction)
    jprev, jx0 = JS.step(jnp.asarray(x), jnp.asarray(mo), sigma, sigma_next, prediction)
    np.testing.assert_allclose(prev.numpy(), np.asarray(jprev), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(PS.scale_model_input(_t(x), sigma).numpy(),
                               np.asarray(JS.scale_model_input(jnp.asarray(x), sigma)), rtol=1e-6)
    np.testing.assert_allclose(PS.add_noise(_t(x), _t(mo), sigma).numpy(),
                               np.asarray(JS.add_noise(jnp.asarray(x), jnp.asarray(mo), sigma)),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# CLIP: HF transformers' state dict through the JAX loader, convert.py and
# the port's loader
# ---------------------------------------------------------------------------

TINY_CLIP = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, image_size=28, patch_size=14, projection_dim=32)


@pytest.fixture(scope="module")
def clip_pair():
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    torch.manual_seed(0)
    hf = CLIPVisionModelWithProjection(CLIPVisionConfig(hidden_act="quick_gelu",
                                                        **TINY_CLIP)).eval()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    sd["vision_model.embeddings.position_ids"] = np.arange(5)[None]  # older checkpoints
    params = JC.params_from_hf_state_dict(sd, JCFG.ClipEncoderConfig(**TINY_CLIP), jnp.float32)
    cfg = PCFG.ClipEncoderConfig(**TINY_CLIP)
    return (params, PC.params_from_hf_state_dict(sd, cfg),
            PCV.clip_from_jax(_tree(params), cfg), hf)


def test_clip_matches_jax(clip_pair, rng):
    params, mine, converted, hf = clip_pair
    x = rng.uniform(0, 1, size=(2, 3, 28, 28)).astype(np.float32)
    xn = np.asarray(JC.normalize_for_clip(jnp.asarray(x)))
    np.testing.assert_allclose(PC.normalize_for_clip(_t(x)).numpy(), xn, atol=1e-6)
    want = np.asarray(JC.forward(params, JCFG.ClipEncoderConfig(**TINY_CLIP), jnp.asarray(xn)))
    with torch.no_grad():
        got = mine(_t(xn)).numpy()
        got_conv = converted(_t(xn)).numpy()
        ref = hf(pixel_values=_t(xn)).image_embeds.numpy()
    assert got.shape == want.shape == (2, 32)
    assert np.abs(got - want).max() <= 2e-4
    np.testing.assert_array_equal(got_conv, got)
    assert np.abs(got - ref).max() <= 2e-4


@pytest.mark.parametrize("src,dst", [((96, 160), (28, 28)), ((37, 53), (28, 28)),
                                     ((16, 16), (28, 28)), ((576, 1024), (224, 224)),
                                     ((28, 100), (28, 28))])
def test_resize_matches_jax_image_resize(rng, src, dst):
    x = rng.uniform(0, 1, size=(1, 3) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3) + dst, method="bilinear"))
    got = PC.resize_bilinear(_t(x), *dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# UNet: the torch mirror's state dict
# ---------------------------------------------------------------------------

UNET = dict(in_channels=8, out_channels=4, block_out_channels=(64, 128), layers_per_block=1,
            cross_attention_dim=32, num_attention_heads=(1, 2), addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24)


@pytest.fixture(scope="module")
def unet_pair():
    torch.manual_seed(0)
    mirror = torch_svd.UNetSpatioTemporal(
        in_channels=8, out_channels=4, block_out_channels=(64, 128), layers_per_block=1,
        cross_dim=32, heads=(1, 2), addition_time_embed_dim=8).eval()
    sd = {k: v.numpy() for k, v in mirror.state_dict().items()}
    params = junet(sd, jnp.float32)
    cfg = PCFG.SvdUnetConfig(**UNET)
    return params, PL.unet_params_from_state_dict(sd, cfg), PCV.unet_from_jax(_tree(params), cfg)


def test_unet_matches_jax_through_k6_and_k1_routes(unet_pair, rng, monkeypatch):
    params, mine, converted = unet_pair
    f = 2
    x = rng.normal(size=(f, 8, 48, 48)).astype(np.float32)
    ehs = (rng.normal(size=(f, 1, 32)) * 0.5).astype(np.float32)
    ids = np.asarray([[6, 127, 0.02]], np.float32)
    t = np.asarray([0.25 * math.log(14.6)], np.float32)
    want = np.asarray(JU.forward(params, JCFG.SvdUnetConfig(**UNET), jnp.asarray(x),
                                 jnp.asarray(t), jnp.asarray(ehs), jnp.asarray(ids), f))
    calls = {"k6": 0, "k1": 0}

    def count(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(K6, "flash_attention_plain", count("k6", K6.flash_attention_plain))
    monkeypatch.setattr(FAP, "flash_attention_packed_plain",
                        count("k1", FAP.flash_attention_packed_plain))
    with torch.no_grad():
        got = mine(_t(x), _t(t), _t(ehs), _t(ids), f).numpy()
    # level 0 (2304 tokens, 1 head): down block 0's transformer and up block
    # 1's two; the mid block (576 tokens, 2 heads) takes K1
    assert calls == {"k6": 3, "k1": 1}
    assert got.shape == want.shape == (f, 4, 48, 48)
    assert np.abs(got - want).max() <= 2e-3
    with torch.no_grad():
        np.testing.assert_array_equal(
            converted(_t(x), _t(t), _t(ehs), _t(ids), f).numpy(), got)


def test_full_size_unet_has_the_diffusers_layout():
    """The full config on the meta device: the up blocks' resnet input
    channels of the diffusers checkpoint (JAX ``UP_BLOCK_CHANNELS``), the
    level heads, and the total parameter count of SVD's UNet."""
    cfg = PCFG.SvdUnetConfig()
    with torch.device("meta"):
        model = PU.UNetSpatioTemporalConditionModel(cfg)
    for blk, (ins, out, has_attn, has_up) in zip(model.up_blocks, JU.UP_BLOCK_CHANNELS):
        assert tuple(r.spatial_res_block.conv1.in_channels for r in blk.resnets) == ins
        assert all(r.spatial_res_block.conv1.out_channels == out for r in blk.resnets)
        assert (blk.attentions is not None) == has_attn
        assert (blk.upsamplers is not None) == has_up
    heads = [a.transformer_blocks[0].attn1.heads for blk in model.down_blocks
             if blk.attentions is not None for a in blk.attentions]
    assert heads == [5, 5, 10, 10, 20, 20]
    assert sum(p.numel() for p in model.parameters()) == 1_524_623_082


# ---------------------------------------------------------------------------
# VAE: the torch mirror's state dict
# ---------------------------------------------------------------------------

VAE = dict(block_out_channels=(32, 64), latent_channels=4, layers_per_block=1)


@pytest.fixture(scope="module")
def vae_pair():
    torch.manual_seed(1)
    mirror = tvv.AutoencoderKLTemporalDecoder(boc=(32, 64), latent=4, layers=1).eval()
    sd = {k: v.numpy() for k, v in mirror.state_dict().items()}
    params = JV.vae_params_from_state_dict(sd, jnp.float32)
    cfg = PCFG.SvdVaeConfig(**VAE)
    return (params, PV.vae_params_from_state_dict(sd, cfg),
            PCV.vae_from_jax(_tree(params), cfg))


def test_vae_encode_matches_jax(vae_pair, rng):
    params, mine, converted = vae_pair
    cfg = JCFG.SvdVaeConfig(**VAE)
    x = rng.uniform(-1, 1, size=(2, 3, 32, 48)).astype(np.float32)
    want = np.asarray(JV.encode_to_latent(params, cfg, jnp.asarray(x)))
    key = jax.random.PRNGKey(3)
    want_s = np.asarray(JV.encode_to_latent(params, cfg, jnp.asarray(x), key))
    noise = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    with torch.no_grad():
        got = PV.encode_to_latent(mine, _t(x)).numpy()
        got_s = PV.encode_to_latent(mine, _t(x), _t(noise)).numpy()
        np.testing.assert_array_equal(PV.encode_to_latent(converted, _t(x)).numpy(), got)
        moments = PV.encoder_forward(mine, _t(x)).numpy()
    assert got.shape == (2, 4, 16, 24)  # one downsampler: /2
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    np.testing.assert_allclose(got_s, want_s, atol=5e-4, rtol=0)
    np.testing.assert_allclose(
        moments, np.asarray(JV.encoder_forward(params["encoder"], cfg, jnp.asarray(x))),
        atol=5e-4, rtol=0)


@pytest.mark.parametrize("chunk", [None, 2])
def test_vae_decode_matches_jax(vae_pair, rng, chunk):
    params, mine, _ = vae_pair
    f = 3
    z = rng.normal(size=(f, 4, 4, 6)).astype(np.float32)
    want = np.asarray(JV.decode(params, JCFG.SvdVaeConfig(**VAE), jnp.asarray(z), f,
                                chunk_size=chunk))
    with torch.no_grad():
        got = PV.decode(mine, _t(z), f, chunk_size=chunk).numpy()
    assert got.shape == (f, 3, 8, 12)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_full_size_vae_has_the_diffusers_layout():
    with torch.device("meta"):
        vae = PV.AutoencoderKLTemporalDecoder(PCFG.SvdVaeConfig())
    assert len(vae.decoder.mid_block.resnets) == 2
    assert [len(b.resnets) for b in vae.decoder.up_blocks] == [3, 3, 3, 3]
    assert [len(b.resnets) for b in vae.encoder.down_blocks] == [2, 2, 2, 2]


def test_init_random_is_seeded_and_finite():
    cfg = PCFG.SvdUnetConfig(**UNET)
    a = PU.init_random(cfg, "cpu", torch.float32, torch.Generator().manual_seed(5))
    b = PU.init_random(cfg, "cpu", torch.float32, torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb) and torch.isfinite(pa).all(), name
    assert a.down_blocks[0].resnets[0].time_mixer.mix_factor.item() == 0.5
    assert a.conv_norm_out.weight.min().item() == 1.0

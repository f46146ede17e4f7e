"""The PyTorch port's VAE decoder (dense, NCDHW; the streamed modes are in
``test_torch_vae_stream.py``) against the JAX package's
decoder on the CPU, in f32, on a narrow timestep-conditioned config.
Tolerance: atol 5e-4 against both JAX layouts (channels-first and
channels-last)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video.vae_init import init_vae_params
from candle_video_tpu_torch.models.ltx_video import vae as PV
from candle_video_tpu_torch.models.ltx_video.configs import LtxVaeConfig
from candle_video_tpu_torch.models.ltx_video.convert import vae_decoder_from_jax

torch.set_num_threads(2)

TINY = dict(
    latent_channels=8,
    block_out_channels=(8, 16, 32),
    decoder_block_out_channels=(8, 16),
    spatiotemporal_scaling=(True, True),
    decoder_spatiotemporal_scaling=(True, True),
    layers_per_block=(1, 1, 2),
    decoder_layers_per_block=(1, 1, 1),
    patch_size=2,
    downsample_types=("spatiotemporal", "spatiotemporal"),
    decoder_upsample_residual=(True, True),
    decoder_upsample_factor=(2, 2),
    decoder_causal=False,
    spatial_compression_ratio=8,
    temporal_compression_ratio=4,
)


def _tree(seed=1):
    params = init_vae_params(jax.random.PRNGKey(seed), JV.LtxVaeConfig(**TINY),
                             dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, params)
    # non-zero biases and latent statistics so the carry-over is exercised
    dec = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.02
                       if a.ndim == 1 else a, tree["decoder"])
    tree["decoder"] = dec
    tree["latents_mean"] = rng.normal(size=8).astype(np.float32) * 0.1
    tree["latents_std"] = 1.0 + rng.uniform(size=8).astype(np.float32)
    return tree


@pytest.mark.parametrize("channels_last", [False, True])
def test_decoder_matches_jax(rng, channels_last):
    tree = _tree()
    jcfg, pcfg = JV.LtxVaeConfig(**TINY), LtxVaeConfig(**TINY)
    dec = vae_decoder_from_jax(tree, pcfg, device="cpu")
    z = rng.normal(size=(2, 8, 3, 4, 5)).astype(np.float32)
    temb = np.array([0.05, 0.3], np.float32)
    want = JV.decoder_forward(jax.tree.map(jnp.asarray, tree["decoder"]), jcfg,
                              jnp.asarray(z), jnp.asarray(temb),
                              channels_last=channels_last)
    with torch.no_grad():
        got = PV.decode(dec, torch.from_numpy(z), torch.from_numpy(temb))
    assert got.shape == (2, 3, 9, 32, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


def test_denormalize_and_unsupported_modes(rng):
    lat = rng.normal(size=(1, 8, 2, 3, 3)).astype(np.float32)
    mean = rng.normal(size=8).astype(np.float32)
    std = rng.uniform(1, 2, size=8).astype(np.float32)
    got = PV.denormalize_latents(torch.from_numpy(lat), torch.from_numpy(mean),
                                 torch.from_numpy(std))
    want = JV.denormalize_latents(jnp.asarray(lat), jnp.asarray(mean), jnp.asarray(std))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    dec = PV.init_random(LtxVaeConfig(**TINY), "cpu", torch.float32,
                         generator=torch.Generator().manual_seed(1))
    tree = _tree()
    tiling = dict(tile_sample_min_height=24, tile_sample_min_width=24,
                  tile_sample_stride_height=16, tile_sample_stride_width=16)
    zt = rng.normal(size=(1, 8, 2, 4, 4)).astype(np.float32)
    with torch.no_grad():
        tiled = PV.decode(vae_decoder_from_jax(tree, LtxVaeConfig(**TINY), device="cpu"), torch.from_numpy(zt),
                          torch.tensor([0.05]), tiling=PV.TilingConfig(**tiling), use_tiling=True)
    jdec = jax.tree.map(jnp.asarray, tree["decoder"])
    want = JV.tiled_decode(None, JV.LtxVaeConfig(**TINY), jnp.asarray(zt),
                           jnp.asarray([0.05], jnp.float32), JV.TilingConfig(**tiling),
                           jax.jit(lambda zz, tt: JV.decoder_forward(
                               jdec, JV.LtxVaeConfig(**TINY), zz, tt)))
    assert tiled.shape == (1, 3, 5, 32, 32)
    np.testing.assert_allclose(tiled.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    z = torch.from_numpy(rng.normal(size=(1, 8, 3, 2, 2)).astype(np.float32))
    with torch.no_grad():
        streamed = PV.decode(dec, z, tail_stream_chunks=2)
        dense = PV.decode(dec, z)
    assert streamed.shape == dense.shape == (1, 3, 9, 16, 16)
    np.testing.assert_allclose(streamed.numpy(), dense.numpy(), atol=1e-5, rtol=0)


def test_decoder_rejects_noise_injection():
    """Noise injection needs a flag for the mid block and every up block:
    a shorter ``decoder_inject_noise`` that asks for it is refused (the
    full tuple builds the scales, ``tests/test_torch_vae_noise.py``)."""
    cfg = LtxVaeConfig(**TINY, decoder_inject_noise=(True,))
    with pytest.raises(ValueError, match="decoder_inject_noise"):
        PV.LtxVaeDecoder(cfg, torch.float32)


def test_random_init_decoder_runs():
    dec = PV.init_random(LtxVaeConfig(**TINY), "cpu", torch.float32,
                         generator=torch.Generator().manual_seed(3))
    assert float(dec.timestep_scale_multiplier) == 1000.0
    with torch.no_grad():
        out = dec(torch.randn(1, 8, 2, 2, 3, generator=torch.Generator().manual_seed(0)),
                  torch.tensor([0.05]))
    assert out.shape == (1, 3, 5, 16, 24) and torch.isfinite(out).all()

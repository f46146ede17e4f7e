"""The PyTorch port's VAE decoder noise injection on the CPU, in f32, against
the JAX package's ``decoder_forward(noise_key=PRNGKey(7))`` on the same
weights.

The JAX random init makes no ``per_channel_scale1/2``, so the JAX tree gets
them here (random [C, 1, 1], as a diffusers checkpoint holds them) for every
decoder resnet; without them the JAX injection is a no-op.  Tolerances: the
port against JAX atol 5e-4 (the VAE envelope of ``test_torch_vae.py``; the
float32 noise itself agrees to a few ulp, ``test_torch_threefry.py``), the
port's streamed walks against its dense decode atol 1e-5 (the overlap-save
steps sum the same products in another order).  Also the loader and
``vae_decoder_from_jax`` carrying the scales."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import loader as JL
from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video.vae_init import init_vae_params
from candle_video_tpu_torch.models.ltx_video import loader as L
from candle_video_tpu_torch.models.ltx_video import vae as PV
from candle_video_tpu_torch.models.ltx_video.configs import LtxVaeConfig
from candle_video_tpu_torch.models.ltx_video.convert import vae_decoder_from_jax
from candle_video_tpu_torch.utils import rng as R

torch.set_num_threads(2)

# the geometry of tests/test_vae.py's channels-last test: two up blocks of
# two resnets, a mid block of two
CFG = dict(in_channels=3, out_channels=3, latent_channels=4,
           block_out_channels=(8, 16, 32), decoder_block_out_channels=(8, 16),
           spatiotemporal_scaling=(True, True), decoder_spatiotemporal_scaling=(True, True),
           layers_per_block=(1, 1, 2), decoder_layers_per_block=(2, 2, 2),
           patch_size=2, patch_size_t=1,
           downsample_types=("spatiotemporal", "spatiotemporal"),
           decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
           timestep_conditioning=True, spatial_compression_ratio=8,
           temporal_compression_ratio=4)
ATOL_JAX = 5e-4
ATOL_DENSE = 1e-5
NOISE_SEED = 7
# the decoder's injecting resnets: mid (2) and two up blocks (2 each)
N_RESNETS = 6


def _resnets(dec):
    yield from dec["mid_block"]["resnets"]
    for blk in dec["up_blocks"]:
        yield from blk["resnets"]


def _models(causal: bool, inject: bool):
    """(JAX config, JAX decoder tree, port decoder, numpy tree) with
    non-zero biases and, with ``inject``, random noise scales."""
    jcfg = JV.LtxVaeConfig(**CFG, decoder_causal=causal, decoder_inject_noise=(inject,) * 4)
    tree = jax.tree.map(np.asarray, init_vae_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    rng = np.random.default_rng(0)
    tree["decoder"] = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.02 if a.ndim == 1 else a,
        tree["decoder"])
    if inject:
        for res in _resnets(tree["decoder"]):
            c = res["conv1"]["weight"].shape[0]
            for name in ("per_channel_scale1", "per_channel_scale2"):
                res[name] = (rng.normal(size=(c, 1, 1)) * 0.5).astype(np.float32)
    pcfg = LtxVaeConfig(**CFG, decoder_causal=causal, decoder_inject_noise=(inject,) * 4)
    jdec = jax.tree.map(jnp.asarray, tree["decoder"])
    return jcfg, jdec, vae_decoder_from_jax(tree, pcfg, device="cpu"), tree


@pytest.fixture(scope="module")
def injecting():
    return _models(False, True)


def _z(t, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, 4, t, 4, 4)).astype(np.float32), np.array([0.05], np.float32)


def _port(fn, *args, **kw):
    with torch.no_grad():
        return fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args),
                  **kw).numpy()


@pytest.mark.parametrize("causal,inject", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_dense_decode_matches_jax_decoder_forward(causal, inject):
    """tests/test_vae.py:536's cases (and causal with injection): the
    port's dense decode with ``noise_key`` against JAX ``decoder_forward``
    in both JAX layouts; with injection the noise moves the video."""
    jcfg, jdec, dec, _ = _models(causal, inject)
    z, temb = _z(7)
    nk = jax.random.PRNGKey(NOISE_SEED) if inject else None
    got = _port(dec, z, temb, noise_key=R.prng_key(NOISE_SEED) if inject else None)
    assert got.shape == (1, 3, 25, 32, 32)
    for cl in (False, True):
        want = JV.decoder_forward(jdec, jcfg, jnp.asarray(z), jnp.asarray(temb), noise_key=nk,
                                  channels_last=cl)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_JAX, rtol=0,
                                   err_msg=f"causal={causal} inject={inject} cl={cl}")
    if inject:
        quiet = _port(dec, z, temb)  # no key: no noise, as JAX without one
        assert np.abs(got - quiet).max() > 100 * ATOL_JAX
        other = _port(dec, z, temb, noise_key=R.prng_key(NOISE_SEED + 1))
        assert np.abs(got - other).max() > 100 * ATOL_JAX


def test_injection_draws_two_hw_rows_per_resnet(injecting, monkeypatch):
    """Every injecting resnet draws twice, [H, W] in the activation's dtype,
    from ``split(noise_key)`` then ``split`` of its first half: every
    resnet starts from the same key, as the JAX ``_resnet_core`` does."""
    _, _, dec, _ = injecting
    draws, normal_on = [], R.normal_on
    monkeypatch.setattr(R, "normal_on", lambda key, shape, dtype=None, device="cpu": draws.append(
        (tuple(int(k) for k in key), tuple(shape), dtype)) or normal_on(key, shape, dtype, device))
    z, temb = _z(3)
    _port(dec, z, temb, noise_key=R.prng_key(NOISE_SEED))
    assert len(draws) == 2 * N_RESNETS
    k1, sub1 = R.split(R.prng_key(NOISE_SEED))
    _, sub2 = R.split(k1)
    want = [tuple(int(k) for k in sub1), tuple(int(k) for k in sub2)] * N_RESNETS
    assert [d[0] for d in draws] == want
    assert all(d[2] == torch.float32 and len(d[1]) == 2 for d in draws)
    assert {d[1] for d in draws} == {(4, 4), (8, 8), (16, 16)}


@pytest.mark.parametrize("n", [2, 4])
def test_tail_stream_injects_as_dense_and_jax(injecting, n):
    jcfg, jdec, dec, _ = injecting
    z, temb = _z(7)
    nk = R.prng_key(NOISE_SEED)
    dense = _port(dec, z, temb, noise_key=nk)
    head = _port(PV.decoder_head_forward_cl, dec, z, temb, noise_key=nk)
    got = _port(PV.decoder_tail_streamed, dec, head, temb, n_chunks=n, noise_key=nk)
    np.testing.assert_allclose(got, dense, atol=ATOL_DENSE, rtol=0)
    want = JV.decoder_forward(jdec, jcfg, jnp.asarray(z), jnp.asarray(temb),
                              noise_key=jax.random.PRNGKey(NOISE_SEED), tail_stream_chunks=n)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_JAX, rtol=0)


@pytest.mark.parametrize("n", [2, 3])
def test_ups_tail_stream_injects_as_dense_and_jax(injecting, n):
    jcfg, jdec, dec, _ = injecting
    z, temb = _z(7, seed=2)
    nk = R.prng_key(NOISE_SEED)
    dense = _port(dec, z, temb, noise_key=nk)
    head = _port(PV.decoder_head_pre_ups_forward_cl, dec, z, temb, noise_key=nk)
    got = _port(PV.decoder_ups_tail_streamed, dec, head, temb, n_chunks=n, noise_key=nk)
    np.testing.assert_allclose(got, dense, atol=ATOL_DENSE, rtol=0)
    want = JV.decoder_forward(jdec, jcfg, jnp.asarray(z), jnp.asarray(temb),
                              noise_key=jax.random.PRNGKey(NOISE_SEED), tail_stream_chunks=n,
                              tail_stream_from_ups=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_JAX, rtol=0)


def test_fullstream_injects_as_dense_and_jax(injecting):
    jcfg, jdec, dec, _ = injecting
    z, temb = _z(24, seed=3)
    nk = R.prng_key(NOISE_SEED)
    dense = _port(dec, z, temb, noise_key=nk)
    got = _port(PV.decoder_forward_fullstream, dec, z, temb, n_chunks=2, noise_key=nk)
    np.testing.assert_allclose(got, dense, atol=ATOL_DENSE, rtol=0)
    want = JV.decoder_forward_fullstream(jdec, jcfg, jnp.asarray(z), jnp.asarray(temb),
                                         noise_key=jax.random.PRNGKey(NOISE_SEED), n_chunks=2)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_JAX, rtol=0)


def test_decode_facade_passes_no_key(injecting):
    """``decode`` injects nothing, as the JAX ``decode`` passes no key."""
    _, _, dec, _ = injecting
    z, temb = _z(3)
    np.testing.assert_array_equal(_port(PV.decode, dec, z, temb), _port(dec, z, temb))


def test_vae_from_jax_carries_the_scales(injecting):
    _, _, dec, tree = injecting
    jres = list(_resnets(tree["decoder"]))
    pres = list(dec.mid_block.resnets) + [r for b in dec.up_blocks for r in b.resnets]
    assert len(jres) == len(pres) == N_RESNETS
    for j, p in zip(jres, pres):
        for name in ("per_channel_scale1", "per_channel_scale2"):
            np.testing.assert_array_equal(getattr(p, name).detach().numpy(), j[name])
    with pytest.raises(KeyError, match="per_channel_scale"):  # no place for them
        vae_decoder_from_jax(tree, LtxVaeConfig(**CFG), device="cpu")


@pytest.mark.parametrize("spelling", ["", ".weight"])
def test_loader_reads_the_scales_as_jax_does(injecting, spelling):
    """The writer's state dict (the scales under diffusers' names, or with
    ``.weight`` as some files spell them) loads back to the same decoder,
    and the JAX loader reads the same scales from it."""
    _, _, dec, _ = injecting
    sd = {}
    for k, v in L.vae_decoder_state_dict(dec).items():
        sd[k + spelling if ".per_channel_scale" in k else k] = v.detach().clone()
    assert sum(".per_channel_scale" in k for k in sd) == 2 * N_RESNETS
    back = L.vae_decoder_from_state_dict(sd, dec.cfg, "cpu", torch.float32)
    for (name, a), (_, b) in zip(dec.state_dict().items(), back.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    npsd = {k: v.numpy() for k, v in sd.items()}
    prefixes = [f"decoder.mid_block.resnets.{j}" for j in range(2)] + [
        f"decoder.up_blocks.{i}.resnets.{j}" for i in range(2) for j in range(2)]
    for pre, p in zip(prefixes, list(back.mid_block.resnets)
                      + [r for b in back.up_blocks for r in b.resnets]):
        j = JL._resnet_params(npsd, pre, jnp.float32)  # the JAX loader's resnet reader
        for name in ("per_channel_scale1", "per_channel_scale2"):
            np.testing.assert_array_equal(np.asarray(j[name]),
                                          getattr(p, name).detach().numpy())
    plain = dataclasses.replace(dec.cfg, decoder_inject_noise=(False,) * 4)
    with pytest.raises(L.LoaderError, match="no place for"):
        L.vae_decoder_from_state_dict(sd, plain, "cpu", torch.float32)


def test_random_init_makes_the_scales():
    cfg = LtxVaeConfig(**CFG, decoder_inject_noise=(True,) * 4)
    dec = PV.init_random(cfg, "cpu", torch.float32, generator=torch.Generator().manual_seed(0))
    scales = [p for n, p in dec.named_parameters() if ".per_channel_scale" in n]
    assert len(scales) == 2 * N_RESNETS and all(s.shape[1:] == (1, 1) for s in scales)
    assert all(float(s.detach().abs().sum()) > 0 for s in scales)
    mixed = PV.empty_decoder(dataclasses.replace(cfg, decoder_inject_noise=(False, True, False,
                                                                            False)),
                             "cpu", torch.float32)
    # the flags run in the config's order, which the decoder reverses: of
    # four flags the second is the second up block's (the third reversed)
    assert mixed.up_blocks[0].resnets[0].per_channel_scale1 is None
    assert mixed.up_blocks[1].resnets[0].per_channel_scale1 is not None
    assert mixed.mid_block.resnets[0].per_channel_scale1 is None

"""The PyTorch port's exact streamed VAE decode modes on the CPU, in f32:
each against the port's dense decode (atol 1e-5: the overlap-save steps sum
the same products in another order) and against the JAX package's streamed
decode on the same weights (atol 5e-4, the VAE envelope of
``test_torch_vae.py``).  Geometry of the JAX package's streaming tests: two
spatiotemporal up blocks, two resnets per block."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video.vae_init import init_vae_params
from candle_video_tpu_torch.models.ltx_video import vae as PV
from candle_video_tpu_torch.models.ltx_video.configs import LtxVaeConfig, get_config_by_version
from candle_video_tpu_torch.models.ltx_video.convert import vae_decoder_from_jax

torch.set_num_threads(2)

CFG = dict(in_channels=3, out_channels=3, latent_channels=4,
           block_out_channels=(8, 16, 32), decoder_block_out_channels=(8, 16),
           spatiotemporal_scaling=(True, True), decoder_spatiotemporal_scaling=(True, True),
           layers_per_block=(1, 1, 2), decoder_layers_per_block=(2, 2, 2),
           patch_size=2, patch_size_t=1,
           downsample_types=("spatiotemporal", "spatiotemporal"),
           decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
           timestep_conditioning=True, decoder_causal=False,
           spatial_compression_ratio=8, temporal_compression_ratio=4)
ATOL_DENSE = 1e-5
ATOL_JAX = 5e-4


@pytest.fixture(scope="module")
def models():
    jcfg = JV.LtxVaeConfig(**CFG)
    params = init_vae_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, params)
    # non-zero biases so a misaligned stream cannot hide behind zeros
    tree["decoder"] = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.02 if a.ndim == 1 else a,
        tree["decoder"])
    jdec = jax.tree.map(jnp.asarray, tree["decoder"])
    return jcfg, jdec, vae_decoder_from_jax(tree, LtxVaeConfig(**CFG), device="cpu")


def _z(t, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, 4, t, 4, 4)).astype(np.float32), np.array([0.05], np.float32)


def _port(dec, z, temb, **kw):
    with torch.no_grad():
        return PV.decode(dec, torch.from_numpy(z), torch.from_numpy(temb), **kw).numpy()


@pytest.mark.parametrize("n", [2, 3, 4])
def test_tail_stream_matches_dense_and_jax(models, n):
    jcfg, jdec, dec = models
    z, temb = _z(7)  # head output T = 25, tail delay 5
    dense = _port(dec, z, temb)
    got = _port(dec, z, temb, tail_stream_chunks=n)
    assert got.shape == dense.shape == (1, 3, 25, 32, 32)
    np.testing.assert_allclose(got, dense, atol=ATOL_DENSE, rtol=0)
    want = JV.decoder_forward(jdec, jcfg, jnp.asarray(z), jnp.asarray(temb),
                              tail_stream_chunks=n)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_JAX, rtol=0)


@pytest.mark.parametrize("n", [2, 3])
def test_ups_tail_stream_matches_dense_and_jax(models, n):
    jcfg, jdec, dec = models
    z, temb = _z(7, seed=2)  # pre-upsample T = 13
    dense = _port(dec, z, temb)
    got = _port(dec, z, temb, tail_stream_chunks=n, tail_stream_from_ups=True)
    np.testing.assert_allclose(got, dense, atol=ATOL_DENSE, rtol=0)
    want = JV.decoder_forward(jdec, jcfg, jnp.asarray(z), jnp.asarray(temb),
                              tail_stream_chunks=n, tail_stream_from_ups=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_JAX, rtol=0)


def test_fullstream_matches_dense_and_jax(models):
    jcfg, jdec, dec = models
    z, temb = _z(24, seed=3)
    dense = _port(dec, z, temb)
    got = _port(dec, z, temb, full_stream_chunks=2)
    assert got.shape == dense.shape == (1, 3, 93, 32, 32)
    np.testing.assert_allclose(got, dense, atol=ATOL_DENSE, rtol=0)
    want = JV.decoder_forward_fullstream(jdec, jcfg, jnp.asarray(z), jnp.asarray(temb),
                                         n_chunks=2)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_JAX, rtol=0)


def test_head_and_tail_split_match_jax(models):
    """The split points: the head through the last upsampler, the head
    before it, and the tail on the head's output."""
    jcfg, jdec, dec = models
    z, temb = _z(3, seed=4)
    zt, tt = torch.from_numpy(z), torch.from_numpy(temb)
    with torch.no_grad():
        head = PV.decoder_head_forward(dec, zt, tt)
        pre = PV.decoder_head_pre_ups_forward(dec, zt, tt)
        tail = PV.decoder_tail_forward(dec, head, tt)
    jz, jt = jnp.asarray(z), jnp.asarray(temb)
    np.testing.assert_allclose(head.numpy(), np.asarray(JV.decoder_head_forward(jdec, jcfg, jz, jt)),
                               atol=ATOL_JAX, rtol=0)
    # the JAX package's pre-ups head is channels-last [B,T,H,W,C]
    want_pre = np.asarray(JV.decoder_head_pre_ups_forward_cl(jdec, jcfg, jz, jt))
    np.testing.assert_allclose(pre.numpy(), want_pre.transpose(0, 4, 1, 2, 3),
                               atol=ATOL_JAX, rtol=0)
    np.testing.assert_allclose(
        tail.numpy(), np.asarray(JV.decoder_tail_forward(jdec, jcfg, jnp.asarray(head.numpy()), jt)),
        atol=ATOL_JAX, rtol=0)


@pytest.mark.parametrize("which", ["tiny", "0.9.8"])
def test_stream_fill_functions_match_jax(which):
    pcfg = LtxVaeConfig(**CFG) if which == "tiny" else get_config_by_version(
        "0.9.8-2b-distilled").vae
    jcfg = JV.LtxVaeConfig(**dataclasses.asdict(pcfg))
    # the fill functions read the block structure only: a skeleton of the
    # JAX decoder tree (mid block, then the up blocks, as the reversed
    # decoder_layers_per_block)
    lpb = list(jcfg.decoder_layers_per_block)[::-1]
    jdec = {"mid_block": {"resnets": [None] * lpb[0]},
            "up_blocks": [{"resnets": [None] * n} for n in lpb[1:]]}
    assert PV.tail_stream_delay(pcfg) == JV.tail_stream_delay(jdec)
    assert PV.ups_tail_first_chunk_min(pcfg) == JV.ups_tail_first_chunk_min(jdec, jcfg)
    assert PV.fullstream_first_chunk_min(pcfg) == JV.fullstream_first_chunk_min(jdec, jcfg)
    assert PV.stream_spans(33, 4) == JV.stream_spans(33, 4)
    if which == "0.9.8":
        # two full-stream chunks need 46 latent frames: 257 frames have 33
        assert PV.fullstream_first_chunk_min(pcfg) == 23
        assert (PV.tail_stream_delay(pcfg), PV.ups_tail_first_chunk_min(pcfg)) == (11, 8)


def test_stream_refusals(models):
    jcfg, jdec, dec = models
    z, temb = _z(7)
    with pytest.raises(ValueError, match="pipeline delay"):
        _port(dec, z, temb, tail_stream_chunks=6)
    with pytest.raises(ValueError, match="pipeline fill"):
        _port(dec, z, temb, tail_stream_chunks=4, tail_stream_from_ups=True)
    with pytest.raises(ValueError, match="pipeline fill"):
        _port(dec, *_z(24), full_stream_chunks=3)
    causal = PV.init_random(LtxVaeConfig(**dict(CFG, decoder_causal=True)), "cpu",
                            torch.float32)
    for kw in (dict(tail_stream_chunks=2), dict(full_stream_chunks=2)):
        with pytest.raises(NotImplementedError, match="non-causal"):
            _port(causal, *_z(24), **kw)


def _rank(picked):
    if "full_stream_chunks" in picked:
        return 3
    if picked.get("tail_stream_from_ups"):
        return 2
    return 1 if "tail_stream_chunks" in picked else 0


def _ladder(cfg, shape):
    """The picks of ``select_decode_mode`` as the free memory falls in 3%
    steps from twice what the dense decode needs, and whether it ended by
    refusing (too few latent frames for two full-stream chunks)."""
    b, _, t, h, w = shape
    px = b * t * cfg.temporal_compression_ratio * h * w * cfg.spatial_compression_ratio ** 2
    picks = []
    for i in range(200):
        try:
            picks.append(PV.select_decode_mode(
                cfg, shape, free_bytes=int(2 * PV._DENSE_PEAK_B_PER_PX * px / 0.85 * 0.97 ** i)))
        except ValueError as e:
            assert "full stream needs" in str(e)
            return picks, True
    return picks, False


def test_select_decode_mode_ladder():
    cfg = get_config_by_version("0.9.8-2b-distilled").vae
    shape = (1, 128, 33, 16, 24)  # 512x768x257
    px = 33 * 8 * 512 * 768
    picks, refused = _ladder(cfg, shape)
    ranks = [_rank(p) for p in picks]
    # dense, the tail stream, the ups-split stream; the full stream's first
    # chunk needs 23 latent frames, so two chunks do not fit in 33
    assert ranks == sorted(ranks) and set(ranks) == {0, 1, 2} and refused, picks
    for picked in picks:  # a streamed pick streams in at least two chunks
        assert all(v is True or v >= 2 for v in picked.values()), picked
    # 369 frames at 128x192 (47 latent frames) reach the full stream, in 2 chunks
    picks, refused = _ladder(cfg, (1, 128, 47, 4, 6))
    assert not refused and picks[-1] == {"full_stream_chunks": 2}, picks
    # the dense boundary sits where the dense peak meets 85% of free memory
    edge = PV._DENSE_PEAK_B_PER_PX * px / 0.85
    assert PV.select_decode_mode(cfg, shape, free_bytes=int(edge * 1.01)) == {}
    assert PV.select_decode_mode(cfg, shape, free_bytes=int(edge * 0.99)) != {}
    # dense without a memory reading (the CPU), for causal decoders, below 4 frames
    assert PV._device_free_bytes("cpu") is None
    assert PV.select_decode_mode(cfg, shape, device="cpu") == {}
    assert PV.select_decode_mode(dataclasses.replace(cfg, decoder_causal=True), shape,
                                 free_bytes=2**30) == {}
    assert PV.select_decode_mode(cfg, (1, 128, 3, 16, 24), free_bytes=1) == {}


@pytest.mark.parametrize("frames,lh,lw", [(97, 16, 24), (257, 16, 24), (369, 4, 6)])
def test_ladder_picks_decode_the_098_decoder(frames, lh, lw):
    """Every mode the ladder picks for the 0.9.8 decoder at these clips
    decodes to the clip's shape: the full-width decoder on the meta device,
    which checks each chunk's pipeline fill and every shape without
    computing."""
    cfg = get_config_by_version("0.9.8-2b-distilled").vae
    t = (frames - 1) // 8 + 1
    picks, _ = _ladder(cfg, (1, 128, t, lh, lw))
    with torch.device("meta"):
        dec = PV.LtxVaeDecoder(cfg, torch.bfloat16)
        z, temb = torch.empty(1, 128, t, lh, lw), torch.empty(1)
    with torch.no_grad():
        for picked in {tuple(sorted(p.items())): p for p in picks}.values():
            assert PV.decode(dec, z, temb, **picked).shape == (1, 3, frames, lh * 32, lw * 32)


@pytest.mark.parametrize("t", [4, 5, 6, 9, 24])
def test_ladder_picks_decode_exactly(models, t):
    """On the small decoder, every mode the ladder picks at short latent
    clips decodes (the first chunk clears its fill) and equals dense."""
    _, _, dec = models
    z, temb = _z(t, seed=t)
    dense = _port(dec, z, temb)
    picks, refused = _ladder(dec.cfg, z.shape)
    assert len({_rank(p) for p in picks}) >= 2, picks
    # 24 latent frames hold two full-stream chunks of the 11 it needs
    assert refused == (t < 2 * PV.fullstream_first_chunk_min(dec.cfg)), picks
    for picked in {tuple(sorted(p.items())): p for p in picks}.values():
        np.testing.assert_allclose(_port(dec, z, temb, **picked), dense,
                                   atol=ATOL_DENSE, rtol=0)

"""The PyTorch port's VAE encoder, posterior, tiling and facades against the
JAX package's on the CPU, in f32, on narrow configs.

Tolerances: the encoder's moments atol 1e-4 (f32, 10+ convs), the diffusers
fixture's ``enc_output`` atol 5e-4 (the JAX test's bound); decoded videos
atol 5e-4 (the decoder tests' bound); blends and the posterior 1e-6; the
bf16 posterior's draw bit-equal to ``jax.random.normal(..., bfloat16)``."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video.loader import vae_params_from_state_dict
from candle_video_tpu.models.ltx_video.vae_init import init_vae_params
from candle_video_tpu_torch.models.ltx_video import loader as PL
from candle_video_tpu_torch.models.ltx_video import vae as PV
from candle_video_tpu_torch.models.ltx_video.configs import LtxVaeConfig
from candle_video_tpu_torch.models.ltx_video.convert import (
    vae_decoder_from_jax,
    vae_encoder_from_jax,
)
from candle_video_tpu_torch.ops.kernels import conv3d_igemm as K8
from candle_video_tpu_torch.utils import rng as R

torch.set_num_threads(2)

TINY = dict(
    latent_channels=8, block_out_channels=(8, 16, 32), decoder_block_out_channels=(8, 16),
    spatiotemporal_scaling=(True, True), decoder_spatiotemporal_scaling=(True, True),
    layers_per_block=(1, 1, 2), decoder_layers_per_block=(1, 1, 1), patch_size=2,
    downsample_types=("spatiotemporal", "spatiotemporal"),
    decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
    decoder_causal=False, spatial_compression_ratio=8, temporal_compression_ratio=4)
# widths a multiple of 128 wherever K8 could take a conv: the resnets of both
# blocks and the mid block and both downsamplers' convs (128 -> 512/4, 512 ->
# 512/2), 8 convs; conv_in (12 -> 128) and conv_out (512 -> 9) are not
# eligible
WIDE = dict(TINY, block_out_channels=(128, 512, 512), layers_per_block=(1, 1, 2),
            downsample_types=("spatial", "temporal"), spatial_compression_ratio=4,
            temporal_compression_ratio=2)
# 32x32-pixel tiles every 24 and 8 frames every 4: 17x40x48 samples span
# 2x2 tiles in space and 4 in time, 5x5x6 latents 2x2 and 5
TILES = dict(tile_sample_min_height=32, tile_sample_min_width=32,
             tile_sample_min_num_frames=8, tile_sample_stride_height=24,
             tile_sample_stride_width=24, tile_sample_stride_num_frames=4)


def _tree(cfg, seed=1, norm_out=False):
    """JAX VAE params as numpy, with non-zero biases and latent statistics."""
    tree = jax.tree.map(np.asarray, init_vae_params(jax.random.PRNGKey(seed),
                                                    JV.LtxVaeConfig(**cfg), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for part in ("encoder", "decoder"):
        tree[part] = jax.tree.map(
            lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.02
            if a.ndim == 1 else a, tree[part])
    if norm_out:
        tree["encoder"]["norm_out"] = {
            "weight": 1.0 + rng.normal(size=cfg["block_out_channels"][-1]).astype(np.float32) * 0.1}
    c = cfg["latent_channels"]
    tree["latents_mean"] = rng.normal(size=c).astype(np.float32) * 0.1
    tree["latents_std"] = 1.0 + rng.uniform(size=c).astype(np.float32)
    return tree


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    tree = _tree(TINY)
    pcfg = LtxVaeConfig(**TINY)
    return dict(tree=tree, jparams=_jax(tree), jcfg=JV.LtxVaeConfig(**TINY),
                enc=vae_encoder_from_jax(tree, pcfg, device="cpu"), dec=vae_decoder_from_jax(tree, pcfg, device="cpu"))


def _video(rng, shape):
    return rng.uniform(-1, 1, size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_out", [False, True], ids=["plain", "norm_out"])
@pytest.mark.parametrize("shape", [(1, 3, 9, 16, 24), (2, 3, 5, 32, 16), (1, 3, 1, 16, 16)],
                         ids=["9f", "B2", "image"])
def test_encoder_matches_jax(rng, shape, norm_out):
    tree = _tree(TINY, seed=2, norm_out=norm_out)
    enc = vae_encoder_from_jax(tree, LtxVaeConfig(**TINY), device="cpu")
    assert (enc.norm_out is not None) == norm_out
    x = _video(rng, shape)
    want = np.asarray(JV.encoder_forward(_jax(tree)["encoder"], JV.LtxVaeConfig(**TINY),
                                         jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    b, _, f, h, w = shape
    assert got.shape == want.shape == (b, 16, (f - 1) // 4 + 1, h // 8, w // 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the logvar channel replicated: every channel past the mean is the last one
    np.testing.assert_array_equal(got[:, 8:], np.repeat(got[:, 8:9], 8, axis=1))


def test_primitives_match_jax(rng):
    x = rng.normal(size=(2, 3, 4, 8, 12)).astype(np.float32)
    np.testing.assert_array_equal(PV._patchify(torch.from_numpy(x), 4, 2).numpy(),
                                  np.asarray(JV._patchify(jnp.asarray(x), 4, 2)))
    conv = PV.Downsampler(8, 4, torch.float32)
    with torch.no_grad():
        conv.conv.weight.normal_(0, 0.1, generator=torch.Generator().manual_seed(0))
        conv.conv.bias.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(1))
    p = {"conv": {"weight": jnp.asarray(conv.conv.weight.detach().numpy()),
                  "bias": jnp.asarray(conv.conv.bias.detach().numpy())}}
    h = rng.normal(size=(1, 8, 5, 6, 4)).astype(np.float32)
    for stride, causal in (((2, 2, 2), True), ((1, 2, 2), True), ((2, 1, 1), False)):
        out_channels = 4 * stride[0] * stride[1] * stride[2]
        want = np.asarray(JV._pixel_unshuffle_downsample(p, jnp.asarray(h), stride,
                                                         out_channels, causal=causal))
        with torch.no_grad():
            got = conv(torch.from_numpy(h), stride, out_channels, causal).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "igemm"])
def test_encoder_conv_routes_match_jax(rng, monkeypatch, impl):
    """Through ``F.conv3d`` and through K8's plain version (the CPU side of
    ``CVT_CONV3D_IMPL=igemm``), which takes the eight eligible convs."""
    monkeypatch.setenv("CVT_CONV3D_IMPL", impl)
    tree = _tree(WIDE, seed=3)
    enc = vae_encoder_from_jax(tree, LtxVaeConfig(**WIDE), device="cpu")
    calls = []
    route = K8.conv3d_igemm
    monkeypatch.setattr(K8, "conv3d_igemm", lambda *a, **k: calls.append(a[1].shape)
                        or route(*a, **k))
    x = _video(rng, (1, 3, 5, 16, 16))
    want = np.asarray(JV.encoder_forward(_jax(tree)["encoder"], JV.LtxVaeConfig(**WIDE),
                                         jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 16, 3, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert len(calls) == (8 if impl == "igemm" else 0)
    assert all(K8.eligible(s[1], s[0], s[2:]) for s in calls)


def test_diffusers_fixture_encoder():
    """``fixtures/vae_parity.safetensors`` (diffusers' AutoencoderKLLTXVideo)
    through ``vae_encoder_from_state_dict``, at the JAX test's bound."""
    fx = PL.load_safetensors(str(Path(__file__).resolve().parent.parent / "fixtures"
                                 / "vae_parity.safetensors"))
    sd = {k[len("weights."):]: v for k, v in fx.items() if k.startswith("weights.")}
    cfg = LtxVaeConfig(
        in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(8, 16, 32),
        decoder_block_out_channels=(8, 16), spatiotemporal_scaling=(True, True),
        decoder_spatiotemporal_scaling=(True, True), layers_per_block=(1, 1, 2),
        decoder_layers_per_block=(1, 1, 1), patch_size=2, patch_size_t=1,
        downsample_types=("spatiotemporal", "spatiotemporal"),
        decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
        timestep_conditioning=True, decoder_causal=False, spatial_compression_ratio=8,
        temporal_compression_ratio=4)
    enc = PL.vae_encoder_from_state_dict(sd, cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        got = enc(fx["enc_input"].float()).numpy()
    np.testing.assert_allclose(got, fx["enc_output"].numpy(), atol=5e-4, rtol=0)
    jp = vae_params_from_state_dict({k: v.numpy() for k, v in sd.items()}, jnp.float32)
    want = np.asarray(JV.encoder_forward(jp["encoder"], JV.LtxVaeConfig(**{
        f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()}),
        jnp.asarray(fx["enc_input"].numpy())))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_random_init_encoder_runs():
    enc = PV.init_random_encoder(LtxVaeConfig(**TINY), "cpu", torch.float32,
                                 generator=torch.Generator().manual_seed(3))
    assert enc.norm_out is None
    assert all(float(p.detach().abs().max()) == 0 for n, p in enc.named_parameters()
               if n.endswith(".bias"))
    w = enc.conv_in.weight
    assert abs(float(w.std()) - 0.05) < 0.01
    with torch.no_grad():
        out = enc(torch.rand(1, 3, 5, 16, 24, generator=torch.Generator().manual_seed(0)))
    assert out.shape == (1, 16, 2, 2, 3) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the posterior and the round trip
# ---------------------------------------------------------------------------


def test_gaussian_split_normalize_and_sample_f32(rng):
    m = rng.normal(size=(2, 8, 2, 3, 3)).astype(np.float32)
    mean, logvar = PV.gaussian_split(torch.from_numpy(m))
    jmean, jlogvar = JV.gaussian_split(jnp.asarray(m))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean))
    np.testing.assert_array_equal(logvar.numpy(), np.asarray(jlogvar))
    got = PV.gaussian_sample(torch.from_numpy(m), R.prng_key(45)).numpy()
    want = np.asarray(JV.gaussian_sample(jnp.asarray(m), jax.random.PRNGKey(45)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mu = rng.normal(size=4).astype(np.float32)
    sd = rng.uniform(1, 2, size=4).astype(np.float32)
    got = PV.normalize_latents(torch.from_numpy(m[:, :4]), torch.from_numpy(mu),
                               torch.from_numpy(sd), 0.7).numpy()
    want = np.asarray(JV.normalize_latents(jnp.asarray(m[:, :4]), jnp.asarray(mu),
                                           jnp.asarray(sd), 0.7))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_gaussian_sample_bf16_draws_the_jax_bf16_stream(rng):
    """In bf16 the draw is ``jax.random.normal(key, shape, bfloat16)``, bit
    for bit, another stream than the f32 one."""
    m = rng.normal(size=(1, 16, 1, 4, 6)).astype(np.float32)
    mb = torch.from_numpy(m).bfloat16()
    zeros = mb.clone()
    zeros[:, 8:] = 0  # logvar 0: the sample is mean + eps
    zeros[:, :8] = 0
    eps = PV.gaussian_sample(zeros, R.prng_key(48))
    assert eps.dtype == torch.bfloat16
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(48), (1, 8, 1, 4, 6),
                                        jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(eps.float().numpy(), want)
    f32 = R.normal(R.prng_key(48), (1, 8, 1, 4, 6))
    assert np.abs(f32 - want).max() > 0.5
    got = PV.gaussian_sample(mb, R.prng_key(48)).float().numpy()
    jwant = np.asarray(JV.gaussian_sample(jnp.asarray(m, jnp.bfloat16),
                                          jax.random.PRNGKey(48)).astype(jnp.float32))
    # bf16 mean + exp(logvar/2)·eps: one bf16 rounding apart at most
    np.testing.assert_allclose(got, jwant, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("posterior", [False, True], ids=["mode", "sample"])
def test_forward_matches_jax(tiny, rng, posterior):
    x = _video(rng, (1, 3, 9, 16, 24))
    temb = np.array([0.05], np.float32)
    kw = dict(tiling=PV.TilingConfig(**TILES), use_tiling=False)
    want = np.asarray(JV.forward(tiny["jparams"], tiny["jcfg"], jnp.asarray(x),
                                 jnp.asarray(temb), sample_posterior=posterior,
                                 key=jax.random.PRNGKey(3) if posterior else None,
                                 tiling=JV.TilingConfig(**TILES), use_tiling=False,
                                 use_framewise_decoding=False))
    with torch.no_grad():
        got = PV.forward(tiny["enc"], tiny["dec"], torch.from_numpy(x), torch.from_numpy(temb),
                         sample_posterior=posterior, key=R.prng_key(3) if posterior else None,
                         **kw).numpy()
    assert got.shape == want.shape == (1, 3, 9, 16, 24)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    with pytest.raises(ValueError, match="PRNG key"):
        PV.forward(tiny["enc"], tiny["dec"], torch.from_numpy(x), sample_posterior=True)


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["blend_h", "blend_v", "blend_t"])
@pytest.mark.parametrize("blend", [0, 3, 9])
def test_blends_match_jax(rng, name, blend):
    a = rng.normal(size=(1, 2, 5, 6, 7)).astype(np.float32)
    b = rng.normal(size=(1, 2, 5, 6, 7)).astype(np.float32)
    got = getattr(PV, name)(torch.from_numpy(a), torch.from_numpy(b), blend).numpy()
    want = np.asarray(getattr(JV, name)(jnp.asarray(a), jnp.asarray(b), blend))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _port_decode_fn(dec):
    """The port's decoder as a JAX ``decode_fn``: the JAX tiling loops and
    blends around the port's tiles, so only the tiling arithmetic differs."""
    def fn(zz, tt):
        with torch.no_grad():
            out = dec(torch.from_numpy(np.asarray(zz)), torch.from_numpy(np.asarray(tt)))
        return jnp.asarray(out.numpy())
    return fn


def _port_encode_fn(enc):
    def fn(xx):
        with torch.no_grad():
            return jnp.asarray(enc(torch.from_numpy(np.asarray(xx))).numpy())
    return fn


@pytest.mark.parametrize("temporal", [False, True], ids=["spatial", "temporal"])
def test_tiled_decode_matches_jax(tiny, rng, temporal):
    """2x2 tiles in space (and 5 in time, each 2x2 in space), blended
    against already-blended neighbours; the non-first temporal tiles drop
    their last frame."""
    z = rng.normal(size=(1, 8, 5, 5, 6)).astype(np.float32)
    temb = np.array([0.05], np.float32)
    fn = JV.temporal_tiled_decode if temporal else JV.tiled_decode
    want = np.asarray(fn(tiny["jparams"], tiny["jcfg"], jnp.asarray(z), jnp.asarray(temb),
                         JV.TilingConfig(**TILES), _port_decode_fn(tiny["dec"])))
    fn = PV.temporal_tiled_decode if temporal else PV.tiled_decode
    with torch.no_grad():
        got = fn(tiny["dec"], torch.from_numpy(z), torch.from_numpy(temb),
                 PV.TilingConfig(**TILES)).numpy()
    assert got.shape == want.shape == (1, 3, 17, 40, 48)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("temporal", [False, True], ids=["spatial", "temporal"])
def test_tiled_encode_matches_jax(tiny, rng, temporal):
    """2x2 tiles in space (and 5 in time), blended in latent space; the
    first temporal tile drops its first latent frame."""
    x = _video(rng, (1, 3, 17, 40, 48))
    fn = JV.temporal_tiled_encode if temporal else JV.tiled_encode
    want = np.asarray(fn(tiny["jparams"], tiny["jcfg"], jnp.asarray(x),
                         JV.TilingConfig(**TILES), _port_encode_fn(tiny["enc"])))
    fn = PV.temporal_tiled_encode if temporal else PV.tiled_encode
    with torch.no_grad():
        got = fn(tiny["enc"], torch.from_numpy(x), PV.TilingConfig(**TILES)).numpy()
    assert got.shape == want.shape == (1, 16, 5, 5, 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("flags", [dict(use_tiling=False, use_framewise_decoding=False),
                                   dict(use_tiling=True, use_framewise_decoding=False),
                                   dict(use_tiling=False, use_framewise_decoding=True),
                                   dict(use_tiling=True, use_framewise_decoding=True)],
                         ids=["dense", "spatial", "temporal", "both"])
def test_decode_facade_dispatch_matches_jax(tiny, rng, flags):
    """The JAX facade's order (temporal first, then spatial, then direct),
    with the JAX defaults passed out; the last case through the JAX
    package's own decoder, the others around the port's tiles."""
    z = rng.normal(size=(1, 8, 5, 5, 6)).astype(np.float32)
    temb = np.array([0.05], np.float32)
    tiling = PV.TilingConfig(**TILES)
    own = flags["use_tiling"] and flags["use_framewise_decoding"]
    want = np.asarray(JV.decode(tiny["jparams"], tiny["jcfg"], jnp.asarray(z),
                                jnp.asarray(temb), tiling=JV.TilingConfig(**TILES),
                                decode_fn=None if own else _port_decode_fn(tiny["dec"]),
                                **flags))
    with torch.no_grad():
        got = PV.decode(tiny["dec"], torch.from_numpy(z), torch.from_numpy(temb),
                        tiling=tiling, **flags)
        direct = {"dense": lambda: tiny["dec"](torch.from_numpy(z), torch.from_numpy(temb)),
                  "spatial": lambda: PV.tiled_decode(tiny["dec"], torch.from_numpy(z),
                                                     torch.from_numpy(temb), tiling),
                  "temporal": lambda: PV.temporal_tiled_decode(
                      tiny["dec"], torch.from_numpy(z), torch.from_numpy(temb), tiling)}
        key = ("temporal" if flags["use_framewise_decoding"] else
               "spatial" if flags["use_tiling"] else "dense")
        assert torch.equal(got, direct[key]())
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4 if own else 1e-6, rtol=0)


def test_decode_is_dense_by_default(tiny, rng):
    """The port's one departure from the JAX facade: no tiling unless asked."""
    z = torch.from_numpy(rng.normal(size=(1, 8, 5, 5, 6)).astype(np.float32))
    temb = torch.tensor([0.05])
    with torch.no_grad():
        assert torch.equal(PV.decode(tiny["dec"], z, temb, tiling=PV.TilingConfig(**TILES)),
                           tiny["dec"](z, temb))


@pytest.mark.parametrize("flags", [dict(use_tiling=False, use_framewise_encoding=False),
                                   dict(use_tiling=True, use_framewise_encoding=False),
                                   dict(use_tiling=True, use_framewise_encoding=True)],
                         ids=["direct", "spatial", "temporal"])
def test_encode_facade_dispatch_matches_jax(tiny, rng, flags):
    """The JAX order (temporal, then spatial, then direct) around the
    port's tiles; the direct case through the JAX package's own encoder."""
    x = _video(rng, (1, 3, 17, 40, 48))
    own = not flags["use_tiling"]
    want = np.asarray(JV.encode(tiny["jparams"], tiny["jcfg"], jnp.asarray(x),
                                tiling=JV.TilingConfig(**TILES),
                                encode_fn=None if own else _port_encode_fn(tiny["enc"]),
                                **flags))
    with torch.no_grad():
        got = PV.encode(tiny["enc"], torch.from_numpy(x), tiling=PV.TilingConfig(**TILES),
                        **flags).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 if own else 1e-6, rtol=0)
    # the JAX defaults: spatial tiling on, temporal off
    with torch.no_grad():
        default = PV.encode(tiny["enc"], torch.from_numpy(x), tiling=PV.TilingConfig(**TILES))
        spatial = PV.tiled_encode(tiny["enc"], torch.from_numpy(x), PV.TilingConfig(**TILES))
    assert torch.equal(default, spatial)


def test_slicing_equals_rows_decoded_alone(tiny, rng):
    """``use_slicing`` at B = 2: each row decoded alone, with its own decode
    timestep, dense or tiled."""
    z = torch.from_numpy(rng.normal(size=(2, 8, 3, 5, 6)).astype(np.float32))
    temb = torch.tensor([0.05, 0.3])
    tiling = PV.TilingConfig(**TILES)
    with torch.no_grad():
        sliced = PV.decode(tiny["dec"], z, temb, use_slicing=True)
        rows = [tiny["dec"](z[i:i + 1], temb[i:i + 1]) for i in range(2)]
        tiled = PV.decode(tiny["dec"], z, temb, use_slicing=True, use_tiling=True,
                          tiling=tiling)
        tiled_rows = [PV.tiled_decode(tiny["dec"], z[i:i + 1], temb[i:i + 1], tiling)
                      for i in range(2)]
    assert torch.equal(sliced, torch.cat(rows))
    assert torch.equal(tiled, torch.cat(tiled_rows))
    want = np.asarray(JV.decode(tiny["jparams"], tiny["jcfg"], jnp.asarray(z.numpy()),
                                jnp.asarray(temb.numpy()), use_slicing=True, use_tiling=True,
                                use_framewise_decoding=False, tiling=JV.TilingConfig(**TILES),
                                decode_fn=_port_decode_fn(tiny["dec"])))
    np.testing.assert_allclose(tiled.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", [dict(tail_stream_chunks=2),
                                  dict(tail_stream_chunks=2, tail_stream_from_ups=True)],
                         ids=["tail", "ups"])
def test_each_tile_runs_the_mode_asked_for(monkeypatch, mode):
    """A tiled decode runs the streamed mode asked for on every tile (exact:
    equal to the dense tiles up to f32 op order), on the streamed-decode
    tests' geometry (two resnets a block)."""
    cfg = dict(TINY, latent_channels=4, decoder_layers_per_block=(2, 2, 2))
    dec = PV.init_random(LtxVaeConfig(**cfg), "cpu", torch.float32,
                         generator=torch.Generator().manual_seed(4))
    z = torch.randn(1, 4, 9, 5, 6, generator=torch.Generator().manual_seed(5))
    temb = torch.tensor([0.05])
    seen = []
    for name in ("decoder_tail_streamed", "decoder_ups_tail_streamed"):
        fn = getattr(PV, name)
        monkeypatch.setattr(PV, name, lambda *a, _f=fn, _n=name, **k: seen.append(_n)
                            or _f(*a, **k))
    kw = dict(tiling=PV.TilingConfig(**TILES), use_tiling=True)
    with torch.no_grad():
        streamed = PV.decode(dec, z, temb, **mode, **kw)
        dense = PV.decode(dec, z, temb, **kw)
    want = "decoder_ups_tail_streamed" if mode.get("tail_stream_from_ups") else \
        "decoder_tail_streamed"
    assert seen == [want] * 4  # 2x2 tiles, none in the dense decode
    assert streamed.shape == dense.shape == (1, 3, 33, 40, 48)
    np.testing.assert_allclose(streamed.numpy(), dense.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_loader_and_writer_round_trip(tiny, tmp_path):
    sd = PL.vae_encoder_state_dict(tiny["enc"])
    assert all(k.startswith("encoder.") for k in sd) and len(sd) == 20
    assert "encoder.down_blocks.1.downsamplers.0.conv.conv.weight" in sd
    dec_sd = PL.vae_decoder_state_dict(tiny["dec"])
    path = tmp_path / "vae.safetensors"
    PL.save_safetensors({**sd, **dec_sd}, str(path))
    file = PL.load_safetensors(str(path))
    assert PL.has_vae_encoder(file) and not PL.has_vae_encoder(dec_sd)
    enc = PL.vae_encoder_from_state_dict(file, LtxVaeConfig(**TINY), device="cpu",
                                         dtype=torch.float32)
    for k, v in tiny["enc"].state_dict().items():
        assert torch.equal(enc.state_dict()[k], v), k
    # the decoder loader reads past the encoder's tensors
    PL.vae_decoder_from_state_dict(file, LtxVaeConfig(**TINY), device="cpu",
                                   dtype=torch.float32)
    # the JAX loader reads the port's file as the same encoder
    jp = vae_params_from_state_dict({k: v.numpy() for k, v in file.items()}, jnp.float32)
    x = np.random.default_rng(1).uniform(-1, 1, size=(1, 3, 5, 16, 16)).astype(np.float32)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JV.encoder_forward(
        jp["encoder"], tiny["jcfg"], jnp.asarray(x))), atol=1e-4, rtol=0)


def test_loader_takes_norm_out_and_optional_downsamplers():
    cfg = dict(TINY, block_out_channels=(8, 16, 16), spatiotemporal_scaling=(True, False),
               spatial_compression_ratio=4, temporal_compression_ratio=2)
    tree = _tree(cfg, seed=5, norm_out=True)
    enc = vae_encoder_from_jax(tree, LtxVaeConfig(**cfg), device="cpu")
    assert enc.down_blocks[1].downsampler is None and enc.norm_out is not None
    sd = PL.vae_encoder_state_dict(enc)
    assert "encoder.norm_out.weight" in sd
    assert not any("down_blocks.1.downsamplers" in k for k in sd)
    back = PL.vae_encoder_from_state_dict(sd, LtxVaeConfig(**cfg), device="cpu",
                                          dtype=torch.float32)
    x = np.random.default_rng(2).uniform(-1, 1, size=(1, 3, 5, 8, 8)).astype(np.float32)
    dec_sd = PL.vae_decoder_state_dict(vae_decoder_from_jax(tree, LtxVaeConfig(**cfg), device="cpu"))
    jp = vae_params_from_state_dict({k: v.numpy() for k, v in {**sd, **dec_sd}.items()},
                                    jnp.float32)
    assert "norm_out" in jp["encoder"] and "downsamplers" not in jp["encoder"]["down_blocks"][1]
    with torch.no_grad():
        got = back(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JV.encoder_forward(
        jp["encoder"], JV.LtxVaeConfig(**cfg), jnp.asarray(x))), atol=1e-4, rtol=0)


def test_loader_errors(tiny):
    sd = PL.vae_encoder_state_dict(tiny["enc"])
    cfg = LtxVaeConfig(**TINY)
    wrong = LtxVaeConfig(**dict(TINY, layers_per_block=(2, 1, 2)))
    with pytest.raises(PL.LoaderError, match="encoder has"):
        PL.vae_encoder_from_state_dict(sd, wrong, device="cpu", dtype=torch.float32)
    extra = dict(sd, **{"encoder.down_blocks.0.resnets.0.norm3.weight": torch.ones(8)})
    with pytest.raises(PL.LoaderError, match="no place"):
        PL.vae_encoder_from_state_dict(extra, cfg, device="cpu", dtype=torch.float32)
    bad = dict(sd)
    bad["encoder.conv_out.conv.bias"] = torch.zeros(3)
    with pytest.raises(PL.LoaderError, match="shape"):
        PL.vae_encoder_from_state_dict(bad, cfg, device="cpu", dtype=torch.float32)

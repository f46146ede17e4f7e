"""The port's channels-last VAE (``causal_conv3d_cl``, the ``cl`` bodies of
the resnet, upsampler, downsampler and unpatchify, the dense and streamed
``*_cl`` decoder walks, the channels-last encoder, the layout switch)
against the JAX package's channels-last twins on the CPU, on weights
carried across by the converters, and against the port's own NCDHW walks.

Tolerances:
- f32 against JAX: convs atol 1e-4 (one conv's f32 sums in another order),
  blocks and walks atol 5e-4 (the VAE envelope of ``test_torch_vae.py``);
- bf16 convs against JAX: two bf16 ulps of the output's largest magnitude.
  The JAX op rounds each of its kt tap convs to bf16 and adds them in bf16;
  the port rounds the f32 sum once, as K8 and cuDNN do.  K8's plain version
  is held to half an ulp of the rounded f32 conv;
- the port's channels-last walks against its NCDHW walks: atol 5e-5 (the
  same products, summed by other CPU conv algorithms in the two layouts:
  7.2e-6 read between the 93-frame full stream and the NCDHW dense
  decode).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video.vae_init import init_vae_params
from candle_video_tpu.ops.conv3d import causal_conv3d_cl as jax_conv_cl
from candle_video_tpu_torch.models.ltx_video import vae as PV
from candle_video_tpu_torch.models.ltx_video.configs import LtxVaeConfig
from candle_video_tpu_torch.models.ltx_video.convert import (
    vae_decoder_from_jax,
    vae_encoder_from_jax,
)
from candle_video_tpu_torch.ops import conv3d as C
from candle_video_tpu_torch.ops.kernels import conv3d_igemm as K8
from candle_video_tpu_torch.utils import rng as R

torch.set_num_threads(2)

# the streamed-decode tests' geometry: two spatiotemporal up blocks, two
# resnets a block, a mid block of two
CFG = dict(in_channels=3, out_channels=3, latent_channels=4,
           block_out_channels=(8, 16, 32), decoder_block_out_channels=(8, 16),
           spatiotemporal_scaling=(True, True), decoder_spatiotemporal_scaling=(True, True),
           layers_per_block=(1, 1, 2), decoder_layers_per_block=(2, 2, 2),
           patch_size=2, patch_size_t=1,
           downsample_types=("spatiotemporal", "spatiotemporal"),
           decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
           timestep_conditioning=True, decoder_causal=False,
           spatial_compression_ratio=8, temporal_compression_ratio=4)
# an encoder and decoder whose every 3x3x3 conv but conv_in / conv_out is
# one K8 takes (C, O multiples of 128)
WIDE = dict(CFG, block_out_channels=(128, 512, 512), decoder_block_out_channels=(128, 256),
            layers_per_block=(1, 1, 2), decoder_layers_per_block=(1, 1, 1),
            downsample_types=("spatial", "temporal"), spatial_compression_ratio=4,
            temporal_compression_ratio=2)
ATOL_CONV = 1e-4
ATOL_JAX = 5e-4
ATOL_LAYOUT = 5e-5
NOISE_SEED = 7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().float().numpy()


def _tree(cfg, seed=0, inject=False):
    """JAX VAE params as numpy with non-zero biases and, with ``inject``,
    the noise scales the JAX random init does not make."""
    jcfg = JV.LtxVaeConfig(**cfg, decoder_inject_noise=(inject,) * 4)
    tree = jax.tree.map(np.asarray, init_vae_params(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for part in ("encoder", "decoder"):
        tree[part] = jax.tree.map(
            lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.02
            if a.ndim == 1 else a, tree[part])
    if inject:
        dec = tree["decoder"]
        for blk in [dec["mid_block"]] + list(dec["up_blocks"]):
            for res in blk["resnets"]:
                c = res["conv1"]["weight"].shape[0]
                for name in ("per_channel_scale1", "per_channel_scale2"):
                    res[name] = (rng.normal(size=(c, 1, 1)) * 0.5).astype(np.float32)
    return jcfg, tree


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX decoder tree, port decoder) on CFG, noise scales in
    every resnet."""
    jcfg, tree = _tree(CFG, inject=True)
    pcfg = LtxVaeConfig(**CFG, decoder_inject_noise=(True,) * 4)
    return jcfg, jax.tree.map(jnp.asarray, tree["decoder"]), vae_decoder_from_jax(
        tree, pcfg, device="cpu")


def _z(t, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, 4, t, 4, 4)).astype(np.float32), np.array([0.05], np.float32)


def _keys(inject):
    """(the JAX key, the port key) of the injection, or Nones."""
    if not inject:
        return None, None
    return jax.random.PRNGKey(NOISE_SEED), R.prng_key(NOISE_SEED)


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


MODES = {"causal": dict(causal=True), "same": dict(causal=False),
         "valid": dict(causal=False, time_pad="valid")}


@pytest.mark.parametrize("impl", ["xla", "igemm"])
@pytest.mark.parametrize("mode", list(MODES))
def test_conv3d_cl_matches_jax(rng, mode, impl):
    """f32 and bf16 against JAX ``causal_conv3d_cl`` at C = O = 128 (K8 takes
    it under ``"igemm"``: its plain version here), B = 2; the result is
    contiguous [B, T', H, W, O] and equals the NCDHW op's."""
    kw = MODES[mode]
    x = rng.normal(size=(2, 5, 4, 6, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 128, 3, 3, 3)) * 0.05).astype(np.float32)
    b = (rng.normal(size=128) * 0.1).astype(np.float32)
    got = C.causal_conv3d_cl(_t(x), _t(w), _t(b), impl=impl, **kw)
    t_out = 3 if mode == "valid" else 5
    assert got.shape == (2, t_out, 4, 6, 128) and got.is_contiguous()
    want = np.asarray(jax_conv_cl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))
    np.testing.assert_allclose(_np(got), want, atol=ATOL_CONV, rtol=0)
    ncdhw = C.causal_conv3d(_t(x.transpose(0, 4, 1, 2, 3)), _t(w), _t(b), impl=impl, **kw)
    np.testing.assert_allclose(_np(got), _np(ncdhw).transpose(0, 2, 3, 4, 1), atol=ATOL_CONV,
                               rtol=0)
    xb, wb, bb = (_t(a).bfloat16() for a in (x, w, b))
    got_b = C.causal_conv3d_cl(xb, wb, bb, impl=impl, **kw)
    assert got_b.dtype == torch.bfloat16
    want_b = np.asarray(jax_conv_cl(*(jnp.asarray(_np(a), jnp.bfloat16) for a in (xb, wb, bb)),
                                    **kw).astype(jnp.float32))
    peak_ulp = 2.0 ** (np.floor(np.log2(np.abs(want_b).max())) - 7)
    np.testing.assert_allclose(_np(got_b), want_b, atol=2 * peak_ulp, rtol=0)
    if impl == "igemm":  # K8's plain version: the f32 sum rounded once
        f32 = _np(C.causal_conv3d_cl(xb.float(), wb.float(), bb.float(), impl="xla", **kw))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(f32), 1e-30))) - 7)
        assert (np.abs(_np(got_b) - f32) <= 0.5 * ulp + 1e-5).all()


def test_conv3d_cl_hands_k8_a_channels_last_view(monkeypatch):
    """A contiguous [B, T, H, W, C] reaches K8 as a ``channels_last_3d``
    view of itself (no copy), for B = 1 and T = 1 as well."""
    seen = []
    real = K8.conv3d_igemm
    monkeypatch.setattr(K8, "conv3d_igemm", lambda x, *a, **k: seen.append(x) or real(x, *a, **k))
    w = torch.randn(128, 128, 3, 3, 3) * 0.05
    for shape in ((1, 1, 3, 4, 128), (2, 4, 3, 4, 128), (1, 3, 1, 1, 128)):
        x = torch.randn(shape)
        C.causal_conv3d_cl(x, w, impl="igemm")
        assert seen[-1].data_ptr() == x.data_ptr(), shape
        assert seen[-1].is_contiguous(memory_format=torch.channels_last_3d), shape


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _conv_params(rng, c_in, c_out):
    return {"weight": (rng.normal(size=(c_out, c_in, 3, 3, 3)) * 0.1).astype(np.float32),
            "bias": (rng.normal(size=c_out) * 0.1).astype(np.float32)}


def _set(conv, p):
    with torch.no_grad():
        conv.weight.copy_(_t(p["weight"]))
        conv.bias.copy_(_t(p["bias"]))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("inject", [False, True])
def test_resnet_block_cl_matches_jax(rng, inject, causal):
    """``ResnetBlock(cl=True)`` against ``_resnet_block_cl`` with the
    [B, 4C] timestep modulation, with and without noise injection (the same
    [H, W] draws as the NCDHW block); equal to the NCDHW block."""
    c = 16
    p = {"conv1": _conv_params(rng, c, c), "conv2": _conv_params(rng, c, c),
         "scale_shift_table": rng.normal(size=(4, c)).astype(np.float32) * 0.25}
    if inject:
        p.update(per_channel_scale1=rng.normal(size=(c, 1, 1)).astype(np.float32) * 0.5,
                 per_channel_scale2=rng.normal(size=(c, 1, 1)).astype(np.float32) * 0.5)
    block = PV.ResnetBlock(c, torch.float32, conditioned=True, inject_noise=inject)
    _set(block.conv1, p["conv1"])
    _set(block.conv2, p["conv2"])
    with torch.no_grad():
        block.scale_shift_table.copy_(_t(p["scale_shift_table"]))
        if inject:
            block.per_channel_scale1.copy_(_t(p["per_channel_scale1"]))
            block.per_channel_scale2.copy_(_t(p["per_channel_scale2"]))
    x = rng.normal(size=(2, 4, 5, 6, c)).astype(np.float32)
    temb = rng.normal(size=(2, 4 * c)).astype(np.float32) * 0.1
    jkey, pkey = _keys(inject)
    want = JV._resnet_block_cl(jax.tree.map(jnp.asarray, p), JV.LtxVaeConfig(), jnp.asarray(x),
                               jnp.asarray(temb), causal=causal, noise_key=jkey)
    with torch.no_grad():
        got = block(_t(x), _t(temb), causal, noise_key=pkey, cl=True)
        ncdhw = block(_t(x.transpose(0, 4, 1, 2, 3)), _t(temb), causal, noise_key=pkey)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_JAX, rtol=0)
    np.testing.assert_allclose(_np(got), _np(ncdhw).transpose(0, 2, 3, 4, 1), atol=ATOL_LAYOUT,
                               rtol=0)


@pytest.mark.parametrize("stride,residual,upf", [((2, 2, 2), True, 2), ((1, 2, 2), True, 1),
                                                 ((2, 2, 2), False, 2)],
                         ids=["repeats4", "repeats4-spatial", "no-residual"])
def test_upsampler_cl_matches_jax(rng, stride, residual, upf):
    """``Upsampler(cl=True)``: depth-to-space in [c_out, st, sh, sw] order,
    the channel-tiled residual, the st-1 frame crop."""
    c_in, out_ch = 16, 16 // upf
    sp = stride[0] * stride[1] * stride[2]
    reps = out_ch * sp // c_in
    p = {"conv": _conv_params(rng, c_in, out_ch * sp)}
    ups = PV.Upsampler(c_in, out_ch * sp, torch.float32)
    _set(ups.conv, p["conv"])
    x = rng.normal(size=(1, 3, 4, 5, c_in)).astype(np.float32)
    want = JV._upsampler_cl(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride, residual,
                            reps, causal=False)
    with torch.no_grad():
        got = ups(_t(x), stride, residual, reps, False, cl=True)
        ncdhw = ups(_t(x.transpose(0, 4, 1, 2, 3)), stride, residual, reps, False)
    assert got.shape == tuple(np.asarray(want).shape)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_JAX, rtol=0)
    np.testing.assert_allclose(_np(got), _np(ncdhw).transpose(0, 2, 3, 4, 1), atol=ATOL_LAYOUT,
                               rtol=0)


@pytest.mark.parametrize("p,pt", [(4, 1), (2, 2)])
def test_patchify_cl_matches_jax(rng, p, pt):
    """``_patchify_cl`` moves the same values as JAX's and as the NCDHW
    ``_patchify`` (bit for bit), and ``_unpatchify(cl=True)`` inverts the
    channel order [c, pt, p_w, p_h]."""
    x = rng.normal(size=(2, 4, 8, 12, 3)).astype(np.float32)
    got = PV._patchify_cl(_t(x), p, pt)
    np.testing.assert_array_equal(_np(got), np.asarray(JV._patchify_cl(jnp.asarray(x), p, pt)))
    ncdhw = PV._patchify(_t(x.transpose(0, 4, 1, 2, 3)), p, pt)
    np.testing.assert_array_equal(_np(got), _np(ncdhw).transpose(0, 2, 3, 4, 1))
    y = rng.normal(size=(2, 3, 4, 5, 3 * pt * p * p)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(PV._unpatchify(_t(y), p, pt, cl=True)),
        np.asarray(JV._unpatchify(jnp.asarray(y), p, pt, cl=True)))


@pytest.mark.parametrize("kind", ["spatial", "temporal", "spatiotemporal"])
def test_downsampler_cl_matches_jax(rng, kind):
    """``Downsampler(cl=True)`` against ``_pixel_unshuffle_downsample_cl``:
    the first-frame pad, the conv, the unshuffle and the grouped mean."""
    stride = PV._DOWNSAMPLE_STRIDES[kind]
    c, out_channels = 8, 16
    c_conv = out_channels // (stride[0] * stride[1] * stride[2])
    p = {"conv": _conv_params(rng, c, c_conv)}
    ds = PV.Downsampler(c, c_conv, torch.float32)
    _set(ds.conv, p["conv"])
    x = rng.normal(size=(2, 5, 4, 6, c)).astype(np.float32)
    want = JV._pixel_unshuffle_downsample_cl(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                             stride, out_channels, causal=True)
    with torch.no_grad():
        got = ds(_t(x), stride, out_channels, True, cl=True)
        ncdhw = ds(_t(x.transpose(0, 4, 1, 2, 3)), stride, out_channels, True)
    assert got.shape == tuple(np.asarray(want).shape)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_JAX, rtol=0)
    np.testing.assert_allclose(_np(got), _np(ncdhw).transpose(0, 2, 3, 4, 1), atol=ATOL_LAYOUT,
                               rtol=0)


# ---------------------------------------------------------------------------
# the decoder walks
# ---------------------------------------------------------------------------


DENSE = {"head": (PV.decoder_head_forward_cl, JV.decoder_head_forward_cl,
                  PV.decoder_head_forward),
         "pre_ups": (PV.decoder_head_pre_ups_forward_cl, JV.decoder_head_pre_ups_forward_cl,
                     PV.decoder_head_pre_ups_forward)}


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("walk", ["head", "pre_ups", "tail"])
def test_dense_walks_cl_match_jax(models, walk, inject):
    """The three dense channels-last walks against JAX's, with and without
    the injection's key: the heads give [B, T, H, W, C] (equal to the NCDHW
    heads, transposed); the tail takes it and gives NCDHW video."""
    jcfg, jdec, dec = models
    z, temb = _z(3, seed=4)
    jkey, pkey = _keys(inject)
    jz, jt, zt, tt = jnp.asarray(z), jnp.asarray(temb), _t(z), _t(temb)
    with torch.no_grad():
        if walk == "tail":
            h = JV.decoder_head_forward_cl(jdec, jcfg, jz, jt, noise_key=jkey)
            got = PV.decoder_tail_forward_cl(dec, _t(np.asarray(h)), tt, noise_key=pkey)
            want = JV.decoder_tail_forward_cl(jdec, jcfg, h, jt, noise_key=jkey)
            other = PV.decoder_tail_forward(
                dec, _t(np.asarray(h).transpose(0, 4, 1, 2, 3)), tt, noise_key=pkey)
        else:
            port, jax_fn, port_ncdhw = DENSE[walk]
            got = port(dec, zt, tt, noise_key=pkey)
            want = jax_fn(jdec, jcfg, jz, jt, noise_key=jkey)
            other = port_ncdhw(dec, zt, tt, noise_key=pkey).permute(0, 2, 3, 4, 1)
    assert got.shape == tuple(np.asarray(want).shape)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_JAX, rtol=0)
    np.testing.assert_allclose(_np(got), _np(other), atol=ATOL_LAYOUT, rtol=0)


def _resnet_state(prefix, d):
    return {f"{prefix}.{k}": d[k] for k in ("c1", "c2", "sc")}


def _tail_state(st):
    out = {"conv_out": st["out"]}
    for k, d in enumerate(st["resnets"]):
        out.update(_resnet_state(f"tail.{k}", d))
    return out


def _ups_state(i, st):
    return {f"up{i}.conv": st["conv"], f"up{i}.res": st["res"]}


def _head_state(st):
    out = {"conv_in": st["conv_in"]}
    for k, d in enumerate(st["mid"]):
        out.update(_resnet_state(f"mid.{k}", d))
    for i, up in enumerate(st["up"]):
        out.update(_ups_state(i, up["ups"]))
        for k, d in enumerate(up["resnets"]):
            out.update(_resnet_state(f"up{i}.{k}", d))
    return out


def _ups_tail_state(st):
    return {**_ups_state(1, st["ups"]), **_tail_state(st["tail"])}


# (port step, JAX step, JAX init, JAX state -> the port's keys, input
# frames, chunks)
STREAMS = {
    "head": (PV.decoder_head_stream_cl, JV.decoder_head_stream_cl,
             lambda p, c, b, h, w: JV.head_stream_init(p, c, b, h, w, jnp.float32),
             _head_state, 24, 2),
    "tail": (PV.decoder_tail_stream_cl, JV.decoder_tail_stream_cl,
             lambda p, c, b, h, w: JV.tail_stream_init(p, b, h, w, jnp.float32),
             _tail_state, 25, 3),
    "ups_tail": (PV.decoder_ups_tail_stream_cl, JV.decoder_ups_tail_stream_cl,
                 lambda p, c, b, h, w: JV.ups_tail_stream_init(p, c, b, h, w, jnp.float32),
                 _ups_tail_state, 13, 3),
}


def _stream_input(models, kind):
    """The stream's input: latents for the head (NCDHW), the channels-last
    head's output for the tail, the pre-upsample head's for the ups-split."""
    jcfg, jdec, _ = models
    n = STREAMS[kind][4]
    z, temb = _z(n if kind == "head" else 7, seed=5)
    if kind == "head":
        return z, temb
    fn = JV.decoder_head_forward_cl if kind == "tail" else JV.decoder_head_pre_ups_forward_cl
    return np.asarray(fn(jdec, jcfg, jnp.asarray(z), jnp.asarray(temb))), temb


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("kind", list(STREAMS))
def test_stream_steps_cl_match_jax(models, kind, inject):
    """The three streamed channels-last walks chunk by chunk against JAX's:
    each chunk's output and, after every step, the carried state (its keys,
    [B, 2, H, W, C] caches and contents).  The port's step starts from
    ``{}``, JAX's from its zero-filled ``*_stream_init``."""
    jcfg, jdec, dec = models
    port_step, jax_step, jax_init, to_port, n, chunks = STREAMS[kind]
    x, temb = _stream_input(models, kind)
    td = 2 if kind == "head" else 1
    b, (hgt, wid) = x.shape[0], (x.shape[3:5] if kind == "head" else x.shape[2:4])
    jstate = jax_init(jdec, jcfg, b, hgt, wid)
    state = {}
    jkey, pkey = _keys(inject)
    spans = PV.stream_spans(x.shape[td], chunks)
    assert spans == JV.stream_spans(x.shape[td], chunks) and len(spans) == chunks
    for i, (a, e) in enumerate(spans):
        mode = PV._stream_mode(i, len(spans))
        piece = np.take(x, np.arange(a, e), axis=td)
        want, jstate = jax_step(jdec, jcfg, jnp.asarray(piece), jstate, mode, jnp.asarray(temb),
                                jkey)
        with torch.no_grad():
            got = port_step(dec, _t(piece), state, mode, _t(temb), pkey)
        assert got.shape == tuple(np.asarray(want).shape), (kind, mode)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_JAX, rtol=0,
                                   err_msg=f"{kind} {mode}")
        if mode == "last":
            assert state == {}
            continue
        jflat = to_port(jstate)
        assert {k: tuple(v.shape) for k, v in state.items()} == {
            k: tuple(v.shape) for k, v in jflat.items()}, (kind, mode)
        for k in state:
            np.testing.assert_allclose(_np(state[k]), np.asarray(jflat[k]), atol=ATOL_JAX,
                                       rtol=0, err_msg=f"{kind} {mode} {k}")


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("mode", [dict(tail_stream_chunks=2), dict(tail_stream_chunks=3),
                                  dict(tail_stream_chunks=2, tail_stream_from_ups=True),
                                  dict(full_stream_chunks=2)],
                         ids=["tail2", "tail3", "ups2", "full2"])
def test_streamed_decodes_cl_match_jax_and_ncdhw(models, mode, inject):
    """``decoder_tail_streamed``, ``decoder_ups_tail_streamed`` and
    ``decoder_forward_fullstream`` on the channels-last walks against the
    JAX runners and against the port's dense decode in both layouts."""
    jcfg, jdec, dec = models
    z, temb = _z(24 if "full_stream_chunks" in mode else 7, seed=6)
    jkey, pkey = _keys(inject)
    jz, jt, zt, tt = jnp.asarray(z), jnp.asarray(temb), _t(z), _t(temb)
    with torch.no_grad():
        if "full_stream_chunks" in mode:
            n = mode["full_stream_chunks"]
            got = PV.decoder_forward_fullstream(dec, zt, tt, n_chunks=n, noise_key=pkey)
            want = JV.decoder_forward_fullstream(jdec, jcfg, jz, jt, noise_key=jkey, n_chunks=n)
        else:
            n, ups = mode["tail_stream_chunks"], mode.get("tail_stream_from_ups", False)
            runner = PV.decoder_ups_tail_streamed if ups else PV.decoder_tail_streamed
            head = PV.decoder_head_pre_ups_forward_cl if ups else PV.decoder_head_forward_cl
            got = runner(dec, head(dec, zt, tt, noise_key=pkey), tt, n_chunks=n,
                         noise_key=pkey)
            want = JV.decoder_forward(jdec, jcfg, jz, jt, noise_key=jkey, channels_last=True,
                                      tail_stream_chunks=n, tail_stream_from_ups=ups)
        dense = dec(zt, tt, noise_key=pkey, channels_last=True)
        other = dec(zt, tt, noise_key=pkey, channels_last=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_JAX, rtol=0)
    np.testing.assert_allclose(_np(got), _np(other), atol=ATOL_LAYOUT, rtol=0)
    np.testing.assert_allclose(_np(got), _np(dense), atol=ATOL_LAYOUT, rtol=0)


def test_ncdhw_layout_refuses_the_streamed_modes(models, monkeypatch):
    """The streamed modes are channels-last only, as in the JAX facade:
    asked of the NCDHW layout (by ``CVT_DECODER_LAYOUT`` or explicitly),
    ``decode`` raises, as JAX ``decode`` does."""
    jcfg, jdec, dec = models
    z, temb = _z(24, seed=6)
    monkeypatch.setenv("CVT_DECODER_LAYOUT", "ncdhw")
    for mode in (dict(tail_stream_chunks=2), dict(tail_stream_chunks=2, tail_stream_from_ups=True),
                 dict(full_stream_chunks=2)):
        with pytest.raises(ValueError, match="requires the channels-last decoder"):
            JV.decode({"decoder": jdec}, jcfg, jnp.asarray(z), jnp.asarray(temb),
                      use_tiling=False, use_framewise_decoding=False, **mode)
        for kw in ({}, {"channels_last": False}):
            with pytest.raises(ValueError, match="require the channels-last decoder"), \
                    torch.no_grad():
                PV.decode(dec, _t(z), _t(temb), **kw, **mode)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
def test_decoder_forward_cl_matches_jax_and_ncdhw(batch, causal):
    """The dense decode in channels-last against JAX ``decoder_forward``
    (channels-last) and the port's NCDHW decode."""
    jcfg, tree = _tree(dict(CFG, decoder_causal=causal), seed=2)
    dec = vae_decoder_from_jax(tree, LtxVaeConfig(**dict(CFG, decoder_causal=causal)),
                               device="cpu")
    rng = np.random.default_rng(3)
    z = rng.normal(size=(batch, 4, 3, 3, 4)).astype(np.float32)
    temb = np.full(batch, 0.05, np.float32)
    want = JV.decoder_forward(jax.tree.map(jnp.asarray, tree["decoder"]), jcfg, jnp.asarray(z),
                              jnp.asarray(temb), channels_last=True)
    with torch.no_grad():
        got = dec(_t(z), _t(temb), channels_last=True)
        other = dec(_t(z), _t(temb), channels_last=False)
    assert got.shape == (batch, 3, 9, 24, 32) and got.is_contiguous()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_JAX, rtol=0)
    np.testing.assert_allclose(_np(got), _np(other), atol=ATOL_LAYOUT, rtol=0)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,shape", [(CFG, (1, 3, 9, 16, 24)), (CFG, (2, 3, 5, 32, 16)),
                                       (CFG, (1, 3, 1, 16, 16)), (WIDE, (1, 3, 5, 8, 8))],
                         ids=["9f", "B2", "image", "wide"])
@pytest.mark.parametrize("impl", ["xla", "igemm"])
def test_encoder_forward_cl_matches_jax_and_ncdhw(rng, monkeypatch, cfg, shape, impl):
    """``LtxVaeEncoder.forward(channels_last=True)`` against JAX
    ``encoder_forward_cl`` (the logvar channel replicated on the last axis)
    and the port's NCDHW encode, on both conv routes (K8's plain version
    for the WIDE config's eligible convs)."""
    jcfg, tree = _tree(cfg, seed=3)
    enc = vae_encoder_from_jax(tree, LtxVaeConfig(**cfg), device="cpu")
    x = rng.uniform(-1, 1, size=shape).astype(np.float32)
    want = np.asarray(JV.encoder_forward_cl(jax.tree.map(jnp.asarray, tree["encoder"]), jcfg,
                                            jnp.asarray(x)))
    monkeypatch.setenv("CVT_CONV3D_IMPL", impl)
    with torch.no_grad():
        got = enc(_t(x), channels_last=True)
        other = enc(_t(x), channels_last=False)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(_np(got), want, atol=ATOL_CONV, rtol=0)
    np.testing.assert_allclose(_np(got), _np(other), atol=ATOL_LAYOUT, rtol=0)


def test_channels_last_walks_hand_k8_views(monkeypatch):
    """Every conv K8 takes in the channels-last decode (dense and streamed)
    and encode (B = 1 and 2, one frame) receives a ``channels_last_3d``,
    16-byte aligned input: on the card no K8 input is copied (the
    ``RELAYOUT`` count stays 0).  The NCDHW walks' inputs are not."""
    _, tree = _tree(WIDE, seed=4)
    pcfg = LtxVaeConfig(**WIDE)
    dec = vae_decoder_from_jax(tree, pcfg, device="cpu")
    enc = vae_encoder_from_jax(tree, pcfg, device="cpu")
    seen = []
    real = K8.conv3d_igemm
    monkeypatch.setattr(K8, "conv3d_igemm", lambda x, *a, **k: seen.append(
        x.is_contiguous(memory_format=torch.channels_last_3d) and x.data_ptr() % 16 == 0)
        or real(x, *a, **k))
    monkeypatch.setenv("CVT_CONV3D_IMPL", "igemm")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for batch, frames in ((1, 5), (2, 5), (1, 1)):
            enc(torch.rand(batch, 3, frames, 8, 8, generator=g) * 2 - 1, channels_last=True)
        z, temb = torch.randn(1, 4, 5, 2, 3, generator=g), torch.tensor([0.05])
        dec(z, temb, channels_last=True)
        PV.decode(dec, z, temb, tail_stream_chunks=2, channels_last=True)
        n_cl = len(seen)
        dec(z, temb, channels_last=False)
    assert n_cl > 20 and all(seen[:n_cl]), seen
    assert not all(seen[n_cl:])


# ---------------------------------------------------------------------------
# layout selection and the policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("part", ["decoder", "encoder"])
def test_layout_is_read_per_call(monkeypatch, part):
    """``CVT_DECODER_LAYOUT`` is read at every call (set, call, unset,
    call), an explicit ``channels_last`` wins over it, and the default is
    channels-last; the JAX facade's encoder reads it once per process."""
    _, tree = _tree(CFG, seed=5)
    pcfg = LtxVaeConfig(**CFG)
    calls = []
    for name in ("causal_conv3d", "causal_conv3d_cl"):
        real = getattr(PV, name)
        monkeypatch.setattr(PV, name, lambda *a, _r=real, _n=name, **k: calls.append(_n)
                            or _r(*a, **k))
    if part == "decoder":
        dec = vae_decoder_from_jax(tree, pcfg, device="cpu")
        z, temb = _z(2)

        def run(**kw):
            return PV.decode(dec, _t(z), _t(temb), **kw)
    else:
        enc = vae_encoder_from_jax(tree, pcfg, device="cpu")
        x = np.random.default_rng(0).uniform(-1, 1, size=(1, 3, 5, 16, 16)).astype(np.float32)

        def run(**kw):
            return PV.encode(enc, _t(x), **kw)

    def layout(**kw):
        calls.clear()
        with torch.no_grad():
            out = run(**kw)
        assert len(set(calls)) == 1, calls
        return calls[0].endswith("_cl"), out

    monkeypatch.delenv("CVT_DECODER_LAYOUT", raising=False)
    cl_on, default = layout()
    monkeypatch.setenv("CVT_DECODER_LAYOUT", "ncdhw")
    cl_off, ncdhw = layout()
    cl_forced, _ = layout(channels_last=True)
    monkeypatch.delenv("CVT_DECODER_LAYOUT")
    cl_again, _ = layout()
    assert (cl_on, cl_off, cl_forced, cl_again) == (True, False, True, True)
    assert layout(channels_last=False)[0] is False
    np.testing.assert_allclose(_np(default), _np(ncdhw), atol=ATOL_LAYOUT, rtol=0)


def _rank(picked):
    if "full_stream_chunks" in picked:
        return 3
    if picked.get("tail_stream_from_ups"):
        return 2
    return 1 if "tail_stream_chunks" in picked else 0


def test_select_decode_mode_channels_last_on_the_jax_grid():
    """``select_decode_mode(channels_last=True)`` on ``tests/test_vae.py``'s
    grid (512x768x97 latents of the JAX default config; 64, 6, 2.4 and 1
    GiB free).  Its per-pixel peaks are the card's, not the JAX package's,
    so the mode at a given free memory may differ; what holds:
    - plenty of memory, a causal decoder or two latent frames: dense, as JAX;
    - as the memory falls both walk the same ladder, dense -> tail stream ->
      ups-split stream -> full stream, never back;
    - at 1 GiB JAX names a full stream its own runner refuses (13 latent
      frames hold no two chunks of the fill); the port refuses it at once;
    - the NCDHW layout stays dense in both (it does not stream)."""
    jcfg = JV.LtxVaeConfig()
    pcfg = LtxVaeConfig(**dataclasses.asdict(jcfg))
    zshape = (1, 128, 13, 16, 24)
    gib = 1024 ** 3

    def port(free, cfg=pcfg, shape=zshape, cl=True):
        try:
            return PV.select_decode_mode(cfg, shape, free_bytes=free, channels_last=cl)
        except ValueError as e:
            assert "full stream needs" in str(e)
            return {"full_stream_chunks": 0}

    grid = [64 * gib, 6 * gib, int(2.4 * gib), 1 * gib]
    jax_picks = [JV.select_decode_mode(jcfg, zshape, free_bytes=f, channels_last=True)
                 for f in grid]
    assert [_rank(p) for p in jax_picks] == [0, 1, 2, 3]
    picks = [port(f) for f in grid]
    assert picks[0] == jax_picks[0] == {}
    ladder = [port(int(64 * gib * 0.97 ** i)) for i in range(120)]
    assert [_rank(p) for p in ladder] == sorted(_rank(p) for p in ladder)
    assert {_rank(p) for p in ladder} == {0, 1, 2, 3}
    skeleton = {"mid_block": {"resnets": [None] * 5},
                "up_blocks": [{"resnets": [None] * 5} for _ in range(3)]}
    need = JV.fullstream_first_chunk_min(skeleton, jcfg)
    first = JV.stream_spans(13, jax_picks[3]["full_stream_chunks"])[0]
    assert first[1] - first[0] < need == PV.fullstream_first_chunk_min(pcfg)
    assert picks[3] == {"full_stream_chunks": 0}  # refused
    causal = dataclasses.replace(jcfg, decoder_causal=True)
    for cfg, jc, shape in ((dataclasses.replace(pcfg, decoder_causal=True), causal, zshape),
                           (pcfg, jcfg, (1, 128, 2, 16, 24))):
        assert port(gib, cfg, shape) == {} == JV.select_decode_mode(
            jc, shape, free_bytes=gib, channels_last=True)
    for free in grid:
        assert port(free, cl=False) == {} == JV.select_decode_mode(
            jcfg, zshape, free_bytes=free, channels_last=False)

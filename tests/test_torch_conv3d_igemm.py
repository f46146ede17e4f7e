"""K8 (implicit-GEMM 3x3x3 conv) and the decoder's ``"igemm"`` route of the
PyTorch port against the JAX package on the CPU, in f32.

- K8's plain version against JAX ``conv3d_igemm_cl`` in interpret mode at
  the two cases of the JAX package's own test, plus O = 256 and B = 2:
  atol 2e-4 (f32 summation order over 27·C terms).
- The same against the port's ``causal_conv3d(impl="xla")``, including
  ``time_pad="valid"``: atol 2e-5.
- The route: eligibility counts 44 of the 45 convs of the 0.9.8 decoder
  (from its config, no weights), ``CVT_CONV3D_IMPL=igemm`` is honoured by
  ``impl="auto"``, and a tiny decoder of 128-multiple widths decodes under
  ``"igemm"`` to the JAX decoder's output within the VAE parity tolerance
  (atol 5e-4, ``test_torch_vae.py``).
- K8 itself on a card (marked ``cuda``; skips without one).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video.vae_init import init_vae_params
from candle_video_tpu.ops.pallas.conv3d_igemm import conv3d_igemm_cl
from candle_video_tpu_torch.models.ltx_video import configs as PC
from candle_video_tpu_torch.models.ltx_video import vae as PV
from candle_video_tpu_torch.models.ltx_video.convert import vae_decoder_from_jax
from candle_video_tpu_torch.ops import conv3d as PO
from candle_video_tpu_torch.ops.kernels import _build
from candle_video_tpu_torch.ops.kernels import conv3d_igemm as K8

torch.set_num_threads(2)

# (causal, B, T, H, W, C, O): the JAX package's two cases first; the JAX
# kernel needs W % 8 == 0 in f32 (its TPU tile), K8 does not
CASES = [(True, 1, 4, 8, 8, 128, 128), (False, 1, 3, 16, 8, 128, 128),
         (True, 1, 3, 5, 8, 128, 256), (False, 2, 4, 6, 8, 128, 128)]
RAGGED = [(True, 1, 3, 5, 7, 128, 128), (False, 2, 4, 3, 5, 256, 128)]


def _inputs(rng, b, t, h, w, c, o):
    x = rng.normal(size=(b, c, t, h, w)).astype(np.float32)
    wt = (rng.normal(size=(o, c, 3, 3, 3)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(o,)).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("case", CASES, ids=str)
def test_k8_plain_matches_pallas_interpret(case):
    causal, b, t, h, w, c, o = case
    x, wt, bias = _inputs(np.random.default_rng(11), b, t, h, w, c, o)
    got = K8.conv3d_igemm(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias),
                          causal=causal)
    assert got.shape == (b, o, t, h, w) and got.dtype == torch.float32
    for i in range(b):  # the JAX kernel takes one [T, H, W, C] clip
        want = conv3d_igemm_cl(jnp.asarray(x[i].transpose(1, 2, 3, 0)), jnp.asarray(wt),
                               jnp.asarray(bias), causal=causal, interpret=True)
        np.testing.assert_allclose(got[i].numpy().transpose(1, 2, 3, 0), np.asarray(want),
                                   atol=2e-4, rtol=0)


@pytest.mark.parametrize("time_pad", ["edge", "valid"])
@pytest.mark.parametrize("case", CASES + RAGGED, ids=str)
def test_k8_plain_matches_the_port_conv(case, time_pad):
    causal, b, t, h, w, c, o = case
    x, wt, bias = (torch.from_numpy(a) for a in _inputs(np.random.default_rng(5), b, t, h, w,
                                                            c, o))
    got = K8.conv3d_igemm(x, wt, bias, causal=causal, time_pad=time_pad)
    want = PO.causal_conv3d(x, wt, bias, causal=causal, time_pad=time_pad, impl="xla")
    assert got.shape == want.shape == (b, o, t - 2 * (time_pad == "valid"), h, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


def test_route_takes_44_of_the_0_9_8_decoders_45_convs():
    cfg = PC.get_config_by_version("0.9.8-2b-distilled").vae
    with torch.device("meta"):
        dec = PV.LtxVaeDecoder(cfg)
    convs = {n: m.weight.shape for n, m in dec.named_modules() if isinstance(m, PV.Conv3d)}
    taken = {n for n, s in convs.items() if K8.eligible(s[1], s[0], s[2:])}
    assert len(convs) == 45 and len(taken) == 44
    assert set(convs) - taken == {"conv_out"}  # O = 48
    assert not K8.eligible(128, 128, (1, 3, 3)) and not K8.eligible(64, 128, (3, 3, 3))


def test_cvt_conv3d_impl_is_honoured_by_auto(monkeypatch):
    calls = []
    plain = K8.conv3d_igemm_plain
    monkeypatch.setattr(K8, "conv3d_igemm_plain", lambda *a, **k: calls.append(1) or
                        plain(*a, **k))
    x = torch.randn(1, 128, 2, 3, 3)
    w128, b128 = torch.randn(128, 128, 3, 3, 3) * 0.05, torch.randn(128)
    w48 = torch.randn(48, 128, 3, 3, 3) * 0.05
    monkeypatch.delenv("CVT_CONV3D_IMPL", raising=False)
    assert PO.resolve_impl() == "xla"
    PO.causal_conv3d(x, w128, b128)
    assert calls == []
    monkeypatch.setenv("CVT_CONV3D_IMPL", "igemm")
    assert PO.resolve_impl() == "igemm" and PO.resolve_impl("xla") == "xla"
    got = PO.causal_conv3d(x, w128, b128)
    assert calls == [1]
    PO.causal_conv3d(x, w48)  # not eligible: the library conv, by shape
    PO.causal_conv3d(x, w128, b128, impl="xla")  # an explicit choice wins
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), PO.causal_conv3d(x, w128, b128, impl="xla").numpy(),
                               atol=2e-5, rtol=0)
    monkeypatch.setenv("CVT_CONV3D_IMPL", "taps")
    with pytest.raises(ValueError, match="taps"):
        PO.causal_conv3d(x, w128, b128)


WIDE = dict(latent_channels=128, block_out_channels=(8, 16, 32),
            decoder_block_out_channels=(256, 512), spatiotemporal_scaling=(True, True),
            decoder_spatiotemporal_scaling=(True, True), layers_per_block=(1, 1, 2),
            decoder_layers_per_block=(1, 1, 1), patch_size=2,
            downsample_types=("spatiotemporal", "spatiotemporal"),
            decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
            decoder_causal=False, spatial_compression_ratio=8, temporal_compression_ratio=4)


def test_tiny_wide_decoder_under_igemm_matches_jax(monkeypatch):
    rng = np.random.default_rng(2)
    tree = jax.tree.map(np.asarray, init_vae_params(jax.random.PRNGKey(4),
                                                    JV.LtxVaeConfig(**WIDE),
                                                    dtype=jnp.float32))
    tree["decoder"] = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.02 if a.ndim == 1
        else a, tree["decoder"])
    dec = vae_decoder_from_jax(tree, PC.LtxVaeConfig(**WIDE), device="cpu")
    z = rng.normal(size=(1, 128, 3, 2, 3)).astype(np.float32)
    temb = np.array([0.05], np.float32)
    want = JV.decoder_forward(jax.tree.map(jnp.asarray, tree["decoder"]),
                              JV.LtxVaeConfig(**WIDE), jnp.asarray(z), jnp.asarray(temb))
    calls = []
    plain = K8.conv3d_igemm_plain
    monkeypatch.setattr(K8, "conv3d_igemm_plain", lambda *a, **k: calls.append(1) or
                        plain(*a, **k))
    monkeypatch.setenv("CVT_CONV3D_IMPL", "igemm")
    with torch.no_grad():
        got = PV.decode(dec, torch.from_numpy(z), torch.from_numpy(temb))
    # conv_in, 2 mid-block convs, 2 upsampler convs, 2 resnet convs per up
    # block: every conv but conv_out (O = 12)
    assert len(calls) == 1 + 2 + 2 + 2 * 2
    assert got.shape == (1, 3, 9, 16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


@pytest.mark.cuda
def test_k8_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K8 is CUDA C++ with no CPU mode")
    rng = np.random.default_rng(3)
    _build.reset_launches()
    for causal, b, t, h, w, c, o in CASES + RAGGED:
        for time_pad in ("edge", "valid"):
            x, wt, bias = (torch.from_numpy(a).cuda().bfloat16()
                           for a in _inputs(rng, b, t, h, w, c, o))
            got = K8.conv3d_igemm(x, wt, bias, causal=causal, time_pad=time_pad)
            want = K8.conv3d_igemm_plain(x, wt, bias, causal=causal, time_pad=time_pad)
            torch.cuda.synchronize()
            assert got.is_contiguous(memory_format=torch.channels_last_3d)
            ulp = want.float().abs() * 2.0 ** -7 + 1e-3
            assert ((got.float() - want.float()).abs() <= ulp).all()
    assert _build.LAUNCHES[K8.NAME] == 2 * len(CASES + RAGGED)


# ---------------------------------------------------------------------------
# K8's host plan and its schedule, on the CPU: the tiling the kernel takes
# (a bh x bw rectangle of one output frame per CTA, BN output channels, the
# 27·C/64 K-steps split over CTAs) and its addressing, emulated in torch.

# K8 against its plain version on the card: one bf16 ulp elementwise
# (|d| <= 8e-3 * max(1, |want|)) and rel <= 4e-3, as chip_smoke.py holds it
K8_TOL = dict(scaled=8e-3, rel=4e-3)

# (B, T_out, H, W, C, O): the 2B decoder's four widths at 97 frames, the
# tail's streamed chunk ("valid": 26 frames in, 24 out), a frame the
# rectangle does not divide at B = 2, and a one-row frame
PLANS = [(1, 97, 128, 192, 128, 128), (1, 49, 64, 96, 256, 256), (1, 25, 32, 48, 512, 512),
         (1, 13, 16, 24, 1024, 1024), (1, 24, 128, 192, 128, 128), (2, 5, 13, 20, 128, 128),
         (1, 3, 1, 37, 256, 128)]
H100_SMS = 132  # the SM count of an H100 SXM, which the wrapper reads from the card


@pytest.mark.parametrize("shape", PLANS, ids=str)
def test_k8_plan_covers_every_output_once(shape):
    b, t_out, h, w, c, o = shape
    plan = K8.plan_conv3d(*shape, H100_SMS)
    bh, bw = plan["bh"], plan["bw"]
    assert bh * bw == plan["tile_m"] == (256 if plan["bn"] == 128 else 128)
    assert 1 <= bh <= 256 and 1 <= bw <= 256
    assert o % plan["bn"] == 0 and plan["n_tiles"] == o // plan["bn"]
    assert plan["m_tiles"] == b * t_out * plan["tiles_h"] * plan["tiles_w"]
    hits = torch.zeros(b, t_out, h, w, dtype=torch.int64)
    for mt in range(plan["m_tiles"]):  # the kernel's decomposition of blockIdx.x
        tw, rest = mt % plan["tiles_w"], mt // plan["tiles_w"]
        th, rest = rest % plan["tiles_h"], rest // plan["tiles_h"]
        ti, bi = rest % t_out, rest // t_out
        hits[bi, ti, th * bh:th * bh + bh, tw * bw:tw * bw + bw] += 1
    assert bool((hits == 1).all())
    # no rectangle lies wholly outside the frame
    assert (plan["tiles_h"] - 1) * bh < h and (plan["tiles_w"] - 1) * bw < w
    steps = 27 * c // K8.STEP_C
    assert plan["steps"] == steps and 1 <= plan["split"] <= 4
    covered = [s for lo, hi in plan["ranges"] for s in range(lo, hi)]
    assert covered == list(range(steps)) and len(plan["ranges"]) == plan["split"]
    assert plan["ctas"] == plan["m_tiles"] * plan["n_tiles"] * plan["split"]


def test_k8_plan_splits_only_the_small_grids():
    tail, up1, up0, mid = (K8.plan_conv3d(*s, H100_SMS) for s in PLANS[:4])
    assert tail["split"] == up1["split"] == up0["split"] == 1
    assert mid["split"] > 1 and mid["waves"] > 4  # 156 tiles alone are 1.2 waves
    assert (tail["bh"], tail["bw"], up1["bh"], up1["bw"], mid["bh"], mid["bw"]) == \
        (4, 64, 4, 32, 16, 8)  # each divides its frame


def test_k8_plan_splits_to_fill_the_card_it_is_given():
    # the mid block's 156 tiles: 4 waves need 528 CTAs on 132 SMs, 264 on 66
    mid = PLANS[3]
    assert K8.plan_conv3d(*mid, 132)["split"] == 4
    assert K8.plan_conv3d(*mid, 66)["split"] == 2
    assert K8.plan_conv3d(*mid, 39)["split"] == 1
    # never more than MAX_SPLIT, however small the grid
    assert K8.plan_conv3d(1, 1, 8, 8, 1024, 1024, 132)["split"] == K8.MAX_SPLIT


def _emulate_k8(x, weight, bias, causal, time_pad):
    """K8's schedule in torch, in f32: per CTA tile and K-step the TMA boxes
    (x at the clamped frame, the shifted rows and columns zero-filled
    outside the frame; the packed weight's [BN, 64] slice), f32 partials per
    split, summed in split order, plus the bias, rounded once to bf16."""
    b, c, t, h, w = x.shape
    o = weight.shape[0]
    mode = K8._mode(causal, time_pad)
    t_out = t - 2 if mode == "valid" else t
    plan = K8.plan_conv3d(b, t_out, h, w, c, o, H100_SMS)
    bh, bw, bn = plan["bh"], plan["bw"], plan["bn"]
    xl = x.permute(0, 2, 3, 4, 1).float()  # [B, T, H, W, C]
    w27 = K8.pack_weight(weight).float()
    y = torch.empty(b, t_out, h, w, o)
    cblocks = c // K8.STEP_C
    tile_m = plan["tile_m"]
    rr = torch.arange(tile_m)
    for mt in range(plan["m_tiles"]):
        tw, rest = mt % plan["tiles_w"], mt // plan["tiles_w"]
        th, rest = rest % plan["tiles_h"], rest // plan["tiles_h"]
        ti, bi = rest % t_out, rest // t_out
        hh, ww = th * bh + rr // bw, tw * bw + rr % bw  # the tile's rows, row-major
        for n0 in range(0, o, bn):
            partials = []
            for lo, hi in plan["ranges"]:
                acc = torch.zeros(tile_m, bn)
                for step in range(lo, hi):
                    tap, c0 = step // cblocks, (step % cblocks) * K8.STEP_C
                    dt, dh, dw = tap // 9, (tap // 3) % 3, tap % 3
                    if mode == "valid":
                        frame = ti + dt
                    else:
                        frame = min(max(ti + dt - (2 if mode == "causal" else 1), 0), t - 1)
                    hs, ws = hh + dh - 1, ww + dw - 1
                    inside = (hs >= 0) & (hs < h) & (ws >= 0) & (ws < w)
                    box = torch.zeros(tile_m, K8.STEP_C)
                    box[inside] = xl[bi, frame, hs[inside], ws[inside], c0:c0 + K8.STEP_C]
                    acc += box @ w27[tap, n0:n0 + bn, c0:c0 + K8.STEP_C].T
                partials.append(acc)
            total = partials[0]
            for p in partials[1:]:
                total = total + p
            if bias is not None:
                total = total + bias.float()[n0:n0 + bn]
            keep = (hh < h) & (ww < w)  # rows past the frame's edge are not stored
            y[bi, ti, hh[keep], ww[keep], n0:n0 + bn] = total[keep]
    return y.to(torch.bfloat16).permute(0, 4, 1, 2, 3), plan


@pytest.mark.parametrize("case", [
    (2, 128, 128, 5, 13, 20, True, "edge"),    # ragged frame, B = 2, split 4
    (1, 256, 256, 4, 8, 24, False, "valid"),   # BN = 256, the streamed decode's mode
    (1, 128, 256, 3, 1, 37, False, "edge"),    # a one-row frame, BN = 256: 1 x 128 tiles
], ids=str)
def test_k8_schedule_emulated_matches_plain(case):
    b, c, o, t, h, w, causal, time_pad = case
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(b, c, t, h, w)).astype(np.float32)).bfloat16()
    wt = torch.from_numpy((rng.normal(size=(o, c, 3, 3, 3)) * (27 * c) ** -0.5)
                          .astype(np.float32)).bfloat16()
    bias = torch.from_numpy((rng.normal(size=(o,)) * 0.1).astype(np.float32)).bfloat16()
    got, plan = _emulate_k8(x, wt, bias, causal, time_pad)
    want = K8.conv3d_igemm_plain(x, wt, bias, causal=causal, time_pad=time_pad)
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    d = got.float() - want.float()
    assert float((d.abs() / want.float().abs().clamp_min(1.0)).max()) <= K8_TOL["scaled"]
    assert float(d.norm() / want.float().norm()) <= K8_TOL["rel"]
    if case[0] == 2:
        assert plan["split"] > 1  # the partials' path is the one emulated


def test_packed_weight_is_made_once_and_follows_the_weight():
    w = torch.nn.Parameter(torch.randn(128, 128, 3, 3, 3))
    first = K8.packed_weight(w)
    assert torch.equal(first, K8.pack_weight(w)) and first.dtype == torch.bfloat16
    assert K8.packed_weight(w) is first  # no re-pack on the next call
    with torch.no_grad():
        w.mul_(2.0)  # an in-place change bumps the version
    second = K8.packed_weight(w)
    assert second is not first and torch.equal(second, K8.pack_weight(w))
    w.data = torch.randn(128, 128, 3, 3, 3)  # a new storage
    third = K8.packed_weight(w)
    assert third is not second and torch.equal(third, K8.pack_weight(w))
    assert K8.packed_weight(w) is third
    with torch.inference_mode():
        inf = torch.randn(128, 128, 3, 3, 3)
    assert torch.equal(K8.packed_weight(inf), K8.pack_weight(inf))  # no version to key on

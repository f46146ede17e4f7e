"""K1 and K2 (lane-packed flash attention, one-pass and long) and the
attention dispatch of the PyTorch port against the JAX package on the CPU,
in f32.

The port's wrapper takes its plain version for CPU tensors; the JAX side
runs the Pallas kernel in interpret mode and its f32 XLA oracle.
Tolerance: max-abs <= 2e-5 (f32 softmax on both sides, same formula)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.ops import rope as JR
from candle_video_tpu.ops.pallas.flash_attention_packed import (
    flash_attention_packed as jax_fa_packed,
)
from candle_video_tpu_torch.ops import rope as PR
from candle_video_tpu_torch.ops.kernels import _build
from candle_video_tpu_torch.ops.kernels.flash_attention_packed import (
    flash_attention_packed,
)

# ``ops/__init__`` re-exports the function ``attention`` over the module name
JATT = importlib.import_module("candle_video_tpu.ops.attention")
PATT = importlib.import_module("candle_video_tpu_torch.ops.attention")

torch.set_num_threads(2)
ATOL = 2e-5


def _inputs(rng, b, s, kv, h, d, with_bias, with_rope):
    q = rng.normal(size=(b, s, h * d)).astype(np.float32)
    k = rng.normal(size=(b, kv, h * d)).astype(np.float32)
    v = rng.normal(size=(b, kv, h * d)).astype(np.float32)
    bias = None
    if with_bias:
        keep = rng.uniform(size=(b, kv)) > 0.3
        keep[:, 0] = True
        bias = ((1.0 - keep) * -10000.0).astype(np.float32)[:, None, None, :]
    rope = None
    if with_rope:
        grid = rng.uniform(size=(1, s, 3)).astype(np.float32)
        cos, sin = JR.rope_cos_sin(jnp.asarray(grid), h * d)
        rope = (np.asarray(cos), np.asarray(sin))
    return q, k, v, bias, rope


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("s,kv,h,d,with_bias,with_rope", [
    (96, 96, 4, 64, False, True),    # self-attention with in-kernel q RoPE
    (77, 77, 4, 64, True, True),     # ragged S with a key bias
    (61, 130, 4, 64, True, False),   # ragged K, bias, no RoPE
    (40, 65, 4, 64, True, False),    # K = 65: the last key tile is nearly all padding
    (70, 70, 2, 128, True, True),    # D = 128 (13B head width)
])
def test_k1_matches_pallas_interpret_and_oracle(rng, s, kv, h, d, with_bias, with_rope):
    b = 2
    q, k, v, bias, rope = _inputs(rng, b, s, kv, h, d, with_bias, with_rope)
    scale = 1.0 / np.sqrt(d)
    got = flash_attention_packed(
        _t(q), _t(k), _t(v), num_heads=h, scale=scale, bias=_t(bias),
        rope_q=None if rope is None else (_t(rope[0]), _t(rope[1])))
    want = jax_fa_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h, scale=scale,
        bias=None if bias is None else jnp.asarray(bias),
        rope_q=None if rope is None else (jnp.asarray(rope[0]), jnp.asarray(rope[1])),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    qo = q
    if rope is not None:
        qo = np.asarray(JR.apply_rotary_emb(jnp.asarray(q), *map(jnp.asarray, rope)))
    oracle = JATT.attention_xla(
        jnp.asarray(qo).reshape(b, s, h, d), jnp.asarray(k).reshape(b, kv, h, d),
        jnp.asarray(v).reshape(b, kv, h, d), scale,
        bias=None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle).reshape(b, s, h * d),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("self_attn", [True, False])
def test_attention_dispatch_matches_jax(rng, self_attn):
    b, s, h, d = 2, 50, 4, 64
    kv = s if self_attn else 12
    q, k, v, bias, rope = _inputs(rng, b, s, kv, h, d, not self_attn, self_attn)
    shape_q, shape_kv = (b, s, h, d), (b, kv, h, d)
    got = PATT.attention(
        _t(q).reshape(shape_q), _t(k).reshape(shape_kv), _t(v).reshape(shape_kv),
        0.125, bias=_t(bias),
        rope=None if rope is None else (_t(rope[0]), _t(rope[1])))
    want = JATT.attention(
        jnp.asarray(q).reshape(shape_q), jnp.asarray(k).reshape(shape_kv),
        jnp.asarray(v).reshape(shape_kv), 0.125,
        bias=None if bias is None else jnp.asarray(bias), impl="xla",
        rope=None if rope is None else tuple(map(jnp.asarray, rope)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_attention_xla_matches_jax(rng):
    q, k, v, bias, _ = _inputs(rng, 1, 20, 30, 2, 64, True, False)
    got = PATT.attention_xla(_t(q).reshape(1, 20, 2, 64), _t(k).reshape(1, 30, 2, 64),
                             _t(v).reshape(1, 30, 2, 64), 0.3, bias=_t(bias))
    want = JATT.attention_xla(jnp.asarray(q).reshape(1, 20, 2, 64),
                              jnp.asarray(k).reshape(1, 30, 2, 64),
                              jnp.asarray(v).reshape(1, 30, 2, 64), 0.3,
                              bias=jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_launch_counters_stay_zero_on_cpu(rng):
    from candle_video_tpu_torch.ops.kernels.int8_weight_matmul import w8_matmul

    _build.reset_launches()
    q, k, v, _, rope = _inputs(rng, 1, 16, 16, 2, 64, False, True)
    flash_attention_packed(_t(q), _t(k), _t(v), num_heads=2, scale=0.125,
                           rope_q=(_t(rope[0]), _t(rope[1])))
    w8_matmul(torch.ones(4, 32), torch.ones(32, 8, dtype=torch.int8),
              torch.ones(1, 8), qblock=32)
    FAP.flash_attention_packed_long(_t(q), _t(k), _t(v), num_heads=2, scale=0.125,
                                    rope_q=(_t(rope[0]), _t(rope[1])))
    assert _build.LAUNCHES["flash_attention_packed"] == 0
    assert _build.LAUNCHES["flash_attention_packed_long"] == 0
    assert _build.LAUNCHES["w8_matmul"] == 0
    assert sum(_build.LAUNCHES.values()) == 0


def test_kernel_library_is_keyed_on_sources():
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_DIR
    assert {p.name for p in _build._sources()} == {
        "flash_attention_packed.cu", "int8_weight_matmul.cu", "int4_weight_matmul.cu"}


def test_rope_tables_feed_both_sides(rng):
    grid = rng.uniform(size=(1, 12, 3)).astype(np.float32)
    cos, sin = PR.rope_cos_sin(torch.from_numpy(grid), 128)
    assert cos.shape == sin.shape == (1, 12, 128) and cos.dtype == torch.float32


# ---------------------------------------------------------------------------
# K2: the long-sequence kernel's plain version, its shift and the route.
# JAX side: ``_packed_long`` in interpret mode, f32 inputs on both sides
# (the point is the algorithm).  Tolerance: MSE < 1e-6 (the JAX package's
# own long-kernel gate) and max-abs <= 2e-5 (same f32 formula, same blocks).
# ---------------------------------------------------------------------------

FAP = importlib.import_module("candle_video_tpu_torch.ops.kernels.flash_attention_packed")
JFAP = importlib.import_module("candle_video_tpu.ops.pallas.flash_attention_packed")


@pytest.mark.parametrize("kv,with_bias,with_rope,block_k", [
    (1000, False, False, 256),  # S % block_k != 0: the last key block is padded
    (300, True, False, 128),    # short K with a -1e4 key mask (the bias fold)
    (1000, False, True, 256),   # in-kernel q rotation, k rotated outside
], ids=["plain", "bias_kv300", "rope_q"])
def test_k2_plain_matches_pallas_long_interpret(rng, kv, with_bias, with_rope, block_k):
    b, s, h, d = 1, 1000, 4, 64
    q, k, v, bias, rope = _inputs(rng, b, s, kv, h, d, with_bias, with_rope)
    if rope is not None:  # the path hands the kernel a rotated k
        k = np.asarray(JR.apply_rotary_emb(jnp.asarray(k), *map(jnp.asarray, rope)))
    scale = 1.0 / np.sqrt(d)
    got = FAP.flash_attention_packed_long_plain(
        _t(q), _t(k), _t(v), num_heads=h, scale=scale, bias=_t(bias),
        rope_q=None if rope is None else (_t(rope[0]), _t(rope[1])), block_k=block_k)
    want = np.asarray(JFAP._packed_long(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h, scale=scale,
        bias=None if bias is None else jnp.asarray(bias),
        rope_q=None if rope is None else tuple(map(jnp.asarray, rope)),
        block_q=128, block_k=block_k, interpret=True))
    assert float(((got.numpy() - want) ** 2).mean()) < 1e-6
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # and the fixed-shift algorithm against the plain one-pass softmax
    one = FAP.flash_attention_packed_plain(
        _t(q), _t(k), _t(v), num_heads=h, scale=scale, bias=_t(bias),
        rope_q=None if rope is None else (_t(rope[0]), _t(rope[1])))
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=2e-6, rtol=0)


@pytest.mark.parametrize("with_bias,d,amp", [(False, 64, 1.0), (True, 64, 1.0),
                                             (True, 128, 1.0), (False, 64, 30.0)],
                         ids=["d64", "d64_bias", "d128_bias", "clipped"])
def test_group_score_bounds_match_jax(rng, with_bias, d, amp):
    b, s, h = 2, 90, 4
    q, k, _, bias, _ = _inputs(rng, b, s, s, h, d, with_bias, False)
    q, k = q * amp, k * amp
    if bias is not None:
        bias = bias + rng.normal(size=bias.shape).astype(np.float32)
    groups = h * d // 128
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(JFAP.group_score_bounds(jnp.asarray(q), jnp.asarray(k), scale, groups))
    np.testing.assert_allclose(
        FAP.group_score_bounds(_t(q), _t(k), scale, groups).numpy(), want, rtol=1e-6)
    if bias is not None:  # _packed_long folds the global bias max in
        want = want + bias.reshape(b, -1).max(-1, keepdims=True)
    got = FAP.long_shift(_t(q), _t(k), num_heads=h, scale=scale, bias=_t(bias))
    assert got.shape == (b, groups) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    if amp > 1:
        assert float(got.max()) == FAP._BOUND_CLIP


def test_route_picks_k1_or_k2(rng, monkeypatch):
    # K_pad = roundup(K, 128) against the JAX package's threshold
    assert FAP._ONEPASS_KP_MAX == JFAP._ONEPASS_KP_MAX == 8192
    assert not FAP.uses_long_kernel(4992)   # 512x768x97: K1
    assert not FAP.uses_long_kernel(8192)
    assert FAP.uses_long_kernel(8257)       # K_pad 8320
    assert FAP.uses_long_kernel(12672)      # 512x768x257: K2
    calls = []
    plain_long = FAP.flash_attention_packed_long_plain
    monkeypatch.setattr(FAP, "flash_attention_packed_long_plain",
                        lambda *a, **kw: calls.append(1) or plain_long(*a, **kw))
    q, k, v, _, rope = _inputs(rng, 1, 300, 300, 2, 64, False, True)
    args = (_t(q), _t(k), _t(v))
    kw = dict(num_heads=2, scale=0.125, rope_q=(_t(rope[0]), _t(rope[1])))
    one = FAP.flash_attention_packed(*args, **kw)
    assert not calls
    monkeypatch.setattr(FAP, "_ONEPASS_KP_MAX", 256)
    assert FAP.uses_long_kernel(300) and not FAP.uses_long_kernel(256)
    long = FAP.flash_attention_packed(*args, **kw)
    assert calls == [1]
    np.testing.assert_allclose(long.numpy(), one.numpy(), atol=2e-6, rtol=0)


def test_dit_forward_long_route_matches_jax(rng, monkeypatch):
    """The DiT gate of the long regime: a port forward whose self-attention
    takes K2's route (threshold lowered to stay CPU-sized; the 257-frame
    path hits it at S = 12672) against the JAX XLA-attention forward,
    MSE < 1e-4 (the JAX package's transformer gate)."""
    import jax

    from candle_video_tpu.models.ltx_video import transformer as JTF
    from candle_video_tpu.models.ltx_video.pipeline import build_video_coords
    from candle_video_tpu_torch.models.ltx_video.configs import LtxTransformerConfig
    from candle_video_tpu_torch.models.ltx_video.convert import transformer_from_jax

    cfg = dict(in_channels=8, out_channels=8, num_attention_heads=2,
               attention_head_dim=64, cross_attention_dim=128, num_layers=2,
               caption_channels=16)
    jcfg = JTF.LtxTransformerConfig(**cfg)
    params = JTF.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    f, h, w = 6, 13, 14  # S = 1092, not a block multiple
    s = f * h * w
    hidden = rng.normal(size=(1, s, 8)).astype(np.float32)
    enc = (rng.normal(size=(1, 8, 16)) * 0.3).astype(np.float32)
    t = np.full((1,), 993.0, np.float32)
    grid = build_video_coords(f, h, w, frame_rate=25.0)[None] / np.asarray(
        [jcfg.rope_base_num_frames, jcfg.rope_base_height, jcfg.rope_base_width], np.float32)
    cos, sin = JR.rope_cos_sin(jnp.asarray(grid), jcfg.inner_dim, jcfg.rope_theta)
    want = np.asarray(JTF.forward(params, jcfg, jnp.asarray(hidden), jnp.asarray(enc),
                                  jnp.asarray(t), cos, sin, attn_impl="xla"))

    model = transformer_from_jax(jax.tree.map(np.asarray, params),
                                 LtxTransformerConfig(**cfg))
    calls = []
    plain_long = FAP.flash_attention_packed_long_plain
    monkeypatch.setattr(FAP, "flash_attention_packed_long_plain",
                        lambda *a, **kw: calls.append(1) or plain_long(*a, **kw))
    monkeypatch.setattr(FAP, "_ONEPASS_KP_MAX", 512)  # force the long route
    with torch.no_grad():
        got = model(torch.from_numpy(hidden), torch.from_numpy(enc), torch.from_numpy(t),
                    torch.from_numpy(np.array(cos)), torch.from_numpy(np.array(sin))).numpy()
    assert len(calls) == cfg["num_layers"]  # every self-attention took K2's route
    mse = float(((got - want) ** 2).mean())
    assert mse < 1e-4, mse

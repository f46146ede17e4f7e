"""K1 (lane-packed flash attention) and the attention dispatch of the PyTorch
port against the JAX package on the CPU, in f32.

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
    assert _build.LAUNCHES["flash_attention_packed"] == 0
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

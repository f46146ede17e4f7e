"""K6 (classic flash attention over [B, S, H, D]) and its route in the
attention dispatch of the PyTorch port, against the JAX package on the CPU.

K6's plain version (the wrapper's route for CPU tensors) is held against JAX
``flash_attention`` in interpret mode, both of its Pallas bodies: the
one-pass kernel (default blocks) and the multi-k-block online softmax
(``block_k=128``), odd heads, D = 128, ragged S and K, with and without a
key bias.  Tolerance: max-abs <= 1e-5 in f32; in bf16 one bf16 ulp,
``|got - want| <= 2^-7·max(1, |want|)`` (p rounds to bf16 on both sides).
The dispatch sends shapes the lane-packed kernels do not take to K6 above
512 keys and agrees with JAX ``attention(impl="pallas")``."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.ops import rope as JR
from candle_video_tpu.ops.pallas import flash_attention as JK6
from candle_video_tpu.ops.pallas import flash_attention_packed as JFAP
from candle_video_tpu_torch.ops.kernels import _build
from candle_video_tpu_torch.ops.kernels import flash_attention as K6
from candle_video_tpu_torch.ops.kernels import flash_attention_packed as FAP

# ``ops/__init__`` re-exports the function ``attention`` over the module name
JATT = importlib.import_module("candle_video_tpu.ops.attention")
PATT = importlib.import_module("candle_video_tpu_torch.ops.attention")

torch.set_num_threads(2)
ATOL = 1e-5
BF16_ULP = 2.0 ** -7


def _inputs(rng, b, s, kv, h, d, with_bias):
    q = rng.normal(size=(b, s, h, d)).astype(np.float32) * 2
    k = rng.normal(size=(b, kv, h, d)).astype(np.float32)
    v = rng.normal(size=(b, kv, h, d)).astype(np.float32)
    bias = None
    if with_bias:
        keep = rng.uniform(size=(b, kv)) > 0.3
        keep[:, 0] = True
        bias = ((1.0 - keep) * -10000.0 + rng.normal(size=(b, kv))).astype(np.float32)
        bias = bias[:, None, None, :]
    return q, k, v, bias


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(np.array(x)).to(dtype)


CASES = {  # name: (B, S, K, H, D, bias, block_k)
    "onepass_h5": (2, 200, 200, 5, 64, False, None),        # the SVD level-0 heads
    "onepass_ragged_bias": (2, 61, 97, 5, 64, True, None),
    "multiblock_k300_bias": (1, 100, 300, 3, 64, True, 128),  # 3 key blocks, last padded
    "multiblock_d128": (2, 70, 300, 2, 128, False, 128),
    "onepass_d128_bias": (1, 77, 130, 3, 128, True, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_k6_plain_matches_pallas_interpret_f32(rng, name):
    b, s, kv, h, d, with_bias, block_k = CASES[name]
    q, k, v, bias = _inputs(rng, b, s, kv, h, d, with_bias)
    scale = d ** -0.5
    got = K6.flash_attention(_t(q), _t(k), _t(v), scale=scale, bias=_t(bias))
    want = np.asarray(JK6.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        bias=None if bias is None else jnp.asarray(bias), block_k=block_k, interpret=True))
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    oracle = np.asarray(JATT.attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                           bias=None if bias is None else jnp.asarray(bias)))
    np.testing.assert_allclose(got.numpy(), oracle, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["onepass_h5", "multiblock_k300_bias", "onepass_d128_bias"])
def test_k6_plain_matches_pallas_interpret_bf16(rng, name):
    b, s, kv, h, d, with_bias, block_k = CASES[name]
    q, k, v, bias = _inputs(rng, b, s, kv, h, d, with_bias)
    scale = d ** -0.5
    got = K6.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                             _t(v, torch.bfloat16), scale=scale, bias=_t(bias))
    want = np.asarray(JK6.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale=scale,
        bias=None if bias is None else jnp.asarray(bias), block_k=block_k,
        interpret=True)).astype(np.float32)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= BF16_ULP, err.max()


def test_k6_masks_padded_keys_and_takes_the_true_row_max(rng):
    """Logits far above any fixed bound (no clip, no shift) and one key in
    the last block: the plain version still equals the JAX kernel."""
    q, k, v, _ = _inputs(rng, 1, 40, 129, 5, 64, False)
    q *= 30.0  # scores of several hundred nats
    want = np.asarray(JK6.flash_attention(*map(jnp.asarray, (q, k, v)), scale=0.125,
                                          block_k=128, interpret=True))
    got = K6.flash_attention(_t(q), _t(k), _t(v), scale=0.125).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,kv,h,d,with_rope", [
    (600, 600, 5, 64, False), (600, 600, 5, 64, True),  # RoPE: both rotate first
    (520, 700, 3, 64, False), (64, 513, 1, 64, False),
])
def test_dispatch_sends_unpackable_shapes_to_k6(rng, monkeypatch, s, kv, h, d, with_rope):
    assert not FAP.packed_viable(s, kv, h, d)
    q, k, v, _ = _inputs(rng, 1, s, kv, h, d, False)
    rope = None
    if with_rope:
        grid = rng.uniform(size=(1, s, 3)).astype(np.float32)
        rope = tuple(np.asarray(t) for t in JR.rope_cos_sin(jnp.asarray(grid), h * d))
    calls = []
    plain = K6.flash_attention_plain
    monkeypatch.setattr(K6, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    got = PATT.attention(_t(q), _t(k), _t(v), d ** -0.5,
                         rope=None if rope is None else tuple(map(_t, rope)))
    assert calls == [1]
    want = JATT.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5,
                          impl="pallas",
                          rope=None if rope is None else tuple(map(jnp.asarray, rope)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_dispatch_keeps_packable_and_short_shapes_off_k6(rng, monkeypatch):
    calls = []
    plain = K6.flash_attention_plain
    monkeypatch.setattr(K6, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    for s, kv, h, d in [(600, 600, 10, 64), (600, 600, 4, 128),  # packed: K1
                        (600, 14, 5, 64), (600, 1, 5, 64)]:      # short: plain
        q, k, v, _ = _inputs(rng, 1, s, kv, h, d, False)
        PATT.attention(_t(q), _t(k), _t(v), 0.125)
    assert calls == []


@pytest.mark.parametrize("h,d", [(5, 64), (10, 64), (20, 64), (1, 64), (3, 128), (4, 128),
                                 (2, 64), (16, 80), (8, 256), (6, 32), (4, 32)])
def test_packed_viable_matches_jax(h, d):
    assert FAP.packed_viable(100, 100, h, d) == JFAP.packed_viable(100, 100, h, d)


def test_k6_cpu_takes_the_plain_version_and_counts_nothing(rng):
    _build.reset_launches()
    q, k, v, _ = _inputs(rng, 1, 16, 16, 5, 64, False)
    K6.flash_attention(_t(q), _t(k), _t(v), scale=0.125)
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad,exc,match", [
    ("head_dim", ValueError, "head dim"),
    ("shape", ValueError, "do not share"),
    ("dtype", TypeError, "bfloat16"),
    ("bias", ValueError, "bias must be f32"),
    ("device", ValueError, "must be on"),
])
def test_k6_cuda_route_checks(bad, exc, match):
    """The CUDA route's checks (run here on CPU tensors, which it refuses)."""
    b, s, kv, h, d = 1, 16, 24, 5, 64
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16)
    k = v = torch.zeros(b, kv, h, d, dtype=torch.bfloat16)
    bias = None
    if bad == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif bad == "shape":
        v = torch.zeros(b, kv + 1, h, d, dtype=torch.bfloat16)
    elif bad == "dtype":
        q = q.float()
    elif bad == "bias":
        bias = torch.zeros(b, 1, 1, kv, dtype=torch.bfloat16)
    with pytest.raises(exc, match=match):
        K6._check(q, k, v, bias)

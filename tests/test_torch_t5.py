"""The PyTorch port's T5 encoder against the JAX package on the CPU, in f32,
on a narrow config (d_model 64, d_ff 128: multiples of 32 so the int8
groups divide K).

Tolerances: dense max-abs <= 2e-4; int8 (K3 on both sides) relative
Frobenius error <= 1e-2."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import t5 as JT5
from candle_video_tpu.ops.pallas.int8_weight_matmul import quantize_int8_blockwise
from candle_video_tpu_torch.models.ltx_video import t5 as PT5
from candle_video_tpu_torch.models.ltx_video.configs import T5Config
from candle_video_tpu_torch.models.ltx_video.convert import t5_from_jax

torch.set_num_threads(2)

CFG = dict(vocab_size=64, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)


def t5_tree(rng, quant: str = "dense"):
    """Per-layer-list JAX T5 tree; ``quant`` 'dense', 'int8' or 'int8_affine'
    (the K-quant {w_q, s, b} carry with a rank-G correction)."""
    d, ff = CFG["d_model"], CFG["d_ff"]

    def lin(k, n):
        w = (rng.normal(size=(k, n)) * 0.08).astype(np.float32)
        if quant == "dense":
            return {"weight": jnp.asarray(w)}
        w_q, s = quantize_int8_blockwise(w, 32)
        out = {"w_q": jnp.asarray(w_q), "s": jnp.asarray(s)}
        if quant == "int8_affine":
            out["b"] = jnp.asarray(rng.normal(size=(k // 32, n)) * 0.01, jnp.float32)
        return out

    blocks = []
    for i in range(CFG["num_layers"]):
        blk = {
            "attn": {n: lin(d, d) for n in ("q", "k", "v", "o")},
            "attn_norm": {"weight": jnp.asarray(1 + 0.1 * rng.normal(size=d), jnp.float32)},
            "ffn": {"wi_0": lin(d, ff), "wi_1": lin(d, ff), "wo": lin(ff, d)},
            "ffn_norm": {"weight": jnp.asarray(1 + 0.1 * rng.normal(size=d), jnp.float32)},
        }
        if i == 0:
            blk["attn"]["relative_attention_bias"] = jnp.asarray(
                rng.normal(size=(32, CFG["num_heads"])), jnp.float32)
        blocks.append(blk)
    return {
        "embedding": jnp.asarray(rng.normal(size=(64, d)), jnp.float32),
        "blocks": blocks,
        "final_norm": {"weight": jnp.ones((d,), jnp.float32)},
    }


def _ids(rng, b=2, s=24):
    ids = rng.integers(1, 64, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 15:] = 0
    ids[1, 15:] = 0
    return ids, mask


def _run_both(tree, stacked: bool, rng):
    jcfg, pcfg = JT5.T5Config(**CFG), T5Config(**CFG)
    ids, mask = _ids(rng)
    jtree = JT5.stack_blocks(tree) if stacked else tree
    want = JT5.forward(jtree, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    np_tree = {k: v for k, v in _to_numpy(jtree).items()}
    enc = t5_from_jax(np_tree, pcfg)
    got = enc(torch.from_numpy(ids.astype(np.int64)),
              attention_mask=torch.from_numpy(mask.astype(np.float32)))
    return got.detach().numpy(), np.asarray(want)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("stacked", [False, True])
def test_t5_dense_matches_jax(rng, stacked):
    got, want = _run_both(t5_tree(rng, "dense"), stacked, rng)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("quant,stacked", [("int8", False), ("int8", True),
                                           ("int8_affine", False)])
def test_t5_int8_matches_jax(rng, quant, stacked):
    got, want = _run_both(t5_tree(rng, quant), stacked, rng)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-2, rel


def test_relative_position_bias_matches(rng):
    rel = rng.normal(size=(32, 4)).astype(np.float32)
    jcfg, pcfg = JT5.T5Config(**CFG), T5Config(**CFG)
    want = JT5.position_bias({"rel_bias": jnp.asarray(rel)}, jcfg, 40)
    got = PT5.position_bias(torch.from_numpy(rel), pcfg, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        PT5.relative_position_bucket(np.arange(-200, 200)),
        JT5.relative_position_bucket(np.arange(-200, 200)))


def test_int8_fill_is_deterministic_and_wraps():
    a = PT5._int8_fill(3, 16, 32, "cpu")
    b = PT5._int8_fill(3, 16, 32, "cpu")
    assert a.dtype == torch.int8 and torch.equal(a, b)
    i = np.arange(16 * 32, dtype=np.uint64)
    v = ((i * np.uint64(2654435761) + np.uint64(3)) % np.uint64(2 ** 32)) % np.uint64(255)
    want = (v.astype(np.int64).astype(np.int8) - np.int8(64)).astype(np.int8)
    np.testing.assert_array_equal(a.numpy().reshape(-1), want)

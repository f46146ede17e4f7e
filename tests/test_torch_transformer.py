"""The PyTorch port's DiT against the JAX package on the CPU, in f32, on a
narrow config: 2 layers, 4 heads x 64 (so the lane-packed layout applies),
ragged token counts.  Tolerance: max-abs <= 2e-3 over the forward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import transformer as JTF
from candle_video_tpu.ops import rope as JR
from candle_video_tpu_torch.models.ltx_video import transformer as PTF
from candle_video_tpu_torch.models.ltx_video.configs import LtxTransformerConfig
from candle_video_tpu_torch.models.ltx_video.convert import transformer_from_jax

torch.set_num_threads(2)

CFG = dict(in_channels=8, out_channels=8, num_attention_heads=4,
           attention_head_dim=64, cross_attention_dim=256, num_layers=2,
           caption_channels=32)


def _jax_params(seed=0):
    params = JTF.init_params(jax.random.PRNGKey(seed), JTF.LtxTransformerConfig(**CFG),
                             dtype=jnp.float32)
    # non-trivial biases and norm weights so the carry-over is exercised
    rng = np.random.default_rng(seed + 7)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.02,
        params)


@pytest.mark.parametrize("seq,with_mask,skip", [
    (70, True, None),     # ragged S = 2*5*7
    (131, False, (1,)),   # ragged S, a permanently skipped layer
])
def test_dit_forward_matches_jax(rng, seq, with_mask, skip):
    tree = _jax_params()
    jcfg = JTF.LtxTransformerConfig(**CFG)
    model = transformer_from_jax(tree, LtxTransformerConfig(**CFG))
    b, k = 2, 12
    x = rng.normal(size=(b, seq, 8)).astype(np.float32)
    enc = rng.normal(size=(b, k, 32)).astype(np.float32)
    t = np.array([900.0, 312.5], np.float32)
    grid = rng.uniform(size=(1, seq, 3)).astype(np.float32)
    cos, sin = JR.rope_cos_sin(jnp.asarray(grid), 256)
    mask = None
    if with_mask:
        mask = np.ones((b, k), np.float32)
        mask[1, 7:] = 0.0
    skip_mask = None
    if skip is not None:
        skip_mask = PTF.build_skip_layer_mask(2, b, skip)
        np.testing.assert_array_equal(skip_mask, JTF.build_skip_layer_mask(2, b, skip))

    want = JTF.forward(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x), jnp.asarray(enc),
        jnp.asarray(t), cos, sin,
        encoder_attention_mask=None if mask is None else jnp.asarray(mask),
        skip_layer_mask=None if skip_mask is None else jnp.asarray(skip_mask),
        attn_impl="xla")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(enc), torch.from_numpy(t),
                    torch.from_numpy(np.array(cos)), torch.from_numpy(np.array(sin)),
                    encoder_attention_mask=None if mask is None else torch.from_numpy(mask),
                    skip_layer_mask=None if skip_mask is None else torch.from_numpy(skip_mask))
    assert got.shape == (b, seq, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


def test_random_init_stds():
    cfg = LtxTransformerConfig(**CFG)
    g = torch.Generator().manual_seed(0)
    model = PTF.init_random(cfg, "cpu", torch.float32, generator=g)
    assert model.proj_in.bias.abs().max() == 0
    assert torch.all(model.blocks[0].attn1.norm_q == 1)
    assert abs(model.blocks[1].ff.net_0_proj.weight.std().item() - 0.02) < 2e-3
    assert abs(model.scale_shift_table.std().item() - 256 ** -0.5) < 0.03
    again = PTF.init_random(cfg, "cpu", torch.float32,
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(model.proj_out.weight, again.proj_out.weight)

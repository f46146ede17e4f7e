"""The PyTorch port's weight-only DiT tiers (W8A16 on K3, W4A16 on K4)
against the JAX package on the CPU, in f32, on a narrow config with the
13B head width: 2 layers, 2 heads x 128, caption 64.

The forward runs at S = 1040 video tokens, so the large-M linears take the
transient-dequant route and the cross-attention k/v (M = 2 x 16 caption
tokens) the kernel route, on both sides.  Tolerance: max-abs <= 2e-3.
The port's own quantizers give the JAX payloads bit for bit."""

import ml_dtypes
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
from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4
from candle_video_tpu_torch.ops.kernels import int8_weight_matmul as K3
from candle_video_tpu_torch.ops.quant_linear import Int4Linear, Int8Linear

torch.set_num_threads(2)

CFG = dict(in_channels=8, out_channels=8, num_attention_heads=2,
           attention_head_dim=128, cross_attention_dim=256, num_layers=2,
           caption_channels=64)


@pytest.fixture(scope="module")
def dense_tree():
    params = JTF.init_params(jax.random.PRNGKey(0), JTF.LtxTransformerConfig(**CFG),
                             dtype=jnp.float32)
    rng = np.random.default_rng(11)  # non-zero biases so they are carried
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.02,
        params)


def _quantize_jax(tree, tier):
    if tier == "w4":
        q = JTF.quantize_transformer_params_w4(tree, qblock=32, scale_dtype="bfloat16")
    else:
        q = JTF.quantize_transformer_params_w8(tree, qblock=128)
    return jax.tree.map(np.asarray, q)


@pytest.mark.parametrize("tier", ["w4", "w8"])
def test_quantized_dit_forward_matches_jax(dense_tree, tier):
    rng = np.random.default_rng(5)
    qtree = _quantize_jax(dense_tree, tier)
    model = transformer_from_jax(qtree, LtxTransformerConfig(**CFG))
    mod_type = Int4Linear if tier == "w4" else Int8Linear
    assert isinstance(model.blocks[1].attn2.to_k, mod_type)
    b, s, kv = 2, 1040, 16
    x = rng.normal(size=(b, s, 8)).astype(np.float32)
    enc = rng.normal(size=(b, kv, 64)).astype(np.float32)
    t = np.array([900.0, 312.5], np.float32)
    grid = rng.uniform(size=(1, s, 3)).astype(np.float32)
    cos, sin = JR.rope_cos_sin(jnp.asarray(grid), 256)
    mask = np.ones((b, kv), np.float32)
    mask[1, 11:] = 0.0
    want = JTF.forward(jax.tree.map(jnp.asarray, qtree), JTF.LtxTransformerConfig(**CFG),
                       jnp.asarray(x), jnp.asarray(enc), jnp.asarray(t), cos, sin,
                       encoder_attention_mask=jnp.asarray(mask), attn_impl="xla")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(enc), torch.from_numpy(t),
                    torch.from_numpy(np.array(cos)), torch.from_numpy(np.array(sin)),
                    encoder_attention_mask=torch.from_numpy(mask))
    assert got.shape == (b, s, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


@pytest.mark.parametrize("tier", ["w4", "w8"])
def test_port_quantizers_give_the_jax_payloads(dense_tree, tier):
    qtree = _quantize_jax(dense_tree, tier)
    model = transformer_from_jax(dense_tree, LtxTransformerConfig(**CFG))
    if tier == "w4":
        PTF.quantize_transformer_w4(model, qblock=32, scale_dtype=torch.bfloat16)
        names = {"w4": "w4", "w4_scale": "w4_scale", "w4_min": "w4_min", "bias": "bias"}
    else:
        PTF.quantize_transformer_w8(model, qblock=128)
        names = {"w8": "w_q", "w8_scale": "s", "bias": "bias"}
    for i, blk in enumerate(model.blocks):
        for group, name in PTF.QUANTIZED_LINEARS:
            lin = getattr(getattr(blk, group), name)
            leaf = qtree["blocks"][group][name]
            assert set(leaf) == set(names), (group, name)
            for jname, pname in names.items():
                want = leaf[jname][i]
                got = getattr(lin, pname)
                assert got.is_contiguous(), (group, name, jname)  # the kernels' layout
                if want.dtype == ml_dtypes.bfloat16:
                    assert got.dtype == torch.bfloat16
                    got, want = got.float(), want.astype(np.float32)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{group}.{name}.{jname}")
    assert isinstance(model.proj_in, torch.nn.Linear)  # non-block linears stay dense


@pytest.mark.parametrize("tier", ["w4", "w8"])
def test_random_quantized_init(tier):
    cfg = LtxTransformerConfig(**CFG)
    init = PTF.init_random_w4 if tier == "w4" else PTF.init_random_w8
    model = init(cfg, "cpu", torch.float32, generator=torch.Generator().manual_seed(0))
    ff = model.blocks[1].ff.net_0_proj
    if tier == "w4":
        assert ff.w4.shape == (128, 1024) and ff.w4.dtype == torch.uint8
        assert ff.w4_scale.shape == ff.w4_min.shape == (8, 1024)
        assert ff.w4_scale.dtype == torch.bfloat16
        w = K4.dequantize(ff.w4, ff.w4_scale, ff.w4_min, 32, torch.bfloat16)
    else:
        assert ff.w_q.shape == (256, 1024) and ff.w_q.dtype == torch.int8
        assert ff.s.shape == (2, 1024) and ff.s.dtype == torch.float32
        w = K3.dequantize(ff.w_q, ff.s, 128)
    assert abs(w.float().std().item() - 0.02) < 0.002
    assert abs(w.float().mean().item()) < 0.002
    assert ff.bias.dtype == torch.float32 and not ff.bias.any()
    assert model.proj_in.weight.dtype == torch.float32
    assert all(p.device.type == "cpu" for p in model.parameters())

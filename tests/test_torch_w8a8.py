"""K7 (fused W8A8 matmul) and the W8A8 DiT tier of the PyTorch port
against the JAX package on the CPU.

- K7's plain version against JAX ``w8a8_matmul`` in interpret mode, exactly
  (the int8 product is exact on both sides and the f32 epilogue runs in the
  same order), with the bias after the cast as JAX's wrapper adds it.
- The two activation quantizers (JAX ``quantize_activations`` and the
  tier's rule in ``_apply_linear_w8a8``) bit for bit.
- ``W8A8Linear`` against ``_apply_linear_w8a8``: exact in f32, within one
  bf16 ulp in bf16.
- ``quantize_transformer_w8a8`` payloads equal ``quantize_transformer_params``'
  bit for bit (stored ``[N, K]``), the carry-across in ``convert.py``, and
  the tiny W8A8 DiT forward against JAX within the dense DiT's max-abs 2e-3.
- K7's host plan ``plan_w8a8`` (tiles, split, shared memory, boxes) and
  its card schedule emulated in torch (K zero-padded to 16, 128-byte
  K-steps, int32 partials per split summed, the f32 epilogue in order):
  bit-equal to the plain version and to JAX in interpret mode, at the
  tier's shapes cut small and at ragged M, K and N.
- K7 itself on a card (marked ``cuda``; skips without one).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import transformer as JTF
from candle_video_tpu.ops import rope as JR
from candle_video_tpu.ops.pallas.int8_matmul import (
    quantize_activations as jax_quantize_activations,
    w8a8_matmul as jax_w8a8_matmul,
)
from candle_video_tpu_torch.models.ltx_video import transformer as PTF
from candle_video_tpu_torch.models.ltx_video.configs import LtxTransformerConfig
from candle_video_tpu_torch.models.ltx_video.convert import transformer_from_jax
from candle_video_tpu_torch.ops.kernels import _build
from candle_video_tpu_torch.ops.kernels import int8_matmul as K7
from candle_video_tpu_torch.ops.quant_linear import W8A8Linear

torch.set_num_threads(2)

CFG = dict(in_channels=8, out_channels=8, num_attention_heads=2,
           attention_head_dim=64, cross_attention_dim=128, num_layers=2,
           caption_channels=32)
SHAPES = [(77, 96, 200), (128, 256, 384), (5, 40, 24)]


def _operands(rng, m, k, n):
    x_q = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    s_x = rng.uniform(1e-3, 2e-2, size=(m,)).astype(np.float32)
    s_w = rng.uniform(1e-4, 1e-3, size=(n,)).astype(np.float32)
    return x_q, w_q, s_x, s_w


@pytest.mark.parametrize("m,k,n", SHAPES, ids=str)
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_k7_plain_equals_pallas_interpret(rng, m, k, n, with_bias):
    x_q, w_q, s_x, s_w = _operands(rng, m, k, n)
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    want = jax_w8a8_matmul(jnp.asarray(x_q), jnp.asarray(s_x), jnp.asarray(w_q),
                           jnp.asarray(s_w), None if bias is None else jnp.asarray(bias),
                           interpret=True)
    got = K7.w8a8_matmul(torch.from_numpy(x_q), torch.from_numpy(s_x),
                         torch.from_numpy(np.ascontiguousarray(w_q.T)), torch.from_numpy(s_w),
                         None if bias is None else torch.from_numpy(bias))
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # f32 out: the epilogue before any rounding, exact too
    want32 = jax_w8a8_matmul(jnp.asarray(x_q), jnp.asarray(s_x), jnp.asarray(w_q),
                             jnp.asarray(s_w), out_dtype=jnp.float32, interpret=True)
    got32 = K7.w8a8_matmul(torch.from_numpy(x_q), torch.from_numpy(s_x),
                           torch.from_numpy(np.ascontiguousarray(w_q.T)), torch.from_numpy(s_w),
                           out_dtype=torch.float32)
    np.testing.assert_array_equal(got32.numpy(), np.asarray(want32))


def test_k7_bias_orders(rng):
    """After the cast (the JAX wrapper's order) and before it (the tier's)."""
    x_q, w_q, s_x, s_w = (torch.from_numpy(a) for a in _operands(rng, 33, 64, 48))
    w_nk = w_q.t().contiguous()
    bias = torch.from_numpy(rng.normal(size=(48,)).astype(np.float32))
    acc = (x_q.long() @ w_q.long()).float() * s_x[:, None] * s_w[None, :]
    after = K7.w8a8_matmul(x_q, s_x, w_nk, s_w, bias)
    before = K7.w8a8_matmul(x_q, s_x, w_nk, s_w, bias, bias_before_cast=True)
    assert torch.equal(after, acc.to(torch.bfloat16) + bias.to(torch.bfloat16))
    assert torch.equal(before, (acc + bias).to(torch.bfloat16))
    assert not torch.equal(after, before)


def _jax_tier_quantize(x):
    """The three lines of the JAX ``_apply_linear_w8a8`` that quantize x."""
    xf = x.astype(jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-8)
    return jnp.clip(jnp.round(xf / s_x), -127, 127).astype(jnp.int8), s_x[..., 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_quantizers_match_jax_bit_for_bit(rng, dtype):
    x = (rng.normal(size=(3, 41, 96)) * rng.uniform(0.01, 10, size=(3, 41, 1)))
    x[0, 0] = 0.0  # the 1e-8 floor
    x[1, 2, :4] = [127.5, -0.5, 0.5, 1.5]  # ties round half to even
    x = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))
    for port, jax_fn in ((K7.quantize_activations, jax_quantize_activations),
                         (K7.quantize_activations_tier, _jax_tier_quantize)):
        got_q, got_s = port(xt)
        want_q, want_s = jax_fn(x)
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the two rules differ only where the floor binds: max(a, f)/127 vs max(a/127, f)
    assert float(K7.quantize_activations(torch.zeros(1, 4))[1]) != \
        float(K7.quantize_activations_tier(torch.zeros(1, 4))[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_linear_matches_jax_apply_linear(rng, dtype):
    k, n = 96, 72
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    bias = rng.normal(size=(n,)).astype(np.float32) * 0.1
    p = JTF._quantize_linear({"weight": jnp.asarray(w), "bias": jnp.asarray(bias, dtype)})
    x = jnp.asarray(rng.normal(size=(2, 37, k)), dtype)
    want = np.asarray(JTF._apply_linear_w8a8(p, x), np.float32)
    w_q, s = K7.quantize_weight(torch.from_numpy(w.T))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(p["weight_q"]).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(p["w_scale"]))
    lin = W8A8Linear(w_q, s,
                     torch.from_numpy(np.asarray(p["bias"], np.float32)).to(getattr(torch, dtype)))
    got = lin(torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 37, n)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:  # one bf16 ulp at the output's magnitude
        ulp = np.abs(want) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(got - want) <= ulp)


@pytest.fixture(scope="module")
def dense_tree():
    params = JTF.init_params(jax.random.PRNGKey(3), JTF.LtxTransformerConfig(**CFG),
                             dtype=jnp.float32)
    rng = np.random.default_rng(12)  # non-zero biases so they are carried
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.02,
        params)


def test_quantize_transformer_w8a8_gives_the_jax_payloads(dense_tree):
    qtree = jax.tree.map(np.asarray, JTF.quantize_transformer_params(dense_tree))
    model = PTF.quantize_transformer_w8a8(
        transformer_from_jax(dense_tree, LtxTransformerConfig(**CFG), device="cpu"))
    carried = transformer_from_jax(qtree, LtxTransformerConfig(**CFG), device="cpu")
    for i, blk in enumerate(model.blocks):
        for group, name in PTF.QUANTIZED_LINEARS:
            leaf = qtree["blocks"][group][name]
            assert set(leaf) == {"weight_q", "w_scale", "bias"}
            for lin in (getattr(getattr(blk, group), name),
                        getattr(getattr(carried.blocks[i], group), name)):
                assert isinstance(lin, W8A8Linear)
                assert lin.w_q.dtype == torch.int8 and lin.w_q.is_contiguous()
                np.testing.assert_array_equal(lin.w_q.numpy(), leaf["weight_q"][i].T)
                np.testing.assert_array_equal(lin.w_scale.numpy(), leaf["w_scale"][i])
                np.testing.assert_array_equal(lin.bias.numpy(), leaf["bias"][i])
    assert isinstance(model.proj_in, torch.nn.Linear)  # non-block linears stay dense


def test_w8a8_dit_forward_matches_jax(dense_tree):
    rng = np.random.default_rng(6)
    qtree = JTF.quantize_transformer_params(dense_tree)
    model = PTF.quantize_transformer_w8a8(
        transformer_from_jax(dense_tree, LtxTransformerConfig(**CFG), device="cpu"))
    b, s, kv = 2, 96, 16
    x = rng.normal(size=(b, s, 8)).astype(np.float32)
    enc = rng.normal(size=(b, kv, 32)).astype(np.float32)
    t = np.array([900.0, 312.5], np.float32)
    grid = rng.uniform(size=(1, s, 3)).astype(np.float32)
    cos, sin = JR.rope_cos_sin(jnp.asarray(grid), 128)
    mask = np.ones((b, kv), np.float32)
    mask[1, 9:] = 0.0
    want = JTF.forward(qtree, JTF.LtxTransformerConfig(**CFG), jnp.asarray(x),
                       jnp.asarray(enc), jnp.asarray(t), cos, sin,
                       encoder_attention_mask=jnp.asarray(mask), attn_impl="xla")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(enc), torch.from_numpy(t),
                    torch.from_numpy(np.array(cos)), torch.from_numpy(np.array(sin)),
                    encoder_attention_mask=torch.from_numpy(mask))
    assert got.shape == (b, s, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


def test_random_w8a8_init():
    model = PTF.init_random_w8a8(LtxTransformerConfig(**CFG), "cpu", torch.float32,
                                 generator=torch.Generator().manual_seed(0))
    ff = model.blocks[1].ff.net_0_proj
    assert isinstance(ff, W8A8Linear)
    assert ff.w_q.shape == (512, 128) and ff.w_q.dtype == torch.int8
    assert ff.w_scale.shape == (512,) and ff.w_scale.dtype == torch.float32
    w = ff.w_q.float() * ff.w_scale[:, None]
    assert abs(w.std().item() - 0.02) < 0.002 and abs(w.mean().item()) < 0.002
    assert int(ff.w_q.min()) >= -127
    out = model(torch.zeros(1, 4, 8), torch.zeros(1, 3, 32), torch.tensor([500.0]),
                torch.ones(1, 4, 128), torch.zeros(1, 4, 128))
    assert out.shape == (1, 4, 8) and torch.isfinite(out).all()


@pytest.mark.cuda
def test_k7_kernel_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K7 is CUDA C++ with no CPU mode")
    _build.reset_launches()
    for m, k, n in SHAPES + [(4992, 2048, 2048)]:
        x_q, w_q, s_x, s_w = (torch.from_numpy(a).cuda() for a in _operands(rng, m, k, n))
        w_nk = w_q.t().contiguous()
        bias = torch.randn(n, device="cuda")
        got = K7.w8a8_matmul(x_q, s_x, w_nk, s_w, bias, bias_before_cast=True)
        want = K7.w8a8_matmul_plain(x_q, s_x, w_nk, s_w, bias, bias_before_cast=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, k, n)
    assert _build.LAUNCHES[K7.NAME] == len(SHAPES) + 1


# ---------------------------------------------------------------------------
# K7 on Hopper: the host plan and the card's schedule, emulated in torch
# ---------------------------------------------------------------------------

# the tier's shapes cut small (M = 4992 -> 256, the M = 128 cross-attention
# k/v at the tier's K) and ragged M, K (40 takes the zero pad) and N
TIER_SMALL = [(256, 256, 512), (256, 512, 256), (128, 2048, 256)]
RAGGED = [(m, k, n) for m in (1, 37, 130) for k in (40, 48, 2064) for n in (72, 200)]
PATH = [(4992, 2048, 2048), (4992, 2048, 8192), (4992, 8192, 2048), (128, 2048, 2048)]


def _plans(m, k, n):
    """The default plan and the forced ones the card's sweep times."""
    yield K7.plan_w8a8(m, k, n)
    for bn in (128, 256):
        for split in (1, 2, 4):
            if split <= -(-(-(-k // 16) * 16) // K7.STEP_K):
                yield K7.plan_w8a8(m, k, n, bn=bn, split=split)


@pytest.mark.parametrize("m,k,n", PATH + TIER_SMALL + RAGGED, ids=str)
def test_k7_plan_covers_the_output_and_fits_the_card(m, k, n):
    for p in _plans(m, k, n):
        assert p["m_tiles"] * p["bm"] >= m > (p["m_tiles"] - 1) * p["bm"]
        assert p["n_tiles"] * p["bn"] >= n > (p["n_tiles"] - 1) * p["bn"]
        assert p["k_pad"] % 16 == 0 and k <= p["k_pad"] < k + 16
        assert (p["steps"] - 1) * K7.STEP_K < p["k_pad"] <= p["steps"] * K7.STEP_K
        # the split's ranges cut the K-steps into consecutive non-empty runs
        assert p["ranges"][0][0] == 0 and p["ranges"][-1][1] == p["steps"]
        assert all(a < b for a, b in p["ranges"]) and len(p["ranges"]) == p["split"]
        assert all(p["ranges"][i][1] == p["ranges"][i + 1][0] for i in range(p["split"] - 1))
        assert p["smem_bytes"] <= K7.SMEM_LIMIT == 232448
        assert p["smem_bytes"] == (1024 + p["stages"] * (p["bm"] + p["bn"]) * 128
                                   + (2 * p["bn"] + p["bm"]) * 4 + 8 * (2 * p["stages"] + 1))
        # each box's inner dimension is one 128-byte swizzled row of int8
        assert p["box_inner_bytes"] == p["box_x"][0] == p["box_w"][0] == 128
        assert p["box_x"][1] == p["bm"] and p["box_w"][1] == p["bn"] <= 256
        assert (p["workspace"] is None) == (p["split"] == 1)
        if p["workspace"] is not None:
            assert p["workspace"] == (p["split"], p["m_tiles"] * 128, p["n_tiles"] * p["bn"])
    # by default a split appears only where the tiles fall short of the SMs
    p = K7.plan_w8a8(m, k, n)
    assert (p["split"] > 1) == (p["tiles"] < K7.H100_SMS and p["steps"] > 1)
    assert p["ctas"] <= max(p["tiles"], K7.H100_SMS)


def test_k7_plan_on_the_path():
    """The W8A8 tier's four linears: the M = 4992 ones on 128 x 256 tiles
    (312 and 1248 CTAs), the M = 128 cross-attention k/v split four ways
    (16 tiles of 128 x 128, 64 CTAs of four K-steps)."""
    for k, n, ctas in ((2048, 2048, 312), (2048, 8192, 1248), (8192, 2048, 312)):
        p = K7.plan_w8a8(4992, k, n)
        assert (p["bn"], p["split"], p["ctas"]) == (256, 1, ctas)
    p = K7.plan_w8a8(128, 2048, 2048)
    assert (p["bn"], p["tiles"], p["split"], p["ctas"]) == (128, 16, 4, 64)
    assert p["ranges"] == [(4 * z, 4 * z + 4) for z in range(4)]
    with pytest.raises(ValueError, match="96-column"):
        K7.plan_w8a8(128, 2048, 2048, bn=96)
    with pytest.raises(ValueError, match="split of 17"):
        K7.plan_w8a8(128, 2048, 2048, split=17)


def _emulate_k7(x_q, s_x, w_q, s_w, bias, plan, drop=None):
    """K7's schedule in torch: x_q and w_q zero-padded to ``k_pad`` and to
    whole tiles, each split's int32 partial over its 128-byte K-steps
    (exact: int64 products that must fit int32), the partials summed
    (``drop`` leaves one out, as a broken reduce would), then
    f32(acc) * s_x, * s_w, + f32 bias, each rounded, and one bf16 cast."""
    m, k = x_q.shape
    n = w_q.shape[0]
    mp, np_, kp = plan["m_tiles"] * plan["bm"], plan["n_tiles"] * plan["bn"], plan["steps"] * 128
    xp = torch.zeros(mp, kp, dtype=torch.int64)
    wp = torch.zeros(np_, kp, dtype=torch.int64)
    xp[:m, :k], wp[:n, :k] = x_q.long(), w_q.long()
    acc = torch.zeros(mp, np_, dtype=torch.int64)
    for z, (a, b) in enumerate(plan["ranges"]):
        part = xp[:, 128 * a:128 * b] @ wp[:, 128 * a:128 * b].t()
        assert int(part.abs().max()) < 2 ** 31
        if z != drop:
            acc += part
    assert int(acc.abs().max()) < 2 ** 31
    y = acc[:m, :n].to(torch.int32).float() * s_x[:, None]
    y = y * s_w[None, :]
    if bias is not None:
        y = y + bias
    return y.to(torch.bfloat16)


def _k7_operands(rng, m, k, n):
    x_q, w_q, s_x, s_w = _operands(rng, m, k, n)
    bias = rng.normal(size=(n,)).astype(np.float32)
    return x_q, np.ascontiguousarray(w_q.T), s_x, s_w, bias


@pytest.mark.parametrize("m,k,n", TIER_SMALL + RAGGED, ids=str)
def test_k7_schedule_emulated_equals_plain_and_pallas_interpret(rng, m, k, n):
    x_q, w_nk, s_x, s_w, bias = _k7_operands(rng, m, k, n)
    tx, tw, tsx, tsw, tb = map(torch.from_numpy, (x_q, w_nk, s_x, s_w, bias))
    for plan in _plans(m, k, n):
        got = _emulate_k7(tx, tsx, tw, tsw, tb, plan)
        assert torch.equal(got, K7.w8a8_matmul_plain(tx, tsx, tw, tsw, tb,
                                                     bias_before_cast=True))
        assert torch.equal(_emulate_k7(tx, tsx, tw, tsw, None, plan),
                           K7.w8a8_matmul_plain(tx, tsx, tw, tsw))
    want = jax_w8a8_matmul(jnp.asarray(x_q), jnp.asarray(s_x), jnp.asarray(w_nk.T),
                           jnp.asarray(s_w), interpret=True)
    got = _emulate_k7(tx, tsx, tw, tsw, None, K7.plan_w8a8(m, k, n))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_k7_schedule_without_one_split_partial_is_wrong(rng):
    """The card's second broken copy leaves one split's partial out of the
    sum: at the cross-attention k/v shape (split 4) that must show."""
    m, k, n = 128, 2048, 256
    plan = K7.plan_w8a8(m, k, n)
    assert plan["split"] == 4
    tx, tw, tsx, tsw, tb = map(torch.from_numpy, _k7_operands(rng, m, k, n))
    want = K7.w8a8_matmul_plain(tx, tsx, tw, tsw, tb, bias_before_cast=True)
    assert torch.equal(_emulate_k7(tx, tsx, tw, tsw, tb, plan), want)
    assert not torch.equal(_emulate_k7(tx, tsx, tw, tsw, tb, plan, drop=1), want)

"""K1 and K2 (lane-packed flash attention, one-pass and long) and the
attention dispatch of the PyTorch port against the JAX package on the CPU,
in f32.

The port's wrapper takes its plain version for CPU tensors; the JAX side
runs the Pallas kernel in interpret mode and its f32 XLA oracle.
Tolerance: max-abs <= 2e-5 (f32 softmax on both sides, same formula).

The card's schedules of K1 and K2 (the online and fixed-shift modes of
``csrc/flash_attention_hopper.cu``: 128-key tiles, log2 units, bf16 p) are
emulated in torch and held against the plain versions and the JAX kernels
at ``chip_smoke.py``'s limits, beside the launch all modes share.  K6, the
online mode without the q rotation at any H, runs K1's emulation at its own
shapes against its plain version and the JAX ``flash_attention``."""

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
        "flash_attention_hopper.cu", "weight_only_matmul_hopper.cu", "int8_matmul.cu",
        "conv3d_igemm.cu", "threefry_normal.cu", "w4_dequant.cu"}
    assert {"cvt_w8a8_matmul", "cvt_conv3d_igemm", "cvt_flash_attention", "cvt_w8_matmul",
            "cvt_w4_matmul", "cvt_weight_only_max_clusters",
            "cvt_threefry_normal", "cvt_w4_dequant"} <= set(_build._SIGNATURES)


def test_patched_library_builds_from_an_edited_copy_and_restores(tmp_path):
    """``_build.patched``: inside the block the library is keyed on a copy of
    the sources with the substitution made; after it, on the real ones; a
    text that is not in the source once is refused."""
    real_csrc, real_path = _build.CSRC, _build.library_path()
    old = "constexpr int MAX_SPLIT = 8;"
    with _build.patched(tmp_path / "copy", "weight_only_matmul_hopper.cu",
                        [(old, "constexpr int MAX_SPLIT = 4;")]):
        assert _build.CSRC == tmp_path / "copy" / "csrc" and _build._lib is None
        text = (_build.CSRC / "weight_only_matmul_hopper.cu").read_text()
        assert "MAX_SPLIT = 4;" in text and old not in text
        assert _build.library_path().parent.parent == tmp_path / "copy" / "_build"
        assert _build.library_path().parent.name != real_path.parent.name
    assert (_build.CSRC, _build.library_path()) == (real_csrc, real_path)
    assert old in (real_csrc / "weight_only_matmul_hopper.cu").read_text()
    with pytest.raises(AssertionError, match="not there once"):
        with _build.patched(tmp_path / "bad", "weight_only_matmul_hopper.cu",
                            [("no such text", "")]):
            pass
    assert _build.CSRC == real_csrc


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z6reducev' for 'sm_90a'
ptxas info    : Function properties for _Z6reducev
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 38 registers, used 0 barriers
"""


def test_parse_ptxas_reads_registers_and_spills_per_entry():
    assert ("-Xptxas", "-v") == _build.NVCC_FLAGS[-2:]
    assert _build.parse_ptxas(PTXAS) == [
        dict(entry="_Z6kernelILi128EEvv", spill_stores=0, spill_loads=0, registers=168),
        dict(entry="_Z6reducev", spill_stores=12, spill_loads=16, registers=38)]
    assert _build.parse_ptxas("nvcc: nothing compiled\n") == []


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
                                 LtxTransformerConfig(**cfg), device="cpu")
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


# ---------------------------------------------------------------------------
# K1 on Hopper (csrc/flash_attention_hopper.cu): its launch parameters, the
# wrapper's refusals, and its tiled log2-domain online softmax emulated in
# torch against the plain version.
# ---------------------------------------------------------------------------

# K1 against its plain version on the card (chip_smoke.py): one bf16 ulp
# elementwise (|d| <= 8e-3 * max(1, |want|)) and rel <= 4e-3
K1_TOL = dict(scaled=8e-3, rel=4e-3)


@pytest.mark.parametrize("d", [64, 128])
def test_k1_launch_params_fit_the_card(d):
    p = FAP.k1_launch_params(d)
    assert p["smem_bytes"] <= FAP.SMEM_LIMIT == 232448
    assert all(1 <= n <= 256 for n in p["box"]) and p["box_inner_bytes"] <= 128
    assert p["boxes_per_tile"] * p["box"][0] == d and p["box"][1] == p["block_k"]
    assert p["threads"] == 128 * (p["consumers"] + 1) and p["block_q"] == 64 * p["consumers"]
    assert p["stages"] in (2, 3)
    # q, the ring and its barriers, and no byte unaccounted
    tile = p["block_k"] * d * 2
    assert p["smem_bytes"] == 1024 + p["block_q"] * d * 2 + p["stages"] * (2 * tile + 16)


def test_k1_launch_params_refuse_other_widths():
    with pytest.raises(ValueError, match="head dim 96"):
        FAP.k1_launch_params(96)


class _OnCard:
    """A CPU tensor that reports itself on a card: enough of one for the
    wrapper's input checks, which run before any launch."""

    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("fault", ["non-contiguous", "misaligned"])
def test_k1_refuses_misaligned_or_non_contiguous_input(fault):
    b, s, h, d = 1, 16, 2, 64
    q = torch.zeros(b, s, h * d, dtype=torch.bfloat16)
    kv = torch.zeros(b, s, h * d, dtype=torch.bfloat16)
    if fault == "non-contiguous":
        bad = torch.zeros(b, h * d, s, dtype=torch.bfloat16).transpose(1, 2)
    else:  # one bf16 element past a 16-byte boundary
        bad = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)[1:].view(b, s, h * d)
    assert bad.is_contiguous() == (fault == "misaligned")
    FAP._check(_OnCard(q), _OnCard(kv), _OnCard(kv), h, None, None)  # the good inputs pass
    with pytest.raises(ValueError, match="inputs must be contiguous and 16-byte aligned"):
        FAP._check(_OnCard(q), _OnCard(bad), _OnCard(kv), h, None, None)


def test_kernel_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    import shutil

    shutil.copytree(_build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    before = _build.library_path()
    header = tmp_path / "csrc" / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before


def _emulate_k1(q, k, v, num_heads, scale, bias=None, rope_q=None):
    """K1's schedule in torch: q rotated in f32 and rounded to bf16, 128-key
    tiles, scores in log2 units ((s·scale + bias)·log2e, keys >= K at -1e30
    in the last tile), the running (m, l) in f32, p rounded to bf16 for P·V,
    O rescaled by exp2(m_old - m_new), one divide by l, bf16 out."""
    from candle_video_tpu_torch.ops.rope import apply_rotary_emb

    if rope_q is not None:
        q = apply_rotary_emb(q.float(), rope_q[0], rope_q[1]).to(torch.bfloat16)
    b, s, hd = q.shape
    kv, d = k.shape[1], hd // num_heads
    qf = q.reshape(b, s, num_heads, d).float().transpose(1, 2)
    kf = k.reshape(b, kv, num_heads, d).float().transpose(1, 2)
    vf = v.reshape(b, kv, num_heads, d).float().transpose(1, 2)
    block = FAP.k1_launch_params(d)["block_k"]
    m = torch.full((b, num_heads, s, 1), -1e30)
    l = torch.zeros(b, num_heads, s, 1)
    o = torch.zeros(b, num_heads, s, d)
    for k0 in range(0, kv, block):
        keys = torch.arange(k0, k0 + block)
        kt = torch.zeros(b, num_heads, block, d)
        vt = torch.zeros(b, num_heads, block, d)
        n = min(block, kv - k0)  # TMA zero-fills the tile past K
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
        sc = (qf @ kt.transpose(-1, -2)) * (scale * LOG2E)
        if bias is not None:
            bk = torch.zeros(b, block)
            bk[:, :n] = bias.reshape(b, kv)[:, k0:k0 + n].float() * LOG2E
            sc = sc + bk[:, None, None, :]
        sc = torch.where(keys < kv, sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (o / l).transpose(1, 2).reshape(b, s, hd).to(torch.bfloat16)


LOG2E = 1.4426950408889634


@pytest.mark.parametrize("s,kv,h,d,with_bias,with_rope", [
    (200, 65, 4, 64, True, False),     # K = 65: one tile, 63 slots of padding
    (130, 129, 4, 64, True, False),    # K = 129: one key past a tile
    (257, 300, 2, 128, False, True),   # D = 128, q RoPE, ragged S
], ids=["K65", "K129", "d128_rope"])
def test_k1_schedule_emulated_matches_plain(rng, s, kv, h, d, with_bias, with_rope):
    q, k, v, bias, rope = _inputs(rng, 2, s, kv, h, d, with_bias, with_rope)
    q = torch.from_numpy(q * 2).bfloat16()
    k, v = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    args = dict(num_heads=h, scale=d ** -0.5, bias=_t(bias),
                rope_q=None if rope is None else (_t(rope[0]), _t(rope[1])))
    got = _emulate_k1(q, k, v, **args)
    want = FAP.flash_attention_packed_plain(q, k, v, **args)
    dd = got.float() - want.float()
    assert float((dd.abs() / want.float().abs().clamp_min(1.0)).max()) <= K1_TOL["scaled"]
    assert float(dd.norm() / want.float().norm()) <= K1_TOL["rel"]


# ---------------------------------------------------------------------------
# K6 on Hopper: the online mode without the q rotation, at any H.  Its
# [B, S, H, D] inputs are K1's [B, S, H*D]; K1's emulated schedule at K6's
# shapes (5 heads of 64 as at SVD level 0, 3 of 128; ragged K one key into
# a tile, one key past it, and over eight tiles) against K6's plain version
# and the JAX kernel in interpret mode on the same bf16 values in f32, at
# K1's limits.
# ---------------------------------------------------------------------------

JK6 = importlib.import_module("candle_video_tpu.ops.pallas.flash_attention")
K6 = importlib.import_module("candle_video_tpu_torch.ops.kernels.flash_attention")
K6_CASES = [(h, d, kv, with_bias) for h, d in ((5, 64), (3, 128))
            for kv in (65, 129, 1000) for with_bias in (False, True)]


def _k6_inputs(rng, h, d, kv, with_bias, b=2, s=77):
    """bf16 q·2, k, v [B, S|K, H, D] and an f32 key bias [B, 1, 1, K] with a
    -1e4 mask and O(1) values, as K6 gets them."""
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, h, d)).astype(np.float32)).bfloat16()
               for n in (s, kv, kv))
    q = (q.float() * 2).bfloat16()
    bias = None
    if with_bias:
        keep = rng.uniform(size=(b, kv)) > 0.3
        keep[:, 0] = True
        bias = torch.from_numpy(((1.0 - keep) * -10000.0 + rng.normal(size=(b, kv)))
                                .astype(np.float32)[:, None, None, :])
    return q, k, v, bias


def _emulate_k6(q, k, v, scale, bias=None):
    b, s, h, d = q.shape
    flat = lambda t: t.reshape(t.shape[0], t.shape[1], h * d)  # noqa: E731
    return _emulate_k1(flat(q), flat(k), flat(v), h, scale, bias=bias).reshape(b, s, h, d)


@pytest.mark.parametrize("h,d,kv,with_bias", K6_CASES, ids=str)
def test_k6_schedule_emulated_matches_plain(rng, h, d, kv, with_bias):
    q, k, v, bias = _k6_inputs(rng, h, d, kv, with_bias)
    got = _emulate_k6(q, k, v, d ** -0.5, bias)
    _assert_within(got, K6.flash_attention_plain(q, k, v, scale=d ** -0.5, bias=bias), K1_TOL)


@pytest.mark.parametrize("h,d,kv,with_bias", K6_CASES, ids=str)
def test_k6_schedule_emulated_matches_pallas_interpret(rng, h, d, kv, with_bias):
    q, k, v, bias = _k6_inputs(rng, h, d, kv, with_bias)
    got = _emulate_k6(q, k, v, d ** -0.5, bias)
    f32 = lambda t: None if t is None else jnp.asarray(t.float().numpy())  # noqa: E731
    want = JK6.flash_attention(f32(q), f32(k), f32(v), scale=d ** -0.5, bias=f32(bias),
                               block_k=128, interpret=True)
    _assert_within(got, torch.from_numpy(np.array(want)), K1_TOL)


# ---------------------------------------------------------------------------
# K2 on Hopper: the fixed-shift mode of csrc/flash_attention_hopper.cu.  Its
# schedule emulated in torch against the plain version and the JAX kernel
# in interpret mode, and the launch every mode shares.
# ---------------------------------------------------------------------------

# K2 against its plain version on the card (chip_smoke.py): K1's limits
K2_TOL = dict(scaled=8e-3, rel=4e-3)


def _emulate_k2(q, k, v, num_heads, scale, bias=None, rope_q=None, ftz=False):
    """K2's schedule in torch: the shift of ``long_shift`` (on q before its
    rotation) read once per (batch, head) in log2 units, q rotated in f32
    and rounded to bf16, 128-key tiles, p = exp2(s·scale·log2e +
    bias·log2e − shift·log2e) with keys >= K at -1e30, l += Σp in f32, p
    rounded to bf16 for P·V, no max and no rescale, one divide by l, bf16
    out.  ``ftz`` flushes subnormal p to 0, as ``ex2.approx.ftz`` would."""
    from candle_video_tpu_torch.ops.rope import apply_rotary_emb

    shift = FAP.long_shift(q, k, num_heads=num_heads, scale=scale, bias=bias)
    if rope_q is not None:
        q = apply_rotary_emb(q.float(), rope_q[0], rope_q[1]).to(torch.bfloat16)
    b, s, hd = q.shape
    kv, d = k.shape[1], hd // num_heads
    m = shift.repeat_interleave(128 // d, dim=1)[:, :, None, None] * LOG2E  # [B, H, 1, 1]
    qf = q.reshape(b, s, num_heads, d).float().transpose(1, 2)
    kf = k.reshape(b, kv, num_heads, d).float().transpose(1, 2)
    vf = v.reshape(b, kv, num_heads, d).float().transpose(1, 2)
    block = FAP.launch_params(d, "fixed")["block_k"]
    l = torch.zeros(b, num_heads, s, 1)
    o = torch.zeros(b, num_heads, s, d)
    for k0 in range(0, kv, block):
        keys = torch.arange(k0, k0 + block)
        kt = torch.zeros(b, num_heads, block, d)
        vt = torch.zeros(b, num_heads, block, d)
        n = min(block, kv - k0)  # TMA zero-fills the tile past K
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
        sc = (qf @ kt.transpose(-1, -2)) * (scale * LOG2E)
        if bias is not None:
            bk = torch.zeros(b, block)
            bk[:, :n] = bias.reshape(b, kv)[:, k0:k0 + n].float() * LOG2E
            sc = sc + bk[:, None, None, :]
        sc = torch.where(keys < kv, sc - m, torch.tensor(-1e30))
        p = torch.exp2(sc)
        if ftz:
            p = torch.where(p < 2.0 ** -126, torch.zeros(()), p)
        l = l + p.sum(-1, keepdim=True)
        o = o + p.to(torch.bfloat16).float() @ vt
    return (o / l).transpose(1, 2).reshape(b, s, hd).to(torch.bfloat16)


def _bf16_inputs(rng, b, s, kv, h, d, with_bias, with_rope):
    """``_inputs`` as the card gets them: q·2, k, v in bf16 (k rotated when
    q is and S = K, as in a self-attention), bias and tables in f32."""
    q, k, v, bias, rope = _inputs(rng, b, s, kv, h, d, with_bias, with_rope)
    rope = None if rope is None else (_t(rope[0]), _t(rope[1]))
    q, k, v = (torch.from_numpy(x).bfloat16() for x in (q * 2, k, v))
    if rope is not None and s == kv:  # the path hands the kernel a rotated k
        k = PR.apply_rotary_emb(k.float(), *rope).bfloat16()
    return q, k, v, _t(bias), rope


def _assert_within(got, want, tol):
    dd = got.float() - want.float()
    assert float((dd.abs() / want.float().abs().clamp_min(1.0)).max()) <= tol["scaled"]
    assert float(dd.norm() / want.float().norm()) <= tol["rel"]


@pytest.mark.parametrize("s,kv,h,d,with_bias,with_rope", [
    (200, 65, 4, 64, True, False),     # K = 65: one tile, 63 slots of padding
    (130, 129, 4, 64, True, False),    # K = 129: one key past a tile
    (257, 300, 2, 128, False, True),   # D = 128, q RoPE, ragged S
    (77, 1000, 4, 64, True, True),     # biased, ragged S and K, eight tiles
], ids=["K65", "K129", "d128_rope", "bias_rope"])
def test_k2_schedule_emulated_matches_plain(rng, s, kv, h, d, with_bias, with_rope):
    q, k, v, bias, rope = _bf16_inputs(rng, 2, s, kv, h, d, with_bias, with_rope)
    args = dict(num_heads=h, scale=d ** -0.5, bias=bias, rope_q=rope)
    _assert_within(_emulate_k2(q, k, v, **args),
                   FAP.flash_attention_packed_long_plain(q, k, v, **args), K2_TOL)


@pytest.mark.parametrize("kv,with_bias,with_rope", [
    (1000, False, True),   # in-kernel q rotation, ragged last tile
    (300, True, False),    # a -1e4 key mask folded into the shift
], ids=["rope_q", "bias_kv300"])
def test_k2_schedule_emulated_matches_pallas_long_interpret(rng, kv, with_bias, with_rope):
    b, s, h, d = 1, 200, 4, 64
    q, k, v, bias, rope = _bf16_inputs(rng, b, s, kv, h, d, with_bias, with_rope)
    args = dict(num_heads=h, scale=d ** -0.5, bias=bias, rope_q=rope)
    f32 = lambda t: None if t is None else jnp.asarray(t.float().numpy())  # noqa: E731
    want = JFAP._packed_long(
        f32(q), f32(k), f32(v), num_heads=h, scale=d ** -0.5, bias=f32(bias),
        rope_q=None if rope is None else tuple(map(f32, rope)),
        block_q=128, block_k=256, interpret=True)
    _assert_within(_emulate_k2(q, k, v, **args), torch.from_numpy(np.array(want)), K2_TOL)


def test_k2_schedule_keeps_subnormal_p_far_under_the_shift():
    """Rows whose scores lie ~81 nats under the shift (the bound clipped at
    40, the realised row max near -41): their p are subnormal f32.  Kept
    (the kernel's ex2.approx.f32), the schedule holds K2's limits; flushed
    (ex2.approx.ftz), it drops most of those rows' mass."""
    rng = np.random.default_rng(47)
    b, s, kv, h, d = 1, 128, 8320, 2, 64
    u = rng.normal(size=(h, d))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    k = 6 * u + 0.2 * rng.normal(size=(b, kv, h, d))
    q = -(47 * 8 / 6) * u + 0.2 * rng.normal(size=(b, s, h, d))
    q[:, 0] = 60 * u  # one aligned row lifts the bound past the clip
    q, k, v = (torch.from_numpy(x.reshape(b, x.shape[1], h * d)).bfloat16()
               for x in (q, k, rng.normal(size=(b, kv, h, d))))
    args = dict(num_heads=h, scale=d ** -0.5)
    shift = FAP.long_shift(q, k, **args)
    assert float(shift.min()) == FAP._BOUND_CLIP
    rowmax = (q.float().view(b, s, h, d).transpose(1, 2) @
              k.float().view(b, kv, h, d).permute(0, 2, 3, 1)).amax(-1) * d ** -0.5
    assert float(rowmax[:, :, 1:].max()) < -39.0  # ~80 nats under the shift
    want = FAP.flash_attention_packed_long_plain(q, k, v, **args)
    _assert_within(_emulate_k2(q, k, v, **args), want, K2_TOL)
    flushed = _emulate_k2(q, k, v, **args, ftz=True).float()
    assert float((flushed - want.float()).norm() / want.float().norm()) > K2_TOL["rel"]


@pytest.mark.parametrize("mode", FAP.MODES)
@pytest.mark.parametrize("d", [64, 128])
def test_launch_params_fit_the_card_in_every_mode(mode, d):
    p = FAP.launch_params(d, mode)
    assert p["smem_bytes"] <= FAP.SMEM_LIMIT
    assert p == FAP.k1_launch_params(d)  # one launch for all three modes: K1's


@pytest.mark.parametrize("mode", FAP.MODES)
def test_launch_params_refuse_other_widths(mode):
    with pytest.raises(ValueError, match="head dim 32"):
        FAP.launch_params(32, mode)


def test_launch_params_refuse_other_modes():
    with pytest.raises(ValueError, match="mode 'causal'"):
        FAP.launch_params(64, "causal")

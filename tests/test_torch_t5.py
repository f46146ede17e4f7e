"""The PyTorch port's T5 encoder against the JAX package on the CPU, in f32,
on a narrow config (d_model 64, d_ff 128: multiples of 32 so the int8
groups divide K).

Tolerances: dense max-abs <= 2e-4; int8 (K3 on both sides) and the
Q4_K-form w4 carry (K4 on both sides) relative Frobenius error <= 1e-2.

``t5_from_gguf`` is checked on synthetic GGUF files that mix Q4_K, Q5_K,
Q6_K, Q8_0 and f32 payloads: its carries against the JAX
``params_from_gguf(keep_quantized=True)`` leaves bit for bit, and both
loaders' forwards against each other."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import t5 as JT5
from candle_video_tpu.ops.pallas.int4_weight_matmul import quantize_int4_blockwise
from candle_video_tpu.ops.pallas.int8_weight_matmul import quantize_int8_blockwise
from candle_video_tpu.quant import dequant_np as DQ
from candle_video_tpu_torch.models.ltx_video import t5 as PT5
from candle_video_tpu_torch.models.ltx_video.configs import T5Config
from candle_video_tpu_torch.models.ltx_video.convert import t5_from_jax
from candle_video_tpu_torch.ops.quant_linear import Int4Linear, Int8Linear

torch.set_num_threads(2)

CFG = dict(vocab_size=64, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)


def t5_tree(rng, quant: str = "dense"):
    """Per-layer-list JAX T5 tree; ``quant`` 'dense', 'int8', 'int8_affine'
    (the K-quant {w_q, s, b} carry with a rank-G correction) or 'w4' (the
    Q4_K-form {w4, w4_scale, w4_min} carry, f32 scale and min)."""
    d, ff = CFG["d_model"], CFG["d_ff"]

    def lin(k, n):
        w = (rng.normal(size=(k, n)) * 0.08).astype(np.float32)
        if quant == "dense":
            return {"weight": jnp.asarray(w)}
        if quant == "w4":
            p, sc, mn = quantize_int4_blockwise(w, 32)
            return {"w4": jnp.asarray(p), "w4_scale": jnp.asarray(sc),
                    "w4_min": jnp.asarray(mn)}
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
    enc = t5_from_jax(np_tree, pcfg, device="cpu")
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
                                           ("int8_affine", False), ("w4", False),
                                           ("w4", True)])
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


def test_w4_fill_matches_the_jax_bench(rng):
    enc = PT5.init_random_w4(T5Config(**CFG), "cpu", torch.float32)
    lin = enc.blocks[1].wi_1  # seed 7 * 1 + 6
    assert isinstance(lin, Int4Linear) and lin.w4.dtype == torch.uint8
    k, n = CFG["d_model"], CFG["d_ff"]
    assert lin.w4.shape == (k // 2, n) and lin.w4_scale.shape == (k // 32, n)
    i = np.arange(k // 2 * n, dtype=np.uint64)
    want = ((i * np.uint64(2654435761) + np.uint64(13)) % np.uint64(2 ** 32)) % np.uint64(256)
    np.testing.assert_array_equal(lin.w4.numpy().reshape(-1), want.astype(np.uint8))
    assert lin.w4_scale.dtype == torch.float32
    assert torch.all(lin.w4_scale == 1e-4) and torch.all(lin.w4_min == -7.5e-4)


# ---------------------------------------------------------------------------
# GGUF loader
# ---------------------------------------------------------------------------

GGUF_CFG = dict(vocab_size=64, d_model=256, d_kv=32, d_ff=512, num_layers=2, num_heads=8)
# layer roles per payload type: every type the loader carries, mixed per layer
GGUF_TYPES = {"attn_q": DQ.GGML_Q4_K, "attn_k": DQ.GGML_Q5_K, "attn_v": DQ.GGML_Q8_0,
              "attn_o": DQ.GGML_Q6_K, "ffn_gate": DQ.GGML_Q4_K, "ffn_up": None,
              "ffn_down": DQ.GGML_Q6_K}
ROLES = {"attn_q": ("attn", "q"), "attn_k": ("attn", "k"), "attn_v": ("attn", "v"),
         "attn_o": ("attn", "o"), "ffn_gate": ("ffn", "wi_0"), "ffn_up": ("ffn", "wi_1"),
         "ffn_down": ("ffn", "wo")}


def _kquant_gguf(tmp_path, rng, types):
    """Tiny T5 GGUF whose linear tensors use the given types per role (None
    for f32), a Q8_0 embedding and f32 norms (d_model=256 so rows are
    QK_K-aligned)."""
    from candle_video_tpu.quant.gguf import write_gguf

    quantizers = {DQ.GGML_Q4_K: DQ.quantize_q4_k, DQ.GGML_Q5_K: DQ.quantize_q5_k,
                  DQ.GGML_Q6_K: DQ.quantize_q6_k, DQ.GGML_Q8_0: DQ.quantize_q8_0}
    tensors = {}

    def add(name, shape, tid=None):
        x = rng.normal(size=shape).astype(np.float32) * 0.1
        if tid is None:
            tensors[name] = (DQ.GGML_F32, shape, x.view(np.uint8).reshape(-1))
        else:
            tensors[name] = (tid, shape, quantizers[tid](x))

    add("token_embd.weight", (64, 256), DQ.GGML_Q8_0)
    add("enc.output_norm.weight", (256,))
    for i in range(2):
        pre = f"enc.blk.{i}"
        for nm, shape in [("attn_q", (256, 256)), ("attn_k", (256, 256)),
                          ("attn_v", (256, 256)), ("attn_o", (256, 256)),
                          ("ffn_gate", (512, 256)), ("ffn_up", (512, 256)),
                          ("ffn_down", (256, 512))]:
            add(f"{pre}.{nm}.weight", shape, types.get(nm, DQ.GGML_Q5_K))
        add(f"{pre}.attn_norm.weight", (256,))
        add(f"{pre}.ffn_norm.weight", (256,))
    add("enc.blk.0.attn_rel_b.weight", (32, 8))
    path = str(tmp_path / "t5_kq.gguf")
    write_gguf(path, tensors, {"general.architecture": "t5"})
    return path


# JAX carry leaf -> the port module's buffer
_CARRY = {"w_q": "w_q", "s": "s", "b": "b", "w4": "w4", "w4_scale": "w4_scale",
          "w4_min": "w4_min"}


def test_gguf_keep_quantized_carries_match_jax_bit_for_bit(tmp_path, rng):
    path = _kquant_gguf(tmp_path, rng, GGUF_TYPES)
    cfg = T5Config(**GGUF_CFG)
    want = JT5.params_from_gguf(path, JT5.T5Config(**GGUF_CFG), keep_quantized=True)
    enc = PT5.t5_from_gguf(path, cfg, "cpu", keep_quantized=True)  # bf16, as the JAX default
    kinds = {DQ.GGML_Q4_K: Int4Linear, None: Int8Linear}
    for i, blk in enumerate(enc.blocks):
        for role, (group, name) in ROLES.items():
            leaf = want["blocks"][i][group][name]
            lin = getattr(blk, name)
            assert isinstance(lin, kinds.get(GGUF_TYPES[role], Int8Linear)), role
            assert {k for k in _CARRY if getattr(lin, k, None) is not None} == set(leaf), role
            for jname, arr in leaf.items():
                got = getattr(lin, _CARRY[jname])
                arr = np.asarray(arr)
                assert got.numpy().dtype == arr.dtype, (role, jname)
                np.testing.assert_array_equal(got.numpy(), arr, err_msg=f"{role}.{jname}")
    np.testing.assert_array_equal(
        enc.rel_bias.numpy(), np.asarray(want["blocks"][0]["attn"]["relative_attention_bias"]))
    for got, arr in ((enc.embedding, want["embedding"]),
                     (enc.final_norm, want["final_norm"]["weight"]),
                     (enc.blocks[1].ffn_norm, want["blocks"][1]["ffn_norm"]["weight"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(arr, np.float32))


@pytest.mark.parametrize("keep_quantized", [True, False])
def test_gguf_forward_matches_jax(tmp_path, rng, keep_quantized):
    path = _kquant_gguf(tmp_path, rng, GGUF_TYPES)
    jcfg, pcfg = JT5.T5Config(**GGUF_CFG), T5Config(**GGUF_CFG)
    ids, mask = _ids(rng)
    want = np.asarray(JT5.forward(
        JT5.params_from_gguf(path, jcfg, dtype=jnp.float32, keep_quantized=keep_quantized),
        jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    enc = PT5.t5_from_gguf(path, pcfg, "cpu", torch.float32,
                           keep_quantized=keep_quantized)
    if not keep_quantized:
        assert isinstance(enc.blocks[0].q, torch.nn.Linear)
    got = enc(torch.from_numpy(ids.astype(np.int64)),
              attention_mask=torch.from_numpy(mask.astype(np.float32))).numpy()
    if keep_quantized:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-2, rel
    else:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("tid", [DQ.GGML_Q5_K, DQ.GGML_Q6_K])
def test_port_quantizers_write_a_gguf_that_loads_as_jax_dequantizes(tmp_path, rng, tid):
    """The port's own ``quantize_q5_k`` / ``quantize_q6_k`` equal the JAX
    package's bit for bit; a T5 GGUF with every linear in that type, written
    by the port's ``write_gguf``, loads through ``t5_from_gguf`` (f32,
    dequantized) to the JAX ``dequantize_np`` of the same bytes, exactly."""
    from candle_video_tpu_torch.quant import dequant_np as PDQ
    from candle_video_tpu_torch.quant.gguf import write_gguf

    quantize = {DQ.GGML_Q5_K: PDQ.quantize_q5_k, DQ.GGML_Q6_K: PDQ.quantize_q6_k}[tid]
    jax_quantize = {DQ.GGML_Q5_K: DQ.quantize_q5_k, DQ.GGML_Q6_K: DQ.quantize_q6_k}[tid]
    tensors, linears = {}, {}

    def add(name, shape, t=None):
        x = rng.normal(size=shape).astype(np.float32) * 0.1
        if t is None:
            tensors[name] = (DQ.GGML_F32, shape, x.view(np.uint8).reshape(-1))
            return
        raw = quantize(x)
        np.testing.assert_array_equal(raw, jax_quantize(x), err_msg=name)
        tensors[name] = (t, shape, raw)

    add("token_embd.weight", (64, 256))
    add("enc.output_norm.weight", (256,))
    for i in range(2):
        for role, shape in [("attn_q", (256, 256)), ("attn_k", (256, 256)),
                            ("attn_v", (256, 256)), ("attn_o", (256, 256)),
                            ("ffn_gate", (512, 256)), ("ffn_up", (512, 256)),
                            ("ffn_down", (256, 512))]:
            add(f"enc.blk.{i}.{role}.weight", shape, tid)
            linears[(i, ROLES[role][1])] = f"enc.blk.{i}.{role}.weight"
        add(f"enc.blk.{i}.attn_norm.weight", (256,))
        add(f"enc.blk.{i}.ffn_norm.weight", (256,))
    add("enc.blk.0.attn_rel_b.weight", (32, 8))
    path = str(tmp_path / "t5_port.gguf")
    write_gguf(path, tensors, {"general.architecture": "t5"})
    enc = PT5.t5_from_gguf(path, T5Config(**GGUF_CFG), "cpu", torch.float32,
                           keep_quantized=False)
    for (i, name), key in linears.items():
        t, shape, raw = tensors[key]
        want = DQ.dequantize_np(t, raw, int(np.prod(shape))).reshape(shape)
        got = getattr(enc.blocks[i], name).weight.detach().numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_port_gguf_reader_matches_jax_reader(tmp_path, rng):
    """The port's own GGUF reader (``candle_video_tpu_torch/quant``) on a
    file written by the JAX package's ``write_gguf``: the same names, shapes,
    metadata and dequantized arrays, bit for bit, for Q8_0, Q4_K and f32."""
    from candle_video_tpu.quant.gguf import GGUFFile as JGGUFFile
    from candle_video_tpu.quant.gguf import write_gguf
    from candle_video_tpu_torch.quant import dequant_np as PDQ
    from candle_video_tpu_torch.quant.gguf import GGUFFile as PGGUFFile

    tensors = {}
    for name, tid, shape in [("q8", DQ.GGML_Q8_0, (8, 64)), ("q4k", DQ.GGML_Q4_K, (4, 256)),
                             ("f32", DQ.GGML_F32, (3, 5))]:
        x = rng.normal(size=shape).astype(np.float32)
        raw = (x.view(np.uint8).reshape(-1) if tid == DQ.GGML_F32 else
               {DQ.GGML_Q8_0: DQ.quantize_q8_0, DQ.GGML_Q4_K: DQ.quantize_q4_k}[tid](x))
        tensors[name] = (tid, shape, raw)
    path = str(tmp_path / "mixed.gguf")
    write_gguf(path, tensors, {"general.architecture": "t5", "t5.block_count": 2})
    jf, pf = JGGUFFile(path), PGGUFFile(path)
    try:
        assert pf.tensor_names() == jf.tensor_names() == list(tensors)
        assert pf.metadata == jf.metadata
        for name, (tid, shape, _) in tensors.items():
            assert pf.tensors[name].ggml_type == tid and tuple(pf.tensors[name].shape) == shape
            np.testing.assert_array_equal(pf.raw_tensor(name), jf.raw_tensor(name))
            np.testing.assert_array_equal(pf.tensor(name), jf.tensor(name))
        q, s, m = PDQ.extract_q4_k_fields(pf.raw_tensor("q4k"), 1024)
        for a, b in zip((q, s, m), DQ.extract_q4_k_fields(jf.raw_tensor("q4k"), 1024)):
            np.testing.assert_array_equal(a, b)
    finally:
        jf.close()
        pf.close()

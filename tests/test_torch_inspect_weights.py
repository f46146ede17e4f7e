"""The port's checkpoint inspection tool
(``candle_video_tpu_torch/utils/inspect_weights.py``) against the JAX
package's ``scripts/inspect_weights.py``, imported as it is:

- ``list`` prints the JAX script's text on the three fixtures and on a GGUF
  file of Q8_0, Q4_K, Q5_K, Q6_K, F16 and F32 tensors written by the port's
  quantizers; ``split`` on an official-layout file the port writes;
- ``dump-embeds`` with a ``tokenizer.json`` (built here with the
  ``tokenizers`` package; skipped without it): the ids of both tools'
  ``T5TokenizerWrapper``, the embeddings against JAX ``T5.forward`` on
  ``params_from_gguf`` of the same tiny GGUF T5 in f32 within atol 2e-4
  (``test_torch_t5.py``'s limit), and the file's keys, dtypes and shapes
  against what the JAX script writes;
- ``dump-embeds`` without ``--tokenizer`` round-trips bit for bit: its file
  through ``cli.main --embeddings-file`` gives the latents of ``cli.main
  --t5-gguf`` on the same prompt;
- the tool imports neither ``jax``, ``candle_video_tpu`` nor ``safetensors``
  (a subprocess, ``python -m`` included).
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import t5 as JT5
from candle_video_tpu_torch.models.ltx_video import configs as C
from candle_video_tpu_torch.models.ltx_video import loader as L
from candle_video_tpu_torch.models.ltx_video import transformer as TF
from candle_video_tpu_torch.models.ltx_video import vae as V
from candle_video_tpu_torch.models.ltx_video import weight_format as PW
from candle_video_tpu_torch.quant import dequant_np as DQ
from candle_video_tpu_torch.quant.gguf import write_gguf
from candle_video_tpu_torch.utils import inspect_weights as IW
from candle_video_tpu_torch.utils.tokenizer import T5TokenizerWrapper

from test_torch_pipeline import T5_CFG, _cli_latents, tiny_cli  # noqa: F401  (fixture)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = sorted(str(p) for p in (ROOT / "fixtures").glob("*.safetensors"))
T5_ATOL = 2e-4


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_inspect_weights",
                                                  ROOT / "scripts" / "inspect_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JS = _jax_script()


def _stdout(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


_QUANTIZERS = {DQ.GGML_Q8_0: DQ.quantize_q8_0, DQ.GGML_Q4_K: DQ.quantize_q4_k,
               DQ.GGML_Q5_K: DQ.quantize_q5_k, DQ.GGML_Q6_K: DQ.quantize_q6_k,
               DQ.GGML_F16: lambda x: x.astype(np.float16).view(np.uint8).reshape(-1),
               DQ.GGML_F32: lambda x: x.view(np.uint8).reshape(-1)}


def _tensor(rng, ggml_type, shape, scale=0.1):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return ggml_type, shape, _QUANTIZERS[ggml_type](x)


def _t5_gguf(path, cfg, seed=0, linear_type=DQ.GGML_Q8_0):
    """A GGUF T5 of ``cfg`` (``enc.blk.N.*`` names): the linears and the
    embedding in ``linear_type``, the norms and the relative bias F32."""
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.d_ff
    tensors = {"token_embd.weight": _tensor(rng, linear_type, (cfg.vocab_size, d), 1.0),
               "enc.output_norm.weight": _tensor(rng, DQ.GGML_F32, (d,))}
    for i in range(cfg.num_layers):
        for name, shape in [("attn_q", (d, d)), ("attn_k", (d, d)), ("attn_v", (d, d)),
                            ("attn_o", (d, d)), ("ffn_gate", (ff, d)), ("ffn_up", (ff, d)),
                            ("ffn_down", (d, ff))]:
            tensors[f"enc.blk.{i}.{name}.weight"] = _tensor(rng, linear_type, shape)
        tensors[f"enc.blk.{i}.attn_norm.weight"] = _tensor(rng, DQ.GGML_F32, (d,))
        tensors[f"enc.blk.{i}.ffn_norm.weight"] = _tensor(rng, DQ.GGML_F32, (d,))
    tensors["enc.blk.0.attn_rel_b.weight"] = _tensor(
        rng, DQ.GGML_F32, (cfg.relative_attention_num_buckets, cfg.num_heads), 1.0)
    write_gguf(str(path), tensors, {"general.architecture": "t5", "t5.block_count":
                                    cfg.num_layers})
    return str(path)


@pytest.fixture(scope="module")
def mixed_gguf(tmp_path_factory):
    """Every type the port reads, and metadata of every kind the writer
    writes (a string longer than the 80 characters ``list`` keeps)."""
    rng = np.random.default_rng(3)
    tensors = {f"blk.{name}.weight": _tensor(rng, tid, (4, 512))
               for name, tid in [("q8_0", DQ.GGML_Q8_0), ("q4_k", DQ.GGML_Q4_K),
                                 ("q5_k", DQ.GGML_Q5_K), ("q6_k", DQ.GGML_Q6_K),
                                 ("f16", DQ.GGML_F16)]}
    tensors["output_norm.weight"] = _tensor(rng, DQ.GGML_F32, (512,))
    tensors["a_rank3.weight"] = _tensor(rng, DQ.GGML_F16, (2, 3, 8))
    path = tmp_path_factory.mktemp("gguf") / "mixed.gguf"
    write_gguf(str(path), tensors, {"general.architecture": "t5", "general.name": "x" * 120,
                                    "t5.block_count": 24, "t5.eps": 1e-6, "t5.flag": True})
    return str(path)


@pytest.mark.parametrize("which", [*(Path(f).name for f in FIXTURES), "mixed.gguf"])
def test_list_prints_the_jax_scripts_text(mixed_gguf, which):
    path = mixed_gguf if which == "mixed.gguf" else str(ROOT / "fixtures" / which)
    got = _stdout(IW.cmd_list, path)
    assert got == _stdout(JS.cmd_list, path)
    assert got.count("\n") > 3
    if which == "mixed.gguf":
        assert all(t in got for t in ("Q8_0", "Q4_K", "Q5_K", "Q6_K", "F16", "F32"))


def test_split_prints_the_jax_scripts_text(tmp_path):
    """An official single file of a tiny DiT, decoder and encoder (the port's
    names, officialized), with one key neither side claims."""
    tcfg = C.LtxTransformerConfig(in_channels=8, out_channels=8, num_attention_heads=2,
                                  attention_head_dim=12, cross_attention_dim=24, num_layers=2,
                                  caption_channels=16)
    vcfg = C.LtxVaeConfig(latent_channels=4, block_out_channels=(8, 16, 16),
                          decoder_block_out_channels=(8, 16, 16), layers_per_block=(1, 1, 1, 1),
                          decoder_layers_per_block=(1, 1, 1, 1), patch_size=2)
    g = torch.Generator().manual_seed(0)
    tensors = {PW.officialize_transformer_key(k): v for k, v in
               L.transformer_state_dict(TF.init_random(tcfg, "cpu", torch.bfloat16, g)).items()}
    tensors.update({PW.officialize_vae_key(k): v for k, v in
                    L.vae_decoder_state_dict(V.init_random(vcfg, "cpu", torch.float32,
                                                           g)).items()})
    tensors.update({PW.officialize_vae_key(k): v for k, v in L.vae_encoder_state_dict(
        V.init_random_encoder(vcfg, "cpu", torch.float32, g)).items()})
    tensors["text_projection.weight"] = torch.zeros(2, 2)
    path = str(tmp_path / "unified.safetensors")
    L.save_safetensors(tensors, path)
    got = _stdout(IW.cmd_split, path)
    assert got == _stdout(JS.cmd_split, path)
    last = got.splitlines()[-1]
    assert last.startswith("# transformer: ") and "unclassified: 1" in last
    assert "vae: 0" not in last and "transformer: 0" not in last


TINY_T5 = C.T5Config(**T5_CFG)
PROMPT = "a cat walking on grass at dusk"


def _tokenizer_json(path):
    """A word-level ``tokenizer.json`` over the tiny T5's 64 ids."""
    tokenizers = pytest.importorskip("tokenizers")
    words = ["<pad>", "</s>", "<unk>", *"a cat walking on grass at dusk the dog".split()]
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(path))
    return str(path)


def test_dump_embeds_matches_the_jax_t5_and_file(tmp_path, monkeypatch):
    tok_path = _tokenizer_json(tmp_path / "tokenizer.json")
    gguf = _t5_gguf(tmp_path / "t5.gguf", TINY_T5)
    monkeypatch.setattr(IW, "t5_xxl", lambda: TINY_T5)
    jcfg = JT5.T5Config(**T5_CFG)
    monkeypatch.setattr(JT5, "t5_xxl", lambda: jcfg)
    ids, mask = T5TokenizerWrapper(tok_path, 16).encode_batch([PROMPT], 16)
    from candle_video_tpu.utils.tokenizer import T5TokenizerWrapper as JTok

    want_ids, want_mask = JTok(tok_path, 16).encode_batch([PROMPT], 16)
    assert ids.tolist() == want_ids.tolist() and mask.tolist() == want_mask.tolist()
    assert ids[0, :7].tolist() == [3, 4, 5, 6, 7, 8, 9] and mask.sum() == 7

    out = tmp_path / "port.safetensors"
    printed = _stdout(IW.main, ["dump-embeds", "--t5-gguf", gguf, "--tokenizer", tok_path,
                                "--prompt", PROMPT, "--max-length", "16", "--out", str(out),
                                "--device", "cpu", "--dtype", "float32"])
    assert printed == f"saved {out}: (1, 16, 64)\n"
    got = L.load_safetensors(str(out))
    np.testing.assert_array_equal(got["prompt_attention_mask"].numpy(), mask.astype(np.float32))
    want = JT5.forward(JT5.params_from_gguf(gguf, jcfg, dtype=jnp.float32), jcfg,
                       jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got["prompt_embeds"].numpy(), np.asarray(want), atol=T5_ATOL,
                               rtol=0)

    # the JAX script's file (bf16 T5, its default) against the port's at its default
    monkeypatch.setattr(sys, "argv", ["inspect_weights.py", "dump-embeds", "--t5-gguf", gguf,
                                      "--tokenizer", tok_path, "--prompt", PROMPT,
                                      "--max-length", "16", "--out",
                                      str(tmp_path / "jax.safetensors")])
    jax_printed = _stdout(JS.main)
    port_bf16 = tmp_path / "port_bf16.safetensors"
    _stdout(IW.main, ["dump-embeds", "--t5-gguf", gguf, "--tokenizer", tok_path, "--prompt",
                      PROMPT, "--max-length", "16", "--out", str(port_bf16), "--device", "cpu"])
    assert jax_printed.split(": ")[-1] == printed.split(": ")[-1]
    assert (L.get_tensor_info(str(port_bf16)) == L.get_tensor_info(str(out))
            == L.get_tensor_info(str(tmp_path / "jax.safetensors"))
            == {"prompt_attention_mask": ((1, 16), "F32"),
                "prompt_embeds": ((1, 16, 64), "F32")})


def test_dump_embeds_round_trips_through_the_cli(tiny_cli, tmp_path, monkeypatch):
    """Without ``--tokenizer`` the tool and the CLI hash the prompt alike:
    ``--embeddings-file`` of the tool's file gives ``--t5-gguf``'s latents,
    bit for bit.  The default device is the card, which this machine lacks."""
    gguf = _t5_gguf(tmp_path / "t5.gguf", TINY_T5, seed=5)
    monkeypatch.setattr(IW, "t5_xxl", lambda: TINY_T5)
    emb = str(tmp_path / "emb.safetensors")
    IW.main(["dump-embeds", "--t5-gguf", gguf, "--prompt", PROMPT, "--max-length", "16",
             "--out", emb, "--device", "cpu", "--dtype", "float32"])
    common = ["--weights-path", tiny_cli["official"], "--output-type", "latent",
              "--prompt", PROMPT]
    # clones: the latents view their file, which a later run may write again
    from_gguf = _cli_latents(tiny_cli, *common, "--t5-gguf", gguf).clone()
    from_file = _cli_latents(tiny_cli, *common, "--embeddings-file", emb).clone()
    assert torch.equal(from_gguf, from_file)
    other = str(tmp_path / "other.safetensors")
    IW.main(["dump-embeds", "--t5-gguf", gguf, "--prompt", "a dog", "--max-length", "16",
             "--out", other, "--device", "cpu", "--dtype", "float32"])
    assert not torch.equal(_cli_latents(tiny_cli, *common, "--embeddings-file", other),
                           from_file)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IW.main(["dump-embeds", "--t5-gguf", gguf, "--out", emb])


def test_tool_never_imports_jax_or_safetensors(tmp_path, mixed_gguf):
    script = textwrap.dedent("""
        import runpy, sys
        for name in ("candle_video_tpu", "jax", "safetensors"):
            sys.modules[name] = None  # none of them can be imported
        import torch
        torch.set_num_threads(1)
        mixed, fixture, out, t5_gguf = sys.argv[1:5]
        sys.argv = ["inspect_weights", "list", mixed]
        try:
            runpy.run_module("candle_video_tpu_torch.utils.inspect_weights", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        from candle_video_tpu_torch.models.ltx_video.configs import T5Config
        from candle_video_tpu_torch.utils import inspect_weights as IW
        IW.main(["split", fixture])
        IW.t5_xxl = lambda: T5Config(**%r)
        IW.main(["dump-embeds", "--t5-gguf", t5_gguf, "--out", out, "--max-length", "16",
                 "--device", "cpu"])
        assert not [m for m in sys.modules if m.startswith(("jax", "candle_video_tpu."))
                    and sys.modules[m] is not None], sorted(sys.modules)
        assert sys.modules["safetensors"] is None
        print("NO_JAX_OK")
    """) % (T5_CFG,)
    gguf = _t5_gguf(tmp_path / "t5.gguf", TINY_T5)
    res = subprocess.run(
        [sys.executable, "-c", script, mixed_gguf, FIXTURES[0], str(tmp_path / "e.safetensors"),
         gguf], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout and "Q6_K" in res.stdout and "saved " in res.stdout
    assert L.get_tensor_info(str(tmp_path / "e.safetensors"))["prompt_embeds"] == (
        (1, 16, 64), "F32")

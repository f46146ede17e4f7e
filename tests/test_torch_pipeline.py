"""The PyTorch port's text-to-video slice against the JAX package's
``generate`` on the CPU, in f32: tiny DiT (2 layers, 4 heads x 64), tiny
timestep-conditioned VAE, tiny int8 T5 with the MockTokenizer, the same
PCG32 latents and the same decode noise.  A 13B-shaped variant (2 heads x
128, W4A16 DiT block linears, the Q4_K-form w4 T5, a permanently skipped
block) runs both packages' int4 routes.

Tolerances: final latents MSE < 1e-3, video PSNR > 35 dB."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import pipeline as JP
from candle_video_tpu.models.ltx_video import t5 as JT5
from candle_video_tpu.models.ltx_video import transformer as JTF
from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video.configs import LtxFullConfig, LtxInferenceConfig
from candle_video_tpu.models.ltx_video.scheduler import FlowMatchEulerSchedulerConfig
from candle_video_tpu.models.ltx_video.vae_init import init_vae_params
from candle_video_tpu.ops.pallas.int4_weight_matmul import quantize_int4_blockwise
from candle_video_tpu.ops.pallas.int8_weight_matmul import quantize_int8_blockwise
from candle_video_tpu.utils.tokenizer import MockTokenizer
from candle_video_tpu_torch.models.ltx_video import configs as PC
from candle_video_tpu_torch.models.ltx_video import convert as PCV
from candle_video_tpu_torch import cli as PCLI
from candle_video_tpu_torch.models.ltx_video import pipeline as PP
from candle_video_tpu_torch.ops.quant_linear import Int4Linear

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TF_CFG = dict(in_channels=8, out_channels=8, num_attention_heads=4,
              attention_head_dim=64, cross_attention_dim=256, num_layers=2,
              caption_channels=64)
VAE_CFG = dict(latent_channels=8, block_out_channels=(8, 16, 32),
               decoder_block_out_channels=(8, 16),
               spatiotemporal_scaling=(True, True),
               decoder_spatiotemporal_scaling=(True, True),
               layers_per_block=(1, 1, 2), decoder_layers_per_block=(1, 1, 1),
               patch_size=2, downsample_types=("spatiotemporal", "spatiotemporal"),
               decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
               decoder_causal=False, spatial_compression_ratio=32,
               temporal_compression_ratio=4)
T5_CFG = dict(vocab_size=64, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)
SCHED = dict(shift_terminal=0.1, base_shift=0.95, max_shift=2.05,
             base_image_seq_len=1024, max_image_seq_len=4096)
DISTILLED = dict(guidance_scale=1.0, num_inference_steps=3, stg_scale=0.0,
                 rescaling_scale=1.0, timesteps=(1.0, 0.9094, 0.725),
                 decode_timestep=(0.05,), decode_noise_scale=(0.025,))
GUIDED = dict(guidance_scale=2.0, num_inference_steps=3, stg_scale=1.0,
              rescaling_scale=0.7, skip_block_list=(1,))
# the 13B shape at small width: head dim 128, and a permanent skip without
# STG, as the 13B-distilled preset skips block 42
TF_CFG_13B = dict(TF_CFG, num_attention_heads=2, attention_head_dim=128)
DISTILLED_13B = dict(DISTILLED, skip_block_list=(1,))


def _configs(mod_cfg, inference, tf_cfg=TF_CFG):
    return mod_cfg.LtxFullConfig(
        inference=mod_cfg.LtxInferenceConfig(**inference),
        transformer=mod_cfg.LtxTransformerConfig(**tf_cfg),
        vae=mod_cfg.LtxVaeConfig(**VAE_CFG),
        scheduler=mod_cfg.FlowMatchEulerSchedulerConfig(**SCHED),
    )


def _t5_int8_tree(rng, w4=False):
    """Tiny T5 with int8 ``{w_q, s}`` linears, or the Q4_K-form ``{w4,
    w4_scale, w4_min}`` carry with ``w4``."""
    d, ff = T5_CFG["d_model"], T5_CFG["d_ff"]

    def lin(k, n):
        w = rng.normal(size=(k, n)) * 0.08
        if w4:
            p, sc, mn = quantize_int4_blockwise(w, 32)
            return {"w4": jnp.asarray(p), "w4_scale": jnp.asarray(sc),
                    "w4_min": jnp.asarray(mn)}
        w_q, s = quantize_int8_blockwise(w, 32)
        return {"w_q": jnp.asarray(w_q), "s": jnp.asarray(s)}

    blocks = []
    for i in range(T5_CFG["num_layers"]):
        blk = {"attn": {n: lin(d, d) for n in ("q", "k", "v", "o")},
               "attn_norm": {"weight": jnp.ones((d,), jnp.float32)},
               "ffn": {"wi_0": lin(d, ff), "wi_1": lin(d, ff), "wo": lin(ff, d)},
               "ffn_norm": {"weight": jnp.ones((d,), jnp.float32)}}
        if i == 0:
            blk["attn"]["relative_attention_bias"] = jnp.asarray(
                rng.normal(size=(32, T5_CFG["num_heads"])), jnp.float32)
        blocks.append(blk)
    return {"embedding": jnp.asarray(rng.normal(size=(64, d)), jnp.float32),
            "blocks": blocks, "final_norm": {"weight": jnp.ones((d,), jnp.float32)}}


@pytest.fixture(scope="module")
def jax_trees():
    rng = np.random.default_rng(0)
    tparams = JTF.init_params(jax.random.PRNGKey(0), JTF.LtxTransformerConfig(**TF_CFG),
                              dtype=jnp.float32)
    vparams = init_vae_params(jax.random.PRNGKey(1), JV.LtxVaeConfig(**VAE_CFG),
                              dtype=jnp.float32)
    return tparams, vparams, _t5_int8_tree(rng)


@pytest.fixture(scope="module")
def jax_trees_13b_w4(jax_trees):
    tparams = JTF.init_params(jax.random.PRNGKey(2), JTF.LtxTransformerConfig(**TF_CFG_13B),
                              dtype=jnp.float32)
    qparams = JTF.quantize_transformer_params_w4(tparams, qblock=32, scale_dtype="bfloat16")
    return qparams, jax_trees[1], _t5_int8_tree(np.random.default_rng(3), w4=True)


def _pipelines(jax_trees, inference, tf_cfg=TF_CFG):
    tparams, vparams, t5params = jax_trees
    jcfg = LtxFullConfig(
        inference=LtxInferenceConfig(**inference),
        transformer=JTF.LtxTransformerConfig(**tf_cfg),
        vae=JV.LtxVaeConfig(**VAE_CFG),
        scheduler=FlowMatchEulerSchedulerConfig(**SCHED))
    tok = MockTokenizer(vocab_size=64, model_max_length=16)
    jpipe = JP.LtxPipeline(config=jcfg, transformer_params=tparams, vae_params=vparams,
                           t5_params=t5params, t5_config=JT5.T5Config(**T5_CFG),
                           tokenizer=tok)
    pcfg = _configs(PC, inference, tf_cfg)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    ppipe = PP.LtxPipeline(
        config=pcfg,
        transformer=PCV.transformer_from_jax(to_np(tparams), pcfg.transformer),
        vae=PCV.vae_decoder_from_jax(to_np(vparams), pcfg.vae),
        t5=PCV.t5_from_jax(to_np(t5params), PC.T5Config(**T5_CFG)),
        t5_config=PC.T5Config(**T5_CFG), tokenizer=tok)
    return jpipe, ppipe


@pytest.mark.parametrize("inference", [DISTILLED, GUIDED], ids=["distilled", "cfg_stg"])
def test_generate_matches_jax(jax_trees, inference):
    _check_generate(*_pipelines(jax_trees, inference))


def test_generate_13b_shaped_w4_matches_jax(jax_trees_13b_w4):
    jpipe, ppipe = _pipelines(jax_trees_13b_w4, DISTILLED_13B, TF_CFG_13B)
    assert isinstance(ppipe.transformer.blocks[0].attn2.to_k, Int4Linear)
    assert isinstance(ppipe.t5.blocks[1].wo, Int4Linear)
    _check_generate(jpipe, ppipe)


def _check_generate(jpipe, ppipe):
    kw = dict(prompt="a cat walking on grass", height=64, width=96, num_frames=9,
              seed=5, max_sequence_length=16)
    lat_j = np.asarray(JP.generate(jpipe, output_type="latent", **kw))
    lat_p = PP.generate(ppipe, output_type="latent", **kw).numpy()
    assert lat_p.shape == lat_j.shape == (1, 3 * 2 * 3, 8)
    assert float(np.mean((lat_p - lat_j) ** 2)) < 1e-3

    noise = np.random.default_rng(9).normal(size=(1, 8, 3, 2, 3)).astype(np.float32)
    vid_j = np.asarray(JP.generate(jpipe, decode_noise=jnp.asarray(noise),
                                   vae_auto_decode=False, **kw))
    vid_p = PP.generate(ppipe, decode_noise=torch.from_numpy(noise), **kw).numpy()
    assert vid_p.shape == vid_j.shape == (1, 3, 9, 16, 24)  # tiny VAE: 8x spatial
    assert vid_p.min() >= 0.0 and vid_p.max() <= 255.0
    mse = float(np.mean((vid_p.astype(np.float64) - vid_j) ** 2))
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    assert psnr > 35.0, psnr


@pytest.mark.parametrize("mode", [dict(vae_tail_stream_chunks=2),
                                  dict(vae_full_stream_chunks=2)], ids=["tail", "full"])
def test_generate_streamed_decode_equals_dense(jax_trees, mode):
    """generate() with an exact streamed decode equals its dense decode up to
    op-order noise on the [0, 255] scale (atol 1e-3, as the JAX package's
    own check), and the mode it ran is the one asked for."""
    _, ppipe = _pipelines(jax_trees, DISTILLED)
    # 15 latent frames: two full-stream chunks clear the pipeline fill of 8
    kw = dict(prompt="a cat playing piano", height=64, width=96, num_frames=57, seed=3,
              max_sequence_length=16)
    dense = PP.generate(ppipe, **kw).numpy()
    times = {}
    streamed = PP.generate(ppipe, stage_times=times, **mode, **kw).numpy()
    assert streamed.shape == dense.shape == (1, 3, 57, 16, 24)
    np.testing.assert_allclose(streamed, dense, atol=1e-3, rtol=0)
    used = {k: v for k, v in times["decode_mode"].items() if v}
    assert used == {k.removeprefix("vae_"): v for k, v in mode.items()}


def test_generate_refuses_an_undecodable_clip_before_the_denoise(jax_trees, monkeypatch):
    """With almost no free memory the decode-mode ladder reaches the full
    stream, which 33 frames (9 latent frames) cannot feed: generate() raises
    before its first denoise step, not after the denoise."""
    from candle_video_tpu_torch.models.ltx_video import vae as PV

    _, ppipe = _pipelines(jax_trees, DISTILLED)
    monkeypatch.setattr(PV, "_device_free_bytes", lambda device: 1)
    steps = []
    kw = dict(prompt="a cat", height=64, width=96, num_frames=33, seed=3,
              max_sequence_length=16, step_callback=lambda *a: steps.append(a))
    with pytest.raises(ValueError, match="full stream needs"):
        PP.generate(ppipe, **kw)
    assert steps == []
    # a mode asked for is not resolved
    video = PP.generate(ppipe, vae_tail_stream_chunks=2, **kw)
    assert video.shape == (1, 3, 33, 16, 24) and len(steps) > 0


def test_pack_unpack_coords_and_postprocess(rng):
    x = rng.normal(size=(2, 8, 4, 6, 6)).astype(np.float32)
    packed = PP.pack_latents(torch.from_numpy(x), 2, 2)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JP.pack_latents(jnp.asarray(x), 2, 2)))
    back = PP.unpack_latents(packed, 2, 3, 3, 2, 2)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(PP.build_video_coords(3, 2, 2, 25.0),
                                  JP.build_video_coords(3, 2, 2, 25.0))
    v = rng.normal(size=(1, 3, 2, 4, 4)).astype(np.float32) * 2
    np.testing.assert_allclose(PP.postprocess_video(torch.from_numpy(v)).numpy(),
                               np.asarray(JP.postprocess_video(jnp.asarray(v))), atol=1e-4)
    cfgn = rng.normal(size=(2, 30, 8)).astype(np.float32)
    text = rng.normal(size=(2, 30, 8)).astype(np.float32)
    np.testing.assert_allclose(
        PP.rescale_noise_cfg(torch.from_numpy(cfgn), torch.from_numpy(text), 0.7).numpy(),
        np.asarray(JP.rescale_noise_cfg(jnp.asarray(cfgn), jnp.asarray(text), 0.7)),
        atol=1e-5)


@pytest.mark.parametrize("seed,inc,shape", [(42, 0, (1, 8, 3, 2, 3)), (7, 3, (5,)),
                                           (2**40 + 1, 0, (2, 3, 7))])
def test_port_pcg32_matches_jax_package(seed, inc, shape):
    """The port's own PCG32 copy draws the JAX package's bits: the u32
    stream and the Box-Muller normals (odd counts included)."""
    from candle_video_tpu.utils.rng import Pcg32 as JPcg32
    from candle_video_tpu_torch.utils.rng import Pcg32

    got, want = Pcg32(seed, inc), JPcg32(seed, inc)
    assert [got.next_u32() for _ in range(9)] == [want.next_u32() for _ in range(9)]
    np.testing.assert_array_equal(got.randn(shape), want.randn(shape))
    np.testing.assert_array_equal(Pcg32(seed, inc).randn(shape), JPcg32(seed, inc).randn(shape))


def test_check_inputs_rejects():
    with pytest.raises(ValueError):
        PP.check_inputs(100, 96, "p", None)
    with pytest.raises(ValueError):
        PP.check_inputs(64, 96, None, None)
    with pytest.raises(ValueError):
        PP.check_inputs(64, 96, None, torch.zeros(1, 4, 8))


@pytest.mark.parametrize("which", ["embeds", "masks"])
def test_check_inputs_refuses_mismatched_negative_rows_as_jax(jax_trees, which):
    """The two shape refusals of the JAX ``check_inputs``, with its
    messages, in its argument order; ``generate`` refuses before encoding."""
    emb, mask = torch.zeros(2, 4, 8), torch.ones(2, 4)
    kw = dict(prompt_embeds=emb, prompt_attention_mask=mask,
              negative_prompt_embeds=torch.zeros(1, 4, 8) if which == "embeds" else emb,
              negative_prompt_attention_mask=torch.ones(2, 5) if which == "masks" else mask)
    with pytest.raises(ValueError) as want:
        JP.check_inputs(64, 96, None, **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
    with pytest.raises(ValueError) as got:
        PP.check_inputs(64, 96, None, **kw)
    assert str(got.value) == str(want.value) and "same shape" in str(got.value)
    with pytest.raises(ValueError, match="same shape"):
        PP.generate(_pipelines(jax_trees, GUIDED)[1], height=64, width=96, **kw)
    pos = [kw[k] for k in ("prompt_embeds", "negative_prompt_embeds",
                           "prompt_attention_mask", "negative_prompt_attention_mask")]
    with pytest.raises(ValueError, match="same shape"):
        PP.check_inputs(64, 96, None, *pos)


STOCHASTIC = dict(DISTILLED, stochastic_sampling=True, decode_noise_scale=None,
                  decode_timestep=None)


def _jax_normal(seed, shape, key=None):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed) if key is None else key,
                                        shape, jnp.float32))


@pytest.mark.parametrize("case", ["decode_noise", "stochastic", "jax_latents"])
def test_generate_seeded_draws_match_jax_without_injection(jax_trees, monkeypatch, case):
    """No draw injected: the port's own draws for one seed are the JAX
    package's (decode noise ``PRNGKey(seed + 2)``; the stochastic chain from
    ``PRNGKey(seed + 1)``; ``use_pcg_rng=False`` latents ``PRNGKey(seed)``)
    within atol 1e-5, and the request matches JAX ``generate`` run the same
    way (the tolerances of ``_check_generate``)."""
    from candle_video_tpu_torch.models.ltx_video import scheduler as PS

    inference = STOCHASTIC if case == "stochastic" else DISTILLED
    jpipe, ppipe = _pipelines(jax_trees, inference)
    seed = 11
    kw = dict(prompt="a cat walking on grass", height=64, width=96, num_frames=9,
              seed=seed, max_sequence_length=16)
    if case == "jax_latents":
        kw["use_pcg_rng"] = False
    drawn = {"noise": [], "latents": [], "decode": []}
    step, loop, prep = PS.step, PP.denoise_loop, PP.prepare_decode
    monkeypatch.setattr(PS, "step", lambda *a, **k: drawn["noise"].append(k.get("noise"))
                        or step(*a, **k))
    monkeypatch.setattr(PP, "denoise_loop", lambda tr, lat, *a, **k:
                        drawn["latents"].append(lat.clone()) or loop(tr, lat, *a, **k))
    monkeypatch.setattr(PP, "prepare_decode", lambda final, mean, std, noise, *a, **k:
                        drawn["decode"].append(noise) or prep(final, mean, std, noise, *a, **k))
    vid_p = PP.generate(ppipe, **kw).numpy()
    vid_j = np.asarray(JP.generate(jpipe, vae_auto_decode=False, **kw))

    shape = (1, 8, 3, 2, 3)
    np.testing.assert_allclose(drawn["decode"][0].numpy(), _jax_normal(seed + 2, shape),
                               atol=1e-5, rtol=0)
    if case == "stochastic":
        key = jax.random.PRNGKey(seed + 1)
        assert len(drawn["noise"]) == 3
        for noise in drawn["noise"]:
            key, sub = jax.random.split(key)
            np.testing.assert_allclose(noise.numpy(), _jax_normal(None, (1, 18, 8), sub),
                                       atol=1e-5, rtol=0)
    elif case == "jax_latents":
        want = JP.pack_latents(jnp.asarray(_jax_normal(seed, shape)), 1, 1)
        np.testing.assert_allclose(drawn["latents"][0].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
    assert vid_p.shape == vid_j.shape == (1, 3, 9, 16, 24)
    mse = float(np.mean((vid_p.astype(np.float64) - vid_j) ** 2))
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 35.0, mse
    lat_p = PP.generate(ppipe, output_type="latent", **kw).numpy()
    lat_j = np.asarray(JP.generate(jpipe, output_type="latent", **kw))
    assert float(np.mean((lat_p - lat_j) ** 2)) < 1e-3


def test_cli_rejects_both_dit_tiers():
    with pytest.raises(SystemExit, match="mutually exclusive"):
        PCLI.main(["--dit-int8", "--dit-int4", "--device", "cpu"])
    with pytest.raises(ValueError, match="dit_quant"):
        PCLI.build_random_pipeline("0.9.8-13b-distilled", "cpu", dit_quant="w2")


def test_port_generate_never_imports_jax(tmp_path):
    script = textwrap.dedent("""
        import sys
        sys.modules["candle_video_tpu"] = None  # the JAX package cannot be imported
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from candle_video_tpu_torch.utils.tokenizer import MockTokenizer
        from candle_video_tpu_torch.models.ltx_video import configs as C
        from candle_video_tpu_torch.models.ltx_video import pipeline as P
        from candle_video_tpu_torch.models.ltx_video import t5 as T5
        from candle_video_tpu_torch.models.ltx_video import transformer as TF
        from candle_video_tpu_torch.models.ltx_video import vae as V
        import candle_video_tpu_torch.cli
        cfg = C.LtxFullConfig(
            inference=C.LtxInferenceConfig(guidance_scale=1.0, num_inference_steps=2,
                                           stg_scale=0.0, timesteps=(1.0, 0.7),
                                           decode_timestep=(0.05,),
                                           decode_noise_scale=(0.025,)),
            transformer=C.LtxTransformerConfig(**%r),
            vae=C.LtxVaeConfig(**%r),
            scheduler=C.FlowMatchEulerSchedulerConfig())
        t5cfg = C.T5Config(**%r)
        pipe = P.LtxPipeline(cfg, TF.init_random(cfg.transformer, "cpu", torch.float32),
                             V.init_random(cfg.vae, "cpu", torch.float32),
                             T5.init_random_int8(t5cfg, "cpu", torch.float32, 0.01),
                             t5cfg, MockTokenizer(vocab_size=64, model_max_length=16))
        out = P.generate(pipe, prompt="x", height=64, width=64, num_frames=5,
                         max_sequence_length=16)
        assert out.shape == (1, 3, 5, 16, 16) and torch.isfinite(out).all()

        # the W4 tiers: int4 DiT block linears, T5 from a Q4_K / Q8_0 GGUF file
        from candle_video_tpu_torch.quant import dequant_np as DQ
        from candle_video_tpu_torch.quant.gguf import write_gguf
        rng = np.random.default_rng(0)
        d, ff = t5cfg.d_model, t5cfg.d_ff
        tensors = {}
        def add(name, shape, tid=None):
            x = rng.normal(size=shape).astype(np.float32) * 0.1
            tensors[name] = ((DQ.GGML_F32, shape, x.view(np.uint8).reshape(-1)) if tid is None
                             else (tid, shape, {DQ.GGML_Q4_K: DQ.quantize_q4_k,
                                                DQ.GGML_Q8_0: DQ.quantize_q8_0}[tid](x)))
        add("token_embd.weight", (t5cfg.vocab_size, d), DQ.GGML_Q8_0)
        add("enc.output_norm.weight", (d,))
        for i in range(t5cfg.num_layers):
            for nm, shape in [("attn_q", (d, d)), ("attn_k", (d, d)), ("attn_v", (d, d)),
                              ("attn_o", (d, d)), ("ffn_gate", (ff, d)), ("ffn_up", (ff, d)),
                              ("ffn_down", (d, ff))]:
                add(f"enc.blk.{i}.{nm}.weight", shape,
                    DQ.GGML_Q8_0 if nm == "ffn_down" else DQ.GGML_Q4_K)
            add(f"enc.blk.{i}.attn_norm.weight", (d,))
            add(f"enc.blk.{i}.ffn_norm.weight", (d,))
        add("enc.blk.0.attn_rel_b.weight", (32, t5cfg.num_heads))
        path = sys.argv[1] + "/t5.gguf"
        write_gguf(path, tensors, {"general.architecture": "t5"})
        pipe = P.LtxPipeline(cfg, TF.init_random_w4(cfg.transformer, "cpu", torch.float32),
                             V.init_random(cfg.vae, "cpu", torch.float32),
                             T5.t5_from_gguf(path, t5cfg, "cpu", torch.float32,
                                             keep_quantized=True),
                             t5cfg, MockTokenizer(vocab_size=64, model_max_length=16))
        out = P.generate(pipe, prompt="x", height=64, width=64, num_frames=5,
                         max_sequence_length=16)
        assert out.shape == (1, 3, 5, 16, 16) and torch.isfinite(out).all()
        assert type(pipe.t5.blocks[0].q).__name__ == "Int4Linear"
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        assert sys.modules["candle_video_tpu"] is None
        assert not [m for m in sys.modules if m.startswith("candle_video_tpu.")]
        print("NO_JAX_OK")
    """) % (TF_CFG, VAE_CFG, T5_CFG)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout


# ---------------------------------------------------------------------------
# the cooperative interrupt and the prompt-embedding cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_interrupt_before_step_k_equals_k_steps_of_jax(jax_trees, k):
    """Set from the step callback after step k, ``interrupt`` stops both
    loops before step k + 1: the latents are those of k steps of JAX's
    step-wise loop, and the callback saw k steps."""
    jpipe, ppipe = _pipelines(jax_trees, DISTILLED)
    seen = {"jax": [], "port": []}

    def stopper(pipe, side):
        def cb(i, n, lat):
            seen[side].append(i)
            if i == k - 1:
                pipe.interrupt = True
        return cb

    kw = dict(prompt="a cat walking on grass", height=64, width=96, num_frames=9, seed=5,
              max_sequence_length=16, output_type="latent")
    lat_j = np.asarray(JP.generate(jpipe, step_callback=stopper(jpipe, "jax"), **kw))
    lat_p = PP.generate(ppipe, step_callback=stopper(ppipe, "port"), **kw).numpy()
    assert seen["port"] == seen["jax"] == list(range(k))
    assert float(np.mean((lat_p - lat_j) ** 2)) < 1e-3
    full = PP.generate(_pipelines(jax_trees, DISTILLED)[1], **kw).numpy()
    assert float(np.mean((full - lat_p) ** 2)) > 1e-6  # the stop changed the result


def test_encode_prompt_caches_sixteen_keys_first_in_first_out(jax_trees):
    _, ppipe = _pipelines(jax_trees, DISTILLED)
    calls = []
    encode = ppipe.tokenizer.encode_batch

    class Counting:
        def encode_batch(self, prompts, max_length=None):
            calls.append(tuple(prompts))
            return encode(prompts, max_length)

    ppipe.tokenizer = Counting()
    first = ppipe.encode_prompt(["a cat"], 16)
    assert ppipe.encode_prompt(["a cat"], 16) is first and len(calls) == 1
    ppipe.encode_prompt(["a cat"], 8)  # another length is another key
    assert len(calls) == 2
    for i in range(14):
        ppipe.encode_prompt([f"prompt {i}"], 16)
    assert len(ppipe._embed_cache) == ppipe.embedding_cache_size == 16
    assert ppipe.encode_prompt(["a cat"], 16) is first  # still cached: 16 keys
    ppipe.encode_prompt(["the seventeenth"], 16)  # evicts the oldest key
    n = len(calls)
    again = ppipe.encode_prompt(["a cat"], 16)
    assert len(calls) == n + 1 and again is not first
    assert torch.equal(again[0], first[0])
    ppipe.embedding_cache_size = 0  # off: every call encodes
    ppipe._embed_cache.clear()
    ppipe.encode_prompt(["a cat"], 16)
    ppipe.encode_prompt(["a cat"], 16)
    assert len(calls) == n + 3 and not ppipe._embed_cache


# ---------------------------------------------------------------------------
# the CLI at a tiny config
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_cli(monkeypatch, tmp_path):
    """The CLI with the tiny configs patched in, an official single file and
    a diffusers directory of the same random weights, and a HuggingFace T5
    directory."""
    from candle_video_tpu_torch.models.ltx_video import loader as PL
    from candle_video_tpu_torch.models.ltx_video import t5 as PT5
    from candle_video_tpu_torch.models.ltx_video import transformer as PTF
    from candle_video_tpu_torch.models.ltx_video import vae as PV
    from candle_video_tpu_torch.models.ltx_video import weight_format as PW

    cfg = _configs(PC, DISTILLED)
    t5cfg = PC.T5Config(**T5_CFG)
    monkeypatch.setattr(PCLI, "get_config_by_version", lambda version: cfg)
    monkeypatch.setattr(PCLI, "t5_xxl", lambda: t5cfg)
    gen = torch.Generator().manual_seed(0)
    dit = PTF.init_random(cfg.transformer, "cpu", torch.float32, gen)
    dec = PV.init_random(cfg.vae, "cpu", torch.float32, gen)
    dit_sd, vae_sd = PL.transformer_state_dict(dit), PL.vae_decoder_state_dict(dec)
    official = tmp_path / "ltxv-tiny.safetensors"
    PL.save_safetensors({**{PW.officialize_transformer_key(k): v for k, v in dit_sd.items()},
                         **{PW.officialize_vae_key(k): v for k, v in vae_sd.items()}},
                        str(official))
    diffusers = tmp_path / "diffusers"
    for sub, sd in (("transformer", dit_sd), ("vae", vae_sd)):
        (diffusers / sub).mkdir(parents=True)
        PL.save_safetensors(sd, str(diffusers / sub / "diffusion_pytorch_model.safetensors"))
    t5 = PCV.t5_from_jax(jax.tree.map(np.asarray, _t5_int8_tree(np.random.default_rng(1))),
                         t5cfg)
    hf = {"shared.weight": t5.embedding, "encoder.final_layer_norm.weight": t5.final_norm,
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": t5.rel_bias}
    for i, blk in enumerate(t5.blocks):
        for name, hf_name in PT5.HF_LINEARS.items():
            lin = getattr(blk, name)
            w = lin.w_q.float() * lin.s.repeat_interleave(lin.w_q.shape[0] // lin.s.shape[0], 0)
            hf[f"encoder.block.{i}.{hf_name}.weight"] = w.t().contiguous()
        hf[f"encoder.block.{i}.layer.0.layer_norm.weight"] = blk.attn_norm
        hf[f"encoder.block.{i}.layer.1.layer_norm.weight"] = blk.ffn_norm
    (tmp_path / "text_encoder").mkdir()
    PL.save_safetensors(hf, str(tmp_path / "text_encoder" / "model.safetensors"))
    base = ["--device", "cpu", "--dtype", "float32", "--height", "64", "--width", "64",
            "--num-frames", "5", "--max-sequence-length", "16", "--seed", "3"]
    return dict(cfg=cfg, dit=dit, dec=dec, official=str(official), diffusers=str(diffusers),
                t5_dir=str(tmp_path / "text_encoder"), out=tmp_path / "out", base=base)


def _cli_latents(tiny, *extra):
    from candle_video_tpu_torch.models.ltx_video import loader as PL

    out = tiny["out"] / str(len(list(tiny["out"].parent.glob("out*"))))
    assert PCLI.main([*tiny["base"], "--output-dir", str(out), *extra]) == 0
    return PL.load_safetensors(str(out / "latents.safetensors"))["latents"]


def _random_embeds(cfg):
    """The CLI's embeddings without a T5 (the JAX CLI's smoke mode)."""
    shape = (1, 16, cfg.transformer.caption_channels)
    emb = torch.from_numpy(np.random.default_rng(0).normal(size=shape) * 0.02).float()
    return dict(prompt_embeds=emb, prompt_attention_mask=torch.ones(shape[:2]))


@pytest.mark.parametrize("tier", [None, "w8", "w4"])
def test_cli_runs_an_official_file_as_the_in_memory_pipeline(tiny_cli, tier):
    """``--weights-path`` on the official file (and on the diffusers
    directory for the dense tier) gives the latents of ``generate`` on the
    in-memory modules, quantized as the tier does."""
    from candle_video_tpu_torch.models.ltx_video import transformer as PTF

    import copy

    dit = copy.deepcopy(tiny_cli["dit"])
    flag = []
    if tier == "w8":
        PTF.quantize_transformer_w8(dit)
        flag = ["--dit-int8"]
    elif tier == "w4":
        PTF.quantize_transformer_w4(dit)
        flag = ["--dit-int4"]
    pipe = PP.LtxPipeline(tiny_cli["cfg"], dit, tiny_cli["dec"])
    want = PP.generate(pipe, height=64, width=64, num_frames=5, seed=3,
                       max_sequence_length=16, output_type="latent",
                       **_random_embeds(tiny_cli["cfg"]))
    got = _cli_latents(tiny_cli, "--weights-path", tiny_cli["official"], "--output-type",
                       "latent", *flag)
    assert got.shape == want.shape and torch.equal(got, want)
    if tier is None:
        got = _cli_latents(tiny_cli, "--weights-path", tiny_cli["diffusers"],
                           "--output-type", "latent")
        assert torch.equal(got, want)


def test_cli_embeddings_initial_and_final_latents_round_trip(tiny_cli, tmp_path):
    """``--embeddings-file`` and ``--initial-latents-file`` feed ``generate``;
    ``--save-final-latents`` writes its final latents beside the video, and
    they equal the latent output of the same request."""
    from candle_video_tpu_torch.models.ltx_video import loader as PL

    g = torch.Generator().manual_seed(7)
    emb = dict(prompt_embeds=torch.randn(1, 16, 64, generator=g) * 0.1,
               prompt_attention_mask=torch.ones(1, 16))
    emb["prompt_attention_mask"][0, 12:] = 0
    init = torch.randn(1, 2 * 2 * 2, 8, generator=g)
    PL.save_safetensors(emb, str(tmp_path / "emb.safetensors"))
    PL.save_safetensors({"latents": init}, str(tmp_path / "init.safetensors"))
    files = ["--weights-path", tiny_cli["official"], "--embeddings-file",
             str(tmp_path / "emb.safetensors"), "--initial-latents-file",
             str(tmp_path / "init.safetensors")]
    pipe = PP.LtxPipeline(tiny_cli["cfg"], tiny_cli["dit"], tiny_cli["dec"])
    want = PP.generate(pipe, height=64, width=64, num_frames=5, seed=3, latents=init,
                       output_type="latent", **emb)
    final = tmp_path / "final.safetensors"
    out = tmp_path / "video_out"
    assert PCLI.main([*tiny_cli["base"], *files, "--output-dir", str(out),
                      "--save-final-latents", str(final)]) == 0
    got = PL.load_safetensors(str(final))["latents"]
    assert torch.equal(got, want)
    assert np.load(out / "video_uint8.npy").shape == (5, 16, 16, 3)
    assert torch.equal(_cli_latents(tiny_cli, *files, "--output-type", "latent"), want)


def test_cli_progress_interrupt_stops_before_the_next_step(tiny_cli, tmp_path, monkeypatch):
    """Under ``--progress`` Ctrl-C sets ``pipe.interrupt``: raised before the
    first step, the latents are the initial ones; the previous handler is
    restored after."""
    from candle_video_tpu_torch.models.ltx_video import loader as PL

    handlers = []
    monkeypatch.setattr(PCLI.signal, "signal",
                        lambda sig, handler: handlers.append((sig, handler)) or "previous")
    generate = PCLI.generate

    def ctrl_c_first(pipe, **kw):
        handlers[0][1](PCLI.signal.SIGINT, None)
        return generate(pipe, **kw)

    monkeypatch.setattr(PCLI, "generate", ctrl_c_first)
    init = torch.randn(1, 8, 8, generator=torch.Generator().manual_seed(2))
    PL.save_safetensors({"latents": init}, str(tmp_path / "init.safetensors"))
    got = _cli_latents(tiny_cli, "--weights-path", tiny_cli["official"], "--progress",
                       "--initial-latents-file", str(tmp_path / "init.safetensors"),
                       "--output-type", "latent")
    assert torch.equal(got, init)
    assert [h[0] for h in handlers] == [PCLI.signal.SIGINT] * 2
    assert handlers[1][1] == "previous"


def test_cli_load_pipeline_takes_t5_dir_and_warns_without_a_t5(tiny_cli, capsys):
    args = PCLI.build_parser().parse_args([*tiny_cli["base"], "--weights-path",
                                           tiny_cli["official"], "--t5-dir",
                                           tiny_cli["t5_dir"]])
    pipe = PCLI.load_pipeline(args, torch.device("cpu"), torch.float32)
    assert isinstance(pipe.t5.blocks[0].q, torch.nn.Linear)
    pipe.tokenizer = MockTokenizer(vocab_size=64, model_max_length=16)  # the tiny vocabulary
    emb, mask = pipe.encode_prompt(["a cat"], 16)
    assert emb.shape == (1, 16, 64) and torch.isfinite(emb).all()
    assert "Loading T5 dir" in capsys.readouterr().out
    _cli_latents(tiny_cli, "--weights-path", tiny_cli["official"], "--output-type", "latent")
    assert "WARNING: no T5 weights given" in capsys.readouterr().out


def test_cli_parser_takes_the_jax_flags():
    args = PCLI.build_parser().parse_args(
        ["--weights-path", "w", "--t5-dir", "t", "--tokenizer", "tok.json", "--frame-rate",
         "24", "--guidance-rescale", "0.5", "--stg-scale", "4", "--skip-block-list", "11",
         "25", "--num-videos-per-prompt", "2", "--max-sequence-length", "64",
         "--embeddings-file", "e", "--initial-latents-file", "i", "--save-final-latents",
         "f", "--save-frames"])
    assert (args.weights_path, args.t5_dir, args.tokenizer, args.frame_rate) == (
        "w", "t", "tok.json", 24.0)
    assert (args.guidance_rescale, args.stg_scale, args.skip_block_list) == (0.5, 4.0, [11, 25])
    assert (args.num_videos_per_prompt, args.max_sequence_length) == (2, 64)
    assert (args.embeddings_file, args.initial_latents_file, args.save_final_latents,
            args.save_frames) == ("e", "i", "f", True)

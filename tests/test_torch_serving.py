"""The PyTorch port's serving runtime (``candle_video_tpu_torch/serving.py``)
against the JAX package's (``candle_video_tpu/serving.py``) on the CPU, on
the same tiny weights carried over by ``convert.py``: each test of
``tests/test_serving.py`` has its counterpart here.

Tolerances: a batched request equals the same request served alone within
1e-5 (as the JAX tests hold the JAX server); the port's result equals the
JAX server's for the same request within ``PARITY`` (the f32 CPU runs of two
packages differ by summation order only); the rows' draws are bit-equal.
Every ``queue.get`` has a timeout and every started server is stopped in a
``finally``."""

import argparse
import dataclasses
import io
import time
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu import serving as JS
from candle_video_tpu.models.ltx_video import t5 as JT5
from candle_video_tpu.models.ltx_video import transformer as JTF
from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video.configs import LtxFullConfig, LtxInferenceConfig
from candle_video_tpu.models.ltx_video.pipeline import LtxPipeline as JPipeline
from candle_video_tpu.models.ltx_video.scheduler import FlowMatchEulerSchedulerConfig
from candle_video_tpu.models.ltx_video.vae_init import init_vae_params
from candle_video_tpu.utils.tokenizer import MockTokenizer
from candle_video_tpu_torch import cli as PCLI
from candle_video_tpu_torch import serving as PS
from candle_video_tpu_torch.models.ltx_video import configs as PC
from candle_video_tpu_torch.models.ltx_video import convert as PCV
from candle_video_tpu_torch.models.ltx_video import pipeline as PP

torch.set_num_threads(2)

GET_TIMEOUT = 300  # seconds a result may take; a hung worker fails the test instead
PARITY = dict(atol=1e-4, rtol=1e-4)  # port vs JAX on [B, S, C] latents and [0, 255] video
TF_CFG = dict(in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=12,
              cross_attention_dim=24, num_layers=2, caption_channels=16)
VAE_CFG = dict(in_channels=3, out_channels=3, latent_channels=8,
               block_out_channels=(8, 16, 32), decoder_block_out_channels=(8, 16),
               spatiotemporal_scaling=(True, True),
               decoder_spatiotemporal_scaling=(True, True),
               layers_per_block=(1, 1, 2), decoder_layers_per_block=(1, 1, 1),
               patch_size=2, patch_size_t=1,
               downsample_types=("spatiotemporal", "spatiotemporal"),
               decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
               timestep_conditioning=True, decoder_causal=False,
               spatial_compression_ratio=32, temporal_compression_ratio=4)
T5_CFG = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=1, num_heads=4)
SCHED = dict(shift_terminal=0.1)
GUIDED = dict(guidance_scale=2.0, num_inference_steps=2, stg_scale=0.0, skip_block_list=())
TENSOR = dict(guidance_scale=1.0, num_inference_steps=2, stg_scale=0.0, skip_block_list=(),
              decode_timestep=(0.05,), decode_noise_scale=(0.025,))
SMALL, BIG = (64, 64, 9, 2), (96, 96, 9, 2)


def _t5_tree(rng):
    def lin(k, n):
        return {"weight": jnp.asarray(rng.normal(size=(k, n)) * 0.05, jnp.float32)}

    return {
        "embedding": jnp.asarray(rng.normal(size=(64, 16)) * 0.05, jnp.float32),
        "blocks": [{
            "attn": {"q": lin(16, 16), "k": lin(16, 16), "v": lin(16, 16), "o": lin(16, 16),
                     "relative_attention_bias": jnp.asarray(rng.normal(size=(32, 4)),
                                                            jnp.float32)},
            "attn_norm": {"weight": jnp.ones((16,), jnp.float32)},
            "ffn": {"wi_0": lin(16, 32), "wi_1": lin(16, 32), "wo": lin(32, 16)},
            "ffn_norm": {"weight": jnp.ones((16,), jnp.float32)},
        }],
        "final_norm": {"weight": jnp.ones((16,), jnp.float32)},
    }


def _pair(inference, with_vae):
    """The JAX pipeline and the port's on the same tiny weights: the DiT
    alone (latent output), or with a timestep-conditioned VAE, a tiny T5 and
    the mock tokenizer (string prompts, tensor output)."""
    vae_cfg = VAE_CFG if with_vae else {}
    jcfg = LtxFullConfig(inference=LtxInferenceConfig(**inference),
                         transformer=JTF.LtxTransformerConfig(**TF_CFG),
                         vae=JV.LtxVaeConfig(**vae_cfg),
                         scheduler=FlowMatchEulerSchedulerConfig(**SCHED))
    pcfg = PC.LtxFullConfig(inference=PC.LtxInferenceConfig(**inference),
                            transformer=PC.LtxTransformerConfig(**TF_CFG),
                            vae=PC.LtxVaeConfig(**vae_cfg),
                            scheduler=PC.FlowMatchEulerSchedulerConfig(**SCHED))
    tparams = JTF.init_params(jax.random.PRNGKey(0), jcfg.transformer, dtype=jnp.float32)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    ptf = PCV.transformer_from_jax(to_np(tparams), pcfg.transformer, device="cpu")
    if not with_vae:
        return (JPipeline(config=jcfg, transformer_params=tparams),
                PP.LtxPipeline(config=pcfg, transformer=ptf))
    vparams = init_vae_params(jax.random.PRNGKey(1), jcfg.vae, dtype=jnp.float32)
    t5 = _t5_tree(np.random.default_rng(3))
    tok = MockTokenizer(vocab_size=64, model_max_length=8)
    jpipe = JPipeline(config=jcfg, transformer_params=tparams, vae_params=vparams,
                      t5_params=t5, t5_config=JT5.T5Config(**T5_CFG), tokenizer=tok)
    ppipe = PP.LtxPipeline(
        config=pcfg, transformer=ptf,
        vae=PCV.vae_decoder_from_jax(to_np(vparams), pcfg.vae, device="cpu"),
        t5=PCV.t5_from_jax(to_np(t5), PC.T5Config(**T5_CFG), device="cpu"),
        t5_config=PC.T5Config(**T5_CFG), tokenizer=tok)
    return jpipe, ppipe


@pytest.fixture(scope="module")
def pipes():
    return _pair(GUIDED, with_vae=False)


@pytest.fixture(scope="module")
def pipes_vae():
    return _pair(TENSOR, with_vae=True)


def _embeds(seed):
    return np.asarray(np.random.default_rng(seed).normal(size=(1, 8, 16)) * 0.3, np.float32)


def _reqs(seed, bucket=None, output_type="latent", embeds=None):
    """The same request for the JAX server and for the port's."""
    emb = _embeds(seed) if embeds is None else embeds
    mask = np.ones((1, 8), np.float32)
    jb = None if bucket is None else JS.ShapeBucket(*bucket)
    pb = None if bucket is None else PS.ShapeBucket(*bucket)
    return (JS.Request(prompt_embeds=jnp.asarray(emb), prompt_attention_mask=jnp.asarray(mask),
                       bucket=jb, output_type=output_type, seed=seed),
            PS.Request(prompt_embeds=torch.from_numpy(emb),
                       prompt_attention_mask=torch.from_numpy(mask), bucket=pb,
                       output_type=output_type, seed=seed))


def _servers(pipes, buckets, **kw):
    jpipe, ppipe = pipes
    return (JS.VideoGenerationServer(jpipe, [JS.ShapeBucket(*b) for b in buckets],
                                     attn_impl="xla", **kw),
            PS.VideoGenerationServer(ppipe, [PS.ShapeBucket(*b) for b in buckets], **kw))


def _served(server, requests):
    """Submit every request before the worker starts (so the drain sees them
    all at once), then collect each result with a timeout."""
    outs = [server.submit(r) for r in requests]
    server.start()
    try:
        results = [q.get(timeout=GET_TIMEOUT) for q in outs]
    finally:
        server.stop()
    for r in results:
        assert not isinstance(r, Exception), r
    return results


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.numpy()


def test_warmup_and_sync_generate(pipes):
    jserver, pserver = _servers(pipes, [SMALL], max_sequence_length=8)
    pserver.warmup()
    assert "compile_s" in pserver.stats()["buckets"][str(PS.ShapeBucket(*SMALL).key())]
    jreq, preq = _reqs(1)
    out = pserver.generate_sync(preq)
    assert out.shape == (1, 2 * 2 * 2, 8)  # latent 2x2x((9-1)/8+1 = 2) frames
    assert pserver.stats()["served"] == 1
    np.testing.assert_allclose(_np(out), _np(jserver.generate_sync(jreq)), **PARITY)


def test_queue_loop(pipes):
    jserver, pserver = _servers(pipes, [SMALL], max_sequence_length=8)
    pserver.warmup().start()
    try:
        outs = [pserver.submit(_reqs(i)[1]) for i in range(3)]
        results = [q.get(timeout=GET_TIMEOUT) for q in outs]
    finally:
        pserver.stop()
    for i, r in enumerate(results):
        assert not isinstance(r, Exception), r
        assert r.shape == (1, 8, 8)
        np.testing.assert_allclose(_np(r), _np(jserver.generate_sync(_reqs(i)[0])), **PARITY)
    assert pserver.stats()["served"] == 3
    assert pserver.stats()["queue_depth"] == 0


def test_bucket_snapping(pipes):
    jserver, pserver = _servers(pipes, [SMALL, BIG], max_sequence_length=8)
    # a request between the buckets snaps up to the smallest that fits
    assert pserver._pick_bucket(_reqs(1, (65, 65, 9, 2))[1]) == PS.ShapeBucket(*BIG)
    assert pserver._pick_bucket(PS.Request(bucket=PS.ShapeBucket(*SMALL))) == \
        PS.ShapeBucket(*SMALL)
    # the same choice as the JAX server's over a grid, and the first bucket
    # when none fits or none is asked for
    for shape in [(32, 64, 5, 2), (64, 96, 9, 2), (96, 96, 17, 2), (128, 64, 9, 2), None]:
        jreq, preq = _reqs(1, shape)
        assert pserver._pick_bucket(preq).key() == jserver._pick_bucket(jreq).key(), shape


def test_continuous_batching(pipes):
    """Three queued same-bucket requests serve as ONE batched generate whose
    rows equal the requests served alone (per-seed PCG32 latents)."""
    jsingle, single = _servers(pipes, [SMALL], max_sequence_length=8)
    expected = [_np(single.generate_sync(_reqs(i)[1])) for i in (1, 2, 3)]
    _, server = _servers(pipes, [SMALL], max_batch=4, max_sequence_length=8)
    server.warmup()
    results = _served(server, [_reqs(i)[1] for i in (1, 2, 3)])
    for i, r, e in zip((1, 2, 3), results, expected):
        assert r.shape == e.shape
        np.testing.assert_allclose(_np(r), e, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(r), _np(jsingle.generate_sync(_reqs(i)[0])), **PARITY)
    rec = server.stats()["buckets"][str(PS.ShapeBucket(*SMALL).key())]
    assert rec["last_batch"] == 3
    assert server.stats()["served"] == 3


def test_batched_tensor_output_equals_single(pipes_vae):
    """Batched tensor-output requests equal the same requests served alone:
    each row's initial latents and decode noise come from its own seed."""
    bucket = (64, 64, 5, 2)
    jsingle, single = _servers(pipes_vae, [bucket], max_sequence_length=8)
    expected = [_np(single.generate_sync(_reqs(i, output_type="tensor")[1])) for i in (1, 2)]
    _, server = _servers(pipes_vae, [bucket], max_batch=2, max_sequence_length=8)
    results = _served(server, [_reqs(i, output_type="tensor")[1] for i in (1, 2)])
    for i, r, e in zip((1, 2), results, expected):
        assert r.shape == e.shape == (1, 3, 5, 16, 16)  # the tiny decoder upsamples 8x
        np.testing.assert_allclose(_np(r), e, atol=1e-5, rtol=1e-5)
        want = _np(jsingle.generate_sync(_reqs(i, output_type="tensor")[0]))
        np.testing.assert_allclose(_np(r), want, **PARITY)


@pytest.mark.parametrize("use_pcg_rng", [True, False], ids=["pcg", "jax_random"])
def test_row_draws_equal_the_jax_servers(pipes_vae, use_pcg_rng):
    """Each row's initial latents are the JAX server's: PCG32 rows bit for
    bit; ``jax.random.normal(PRNGKey(seed))`` rows (``use_pcg_rng=False``)
    and the decode noise (``PRNGKey(seed + 2)``) within ``utils/rng``'s
    float32 limit, atol 1e-5 (XLA's log1p and fused erfinv polynomial round
    a few ulp apart from NumPy's).  Every row is bit-equal to the host
    reference draw for that seed (PCG32, or ``utils/rng.normal``)."""
    from candle_video_tpu_torch.utils import rng as R

    bucket = (64, 64, 5, 2)
    jserver, pserver = _servers(pipes_vae, [bucket], use_pcg_rng=use_pcg_rng)
    jb, pb = JS.ShapeBucket(*bucket), PS.ShapeBucket(*bucket)
    seeds = [5, 6, 2**31 + 7]
    shape = pserver._latent_shape(pb)
    rows = np.concatenate([pserver._row_latents(_reqs(s)[1], pb) for s in seeds])
    want = np.concatenate([np.asarray(jserver._row_latents(_reqs(s)[0], jb), np.float32)
                           for s in seeds])
    if use_pcg_rng:
        np.testing.assert_array_equal(rows, want)
        single = [R.Pcg32(s, 0).randn(shape) for s in seeds]
    else:
        np.testing.assert_allclose(rows, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(rows, np.asarray(jserver._rows_normal(seeds, shape)),
                                   atol=1e-5, rtol=0)
        single = [R.normal(R.prng_key(s), shape) for s in seeds]
    np.testing.assert_array_equal(rows, np.concatenate(single))
    noise = np.concatenate([pserver._row_decode_noise(_reqs(s)[1], pb) for s in seeds])
    np.testing.assert_allclose(noise, np.asarray(jserver._rows_normal(seeds, shape, 2)),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        noise, np.concatenate([R.normal(R.prng_key(s + 2), shape) for s in seeds]))


@pytest.mark.parametrize("output_type", ["latent", "tensor"])
def test_batched_jax_random_draws_are_one_rows_normal_each(pipes_vae, monkeypatch, output_type):
    """``use_pcg_rng=False``: a batch draws its latents and (for a video) its
    decode noise with one ``rows_normal`` call each, offsets 0 and 2, as the
    JAX server's ``_batched_generate`` does: within atol 1e-5 of the JAX
    server's ``_rows_normal`` rows (float32 ulps, ``test_torch_threefry.py``)
    and bit-equal to the rows a single-request ``generate`` draws on the
    same device (``normal_on(PRNGKey(seed))``, ``PRNGKey(seed + 2)``)."""
    from candle_video_tpu_torch.utils import rng as R

    bucket = (64, 64, 5, 2)
    jserver, pserver = _servers(pipes_vae, [bucket], use_pcg_rng=False)
    pb = PS.ShapeBucket(*bucket)
    seeds = [5, 6, 2**31 + 7]
    shape = pserver._latent_shape(pb)
    calls, seen = [], {}
    rows_normal = R.rows_normal
    monkeypatch.setattr(R, "rows_normal", lambda *a, **k: calls.append((a, k))
                        or rows_normal(*a, **k))
    monkeypatch.setattr(PS, "generate", lambda pipe, **kw: seen.update(kw) or kw["latents"])
    pserver._batched_generate([_reqs(s, bucket, output_type)[1] for s in seeds], pb)
    video = output_type == "tensor"
    assert [c[1].get("offset", 0) for c in calls] == ([0, 2] if video else [0])
    assert all(list(c[0][0]) == seeds for c in calls)
    np.testing.assert_allclose(seen["latents"].numpy(),
                               np.asarray(jserver._rows_normal(seeds, shape)), atol=1e-5, rtol=0)
    single = torch.cat([R.normal_on(R.prng_key(s), shape) for s in seeds])
    assert torch.equal(seen["latents"], single)
    if not video:
        assert seen["decode_noise"] is None
        return
    np.testing.assert_allclose(seen["decode_noise"].numpy(),
                               np.asarray(jserver._rows_normal(seeds, shape, 2)),
                               atol=1e-5, rtol=0)
    assert torch.equal(seen["decode_noise"],
                       torch.cat([R.normal_on(R.prng_key(s + 2), shape) for s in seeds]))


def test_row_latents_respect_use_pcg_rng(pipes):
    """With ``use_pcg_rng=False`` batched rows draw ``jax.random`` latents
    exactly as a single-request call does."""
    jsingle, single = _servers(pipes, [SMALL], max_sequence_length=8, use_pcg_rng=False)
    expected = [_np(single.generate_sync(_reqs(i)[1])) for i in (5, 6)]
    _, server = _servers(pipes, [SMALL], max_batch=2, max_sequence_length=8,
                         use_pcg_rng=False)
    results = _served(server, [_reqs(i)[1] for i in (5, 6)])
    for i, r, e in zip((5, 6), results, expected):
        np.testing.assert_allclose(_np(r), e, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(r), _np(jsingle.generate_sync(_reqs(i)[0])), **PARITY)


def test_stochastic_preset_batch_shares_the_first_requests_step_noise_as_jax(pipes):
    """A stochastic preset: the batched call takes the first request's seed
    for the step noise of every row, as the JAX server does (a reference
    defect), so its second row differs from that request served alone; the
    port's batch equals the JAX server's batch."""
    stochastic = _pair(dict(GUIDED, guidance_scale=1.0, stochastic_sampling=True),
                       with_vae=False)
    jserver, server = _servers(stochastic, [SMALL], max_batch=2, max_sequence_length=8)
    jres = _served(jserver, [_reqs(i)[0] for i in (1, 2)])
    results = _served(server, [_reqs(i)[1] for i in (1, 2)])
    for r, j in zip(results, jres):
        np.testing.assert_allclose(_np(r), _np(j), **PARITY)
    _, single = _servers(stochastic, [SMALL], max_sequence_length=8)
    np.testing.assert_allclose(_np(results[0]), _np(single.generate_sync(_reqs(1)[1])),
                               atol=1e-5, rtol=1e-5)
    assert not np.allclose(_np(results[1]), _np(single.generate_sync(_reqs(2)[1])),
                           atol=1e-3)


def test_skipped_requests_not_starved(pipes):
    """A request held out of a batch is served from the pending list before
    new queue items."""
    _, server = _servers(pipes, [SMALL, BIG], max_batch=4, max_sequence_length=8)
    # small, big, small, small: the big one must still be served
    results = _served(server, [_reqs(1)[1], _reqs(2, BIG)[1], _reqs(3)[1], _reqs(4)[1]])
    assert results[1].shape == (1, 3 * 3 * 2, 8)
    assert server.stats()["served"] == 4
    rec = server.stats()["buckets"][str(PS.ShapeBucket(*SMALL).key())]
    assert rec["served"] == 3 and rec["last_batch"] == 3


def test_batching_mixed_buckets_requeue(pipes):
    """A request of another bucket is held and served on its own."""
    jserver, server = _servers(pipes, [SMALL, BIG], max_batch=4, max_sequence_length=8)
    r0, r1 = _served(server, [_reqs(1)[1], _reqs(2, BIG)[1]])
    assert r0.shape == (1, 8, 8)
    assert r1.shape == (1, 3 * 3 * 2, 8)
    assert server.stats()["served"] == 2
    np.testing.assert_allclose(_np(r1), _np(jserver.generate_sync(_reqs(2, BIG)[0])),
                               **PARITY)


def test_server_rejects_conditioning_kwargs():
    """Server-level conditioning would drop the anchors (the server passes
    each row's noise as ``latents``, which generate() takes as already
    mixed): refused at construction, as by the JAX server."""
    for server, bucket in ((JS.VideoGenerationServer, JS.ShapeBucket),
                           (PS.VideoGenerationServer, PS.ShapeBucket)):
        for kw in ("image_latents", "image", "conditioning"):
            with pytest.raises(ValueError, match="conditioning"):
                server(object(), [bucket(64, 64, 9, 4)], **{kw: object()})


def test_mixed_bucket_fairness_under_burst(pipes):
    """Alternating big and small requests with batching all complete, and
    the first small request finishes no later than the last big one."""
    _, server = _servers(pipes, [SMALL, BIG], max_batch=2, max_sequence_length=8)
    zeros = np.zeros((1, 8, 16), np.float32)
    reqs = [_reqs(i, BIG if i % 2 == 0 else SMALL, embeds=zeros)[1] for i in range(6)]
    outs = [server.submit(r) for r in reqs]
    server.start()
    try:
        done_at = {}
        for i, q in enumerate(outs):
            res = q.get(timeout=GET_TIMEOUT)
            assert not isinstance(res, Exception), res
            done_at[i] = time.time()
    finally:
        server.stop()
    assert server.stats()["served"] == 6
    assert done_at[1] <= done_at[4] + 1e-6


def test_worker_error_reaches_the_caller(pipes):
    """An exception in the worker goes into the caller's result queue, and
    generate_sync raises it; the worker goes on serving."""
    _, server = _servers(pipes, [SMALL], max_batch=2, max_sequence_length=8)
    bad = PS.Request(prompt_embeds=torch.zeros(1, 8, 16), bucket=PS.ShapeBucket(*SMALL),
                     output_type="latent")  # no attention mask
    server.start()
    try:
        with pytest.raises(ValueError, match="prompt_attention_mask"):
            server.generate_sync(bad, timeout=GET_TIMEOUT)
        assert server.generate_sync(_reqs(1)[1], timeout=GET_TIMEOUT).shape == (1, 8, 8)
    finally:
        server.stop()


def test_unknown_generate_keyword_raises(pipes):
    """``generate_kwargs`` take only what the port's generate() takes:
    ``attn_impl`` is not ported."""
    server = PS.VideoGenerationServer(pipes[1], [PS.ShapeBucket(*SMALL)], attn_impl="xla")
    with pytest.raises(TypeError, match="attn_impl"):
        server.generate_sync(_reqs(1)[1])


def test_cli_serve_rejects_mesh_and_image():
    """--serve is the single-GPU serving loop: --mesh and the one-shot
    surfaces (--image, latent output) are refused before anything loads."""
    with pytest.raises(SystemExit, match="single-GPU serving loop"):
        PCLI.main(["--serve", "--mesh", "tp=2"])
    with pytest.raises(SystemExit, match="one-shot CLI path"):
        PCLI.main(["--serve", "--image", "x.png"])
    with pytest.raises(SystemExit, match="one-shot CLI path"):
        PCLI.main(["--serve", "--output-type", "latent"])
    args = PCLI.build_parser().parse_args(["--serve", "--serve-max-batch", "2"])
    assert args.serve and args.serve_max_batch == 2


def test_string_prompt_serving(pipes_vae):
    """String prompts go through generate(prompt=...) one at a time (the
    batcher groups only embedding requests); the result equals a direct
    generate() with the same seed, and the JAX server's."""
    jpipe, ppipe = pipes_vae
    bucket = (64, 64, 5, 2)
    jserver, server = _servers(pipes_vae, [bucket], max_batch=2, max_sequence_length=8,
                               use_pcg_rng=False)
    server.warmup().start()
    try:
        out = server.generate_sync(PS.Request(prompt="a cat", bucket=PS.ShapeBucket(*bucket),
                                              seed=9, output_type="tensor"),
                                   timeout=GET_TIMEOUT)
    finally:
        server.stop()
    ref = PP.generate(ppipe, prompt="a cat", height=64, width=64, num_frames=5,
                      num_inference_steps=2, guidance_scale=1.0, stg_scale=0.0, seed=9,
                      output_type="tensor", max_sequence_length=8, use_pcg_rng=False)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-3, rtol=1e-5)
    want = jserver.generate_sync(JS.Request(prompt="a cat", bucket=JS.ShapeBucket(*bucket),
                                            seed=9, output_type="tensor"))
    np.testing.assert_allclose(_np(out), _np(want), **PARITY)


def _serve_args(tmp_path, **kw):
    return argparse.Namespace(**{**dict(
        height=64, width=64, num_frames=5, num_inference_steps=None, guidance_scale=None,
        negative_prompt="bad", serve_max_batch=1, pcg_rng=False, vae_stream_chunks=0,
        output_dir=str(tmp_path), frame_rate=25.0, max_sequence_length=8, seed=5), **kw})


def test_cli_run_serve_loop(pipes_vae, tmp_path, monkeypatch):
    """The --serve loop (cli.run_serve): prompts stream from stdin, each
    makes a video file, 'quit' ends it, lines after it are not read."""
    monkeypatch.setattr("sys.stdin", io.StringIO("a cat\n\na dog\nquit\nnever seen\n"))
    assert PCLI.run_serve(_serve_args(tmp_path), pipes_vae[1]) == 0
    made = sorted(p.name for p in tmp_path.iterdir())
    assert len(made) == 2 and made[0].startswith("serve_000")
    assert made[1].startswith("serve_001")


def test_cli_serve_mock_embeddings_hash_the_prompt_stably(pipes_vae, tmp_path, monkeypatch):
    """Without a T5 a prompt maps to random embeddings seeded by the CRC-32
    of its UTF-8 bytes (the JAX CLI's ``hash()`` differs from process to
    process), and each request takes seed ``--seed + n``."""
    pipe = dataclasses.replace(pipes_vae[1], t5=None)
    seen = []
    submit = PS.VideoGenerationServer.submit

    def record(self, request):
        seen.append(request)
        return submit(self, request)

    monkeypatch.setattr(PS.VideoGenerationServer, "submit", record)
    monkeypatch.setattr("sys.stdin", io.StringIO("a cat\nun chat noir\n"))
    assert PCLI.run_serve(_serve_args(tmp_path, serve_max_batch=2), pipe) == 0
    assert len(list(tmp_path.iterdir())) == 2
    for n, (req, prompt) in enumerate(zip(seen, ["a cat", "un chat noir"])):
        want = np.random.default_rng(zlib.crc32(prompt.encode("utf-8"))).normal(
            size=(1, 8, 16)) * 0.02
        np.testing.assert_array_equal(req.prompt_embeds.numpy(), want.astype(np.float32))
        assert req.prompt is None and req.seed == 5 + n


def test_cli_serve_batches_lines_queued_behind_a_running_request(pipes_vae, tmp_path,
                                                                 monkeypatch):
    """The --serve loop submits each line as it is read: the lines that
    queue behind the first request are served as batches of
    ``--serve-max-batch``.  With a T5 each request carries the prompt's
    embeddings, encoded as the line is read."""
    pipe = pipes_vae[1]
    servers, seen = [], []
    submit = PS.VideoGenerationServer.submit

    def record(self, request):
        servers.append(self)
        seen.append(request)
        return submit(self, request)

    monkeypatch.setattr(PS.VideoGenerationServer, "submit", record)
    prompts = ["a cat", "a dog", "a bird", "a fish"]
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(p + "\n" for p in prompts)))
    assert PCLI.run_serve(_serve_args(tmp_path, serve_max_batch=2), pipe) == 0
    assert len(list(tmp_path.iterdir())) == 4
    stats = servers[0].stats()
    assert stats["served"] == 4
    (bucket,) = stats["buckets"].values()
    assert bucket["last_batch"] == 2
    for n, (req, prompt) in enumerate(zip(seen, prompts)):
        emb, mask = pipe.encode_prompt([prompt], 8)
        torch.testing.assert_close(req.prompt_embeds, emb, atol=0, rtol=0)
        torch.testing.assert_close(req.prompt_attention_mask, mask, atol=0, rtol=0)
        assert req.prompt is None and req.negative_prompt_embeds is None
        assert req.seed == 5 + n


def test_cli_serve_raises_a_worker_error(pipes_vae, tmp_path, monkeypatch):
    """An exception in the server's worker reaches the CLI loop, which
    raises it once the lines before it are written."""
    def fail(self, request):
        raise RuntimeError("worker failed")

    monkeypatch.setattr(PS.VideoGenerationServer, "_serve_one", fail)
    monkeypatch.setattr("sys.stdin", io.StringIO("a cat\n"))
    with pytest.raises(RuntimeError, match="worker failed"):
        PCLI.run_serve(_serve_args(tmp_path), pipes_vae[1])
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("serve_")]

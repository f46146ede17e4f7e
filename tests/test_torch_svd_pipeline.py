"""The SVD image-to-video pipeline of the PyTorch port against JAX
``generate`` on the CPU, in f32.

One parameter set (the torch mirrors' UNet and VAE, HF's CLIP at a tiny
size) goes to both sides; the port's ``generate`` takes the JAX
``jax.random`` draws (image noise, initial latents) as tensors.  The request
runs CLIP on the resized image, the noise-augmented VAE encode, CFG with the
per-frame guidance ramp over three Euler steps and the decode; at 48×48 the
UNet's level 0 has 576 tokens of 2 heads of 16 (not lane-packable), so K6's
route carries it.  Envelope: latents max-abs <= 2e-3 (the UNet's) and video
PSNR >= 35 dB (the pipeline's, ``docs/benchmark_results.md``)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import torch_svd  # noqa: E402
import torch_svd_vae as tvv  # noqa: E402

from candle_video_tpu.models.svd import clip as JC  # noqa: E402
from candle_video_tpu.models.svd import configs as JCFG  # noqa: E402
from candle_video_tpu.models.svd import pipeline as JP  # noqa: E402
from candle_video_tpu.models.svd import vae as JV  # noqa: E402
from candle_video_tpu.models.svd.loader import unet_params_from_state_dict as junet  # noqa: E402
from candle_video_tpu_torch import cli_svd  # noqa: E402
from candle_video_tpu_torch.models.svd import clip as PC  # noqa: E402
from candle_video_tpu_torch.models.svd import configs as PCFG  # noqa: E402
from candle_video_tpu_torch.models.svd import loader as PL  # noqa: E402
from candle_video_tpu_torch.models.svd import pipeline as PP  # noqa: E402
from candle_video_tpu_torch.models.svd import vae as PV  # noqa: E402
from candle_video_tpu_torch.ops.kernels import flash_attention as K6  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
UNET = dict(in_channels=8, out_channels=4, block_out_channels=(32, 64), layers_per_block=1,
            cross_attention_dim=16, num_attention_heads=(2, 4), addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24)
VAE = dict(block_out_channels=(32, 64), latent_channels=4, layers_per_block=1)
CLIP = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            image_size=28, patch_size=14, projection_dim=16)
INF = dict(num_frames=3, num_inference_steps=3, fps=7, motion_bucket_id=127,
           noise_aug_strength=0.02, min_guidance_scale=1.0, max_guidance_scale=2.5, seed=11)


def _configs(mod):
    return mod.SvdConfig(unet=mod.SvdUnetConfig(**UNET), vae=mod.SvdVaeConfig(**VAE),
                         scheduler=mod.EulerSchedulerConfig(),
                         clip=mod.ClipEncoderConfig(**CLIP))


@pytest.fixture(scope="module")
def pipes():
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    torch.manual_seed(0)
    unet_sd = {k: v.numpy() for k, v in torch_svd.UNetSpatioTemporal(
        in_channels=8, out_channels=4, block_out_channels=(32, 64), layers_per_block=1,
        cross_dim=16, heads=(2, 4), addition_time_embed_dim=8).state_dict().items()}
    vae_sd = {k: v.numpy() for k, v in tvv.AutoencoderKLTemporalDecoder(
        boc=(32, 64), latent=4, layers=1).state_dict().items()}
    clip_sd = {k: v.numpy() for k, v in CLIPVisionModelWithProjection(
        CLIPVisionConfig(hidden_act="quick_gelu", **CLIP)).state_dict().items()}
    jcfg, pcfg = _configs(JCFG), _configs(PCFG)
    jpipe = JP.SvdPipeline(config=jcfg, unet_params=junet(unet_sd, jnp.float32),
                           vae_params=JV.vae_params_from_state_dict(vae_sd, jnp.float32),
                           clip_params=JC.params_from_hf_state_dict(clip_sd, jcfg.clip,
                                                                     jnp.float32))
    ppipe = PP.SvdPipeline(config=pcfg,
                           unet=PL.unet_params_from_state_dict(unet_sd, pcfg.unet),
                           vae=PV.vae_params_from_state_dict(vae_sd, pcfg.vae),
                           clip=PC.params_from_hf_state_dict(clip_sd, pcfg.clip))
    return jpipe, ppipe


def _jax_draws(image, lat_hw):
    """The JAX ``generate``'s two normal draws for seed ``INF["seed"]``."""
    key = jax.random.PRNGKey(INF["seed"])
    key, k1, k2 = jax.random.split(key, 3)
    image_noise = jax.random.normal(k1, image.shape, jnp.float32)
    latent_noise = jax.random.normal(k2, (INF["num_frames"], 4) + lat_hw, jnp.float32)
    return (torch.from_numpy(np.array(image_noise)), torch.from_numpy(np.array(latent_noise)))


def _psnr(got, want):
    to255 = lambda v: (np.clip(v, -1, 1) + 1.0) * 127.5  # noqa: E731
    mse = float(np.mean((to255(got).astype(np.float64) - to255(want)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_generate_matches_jax_generate(pipes, rng, monkeypatch):
    jpipe, ppipe = pipes
    image = rng.uniform(-1, 1, size=(1, 3, 48, 48)).astype(np.float32)
    inf_j, inf_p = JP.SvdInferenceConfig(**INF), PP.SvdInferenceConfig(**INF)
    want = np.asarray(JP.generate(jpipe, jnp.asarray(image), inf_j, output_type="latent"))
    want_video = np.asarray(JV.decode(jpipe.vae_params, jpipe.config.vae, jnp.asarray(want),
                                      INF["num_frames"]))
    image_noise, latent_noise = _jax_draws(image, want.shape[2:])

    calls = []
    plain = K6.flash_attention_plain
    monkeypatch.setattr(K6, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    times = {}
    got = PP.generate(ppipe, torch.from_numpy(image), inf_p, output_type="latent",
                      image_noise=image_noise, latent_noise=latent_noise,
                      stage_times=times).numpy()
    # level 0: down block 0's transformer and up block 1's two, 3 steps
    assert len(calls) == 3 * 3
    assert got.shape == want.shape == (3, 4, 24, 24)
    assert np.abs(got - want).max() <= 2e-3
    assert set(times) == {"clip_encode", "vae_encode", "unet_steps"}
    assert len(times["unet_steps"]) == 3

    video = PP.generate(ppipe, torch.from_numpy(image), inf_p, image_noise=image_noise,
                        latent_noise=latent_noise).numpy()
    assert video.shape == want_video.shape == (3, 3, 48, 48)
    assert _psnr(video, want_video) >= 35.0


def test_generate_draws_from_its_generator(pipes, rng):
    """Without injected draws the noise comes from the generator: the same
    seed repeats the request, another seed does not."""
    _, ppipe = pipes
    image = torch.from_numpy(rng.uniform(-1, 1, size=(1, 3, 32, 32)).astype(np.float32))
    inf = PP.SvdInferenceConfig(**dict(INF, num_inference_steps=1))
    runs = [PP.generate(ppipe, image, inf, output_type="latent",
                        generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    seeded = PP.generate(ppipe, image, inf, output_type="latent")  # INF's seed
    assert torch.equal(seeded, PP.generate(ppipe, image, inf, output_type="latent",
                                           generator=torch.Generator().manual_seed(11)))


def test_guidance_ramp_and_conditioning_rows_match_jax(pipes, rng):
    """Image embeddings given (CLIP bypassed), guidance 1 -> 3: the CFG rows,
    the ramp and ``scale_model_input`` over two steps against JAX."""
    jpipe, ppipe = pipes
    image = rng.uniform(-1, 1, size=(1, 3, 32, 32)).astype(np.float32)
    emb = (rng.normal(size=(1, 1, 16)) * 0.3).astype(np.float32)
    inf = dict(INF, num_inference_steps=2, max_guidance_scale=3.0)
    want = np.asarray(JP.generate(jpipe, jnp.asarray(image), JP.SvdInferenceConfig(**inf),
                                  image_embeddings=jnp.asarray(emb), output_type="latent"))
    image_noise, latent_noise = _jax_draws(image, want.shape[2:])
    got = PP.generate(ppipe, torch.from_numpy(image), PP.SvdInferenceConfig(**inf),
                      image_embeddings=torch.from_numpy(emb), output_type="latent",
                      image_noise=image_noise, latent_noise=latent_noise).numpy()
    assert np.abs(got - want).max() <= 2e-3


def test_cli_svd_refuses_without_weights(capsys):
    assert cli_svd.main([]) == 2
    assert "--weights-path" in capsys.readouterr().out
    args = cli_svd.build_parser().parse_args([])
    assert args.device == "cuda" and (args.height, args.width, args.num_frames) == (576, 1024, 14)


def test_port_svd_generate_never_imports_jax(tmp_path):
    """The port's SVD path in a process where neither JAX nor the JAX package
    can be imported: random tiny weights from a seed, one request."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["candle_video_tpu"] = None
        import torch
        torch.set_num_threads(2)
        from candle_video_tpu_torch import cli_svd
        from candle_video_tpu_torch.models.svd import clip as C, unet as U, vae as V
        from candle_video_tpu_torch.models.svd import pipeline as P
        from candle_video_tpu_torch.models.svd import configs as F
        cfg = F.SvdConfig(unet=F.SvdUnetConfig(**{UNET!r}), vae=F.SvdVaeConfig(**{VAE!r}),
                          clip=F.ClipEncoderConfig(**{CLIP!r}))
        g = torch.Generator().manual_seed(0)
        pipe = P.SvdPipeline(cfg, U.init_random(cfg.unet, "cpu", torch.float32, g),
                             V.init_random(cfg.vae, "cpu", torch.float32, g),
                             C.init_random(cfg.clip, "cpu", torch.float32, g))
        image = torch.rand(1, 3, 32, 32, generator=g) * 2 - 1
        video = P.generate(pipe, image, P.SvdInferenceConfig(num_frames=2, num_inference_steps=2))
        assert video.shape == (2, 3, 32, 32) and torch.isfinite(video).all()
        assert cli_svd.main([]) == 2
        leaked = [m for m in sys.modules if m.startswith(("jax.", "candle_video_tpu."))]
        assert not leaked, leaked
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")

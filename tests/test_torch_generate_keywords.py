"""The decode-policy and attention keywords of the port's ``generate`` and
``vae.decode`` against the JAX package's, on the CPU in f32, at the tiny
configs of ``test_torch_pipeline.py``:

- ``generate(vae_auto_decode=)``: with the free memory patched so that the
  policy streams, both values give JAX's ``generate(vae_auto_decode=)``
  result within ``_check_generate``'s limits (latents MSE < 1e-3, video
  PSNR > 35 dB), and ``stage_times["decode_mode"]`` names the mode run;
- ``vae.decode(auto_mode=)``: the mode the policy picks, bit for bit; chunk
  keywords win; against JAX's ``decode(auto_mode=True)`` within the VAE's
  5e-4;
- ``generate(attn_impl=)``: every value gives the same latents on the CPU
  (JAX's within MSE 1e-3), an unknown one raises, and ``"xla"`` on a
  device that is not the CPU (meta tensors standing in for the card)
  raises before any encode, draw or launch;
- the CLI passes ``--attn-impl`` into ``generate``, and the server into
  its ``generate`` calls.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import pipeline as JP
from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu_torch import cli as PCLI
from candle_video_tpu_torch import serving as PSV
from candle_video_tpu_torch.models.ltx_video import pipeline as PP
from candle_video_tpu_torch.models.ltx_video import vae as PV
from candle_video_tpu_torch.ops.kernels import _build

from test_torch_pipeline import (  # noqa: F401  (fixtures)
    DISTILLED, _cli_latents, _pipelines, jax_trees, tiny_cli)

torch.set_num_threads(2)

# 64x96x57 frames: latents [1, 8, 15, 2, 3], 368,640 output pixel-frames.
# 45 MB free: 85% of it holds the port's tail stream (98 B a pixel-frame)
# but not its dense decode (110), so the port's policy streams the tail in
# 2 chunks; the JAX policy (200 / 62 B) picks the tail stream too.
KW = dict(prompt="a cat playing piano", height=64, width=96, num_frames=57, seed=3,
          max_sequence_length=16)
FREE_BYTES = 45_000_000
VAE_ATOL = 5e-4  # port against JAX on one VAE (test_torch_vae_stream.py)


@pytest.fixture
def tight_memory(monkeypatch):
    """Both packages' decode policies read ``FREE_BYTES`` free."""
    monkeypatch.setattr(PV, "_device_free_bytes", lambda device: FREE_BYTES)
    monkeypatch.setattr(JV, "_device_free_bytes", lambda: FREE_BYTES)


def _used(mode: dict) -> dict:
    """The keywords of a decode mode that ask for something (dense: {})."""
    return {k: v for k, v in mode.items() if v}


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("auto", [True, False], ids=["auto", "dense"])
def test_vae_auto_decode_matches_jax(jax_trees, tight_memory, auto):
    jpipe, ppipe = _pipelines(jax_trees, DISTILLED)
    noise = np.random.default_rng(9).normal(size=(1, 8, 15, 2, 3)).astype(np.float32)
    times = {}
    got = PP.generate(ppipe, decode_noise=torch.from_numpy(noise), vae_auto_decode=auto,
                      stage_times=times, **KW).numpy()
    want = np.asarray(JP.generate(jpipe, decode_noise=jnp.asarray(noise),
                                  vae_auto_decode=auto, **KW))
    assert _used(times["decode_mode"]) == ({"tail_stream_chunks": 2} if auto else {})
    assert got.shape == want.shape == (1, 3, 57, 16, 24)
    assert _psnr(got, want) > 35.0
    # the streamed tail is exact: the two port videos agree to op-order noise
    other = PP.generate(ppipe, decode_noise=torch.from_numpy(noise), vae_auto_decode=not auto,
                        **KW).numpy()
    np.testing.assert_allclose(got, other, atol=1e-3, rtol=0)


def test_vae_auto_decode_off_keeps_an_explicit_mode(jax_trees, tight_memory):
    _, ppipe = _pipelines(jax_trees, DISTILLED)
    times = {}
    PP.generate(ppipe, vae_auto_decode=False, vae_full_stream_chunks=2, stage_times=times,
                **KW)
    assert _used(times["decode_mode"]) == {"full_stream_chunks": 2}


def _modes_run(monkeypatch):
    """The (tail, from_ups, full) of every ``_decode_mode_fn`` built."""
    seen, build = [], PV._decode_mode_fn
    monkeypatch.setattr(PV, "_decode_mode_fn",
                        lambda dec, *a: seen.append(tuple(a)) or build(dec, *a))
    return seen


@pytest.fixture
def no_grad():
    with torch.no_grad():
        yield


def test_decode_auto_mode_is_the_policys_mode(jax_trees, tight_memory, monkeypatch, no_grad):
    jpipe, ppipe = _pipelines(jax_trees, DISTILLED)
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.normal(size=(1, 8, 15, 2, 3)).astype(np.float32))
    temb = torch.tensor([0.05])
    picked = PV.select_decode_mode(ppipe.vae.cfg, z.shape, device=z.device)
    assert picked == {"tail_stream_chunks": 2}
    seen = _modes_run(monkeypatch)
    auto = PV.decode(ppipe.vae, z, temb, auto_mode=True)
    explicit = PV.decode(ppipe.vae, z, temb, **picked)
    dense = PV.decode(ppipe.vae, z, temb)  # auto_mode is off by default
    assert seen == [(2, False, 0), (2, False, 0), (0, False, 0)]
    assert torch.equal(auto, explicit)
    np.testing.assert_allclose(auto.numpy(), dense.numpy(), atol=1e-5, rtol=0)
    # chunk keywords win over the policy
    seen.clear()
    ups = PV.decode(ppipe.vae, z, temb, auto_mode=True, tail_stream_chunks=3,
                    tail_stream_from_ups=True)
    full = PV.decode(ppipe.vae, z, temb, auto_mode=True, full_stream_chunks=2)
    assert seen == [(3, True, 0), (0, False, 2)]
    assert torch.equal(ups, PV.decode(ppipe.vae, z, temb, tail_stream_chunks=3,
                                      tail_stream_from_ups=True))
    assert torch.equal(full, PV.decode(ppipe.vae, z, temb, full_stream_chunks=2))
    # the JAX facade's auto_mode on the same latents and budget
    want = JV.decode(jpipe.vae_params, jpipe.config.vae, jnp.asarray(z.numpy()),
                     jnp.asarray(temb.numpy()), use_tiling=False,
                     use_framewise_decoding=False, auto_mode=True)
    np.testing.assert_allclose(auto.numpy(), np.asarray(want), atol=VAE_ATOL, rtol=0)


LATENT_KW = dict(prompt="a cat walking on grass", height=64, width=96, num_frames=9, seed=5,
                 max_sequence_length=16, output_type="latent")


def test_attn_impl_every_value_runs_the_plain_path_on_the_cpu(jax_trees):
    jpipe, ppipe = _pipelines(jax_trees, DISTILLED)
    got = {v: PP.generate(ppipe, attn_impl=v, **LATENT_KW) for v in PP.ATTN_IMPLS}
    assert torch.equal(got["auto"], got["pallas"]) and torch.equal(got["auto"], got["xla"])
    want = np.asarray(JP.generate(jpipe, attn_impl="xla", **LATENT_KW))
    assert float(np.mean((got["auto"].numpy() - want) ** 2)) < 1e-3
    with pytest.raises(ValueError, match="attn_impl 'flash'"):
        PP.generate(ppipe, attn_impl="flash", **LATENT_KW)


def test_attn_impl_xla_off_the_cpu_raises_before_any_work(jax_trees, monkeypatch):
    """A pipeline on meta tensors (a device that is not the CPU, as the
    card): ``"xla"`` raises before the tokenizer, a draw or a kernel runs."""
    _, ppipe = _pipelines(jax_trees, DISTILLED)
    ppipe.transformer.to("meta")
    assert ppipe.device.type == "meta"
    calls = []
    monkeypatch.setattr(ppipe.tokenizer, "encode_batch", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(PP, "_initial_noise", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(PP.R, "normal_on", lambda *a, **k: calls.append(a))
    _build.reset_launches()
    with pytest.raises(ValueError, match="no tensor falls back"):
        PP.generate(ppipe, attn_impl="xla", **LATENT_KW)
    assert calls == [] and not any(_build.LAUNCHES.values())


def test_cli_passes_attn_impl_to_generate(tiny_cli, monkeypatch):
    seen, generate = [], PCLI.generate
    monkeypatch.setattr(PCLI, "generate",
                        lambda pipe, **kw: seen.append(kw["attn_impl"]) or generate(pipe, **kw))
    args = ["--weights-path", tiny_cli["official"], "--output-type", "latent"]
    pallas = _cli_latents(tiny_cli, *args, "--attn-impl", "pallas").clone()
    auto = _cli_latents(tiny_cli, *args)
    assert seen == ["pallas", "auto"] and torch.equal(pallas, auto)
    with pytest.raises(SystemExit, match="--attn-impl xla"):
        PCLI.main([*tiny_cli["base"], "--attn-impl", "xla", "--device", "cuda"])


def test_server_passes_attn_impl_to_generate(jax_trees, monkeypatch):
    """The server's ``generate_kwargs`` carry ``attn_impl`` into every
    ``generate`` call, as the JAX CLI hands it to the JAX server."""
    _, ppipe = _pipelines(jax_trees, DISTILLED)
    seen, generate = [], PSV.generate
    monkeypatch.setattr(PSV, "generate",
                        lambda pipe, **kw: seen.append(kw.get("attn_impl")) or generate(pipe,
                                                                                       **kw))
    server = PSV.VideoGenerationServer(ppipe, [PSV.ShapeBucket(64, 96, 9, 3)],
                                       attn_impl="xla", max_sequence_length=16)
    req = PSV.Request(prompt_embeds=torch.zeros(1, 16, 64),
                      prompt_attention_mask=torch.ones(1, 16), output_type="latent",
                      bucket=PSV.ShapeBucket(64, 96, 9, 3))
    server.start()
    try:
        out = server.generate_sync(req, timeout=120)
    finally:
        server.stop()
    assert out.shape == (1, 18, 8) and seen == ["xla"]

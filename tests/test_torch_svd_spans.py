"""The SVD pipeline's spans (``utils/debug.py``) and its ``step_callback``:
a tiny request under ``recording()`` opens ``generate`` holding
``clip_encode``, ``vae_encode``, one ``denoise_step`` a step and
``vae_decode``; each step holds ``temporal``, ``matmul`` and ``conv``
spans, the resnets and transformer blocks theirs; off, nothing is kept."""

import pytest
import torch

from candle_video_tpu_torch.models.svd import clip as C
from candle_video_tpu_torch.models.svd import configs as F
from candle_video_tpu_torch.models.svd import pipeline as P
from candle_video_tpu_torch.models.svd import unet as U
from candle_video_tpu_torch.models.svd import vae as V
from candle_video_tpu_torch.utils import debug

torch.set_num_threads(2)

UNET = dict(in_channels=8, out_channels=4, block_out_channels=(32, 64), layers_per_block=1,
            cross_attention_dim=16, num_attention_heads=(2, 4), addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24)
VAE = dict(block_out_channels=(32, 64), latent_channels=4, layers_per_block=2)
CLIP = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            image_size=28, patch_size=14, projection_dim=16)
INF = P.SvdInferenceConfig(num_frames=3, num_inference_steps=2, seed=5)


@pytest.fixture(autouse=True)
def _empty_recorder():
    debug.drain()
    yield
    debug.drain()


@pytest.fixture(scope="module")
def pipe():
    cfg = F.SvdConfig(unet=F.SvdUnetConfig(**UNET), vae=F.SvdVaeConfig(**VAE),
                      clip=F.ClipEncoderConfig(**CLIP))
    g = torch.Generator().manual_seed(0)
    return P.SvdPipeline(cfg, U.init_random(cfg.unet, "cpu", torch.float32, g),
                         V.init_random(cfg.vae, "cpu", torch.float32, g),
                         C.init_random(cfg.clip, "cpu", torch.float32, g))


def _image():
    return torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(1)) * 2 - 1


def _within(span, root, by_id):
    while span.parent is not None:
        span = by_id[span.parent]
        if span.id == root.id:
            return True
    return False


def test_a_request_records_its_stages_steps_and_leaves(pipe):
    seen = []
    times = {}
    with debug.recording():
        video = P.generate(pipe, _image(), INF, stage_times=times,
                           step_callback=lambda i, n, lat: seen.append((i, n, lat.clone())))
    spans = debug.drain()
    by_id = {s.id: s for s in spans}
    (gen,) = [s for s in spans if s.name == "generate"]
    assert gen.parent is None and gen.attrs == {"rows": 1, "frames": 3}
    stages = [s for s in spans if s.parent == gen.id]
    assert [s.name for s in sorted(stages, key=lambda s: s.start_ns)] == \
        ["clip_encode", "vae_encode", "denoise_step", "denoise_step", "vae_decode"]
    steps = [s for s in stages if s.name == "denoise_step"]
    assert [s.attrs for s in steps] == [{"step": 0}, {"step": 1}]
    for step in steps:
        names = {s.name for s in spans if _within(s, step, by_id)}
        assert {"temporal", "matmul", "conv", "resnet", "attn1", "attn2", "ff"} <= names
    decode = next(s for s in stages if s.name == "vae_decode")
    names = {s.name for s in spans if _within(s, decode, by_id)}
    assert {"resnet", "temporal", "conv", "attn1", "matmul"} <= names
    assert set(times) == {"clip_encode", "vae_encode", "unet_steps", "vae_decode"}
    assert len(times["unet_steps"]) == 2
    # the callback: after each step, the latents as [B, F, 4, h, w]
    assert [(i, n) for i, n, _ in seen] == [(0, 2), (1, 2)]
    assert all(tuple(lat.shape) == (1, 3, 4, 16, 16) for _, _, lat in seen)
    assert video.shape == (3, 3, 32, 32)


def test_the_callback_gets_the_final_latents(pipe):
    seen = []
    lat = P.generate(pipe, _image(), INF, output_type="latent",
                     step_callback=lambda i, n, x: seen.append(x.clone()))
    assert torch.equal(seen[-1].reshape(lat.shape), lat)
    assert debug.drain() == []  # recording off: nothing kept

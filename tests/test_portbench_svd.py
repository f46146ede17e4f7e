"""The benchmark's SVD family on the CPU at a tiny preset: the port's UNet
(CFG rows), temporal decode, CLIP and a whole two-step request against the
plain reference (``portbench/reference/svd.py``) on seeded random weights
made by ``families/svd.py``; three faults the cell's check must catch; the
hand count of a UNet forward's FLOPs (``portbench/arith_svd.py``) against
``torch.utils.flop_counter`` at the published widths.

The tiny preset keeps every kind of block (two UNet levels with and
without transformers, the temporal decoder, a CLIP tower) and runs the
program in float32, so the program and the reference differ by summation
order alone."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from candle_video_tpu_torch.models.svd import pipeline as PP
from candle_video_tpu_torch.models.svd import unet as PU
from candle_video_tpu_torch.models.svd import vae as PV
from candle_video_tpu_torch.models.svd.clip import normalize_for_clip, resize_bilinear
from portbench import arith_svd, run
from portbench.families import svd as FAM
from portbench.reference import svd as REF

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CELL = "svd-576x1024x14"
SEED = 2 ** 31 + 77  # past 32 bits, as the benchmark's seeds are


def _published():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {c["name"]: c for c in bench["workloads"]}[CELL]
    config = json.loads((ROOT / "portbench" / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return config, mix


def tiny():
    """(config, mix): every width cut, the program in float32, a 64×64
    image to 3 frames in 2 steps with the published guidance ramp."""
    config, mix = copy.deepcopy(_published())
    config["unet"].update(block_out_channels=[32, 64], num_attention_heads=[1, 2],
                          cross_attention_dim=16, addition_time_embed_dim=8,
                          projection_class_embeddings_input_dim=24, layers_per_block=1)
    config["vae"].update(block_out_channels=[32, 64], layers_per_block=2)
    config["image_encoder"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=4, image_size=28, patch_size=14,
                                   projection_dim=16)
    config["precision"] = "f32"
    mix.update(height=64, width=64, num_frames=3, num_inference_steps=2)
    return config, mix


@pytest.fixture(scope="module")
def family():
    config, mix = tiny()
    raw = FAM.make_weights(config, SEED, "cpu")
    return config, mix, raw, FAM.build(config, raw, "cpu", lambda phase: None)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@torch.no_grad()
def test_unet_with_cfg_rows_matches_the_reference(family):
    """28 rows a step at full size: here the unconditional and conditional
    halves of 3 frames.  Both sides in float32; 1e-4 of the output's
    largest value covers summation order and the port's float32 sinusoid
    frequencies (the reference takes them in float64)."""
    config, mix, raw, pipe = family
    g = torch.Generator().manual_seed(1)
    f, rows = mix["num_frames"], 2 * mix["num_frames"]
    x = torch.randn(rows, 8, 16, 16, generator=g)
    ctx = torch.randn(rows, 1, 16, generator=g)
    ctx[:f] = 0.0
    t = torch.tensor([0.25 * np.log(30.0)] * 2, dtype=torch.float32)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2)
    got = pipe.unet(x, t[:1], ctx, ids, f)
    want = REF.unet(raw, config["unet"], REF.F32, x, t, ctx, ids, f)
    assert got.shape == want.shape == (rows, 4, 16, 16)
    assert _rel(got, want) <= 1e-4


@torch.no_grad()
def test_temporal_decode_matches_the_reference(family):
    """The decoder with its temporal resnets and ``time_conv_out``, float32
    both sides: 1e-4 of the largest value."""
    config, mix, raw, pipe = family
    z = torch.randn(3, 4, 32, 32, generator=torch.Generator().manual_seed(2))
    got = PV.decode(pipe.vae, z, 3)
    want = REF.vae_decode(raw, config["vae"], z / config["vae"]["scaling_factor"], 3, REF.F32)
    assert _rel(got, want) <= 1e-4


@torch.no_grad()
def test_clip_matches_the_reference(family):
    """The resize, the normalisation and the tower: 1e-4 of the largest
    embedding value (float32 both sides)."""
    config, _, raw, pipe = family
    image = torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(3)) * 2 - 1
    got = pipe.clip(normalize_for_clip(resize_bilinear((image + 1) / 2, 28, 28)))
    want = REF.clip_embed(raw, config["image_encoder"], image)
    assert _rel(got, want) <= 1e-4


def _request(family, i=0):
    """Request i through the family as the harness sends it: its video as
    uint8 and its final latents; then the reference's readings."""
    config, mix, raw, pipe = family
    tap = run.LatentTap({i})
    tap.armed, tap.first = True, i
    video = run.to_host_u8(FAM.request(pipe, config, mix, SEED, i, None, tap))
    ref_lat, noise = FAM.reference_latents(raw, config, mix, SEED, {"index": i}, "cpu")
    ref_video = FAM.reference_video(raw, config, mix, SEED, {"index": i}, ref_lat, "cpu")
    return dict(latent_rel_rms=run.latent_error(tap.kept.get(i), ref_lat, noise),
                **run.video_errors(video, ref_video))


def test_a_two_step_request_matches_the_reference(family):
    """Latents: float32 both sides, so 1e-6 of the way from the noise; the
    video: the program's is rounded to uint8 (RMS 0.29 of a level against
    a standard deviation of about 35), so 0.02."""
    got = _request(family)
    assert got["latent_rel_rms"] <= 1e-6
    assert got["rel_rms"] <= 0.02 and got["frame_rel_rms"] <= 0.02


class _FlatRamp:
    """``numpy`` for the pipeline, with the guidance ramp flattened to its
    mean."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def linspace(lo, hi, n, dtype=None):
        return np.full(n, (lo + hi) / 2, dtype)


def _invert_alpha(monkeypatch):
    blend = PU.AlphaBlender.forward
    monkeypatch.setattr(PU.AlphaBlender, "forward",
                        lambda self, s, t, temporal_first=False: blend(self, t, s, temporal_first))


FAULTS = {
    "time-mixer-alpha-inverted": _invert_alpha,
    "guidance-ramp-flattened": lambda mp: mp.setattr(PP, "np", _FlatRamp()),
    "time-conv-out-skipped": lambda mp: mp.setattr(PV, "temporal_conv", lambda conv, x, f: x),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_fails_the_cells_check(family, fault, monkeypatch):
    """Each fault reads above one of the cell's compared limits."""
    limits = json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json").read_text())
    FAULTS[fault](monkeypatch)
    got = _request(family)
    assert any(got[k] > limits[k] for k in limits["compared"]), got


def test_unet_flops_match_the_flop_counter_at_published_widths(monkeypatch):
    """One CFG step's UNet forward (28 rows of 8×72×128) on the meta device,
    attention through the plain einsum path so that the counter sees it:
    89.6 TFLOP, the hand count within 1%."""
    from torch.utils.flop_counter import FlopCounterMode

    from candle_video_tpu_torch.ops.attention import attention_xla_bf16

    config, mix = _published()
    monkeypatch.setattr(PU, "attention", lambda q, k, v, scale: attention_xla_bf16(q, k, v,
                                                                                   scale))
    rows, f = arith_svd.unet_rows(mix), mix["num_frames"]
    h, w = arith_svd.latent_hw(config, mix["height"], mix["width"])
    with torch.device("meta"):
        unet = PU.UNetSpatioTemporalConditionModel(FAM.port_config(config).unet)
        x = torch.empty(rows, 8, h, w, dtype=torch.bfloat16)
        ctx = torch.empty(rows, 1, 1024, dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as counter:
            unet(x, torch.empty(1), ctx, torch.empty(rows // f, 3), f)
    want = arith_svd.unet_forward_flops(config, rows, h, w, f)
    assert (rows, h, w) == (28, 72, 128)
    assert abs(want / counter.get_total_flops() - 1) <= 0.01
    assert 89.5e12 <= want <= 89.7e12


def test_self_attention_launches_a_step():
    """Five K6 calls (level 0, 5 heads of 64) and ten K1 calls (levels 1
    and 2) a UNet forward; the mid block's 144 tokens take the unfused
    path."""
    config, mix = _published()
    h, w = arith_svd.latent_hw(config, mix["height"], mix["width"])
    kernels = [arith_svd.attention_kernel(*c)
               for c in arith_svd.self_attention_calls(config, h, w)]
    assert (kernels.count("K6"), kernels.count("K1"), kernels.count(None)) == (5, 10, 1)
    bound = sum(arith_svd.self_attention_bound_s(t, hd, 28)
                for t, hd in arith_svd.self_attention_calls(config, h, w)
                if arith_svd.attention_kernel(t, hd))
    assert 17.0e-3 <= bound <= 18.0e-3


def test_the_reference_loads_nothing_of_the_program_or_jax():
    """``reference/svd.py`` and ``arith_svd.py`` in a fresh process: no
    module of the port, of JAX or of the JAX package is loaded."""
    import subprocess
    import sys

    code = ("import json, sys\nimport portbench.reference.svd, portbench.arith_svd\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "candle_video_tpu", "candle_video_tpu_torch"}


@pytest.mark.parametrize("part", list(FAM.PARTS))
def test_the_weights_are_the_checkpoints_names_and_shapes(part):
    """At the published widths the family makes exactly the state dict of
    the port's module, name for name and shape for shape (the loaders
    reshape what they copy, so a shape is checked here)."""
    from candle_video_tpu_torch.models.svd import clip as C

    from portbench import weights

    config, _ = _published()
    cfg = FAM.port_config(config)
    build = {"unet": lambda: PU.UNetSpatioTemporalConditionModel(cfg.unet),
             "vae": lambda: PV.AutoencoderKLTemporalDecoder(cfg.vae),
             "image_encoder": lambda: C.ClipVisionModelWithProjection(cfg.clip)}[part]
    spec = weights.Spec()
    FAM.PARTS[part](spec, config)
    made = {name.split("/", 1)[1]: shape for name, shape, *_ in spec.rows}
    assert all(name.startswith(part + "/") for name, *_ in spec.rows)
    with torch.device("meta"):
        module = build()
    assert made == {k: tuple(v.shape) for k, v in module.state_dict().items()}

"""The port's model registry (``models/registry.py``) against the JAX
package's, and its debug utilities (``utils/debug.py``): ``CVT_LOG``
gating, ``dump_tensor`` through the port's own safetensors writer and
reader, ``StageTimer`` and the ``CVT_PROFILE`` trace, and where the port
uses them: ``generate``'s ``stage_times`` and latent dumps, the server's
log records and traces."""

import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from candle_video_tpu.models import registry as JR
from candle_video_tpu_torch.models import registry as PR
from candle_video_tpu_torch.models.ltx_video import configs as PC
from candle_video_tpu_torch.models.ltx_video import transformer as TF
from candle_video_tpu_torch.models.ltx_video.loader import load_safetensors
from candle_video_tpu_torch.models.ltx_video.pipeline import LtxPipeline, generate
from candle_video_tpu_torch.models.svd.configs import SvdConfig
from candle_video_tpu_torch.models.svd.pipeline import SvdPipeline
from candle_video_tpu_torch.serving import Request, ShapeBucket, VideoGenerationServer
from candle_video_tpu_torch.utils import debug


def _tiny_config():
    return PC.LtxFullConfig(
        inference=PC.LtxInferenceConfig(),
        transformer=PC.LtxTransformerConfig(
            in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=8,
            cross_attention_dim=16, num_layers=1, caption_channels=16),
        vae=PC.LtxVaeConfig(), scheduler=PC.FlowMatchEulerSchedulerConfig())


def _tiny_pipeline():
    cfg = _tiny_config()
    transformer = TF.init_random(cfg.transformer, "cpu", torch.float32,
                                 generator=torch.Generator().manual_seed(0))
    return PR.build_pipeline("ltx_video", config=cfg, transformer=transformer)


TINY_REQUEST = dict(height=64, width=64, num_frames=9, num_inference_steps=2,
                    guidance_scale=1.0, stg_scale=0.0, output_type="latent")


def _embeds():
    return dict(prompt_embeds=torch.randn(1, 8, 16, generator=torch.Generator().manual_seed(1)),
                prompt_attention_mask=torch.ones(1, 8))


def test_registry_lists_the_jax_families_and_builds_the_ports_pipelines():
    assert PR.available() == JR.available() == ["ltx_video", "svd"]
    cfg = _tiny_config()
    transformer = TF.init_random(cfg.transformer, "cpu", torch.float32)
    ltx = PR.build_pipeline("ltx_video", config=cfg, transformer=transformer)
    assert type(ltx) is LtxPipeline and ltx.transformer is transformer
    unet = torch.nn.Module()
    svd = PR.build_pipeline("svd", config=SvdConfig(), unet=unet)
    assert type(svd) is SvdPipeline and svd.unet is unet
    for registry in (PR, JR):
        with pytest.raises(KeyError, match="unknown model family 'sora'"):
            registry.build_pipeline("sora")


def test_register_adds_a_family():
    PR.register("tiny_test_family")(lambda **kw: kw)
    try:
        assert "tiny_test_family" in PR.available()
        assert PR.build_pipeline("tiny_test_family", a=1) == {"a": 1}
    finally:
        PR._REGISTRY.pop("tiny_test_family")


@pytest.mark.parametrize("setting, logged", [(None, []), ("off", []), ("info", ["a"]),
                                             ("INFO", ["a"]), ("debug", ["a", "b"])])
def test_log_is_gated_by_cvt_log(monkeypatch, capsys, setting, logged):
    if setting is None:
        monkeypatch.delenv("CVT_LOG", raising=False)
    else:
        monkeypatch.setenv("CVT_LOG", setting)
    debug.log("a", "info record", step=3)
    debug.log("b", "debug record", level="debug")
    lines = capsys.readouterr().err.splitlines()
    recs = [json.loads(line) for line in lines]
    assert [r["stage"] for r in recs] == logged
    if recs:
        assert recs[0]["msg"] == "info record" and recs[0]["step"] == 3 and "ts" in recs[0]


def test_dump_tensor_round_trips_through_the_ports_reader(tmp_path, monkeypatch):
    monkeypatch.delenv("CVT_DUMP_TENSORS", raising=False)
    debug.dump_tensor("x", np.ones(3))
    assert not list(tmp_path.iterdir())

    monkeypatch.setenv("CVT_DUMP_TENSORS", str(tmp_path))
    x = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0)).bfloat16()
    debug.dump_tensor("latents", x, step=2)
    debug.dump_tensor("noise", np.arange(6, dtype=np.float64).reshape(2, 3))
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 2
    assert files[0].endswith("_latents_step2.safetensors")
    assert files[1].endswith("_noise.safetensors")
    assert int(files[1][:3]) == int(files[0][:3]) + 1  # numbered in call order
    got = load_safetensors(os.path.join(tmp_path, files[0]))["tensor"]
    assert got.dtype == torch.float32
    assert torch.equal(got, x.float())
    got = load_safetensors(os.path.join(tmp_path, files[1]))["tensor"]
    assert torch.equal(got, torch.arange(6, dtype=torch.float32).reshape(2, 3))


def test_stage_timer_report():
    t = debug.StageTimer()
    with t.stage("encode"):
        pass
    with t.stage("denoise"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with t.stage("encode"):
        pass
    rep = t.report()
    assert set(rep) == {"encode", "denoise", "_shares"}
    assert all(rep[k] >= 0.0 for k in ("encode", "denoise"))
    assert set(rep["_shares"]) == {"encode", "denoise"}
    assert all(v.endswith("%") for v in rep["_shares"].values())


def test_a_disabled_stage_timer_records_nothing():
    t = debug.StageTimer(enabled=False)
    with t.stage("encode"):
        pass
    assert t.stages == {}


def test_generate_stage_times_and_tensor_dumps(tmp_path, monkeypatch):
    """``generate(stage_times=)`` reads its stages off a ``StageTimer``;
    ``CVT_DUMP_TENSORS`` receives the initial and the final latents."""
    monkeypatch.setenv("CVT_DUMP_TENSORS", str(tmp_path))
    times = {}
    final = generate(_tiny_pipeline(), seed=3, stage_times=times, **TINY_REQUEST, **_embeds())
    assert set(times) == {"t5_encode", "denoise_steps", "total"}
    assert len(times["denoise_steps"]) == 2
    assert 0.0 <= times["t5_encode"] <= times["total"]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert [f[4:] for f in files] == ["initial_latents.safetensors",
                                      "final_latents.safetensors"]
    got = load_safetensors(os.path.join(tmp_path, files[1]))["tensor"]
    assert torch.equal(got, final)
    got = load_safetensors(os.path.join(tmp_path, files[0]))["tensor"]
    assert got.shape == final.shape and not torch.equal(got, final)


def test_server_logs_and_traces_each_served_call(tmp_path, monkeypatch, capsys):
    """With ``CVT_LOG=info`` the server logs one record a served call, and
    with ``CVT_PROFILE`` writes one trace a served call."""
    monkeypatch.setenv("CVT_LOG", "info")
    monkeypatch.setenv("CVT_PROFILE", str(tmp_path))
    bucket = ShapeBucket(64, 64, 9, 2)
    server = VideoGenerationServer(_tiny_pipeline(), [bucket])
    server.generate_sync(Request(bucket=bucket, seed=4, output_type="latent", **_embeds()))
    recs = [json.loads(line) for line in capsys.readouterr().err.splitlines()]
    serve = [r for r in recs if r["stage"] == "serve"]
    assert len(serve) == 1
    assert serve[0]["bucket"] == [64, 64, 9, 2, False] and serve[0]["rows"] == 1
    assert serve[0]["ms"] == server.stats()["buckets"][str(bucket.key())]["last_ms"]
    assert [p.name for p in tmp_path.iterdir()] == ["serve_00000_b1.trace.json"]


def test_trace_is_a_no_op_without_cvt_profile_and_writes_a_trace_with_it(tmp_path,
                                                                        monkeypatch):
    monkeypatch.delenv("CVT_PROFILE", raising=False)
    with debug.trace("off"):
        torch.ones(8) + 1
    assert not list(tmp_path.iterdir())

    out = tmp_path / "profile"
    monkeypatch.setenv("CVT_PROFILE", str(out))
    with debug.trace("step"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = out / "step.trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_mock_tokenizer_ids_are_the_same_in_every_process():
    """The port's mock tokenizer hashes words with CRC-32, so a prompt's ids
    do not change with Python's per-process hash salt."""
    script = ("from candle_video_tpu_torch.utils.tokenizer import MockTokenizer; "
              "ids, mask = MockTokenizer(vocab_size=128).encode_batch(['a red fox'], 8); "
              "print(ids.tolist(), mask.tolist())")
    runs = {subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                           check=True, timeout=120,
                           env={**os.environ, "PYTHONHASHSEED": salt}).stdout
            for salt in ("1", "2")}
    ids = [zlib.crc32(w.encode("utf-8")) % 126 + 1 for w in ("a", "red", "fox")]
    assert runs == {f"{[ids + [1, 0, 0, 0, 0]]} {[[1, 1, 1, 1, 0, 0, 0, 0]]}\n"}

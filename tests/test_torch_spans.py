"""The port's spans (``utils/debug.py``): off, a span reads no clock and
keeps nothing; on, spans nest by thread and ``generate`` and the server open
theirs.  On a hand-made trace, the benchmark's ``portbench/spans.py`` gives
each kernel and idle gap the innermost span open on the launching thread."""

import threading
import time

import pytest
import torch

from candle_video_tpu_torch.models.ltx_video import configs as PC
from candle_video_tpu_torch.models.ltx_video import transformer as TF
from candle_video_tpu_torch.models.ltx_video import vae as V
from candle_video_tpu_torch.models.ltx_video.pipeline import LtxPipeline, generate
from candle_video_tpu_torch.serving import Request, ShapeBucket, VideoGenerationServer
from candle_video_tpu_torch.utils import debug
from candle_video_tpu_torch.utils.debug import SpanRecord
from portbench import spans as S
from portbench.spans import Kernel

GET_TIMEOUT = 300
TF_CFG = dict(in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=8,
              cross_attention_dim=16, num_layers=2, caption_channels=16)
VAE_CFG = dict(latent_channels=8, decoder_block_out_channels=(8, 16),
               decoder_spatiotemporal_scaling=(True, True), decoder_layers_per_block=(1, 1, 1),
               patch_size=2, patch_size_t=1, decoder_upsample_residual=(True, True),
               decoder_upsample_factor=(2, 2), timestep_conditioning=True,
               decoder_causal=False, spatial_compression_ratio=8, temporal_compression_ratio=4)
REQUEST = dict(height=64, width=64, num_frames=9, num_inference_steps=3, guidance_scale=1.0,
               stg_scale=0.0, skip_block_list=(), decode_timestep=(0.05,),
               decode_noise_scale=(0.025,))
LEAF_NAMES = {"matmul", "attn.kernel", "attn.cross", "w4.dequant", "w8.dequant", "conv"}


@pytest.fixture(autouse=True)
def _empty_recorder():
    debug.drain()
    yield
    debug.drain()


@pytest.fixture(scope="module")
def pipe():
    cfg = PC.LtxFullConfig(inference=PC.LtxInferenceConfig(),
                           transformer=PC.LtxTransformerConfig(**TF_CFG),
                           vae=PC.LtxVaeConfig(**VAE_CFG),
                           scheduler=PC.FlowMatchEulerSchedulerConfig())
    g = torch.Generator().manual_seed(0)
    return LtxPipeline(config=cfg,
                       transformer=TF.init_random(cfg.transformer, "cpu", torch.float32, g),
                       vae=V.init_random(cfg.vae, "cpu", torch.float32, generator=g))


def _embeds(seed):
    g = torch.Generator().manual_seed(seed)
    return dict(prompt_embeds=torch.randn(1, 8, 16, generator=g),
                prompt_attention_mask=torch.ones(1, 8))


def _ancestors(span, by_id):
    out = []
    while span.parent is not None:
        span = by_id[span.parent]
        out.append(span)
    return out


def _no_clock(monkeypatch):
    def stop(*_):
        raise AssertionError("a clock was read")

    monkeypatch.setattr(time, "perf_counter_ns", stop)
    monkeypatch.setattr(time, "perf_counter", stop)


def test_a_span_off_reads_no_clock_and_keeps_nothing(monkeypatch):
    _no_clock(monkeypatch)
    with debug.span("matmul"), debug.span("denoise_step", step=0) as sp:
        assert sp is None  # the shared no-op context
    assert debug.span("a") is debug.span("b", x=1)
    debug.since("serve.queue_wait", debug.mark(), request_id=1)
    assert debug.drain() == []


def test_generate_off_reads_no_clock(pipe, monkeypatch):
    """Without ``stage_times`` and outside ``recording()`` neither
    ``generate`` nor its denoise loop reads the clock."""
    _no_clock(monkeypatch)
    generate(pipe, seed=1, output_type="latent", **REQUEST, **_embeds(1))
    assert debug.drain() == []


def test_spans_nest_by_thread_with_parent_ids():
    with debug.recording():
        with debug.span("outer", step=3):
            with debug.span("mid"):
                with debug.span("leaf"):
                    pass
            with debug.span("sibling"):
                pass
        other = threading.Thread(target=lambda: debug.span("alone").__enter__().__exit__())
        other.start()
        other.join(timeout=30)
    assert not other.is_alive()
    spans = debug.drain()
    assert debug.drain() == []
    by_name = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["leaf", "mid", "sibling", "outer", "alone"]
    assert by_name["outer"].parent is None and by_name["outer"].attrs == {"step": 3}
    assert by_name["mid"].parent == by_name["sibling"].parent == by_name["outer"].id
    assert by_name["leaf"].parent == by_name["mid"].id
    assert by_name["alone"].parent is None
    assert {s.tid for s in spans if s.name != "alone"} == {threading.get_ident()}
    assert by_name["alone"].tid != threading.get_ident()
    assert len({s.id for s in spans}) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
    outer, leaf = by_name["outer"], by_name["leaf"]
    assert outer.start_ns <= leaf.start_ns <= leaf.end_ns <= outer.end_ns


def test_a_span_object_times_itself_off_and_a_mark_spans_threads():
    with debug.Span("serve.call", rows=2) as call:
        assert call.seconds() >= 0.0
    assert call.seconds() == (call.end_ns - call.start_ns) / 1e9
    assert debug.drain() == []
    with debug.recording():
        start = debug.mark()
        done = threading.Thread(target=debug.since, args=("serve.queue_wait", start),
                                kwargs=dict(request_id="r"))
        done.start()
        done.join(timeout=30)
    (wait,) = debug.drain()
    assert wait.name == "serve.queue_wait" and wait.attrs == {"request_id": "r"}
    assert wait.tid is None and wait.parent is None and wait.start_ns == start <= wait.end_ns


def test_stage_timer_stages_are_spans_with_or_without_times():
    for enabled in (False, True):
        timer = debug.StageTimer(enabled=enabled)
        with debug.recording(), timer.stage("vae_decode", mode={"tail_stream_chunks": 0}):
            pass
        (sp,) = debug.drain()
        assert sp.name == "vae_decode" and sp.attrs == {"mode": {"tail_stream_chunks": 0}}
        assert set(timer.stages) == ({"vae_decode"} if enabled else set())


def test_generate_records_its_stages_steps_and_leaves(pipe):
    times = {}
    with debug.recording():
        video = generate(pipe, seed=2, stage_times=times, **REQUEST, **_embeds(2))
    spans = debug.drain()
    assert video.shape == (1, 3, 9, 64, 64)
    assert set(times) == {"t5_encode", "denoise_steps", "vae_decode", "decode_mode", "total"}
    assert len(times["denoise_steps"]) == REQUEST["num_inference_steps"]
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.name == "generate"]
    assert root.parent is None and root.attrs == {"rows": 1, "frames": 9}
    for name in ("t5_encode", "prepare", "vae_decode"):
        (s,) = [s for s in spans if s.name == name]
        assert s.parent == root.id
    steps = [s for s in spans if s.name == "denoise_step"]
    assert [s.attrs["step"] for s in steps] == list(range(REQUEST["num_inference_steps"]))
    assert all(s.parent == root.id for s in steps)
    (decode,) = [s for s in spans if s.name == "vae_decode"]
    assert decode.attrs["mode"] == times["decode_mode"]
    in_step = {}
    for s in spans:
        up = _ancestors(s, by_id)
        if s.name in LEAF_NAMES and any(a.name == "denoise_step" for a in up):
            in_step[s.name] = in_step.get(s.name, 0) + 1
            assert not any(a.name in LEAF_NAMES for a in up)  # leaves do not nest
    # per step: 2 blocks of 10 block linears, proj_in, proj_out, the caption
    # projection's 2 and the timestep embedding's 3 on the plain path
    steps_n = REQUEST["num_inference_steps"]
    assert in_step == {"matmul": steps_n * (2 * 10 + 7), "attn.cross": steps_n * 2}
    convs = [s for s in spans if s.name == "conv"]
    assert convs and all(decode in _ancestors(s, by_id) for s in convs)
    assert {"resnet", "upsampler"} <= {a.name for s in convs for a in _ancestors(s, by_id)}
    for s in steps:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns


def test_a_served_batch_records_its_queue_waits_and_one_call(pipe):
    bucket = ShapeBucket(64, 64, 9, 2)
    server = VideoGenerationServer(pipe, [bucket], max_batch=2)
    with debug.recording():
        outs = [server.submit(Request(bucket=bucket, seed=5 + i, output_type="latent",
                                      request_id=name, **_embeds(5 + i)))
                for i, name in enumerate(("first", "second"))]
        server.start()
        try:
            results = [q.get(timeout=GET_TIMEOUT) for q in outs]
        finally:
            server.stop()
    assert all(not isinstance(r, Exception) for r in results)
    spans = debug.drain()
    waits = [s for s in spans if s.name == "serve.queue_wait"]
    assert sorted(w.attrs["request_id"] for w in waits) == ["first", "second"]
    (call,) = [s for s in spans if s.name == "serve.call"]
    assert call.attrs == {"rows": 2, "request_ids": ["first", "second"]}
    assert call.tid != threading.get_ident()  # the worker's
    assert all(w.end_ns <= call.start_ns for w in waits)
    kids = [s.name for s in spans if s.parent == call.id]
    assert kids == ["serve.rows", "generate", "serve.handoff"]
    # the stats take the call's time off its span, before the handoff
    last_ms = server.stats()["buckets"][str(bucket.key())]["last_ms"]
    assert 0.0 < last_ms <= (call.end_ns - call.start_ns) / 1e6 + 0.05


# ---------------------------------------------------------------------------
# attribution on a hand-made trace
# ---------------------------------------------------------------------------

MAIN, WORKER = 0x7F5DCB97D300, 0x7F5A83FFF6C0  # pthread ids: the trace keeps 32 bits
OFFSET = 1_000_000  # trace ns less perf_counter ns


def _span(sid, parent, name, tid, a, b):
    return SpanRecord(sid, parent, name, tid, a, b, {})


SPANS = [
    _span(1, None, "generate", MAIN, 0, 1000),
    _span(2, 1, "denoise_step", MAIN, 100, 500),
    _span(3, 2, "attn1", MAIN, 120, 300),
    _span(4, 3, "matmul", MAIN, 130, 150),
    _span(5, 3, "attn.kernel", MAIN, 200, 220),
    _span(6, 2, "w4.dequant", MAIN, 320, 340),
    _span(7, 1, "vae_decode", MAIN, 600, 900),
    _span(8, 7, "conv", MAIN, 650, 700),
    _span(9, None, "serve.call", WORKER, 0, 1000),
    _span(10, None, "serve.queue_wait", None, 0, 1000),
]


def _kernel(name, start, dur, launch, tid):
    if tid is not None:  # a launch's thread, as the trace's 32-bit signed id
        tid &= 0xFFFFFFFF
        tid -= (1 << 32) if tid >= 1 << 31 else 0
    return Kernel(name, start + OFFSET, dur, None if launch is None else launch + OFFSET, tid)


KERNELS = [  # device start and duration, then the launch: all in host ns
    _kernel("gemm", 160, 30, 140, MAIN),  # matmul inside attn1
    _kernel("rms_norm", 150, 10, 125, MAIN),  # attn1's glue
    _kernel("flash", 230, 50, 210, MAIN),  # attn.kernel
    _kernel("dequant", 340, 20, 330, MAIN),  # w4.dequant
    _kernel("step_add", 410, 10, 400, MAIN),  # the step's own glue
    _kernel("conv", 670, 40, 660, MAIN),  # conv
    _kernel("pad", 650, 10, 640, MAIN),  # the decode's glue
    _kernel("copy", 720, 5, 50, WORKER),  # another thread's span
    _kernel("orphan", 1510, 5, 1500, MAIN),  # launched after every span closed
    _kernel("no_launch", 1520, 5, None, None),  # no launch event in the trace
]


def test_each_kernel_goes_to_the_innermost_span_on_its_thread():
    owners = S.attribute(KERNELS, SPANS, OFFSET)
    assert owners == [4, 3, 5, 6, 2, 8, 7, 9, None, None]


def test_the_split_of_each_step_and_decode_by_leaf_and_glue():
    owners = S.attribute(KERNELS, SPANS, OFFSET)
    assert S.split(KERNELS, owners, SPANS, "denoise_step") == {
        2: {"matmul": 30, "glue:attn1": 10, "attention": 50, "dequant": 20,
            "glue:denoise_step": 10}}
    assert S.split(KERNELS, owners, SPANS, "vae_decode") == {
        7: {"conv": 40, "glue:vae_decode": 10}}


def test_idle_gaps_go_to_the_span_open_on_the_next_kernels_thread():
    gaps = S.idle_gaps(KERNELS, SPANS, OFFSET, 100 + OFFSET, 1600 + OFFSET)
    gaps = [(a - OFFSET, n, sid) for a, n, sid in gaps]
    # the device waits from 100 for a kernel of the step, which has just
    # opened; from 190 for the attention kernel, while attn1 is still open
    assert gaps[:3] == [(100, 50, 2), (190, 40, 3), (280, 60, 3)]
    assert gaps[5:8] == [(660, 10, 8), (710, 10, 9), (725, 785, 7)]
    assert gaps[-2:] == [(1515, 5, None), (1525, 75, None)]
    assert sum(n for _, n, _ in gaps) + sum(k.dur_ns for k in KERNELS) == 1500
    assert S.innermost(SPANS, [(MAIN, 135), (WORKER, 500), (MAIN, 5000), None]) == \
        [4, 9, None, None]


def test_the_summary_of_a_window():
    out = S.summarize(KERNELS, SPANS, OFFSET, 100 + OFFSET, 1600 + OFFSET)
    assert out["kernels"] == len(KERNELS) and out["kernel_s"] == pytest.approx(185e-9)
    assert out["unclaimed_share"] == pytest.approx(10 / 185)  # "orphan", "no_launch"
    step = out["denoise_step"]
    assert (step["count"], step["launches"]) == (1, 5)
    assert step["ms"] == pytest.approx(120e-6) and step["glue_ms"] == pytest.approx(20e-6)
    assert out["vae_decode"]["parts_ms"] == pytest.approx({"conv": 40e-6,
                                                          "glue:vae_decode": 10e-6})
    assert out["t5_encode"] == dict(count=0, ms=0.0, glue_ms=0.0, launches=0.0, parts_ms={})
    assert out["idle_ms_by_span"]["vae_decode"] == pytest.approx(785e-6)
    assert out["leaf_spans_without_kernel"] == {n: [0, 1] for n in
                                               ("attn.kernel", "conv", "matmul", "w4.dequant")}


def test_refined_idle_labels_sum_to_the_harness_labels():
    def label(t):  # the harness's labeller: inside the request, or not
        return "inside_requests" if OFFSET <= t < 1000 + OFFSET else "between_requests"

    refined = dict(S.refined_idle(KERNELS, SPANS, OFFSET, 100 + OFFSET, 1600 + OFFSET, label))
    gaps = S.idle_gaps(KERNELS, SPANS, OFFSET, 100 + OFFSET, 1600 + OFFSET)
    assert refined == pytest.approx({
        "inside_requests:denoise_step": 330e-9, "inside_requests:attn1": 100e-9,
        "inside_requests:conv": 10e-9, "inside_requests:serve.call": 10e-9,
        "inside_requests:vae_decode": 785e-9, "between_requests": 80e-9})
    for old in ("inside_requests", "between_requests"):
        total = sum(n for a, n, _ in gaps if label(a) == old) / 1e9
        assert sum(v for k, v in refined.items()
                   if k.split(":")[0] == old) == pytest.approx(total)
    assert all(":" in k for k in refined if k.startswith("inside_"))


def test_a_served_calls_kernels_by_its_child_span():
    spans = SPANS + [_span(11, 9, "serve.rows", WORKER, 10, 100),
                     _span(12, 9, "generate", WORKER, 100, 800),
                     _span(13, 12, "matmul", WORKER, 200, 300)]
    kernels = [_kernel("draw", 30, 5, 20, WORKER), _kernel("gemm", 250, 30, 210, WORKER),
               _kernel("glue", 400, 7, 390, WORKER), _kernel("put", 900, 2, 850, WORKER)]
    owners = S.attribute(kernels, spans, OFFSET)
    assert owners == [11, 13, 12, 9]
    assert S.by_child(kernels, owners, spans, "serve.call") == {
        9: {"serve.rows": 5, "generate": 37, "serve.call": 2}}


def test_span_split_reads_a_tiny_served_run(monkeypatch):
    """``portbench/span_split.py`` on the served cell cut to a CPU size: the
    queue waits of the first half's calls, their parts, the steps' host
    spans and the idle labels (no CUDA kernels here, so no split)."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1] / "portbench" / "tests"))
    import tiny

    from portbench import span_split

    cell, config, mix, *_ = tiny.cell("ltx2b-serve-poisson")
    out = span_split.traced(cell, config, mix, 2 ** 31 + 21, 6.0, device="cpu")
    assert debug.RECORDING == 0 and debug.drain() == []  # recording is off again
    served = out["serve"]
    assert served["calls"] >= 1 and served["requests"] >= served["calls"]
    assert served["queue_wait_s"] >= 0.0 and served["call_ms"] > 0.0
    assert served["part_host_ms"]["generate"][1] == served["calls"]
    assert out["metrics"] == {"queue_wait_s.serve": served["queue_wait_s"]}
    steps = config["inference"]["num_inference_steps"]
    assert out["untraced_steps"] >= steps and out["step_launch_ms"] > 0.0
    total = {}
    for label, s in out["idle_gaps_refined"]:
        total[label.split(":")[0]] = total.get(label.split(":")[0], 0.0) + s
    assert total == pytest.approx(dict(out["idle_gaps"]))

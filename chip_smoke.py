"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``candle_video_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main paths' shapes (K1
at the served batch of two, the 13B-dev request's three rows and one 13B
tensor-parallel rank's 16 heads too; all
eight, and R1, also as copies broken on purpose, which must fail; K3 and K4 also at
qblocks the kernel is not built for, on their dequant route; the W4
transient dequant kernel ``csrc/w4_dequant.cu`` at the 13B DiT's shapes, bit
for bit, beside its byte bound, and a copy broken on purpose), then
drives on random weights, checking the outputs and the kernels' launch
counts of every request:

- the ``0.9.8-2b-distilled`` path at 512x768x97 (T5-XXL int8 → 28-layer 2B
  DiT on K1, 7 steps → VAE decode): a cold and a warm request with
  per-stage times and one more warm request timed end to end only;
  ``generate(attn_impl="xla")`` refused before any launch and ``"pallas"``
  bit-equal to the default; the requests decode in the default
  channels-last layout (``CVT_DECODER_LAYOUT``); then the last request's
  latents decoded again in both layouts, each on cuDNN and with every
  eligible decoder conv on K8 (``CVT_CONV3D_IMPL=igemm``; no copy before
  K8 in channels-last), against the NCDHW cuDNN decode;
- R1 (``csrc/threefry_normal.cu``: ``jax.random.normal`` drawn on the card)
  against its plain version at the paths' draws (the decode noise, a
  served batch of two rows, an anchor's bf16 posterior, the SVD image
  noise, one bf16 injection), beside the host NumPy draw it replaced, and
  a copy broken on purpose; the 2B request's decode noise on R1 (one
  launch), and a full-width 2B decoder with noise injected in every
  resnet, dense against the streamed tail (two R1 launches a resnet);
- the ``0.9.6-2b-distilled`` stochastic preset as published (512x768x97,
  8 stochastic steps, the int8 T5): a cold and a warm request, every step's
  noise and the decode noise on R1, against the same request on the plain
  version's draws;
- the ``0.9.8-2b-distilled`` image-to-video request at 512x768x97 (a random image as
  a hard anchor on frame 0 through the VAE encoder, every token at its own
  timestep through the DiT's AdaLN): a warm-up and a timed request, the
  anchor's latent frame held bit for bit, and a two-anchor request (frame
  0, and the last latent frame at strength 0.9); then a 97-frame encode in
  both layouts, on cuDNN and with every eligible encoder conv on K8, and
  the full-size tiled decode against the dense one; a tiny image-to-video slice and tiny tiled
  encode and decode against the CPU before them;
- the same request on the W8A8 DiT tier (``quantize_transformer_w8a8``:
  every block linear on K7) against the bf16 request;
- the same request through the sequence-parallel path in a ring of one
  (``generate(sp_mesh=make_mesh(sp=1))`` in a one-rank NCCL group): every
  DiT self-attention on K5, none on K1, against the request without it;
- the same preset's long clip, 512x768x257 (S = 12672: every DiT
  self-attention on K2): a cold and a warm request, ``vae.decode(auto_mode=
  True)`` against the mode the policy names and a request with
  ``vae_auto_decode=False``, then the exact decode modes (dense, tail
  stream, ups-split stream; the full stream on a 128x192x369 clip) against
  the dense decode, with their peak memory;
- the serving runtime (``serving.VideoGenerationServer``) on the 2B preset
  at 512x768x97, 7 steps, embeddings injected, the streamed tail in 2
  chunks: a burst of 6 requests at ``max_batch=2`` and the same burst at
  ``max_batch=1`` (videos/min, p50 and p95 sojourn; every batched
  request's initial latents bit-equal to its single request's, its video
  against it), a burst mixing in the 256x384x33 bucket, and a string
  prompt through the T5 and again from the embedding cache;
- the ``0.9.8-13b-distilled`` W4A16 resident path at 512x768x97
  (Q4_K-form T5-XXL on K4 → 48-layer 13B DiT with int4 block linears →
  VAE decode with the streamed tail in 6 chunks): a cold and a warm request;
  then the ``0.9.8-13b-dev`` request as published on the same weights
  (guidance 8, STG 4.0, rescale 0.5, skip blocks 11, 25, 35, 39, a negative
  prompt: three rows a step through K1, K4 and the transient dequant
  route), 30 steps; every transient-route call one ``w4_dequant`` launch;
- the 13B W8A16 tier (int8 T5 → 13B DiT with int8 block linears): one
  request, then the 13B-dev request cut to 4 steps;
- the dense 13B in bf16 through the multi-GPU paths on the one card:
  pipeline parallelism in a one-rank NCCL group (the 13B-dev request, 4
  steps, without the mesh and under ``generate(pp_mesh=
  make_pipeline_mesh(1), pp_microbatches=3)``: K1 at B = 1 three times a
  layer), then tensor parallelism at tp=2 as two rank processes sharing
  the card in a gloo group (the distilled request, 7 steps: each rank's
  K1 at 16 heads; the ranks bit-equal, rank 0 against the request without
  the mesh, and one forward against the unsharded one);
- a full-size official-layout 2B checkpoint (DiT, VAE decoder and
  encoder) written by the port's writer and run through the CLI
  (``--weights-path``) in bf16, in bf16 with ``--image``, ``--dit-int8`` and
  ``--dit-int4`` against the in-memory pipeline on the same weights, and a
  full-width T5 HF directory of 2 of the 24 blocks;
- a full-size T5-XXL GGUF (24 blocks in Q8_0, payloads drawn field by
  field) through the port's inspection tool (``list``, ``dump-embeds``)
  and the CLI: the dense and keep-quantized loads and encodes, ``--t5-gguf``
  against ``--embeddings-file`` of the dumped file on the 2B preset
  (latents bit-equal), and the ``0.9.5-2b`` preset as published (40 steps,
  CFG 3 + STG 1 + rescale 0.7, skip block 19, three DiT rows a step) with
  the T5 kept quantized on K3; then a Q5_K_M file of 2 of the 24 blocks,
  K3 at qblocks 32 and 16 on its payloads;
- SVD image-to-video at its published request, 576x1024x14 with CFG (CLIP
  → noise-augmented VAE encode → 25 v-prediction Euler steps of the UNet at
  batch 28, the level-0 self-attention on K6 and levels 1-2 on K1 →
  temporal VAE decode): a 2-step warm-up request and the 25-step one, after
  K6 against its plain version (and a copy broken on purpose) and a tiny SVD
  slice against the CPU;

and runs the CLI for the 2B and the 13B int4 paths.  Run from the
repository root:

    python3 chip_smoke.py

``python3 chip_smoke.py --guided-drift`` builds the kernels and runs only
the guided tiny slices (dense and int4) over twelve prompts: how far the
card's bf16 run and the CPU's drift from f32 under the 13B-dev guidance,
the readings behind ``CFG_DRIFT``.

The last line is ``{"ok": true, "device": {...}}``; any failed phase raises
and the exit code is not 0.  Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "output", "chip_smoke")  # gitignored
# Limits near the readings on an H100, so that a kernel that drops the
# padded-key mask or rounds W in another order fails them.  K1: rel 1.7e-3 to
# 1.8e-3 against 4e-3; elementwise the two bf16 outputs differ by at most one
# bf16 ulp, 2^-7 relative, so |got - want| <= 8e-3 * max(1, |want|).
# K3: rel 4e-5 to 7e-5 against 2e-4.  K4 dequantizes in K3's order (f32,
# one bf16 rounding) and shares its limit; a K4 that rounds q·s and + m to
# bf16 in turn, as the DiT's large-M route does, reads ~4e-3.
K1_TOL = dict(scaled=8e-3, rel=4e-3)   # bf16 output and bf16 p for P·V
K2_TOL = dict(scaled=8e-3, rel=4e-3)   # K1's limits: the same bf16 roundings
K6_TOL = dict(scaled=8e-3, rel=4e-3)   # K1's limits: the same bf16 roundings
# K5 against its plain version: acc/l in bf16 terms at K1's limits (p rounds
# to bf16 against the running max, the plain version against the chunk's);
# acc, which carries that bf16 p, rel <= 4e-3 in norm (readings 1.3e-3 to
# 1.5e-3).  m and l see no bf16 rounding, only f32 summation order: readings
# 4e-7 to 8e-7, limits 1e-5, so a kernel that carries either a little wrong
# fails.
K5_TOL = dict(scaled=8e-3, rel=4e-3, m_scaled=1e-5, l_rel=1e-5, acc_rel=4e-3)
# Streamed against dense video on [0, 255], PSNR in dB.  Exact in f32 (the
# CPU tests hold them to 1e-5); in bf16 cuDNN may pick other algorithms for
# other T extents.  Readings on an H100: the tail and ups-split streams 92.4
# dB on the 257f latents; the full stream 45.5 dB in bf16, where it
# streams every stage of a deep random-weight decoder, and far higher in f32.
DECODE_PSNR_DB = dict(tail=80.0, full_bf16=42.0, full_f32=80.0)
# the card's dense bf16 and int8 tensor-core peaks and memory rate (H100 SXM
# data sheet, 700 W)
PEAK_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12
# R1 against its plain version on the card: both round each step of the
# uniform and the erfinv on its own and call the card's log1pf, so they are
# expected to agree bit for bit; the limits let one float32 ulp through in
# float32 (well inside the CPU tests' 1e-5 against the host NumPy draw) and
# one bfloat16 ulp in bfloat16.  The broken copy (one rotation constant of
# the cipher changed) draws another stream: |d| ~ 1.
R1_TOL = dict(f32_abs=1e-5, bf16_scaled=8e-3)
R1_BREAK = ("{{13, 15, 26, 6}, {17, 29, 16, 24}}", "{{13, 15, 26, 7}, {17, 29, 16, 24}}")
# the card's INT32 rate, 64 lanes on each of 132 SMs at the 1.98 GHz boost
# clock (H100 SXM), and the int32 operations R1 spends on a value (20
# rounds of add, rotate and xor, 5 key injections of two adds, the counter
# split, the xor of the two words and the bit extraction)
PEAK_INT32_OPS, R1_OPS_PER_VALUE = 132 * 64 * 1.98e9, 80
K3_TOL = dict(rel=2e-4)                 # bf16 output rounding
K4_TOL = dict(rel=2e-4)                 # bf16 output rounding
SLICE_TOL = dict(latent_rel=2e-2, video_psnr=35.0)  # bf16 card run vs f32 plain run
SLICE_PROMPT = "a red fox in the snow"
GUIDED_DRIFT_PROMPTS = (SLICE_PROMPT, "a cat walking on grass", "waves on a beach at dusk",
                        "a city street in the rain", "an old man reading a book",
                        "fireworks over a lake", "a dog running in a park",
                        "clouds over mountains", "a koi pond in the rain",
                        "a train crossing a bridge", "a candle flickering",
                        "birds over a field")
# The tiny SVD slice with CFG: the 1 -> 3 ramp scales up the random-weight
# UNet's bf16 rounding, so bf16 alone drifts past 2e-2 from f32.  Readings on
# an H100 against the CPU f32 run: the card 2.717e-2, the CPU's bf16 run of
# the plain versions 2.732e-2 (1.543e-2 and 1.545e-2 without CFG); the two
# bf16 runs differ from each other by 2.806e-2, as the kernels round p in
# another order.  The tiny LTX slice under the 13B-dev guidance (CFG 8, STG
# 4, rescale 0.5, 30 steps) does the same to the DiT's rounding: over twelve
# prompts the CPU's bf16 run drifts 9.2e-3 to 7.5e-2 from f32 (the int4
# slice 5.8e-3 to 6.6e-3), and the card 0.975x to 1.019x as far.  Under CFG
# the card may drift 1.25x as far as the CPU's bf16 run on the same inputs.
CFG_DRIFT = 1.25
RESULTS: dict = {}


def log(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak of their type (bf16 unless ``peak`` says otherwise) and the
    bytes (each input read once, each output written once) over the memory
    rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, s, kv, h, d, with_bias, with_rope) -> dict:
    hd = h * d
    nbytes = 2 * (2 * b * s * hd + 2 * b * kv * hd)  # q, out, k, v in bf16
    nbytes += 4 * b * kv * with_bias + 2 * 4 * s * hd * with_rope  # f32 bias, cos, sin
    return bound(4.0 * b * h * s * kv * d, nbytes)


def sdpa_ms(q, k, v, h, scale, bias, rope):
    """One ``scaled_dot_product_attention`` call on the [B,H,S,D] views, q
    rotated beforehand: the library yardstick, used nowhere in the port."""
    from candle_video_tpu_torch.ops.rope import apply_rotary_emb

    if rope is not None:
        q = apply_rotary_emb(q, *rope)
    b, s, hd = q.shape
    view = lambda t: t.view(b, t.shape[1], h, hd // h).transpose(1, 2)  # noqa: E731
    mask = None if bias is None else bias.to(q.dtype)
    return cuda_ms(lambda: F.scaled_dot_product_attention(view(q), view(k), view(v),
                                                          attn_mask=mask, scale=scale))


def sdpa_flash_ms(q, k, v, h, scale):
    """``scaled_dot_product_attention`` on the flash backend, q already
    rotated: the library yardstick, used nowhere in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, hd = q.shape
    view = lambda t: t.view(b, t.shape[1], h, hd // h).transpose(1, 2)  # noqa: E731
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return cuda_ms(lambda: F.scaled_dot_product_attention(view(q), view(k), view(v),
                                                              scale=scale))


def ring_bound(b, sq, sc, h, d) -> dict:
    """K5's bound: q, k, v in bf16 read once, the f32 state (acc, m, l) read
    and written once."""
    hd = h * d
    nbytes = 2 * (b * sq * hd + 2 * b * sc * hd) + 2 * 4 * (b * sq * hd + 2 * b * h * sq)
    return bound(4.0 * b * h * sq * sc * d, nbytes)


def path_rope(latent_frames, h, d, dev):
    """The RoPE tables of a 512x768 request with ``latent_frames`` latent
    frames (inner h·d)."""
    from candle_video_tpu_torch.models.ltx_video.pipeline import build_video_coords
    from candle_video_tpu_torch.ops.rope import rope_cos_sin

    coords = build_video_coords(latent_frames, 16, 24, 25.0)
    grid = torch.from_numpy(coords / [20.0, 2048.0, 2048.0]).float()
    return rope_cos_sin(grid.to(dev)[None], h * d)


def errors(got, want):
    d = got.float() - want.float()
    scaled = d.abs() / want.float().abs().clamp_min(1.0)
    return dict(max_abs=d.abs().max().item(), scaled=scaled.max().item(),
                mse=d.square().mean().item(), rel=(d.norm() / want.float().norm()).item())


def by_frame(plain, q, k, v, bias=None, **kw):
    """A plain version one batch row at a time, the rows concatenated: at
    the SVD path's batch of 28 its scores would not fit in one call."""
    return torch.cat([plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                            bias=None if bias is None else bias[i:i + 1], **kw)
                      for i in range(q.shape[0])])


# the sources whose kernels must keep every value in registers
NO_SPILLS = ("flash_attention_hopper.cu", "conv3d_igemm.cu", "int8_matmul.cu",
             "weight_only_matmul_hopper.cu", "threefry_normal.cu", "w4_dequant.cu")


def check_ptxas(card):
    """Every kernel's registers and spill bytes as ``ptxas -v`` reported
    them at the build; the kernels of the ``NO_SPILLS`` sources (the
    attention modes K1, K2, K5 and K6; K7; K8; R1) must not spill."""
    from candle_video_tpu_torch.ops.kernels import _build

    report = _build.ptxas_report()
    for src, entries in report.items():
        for e in entries:
            log(f"[ptxas] {src}: {e['entry']}: {e['registers']} registers, "
                f"{e['spill_stores']} B spill stores, {e['spill_loads']} B spill loads")
            if src in NO_SPILLS and e["spill_stores"] + e["spill_loads"]:
                raise AssertionError(f"{src}: {e['entry']} spills registers: {e}")
        if src in NO_SPILLS and not entries:
            raise AssertionError(f"{src}: ptxas reported no entry function")
    RESULTS["ptxas"] = report


TP_K1_CASE = "13B tp=2 rank 1x4992x16x128 rope"


def check_k1(card):
    """K1 against its plain version at the paths' shapes (2B, 13B, the SVD
    levels) and at ragged edges: K = 65 and K = 129 (one key past a 128-key
    tile) catch a missing padded-key mask, S = 4992 + 64 a ragged q tile.
    Then the broken copy (the running-max rescale of O dropped), which must
    fail every case of more than one key tile."""
    from candle_video_tpu_torch.ops.kernels import flash_attention_packed as K1
    from candle_video_tpu_torch.ops.rope import apply_rotary_emb, rope_cos_sin

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, inputs = [], {}
    # (label, B, S, K, H, D, bias, rope): the path's shape first
    cases = [("path 1x4992x32x64 rope", 1, 4992, 4992, 32, 64, False, True),
             ("13B path 1x4992x32x128 rope", 1, 4992, 4992, 32, 128, False, True),
             ("ragged S=K=1000 bias rope", 1, 1000, 1000, 32, 64, True, True),
             ("D=128 S=1000 K=1031 bias", 2, 1000, 1031, 16, 128, True, False),
             # 63 of the last tile's 64 key slots are padding: a missing mask fails
             ("K=65 bias padded tile", 2, 200, 65, 8, 64, True, False),
             # one key past a 128-key tile: the last tile is 127 slots of padding
             ("K=129 bias one key past a tile", 2, 300, 129, 8, 64, True, False),
             ("ragged S=K=4992+64 rope", 1, 5056, 5056, 32, 64, False, True),
             # a served batch of two 2B requests, and the 13B-dev request's
             # three guidance rows (cond, uncond, STG-perturbed)
             ("serving 2B batch 2x4992x32x64 rope", 2, 4992, 4992, 32, 64, False, True),
             ("13B-dev rows 3x4992x32x128 rope", 3, 4992, 4992, 32, 128, False, True),
             # one rank of the 13B at tp=2: 16 of the 32 heads, its half of the
             # full-width tables (rank 0's, which holds the dim % 6 pad lanes)
             (TP_K1_CASE, 1, 4992, 4992, 16, 128, False, True),
             # the SVD UNet's levels 1 and 2 at 576x1024x14 with CFG (batch 28)
             ("SVD level 1 28x2304x10x64", 28, 2304, 2304, 10, 64, False, False),
             ("SVD level 2 28x576x20x64", 28, 576, 576, 20, 64, False, False)]
    for label, b, s, kv, h, d, with_bias, with_rope in cases:
        q = torch.randn(b, s, h * d, generator=g, device=dev).mul_(2).bfloat16()
        k = torch.randn(b, kv, h * d, generator=g, device=dev).bfloat16()
        v = torch.randn(b, kv, h * d, generator=g, device=dev).bfloat16()
        bias = None
        if with_bias:
            keep = torch.rand(b, kv, generator=g, device=dev) > 0.2
            bias = ((~keep).float() * -10000.0)[:, None, None, :].contiguous()
        rope = None
        if with_rope:
            if label == TP_K1_CASE:  # rank 0's lanes of the 13B's tables
                rope = tuple(t[..., :h * d].contiguous() for t in path_rope(13, 2 * h, d, dev))
            elif s == 4992:  # the real tables of a 512x768x97 request (inner h·d)
                rope = path_rope(13, h, d, dev)
            else:
                rope = rope_cos_sin(torch.rand(1, s, 3, generator=g, device=dev), h * d)
            k = apply_rotary_emb(k, *rope)  # the path hands K1 a rotated k
        args = dict(num_heads=h, scale=d ** -0.5, bias=bias, rope_q=rope)
        plain = K1.flash_attention_packed_plain
        if b == 28:
            plain = lambda *a, **kw: by_frame(K1.flash_attention_packed_plain, *a, **kw)  # noqa: E731
        got = K1.flash_attention_packed(q, k, v, **args)
        want = plain(q, k, v, **args)
        torch.cuda.synchronize()
        err = errors(got, want)
        ms = cuda_ms(lambda: K1.flash_attention_packed(q, k, v, **args))
        plain_ms = cuda_ms(lambda: plain(q, k, v, **args), iters=5)
        flops = 4.0 * b * h * s * kv * d
        log(f"[K1] {label}: max_abs={err['max_abs']:.3e} scaled={err['scaled']:.3e} "
            f"mse={err['mse']:.3e} "
            f"rel={err['rel']:.3e} kernel={ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
            f"plain={plain_ms:.3f} ms | {card}")
        if not (err["scaled"] <= K1_TOL["scaled"] and err["rel"] <= K1_TOL["rel"]):
            raise AssertionError(f"K1 {label} disagrees with its plain version: {err}")
        row = dict(label=label, ms=ms, plain_ms=plain_ms, library_ms=None, **err,
                   **attention_bound(b, s, kv, h, d, with_bias, with_rope))
        if s == kv == 4992 or b == 28:  # the paths' shapes: the library yardstick too
            row["library_ms"] = sdpa_ms(q, k, v, h, d ** -0.5, bias, rope)
            log(f"[K1] {label}: sdpa={row['library_ms']:.3f} ms bound={row['bound_ms']:.4f} ms "
                f"({row['bound_by']}) | {card}")
        rows.append(row)
        if kv > 128 and (b == 1 or s == 4992) or label.startswith("K=129"):
            inputs[label] = (q, k, v, args, want)
    RESULTS["k1"] = rows

    def run_broken():
        res = {}
        for label, (q, k, v, args, want) in inputs.items():
            res[label] = errors(K1.flash_attention_packed(q, k, v, **args), want)
            torch.cuda.synchronize()
        return res

    broken = broken_copy("k1", K1_BREAK, run_broken)
    for label, err in broken.items():
        log(f"[K1 broken: no running-max rescale] {label}: rel={err['rel']:.3e} "
            f"scaled={err['scaled']:.3e} | {card}")
        if err["scaled"] <= K1_TOL["scaled"] and err["rel"] <= K1_TOL["rel"]:
            raise AssertionError(f"the broken K1 passes the limits at {label}: {err}")
    RESULTS["k1_broken"] = broken
    return rows[0]


# the broken K1: O is no longer rescaled when the running max grows, so the
# key tiles' partial sums are added against different shifts
K1_BREAK = ("o[r] *= alpha[(r >> 1) & 1];", "o[r] *= 1.f;")


# the broken K2: the shift moves from tile to tile (m + tile index, in log2
# units), so the key tiles' partial sums no longer add up to one softmax
K2_BREAK = ("const float tile_shift = mfix;", "const float tile_shift = mfix + (float)it;")
# K2 with the SFU's flush-to-zero exp2: p under 2^-126 becomes 0, which the
# case whose rows lie ~81 nats under the shift must catch
K2_FTZ = ("const float p = ex2_sub(sc[r]);", "const float p = ex2(sc[r]);")


# the broken K5: each CTA drops the carried running sum l (starts it at 0),
# so after more than one ring step the output is normalised by the last
# chunks' sums only
K5_BREAK = ("l[i] = lane % 4 == 0 ? l_st[st0 + 8 * i] : 0.f;", "l[i] = 0.f;")


def broken_copy(tag, substitution, fn, source="flash_attention_hopper.cu"):
    """Run ``fn`` on a kernel library built from a copy of ``csrc/`` with
    ``substitution`` (one (old, new) pair, or a list of them) applied to
    ``source`` (under the gitignored output directory), then restore the
    real library."""
    from candle_video_tpu_torch.ops.kernels import _build

    subs = [substitution] if isinstance(substitution[0], str) else substitution
    with _build.patched(os.path.join(OUT_DIR, f"broken_{tag}"), source, subs):
        return fn()


FAR_UNDER = "(far) 1x1000x8320x32x64, rows ~81 nats under the shift"


def far_under_shift_qk(g, b, s, kv, h, d, dev):
    """q and k whose scores, for every q row but the first, lie ~81 nats
    under K2's shift: the keys of a head cluster around a unit direction u
    (6u + noise), the rows point against it at 62.7 (scores near -41 nats
    at D = 64), and the first row along it at 60 lifts the Cauchy-Schwarz
    bound past its clip of 40.  Their p are subnormal f32."""
    u = torch.randn(h, d, generator=g, device=dev)
    u /= u.norm(dim=-1, keepdim=True)
    k = 6 * u + 0.2 * torch.randn(b, kv, h, d, generator=g, device=dev)
    q = -(47 * 8 / 6) * u + 0.2 * torch.randn(b, s, h, d, generator=g, device=dev)
    q[:, 0] = 60 * u
    return q.reshape(b, s, h * d).bfloat16(), k.reshape(b, kv, h * d).bfloat16()


def check_k2(card):
    """K2 against its plain version at the 257-frame path's shape (and the
    13B head width, a ragged biased case just over the route's threshold,
    and a case whose rows lie ~81 nats under the fixed shift, where p is
    subnormal), timed through the wrapper (``ms``), alone on a precomputed
    shift (``kernel_ms``) and its torch shift alone (``shift_ms``), beside
    K1 and SDPA on the same inputs; then the broken copy, which must fail
    the limits, and a copy on the flush-to-zero exp2, which must fail the
    far-under case."""
    from candle_video_tpu_torch.ops.kernels import flash_attention_packed as FA
    from candle_video_tpu_torch.ops.rope import apply_rotary_emb, rope_cos_sin

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []
    # (label, B, S, K, H, D, bias, rope): the path's shape first
    cases = [("path 1x12672x32x64 rope 257f", 1, 12672, 12672, 32, 64, False, True),
             ("1x12672x32x128 rope 257f", 1, 12672, 12672, 32, 128, False, True),
             # K_pad 8320 > 8192; 1 of the last tile's 128 key slots is a key
             ("ragged K=8257 bias rope", 2, 1000, 8257, 32, 64, True, True),
             (FAR_UNDER, 1, 1000, 8320, 32, 64, False, False)]
    inputs = {}
    for label, b, s, kv, h, d, with_bias, with_rope in cases:
        q = torch.randn(b, s, h * d, generator=g, device=dev).mul_(2).bfloat16()
        k = torch.randn(b, kv, h * d, generator=g, device=dev).bfloat16()
        v = torch.randn(b, kv, h * d, generator=g, device=dev).bfloat16()
        if label == FAR_UNDER:
            q, k = far_under_shift_qk(g, b, s, kv, h, d, dev)
        bias = None
        if with_bias:
            keep = torch.rand(b, kv, generator=g, device=dev) > 0.3
            bias = ((~keep).float() * -10000.0)[:, None, None, :].contiguous()
        rope = None
        if s == 12672:
            rope = path_rope(33, h, d, dev)
        elif with_rope:
            rope = rope_cos_sin(torch.rand(1, s, 3, generator=g, device=dev), h * d)
        if s == kv:
            k = apply_rotary_emb(k, *rope)  # the path hands the kernel a rotated k
        args = dict(num_heads=h, scale=d ** -0.5, bias=bias, rope_q=rope)
        if not FA.uses_long_kernel(kv):
            raise AssertionError(f"K2 {label}: K={kv} does not route to K2")
        got = FA.flash_attention_packed_long(q, k, v, **args)
        want = FA.flash_attention_packed_long_plain(q, k, v, **args)
        torch.cuda.synchronize()
        err = errors(got, want)
        k1_err = errors(FA.flash_attention_packed_onepass(q, k, v, **args), want)
        ms = cuda_ms(lambda: FA.flash_attention_packed_long(q, k, v, **args))
        shift_ms = cuda_ms(lambda: FA.long_shift(q, k, num_heads=h, scale=d ** -0.5, bias=bias))
        shift = FA.long_shift(q, k, num_heads=h, scale=d ** -0.5, bias=bias).contiguous()
        kernel_ms = cuda_ms(lambda: FA.launch_long(q, k, v, shift, **args))
        k1_ms = cuda_ms(lambda: FA.flash_attention_packed_onepass(q, k, v, **args))
        plain_ms = cuda_ms(lambda: FA.flash_attention_packed_long_plain(q, k, v, **args),
                           iters=3, warmup=1)
        library_ms = sdpa_ms(q, k, v, h, d ** -0.5, bias, rope)
        row = dict(label=label, ms=ms, kernel_ms=kernel_ms, shift_ms=shift_ms, k1_ms=k1_ms,
                   plain_ms=plain_ms, library_ms=library_ms, k1_rel=k1_err["rel"], **err,
                   **attention_bound(b, s, kv, h, d, with_bias, rope is not None))
        tflops = 4.0 * b * h * s * kv * d / kernel_ms / 1e9
        log(f"[K2] {label}: max_abs={err['max_abs']:.3e} scaled={err['scaled']:.3e} "
            f"rel={err['rel']:.3e} wrapper={ms:.3f} ms = shift {shift_ms:.3f} ms + kernel "
            f"{kernel_ms:.3f} ms ({tflops:.1f} TFLOP/s, {row['bound_ms'] / kernel_ms:.1%} of "
            f"the {row['bound_ms']:.3f} ms bound, {row['bound_by']}) K1={k1_ms:.3f} ms "
            f"(rel {k1_err['rel']:.3e}) sdpa={library_ms:.3f} ms plain={plain_ms:.2f} ms "
            f"| {card}")
        if not (err["scaled"] <= K2_TOL["scaled"] and err["rel"] <= K2_TOL["rel"]):
            raise AssertionError(f"K2 {label} disagrees with its plain version: {err}")
        rows.append(row)
        inputs[label] = (q, k, v, args, want)
    RESULTS["k2"] = rows

    def run_copy(labels):
        def run():
            out = {}
            for label in labels:
                q, k, v, args, want = inputs[label]
                out[label] = errors(FA.flash_attention_packed_long(q, k, v, **args), want)
                torch.cuda.synchronize()
            return out
        return run

    broken = broken_copy("k2", K2_BREAK, run_copy(list(inputs)),
                         source="flash_attention_hopper.cu")
    for label, err in broken.items():
        log(f"[K2 broken: per-tile shift] {label}: rel={err['rel']:.3e} "
            f"scaled={err['scaled']:.3e} | {card}")
        if err["scaled"] <= K2_TOL["scaled"] and err["rel"] <= K2_TOL["rel"]:
            raise AssertionError(f"the broken K2 passes the limits at {label}: {err}")
    RESULTS["k2_broken"] = broken
    ftz = broken_copy("k2_ftz", K2_FTZ, run_copy([FAR_UNDER]),
                      source="flash_attention_hopper.cu")
    err = ftz[FAR_UNDER]
    log(f"[K2 on ex2.approx.ftz] {FAR_UNDER}: rel={err['rel']:.3e} scaled={err['scaled']:.3e} "
        f"| {card}")
    if err["scaled"] <= K2_TOL["scaled"] and err["rel"] <= K2_TOL["rel"]:
        raise AssertionError(f"K2 on the flush-to-zero exp2 passes the far-under case: {err}")
    RESULTS["k2_ftz"] = ftz
    return rows[0]


def ring_run(K5, q, chunks, h, scale, fn):
    """The ring's recurrence on one rank: ``fn`` (K5 or its plain version)
    over the K/V ``chunks`` in ring order from the initial state; returns
    the state after every step."""
    b, sq, hd = q.shape
    m, l, acc = K5.init_ring_state(b, sq, h, hd // h, device=q.device)
    states = []
    for k, v in chunks:
        fn(q, k, v, m, l, acc, num_heads=h, scale=scale)
        states.append((m.clone(), l.clone(), acc.clone()))
    return states


def ring_output(state, h, dtype=torch.bfloat16):
    m, l, acc = state
    b, sq, hd = acc.shape
    return (acc.view(b, sq, h, hd // h) / l.transpose(1, 2)[..., None]).reshape(b, sq, hd).to(
        dtype)


def state_errors(got, want):
    """K5's state against the plain version's: m scaled by max(1, |m|), l
    and acc relative in norm."""
    (gm, gl, ga), (wm, wl, wa) = got, want
    return dict(m_scaled=((gm - wm).abs() / wm.abs().clamp_min(1.0)).max().item(),
                l_rel=((gl - wl).norm() / wl.norm()).item(),
                acc_rel=((ga - wa).norm() / wa.norm()).item())


def check_k5(card):
    """K5 (one ring step) against its plain version, state after every step
    and the final ``acc / l``, at the ring's chunk shapes on the 512x768x97
    path's rotated q and k: (a) sp = 1, one chunk, also against K1 and plain
    attention; (b) sp = 4, a 1248-row q chunk against four 1248-key chunks
    in ring order, the output against attention over all 4992 keys; (c) the
    13B head width D = 128 at sp = 2; (d) a ragged Sq = Sc = 1000, B = 2,
    two steps, which a missing padded-key mask fails.  Each timed beside K1
    and SDPA (flash backend) on one chunk; then the broken copy (e), which
    must fail the multi-step cases."""
    from candle_video_tpu_torch.ops.kernels import flash_attention_packed as K1
    from candle_video_tpu_torch.ops.kernels import ring_chunk as K5
    from candle_video_tpu_torch.ops.rope import apply_rotary_emb

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    # (label, B, S (all keys), sp, H, D): sp chunks of S / sp, rank 0's view
    cases = [("(a) sp=1 1x4992x32x64", 1, 4992, 1, 32, 64),
             ("(b) sp=4 1x1248x(4x1248)x32x64", 1, 4992, 4, 32, 64),
             ("(c) sp=2 1x2496x(2x2496)x32x128", 1, 4992, 2, 32, 128),
             ("(d) ragged 2x1000x(2x1000)x32x64", 2, 2000, 2, 32, 64)]
    rows, inputs = [], {}
    for label, b, s, sp, h, d in cases:
        hd, scale, n = h * d, d ** -0.5, s // sp
        q = torch.randn(b, s, hd, generator=g, device=dev).mul_(2).bfloat16()
        k = torch.randn(b, s, hd, generator=g, device=dev).bfloat16()
        v = torch.randn(b, s, hd, generator=g, device=dev).bfloat16()
        if s == 4992:  # the real tables of a 512x768x97 request: rotated q and k
            rope = path_rope(13, h, d, dev)
            q, k = apply_rotary_emb(q, *rope), apply_rotary_emb(k, *rope)
        qc = q[:, :n].contiguous()
        # rank 0 holds chunk 0, then receives chunks sp-1, ..., 1 around the ring
        chunks = [(k[:, j * n:(j + 1) * n].contiguous(), v[:, j * n:(j + 1) * n].contiguous())
                  for j in [0] + list(range(sp - 1, 0, -1))]
        got = ring_run(K5, qc, chunks, h, scale, K5.ring_chunk_update)
        want = ring_run(K5, qc, chunks, h, scale, K5.ring_chunk_update_plain)
        torch.cuda.synchronize()
        steps = [state_errors(gs, ws) for gs, ws in zip(got, want)]
        out, out_plain = ring_output(got[-1], h), ring_output(want[-1], h)
        err = errors(out, out_plain)
        attn = K1.flash_attention_packed_plain(qc, k, v, num_heads=h, scale=scale)
        k1_all = K1.flash_attention_packed_onepass(qc, k, v, num_heads=h, scale=scale)
        vs_attention, vs_k1 = errors(out, attn), errors(out, k1_all)
        # timed on one chunk: K5 (state updated in place, as on the path), K1,
        # SDPA (flash backend) and the plain version on the same inputs
        k0, v0 = chunks[0]
        m, l, acc = K5.init_ring_state(b, n, h, d, device=dev)
        args = dict(num_heads=h, scale=scale)
        ms = cuda_ms(lambda: K5.ring_chunk_update(qc, k0, v0, m, l, acc, **args))
        k1_ms = cuda_ms(lambda: K1.flash_attention_packed_onepass(qc, k0, v0, **args))
        library_ms = sdpa_flash_ms(qc, k0, v0, h, scale)
        plain_ms = cuda_ms(lambda: K5.ring_chunk_update_plain(qc, k0, v0, m, l, acc, **args),
                           iters=3, warmup=1)
        row = dict(label=label, ms=ms, k1_ms=k1_ms, plain_ms=plain_ms, library_ms=library_ms,
                   steps=steps, vs_attention_rel=vs_attention["rel"],
                   vs_k1_rel=vs_k1["rel"], **err, **ring_bound(b, n, n, h, d))
        worst = {key: max(st[key] for st in steps) for key in steps[0]}
        log(f"[K5] {label}: out max_abs={err['max_abs']:.3e} scaled={err['scaled']:.3e} "
            f"rel={err['rel']:.3e}; state over {sp} step(s) m_scaled<={worst['m_scaled']:.2e} "
            f"l_rel<={worst['l_rel']:.2e} acc_rel<={worst['acc_rel']:.2e}; vs attention over "
            f"all {s} keys rel={vs_attention['rel']:.3e} (K1 on them {vs_k1['rel']:.3e}) | "
            f"one chunk: kernel={ms:.3f} ms "
            f"({4.0 * b * h * n * n * d / ms / 1e9:.1f} TFLOP/s, "
            f"{row['bound_ms'] / ms:.1%} of the {row['bound_ms']:.4f} ms bound, "
            f"{row['bound_by']}) K1={k1_ms:.3f} ms sdpa(flash)={library_ms:.3f} ms "
            f"plain={plain_ms:.2f} ms | {card}")
        if not (err["scaled"] <= K5_TOL["scaled"] and err["rel"] <= K5_TOL["rel"]
                and vs_attention["rel"] <= K5_TOL["rel"]
                and all(worst[key] <= K5_TOL[key] for key in worst)):
            raise AssertionError(f"K5 {label} disagrees with its plain version: {row}")
        rows.append(row)
        inputs[label] = (qc, chunks, h, scale, out_plain)
    RESULTS["k5"] = rows

    def run_broken():
        res = {}
        for label, (qc, chunks, h, scale, want) in inputs.items():
            out = ring_output(ring_run(K5, qc, chunks, h, scale, K5.ring_chunk_update)[-1], h)
            torch.cuda.synchronize()
            res[label] = errors(out, want)
        return res

    broken = broken_copy("k5", K5_BREAK, run_broken)
    for label, err in broken.items():
        multi = not label.startswith("(a)")
        log(f"[K5 broken: carried l dropped] {label}: rel={err['rel']:.3e} "
            f"scaled={err['scaled']:.3e}{'' if multi else ' (one step: l_old = 0)'} | {card}")
        if multi and err["scaled"] <= K5_TOL["scaled"] and err["rel"] <= K5_TOL["rel"]:
            raise AssertionError(f"the broken K5 passes the limits at {label}: {err}")
    RESULTS["k5_broken"] = broken
    return rows[0]


# the broken K6 (the online mode of flash_attention_hopper.cu, which K1
# shares): the running max no longer rescales what was summed before it
# (alpha = 1, for O and l), so any row whose max rises after its first key
# tile is wrong.  A case of one key tile has nothing before it to rescale,
# so a second copy drops the padded-key mask, which a ragged last tile needs.
K6_BREAK = ("alpha[i] = ex2(m[i] - m_new);", "alpha[i] = 1.f;")
K6_MASK_BREAK = ("if (k0 + BKV > K) {", "if (false) {")
SVD_K6_SHAPE = (28, 9216, 5, 64)  # 576x1024x14 with CFG: 2 x 14 frames, 72·128 tokens


def check_k6(card):
    """K6 against its plain version: (a) the SVD path shape cut to one frame
    (1x9216x5x64), (b) D = 128, H = 3, ragged K = 1000 with an f32 bias,
    (c) K = 65, which a missing padded-key mask fails.  Each timed beside
    SDPA (flash backend without a bias, the default one with it).  Then the
    full path call [28, 9216, 5, 64], held against its plain version run
    one frame at a time (at once it would hold 47.6 GB of scores), and two
    broken copies: without the running-max rescale, which must fail every
    case of more than one 128-key tile ((a), (b)), and without the
    padded-key mask, which must fail (c), whose 65 keys fill one tile.
    Returns the path call's row."""
    from candle_video_tpu_torch.ops.kernels import flash_attention as K6

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    # (label, B, S, K, H, D, bias): the path's shape first
    cases = [("(a) path frame 1x9216x5x64", 1, 9216, 9216, 5, 64, False),
             ("(b) D=128 H=3 S=777 K=1000 bias", 2, 777, 1000, 3, 128, True),
             # 63 of the tile's 128 key slots are padding: a missing mask fails
             ("(c) K=65 bias padded tile", 2, 200, 65, 5, 64, True)]
    rows, inputs = [], {}
    for label, b, s, kv, h, d, with_bias in cases:
        q = torch.randn(b, s, h, d, generator=g, device=dev).mul_(2).bfloat16()
        k = torch.randn(b, kv, h, d, generator=g, device=dev).bfloat16()
        v = torch.randn(b, kv, h, d, generator=g, device=dev).bfloat16()
        bias = None
        if with_bias:
            keep = torch.rand(b, kv, generator=g, device=dev) > 0.2
            bias = ((~keep).float() * -10000.0)[:, None, None, :].contiguous()
        args = dict(scale=d ** -0.5, bias=bias)
        got = K6.flash_attention(q, k, v, **args)
        want = K6.flash_attention_plain(q, k, v, **args)
        torch.cuda.synchronize()
        err = errors(got, want)
        ms = cuda_ms(lambda: K6.flash_attention(q, k, v, **args))
        plain_ms = cuda_ms(lambda: K6.flash_attention_plain(q, k, v, **args), iters=3, warmup=1)
        q3, k3, v3 = (t.view(b, t.shape[1], h * d) for t in (q, k, v))
        library_ms = (sdpa_ms(q3, k3, v3, h, d ** -0.5, bias, None) if with_bias
                      else sdpa_flash_ms(q3, k3, v3, h, d ** -0.5))
        row = dict(label=label, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **err,
                   **attention_bound(b, s, kv, h, d, with_bias, False))
        log(f"[K6] {label}: max_abs={err['max_abs']:.3e} scaled={err['scaled']:.3e} "
            f"rel={err['rel']:.3e} kernel={ms:.3f} ms "
            f"({4.0 * b * h * s * kv * d / ms / 1e9:.1f} TFLOP/s, {row['bound_ms'] / ms:.1%} of "
            f"the {row['bound_ms']:.4f} ms bound, {row['bound_by']}) "
            f"sdpa{'' if with_bias else '(flash)'}={library_ms:.3f} ms plain={plain_ms:.2f} ms "
            f"| {card}")
        if not (err["scaled"] <= K6_TOL["scaled"] and err["rel"] <= K6_TOL["rel"]):
            raise AssertionError(f"K6 {label} disagrees with its plain version: {err}")
        rows.append(row)
        inputs[label] = (q, k, v, args, want)
    RESULTS["k6"] = rows

    # the full call of the path (one UNet forward makes five), its plain
    # version one frame at a time
    b, s, h, d = SVD_K6_SHAPE
    q = torch.randn(b, s, h, d, generator=g, device=dev).mul_(2).bfloat16()
    k = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    v = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    plain = lambda: by_frame(K6.flash_attention_plain, q, k, v, scale=d ** -0.5)  # noqa: E731
    out = K6.flash_attention(q, k, v, scale=d ** -0.5)
    err = errors(out, plain())
    full = dict(label="path 28x9216x5x64", ms=cuda_ms(lambda: K6.flash_attention(
                    q, k, v, scale=d ** -0.5), iters=5),
                plain_ms=cuda_ms(plain, iters=3, warmup=1),
                library_ms=sdpa_flash_ms(*(t.view(b, s, h * d) for t in (q, k, v)), h, d ** -0.5),
                **err, **attention_bound(b, s, s, h, d, False, False))
    log(f"[K6] {full['label']} (plain version frame by frame): max_abs={err['max_abs']:.3e} "
        f"scaled={err['scaled']:.3e} rel={err['rel']:.3e} kernel={full['ms']:.3f} ms "
        f"({4.0 * b * h * s * s * d / full['ms'] / 1e9:.1f} TFLOP/s, "
        f"{full['bound_ms'] / full['ms']:.1%} of the {full['bound_ms']:.3f} ms bound, "
        f"{full['bound_by']}) sdpa(flash)={full['library_ms']:.3f} ms "
        f"plain={full['plain_ms']:.2f} ms | {card}")
    if not (err["scaled"] <= K6_TOL["scaled"] and err["rel"] <= K6_TOL["rel"]):
        raise AssertionError(f"K6 {full['label']} disagrees with its plain version: {err}")
    RESULTS["k6_path_call"] = full
    del q, k, v, out

    def run_broken():
        res = {}
        for label, (q, k, v, args, want) in inputs.items():
            res[label] = errors(K6.flash_attention(q, k, v, **args), want)
            torch.cuda.synchronize()
        return res

    tiles = {label: -(-kv // 128) for label, _, _, kv, *_ in cases}
    broken = broken_copy("k6", K6_BREAK, run_broken)
    for label, err in broken.items():
        log(f"[K6 broken: no running-max rescale] {label}: rel={err['rel']:.3e} "
            f"scaled={err['scaled']:.3e}{'' if tiles[label] > 1 else ' (one key tile)'} | "
            f"{card}")
        if tiles[label] > 1 and err["scaled"] <= K6_TOL["scaled"] and \
                err["rel"] <= K6_TOL["rel"]:
            raise AssertionError(f"the broken K6 passes the limits at {label}: {err}")
    unmasked = broken_copy("k6_mask", K6_MASK_BREAK, run_broken)
    for label, err in unmasked.items():
        log(f"[K6 broken: no padded-key mask] {label}: rel={err['rel']:.3e} "
            f"scaled={err['scaled']:.3e} | {card}")
    err = unmasked[cases[2][0]]
    if err["scaled"] <= K6_TOL["scaled"] and err["rel"] <= K6_TOL["rel"]:
        raise AssertionError(f"the K6 copy without the mask passes the limits at K = 65: {err}")
    RESULTS["k6_broken"] = dict(no_rescale=broken, no_mask=unmasked)
    return full


# K3's and K4's cases: (label, M, K, N, qblock, bias) and, for K4, the
# scale dtype.  The path's shapes (the T5 linears at 128 tokens, the 13B
# DiT's cross-attention k/v over 128 caption tokens), T5 under CFG (M =
# 256), and ragged cases: M = 77, N not a multiple of 16 (padded by the
# wrapper), qblock 16, 64 and 128.
K3_CASES = [("T5 q/k/v/o", 128, 4096, 4096, 32, False),
            ("T5 wi_0/wi_1", 128, 4096, 10240, 32, False),
            ("T5 wo", 128, 10240, 4096, 32, False),
            ("T5 q/k/v/o qb16", 128, 4096, 4096, 16, False),
            ("T5 wi_0/wi_1 qb16", 128, 4096, 10240, 16, False),
            ("T5 wo qb16", 128, 10240, 4096, 16, False),
            ("13B W8 DiT attn2 k/v", 128, 4096, 4096, 32, True),
            # the 13B-dev request's cross-attention k/v: 3 guidance rows x 128
            # tokens, the W8 DiT's groups of 128
            ("13B-dev W8 DiT attn2 k/v M=384", 384, 4096, 4096, 128, True),
            ("T5 CFG q/k/v/o", 256, 4096, 4096, 32, False),
            ("T5 CFG wi_0/wi_1", 256, 4096, 10240, 32, False),
            ("T5 CFG wo", 256, 10240, 4096, 32, False),
            ("ragged N qb64", 77, 4096, 4001, 64, True),
            ("ragged N qb128 M=256", 256, 2048, 1000, 128, True)]
K4_CASES = [("T5 q/k/v/o", 128, 4096, 4096, 32, False, torch.float32),
            ("T5 wi_0/wi_1", 128, 4096, 10240, 32, False, torch.float32),
            ("T5 wo", 128, 10240, 4096, 32, False, torch.float32),
            ("DiT attn2 k/v", 128, 4096, 4096, 32, True, torch.bfloat16),
            ("ragged", 77, 4096, 4000, 32, True, torch.float32),
            ("T5 CFG q/k/v/o", 256, 4096, 4096, 32, False, torch.float32),
            ("T5 CFG wi_0/wi_1", 256, 4096, 10240, 32, False, torch.float32),
            ("T5 CFG wo", 256, 10240, 4096, 32, False, torch.float32),
            ("13B-dev DiT attn2 k/v M=384", 384, 4096, 4096, 32, True, torch.bfloat16),
            ("T5 q/k/v/o qb16", 128, 4096, 4096, 16, False, torch.float32),
            ("ragged N qb64", 77, 4096, 4008, 64, True, torch.float32),
            ("qb128 M=256", 256, 2048, 1032, 128, True, torch.bfloat16)]
# the broken K3 and K4: each step's scale rows read from group g + 1 (W8's
# code); the high nibbles scaled by the low group's s and m (W4's code).
# Both go into one copy of the library, each failing its own format.
K3_BREAK = ("tma_load_2d(sc, &smap, &full[s], n0, g0);",
            "tma_load_2d(sc, &smap, &full[s], n0, g0 + 1);")
K4_BREAK = ("pair(sc + half * args.tile_elems + gr * BN + n),\n"
            "                       pair(sc + (2 + half) * args.tile_elems + gr * BN + n)",
            "pair(sc + gr * BN + n),\n"
            "                       pair(sc + 2 * args.tile_elems + gr * BN + n)")
# the cluster's sum without split 1's partial: every split case of both
# formats must fail
WO_SPLIT_BREAK = ("for (int zz = 1; zz < MAX_SPLIT; ++zz) {",
                  "for (int zz = 2; zz < MAX_SPLIT; ++zz) {")
WO_SOURCE = "weight_only_matmul_hopper.cu"


def host_ms(fn, iters: int = 50) -> float:
    """Host milliseconds per call of ``fn`` up to its enqueue (no sync in
    the loop): the Python and launch work a call costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def check_weight_only(card, tag, cases, make, call, plain, plan_of, bound_of, yardstick):
    """K3 or K4 (``tag``) against its plain version in every case (rel <=
    2e-4), timed through the wrapper (``ms``) and on the device by
    ``torch.profiler`` (``kernel_ms``: a single call's event time also holds
    the wrapper's host work), beside its bound, the plain version, the
    yardstick and the host work a call.  Returns the rows and what
    ``check_weight_only_broken`` needs to run the cases again."""
    from candle_video_tpu_torch.ops.kernels.int8_weight_matmul import cluster_slots

    dev = torch.device("cuda")
    tol = K3_TOL if tag == "K3" else K4_TOL
    rows, inputs = [], {}
    slots = cluster_slots(dev.index or 0)
    log(f"[{tag}] clusters of 1..8 CTAs the card holds at once: {slots} | {card}")
    RESULTS["cluster_slots"] = slots
    for case in cases:
        label, m, kk, n, qb = case[:5]
        args = make(case)
        plan = plan_of(case)
        got = call(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = errors(got, want)
        inputs[label] = (args, want, plan["split"])
        plan_txt = (f"plan bn={plan['bn']} stages={plan['stages']} split={plan['split']} "
                    f"ctas={plan['ctas']} ({plan['waves']:.2f} waves) n_pad={plan['n_pad']}")
        if not err["rel"] <= tol["rel"]:
            raise AssertionError(f"{tag} {label} ({plan_txt}) disagrees with its plain "
                                 f"version: {err}")
        ms = cuda_ms(lambda: call(*args), iters=20)
        plain_ms = cuda_ms(lambda: plain(*args), iters=5)
        kernel_ms = device_ms_of(kernel_device_ms(lambda: call(*args), repeats=3),
                                 "weight_only_matmul_kernel")
        host = host_ms(lambda: call(*args))
        library_ms, library_err, bf16_ms = yardstick(case, args, want)
        row = dict(label=label, m=m, k=kk, n=n, qblock=qb, ms=ms, kernel_ms=kernel_ms,
                   host_ms=host,
                   plain_ms=plain_ms, library_ms=library_ms, library_rel=library_err,
                   bf16_matmul_ms=bf16_ms,
                   plan={k: plan[k] for k in ("bn", "stages", "split", "ctas", "waves",
                                              "smem_bytes")},
                   **err, **bound_of(case))
        share = row["bound_ms"] / kernel_ms if kernel_ms else None
        row["bound_share"] = share
        log(f"[{tag}] {label} M={m} K={kk} N={n} qb={qb}: rel={err['rel']:.3e} "
            f"max_abs={err['max_abs']:.3e} {plan_txt} | "
            f"{ms:.4f} ms through the wrapper, {kernel_ms} ms on the device, {host:.4f} ms of "
            f"host work a call "
            f"({'n/a' if share is None else f'{share:.1%}'} of the {row['bound_ms']:.4f} ms "
            f"bound, {row['bound_by']}) plain={plain_ms:.4f} ms | "
            + (f"_weight_int4pack_mm={library_ms:.4f} ms (rel {library_err:.3e} against the "
               f"plain version, not held) " if library_ms is not None else "")
            + (f"bf16 matmul on the dequantized weight (not the same function)={bf16_ms:.4f} "
               f"ms " if bf16_ms is not None else "") + f"| {card}")
        rows.append(row)
    RESULTS[tag.lower()] = rows
    return rows, (tag, tol, inputs, call)


def check_weight_only_broken(card, *runs):
    """Two broken copies of the weight-only kernel, each run on every K3 and
    K4 case (``runs``: what ``check_weight_only`` returned): one with
    ``K3_BREAK`` and ``K4_BREAK``, which must fail every case, and one
    with ``WO_SPLIT_BREAK``, which must fail every case of more than one
    split (and each format must have one)."""
    def run_all():
        res = {}
        for tag, _, inputs, call in runs:
            for label, (args, want, _) in inputs.items():
                res[tag, label] = errors(call(*args), want)
                torch.cuda.synchronize()
        return res

    broken = {}
    for name, subs in (("next group's scales (K3), high nibbles on the low group (K4)",
                        [K3_BREAK, K4_BREAK]),
                       ("split 1's partial dropped", [WO_SPLIT_BREAK])):
        res = broken_copy(f"wo_{len(broken)}", subs, run_all, source=WO_SOURCE)
        split_copy = subs == [WO_SPLIT_BREAK]
        for tag, tol, inputs, _ in runs:
            for label, (_, _, split) in inputs.items():
                err = res[tag, label]
                log(f"[{tag} broken: {name}] {label} (split {split}): rel={err['rel']:.3e} "
                    f"| {card}")
                if (not split_copy or split > 1) and err["rel"] <= tol["rel"]:
                    raise AssertionError(f"the {tag} copy ({name}) passes at {label}: {err}")
            if split_copy and not any(s > 1 for _, _, s in inputs.values()):
                raise AssertionError(f"no {tag} case is split: the split copy tests nothing")
        broken[name] = {f"{tag} {label}": err for (tag, label), err in res.items()}
    RESULTS["weight_only_broken"] = broken


def check_k3(card):
    from candle_video_tpu_torch.ops.kernels import int8_weight_matmul as K3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def make(case):
        _, m, kk, n, qb, with_bias = case
        x = torch.randn(m, kk, generator=g, device=dev).bfloat16()
        w_q = torch.randint(-127, 128, (kk, n), generator=g, device=dev, dtype=torch.int8)
        s = torch.rand(kk // qb, n, generator=g, device=dev) * 1e-3 + 1e-4
        bias = (torch.randn(n, generator=g, device=dev) * 0.1).bfloat16() if with_bias else None
        return x, w_q, s, bias, qb

    def bound_of(case):
        _, m, kk, n, qb, with_bias = case
        nbytes = 2 * m * kk + kk * n + 4 * (kk // qb) * n + 2 * m * n + 2 * n * with_bias
        return bound(2.0 * m * kk * n, nbytes)

    def yardstick(case, args, want):
        x, w_q, s, _, qb = args
        wd = K3.dequantize(w_q, s, qb)
        return None, None, cuda_ms(lambda: torch.matmul(x, wd), iters=20)

    rows, run = check_weight_only(
        card, "K3", K3_CASES, make, lambda *a: K3.w8_matmul(*a[:4], qblock=a[4]),
        lambda *a: K3.w8_matmul_plain(*a[:4], qblock=a[4]),
        lambda case: K3.plan_w8(*case[1:5], K3.cluster_slots(dev.index or 0)),
        bound_of, yardstick)
    return next(r for r in rows if r["label"] == "T5 wi_0/wi_1"), run


def int4pack_yardstick(x, w_p, s, mn, qb):
    """``torch._weight_int4pack_mm`` on K4's weight, converted once outside
    the timed call: the codes transposed to [N, K] and packed by
    ``_convert_weight_to_int4pack`` (two codes a byte, the even k in the
    high nibble), scale and zero ``m + 8·s`` in bf16 (its dequant is (q -
    8)·scale + zero).  Returns its ms and the call itself."""
    from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4

    codes = K4._codes(w_p).t().contiguous().to(torch.int32)  # [N, K]
    packed = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)
    w4 = torch._convert_weight_to_int4pack(packed, 8)
    zeros = (mn.float() + 8.0 * s.float()).bfloat16()
    sz = torch.stack([s.bfloat16(), zeros], dim=2).contiguous()  # [K/qb, N, 2]
    return cuda_ms(lambda: torch._weight_int4pack_mm(x, w4, qb, sz), iters=20), \
        torch._weight_int4pack_mm(x, w4, qb, sz)


def check_k4(card):
    from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def make(case):
        _, m, kk, n, qb, with_bias, sdt = case
        x = torch.randn(m, kk, generator=g, device=dev).bfloat16()
        w_p = torch.randint(0, 256, (kk // 2, n), generator=g, device=dev, dtype=torch.uint8)
        # the DiT init's affine form: s ~ 0.02/4.61, m ~ -7.5·s (centred weights)
        s = (torch.rand(kk // qb, n, generator=g, device=dev) * 0.5 + 0.75) * (0.02 / 4.61)
        mn = -7.5 * s * (1.0 + 0.05 * torch.randn(s.shape, generator=g, device=dev))
        bias = (torch.randn(n, generator=g, device=dev) * 0.1).bfloat16() if with_bias else None
        return x, w_p, s.to(sdt), mn.to(sdt), bias, qb

    def bound_of(case):
        _, m, kk, n, qb, with_bias, sdt = case
        es = torch.tensor([], dtype=sdt).element_size()
        nbytes = (2 * m * kk + kk // 2 * n + 2 * (kk // qb) * n * es + 2 * m * n
                  + 2 * n * with_bias)
        return bound(2.0 * m * kk * n, nbytes)

    def yardstick(case, args, want):
        x, w_p, s, mn, bias, qb = args
        if qb not in (32, 64, 128, 256):  # the group sizes its kernel takes
            return None, None, None
        ms, out = int4pack_yardstick(x, w_p, s, mn, qb)
        out = out if bias is None else out + bias
        return ms, errors(out, want)["rel"], None

    rows, run = check_weight_only(
        card, "K4", K4_CASES, make, lambda *a: K4.w4_matmul(*a[:5], qblock=a[5]),
        lambda *a: K4.w4_matmul_plain(*a[:5], qblock=a[5]),
        lambda case: K4.plan_w4(*case[1:5], torch.tensor([], dtype=case[6]).element_size(),
                                K4.cluster_slots(dev.index or 0)),
        bound_of, yardstick)
    return next(r for r in rows if r["label"] == "DiT attn2 k/v"), run


# K3 / K4 at a qblock the kernel is not built for (``qblock_ok``):
# the transient dequant route, a bf16 dequant and one cuBLAS bf16 matmul,
# against the plain version.  cuBLAS may reduce split-K partials in bf16
# (torch's default for bf16 matmuls), so the limit is a bf16 rounding's, not
# the kernel's 2e-4.
NARROW_QBLOCK_CASES = [("K3", 128, 4080, 4096, 48), ("K3", 128, 4096, 4096, 8),
                       ("K4", 128, 4032, 4096, 48)]
NARROW_QBLOCK_TOL = dict(rel=2e-3)


def check_narrow_qblocks(card):
    """Each ``NARROW_QBLOCK_CASES`` call on the card goes to the dequant route
    (one count of ``w8_matmul_dequant`` / ``w4_matmul_dequant``, no matmul
    kernel launch; K4's dequant is one ``w4_dequant`` launch) and agrees with
    the plain version."""
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4
    from candle_video_tpu_torch.ops.kernels import int8_weight_matmul as K3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for tag, m, kk, n, qb in NARROW_QBLOCK_CASES:
        x = torch.randn(m, kk, generator=g, device=dev).bfloat16()
        s = torch.rand(kk // qb, n, generator=g, device=dev) * 1e-3 + 1e-4
        if tag == "K3":
            w = torch.randint(-127, 128, (kk, n), generator=g, device=dev, dtype=torch.int8)
            args, mod = (x, w, s), K3

            def call(*a):
                return K3.w8_matmul(*a, qblock=qb)

            def plain(*a):
                return K3.w8_matmul_plain(*a, qblock=qb)
        else:
            w = torch.randint(0, 256, (kk // 2, n), generator=g, device=dev, dtype=torch.uint8)
            s = s.bfloat16()
            args, mod = (x, w, s, (-7.5 * s.float()).bfloat16()), K4

            def call(*a):
                return K4.w4_matmul(*a, qblock=qb)

            def plain(*a):
                return K4.w4_matmul_plain(*a, qblock=qb)
        _build.reset_launches()
        got = call(*args)
        launches = dict(_build.LAUNCHES)
        err = errors(got, plain(*args))
        want = {mod.DEQUANT_NAME: 1, **({K4.DEQUANT_KERNEL: 1} if mod is K4 else {})}
        if launches != want:
            raise AssertionError(f"{tag} qb {qb}: launches {launches}, want {want} and no "
                                 "matmul kernel")
        if not err["rel"] <= NARROW_QBLOCK_TOL["rel"]:
            raise AssertionError(f"{tag} qb {qb} ({mod.DEQUANT_NAME}) disagrees with its plain "
                                 f"version: {err}")
        ms = cuda_ms(lambda: call(*args), iters=20)
        row = dict(tag=tag, m=m, k=kk, n=n, qblock=qb, route=mod.DEQUANT_NAME, ms=ms, **err)
        log(f"[{tag} qb {qb}] M={m} K={kk} N={n}: {mod.DEQUANT_NAME} (no matmul kernel) "
            f"rel={err['rel']:.3e} max_abs={err['max_abs']:.3e} (limit rel "
            f"{NARROW_QBLOCK_TOL['rel']}) {ms:.4f} ms | {card}")
        rows.append(row)
    RESULTS["narrow_qblocks"] = rows


# The W4 transient dequant (csrc/w4_dequant.cu) at the 13B DiT's large-M
# shapes, qblock 32: (label, K, N, launches a 13B step).  A step runs attn1
# q/k/v/out and attn2 q/out at 4096x4096, FF up at 4096x16384 and FF down at
# 16384x4096 in each of its 48 blocks.
W4DQ_CASES = [("13B attn 4096x4096", 4096, 4096, 6 * 48),
              ("13B ff up 4096x16384", 4096, 16384, 48),
              ("13B ff down 16384x4096", 16384, 4096, 48)]
# a copy that adds m to q·s without rounding the product to bf16 first: the
# DiT's bf16 order must then differ in every case (the f32 order does not)
W4DQ_BREAK = ("return __fadd_rn(BF16_ORDER ? round_bf16(p) : p, m);",
              "return __fadd_rn(p, m);")
# bytes of memory the timed calls of one case cycle through, so that each
# call finds its codes and scales outside the 50 MB L2, as a step's linears do
W4DQ_SWEEP_BYTES = 256e6


def check_w4_dequant(card):
    """The one-pass W4 dequant against the plain ``dequantize`` on the card at
    ``W4DQ_CASES``, bit for bit, in both orders with f32 and bf16 scales, one
    launch each; the DiT's case (bf16 order, bf16 scales) timed through the
    wrapper (``ms``) and on the device by ``torch.profiler`` (``kernel_ms``)
    over distinct payloads, beside its byte bound (codes, s, m in, the bf16
    weight out: 2.625 B a weight), the plain version and the host work a call.
    Then the broken copy, which must differ in every bf16-order case.
    Returns the rows and the step's sums."""
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    qb, order = 32, torch.bfloat16
    rows, inputs = [], {}
    for label, kk, n, per_step in W4DQ_CASES:
        w_p = torch.randint(0, 256, (kk // 2, n), generator=g, device=dev, dtype=torch.uint8)
        s32 = (torch.rand(kk // qb, n, generator=g, device=dev) * 0.5 + 0.75) * (0.02 / 4.61)
        m32 = -7.5 * s32 * (1.0 + 0.05 * torch.randn(s32.shape, generator=g, device=dev))
        for sdt in (torch.float32, torch.bfloat16):
            for cdt in (torch.bfloat16, torch.float32):
                s, m = s32.to(sdt), m32.to(sdt)
                _build.reset_launches()
                got = K4.w4_dequant(w_p, s, m, qb, cdt)
                launches = dict(_build.LAUNCHES)
                want = K4.dequantize(w_p, s, m, qb, cdt)
                torch.cuda.synchronize()
                unequal = int((got != want).sum())
                if unequal or launches != {K4.DEQUANT_KERNEL: 1}:
                    raise AssertionError(
                        f"w4_dequant {label} scales {sdt} order {cdt}: {unequal} weights "
                        f"differ from dequantize, launches {launches}")
                inputs[label, str(sdt), str(cdt)] = (w_p, s, m, cdt, want)
        s, m = s32.bfloat16(), m32.bfloat16()
        nbytes = kk // 2 * n + 2 * (kk // qb) * n * 2 + 2 * kk * n
        copies = max(1, math.ceil(W4DQ_SWEEP_BYTES / nbytes))
        payloads = [(w_p.clone(), s.clone(), m.clone()) for _ in range(copies)]

        def sweep(payloads=payloads):
            for a in payloads:
                K4.w4_dequant(*a, qb, order)

        ms = cuda_ms(sweep, iters=10) / copies
        by_name = kernel_device_ms(sweep, iters=5, repeats=3)
        kernel_ms = device_ms_of(by_name, "w4_dequant_kernel")
        kernel_ms = None if kernel_ms is None else kernel_ms / copies
        plain_ms = cuda_ms(lambda: K4.dequantize(w_p, s, m, qb, order), iters=5)
        host = host_ms(lambda: K4.w4_dequant(w_p, s, m, qb, order))
        del payloads
        row = dict(label=label, k=kk, n=n, qblock=qb, unequal=0, ms=ms, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, host_ms=host, library_ms=None, max_abs=0.0,
                   launches_per_step=per_step, bytes=nbytes, **bound(0.0, nbytes))
        row["bound_share"] = row["bound_ms"] / kernel_ms if kernel_ms else None
        share = "n/a" if row["bound_share"] is None else f"{row['bound_share']:.1%}"
        log(f"[w4_dequant] {label} qb {qb}: bit-equal to dequantize in both orders with f32 "
            f"and bf16 scales, 1 launch each | bf16 order, bf16 scales, over {copies} "
            f"payloads: {ms:.4f} ms through the wrapper, "
            f"{'not measured' if kernel_ms is None else f'{kernel_ms:.4f} ms'} on the device "
            f"({share} of the {row['bound_ms']:.4f} ms bound, {row['bound_by']}: "
            f"{nbytes / (kk * n):.3f} B a weight), {host:.4f} ms of host work a call; "
            f"plain={plain_ms:.4f} ms | {card}")
        rows.append(row)
    step = {key: None if any(r[key] is None for r in rows)
            else sum(r[key] * r["launches_per_step"] for r in rows)
            for key in ("kernel_ms", "plain_ms", "bound_ms")}
    step["launches"] = sum(r["launches_per_step"] for r in rows)
    dev_ms = "not measured" if step["kernel_ms"] is None else f"{step['kernel_ms']:.2f} ms"
    log(f"[w4_dequant] a 13B step's {step['launches']} dequants: {dev_ms} on the device "
        f"against a {step['bound_ms']:.2f} ms bound; plain {step['plain_ms']:.2f} ms | {card}")

    def run_broken():
        return {key: int((K4.w4_dequant(w_p, s, m, qb, cdt) != want).sum())
                for key, (w_p, s, m, cdt, want) in inputs.items()}

    broken = broken_copy("w4dq", W4DQ_BREAK, run_broken, source="w4_dequant.cu")
    for (label, sdt, cdt), unequal in broken.items():
        log(f"[w4_dequant broken: q·s not rounded to bf16] {label} scales {sdt} order {cdt}: "
            f"{unequal} weights differ | {card}")
        if cdt == str(torch.bfloat16) and not unequal:
            raise AssertionError(f"the broken w4_dequant passes at {label} ({sdt}, {cdt})")
    RESULTS["w4_dequant"] = dict(rows=rows, step=step,
                                 broken={" ".join(k): v for k, v in broken.items()})
    return rows, step


def check_k3_k4(card):
    """K3 and K4 in every case, then their broken copies on the same
    inputs, then the qblocks the kernel is not built for; returns the rows
    of the ``kernels`` line."""
    k3, run3 = check_k3(card)
    k4, run4 = check_k4(card)
    check_weight_only_broken(card, run3, run4)
    check_narrow_qblocks(card)
    return k3, k4


def bf16_ulps(got, want):
    """The largest |got - want| in units of the bf16 spacing at max(|want|,
    1) (one ulp: 2^(floor(log2 |want|) - 7)), the unit ``errors``' scaled
    difference is held to."""
    w = want.float().abs().clamp_min(1.0)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


# the broken K7s: the epilogue drops the row scale s_x; the split-K pass
# leaves split 1's partial out of its sum
K7_BREAK = ("__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs)",
            "__fmul_rn(__int2float_rn(acc), cs)")
K7_SPLIT_BREAK = ("for (int z = 1; z < args.split; ++z)", "for (int z = 2; z < args.split; ++z)")
# the path's shapes, timed and swept over the plan's choices; then ragged
# M, N and K (40 and 2072 take the zero pad to a multiple of 16), checked only
K7_PATH = [("to_q/k/v/out attn1 4992x2048x2048", 4992, 2048, 2048),
           ("ff.net_0_proj 4992x2048x8192", 4992, 2048, 8192),
           ("ff.net_2 4992x8192x2048", 4992, 8192, 2048),
           ("attn2 to_k/v 128x2048x2048", 128, 2048, 2048)]
K7_RAGGED = [("ragged 1x48x72", 1, 48, 72), ("ragged 37x2064x200", 37, 2064, 200),
             ("ragged 130x48x200", 130, 48, 200), ("ragged 4999x2048x2056", 4999, 2048, 2056),
             ("padded K 1x40x72", 1, 40, 72), ("padded K 37x40x200", 37, 40, 200),
             ("padded K 130x2072x72", 130, 2072, 72), ("odd N 64x256x199", 64, 256, 199)]


def kernel_device_ms(fn, iters: int = 20, tries: int = 3, repeats: int = 1) -> dict:
    """Device milliseconds per call by kernel name, from ``torch.profiler``
    over ``iters`` calls of ``fn`` (empty if the profiler saw no device
    time).  A profile that saw no device time, or in which a kernel's count
    is not a multiple of ``iters`` (dropped records), is taken again, up to
    ``tries`` times; with ``repeats`` > 1, each name's median over that many
    profiles."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        rows: dict = {}
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            rows = {}
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", None)
                us = e.self_cuda_time_total if us is None else us
                if us > 0:
                    ms, count = rows.get(e.key, (0.0, 0))
                    rows[e.key] = (ms + us / 1e3, count + e.count)
            if rows and all(count % iters == 0 for _, count in rows.values()):
                break
        runs.append({name: ms / iters for name, (ms, _) in rows.items()})
    names = set().union(*runs)
    return {name: statistics.median(r[name] for r in runs if name in r) for name in names}


def device_ms_of(by_name: dict, fragment: str):
    """The summed device ms of the kernels whose name holds ``fragment``
    (None where the profile saw no device time)."""
    return sum(t for k, t in by_name.items() if fragment in k) if by_name else None


def check_k7(card):
    """K7 against its plain version at the W8A8 tier's shapes (M = 4992 at
    the 2B DiT's three linear shapes, M = 128 for the cross-attention k/v)
    and at ragged M, N and K (K = 40 and 2072 zero-padded), the bias fused
    in f32 as the tier adds it: the int32 product is exact and the epilogue
    the same f32 arithmetic, so the outputs must be equal (0 bf16 ulp; the
    limit is 1).  The path's shapes are timed beside the plain version, the
    bf16 ``torch.matmul`` of the same shape (the dense tier's product),
    ``torch._int_mm`` (the int32 product alone, no epilogue) and the tier's
    activation quantizer; the kernel's device time by ``torch.profiler``
    (a single call's event time holds the wrapper's host work too), the
    split-K pass's apart, and on the plan's alternatives (BN = 128 and 256
    at M = 4992, splits 1, 2, 4 and 8 at M = 128).  Then the two broken copies, which must fail: s_x
    dropped (every case), one split's partial dropped (every split case,
    the M = 128 one among them)."""
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.ops.kernels import int8_matmul as K7

    dev = torch.device("cuda")
    sms = _build.sm_count(dev.index or 0)
    g = torch.Generator(device=dev).manual_seed(8)
    rows, inputs = [], {}
    for label, m, kk, n in K7_PATH + K7_RAGGED:
        x_q = torch.randint(-127, 128, (m, kk), generator=g, device=dev, dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, kk), generator=g, device=dev, dtype=torch.int8)
        s_x = torch.rand(m, generator=g, device=dev) * 1e-2 + 1e-3
        s_w = torch.rand(n, generator=g, device=dev) * (0.04 / 73.6) + 1e-5
        bias = torch.randn(n, generator=g, device=dev) * 0.1
        args = (x_q, s_x, w_q, s_w, bias)
        plan = K7.plan_w8a8(m, kk, n, sms)
        got = K7.w8a8_matmul(*args, bias_before_cast=True)
        want = K7.w8a8_matmul_plain(*args, bias_before_cast=True)
        torch.cuda.synchronize()
        err, ulps = errors(got, want), bf16_ulps(got, want)
        plan_txt = (f"plan bn={plan['bn']} stages={plan['stages']} split={plan['split']} "
                    f"ctas={plan['ctas']} ({plan['waves']:.2f} waves) k_pad={plan['k_pad']}")
        inputs[label] = (args, want, plan["split"])
        if ulps > 1:
            raise AssertionError(f"K7 {label} ({plan_txt}) disagrees with its plain version: "
                                 f"{ulps} ulps, {err}")
        if (label, m, kk, n) in K7_RAGGED:
            log(f"[K7] {label}: equal={torch.equal(got, want)} ulps={ulps:.0f} {plan_txt} | {card}")
            continue
        ms = cuda_ms(lambda: K7.w8a8_matmul(*args, bias_before_cast=True), iters=20)
        plain_ms = cuda_ms(lambda: K7.w8a8_matmul_plain(*args, bias_before_cast=True), iters=5)
        xb = torch.randn(m, kk, generator=g, device=dev).bfloat16()
        wb = torch.randn(kk, n, generator=g, device=dev).bfloat16()
        bf16_ms = cuda_ms(lambda: torch.matmul(xb, wb), iters=20)
        w_t = w_q.t()  # [K, N] column-major: the layout _int_mm takes as its second operand
        library_ms = cuda_ms(lambda: torch._int_mm(x_q, w_t), iters=20)
        # the tier's per-token activation quantizer (plain torch ops, as the
        # JAX package leaves it to XLA) that runs before every K7 launch
        quantize_ms = cuda_ms(lambda: K7.quantize_activations_tier(xb), iters=20)
        nbytes = m * kk + n * kk + 4 * (m + 2 * n) + 2 * m * n
        ops = 2.0 * m * kk * n
        row = dict(label=label, m=m, k=kk, n=n, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bf16_matmul_ms=bf16_ms, quantize_ms=quantize_ms,
                   equal=torch.equal(got, want), bf16_ulps=ulps, tops=ops / ms / 1e9,
                   plan={k: plan[k] for k in ("bn", "stages", "split", "ctas", "waves")},
                   **err, **bound(ops, nbytes, PEAK_INT8_OPS))
        # the kernel's device time (GEMM and split pass) by name in a profile:
        # one call's event time above also holds the wrapper's host work
        by_name = kernel_device_ms(lambda: K7.w8a8_matmul(*args, bias_before_cast=True))
        row.update(kernel_ms=device_ms_of(by_name, "w8a8_matmul"),
                   split_pass_ms=device_ms_of(by_name, "splitk_reduce")
                   if plan["split"] > 1 else None)
        # the plan's alternatives on the same inputs, device time by profile
        alts = [(bn, 1) for bn in (128, 256)] if m > 128 else [(128, z) for z in (1, 2, 4, 8)]
        row["alternatives_kernel_ms"] = {
            f"bn={bn} split={z}": device_ms_of(kernel_device_ms(lambda: K7._launch(
                x_q, s_x, w_q, s_w, bias, K7.plan_w8a8(m, kk, n, sms, bn=bn, split=z))),
                "w8a8_matmul") for bn, z in alts}
        log(f"[K7] {label}: equal={row['equal']} ulps={ulps:.0f} max_abs={err['max_abs']:.3e} "
            f"{plan_txt} kernel={ms:.4f} ms through the wrapper, {row['kernel_ms']} ms on the "
            f"device ({row['tops']:.1f} TOP/s, "
            f"{row['bound_ms'] / ms:.1%} of the {row['bound_ms']:.4f} ms bound, "
            f"{row['bound_by']}) _int_mm={library_ms:.4f} ms ({ms / library_ms:.2f}x) "
            f"bf16 matmul={bf16_ms:.4f} ms ({ms / bf16_ms:.2f}x) activation "
            f"quantizer={quantize_ms:.4f} ms plain={plain_ms:.3f} ms | {card}")
        log(f"[K7] {label} plans, device ms: "
            + " ".join(f"{k}: {v}" for k, v in row["alternatives_kernel_ms"].items())
            + (f" | the split pass {row['split_pass_ms']} ms of {row['kernel_ms']}"
               if plan["split"] > 1 else "") + f" | {card}")
        rows.append(row)
    RESULTS["k7"] = rows

    def run_broken():
        res = {}
        for label, (args, want, _) in inputs.items():
            res[label] = bf16_ulps(K7.w8a8_matmul(*args, bias_before_cast=True), want)
            torch.cuda.synchronize()
        return res

    broken = broken_copy("k7", K7_BREAK, run_broken, source="int8_matmul.cu")
    for label, ulps in broken.items():
        log(f"[K7 broken: s_x dropped] {label}: ulps={ulps:.3e} | {card}")
        if ulps <= 1:
            raise AssertionError(f"the broken K7 passes the limit at {label}: {ulps}")
    split_broken = broken_copy("k7_split", K7_SPLIT_BREAK, run_broken, source="int8_matmul.cu")
    for label, ulps in split_broken.items():
        split = inputs[label][2]
        log(f"[K7 broken: split 1's partial dropped] {label} (split {split}): ulps={ulps:.3e} "
            f"| {card}")
        if split > 1 and ulps <= 1:
            raise AssertionError(f"the K7 copy without a split's partial passes at {label}")
    if inputs[K7_PATH[3][0]][2] < 2:
        raise AssertionError("the M = 128 case is not split: the split copy tests nothing")
    RESULTS["k7_broken"] = dict(no_sx=broken, no_split_partial=split_broken)
    return rows[0]


# K8 against its plain version (f32 conv of the same bf16 inputs, one
# rounding): both round once to bf16 after f32 sums in another order, so
# outputs differ by one bf16 ulp where a sum lands near a rounding boundary,
# and more only where the sum cancels to a small value: K1's limits.
K8_TOL = dict(scaled=8e-3, rel=4e-3)
# the broken K8: every tap's box starts at the centre column (the dw shift
# dropped from the box's column coordinate)
K8_BREAK = ("tma_load_4d(as, &xmap, &full[s], c0, w0 + dw - 1,",
            "tma_load_4d(as, &xmap, &full[s], c0, w0,")


def k8_kernel_only(x, w27, bias, kw):
    """A launcher of K8 alone on a pre-packed weight, its output and
    workspace made once: what the wrapper adds (checks, plan, packing-cache
    lookup, allocation) left out."""
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.ops.kernels import conv3d_igemm as K8

    b, c, t, h, w = x.shape
    o = w27.shape[1]
    mode = K8._mode(**kw)
    t_out = t - 2 if mode == "valid" else t
    plan = K8.plan_conv3d(b, t_out, h, w, c, o, _build.sm_count(x.device.index))
    y = torch.empty((b, o, t_out, h, w), dtype=torch.bfloat16, device=x.device,
                    memory_format=torch.channels_last_3d)
    ws = None
    if plan["split"] > 1:
        ws = torch.empty((plan["split"], b * t_out * h * w, o), dtype=torch.float32,
                         device=x.device)
    bias = bias.float().contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _build.lib().cvt_conv3d_igemm
    args = (x.data_ptr(), w27.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), b, t, h, w, c, o, K8._MODES[mode],
            plan["bh"], plan["bw"], plan["bn"], plan["split"], stream)
    return lambda: _build.check(fn(*args), K8.NAME), plan


def check_k8(card):
    """K8 against its plain version at the 2B decoder's four widths at 97
    frames (the tail, up block 1, up block 0, the mid block, whose plan
    splits the K-steps), non-causal as the 0.9.8 decoder runs and causal, a
    ``time_pad="valid"`` case as the streamed decode calls it, B = 2 on a
    13x20 frame that the plan's rectangle does not divide, and the
    encoder's new shapes, causal: the downsamplers' convs that narrow
    (512 -> 128 at 50x64x96, 1024 -> 256 at 26x32x48), the 2048-channel mid
    block (split-K) and a single frame (T = 1, both halo frames clamped to
    frame 0, as the image anchor's encode runs); input and output channels
    last.  ``ms`` is the wrapper call, as for every kernel
    (it packs each weight once and keeps the copy); ``kernel_ms`` the kernel
    alone on a pre-packed weight; both beside the plain version and cuDNN's bf16 ``F.conv3d`` on the
    same time-padded channels-first input (the default route).  Then the
    broken copy, which must fail."""
    from candle_video_tpu_torch.ops.conv3d import replicate_pad_time
    from candle_video_tpu_torch.ops.kernels import conv3d_igemm as K8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    rows, inputs = [], {}
    # (label, B, C, O, T, H, W, causal, time_pad): the tail first
    cases = [("tail 128ch 97x128x192", 1, 128, 128, 97, 128, 192, False, "edge"),
             ("tail 128ch 97x128x192 causal", 1, 128, 128, 97, 128, 192, True, "edge"),
             ("up1 256ch 49x64x96", 1, 256, 256, 49, 64, 96, False, "edge"),
             ("up1 256ch 49x64x96 causal", 1, 256, 256, 49, 64, 96, True, "edge"),
             ("up0 512ch 25x32x48", 1, 512, 512, 25, 32, 48, False, "edge"),
             ("up0 512ch 25x32x48 causal", 1, 512, 512, 25, 32, 48, True, "edge"),
             ("mid 1024ch 13x16x24 split-K", 1, 1024, 1024, 13, 16, 24, False, "edge"),
             ("mid 1024ch 13x16x24 causal split-K", 1, 1024, 1024, 13, 16, 24, True, "edge"),
             ("tail stream chunk 128ch 26x128x192 valid", 1, 128, 128, 26, 128, 192, False,
              "valid"),
             ("ragged B=2 128ch 5x13x20 causal", 2, 128, 128, 5, 13, 20, True, "edge"),
             ("enc ds2 512->128 50x64x96 causal", 1, 512, 128, 50, 64, 96, True, "edge"),
             ("enc ds3 1024->256 26x32x48 causal", 1, 1024, 256, 26, 32, 48, True, "edge"),
             ("enc mid 2048ch 13x16x24 causal split-K", 1, 2048, 2048, 13, 16, 24, True,
              "edge"),
             ("enc 128ch T=1 1x128x192 causal", 1, 128, 128, 1, 128, 192, True, "edge")]
    for label, b, c, o, t, h, w, causal, time_pad in cases:
        x = torch.randn(b, c, t, h, w, generator=g, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last_3d)
        wt = (torch.randn(o, c, 3, 3, 3, generator=g, device=dev) * (27 * c) ** -0.5).bfloat16()
        bias = (torch.randn(o, generator=g, device=dev) * 0.1).bfloat16()
        kw = dict(causal=causal, time_pad=time_pad)
        got = K8.conv3d_igemm(x, wt, bias, **kw)
        want = K8.conv3d_igemm_plain(x, wt, bias, **kw)
        torch.cuda.synchronize()
        if not got.is_contiguous(memory_format=torch.channels_last_3d):
            raise AssertionError(f"K8 {label}: output is not channels last")
        err, ulps = errors(got, want), bf16_ulps(got, want)
        kernel, plan = k8_kernel_only(x, K8.packed_weight(wt), bias, kw)
        if "split-K" in label and plan["split"] == 1:
            raise AssertionError(f"K8 {label}: the plan does not split the K-steps")
        kernel_ms = cuda_ms(kernel, iters=5)
        ms = cuda_ms(lambda: K8.conv3d_igemm(x, wt, bias, **kw), iters=5)
        plain_ms = cuda_ms(lambda: K8.conv3d_igemm_plain(x, wt, bias, **kw), iters=3, warmup=1)
        xp = x.contiguous()
        if time_pad != "valid":
            xp = replicate_pad_time(xp, 3, causal)
        library_ms = cuda_ms(lambda: F.conv3d(xp, wt, bias, padding=(0, 1, 1)), iters=5)
        t_out = got.shape[2]
        flops = 2.0 * b * t_out * h * w * c * o * 27
        nbytes = 2 * b * (c * t * h * w + o * t_out * h * w) + 2 * 27 * c * o + 4 * o
        row = dict(label=label, b=b, c=c, o=o, t=t, h=h, w=w, causal=causal,
                   time_pad=time_pad,
                   ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bf16_ulps=ulps, plan={k: plan[k] for k in ("bh", "bw", "bn", "split",
                                                              "ctas", "waves")},
                   **err, **bound(flops, nbytes))
        log(f"[K8] {label}: max_abs={err['max_abs']:.3e} scaled={err['scaled']:.3e} "
            f"rel={err['rel']:.3e} ulps<={ulps:.0f} wrapper={ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {row['bound_ms'] / ms:.1%} of the "
            f"{row['bound_ms']:.3f} ms bound, {row['bound_by']}) kernel alone={kernel_ms:.3f} ms "
            f"cudnn={library_ms:.3f} ms (K8/cuDNN {ms / library_ms:.2f} by the wrapper, "
            f"{kernel_ms / library_ms:.2f} alone) "
            f"plain={plain_ms:.2f} ms; plan {plan['bh']}x{plan['bw']} BN={plan['bn']} "
            f"split={plan['split']}, {plan['ctas']} CTAs, {plan['waves']:.2f} waves | {card}")
        if not (err["scaled"] <= K8_TOL["scaled"] and err["rel"] <= K8_TOL["rel"]):
            raise AssertionError(f"K8 {label} disagrees with its plain version: {row}")
        rows.append(row)
        if t <= 25 or label.startswith("enc"):  # the broken copy: small and encoder cases
            inputs[label] = (x, wt, bias, kw, want)
    RESULTS["k8"] = rows

    def run_broken():
        res = {}
        for label, (x, wt, bias, kw, want) in inputs.items():
            res[label] = errors(K8.conv3d_igemm(x, wt, bias, **kw), want)
            torch.cuda.synchronize()
        return res

    broken = broken_copy("k8", K8_BREAK, run_broken, source="conv3d_igemm.cu")
    for label, err in broken.items():
        log(f"[K8 broken: dw shift dropped] {label}: rel={err['rel']:.3e} "
            f"scaled={err['scaled']:.3e} | {card}")
        if err["scaled"] <= K8_TOL["scaled"] and err["rel"] <= K8_TOL["rel"]:
            raise AssertionError(f"the broken K8 passes the limits at {label}: {err}")
    RESULTS["k8_broken"] = broken
    return rows[0]


# R1's draws on the paths: (label, the seeds of its rows, one row's shape,
# dtype); the decode noise first, the row of the kernels line
R1_CASES = [("decode noise 1x128x13x16x24 f32", (1,), (1, 128, 13, 16, 24), torch.float32),
            ("served batch 2x128x13x16x24 f32", (1, 2), (1, 128, 13, 16, 24), torch.float32),
            ("anchor posterior 1x128x1x16x24 bf16", (3,), (1, 128, 1, 16, 24), torch.bfloat16),
            ("SVD image noise 1x3x576x1024 f32", (4,), (1, 3, 576, 1024), torch.float32),
            ("injection 16x24 bf16", (5,), (16, 24), torch.bfloat16)]


def check_r1(card):
    """R1 against its plain version on the card at the paths' draws
    (``R1_CASES``): the max abs difference and the count of unequal values,
    also against the host NumPy draw (``utils/rng.normal``) that the port
    made before; timed through the wrapper (``ms``), on the device by
    ``torch.profiler`` (``kernel_ms``), beside the plain version on the
    card and the host draw alone and with its upload (the path R1
    replaces).  No PyTorch call computes ``jax.random.normal``
    (``library_ms`` null); ``torch.randn`` of the same size, another
    stream, is logged beside.  Then the broken copy, which must fail every
    case."""
    import numpy as np

    from candle_video_tpu_torch.ops.kernels import threefry_normal as TN
    from candle_video_tpu_torch.utils import rng as R

    dev = torch.device("cuda")
    rows, inputs = [], {}
    for label, seeds, shape, dtype in R1_CASES:
        keys = [R.prng_key(s) for s in seeds]
        n = math.prod(shape)
        host_dtype = "bfloat16" if dtype == torch.bfloat16 else np.float32

        def call(keys=keys, n=n, dtype=dtype):
            return TN.threefry_normal(keys, n, dtype, dev)

        def host(keys=keys, shape=shape, host_dtype=host_dtype):
            return np.stack([R.normal(k, shape, host_dtype) for k in keys])

        def host_upload(host=host, dtype=dtype):
            out = torch.from_numpy(host()).to(dev, dtype)
            torch.cuda.synchronize()
            return out

        got = call()
        want = TN.threefry_normal_plain(keys, n, dtype, dev)
        from_host = host_upload().reshape(got.shape)
        torch.cuda.synchronize()
        err = errors(got, want)
        unequal = int((got != want).sum())
        host_err = errors(got, from_host)
        host_unequal = int((got != from_host).sum())
        ms = cuda_ms(call, iters=20)
        kernel_ms = device_ms_of(kernel_device_ms(call), "threefry_normal_kernel")
        plain_ms = cuda_ms(lambda: TN.threefry_normal_plain(keys, n, dtype, dev), iters=5,
                           warmup=1)
        randn_ms = cuda_ms(lambda: torch.randn(len(keys), n, dtype=dtype, device=dev), iters=20)
        values = n * len(keys)
        row = dict(label=label, values=values, dtype=str(dtype), unequal=unequal,
                   host_max_abs=host_err["max_abs"], host_unequal=host_unequal, ms=ms,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, host_ms=host_draw_ms(host),
                   host_upload_ms=host_draw_ms(host_upload), library_ms=None,
                   randn_ms=randn_ms, **err,
                   **bound(R1_OPS_PER_VALUE * values, values * got.element_size(),
                           PEAK_INT32_OPS))
        log(f"[R1] {label}: max_abs={err['max_abs']:.3e} unequal={unequal} of {values} "
            f"(against the host NumPy draw: max_abs={host_err['max_abs']:.3e} "
            f"unequal={host_unequal}) wrapper={ms:.4f} ms kernel="
            f"{'not measured' if kernel_ms is None else f'{kernel_ms:.4f} ms'} "
            f"({row['bound_ms']:.4f} ms bound, {row['bound_by']}) plain={plain_ms:.3f} ms "
            f"host draw={row['host_ms']:.2f} ms, with its upload={row['host_upload_ms']:.2f} ms "
            f"(torch.randn, another stream: {randn_ms:.4f} ms) | {card}")
        ok = (err["max_abs"] <= R1_TOL["f32_abs"] if dtype == torch.float32
              else err["scaled"] <= R1_TOL["bf16_scaled"])
        if not (ok and torch.isfinite(got).all()):
            raise AssertionError(f"R1 {label} disagrees with its plain version: {row}")
        rows.append(row)
        inputs[label] = (call, want)
    RESULTS["r1"] = rows

    def run_broken():
        res = {}
        for label, (call, want) in inputs.items():
            res[label] = errors(call(), want)
            torch.cuda.synchronize()
        return res

    broken = broken_copy("r1", R1_BREAK, run_broken, source="threefry_normal.cu")
    for label, err in broken.items():
        log(f"[R1 broken: a rotation constant changed] {label}: max_abs={err['max_abs']:.3e} "
            f"| {card}")
        if err["max_abs"] <= R1_TOL["f32_abs"]:
            raise AssertionError(f"the broken R1 passes the limits at {label}: {err}")
    RESULTS["r1_broken"] = broken
    return rows[0]


def check_small_slice(card, quant=None, guided=False, prompt=SLICE_PROMPT):
    """The tiny slice on the card (kernels, bf16) against the same weights on
    the CPU (plain versions, f32): dense DiT and int8 T5 (K1, K3), with
    ``quant="w4"`` int4 DiT block linears and the Q4_K-form T5 (K1, K4), or
    with ``quant="w8a8"`` the W8A8 DiT tier and the int8 T5 (K1, K7, K3).
    ``guided`` runs the ``0.9.8-13b-dev`` request as published (guidance 8,
    STG 4.0, rescale 0.5, 30 steps, a negative prompt: three rows a step),
    its skip list cut to block 1 of the slice's two; its latents are held to
    ``CFG_DRIFT`` times the drift of the CPU's own bf16 run from f32 on the
    same inputs, and its video to that run's PSNR less 20·log10(CFG_DRIFT)."""
    from candle_video_tpu_torch.models.ltx_video import configs as C
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.models.ltx_video import t5 as T5
    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.models.ltx_video import vae as V
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.ops.quant_linear import W8A8Linear
    from candle_video_tpu_torch.utils.tokenizer import MockTokenizer

    preset = C.get_config_by_version("0.9.8-13b-dev" if guided else "0.9.8-2b-distilled")
    inference = (dataclasses.replace(preset.inference, skip_block_list=(1,)) if guided
                 else preset.inference)
    cfg = C.LtxFullConfig(
        inference=inference,
        transformer=C.LtxTransformerConfig(in_channels=8, out_channels=8,
                                           num_attention_heads=4, num_layers=2,
                                           caption_channels=64),
        vae=C.LtxVaeConfig(latent_channels=8, decoder_block_out_channels=(16, 32),
                           decoder_spatiotemporal_scaling=(True, True),
                           decoder_layers_per_block=(1, 1, 1),
                           decoder_upsample_residual=(True, True),
                           decoder_upsample_factor=(2, 2), patch_size=2,
                           spatial_compression_ratio=8, temporal_compression_ratio=4),
        scheduler=preset.scheduler)
    t5cfg = C.T5Config(vocab_size=128, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                       num_heads=4)
    g = torch.Generator().manual_seed(3)
    tok = MockTokenizer(vocab_size=128, model_max_length=32)
    transformer = TF.init_random(cfg.transformer, "cpu", torch.float32, g)
    if quant == "w4":
        TF.quantize_transformer_w4(transformer)

        def t5(device, dtype):
            return T5.init_random_w4(t5cfg, device, dtype, scale=0.1, minimum=-0.75)
    else:
        if quant == "w8a8":
            TF.quantize_transformer_w8a8(transformer)

        def t5(device, dtype):
            return T5.init_random_int8(t5cfg, device, dtype, 0.01)
    cpu = P.LtxPipeline(cfg, transformer, V.init_random(cfg.vae, "cpu", torch.float32, g),
                        t5("cpu", torch.float32), t5cfg, tok)
    gpu_dit = copy.deepcopy(cpu.transformer).to("cuda", torch.bfloat16)
    for (parent, name), (cparent, _) in zip(TF.quantized_slots(gpu_dit),
                                            TF.quantized_slots(cpu.transformer)):
        if isinstance(getattr(parent, name), W8A8Linear):  # K7 takes the f32 scales
            getattr(parent, name).w_scale = getattr(cparent, name).w_scale.to("cuda")
    gpu = P.LtxPipeline(cfg, gpu_dit, copy.deepcopy(cpu.vae).to("cuda", torch.bfloat16),
                        t5("cuda", torch.bfloat16), t5cfg, tok)
    kw = dict(prompt=prompt, height=64, width=96, num_frames=9, seed=7,
              max_sequence_length=32, decode_noise=torch.zeros(1, 8, 3, 8, 12))
    if guided:
        kw["negative_prompt"] = "worst quality, blurry"
    lat_c = P.generate(cpu, output_type="latent", **kw)
    limit, drift, psnr_min = SLICE_TOL["latent_rel"], None, SLICE_TOL["video_psnr"]
    if guided:
        bf16 = P.LtxPipeline(cfg, copy.deepcopy(cpu.transformer).to(torch.bfloat16),
                             copy.deepcopy(cpu.vae).to(torch.bfloat16),
                             t5("cpu", torch.bfloat16), t5cfg, tok)
        lat_b = P.generate(bf16, output_type="latent", **kw)
        drift = ((lat_b.float() - lat_c).norm() / lat_c.norm()).item()
        limit = CFG_DRIFT * drift
    _build.reset_launches()
    lat_g = P.generate(gpu, output_type="latent", **kw).cpu()
    launches = dict(_build.LAUNCHES)
    want_k7 = cfg.inference.num_inference_steps * cfg.transformer.num_layers * 10
    if quant == "w8a8" and launches.get("w8a8_matmul", 0) != want_k7:
        raise AssertionError(f"tiny W8A8 slice launches {launches}, want {want_k7} "
                             "w8a8_matmul (steps x layers x 10 block linears)")
    want_k1 = cfg.inference.num_inference_steps * cfg.transformer.num_layers
    if launches.get("flash_attention_packed", 0) != want_k1:
        raise AssertionError(f"tiny slice launches {launches}, want {want_k1} "
                             "flash_attention_packed (steps x layers, every row at once)")
    vid_c = P.generate(cpu, **kw)
    vid_g = P.generate(gpu, **kw).cpu()
    rel = ((lat_g - lat_c).norm() / lat_c.norm()).item()
    video_psnr = psnr(vid_g, vid_c)
    if guided:
        psnr_min = psnr(P.generate(bf16, **kw), vid_c) - 20 * math.log10(CFG_DRIFT)
    name = "tiny t2v" + {None: "", "w4": " W4 DiT + Q4_K-form T5",
                         "w8a8": " W8A8 DiT + int8 T5"}[quant] + \
        (" guided (13B-dev: CFG 8, STG 4, rescale 0.5, 30 steps)" if guided else "")
    if prompt != SLICE_PROMPT:
        name += f" {prompt!r}"
    log(f"[slice] {name}, card bf16 kernels vs CPU f32 plain: latent rel={rel:.3e} "
        f"video PSNR={video_psnr:.2f} dB"
        + (f" (the CPU's bf16 run: rel {drift:.3e}, PSNR "
           f"{psnr_min + 20 * math.log10(CFG_DRIFT):.2f} dB; held to rel <= {limit:.3e}, "
           f"PSNR >= {psnr_min:.2f} dB)" if guided else "")
        + f" launches={launches} | {card}")
    if not (rel <= limit and video_psnr >= psnr_min):
        raise AssertionError(f"{name} disagrees with the CPU reference: rel={rel} "
                             f"(limit {limit}) psnr={video_psnr} (limit {psnr_min})")
    RESULTS[f"small_slice{'_' + quant if quant else ''}{'_guided' if guided else ''}"] = dict(
        latent_rel=rel, video_psnr=video_psnr, launches=launches, cpu_bf16_latent_rel=drift,
        latent_limit=limit, video_psnr_limit=psnr_min)


def resident_gib(module) -> float:
    return sum(t.numel() * t.element_size()
               for t in itertools.chain(module.parameters(), module.buffers())) / 2**30


def run_request(pipe, name, prompt, seed, want, card, staged=True, tag="e2e",
                num_frames=97, **gen_kw):
    """One 512x768 ``generate()`` of ``num_frames``: checks the video and
    that the launch counts of this request are exactly ``want``; returns its
    row."""
    from candle_video_tpu_torch.models.ltx_video.pipeline import generate
    from candle_video_tpu_torch.ops.kernels import _build

    torch.cuda.reset_peak_memory_stats()
    times: dict = {}
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    video = generate(pipe, prompt=prompt, height=512, width=768, num_frames=num_frames,
                     seed=seed, stage_times=times if staged else None, **gen_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if tuple(video.shape) != (1, 3, num_frames, 512, 768):
        raise AssertionError(f"{tag} {name}: video shape {tuple(video.shape)}")
    if not torch.isfinite(video).all():
        raise AssertionError(f"{tag} {name}: video has non-finite values")
    lo, hi = video.min().item(), video.max().item()
    if lo < 0.0 or hi > 255.0:
        raise AssertionError(f"{tag} {name}: video outside [0, 255]: [{lo}, {hi}]")
    if any(launches.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"{tag} {name}: launch counts {launches}, want {want}")
    row = dict(request=name, wall_s=wall, peak_gib=peak / 2**30, launches=launches,
               video_mean=video.mean().item(), video_std=video.float().std().item())
    stages = ""
    if staged:
        steps = times["denoise_steps"]
        row.update(t5_encode_s=times["t5_encode"],
                   denoise_step_ms=[1e3 * s for s in steps],
                   denoise_step_mean_ms=1e3 * sum(steps) / len(steps),
                   vae_decode_s=times["vae_decode"], decode_mode=times["decode_mode"])
        if "anchor_encode" in times:
            row["anchor_encode_s"] = times["anchor_encode"]
        stages = (f" t5={row['t5_encode_s'] * 1e3:.1f} ms "
                  + (f"anchor encode={row['anchor_encode_s'] * 1e3:.1f} ms "
                     if "anchor_encode_s" in row else "")
                  + f"denoise step mean={row['denoise_step_mean_ms']:.1f} ms "
                  f"(steps {', '.join(f'{x:.1f}' for x in row['denoise_step_ms'])}) "
                  f"vae_decode={row['vae_decode_s']:.3f} s "
                  f"mode={ {k: v for k, v in row['decode_mode'].items() if v} or 'dense'}")
    log(f"[{tag}] {name} request: wall={wall:.4f} s{stages} peak={row['peak_gib']:.2f} GiB "
        f"launches={launches} video mean={row['video_mean']:.2f} "
        f"std={row['video_std']:.2f} | {card}")
    return row, video


def build_pipeline(tag, card, version, **kw):
    from candle_video_tpu_torch.cli import build_random_pipeline

    t0 = time.perf_counter()
    pipe = build_random_pipeline(version, "cuda", torch.bfloat16, seed=0, **kw)
    # every request encodes its prompt: the stage times and the launch
    # counts hold the T5, also where a phase repeats a prompt
    pipe.embedding_cache_size = 0
    torch.cuda.synchronize()
    gib = dict(dit=resident_gib(pipe.transformer), t5=resident_gib(pipe.t5),
               vae=resident_gib(pipe.vae))
    log(f"[{tag}] built full-size random-init {version} {kw or ''} in "
        f"{time.perf_counter() - t0:.2f} s: resident DiT {gib['dit']:.2f} GiB, "
        f"T5 {gib['t5']:.2f} GiB, VAE {gib['vae']:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | {card}")
    return pipe, gib


def release(pipe):
    del pipe
    gc.collect()
    torch.cuda.empty_cache()


def run_e2e(card):
    """The 2B 512x768x97 request, cold, warm and warm without syncs; the
    last request's decoded latents then feed the K8 decode phase."""
    from candle_video_tpu_torch.models.ltx_video import vae as V

    pipe, _ = build_pipeline("e2e", card, "0.9.8-2b-distilled")
    # R1: the decode noise (PRNGKey(seed + 2)); the initial latents are PCG32
    want = {"flash_attention_packed": 196, "w8_matmul": 168, "w4_matmul": 0,
            "w8a8_matmul": 0, "conv3d_igemm": 0, "threefry_normal": 1}
    # cold and warm with per-stage times (a sync after every stage and step),
    # then warm again timed end to end only, with no sync inside generate()
    requests = [("cold", "A cat walking on grass", True),
                ("warm", "A sailboat crossing a bay at sunset", True),
                ("warm-nosync", "A lighthouse on a cliff in a storm", False)]
    decoded, decode = {}, V.decode

    def keep_latents(decoder, z, temb=None, **kw):
        decoded.update(z=z, temb=temb)
        return decode(decoder, z, temb, **kw)

    V.decode = keep_latents
    try:
        runs = [run_request(pipe, name, prompt, 42 + i, want, card, staged)[0]
                for i, (name, prompt, staged) in enumerate(requests)]
    finally:
        V.decode = decode
    RESULTS["e2e"] = runs
    RESULTS["attn_impl"] = check_attn_impl(card, pipe, want)
    k8_launches = check_igemm_decode(card, pipe.vae, decoded["z"], decoded["temb"])
    inject_launches = check_injected_decode(card, decoded["z"], decoded["temb"])
    release(pipe)
    return runs[-1]["launches"], k8_launches, inject_launches


def check_attn_impl(card, pipe, want):
    """``generate(attn_impl=)`` on the card, the 2B request at 512x768x97
    with latent output: ``"xla"`` (the plain attention) raises before any
    launch; ``"pallas"`` gives the latents of the default ``"auto"``
    request bit for bit, with the same K1 and K3 launches."""
    from candle_video_tpu_torch.models.ltx_video.pipeline import generate
    from candle_video_tpu_torch.ops.kernels import _build

    kw = dict(prompt="A kite over a windy beach", height=512, width=768, num_frames=97,
              seed=47, output_type="latent")
    _build.reset_launches()
    try:
        generate(pipe, attn_impl="xla", **kw)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("generate(attn_impl='xla') ran on the card")
    torch.cuda.synchronize()
    if any(_build.LAUNCHES.values()):
        raise AssertionError(f"attn_impl='xla' launched {dict(_build.LAUNCHES)} before refusing")
    latents, launches = {}, {}
    for impl in ("auto", "pallas"):
        _build.reset_launches()
        latents[impl] = generate(pipe, attn_impl=impl, **kw)
        torch.cuda.synchronize()
        launches[impl] = dict(_build.LAUNCHES)
    counts = {k: want[k] for k in ("flash_attention_packed", "w8_matmul")}
    equal = torch.equal(latents["auto"], latents["pallas"])
    log(f"[e2e] attn_impl: 'xla' refused before any launch ({refused[:60]}...); 'pallas' "
        f"latents bit-equal to 'auto': {equal}; launches {launches['pallas']} | {card}")
    if not equal or any(launches[i].get(k, 0) != n for i in launches for k, n in counts.items()):
        raise AssertionError(f"attn_impl='pallas' differs from 'auto': equal {equal}, "
                             f"launches {launches}, want {counts}")
    return dict(refused=refused, launches=launches, bit_equal=equal)


def check_injected_decode(card, z, temb, chunks: int = 2):
    """The 2B decoder at full width with ``decoder_inject_noise=(True,) *
    4`` (random bf16 weights and noise scales from a seed) on a 97-frame
    request's latents, with a ``noise_key``: the dense decode against the
    head and the streamed tail in ``chunks`` chunks (the exact mode, held
    to ``check_decode_modes``' tail limit), and against the same decode
    without a key, which the noise must move.  R1 launches exactly twice
    per injecting resnet in the dense decode, and twice per tail resnet per
    chunk in the streamed one (every chunk draws the same [H, W] noise)."""
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.models.ltx_video import vae as V
    from candle_video_tpu_torch.models.ltx_video.configs import LtxVaeConfig
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.utils import rng as R

    cfg = dataclasses.replace(LtxVaeConfig(), decoder_inject_noise=(True,) * 4)
    g = torch.Generator(device="cuda").manual_seed(21)
    dec = V.init_random(cfg, "cuda", torch.bfloat16, g)
    n_res = len(dec.mid_block.resnets) + sum(len(b.resnets) for b in dec.up_blocks)
    n_tail = len(dec.up_blocks[-1].resnets)
    key = R.prng_key(77)

    def timed(fn):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        video = P.postprocess_video(fn())
        torch.cuda.synchronize()
        return video, time.perf_counter() - t0, _build.LAUNCHES["threefry_normal"]

    dense, dense_s, dense_n = timed(lambda: dec(z, temb, noise_key=key))
    streamed, stream_s, stream_n = timed(lambda: V.decoder_tail_streamed(
        dec, V.decoder_head_forward_cl(dec, z, temb, noise_key=key), temb, n_chunks=chunks,
        noise_key=key))
    quiet, quiet_s, quiet_n = timed(lambda: dec(z, temb))
    spans = len(V.stream_spans(dense.shape[2], chunks))
    want = dict(dense=2 * n_res, streamed=2 * (n_res - n_tail) + 2 * n_tail * spans, quiet=0)
    row = dict(shape=list(z.shape), resnets=n_res, tail_resnets=n_tail, chunks=spans,
               launches=dict(dense=dense_n, streamed=stream_n, quiet=quiet_n),
               want_launches=want, dense_s=dense_s, streamed_s=stream_s, quiet_s=quiet_s,
               streamed_vs_dense_psnr_db=psnr(streamed, dense),
               quiet_vs_dense_psnr_db=psnr(quiet, dense))
    RESULTS["injected_decode"] = row
    log(f"[decode inject] 2B decoder, noise in all {n_res} resnets, {tuple(z.shape)}: dense "
        f"{dense_s:.3f} s ({dense_n} R1), head + tail stream in {spans} "
        f"{stream_s:.3f} s ({stream_n} R1), without a key {quiet_s:.3f} s; streamed vs dense "
        f"PSNR={row['streamed_vs_dense_psnr_db']:.2f} dB, without the noise "
        f"{row['quiet_vs_dense_psnr_db']:.2f} dB | {card}")
    if row["launches"] != want:
        raise AssertionError(f"injected decode: R1 launches {row['launches']}, want {want}")
    if not (row["streamed_vs_dense_psnr_db"] >= DECODE_PSNR_DB["tail"]
            and torch.isfinite(dense).all()):
        raise AssertionError(f"injected decode: the streamed tail disagrees with dense: {row}")
    if row["quiet_vs_dense_psnr_db"] >= DECODE_PSNR_DB["tail"]:
        raise AssertionError(f"injected decode: the noise does not move the video: {row}")
    del dec
    return row["launches"]["dense"]


def run_stochastic(card):
    """The ``0.9.6-2b-distilled`` preset as published (512x768x97, 8
    stochastic Euler steps, guidance 1, the int8 T5 on a string prompt),
    its first run on the card.  Every ``jax.random`` draw goes through R1:
    one step noise a step (the chain ``split`` from ``PRNGKey(seed + 1)``)
    and the decode noise (``PRNGKey(seed + 2)``: the VAE is timestep
    conditioned, so ``generate`` draws it, at the preset's decode noise
    scale, which defaults to its decode timestep 0); the initial latents
    are PCG32 on the host.  A cold and a warm request, each exactly 28 x 8
    K1, 168 K3 and 8 + 1 R1; then the warm request again with every R1
    draw made by the plain version on the card, whose final latents and
    video the warm request is held to within ``SLICE_TOL``."""
    from candle_video_tpu_torch.ops.kernels import threefry_normal as TN

    pipe, _ = build_pipeline("stochastic", card, "0.9.6-2b-distilled")
    inf = pipe.config.inference
    steps = inf.num_inference_steps
    if not (inf.stochastic_sampling and steps == 8 and inf.guidance_scale == 1.0):
        raise AssertionError(f"0.9.6-2b-distilled is not the published stochastic preset: {inf}")
    want = {"flash_attention_packed": 28 * steps, "w8_matmul": 168, "w4_matmul": 0,
            "conv3d_igemm": 0, "threefry_normal": steps + 1}
    prompt = "A heron standing in a misty marsh at dawn"
    finals = []

    def keep_final(i, n, lat):
        if i == n - 1:
            finals.append(lat.clone())

    rows, videos = [], []
    for name in ("cold", "warm"):
        row, video = run_request(pipe, name, prompt, 60, want, card, tag="stochastic",
                                 step_callback=keep_final)
        rows.append(row)
    videos.append(video)
    kernel = TN.threefry_normal
    TN.threefry_normal = lambda keys, n, dtype=torch.float32, device="cpu": \
        TN.threefry_normal_plain(keys, n, dtype, device)
    try:
        row, video = run_request(pipe, "plain draws", prompt, 60,
                                 dict(want, threefry_normal=0), card, tag="stochastic",
                                 step_callback=keep_final)
    finally:
        TN.threefry_normal = kernel
    videos.append(video)
    rel = ((finals[1] - finals[2]).norm() / finals[2].norm()).item()
    db = psnr(videos[0], videos[1])
    RESULTS["stochastic"] = dict(requests=rows, plain_draws=row, latent_rel_vs_plain=rel,
                                 video_psnr_vs_plain_db=db)
    log(f"[stochastic] 0.9.6-2b-distilled, the warm request against the same request on the "
        f"plain draws: final latents rel={rel:.3e}, video PSNR={db:.2f} dB | {card}")
    if not (rel <= SLICE_TOL["latent_rel"] and db >= SLICE_TOL["video_psnr"]):
        raise AssertionError(f"stochastic: the R1 request disagrees with the plain draws' "
                             f"(rel {rel}, {db} dB)")
    release(pipe)
    return rows[-1]["launches"]


@contextlib.contextmanager
def conv_impl(impl):
    """``CVT_CONV3D_IMPL`` set to ``impl`` inside the block."""
    saved = os.environ.get("CVT_CONV3D_IMPL")
    os.environ["CVT_CONV3D_IMPL"] = impl
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CVT_CONV3D_IMPL"]
        else:
            os.environ["CVT_CONV3D_IMPL"] = saved


# Each layout and conv route's decode against the NCDHW cuDNN decode of the
# same latents, on [0, 255].  All run bf16 convs with f32 sums; a 44-conv
# random-weight decoder carries one-ulp differences forward.  Prediction
# before the first run: 45-60 dB.
IGEMM_DECODE_PSNR_DB = 40.0
# The layouts and conv routes in turns: the four, then the four reversed.
LAYOUT_ROUTES = (("ncdhw", "xla"), ("cl", "xla"), ("cl", "igemm"), ("ncdhw", "igemm"))


def layout_route_turns(run, want_k8: int, what: str):
    """``run(channels_last)`` -> (output, seconds, peak bytes) in each
    layout and conv route (``CVT_CONV3D_IMPL``), in turns.  Each run's K8
    launches must be ``want_k8`` on the igemm route and 0 on cuDNN, and the
    channels-last runs may copy no K8 input to channels last.  -> ({name:
    [rows]}, {name: the first run's output on the host})."""
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.ops.kernels import conv3d_igemm as K8

    runs, outs = {}, {}
    for layout, impl in LAYOUT_ROUTES + LAYOUT_ROUTES[::-1]:
        name = f"{layout}-{'cudnn' if impl == 'xla' else 'igemm'}"
        _build.reset_launches()
        K8.RELAYOUT.clear()
        with conv_impl(impl):
            out, sec, peak = run(layout == "cl")
        launches, relayout = dict(_build.LAUNCHES), dict(K8.RELAYOUT)
        want = want_k8 if impl == "igemm" else 0
        if launches.get("conv3d_igemm", 0) != want:
            raise AssertionError(f"{name} {what}: launch counts {launches}, want {want} K8")
        if layout == "cl" and relayout.get("copies", 0):
            raise AssertionError(f"{name} {what}: {relayout} copies to channels last before K8")
        runs.setdefault(name, []).append(dict(
            seconds=sec, peak_gib=peak / 2**30, launches=launches,
            relayout_copies=relayout.get("copies", 0),
            relayout_gib=relayout.get("bytes", 0) / 2**30))
        outs.setdefault(name, out.float().cpu())
        del out
    return runs, outs


def turns_line(runs) -> str:
    return "; ".join(f"{name} " + ", ".join(f"{r['seconds']:.4f}" for r in rows)
                     + f" s peak {rows[0]['peak_gib']:.2f} GiB copies {rows[0]['relayout_copies']}"
                     for name, rows in runs.items())


# The decoder's four conv widths at their 97-frame shapes (the mid block,
# then the up blocks' resnets): channels, frames, height, width.
DECODER_CONV_SHAPES = ((1024, 13, 16, 24), (512, 25, 32, 48), (256, 49, 64, 96),
                       (128, 97, 128, 192))


def check_conv_layouts(card):
    """cuDNN's bf16 3x3x3 conv at the decoder's widths on an NCDHW input
    and on a ``channels_last_3d`` view with the ``[O, I, 3, 3, 3]`` weight
    as it is (``causal_conv3d_cl``'s call, which must write
    ``channels_last_3d``: else every channels-last conv would copy)."""
    rows = []
    for c, t, h, w in DECODER_CONV_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(c)
        x = torch.randn(1, c, t + 2, h, w, generator=g, device="cuda").bfloat16()
        wt = (torch.randn(c, c, 3, 3, 3, generator=g, device="cuda") * 0.02).bfloat16()
        b = torch.zeros(c, device="cuda").bfloat16()
        xcl = x.contiguous(memory_format=torch.channels_last_3d)
        y = F.conv3d(xcl, wt, b, padding=(0, 1, 1))
        if not y.is_contiguous(memory_format=torch.channels_last_3d):
            raise AssertionError(f"cuDNN wrote {c} ch NDHWC as NCDHW: the walk would copy")
        rows.append(dict(
            shape=[c, t, h, w],
            ncdhw_ms=cuda_ms(lambda: F.conv3d(x, wt, b, padding=(0, 1, 1))),
            ndhwc_ms=cuda_ms(lambda: F.conv3d(xcl, wt, b, padding=(0, 1, 1)))))
        r = rows[-1]
        log(f"[conv layouts] cuDNN bf16 {c} ch {t}x{h}x{w}: NCDHW {r['ncdhw_ms']:.3f} ms, "
            f"NDHWC {r['ndhwc_ms']:.3f} ms | {card}")
        del x, xcl, y
    RESULTS["conv_layouts"] = rows


def check_igemm_decode(card, decoder, z, temb):
    """The dense 97-frame decode of a request's latents in both layouts
    (``channels_last``), each on cuDNN and with every eligible conv on K8
    (``CVT_CONV3D_IMPL=igemm``: exactly 44 launches, conv_out stays on
    cuDNN), in turns: the time and peak of each, each video's PSNR
    against the NCDHW cuDNN decode's, and the channels-last copies before a
    K8 conv (none in channels-last; the NCDHW walk's timed from one such
    copy at the tail's size).  cuDNN's conv layouts first."""
    check_conv_layouts(card)
    runs, videos = layout_route_turns(lambda cl: decode_peak(decoder, z, temb, channels_last=cl),
                                      44, "decode")
    want = videos["ncdhw-cudnn"]
    db = {name: psnr(v, want) for name, v in videos.items() if name != "ncdhw-cudnn"}
    x = torch.randn(1, 128, 97, 128, 192, device="cuda").bfloat16()
    copy_ms = cuda_ms(lambda: x.contiguous(memory_format=torch.channels_last_3d))
    copy_gbs = 2 * x.numel() / copy_ms / 1e6
    relayout_gib = runs["ncdhw-igemm"][0]["relayout_gib"]
    row = dict(shape=list(z.shape), runs=runs, psnr_db=db,
               max_abs={name: (v - want).abs().max().item() for name, v in videos.items()},
               relayout_copy_gb_s=copy_gbs,
               relayout_est_ms=relayout_gib * 2**30 / copy_gbs / 1e6)
    log(f"[decode-k8] dense 97f decode of the e2e latents {tuple(z.shape)}, seconds in turns: "
        f"{turns_line(runs)}; video PSNR vs NCDHW cuDNN "
        + ", ".join(f"{k} {v:.2f} dB" for k, v in db.items())
        + f"; the NCDHW walk's {runs['ncdhw-igemm'][0]['relayout_copies']} copies before K8 "
        f"({relayout_gib:.2f} GiB, about {row['relayout_est_ms']:.1f} ms at the measured "
        f"{copy_gbs:.0f} GB/s) | {card}")
    if not (min(db.values()) >= IGEMM_DECODE_PSNR_DB
            and all(torch.isfinite(v).all() for v in videos.values())):
        raise AssertionError(f"a decode disagrees with the NCDHW cuDNN decode: {db}")
    RESULTS["decode_k8"] = row
    return runs["cl-igemm"][-1]["launches"]


# ---------------------------------------------------------------------------
# image-to-video: the VAE encoder, per-token timesteps, tiling
# ---------------------------------------------------------------------------

# The tiny slices' tiling: 32x32-pixel tiles every 24, 8 frames every 4, so
# the 64x96x17 sample (8x12x5 latents) spans 3x4 tiles in space and 4 in time.
TINY_TILING = dict(tile_sample_min_height=32, tile_sample_min_width=32,
                   tile_sample_min_num_frames=8, tile_sample_stride_height=24,
                   tile_sample_stride_width=24, tile_sample_stride_num_frames=4)
# The tiled encode's moments, card bf16 against the CPU f32 run, rel in
# norm: the CPU's own bf16 run reads 8.8e-3.
TILED_ENCODE_REL = 2e-2


@contextlib.contextmanager
def kept_anchors():
    """A list that receives each anchor's normalised latents [B, C, 1, h, w]
    as ``generate`` makes them, inside the block."""
    from candle_video_tpu_torch.models.ltx_video import pipeline as P

    anchors, make = [], P._anchor_latents

    def keep(*a, **k):
        anchors.append(make(*a, **k))
        return anchors[-1]

    P._anchor_latents = keep
    try:
        yield anchors
    finally:
        P._anchor_latents = make


def tiny_i2v_config():
    """The tiny t2v slice's DiT and decoder, and an encoder of the same
    compression (patch 2, two spatiotemporal downsamplers: 8x space, 4x
    time)."""
    from candle_video_tpu_torch.models.ltx_video import configs as C

    preset = C.get_config_by_version("0.9.8-2b-distilled")
    return C.LtxFullConfig(
        inference=preset.inference,
        transformer=C.LtxTransformerConfig(in_channels=8, out_channels=8,
                                           num_attention_heads=4, num_layers=2,
                                           caption_channels=64),
        vae=C.LtxVaeConfig(latent_channels=8, block_out_channels=(16, 32, 64),
                           layers_per_block=(1, 1, 2), spatiotemporal_scaling=(True, True),
                           downsample_types=("spatiotemporal", "spatiotemporal"),
                           decoder_block_out_channels=(16, 32),
                           decoder_spatiotemporal_scaling=(True, True),
                           decoder_layers_per_block=(1, 1, 1),
                           decoder_upsample_residual=(True, True),
                           decoder_upsample_factor=(2, 2), patch_size=2,
                           spatial_compression_ratio=8, temporal_compression_ratio=4),
        scheduler=preset.scheduler)


def check_i2v_slice(card):
    """The tiny image-to-video slice on the card (kernels, bf16) against the
    same weights and image on the CPU (plain versions, f32): an image anchor
    on frame 0 through the encoder, the per-token AdaLN and the per-token
    steps (K1 7 steps x 2 layers), then the video; the anchor's frame after
    the loop equal to its normalised latents.  The anchor is taken at its posterior mean
    (``"argmax"``): a bf16 encoder draws its posterior sample from another
    stream than an f32 one (``utils/rng.normal``), so ``"sample"`` would
    compare two draws.  Then a tiled encode and a tiled decode over several
    tiles in space and time against the CPU's."""
    from candle_video_tpu_torch.models.ltx_video import configs as C
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.models.ltx_video import t5 as T5
    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.models.ltx_video import vae as V
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.utils.tokenizer import MockTokenizer

    cfg = tiny_i2v_config()
    t5cfg = C.T5Config(vocab_size=128, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                       num_heads=4)
    g = torch.Generator().manual_seed(3)
    tok = MockTokenizer(vocab_size=128, model_max_length=32)
    cpu = P.LtxPipeline(cfg, TF.init_random(cfg.transformer, "cpu", torch.float32, g),
                        V.init_random(cfg.vae, "cpu", torch.float32, g),
                        T5.init_random_int8(t5cfg, "cpu", torch.float32, 0.01), t5cfg, tok,
                        vae_encoder=V.init_random_encoder(cfg.vae, "cpu", torch.float32, g))
    gpu = P.LtxPipeline(cfg, copy.deepcopy(cpu.transformer).to("cuda", torch.bfloat16),
                        copy.deepcopy(cpu.vae).to("cuda", torch.bfloat16),
                        T5.init_random_int8(t5cfg, "cuda", torch.bfloat16, 0.01), t5cfg, tok,
                        vae_encoder=copy.deepcopy(cpu.vae_encoder).to("cuda", torch.bfloat16))
    image = torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(4)) * 2 - 1
    kw = dict(prompt="a red fox in the snow", height=64, width=96, num_frames=9, seed=7,
              max_sequence_length=32, decode_noise=torch.zeros(1, 8, 3, 8, 12), image=image,
              conditioning_sample_mode="argmax")
    lat_c = P.generate(cpu, output_type="latent", **kw)
    _build.reset_launches()
    with kept_anchors() as anchors:
        lat_g = P.generate(gpu, output_type="latent", **kw).cpu()
    launches = dict(_build.LAUNCHES)
    want_k1 = cfg.inference.num_inference_steps * cfg.transformer.num_layers
    if launches.get("flash_attention_packed", 0) != want_k1:
        raise AssertionError(f"tiny i2v slice launches {launches}, want {want_k1} K1")
    vid_c = P.generate(cpu, **kw)
    vid_g = P.generate(gpu, **kw).cpu()
    rel = ((lat_g - lat_c).norm() / lat_c.norm()).item()
    db = psnr(vid_g, vid_c)
    held = torch.equal(lat_g[:, :8 * 12], P.pack_latents(anchors[0], 1, 1).cpu())
    log(f"[i2v-slice] tiny i2v (image anchor on frame 0, argmax), card bf16 kernels vs CPU "
        f"f32 plain: latent rel={rel:.3e} video PSNR={db:.2f} dB, frame 0 equal to the "
        f"normalised anchor after the loop: {held}; launches={launches} | {card}")
    if not (rel <= SLICE_TOL["latent_rel"] and db >= SLICE_TOL["video_psnr"] and held):
        raise AssertionError(f"tiny i2v disagrees with the CPU reference: rel={rel} "
                             f"psnr={db} held={held}")

    tiling = V.TilingConfig(**TINY_TILING)
    x = torch.rand(1, 3, 17, 64, 96, generator=torch.Generator().manual_seed(5)) * 2 - 1
    enc_kw = dict(tiling=tiling, use_tiling=True, use_framewise_encoding=True)
    enc_c = V.encode(cpu.vae_encoder, x, **enc_kw)
    enc_g = V.encode(gpu.vae_encoder, x.cuda(), **enc_kw).float().cpu()
    enc_rel = ((enc_g - enc_c).norm() / enc_c.norm()).item()
    z = torch.randn(1, 8, 5, 8, 12, generator=torch.Generator().manual_seed(6))
    temb = torch.tensor([0.05])
    dec_kw = dict(tiling=tiling, use_tiling=True, use_framewise_decoding=True)
    dec_c = P.postprocess_video(V.decode(cpu.vae, z, temb, **dec_kw))
    dec_g = P.postprocess_video(V.decode(gpu.vae, z.cuda(), temb.cuda(), **dec_kw)).cpu()
    dec_db = psnr(dec_g, dec_c)
    log(f"[i2v-slice] tiny tiled encode (17x64x96, 4 temporal tiles of 3x4): moments "
        f"{tuple(enc_g.shape)} rel={enc_rel:.3e}; tiled decode (5x8x12 latents): video "
        f"{tuple(dec_g.shape)} PSNR={dec_db:.2f} dB, card bf16 vs CPU f32 | {card}")
    if not (enc_rel <= TILED_ENCODE_REL and dec_db >= SLICE_TOL["video_psnr"]
            and tuple(enc_g.shape) == (1, 16, 5, 8, 12)
            and tuple(dec_g.shape) == (1, 3, 17, 64, 96)):
        raise AssertionError(f"tiny tiled encode/decode disagree with the CPU: "
                             f"rel={enc_rel} psnr={dec_db}")
    RESULTS["i2v_slice"] = dict(latent_rel=rel, video_psnr=db, launches=launches,
                                tiled_encode_rel=enc_rel, tiled_decode_psnr=dec_db)


def encode_peak(encoder, x, channels_last=None):
    """A dense encode -> (moments, seconds, peak bytes above what was
    allocated before it)."""
    from candle_video_tpu_torch.models.ltx_video import vae as V

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    moments = V.encode(encoder, x, use_tiling=False, channels_last=channels_last)
    torch.cuda.synchronize()
    return moments, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def range_psnr(got, want) -> float:
    """PSNR in dB over the reference's peak-to-peak range (the video's
    [0, 255] for moments, which have no fixed range)."""
    mse = (got.double() - want.double()).square().mean().item()
    span = (want.max() - want.min()).double().item()
    return float("inf") if mse == 0 else 10 * math.log10(span ** 2 / mse)


# Each layout and conv route's 97-frame encode against the NCDHW cuDNN encode
# of the same video: the igemm decode's gate.  Prediction before the first
# run: 45-60 dB.
IGEMM_ENCODE_PSNR_DB = 40.0


def check_igemm_encode(card, encoder):
    """The dense 97-frame encode of a random 1x3x97x512x768 bf16 video in
    [-1, 1] in both layouts, each on cuDNN and with every eligible conv on
    K8 (exactly 41 launches; conv_in 48 -> 128, the first downsampler's 128
    -> 64 and conv_out 2048 -> 129 stay on cuDNN), in turns: times, peaks,
    the channels-last copies before K8 (none in channels-last), and each
    set of moments' PSNR against the NCDHW cuDNN encode's."""
    g = torch.Generator(device="cuda").manual_seed(11)
    x = (torch.rand(1, 3, 97, 512, 768, generator=g, device="cuda") * 2 - 1).bfloat16()
    runs, moments = layout_route_turns(lambda cl: encode_peak(encoder, x, cl), 41, "encode")
    want = moments["ncdhw-cudnn"]
    if tuple(want.shape) != (1, 256, 13, 16, 24):
        raise AssertionError(f"encode moments {tuple(want.shape)}")
    db = {name: range_psnr(m, want) for name, m in moments.items() if name != "ncdhw-cudnn"}
    rel = {name: ((m - want).norm() / want.norm()).item() for name, m in moments.items()}
    row = dict(runs=runs, psnr_db=db, rel=rel)
    log(f"[encode-k8] dense 97f encode of 1x3x97x512x768 bf16, seconds in turns: "
        f"{turns_line(runs)}; moments PSNR vs NCDHW cuDNN "
        + ", ".join(f"{k} {v:.2f} dB (rel {rel[k]:.3e})" for k, v in db.items()) + f" | {card}")
    if not (min(db.values()) >= IGEMM_ENCODE_PSNR_DB
            and all(torch.isfinite(m).all() for m in moments.values())):
        raise AssertionError(f"an encode disagrees with the NCDHW cuDNN encode: {row}")
    RESULTS["encode_k8"] = row
    return runs["cl-igemm"][-1]["launches"]


def check_tiled_decode(card, decoder, z, temb):
    """The full-size tiled decode (``use_tiling`` and
    ``use_framewise_decoding`` with the default ``TilingConfig``: 13
    temporal tiles of 2x2 spatial tiles at 13x16x24 latents) against the
    dense decode of the same latents: shape, finite, its peak below the
    dense decode's; time and PSNR (approximate by design: printed, not
    held)."""
    dense, dense_s, dense_peak = decode_peak(decoder, z, temb)
    tiled, tiled_s, tiled_peak = decode_peak(decoder, z, temb, use_tiling=True,
                                             use_framewise_decoding=True)
    db = psnr(tiled, dense)
    row = dict(dense_s=dense_s, dense_peak_gib=dense_peak / 2**30, tiled_s=tiled_s,
               tiled_peak_gib=tiled_peak / 2**30, psnr_db=db)
    log(f"[tiled-decode] {tuple(z.shape)} latents: dense {dense_s:.4f} s peak "
        f"{row['dense_peak_gib']:.2f} GiB; tiled (13 temporal x 2x2 spatial tiles) "
        f"{tiled_s:.4f} s peak {row['tiled_peak_gib']:.2f} GiB; PSNR tiled vs dense "
        f"{db:.2f} dB (blended seams: not held) | {card}")
    if tiled.shape != dense.shape or not torch.isfinite(tiled).all():
        raise AssertionError(f"tiled decode: shape {tuple(tiled.shape)}, dense "
                             f"{tuple(dense.shape)}")
    if not tiled_peak < dense_peak:
        raise AssertionError(f"tiled decode peak {tiled_peak} not below dense {dense_peak}")
    RESULTS["tiled_decode"] = row


def run_i2v(card):
    """The 2B 512x768x97 image-to-video request: random weights, one random
    image in [-1, 1] as a hard anchor on frame 0, the prompt through the
    int8 T5: a warm-up and a timed request (exactly 196 K1 and 168 K3 each;
    the anchor's frame after the loop bit-equal to its normalised latents;
    stage times and peak); then a two-anchor request (frame 0 at strength 1,
    the last latent frame at 0.9: finite, frame 0 held exactly).  Then the
    97-frame encode on cuDNN and on K8, and the tiled decode of the timed
    request's latents against their dense decode."""
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.models.ltx_video import vae as V

    pipe, _ = build_pipeline("i2v", card, "0.9.8-2b-distilled")
    g = torch.Generator(device="cuda").manual_seed(12)
    image = torch.rand(1, 3, 512, 768, generator=g, device="cuda") * 2 - 1
    # R1: one bf16 posterior sample per anchor, and the decode noise
    want = {"flash_attention_packed": 196, "w8_matmul": 168, "conv3d_igemm": 0,
            "threefry_normal": 2}
    frame0 = 16 * 24
    finals, decoded = [], {}
    decode = V.decode

    def keep_latents(decoder, z, temb=None, **kw):
        decoded.update(z=z, temb=temb)
        return decode(decoder, z, temb, **kw)

    def held(anchor):
        return torch.equal(finals[-1][:, :frame0], P.pack_latents(anchor, 1, 1))

    def keep_final(k, n, lat):
        finals[:] = [lat]

    rows = []
    V.decode = keep_latents
    try:
        with kept_anchors() as anchors:
            for i, name in enumerate(("warm-up", "timed")):
                row, _ = run_request(pipe, name, "A kite over a windy beach", 50 + i, want,
                                     card, tag="i2v", image=image, step_callback=keep_final)
                row["anchor_held"] = held(anchors[-1])
                rows.append(row)
                if not row["anchor_held"]:
                    raise AssertionError(f"i2v {name}: the conditioned frame moved")
            two = [P.ConditioningItem(image=image, frame_index=0),
                   P.ConditioningItem(image=image.flip(-1), frame_index=12, strength=0.9)]
            row, _ = run_request(pipe, "two anchors", "A kite over a windy beach", 52,
                                 dict(want, threefry_normal=3), card, tag="i2v",
                                 conditioning=two, step_callback=keep_final)
            row["anchor_held"] = held(anchors[-2])
            if not (row["anchor_held"] and torch.isfinite(finals[-1]).all()):
                raise AssertionError("i2v two anchors: frame 0 moved or the latents are not "
                                     "finite")
            rows.append(row)
    finally:
        V.decode = decode
    log(f"[i2v] the anchor's latent frame after the loop equals its normalised latents: "
        f"{[r['anchor_held'] for r in rows]} | {card}")
    RESULTS["i2v"] = rows
    finals.clear()
    launches_k8 = check_igemm_encode(card, pipe.vae_encoder)
    check_tiled_decode(card, pipe.vae, decoded["z"], decoded["temb"])
    release(pipe)
    return rows[1]["launches"], launches_k8


# The W8A8 request's final latents against the bf16 request's (same seed,
# weights, prompt).  Prediction before the first run: 0.5e-2 to 3e-2 (the
# JAX docstring's ~1.4% per forward on random 2B weights, over 7 steps).
W8A8_LATENT_REL = 5e-2


def run_w8a8(card):
    """The 2B 512x768x97 request on the W8A8 tier: the dense pipeline's
    bf16 request first, then ``quantize_transformer_w8a8`` in place and the
    same request cold and warm.  Every DiT block linear runs on K7 (28
    layers x 10 x 7 steps = 1960), self-attention on K1 (196) and the T5 on
    K3 (168).  Step and request times beside the bf16 request's, and the
    final latents' relative difference from it."""
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.models.ltx_video import transformer as TF

    pipe, gib = build_pipeline("w8a8", card, "0.9.8-2b-distilled")
    finals, loop = [], P.denoise_loop

    def keep(*a, **kw):
        finals.append(loop(*a, **kw))
        return finals[-1]

    prompt, seed = "A sailboat crossing a bay at sunset", 43  # run_e2e's warm request
    P.denoise_loop = keep
    try:
        dense, ref = run_request(pipe, "bf16", prompt, seed,
                                 {"flash_attention_packed": 196, "w8_matmul": 168,
                                  "w8a8_matmul": 0}, card, tag="w8a8")
        ref = ref.cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        TF.quantize_transformer_w8a8(pipe.transformer)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        gib_q = resident_gib(pipe.transformer)
        log(f"[w8a8] quantize_transformer_w8a8 on the card in {quantize_s:.2f} s: resident DiT "
            f"{gib['dit']:.2f} -> {gib_q:.2f} GiB | {card}")
        want = {"w8a8_matmul": 1960, "flash_attention_packed": 196, "w8_matmul": 168,
                "conv3d_igemm": 0}
        runs = []
        for name in ("cold", "warm"):
            row, video = run_request(pipe, name, prompt, seed, want, card, tag="w8a8")
            rel = ((finals[-1] - finals[0]).norm() / finals[0].norm()).item()
            row.update(latent_rel=rel, video_psnr=psnr(video.cpu(), ref))
            del video
            log(f"[w8a8] {name} against the bf16 request: latent rel={rel:.3e} video "
                f"PSNR={row['video_psnr']:.2f} dB; step mean {row['denoise_step_mean_ms']:.1f} "
                f"ms vs {dense['denoise_step_mean_ms']:.1f} ms bf16 | {card}")
            if not rel <= W8A8_LATENT_REL:
                raise AssertionError(f"the W8A8 request drifts from the bf16 one: {row}")
            runs.append(row)
    finally:
        P.denoise_loop = loop
    RESULTS["e2e_w8a8"] = dict(resident_gib_bf16=gib["dit"], resident_gib_w8a8=gib_q,
                               quantize_s=quantize_s, bf16=dense, runs=runs)
    release(pipe)
    return runs[-1]["launches"]


@contextlib.contextmanager
def ring_of_one():
    """A one-rank NCCL process group, met through a FileStore in a temporary
    directory (no port), destroyed on the way out."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def run_sp(card):
    """The sequence-parallel path in a ring of one: a one-rank NCCL group
    (through a FileStore in a temporary directory, no port), the 2B
    512x768x97 request through ``generate(sp_mesh=make_mesh(sp=1))`` cold
    and warm (every DiT self-attention on K5: 28 layers x 7 steps, none on
    K1), each against the same request without the mesh, at the same seed
    and weights, by its final latents and its video."""
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.parallel import make_mesh

    pipe, _ = build_pipeline("sp", card, "0.9.8-2b-distilled")
    finals = []
    loops = P.denoise_loop, P.denoise_loop_sp

    def keep(loop):
        def run(*a, **kw):
            finals.append(loop(*a, **kw))
            return finals[-1]
        return run

    prompt, seed = "A koi pond in the rain", 70
    with ring_of_one():
        P.denoise_loop, P.denoise_loop_sp = map(keep, loops)
        try:
            mesh = make_mesh(sp=1)
            _, ref = run_request(pipe, "no mesh", prompt, seed,
                                 {"flash_attention_packed": 196, "ring_chunk_update": 0,
                                  "w8_matmul": 168}, card, tag="sp")
            ref = ref.cpu()  # off the card, so that the SP requests' peaks are their own
            want = {"ring_chunk_update": 196, "flash_attention_packed": 0, "w8_matmul": 168}
            runs = []
            for name in ("cold", "warm"):
                row, video = run_request(pipe, f"sp=1 {name}", prompt, seed, want, card,
                                         tag="sp", sp_mesh=mesh)
                rel = ((finals[-1] - finals[0]).norm() / finals[0].norm()).item()
                row.update(latent_rel=rel, video_psnr=psnr(video.cpu(), ref))
                del video
                log(f"[sp] sp=1 {name} against the request without the mesh: latent "
                    f"rel={rel:.3e} video PSNR={row['video_psnr']:.2f} dB | {card}")
                if not (rel <= SLICE_TOL["latent_rel"]
                        and row["video_psnr"] >= SLICE_TOL["video_psnr"]):
                    raise AssertionError(f"sp=1 {name} disagrees with the request without "
                                         f"the mesh: {row}")
                runs.append(row)
        finally:
            P.denoise_loop, P.denoise_loop_sp = loops
    RESULTS["e2e_sp"] = runs
    release(pipe)
    return runs[-1]["launches"]


def psnr(got, want) -> float:
    mse = (got.double() - want.double()).square().mean().item()
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def decode_peak(decoder, z, temb, **mode):
    """A decode in ``mode`` -> (video in [0, 255], seconds, peak bytes the
    decode allocated above what was allocated before it)."""
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.models.ltx_video import vae as V

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    video = V.decode(decoder, z, temb, **mode)
    torch.cuda.synchronize()
    sec, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base
    return P.postprocess_video(video), sec, peak


def forced_mode(cfg, shape, kind):
    """The pick of ``select_decode_mode`` of this kind ("tail" or "ups") as
    the free memory it is told falls, the one whose chunk count is nearest 4
    (with the card's peaks the ladder picks the tail stream in 2 chunks)."""
    from candle_video_tpu_torch.models.ltx_video import vae as V

    picks = []
    for i in range(400):
        try:
            picked = V.select_decode_mode(cfg, shape, free_bytes=int(80e9 * 0.97 ** i))
        except ValueError:  # below the ups-split stream, too few frames for the full
            break
        if "tail_stream_chunks" in picked and \
                picked.get("tail_stream_from_ups", False) == (kind == "ups"):
            picks.append(picked)
    if not picks:
        raise AssertionError(f"select_decode_mode never picks the {kind} stream for {shape}")
    return min(picks, key=lambda m: abs(m["tail_stream_chunks"] - 4))


def check_decode_modes(card, decoder, z, temb, dense_video):
    """The exact decode modes on the latents ``z`` a 257-frame request
    decoded, forced by telling ``select_decode_mode`` less free memory, each
    against the request's dense video; the same modes' peaks on random
    97-frame latents; the full stream, which needs 46 latent frames for two
    chunks, on random latents of 47 at 128x192.  The peaks per output
    pixel-frame are the measurement behind ``vae._*_PEAK_B_PER_PX``; the
    tail stream is also decoded in 4 chunks."""
    from candle_video_tpu_torch.models.ltx_video import vae as V

    cfg = decoder.cfg
    g = torch.Generator(device="cuda").manual_seed(5)
    free = V._device_free_bytes("cuda")
    log(f"[decode] free {free / 2**30:.2f} GiB with the 2B pipeline resident: "
        f"select_decode_mode picks {V.select_decode_mode(cfg, z.shape, device='cuda') or 'dense'}"
        f" for {tuple(z.shape)} | {card}")
    rows = []

    def measure(label, zz, tt, mode, want=None, limit=None, dec=decoder):
        px = zz.shape[0] * zz.shape[2] * cfg.temporal_compression_ratio * \
            zz.shape[3] * zz.shape[4] * cfg.spatial_compression_ratio ** 2
        video, sec, peak = decode_peak(dec, zz, tt, **mode)
        row = dict(label=label, mode=mode, shape=list(zz.shape), seconds=sec,
                   peak_gib=peak / 2**30, peak_b_per_px=peak / px)
        msg = ""
        if want is not None:
            row.update(psnr_db=psnr(video, want),
                       max_abs=(video - want).abs().max().item())
            msg = f" vs dense: PSNR={row['psnr_db']:.2f} dB max_abs={row['max_abs']:.3f}"
            if not (row["psnr_db"] >= limit and torch.isfinite(video).all()):
                raise AssertionError(f"decode {label} {mode} disagrees with dense: {row}")
        log(f"[decode] {label} {mode or 'dense'}: {sec:.3f} s peak {row['peak_gib']:.2f} GiB "
            f"({row['peak_b_per_px']:.1f} B/px){msg} | {card}")
        rows.append(row)
        return video

    measure("257f", z, temb, {}, dense_video, math.inf)  # the request's decode again
    for kind in ("tail", "ups"):
        picked = forced_mode(cfg, tuple(z.shape), kind)
        for mode in [picked] + ([dict(picked, tail_stream_chunks=4)]
                                if picked["tail_stream_chunks"] != 4 else []):
            measure("257f", z, temb, mode, dense_video, DECODE_PSNR_DB["tail"])
    z97 = torch.randn(1, cfg.latent_channels, 13, 16, 24, generator=g, device="cuda")
    for mode in ({}, {"tail_stream_chunks": 2}, {"tail_stream_chunks": 4},
                 {"tail_stream_chunks": 4, "tail_stream_from_ups": True}):
        measure("97f random", z97, temb, mode)
    need = V.fullstream_first_chunk_min(cfg)
    z369 = torch.randn(1, cfg.latent_channels, 2 * need + 1, 4, 6, generator=g, device="cuda")
    dense369 = measure("128x192x369 random", z369, temb, {})
    measure("128x192x369 random", z369, temb, {"full_stream_chunks": 2}, dense369,
            DECODE_PSNR_DB["full_bf16"])
    # the same in f32: what is left of the bf16 gap is the streamed decode's own
    dec32 = copy.deepcopy(decoder).float()
    dense32 = measure("128x192x369 random f32", z369, temb, {}, dec=dec32)
    measure("128x192x369 random f32", z369, temb, {"full_stream_chunks": 2}, dense32,
            DECODE_PSNR_DB["full_f32"], dec=dec32)
    del dec32
    RESULTS["decode_modes"] = dict(full_stream_first_chunk_min=need, rows=rows)


def run_long(card):
    """The 2B preset's 257-frame clip (S = 33·16·24 = 12672): every DiT
    self-attention routes to K2 (28 layers x 7 steps), none to K1.  The
    warm request's decoded latents then feed the decode-mode check."""
    from candle_video_tpu_torch.models.ltx_video import vae as V

    pipe, _ = build_pipeline("long", card, "0.9.8-2b-distilled")
    want = {"flash_attention_packed_long": 196, "flash_attention_packed": 0,
            "w8_matmul": 168, "w4_matmul": 0}
    decoded = {}
    decode = V.decode

    def keep_latents(decoder, z, temb=None, **kw):
        decoded.update(z=z, temb=temb)
        return decode(decoder, z, temb, **kw)

    runs = []
    for i, (name, prompt) in enumerate([("cold", "A river winding through a forest"),
                                        ("warm", "A train crossing a snowy bridge")]):
        V.decode = keep_latents
        try:
            row, video = run_request(pipe, name, prompt, 60 + i, want, card, tag="long",
                                     num_frames=257)
        finally:
            V.decode = decode
        runs.append(row)
    RESULTS["e2e_long"] = runs
    RESULTS["auto_decode"] = check_auto_decode(card, pipe, decoded["z"], decoded["temb"], want)
    check_decode_modes(card, pipe.vae, decoded["z"], decoded["temb"], video)
    del video
    release(pipe)
    return runs[-1]["launches"]


def check_auto_decode(card, pipe, z, temb, want):
    """On a 257-frame request's latents, ``vae.decode(auto_mode=True)``
    equals the decode in the mode ``select_decode_mode`` names for the
    card's free memory, bit for bit; then one more 257-frame request with
    ``vae_auto_decode=False``, whose ``decode_mode`` is logged (dense, as
    no chunk keyword is given)."""
    from candle_video_tpu_torch.models.ltx_video import vae as V

    picked = V.select_decode_mode(pipe.vae.cfg, z.shape, device="cuda")
    free_gib = V._device_free_bytes("cuda") / 2**30
    auto = V.decode(pipe.vae, z, temb, auto_mode=True)
    equal = torch.equal(auto, V.decode(pipe.vae, z, temb, **picked))
    del auto
    torch.cuda.empty_cache()
    row, _ = run_request(pipe, "vae_auto_decode=False", "A heron wading at dawn", 62, want,
                         card, tag="long", num_frames=257, vae_auto_decode=False)
    used = {k: v for k, v in row["decode_mode"].items() if v}
    log(f"[long] decode(auto_mode=True) with {free_gib:.2f} GiB free: mode {picked or 'dense'}, "
        f"bit-equal to the decode in that mode: {equal}; generate(vae_auto_decode=False) "
        f"decode_mode {used or 'dense'} | {card}")
    if not equal or used:
        raise AssertionError(f"auto_mode decode equal {equal}; vae_auto_decode=False ran {used}")
    return dict(picked=picked, free_gib=free_gib, bit_equal=equal, off_mode=row["decode_mode"],
                off_wall_s=row["wall_s"])


# The served 2B request (JAX ``benches/serving_bench.py``): 7 steps, embeds
# injected, jax.random initial latents, the streamed tail in 2 chunks
SERVING_BIG, SERVING_SMALL = (512, 768, 97, 7), (256, 384, 33, 7)
SERVING_REQUESTS = 6
# A batched request's video against the same request served alone, PSNR on
# [0, 255].  Bit-equal on an H100 (inf dB: cuBLAS reduces each row in the
# same order at M = 2 x 4992 as at 4992); the limit leaves room for another
# algorithm's bf16 rounding (the tiny slices read 47-51 dB against f32),
# and a batched video held against another request's single video must
# read below it.
SERVING_PSNR_DB = 50.0


def percentile(xs, p):
    """The JAX serving bench's nearest-rank percentile."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, round(p / 100 * (len(xs) - 1))))]


def served_burst(server, requests, timeout=600):
    """Submit ``requests`` at once, start the worker, and wait for every
    result: returns (results, sojourn seconds from submit to result,
    wall seconds from the first submit to the last result).  A result that
    is an exception fails the phase."""
    import threading

    t0 = time.perf_counter()
    slots = [dict(q=server.submit(r), t_in=time.perf_counter()) for r in requests]

    def wait(slot):
        slot["res"] = slot["q"].get(timeout=timeout)
        slot["t_out"] = time.perf_counter()

    threads = [threading.Thread(target=wait, args=(slot,), daemon=True) for slot in slots]
    for t in threads:
        t.start()
    server.start()
    try:
        for t in threads:
            t.join(timeout + 5)
    finally:
        server.stop()
    for i, slot in enumerate(slots):
        if "res" not in slot:
            raise AssertionError(f"served request {i} returned no result in {timeout} s")
        if isinstance(slot["res"], BaseException):
            raise AssertionError(f"served request {i} failed in the worker") from slot["res"]
        if not isinstance(slot["res"], torch.Tensor):
            raise AssertionError(f"served request {i} returned {slot['res']!r}")
    wall = max(slot["t_out"] for slot in slots) - t0
    return [slot["res"] for slot in slots], [slot["t_out"] - slot["t_in"] for slot in slots], wall


def trace_busy_ms(path):
    """The device's busy milliseconds in a Chrome trace that
    ``torch.profiler`` exported (the union of its kernel, copy and set
    spans) and the number of those spans."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(spans)


def trace_kernels(path):
    """Kernel name -> (summed milliseconds, spans) of the kernel spans in a
    Chrome trace that ``torch.profiler`` exported."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rows: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            ms, n = rows.get(e.get("name", ""), (0.0, 0))
            rows[e.get("name", "")] = (ms + e["dur"] / 1e3, n + 1)
    return rows


def host_draw_ms(fn, iters: int = 3) -> float:
    """Median host-clock milliseconds of ``fn``, host work only."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


@contextlib.contextmanager
def per_generate_records(serving_module, pipeline_module):
    """Each ``generate`` call the server makes inside the block appends
    its launch counts and the initial latents its denoise loop started from
    to the yielded list."""
    from candle_video_tpu_torch.ops.kernels import _build

    calls, started = [], []
    generate, loop = serving_module.generate, pipeline_module.denoise_loop

    def counted(*a, **kw):
        before = collections.Counter(_build.LAUNCHES)
        out = generate(*a, **kw)
        calls.append(dict(launches=dict(collections.Counter(_build.LAUNCHES) - before),
                          latents=started.pop()))
        return out

    def keep_latents(transformer, latents, *a, **kw):
        started.append(latents.clone())
        return loop(transformer, latents, *a, **kw)

    serving_module.generate, pipeline_module.denoise_loop = counted, keep_latents
    try:
        yield calls
    finally:
        serving_module.generate, pipeline_module.denoise_loop = generate, loop


def run_serving(card):
    """The serving runtime on the 2B preset with the int8 T5 resident, as
    the JAX ``benches/serving_bench.py`` drives it: bucket 512x768x97 at 7
    steps, embeds-injected requests (jax.random latents), the decode
    streamed in 2 tail chunks.  A burst of 6 at ``max_batch=2`` (videos/min,
    p50 and p95 sojourn), the same burst at ``max_batch=1`` (videos/min;
    each request served alone), a mixed burst interleaving the 256x384x33
    bucket, then a string prompt through the T5 (K3) and the same prompt
    from the embedding cache.  Between the bursts, a row's host draws are
    timed, and one batch of 2 is served under ``CVT_PROFILE``: its trace
    gives the device's busy time and idle share.  Holds each batched request's initial latents
    bit-equal to its single request's, its video within
    ``SERVING_PSNR_DB`` of it, exactly 196 K1 launches per generate call
    whatever its batch, no K3 launch for embeds, 168 for the first string
    request and none for its repeat; two R1 launches per batch or single
    request: a batch's ``rows_normal`` for its latents and one for its
    decode noise, made before its generate call, or a single request's two
    draws inside it.  A row's draws are timed on
    the host as the port made them before (NumPy, ``_row_latents``) and as
    R1 makes them now; the traced batch also gives R1's device time."""
    from candle_video_tpu_torch import serving as S
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.ops.kernels import _build

    pipe, _ = build_pipeline("serving", card, "0.9.8-2b-distilled")
    big, small = S.ShapeBucket(*SERVING_BIG), S.ShapeBucket(*SERVING_SMALL)
    gen_kw = dict(use_pcg_rng=False, vae_tail_stream_chunks=2)
    cap = pipe.config.transformer.caption_channels

    def request(i, bucket=big):
        g = torch.Generator().manual_seed(1000 + i)
        return S.Request(prompt_embeds=torch.randn(1, 128, cap, generator=g) * 0.02,
                         prompt_attention_mask=torch.ones(1, 128), bucket=bucket,
                         seed=100 + i)

    def check_calls(tag, calls, k3=0):
        for c in calls:
            # a batch draws its rows before its generate call, a single request in it
            want = {"flash_attention_packed": 196, "w8_matmul": k3,
                    "threefry_normal": 2 if c["latents"].shape[0] == 1 else 0}
            got = {k: c["launches"].get(k, 0) for k in want}
            if got != want:
                raise AssertionError(f"[serving] {tag}: a generate call launched {c['launches']}, "
                                     f"want {want}")

    rows = {}
    reqs = [request(i) for i in range(SERVING_REQUESTS)]
    # continuous batching at max_batch=2; both buckets warmed for the mixed burst
    server = S.VideoGenerationServer(pipe, [big, small], max_batch=2, **gen_kw)
    t0 = time.perf_counter()
    server.warmup()
    warm_s = time.perf_counter() - t0
    _build.reset_launches()
    with per_generate_records(S, P) as calls_b2:
        batched, lat_b2, wall_b2 = served_burst(server, reqs)
    launches_b2 = dict(_build.LAUNCHES)
    check_calls("max_batch=2", calls_b2)
    sizes = [c["latents"].shape[0] for c in calls_b2]
    if sizes != [2] * (SERVING_REQUESTS // 2):
        raise AssertionError(f"[serving] max_batch=2 burst ran batches of {sizes}")
    if launches_b2.get("threefry_normal", 0) != 2 * len(sizes):
        raise AssertionError(f"[serving] max_batch=2 burst launched {launches_b2}, want two "
                             f"R1 launches a batch of 2")
    rows["b2"] = dict(videos_per_min=SERVING_REQUESTS / wall_b2 * 60.0, wall_s=wall_b2,
                      p50_s=percentile(lat_b2, 50), p95_s=percentile(lat_b2, 95),
                      sojourn_s=lat_b2, warmup_s=warm_s, stats=server.stats(),
                      launches=launches_b2)

    # the same burst, each request its own generate call
    server1 = S.VideoGenerationServer(pipe, [big], max_batch=1, **gen_kw).warmup()
    with per_generate_records(S, P) as calls_b1:
        single, lat_b1, wall_b1 = served_burst(server1, reqs)
    check_calls("max_batch=1", calls_b1)
    rows["b1"] = dict(videos_per_min=SERVING_REQUESTS / wall_b1 * 60.0, wall_s=wall_b1,
                      p50_s=percentile(lat_b1, 50), p95_s=percentile(lat_b1, 95),
                      sojourn_s=lat_b1, stats=server1.stats())
    batched_latents = torch.cat([c["latents"] for c in calls_b2])
    psnrs = []
    for i in range(SERVING_REQUESTS):
        if not torch.equal(batched_latents[i:i + 1], calls_b1[i]["latents"]):
            raise AssertionError(f"[serving] request {i}: the batched initial latents differ "
                                 "from the single request's")
        psnrs.append(psnr(batched[i], single[i]))
    crossed = psnr(batched[0], single[1])
    rows.update(batched_vs_single_psnr_db=psnrs, batched_vs_other_request_psnr_db=crossed)
    if min(psnrs) < SERVING_PSNR_DB or crossed >= SERVING_PSNR_DB:
        raise AssertionError(f"[serving] batched videos against single: {psnrs} dB, want >= "
                             f"{SERVING_PSNR_DB}; against another request's {crossed} dB, "
                             "want below")
    del batched, single, batched_latents, calls_b1, calls_b2

    # where a batch's time goes: the host draws of one row, then one batch
    # of 2 traced through the server's CVT_PROFILE window
    from candle_video_tpu_torch.utils import rng as R

    seeds2, shape = [r.seed for r in reqs[:2]], server1._latent_shape(big)
    draws = dict(latents_ms=host_draw_ms(lambda: server1._row_latents(reqs[0], big)),
                 decode_noise_ms=host_draw_ms(lambda: server1._row_decode_noise(reqs[0], big)),
                 r1_2_rows_ms=cuda_ms(lambda: R.rows_normal(seeds2, shape, device="cuda")),
                 r1_2_rows_host_ms=host_ms(lambda: R.rows_normal(seeds2, shape, device="cuda")))
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CVT_PROFILE"] = tmp
        try:
            server = S.VideoGenerationServer(pipe, [big], max_batch=2, **gen_kw)
            served_burst(server, reqs[:2])
        finally:
            del os.environ["CVT_PROFILE"]
        names = sorted(os.listdir(tmp))
        if names != ["serve_00000_b2.trace.json"]:
            raise AssertionError(f"[serving] the traced batch of 2 wrote {names}")
        busy_ms, spans = trace_busy_ms(os.path.join(tmp, names[0]))
        kernels = trace_kernels(os.path.join(tmp, names[0]))
    r1 = [v for k, v in kernels.items() if "threefry_normal" in k]
    r1_ms, r1_spans = sum(v[0] for v in r1), sum(v[1] for v in r1)
    traced_ms = server.stats()["buckets"][str(big.key())]["last_ms"]
    if not spans:
        raise AssertionError("[serving] the traced batch holds no device span")
    rows["traced_b2"] = dict(
        ms=traced_ms, untraced_batch_ms=1e3 * wall_b2 / (SERVING_REQUESTS // 2),
        device_busy_ms=busy_ms, device_spans=spans, idle_share=1.0 - busy_ms / traced_ms,
        r1_trace_ms=r1_ms, r1_trace_spans=r1_spans,
        host_draws_2_rows_ms=2 * (draws["latents_ms"] + draws["decode_noise_ms"]),
        r1_host_2x2_rows_ms=2 * draws["r1_2_rows_host_ms"],
        trace_kernels={k: v for k, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:40]},
        trace_kernel_names=sorted(kernels)[:300],
        **draws)

    # a mixed burst: the big bucket interleaved with the small one
    mixed = [request(10 + i, big if i % 2 == 0 else small) for i in range(SERVING_REQUESTS)]
    server = S.VideoGenerationServer(pipe, [big, small], max_batch=2, **gen_kw)
    with per_generate_records(S, P) as calls_mixed:
        outs, lat_mixed, wall_mixed = served_burst(server, mixed)
    check_calls("mixed", calls_mixed)
    for i, out in enumerate(outs):
        b = mixed[i].bucket
        want = (1, 3, b.num_frames, b.height, b.width)
        if tuple(out.shape) != want:
            raise AssertionError(f"[serving] mixed request {i}: {tuple(out.shape)}, want {want}")
    rows["mixed"] = dict(videos_per_min=SERVING_REQUESTS / wall_mixed * 60.0,
                         wall_s=wall_mixed, sojourn_s=lat_mixed,
                         batches=[c["latents"].shape[0] for c in calls_mixed])
    del outs

    # a string prompt through the T5 on K3, then the same prompt from the cache
    pipe.embedding_cache_size = 16
    server = S.VideoGenerationServer(pipe, [big], max_batch=2, **gen_kw)
    prompt = "A koi pond in the rain, ripples spreading"
    with per_generate_records(S, P) as calls_text:
        texts, lat_text, _ = served_burst(
            server, [S.Request(prompt=prompt, bucket=big, seed=7 + i) for i in range(2)])
    check_calls("string prompt", calls_text[:1], k3=168)
    check_calls("string prompt again (cached)", calls_text[1:], k3=0)
    rows["string_prompt"] = dict(sojourn_s=lat_text,
                                 launches=[c["launches"] for c in calls_text])
    del texts
    RESULTS["serving"] = rows
    log(f"[serving] 2B {big.height}x{big.width}x{big.num_frames} {big.num_inference_steps} "
        f"steps, {SERVING_REQUESTS} requests: max_batch=2 "
        f"{rows['b2']['videos_per_min']:.2f} videos/min (wall {wall_b2:.3f} s, p50 "
        f"{rows['b2']['p50_s']:.3f} s, p95 {rows['b2']['p95_s']:.3f} s; warmup {warm_s:.2f} s), "
        f"max_batch=1 {rows['b1']['videos_per_min']:.2f} videos/min (wall {wall_b1:.3f} s, p50 "
        f"{rows['b1']['p50_s']:.3f} s, p95 {rows['b1']['p95_s']:.3f} s), mixed with "
        f"{small.height}x{small.width}x{small.num_frames} "
        f"{rows['mixed']['videos_per_min']:.2f} videos/min (batches {rows['mixed']['batches']}); "
        f"batched vs single {min(psnrs):.2f}-{max(psnrs):.2f} dB (vs another request "
        f"{crossed:.2f} dB), initial latents bit-equal; a row's draws on the host (NumPy, as "
        f"before) {draws['latents_ms']:.1f} ms latents + {draws['decode_noise_ms']:.1f} ms "
        f"decode noise, two rows' on R1 {draws['r1_2_rows_ms']:.4f} ms on the card "
        f"({draws['r1_2_rows_host_ms']:.4f} ms of host work); traced batch of 2 "
        f"{traced_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({rows['traced_b2']['idle_share']:.1%} idle; R1 {r1_ms:.4f} ms in {r1_spans} spans); "
        f"string prompt {lat_text[0]:.3f} s, its repeat from the cache behind it "
        f"{lat_text[1]:.3f} s; burst launches "
        f"{launches_b2} | {card}")
    release(pipe)
    return launches_b2


def dequant_ms_per_step(transformer) -> float:
    """CUDA-event milliseconds of the transient dequants one denoise step
    makes: every block linear but the cross-attention k/v (whose few rows
    stay on K3/K4) dequantized once into bf16, in the linear's order, by the
    route's own dequant (W4: the ``w4_dequant`` kernel; W8: ``dequantize``)."""
    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4
    from candle_video_tpu_torch.ops.kernels import int8_weight_matmul as K3
    from candle_video_tpu_torch.ops.quant_linear import Int4Linear

    lins = [getattr(getattr(blk, group), name) for blk in transformer.blocks
            for group, name in TF.QUANTIZED_LINEARS
            if not (group == "attn2" and name in ("to_k", "to_v"))]

    def run():
        for lin in lins:
            if isinstance(lin, Int4Linear):
                K4.w4_dequant(lin.w4, lin.w4_scale, lin.w4_min,
                              lin.w4.shape[0] * 2 // lin.w4_scale.shape[0], lin.compute_dtype)
            else:
                K3.dequantize(lin.w_q, lin.s, lin.w_q.shape[0] // lin.s.shape[0])

    return cuda_ms(run, iters=3, warmup=1)


DEV_PROMPT = "A lighthouse keeper climbing a spiral staircase at night, lantern in hand"
DEV_NEGATIVE = "worst quality, inconsistent motion, blurry, jittery, distorted"


def run_13b_dev(card, pipe, tier, distilled_step_ms):
    """The ``0.9.8-13b-dev`` request as published (guidance 8, STG 4.0,
    rescale 0.5, skip blocks 11, 25, 35, 39, a negative prompt: three rows
    a step) on the 13B pipeline ``pipe`` of ``tier`` (the presets share
    the DiT, VAE and scheduler): 30 steps on W4, decoded with the streamed
    tail in 6 chunks; cut to 4 steps on W8.  Exact launches: K1 48 a step
    (every layer runs, the skips mask the STG rows), the tier's kernel 2 x
    168 for the T5 (prompt and negative) plus 2 x 48 a step for the
    cross-attention k/v at M = 3 x 128, and 8 x 48 a step of the transient
    dequant route at M = 3 x 4992 (on W4 each one ``w4_dequant`` launch)."""
    from candle_video_tpu_torch.models.ltx_video.configs import get_config_by_version

    layers, steps = 48, 30 if tier == "w4" else 4
    kernel, other = ("w4_matmul", "w8_matmul") if tier == "w4" else ("w8_matmul", "w4_matmul")
    want = {"flash_attention_packed": layers * steps, kernel: 2 * 168 + 2 * layers * steps,
            f"{kernel}_dequant": 8 * layers * steps, other: 0, f"{other}_dequant": 0,
            "flash_attention_packed_long": 0,
            "w4_dequant": 8 * layers * steps if tier == "w4" else 0}
    saved = pipe.config
    pipe.config = get_config_by_version("0.9.8-13b-dev")
    try:
        row, video = run_request(
            pipe, f"13b-dev {tier} {steps} steps", DEV_PROMPT, 81, want, card,
            tag=f"13b-dev-{tier}", negative_prompt=DEV_NEGATIVE, num_inference_steps=steps,
            vae_tail_stream_chunks=6 if tier == "w4" else 0)
        if not video.float().std().item() > 0.0:
            raise AssertionError(f"13b-dev {tier}: the video is constant")
        del video
        dequant_ms = dequant_ms_per_step(pipe.transformer)
    finally:
        pipe.config = saved
    step_ms = row["denoise_step_mean_ms"]
    row.update(steps=steps, dequant_ms_per_step=dequant_ms,
               dequant_share=dequant_ms / step_ms, distilled_step_ms=distilled_step_ms)
    log(f"[13b-dev-{tier}] step at 3 rows {step_ms:.1f} ms against the distilled 13B step "
        f"{distilled_step_ms:.1f} ms (1 row) in this call ({step_ms / distilled_step_ms:.2f}x); "
        f"transient dequant {dequant_ms:.1f} ms a step ({row['dequant_share']:.1%}); peak "
        f"{row['peak_gib']:.2f} GiB | {card}")
    RESULTS[f"e2e_13b_dev_{tier}"] = row
    return row["launches"]


def run_13b_w4(card):
    """The 13B W4A16 path with the DiT, the Q4_K-form T5 and the VAE decoder
    all resident: K4 carries every T5 linear (24 x 7) and the DiT's
    cross-attention k/v (48 x 2 x 7 steps); the other 8 block linears take
    the transient route, one ``w4_dequant`` launch each (8 x 48 x 7); block
    42 is a permanent skip, computed and then masked, so every layer launches
    K1.  It decodes with
    the streamed tail in 6 chunks, as the JAX package's 13B W4 bench does."""
    pipe, gib = build_pipeline("13b-w4", card, "0.9.8-13b-distilled", dit_quant="w4",
                               t5_quant="w4")
    want = {"w4_matmul": 168 + 672, "flash_attention_packed": 336, "w8_matmul": 0,
            "w4_matmul_dequant": 8 * 48 * 7, "w4_dequant": 8 * 48 * 7}
    runs = [run_request(pipe, name, prompt, 42 + i, want, card, tag="13b-w4",
                        vae_tail_stream_chunks=6)[0]
            for i, (name, prompt) in enumerate([
                ("cold", "A red panda climbing a snow-covered pine tree"),
                ("warm", "A hot air balloon over a canyon at dawn")])]
    RESULTS["e2e_13b_w4"] = dict(resident_gib=gib, runs=runs)
    dev = run_13b_dev(card, pipe, "w4", runs[-1]["denoise_step_mean_ms"])
    release(pipe)
    return runs[-1]["launches"], dev


def run_13b_w8(card):
    """The 13B W8A16 tier at full depth (L' = 48 of 48 layers, not cut):
    K3 carries the int8 T5 (168) and the DiT's cross-attention k/v
    (14 per layer)."""
    layers = 48
    pipe, gib = build_pipeline("13b-w8", card, "0.9.8-13b-distilled", dit_quant="w8")
    want = {"w8_matmul": 168 + 14 * layers, "flash_attention_packed": 7 * layers,
            "w4_matmul": 0, "w4_dequant": 0}
    row, _ = run_request(pipe, f"L'={layers} (full depth)",
                         "A fox running through tall grass", 51, want, card, tag="13b-w8")
    RESULTS["e2e_13b_w8"] = dict(resident_gib=gib, layers=layers, run=row)
    dev = run_13b_dev(card, pipe, "w8", row["denoise_step_mean_ms"])
    release(pipe)
    return dev


# the parallel phases' request: its seed, and the injected caption states
# (a prompt of 24 tokens, the rest of the 128 padding)
PAR_SEED = 91
PAR_TOKENS = 24


def injected_embeddings(seed, negative=False):
    """Caption states [1, 128, 4096] of std 0.02 and their mask (the first
    ``PAR_TOKENS`` kept), made on the host from ``seed``: the prompt's and,
    with ``negative``, a negative prompt's from ``seed + 1``."""
    def one(sd):
        g = torch.Generator().manual_seed(sd)
        mask = torch.zeros(1, 128)
        mask[:, :PAR_TOKENS] = 1.0
        return torch.randn(1, 128, 4096, generator=g) * 0.02, mask

    emb, mask = one(seed)
    kw = dict(prompt_embeds=emb, prompt_attention_mask=mask)
    if negative:
        kw["negative_prompt_embeds"], kw["negative_prompt_attention_mask"] = one(seed + 1)
    return kw


@contextlib.contextmanager
def kept_finals():
    """The final latents of every ``denoise_loop`` inside the block (the
    pipelined loop runs it too), in a list."""
    from candle_video_tpu_torch.models.ltx_video import pipeline as P

    finals, loop = [], P.denoise_loop

    def run(*a, **kw):
        finals.append(loop(*a, **kw))
        return finals[-1]

    P.denoise_loop = run
    try:
        yield finals
    finally:
        P.denoise_loop = loop


@contextlib.contextmanager
def k1_calls():
    """A Counter of (batch, heads) over the K1 calls inside the block (its
    launches stay counted by the wrapper)."""
    from candle_video_tpu_torch.ops.kernels import flash_attention_packed as K1

    calls, fn = collections.Counter(), K1.flash_attention_packed_onepass

    def counted(q, k, v, *, num_heads, **kw):
        calls[f"B={q.shape[0]} H={num_heads}"] += 1
        return fn(q, k, v, num_heads=num_heads, **kw)

    K1.flash_attention_packed_onepass = counted
    try:
        yield calls
    finally:
        K1.flash_attention_packed_onepass = fn


def against(row, final, ref_final, video, ref_video, tag, name, card):
    """Latent rel and video PSNR of a request against its reference, held
    to ``SLICE_TOL``."""
    rel = ((final.float().cpu() - ref_final.float().cpu()).norm()
           / ref_final.float().cpu().norm()).item()
    row.update(latent_rel=rel, video_psnr=psnr(video.cpu(), ref_video))
    log(f"[{tag}] {name} against the request without the mesh: latent rel={rel:.3e} "
        f"video PSNR={row['video_psnr']:.2f} dB | {card}")
    if not (rel <= SLICE_TOL["latent_rel"] and row["video_psnr"] >= SLICE_TOL["video_psnr"]):
        raise AssertionError(f"{tag} {name} disagrees with the request without the mesh: "
                             f"{row}")


def run_pp(card, pipe):
    """Pipeline parallelism in a one-rank NCCL group (``ring_of_one``): the
    ``0.9.8-13b-dev`` request in bf16 as published (guidance 8, STG 4.0,
    rescale 0.5, skip blocks 11, 25, 35, 39, a negative prompt: three rows a
    step), cut to 4 steps, embeddings injected, the streamed tail in 6
    chunks, on the dense 13B ``pipe``.  Without the mesh: 48 K1 a step at
    B = 3.  Under ``generate(pp_mesh=make_pipeline_mesh(1),
    pp_microbatches=3)``: each row is a microbatch, 3 x 48 K1 a step at
    B = 1; held to ``SLICE_TOL`` against the request without the mesh."""
    from candle_video_tpu_torch.models.ltx_video.configs import get_config_by_version
    from candle_video_tpu_torch.parallel import make_pipeline_mesh

    layers, steps = 48, 4
    want = {"flash_attention_packed": layers * steps, "flash_attention_packed_long": 0,
            "w8_matmul": 0, "w4_matmul": 0}
    kw = dict(num_inference_steps=steps, vae_tail_stream_chunks=6,
              **injected_embeddings(PAR_SEED, negative=True))
    saved = pipe.config
    pipe.config = get_config_by_version("0.9.8-13b-dev")
    try:
        with ring_of_one(), kept_finals() as finals:
            with k1_calls() as calls:
                ref_row, ref = run_request(pipe, "13b-dev no mesh", None, PAR_SEED, want,
                                           card, tag="pp", **kw)
            ref_row["k1_calls"] = dict(calls)
            ref = ref.cpu()
            want = dict(want, flash_attention_packed=3 * layers * steps)
            with k1_calls() as calls:
                row, video = run_request(pipe, "13b-dev pp=1 M=3", None, PAR_SEED, want, card,
                                         tag="pp", pp_mesh=make_pipeline_mesh(1),
                                         pp_microbatches=3, **kw)
            row["k1_calls"] = dict(calls)
            against(row, finals[-1], finals[0], video, ref, "pp", "pp=1 M=3", card)
            del video
    finally:
        pipe.config = saved
    if set(ref_row["k1_calls"]) != {"B=3 H=32"} or set(row["k1_calls"]) != {"B=1 H=32"}:
        raise AssertionError(f"pp: K1 ran at {ref_row['k1_calls']} without the mesh and "
                             f"{row['k1_calls']} under it")
    log(f"[pp] step without the mesh {ref_row['denoise_step_mean_ms']:.1f} ms (K1 at B = 3), "
        f"pp=1 M=3 {row['denoise_step_mean_ms']:.1f} ms (K1 at B = 1, three a layer); peaks "
        f"{ref_row['peak_gib']:.2f} / {row['peak_gib']:.2f} GiB | {card}")
    RESULTS["e2e_pp"] = dict(steps=steps, no_mesh=ref_row, pp1_m3=row)
    return row["launches"]


TP = 2


def tp_reference(card, pipe):
    """The ``0.9.8-13b-distilled`` request at 512x768x97 in bf16, 7 steps,
    embeddings injected, the streamed tail in 6 chunks, without a mesh:
    48 K1 a step.  Returns its row, final latents and video on the host."""
    want = {"flash_attention_packed": 7 * 48, "flash_attention_packed_long": 0,
            "w8_matmul": 0, "w4_matmul": 0}
    with kept_finals() as finals:
        row, video = run_request(pipe, "13b no mesh", None, PAR_SEED, want, card, tag="tp",
                                 vae_tail_stream_chunks=6, **injected_embeddings(PAR_SEED))
    return row, finals[-1].cpu(), video.cpu()


def forward_inputs(dev):
    """One DiT forward's inputs at the 13B request's shape, from
    ``PAR_SEED``: latents [1, 4992, 128], the injected caption states and
    mask, the first step's timestep and the request's RoPE tables."""
    g = torch.Generator().manual_seed(PAR_SEED)
    emb = injected_embeddings(PAR_SEED)
    cos, sin = path_rope(13, 32, 128, dev)
    return (torch.randn(1, 4992, 128, generator=g).to(dev), emb["prompt_embeds"].to(dev),
            torch.tensor([1000.0], device=dev), cos, sin,
            emb["prompt_attention_mask"].to(dev))


def dit_forward(transformer, inputs):
    *args, mask = inputs
    return transformer(*args, encoder_attention_mask=mask)


def f32_partials(self, x):
    """``RowShardedLinear.forward`` with f32 partials (bf16 operands, the
    product left in f32 by ``torch.mm(out_dtype=)``), summed in f32 and
    rounded once after the bias: the alternative to the port's bf16
    reduction, measured beside it by ``run_tp``."""
    import torch.distributed as dist

    y = torch.mm(x.reshape(-1, x.shape[-1]), self.weight.t(), out_dtype=torch.float32)
    dist.all_reduce(y, group=self.group)
    if self.bias is not None:
        y = y + self.bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], -1)


def rel_err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def tp_rank_main(rank, world, tmp):
    """One rank of ``run_tp``: joins a gloo group through a FileStore in
    ``tmp``, builds the parent's seeded 13B DiT and VAE on the card (the
    ranks in turn, each cutting its DiT with ``shard_transformer`` before
    the next builds, so that two full copies never coexist), runs the
    request of ``tp_reference`` and writes its results to ``tmp``.  It loads
    the parent's kernel library and never builds one."""
    import torch.distributed as dist

    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.models.ltx_video import vae as V
    from candle_video_tpu_torch.models.ltx_video.configs import get_config_by_version
    from candle_video_tpu_torch.models.ltx_video.pipeline import LtxPipeline, generate
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.parallel import make_mesh, shard_transformer

    rank, world = int(rank), int(world)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if not _build.library_path().exists():
        raise RuntimeError(f"rank {rank}: no kernel library at {_build.library_path()}; the "
                           "parent builds it before it starts the ranks")
    _build.lib()
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(tp=world, device=dev)
        cfg = get_config_by_version("0.9.8-13b-distilled")
        build = {}
        for turn in range(world):
            if turn == rank:
                t0 = time.perf_counter()
                torch.cuda.reset_peak_memory_stats()
                g = torch.Generator(device=dev).manual_seed(0)  # build_random_pipeline's
                transformer = TF.init_random(cfg.transformer, dev, torch.bfloat16, generator=g)
                full = resident_gib(transformer)
                shard_transformer(transformer, mesh)
                vae = V.init_random(cfg.vae, dev, torch.bfloat16, generator=g)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                build = dict(build_s=time.perf_counter() - t0, dit_full_gib=full,
                             dit_shard_gib=resident_gib(transformer),
                             build_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            dist.barrier()
        # one forward against the unsharded one: the port's bf16 reduction,
        # then f32 partials in its place
        from candle_video_tpu_torch.parallel import RowShardedLinear

        ref_out = torch.load(os.path.join(tmp, "forward.pt"))
        inputs = forward_inputs(dev)
        forward = dict(bf16=rel_err(dit_forward(transformer, inputs), ref_out))
        shipped = RowShardedLinear.forward
        RowShardedLinear.forward = f32_partials
        try:
            forward["f32_partials"] = rel_err(dit_forward(transformer, inputs), ref_out)
        except (RuntimeError, TypeError) as e:  # torch.mm without out_dtype
            forward["f32_partials"] = f"not measured: {type(e).__name__}: {e}"[:300]
        finally:
            RowShardedLinear.forward = shipped
        pipe = LtxPipeline(config=cfg, transformer=transformer, vae=vae)
        times: dict = {}
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        with kept_finals() as finals, k1_calls() as calls:
            video = generate(pipe, height=512, width=768, num_frames=97, seed=PAR_SEED,
                             stage_times=times, vae_tail_stream_chunks=6,
                             **injected_embeddings(PAR_SEED))
        torch.cuda.synchronize()
        wall, steps = time.perf_counter() - t0, times["denoise_steps"]
        torch.save(dict(rank=rank, latents=finals[-1].cpu(),
                        video=video.cpu() if rank == 0 else None,
                        launches=dict(_build.LAUNCHES), k1_calls=dict(calls), wall_s=wall,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                        denoise_step_ms=[1e3 * x for x in steps],
                        denoise_step_mean_ms=1e3 * sum(steps) / len(steps),
                        vae_decode_s=times["vae_decode"], forward_rel=forward, **build),
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_tp(card, ref_row, ref_final, ref_video, ref_forward):
    """Tensor parallelism at tp=2 on the one card: two rank processes share
    it in a gloo group (its all-reduce stages CUDA tensors through the
    host), each with 16 of the 13B's 32 heads and half the FF lanes
    (``tp_rank_main``).  Each must launch exactly 48 K1 a step, all at B = 1
    and 16 heads; the two ranks' final latents must be bit-equal, and rank
    0's latents and video within ``SLICE_TOL`` of ``tp_reference``'s.  Each
    rank also runs one forward against the unsharded one (``ref_forward``)
    with the port's bf16 reduction and with f32 partials in its place."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(ref_forward, os.path.join(tmp, "forward.pt"))
        env = dict(os.environ, PYTHONPATH=REPO, PYTHONFAULTHANDLER="1")
        code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke as C; "
                "C.tp_rank_main(*sys.argv[1:])")
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(TP)]
        procs = []
        t0 = time.perf_counter()
        try:
            for r in range(TP):
                with open(logs[r], "w") as f:
                    procs.append(subprocess.Popen([sys.executable, "-c", code, str(r), str(TP),
                                                   tmp], cwd=REPO, env=env, stdout=f,
                                                  stderr=subprocess.STDOUT))
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r in range(TP):
            with open(logs[r]) as f:
                tail = f.read()[-3000:]
            if rcs[r] != 0:
                raise AssertionError(f"tp rank {r} failed (rc {rcs[r]}):\n{tail}")
        rows = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(TP)]
    want = 7 * 48
    for row in rows:
        k1 = row["launches"].get("flash_attention_packed", 0)
        if k1 != want or row["k1_calls"] != {"B=1 H=16": want} or \
                row["launches"].get("flash_attention_packed_long", 0):
            raise AssertionError(f"tp rank {row['rank']}: launches {row['launches']}, K1 calls "
                                 f"{row['k1_calls']}, want {want} K1 at B=1 H=16")
    if not all(torch.equal(row["latents"], rows[0]["latents"]) for row in rows[1:]):
        raise AssertionError("tp: the ranks' final latents differ")
    video = rows[0].pop("video")
    against(rows[0], rows[0]["latents"], ref_final, video, ref_video, "tp", "tp=2 rank 0", card)
    for row in rows:
        row.pop("latents", None)
        row.pop("video", None)
        log(f"[tp] rank {row['rank']}: {row['launches']} K1 calls {row['k1_calls']}; built in "
            f"{row['build_s']:.2f} s (DiT {row['dit_full_gib']:.2f} -> {row['dit_shard_gib']:.2f} "
            f"GiB, build peak {row['build_peak_gib']:.2f} GiB); request {row['wall_s']:.2f} s, "
            f"step mean {row['denoise_step_mean_ms']:.1f} ms (steps "
            f"{', '.join(f'{x:.1f}' for x in row['denoise_step_ms'])}), decode "
            f"{row['vae_decode_s']:.2f} s, peak {row['peak_gib']:.2f} GiB: two processes "
            f"time-sharing one card, reductions staged through the host; one forward against "
            f"the unsharded one: rel {row['forward_rel']} | {card}")
    log(f"[tp] ranks bit-equal; the phase took {wall:.1f} s (the ranks' start, build and "
        f"request); the request without the mesh: step mean "
        f"{ref_row['denoise_step_mean_ms']:.1f} ms | {card}")
    RESULTS["e2e_tp"] = dict(tp=TP, no_mesh=ref_row, ranks=rows, phase_s=wall)
    return rows[0]["launches"]


def run_parallel(card):
    """The dense 13B in bf16 (``0.9.8-13b-distilled`` weights, from seed 0
    as every phase's): ``run_pp`` on the 13B-dev request, the tp=2
    reference request, then the pipeline is released and ``run_tp`` starts
    the ranks."""
    pipe, gib = build_pipeline("13b-bf16", card, "0.9.8-13b-distilled")
    launches_pp = run_pp(card, pipe)
    ref = tp_reference(card, pipe)
    ref_forward = dit_forward(pipe.transformer, forward_inputs(torch.device("cuda"))).cpu()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["e2e_13b_bf16_resident_gib"] = gib
    return launches_pp, run_tp(card, *ref, ref_forward)


SVD_TINY = dict(
    unet=dict(in_channels=8, out_channels=4, block_out_channels=(64, 128), layers_per_block=1,
              cross_attention_dim=64, num_attention_heads=(1, 2), addition_time_embed_dim=8,
              projection_class_embeddings_input_dim=24),
    vae=dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1),
    clip=dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              projection_dim=64))


def check_svd_slice(card):
    """The tiny SVD slice on the card (bf16, kernels) against the same
    weights on the CPU (plain versions), with the same injected noise: a
    384x384 image, 4 frames, 7 steps.  At 48x48 latents the UNet's level 0
    (2304 tokens, one head of 64) takes K6 three times per forward and its
    mid block (576 tokens, two heads) K1 once.  Two requests, each against
    the CPU f32 run, the video within the slice's PSNR:
    - guidance 1 (no CFG): latent rel within the slice limit;
    - guidance 1 -> 3 (CFG, the UNet at batch 8): latent rel within
      ``CFG_DRIFT`` times the drift of the CPU's own bf16 run of the
      plain versions (launching no kernel) from the same f32 run."""
    from candle_video_tpu_torch.models.svd import clip as C
    from candle_video_tpu_torch.models.svd import configs as F
    from candle_video_tpu_torch.models.svd import pipeline as SP
    from candle_video_tpu_torch.models.svd import unet as U
    from candle_video_tpu_torch.models.svd import vae as V
    from candle_video_tpu_torch.ops.kernels import _build

    cfg = F.SvdConfig(unet=F.SvdUnetConfig(**SVD_TINY["unet"]),
                      vae=F.SvdVaeConfig(**SVD_TINY["vae"]),
                      clip=F.ClipEncoderConfig(**SVD_TINY["clip"]))
    g = torch.Generator().manual_seed(3)
    f32 = SP.SvdPipeline(cfg, U.init_random(cfg.unet, "cpu", torch.float32, g),
                         V.init_random(cfg.vae, "cpu", torch.float32, g),
                         C.init_random(cfg.clip, "cpu", torch.float32, g))
    mods = (f32.unet, f32.vae, f32.clip)
    bf16 = SP.SvdPipeline(cfg, *(copy.deepcopy(m).to(torch.bfloat16) for m in mods))
    gpu = SP.SvdPipeline(cfg, *(copy.deepcopy(m).to("cuda", torch.bfloat16) for m in mods))
    frames, steps = 4, 7
    image = torch.rand(1, 3, 384, 384, generator=g) * 2 - 1
    noise = dict(image_noise=torch.randn(image.shape, generator=g),
                 latent_noise=torch.randn(frames, 4, 48, 48, generator=g))
    to255 = lambda v: (v.clamp(-1, 1) + 1.0) * 127.5  # noqa: E731

    def run(pipe, inf):
        lat = SP.generate(pipe, image, inf, output_type="latent", **noise)
        video = V.decode(pipe.vae, lat, frames, chunk_size=inf.decode_chunk_size)
        return lat.float().cpu(), to255(video.float().cpu())

    def compare(got, want):
        rel = ((got[0] - want[0]).norm() / want[0].norm()).item()
        return dict(latent_rel=rel, video_psnr=psnr(got[1], want[1]))

    rows = {}
    for name, gmax in (("no CFG", 1.0), ("CFG 1->3", 3.0)):
        inf = SP.SvdInferenceConfig(num_frames=frames, num_inference_steps=steps,
                                    max_guidance_scale=gmax)
        _build.reset_launches()
        card_run = run(gpu, inf)
        launches = dict(_build.LAUNCHES)
        want = {"flash_attention": 3 * steps, "flash_attention_packed": steps}
        if any(launches.get(k, 0) != n for k, n in want.items()):
            raise AssertionError(f"tiny SVD slice ({name}) launches {launches}, want {want}")
        cpu_f32, cpu_bf16 = run(f32, inf), run(bf16, inf)
        pairs = {"card vs CPU f32": compare(card_run, cpu_f32),
                 "card vs CPU bf16": compare(card_run, cpu_bf16),
                 "CPU bf16 vs CPU f32": compare(cpu_bf16, cpu_f32)}
        held, drift = pairs["card vs CPU f32"], pairs["CPU bf16 vs CPU f32"]["latent_rel"]
        limit = SLICE_TOL["latent_rel"] if gmax == 1.0 else CFG_DRIFT * drift
        log(f"[slice] tiny SVD i2v 384x384x{frames} {steps} steps, {name}, card bf16 kernels: "
            + "; ".join(f"{k}: latent rel={v['latent_rel']:.3e} PSNR={v['video_psnr']:.2f} dB"
                        for k, v in pairs.items())
            + f" (held: card vs CPU f32, latent rel <= {limit:.3e}) launches={launches} | {card}")
        if not (held["latent_rel"] <= limit and held["video_psnr"] >= SLICE_TOL["video_psnr"]):
            raise AssertionError(f"the tiny SVD slice ({name}) disagrees with the CPU f32 run: "
                                 f"{held}, latent limit {limit}")
        rows[name] = dict(pairs, latent_limit=limit, launches=launches)
    RESULTS["small_slice_svd"] = rows


def run_svd(card, steps: int = 25):
    """SVD's published request on random bf16 weights from a seed: a seeded
    random 576x1024 image, 14 frames at fps 7, motion bucket 127, guidance
    1 -> 3 (CFG: the UNet runs at batch 28).  A 2-step warm-up request, then
    one of ``steps`` steps with per-stage times, the peaks before and during
    the decode, and exact launch counts: per UNet forward 5 K6 (level 0:
    2 in down block 0, 3 in up block 3) and 10 K1 (levels 1 and 2)."""
    from candle_video_tpu_torch.models.svd import clip as C
    from candle_video_tpu_torch.models.svd import pipeline as SP
    from candle_video_tpu_torch.models.svd import unet as U
    from candle_video_tpu_torch.models.svd import vae as V
    from candle_video_tpu_torch.models.svd.configs import SvdConfig
    from candle_video_tpu_torch.ops.kernels import _build

    cfg = SvdConfig()
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    pipe = SP.SvdPipeline(cfg, U.init_random(cfg.unet, "cuda", torch.bfloat16, g),
                          V.init_random(cfg.vae, "cuda", torch.bfloat16, g),
                          C.init_random(cfg.clip, "cuda", torch.bfloat16, g))
    torch.cuda.synchronize()
    gib = dict(unet=resident_gib(pipe.unet), clip=resident_gib(pipe.clip),
               vae=resident_gib(pipe.vae))
    log(f"[svd] built full-size random-init SVD in {time.perf_counter() - t0:.2f} s: resident "
        f"UNet {gib['unet']:.2f} GiB, CLIP {gib['clip']:.2f} GiB, VAE {gib['vae']:.2f} GiB | "
        f"{card}")
    image = torch.rand(1, 3, 576, 1024, generator=g, device="cuda") * 2 - 1
    per_step = {"flash_attention": 5, "flash_attention_packed": 10}
    others = ("flash_attention_packed_long", "w8_matmul", "w4_matmul", "ring_chunk_update")
    decode, peaks = V.decode, {}

    def measured_decode(*a, **kw):
        torch.cuda.synchronize()
        peaks["before_decode"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = decode(*a, **kw)
        torch.cuda.synchronize()
        peaks["decode"] = torch.cuda.max_memory_allocated()
        return out

    runs = []
    for name, n in (("warm-up", 2), ("request", steps)):
        times: dict = {}
        inf = SP.SvdInferenceConfig(num_inference_steps=n)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        V.decode = measured_decode
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            video = SP.generate(pipe, image, inf, stage_times=times)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            V.decode = decode
        launches = dict(_build.LAUNCHES)
        want = {k: c * n for k, c in per_step.items()} | dict.fromkeys(others, 0) | {
            "threefry_normal": 2}  # the image noise and the latent noise
        if tuple(video.shape) != (14, 3, 576, 1024) or not torch.isfinite(video).all():
            raise AssertionError(f"svd {name}: video {tuple(video.shape)} or non-finite values")
        if any(launches.get(k, 0) != c for k, c in want.items()):
            raise AssertionError(f"svd {name}: launch counts {launches}, want {want}")
        step_ms = [1e3 * s for s in times["unet_steps"]]
        row = dict(request=name, steps=n, wall_s=wall, clip_encode_s=times["clip_encode"],
                   vae_encode_s=times["vae_encode"], unet_step_ms=step_ms,
                   unet_step_mean_ms=statistics.mean(step_ms),
                   unet_step_median_ms=statistics.median(step_ms),
                   vae_decode_s=times["vae_decode"],
                   peak_before_decode_gib=peaks["before_decode"] / 2**30,
                   peak_decode_gib=peaks["decode"] / 2**30, launches=launches,
                   video_mean=video.float().mean().item(), video_std=video.float().std().item())
        log(f"[svd] {name} 576x1024x14 {n} steps: wall={wall:.3f} s clip={row['clip_encode_s'] * 1e3:.1f} ms "
            f"vae_encode={row['vae_encode_s'] * 1e3:.1f} ms unet step mean="
            f"{row['unet_step_mean_ms']:.1f} ms median={row['unet_step_median_ms']:.1f} ms "
            f"decode={row['vae_decode_s']:.3f} s peak {row['peak_before_decode_gib']:.2f} GiB "
            f"before the decode, {row['peak_decode_gib']:.2f} GiB in it; launches={launches} "
            f"video mean={row['video_mean']:.3f} std={row['video_std']:.3f} | {card}")
        runs.append(row)
        del video
    RESULTS["e2e_svd"] = dict(resident_gib=gib, runs=runs)
    release(pipe)
    return runs[-1]["launches"]


CKPT_SEED = 77
CKPT_PROMPT = "A paper boat drifting down a rain-filled gutter"


def quantized_payloads(model) -> dict:
    """Every buffer of the DiT's quantized block linears, on the host."""
    from candle_video_tpu_torch.models.ltx_video import transformer as TF

    out = {}
    for i, blk in enumerate(model.blocks):
        for group, name in TF.QUANTIZED_LINEARS:
            for leaf, t in getattr(getattr(blk, group), name).named_buffers():
                out[f"blocks.{i}.{group}.{name}.{leaf}"] = t.cpu()
    return out


def reference_request(pipe, kw):
    """One in-memory request: (final latents, uint8 frames), on the host."""
    from candle_video_tpu_torch.models.ltx_video.pipeline import generate
    from candle_video_tpu_torch.utils import video_io

    final = {}
    video = generate(pipe, step_callback=lambda i, n, lat: final.update(lat=lat), **kw)
    torch.cuda.synchronize()
    return final["lat"].float().cpu(), video_io.to_uint8_frames(video.cpu().numpy())


def frames_diff(a, b) -> int:
    return int(abs(a.astype("int16") - b.astype("int16")).max())


def write_official_2b(pipe, path) -> dict:
    """The pipeline's DiT, VAE decoder and VAE encoder as one
    official-layout file, written by the port's writer; returns its size."""
    from candle_video_tpu_torch.models.ltx_video import loader as L
    from candle_video_tpu_torch.models.ltx_video import weight_format as W

    tensors = {W.officialize_transformer_key(k): v
               for k, v in L.transformer_state_dict(pipe.transformer).items()}
    tensors.update({W.officialize_vae_key(k): v
                    for k, v in L.vae_decoder_state_dict(pipe.vae).items()})
    tensors.update({W.officialize_vae_key(k): v
                    for k, v in L.vae_encoder_state_dict(pipe.vae_encoder).items()})
    t0 = time.perf_counter()
    L.save_safetensors(tensors, path)
    n_bytes = os.path.getsize(path)
    return dict(tensors=len(tensors), gib=n_bytes / 2**30, write_s=time.perf_counter() - t0,
                dtypes=sorted({str(t.dtype) for t in tensors.values()}))


def cli_checkpoint_run(card, tier, path, emb_path, out_dir, ref, image_path=None):
    """``cli.main`` on the official file at 512x768x97 with the embeddings
    file (and ``--image image_path``, which needs the file's encoder): the
    load timed (seconds, the file's GiB/s, the device peak of the
    DiT load and of the whole load), the launches of the request counted,
    the final latents and the frames against the in-memory ``ref``, the
    quantized payloads against the in-memory quantizer's."""
    import numpy as np

    from candle_video_tpu_torch import cli
    from candle_video_tpu_torch.models.ltx_video import loader as L
    from candle_video_tpu_torch.ops.kernels import _build

    flag = {"bf16": [], "i2v": [], "w8": ["--dit-int8"], "w4": ["--dit-int4"]}[tier]
    quant = {"bf16": None, "i2v": None, "w8": "w8", "w4": "w4"}[tier]
    if image_path is not None:
        flag = [*flag, "--image", image_path]
    seen = {}
    load_pipeline, dit_load = cli.load_pipeline, cli._DIT_LOADERS[quant]

    def peak_since(base):
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    def timed_dit(*a, **k):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = dit_load(*a, **k)
        seen.update(dit_peak_gib=peak_since(base), dit_load_s=time.perf_counter() - t0)
        return model

    def timed_load(args, device, dtype):
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pipe = load_pipeline(args, device, dtype)
        torch.cuda.synchronize()
        seen.update(pipe=pipe, load_s=time.perf_counter() - t0, base_gib=base / 2**30,
                    resident_gib=(torch.cuda.memory_allocated() - base) / 2**30)
        return pipe

    lat_path = os.path.join(out_dir, f"final_{tier}.safetensors")
    argv = ["--weights-path", path, "--embeddings-file", emb_path, "--vae-stream-chunks", "2",
            "--seed", str(CKPT_SEED), "--height", "512", "--width", "768", "--num-frames",
            "97", "--output-dir", os.path.join(out_dir, tier), "--save-final-latents",
            lat_path, *flag]
    cli.load_pipeline, cli._DIT_LOADERS[quant] = timed_load, timed_dit
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        cli.load_pipeline, cli._DIT_LOADERS[quant] = load_pipeline, dit_load
    if rc != 0:
        raise AssertionError(f"checkpoint cli {tier} returned {rc}")
    pipe = seen.pop("pipe")
    lat = L.load_safetensors(lat_path)["latents"].clone()
    frames = np.load(os.path.join(out_dir, tier, "video_uint8.npy"))
    ref_lat, ref_frames, spread, frame_spread, payloads = ref
    lat_diff = (lat - ref_lat).abs().max().item()
    frame_diff = frames_diff(frames, ref_frames)
    same_payloads = None
    if payloads is not None:
        got = quantized_payloads(pipe.transformer)
        same_payloads = sorted(got) == sorted(payloads) and all(
            torch.equal(got[k], payloads[k]) for k in payloads)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    gib = os.path.getsize(path) / 2**30
    row = dict(tier=tier, argv=argv, wall_s=wall, launches=launches, latent_max_abs=lat_diff,
               reference_spread=spread, frames_max_diff=frame_diff,
               reference_frame_spread=frame_spread, payloads_bit_equal=same_payloads,
               file_gib_per_s=gib / seen["load_s"], **seen)
    log(f"[checkpoint] cli {tier}: load {seen['load_s']:.2f} s ({row['file_gib_per_s']:.2f} "
        f"GiB/s of the {gib:.2f} GiB file, in the page cache), DiT load "
        f"{seen['dit_load_s']:.2f} s at a device peak of {seen['dit_peak_gib']:.3f} GiB, "
        f"resident {seen['resident_gib']:.2f} GiB; request wall {wall:.2f} s with the load; "
        f"latents max |diff| {lat_diff:.3e} against the in-memory request (spread of two "
        f"in-memory runs {spread:.3e}), frames max diff {frame_diff} (spread {frame_spread}), "
        f"payloads bit-equal: {same_payloads}; launches {launches} | {card}")
    if lat.shape != ref_lat.shape or not torch.isfinite(lat).all():
        raise AssertionError(f"checkpoint cli {tier}: latents {tuple(lat.shape)}")
    if lat_diff > spread or frame_diff > frame_spread:
        raise AssertionError(f"checkpoint cli {tier}: latents differ by {lat_diff}, frames by "
                             f"{frame_diff}, beyond the in-memory spread {spread} / "
                             f"{frame_spread}")
    if payloads is not None and not same_payloads:
        raise AssertionError(f"checkpoint cli {tier}: the streamed payloads are not the "
                             "in-memory quantizer's")
    return row


def check_t5_dir(card, root, layers: int = 2):
    """A full-width HuggingFace T5-XXL directory of ``layers`` of the 24
    blocks (d_model 4096, d_ff 10240, vocab 32128; the depth cut is the only
    one), written by the port's writer, through ``t5_from_hf_state_dict``
    against the encoder built in memory from the same tensors."""
    from candle_video_tpu_torch.models.ltx_video import loader as L
    from candle_video_tpu_torch.models.ltx_video import t5 as T5
    from candle_video_tpu_torch.models.ltx_video.configs import T5Config

    cfg = T5Config(num_layers=layers)
    g = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, scale=0.02, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    d, ff = cfg.d_model, cfg.d_ff
    shapes = {"q": (d, d), "k": (d, d), "v": (d, d), "o": (d, d), "wi_0": (ff, d),
              "wi_1": (ff, d), "wo": (d, ff)}
    sd = {"shared.weight": rnd(cfg.vocab_size, d, scale=1.0),
          "encoder.final_layer_norm.weight": 1 + rnd(d, scale=0.1),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              rnd(cfg.relative_attention_num_buckets, cfg.num_heads, scale=1.0,
                  dtype=torch.float32)}
    blocks = []
    for i in range(layers):
        lins = {}
        for name, shape in shapes.items():
            sd[f"encoder.block.{i}.{T5.HF_LINEARS[name]}.weight"] = w = rnd(*shape)
            lins[name] = T5.dense_linear(w.t())
        sd[f"encoder.block.{i}.layer.0.layer_norm.weight"] = n0 = 1 + rnd(d, scale=0.1)
        sd[f"encoder.block.{i}.layer.1.layer_norm.weight"] = n1 = 1 + rnd(d, scale=0.1)
        blocks.append(T5.T5Block(cfg, lins, n0, n1))
    ref = T5.T5Encoder(cfg, sd["shared.weight"], blocks, sd[
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
        sd["encoder.final_layer_norm.weight"]).eval()
    directory = os.path.join(root, "text_encoder")
    os.makedirs(directory, exist_ok=True)
    L.save_safetensors(sd, os.path.join(directory, "model.safetensors"))
    gib = os.path.getsize(os.path.join(directory, "model.safetensors")) / 2**30
    del sd
    t0 = time.perf_counter()
    enc = T5.t5_from_hf_state_dict(L.load_sharded(directory), cfg, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ids = torch.randint(0, cfg.vocab_size, (1, 128), generator=g, device="cuda")
    mask = torch.ones(1, 128, device="cuda")
    mask[:, 40:] = 0
    got, want = enc(ids, mask), ref(ids, mask)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    log(f"[checkpoint] T5 HF directory, full width, {layers} of 24 blocks (depth cut), "
        f"{gib:.2f} GiB: loaded in {load_s:.2f} s; 128-token encode max |diff| {diff:.3e} "
        f"against the in-memory encoder of the same tensors | {card}")
    if got.shape != (1, 128, d) or not torch.equal(got, want):
        raise AssertionError(f"T5 from the HF directory differs from the in-memory encoder: "
                             f"max |diff| {diff}")
    shutil.rmtree(directory)
    RESULTS["checkpoint_t5_dir"] = dict(layers=layers, gib=gib, load_s=load_s, max_abs=diff)


def run_checkpoint(card):
    """A full-size official-layout 2B file (the DiT, VAE decoder, VAE encoder
    and latent statistics of ``build_random_pipeline("0.9.8-2b-distilled",
    seed=0)`` in bf16) written by the port's writer, then run through
    ``cli.main`` four ways, bf16, bf16 with ``--image`` (a PNG written here:
    the encoder comes from the file), ``--dit-int8`` and ``--dit-int4``, each
    at 512x768x97 with the prompt embeddings of the in-memory int8 T5 from
    an embeddings file and the streamed tail in 2 chunks.  Each run's
    latents and frames are held to the in-memory pipeline's request on the
    same weights (quantized by ``quantize_transformer_w8`` / ``_w4`` for the
    tiers): equal, or within the spread of two in-memory runs; its payloads
    to the in-memory quantizer's, bit for bit; its launches to K1 196 and,
    on the tiers, K3 or K4 392 (the DiT's cross-attention k/v at M = 128; no
    T5 runs); the DiT load's device peak to below the bf16 block tree.
    Then a full-width T5 HF directory.  The files are deleted at the end."""
    import numpy as np
    from PIL import Image

    from candle_video_tpu_torch.models.ltx_video import loader as L
    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.utils.video_io import load_image

    root = os.path.join(OUT_DIR, "checkpoint")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "ltxv-2b-0.9.8-distilled-random.safetensors")
    emb_path = os.path.join(root, "embeddings.safetensors")
    image_path = os.path.join(root, "anchor.png")
    Image.fromarray(np.random.default_rng(8).integers(0, 256, (512, 768, 3), np.uint8)).save(
        image_path)
    pipe, gib = build_pipeline("checkpoint", card, "0.9.8-2b-distilled")
    emb, mask = pipe.encode_prompt([CKPT_PROMPT], 128)
    L.save_safetensors({"prompt_embeds": emb, "prompt_attention_mask": mask}, emb_path)
    pipe.t5 = None
    gc.collect()
    torch.cuda.empty_cache()
    kw = dict(prompt_embeds=emb, prompt_attention_mask=mask, height=512, width=768,
              num_frames=97, seed=CKPT_SEED, vae_tail_stream_chunks=2)
    block_tree_gib = sum(
        t.numel() * t.element_size() for parent, name in TF.quantized_slots(pipe.transformer)
        for t in getattr(parent, name).parameters()) / 2**30
    refs = {}
    dense = pipe.transformer
    for tier, quantize in (("bf16", None), ("w8", TF.quantize_transformer_w8),
                           ("w4", TF.quantize_transformer_w4)):
        if quantize is not None:
            pipe.transformer = quantize(copy.deepcopy(dense))
        (lat_a, fr_a), (lat_b, fr_b) = (reference_request(pipe, kw) for _ in range(2))
        payloads = None if quantize is None else quantized_payloads(pipe.transformer)
        refs[tier] = (lat_a, fr_a, (lat_a - lat_b).abs().max().item(), frames_diff(fr_a, fr_b),
                      payloads)
        log(f"[checkpoint] in-memory {tier} request x2: latents spread "
            f"{refs[tier][2]:.3e}, frames spread {refs[tier][3]} | {card}")
        pipe.transformer = dense
    i2v_kw = dict(kw, image=load_image(image_path, 512, 768))
    (lat_a, fr_a), (lat_b, fr_b) = (reference_request(pipe, i2v_kw) for _ in range(2))
    refs["i2v"] = (lat_a, fr_a, (lat_a - lat_b).abs().max().item(), frames_diff(fr_a, fr_b),
                   None)
    log(f"[checkpoint] in-memory i2v request x2: latents spread {refs['i2v'][2]:.3e}, frames "
        f"spread {refs['i2v'][3]} | {card}")
    n_encoder = len(pipe.vae_encoder.state_dict())
    info = write_official_2b(pipe, path)
    log(f"[checkpoint] wrote the official-layout 2B file: {info['tensors']} tensors "
        f"({n_encoder} of the encoder), {info['gib']:.2f} GiB, {info['dtypes']}, in "
        f"{info['write_s']:.2f} s; the bf16 block tree is {block_tree_gib:.2f} GiB | {card}")
    del dense, emb, mask, pipe  # one pipeline resident at a time
    gc.collect()
    torch.cuda.empty_cache()
    rows = {}
    want = {"bf16": {"flash_attention_packed": 196, "w8_matmul": 0, "w4_matmul": 0},
            "i2v": {"flash_attention_packed": 196, "w8_matmul": 0, "w4_matmul": 0},
            "w8": {"flash_attention_packed": 196, "w8_matmul": 392, "w4_matmul": 0},
            "w4": {"flash_attention_packed": 196, "w4_matmul": 392, "w8_matmul": 0}}
    for tier in ("bf16", "i2v", "w8", "w4"):
        row = cli_checkpoint_run(card, tier, path, emb_path, root, refs[tier],
                                 image_path if tier == "i2v" else None)
        if any(row["launches"].get(k, 0) != n for k, n in want[tier].items()):
            raise AssertionError(f"checkpoint cli {tier}: launches {row['launches']}, "
                                 f"want {want[tier]}")
        if tier in ("w8", "w4") and not row["dit_peak_gib"] < block_tree_gib:
            raise AssertionError(f"checkpoint cli {tier}: the streaming DiT load peaked at "
                                 f"{row['dit_peak_gib']:.3f} GiB, not below the "
                                 f"{block_tree_gib:.3f} GiB bf16 block tree")
        rows[tier] = {k: v for k, v in row.items() if k != "argv"}
    os.remove(path)
    check_t5_dir(card, root)
    shutil.rmtree(root)
    RESULTS["checkpoint"] = dict(file=info, block_tree_gib=block_tree_gib, runs=rows)
    return rows


def run_cli(card):
    from candle_video_tpu_torch import cli
    from candle_video_tpu_torch.models.ltx_video import loader as L

    for name, extra in (("cli_smoke", []),
                        ("cli_smoke_13b_int4", ["--version", "0.9.8-13b-distilled",
                                                "--dit-int4"])):
        out = os.path.join(OUT_DIR, name)
        t0 = time.perf_counter()
        rc = cli.main([*extra, "--height", "256", "--width", "384", "--num-frames", "25",
                       "--output-type", "latent", "--output-dir", out])
        if rc != 0:
            raise AssertionError(f"cli {extra} returned {rc}")
        lat = L.load_safetensors(os.path.join(out, "latents.safetensors"))["latents"]
        if tuple(lat.shape) != (1, 4 * 8 * 12, 128) or not torch.isfinite(lat).all():
            raise AssertionError(f"cli {extra} latents {tuple(lat.shape)}")
        log(f"[cli] {' '.join(extra) or '2B'} 256x384x25 latent run in "
            f"{time.perf_counter() - t0:.2f} s | {card}")
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the GGUF T5-XXL: a full-size Q8_0 file through the inspection tool and the
# CLI, and the Q5_K_M mix of 2 blocks
# ---------------------------------------------------------------------------

T5_ROLES = ("token_embd", "attn_q", "attn_k", "attn_v", "attn_o", "ffn_gate", "ffn_up",
            "ffn_down")


def t5_role_std(cfg) -> dict:
    """The std of each layer role's dequantized weights in the random
    files: T5's own initializer (HF ``T5PreTrainedModel._init_weights``,
    factor 1), so that every width runs the same dynamics."""
    d, dkv, inner, ff = cfg.d_model, cfg.d_kv, cfg.num_heads * cfg.d_kv, cfg.d_ff
    return {"token_embd": 1.0, "attn_q": (d * dkv) ** -0.5, "attn_k": d ** -0.5,
            "attn_v": d ** -0.5, "attn_o": inner ** -0.5, "ffn_gate": d ** -0.5,
            "ffn_up": d ** -0.5, "ffn_down": ff ** -0.5}


# a llama.cpp Q5_K_M file's types in the first blocks of 24 (its
# use_more_bits rule puts attn_v and ffn_down of blocks 0-2 in Q6_K)
Q8_0 = dict.fromkeys(T5_ROLES, "Q8_0")
Q5_K_M = dict.fromkeys(T5_ROLES, "Q5_K") | {"attn_v": "Q6_K", "ffn_down": "Q6_K"}
# Keep-quantized encode against the dense encode of the same file, rel in
# norm over [1, 128, d_model].  Both round the same weights once to bf16
# (Q8_0: bf16(q·d) either way) and sum in f32 in another order; Q5_K's K3
# route rounds q·s alone and adds the min as an f32 rank-G correction.  A
# 1-ulp difference in 0.02% of a linear's outputs grows through the blocks
# to the bf16 floor: on the CPU the plain versions read 2.35e-2 to 2.51e-2
# (Q8_0, 24 blocks, at 1/8, 1/4 and 1/2 of the width; the dense bf16 encoder
# reads 2.53e-2 from its own f32 run) and 1.10e-2 to 1.16e-2 (Q5_K_M, 2
# blocks, at 1/4, 1/2 and the full width), tests/test_torch_gguf_t5.py.
# The card's limits are 3x the largest reading, stated before its first run.
GGUF_T5_TOL = dict(q8_0=7.5e-2, q5_k_m=3.5e-2)
GGUF_PROMPT = "An origami crane unfolding on a wooden desk in morning light"
GGUF_SEED = 123


def gguf_payload(kind: str, n: int, std: float, g, device):
    """``n`` values of GGUF type ``kind`` ("Q8_0", "Q5_K" or "Q6_K") as raw
    blocks (uint8, on the host), each field drawn from ``g`` on ``device``
    with no quantizer run: Q8_0 codes N(0, 32²) rounded and clipped to
    ±127 and an f16 scale ``std / 32`` each 32 values; the K-quants' bytes
    uniform and their f16 ``d`` (and Q5_K's ``dmin = 15.5·d``, which
    centres the weights) set so that the weights' std is ``std`` (±25% a
    block)."""
    def f16_bytes(x):
        return x.to(torch.float16).view(torch.uint8).reshape(-1, 2)

    def jitter(nb):
        return torch.rand(nb, generator=g, device=device) * 0.5 + 0.75

    if kind == "Q8_0":
        nb = n // 32
        codes = torch.randn(nb, 32, generator=g, device=device).mul_(32).round_()
        codes = codes.clamp_(-127, 127).to(torch.int8).view(torch.uint8)
        blocks = torch.cat([f16_bytes(jitter(nb) * (std / 32)), codes], dim=1)
    else:
        nb = n // 256
        size = {"Q5_K": 176, "Q6_K": 210}[kind]
        blocks = torch.randint(0, 256, (nb, size), generator=g, device=device,
                               dtype=torch.uint8)
        if kind == "Q5_K":  # w = d·sc·q - dmin·m: sc, m in 0..63, q in 0..31
            d = jitter(nb) * (std / 527)
            blocks[:, 0:2], blocks[:, 2:4] = f16_bytes(d), f16_bytes(15.5 * d)
        else:  # w = d·sc·(q - 32): sc int8, q in 0..63
            blocks[:, 208:210] = f16_bytes(jitter(nb) * (std / 1365))
    return blocks.cpu().numpy().reshape(-1)


def write_t5_gguf(path, cfg, types: dict, seed: int, device) -> dict:
    """A T5 encoder of ``cfg`` as a GGUF file with the names
    ``t5_from_gguf`` reads (``enc.blk.N.*``): the embedding and every block
    linear in ``types[role]`` at ``t5_role_std``, the norms F32 near 1 and
    the relative bias F32 N(0, 1), drawn from ``seed`` on ``device`` and
    written by the port's ``write_gguf``.  Returns the tensor count, the
    count of each type, the size and the seconds to draw and to write."""
    import numpy as np

    from candle_video_tpu_torch.quant import dequant_np as DQ
    from candle_video_tpu_torch.quant.gguf import write_gguf

    type_ids = {name: tid for tid, name in DQ.TYPE_NAMES.items()}
    g = torch.Generator(device=device).manual_seed(seed)
    d, ff = cfg.d_model, cfg.d_ff
    shapes = {"attn_q": (d, d), "attn_k": (d, d), "attn_v": (d, d), "attn_o": (d, d),
              "ffn_gate": (ff, d), "ffn_up": (ff, d), "ffn_down": (d, ff)}

    std = t5_role_std(cfg)

    def payload(role, shape):
        return type_ids[types[role]], shape, gguf_payload(types[role], math.prod(shape),
                                                          std[role], g, device)

    def f32(shape, mean, std):
        x = torch.randn(shape, generator=g, device=device) * std + mean
        return DQ.GGML_F32, shape, x.cpu().numpy().view(np.uint8).reshape(-1)

    t0 = time.perf_counter()
    tensors = {"token_embd.weight": payload("token_embd", (cfg.vocab_size, d)),
               "enc.output_norm.weight": f32((d,), 1.0, 0.1)}
    for i in range(cfg.num_layers):
        for role, shape in shapes.items():
            tensors[f"enc.blk.{i}.{role}.weight"] = payload(role, shape)
        tensors[f"enc.blk.{i}.attn_norm.weight"] = f32((d,), 1.0, 0.1)
        tensors[f"enc.blk.{i}.ffn_norm.weight"] = f32((d,), 1.0, 0.1)
    tensors["enc.blk.0.attn_rel_b.weight"] = f32(
        (cfg.relative_attention_num_buckets, cfg.num_heads), 0.0, 1.0)
    t1 = time.perf_counter()
    write_gguf(path, tensors, {"general.architecture": "t5", "t5.block_count": cfg.num_layers})
    return dict(tensors=len(tensors), types=dict(collections.Counter(
        DQ.TYPE_NAMES[t[0]] for t in tensors.values())), gib=os.path.getsize(path) / 2**30,
        draw_s=t1 - t0, write_s=time.perf_counter() - t1)


def t5_tokens(cfg, device, seed: int = 6, n: int = 128, kept: int = 40):
    """``n`` random token ids from ``seed``, the last ``n - kept`` padded."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (1, n), generator=g, device=device)
    mask = torch.ones(1, n, device=device)
    mask[:, kept:] = 0
    return ids, mask


def gguf_t5_drift(path, cfg, device, dtype=torch.bfloat16) -> dict:
    """The keep-quantized encoder of a GGUF T5 against the dense encoder of
    the same file on ``t5_tokens``: ``errors`` of the two encodes, with
    both encoders and the tokens."""
    from candle_video_tpu_torch.models.ltx_video import t5 as T5

    dense = T5.t5_from_gguf(path, cfg, device, dtype)
    kept = T5.t5_from_gguf(path, cfg, device, dtype, keep_quantized=True)
    ids, mask = t5_tokens(cfg, device)
    with torch.no_grad():
        want, got = dense(ids, mask), kept(ids, mask)
    return dict(errors(got, want), dense=dense, kept=kept, ids=ids, mask=mask)


@contextlib.contextmanager
def timed_calls(module, name, seen: dict, key: str):
    """``module.name`` timed to a synchronize for the block: each call's
    seconds appended to ``seen[key]``, and the resident GiB of what it
    returned (a module) to ``seen[key + "_gib"]``."""
    fn = getattr(module, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        seen.setdefault(key, []).append(time.perf_counter() - t0)
        if isinstance(out, torch.nn.Module):
            seen.setdefault(key + "_gib", []).append(resident_gib(out))
        return out

    setattr(module, name, timed)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def gguf_cli_run(card, name, argv, want, out_dir):
    """``cli.main(argv)`` with its T5 load timed and its ``generate`` call
    given ``stage_times``: the launches of the whole call against ``want``,
    the output checked finite (and a video in [0, 255]); returns its row and
    the final latents of a latent run."""
    from candle_video_tpu_torch import cli
    from candle_video_tpu_torch.models.ltx_video import loader as L
    from candle_video_tpu_torch.ops.kernels import _build

    seen: dict = {}
    generate = cli.generate

    def staged(pipe, **kw):
        times: dict = {}
        out = generate(pipe, stage_times=times, **kw)
        seen.update(times=times, out_min=out.min().item(), out_max=out.max().item(),
                    finite=bool(torch.isfinite(out).all()))
        return out

    out = os.path.join(out_dir, name)
    argv = [*argv, "--seed", str(GGUF_SEED), "--output-dir", out]
    cli.generate = staged
    try:
        with timed_calls(cli, "load_t5", seen, "t5_load_s"):
            _build.reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
    finally:
        cli.generate = generate
    gc.collect()
    torch.cuda.empty_cache()
    times = seen.pop("times")
    steps = [1e3 * s for s in times["denoise_steps"]]
    row = dict(name=name, argv=argv, wall_s=wall, launches=launches,
               t5_load_s=seen["t5_load_s"][0], t5_gib=seen["t5_load_s_gib"][0]
               if "t5_load_s_gib" in seen else None, t5_encode_s=times["t5_encode"],
               step_ms=steps, step_mean_ms=statistics.mean(steps),
               step_median_ms=statistics.median(steps), generate_s=times["total"],
               vae_decode_s=times.get("vae_decode"), decode_mode=times.get("decode_mode"),
               out_min=seen["out_min"], out_max=seen["out_max"])
    log(f"[gguf] cli {name}: rc={rc} wall {wall:.2f} s (T5 load {row['t5_load_s']:.2f} s"
        + (f", {row['t5_gib']:.2f} GiB resident" if row["t5_gib"] is not None else ", no T5")
        + f"), generate {row['generate_s']:.3f} s: t5 encode "
        f"{1e3 * row['t5_encode_s']:.1f} ms, {len(steps)} steps mean "
        f"{row['step_mean_ms']:.1f} ms median {row['step_median_ms']:.1f} ms (first "
        f"{steps[0]:.1f})" + (f", vae_decode {row['vae_decode_s']:.3f} s" if
                              row["vae_decode_s"] is not None else "")
        + f"; output in [{row['out_min']:.3f}, {row['out_max']:.3f}]; launches {launches} "
        f"| {card}")
    if rc != 0 or not seen["finite"]:
        raise AssertionError(f"gguf cli {name}: rc {rc}, finite {seen['finite']}")
    if any(launches.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"gguf cli {name}: launch counts {launches}, want {want}")
    latents = None
    if "latent" in argv:
        latents = L.load_safetensors(os.path.join(out, "latents.safetensors"))["latents"].clone()
    elif not (0.0 <= row["out_min"] and row["out_max"] <= 255.0):
        raise AssertionError(f"gguf cli {name}: video outside [0, 255]")
    return row, latents


def check_gguf_q5_k_m(card, root):
    """A full-width GGUF T5 of 2 of the 24 blocks in the Q5_K_M mix (the
    depth cut is the only one), loaded keep-quantized and dense: the
    128-token encodes within ``GGUF_T5_TOL["q5_k_m"]`` (14 K3 launches: Q5_K
    at qblock 32 with its rank-G correction, Q6_K at qblock 16); then K3 on
    the file's own payloads against its plain version at the ffn_down shape
    (Q6_K, qblock 16: M = 128, K = 10240, N = 4096) and the ffn_gate shape
    (Q5_K, qblock 32), timed beside its bound, the plain version and a bf16
    ``matmul`` on the dequantized weight."""
    from candle_video_tpu_torch.models.ltx_video import t5 as T5
    from candle_video_tpu_torch.models.ltx_video.configs import T5Config
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.ops.kernels import int8_weight_matmul as K3

    cfg = T5Config(num_layers=2)
    path = os.path.join(root, "t5-xxl-2-blocks-Q5_K_M-random.gguf")
    info = write_t5_gguf(path, cfg, Q5_K_M, seed=32, device="cuda")
    seen: dict = {}
    with timed_calls(T5, "t5_from_gguf", seen, "load_s"):
        drift = gguf_t5_drift(path, cfg, "cuda")
    kept = drift.pop("kept")
    _build.reset_launches()
    kept(drift.pop("ids"), drift.pop("mask"))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    del drift["dense"]
    err = drift
    log(f"[gguf] Q5_K_M, full width, 2 of 24 blocks (depth cut): {info['types']}, "
        f"{info['gib']:.3f} GiB written in {info['write_s']:.2f} s; loaded dense in "
        f"{seen['load_s'][0]:.2f} s ({seen['load_s_gib'][0]:.3f} GiB), keep-quantized in "
        f"{seen['load_s'][1]:.2f} s ({seen['load_s_gib'][1]:.3f} GiB); 128-token encode on K3 "
        f"against dense: rel={err['rel']:.3e} max_abs={err['max_abs']:.3e} (limit rel "
        f"{GGUF_T5_TOL['q5_k_m']}); launches {launches} | {card}")
    if not err["rel"] <= GGUF_T5_TOL["q5_k_m"]:
        raise AssertionError(f"Q5_K_M keep-quantized encode drifts from dense: {err}")
    if launches.get("w8_matmul", 0) != 14 or launches.get("w8_matmul_dequant", 0):
        raise AssertionError(f"Q5_K_M encode launches {launches}, want 14 w8_matmul")
    g = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for label, lin in (("T5 ffn_down Q6_K qb16", kept.blocks[0].wo),
                       ("T5 ffn_gate Q5_K qb32", kept.blocks[0].wi_0)):
        kk, n = lin.w_q.shape
        qb = kk // lin.s.shape[0]
        x = torch.randn(128, kk, generator=g, device="cuda").bfloat16()
        call = lambda: K3.w8_matmul(x, lin.w_q, lin.s, qblock=qb)  # noqa: E731
        plain = lambda: K3.w8_matmul_plain(x, lin.w_q, lin.s, qblock=qb)  # noqa: E731
        e = errors(call(), plain())
        wd = K3.dequantize(lin.w_q, lin.s, qb)
        row = dict(label=label, m=128, k=kk, n=n, qblock=qb, ms=cuda_ms(call, iters=20),
                   plain_ms=cuda_ms(plain, iters=5),
                   kernel_ms=device_ms_of(kernel_device_ms(call, repeats=3),
                                          "weight_only_matmul_kernel"),
                   bf16_matmul_ms=cuda_ms(lambda: torch.matmul(x, wd), iters=20), **e,
                   **bound(2.0 * 128 * kk * n,
                           2 * 128 * kk + kk * n + 4 * (kk // qb) * n + 2 * 128 * n))
        log(f"[gguf] K3 {label} M=128 K={kk} N={n} qb={qb} on the file's payload: "
            f"rel={e['rel']:.3e} max_abs={e['max_abs']:.3e} (limit {K3_TOL['rel']}) | "
            f"{row['ms']:.4f} ms through the wrapper, {row['kernel_ms']} ms on the device "
            f"({row['bound_ms']:.4f} ms bound, {row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, bf16 matmul on the dequantized weight "
            f"{row['bf16_matmul_ms']:.4f} ms | {card}")
        if not e["rel"] <= K3_TOL["rel"]:
            raise AssertionError(f"K3 {label} disagrees with its plain version: {e}")
        rows.append(row)
    del kept
    os.remove(path)
    return dict(file=info, load_s=seen["load_s"], resident_gib=seen["load_s_gib"],
                encode=err, launches=launches, k3=rows)


def host_route_block_s(path, block: int = 0) -> float:
    """Seconds of the dense route ``t5_from_gguf`` took before it split
    Q8_0 on the card, for block ``block``'s seven linears: the NumPy
    dequant, a transposed copy on the host, the upload in bf16."""
    import numpy as np

    from candle_video_tpu_torch.quant.gguf import GGUFFile

    f = GGUFFile(path)
    try:
        t0 = time.perf_counter()
        for role in T5_ROLES[1:]:
            w = f.tensor(f"enc.blk.{block}.{role}.weight")
            torch.from_numpy(np.array(w.T, order="C")).to("cuda", torch.bfloat16)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        f.close()


def run_gguf_t5(card):
    """A full-size T5-XXL GGUF, all 24 blocks in Q8_0 (4.6 G codes written
    field by field, ``write_t5_gguf``), through the port's inspection tool
    and CLI: ``list``; ``dump-embeds`` (the hash tokenizer) to an
    embeddings file; the dense and keep-quantized loads and encodes (the
    file's embeddings are the dense encode bit for bit; the K3 encode within
    ``GGUF_T5_TOL["q8_0"]`` of it; 168 K3 a keep-quantized encode); ``cli
    --t5-gguf`` against ``cli --embeddings-file`` on the default preset at
    512x768x97, latents bit-equal; the ``0.9.5-2b`` preset as published
    (40 steps, CFG 3 + STG 1 + rescale 0.7, skip block 19, a negative
    prompt: three DiT rows a step) with the T5 kept quantized at 512x768x97.
    Then the Q5_K_M mix (``check_gguf_q5_k_m``).  The files are deleted at
    the end.  Returns the 0.9.5-2b request's launches."""
    from candle_video_tpu_torch.models.ltx_video import loader as L
    from candle_video_tpu_torch.models.ltx_video import t5 as T5
    from candle_video_tpu_torch.models.ltx_video.configs import t5_xxl
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.utils import inspect_weights as IW

    t_phase = time.perf_counter()
    root = os.path.join(OUT_DIR, "gguf_t5")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "t5-v1_1-xxl-encoder-Q8_0-random.gguf")
    emb_path = os.path.join(root, "embeddings.safetensors")
    cfg = t5_xxl()
    info = write_t5_gguf(path, cfg, Q8_0, seed=31, device="cuda")
    log(f"[gguf] wrote the full-size T5-XXL GGUF (24 blocks, Q8_0): {info['tensors']} tensors "
        f"{info['types']}, {info['gib']:.3f} GiB, drawn in {info['draw_s']:.2f} s and written "
        f"in {info['write_s']:.2f} s | {card}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        IW.main(["list", path])
    lines = buf.getvalue().splitlines()
    listed = collections.Counter(ln.rsplit(None, 1)[-1] for ln in lines[1:]
                                 if not ln.startswith("  meta "))
    log(f"[gguf] inspect_weights list: {lines[0]!r}; tensors by type {dict(listed)}")
    if not lines[0].startswith(f"# GGUF: {info['tensors']} tensors") or \
            dict(listed) != info["types"]:
        raise AssertionError(f"inspect_weights list disagrees with the file: {lines[:3]}")

    seen: dict = {}
    with timed_calls(T5, "t5_from_gguf", seen, "load_s"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            IW.main(["dump-embeds", "--t5-gguf", path, "--prompt", GGUF_PROMPT,
                     "--max-length", "128", "--out", emb_path])
        dump_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        err = gguf_t5_drift(path, cfg, "cuda")
    dense, kept = err.pop("dense"), err.pop("kept")
    del err["ids"], err["mask"]
    emb = L.load_safetensors(emb_path)
    tok = IW.make_tokenizer(None, 128, cfg.vocab_size)
    ids, mask = (torch.from_numpy(a.astype("int64")).cuda() for a in tok.encode_batch(
        [GGUF_PROMPT], 128))
    mask = mask.float()
    want = dense(ids, mask)
    _build.reset_launches()
    got = kept(ids, mask)
    torch.cuda.synchronize()
    kept_launches = dict(_build.LAUNCHES)
    same_file = torch.equal(emb["prompt_embeds"].cuda(), want.float())
    dense_ms = cuda_ms(lambda: dense(ids, mask), iters=5)
    kept_ms = cuda_ms(lambda: kept(ids, mask), iters=5)
    log(f"[gguf] dump-embeds: {dump_s:.2f} s with its dense load ({seen['load_s'][0]:.2f} s), "
        f"{buf.getvalue().splitlines()[-1]!r},"
        f" equal to the dense encode: {same_file}; loads: dense {seen['load_s'][1]:.2f} s "
        f"({seen['load_s_gib'][1]:.2f} GiB resident), keep-quantized {seen['load_s'][2]:.2f} s "
        f"({seen['load_s_gib'][2]:.2f} GiB); encode of 128 tokens: dense {dense_ms:.2f} ms, "
        f"keep-quantized on K3 {kept_ms:.2f} ms; K3 against dense on t5_tokens (40 of 128 "
        f"kept) rel={err['rel']:.3e} "
        f"max_abs={err['max_abs']:.3e} (limit rel {GGUF_T5_TOL['q8_0']}); launches of one "
        f"keep-quantized encode {kept_launches} | {card}")
    if not same_file:
        raise AssertionError("dump-embeds wrote other embeddings than the dense encode")
    if not err["rel"] <= GGUF_T5_TOL["q8_0"]:
        raise AssertionError(f"Q8_0 keep-quantized encode drifts from dense: {err}")
    if kept_launches.get("w8_matmul", 0) != 168:
        raise AssertionError(f"keep-quantized encode launches {kept_launches}, want 168 K3")
    del dense, kept, got, want
    gc.collect()
    torch.cuda.empty_cache()
    host_block_s = host_route_block_s(path)
    log(f"[gguf] the former host route (NumPy dequant, transposed copy, upload) of one block: "
        f"{host_block_s:.2f} s, x24 = {24 * host_block_s:.1f} s, against the dense load's "
        f"{seen['load_s'][1]:.2f} s with Q8_0 split on the card | {card}")

    plain_2b = {"flash_attention_packed": 196, "w8_matmul": 0, "w4_matmul": 0,
                "threefry_normal": 0}
    t5_row, lat_t5 = gguf_cli_run(card, "distilled_t5_gguf",
                                  ["--t5-gguf", path, "--prompt", GGUF_PROMPT,
                                   "--output-type", "latent"], plain_2b, root)
    emb_row, lat_emb = gguf_cli_run(card, "distilled_embeddings_file",
                                    ["--embeddings-file", emb_path, "--output-type", "latent"],
                                    plain_2b, root)
    diff = (lat_t5 - lat_emb).abs().max().item()
    log(f"[gguf] --t5-gguf against --embeddings-file (dump-embeds): latents "
        f"{tuple(lat_t5.shape)} max |diff| {diff:.3e}, bit-equal: {torch.equal(lat_t5, lat_emb)}"
        f" | {card}")
    if not torch.equal(lat_t5, lat_emb):
        raise AssertionError(f"--embeddings-file latents differ from --t5-gguf's by {diff}")
    # 40 steps x 28 layers of K1 at B = 3; the prompt's and the negative
    # prompt's encodes, 168 K3 each; the decode noise
    dev_want = {"flash_attention_packed": 28 * 40, "w8_matmul": 2 * 168, "w4_matmul": 0,
                "w8_matmul_dequant": 0, "flash_attention_packed_long": 0,
                "threefry_normal": 1}
    dev_row, _ = gguf_cli_run(card, "0.9.5-2b_t5_keep_quantized",
                              ["--version", "0.9.5-2b", "--t5-gguf", path, "--t5-keep-quantized",
                               "--prompt", GGUF_PROMPT, "--negative-prompt", DEV_NEGATIVE],
                              dev_want, root)
    log(f"[gguf] 0.9.5-2b request: step mean {dev_row['step_mean_ms']:.1f} ms = "
        f"{dev_row['step_mean_ms'] / t5_row['step_mean_ms']:.2f}x the distilled step "
        f"({t5_row['step_mean_ms']:.1f} ms, the --t5-gguf run); generate "
        f"{dev_row['generate_s']:.2f} s, the CLI call {dev_row['wall_s']:.2f} s | {card}")
    os.remove(path)
    q5 = check_gguf_q5_k_m(card, root)
    shutil.rmtree(root)
    phase_s = time.perf_counter() - t_phase
    log(f"[gguf] phase took {phase_s:.1f} s | {card}")
    RESULTS["gguf_t5"] = dict(
        file=info, listed=dict(listed), dump_embeds_s=dump_s, load_s=seen["load_s"],
        host_route_block_s=host_block_s,
        resident_gib=seen["load_s_gib"], encode_ms=dict(dense=dense_ms, kept=kept_ms),
        kept_vs_dense=err, kept_launches=kept_launches,
        cli={r["name"]: {k: v for k, v in r.items() if k != "argv"}
             for r in (t5_row, emb_row, dev_row)},
        round_trip_bit_equal=True, q5_k_m=q5, phase_s=phase_s)
    return dev_row["launches"]


def phase(name, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds kept under ``name`` in
    ``RESULTS["phase_s"]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        RESULTS.setdefault("phase_s", {})[name] = time.perf_counter() - t0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--guided-drift"]):
        print(f"chip_smoke: unknown arguments {argv}; usage: python3 chip_smoke.py "
              "[--guided-drift]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from candle_video_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    os.makedirs(OUT_DIR, exist_ok=True)

    card = gpu_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    path = _build.build()
    log(f"[build] {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s")
    _build.lib()
    check_ptxas(card)
    if argv == ["--guided-drift"]:
        for quant in (None, "w4"):
            for prompt in GUIDED_DRIFT_PROMPTS:
                check_small_slice(card, quant=quant, guided=True, prompt=prompt)
        return 0

    k1 = phase("check_k1", check_k1, card)
    k2 = phase("check_k2", check_k2, card)
    k3, k4 = phase("check_k3_k4", check_k3_k4, card)
    w4dq, w4dq_step = phase("check_w4_dequant", check_w4_dequant, card)
    k5 = phase("check_k5", check_k5, card)
    k7 = phase("check_k7", check_k7, card)
    k8 = phase("check_k8", check_k8, card)
    r1 = phase("check_r1", check_r1, card)
    phase("small_slice", check_small_slice, card)
    phase("small_slice w4", check_small_slice, card, quant="w4")
    phase("small_slice w8a8", check_small_slice, card, quant="w8a8")
    phase("small_slice guided", check_small_slice, card, guided=True)
    phase("small_slice w4 guided", check_small_slice, card, quant="w4",
          guided=True)
    phase("check_i2v_slice", check_i2v_slice, card)
    launches, launches_k8, launches_inject = phase("run_e2e", run_e2e, card)
    launches_stochastic = phase("run_stochastic", run_stochastic, card)
    launches_i2v, launches_k8_encode = phase("run_i2v", run_i2v, card)
    launches_w8a8 = phase("run_w8a8", run_w8a8, card)
    launches_sp = phase("run_sp", run_sp, card)
    launches_long = phase("run_long", run_long, card)
    launches_serving = phase("run_serving", run_serving, card)
    launches_13b, launches_dev_w4 = phase("run_13b_w4", run_13b_w4, card)
    launches_dev_w8 = phase("run_13b_w8", run_13b_w8, card)
    launches_pp, launches_tp = phase("run_parallel", run_parallel, card)
    phase("run_checkpoint", run_checkpoint, card)
    launches_gguf = phase("run_gguf_t5", run_gguf_t5, card)
    phase("run_cli", run_cli, card)
    k6 = phase("check_k6", check_k6, card)
    phase("check_svd_slice", check_svd_slice, card)
    launches_svd = phase("run_svd", run_svd, card)
    def entry(name, source, replaces, launched, row):
        return dict(name=name, route="cuda", source=f"candle_video_tpu_torch/csrc/{source}",
                    replaces=f"candle_video_tpu/ops/pallas/{replaces}", launches=launched,
                    max_abs_err=row["max_abs"], ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=row["library_ms"])

    kernels = [
        entry("flash_attention_packed", "flash_attention_hopper.cu",
              "flash_attention_packed.py:543", launches["flash_attention_packed"], k1),
        entry("flash_attention_packed_long", "flash_attention_hopper.cu",
              "flash_attention_packed.py:392", launches_long["flash_attention_packed_long"], k2),
        entry("w8_matmul", "weight_only_matmul_hopper.cu", "int8_weight_matmul.py:82",
              launches["w8_matmul"], k3),
        entry("w4_matmul", "weight_only_matmul_hopper.cu", "int4_weight_matmul.py:205",
              launches_13b["w4_matmul"], k4),
        entry("ring_chunk_update", "flash_attention_hopper.cu", "ring_chunk.py:91",
              launches_sp["ring_chunk_update"], k5),
        entry("flash_attention", "flash_attention_hopper.cu", "flash_attention.py:175",
              launches_svd["flash_attention"], k6),
        entry("w8a8_matmul", "int8_matmul.cu", "int8_matmul.py:48",
              launches_w8a8["w8a8_matmul"], k7),
        entry("conv3d_igemm", "conv3d_igemm.cu", "conv3d_igemm.py:98",
              launches_k8["conv3d_igemm"], k8),
    ]
    # K1 on the t2v and the i2v request; K8 on the igemm decode and encode, each
    # path read with the counts set to 0 just before it
    kernels[0]["launches_by_path"] = {
        "t2v 2B 97f": launches["flash_attention_packed"],
        "0.9.5-2b 97f cfg+stg": launches_gguf["flash_attention_packed"],
        "i2v 2B 97f": launches_i2v["flash_attention_packed"],
        "serving 2B 97f b2": launches_serving["flash_attention_packed"],
        "13b-dev w4 97f": launches_dev_w4["flash_attention_packed"],
        "13b tp=2 rank 97f": launches_tp["flash_attention_packed"],
        "13b-dev pp=1 M=3 97f": launches_pp["flash_attention_packed"]}
    # K3 and K4 on the 13B-dev request (W8 at 4 steps, W4 at 30); K3 on the
    # 0.9.5-2b request's two encodes by the GGUF T5 kept quantized
    kernels[2]["launches_by_path"] = {"t2v 2B 97f": launches["w8_matmul"],
                                      "13b-dev": launches_dev_w8["w8_matmul"],
                                      "t5 gguf q8_0 keep-quantized": launches_gguf["w8_matmul"]}
    kernels[3]["launches_by_path"] = {"13b w4 97f": launches_13b["w4_matmul"],
                                      "13b-dev": launches_dev_w4["w4_matmul"]}
    kernels[-1]["launches_by_path"] = {"igemm decode 97f": launches_k8["conv3d_igemm"],
                                       "igemm encode 97f": launches_k8_encode["conv3d_igemm"]}
    kernels[-1]["launches"] = sum(kernels[-1]["launches_by_path"].values())
    kernels[-1]["kernel_ms"] = k8["kernel_ms"]  # K8 alone, beside its wrapper's ms
    kernels[2]["kernel_ms"] = k3["kernel_ms"]   # K3 and K4 on the device, by profile
    kernels[3]["kernel_ms"] = k4["kernel_ms"]
    kernels[1].update(kernel_ms=k2["kernel_ms"], shift_ms=k2["shift_ms"])  # K2 alone, its shift
    # R1, the port's own kernel: no Pallas kernel; it replaces the jax.random
    # draws inside the JAX package's XLA programs (the server's vmap over
    # seeds first).  Its yardstick is the host NumPy draw it replaced.
    kernels.append(dict(
        name="threefry_normal", route="cuda",
        source="candle_video_tpu_torch/csrc/threefry_normal.cu",
        replaces="candle_video_tpu/serving.py:41", launches=launches["threefry_normal"],
        max_abs_err=r1["max_abs"], ms=r1["ms"], plain_ms=r1["plain_ms"],
        bound_ms=r1["bound_ms"], bound_by=r1["bound_by"], library_ms=None,
        kernel_ms=r1["kernel_ms"], host_ms=r1["host_ms"], host_upload_ms=r1["host_upload_ms"],
        launches_by_path={"t2v 2B 97f": launches["threefry_normal"],
                          "stochastic 0.9.6 2B 97f": launches_stochastic["threefry_normal"],
                          "i2v 2B 97f": launches_i2v["threefry_normal"],
                          "serving 2B 97f b2": launches_serving["threefry_normal"],
                          "injected decode 2B 97f": launches_inject,
                          "svd 576x1024x14": launches_svd["threefry_normal"]}))
    # the W4 transient dequant, the port's own kernel: no Pallas kernel (the
    # JAX package's w4_matmul_xla leaves the dequant to XLA); its yardstick is
    # the plain dequantize it replaced on the card
    kernels.append(dict(
        name="w4_dequant", route="cuda", source="candle_video_tpu_torch/csrc/w4_dequant.cu",
        replaces="candle_video_tpu/ops/pallas/int4_weight_matmul.py w4_matmul_xla (XLA)",
        launches=launches_13b["w4_dequant"], max_abs_err=0.0, ms=w4dq[0]["ms"],
        plain_ms=w4dq[0]["plain_ms"], bound_ms=w4dq[0]["bound_ms"],
        bound_by=w4dq[0]["bound_by"], library_ms=None, kernel_ms=w4dq[0]["kernel_ms"],
        step=w4dq_step, launches_by_path={"13b w4 97f": launches_13b["w4_dequant"],
                                          "13b-dev": launches_dev_w4["w4_dequant"]}))
    RESULTS.update(card=card, kernels=kernels)
    log("[phases] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in RESULTS["phase_s"].items()))
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

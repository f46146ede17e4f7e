"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``candle_video_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main paths' shapes (K2
and K5 also as copies broken on purpose, which must fail), then drives on
random weights, checking the outputs and the kernels' launch counts of
every request:

- the ``0.9.8-2b-distilled`` path at 512x768x97 (T5-XXL int8 → 28-layer 2B
  DiT on K1, 7 steps → VAE decode): a cold and a warm request with
  per-stage times and one more warm request timed end to end only;
- the same request through the sequence-parallel path in a ring of one
  (``generate(sp_mesh=make_mesh(sp=1))`` in a one-rank NCCL group): every
  DiT self-attention on K5, none on K1, against the request without it;
- the same preset's long clip, 512x768x257 (S = 12672: every DiT
  self-attention on K2): a cold and a warm request, then the exact decode
  modes (dense, tail stream, ups-split stream; the full stream on a
  128x192x369 clip) against the dense decode, with their peak memory;
- the ``0.9.8-13b-distilled`` W4A16 resident path at 512x768x97
  (Q4_K-form T5-XXL on K4 → 48-layer 13B DiT with int4 block linears →
  VAE decode with the streamed tail in 6 chunks): a cold and a warm request;
- the 13B W8A16 tier (int8 T5 → 13B DiT with int8 block linears): one
  request;
- SVD image-to-video at its published request, 576x1024x14 with CFG (CLIP
  → noise-augmented VAE encode → 25 v-prediction Euler steps of the UNet at
  batch 28, the level-0 self-attention on K6 and levels 1-2 on K1 →
  temporal VAE decode): a 2-step warm-up request and the 25-step one, after
  K6 against its plain version (and a copy broken on purpose) and a tiny SVD
  slice against the CPU;

and runs the CLI for the 2B and the 13B int4 paths.  Run from the
repository root:

    python3 chip_smoke.py

The last line is ``{"ok": true, "device": {...}}``; any failed phase raises
and the exit code is not 0.  Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import copy
import gc
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
from pathlib import Path

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
# the card's dense bf16 tensor-core peak and memory rate (H100 SXM data sheet)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
K3_TOL = dict(rel=2e-4)                 # bf16 output rounding
K4_TOL = dict(rel=2e-4)                 # bf16 output rounding
SLICE_TOL = dict(latent_rel=2e-2, video_psnr=35.0)  # bf16 card run vs f32 plain run
# The tiny SVD slice with CFG: the 1 -> 3 ramp scales up the random-weight
# UNet's bf16 rounding, so bf16 alone drifts past 2e-2 from f32.  Readings on
# an H100 against the CPU f32 run: the card 2.717e-2, the CPU's bf16 run of
# the plain versions 2.732e-2 (1.543e-2 and 1.545e-2 without CFG); the two
# bf16 runs differ from each other by 2.806e-2, as the kernels round p in
# another order.  The card may drift 1.25x as far as the CPU's bf16 run.
SVD_CFG_DRIFT = 1.25
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


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the bf16 peak and the bytes (each input read once, each output written
    once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
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


def check_k1(card):
    from candle_video_tpu_torch.ops.kernels import flash_attention_packed as K1
    from candle_video_tpu_torch.ops.rope import apply_rotary_emb, rope_cos_sin

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    # (label, B, S, K, H, D, bias, rope): the path's shape first
    cases = [("path 1x4992x32x64 rope", 1, 4992, 4992, 32, 64, False, True),
             ("13B path 1x4992x32x128 rope", 1, 4992, 4992, 32, 128, False, True),
             ("ragged S=K=1000 bias rope", 1, 1000, 1000, 32, 64, True, True),
             ("D=128 S=1000 K=1031 bias", 2, 1000, 1031, 16, 128, True, False),
             # 63 of the last tile's 64 key slots are padding: a missing mask fails
             ("K=65 bias padded tile", 2, 200, 65, 8, 64, True, False),
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
            if s == 4992:  # the real tables of a 512x768x97 request (inner h·d)
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
    RESULTS["k1"] = rows
    return rows[0]


# the broken K2: the shift moves from tile to tile (m + tile index), so the
# key tiles' partial sums no longer add up to one softmax
K2_BREAK = ("const float p = exp2f((val - mfix) * LOG2E);",
            "const float p = exp2f((val - (mfix + (float)it)) * LOG2E);")


# the broken K5: each CTA drops the carried running sum l (starts it at 0),
# so after more than one ring step the output is normalised by the last
# chunks' sums only
K5_BREAK = ("l[r] = lane % 4 == 0 ? l_st[st0 + 8 * r] : 0.f;", "l[r] = 0.f;")


def broken_copy(tag, substitution, fn):
    """Run ``fn`` on a kernel library built from a copy of ``csrc/`` with
    ``substitution`` applied to ``flash_attention_packed.cu`` (under the
    gitignored output directory), then restore the real library."""
    from candle_video_tpu_torch.ops.kernels import _build

    root = os.path.join(OUT_DIR, f"broken_{tag}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, os.path.join(root, "csrc"))
    src = os.path.join(root, "csrc", "flash_attention_packed.cu")
    with open(src) as f:
        text = f.read()
    if text.count(substitution[0]) != 1:
        raise AssertionError(f"the {tag} line to break is not in the source")
    with open(src, "w") as f:
        f.write(text.replace(*substitution))
    saved = _build.CSRC, _build.BUILD_DIR, _build._lib
    _build.CSRC, _build.BUILD_DIR, _build._lib = Path(root, "csrc"), Path(root, "_build"), None
    try:
        return fn()
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = saved


def check_k2(card):
    """K2 against its plain version at the 257-frame path's shape (and the
    13B head width, and a ragged biased case just over the route's
    threshold), timed beside K1 and SDPA on the same inputs; then the
    broken copy, which must fail the limits."""
    from candle_video_tpu_torch.ops.kernels import flash_attention_packed as FA
    from candle_video_tpu_torch.ops.rope import apply_rotary_emb, rope_cos_sin

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []
    # (label, B, S, K, H, D, bias, rope): the path's shape first
    cases = [("path 1x12672x32x64 rope 257f", 1, 12672, 12672, 32, 64, False, True),
             ("1x12672x32x128 rope 257f", 1, 12672, 12672, 32, 128, False, True),
             # K_pad 8320 > 8192; 1 of the last tile's 64 key slots is a key
             ("ragged K=8257 bias rope", 2, 1000, 8257, 32, 64, True, True)]
    inputs = {}
    for label, b, s, kv, h, d, with_bias, with_rope in cases:
        q = torch.randn(b, s, h * d, generator=g, device=dev).mul_(2).bfloat16()
        k = torch.randn(b, kv, h * d, generator=g, device=dev).bfloat16()
        v = torch.randn(b, kv, h * d, generator=g, device=dev).bfloat16()
        bias = None
        if with_bias:
            keep = torch.rand(b, kv, generator=g, device=dev) > 0.3
            bias = ((~keep).float() * -10000.0)[:, None, None, :].contiguous()
        if s == 12672:
            rope = path_rope(33, h, d, dev)
        else:
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
        k1_ms = cuda_ms(lambda: FA.flash_attention_packed_onepass(q, k, v, **args))
        plain_ms = cuda_ms(lambda: FA.flash_attention_packed_long_plain(q, k, v, **args),
                           iters=3, warmup=1)
        library_ms = sdpa_ms(q, k, v, h, d ** -0.5, bias, rope)
        row = dict(label=label, ms=ms, k1_ms=k1_ms, plain_ms=plain_ms, library_ms=library_ms,
                   k1_rel=k1_err["rel"], **err,
                   **attention_bound(b, s, kv, h, d, with_bias, True))
        tflops = 4.0 * b * h * s * kv * d / ms / 1e9
        log(f"[K2] {label}: max_abs={err['max_abs']:.3e} scaled={err['scaled']:.3e} "
            f"rel={err['rel']:.3e} kernel={ms:.3f} ms ({tflops:.1f} TFLOP/s, "
            f"{row['bound_ms'] / ms:.1%} of the {row['bound_ms']:.3f} ms bound, "
            f"{row['bound_by']}) K1={k1_ms:.3f} ms (rel {k1_err['rel']:.3e}) "
            f"sdpa={library_ms:.3f} ms plain={plain_ms:.2f} ms | {card}")
        if not (err["scaled"] <= K2_TOL["scaled"] and err["rel"] <= K2_TOL["rel"]):
            raise AssertionError(f"K2 {label} disagrees with its plain version: {err}")
        rows.append(row)
        inputs[label] = (q, k, v, args, want)
    RESULTS["k2"] = rows

    def run_broken():
        out = {}
        for label, (q, k, v, args, want) in inputs.items():
            out[label] = errors(FA.flash_attention_packed_long(q, k, v, **args), want)
            torch.cuda.synchronize()
        return out

    broken = broken_copy("k2", K2_BREAK, run_broken)
    for label, err in broken.items():
        log(f"[K2 broken: per-tile shift] {label}: rel={err['rel']:.3e} "
            f"scaled={err['scaled']:.3e} | {card}")
        if err["scaled"] <= K2_TOL["scaled"] and err["rel"] <= K2_TOL["rel"]:
            raise AssertionError(f"the broken K2 passes the limits at {label}: {err}")
    RESULTS["k2_broken"] = broken
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


# the broken K6: the running max no longer rescales what was summed before
# it (alpha = 1), so any row whose max rises after its first key tile is wrong
K6_BREAK = ("alpha[r] = exp2f((m[r] - m_new) * LOG2E);", "alpha[r] = 1.f;")
SVD_K6_SHAPE = (28, 9216, 5, 64)  # 576x1024x14 with CFG: 2 x 14 frames, 72·128 tokens


def check_k6(card):
    """K6 against its plain version: (a) the SVD path shape cut to one frame
    (1x9216x5x64), (b) D = 128, H = 3, ragged K = 1000 with an f32 bias,
    (c) K = 65, which a missing padded-key mask fails.  Each timed beside
    SDPA (flash backend without a bias, the default one with it).  Then the
    full path call [28, 9216, 5, 64], held against its plain version run
    one frame at a time (at once it would hold 47.6 GB of scores), and the
    broken copy, which must fail (a)-(c).  Returns the path call's row."""
    from candle_video_tpu_torch.ops.kernels import flash_attention as K6

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    # (label, B, S, K, H, D, bias): the path's shape first
    cases = [("(a) path frame 1x9216x5x64", 1, 9216, 9216, 5, 64, False),
             ("(b) D=128 H=3 S=777 K=1000 bias", 2, 777, 1000, 3, 128, True),
             # 63 of the last tile's 64 key slots are padding: a missing mask fails
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

    broken = broken_copy("k6", K6_BREAK, run_broken)
    for label, err in broken.items():
        log(f"[K6 broken: no running-max rescale] {label}: rel={err['rel']:.3e} "
            f"scaled={err['scaled']:.3e} | {card}")
        if err["scaled"] <= K6_TOL["scaled"] and err["rel"] <= K6_TOL["rel"]:
            raise AssertionError(f"the broken K6 passes the limits at {label}: {err}")
    RESULTS["k6_broken"] = broken
    return full


def check_k3(card):
    from candle_video_tpu_torch.ops.kernels import int8_weight_matmul as K3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for qb in (32, 16):
        for kk, n in ((4096, 4096), (4096, 10240), (10240, 4096)):
            x = torch.randn(128, kk, generator=g, device=dev).bfloat16()
            w_q = torch.randint(-127, 128, (kk, n), generator=g, device=dev,
                                dtype=torch.int8)
            s = torch.rand(kk // qb, n, generator=g, device=dev) * 1e-3 + 1e-4
            got = K3.w8_matmul(x, w_q, s, qblock=qb)
            want = K3.w8_matmul_plain(x, w_q, s, qblock=qb)
            torch.cuda.synchronize()
            err = errors(got, want)
            ms = cuda_ms(lambda: K3.w8_matmul(x, w_q, s, qblock=qb), iters=20)
            plain_ms = cuda_ms(lambda: K3.w8_matmul_plain(x, w_q, s, qblock=qb), iters=20)
            gbs = kk * n * (1 + 4 / qb) / ms / 1e6
            log(f"[K3] M=128 K={kk} N={n} qb={qb}: rel={err['rel']:.3e} "
                f"max_abs={err['max_abs']:.3e} kernel={ms:.4f} ms ({gbs:.0f} GB/s weight "
                f"stream) plain={plain_ms:.4f} ms | {card}")
            if not err["rel"] <= K3_TOL["rel"]:
                raise AssertionError(f"K3 K={kk} N={n} qb={qb} disagrees: {err}")
            nbytes = 2 * 128 * kk + kk * n + 4 * (kk // qb) * n + 2 * 128 * n
            rows.append(dict(k=kk, n=n, qblock=qb, ms=ms, plain_ms=plain_ms, library_ms=None,
                             **err, **bound(2.0 * 128 * kk * n, nbytes)))
    RESULTS["k3"] = rows
    return next(r for r in rows if (r["k"], r["n"], r["qblock"]) == (4096, 10240, 32))


def check_k4(card):
    from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    # (label, M, K, N, scale dtype, bias): the T5 linears at 128 tokens, the
    # 13B DiT's cross-attention k/v over 128 caption tokens, one ragged case
    cases = [("T5 q/k/v/o", 128, 4096, 4096, torch.float32, False),
             ("T5 wi_0/wi_1", 128, 4096, 10240, torch.float32, False),
             ("T5 wo", 128, 10240, 4096, torch.float32, False),
             ("DiT attn2 k/v", 128, 4096, 4096, torch.bfloat16, True),
             ("ragged", 77, 4096, 4000, torch.float32, True)]
    for label, m, kk, n, sdt, with_bias in cases:
        x = torch.randn(m, kk, generator=g, device=dev).bfloat16()
        w_p = torch.randint(0, 256, (kk // 2, n), generator=g, device=dev, dtype=torch.uint8)
        # the DiT init's affine form: s ~ 0.02/4.61, m ~ -7.5·s (centred weights)
        s = (torch.rand(kk // 32, n, generator=g, device=dev) * 0.5 + 0.75) * (0.02 / 4.61)
        mn = -7.5 * s * (1.0 + 0.05 * torch.randn(s.shape, generator=g, device=dev))
        s, mn = s.to(sdt), mn.to(sdt)
        bias = (torch.randn(n, generator=g, device=dev) * 0.1).bfloat16() if with_bias else None
        got = K4.w4_matmul(x, w_p, s, mn, bias)
        want = K4.w4_matmul_plain(x, w_p, s, mn, bias)
        torch.cuda.synchronize()
        err = errors(got, want)
        ms = cuda_ms(lambda: K4.w4_matmul(x, w_p, s, mn, bias), iters=20)
        plain_ms = cuda_ms(lambda: K4.w4_matmul_plain(x, w_p, s, mn, bias), iters=20)
        weight_bytes = kk // 2 * n + 2 * (kk // 32) * n * s.element_size()
        gbs = weight_bytes / ms / 1e6
        log(f"[K4] {label} M={m} K={kk} N={n} s,m {str(sdt)[6:]}"
            f"{' bias' if with_bias else ''}: rel={err['rel']:.3e} "
            f"max_abs={err['max_abs']:.3e} kernel={ms:.4f} ms ({gbs:.0f} GB/s weight "
            f"stream) plain={plain_ms:.4f} ms | {card}")
        if not err["rel"] <= K4_TOL["rel"]:
            raise AssertionError(f"K4 {label} disagrees with its plain version: {err}")
        nbytes = 2 * m * kk + weight_bytes + 2 * m * n + 2 * n * with_bias
        rows.append(dict(label=label, m=m, k=kk, n=n, scale_dtype=str(sdt), ms=ms,
                         plain_ms=plain_ms, weight_gb_s=gbs, library_ms=None, **err,
                         **bound(2.0 * m * kk * n, nbytes)))
    RESULTS["k4"] = rows
    return next(r for r in rows if r["label"] == "DiT attn2 k/v")


def check_small_slice(card, quant=None):
    """The tiny slice on the card (kernels, bf16) against the same weights on
    the CPU (plain versions, f32): dense DiT and int8 T5 (K1, K3), or with
    ``quant="w4"`` int4 DiT block linears and the Q4_K-form T5 (K1, K4)."""
    from candle_video_tpu_torch.models.ltx_video import configs as C
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.models.ltx_video import t5 as T5
    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.models.ltx_video import vae as V
    from candle_video_tpu_torch.utils.tokenizer import MockTokenizer

    cfg = C.LtxFullConfig(
        inference=C.get_config_by_version("0.9.8-2b-distilled").inference,
        transformer=C.LtxTransformerConfig(in_channels=8, out_channels=8,
                                           num_attention_heads=4, num_layers=2,
                                           caption_channels=64),
        vae=C.LtxVaeConfig(latent_channels=8, decoder_block_out_channels=(16, 32),
                           decoder_spatiotemporal_scaling=(True, True),
                           decoder_layers_per_block=(1, 1, 1),
                           decoder_upsample_residual=(True, True),
                           decoder_upsample_factor=(2, 2), patch_size=2,
                           spatial_compression_ratio=8, temporal_compression_ratio=4),
        scheduler=C.get_config_by_version("0.9.8-2b-distilled").scheduler)
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
        def t5(device, dtype):
            return T5.init_random_int8(t5cfg, device, dtype, 0.01)
    cpu = P.LtxPipeline(cfg, transformer, V.init_random(cfg.vae, "cpu", torch.float32, g),
                        t5("cpu", torch.float32), t5cfg, tok)
    gpu = P.LtxPipeline(cfg, copy.deepcopy(cpu.transformer).to("cuda", torch.bfloat16),
                        copy.deepcopy(cpu.vae).to("cuda", torch.bfloat16),
                        t5("cuda", torch.bfloat16), t5cfg, tok)
    kw = dict(prompt="a red fox in the snow", height=64, width=96, num_frames=9, seed=7,
              max_sequence_length=32, decode_noise=torch.zeros(1, 8, 3, 8, 12))
    lat_c = P.generate(cpu, output_type="latent", **kw)
    lat_g = P.generate(gpu, output_type="latent", **kw).cpu()
    vid_c = P.generate(cpu, **kw)
    vid_g = P.generate(gpu, **kw).cpu()
    rel = ((lat_g - lat_c).norm() / lat_c.norm()).item()
    mse = (vid_g.double() - vid_c.double()).square().mean().item()
    psnr = float("inf") if mse == 0 else 10 * torch.log10(torch.tensor(255.0 ** 2 / mse)).item()
    name = "tiny t2v" + (" W4 DiT + Q4_K-form T5" if quant else "")
    log(f"[slice] {name}, card bf16 kernels vs CPU f32 plain: latent rel={rel:.3e} "
        f"video PSNR={psnr:.2f} dB | {card}")
    if not (rel <= SLICE_TOL["latent_rel"] and psnr >= SLICE_TOL["video_psnr"]):
        raise AssertionError(f"{name} disagrees with the CPU reference: rel={rel} "
                             f"psnr={psnr}")
    RESULTS[f"small_slice{'_' + quant if quant else ''}"] = dict(latent_rel=rel,
                                                                 video_psnr=psnr)


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
        stages = (f" t5={row['t5_encode_s'] * 1e3:.1f} ms "
                  f"denoise step mean={row['denoise_step_mean_ms']:.1f} ms "
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
    pipe, _ = build_pipeline("e2e", card, "0.9.8-2b-distilled")
    want = {"flash_attention_packed": 196, "w8_matmul": 168, "w4_matmul": 0}
    # cold and warm with per-stage times (a sync after every stage and step),
    # then warm again timed end to end only, with no sync inside generate()
    requests = [("cold", "A cat walking on grass", True),
                ("warm", "A sailboat crossing a bay at sunset", True),
                ("warm-nosync", "A lighthouse on a cliff in a storm", False)]
    runs = [run_request(pipe, name, prompt, 42 + i, want, card, staged)[0]
            for i, (name, prompt, staged) in enumerate(requests)]
    RESULTS["e2e"] = runs
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
    check_decode_modes(card, pipe.vae, decoded["z"], decoded["temb"], video)
    del video
    release(pipe)
    return runs[-1]["launches"]


def run_13b_w4(card):
    """The 13B W4A16 path with the DiT, the Q4_K-form T5 and the VAE decoder
    all resident: K4 carries every T5 linear (24 x 7) and the DiT's
    cross-attention k/v (48 x 2 x 7 steps); block 42 is a permanent skip,
    computed and then masked, so every layer launches K1.  It decodes with
    the streamed tail in 6 chunks, as the JAX package's 13B W4 bench does."""
    pipe, gib = build_pipeline("13b-w4", card, "0.9.8-13b-distilled", dit_quant="w4",
                               t5_quant="w4")
    want = {"w4_matmul": 168 + 672, "flash_attention_packed": 336, "w8_matmul": 0}
    runs = [run_request(pipe, name, prompt, 42 + i, want, card, tag="13b-w4",
                        vae_tail_stream_chunks=6)[0]
            for i, (name, prompt) in enumerate([
                ("cold", "A red panda climbing a snow-covered pine tree"),
                ("warm", "A hot air balloon over a canyon at dawn")])]
    RESULTS["e2e_13b_w4"] = dict(resident_gib=gib, runs=runs)
    release(pipe)
    return runs[-1]["launches"]


def run_13b_w8(card):
    """The 13B W8A16 tier at full depth (L' = 48 of 48 layers, not cut):
    K3 carries the int8 T5 (168) and the DiT's cross-attention k/v
    (14 per layer)."""
    layers = 48
    pipe, gib = build_pipeline("13b-w8", card, "0.9.8-13b-distilled", dit_quant="w8")
    want = {"w8_matmul": 168 + 14 * layers, "flash_attention_packed": 7 * layers,
            "w4_matmul": 0}
    row, _ = run_request(pipe, f"L'={layers} (full depth)",
                         "A fox running through tall grass", 51, want, card, tag="13b-w8")
    RESULTS["e2e_13b_w8"] = dict(resident_gib=gib, layers=layers, run=row)
    release(pipe)


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
      ``SVD_CFG_DRIFT`` times the drift of the CPU's own bf16 run of the
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
        limit = SLICE_TOL["latent_rel"] if gmax == 1.0 else SVD_CFG_DRIFT * drift
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
        want = {k: c * n for k, c in per_step.items()} | dict.fromkeys(others, 0)
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


def run_cli(card):
    from candle_video_tpu_torch import cli

    for name, extra in (("cli_smoke", []),
                        ("cli_smoke_13b_int4", ["--version", "0.9.8-13b-distilled",
                                                "--dit-int4"])):
        out = os.path.join(OUT_DIR, name)
        t0 = time.perf_counter()
        rc = cli.main([*extra, "--height", "256", "--width", "384", "--num-frames", "25",
                       "--output-type", "latent", "--output-dir", out])
        if rc != 0:
            raise AssertionError(f"cli {extra} returned {rc}")
        lat = torch.load(os.path.join(out, "latents.pt"))
        if tuple(lat.shape) != (1, 4 * 8 * 12, 128) or not torch.isfinite(lat).all():
            raise AssertionError(f"cli {extra} latents {tuple(lat.shape)}")
        log(f"[cli] {' '.join(extra) or '2B'} 256x384x25 latent run in "
            f"{time.perf_counter() - t0:.2f} s | {card}")
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
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

    k1 = check_k1(card)
    k2 = check_k2(card)
    k3 = check_k3(card)
    k4 = check_k4(card)
    k5 = check_k5(card)
    check_small_slice(card)
    check_small_slice(card, quant="w4")
    launches = run_e2e(card)
    launches_sp = run_sp(card)
    launches_long = run_long(card)
    launches_13b = run_13b_w4(card)
    run_13b_w8(card)
    run_cli(card)
    k6 = check_k6(card)
    check_svd_slice(card)
    launches_svd = run_svd(card)

    def entry(name, source, replaces, launched, row):
        return dict(name=name, route="cuda", source=f"candle_video_tpu_torch/csrc/{source}",
                    replaces=f"candle_video_tpu/ops/pallas/{replaces}", launches=launched,
                    max_abs_err=row["max_abs"], ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=row["library_ms"])

    kernels = [
        entry("flash_attention_packed", "flash_attention_packed.cu",
              "flash_attention_packed.py:543", launches["flash_attention_packed"], k1),
        entry("flash_attention_packed_long", "flash_attention_packed.cu",
              "flash_attention_packed.py:392", launches_long["flash_attention_packed_long"], k2),
        entry("w8_matmul", "int8_weight_matmul.cu", "int8_weight_matmul.py:82",
              launches["w8_matmul"], k3),
        entry("w4_matmul", "int4_weight_matmul.cu", "int4_weight_matmul.py:205",
              launches_13b["w4_matmul"], k4),
        entry("ring_chunk_update", "flash_attention_packed.cu", "ring_chunk.py:91",
              launches_sp["ring_chunk_update"], k5),
        entry("flash_attention", "flash_attention_packed.cu", "flash_attention.py:175",
              launches_svd["flash_attention"], k6),
    ]
    RESULTS.update(card=card, kernels=kernels)
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

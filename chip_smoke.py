"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``candle_video_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main paths' shapes (all
eight also as copies broken on purpose, which must fail; K3 and K4 also at
qblocks the kernel is not built for, on their dequant route), then
drives on random weights, checking the outputs and the kernels' launch
counts of every request:

- the ``0.9.8-2b-distilled`` path at 512x768x97 (T5-XXL int8 → 28-layer 2B
  DiT on K1, 7 steps → VAE decode): a cold and a warm request with
  per-stage times and one more warm request timed end to end only; then the
  last request's latents decoded again with every eligible decoder conv on
  K8 (``CVT_CONV3D_IMPL=igemm``) against the default cuDNN decode;
- the same request on the W8A8 DiT tier (``quantize_transformer_w8a8``:
  every block linear on K7) against the bf16 request;
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
- a full-size official-layout 2B checkpoint written by the port's writer
  and run through the CLI (``--weights-path``) in bf16, ``--dit-int8`` and
  ``--dit-int4`` against the in-memory pipeline on the same weights, and a
  full-width T5 HF directory of 2 of the 24 blocks;
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
             "weight_only_matmul_hopper.cu")


def check_ptxas(card):
    """Every kernel's registers and spill bytes as ``ptxas -v`` reported
    them at the build; the kernels of the ``NO_SPILLS`` sources (the
    attention modes K1, K2, K5 and K6; K7; K8) must not spill."""
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
        if kv > 128 and b == 1 or label.startswith("K=129"):
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
            ("T5 CFG q/k/v/o", 256, 4096, 4096, 32, False),
            ("ragged N qb64", 77, 4096, 4001, 64, True),
            ("ragged N qb128 M=256", 256, 2048, 1000, 128, True)]
K4_CASES = [("T5 q/k/v/o", 128, 4096, 4096, 32, False, torch.float32),
            ("T5 wi_0/wi_1", 128, 4096, 10240, 32, False, torch.float32),
            ("T5 wo", 128, 10240, 4096, 32, False, torch.float32),
            ("DiT attn2 k/v", 128, 4096, 4096, 32, True, torch.bfloat16),
            ("ragged", 77, 4096, 4000, 32, True, torch.float32),
            ("T5 CFG q/k/v/o", 256, 4096, 4096, 32, False, torch.float32),
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
    (one count of ``w8_matmul_dequant`` / ``w4_matmul_dequant``, no kernel
    launch) and agrees with the plain version."""
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
        if launches != {mod.DEQUANT_NAME: 1}:
            raise AssertionError(f"{tag} qb {qb}: launches {launches}, want one "
                                 f"{mod.DEQUANT_NAME} and no kernel")
        if not err["rel"] <= NARROW_QBLOCK_TOL["rel"]:
            raise AssertionError(f"{tag} qb {qb} ({mod.DEQUANT_NAME}) disagrees with its plain "
                                 f"version: {err}")
        ms = cuda_ms(lambda: call(*args), iters=20)
        row = dict(tag=tag, m=m, k=kk, n=n, qblock=qb, route=mod.DEQUANT_NAME, ms=ms, **err)
        log(f"[{tag} qb {qb}] M={m} K={kk} N={n}: {mod.DEQUANT_NAME} (no kernel launch) "
            f"rel={err['rel']:.3e} max_abs={err['max_abs']:.3e} (limit rel "
            f"{NARROW_QBLOCK_TOL['rel']}) {ms:.4f} ms | {card}")
        rows.append(row)
    RESULTS["narrow_qblocks"] = rows


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
    ``time_pad="valid"`` case as the streamed decode calls it, and B = 2 on
    a 13x20 frame that the plan's rectangle does not divide; input and
    output channels last.  ``ms`` is the wrapper call, as for every kernel
    (it packs each weight once and keeps the copy); ``kernel_ms`` the kernel
    alone on a pre-packed weight; both beside the plain version and cuDNN's bf16 ``F.conv3d`` on the
    same time-padded channels-first input (the default route).  Then the
    broken copy, which must fail."""
    from candle_video_tpu_torch.ops.conv3d import replicate_pad_time
    from candle_video_tpu_torch.ops.kernels import conv3d_igemm as K8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    rows, inputs = [], {}
    # (label, B, C (= O), T, H, W, causal, time_pad): the tail first
    cases = [("tail 128ch 97x128x192", 1, 128, 97, 128, 192, False, "edge"),
             ("tail 128ch 97x128x192 causal", 1, 128, 97, 128, 192, True, "edge"),
             ("up1 256ch 49x64x96", 1, 256, 49, 64, 96, False, "edge"),
             ("up1 256ch 49x64x96 causal", 1, 256, 49, 64, 96, True, "edge"),
             ("up0 512ch 25x32x48", 1, 512, 25, 32, 48, False, "edge"),
             ("up0 512ch 25x32x48 causal", 1, 512, 25, 32, 48, True, "edge"),
             ("mid 1024ch 13x16x24 split-K", 1, 1024, 13, 16, 24, False, "edge"),
             ("mid 1024ch 13x16x24 causal split-K", 1, 1024, 13, 16, 24, True, "edge"),
             ("tail stream chunk 128ch 26x128x192 valid", 1, 128, 26, 128, 192, False, "valid"),
             ("ragged B=2 128ch 5x13x20 causal", 2, 128, 5, 13, 20, True, "edge")]
    for label, b, c, t, h, w, causal, time_pad in cases:
        x = torch.randn(b, c, t, h, w, generator=g, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last_3d)
        wt = (torch.randn(c, c, 3, 3, 3, generator=g, device=dev) * (27 * c) ** -0.5).bfloat16()
        bias = (torch.randn(c, generator=g, device=dev) * 0.1).bfloat16()
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
        flops = 2.0 * b * t_out * h * w * c * c * 27
        nbytes = 2 * b * (c * t * h * w + c * t_out * h * w) + 2 * 27 * c * c + 4 * c
        row = dict(label=label, b=b, c=c, t=t, h=h, w=w, causal=causal, time_pad=time_pad,
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
        if t <= 25:  # the broken copy runs on the small cases
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


def check_small_slice(card, quant=None):
    """The tiny slice on the card (kernels, bf16) against the same weights on
    the CPU (plain versions, f32): dense DiT and int8 T5 (K1, K3), with
    ``quant="w4"`` int4 DiT block linears and the Q4_K-form T5 (K1, K4), or
    with ``quant="w8a8"`` the W8A8 DiT tier and the int8 T5 (K1, K7, K3)."""
    from candle_video_tpu_torch.models.ltx_video import configs as C
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.models.ltx_video import t5 as T5
    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.models.ltx_video import vae as V
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.ops.quant_linear import W8A8Linear
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
    kw = dict(prompt="a red fox in the snow", height=64, width=96, num_frames=9, seed=7,
              max_sequence_length=32, decode_noise=torch.zeros(1, 8, 3, 8, 12))
    lat_c = P.generate(cpu, output_type="latent", **kw)
    _build.reset_launches()
    lat_g = P.generate(gpu, output_type="latent", **kw).cpu()
    launches = dict(_build.LAUNCHES)
    want_k7 = cfg.inference.num_inference_steps * cfg.transformer.num_layers * 10
    if quant == "w8a8" and launches.get("w8a8_matmul", 0) != want_k7:
        raise AssertionError(f"tiny W8A8 slice launches {launches}, want {want_k7} "
                             "w8a8_matmul (steps x layers x 10 block linears)")
    vid_c = P.generate(cpu, **kw)
    vid_g = P.generate(gpu, **kw).cpu()
    rel = ((lat_g - lat_c).norm() / lat_c.norm()).item()
    mse = (vid_g.double() - vid_c.double()).square().mean().item()
    psnr = float("inf") if mse == 0 else 10 * torch.log10(torch.tensor(255.0 ** 2 / mse)).item()
    name = "tiny t2v" + {None: "", "w4": " W4 DiT + Q4_K-form T5",
                         "w8a8": " W8A8 DiT + int8 T5"}[quant]
    log(f"[slice] {name}, card bf16 kernels vs CPU f32 plain: latent rel={rel:.3e} "
        f"video PSNR={psnr:.2f} dB launches={launches} | {card}")
    if not (rel <= SLICE_TOL["latent_rel"] and psnr >= SLICE_TOL["video_psnr"]):
        raise AssertionError(f"{name} disagrees with the CPU reference: rel={rel} "
                             f"psnr={psnr}")
    RESULTS[f"small_slice{'_' + quant if quant else ''}"] = dict(
        latent_rel=rel, video_psnr=psnr, launches=launches)


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
    want = {"flash_attention_packed": 196, "w8_matmul": 168, "w4_matmul": 0,
            "w8a8_matmul": 0, "conv3d_igemm": 0}
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
    k8_launches = check_igemm_decode(card, pipe.vae, decoded["z"], decoded["temb"])
    release(pipe)
    return runs[-1]["launches"], k8_launches


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


# The decode on K8 against the cuDNN decode of the same latents, on [0, 255].
# Both run bf16 convs with f32 sums; a 44-conv random-weight decoder carries
# one-ulp differences forward.  Prediction before the first run: 45-60 dB.
IGEMM_DECODE_PSNR_DB = 40.0


def check_igemm_decode(card, decoder, z, temb):
    """The dense 97-frame decode of a request's latents with every eligible
    conv on K8 (``CVT_CONV3D_IMPL=igemm``: exactly 44 launches, conv_out
    stays on cuDNN) against the default cuDNN decode: the time and peak of
    each, in turns (cuDNN, K8, K8, cuDNN), the video's PSNR against cuDNN's,
    and the channels-last copies the decoder's own ops force before a K8
    conv, with their time estimated from one such copy timed at the tail's
    size."""
    from candle_video_tpu_torch.ops.kernels import _build
    from candle_video_tpu_torch.ops.kernels import conv3d_igemm as K8

    runs = {"cudnn": [], "igemm": []}
    videos = {}
    for impl in ("xla", "igemm", "igemm", "xla"):
        name = "cudnn" if impl == "xla" else "igemm"
        _build.reset_launches()
        K8.RELAYOUT.clear()
        with conv_impl(impl):
            video, sec, peak = decode_peak(decoder, z, temb)
        launches, relayout = dict(_build.LAUNCHES), dict(K8.RELAYOUT)
        want = 44 if name == "igemm" else 0
        if launches.get("conv3d_igemm", 0) != want:
            raise AssertionError(f"{name} decode: launch counts {launches}, want {want} K8")
        runs[name].append(dict(seconds=sec, peak_gib=peak / 2**30, launches=launches,
                               relayout_copies=relayout.get("copies", 0),
                               relayout_gib=relayout.get("bytes", 0) / 2**30))
        videos[name] = video.cpu()
        del video
    db = psnr(videos["igemm"], videos["cudnn"])
    x = torch.randn(1, 128, 97, 128, 192, device="cuda").bfloat16()
    copy_ms = cuda_ms(lambda: x.contiguous(memory_format=torch.channels_last_3d))
    copy_gbs = 2 * x.numel() / copy_ms / 1e6
    relayout_gib = runs["igemm"][0]["relayout_gib"]
    row = dict(shape=list(z.shape), runs=runs, psnr_db=db,
               max_abs=(videos["igemm"] - videos["cudnn"]).abs().max().item(),
               relayout_copy_gb_s=copy_gbs,
               relayout_est_ms=relayout_gib * 2**30 / copy_gbs / 1e6)
    log(f"[decode-k8] dense 97f decode of the e2e latents {tuple(z.shape)}: cuDNN "
        + ", ".join(f"{r['seconds']:.4f} s" for r in runs["cudnn"])
        + f" peak {runs['cudnn'][0]['peak_gib']:.2f} GiB; K8 "
        + ", ".join(f"{r['seconds']:.4f} s" for r in runs["igemm"])
        + f" peak {runs['igemm'][0]['peak_gib']:.2f} GiB, "
        f"{runs['igemm'][0]['launches']}; video PSNR vs cuDNN {db:.2f} dB "
        f"max_abs {row['max_abs']:.3f}; channels-last copies before K8: "
        f"{runs['igemm'][0]['relayout_copies']} ({relayout_gib:.2f} GiB, about "
        f"{row['relayout_est_ms']:.1f} ms at the measured {copy_gbs:.0f} GB/s) | {card}")
    if not (db >= IGEMM_DECODE_PSNR_DB and torch.isfinite(videos["igemm"]).all()):
        raise AssertionError(f"the K8 decode disagrees with the cuDNN decode: {row}")
    RESULTS["decode_k8"] = row
    return runs["igemm"][-1]["launches"]


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


CKPT_SEED = 77
CKPT_PROMPT = "A paper boat drifting down a rain-filled gutter"
# the VAE encoder's tensors written beside the decoder, at the shapes of the
# full 0.9.8 VAE (latent 128, patch 4, widths 128 .. 2048): conv_in, the
# first down block's four resnets and conv_out; the loader skips them
CKPT_ENCODER = dict(
    [("encoder.conv_in.conv.weight", (128, 48, 3, 3, 3)), ("encoder.conv_in.conv.bias", (128,)),
     ("encoder.conv_out.conv.weight", (129, 2048, 3, 3, 3)),
     ("encoder.conv_out.conv.bias", (129,))]
    + [(f"encoder.down_blocks.0.resnets.{j}.{c}.conv.{leaf}",
        (128, 128, 3, 3, 3) if leaf == "weight" else (128,))
       for j in range(4) for c in ("conv1", "conv2") for leaf in ("weight", "bias")])


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
    """The pipeline's DiT and VAE decoder (and ``CKPT_ENCODER``) as one
    official-layout file, written by the port's writer; returns its size."""
    from candle_video_tpu_torch.models.ltx_video import loader as L
    from candle_video_tpu_torch.models.ltx_video import weight_format as W

    g = torch.Generator(device="cuda").manual_seed(5)
    tensors = {W.officialize_transformer_key(k): v
               for k, v in L.transformer_state_dict(pipe.transformer).items()}
    tensors.update({W.officialize_vae_key(k): v
                    for k, v in L.vae_decoder_state_dict(pipe.vae).items()})
    tensors.update({W.officialize_vae_key(k): (torch.randn(shape, generator=g, device="cuda")
                                               * 0.02).bfloat16()
                    for k, shape in CKPT_ENCODER.items()})
    t0 = time.perf_counter()
    L.save_safetensors(tensors, path)
    n_bytes = os.path.getsize(path)
    return dict(tensors=len(tensors), gib=n_bytes / 2**30, write_s=time.perf_counter() - t0,
                dtypes=sorted({str(t.dtype) for t in tensors.values()}))


def cli_checkpoint_run(card, tier, path, emb_path, out_dir, ref):
    """``cli.main`` on the official file at 512x768x97 with the embeddings
    file: the load timed (seconds, the file's GiB/s, the device peak of the
    DiT load and of the whole load), the launches of the request counted,
    the final latents and the frames against the in-memory ``ref``, the
    quantized payloads against the in-memory quantizer's."""
    import numpy as np

    from candle_video_tpu_torch import cli
    from candle_video_tpu_torch.models.ltx_video import loader as L
    from candle_video_tpu_torch.ops.kernels import _build

    flag = {"bf16": [], "w8": ["--dit-int8"], "w4": ["--dit-int4"]}[tier]
    quant = {"bf16": None, "w8": "w8", "w4": "w4"}[tier]
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
    """A full-size official-layout 2B file (the DiT, VAE decoder and latent
    statistics of ``build_random_pipeline("0.9.8-2b-distilled", seed=0)`` in
    bf16, and some encoder tensors) written by the port's writer, then run
    through ``cli.main`` three ways, bf16, ``--dit-int8`` and ``--dit-int4``,
    each at 512x768x97 with the prompt embeddings of the in-memory int8 T5
    from an embeddings file and the streamed tail in 2 chunks.  Each run's
    latents and frames are held to the in-memory pipeline's request on the
    same weights (quantized by ``quantize_transformer_w8`` / ``_w4`` for the
    tiers): equal, or within the spread of two in-memory runs; its payloads
    to the in-memory quantizer's, bit for bit; its launches to K1 196 and,
    on the tiers, K3 or K4 392 (the DiT's cross-attention k/v at M = 128; no
    T5 runs); the DiT load's device peak to below the bf16 block tree.
    Then a full-width T5 HF directory.  The files are deleted at the end."""
    from candle_video_tpu_torch.models.ltx_video import loader as L
    from candle_video_tpu_torch.models.ltx_video import transformer as TF

    root = os.path.join(OUT_DIR, "checkpoint")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "ltxv-2b-0.9.8-distilled-random.safetensors")
    emb_path = os.path.join(root, "embeddings.safetensors")
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
    info = write_official_2b(pipe, path)
    log(f"[checkpoint] wrote the official-layout 2B file: {info['tensors']} tensors "
        f"({len(CKPT_ENCODER)} of the encoder), {info['gib']:.2f} GiB, {info['dtypes']}, in "
        f"{info['write_s']:.2f} s; the bf16 block tree is {block_tree_gib:.2f} GiB | {card}")
    del dense, emb, mask, pipe  # one pipeline resident at a time
    gc.collect()
    torch.cuda.empty_cache()
    rows = {}
    want = {"bf16": {"flash_attention_packed": 196, "w8_matmul": 0, "w4_matmul": 0},
            "w8": {"flash_attention_packed": 196, "w8_matmul": 392, "w4_matmul": 0},
            "w4": {"flash_attention_packed": 196, "w4_matmul": 392, "w8_matmul": 0}}
    for tier in ("bf16", "w8", "w4"):
        row = cli_checkpoint_run(card, tier, path, emb_path, root, refs[tier])
        if any(row["launches"].get(k, 0) != n for k, n in want[tier].items()):
            raise AssertionError(f"checkpoint cli {tier}: launches {row['launches']}, "
                                 f"want {want[tier]}")
        if tier != "bf16" and not row["dit_peak_gib"] < block_tree_gib:
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
    check_ptxas(card)

    k1 = check_k1(card)
    k2 = check_k2(card)
    k3, k4 = check_k3_k4(card)
    k5 = check_k5(card)
    k7 = check_k7(card)
    k8 = check_k8(card)
    check_small_slice(card)
    check_small_slice(card, quant="w4")
    check_small_slice(card, quant="w8a8")
    launches, launches_k8 = run_e2e(card)
    launches_w8a8 = run_w8a8(card)
    launches_sp = run_sp(card)
    launches_long = run_long(card)
    launches_13b = run_13b_w4(card)
    run_13b_w8(card)
    run_checkpoint(card)
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
    kernels[-1]["kernel_ms"] = k8["kernel_ms"]  # K8 alone, beside its wrapper's ms
    kernels[2]["kernel_ms"] = k3["kernel_ms"]   # K3 and K4 on the device, by profile
    kernels[3]["kernel_ms"] = k4["kernel_ms"]
    kernels[1].update(kernel_ms=k2["kernel_ms"], shift_ms=k2["shift_ms"])  # K2 alone, its shift
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

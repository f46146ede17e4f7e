"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``candle_video_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main paths' shapes,
then drives on random weights, at 512x768x97, checking the outputs and the
kernels' launch counts of every request:

- the ``0.9.8-2b-distilled`` path (T5-XXL int8 → 28-layer 2B DiT, 7 steps
  → VAE decode): a cold and a warm request with per-stage times and one more
  warm request timed end to end only;
- the ``0.9.8-13b-distilled`` W4A16 resident path (Q4_K-form T5-XXL on K4 →
  48-layer 13B DiT with int4 block linears → VAE decode): a cold and a warm
  request;
- the 13B W8A16 tier (int8 T5 → 13B DiT with int8 block linears): one
  request;

and runs the CLI for the 2B and the 13B int4 paths.  Run from the
repository root:

    python3 chip_smoke.py

The last line is ``{"ok": true, "device": {...}}``; any failed phase raises
and the exit code is not 0.  Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import copy
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import torch

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
K3_TOL = dict(rel=2e-4)                 # bf16 output rounding
K4_TOL = dict(rel=2e-4)                 # bf16 output rounding
SLICE_TOL = dict(latent_rel=2e-2, video_psnr=35.0)  # bf16 card run vs f32 plain run
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


def errors(got, want):
    d = got.float() - want.float()
    scaled = d.abs() / want.float().abs().clamp_min(1.0)
    return dict(max_abs=d.abs().max().item(), scaled=scaled.max().item(),
                mse=d.square().mean().item(), rel=(d.norm() / want.float().norm()).item())


def check_k1(card):
    from candle_video_tpu_torch.models.ltx_video.pipeline import build_video_coords
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
             ("K=65 bias padded tile", 2, 200, 65, 8, 64, True, False)]
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
                coords = build_video_coords(13, 16, 24, 25.0)
                grid = torch.from_numpy(coords / [20.0, 2048.0, 2048.0]).float()
            else:
                grid = torch.rand(s, 3, generator=g, device=dev)
            rope = rope_cos_sin(grid.to(dev)[None], h * d)
            k = apply_rotary_emb(k, *rope)  # the path hands K1 a rotated k
        args = dict(num_heads=h, scale=d ** -0.5, bias=bias, rope_q=rope)
        got = K1.flash_attention_packed(q, k, v, **args)
        want = K1.flash_attention_packed_plain(q, k, v, **args)
        torch.cuda.synchronize()
        err = errors(got, want)
        ms = cuda_ms(lambda: K1.flash_attention_packed(q, k, v, **args))
        plain_ms = cuda_ms(lambda: K1.flash_attention_packed_plain(q, k, v, **args), iters=5)
        flops = 4.0 * b * h * s * kv * d
        log(f"[K1] {label}: max_abs={err['max_abs']:.3e} scaled={err['scaled']:.3e} "
            f"mse={err['mse']:.3e} "
            f"rel={err['rel']:.3e} kernel={ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
            f"plain={plain_ms:.3f} ms | {card}")
        if not (err["scaled"] <= K1_TOL["scaled"] and err["rel"] <= K1_TOL["rel"]):
            raise AssertionError(f"K1 {label} disagrees with its plain version: {err}")
        rows.append(dict(label=label, ms=ms, plain_ms=plain_ms, **err))
    RESULTS["k1"] = rows
    return rows[0]


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
            rows.append(dict(k=kk, n=n, qblock=qb, ms=ms, plain_ms=plain_ms, **err))
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
        rows.append(dict(label=label, m=m, k=kk, n=n, scale_dtype=str(sdt), ms=ms,
                         plain_ms=plain_ms, weight_gb_s=gbs, **err))
    RESULTS["k4"] = rows
    return next(r for r in rows if r["label"] == "DiT attn2 k/v")


def check_small_slice(card, quant=None):
    """The tiny slice on the card (kernels, bf16) against the same weights on
    the CPU (plain versions, f32): dense DiT and int8 T5 (K1, K3), or with
    ``quant="w4"`` int4 DiT block linears and the Q4_K-form T5 (K1, K4)."""
    from candle_video_tpu.utils.tokenizer import MockTokenizer
    from candle_video_tpu_torch.models.ltx_video import configs as C
    from candle_video_tpu_torch.models.ltx_video import pipeline as P
    from candle_video_tpu_torch.models.ltx_video import t5 as T5
    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.models.ltx_video import vae as V

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


def run_request(pipe, name, prompt, seed, want, card, staged=True, tag="e2e"):
    """One 512x768x97 ``generate()``: checks the video and that the launch
    counts of this request are exactly ``want``; returns its row."""
    from candle_video_tpu_torch.models.ltx_video.pipeline import generate
    from candle_video_tpu_torch.ops.kernels import _build

    torch.cuda.reset_peak_memory_stats()
    times: dict = {}
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    video = generate(pipe, prompt=prompt, height=512, width=768, num_frames=97,
                     seed=seed, stage_times=times if staged else None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if tuple(video.shape) != (1, 3, 97, 512, 768):
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
                   vae_decode_s=times["vae_decode"])
        stages = (f" t5={row['t5_encode_s'] * 1e3:.1f} ms "
                  f"denoise step mean={row['denoise_step_mean_ms']:.1f} ms "
                  f"(steps {', '.join(f'{x:.1f}' for x in row['denoise_step_ms'])}) "
                  f"vae_decode={row['vae_decode_s']:.3f} s")
    log(f"[{tag}] {name} request: wall={wall:.4f} s{stages} peak={row['peak_gib']:.2f} GiB "
        f"launches={launches} video mean={row['video_mean']:.2f} "
        f"std={row['video_std']:.2f} | {card}")
    return row


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
    runs = [run_request(pipe, name, prompt, 42 + i, want, card, staged)
            for i, (name, prompt, staged) in enumerate(requests)]
    RESULTS["e2e"] = runs
    release(pipe)
    return runs[-1]["launches"]


def run_13b_w4(card):
    """The 13B W4A16 path with the DiT, the Q4_K-form T5 and the VAE decoder
    all resident: K4 carries every T5 linear (24 x 7) and the DiT's
    cross-attention k/v (48 x 2 x 7 steps); block 42 is a permanent skip,
    computed and then masked, so every layer launches K1."""
    pipe, gib = build_pipeline("13b-w4", card, "0.9.8-13b-distilled", dit_quant="w4",
                               t5_quant="w4")
    want = {"w4_matmul": 168 + 672, "flash_attention_packed": 336, "w8_matmul": 0}
    runs = [run_request(pipe, name, prompt, 42 + i, want, card, tag="13b-w4")
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
    row = run_request(pipe, f"L'={layers} (full depth)", "A fox running through tall grass",
                      51, want, card, tag="13b-w8")
    RESULTS["e2e_13b_w8"] = dict(resident_gib=gib, layers=layers, run=row)
    release(pipe)


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
    k3 = check_k3(card)
    k4 = check_k4(card)
    check_small_slice(card)
    check_small_slice(card, quant="w4")
    launches = run_e2e(card)
    launches_13b = run_13b_w4(card)
    run_13b_w8(card)
    run_cli(card)

    kernels = [
        dict(name="flash_attention_packed", route="cuda",
             source="candle_video_tpu_torch/csrc/flash_attention_packed.cu",
             replaces="candle_video_tpu/ops/pallas/flash_attention_packed.py:543",
             launches=launches["flash_attention_packed"], max_abs_err=k1["max_abs"],
             ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="w8_matmul", route="cuda",
             source="candle_video_tpu_torch/csrc/int8_weight_matmul.cu",
             replaces="candle_video_tpu/ops/pallas/int8_weight_matmul.py:82",
             launches=launches["w8_matmul"], max_abs_err=k3["max_abs"],
             ms=k3["ms"], plain_ms=k3["plain_ms"]),
        dict(name="w4_matmul", route="cuda",
             source="candle_video_tpu_torch/csrc/int4_weight_matmul.cu",
             replaces="candle_video_tpu/ops/pallas/int4_weight_matmul.py:205",
             launches=launches_13b["w4_matmul"], max_abs_err=k4["max_abs"],
             ms=k4["ms"], plain_ms=k4["plain_ms"]),
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

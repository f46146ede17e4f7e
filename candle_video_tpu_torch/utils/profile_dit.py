"""Profile one warm 2B DiT forward on the GPU: without and with the
sequence-parallel ring of one, then on the W8A8 tier; or, with ``--paths
weight-only``, the paths of the weight-only kernels K3 and K4.

At the shapes of a 512x768x97 request (S = 4992 video tokens, 128 caption
tokens) on random weights from a seed: the forward's time by CUDA events,
the device time by kernel name under ``torch.profiler``, the kernels' busy
time, the idle share and the device time by kind (K1, K5, K7, K3, cuBLAS's
matmuls, the rest: the glue).  The ring runs in a one-rank NCCL group met
through a FileStore in a temporary directory, so every self-attention goes
through K5 instead of K1.  The W8A8 row quantizes the same weights in
place (``quantize_transformer_w8a8``), so every block linear runs on K7
after the per-token activation quantizer.

The weight-only paths, at the same request's shapes: the T5-XXL prompt
encode, int8 (every linear on K3) and Q4_K-form (every linear on K4), each
timed by the host clock around an encode that ends in a synchronize (it is
set by the host's dispatch); one 13B DiT forward on the W4 and the W8 tier
by CUDA events (the 48 layers' cross-attention k/v over 128 caption tokens
on K4 or K3, 96 calls; the block linears at 4992 tokens on the transient
dequant and cuBLAS).  Every idle share is one less the kernels' busy time
under the profiler over the unprofiled median.  Needs one CUDA device:

    python -m candle_video_tpu_torch.utils.profile_dit [--paths 2b|weight-only] [--json FILE]

The port is imported by its package name, so a run of this file by its
path profiles another checkout's package: ``PYTHONPATH=<checkout> python
candle_video_tpu_torch/utils/profile_dit.py --paths weight-only``.  Kinds
are read from this version's kernel names.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import tempfile
import time

import torch


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
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


# kernel-name patterns -> kind, first match wins.  K1, K2, K5 and K6 are one
# kernel, flash_attention_hopper_kernel<D, consumers, stages, mode>, told
# apart by its mode (0 online, 1 fixed, 2 ring, 3 unrotated); K7 is the
# W8A8 GEMM and its split-K pass; K3 and K4 are weight_only_matmul_kernel
# <format, blocks>, W8 or W4<scale type>; cuBLAS's are the "matmul" kind.
KINDS = (("K1", r"flash_attention_hopper_kernel<\d+,\s*\d+,\s*\d+,\s*0>"),
         ("K2", r"flash_attention_hopper_kernel<\d+,\s*\d+,\s*\d+,\s*1>"),
         ("K5", r"flash_attention_hopper_kernel<\d+,\s*\d+,\s*\d+,\s*2>"),
         ("K7", r"w8a8_matmul"), ("K3", r"weight_only_matmul_kernel<[^,]*W8,"),
         ("K4", r"weight_only_matmul_kernel<[^,]*W4<"),
         ("matmul", r"gemm|nvjet|cutlass"))


def kind_of(name: str, kinds=KINDS) -> str:
    return next((k for k, pat in kinds if re.search(pat, name, re.IGNORECASE)), "other")


def kinds_ms(kernels: dict, kinds=KINDS) -> dict:
    """Device milliseconds by kind from ``kernel_ms``' rows."""
    out: dict = {}
    for name, t in kernels.items():
        out[kind_of(name, kinds)] = out.get(kind_of(name, kinds), 0.0) + t
    return out


def kernel_ms(prof) -> dict:
    """Device milliseconds by kernel name from a finished profile."""
    out: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def host_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs by the host clock,
    each ending in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def traced_row(fn, ms: float, timed_by: str, top: int = 12) -> dict:
    """One run of ``fn`` under ``torch.profiler`` beside its unprofiled
    median ``ms``: the kernels' busy time, the idle share against ``ms``,
    the device time by kind and the ``top`` kernels, and the kernel
    launches that run counted."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from candle_video_tpu_torch.ops.kernels import _build

    _build.reset_launches()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    kernels = kernel_ms(prof)
    busy = sum(kernels.values())
    return dict(ms=ms, timed_by=timed_by, kernels_busy_ms=busy, idle_share=1 - busy / ms,
                kinds_ms=kinds_ms(kernels), launches=launches,
                top_kernels_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:top])


def dit_inputs(cfg, g):
    """x, the caption states, t, the RoPE tables and the caption mask of a
    512x768x97 request: 4992 video tokens, 128 caption tokens."""
    from candle_video_tpu_torch.models.ltx_video.pipeline import build_video_coords
    from candle_video_tpu_torch.ops.rope import rope_cos_sin

    x = torch.randn(1, 4992, cfg.in_channels, generator=g, device="cuda")
    enc = torch.randn(1, 128, cfg.caption_channels, generator=g, device="cuda")
    t = torch.full((1,), 900.0, device="cuda")
    coords = build_video_coords(13, 16, 24, 25.0)
    grid = torch.from_numpy(coords / [20.0, 2048.0, 2048.0]).float().cuda()
    cos, sin = rope_cos_sin(grid[None], cfg.num_attention_heads * cfg.attention_head_dim)
    return x, enc, t, cos, sin, torch.ones(1, 128, device="cuda")


def profile(top: int = 12) -> dict:
    import torch.distributed as dist

    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.models.ltx_video.configs import get_config_by_version

    cfg = get_config_by_version("0.9.8-2b-distilled").transformer
    g = torch.Generator(device="cuda").manual_seed(8)
    model = TF.init_random(cfg, "cuda", torch.bfloat16, generator=g)
    x, enc, t, cos, sin, mask = dit_inputs(cfg, g)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            for label, ring in (("no mesh", None), ("sp=1 ring", dist.group.WORLD),
                                ("W8A8 tier", None)):
                if label == "W8A8 tier":
                    TF.quantize_transformer_w8a8(model)

                def fwd():
                    return model(x, enc, t, cos, sin, encoder_attention_mask=mask, ring=ring)
                rows[f"2B DiT forward 512x768x97 {label}"] = traced_row(
                    fwd, cuda_ms(fwd), "CUDA events", top)
        finally:
            dist.destroy_process_group()
    return rows


def profile_weight_only(iters: int = 10, top: int = 12) -> dict:
    """The int8 and the Q4_K-form T5 encode of one 128-token prompt, then
    one 13B DiT forward on the W4 and the W8 tier."""
    from candle_video_tpu_torch.models.ltx_video import t5 as T5
    from candle_video_tpu_torch.models.ltx_video import transformer as TF
    from candle_video_tpu_torch.models.ltx_video.configs import get_config_by_version, t5_xxl

    rows = {}
    with torch.no_grad():
        cfg = t5_xxl()
        for quant, init in (("int8", T5.init_random_int8), ("Q4_K form", T5.init_random_w4)):
            enc = init(cfg, torch.device("cuda"), torch.bfloat16)
            g = torch.Generator(device="cuda").manual_seed(0)
            ids = torch.randint(0, cfg.vocab_size, (1, 128), generator=g, device="cuda")
            mask = torch.ones(1, 128, device="cuda")

            def encode():
                return enc(ids, attention_mask=mask)
            rows[f"T5-XXL {quant} encode, 128 tokens"] = traced_row(
                encode, host_ms(encode, iters), "host clock", top)
            del enc
            torch.cuda.empty_cache()
        cfg = get_config_by_version("0.9.8-13b-distilled").transformer
        for tier, init in (("W4", TF.init_random_w4), ("W8", TF.init_random_w8)):
            g = torch.Generator(device="cuda").manual_seed(8)
            model = init(cfg, "cuda", torch.bfloat16, generator=g)
            x, enc, t, cos, sin, mask = dit_inputs(cfg, g)

            def fwd():
                return model(x, enc, t, cos, sin, encoder_attention_mask=mask)
            rows[f"13B DiT forward 512x768x97 on the {tier} tier"] = traced_row(
                fwd, cuda_ms(fwd, iters=max(3, iters // 3)), "CUDA events", top)
            del model
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--paths", choices=("2b", "weight-only"), default="2b")
    p.add_argument("--json", help="also write the rows to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_dit: needs a CUDA device", file=sys.stderr)
        return 2
    rows = profile() if args.paths == "2b" else profile_weight_only()
    for label, row in rows.items():
        kinds = ", ".join(f"{k} {v:.2f}" for k, v in sorted(row["kinds_ms"].items(),
                                                             key=lambda kv: -kv[1]))
        print(f"{label}: {row['ms']:.2f} ms by {row['timed_by']}, kernels busy "
              f"{row['kernels_busy_ms']:.2f} ms ({row['idle_share']:.1%} idle); "
              f"by kind (ms): {kinds}; launches {row['launches']}")
        for name, ms in row["top_kernels_ms"]:
            print(f"  {ms:8.3f} ms  {name[:110]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

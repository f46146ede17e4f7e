"""Profile one warm 2B DiT forward on the GPU, without and with the
sequence-parallel ring of one.

At the shapes of a 512x768x97 request (S = 4992 video tokens, 128 caption
tokens) on random weights from a seed: the forward's time by CUDA events,
the device time by kernel name under ``torch.profiler``, the kernels' busy
time and the idle share.  The ring runs in a one-rank NCCL group met
through a FileStore in a temporary directory, so every self-attention goes
through K5 instead of K1.  Needs one CUDA device:

    python -m candle_video_tpu_torch.utils.profile_dit [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

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


def kernel_ms(prof) -> dict:
    """Device milliseconds by kernel name from a finished profile."""
    out: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def profile(top: int = 12) -> dict:
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from ..models.ltx_video import transformer as TF
    from ..models.ltx_video.configs import get_config_by_version
    from ..models.ltx_video.pipeline import build_video_coords
    from ..ops.rope import rope_cos_sin

    cfg = get_config_by_version("0.9.8-2b-distilled").transformer
    g = torch.Generator(device="cuda").manual_seed(8)
    model = TF.init_random(cfg, "cuda", torch.bfloat16, generator=g)
    x = torch.randn(1, 4992, cfg.in_channels, generator=g, device="cuda")
    enc = torch.randn(1, 128, cfg.caption_channels, generator=g, device="cuda")
    t = torch.full((1,), 900.0, device="cuda")
    coords = build_video_coords(13, 16, 24, 25.0)
    grid = torch.from_numpy(coords / [20.0, 2048.0, 2048.0]).float().cuda()
    cos, sin = rope_cos_sin(grid[None], cfg.num_attention_heads * cfg.attention_head_dim)
    mask = torch.ones(1, 128, device="cuda")
    rows = {}
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            for label, ring in (("no mesh", None), ("sp=1 ring", dist.group.WORLD)):
                def fwd():
                    return model(x, enc, t, cos, sin, encoder_attention_mask=mask, ring=ring)
                fwd_ms = cuda_ms(fwd)
                with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fwd()
                    torch.cuda.synchronize()
                kernels = kernel_ms(prof)
                busy = sum(kernels.values())
                rows[label] = dict(forward_ms=fwd_ms, kernels_busy_ms=busy,
                                   idle_share=1 - busy / fwd_ms,
                                   top_kernels_ms=sorted(kernels.items(),
                                                         key=lambda kv: -kv[1])[:top])
        finally:
            dist.destroy_process_group()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", help="also write the rows to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_dit: needs a CUDA device", file=sys.stderr)
        return 2
    rows = profile()
    for label, row in rows.items():
        print(f"2B DiT forward 512x768x97 {label}: {row['forward_ms']:.2f} ms by CUDA events, "
              f"kernels busy {row['kernels_busy_ms']:.2f} ms ({row['idle_share']:.1%} idle)")
        for name, ms in row["top_kernels_ms"]:
            print(f"  {ms:8.3f} ms  {name[:110]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

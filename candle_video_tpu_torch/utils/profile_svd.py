"""Profile one warm SVD UNet forward and one temporal VAE decode on the GPU.

At the shapes of SVD's published request (576x1024, 14 frames, CFG: the
UNet at batch 28 on 72x128 latents) on random bf16 weights from a seed: the
time by CUDA events, the device time by kernel name under
``torch.profiler``, the kernels' busy time, the idle share and the device
time by kind (K6, K1, matmuls, convolutions, the rest).  Needs one CUDA
device:

    python -m candle_video_tpu_torch.utils.profile_svd [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .profile_dit import cuda_ms, kernel_ms

# kernel-name fragments -> kind, first match wins; K1 and K6 are the
# template instances of csrc/flash_attention_packed.cu (the last flag is
# ROPE); cuDNN's convolutions are implicit GEMMs named "fprop"
KINDS = (("K6", "flash_attention_packed_kernel<64, false, false, false>"),
         ("K1", "flash_attention_packed_kernel<64, false, false, true>"),
         ("conv", "fprop"), ("conv", "conv"), ("conv", "cudnn"),
         ("matmul", "gemm"), ("matmul", "nvjet"), ("matmul", "cutlass"))


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, frag in KINDS if frag.lower() in low), "other")


def _profile(fn, top: int) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    ms = cuda_ms(fn, iters=3, warmup=1)
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = kernel_ms(prof)
    busy = sum(kernels.values())
    kinds: dict = {}
    for name, t in kernels.items():
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + t
    return dict(ms=ms, kernels_busy_ms=busy, idle_share=1 - busy / ms, kinds_ms=kinds,
                top_kernels_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:top])


def profile(top: int = 12) -> dict:
    from ..models.svd import unet as U
    from ..models.svd import vae as V
    from ..models.svd.configs import SvdConfig

    cfg = SvdConfig()
    g = torch.Generator(device="cuda").manual_seed(9)
    unet = U.init_random(cfg.unet, "cuda", torch.bfloat16, g)
    vae = V.init_random(cfg.vae, "cuda", torch.bfloat16, g)
    x = torch.randn(28, 8, 72, 128, generator=g, device="cuda")
    emb = torch.randn(28, 1, cfg.unet.cross_attention_dim, generator=g, device="cuda")
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device="cuda")
    t = torch.tensor([0.25 * 2.68], device="cuda")
    z = torch.randn(14, 4, 72, 128, generator=g, device="cuda")
    with torch.no_grad():
        return {"unet forward": _profile(lambda: unet(x, t, emb, ids, 14), top),
                "vae decode": _profile(lambda: V.decode(vae, z, 14), top)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", help="also write the rows to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_svd: needs a CUDA device", file=sys.stderr)
        return 2
    rows = profile()
    for label, row in rows.items():
        kinds = ", ".join(f"{k} {v:.1f}" for k, v in sorted(row["kinds_ms"].items(),
                                                             key=lambda kv: -kv[1]))
        print(f"SVD {label}, 576x1024x14: {row['ms']:.2f} ms by CUDA events, kernels "
              f"busy {row['kernels_busy_ms']:.2f} ms ({row['idle_share']:.1%} idle); by kind "
              f"(ms): {kinds}")
        for name, ms in row["top_kernels_ms"]:
            print(f"  {ms:8.3f} ms  {name[:110]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

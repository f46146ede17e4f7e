"""LTX-Video text-to-video CLI of the PyTorch port, random-init smoke mode.

Builds a preset's full-width modules with random weights from ``--seed``
(DiT and VAE in ``--dtype``, or the DiT's block linears as weight-only int8
or int4 with ``--dit-int8`` / ``--dit-int4``; T5-XXL with int8 weights
resident, or loaded from ``--t5-gguf``) on ``--device`` and runs one
generation.  Loading DiT and VAE checkpoints is not ported yet.

Run: python -m candle_video_tpu_torch.cli --height 256 --width 384 \
         --num-frames 25 --output-type latent
     python -m candle_video_tpu_torch.cli --version 0.9.8-13b-distilled \
         --dit-int4 --height 256 --width 384 --num-frames 25 --output-type latent

Sequence-parallel ring attention over N GPUs of one host, one process each:
     torchrun --nproc_per_node=N -m candle_video_tpu_torch.cli --mesh sp=N
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from .models.ltx_video import t5 as T5
from .models.ltx_video import transformer as TF
from .models.ltx_video import vae as V
from .models.ltx_video.configs import get_config_by_version, t5_xxl
from .models.ltx_video.pipeline import LtxPipeline, generate
from .parallel import make_mesh
from .utils.tokenizer import MockTokenizer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="candle-video-tpu-torch",
        description="LTX-Video text-to-video on an NVIDIA GPU (PyTorch + CUDA kernels)")
    p.add_argument("--prompt", type=str, default="A cat walking on grass")
    p.add_argument("--negative-prompt", type=str,
                   default="worst quality, inconsistent motion, blurry, jittery, distorted")
    p.add_argument("--version", type=str, default="0.9.8-2b-distilled",
                   help="preset: 0.9.5 | 0.9.6-dev | 0.9.6-distilled | "
                        "0.9.8-2b-distilled | 0.9.8-13b-dev | 0.9.8-13b-distilled")
    p.add_argument("--t5-gguf", type=str, default=None,
                   help="GGUF file for the quantized T5-XXL encoder")
    p.add_argument("--t5-keep-quantized", action="store_true",
                   help="keep the GGUF T5 weights quantized on the card (Q4_K as packed "
                        "nibbles on K4, the other types as int8 on K3); default "
                        "dequantizes them once into --dtype")
    p.add_argument("--dit-int8", action="store_true",
                   help="DiT block linears as weight-only int8 (W8A16, groups of 128 "
                        "along K)")
    p.add_argument("--dit-int4", action="store_true",
                   help="DiT block linears as weight-only int4 (W4A16, GGUF-Q4_K-form "
                        "affine groups of 32, bf16 scale and min)")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--num-frames", type=int, default=97)
    p.add_argument("--num-inference-steps", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-type", type=str, default="tensor", choices=["tensor", "latent"])
    p.add_argument("--output-dir", type=str, default="output")
    p.add_argument("--gif", action="store_true", help="also write video.gif (needs imageio)")
    p.add_argument("--mp4", action="store_true", help="also write video.mp4 (needs imageio)")
    p.add_argument("--vae-stream-chunks", type=int, default=0,
                   help="decode with the exact streamed tail in N temporal chunks "
                        "(overlap-save conv caches, zero recompute); default: the mode "
                        "select_decode_mode picks from the free card memory")
    p.add_argument("--progress", action="store_true", help="print a line per denoise step")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"],
                   help="model dtype; the CUDA kernels take bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    p.add_argument("--mesh", type=str, default=None,
                   help="'sp=N': sequence-parallel ring attention (video tokens shard "
                        "over N ranks, K/V rotate around the ring), one process per GPU "
                        "under torchrun (NCCL; gloo with --device cpu); 'sp=1' alone is an "
                        "ordinary request. dp=M shards the batch, which needs M videos "
                        "(generate(sp_mesh=make_mesh(dp=M, sp=N))); tp and pp are not "
                        "yet ported")
    return p


_MESH_AXES = ("dp", "sp", "tp", "pp")


def parse_mesh(spec: str) -> dict:
    """'sp=4,dp=2' -> {"dp": 2, "sp": 4, "tp": 1, "pp": 1}; tp > 1 and pp > 1
    are refused (not yet ported)."""
    mesh = dict.fromkeys(_MESH_AXES, 1)
    for item in spec.split(","):
        key, sep, val = item.partition("=")
        if key.strip() not in mesh or not sep or not val.strip().isdigit() or int(val) < 1:
            raise SystemExit(f"--mesh {spec!r}: expected comma-separated axis=N with axes "
                             f"{', '.join(_MESH_AXES)} and N >= 1")
        mesh[key.strip()] = int(val)
    for axis, item in (("tp", "TP, mesh.py shard_transformer_params"),
                       ("pp", "PP, parallel/pipeline.py denoise_loop_pp")):
        if mesh[axis] > 1:
            raise SystemExit(f"--mesh {axis}={mesh[axis]}: {axis} > 1 is not yet ported "
                             f"(ROADMAP item 13: {item})")
    return mesh


def init_distributed(mesh: dict, device_name: str):
    """Join the torchrun process group (RANK, WORLD_SIZE, LOCAL_RANK and the
    rendezvous address from the environment), NCCL on the GPU of
    LOCAL_RANK or gloo on the CPU; returns the (dp, sp) mesh."""
    need = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    if any(k not in os.environ for k in need):
        n = mesh["dp"] * mesh["sp"]
        raise SystemExit(f"--mesh with dp x sp = {n} ranks runs one process per GPU: "
                         f"torchrun --nproc_per_node={n} -m candle_video_tpu_torch.cli "
                         "--mesh ...")
    device = resolve_device(device_name)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return make_mesh(dp=mesh["dp"], sp=mesh["sp"], device=device)


_DIT_INITS = {None: TF.init_random, "w8": TF.init_random_w8, "w4": TF.init_random_w4}
_T5_INITS = {"int8": T5.init_random_int8, "w4": T5.init_random_w4}


def build_random_pipeline(version: str, device, dtype=torch.bfloat16, seed: int = 0,
                          max_sequence_length: int = 128, dit_quant: str | None = None,
                          t5_quant: str = "int8", t5_gguf: str | None = None,
                          t5_keep_quantized: bool = False) -> LtxPipeline:
    """A preset's full-width pipeline with random weights made on ``device``
    from ``seed``: VAE decoder in ``dtype``; DiT in ``dtype``, or with its
    block linears as weight-only int8 (``dit_quant="w8"``) or int4 (``"w4"``);
    T5-XXL resident with int8 (``t5_quant="int8"``) or Q4_K-form 4-bit
    (``"w4"``) weights, or loaded from the GGUF file ``t5_gguf``."""
    if dit_quant not in _DIT_INITS or t5_quant not in _T5_INITS:
        raise ValueError(f"dit_quant {dit_quant!r} not in {sorted(map(str, _DIT_INITS))} "
                         f"or t5_quant {t5_quant!r} not in {sorted(_T5_INITS)}")
    cfg = get_config_by_version(version)
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    transformer = _DIT_INITS[dit_quant](cfg.transformer, device, dtype, generator=g)
    vae = V.init_random(cfg.vae, device, dtype, generator=g)
    t5_cfg = t5_xxl()
    if t5_gguf:
        t5 = T5.t5_from_gguf(t5_gguf, t5_cfg, device, dtype, keep_quantized=t5_keep_quantized)
    else:
        t5 = _T5_INITS[t5_quant](t5_cfg, device, dtype)
    return LtxPipeline(config=cfg, transformer=transformer, vae=vae, t5=t5,
                       t5_config=t5_cfg,
                       tokenizer=MockTokenizer(model_max_length=max_sequence_length))


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this run needs an NVIDIA GPU "
                         "(pass --device cpu to run on the CPU on purpose)")
    return device


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.dit_int8 and args.dit_int4:
        raise SystemExit("--dit-int8 and --dit-int4 are mutually exclusive")
    dit_quant = "w8" if args.dit_int8 else ("w4" if args.dit_int4 else None)
    mesh = parse_mesh(args.mesh) if args.mesh else None
    if mesh is not None and dit_quant:
        flag = "--dit-int4" if args.dit_int4 else "--dit-int8"
        raise SystemExit(f"{flag} is a single-GPU capacity path and does not compose with "
                         f"--mesh: drop {flag} for multi-GPU runs")
    if mesh is not None and mesh["dp"] > 1:
        raise SystemExit(f"--mesh dp={mesh['dp']} shards the batch, and the CLI generates "
                         "one video: use dp=1")
    if mesh is not None and mesh["sp"] > 1:
        if args.progress:
            raise SystemExit("--progress is a step callback, which the sequence-parallel "
                             "loop does not take: drop it with --mesh sp=N")
        sp_mesh = init_distributed(mesh, args.device)
        try:
            return _run(args, dit_quant, sp_mesh.device, sp_mesh)
        finally:
            dist.destroy_process_group()
    return _run(args, dit_quant, resolve_device(args.device))


def _run(args, dit_quant, device, sp_mesh=None) -> int:
    lead = sp_mesh is None or dist.get_rank() == 0  # the rank that prints and saves
    say = print if lead else (lambda *a, **k: None)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    say(f"candle-video-tpu-torch | preset {args.version} | device {device}"
        + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
        + (f" | DiT weight-only {dit_quant}" if dit_quant else "")
        + (f" | mesh dp={sp_mesh.dp} sp={sp_mesh.sp} (ring attention)" if sp_mesh else ""))
    say("random-init DiT and VAE (smoke mode): their checkpoint loading is not ported yet"
        + (f"; T5 from {args.t5_gguf}" if args.t5_gguf else ""))
    t0 = time.perf_counter()
    pipe = build_random_pipeline(args.version, device, dtype, seed=args.seed,
                                 dit_quant=dit_quant, t5_gguf=args.t5_gguf,
                                 t5_keep_quantized=args.t5_keep_quantized)
    say(f"built pipeline in {time.perf_counter() - t0:.2f}s")

    step_callback = None
    if args.progress:
        def step_callback(i, n, lat):
            print(f"Step {i + 1}/{n}", flush=True)

    t0 = time.perf_counter()
    out = generate(pipe, prompt=args.prompt, negative_prompt=args.negative_prompt,
                   height=args.height, width=args.width, num_frames=args.num_frames,
                   num_inference_steps=args.num_inference_steps,
                   guidance_scale=args.guidance_scale, seed=args.seed,
                   output_type=args.output_type, step_callback=step_callback,
                   vae_tail_stream_chunks=args.vae_stream_chunks, sp_mesh=sp_mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    say(f"generation took {time.perf_counter() - t0:.2f}s, output {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise SystemExit("generation produced non-finite values")
    if not lead:
        return 0

    os.makedirs(args.output_dir, exist_ok=True)
    if args.output_type == "latent":
        path = os.path.join(args.output_dir, "latents.pt")
        torch.save(out.cpu(), path)
        print(f"saved latents: {path}")
        return 0
    from .utils import video_io

    video = out.cpu().numpy()
    path = os.path.join(args.output_dir, "video_uint8.npy")
    import numpy as np

    np.save(path, video_io.to_uint8_frames(video))
    print(f"saved frames [F,H,W,C] uint8: {path}")
    if args.gif:
        print(f"saved GIF: {video_io.save_gif(video, os.path.join(args.output_dir, 'video.gif'))}")
    if args.mp4:
        print(f"saved video: {video_io.save_mp4(video, os.path.join(args.output_dir, 'video.mp4'))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""SVD image-to-video CLI (``candle_video_tpu/cli_svd.py``, the same flags
plus ``--device``).

    python -m candle_video_tpu_torch.cli_svd --weights-path DIR [--image in.png]

``DIR`` is a diffusers SVD checkpoint (``unet/``, ``vae/``,
``image_encoder/``, safetensors).  As in the JAX CLI there is no
random-weight mode: without ``--weights-path`` it exits with 2.  The frames
always go to ``video_uint8.npy`` (as the port's t2v CLI writes them; no
imaging package needed); ``--gif`` (imageio) and ``--save-frames`` (PIL)
write the GIF and the PNGs too.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="candle-video-tpu-torch-svd",
        description="Stable Video Diffusion image-to-video on PyTorch (NVIDIA GPU)")
    p.add_argument("--image", type=str, required=False, default=None,
                   help="input image (png/jpg); omit for a random input image")
    p.add_argument("--weights-path", type=str, default=None,
                   help="diffusers SVD model dir (unet/ vae/ image_encoder/)")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--num-frames", type=int, default=14)
    p.add_argument("--num-inference-steps", type=int, default=25)
    p.add_argument("--fps", type=int, default=7)
    p.add_argument("--motion-bucket-id", type=int, default=127)
    p.add_argument("--noise-aug-strength", type=float, default=0.02)
    p.add_argument("--min-guidance-scale", type=float, default=1.0)
    p.add_argument("--max-guidance-scale", type=float, default=3.0)
    p.add_argument("--decode-chunk-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-dir", type=str, default="output_svd")
    p.add_argument("--gif", action="store_true", help="also write video.gif (needs imageio)")
    p.add_argument("--save-frames", action="store_true", help="also write PNGs (needs PIL)")
    p.add_argument("--dtype", type=str, default=None, choices=["bfloat16", "float32"],
                   help="model dtype (default bfloat16 on cuda, where the kernels take "
                        "it; float32 elsewhere, as the JAX CLI)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.weights_path:
        print("ERROR: SVD has no random-init smoke mode at full size; pass "
              "--weights-path with a diffusers SVD checkpoint dir")
        return 2

    import numpy as np
    import torch

    from .cli import resolve_device
    from .models.ltx_video.loader import load_sharded
    from .models.svd import clip as CLIP
    from .models.svd import pipeline as SP
    from .models.svd import vae as SV
    from .models.svd.configs import SvdConfig
    from .models.svd.loader import unet_params_from_state_dict
    from .utils import video_io

    device = resolve_device(args.device)
    dtype_name = args.dtype or ("bfloat16" if device.type == "cuda" else "float32")
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    cfg = SvdConfig()
    print(f"candle-video-tpu-torch SVD | device: {device} | dtype: {dtype_name}")

    def part(name):
        return load_sharded(os.path.join(args.weights_path, name))

    with torch.no_grad():
        pipe = SP.SvdPipeline(
            config=cfg,
            unet=unet_params_from_state_dict(part("unet"), cfg.unet, device, dtype),
            vae=SV.vae_params_from_state_dict(part("vae"), cfg.vae, device, dtype),
            clip=CLIP.params_from_hf_state_dict(part("image_encoder"), cfg.clip, device, dtype))

    if args.image:
        image = video_io.load_image(args.image, args.height, args.width)
    else:
        image = np.random.default_rng(args.seed).uniform(
            -1, 1, size=(1, 3, args.height, args.width))
    image = torch.from_numpy(np.asarray(image, np.float32))

    inf = SP.SvdInferenceConfig(
        num_frames=args.num_frames, num_inference_steps=args.num_inference_steps,
        fps=args.fps, motion_bucket_id=args.motion_bucket_id,
        noise_aug_strength=args.noise_aug_strength,
        min_guidance_scale=args.min_guidance_scale,
        max_guidance_scale=args.max_guidance_scale,
        decode_chunk_size=args.decode_chunk_size, seed=args.seed)

    t0 = time.time()
    video = SP.generate(pipe, image, inf).float().cpu()
    print(f"generation took {time.time() - t0:.1f}s; frames {tuple(video.shape)}")

    os.makedirs(args.output_dir, exist_ok=True)
    # [B·F, 3, H, W] in [-1, 1] -> [1, 3, F, H, W] in [0, 255]
    v = ((video.clamp(-1, 1) + 1.0) / 2.0 * 255.0).transpose(0, 1)[None].numpy()
    path = os.path.join(args.output_dir, "video_uint8.npy")
    np.save(path, video_io.to_uint8_frames(v))
    print(f"saved frames [F,H,W,C] uint8: {path}")
    if args.save_frames:
        paths = video_io.save_frames_png(v, args.output_dir)
        print(f"saved {len(paths)} frames")
    if args.gif:
        path = video_io.save_gif(v, os.path.join(args.output_dir, "video.gif"), fps=args.fps)
        print(f"saved {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Frame/GIF/MP4 export — the port's own copy of
``candle_video_tpu/utils/video_io.py``, via PIL/imageio."""

from __future__ import annotations

import os

import numpy as np


def to_uint8_frames(video) -> np.ndarray:
    """[B,C,F,H,W] float [0,255] -> [F,H,W,C] uint8 (first batch element)."""
    v = np.asarray(video)
    if v.ndim == 5:
        v = v[0]
    frames = np.clip(v, 0, 255).astype(np.uint8)
    return frames.transpose(1, 2, 3, 0)


def save_frames_png(video, out_dir: str, prefix: str = "frame"):
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    frames = to_uint8_frames(video)
    paths = []
    for i, frame in enumerate(frames):
        path = os.path.join(out_dir, f"{prefix}_{i:04d}.png")
        Image.fromarray(frame).save(path)
        paths.append(path)
    return paths


def save_gif(video, path: str, fps: float = 25.0):
    import imageio.v3 as iio

    frames = to_uint8_frames(video)
    iio.imwrite(path, frames, duration=1000.0 / fps, loop=0)
    return path


def save_mp4(video, path: str, fps: float = 25.0):
    import imageio.v3 as iio

    frames = to_uint8_frames(video)
    try:
        iio.imwrite(path, frames, fps=fps)
    except Exception:
        # fall back to GIF when no ffmpeg backend is available
        alt = os.path.splitext(path)[0] + ".gif"
        return save_gif(video, alt, fps)
    return path


def load_image(path: str, height: int | None = None, width: int | None = None):
    """Load an image to [1, 3, H, W] float32 in [-1, 1] (the SVD pipeline's
    input convention; reference src/models/svd/pipeline.rs load_image)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if height and width:
        img = img.resize((width, height), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    arr = arr.transpose(2, 0, 1)[None]
    return arr * 2.0 - 1.0

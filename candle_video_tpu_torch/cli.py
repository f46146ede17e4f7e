"""LTX-Video text- and image-to-video CLI of the PyTorch port
(``candle_video_tpu/cli.py``).

With ``--weights-path`` the DiT and the VAE come from a checkpoint:
an official single ``.safetensors`` file (split by ``weight_format``) or a
diffusers directory (``transformer/``, ``vae/``).  The DiT loads in
``--dtype``, or with ``--dit-int8`` / ``--dit-int4`` its block linears are
quantized on the host straight off the file, layer by layer.  The T5-XXL
comes from ``--t5-gguf`` or ``--t5-dir`` (a HuggingFace ``text_encoder/``);
with neither, prompts map to random embeddings (a warning says so) unless
``--embeddings-file`` gives them.  Without ``--weights-path`` every module
is random from ``--seed`` (smoke mode: the DiT in ``--dtype`` or int8 /
int4, the T5-XXL with int8 weights resident or from ``--t5-gguf``).
``--image path[:frame[:strength]]`` (repeatable) conditions the video on
images, which the VAE encoder encodes: the checkpoint must hold the
encoder's tensors.  ``--vae-tiling`` and ``--vae-slicing`` tile and slice
the decode.  ``--serve`` runs the serving loop (``serving.py``): one prompt a
stdin line, one video file a request.

Run: python -m candle_video_tpu_torch.cli --weights-path ltxv-2b-0.9.8-distilled.safetensors \
         --t5-dir text_encoder --tokenizer tokenizer.json --dit-int8
     python -m candle_video_tpu_torch.cli --height 256 --width 384 \
         --num-frames 25 --output-type latent          # random weights
     python -m candle_video_tpu_torch.cli --version 0.9.8-13b-distilled \
         --dit-int4 --height 256 --width 384 --num-frames 25 --output-type latent
     python -m candle_video_tpu_torch.cli --image first.png --image last.png:12:0.9
     python -m candle_video_tpu_torch.cli --serve --serve-max-batch 2 < prompts.txt

Sequence-parallel ring attention, tensor parallelism (each GPU holds 1/N of
the DiT's heads and FF lanes) or the pipelined block stack (GPipe, or
interleaved with K virtual stages a GPU) over N GPUs of one host, one
process each:
     torchrun --nproc_per_node=N -m candle_video_tpu_torch.cli --mesh sp=N
     torchrun --nproc_per_node=N -m candle_video_tpu_torch.cli --mesh tp=N
     torchrun --nproc_per_node=N -m candle_video_tpu_torch.cli --mesh pp=N[,interleave=K]
"""

from __future__ import annotations

import argparse
import os
import queue
import signal
import sys
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from .models.ltx_video import loader as L
from .models.ltx_video import t5 as T5
from .models.ltx_video import transformer as TF
from .models.ltx_video import vae as V
from .models.ltx_video.configs import get_config_by_version, t5_xxl
from .models.ltx_video.pipeline import ATTN_IMPLS, LtxPipeline, generate
from .models.ltx_video.weight_format import detect_format, split_unified_state_dict
from .models.registry import build_pipeline
from .parallel import PipelineMesh, make_mesh, make_pipeline_mesh, shard_transformer
from .utils.tokenizer import MockTokenizer, make_tokenizer


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
    p.add_argument("--weights-path", type=str, default=None,
                   help="an official single .safetensors file, or a diffusers directory "
                        "with transformer/ and vae/; without it every module is random "
                        "(smoke mode)")
    p.add_argument("--t5-gguf", type=str, default=None,
                   help="GGUF file for the quantized T5-XXL encoder")
    p.add_argument("--t5-dir", type=str, default=None,
                   help="HuggingFace T5 text_encoder directory (safetensors), loaded dense "
                        "in --dtype")
    p.add_argument("--tokenizer", type=str, default=None,
                   help="tokenizer.json of the T5 (needs the tokenizers package); default: "
                        "a hash tokenizer")
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
    p.add_argument("--frame-rate", type=float, default=25.0)
    p.add_argument("--num-inference-steps", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--guidance-rescale", type=float, default=None)
    p.add_argument("--stg-scale", type=float, default=None)
    p.add_argument("--skip-block-list", type=int, nargs="*", default=None)
    p.add_argument("--num-videos-per-prompt", type=int, default=1)
    p.add_argument("--max-sequence-length", type=int, default=128)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--pcg-rng", action=argparse.BooleanOptionalAction, default=True,
                   help="initial latents from the deterministic PCG32 RNG (the default, "
                        "as the JAX CLI); --no-pcg-rng draws them as "
                        "jax.random.normal(PRNGKey(seed))")
    p.add_argument("--output-type", type=str, default="tensor", choices=["tensor", "latent"])
    p.add_argument("--output-dir", type=str, default="output")
    p.add_argument("--serve", action="store_true",
                   help="serving loop: warm the --height/--width/--num-frames/steps bucket "
                        "once, then read one prompt a stdin line and write "
                        "output-dir/serve_NNN.mp4 a request (GIF without ffmpeg); EOF or "
                        "'quit' ends (serving.VideoGenerationServer)")
    p.add_argument("--serve-max-batch", type=int, default=1,
                   help="continuous-batching width for --serve: up to N requests queued "
                        "behind a running one are served as one batched generate()")
    p.add_argument("--embeddings-file", type=str, default=None,
                   help="safetensors with prompt_embeds / prompt_attention_mask (and "
                        "negative_*): the text encoder does not run")
    p.add_argument("--initial-latents-file", type=str, default=None,
                   help="safetensors with a 'latents' tensor [B,S,C] or [B,C,F,H,W]")
    p.add_argument("--save-final-latents", type=str, default=None,
                   help="also write the final latents [B,S,C] f32 to this safetensors "
                        "file, key 'latents'")
    p.add_argument("--save-frames", action="store_true",
                   help="also write one PNG a frame (needs Pillow)")
    p.add_argument("--gif", action="store_true", help="also write video.gif (needs imageio)")
    p.add_argument("--mp4", action="store_true", help="also write video.mp4 (needs imageio)")
    p.add_argument("--image", type=str, action="append", default=None,
                   help="conditioning image, resized to --height x --width; repeatable; "
                        "'path[:frame[:strength]]' places the anchor at a latent frame "
                        "index (default 0) with a strength (default 1.0), e.g. --image "
                        "a.png --image b.png:12:0.9 for first+last interpolation")
    p.add_argument("--vae-tiling", action="store_true",
                   help="decode with spatial and temporal VAE tiling (approximate: "
                        "blended overlaps), and encode the --image anchors tiled")
    p.add_argument("--vae-slicing", action="store_true",
                   help="decode the batch's videos one at a time")
    p.add_argument("--vae-stream-chunks", type=int, default=0,
                   help="decode with the exact streamed tail in N temporal chunks "
                        "(overlap-save conv caches, zero recompute); default: the mode "
                        "select_decode_mode picks from the free card memory")
    p.add_argument("--progress", action="store_true",
                   help="print a line per denoise step; Ctrl-C then stops after the "
                        "current step (cooperative interrupt)")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"],
                   help="model dtype; the CUDA kernels take bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    p.add_argument("--attn-impl", type=str, default="auto", choices=ATTN_IMPLS,
                   help="attention route, as the JAX CLI's: 'auto' and 'pallas' run the "
                        "CUDA kernels on the GPU; 'xla' (the plain attention) is refused "
                        "on the GPU, whose path never falls back to a plain version. On "
                        "the CPU every choice is the plain path")
    p.add_argument("--mesh", type=str, default=None,
                   help="one process per GPU under torchrun (NCCL; gloo with --device "
                        "cpu): 'sp=N' sequence-parallel ring attention (video tokens "
                        "shard over N ranks, K/V rotate around the ring); 'tp=N' tensor "
                        "parallelism (each rank holds 1/N of the DiT's heads and FF "
                        "lanes); 'pp=N[,interleave=K]' the DiT's block stack pipelined "
                        "over N stages (K virtual stages a rank), tp=M beside it cuts "
                        "each stage over M ranks. 'sp=1', 'tp=1' and 'pp=1' alone are "
                        "an ordinary request. dp=M shards the batch, which needs M "
                        "videos")
    return p


def parse_image_spec(spec: str) -> tuple:
    """'path[:frame[:strength]]' -> (path, frame_index, strength).  The
    trailing pieces count only when they parse as numbers, so paths holding
    ':' still resolve ('C:/img.png', 'img.png:12:0.9')."""
    parts = spec.rsplit(":", 2)
    if len(parts) == 3:
        try:
            return parts[0], int(parts[1]), float(parts[2])
        except ValueError:
            pass
    if len(parts) >= 2:
        try:
            return spec.rsplit(":", 1)[0], int(parts[-1]), 1.0
        except ValueError:
            pass
    return spec, 0, 1.0


_MESH_KEYS = ("dp", "sp", "tp", "pp", "interleave")


def parse_mesh(spec: str) -> dict:
    """'pp=2,interleave=2' -> {"dp": 1, "sp": 1, "tp": 1, "pp": 2,
    "interleave": 2}, every key defaulting to 1; refuses what the JAX
    package does not compose (tp with sp, pp with sp) and an interleave
    without a pipeline."""
    mesh = dict.fromkeys(_MESH_KEYS, 1)
    for item in spec.split(","):
        key, sep, val = item.partition("=")
        if key.strip() not in mesh or not sep or not val.strip().isdigit() or int(val) < 1:
            raise SystemExit(f"--mesh {spec!r}: expected comma-separated axis=N with keys "
                             f"{', '.join(_MESH_KEYS)} and N >= 1")
        mesh[key.strip()] = int(val)
    if mesh["tp"] > 1 and mesh["sp"] > 1:
        raise SystemExit(f"--mesh {spec!r}: tp and sp cannot be combined in one mesh "
                         "(weight sharding inside the ring is not wired); use tp=N or sp=N")
    if mesh["pp"] > 1 and mesh["sp"] > 1:
        raise SystemExit(f"--mesh {spec!r}: pass at most one of pp and sp")
    if mesh["interleave"] > 1 and mesh["pp"] == 1:
        raise SystemExit(f"--mesh {spec!r}: interleave=K splits pipeline stages and needs "
                         "pp=N with N > 1")
    return mesh


def mesh_ranks(mesh: dict) -> int:
    return mesh["dp"] * mesh["sp"] * mesh["tp"] * mesh["pp"]


def init_distributed(mesh: dict, device_name: str):
    """Join the torchrun process group (RANK, WORLD_SIZE, LOCAL_RANK and the
    rendezvous address from the environment), NCCL on the GPU of
    LOCAL_RANK or gloo on the CPU; returns the (pp, tp) pipeline mesh when
    pp > 1, else the (dp, tp) or (dp, sp) mesh."""
    need = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    if any(k not in os.environ for k in need):
        n = mesh_ranks(mesh)
        raise SystemExit(f"--mesh of {n} ranks runs one process per GPU: "
                         f"torchrun --nproc_per_node={n} -m candle_video_tpu_torch.cli "
                         "--mesh ...")
    device = resolve_device(device_name)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    if mesh["pp"] > 1:
        return make_pipeline_mesh(mesh["pp"], tp=mesh["tp"], device=device)
    return make_mesh(dp=mesh["dp"], tp=mesh["tp"], sp=mesh["sp"], device=device)


_DIT_INITS = {None: TF.init_random, "w8": TF.init_random_w8, "w4": TF.init_random_w4}
_T5_INITS = {"int8": T5.init_random_int8, "w4": T5.init_random_w4}


def build_random_pipeline(version: str, device, dtype=torch.bfloat16, seed: int = 0,
                          max_sequence_length: int = 128, dit_quant: str | None = None,
                          t5_quant: str = "int8", t5=None) -> LtxPipeline:
    """A preset's full-width pipeline with random weights made on ``device``
    from ``seed``: VAE decoder and encoder in ``dtype``; DiT in ``dtype``, or with its
    block linears as weight-only int8 (``dit_quant="w8"``) or int4 (``"w4"``);
    T5-XXL resident with int8 (``t5_quant="int8"``) or Q4_K-form 4-bit
    (``"w4"``) weights, unless a loaded encoder ``t5`` is given."""
    if dit_quant not in _DIT_INITS or t5_quant not in _T5_INITS:
        raise ValueError(f"dit_quant {dit_quant!r} not in {sorted(map(str, _DIT_INITS))} "
                         f"or t5_quant {t5_quant!r} not in {sorted(_T5_INITS)}")
    cfg = get_config_by_version(version)
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    transformer = _DIT_INITS[dit_quant](cfg.transformer, device, dtype, generator=g)
    vae = V.init_random(cfg.vae, device, dtype, generator=g)
    encoder = V.init_random_encoder(cfg.vae, device, dtype, generator=g)
    t5_cfg = t5_xxl()
    if t5 is None:
        t5 = _T5_INITS[t5_quant](t5_cfg, device, dtype)
    return build_pipeline("ltx_video", config=cfg, transformer=transformer, vae=vae, t5=t5,
                          t5_config=t5_cfg,
                          tokenizer=MockTokenizer(model_max_length=max_sequence_length),
                          vae_encoder=encoder)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this run needs an NVIDIA GPU "
                         "(pass --device cpu to run on the CPU on purpose)")
    return device


def _dit_quant(args):
    if args.dit_int8 and args.dit_int4:
        raise SystemExit("--dit-int8 and --dit-int4 are mutually exclusive")
    return "w8" if args.dit_int8 else ("w4" if args.dit_int4 else None)


def load_t5(args, device, dtype):
    """The T5-XXL from ``--t5-gguf`` or ``--t5-dir``, else None."""
    if args.t5_gguf:
        print(f"Loading GGUF T5: {args.t5_gguf}")
        return T5.t5_from_gguf(args.t5_gguf, t5_xxl(), device, dtype,
                               keep_quantized=args.t5_keep_quantized)
    if args.t5_dir:
        print(f"Loading T5 dir: {args.t5_dir}")
        return T5.t5_from_hf_state_dict(L.load_sharded(args.t5_dir), t5_xxl(), device, dtype)
    return None


_DIT_LOADERS = {None: L.transformer_from_state_dict, "w8": L.transformer_w8_from_state_dict,
                "w4": L.transformer_w4_from_state_dict}


def load_pipeline(args, device, dtype) -> LtxPipeline:
    """The pipeline the arguments ask for (JAX ``cli.load_pipeline``): the
    DiT, the VAE decoder and, where the file holds it, the VAE encoder from
    ``--weights-path`` (an official file through
    ``detect_format`` and ``split_unified_state_dict``, or a diffusers
    directory's ``transformer/`` and ``vae/``), the DiT dense or streamed
    into int8 / int4; the T5 from ``--t5-gguf`` / ``--t5-dir``.  Without
    ``--weights-path``, ``build_random_pipeline`` (random from ``--seed``,
    with its resident int8 T5 unless a T5 file is given)."""
    cfg = get_config_by_version(args.version)
    dit_quant = _dit_quant(args)
    tokenizer = make_tokenizer(args.tokenizer, args.max_sequence_length, t5_xxl().vocab_size)
    if not args.weights_path:
        print("No --weights-path: random-init DiT and VAE (smoke mode)")
        pipe = build_random_pipeline(args.version, device, dtype, seed=args.seed,
                                     dit_quant=dit_quant, t5=load_t5(args, device, dtype))
        pipe.tokenizer = tokenizer
        return pipe
    fmt = detect_format(args.weights_path)
    print(f"Loading weights ({fmt}): {args.weights_path}")
    if fmt == "official":
        tsd, vsd = split_unified_state_dict(L.load_safetensors(args.weights_path))
    else:
        tsd = L.load_sharded(os.path.join(args.weights_path, "transformer"))
        vsd = L.load_sharded(os.path.join(args.weights_path, "vae"))
    if dit_quant:
        bits = 8 if dit_quant == "w8" else 4
        print(f"Loading DiT as weight-only int{bits} (W{bits}A16), quantized on the host "
              "layer by layer")
    transformer = _DIT_LOADERS[dit_quant](tsd, cfg.transformer, device, dtype)
    vae = L.vae_decoder_from_state_dict(vsd, cfg.vae, device, dtype)
    encoder = (L.vae_encoder_from_state_dict(vsd, cfg.vae, device, dtype)
               if L.has_vae_encoder(vsd) else None)
    return build_pipeline("ltx_video", config=cfg, transformer=transformer, vae=vae,
                          t5=load_t5(args, device, dtype), t5_config=t5_xxl(),
                          tokenizer=tokenizer, vae_encoder=encoder)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.serve and args.mesh:
        raise SystemExit("--serve is the single-GPU serving loop and does not compose with "
                         "--mesh")
    if args.serve and (args.image or args.output_type == "latent"):
        raise SystemExit("--serve serves text prompts to video files; --image and "
                         "--output-type latent go through the one-shot CLI path")
    dit_quant = _dit_quant(args)
    mesh = parse_mesh(args.mesh) if args.mesh else None
    if mesh is not None and dit_quant:
        flag = "--dit-int4" if args.dit_int4 else "--dit-int8"
        raise SystemExit(f"{flag} is a single-GPU capacity path and does not compose with "
                         f"--mesh: drop {flag} for multi-GPU runs")
    if mesh is not None and mesh["dp"] > 1:
        raise SystemExit(f"--mesh dp={mesh['dp']} shards the batch, and the CLI generates "
                         "one video: use dp=1")
    if args.attn_impl == "xla" and torch.device(args.device).type == "cuda":
        raise SystemExit("--attn-impl xla runs the plain attention, and on the GPU no "
                         "tensor falls back to a plain version: use auto or pallas (the "
                         "CUDA kernels), or --device cpu")
    if mesh is not None and mesh_ranks(mesh) > 1:
        if (mesh["sp"] > 1 or mesh["pp"] > 1) and (
                args.progress or (args.save_final_latents and args.output_type != "latent")):
            mode = "sp" if mesh["sp"] > 1 else "pp"
            raise SystemExit("--progress, and --save-final-latents beside a video, take a "
                             f"step callback, which the {mode} loop does not: drop them "
                             f"with --mesh {mode}=N")
        pmesh = init_distributed(mesh, args.device)
        try:
            return _run(args, dit_quant, pmesh.device, pmesh, mesh["interleave"])
        finally:
            dist.destroy_process_group()
    return _run(args, dit_quant, resolve_device(args.device))


def _prompt_kwargs(args, pipe) -> dict:
    """The prompt (for the T5), the embeddings of ``--embeddings-file``, or,
    with no T5, random embeddings (as the JAX CLI's smoke mode)."""
    if args.embeddings_file:
        emb = L.load_safetensors(args.embeddings_file)
        names = ["prompt_embeds", "prompt_attention_mask"]
        if "negative_prompt_embeds" in emb:
            names += ["negative_prompt_embeds", "negative_prompt_attention_mask"]
        return {k: emb[k] for k in names}
    if pipe.t5 is not None:
        return dict(prompt=args.prompt, negative_prompt=args.negative_prompt)
    print("WARNING: no T5 weights given; using random embeddings (smoke mode). Pass "
          "--t5-gguf/--t5-dir or --embeddings-file for real runs.")
    shape = (1, args.max_sequence_length, pipe.config.transformer.caption_channels)
    embeds = torch.from_numpy(np.random.default_rng(0).normal(size=shape) * 0.02).float()
    mask = torch.ones(shape[:2])
    return dict(prompt_embeds=embeds, prompt_attention_mask=mask,
                negative_prompt_embeds=torch.zeros_like(embeds),
                negative_prompt_attention_mask=mask)


def run_serve(args, pipe) -> int:
    """The serving loop over ``serving.VideoGenerationServer``: the CLI's
    bucket is warmed once (a single request, and a batch of
    ``--serve-max-batch`` rows when batching), then each stdin line is a
    request whose video lands in ``output_dir/serve_NNN.mp4``.

    Lines are submitted as they are read, without waiting for the videos
    before them, so that requests queued behind a running one are served
    together, up to ``--serve-max-batch`` in one batched ``generate``; a
    writer thread takes the results in submission order.  Every request
    carries its embeddings (the server batches only such requests): with a
    T5 the prompt, and under guidance the negative prompt, are encoded as
    the line is read (``pipe.encode_prompt``, cached); without one, a prompt
    maps to random embeddings seeded by the CRC-32 of its UTF-8 bytes, the
    same in every process."""
    from .serving import Request, ShapeBucket, VideoGenerationServer
    from .utils import video_io

    inf = pipe.config.inference
    steps = args.num_inference_steps or inf.num_inference_steps
    g = args.guidance_scale if args.guidance_scale is not None else inf.guidance_scale
    mock = pipe.t5 is None or pipe.tokenizer is None
    guidance = bool(g and g > 1.0) and not mock
    bucket = ShapeBucket(args.height, args.width, args.num_frames, steps, guidance)
    if mock:
        print("[serve] no T5 weights: prompts map to random embeddings seeded by the prompt "
              "(smoke mode; pass --t5-gguf/--t5-dir for real serving)")
    server = VideoGenerationServer(
        pipe, [bucket], max_batch=args.serve_max_batch, use_pcg_rng=args.pcg_rng,
        vae_tail_stream_chunks=args.vae_stream_chunks,
        max_sequence_length=args.max_sequence_length, attn_impl=args.attn_impl)
    print(f"[serve] warming bucket {bucket.key()}...")
    t0 = time.perf_counter()
    server.warmup()
    print(f"[serve] warm in {time.perf_counter() - t0:.1f}s; one prompt a line (EOF or "
          "'quit' ends)")
    os.makedirs(args.output_dir, exist_ok=True)
    cap = pipe.config.transformer.caption_channels
    length = args.max_sequence_length
    submitted: queue.Queue = queue.Queue()  # (n, prompt, result queue, t0); None ends
    failed: list = []

    def write_results():  # its first error ends it; run_serve raises that error
        while (item := submitted.get()) is not None:
            n, prompt, result, t_submit = item
            try:
                out = result.get(timeout=1800)
                if isinstance(out, Exception):
                    raise out
                path = video_io.save_mp4(out.float().cpu().numpy(),
                                         os.path.join(args.output_dir, f"serve_{n:03d}.mp4"),
                                         args.frame_rate)
            except queue.Empty:
                failed.append(TimeoutError(f"request #{n} took over 1800 s"))
                return
            except Exception as e:
                failed.append(e)
                return
            print(f"[serve] #{n} {prompt[:48]!r} -> {path} "
                  f"({time.perf_counter() - t_submit:.2f}s)", flush=True)

    def embeddings(prompt: str) -> dict:
        if mock:
            rngk = np.random.default_rng(zlib.crc32(prompt.encode("utf-8")))
            embeds = rngk.normal(size=(1, length, cap)) * 0.02
            return dict(prompt_embeds=torch.from_numpy(embeds).float(),
                        prompt_attention_mask=torch.ones(1, length))
        with torch.no_grad():
            emb, mask = pipe.encode_prompt([prompt], length)
            kw = dict(prompt_embeds=emb, prompt_attention_mask=mask)
            if guidance:
                neg, neg_mask = pipe.encode_prompt([args.negative_prompt], length)
                kw.update(negative_prompt_embeds=neg, negative_prompt_attention_mask=neg_mask)
        return kw

    server.start()
    writer = threading.Thread(target=write_results, daemon=True)
    writer.start()
    n = 0
    interrupted = False
    try:
        for line in sys.stdin:
            prompt = line.strip()
            if prompt in ("quit", "exit") or failed:
                break
            if not prompt:
                continue
            req = Request(bucket=bucket, seed=args.seed + n, **embeddings(prompt))
            submitted.put((n, prompt, server.submit(req), time.perf_counter()))
            n += 1
    except KeyboardInterrupt:
        interrupted = True
        print("\n[serve] interrupted")
    finally:
        if not interrupted:
            submitted.put(None)
            writer.join()
        server.stop()
    print(f"[serve] served {server.stats()['served']} videos")
    if failed:
        raise failed[0]
    return 0


def _describe(mesh, interleave: int) -> str:
    if isinstance(mesh, PipelineMesh):
        return (f" | mesh pp={mesh.pp} interleave={interleave} tp={mesh.tp} "
                "(pipelined block stack)")
    if mesh.sp > 1:
        return f" | mesh dp={mesh.dp} sp={mesh.sp} (ring attention)"
    return f" | mesh dp={mesh.dp} tp={mesh.tp} (tensor parallel)"


def _run(args, dit_quant, device, mesh=None, interleave: int = 1) -> int:
    """One request on ``device``; ``mesh`` (from ``init_distributed``)
    chooses, in the JAX CLI's order, the pipelined denoise (a pipeline
    mesh), the ring (sp > 1) or the tensor-parallel DiT."""
    lead = mesh is None or dist.get_rank() == 0  # the rank that prints and saves
    say = print if lead else (lambda *a, **k: None)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    say(f"candle-video-tpu-torch | preset {args.version} | device {device}"
        + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
        + (f" | DiT weight-only {dit_quant}" if dit_quant else "")
        + (_describe(mesh, interleave) if mesh is not None else ""))
    t0 = time.perf_counter()
    pipe = load_pipeline(args, device, dtype)
    say(f"loaded pipeline in {time.perf_counter() - t0:.2f}s")
    mesh_kw = {}
    if isinstance(mesh, PipelineMesh):
        mesh_kw = dict(pp_mesh=mesh, pp_interleave=interleave)
    elif mesh is not None and mesh.sp > 1:
        mesh_kw = dict(sp_mesh=mesh)
    elif mesh is not None:
        shard_transformer(pipe.transformer, mesh)
    if args.serve:
        return run_serve(args, pipe)

    kwargs = _prompt_kwargs(args, pipe)
    if args.initial_latents_file:
        kwargs["latents"] = L.load_safetensors(args.initial_latents_file)["latents"]
    if args.image:
        if pipe.vae_encoder is None:
            raise SystemExit(f"--image needs the VAE encoder, and {args.weights_path} holds "
                             "none of its tensors (encoder.*)")
        from .models.ltx_video.pipeline import ConditioningItem
        from .utils.video_io import load_image

        kwargs["conditioning"] = [
            ConditioningItem(image=load_image(path, args.height, args.width),
                             frame_index=frame_index, strength=strength)
            for path, frame_index, strength in map(parse_image_spec, args.image)]
    final = {}
    step_callback = None
    if not mesh_kw:
        def step_callback(i, n, lat):
            final["latents"] = lat
            if args.progress:
                print(f"Step {i + 1}/{n}", flush=True)

    previous = None
    if args.progress:
        def on_sigint(sig, frame):
            print("\ninterrupt requested: finishing the current step...", flush=True)
            pipe.interrupt = True

        previous = signal.signal(signal.SIGINT, on_sigint)

    t0 = time.perf_counter()
    try:
        out = generate(pipe, height=args.height, width=args.width,
                       num_frames=args.num_frames, frame_rate=args.frame_rate,
                       num_inference_steps=args.num_inference_steps,
                       guidance_scale=args.guidance_scale,
                       guidance_rescale=args.guidance_rescale, stg_scale=args.stg_scale,
                       skip_block_list=args.skip_block_list,
                       num_videos_per_prompt=args.num_videos_per_prompt, seed=args.seed,
                       max_sequence_length=args.max_sequence_length,
                       use_pcg_rng=args.pcg_rng, attn_impl=args.attn_impl,
                       output_type=args.output_type, step_callback=step_callback,
                       vae_tail_stream_chunks=args.vae_stream_chunks,
                       use_vae_tiling=args.vae_tiling, use_vae_slicing=args.vae_slicing,
                       **mesh_kw, **kwargs)
    finally:
        if previous is not None:
            signal.signal(signal.SIGINT, previous)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    say(f"generation took {time.perf_counter() - t0:.2f}s, output {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise SystemExit("generation produced non-finite values")
    if not lead:
        return 0

    os.makedirs(args.output_dir, exist_ok=True)
    if args.output_type == "latent" or args.save_final_latents:
        latents = out if args.output_type == "latent" else final.get("latents")
        path = args.save_final_latents or os.path.join(args.output_dir, "latents.safetensors")
        if latents is None:
            print(f"no denoise step ran (interrupted): {path} not written")
        else:
            L.save_safetensors({"latents": latents.float()}, path)
            print(f"saved latents: {path}")
        if args.output_type == "latent":
            return 0
    from .utils import video_io

    video = out.cpu().numpy()
    path = os.path.join(args.output_dir, "video_uint8.npy")
    np.save(path, video_io.to_uint8_frames(video))
    print(f"saved frames [F,H,W,C] uint8: {path}")
    if args.save_frames:
        paths = video_io.save_frames_png(video, args.output_dir)
        print(f"saved {len(paths)} PNG frames to {args.output_dir}")
    if args.gif:
        path = video_io.save_gif(video, os.path.join(args.output_dir, "video.gif"),
                                 args.frame_rate)
        print(f"saved GIF: {path}")
    if args.mp4:
        path = video_io.save_mp4(video, os.path.join(args.output_dir, "video.mp4"),
                                 args.frame_rate)
        print(f"saved video: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

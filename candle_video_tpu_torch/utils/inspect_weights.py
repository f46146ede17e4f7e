"""Checkpoint inspection tool of the PyTorch port (``scripts/inspect_weights.py``,
the reference's debug examples: inspect_t5, inspect_vae_weights,
list_gguf_tensors, check_t5_shapes, dump_t5_embeddings).

- ``list`` prints a ``.safetensors`` or ``.gguf`` file's tensors (and a
  GGUF file's metadata) from its header, in the JAX script's text;
- ``split`` previews how an official single file's keys split into the
  transformer and the VAE (``weight_format``);
- ``dump-embeds`` encodes a prompt with a GGUF T5-XXL, dequantized once into
  ``--dtype`` as the JAX script loads it, and writes the ``prompt_embeds``
  (f32 [1, N, d_model]) / ``prompt_attention_mask`` (f32 [1, N]) file that
  the CLI's ``--embeddings-file`` reads.  Without ``--tokenizer`` prompts go
  through the hash tokenizer, as the CLI's do without it, so the file holds
  what ``cli --t5-gguf`` encodes for the same prompt.

Run: python -m candle_video_tpu_torch.utils.inspect_weights list <file.safetensors|file.gguf>
     python -m candle_video_tpu_torch.utils.inspect_weights split <unified.safetensors>
     python -m candle_video_tpu_torch.utils.inspect_weights dump-embeds --t5-gguf F \\
         [--tokenizer tokenizer.json] --prompt "..." --max-length 128 --out E.safetensors
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.ltx_video import loader as L
from ..models.ltx_video import weight_format as W
from ..models.ltx_video.configs import T5Config, t5_xxl
from .tokenizer import make_tokenizer


def cmd_list(path: str):
    if path.endswith(".gguf"):
        from ..quant.dequant_np import TYPE_NAMES
        from ..quant.gguf import GGUFFile

        f = GGUFFile(path)
        try:
            print(f"# GGUF: {len(f.tensors)} tensors, metadata keys: {len(f.metadata)}")
            for k, v in sorted(f.metadata.items()):
                print(f"  meta {k} = {str(v)[:80]}")
            for name, info in f.tensors.items():
                tname = TYPE_NAMES.get(info.ggml_type, str(info.ggml_type))
                print(f"  {name}  {info.shape}  {tname}")
        finally:
            f.close()
    else:
        info = L.get_tensor_info(path)
        print(f"# safetensors: {len(info)} tensors")
        for name, (shape, dtype) in sorted(info.items()):
            print(f"  {name}  {shape}  {dtype}")


def cmd_split(path: str):
    info = L.get_tensor_info(path)
    n_t = n_v = n_o = 0
    for key in sorted(info):
        new = W.remap_key(key)
        if W.is_transformer_key(key) and not W.is_vae_key(key):
            dest, n_t = "transformer", n_t + 1
        elif W.is_vae_key(key):
            dest, n_v = "vae", n_v + 1
        else:
            dest, n_o = "?", n_o + 1
        print(f"  [{dest:>11}] {key} -> {new}")
    print(f"# transformer: {n_t}, vae: {n_v}, unclassified: {n_o}")


@torch.no_grad()
def encode_prompt(t5_gguf: str, cfg: T5Config, prompt: str, max_length: int, tokenizer,
                  device="cuda", dtype=torch.bfloat16) -> dict:
    """``prompt`` (ids from ``tokenizer``) through the GGUF T5 of config
    ``cfg``, dequantized into ``dtype`` on ``device``: ``prompt_embeds`` f32
    [1, max_length, d_model] and ``prompt_attention_mask`` f32
    [1, max_length], on the host."""
    from ..models.ltx_video import t5 as T5

    encoder = T5.t5_from_gguf(t5_gguf, cfg, device, dtype)
    ids, mask = tokenizer.encode_batch([prompt], max_length)
    ids = torch.from_numpy(np.asarray(ids, np.int64)).to(encoder.embedding.device)
    mask = torch.from_numpy(np.asarray(mask, np.float32))
    emb = encoder(ids, attention_mask=mask.to(ids.device))
    return {"prompt_embeds": emb.float().cpu(), "prompt_attention_mask": mask}


def cmd_dump_embeds(args):
    tokenizer = make_tokenizer(args.tokenizer, args.max_length, t5_xxl().vocab_size)
    out = encode_prompt(args.t5_gguf, t5_xxl(), args.prompt, args.max_length, tokenizer,
                        args.device, getattr(torch, args.dtype))
    L.save_safetensors(out, args.out)
    print(f"saved {args.out}: {tuple(out['prompt_embeds'].shape)}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m candle_video_tpu_torch.utils.inspect_weights")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list").add_argument("path")
    sub.add_parser("split").add_argument("path")
    p_dump = sub.add_parser("dump-embeds")
    p_dump.add_argument("--t5-gguf", required=True)
    p_dump.add_argument("--tokenizer", default=None,
                        help="tokenizer.json (needs the tokenizers package); default: the "
                             "hash tokenizer, as the CLI's without --tokenizer")
    p_dump.add_argument("--prompt", default="a cat")
    p_dump.add_argument("--max-length", type=int, default=128)
    p_dump.add_argument("--out", default="embeddings.safetensors")
    p_dump.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises when no GPU is present")
    p_dump.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                        help="the dequantized T5's dtype, as the CLI's --dtype")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "list":
        cmd_list(args.path)
    elif args.cmd == "split":
        cmd_split(args.path)
    else:
        cmd_dump_embeds(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""T5 tokenizer wrapper: HF tokenizers → fixed-length ids + mask — the port's
own copy of ``candle_video_tpu/utils/tokenizer.py``.

Mirror of the reference's TokenizerAdapter (examples/ltx-video/
main.rs:109-149) and QuantizedT5Encoder::tokenize (text_encoder.rs:652-824):
pad/truncate to a fixed length (default 128), 0/1 attention mask.
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np


class T5TokenizerWrapper:
    def __init__(self, tokenizer_json_path: str, model_max_length: int = 128,
                 pad_id: int = 0):
        from tokenizers import Tokenizer

        self.tokenizer = Tokenizer.from_file(tokenizer_json_path)
        self.model_max_length = model_max_length
        self.pad_id = pad_id

    def encode_batch(self, prompts: Sequence[str], max_length: int | None = None):
        """Returns (input_ids [B, L] int32, attention_mask [B, L] int32)."""
        max_length = max_length or self.model_max_length
        ids = np.full((len(prompts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for i, enc in enumerate(self.tokenizer.encode_batch(list(prompts))):
            tok = enc.ids[:max_length]
            ids[i, : len(tok)] = tok
            mask[i, : len(tok)] = 1
        return ids, mask


class MockTokenizer:
    """Deterministic hash tokenizer for tests / embed-injection runs — the
    reference's DummyTokenizer role (examples/ltx-video/main.rs:151-173).
    A word's id comes from the CRC-32 of its UTF-8 bytes, the same in every
    process (the JAX package's copy uses ``hash()``, which Python salts per
    process)."""

    def __init__(self, vocab_size: int = 32128, model_max_length: int = 128):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length

    def encode_batch(self, prompts: Sequence[str], max_length: int | None = None):
        max_length = max_length or self.model_max_length
        ids = np.zeros((len(prompts), max_length), np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            toks = [zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 2) + 1
                    for w in p.split()][: max_length - 1]
            toks.append(1)  # EOS
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask

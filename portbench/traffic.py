"""The one generator of every traffic mix: the requests a run sends, made
from a mix's parameters (``portbench/traffic/<mix>.json``) and the run's
``--seed``.

- ``closed``: one client sends its next request when the last one's video
  is in host memory, for the run's seconds.  Request i carries a text
  prompt of ``prompt_tokens`` ids (the last one EOS) and its own seed.
- ``open``: requests fall due on a schedule of mean rate ``rate_per_min``
  drawn from the mix's ``schedule_seed``, never from ``--seed``: every run
  offers the same requests at the same moments, and ``--seed`` sets only
  what they carry (prompt embeddings, mask lengths, seeds).  Requests due
  inside the run's seconds are sent.  ``arrival`` names the process:
  ``poisson``, or ``onoff`` (Poisson bursts for ``on_s`` seconds, then
  ``off_s`` seconds with none, at the same mean rate).

Prompt ids come from the benchmark's own tokenizer (``IdTokenizer``): the
prompt text is the ids themselves, so both sides read the same ids.
"""

from __future__ import annotations

from typing import List

import numpy as np

EOS = 1


class IdTokenizer:
    """Prompts written as ``t<id> t<id> ...`` -> those ids, EOS, zero
    padding; the mask marks the ids and the EOS."""

    def encode_batch(self, prompts, max_length: int = 128):
        ids = np.zeros((len(prompts), max_length), np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            toks = [int(w[1:]) for w in p.split()][:max_length - 1] + [EOS]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return ids, mask


def request_seed(seed: int, i: int) -> int:
    """Request i's generation seed: distinct per request, below 2**31."""
    return int(np.random.default_rng([seed, i, 1]).integers(0, 2 ** 31 - 1))


def prompt(seed: int, i: int, tokens: int, vocab: int) -> str:
    """Request i's prompt: ``tokens - 1`` ids in [2, vocab) and the EOS the
    tokenizer adds."""
    ids = np.random.default_rng([seed, i, 2]).integers(2, vocab, tokens - 1)
    return " ".join(f"t{v}" for v in ids)


def _poisson(rng, rate: float, start: float, end: float) -> List[float]:
    out, t = [], start
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= end:
            return out
        out.append(t)


def arrivals(mix: dict, seconds: float) -> List[float]:
    """Due times in [0, seconds) of an open mix, from its schedule seed."""
    rng = np.random.default_rng(int(mix["schedule_seed"]))
    rate = mix["rate_per_min"] / 60.0
    if mix["arrival"] == "poisson":
        return _poisson(rng, rate, 0.0, seconds)
    if mix["arrival"] == "onoff":
        on, off = float(mix["on_s"]), float(mix["off_s"])
        out, t = [], 0.0
        while t < seconds:
            out += _poisson(rng, rate * (on + off) / on, t, min(t + on, seconds))
            t += on + off
        return out
    raise ValueError(f"unknown arrival process {mix['arrival']!r}")


def mask_lengths(seed: int, n: int, lo: int, hi: int) -> np.ndarray:
    """Valid prompt-embedding tokens of each open-mix request, in [lo, hi]."""
    return np.random.default_rng([seed, 3]).integers(lo, hi + 1, n)


def sample(seed: int, n: int, k: int) -> List[int]:
    """k of the n requests, drawn from the seed, for the check, in the order
    drawn: a shorter draw of the same seed is a prefix of a longer one."""
    return np.random.default_rng([seed, 4]).permutation(n)[:k].tolist()

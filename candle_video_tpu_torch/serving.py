"""In-process serving runtime of the PyTorch port
(``candle_video_tpu/serving.py``): shape buckets, a request queue and
continuous batching around one ``LtxPipeline``.

- **Shape buckets**: each (height, width, num_frames, steps, guidance)
  bucket is warmed once (the first calls build the CUDA kernels and pick
  the cuBLAS and cuDNN algorithms); a request snaps to the smallest bucket
  that holds it.
- **Request queue**: one worker thread serves the queue in order; the
  device runs one request (or one batch) at a time.
- **Continuous batching** (``max_batch > 1``): the worker drains
  same-bucket requests that carry embeddings and serves them as ONE
  batched ``generate`` call.  Each row's initial latents are drawn from its
  own seed, exactly as a single-request call draws them, and injected as
  ``latents``: PCG32 row by row on the host, or with
  ``use_pcg_rng=False`` every row's ``jax.random.normal(PRNGKey(seed))``
  in one R1 launch on the device (``utils/rng.rows_normal``, the JAX
  server's jitted ``vmap``); with a timestep-conditioned VAE every row's
  decode noise, from ``PRNGKey(seed + 2)``, is one more such launch,
  injected as ``decode_noise``.  A batched
  request therefore starts from the same numbers as when served alone, and
  on the CPU ends within float rounding of it.  Requests that do not match
  the batch wait in a bounded pending list that is served before new queue
  items (no starvation; submission order kept within a compatibility
  class).  The CFG/STG rows stack on the same batch axis, so a batch of N
  runs one forward of N × num_conds rows a step.
- **Stats**: per-bucket latency, queue depth, served count, batch size.
- **Observability** (``utils/debug.py``): each served ``generate`` call is
  a ``serve.call`` span (``rows``, ``request_ids``) that holds
  ``generate`` and, in a batch's call, ``serve.rows`` (the row draws and
  concatenations) and ``serve.handoff`` (the rows to the callers); its
  seconds, to the end of ``generate``, are the bucket's ``last_ms``.
  Inside ``debug.recording()`` the spans are kept, with one
  ``serve.queue_wait`` a request (``request_id``) from ``submit`` to the
  moment the worker takes it into a batch, a stay in the pending list
  included.  With ``CVT_LOG=info`` each served call logs one JSON line
  (bucket, rows, milliseconds); with ``CVT_PROFILE=<dir>`` each served
  call is a ``torch.profiler`` window written to
  ``<dir>/serve_NNNNN_bR.trace.json`` (R rows), which holds the call's
  span.

A stochastic preset (``0.9.6-distilled``) draws its step noise from the
first request's seed for the whole batch, as the JAX server does, so there
a batched request differs from the same request served alone.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.ltx_video.pipeline import generate
from .utils import debug
from .utils import rng as R


@dataclasses.dataclass(frozen=True)
class ShapeBucket:
    height: int
    width: int
    num_frames: int
    num_inference_steps: int
    guidance: bool = False  # CFG and STG rows on or off

    def key(self) -> Tuple:
        return (self.height, self.width, self.num_frames,
                self.num_inference_steps, self.guidance)


@dataclasses.dataclass
class Request:
    prompt: Optional[str] = None
    negative_prompt: Optional[str] = None
    prompt_embeds: Any = None
    prompt_attention_mask: Any = None
    negative_prompt_embeds: Any = None
    negative_prompt_attention_mask: Any = None
    bucket: Optional[ShapeBucket] = None
    seed: int = 42
    output_type: str = "tensor"
    request_id: Any = None  # the caller's name for it, on its spans


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cat(xs, device):
    return torch.cat([x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
                      for x in xs]).to(device)


class VideoGenerationServer:
    """A single-device serving loop around an ``LtxPipeline``, on the
    pipeline's device.  ``generate_kwargs`` go to every ``generate`` call
    (``use_pcg_rng``, ``max_sequence_length``, ``vae_tail_stream_chunks``,
    ...); the bucket sets the shape, the steps and the guidance."""

    def __init__(self, pipe, buckets: Sequence[ShapeBucket], max_batch: int = 1,
                 **generate_kwargs):
        self._pipe = pipe
        self._buckets = {b.key(): b for b in buckets}
        self._max_batch = max(1, int(max_batch))
        if any(k in generate_kwargs for k in ("conditioning", "image", "image_latents")):
            # the server injects each row's noise as `latents`, which
            # generate() takes as already mixed under conditioning: the
            # anchors would be dropped without a word
            raise ValueError(
                "image conditioning is not supported as a server-level generate kwarg; "
                "serve conditioned requests through generate() directly")
        self._gen_kwargs = generate_kwargs
        # (request, result queue, debug.mark() at submit)
        self._queue: "queue.Queue[tuple[Request, queue.Queue, Any]]" = queue.Queue()
        # items skipped by _drain_batch, served before new queue items
        self._pending: list = []
        self._stats: Dict[Tuple, Dict[str, float]] = {}
        self._served = 0
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, warm_embeds=None, warm_mask=None):
        """Run every bucket once on neutral inputs: a single request and,
        when ``max_batch > 1``, a batch of ``max_batch`` rows, so that the
        first real requests pay no kernel build or algorithm search."""
        for b in self._buckets.values():
            if warm_embeds is None:
                cap = self._pipe.config.transformer.caption_channels
                warm_embeds = torch.zeros(1, 128, cap)
                warm_mask = torch.ones(1, 128)
            t0 = time.time()
            req = Request(
                prompt_embeds=warm_embeds, prompt_attention_mask=warm_mask,
                negative_prompt_embeds=warm_embeds if b.guidance else None,
                negative_prompt_attention_mask=warm_mask if b.guidance else None,
                bucket=b, seed=0,
                output_type="tensor" if self._pipe.vae is not None else "latent")
            self._generate(req)
            _sync(self._pipe.device)
            if self._max_batch > 1:
                self._batched_generate([req] * self._max_batch, b)
            self._stats[b.key()] = {"compile_s": time.time() - t0, "served": 0,
                                    "last_ms": 0.0}
        return self

    def start(self):
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        return self

    def stop(self):
        self._stop.set()
        if self._worker is not None:
            self._queue.put((None, None, None))  # wake
            self._worker.join(timeout=30)

    # -- request path ---------------------------------------------------------

    def submit(self, request: Request) -> "queue.Queue":
        """Enqueue; returns a one-item queue that receives the result (or the
        exception that serving it raised)."""
        out: "queue.Queue" = queue.Queue(maxsize=1)
        self._queue.put((request, out, debug.mark()))
        return out

    def generate_sync(self, request: Request, timeout: Optional[float] = None):
        if self._worker is None:
            return self._serve_one(request)
        result = self.submit(request).get(timeout=timeout)
        if isinstance(result, Exception):
            raise result
        return result

    def stats(self) -> Dict:
        return {
            "served": self._served,
            "queue_depth": self._queue.qsize(),
            "buckets": {str(k): dict(v) for k, v in self._stats.items()},
        }

    # -- internals ----------------------------------------------------------

    def _bucket_kwargs(self, b: ShapeBucket) -> Dict:
        inf = self._pipe.config.inference
        return dict(
            height=b.height,
            width=b.width,
            num_frames=b.num_frames,
            num_inference_steps=b.num_inference_steps,
            guidance_scale=inf.guidance_scale if b.guidance else 1.0,
            stg_scale=inf.stg_scale if b.guidance else 0.0,
            **self._gen_kwargs,
        )

    def _pick_bucket(self, request: Request) -> ShapeBucket:
        if request.bucket is not None and request.bucket.key() in self._buckets:
            return self._buckets[request.bucket.key()]
        if request.bucket is not None:
            # snap to the smallest bucket that fits
            cands = [b for b in self._buckets.values()
                     if b.height >= request.bucket.height
                     and b.width >= request.bucket.width
                     and b.num_frames >= request.bucket.num_frames]
            if cands:
                return min(cands, key=lambda b: (b.height * b.width, b.num_frames))
        if not self._buckets:
            raise RuntimeError("no shape buckets configured")
        return next(iter(self._buckets.values()))

    def _generate(self, request: Request):
        return generate(
            self._pipe,
            prompt=request.prompt,
            negative_prompt=request.negative_prompt,
            prompt_embeds=request.prompt_embeds,
            prompt_attention_mask=request.prompt_attention_mask,
            negative_prompt_embeds=request.negative_prompt_embeds,
            negative_prompt_attention_mask=request.negative_prompt_attention_mask,
            seed=request.seed,
            output_type=request.output_type,
            **self._bucket_kwargs(self._pick_bucket(request)),
        )

    def _record(self, b: ShapeBucket, n: int, call: debug.Span, batched: bool):
        """The stats and the log line of a served call, timed by its span."""
        rec = self._stats.setdefault(b.key(), {"served": 0, "last_ms": 0.0})
        rec["served"] += n
        rec["last_ms"] = round(call.seconds() * 1000.0, 1)
        if batched:
            rec["last_batch"] = n
        self._served += n
        debug.log("serve", bucket=list(b.key()), rows=n, ms=rec["last_ms"])

    def _serve_one(self, request: Request):
        b = self._pick_bucket(request)
        with debug.trace(f"serve_{self._served:05d}_b1"), \
                debug.Span("serve.call", rows=1, request_ids=[request.request_id]) as call:
            out = self._generate(request)
            _sync(out.device)
            self._record(b, 1, call, batched=False)
        return out

    # -- continuous batching --------------------------------------------------

    def _batchable(self, a: Request, b: Request) -> bool:
        if a.prompt_embeds is None or b.prompt_embeds is None:
            return False  # string prompts go through the embedding cache one at a time
        if self._pick_bucket(a).key() != self._pick_bucket(b).key():
            return False
        if a.output_type != b.output_type:
            return False
        if tuple(a.prompt_embeds.shape) != tuple(b.prompt_embeds.shape):
            return False
        if (a.negative_prompt_embeds is None) != (b.negative_prompt_embeds is None):
            return False
        return True

    def _drain_batch(self, first):
        batch = [first]
        skipped = []
        # older skipped items first (no starvation), then fresh queue items
        candidates = list(self._pending)
        self._pending = []
        while len(batch) < self._max_batch and candidates:
            item = candidates.pop(0)
            if self._batchable(batch[0][0], item[0]):
                batch.append(item)
            else:
                skipped.append(item)
        skipped = skipped + candidates
        while len(batch) < self._max_batch:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item[0] is None:
                self._queue.put(item)
                break
            if self._batchable(batch[0][0], item[0]):
                batch.append(item)
            else:
                skipped.append(item)
        self._pending = skipped
        return batch

    def _latent_shape(self, bucket: ShapeBucket):
        tcfg = self._pipe.config.transformer
        vcfg = self._pipe.config.vae
        f = (bucket.num_frames - 1) // vcfg.temporal_compression_ratio + 1
        h = bucket.height // vcfg.spatial_compression_ratio
        w = bucket.width // vcfg.spatial_compression_ratio
        return (1, tcfg.in_channels, f, h, w)

    def _row_latents(self, request: Request, bucket: ShapeBucket) -> np.ndarray:
        """The initial latents a single-request call draws (generate()'s
        ``use_pcg_rng`` branch), on the host: the PCG rows of a batch, and
        the reference of its ``jax.random`` rows."""
        shape = self._latent_shape(bucket)
        if self._gen_kwargs.get("use_pcg_rng", True):
            return R.Pcg32(request.seed, 0).randn(shape)
        return R.normal(R.prng_key(request.seed), shape)

    def _row_decode_noise(self, request: Request, bucket: ShapeBucket) -> np.ndarray:
        """The decode noise a single-request call draws: ``PRNGKey(seed + 2)``
        at the single-sample shape, on the host (the reference of a batch's
        ``rows_normal`` draw)."""
        return R.normal(R.prng_key(request.seed + 2), self._latent_shape(bucket))

    def _serve_batch(self, items):
        """Serve same-bucket queue items as one batched generate call; each
        item's result queue gets its row."""
        requests = [r for r, _, _ in items]
        b = self._pick_bucket(requests[0])
        with debug.trace(f"serve_{self._served:05d}_b{len(items)}"), \
                debug.Span("serve.call", rows=len(items),
                           request_ids=[r.request_id for r in requests]) as call:
            out = self._batched_generate(requests, b)
            self._record(b, len(items), call, batched=True)
            with debug.span("serve.handoff"):
                for i, (_, result, _) in enumerate(items):
                    result.put(out[i:i + 1])

    def _batched_generate(self, requests, b):
        """One generate() over N same-bucket embedding requests (the
        continuous-batching path; warmup runs it too)."""
        device = self._pipe.device
        shape, seeds = self._latent_shape(b), [r.seed for r in requests]
        with debug.span("serve.rows"):
            if self._gen_kwargs.get("use_pcg_rng", True):
                # PCG rows are host-side by contract
                latents = torch.from_numpy(
                    np.concatenate([self._row_latents(r, b) for r in requests])).to(device)
            else:
                latents = R.rows_normal(seeds, shape, device=device)
            decode_noise = None
            if (requests[0].output_type != "latent" and self._pipe.vae is not None
                    and self._pipe.config.vae.timestep_conditioning):
                decode_noise = R.rows_normal(seeds, shape, offset=2, device=device)
            neg = requests[0].negative_prompt_embeds is not None
            embeds = _cat([r.prompt_embeds for r in requests], device)
            mask = _cat([r.prompt_attention_mask for r in requests], device)
            neg_embeds = neg_mask = None
            if neg:
                neg_embeds = _cat([r.negative_prompt_embeds for r in requests], device)
                neg_mask = _cat([r.negative_prompt_attention_mask for r in requests], device)
        out = generate(
            self._pipe,
            prompt_embeds=embeds,
            prompt_attention_mask=mask,
            negative_prompt_embeds=neg_embeds,
            negative_prompt_attention_mask=neg_mask,
            latents=latents,
            decode_noise=decode_noise,
            seed=requests[0].seed,
            output_type=requests[0].output_type,
            **self._bucket_kwargs(b),
        )
        _sync(device)
        return out

    def _loop(self):
        # grad mode is per thread: generate() turns it off for itself, the
        # row draws and the embedding concatenations here need it off too
        with torch.no_grad():
            while not self._stop.is_set():
                if self._pending:
                    item = self._pending.pop(0)
                else:
                    item = self._queue.get()
                    if item[0] is None:
                        continue
                batch = self._drain_batch(item) if self._max_batch > 1 else [item]
                for request, _, submitted in batch:
                    debug.since("serve.queue_wait", submitted, request_id=request.request_id)
                if len(batch) == 1:
                    request, out, _ = batch[0]
                    try:
                        out.put(self._serve_one(request))
                    except Exception as e:  # the caller's result queue gets it
                        out.put(e)
                    continue
                try:
                    self._serve_batch(batch)
                except Exception as e:
                    for _, out, _ in batch:
                        out.put(e)

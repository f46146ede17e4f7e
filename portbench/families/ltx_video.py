"""The LTX-Video family (the port's ``models/ltx_video``): text to video
on the 2B and 13B DiTs, closed loop and served.

A family module is what the harness (``run.py``) knows of one model
family; a configuration names it with ``"family"`` (none: this one).  It
gives, in plain functions:

- ``MODES``: the traffic modes it serves (``closed``; ``open``, through a
  server), and ``CONTROL``: the name of its reference's control precision;
- ``make_weights``: the raw weights of a configuration from a seed, on the
  device, every part the program takes;
- ``build``: the program on the device from them, calling ``done(phase)``
  after each set-up phase;
- ``request``: one closed-loop request, the video as [1, 3, F, H, W] f32 in
  [0, 255];
- ``Served`` (``open`` only): the server, and what the open mix's requests
  carry;
- ``reference_weights``, ``reference_latents``, ``reference_video``: the
  plain reference of one sampled request, at its own or the control
  precision.

The program is built by ``program.py`` from ``weights.py``'s tensors; the
reference is ``reference/ltx.py``.  A request carries a prompt of ids drawn
from the run's seed (``traffic.prompt``) and its own generation seed
(``traffic.request_seed``).
"""

from __future__ import annotations

import torch

from portbench import program, traffic, weights

MODES = ("closed", "open")
CONTROL = "fp8"


def make_weights(config: dict, seed: int, device):
    return weights.make(config, seed, device)


def build(config: dict, raw: dict, device, done):
    """The port's ``LtxPipeline``; set-up phases ``build_dit``,
    ``build_vae``, ``build_t5``."""
    return program.build(config, raw, traffic.IdTokenizer(), device, done)


def _shape(mix: dict) -> dict:
    return dict(height=mix["height"], width=mix["width"], num_frames=mix["num_frames"])


def request(pipe, config: dict, mix: dict, seed: int, i: int, stage_times, step_callback):
    """Request ``i`` of a run with seed ``seed``: its prompt and its
    generation seed, through the port's ``generate``."""
    vocab = config["t5"]["vocab_size"]
    return program.generate(pipe, prompt=traffic.prompt(seed, i, mix["prompt_tokens"], vocab),
                            seed=traffic.request_seed(seed, i),
                            max_sequence_length=mix["prompt_tokens"], stage_times=stage_times,
                            step_callback=step_callback, **_shape(mix))


class Served:
    """The port's ``VideoGenerationServer`` over the open mix's one bucket,
    and what the mix's first ``n`` requests carry, from the run's seed:
    prompt embeddings [n, 1, L, caption] bf16 (the embedding cache's
    output), masks [n, 1, L] with seeded valid lengths, generation seeds.
    Request ``n`` warms the server up."""

    def __init__(self, pipe, config: dict, mix: dict, seed: int, n: int, device,
                 step_callback, warm_index: int):
        cap_tokens = mix["embed_tokens"]
        cap = config["transformer"]["caption_channels"]
        g = torch.Generator(device=device).manual_seed(traffic.request_seed(seed, warm_index))
        self.embeds = torch.randn(n + 1, 1, cap_tokens, cap, generator=g, device=device,
                                  dtype=torch.bfloat16)
        lengths = traffic.mask_lengths(seed, n + 1, mix["min_mask_tokens"], cap_tokens)
        self.masks = (torch.arange(cap_tokens, device=device)[None, None, :]
                      < torch.as_tensor(lengths, device=device)[:, None, None]).float()
        self.seeds = [traffic.request_seed(seed, i) for i in range(n + 1)]
        self.n = n
        self.bucket = program.ShapeBucket(mix["height"], mix["width"], mix["num_frames"],
                                          config["inference"]["num_inference_steps"])
        self.server = program.VideoGenerationServer(
            pipe, [self.bucket], max_batch=mix["max_batch"],
            vae_tail_stream_chunks=mix["tail_stream_chunks"], step_callback=step_callback)

    def warmup(self):
        self.server.warmup(self.embeds[self.n], self.masks[self.n])

    def start(self):
        self.server.start()

    def stop(self):
        self.server.stop()

    def submit(self, i: int):
        """Request ``i``; returns the queue its video (or exception)
        arrives on."""
        return self.server.submit(program.Request(prompt_embeds=self.embeds[i],
                                                  prompt_attention_mask=self.masks[i],
                                                  bucket=self.bucket, seed=self.seeds[i]))

    def carried(self, i: int) -> dict:
        """What request ``i`` carried, for its reference."""
        return dict(embeds=self.embeds[i], mask=self.masks[i])


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def reference_weights(config: dict, seed: int, device, mix: dict):
    """What the reference reads: the open mix's requests carry prompt
    embeddings, so no T5 there."""
    return weights.make(config, seed, device,
                        ("dit", "vae") if mix["mode"] == "open" else ("dit", "vae", "t5"))


def _prec(control):
    from portbench.reference import ltx as REF

    return None if control is None else REF.Precision(control)


def _ref_shape(mix: dict, seed: int, r: dict, device) -> dict:
    return dict(seed=traffic.request_seed(seed, r["index"]), device=device, **_shape(mix))


def reference_latents(raw: dict, config: dict, mix: dict, seed: int, r: dict, device,
                      control=None):
    """Sampled request ``r``'s (``index``; ``embeds`` and ``mask`` where it
    carried them) final packed latents and initial noise, each [1, S, C]
    f32, at the reference's precision or ``control``'s."""
    from portbench.reference import ltx as REF

    if "embeds" in r:
        text = dict(embeds=r["embeds"].float(), mask=r["mask"].float())
    else:
        ids, mask = traffic.IdTokenizer().encode_batch(
            [traffic.prompt(seed, r["index"], mix["prompt_tokens"], config["t5"]["vocab_size"])],
            mix["prompt_tokens"])
        text = dict(ids=torch.from_numpy(ids).long().to(device),
                    mask=torch.from_numpy(mask).float().to(device))
    return REF.denoise(raw, config, prec=_prec(control), **text,
                       **_ref_shape(mix, seed, r, device))


def reference_video(raw: dict, config: dict, mix: dict, seed: int, r: dict, lat, device,
                    control=None):
    """The video [3, F, H, W] f32 in [0, 255] that request ``r``'s final
    latents ``lat`` [1, S, C] decode to."""
    from portbench.reference import ltx as REF

    return REF.decode(raw, config, lat, prec=_prec(control), **_ref_shape(mix, seed, r, device))

"""The weights a run makes for a seed, pinned: a checksum of every tensor
(name, dtype, shape, bytes) that the family's ``make_weights`` gives for the
tiny LTX-Video configurations (``tiny.py``), all three parts, one seed.
The values were read from the harness as it was before the family modules:
a change that moves them moves every cell's weights, and with them its
readings."""

import hashlib

import pytest
import torch

from portbench import run
from portbench.tests import tiny

SEED = 20261018
PINNED = {
    "ltx-video-2b-0.9.8-distilled":
        (179, "5112e8f9111879ca40de11944536de8063b695f00a06e608987dbccafaa0a7e2"),
    "ltx-video-13b-0.9.8-distilled-w4":
        (253, "ae8f55161ada7fc1d2d4e02d9c9b2cd578d1ab6ca29233b143286b29434247d1"),
}


def checksum(raw) -> str:
    h = hashlib.sha256()
    for name in sorted(raw):
        t = raw[name].contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_weights_of_a_seed_are_pinned(name):
    config = tiny.config(name)
    fam = run.family(config)
    raw = fam.make_weights(config, SEED, "cpu")
    assert (len(raw), checksum(raw)) == PINNED[name]
    # the reference reads the same tensors: all of them for a closed mix,
    # all but the text encoder's for the open one
    for mode in ("closed", "open"):
        ref = fam.reference_weights(config, SEED, "cpu", {"mode": mode})
        assert set(ref) == {k for k in raw if mode == "closed" or not k.startswith("t5.")}
        assert all(torch.equal(ref[k], raw[k]) for k in ref)

"""The frozen operation counts of ``arith`` against torch's own FLOP counter
on the plain reference at a tiny size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import arith, weights
from portbench.reference import ltx as REF
from portbench.tests import tiny


@pytest.mark.parametrize("name", ["ltx-video-2b-0.9.8-distilled",
                                  "ltx-video-13b-0.9.8-distilled-w4"])
def test_dit_forward_flops_match_the_counter(name):
    config = tiny.config(name)
    raw = weights.make(config, 3, "cpu", parts=("dit",))
    t = config["transformer"]
    s, k = 2 * 3 * 4, 16
    d = t["num_attention_heads"] * t["attention_head_dim"]
    lat = torch.randn(1, s, t["in_channels"])
    enc = torch.randn(1, k, t["caption_channels"])
    rope = (torch.ones(s, d), torch.zeros(s, d))
    with FlopCounterMode(display=False) as fc:
        REF.dit_forward(raw, t, REF.Precision(), lat, enc, torch.ones(1, k),
                        torch.full((1,), 500.0), rope,
                        skip=tuple(config["inference"]["skip_block_list"]))
    assert arith.dit_forward_flops(config, s, k) == fc.get_total_flops()


def test_decoder_conv_flops_match_the_counter():
    config = tiny.config("ltx-video-2b-0.9.8-distilled")
    raw = weights.make(config, 3, "cpu", parts=("vae",))
    lat = (2, 2, 3)
    z = torch.randn(1, config["vae"]["latent_channels"], *lat)
    with FlopCounterMode(display=False) as fc:
        REF.vae_decode(raw, config["vae"], z, torch.full((1,), 0.05), REF.Precision())
    convs = sum(v for op, v in fc.get_flop_counts()["Global"].items()
                if "convolution" in str(op))
    assert convs == sum(2 * 27 * ci * co * t * h * w
                        for ci, co, t, h, w in arith.decoder_convs(config, *lat))


def test_bounds_take_the_larger_of_compute_and_bytes():
    config = tiny.config("ltx-video-2b-0.9.8-distilled")
    # at 8 tokens attention moves more than it computes; at 8192 it computes more
    small, big = arith.self_attention_bound_s(config, 8), arith.self_attention_bound_s(config,
                                                                                      8192)
    hd = 128
    assert small == pytest.approx((4 * 8 * hd * 2 + 2 * 8 * hd * 4) / arith.PEAK_HBM_BYTES)
    assert big == pytest.approx(4.0 * 8192 ** 2 * hd / arith.PEAK_BF16_FLOPS)


def test_percentile_interpolates_between_ranks():
    assert arith.percentile([1, 2, 3, 4, 5], 50) == 3
    assert arith.percentile(list(range(1, 21)), 95) == pytest.approx(19.05)
    assert arith.percentile([7.0], 95) == 7.0

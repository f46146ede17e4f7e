"""K4 (weight-only int4 matmul) of the PyTorch port against the JAX package
on the CPU: the numpy producers bit for bit, the kernel's plain version
against the Pallas kernel in interpret mode, and the transient route
against ``w4_matmul_xla``.

Both sides of each comparison dequantize in the same order and round the
weight to bf16 once per order, then accumulate in f32; only the summation
order differs.  Tolerance: relative Frobenius error <= 1e-5."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.ops.pallas import int4_weight_matmul as J4
from candle_video_tpu_torch.ops.kernels import _build
from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4

torch.set_num_threads(2)
RTOL = 1e-5
SCALE_DTYPES = {"f32": (np.float32, torch.float32),
                "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _weights(rng, k, n, scale):
    """JAX-produced payload (numpy) and the same as torch tensors."""
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    p, s, m = J4.quantize_int4_blockwise(w, 32, scale_dtype=SCALE_DTYPES[scale][0])
    dt = SCALE_DTYPES[scale][1]
    return (p, s, m), (torch.from_numpy(p), torch.from_numpy(np.asarray(s, np.float32)).to(dt),
                       torch.from_numpy(np.asarray(m, np.float32)).to(dt))


@pytest.mark.parametrize("scale", ["f32", "bf16"])
def test_producers_match_jax_bit_for_bit(rng, scale):
    w = rng.normal(size=(2, 128, 48)).astype(np.float32) * 0.03  # stacked layers
    want = J4.quantize_int4_blockwise(w, 32, scale_dtype=SCALE_DTYPES[scale][0])
    got = K4.quantize_int4_blockwise(w, 32, scale_dtype=SCALE_DTYPES[scale][1])
    assert got[0].dtype == torch.uint8 and got[1].dtype == SCALE_DTYPES[scale][1]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for g, wnt in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(wnt, np.float32))
    codes = rng.integers(0, 16, size=(64, 24))
    np.testing.assert_array_equal(K4.pack_nibbles(codes), J4.pack_nibbles(codes))
    np.testing.assert_array_equal(
        K4.dequantize_int4_blockwise(want[0], *want[1:]),
        J4.dequantize_int4_blockwise(want[0], *want[1:]))


def test_straddling_k_is_rejected():
    with pytest.raises(ValueError, match="multiple of 2\\*qblock"):
        K4.quantize_int4_blockwise(np.zeros((32, 8), np.float32), qblock=32)
    with pytest.raises(ValueError):
        K4.pack_nibbles(np.full((4, 2), 16))


@pytest.mark.parametrize("m,k,n,scale,with_bias", [
    (128, 128, 192, "f32", False),
    (37, 320, 100, "bf16", True),   # ragged M and N, 5 groups per half
    (5, 320, 72, "f32", True),
    (128, 128, 128, "bf16", False),
])
def test_k4_plain_matches_pallas_interpret(rng, m, k, n, scale, with_bias):
    (p, s, mn), (tp, ts, tm) = _weights(rng, k, n, scale)
    x = rng.normal(size=(m, k)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    got = K4.w4_matmul(torch.from_numpy(x), tp, ts, tm,
                       None if bias is None else torch.from_numpy(bias))
    want = J4.w4_matmul(jnp.asarray(x), jnp.asarray(p), jnp.asarray(s), jnp.asarray(mn),
                        None if bias is None else jnp.asarray(bias),
                        out_dtype=jnp.float32, interpret=True)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("compute", ["bf16", "f32"])
def test_transient_route_matches_w4_matmul_xla(rng, compute):
    (p, s, mn), (tp, ts, tm) = _weights(rng, 128, 96, "bf16")
    x = rng.normal(size=(1100, 128)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    jdt, tdt = SCALE_DTYPES[compute][0], SCALE_DTYPES[compute][1]
    got = K4.w4_matmul_auto(torch.from_numpy(x), tp, ts, tm, torch.from_numpy(bias),
                            compute_dtype=tdt)
    want = J4.w4_matmul_xla(jnp.asarray(x), jnp.asarray(p), jnp.asarray(s), jnp.asarray(mn),
                            jnp.asarray(bias), out_dtype=jnp.float32, compute_dtype=jdt)
    assert _rel(got.numpy(), want) <= RTOL


def test_the_two_rounding_orders_differ(rng):
    """The kernel's f32-then-round dequant and the DiT's two-step bf16 one
    are different functions; a change that merges them shows here."""
    _, (tp, ts, tm) = _weights(rng, 256, 128, "bf16")
    x = torch.from_numpy(rng.normal(size=(16, 256)).astype(np.float32))
    kernel_order = K4.w4_matmul_plain(x, tp, ts, tm)
    bf16_order = K4.w4_matmul_xla_equivalent(x, tp, ts, tm, compute_dtype=torch.bfloat16)
    f32_order = K4.w4_matmul_xla_equivalent(x, tp, ts, tm, compute_dtype=torch.float32)
    assert _rel(bf16_order.numpy(), kernel_order.numpy()) > 1e-3
    assert _rel(f32_order.numpy(), kernel_order.numpy()) < 1e-6


def test_auto_dispatches_on_m(rng):
    _, (tp, ts, tm) = _weights(rng, 64, 32, "bf16")
    for m, route in ((K4.W4_XLA_MIN_M - 1, "kernel"), (K4.W4_XLA_MIN_M, "transient")):
        x = torch.from_numpy(rng.normal(size=(m, 64)).astype(np.float32))
        got = K4.w4_matmul_auto(x, tp, ts, tm, compute_dtype=torch.bfloat16)
        want = (K4.w4_matmul_plain(x, tp, ts, tm) if route == "kernel" else
                K4.w4_matmul_xla_equivalent(x, tp, ts, tm, compute_dtype=torch.bfloat16))
        assert torch.equal(got, want), route


def test_launch_counter_stays_zero_on_cpu(rng):
    _build.reset_launches()
    _, (tp, ts, tm) = _weights(rng, 64, 32, "f32")
    K4.w4_matmul(torch.ones(4, 64), tp, ts, tm)
    K4.w4_matmul_auto(torch.ones(4, 64), tp, ts, tm)
    assert _build.LAUNCHES[K4.NAME] == 0
    assert sum(_build.LAUNCHES.values()) == 0


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    wp = torch.zeros(32, 16, dtype=torch.uint8)
    s = torch.zeros(2, 16)
    with pytest.raises(TypeError):
        K4._check(x.float(), wp, s, s, None, 32)
    with pytest.raises(TypeError):
        K4._check(x, wp, s, s.bfloat16(), None, 32)
    with pytest.raises(ValueError, match="N % 8"):
        K4._check(x, wp[:, :12], s[:, :12], s[:, :12], None, 32)
    with pytest.raises(ValueError, match="on cpu"):  # shapes pass, then the device check
        K4._check(x, wp, s, s, None, 32)

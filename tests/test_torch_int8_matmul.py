"""K3 (weight-only int8 matmul) of the PyTorch port against the JAX
package's Pallas kernel in interpret mode, on the CPU.

Both sides round the dequantized weight to bf16 and accumulate in f32, so
the only difference is summation order.  Tolerance: relative Frobenius
error <= 4e-3."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.ops.pallas.int8_weight_matmul import (
    quantize_int8_blockwise,
    w8_matmul as jax_w8_matmul,
    w8_matmul_xla as jax_w8_matmul_xla,
)
from candle_video_tpu_torch.ops.kernels import int8_weight_matmul as K3

torch.set_num_threads(2)
RTOL = 4e-3


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("m,k,n,qblock,with_bias", [
    (128, 256, 192, 32, False),
    (37, 128, 100, 16, True),    # ragged M and N, Q6_K-style groups of 16
    (5, 96, 72, 32, True),
    (128, 64, 128, 16, False),
])
def test_k3_matches_pallas_interpret(rng, m, k, n, qblock, with_bias):
    x = rng.normal(size=(m, k)).astype(np.float32)
    w_q, s = quantize_int8_blockwise(rng.normal(size=(k, n)) * 0.05, qblock)
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    got = K3.w8_matmul(torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(s),
                       None if bias is None else torch.from_numpy(bias), qblock=qblock)
    want = jax_w8_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s),
                         None if bias is None else jnp.asarray(bias),
                         out_dtype=jnp.float32, interpret=True, qblock=qblock)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= RTOL


def test_k3_auto_takes_transient_dequant_at_large_m(rng):
    m, k, n = 1024, 64, 48
    x = rng.normal(size=(m, k)).astype(np.float32)
    w_q, s = quantize_int8_blockwise(rng.normal(size=(k, n)) * 0.05, 32)
    got = K3.w8_matmul_auto(torch.from_numpy(x), torch.from_numpy(w_q),
                            torch.from_numpy(s), out_dtype=torch.float32)
    want = jax_w8_matmul_xla(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s),
                             out_dtype=jnp.float32)
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("shape,qblock", [((256, 48), 32), ((2, 256, 40), 128),
                                          ((64, 24), 16)])
def test_quantize_int8_blockwise_matches_jax_bit_for_bit(rng, shape, qblock):
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    got_q, got_s = K3.quantize_int8_blockwise(w, qblock)
    want_q, want_s = quantize_int8_blockwise(w, qblock)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)
    with pytest.raises(ValueError, match="multiple of qblock"):
        K3.quantize_int8_blockwise(w[..., :-8, :], 128)


def test_dequantize_rounds_like_the_kernel(rng):
    w_q, s = quantize_int8_blockwise(rng.normal(size=(64, 16)), 32)
    got = K3.dequantize(torch.from_numpy(w_q), torch.from_numpy(s), 32)
    assert got.dtype == torch.bfloat16
    want = (w_q.astype(np.float32).reshape(2, 32, 16) * s[:, None, :]).reshape(64, 16)
    np.testing.assert_array_equal(
        got.float().numpy(), torch.from_numpy(want).to(torch.bfloat16).float().numpy())

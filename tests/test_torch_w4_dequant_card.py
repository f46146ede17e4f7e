"""The W4 transient dequant kernel (``csrc/w4_dequant.cu``) on a card,
against the plain ``dequantize`` run on the same card, bit for bit: both
orders (the DiT's bf16, the fallback's f32), f32 and bf16 scales, the 13B
DiT's three shapes, a ragged N and qblocks K4 refuses.  Marked ``cuda``;
each test skips itself without a card.

This file imports neither JAX nor the CPU tests' fixtures, so that it runs
on a machine with a card and no JAX: ``python -m pytest --noconftest
tests/test_torch_w4_dequant_card.py``."""

import pytest
import torch

from candle_video_tpu_torch.ops.kernels import _build
from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4
from candle_video_tpu_torch.ops.kernels.int8_weight_matmul import dot_bf16

ORDERS = {"bf16": torch.bfloat16, "f32": torch.float32}
SCALES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (K, N, qblock): the 13B DiT's q/k/v/out, FF up and FF down; a ragged N; a
# ragged last item of packed rows (K/2 = 34 rows, 4 a thread) whose groups
# start inside an item; qblocks that ``qblock_ok`` refuses (the f32-order
# fallback's), with ragged N
SHAPES = [(4096, 4096, 32), (4096, 16384, 32), (16384, 4096, 32), (320, 72, 32),
          (68, 40, 17), (384, 4104, 48), (4096, 136, 8)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the dequant kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _payload(k, n, qb, scale_dtype, dev, seed=0):
    """Random codes and the DiT init's affine form (s ~ 0.02/4.61, m ~ -7.5 s)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w_p = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    s = (torch.rand(k // qb, n, generator=g, device=dev) * 0.5 + 0.75) * (0.02 / 4.61)
    m = -7.5 * s * (1.0 + 0.05 * torch.randn(s.shape, generator=g, device=dev))
    return w_p, s.to(scale_dtype), m.to(scale_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("k,n,qb", SHAPES, ids=str)
def test_kernel_is_dequantize_bit_for_bit(k, n, qb, order, scale):
    dev = _card()
    w_p, s, m = _payload(k, n, qb, SCALES[scale], dev)
    _build.reset_launches()
    got = K4.w4_dequant(w_p, s, m, qb, ORDERS[order])
    want = K4.dequantize(w_p, s, m, qb, ORDERS[order])
    torch.cuda.synchronize()
    assert _build.LAUNCHES[K4.DEQUANT_KERNEL] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (k, n)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_auto_route_at_1024_rows_is_the_plain_route_exactly():
    """``w4_matmul_auto`` at M = 1024 (the DiT's transient route: bf16 order,
    bf16 scales, bias) against the route as it was, the plain dequant and
    the same cuBLAS matmul: equal, with one dequant launch per route call."""
    dev = _card()
    k, n, qb = 4096, 4096, 32
    w_p, s, m = _payload(k, n, qb, torch.bfloat16, dev, seed=1)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(K4.W4_XLA_MIN_M, k, generator=g, device=dev).bfloat16()
    bias = (torch.randn(n, generator=g, device=dev) * 0.1).bfloat16()
    _build.reset_launches()
    got = K4.w4_matmul_auto(x, w_p, s, m, bias, qb, compute_dtype=torch.bfloat16)
    want = dot_bf16(x, K4.dequantize(w_p, s, m, qb, torch.bfloat16), torch.bfloat16) + bias
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _build.LAUNCHES[K4.DEQUANT_KERNEL] == _build.LAUNCHES[K4.DEQUANT_NAME] == 1
    assert _build.LAUNCHES[K4.NAME] == 0


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take():
    """A CUDA tensor launches the kernel or raises: no fallback."""
    dev = _card()
    w_p, s, m = _payload(128, 40, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="N % 8"):
        K4.w4_dequant(w_p[:, :36].contiguous(), s[:, :36].contiguous(),
                      m[:, :36].contiguous(), 32)
    with pytest.raises(ValueError, match="on one CUDA device"):
        K4.w4_dequant(w_p, s.cpu(), m, 32)

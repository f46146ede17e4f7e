"""K4 (weight-only int4 matmul) of the PyTorch port against the JAX package
on the CPU: the numpy producers bit for bit, the kernel's plain version
against the Pallas kernel in interpret mode, and the transient route
against ``w4_matmul_xla``.

Both sides of each comparison dequantize in the same order and round the
weight to bf16 once per order, then accumulate in f32; only the summation
order differs.  Tolerance: relative Frobenius error <= 1e-5 for f32
outputs, <= 2e-4 where both sides round to bf16 (the card's schedule
emulated in torch against the plain version and the Pallas kernel)."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.ops.pallas import int4_weight_matmul as J4
from candle_video_tpu_torch.ops.kernels import _build
from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4
from test_torch_int8_matmul import (  # noqa: E402  (K3's helpers: one kernel)
    EMU_RTOL, _forced_plans as forced_plans, check_plan_covers_the_output,
    check_plan_fills_one_wave, emulate_split_k, stub_card)

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
    K4.w4_matmul_auto(torch.ones(K4.W4_XLA_MIN_M, 64), tp, ts, tm,
                      compute_dtype=torch.bfloat16)
    K4.w4_dequant(tp, ts, tm, 32, torch.bfloat16)
    assert _build.LAUNCHES[K4.NAME] == 0
    assert _build.LAUNCHES[K4.DEQUANT_KERNEL] == 0
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("qb", [32, 48])
@pytest.mark.parametrize("scale", ["f32", "bf16"])
@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_w4_dequant_on_cpu_tensors_is_the_plain_dequantize(rng, compute, scale, qb):
    """The transient route's dequant takes the plain version on the CPU, in
    both orders, with either scale dtype, at a qblock K4 takes and at one
    it refuses (the fallback's)."""
    k, n = 4 * qb, 72  # N a multiple of 8, not of 16
    tp, ts, tm = K4.quantize_int4_blockwise(rng.normal(size=(k, n)).astype(np.float32) * 0.05,
                                            qb, SCALE_DTYPES[scale][1])
    got = K4.w4_dequant(tp, ts, tm, qb, compute)
    assert got.dtype == torch.bfloat16 and got.shape == (k, n)
    assert torch.equal(got, K4.dequantize(tp, ts, tm, qb, compute))


def _dequant_operands(k=128, n=32, qb=32, scale_dtype=torch.bfloat16):
    return (torch.zeros(k // 2, n, dtype=torch.uint8), torch.zeros(k // qb, n, dtype=scale_dtype),
            torch.zeros(k // qb, n, dtype=scale_dtype))


def _unaligned(t):
    """``t``'s values in a tensor whose data starts 2 bytes past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() * t.element_size() + 16, dtype=torch.uint8)
    off = (-flat.data_ptr() + 2) % 16
    return flat[off:off + t.numel() * t.element_size()].view(t.dtype).view(t.shape)


DEQUANT_REFUSALS = {
    "int8 codes": (TypeError, lambda w, s, m: (w.to(torch.int8), s, m, 32, torch.bfloat16)),
    "f16 scales": (TypeError, lambda w, s, m: (w, s.half(), m.half(), 32, torch.bfloat16)),
    "s and m apart": (TypeError, lambda w, s, m: (w, s.float(), m, 32, torch.bfloat16)),
    "f16 compute": (TypeError, lambda w, s, m: (w, s, m, 32, torch.float16)),
    "N % 8": (ValueError, lambda w, s, m: (w[:, :12].contiguous(), s[:, :12].contiguous(),
                                           m[:, :12].contiguous(), 32, torch.bfloat16)),
    "s rows": (ValueError, lambda w, s, m: (w, s[:2].contiguous(), m[:2].contiguous(), 32,
                                            torch.bfloat16)),
    "1-D codes": (ValueError, lambda w, s, m: (w.reshape(-1), s, m, 32, torch.bfloat16)),
    "K % (2*qblock)": (ValueError, lambda w, s, m: (w[:48].contiguous(), s[:3].contiguous(),
                                                    m[:3].contiguous(), 32, torch.bfloat16)),
    "non-contiguous": (ValueError, lambda w, s, m: (w.t().contiguous().t(), s, m, 32,
                                                    torch.bfloat16)),
    "unaligned codes": (ValueError, lambda w, s, m: (_unaligned(w), s, m, 32, torch.bfloat16)),
    "unaligned min": (ValueError, lambda w, s, m: (w, s, _unaligned(m), 32, torch.bfloat16)),
}


@pytest.mark.parametrize("case", sorted(DEQUANT_REFUSALS))
def test_w4_dequant_checks_reject_what_the_kernel_does_not_take(case):
    """The card's wrapper raises, before any launch, on what the kernel does
    not take; a CPU tensor that passes every other check fails the device
    check last."""
    err, make = DEQUANT_REFUSALS[case]
    args = make(*_dequant_operands())
    with pytest.raises(err, match=K4.DEQUANT_KERNEL):
        K4._check_dequant(*args)
    with pytest.raises(ValueError, match="on one CUDA device, not cpu"):
        K4._check_dequant(*_dequant_operands(), 32, torch.bfloat16)


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


@pytest.mark.parametrize("qb", [8, 48, 96])
def test_qblocks_the_kernel_refuses_still_run_on_the_cpu(rng, qb):
    """The kernel takes a qblock whose 16-deep chunks lie in one group (16,
    32, 64, 128, ...), so its checks refuse 8, 48 or 96; the wrapper sends
    those to the transient route in the kernel's f32 order on the card
    (``qblock_ok``), and on the CPU the plain version, as the JAX
    kernel, takes them."""
    k, n = 8 * qb, 16
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    packed, s, mn = K4.quantize_int4_blockwise(w, qb)
    x = torch.from_numpy(rng.normal(size=(4, k)).astype(np.float32))
    assert not K4.qblock_ok(qb)
    with pytest.raises(ValueError, match="multiple of 16 dividing 64"):
        K4._check(x.bfloat16(), packed, s, mn, None, qb)
    got = K4.w4_matmul(x, packed, s, mn, qblock=qb)
    want = J4.w4_matmul(jnp.asarray(x.numpy()), jnp.asarray(packed.numpy()),
                        jnp.asarray(s.numpy()), jnp.asarray(mn.numpy()),
                        out_dtype=jnp.float32, interpret=True, qblock=qb)
    assert _rel(got.numpy(), want) <= RTOL


# ---------------------------------------------------------------------------
# K4 on Hopper: the host plan, the card's schedule emulated in torch, and
# the wrapper's launch (K3's helpers: one kernel, two formats)
# ---------------------------------------------------------------------------

PATH = [(4096, 4096), (4096, 10240), (10240, 4096)]
PLAN_SHAPES = ([(m, k, n) for m in (1, 77, 128, 256, 1000) for k, n in PATH]
               + [(77, 1024, 4008), (1, 256, 16), (130, 320, 200)])


@pytest.mark.parametrize("scale_bytes", [4, 2])
@pytest.mark.parametrize("m,k,n,qb", [(m, k, n, qb) for m, k, n in PLAN_SHAPES
                                      for qb in (16, 32, 64, 128) if k % (2 * qb) == 0],
                         ids=str)
def test_k4_plan_covers_the_output_and_fits_the_card(m, k, n, qb, scale_bytes):
    def plan_of(m, k, n, qb, **kw):
        return K4.plan_w4(m, k, n, qb, scale_bytes, **kw)

    for p in forced_plans(plan_of, m, k, n, qb):
        check_plan_covers_the_output(p, m, k // 2, n)
        assert p["x_boxes"] == 2 and p["scale_tiles"] == 4
    p = plan_of(m, k, n, qb)
    assert p["stages"] >= 4
    assert p["stage_bytes"] >= 2 * 128 * 128 + p["bn"] * 64 + 4 * p["srows"] * p["bn"] * \
        scale_bytes
    check_plan_fills_one_wave(p)


def test_k4_plan_on_the_path():
    """The T5 linears (f32 s, m) and the DiT's cross-attention k/v (bf16)
    at 128 tokens: 256-column tiles, a four-stage ring of 56 or 52 KB
    steps (two x boxes, the raw tile, four scale tiles), K3's clusters;
    qblock 16 in f32 takes 128-column tiles to keep four stages."""
    for (k, n), split in zip(PATH, (6, 2, 6)):
        p = K4.plan_w4(128, k, n, 32, 4)
        assert (p["bn"], p["stages"], p["stage_bytes"], p["split"]) == (256, 4, 57344, split)
    p = K4.plan_w4(128, 4096, 4096, 32, 2)
    assert (p["bn"], p["stages"], p["stage_bytes"], p["split"]) == (256, 4, 53248, 6)
    p = K4.plan_w4(128, 4096, 4096, 16, 4)
    assert (p["bn"], p["stages"], p["split"]) == (128, 4, 3)


def magic_dequant_k4(w_p, s, m, qb):
    """The card's dequant: each nibble in the mantissa of 2^23 (c = 2^23 +
    q), then q * s as one FMA, c * s + (-2^23 * s) rounded once to f32 (in
    float64 here, where that sum is exact), then + f32(m) rounded apart,
    one bf16 rounding; low nibbles are logical rows 0 .. K/2 - 1."""
    codes = torch.cat([w_p & 0xF, w_p >> 4], dim=0).to(torch.int32)
    k, n = codes.shape
    c = (codes | 0x4B000000).view(torch.float32).double().reshape(k // qb, qb, n)
    sd = s.float().double()[:, None, :]
    qs = (c * sd - 8388608.0 * sd).float()
    # the FMA's q * s is the f32 product of the exact code and the scale
    q = (c - 8388608.0).float()
    assert torch.equal(qs, q * s.float()[:, None, :])
    return (qs + m.float()[:, None, :]).reshape(k, n).to(torch.bfloat16)


def _emulate_k4(x, w_p, s, m, bias, qb, plan, drop=None):
    kh = w_p.shape[0]
    w = magic_dequant_k4(w_p, s, m, qb)
    assert torch.equal(w, K4.dequantize(w_p, s, m, qb))  # bit for bit

    def rows_of(a, b):  # a step's packed rows hold logical rows j and K/2 + j
        lo = torch.arange(64 * a, min(64 * b, kh))
        return torch.cat([lo, lo + kh])

    return emulate_split_k(x.to(torch.bfloat16).float(), w, plan, rows_of, bias, drop)


EMU_SHAPES = [(128, 1024, 256, 32, "f32", False), (77, 512, 200, 16, "f32", True),
              (256, 512, 384, 64, "bf16", True), (1, 1024, 136, 128, "bf16", False),
              (130, 320, 72, 32, "f32", True)]


def _k4_operands(rng, m, k, n, qb, scale, with_bias):
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    p, s, mn = J4.quantize_int4_blockwise(w, qb, scale_dtype=SCALE_DTYPES[scale][0])
    dt = SCALE_DTYPES[scale][1]
    ts, tm = (torch.from_numpy(np.asarray(a, np.float32)).to(dt) for a in (s, mn))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)) if with_bias else None
    return (x, torch.from_numpy(p), ts, tm, bias), (p, s, mn)


@pytest.mark.parametrize("m,k,n,qb,scale,with_bias", EMU_SHAPES, ids=str)
def test_k4_schedule_emulated_matches_plain_and_pallas_interpret(rng, m, k, n, qb, scale,
                                                                 with_bias):
    (x, tp, ts, tm, bias), (p, s, mn) = _k4_operands(rng, m, k, n, qb, scale, with_bias)
    want = K4.w4_matmul_plain(x, tp, ts, tm, bias, qb)

    def plan_of(m, k, n, qb, **kw):
        return K4.plan_w4(m, k, n, qb, ts.element_size(), **kw)

    for plan in forced_plans(plan_of, m, k, n, qb):
        got = _emulate_k4(x, tp, ts, tm, bias, qb, plan)
        assert _rel(got.float().numpy(), want.float().numpy()) <= EMU_RTOL, plan["split"]
    jax_y = J4.w4_matmul(jnp.asarray(x.float().numpy()), jnp.asarray(p), jnp.asarray(s),
                         jnp.asarray(mn), None if bias is None else jnp.asarray(bias.numpy()),
                         out_dtype=jnp.bfloat16, interpret=True, qblock=qb)
    got = _emulate_k4(x, tp, ts, tm, bias, qb, plan_of(m, k, n, qb))
    assert _rel(got.float().numpy(), np.asarray(jax_y, np.float32)) <= EMU_RTOL


def test_k4_schedule_without_one_split_partial_is_wrong(rng):
    m, k, n, qb = 128, 1024, 256, 32
    plan = K4.plan_w4(m, k, n, qb)
    assert plan["split"] == 8
    (x, tp, ts, tm, bias), _ = _k4_operands(rng, m, k, n, qb, "f32", True)
    want = K4.w4_matmul_plain(x, tp, ts, tm, bias, qb).float().numpy()
    assert _rel(_emulate_k4(x, tp, ts, tm, bias, qb, plan).float().numpy(), want) <= EMU_RTOL
    assert _rel(_emulate_k4(x, tp, ts, tm, bias, qb, plan, drop=1).float().numpy(),
                want) > 100 * EMU_RTOL


def test_k4_high_nibbles_need_their_own_groups(rng):
    """The card's broken K4 scales the high nibbles by the low group's s
    and m: the emulation with that dequant must fail the limit."""
    m, k, n, qb = 128, 512, 128, 32
    (x, tp, ts, tm, _), _ = _k4_operands(rng, m, k, n, qb, "f32", False)
    half = ts.shape[0] // 2
    lo_s, lo_m = torch.cat([ts[:half]] * 2), torch.cat([tm[:half]] * 2)
    want = K4.w4_matmul_plain(x, tp, ts, tm, None, qb).float().numpy()
    got = K4.w4_matmul_plain(x, tp, lo_s, lo_m, None, qb).float().numpy()
    assert _rel(got, want) > 100 * EMU_RTOL


@pytest.mark.parametrize("m,k,n,qb,scale_dtype", [(128, 4096, 4096, 32, torch.bfloat16),
                                                  (77, 4096, 4008, 16, torch.float32)],
                         ids=str)
def test_k4_launches_once_on_its_plan_with_no_workspace(monkeypatch, m, k, n, qb,
                                                        scale_dtype):
    x = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    w_p = torch.empty(k // 2, n, dtype=torch.uint8, device="meta")
    s = torch.empty(k // qb, n, dtype=scale_dtype, device="meta")
    bias = torch.empty(n, dtype=torch.bfloat16, device="meta")
    lib, allocs = stub_card(monkeypatch, K4)
    y = K4.w4_matmul(x, w_p, s, s, bias, qblock=qb)
    assert y.shape == (m, n) and y.dtype == torch.bfloat16 and y.device.type == "meta"
    assert allocs == [((m, n),)]  # the output, and no workspace
    p = K4.plan_w4(m, k, n, qb, s.element_size())
    assert len(lib.calls) == 1 and _build.LAUNCHES[K4.NAME] == 1
    call = lib.calls[0]
    assert len(call) == len(_build._SIGNATURES["cvt_w4_matmul"])
    assert call[6:] == (m, k, n, p["n_pad"], qb, int(scale_dtype == torch.bfloat16), p["bn"],
                        p["stages"], p["split"], p["smem_bytes"], 7)


ROUTES = {8: "dequant", 16: "kernel", 32: "kernel", 48: "dequant", 64: "kernel",
          96: "dequant", 128: "kernel"}


@pytest.mark.parametrize("qb", sorted(ROUTES))
def test_k4_on_the_card_routes_by_qblock_before_any_launch(monkeypatch, qb):
    """As K3: a qblock the kernel is not built for takes the transient route,
    counted as ``w4_matmul_dequant``, with no kernel launch."""
    m, k, n = 128, 8 * 96, 32
    x = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    w_p = torch.empty(k // 2, n, dtype=torch.uint8, device="meta")
    s = torch.empty(k // qb, n, dtype=torch.bfloat16, device="meta")
    lib, _ = stub_card(monkeypatch, K4)
    monkeypatch.setattr(K4, "_check_dequant", lambda *a: None)
    for call in (K4.w4_matmul, K4.w4_matmul_auto):
        y = call(x, w_p, s, s, qblock=qb)
        assert y.shape == (m, n) and y.device.type == "meta"
    kernel = ROUTES[qb] == "kernel"
    assert K4.qblock_ok(qb) == kernel
    assert len(lib.calls) == _build.LAUNCHES[K4.NAME] == 2 * kernel
    assert _build.LAUNCHES[K4.DEQUANT_NAME] == 2 * (not kernel)
    # the route's dequant is one launch of its kernel, in the kernel's f32 order
    assert len(lib.dequant_calls) == _build.LAUNCHES[K4.DEQUANT_KERNEL] == 2 * (not kernel)
    assert all(c[6:9] == (qb, 1, 0) for c in lib.dequant_calls)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_transient_route_launches_the_dequant_kernel_once(monkeypatch, compute, scale_dtype):
    """From ``W4_XLA_MIN_M`` rows on, a call on the card is one dequant
    launch into the [K, N] bf16 weight (its only allocation before the
    matmul), counted beside the route: the scale dtype and the order by
    flag, no K4 launch."""
    m, k, n, qb = K4.W4_XLA_MIN_M, 4096, 16392, 32
    x = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    w_p = torch.empty(k // 2, n, dtype=torch.uint8, device="meta")
    s = torch.empty(k // qb, n, dtype=scale_dtype, device="meta")
    lib, allocs = stub_card(monkeypatch, K4)
    monkeypatch.setattr(K4, "_check_dequant", lambda *a: None)
    y = K4.w4_matmul_auto(x, w_p, s, s, qblock=qb, compute_dtype=compute)
    assert y.shape == (m, n) and y.device.type == "meta"
    assert allocs[0] == ((k, n),)
    assert lib.calls == [] and _build.LAUNCHES[K4.NAME] == 0
    assert _build.LAUNCHES[K4.DEQUANT_KERNEL] == _build.LAUNCHES[K4.DEQUANT_NAME] == 1
    (call,) = lib.dequant_calls
    assert len(call) == len(_build._SIGNATURES["cvt_w4_dequant"])
    assert call[4:] == (k, n, qb, int(scale_dtype == torch.bfloat16),
                        int(compute == torch.bfloat16), 7)


@pytest.mark.parametrize("qb", [8, 48, 96])
def test_k4_dequant_route_matches_pallas_interpret(rng, qb):
    """The route the card takes for such a qblock dequantizes in the
    kernel's f32 order: JAX's ``w4_matmul``."""
    k, n = 8 * qb, 24
    packed, s, mn = K4.quantize_int4_blockwise(
        rng.normal(size=(k, n)).astype(np.float32) * 0.05, qb, torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(9, k)).astype(np.float32))
    got = K4.w4_matmul_xla_equivalent(x, packed, s, mn, qblock=qb)
    want = J4.w4_matmul(jnp.asarray(x.numpy()), jnp.asarray(packed.numpy()),
                        jnp.asarray(s.float().numpy()).astype(jnp.bfloat16),
                        jnp.asarray(mn.float().numpy()).astype(jnp.bfloat16),
                        out_dtype=jnp.float32, interpret=True, qblock=qb)
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("qb", [8, 48])
def test_k4_narrow_qblock_on_the_card(rng, qb):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the route runs on CUDA tensors only")
    k, n = 4096 // (2 * qb) * 2 * qb, 4096
    packed, s, mn = (t.cuda() for t in K4.quantize_int4_blockwise(
        rng.normal(size=(k, n)).astype(np.float32) * 0.05, qb, torch.bfloat16))
    x = torch.from_numpy(rng.normal(size=(128, k)).astype(np.float32)).cuda().bfloat16()
    _build.reset_launches()
    got = K4.w4_matmul(x, packed, s, mn, qblock=qb)
    want = K4.w4_matmul_plain(x, packed, s, mn, qblock=qb)
    assert _rel(got.float().cpu().numpy(), want.float().cpu().numpy()) <= 2e-3
    assert _build.LAUNCHES[K4.DEQUANT_NAME] == 1 and _build.LAUNCHES[K4.NAME] == 0

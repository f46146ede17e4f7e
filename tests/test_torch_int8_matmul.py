"""K3 (weight-only int8 matmul) of the PyTorch port against the JAX
package's Pallas kernel in interpret mode, on the CPU; the kernel's host
plan, its schedule on the card emulated in torch, and the wrapper's launch.

Both sides round the dequantized weight to bf16 and accumulate in f32, so
the only difference is summation order.  Tolerance: relative Frobenius
error <= 4e-3 for f32 outputs, <= 2e-4 where both sides round to bf16."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.ops.pallas.int8_weight_matmul import (
    quantize_int8_blockwise,
    w8_matmul as jax_w8_matmul,
    w8_matmul_xla as jax_w8_matmul_xla,
)
from candle_video_tpu_torch.ops.kernels import _build
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


@pytest.mark.parametrize("qb", [8, 48, 96])
def test_qblocks_the_kernel_refuses_still_run_on_the_cpu(rng, qb):
    """The kernel takes a qblock whose 16-deep chunks lie in one group (16,
    32, 64, 128, ...), so its checks refuse 8, 48 or 96; the wrapper sends
    those to the transient dequant route on the card
    (``qblock_ok``), and on the CPU the plain version, as the JAX
    kernel, takes them."""
    k, n = 4 * qb, 24
    x = rng.normal(size=(4, k)).astype(np.float32)
    w_q, s = quantize_int8_blockwise(rng.normal(size=(k, n)) * 0.05, qb)
    assert [K3.qblock_ok(q) for q in (qb, 16, 32, 64, 128, 192)] == [False] + [True] * 5
    with pytest.raises(ValueError, match="multiple of 16 dividing 64"):
        K3._check(torch.from_numpy(x).bfloat16(), torch.from_numpy(w_q),
                  torch.from_numpy(s), None, qb)
    got = K3.w8_matmul(torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(s),
                       qblock=qb)
    want = jax_w8_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s),
                         out_dtype=jnp.float32, interpret=True, qblock=qb)
    assert _rel(got.numpy(), want) <= RTOL


ROUTES = {8: "dequant", 16: "kernel", 32: "kernel", 48: "dequant", 64: "kernel",
          96: "dequant", 128: "kernel"}


@pytest.mark.parametrize("qb", sorted(ROUTES))
def test_k3_on_the_card_routes_by_qblock_before_any_launch(monkeypatch, qb):
    """A qblock the kernel is not built for goes to the transient dequant
    route, counted as ``w8_matmul_dequant``, with no kernel launch; the
    others launch the kernel once.  ``_auto`` below ``W8_XLA_MIN_M`` rows
    routes the same way, and from there on takes the dequant route."""
    m, k, n = 128, 4 * 96, 32
    x = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    w_q = torch.empty(k, n, dtype=torch.int8, device="meta")
    s = torch.empty(k // qb, n, device="meta")
    lib, _ = stub_card(monkeypatch, K3)
    for call in (K3.w8_matmul, K3.w8_matmul_auto):
        y = call(x, w_q, s, qblock=qb)
        assert y.shape == (m, n) and y.device.type == "meta"
    kernel = ROUTES[qb] == "kernel"
    assert K3.qblock_ok(qb) == kernel
    assert len(lib.calls) == _build.LAUNCHES[K3.NAME] == 2 * kernel
    assert _build.LAUNCHES[K3.DEQUANT_NAME] == 2 * (not kernel)
    K3.w8_matmul_auto(torch.empty(K3.W8_XLA_MIN_M, k, dtype=torch.bfloat16, device="meta"),
                      w_q, s, qblock=qb)
    assert _build.LAUNCHES[K3.DEQUANT_NAME] == 2 * (not kernel) + 1
    assert len(lib.calls) == 2 * kernel


@pytest.mark.parametrize("qb", [8, 48, 96])
def test_k3_dequant_route_matches_pallas_interpret(rng, qb):
    """What the card runs for such a qblock, run here: JAX's function."""
    k, n = 4 * qb, 40
    x = rng.normal(size=(77, k)).astype(np.float32)
    w_q, s = quantize_int8_blockwise(rng.normal(size=(k, n)) * 0.05, qb)
    bias = rng.normal(size=(n,)).astype(np.float32)
    got = K3.w8_matmul_dequant(torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(s),
                               torch.from_numpy(bias), qblock=qb)
    want = jax_w8_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s), jnp.asarray(bias),
                         out_dtype=jnp.float32, interpret=True, qblock=qb)
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("qb", [8, 48])
def test_k3_narrow_qblock_on_the_card(rng, qb):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the route runs on CUDA tensors only")
    k, n = 4096 // qb * qb, 4096
    x = torch.from_numpy(rng.normal(size=(128, k)).astype(np.float32)).cuda().bfloat16()
    w_q, s = (torch.from_numpy(a).cuda()
              for a in quantize_int8_blockwise(rng.normal(size=(k, n)) * 0.05, qb))
    _build.reset_launches()
    got = K3.w8_matmul(x, w_q, s, qblock=qb)
    want = K3.w8_matmul_plain(x, w_q, s, qblock=qb)
    assert _rel(got.float().cpu().numpy(), want.float().cpu().numpy()) <= 2e-3
    assert _build.LAUNCHES[K3.DEQUANT_NAME] == 1 and _build.LAUNCHES[K3.NAME] == 0


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


# ---------------------------------------------------------------------------
# K3 on Hopper: the host plan, the card's schedule emulated in torch, and
# the wrapper's launch
# ---------------------------------------------------------------------------

# the T5 linears (the path), and the same at M = 256 (CFG), ragged and tiny
PATH = [(4096, 4096), (4096, 10240), (10240, 4096)]
PLAN_SHAPES = ([(m, k, n) for m in (1, 77, 128, 256, 1000) for k, n in PATH]
               + [(77, 1024, 4001), (1, 64, 16), (130, 208, 200)])
# the card's schedule against the plain version (both bf16 outputs of f32
# sums in another order; readings under 1e-4) and against JAX in interpret
# mode, which also rounds to bf16 once
EMU_RTOL = 2e-4


def _forced_plans(plan_of, m, k, n, qb):
    yield plan_of(m, k, n, qb)
    steps = plan_of(m, k, n, qb)["steps"]
    for bn in (128, 256):
        for split in (1, 2, 3, 8):
            if split <= steps:
                yield plan_of(m, k, n, qb, bn=bn, split=split)


def check_plan_covers_the_output(p, m, rows, n):
    """Every output element is computed by one tile and reduced by one CTA
    of its cluster; every K step belongs to one split; the ring fits."""
    assert p["m_tiles"] * 128 >= m > (p["m_tiles"] - 1) * 128
    assert p["n_tiles"] * p["bn"] >= n > (p["n_tiles"] - 1) * p["bn"]
    assert p["n_pad"] % 16 == 0 and n <= p["n_pad"] < n + 16
    assert (p["steps"] - 1) * 64 < rows <= p["steps"] * 64
    assert p["ranges"][0][0] == 0 and p["ranges"][-1][1] == p["steps"]
    assert len(p["ranges"]) == p["split"] and all(a < b for a, b in p["ranges"])
    assert all(p["ranges"][i][1] == p["ranges"][i + 1][0] for i in range(p["split"] - 1))
    assert 1 <= p["split"] <= 8 and p["cluster"] == (1, 1, p["split"])
    r = p["reduce_rows"]
    assert (p["split"] - 1) * r < 128 <= p["split"] * r  # each CTA reduces a non-empty slice
    assert p["smem_bytes"] <= 232448 and p["stages"] >= 2
    assert p["smem_bytes"] == 1024 + max(p["stages"] * p["stage_bytes"],
                                         128 * (p["bn"] + 4) * 4) + 16 * p["stages"]
    assert p["workspace"] is None
    # boxes: x one 128-byte swizzled row of 64 bf16 by 128 tokens; the raw
    # weight 128 columns by 64 rows, bn / 128 of them
    assert p["box_x"] == (64, 128) and p["box_w"] == (128, 64)
    assert p["w_boxes"] * 128 == p["bn"] and p["box_scale"][0] == p["bn"]
    assert p["ctas"] == p["tiles"] * p["split"]


def check_plan_fills_one_wave(p, clusters=K3.H100_CLUSTERS):
    """The default plan: every cluster on the card at once where the tiles
    alone fit it, and a cluster of two or more only where the card holds
    that many clusters of two."""
    if p["tiles"] <= clusters[0]:
        assert p["tiles"] <= clusters[p["split"] - 1] and p["waves"] <= 1
        assert p["ctas"] <= clusters[0]
    assert (p["split"] > 1) == (p["tiles"] <= clusters[1] and p["steps"] > 1)


@pytest.mark.parametrize("m,k,n,qb", [(m, k, n, qb) for m, k, n in PLAN_SHAPES
                                      for qb in (16, 32, 64, 128) if k % qb == 0], ids=str)
def test_k3_plan_covers_the_output_and_fits_the_card(m, k, n, qb):
    for p in _forced_plans(K3.plan_w8, m, k, n, qb):
        check_plan_covers_the_output(p, m, k, n)
    p = K3.plan_w8(m, k, n, qb)
    assert p["stages"] >= K3.MIN_STAGES
    assert p["srows"] == max(1, 64 // qb)
    check_plan_fills_one_wave(p)


def test_k3_plan_on_the_path():
    """The T5 linears at 128 tokens on an H100 (which holds 17 clusters of
    six, 66 of two): 256-column tiles, six stages; 4096^2 and 10240 x 4096
    in clusters of six (96 CTAs), 4096 x 10240 in clusters of two (80
    CTAs); under CFG (M = 256) 4096^2 takes 128-column tiles in clusters of
    two (128 CTAs)."""
    for (k, n), (split, ctas) in zip(PATH, ((6, 96), (2, 80), (6, 96))):
        p = K3.plan_w8(128, k, n, 32)
        assert (p["bn"], p["stages"], p["split"], p["ctas"]) == (256, 6, split, ctas)
    p = K3.plan_w8(256, 4096, 4096, 32)
    assert (p["bn"], p["split"], p["ctas"]) == (128, 2, 128)
    # a card that holds fewer clusters of six takes another split
    fewer = (132, 66, 39, 30, 22, 15, 15, 15)
    assert K3.plan_w8(128, 4096, 4096, 32, fewer)["ctas"] == 96
    assert K3.plan_w8(128, 4096, 4096, 32, fewer)["split"] != 6
    with pytest.raises(ValueError, match="96-column"):
        K3.plan_w8(128, 4096, 4096, 32, bn=96)
    with pytest.raises(ValueError, match="split of 9"):
        K3.plan_w8(128, 4096, 4096, 32, split=9)
    with pytest.raises(ValueError, match="split of 2 over 1"):
        K3.plan_w8(128, 64, 4096, 32, split=2)


def magic_dequant_k3(w_q, s, qb):
    """The card's dequant: the code XOR 0x80 in the mantissa of 2^23, one
    f32 subtract of 2^23 + 128, one f32 multiply by the scale, one bf16
    rounding."""
    k, n = w_q.shape
    bits = (w_q.view(torch.uint8).to(torch.int32) ^ 0x80) | 0x4B000000
    q = bits.view(torch.float32) - 8388736.0
    return (q.reshape(k // qb, qb, n) * s[:, None, :]).reshape(k, n).to(torch.bfloat16)


def emulate_split_k(xb, w, plan, rows_of, bias, drop=None):
    """The card's schedule for any weight-only format: for every (M-tile,
    N-tile), each split's f32 partial over its 64-row steps (``rows_of``
    maps a step range to the logical K rows it covers), the partials summed
    in split order (``drop`` leaves one out, as a broken cluster sum
    would), one bf16 rounding, then the bf16 bias."""
    m, n = xb.shape[0], w.shape[1]
    y = torch.zeros(m, n, dtype=torch.bfloat16)
    seen = torch.zeros(m, n, dtype=torch.int32)
    for mt in range(plan["m_tiles"]):
        rs = slice(128 * mt, min(m, 128 * (mt + 1)))
        for nt in range(plan["n_tiles"]):
            cs = slice(plan["bn"] * nt, min(n, plan["bn"] * (nt + 1)))
            acc = None
            for z, (a, b) in enumerate(plan["ranges"]):
                ks = rows_of(a, b)
                part = xb[rs][:, ks] @ w[ks, cs].float()
                if z != drop:
                    acc = part if acc is None else acc + part
            out = acc.to(torch.bfloat16)
            if bias is not None:
                out = out + bias[cs].to(torch.bfloat16)
            y[rs, cs] = out
            seen[rs, cs] += 1
    assert bool((seen == 1).all())
    return y


def _emulate_k3(x, w_q, s, bias, qb, plan, drop=None):
    k = x.shape[1]
    w = magic_dequant_k3(w_q, s, qb)
    assert torch.equal(w, K3.dequantize(w_q, s, qb))  # bit for bit

    def rows_of(a, b):
        return torch.arange(64 * a, min(64 * b, k))

    return emulate_split_k(x.to(torch.bfloat16).float(), w, plan, rows_of, bias, drop)


EMU_SHAPES = [(128, 512, 256, 32, False), (77, 1024, 200, 16, True),
              (256, 256, 384, 64, True), (1, 2048, 128, 128, False),
              (130, 208, 72, 16, True)]


def _k3_operands(rng, m, k, n, qb, with_bias):
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    w_q, s = quantize_int8_blockwise(rng.normal(size=(k, n)) * 0.05, qb)
    bias = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)) if with_bias else None
    return x, torch.from_numpy(w_q), torch.from_numpy(s), bias


@pytest.mark.parametrize("m,k,n,qb,with_bias", EMU_SHAPES, ids=str)
def test_k3_schedule_emulated_matches_plain_and_pallas_interpret(rng, m, k, n, qb, with_bias):
    x, w_q, s, bias = _k3_operands(rng, m, k, n, qb, with_bias)
    want = K3.w8_matmul_plain(x, w_q, s, bias, qb)
    for plan in _forced_plans(K3.plan_w8, m, k, n, qb):
        got = _emulate_k3(x, w_q, s, bias, qb, plan)
        assert _rel(got.float().numpy(), want.float().numpy()) <= EMU_RTOL, plan["split"]
    jax_y = jax_w8_matmul(jnp.asarray(x.float().numpy()), jnp.asarray(w_q.numpy()),
                          jnp.asarray(s.numpy()),
                          None if bias is None else jnp.asarray(bias.numpy()),
                          out_dtype=jnp.bfloat16, interpret=True, qblock=qb)
    got = _emulate_k3(x, w_q, s, bias, qb, K3.plan_w8(m, k, n, qb))
    assert _rel(got.float().numpy(), np.asarray(jax_y, np.float32)) <= EMU_RTOL


def test_k3_schedule_without_one_split_partial_is_wrong(rng):
    """The card's broken copy leaves split 1's partial out of the cluster's
    sum: at a split shape that must fail the limit."""
    m, k, n, qb = 128, 512, 256, 32
    plan = K3.plan_w8(m, k, n, qb)
    assert plan["split"] == 8
    x, w_q, s, bias = _k3_operands(rng, m, k, n, qb, True)
    want = K3.w8_matmul_plain(x, w_q, s, bias, qb).float().numpy()
    assert _rel(_emulate_k3(x, w_q, s, bias, qb, plan).float().numpy(), want) <= EMU_RTOL
    assert _rel(_emulate_k3(x, w_q, s, bias, qb, plan, drop=1).float().numpy(),
                want) > 100 * EMU_RTOL


class _Lib:
    """A stand-in for the kernel library that records each launch."""

    def __init__(self):
        self.calls = []
        self.dequant_calls = []

    def cvt_w8_matmul(self, *args):
        self.calls.append(args)
        return 0

    cvt_w4_matmul = cvt_w8_matmul

    def cvt_w4_dequant(self, *args):
        self.dequant_calls.append(args)
        return 0


def stub_card(monkeypatch, module):
    """Meta tensors stand in for the card's: the input checks (which need a
    CUDA tensor) are stubbed, the library records launches, and every
    ``torch.empty`` is counted."""
    lib, allocs, empty = _Lib(), [], torch.empty
    monkeypatch.setattr(module, "_check", lambda *a: None)
    monkeypatch.setattr(module, "cluster_slots", lambda index: K3.H100_CLUSTERS)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: allocs.append(a) or empty(*a, **kw))
    _build.reset_launches()
    return lib, allocs


@pytest.mark.parametrize("m,k,n,qb", [(128, 4096, 4096, 32), (77, 4096, 4001, 16)], ids=str)
def test_k3_launches_once_on_its_plan_with_no_workspace(monkeypatch, m, k, n, qb):
    x = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    w_q = torch.empty(k, n, dtype=torch.int8, device="meta")
    s = torch.empty(k // qb, n, device="meta")
    bias = torch.empty(n, device="meta")
    lib, allocs = stub_card(monkeypatch, K3)
    y = K3.w8_matmul(x, w_q, s, bias, qblock=qb)
    assert y.shape == (m, n) and y.dtype == torch.bfloat16 and y.device.type == "meta"
    assert allocs == [((m, n),)]  # the output, and no workspace
    p = K3.plan_w8(m, k, n, qb)
    assert len(lib.calls) == 1 and _build.LAUNCHES[K3.NAME] == 1
    call = lib.calls[0]
    assert len(call) == len(_build._SIGNATURES["cvt_w8_matmul"])
    assert call[5:] == (m, k, n, p["n_pad"], qb, p["bn"], p["stages"], p["split"],
                        p["smem_bytes"], 7)


def test_profilers_tell_k3_from_k4_by_kernel_name():
    """The weight-only kernel's instances carry their format in the name;
    the profiler sorts them into K3 and K4, apart from cuBLAS and K7."""
    from candle_video_tpu_torch.utils import profile_dit as PD

    ns = "(anonymous namespace)::"
    w8 = f"void {ns}weight_only_matmul_kernel<{ns}W8, 2>(CUtensorMap_st, {ns}Args)"
    w4 = f"void {ns}weight_only_matmul_kernel<{ns}W4<float>, 1>(CUtensorMap_st, {ns}Args)"
    w4b = f"void {ns}weight_only_matmul_kernel<{ns}W4<__nv_bfloat16>, 2>(CUtensorMap_st)"
    assert (PD.kind_of(w8), PD.kind_of(w4), PD.kind_of(w4b)) == ("K3", "K4", "K4")
    assert PD.kind_of(f"void {ns}w8a8_matmul_kernel<256>(CUtensorMap_st)") == "K7"
    assert PD.kind_of("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul"

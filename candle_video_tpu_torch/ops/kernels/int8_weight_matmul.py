"""K3: weight-only int8 matmul (W8A16) — CUDA kernel and its plain version.

Counterpart of ``candle_video_tpu/ops/pallas/int8_weight_matmul.py``:
``y = x · bf16(f32(w_q) · s[k // qblock, n])`` with f32 accumulation, the
result in the output dtype, an optional bias added after.  The kernel is
the W8 instance of ``csrc/weight_only_matmul_hopper.cu`` (K4 is its other
format): wgmma fed by a TMA ring, split-K summed inside a thread-block
cluster; its source note says what bounds it.  Its launch is decided here,
per shape, by ``plan_weight_only`` (``plan_w8``; K4's ``plan_w4`` is the
same plan over packed rows): the output tile's width, the ring, and the
cluster of CTAs along K where the output tiles alone leave the card's SMs
idle.  TMA's row pitch must be a multiple of 16 bytes, so a payload whose
N is not is padded with zero columns per call; the output keeps its N.

CPU tensors take the plain version.  CUDA tensors launch the kernel, or,
for a qblock the kernel is not built for (``qblock_ok``: 8, 48, 96, ...),
chosen by shape before any launch, take the transient dequant route (the
weight dequantized into a transient bf16 buffer, then one bf16
``torch.matmul``; counted as ``w8_matmul_dequant``), so every qblock that
divides K runs, as in the JAX ``w8_matmul``.
``w8_matmul_auto`` keeps the JAX package's dispatch: from ``W8_XLA_MIN_M``
rows on, the transient route (the JAX package leaves that regime to XLA);
the T5 encode (M = 128) takes the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

NAME = "w8_matmul"
DEQUANT_NAME = "w8_matmul_dequant"  # the transient dequant route on the card
QBLOCK = 32
W8_XLA_MIN_M = 1024
BLOCK_M = 128            # tokens per CTA: the wgmma's N
STEP_ROWS = 64           # payload rows per ring step (K4: packed rows)
X_BOX_BYTES = 128 * 128  # one x box: 128 tokens x 64 bf16, one 128-byte swizzled row each
MAX_SPLIT = 8            # CTAs along K in one cluster: the portable cluster size
MAX_STAGES = 8
MIN_STAGES = 4           # a 256-column tile whose ring holds fewer takes 128 columns
# clusters of 1 .. 8 CTAs of the kernel (one CTA an SM) that an H100 SXM
# holds at once: cudaOccupancyMaxActiveClusters on an H100 80GB HBM3
# (chip_smoke.py logs the card's); a card's own are read by
# ``cluster_slots``
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
SMEM_LIMIT = 232448      # one block's dynamic shared memory on the card (227 KB)


def quantize_int8_blockwise(w, qblock: int = QBLOCK):
    """[.., K, N] float -> (w_q int8 [.., K, N], s f32 [.., K//qblock, N]):
    symmetric per-(group of ``qblock`` along K, column) quantization, the
    numpy producer of the JAX package, with C-contiguous payloads whatever
    the layout of ``w``."""
    w = np.ascontiguousarray(w, np.float32)
    k, n = w.shape[-2], w.shape[-1]
    if k % qblock:
        raise ValueError(f"K={k} must be a multiple of qblock={qblock}")
    g = w.reshape(*w.shape[:-2], k // qblock, qblock, n)
    s = np.maximum(np.abs(g).max(axis=-2), 1e-12) / 127.0
    q = np.clip(np.round(g / s[..., None, :]), -127, 127).astype(np.int8)
    return q.reshape(w.shape), s.astype(np.float32)


def dot_bf16(x, w_bf16, out_dtype):
    """x·w over bf16 operands with f32 accumulation, the result in
    ``out_dtype``: XLA's ``dot(bf16, bf16, preferred_element_type=f32)``
    followed by a cast.  A bf16 result is one bf16 matmul; any other takes
    the f32 product of the bf16 values, so it is not rounded to bf16."""
    xb = x.to(torch.bfloat16)
    if out_dtype == torch.bfloat16:
        return torch.matmul(xb, w_bf16)
    return torch.matmul(xb.float(), w_bf16.float()).to(out_dtype)


def dequantize(w_q, s_w, qblock: int = QBLOCK):
    """int8 [K, N] with f32 scales [K/qblock, N] -> bf16 [K, N]."""
    k, n = w_q.shape
    w = w_q.float().reshape(k // qblock, qblock, n) * s_w.float()[:, None, :]
    return w.reshape(k, n).to(torch.bfloat16)


def w8_matmul_plain(x, w_q, s_w, bias=None, qblock: int = QBLOCK, out_dtype=None):
    """Plain PyTorch version: bf16 operands, f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    w = dequantize(w_q, s_w, qblock)
    y = torch.matmul(x.to(torch.bfloat16).float(), w.float()).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


def qblock_ok(qblock: int) -> bool:
    """The group sizes the kernel takes: a multiple of 16 that divides the
    64-row step or is a multiple of it (16, 32, 64, 128, ...), so that a
    16-deep chunk lies in one group.  On the card ``w8_matmul`` /
    ``w4_matmul`` send any other qblock, before any launch, to the
    transient dequant route."""
    return qblock >= 16 and qblock % 16 == 0 and (64 % qblock == 0 or qblock % 64 == 0)



def count_dequant_route(x, name: str) -> None:
    """One more ``name`` where the transient dequant route runs on the card
    (not on the CPU, where the plain versions run)."""
    if x.device.type != "cpu":
        _build.LAUNCHES[name] += 1


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan_weight_only(m: int, payload_rows: int, n: int, qblock: int, *,
                     x_boxes: int, scale_tiles: int, scale_bytes: int,
                     clusters: tuple = H100_CLUSTERS, bn: int | None = None,
                     split: int | None = None) -> dict:
    """The launch of K3 (``x_boxes=1``, one f32 scale tile) or K4
    (``x_boxes=2``: the low and high halves of K; four scale tiles: s and m
    of both; ``payload_rows`` the packed rows K/2) for ``[m, K] · [K, n]``
    on a card that holds ``clusters[z - 1]`` clusters of z CTAs at once, a
    pure function of its arguments.  ``bn`` and ``split``
    force those choices (for measuring the alternatives); by default:

    - ``n_pad``: N rounded up to 16 (TMA's pitch rule; the wrapper pads the
      payload); ``steps``: 64-row steps over the payload, the last one
      zero-filled past its end; ``srows``: scale rows a step loads.
    - ``stages``: as many ring slots as fit in shared memory, at most
      ``MAX_STAGES``; a 256-column tile must keep ``MIN_STAGES``.
    - ``bn`` (output columns per CTA, 128 or 256) and ``split`` (CTAs along
      K per output tile, one cluster, at most ``MAX_SPLIT`` and ``steps``):
      the pair whose clusters all fit on the card at once and that puts
      the most CTAs to work; on a tie the one that pads N least, then the
      wider tile (x is read once per tile); where no split fits in one
      wave, the fewest waves.
      ``ranges`` are each split's steps; CTA z of a cluster sums rows z ·
      ``reduce_rows`` .. of every split's f32 tile.  ``workspace`` is None:
      the partials never leave shared memory.
    """
    n_pad = _ceil(n, 16) * 16
    steps = _ceil(payload_rows, STEP_ROWS)
    srows = STEP_ROWS // qblock if qblock < STEP_ROWS else 1
    m_tiles = _ceil(m, BLOCK_M)

    def stage_bytes(b):
        raw = x_boxes * X_BOX_BYTES + b * STEP_ROWS + scale_tiles * srows * b * scale_bytes
        return _ceil(raw, 1024) * 1024

    def smem(b, stages):
        return 1024 + max(stages * stage_bytes(b), BLOCK_M * (b + 4) * 4) + 16 * stages

    def stages_for(b):
        return max((s for s in range(1, MAX_STAGES + 1) if smem(b, s) <= SMEM_LIMIT), default=0)

    if bn is not None and bn not in (128, 256):
        raise ValueError(f"weight-only matmul: no kernel is built for {bn}-column tiles")
    if split is not None and not 1 <= split <= min(MAX_SPLIT, steps):
        raise ValueError(f"weight-only matmul: a split of {split} over {steps} steps")
    best = None
    for b in (128, 256) if bn is None else (bn,):
        if stages_for(b) < (MIN_STAGES if bn is None and b == 256 else 2):
            continue
        tiles = m_tiles * _ceil(n, b)
        for z in range(1, min(MAX_SPLIT, steps) + 1) if split is None else (split,):
            waves = _ceil(tiles, clusters[z - 1])
            key = (waves == 1, tiles * z if waves == 1 else -waves, n - _ceil(n, b) * b, b, -z)
            if best is None or key > best[0]:
                best = (key, b, z, tiles)
    if best is None:
        raise ValueError(f"weight-only matmul: a {bn}-column ring does not fit shared memory")
    _, bn, split, tiles = best
    stages = stages_for(bn)
    return dict(bm=BLOCK_M, bn=bn, n_pad=n_pad, step_rows=STEP_ROWS, steps=steps, srows=srows,
                stages=stages, stage_bytes=stage_bytes(bn), smem_bytes=smem(bn, stages),
                tile_bytes=BLOCK_M * (bn + 4) * 4, box_x=(64, BLOCK_M), x_boxes=x_boxes,
                box_w=(128, STEP_ROWS), w_boxes=bn // 128, box_scale=(bn, srows),
                scale_tiles=scale_tiles, m_tiles=m_tiles, n_tiles=_ceil(n, bn), tiles=tiles,
                split=split, cluster=(1, 1, split),
                ranges=[(z * steps // split, (z + 1) * steps // split) for z in range(split)],
                reduce_rows=_ceil(BLOCK_M, split), ctas=tiles * split,
                waves=tiles / clusters[split - 1], workspace=None)


@functools.lru_cache(maxsize=None)
def cluster_slots(index: int) -> tuple:
    """Clusters of 1 .. 8 CTAs of the kernel (one CTA an SM) that CUDA
    device ``index`` holds at once (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes

    out, slots = ctypes.c_int(0), []
    with torch.cuda.device(index):
        for z in range(1, MAX_SPLIT + 1):
            _build.check(_build.lib().cvt_weight_only_max_clusters(
                z, SMEM_LIMIT - 16 * 1024, ctypes.byref(out)), "max clusters")
            slots.append(out.value)
    return tuple(slots)


@functools.lru_cache(maxsize=256)
def plan_w8(m: int, k: int, n: int, qblock: int = QBLOCK, clusters: tuple = H100_CLUSTERS,
            *, bn: int | None = None, split: int | None = None) -> dict:
    """K3's launch (``plan_weight_only`` over K int8 rows, one f32 scale
    tile), cached: treat the result as read-only."""
    return plan_weight_only(m, k, n, qblock, x_boxes=1, scale_tiles=1, scale_bytes=4,
                            clusters=clusters, bn=bn, split=split)


def pad_columns(n_pad: int, *tensors):
    """Each [rows, N] tensor zero-padded to ``n_pad`` columns (a copy where
    N is short of it, the tensor itself where not)."""
    return [t if t.shape[1] == n_pad else F.pad(t, (0, n_pad - t.shape[1])) for t in tensors]


def _check(x, w_q, s_w, bias, qblock):
    m, k = x.shape
    n = w_q.shape[1]
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 or \
            s_w.dtype != torch.float32:
        raise TypeError(f"{NAME}: needs bf16 x, int8 w_q, f32 scales; got "
                        f"{x.dtype}, {w_q.dtype}, {s_w.dtype}")
    if (w_q.shape[0] != k or k % 8 or not qblock_ok(qblock) or k % qblock
            or s_w.shape != (k // qblock, n)):
        raise ValueError(f"{NAME}: x {tuple(x.shape)} w_q {tuple(w_q.shape)} "
                         f"s {tuple(s_w.shape)} qblock {qblock}: needs K % 8 == 0, K % qblock "
                         "== 0 and a qblock that is a multiple of 16 dividing 64 or a "
                         "multiple of 64")
    tensors = [x, w_q, s_w]
    if bias is not None:
        if bias.dtype != torch.bfloat16 or bias.shape != (n,):
            raise ValueError(f"{NAME}: bias must be bf16 [N]")
        tensors.append(bias)
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{NAME}: every input must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: inputs must be contiguous and 16-byte aligned")


def _launch(x, w_q, s_w, bias, qblock, plan=None):
    """One launch on ``plan`` (``plan_w8``'s for the shape unless one is
    given); the output is the only allocation, besides the zero-padded
    payload of a ragged N."""
    _check(x, w_q, s_w, bias, qblock)
    m, k = x.shape
    n = w_q.shape[1]
    if plan is None:
        plan = plan_w8(m, k, n, qblock, cluster_slots(x.device.index))
    w_q, s_w = pad_columns(plan["n_pad"], w_q, s_w)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _build.lib().cvt_w8_matmul(
        x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), m, k, n, plan["n_pad"],
        qblock, plan["bn"], plan["stages"], plan["split"], plan["smem_bytes"],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return y


def w8_matmul_dequant(x, w_q, s_w, bias=None, qblock: int = QBLOCK, out_dtype=None):
    """The transient dequant route: ``dequantize`` into a bf16 weight, then
    one bf16 matmul with f32 accumulation, the bias added after."""
    count_dequant_route(x, DEQUANT_NAME)
    out_dtype = out_dtype or x.dtype
    y = dot_bf16(x, dequantize(w_q, s_w, qblock), out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def w8_matmul(x, w_q, s_w, bias=None, qblock: int = QBLOCK, out_dtype=None):
    """x [M, K], w_q int8 [K, N], s_w f32 [K/qblock, N], bias [N] -> [M, N]."""
    if x.device.type == "cpu":
        return w8_matmul_plain(x, w_q, s_w, bias, qblock, out_dtype)
    if not qblock_ok(qblock):
        return w8_matmul_dequant(x, w_q, s_w, bias, qblock, out_dtype)
    if out_dtype not in (None, torch.bfloat16):
        raise TypeError(f"{NAME}: the kernel writes bfloat16, not {out_dtype}")
    return _launch(x, w_q, s_w, None if bias is None else bias.to(torch.bfloat16), qblock)


def w8_matmul_auto(x, w_q, s_w, bias=None, qblock: int = QBLOCK, out_dtype=None):
    """Fused kernel for small M (weight-bandwidth bound); the transient
    dequant route from ``W8_XLA_MIN_M`` rows on."""
    if x.shape[0] >= W8_XLA_MIN_M:
        return w8_matmul_dequant(x, w_q, s_w, bias, qblock, out_dtype)
    return w8_matmul(x, w_q, s_w, bias, qblock, out_dtype)

"""NumPy dequantization for GGML block formats — the port's own copy of
``candle_video_tpu/quant/dequant_np.py``.

Implements the ggml block layouts Q8_0, Q4_K, Q5_K, Q6_K, F16 and F32; the
port's GGUF reader dequantizes through these functions only.

Also provides the Q8_0, Q4_K, Q5_K and Q6_K quantizers (encode) with which
tests write random weights into GGUF files.
"""

from __future__ import annotations

import numpy as np

QK_K = 256
QK8_0 = 32

# ggml type ids
GGML_F32 = 0
GGML_F16 = 1
GGML_Q8_0 = 8
GGML_Q4_K = 12
GGML_Q5_K = 13
GGML_Q6_K = 14

TYPE_NAMES = {
    GGML_F32: "F32",
    GGML_F16: "F16",
    GGML_Q8_0: "Q8_0",
    GGML_Q4_K: "Q4_K",
    GGML_Q5_K: "Q5_K",
    GGML_Q6_K: "Q6_K",
}

BLOCK_SIZES = {  # (elements per block, bytes per block)
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_Q8_0: (QK8_0, 2 + QK8_0),
    GGML_Q4_K: (QK_K, 2 + 2 + 12 + QK_K // 2),
    GGML_Q5_K: (QK_K, 2 + 2 + 12 + QK_K // 8 + QK_K // 2),
    GGML_Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
}


def _f16(u16):
    return u16.view(np.float16).astype(np.float32)


def dequant_q8_0(raw: np.ndarray, n_elements: int) -> np.ndarray:
    nb = n_elements // QK8_0
    blocks = raw[: nb * 34].reshape(nb, 34)
    d = _f16(blocks[:, :2].copy().view(np.uint16))[:, 0]
    qs = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (qs * d[:, None]).reshape(-1)


def extract_q4_k_fields(raw: np.ndarray, n_elements: int):
    """Split Q4_K blocks into the EXACT affine decomposition
    ``w[k] = s[g]*q[k] + b[g]`` over groups of 32 along K:

    returns (q int8 [n] in 0..15, s f32 [n//32], b f32 [n//32]).

    Exactness: dequant computes ``d*sc*q - dmin*m`` with d,dmin f16 and
    sc,m 6-bit ints — both products fit f32 exactly (11+6 and 11+6 mantissa
    bits), so s=d*sc and b=-dmin*m reproduce it bit-for-bit.  This lets
    Q4_K payloads ride the int8 weight-only matmul losslessly (the bias
    term becomes a rank-G group-sum correction)."""
    raw = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    nb = n_elements // QK_K
    bs = BLOCK_SIZES[GGML_Q4_K][1]
    blocks = raw[: nb * bs].reshape(nb, bs)
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))[:, 0]
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))[:, 0]
    sc, mn = _unpack_scale_min_k4(blocks[:, 4:16])
    qs = blocks[:, 16:]

    q = np.empty((nb, QK_K), np.int8)
    for pair in range(4):
        qb = qs[:, pair * 32 : (pair + 1) * 32]
        q[:, pair * 64 : pair * 64 + 32] = (qb & 0xF).astype(np.int8)
        q[:, pair * 64 + 32 : pair * 64 + 64] = (qb >> 4).astype(np.int8)
    s = (d[:, None] * sc).astype(np.float32)  # [nb, 8]
    b = (-(dmin[:, None] * mn)).astype(np.float32)
    return q.reshape(-1), s.reshape(-1), b.reshape(-1)


def extract_q5_k_fields(raw: np.ndarray, n_elements: int):
    """Q5_K analogue of extract_q4_k_fields: q in 0..31 (5th bit from qh)."""
    raw = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    nb = n_elements // QK_K
    bs = BLOCK_SIZES[GGML_Q5_K][1]
    blocks = raw[: nb * bs].reshape(nb, bs)
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))[:, 0]
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))[:, 0]
    sc, mn = _unpack_scale_min_k4(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    qs = blocks[:, 48:]

    q = np.empty((nb, QK_K), np.int8)
    u1, u2 = 1, 2
    for pair in range(4):
        qb = qs[:, pair * 32 : (pair + 1) * 32]
        lo = (qb & 0xF) + ((qh & u1) != 0) * 16
        hi = (qb >> 4) + ((qh & u2) != 0) * 16
        q[:, pair * 64 : pair * 64 + 32] = lo.astype(np.int8)
        q[:, pair * 64 + 32 : pair * 64 + 64] = hi.astype(np.int8)
        u1 <<= 2
        u2 <<= 2
    s = (d[:, None] * sc).astype(np.float32)
    b = (-(dmin[:, None] * mn)).astype(np.float32)
    return q.reshape(-1), s.reshape(-1), b.reshape(-1)


def extract_q6_k_fields(raw: np.ndarray, n_elements: int):
    """Q6_K: symmetric ``w[k] = s[g]*q[k]`` over groups of 16 along K.

    returns (q int8 [n] in -32..31, s f32 [n//16]); s = d*scale[g] is an
    exact f32 product (f16 x int8)."""
    raw = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    nb = n_elements // QK_K
    bs = BLOCK_SIZES[GGML_Q6_K][1]
    blocks = raw[: nb * bs].reshape(nb, bs)
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    scales = blocks[:, 192:208].view(np.int8)
    d = _f16(blocks[:, 208:210].copy().view(np.uint16))[:, 0]

    q = np.empty((nb, QK_K), np.int8)
    for half in range(2):
        base = half * 128
        l_ql = ql[:, half * 64 : half * 64 + 64]
        l_qh = qh[:, half * 32 : half * 32 + 32]
        q[:, base : base + 32] = ((l_ql[:, :32] & 0xF) | ((l_qh & 0x3) << 4)).astype(np.int8) - 32
        q[:, base + 32 : base + 64] = ((l_ql[:, 32:] & 0xF) | (((l_qh >> 2) & 0x3) << 4)).astype(np.int8) - 32
        q[:, base + 64 : base + 96] = ((l_ql[:, :32] >> 4) | (((l_qh >> 4) & 0x3) << 4)).astype(np.int8) - 32
        q[:, base + 96 : base + 128] = ((l_ql[:, 32:] >> 4) | (((l_qh >> 6) & 0x3) << 4)).astype(np.int8) - 32
    s = (d[:, None] * scales.astype(np.float32)).astype(np.float32)  # [nb, 16]
    return q.reshape(-1), s.reshape(-1)


def _unpack_scale_min_k4(scales: np.ndarray):
    """scales [nb, 12] uint8 -> (sc, m) each [nb, 8] (ggml get_scale_min_k4)."""
    sc = np.empty((scales.shape[0], 8), np.float32)
    mn = np.empty((scales.shape[0], 8), np.float32)
    s = scales.astype(np.uint16)
    for j in range(8):
        if j < 4:
            sc[:, j] = (s[:, j] & 63).astype(np.float32)
            mn[:, j] = (s[:, j + 4] & 63).astype(np.float32)
        else:
            sc[:, j] = ((s[:, j + 4] & 0xF) | ((s[:, j - 4] >> 6) << 4)).astype(
                np.float32
            )
            mn[:, j] = ((s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def dequant_q4_k(raw: np.ndarray, n_elements: int) -> np.ndarray:
    nb = n_elements // QK_K
    bs = BLOCK_SIZES[GGML_Q4_K][1]
    blocks = raw[: nb * bs].reshape(nb, bs)
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))[:, 0]
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))[:, 0]
    scales = blocks[:, 4:16]
    qs = blocks[:, 16:]  # [nb, 128]

    sc, mn = _unpack_scale_min_k4(scales)
    out = np.empty((nb, QK_K), np.float32)
    for pair in range(4):  # 4 x 64 values
        q = qs[:, pair * 32 : (pair + 1) * 32]
        lo = (q & 0xF).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        d1 = d * sc[:, 2 * pair]
        m1 = dmin * mn[:, 2 * pair]
        d2 = d * sc[:, 2 * pair + 1]
        m2 = dmin * mn[:, 2 * pair + 1]
        out[:, pair * 64 : pair * 64 + 32] = d1[:, None] * lo - m1[:, None]
        out[:, pair * 64 + 32 : pair * 64 + 64] = d2[:, None] * hi - m2[:, None]
    return out.reshape(-1)


def dequant_q5_k(raw: np.ndarray, n_elements: int) -> np.ndarray:
    nb = n_elements // QK_K
    bs = BLOCK_SIZES[GGML_Q5_K][1]
    blocks = raw[: nb * bs].reshape(nb, bs)
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))[:, 0]
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))[:, 0]
    scales = blocks[:, 4:16]
    qh = blocks[:, 16:48]  # [nb, 32]
    qs = blocks[:, 48:]  # [nb, 128]

    sc, mn = _unpack_scale_min_k4(scales)
    out = np.empty((nb, QK_K), np.float32)
    u1, u2 = 1, 2
    for pair in range(4):
        q = qs[:, pair * 32 : (pair + 1) * 32]
        lo = (q & 0xF).astype(np.float32) + ((qh & u1) != 0) * 16.0
        hi = (q >> 4).astype(np.float32) + ((qh & u2) != 0) * 16.0
        d1 = d * sc[:, 2 * pair]
        m1 = dmin * mn[:, 2 * pair]
        d2 = d * sc[:, 2 * pair + 1]
        m2 = dmin * mn[:, 2 * pair + 1]
        out[:, pair * 64 : pair * 64 + 32] = d1[:, None] * lo - m1[:, None]
        out[:, pair * 64 + 32 : pair * 64 + 64] = d2[:, None] * hi - m2[:, None]
        u1 <<= 2
        u2 <<= 2
    return out.reshape(-1)


def dequant_q6_k(raw: np.ndarray, n_elements: int) -> np.ndarray:
    nb = n_elements // QK_K
    bs = BLOCK_SIZES[GGML_Q6_K][1]
    blocks = raw[: nb * bs].reshape(nb, bs)
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    scales = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(blocks[:, 208:210].copy().view(np.uint16))[:, 0]

    out = np.empty((nb, QK_K), np.float32)
    for half in range(2):  # two 128-value halves
        base = half * 128
        l_ql = ql[:, half * 64 : half * 64 + 64]
        l_qh = qh[:, half * 32 : half * 32 + 32]
        l_sc = scales[:, half * 8 : half * 8 + 8]
        q1 = ((l_ql[:, :32] & 0xF) | ((l_qh & 0x3) << 4)).astype(np.int8) - 32
        q2 = ((l_ql[:, 32:] & 0xF) | (((l_qh >> 2) & 0x3) << 4)).astype(np.int8) - 32
        q3 = ((l_ql[:, :32] >> 4) | (((l_qh >> 4) & 0x3) << 4)).astype(np.int8) - 32
        q4 = ((l_ql[:, 32:] >> 4) | (((l_qh >> 6) & 0x3) << 4)).astype(np.int8) - 32
        # scales: is = l//16 within each 32-lane strip, offsets 0,2,4,6
        for strip, q in enumerate((q1, q2, q3, q4)):
            scl = np.repeat(l_sc[:, [2 * strip, 2 * strip + 1]], 16, axis=1)
            out[:, base + strip * 32 : base + (strip + 1) * 32] = (
                d[:, None] * scl * q.astype(np.float32)
            )
    return out.reshape(-1)


def dequantize_np(type_id: int, raw: np.ndarray, n_elements: int) -> np.ndarray:
    raw = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    if type_id == GGML_F32:
        return raw[: n_elements * 4].view(np.float32).copy()
    if type_id == GGML_F16:
        return raw[: n_elements * 2].view(np.float16).astype(np.float32)
    if type_id == GGML_Q8_0:
        return dequant_q8_0(raw, n_elements)
    if type_id == GGML_Q4_K:
        return dequant_q4_k(raw, n_elements)
    if type_id == GGML_Q5_K:
        return dequant_q5_k(raw, n_elements)
    if type_id == GGML_Q6_K:
        return dequant_q6_k(raw, n_elements)
    raise ValueError(f"unsupported ggml type {type_id}")


# ---------------------------------------------------------------------------
# quantizers (tests only; Q8_0 and Q4_K)
# ---------------------------------------------------------------------------


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32).reshape(-1, QK8_0)
    amax = np.abs(x).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    qs = np.round(x * inv[:, None]).astype(np.int8)
    out = np.empty((x.shape[0], 34), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = qs.view(np.uint8)
    return out.reshape(-1)


def _simple_kquant_scales(x, nmax):
    """Simplified per-32-group scale/min selection (not bit-exact with
    ggml's optimizer; produces valid blocks for round-trip testing)."""
    groups = x.reshape(-1, 8, 32)
    gmin = np.minimum(groups.min(axis=2), 0.0)
    gmax = groups.max(axis=2)
    scale = (gmax - gmin) / nmax
    return scale, -gmin


def _kquant_affine(x, nmax: float):
    """The Q4_K / Q5_K encode shared by both: per-32-group scale and min at
    6 bits against the block's f16 ``d`` / ``dmin``, the quants in
    [0, nmax] ([nb, 8, 32] uint8) and the 12 packed scale bytes (the inverse
    of ``get_scale_min_k4``)."""
    x = x.astype(np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    scale, mins = _simple_kquant_scales(x, nmax)
    smax = scale.max(axis=1)
    mmax = mins.max(axis=1)
    d = np.where(smax > 0, smax / 63.0, 0).astype(np.float32)
    dmin = np.where(mmax > 0, mmax / 63.0, 0).astype(np.float32)
    ls = np.clip(np.round(scale / np.where(d == 0, 1, d)[:, None]), 0, 63).astype(np.uint8)
    lm = np.clip(np.round(mins / np.where(dmin == 0, 1, dmin)[:, None]), 0, 63).astype(np.uint8)
    eff_scale = d[:, None] * ls
    eff_min = dmin[:, None] * lm

    g = x.reshape(nb, 8, 32)
    q = np.clip(
        np.round((g + eff_min[:, :, None]) / np.where(eff_scale == 0, 1, eff_scale)[:, :, None]),
        0,
        nmax,
    ).astype(np.uint8)

    scales = np.zeros((nb, 12), np.uint8)
    for j in range(4):
        scales[:, j] = ls[:, j] & 63
        scales[:, j + 4] = lm[:, j] & 63
    for j in range(4, 8):
        scales[:, j + 4] = (ls[:, j] & 0xF) | ((lm[:, j] & 0xF) << 4)
        scales[:, j - 4] |= (ls[:, j] >> 4) << 6
        scales[:, j] |= (lm[:, j] >> 4) << 6
    return d, dmin, scales, q


def _low_nibbles(q):
    """Pairs of 32-groups share bytes: the low nibble group 2k, the high 2k+1."""
    qs = np.zeros((q.shape[0], 128), np.uint8)
    for pair in range(4):
        qs[:, pair * 32 : (pair + 1) * 32] = (q[:, 2 * pair] & 0xF) | (
            (q[:, 2 * pair + 1] & 0xF) << 4
        )
    return qs


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    d, dmin, scales, q = _kquant_affine(x, 15.0)
    out = np.empty((q.shape[0], BLOCK_SIZES[GGML_Q4_K][1]), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:16] = scales
    out[:, 16:] = _low_nibbles(q)
    return out.reshape(-1)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    """Encode Q5_K blocks (simplified scale search, exact layout): Q4_K's
    nibbles plus each quant's fifth bit in ``qh`` (bit 2k of byte l for
    element l of group 2k, bit 2k+1 for group 2k+1)."""
    d, dmin, scales, q = _kquant_affine(x, 31.0)
    qh = np.zeros((q.shape[0], 32), np.uint8)
    for pair in range(4):
        qh |= (q[:, 2 * pair] >> 4) << (2 * pair)
        qh |= (q[:, 2 * pair + 1] >> 4) << (2 * pair + 1)
    out = np.empty((q.shape[0], BLOCK_SIZES[GGML_Q5_K][1]), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:16] = scales
    out[:, 16:48] = qh
    out[:, 48:] = _low_nibbles(q)
    return out.reshape(-1)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    """Encode Q6_K blocks (simplified scale search, exact layout): 16 groups
    of 16 with an int8 scale each against the block's f16 ``d``, quants in
    [-32, 31] stored +32 as 4 low bits (``ql``) and 2 high bits (``qh``)."""
    x = x.astype(np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    groups = x.reshape(nb, 16, 16)
    gscale = np.abs(groups).max(axis=2) / 31.0
    smax = gscale.max(axis=1)
    d = np.where(smax > 0, smax / 127.0, 0).astype(np.float32)
    sc = np.clip(np.round(gscale / np.where(d == 0, 1, d)[:, None]), -128, 127).astype(np.int8)
    eff = d[:, None] * sc.astype(np.float32)
    q = np.clip(np.round(groups / np.where(eff == 0, 1, eff)[:, :, None]), -32, 31)
    qflat = (q.astype(np.int8) + 32).reshape(nb, QK_K).astype(np.uint8)  # 0..63

    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        s1, s2, s3, s4 = (qflat[:, half * 128 + 32 * k : half * 128 + 32 * (k + 1)]
                          for k in range(4))
        ql[:, half * 64 : half * 64 + 32] = (s1 & 0xF) | ((s3 & 0xF) << 4)
        ql[:, half * 64 + 32 : half * 64 + 64] = (s2 & 0xF) | ((s4 & 0xF) << 4)
        qh[:, half * 32 : half * 32 + 32] = (
            (s1 >> 4) | ((s2 >> 4) << 2) | ((s3 >> 4) << 4) | ((s4 >> 4) << 6)
        )

    out = np.empty((nb, BLOCK_SIZES[GGML_Q6_K][1]), np.uint8)
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.reshape(-1)

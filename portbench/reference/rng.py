"""The two random streams an LTX-Video request draws from its seed, written
out plainly in NumPy for the reference.

- ``pcg32_randn``: the initial latents.  PCG32 (XSH-RR, the stream set up by
  ``state = 0; inc = 2·inc + 1; next; state += seed; next``), uniforms
  ``(u32 >> 8)·2**-24`` and Box-Muller pairs ``(r·cos, r·sin)`` in float32;
  a pair whose first uniform is at most 1e-7 is redrawn, which shifts the
  pairing of the rest of the stream by one draw.
- ``threefry_normal``: ``jax.random.normal(PRNGKey(seed), shape)`` in
  float32 (threefry2x32 with 20 rounds over the flat index, the two output
  words xor-ed, 23 mantissa bits to a uniform in (-1, 1), ``sqrt(2)·erfinv``),
  the decode noise.
"""

from __future__ import annotations

import numpy as np

_MULT = 6364136223846793005
_M64 = (1 << 64) - 1


def _pcg_states(state: int, inc: int, n: int) -> np.ndarray:
    """The n LCG states starting at ``state``, by doubling: the states
    [m, 2m) are the states [0, m) advanced m steps at once."""
    out = np.empty(n, np.uint64)
    out[0] = state
    a, c, m = np.uint64(_MULT), np.uint64(inc), 1
    with np.errstate(over="ignore"):
        while m < n:
            take = min(m, n - m)
            out[m:m + take] = out[:take] * a + c
            c = a * c + c
            a = a * a
            m *= 2
    return out


def _pcg_output(states: np.ndarray) -> np.ndarray:
    xs = (((states >> np.uint64(18)) ^ states) >> np.uint64(27)).astype(np.uint32)
    rot = (states >> np.uint64(59)).astype(np.uint32)
    return (xs >> rot) | (xs << ((np.uint32(32) - rot) & np.uint32(31)))


def pcg32_randn(seed: int, shape, inc: int = 0) -> np.ndarray:
    """float32 Gaussians of ``shape`` from PCG32 seeded with ``seed``."""
    count = int(np.prod(shape))
    inc = ((inc << 1) | 1) & _M64
    state = (0 * _MULT + inc) & _M64
    state = ((state + seed) & _M64) * _MULT + inc & _M64
    pairs = (count + 1) // 2
    draws = 2 * pairs + 64
    u = (_pcg_output(_pcg_states(state, inc, draws)) >> np.uint32(8)).astype(np.float32)
    u *= np.float32(5.9604645e-8)
    u1_at = np.arange(pairs, dtype=np.int64) * 2
    # each redraw of a first uniform moves every later pair one draw on
    for bad in np.flatnonzero(u <= np.float32(1e-7)):
        hit = np.searchsorted(u1_at, bad)
        if hit < pairs and u1_at[hit] == bad:
            u1_at[hit:] += 1
    if u1_at[-1] + 1 >= draws:
        raise ValueError("too many PCG32 redraws for the margin")
    u1, u2 = u[u1_at], u[u1_at + 1]
    mag = np.sqrt(np.float32(-2.0) * np.log(u1), dtype=np.float32)
    ang = (np.float32(2.0) * np.float32(np.pi)) * u2
    out = np.empty(2 * pairs, np.float32)
    out[0::2] = mag * np.cos(ang, dtype=np.float32)
    out[1::2] = mag * np.sin(ang, dtype=np.float32)
    return out[:count].reshape(shape)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter words under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def threefry_normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), shape)`` in float32 (erfinv in
    float64, so within a few float32 ulp of JAX's)."""
    from scipy.special import erfinv

    seed = int(seed) & ((1 << 64) - 1)
    key = (seed >> 32, seed & 0xFFFFFFFF)
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi, lo = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = hi ^ lo
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo_f = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo_f, u * (np.float32(1.0) - lo_f) + lo_f)
    return (np.sqrt(2.0) * erfinv(u.astype(np.float64))).astype(np.float32).reshape(shape)

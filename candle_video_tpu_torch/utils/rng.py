"""The JAX package's random streams: PCG32 on the host, ``jax.random`` on
the device.

- ``Pcg32``: the deterministic PCG32 RNG with Box-Muller Gaussian sampling,
  the port's own copy of ``candle_video_tpu/utils/rng.py``.  It stays on the
  host, as in the JAX package ("host-side by contract").
- ``prng_key``, ``split`` and ``normal``: ``jax.random.PRNGKey``,
  ``jax.random.split`` and ``jax.random.normal`` (float32 or bfloat16) in
  NumPy, in the form the JAX package draws them (the default threefry2x32
  generator with ``jax_threefry_partitionable`` on).  Keys are ``(hi, lo)``
  pairs of ``np.uint32``; seeds of 2**32 and above differ from JAX's when
  JAX runs without x64.  ``normal`` is the host reference.
- ``normal_on`` and ``rows_normal``: the same draws made where the tensor
  lives, through R1 (``ops/kernels/threefry_normal.py``: the CUDA kernel on
  a GPU, its plain PyTorch version on the CPU), one launch for any number
  of rows.  Every ``jax.random`` draw of the port's pipelines, VAE, server
  and SVD goes through them; keys are still split on the host, which is
  microseconds of scalar work.

Bit-exact re-implementation of the reference's deterministic RNG
(reference: src/utils/deterministic_rng.rs:6-82) so that initial latents are
reproducible across the Rust/CUDA and JAX/TPU implementations.  The stream is
generated host-side in NumPy (vectorised via log-doubling of the LCG state
advance) and uploaded once — the reference also builds latents on the CPU and
uploads (deterministic_rng.rs:61-81).
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_PCG_MULT = np.uint64(6364136223846793005)
_U64 = np.uint64
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


class Pcg32:
    """PCG32 (XSH-RR) generator matching the reference implementation.

    ``new(seed, inc)`` seeding sequence: state=0; inc=(inc<<1)|1; next_u32();
    state += seed; next_u32().  (deterministic_rng.rs:12-21)
    """

    def __init__(self, seed: int, inc: int = 0):
        err = np.geterr()
        np.seterr(over="ignore")
        try:
            self.inc = _U64((int(inc) << 1 | 1) & 0xFFFFFFFFFFFFFFFF)
            self.state = _U64(0)
            self._advance_scalar()
            self.state = _U64((int(self.state) + int(seed)) & 0xFFFFFFFFFFFFFFFF)
            self._advance_scalar()
        finally:
            np.seterr(**err)

    def _advance_scalar(self) -> None:
        self.state = _U64(
            (int(self.state) * int(_PCG_MULT) + int(self.inc)) & 0xFFFFFFFFFFFFFFFF
        )

    # -- scalar API (exact mirror of the reference) -------------------------

    def next_u32(self) -> int:
        old = int(self.state)
        self._advance_scalar()
        xorshifted = (((old >> 18) ^ old) >> 27) & 0xFFFFFFFF
        rot = (old >> 59) & 31
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & 0xFFFFFFFF

    def next_f32(self) -> float:
        # (u32 >> 8) * 2^-24 in f32 (deterministic_rng.rs:36-40)
        return float(np.float32(self.next_u32() >> 8) * np.float32(5.9604645e-8))

    def next_gaussian(self) -> tuple[float, float]:
        while True:
            u1 = np.float32(self.next_f32())
            if u1 > np.float32(1e-7):
                break
        u2 = np.float32(self.next_f32())
        mag = np.sqrt(np.float32(-2.0) * np.log(u1))
        two_pi_u2 = np.float32(2.0) * np.float32(np.pi) * u2
        z0 = np.float32(mag * np.cos(two_pi_u2))
        z1 = np.float32(mag * np.sin(two_pi_u2))
        return float(z0), float(z1)

    # -- vectorised stream --------------------------------------------------

    def _raw_u32_block(self, n: int) -> np.ndarray:
        """Generate the next ``n`` u32 outputs, advancing internal state.

        Uses log-doubling: from states[:m] compute states[m:2m] via the
        m-step LCG composition  s -> A_m * s + C_m  (all mod 2^64).
        """
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        err = np.geterr()
        np.seterr(over="ignore")
        try:
            states = np.empty(n, dtype=np.uint64)
            states[0] = self.state
            m = 1
            a_m = _PCG_MULT
            c_m = self.inc
            while m < n:
                take = min(m, n - m)
                states[m : m + take] = states[:take] * a_m + c_m
                # compose: (A,C) o (A,C) = (A*A, A*C + C)
                c_m = a_m * c_m + c_m
                a_m = a_m * a_m
                m += m
            # advance internal state by n steps: s_n = A_n*s0 + C_n via last state
            self.state = states[-1] * _PCG_MULT + self.inc
            # XSH-RR output function
            xorshifted = (((states >> _U64(18)) ^ states) >> _U64(27)).astype(
                np.uint32
            )
            rot = (states >> _U64(59)).astype(np.uint32)
            neg = (np.uint32(0) - rot) & np.uint32(31)
            out = (xorshifted >> rot) | (xorshifted << neg)
            return out
        finally:
            np.seterr(**err)

    def _f32_block(self, n: int) -> np.ndarray:
        u = self._raw_u32_block(n)
        return ((u >> np.uint32(8)).astype(np.float32)) * np.float32(5.9604645e-8)

    def randn(self, shape) -> np.ndarray:
        """Gaussian tensor via Box-Muller, bit-exact vs the scalar reference.

        Pairs (z0, z1) are produced from consecutive (u1, u2) draws with the
        rare u1 <= 1e-7 rejection replayed exactly (deterministic_rng.rs:44-58,
        61-81).
        """
        shape = tuple(int(s) for s in shape)
        count = int(np.prod(shape)) if shape else 1
        n_pairs = (count + 1) // 2
        out = np.empty(2 * n_pairs, dtype=np.float32)

        filled = 0
        while filled < n_pairs:
            need = n_pairs - filled
            block = self._f32_block(2 * need)
            u1 = block[0::2]
            u2 = block[1::2]
            bad = np.nonzero(u1 <= np.float32(1e-7))[0]
            valid = int(bad[0]) if bad.size else need
            if valid:
                v1 = u1[:valid].astype(np.float32)
                v2 = u2[:valid].astype(np.float32)
                mag = np.sqrt(np.float32(-2.0) * np.log(v1), dtype=np.float32)
                ang = (np.float32(2.0) * np.float32(np.pi)) * v2
                base = filled * 2
                out[base : base + 2 * valid : 2] = mag * np.cos(ang, dtype=np.float32)
                out[base + 1 : base + 2 * valid : 2] = mag * np.sin(
                    ang, dtype=np.float32
                )
                filled += valid
            if valid < need:
                # Rejection hit: rewind the generator to just after the pair
                # that failed and replay that single pair with the scalar path.
                # We consumed 2*need draws; unused = everything after the two
                # draws of the failing pair... simpler: re-seat the stream by
                # replaying scalar from the failing pair onward.
                consumed_ok = 2 * valid
                # rewind by (2*need - consumed_ok) outputs
                self._rewind(2 * need - consumed_ok)
                z0, z1 = self.next_gaussian()
                base = filled * 2
                out[base] = z0
                out[base + 1] = z1
                filled += 1

        return out[:count].reshape(shape)

    def _rewind(self, steps: int) -> None:
        """Step the LCG backwards (multiplier is odd => invertible mod 2^64)."""
        err = np.geterr()
        np.seterr(over="ignore")
        try:
            inv = pow(int(_PCG_MULT), -1, 1 << 64)
            s = int(self.state)
            for _ in range(steps):
                s = (inv * ((s - int(self.inc)) & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
            self.state = _U64(s)
        finally:
            np.seterr(**err)



# -- jax.random: threefry2x32 (Salmon et al. 2011, 20 rounds) ---------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` under ``key``."""
    with np.errstate(over="ignore"):
        ks = (_U32(key[0]), _U32(key[1]), _U32(key[0]) ^ _U32(key[1]) ^ _U32(0x1BD11BDA))
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
                x1 = x1 ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as (hi, lo) words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _U32(seed >> 32), _U32(seed & 0xFFFFFFFF)


def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)``: key i is threefry of the counter
    (0, i)."""
    hi, lo = _threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return [(hi[i], lo[i]) for i in range(num)]


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"),
# coefficients highest power first, for w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x):
    f = np.float32
    w = -np.log1p(-x * x)
    small = w < f(5)
    ws, wl = w - f(2.5), np.sqrt(np.maximum(w, f(5))) - f(3)
    ps, pl = np.full_like(x, f(_ERFINV_SMALL[0])), np.full_like(x, f(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        ps, pl = f(cs) + ps * ws, f(cl) + pl * wl
    return np.where(small, ps, pl) * x


def round_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), kept
    as float32: NumPy has no bfloat16, and these convert to
    ``torch.bfloat16`` exactly."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    up = ((bits >> _U32(16)) & _U32(1)) + _U32(0x7FFF)
    with np.errstate(over="ignore"):
        out = (bits + up) & _U32(0xFFFF0000)
    return np.where(np.isnan(bits.view(np.float32)), bits | _U32(0x00400000),
                    out).view(np.float32)


def _bits(key, n: int):
    """The 32 random bits of each of ``n`` values: the two threefry words of
    the flat index, xor-ed."""
    idx = np.arange(n, dtype=np.uint64)
    hi, lo = _threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                           (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return hi ^ lo


def normal(key, shape, dtype=np.float32) -> np.ndarray:
    """``jax.random.normal(key, shape, dtype)`` for float32 and bfloat16
    (``dtype`` a NumPy dtype, ``"bfloat16"`` or ``torch.bfloat16``).

    float32: a uniform in [nextafter(-1, 0), 1) from the top 23 of the 32
    bits, then ``sqrt(2)·erfinv``; agrees with JAX to a few float32 ulp (the
    erfinv's rounding).  bfloat16 is another stream, not the float32 draw
    rounded: the uniform takes 7 mantissa bits from the low byte of the 32
    bits, each step rounds to bfloat16 (the range ``1 - nextafter(-1, 0)``
    to 2), the erfinv runs in float32 on the bfloat16 uniform and rounds,
    and the product with bfloat16 ``sqrt(2)`` rounds once more.  Returned
    as float32 holding bfloat16 values."""
    shape = tuple(int(s) for s in shape)
    name = getattr(dtype, "__name__", None) or str(dtype).removeprefix("torch.")
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"normal: dtype {dtype} is not float32 or bfloat16")
    bits = _bits(key, int(np.prod(shape)))
    if name == "bfloat16":
        f = np.float32
        mant = ((bits & _U32(0xFF)) >> _U32(1)) | _U32(0x3F80)
        u01 = (mant << _U32(16)).view(np.float32) - f(1.0)
        lo_f = f(-0.99609375)  # nextafter(-1, 0) in bfloat16
        u = np.maximum(lo_f, round_bf16(round_bf16(u01 * f(2.0)) + lo_f))
        z = round_bf16(f(1.4140625) * round_bf16(_erfinv_f32(u)))  # bfloat16 sqrt(2)
        return z.reshape(shape)
    u01 = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo_f = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo_f, u01 * (np.float32(1.0) - lo_f) + lo_f)
    return (np.float32(np.sqrt(2.0)) * _erfinv_f32(u)).astype(np.float32).reshape(shape)


def normal_on(keys, shape, dtype=None, device="cpu"):
    """``jax.random.normal`` drawn on ``device`` (a torch tensor of
    ``shape``, float32 unless ``dtype`` is ``torch.bfloat16``) by one R1
    launch.  ``keys`` is one ``(hi, lo)`` key for the whole shape, or a
    list of keys, one per row of the leading axis: row r is then
    ``jax.random.normal(keys[r], shape[1:])``, as JAX's ``vmap`` over keys
    draws it."""
    import torch

    from ..ops.kernels.threefry_normal import threefry_normal

    shape = tuple(int(s) for s in shape)
    rows = keys if isinstance(keys, list) else [keys]
    if isinstance(keys, list) and (not shape or len(keys) != shape[0]):
        raise ValueError(f"normal_on: {len(keys)} keys for the rows of shape {shape}")
    n = int(np.prod(shape[1:] if isinstance(keys, list) else shape))
    return threefry_normal(rows, n, dtype or torch.float32, device).reshape(shape)


def rows_normal(seeds, shape, offset: int = 0, device="cpu"):
    """The JAX server's ``_rows_normal_jit``: for each seed s one float32
    row ``jax.random.normal(PRNGKey(s + offset), shape)``, stacked on a new
    leading axis that takes the place of ``shape``'s leading 1 (``shape``
    is the single-request shape [1, ...]), all in one launch on
    ``device``.  Seeds keep their full width (JAX's server truncates them
    to uint32)."""
    shape = tuple(int(s) for s in shape)
    if not shape or shape[0] != 1:
        raise ValueError(f"rows_normal: shape {shape} must be a single-request [1, ...] shape")
    keys = [prng_key(int(s) + offset) for s in seeds]
    return normal_on(keys, (len(keys),) + shape[1:], device=device)

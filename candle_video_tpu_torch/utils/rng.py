"""Deterministic PCG32 RNG with Box-Muller Gaussian sampling — the port's own
copy of ``candle_video_tpu/utils/rng.py`` (the NumPy generator only).

Bit-exact re-implementation of the reference's deterministic RNG
(reference: src/utils/deterministic_rng.rs:6-82) so that initial latents are
reproducible across the Rust/CUDA and JAX/TPU implementations.  The stream is
generated host-side in NumPy (vectorised via log-doubling of the LCG state
advance) and uploaded once — the reference also builds latents on the CPU and
uploads (deterministic_rng.rs:61-81).
"""

from __future__ import annotations

import numpy as np

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


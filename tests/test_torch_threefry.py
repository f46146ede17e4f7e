"""R1 (``ops/kernels/threefry_normal.py``): the plain PyTorch version of the
on-card ``jax.random.normal`` against the host reference ``utils/rng.py``
and against JAX, on the CPU; the wrapper's launch with a stand-in library;
the kernel itself on a card (marked ``cuda``, skipped without one).

Tolerances: the counters, keys, bits and uniforms are equal bit for bit.
float32 normals agree within atol 1e-5, not bit for bit: torch's float32
``log1p`` and NumPy's round differently in about one value in eight, which
moves 1.03% of the normals by 1 to 6 float32 ulp (4,000,000 values of seeds
0-9: largest difference 7.15e-7); against JAX (XLA's own log1p and fused
erfinv) 4.7% differ, by at most 7.15e-7, within the limit
``tests/test_torch_rng.py`` states.  bfloat16 normals are equal bit for
bit, to NumPy's and to JAX's, on the same 4,000,000 values: a float32 ulp in
the erfinv moved no bfloat16 rounding."""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu import serving as JS
from candle_video_tpu_torch.ops.kernels import _build
from candle_video_tpu_torch.ops.kernels import threefry_normal as TN
from candle_video_tpu_torch.utils import rng as R

torch.set_num_threads(2)

F32_ATOL = 1e-5
SEEDS = (0, 1, 42, 2**31 + 5)
SHAPES = ((1,), (7,), (3, 5, 11), (1, 8, 2, 16, 24), (1, 3, 37, 41))


def _np_uniform(bits, bf16: bool):
    """``utils/rng.normal``'s uniform, stage by stage."""
    f = np.float32
    if bf16:
        mant = ((bits & np.uint32(0xFF)) >> np.uint32(1)) | np.uint32(0x3F80)
        u01 = (mant << np.uint32(16)).view(np.float32) - f(1.0)
        lo = f(-0.99609375)
        return np.maximum(lo, R.round_bf16(R.round_bf16(u01 * f(2.0)) + lo))
    u01 = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - f(1.0)
    lo = np.nextafter(f(-1.0), f(0.0))
    return np.maximum(lo, u01 * (f(1.0) - lo) + lo)


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_threefry_and_bits_equal_the_host_reference(seed):
    key = R.prng_key(seed)
    x0 = np.arange(0, 3000, 3, dtype=np.uint32)
    x1 = np.arange(1000, dtype=np.uint32) * np.uint32(2654435761)
    want = R._threefry2x32(key, x0, x1)
    got = TN.threefry2x32_plain(int(key[0]), int(key[1]), torch.from_numpy(x0.astype(np.int64)),
                                torch.from_numpy(x1.astype(np.int64)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), w)
    # split's keys are the threefry of (0, i): the plain version gives them too
    hi, lo = TN.threefry2x32_plain(int(key[0]), int(key[1]), torch.zeros(4, dtype=torch.int64),
                                   torch.arange(4))
    assert [(int(a), int(b)) for a, b in zip(hi, lo)] == [
        (int(a), int(b)) for a, b in R.split(key, 4)]
    n = 10_007
    np.testing.assert_array_equal(TN.bits_plain(key, n).numpy().astype(np.uint32),
                                  R._bits(key, n))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_uniforms_equal_the_host_reference(bf16):
    for seed in SEEDS:
        key = R.prng_key(seed)
        bits = R._bits(key, 50_000)
        got = TN.uniform_plain(TN.bits_plain(key, 50_000),
                               torch.bfloat16 if bf16 else torch.float32).numpy()
        np.testing.assert_array_equal(got, _np_uniform(bits, bf16))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_normals_against_the_host_reference(seed, shape):
    key = R.prng_key(seed)
    n = int(np.prod(shape))
    f32 = TN.threefry_normal(key, n)[0].numpy()
    np.testing.assert_allclose(f32, R.normal(key, shape).reshape(-1), atol=F32_ATOL, rtol=0)
    bf16 = TN.threefry_normal(key, n, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and bf16.shape == (1, n)
    np.testing.assert_array_equal(bf16[0].float().numpy(),
                                  R.normal(key, shape, "bfloat16").reshape(-1))


def test_float32_difference_from_the_host_is_log1p_ulps():
    """The stated limit's reading: on 400,000 values the float32 normals
    differ from NumPy's in ~1% of values, by at most 7.2e-7 (a few ulp), and
    every difference comes from ``log1p``: with NumPy's log1p values fed
    through the plain erfinv the two agree bit for bit."""
    key = R.prng_key(3)
    n = 400_000
    got = TN.threefry_normal(key, n)[0].numpy()
    want = R.normal(key, (n,))
    diff = np.abs(got - want)
    assert diff.max() <= 1e-6 and (diff > 0).mean() < 0.03
    u = _np_uniform(R._bits(key, n), False)
    w_np = -np.log1p(-u * u)
    w_t = (-torch.log1p(-torch.from_numpy(u) * torch.from_numpy(u))).numpy()
    changed = w_np != w_t
    assert not (diff[~changed] > 0).any()


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_plain_normals_against_jax(seed):
    """JAX (``jax_threefry_partitionable`` on) draws of odd shapes: float32
    within atol 1e-5, bfloat16 bit for bit."""
    for shape in SHAPES:
        key = R.prng_key(seed)
        n = int(np.prod(shape))
        jkey = jax.random.PRNGKey(seed)
        np.testing.assert_allclose(
            R.normal_on(key, shape).numpy(),
            np.asarray(jax.random.normal(jkey, shape, jnp.float32)), atol=F32_ATOL, rtol=0)
        got = R.normal_on(key, shape, torch.bfloat16)
        assert got.shape == shape and got.dtype == torch.bfloat16 and got.numel() == n
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jax.random.normal(jkey, shape, jnp.bfloat16).astype(jnp.float32)))


def test_rows_are_independent_draws_of_their_keys():
    """One call of R rows equals R calls of one row each; ``normal_on`` with
    a list of keys gives row r ``normal(keys[r], shape[1:])``, as a vmap
    over keys does."""
    keys = [R.prng_key(s) for s in (4, 5, 2**33 + 1)]
    for dtype in (torch.float32, torch.bfloat16):
        rows = TN.threefry_normal(keys, 1001, dtype)
        assert rows.shape == (3, 1001)
        for r, k in enumerate(keys):
            assert torch.equal(rows[r], TN.threefry_normal(k, 1001, dtype)[0])
        shaped = R.normal_on(keys, (3, 7, 11), dtype)
        for r, k in enumerate(keys):
            assert torch.equal(shaped[r], R.normal_on(k, (7, 11), dtype))
    with pytest.raises(ValueError, match="keys for the rows"):
        R.normal_on(keys, (2, 5))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TN.threefry_normal(keys[0], 5, torch.float16)
    with pytest.raises(ValueError, match="32-bit"):
        TN.threefry_normal([(1 << 32, 0)], 5)


@pytest.mark.parametrize("offset", [0, 2])
def test_rows_normal_against_the_jax_servers_rows(offset):
    """``rows_normal`` against JAX ``serving._rows_normal_jit`` (one jitted
    vmap over uint32 seeds), on the CPU: float32 within atol 1e-5."""
    seeds = [5, 6, 77]
    shape = (1, 8, 2, 4, 6)
    got = R.rows_normal(seeds, shape, offset)
    assert got.shape == (3,) + shape[1:] and got.dtype == torch.float32
    want = np.asarray(JS._rows_normal_jit(jnp.asarray([s + offset for s in seeds], jnp.uint32),
                                          shape))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    for r, s in enumerate(seeds):
        assert torch.equal(got[r:r + 1], R.normal_on(R.prng_key(s + offset), shape))
    with pytest.raises(ValueError, match="single-request"):
        R.rows_normal(seeds, (2, 8))


class _Lib:
    """A stand-in for the kernel library that records R1's launches and
    the keys each carried."""

    def __init__(self):
        self.calls = []

    def cvt_threefry_normal(self, keys, rows, n, bf16, out, stream):
        words = ctypes.cast(keys, ctypes.POINTER(ctypes.c_uint32))[:2 * rows]
        self.calls.append((words, rows, n, bf16, out, stream))
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_launches_one_kernel_per_128_rows(monkeypatch, dtype):
    """Off the CPU the wrapper launches the kernel, never the plain
    version: 200 rows are two launches (128 + 72), each carrying its rows'
    (hi, lo) words, counted once each.  Meta tensors stand in for the
    card's (the device check, which needs a CUDA tensor, is stubbed)."""
    lib = _Lib()
    monkeypatch.setattr(TN, "_check", lambda out: None)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(TN, "threefry_normal_plain", None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7})())
    _build.reset_launches()
    keys = [R.prng_key(s) for s in range(200)]
    out = TN.threefry_normal(keys, 333, dtype, "meta")
    assert out.shape == (200, 333) and out.dtype == dtype and out.device.type == "meta"
    assert [c[1:4] for c in lib.calls] == [(128, 333, int(dtype == torch.bfloat16)),
                                          (72, 333, int(dtype == torch.bfloat16))]
    flat = [int(w) for k in keys for w in k]
    assert lib.calls[0][0] == flat[:256] and lib.calls[1][0] == flat[256:]
    assert all(c[5] == 7 for c in lib.calls)
    assert _build.LAUNCHES[TN.NAME] == 2
    assert len(_build._SIGNATURES["cvt_threefry_normal"]) == 6


def test_wrapper_refuses_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel for device meta"):
        TN.threefry_normal(R.prng_key(0), 8, torch.float32, "meta")


@pytest.mark.cuda
def test_wrapper_raises_without_the_kernel_library(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with the library
    missing the draw raises, and nothing falls back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: R1 is CUDA C++ with no CPU mode")

    def missing():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")

    monkeypatch.setattr(_build, "lib", missing)
    monkeypatch.setattr(TN, "threefry_normal_plain", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        R.normal_on(R.prng_key(0), (4, 5), device="cuda")


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: R1 is CUDA C++ with no CPU mode")
    keys = [R.prng_key(s) for s in (1, 2)]
    for dtype in (torch.float32, torch.bfloat16):
        got = TN.threefry_normal(keys, 638_976, dtype, "cuda")
        want = TN.threefry_normal_plain(keys, 638_976, dtype, "cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, want), dtype

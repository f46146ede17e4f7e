"""The port's NumPy ``jax.random`` (``utils/rng.py``: ``prng_key``,
``split``, ``normal``) against ``jax.random`` itself, and the seeded draws
of the LTX and SVD pipelines against the JAX package's key sequence.

Keys must be equal bit for bit; float32 normals agree within atol 1e-5
(the erfinv polynomial's rounding, a few ulp); bfloat16 normals (another
stream: 8 random bits a value) are bit-equal.  Seeds stay below 2**32:
above it the JAX key depends on x64 mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from candle_video_tpu_torch.utils import rng as R

SEEDS = [0, 42, 2**31 - 1]
SHAPES = [(7,), (3, 5, 7), (1, 8, 3, 2, 3), (2, 129, 11)]


def _key_words(key):
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
                      else key, np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert np.array_equal(np.asarray(R.prng_key(seed), np.uint32),
                          _key_words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_matches_jax(seed, shape):
    got = R.normal(R.prng_key(seed), shape)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", SEEDS + [42 + 3, 7 + 3 + 1])  # the i2v anchors' keys
@pytest.mark.parametrize("shape", SHAPES + [(1, 128, 1, 16, 24)], ids=str)
@pytest.mark.parametrize("dtype", ["bfloat16", torch.bfloat16], ids=["str", "torch"])
def test_normal_bf16_matches_jax_bit_for_bit(seed, shape, dtype):
    got = R.normal(R.prng_key(seed), shape, dtype)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.bfloat16)
                      .astype(jnp.float32))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(torch.from_numpy(got).bfloat16().float().numpy(), got)


def test_normal_bf16_is_its_own_stream_and_dtypes():
    key = R.prng_key(45)
    bf16 = R.normal(key, (64,), "bfloat16")
    f32 = R.normal(key, (64,))
    assert np.abs(bf16 - R.round_bf16(f32)).max() > 0.5  # not the f32 draw rounded
    np.testing.assert_allclose(bf16[:3], [-0.15234375, 0.5390625, 0.28320312], atol=0)
    for dt in (np.float32, "float32", torch.float32, np.dtype("float32")):
        np.testing.assert_array_equal(R.normal(key, (5,), dt), f32[:5])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        R.normal(key, (5,), torch.float16)


def test_round_bf16_ties_to_even():
    x = np.array([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -2.5, 3.0e38, np.inf], np.float32)
    np.testing.assert_array_equal(
        R.round_bf16(x), torch.from_numpy(x).bfloat16().float().numpy())
    assert np.isnan(R.round_bf16(np.array([np.nan], np.float32))).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_matches_jax(seed, num):
    got = R.split(R.prng_key(seed), num)
    want = _key_words(jax.random.split(jax.random.PRNGKey(seed), num))
    assert np.array_equal(np.asarray(got, np.uint32), want)
    # a draw from a split key, and a chain of splits as the stochastic loop makes
    np.testing.assert_allclose(
        R.normal(got[-1], (4, 33)),
        np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(seed), num)[-1],
                                     (4, 33), jnp.float32)), atol=1e-5, rtol=0)
    key, jkey = R.prng_key(seed + 1), jax.random.PRNGKey(seed + 1)
    for _ in range(3):
        key, sub = R.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_allclose(R.normal(sub, (2, 9)),
                                   np.asarray(jax.random.normal(jsub, (2, 9), jnp.float32)),
                                   atol=1e-5, rtol=0)


def test_normal_is_standard_normal():
    z = R.normal(R.prng_key(7), (200_000,))
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    assert np.isfinite(z).all()


def test_ltx_stochastic_steps_draw_the_jax_chain(monkeypatch):
    """denoise_loop's step noise is ``normal(split(key)[1])`` along the
    chain from ``noise_key``, as the JAX loop's ``key, sub = split(key)``."""
    from candle_video_tpu_torch.models.ltx_video import pipeline as PP
    from candle_video_tpu_torch.models.ltx_video import scheduler as PS

    drawn = []
    step = PS.step
    monkeypatch.setattr(PS, "step", lambda lat, pred, s, sn, stochastic=False, noise=None:
                        drawn.append(noise) or step(lat, pred, s, sn, stochastic=stochastic,
                                                    noise=noise))
    sched = PS.set_timesteps(PS.FlowMatchEulerSchedulerConfig(stochastic_sampling=True),
                             num_inference_steps=3, sigmas=[1.0, 0.7, 0.4], mu=0.0)
    lat = torch.zeros(1, 6, 4)
    PP.denoise_loop(lambda x, *a, **k: torch.zeros_like(x), lat, None, None, sched,
                    None, None, stochastic=True, noise_key=R.prng_key(5 + 1))
    key = jax.random.PRNGKey(6)
    assert len(drawn) == 3
    for noise in drawn:
        key, sub = jax.random.split(key)
        np.testing.assert_allclose(noise.numpy(),
                                   np.asarray(jax.random.normal(sub, (1, 6, 4), jnp.float32)),
                                   atol=1e-5, rtol=0)

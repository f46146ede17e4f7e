"""The PyTorch port's plain ops, scheduler and presets against the JAX
package, on the CPU in f32.  Tolerance for every op here: max-abs <= 2e-5
(both sides compute the same f32 formula; only summation order differs)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import configs as JC
from candle_video_tpu.models.ltx_video import scheduler as JS
from candle_video_tpu.ops import activations as JA
from candle_video_tpu.ops import conv3d as JCV
from candle_video_tpu.ops import embeddings as JE
from candle_video_tpu.ops import norms as JN
from candle_video_tpu.ops import rope as JR
from candle_video_tpu_torch.models.ltx_video import configs as PC
from candle_video_tpu_torch.models.ltx_video import scheduler as PS
from candle_video_tpu_torch.ops import activations as PA
from candle_video_tpu_torch.ops import conv3d as PCV
from candle_video_tpu_torch.ops import embeddings as PE
from candle_video_tpu_torch.ops import norms as PN
from candle_video_tpu_torch.ops import rope as PR

torch.set_num_threads(2)
ATOL = 2e-5


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("affine", [False, True])
def test_rms_norm_and_layer_norm(rng, affine):
    x = rng.normal(size=(2, 7, 96)).astype(np.float32) * 3.0
    w = rng.normal(size=(96,)).astype(np.float32) if affine else None
    b = rng.normal(size=(96,)).astype(np.float32) if affine else None
    tw = None if w is None else torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    jw = None if w is None else jnp.asarray(w)
    jb = None if b is None else jnp.asarray(b)
    _close(PN.rms_norm(torch.from_numpy(x), tw, eps=1e-5),
           JN.rms_norm(jnp.asarray(x), jw, eps=1e-5))
    _close(PN.layer_norm(torch.from_numpy(x), tw, tb),
           JN.layer_norm(jnp.asarray(x), jw, jb))


def test_activations(rng):
    x = rng.normal(size=(5, 33)).astype(np.float32) * 4.0
    _close(PA.gelu_tanh(torch.from_numpy(x)), JA.gelu_tanh(jnp.asarray(x)))
    _close(PA.silu(torch.from_numpy(x)), JA.silu(jnp.asarray(x)))


@pytest.mark.parametrize("dim", [256, 257])
def test_sinusoidal_timestep_embedding(dim):
    t = np.array([0.0, 1.5, 50.0, 999.0], np.float32)
    # arguments reach ~1e3 rad: allow a few f32 ulps of the argument
    _close(PE.sinusoidal_timestep_embedding(torch.from_numpy(t), dim),
           JE.sinusoidal_timestep_embedding(jnp.asarray(t), dim), atol=2e-4)


@pytest.mark.parametrize("dim", [256, 128 + 6])
def test_rope_tables_and_rotation(rng, dim):
    grid = rng.uniform(0, 1, size=(1, 40, 3)).astype(np.float32)
    cos_p, sin_p = PR.rope_cos_sin(torch.from_numpy(grid), dim)
    cos_j, sin_j = JR.rope_cos_sin(jnp.asarray(grid), dim)
    _close(cos_p, cos_j)
    _close(sin_p, sin_j)
    x = rng.normal(size=(2, 40, dim)).astype(np.float32)
    _close(PR.apply_rotary_emb(torch.from_numpy(x), cos_p, sin_p),
           JR.apply_rotary_emb(jnp.asarray(x), cos_j, sin_j))


@pytest.mark.parametrize("kernel,causal", [((3, 3, 3), True), ((3, 3, 3), False),
                                           ((1, 1, 1), True)])
def test_causal_conv3d(rng, kernel, causal):
    x = rng.normal(size=(1, 4, 5, 8, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4, *kernel)).astype(np.float32) * 0.2
    b = rng.normal(size=(6,)).astype(np.float32)
    got = PCV.causal_conv3d(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), causal=causal)
    want = JCV.causal_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             causal=causal, impl="xla")
    _close(got, want, atol=1e-4)  # 108-term f32 sums of O(1) products


@pytest.mark.parametrize("kwargs", [
    dict(num_inference_steps=7, sigmas=list(JC._DISTILLED_SIGMAS), mu=0.0),
    dict(num_inference_steps=10, mu=1.3),
])
def test_set_timesteps_matches(kwargs):
    cfg_j = JC.v0_9_8_distilled_2b().scheduler
    cfg_p = PC.v0_9_8_distilled_2b().scheduler
    sj = JS.set_timesteps(cfg_j, **kwargs)
    sp = PS.set_timesteps(cfg_p, **kwargs)
    np.testing.assert_array_equal(sp.sigmas, sj.sigmas)
    np.testing.assert_array_equal(sp.timesteps, sj.timesteps)
    assert PS.calculate_shift(4992) == JS.calculate_shift(4992)


@pytest.mark.parametrize("stochastic", [False, True])
def test_scheduler_step(rng, stochastic):
    x, v, n = (rng.normal(size=(2, 9, 8)).astype(np.float32) for _ in range(3))
    got = PS.step(torch.from_numpy(x), torch.from_numpy(v), 0.9812, 0.975,
                  stochastic=stochastic, noise=torch.from_numpy(n))
    want = JS.step(jnp.asarray(x), jnp.asarray(v), 0.9812, 0.975,
                   stochastic=stochastic, noise=jnp.asarray(n))
    _close(got, want, atol=1e-6)


def test_presets_equal_field_by_field():
    for version in JC._VERSIONS:
        j = JC.get_config_by_version(version)
        p = PC.get_config_by_version(version)
        for part in ("inference", "transformer", "vae", "scheduler"):
            assert dataclasses.asdict(getattr(p, part)) == \
                dataclasses.asdict(getattr(j, part)), (version, part)
    from candle_video_tpu.models.ltx_video import t5 as JT5

    assert dataclasses.asdict(PC.t5_xxl()) == dataclasses.asdict(JT5.t5_xxl())
    assert PC.get_config_by_version("nope") == PC.v0_9_5_2b()

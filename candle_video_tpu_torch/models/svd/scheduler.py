"""Euler discrete scheduler with v-prediction and Karras sigmas (SVD)
(``candle_video_tpu/models/svd/scheduler.py``).

``set_timesteps`` builds the f64 host table in numpy, as the JAX package
does: scaled-linear betas → cumulative alphas → sigmas, leading, trailing or
linspace spacing, optional Karras re-spacing, continuous (0.25·ln σ)
timesteps.  ``scale_model_input``, ``step`` and ``add_noise`` run on tensors;
``step`` in f32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .configs import EulerSchedulerConfig


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    sigmas: np.ndarray  # [N+1], terminal 0 appended (f64 host table)
    timesteps: np.ndarray  # [N]
    init_noise_sigma: float
    num_inference_steps: int


def _train_sigmas(cfg: EulerSchedulerConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(
            math.sqrt(cfg.beta_start), math.sqrt(cfg.beta_end), n, dtype=np.float64
        ) ** 2
    else:  # linear (and default)
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - betas)
    return np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)


def _karras(sigmas: np.ndarray, sigma_min: float, sigma_max: float) -> np.ndarray:
    n = len(sigmas)
    rho = 7.0
    ramp = np.arange(n, dtype=np.float64) / max(n - 1, 1)
    min_inv = sigma_min ** (1.0 / rho)
    max_inv = sigma_max ** (1.0 / rho)
    return (max_inv + ramp * (min_inv - max_inv)) ** rho


def set_timesteps(cfg: EulerSchedulerConfig, num_inference_steps: int) -> EulerSchedule:
    n = cfg.num_train_timesteps
    train_sigmas = _train_sigmas(cfg)

    if cfg.timestep_spacing == "leading":
        ratio = n // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio + cfg.steps_offset)[::-1].astype(
            np.float64
        )
    elif cfg.timestep_spacing == "trailing":
        ratio = n / num_inference_steps
        ts = np.round(n - np.arange(num_inference_steps, 0, -1, dtype=np.float64) * ratio)
    else:  # linspace
        t = np.arange(num_inference_steps, dtype=np.float64) / max(
            num_inference_steps - 1, 1
        )
        ts = np.round((1.0 - t) * (n - 1))

    sig = train_sigmas[np.minimum(ts.astype(int), n - 1)]
    if cfg.use_karras_sigmas:
        sig = _karras(sig, cfg.sigma_min, cfg.sigma_max)
    sigmas = np.concatenate([sig, [0.0]])

    if cfg.timestep_type == "continuous":
        timesteps = 0.25 * np.log(sigmas[:-1])
    else:
        timesteps = ts

    if cfg.timestep_spacing in ("linspace", "trailing"):
        init_noise_sigma = float(sigmas[0])
    else:
        init_noise_sigma = float(math.sqrt(sigmas[0] ** 2 + 1.0))

    return EulerSchedule(sigmas=sigmas, timesteps=timesteps,
                         init_noise_sigma=init_noise_sigma,
                         num_inference_steps=num_inference_steps)


def scale_model_input(sample, sigma: float):
    """x / sqrt(sigma^2 + 1), the divisor in x's dtype."""
    return sample / torch.tensor(math.sqrt(sigma ** 2 + 1.0), dtype=sample.dtype,
                                 device=sample.device)


def _f32(x: float, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def step(sample, model_output, sigma: float, sigma_next: float,
         prediction_type: str = "v_prediction"):
    """One Euler step in f32; returns (prev_sample in sample's dtype,
    pred_original_sample)."""
    x = sample.float()
    mo = model_output.float()
    if prediction_type == "v_prediction":
        # c_out = -sigma/sqrt(sigma^2+1); c_skip = 1/(sigma^2+1) (no sqrt)
        s2p1 = sigma * sigma + 1.0
        pred_x0 = mo * _f32(-sigma / math.sqrt(s2p1), x) + x * _f32(1.0 / s2p1, x)
        derivative = (x - pred_x0) / _f32(sigma, x)
    elif prediction_type == "epsilon":
        pred_x0 = x - _f32(sigma, x) * mo
        derivative = mo
    else:  # sample prediction
        pred_x0 = mo
        derivative = (x - mo) / _f32(sigma, x)
    prev = x + _f32(sigma_next - sigma, x) * derivative
    return prev.to(sample.dtype), pred_x0


def add_noise(original, noise, sigma: float):
    return original + noise * torch.tensor(sigma, dtype=original.dtype,
                                           device=original.device)

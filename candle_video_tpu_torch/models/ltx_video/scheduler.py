"""Flow-matching Euler scheduler (``candle_video_tpu/models/ltx_video/
scheduler.py``).

The sigma schedule is a handful of scalars built host-side in f32 NumPy (the
JAX package's helpers, copied); the Euler update runs on tensors in f32
across steps.  Stochastic sampling takes an explicit ``noise`` tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerSchedulerConfig:
    """Mirror of FlowMatchEulerDiscreteSchedulerConfig (scheduler.rs:16-58)."""

    num_train_timesteps: int = 1000
    shift: float = 1.0
    use_dynamic_shifting: bool = False
    base_shift: Optional[float] = 0.5
    max_shift: Optional[float] = 1.15
    base_image_seq_len: Optional[int] = 256
    max_image_seq_len: Optional[int] = 4096
    invert_sigmas: bool = False
    shift_terminal: Optional[float] = None
    use_karras_sigmas: bool = False
    use_exponential_sigmas: bool = False
    use_beta_sigmas: bool = False
    time_shift_type: str = "exponential"  # or "linear"
    stochastic_sampling: bool = False

    def __post_init__(self):
        if (
            int(self.use_karras_sigmas)
            + int(self.use_exponential_sigmas)
            + int(self.use_beta_sigmas)
            > 1
        ):
            raise ValueError(
                "Only one of use_beta_sigmas/use_exponential_sigmas/"
                "use_karras_sigmas can be enabled."
            )


@dataclasses.dataclass(frozen=True)
class Schedule:
    """An inference schedule: ``sigmas`` has the terminal value appended."""

    sigmas: np.ndarray  # [N+1] f32
    timesteps: np.ndarray  # [N] f32
    num_inference_steps: int



def _linspace(start: float, end: float, steps: int) -> np.ndarray:
    if steps == 0:
        return np.zeros((0,), dtype=np.float32)
    if steps == 1:
        return np.array([start], dtype=np.float32)
    i = np.arange(steps, dtype=np.float32)
    return (
        np.float32(start)
        + (np.float32(end) - np.float32(start)) * i / np.float32(steps - 1)
    ).astype(np.float32)


def init_sigmas(config: FlowMatchEulerSchedulerConfig) -> tuple[np.ndarray, np.ndarray]:
    """Training-schedule sigmas/timesteps as built at init (scheduler.rs:95-117)."""
    n = config.num_train_timesteps
    ts = np.arange(1, n + 1, dtype=np.float32)[::-1].copy()
    sigmas = ts / np.float32(n)
    if not config.use_dynamic_shifting:
        sh = np.float32(config.shift)
        sigmas = sh * sigmas / (1.0 + (sh - 1.0) * sigmas)
    ts = sigmas * np.float32(n)
    return sigmas.astype(np.float32), ts.astype(np.float32)


def time_shift(
    config: FlowMatchEulerSchedulerConfig, mu: float, sigma: float, t: np.ndarray
) -> np.ndarray:
    """exp(mu)/(exp(mu) + (1/t - 1)^sigma), or the linear variant
    (scheduler.rs:172-186)."""
    t = t.astype(np.float32)
    base = np.power(1.0 / t - 1.0, np.float32(sigma)).astype(np.float32)
    if config.time_shift_type == "exponential":
        emu = np.float32(math.exp(mu))
        return (emu / (emu + base)).astype(np.float32)
    return (np.float32(mu) / (np.float32(mu) + base)).astype(np.float32)


def stretch_shift_to_terminal(
    config: FlowMatchEulerSchedulerConfig, t: np.ndarray
) -> np.ndarray:
    """Rescale so the last sigma hits shift_terminal (scheduler.rs:188-207)."""
    if config.shift_terminal is None or t.size == 0:
        return t
    one_minus_last = np.float32(1.0) - t[-1]
    denom = np.float32(1.0 - config.shift_terminal)
    if abs(float(denom)) < 1e-12:
        raise ValueError("shift_terminal too close to 1.0")
    scale = one_minus_last / denom
    return (np.float32(1.0) - (np.float32(1.0) - t) / scale).astype(np.float32)


def _convert_to_karras(in_sigmas: np.ndarray, steps: int) -> np.ndarray:
    sigma_min, sigma_max = np.float32(in_sigmas[-1]), np.float32(in_sigmas[0])
    rho = np.float32(7.0)
    ramp = _linspace(0.0, 1.0, steps)
    min_inv = np.power(sigma_min, 1.0 / rho)
    max_inv = np.power(sigma_max, 1.0 / rho)
    return np.power(max_inv + ramp * (min_inv - max_inv), rho).astype(np.float32)


def _convert_to_exponential(in_sigmas: np.ndarray, steps: int) -> np.ndarray:
    sigma_min, sigma_max = np.float32(in_sigmas[-1]), np.float32(in_sigmas[0])
    return np.exp(_linspace(math.log(sigma_max), math.log(sigma_min), steps)).astype(
        np.float32
    )


def _convert_to_beta(
    in_sigmas: np.ndarray, steps: int, alpha: float = 0.6, beta: float = 0.6
) -> np.ndarray:
    from scipy.stats import beta as beta_dist

    sigma_min, sigma_max = float(in_sigmas[-1]), float(in_sigmas[0])
    ts = 1.0 - np.linspace(0.0, 1.0, steps, dtype=np.float64)
    ppf = beta_dist.ppf(ts, alpha, beta)
    return (sigma_min + ppf * (sigma_max - sigma_min)).astype(np.float32)


def set_timesteps(
    config: FlowMatchEulerSchedulerConfig,
    num_inference_steps: Optional[int] = None,
    sigmas: Optional[Sequence[float]] = None,
    mu: Optional[float] = None,
    timesteps: Optional[Sequence[float]] = None,
) -> Schedule:
    """Build an inference schedule (scheduler.rs:274-412, same 6 stages)."""
    if config.use_dynamic_shifting and mu is None:
        raise ValueError("mu must be provided when use_dynamic_shifting=True")
    if sigmas is not None and timesteps is not None and len(sigmas) != len(timesteps):
        raise ValueError("sigmas and timesteps must have the same length")

    if num_inference_steps is not None:
        if sigmas is not None and len(sigmas) != num_inference_steps:
            raise ValueError("sigmas length must match num_inference_steps")
        if timesteps is not None and len(timesteps) != num_inference_steps:
            raise ValueError("timesteps length must match num_inference_steps")
    else:
        if sigmas is not None:
            num_inference_steps = len(sigmas)
        elif timesteps is not None:
            num_inference_steps = len(timesteps)
        else:
            raise ValueError(
                "num_inference_steps required when no sigmas/timesteps given"
            )

    init_s, _ = init_sigmas(config)
    sigma_max, sigma_min = float(init_s[0]), float(init_s[-1])
    n_train = np.float32(config.num_train_timesteps)

    is_timesteps_provided = timesteps is not None
    ts_vec = np.asarray(timesteps, dtype=np.float32) if timesteps is not None else None

    if sigmas is not None:
        sig = np.asarray(sigmas, dtype=np.float32)
    else:
        if ts_vec is None:
            ts_vec = _linspace(
                sigma_max * float(n_train), sigma_min * float(n_train), num_inference_steps
            )
        sig = (ts_vec / n_train).astype(np.float32)

    # 2) shifting
    if mu is not None:
        sig = time_shift(config, float(mu), 1.0, sig)
    elif config.use_dynamic_shifting:
        raise ValueError("mu must be provided when use_dynamic_shifting=True")
    else:
        sh = np.float32(config.shift)
        sig = (sh * sig / (1.0 + (sh - 1.0) * sig)).astype(np.float32)

    # 3) terminal stretch
    if config.shift_terminal is not None:
        sig = stretch_shift_to_terminal(config, sig)

    # 4) karras/exponential/beta transforms
    if config.use_karras_sigmas:
        sig = _convert_to_karras(sig, num_inference_steps)
    elif config.use_exponential_sigmas:
        sig = _convert_to_exponential(sig, num_inference_steps)
    elif config.use_beta_sigmas:
        sig = _convert_to_beta(sig, num_inference_steps)

    # 5) timesteps
    if is_timesteps_provided:
        out_ts = ts_vec.astype(np.float32)
    else:
        out_ts = (sig * n_train).astype(np.float32)

    # 6) invert + terminal append
    if config.invert_sigmas:
        sig = (1.0 - sig).astype(np.float32)
        out_ts = (sig * n_train).astype(np.float32)
        sig = np.concatenate([sig, np.ones((1,), np.float32)])
    else:
        sig = np.concatenate([sig, np.zeros((1,), np.float32)])

    return Schedule(
        sigmas=sig.astype(np.float32),
        timesteps=out_ts.astype(np.float32),
        num_inference_steps=num_inference_steps,
    )


def step(sample, model_output, sigma, sigma_next, *, stochastic: bool = False,
         noise=None):
    """One Euler step in f32: x + (sigma_next - sigma) * v.  With
    ``stochastic=True`` the x0-resample form is used and ``noise`` must be
    given."""
    x = sample.float()
    v = model_output.float()
    sigma = float(sigma)
    sigma_next = float(sigma_next)
    if stochastic:
        if noise is None:
            raise ValueError("stochastic step requires explicit noise")
        x0 = x - sigma * v
        return (1.0 - sigma_next) * x0 + sigma_next * noise.float()
    return x + (sigma_next - sigma) * v


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """SD3/Flux mu from sequence length (t2v_pipeline.rs:159-169)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b

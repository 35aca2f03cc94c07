"""Cosine diffusion schedule, the forward process and the DDIM helpers.

The schedule is computed in float64 on the host and stored in float32, as
the JAX package stores it. The training noise of the 3DMatch branch is the
signed-fractional noise of a standard-normal draw; the 4DMatch branch's is the
draw itself (then a sigmoid of the noised matrix). The draw is passed in, so
that a test can feed both packages the same numbers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    """Per-timestep float32 arrays (host numpy)."""
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray


def cosine_beta_schedule(timesteps: int = 1000, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule, float64."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


def make_schedule(timesteps: int = 1000) -> DiffusionSchedule:
    acp = np.cumprod(1.0 - cosine_beta_schedule(timesteps))
    f32 = lambda a: np.asarray(a, np.float32)
    return DiffusionSchedule(
        alphas_cumprod=f32(acp),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
    )


def _per_batch(table: np.ndarray, t, like):
    """table[t] for timesteps t [B], shaped to broadcast over ``like`` [B, ...]."""
    vals = torch.from_numpy(table).to(like.device)[t.long().to(like.device)]
    return vals.reshape((-1,) + (1,) * (like.ndim - 1))


def q_sample(schedule: DiffusionSchedule, x_start, t, noise):
    """Forward diffusion x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps, t [B]."""
    return _per_batch(schedule.sqrt_alphas_cumprod, t, x_start) * x_start \
        + _per_batch(schedule.sqrt_one_minus_alphas_cumprod, t, x_start) * noise


def signed_fractional_noise(g, scale: float = 1.5):
    """3DMatch training noise sign(g) * frac(|g|) * scale of a standard-normal
    draw ``g`` (the JAX package draws g inside; here it is passed in)."""
    return torch.sign(g) * torch.remainder(torch.abs(g), 1.0) * scale


def predict_noise_from_start(schedule: DiffusionSchedule, x_t, t: int, x0):
    """eps_hat = (sqrt(1/acp_t) x_t - x0) / sqrt(1/acp_t - 1) at one timestep t."""
    return (float(schedule.sqrt_recip_alphas_cumprod[t]) * x_t - x0) \
        / float(schedule.sqrt_recipm1_alphas_cumprod[t])


def ddim_coefficients(schedule: DiffusionSchedule, t: int, t_next: int, eta: float):
    """(sqrt(acp_next), c, sigma) of the DDIM update
    x_next = x0 * sqrt(acp_next) + c * eps_hat [+ sigma * noise], with
    c = sqrt(max(1 - acp_next - sigma^2, 0)) and
    sigma = eta * sqrt((1 - acp_t / acp_next) (1 - acp_next) / (1 - acp_t));
    the 3DMatch branch drops the noise term, the 4DMatch branch keeps it.

    At the first step (acp_t ~ 2e-9) ``1 - acp_next - sigma^2`` cancels to
    float32 rounding, so c depends on how it is evaluated. The JAX package's
    compiled loop evaluates ``(1 - acp_next) - sigma * sigma`` as one fused
    multiply-add in float32; this does the same (the product is exact in
    float64), so both packages take the same step.
    """
    a, a_next = schedule.alphas_cumprod[t], schedule.alphas_cumprod[t_next]
    one = np.float32(1.0)
    sigma = np.float32(eta) * np.sqrt((one - a / a_next) * (one - a_next) / (one - a))
    rem = np.float32(np.float64(one - a_next) - np.float64(sigma) * np.float64(sigma))
    return (float(np.sqrt(a_next)), float(np.sqrt(np.maximum(rem, np.float32(0.0)))),
            float(sigma))


def ddim_time_pairs(num_timesteps: int, sampling_steps: int) -> np.ndarray:
    """Reversed (t, t_next) pairs: linspace(0, T-1, steps+1) as ints, reversed."""
    times = np.linspace(0, num_timesteps - 1, sampling_steps + 1).astype(np.int32)[::-1]
    return np.stack([times[:-1], times[1:]], axis=1)  # [steps, 2]

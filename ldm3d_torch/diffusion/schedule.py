"""DDPM noise schedule: the coefficient tables of `ldm3d.diffusion.schedule`.

Linear beta in [beta_start, beta_end] over T steps, precomputed in float64
and held as float32 tables. `make_schedule` puts the tables on the CPU:
the sampler reads one timestep at a time as Python scalars, so no per-step
gather runs on the device. The batched functions (`q_sample`, `v_target`,
`min_snr_weight`, `model_out_to_eps`) gather a batch of timesteps on t's
device; `Schedule.to(device)` gives a copy there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Schedule(NamedTuple):
    beta: torch.Tensor
    alpha: torch.Tensor
    sqrt_alpha: torch.Tensor
    alpha_bar: torch.Tensor
    alpha_bar_prev: torch.Tensor
    sqrt_alpha_bar: torch.Tensor
    sqrt_alpha_bar_prev: torch.Tensor
    sqrt_one_minus_alpha_bar: torch.Tensor

    @property
    def timesteps(self) -> int:
        return self.beta.shape[0]

    def to(self, device) -> "Schedule":
        return Schedule(*(tab.to(device) for tab in self))

    def gather(self, t: torch.Tensor) -> "Schedule":
        """All tables at the batched timesteps t, shaped [B, 1, 1, 1, 1] to
        broadcast over a [B, H, W, D, C] volume."""
        return Schedule(*(tab.to(t.device)[t.long()].reshape(-1, 1, 1, 1, 1)
                          for tab in self))


def make_schedule(timesteps: int, beta_start: float = 1e-4,
                  beta_end: float = 0.02) -> Schedule:
    beta = np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)
    alpha = 1.0 - beta
    alpha_bar = np.cumprod(alpha, 0)
    alpha_bar_prev = np.append(1.0, alpha_bar[:-1])

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    return Schedule(
        beta=f32(beta),
        alpha=f32(alpha),
        sqrt_alpha=f32(np.sqrt(alpha)),
        alpha_bar=f32(alpha_bar),
        alpha_bar_prev=f32(alpha_bar_prev),
        sqrt_alpha_bar=f32(np.sqrt(alpha_bar)),
        sqrt_alpha_bar_prev=f32(np.sqrt(alpha_bar_prev)),
        sqrt_one_minus_alpha_bar=f32(np.sqrt(1.0 - alpha_bar)),
    )


def q_sample(sched: Schedule, latents: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps."""
    g = sched.gather(t)
    return (g.sqrt_alpha_bar.to(latents.dtype) * latents
            + g.sqrt_one_minus_alpha_bar.to(latents.dtype) * noise)


def v_target(sched: Schedule, latents: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """v = sqrt(abar_t) eps - sqrt(1 - abar_t) x_0 (Salimans & Ho 2022)."""
    g = sched.gather(t)
    return (g.sqrt_alpha_bar.to(noise.dtype) * noise
            - g.sqrt_one_minus_alpha_bar.to(noise.dtype) * latents)


def min_snr_weight(sched: Schedule, t: torch.Tensor, gamma: float,
                   prediction_type: str) -> torch.Tensor:
    """Min-SNR-gamma loss weight (Hang et al. 2023): min(SNR, gamma) / SNR
    for eps-prediction, min(SNR, gamma) / (SNR + 1) for v-prediction;
    [B, 1, 1, 1, 1]."""
    g = sched.gather(t)
    snr = g.alpha_bar / (1.0 - g.alpha_bar)
    clipped = torch.clamp(snr, max=gamma)
    if prediction_type == "v":
        return clipped / (snr + 1.0)
    return clipped / snr


def model_out_to_eps(sched: Schedule, x_t: torch.Tensor, t: torch.Tensor,
                     out: torch.Tensor, prediction_type: str) -> torch.Tensor:
    """Model output in eps-space, so that every sampler keeps its eps-based
    update. For v-prediction eps = sqrt(abar_t) v + sqrt(1 - abar_t) x_t,
    the inverse of `v_target` given x_t = `q_sample`(x_0, t, eps)."""
    if prediction_type == "eps":
        return out
    if prediction_type != "v":
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    g = sched.gather(t)
    return (g.sqrt_alpha_bar.to(out.dtype) * out
            + g.sqrt_one_minus_alpha_bar.to(out.dtype) * x_t)


def posterior_coefficients(sched: Schedule, t: int):
    """The scalars of `posterior` at one timestep, computed in float32 in
    the same order as the JAX package: (sqrt(1-abar), sqrt(abar),
    x0 coefficient, x_t coefficient, variance), each a Python float that
    holds a float32 value exactly."""
    g = Schedule(*(tab[t] for tab in sched))
    one = torch.tensor(1.0, dtype=torch.float32)
    c_x0 = g.beta * g.sqrt_alpha_bar_prev / (one - g.alpha_bar)
    c_xt = (one - g.alpha_bar_prev) * g.sqrt_alpha / (one - g.alpha_bar)
    var = (one - g.alpha_bar_prev) * g.beta / (one - g.alpha_bar)
    return (float(g.sqrt_one_minus_alpha_bar), float(g.sqrt_alpha_bar),
            float(c_x0), float(c_xt), float(var))


def posterior(sched: Schedule, x_t: torch.Tensor, pred_noise: torch.Tensor,
              t: int) -> tuple[torch.Tensor, float]:
    """Posterior mean and variance of the reverse step at timestep t."""
    s1m, sab, c_x0, c_xt, var = posterior_coefficients(sched, t)
    x0 = (x_t - s1m * pred_noise) / sab
    mean = c_x0 * x0 + c_xt * x_t
    return mean, var

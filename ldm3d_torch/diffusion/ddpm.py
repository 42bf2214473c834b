"""The DDPM training loss and the samplers of `ldm3d.diffusion.ddpm`: the
T-step reverse process (`sample_latents`), DDIM, DPM-Solver++(2M) and
DPM-Solver++(2M) SDE over a strided timestep subsequence, each a Python
loop of denoiser calls with float32 coefficients computed on the host.

Noise comes from a `torch.Generator`, or is injected: `init_noise` is x_T
and `step_noise(k)` the noise added at step k, where k is the timestep t
for `sample_latents` and the step index i (0 for the first denoiser call)
for the strided samplers. Injection lets a test hand the JAX sampler's own
draws to these.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ldm3d_torch.core.device import resolve_device
from ldm3d_torch.diffusion.schedule import Schedule, posterior, q_sample


def diffusion_train_loss(sched: Schedule, latents: torch.Tensor,
                         pred_noise_fn: Callable, t: torch.Tensor,
                         noise: torch.Tensor, global_batch: int,
                         loss_scaling: str = "reference") -> torch.Tensor:
    """Diffuse `latents` to timesteps t with `noise`, predict, and return
    the loss. "reference" scaling is SUM-MSE / (global_batch * lc^4) with
    lc the latent channels; "mean" is the mean MSE. t and noise are the
    caller's draws (the JAX function draws them from its key)."""
    noisy = q_sample(sched, latents, t, noise)
    pred = pred_noise_fn(noisy, t)
    err = torch.square(noise.float() - pred.float())
    if loss_scaling == "reference":
        lc = latents.shape[-1]
        return err.sum() / (global_batch * float(lc) ** 4)
    return err.mean()


def ddpm_sample_step(sched: Schedule, x: torch.Tensor,
                     pred_noise: torch.Tensor, t: int,
                     noise: Optional[torch.Tensor],
                     clip_value: float = 1.0) -> torch.Tensor:
    """One reverse step: posterior mean, clipped to [-clip_value,
    clip_value] unless clip_value <= 0, plus sqrt(var) * noise. `noise` is
    None, or ignored, at t == 0."""
    mean, var = posterior(sched, x, pred_noise, t)
    if clip_value > 0:
        mean = mean.clamp(-clip_value, clip_value)
    if t == 0 or noise is None:
        return mean
    std = float(torch.exp(0.5 * torch.log(
        torch.tensor(max(var, 1e-20), dtype=torch.float32))))
    return mean + std * noise


def _noise_source(shape, generator, device, step_noise):
    """t -> noise at step key t: injected, or drawn from `generator`."""
    if step_noise is not None:
        return lambda key: step_noise(key).to(device, torch.float32)
    return lambda key: torch.randn(shape, generator=generator, device=device,
                                   dtype=torch.float32)


def _start(shape, generator, device, init_noise):
    """x_T and the sampler's device: `device`, else the generator's, else
    the GPU (`resolve_device`), never the CPU unless asked for."""
    if device is None:
        device = generator.device if generator is not None \
            else resolve_device(None)
    if init_noise is None:
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
    else:
        x = init_noise.to(device, torch.float32)
    return x, device


def sample_latents(sched: Schedule, denoise_fn: Callable, shape,
                   generator: Optional[torch.Generator] = None,
                   device=None, clip_value: float = 1.0,
                   init_noise: Optional[torch.Tensor] = None,
                   step_noise: Optional[Callable[[int], torch.Tensor]] = None,
                   last_step: int = 0) -> torch.Tensor:
    """Reverse process from x_T ~ N(0, I) down to timestep `last_step`.

    Args:
      denoise_fn: (x [B, ...] float32, t [B] int64) -> predicted noise.
      shape: latent shape (B, h, w, d, C).
      generator: draws x_T and the per-step noise when they are not
        injected; its device is the sampler's device.
      init_noise / step_noise: injected x_T and t -> noise at timestep t.
    """
    x, device = _start(shape, generator, device, init_noise)
    noise = _noise_source(shape, generator, device, step_noise)
    b = shape[0]
    for t in range(sched.timesteps - 1, last_step - 1, -1):
        t_batch = torch.full((b,), t, dtype=torch.long, device=device)
        eps = denoise_fn(x, t_batch).float()
        x = ddpm_sample_step(sched, x, eps, t, noise(t) if t > 0 else None,
                             clip_value)
    return x


def sampler_timesteps(timesteps: int, num_steps: int) -> List[int]:
    """The strided subsequence of the DDIM and DPM++ samplers, descending
    and ending at 0: JAX's float32 `jnp.linspace(0, T - 1, n).round()`
    with n = min(num_steps, T), reproduced as XLA computes it. XLA turns
    the division by n - 1 into a product with its float32 reciprocal and
    folds T - 1 into that constant, so point i is
    i * f32(f32(T - 1) * f32(1 / (n - 1))); the last point is T - 1, and
    the points are rounded half to even. The exact quotient, numpy's
    float64 `linspace` and torch's float32 `linspace` each give another
    table at some n (e.g. T = 500 and n = 27, 51 or 63)."""
    n = min(num_steps, timesteps)
    if n < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if n == 1:
        return [0]
    stride = np.float32(timesteps - 1) * (np.float32(1) / np.float32(n - 1))
    pts = np.append(np.arange(n - 1, dtype=np.float32) * stride,
                    np.float32(timesteps - 1))
    return [int(v) for v in np.rint(pts)[::-1]]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def sample_latents_ddim(sched: Schedule, denoise_fn: Callable, shape,
                        generator: Optional[torch.Generator] = None,
                        device=None, num_steps: int = 50, eta: float = 0.0,
                        clip_value: float = 1.0,
                        init_noise: Optional[torch.Tensor] = None,
                        step_noise: Optional[Callable[[int], torch.Tensor]]
                        = None) -> torch.Tensor:
    """DDIM (Song et al. 2021) over `sampler_timesteps`: x0 prediction
    (clipped unless clip_value <= 0), then
    x <- sqrt(abar_p) x0 + sqrt(1 - abar_p - sigma^2) eps + sigma z with
    sigma = eta sqrt((1 - abar_p) / (1 - abar_t)) sqrt(1 - abar_t / abar_p)
    and abar_p = 1 at the last step. eta = 0 is deterministic; the noise
    of step i is drawn only where sigma > 0."""
    taus = sampler_timesteps(sched.timesteps, num_steps)
    x, device = _start(shape, generator, device, init_noise)
    noise = _noise_source(shape, generator, device, step_noise)
    a_bar, one, b = sched.alpha_bar, _f32(1.0), shape[0]
    for i, t in enumerate(taus):
        ab_t = a_bar[t]
        ab_p = a_bar[taus[i + 1]] if i + 1 < len(taus) else one
        eps = denoise_fn(x, torch.full((b,), t, dtype=torch.long,
                                       device=device)).float()
        x0 = (x - float(torch.sqrt(one - ab_t)) * eps) / float(
            torch.sqrt(ab_t))
        if clip_value > 0:
            x0 = x0.clamp(-clip_value, clip_value)
        sigma = (_f32(eta) * torch.sqrt((one - ab_p) / (one - ab_t))
                 * torch.sqrt(one - ab_t / ab_p))
        c_dir = torch.sqrt(torch.clamp(one - ab_p - sigma ** 2, min=0.0))
        x = float(torch.sqrt(ab_p)) * x0 + float(c_dir) * eps
        if float(sigma) > 0:
            x = x + float(sigma) * noise(i)
    return x


def _dpm_tables(sched: Schedule, taus: List[int]):
    """sqrt(abar), sqrt(1 - abar) and the log-SNR lambda at each step, in
    float32."""
    idx = torch.tensor(taus)
    alpha = torch.sqrt(sched.alpha_bar)[idx]
    sigma = torch.sqrt(1.0 - sched.alpha_bar)[idx]
    return alpha, sigma, torch.log(alpha) - torch.log(sigma)


def sample_latents_dpmpp(sched: Schedule, denoise_fn: Callable, shape,
                         generator: Optional[torch.Generator] = None,
                         device=None, num_steps: int = 20,
                         clip_value: float = 1.0,
                         init_noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022), deterministic, over
    `sampler_timesteps`: with h = lambda_next - lambda, r = h_prev / h and
    the x0 prediction d (clipped unless clip_value <= 0),
    x <- (sigma_next / sigma) x - alpha_next (e^-h - 1) d2, where
    d2 = (1 + 1/2r) d - (1/2r) d_prev, and d2 = d at step 0 (h_prev starts
    at 1). The last step returns d."""
    taus = sampler_timesteps(sched.timesteps, num_steps)
    x, device = _start(shape, generator, device, init_noise)
    alpha, sigma, lam = _dpm_tables(sched, taus)
    n, b = len(taus), shape[0]
    d_prev, h_prev = None, _f32(1.0)
    for i, t in enumerate(taus):
        eps = denoise_fn(x, torch.full((b,), t, dtype=torch.long,
                                       device=device)).float()
        d = (x - float(sigma[i]) * eps) / float(alpha[i])
        if clip_value > 0:
            d = d.clamp(-clip_value, clip_value)
        if i == n - 1:
            break
        h = lam[i + 1] - lam[i]
        if i == 0:
            d2 = d
        else:
            inv = 1.0 / (2.0 * (h_prev / h))
            d2 = float(1.0 + inv) * d - float(inv) * d_prev
        x = (float(sigma[i + 1] / sigma[i]) * x
             - float(alpha[i + 1] * (torch.exp(-h) - 1.0)) * d2)
        d_prev, h_prev = d, h
    return d


def sample_latents_dpmpp_sde(sched: Schedule, denoise_fn: Callable, shape,
                             generator: Optional[torch.Generator] = None,
                             device=None, num_steps: int = 50,
                             clip_value: float = 1.0,
                             init_noise: Optional[torch.Tensor] = None,
                             step_noise: Optional[Callable[[int],
                                                           torch.Tensor]]
                             = None) -> torch.Tensor:
    """DPM-Solver++(2M) SDE, VP form, midpoint multistep (eta = 1), over
    `sampler_timesteps`: with h, r and d as in `sample_latents_dpmpp`,
    x <- (sigma_next / sigma) e^-h x + alpha_next (1 - e^-2h) d_mid
         + sigma_next sqrt(1 - e^-2h) z,
    d_mid = d + (1/2r)(d - d_prev), and d_mid = d at step 0. The last step
    returns d and draws no noise."""
    taus = sampler_timesteps(sched.timesteps, num_steps)
    x, device = _start(shape, generator, device, init_noise)
    noise = _noise_source(shape, generator, device, step_noise)
    alpha, sigma, lam = _dpm_tables(sched, taus)
    n, b = len(taus), shape[0]
    d_prev, h_prev = None, _f32(1.0)
    for i, t in enumerate(taus):
        eps = denoise_fn(x, torch.full((b,), t, dtype=torch.long,
                                       device=device)).float()
        d = (x - float(sigma[i]) * eps) / float(alpha[i])
        if clip_value > 0:
            d = d.clamp(-clip_value, clip_value)
        if i == n - 1:
            break
        h = lam[i + 1] - lam[i]
        d_mid = d if i == 0 else d + float(0.5 / (h_prev / h)) * (d - d_prev)
        em2h = torch.exp(-2.0 * h)
        x = (float(sigma[i + 1] / sigma[i] * torch.exp(-h)) * x
             + float(alpha[i + 1] * (1.0 - em2h)) * d_mid
             + float(sigma[i + 1] * torch.sqrt(torch.clamp(1.0 - em2h,
                                                           min=0.0)))
             * noise(i))
        d_prev, h_prev = d, h
    return d

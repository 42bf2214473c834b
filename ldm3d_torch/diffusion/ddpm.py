"""The DDPM training loss and the T-step reverse process of
`ldm3d.diffusion.ddpm`, the latter as a Python loop of denoiser calls.

Noise comes from a `torch.Generator`, or is injected: `init_noise` is x_T
and `step_noise(t)` the noise added at timestep t. Injection lets a test
hand the JAX sampler's own draws to this one.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

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


def sample_latents(sched: Schedule, denoise_fn: Callable, shape,
                   generator: Optional[torch.Generator] = None,
                   device=None, clip_value: float = 1.0,
                   init_noise: Optional[torch.Tensor] = None,
                   step_noise: Optional[Callable[[int], torch.Tensor]] = None,
                   ) -> torch.Tensor:
    """Full reverse process from x_T ~ N(0, I) down to t = 0.

    Args:
      denoise_fn: (x [B, ...] float32, t [B] int64) -> predicted noise.
      shape: latent shape (B, h, w, d, C).
      generator: draws x_T and the per-step noise when they are not
        injected; its device is the sampler's device.
      init_noise / step_noise: injected x_T and t -> noise at timestep t.
    """
    if device is None:
        device = generator.device if generator is not None else "cpu"

    def randn():
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    x = randn() if init_noise is None else init_noise.to(device, torch.float32)
    b = shape[0]
    for t in range(sched.timesteps - 1, -1, -1):
        t_batch = torch.full((b,), t, dtype=torch.long, device=device)
        eps = denoise_fn(x, t_batch).float()
        noise = None
        if t > 0:
            noise = randn() if step_noise is None \
                else step_noise(t).to(device, torch.float32)
        x = ddpm_sample_step(sched, x, eps, t, noise, clip_value)
    return x


"""Stage-2 latent diffusion: the port of `ldm3d.train.dm_trainer`
(`LatentDiffusion`, `DiffusionTrainer`): encode volumes through the frozen
VQ-VAE, train the U-Net on volumes or on cached latents, sample with the
DDPM, DDIM, DPM++(2M) or DPM++(2M) SDE sampler (optionally with
classifier-free guidance, optionally decoded), and score samples with the
latent-FID evaluation of the training CLI (`fidelity_eval`).

The Python loop over `train_step_latents` is the counterpart of
`train_epoch_latents`, whose `lax.scan` only saved TPU dispatches.

With a `mesh` of several processes (`parallel.mesh.make_mesh`), each
process trains on its rows of every global batch: the draws are made for
the global batch and sliced, the U-Net's BatchNorm normalises with the
global batch's statistics, and the gradients and metrics are reduced
over the data x space group, so that the processes take the step one
process takes on the global batch. With a 'space' axis the steps,
`encode_latents` and `generate` run inside
`parallel.spatial.spatial_sharding`: volumes arrive as depth slabs,
latents whole (their rows of the batch), and the U-Net and the frozen
VQ-VAE run on depth slabs; each process's loss is its slab's share.
`encode_latents` and `generate` return whole latents and volumes, equal
on every process of the space group. With a 'model' axis the U-Net's
wide conv kernels and vectors (and so Adam's moments and the EMA copy's)
are split over the model group (`parallel.tp`; the steps and `generate`
run inside `tp.mesh_sharding`); the frozen VQ-VAE stays whole on every
process. `state_dict` / `load_state_dict` hold whole tensors, one
process's.

The model computes in `train_cfg.dtype` (`layers.set_compute_dtype`; the
JAX default bfloat16 builds `LatentDiffusion(dtype=bfloat16)`, the frozen
VQ-VAE and the U-Net alike): activations in it, parameters, Adam's
moments, the EMA copy and the BatchNorm statistics in float32, and the
noised latents, the loss, the sampler's state and the returned latents
and volumes in float32.

`generate` decodes with cuDNN's deterministic algorithms, so that a
seeded request gives the same volume every time, as a JAX request's
`PRNGKey(seed)` does: in bfloat16 the default algorithms of the decode's
transposed convolutions do not repeat on an H100.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ldm3d_torch.core.config import (DiffusionConfig, TrainConfig,
                                     compute_dtype)
from ldm3d_torch.core.device import resolve_device
from ldm3d_torch.diffusion.ddpm import (sample_latents, sample_latents_ddim,
                                        sample_latents_dpmpp,
                                        sample_latents_dpmpp_sde)
from ldm3d_torch.diffusion.schedule import (make_schedule, min_snr_weight,
                                            model_out_to_eps, q_sample,
                                            v_target)
from ldm3d_torch.models.layers import (INIT_SCHEMES, at_least_float32,
                                       set_compute_dtype)
from ldm3d_torch.models.unet3d import UNet3D
from ldm3d_torch.models.vqvae import VQVAE
from ldm3d_torch.ops.fid import (frechet_distance, latent_fidelity,
                                 pool_latent_features)
from ldm3d_torch.parallel import spatial, tp
from ldm3d_torch.parallel.distributed import (reduce_gradients,
                                              reduce_metrics)
from ldm3d_torch.parallel.mesh import (attach_data_group, batch_group,
                                       data_shard)
from ldm3d_torch.parallel.spatial import spatial_sharding
from ldm3d_torch.parallel.tp import mesh_sharding

SAMPLERS = ("ddpm", "ddim", "dpmpp", "dpmpp_sde")


def auto_latent_scale(lat_std: float, cfg: DiffusionConfig,
                      explicit: Optional[float] = None,
                      clip: Optional[float] = None) -> DiffusionConfig:
    """The `--cache_latents` rule for the diffusion space's scale.

    Given the std of the cached latents (in diffusion space), returns `cfg`
    with latent_scale = 1 / std and clip_sample_range = `clip` (0 when not
    given) only when no scale was given (`explicit` is None), the config's
    scale is 1.0, |std - 1| > 0.05 and std > 1e-8; else `cfg` unchanged."""
    if (explicit is None and cfg.latent_scale == 1.0
            and abs(lat_std - 1.0) > 0.05 and lat_std > 1e-8):
        return dataclasses.replace(
            cfg, latent_scale=1.0 / lat_std,
            clip_sample_range=clip if clip is not None else 0.0)
    return cfg


class LatentDiffusion(nn.Module):
    """Frozen VQ-VAE and the U-Net denoiser under one module, so that both
    state dicts share one prefix tree (`unet.*`, `vqvae.encoder.*`,
    `vqvae.quantizer.*`, `vqvae.decoder.*`), as the flax tree does."""

    def __init__(self, cfg: DiffusionConfig):
        super().__init__()
        self.cfg = cfg
        self.vqvae = VQVAE(cfg.vqvae)
        self.unet = UNet3D(cfg.unet, out_channels=cfg.latent_channels,
                           in_channels=cfg.latent_channels,
                           latent_size=cfg.latent_size)

    def encode_latents(self, images: torch.Tensor) -> torch.Tensor:
        """Volumes (NDHWC) -> quantized latents (NDHWC) times latent_scale,
        the diffusion space."""
        q, _ = self.vqvae.encode_quantize(images)
        if self.cfg.latent_scale != 1.0:
            q = q * self.cfg.latent_scale
        return q

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents in diffusion space (NDHWC) -> volumes (NDHWC); divides by
        latent_scale first. Under spatial sharding whole latents give the
        whole volume: decoded over depth slabs when the latent depth
        divides by the space degree, else whole on every process."""
        if self.cfg.latent_scale != 1.0:
            latents = latents / self.cfg.latent_scale
        axis = spatial.SPATIAL_AXIS
        if spatial.shards(latents.shape[axis]):
            return spatial.gather(
                self.vqvae.decode(spatial.shard_spatial(latents)), axis)
        with spatial.whole():
            return self.vqvae.decode(latents)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block; every other cuDNN
    setting (TF32, benchmark) stays the caller's."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


class DiffusionTrainer:
    """Owns the model on one device; trains the U-Net and samples from it.

    The VQ-VAE is frozen: always in eval mode, outside the optimizer. The
    U-Net is in train mode only inside a train step. t, noise and the
    context-drop mask of a step come from `self.generator` (on this
    trainer's device, seeded with `train_cfg.seed`) unless injected; under
    a `mesh` they are the global batch's, and so are injected ones."""

    def __init__(self, cfg: DiffusionConfig, device=None,
                 train_cfg: Optional[TrainConfig] = None, mesh=None):
        self.cfg = cfg
        self.train_cfg = train_cfg or TrainConfig()
        self.device = resolve_device(device)
        self.conditional = cfg.unet.context_dim is not None
        self.model = LatentDiffusion(cfg).to(self.device).eval()
        set_compute_dtype(self.model, compute_dtype(self.train_cfg.dtype))
        self.model.requires_grad_(False)
        self.ema_unet: Optional[UNet3D] = None
        self.sched = make_schedule(cfg.timesteps, cfg.beta_start,
                                   cfg.beta_end)
        self._sched_dev = self.sched.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.train_cfg.seed)
        self.optimizer: Optional[torch.optim.Adam] = None
        self.step = 0
        self.mesh = mesh
        # the frozen stage-1 runs in eval mode only: no global statistics,
        # and whole on every process
        attach_data_group(self.model.unet, mesh)
        tp.shard_module(self.model.unet, mesh)

    def init_random(self, seed: int, scheme: str = "jax"
                    ) -> "DiffusionTrainer":
        """Seeded random weights: the JAX package's init (`layers.init_jax_`)
        or, with scheme "reach", `layers.init_params_`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with tp.whole_parameters(self.model, self.mesh):
            INIT_SCHEMES[scheme](self.model, gen)
        return self

    def snapshot_modules(self) -> Tuple[nn.Module, Optional[nn.Module]]:
        """(the model, the EMA U-Net or None): what a `.npz` snapshot
        holds (`utils.export`). The EMA collection is there when the
        trainer has an EMA U-Net or will make one (ema_decay > 0), as in
        the JAX trainer's state."""
        ema = self.ema_unet
        if ema is None and self.train_cfg.ema_decay > 0:
            ema = self.model.unet
        return self.model, ema

    def load_state_dicts(self, model_state: Dict[str, torch.Tensor],
                         ema_unet_state: Optional[Dict] = None) -> None:
        """Load `convert.convert_state`'s output: the model state, strict,
        and the U-Net's EMA state when the checkpoint has one."""
        self.model.load_state_dict(
            tp.sliced_state(self.model, model_state, self.mesh), strict=True)
        self._load_ema(ema_unet_state)

    def _load_ema(self, ema_unet_state: Optional[Dict]) -> None:
        """The EMA U-Net of a whole state, or None; a copy of the U-Net,
        sharded as it is."""
        self.ema_unet = None
        if ema_unet_state is not None:
            ema = copy.deepcopy(self.model.unet)
            ema.load_state_dict(tp.sliced_state(ema, ema_unet_state,
                                                self.mesh), strict=True)
            self.ema_unet = ema.eval().requires_grad_(False)

    def state_dict(self) -> dict:
        """The whole training state, as `ldm3d.train.state.TrainState`
        holds it: the model (the frozen VQ-VAE and the BatchNorm statistics
        included), the EMA U-Net, Adam's state (moments, step count,
        learning rate), the step, the generator's state and the latent
        scale. Tensors are the live ones (as `nn.Module.state_dict`):
        serialise or copy before the next step. Under a 'model' axis the
        sharded tensors are gathered whole (a collective)."""
        return {
            "model": tp.whole_state(self.model, self.model.state_dict(),
                                    self.mesh),
            "ema_unet": None if self.ema_unet is None
            else tp.whole_state(self.ema_unet, self.ema_unet.state_dict(),
                                self.mesh),
            "optimizer": None if self.optimizer is None
            else tp.whole_optimizer_state(
                self.optimizer, self.optimizer.state_dict(),
                tp.param_dims(self.model), self.mesh),
            "step": self.step,
            "generator": self.generator.get_state(),
            "latent_scale": self.cfg.latent_scale,
            "clip_sample_range": self.cfg.clip_sample_range,
        }

    def load_state_dict(self, state: dict, optimizer: bool = True) -> None:
        """Restore `state_dict()`'s output onto this trainer's device, so
        that training goes on as if it had never stopped. With
        `optimizer=False` (sampling only) Adam's state is not restored and
        no optimizer is built."""
        self.set_latent_scale(float(state["latent_scale"]),
                              float(state["clip_sample_range"]))
        self.model.load_state_dict(
            tp.sliced_state(self.model, state["model"], self.mesh),
            strict=True)
        self._load_ema(state["ema_unet"])
        self.optimizer = None
        if optimizer and state["optimizer"] is not None:
            self._optimizer().load_state_dict(tp.sliced_optimizer_state(
                self.optimizer, state["optimizer"],
                tp.param_dims(self.model), self.mesh))
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())

    def set_latent_scale(self, latent_scale: float,
                         clip_sample_range: float) -> None:
        """Adopt a new diffusion-space scale (e.g. `auto_latent_scale`'s)."""
        self.cfg = dataclasses.replace(self.cfg, latent_scale=latent_scale,
                                       clip_sample_range=clip_sample_range)
        self.model.cfg = self.cfg

    # -- train ------------------------------------------------------------

    @torch.no_grad()
    def encode_latents(self, images: torch.Tensor) -> torch.Tensor:
        """Quantized latents of volumes (NDHWC) in diffusion space, under
        the frozen stage-1 in eval mode: deterministic, so they can be
        computed once per corpus and trained on (`train_step_latents`).
        Over a space mesh `images` are depth slabs and the latents are
        gathered whole. float32 (a quantizer that returns the compute
        dtype gives its values, upcast)."""
        with spatial_sharding(self.mesh):
            lat = self.model.encode_latents(images.to(self.device).float())
            return at_least_float32(spatial.gather(lat, spatial.SPATIAL_AXIS))

    def _optimizer(self) -> torch.optim.Adam:
        """Adam over the U-Net only (optax `adam` math, eps 1e-8), and the
        EMA copy of the U-Net, both made at the first step."""
        if self.optimizer is None:
            unet = self.model.unet
            unet.requires_grad_(True)
            tc = self.train_cfg
            self.optimizer = torch.optim.Adam(
                unet.parameters(), lr=tc.learning_rate,
                betas=(tc.adam_b1, tc.adam_b2), eps=1e-8)
        if self.train_cfg.ema_decay > 0 and self.ema_unet is None:
            self.ema_unet = copy.deepcopy(self.model.unet).eval()
            self.ema_unet.requires_grad_(False)
        return self.optimizer

    def _draws(self, shape, t, noise, drop):
        """t, noise and the drop mask of the global batch (drawn unless
        injected), then this process's rows of them."""
        gen, dev = self.generator, self.device
        shard = data_shard(self.mesh)
        b = shape[0] * (1 if shard is None else shard[1])
        if t is None:
            t = torch.randint(0, self.cfg.timesteps, (b,), generator=gen,
                              device=dev)
        if noise is None:
            noise = torch.randn((b,) + tuple(shape[1:]), generator=gen,
                                device=dev)
        if drop is None and self.conditional and self.cfg.unet.cfg_dropout > 0:
            drop = torch.rand(b, generator=gen, device=dev) \
                < self.cfg.unet.cfg_dropout

        def local(x):
            if x is None or shard is None:
                return x
            return x[shard[0] * shape[0]:(shard[0] + 1) * shape[0]]
        t, noise, drop = local(t), local(noise), local(drop)
        return (t.to(dev).long(), noise.to(dev, torch.float32),
                None if drop is None else drop.to(dev).bool())

    def _train_on(self, latents: torch.Tensor,
                  context: Optional[torch.Tensor], t, noise, drop
                  ) -> Dict[str, torch.Tensor]:
        cfg, tc = self.cfg, self.train_cfg
        opt = self._optimizer()
        unet = self.model.unet
        latents = latents.detach().float()
        b = latents.shape[0]
        t, noise, drop = self._draws(latents.shape, t, noise, drop)
        if self.conditional:
            context = torch.zeros(b, dtype=torch.long, device=self.device) \
                if context is None else context.to(self.device).long()
            if cfg.unet.cfg_dropout > 0:
                # train the null token on a random subset of the batch
                context = torch.where(drop, cfg.unet.context_dim + 1,
                                      context)
        else:
            context = None

        target = v_target(self._sched_dev, latents, t, noise) \
            if cfg.prediction_type == "v" else noise
        x_t = q_sample(self._sched_dev, latents, t, noise)
        unet.train()
        try:
            with mesh_sharding(self.mesh):
                # over a space mesh the U-Net takes this process's depth
                # slab of the noised latents; the loss is the slab's share
                x_t, target = (spatial.shard_spatial(a)
                               for a in (x_t, target))
                pred = unet(x_t, t, context)
                err = torch.square(target - pred.float())
                if cfg.min_snr_gamma is not None:
                    err = err * min_snr_weight(self._sched_dev, t,
                                               cfg.min_snr_gamma,
                                               cfg.prediction_type)
                # "loss" is always reported in the reference's SUM-MSE /
                # (global batch * lc^4) scale; the gradient follows
                # loss_reduction
                ref_loss = err.sum() / (tc.batch_size
                                        * float(cfg.latent_channels) ** 4)
                mse = err.mean()
                opt.zero_grad(set_to_none=True)
                (ref_loss if cfg.loss_reduction == "ref" else mse).backward()
        finally:
            unet.eval()
        metrics = {"loss": ref_loss.detach(), "noise_mse": mse.detach()}
        group = batch_group(self.mesh)
        if group is not None:
            # ref_loss is a share of the global sum, mse a local mean
            reduce_gradients(unet.parameters(), group,
                             average=cfg.loss_reduction != "ref")
            metrics = reduce_metrics(metrics, group, sums=("loss",))
        opt.step()
        self._update_ema()
        self.step += 1
        return metrics

    @torch.no_grad()
    def _update_ema(self) -> None:
        """ema = d * ema + (1 - d) * params with the warm-up
        d = min(decay, (1 + n) / (10 + n)) at step n, in float32; the EMA
        copy reads the live BatchNorm statistics."""
        if self.ema_unet is None:
            return
        n = np.float32(self.step)
        d = min(np.float32(self.train_cfg.ema_decay),
                (np.float32(1) + n) / (np.float32(10) + n))
        ema = list(self.ema_unet.parameters())
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, list(self.model.unet.parameters()),
                            alpha=float(np.float32(1) - d))
        for e, b in zip(self.ema_unet.buffers(), self.model.unet.buffers()):
            e.copy_(b)

    def train_step(self, images: torch.Tensor,
                   context: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on volumes (NDHWC): encode through the frozen stage-1,
        then as `train_step_latents`."""
        return self._train_on(self.encode_latents(images), context, t, noise,
                              drop)

    def train_step_latents(self, latents: torch.Tensor,
                           context: Optional[torch.Tensor] = None,
                           t: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None,
                           drop: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
        """One step on latents in diffusion space (NDHWC): t ~ U[0, T),
        Gaussian noise and, with cfg_dropout, the null context token on a
        Bernoulli(cfg_dropout) subset, unless injected (t [B] int, noise
        like latents, drop [B] bool). Returns {"loss" (reference scale),
        "noise_mse"} as 0-dim tensors on the device."""
        return self._train_on(latents.to(self.device), context, t, noise,
                              drop)

    # -- sampling ---------------------------------------------------------

    @torch.no_grad()
    def generate(self, latent_shape, context: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 init_noise: Optional[torch.Tensor] = None,
                 step_noise: Optional[Callable[[int], torch.Tensor]] = None,
                 use_ema: bool = True, sampler: str = "ddpm",
                 sample_steps: Optional[int] = None, eta: float = 0.0,
                 guidance_scale: Optional[float] = None, last_step: int = 0,
                 decode: bool = True) -> torch.Tensor:
        """Sample latents from x_T and, with `decode`, VQ-decode them.

        sampler: "ddpm" is the T-step chain down to `last_step`; "ddim"
        (with `eta`), "dpmpp" and "dpmpp_sde" take `sample_steps` U-Net
        calls (default max(T // 20, 1)). `guidance_scale` s runs
        classifier-free guidance: one U-Net call over [x; x] with contexts
        [context; null], eps = eps_u + s (eps_c - eps_u); it needs a
        conditional model trained with cfg_dropout > 0. Samples from the
        EMA weights when they are loaded (`use_ema=False` forces the raw
        weights). Noise is drawn from `generator` (on this trainer's
        device) unless `init_noise` / `step_noise` inject it (see
        `ldm3d_torch.diffusion.ddpm`). Returns volumes [B, H, W, D, out]
        (NDHWC), or with `decode=False` the latents in diffusion space,
        float32 (a decode in the compute dtype upcast).
        Over a space mesh every process samples the same whole latents,
        each U-Net call and the decode run on depth slabs, and the whole
        volume is returned on every process."""
        with mesh_sharding(self.mesh):
            return self._generate(
                latent_shape, context, generator, init_noise, step_noise,
                use_ema, sampler, sample_steps, eta, guidance_scale,
                last_step, decode)

    def _generate(self, latent_shape, context, generator, init_noise,
                  step_noise, use_ema, sampler, sample_steps, eta,
                  guidance_scale, last_step, decode) -> torch.Tensor:
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        if guidance_scale is not None:
            if not self.conditional:
                raise ValueError(
                    "guidance_scale requires a conditional model")
            if self.cfg.unet.cfg_dropout <= 0:
                raise ValueError(
                    "guidance_scale requires a model trained with "
                    "cfg_dropout > 0; this model never learned the null "
                    "context token, so guided sampling would be a silent "
                    "no-op")
        unet = self.ema_unet if (use_ema and self.ema_unet is not None) \
            else self.model.unet
        if self.conditional:
            if context is None:
                raise ValueError("conditional model requires a context")
            context = context.to(self.device)
        else:
            context = None
        ptype = self.cfg.prediction_type
        sched = self._sched_dev
        axis = spatial.SPATIAL_AXIS

        def net(x, t, c):
            """The U-Net on whole latents, over slabs where they split."""
            out = unet(spatial.shard_spatial(x), t, c)
            return spatial.gather(out, axis) \
                if spatial.shards(x.shape[axis]) else out

        def denoise(x, t):
            if guidance_scale is None:
                return model_out_to_eps(sched, x, t, net(x, t, context),
                                        ptype)
            null = torch.full_like(context, self.cfg.unet.context_dim + 1)
            x2, t2 = torch.cat([x, x]), torch.cat([t, t])
            out = model_out_to_eps(sched, x2, t2,
                                   net(x2, t2, torch.cat([context, null])),
                                   ptype)
            eps_c, eps_u = out.chunk(2)
            return eps_u + guidance_scale * (eps_c - eps_u)

        if generator is None and (init_noise is None or (
                step_noise is None and sampler != "dpmpp")):
            raise ValueError("generate needs a generator or injected noise")
        shape = tuple(latent_shape)
        common = dict(generator=generator, device=self.device,
                      clip_value=self.cfg.clip_sample_range,
                      init_noise=init_noise)
        steps = sample_steps or max(self.cfg.timesteps // 20, 1)
        if sampler == "ddim":
            latents = sample_latents_ddim(
                self.sched, denoise, shape, num_steps=steps, eta=eta,
                step_noise=step_noise, **common)
        elif sampler == "dpmpp":
            latents = sample_latents_dpmpp(self.sched, denoise, shape,
                                           num_steps=steps, **common)
        elif sampler == "dpmpp_sde":
            latents = sample_latents_dpmpp_sde(
                self.sched, denoise, shape, num_steps=steps,
                step_noise=step_noise, **common)
        else:
            latents = sample_latents(self.sched, denoise, shape,
                                     last_step=last_step,
                                     step_noise=step_noise, **common)
        if not decode:
            return latents
        with deterministic_cudnn():
            return at_least_float32(self.model.decode(latents))

    # -- fidelity ---------------------------------------------------------

    def latent_features(self, images: torch.Tensor) -> np.ndarray:
        """Pooled frozen-encoder features of volumes (NDHWC) for the latent
        fidelity metrics, [B, 2C] float64 numpy. The features are in the
        raw codebook range (divided by latent_scale): the Frechet distance
        scales with the features' scale squared, so FID numbers stay
        comparable across latent_scale recipes."""
        lat = self.encode_latents(images)
        if self.cfg.latent_scale != 1.0:
            lat = lat / self.cfg.latent_scale
        return pool_latent_features(lat.cpu().numpy())

    def fidelity_eval(self, real_feats: np.ndarray,
                      generator: torch.Generator, num_samples: int = 64,
                      batch: int = 16, sampler: str = "ddim",
                      sample_steps: Optional[int] = None,
                      guidance_scale: Optional[float] = None,
                      eta: float = 0.0, real_ctx=None) -> dict:
        """Generate `num_samples` latents (split evenly over the context
        values 0..context_dim of a conditional model), in batches of
        `batch` with noise from `generator`, and score them against
        `real_feats` with latent-FID and kernel-MMD (`ops.fid`).

        With `real_ctx` (the context label of each row of `real_feats`; a
        conditional model only) it also reports, from the same samples,
        `fid_same_c{c}` (the ctx = c samples against the ctx = c real rows),
        `fid_cross_c{c}` (against the other rows) and `fid_class_sep`, the
        mean of cross - same; a context with fewer than 2 rows on either
        side is skipped."""
        ls = self.cfg.latent_size
        shape = (batch, ls, ls, ls, self.cfg.latent_channels)
        contexts = (list(range(self.cfg.unet.context_dim + 1))
                    if self.conditional else [None])
        per = max(num_samples // len(contexts), 1)
        feats_by_ctx: Dict = {c: [] for c in contexts}
        for c in contexts:
            ctx = None if c is None else torch.full(
                (batch,), c, dtype=torch.long, device=self.device)
            done = 0
            while done < per:
                lats = self.generate(shape, ctx, generator=generator,
                                     sampler=sampler,
                                     sample_steps=sample_steps, eta=eta,
                                     guidance_scale=guidance_scale,
                                     decode=False)
                n = min(batch, per - done)
                if self.cfg.latent_scale != 1.0:
                    lats = lats / self.cfg.latent_scale
                feats_by_ctx[c].append(
                    pool_latent_features(lats[:n].cpu().numpy()))
                done += n
        gen_all = np.concatenate(
            [f for fs in feats_by_ctx.values() for f in fs], axis=0)
        out = latent_fidelity(real_feats, gen_all)
        if real_ctx is not None and self.conditional:
            labels = np.asarray(real_ctx).reshape(-1)
            real = np.asarray(real_feats)
            seps = []
            for c in contexts:
                same, cross = real[labels == c], real[labels != c]
                if same.shape[0] < 2 or cross.shape[0] < 2:
                    continue
                gen_c = np.concatenate(feats_by_ctx[c], axis=0)
                f_same = frechet_distance(same, gen_c)
                f_cross = frechet_distance(cross, gen_c)
                out[f"fid_same_c{c}"] = f_same
                out[f"fid_cross_c{c}"] = f_cross
                seps.append(f_cross - f_same)
            if seps:
                out["fid_class_sep"] = float(np.mean(seps))
        return out

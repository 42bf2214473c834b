"""VQ-GAN training: the port of `ldm3d.train.gan_trainer`.

The trainer owns its state, as the port's other trainers do: the
autoencoder (`ae`), the two PatchGAN critics (`disc3d` over volumes,
`disc2d` over one random frame per volume) and the frozen LPIPS, their
BatchNorm statistics and the quantizer's buffers; two Adam optimizers
(`optimizer` over the autoencoder at `learning_rate`, the one a plateau
schedule changes; `disc_optimizer` over both critics at
`disc_learning_rate`); the step, the epoch and the generator that every
random draw comes from (the quantizer's, the frame indices).

A step is one backward pass over ae_loss + disc_loss, with `detach()`
walls where the JAX step puts `stop_gradient`: the critics' parameters
are frozen on the generator's path, the reconstruction is detached on
the critics' fake path, and the real features that feature matching reads
are detached. The input is concat(volume, mask); the loss is L1
reconstruction + the quantizer's loss + lpips_wt x LPIPS on the frames,
and, from `disc_threshold` epochs on, the adversarial terms. The critics'
real forwards run in training mode and update their BatchNorm statistics;
every fake forward, R1's and the adaptive weight's run in eval mode on
the updated statistics, and gradients reach the critics through those
statistics, as in JAX, where the statistics a flax BatchNorm returns
are traced values. Before `disc_threshold` the warm program runs no
critic at all, and the critics take an Adam step with zero gradients, so
that their parameters stay as they were while Adam's step count moves on.
The autoencoder and both critics compute in `train_cfg.dtype`
(`layers.set_compute_dtype`; bfloat16 by default, as the JAX trainer
builds them), LPIPS in float32 on the upcast reconstruction; the losses,
the adaptive weight and R1's input gradients are float32.

With a `mesh` of several processes each holds its rows of every global
batch, as in the other trainers: the frame indices are the global
batch's, sliced; BatchNorm (the critics' live statistics included) and
the quantizer's statistics are the global batch's; both optimizers'
gradients are averaged over the data group; the adaptive weight's
gradient norms are those of the global batch's gradients; R1, a mean of
per-sample terms, is averaged with the rest of the metrics. With a
'space' axis the autoencoder runs on depth slabs inside
`parallel.spatial.spatial_sharding` (the L1 term is each process's slab
mean), and everything after it (the frames, LPIPS, both critics, R1, the
adaptive weight) on the gathered volumes inside `spatial.whole()`, whole
on every process of the space group; both optimizers' gradients and the
metrics are averaged over the data x space group. With a 'model' axis
the autoencoder's and both critics' wide conv kernels and vectors (and
both optimizers' moments) are split over the model group
(`parallel.tp`; the steps run inside `tp.mesh_sharding`), LPIPS stays
whole; `state_dict` / `load_state_dict` hold whole tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ldm3d_torch.convert import (convert_gan_state, gan_flax_state,
                                 module_state)
from ldm3d_torch.core.config import (TrainConfig, VQGANConfig,
                                     compute_dtype)
from ldm3d_torch.core.device import resolve_device
from ldm3d_torch.models.layers import (INIT_SCHEMES, _BatchNorm,
                                       at_least_float32, set_compute_dtype)
from ldm3d_torch.models.lpips import (LPIPS, calibrate_lpips_,
                                      calibration_frames, load_lpips_params)
from ldm3d_torch.models.quantizers import Draws, QuantAux
from ldm3d_torch.models.vqgan import (Discriminator2D, Discriminator3D,
                                      VQGANAutoencoder, hinge_d_loss,
                                      vanilla_d_loss)
from ldm3d_torch.ops.metrics import volume_psnr, volume_ssim
from ldm3d_torch.parallel import spatial, tp
from ldm3d_torch.parallel.distributed import (all_reduce_sum,
                                              reduce_gradients,
                                              reduce_metrics)
from ldm3d_torch.parallel.mesh import (attach_data_group, batch_group,
                                       data_group, data_shard)
from ldm3d_torch.parallel.tp import mesh_sharding


class VQGANModules(nn.Module):
    """The four networks of a VQ-GAN under the JAX state's names: `ae`,
    `disc3d`, `disc2d` and `lpips`."""

    def __init__(self, cfg: VQGANConfig, volume_size: int):
        super().__init__()
        img_ch = cfg.ae.in_channels // 2
        self.ae = VQGANAutoencoder(cfg.ae)
        self.disc3d = Discriminator3D(cfg.disc, img_ch, volume_size)
        self.disc2d = Discriminator2D(cfg.disc, img_ch)
        self.lpips = LPIPS()

    def flax_state(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The JAX GAN state's collections (`convert.gan_flax_state`)."""
        return gan_flax_state(self)


@contextlib.contextmanager
def _frozen(*modules: nn.Module):
    """The modules' parameters as constants inside the block (the
    generator's path through the critics)."""
    params = [p for m in modules for p in m.parameters()
              if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _cf(x: torch.Tensor) -> torch.Tensor:
    """Channels last -> channels first (NDHWC -> NCDHW, NHWC -> NCHW)."""
    return x.movedim(-1, 1)


def _rgb(frames: torch.Tensor) -> torch.Tensor:
    """[B, W, D, 1] frames -> [B, 3, W, D], the gray channel tiled."""
    return _cf(frames).expand(-1, 3, -1, -1)


class GANTrainer:
    """Trains a `VQGANConfig` on one device; the networks are in
    training mode only inside `train_step`."""

    def __init__(self, cfg: VQGANConfig, train_cfg: Optional[TrainConfig]
                 = None, device=None, volume_size: int = 128, mesh=None):
        self.cfg = cfg
        self.train_cfg = train_cfg or TrainConfig()
        self.device = resolve_device(device)
        self.volume_size = volume_size
        self.model = VQGANModules(cfg, volume_size).to(self.device).eval()
        self.mesh = mesh
        attach_data_group(self.model, mesh)
        self.ae, self.disc3d = self.model.ae, self.model.disc3d
        self.disc2d, self.lpips = self.model.disc2d, self.model.lpips
        for m in (self.ae, self.disc3d, self.disc2d):   # LPIPS: frozen
            tp.shard_module(m, mesh)
            set_compute_dtype(m, compute_dtype(self.train_cfg.dtype))
        # the critics' fake, R1 and adaptive forwards read the statistics
        # of their real forward as JAX does, gradients included
        self._critic_norms = [m for d in (self.disc3d, self.disc2d)
                              for m in d.modules()
                              if isinstance(m, _BatchNorm)]
        for m in self._critic_norms:
            m.live_stats_graph = True
        self.d_loss = vanilla_d_loss if cfg.disc_loss_fn == "vanilla" \
            else hinge_d_loss
        tc = self.train_cfg
        # optax adam's math, eps 1e-8; learning rates in float32 as
        # optax's injected hyper-parameters are
        self.optimizer = torch.optim.Adam(
            self.ae.parameters(), lr=float(np.float32(tc.learning_rate)),
            betas=(tc.adam_b1, tc.adam_b2), eps=1e-8)
        self.disc_optimizer = torch.optim.Adam(
            [*self.disc3d.parameters(), *self.disc2d.parameters()],
            lr=float(np.float32(tc.disc_learning_rate)),
            betas=(tc.adam_b1, tc.adam_b2), eps=1e-8)
        self.generator = torch.Generator(device=self.device).manual_seed(
            tc.seed)
        self.step = 0
        self.epoch = 0
        self.lpips_pretrained = False

    def init_random(self, seed: int, scheme: str = "jax") -> "GANTrainer":
        """Seeded random weights, the JAX package's init (`layers.init_jax_`)
        or, with scheme "reach", `layers.init_params_`; LPIPS from
        $LDM3D_LPIPS_WEIGHTS, or else the self-calibrated random-feature
        surrogate over the random trunk (with a warning)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with tp.whole_parameters(self.model, self.mesh):
            INIT_SCHEMES[scheme](self.model, gen)
        flat = load_lpips_params()
        self.lpips_pretrained = flat is not None
        if flat is not None:
            self.lpips.load_state_dict(module_state(flat), strict=True)
        else:
            warnings.warn(
                "LPIPS: no pretrained weights found (set "
                "LDM3D_LPIPS_WEIGHTS to a converted .npz). Using the "
                "deterministic random-feature surrogate with self-"
                "calibrated linear heads; perceptual-loss values are NOT "
                "comparable to trained-LPIPS runs.", stacklevel=2)
            frames = calibration_frames(
                (self.volume_size, self.volume_size),
                torch.Generator(device=self.device).manual_seed(0))
            calibrate_lpips_(self.lpips, *frames)
        return self

    # -- state ------------------------------------------------------------

    def state_dict(self) -> dict:
        """The whole training state: the four networks (weights,
        BatchNorm statistics, quantizer buffers), both optimizers, the
        step, the epoch, the generator's state and the config. Tensors
        are the live ones. Under a 'model' axis the sharded tensors are
        gathered whole (a collective)."""
        dims = tp.param_dims(self.model)
        return {
            "model": tp.whole_state(self.model, self.model.state_dict(),
                                    self.mesh),
            "optimizer": tp.whole_optimizer_state(
                self.optimizer, self.optimizer.state_dict(), dims,
                self.mesh),
            "disc_optimizer": tp.whole_optimizer_state(
                self.disc_optimizer, self.disc_optimizer.state_dict(), dims,
                self.mesh),
            "step": self.step,
            "epoch": self.epoch,
            "generator": self.generator.get_state(),
            "vqgan_cfg": dataclasses.asdict(self.cfg),
        }

    def load_state_dict(self, state: dict, optimizer: bool = True) -> None:
        """Restore `state_dict()`'s output onto this trainer's device; with
        `optimizer=False` (evaluation only) both Adams are left. The state
        holds whole tensors; this process keeps its shards."""
        self.model.load_state_dict(
            tp.sliced_state(self.model, state["model"], self.mesh),
            strict=True)
        if optimizer:
            dims = tp.param_dims(self.model)
            for opt, key in ((self.optimizer, "optimizer"),
                             (self.disc_optimizer, "disc_optimizer")):
                opt.load_state_dict(tp.sliced_optimizer_state(
                    opt, state[key], dims, self.mesh))
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
        self.generator.set_state(state["generator"].cpu())

    def snapshot_modules(self) -> Tuple[nn.Module, None]:
        """(the four networks, None): a VQ-GAN has no EMA copy."""
        return self.model, None

    @staticmethod
    def convert_snapshot(arrays) -> Tuple[Dict[str, torch.Tensor], None]:
        """(networks' state, None) of a snapshot's arrays."""
        return convert_gan_state(arrays), None

    def load_state_dicts(self, model_state: Dict[str, torch.Tensor],
                         ema_state: None = None) -> None:
        """Load `convert_snapshot`'s output (strict)."""
        if ema_state is not None:
            raise ValueError("a VQ-GAN snapshot has no ema_params")
        self.model.load_state_dict(
            tp.sliced_state(self.model, model_state, self.mesh), strict=True)

    # -- the losses -------------------------------------------------------

    def _batch(self, vol, mask):
        """On the device, in the networks' type (float32; a float64 twin
        serves as a reference)."""
        dtype = next(self.ae.parameters()).dtype
        return vol.to(self.device, dtype), mask.to(self.device, dtype)

    def _frame_indices(self, h: int, b: int, draws: Draws) -> torch.Tensor:
        """One frame index per item, uniform in frame_idx_range clipped to
        the volume."""
        lo, hi = self.cfg.frame_idx_range
        hi = min(hi, h)
        lo = min(lo, hi - 1)
        return draws.randint(lo, hi, (b,), self.device, rows=True)

    def _forward_losses(self, vol, mask, draws: Draws, training: bool,
                        warm: bool = False):
        """(total loss, metrics, reconstruction of the image channel,
        volume), the JAX `_forward_losses`; the last two whole. In
        training the networks must be in training mode; in eval, under
        no_grad. Runs inside `mesh_sharding(self.mesh)`."""
        x = torch.cat([vol, mask], dim=-1)
        recon, aux = self.ae(x, draws)
        img_recon = at_least_float32(recon[..., :vol.shape[-1]])
        recon_loss = torch.mean(torch.abs(img_recon - vol))
        img_recon, vol = (spatial.gather(a, spatial.SPATIAL_AXIS)
                          for a in (img_recon, vol))
        with spatial.whole():
            total, metrics = self._whole_losses(
                vol, img_recon, recon_loss, aux, draws, training, warm)
        return total, metrics, img_recon, vol

    def _whole_losses(self, vol, img_recon, recon_loss, aux, draws,
                      training: bool, warm: bool):
        """The terms on whole volumes: LPIPS on the frames, the critics,
        R1 and the adaptive weight."""
        cfg = self.cfg
        b, h = vol.shape[0], vol.shape[1]

        frame_idx = self._frame_indices(h, b, draws).long()
        rows = torch.arange(b, device=vol.device)
        frames = vol[rows, frame_idx]                    # [B, W, D, C]
        frames_recon = img_recon[rows, frame_idx]
        f3 = _rgb(frames)
        perceptual = torch.mean(self.lpips(f3, _rgb(frames_recon)))
        q_loss = at_least_float32(aux.loss)
        zero = torch.zeros((), device=vol.device)

        if warm:
            ae_loss = recon_loss + q_loss + cfg.lpips_wt * perceptual
            metrics = {"loss": ae_loss, "reconst_loss": recon_loss,
                       "quantize_loss": q_loss, "gen_loss": zero,
                       "disc_loss": zero, "gan_feat_loss": zero,
                       "perceptual_loss": perceptual,
                       "perplexity": aux.perplexity}
            if cfg.adaptive_g_weight:
                metrics["adaptive_weight"] = zero
            return ae_loss, metrics

        gate = float(self.epoch >= cfg.disc_threshold)
        g_gate = float(self.epoch >= cfg.disc_threshold + cfg.g_adv_delay)
        vol_c, frames_c = _cf(vol), _cf(frames)
        recon_c, frames_recon_c = _cf(img_recon), _cf(frames_recon)
        # the critics on real inputs: training mode updates the statistics
        real_logits, real_feat = self.disc3d(vol_c)
        real_logits2, real_feat2 = self.disc2d(frames_c)
        self.disc3d.eval()
        self.disc2d.eval()
        try:
            fake_logits, _ = self.disc3d(recon_c.detach())
            fake_logits2, _ = self.disc2d(frames_recon_c.detach())
            with _frozen(self.disc3d, self.disc2d):
                fake_logits_g, fake_feat_g = self.disc3d(recon_c)
                fake_logits2_g, fake_feat2_g = self.disc2d(frames_recon_c)
                adv_w = torch.tensor(cfg.g_loss_adv_wt, device=vol.device)
                if cfg.adaptive_g_weight:
                    adv_w = adv_w * self._adaptive_lambda(
                        img_recon, vol, f3, rows, frame_idx)
            r1 = zero
            if cfg.r1_gamma > 0:
                r1 = self._r1(vol_c, frames_c, b, create_graph=training)
        finally:
            if training:
                self.disc3d.train()
                self.disc2d.train()

        # the critics' losses in their compute dtype, read in float32
        if cfg.g_adv_style == "bce":
            g_adv = at_least_float32(self.d_loss(True, fake_logits_g)
                                     + self.d_loss(True, fake_logits2_g))
        else:
            g_adv = at_least_float32(-torch.mean(fake_logits_g)
                                     - torch.mean(fake_logits2_g))
        feat_w = 4.0 / (3 + 1)
        feat_loss = zero
        for fa, fb in [*zip(fake_feat_g[:-1], real_feat[:-1]),
                       *zip(fake_feat2_g[:-1], real_feat2[:-1])]:
            feat_loss = feat_loss + feat_w * torch.mean(torch.abs(
                at_least_float32(fa) - at_least_float32(fb.detach())))

        ae_loss = (recon_loss + q_loss + cfg.lpips_wt * perceptual
                   + g_gate * (cfg.gan_feat_wt * feat_loss + adv_w * g_adv))
        disc_loss = (self.d_loss(True, real_logits)
                     + self.d_loss(False, fake_logits)
                     + self.d_loss(True, real_logits2)
                     + self.d_loss(False, fake_logits2))
        disc_loss = gate * cfg.disc_wt * at_least_float32(disc_loss)
        if cfg.r1_gamma > 0:
            disc_loss = disc_loss + gate * r1
        metrics = {"loss": ae_loss, "reconst_loss": recon_loss,
                   "quantize_loss": q_loss, "gen_loss": g_gate * g_adv,
                   "disc_loss": disc_loss,
                   "gan_feat_loss": g_gate * feat_loss,
                   "perceptual_loss": perceptual,
                   "perplexity": aux.perplexity}
        if cfg.adaptive_g_weight:
            metrics["adaptive_weight"] = g_gate * adv_w
        if cfg.r1_gamma > 0:
            metrics["r1_penalty"] = gate * r1
        return ae_loss + disc_loss, metrics

    def _adaptive_lambda(self, img_recon, vol, f3, rows, frame_idx):
        """clip(||d nll / d r|| / (||d adv / d r|| + 1e-6), 0, max) at the
        detached reconstruction r, as a constant. Runs with the critics
        frozen and in eval mode."""
        cfg = self.cfg

        def nll_of(r):
            p = torch.mean(self.lpips(f3, _rgb(r[rows, frame_idx])))
            return torch.mean(torch.abs(r - vol)) + cfg.lpips_wt * p

        def adv_of(r):
            fl, _ = self.disc3d(_cf(r))
            fl2, _ = self.disc2d(_cf(r[rows, frame_idx]))
            if cfg.g_adv_style == "bce":
                return self.d_loss(True, fl) + self.d_loss(True, fl2)
            return -torch.mean(fl) - torch.mean(fl2)

        with torch.enable_grad():
            r = img_recon.detach().requires_grad_(True)
            g_r, = torch.autograd.grad(nll_of(r), r)
            r = img_recon.detach().requires_grad_(True)
            g_a, = torch.autograd.grad(adv_of(r), r)
        group = data_group(self.mesh)
        if group is None:
            lam = torch.linalg.vector_norm(g_r) / (
                torch.linalg.vector_norm(g_a) + 1e-6)
        else:
            # the global losses are the means of the processes' local
            # ones: their gradients are the local ones over the group size
            n = float(self.mesh.shape["data"])
            sq = all_reduce_sum(torch.stack([torch.sum(torch.square(g_r)),
                                             torch.sum(torch.square(g_a))]),
                                group) / (n * n)
            lam = torch.sqrt(sq[0]) / (torch.sqrt(sq[1]) + 1e-6)
        return torch.clamp(lam, 0.0, cfg.adaptive_g_max).detach()

    def _r1(self, vol_c, frames_c, b: int, create_graph: bool):
        """gamma / 2 x (E||d D3(v)/dv||^2 + E||d D2(f)/df||^2) on the real
        inputs, critics in eval mode; with `create_graph` the penalty's
        gradient reaches the critics' parameters (second order)."""
        with torch.enable_grad():
            v = vol_c.detach().requires_grad_(True)
            f = frames_c.detach().requires_grad_(True)
            g3, = torch.autograd.grad(at_least_float32(self.disc3d(v)[0]).sum(), v,
                                      create_graph=create_graph)
            g2, = torch.autograd.grad(at_least_float32(self.disc2d(f)[0]).sum(), f,
                                      create_graph=create_graph)
        return 0.5 * self.cfg.r1_gamma * (
            torch.mean(torch.sum(torch.square(g3.reshape(b, -1)), dim=-1))
            + torch.mean(torch.sum(torch.square(g2.reshape(b, -1)), dim=-1)))

    # -- steps ------------------------------------------------------------

    def _networks(self, training: bool) -> None:
        for m in (self.ae, self.disc3d, self.disc2d):
            m.train(training)

    def train_step(self, vol: torch.Tensor, mask: torch.Tensor,
                   draws: Optional[Draws] = None,
                   warm: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """One step on volumes and masks [B, H, W, D, 1] (NDHWC): the warm
        program before `disc_threshold` epochs, the adversarial one after
        (`warm` overrides the choice). Random draws come from
        `self.generator` unless `draws` injects them. Returns the metrics
        as 0-dim tensors on the device."""
        if warm is None:
            warm = self.epoch < self.cfg.disc_threshold
        vol, mask = self._batch(vol, mask)
        draws = draws or Draws(self.generator, shard=data_shard(self.mesh))
        self._networks(True)
        try:
            with mesh_sharding(self.mesh):
                total, metrics, _, _ = self._forward_losses(
                    vol, mask, draws, True, warm=bool(warm))
                self.optimizer.zero_grad(set_to_none=True)
                self.disc_optimizer.zero_grad(set_to_none=True)
                total.backward()
        finally:
            self._networks(False)
            for m in self._critic_norms:
                m.live_stats = None
        # optax updates every parameter; in the warm program the critics'
        # gradients are zeros, which keeps them and advances Adam's count
        for group in (self.optimizer, self.disc_optimizer):
            for p in group.param_groups[0]["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if batch_group(self.mesh) is not None:
            reduce_gradients(self.model.parameters(), batch_group(self.mesh))
        self.optimizer.step()
        self.disc_optimizer.step()
        self.step += 1
        return self._global({k: v.detach() for k, v in metrics.items()})

    def _global(self, metrics: Dict) -> Dict:
        """Metrics of the global batch: means over the data x space group;
        the perplexity and the adaptive weight are already global."""
        group = batch_group(self.mesh)
        if group is None:
            return metrics
        return reduce_metrics(metrics, group,
                              keep=("perplexity", "adaptive_weight"))

    @torch.no_grad()
    def eval_step(self, vol: torch.Tensor, mask: torch.Tensor,
                  seed: int = 0, draws: Optional[Draws] = None
                  ) -> Dict[str, torch.Tensor]:
        """The adversarial program's metrics in eval mode (no state
        changes), plus "ssim" and "psnr" of the image channel. The frames
        come from a generator seeded with `seed` unless `draws` injects
        them."""
        vol, mask = self._batch(vol, mask)
        if draws is None:
            draws = Draws(torch.Generator(device=self.device)
                          .manual_seed(seed), shard=data_shard(self.mesh))
        with mesh_sharding(self.mesh):
            _, metrics, img_recon, vol = self._forward_losses(
                vol, mask, draws, False)
            with spatial.whole():
                metrics["ssim"] = volume_ssim(img_recon, vol)
                metrics["psnr"] = volume_psnr(img_recon, vol)
        return self._global(metrics)

    def next_epoch(self) -> None:
        """The epoch counter that gates the adversarial terms."""
        self.epoch += 1

    @torch.no_grad()
    def reconstruct(self, vol: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, QuantAux]:
        """(reconstruction [B, H, W, D, out] in float32, QuantAux) in eval
        mode (over a space mesh, this process's depth slab)."""
        vol, mask = self._batch(vol, mask)
        with mesh_sharding(self.mesh):
            recon, aux = self.ae(torch.cat([vol, mask], dim=-1))
            return at_least_float32(recon), aux

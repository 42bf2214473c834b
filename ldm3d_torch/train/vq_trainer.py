"""Stage-1 VQ-VAE training: the port of `ldm3d.train.vq_trainer`.

The trainer owns its state, as the port's `DiffusionTrainer` does: the
model on one device (weights, BatchNorm statistics, the quantizer's usage
and EMA buffers), Adam over every parameter (its learning rate is the one
a plateau schedule changes), the step count and the generator that every
random draw of a step comes from (dropout masks, quantizer noise, the EMA
quantizer's random rows, the replacement's donors). `state_dict` carries
all of it, so that a restored trainer goes on exactly as the saving one.

The loss is the reconstruction MSE of the image channel plus
`quantize_loss_weight` times the quantizer's loss; a 2-channel config
trains on concat(volume, mask). Eval adds per-slice SSIM and PSNR.
The model computes in `train_cfg.dtype` (`layers.set_compute_dtype`, as
the JAX trainer builds its module with that dtype): activations bfloat16
by default, parameters, Adam's state and the BatchNorm statistics
float32. The reconstruction is upcast for the loss and the metrics, and
the codebook search and statistics run in float32.

With a `mesh` of several processes each holds its rows of every global
batch, and with a 'space' axis its depth slab of each volume
(`parallel.mesh.shard_batch(..., spatial_axis=3)`); the steps run inside
`parallel.spatial.spatial_sharding`. Per-row and per-voxel draws
(dropout, NSVQ noise) are the global batch's, sliced; BatchNorm and the
quantizer's statistics are the global batch's; gradients are averaged
and metrics reduced over the data x space group (each process's loss is
its slab's mean), so that the codebooks and weights stay equal on every
process. SSIM and PSNR are taken on the gathered volumes. With a 'model'
axis the model's wide conv kernels and vectors are split over the model
group (`parallel.tp`; the steps run inside `tp.mesh_sharding`); Adam's
moments follow them, and `state_dict` / `load_state_dict` hold whole
tensors, one process's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ldm3d_torch.core.config import (TrainConfig, VQVAEConfig,
                                     compute_dtype)
from ldm3d_torch.core.device import resolve_device
from ldm3d_torch.models.layers import (INIT_SCHEMES, _BatchNorm,
                                       at_least_float32, set_compute_dtype)
from ldm3d_torch.models.quantizers import (Draws, QuantAux,
                                           replace_unused_codebooks,
                                           replace_unused_codebooks_staged)
from ldm3d_torch.models.emavqvae import EMASkipTrainable
from ldm3d_torch.models.vqvae import VQVAE
from ldm3d_torch.models.vqvae_legacy import LegacyVQVAE
from ldm3d_torch.ops.metrics import volume_psnr, volume_ssim
from ldm3d_torch.ops.quantize import perplexity_from_counts
from ldm3d_torch.parallel import tp
from ldm3d_torch.parallel.distributed import (reduce_gradients,
                                              reduce_metrics)
from ldm3d_torch.parallel.mesh import (attach_data_group, batch_group,
                                       data_shard)
from ldm3d_torch.parallel.spatial import SPATIAL_AXIS, gather
from ldm3d_torch.parallel.tp import mesh_sharding

def make_stage1(cfg: VQVAEConfig) -> nn.Module:
    """The model of `cfg.family`: "monai" (`VQVAE`), "ema_skip"
    (`EMASkipTrainable`: num_channels[0] filters, the quantizer's K and D)
    or "legacy" (`LegacyVQVAE` of legacy_mode and legacy_down). Each
    maps NDHWC volumes and draws to (reconstruction, QuantAux)."""
    if cfg.family == "ema_skip":
        return EMASkipTrainable(
            num_channels=cfg.out_channels, num_filters=cfg.num_channels[0],
            embedding_dim=cfg.quantizer.embedding_dim,
            num_embeddings=cfg.quantizer.num_embeddings,
            in_channels=cfg.in_channels)
    if cfg.family == "legacy":
        return LegacyVQVAE(
            latent_dim=cfg.quantizer.embedding_dim,
            num_embeddings=cfg.quantizer.num_embeddings,
            mode=cfg.legacy_mode, down=cfg.legacy_down,
            out_channels=cfg.out_channels, in_channels=cfg.in_channels)
    if cfg.family != "monai":
        raise ValueError(f"unknown VQ-VAE family {cfg.family!r}")
    return VQVAE(cfg)


class VQTrainer:
    """Trains a stage-1 model of `cfg.family` (`make_stage1`) on one
    device. The model is in training mode only inside `train_step` and
    `recalibrate_batch_stats`."""

    def __init__(self, cfg: VQVAEConfig,
                 train_cfg: Optional[TrainConfig] = None, device=None,
                 mesh=None):
        self.cfg = cfg
        self.train_cfg = train_cfg or TrainConfig()
        self.device = resolve_device(device)
        self.model = make_stage1(cfg).to(self.device).eval()
        set_compute_dtype(self.model, compute_dtype(self.train_cfg.dtype))
        self.mesh = mesh
        attach_data_group(self.model, mesh)
        tp.shard_module(self.model, mesh)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.train_cfg.seed)
        tc = self.train_cfg
        # optax adam's math, eps 1e-8; the learning rate held in float32
        # as optax's injected hyper-parameter is
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=float(np.float32(tc.learning_rate)),
            betas=(tc.adam_b1, tc.adam_b2), eps=1e-8)
        self.step = 0

    def init_random(self, seed: int, scheme: str = "jax") -> "VQTrainer":
        """Seeded random weights: the JAX package's init (`layers.init_jax_`)
        or, with scheme "reach", `layers.init_params_`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with tp.whole_parameters(self.model, self.mesh):
            INIT_SCHEMES[scheme](self.model, gen)
        return self

    # -- state ------------------------------------------------------------

    def state_dict(self) -> dict:
        """The whole training state: the model (weights, BatchNorm
        statistics, quantizer buffers), Adam's state (moments, step
        counts, learning rate), the step, the generator's state and the
        model's config. Tensors are the live ones: serialise or copy
        before the next step. Under a 'model' axis the sharded tensors
        are gathered whole (a collective)."""
        return {
            "model": tp.whole_state(self.model, self.model.state_dict(),
                                    self.mesh),
            "optimizer": tp.whole_optimizer_state(
                self.optimizer, self.optimizer.state_dict(),
                tp.param_dims(self.model), self.mesh),
            "step": self.step,
            "generator": self.generator.get_state(),
            "vqvae_cfg": dataclasses.asdict(self.cfg),
        }

    def snapshot_modules(self) -> Tuple[nn.Module, None]:
        """(the model, None): what a `.npz` snapshot holds
        (`utils.export`); a stage-1 has no EMA copy."""
        return self.model, None

    def load_state_dicts(self, model_state: Dict[str, torch.Tensor],
                         ema_state: None = None) -> None:
        """Load `convert.convert_state`'s output (strict); a stage-1
        snapshot has no EMA collection."""
        if ema_state is not None:
            raise ValueError("a VQ-VAE snapshot has no ema_params")
        self.model.load_state_dict(
            tp.sliced_state(self.model, model_state, self.mesh), strict=True)

    def load_state_dict(self, state: dict, optimizer: bool = True) -> None:
        """Restore `state_dict()`'s output onto this trainer's device; with
        `optimizer=False` (reconstruction only) Adam's state is left. The
        state holds whole tensors; this process keeps its shards."""
        self.model.load_state_dict(
            tp.sliced_state(self.model, state["model"], self.mesh),
            strict=True)
        if optimizer:
            self.optimizer.load_state_dict(tp.sliced_optimizer_state(
                self.optimizer, state["optimizer"],
                tp.param_dims(self.model), self.mesh))
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())

    # -- steps ------------------------------------------------------------

    def _model_input(self, vol: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
        """concat(volume, mask) for a 2-channel config; the 1-channel ones
        train on the bare volume."""
        if self.cfg.in_channels > vol.shape[-1]:
            return torch.cat([vol, mask], dim=-1)
        return vol

    def _losses(self, vol: torch.Tensor, recon: torch.Tensor,
                aux: QuantAux) -> Tuple[torch.Tensor, Dict]:
        img = recon[..., :vol.shape[-1]].float()
        recon_loss = torch.mean(torch.square(img - vol))
        q_weight = self.cfg.quantizer.quantize_loss_weight
        loss = recon_loss + q_weight * aux.loss.float()
        metrics = {"loss": loss, "reconst_loss": recon_loss,
                   "quantize_loss": at_least_float32(aux.loss),
                   "perplexity": aux.perplexity}
        if aux.usage_counts.dim() == 2:
            # RNSVQ: one perplexity per stage, so that a dead later stage
            # shows in training.log
            for i, c in enumerate(aux.usage_counts):
                metrics[f"perplexity_stage{i}"] = perplexity_from_counts(c)
        return loss, metrics

    def _global(self, metrics: Dict) -> Dict:
        """Metrics of the global batch: means over the data x space group;
        the perplexities already come from global counts."""
        group = batch_group(self.mesh)
        if group is None:
            return metrics
        return reduce_metrics(metrics, group, keep=[
            k for k in metrics if k.startswith("perplexity")])

    def _batch(self, vol, mask):
        return (vol.to(self.device, torch.float32),
                mask.to(self.device, torch.float32))

    def train_step(self, vol: torch.Tensor, mask: torch.Tensor,
                   draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """One Adam step on volumes and masks [B, H, W, D, 1] (NDHWC).
        Random draws come from `self.generator` unless `draws` injects
        them. Returns {"loss", "reconst_loss", "quantize_loss",
        "perplexity"[, "perplexity_stage{i}"]} as 0-dim tensors on the
        device."""
        vol, mask = self._batch(vol, mask)
        self.model.train()       # through the backward pass: remat
        try:                     # recomputes units in training mode
            with mesh_sharding(self.mesh):
                recon, aux = self.model(
                    self._model_input(vol, mask),
                    draws or Draws(self.generator,
                                   shard=data_shard(self.mesh)))
                loss, metrics = self._losses(vol, recon, aux)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
        finally:
            self.model.eval()
        for p in self.model.parameters():
            if p.grad is None:    # optax updates every parameter
                p.grad = torch.zeros_like(p)
        if batch_group(self.mesh) is not None:
            reduce_gradients(self.model.parameters(), batch_group(self.mesh))
        self.optimizer.step()
        self.step += 1
        return self._global({k: v.detach() for k, v in metrics.items()})

    @torch.no_grad()
    def eval_step(self, vol: torch.Tensor, mask: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """The train metrics in eval mode (no state changes), plus the
        per-slice "ssim" and "psnr" of the image channel."""
        vol, mask = self._batch(vol, mask)
        with mesh_sharding(self.mesh):
            recon, aux = self.model(self._model_input(vol, mask))
            _, metrics = self._losses(vol, recon, aux)
            # per-slice metrics along H: on the whole volumes of the slabs
            img, whole = (gather(v, SPATIAL_AXIS) for v in
                          (recon[..., :vol.shape[-1]].float(), vol))
            metrics["ssim"] = volume_ssim(img, whole)
            metrics["psnr"] = volume_psnr(img, whole)
        return self._global(metrics)

    @torch.no_grad()
    def reconstruct(self, vol: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, QuantAux]:
        """(reconstruction [B, H, W, D, out] in float32, QuantAux) in eval
        mode (over a space mesh, this process's depth slab)."""
        vol, mask = self._batch(vol, mask)
        with mesh_sharding(self.mesh):
            recon, aux = self.model(self._model_input(vol, mask))
            return at_least_float32(recon), aux

    @torch.no_grad()
    def recalibrate_batch_stats(self, loader, passes: int = 3) -> None:
        """Re-estimate the BatchNorm running statistics with training-mode
        forward passes over `loader` ((vol, mask, ...) batches); weights,
        optimizer and the quantizer's state are left as they were (each
        batch's quantizer updates are undone). Dropout and quantizer draws
        come from a generator of their own, so that the training draws
        do not move."""
        if not any(isinstance(m, _BatchNorm) for m in self.model.modules()):
            return
        quantizer = self.model.quantizer
        saved = {k: b.clone() for k, b in quantizer.named_buffers()}
        gen = torch.Generator(device=self.device).manual_seed(
            self.train_cfg.seed + 0x5eca11b + self.step)
        self.model.train()
        try:
            for _ in range(passes):
                for batch in loader:
                    vol, mask = self._batch(batch[0], batch[1])
                    with mesh_sharding(self.mesh):
                        self.model(self._model_input(vol, mask),
                                   Draws(gen, shard=data_shard(self.mesh)))
                    for k, b in quantizer.named_buffers():
                        b.copy_(saved[k])
        finally:
            self.model.eval()

    # -- codebook maintenance ---------------------------------------------

    @torch.no_grad()
    def replace_unused(self, num_batches: int,
                       draws: Optional[Draws] = None) -> int:
        """Epoch-end replacement of unused codes; returns how many were
        replaced. ste / nsvq re-seed dead rows of the codebook, rnsvq each
        stage from its own used rows; the EMA kinds restart dead codes
        inside the training step, so this is a no-op for them. Adam's
        moments of the codebook are left as they are, as in JAX."""
        kind = self.cfg.quantizer.kind
        thresh = self.cfg.quantizer.discarding_threshold
        q = self.model.quantizer
        draws = draws or Draws(self.generator)
        if kind in ("ste", "nsvq"):
            new_cb, new_usage, n = replace_unused_codebooks(
                q.codebook.detach(), q.codebooks_used, num_batches, draws,
                thresh)
            q.codebook.copy_(new_cb)
        elif kind == "rnsvq":
            new_cb, new_usage, n = replace_unused_codebooks_staged(
                q.codebooks.detach(), q.codebooks_used, num_batches, draws,
                thresh)
            q.codebooks.copy_(new_cb)
        else:
            return 0
        q.codebooks_used.copy_(new_usage)
        return int(n)


def load_stage1_checkpoint(directory: str, vqvae: VQVAE,
                           epoch: Optional[int] = None) -> int:
    """Load the VQ-VAE of a `--train_vq` checkpoint directory (its latest
    epoch unless `epoch`) into `vqvae`, e.g. a diffusion trainer's frozen
    stage-1. A checkpoint of another architecture (names or shapes that
    differ) is refused before anything is loaded. Returns the epoch."""
    from ldm3d_torch.train.checkpoint import CheckpointManager
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no stage-1 checkpoint directory "
                                f"{directory}")
    state, epoch = CheckpointManager(directory).restore(epoch)
    saved, want = state["model"], vqvae.state_dict()
    differ = sorted(set(want) ^ set(saved)) + [
        f"{k}: {tuple(saved[k].shape)} saved, {tuple(t.shape)} here"
        for k, t in want.items()
        if k in saved and (saved[k].shape != t.shape
                           or saved[k].dtype != t.dtype)]
    if differ:
        raise ValueError(
            f"the stage-1 checkpoint {directory} (epoch {epoch}) is of "
            f"another VQ-VAE than this one: {len(differ)} entries differ "
            f"({'; '.join(differ[:3])}). It was trained as "
            f"{state.get('vqvae_cfg')}; this model's stage-1 is "
            f"{dataclasses.asdict(vqvae.cfg)}. Train the stage-1 with the "
            "diffusion preset's own VQ-VAE (vqvae_dm_stage1 for dm3d and "
            "conditional_dm3d, with the same --norm).")
    vqvae.load_state_dict(saved, strict=True)
    return epoch

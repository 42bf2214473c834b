"""MONAI-style 3D VQ-VAE: the port of `ldm3d.models.vqvae` (encoder,
quantizer and decoder).

Encoder: per level a k4 stride-2 conv (or the space-to-depth stem at level
0), ReLU and N residual units, then a conv3 to the latent width + PReLU.
Decoder: stem conv3 + PReLU, then per level N residual units and a
TF-exact stride-2 transposed conv, ReLU between levels. Dropout, in
training mode only, sits where the JAX module has it: after each
downsampling conv but the first and after the latent conv, after the
decoder's stem and after each upsampling conv but the last. NCDHW inside;
`VQVAE.forward`, `encode`, `encode_quantize` and `decode` take and return
NDHWC like the JAX module.

With `remat` each residual unit is recomputed in the backward pass
(`torch.utils.checkpoint`); `remat_policy="conv"` keeps the convolutions'
outputs and recomputes the rest. BatchNorm's running statistics are
updated once per step either way, as flax's `nn.remat` does.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ldm3d_torch.core.config import VQVAEConfig
from ldm3d_torch.models.layers import (Conv3d, ConvTranspose3d, Norm, PReLU,
                                       _BatchNorm, act_layer)
from ldm3d_torch.models.quantizers import Draws, QuantAux, make_quantizer
from ldm3d_torch.parallel import spatial, tp
from ldm3d_torch.parallel.halo import halo_exchange


class VQVAEResidualUnit(nn.Module):
    """conv3 -> act -> conv3 -> norm -> PReLU, ReLU of the skip sum."""

    def __init__(self, input_channels: int, num_res_channels: int,
                 act: str = "relu", norm: str = "batch"):
        super().__init__()
        self.conv1 = Conv3d(input_channels, num_res_channels, 3)
        self.act1 = act_layer(act, num_res_channels)
        self.conv2 = Conv3d(num_res_channels, input_channels, 3)
        self.norm = Norm(norm, input_channels)
        self.prelu = PReLU(input_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act1(self.conv1(x))
        h = self.prelu(self.norm(self.conv2(h)))
        return F.relu(x + h)


def space_to_depth3d(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NCDHW [B, C, D, H, W] -> [B, r^3 C, D/r, H/r, W/r], channels in the
    JAX package's parity-major order (qd, qh, qw, c)."""
    b, c, d, h, w = x.shape
    x = x.reshape(b, c, d // r, r, h // r, r, w // r, r)
    x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(b, r * r * r * c, d // r, h // r, w // r)


class S2DStemConv(nn.Module):
    """The k4-s2 SAME conv reparameterised as zero-pad(1, 1) ->
    space-to-depth(2) -> k2-s1 VALID conv: the same function class (a k4
    kernel w maps to w2[t, (q, c), o] = w[2t + q, c, o])."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = Conv3d(8 * in_channels, features, 2, padding="VALID")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = spatial.sharded()
        if mesh is None:
            if any(n % 2 for n in x.shape[2:]):
                raise ValueError("S2DStemConv requires even spatial dims")
            return self.conv(space_to_depth3d(F.pad(x, (1, 1) * 3), 2))
        if x.shape[4] % 2:
            # an odd slab: the parities of space-to-depth straddle slabs
            return spatial.gathered(self.forward, x)
        # the depth pad is the neighbours' rows (zeros at the ends)
        x = halo_exchange(F.pad(x, (0, 0) + (1, 1) * 2), 1, 1, 4, mesh)
        return self.conv(space_to_depth3d(x, 2))


def _save_convolutions(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """remat_policy "conv": keep convolution outputs, recompute the rest."""
    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _Recompute:
    """The recompute context of a checkpointed unit: its BatchNorms leave
    their running statistics alone (the forward pass updated them), and
    the unit runs under the spatial and tensor-parallel sharding of its
    forward pass (the backward pass may run on another thread, which does
    not see the forward's thread-local contexts)."""

    def __init__(self, unit: nn.Module, inner):
        self.norms = [m for m in unit.modules() if isinstance(m, _BatchNorm)]
        self.inner = inner
        self.saved = (spatial.state(), tp.state())
        self.sharding = None

    def __enter__(self):
        for m in self.norms:
            m.update_stats = False
        self.sharding = contextlib.ExitStack()
        self.sharding.enter_context(spatial.restoring(self.saved[0]))
        self.sharding.enter_context(tp.restoring(self.saved[1]))
        return self.inner.__enter__()

    def __exit__(self, *exc):
        try:
            return self.inner.__exit__(*exc)
        finally:
            self.sharding.close()
            for m in self.norms:
                m.update_stats = True


def _remat_contexts(unit: nn.Module, policy: str):
    if policy == "conv":
        fwd, rec = create_selective_checkpoint_contexts(_save_convolutions)
    elif policy == "full":
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    else:
        raise ValueError(f"unknown remat_policy {policy!r}")
    return fwd, _Recompute(unit, rec)


def _run_unit(cfg: VQVAEConfig, unit: nn.Module, x: torch.Tensor
              ) -> torch.Tensor:
    """A residual unit, checkpointed when cfg.remat and gradients are on."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return unit(x)
    return checkpoint(unit, x, use_reentrant=False,
                      context_fn=partial(_remat_contexts, unit,
                                         cfg.remat_policy))


def _dropout(x: torch.Tensor, rate: float, training: bool,
             draws: Optional[Draws]) -> torch.Tensor:
    """flax Dropout of an NCDHW volume: keep with probability 1 - rate and
    scale by 1 / (1 - rate). The keep mask is drawn in the JAX layout
    (NDHWC), so that JAX's masks can be injected as they are; over depth
    slabs it is the global mask's slab."""
    if not rate or not training:
        return x
    if draws is None:
        raise ValueError("dropout in training mode needs its draws (a "
                         "Draws with a generator)")
    keep = 1.0 - rate
    b, c, d, h, w = x.shape
    mask = draws.bernoulli(keep, (b, d, h, w, c), x.device, rows=True,
                           depth=spatial.SPATIAL_AXIS)
    return torch.where(mask.permute(0, 4, 1, 2, 3), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Encoder(nn.Module):
    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        ch_in = cfg.in_channels
        for i, ch in enumerate(cfg.num_channels):
            if (i == 0 and cfg.stem_s2d and cfg.downsample_kernel[0] == 4
                    and cfg.downsample_stride[0] == 2):
                self.add_module("down_0", S2DStemConv(ch_in, ch))
            else:
                self.add_module(f"down_{i}", Conv3d(
                    ch_in, ch, cfg.downsample_kernel[i],
                    stride=cfg.downsample_stride[i]))
            for j in range(cfg.num_res_layers):
                self.add_module(f"res_{i}_{j}", VQVAEResidualUnit(
                    ch, cfg.num_res_channels[i], act=cfg.act, norm=cfg.norm))
            ch_in = ch
        self.to_latent = Conv3d(ch_in, cfg.quantizer.embedding_dim, 3)
        self.latent_prelu = PReLU(cfg.quantizer.embedding_dim)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
        """x [B, in, H, W, D] -> [B, emb, h, w, d] (NCDHW). `draws` gives
        the dropout masks in training mode."""
        cfg = self.cfg
        for i in range(cfg.num_levels):
            x = getattr(self, f"down_{i}")(x)
            if i > 0:
                x = _dropout(x, cfg.dropout, self.training, draws)
            x = F.relu(x)
            for j in range(cfg.num_res_layers):
                x = _run_unit(cfg, getattr(self, f"res_{i}_{j}"), x)
        x = _dropout(self.to_latent(x), cfg.dropout, self.training, draws)
        return self.latent_prelu(x)


class Decoder(nn.Module):
    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        rev = list(reversed(cfg.num_channels))
        rev_res = list(reversed(cfg.num_res_channels))
        n = len(rev)
        self.stem = Conv3d(cfg.quantizer.embedding_dim, rev[0], 3)
        self.stem_prelu = PReLU(rev[0])
        for i in range(n):
            for j in range(cfg.num_res_layers):
                self.add_module(f"res_{i}_{j}", VQVAEResidualUnit(
                    rev[i], rev_res[i], act=cfg.act, norm=cfg.norm))
            out_ch = cfg.out_channels if i == n - 1 else rev[i + 1]
            self.add_module(f"up_{i}", ConvTranspose3d(
                rev[i], out_ch, cfg.upsample_kernel[n - 1 - i],
                stride=cfg.upsample_stride[n - 1 - i],
                kernel_resize=cfg.kernel_resize))
        if cfg.output_act:
            self.output_act = act_layer(cfg.output_act, cfg.out_channels)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
        """x [B, C, h, w, d] -> [B, out, H, W, D] (NCDHW). `draws` gives
        the dropout masks in training mode."""
        cfg = self.cfg
        n = cfg.num_levels
        x = _dropout(self.stem(x), cfg.dropout, self.training, draws)
        x = self.stem_prelu(x)
        for i in range(n):
            for j in range(cfg.num_res_layers):
                x = _run_unit(cfg, getattr(self, f"res_{i}_{j}"), x)
            x = getattr(self, f"up_{i}")(x)
            if i != n - 1:
                x = F.relu(_dropout(x, cfg.dropout, self.training, draws))
        if cfg.output_act:
            x = self.output_act(x)
        return x


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


class VQVAE(nn.Module):
    """Encoder -> quantizer -> decoder: stage-1, trained by `VQTrainer`,
    frozen under latent diffusion. Training mode is where dropout, the
    quantizer's noise and its state updates (usage, EMA) happen; their
    randomness comes from `draws`."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantizer = make_quantizer(cfg.quantizer)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> tuple[torch.Tensor, QuantAux]:
        """Volumes [B, H, W, D, in] (NDHWC) -> (reconstruction [B, H, W, D,
        out], QuantAux)."""
        z = _ndhwc(self.encoder(_ncdhw(x), draws))
        quantized, aux = self.quantizer(z, draws)
        return _ndhwc(self.decoder(_ncdhw(quantized), draws)), aux

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Volumes [B, H, W, D, in] (NDHWC) -> latents [B, h, w, d, emb]."""
        return _ndhwc(self.encoder(_ncdhw(x)))

    def encode_quantize(self, x: torch.Tensor
                        ) -> tuple[torch.Tensor, QuantAux]:
        """Volumes (NDHWC) -> (quantized latents (NDHWC), QuantAux)."""
        return self.quantizer(self.encode(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, h, w, d, C] (NDHWC) -> volumes [B, H, W, D, out]."""
        return _ndhwc(self.decoder(_ncdhw(z)))

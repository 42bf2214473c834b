"""MONAI-style 3D VQ-VAE: the port of `ldm3d.models.vqvae` (encoder, STE
quantizer and decoder).

Encoder: per level a k4 stride-2 conv (or the space-to-depth stem at level
0), ReLU and N residual units, then a conv3 to the latent width + PReLU.
Decoder: stem conv3 + PReLU, then per level N residual units and a
TF-exact stride-2 transposed conv, ReLU between levels. NCDHW inside;
`VQVAE.encode`, `encode_quantize` and `decode` take and return NDHWC like
the JAX module. Dropout is not ported: a config with dropout > 0 raises.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ldm3d_torch.core.config import VQVAEConfig
from ldm3d_torch.models.layers import (Conv3d, ConvTranspose3d, Norm, PReLU,
                                       act_layer)
from ldm3d_torch.models.quantizers import QuantAux, make_quantizer


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
        if any(n % 2 for n in x.shape[2:]):
            raise ValueError("S2DStemConv requires even spatial dims")
        return self.conv(space_to_depth3d(F.pad(x, (1, 1) * 3), 2))


def _no_dropout(cfg: VQVAEConfig) -> None:
    if cfg.dropout:
        raise ValueError(f"VQVAEConfig.dropout={cfg.dropout}: dropout is "
                         "not ported yet")


class Encoder(nn.Module):
    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        _no_dropout(cfg)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, in, H, W, D] -> [B, emb, h, w, d] (NCDHW)."""
        cfg = self.cfg
        for i in range(cfg.num_levels):
            x = F.relu(getattr(self, f"down_{i}")(x))
            for j in range(cfg.num_res_layers):
                x = getattr(self, f"res_{i}_{j}")(x)
        return self.latent_prelu(self.to_latent(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        _no_dropout(cfg)
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
                stride=cfg.upsample_stride[n - 1 - i]))
        if cfg.output_act:
            self.output_act = act_layer(cfg.output_act, cfg.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, h, w, d] -> [B, out, H, W, D] (NCDHW)."""
        cfg = self.cfg
        n = cfg.num_levels
        x = self.stem_prelu(self.stem(x))
        for i in range(n):
            for j in range(cfg.num_res_layers):
                x = getattr(self, f"res_{i}_{j}")(x)
            x = getattr(self, f"up_{i}")(x)
            if i != n - 1:
                x = F.relu(x)
        if cfg.output_act:
            x = self.output_act(x)
        return x


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


class VQVAE(nn.Module):
    """Encoder -> quantizer -> decoder (the frozen stage-1 of latent
    diffusion). The quantizer's train/eval mode decides whether its usage
    counter is updated."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantizer = make_quantizer(cfg.quantizer)

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

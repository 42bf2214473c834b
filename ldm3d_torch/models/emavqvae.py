"""The skip-connection EMA VQ-VAE and the generic 3D U-Net: the port of
`ldm3d.models.emavqvae`.

  - SkipVQEncoder: four k4-s2 convs (f, 2f, 4f, then the embedding width),
    BatchNorm + ReLU after the first three, whose outputs are returned
    for the decoder's skips.
  - SkipVQDecoder: the mirror ladder of k4-s2 transposed convs (TF SAME),
    each of the first three concatenated with the encoder's skip.
  - EMAVQVAE3D: encoder -> Sonnet EMA quantizer (K, D; commitment 6,
    decay 0.99, its defaults) -> skip decoder, returning the reference's
    dict {"x_out", "vq_loss", "perplexity"}; `EMASkipTrainable` returns
    (reconstruction, QuantAux) for `VQTrainer`. The skips go around the
    quantizer, so the decoder is not a function of the codes alone.
  - UNet3DSegment: DoubleConv (two conv3 + BatchNorm + ReLU) blocks, four
    2x max-pool downs, nearest (or k2-s2 transposed) ups with concat
    skips, a 1x1 head.

Unnamed flax submodules keep their automatic names (`Conv_0`, `Norm_0`,
`ConvTranspose_0`), so `ldm3d_torch.convert` maps the trees. Volumes are
NDHWC at the public functions, NCDHW inside.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ldm3d_torch.models.layers import Conv3d, ConvTranspose3d, Norm, upsample3d
from ldm3d_torch.models.quantizers import (Draws, QuantAux,
                                           VectorQuantizerEMASonnet)
from ldm3d_torch.models.vqvae import _ncdhw, _ndhwc


class _ConvBNRelu(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 transpose: bool = False, batchnorm: bool = True):
        super().__init__()
        self.conv_name = "ConvTranspose_0" if transpose else "Conv_0"
        layer = ConvTranspose3d if transpose else Conv3d
        self.add_module(self.conv_name, layer(in_channels, features, 4,
                                              stride=2))
        self.batchnorm = batchnorm
        if batchnorm:
            self.Norm_0 = Norm("batch", features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, self.conv_name)(x)
        if self.batchnorm:
            x = self.Norm_0(x)
        return F.relu(x)


class SkipVQEncoder(nn.Module):
    def __init__(self, in_channels: int, num_filters: int = 8,
                 embedding_dim: int = 128, batchnorm: bool = True):
        super().__init__()
        f = num_filters
        self.conv1 = _ConvBNRelu(in_channels, f, batchnorm=batchnorm)
        self.conv2 = _ConvBNRelu(f, 2 * f, batchnorm=batchnorm)
        self.conv3 = _ConvBNRelu(2 * f, 4 * f, batchnorm=batchnorm)
        self.conv4 = Conv3d(4 * f, embedding_dim, 4, stride=2)

    def forward(self, x: torch.Tensor):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x2)
        return x1, x2, x3, self.conv4(x3)


class SkipVQDecoder(nn.Module):
    def __init__(self, embedding_dim: int, out_channels: int = 1,
                 num_filters: int = 8, batchnorm: bool = False):
        super().__init__()
        f = num_filters
        self.conv1 = _ConvBNRelu(embedding_dim, 4 * f, True, batchnorm)
        self.conv2 = _ConvBNRelu(8 * f, 2 * f, True, batchnorm)
        self.conv3 = _ConvBNRelu(4 * f, f, True, batchnorm)
        self.conv4 = ConvTranspose3d(2 * f, out_channels, 4, stride=2)

    def forward(self, zq, x1, x2, x3) -> torch.Tensor:
        h = self.conv1(zq)
        h = self.conv2(torch.cat([x3, h], dim=1))
        h = self.conv3(torch.cat([x2, h], dim=1))
        return self.conv4(torch.cat([x1, h], dim=1))


class EMAVQVAE3D(nn.Module):
    """Encoder (BatchNorm) -> Sonnet EMA quantizer -> skip decoder."""

    def __init__(self, num_channels: int = 1, num_filters: int = 8,
                 embedding_dim: int = 32, num_embeddings: int = 512,
                 batchnorm: bool = False, in_channels: Optional[int] = None):
        super().__init__()
        self.encoder = SkipVQEncoder(in_channels or num_channels,
                                     num_filters, embedding_dim,
                                     batchnorm=True)
        self.quantization = VectorQuantizerEMASonnet(num_embeddings,
                                                     embedding_dim)
        self.decoder = SkipVQDecoder(embedding_dim, num_channels, num_filters,
                                     batchnorm=batchnorm)

    @property
    def quantizer(self) -> VectorQuantizerEMASonnet:
        """The quantizer under the name the trainers read."""
        return self.quantization

    def _run(self, x: torch.Tensor) -> Tuple[torch.Tensor, QuantAux]:
        x1, x2, x3, ze = self.encoder(_ncdhw(x))
        zq, aux = self.quantization(_ndhwc(ze))
        return _ndhwc(self.decoder(_ncdhw(zq), x1, x2, x3)), aux

    def forward(self, x: torch.Tensor,
                draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        recon, aux = self._run(x)
        return {"x_out": recon, "vq_loss": aux.loss,
                "perplexity": aux.perplexity}


class EMASkipTrainable(EMAVQVAE3D):
    """(reconstruction, QuantAux), the interface `VQTrainer` trains."""

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> Tuple[torch.Tensor, QuantAux]:
        return self._run(x)


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.Conv_0 = Conv3d(in_channels, features, 3)
        self.Norm_0 = Norm("batch", features)
        self.Conv_1 = Conv3d(features, features, 3)
        self.Norm_1 = Norm("batch", features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        return F.relu(self.Norm_1(self.Conv_1(x)))


class UNet3DSegment(nn.Module):
    """Generic 3D U-Net: {"x_out": [B, H, W, D, num_channels]} of NDHWC
    volumes with `in_channels` channels."""

    def __init__(self, num_channels: int = 1, num_filters: int = 4,
                 bilinear: bool = True, in_channels: int = 1):
        super().__init__()
        f = num_filters
        factor = 2 if bilinear else 1
        self.bilinear = bilinear
        self.inconv = DoubleConv(in_channels, f)
        widths = [f, 2 * f, 4 * f, 8 * f, 16 * f // factor]
        for i in range(4):
            self.add_module(f"down{i + 1}", DoubleConv(widths[i],
                                                       widths[i + 1]))
        outs = [8 * f // factor, 4 * f // factor, 2 * f // factor, f]
        below = widths[4]
        for i in range(4):
            skip = widths[3 - i]
            if not bilinear:
                self.add_module(f"ConvTranspose_{i}", ConvTranspose3d(
                    below, below, 2, stride=2))
            self.add_module(f"up{i + 1}", DoubleConv(skip + below, outs[i]))
            below = outs[i]
        self.outconv = Conv3d(f, num_channels, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.inconv(_ncdhw(x))
        skips = [h]
        for i in range(4):
            h = getattr(self, f"down{i + 1}")(F.max_pool3d(h, 2, 2))
            skips.append(h)
        for i in range(4):
            if self.bilinear:
                h = upsample3d(h, 2)
            else:
                h = getattr(self, f"ConvTranspose_{i}")(h)
            h = getattr(self, f"up{i + 1}")(torch.cat([skips[3 - i], h],
                                                      dim=1))
        return {"x_out": _ndhwc(self.outconv(h))}

"""The legacy functional VQ-VAE (`--vqvae_mode`): the port of
`ldm3d.models.vqvae_legacy`.

  - mode 1: `LegacyEncoder` / `LegacyDecoder`, 2 or 3 stride-2 k3 convs
    (32, 64[, 128]) + ReLU and a 1x1 conv to the latent width; the
    decoder mirrors them with k3 stride-2 transposed convs (TF SAME) and
    a stride-1 k3 transposed conv to the output.
  - mode 2: `LegacyEncoder2` / `LegacyDecoder2`, two k4 stride-2 convs,
    then residual adds of 1x1-projected branches at width 128.
`LegacyVQVAE` puts a straight-through quantizer (K, D, beta 0.25)
between them. `test_loss` is the test-time MSE over the training
variance. Unnamed flax layers keep their automatic names (`Conv_{i}`,
`ConvTranspose_{i}`, in creation order). NDHWC at `LegacyVQVAE`, NCDHW
inside.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ldm3d_torch.models.layers import Conv3d, ConvTranspose3d
from ldm3d_torch.models.quantizers import Draws, QuantAux, VectorQuantizerSTE
from ldm3d_torch.models.vqvae import _ncdhw, _ndhwc
from ldm3d_torch.parallel import spatial


def _layers(module: nn.Module, name: str, layer, specs) -> None:
    """Register `layer(in, out, kernel, stride)` as `{name}_{i}` per spec."""
    for i, spec in enumerate(specs):
        module.add_module(f"{name}_{i}", layer(*spec[:3], stride=spec[3]))


class LegacyEncoder(nn.Module):
    def __init__(self, in_channels: int = 1, latent_dim: int = 16,
                 down: int = 3):
        super().__init__()
        widths = [32, 64, 128][:down]
        specs = [(a, b, 3, 2) for a, b in zip([in_channels] + widths, widths)]
        specs.append((widths[-1], latent_dim, 1, 1))
        _layers(self, "Conv", Conv3d, specs)
        self.n = len(specs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n - 1):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return getattr(self, f"Conv_{self.n - 1}")(x)


class LegacyDecoder(nn.Module):
    def __init__(self, latent_dim: int = 16, out_channels: int = 1,
                 down: int = 3):
        super().__init__()
        widths = [128, 64, 32][3 - down:]
        specs = [(a, b, 3, 2) for a, b in zip([latent_dim] + widths, widths)]
        specs.append((32, out_channels, 3, 1))
        _layers(self, "ConvTranspose", ConvTranspose3d, specs)
        self.n = len(specs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n - 1):
            x = F.relu(getattr(self, f"ConvTranspose_{i}")(x))
        return getattr(self, f"ConvTranspose_{self.n - 1}")(x)


class LegacyEncoder2(nn.Module):
    def __init__(self, in_channels: int = 1, latent_dim: int = 16):
        super().__init__()
        _layers(self, "Conv", Conv3d, [
            (in_channels, 32, 4, 2), (32, 64, 4, 2), (64, 128, 3, 1),
            (64, 128, 1, 1), (128, 128, 3, 1), (128, 128, 1, 1),
            (128, latent_dim, 1, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        y = F.relu(self.Conv_2(x))
        x = self.Conv_3(x) + y
        y = F.relu(self.Conv_4(x))
        x = self.Conv_5(x) + y
        return self.Conv_6(x)


class LegacyDecoder2(nn.Module):
    def __init__(self, latent_dim: int = 16, out_channels: int = 1):
        super().__init__()
        _layers(self, "ConvTranspose", ConvTranspose3d, [
            (latent_dim, 128, 1, 1), (128, 128, 3, 1), (128, 128, 1, 1),
            (128, 128, 3, 1), (128, 128, 1, 1), (128, 64, 4, 2),
            (64, 32, 4, 2), (32, out_channels, 3, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.ConvTranspose_0(x))
        y = F.relu(self.ConvTranspose_1(x))
        x = self.ConvTranspose_2(y) + x
        y = F.relu(self.ConvTranspose_3(x))
        x = self.ConvTranspose_4(y) + x
        x = F.relu(self.ConvTranspose_5(x))
        x = F.relu(self.ConvTranspose_6(x))
        return self.ConvTranspose_7(x)


class LegacyVQVAE(nn.Module):
    """Encoder -> straight-through quantizer -> decoder; mode 1 plain
    (`down` 2 or 3), mode 2 residual."""

    def __init__(self, latent_dim: int = 16, num_embeddings: int = 64,
                 mode: int = 1, down: int = 3, out_channels: int = 1,
                 in_channels: int = 1):
        super().__init__()
        if mode == 1:
            self.encoder = LegacyEncoder(in_channels, latent_dim, down)
            self.decoder = LegacyDecoder(latent_dim, out_channels, down)
        elif mode == 2:
            self.encoder = LegacyEncoder2(in_channels, latent_dim)
            self.decoder = LegacyDecoder2(latent_dim, out_channels)
        else:
            raise ValueError(f"legacy mode {mode}: 1 or 2")
        self.quantizer = VectorQuantizerSTE(num_embeddings, latent_dim)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> Tuple[torch.Tensor, QuantAux]:
        """Under spatial sharding the model runs on the gathered volume
        (JAX has no `shard_spatial` in it) and returns this process's
        slab of the reconstruction."""
        axis = spatial.SPATIAL_AXIS
        x = spatial.gather(x, axis)
        with spatial.whole():
            q, aux = self.quantizer(_ndhwc(self.encoder(_ncdhw(x))))
            out = _ndhwc(self.decoder(_ncdhw(q)))
        return spatial.scatter(out, axis), aux


def test_loss(x: torch.Tensor, recon: torch.Tensor,
              train_variance: float = 0.0949) -> torch.Tensor:
    """The test-time MSE over the training variance."""
    return torch.mean(torch.square(x - recon)) / train_variance

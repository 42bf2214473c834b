"""LPIPS, the perceptual distance of the VQ-GAN's loss: the port of
`ldm3d.models.lpips`.

A VGG16 trunk (3x3 SAME convs + ReLU, 2x2 VALID max pools) taps the last
conv of each of its five blocks; each tap is shifted and scaled, unit-
normalised over channels (x * rsqrt(sum x^2 + 1e-10)), squared-differenced
between the two images, weighted by a 1x1 linear head without bias and
averaged over space; the five are summed. It runs in its input's type
(float32 in the port) and is frozen (no parameter takes a gradient).

Pretrained weights come from a flat `.npz` of '/'-joined flax paths
(`vgg/block1_conv1/kernel`, `lin0/kernel`, ...), named by the environment
variable `LDM3D_LPIPS_WEIGHTS`, the JAX package's format and variable.
Without them the trunk keeps its seeded random init and each head is
rescaled so that every tap contributes equally over MRI-like distorted
frame pairs (`calibration_frames`, then `calibrate_lpips_`): a
random-feature surrogate, not comparable to trained LPIPS.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ldm3d_torch.models.layers import Conv2d

# VGG16 conv plan: (channels, convs per block)
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16Features(nn.Module):
    """VGG16 trunk over NCHW images, returning the five LPIPS taps."""

    def __init__(self):
        super().__init__()
        ch_in = 3
        for bi, (ch, n_convs) in enumerate(_VGG_BLOCKS):
            for ci in range(n_convs):
                self.add_module(f"block{bi + 1}_conv{ci + 1}",
                                Conv2d(ch_in, ch, 3))
                ch_in = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for bi, (_, n_convs) in enumerate(_VGG_BLOCKS):
            for ci in range(n_convs):
                x = F.relu(getattr(self, f"block{bi + 1}_conv{ci + 1}")(x))
            feats.append(x)
            if bi < len(_VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


def _unit(a: torch.Tensor) -> torch.Tensor:
    """Unit-normalise over the channels (dim 1)."""
    return a * torch.rsqrt(torch.sum(torch.square(a), dim=1, keepdim=True)
                           + 1e-10)


class LPIPS(nn.Module):
    """d(img1, img2) -> [N] over NCHW RGB images in [0, 1]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_VGG_BLOCKS):
            self.add_module(f"lin{i}", Conv2d(ch, 1, 1, use_bias=False,
                                              kernel_init="constant:0.1"))
        self.requires_grad_(False)

    def taps(self, img: torch.Tensor) -> List[torch.Tensor]:
        shift, scale = (torch.from_numpy(a).to(img.device, img.dtype)
                        .view(1, 3, 1, 1) for a in (_SHIFT, _SCALE))
        return self.vgg((img - shift) / scale)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor
                ) -> torch.Tensor:
        total = 0.0
        for i, (a, b) in enumerate(zip(self.taps(img1), self.taps(img2))):
            diff = torch.square(_unit(a) - _unit(b))
            lin = getattr(self, f"lin{i}")(diff)
            total = total + torch.mean(lin, dim=(1, 2, 3))
        return total


def calibration_frames(frame_hw: Tuple[int, int], generator: torch.Generator,
                       num_samples: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MRI-like frame pairs for `calibrate_lpips_`, NCHW RGB on the
    generator's device: smooth base frames (uniform noise at a quarter of
    the size, bilinearly upsampled with half-pixel centres) and distorted
    partners (a brightness gain 1 + 0.2 N(0, 1) per frame, 0.05 N(0, 1)
    noise, clipped to [0, 1]). The JAX version draws the same
    distributions with `jax.random`."""
    h, w = frame_hw
    dev = generator.device
    base = torch.rand(num_samples, 1, h // 4, w // 4, generator=generator,
                      device=dev)
    base = F.interpolate(base, size=(h, w), mode="bilinear",
                         align_corners=False)
    gain = 1.0 + 0.2 * torch.randn(num_samples, 1, 1, 1,
                                   generator=generator, device=dev)
    noise = 0.05 * torch.randn(base.shape, generator=generator, device=dev)
    dist = torch.clamp(base * gain + noise, 0.0, 1.0)
    return base.expand(-1, 3, -1, -1), dist.expand(-1, 3, -1, -1)


@torch.no_grad()
def calibrate_lpips_(lpips: LPIPS, img1: torch.Tensor,
                     img2: torch.Tensor) -> LPIPS:
    """Rescale each linear head, in place, so that every tap contributes
    1/5 of a unit total in expectation over the pairs (img1, img2): the
    head becomes all-ones times 1/5 over the tap's mean channel-summed
    squared difference of unit-normalised features."""
    f1, f2 = lpips.taps(img1), lpips.taps(img2)
    for i, (a, b) in enumerate(zip(f1, f2)):
        layer_mean = float(torch.mean(torch.sum(
            torch.square(_unit(a) - _unit(b)), dim=1)))
        gain = (1.0 / len(f1)) / max(layer_mean, 1e-12)
        getattr(lpips, f"lin{i}").weight.fill_(gain)
    return lpips


def load_lpips_params(path: Optional[str] = None
                      ) -> Optional[Dict[str, np.ndarray]]:
    """The flat {flax path: array} of a converted VGG16 + heads `.npz`
    (`path`, else $LDM3D_LPIPS_WEIGHTS); None when there is none."""
    path = path or os.environ.get("LDM3D_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as flat:
        return {k: flat[k] for k in flat.files}

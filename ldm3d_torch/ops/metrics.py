"""Image-quality metrics of stage-1 evaluation: the port of
`ldm3d.ops.metrics` (per-slice 2D SSIM and PSNR of volumes).

The 11 x 11 Gaussian window (sigma 1.5) is applied as two 1D passes of
float32 multiply-adds over shifted views, never as a convolution: on the
card cuDNN would run a float32 convolution on TF32, and the windowed
E[x^2] - mu^2 then loses the precision that keeps SSIM at or below 1 (the
reason the JAX package runs its filter at `Precision.HIGHEST`).
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalised 1D window; the JAX package's 2D window is its outer
    product."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _filter2d(img: torch.Tensor, g: np.ndarray) -> torch.Tensor:
    """[N, H, W] -> valid-padded separable blur [N, H - k + 1, W - k + 1]."""
    k = len(g)
    w = [float(np.float32(v)) for v in g]
    h_out, w_out = img.shape[-2] - k + 1, img.shape[-1] - k + 1
    rows = sum(w[t] * img[..., t:t + w_out] for t in range(k))
    return sum(w[t] * rows[..., t:t + h_out, :] for t in range(k))


def ssim2d(a: torch.Tensor, b: torch.Tensor, max_val,
           size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean 2D SSIM of each of a batch of [N, H, W] image pairs
    (tf.image.ssim's math), [N]."""
    a, b = a.float(), b.float()
    g = _gaussian_1d(size, sigma)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a, mu_b = _filter2d(a, g), _filter2d(b, g)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    # variances are >= 0 analytically; clamp away float error so that the
    # cs term stays at or below 1
    sigma_aa = torch.clamp(_filter2d(a * a, g) - mu_aa, min=0.0)
    sigma_bb = torch.clamp(_filter2d(b * b, g) - mu_bb, min=0.0)
    sigma_ab = _filter2d(a * b, g) - mu_ab
    lum = (2.0 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    cs = (2.0 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    return torch.mean(lum * cs, dim=(-2, -1))


def volume_ssim(vol_a: torch.Tensor, vol_b: torch.Tensor) -> torch.Tensor:
    """Mean per-slice SSIM of [B, H, W, D, 1] volumes, slices along H;
    max_val is the dynamic range of the second argument, per volume."""
    out = []
    for va, vb in zip(vol_a[..., 0].float(), vol_b[..., 0].float()):
        out.append(torch.mean(ssim2d(va, vb, vb.max() - vb.min())))
    return torch.stack(out).mean()


def volume_psnr(vol_a: torch.Tensor, vol_b: torch.Tensor) -> torch.Tensor:
    """Mean per-slice PSNR of [B, H, W, D, 1] volumes, slices along H;
    max_val as in `volume_ssim`."""
    out = []
    for va, vb in zip(vol_a.float(), vol_b.float()):
        max_val = vb.max() - vb.min()
        mse = torch.mean(torch.square(va - vb), dim=(1, 2, 3))
        out.append(torch.mean(
            20.0 * torch.log10(torch.clamp(max_val, min=1e-12))
            - 10.0 * torch.log10(torch.clamp(mse, min=1e-12))))
    return torch.stack(out).mean()

"""SSIM and PSNR of the port (`ldm3d_torch.ops.metrics`) against the JAX
package's `ldm3d.ops.metrics`, on the CPU, on seeded numpy volumes.

The port's Gaussian window is two 1D float32 passes where JAX runs one 2D
convolution at HIGHEST precision: the windowed means differ by float32
rounding (a few 1e-8 at values of O(1)), which SSIM's stabilising
constants keep from growing. SSIM is compared to 1e-6 absolute, PSNR (in
dB, from the same per-slice MSE) to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.ops.metrics import (ssim2d as j_ssim2d,
                               volume_psnr as j_volume_psnr,
                               volume_ssim as j_volume_ssim)
from ldm3d_torch.ops.metrics import ssim2d, volume_psnr, volume_ssim
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

SSIM_ATOL = 1e-6
PSNR_RTOL = 1e-5


def _pair(shape, seed, noise=0.1, scale=1.0):
    rng = np.random.default_rng(seed)
    b = (scale * rng.random(shape)).astype(np.float32)
    a = (b + noise * rng.standard_normal(shape)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("max_val", [1.0, 0.37])
def test_ssim2d_matches(max_val):
    a, b = _pair((5, 24, 19), seed=1)
    out = ssim2d(torch.from_numpy(a), torch.from_numpy(b), max_val)
    ref = j_ssim2d(jnp.asarray(a), jnp.asarray(b), max_val)
    assert out.shape == (5,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=SSIM_ATOL)


@pytest.mark.parametrize("noise", [0.0, 0.05, 0.5])
def test_volume_ssim_and_psnr_match(noise):
    # another dynamic range per volume
    a, b = _pair((2, 16, 16, 16, 1), seed=2, noise=noise,
                 scale=np.array([1.0, 0.5]).reshape(2, 1, 1, 1, 1))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ssim, psnr = volume_ssim(ta, tb), volume_psnr(ta, tb)
    ref_ssim = float(j_volume_ssim(jnp.asarray(a), jnp.asarray(b)))
    ref_psnr = float(j_volume_psnr(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(float(ssim), ref_ssim, atol=SSIM_ATOL)
    np.testing.assert_allclose(float(psnr), ref_psnr, rtol=PSNR_RTOL)
    assert float(ssim) <= 1.0
    if noise == 0.0:
        # identical volumes: SSIM 1, and PSNR at the 1e-12 MSE floor
        np.testing.assert_allclose(float(ssim), 1.0, atol=1e-6)
        assert float(psnr) > 100.0


def test_ssim_with_flat_background_stays_at_or_below_one():
    # Volumes as the corpus has them: a textured ball on a zero background.
    # In the flat regions every windowed variance is float noise around 0,
    # which the clamp keeps from pushing SSIM above 1.
    rng = np.random.default_rng(3)
    g = np.indices((16, 16, 16)) - 7.5
    ball = (np.sqrt((g ** 2).sum(0)) < 6)[None, ..., None]
    b = np.where(ball, rng.random((2, 16, 16, 16, 1)), 0.0).astype(np.float32)
    a = np.where(ball, b + 0.02 * rng.standard_normal(b.shape),
                 0.0).astype(np.float32)
    ssim = float(volume_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert 0.5 < ssim <= 1.0
    np.testing.assert_allclose(
        ssim, float(j_volume_ssim(jnp.asarray(a), jnp.asarray(b))),
        atol=SSIM_ATOL)

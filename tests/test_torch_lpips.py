"""The port's LPIPS against the JAX package's, on the CPU.

- The distance of two image batches (with frame sizes the pools floor)
  from JAX-initialised, converted VGG16 + head weights; 0 for identical
  images.
- `load_lpips_params`: the JAX package's flat `.npz` (the layout of
  tools/export_lpips_weights.py) under `LDM3D_LPIPS_WEIGHTS` loads into the
  port's LPIPS and into `GANTrainer.init_random`, which then reports
  pretrained weights and does not warn.
- The calibration of the random-feature surrogate: JAX's own frames (its
  `jax.random` draws, re-made here) fed to `calibrate_lpips_` give JAX's
  heads; `calibration_frames` upsamples as `jax.image.resize(...,
  "bilinear")` does, and without weights `GANTrainer` warns and
  calibrates.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.models import lpips as jlpips
from ldm3d_torch.convert import flatten, module_state
from ldm3d_torch.core.config import (DiscriminatorConfig, QuantizerConfig,
                                     VQGANConfig, VQVAEConfig)
from ldm3d_torch.models import lpips
from ldm3d_torch.train.gan_trainer import GANTrainer
from test_torch_samplers import FAST
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# float32 VGG16 features summed in other orders than XLA: the distance to
# 1e-5 of its value, the calibrated head gains (1 / the same means) too.
REL_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _jax_lpips(h, w, seed=0):
    """The JAX LPIPS and its init, compiled once (LLVM optimisation
    off)."""
    m = jlpips.LPIPS(dtype=jnp.float32)
    x = jnp.zeros((1, h, w, 3))
    key = jax.random.PRNGKey(seed)
    init = jax.jit(lambda k, v: m.init({"params": k}, v, v))
    return m, _np(init.lower(key, x).compile(compiler_options=FAST)(key, x))


def _port(params):
    t = lpips.LPIPS()
    t.load_state_dict(module_state(params), strict=True)
    return t


def _nchw(a):
    a = np.moveaxis(np.array(a, np.float32), -1, 1)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hw", [(32, 32), (20, 28)])
def test_distance_matches_jax(hw):
    m, var = _jax_lpips(*hw)
    rng = np.random.default_rng(1)
    a = rng.random((3,) + hw + (3,)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    ref = np.asarray(jax.jit(m.apply).lower(
        var, jnp.asarray(a), jnp.asarray(b)).compile(compiler_options=FAST)(
        var, jnp.asarray(a), jnp.asarray(b)))
    t = _port(var["params"])
    got = t(_nchw(a), _nchw(b)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, ref, rtol=REL_TOL)
    np.testing.assert_allclose(t(_nchw(a), _nchw(a)).numpy(), 0.0,
                               atol=1e-6)
    assert not any(p.requires_grad for p in t.parameters())


def _tiny_gan():
    ae = VQVAEConfig(in_channels=2, out_channels=2, num_channels=(4, 8),
                     num_res_channels=(4, 8), num_res_layers=1,
                     norm="group",
                     quantizer=QuantizerConfig(kind="ste",
                                               num_embeddings=16,
                                               embedding_dim=8))
    return VQGANConfig(ae=ae, disc=DiscriminatorConfig(num_channels=(4,)))


def test_weights_file_loads_as_in_jax(tmp_path, monkeypatch):
    _, var = _jax_lpips(16, 16, seed=3)
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **flatten(var["params"]))
    ref = jlpips.load_lpips_params(path)
    got = lpips.load_lpips_params(path)
    assert got.keys() == flatten(_np(ref)).keys()
    for k, a in flatten(_np(ref)).items():
        np.testing.assert_array_equal(got[k], a)
    monkeypatch.setenv("LDM3D_LPIPS_WEIGHTS", path)
    assert lpips.load_lpips_params().keys() == got.keys()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr = GANTrainer(_tiny_gan(), device="cpu",
                        volume_size=16).init_random(0)
    assert tr.lpips_pretrained
    want = _port(var["params"]).state_dict()
    for k, t in tr.lpips.state_dict().items():
        assert torch.equal(t, want[k]), k
    monkeypatch.setenv("LDM3D_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    assert lpips.load_lpips_params() is None


def _jax_frames(h, w, seed=0, num=8):
    """The frames `ldm3d.models.lpips.calibrate_lpips_params` draws."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    base = jax.random.uniform(k1, (num, h // 4, w // 4, 1))
    base = jax.image.resize(base, (num, h, w, 1), "bilinear")
    gain = 1.0 + 0.2 * jax.random.normal(k2, (num, 1, 1, 1))
    noise = 0.05 * jax.random.normal(k3, base.shape)
    dist = jnp.clip(base * gain + noise, 0.0, 1.0)
    return jnp.tile(base, (1, 1, 1, 3)), jnp.tile(dist, (1, 1, 1, 3))


@pytest.mark.parametrize("hw", [(32, 32), (16, 24)])
def test_calibration_from_jax_frames_matches_jax(hw):
    _, var = _jax_lpips(*hw, seed=4)
    ref = _np(jlpips.calibrate_lpips_params(var["params"], hw, seed=0))
    img1, img2 = _jax_frames(*hw)
    t = lpips.calibrate_lpips_(_port(var["params"]), _nchw(img1),
                               _nchw(img2))
    want = module_state(ref)
    for i in range(5):
        k = f"lin{i}.weight"
        np.testing.assert_allclose(t.state_dict()[k].numpy(),
                                   want[k].numpy(), rtol=REL_TOL)
    # the trunk is left as it was
    for k, v in t.state_dict().items():
        if not k.startswith("lin"):
            assert torch.equal(v, want[k]), k


def test_calibration_frames_upsample_as_jax():
    gen = torch.Generator().manual_seed(0)
    img1, img2 = lpips.calibration_frames((32, 24), gen, num_samples=4)
    assert img1.shape == img2.shape == (4, 3, 32, 24)
    assert 0.0 <= float(img1.min()) and float(img1.max()) <= 1.0
    assert 0.0 <= float(img2.min()) and float(img2.max()) <= 1.0
    assert torch.equal(img1[:, 0], img1[:, 2])
    # the same base through both resizes
    small = np.random.default_rng(2).random((4, 8, 6, 1)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(small), (4, 32, 24, 1),
                                      "bilinear"))
    got = torch.nn.functional.interpolate(
        _nchw(small), size=(32, 24), mode="bilinear", align_corners=False)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), ref,
                               atol=1e-6)
    again = lpips.calibration_frames((32, 24), torch.Generator()
                                     .manual_seed(0), num_samples=4)
    assert torch.equal(again[0], img1) and torch.equal(again[1], img2)


def test_trainer_without_weights_warns_and_calibrates(monkeypatch):
    monkeypatch.delenv("LDM3D_LPIPS_WEIGHTS", raising=False)
    with pytest.warns(UserWarning, match="LPIPS: no pretrained weights"):
        tr = GANTrainer(_tiny_gan(), device="cpu",
                        volume_size=16).init_random(0)
    assert not tr.lpips_pretrained
    img1, img2 = lpips.calibration_frames(
        (16, 16), torch.Generator().manual_seed(0))
    d = tr.lpips(img1, img2)
    # each tap 1/5 of a unit in expectation over the calibration pairs
    np.testing.assert_allclose(float(d.mean()), 1.0, rtol=1e-5)

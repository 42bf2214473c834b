"""The port's VQ decoder against the JAX package, on the CPU.

The TF-exact transposed conv is checked twice: against the precomputed TF
goldens of tests/test_tf_parity.py, through the converter's kernel mapping,
and inside the tiny decoder against flax `nn.ConvTranspose(transpose_kernel
=True)`. Weights are a JAX init perturbed with seeded numpy noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ldm3d.models.vqvae import Decoder as JDecoder
from ldm3d_torch.convert import module_state
from ldm3d_torch.core.config import VQVAEConfig, flagship_cfg
from ldm3d_torch.models.layers import ConvTranspose3d, Norm, PReLU
from ldm3d_torch.models.vqvae import Decoder
from test_tf_parity import (W_2_3_2, W_2_4_2, W_3_3_1, X_2_3_2, X_2_4_2,
                            X_3_3_1, Y_2_3_2, Y_2_4_2, Y_3_3_1)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# float32: each output sums at most a few hundred products per layer in a
# different order than XLA; 1e-5 relative to max |ref| is a few ulps.
REL_TOL = 1e-5


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("x,w,y,k,s", [
    (X_2_4_2, W_2_4_2, Y_2_4_2, 4, 2),   # the decoders' k4-s2 upsample
    (X_3_3_1, W_3_3_1, Y_3_3_1, 3, 1),
    (X_2_3_2, W_2_3_2, Y_2_3_2, 3, 2),   # odd k - s: asymmetric SAME window
])
def test_conv3d_transpose_tf_goldens(x, w, y, k, s):
    # The golden kernel in the flax layout (k, k, k, OUT, IN), converted
    # exactly as a checkpoint's would be.
    kern = np.asarray(w, np.float32)[..., None, None]
    layer = ConvTranspose3d(1, 1, k, stride=s, use_bias=False)
    layer.load_state_dict(module_state({"kernel": kern}))
    with torch.no_grad():
        out = layer(torch.tensor(x, dtype=torch.float32)[None, None])
    # the goldens are given to 6 decimals
    np.testing.assert_allclose(out[0, 0].double().numpy(), y, rtol=1e-5,
                               atol=1e-5)


def test_prelu_is_per_channel():
    p = PReLU(3)
    with torch.no_grad():
        p.alpha.copy_(torch.tensor([0.1, 0.2, 0.3]))
    x = -torch.ones(1, 3, 2, 2, 2)
    out = p(x)
    assert torch.equal(out[0, :, 0, 0, 0], torch.tensor([-0.1, -0.2, -0.3]))
    assert torch.equal(p(-x), -x)


def test_group_norm_groups_and_eps():
    n = Norm("group", 16)
    assert n.GroupNorm_0.groups == 16          # min(C, 32)
    assert Norm("group", 64).GroupNorm_0.groups == 32
    x = torch.randn(2, 16, 3, 3, 3, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.functional.group_norm(x, 16, eps=1e-6)
    assert torch.allclose(n(x), ref)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_tiny_decoder_matches(norm):
    jvq = dataclasses.replace(_flagship_cfg(tiny=True).vqvae, norm=norm)
    tvq = dataclasses.replace(flagship_cfg(tiny=True).vqvae, norm=norm)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 4, 4, 4, 8)).astype(np.float32)
    mod = JDecoder(jvq, dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(z), training=False)
    params = _perturb(v["params"], seed=4)
    variables = {"params": params}
    stats = None
    if norm == "batch":
        stats = jax.tree_util.tree_map(
            lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
            v["batch_stats"])
        variables["batch_stats"] = stats
    ref = mod.apply(variables, jnp.asarray(z), training=False)
    dec = Decoder(tvq).eval()
    dec.load_state_dict(module_state(params, stats))
    with torch.no_grad():
        out = dec(torch.from_numpy(z).permute(0, 4, 1, 2, 3))
    out = out.permute(0, 2, 3, 4, 1).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 16, 1)
    err = np.abs(out - np.asarray(ref)).max()
    assert err <= REL_TOL * np.abs(np.asarray(ref)).max()


def test_flagship_decoder_layout():
    # Construction only, on the meta device: four levels, 5 residual units
    # each, GroupNorm, 8^3 x 256 in, 128^3 x 1 out.
    cfg = flagship_cfg().vqvae
    assert isinstance(cfg, VQVAEConfig) and cfg.norm == "group"
    with torch.device("meta"):
        dec = Decoder(cfg)
        out = dec(torch.empty(1, 256, 8, 8, 8))
    assert out.shape == (1, 1, 128, 128, 128)
    assert hasattr(dec, "res_3_4") and not hasattr(dec, "res_3_5")
    assert dec.res_0_0.norm.GroupNorm_0.groups == 32

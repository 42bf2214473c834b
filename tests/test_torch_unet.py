"""The port's conditional U-Net against the JAX package, on the CPU.

Weights come from a JAX init, perturbed with seeded numpy noise so that the
JAX package's zero-initialised layers (the second conv of each residual
block, the head) carry signal, and are converted by `ldm3d_torch.convert`.
Inputs are seeded numpy arrays. The JAX side runs in float32 with the XLA
attention path, which is what `impl="auto"` picks at these shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ldm3d.models.layers import conv3d as jconv3d
from ldm3d.models.unet3d import (AttentionBlock as JAttentionBlock,
                                 CrossAttentionBlock as JCrossAttentionBlock,
                                 TimeEmbedding as JTimeEmbedding,
                                 UNet3D as JUNet3D)
from ldm3d_torch.convert import module_state
from ldm3d_torch.core.config import flagship_cfg
from ldm3d_torch.models.layers import Conv3d, same_pads
from ldm3d_torch.models.unet3d import (AttentionBlock, CrossAttentionBlock,
                                       TimeEmbedding, UNet3D)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# float32 on both sides; a block sums a few thousand products per output in
# different orders (XLA vs oneDNN/ATen), so agreement is to a few float32
# ulps of the output's scale: 1e-5 relative to max |ref|.
REL_TOL = 1e-5


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), tree)


def _stats(tree, seed):
    """BatchNorm statistics with a nontrivial mean and a positive var."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, tree)


def _assert_close(out, ref, tol=REL_TOL):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def test_same_padding_stride2_even_input_pads_after_only():
    assert same_pads(8, 3, 2) == (0, 1)
    assert same_pads(4, 3, 1) == (1, 1)
    assert same_pads(16, 4, 2) == (1, 1)
    assert same_pads(8, 1, 1) == (0, 0)


@pytest.mark.parametrize("k,s,n", [(3, 2, 8), (3, 1, 5), (4, 2, 6)])
def test_conv3d_same_matches_flax(k, s, n):
    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((2, n, n, n, 3)).astype(np.float32)
    mod = jconv3d(5, k, stride=s)
    params = _perturb(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                      seed=1)
    ref = mod.apply(params, jnp.asarray(x))
    conv = Conv3d(3, 5, k, stride=s)
    conv.load_state_dict(module_state(params["params"]))
    with torch.no_grad():
        out = conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert out.shape[2:] == ref.shape[1:4]
    _assert_close(out.permute(0, 2, 3, 4, 1).numpy(), ref)


def test_time_embedding_matches():
    t = np.array([0, 1, 17, 499], np.int32)
    ref = JTimeEmbedding(64)(jnp.asarray(t))
    out = TimeEmbedding(64)(torch.from_numpy(t))
    # sin/cos of float32 arguments up to 499: the argument itself carries
    # an ulp of 2^-15 ~ 3e-5, and the two libraries' sin differ by about
    # that much; 1e-4 absolute is a few ulps of the largest argument.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("heads", [1, 2])
def test_cross_attention_block_flagship_width(heads):
    # C=512 at a 4^3 grid (sequence 64): the flagship's attention shape.
    rng = np.random.default_rng(heads)
    x = rng.standard_normal((2, 4, 4, 4, 512)).astype(np.float32)
    ctx = rng.standard_normal((2, 4, 4, 4, 512)).astype(np.float32)
    mod = JCrossAttentionBlock(512, num_heads=heads, impl="xla",
                               dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx),
                 training=False)
    params = _perturb(v["params"], seed=heads, scale=0.02)
    stats = _stats(v["batch_stats"], seed=heads)
    ref = mod.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), jnp.asarray(ctx), training=False)
    blk = CrossAttentionBlock(512, num_heads=heads).eval()
    blk.load_state_dict(module_state(params, stats))
    with torch.no_grad():
        out = blk(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                  torch.from_numpy(ctx))
    _assert_close(out.permute(0, 2, 3, 4, 1).numpy(), ref)


def test_attention_block_adds_normalized_input():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 4, 4, 64)).astype(np.float32)
    mod = JAttentionBlock(64, impl="xla", dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    params = _perturb(v["params"], seed=7)
    stats = _stats(v["batch_stats"], seed=7)
    ref = mod.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), training=False)
    blk = AttentionBlock(64).eval()
    blk.load_state_dict(module_state(params, stats))
    with torch.no_grad():
        out = blk(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    _assert_close(out.permute(0, 2, 3, 4, 1).numpy(), ref)


def test_tiny_unet_one_denoise_step():
    jcfg = _flagship_cfg(tiny=True)
    tcfg = flagship_cfg(tiny=True)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 4, 4, 8)).astype(np.float32)
    t = np.array([7, 2], np.int32)
    c = np.array([1, 0], np.int32)
    mod = JUNet3D(jcfg.unet, out_channels=8, dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                 jnp.asarray(c), training=False)
    params = _perturb(v["params"], seed=11)
    stats = _stats(v["batch_stats"], seed=11)
    ref = mod.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
                    training=False)
    unet = UNet3D(tcfg.unet, out_channels=8, in_channels=8,
                  latent_size=4).eval()
    unet.load_state_dict(module_state(params, stats))
    with torch.no_grad():
        out = unet(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(c))
    assert out.shape == (2, 4, 4, 4, 8)
    _assert_close(out.numpy(), ref)


def test_flagship_unet_shape_and_attention_sites():
    # Construction only, on the meta device (no memory, no forward): the
    # full-width module has the flagship's six cross-attention sites, each
    # with its ContextMLP, and the embedding's null row.
    cfg = flagship_cfg()
    with torch.device("meta"):
        unet = UNet3D(cfg.unet, cfg.latent_channels, cfg.latent_channels,
                      cfg.latent_size)
    sites = sorted(n for n, m in unet.named_children()
                   if isinstance(m, CrossAttentionBlock))
    assert sites == ["xattn_down_1_0", "xattn_down_1_1", "xattn_mid",
                     "xattn_up_1_0", "xattn_up_1_1", "xattn_up_1_2"]
    assert unet.context_embed.weight.shape == (cfg.unet.context_dim + 2,
                                               4 * 256)
    assert unet.ctx_mlp_mid.Dense_0.weight.shape == (4 ** 3 * 512, 1024)

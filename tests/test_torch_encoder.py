"""The port's encode side against the JAX package, on the CPU: the
space-to-depth stem, the VQ-VAE `Encoder` (BatchNorm in eval and train
mode, GroupNorm as the flagship uses), the straight-through quantizer and
`LatentDiffusion.encode_latents`, on JAX-initialised weights perturbed with
seeded numpy noise and carried over by `ldm3d_torch.convert`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ldm3d.models.quantizers import VectorQuantizerSTE as JSTE
from ldm3d.models.vqvae import (Encoder as JEncoder, S2DStemConv as JS2D,
                                space_to_depth3d as j_s2d)
from ldm3d.train.dm_trainer import LatentDiffusion as JLatentDiffusion
from ldm3d_torch.convert import convert_state, module_state
from ldm3d_torch.core.config import flagship_cfg
from ldm3d_torch.models.layers import Conv3d
from ldm3d_torch.models.quantizers import VectorQuantizerSTE
from ldm3d_torch.models.vqvae import (VQVAE, Encoder, S2DStemConv,
                                      space_to_depth3d)
from ldm3d_torch.train.dm_trainer import LatentDiffusion
from test_torch_quantize import _distances, assert_same_argmin
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# float32 on both sides; an encoder output sums a few thousand products
# per layer in another order than XLA, so agreement is to a few float32
# ulps of the output's scale: 1e-5 relative to max |ref|.
REL_TOL = 1e-5


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), tree)


def _stats(tree, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        if path[-1].key == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, tree)


def _assert_close(out, ref, tol=REL_TOL):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def _ndhwc(t):
    return t.detach().permute(0, 2, 3, 4, 1).numpy()


def _volumes(b=2, size=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((b, size, size, size, 1)).astype(np.float32)


def test_space_to_depth_matches():
    x = np.arange(2 * 4 * 6 * 4 * 3, dtype=np.float32).reshape(2, 4, 6, 4, 3)
    ref = np.asarray(j_s2d(jnp.asarray(x), 2))
    out = _ndhwc(space_to_depth3d(_ncdhw(x), 2))
    np.testing.assert_array_equal(out, ref)


def test_s2d_stem_exactly_matches_k4s2_same_conv():
    # tests/test_s2d_stem.py's claim, for the port: any k4-s2 SAME kernel
    # w maps to w2[o, (qd, qh, qw, c), t] = w[o, c, 2t + q] and reproduces
    # the conv; float32 CPU, 1e-6 at outputs of O(1) (weights at the
    # scale of a glorot init, as there).
    torch.manual_seed(0)
    x = torch.randn(2, 2, 8, 8, 8)
    conv = Conv3d(2, 5, 4, stride=2)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.1)
        conv.bias.normal_(0.0, 0.1)
    stem = S2DStemConv(2, 5)
    w = conv.weight.detach().reshape(5, 2, 2, 2, 2, 2, 2, 2)
    w2 = w.permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(5, 16, 2, 2, 2)
    stem.conv.load_state_dict({"weight": w2, "bias": conv.bias.detach()})
    with torch.no_grad():
        ref, out = conv(x), stem(x)
    assert out.shape == ref.shape == (2, 5, 4, 4, 4)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_s2d_stem_matches_flax():
    x = _volumes(2, 8, seed=1)
    mod = JS2D(5, dtype=jnp.float32)
    params = _perturb(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                      seed=1)
    ref = mod.apply(params, jnp.asarray(x))
    stem = S2DStemConv(1, 5)
    stem.load_state_dict(module_state(params["params"]))
    with torch.no_grad():
        out = stem(_ncdhw(x))
    _assert_close(_ndhwc(out), ref)


def _cfgs(**kw):
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True).vqvae, **kw)
    tcfg = dataclasses.replace(flagship_cfg(tiny=True).vqvae, **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("norm,stem_s2d,training", [
    ("batch", False, False),   # the tiny stage-1, eval mode (encode)
    ("batch", False, True),    # batch statistics and their update
    ("group", False, False),   # the flagship stage-1's norm
    ("batch", True, False),    # the space-to-depth stem at level 0
])
def test_encoder_matches(norm, stem_s2d, training):
    jcfg, tcfg = _cfgs(norm=norm, stem_s2d=stem_s2d)
    x = _volumes(seed=2)
    mod = JEncoder(jcfg, dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    params = _perturb(v["params"], seed=3)
    stats = _stats(v.get("batch_stats", {}), seed=3)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    enc = Encoder(tcfg)
    enc.load_state_dict(module_state(params, stats))
    enc.train(training)
    if training:
        ref, upd = mod.apply(variables, jnp.asarray(x), training=True,
                             mutable=["batch_stats"])
    else:
        ref = mod.apply(variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        out = enc(_ncdhw(x))
    assert out.shape == (2, 8, 4, 4, 4)
    _assert_close(_ndhwc(out), ref)
    if training:
        # the running statistics after one update, to float32 rounding
        new = module_state(params, upd["batch_stats"])
        for k, t in enc.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), new[k].numpy(),
                                           rtol=1e-5, atol=1e-6)


def _ste(training, seed=4):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((2, 4, 4, 4, 8))).astype(np.float32)
    mod = JSTE(16, 8)
    v = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x), training=False)
    used = np.arange(16, dtype=np.float32)
    variables = {"params": jax.device_get(v["params"]),
                 "vq_stats": {"codebooks_used": used}}
    q = VectorQuantizerSTE(16, 8).train(training)
    q.load_state_dict({"codebook": torch.from_numpy(
        np.array(variables["params"]["codebook"])),
        "codebooks_used": torch.from_numpy(used.copy())})
    return x, mod, variables, q


@pytest.mark.parametrize("training", [True, False])
def test_ste_quantizer_matches(training):
    x, mod, variables, q = _ste(training)
    (ref, aux), upd = mod.apply(variables, jnp.asarray(x), training=training,
                                mutable=["vq_stats"])
    out, taux = q(torch.from_numpy(x))
    cb = np.asarray(variables["params"]["codebook"])
    assert_same_argmin(taux.indices.reshape(-1).numpy(),
                       np.asarray(aux.indices).reshape(-1),
                       _distances(x.reshape(-1, 8), cb))
    np.testing.assert_array_equal(taux.indices.numpy(),
                                  np.asarray(aux.indices))
    # x + (q - x) in float32 on both sides: bit for bit
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    # means of 1024 squares: 1e-6 relative
    np.testing.assert_allclose(taux.loss.item(), float(aux.loss), rtol=1e-6)
    np.testing.assert_allclose(taux.perplexity.item(), float(aux.perplexity),
                               rtol=1e-6)
    np.testing.assert_array_equal(taux.usage_counts.numpy(),
                                  np.asarray(aux.usage_counts))
    # the usage counter moves in training mode only, by this batch's counts
    want = np.asarray(upd["vq_stats"]["codebooks_used"])
    np.testing.assert_array_equal(q.codebooks_used.numpy(), want)
    moved = not np.array_equal(want, variables["vq_stats"]["codebooks_used"])
    assert moved == training


def test_straight_through_gradient_matches():
    x, mod, variables, q = _ste(True, seed=5)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def f(xin, cb):
        var = {**variables, "params": {"codebook": cb}}
        (out, aux), _ = mod.apply(var, xin, training=True,
                                  mutable=["vq_stats"])
        return jnp.sum(out * w) + aux.loss

    gx, gcb = jax.grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(variables["params"]["codebook"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = q(xt)
    (torch.sum(out * torch.from_numpy(w)) + aux.loss).backward()
    # straight through: d out / d x is the identity, so gx = w + d loss/dx
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(q.codebook.grad.numpy(), np.asarray(gcb),
                               rtol=1e-5, atol=1e-7)
    xt.grad = None
    out, _ = q(xt)
    out.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_encode_latents_matches():
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True), latent_scale=2.5)
    tcfg = dataclasses.replace(flagship_cfg(tiny=True), latent_scale=2.5)
    images = _volumes(seed=7)
    mod = JLatentDiffusion(jcfg, dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(images),
                 method="encode_latents")
    variables = {"params": _perturb(v["params"], seed=8),
                 "batch_stats": _stats(v["batch_stats"], seed=8),
                 "vq_stats": jax.device_get(v["vq_stats"])}
    ref = mod.apply(variables, jnp.asarray(images), method="encode_latents")
    state, _ = convert_state(variables)
    model = LatentDiffusion(tcfg).eval()
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected
    assert all(k.startswith(("unet.", "vqvae.decoder.")) for k in missing)
    with torch.no_grad():
        out = model.encode_latents(torch.from_numpy(images))
    assert out.shape == (2, 4, 4, 4, 8)
    # quantized codes times the scale: exact once the indices agree
    _assert_close(out.numpy(), ref, tol=1e-6)


def test_flagship_encoder_and_quantizer_shapes():
    # Construction only, on the meta device: the flagship stage-1 encodes
    # 128^3 x 1 volumes through 4 GroupNorm levels to 8^3 x 256 and
    # quantizes against K = 1024 codes.
    cfg = flagship_cfg().vqvae
    with torch.device("meta"):
        vq = VQVAE(cfg)
    assert vq.encoder.down_0.weight.shape == (32, 1, 4, 4, 4)
    assert vq.encoder.down_3.weight.shape == (256, 128, 4, 4, 4)
    assert vq.encoder.to_latent.weight.shape == (256, 256, 3, 3, 3)
    assert hasattr(vq.encoder.res_3_4.norm, "GroupNorm_0")
    assert vq.quantizer.codebook.shape == (1024, 256)
    assert vq.quantizer.codebooks_used.shape == (1024,)


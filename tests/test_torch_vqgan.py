"""The port's VQ-GAN modules against the JAX package's, on the CPU.

- `symmetric_pad3d` against `jnp.pad(mode="symmetric")` (TF SYMMETRIC,
  which repeats the edge voxel), `avgpool3d` against flax `avg_pool`, and
  the 2D SAME conv against flax `nn.Conv` (k4-s1 pads (1, 2)).
- The four autoencoder archs ("attn_cp", "attn", "stride", "monai") from
  JAX-initialised, converted weights: eval-mode outputs, and in training
  mode the output, the quantizer's loss, the gradients of every parameter
  and the updated BatchNorm / quantizer state, with JAX's quantizer draws
  recorded and injected.
- Both critics with the conv head, the 3D critic with the dense head at a
  last width that is no cube (its rows are channels-last), `use_sigmoid`,
  in training mode (BatchNorm batch statistics and their update) and in
  eval mode: logits and every intermediate feature.
- The GAN losses and `adopt_weight`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.core.config import DiscriminatorConfig as JDiscriminatorConfig
from ldm3d.core.config import QuantizerConfig as JQuantizerConfig
from ldm3d.core.config import VQVAEConfig as JVQVAEConfig
from ldm3d.models import layers as jlayers
from ldm3d.models import vqgan as jvqgan
from ldm3d_torch.convert import convert_state
from ldm3d_torch.core.config import (DiscriminatorConfig, QuantizerConfig,
                                     VQVAEConfig)
from ldm3d_torch.models import vqgan
from ldm3d_torch.models.layers import Conv2d, avgpool3d, symmetric_pad3d
from ldm3d_torch.models.quantizers import Draws
from test_torch_quantizers import recorded

B, SIZE = 2, 16
# Float32 convolutions, norms and sums in other orders than XLA: 1e-5 of
# the largest value of each compared tensor (its absolute error over its
# largest magnitude). Gradients sum over up to 2 x 16^3 x 64 products:
# 1e-4 of each tensor's largest value, plus 1e-5 of the model's largest
# gradient (a conv bias before a GroupNorm of one channel per group has
# an exact gradient of 0, and both sides give float32 noise around it).
REL_TOL = 1e-5
GRAD_REL_TOL, GRAD_ABS_SHARE = 1e-4, 1e-5


def _close(got, ref, tol=REL_TOL, what="", atol=0.0):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert err <= tol * scale + atol, (what, err, scale)


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _cl(t):
    """channels first (torch) -> channels last (JAX)."""
    return t.detach().movedim(1, -1).numpy()


@pytest.mark.parametrize("kernel,stride", [
    ((5, 1, 1), (1, 1, 1)), ((4, 3, 1), (1, 1, 1)), ((4, 4, 4), (2, 2, 2)),
    ((3, 3, 3), (1, 1, 1)), ((1, 1, 1), (1, 1, 1)), ((3, 4, 2), (1, 2, 2))])
def test_symmetric_pad_matches_jnp(kernel, stride):
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 4, 6)).astype(
        np.float32)
    ref = np.asarray(jlayers.symmetric_pad3d(
        jnp.asarray(np.moveaxis(x, 1, -1)), kernel, stride))
    pads = [(0, 0)] + [((k - s) // 2, k - s - (k - s) // 2)
                       for k, s in zip(kernel, stride)] + [(0, 0)]
    np.testing.assert_array_equal(ref, np.pad(np.moveaxis(x, 1, -1), pads,
                                              mode="symmetric"))
    got = symmetric_pad3d(torch.from_numpy(x), kernel, stride)
    np.testing.assert_array_equal(_cl(got), ref)
    # the edge voxel repeats: not a reflection
    lo = pads[1][0]
    if lo:
        np.testing.assert_array_equal(got[:, :, lo - 1], got[:, :, lo])


def test_symmetric_pad_refuses_a_pad_wider_than_the_dim():
    with pytest.raises(ValueError, match="wider"):
        symmetric_pad3d(torch.zeros(1, 1, 1, 4, 4), (6, 1, 1), (1, 1, 1))


def test_avgpool_and_2d_same_conv_match_flax():
    import flax.linen as nn
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 6, 4, 3)).astype(np.float32)
    _close(_cl(avgpool3d(torch.from_numpy(np.moveaxis(x, -1, 1)), 2)),
           jlayers.avgpool3d(jnp.asarray(x), 2), what="avgpool")
    f = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    for k, s in ((4, 1), (4, 2), (3, 1), (1, 1)):
        conv = nn.Conv(5, (k, k), strides=(s, s), padding="SAME")
        var = conv.init(jax.random.PRNGKey(k + s), jnp.asarray(f))
        ref = conv.apply(var, jnp.asarray(f))
        mod = Conv2d(3, 5, k, stride=s)
        mod.load_state_dict(convert_state({"params": _np(var["params"])})[0])
        got = mod(torch.from_numpy(np.moveaxis(f, -1, 1)))
        _close(_cl(got), ref, what=f"conv2d k{k} s{s}")


ARCHS = {
    "attn_cp": dict(norm="group", act="silu", kind="ema", remat=True),
    "attn": dict(norm="group", act="silu", kind="ema", remat=False),
    "stride": dict(norm="batch", act="relu", kind="ste", remat=True),
    "monai": dict(norm="batch", act="prelu", kind="ste", remat=True),
}


def ae_cfgs(arch):
    a = ARCHS[arch]
    q = dict(kind=a["kind"], num_embeddings=16, embedding_dim=8)
    kw = dict(in_channels=2, out_channels=2, num_channels=(4, 8),
              num_res_channels=(4, 8), num_res_layers=1,
              downsample_stride=(2, 2), downsample_kernel=(4, 4),
              upsample_stride=(2, 2), upsample_kernel=(4, 4),
              norm=a["norm"], act=a["act"], arch=arch, remat=a["remat"])
    return (JVQVAEConfig(quantizer=JQuantizerConfig(**q), **kw),
            VQVAEConfig(quantizer=QuantizerConfig(**q), **kw))


def _ae_pair(arch, seed=0):
    jcfg, tcfg = ae_cfgs(arch)
    jm = jvqgan.VQGANAutoencoder(jcfg, dtype=jnp.float32)
    x = jnp.zeros((B, SIZE, SIZE, SIZE, 2))
    var = _np(jm.init({"params": jax.random.PRNGKey(seed),
                       "noise": jax.random.PRNGKey(seed + 1)}, x,
                      training=False))
    tm = vqgan.VQGANAutoencoder(tcfg)
    tm.load_state_dict(convert_state(var)[0], strict=True)
    return jm, var, tm


def _input(seed):
    rng = np.random.default_rng(seed)
    vol = rng.random((B, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    return np.concatenate([vol, (vol > 0.6).astype(np.float32)], -1)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_autoencoder_eval_matches_jax(arch):
    jm, var, tm = _ae_pair(arch)
    x = _input(1)
    recon, aux = jm.apply(var, jnp.asarray(x), training=False)
    got, taux = tm.eval()(torch.from_numpy(x))
    assert got.shape == (B, SIZE, SIZE, SIZE, 2)
    _close(got.detach(), recon, what="recon")
    _close(taux.loss.detach(), aux.loss, what="q loss")
    np.testing.assert_array_equal(taux.indices.numpy(),
                                  np.asarray(aux.indices))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_autoencoder_training_matches_jax(arch, monkeypatch):
    """Training mode: output, quantizer loss, the gradient of
    sum(recon * w) + loss for every parameter, and the state after."""
    jm, var, tm = _ae_pair(arch, seed=2)
    x = _input(3)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    params = var["params"]
    rest = {k: v for k, v in var.items() if k != "params"}

    def loss(p):
        (recon, aux), upd = jm.apply(
            {"params": p, **rest}, jnp.asarray(x), training=True,
            mutable=list(rest), rngs={"noise": jax.random.PRNGKey(9)})
        return jnp.sum(recon * w) + aux.loss, (recon, aux, upd)

    with recorded(monkeypatch, "normal", "permutation") as draws:
        (ref_loss, (recon, aux, upd)), grads = jax.value_and_grad(
            loss, has_aux=True)(params)
    tm.train()
    got, taux = tm(torch.from_numpy(x), Draws(**draws))
    total = torch.sum(got * torch.from_numpy(w)) + taux.loss
    total.backward()
    _close(got.detach(), recon, what="recon")
    _close(taux.loss.detach(), aux.loss, what="q loss")
    want = convert_state({"params": _np(grads)})[0]
    named = dict(tm.named_parameters())
    assert want.keys() == named.keys()
    g_max = max(float(t.abs().max()) for t in want.values())
    for n, p in named.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(g, want[n], GRAD_REL_TOL, what=n, atol=GRAD_ABS_SHARE * g_max)
    after = convert_state({**{"params": params}, **_np(upd)})[0]
    for k, t in tm.state_dict().items():
        if k not in named:
            _close(t.float(), after[k].float(), what=k)


CRITICS = [("conv", False, (4, 8)), ("conv", True, (4, 8)),
           ("dense", False, (4, 6))]


@pytest.mark.parametrize("head,sigmoid,widths", CRITICS,
                         ids=[f"{h}{'_sigmoid' if s else ''}"
                              for h, s, _ in CRITICS])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_critics_match_jax(head, sigmoid, widths, training):
    jc = JDiscriminatorConfig(num_channels=widths, use_sigmoid=sigmoid,
                              head=head)
    tc = DiscriminatorConfig(num_channels=widths, use_sigmoid=sigmoid,
                             head=head)
    rng = np.random.default_rng(5)
    # the conv head on a volume that is no cube; the dense head, built for
    # a volume size, on 16^3
    depth = 12 if head == "conv" else SIZE
    vol = rng.standard_normal((B, SIZE, SIZE, depth, 1)).astype(np.float32)
    pairs = [(jvqgan.Discriminator3D(jc, dtype=jnp.float32),
              vqgan.Discriminator3D(tc, 1, volume_size=SIZE), vol)]
    if head == "conv":
        pairs.append((jvqgan.Discriminator2D(jc, dtype=jnp.float32),
                      vqgan.Discriminator2D(tc, 1), vol[:, 3]))
    for jmod, tmod, inp in pairs:
        var = _np(jmod.init({"params": jax.random.PRNGKey(6)},
                            jnp.asarray(inp), training=False))
        # move the statistics off their init, so eval mode reads them
        var["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (a + rng.random(a.shape).astype(np.float32)),
            var["batch_stats"])
        tmod.load_state_dict(convert_state(var)[0], strict=True)
        if training:
            (logits, feats), upd = jmod.apply(var, jnp.asarray(inp),
                                              training=True,
                                              mutable=["batch_stats"])
        else:
            logits, feats = jmod.apply(var, jnp.asarray(inp),
                                       training=False)
        tmod.train(training)
        got, tfeats = tmod(torch.from_numpy(np.moveaxis(inp, -1, 1)))
        if head == "dense":
            _close(got.detach(), logits, what="dense logits")
        else:
            _close(_cl(got), logits, what="logits")
        assert len(tfeats) == len(feats) == len(widths) + 2
        for i, (a, b) in enumerate(zip(tfeats[:-1], feats[:-1])):
            _close(_cl(a), b, what=f"feature {i}")
        if sigmoid:
            got = got.detach()
            assert 0.0 <= float(got.min()) <= float(got.max()) <= 1.0
        if training:
            want = convert_state({"params": var["params"], **_np(upd)})[0]
            for k, t in tmod.state_dict().items():
                if "running" in k:
                    _close(t, want[k], what=k)


def test_dense_head_rows_are_channels_last():
    """The dense head's first layer reads the tail's output flattened in
    (D, H, W, C) order: permuting the converted rows as if the flatten
    were channels-first changes the logits."""
    tc = DiscriminatorConfig(num_channels=(4, 6), head="dense")
    m = vqgan.Discriminator3D(tc, 1, volume_size=8)
    from ldm3d_torch.models.layers import init_params_
    init_params_(m, torch.Generator().manual_seed(0))
    x = torch.randn(2, 1, 8, 8, 8, generator=torch.Generator().manual_seed(1))
    ref, _ = m.eval()(x)
    w = m.dense1.weight.detach().clone()            # (64, D H W C)
    m.dense1.weight.data = w.view(64, 2, 2, 2, 6).permute(
        0, 4, 1, 2, 3).reshape(64, -1)
    moved, _ = m(x)
    assert not torch.allclose(ref, moved)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(7)
    logits = (3 * rng.standard_normal((2, 4, 4, 4, 1))).astype(np.float32)
    logits[0, 0, 0, 0, 0] = 60.0          # exp overflows in a naive CE
    logits[0, 0, 0, 1, 0] = -60.0
    for ones in (True, False):
        for j, t in ((jvqgan.hinge_d_loss, vqgan.hinge_d_loss),
                     (jvqgan.vanilla_d_loss, vqgan.vanilla_d_loss)):
            ref = float(j(ones, jnp.asarray(logits)))
            got = float(t(ones, torch.from_numpy(logits)))
            assert np.isfinite(got)
            np.testing.assert_allclose(got, ref, rtol=1e-6)
    for epoch in (0, 3, 4, 9):
        assert vqgan.adopt_weight(0.8, epoch, 4) == pytest.approx(
            float(jvqgan.adopt_weight(0.8, jnp.asarray(epoch), 4)))

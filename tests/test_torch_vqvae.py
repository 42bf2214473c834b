"""The port's stage-1 VQ-VAE against the JAX package, on the CPU: the
encoder and decoder with dropout in training mode (JAX's keep masks,
recorded from `jax.random.bernoulli`, injected through `Draws`), the whole
`VQVAE.forward` with an NSVQ quantizer (masks and noise injected), the
ICNR init of `kernel_resize`, and the remat modes, which must give the
same loss, gradients and BatchNorm running statistics as no remat.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.models.layers import icnr_init as j_icnr_init
from ldm3d.models.vqvae import (VQVAE as JVQVAE, Decoder as JDecoder,
                                Encoder as JEncoder)
from ldm3d_torch.convert import convert_state, module_state
from ldm3d_torch.core.config import (QuantizerConfig, TrainConfig,
                                     VQVAEConfig)
from ldm3d_torch.models.layers import ConvTranspose3d, icnr_init, init_params_
from ldm3d_torch.models.quantizers import Draws
from ldm3d_torch.models.vqvae import VQVAE, Decoder, Encoder
from ldm3d_torch.train.vq_trainer import VQTrainer
from test_torch_encoder import _ncdhw, _ndhwc, _perturb, _stats, _volumes
from test_torch_quantizers import recorded
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# float32 on both sides, convolutions summed in other orders than XLA:
# 1e-5 of the largest output (as test_torch_encoder.py).
REL_TOL = 1e-5


def _cfg(**kw):
    kw.setdefault("quantizer", QuantizerConfig(kind="ste", num_embeddings=16,
                                               embedding_dim=8))
    return VQVAEConfig(
        in_channels=1, out_channels=1, num_channels=(4, 8),
        num_res_channels=(4, 8), num_res_layers=1, downsample_stride=(2, 2),
        downsample_kernel=(4, 4), upsample_stride=(2, 2),
        upsample_kernel=(4, 4), **kw)


def _close(out, ref, tol=REL_TOL):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_dropout_matches_jax(part, monkeypatch):
    cfg = _cfg(dropout=0.3)
    if part == "encoder":
        x, jmod, tmod = _volumes(seed=3), JEncoder(cfg, dtype=jnp.float32), \
            Encoder(cfg)
    else:
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 4, 4, 4, 8)).astype(np.float32)
        jmod, tmod = JDecoder(cfg, dtype=jnp.float32), Decoder(cfg)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    params, stats = _perturb(v["params"], 5), _stats(v["batch_stats"], 5)
    with recorded(monkeypatch, "bernoulli") as draws:
        ref, upd = jmod.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), training=True,
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(9)})
    # two dropout sites each: (level 1, latent) / (stem, between levels)
    assert len(draws["bernoulli"]) == 2
    tmod.load_state_dict(module_state(params, stats))
    tmod.train()
    with torch.no_grad():
        out = tmod(_ncdhw(x), Draws(**draws))
    _close(_ndhwc(out), ref)
    new = module_state(params, upd["batch_stats"])
    for k, t in tmod.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), new[k].numpy(), rtol=1e-5,
                                       atol=1e-6)
    # eval mode (the updated statistics): no dropout, no draws
    with torch.no_grad():
        out = tmod.eval()(_ncdhw(x))
    _close(_ndhwc(out), jmod.apply(
        {"params": params, "batch_stats": upd["batch_stats"]},
        jnp.asarray(x), training=False))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_vqvae_forward_matches_jax(training, monkeypatch):
    """encoder -> NSVQ -> decoder with dropout, as JAX's `__call__`."""
    cfg = _cfg(dropout=0.2, quantizer=QuantizerConfig(
        kind="nsvq", num_embeddings=16, embedding_dim=8))
    x = _volumes(seed=6)
    jmod = JVQVAE(cfg, dtype=jnp.float32)
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), training=False)
    variables = {"params": _perturb(v["params"], 7),
                 "batch_stats": _stats(v["batch_stats"], 7),
                 "vq_stats": jax.device_get(v["vq_stats"])}
    with recorded(monkeypatch, "bernoulli", "normal") as draws:
        (ref, aux), upd = jmod.apply(
            variables, jnp.asarray(x), training=training,
            mutable=["batch_stats", "vq_stats"],
            rngs={"dropout": jax.random.PRNGKey(2),
                  "noise": jax.random.PRNGKey(3)})
    model = VQVAE(cfg)
    state, _ = convert_state(variables)
    model.load_state_dict(state, strict=True)
    model.train(training)
    with torch.no_grad():
        out, taux = model(torch.from_numpy(x), Draws(**draws))
    assert out.shape == x.shape
    _close(out.numpy(), ref)
    np.testing.assert_allclose(taux.loss.item(), float(aux.loss), rtol=1e-5)
    np.testing.assert_array_equal(taux.indices.numpy(),
                                  np.asarray(aux.indices))
    new, _ = convert_state({"batch_stats": upd["batch_stats"],
                            "vq_stats": upd["vq_stats"]})
    got = model.state_dict()
    for k, t in new.items():
        np.testing.assert_allclose(got[k].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_icnr_init_matches_jax():
    # A shared base kernel at half size, resized to the k4 kernel: flax
    # layout (kd, kh, kw, OUT, IN), the port's (IN, OUT, kd, kh, kw).
    rng = np.random.default_rng(8)
    small = rng.standard_normal((2, 2, 2, 3, 5)).astype(np.float32)
    init = j_icnr_init(lambda key, shape, dtype: jnp.asarray(small), 2)
    ref = np.asarray(init(jax.random.PRNGKey(0), (4, 4, 4, 3, 5)))
    out = icnr_init(torch.from_numpy(small.transpose(4, 3, 0, 1, 2).copy()),
                    (4, 4, 4))
    # a convex combination of at most 8 values per tap: float32 rounding
    np.testing.assert_allclose(out.numpy(), ref.transpose(4, 3, 0, 1, 2),
                               rtol=1e-6, atol=1e-7)


def test_kernel_resize_initialises_transposed_convs_with_icnr():
    dec = Decoder(_cfg(kernel_resize=True))
    init_params_(dec, torch.Generator().manual_seed(0))
    for m in dec.modules():
        if isinstance(m, ConvTranspose3d):
            assert m.kernel_resize
            w = m.weight.detach()
            # trilinear x2: tap 1 = 3/4 tap 0 + 1/4 tap 3, on every axis
            for axis in (2, 3, 4):
                t = [w.select(axis, i) for i in range(4)]
                torch.testing.assert_close(t[1], 0.75 * t[0] + 0.25 * t[3],
                                           rtol=1e-5, atol=1e-6)
            # a glorot-normal base: std sqrt(2 / fan_sum) at half size
            ci, co = w.shape[:2]
            std = (2.0 / (8 * ci + 8 * co)) ** 0.5
            assert float(w[:, :, ::3, ::3, ::3].abs().max()) <= 2 * std \
                / .87962566103423978 + 1e-6


def _step(cfg, vol, mask, seed=0):
    tr = VQTrainer(cfg, TrainConfig(dtype="float32", batch_size=2,
                                    learning_rate=1e-3),
                   device="cpu").init_random(seed)
    m = tr.train_step(vol, mask)
    grads = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
    return float(m["loss"]), grads, {k: b.clone() for k, b in
                                     tr.model.named_buffers()}


@pytest.mark.parametrize("norm,kind", [("batch", "nsvq"), ("group", "ste")])
def test_remat_modes_same_loss_grads_and_statistics(norm, kind):
    """remat off, "full" and "conv" recompute the same function: the loss,
    every gradient and every buffer (BatchNorm running statistics updated
    once, the quantizer's usage) are equal bit for bit, dropout and the
    quantizer's noise drawn from the trainer's generator included."""
    vol = torch.from_numpy(_volumes(seed=10))
    mask = (vol > 0.5).float()
    base = _cfg(norm=norm, dropout=0.1, quantizer=QuantizerConfig(
        kind=kind, num_embeddings=16, embedding_dim=8))
    off = _step(base, vol, mask)
    assert any("running_mean" in k for k in off[2]) == (norm == "batch")
    for policy in ("full", "conv"):
        loss, grads, bufs = _step(dataclasses.replace(
            base, remat=True, remat_policy=policy), vol, mask)
        assert loss == off[0], policy
        for n, g in grads.items():
            assert torch.equal(g, off[1][n]), (policy, n)
        for n, b in bufs.items():
            assert torch.equal(b, off[2][n]), (policy, n)


def test_remat_checkpoints_only_with_gradients(monkeypatch):
    # eval and no_grad run the units plainly; training with gradients
    # checkpoints each residual unit once
    import ldm3d_torch.models.vqvae as tv
    calls = []
    real = tv.checkpoint
    monkeypatch.setattr(tv, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    model = VQVAE(_cfg(remat=True))
    x = torch.from_numpy(_volumes(seed=11))
    with torch.no_grad():
        model.train()(x, Draws(torch.Generator().manual_seed(0)))
    assert not calls
    out, aux = model(x)
    (out.sum() + aux.loss).backward()
    assert len(calls) == 4          # 2 levels x 1 unit, encoder and decoder

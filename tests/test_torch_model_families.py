"""The port's skip-connection EMA VQ-VAE, legacy VQ-VAE and generic 3D
U-Net against the JAX package's, on the CPU.

- `VQTrainer` on the "ema_skip" family (the `emavqvae` preset's model at
  small widths) and on the "legacy" family in mode 1 (2 and 3
  downsamples) and mode 2: from one JAX-initialised state, one
  `train_step` and one `eval_step` on both sides; metrics, gradients
  (Adam's first moments), parameter changes, BatchNorm statistics and the
  Sonnet EMA quantizer's state (tolerances of
  tests/test_torch_vq_trainer.py).
- `EMAVQVAE3D`'s output dict and `UNet3DSegment` (nearest and transposed
  ups) in eval and training mode; `test_loss`.
- The presets against the JAX package's, and a bitwise resume of the
  skip model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.core import presets as jpresets
from ldm3d.core.config import QuantizerConfig as JQuantizerConfig
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.core.config import VQVAEConfig as JVQVAEConfig
from ldm3d.models import emavqvae as jema
from ldm3d.models import vqvae_legacy as jlegacy
from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
from ldm3d_torch.convert import convert_state
from ldm3d_torch.core import presets
from ldm3d_torch.core.config import (QuantizerConfig, TrainConfig,
                                     VQVAEConfig)
from ldm3d_torch.models import emavqvae, vqvae_legacy
from ldm3d_torch.train.vq_trainer import VQTrainer
from test_torch_samplers import FAST
from test_torch_vq_trainer import (DELTA_ATOL, DELTA_SHARE, GRAD_SHARE,
                                   MOMENT_RTOL, STATS_ATOL, STATS_RTOL,
                                   _metrics_close, _model_state, _np,
                                   _state_equal, _torch_tree)

B, SIZE, LR = 2, 16, 1e-3
# float32 convolutions summed in other orders: 1e-5 of the largest value;
# the U-Net chains 19 convolutions of up to 27 x 48 products each (about
# 2e-6 of rounding each), 1e-4.
REL_TOL, UNET_REL_TOL = 1e-5, 1e-4


def _cfgs(family, mode=1, down=3):
    if family == "ema_skip":
        q = dict(kind="ema_sonnet", num_embeddings=16, embedding_dim=8)
        kw = dict(num_channels=(4, 8, 16, 32),
                  num_res_channels=(4, 8, 16, 32))
    else:
        q = dict(kind="ste", num_embeddings=16, embedding_dim=4)
        kw = dict(legacy_mode=mode, legacy_down=down)
    kw.update(in_channels=1, out_channels=1, family=family)
    return (JVQVAEConfig(quantizer=JQuantizerConfig(**q), **kw),
            VQVAEConfig(quantizer=QuantizerConfig(**q), **kw))


def _pair(family, mode=1, down=3, seed=0):
    jcfg, tcfg = _cfgs(family, mode, down)
    jtr = JVQTrainer(jcfg, JTrainConfig(batch_size=B, dtype="float32",
                                        learning_rate=LR))
    shape = (B, SIZE, SIZE, SIZE, 1)
    st = jax.jit(jtr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(seed), shape).compile(compiler_options=FAST)(
        jax.random.PRNGKey(seed))
    tt = VQTrainer(tcfg, TrainConfig(dtype="float32", batch_size=B,
                                     learning_rate=LR),
                   device="cpu")
    tt.model.load_state_dict(_model_state(st), strict=True)
    return jtr, st, tt


def _batch(seed):
    rng = np.random.default_rng(seed)
    vol = rng.random((B, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    return vol, (vol > 0.6).astype(np.float32)


FAMILIES = [("ema_skip", 1, 3), ("legacy", 1, 3), ("legacy", 1, 2),
            ("legacy", 2, 3)]


@pytest.mark.parametrize("family,mode,down", FAMILIES,
                         ids=["ema_skip", "legacy1_down3", "legacy1_down2",
                              "legacy2"])
def test_vq_trainer_step_matches_jax(family, mode, down):
    jtr, st, tt = _pair(family, mode, down)
    vol, mask = _batch(1)
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    st2, jm = jtr.train_step(st, jnp.asarray(vol), jnp.asarray(mask))
    tm = tt.train_step(torch.from_numpy(vol), torch.from_numpy(mask))
    _metrics_close(tm, jm)

    inner = st2.opt_state.inner_state[0]
    mu, nu = _torch_tree(inner.mu), _torch_tree(inner.nu)
    new = _torch_tree(st2.params)
    scale = max(np.abs(m).max() for m in mu.values())
    grads = {n: np.sqrt(v / (1.0 - 0.999)) for n, v in nu.items()}
    g_max = max(g.max() for g in grads.values())
    compared = 0
    assert set(mu) == {n for n, _ in tt.model.named_parameters()}
    for n, p in tt.model.named_parameters():
        m = tt.optimizer.state[p]["exp_avg"].numpy()
        assert np.abs(m - mu[n]).max() <= MOMENT_RTOL * scale, n
        g = grads[n]
        sure = (g >= DELTA_SHARE * g.max()) & (g >= GRAD_SHARE * g_max)
        if not sure.any():
            continue
        compared += 1
        d_port = (p.detach() - before[n]).numpy()
        d_ref = new[n] - before[n].numpy()
        assert np.abs(d_port - d_ref)[sure].max() <= DELTA_ATOL, n
    assert compared > len(mu) // 2
    got = tt.model.state_dict()
    for k, t in _model_state(st2).items():
        if k not in before:        # statistics and quantizer buffers
            np.testing.assert_allclose(got[k].float().numpy(),
                                       t.float().numpy(), rtol=STATS_RTOL,
                                       atol=STATS_ATOL, err_msg=k)

    tt.model.load_state_dict(_model_state(st2), strict=True)
    jev = jtr.eval_step(st2, jnp.asarray(vol), jnp.asarray(mask))
    tev = tt.eval_step(torch.from_numpy(vol), torch.from_numpy(mask))
    _metrics_close(tev, jev)
    # replacement is a no-op for the EMA quantizer, a re-seed for STE
    assert tt.replace_unused(1) == 0 or family == "legacy"


def _close(got, ref, tol=REL_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _vars(jmod, x, seed=0):
    return _np(jmod.init({"params": jax.random.PRNGKey(seed)},
                         jnp.asarray(x), training=False))


def test_emavqvae_dict_output_matches_jax():
    x, _ = _batch(2)
    jm = jema.EMAVQVAE3D(num_channels=1, num_filters=4, embedding_dim=8,
                         num_embeddings=16, dtype=jnp.float32)
    var = _vars(jm, x)
    tm = emavqvae.EMAVQVAE3D(num_channels=1, num_filters=4, embedding_dim=8,
                             num_embeddings=16)
    tm.load_state_dict(convert_state(var)[0], strict=True)
    for training in (False, True):
        if training:
            ref, _ = jm.apply(var, jnp.asarray(x), training=True,
                              mutable=["vq_stats", "batch_stats"])
        else:
            ref = jm.apply(var, jnp.asarray(x), training=False)
        got = tm.train(training)(torch.from_numpy(x))
        assert set(got) == set(ref) == {"x_out", "vq_loss", "perplexity"}
        for k in ref:
            _close(got[k].detach(), ref[k])
    assert tm.quantizer is tm.quantization


@pytest.mark.parametrize("bilinear", [True, False],
                         ids=["nearest", "transposed"])
def test_unet3d_segment_matches_jax(bilinear):
    x = np.random.default_rng(3).standard_normal(
        (B, SIZE, SIZE, SIZE, 2)).astype(np.float32)
    jm = jema.UNet3DSegment(num_channels=3, num_filters=2, bilinear=bilinear,
                            dtype=jnp.float32)
    var = _vars(jm, x, seed=1)
    tm = emavqvae.UNet3DSegment(num_channels=3, num_filters=2,
                                bilinear=bilinear, in_channels=2)
    tm.load_state_dict(convert_state(var)[0], strict=True)
    ref = jm.apply(var, jnp.asarray(x), training=False)["x_out"]
    _close(tm.eval()(torch.from_numpy(x))["x_out"].detach(), ref,
           UNET_REL_TOL)
    ref, upd = jm.apply(var, jnp.asarray(x), training=True,
                        mutable=["batch_stats"])
    _close(tm.train()(torch.from_numpy(x))["x_out"].detach(),
           ref["x_out"], UNET_REL_TOL)
    want = convert_state({"params": var["params"], **_np(upd)})[0]
    for k, t in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL)


def test_legacy_test_loss_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.random((2, 4, 4, 4, 1)).astype(np.float32)
    r = rng.random((2, 4, 4, 4, 1)).astype(np.float32)
    for tv in (0.0949, 0.5):
        np.testing.assert_allclose(
            float(vqvae_legacy.test_loss(torch.from_numpy(x),
                                         torch.from_numpy(r), tv)),
            float(jlegacy.test_loss(jnp.asarray(x), jnp.asarray(r), tv)),
            rtol=1e-6)


def _same_fields(port, ref, where=""):
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _same_fields(getattr(port, f.name), getattr(ref, f.name),
                         f"{where}.{f.name}")
    else:
        assert port == ref, (where, port, ref)


@pytest.mark.parametrize("name", ["emavqvae", "vqvae_legacy", "vqgan_attn",
                                  "vqgan_attn_sym", "vqgan_baseline",
                                  "vqgan_gnorm", "vqgan_stride"])
def test_presets_equal_jax(name):
    _same_fields(presets.get_preset(name), jpresets.get_preset(name))


def test_ema_skip_resume_is_bitwise(tmp_path):
    _, tcfg = _cfgs("ema_skip")
    tc = TrainConfig(dtype="float32", batch_size=B, learning_rate=LR, seed=2)
    vol, mask = map(torch.from_numpy, _batch(5))
    straight = VQTrainer(tcfg, tc, device="cpu").init_random(1)
    for _ in range(2):
        straight.train_step(vol, mask)
    saver = VQTrainer(tcfg, tc, device="cpu").init_random(1)
    saver.train_step(vol, mask)
    fresh = VQTrainer(tcfg, tc, device="cpu")
    fresh.load_state_dict(saver.state_dict())
    fresh.train_step(vol, mask)
    _state_equal(straight, fresh)

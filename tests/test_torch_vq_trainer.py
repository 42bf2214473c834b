"""The port's `VQTrainer` against the JAX package's, on the CPU.

From one JAX-initialised state (`TrainConfig(dtype="float32")`), carried
over by `ldm3d_torch.convert`, both trainers take one `train_step` (JAX's
step compiled with its dropout masks and quantizer noise returned as
outputs of the same program, `compiled_with_draws`, and injected into the
port) and then one `eval_step`, for the
ste, nsvq and rnsvq quantizers on a 1-channel and a 2-channel config; the
epoch-end `replace_unused` follows, with JAX's draws re-derived from its
key. Then `recalibrate_batch_stats`, and the port's bitwise exact resume.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.core.config import QuantizerConfig as JQuantizerConfig
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.core.config import VQVAEConfig as JVQVAEConfig
from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
from ldm3d_torch.convert import convert_state
from ldm3d_torch.core.config import (QuantizerConfig, TrainConfig,
                                     VQVAEConfig)
from ldm3d_torch.models.quantizers import Draws
from ldm3d_torch.train.checkpoint import CheckpointManager
from ldm3d_torch.train.vq_trainer import VQTrainer
from test_torch_quantizers import _replacement_draws, compiled_with_draws
from test_torch_samplers import FAST
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

B, SIZE, LR = 2, 16, 1e-3
# Metrics: means over 8192 voxels after the VQ-VAE in float32, summed in
# other orders than XLA: 1e-5 relative. SSIM 1e-6 absolute and PSNR 1e-5
# relative, as tests/test_torch_metrics.py.
METRIC_RTOL = 1e-5
# Gradients, through Adam's first moment (0.1 g): float32 sums over up to
# 2 x 8^3 x 64 products in other orders; 1e-4 of the model's largest first
# moment is the absolute tolerance of every element (a conv bias before
# training-mode BatchNorm has a gradient that is float32 noise around 0).
MOMENT_RTOL = 1e-4
# Parameter changes after one Adam step (about lr * sign(g)): 1e-3 lr,
# where |g| is at least 1e-2 of its tensor's largest and 1e-4 of the
# model's largest, the float32 noise of sums over 1e3-1e4 terms (below,
# Adam scales that noise to a step of any sign, e.g. on a conv bias before
# training-mode BatchNorm, whose exact gradient is 0; see
# tests/test_torch_train.py).
DELTA_ATOL, DELTA_SHARE, GRAD_SHARE = 1e-3 * LR, 1e-2, 1e-4
# BatchNorm statistics and usage after the step.
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


def _cfgs(kind, channels, dropout=0.0, norm="batch"):
    qkw = dict(kind=kind, num_embeddings=16, embedding_dim=8, num_stages=3,
               discarding_threshold=0.5,
               quantize_loss_weight=1.0 if kind == "ste" else 1e2)
    kw = dict(in_channels=channels, out_channels=channels,
              num_channels=(4, 8), num_res_channels=(4, 8), num_res_layers=1,
              downsample_stride=(2, 2), downsample_kernel=(4, 4),
              upsample_stride=(2, 2), upsample_kernel=(4, 4),
              dropout=dropout, norm=norm)
    return (JVQVAEConfig(quantizer=JQuantizerConfig(**qkw), **kw),
            VQVAEConfig(quantizer=QuantizerConfig(**qkw), **kw))


def _batch(seed):
    rng = np.random.default_rng(seed)
    vol = rng.random((B, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    return vol, (vol > 0.6).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _pair(kind, channels, dropout=0.0, seed=0):
    """A JAX trainer and state, and a port trainer holding that state."""
    jcfg, tcfg = _cfgs(kind, channels, dropout)
    jtr = JVQTrainer(jcfg, JTrainConfig(batch_size=B, dtype="float32",
                                        learning_rate=LR))
    shape = (B, SIZE, SIZE, SIZE, channels)
    st = jax.jit(jtr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(seed), shape).compile(compiler_options=FAST)(
        jax.random.PRNGKey(seed))
    tt = VQTrainer(tcfg, TrainConfig(dtype="float32", batch_size=B,
                                     learning_rate=LR),
                   device="cpu")
    tt.model.load_state_dict(_model_state(st), strict=True)
    return jtr, st, tt


def _model_state(st):
    tree = {"params": _np(st.params), "vq_stats": _np(st.vq_stats)}
    if st.batch_stats is not None:
        tree["batch_stats"] = _np(st.batch_stats)
    return convert_state(tree)[0]


def _torch_tree(tree):
    return {k: t.numpy() for k, t in convert_state(
        {"params": _np(tree)})[0].items()}


def _metrics_close(got, ref):
    assert set(got) == set(ref), (set(got), set(ref))
    for k, v in ref.items():
        if k == "ssim":
            np.testing.assert_allclose(float(got[k]), float(v), atol=1e-6)
        else:
            np.testing.assert_allclose(float(got[k]), float(v),
                                       rtol=METRIC_RTOL, err_msg=k)


CASES = [("ste", 1, 0.0), ("ste", 2, 0.2), ("nsvq", 1, 0.0),
         ("nsvq", 2, 0.0), ("rnsvq", 1, 0.0), ("rnsvq", 2, 0.1)]


@pytest.mark.parametrize("kind,channels,dropout", CASES,
                         ids=[f"{k}_{c}ch" + ("_drop" if d else "")
                              for k, c, d in CASES])
def test_train_and_eval_step_match_jax(kind, channels, dropout):
    jtr, st, tt = _pair(kind, channels, dropout)
    vol, mask = _batch(1)
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    # JAX's step compiled, its dropout masks and NSVQ noise outputs of the
    # same program
    (st2, jm), draws = compiled_with_draws(
        jtr._build_train_step(st).__wrapped__,
        (st, jnp.asarray(vol), jnp.asarray(mask)), "normal", "bernoulli")
    assert bool(draws["bernoulli"]) == bool(dropout)
    assert len(draws["normal"]) == (kind != "ste")
    tm = tt.train_step(torch.from_numpy(vol), torch.from_numpy(mask),
                       Draws(**draws))
    if kind == "rnsvq":
        assert {f"perplexity_stage{i}" for i in range(3)} <= set(tm)
    _metrics_close(tm, jm)

    # gradients (Adam's first moment) and the parameter changes
    inner = st2.opt_state.inner_state[0]
    mu, nu = _torch_tree(inner.mu), _torch_tree(inner.nu)
    new = _torch_tree(st2.params)
    scale = max(np.abs(m).max() for m in mu.values())
    grads = {n: np.sqrt(v / (1.0 - 0.999)) for n, v in nu.items()}   # |g|
    g_max = max(g.max() for g in grads.values())
    compared = 0
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
    # BatchNorm statistics and the usage counter after the step
    got = tt.model.state_dict()
    for k, t in _model_state(st2).items():
        if "running" in k or "codebooks_used" in k:
            np.testing.assert_allclose(got[k].numpy(), t.numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL)

    # eval from the state JAX reached
    tt.model.load_state_dict(_model_state(st2), strict=True)
    args = (st2, jnp.asarray(vol), jnp.asarray(mask))
    jev = jtr._eval_step.lower(*args).compile(compiler_options=FAST)(*args)
    tev = tt.eval_step(torch.from_numpy(vol), torch.from_numpy(mask))
    _metrics_close(tev, jev)
    assert float(tev["ssim"]) <= 1.0

    # epoch-end replacement, JAX's draws re-derived from its key
    key = jax.random.PRNGKey(5)
    st3, n_ref = jtr.replace_unused(st2, 2, key)
    usage = np.asarray(st2.vq_stats["quantizer"]["codebooks_used"])
    cb_shape = (16, 8)
    if kind == "rnsvq":
        keys = list(jax.random.split(key, 3))
        rows = [(keys[i], usage[i]) for i in range(3)]
    else:
        rows = [(key, usage)]
    choices, normals = zip(*(_replacement_draws(k, u, 16, cb_shape, 0.5, 2)
                             for k, u in rows))
    n = tt.replace_unused(2, Draws(choice=list(choices),
                                   normal=list(normals)))
    assert n == int(n_ref)
    for k, t in _model_state(st3).items():
        if "codebook" in k:
            np.testing.assert_array_equal(got[k].numpy(), t.numpy())


def test_replace_unused_is_a_no_op_for_the_ema_kinds():
    for kind in ("ema", "ema_sonnet"):
        _, tcfg = _cfgs("ste", 1)
        tcfg = VQVAEConfig(**{**tcfg.__dict__, "quantizer": QuantizerConfig(
            kind=kind, num_embeddings=16, embedding_dim=8)})
        tt = VQTrainer(tcfg, device="cpu").init_random(0)
        before = {k: t.clone() for k, t in tt.model.state_dict().items()}
        assert tt.replace_unused(3) == 0
        for k, t in tt.model.state_dict().items():
            assert torch.equal(t, before[k]), k


def test_recalibrate_batch_stats_matches_jax():
    jtr, st, tt = _pair("ste", 2, seed=3)
    loader = [(*map(jnp.asarray, _batch(s)), None) for s in (4, 5)]
    st2 = jtr.recalibrate_batch_stats(st, loader, passes=2)
    before = {k: t.clone() for k, t in tt.model.state_dict().items()}
    tt.recalibrate_batch_stats(
        [(torch.from_numpy(np.asarray(v)), torch.from_numpy(np.asarray(m)),
          None) for v, m, _ in loader], passes=2)
    got = tt.model.state_dict()
    want = _model_state(st2)
    moved = 0
    for k, t in got.items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL)
            moved += not torch.equal(t, before[k])
        else:   # weights and the quantizer's usage are left alone
            assert torch.equal(t, before[k]), k
    assert moved > 0
    assert not tt.model.training


def _run(tr, vol, mask, steps):
    for _ in range(steps):
        tr.train_step(vol, mask)


def _state_equal(a, b):
    def walk(x, y, where):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), where
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), where
            for k in x:
                walk(x[k], y[k], f"{where}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{where}/{i}")
        else:
            assert x == y, where
    walk(a.state_dict(), b.state_dict(), "")


@pytest.mark.parametrize("kind", ["nsvq", "ema"])
def test_resume_is_bitwise(kind, tmp_path):
    """Two steps straight equal step, save, restore into a fresh trainer,
    step: weights, statistics, quantizer state, Adam, step and generator,
    with dropout and the quantizer's draws from the trainer's generator."""
    _, tcfg = _cfgs("ste", 1, dropout=0.2)
    tcfg = VQVAEConfig(**{**tcfg.__dict__, "quantizer": QuantizerConfig(
        kind=kind, num_embeddings=16, embedding_dim=8)})
    tc = TrainConfig(dtype="float32", batch_size=B, learning_rate=LR, seed=3)
    vol, mask = map(torch.from_numpy, _batch(6))
    straight = VQTrainer(tcfg, tc, device="cpu").init_random(1)
    _run(straight, vol, mask, 2)
    saver = VQTrainer(tcfg, tc, device="cpu").init_random(1)
    _run(saver, vol, mask, 1)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, saver.state_dict())
    state, _ = ckpt.restore(1)
    fresh = VQTrainer(tcfg, tc, device="cpu")
    fresh.load_state_dict(state)
    assert fresh.step == 1
    _run(fresh, vol, mask, 1)
    _state_equal(straight, fresh)
    # and the state dict survives a round trip through bytes unchanged
    buf = io.BytesIO()
    torch.save(fresh.state_dict(), buf)
    buf.seek(0)
    again = VQTrainer(tcfg, tc, device="cpu")
    again.load_state_dict(torch.load(buf, weights_only=True))
    _state_equal(fresh, again)


def test_stage1_families_build_and_unknown_refused():
    """The ema_skip and legacy families build their models and step; an
    unknown family is refused."""
    from ldm3d_torch.models.emavqvae import EMASkipTrainable
    from ldm3d_torch.models.vqvae_legacy import LegacyVQVAE
    _, tcfg = _cfgs("ste", 1)
    for family, cls in (("ema_skip", EMASkipTrainable),
                        ("legacy", LegacyVQVAE)):
        tt = VQTrainer(VQVAEConfig(**{**tcfg.__dict__, "family": family}),
                       device="cpu").init_random(0)
        assert type(tt.model) is cls
        vol, mask = map(torch.from_numpy, _batch(8))
        assert torch.isfinite(tt.train_step(vol, mask)["loss"])
    with pytest.raises(ValueError, match="unknown VQ-VAE family"):
        VQTrainer(VQVAEConfig(**{**tcfg.__dict__, "family": "other"}),
                  device="cpu")


def test_flat_metrics_fetch():
    # the trainer's step metrics are 0-dim tensors on its device, as the
    # loop expects
    _, tcfg = _cfgs("rnsvq", 1)
    tt = VQTrainer(tcfg, device="cpu").init_random(0)
    vol, mask = map(torch.from_numpy, _batch(7))
    m = tt.train_step(vol, mask)
    assert all(v.dim() == 0 and not v.requires_grad for v in m.values())


@pytest.mark.parametrize("kind", ["ste", "ema", "ema_sonnet", "nsvq",
                                  "rnsvq"])
def test_stage1_trees_convert_both_ways(kind, tmp_path):
    """A JAX VQTrainer's state of every quantizer kind (params, vq_stats
    with the EMA buffers, need_init and RNSVQ's [S, K, D] codebooks,
    batch_stats) loads into the port strictly, maps back to the same
    flax tree, and goes through the `.npz` export into JAX's
    `load_state_npz` with every key accounted for."""
    from ldm3d.utils import export as jexport
    from ldm3d_torch.convert import flatten, flax_state
    from ldm3d_torch.utils import export
    jcfg, tcfg = _cfgs(kind, 1)
    jtr = JVQTrainer(jcfg, JTrainConfig(batch_size=B, dtype="float32"))
    init = jax.jit(jtr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(2), (B, SIZE, SIZE, SIZE, 1)).compile(
        compiler_options=FAST)
    st = init(jax.random.PRNGKey(2))
    tt = VQTrainer(tcfg, device="cpu")
    tt.model.load_state_dict(_model_state(st), strict=True)
    ref = {c: flatten(_np(getattr(st, c))) for c in
           ("params", "vq_stats", "batch_stats")}
    got = flax_state(tt.model)
    assert got.keys() == ref.keys()
    for c in ref:
        assert got[c].keys() == ref[c].keys(), c
        for k, a in ref[c].items():
            assert got[c][k].dtype == a.dtype, (c, k)
            np.testing.assert_array_equal(got[c][k], a)
    snap = str(tmp_path / "s.npz")
    export.save_state_npz(snap, tt)
    back = jexport.load_state_npz(snap, init(jax.random.PRNGKey(3)))
    # the snapshot is float16: rounding to it moves a value by up to
    # 4.9e-4 of itself, or 3e-8 below float16's smallest normal number
    for c in ref:
        for k, a in flatten(_np(getattr(back, c))).items():
            np.testing.assert_allclose(a, ref[c][k], rtol=1e-3, atol=1e-7)

"""The port's `GANTrainer` against the JAX package's, on the CPU.

From one JAX-initialised state (`TrainConfig(dtype="float32")`), carried
over by `convert.convert_gan_state`, both trainers take one `train_step`:
JAX's runs eagerly, so that its quantizer draws and frame indices can be
recorded and injected into the port. Compared: every metric; the
gradients of each subtree (`ae`, `disc3d`, `disc2d`) through Adam's first
moments; the parameters after both Adams; Adam's step counts; the
critics' BatchNorm statistics and the quantizer's state. Cases: the warm
program, and the adversarial one with the vanilla loss, the WGAN
generator loss, the adaptive weight and R1 (a second-order gradient), and
with the hinge loss, the BCE generator loss and `g_adv_delay`. Then
`eval_step` from the state JAX reached, the state trees both ways, the
warm program against the gated full one, the automatic dispatch, and a
bitwise resume across the warm and the adversarial program.
"""

import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.core.config import DiscriminatorConfig as JDiscriminatorConfig
from ldm3d.core.config import QuantizerConfig as JQuantizerConfig
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.core.config import VQGANConfig as JVQGANConfig
from ldm3d.core.config import VQVAEConfig as JVQVAEConfig
from ldm3d.train.gan_trainer import GANTrainer as JGANTrainer
from ldm3d_torch.convert import convert_gan_state, flatten, gan_flax_state
from ldm3d_torch.core.config import (DiscriminatorConfig, QuantizerConfig,
                                     TrainConfig, VQGANConfig, VQVAEConfig)
from ldm3d_torch.models.quantizers import Draws
from ldm3d_torch.train.checkpoint import CheckpointManager
from ldm3d_torch.train.gan_trainer import GANTrainer
from test_torch_quantizers import recorded

B, SIZE, LR, DISC_LR = 2, 16, 1e-3, 2e-3
# Metrics: float32 means after the autoencoder, the critics and VGG16,
# summed in other orders than XLA: 1e-5 relative; the adaptive weight is
# a ratio of two gradient norms, each such a sum: 1e-4. SSIM 1e-6
# absolute, PSNR 1e-5 relative (tests/test_torch_metrics.py).
METRIC_RTOL, ADAPTIVE_RTOL = 1e-5, 1e-4
# Gradients through Adam's first moment (1 - b1 = 0.5 of the gradient):
# 1e-4 of the subtree's largest moment, absolute, for every element (a
# conv bias before a training-mode BatchNorm has an exact gradient of 0).
MOMENT_RTOL = 1e-4
# Parameter changes after one Adam step (about lr * sign(g)): 1e-3 of the
# rate where |g| is at least 1e-2 of its tensor's largest and 1e-4 of the
# subtree's largest; below, Adam scales float32 noise to a step of any
# sign (see tests/test_torch_vq_trainer.py).
DELTA_SHARE, GRAD_SHARE = 1e-2, 1e-4
# BatchNorm statistics and the EMA quantizer's state after the step.
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


def cfgs(**over):
    """(JAX, port) VQGANConfig: the "attn_cp" autoencoder at widths (4, 8)
    with remat, the EMA quantizer at K=16, D=8, critics (4, 8), critics
    from epoch 1, frames from [4, 12)."""
    q = dict(kind="ema", num_embeddings=16, embedding_dim=8)
    ae = dict(in_channels=2, out_channels=2, num_channels=(4, 8),
              num_res_channels=(4, 8), num_res_layers=1, norm="group",
              act="silu", remat=True)
    kw = dict(disc_threshold=1, frame_idx_range=(4, 12), **over)
    return (JVQGANConfig(ae=JVQVAEConfig(quantizer=JQuantizerConfig(**q),
                                         **ae),
                         disc=JDiscriminatorConfig(num_channels=(4, 8)),
                         **kw),
            VQGANConfig(ae=VQVAEConfig(quantizer=QuantizerConfig(**q), **ae),
                        disc=DiscriminatorConfig(num_channels=(4, 8)), **kw))


def _train_cfgs():
    kw = dict(batch_size=B, learning_rate=LR, disc_learning_rate=DISC_LR,
              adam_b1=0.5, adam_b2=0.9)
    return (JTrainConfig(dtype="float32", **kw),
            TrainConfig(dtype="float32", seed=3, **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _tree(st):
    return {"params": _np(st.params), "batch_stats": _np(st.batch_stats),
            "vq_stats": _np(st.vq_stats)}


@pytest.fixture(scope="module")
def base_state():
    """One JAX init (VGG16 and its calibration included) for every case:
    the options do not change the state's trees."""
    jcfg, _ = cfgs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JGANTrainer(jcfg, _train_cfgs()[0]).init_state(
            jax.random.PRNGKey(0), (B, SIZE, SIZE, SIZE, 2))


def _pair(base_state, epoch=0, **over):
    jcfg, tcfg = cfgs(**over)
    jtc, tc = _train_cfgs()
    jtr = JGANTrainer(jcfg, jtc)
    st = base_state.replace(epoch=jnp.asarray(epoch, jnp.int32))
    tt = GANTrainer(tcfg, tc, device="cpu", volume_size=SIZE)
    tt.model.load_state_dict(convert_gan_state(_tree(st)), strict=True)
    tt.epoch = epoch
    return jtr, st, tt


def _batch(seed):
    rng = np.random.default_rng(seed)
    vol = rng.random((B, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    return vol, (vol > 0.6).astype(np.float32)


def _metrics_close(got, ref):
    assert set(got) == set(ref), (set(got), set(ref))
    for k, v in ref.items():
        if k == "ssim":
            np.testing.assert_allclose(float(got[k]), float(v), atol=1e-6)
            continue
        tol = ADAPTIVE_RTOL if k == "adaptive_weight" else METRIC_RTOL
        np.testing.assert_allclose(float(got[k]), float(v), rtol=tol,
                                   atol=1e-7, err_msg=k)


def _jax_step(jtr, st, vol, mask, monkeypatch):
    with recorded(monkeypatch, "normal", "permutation", "randint") as d, \
            jax.disable_jit():
        st2, jm = jtr.train_step(st, jnp.asarray(vol), jnp.asarray(mask))
    assert len(d["randint"]) == 1
    return st2, jm, Draws(**d)


def _moments(opt_state, prefix):
    inner = opt_state.inner_state[0]
    tree = {"params": {prefix: _np(inner.mu)} if prefix else _np(inner.mu)}
    return convert_gan_state(tree), int(np.asarray(inner.count))


def _check_subtree(opt, moments, new, before, names, lr):
    """Adam's first moments against JAX's, and the parameter changes where
    the gradient is sure."""
    params = [(n, p) for n, p in names if n in moments]
    assert len(params) == len(names)
    scale = max(float(moments[n].abs().max()) for n, _ in params)
    compared = 0
    for n, p in params:
        st = opt.state[p]
        m = st["exp_avg"]
        assert float((m - moments[n]).abs().max()) <= MOMENT_RTOL * scale \
            + 1e-30, n
        g = (st["exp_avg_sq"] / (1 - opt.param_groups[0]["betas"][1])
             ).sqrt()
        g_max = max(float((opt.state[q]["exp_avg_sq"]).sqrt().max())
                    for _, q in params) / np.sqrt(
            1 - opt.param_groups[0]["betas"][1])
        sure = (g >= DELTA_SHARE * g.max()) & (g >= GRAD_SHARE * g_max) \
            & (g > 0)
        if not bool(sure.any()):
            continue
        compared += 1
        d_port = (p.detach() - before[n])[sure]
        d_ref = (new[n] - before[n])[sure]
        assert float((d_port - d_ref).abs().max()) <= 1e-3 * lr, n
    return compared


CASES = {
    "warm": dict(epoch=0),
    "vanilla_wgan_adaptive_r1": dict(epoch=1, adaptive_g_weight=True,
                                     r1_gamma=0.5),
    "hinge_bce_delay": dict(epoch=1, disc_loss_fn="hinge",
                            g_adv_style="bce", g_adv_delay=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, base_state, monkeypatch):
    over = dict(CASES[case])
    epoch = over.pop("epoch")
    jtr, st, tt = _pair(base_state, epoch, **over)
    vol, mask = _batch(1)
    before = {k: t.clone() for k, t in tt.model.state_dict().items()}
    st2, jm, draws = _jax_step(jtr, st, vol, mask, monkeypatch)
    tm = tt.train_step(torch.from_numpy(vol), torch.from_numpy(mask), draws)
    _metrics_close(tm, jm)
    if case == "warm":
        assert float(tm["disc_loss"]) == 0.0
    else:
        assert float(tm["disc_loss"]) > 0.0
    if case == "hinge_bce_delay":     # critics on, generator's terms off
        assert float(tm["gen_loss"]) == 0.0
    if "r1_gamma" in over:
        assert float(tm["r1_penalty"]) > 0.0

    new = convert_gan_state(_tree(st2))
    ae_mu, ae_count = _moments(st2.opt_state, "ae")
    d_mu, d_count = _moments(st2.disc_opt_state, None)
    ae_names = [(f"ae.{n}", p) for n, p in tt.ae.named_parameters()]
    d_names = [(f"disc3d.{n}", p) for n, p in tt.disc3d.named_parameters()] \
        + [(f"disc2d.{n}", p) for n, p in tt.disc2d.named_parameters()]
    n_ae = _check_subtree(tt.optimizer, ae_mu, new, before, ae_names, LR)
    assert n_ae > len(ae_names) // 2
    if case == "warm":
        # zero gradients: the critics stay bit-equal, Adam's count moves
        for n, p in d_names:
            assert torch.equal(p.detach(), before[n]), n
            assert not tt.disc_optimizer.state[p]["exp_avg"].any(), n
    else:
        n_d = _check_subtree(tt.disc_optimizer, d_mu, new, before,
                             d_names, DISC_LR)
        assert n_d > len(d_names) // 2
    for opt, count in ((tt.optimizer, ae_count),
                       (tt.disc_optimizer, d_count)):
        steps = {int(s["step"]) for s in opt.state.values()}
        assert steps == {count} == {1}
    # LPIPS is frozen
    for k, t in tt.lpips.state_dict().items():
        assert torch.equal(t, before[f"lpips.{k}"]), k
    # the critics' statistics and the quantizer's state
    got = tt.model.state_dict()
    moved = 0
    for k, t in new.items():
        if "running" in k or ".quantizer." in k:
            np.testing.assert_allclose(got[k].float().numpy(),
                                       t.float().numpy(), rtol=STATS_RTOL,
                                       atol=STATS_ATOL, err_msg=k)
            moved += "running" in k and not torch.equal(t, before[k])
    assert (moved > 0) == (case != "warm")
    assert tt.step == int(st2.step) == 1


def test_eval_step_matches_jax(base_state, monkeypatch):
    jtr, st, tt = _pair(base_state, 1, adaptive_g_weight=True, r1_gamma=0.5)
    vol, mask = _batch(2)
    st2, _, draws = _jax_step(jtr, st, vol, mask, monkeypatch)
    tt.model.load_state_dict(convert_gan_state(_tree(st2)), strict=True)
    tt.epoch = 1
    key = jax.random.PRNGKey(7)
    with recorded(monkeypatch, "randint") as d, jax.disable_jit():
        jev = jtr.eval_step(st2, jnp.asarray(vol), jnp.asarray(mask), key)
    before = {k: t.clone() for k, t in tt.model.state_dict().items()}
    tev = tt.eval_step(torch.from_numpy(vol), torch.from_numpy(mask),
                       draws=Draws(**d))
    _metrics_close(tev, jev)
    assert {"ssim", "psnr", "r1_penalty", "adaptive_weight"} <= set(tev)
    for k, t in tt.model.state_dict().items():
        assert torch.equal(t, before[k]), k
    assert all(not v.requires_grad for v in tev.values())
    # without injected draws, the frames come from the seed
    a = tt.eval_step(torch.from_numpy(vol), torch.from_numpy(mask), seed=4)
    b = tt.eval_step(torch.from_numpy(vol), torch.from_numpy(mask), seed=4)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_state_trees_convert_both_ways(base_state, tmp_path):
    """Every array of the JAX GAN state (params of all four networks, 2D
    kernels, BatchNorm statistics, the EMA quantizer's vq_stats) loads
    strictly and maps back to the same flax paths and values; a snapshot
    written by the port loads in JAX's `load_state_npz` and back into the
    port."""
    from ldm3d.utils import export as jexport
    from ldm3d_torch.utils import export
    _, st, tt = _pair(base_state)
    ref = {c: flatten(v) for c, v in _tree(st).items()}
    got = gan_flax_state(tt.model)
    assert got.keys() == ref.keys()
    for c in ref:
        assert got[c].keys() == ref[c].keys(), c
        for k, a in ref[c].items():
            assert got[c][k].dtype == a.dtype, (c, k)
            np.testing.assert_array_equal(got[c][k], a)
    # a snapshot in JAX's layout (float32 here), into JAX and a twin
    snap = str(tmp_path / "gan.npz")
    export.save_state_npz(snap, tt, dtype=np.float32)
    back = jexport.load_state_npz(snap, st)
    for c, tree in _tree(back).items():
        for k, a in flatten(tree).items():
            np.testing.assert_array_equal(a, ref[c][k])
    twin = GANTrainer(tt.cfg, tt.train_cfg, device="cpu", volume_size=SIZE)
    export.load_state_npz(snap, twin)
    model, ema = tt.snapshot_modules()
    assert ema is None
    for k, t in twin.model.state_dict().items():
        assert torch.equal(t, model.state_dict()[k]), k


def test_warm_program_matches_the_gated_one(base_state):
    """Before disc_threshold the warm program and the full one (gate 0)
    give the same metrics, autoencoder and both Adams; only the critics'
    BatchNorm statistics differ (the full program's real forwards update
    them)."""
    vol, mask = map(torch.from_numpy, _batch(3))
    runs = []
    for warm in (True, False):
        _, _, tt = _pair(base_state, 0)
        draws = Draws(torch.Generator().manual_seed(5))
        runs.append((tt, tt.train_step(vol, mask, draws, warm=warm)))
    (a, ma), (b, mb) = runs
    for k in ma:
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    stats_differ = 0
    for k in sa:
        if "disc" in k and "running" in k:
            stats_differ += not torch.equal(sa[k], sb[k])
        else:
            torch.testing.assert_close(sa[k], sb[k], rtol=1e-6, atol=1e-7)
    assert stats_differ > 0
    for name in ("optimizer", "disc_optimizer"):
        for p_a, p_b in zip(getattr(a, name).state.values(),
                            getattr(b, name).state.values()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                torch.testing.assert_close(p_a[key], p_b[key], rtol=1e-6,
                                           atol=1e-12)


def test_train_step_dispatches_on_the_epoch(base_state, monkeypatch):
    _, _, tt = _pair(base_state, 0)
    chosen = []
    real = tt._forward_losses

    def spy(*a, warm=False, **kw):
        chosen.append(warm)
        return real(*a, warm=warm, **kw)
    monkeypatch.setattr(tt, "_forward_losses", spy)
    vol, mask = map(torch.from_numpy, _batch(4))
    tt.train_step(vol, mask)
    tt.next_epoch()
    assert tt.epoch == 1
    m = tt.train_step(vol, mask)
    assert chosen == [True, False] and float(m["disc_loss"]) > 0.0


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


def test_resume_is_bitwise(base_state, tmp_path):
    """A warm step, the epoch, an adversarial step with R1 and the
    adaptive weight: straight, and with a save and restore into a fresh
    trainer after the first, equal to the bit (both Adams, the epoch, the
    generator, every BatchNorm and quantizer buffer)."""
    over = dict(adaptive_g_weight=True, r1_gamma=0.5)
    vol, mask = map(torch.from_numpy, _batch(6))

    def first(tt):
        tt.train_step(vol, mask)
        tt.next_epoch()

    _, _, straight = _pair(base_state, 0, **over)
    first(straight)
    straight.train_step(vol, mask)
    _, _, saver = _pair(base_state, 0, **over)
    first(saver)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, saver.state_dict())
    state, _ = ckpt.restore(1)
    fresh = GANTrainer(saver.cfg, saver.train_cfg, device="cpu",
                       volume_size=SIZE)
    fresh.load_state_dict(state)
    assert fresh.epoch == 1 and fresh.step == 1
    fresh.train_step(vol, mask)
    _state_equal(straight, fresh)
    buf = io.BytesIO()
    torch.save(fresh.state_dict(), buf)
    buf.seek(0)
    again = GANTrainer(saver.cfg, saver.train_cfg, device="cpu",
                       volume_size=SIZE)
    again.load_state_dict(torch.load(buf, weights_only=True))
    _state_equal(fresh, again)

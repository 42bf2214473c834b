"""The port's stage-2 training against the JAX package, on the CPU.

Both sides start from one JAX-initialised state of the tiny flagship,
perturbed with seeded numpy noise (so that the zero-initialised layers
carry gradient) and carried over by `ldm3d_torch.convert`. Each case takes
three steps on both sides; the port is fed JAX's own draws of t, noise
and the context-drop mask, re-derived from `state.rng` with the split
sequence of `DiffusionTrainer._build_train_step`.

Before steps 2 and 3 the port is set to JAX's state (weights, BatchNorm
statistics, EMA, Adam moments and step count), so that each of the three
steps is compared from one state: the losses, every U-Net parameter's
change, the BatchNorm running statistics and the EMA, through
`convert.flax_state`. A free-running port (never re-set) is also held to
JAX's losses over the three steps, at a tolerance stated below.

Also here: `diffusion_train_loss`, `auto_latent_scale`, training-mode
BatchNorm against flax, and the attention `autograd.Function`.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.diffusion.ddpm import diffusion_train_loss as j_train_loss
from ldm3d.diffusion.schedule import make_schedule as j_make_schedule
from ldm3d.models.layers import Norm as JNorm
from ldm3d.train.dm_trainer import DiffusionTrainer as JTrainer
from ldm3d.train.state import TrainState
from ldm3d_torch.convert import convert_state, flatten, flax_state
from ldm3d_torch.core.config import TrainConfig, flagship_cfg
from ldm3d_torch.diffusion.ddpm import diffusion_train_loss
from ldm3d_torch.diffusion.schedule import make_schedule
from ldm3d_torch.models.layers import Norm
from ldm3d_torch.ops import attention as tattn
from ldm3d_torch.train.dm_trainer import DiffusionTrainer, auto_latent_scale

B = 2
LR = 1e-3
EMA_DECAY = 0.99
LATENT_SHAPE = (B, 4, 4, 4, 8)
# Losses: means of 1024 squared errors after a U-Net in float32, summed in
# other orders than XLA; 1e-5 relative.
LOSS_RTOL = 1e-5
# Gradients, through Adam's moments after the step: m and sqrt(v) (the RMS
# gradient). float32 sums in other orders than XLA agree to about 1e-5 of
# the U-Net's largest value of each (6e-6 was seen); MOMENT_RTOL of it is
# the absolute tolerance for every element.
MOMENT_RTOL = 2e-5
# Parameter and EMA changes. Adam moves a parameter by about lr whatever
# its gradient's size, so changes are compared with an absolute tolerance
# of 1e-3 * lr (about 4 float32 ulps of a weight of O(1), well above the
# rounding of p + update). Adam divides by sqrt(v_hat), which turns the
# moments' absolute error into a step error that grows as the element's
# gradient shrinks: the changes are compared where sqrt(v_hat) is at least
# DELTA_SHARE of its tensor's largest and above GRAD_FLOOR. Below, the
# gradient is either small next to its tensor's rounding or float32 noise
# of a quantity that is zero in exact arithmetic (the bias of a conv
# followed by training-mode BatchNorm, which removes it), which Adam scales
# up to a step of any sign; those elements are held by the moments only.
DELTA_ATOL = 1e-3 * LR
DELTA_SHARE = 1e-2
GRAD_FLOOR = 1e-6
# BatchNorm running statistics: batch means and variances of U-Net
# activations in float32; 1e-5 relative, 1e-6 absolute.
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
# A port that is never re-set drifts from JAX: the weights whose gradient
# is below GRAD_FLOOR move by different steps of up to lr on the two
# sides, and some of them are not exactly inert (e.g. taps of a k3 conv
# at the 2^3 level). After 3 steps at lr 1e-3 the losses differed by
# 1.8e-4 relative (volume case); 1e-3 relative bounds that drift.
FREE_LOSS_RTOL = 1e-3

CASES = {
    # name: (path, cfg_dropout, prediction_type, loss_reduction, min_snr)
    "volume_eps_mean_drop": ("volume", 0.5, "eps", "mean", None),
    "latents_v_minsnr_ref_drop": ("latents", 0.5, "v", "ref", 5.0),
    "latents_eps_mean_nodrop": ("latents", 0.0, "eps", "mean", None),
}


def _replace(cfg, cfg_dropout, prediction_type, loss_reduction, min_snr):
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, cfg_dropout=cfg_dropout),
        prediction_type=prediction_type, loss_reduction=loss_reduction,
        min_snr_gamma=min_snr)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def base():
    """A perturbed JAX init of the tiny flagship with a null context row
    (cfg_dropout > 0), as numpy trees."""
    cfg = _replace(_flagship_cfg(tiny=True), 0.5, "eps", "mean", None)
    tr = JTrainer(cfg, JTrainConfig(batch_size=B, dtype="float32"))
    st = jax.jit(tr.init_state, static_argnums=1)(jax.random.PRNGKey(0),
                                                  (B, 16, 16, 16, 1))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        _np(st.params))

    def stat(path, a):
        if path[-1].key == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    stats = jax.tree_util.tree_map_with_path(stat, _np(st.batch_stats))
    vq = _np(st.vq_stats)
    return params, stats, vq, np.array(st.rng)


def _draws(rng, shape, p_drop, timesteps):
    """`_build_train_step`'s draws from the state's key."""
    rng, step_rng = jax.random.split(rng)
    t_rng, n_rng, c_rng = jax.random.split(step_rng, 3)
    drop = None
    if p_drop > 0:
        drop = np.array(jax.random.bernoulli(c_rng, p_drop, (shape[0],)))
    t = np.array(jax.random.randint(t_rng, (shape[0],), 0, timesteps))
    noise = np.array(jax.random.normal(n_rng, shape, jnp.float32))
    return rng, t, noise, drop


def _moment(tt, slot):
    """One of Adam's moments in the flax layout (through a copy of the
    U-Net that holds it as its weights)."""
    twin = copy.deepcopy(tt.model.unet)
    with torch.no_grad():
        for p, w in zip(tt.model.unet.parameters(), twin.parameters()):
            w.copy_(tt.optimizer.state[p][slot] if tt.optimizer else 0.0)
    return flax_state(twin, "unet")["params"]


def _snapshot(tt):
    unet = flax_state(tt.model.unet, "unet")
    return dict(params=unet["params"], stats=unet["batch_stats"],
                ema=flax_state(tt.ema_unet, "unet")["params"],
                vqvae=flax_state(tt.model.vqvae, "vqvae")["params"],
                mu=_moment(tt, "exp_avg"), nu=_moment(tt, "exp_avg_sq"))


def _jax_snapshot(st):
    inner = st.opt_state.inner_state[0]
    return dict(params=flatten(_np(st.params["unet"]), "unet"),
                stats=flatten(_np(st.batch_stats["unet"]), "unet"),
                ema=flatten(_np(st.ema_params), "unet"),
                mu=flatten(_np(inner.mu), "unet"),
                nu=flatten(_np(inner.nu), "unet"), count=int(inner.count))


def _set_to(tt, st):
    """Put JAX's state into the port's trainer: weights, statistics, EMA,
    Adam's moments and step count."""
    tree = {"params": _np(st.params), "batch_stats": _np(st.batch_stats),
            "vq_stats": _np(st.vq_stats), "ema_params": _np(st.ema_params)}
    tt.load_state_dicts(*convert_state(tree))
    inner = st.opt_state.inner_state[0]
    mu, _ = convert_state({"params": {"unet": _np(inner.mu)}})
    nu, _ = convert_state({"params": {"unet": _np(inner.nu)}})
    for name, p in tt.model.unet.named_parameters():
        state = tt.optimizer.state[p]
        state["step"].fill_(int(inner.count))
        state["exp_avg"].copy_(mu["unet." + name])
        state["exp_avg_sq"].copy_(nu["unet." + name])
    tt.step = int(st.step)


def _trainer(tcfg, model_state, ema_state):
    tt = DiffusionTrainer(tcfg, device="cpu", train_cfg=TrainConfig(
        dtype="float32", batch_size=B, learning_rate=LR, ema_decay=EMA_DECAY))
    tt.load_state_dicts(model_state, ema_state)
    return tt


def _port_step(tt, path, x, ctx, t, noise, drop):
    fn = tt.train_step if path == "volume" else tt.train_step_latents
    m = fn(torch.from_numpy(x), torch.from_numpy(ctx),
           t=torch.from_numpy(t), noise=torch.from_numpy(noise),
           drop=None if drop is None else torch.from_numpy(drop))
    return {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def runs(base):
    """Three steps of each case: JAX, the port re-set to JAX's state before
    each step (snapshots before and after every step), and a free-running
    port (losses)."""
    out = {}
    for name, (path, p_drop, ptype, red, snr) in CASES.items():
        params, stats, vq, rng = (jax.tree_util.tree_map(np.copy, t)
                                  for t in base)
        if p_drop == 0:        # no null row in the context embedding
            emb = params["unet"]["context_embed"]
            emb["embedding"] = emb["embedding"][:-1]
        jcfg = _replace(_flagship_cfg(tiny=True), p_drop, ptype, red, snr)
        tcfg = _replace(flagship_cfg(tiny=True), p_drop, ptype, red, snr)
        jtr = JTrainer(jcfg, JTrainConfig(batch_size=B, dtype="float32",
                                          ema_decay=EMA_DECAY,
                                          learning_rate=LR))
        ema = jax.tree_util.tree_map(np.copy, params["unet"])
        st = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        vq_stats=vq, batch_stats=stats,
                        opt_state=jtr.tx.init(params["unet"]),
                        rng=jnp.asarray(rng), ema_params=ema)
        start = convert_state({"params": params, "batch_stats": stats,
                               "vq_stats": vq, "ema_params": ema})
        tt, free = _trainer(tcfg, *start), _trainer(tcfg, *start)

        data = np.random.default_rng(1)
        if path == "volume":
            x = data.random((B, 16, 16, 16, 1)).astype(np.float32)
        else:
            x = data.standard_normal(LATENT_SHAPE).astype(np.float32)
        ctx = np.array([1, 0], np.int32)
        steps = {}
        key = jnp.asarray(rng)
        for step in (1, 2, 3):
            key, t, noise, drop = _draws(key, LATENT_SHAPE, p_drop,
                                         jcfg.timesteps)
            if step > 1:
                _set_to(tt, st)
            before = (_jax_snapshot(st), _snapshot(tt))
            fn = jtr.train_step if path == "volume" \
                else jtr.train_step_latents
            st, jm = fn(st, jnp.asarray(x), jnp.asarray(ctx))
            np.testing.assert_array_equal(np.array(st.rng), np.array(key))
            tm = _port_step(tt, path, x, ctx, t, noise, drop)
            fm = _port_step(free, path, x, ctx, t, noise, drop)
            steps[step] = dict(
                before=before, after=(_jax_snapshot(st), _snapshot(tt)),
                jax={k: float(v) for k, v in jm.items()}, port=tm, free=fm)
        out[name] = (steps, tt)
    return out


def _assert_moments(name, ja, ta):
    for slot, f in (("mu", lambda a: a), ("nu", np.sqrt)):
        scale = max(np.abs(f(a)).max() for a in ja[slot].values())
        for key, ref in ja[slot].items():
            err = np.abs(f(ta[slot][key]) - f(ref)).max()
            assert err <= MOMENT_RTOL * scale, (name, slot, key, err, scale)


def _assert_deltas(name, jb, ja, tb, ta, nu, count, lr):
    compared = total = 0
    for key in ja:
        dj = ja[key] - jb[key]
        dt = ta[key] - tb[key]
        g = np.sqrt(nu[key] / (1.0 - 0.999 ** count))
        sure = (g >= DELTA_SHARE * g.max()) & (g >= GRAD_FLOOR)
        err = np.abs(dt - dj)[sure]
        assert err.size == 0 or err.max() <= DELTA_ATOL, \
            (name, key, float(err.max()))
        # Adam's step is at most a few lr anywhere
        assert np.abs(dt).max() <= 3 * lr, (name, key)
        compared += int(sure.sum())
        total += sure.size
    # the comparison covers most weights
    assert compared >= 0.5 * total, (name, compared, total)


@pytest.mark.parametrize("step", [1, 2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches(runs, case, step):
    steps, tt = runs[case]
    rec = steps[step]
    (jb, tb), (ja, ta) = rec["before"], rec["after"]
    for k in ("loss", "noise_mse"):
        np.testing.assert_allclose(rec["port"][k], rec["jax"][k],
                                   rtol=LOSS_RTOL)
    assert ja["params"].keys() == ta["params"].keys()
    assert ja["stats"].keys() == ta["stats"].keys()
    assert ja["count"] == step
    _assert_moments(case, ja, ta)
    _assert_deltas(case, jb["params"], ja["params"], tb["params"],
                   ta["params"], ja["nu"], step, LR)
    # the EMA moves by (1 - d) of the way to the new weights, with the
    # warm-up d = min(decay, (1 + n) / (10 + n))
    _assert_deltas(case, jb["ema"], ja["ema"], tb["ema"], ta["ema"],
                   ja["nu"], step, LR)
    for key in ja["stats"]:
        np.testing.assert_allclose(ta["stats"][key], ja["stats"][key],
                                   rtol=STATS_RTOL, atol=STATS_ATOL,
                                   err_msg=key)
    # the frozen stage-1 does not move, nor does its usage counter
    for key, arr in ta["vqvae"].items():
        np.testing.assert_array_equal(arr, tb["vqvae"][key], err_msg=key)
    assert tt.step == 3
    assert not tt.model.unet.training and not tt.model.vqvae.training


@pytest.mark.parametrize("case", list(CASES))
def test_three_free_running_steps_track_jax(runs, case):
    steps, _ = runs[case]
    for step in (1, 2, 3):
        rec = steps[step]
        for k in ("loss", "noise_mse"):
            np.testing.assert_allclose(rec["free"][k], rec["jax"][k],
                                       rtol=FREE_LOSS_RTOL,
                                       err_msg=f"step {step}")
    # step 1 starts from one state: there the free port is the re-set one
    assert steps[1]["free"] == steps[1]["port"]


def test_trainer_encode_latents_match(base):
    params, stats, vq, _ = base
    jcfg = dataclasses.replace(
        _replace(_flagship_cfg(tiny=True), 0.5, "eps", "mean", None),
        latent_scale=3.0)
    tcfg = dataclasses.replace(
        _replace(flagship_cfg(tiny=True), 0.5, "eps", "mean", None),
        latent_scale=3.0)
    jtr = JTrainer(jcfg, JTrainConfig(batch_size=B, dtype="float32"))
    st = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                    vq_stats=vq, batch_stats=stats, opt_state=None,
                    rng=jax.random.PRNGKey(0))
    images = np.random.default_rng(2).random(
        (B, 16, 16, 16, 1)).astype(np.float32)
    ref = np.asarray(jtr.encode_latents(st, jnp.asarray(images)))
    tt = DiffusionTrainer(tcfg, device="cpu",
                          train_cfg=TrainConfig(dtype="float32"))
    tt.load_state_dicts(*convert_state({"params": params,
                                        "batch_stats": stats,
                                        "vq_stats": vq}))
    out = tt.encode_latents(torch.from_numpy(images))
    assert not out.requires_grad and out.shape == LATENT_SHAPE
    # quantized codes times the scale: equal once the indices agree
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)
    assert tt.model.vqvae.quantizer.codebooks_used.sum() == 0


@pytest.mark.parametrize("scaling", ["reference", "mean"])
def test_diffusion_train_loss_matches(scaling):
    rng = np.random.default_rng(3)
    lat = rng.standard_normal(LATENT_SHAPE).astype(np.float32)
    w = rng.standard_normal(LATENT_SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(4)

    def pred_j(noisy, t):
        return 0.5 * noisy * jnp.asarray(w) + t[:, None, None, None, None]

    ref = float(j_train_loss(j_make_schedule(8), jnp.asarray(lat), pred_j,
                             key, 8, scaling))
    t_rng, n_rng = jax.random.split(key)
    t = np.array(jax.random.randint(t_rng, (B,), 0, 8))
    noise = np.array(jax.random.normal(n_rng, lat.shape, jnp.float32))

    def pred_t(noisy, tt):
        return 0.5 * noisy * torch.from_numpy(w) + tt[:, None, None, None,
                                                      None]

    out = diffusion_train_loss(make_schedule(8), torch.from_numpy(lat),
                               pred_t, torch.from_numpy(t),
                               torch.from_numpy(noise), 8, scaling)
    np.testing.assert_allclose(float(out), ref, rtol=1e-6)


@pytest.mark.parametrize("std,scale,explicit,want", [
    (0.048, 1.0, None, 1 / 0.048),    # raw latents: rescale to unit std
    (0.048, 1.0, 2.0, 1.0),           # a scale was given: keep it
    (0.048, 20.834, None, 20.834),    # the config already has a scale
    (1.03, 1.0, None, 1.0),           # already within 5% of unit std
    (1e-9, 1.0, None, 1.0),           # a dead encoder: no division
])
def test_auto_latent_scale_conditions(std, scale, explicit, want):
    cfg = dataclasses.replace(flagship_cfg(tiny=True), latent_scale=scale,
                              clip_sample_range=1.0)
    new = auto_latent_scale(std, cfg, explicit)
    assert new.latent_scale == pytest.approx(want)
    assert new.clip_sample_range == (0.0 if new is not cfg else 1.0)
    assert new.unet == cfg.unet and new.vqvae == cfg.vqvae
    if new is not cfg:
        assert auto_latent_scale(std, cfg, clip=0.5).clip_sample_range == 0.5


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_flax(training):
    # An offset mean makes a biased and an unbiased variance differ by
    # n / (n - 1) = 54 / 53, far above the 1e-5 tolerance.
    rng = np.random.default_rng(5)
    x = (3.0 + 2.0 * rng.standard_normal((2, 3, 3, 3, 4))).astype(np.float32)
    mod = JNorm("batch", dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    variables = {"params": {"BatchNorm_0": {
        "scale": np.array([1.0, 0.5, 2.0, -1.0], np.float32),
        "bias": np.array([0.0, 0.1, -0.2, 0.3], np.float32)}},
        "batch_stats": {"BatchNorm_0": {
            "mean": np.array([0.5, 1.0, -1.0, 0.0], np.float32),
            "var": np.array([1.0, 2.0, 0.5, 4.0], np.float32)}}}
    assert jax.tree_util.tree_structure(v) == \
        jax.tree_util.tree_structure(variables)
    ref, upd = mod.apply(variables, jnp.asarray(x), training=training,
                         mutable=["batch_stats"])
    norm = Norm("batch", 4).train(training)
    bn = norm.BatchNorm_0
    bn.load_state_dict({
        "weight": torch.tensor([1.0, 0.5, 2.0, -1.0]),
        "bias": torch.tensor([0.0, 0.1, -0.2, 0.3]),
        "running_mean": torch.tensor([0.5, 1.0, -1.0, 0.0]),
        "running_var": torch.tensor([1.0, 2.0, 0.5, 4.0])})
    out = norm(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    new = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"],
                               rtol=1e-6, atol=1e-6)


def _qkv(seed, b=2, n=64, nkv=37, c=64):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .requires_grad_(True)
            for s in ((b, n, c), (b, nkv, c), (b, nkv, c))]


def test_attention_function_gradient_matches_plain_autograd():
    # The Function driven with the plain forward, as the CPU allows: its
    # backward (recomputed through the plain version) against autograd
    # through the plain version itself; the same float32 operations, so
    # to a few ulps.
    q, k, v = _qkv(6)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 64, 64)).astype(np.float32))
    out = tattn.VoxelAttentionFn.apply(q, k, v, 0.125,
                                       tattn._attention_reference)
    grads = torch.autograd.grad(out, (q, k, v), g)
    ref = tattn._attention_reference(q, k, v, 0.125)
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_attention_function_gives_a_forward_without_graph_its_gradient():
    # The fault the Function repairs: the CUDA kernel fills a fresh tensor
    # that autograd knows nothing of, so its output would not require grad
    # and the q/k/v projections would get no gradient from attention.
    q, k, v = _qkv(8)

    def forward_without_graph(q, k, v, scale):
        return tattn._attention_reference(q, k, v, scale).detach()

    assert not forward_without_graph(q, k, v, 0.125).requires_grad
    out = tattn.VoxelAttentionFn.apply(q, k, v, 0.125, forward_without_graph)
    assert out.requires_grad
    out.sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and t.grad.abs().sum() > 0
    # and only the inputs that need one get a gradient
    q2, k2, v2 = _qkv(9)
    k2.requires_grad_(False)
    tattn.VoxelAttentionFn.apply(q2, k2, v2, 0.125,
                                 tattn._attention_reference).sum().backward()
    assert k2.grad is None and q2.grad is not None and v2.grad is not None


@pytest.mark.gpu
def test_attention_gradient_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(8, 64, 512, generator=gen, device="cuda")
               .requires_grad_(True) for _ in range(3))
    g = torch.randn(8, 64, 512, generator=gen, device="cuda")
    tattn.reset_launches()
    out = tattn.voxel_attention(q, k, v)
    assert out.requires_grad and tattn.launches == 1
    grads = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(tattn._attention_reference(q, k, v,
                                                         512 ** -0.5),
                              (q, k, v), g)
    for a, b in zip(grads, ref):
        assert (a - b).abs().max().item() <= 1e-4

"""Data-parallel training of the port over two gloo processes on the CPU
(tests/torch_dist_workers.py), each with two rows of a global batch of
four:

- a VQ-VAE step (STE quantizer, BatchNorm) and a diffusion step on
  latents (BatchNorm, cfg-dropout) against the JAX trainers on
  `make_mesh(MeshConfig(data=2), devices=jax.devices()[:2])`, from one
  state (the port's JAX init, perturbed, carried to JAX by
  `convert.flax_state`) with JAX's draws injected, at the tolerances of
  the single-device trainer tests; then the epoch-end codebook
  replacement, exactly;
- against the port's own one-process step on the global batch: a VQ-VAE
  step with dropout and the NSVQ quantizer (per-row draws from the
  trainer's generator), a diffusion step with loss_reduction "ref" (summed
  gradients), a VQ-GAN step with R1 and the adaptive weight (both
  optimizers' gradients), and two training passes of the EMA quantizers
  (their statistics, restarts and gradients);
- `--train_vq --platform cpu --cpu_devices 2`: process 0's training.log
  equals the one-process log at the same global batch, one checkpoint is
  written, and a checkpoint resumes in one and in two processes as in one;
  `--train_dm --fidelity_freq` scores as in one process; --auto_resume
  over two processes recovers from a failure on process 1 and logs what
  an uninterrupted run logs.

Every rank ends each step with parameters, statistics and codebooks
bitwise equal to the other's.
"""

import copy
import csv
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from __graft_entry__ import _flagship_cfg
from ldm3d.core.config import MeshConfig as JMeshConfig
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.parallel import mesh as jmesh
from ldm3d.train.dm_trainer import DiffusionTrainer as JDiffusionTrainer
from ldm3d.train.state import TrainState
from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
from ldm3d_torch.cli import main as cli
from ldm3d_torch.convert import flatten, flax_state
from ldm3d_torch.core.config import (QuantizerConfig, TrainConfig,
                                     flagship_cfg)
from ldm3d_torch.models.quantizers import Draws, make_quantizer
from ldm3d_torch.train.checkpoint import CheckpointManager
from ldm3d_torch.train.dm_trainer import DiffusionTrainer
from ldm3d_torch.train.gan_trainer import GANTrainer
from ldm3d_torch.train.vq_trainer import VQTrainer
from test_torch_gan_trainer import ADAPTIVE_RTOL, cfgs as gan_cfgs
from test_torch_quantizers import _replacement_draws
from test_torch_samplers import FAST
from test_torch_train import (FREE_LOSS_RTOL, LOSS_RTOL, STATS_ATOL,
                              STATS_RTOL, _assert_deltas, _assert_moments)
from test_torch_train import _draws as dm_draws
from test_torch_vq_trainer import (DELTA_ATOL, DELTA_SHARE, GRAD_SHARE,
                                   METRIC_RTOL)
from test_torch_vq_trainer import MOMENT_RTOL as VQ_MOMENT_RTOL
from test_torch_vq_trainer import _cfgs as vq_cfgs
from test_torch_vq_trainer import _model_state as vq_model_state
from torch_dist_workers import launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

B, LR, EMA_DECAY = 4, 1e-3, 0.99
LATENT_SHAPE = (B, 4, 4, 4, 8)
# one process against two on the same global batch: float32 sums in
# other orders (the gradients' all-reduce, BatchNorm's global moments), so
# the single-device trainer tests' tolerances: metrics 1e-5 relative,
# gradients 1e-4 of the largest of their (sub)tree
REL_TOL, GRAD_RTOL = 1e-5, 1e-4


def _nest(flat):
    """'/'-joined flax paths -> a nested tree."""
    tree = {}
    for path, arr in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _perturb_(module, seed):
    """Seeded noise on every weight and random BatchNorm statistics, so
    that the zero-initialised layers carry gradient
    (tests/test_torch_train.py does the same to the JAX init)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
        for name, b in module.named_buffers():
            if name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))
            elif name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))


def _jax_mesh():
    return jmesh.make_mesh(JMeshConfig(data=2), devices=jax.devices()[:2])


def _put(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, P(jmesh.DATA_AXIS, *([None] * (x.ndim - 1)))))


def _compiled(jitted, *args):
    return jitted.lower(*args).compile(compiler_options=FAST)


def _vq_jax(jm):
    """The STE VQ-VAE case: the port's state, JAX's step, eval and
    replacement on the 2-device mesh."""
    jcfg, tcfg = vq_cfgs("ste", 1)
    tt = VQTrainer(tcfg, TrainConfig(dtype="float32", batch_size=B,
                                     learning_rate=LR),
                   device="cpu").init_random(0)
    _perturb_(tt.model, 1)
    tree = {k: _nest(v) for k, v in flax_state(tt.model).items()}
    jtr = JVQTrainer(jcfg, JTrainConfig(batch_size=B, dtype="float32",
                                        learning_rate=LR), mesh=jm)
    st = TrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                    vq_stats=tree["vq_stats"],
                    batch_stats=tree["batch_stats"],
                    opt_state=jtr.tx.init(tree["params"]),
                    rng=jax.random.PRNGKey(0))
    st = jax.device_put(st, jmesh.replicated(jm))
    rng = np.random.default_rng(2)
    vol = rng.random((B, 16, 16, 16, 1)).astype(np.float32)
    mask = (vol > 0.6).astype(np.float32)
    jv, jmask = _put(jm, vol), _put(jm, mask)
    step = _compiled(jtr._build_train_step(st), st, jv, jmask)
    before = {k: t.clone() for k, t in tt.model.state_dict().items()}
    st2, metrics = step(st, jv, jmask)
    ev = _compiled(jtr._eval_step, st2, jv, jmask)(st2, jv, jmask)
    key = jax.random.PRNGKey(5)
    st3, n_ref = jtr.replace_unused(st2, 2, key)
    usage = np.asarray(st2.vq_stats["quantizer"]["codebooks_used"])
    choice, normal = _replacement_draws(key, usage, 16, (16, 8), 0.5, 2)
    ref = dict(metrics={k: float(v) for k, v in metrics.items()},
               eval={k: float(v) for k, v in ev.items()},
               mu=flatten(_np(st2.opt_state.inner_state[0].mu)),
               nu=flatten(_np(st2.opt_state.inner_state[0].nu)),
               params=flatten(_np(st2.params)),
               stats=flatten(_np({"batch_stats": st2.batch_stats,
                                  "vq_stats": st2.vq_stats})),
               replaced=int(n_ref),
               codebook=np.asarray(st3.params["quantizer"]["codebook"]),
               before=before, twin=tt)
    case = dict(kind="vq", batch=B, cfg=tcfg,
                train=dict(batch_size=B, learning_rate=LR),
                state=before, vol=torch.from_numpy(vol),
                mask=torch.from_numpy(mask), eval_state=vq_model_state(st2),
                replace=dict(choice=[choice], normal=[normal]))
    return case, ref


def _dm_cfgs(p_drop, ptype, reduction, snr):
    def rep(cfg):
        return dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet, cfg_dropout=p_drop),
            prediction_type=ptype, loss_reduction=reduction,
            min_snr_gamma=snr)
    return rep(_flagship_cfg(tiny=True)), rep(flagship_cfg(tiny=True))


def _dm_trainer(tcfg):
    tt = DiffusionTrainer(tcfg, device="cpu", train_cfg=TrainConfig(
        dtype="float32", batch_size=B, learning_rate=LR,
        ema_decay=EMA_DECAY)).init_random(0)
    _perturb_(tt.model.unet, 3)
    return tt


def _dm_case(tcfg, tt, lat, ctx, draws):
    return dict(kind="dm", batch=B, cfg=tcfg,
                train=dict(batch_size=B, learning_rate=LR,
                           ema_decay=EMA_DECAY),
                state={k: t.clone() for k, t in
                       tt.model.state_dict().items()},
                ema={k: t.clone() for k, t in
                     tt.model.unet.state_dict().items()},
                lat=torch.from_numpy(lat), ctx=torch.from_numpy(ctx),
                draws={k: None if v is None else torch.from_numpy(v)
                       for k, v in draws.items()})


def _dm_jax(jm):
    """The diffusion case (eps, mean, cfg_dropout 0.5): the port's
    state, JAX's step on latents on the 2-device mesh."""
    jcfg, tcfg = _dm_cfgs(0.5, "eps", "mean", None)
    tt = _dm_trainer(tcfg)
    tree = {k: _nest(v) for k, v in flax_state(tt.model).items()}
    params = tree["params"]
    jtr = JDiffusionTrainer(jcfg, JTrainConfig(
        batch_size=B, dtype="float32", ema_decay=EMA_DECAY,
        learning_rate=LR), mesh=jm)
    ema = jax.tree_util.tree_map(jnp.copy, params["unet"])
    st = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                    vq_stats=tree["vq_stats"],
                    batch_stats=tree["batch_stats"],
                    opt_state=jtr.tx.init(params["unet"]),
                    rng=jax.random.PRNGKey(4), ema_params=ema)
    st = jax.device_put(st, jmesh.replicated(jm))
    _, t, noise, drop = dm_draws(st.rng, LATENT_SHAPE, 0.5, jcfg.timesteps)
    data = np.random.default_rng(6)
    lat = data.standard_normal(LATENT_SHAPE).astype(np.float32)
    ctx = np.array([1, 0, 1, 1], np.int32)
    unet = flax_state(tt.model.unet, "unet")
    before = dict(params=unet["params"], ema=unet["params"])
    jl, jc = _put(jm, lat), _put(jm, ctx)
    step = _compiled(jtr._build_train_step(st, on_latents=True), st, jl, jc)
    st2, metrics = step(st, jl, jc)
    inner = st2.opt_state.inner_state[0]
    ref = dict(metrics={k: float(v) for k, v in metrics.items()},
               params=flatten(_np(st2.params["unet"]), "unet"),
               stats=flatten(_np(st2.batch_stats["unet"]), "unet"),
               ema=flatten(_np(st2.ema_params), "unet"),
               mu=flatten(_np(inner.mu), "unet"),
               nu=flatten(_np(inner.nu), "unet"), before=before, twin=tt)
    return _dm_case(tcfg, tt, lat, ctx, dict(t=t, noise=noise,
                                             drop=drop)), ref


def _gan_one_process(cfg, train_kw, vol, mask, epoch):
    tr = GANTrainer(cfg, TrainConfig(**{"dtype": "float32", **train_kw}),
                    device="cpu",
                    volume_size=16).init_random(5)
    tr.epoch = epoch
    m = tr.train_step(torch.from_numpy(vol), torch.from_numpy(mask))
    return tr, {k: float(v) for k, v in m.items()}


EMA_KINDS = {"ema": QuantizerConfig(kind="ema", num_embeddings=16,
                                    embedding_dim=8),
             "ema_sonnet": QuantizerConfig(kind="ema_sonnet",
                                           num_embeddings=16,
                                           embedding_dim=8)}


def _quantizer_one_process(cfg, seed, xs):
    q = make_quantizer(cfg)
    q.reset_parameters(torch.Generator().manual_seed(seed))
    q.train()
    gen = torch.Generator().manual_seed(seed + 1)
    steps = []
    for x in xs:
        x = x.clone().requires_grad_(True)
        y, aux = q(x, Draws(gen))
        (y.square().mean() + aux.loss).backward()
        steps.append(dict(y=y.detach(), dx=x.grad,
                          perplexity=float(aux.perplexity),
                          counts=aux.usage_counts.clone(),
                          buffers={k: b.clone()
                                   for k, b in q.named_buffers()}))
    return steps


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case: its one-process reference and both ranks' results
    (one launch of the two workers)."""
    d = tmp_path_factory.mktemp("steps")
    jm = _jax_mesh()
    spec, refs = {}, {}
    spec["vq_jax"], refs["vq_jax"] = _vq_jax(jm)
    spec["dm_jax"], refs["dm_jax"] = _dm_jax(jm)

    # NSVQ with dropout, draws from the trainer's generator
    _, tcfg = vq_cfgs("nsvq", 2, dropout=0.2)
    tt = VQTrainer(tcfg, TrainConfig(dtype="float32", batch_size=B,
                                     learning_rate=LR),
                   device="cpu").init_random(0)
    rng = np.random.default_rng(7)
    vol = rng.random((B, 16, 16, 16, 1)).astype(np.float32)
    mask = (vol > 0.5).astype(np.float32)
    spec["vq_drop"] = dict(kind="vq", batch=B, cfg=tcfg,
                           train=dict(batch_size=B, learning_rate=LR),
                           state={k: t.clone() for k, t in
                                  tt.model.state_dict().items()},
                           vol=torch.from_numpy(vol),
                           mask=torch.from_numpy(mask))
    m = tt.train_step(torch.from_numpy(vol), torch.from_numpy(mask))
    refs["vq_drop"] = dict(metrics={k: float(v) for k, v in m.items()},
                           trainer=tt)

    # loss_reduction "ref": the gradients are summed, not averaged
    _, tcfg = _dm_cfgs(0.5, "v", "ref", 5.0)
    tt = _dm_trainer(tcfg)
    lat = rng.standard_normal(LATENT_SHAPE).astype(np.float32)
    ctx = np.array([0, 1, 1, 0], np.int32)
    draws = dict(t=rng.integers(0, tcfg.timesteps, B),
                 noise=rng.standard_normal(LATENT_SHAPE).astype(np.float32),
                 drop=rng.random(B) < 0.5)
    spec["dm_ref"] = _dm_case(tcfg, tt, lat, ctx, draws)
    m = tt.train_step_latents(
        torch.from_numpy(lat), torch.from_numpy(ctx),
        **{k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()})
    refs["dm_ref"] = dict(metrics={k: float(v) for k, v in m.items()},
                          trainer=tt)

    # the VQ-GAN's adversarial step with R1 and the adaptive weight
    gcfg = gan_cfgs(adaptive_g_weight=True, r1_gamma=1.0)[1]
    train_kw = dict(batch_size=B, learning_rate=LR, disc_learning_rate=2e-3,
                    adam_b1=0.5, adam_b2=0.9, seed=3)
    vol = rng.random((B, 16, 16, 16, 1)).astype(np.float32)
    mask = (vol > 0.5).astype(np.float32)
    spec["gan"] = dict(kind="gan", batch=B, cfg=gcfg, train=train_kw,
                       size=16, seed=5, epoch=1, vol=torch.from_numpy(vol),
                       mask=torch.from_numpy(mask))
    with pytest.warns(UserWarning, match="LPIPS"):
        tr, m = _gan_one_process(gcfg, train_kw, vol, mask, 1)
    refs["gan"] = dict(metrics=m, trainer=tr)

    # the EMA quantizers: 32 rows a pass (the restart draws from all), then
    # 4 rows (fewer than the 16 codes: tiled and jittered)
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((B, 2, 2, 2, 8), (B, 1, 1, 1, 8))]
    for kind, qcfg in EMA_KINDS.items():
        spec[kind] = dict(kind="quantizer", batch=B, cfg=qcfg, seed=9,
                          xs=xs)
        refs[kind] = _quantizer_one_process(qcfg, 9, xs)

    torch.save(spec, d / "steps_in.pt")
    return refs, launch("steps", d, timeout=120)


def _equal_on_both_ranks(ranks, name, key):
    a, b = ranks[0][name][key], ranks[1][name][key]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), (name, key, k)


def _port_flax(tt, state, slot=None):
    """The port's state (or an Adam moment by parameter name) in the flax
    layout of `tt`'s model, through a twin."""
    twin = copy.deepcopy(tt.model)
    if slot is None:
        twin.load_state_dict(state, strict=True)
    else:
        with torch.no_grad():
            for n, p in twin.named_parameters():
                p.copy_(state[n] if n in state else torch.zeros_like(p))
    return twin


def test_vq_step_matches_jax_on_a_two_device_mesh(run):
    refs, ranks = run
    ref, got = refs["vq_jax"], ranks[0]["vq_jax"]
    _equal_on_both_ranks(ranks, "vq_jax", "state")
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=METRIC_RTOL,
                                   err_msg=k)
    # gradients through Adam's first moment, in the flax layout
    tt = ref["twin"]
    mu = flax_state(_port_flax(tt, got["mu"], "mu"))["params"]
    scale = max(np.abs(m).max() for m in ref["mu"].values())
    for path, m in ref["mu"].items():
        assert np.abs(mu[path] - m).max() <= VQ_MOMENT_RTOL * scale, path
    after = flax_state(_port_flax(tt, got["state"]))
    for path, s in ref["stats"].items():
        coll, rest = path.split("/", 1)
        np.testing.assert_allclose(after[coll][rest], s, rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=path)
    # parameter changes where the gradient is clearly above float32 noise
    # (tests/test_torch_vq_trainer.py)
    before = flax_state(_port_flax(tt, ref["before"]))["params"]
    grads = {n: np.sqrt(v / (1.0 - 0.999)) for n, v in ref["nu"].items()}
    g_max = max(g.max() for g in grads.values())
    compared = 0
    for path, p in ref["params"].items():
        g = grads[path]
        sure = (g >= DELTA_SHARE * g.max()) & (g >= GRAD_SHARE * g_max)
        if sure.any():
            compared += 1
            d_port = after["params"][path] - before[path]
            d_ref = p - before[path]
            assert np.abs(d_port - d_ref)[sure].max() <= DELTA_ATOL, path
    assert compared > len(ref["params"]) // 2


def test_vq_eval_and_replacement_match_jax(run):
    """Eval and the epoch-end replacement from the state JAX reached (as
    tests/test_torch_vq_trainer.py)."""
    refs, ranks = run
    ref, got = refs["vq_jax"], ranks[0]["vq_jax"]
    for k, v in ref["eval"].items():
        if k == "ssim":
            np.testing.assert_allclose(got["eval"][k], v, atol=1e-6)
        else:
            np.testing.assert_allclose(got["eval"][k], v, rtol=METRIC_RTOL,
                                       err_msg=k)
    assert ranks[0]["vq_jax"]["replaced"] == ranks[1]["vq_jax"]["replaced"] \
        == ref["replaced"]
    _equal_on_both_ranks(ranks, "vq_jax", "after_replace")
    np.testing.assert_array_equal(
        got["after_replace"]["quantizer.codebook"].numpy(), ref["codebook"])


def test_diffusion_step_matches_jax_on_a_two_device_mesh(run):
    refs, ranks = run
    ref, got = refs["dm_jax"], ranks[0]["dm_jax"]
    for key in ("state", "ema", "mu", "nu"):
        _equal_on_both_ranks(ranks, "dm_jax", key)
    for k in ("loss", "noise_mse"):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    tt = ref["twin"]
    unet = copy.deepcopy(tt.model.unet)

    def flax_of(state, prefix="unet."):
        with torch.no_grad():
            for n, p in unet.named_parameters():
                p.copy_(state[prefix + n] if prefix + n in state else 0.0)
        return flax_state(unet, "unet")["params"]
    ta = dict(mu=flax_of({"unet." + k: v for k, v in got["mu"].items()}),
              nu=flax_of({"unet." + k: v for k, v in got["nu"].items()}))
    _assert_moments("dm_jax", ref, ta)
    ta["params"] = flax_of(got["state"])
    ta["ema"] = flax_of(got["ema"], "")
    b = ref["before"]
    _assert_deltas("dm_jax", b["params"], ref["params"], b["params"],
                   ta["params"], ref["nu"], 1, LR)
    _assert_deltas("dm_jax", b["ema"], ref["ema"], b["ema"], ta["ema"],
                   ref["nu"], 1, LR)
    unet.load_state_dict({k[len("unet."):]: v for k, v in
                          got["state"].items() if k.startswith("unet.")})
    stats = flax_state(unet, "unet")["batch_stats"]
    for path, s in ref["stats"].items():
        np.testing.assert_allclose(stats[path], s, rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=path)


def _close_tree(got, ref, rtol, what):
    """Each tensor within rtol of the tree's largest |value|."""
    scale = max(float(t.double().abs().max()) for t in ref.values()) or 1.0
    for k, t in ref.items():
        err = float((got[k].double() - t.double()).abs().max())
        assert err <= rtol * scale, (what, k, err, scale)


@pytest.mark.parametrize("name", ["vq_drop", "dm_ref"])
def test_step_matches_one_process(run, name):
    """Per-row draws from the trainer's generator (dropout, NSVQ noise),
    and "ref" gradients summed over the processes."""
    refs, ranks = run
    ref, got = refs[name], ranks[0][name]
    _equal_on_both_ranks(ranks, name, "state")
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=REL_TOL,
                                   err_msg=k)
    tr = ref["trainer"]
    model = tr.model if name != "dm_ref" else tr.model.unet
    params = dict(model.named_parameters())
    opt = tr.optimizer
    mu = {n: opt.state[p]["exp_avg"] for n, p in params.items()}
    _close_tree(got["mu"], mu, GRAD_RTOL, name)
    want = tr.model.state_dict()
    stats = {k: t for k, t in want.items() if "running" in k
             or "codebooks_used" in k}
    _close_tree({k: got["state"][k] for k in stats}, stats, REL_TOL, name)


def test_gan_step_matches_one_process(run):
    """Both optimizers' gradients (each network's within 1e-4 of its
    largest), the metrics and the adaptive weight."""
    refs, ranks = run
    ref, got = refs["gan"], ranks[0]["gan"]
    _equal_on_both_ranks(ranks, "gan", "state")
    for k, v in ref["metrics"].items():
        rtol = ADAPTIVE_RTOL if k == "adaptive_weight" else REL_TOL
        np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol,
                                   err_msg=k)
    assert ref["metrics"]["adaptive_weight"] > 0
    assert ref["metrics"]["r1_penalty"] > 0
    grads = {n: p.grad for n, p in ref["trainer"].model.named_parameters()
             if p.grad is not None}
    assert got["grads"].keys() == grads.keys()
    for net in ("ae.", "disc3d.", "disc2d."):
        sub = {n: g for n, g in grads.items() if n.startswith(net)}
        assert sub
        _close_tree(got["grads"], sub, GRAD_RTOL, net)
    want = ref["trainer"].model.state_dict()
    stats = {k: t for k, t in want.items() if "running" in k
             or "ema_" in k or k.endswith("quantizer.codebook")}
    _close_tree({k: got["state"][k] for k in stats}, stats, REL_TOL, "gan")


@pytest.mark.parametrize("kind", list(EMA_KINDS))
def test_ema_quantizer_statistics_match_one_process(run, kind):
    """Usage counts and perplexity of the global batch, the cluster
    statistics, the data-dependent init and the restarts drawn from the
    global rows: equal on both ranks, and to one process. The input
    gradient of the local losses' sum is the one-process gradient of the
    global mean times the number of processes."""
    refs, ranks = run
    for i, ref in enumerate(refs[kind]):
        a, b = ranks[0][kind]["steps"][i], ranks[1][kind]["steps"][i]
        for k in ref["buffers"]:
            assert torch.equal(a["buffers"][k], b["buffers"][k]), (i, k)
        assert torch.equal(a["counts"], ref["counts"]), i
        np.testing.assert_allclose(a["perplexity"], ref["perplexity"],
                                   rtol=REL_TOL)
        _close_tree(a["buffers"], ref["buffers"], REL_TOL, (kind, i))
        got = {"y": torch.cat([a["y"], b["y"]]),
               "dx": torch.cat([a["dx"], b["dx"]]) / 2}
        for k in got:
            _close_tree(got, {k: ref[k]}, REL_TOL, (kind, i, k))


# --------------------------------------------------------------------------
# The command line: --cpu_devices 2
# --------------------------------------------------------------------------


def _log(directory, run="smoke_vq"):
    with open(os.path.join(directory, run, "training.log")) as f:
        return list(csv.DictReader(f))


def _rows_close(got, ref):
    """training.log rows of two runs of the same global batches: after
    the first step the weights differ by Adam's amplification of float32
    noise (a gradient that is exactly 0 in one run, as a conv bias's
    before BatchNorm, is noise in the other and takes a step of up to the
    learning rate), so the free-running tolerance of
    tests/test_torch_train.py. At the smoke preset's rate (1e-4) that
    drift moved the validation SSIM by 2.8e-3 and code choices with it:
    the runs train at 1e-5."""
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref]
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_allclose(float(g[k]), float(r[k]),
                                       rtol=FREE_LOSS_RTOL, atol=1e-7,
                                       err_msg=k)


def test_train_vq_over_two_processes_logs_checkpoints_and_resumes(
        tmp_path, capfd):
    cache = str(tmp_path / "cache")
    # 8 training volumes (2 steps of 4) and 4 held out (one batch)
    common = ["--preset", "smoke", "--platform", "cpu", "--train_vq",
              "--synthetic", "--num_synthetic", "12", "--volume_size", "16",
              "--cache_dir", cache, "--val_perc", "0.34", "--lr", "1e-5"]

    def one(ckpt, *extra):
        cli.main(common + ["--lbs", "4", "--ckpt_dir", str(ckpt), *extra])

    def two(ckpt, *extra):
        """--cpu_devices 2 from this process (it spawns the two);
        both processes' output."""
        capfd.readouterr()
        cli.main(common + ["--lbs", "2", "--cpu_devices", "2",
                           "--ckpt_dir", str(ckpt), *extra])
        return capfd.readouterr().out

    one(tmp_path / "k1", "--epochs", "1")
    shutil.copytree(tmp_path / "k1", tmp_path / "k3")
    one(tmp_path / "k1", "--epochs", "2", "--resume_ckpt", "-1")
    ref = _log(tmp_path / "k1")

    out = two(tmp_path / "k2", "--epochs", "1")
    assert out.count("multi-host: process") == 2
    assert "backend gloo, device cpu" in out
    assert out.count("epoch 1/1") == 1        # process 0 prints
    _rows_close(_log(tmp_path / "k2"), ref[:1])
    assert sorted(os.listdir(tmp_path / "k2")) == ["smoke_vq"]
    assert CheckpointManager(str(tmp_path / "k2" / "smoke_vq")) \
        .all_epochs() == [1]
    # written by two processes, resumed in one
    one(tmp_path / "k2", "--epochs", "2", "--resume_ckpt", "-1")
    _rows_close(_log(tmp_path / "k2"), ref)
    # written by one process, resumed in two
    out = two(tmp_path / "k3", "--epochs", "2", "--resume_ckpt", "-1")
    assert out.count("resumed from epoch 1") == 2
    _rows_close(_log(tmp_path / "k3"), ref)
    assert CheckpointManager(str(tmp_path / "k3" / "smoke_vq")) \
        .all_epochs() == [1, 2]


def test_fidelity_freq_over_two_processes_evaluates_on_every_process(
        tmp_path, capfd):
    """--train_dm --cache_latents --fidelity_freq 1 over two processes:
    the real features are gathered to every process, each samples and
    scores the same (a sharded U-Net would sample with collectives on
    all), and process 0 logs; its training.log row (loss and the fidelity
    metrics) equals the one-process run's at the same global batch."""
    common = ["--preset", "smoke_cond", "--platform", "cpu", "--synthetic",
              "--num_synthetic", "12", "--volume_size", "16", "--val_perc",
              "0.34", "--cache_dir", str(tmp_path / "cache")]
    run = ["--train_dm", "--cache_latents", "--epochs", "1",
           "--fidelity_freq", "1", "--fidelity_samples", "4",
           "--sample_steps", "3"]

    def cmd(*extra):
        """The command from this process (--cpu_devices 2 spawns the
        two); its output, both processes'."""
        capfd.readouterr()
        cli.main(common + list(extra))
        return capfd.readouterr().out

    cmd("--create_dataset")
    cmd(*run, "--lbs", "4", "--ckpt_dir", str(tmp_path / "k1"))
    out = cmd(*run, "--lbs", "2", "--cpu_devices", "2", "--ckpt_dir",
              str(tmp_path / "k2"))
    assert out.count("fidelity: cached 4 real-volume feature rows") == 1
    ref, got = (_log(tmp_path / k, "smoke_cond_dm") for k in ("k1", "k2"))
    assert {"latent_fid", "latent_mmd"} <= set(ref[0])
    _rows_close(got, ref)


@pytest.mark.parametrize("launch_by", ["cpu_devices", "coordinator"])
def test_auto_resume_recovers_over_processes(launch_by, tmp_path,
                                             monkeypatch, capfd):
    """--auto_resume over two processes, launched by --cpu_devices 2 and
    by hand with a coordinator: process 1's plateau schedule fails at the
    end of epoch 2; both processes agree on it, print their recovery,
    restore epoch 1 (process 0's last save) and train epoch 2 again in
    its own order; training.log equals an uninterrupted one-process run's
    at the same global batch."""
    from torch_dist_workers import launch, local_process_failing
    common = ["--preset", "smoke", "--platform", "cpu", "--train_vq",
              "--synthetic", "--num_synthetic", "12", "--volume_size", "16",
              "--cache_dir", str(tmp_path / "cache"), "--val_perc", "0.34",
              "--lr", "1e-5", "--epochs", "2"]
    cli.main(common + ["--lbs", "4", "--ckpt_dir", str(tmp_path / "k1")])
    argv = common + ["--lbs", "2", "--auto_resume", "1", "--ckpt_dir",
                     str(tmp_path / "k2")]
    capfd.readouterr()
    if launch_by == "cpu_devices":
        monkeypatch.setattr(cli, "_local_process", local_process_failing)
        cli.main(argv + ["--cpu_devices", "2"])
        outs = [capfd.readouterr().out]      # both processes' output
    else:
        torch.save({"mesh": {}, "argv": argv, "fail": (1, 1)},
                   tmp_path / "cli_in.pt")
        outs = [r["stdout"] for r in launch("cli", tmp_path, timeout=180)]
    out = "".join(outs)
    assert out.count("recovered from") == 2, out
    assert "recovered from 'RuntimeError: injected fault' (process 1)" in out
    assert "recovered from 'PeerFailure: process [1] failed' (process 0)" \
        in out
    assert out.count("resuming at epoch 1 (restart 1/1)") == 2
    _rows_close(_log(tmp_path / "k2"), _log(tmp_path / "k1"))
    assert CheckpointManager(str(tmp_path / "k2" / "smoke_vq")) \
        .all_epochs() == [1, 2]

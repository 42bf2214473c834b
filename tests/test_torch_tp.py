"""Tensor parallelism of the port (`ldm3d_torch.parallel.tp`) on the CPU,
against one process and against the JAX package.

- The rule: JAX's own cases (tests/test_tensor_parallel.py), and `tp_plan`
  against `ldm3d.parallel.tp.tp_param_shardings` leaf for leaf, through
  `convert`'s flax paths, for every trainable tree (the VQ-VAE, the
  U-Net, the VQ-GAN's autoencoder and both critics) at model 2 and 4:
  a transposed conv is split on its input channels (JAX's last dim of
  flax's (k, k, k, OUT, IN) kernel), a dense layer's bias is split and
  its kernel is not.
- Two gloo processes on a data 1 x model 2 mesh
  (tests/torch_dist_workers.py's `tp` job, one launch for every case):
  a sharded conv, a sharded transposed conv and a gathered vector
  (GroupNorm's scale and offset), forward and backward, against the whole
  op; the VQ step of tests/test_tensor_parallel.py's config (against one
  process, twice, and its loss against the JAX trainer's step on a
  data 1 x model 2 device mesh), the diffusion step with its EMA update
  and a 3-step DDIM `generate` from the EMA U-Net, and the VQ-GAN's
  adversarial step with R1 and the adaptive weight (both optimizers),
  each against the port's one-process step; checkpoints from two
  processes restored in one and from one in two.
- Four processes (`tp` job with other meshes): the VQ step on data 2 x
  model 2, and a conv with a sharded weight over depth slabs on space 2
  x model 2.

Tolerances (as tests/test_torch_multiprocess.py): metrics 1e-5 relative;
gradients and Adam's moments each within 1e-4 of their model's largest
|value|; the processes of a step end bitwise equal on what they both
hold whole. Ops: 1e-6 of the largest value (one conv's float32 sums in
another order, and a partial sum of two).
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ldm3d.core.config import MeshConfig as JMeshConfig
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.parallel import mesh as jmesh
from ldm3d.parallel.tp import tp_param_shardings
from ldm3d.train.dm_trainer import DiffusionTrainer as JDiffusionTrainer
from ldm3d.train.gan_trainer import GANTrainer as JGANTrainer
from ldm3d.train.state import TrainState
from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
from ldm3d_torch.convert import _flax_leaf, flax_state
from ldm3d_torch.core.config import TrainConfig
from ldm3d_torch.models.layers import Conv3d, ConvTranspose3d, Norm
from ldm3d_torch.models.quantizers import make_quantizer
from ldm3d_torch.parallel.tp import MIN_FEATURES, tp_plan
from ldm3d_torch.train.dm_trainer import DiffusionTrainer
from ldm3d_torch.train.gan_trainer import GANTrainer
from ldm3d_torch.train.vq_trainer import VQTrainer
from test_tensor_parallel import _cfg as jtp_vq_cfg
from test_tensor_parallel import _tiny_diff_cfg as jtp_dm_cfg
from test_torch_multiprocess import _nest, _perturb_
from test_torch_samplers import FAST
from test_torch_spatial import _port_cfg
from torch_dist_workers import launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REL_TOL, TREE_RTOL, OP_RTOL = 1e-5, 1e-4, 1e-6
# tests/test_tensor_parallel.py's bounds for a TP loss against another
JAX_RTOL, JAX_ATOL = 2e-5, 2e-6
B, LR = 2, 1e-3


def _jax_gan_cfg(**over):
    """tests/test_tensor_parallel.py's VQ-GAN (its autoencoder and critics
    at widths 32 / 64, the EMA quantizer)."""
    from ldm3d.core.config import (DiscriminatorConfig, QuantizerConfig,
                                   VQGANConfig, VQVAEConfig)
    ae = VQVAEConfig(
        in_channels=2, out_channels=2, num_channels=(32, 64),
        num_res_channels=(32, 64), num_res_layers=1, norm="group",
        act="silu", downsample_stride=(2, 2), downsample_kernel=(4, 4),
        upsample_stride=(2, 2), upsample_kernel=(4, 4),
        quantizer=QuantizerConfig(kind="ema", num_embeddings=16,
                                  embedding_dim=8))
    return VQGANConfig(ae=ae, disc=DiscriminatorConfig(num_channels=(32, 64)),
                       disc_threshold=0, frame_idx_range=(4, 12),
                       lpips_image_size=16, **over)


# --------------------------------------------------------------------------
# The rule
# --------------------------------------------------------------------------


def test_tp_plan_rules():
    """tests/test_tensor_parallel.py's cases at model 4: a conv of 64
    outputs split (kernel and bias), a stem of 8 not, the codebook not;
    JAX's rule on the same tensors in its layout agrees."""
    m = torch.nn.Module()
    m.conv, m.stem = Conv3d(32, 64, 3), Conv3d(2, 8, 3)
    m.quantizer = make_quantizer(_port_cfg(jtp_vq_cfg()).quantizer)
    plan = tp_plan(m, 4)
    assert plan == {"conv.weight": 0, "conv.bias": 0, "stem.weight": None,
                    "stem.bias": None, "quantizer.codebook": None}
    mesh = jmesh.make_mesh(JMeshConfig(data=1, space=1, model=4),
                           devices=jax.devices()[:4])
    tree = {"params": {}}
    for name, mod in m.named_modules():
        for n, t in mod.named_parameters(recurse=False):
            _, leaf, arr = _flax_leaf(mod, n, t)
            tree["params"][f"{name}/{leaf}"] = arr
    sh = tp_param_shardings(tree["params"], mesh)
    assert sh["conv/kernel"].spec == P(None, None, None, None, "model")
    assert sh["conv/bias"].spec == P("model")
    assert sh["stem/kernel"].spec == P() and sh["quantizer/codebook"].spec \
        == P()


def _port_trees():
    """name -> (the port module, its JAX param tree's shapes): each
    trainable tree of the three trainers at the configs of
    tests/test_tensor_parallel.py."""
    key = jax.random.PRNGKey(0)
    shape = (B, 16, 16, 16, 2)
    out = {}
    jvq = JVQTrainer(jtp_vq_cfg(), JTrainConfig(batch_size=B,
                                                dtype="float32"))
    out["vqvae"] = (VQTrainer(_port_cfg(jtp_vq_cfg()), device="cpu").model,
                    jax.eval_shape(lambda k: jvq.model.init(
                        {"params": k, "noise": k, "dropout": k},
                        jnp.zeros(shape), training=False), key)["params"])
    dcfg = jtp_dm_cfg()
    jdm = JDiffusionTrainer(dcfg, JTrainConfig(batch_size=B,
                                               dtype="float32"),
                            conditional=True)
    params = jax.eval_shape(lambda k: jdm.init_state(
        k, (B, 16, 16, 16, 1)), key).params
    out["unet"] = (DiffusionTrainer(_port_cfg(dcfg), device="cpu")
                   .model.unet, params["unet"])
    jgan = JGANTrainer(_jax_gan_cfg(), JTrainConfig(batch_size=B,
                                                    dtype="float32"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gan = GANTrainer(_port_cfg(_jax_gan_cfg()), device="cpu",
                         volume_size=16)
    rngs = {"params": key, "noise": key, "dropout": key}
    vol = jnp.zeros(shape[:-1] + (1,))
    out["gan_ae"] = (gan.ae, jax.eval_shape(lambda: jgan.ae.init(
        rngs, jnp.zeros(shape), training=False))["params"])
    out["disc3d"] = (gan.disc3d, jax.eval_shape(lambda: jgan.disc3d.init(
        rngs, vol, training=False))["params"])
    out["disc2d"] = (gan.disc2d, jax.eval_shape(lambda: jgan.disc2d.init(
        rngs, vol[:, 0], training=False))["params"])
    return out


@pytest.fixture(scope="module")
def trees():
    return _port_trees()


def _flax_paths(module):
    """{port parameter name: its flax path} (`convert.flax_state`'s)."""
    out = {}
    for name, mod in module.named_modules():
        for n, t in mod.named_parameters(recurse=False):
            _, leaf, _ = _flax_leaf(mod, n, t)
            out[f"{name}.{n}" if name else n] = "/".join(
                [p for p in name.split(".") if p] + [leaf])
    return out


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("tree", ["vqvae", "unet", "gan_ae", "disc3d",
                                  "disc2d"])
def test_tp_plan_matches_jax(trees, tree, model):
    module, jparams = trees[tree]
    mesh = jmesh.make_mesh(JMeshConfig(data=1, space=1, model=model),
                           devices=jax.devices()[:model])
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): s.spec
            for path, s in jax.tree_util.tree_leaves_with_path(
                tp_param_shardings(jparams, mesh))}
    paths = _flax_paths(module)
    assert sorted(paths.values()) == sorted(flat)
    plan = tp_plan(module, model)
    split = 0
    for name, dim in plan.items():
        spec = flat[paths[name]]
        if dim is None:
            assert spec == P(), (name, spec)
        else:
            ndim = dict(module.named_parameters())[name].dim()
            assert dim == 0 and spec == (P("model") if ndim == 1 else
                                         P(None, None, None, None, "model")
                                         ), (name, spec)
            split += 1
    assert split, "nothing split"
    if tree in ("vqvae", "gan_ae"):
        # the decoder's transposed convs: split on their 64 inputs, the
        # bias of their 32 outputs whole
        up = [n for n, m in module.named_modules()
              if isinstance(m, ConvTranspose3d) and m.weight.shape[0] >= 64]
        assert up and all(plan[f"{n}.weight"] == 0
                          and plan[f"{n}.bias"] is None for n in up)
    if tree == "unet":
        dense = [n for n, m in module.named_modules()
                 if isinstance(m, torch.nn.Linear)
                 and m.weight.shape[0] >= MIN_FEATURES]
        assert dense and all(plan[f"{n}.bias"] == 0
                             and plan[f"{n}.weight"] is None for n in dense)


# --------------------------------------------------------------------------
# Two processes, data 1 x model 2
# --------------------------------------------------------------------------


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return module


def _op_cases():
    """name -> (module, NCDHW input shape)."""
    return {
        "conv": (Conv3d(32, 64, 3), (2, 32, 4, 5, 6)),
        "convT": (ConvTranspose3d(64, 32, 4, 2), (2, 64, 3, 4, 3)),
        "vector": (Norm("group", 64, num_groups=8), (2, 64, 3, 3, 4)),
    }


def _op_spec(rng, cases, mesh=None):
    spec, refs = {}, {}
    for i, (name, (module, shape)) in enumerate(cases.items()):
        module = _seeded(module, 10 + i)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        with torch.no_grad():
            y = module(x)
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                             .astype(np.float32))
        spec[name] = dict(kind="op", module=module, x=x, g=g)
        if mesh is not None:
            spec[name]["mesh"] = mesh
        m = copy.deepcopy(module)
        xr = x.clone().requires_grad_(True)
        yr = m(xr)
        (yr * g).sum().backward()
        refs[name] = dict(y=yr.detach(), dx=xr.grad,
                          grads={n: p.grad for n, p in m.named_parameters()})
    return spec, refs


def _vq_state():
    """A one-process trainer of tests/test_tensor_parallel.py's VQ-VAE
    from the JAX init's draw, with noise on every weight and random
    BatchNorm statistics."""
    jcfg = jtp_vq_cfg()
    tr = VQTrainer(_port_cfg(jcfg), TrainConfig(dtype="float32", batch_size=B,
                                                learning_rate=LR),
                   device="cpu").init_random(0)
    _perturb_(tr.model, 1)
    return tr


def _vq_batch(seed, b=B):
    rng = np.random.default_rng(seed)
    vol = rng.random((b, 16, 16, 16, 1)).astype(np.float32)
    return torch.from_numpy(vol), torch.from_numpy(
        (vol > 0.6).astype(np.float32))


def _one_step(tr, case):
    """A one-process trainer's step on a case's whole batch: metrics, its
    gradients and state."""
    if case["kind"] == "dm":
        m = tr.train_step_latents(case["lat"], case["ctx"], **case["draws"])
        model = tr.model.unet
    else:
        m = tr.train_step(case["vol"], case["mask"])
        model = tr.model
    return dict(metrics={k: float(v) for k, v in m.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                state=copy.deepcopy(tr.state_dict()))


def _vq_case(batch_seed=2, b=B):
    tr = _vq_state()
    state = copy.deepcopy(tr.state_dict())
    vol, mask = _vq_batch(batch_seed, b)
    case = dict(kind="vq", cfg=tr.cfg,
                train=dict(batch_size=b, learning_rate=LR), state=state,
                vol=vol, mask=mask, again=True)
    ref = _one_step(tr, case)
    ref["again"] = {k: float(v) for k, v in
                    tr.train_step(vol, mask).items()}
    return case, ref


def _jax_tp_vq_loss(state, vol, mask):
    """The JAX trainer's step of the same state and batch on a data 1 x
    model 2 device mesh (GSPMD, conv channels over 'model')."""
    tr = VQTrainer(_port_cfg(jtp_vq_cfg()),
                   TrainConfig(dtype="float32", batch_size=B),
                   device="cpu")
    tr.model.load_state_dict(state["model"])
    tree = {k: _nest(v) for k, v in flax_state(tr.model).items()}
    mesh = jmesh.make_mesh(JMeshConfig(data=1, space=1, model=2),
                           devices=jax.devices()[:2])
    jtr = JVQTrainer(jtp_vq_cfg(), JTrainConfig(
        batch_size=B, dtype="float32", learning_rate=LR), mesh=mesh)
    st = TrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                    vq_stats=tree["vq_stats"],
                    batch_stats=tree["batch_stats"],
                    opt_state=jtr.tx.init(tree["params"]),
                    rng=jax.random.PRNGKey(0))
    st = jax.device_put(st, jtr._state_shardings(st))
    specs = [x.sharding.spec for x in jax.tree_util.tree_leaves(st.params)]
    assert any("model" in str(s) for s in specs)
    jv, jm = jmesh.shard_batch(mesh, (jnp.asarray(vol.numpy()),
                                      jnp.asarray(mask.numpy())))
    step = jtr._build_train_step(st).lower(st, jv, jm).compile(
        compiler_options=FAST)
    _, metrics = step(st, jv, jm)
    return {k: float(v) for k, v in metrics.items()}


def _dm_case():
    """tests/test_tensor_parallel.py's diffusion config (U-Net widths 64 /
    128): a 3-step DDIM `generate` from the EMA U-Net with the decode,
    then the one-process step on latents with injected draws."""
    cfg = _port_cfg(jtp_dm_cfg())
    tr = DiffusionTrainer(cfg, device="cpu", train_cfg=TrainConfig(
        dtype="float32", batch_size=B, learning_rate=LR,
        ema_decay=0.99)).init_random(0)
    _perturb_(tr.model.unet, 3)
    tr._optimizer()                          # Adam and the EMA copy
    state = copy.deepcopy(tr.state_dict())
    rng = np.random.default_rng(6)
    shape = (B, 4, 4, 4, 8)

    def f32(s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    draws = dict(t=torch.tensor([3, 6]), noise=f32(shape), drop=None)
    gen = dict(shape=shape, ctx=torch.tensor([0, 1]), steps=3, eta=0.5,
               init_noise=f32(shape), step_noise=[f32(shape)
                                                  for _ in range(3)])
    case = dict(kind="dm", cfg=cfg, train=dict(batch_size=B,
                                               learning_rate=LR,
                                               ema_decay=0.99),
                state=state, lat=f32(shape), ctx=torch.tensor([1, 0]),
                draws=draws, generate=gen)
    volumes = tr.generate(
        shape, gen["ctx"], init_noise=gen["init_noise"],
        step_noise=gen["step_noise"].__getitem__, sampler="ddim",
        sample_steps=3, eta=0.5, decode=True)
    return case, dict(_one_step(tr, case), volumes=volumes)


def _gan_case():
    """tests/test_tensor_parallel.py's VQ-GAN, adversarial from epoch 0
    with R1 and the adaptive weight (second-order gradients through the
    sharded critics)."""
    cfg = _port_cfg(_jax_gan_cfg(adaptive_g_weight=True, r1_gamma=0.5))
    train = dict(batch_size=B, learning_rate=LR, disc_learning_rate=LR,
                 adam_b1=0.5, adam_b2=0.9, seed=3)
    with pytest.warns(UserWarning, match="LPIPS"):
        tr = GANTrainer(cfg, TrainConfig(**{"dtype": "float32", **train}),
                        device="cpu",
                        volume_size=16).init_random(5)
    state = copy.deepcopy(tr.state_dict())
    vol, mask = _vq_batch(1)
    case = dict(kind="gan", cfg=cfg, train=train, size=16, state=state,
                vol=vol, mask=mask)
    return case, _one_step(tr, case)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case's references and both ranks' results."""
    d = tmp_path_factory.mktemp("tp")
    spec, refs = _op_spec(np.random.default_rng(0), _op_cases())
    spec["vq"], refs["vq"] = _vq_case()
    spec["dm"], refs["dm"] = _dm_case()
    spec["gan"], refs["gan"] = _gan_case()
    # a one-process checkpoint (after a step), resumed over two processes
    spec["from_one"] = dict(spec["vq"], state=refs["vq"]["state"])
    one = VQTrainer(spec["vq"]["cfg"], TrainConfig(
        **{"dtype": "float32", **spec["vq"]["train"]}),
                    device="cpu")
    one.load_state_dict(copy.deepcopy(refs["vq"]["state"]))
    refs["from_one"] = _one_step(one, spec["from_one"])
    torch.save(spec, d / "tp_in.pt")
    return spec, refs, launch("tp", d, timeout=240)


def _close(got, ref, rtol, what):
    scale = float(ref.double().abs().max()) or 1.0
    err = float((got.double() - ref.double()).abs().max())
    assert err <= rtol * scale, (what, err, scale)


def _close_tree(got, ref, rtol, what):
    """Each tensor within rtol of the tree's largest |value|."""
    assert got.keys() == ref.keys(), what
    scale = max(float(t.double().abs().max()) for t in ref.values()) or 1.0
    for k, t in ref.items():
        err = float((got[k].double() - t.double()).abs().max())
        assert err <= rtol * scale, (what, k, err, scale)


def _moments(state, slot):
    return {i: s[slot] for i, s in state["optimizer"]["state"].items()}


def _assert_step(ranks, name, ref, grads=True):
    """Both ranks bitwise equal on the whole state; the metrics, the
    gradients and Adam's moments as one process's; the checkpoint with
    one process's keys and shapes."""
    a, b = ranks[0][name], ranks[1][name]
    assert a["metrics"] == b["metrics"]
    for k in a["state"]["model"]:
        assert torch.equal(a["state"]["model"][k], b["state"]["model"][k]), k
    assert a["sharded"], name
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(a["metrics"][k], v, rtol=REL_TOL,
                                   atol=1e-7, err_msg=(name, k))
    if grads:
        _close_tree(a["grads"], ref["grads"], TREE_RTOL, (name, "grads"))
    want, got = ref["state"], a["state"]
    assert got["model"].keys() == want["model"].keys()
    assert all(got["model"][k].shape == t.shape
               for k, t in want["model"].items())
    for key in [k for k in ("optimizer", "disc_optimizer") if k in want]:
        for slot in ("exp_avg", "exp_avg_sq"):
            _close_tree({str(i): t for i, t in _moments(
                {"optimizer": got[key]}, slot).items()},
                {str(i): t for i, t in _moments(
                    {"optimizer": want[key]}, slot).items()},
                TREE_RTOL, (name, key, slot))


@pytest.mark.parametrize("name", list(_op_cases()))
def test_sharded_op_matches_the_whole_op(run, name):
    """The output and the input's gradient on both ranks are the whole
    op's, and so are the parameters' gradients, gathered whole."""
    _, refs, ranks = run
    ref = refs[name]
    for r in ranks:
        _close(r[name]["y"], ref["y"], OP_RTOL, (name, "y"))
        _close(r[name]["dx"], ref["dx"], OP_RTOL, (name, "dx"))
        for k, g in ref["grads"].items():
            _close(r[name]["grads"][k], g, OP_RTOL, (name, k))
    assert ranks[0][name]["sharded"]


def test_vq_step_matches_one_process_and_jax(run):
    spec, refs, ranks = run
    _assert_step(ranks, "vq", refs["vq"])
    got = ranks[0]["vq"]
    for k, v in refs["vq"]["again"].items():     # a second step
        np.testing.assert_allclose(got["again"][k], v, rtol=REL_TOL,
                                   atol=1e-7, err_msg=k)
    # the wide kernels are split: each rank holds half of down_1's
    local = got["local"]["encoder.down_1.weight"]
    assert local.shape[0] * 2 == got["state"]["model"][
        "encoder.down_1.weight"].shape[0]
    jm = _jax_tp_vq_loss(spec["vq"]["state"], spec["vq"]["vol"],
                         spec["vq"]["mask"])
    np.testing.assert_allclose(got["metrics"]["loss"], jm["loss"],
                               rtol=JAX_RTOL, atol=JAX_ATOL)


def test_diffusion_step_ema_and_generate(run):
    """The step as one process's; the EMA copy (sharded as the U-Net) is
    d * ema + (1 - d) * params of the step's own parameters (d = 0.1 at
    step 0: the parameters themselves differ from one process's by
    Adam's first step on gradients of float32 noise, up to 2 x lr), and
    the sampled volumes from the EMA U-Net are one process's."""
    spec, refs, ranks = run
    _assert_step(ranks, "dm", refs["dm"])
    a, b = ranks[0]["dm"], ranks[1]["dm"]
    for k in a["state"]["ema_unet"]:
        assert torch.equal(a["state"]["ema_unet"][k],
                           b["state"]["ema_unet"][k]), k
    ema0 = spec["dm"]["state"]["ema_unet"]
    for k, e in a["state"]["ema_unet"].items():
        if "running" in k:
            continue
        want = 0.1 * ema0[k] + 0.9 * a["state"]["model"][f"unet.{k}"]
        _close(e, want, REL_TOL, ("ema", k))
    assert torch.equal(a["volumes"], b["volumes"])
    assert a["volumes"].shape == (B, 16, 16, 16, 1)
    _close(a["volumes"], refs["dm"]["volumes"], REL_TOL, "generate")


def test_gan_step_with_both_optimizers(run):
    _, refs, ranks = run
    ref = refs["gan"]
    _assert_step(ranks, "gan", ref)
    got = ranks[0]["gan"]
    assert got["metrics"]["r1_penalty"] > 0
    assert got["metrics"]["adaptive_weight"] > 0
    assert any(k.startswith("disc3d.") for k in got["sharded"])
    assert any(k.startswith("disc2d.") for k in got["sharded"])
    assert not any(k.startswith("lpips.") for k in got["sharded"])


def test_checkpoints_move_between_one_and_two_processes(run):
    """Two processes' checkpoint (whole tensors, one process's keys and
    shapes) restores in one process, which then steps as the two did;
    a one-process checkpoint restored in two steps as one process."""
    spec, refs, ranks = run
    tp_state = ranks[0]["vq"]["state"]
    one = VQTrainer(spec["vq"]["cfg"], TrainConfig(
        **{"dtype": "float32", **spec["vq"]["train"]}),
                    device="cpu")
    one.load_state_dict(copy.deepcopy(tp_state))
    m = one.train_step(spec["vq"]["vol"], spec["vq"]["mask"])
    for k, v in m.items():
        np.testing.assert_allclose(ranks[0]["vq"]["again"][k], float(v),
                                   rtol=REL_TOL, atol=1e-7, err_msg=k)
    _assert_step(ranks, "from_one", refs["from_one"])


# --------------------------------------------------------------------------
# Four processes: data 2 x model 2, space 2 x model 2
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp4")
    spec, refs = _op_spec(np.random.default_rng(1),
                          {"halo_conv": (Conv3d(16, 64, 3),
                                         (2, 16, 4, 4, 8))}, mesh=(1, 2, 2))
    spec["vq"], refs["vq"] = _vq_case(batch_seed=4, b=4)
    spec["vq"]["mesh"] = (2, 1, 2)
    torch.save(spec, d / "tp_in.pt")
    return refs, launch("tp", d, n=4, timeout=240)


def test_vq_step_on_data_2_by_model_2(run4):
    refs, ranks = run4
    for r in ranks[1:]:
        assert r["vq"]["metrics"] == ranks[0]["vq"]["metrics"]
        for k, t in r["vq"]["state"]["model"].items():
            assert torch.equal(t, ranks[0]["vq"]["state"]["model"][k]), k
    _assert_step(ranks, "vq", refs["vq"])


def test_halo_conv_with_a_sharded_weight_on_space_2_by_model_2(run4):
    """Ranks (space, model) = (s, m): each holds depth slab s; the two
    model ranks of a slab agree bitwise; the slabs' outputs and input
    gradients are the whole op's, the weights' gradients summed over
    the slabs."""
    refs, ranks = run4
    ref = refs["halo_conv"]
    got = [r["halo_conv"] for r in ranks]
    for s in (0, 2):
        assert torch.equal(got[s]["y"], got[s + 1]["y"])
    _close(torch.cat([got[0]["y"], got[2]["y"]], 4), ref["y"], OP_RTOL, "y")
    _close(torch.cat([got[0]["dx"], got[2]["dx"]], 4), ref["dx"], OP_RTOL,
           "dx")
    for k, g in ref["grads"].items():
        _close(got[0]["grads"][k] + got[2]["grads"][k], g, OP_RTOL, k)
    assert got[0]["sharded"] == {"weight": 0, "bias": 0}


def test_model_axis_context_is_a_no_op_without_one():
    """`model_sharding` of a mesh without a model axis (or None) leaves
    a module whole; a sharded module outside the context refuses."""
    from ldm3d_torch.parallel import tp
    from ldm3d_torch.parallel.mesh import Mesh
    m = Conv3d(4, 64, 1)
    assert tp.shard_module(m, Mesh({"data": 2, "space": 1, "model": 1}))\
        is m and not tp.sharded_names(m)
    with tp.model_sharding(None):
        assert tp.state() is None
    m._tp = {"weight": 0}
    with pytest.raises(RuntimeError, match="model_sharding"):
        m(torch.zeros(1, 4, 1, 1, 1))

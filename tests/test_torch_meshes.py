"""The JAX package's multi-axis meshes in the port, on the CPU: gloo
processes on (data, space, model) meshes of more than one axis
(tests/torch_dist_workers.py's `meshes` job, each process its rows and
depth slab of every batch), against the port in one process and against
the JAX trainers on the same meshes of the virtual CPU devices.

- Four processes, one launch, two meshes made in this order:
  - data 2 x space 2 (the data x space plane's group reduces gradients,
    metrics and BatchNorm and codebook statistics): a VQ-VAE step with
    BatchNorm and its eval (against one process, and its loss against
    JAX's step on `make_mesh(MeshConfig(data=2, space=2))`);
    `__graft_entry__.dryrun_multichip`'s conditional-LDM step on volumes
    (its tiny config, the frozen stage-1's encode over slabs, injected
    draws, the EMA) and a DDIM `generate` from the EMA U-Net with the
    decode over slabs, against one process; the VQ-GAN's adversarial
    step with R1 and the adaptive weight, against one process.
  - data 1 x space 4 (two slabs with two neighbours each): the TF-'same'
    k3 s1 and k4 s2 convs, the TF-exact transposed k4 s2 conv and a
    SYMMETRIC-pad conv, forward and backward, against the whole op; a
    stage-1 step against one process.
- Eight processes, one launch: data 2 x space 2 x model 2, the mesh of
  `dryrun_multichip` on eight devices, at its config (the tiny model,
  the U-Net widened to (8, 64) so that the model axis splits): the step
  against one process and its loss against JAX's step on the 2 x 2 x 2
  mesh; the parameter bytes per process below one process's (the JAX
  contract's check that the split happens).

Tolerances (tests/test_torch_tp.py's): metrics 1e-5 relative; gradients
and Adam's moments each within 1e-4 of their model's largest |value|;
ops 1e-6 of the largest value (the output) and 1e-4 (the gradients, as
tests/test_torch_spatial.py's ops); the processes end bitwise equal on
what they hold whole.
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ldm3d.core import config as jconfig
from ldm3d.parallel import mesh as jmesh
from ldm3d.train.dm_trainer import DiffusionTrainer as JDiffusionTrainer
from ldm3d.train.state import TrainState
from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
from ldm3d_torch.convert import flax_state
from ldm3d_torch.core.config import TrainConfig
from ldm3d_torch.models.layers import Conv3d, ConvTranspose3d
from ldm3d_torch.models.vqgan import SamePadConv3D
from ldm3d_torch.train.dm_trainer import DiffusionTrainer
from ldm3d_torch.train.gan_trainer import GANTrainer
from ldm3d_torch.train.vq_trainer import VQTrainer
from test_torch_gan_trainer import ADAPTIVE_RTOL
from test_torch_gan_trainer import _train_cfgs as gan_train_cfgs
from test_torch_gan_trainer import cfgs as gan_cfgs
from test_torch_multiprocess import _nest, _perturb_
from test_torch_samplers import FAST
from test_torch_spatial import _op_reference, _port_cfg, _seeded
from test_torch_train import LOSS_RTOL
from test_torch_train import _draws as dm_draws
from test_torch_vq_trainer import _cfgs as vq_cfgs
from torch_dist_workers import launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REL_TOL, TREE_RTOL, OP_RTOL, OP_GRAD_RTOL = 1e-5, 1e-4, 1e-6, 1e-4
# tests/test_tensor_parallel.py's bounds for one JAX loss against another
JAX_RTOL, JAX_ATOL = 2e-5, 2e-6
B, LR, SIZE = 4, 1e-3, 16
PLANE, SPACE4, CUBE = (2, 2, 1), (1, 4, 1), (2, 2, 2)


def _volumes(seed, b=B, channels=1):
    rng = np.random.default_rng(seed)
    vol = rng.random((b, SIZE, SIZE, SIZE, channels)).astype(np.float32)
    return torch.from_numpy(vol), torch.from_numpy(
        (vol > 0.6).astype(np.float32))


def _one_step(tr, case):
    """The port's one-process step of `case` from its state: metrics,
    gradients, state (and a VQ case's eval before the step)."""
    res = {}
    if case["kind"] == "dm":
        m = tr.train_step(case["vol"], case["ctx"], **case["draws"])
        model = tr.model.unet
    else:
        if case["kind"] == "vq":
            res["eval"] = {k: float(v) for k, v in
                           tr.eval_step(case["vol"], case["mask"]).items()}
        m = tr.train_step(case["vol"], case["mask"])
        model = tr.model
    res.update(metrics={k: float(v) for k, v in m.items()},
               grads={n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
               state=copy.deepcopy(tr.state_dict()),
               param_bytes=sum(p.numel() * p.element_size()
                               for p in model.parameters()))
    return res


# --------------------------------------------------------------------------
# The cases
# --------------------------------------------------------------------------


def _op_cases():
    """name -> (module, NCDHW input shape): depth 8 over four 2-row slabs
    (4 of the transposed conv's output)."""
    return {
        "conv_k3": (Conv3d(3, 4, 3), (2, 3, 6, 5, 8)),
        "conv_k4_s2": (Conv3d(3, 4, 4, stride=2), (2, 3, 6, 4, 8)),
        "convT_k4_s2": (ConvTranspose3d(3, 4, 4, 2), (2, 3, 4, 5, 8)),
        "sympad_conv_k3": (SamePadConv3D(3, 4, 3), (2, 3, 6, 5, 8)),
    }


def _op_spec(rng):
    spec, refs = {}, {}
    for i, (name, (module, shape)) in enumerate(_op_cases().items()):
        module = _seeded(module, 30 + i)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        with torch.no_grad():
            y = module.eval()(x)
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                             .astype(np.float32))
        spec[name] = dict(kind="op", module=module, x=x, g=g, axis=4,
                          mesh=SPACE4)
        refs[name] = _op_reference(dict(spec[name], args=(), train=False))
    return spec, refs


def _vq_case(norm, seed, mesh):
    """A VQ-VAE (STE, no random draws) from the port's perturbed init at
    global batch B of 16^3 volumes, and its one-process step."""
    jcfg, tcfg = vq_cfgs("ste", 1, 0.0, norm)
    train = dict(batch_size=B, learning_rate=LR)
    one = VQTrainer(tcfg, TrainConfig(dtype="float32", **train),
                    device="cpu").init_random(seed)
    _perturb_(one.model, seed + 1)
    vol, mask = _volumes(seed + 2)
    case = dict(kind="vq", cfg=tcfg, jcfg=jcfg, train=train, mesh=mesh,
                state=copy.deepcopy(one.state_dict()), vol=vol, mask=mask)
    return case, _one_step(one, case)


def _dryrun_cfg(widths=None):
    """`dryrun_multichip`'s config (JAX's, the port's): the tiny flagship,
    its U-Net widened to `widths` where the model axis must split."""
    jcfg = _flagship_cfg(tiny=True)
    if widths is not None:
        jcfg = jconfig.replace(jcfg, unet=jconfig.replace(
            jcfg.unet, widths=tuple(widths)))
    return jcfg, _port_cfg(jcfg)


def _dm_case(mesh, widths=None, ema_decay=0.0, generate=False, seed=0):
    """`dryrun_multichip`'s conditional-LDM step on volumes at global
    batch B (its 2 x data) from the port's perturbed init, JAX's draws
    of that step injected; the JAX state of the same weights; the
    one-process step; with `generate`, the spec of a 2-step DDIM
    `generate` from the EMA U-Net after the step."""
    jcfg, tcfg = _dryrun_cfg(widths)
    train = dict(batch_size=B, learning_rate=LR, ema_decay=ema_decay)
    one = DiffusionTrainer(tcfg, device="cpu", train_cfg=TrainConfig(
        dtype="float32", **train)).init_random(seed)
    _perturb_(one.model.unet, seed + 3)
    one._optimizer()                         # Adam and the EMA copy
    state = copy.deepcopy(one.state_dict())
    tree = {k: _nest(v) for k, v in flax_state(one.model).items()}
    rng_key = jax.random.PRNGKey(seed + 4)
    lat_shape = (B,) + (tcfg.latent_size,) * 3 + (tcfg.latent_channels,)
    _, t, noise, drop = dm_draws(rng_key, lat_shape, tcfg.unet.cfg_dropout,
                                 tcfg.timesteps)
    vol, _ = _volumes(seed + 5)
    ctx = torch.tensor([1, 0, 0, 1])
    case = dict(kind="dm", cfg=tcfg, train=train, mesh=mesh, state=state,
                vol=vol, ctx=ctx, jcfg=jcfg, tree=tree, rng=rng_key,
                draws=dict(t=torch.from_numpy(t),
                           noise=torch.from_numpy(noise),
                           drop=None if drop is None
                           else torch.from_numpy(drop)))
    ref = {}
    if generate:
        rng = np.random.default_rng(seed + 6)
        shape = (2,) + lat_shape[1:]

        def f32(s):
            return torch.from_numpy(rng.standard_normal(s)
                                    .astype(np.float32))
        case["generate"] = dict(shape=shape, ctx=torch.tensor([0, 1]),
                                steps=2, eta=0.5, init_noise=f32(shape),
                                step_noise=[f32(shape) for _ in range(2)])
    ref.update(_one_step(one, case))
    return case, ref


def _generate(case, state):
    """The case's `generate` in one process from a trainer's state."""
    tr = DiffusionTrainer(case["cfg"], device="cpu", train_cfg=TrainConfig(
        dtype="float32", **case["train"]))
    tr.load_state_dict(copy.deepcopy(state))
    gen = case["generate"]
    return tr.generate(gen["shape"], gen["ctx"],
                       init_noise=gen["init_noise"],
                       step_noise=gen["step_noise"].__getitem__,
                       sampler="ddim", sample_steps=gen["steps"],
                       eta=gen["eta"], decode=True)


def _gan_case(mesh):
    """The VQ-GAN's adversarial step with R1 and the adaptive weight at
    global batch B, its draws (the EMA quantizer's random rows, the frame
    indices) from the trainer's generator in the state."""
    _, tcfg = gan_cfgs(adaptive_g_weight=True, r1_gamma=0.5)
    tc = dataclasses.replace(gan_train_cfgs()[1], batch_size=B)
    with pytest.warns(UserWarning, match="LPIPS"):
        one = GANTrainer(tcfg, tc, device="cpu",
                         volume_size=SIZE).init_random(5)
    vol, mask = _volumes(7, channels=1)
    train = dict(batch_size=B, learning_rate=tc.learning_rate,
                 disc_learning_rate=tc.disc_learning_rate,
                 adam_b1=tc.adam_b1, adam_b2=tc.adam_b2, seed=tc.seed)
    case = dict(kind="gan", cfg=tcfg, train=train, size=SIZE, epoch=1,
                mesh=mesh, state=copy.deepcopy(one.state_dict()), vol=vol,
                mask=mask)
    one.epoch = 1
    return case, _one_step(one, case)


def _worker_case(case):
    """The case without what only the test needs (the JAX side)."""
    return {k: v for k, v in case.items() if k not in ("jcfg", "tree",
                                                       "rng")}


# --------------------------------------------------------------------------
# JAX's steps on the same meshes of the virtual CPU devices
# --------------------------------------------------------------------------


def _jax_mesh(shape):
    data, space, model = shape
    return jmesh.make_mesh(jconfig.MeshConfig(data=data, space=space,
                                              model=model),
                           devices=jax.devices()[:math.prod(shape)])


def _jax_vq_loss(case):
    """JAX's VQ step of the case's state and batch on its mesh (GSPMD:
    rows over 'data', depth over 'space')."""
    tr = VQTrainer(case["cfg"], TrainConfig(dtype="float32", batch_size=B),
                   device="cpu")
    tr.model.load_state_dict(case["state"]["model"])
    tree = {k: _nest(v) for k, v in flax_state(tr.model).items()}
    mesh = _jax_mesh(case["mesh"])
    jtr = JVQTrainer(case["jcfg"], jconfig.TrainConfig(
        batch_size=B, dtype="float32", learning_rate=LR), mesh=mesh)
    st = TrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                    vq_stats=tree["vq_stats"],
                    batch_stats=tree["batch_stats"],
                    opt_state=jtr.tx.init(tree["params"]),
                    rng=jax.random.PRNGKey(0))
    st = jax.device_put(st, jtr._state_shardings(st))
    jv, jm = jmesh.shard_batch(mesh, (jnp.asarray(case["vol"].numpy()),
                                      jnp.asarray(case["mask"].numpy())),
                               spatial_axis=3)
    step = jtr._build_train_step(st).lower(st, jv, jm).compile(
        compiler_options=FAST)
    _, metrics = step(st, jv, jm)
    return {k: float(v) for k, v in metrics.items()}


def _jax_dm_loss(case):
    """JAX's conditional-LDM step (`dryrun_multichip`'s) of the case's
    state, volumes and key on its mesh; asserts that the model axis
    splits the state's kernels where it has one."""
    tree, mesh = case["tree"], _jax_mesh(case["mesh"])
    jtr = JDiffusionTrainer(case["jcfg"], jconfig.TrainConfig(
        batch_size=B, dtype="float32", learning_rate=LR,
        ema_decay=case["train"]["ema_decay"]), mesh=mesh, conditional=True)
    params = tree["params"]
    st = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                    vq_stats=tree.get("vq_stats"),
                    batch_stats=tree.get("batch_stats"),
                    opt_state=jtr.tx.init(params["unet"]), rng=case["rng"],
                    ema_params=None)
    st = jax.device_put(st, jtr._state_shardings(st))
    if case["mesh"][2] > 1:
        specs = [str(x.sharding.spec) for x in
                 jax.tree_util.tree_leaves(st.params["unet"])]
        assert any("model" in s for s in specs)
    jv, jc = jmesh.shard_batch(mesh, (jnp.asarray(case["vol"].numpy()),
                                      jnp.asarray(case["ctx"].numpy(),
                                                  jnp.int32)),
                               spatial_axis=3)
    step = jtr._build_train_step(st).lower(st, jv, jc).compile(
        compiler_options=FAST)
    _, metrics = step(st, jv, jc)
    return {k: float(v) for k, v in metrics.items()}


# --------------------------------------------------------------------------
# The launches
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    """The four-process cases' specs, references and every rank's
    results (the meshes made in the order of the cases: data 2 x space 2,
    then data 1 x space 4)."""
    d = tmp_path_factory.mktemp("meshes4")
    spec, refs = {}, {}
    spec["vq_batchnorm"], refs["vq_batchnorm"] = _vq_case("batch", 0, PLANE)
    spec["dryrun_dm"], refs["dryrun_dm"] = _dm_case(
        PLANE, ema_decay=0.99, generate=True)
    spec["gan"], refs["gan"] = _gan_case(PLANE)
    ops, op_refs = _op_spec(np.random.default_rng(0))
    spec.update(ops)
    refs.update(op_refs)
    spec["vq_space4"], refs["vq_space4"] = _vq_case("group", 3, SPACE4)
    torch.save({k: _worker_case(c) for k, c in spec.items()},
               d / "meshes_in.pt")
    return spec, refs, launch("meshes", d, n=4, timeout=300)


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    """`dryrun_multichip`'s step on data 2 x space 2 x model 2."""
    d = tmp_path_factory.mktemp("meshes8")
    spec, refs = {}, {}
    spec["dryrun_tp"], refs["dryrun_tp"] = _dm_case(CUBE, widths=(8, 64),
                                                    seed=1)
    torch.save({k: _worker_case(c) for k, c in spec.items()},
               d / "meshes_in.pt")
    return spec, refs, launch("meshes", d, n=8, timeout=300, threads=1)


# --------------------------------------------------------------------------
# Checks
# --------------------------------------------------------------------------


def _close(got, ref, rtol, what):
    scale = float(ref.double().abs().max()) or 1.0
    err = float((got.double() - ref.double()).abs().max())
    assert err <= rtol * scale, (what, err / (rtol * scale))


def _close_tree(got, ref, rtol, what):
    """Each tensor within rtol of the tree's largest |value|."""
    assert got.keys() == ref.keys(), what
    scale = max(float(t.double().abs().max()) for t in ref.values()) or 1.0
    for k, t in ref.items():
        err = float((got[k].double() - t.double()).abs().max())
        assert err <= rtol * scale, (what, k, err / (rtol * scale))


def _equal(a, b, what):
    """Two (nested) states bitwise equal."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], (what, k))
    elif torch.is_tensor(a):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def _assert_step(ranks, name, ref, skip=()):
    """The metrics, gradients and Adam's moments as one process's; every
    rank bitwise equal on the whole state, the metrics and the whole
    gradients."""
    got = ranks[0][name]
    for k, v in ref["metrics"].items():
        if k not in skip:
            np.testing.assert_allclose(got["metrics"][k], v, rtol=REL_TOL,
                                       atol=1e-7, err_msg=(name, k))
    _close_tree(got["grads"], ref["grads"], TREE_RTOL, (name, "grads"))
    want, have = ref["state"], got["state"]
    assert have["model"].keys() == want["model"].keys()
    for k, t in want["model"].items():
        assert have["model"][k].shape == t.shape, k
    for key in [k for k in ("optimizer", "disc_optimizer") if k in want]:
        for slot in ("exp_avg", "exp_avg_sq"):
            _close_tree(
                {str(i): s[slot] for i, s in
                 have[key]["state"].items()},
                {str(i): s[slot] for i, s in want[key]["state"].items()},
                TREE_RTOL, (name, key, slot))
    for r in ranks[1:]:
        for key in ("metrics", "grads", "state"):
            _equal(r[name][key], got[key], (name, key))


def test_vq_step_with_batchnorm_on_data_2_by_space_2(run4):
    """BatchNorm's statistics and the gradients over the data x space
    plane: the step and the eval as one process's, the running
    statistics too, and the loss as JAX's step on the same mesh."""
    spec, refs, ranks = run4
    ref, got = refs["vq_batchnorm"], ranks[0]["vq_batchnorm"]
    slabs = [r["vq_batchnorm"]["slab"] for r in ranks]
    assert slabs == [[2, 16, 16, 8, 1]] * 4
    _assert_step(ranks, "vq_batchnorm", ref)
    stats = {k: t for k, t in ref["state"]["model"].items()
             if "running" in k}
    assert stats
    for k, t in stats.items():
        _close(got["state"]["model"][k], t, REL_TOL, k)
    for r in ranks[1:]:
        assert r["vq_batchnorm"]["eval"] == got["eval"]
    for k, v in ref["eval"].items():
        np.testing.assert_allclose(got["eval"][k], v, rtol=REL_TOL,
                                   atol=1e-6, err_msg=k)
    jm = _jax_vq_loss(spec["vq_batchnorm"])
    np.testing.assert_allclose(got["metrics"]["loss"], jm["loss"],
                               rtol=JAX_RTOL, atol=JAX_ATOL)


def test_dryrun_step_ema_and_generate_on_data_2_by_space_2(run4):
    """`dryrun_multichip`'s step on data 2 x space 2 as one process's:
    the frozen stage-1's encode over slabs, the U-Net's BatchNorm over
    the plane, the EMA; the EMA U-Net's DDIM samples, decoded over
    slabs, whole and equal on every rank."""
    spec, refs, ranks = run4
    ref, got = refs["dryrun_dm"], ranks[0]["dryrun_dm"]
    _assert_step(ranks, "dryrun_dm", ref)
    # d * ema + (1 - d) * the step's own parameters, d = 0.1 at step 0
    # (the parameters differ from one process's by Adam's first step on
    # gradients of float32 noise, up to 2 x lr)
    ema0 = spec["dryrun_dm"]["state"]["ema_unet"]
    for k, e in got["state"]["ema_unet"].items():
        own = got["state"]["model"][f"unet.{k}"]
        want = own if "running" in k else 0.1 * ema0[k] + 0.9 * own
        _close(e, want, REL_TOL, ("ema", k))
    for r in ranks[1:]:
        assert torch.equal(r["dryrun_dm"]["volumes"], got["volumes"])
    assert got["volumes"].shape == (2, SIZE, SIZE, SIZE, 1)
    # one process, given the weights the step left
    _close(got["volumes"], _generate(spec["dryrun_dm"], got["state"]),
           REL_TOL, "generate")


def test_gan_step_on_data_2_by_space_2(run4):
    """Both optimizers' gradients, R1 and the adaptive weight (a ratio
    of two gradient norms over the data group: ADAPTIVE_RTOL) as one
    process's."""
    _, refs, ranks = run4
    ref = refs["gan"]
    _assert_step(ranks, "gan", ref, skip=("adaptive_weight",))
    got = ranks[0]["gan"]["metrics"]
    assert got["r1_penalty"] > 0 and ref["metrics"]["adaptive_weight"] > 0
    np.testing.assert_allclose(got["adaptive_weight"],
                               ref["metrics"]["adaptive_weight"],
                               rtol=ADAPTIVE_RTOL)


@pytest.mark.parametrize("name", list(_op_cases()))
def test_halo_op_on_space_4(run4, name):
    """Four 2-row slabs, two of them with a neighbour on each side: the
    slabs' outputs and input gradients are the whole op's, the weights'
    gradients summed over the slabs."""
    _, refs, ranks = run4
    ref = refs[name]
    _close(torch.cat([r[name]["y"] for r in ranks], 4), ref["y"], OP_RTOL,
           (name, "y"))
    _close(torch.cat([r[name]["dx"] for r in ranks], 4), ref["dx"],
           OP_GRAD_RTOL, (name, "dx"))
    for k, g in ref["grads"].items():
        _close(sum(r[name]["grads"][k] for r in ranks), g, OP_GRAD_RTOL,
               (name, k))


def test_stage1_step_on_space_4(run4):
    """A GroupNorm VQ-VAE step over four slabs (4, 2 and 1 rows at its
    three levels) as one process's."""
    _, refs, ranks = run4
    assert [r["vq_space4"]["slab"][3] for r in ranks] == [4] * 4
    _assert_step(ranks, "vq_space4", refs["vq_space4"])


def test_dryrun_step_on_data_2_by_space_2_by_model_2(run8):
    """The JAX contract's mesh: the step as one process's and its loss as
    JAX's on the same 2 x 2 x 2 mesh; each process holds less of the
    U-Net than one process does (the wide kernels split)."""
    spec, refs, ranks = run8
    ref, got = refs["dryrun_tp"], ranks[0]["dryrun_tp"]
    _assert_step(ranks, "dryrun_tp", ref)
    assert all(r["dryrun_tp"]["param_bytes"] < ref["param_bytes"]
               for r in ranks)
    jm = _jax_dm_loss(spec["dryrun_tp"])
    for k in ("loss", "noise_mse"):
        np.testing.assert_allclose(got["metrics"][k], jm[k],
                                   rtol=LOSS_RTOL, err_msg=k)

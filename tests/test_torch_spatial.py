"""Spatial parallelism of the port (`ldm3d_torch.parallel.spatial`) on the
CPU: two gloo processes on a data 1 x space 2 mesh, each holding one depth
slab of every volume (tests/torch_dist_workers.py, one launch for every
case), against the port in one process on the whole volumes and against
the JAX package's single-device trainers.

- The sharding rule: the counterparts of tests/test_spatial.py's
  `shard_spatial` cases, and the halo widths.
- Each sharded op against the unsharded op, forward and gradient: the
  TF-'same' k3 s1 and k4 s2 convs, a k5 conv on one-row slabs (the gather
  rule), the TF-exact transposed k4 s2 conv, the SYMMETRIC-pad convs of
  the VQ-GAN, the space-to-depth stem, avgpool / upsample, GroupNorm,
  BatchNorm, a U-Net whose deepest level runs whole, a rematerialised
  encoder whose backward pass runs on another thread, and the two
  families that run on the gathered volume (the VQ-GAN's "stride"
  autoencoder, the legacy VQ-VAE).
- Trainer steps, each against the one-process step (loss 1e-5 relative,
  each gradient within 1e-4 of its tensor's largest value) and against
  JAX at the single-device trainer tests' tolerances: a VQ-VAE with
  GroupNorm and STE, one with BatchNorm, dropout and NSVQ noise, and the
  diffusion step on latents (`tiny_diffusion_cfg(conditional=True)`,
  then `generate(decode=True)` from the EMA U-Net against one process);
  the VQ-GAN's adversarial step with R1 and the adaptive weight (both
  optimizers' gradients; the EMA quantizer's random rows in global
  order) against the one-process step, which
  tests/test_torch_gan_trainer.py holds to JAX's. The EMA quantizers'
  statistics and restarts on depth slabs. After every step both ranks'
  states are bitwise equal.

The VQ-VAE cases start from JAX's init carried over by
`convert.convert_state`: the same converted tree gives the same step in
one process and over two slabs (spatial sharding splits activations,
not parameters).

Gradient convention: each process's loss is its slab's mean, and the
trainers average over the data x space group, so that the parameters'
gradients are the one-process gradients; an input slab's gradient of the
sum of the processes' losses is `space` times the one-process gradient.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.core import config as jconfig
from ldm3d.train.dm_trainer import DiffusionTrainer as JDiffusionTrainer
from ldm3d.train.state import TrainState
from ldm3d_torch.convert import convert_state, flax_state
from ldm3d_torch.core import config as tconfig
from ldm3d_torch.core.config import TrainConfig
from ldm3d_torch.models.layers import (Conv3d, ConvTranspose3d, Norm,
                                       init_params_, set_compute_dtype)
from ldm3d_torch.models.quantizers import Draws
from ldm3d_torch.models.unet3d import UNet3D
from ldm3d_torch.models.vqgan import (SamePadConv3D, SamePadConvTranspose3D,
                                      VQGANAutoencoder)
from ldm3d_torch.models.vqvae_legacy import LegacyVQVAE
from ldm3d_torch.models.vqvae import Encoder, S2DStemConv
from ldm3d_torch.parallel import spatial
from ldm3d_torch.parallel.halo import _halo_widths, transposed_halo
from ldm3d_torch.parallel.mesh import Mesh
from ldm3d_torch.train.dm_trainer import DiffusionTrainer
from ldm3d_torch.train.gan_trainer import GANTrainer
from ldm3d_torch.train.vq_trainer import VQTrainer
from test_dm_trainer import tiny_diffusion_cfg
from test_torch_gan_trainer import ADAPTIVE_RTOL
from test_torch_gan_trainer import _train_cfgs as gan_train_cfgs
from test_torch_gan_trainer import cfgs as gan_cfgs
from test_torch_multiprocess import EMA_KINDS, _perturb_
from test_torch_quantizers import compiled_with_draws
from test_torch_samplers import FAST
from test_torch_train import LOSS_RTOL
from test_torch_train import MOMENT_RTOL as DM_MOMENT_RTOL
from test_torch_train import _draws as dm_draws
from test_torch_vq_trainer import MOMENT_RTOL as VQ_MOMENT_RTOL
from test_torch_vq_trainer import _cfgs as vq_cfgs
from test_torch_vq_trainer import _metrics_close as vq_metrics_close
from test_torch_vq_trainer import _model_state, _torch_tree
from torch_dist_workers import Apply, First, launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

SPACE = 2
# against one process: the loss 1e-5 relative, every gradient within 1e-4
# of its tensor's largest |value| (float32 sums in other orders: the
# halo'd slabs, the norms' and gradients' all-reduces); outputs of ops and
# of the decode 1e-5 of their largest. A gradient that is zero in exact
# arithmetic (a conv bias before a norm, an attention key's bias, a
# parameter before the encoder's last GroupNorm) is float32 noise: seen
# up to 1.3e-6 of the model's largest gradient (encoder_remat_thread's
# res_1_0.conv2.bias; the VQ-GAN's encoder.down_1.bias 4.5e-7). Such a
# tensor is held to GRAD_FLOOR of the model's largest gradient instead,
# 10x tighter than the single-device tests' moment bound.
REL_TOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-5


def _mesh(rank, data=1, space=SPACE):
    """A mesh position without process groups (the rule needs none)."""
    return Mesh({"data": data, "space": space, "model": 1}, rank=rank)


# --------------------------------------------------------------------------
# The sharding rule (tests/test_spatial.py)
# --------------------------------------------------------------------------


def test_shard_spatial_noop_outside_context():
    x = torch.ones(2, 8, 8, 8, 3)
    assert spatial.shard_spatial(x) is x
    assert spatial.active_mesh() is None and spatial.sharded() is None


def test_shard_spatial_skips_indivisible_shapes():
    with spatial.spatial_sharding(_mesh(0, 2, 4)):
        x = torch.ones(2, 8, 8, 6, 3)      # depth 6 does not split by 4
        assert spatial.shard_spatial(x) is x
        assert not spatial.shards(6) and spatial.shards(8)


def test_shard_spatial_takes_the_depth_slab():
    x = torch.arange(2 * 8 * 3 * 8 * 3.0).reshape(2, 8, 3, 8, 3)
    for r in range(4):
        with spatial.spatial_sharding(_mesh(r, 1, 4)):
            assert torch.equal(spatial.shard_spatial(x),
                               x[:, :, :, 2 * r:2 * r + 2])
            with spatial.whole():      # whole tensors: no slab
                assert spatial.shard_spatial(x) is x


def test_with_spatial_restores_context():
    mesh = _mesh(1)

    def body():
        assert spatial.active_mesh() is mesh
        assert spatial.space_size() == SPACE
        return 1

    assert spatial.with_spatial(mesh, body)() == 1
    assert spatial.active_mesh() is None
    # a space degree of 1 makes the context a no-op
    with spatial.spatial_sharding(_mesh(0, 2, 1)):
        assert spatial.active_mesh() is None


def test_shard_batch_and_loaders_give_each_process_its_slab(tmp_path):
    """On a data 2 x space 2 mesh each process holds its rows and its
    depth slab of every volume (whole contexts and latents): the cache
    and device-data loaders, augmentation included, bit for bit as the
    one-process batch's block; an indivisible depth is refused."""
    from ldm3d_torch.core.config import DataConfig
    from ldm3d_torch.data.pipeline import (DataLoader, DeviceSyntheticLoader,
                                           VolumeCache,
                                           write_synthetic_cache)
    from ldm3d_torch.parallel.mesh import local_depth, shard_batch
    x = torch.arange(4 * 2 * 2 * 8 * 1.0).reshape(4, 2, 2, 8, 1)
    for r in range(4):
        mesh = _mesh(r, 2, 2)
        rows, depth = slice(2 * (r // 2), 2 * (r // 2) + 2), \
            slice(4 * (r % 2), 4 * (r % 2) + 4)
        vol, ctx = shard_batch(mesh, (x, torch.arange(4)), spatial_axis=3)
        assert torch.equal(vol, x[rows, :, :, depth])
        assert torch.equal(ctx, torch.arange(4)[rows])
    with pytest.raises(ValueError, match="not divisible"):
        local_depth(_mesh(0, 1, 2), 7)
    cfg = DataConfig(volume_size=16, augment=True, augment_fraction=1.0)
    write_synthetic_cache(str(tmp_path), 8, 16, seed=3, device="cpu")
    cache = VolumeCache(str(tmp_path))
    for make in (lambda m: DataLoader(cache, 4, cfg, seed=1, device="cpu",
                                      mesh=m),
                 lambda m: DeviceSyntheticLoader(8, 4, cfg, corpus_seed=3,
                                                 seed=1, device="cpu",
                                                 mesh=m)):
        whole = list(make(None))
        for r in range(4):
            mesh = _mesh(r, 2, 2)
            for ref, got in zip(whole, make(mesh)):
                want = shard_batch(mesh, ref, spatial_axis=3)
                assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_halo_widths_and_fit():
    assert _halo_widths(3, 1) == (1, 1) and _halo_widths(4, 2) == (1, 1)
    assert _halo_widths(3, 2) == (0, 1) and _halo_widths(1, 1) == (0, 0)
    # the transposed k4 s2 conv needs a row of each neighbour, and its
    # slab starts 3 rows into the padded slab's full output
    assert transposed_halo(4, 2) == (1, 1, 3)
    assert spatial.fits(1, 1, 1) and not spatial.fits(1, 2, 2)
    assert not spatial.fits(3, 1, 1, 2) and spatial.fits(4, 1, 1, 2)


# --------------------------------------------------------------------------
# One launch of the two processes for every case
# --------------------------------------------------------------------------


def _seeded(module, seed):
    init_params_(module, torch.Generator().manual_seed(seed))
    _perturb_(module, seed + 1)
    return module


def _op_cases():
    """name -> (module, NCDHW input shape or the U-Net's, depth axis)."""
    # BatchNorm (eval: the running statistics): a GroupNorm over the
    # deepest level's single voxel would divide float32 noise by sqrt(eps)
    unet_cfg = tconfig.UNetConfig(widths=(4, 8, 16), num_res_blocks=1,
                                  has_attention=(False, True, True),
                                  first_conv_channels=4, norm="batch")
    quantizer = tconfig.QuantizerConfig(kind="ste", num_embeddings=16,
                                        embedding_dim=8)
    return {
        "conv_k3": (Conv3d(3, 4, 3), (2, 3, 6, 5, 8)),
        "conv_k4_s2": (Conv3d(3, 4, 4, stride=2), (2, 3, 6, 4, 8)),
        "conv_k5_gathered": (Conv3d(3, 4, 5), (2, 3, 6, 5, 2)),
        "convT_k4_s2": (ConvTranspose3d(3, 4, 4, 2), (2, 3, 4, 5, 4)),
        "sympad_conv_k3": (SamePadConv3D(3, 4, 3), (2, 3, 6, 5, 8)),
        "sympad_conv_k4_s2": (SamePadConv3D(3, 4, 4, 2), (2, 3, 6, 4, 8)),
        "sympad_convT_k4_s2": (SamePadConvTranspose3D(3, 4), (2, 3, 4, 4, 4)),
        "s2d_stem": (S2DStemConv(3, 4), (2, 3, 4, 6, 8)),
        "avgpool": (Apply("avgpool3d"), (2, 3, 4, 6, 8)),
        "upsample": (Apply("upsample3d"), (2, 3, 4, 6, 4)),
        "groupnorm": (Norm("group", 8, num_groups=4), (2, 8, 3, 5, 8)),
        "batchnorm": (Norm("batch", 3), (2, 3, 3, 5, 8)),
        # levels of depth 4, 2, 1: the deepest runs whole; attention over
        # 2-row slabs (local queries, gathered keys) and whole
        "unet_whole_level": (UNet3D(unet_cfg, out_channels=2, in_channels=2,
                                    latent_size=4), (2, 4, 4, 4, 2)),
        # remat: the units recomputed in a backward pass run on a thread
        # of its own, under the forward pass's sharding
        "encoder_remat_thread": (Encoder(tconfig.VQVAEConfig(
            in_channels=1, num_channels=(4, 8), num_res_channels=(4, 8),
            num_res_layers=1, downsample_stride=(2, 2),
            downsample_kernel=(4, 4), norm="group", remat=True,
            quantizer=quantizer)),
            (2, 1, 4, 6, 8)),
        # the families JAX does not shard run on the gathered volume
        "vqgan_stride_whole": (First(VQGANAutoencoder(tconfig.VQVAEConfig(
            arch="stride", in_channels=1, out_channels=1,
            num_channels=(4, 8), num_res_channels=(4, 8),
            num_res_layers=1, norm="group", quantizer=quantizer))),
            (2, 8, 8, 8, 1)),
        "legacy_whole": (First(LegacyVQVAE(latent_dim=8, num_embeddings=16,
                                           down=2)), (2, 8, 8, 8, 1)),
    }


# bfloat16 activations over depth slabs (`set_compute_dtype`): the halo
# exchange and the gathers move bfloat16 exactly, but a slab's conv is
# another convolution call than the whole volume's (its own blocking and
# accumulation order), so outputs and input gradients may differ by a
# bfloat16 ulp of the largest value: BF16_RTOL = 2^-7 of it; the weights'
# gradients, sums over the slabs, to 1e-2 of the largest.
BF16_RTOL, BF16_GRAD_RTOL = 2.0 ** -7, 1e-2


def _bf16_op_cases():
    return {
        "bf16_conv_k3": (Conv3d(3, 4, 3), (2, 3, 6, 5, 8)),
        "bf16_convT_k4_s2": (ConvTranspose3d(3, 4, 4, 2), (2, 3, 4, 5, 4)),
        "bf16_groupnorm": (Norm("group", 8, num_groups=4), (2, 8, 3, 5, 8)),
    }


def _op_spec(rng):
    spec = {}
    cases = {**_op_cases(), **_bf16_op_cases()}
    for i, (name, (module, shape)) in enumerate(cases.items()):
        module = _seeded(module, 10 + i)
        if name.startswith("bf16_"):
            set_compute_dtype(module, torch.bfloat16)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        unet = isinstance(module, UNet3D)
        args = (torch.tensor([3, 1]),) if unet else ()
        ndhwc = unet or isinstance(module, First)
        with torch.no_grad():
            y = module.eval()(x, *args)
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                             .astype(np.float32))
        spec[name] = dict(kind="op", module=module, x=x, g=g, args=args,
                          axis=3 if ndhwc else 4, train=name == "batchnorm",
                          thread=name.endswith("thread"))
    return spec


def _op_reference(case):
    m = copy.deepcopy(case["module"]).train(case["train"])
    x = case["x"].clone().requires_grad_(True)
    y = m(x, *case["args"])
    (y * case["g"]).sum().backward()
    return dict(y=y.detach(), dx=x.grad,
                grads={n: p.grad for n, p in m.named_parameters()
                       if p.grad is not None},
                buffers=dict(m.named_buffers()))


def _port_cfg(cfg):
    """The port's config of a JAX config dataclass: the fields the port
    has (it has no field of a choice it does not offer)."""
    if dataclasses.is_dataclass(cfg):
        cls = getattr(tconfig, type(cfg).__name__)
        return cls(**{f.name: _port_cfg(getattr(cfg, f.name))
                      for f in dataclasses.fields(cls)})
    return cfg


VQ_B = 2


def _vq_case(kind, channels, dropout, norm, seed):
    """A JAX-initialised VQ-VAE, JAX's compiled step with its draws
    recorded, the port's one-process step with them injected, and the
    spec of the same step over two processes."""
    from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
    jcfg, tcfg = vq_cfgs(kind, channels, dropout, norm)
    jtr = JVQTrainer(jcfg, jconfig.TrainConfig(batch_size=VQ_B,
                                               dtype="float32",
                                               learning_rate=1e-3))
    shape = (VQ_B, 16, 16, 16, channels)
    st = jax.jit(jtr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(seed), shape).compile(compiler_options=FAST)(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    vol = rng.random(shape[:4] + (1,)).astype(np.float32)
    mask = (vol > 0.6).astype(np.float32)
    (st2, jm), d = compiled_with_draws(
        jtr._build_train_step(st).__wrapped__,
        (st, jnp.asarray(vol), jnp.asarray(mask)), "normal", "bernoulli")
    draws = {k: list(v) for k, v in d.items() if v}
    train = dict(batch_size=VQ_B, learning_rate=1e-3)
    state = _model_state(st)
    one = VQTrainer(tcfg, TrainConfig(**{"dtype": "float32", **train}),
                    device="cpu")
    one.model.load_state_dict(state, strict=True)
    # eval from the shared state (after a step the states differ by Adam's
    # steps on float32 noise)
    ev = one.eval_step(torch.from_numpy(vol), torch.from_numpy(mask))
    om = one.train_step(torch.from_numpy(vol), torch.from_numpy(mask),
                        Draws(**copy.deepcopy(draws)))
    ref = dict(one=dict(metrics={k: float(v) for k, v in om.items()},
                        grads={n: p.grad for n, p in
                               one.model.named_parameters()},
                        eval={k: float(v) for k, v in ev.items()}),
               jax=dict(metrics=jm, mu=_torch_tree(
                   st2.opt_state.inner_state[0].mu)))
    spec = dict(kind="vq", cfg=tcfg, train=train, state=state,
                vol=torch.from_numpy(vol), mask=torch.from_numpy(mask),
                draws=draws)
    return spec, ref


DM_B = 2


def _dm_case():
    """The tiny conditional diffusion step on latents from the port's
    perturbed init (carried to JAX), JAX's single-device step with its
    draws, the one-process step, and the EMA U-Net's decoded DDIM
    samples."""
    jcfg = tiny_diffusion_cfg(conditional=True)
    tcfg = _port_cfg(jcfg)
    train = dict(batch_size=DM_B, learning_rate=1e-3, ema_decay=0.99)
    one = DiffusionTrainer(tcfg, device="cpu",
                           train_cfg=TrainConfig(
                               **{"dtype": "float32", **train})
                           ).init_random(0)
    _perturb_(one.model.unet, 3)
    state = {k: t.clone() for k, t in one.model.state_dict().items()}
    tree = flax_state(one.model)
    nest = {}
    for coll, flat in tree.items():
        for path, arr in flat.items():
            node = nest.setdefault(coll, {})
            *parents, leaf = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(arr)
    jtr = JDiffusionTrainer(jcfg, jconfig.TrainConfig(
        batch_size=DM_B, dtype="float32", learning_rate=1e-3,
        ema_decay=0.99))
    params = nest["params"]
    st = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                    vq_stats=nest["vq_stats"],
                    batch_stats=nest["batch_stats"],
                    opt_state=jtr.tx.init(params["unet"]),
                    rng=jax.random.PRNGKey(4),
                    ema_params=jax.tree_util.tree_map(jnp.copy,
                                                      params["unet"]))
    shape = (DM_B, 4, 4, 4, 8)
    _, t, noise, drop = dm_draws(st.rng, shape, tcfg.unet.cfg_dropout,
                                 jcfg.timesteps)
    rng = np.random.default_rng(6)
    lat = rng.standard_normal(shape).astype(np.float32)
    ctx = np.array([1, 0], np.int32)
    step = jtr._build_train_step(st, on_latents=True).lower(
        st, jnp.asarray(lat), jnp.asarray(ctx)).compile(
        compiler_options=FAST)
    st2, jm = step(st, jnp.asarray(lat), jnp.asarray(ctx))
    step_draws = dict(t=torch.from_numpy(t), noise=torch.from_numpy(noise),
                      drop=None if drop is None else torch.from_numpy(drop))
    om = one.train_step_latents(torch.from_numpy(lat), torch.from_numpy(ctx),
                                **step_draws)
    gen = dict(shape=shape, ctx=torch.tensor([0, 1]), steps=2, eta=0.5,
               init_noise=torch.from_numpy(rng.standard_normal(shape)
                                           .astype(np.float32)),
               step_noise=[torch.from_numpy(rng.standard_normal(shape)
                                            .astype(np.float32))
                           for _ in range(2)])
    vols = one.generate(gen["shape"], gen["ctx"],
                        init_noise=gen["init_noise"],
                        step_noise=gen["step_noise"].__getitem__,
                        sampler="ddim", sample_steps=gen["steps"],
                        eta=gen["eta"], decode=True)
    mu = convert_state({"params": {"unet": jax.tree_util.tree_map(
        np.array, jax.device_get(st2.opt_state.inner_state[0].mu))}})[0]
    ref = dict(one=dict(metrics={k: float(v) for k, v in om.items()},
                        grads={n: p.grad for n, p in
                               one.model.unet.named_parameters()},
                        volumes=vols),
               jax=dict(metrics={k: float(v) for k, v in jm.items()},
                        mu=mu))
    spec = dict(kind="dm", cfg=tcfg, train=train, state=state,
                ema={k[len("unet."):]: v for k, v in state.items()
                     if k.startswith("unet.")},
                lat=torch.from_numpy(lat), ctx=torch.from_numpy(ctx),
                step_draws=step_draws, generate=gen)
    return spec, ref


def _dm_bf16_case(dm):
    """The diffusion case's step in bfloat16 (the JAX default dtype), and
    the one-process bfloat16 step it is held to."""
    spec = dict(dm, train={**dm["train"], "dtype": "bfloat16"})
    one = DiffusionTrainer(spec["cfg"], device="cpu",
                           train_cfg=TrainConfig(**spec["train"]))
    one.load_state_dicts(spec["state"], spec["ema"])
    om = one.train_step_latents(spec["lat"], spec["ctx"],
                                **spec["step_draws"])
    return spec, dict(metrics={k: float(v) for k, v in om.items()},
                      grads={n: p.grad for n, p in
                             one.model.unet.named_parameters()})


def _gan_case():
    """The VQ-GAN's adversarial step with R1 and the adaptive weight in one
    process, its draws (the EMA quantizer's random rows, the frame
    indices) from the trainer's generator, as the two processes draw
    them. (tests/test_torch_gan_trainer.py holds this one-process step to
    JAX's.)"""
    _, tcfg = gan_cfgs(adaptive_g_weight=True, r1_gamma=0.5)
    _, tc = gan_train_cfgs()
    with pytest.warns(UserWarning, match="LPIPS"):
        one = GANTrainer(tcfg, tc, device="cpu",
                         volume_size=16).init_random(5)
    state = {k: t.clone() for k, t in one.model.state_dict().items()}
    rng = np.random.default_rng(1)
    vol = rng.random((2, 16, 16, 16, 1)).astype(np.float32)
    mask = (vol > 0.6).astype(np.float32)
    one.epoch = 1
    om = one.train_step(torch.from_numpy(vol), torch.from_numpy(mask))
    ref = dict(one=dict(metrics={k: float(v) for k, v in om.items()},
                        grads={n: p.grad for n, p in
                               one.model.named_parameters()
                               if p.grad is not None}))
    train = dict(batch_size=tc.batch_size, learning_rate=tc.learning_rate,
                 disc_learning_rate=tc.disc_learning_rate,
                 adam_b1=tc.adam_b1, adam_b2=tc.adam_b2, seed=tc.seed)
    spec = dict(kind="gan", cfg=tcfg, train=train, size=16, epoch=1,
                state=state, vol=torch.from_numpy(vol),
                mask=torch.from_numpy(mask))
    return spec, ref


def _quantizer_reference(cfg, seed, xs):
    from ldm3d_torch.models.quantizers import make_quantizer
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
    """Every case's references and both ranks' results."""
    d = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(0)
    spec = _op_spec(rng)
    refs = {name: _op_reference(case) for name, case in spec.items()}
    spec["vq_group_ste"], refs["vq_group_ste"] = _vq_case(
        "ste", 1, 0.0, "group", 0)
    spec["vq_batch_drop"], refs["vq_batch_drop"] = _vq_case(
        "nsvq", 2, 0.2, "batch", 1)
    spec["dm"], refs["dm"] = _dm_case()
    spec["dm_bf16"], refs["dm_bf16"] = _dm_bf16_case(spec["dm"])
    spec["gan"], refs["gan"] = _gan_case()
    # 2 x 2 x 2 x 4 = 32 rows a pass (the restart draws from all), then
    # 8 rows (fewer than the 16 codes: tiled and jittered)
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((2, 2, 2, 4, 8), (2, 1, 2, 2, 8))]
    for kind, qcfg in EMA_KINDS.items():
        spec[kind] = dict(kind="quantizer", cfg=qcfg, seed=9, xs=xs)
        refs[kind] = _quantizer_reference(qcfg, 9, xs)
    torch.save(spec, d / "spatial_in.pt")
    return refs, launch("spatial", d, timeout=240)


def _cat(ranks, name, key, axis):
    return torch.cat([r[name][key] for r in ranks], axis)


def _close(got, ref, rtol, what):
    """`got` within rtol of `ref`'s largest |value|."""
    scale = float(ref.double().abs().max()) or 1.0
    err = float((got.double() - ref.double()).abs().max())
    assert err <= rtol * scale, (what, err, scale)


def _grads_close(got, ref, what):
    """Each gradient within GRAD_RTOL of its tensor's largest |value|, or
    GRAD_FLOOR of the model's largest."""
    assert got.keys() == ref.keys(), what
    if not ref:
        return
    top = max(float(g.double().abs().max()) for g in ref.values())
    for k, g in ref.items():
        err = float((got[k].double() - g.double()).abs().max())
        bound = max(GRAD_RTOL * float(g.double().abs().max()),
                    GRAD_FLOOR * top)
        assert err <= bound, (what, k, err, bound)


def _equal_on_both_ranks(ranks, name, key):
    a, b = ranks[0][name][key], ranks[1][name][key]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), (name, key, k)


@pytest.mark.parametrize("name", list(_bf16_op_cases()))
def test_sharded_bf16_op_matches_the_whole_op(run, name):
    """In bfloat16: the slabs' outputs (bfloat16) and input gradients
    within a bfloat16 ulp of the whole op's, the summed weight gradients
    (float32) within BF16_GRAD_RTOL."""
    refs, ranks = run
    ref = refs[name]
    assert ranks[0][name]["y"].dtype == ref["y"].dtype == torch.bfloat16
    _close(_cat(ranks, name, "y", 4), ref["y"], BF16_RTOL, (name, "y"))
    _close(_cat(ranks, name, "dx", 4), ref["dx"], BF16_RTOL, (name, "dx"))
    for k, g in ref["grads"].items():
        assert g.dtype == torch.float32
        _close(ranks[0][name]["grads"][k] + ranks[1][name]["grads"][k], g,
               BF16_GRAD_RTOL, (name, k))


@pytest.mark.parametrize("name", list(_op_cases()))
def test_sharded_op_matches_the_whole_op(run, name):
    """The slabs' outputs are the whole output's; an input slab's
    gradient is the whole gradient's slab; the parameters' gradients
    summed over the slabs and the BatchNorm statistics are the whole
    op's."""
    refs, ranks = run
    ref = refs[name]
    axis = 3 if name.startswith(("unet", "vqgan", "legacy")) else 4
    _close(_cat(ranks, name, "y", axis), ref["y"], REL_TOL, (name, "y"))
    _close(_cat(ranks, name, "dx", axis), ref["dx"], GRAD_RTOL,
           (name, "dx"))
    _grads_close({k: g + ranks[1][name]["grads"][k]
                  for k, g in ranks[0][name]["grads"].items()},
                 ref["grads"], name)
    _equal_on_both_ranks(ranks, name, "buffers")
    for k, b in ref["buffers"].items():
        _close(ranks[0][name]["buffers"][k], b, REL_TOL, (name, k))


def _assert_step(ranks, name, ref):
    """Both ranks bitwise equal; the metrics and every gradient as one
    process's."""
    _equal_on_both_ranks(ranks, name, "state")
    _equal_on_both_ranks(ranks, name, "grads")
    got = ranks[0][name]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=REL_TOL,
                                   atol=1e-7, err_msg=(name, k))
    _grads_close(got["grads"], ref["grads"], name)


def _assert_moments(grads, b1, mu, rtol):
    """Adam's first moment of the ranks' gradients ((1 - b1) g at the
    first step) against JAX's, within rtol of the model's largest."""
    scale = max(float(np.abs(np.asarray(m)).max()) for m in mu.values())
    for k, m_ref in mu.items():
        m = (1.0 - b1) * grads[k].double().numpy()
        err = float(np.abs(m - np.asarray(m_ref, np.float64)).max())
        assert err <= rtol * scale, (k, err, scale)


@pytest.mark.parametrize("name", ["vq_group_ste", "vq_batch_drop"])
def test_vq_step_over_depth_slabs(run, name):
    refs, ranks = run
    ref = refs[name]
    _assert_step(ranks, name, ref["one"])
    got = ranks[0][name]
    vq_metrics_close(got["metrics"], ref["jax"]["metrics"])
    _assert_moments(got["grads"], 0.9, ref["jax"]["mu"], VQ_MOMENT_RTOL)
    # eval over slabs (SSIM and PSNR on the gathered volumes)
    assert got["eval"] == ranks[1][name]["eval"]
    for k, v in ref["one"]["eval"].items():
        if k == "ssim":
            np.testing.assert_allclose(got["eval"][k], v, atol=1e-6)
        else:
            np.testing.assert_allclose(got["eval"][k], v, rtol=REL_TOL,
                                       err_msg=k)


def test_diffusion_step_and_ema_generate_over_depth_slabs(run):
    refs, ranks = run
    ref = refs["dm"]
    _assert_step(ranks, "dm", ref["one"])
    _equal_on_both_ranks(ranks, "dm", "ema")
    got = ranks[0]["dm"]
    for k in ("loss", "noise_mse"):
        np.testing.assert_allclose(got["metrics"][k],
                                   ref["jax"]["metrics"][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    _assert_moments({f"unet.{k}": g for k, g in got["grads"].items()}, 0.9,
                    ref["jax"]["mu"], DM_MOMENT_RTOL)
    # the EMA copy samples over slabs (its U-Net a deepcopy: the sharding
    # is the context's) and the decode is gathered whole on both ranks
    assert torch.equal(got["volumes"], ranks[1]["dm"]["volumes"])
    assert got["volumes"].shape == (DM_B, 16, 16, 16, 1)
    _close(got["volumes"], ref["one"]["volumes"], REL_TOL, "generate")


def test_bf16_diffusion_step_over_depth_slabs(run):
    """The diffusion step in bfloat16 over slabs against one process in
    bfloat16 (both round bfloat16 activations, in other orders): the
    loss to 5e-3 relative, the gradients' L2 distance to 5e-2 of their
    norm (about 1.5e-2 here)."""
    refs, ranks = run
    ref, got = refs["dm_bf16"], ranks[0]["dm_bf16"]
    _equal_on_both_ranks(ranks, "dm_bf16", "grads")
    for k in ("loss", "noise_mse"):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   rtol=5e-3, err_msg=k)
    num = sum(float((got["grads"][n] - g).double().square().sum())
              for n, g in ref["grads"].items())
    den = sum(float(g.double().square().sum()) for g in ref["grads"].values())
    assert np.sqrt(num / den) <= 5e-2, np.sqrt(num / den)
    assert got["volumes"].dtype == torch.float32


def test_gan_step_over_depth_slabs(run):
    """Both optimizers' gradients (the autoencoder's over slabs, the
    critics' on the gathered volumes), R1 and the adaptive weight (a
    ratio of two gradient norms: ADAPTIVE_RTOL), against one process."""
    refs, ranks = run
    ref = refs["gan"]["one"]
    adaptive = ref["metrics"].pop("adaptive_weight")
    _assert_step(ranks, "gan", ref)
    got = ranks[0]["gan"]["metrics"]
    assert got["r1_penalty"] > 0 and adaptive > 0
    np.testing.assert_allclose(got["adaptive_weight"], adaptive,
                               rtol=ADAPTIVE_RTOL)


@pytest.mark.parametrize("kind", list(EMA_KINDS))
def test_ema_quantizer_over_depth_slabs(run, kind):
    """Usage counts and perplexity of the global batch, the cluster
    statistics, the data-dependent init and the restarts drawn from the
    global rows in the one-process order: equal on both ranks, and to
    one process."""
    refs, ranks = run
    for i, ref in enumerate(refs[kind]):
        a, b = ranks[0][kind]["steps"][i], ranks[1][kind]["steps"][i]
        for k in ref["buffers"]:
            assert torch.equal(a["buffers"][k], b["buffers"][k]), (i, k)
            _close(a["buffers"][k], ref["buffers"][k], REL_TOL, (kind, i, k))
        assert torch.equal(a["counts"], ref["counts"]), i
        np.testing.assert_allclose(a["perplexity"], ref["perplexity"],
                                   rtol=REL_TOL)
        _close(torch.cat([a["y"], b["y"]], 3), ref["y"], REL_TOL,
               (kind, i, "y"))
        _close(torch.cat([a["dx"], b["dx"]], 3) / SPACE, ref["dx"],
               REL_TOL, (kind, i, "dx"))

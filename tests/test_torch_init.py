"""The trainers' init (`init_random`, scheme "jax": `layers.init_jax_`)
against the JAX package's `init_state`, on the CPU, for the three
trainers at their tiny test configs: the flagship stage 2 (with a
classifier-free-guidance null row), a stage-1 VQ-VAE and the VQ-GAN
(`vqgan_attn`'s autoencoder, both critics and LPIPS).

The two sides draw the same distributions from different generators, so
tensors are paired by their flax path (`convert.flax_state` /
`gan_flax_state`) and compared as samples:
  - a tensor that is constant on the JAX side (zeros of the zero-init
    layers and of the biases, ones of the norms, BatchNorm statistics,
    PReLU slopes) is the same constant on the port's, exactly; the LPIPS
    heads, calibrated from the random trunk after init, are constant per
    head on both sides;
  - a random weight keeps to its kind's support on both sides (the
    glorot-uniform limit, the 2-sigma truncation of lecun-normal, 6 sigma
    of an embedding's normal), and its standard deviation is within
    STD_RTOL of the JAX tensor's where the tensor has at least MIN_STD_N
    elements;
  - per kind, all weights pooled (each divided by its expected standard
    deviation): the pooled standard deviation is within POOLED_RTOL of 1
    on both sides, which holds the small tensors too.
The kind of each weight is read from the port's module (`kernel_init`),
and the JAX side is held to it as well: a kind stated wrongly in the port
fails on the JAX tensor's support or its pooled deviation.

Also here: `Norm("layer")` against flax, and the refusal of an unknown
kernel init.
"""

import dataclasses
import math
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from __graft_entry__ import _flagship_cfg
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.models.layers import Norm as JNorm
from ldm3d.train.dm_trainer import DiffusionTrainer as JTrainer
from ldm3d.train.gan_trainer import GANTrainer as JGANTrainer
from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
from ldm3d_torch.convert import flatten, flax_state, gan_flax_state
from ldm3d_torch.core.config import TrainConfig, flagship_cfg
from ldm3d_torch.models.layers import (ConvTranspose3d, Norm, _fans,
                                       init_jax_, init_params_, with_init)
from ldm3d_torch.train.dm_trainer import DiffusionTrainer
from ldm3d_torch.train.gan_trainer import GANTrainer
from ldm3d_torch.train.vq_trainer import VQTrainer
from test_torch_gan_trainer import cfgs as gan_cfgs
from test_torch_samplers import FAST
from test_torch_vq_trainer import _cfgs as vq_cfgs
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# Sample standard deviations of two independent draws of one distribution
# over n >= 4096 elements differ by about sqrt(2 / n) < 2.3 %; 10 % is
# four times that.
MIN_STD_N, STD_RTOL = 4096, 0.10
# Pooled over every tensor of a kind: 5 %, or four standard errors of a
# sample standard deviation, 4 / sqrt(2 n), where the pool is small (the
# tiny embedding: 96 elements, 29 %; a draw at the wrong scale, N(0, 1)
# for 1 / sqrt(32), is off by a factor of 5.7).
POOLED_RTOL = 0.05
TRUNC = .87962566103423978       # std of a unit normal truncated at 2


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _kinds(module: nn.Module, prefix: str = ""):
    """{flax path of a weight: (kind, expected std, support bound)}."""
    out = {}
    for name, m in module.named_modules():
        path = "/".join(p for p in (prefix, *name.split(".")) if p)
        if isinstance(m, nn.Embedding):
            std = m.embedding_dim ** -0.5
            out[path + "/embedding"] = ("embed", std, 6 * std)
            continue
        kind = getattr(m, "kernel_init", None)
        if kind is None and isinstance(m, nn.Linear):
            kind = "glorot_uniform"
        if kind is None:
            continue
        fan_in, fan_out = _fans(m.weight)
        if kind == "glorot_uniform":
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            out[path + "/kernel"] = (kind, limit / math.sqrt(3), limit)
        elif kind == "lecun_normal":
            std = math.sqrt(1.0 / fan_in)
            out[path + "/kernel"] = (kind, std, 2 * std / TRUNC * 1.0001)
        else:
            out[path + "/kernel"] = (kind, None, None)
    return out


def _compare(jax_tree, port_tree, kinds, calibrated=()):
    """Holds the port's tensors to JAX's as set out in the docstring;
    returns the number of tensors compared."""
    jflat, pflat = flatten(jax_tree), flatten(port_tree)
    assert jflat.keys() == pflat.keys()
    pooled = {}
    for path, a in jflat.items():
        t = pflat[path]
        assert a.shape == t.shape, path
        a = np.asarray(a, np.float64)
        t = np.asarray(t, np.float64)
        if any(path.startswith(c) for c in calibrated):
            assert np.ptp(a) == 0 and np.ptp(t) == 0, path
            continue
        if np.ptp(a) == 0:
            np.testing.assert_array_equal(t, a, err_msg=path)
            continue
        weight = path.partition("/")[2]
        if weight not in kinds:
            continue              # a quantizer's own draw (reset_parameters)
        kind, std, bound = kinds[weight]
        assert kind not in ("zeros",) and not kind.startswith("constant"), \
            f"{path}: JAX draws it, the port states {kind}"
        if std is None:
            continue
        for side, x in (("jax", a), ("port", t)):
            assert np.abs(x).max() <= bound, (path, side, kind)
            pooled.setdefault((kind, side), []).append((x / std).ravel())
        if a.size >= MIN_STD_N:
            np.testing.assert_allclose(t.std(), a.std(), rtol=STD_RTOL,
                                       err_msg=path)
    for (kind, side), xs in pooled.items():
        z = np.concatenate(xs)
        rtol = max(POOLED_RTOL, 4.0 / math.sqrt(2 * z.size))
        np.testing.assert_allclose(z.std(), 1.0, rtol=rtol,
                                   err_msg=f"{kind} {side} n={z.size}")
    return len(jflat)


def test_stage2_init_matches_jax():
    jcfg = _flagship_cfg(tiny=True)
    jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(
        jcfg.unet, cfg_dropout=0.1))
    tr = JTrainer(jcfg, JTrainConfig(batch_size=1, dtype="float32"),
                  conditional=True)
    st = jax.jit(tr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(0), (1, 16, 16, 16, 1)).compile(
        compiler_options=FAST)(jax.random.PRNGKey(0))
    cfg = flagship_cfg(tiny=True)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, cfg_dropout=0.1))
    tt = DiffusionTrainer(cfg, device="cpu").init_random(1)
    port = flax_state(tt.model)
    n = _compare({"params": _np(st.params),
                  "batch_stats": _np(st.batch_stats)},
                 {"params": port["params"],
                  "batch_stats": port["batch_stats"]}, _kinds(tt.model))
    assert n > 100
    unet = tt.model.unet
    assert not unet.head.weight.any()
    assert not unet.down_res_0_0.conv2.weight.any()
    emb = tt.model.unet.context_embed.weight
    assert emb.shape[0] == cfg.unet.context_dim + 2     # the null row


def test_stage1_init_matches_jax():
    jcfg, tcfg = vq_cfgs("ste", 1)
    jtr = JVQTrainer(jcfg, JTrainConfig(batch_size=2, dtype="float32"))
    st = jax.jit(jtr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(0), (2, 16, 16, 16, 1)).compile(
        compiler_options=FAST)(jax.random.PRNGKey(0))
    tt = VQTrainer(tcfg, TrainConfig(dtype="float32", batch_size=2),
                   device="cpu") \
        .init_random(1)
    port = flax_state(tt.model)
    _compare({"params": _np(st.params), "batch_stats": _np(st.batch_stats)},
             {"params": port["params"], "batch_stats": port["batch_stats"]},
             _kinds(tt.model))


def test_gan_init_matches_jax():
    jcfg, tcfg = gan_cfgs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st = JGANTrainer(jcfg, JTrainConfig(batch_size=2, dtype="float32")) \
            .init_state(jax.random.PRNGKey(0), (2, 16, 16, 16, 2))
        tt = GANTrainer(tcfg, TrainConfig(dtype="float32", batch_size=2),
                        device="cpu",
                        volume_size=16).init_random(1)
    port = gan_flax_state(tt.model)
    kinds = _kinds(tt.model)
    assert kinds["lpips/vgg/block1_conv1/kernel"][0] == "lecun_normal"
    assert kinds["disc2d/down_0/kernel"][0] == "lecun_normal"
    assert kinds["disc3d/down_0/kernel"][0] == "glorot_uniform"
    _compare({"params": _np(st.params), "batch_stats": _np(st.batch_stats)},
             {"params": port["params"], "batch_stats": port["batch_stats"]},
             kinds, calibrated=("params/lpips/lin",))


def test_dense_critic_head_is_lecun_normal():
    """The 3D critic's dense head (`vqgan_gnorm`'s), which the tiny GAN
    config does not build: flax's default Dense init on both sides."""
    jcfg, tcfg = gan_cfgs()
    jcfg = dataclasses.replace(jcfg, disc=dataclasses.replace(
        jcfg.disc, head="dense"))
    tcfg = dataclasses.replace(tcfg, disc=dataclasses.replace(
        tcfg.disc, head="dense"))
    from ldm3d.models.vqgan import Discriminator3D as JDisc
    from ldm3d_torch.models.vqgan import Discriminator3D
    var = JDisc(jcfg.disc).init(jax.random.PRNGKey(0),
                                np.zeros((1, 16, 16, 16, 1), np.float32),
                                training=False)
    d = Discriminator3D(tcfg.disc, 1, volume_size=16)
    init_jax_(d, torch.Generator().manual_seed(0))
    port = flax_state(d)
    kinds = _kinds(d)
    assert kinds["dense1/kernel"][0] == kinds["dense2/kernel"][0] \
        == "lecun_normal"
    _compare({"params": _np(var["params"])}, {"params": port["params"]},
             kinds)


def test_schemes_differ_only_where_jax_does():
    """"reach" (`init_params_`) keeps every layer live; "jax" zeroes the
    zero-init layers; both are seeded."""
    cfg = flagship_cfg(tiny=True)
    a = DiffusionTrainer(cfg, device="cpu").init_random(0, "reach")
    b = DiffusionTrainer(cfg, device="cpu").init_random(0)
    c = DiffusionTrainer(cfg, device="cpu").init_random(0)
    assert a.model.unet.head.weight.abs().min() > 0
    assert not b.model.unet.head.weight.any()
    for (k, x), y in zip(b.model.state_dict().items(),
                         c.model.state_dict().values()):
        assert torch.equal(x, y), k
    with pytest.raises(KeyError):
        DiffusionTrainer(cfg, device="cpu").init_random(0, "other")


def test_kernel_init_refuses_unknown_kinds():
    with pytest.raises(ValueError, match="unknown kernel init"):
        with_init(nn.Linear(2, 2), "he_normal")
    with pytest.raises(ValueError):
        with_init(nn.Linear(2, 2), "constant:x")
    m = with_init(nn.Linear(3, 2), "constant:0.5")
    init_jax_(m, torch.Generator().manual_seed(0))
    assert torch.equal(m.weight, torch.full((2, 3), 0.5))


def test_icnr_transposed_conv_under_both_schemes():
    """A `kernel_resize` transposed conv takes the ICNR init under both:
    constant over each stride^3 block of taps."""
    for init in (init_jax_, init_params_):
        m = ConvTranspose3d(4, 3, kernel=4, stride=2, kernel_resize=True)
        init(m, torch.Generator().manual_seed(0))
        assert m.kernel_init == "glorot_normal_icnr"
        assert torch.isfinite(m.weight).all() and m.weight.std() > 0


@pytest.mark.parametrize("shape", [(2, 5, 4, 3, 6), (1, 2, 2, 2, 16)])
def test_norm_layer_matches_flax(shape):
    """`Norm("layer")`: flax LayerNorm over the channels (eps 1e-6, scale
    and bias) of an NDHWC volume; the port takes NCDHW. 1e-6 relative
    and absolute: flax's variance is E[x^2] - E[x]^2, torch's two-pass,
    so outputs of unit scale lie a few float32 ulps apart (1.07e-6 at an
    output of 1.53 over 6 channels)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) + 0.5).astype(np.float32)
    c = shape[-1]
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var = {"params": {"LayerNorm_0": {"scale": scale, "bias": bias}}}
    ref = np.asarray(JNorm("layer").apply(var, x))
    m = Norm("layer", c)
    port = flax_state(m)["params"]
    assert set(port) == {"LayerNorm_0/scale", "LayerNorm_0/bias"}
    m.load_state_dict({"LayerNorm_0.weight": torch.from_numpy(scale),
                       "LayerNorm_0.bias": torch.from_numpy(bias)})
    got = m(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(
        0, 2, 3, 4, 1).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

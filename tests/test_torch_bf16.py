"""The port's compute dtype (`TrainConfig.dtype`) against the JAX package's
bfloat16 default, on the CPU.

JAX builds every model with `dtype=jnp.bfloat16` and compiles it once per
case; the port sets the same dtype with `layers.set_compute_dtype` (the
trainers do it from `TrainConfig()`). Three kinds of check:

- A dtype census: every flax module's output (`capture_intermediates`)
  against the port module of the same path (forward hooks), for the
  U-Net, the VQ-VAE (encoder, quantizer, decoder), a VQ-GAN autoencoder
  with both critics, emavqvae and vqvae_legacy; the codebook search gets
  float32 on every path.
- Values: single layers, each family's forward pass, a few sampler steps
  and one train step of each trainer, port bfloat16 against JAX bfloat16.
- The float32 path is the old one: the other `test_torch_*` files hold it
  at float32 tolerances.

Why the tolerances are what they are (measured here): one layer casts
where flax casts and agrees with it on more than 99.9 % of the outputs
(the rest one bfloat16 ulp apart: accumulation order), which is far from
JAX's own float32 result. Over a network those single-ulp differences
feed the next layer and grow as JAX's bfloat16 rounding does, and the
activations differ too: torch's SiLU and GELU round once where XLA on the
CPU rounds each elementary op. So a whole network lies about as far from
JAX bfloat16 as JAX bfloat16 lies from JAX float32; the bounds below are
a small multiple of that distance, measured for each case, and the
census is the check that tells the casts apart.
"""

import dataclasses
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.models.layers import Norm as JNorm
from ldm3d.models.layers import conv3d_transpose as jconv3d_transpose
from ldm3d.models.unet3d import UNet3D as JUNet3D
from ldm3d.train.dm_trainer import DiffusionTrainer as JTrainer
from ldm3d.train.gan_trainer import GANTrainer as JGANTrainer
from ldm3d.train.state import TrainState
from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
from ldm3d_torch.convert import convert_gan_state, convert_state, module_state
from ldm3d_torch.core.config import TrainConfig, compute_dtype, flagship_cfg
from ldm3d_torch.models import quantizers as tquant
from ldm3d_torch.models.layers import (_COMPUTE, Conv3d, ConvTranspose3d,
                                       Dense, Embed, LayerNorm, Norm,
                                       set_compute_dtype)
from ldm3d_torch.models.quantizers import Draws
from ldm3d_torch.train.dm_trainer import DiffusionTrainer
from ldm3d_torch.train.gan_trainer import GANTrainer
from ldm3d_torch.train.vq_trainer import VQTrainer
from test_torch_gan_trainer import _batch as gan_batch
from test_torch_gan_trainer import _jax_step as gan_jax_step
from test_torch_gan_trainer import _moments as gan_moments
from test_torch_gan_trainer import _train_cfgs as gan_train_cfgs
from test_torch_gan_trainer import _tree as gan_tree
from test_torch_gan_trainer import base_state  # noqa: F401 (a fixture)
from test_torch_gan_trainer import cfgs as gan_cfgs
from test_torch_model_families import _cfgs as family_cfgs
from test_torch_samplers import FAST, _jax_draws
from test_torch_train import _draws as dm_draws
from test_torch_vq_trainer import _cfgs as vq_cfgs
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

B = 2
BF = torch.bfloat16
# One layer against flax: the share of outputs that are equal, and the L1
# distance from flax bfloat16 over the L1 distance from flax bfloat16 to
# flax float32 (measured: 0.99997 and 2e-5 to 3e-4 for a conv, a dense, a
# transposed conv and the norms).
LAYER_EQUAL = 0.999
LAYER_L1_FRACTION = 2e-3
# A whole network (forward, sampler): the port's distance from JAX
# bfloat16, in units of JAX bfloat16's distance from float32 (max
# |difference| over max |reference|). Gradients of one train step, through
# Adam's first moment: the L2 distance per parameter group in the same
# units; bfloat16 gradients of these tiny networks are noisy (JAX
# bfloat16 lies 0.02-0.9 of a group's norm from float32), and the port's
# distance was at most 1.7 of that.
NET_FRACTION = 3.0
# A train step's loss, a mean over 1e3-1e4 squared errors: the port's
# bfloat16 step lies 3.2e-4 (the U-Net) and 2.6e-7 (the VQ-VAE) relative
# from JAX's bfloat16 step. JAX's own bfloat16-to-float32 distance is no
# yardstick here (4.7e-5 for the U-Net: the rounding averages out of the
# mean), so the bound is stated outright.
LOSS_RTOL = 1e-3
# The VQ-GAN's critic losses are bfloat16 sums on both sides (JAX upcasts
# them only when it weights them): one bfloat16 ulp of the value apart at
# least (seen: the critics' loss 2.203 against 2.188). Its metrics are
# held to that or to NET_FRACTION of the float32 port's distance.
BF16_ULP = 2.0 ** -7


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _first_leaf(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _flax_outputs(module, variables, *args, **kw):
    """(output, {port module path: first output leaf}) of every flax
    module call, first calls first."""
    def run(v, *a):
        return module.apply(v, *a, capture_intermediates=True,
                            mutable=["intermediates"], **kw)
    out, inter = _compile(run, variables, *args)(variables, *args)
    calls = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            inter["intermediates"])[0]:
        keys = [p.key for p in path if hasattr(p, "key")]
        name = ".".join(keys[:keys.index("__call__")])
        if name:
            calls.setdefault(name, leaf)
    return out, calls


def _port_outputs(module, *args):
    """(output, {module path: first output leaf of its first call})."""
    calls = {}

    def hook(name):
        def record(module, inputs, output):
            calls.setdefault(name, _first_leaf(output))   # returns None
        return record
    handles = [m.register_forward_hook(hook(n))
               for n, m in module.named_modules() if n]
    try:
        with torch.no_grad():
            out = module(*args)
    finally:
        for h in handles:
            h.remove()
    return out, calls


def _census(module, flax_calls, port_calls):
    """Every port layer with a compute dtype, and every module flax also
    has, gives flax's output dtype. Returns the number compared."""
    common = set(flax_calls) & set(port_calls)
    layers = {n for n, m in module.named_modules()
              if hasattr(m, "compute_dtype") and n in port_calls}
    assert layers <= common, sorted(layers - common)
    wrong = [(n, str(flax_calls[n].dtype), str(port_calls[n].dtype))
             for n in sorted(common)
             if str(flax_calls[n].dtype)
             != str(port_calls[n].dtype).removeprefix("torch.")]
    assert not wrong, wrong
    return len(common)


@pytest.fixture
def search_dtypes(monkeypatch):
    """The dtypes the codebook search receives, in call order."""
    seen = []
    plain = tquant.nearest_codebook_indices

    def spy(x, codebook):
        seen.append(x.dtype)
        return plain(x, codebook)
    monkeypatch.setattr(tquant, "nearest_codebook_indices", spy)
    return seen


def _float32_outputs(module, *args):
    """`_port_outputs` of `module` with its casts taken away, then put
    back: the port's float32 path, which the other test_torch_* files hold
    to JAX float32 at 1e-5 and which stands in for it here as the yardstick
    of JAX bfloat16's own rounding (one JAX compile per case, not two)."""
    set_compute_dtype(module, torch.float32)
    try:
        return _port_outputs(module, *args)
    finally:
        set_compute_dtype(module, BF)


def _distance(out, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(out, np.float32) - ref).max()
                 / np.abs(ref).max())


def _assert_net(out, ref_bf, ref_f32, what):
    """The port's bfloat16 output within NET_FRACTION of JAX bfloat16's own
    distance from float32 (`ref_f32`: the port's float32 result)."""
    own = _distance(ref_bf, ref_f32)
    got = _distance(out, ref_bf)
    assert 0 < own and got <= NET_FRACTION * own, (what, got, own)


# ---------------------------------------------------------------------------
# single layers
# ---------------------------------------------------------------------------


def _layer_cases():
    conv = fnn.Conv(16, (3, 3, 3), padding="SAME", dtype=jnp.bfloat16)
    dense = fnn.Dense(24, dtype=jnp.bfloat16)
    return {
        "conv3d": (conv, fnn.Conv(16, (3, 3, 3), padding="SAME"),
                   lambda: Conv3d(8, 16, 3), (2, 6, 6, 6, 8), True),
        "dense": (dense, fnn.Dense(24), lambda: Dense(8, 24),
                  (2, 40, 8), False),
        "conv_transpose3d": (
            jconv3d_transpose(8, 4, 2, dtype=jnp.bfloat16),
            jconv3d_transpose(8, 4, 2), lambda: ConvTranspose3d(8, 8),
            (2, 4, 4, 4, 8), True),
        "group_norm": (JNorm("group", dtype=jnp.bfloat16), JNorm("group"),
                       lambda: Norm("group", 8), (2, 4, 4, 4, 8), True),
        "batch_norm_train": (JNorm("batch", dtype=jnp.bfloat16),
                             JNorm("batch"), lambda: Norm("batch", 8),
                             (2, 4, 4, 4, 8), True),
        "layer_norm": (fnn.LayerNorm(dtype=jnp.bfloat16), fnn.LayerNorm(),
                       lambda: LayerNorm(8), (2, 40, 8), False),
    }


@pytest.mark.parametrize("name", list(_layer_cases()))
def test_layer_casts_where_flax_casts(name):
    jbf, j32, make, shape, volume = _layer_cases()[name]
    rng = np.random.default_rng(len(name))
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    v = jbf.init(jax.random.PRNGKey(0), x)
    v = {**v, "params": _perturb(v["params"], 1, 0.3)}
    train = name == "batch_norm_train"
    kw = dict(mutable=["batch_stats"]) if train else {}
    ref, ref32 = (_first_leaf(m.apply(v, x, **kw)) for m in (jbf, j32))
    layer = make()
    layer.load_state_dict(module_state(v["params"], v.get("batch_stats")))
    set_compute_dtype(layer.train(train), BF)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = layer(xt.movedim(-1, 1) if volume else xt)
    out = (out.movedim(1, -1) if volume else out)
    assert out.dtype == BF and str(ref.dtype) == "bfloat16"
    out, ref, ref32 = (np.asarray(a, np.float32) for a in
                       (out.float(), ref, ref32))
    assert np.mean(out == ref) >= LAYER_EQUAL, np.mean(out == ref)
    fraction = np.abs(out - ref).mean() / np.abs(ref - ref32).mean()
    assert fraction <= LAYER_L1_FRACTION, fraction


def test_embed_rows_come_out_in_the_compute_dtype():
    emb = Embed(5, 8)
    set_compute_dtype(emb, BF)
    out = emb(torch.tensor([0, 4]))
    assert out.dtype == BF
    assert torch.equal(out, emb.weight[[0, 4]].to(BF))
    assert emb.weight.dtype == torch.float32


def test_float32_takes_the_casts_away():
    unet = DiffusionTrainer(flagship_cfg(tiny=True), device="cpu",
                            train_cfg=TrainConfig(dtype="float32")).model
    assert all(getattr(m, "compute_dtype", None) is None
               for m in unet.modules())
    assert compute_dtype("float32") == torch.float32
    assert compute_dtype(TrainConfig().dtype) == BF


# ---------------------------------------------------------------------------
# the census and the forward passes of each family
# ---------------------------------------------------------------------------


def test_unet_census_and_values():
    jcfg = _flagship_cfg(tiny=True)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 4, 4, 4, 8)).astype(np.float32)
    t, c = np.array([7, 2], np.int32), np.array([1, 0], np.int32)
    jbf = JUNet3D(jcfg.unet, out_channels=8, dtype=jnp.bfloat16)
    v = jbf.init(jax.random.PRNGKey(0), x, t, c, training=False)
    v = {"params": _perturb(v["params"], 11, 0.1),
         "batch_stats": v["batch_stats"]}
    ref, calls = _flax_outputs(jbf, v, x, t, c, training=False)
    # the U-Net of a trainer built with the default TrainConfig
    unet = DiffusionTrainer(flagship_cfg(tiny=True), device="cpu").model.unet
    unet.load_state_dict(module_state(v["params"], v["batch_stats"]))
    args = [torch.from_numpy(a) for a in (x, t, c)]
    out, port_calls = _port_outputs(unet, *args)
    ref32, _ = _float32_outputs(unet, *args)
    n = _census(unet, calls, port_calls)
    dtypes = [str(a.dtype) for a in calls.values()]
    # the sinusoidal embedding is the one float32 output
    assert dtypes.count("float32") == 1 and n >= 120, (dtypes, n)
    assert out.dtype == BF
    _assert_net(out.float(), ref, ref32, "unet")


STAGE1 = {
    "vqvae": lambda: (_flagship_cfg(tiny=True).vqvae,
                      flagship_cfg(tiny=True).vqvae),
    "emavqvae": lambda: family_cfgs("ema_skip"),
    "vqvae_legacy": lambda: family_cfgs("legacy", mode=2, down=2),
}


@pytest.mark.parametrize("family", list(STAGE1))
def test_stage1_census_and_values(family, search_dtypes):
    """The models of default-TrainConfig trainers. The encoders' outputs
    are compared (a code that flips between two near-equidistant codebook
    rows would move the reconstruction by a code's difference); the
    VQ-VAE's decoder on JAX's own codes."""
    jcfg, tcfg = STAGE1[family]()
    x = np.random.default_rng(3).random((B, 16, 16, 16, 1)).astype(
        np.float32)
    jbf = JVQTrainer(jcfg, JTrainConfig(batch_size=B)).model
    v = jbf.init({"params": jax.random.PRNGKey(3),
                  "noise": jax.random.PRNGKey(3)}, x, training=False)
    v = {**v, "params": _perturb(v["params"], 3)}
    model = VQTrainer(tcfg, device="cpu").model
    state = module_state(v["params"], v.get("batch_stats"))
    state.update(module_state(v.get("vq_stats", {})))
    model.load_state_dict(state)
    _, calls = _flax_outputs(jbf, v, x, training=False)
    out, port_calls = _port_outputs(model, torch.from_numpy(x))
    _, calls32 = _float32_outputs(model, torch.from_numpy(x))
    assert _census(model, calls, port_calls) >= 10
    assert search_dtypes and set(search_dtypes) == {torch.float32}
    assert out[0].dtype == getattr(torch, str(calls["decoder"].dtype))
    # the port's encoders return NCDHW
    _assert_net(port_calls["encoder"].float().movedim(1, -1),
                calls["encoder"], calls32["encoder"].movedim(1, -1), family)
    if family == "vqvae":
        q = calls["quantizer"]
        ref = _compile(lambda v_, a: jbf.apply(v_, a, method="decode"),
                       v, q)(v, q)
        z = torch.from_numpy(np.asarray(q, np.float32))
        with torch.no_grad():
            got = model.decode(z)
            set_compute_dtype(model, torch.float32)
            got32 = model.decode(z)
        _assert_net(got.float(), ref, got32, "decoder")


def test_vqgan_census_and_values(search_dtypes):
    jcfg, tcfg = gan_cfgs()
    size = 16
    x = np.random.default_rng(5).random((B, size, size, size, 2)).astype(
        np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtr = JGANTrainer(jcfg, JTrainConfig(batch_size=B))
        tt = GANTrainer(tcfg, device="cpu", volume_size=size)
    frame = x[:, 8, ..., :1]
    cases = (("ae", x), ("disc3d", x[..., :1]), ("disc2d", frame))
    for i, (name, inp) in enumerate(cases):
        jbf = getattr(jtr, name)
        v = jbf.init({"params": jax.random.PRNGKey(i),
                      "noise": jax.random.PRNGKey(i)}, inp, training=False)
        v = {**v, "params": _perturb(v["params"], i)}
        prefix = {"params": {name: v["params"]}}
        if "batch_stats" in v:
            prefix["batch_stats"] = {name: v["batch_stats"]}
        if "vq_stats" in v:         # the autoencoder's, unprefixed
            prefix["vq_stats"] = v["vq_stats"]
        module = getattr(tt, name)
        module.load_state_dict({k.removeprefix(name + "."): t for k, t in
                                convert_gan_state(prefix).items()})
        ref, calls = _flax_outputs(jbf, v, inp, training=False)
        xin = torch.from_numpy(inp)
        xin = xin if name == "ae" else xin.movedim(-1, 1)
        out, port_calls = _port_outputs(module, xin)
        ref32, _ = _float32_outputs(module, xin)
        assert _census(module, calls, port_calls) >= 6, name
        got, got32 = _first_leaf(out), _first_leaf(ref32)
        if name != "ae":
            got, got32 = got.movedim(1, -1), got32.movedim(1, -1)
        assert got.dtype == getattr(torch, str(_first_leaf(ref).dtype))
        _assert_net(got.float(), _first_leaf(ref), got32, name)
    assert search_dtypes and set(search_dtypes) == {torch.float32}
    # LPIPS stays float32
    assert all(getattr(m, "compute_dtype", None) is None
               for m in tt.lpips.modules())


# ---------------------------------------------------------------------------
# the sampler and the trainers' steps
# ---------------------------------------------------------------------------


SHAPE = (B, 4, 4, 4, 8)
CTX = np.array([1, 0], np.int32)


@pytest.fixture(scope="module")
def dm_state():
    """A perturbed JAX init of the tiny flagship with a null context row and
    EMA weights, as numpy trees."""
    cfg = _flagship_cfg(tiny=True)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, cfg_dropout=0.5))
    tr = JTrainer(cfg, JTrainConfig(batch_size=B, dtype="float32"),
                  conditional=True)
    st = jax.jit(tr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(0), (B, 16, 16, 16, 1)).compile(
        compiler_options=FAST)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = _perturb(_np(st.params), 0, 0.02)
    stats = jax.tree_util.tree_map(
        lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
        _np(st.batch_stats))
    return cfg, st.replace(params=params, batch_stats=stats,
                           ema_params=params["unet"])


def _dm_port(cfg, st, dtype, **train):
    tcfg = flagship_cfg(tiny=True)
    tcfg = dataclasses.replace(tcfg, unet=dataclasses.replace(
        tcfg.unet, cfg_dropout=cfg.unet.cfg_dropout))
    tt = DiffusionTrainer(tcfg, device="cpu",
                          train_cfg=TrainConfig(dtype=dtype, **train))
    tt.load_state_dicts(*convert_state(
        {"params": _np(st.params), "batch_stats": _np(st.batch_stats),
         "vq_stats": _np(st.vq_stats), "ema_params": _np(st.ema_params)}))
    return tt


# JAX's float32 results enter only as the yardstick of JAX bfloat16's own
# rounding; the port's float32 path stands in for them below (the other
# test_torch_* files hold it to JAX float32 at 1e-5), which spares a
# second JAX compile per case.


@pytest.mark.parametrize("sampler,steps,guidance", [
    ("ddpm", None, None), ("ddim", 3, 2.0)])
def test_sampler_steps(dm_state, sampler, steps, guidance):
    cfg, st = dm_state
    key = jax.random.PRNGKey(5)
    tr = JTrainer(cfg, JTrainConfig(batch_size=1), conditional=True)
    fn = jax.jit(tr.generate_fn(SHAPE, decode=False, sampler=sampler,
                                sample_steps=steps, guidance_scale=guidance))
    ref = np.asarray(fn.lower(st, key, jnp.asarray(CTX)).compile(
        compiler_options=FAST)(st, key, jnp.asarray(CTX)))
    x_t, noise = _jax_draws(key, sampler, steps, cfg.timesteps)
    out = {}
    for dtype in ("bfloat16", "float32"):
        out[dtype] = _dm_port(cfg, st, dtype).generate(
            SHAPE, torch.from_numpy(CTX), init_noise=x_t, step_noise=noise,
            sampler=sampler, sample_steps=steps, guidance_scale=guidance,
            decode=False)
    assert out["bfloat16"].dtype == torch.float32 and ref.dtype == np.float32
    _assert_net(out["bfloat16"], ref, out["float32"], sampler)


def _group_errors(port_mu, ref_mu, port32_mu):
    """Per parameter group (the first two levels of the module tree): the
    L2 distance of the port's first moments from JAX bfloat16's, and of
    the float32 port's, each over the norm of JAX bfloat16's."""
    sums = {}
    for k, ref in ref_mu.items():
        g = ".".join(k.split(".")[:2])
        acc = sums.setdefault(g, np.zeros(3))
        acc += [np.square(port_mu[k] - ref).sum(),
                np.square(port32_mu[k] - ref).sum(), np.square(ref).sum()]
    return {g: (np.sqrt(a / max(n, 1e-30)), np.sqrt(b / max(n, 1e-30)))
            for g, (a, b, n) in sums.items()}


def _assert_steps(what, ports, ref_loss, ref_mu):
    """The bfloat16 port's loss within LOSS_RTOL of JAX bfloat16's, and its
    first moments (after one Adam step, a fixed share of the gradient)
    within NET_FRACTION of the float32 port's distance from JAX bfloat16,
    per parameter group."""
    (loss, mu), (loss32, mu32) = ports["bfloat16"], ports["float32"]
    assert abs(loss - ref_loss) <= max(LOSS_RTOL * abs(ref_loss),
                                       NET_FRACTION * abs(loss32 - ref_loss)), \
        (what, loss, loss32, ref_loss)
    for g, (got, own) in _group_errors(mu, ref_mu, mu32).items():
        assert got <= NET_FRACTION * own + 1e-6, (what, g, got, own)


def _port_mu(opt, model, prefix=""):
    return {prefix + n: opt.state[p]["exp_avg"].numpy()
            for n, p in model.named_parameters() if p in opt.state}


def _jax_mu(st, prefix):
    mu = st.opt_state.inner_state[0].mu
    return {k: v.numpy() for k, v in convert_state(
        {"params": {prefix: _np(mu)} if prefix else _np(mu)})[0].items()}


def test_diffusion_train_step(dm_state):
    cfg, st = dm_state
    lr = 1e-3
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    rng = np.array(st.rng)
    jtr = JTrainer(cfg, JTrainConfig(batch_size=B, learning_rate=lr),
                   conditional=True)
    params = _np(st.params)
    s = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                   vq_stats=_np(st.vq_stats), batch_stats=_np(st.batch_stats),
                   opt_state=jtr.tx.init(params["unet"]),
                   rng=jnp.asarray(rng), ema_params=None)
    s2, jm = jtr.train_step_latents(s, jnp.asarray(x), jnp.asarray(CTX))
    _, t, noise, drop = dm_draws(jnp.asarray(rng), SHAPE, 0.5, cfg.timesteps)
    ports = {}
    for dtype in ("bfloat16", "float32"):
        tt = _dm_port(cfg, st, dtype, batch_size=B, learning_rate=lr)
        m = tt.train_step_latents(
            torch.from_numpy(x), torch.from_numpy(CTX),
            t=torch.from_numpy(t), noise=torch.from_numpy(noise),
            drop=torch.from_numpy(drop))
        ports[dtype] = (float(m["loss"]),
                        _port_mu(tt.optimizer, tt.model.unet, "unet."))
    _assert_steps("diffusion", ports, float(jm["loss"]), _jax_mu(s2, "unet"))


def test_vq_train_step():
    jcfg, tcfg = vq_cfgs("ste", 1)
    lr = 1e-3
    rng = np.random.default_rng(2)
    vol = rng.random((B, 16, 16, 16, 1)).astype(np.float32)
    mask = (vol > 0.6).astype(np.float32)
    jtr = JVQTrainer(jcfg, JTrainConfig(batch_size=B, learning_rate=lr))
    st = jax.jit(jtr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(4), vol.shape).compile(compiler_options=FAST)(
        jax.random.PRNGKey(4))
    tree = {"params": _np(st.params), "vq_stats": _np(st.vq_stats),
            "batch_stats": _np(st.batch_stats)}
    s2, jm = jtr.train_step(st, jnp.asarray(vol), jnp.asarray(mask))
    ports = {}
    for dtype in ("bfloat16", "float32"):
        tt = VQTrainer(tcfg, TrainConfig(dtype=dtype, batch_size=B,
                                         learning_rate=lr), device="cpu")
        tt.model.load_state_dict(convert_state(tree)[0])
        m = tt.train_step(torch.from_numpy(vol), torch.from_numpy(mask))
        ports[dtype] = (float(m["loss"]), _port_mu(tt.optimizer, tt.model))
    _assert_steps("vq", ports, float(jm["loss"]), _jax_mu(s2, ""))


def test_gan_adversarial_losses(base_state):
    """The VQ-GAN's adversarial program with the adaptive weight and R1, in
    eval mode (JAX's `eval_step`, compiled once): every loss and metric,
    float32 on the port's side (test_gan_train_step holds the train
    step's gradients)."""
    over = dict(adaptive_g_weight=True, r1_gamma=0.5)
    jcfg, tcfg = gan_cfgs(**over)
    jtr = JGANTrainer(jcfg, JTrainConfig(batch_size=B))
    st = base_state.replace(epoch=jnp.asarray(1, jnp.int32))
    vol, mask = gan_batch(2)
    key = jax.random.PRNGKey(7)
    args = (st, jnp.asarray(vol), jnp.asarray(mask), key)
    ref = {k: float(v) for k, v in jtr._eval_step.lower(*args).compile(
        compiler_options=FAST)(*args).items()}
    lo, hi = jcfg.frame_idx_range
    frames = np.array(jax.random.randint(jax.random.split(key)[1], (B,),
                                         lo, min(hi, vol.shape[1])))
    ports = {}
    for dtype in ("bfloat16", "float32"):
        tt = GANTrainer(tcfg, TrainConfig(dtype=dtype, batch_size=B),
                        device="cpu", volume_size=16)
        tt.model.load_state_dict(convert_gan_state(gan_tree(st)))
        tt.epoch = 1
        ports[dtype] = tt.eval_step(torch.from_numpy(vol),
                                    torch.from_numpy(mask),
                                    draws=Draws(randint=[frames]))
    assert all(v.dtype == torch.float32 for v in ports["bfloat16"].values())
    assert {"adaptive_weight", "r1_penalty"} <= set(ref)
    for k, r in ref.items():
        got, got32 = float(ports["bfloat16"][k]), float(ports["float32"][k])
        assert abs(got - r) <= max(BF16_ULP * abs(r),
                                   NET_FRACTION * abs(got32 - r)), \
            (k, got, got32, r)


def _gan_census(tt):
    """Forward hooks that record the output dtype of every compute layer
    of the autoencoder and both critics and of the critics' losses
    (`d_loss`), by network; returns the record and the hooks."""
    seen = {}
    handles = []
    for net in ("ae", "disc3d", "disc2d"):
        for n, m in getattr(tt, net).named_modules():
            if isinstance(m, _COMPUTE):
                handles.append(m.register_forward_hook(
                    lambda mod, args, out, key=(net, n): seen.setdefault(
                        key, set()).add(_first_leaf(out).dtype)))
    d_loss = tt.d_loss

    def recorded_d_loss(*a):
        out = d_loss(*a)
        seen.setdefault(("d_loss", ""), set()).add(out.dtype)
        return out
    tt.d_loss = recorded_d_loss
    return seen, handles


@pytest.mark.parametrize("program", ["adversarial", "warm"])
def test_gan_train_step(base_state, program):
    """One bfloat16 VQ-GAN train step of each program from one state
    (`base_state`, 16^3), the adversarial one with the adaptive weight
    and R1: JAX's compiled step, its draws (outputs of the same program,
    tests/test_torch_gan_trainer.py's `_jax_step`) injected into the
    port. The loss and every metric, and Adam's first moments of the
    autoencoder and of the critics per parameter group, by the file's
    rule; and the census: every compute layer of the three networks, and
    each critic loss, bfloat16 in the port's step."""
    warm = program == "warm"
    over = {} if warm else dict(adaptive_g_weight=True, r1_gamma=0.5)
    jcfg, tcfg = gan_cfgs(**over)
    jtc, tc = gan_train_cfgs()
    jtr = JGANTrainer(jcfg, dataclasses.replace(jtc, dtype="bfloat16"))
    st = base_state.replace(epoch=jnp.asarray(0 if warm else 1, jnp.int32))
    vol, mask = gan_batch(1)
    st2, jm, draws = gan_jax_step(jtr, st, vol, mask, warm)
    ports, census = {}, None
    for dtype in ("bfloat16", "float32"):
        tt = GANTrainer(tcfg, dataclasses.replace(tc, dtype=dtype),
                        device="cpu", volume_size=16)
        tt.model.load_state_dict(convert_gan_state(gan_tree(st)))
        tt.epoch = int(st.epoch)
        if dtype == "bfloat16":
            census, handles = _gan_census(tt)
        m = tt.train_step(torch.from_numpy(vol), torch.from_numpy(mask),
                          draws=Draws(**{k: list(v)
                                         for k, v in draws.items()}),
                          warm=warm)
        if dtype == "bfloat16":
            for h in handles:
                h.remove()
        mu = {**_port_mu(tt.optimizer, tt.ae, "ae."),
              **_port_mu(tt.disc_optimizer, tt.disc3d, "disc3d."),
              **_port_mu(tt.disc_optimizer, tt.disc2d, "disc2d.")}
        ports[dtype] = (m, mu)
    nets = {key[0] for key in census}
    assert nets == ({"ae"} if warm else {"ae", "disc3d", "disc2d",
                                         "d_loss"}), nets
    wrong = {k: v for k, v in census.items() if v != {BF}}
    assert not wrong, wrong
    for k, r in jm.items():
        r = float(r)
        got, got32 = (float(ports[d][0][k]) for d in ("bfloat16", "float32"))
        assert abs(got - r) <= max(BF16_ULP * abs(r),
                                   NET_FRACTION * abs(got32 - r)), \
            (k, got, got32, r)
    ref_mu = {k: v.numpy() for k, v in {
        **gan_moments(st2.opt_state, "ae")[0],
        **gan_moments(st2.disc_opt_state, None)[0]}.items()}
    _assert_steps(f"gan {program}", {d: (float(m["loss"]), mu)
                                     for d, (m, mu) in ports.items()},
                  float(jm["loss"]), ref_mu)

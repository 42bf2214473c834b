"""The port's tiny slice end to end against the JAX package, on the CPU:
schedule, reverse step, `generate` (T-step DDPM chain + VQ decode) against
`DiffusionTrainer.generate_fn(..., decode=True)` with the JAX sampler's own
noise injected, the weight converter's two input forms, and the service's
request validation. The other samplers, guidance and v-prediction are in
test_torch_samplers.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ldm3d.core.config import TrainConfig
from ldm3d.diffusion.ddpm import ddpm_sample_step as j_step
from ldm3d.diffusion.schedule import make_schedule as j_make_schedule
from ldm3d.train.dm_trainer import DiffusionTrainer as JTrainer
from ldm3d.utils.export import save_state_npz
from ldm3d_torch.convert import convert_state, load_npz
from ldm3d_torch.core.config import TrainConfig as PTrainConfig
from ldm3d_torch.core.config import flagship_cfg
from ldm3d_torch.core.device import resolve_device
from ldm3d_torch.diffusion.ddpm import ddpm_sample_step
from ldm3d_torch.diffusion.schedule import make_schedule
from ldm3d_torch.serve import GenerationService
from ldm3d_torch.train.dm_trainer import DiffusionTrainer
from test_torch_samplers import FAST
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

SHAPE = (2, 4, 4, 4, 8)


@pytest.fixture(scope="module")
def jax_side():
    """Tiny JAX trainer state (float32, with EMA weights), perturbed with
    seeded noise so that no layer is zero and EMA differs from the raw
    weights."""
    cfg = _flagship_cfg(tiny=True)
    tr = JTrainer(cfg, TrainConfig(batch_size=1, dtype="float32",
                                   ema_decay=0.9), conditional=True)
    st = jax.jit(tr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(0), (1, 16, 16, 16, 1)).compile(
        compiler_options=FAST)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def noisy(tree, scale):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a) + scale * rng.standard_normal(
                a.shape).astype(np.float32), tree)
    params = noisy(st.params, 0.02)
    stats = jax.tree_util.tree_map(
        lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
        st.batch_stats)
    ema = noisy(params["unet"], 0.01)
    st = st.replace(params=params, batch_stats=stats, ema_params=ema)
    return tr, st


def _port(st):
    tree = {"params": jax.device_get(st.params),
            "batch_stats": jax.device_get(st.batch_stats),
            "vq_stats": jax.device_get(st.vq_stats),
            "ema_params": jax.device_get(st.ema_params)}
    model_state, ema_state = convert_state(tree)
    tt = DiffusionTrainer(flagship_cfg(tiny=True), device="cpu",
                          train_cfg=PTrainConfig(dtype="float32"))
    tt.load_state_dicts(model_state, ema_state)
    return tt


def test_schedule_tables_match():
    ref = j_make_schedule(500)
    out = make_schedule(500)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("t,clip", [(499, 0.0), (250, 1.0), (0, 0.0)])
def test_ddpm_step_matches(t, clip):
    sched_t, sched_j = make_schedule(500), j_make_schedule(500)
    rng = np.random.default_rng(t)
    x, eps, noise = (rng.standard_normal(SHAPE).astype(np.float32)
                     for _ in range(3))
    jnoise = noise if t > 0 else np.zeros_like(noise)
    ref = j_step(sched_j, jnp.asarray(x), jnp.asarray(eps),
                 jnp.full((2,), t, jnp.int32), jnp.asarray(jnoise),
                 clip_value=clip)
    out = ddpm_sample_step(sched_t, torch.from_numpy(x),
                           torch.from_numpy(eps), t, torch.from_numpy(noise),
                           clip_value=clip)
    # the same float32 coefficients; x0 = (x - c eps) / sqrt(abar) is
    # large at t = 499 (1 / sqrt(abar) ~ 12), so a few ulps of it
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    if clip > 0:
        assert np.abs(out.numpy()).max() <= clip + 2.0  # mean clipped


@pytest.mark.parametrize("use_ema", [True, False])
def test_tiny_generate_matches_generate_fn(jax_side, use_ema):
    tr, st = jax_side
    tt = _port(st)
    ctx = np.array([1, 0], np.int32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(tr.generate_fn(SHAPE, decode=True, use_ema=use_ema)
                     .lower(st, key, jnp.asarray(ctx)).compile(
                         compiler_options=FAST)(st, key, jnp.asarray(ctx)))
    # the JAX sampler's draws: split(rng) -> x_T, then one split per step
    init_rng, r = jax.random.split(key)
    x_t = np.array(jax.random.normal(init_rng, SHAPE, jnp.float32))
    steps = {}
    for t in range(tt.cfg.timesteps - 1, -1, -1):
        r, sub = jax.random.split(r)
        steps[t] = torch.from_numpy(
            np.array(jax.random.normal(sub, SHAPE, jnp.float32)))
    out = tt.generate(SHAPE, torch.from_numpy(ctx),
                      init_noise=torch.from_numpy(x_t),
                      step_noise=steps.__getitem__, use_ema=use_ema).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 16, 1)
    # 8 chained U-Net calls and a decode in float32, summed in different
    # orders; the chain amplifies eps errors by up to 1/sqrt(abar), so the
    # bound is 1e-5 relative to max |ref| (about 4e-7 was measured).
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def test_flat_npz_keys_convert_like_the_tree(jax_side, tmp_path):
    _, st = jax_side
    path = os.path.join(tmp_path, "snap.npz")
    save_state_npz(path, st, dtype=np.float32)
    flat_model, flat_ema = load_npz(path)
    tree_model, tree_ema = convert_state(
        {"params": jax.device_get(st.params),
         "batch_stats": jax.device_get(st.batch_stats),
         "vq_stats": jax.device_get(st.vq_stats),
         "ema_params": jax.device_get(st.ema_params)})
    assert flat_model.keys() == tree_model.keys()
    assert flat_ema.keys() == tree_ema.keys()
    for k in tree_model:
        assert torch.equal(flat_model[k], tree_model[k]), k
    # the encoder, the codebook and its usage counter are mapped too
    assert any(k.startswith("vqvae.encoder.") for k in flat_model)
    assert flat_model["vqvae.quantizer.codebook"].shape == (16, 8)
    assert "vqvae.quantizer.codebooks_used" in flat_model
    # the converted state loads strictly into the port's model
    tt = DiffusionTrainer(flagship_cfg(tiny=True), device="cpu")
    tt.load_state_dicts(flat_model, flat_ema)
    assert tt.ema_unet is not None


@pytest.fixture(scope="module")
def service():
    cfg = flagship_cfg(tiny=True)
    trainer = DiffusionTrainer(cfg, device="cpu",
                               train_cfg=PTrainConfig(dtype="float32"))
    return GenerationService(cfg, trainer.init_random(0, scheme="reach"))


def test_service_generates_and_is_seeded(service):
    a = service.generate(num=2, context=1, seed=3)
    b = service.generate(num=2, context=1, seed=3)
    c = service.generate(num=2, context=0, seed=4)
    assert a.shape == (2, 16, 16, 16, 1) and a.dtype == np.float32
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("kwargs,match", [
    (dict(num=0), "num must be"),
    (dict(num=33), "num must be"),
    (dict(sampler="euler"), "sampler must be"),
    (dict(sampler="ddim", sample_steps=0), "sample_steps must be"),
    (dict(sampler="dpmpp", sample_steps=9), "sample_steps must be"),
    (dict(guidance_scale=2.0), "cfg_dropout > 0"),
    (dict(guidance_scale=25.0), "guidance_scale must be"),
    (dict(context=2), "context must be"),
    (dict(context=-1), "context must be"),
])
def test_service_rejects(service, kwargs, match):
    with pytest.raises(ValueError, match=match):
        service.generate(**kwargs)


def test_service_decodes_with_deterministic_cudnn(service, monkeypatch):
    """A served request decodes with cuDNN's deterministic algorithms (on
    the card the bf16 decode repeats only with them) and leaves the
    caller's setting as it was; sampling alone decodes nothing."""
    model = service.trainer.model
    seen, decode = [], model.decode

    def recorded(latents):
        seen.append(torch.backends.cudnn.deterministic)
        return decode(latents)
    monkeypatch.setattr(model, "decode", recorded)
    before = torch.backends.cudnn.deterministic
    service.generate(num=1, context=1, seed=6, sampler="ddim",
                     sample_steps=2)
    assert seen == [True]
    assert torch.backends.cudnn.deterministic == before
    service.trainer.generate((1,) + SHAPE[1:], torch.tensor([1]),
                             generator=torch.Generator().manual_seed(0),
                             sampler="ddim", sample_steps=2, decode=False)
    assert seen == [True]


def test_unit_guidance_is_the_plain_chain(service):
    a = service.generate(num=1, context=1, seed=5, guidance_scale=1.0)
    b = service.generate(num=1, context=1, seed=5)
    np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionTrainer(flagship_cfg(tiny=True))
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("tiny", [False, True])
def test_port_config_copies_the_flagship(tiny):
    # Every field the port keeps has the JAX config's value.
    import dataclasses

    def same(port, ref, path):
        for f in dataclasses.fields(port):
            a, b = getattr(port, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(a):
                same(a, b, f"{path}.{f.name}")
            else:
                assert a == b, f"{path}.{f.name}: {a!r} != {b!r}"
    same(flagship_cfg(tiny), _flagship_cfg(tiny), "cfg")

"""The port's samplers against the JAX package, on the CPU.

The strided timestep tables of DDIM, DPM++(2M) and DPM++(2M) SDE; each
sampler of `DiffusionTrainer.generate` (DDPM down to `last_step`, DDIM at
eta 0 and 0.5, DPM++, DPM++ SDE) against JAX's `generate_fn` with JAX's
own draws injected, for EMA and raw weights, for eps- and v-prediction,
unguided and with classifier-free guidance; the refusals of guidance; and
the service's request validation against the JAX service's messages.

Both sides run the tiny flagship with cfg_dropout 0.1 (so that the null
context row exists), from one JAX-initialised float32 state perturbed with
seeded noise and carried over by `ldm3d_torch.convert`.

JAX's programs are compiled with LLVM's optimisation off (`FAST`): the
same HLO, compiled in about 1.5 s instead of 7 s, whose samples moved by
2e-7 of their largest value. The raw-weight cases run the EMA program on a
state whose EMA weights are the raw ones, so one program serves both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ldm3d.core.config import TrainConfig
from ldm3d.diffusion.ddpm import (sample_latents_ddim as j_ddim,
                                  sample_latents_dpmpp as j_dpmpp,
                                  sample_latents_dpmpp_sde as j_dpmpp_sde)
from ldm3d.diffusion.schedule import make_schedule as j_make_schedule
from ldm3d.serve import GenerationService as JService
from ldm3d.train.dm_trainer import DiffusionTrainer as JTrainer
from ldm3d_torch.convert import convert_state
from ldm3d_torch.core.config import TrainConfig as PTrainConfig
from ldm3d_torch.core.config import flagship_cfg
from ldm3d_torch.diffusion.ddpm import sampler_timesteps
from ldm3d_torch.serve import GenerationService
from ldm3d_torch.train.dm_trainer import DiffusionTrainer

SHAPE = (2, 4, 4, 4, 8)
CTX = np.array([1, 0], np.int32)
# Each case chains up to 8 tiny U-Net calls in float32, summed in other
# orders than XLA; each step amplifies an eps error by up to
# 1 / sqrt(abar_t) (at most 1.04 at T = 8) and guidance at scale 3 by
# |1 - s| + |s| = 5. 1e-5 of max |ref|, as for the DDPM chain in
# test_torch_generate.py.
REL_TOL = 1e-5
FAST = dict(xla_backend_optimization_level=0,
            xla_llvm_disable_expensive_passes=True)


def _compile(fn, *args):
    return fn.lower(*args).compile(compiler_options=FAST)


def _cfg_dropout(cfg, p=0.1):
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, cfg_dropout=p))


def _v(cfg):
    return dataclasses.replace(cfg, prediction_type="v")


@pytest.fixture(scope="module")
def sides():
    """JAX trainers (eps and v) over one perturbed float32 state with EMA
    weights, and port trainers (eps and v) loaded with its conversion."""
    cfg = _cfg_dropout(_flagship_cfg(tiny=True))
    tc = TrainConfig(batch_size=1, dtype="float32", ema_decay=0.9)
    tr = JTrainer(cfg, tc, conditional=True)
    st = _compile(jax.jit(tr.init_state, static_argnums=1),
                  jax.random.PRNGKey(0), (1, 16, 16, 16, 1))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def noisy(tree, scale):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a) + scale * rng.standard_normal(
                a.shape).astype(np.float32), tree)
    params = noisy(st.params, 0.02)
    stats = jax.tree_util.tree_map(
        lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
        st.batch_stats)
    st = st.replace(params=params, batch_stats=stats,
                    ema_params=noisy(params["unet"], 0.01))
    model_state, ema_state = convert_state(
        {"params": jax.device_get(st.params),
         "batch_stats": jax.device_get(st.batch_stats),
         "vq_stats": jax.device_get(st.vq_stats),
         "ema_params": jax.device_get(st.ema_params)})
    port_cfg = _cfg_dropout(flagship_cfg(tiny=True))
    ports = {}
    for ptype, pcfg in (("eps", port_cfg), ("v", _v(port_cfg))):
        tt = DiffusionTrainer(pcfg, device="cpu",
                              train_cfg=PTrainConfig(dtype="float32"))
        tt.load_state_dicts(model_state, ema_state)
        ports[ptype] = tt
    jax_tr = {"eps": tr, "v": JTrainer(_v(cfg), tc, conditional=True)}
    states = {True: st, False: st.replace(ema_params=st.params["unet"])}
    return jax_tr, states, ports, {}


def _jax_draws(key, sampler, steps, timesteps, last_step=0):
    """The JAX sampler's draws: split(key) -> x_T, then one split of the
    loop key per step (DDPM, DDIM, DPM++ SDE); DPM++ draws x_T only.
    DDPM's noise is keyed by timestep, the others' by step index."""
    init_rng, r = jax.random.split(key)
    x_t = torch.from_numpy(np.array(jax.random.normal(init_rng, SHAPE,
                                                      jnp.float32)))
    if sampler == "dpmpp":
        return x_t, None
    keys = (range(timesteps - 1, last_step - 1, -1) if sampler == "ddpm"
            else range(min(steps, timesteps)))
    noise = {}
    for k in keys:
        r, sub = jax.random.split(r)
        noise[k] = torch.from_numpy(np.array(jax.random.normal(
            sub, SHAPE, jnp.float32)))
    return x_t, noise.__getitem__


def _compare(sides, ptype, sampler, steps=None, eta=0.0, guidance=None,
             last_step=0, decode=False, use_ema=True, seed=5):
    jax_tr, states, ports, programs = sides
    tr, tt = jax_tr[ptype], ports[ptype]
    key = jax.random.PRNGKey(seed)
    args = (states[use_ema], key, jnp.asarray(CTX))
    spec = (ptype, sampler, steps, eta, guidance, last_step, decode)
    if spec not in programs:
        programs[spec] = _compile(tr.generate_fn(
            SHAPE, last_step=last_step, decode=decode, sampler=sampler,
            sample_steps=steps, eta=eta, guidance_scale=guidance), *args)
    ref = np.asarray(programs[spec](*args))
    x_t, noise = _jax_draws(key, sampler, steps, tt.cfg.timesteps,
                            last_step)
    out = tt.generate(SHAPE, torch.from_numpy(CTX), init_noise=x_t,
                      step_noise=noise, use_ema=use_ema, sampler=sampler,
                      sample_steps=steps, eta=eta, guidance_scale=guidance,
                      last_step=last_step, decode=decode).numpy()
    assert out.shape == ref.shape
    assert np.isfinite(ref).all()
    err = np.abs(out - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())
    return out


@pytest.mark.parametrize("timesteps,n", [(500, n) for n in (
    1, 2, 20, 25, 27, 39, 43, 50, 51, 53, 59, 77, 85, 500)]
    + [(8, n) for n in range(1, 9)])
def test_timestep_tables_match(timesteps, n):
    ref = jax.jit(lambda: jnp.linspace(0, timesteps - 1, n).round()
                  .astype(jnp.int32)[::-1])()
    assert sampler_timesteps(timesteps, n) == np.asarray(ref).tolist()


@pytest.mark.parametrize("j_sampler", [j_ddim, j_dpmpp, j_dpmpp_sde])
def test_jax_samplers_walk_the_table(j_sampler):
    # The timesteps the JAX samplers' U-Net calls really receive, at an n
    # where the exact quotient i / (n - 1) would give another table.
    seen = []

    def denoise(x, t):
        jax.debug.callback(lambda tt: seen.append(int(tt[0])), t)
        return jnp.zeros_like(x)
    jax.jit(lambda k: j_sampler(j_make_schedule(500), denoise,
                                (1, 1, 1, 1, 1), k, num_steps=51))(
        jax.random.PRNGKey(0)).block_until_ready()
    assert seen == sampler_timesteps(500, 51)


SAMPLER_CASES = {
    "ddim_eta0": dict(sampler="ddim", steps=5),
    "ddim_eta05": dict(sampler="ddim", steps=5, eta=0.5),
    "dpmpp": dict(sampler="dpmpp", steps=4),
    "dpmpp_sde": dict(sampler="dpmpp_sde", steps=6),
    "ddpm_last_step": dict(sampler="ddpm", last_step=3),
}


@pytest.mark.parametrize("use_ema", [True, False])
@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_matches_generate_fn(sides, case, use_ema):
    _compare(sides, "eps", use_ema=use_ema, **SAMPLER_CASES[case])


@pytest.mark.parametrize("case", ["ddim_eta05", "dpmpp_sde",
                                  "ddpm_last_step"])
def test_v_prediction_matches_generate_fn(sides, case):
    _compare(sides, "v", **SAMPLER_CASES[case])


@pytest.mark.parametrize("ptype,case,guidance,decode", [
    ("eps", "ddim_eta05", 3.0, True),     # guided and decoded
    ("eps", "ddim_eta0", 0.0, False),     # scale 0: the unconditional eps
    ("eps", "dpmpp_sde", 3.0, False),
    ("v", "dpmpp", 3.0, False),           # v converted on the 2B batch
])
def test_guidance_matches_generate_fn(sides, ptype, case, guidance, decode):
    _compare(sides, ptype, guidance=guidance, decode=decode,
             **SAMPLER_CASES[case])


def test_unit_guidance_is_the_conditional_eps(sides):
    # eps_u + 1 * (eps_c - eps_u) is eps_c, from a batch of 2B.
    tt = sides[2]["eps"]
    outs = [tt.generate(SHAPE, torch.from_numpy(CTX),
                        generator=torch.Generator().manual_seed(3),
                        sampler="ddim", sample_steps=4, decode=False,
                        guidance_scale=g).numpy() for g in (None, 1.0)]
    np.testing.assert_allclose(outs[1], outs[0], rtol=0,
                               atol=REL_TOL * np.abs(outs[0]).max())


@pytest.mark.parametrize("conditional,match", [
    (False, "requires a conditional model"),
    (True, "cfg_dropout > 0"),
])
def test_guidance_refusals(conditional, match):
    # Both packages refuse guidance without a learned null token.
    jcfg, cfg = _flagship_cfg(tiny=True), flagship_cfg(tiny=True)
    if not conditional:
        jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(
            jcfg.unet, context_dim=None))
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, context_dim=None))
    with pytest.raises(ValueError, match=match):
        JTrainer(jcfg, TrainConfig(batch_size=1, dtype="float32"),
                 conditional=conditional).generate_fn(SHAPE,
                                                      guidance_scale=2.0)
    tt = DiffusionTrainer(cfg, device="cpu")
    ctx = torch.from_numpy(CTX) if conditional else None
    with pytest.raises(ValueError, match=match):
        tt.generate(SHAPE, ctx, generator=torch.Generator().manual_seed(0),
                    sampler="ddim", guidance_scale=2.0)


def test_service_refuses_what_the_jax_service_refuses():
    # Validation runs before any weight is read, so the JAX service needs
    # no state here.
    cfg, jcfg = flagship_cfg(tiny=True), _flagship_cfg(tiny=True)
    port = GenerationService.from_random_init(cfg, seed=0, device="cpu")
    ref = JService(jcfg, None, conditional=True)
    bad = [dict(num=0), dict(num=33), dict(sampler="euler"),
           dict(sampler="ddim", sample_steps=0),
           dict(sampler="dpmpp_sde", sample_steps=9),
           dict(guidance_scale=-0.1), dict(guidance_scale=20.5),
           dict(guidance_scale=2.0), dict(context=2), dict(context=-1)]
    for req in bad:
        with pytest.raises(ValueError) as want:
            ref.generate(**req)
        with pytest.raises(ValueError) as got:
            port.generate(**req)
        assert str(got.value) == str(want.value), req


@pytest.mark.parametrize("sampler,steps", [("ddim", 5), ("dpmpp", 8),
                                           ("dpmpp_sde", 3)])
def test_service_serves_each_sampler_guided(sides, sampler, steps):
    svc = GenerationService(sides[2]["eps"].cfg, sides[2]["eps"])
    a = svc.generate(num=2, context=1, sampler=sampler, sample_steps=steps,
                     guidance_scale=3.04, seed=4)
    b = svc.generate(num=2, context=1, sampler=sampler, sample_steps=steps,
                     guidance_scale=3.0, seed=4)
    assert a.shape == (2, 16, 16, 16, 1) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)     # the scale is rounded to 0.1
    assert svc.compiled_signatures()[-1] == [2, sampler, steps, 3.0]

"""The port's latent-fidelity evaluation against the JAX package, on the CPU.

`ldm3d_torch.ops.fid` against `ldm3d.ops.fid` on seeded features;
`DiffusionTrainer.latent_features` against JAX's on the same volumes and
weights; and `fidelity_eval`: its keys against JAX's, and its scores and
per-class splits recomputed with JAX's functions from the same samples.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ldm3d.ops.fid as j_fid
from __graft_entry__ import _flagship_cfg
from ldm3d.core.config import TrainConfig
from ldm3d.train.dm_trainer import DiffusionTrainer as JTrainer
from ldm3d_torch.convert import convert_state
from ldm3d_torch.core.config import TrainConfig as PTrainConfig
from ldm3d_torch.core.config import flagship_cfg
from ldm3d_torch.ops import fid
from ldm3d_torch.train.dm_trainer import DiffusionTrainer

# The same float64 numpy code on the same inputs; 1e-12 relative leaves
# room for BLAS summing in another order across processes.
FID_RTOL = 1e-12
# A latent scale other than 1 so that the division of the features by it
# is exercised.
LATENT_SCALE = 2.5
LABELS = np.array([0, 0, 0, 1, 1, 1])
FAST = dict(xla_backend_optimization_level=0,
            xla_llvm_disable_expensive_passes=True)


def _features(seed, n, d=16):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) * rng.random(d) + rng.random(d)


@pytest.mark.parametrize("name,args", [
    ("pool_latent_features",
     (np.random.default_rng(1).standard_normal((5, 4, 4, 4, 8))
      .astype(np.float32),)),
    ("frechet_distance", (_features(2, 40), _features(3, 30))),
    ("kernel_mmd", (_features(4, 40), _features(5, 30))),
    ("kernel_mmd", (_features(4, 40), _features(5, 30), [0.5, 2.0])),
    ("latent_fidelity", (_features(6, 12), _features(7, 9))),
])
def test_fid_functions_match(name, args):
    out, ref = getattr(fid, name)(*args), getattr(j_fid, name)(*args)
    if isinstance(ref, dict):
        assert out.keys() == ref.keys()
        out, ref = list(out.values()), list(ref.values())
    np.testing.assert_allclose(out, ref, rtol=FID_RTOL, atol=0)


@pytest.fixture(scope="module")
def sides():
    """A JAX trainer state of the tiny flagship (float32, latent scale
    2.5), perturbed with seeded noise, and the port loaded with it."""
    cfg = dataclasses.replace(_flagship_cfg(tiny=True),
                              latent_scale=LATENT_SCALE)
    tr = JTrainer(cfg, TrainConfig(batch_size=1, dtype="float32"),
                  conditional=True)
    st = jax.jit(tr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(0), (1, 16, 16, 16, 1)).compile(
        compiler_options=FAST)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    st = st.replace(params=jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
            a.shape).astype(np.float32), st.params))
    model_state, _ = convert_state(
        {"params": jax.device_get(st.params),
         "batch_stats": jax.device_get(st.batch_stats),
         "vq_stats": jax.device_get(st.vq_stats)})
    tt = DiffusionTrainer(dataclasses.replace(
        flagship_cfg(tiny=True), latent_scale=LATENT_SCALE), device="cpu",
        train_cfg=PTrainConfig(dtype="float32"))
    tt.load_state_dicts(model_state)
    vols = np.random.default_rng(9).random((6, 16, 16, 16, 1),
                                           dtype=np.float32)
    return tr, st, tt, vols


def test_latent_features_match(sides):
    tr, st, tt, vols = sides
    ref = np.asarray(tr.latent_features(st, vols))
    out = tt.latent_features(torch.from_numpy(vols))
    assert out.shape == ref.shape == (6, 16) and out.dtype == np.float64
    # quantized codebook rows pooled in float64: the same picks give the
    # same features to float32 rounding of the rows' scaling
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_fidelity_eval_keys_and_splits(sides):
    tr, st, tt, vols = sides
    real = tt.latent_features(torch.from_numpy(vols))
    kw = dict(num_samples=6, batch=2, sampler="ddim", sample_steps=3)
    out = tt.fidelity_eval(real, torch.Generator().manual_seed(11),
                           real_ctx=LABELS, **kw)
    ref = tr.fidelity_eval(st, real, jax.random.PRNGKey(11),
                           real_ctx=LABELS, **kw)
    assert sorted(out) == sorted(ref)
    assert {"fid_same_c0", "fid_cross_c1", "fid_class_sep"} <= set(out)
    assert out["n_real"] == ref["n_real"] == 6
    assert out["n_gen"] == ref["n_gen"] == 6

    # The same samples again from the same seed: 3 per context in batches
    # of 2, the last batch cut to 1, in the diffusion space / latent_scale.
    gen = torch.Generator().manual_seed(11)
    feats = {}
    for c in (0, 1):
        ctx = torch.full((2,), c, dtype=torch.long)
        lats = [tt.generate((2, 4, 4, 4, 8), ctx, generator=gen,
                            sampler="ddim", sample_steps=3, decode=False)
                for _ in range(2)]
        lats = torch.cat(lats)[:3] / LATENT_SCALE
        feats[c] = j_fid.pool_latent_features(lats.numpy())
    want = j_fid.latent_fidelity(real, np.concatenate([feats[0], feats[1]]))
    seps = []
    for c in (0, 1):
        same, cross = real[LABELS == c], real[LABELS != c]
        want[f"fid_same_c{c}"] = j_fid.frechet_distance(same, feats[c])
        want[f"fid_cross_c{c}"] = j_fid.frechet_distance(cross, feats[c])
        seps.append(want[f"fid_cross_c{c}"] - want[f"fid_same_c{c}"])
    want["fid_class_sep"] = float(np.mean(seps))
    assert sorted(want) == sorted(out)
    for k in want:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], want[k], rtol=FID_RTOL, err_msg=k)


def test_fidelity_eval_skips_thin_classes(sides):
    # A context with fewer than 2 real rows on either side gets no split.
    _, _, tt, vols = sides
    real = tt.latent_features(torch.from_numpy(vols))
    out = tt.fidelity_eval(real, torch.Generator().manual_seed(3),
                           num_samples=2, batch=1, sample_steps=2,
                           real_ctx=np.array([0, 0, 0, 0, 0, 1]))
    assert "fid_same_c0" not in out and "fid_same_c1" not in out
    assert "fid_class_sep" not in out
    assert out["n_gen"] == 2

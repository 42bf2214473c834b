"""The port's checkpoints, snapshots, callbacks and loop, on the CPU.

- `CheckpointManager`: the cases of `tests/test_callbacks_checkpoint.py`
  in the port's form (round trip, epoch selection and retention,
  save_best_only, a pinned epoch that survives retention).
- Exact resume: two steps straight against one step, a save, a restore
  into a fresh trainer and one more step, bitwise (the step count and so
  the EMA warm-up, Adam's moments and the generator included).
- `save_state_npz` in the JAX package's layout both ways: a port snapshot
  loaded by JAX's `load_state_npz` into a tiny JAX trainer's template, and
  a JAX snapshot loaded by the port; DDIM samples of both sides from the
  restored state, with JAX's draws injected.
- `CSVLogger`, `MetricsLogger` and `ReduceLROnPlateau` against JAX's over
  one metric sequence; `fit` pinning and `fit_with_recovery`.
"""

import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.train import callbacks as jcb
from ldm3d.train.dm_trainer import DiffusionTrainer as JTrainer
from ldm3d.utils import export as jexport
from ldm3d_torch.convert import flatten, flax_state
from ldm3d_torch.core.config import TrainConfig, flagship_cfg
from ldm3d_torch.train import callbacks as cb
from ldm3d_torch.train.checkpoint import CheckpointManager
from ldm3d_torch.train.dm_trainer import DiffusionTrainer
from ldm3d_torch.train.loop import fit, fit_with_recovery
from ldm3d_torch.utils import export
from test_torch_samplers import CTX, FAST, SHAPE, _jax_draws
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# DDIM samples from one restored state on both sides: up to 8 tiny U-Net
# calls in float32 summed in other orders than XLA (as
# test_torch_samplers.py), 1e-5 of the largest value.
SAMPLE_REL_TOL = 1e-5
EMA_DECAY = 0.99


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 4, generator=g)}, "step": 7}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=3)
    st = _state()
    assert mgr.save(1, st)
    mgr.wait()
    restored, epoch = mgr.restore()
    assert epoch == 1 and restored["step"] == 7
    assert torch.equal(restored["params"]["w"], st["params"]["w"])
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["1.pt"]
    mgr.close()


def test_checkpoint_epoch_selection_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    for e in (1, 2, 3):
        mgr.save(e, _state(e))
    assert mgr.latest_epoch() == 3 and mgr.all_epochs() == [2, 3]
    st, epoch = mgr.restore(2)
    assert epoch == 2 and torch.equal(st["params"]["w"],
                                      _state(2)["params"]["w"])
    with pytest.raises(FileNotFoundError):
        mgr.restore(1)                       # evicted by keep=2
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_checkpoint_save_best_only(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_best_only=True)
    assert mgr.save(1, _state(), metric=1.0)
    assert not mgr.save(2, _state(), metric=1.5)   # worse: skipped
    assert mgr.save(3, _state(), metric=0.5)
    assert mgr.latest_epoch() == 3 and mgr.all_epochs() == [1, 3]


def test_checkpoint_pinned_epoch_survives_retention(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep=2)
    st = _state()
    mgr.save(1, st)
    mgr.save(3, st, pin="best_latent_fid")
    for e in (5, 7, 9):
        mgr.save(e, st)
    assert mgr.pinned() == {"best_latent_fid": 3}
    assert mgr.all_epochs() == [3, 7, 9]
    assert mgr.restore(3)[1] == 3
    for gone in (1, 5):
        with pytest.raises(FileNotFoundError):
            mgr.restore(gone)
    mgr2 = CheckpointManager(d, keep=2)      # the pin file is honoured
    assert mgr2.pinned() == {"best_latent_fid": 3}
    mgr2.save(11, st)
    assert mgr2.restore(3)[1] == 3
    mgr2.save(13, st, pin="best_latent_fid")  # the slot moves on
    mgr2.save(15, st)
    mgr2.save(17, st)
    with pytest.raises(FileNotFoundError):
        mgr2.restore(3)
    assert mgr2.all_epochs() == [13, 15, 17]


def _tiny_cfg():
    cfg = flagship_cfg(tiny=True)
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, cfg_dropout=0.5))


def _trainer(seed=0):
    tc = TrainConfig(dtype="float32", batch_size=2, learning_rate=1e-3,
                     ema_decay=EMA_DECAY,
                     seed=11)
    return DiffusionTrainer(_tiny_cfg(), device="cpu",
                            train_cfg=tc).init_random(seed, "reach")


def _batch(path):
    rng = np.random.default_rng(2)
    shape = (2, 16, 16, 16, 1) if path == "volume" else SHAPE
    x = torch.from_numpy(rng.random(shape, dtype=np.float32))
    return x, torch.tensor([1, 0])


def _step(tr, path, x, ctx):
    fn = tr.train_step if path == "volume" else tr.train_step_latents
    return {k: float(v) for k, v in fn(x, ctx).items()}


def _everything(tr):
    """Every number of a trainer's state, flattened, for bitwise checks."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, torch.Tensor):
            out[prefix] = v.detach().clone()
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}/{i}", x)
        else:
            out[prefix] = v
    walk("", tr.state_dict())
    return out


@pytest.mark.parametrize("path", ["latents", "volume"])
def test_resume_is_exact(tmp_path, path):
    """Two steps straight equal one step, a save, a restore into a fresh
    trainer and one step, bitwise: the step count (and so the EMA
    warm-up d = min(decay, (1 + n) / (10 + n))), Adam's state and the
    generator's draws all survive the checkpoint."""
    x, ctx = _batch(path)
    straight = _trainer()
    m_straight = [_step(straight, path, x, ctx) for _ in range(2)]

    first = _trainer()
    m_first = _step(first, path, x, ctx)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, first.state_dict())
    fresh = _trainer(seed=99)                 # other weights, step 0
    state, epoch = mgr.restore()
    fresh.load_state_dict(state)
    assert epoch == 1 and fresh.step == 1
    m_second = _step(fresh, path, x, ctx)

    assert [m_first, m_second] == m_straight
    a, b = _everything(straight), _everything(fresh)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert fresh.step == 2


def test_load_state_dict_without_optimizer(tmp_path):
    tr = _trainer()
    _step(tr, "latents", *_batch("latents"))
    other = _trainer(seed=5)
    other.load_state_dict(tr.state_dict(), optimizer=False)
    assert other.optimizer is None and other.ema_unet is not None
    for p, q in zip(tr.ema_unet.parameters(), other.ema_unet.parameters()):
        assert torch.equal(p, q)


@pytest.fixture(scope="module")
def jax_side():
    """A tiny JAX trainer's state with EMA weights (float32), its snapshot
    template, and the DDIM program of the comparison."""
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), unet=(
        dataclasses.replace(_flagship_cfg(tiny=True).unet, cfg_dropout=0.5)))
    tr = JTrainer(cfg, JTrainConfig(batch_size=2, dtype="float32",
                                    ema_decay=EMA_DECAY), conditional=True)
    init = jax.jit(tr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(0), (2, 16, 16, 16, 1)).compile(
        compiler_options=FAST)
    st = init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    st = st.replace(
        params=jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
                a.shape).astype(np.float32), st.params),
        batch_stats=jax.tree_util.tree_map(
            lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
            st.batch_stats),
        ema_params=jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.01 * rng.standard_normal(
                a.shape).astype(np.float32), st.params["unet"]))
    key = jax.random.PRNGKey(6)
    gen = jax.jit(tr.generate_fn(SHAPE, decode=False, sampler="ddim",
                                 sample_steps=3)).lower(
        st, key, jnp.asarray(CTX)).compile(compiler_options=FAST)
    return tr, st, init, gen, key


def _port_sample(tt, key):
    x_t, noise = _jax_draws(key, "ddim", 3, tt.cfg.timesteps)
    return tt.generate(SHAPE, torch.from_numpy(CTX), init_noise=x_t,
                       step_noise=noise, sampler="ddim", sample_steps=3,
                       decode=False).numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_port_snapshot_loads_in_jax(tmp_path, jax_side):
    tr, _, init, gen, key = jax_side
    tt = _trainer()
    _step(tt, "latents", *_batch("latents"))   # makes the EMA copy
    path = str(tmp_path / "port.npz")
    meta = export.save_state_npz(path, tt, {"epoch": 3})
    assert meta["collections"] == ["batch_stats", "ema_params", "params",
                                   "vq_stats"]
    assert jexport.load_meta_npz(path)["epoch"] == 3
    template = init(jax.random.PRNGKey(9))
    restored = jexport.load_state_npz(path, template)
    # every array the port wrote is one JAX reads, in the flax layout
    with np.load(path) as z:
        keys = {k for k in z.files if k != "__meta__"}
    jflat = {f"{c}/{k}" for c in ("params", "batch_stats", "vq_stats")
             for k in flatten(jax.device_get(getattr(restored, c)))}
    jflat |= {f"ema_params/{k}"
              for k in flatten(jax.device_get(restored.ema_params))}
    assert keys == jflat
    # the port, reloaded from its own float16 snapshot, samples as JAX
    twin = export.load_state_npz(path, _trainer(seed=4))
    ref = np.asarray(gen(restored, key, jnp.asarray(CTX)))
    assert _rel(_port_sample(twin, key), ref) <= SAMPLE_REL_TOL


def test_jax_snapshot_loads_in_port(tmp_path, jax_side):
    tr, st, _, gen, key = jax_side
    path = str(tmp_path / "jax.npz")
    jexport.save_state_npz(path, st, {"epoch": 5})
    assert export.load_meta_npz(path)["epoch"] == 5
    tt = export.load_state_npz(path, _trainer(seed=3))
    assert tt.ema_unet is not None
    # the port holds the snapshot's float16 values exactly
    with np.load(path) as z:
        ema = {k.split("/", 1)[1]: z[k] for k in z.files
               if k.startswith("ema_params/")}
    for k, a in flax_state(tt.ema_unet)["params"].items():
        np.testing.assert_array_equal(a, ema[k].astype(np.float32))
    restored = jexport.load_state_npz(path, st)
    ref = np.asarray(gen(restored, key, jnp.asarray(CTX)))
    assert _rel(_port_sample(tt, key), ref) <= SAMPLE_REL_TOL


def test_snapshot_loading_is_strict(tmp_path, jax_side):
    _, st, _, _, _ = jax_side
    path = str(tmp_path / "jax.npz")
    jexport.save_state_npz(path, st, {})
    no_ema = DiffusionTrainer(_tiny_cfg(), device="cpu")
    with pytest.raises(ValueError, match="ema_params"):
        export.load_state_npz(path, no_ema)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    dropped = dict(arrays)
    del dropped["params/vqvae/encoder/down_0/kernel"]
    np.savez(str(tmp_path / "missing.npz"), **dropped)
    with pytest.raises(KeyError, match="down_0"):
        export.load_state_npz(str(tmp_path / "missing.npz"), _trainer())
    shaped = dict(arrays)
    shaped["params/vqvae/encoder/down_0/kernel"] = np.zeros((1, 2, 3),
                                                            np.float16)
    np.savez(str(tmp_path / "shaped.npz"), **shaped)
    with pytest.raises(ValueError, match="shape"):
        export.load_state_npz(str(tmp_path / "shaped.npz"), _trainer())
    extra = dict(arrays)
    extra["params/unet/extra/kernel"] = np.zeros((2,), np.float16)
    np.savez(str(tmp_path / "extra.npz"), **extra)
    with pytest.raises(ValueError, match="does not"):
        export.load_state_npz(str(tmp_path / "extra.npz"), _trainer())


# one metric sequence for the loggers and the plateau scheduler: a late
# column, a plateau, improvements, and the min_lr floor
_METRICS = [{"loss": 1.0}, {"loss": 1.0, "latent_fid": 12.0},
            {"loss": 1.0}, {"loss": 0.5}, {"loss": 0.5, "latent_fid": 9.5},
            {"loss": 0.5}, {"loss": 0.5}, {"loss": 0.5}, {"loss": 0.5}]


def test_csv_logger_bytes_match_jax(tmp_path):
    paths = {}
    for name, mod in (("port", cb), ("jax", jcb)):
        path = str(tmp_path / name / "training.log")
        log = mod.CSVLogger(path)
        for e, m in enumerate(_METRICS[:5]):
            log(e, m)
        resumed = mod.CSVLogger(path, append=True)
        for e, m in enumerate(_METRICS[5:], start=5):
            resumed(e, m)
        paths[name] = path
    with open(paths["port"], "rb") as f:
        port = f.read()
    with open(paths["jax"], "rb") as f:
        assert port == f.read()
    rows = list(csv.DictReader(open(paths["port"])))
    assert len(rows) == len(_METRICS) and rows[0]["latent_fid"] == ""
    from ldm3d.utils.visualize import read_training_log
    assert np.isnan(read_training_log(paths["port"])["latent_fid"][0])


def test_metrics_logger_records_match_jax(tmp_path):
    recs = {}
    for name, mod in (("port", cb), ("jax", jcb)):
        path = str(tmp_path / f"{name}.jsonl")
        log = mod.MetricsLogger(path, run_name="r1")
        for e, m in enumerate(_METRICS):
            log(e, m)
        log(9, {"loss": 0.4}, prefix="val_")
        recs[name] = [json.loads(line) for line in open(path)]
    for p, j in zip(recs["port"], recs["jax"]):
        assert list(p) == list(j)
        p.pop("time"), j.pop("time")
        assert p == j
    assert len(recs["port"]) == len(_METRICS) + 1


@pytest.mark.parametrize("delayed", [False, True])
def test_reduce_lr_on_plateau_matches_jax(delayed):
    kw = dict(monitor="loss", factor=0.5, patience=2, min_lr=2.6e-4)
    if delayed:
        port = cb.DelayedReduceLROnPlateau(start_epoch=2, **kw)
        ref = jcb.DelayedReduceLROnPlateau(start_epoch=2, **kw)
    else:
        port, ref = cb.ReduceLROnPlateau(**kw), jcb.ReduceLROnPlateau(**kw)
    # the learning rate as inject_hyperparams holds it: float32
    opt = torch.optim.Adam([torch.zeros(3, requires_grad=True)],
                           lr=float(np.float32(1e-3)))
    jstate = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3).init(
        {"w": jnp.zeros((3,))})
    got, want = [], []
    for e, m in enumerate(_METRICS):
        opt, red = port(e, m, opt)
        jstate, jred = ref(e, m, jstate)
        got.append((red, cb.get_learning_rate(opt)))
        want.append((jred, jcb.get_learning_rate(jstate)))
    assert got == want
    assert any(r for r, _ in got)


class _FakeTrainer:
    """A trainer of one number, with the port trainer's state API."""

    def __init__(self):
        self.w = torch.zeros(())
        self.step = 0
        self.optimizer = None

    def state_dict(self):
        return {"w": self.w.clone(), "step": self.step}

    def load_state_dict(self, state):
        self.w, self.step = state["w"].clone(), int(state["step"])

    def train_step(self, vol, ctx):
        self.w += 1.0
        self.step += 1
        return {"loss": torch.tensor(1.0)}


def test_fit_pins_best_metric_epoch(tmp_path):
    psnr = {1: 30.0, 2: 35.0, 3: 31.0, 4: 29.0, 5: 28.0, 6: 27.0}
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep=1)
    tr = _FakeTrainer()
    metrics = fit(tr, [(None, None, None)], 6, ckpt=ckpt, ckpt_freq=100,
                  epoch_callback=lambda e, t: {"val_psnr": psnr[e + 1]},
                  verbose=False)
    assert ckpt.pinned() == {"best_val_psnr": 2}
    assert ckpt.all_epochs() == [2, 6]
    assert ckpt.restore(2)[0]["step"] == 2 and metrics["loss"] == 1.0


def test_fit_with_recovery_resumes_from_checkpoint(tmp_path):
    tr = _FakeTrainer()
    crashes = {"n": 0}

    def step_fn(batch):
        # crash once at step 3 (epoch 1), after epoch 0 checkpointed
        if tr.step == 3 and crashes["n"] == 0:
            crashes["n"] += 1
            raise RuntimeError("injected fault")
        return tr.train_step(*batch[::2])

    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=3)
    fit_with_recovery(tr, [(None, None, None)] * 2, 3, ckpt=mgr,
                      max_restarts=1, step_fn=step_fn, verbose=False)
    assert crashes["n"] == 1
    assert tr.step == 6 and float(tr.w) == 6.0   # the rolled-back step
    assert mgr.latest_epoch() == 3               # was replayed

"""The port's tools (`ldm3d_torch/tools/`) against the JAX package and the
JAX tools, on the CPU at `smoke_cond`'s widths on 16^3 volumes.

One module-scoped run of the port's command line trains a conditional
checkpoint (cfg_dropout 0.1, EMA, `--fidelity_freq 1`, two epochs), runs a
`--fidelity_sweep --fidelity_by_class` and exports a snapshot with
`export_flagship` (the flagship config patched to the run's widths). Then:
- the best-FID epoch and the logged fidelity against `bench.py`'s own
  helpers on the same `metrics.jsonl`; the snapshot loaded by the JAX
  package's `load_state_npz` (strict) into a template built with
  `bench._apply_meta` of the snapshot's meta; the fallback to the latest
  epoch; a request served from the snapshot against one served from the
  checkpoint with its weights rounded to float16 and one served from the
  snapshot JAX writes back, bit for bit;
- `recalibrate_bn` against JAX's `VQTrainer.recalibrate_batch_stats` on
  the batches the tool read (from the cache and from the on-device
  synthetic source), weights bit for bit unchanged;
- `context_effect`'s distances and `r5_diag`'s probe A against the same
  computations on JAX's `DiffusionTrainer` with the snapshot's weights;
  both tools' `main` end to end;
- `emit_sbatch`'s forms as `tests/test_emit_sbatch.py` checks the JAX
  tool's, with one process per card;
- the report tools' text equal to the JAX tools' on a `training.log` the
  port's `CSVLogger` wrote, and `tools/conditioning_ab.py` over the port's
  fidelity-sweep JSON.
JAX programs compile with LLVM optimisation off (`FAST`).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ldm3d.core import presets as jpresets
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.diffusion.schedule import model_out_to_eps as j_model_out_to_eps
from ldm3d.diffusion.schedule import q_sample as j_q_sample
from ldm3d.train.dm_trainer import DiffusionTrainer as JTrainer
from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
from ldm3d.utils import export as jexport
from ldm3d_torch.cli import main as cli
from ldm3d_torch.core import presets
from ldm3d_torch.core.config import (DataConfig, ExperimentConfig,
                                     TrainConfig, replace)
from ldm3d_torch.core.presets import get_preset
from ldm3d_torch.serve import server_from_args
from ldm3d_torch.tools import (context_effect, dm_comparison, emit_sbatch,
                               export_flagship, gan_ab, quality_report,
                               r5_diag, recalibrate_bn)
from ldm3d_torch.train import meta as tmeta
from ldm3d_torch.train.callbacks import CSVLogger
from ldm3d_torch.train.checkpoint import CheckpointManager
from ldm3d_torch.train.meta import adopt_meta
from ldm3d_torch.train.vq_trainer import VQTrainer
from ldm3d_torch.utils.export import load_meta_npz
from test_torch_samplers import FAST
from test_torch_vq_trainer import STATS_ATOL, STATS_RTOL, _cfgs, _model_state
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# context_effect's distances: |eps_a - eps_b| / |eps_0| of a tiny float32
# U-Net, the eps differences 2-7 % of eps, so eps's float32 error (1e-6
# of it, summed in other orders than XLA) is up to 5e-5 of a distance.
DIST_RTOL = 1e-4
# Probe A's eps-MSE: a mean over 2 x 4^3 x 8 squared errors of the same
# float32 U-Net, as the samplers' eps (tests/test_torch_samplers.py).
MSE_RTOL = 1e-5
B = 2


def _smoke_diffusion():
    """smoke_cond's diffusion model with the null token the run trains."""
    d = get_preset("smoke_cond").diffusion
    return replace(d, unet=replace(d.unet, cfg_dropout=0.1))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A trained smoke_cond run from the port's CLI (checkpoints of epochs
    1 and 2, metrics.jsonl with latent_fid rows, training.log, a
    fidelity-sweep JSON) and the snapshot `export_flagship` wrote of it."""
    d = str(tmp_path_factory.mktemp("tools"))
    base = ["--preset", "smoke_cond", "--platform", "cpu",
            "--cache_dir", d + "/cache", "--ckpt_dir", d + "/ckpt",
            "--out_dir", d + "/out", "--val_perc", "0.34",
            "--cfg_dropout", "0.1", "--ema_decay", "0.9", "--lbs", "2"]
    cli.main(base + ["--create_dataset", "--synthetic", "--num_synthetic",
                     "6"])
    cli.main(base + ["--train_dm", "--cache_latents", "--epochs", "2",
                     "--fidelity_freq", "1", "--fidelity_samples", "4"])
    # every volume's features (no held-out split): two rows or more of
    # each class on each side of the per-class FID
    cli.main(base + ["--fidelity_sweep", "--fidelity_samples", "4",
                     "--sweep_samplers", "ddim:2", "--guidance_grid",
                     "none,3", "--fidelity_by_class", "--val_perc", "0"])
    dm = d + "/ckpt/smoke_cond_dm"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(export_flagship, "flagship_cfg", _smoke_diffusion)
        written = export_flagship.main(["--ckpt", dm, "--out",
                                        d + "/snap/f16.npz",
                                        "--platform", "cpu"])
    return dict(dir=d, dm=dm, npz=d + "/snap/f16.npz", meta=written,
                cache=d + "/cache")


# -- bench.py's helpers --------------------------------------------------

def _rows(*fids, malformed=False):
    out = [json.dumps({"run": "r", "step": 0, "loss": 1.0})]
    for step, fid in fids:
        out.append(json.dumps({"run": "r", "step": step, "latent_fid": fid,
                               "latent_mmd": fid / 10,
                               "fid_class_sep": -fid / 100}))
    if malformed:
        out.insert(1, "{not json")
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("saved,rows", [
    ((1, 2, 3), _rows((0, 5.0), (1, 3.25), (2, 4.0))),       # epoch 2
    ((1, 3), _rows((0, 5.0), (1, 3.25), (2, 4.0), malformed=True)),
    ((2,), _rows((0, 5.0))),                                  # unsaved
    ((1, 2), _rows()),                                        # no rows
    ((1, 2), None),                                           # no file
])
def test_best_fid_epoch_and_fidelity_match_bench(tmp_path, saved, rows):
    for ep in saved:       # the port's checkpoint files, orbax's dirs
        (tmp_path / f"{ep}.pt").write_bytes(b"")
        (tmp_path / str(ep)).mkdir()
    if rows is not None:
        (tmp_path / "metrics.jsonl").write_text(rows)
    best = tmeta.best_fid_epoch(str(tmp_path))
    assert best == bench._best_fid_epoch(str(tmp_path))
    for ep in (best or max(saved), 1, 3):
        assert tmeta.fidelity_from_jsonl(str(tmp_path), ep) \
            == bench._fidelity_from_jsonl(str(tmp_path), ep)


# -- export_flagship -----------------------------------------------------

def _jax_trainer(meta):
    """JAX's DiffusionTrainer of smoke_cond with the snapshot's meta applied
    by `bench._apply_meta`, float32, and its state's template."""
    cfg = bench._apply_meta(jpresets.get_preset("smoke_cond").diffusion,
                            meta)
    tr = JTrainer(cfg, JTrainConfig(batch_size=1, dtype="float32",
                                    ema_decay=float(meta["ema_decay"])),
                  conditional=True)
    init = jax.jit(tr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(0), (1, 16, 16, 16, 1)).compile(
        compiler_options=FAST)
    return tr, init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_side(run):
    """JAX's trainer and the snapshot loaded into its template (strict)."""
    tr, template = _jax_trainer(load_meta_npz(run["npz"]))
    return tr, template, jexport.load_state_npz(run["npz"], template)


def test_export_snapshot_loads_in_jax(run, jax_side):
    _, template, st = jax_side
    want = {}
    for coll in ("params", "ema_params", "vq_stats", "batch_stats"):
        for k, a in jexport._flatten(getattr(template, coll)).items():
            want[f"{coll}/{k}"] = a.shape
    with np.load(run["npz"]) as z:
        got = {k: z[k] for k in z.files if k != "__meta__"}
    assert {k: a.shape for k, a in got.items()} == want
    assert all(a.dtype in (np.float16, np.bool_) for a in got.values())
    restored = {}
    for coll in ("params", "ema_params", "vq_stats", "batch_stats"):
        for k, a in jexport._flatten(getattr(st, coll)).items():
            restored[f"{coll}/{k}"] = a
    for k, a in got.items():   # JAX holds the snapshot's values exactly
        np.testing.assert_array_equal(restored[k], a.astype(
            restored[k].dtype), err_msg=k)
    # the meta: the best-FID epoch, its source and fidelity, train_meta
    meta = run["meta"]
    assert load_meta_npz(run["npz"]) == meta
    assert meta["epoch"] == tmeta.best_fid_epoch(run["dm"]) is not None
    assert meta["source_ckpt"] == os.path.relpath(run["dm"], REPO)
    for k, v in bench._fidelity_from_jsonl(run["dm"], meta["epoch"]).items():
        assert meta[k] == v, k
    with open(os.path.join(run["dm"], "train_meta.json")) as f:
        for k, v in json.load(f).items():
            assert meta[k] == v, k


def test_export_falls_back_to_the_latest_epoch(run, tmp_path, monkeypatch):
    ckpt = tmp_path / "no_fidelity_dm"
    ckpt.mkdir()
    for name in ("1.pt", "2.pt", "train_meta.json"):
        shutil.copy(os.path.join(run["dm"], name), ckpt / name)
    monkeypatch.setattr(export_flagship, "flagship_cfg", _smoke_diffusion)
    meta = export_flagship.main(["--ckpt", str(ckpt), "--out",
                                 str(tmp_path / "s.npz"),
                                 "--platform", "cpu"])
    assert meta["epoch"] == 2 and "latent_fid" not in meta
    meta = export_flagship.main(["--ckpt", str(ckpt), "--out",
                                 str(tmp_path / "s1.npz"), "--epoch", "1",
                                 "--platform", "cpu"])
    assert meta["epoch"] == 1


def test_snapshot_serves_as_the_checkpoint_rounded_to_float16(
        run, jax_side, tmp_path):
    """The serve CLI's service over the snapshot against its service over
    the exported epoch's checkpoint with every float rounded to float16,
    and over the snapshot JAX writes of the state it loaded from the
    port's: the same weights, so the same request gives the same volumes,
    bit for bit."""
    common = ["--preset", "smoke_cond", "--platform", "cpu", "--port", "0"]
    snap, server = server_from_args(common + ["--ckpt_dir", run["npz"]])
    server.server_close()
    jax_npz = str(tmp_path / "jax.npz")
    jexport.save_state_npz(jax_npz, jax_side[2], load_meta_npz(run["npz"]))
    via_jax, server = server_from_args(common + ["--ckpt_dir", jax_npz])
    server.server_close()
    ckpt, server = server_from_args(common + [
        "--ckpt_dir", run["dm"], "--epoch", str(run["meta"]["epoch"])])
    server.server_close()
    assert snap.epoch == ckpt.epoch and snap.trainer.ema_unet is not None
    with torch.no_grad():
        for module in (ckpt.trainer.model, ckpt.trainer.ema_unet):
            for t in module.state_dict().values():
                if t.is_floating_point():
                    t.copy_(t.half().float())
    for req in (dict(num=2, context=1, sampler="ddim", sample_steps=3,
                     guidance_scale=3.0, seed=5),
                dict(num=1, context=0, seed=9)):
        a, b = snap.generate(**req), ckpt.generate(**req)
        assert np.isfinite(a).all() and a.shape == (req["num"], 16, 16,
                                                    16, 1)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, via_jax.generate(**req))


# -- recalibrate_bn ------------------------------------------------------

class _Recorded:
    """The loader the tool passed, recording each pass's batches."""

    def __init__(self, loader):
        self.loader, self.passes = loader, []

    def __iter__(self):
        self.passes.append([])
        for batch in self.loader:
            self.passes[-1].append(tuple(np.array(x.cpu())
                                         for x in batch[:2]))
            yield batch


class _Replay:
    """The recorded passes, one per iteration, as JAX batches."""

    def __init__(self, passes):
        self.passes = list(passes)

    def __iter__(self):
        for vol, mask in self.passes.pop(0):
            yield jnp.asarray(vol), jnp.asarray(mask), None


@pytest.mark.parametrize("source", ["cache", "num_synthetic"])
def test_recalibrate_bn_matches_jax(run, tmp_path, monkeypatch, source):
    jcfg, tcfg = _cfgs("ste", 1)   # BatchNorm, no dropout: no draws
    tc = TrainConfig(batch_size=B, dtype="float32")
    jtr = JVQTrainer(jcfg, JTrainConfig(batch_size=B, dtype="float32"))
    st = jax.jit(jtr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(2), (B, 16, 16, 16, 1)).compile(
        compiler_options=FAST)(jax.random.PRNGKey(2))
    tt = VQTrainer(tcfg, tc, device="cpu")
    tt.model.load_state_dict(_model_state(st), strict=True)
    ckpt = str(tmp_path / "s1_vq")
    CheckpointManager(ckpt).save(4, tt.state_dict())
    monkeypatch.setitem(presets._REGISTRY, "tools_bn", lambda: (
        ExperimentConfig(name="tools_bn", vqvae=tcfg, train=tc,
                         data=DataConfig(volume_size=16))))
    recorded = []
    real = VQTrainer.recalibrate_batch_stats

    def record(self, loader, passes=3):
        recorded.append(_Recorded(loader))
        return real(self, recorded[-1], passes)
    monkeypatch.setattr(VQTrainer, "recalibrate_batch_stats", record)
    argv = ["--preset", "tools_bn", "--ckpt_dir", ckpt + "/",
            "--cache_dir", run["cache"], "--lbs", str(B), "--passes", "2",
            "--platform", "cpu"]
    if source == "num_synthetic":
        argv += ["--num_synthetic", "6"]
    out = recalibrate_bn.main(argv)
    assert out == ckpt + "_bnr"      # the JAX tool's directory and epoch
    assert CheckpointManager(out).all_epochs() == [4]
    passes = recorded[0].passes
    assert len(passes) == 2 and len(passes[0]) >= 2

    st2 = jtr.recalibrate_batch_stats(st, _Replay(passes), passes=2)
    got, _ = CheckpointManager(out).restore(4)
    before, _ = CheckpointManager(ckpt).restore(4)
    want = _model_state(st2)
    moved = 0
    for k, t in got["model"].items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=k)
            moved += not torch.equal(t, before["model"][k])
        else:  # weights and the quantizer's buffers, bit for bit
            assert torch.equal(t, before["model"][k]), k
    assert moved > 0
    assert got["step"] == before["step"]
    assert torch.equal(got["generator"], before["generator"])
    for k, s in got["optimizer"]["state"].items():
        for name, v in s.items():
            assert torch.equal(v, before["optimizer"]["state"][k][name])


# -- context_effect and r5_diag --------------------------------------------

@pytest.fixture(scope="module")
def port_side(run):
    """The port's trainer over the snapshot, float32, as context_effect
    restores it."""
    cfg = adopt_meta(ExperimentConfig(diffusion=_smoke_diffusion()),
                     argparse.Namespace(), load_meta_npz(run["npz"]))
    tt, epoch = context_effect.restore(
        run["npz"], cfg.diffusion, TrainConfig(dtype="float32"), "cpu")
    assert epoch == run["meta"]["epoch"] and tt.ema_unet is not None
    return tt


def _jax_eps(jtr, st):
    variables = jtr._apply_variables(st, unet_params=st.ema_params)

    def eps(x, t, ctx):
        out = jtr.model.apply(variables, x, t, ctx, training=False,
                              method="denoise")
        return j_model_out_to_eps(jtr.sched, x, t, out,
                                  jtr.cfg.prediction_type)
    x = jnp.zeros((B, 4, 4, 4, 8), jnp.float32)
    t = jnp.zeros((B,), jnp.int32)
    compiled = jax.jit(eps).lower(x, t, t).compile(compiler_options=FAST)
    return lambda x, t, c: np.asarray(compiled(x, t, c))


def test_context_effect_matches_jax(run, jax_side, port_side):
    jtr, _, st = jax_side
    jeps = _jax_eps(jtr, st)
    eps = context_effect.eps_fn(port_side)
    ncls, null = 2, port_side.cfg.unet.context_dim + 1
    rng = np.random.default_rng(11)
    for tval in (0, 3, 7):
        x = rng.standard_normal((B, 4, 4, 4, 8)).astype(np.float32)
        got = context_effect.distances(eps, torch.from_numpy(x), tval,
                                       ncls, null)
        t = np.full((B,), tval, np.int32)
        es = [jeps(x, t, np.full((B,), c, np.int32)) for c in range(ncls)]
        en = jeps(x, t, np.full((B,), null, np.int32))
        n0 = np.linalg.norm(es[0])
        want = (np.linalg.norm(es[0] - es[1]) / n0,
                np.mean([np.linalg.norm(e - en) / n0 for e in es]))
        np.testing.assert_allclose(got, want, rtol=DIST_RTOL)
        assert got[0] > 0 and got[1] > 0


def test_context_effect_runs_on_checkpoint_and_snapshot(run, monkeypatch,
                                                        capsys):
    monkeypatch.setattr(context_effect, "flagship_cfg", _smoke_diffusion)
    for ckpt, epoch in ((run["dm"], 2), (run["npz"], run["meta"]["epoch"])):
        rows = context_effect.main(["--ckpt", ckpt, "--batch", "2",
                                    "--platform", "cpu"])
        out = capsys.readouterr().out
        assert f"# restored epoch {epoch} from {ckpt}" in out
        assert "# context embedding table context_embed.weight (3," in out
        assert [r[0] for r in rows] == [0, 1, 3, 5, 6]      # T = 8
        assert all(np.isfinite(r[1:]).all() and min(r[1:]) > 0
                   for r in rows)


def test_r5_probe_a_matches_jax(jax_side, port_side):
    jtr, _, st = jax_side
    variables = jtr._apply_variables(st, unet_params=st.ema_params)

    def probe(lat, ctx, t, noise):
        noisy = j_q_sample(jtr.sched, lat, t, noise)
        pred = jtr.model.apply(variables, noisy, t, ctx, training=False,
                               method="denoise")
        return jnp.mean(jnp.square(noise - pred))
    rng = np.random.default_rng(12)
    lat = rng.standard_normal((B, 4, 4, 4, 8)).astype(np.float32)
    ctx = np.array([1, 0], np.int32)
    t0 = np.zeros((B,), np.int32)
    compiled = jax.jit(probe).lower(lat, ctx, t0, lat).compile(
        compiler_options=FAST)
    assert r5_diag.buckets(8) == [0, 1, 3, 4, 6, 7]
    assert r5_diag.buckets(500) == list(r5_diag.BUCKETS)
    for tv in r5_diag.buckets(8)[::2]:
        noise = rng.standard_normal(lat.shape).astype(np.float32)
        t = np.full((B,), tv, np.int32)
        got = r5_diag.bucket_mse(port_side, port_side.ema_unet,
                                 torch.from_numpy(lat),
                                 torch.from_numpy(ctx).long(),
                                 torch.from_numpy(t).long(),
                                 torch.from_numpy(noise))
        np.testing.assert_allclose(got, float(compiled(lat, ctx, t, noise)),
                                   rtol=MSE_RTOL)


def test_r5_diag_runs_its_probes(run, tmp_path, capsys):
    cfg = get_preset("smoke_cond")
    s1 = str(tmp_path / "s1_vq")
    CheckpointManager(s1).save(1, VQTrainer(
        cfg.diffusion.vqvae, cfg.train, device="cpu").init_random(0)
        .state_dict())
    r5_diag.main(["--skip", "w", "--overfit_steps", "2", "--arm_epochs",
                  "1", "--crawl_ckpt", run["dm"], "--platform", "cpu",
                  "--preset", "smoke_cond", "--norm", "batch",
                  "--num_classes", "2", "--num_synthetic", "6",
                  "--cache_dir", run["cache"], "--vqvae_load_ckpt", s1,
                  "--ckpt_dir", str(tmp_path / "diag"), "--timesteps", "8",
                  "--lbs", "2", "--val_perc", "0.34"])
    out = capsys.readouterr().out
    for line in ("stage-1 weights from epoch 1", "crawl checkpoint epoch 2",
                 "[crawl ep2 raw] t-bucket eps-MSE:",
                 "[crawl ep2 ema] t-bucket eps-MSE:",
                 "[overfit b1 lr=0.0001] step     1",
                 "[overfit lr1e-3] t-bucket eps-MSE:",
                 "[overfit GN lr1e-4] t-bucket eps-MSE:",
                 "[arm lr=0.001] epoch 1/1", "[arm lr=0.001 raw]"):
        assert line in out, line
    mses = [float(m) for m in re.findall(r"mse=([0-9.naif]+)", out)]
    assert len(mses) >= 6 * 6 and np.isfinite(mses).all()


# -- emit_sbatch -----------------------------------------------------------

def test_emit_single_node(tmp_path):
    out = tmp_path / "sb_vqgan.sbatch"
    emit_sbatch.main(["--preset", "vqgan_attn", "--out", str(out)])
    text = out.read_text()
    assert "#SBATCH --nodes=1" in text
    assert "#SBATCH --ntasks-per-node=1" in text
    assert "#SBATCH --gres=gpu:1" in text
    assert "--preset vqgan_attn" in text
    assert "--train_vq" in text and "--disc_threshold 40" in text
    assert "srun python -m ldm3d_torch.cli.main" in text
    assert "--coordinator" not in text


@pytest.mark.parametrize("nodes,gpus", [(4, 1), (1, 4), (2, 8)])
def test_emit_multi_process_wires_distributed(tmp_path, nodes, gpus):
    out = tmp_path / "sb_dm.sbatch"
    emit_sbatch.main(["--preset", "conditional_dm3d", "--nodes", str(nodes),
                      "--gpus_per_node", str(gpus), "--out", str(out)])
    text = out.read_text()
    assert f"#SBATCH --nodes={nodes}" in text
    assert f"#SBATCH --ntasks-per-node={gpus}" in text
    assert f"#SBATCH --gres=gpu:{gpus}" in text
    assert "LDM3D_COORDINATOR" in text
    assert "python -m ldm3d_torch.cli.main --preset conditional_dm3d" in text
    assert '--num_processes "$SLURM_NTASKS"' in text
    assert '--process_id "$SLURM_PROCID"' in text
    # the port's CLI parses the line every task runs
    line = text.split("bash -c '", 1)[1].split("\\", 1)[0].split()[3:]
    assert cli.build_parser().parse_args(line + [
        "--coordinator", "h:1", "--num_processes", str(nodes * gpus),
        "--process_id", "0"]).train_dm


def test_emit_all_covers_canonical_matrix(tmp_path):
    emit_sbatch.main(["--all", "--out_dir", str(tmp_path)])
    files = sorted(os.listdir(tmp_path))
    assert len(files) >= 10, files
    assert "sb_vqgan_attn.sbatch" in files
    assert "sb_conditional_dm3d.sbatch" in files
    # the JAX tool's matrix, preset for preset
    jax_tool = _load_tool("emit_sbatch")
    assert emit_sbatch.CANONICAL == jax_tool.CANONICAL


def test_passthrough_flags(tmp_path):
    out = tmp_path / "s.sbatch"
    emit_sbatch.main(["--preset", "vqvae_b8_all", "--out", str(out),
                      "--epochs", "7", "--norm", "group"])
    text = out.read_text()
    assert "--epochs 7" in text and "--norm group" in text


# -- the report tools ------------------------------------------------------

def _load_tool(name):
    """A JAX tool from `tools/` as a module (it has no package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _output(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _gan_log(path, adaptive: bool):
    """A VQ-GAN run's training.log, written by the port's CSVLogger."""
    log = CSVLogger(str(path))
    rng = np.random.default_rng(3 + adaptive)
    for epoch in range(4):
        row = {"loss": 1.0 / (epoch + 1), "val_ssim": 0.5 + 0.1 * epoch,
               "val_psnr": 20.0 + epoch, "val_reconst_loss": 1e-3,
               "gen_loss": float(rng.random()),
               "disc_loss": float(rng.random())}
        if adaptive:
            row["adaptive_weight"] = float(rng.random())
        log(epoch, row)
    return str(path)


def test_reports_match_the_jax_tools(run, tmp_path, monkeypatch):
    dm_log = os.path.join(run["dm"], "training.log")
    a = _gan_log(tmp_path / "a.log", False)
    b = _gan_log(tmp_path / "b.log", True)

    jq = _load_tool("quality_report")
    got = _output(quality_report.main, [dm_log, "--png",
                                        str(tmp_path / "q.png")])
    want = _output(jq.main, [dm_log])

    def table(text):   # the port's text names no device in one sentence
        return [ln for ln in text.splitlines()
                if not ln.startswith("**Reference comparison**")
                and not ln.startswith("curves ->")]
    assert table(got) == table(want) and "| final (2) |" in got
    assert (tmp_path / "q.png").stat().st_size > 0

    argv = [f"A={a}", f"B={b}", "--threshold", "2"]
    got = _output(gan_ab.main, argv + ["--png", str(tmp_path / "g.png")])
    monkeypatch.setattr(sys, "argv", ["gan_ab.py"] + argv)
    want = _output(_load_tool("gan_ab").main)
    assert got.splitlines()[:len(want.splitlines())] == want.splitlines()
    assert "| 4 | 0.800 | 23.00 |" in got

    argv = [f"T500={dm_log}", f"again={dm_log}"]
    assert _output(dm_comparison.main, argv) \
        == _output(_load_tool("dm_comparison").main, argv)


def test_conditioning_ab_reads_the_port_sweep(run, tmp_path, monkeypatch):
    sweep = os.path.join(run["dir"], "out", "fidelity_sweep_smoke_cond.json")
    with open(sweep) as f:
        rows = json.load(f)["rows"]
    assert [r["guidance"] for r in rows] == [None, 3.0]
    assert all("fid_class_sep" in r for r in rows)
    out = tmp_path / "ab.md"
    monkeypatch.setattr(sys, "argv", ["conditioning_ab.py", f"A={sweep}",
                                      f"B={sweep}", "--out", str(out)])
    _load_tool("conditioning_ab").main()
    lines = out.read_text().splitlines()
    body = [ln for ln in lines if ln.startswith("| A |")
            or ln.startswith("| B |")]
    assert len(body) == 2 * len(rows)
    assert body[0].endswith(f"| {rows[0]['fid_class_sep']} |")

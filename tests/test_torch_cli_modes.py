"""The command-line modes the port gained last: `--fidelity_sweep`,
`--profile` and `--device_data`, on the CPU at `smoke_cond` / `smoke`
(16^3 volumes). `--sweep` is in tests/test_torch_sweep.py.

- `--fidelity_sweep` against the JAX CLI's `run_fidelity_sweep`: with
  the trainers replaced by fakes that return the same scores, both parse
  the same sampler x guidance grid, skip the same guided cells and write
  the same `.json` and `.md` files. Then a real sweep over a trained
  checkpoint: each row equals a direct `fidelity_eval` with the sweep's
  seed, and a guided cell of a model trained without cfg_dropout is
  skipped. Both CLIs read one fixed clock (`time.perf_counter`
  stubbed), so that the rows' `eval_seconds` are equal by construction
  however long a fake call takes under a loaded test run.
- `--profile` writes a Chrome trace of the run under `{ckpt_dir}/trace`.
- `--train_vq --synthetic --device_data` trains exactly as the cache
  path does: the same `training.log`.
"""

import glob
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from ldm3d.cli import main as jcli
from ldm3d.core import presets as jpresets
from ldm3d.train import checkpoint as jckpt
from ldm3d_torch.cli import main as cli
from ldm3d_torch.core import presets as ppresets
from ldm3d_torch.train import checkpoint as pckpt
from ldm3d_torch.train import dm_trainer as pdm
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

GRID = ["--sweep_samplers", "ddpm, ddim:3,dpmpp:4:,ddim:5:0.5,,",
        "--guidance_grid", "none,0,2.5, NONE,3"]


def _scores(sampler, steps, eta, g, by_class):
    """Fake scores, a function of the cell."""
    base = 10.0 + 0.123456 * (steps or 7) + 1.5 * eta + (g or 0.0) \
        + 0.01 * len(sampler)
    out = {"latent_fid": base, "latent_mmd": base / 1000.0}
    if by_class:
        out.update(fid_same_c0=base + 0.5, fid_same_c1=base + 0.25,
                   fid_cross_c0=base + 2.0, fid_cross_c1=base + 1.75,
                   fid_class_sep=1.5)
    return out


class _FakeJAX:
    conditional = True

    def __init__(self, calls, cfg_dropout):
        self.calls, self.cfg_dropout = calls, cfg_dropout

    def init_state(self, *a):
        return None

    def latent_features(self, state, vol):
        return np.ones((2, 4), np.float32)

    def fidelity_eval(self, state, real_feats, key, num_samples, batch,
                      sampler, sample_steps, eta, guidance_scale, real_ctx):
        self.calls.append((sampler, sample_steps, eta, guidance_scale))
        if guidance_scale is not None and self.cfg_dropout <= 0:
            raise ValueError("guidance needs cfg_dropout")
        return _scores(sampler, sample_steps, eta, guidance_scale,
                       real_ctx is not None)


class _FakePort(_FakeJAX):
    def __init__(self, cfg, device=None, train_cfg=None):
        super().__init__(_FakePort.calls, cfg.unet.cfg_dropout)

    def load_state_dict(self, state, optimizer=True):
        pass

    def latent_features(self, vol):
        return np.ones((2, 4), np.float32)

    def fidelity_eval(self, real_feats, generator, num_samples, batch,
                      sampler, sample_steps, eta, guidance_scale, real_ctx):
        return super().fidelity_eval(None, real_feats, generator,
                                     num_samples, batch, sampler,
                                     sample_steps, eta, guidance_scale,
                                     real_ctx)


def _loader():
    return ([(torch.zeros(2, 16, 16, 16, 1), None,
              torch.tensor([0, 1], dtype=torch.int32))], None)


@pytest.mark.parametrize("by_class,cfg_dropout", [(True, 0.1),
                                                  (False, 0.0)])
def test_fidelity_sweep_files_equal_jax(tmp_path, monkeypatch, by_class,
                                        cfg_dropout):
    argv = ["--preset", "smoke_cond", "--fidelity_sweep",
            "--fidelity_samples", "8", "--cfg_dropout", str(cfg_dropout),
            "--ckpt_dir", str(tmp_path / "k"), *GRID] \
        + (["--fidelity_by_class"] if by_class else [])
    jcalls, pcalls = [], []
    _FakePort.calls = pcalls
    monkeypatch.setattr(jcli, "_dm_trainer",
                        lambda cfg, args, mesh: _FakeJAX(jcalls,
                                                         cfg_dropout))
    monkeypatch.setattr(jcli, "_loaders", lambda cfg, args, mesh=None: (
        [(np.zeros((2, 16, 16, 16, 1), np.float32), None,
          np.array([0, 1], np.int32))], None))
    monkeypatch.setattr(jckpt.CheckpointManager, "restore",
                        lambda self, state, epoch=None: (state, 3))
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(pdm, "DiffusionTrainer", _FakePort)
    monkeypatch.setattr(cli, "_loaders", lambda cfg, args, device: _loader())
    monkeypatch.setattr(pckpt.CheckpointManager, "restore",
                        lambda self, epoch=None: ({}, 3))
    # the JAX CLI imports `time` inside run_fidelity_sweep: patch the
    # module's function, which both sides read at call time
    monkeypatch.setattr(time, "perf_counter", lambda: 100.0)
    outs = {}
    for side, mod in (("jax", jcli), ("port", cli)):
        out = str(tmp_path / side)
        args = mod.build_parser().parse_args(argv + ["--out_dir", out])
        if side == "port":
            args.platform = "cpu"
        presets = jpresets if side == "jax" else ppresets
        cfg = mod.apply_overrides(presets.get_preset("smoke_cond"), args)
        rows = mod.run_fidelity_sweep(cfg, args)
        base = os.path.join(out, f"fidelity_sweep_{cfg.name}")
        with open(base + ".json") as f:
            js = json.load(f)
        with open(base + ".md") as f:
            md = f.read()
        outs[side] = rows, js, md
    assert jcalls == pcalls
    assert len(jcalls) == 4 * 5
    (jrows, jjs, jmd), (prows, pjs, pmd) = outs["jax"], outs["port"]
    assert prows == jrows and pjs == jjs and pmd == jmd
    # the unguided cells only, without cfg_dropout ("none", "0", "NONE")
    assert len(prows) == (20 if cfg_dropout else 12)
    assert ("FID same(c0/c1)" in pmd) == by_class
    assert prows[0]["steps"] is None and "| T |" in pmd
    assert {r["sampler"] for r in prows} == {"ddpm", "ddim", "dpmpp",
                                             "ddim(eta=0.5)"}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of --train_dm at smoke_cond (no cfg_dropout)."""
    d = tmp_path_factory.mktemp("dm")
    base = ["--preset", "smoke_cond", "--platform", "cpu", "--cache_dir",
            str(d / "c"), "--ckpt_dir", str(d / "k"), "--out_dir",
            str(d / "o"), "--val_perc", "0.34", "--num_synthetic", "6"]
    cli.main(base + ["--create_dataset", "--synthetic"])
    cli.main(base + ["--train_dm", "--epochs", "1"])
    return base


def test_fidelity_sweep_rows_equal_direct_evals(trained, capsys):
    cli.main(trained + ["--fidelity_sweep", "--fidelity_samples", "4",
                        "--sweep_samplers", "ddim:2,dpmpp:3",
                        "--guidance_grid", "none,3", "--fidelity_by_class"])
    out = capsys.readouterr().out
    assert out.count("skip ") == 2 and "cfg_dropout" in out
    args = cli.build_parser().parse_args(trained)
    cfg = cli.apply_overrides(ppresets.get_preset("smoke_cond"), args)
    with open(os.path.join(str(args.out_dir),
                           f"fidelity_sweep_{cfg.name}.json")) as f:
        result = json.load(f)
    assert result["epoch"] == 1 and len(result["rows"]) == 2
    tr = pdm.DiffusionTrainer(cfg.diffusion, device="cpu",
                              train_cfg=cfg.train)
    state, _ = pckpt.CheckpointManager(
        os.path.join(cfg.ckpt_dir, f"{cfg.name}_dm")).restore()
    tr.load_state_dict(state, optimizer=False)
    loader = cli._loaders(cfg, args, torch.device("cpu"))[1]
    batches = list(loader)
    real = np.concatenate([tr.latent_features(b[0]) for b in batches])
    ctx = np.concatenate([b[2].numpy() for b in batches])
    for row, (sampler, steps) in zip(result["rows"],
                                     [("ddim", 2), ("dpmpp", 3)]):
        scores = tr.fidelity_eval(
            real, torch.Generator().manual_seed(cfg.train.seed + 9000),
            num_samples=4, batch=4, sampler=sampler, sample_steps=steps,
            real_ctx=ctx)
        assert row["sampler"] == sampler and row["steps"] == steps
        assert row["guidance"] is None
        assert row["latent_fid"] == round(float(scores["latent_fid"]), 3)
        assert row["latent_mmd"] == round(float(scores["latent_mmd"]), 4)
        for k, v in scores.items():
            if k.startswith("fid_"):
                assert row[k] == round(float(v), 3)


def test_profile_writes_a_trace(trained):
    cli.main(trained + ["--test_dm", "--sampler", "ddim", "--sample_steps",
                        "2", "--profile"])
    args = cli.build_parser().parse_args(trained)
    files = glob.glob(os.path.join(args.ckpt_dir, "trace",
                                   "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("conv3d" in n or "convolution" in n for n in names)


def test_device_data_trains_as_the_cache_does(tmp_path):
    """--train_vq at `smoke` from the corpus computed in process equals
    the run over the cache of the same seed, metric for metric."""
    logs = []
    for extra in (["--device_data"], []):
        d = tmp_path / ("device" if extra else "cache")
        cli.main(["--preset", "smoke", "--platform", "cpu", "--cache_dir",
                  str(d / "c"), "--ckpt_dir", str(d / "k"), "--val_perc",
                  "0.34", "--synthetic", "--num_synthetic", "6",
                  "--augment", "--train_vq", "--epochs", "2", *extra])
        logs.append((d / "k" / "smoke_vq" / "training.log").read_text())
        assert os.path.exists(d / "c" / "manifest.json") == (not extra)
    assert logs[0] == logs[1] and len(logs[0].splitlines()) == 3

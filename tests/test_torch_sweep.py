"""The port's sweeps (`ldm3d_torch.core.sweep` and the CLI's `--sweep`)
against the JAX package's, on the CPU.

`core/sweep.py` is pure Python on `random.Random(seed)`, so for the same
spec, seed and observations the port's parse, expansions, folded configs
and Bayes (TPE) proposals equal JAX's exactly. Then a two-point grid
`--sweep` at `smoke` on 16^3 volumes: one `--train_vq` per point, both
records in `sweep_results.jsonl` with the JAX runner's keys, names and
the last row of each point's `training.log`.
"""

import json
import math
import os

import pytest

from ldm3d.core import presets as jpresets
from ldm3d.core import sweep as jsweep
from ldm3d_torch.cli import main as cli
from ldm3d_torch.core import presets
from ldm3d_torch.core import sweep
from test_torch_cli import _same_fields
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

YAML = """
program: exp_main.py   # the reference's
method: bayes
metric:
  name: val_loss
  goal: minimize
parameters:
  channel_list:
    values: ["(32,64,128)", "(32,64,128,256)"]
  num_embedding:
    values: [64, 512]
  embedding_dim:
    value: 256
  lr:
    values: [0.0001, 0.0003, 0.001]
  lbs:
    values: [3, 4]
  epochs:
    value: 70
  dataset:
    value: BraTS
"""


def _spec(method="bayes", goal="minimize"):
    return YAML.replace("method: bayes", f"method: {method}").replace(
        "goal: minimize", f"goal: {goal}")


@pytest.mark.parametrize("method", ["bayes", "grid", "random"])
def test_parse_equals_jax(method):
    text = _spec(method)
    assert sweep.parse_sweep_yaml(text) == jsweep.parse_sweep_yaml(text)


@pytest.mark.parametrize("count,seed", [(None, 0), (5, 0), (5, 3), (3, 1),
                                        (24, 2), (100, 0)])
@pytest.mark.parametrize("method", ["grid", "random"])
def test_expand_equals_jax(method, count, seed):
    spec = sweep.parse_sweep_yaml(_spec(method))
    got = sweep.expand_sweep(spec, count=count, seed=seed)
    assert got == jsweep.expand_sweep(spec, count=count, seed=seed)
    assert len(got) == min(count or 24, 24)


@pytest.mark.parametrize("preset", ["vqvae_b8_all", "vqvae_dm_stage1",
                                    "smoke"])
def test_apply_sweep_point_equals_jax(preset):
    spec = sweep.parse_sweep_yaml(_spec("grid"))
    for point in sweep.expand_sweep(spec, count=5, seed=0):
        _same_fields(sweep.apply_sweep_point(presets.get_preset(preset),
                                             point),
                     jsweep.apply_sweep_point(jpresets.get_preset(preset),
                                              point))


@pytest.mark.parametrize("goal,seed,n_init", [("minimize", 0, 4),
                                              ("maximize", 1, 2),
                                              ("minimize", 7, 6)])
def test_bayes_proposals_equal_jax(goal, seed, n_init):
    """The same proposals over a scripted series of observations, to the
    grid's end (24 cells), and the same best point."""
    spec = sweep.parse_sweep_yaml(_spec("bayes", goal))
    ours = sweep.BayesSearch(spec, seed=seed, n_init=n_init)
    ref = jsweep.BayesSearch(spec, seed=seed, n_init=n_init)
    proposals = []
    for i in range(30):
        p, q = ours.suggest(), ref.suggest()
        assert p == q, i
        if p is None:
            break
        proposals.append(p)
        # a scripted metric: smooth in the point, with a failed trial
        value = (math.log(p["lr"]) + 0.01 * p["num_embedding"]
                 - len(p["channel_list"]) + 0.1 * p["lbs"]
                 + 0.37 * ((7 * i) % 5))
        if i == 5:
            value = math.inf
        ours.observe(p, value)
        ref.observe(p, value)
    assert len(proposals) == 24
    assert len({tuple(sorted(p.items())) for p in proposals}) == 24
    assert ours.best() == ref.best()


def test_malicious_channel_list_rejected():
    """channel_list is a strict literal of int tuples: the reference's
    eval() is not reproduced."""
    for bad in ('"(__import__,)"', '"(1.5, 2)"', '"(\'a\',)"'):
        text = YAML.replace('"(32,64,128)"', bad)
        with pytest.raises((ValueError, SyntaxError)):
            sweep.parse_sweep_yaml(text)
        with pytest.raises((ValueError, SyntaxError)):
            jsweep.parse_sweep_yaml(text)


def test_sweep_runs_two_points(tmp_path, capsys):
    """`--sweep` over a two-point grid (two learning rates, one epoch
    each) at `smoke` on 16^3 volumes: two `--train_vq` runs and two
    records, each with its point's final metrics and no error."""
    spec = tmp_path / "sweep.yaml"
    spec.write_text("method: grid\nmetric:\n  name: val_loss\n"
                    "  goal: minimize\nparameters:\n"
                    "  lr:\n    values: [0.001, 0.0003]\n"
                    "  epochs:\n    value: 1\n")
    ckpt = tmp_path / "k"
    cli.main(["--preset", "smoke", "--platform", "cpu", "--volume_size",
              "16", "--cache_dir", str(tmp_path / "c"), "--ckpt_dir",
              str(ckpt), "--val_perc", "0.34", "--synthetic",
              "--num_synthetic", "6", "--sweep", str(spec)])
    out = capsys.readouterr().out
    assert "sweep (grid): 2 points, optimizing val_loss" in out
    assert "best: " in out
    recs = [json.loads(line) for line in
            (ckpt / "sweep_results.jsonl").read_text().splitlines()]
    assert [r["point"]["lr"] for r in recs] == [0.001, 0.0003]
    cfg = presets.get_preset("smoke")
    for r in recs:
        assert set(r) == {"name", "point", "metrics"}
        assert r["name"] == sweep.apply_sweep_point(cfg, r["point"]).name
        log = ckpt / f"{r['name']}_vq" / "training.log"
        header, *rows = log.read_text().splitlines()
        assert len(rows) == 1
        assert list(r["metrics"]) == header.split(",")
        assert r["metrics"]["epoch"] == 0.0
        assert math.isfinite(r["metrics"]["val_loss"])
    assert os.path.isdir(tmp_path / "c")        # one corpus for both


def test_failed_point_is_recorded_and_the_sweep_goes_on(tmp_path,
                                                        monkeypatch):
    """A point that raises is recorded with its error; bayes observes it
    as the worst value and proposes the next."""
    spec = tmp_path / "s.yaml"
    spec.write_text("method: bayes\nparameters:\n"
                    "  lr:\n    values: [0.1, 0.2, 0.3]\n")
    calls = []

    def fake_train(cfg, args):
        calls.append(cfg.train.learning_rate)
        if len(calls) == 1:
            raise RuntimeError("boom")
        d = os.path.join(cfg.ckpt_dir, f"{cfg.name}_vq")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "training.log"), "w") as f:
            f.write(f"epoch,val_loss\n0,{cfg.train.learning_rate}\n")
    monkeypatch.setattr(cli, "run_train_vq", fake_train)
    args = cli.build_parser().parse_args(
        ["--preset", "smoke", "--sweep", str(spec), "--ckpt_dir",
         str(tmp_path / "k")])
    cfg = cli.apply_overrides(presets.get_preset("smoke"), args)
    recs = cli.run_sweep(cfg, args)
    assert len(recs) == 3 == len(calls)
    assert recs[0] == {"name": recs[0]["name"], "error": "boom"}
    assert all("metrics" in r for r in recs[1:])

"""Stage-1 training from the port's command line, on the CPU.

- `--create_dataset --synthetic`, `--train_vq` (validation pass, image
  montages, unused-code replacement every epoch, pinned best val_psnr),
  `--resume_ckpt -1`, `--test_vq --save_nifti` at the `smoke` preset with
  `--platform cpu`, and the files each writes;
- the trained state exported to `.npz` restores in JAX's `load_state_npz`
  with every key accounted for, and JAX reconstructs from it what the
  port reconstructs from it;
- `--train_dm --vqvae_load_ckpt <a --train_vq directory>` loads the
  stage-1 that was trained with the diffusion preset's own VQ-VAE, and
  refuses one of another architecture before loading anything;
- `fit`'s validation pass, plateau schedule and replacement on a stub;
- the stage-1 models that were refused before the VQ-GAN family was
  ported (emavqvae, vqvae_legacy, --vqvae_mode) build the JAX CLI's
  config from the same argv and run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.cli import main as jcli
from ldm3d.core import presets as jpresets
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.train.vq_trainer import VQTrainer as JVQTrainer
from ldm3d.utils import export as jexport
from ldm3d_torch.cli import main as cli
from ldm3d_torch.core.config import replace
from ldm3d_torch.core.presets import get_preset
from ldm3d_torch.train.callbacks import ReduceLROnPlateau
from ldm3d_torch.train.checkpoint import CheckpointManager
from ldm3d_torch.train.loop import fit
from ldm3d_torch.train.vq_trainer import VQTrainer
from ldm3d_torch.utils import export
from test_torch_cli import _same_fields
from test_torch_samplers import FAST

# Reconstructions from one float16 snapshot: the same float32 VQ-VAE in
# eval mode on both sides, convolutions summed in other orders; 1e-5 of
# the largest value (as tests/test_torch_encoder.py).
RECON_REL_TOL = 1e-5


def _argv(tmp_path, preset="smoke"):
    return ["--preset", preset, "--platform", "cpu",
            "--cache_dir", str(tmp_path / "cache"),
            "--ckpt_dir", str(tmp_path / "ckpt"),
            "--out_dir", str(tmp_path / "out"), "--val_perc", "0.34"]


def _parse(argv):
    args = cli.build_parser().parse_args(argv)
    return cli.apply_overrides(get_preset(args.preset), args), args


def test_train_vq_and_test_vq_on_the_cpu(tmp_path, capsys):
    base = _argv(tmp_path)
    cli.main(base + ["--create_dataset", "--synthetic", "--num_synthetic",
                     "6"])
    # 4 training volumes (2 steps of 2), 2 held out (one val batch)
    cfg, args = _parse(base + ["--train_vq", "--epochs", "2",
                               "--image_log_freq", "1"])
    cfg = replace(cfg, train=replace(cfg.train, replace_codebook_freq=1))
    trainer = cli.run_train_vq(cfg, args)
    out = capsys.readouterr().out
    assert "epoch 2/2" in out and "val_ssim" in out
    assert trainer.step == 4 and trainer.cfg.in_channels == 2
    logdir = tmp_path / "ckpt" / "smoke_vq"
    rows = open(logdir / "training.log").read().splitlines()
    header = rows[0].split(",")
    for col in ("loss", "reconst_loss", "quantize_loss", "perplexity",
                "val_loss", "val_ssim", "val_psnr", "codebooks_replaced"):
        assert col in header, col
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "1"]
    recs = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    assert any("best_val_psnr" in r for r in recs)
    assert sorted(os.listdir(logdir / "images")) == [
        f"epoch{e}_{n}.png" for e in (1, 2)
        for n in ("original", "reconstruction")]
    mgr = CheckpointManager(str(logdir))
    assert mgr.all_epochs() == [1, 2] and "best_val_psnr" in mgr.pinned()

    cli.main(base + ["--train_vq", "--epochs", "3", "--resume_ckpt", "-1"])
    out = capsys.readouterr().out
    assert "resumed from epoch 2" in out and "epoch 3/3" in out
    assert "epoch 1/3" not in out
    state, _ = mgr.restore()
    assert state["step"] == 6

    cli.main(base + ["--test_vq", "--save_nifti"])
    out = capsys.readouterr().out
    assert "testing epoch 3" in out
    assert "mean reconst MSE over 1 batches" in out
    assert sorted(os.listdir(tmp_path / "out")) == [
        "original_0.npy", "reconst_0.npy", "reconst_0_0.nii.gz"]
    orig = np.load(tmp_path / "out" / "original_0.npy")
    recon = np.load(tmp_path / "out" / "reconst_0.npy")
    assert orig.shape == recon.shape == (2, 16, 16, 16, 1)
    assert np.isfinite(recon).all()
    mse = float(out.split("mean reconst MSE over 1 batches: ")[1].split()[0])
    np.testing.assert_allclose(mse, np.mean((recon - orig) ** 2), rtol=1e-4)

    # the .npz export in the JAX layout restores in JAX, every key used
    tr = VQTrainer(cfg.vqvae, cfg.train, device="cpu")
    tr.load_state_dict(state)
    snap = str(tmp_path / "stage1.npz")
    export.save_state_npz(snap, tr, {"epoch": 3})
    jtr = JVQTrainer(jpresets.get_preset("smoke").vqvae,
                     JTrainConfig(batch_size=2, dtype="float32"))
    shape = (2, 16, 16, 16, 2)
    st = jax.jit(jtr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(0), shape).compile(compiler_options=FAST)(
        jax.random.PRNGKey(0))
    st = jexport.load_state_npz(snap, st)
    twin = VQTrainer(cfg.vqvae, cfg.train, device="cpu")
    export.load_state_npz(snap, twin)
    mask = (orig > 0.5).astype(np.float32)
    recon_fn = jax.jit(lambda s, v, m: jtr.model.apply(
        s.variables(), jtr._model_input(v, m), training=False)[0]).lower(
        st, jnp.asarray(orig), jnp.asarray(mask)).compile(
        compiler_options=FAST)
    ref = np.asarray(recon_fn(st, jnp.asarray(orig), jnp.asarray(mask)))
    got, _ = twin.reconstruct(torch.from_numpy(orig), torch.from_numpy(mask))
    got = got.numpy()
    assert got.shape == ref.shape == shape
    assert np.abs(got - ref).max() <= RECON_REL_TOL * np.abs(ref).max()


def test_train_dm_loads_a_port_stage1_directory(tmp_path, capsys):
    base = _argv(tmp_path, "smoke_cond")
    cli.main(base + ["--create_dataset", "--synthetic", "--num_synthetic",
                     "6"])
    # a stage-1 trained as the diffusion preset's own VQ-VAE
    cfg, args = _parse(base + ["--train_vq", "--epochs", "1", "--suffix",
                               "stage1"])
    cfg = replace(cfg, vqvae=cfg.diffusion.vqvae)
    cli.run_train_vq(cfg, args)
    s1 = tmp_path / "ckpt" / "stage1_vq"
    # and one of the smoke preset's own 2-channel VQ-VAE
    cli.main(base + ["--train_vq", "--epochs", "1", "--suffix", "twoch"])
    capsys.readouterr()
    with pytest.raises(ValueError, match="another VQ-VAE") as err:
        cli.main(base + ["--train_dm", "--epochs", "1", "--vqvae_load_ckpt",
                         str(tmp_path / "ckpt" / "twoch_vq")])
    assert "down_0.weight" in str(err.value)
    assert not (tmp_path / "ckpt" / "smoke_cond_dm" / "1.pt").exists()

    cli.main(base + ["--train_dm", "--cache_latents", "--epochs", "1",
                     "--vqvae_load_ckpt", str(s1)])
    out = capsys.readouterr().out
    assert "loaded stage-1 VQ-VAE weights from epoch 1" in out
    assert (tmp_path / "cache" / "latents_s1ep1_b2.npz").exists()
    dm_state, _ = CheckpointManager(
        str(tmp_path / "ckpt" / "smoke_cond_dm")).restore()
    vq_state, _ = CheckpointManager(str(s1)).restore()
    for k, t in vq_state["model"].items():
        assert torch.equal(dm_state["model"]["vqvae." + k], t), k


class _Stub:
    """A trainer whose val loss never improves."""

    def __init__(self):
        self.optimizer = torch.optim.SGD([torch.zeros(1,
                                                      requires_grad=True)],
                                         lr=1e-3)
        self.replaced = []

    def train_step(self, vol, ctx):
        return {"loss": torch.tensor(1.0)}

    def eval_step(self, vol, mask):
        return {"loss": torch.tensor(2.0), "psnr": torch.tensor(3.0)}

    def replace_unused(self, num_batches):
        self.replaced.append(num_batches)
        return 5

    def state_dict(self):
        return {}


def test_fit_validation_schedule_and_replacement(capsys):
    stub = _Stub()
    batches = [(torch.zeros(1), torch.zeros(1), None)] * 3
    logged = []
    metrics = fit(stub, batches, 4, val_loader=batches[:2],
                  lr_schedule=ReduceLROnPlateau(monitor="val_loss",
                                                patience=2),
                  replace_codebook_freq=2,
                  metrics_logger=lambda e, m: logged.append((e, dict(m))))
    assert metrics["val_loss"] == 2.0 and metrics["val_psnr"] == 3.0
    assert stub.replaced == [3, 3]                 # epochs 2 and 4
    assert [("codebooks_replaced" in m) for _, m in logged] == [
        False, True, False, True]
    # no improvement after epoch 1: the rate halves after 2 more
    assert stub.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)
    assert "lr -> 5.00e-04" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--preset", "emavqvae", "--train_vq"],
    ["--preset", "vqvae_legacy", "--test_vq"],
    ["--preset", "smoke", "--train_vq", "--vqvae_mode", "2"],
    ["--preset", "vqgan_stride", "--train_dm"],
    ["--preset", "emavqvae", "--create_dataset", "--synthetic"],
])
def test_unported_stage1_models_exit_with_item_7(argv, tmp_path,
                                                 monkeypatch):
    """These models exited with ROADMAP queue 1 item 7 until they were
    ported. Now each argv folds into the config the JAX CLI builds from
    it, and its mode runs on the CPU at 16^3 (a --test_vq after a
    --train_vq of its own); --train_dm of a VQ-GAN preset trains the
    preset's 128^3 diffusion model, so that case checks the config
    only."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    ref = jcli.apply_overrides(jpresets.get_preset(argv[1]),
                               jcli.build_parser().parse_args(argv))
    cfg, _ = _parse(argv)
    _same_fields(cfg, ref)
    if "--train_dm" in argv:
        return
    base = _argv(tmp_path, argv[1]) + ["--volume_size", "16", "--lbs", "1",
                                       "--num_synthetic", "3",
                                       "--synthetic", "--epochs", "1"]
    if "--test_vq" in argv:
        cli.main(base + ["--train_vq"])
    cli.main(base + argv[2:])
    if "--create_dataset" in argv:
        assert (tmp_path / "cache" / "manifest.json").exists()
        return
    if "--test_vq" in argv:
        recon = np.load(tmp_path / "out" / "reconst_0.npy")
        assert recon.shape == (1, 16, 16, 16, 1)
        return
    state, epoch = CheckpointManager(
        str(tmp_path / "ckpt" / f"{argv[1]}_vq")).restore()
    assert epoch == 1 and state["step"] == 2
    family = "ema_skip" if argv[1] == "emavqvae" else "legacy"
    trainer = VQTrainer(cfg.vqvae, device="cpu")
    assert cfg.vqvae.family == family
    trainer.load_state_dict(state)


def test_test_vq_needs_a_validation_split(tmp_path):
    base = _argv(tmp_path)
    cli.main(base + ["--create_dataset", "--synthetic", "--num_synthetic",
                     "3"])
    with pytest.raises(SystemExit, match="validation split is empty"):
        cli.main(base + ["--test_vq"])

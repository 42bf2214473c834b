"""The port's command line against the JAX package's, on the CPU.

- `build_parser`: the JAX CLI's flags, destinations and defaults.
- `apply_overrides` over a table of argv: the same config fields as the
  JAX CLI's (one device: --lbs is the global batch on both sides).
- `_adopt_dm_meta` of a train_meta.json written by the port: JAX's
  function adopts the same values and prints the same line.
- The whole slice at `smoke_cond` with `--platform cpu`: --create_dataset
  --synthetic, --train_dm --cache_latents (with --fidelity_freq and
  --image_log_freq), --resume_ckpt -1, --test_dm, then
  `GenerationService.from_checkpoint` and the serve CLI answering one
  request over HTTP.
- On a cache written by the JAX package: the port's cached latents equal
  JAX's `encode_latents` of the same batches under the port's weights,
  and the trained state, exported and loaded into JAX, samples as the
  port samples from the same snapshot, with JAX's draws injected.
- Every preset equals the JAX package's; the VQ-GAN modes run on the
  CPU from the same argv as JAX's at 16^3.
- The modes once refused: --train_vq over a space mesh and --train_dm
  over a model mesh, in two processes, as one process trains.
- The refusals: without `--platform cpu` every entry point raises on a
  machine with no GPU, the samplers' default device included.
"""

import argparse
import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.cli import main as jcli
from ldm3d.core import presets as jpresets
from ldm3d.core.config import DataConfig as JDataConfig
from ldm3d.core.config import TrainConfig as JTrainConfig
from ldm3d.data import pipeline as jpipe
from ldm3d.train.dm_trainer import DiffusionTrainer as JTrainer
from ldm3d.utils import export as jexport
from ldm3d_torch.cli import main as cli
from ldm3d_torch.convert import flax_state
from ldm3d_torch.core import presets
from ldm3d_torch.core.config import MeshConfig, flagship_cfg
from ldm3d_torch.core.presets import get_preset, list_presets
from ldm3d_torch.data import pipeline
from ldm3d_torch.data.synthetic import synthetic_batch
from ldm3d_torch.diffusion.ddpm import sample_latents
from ldm3d_torch.diffusion.schedule import make_schedule
from ldm3d_torch.serve import GenerationService, server_from_args
from ldm3d_torch.train.checkpoint import CheckpointManager
from ldm3d_torch.train.dm_trainer import DiffusionTrainer
from ldm3d_torch.utils import export
from test_torch_samplers import CTX, FAST, SHAPE, _jax_draws
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# Encoded latents: the same frozen float32 encoder and codebook on both
# sides, convolutions summed in other orders; the quantized latents are
# codebook rows (equal unless a near-tie picks another row), times the
# AUTO latent scale. 1e-5 of the largest value.
ENCODE_REL_TOL = 1e-5
# Samples from one exported snapshot: up to 3 DDIM steps of the tiny
# U-Net and one decode in float32, as tests/test_torch_samplers.py;
# 1e-5 of the largest value.
SAMPLE_REL_TOL = 1e-5


def _skip_with_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")


def _flag_table(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_flags():
    port, ref = _flag_table(cli.build_parser()), _flag_table(
        jcli.build_parser())
    assert port.keys() == ref.keys()
    for dest, a in port.items():
        b = ref[dest]
        assert a.option_strings == b.option_strings, dest
        assert a.default == b.default, dest
        assert type(a) is type(b), dest
        assert a.type == b.type, dest
        if dest != "platform":   # the device names differ
            assert a.choices == b.choices, dest
    assert port["platform"].choices == ["cpu", "gpu"]


def _same_fields(port, ref, where=""):
    """Every field of the port's dataclass equals the JAX object's field
    of the same name."""
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _same_fields(getattr(port, f.name), getattr(ref, f.name),
                         f"{where}.{f.name}")
    else:
        assert port == ref, (where, port, ref)


OVERRIDES = [
    ["--preset", "conditional_dm3d", "--norm", "group", "--num_classes",
     "4", "--cfg_dropout", "0.1", "--ema_decay", "0.999", "--latent_scale",
     "20.834", "--clip_sample_range", "0"],
    ["--preset", "dm3d", "--lr", "3e-4", "--epochs", "7", "--lbs", "4",
     "--val_perc", "0.2", "--dtype", "float32", "--timesteps", "100",
     "--prediction_type", "v", "--min_snr_gamma", "5", "--loss_reduction",
     "ref"],
    ["--preset", "smoke_cond", "--unet_widths", "16,32,64", "--unet_stem",
     "16", "--context_in_time", "--cache_dir", "c", "--dataset", "BraTS",
     "--dataset_dir", "d", "--volume_size", "32", "--augment",
     "--test_run", "--ckpt_dir", "k", "--suffix", "run7"],
    ["--preset", "smoke", "--unet_widths", "8,16", "--unet_attention",
     "1,0"],
    ["--preset", "conditional_dm3d", "--kernel_resize", "--num_embeddings",
     "64", "--embedding_dim", "4", "--vqvae_mode", "2", "--disc_threshold",
     "3", "--r1_gamma", "1.0"],
    # the stage-1 presets
    ["--preset", "vqvae_dm_stage1", "--norm", "group", "--lbs", "8"],
    ["--preset", "vqvae_b8_all", "--kernel_resize", "--num_embeddings",
     "256"],
    ["--preset", "vqvae_5level_test", "--embedding_dim", "64"],
    ["--preset", "nsvqvae", "--lr", "2e-4"],
    ["--preset", "rnsvqvae", "--epochs", "3"],
]


@pytest.mark.parametrize("argv", OVERRIDES, ids=lambda a: a[1] + str(
    len(a)))
def test_apply_overrides_matches_jax(argv, monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 1)   # one device
    port = cli.apply_overrides(get_preset(argv[1]),
                               cli.build_parser().parse_args(argv))
    ref = jcli.apply_overrides(jpresets.get_preset(argv[1]),
                               jcli.build_parser().parse_args(argv))
    _same_fields(port, ref)
    if argv == OVERRIDES[0]:
        # the flagship, but for the preset's stage-1 remat, which only
        # matters where gradients flow (stage-1 training)
        flag = flagship_cfg()
        flag = dataclasses.replace(flag, vqvae=dataclasses.replace(
            flag.vqvae, remat=True))
        _same_fields(port.diffusion, flag)
        assert port.diffusion == flag
    if argv == OVERRIDES[5]:
        # vqvae_dm_stage1 --norm group trains the flagship's stage-1
        dm = cli.apply_overrides(get_preset("conditional_dm3d"),
                                 cli.build_parser().parse_args(OVERRIDES[0]))
        assert port.vqvae == dm.diffusion.vqvae
        assert dataclasses.replace(port.vqvae, remat=False) \
            == flagship_cfg().vqvae


def test_stage1_presets_refused():
    """Every preset of the JAX package builds in the port and equals the
    JAX package's (the VQ-GAN presets, emavqvae and vqvae_legacy were
    refused until the VQ-GAN family was ported); an unknown name is still
    refused."""
    assert list_presets() == jpresets.list_presets()
    for name in jpresets.list_presets():
        _same_fields(get_preset(name), jpresets.get_preset(name), name)
    with pytest.raises(KeyError):
        get_preset("no_such_preset")


@pytest.mark.parametrize("given", [[], ["--latent_scale", "2", "--timesteps",
                                        "8", "--ema_decay", "0"]])
def test_adopt_meta_matches_jax(tmp_path, capsys, given):
    argv = ["--preset", "smoke_cond", "--ckpt_dir", str(tmp_path)] + given
    trained = cli.apply_overrides(get_preset("smoke_cond"), cli.build_parser()
                                  .parse_args(["--preset", "smoke_cond"]))
    trained = dataclasses.replace(
        trained,
        diffusion=dataclasses.replace(
            trained.diffusion, latent_scale=12.25, clip_sample_range=0.0,
            timesteps=6, prediction_type="v",
            unet=dataclasses.replace(
                trained.diffusion.unet, cfg_dropout=0.2, context_dim=3,
                context_in_time=True, widths=(16, 32), first_conv_channels=16,
                has_attention=(False, True, True))),
        train=dataclasses.replace(trained.train, ema_decay=0.9))
    d = os.path.join(str(tmp_path), "smoke_cond_dm")
    os.makedirs(d)
    with open(os.path.join(d, "train_meta.json"), "w") as f:
        json.dump(cli.train_meta(trained), f, indent=1)
    port = cli._adopt_dm_meta(
        cli.apply_overrides(get_preset("smoke_cond"),
                            cli.build_parser().parse_args(argv)),
        cli.build_parser().parse_args(argv))
    port_out = capsys.readouterr().out
    jargs = jcli.build_parser().parse_args(argv)
    ref = jcli._adopt_dm_meta(jcli.apply_overrides(
        jpresets.get_preset("smoke_cond"), jargs), jargs)
    assert capsys.readouterr().out == port_out
    _same_fields(port, ref)
    if not given:
        assert port.diffusion == trained.diffusion
        assert "adopted from train_meta.json" in port_out


def _run(tmp_path, *extra):
    argv = ["--preset", "smoke_cond", "--platform", "cpu",
            "--cache_dir", str(tmp_path / "cache"),
            "--ckpt_dir", str(tmp_path / "ckpt"),
            "--out_dir", str(tmp_path / "out"), "--val_perc", "0.34"]
    cli.main(argv + list(extra))


TRAIN = ["--train_dm", "--cache_latents", "--ema_decay", "0.9",
         "--cfg_dropout", "0.1", "--dtype", "float32"]


def test_cli_slice_on_the_cpu(tmp_path, capsys):
    _run(tmp_path, "--create_dataset", "--synthetic", "--num_synthetic",
         "6", "--num_classes", "4")
    manifest = json.load(open(tmp_path / "cache" / "manifest.json"))
    assert len(manifest["entries"]) == 6 and manifest["num_classes"] == 4
    _run(tmp_path, *TRAIN, "--num_classes", "4", "--epochs", "2",
         "--fidelity_freq", "1", "--fidelity_samples", "4",
         "--sample_steps", "2", "--image_log_freq", "2")
    out = capsys.readouterr().out
    assert "AUTO latent_scale" in out and "epoch 2/2" in out
    logdir = tmp_path / "ckpt" / "smoke_cond_dm"
    meta = json.load(open(logdir / "train_meta.json"))
    assert meta["latent_scale"] != 1.0 and meta["clip_sample_range"] == 0.0
    assert meta["context_dim"] == 3 and meta["ema_decay"] == 0.9
    assert sorted(os.listdir(logdir / "images")) == [
        f"epoch2_generated_ctx{c}.png" for c in range(4)]
    mgr = CheckpointManager(str(logdir))
    assert mgr.all_epochs() == [1, 2] and mgr.pinned()
    state, _ = mgr.restore(2)
    assert state["step"] == 4 and state["ema_unet"] is not None

    _run(tmp_path, *TRAIN, "--num_classes", "4", "--epochs", "3",
         "--resume_ckpt", "-1")
    out = capsys.readouterr().out
    assert "resumed from epoch 2" in out and "epoch 3/3" in out
    assert "epoch 1/3" not in out
    assert mgr.restore()[0]["step"] == 6
    rows = open(logdir / "training.log").read().splitlines()
    assert rows[0].startswith("epoch,loss,noise_mse,latent_fid")
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "1", "2"]

    _run(tmp_path, "--test_dm", "--sampler", "ddim", "--sample_steps", "3",
         "--save_nifti")
    assert "adopted from train_meta.json" in capsys.readouterr().out
    files = sorted(os.listdir(tmp_path / "out"))
    npys = [f for f in files if f.endswith(".npy")]
    assert npys == [f"smoke_cond-8rsteps-ddim3-ctx{c}.npy" for c in range(4)]
    assert len([f for f in files if f.endswith(".nii.gz")]) == 16
    for f in npys:
        vol = np.load(tmp_path / "out" / f)
        assert vol.shape == (4, 16, 16, 16, 1) and np.isfinite(vol).all()

    # serving from the checkpoint: in process, and through the serve CLI
    cfg = cli._adopt_dm_meta(cli.apply_overrides(
        get_preset("smoke_cond"), cli.build_parser().parse_args(
            ["--ckpt_dir", str(tmp_path / "ckpt")])),
        argparse.Namespace())
    svc = GenerationService.from_checkpoint(cfg, str(logdir), ema=True,
                                            device="cpu")
    assert svc.epoch == 3 and svc.trainer.ema_unet is not None
    assert svc.cfg.latent_scale == meta["latent_scale"]
    vols = svc.generate(num=2, context=3, sampler="ddim", sample_steps=4,
                        guidance_scale=2.0, seed=5)
    assert vols.shape == (2, 16, 16, 16, 1) and np.isfinite(vols).all()
    with pytest.raises(ValueError, match="EMA"):
        GenerationService.from_checkpoint(cfg, str(logdir), device="cpu")
    svc2, server = server_from_args(["--preset", "smoke_cond", "--ckpt_dir",
                                     str(logdir), "--platform", "cpu",
                                     "--port", "0"])
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        port = server.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", method="POST",
            data=json.dumps({"num": 2, "context": 3, "sampler": "ddim",
                             "sample_steps": 4, "guidance_scale": 2.0,
                             "seed": 5}).encode())
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(req, timeout=60) as resp:
            import io
            served = np.load(io.BytesIO(resp.read()))
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_array_equal(served, vols)


def test_cli_volume_path_with_recovery(tmp_path, capsys, monkeypatch):
    """--train_dm on volumes (encode every step) with --auto_resume: a
    step that fails once after the first checkpoint is recovered from it;
    --ckpt_freq 2 saves epochs 2 and 3 (the last) only."""
    fails = {"n": 0}
    real = DiffusionTrainer.train_step

    def flaky(self, *a, **kw):
        if self.step == 4 and not fails["n"]:   # epoch 3
            fails["n"] += 1
            raise RuntimeError("injected fault")
        return real(self, *a, **kw)
    monkeypatch.setattr(DiffusionTrainer, "train_step", flaky)
    _run(tmp_path, "--train_dm", "--synthetic", "--num_synthetic", "6",
         "--epochs", "3", "--auto_resume", "1", "--ckpt_freq", "2")
    out = capsys.readouterr().out
    assert fails["n"] == 1 and "recovered from 'RuntimeError" in out
    assert "resuming at epoch 2" in out
    mgr = CheckpointManager(str(tmp_path / "ckpt" / "smoke_cond_dm"))
    assert mgr.all_epochs() == [2, 3]
    state, _ = mgr.restore(3)
    assert state["step"] == 6 and state["ema_unet"] is None
    assert state["latent_scale"] == 1.0   # no cached latents: no AUTO


def test_cli_loads_a_jax_stage1_snapshot(tmp_path, capsys):
    """--vqvae_load_ckpt reads a stage-1 snapshot written by the JAX
    package (a VQTrainer's state through its save_state_npz) into the
    frozen VQ-VAE, and --cache_latents persists the raw latents beside
    the corpus under the snapshot's epoch, then reloads them."""
    from ldm3d.train.vq_trainer import VQTrainer
    jcfg = jpresets.get_preset("smoke_cond").diffusion.vqvae
    vq = VQTrainer(jcfg, JTrainConfig(batch_size=2, dtype="float32"))
    st = jax.jit(vq.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(4), (2, 16, 16, 16, 1)).compile(
        compiler_options=FAST)(jax.random.PRNGKey(4))
    snap = str(tmp_path / "stage1.npz")
    jexport.save_state_npz(snap, st, {"epoch": 7})
    _run(tmp_path, "--train_dm", "--cache_latents", "--synthetic",
         "--num_synthetic", "6", "--epochs", "1", "--vqvae_load_ckpt", snap)
    out = capsys.readouterr().out
    assert "loaded stage-1 VQ-VAE weights from epoch 7" in out
    disk = tmp_path / "cache" / "latents_s1ep7_b2.npz"
    assert disk.exists() and "persisted to" in out
    _run(tmp_path, "--train_dm", "--cache_latents", "--epochs", "2",
         "--resume_ckpt", "-1", "--vqvae_load_ckpt", snap)
    out = capsys.readouterr().out
    assert "loaded 4 latents from" in out
    state, _ = CheckpointManager(
        str(tmp_path / "ckpt" / "smoke_cond_dm")).restore()
    with np.load(snap) as z:
        ref = {k: z[k] for k in z.files if k != "__meta__"}
    twin = DiffusionTrainer(get_preset("smoke_cond").diffusion,
                            device="cpu")
    twin.model.load_state_dict(state["model"])
    got = export._arrays(twin.model.vqvae)
    assert got.keys() == ref.keys()
    for k, a in got.items():
        np.testing.assert_array_equal(a, ref[k].astype(np.float32))


@pytest.fixture(scope="module")
def against_jax(tmp_path_factory):
    """A JAX-written cache; the port's CLI trains one epoch on it with its
    cached latents captured; a JAX trainer of the same config."""
    d = tmp_path_factory.mktemp("vs_jax")
    cache = str(d / "cache")
    jpipe.write_synthetic_cache(cache, 6, 16, seed=0, num_classes=2)
    argv = ["--preset", "smoke_cond", "--platform", "cpu", "--cache_dir",
            cache, "--ckpt_dir", str(d / "ckpt"), "--val_perc", "0.34",
            *TRAIN, "--epochs", "1"]
    captured = {}
    real = pipeline.LatentLoader

    def capture(lat, ctx, *a, **kw):
        captured["lat"], captured["ctx"] = lat.clone(), ctx.clone()
        return real(lat, ctx, *a, **kw)
    pipeline.LatentLoader = capture
    try:
        args = cli.build_parser().parse_args(argv)
        trainer = cli.run_train_dm(
            cli.apply_overrides(get_preset("smoke_cond"), args), args)
    finally:
        pipeline.LatentLoader = real
    jargs = jcli.build_parser().parse_args(argv)
    jcfg = jcli.apply_overrides(jpresets.get_preset("smoke_cond"), jargs)
    jcfg = jcfg.diffusion
    tr = JTrainer(jcfg, JTrainConfig(batch_size=2, dtype="float32",
                                     ema_decay=0.9), conditional=True)
    init = jax.jit(tr.init_state, static_argnums=1).lower(
        jax.random.PRNGKey(0), (2, 16, 16, 16, 1)).compile(
        compiler_options=FAST)
    return dict(cache=cache, trainer=trainer, captured=captured, jcfg=jcfg,
                jtr=tr, init=init, dir=d)


def _nest(flat):
    """{'a/b/c': x} -> {'a': {'b': {'c': x}}}."""
    out = {}
    for path, x in flat.items():
        *mods, leaf = path.split("/")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = x
    return out


def test_cached_latents_match_jax_encode(against_jax):
    s = against_jax
    trainer, jtr = s["trainer"], s["jtr"]
    st = s["init"](jax.random.PRNGKey(0))
    tree = {c: _nest(t) for c, t in flax_state(trainer.model).items()}
    st = st.replace(params=tree["params"], batch_stats=tree["batch_stats"],
                    vq_stats=tree["vq_stats"])
    # JAX's loader over the same split visits the same batches
    tc = get_preset("smoke_cond").train
    tr_idx, _ = jpipe.train_val_split(6, 0.34, tc.seed)
    loader = jpipe.DataLoader(jpipe.VolumeCache(s["cache"]), 2,
                              JDataConfig(volume_size=16), seed=tc.seed,
                              train=True, indices=tr_idx)
    encode = jax.jit(jtr.encode_latents)
    lats, ctxs = zip(*((np.asarray(encode(st, v)), np.asarray(c))
                       for v, _, c in loader))
    ref = np.concatenate(lats) * trainer.cfg.latent_scale
    got = s["captured"]["lat"].numpy()
    assert got.shape == ref.shape == (4, 4, 4, 4, 8)
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) \
        <= ENCODE_REL_TOL
    np.testing.assert_array_equal(s["captured"]["ctx"].numpy(),
                                  np.concatenate(ctxs))


def test_trained_state_samples_as_jax(against_jax):
    s = against_jax
    trainer = s["trainer"]
    path = str(s["dir"] / "trained.npz")
    export.save_state_npz(path, trainer, {"epoch": 1})
    jcfg = dataclasses.replace(s["jcfg"],
                               latent_scale=trainer.cfg.latent_scale,
                               clip_sample_range=0.0)
    jtr = JTrainer(jcfg, JTrainConfig(batch_size=2, dtype="float32",
                                      ema_decay=0.9), conditional=True)
    st = jexport.load_state_npz(path, s["init"](jax.random.PRNGKey(1)))
    key = jax.random.PRNGKey(8)
    prog = jax.jit(jtr.generate_fn(SHAPE, decode=True, sampler="ddim",
                                   sample_steps=3)).lower(
        st, key, jnp.asarray(CTX)).compile(compiler_options=FAST)
    ref = np.asarray(prog(st, key, jnp.asarray(CTX)))
    twin = DiffusionTrainer(trainer.cfg, device="cpu",
                            train_cfg=trainer.train_cfg)
    export.load_state_npz(path, twin)
    x_t, noise = _jax_draws(key, "ddim", 3, twin.cfg.timesteps)
    got = twin.generate(SHAPE, torch.from_numpy(CTX), init_noise=x_t,
                        step_noise=noise, sampler="ddim",
                        sample_steps=3).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 16, 1)
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) \
        <= SAMPLE_REL_TOL


# --train_dm on volumes and on cached latents with a preset mesh of a
# 'model' axis of 2, over two processes
MODEL_MESH_FLAGS = {"volumes": ["--train_dm"],
                    "cached_latents": ["--train_dm", "--cache_latents"]}
# the smoke U-Net's widths (8, 16) are too narrow for the rule to split
# anything (64 at least): these make it split the U-Net's convs
TP_WIDTHS = (64, 128)


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory):
    """The file's runs over two processes: each run's directory (its
    one-process run at the same global batch in k1, the two-process run
    in k2) and both processes' results (each calls the CLI's main with
    --coordinator). The two-process runs share one launch of the two
    workers, each run joining a group of its own."""
    from torch_dist_workers import launch, widened
    base = tmp_path_factory.mktemp("two_process_cli")
    dirs, runs = {}, []
    cfg = widened(get_preset("smoke_cond"), widths=TP_WIDTHS)
    for name, flags in MODEL_MESH_FLAGS.items():
        d = dirs[name] = base / name
        common = ["--preset", "smoke_cond", "--platform", "cpu",
                  "--synthetic", "--num_synthetic", "6", "--volume_size",
                  "16", "--cache_dir", str(d / "cache"), "--val_perc",
                  "0.34", "--lr", "1e-5", "--epochs", "1"] + flags
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(presets, "get_preset", lambda name: cfg)
            cli.main(common + ["--lbs", "4", "--ckpt_dir", str(d / "k1")])
        runs.append({"mesh": dataclasses.asdict(MeshConfig(model=2)),
                     "widths": TP_WIDTHS, "argv": common + [
                         "--lbs", "2", "--ckpt_dir", str(d / "k2")]})
    d = dirs["space"] = base / "space"
    common = ["--preset", "smoke", "--platform", "cpu", "--train_vq",
              "--synthetic", "--num_synthetic", "12", "--volume_size", "16",
              "--cache_dir", str(d / "cache"), "--val_perc", "0.34", "--lr",
              "1e-5", "--epochs", "1"]
    cli.main(common + ["--lbs", "4", "--ckpt_dir", str(d / "k1")])
    runs.append({"mesh": {"data": 1, "space": 2}, "argv": common + [
        "--lbs", "2", "--ckpt_dir", str(d / "k2")]})
    torch.save({"runs": runs}, base / "cli_in.pt")
    ranks = launch("cli", base, timeout=400)
    return {name: (d, [r[i] for r in ranks])
            for i, (name, d) in enumerate(dirs.items())}


@pytest.mark.parametrize("name", list(MODEL_MESH_FLAGS))
def test_train_dm_over_a_model_mesh(two_process_runs, name):
    """--train_dm on volumes and on cached latents with a model = 2
    preset mesh, in two processes: a data 1 x model 2 mesh, the U-Net's
    convs split over it; process 0's training.log equals the one-process
    log at the same global batch, at the data-parallel test's tolerance
    (tests/test_torch_multiprocess.py)."""
    from test_torch_multiprocess import _log, _rows_close
    d, ranks = two_process_runs[name]
    for i, r in enumerate(ranks):
        assert f"multi-host: process {i}/2" in r["stdout"]
        assert r["meshes"] and all(m == {"data": 1, "space": 1, "model": 2}
                                   for m in r["meshes"])
    run = "smoke_cond_dm"
    _rows_close(_log(d / "k2", run), _log(d / "k1", run))
    assert CheckpointManager(str(d / "k2" / run)).all_epochs() == [1]


def test_train_vq_over_a_space_mesh(two_process_runs):
    """--train_vq in two processes (each calls the CLI's main with
    --coordinator, as --cpu_devices 2 has them do) with a space = 2 preset
    mesh: a data 1 x space 2 mesh, each process training on one depth slab
    of every volume; process 0's training.log equals the one-process log
    at the same global batch (--lbs is per process, as the JAX CLI's is
    per device), at the data-parallel test's tolerance
    (tests/test_torch_multiprocess.py)."""
    from test_torch_multiprocess import _log, _rows_close
    d, ranks = two_process_runs["space"]
    for i, r in enumerate(ranks):
        assert f"multi-host: process {i}/2" in r["stdout"]
        assert r["meshes"] and all(m == {"data": 1, "space": 2, "model": 1}
                                   for m in r["meshes"])
    _rows_close(_log(d / "k2"), _log(d / "k1"))


@pytest.mark.parametrize("flags", [
    ["--train_vq", "--preset", "vqgan_attn"],
    ["--test_vq", "--preset", "vqgan_gnorm"]], ids=["train_vq", "test_vq"])
def test_vqgan_modes_run_on_the_cpu(flags, tmp_path, monkeypatch, capsys):
    """The VQ-GAN modes (refused until the family was ported): the argv
    folds into the config the JAX CLI builds from it, and the mode runs
    at the preset's widths on 16^3 volumes with --platform cpu (--test_vq
    after a --train_vq of its own)."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    ref = jcli.apply_overrides(jpresets.get_preset(flags[2]),
                               jcli.build_parser().parse_args(flags))
    port = cli.apply_overrides(get_preset(flags[2]),
                               cli.build_parser().parse_args(flags))
    _same_fields(port, ref)
    assert port.model == "vqgan"
    base = ["--preset", flags[2], "--platform", "cpu", "--volume_size",
            "16", "--cache_dir", str(tmp_path / "c"), "--ckpt_dir",
            str(tmp_path / "k"), "--out_dir", str(tmp_path / "o"),
            "--val_perc", "0.34", "--synthetic", "--num_synthetic", "6",
            "--disc_threshold", "1"]
    with pytest.warns(UserWarning, match="LPIPS"):
        cli.main(base + ["--train_vq", "--epochs",
                         "2" if flags[0] == "--train_vq" else "1"])
    out = capsys.readouterr().out
    if flags[0] == "--train_vq":
        # epoch 1 warm, epoch 2 adversarial
        assert "epoch 2/2" in out and "val_disc_loss" in out
        log = (tmp_path / "k" / "vqgan_attn_vq" / "training.log")
        rows = [r.split(",") for r in log.read_text().splitlines()]
        col = rows[0].index("disc_loss")
        assert float(rows[1][col]) == 0.0 and float(rows[2][col]) > 0.0
        return
    cli.main(base + ["--test_vq"])
    out = capsys.readouterr().out
    assert "testing epoch 1" in out and "mean reconst MSE" in out
    recon = np.load(tmp_path / "o" / "reconst_0.npy")
    assert recon.shape == (2, 16, 16, 16, 1) and np.isfinite(recon).all()


def test_entry_points_need_a_gpu_or_platform_cpu(tmp_path):
    _skip_with_a_gpu()
    for argv in (["--create_dataset", "--synthetic"], ["--train_dm"],
                 ["--test_dm"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--preset", "smoke_cond", "--cache_dir",
                      str(tmp_path)] + argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_from_args(["--preset", "smoke_cond", "--ckpt_dir",
                          str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.write_synthetic_cache(str(tmp_path), 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_batch(torch.Generator().manual_seed(0), 1, 8)


def test_sampler_default_device_is_the_gpu():
    """With neither a device nor a generator, a sampler runs on the GPU
    (and so raises here), never quietly on the CPU."""
    _skip_with_a_gpu()
    sched = make_schedule(8, 1e-4, 0.02)
    x = torch.zeros(1, 2, 2, 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_latents(sched, lambda x, t: x, x.shape, init_noise=x,
                       step_noise=lambda t: x)
    out = sample_latents(sched, lambda x, t: x, x.shape, device="cpu",
                         init_noise=x, step_noise=lambda t: x)
    assert out.device.type == "cpu"


@pytest.mark.parametrize("flags,dtype", [([], torch.bfloat16),
                                         (["--dtype", "float32"],
                                          torch.float32)])
def test_dtype_flag_sets_the_trainers_compute_dtype(flags, dtype):
    """Without --dtype the trainers compute in the preset's dtype:
    bfloat16, JAX's default (vqvae_legacy's stage-1, and the flagship
    conditional_dm3d's config); --dtype float32 gives the float32 port.
    Parameters are float32 either way."""
    from ldm3d_torch.cli.main import _stage1_trainer
    from ldm3d_torch.core.config import compute_dtype
    parse = cli.build_parser().parse_args
    flagship = cli.apply_overrides(get_preset("conditional_dm3d"),
                                   parse(["--preset", "conditional_dm3d"]
                                         + flags))
    assert compute_dtype(flagship.train.dtype) == dtype
    cfg = cli.apply_overrides(get_preset("vqvae_legacy"), parse(
        ["--preset", "vqvae_legacy", "--volume_size", "16"] + flags))
    tr = _stage1_trainer(cfg, "cpu")
    with torch.no_grad():
        recon, aux = tr.model(torch.zeros((1, 16, 16, 16, 1)))
    assert recon.dtype == dtype
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    # the smoke presets pin float32, as JAX's smoke preset does
    assert get_preset("smoke_cond").train.dtype == "float32"

"""The port runs without JAX: a rehearsal of the GPU machine, which has no
jax, flax or optax.

A subprocess blocks `jax`, `flax`, `optax` and the JAX package `ldm3d` in
`sys.modules` before anything is imported, then imports `chip_smoke`,
serves the tiny slice (DDPM, and guided DDIM), imports the HTTP front,
builds a NIfTI response, runs the tiny training slice (encode, latent
scale, steps on volumes and on latents) and a latent-FID evaluation on the
CPU, then the command line at `smoke_cond` (--create_dataset, --train_dm
--cache_latents, --resume_ckpt -1, --test_dm) and serves from its
checkpoint, stage-1 at `smoke` (--train_vq, --test_vq) and the VQ-GAN
at `vqgan_attn` on 16^3 volumes (--train_vq for a warm and an
adversarial epoch, --test_vq), a --fidelity_sweep under --profile, a
bayes --sweep of one --train_vq point on --device_data, the native
reader, the profiling helpers, the offline plots, `parallel/` (a
one-process mesh, halo conv and spatial context), a two-process
--train_vq
(--cpu_devices 2, whose processes start afresh) and the tools
(`ldm3d_torch/tools/`: a snapshot exported and served,
recalibrate_bn on the stage-1, emit_sbatch and the reports), with `bench`, `__graft_entry__` and `tools` blocked too. The
sources of the port (every module under `ldm3d_torch/`, `parallel/` and
`tools/` included, so the CLI, data, checkpoint and export modules too)
and of `chip_smoke.py` are also searched for imports of any of them.
"""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch
from torch_threads import TORCH_THREADS
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "flax", "optax", "ldm3d", "bench", "__graft_entry__",
           "tools")

_REHEARSAL = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None        # any import of them raises ImportError
sys.path.insert(0, {REPO!r})
import numpy as np
import chip_smoke                   # the smoke script's imports, JAX-free
from ldm3d_torch.core.config import flagship_cfg
from ldm3d_torch.serve import GenerationService
svc = GenerationService.from_random_init(flagship_cfg(tiny=True), seed=0,
                                         device="cpu")
vols = svc.generate(num=2, context=1, seed=3)
assert vols.shape == (2, 16, 16, 16, 1) and np.isfinite(vols).all()
import dataclasses
from ldm3d_torch.data.nifti import nifti_bytes
from ldm3d_torch.ops.fid import latent_fidelity
from ldm3d_torch.serve import serve
cfg = flagship_cfg(tiny=True)
guided = GenerationService.from_random_init(dataclasses.replace(
    cfg, unet=dataclasses.replace(cfg.unet, cfg_dropout=0.1)), seed=0,
    device="cpu")
g = guided.generate(num=2, context=1, sampler="ddim", sample_steps=3,
                    guidance_scale=3.0, seed=3)
assert g.shape == (2, 16, 16, 16, 1) and np.isfinite(g).all()
assert len(nifti_bytes(g[0])) == 352 + 4 * 16 ** 3
import torch
from ldm3d_torch.core.config import TrainConfig
from ldm3d_torch.train.dm_trainer import DiffusionTrainer, auto_latent_scale
tr = DiffusionTrainer(flagship_cfg(tiny=True), device="cpu",
                      train_cfg=TrainConfig(dtype="float32", batch_size=2,
                                            ema_decay=0.999))
tr.init_random(0)
images = torch.from_numpy(vols)
lat = tr.encode_latents(images)
cfg = auto_latent_scale(float(lat.std()), tr.cfg)
tr.set_latent_scale(cfg.latent_scale, cfg.clip_sample_range)
ctx = torch.tensor([1, 0])
for m in (tr.train_step(images, ctx),
          tr.train_step_latents(lat * cfg.latent_scale, ctx)):
    assert all(np.isfinite(float(v)) for v in m.values()), m
assert tr.step == 2 and tr.ema_unet is not None
real = tr.latent_features(images)
scores = tr.fidelity_eval(real, torch.Generator().manual_seed(0),
                          num_samples=2, batch=1, sample_steps=2)
assert np.isfinite(scores["latent_fid"]), scores
import tempfile
from ldm3d_torch.cli.main import main as cli_main
from ldm3d_torch.core.presets import get_preset
with tempfile.TemporaryDirectory() as d:
    base = ["--preset", "smoke_cond", "--platform", "cpu", "--cache_dir",
            d + "/cache", "--ckpt_dir", d + "/ckpt", "--out_dir", d + "/out",
            "--val_perc", "0.34"]
    cli_main(base + ["--create_dataset", "--synthetic", "--num_synthetic",
                     "6"])
    cli_main(base + ["--train_dm", "--cache_latents", "--epochs", "1",
                     "--ema_decay", "0.9"])
    cli_main(base + ["--train_dm", "--cache_latents", "--epochs", "2",
                     "--ema_decay", "0.9", "--resume_ckpt", "-1"])
    cli_main(base + ["--test_dm", "--sampler", "ddim", "--sample_steps",
                     "2"])
    served = GenerationService.from_checkpoint(
        get_preset("smoke_cond"), d + "/ckpt/smoke_cond_dm", ema=True,
        device="cpu").generate(num=1, sampler="ddim", sample_steps=2)
    assert served.shape == (1, 16, 16, 16, 1) and np.isfinite(served).all()
    s1 = ["--preset", "smoke"] + base[2:]
    cli_main(s1 + ["--train_vq", "--epochs", "1"])
    cli_main(s1 + ["--test_vq"])
    import os
    assert os.path.exists(d + "/out/reconst_0.npy")
    os.remove(d + "/out/reconst_0.npy")
    gan = ["--preset", "vqgan_attn", "--volume_size", "16",
           "--disc_threshold", "1"] + base[2:]
    cli_main(gan + ["--train_vq", "--epochs", "2"])
    cli_main(gan + ["--test_vq"])
    assert os.path.exists(d + "/out/reconst_0.npy")
    cli_main(base + ["--fidelity_sweep", "--fidelity_samples", "2",
                     "--sweep_samplers", "ddim:2", "--guidance_grid",
                     "none,3", "--fidelity_by_class", "--profile"])
    assert os.path.exists(d + "/out/fidelity_sweep_smoke_cond.md")
    assert os.listdir(d + "/ckpt/trace")
    with open(d + "/sweep.yaml", "w") as f:
        f.write("method: bayes\\nparameters:\\n  lr:\\n"
                "    values: [0.001]\\n  epochs:\\n    value: 1\\n")
    cli_main(s1 + ["--sweep", d + "/sweep.yaml", "--synthetic",
                   "--device_data", "--ckpt_dir", d + "/sweep"])
    with open(d + "/sweep/sweep_results.jsonl") as f:
        assert len(f.read().splitlines()) == 1
    from ldm3d_torch.data.native import NativeReader
    from ldm3d_torch.data.pipeline import DataLoader, VolumeCache
    from ldm3d_torch.core.config import DataConfig
    loader = DataLoader(VolumeCache(d + "/cache"), 2,
                        DataConfig(volume_size=16), device="cpu")
    assert loader.reader == "native" and len(list(loader)) == 3
    from ldm3d_torch.utils import profiling, visualize
    timer = profiling.StepTimer()
    for _ in range(2):
        timer.time_step(torch.matmul, torch.ones(8, 8), torch.ones(8, 8))
    assert timer.summary()["steps"] == 1.0
    assert profiling.cost_estimate(torch.matmul, torch.ones(4, 4),
                                   torch.ones(4, 4))["flops"] == 128.0
    log = d + "/ckpt/smoke_vq/training.log"
    assert "loss" in visualize.read_training_log(log)
    visualize.main(["loss", log, "--out", d + "/loss.png"])
    assert os.path.exists(d + "/loss.png")
    from ldm3d_torch.parallel.halo import halo_conv3d
    from ldm3d_torch.parallel.mesh import make_mesh
    y = halo_conv3d(torch.ones(1, 4, 4, 4, 2), torch.ones(3, 3, 3, 2, 3),
                    None, 1, make_mesh())
    assert y.shape == (1, 4, 4, 4, 3) and float(y[0, 1, 1, 1, 0]) == 54.0
    from ldm3d_torch.parallel.spatial import shard_spatial, spatial_sharding
    with spatial_sharding(make_mesh()):
        x = torch.ones(1, 4, 4, 4, 2)
        assert shard_spatial(x) is x
    cli_main(s1 + ["--train_vq", "--epochs", "1", "--lbs", "1",
                   "--cpu_devices", "2", "--ckpt_dir", d + "/mp"])
    assert os.listdir(d + "/mp") == ["smoke_vq"]
    from ldm3d_torch.tools import (dm_comparison, emit_sbatch,
                                   export_flagship, gan_ab, quality_report,
                                   recalibrate_bn)
    export_flagship.flagship_cfg = lambda: get_preset("smoke_cond").diffusion
    dm = d + "/ckpt/smoke_cond_dm"
    export_flagship.main(["--ckpt", dm, "--out", d + "/f16.npz",
                          "--platform", "cpu"])
    from ldm3d_torch.serve import server_from_args
    snap, server = server_from_args(["--preset", "smoke_cond", "--ckpt_dir",
                                     d + "/f16.npz", "--platform", "cpu",
                                     "--port", "0"])
    server.server_close()
    assert np.isfinite(snap.generate(num=1, sampler="ddim",
                                     sample_steps=2)).all()
    recalibrate_bn.main(["--preset", "smoke", "--ckpt_dir",
                         d + "/ckpt/smoke_vq", "--cache_dir", d + "/cache",
                         "--lbs", "2", "--passes", "1", "--platform", "cpu"])
    assert os.listdir(d + "/ckpt/smoke_vq_bnr") == ["1.pt"]
    emit_sbatch.main(["--preset", "smoke", "--nodes", "2", "--out",
                      d + "/s.sbatch"])
    quality_report.main([log])
    dm_comparison.main(["A=" + dm + "/training.log"])
    gan_ab.main(["A=" + log, "B=" + log])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None)
assert not loaded, loaded
print("REHEARSAL_OK")
"""


def _env():
    """The environment of the subprocesses: no PYTHONPATH, and torch's
    threads as the tests' (`torch_threads`)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.setdefault("OMP_NUM_THREADS", str(TORCH_THREADS))
    return env


def test_tiny_slice_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _REHEARSAL], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "REHEARSAL_OK" in proc.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax|ldm3d|bench|__graft_entry__|tools)\b|"
    r"from\s+(jax|flax|optax|ldm3d|bench|__graft_entry__|tools)(\.|\s))",
    re.M)


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO, "ldm3d_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_sources_import_no_jax():
    hits = []
    sources = list(_port_sources())
    for module in (("parallel", "spatial.py"), ("tools", "r5_diag.py")):
        assert os.path.join(REPO, "ldm3d_torch", *module) in sources
    for path in sources:
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0)}")
    assert not hits, hits


def test_chip_smoke_fails_without_the_repo(tmp_path):
    # Alone in a directory, the script cannot import the port: it must
    # exit non-zero and print no result line.
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=_env())
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=_env())
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout

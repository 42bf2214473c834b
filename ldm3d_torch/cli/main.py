"""The command line of the PyTorch port: `python -m ldm3d_torch.cli.main`,
the port of `ldm3d.cli.main` with the same flags, destinations and
defaults.

    python -m ldm3d_torch.cli.main --preset smoke_cond --platform cpu \
        --create_dataset --synthetic --cache_dir ./cache
    python -m ldm3d_torch.cli.main --preset conditional_dm3d --train_dm \
        --cache_latents --epochs 100 --lbs 8 --ema_decay 0.999
    python -m ldm3d_torch.cli.main --preset conditional_dm3d --test_dm \
        --sampler ddim --sample_steps 50

Ported modes: --create_dataset (synthetic or NIfTI); --train_vq and
--test_vq (stage-1 training with the validation pass, the plateau
schedule and unused-code replacement, and the held-out reconstructions):
the VQ-VAE family (every quantizer kind; `emavqvae`; `vqvae_legacy` and
--vqvae_mode 1 / 2) through `VQTrainer`, and the VQ-GAN presets
(`model == "vqgan"`) through `GANTrainer`, with --disc_threshold,
--disc_lr, --adaptive_gan_weight, --adaptive_g_max, --g_adv_delay and
--r1_gamma; --train_dm (on volumes or, with --cache_latents, on
latents encoded once and cached on disk beside the corpus when a stage-1
is loaded), with the AUTO latent scale, train_meta.json, --resume_ckpt,
--auto_resume, --ckpt_freq, --fidelity_freq and --image_log_freq;
--test_dm; --fidelity_sweep (latent-FID and kernel-MMD of a restored
stage-2 checkpoint over a grid of samplers x guidance scales, written as
`fidelity_sweep_<name>.json` and `.md` under --out_dir); --sweep (a
hyper-parameter sweep of --train_vq runs over a W&B-style YAML, grid,
random or bayes, `ldm3d_torch.core.sweep`, recorded in
`{ckpt_dir}/sweep_results.jsonl`); --device_data (with --synthetic: the
corpus's batches computed on the device instead of read from the cache);
--profile (the whole run under a `torch.profiler` trace, written under
`{ckpt_dir}/trace/`). The run goes on the GPU unless `--platform cpu` is
given; with no GPU visible it raises. Checkpoints are
`ldm3d_torch.train.checkpoint` files (one `torch.save` of the trainer's
whole state per epoch) under `{ckpt_dir}/{name}_vq/` and
`{ckpt_dir}/{name}_dm/`. `--vqvae_load_ckpt`
reads a stage-1 VQ-VAE from a `--train_vq` checkpoint directory (its
latest epoch) or from a snapshot in the JAX package's `.npz` export
layout (`ldm3d_torch.utils.export`); the stage-1 must have the
architecture of the preset's `diffusion.vqvae`, or it is refused.

    python -m ldm3d_torch.cli.main --preset vqvae_dm_stage1 --norm group \
        --train_vq --epochs 100 --lbs 8
    python -m ldm3d_torch.cli.main --preset conditional_dm3d --norm group \
        --train_dm --cache_latents \
        --vqvae_load_ckpt ./checkpoints/vqvae_dm_stage1_vq
    python -m ldm3d_torch.cli.main --preset vqgan_attn --train_vq \
        --synthetic --disc_threshold 1 --epochs 2

Without `LDM3D_LPIPS_WEIGHTS` (a converted VGG16 + LPIPS `.npz`) the
VQ-GAN's perceptual loss is a self-calibrated random-feature surrogate.
    python -m ldm3d_torch.cli.main --preset conditional_dm3d --norm group \
        --fidelity_sweep --sweep_samplers ddim:10,dpmpp:10 \
        --guidance_grid none,3 --fidelity_by_class
    python -m ldm3d_torch.cli.main --preset vqvae_dm_stage1 --norm group \
        --sweep sweep.yaml --sweep_count 4 --synthetic --device_data

Data-parallel training over N processes (`ldm3d_torch.parallel`):
--coordinator host:port, --num_processes N and --process_id i (or the
LDM3D_COORDINATOR / LDM3D_NUM_PROCESSES / LDM3D_PROCESS_ID variables)
join one process per device, process i on `cuda:(i % cards)`; with
--platform cpu, --cpu_devices N starts N such processes of the command
on a free localhost port and returns when all have ended. --lbs is then
the batch of each process (global batch = lbs x processes, as the JAX
CLI's lbs x devices, whatever the mesh); each process reads its rows of
every global batch, process 0 alone writes logs, images,
train_meta.json and checkpoints, and the modes that do not train
(--create_dataset, --test_vq, --test_dm, --fidelity_sweep) and the
--fidelity_freq evaluation runs on every process (process 0 logs it).
A 'space' axis S of the preset's mesh (`MeshConfig.space`) splits the
depth of every volume over S processes (`ldm3d_torch.parallel.spatial`):
each process reads and trains on its depth slab of its rows. A 'model'
axis M (`MeshConfig.model`) splits the wide conv kernels and vectors of
the trained networks over M processes (`ldm3d_torch.parallel.tp`),
which read the same rows and hold the same activations. The processes
form a (processes / (S x M)) x S x M data x space x model mesh; as in
the JAX CLI, the axes come from the preset's mesh and no flag sets
them. Every process decides each save and takes the trainer's state
(whole tensors, gathered over the model axis); process 0 writes it.
--auto_resume works over processes: a failure that every process can
see (a batch's fetch, the epoch's callbacks, logging or save) is agreed
on, and all restore the epoch process 0 saved last; a failure inside a
step on one process alone leaves the others waiting in the step's
collective (see `ldm3d_torch.train.loop`).

    python -m ldm3d_torch.cli.main --preset smoke --platform cpu \
        --cpu_devices 2 --train_vq --synthetic --lbs 1
    python -m ldm3d_torch.cli.main --preset conditional_dm3d --norm group \
        --train_dm --cache_latents --lbs 4 --coordinator host0:29500 \
        --num_processes 8 --process_id 0
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from ldm3d_torch.core.config import replace
from ldm3d_torch.core.device import resolve_device
from ldm3d_torch.parallel import distributed as pdist
from ldm3d_torch.parallel.spatial import gather_volume
from ldm3d_torch.train.meta import adopt_meta, load_meta, train_meta


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ldm3d_torch",
                                description="3D latent diffusion, PyTorch")
    p.add_argument("--preset", default="vqvae_b8_all")
    # modes
    p.add_argument("--create_dataset", action="store_true")
    p.add_argument("--train_vq", action="store_true")
    p.add_argument("--test_vq", action="store_true")
    p.add_argument("--train_dm", action="store_true")
    p.add_argument("--test_dm", action="store_true")
    # data
    p.add_argument("--dataset", default=None,
                   help="CC|NFBS|HCP|BraTS|all|all-T")
    p.add_argument("--dataset_dir", default=None)
    p.add_argument("--cache_dir", default=None)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="use generated volumes (no NIfTI data needed)")
    p.add_argument("--device_data", action="store_true",
                   help="with --synthetic: compute the corpus's batches on "
                        "the device instead of reading the cache")
    p.add_argument("--num_synthetic", type=int, default=24)
    p.add_argument("--num_classes", type=int, default=None,
                   help="synthetic-corpus class count; also sizes the "
                        "conditional U-Net's context embedding")
    p.add_argument("--volume_size", type=int, default=None)
    # training
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lbs", type=int, default=None,
                   help="batch size per process (global = lbs * processes)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--val_perc", type=float, default=None)
    p.add_argument("--kernel_resize", action="store_true")
    p.add_argument("--suffix", default=None)
    p.add_argument("--test_epoch", type=int, default=None)
    p.add_argument("--save_best_only", action="store_true")
    p.add_argument("--vqvae_load_ckpt", type=str, default=None,
                   help="stage-1 VQ-VAE: a --train_vq checkpoint directory "
                        "or a snapshot (.npz, export layout)")
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--norm", default=None, choices=["batch", "group"],
                   help="normalization family of the autoencoder")
    p.add_argument("--resume_ckpt", type=int, default=None,
                   help="resume from this checkpoint epoch; -1 resumes the "
                        "latest if one exists and starts fresh otherwise")
    p.add_argument("--test_run", action="store_true")
    p.add_argument("--vqvae_mode", type=int, default=None, choices=[1, 2])
    p.add_argument("--num_embeddings", type=int, default=None)
    p.add_argument("--embedding_dim", type=int, default=None)
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                   help="compute dtype of the trainers' networks "
                        "(default bfloat16; parameters stay float32)")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--ckpt_freq", type=int, default=1,
                   help="save a checkpoint every N epochs (the final "
                        "epoch is always saved)")
    p.add_argument("--out_dir", default="./generated_images_dm3d")
    p.add_argument("--profile", action="store_true",
                   help="trace the run with torch.profiler into "
                        "{ckpt_dir}/trace")
    p.add_argument("--disc_threshold", type=int, default=None)
    p.add_argument("--adaptive_gan_weight", action="store_true",
                   default=None)
    p.add_argument("--adaptive_g_max", type=float, default=None)
    p.add_argument("--g_adv_delay", type=int, default=None)
    p.add_argument("--r1_gamma", type=float, default=None)
    p.add_argument("--disc_lr", type=float, default=None)
    p.add_argument("--auto_resume", type=int, default=0, metavar="N",
                   help="on a training crash, restore the latest "
                        "checkpoint and resume, up to N times")
    p.add_argument("--sampler", default="ddpm",
                   choices=["ddpm", "ddim", "dpmpp", "dpmpp_sde"],
                   help="test_dm sampler")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="strided sampler U-Net evaluations (default "
                        "timesteps//20)")
    p.add_argument("--eta", type=float, default=0.0,
                   help="DDIM stochasticity (0 = deterministic)")
    p.add_argument("--guidance_scale", type=float, default=None,
                   help="classifier-free guidance scale for test_dm "
                        "(needs a model trained with cfg_dropout > 0)")
    p.add_argument("--prediction_type", default=None,
                   choices=["eps", "v"])
    p.add_argument("--min_snr_gamma", type=float, default=None)
    p.add_argument("--loss_reduction", default=None,
                   choices=["mean", "ref"])
    p.add_argument("--cfg_dropout", type=float, default=None,
                   help="context-drop probability during --train_dm")
    p.add_argument("--save_nifti", action="store_true",
                   help="with --test_dm/--test_vq: also export volumes as "
                        ".nii.gz")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="EMA decay of the U-Net weights during --train_dm; "
                        "sampling then uses the averaged weights")
    p.add_argument("--fidelity_freq", type=int, default=0,
                   help="with --train_dm: latent-FID / kernel-MMD every N "
                        "epochs; 0 disables")
    p.add_argument("--fidelity_samples", type=int, default=64,
                   help="generated samples per fidelity eval")
    p.add_argument("--unet_stem", type=int, default=None)
    p.add_argument("--unet_widths", type=str, default=None,
                   help="comma list of denoiser level widths")
    p.add_argument("--unet_attention", type=str, default=None,
                   help="comma list of 0/1 per level (middle always "
                        "attends)")
    p.add_argument("--latent_scale", type=float, default=None,
                   help="multiply the frozen encoder's latents before "
                        "diffusion, divide before decode")
    p.add_argument("--clip_sample_range", type=float, default=None,
                   help="samplers' clipping half-width; <= 0 disables")
    p.add_argument("--context_in_time", action="store_true", default=None)
    p.add_argument("--fidelity_by_class", action="store_true",
                   help="conditional models: also report per-class FID")
    p.add_argument("--fidelity_sweep", action="store_true",
                   help="latent-FID / kernel-MMD of a trained DM checkpoint "
                        "over --sweep_samplers x --guidance_grid")
    p.add_argument("--sweep_samplers", default="ddpm,ddim:50,dpmpp:25",
                   help="comma list of sampler[:steps[:eta]]")
    p.add_argument("--guidance_grid", default="none",
                   help="comma list of guidance scales (none = unguided)")
    p.add_argument("--cache_latents", action="store_true",
                   help="with --train_dm: encode the corpus once through "
                        "the frozen stage-1 and train from device-resident "
                        "latents")
    p.add_argument("--image_log_freq", type=int, default=0,
                   help="save generated-sample slice montages every N "
                        "epochs; 0 disables")
    p.add_argument("--sweep", type=str, default=None,
                   help="sweep YAML (W&B schema): train one --train_vq run "
                        "per point")
    p.add_argument("--sweep_count", type=int, default=None)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for multi-process training "
                        "(or set LDM3D_COORDINATOR)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="the device: the GPU by default; cpu runs the "
                        "plain PyTorch path on the CPU")
    p.add_argument("--cpu_devices", type=int, default=0,
                   help="with --platform cpu: run the command in this many "
                        "local processes, one mesh device each")
    return p


def _mesh(cfg):
    """The training mesh: `make_mesh` of the preset's mesh (data, space
    and model axes) over the run's processes at the global batch."""
    from ldm3d_torch.parallel.mesh import make_mesh
    return make_mesh(cfg.train.mesh, batch_size=cfg.train.batch_size)


def _device(args) -> torch.device:
    """This process's device in a multi-process run, else the GPU unless
    --platform cpu; raises when no GPU is visible."""
    if pdist.process_device() is not None:
        return pdist.process_device()
    return resolve_device("cpu" if args.platform == "cpu" else None)


def apply_overrides(cfg, args):
    """Fold CLI flags into the preset's config tree (the global batch is
    --lbs times the number of processes)."""
    train = cfg.train
    if args.lr is not None:
        train = replace(train, learning_rate=args.lr)
    if getattr(args, "disc_lr", None) is not None:
        train = replace(train, disc_learning_rate=args.disc_lr)
    if args.epochs is not None:
        train = replace(train, epochs=args.epochs)
    if args.lbs is not None:
        train = replace(train, batch_size=args.lbs * pdist.process_count())
    if args.val_perc is not None:
        train = replace(train, val_fraction=args.val_perc)
    if args.dtype is not None:
        train = replace(train, dtype=args.dtype)
    if getattr(args, "ema_decay", None) is not None:
        train = replace(train, ema_decay=args.ema_decay)
    cfg = replace(cfg, train=train)

    data = cfg.data
    if args.dataset is not None:
        data = replace(data, dataset=args.dataset)
    if args.dataset_dir is not None:
        data = replace(data, dataset_dir=args.dataset_dir)
    if args.cache_dir is not None:
        data = replace(data, cache_dir=args.cache_dir)
    if args.volume_size is not None:
        data = replace(data, volume_size=args.volume_size)
    if args.augment:
        data = replace(data, augment=True)
    if args.test_run:
        data = replace(data, test_run=True)
    if getattr(args, "num_classes", None) is not None:
        data = replace(data, num_classes=args.num_classes)
        if cfg.diffusion.unet.context_dim:
            # context ids run 0..num_classes-1
            cfg = replace(cfg, diffusion=replace(
                cfg.diffusion, unet=replace(cfg.diffusion.unet,
                                            context_dim=args.num_classes - 1)))
    cfg = replace(cfg, data=data)

    vq = cfg.vqvae
    q = vq.quantizer
    if args.num_embeddings is not None:
        q = replace(q, num_embeddings=args.num_embeddings)
    if args.embedding_dim is not None:
        q = replace(q, embedding_dim=args.embedding_dim)
    vq = replace(vq, quantizer=q)
    if args.kernel_resize:
        vq = replace(vq, kernel_resize=True)
    if args.vqvae_mode is not None:
        vq = replace(vq, family="legacy", legacy_mode=args.vqvae_mode)
    if args.norm is not None:
        vq = replace(vq, norm=args.norm)
    cfg = replace(cfg, vqvae=vq)

    diff = cfg.diffusion
    if args.norm is not None:
        diff = replace(diff, vqvae=replace(diff.vqvae, norm=args.norm))
    if getattr(args, "unet_stem", None) is not None:
        diff = replace(diff, unet=replace(diff.unet,
                                          first_conv_channels=args.unet_stem))
    if getattr(args, "unet_widths", None) is not None:
        widths = tuple(int(w) for w in args.unet_widths.split(","))
        attn = diff.unet.has_attention
        if len(attn) != len(widths) + 1:
            # level count changed: attention on the deepest level + middle
            attn = (False,) * (len(widths) - 1) + (True, True)
        diff = replace(diff, unet=replace(diff.unet, widths=widths,
                                          has_attention=attn))
    if getattr(args, "unet_attention", None) is not None:
        attn = tuple(bool(int(v))
                     for v in args.unet_attention.split(",")) + (True,)
        diff = replace(diff, unet=replace(diff.unet, has_attention=attn))
    if args.timesteps is not None:
        diff = replace(diff, timesteps=args.timesteps)
    if getattr(args, "cfg_dropout", None) is not None:
        diff = replace(diff, unet=replace(diff.unet,
                                          cfg_dropout=args.cfg_dropout))
    if getattr(args, "context_in_time", None):
        diff = replace(diff, unet=replace(diff.unet, context_in_time=True))
    if getattr(args, "prediction_type", None) is not None:
        diff = replace(diff, prediction_type=args.prediction_type)
    if getattr(args, "min_snr_gamma", None) is not None:
        diff = replace(diff, min_snr_gamma=args.min_snr_gamma)
    if getattr(args, "latent_scale", None) is not None:
        diff = replace(diff, latent_scale=args.latent_scale)
    if getattr(args, "loss_reduction", None) is not None:
        diff = replace(diff, loss_reduction=args.loss_reduction)
    if getattr(args, "clip_sample_range", None) is not None:
        diff = replace(diff, clip_sample_range=args.clip_sample_range)
    cfg = replace(cfg, diffusion=diff)

    gan = cfg.vqgan
    if args.disc_threshold is not None:
        gan = replace(gan, disc_threshold=args.disc_threshold)
    if getattr(args, "adaptive_gan_weight", None):
        gan = replace(gan, adaptive_g_weight=True)
    if getattr(args, "r1_gamma", None) is not None:
        gan = replace(gan, r1_gamma=args.r1_gamma)
    if getattr(args, "adaptive_g_max", None) is not None:
        gan = replace(gan, adaptive_g_max=args.adaptive_g_max)
    if getattr(args, "g_adv_delay", None) is not None:
        gan = replace(gan, g_adv_delay=args.g_adv_delay)
    cfg = replace(cfg, vqgan=gan)

    if args.ckpt_dir is not None:
        cfg = replace(cfg, ckpt_dir=args.ckpt_dir)
    if args.suffix is not None:
        cfg = replace(cfg, name=args.suffix)
    return cfg


def _loaders(cfg, args, device, mesh=None):
    """Train and val loaders over the cache (written first, by process 0,
    from the synthetic corpus with --synthetic when there is none), or
    with --synthetic --device_data over the corpus computed on the device;
    the val loader is None when the split is smaller than a batch. With a
    `mesh` each yields this process's rows of every global batch."""
    from ldm3d_torch.data.pipeline import (DataLoader,
                                           DeviceSyntheticLoader,
                                           VolumeCache, train_val_split,
                                           write_synthetic_cache)

    if args.synthetic and args.device_data:
        n = args.num_synthetic
        tr, va = train_val_split(n, cfg.train.val_fraction, cfg.train.seed)

        def make(idx, train):
            return DeviceSyntheticLoader(
                n, cfg.train.batch_size, cfg.data, corpus_seed=cfg.train.seed,
                seed=cfg.train.seed, train=train, indices=idx, device=device,
                mesh=mesh)
        val = make(va, False) if len(va) >= cfg.train.batch_size else None
        return make(tr, True), val
    cache_dir = cfg.data.cache_dir
    manifest = os.path.join(cache_dir, "manifest.json")
    if (args.synthetic and not os.path.exists(manifest)
            and pdist.is_primary()):
        write_synthetic_cache(cache_dir, args.num_synthetic,
                              cfg.data.volume_size, seed=cfg.train.seed,
                              num_classes=cfg.data.num_classes,
                              device=device)
    if args.synthetic:
        pdist.barrier()
    if not os.path.exists(manifest):
        raise SystemExit(
            f"no cache at {cache_dir}: run --create_dataset first "
            f"(or pass --synthetic)")
    cache = VolumeCache(cache_dir)
    tr, va = train_val_split(cache, cfg.train.val_fraction, cfg.train.seed)
    train = DataLoader(cache, cfg.train.batch_size, cfg.data,
                       seed=cfg.train.seed, train=True, indices=tr,
                       device=device, mesh=mesh)
    val = DataLoader(cache, cfg.train.batch_size, cfg.data,
                     seed=cfg.train.seed, train=False, indices=va,
                     device=device, mesh=mesh) \
        if len(va) >= cfg.train.batch_size else None
    return train, val


def _ckpt_dir(cfg, stage: str) -> str:
    return os.path.join(cfg.ckpt_dir, f"{cfg.name}_{stage}")


def _maybe_resume(ckpt, trainer, resume_ckpt) -> int:
    """Restore per --resume_ckpt into `trainer`: None = fresh start, N >= 0
    = that epoch (raises if missing), -1 = the latest if one exists, else
    a fresh start. Returns the epoch to start from."""
    if resume_ckpt is None:
        return 0
    try:
        state, epoch = ckpt.restore(None if resume_ckpt < 0 else resume_ckpt)
    except FileNotFoundError:
        if resume_ckpt >= 0:
            raise
        return 0
    if "ema_unet" in state and (
            (state["ema_unet"] is not None)
            != (trainer.train_cfg.ema_decay > 0)):
        # the JAX restore fails on the state tree's mismatch
        raise ValueError(
            f"checkpoint epoch {epoch} in {ckpt.directory} "
            + ("holds" if state["ema_unet"] is not None else "has no")
            + " EMA weights: resume with the --ema_decay it was trained "
              "with")
    trainer.load_state_dict(state)
    print(f"resumed from epoch {epoch}")
    return epoch


def _stage1_trainer(cfg, device, mesh=None):
    """A `GANTrainer` when the preset's model is "vqgan", else a
    `VQTrainer` of `cfg.vqvae`."""
    if cfg.model == "vqgan":
        from ldm3d_torch.train.gan_trainer import GANTrainer
        return GANTrainer(cfg.vqgan, cfg.train, device=device,
                          volume_size=cfg.data.volume_size, mesh=mesh)
    from ldm3d_torch.train.vq_trainer import VQTrainer
    return VQTrainer(cfg.vqvae, cfg.train, device=device, mesh=mesh)


def run_train_vq(cfg, args):
    """Stage-1 training (a VQ-VAE, or a VQ-GAN when the preset's model is
    "vqgan"); returns the trainer."""
    from ldm3d_torch.train.callbacks import (CSVLogger,
                                             DelayedReduceLROnPlateau,
                                             ImageLogger, MetricsLogger,
                                             ReduceLROnPlateau)
    from ldm3d_torch.train.checkpoint import CheckpointManager
    from ldm3d_torch.train.loop import fit, fit_with_recovery

    mesh = _mesh(cfg)
    device = _device(args)
    train_loader, val_loader = _loaders(cfg, args, device, mesh)
    is_gan = cfg.model == "vqgan"
    trainer = _stage1_trainer(cfg, device, mesh).init_random(cfg.train.seed)
    primary = pdist.is_primary()
    if is_gan:
        # the autoencoder's rate, once the critics have started
        lr_sched = DelayedReduceLROnPlateau(
            start_epoch=cfg.vqgan.disc_threshold, monitor="val_loss",
            factor=0.5, patience=10)
    else:
        lr_sched = ReduceLROnPlateau(monitor="val_loss", factor=0.5,
                                     patience=10)
    logdir = _ckpt_dir(cfg, "vq")
    ckpt = CheckpointManager(logdir, keep=cfg.train.keep_checkpoints,
                             save_best_only=args.save_best_only,
                             write=primary)
    initial_epoch = _maybe_resume(ckpt, trainer, args.resume_ckpt)

    image_logger = None
    if args.image_log_freq:
        batches = iter(val_loader or train_loader)
        vol, mask, _ = next(batches)
        batches.close()

        def render(tr):
            recon, _ = tr.reconstruct(vol, mask)
            # over a space mesh, the whole volumes of the depth slabs
            whole, rec = (gather_volume(mesh, v) for v in (vol, recon))
            return {"original": whole[:2].float().cpu().numpy(),
                    "reconstruction": rec[:2, ..., :1].float().cpu()
                    .numpy()}

        image_logger = ImageLogger(os.path.join(logdir, "images"), render,
                                   log_freq=args.image_log_freq,
                                   write=primary)
    fit_fn = fit if not args.auto_resume else functools.partial(
        fit_with_recovery, max_restarts=args.auto_resume)
    metrics = fit_fn(
        trainer, train_loader, cfg.train.epochs, val_loader=val_loader,
        ckpt=None if args.test_run else ckpt,
        image_logger=image_logger,
        csv_logger=CSVLogger(os.path.join(logdir, "training.log"),
                             append=args.resume_ckpt is not None)
        if primary else None,
        metrics_logger=MetricsLogger(os.path.join(logdir, "metrics.jsonl"),
                                     run_name=cfg.name) if primary else None,
        lr_schedule=lr_sched,
        # the VQ-GAN's quantizers replace no codes between epochs
        replace_codebook_freq=0 if is_gan
        else cfg.train.replace_codebook_freq,
        initial_epoch=initial_epoch, ckpt_freq=args.ckpt_freq,
        step_fn=lambda batch: trainer.train_step(batch[0], batch[1]),
        is_gan=is_gan)
    ckpt.wait()
    print("final:", {k: round(float(v), 6) for k, v in metrics.items()})
    return trainer


def run_test_vq(cfg, args):
    """Reconstruct the held-out split from a --train_vq checkpoint: per
    batch its metrics, `original_{i}.npy` and `reconst_{i}.npy` (the image
    channel; `reconst_{i}_0.nii.gz` too with --save_nifti), then the mean
    reconstruction MSE. Returns (paths written, mean MSE)."""
    from ldm3d_torch.data.nifti import save_nifti
    from ldm3d_torch.train.checkpoint import CheckpointManager

    device = _device(args)
    _, val_loader = _loaders(cfg, args, device)
    if val_loader is None:
        raise SystemExit("validation split is empty")
    trainer = _stage1_trainer(cfg, device)
    state, epoch = CheckpointManager(_ckpt_dir(cfg, "vq")).restore(
        args.test_epoch)
    trainer.load_state_dict(state, optimizer=False)
    del state
    print(f"testing epoch {epoch}")

    os.makedirs(args.out_dir, exist_ok=True)
    total_mse, n, paths = 0.0, 0, []
    for i, (vol, mask, _ctx) in enumerate(val_loader):
        metrics = trainer.eval_step(vol, mask)
        total_mse += float(metrics["reconst_loss"])
        n += 1
        recon, _ = trainer.reconstruct(vol, mask)
        recon = recon[..., :1].float().cpu().numpy()
        for name, arr in ((f"original_{i}.npy", vol.float().cpu().numpy()),
                          (f"reconst_{i}.npy", recon)):
            paths.append(os.path.join(args.out_dir, name))
            np.save(paths[-1], arr)
        if args.save_nifti:
            paths.append(os.path.join(args.out_dir, f"reconst_{i}_0.nii.gz"))
            save_nifti(paths[-1], recon[0])
        print(f"batch {i}: " + " ".join(
            f"{k}={float(v):.5f}" for k, v in metrics.items()))
    mean = total_mse / max(n, 1)
    print(f"mean reconst MSE over {n} batches: {mean:.6f}")
    return paths, mean


def _dm_trainer(cfg, device, mesh=None):
    from ldm3d_torch.train.dm_trainer import DiffusionTrainer
    return DiffusionTrainer(cfg.diffusion, device=device, train_cfg=cfg.train,
                            mesh=mesh).init_random(cfg.train.seed)


def _adopt_dm_meta(cfg, args):
    """`adopt_meta` of the run's own train_meta.json."""
    return adopt_meta(cfg, args, load_meta(os.path.join(
        _ckpt_dir(cfg, "dm"), "train_meta.json")))


def _encode_corpus(trainer, loader, t0: float, mesh=None):
    """(latents, contexts) of every batch of `loader`, on the device. With
    a `mesh` each process encodes its rows (over a 'space' axis, its
    depth slabs; `encode_latents` gathers the latents over the space
    group) of every batch and the rows are gathered, so that every
    process holds the whole corpus in the one-process order."""
    lats, ctxs = [], []
    for i, (vol, _mask, ctx) in enumerate(loader):
        lats.append(trainer.encode_latents(vol))
        ctxs.append(ctx)
        if (i + 1) % 32 == 0:
            print(f"cache_latents: encoded {i + 1} batches "
                  f"[{time.time() - t0:.0f}s]", flush=True)
    from ldm3d_torch.parallel.mesh import DATA_AXIS, data_group

    lat, ctx = torch.cat(lats), torch.cat(ctxs)
    group = data_group(mesh)
    if group is None:
        return lat, ctx

    def gather(x):
        # [processes x batches x rows] -> [batches x processes x rows]
        full = pdist.all_gather_rows(x, group).reshape(
            (mesh.shape[DATA_AXIS], len(lats), -1) + x.shape[1:])
        return full.transpose(0, 1).reshape((-1,) + x.shape[1:])
    return gather(lat), gather(ctx)


def run_train_dm(cfg, args):
    """Stage-2 training; returns the trainer."""
    from ldm3d_torch.data.pipeline import LatentLoader
    from ldm3d_torch.train.callbacks import (CSVLogger, ImageLogger,
                                             MetricsLogger)
    from ldm3d_torch.train.checkpoint import CheckpointManager
    from ldm3d_torch.train.loop import fit, fit_with_recovery
    from ldm3d_torch.train.dm_trainer import auto_latent_scale
    from ldm3d_torch.train.vq_trainer import load_stage1_checkpoint
    from ldm3d_torch.utils.export import load_stage1_npz

    mesh = _mesh(cfg)
    device = _device(args)
    primary = pdist.is_primary()
    train_loader, val_loader = _loaders(cfg, args, device, mesh)
    size = cfg.data.volume_size
    trainer = _dm_trainer(cfg, device, mesh)
    vq_epoch = None
    if args.vqvae_load_ckpt:
        if os.path.isdir(args.vqvae_load_ckpt):
            vq_epoch = load_stage1_checkpoint(args.vqvae_load_ckpt,
                                              trainer.model.vqvae)
        else:
            meta = load_stage1_npz(args.vqvae_load_ckpt, trainer)
            vq_epoch = int(meta.get("epoch", 0))
        print(f"loaded stage-1 VQ-VAE weights from epoch {vq_epoch}")

    ckpt = CheckpointManager(_ckpt_dir(cfg, "dm"),
                             keep=cfg.train.keep_checkpoints, write=primary)
    initial_epoch = _maybe_resume(ckpt, trainer, args.resume_ckpt)
    # a checkpoint carries its latent scale: encode and record with it
    cfg = replace(cfg, diffusion=trainer.cfg)

    def step_fn(batch):
        vol, _mask, ctx = batch
        return trainer.train_step(vol, ctx)

    logdir = _ckpt_dir(cfg, "dm")
    image_logger = None
    if args.image_log_freq:
        f = cfg.diffusion.vqvae.spatial_factor
        lat = (1, size // f, size // f, size // f,
               cfg.diffusion.latent_channels)
        contexts = (list(range(cfg.diffusion.unet.context_dim + 1))
                    if cfg.model == "conditional_dm" else [None])

        def render(tr):
            out = {}
            for c in contexts:
                ctx = None if not tr.conditional else torch.full(
                    (1,), 0 if c is None else c, dtype=torch.long,
                    device=device)
                gen = torch.Generator(device=device).manual_seed(11)
                vols = tr.generate(lat, ctx, generator=gen, sampler="ddim")
                tag = f"generated_ctx{c}" if c is not None else "generated"
                out[tag] = vols.float().cpu().numpy()
            return out

        image_logger = ImageLogger(os.path.join(logdir, "images"), render,
                                   log_freq=args.image_log_freq,
                                   write=primary)

    epoch_callback = None
    if args.fidelity_freq:
        # real-corpus features once, from the frozen encoder; held-out
        # volumes when a val split exists, else the train set
        feats, ctx_rows = [], []
        for batch in (val_loader or train_loader):
            feats.append(trainer.latent_features(batch[0]))
            ctx_rows.append(batch[2].cpu().numpy().reshape(-1))
        if pdist.process_count() > 1:
            # every process's rows to every process, batch by batch in the
            # one-process order: every process evaluates the same samples
            # (a sharded U-Net samples with collectives on all of them)
            parts = [None] * pdist.process_count()
            torch.distributed.all_gather_object(parts, (feats, ctx_rows))
            feats = [p[0][i] for i in range(len(feats)) for p in parts]
            ctx_rows = [p[1][i] for i in range(len(ctx_rows))
                        for p in parts]
        real_feats = np.concatenate(feats, axis=0)
        real_ctx = (np.concatenate(ctx_rows, axis=0)
                    if args.fidelity_by_class and trainer.conditional
                    else None)
        if primary:
            print(f"fidelity: cached {real_feats.shape[0]} real-volume "
                  f"feature rows ({'val' if val_loader else 'train'} "
                  f"split)")

        def epoch_callback(epoch, tr):
            if (epoch + 1) % args.fidelity_freq != 0:
                return {}
            gen = torch.Generator(device=device).manual_seed(
                cfg.train.seed + 5000 + epoch)
            scores = tr.fidelity_eval(
                real_feats, gen, num_samples=args.fidelity_samples,
                batch=min(args.fidelity_samples, 16), sampler="ddim",
                sample_steps=args.sample_steps, real_ctx=real_ctx)
            out = {"latent_fid": scores["latent_fid"],
                   "latent_mmd": scores["latent_mmd"]}
            if "fid_class_sep" in scores:
                out["fid_class_sep"] = scores["fid_class_sep"]
            return out

    if args.cache_latents:
        # one frozen-encoder pass over the corpus, then train from latents
        # resident on the device
        if cfg.data.augment:
            print("cache_latents: augmentation frozen to a single draw "
                  "(matches the reference's static augmented copies)")
        t0 = time.time()
        # the raw (unscaled) latents persist beside the corpus, keyed by
        # the stage-1 epoch, when the stage-1 weights come from a snapshot
        lat_disk = None
        if args.vqvae_load_ckpt and not cfg.data.augment:
            os.makedirs(cfg.data.cache_dir, exist_ok=True)
            lat_disk = os.path.join(
                cfg.data.cache_dir,
                f"latents_s1ep{vq_epoch}_b{cfg.train.batch_size}.npz")
        lat_all = ctx_all = None
        if lat_disk and os.path.exists(lat_disk):
            try:
                with np.load(lat_disk) as z:
                    lat_all = torch.from_numpy(
                        z["lat"].astype(np.float32)).to(device)
                    ctx_all = torch.from_numpy(z["ctx"]).to(device)
                print(f"cache_latents: loaded {lat_all.shape[0]} latents "
                      f"from {lat_disk}", flush=True)
            except (OSError, ValueError, KeyError) as e:
                print(f"cache_latents: disk cache unreadable ({e}); "
                      f"re-encoding", flush=True)
                lat_all = ctx_all = None
        if lat_all is None:
            lat_all, ctx_all = _encode_corpus(trainer, train_loader, t0,
                                              mesh)
            if lat_disk and primary:
                np.savez(lat_disk,
                         lat=lat_all.cpu().numpy().astype(np.float16),
                         ctx=ctx_all.cpu().numpy())
                print(f"cache_latents: persisted to {lat_disk}", flush=True)
        lat_std = float(torch.std(lat_all.float(), correction=0))
        print(f"cache_latents: {lat_all.shape[0]} latents "
              f"{tuple(lat_all.shape[1:])} resident on {device} "
              f"({lat_all.nelement() * lat_all.element_size() / 1e6:.0f} "
              f"MB, encoded in {time.time() - t0:.1f}s); latent std "
              f"{lat_std:.4f} in diffusion space (latent_scale "
              f"{cfg.diffusion.latent_scale:g} applied) — for "
              f"unit-variance latents train with --latent_scale "
              f"{cfg.diffusion.latent_scale / max(lat_std, 1e-8):.4f}")
        # AUTO latent scale: unless a scale was given, rescale the cached
        # latents to unit variance and turn off the sampler clip
        new = auto_latent_scale(lat_std, cfg.diffusion, args.latent_scale,
                                args.clip_sample_range)
        if new is not cfg.diffusion:
            cfg = replace(cfg, diffusion=new)
            trainer.set_latent_scale(new.latent_scale,
                                     new.clip_sample_range)
            lat_all = lat_all * new.latent_scale
            print(f"cache_latents: AUTO latent_scale {new.latent_scale:.4f}"
                  f" (corpus-derived; clip_sample_range -> "
                  f"{new.clip_sample_range:g}). Pass --latent_scale 1 to "
                  f"force raw reference behavior; restore/serve adopt the "
                  f"value from train_meta.json.")
        train_loader = LatentLoader(lat_all, ctx_all, cfg.train.batch_size,
                                    seed=cfg.train.seed, mesh=mesh)

        def step_fn(batch):  # noqa: F811 - replaces the volume path
            lat, ctx = batch
            return trainer.train_step_latents(lat, ctx)

    if primary:
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "train_meta.json"), "w") as f:
            json.dump(train_meta(cfg), f, indent=1)

    fit_fn = fit if not args.auto_resume else functools.partial(
        fit_with_recovery, max_restarts=args.auto_resume)
    metrics = fit_fn(
        trainer, train_loader, cfg.train.epochs,
        ckpt=None if args.test_run else ckpt,
        image_logger=image_logger,
        epoch_callback=epoch_callback,
        csv_logger=CSVLogger(os.path.join(logdir, "training.log"),
                             append=args.resume_ckpt is not None)
        if primary else None,
        metrics_logger=MetricsLogger(os.path.join(logdir, "metrics.jsonl"),
                                     run_name=cfg.name) if primary else None,
        initial_epoch=initial_epoch, ckpt_freq=args.ckpt_freq,
        step_fn=step_fn)
    ckpt.wait()
    print("final:", {k: round(float(v), 8) for k, v in metrics.items()})
    return trainer


def run_test_dm(cfg, args):
    """Sample 4 volumes per context from a checkpoint and save them as
    .npy (and .nii.gz with --save_nifti); returns the saved paths."""
    from ldm3d_torch.data.nifti import save_nifti
    from ldm3d_torch.train.checkpoint import CheckpointManager
    from ldm3d_torch.train.dm_trainer import DiffusionTrainer

    cfg = _adopt_dm_meta(cfg, args)
    device = _device(args)
    size = cfg.data.volume_size
    trainer = DiffusionTrainer(cfg.diffusion, device=device,
                               train_cfg=cfg.train)
    ckpt = CheckpointManager(_ckpt_dir(cfg, "dm"))
    state, epoch = ckpt.restore(args.test_epoch)
    trainer.load_state_dict(state, optimizer=False)
    del state
    print(f"sampling from epoch {epoch} ({cfg.diffusion.timesteps} steps)")

    f = cfg.diffusion.vqvae.spatial_factor
    lat = size // f
    shape = (4, lat, lat, lat, cfg.diffusion.latent_channels)
    os.makedirs(args.out_dir, exist_ok=True)
    contexts = (list(range(cfg.diffusion.unet.context_dim + 1))
                if cfg.model == "conditional_dm" else [None])
    paths = []
    for c in contexts:
        ctx = None if not trainer.conditional else torch.full(
            (shape[0],), 0 if c is None else c, dtype=torch.long,
            device=device)
        gen = torch.Generator(device=device).manual_seed(7)
        out = trainer.generate(shape, ctx, generator=gen,
                               sampler=args.sampler,
                               sample_steps=args.sample_steps, eta=args.eta,
                               guidance_scale=args.guidance_scale)
        tag = f"-ctx{c}" if c is not None else ""
        if args.sampler in ("ddim", "dpmpp", "dpmpp_sde"):
            tag = f"-{args.sampler}{args.sample_steps or ''}{tag}"
        path = os.path.join(
            args.out_dir,
            f"{cfg.name}-{cfg.diffusion.timesteps}rsteps{tag}.npy")
        arr = out.float().cpu().numpy()
        np.save(path, arr)
        paths.append(path)
        print("saved", path, arr.shape)
        if args.save_nifti:
            for b in range(arr.shape[0]):
                nii = path.replace(".npy", f"_{b}.nii.gz")
                save_nifti(nii, arr[b])
                print("saved", nii)
    return paths


def _parse_samplers(spec: str):
    """[(sampler, steps or None, eta)] of --sweep_samplers entries
    `sampler[:steps[:eta]]`."""
    samplers = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        steps = int(parts[1]) if len(parts) > 1 and parts[1] else None
        eta = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
        samplers.append((parts[0], steps, eta))
    return samplers


def _parse_guidances(spec: str):
    """The --guidance_grid scales; "", "none" and "0" are unguided (None)."""
    out = []
    for g in spec.split(","):
        g = g.strip().lower()
        out.append(None if g in ("", "none", "0") else float(g))
    return out


def run_fidelity_sweep(cfg, args):
    """Latent-FID and kernel-MMD of a trained stage-2 checkpoint (against
    the held-out split's frozen-encoder features) over --sweep_samplers x
    --guidance_grid; a guided cell of a model trained without cfg_dropout
    is skipped. Writes `fidelity_sweep_<name>.json` and `.md` under
    --out_dir, in the JAX package's format; returns the rows."""
    from ldm3d_torch.train.checkpoint import CheckpointManager
    from ldm3d_torch.train.dm_trainer import DiffusionTrainer

    cfg = _adopt_dm_meta(cfg, args)
    device = _device(args)
    trainer = DiffusionTrainer(cfg.diffusion, device=device,
                               train_cfg=cfg.train)
    state, epoch = CheckpointManager(_ckpt_dir(cfg, "dm")).restore(
        args.test_epoch)
    trainer.load_state_dict(state, optimizer=False)
    del state
    print(f"fidelity sweep from epoch {epoch} "
          f"(T={cfg.diffusion.timesteps}, "
          f"prediction={cfg.diffusion.prediction_type})")

    train_loader, val_loader = _loaders(cfg, args, device)
    feats, ctx_rows = [], []
    for batch in (val_loader or train_loader):
        feats.append(trainer.latent_features(batch[0]))
        ctx_rows.append(batch[2].cpu().numpy().reshape(-1))
    real_feats = np.concatenate(feats, axis=0)
    real_ctx = (np.concatenate(ctx_rows, axis=0)
                if args.fidelity_by_class and trainer.conditional else None)
    print(f"cached {real_feats.shape[0]} real-volume feature rows"
          + (f" (per-class: {np.bincount(real_ctx.astype(int)).tolist()})"
             if real_ctx is not None else ""))

    rows = []
    for sampler, steps, eta in _parse_samplers(args.sweep_samplers):
        for g in _parse_guidances(args.guidance_grid):
            t0 = time.perf_counter()
            gen = torch.Generator(device=device).manual_seed(
                cfg.train.seed + 9000)
            try:
                scores = trainer.fidelity_eval(
                    real_feats, gen, num_samples=args.fidelity_samples,
                    batch=min(args.fidelity_samples, 16), sampler=sampler,
                    sample_steps=steps, eta=eta, guidance_scale=g,
                    real_ctx=real_ctx)
            except ValueError as e:  # e.g. guidance without cfg_dropout
                print(f"skip {sampler}:{steps} g={g}: {e}")
                continue
            dt = time.perf_counter() - t0
            name = sampler if not eta else f"{sampler}(eta={eta:g})"
            row = {"sampler": name, "steps": steps, "guidance": g,
                   "latent_fid": round(float(scores["latent_fid"]), 3),
                   "latent_mmd": round(float(scores["latent_mmd"]), 4),
                   "eval_seconds": round(dt, 1)}
            for k, v in scores.items():
                if k.startswith("fid_"):
                    row[k] = round(float(v), 3)
            rows.append(row)
            print(row, flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.join(args.out_dir, f"fidelity_sweep_{cfg.name}")
    with open(base + ".json", "w") as f:
        json.dump({"epoch": epoch, "timesteps": cfg.diffusion.timesteps,
                   "prediction_type": cfg.diffusion.prediction_type,
                   "num_samples": args.fidelity_samples, "rows": rows},
                  f, indent=1)
    by_class = any("fid_class_sep" in r for r in rows)
    extra_hdr = (" FID same(c0/c1) | FID cross(c0/c1) | class sep |"
                 if by_class else "")
    lines = [f"# Fidelity sweep — {cfg.name} (epoch {epoch}, "
             f"T={cfg.diffusion.timesteps}, "
             f"{cfg.diffusion.prediction_type}-prediction, "
             f"{args.fidelity_samples} samples/cell)", "",
             "| sampler | steps | guidance | latent-FID | kernel-MMD |"
             + extra_hdr + " eval s |",
             "|---|---|---|---|---|" + ("---|---|---|" if by_class else "")
             + "---|"]
    for r in rows:
        extra = ""
        if by_class:
            extra = (f" {r.get('fid_same_c0', '—')}/"
                     f"{r.get('fid_same_c1', '—')} "
                     f"| {r.get('fid_cross_c0', '—')}/"
                     f"{r.get('fid_cross_c1', '—')} "
                     f"| {r.get('fid_class_sep', '—')} |")
        lines.append(
            f"| {r['sampler']} | {r['steps'] or 'T'} "
            f"| {r['guidance'] if r['guidance'] is not None else '—'} "
            f"| {r['latent_fid']} | {r['latent_mmd']} |"
            + extra + f" {r['eval_seconds']} |")
    with open(base + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote", base + ".md")
    return rows


def _sweep_trial(cfg, args, point, metric):
    """Train one sweep point (`run_train_vq`); returns (record, the final
    value of `metric` in its training.log, or None)."""
    import csv

    from ldm3d_torch.core.sweep import apply_sweep_point

    run_cfg = apply_sweep_point(cfg, point)
    print(f"--- sweep point: {run_cfg.name}")
    try:
        run_train_vq(run_cfg, args)
        log = os.path.join(_ckpt_dir(run_cfg, "vq"), "training.log")
        last = {}
        if os.path.exists(log):
            with open(log) as lf:
                rows = list(csv.DictReader(lf))
            if rows:
                last = {k: float(v) for k, v in rows[-1].items()}
        rec = {"name": run_cfg.name, "point": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in point.items()}, "metrics": last}
        return rec, last.get(metric)
    except Exception as e:  # a failed point is recorded; the sweep goes on
        traceback.print_exc()
        return {"name": run_cfg.name, "error": str(e)}, None


def run_sweep(cfg, args):
    """Train each point of the --sweep YAML (`run_train_vq`) and append
    one record per point to `{ckpt_dir}/sweep_results.jsonl`. `grid` and
    `random` expand up front (--sweep_count points at most); `bayes` runs
    `core.sweep.BayesSearch`, observing each point's final metric before
    proposing the next (a failed point counts as the worst value).
    Returns the records."""
    from ldm3d_torch.core.sweep import (BayesSearch, expand_sweep,
                                        parse_sweep_yaml)

    with open(args.sweep) as f:
        spec = parse_sweep_yaml(f.read())
    metric = spec.get("metric", {}).get("name", "val_loss")
    goal = spec.get("metric", {}).get("goal", "minimize")
    method = spec.get("method", "grid")
    results = []
    results_path = os.path.join(cfg.ckpt_dir, "sweep_results.jsonl")
    if pdist.is_primary():
        os.makedirs(cfg.ckpt_dir, exist_ok=True)

    def record(rec):
        results.append(rec)
        if pdist.is_primary():
            with open(results_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    if method == "bayes":
        search = BayesSearch(spec, seed=cfg.train.seed, goal=goal)
        count = args.sweep_count or min(len(search.candidates), 20)
        print(f"sweep (bayes/TPE): up to {count} of "
              f"{len(search.candidates)} grid cells, optimizing {metric}")
        bad_value = float("inf") if not str(goal).startswith("max") \
            else float("-inf")
        for _ in range(count):
            point = search.suggest()
            if point is None:
                break
            rec, value = _sweep_trial(cfg, args, point, metric)
            search.observe(point, value if value is not None else bad_value)
            record(rec)
    else:
        points = expand_sweep(spec, count=args.sweep_count,
                              seed=cfg.train.seed)
        print(f"sweep ({method}): {len(points)} points, optimizing {metric}")
        for point in points:
            record(_sweep_trial(cfg, args, point, metric)[0])

    scored = [r for r in results
              if r.get("metrics", {}).get(metric) is not None]
    if scored:
        pick = max if str(goal).startswith("max") else min
        best = pick(scored, key=lambda r: r["metrics"][metric])
        print(f"best: {best['name']} {metric}={best['metrics'][metric]:.6f}")
    return results


def run_create_dataset(cfg, args):
    from ldm3d_torch.data.pipeline import build_cache, write_synthetic_cache
    if args.synthetic:
        write_synthetic_cache(cfg.data.cache_dir, args.num_synthetic,
                              cfg.data.volume_size, seed=cfg.train.seed,
                              num_classes=cfg.data.num_classes,
                              device=_device(args))
        print(f"synthetic cache at {cfg.data.cache_dir}")
    else:
        build_cache(cfg.data)
        print(f"cache at {cfg.data.cache_dir}")


def _local_process(index: int, argv, n: int, port: int) -> None:
    """Process `index` of a --cpu_devices run."""
    main(list(argv) + ["--cpu_devices", "0", "--coordinator",
                       f"127.0.0.1:{port}", "--num_processes", str(n),
                       "--process_id", str(index)])


def _run_local_processes(argv, n: int) -> None:
    """The command in `n` local processes joined over a free localhost
    port; returns when all have ended, raises when one fails (the others
    are then stopped)."""
    import torch.multiprocessing as mp
    mp.start_processes(_local_process, args=(argv, n, pdist.free_port()),
                       nprocs=n, join=True, start_method="spawn")


def main(argv=None):
    if hasattr(sys.stdout, "reconfigure"):
        # one line per epoch must reach a log file as it is written
        sys.stdout.reconfigure(line_buffering=True)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.cpu_devices > 1:
        if args.platform != "cpu" or args.coordinator \
                or os.environ.get("LDM3D_COORDINATOR"):
            raise SystemExit("ldm3d_torch: --cpu_devices starts local "
                             "processes on the CPU: pass --platform cpu and "
                             "no coordinator")
        _run_local_processes(argv, args.cpu_devices)
        return
    if pdist.initialize(args.coordinator, args.num_processes,
                        args.process_id, platform=args.platform):
        print(f"multi-host: process {pdist.process_index()}/"
              f"{pdist.process_count()}, backend "
              f"{pdist.collective_backend()}, device {pdist.process_device()}")
    try:
        from ldm3d_torch.core.presets import get_preset
        cfg = apply_overrides(get_preset(args.preset), args)
        _device(args)       # no GPU and no --platform cpu: raise before work

        with contextlib.ExitStack() as stack:
            if args.profile:
                from ldm3d_torch.utils.profiling import trace
                stack.enter_context(trace(os.path.join(cfg.ckpt_dir,
                                                       "trace")))
            _run_modes(cfg, args)
        pdist.barrier()
    finally:
        pdist.shutdown()


def _on_primary(fn, cfg, args):
    """A mode that does not train: process 0 runs it (one process, no
    mesh), the others wait for it."""
    if pdist.is_primary():
        fn(cfg, args)
    pdist.barrier()


def _run_modes(cfg, args) -> None:
    if args.sweep:
        run_sweep(cfg, args)
        return
    if args.create_dataset:
        _on_primary(run_create_dataset, cfg, args)
    if args.train_vq:
        run_train_vq(cfg, args)
    if args.test_vq:
        _on_primary(run_test_vq, cfg, args)
    if args.train_dm:
        run_train_dm(cfg, args)
    if args.test_dm:
        _on_primary(run_test_dm, cfg, args)
    if args.fidelity_sweep:
        _on_primary(run_fidelity_sweep, cfg, args)
    if not any([args.create_dataset, args.train_vq, args.test_vq,
                args.train_dm, args.test_dm, args.fidelity_sweep]):
        print("nothing to do: pass --train_vq/--test_vq/--train_dm/"
              "--test_dm/--create_dataset/--fidelity_sweep/--sweep")


if __name__ == "__main__":
    main()

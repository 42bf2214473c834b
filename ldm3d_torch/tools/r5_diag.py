"""Plateau diagnosis of a trained flagship denoiser: the port of
`tools/r5_diag.py` (why does a correctly scaled flagship DM plateau at
noise_mse ~0.88?).

Probes, all on the corpus's latents through the trained stage-1:
  A. eps-MSE per timestep bucket of a trained `--train_dm` checkpoint
     (--crawl_ckpt; its raw U-Net and its EMA U-Net): eps-MSE ~1 at every
     t = a dead model; low at high t but ~1 at low t = healthy but
     saturated (low-t eps cannot be recovered).
  B. single-batch overfit from the fresh U-Net, lr 1e-4 then 1e-3, on 8
     fixed latents: a healthy architecture and step drive the train MSE
     toward the low-t floor within ~1k steps.
  W. the same overfit with a wide U-Net (stem 256, widths 256, 512), then
     the tool ends (skip it with --skip w to reach G and C).
  G. the same overfit with a GroupNorm U-Net.
  C. --arm_epochs epochs on the whole corpus at --arm_lr: does the
     plateau move, i.e. is it only an optimization-rate problem?

The command line the tool builds is the JAX tool's (the flagship recipe
on the 1,232-volume synthetic corpus, the stage-1 of
runs/ckpt_flagship_gn/flagship_vq); every flag it does not know is
appended to it (the last of a flag wins), e.g. `--platform cpu`,
`--preset`, `--num_synthetic`, `--vqvae_load_ckpt`. The buckets are the
JAX tool's at T = 500 (1 ... 499), scaled to the run's T. A probe's
U-Net is evaluated with its own BatchNorm statistics (the JAX tool used
the fresh state's for every probe).

Usage: python -m ldm3d_torch.tools.r5_diag [--skip a,b,w,g,c]
           [--arm_lr 1e-3] [--arm_epochs 30] [--overfit_steps 1200]
           [--crawl_ckpt runs/ckpt_flagship/flagship_dm] [CLI flags ...]
"""

from __future__ import annotations

import argparse
import copy
import time

import torch

FLAGS = ["--preset", "conditional_dm3d", "--norm", "group",
         "--synthetic", "--device_data", "--num_synthetic", "1232",
         "--num_classes", "4", "--cache_dir", "runs/corpus128",
         "--val_perc", "0.1", "--lbs", "8", "--timesteps", "500",
         "--cfg_dropout", "0.1", "--ema_decay", "0.999", "--train_dm",
         "--cache_latents", "--epochs", "30",
         "--vqvae_load_ckpt", "runs/ckpt_flagship_gn/flagship_vq",
         "--suffix", "diag", "--latent_scale", "18.4713",
         "--clip_sample_range", "0", "--ckpt_dir", "runs/ckpt_diag"]
BUCKETS = (1, 25, 50, 100, 200, 300, 400, 475, 499)   # at T = 500
REPEATS = 4                                           # noise draws per t


def get_cfg_args(extra=()):
    """(the port's CLI module, the config, the parsed flags) of FLAGS and
    `extra`."""
    from ldm3d_torch.cli import main as M
    from ldm3d_torch.core.presets import get_preset
    args = M.build_parser().parse_args(FLAGS + list(extra))
    cfg = M.apply_overrides(get_preset(args.preset), args)
    return M, cfg, args


def build_latents(M, cfg, args):
    """(trainer, latents [N, ...] in diffusion space, contexts [N]) on the
    device: the training split encoded through the stage-1 of
    --vqvae_load_ckpt."""
    from ldm3d_torch.train.vq_trainer import load_stage1_checkpoint
    device = M._device(args)
    train_loader, _ = M._loaders(cfg, args, device)
    trainer = M._dm_trainer(cfg, device)
    ep = load_stage1_checkpoint(args.vqvae_load_ckpt, trainer.model.vqvae)
    print(f"stage-1 weights from epoch {ep}", flush=True)
    t0 = time.time()
    lat_all, ctx_all = M._encode_corpus(trainer, train_loader, t0)
    ctx_all = ctx_all.reshape(-1).long()
    print(f"encoded {lat_all.shape[0]} latents in {time.time()-t0:.1f}s; "
          f"std(diffusion space)="
          f"{float(torch.std(lat_all, correction=0)):.4f}", flush=True)
    return trainer, lat_all, ctx_all


def buckets(timesteps: int) -> list:
    """BUCKETS scaled from T = 500 to `timesteps` (the same at 500)."""
    return sorted({round(tv * (timesteps - 1) / 499) for tv in BUCKETS})


@torch.no_grad()
def bucket_mse(trainer, unet, lat, ctx, t, noise) -> float:
    """mean (noise - unet(q_sample(lat, t, noise), t, ctx))^2, the U-Net
    in eval mode (the JAX tool's `probe`)."""
    from ldm3d_torch.diffusion.schedule import q_sample
    noisy = q_sample(trainer._sched_dev, lat.float(), t, noise)
    pred = unet.eval()(noisy.to(lat.dtype), t, ctx)
    return float(torch.mean(torch.square(noise - pred.float())))


def t_bucket_mse(trainer, lat, ctx, unet, tag):
    """eps-MSE per t bucket with the given U-Net, each the mean of
    REPEATS noise draws (seeded 100 t + r)."""
    print(f"[{tag}] t-bucket eps-MSE:", flush=True)
    rows = []
    for tv in buckets(trainer.cfg.timesteps):
        acc = 0.0
        for r in range(REPEATS):
            gen = torch.Generator(device=lat.device).manual_seed(
                100 * tv + r)
            noise = torch.randn(lat.shape, generator=gen,
                                device=lat.device)
            t = torch.full((lat.shape[0],), tv, dtype=torch.long,
                           device=lat.device)
            acc += bucket_mse(trainer, unet, lat, ctx, t, noise)
        rows.append((tv, acc / REPEATS))
        print(f"  t={tv:4d}  mse={acc/REPEATS:.4f}", flush=True)
    return rows


def overfit(trainer, lat8, ctx8, lr, steps=1200, tag=""):
    """Single-batch overfit of a copy of the trainer's U-Net (Adam at
    `lr`, optax's defaults); returns the copy, in eval mode."""
    from ldm3d_torch.diffusion.schedule import q_sample
    unet = copy.deepcopy(trainer.model.unet).train().requires_grad_(True)
    opt = torch.optim.Adam(unet.parameters(), lr=lr, eps=1e-8)
    dev, T = lat8.device, trainer.cfg.timesteps
    gen = torch.Generator(device=dev).manual_seed(7)
    t0 = time.time()
    for i in range(steps):
        t = torch.randint(0, T, (lat8.shape[0],), generator=gen, device=dev)
        noise = torch.randn(lat8.shape, generator=gen, device=dev)
        noisy = q_sample(trainer._sched_dev, lat8.float(), t, noise)
        pred = unet(noisy.to(lat8.dtype), t, ctx8)
        loss = torch.mean(torch.square(noise - pred.float()))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 200 == 0 or i == steps - 1:
            print(f"[overfit {tag} lr={lr:g}] step {i:5d} "
                  f"mse={float(loss.detach()):.4f}", flush=True)
    print(f"[overfit {tag}] {steps} steps in {time.time()-t0:.1f}s",
          flush=True)
    return unet.eval().requires_grad_(False)


def _trainer(diffusion, train_cfg, device, seed):
    from ldm3d_torch.train.dm_trainer import DiffusionTrainer
    return DiffusionTrainer(diffusion, device=device,
                            train_cfg=train_cfg).init_random(seed)


def full_corpus_arm(trainer, lat_all, ctx_all, lr, epochs, cfg):
    """Training on every cached latent at `lr` from a fresh U-Net (seed +
    1) over the trained stage-1; prints each epoch's mean metrics."""
    from ldm3d_torch.core.config import replace
    from ldm3d_torch.data.pipeline import LatentLoader
    tr = _trainer(cfg.diffusion, replace(cfg.train, learning_rate=lr),
                  trainer.device, cfg.train.seed + 1)
    # graft the frozen stage-1 and the latent scale of the encoded corpus
    tr.model.vqvae.load_state_dict(trainer.model.vqvae.state_dict())
    tr.set_latent_scale(trainer.cfg.latent_scale,
                        trainer.cfg.clip_sample_range)
    loader = LatentLoader(lat_all, ctx_all, cfg.train.batch_size,
                          seed=cfg.train.seed)
    for epoch in range(epochs):
        t0 = time.time()
        sums, n = {}, 0
        for lat, ctx in loader:
            for k, v in tr.train_step_latents(lat, ctx).items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
        msg = {k: round(float(v) / n, 5) for k, v in sums.items()}
        print(f"[arm lr={lr:g}] epoch {epoch+1}/{epochs} "
              f"[{time.time()-t0:.1f}s] {msg}", flush=True)
    return tr


def main(argv=None):
    ap = argparse.ArgumentParser("ldm3d_torch.tools.r5_diag")
    ap.add_argument("--skip", default="")
    ap.add_argument("--arm_lr", type=float, default=1e-3)
    ap.add_argument("--arm_epochs", type=int, default=30)
    ap.add_argument("--overfit_steps", type=int, default=1200,
                    help="steps of each overfit (the wide arm takes 2/3)")
    ap.add_argument("--crawl_ckpt", default="runs/ckpt_flagship/flagship_dm",
                    help="probe A's --train_dm checkpoint dir (its latest "
                         "epoch)")
    args_d, extra = ap.parse_known_args(argv)
    skip = set(args_d.skip.split(","))
    steps = args_d.overfit_steps

    from ldm3d_torch.core.config import replace
    M, cfg, args = get_cfg_args(extra)
    trainer, lat_all, ctx_all = build_latents(M, cfg, args)
    lat8, ctx8 = lat_all[:8], ctx_all[:8]

    if "a" not in skip:
        # A: the trained checkpoint's profile (latest saved epoch)
        from ldm3d_torch.train.checkpoint import CheckpointManager
        try:
            crawl, ep = CheckpointManager(args_d.crawl_ckpt).restore()
            print(f"crawl checkpoint epoch {ep}", flush=True)
            raw = copy.deepcopy(trainer.model.unet)
            raw.load_state_dict({k[len("unet."):]: v for k, v in
                                 crawl["model"].items()
                                 if k.startswith("unet.")})
            t_bucket_mse(trainer, lat8, ctx8, raw, f"crawl ep{ep} raw")
            if crawl["ema_unet"] is not None:
                raw.load_state_dict(crawl["ema_unet"])
                t_bucket_mse(trainer, lat8, ctx8, raw, f"crawl ep{ep} ema")
            del raw, crawl
        except (OSError, KeyError, RuntimeError) as e:
            print(f"A skipped: {e}", flush=True)

    if "b" not in skip:
        p1 = overfit(trainer, lat8, ctx8, 1e-4, steps, tag="b1")
        t_bucket_mse(trainer, lat8, ctx8, p1, "overfit lr1e-4")
        p2 = overfit(trainer, lat8, ctx8, 1e-3, steps, tag="b2")
        t_bucket_mse(trainer, lat8, ctx8, p2, "overfit lr1e-3")
        del p1, p2

    if "w" not in skip:
        # WIDE arm: stem >= latent channels. A 32-channel stem on a
        # 256-channel latent caps eps recovery at 32/256 of the variance
        # (every skip descends from the stem); standard LDM practice is
        # stem >> latent channels. Lean: only lat8, no EMA copy.
        diff_w = replace(cfg.diffusion,
                         unet=replace(cfg.diffusion.unet,
                                      first_conv_channels=256,
                                      widths=(256, 512),
                                      has_attention=(False, True, True)))
        lat8, ctx8 = lat8.clone(), ctx8.clone()
        device = trainer.device
        del lat_all, ctx_all, trainer
        if device.type == "cuda":
            torch.cuda.empty_cache()
        tr3 = _trainer(diff_w, replace(cfg.train, ema_decay=0.0), device,
                       cfg.train.seed)
        p4 = overfit(tr3, lat8, ctx8, 1e-4, steps=steps * 2 // 3,
                     tag="wide")
        t_bucket_mse(tr3, lat8, ctx8, p4, "overfit WIDE lr1e-4")
        return

    if "g" not in skip:
        # GroupNorm U-Net arm: the same overfit with norm="group", to
        # isolate BatchNorm as the dead-gradient culprit
        diff_gn = replace(cfg.diffusion,
                          unet=replace(cfg.diffusion.unet, norm="group"))
        tr2 = _trainer(diff_gn, cfg.train, trainer.device, cfg.train.seed)
        p3 = overfit(tr2, lat8, ctx8, 1e-4, steps, tag="gn")
        t_bucket_mse(tr2, lat8, ctx8, p3, "overfit GN lr1e-4")
        del tr2, p3

    if "c" not in skip:
        tr = full_corpus_arm(trainer, lat_all, ctx_all, args_d.arm_lr,
                             args_d.arm_epochs, cfg)
        t_bucket_mse(tr, lat8, ctx8, tr.model.unet,
                     f"arm lr={args_d.arm_lr:g} raw")


if __name__ == "__main__":
    main()

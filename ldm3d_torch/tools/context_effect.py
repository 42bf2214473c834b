"""Diagnostic: how much does the context token move the denoiser? The
port of `tools/context_effect.py`.

A fidelity sweep where classifier-free guidance changes latent-FID only
in the third decimal implies eps(x,t,ctx=c) ~= eps(x,t,ctx=null). This
measures that on a trained model: the relative L2 distance between the
EMA U-Net's eps-space outputs under context 0 / context 1 / ... / the null
token, averaged over random latents, at a grid of timesteps; then whether
the context embedding's rows differ.

Usage: python -m ldm3d_torch.tools.context_effect \\
           [--ckpt runs/ckpt_flagship/flagship_dm]   # or a .npz snapshot
           [--batch 8] [--num_classes 2] [--context_in_time]
           [--platform cpu]                           # default: the GPU
"""

from __future__ import annotations

import argparse

import torch

from ldm3d_torch.core.config import (ExperimentConfig, TrainConfig,
                                     flagship_cfg, replace)

FRACS = (0.1, 0.25, 0.5, 0.75, 0.95)   # timesteps, as fractions of T - 1


def restore(path: str, cfg, train_cfg: TrainConfig, device):
    """(trainer, epoch) of a `--train_dm` checkpoint directory (its latest
    epoch) or of a `.npz` snapshot (`GenerationService.from_snapshot`)."""
    from ldm3d_torch.serve import GenerationService
    from ldm3d_torch.train.checkpoint import CheckpointManager
    from ldm3d_torch.train.dm_trainer import DiffusionTrainer

    if path.endswith(".npz"):
        svc = GenerationService.from_snapshot(
            ExperimentConfig(diffusion=cfg, train=train_cfg), path, device)
        return svc.trainer, svc.epoch
    trainer = DiffusionTrainer(cfg, device=device, train_cfg=train_cfg)
    state, epoch = CheckpointManager(path).restore()
    trainer.load_state_dict(state, optimizer=False)
    return trainer, epoch


def _sampling_unet(trainer):
    return trainer.ema_unet if trainer.ema_unet is not None \
        else trainer.model.unet


def eps_fn(trainer):
    """eps(x, t, ctx) of the trainer's EMA U-Net (its U-Net without one),
    in eval mode: the model's output converted to eps-space."""
    from ldm3d_torch.diffusion.schedule import model_out_to_eps

    unet = _sampling_unet(trainer)

    @torch.no_grad()
    def eps(x, t, ctx):
        return model_out_to_eps(trainer._sched_dev, x, t, unet(x, t, ctx),
                                trainer.cfg.prediction_type).float()
    return eps


def distances(eps, x: torch.Tensor, tval: int, num_classes: int,
              null_tok: int) -> tuple:
    """(mean over pairs of contexts of |eps_c - eps_c'| / |eps_0|, mean
    over contexts of |eps_c - eps_null| / |eps_0|) on latents `x` [B,
    ...] at timestep `tval`."""
    b = x.shape[0]

    def full(v):
        return torch.full((b,), v, dtype=torch.long, device=x.device)
    t = full(tval)
    es = [eps(x, t, full(c)) for c in range(num_classes)]
    en = eps(x, t, full(null_tok))
    n0 = torch.linalg.norm(es[0])
    pair = [float(torch.linalg.norm(es[a] - es[c]) / n0)
            for a in range(num_classes) for c in range(a + 1, num_classes)]
    vnull = [float(torch.linalg.norm(e - en) / n0) for e in es]
    return sum(pair) / len(pair), sum(vnull) / len(vnull)


def main(argv=None) -> list:
    """Returns [(t, pairwise, null)] per timestep."""
    ap = argparse.ArgumentParser("ldm3d_torch.tools.context_effect")
    ap.add_argument("--ckpt", default="runs/ckpt_flagship/flagship_dm",
                    help="a --train_dm checkpoint dir or a .npz snapshot")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--num_classes", type=int, default=2,
                    help="class count the checkpoint was trained with "
                         "(sizes the context embedding: context_dim = n-1)")
    ap.add_argument("--context_in_time", action="store_true",
                    help="checkpoint trained with the context-in-time "
                         "pathway (changes the parameter structure)")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="the GPU by default")
    args = ap.parse_args(argv)

    from ldm3d_torch.core.device import resolve_device

    device = resolve_device("cpu" if args.platform == "cpu" else None)
    cfg = flagship_cfg()
    # always size the embedding from --num_classes (the flagship cfg
    # defaults to the 4-class corpus; a 2-class checkpoint needs 1)
    cfg = replace(cfg, unet=replace(
        cfg.unet, context_dim=args.num_classes - 1,
        context_in_time=args.context_in_time))
    trainer, epoch = restore(args.ckpt, cfg,
                             TrainConfig(batch_size=args.batch), device)
    print(f"# restored epoch {epoch} from {args.ckpt}")

    ls, lc = cfg.latent_size, cfg.latent_channels
    b, ncls, T = args.batch, args.num_classes, cfg.timesteps
    null_tok = cfg.unet.context_dim + 1
    eps = eps_fn(trainer)
    print(f"# T={T}  classes={ncls}  "
          f"context_in_time={args.context_in_time}")
    print("#   t   mean-pairwise |ec-ec'|/|e0|    mean |ec-enull|/|e0|")
    gen = torch.Generator(device=device).manual_seed(42)
    rows = []
    for frac in FRACS:
        tval = int(frac * (T - 1))
        x = torch.randn((b, ls, ls, ls, lc), generator=gen, device=device)
        pair, vnull = distances(eps, x, tval, ncls, null_tok)
        rows.append((tval, pair, vnull))
        print(f"  {tval:4d}        {pair:.5f}       "
              f"         {vnull:.5f}")

    # and the embedding table itself: are the rows distinct?
    unet = _sampling_unet(trainer)
    emb = None
    for name, p in unet.named_parameters():
        if "embed" in name.lower() and p.dim() == 2 and p.shape[0] <= 8:
            emb = (name, p.detach().float())
    if emb is not None:
        name, tab = emb
        print(f"# context embedding table {name} {tuple(tab.shape)}")
        d01 = torch.linalg.norm(tab[0] - tab[1]) / torch.linalg.norm(tab[0])
        norms = [float(torch.linalg.norm(tab[i]))
                 for i in range(tab.shape[0])]
        print(f"#   |row0-row1|/|row0| = {d01:.4f}, row norms = {norms}")
    return rows


if __name__ == "__main__":
    main()

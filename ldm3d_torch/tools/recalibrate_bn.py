"""Recalibrate a trained VQ-VAE checkpoint's BatchNorm running statistics:
the port of `tools/recalibrate_bn.py`.

BN eval mode uses running averages (momentum .99) that can lag the final
parameters' activation distribution — observed as val-loss spikes while
train loss is smooth on the 4-level 8^3-bottleneck config. This restores a
stage-1 checkpoint of the port's `--train_vq`, runs training-mode forward
passes over the training split to re-estimate the running statistics
(`VQTrainer.recalibrate_batch_stats`: weights, quantizer state, optimizer
and step untouched), and saves the whole state as epoch <orig> into
--out_dir (default: <ckpt_dir>_bnr).

Run: python -m ldm3d_torch.tools.recalibrate_bn --preset vqvae_dm_stage1 \\
         --ckpt_dir runs/ckpt_flagship/flagship_vq \\
         --cache_dir runs/corpus128 --num_synthetic 1232 --passes 3
     (the GPU unless --platform cpu)
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    """Returns the output directory."""
    ap = argparse.ArgumentParser("ldm3d_torch.tools.recalibrate_bn")
    ap.add_argument("--preset", required=True)
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--cache_dir", required=True)
    ap.add_argument("--num_synthetic", type=int, default=None,
                    help="use the on-device synthetic source with this "
                         "corpus size instead of the cache")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--lbs", type=int, default=8)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="the GPU by default")
    args = ap.parse_args(argv)

    from ldm3d_torch.core.config import replace
    from ldm3d_torch.core.device import resolve_device
    from ldm3d_torch.core.presets import get_preset
    from ldm3d_torch.data.pipeline import (DataLoader,
                                           DeviceSyntheticLoader,
                                           VolumeCache, train_val_split)
    from ldm3d_torch.train.checkpoint import CheckpointManager
    from ldm3d_torch.train.vq_trainer import VQTrainer

    device = resolve_device("cpu" if args.platform == "cpu" else None)
    cfg = get_preset(args.preset)
    tcfg = replace(cfg.train, batch_size=args.lbs)

    if args.num_synthetic:
        tr, _ = train_val_split(args.num_synthetic, tcfg.val_fraction,
                                tcfg.seed)
        loader = DeviceSyntheticLoader(
            args.num_synthetic, args.lbs, cfg.data, corpus_seed=tcfg.seed,
            seed=tcfg.seed, train=False, indices=tr, device=device)
    else:
        cache = VolumeCache(args.cache_dir)
        tr, _ = train_val_split(cache, tcfg.val_fraction, tcfg.seed)
        loader = DataLoader(cache, args.lbs, cfg.data, seed=tcfg.seed,
                            train=False, indices=tr, device=device)

    trainer = VQTrainer(cfg.vqvae, tcfg, device=device)
    state, epoch = CheckpointManager(args.ckpt_dir).restore(args.epoch)
    trainer.load_state_dict(state)
    del state
    print(f"restored epoch {epoch} from {args.ckpt_dir}")

    trainer.recalibrate_batch_stats(loader, passes=args.passes)

    out_dir = args.out_dir or args.ckpt_dir.rstrip("/") + "_bnr"
    mgr = CheckpointManager(out_dir, keep=2)
    mgr.save(epoch, trainer.state_dict())
    mgr.wait()
    print(f"recalibrated batch_stats ({args.passes} passes) -> "
          f"{out_dir} (epoch {epoch})")
    return out_dir


if __name__ == "__main__":
    main()

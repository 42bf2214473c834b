"""Export a trained flagship conditional LDM (a `--train_dm` run of the
port's command line) to a compact float16 .npz snapshot: the port of
`tools/export_flagship.py`.

The snapshot holds the sampling state (weights, the EMA U-Net and the
quantizer's and BatchNorm's statistics, no optimizer moments) in the JAX
package's layout (`ldm3d_torch.utils.export`), so that the JAX package's
`load_state_npz` reads it too, plus the run's train_meta.json invariants,
the exported epoch, the source directory and that epoch's logged
fidelity. The port's serve CLI and `context_effect` take it in place of
a checkpoint directory.

Usage:
  python -m ldm3d_torch.tools.export_flagship \\
      [--ckpt runs/ckpt_flagship/flagship_dm] \\
      [--out runs/flagship/flagship_f16.npz] \\
      [--epoch N]          # default: best latent-FID, else the latest
      [--platform cpu]     # default: the GPU
"""

from __future__ import annotations

import argparse
import json
import os

from ldm3d_torch.core.config import (ExperimentConfig, TrainConfig,
                                     flagship_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> dict:
    """Returns the metadata written."""
    ap = argparse.ArgumentParser("ldm3d_torch.tools.export_flagship")
    ap.add_argument("--ckpt",
                    default=os.path.join(REPO, "runs", "ckpt_flagship",
                                         "flagship_dm"))
    ap.add_argument("--out",
                    default=os.path.join(REPO, "runs", "flagship",
                                         "flagship_f16.npz"))
    ap.add_argument("--epoch", type=int, default=None,
                    help="epoch to export (default: best logged latent-FID, "
                         "falling back to latest)")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="the GPU by default")
    args = ap.parse_args(argv)

    from ldm3d_torch.core.device import resolve_device
    from ldm3d_torch.train.checkpoint import CheckpointManager
    from ldm3d_torch.train.dm_trainer import DiffusionTrainer
    from ldm3d_torch.train.meta import (adopt_meta, best_fid_epoch,
                                        fidelity_from_jsonl, load_meta)
    from ldm3d_torch.utils.export import save_state_npz

    device = resolve_device("cpu" if args.platform == "cpu" else None)
    meta_path = os.path.join(args.ckpt, "train_meta.json")
    meta = load_meta(meta_path)
    if not os.path.exists(meta_path):
        print(f"WARNING: {meta_path} missing — exporting with the static "
              f"flagship-recipe invariants")
    cfg = adopt_meta(ExperimentConfig(diffusion=flagship_cfg(),
                                      train=TrainConfig(batch_size=1)),
                     argparse.Namespace(), meta)
    trainer = DiffusionTrainer(cfg.diffusion, device=device,
                               train_cfg=cfg.train)

    epoch = args.epoch if args.epoch is not None else best_fid_epoch(
        args.ckpt)
    state, epoch = CheckpointManager(args.ckpt).restore(epoch)
    print(f"restoring epoch {epoch} from {args.ckpt}")
    trainer.load_state_dict(state, optimizer=False)
    del state

    meta.update(fidelity_from_jsonl(args.ckpt, epoch))
    meta["epoch"] = int(epoch)
    meta["source_ckpt"] = os.path.relpath(args.ckpt, REPO)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    written = save_state_npz(args.out, trainer, meta)
    size = os.path.getsize(args.out)
    print(f"wrote {args.out}: {size / 1e6:.1f} MB, "
          f"{written['num_arrays']} arrays, meta={json.dumps(written)}")
    return written


if __name__ == "__main__":
    main()

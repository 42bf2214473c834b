"""Quality-parity report: convergence evidence vs the reference logs. The
port of `tools/quality_report.py`, over the port's `training.log` files.

Reads one or more CSVLogger `training.log` files from convergence runs and
emits (a) a markdown milestone table, (b) a loss/PSNR/SSIM curve PNG via
ldm3d_torch.utils.visualize, and (c) a comparison block against the
reference's committed Slurm logs (BASELINE.md: B8-all-KR val_loss 6.8e-4 /
best 6.9e-4 at ~60 epochs, reconst 0.0013-0.0014).

Run: python -m ldm3d_torch.tools.quality_report <training.log> \
         [--out report.md] [--png curves.png]
"""

from __future__ import annotations

import argparse

import numpy as np

from ldm3d_torch.utils.visualize import plot_loss_curves, read_training_log

REFERENCE_ROWS = [
    # (label, metric, value) from BASELINE.md (4x V100, real MRI "all")
    ("reference B8-all-KR final", "val_loss", 6.8e-4),
    ("reference B8-all-KR-25 best", "val_loss", 6.9e-4),
    ("reference B8-all-KR final", "reconst_loss", 0.0014),
]

MILESTONES = (1, 2, 5, 10, 20, 30, 40, 41, 45, 50, 60, 70)

COLS = ("loss", "reconst_loss", "quantize_loss", "val_loss",
        "val_reconst_loss", "val_psnr", "val_ssim",
        # --train_dm --fidelity_freq columns (ops/fid.py): the
        # sample-fidelity-vs-epoch curve the reference never measures
        "latent_fid", "latent_mmd")

# VQ-GAN per-term losses (train/gan_trainer.py); appended to the
# table only when the log contains them (the 40-warm-epoch rows log the
# adversarial terms as 0)
GAN_COLS = ("perceptual_loss", "gen_loss", "disc_loss", "gan_feat_loss",
            "val_perplexity")


def report(log_path: str) -> str:
    cols = read_training_log(log_path)
    epochs = np.asarray(cols["epoch"], int)
    table_cols = COLS + tuple(c for c in GAN_COLS if c in cols)
    lines = []
    lines.append(f"### Convergence: `{log_path}`\n")
    header = "| epoch | " + " | ".join(table_cols) + " |"
    lines.append(header)
    lines.append("|" + "---|" * (len(table_cols) + 1))

    def fmt(c, e_idx):
        if c not in cols:
            return "—"
        v = float(cols[c][e_idx])
        if not np.isfinite(v):   # blank cell (column appeared mid-run)
            return "—"
        return f"{v:.3f}" if "psnr" in c or "ssim" in c else f"{v:.2e}"

    for m in MILESTONES:
        idx = np.where(epochs == m - 1)[0]  # CSVLogger epochs are 0-based
        if idx.size == 0:
            idx = np.where(epochs == m)[0]
        if idx.size == 0:
            continue
        i = int(idx[0])
        lines.append(f"| {m} | " + " | ".join(fmt(c, i) for c in table_cols) + " |")
    # final row
    i = len(epochs) - 1
    lines.append(f"| final ({int(epochs[i]) + 1}) | "
                 + " | ".join(fmt(c, i) for c in table_cols) + " |")

    lines.append("\n**Reference comparison** (4x V100 on real MRI; this run: "
                 "the fixed 1232-volume synthetic corpus — same "
                 "architecture/hyperparameters, different data, so loss "
                 "scales are indicative, not identical):\n")
    lines.append("| run | metric | value |")
    lines.append("|---|---|---|")
    for label, metric, value in REFERENCE_ROWS:
        lines.append(f"| {label} | {metric} | {value:.2e} |")
    for metric in ("val_loss", "val_reconst_loss"):
        if metric in cols:
            best = float(np.nanmin(cols[metric]))
            lines.append(f"| this framework (best) | {metric} | {best:.2e} |")
    for metric in ("val_psnr", "val_ssim"):
        if metric in cols:
            vals = np.asarray(cols[metric], float)
            vals = vals[np.isfinite(vals)]
            if metric == "val_ssim":
                # a physically invalid SSIM > 1 (a bf16 conv variance
                # error) is excluded from "best"
                vals = vals[vals <= 1.0]
            if vals.size == 0:
                continue
            best = float(np.max(vals))
            lines.append(f"| this framework (best) | {metric} | {best:.3f} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> str:
    """Returns the report's text."""
    ap = argparse.ArgumentParser("ldm3d_torch.tools.quality_report")
    ap.add_argument("logs", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--png", default=None)
    args = ap.parse_args(argv)

    text = "\n".join(report(p) for p in args.logs)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    if args.png:
        plot_loss_curves(args.logs, args.png,
                         metrics=("loss", "val_loss", "val_psnr"))
        print(f"curves -> {args.png}")
    return text


if __name__ == "__main__":
    main()

"""A/B comparison of two VQ-GAN convergence runs (fixed vs adaptive
generator weight): the port of `tools/gan_ab.py`, over the port's
`training.log` files.

Reads two CSVLogger ``training.log`` files, epoch-aligns them, and emits a
markdown table plus an overlay PNG of the metrics that show whether the
adversarial phase preserved reconstruction quality (val_ssim / val_psnr /
val_reconst_loss) or diverged (gen_loss growing unbounded): the
--adaptive_gan_weight stabilizer (train/gan_trainer.py, Esser et al. 2021
eq. 7) against the fixed-weight recipe the reference hard-codes.

Run: python -m ldm3d_torch.tools.gan_ab A=runs/a/training.log \
         B=runs/b/training.log [--out ab.md] [--png ab.png] [--threshold 10]
"""

from __future__ import annotations

import argparse

import numpy as np

from ldm3d_torch.utils.visualize import read_training_log

METRICS = ("val_ssim", "val_psnr", "val_reconst_loss", "gen_loss",
           "disc_loss", "adaptive_weight")


def load(spec: str):
    label, path = spec.split("=", 1)
    cols = read_training_log(path)
    if not cols:
        raise SystemExit(f"empty log: {path}")
    return label, path, cols


def best_at(cols, metric, lo, hi, reduce=np.nanmax):
    """Reduce a metric over the epoch window [lo, hi] (inclusive)."""
    if metric not in cols:
        return None
    ep = np.asarray(cols["epoch"], int)
    sel = (ep >= lo) & (ep <= hi)
    if not sel.any():
        return None
    vals = np.asarray(cols[metric], float)[sel]
    if np.all(np.isnan(vals)):
        return None
    return float(reduce(vals))


def main(argv=None) -> str:
    """Returns the report's text."""
    ap = argparse.ArgumentParser("ldm3d_torch.tools.gan_ab")
    ap.add_argument("specs", nargs=2, help="LABEL=path/to/training.log")
    ap.add_argument("--out", default=None)
    ap.add_argument("--png", default=None)
    ap.add_argument("--threshold", type=int, default=10,
                    help="disc_threshold epoch separating warm/adversarial")
    args = ap.parse_args(argv)

    runs = [load(s) for s in args.specs]
    thr = args.threshold

    lines = ["# VQ-GAN adversarial-phase A/B\n"]
    lines.append(f"Warm-up: epochs < {thr}; adversarial: epochs >= {thr}. "
                 "Fixed weights are the reference recipe "
                 "(vqgan_attn_cp.py:725-766); 'adaptive' rescales the "
                 "generator adversarial term by "
                 "lambda = ||grad_rec||/||grad_adv|| each step "
                 "(--adaptive_gan_weight).\n")
    lines.append("| run | log | epochs | val_ssim @warm-end | "
                 "val_ssim best (adv) | val_ssim last | val_psnr last | "
                 "val_reconst last | gen_loss last | mean adaptive_weight |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|")

    for label, path, cols in runs:
        ep = np.asarray(cols["epoch"], int)
        last = int(ep.max())

        def lastv(m):
            if m not in cols:
                return None
            v = np.asarray(cols[m], float)
            v = v[~np.isnan(v)]
            return float(v[-1]) if v.size else None

        def f(v, s="%.3f"):
            return "—" if v is None else (s % v)

        warm_end = best_at(cols, "val_ssim", thr - 1, thr - 1)
        adv_best = best_at(cols, "val_ssim", thr, last)
        mean_aw = best_at(cols, "adaptive_weight", thr, last,
                          reduce=np.nanmean)
        lines.append(
            f"| {label} | `{path}` | {last + 1} | {f(warm_end)} | "
            f"{f(adv_best)} | {f(lastv('val_ssim'))} | "
            f"{f(lastv('val_psnr'), '%.2f')} | "
            f"{f(lastv('val_reconst_loss'), '%.2e')} | "
            f"{f(lastv('gen_loss'), '%.2f')} | {f(mean_aw, '%.4g')} |")

    # per-epoch adversarial-phase table
    lines.append("\n### Per-epoch (adversarial phase)\n")
    hdr = ["epoch"]
    for label, _, _ in runs:
        hdr += [f"{label} val_ssim", f"{label} val_psnr",
                f"{label} gen_loss"]
    lines.append("| " + " | ".join(hdr) + " |")
    lines.append("|" + "---|" * len(hdr))
    max_ep = max(int(np.asarray(c["epoch"], int).max()) for _, _, c in runs)
    for e in range(thr, max_ep + 1):
        row = [str(e + 1)]
        for _, _, cols in runs:
            for m, s in (("val_ssim", "%.3f"), ("val_psnr", "%.2f"),
                         ("gen_loss", "%.2f")):
                v = best_at(cols, m, e, e)
                row.append("—" if v is None else (s % v))
        lines.append("| " + " | ".join(row) + " |")

    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
        print(f"wrote {args.out}")
    else:
        print(text)

    if args.png:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for (label, _, cols), color in zip(runs, ("C0", "C1")):
            ep = np.asarray(cols["epoch"], int) + 1
            for ax, m, logy in zip(axes,
                                   ("val_ssim", "val_psnr", "gen_loss"),
                                   (False, False, False)):
                if m in cols:
                    ax.plot(ep, np.asarray(cols[m], float), color,
                            label=label)
                ax.set_title(m)
                ax.set_xlabel("epoch")
                ax.grid(alpha=0.3)
        for ax in axes:
            ax.axvline(thr + 0.5, ls="--", c="gray", lw=1)
            ax.legend()
        fig.tight_layout()
        fig.savefig(args.png, dpi=110)
        plt.close(fig)
        print(f"wrote {args.png}")
    return text


if __name__ == "__main__":
    main()

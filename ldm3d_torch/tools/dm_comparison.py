"""DM loss-floor isolation table: the port of `tools/dm_comparison.py`,
over the port's `training.log` files.

Reads the training.log CSVs of the stage-2 runs (e.g. T=500 eps, T=1000
eps, T=1000 v-pred) and emits one markdown table: final/best train loss
(reference-scaled sum-MSE), noise MSE, and the latent-fidelity metrics
(ops/fid.py) per run — the apples-to-apples comparison against the
reference's logged 9.2e-6 at T=500.

Run: python -m ldm3d_torch.tools.dm_comparison LABEL=path/training.log ... \
         [--out f.md]
"""

from __future__ import annotations

import argparse

import numpy as np

from ldm3d_torch.utils.visualize import read_training_log

COLS = ("loss", "noise_mse", "latent_fid", "latent_mmd")


def summarize(path: str) -> dict:
    cols = read_training_log(path)
    out = {"epochs": int(np.asarray(cols["epoch"], float).max()) + 1}
    for c in COLS:
        if c not in cols:
            continue
        vals = np.asarray(cols[c], float)
        valid = vals[np.isfinite(vals)]
        if valid.size == 0:
            continue
        out[f"{c}_final"] = float(valid[-1])
        out[f"{c}_best"] = float(valid.min())
    return out


def main(argv=None) -> str:
    """Returns the table's text."""
    ap = argparse.ArgumentParser("ldm3d_torch.tools.dm_comparison")
    ap.add_argument("runs", nargs="+", help="LABEL=path/to/training.log")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rows = []
    for spec in args.runs:
        label, path = spec.split("=", 1)
        rows.append((label, summarize(path)))

    lines = ["### Stage-2 loss-floor / parameterization comparison", ""]
    lines.append("| run | epochs | train loss (final/best) | noise MSE "
                 "(final) | latent-FID (final/best) | kernel-MMD (final) |")
    lines.append("|---|---|---|---|---|---|")
    for label, s in rows:
        def f(key, fmt="{:.3e}"):
            return fmt.format(s[key]) if key in s else "—"
        lines.append(
            f"| {label} | {s['epochs']} "
            f"| {f('loss_final')} / {f('loss_best')} "
            f"| {f('noise_mse_final', '{:.4f}')} "
            f"| {f('latent_fid_final', '{:.3f}')} / "
            f"{f('latent_fid_best', '{:.3f}')} "
            f"| {f('latent_mmd_final', '{:.4f}')} |")
    lines.append("")
    lines.append("Reference comparison: the reference's only logged DM "
                 "number is train loss 9.2e-6 — a T=500 *unconditional* "
                 "run on real-MRI latents "
                 "(experiments/dm/dm3d-B8-500-all.output); the T=500 row "
                 "above is the apples-to-apples configuration on this "
                 "corpus. Loss is the reference-scaled sum-MSE/(bs*lc^4); "
                 "latent-FID/MMD are computed against held-out frozen-"
                 "encoder features (lower is better; the reference has no "
                 "sample-fidelity metric).")
    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as fobj:
            fobj.write(text)
    print(text)
    return text


if __name__ == "__main__":
    main()

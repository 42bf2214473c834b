"""Offline analysis plots: the port of `ldm3d.utils.visualize`, over the
port's own `training.log` CSVs and `.npy` volumes (the JAX package's
formats). matplotlib is imported when a plot is drawn, not before.

The reference inspects runs with two notebooks: `Visualize_Loss.ipynb`
(pandas plots of the CSVLogger `training.log` files) and
`Visualize_Images.ipynb` (ipywidgets slice browser over saved `.npy`
original/reconstruction volumes). Headless equivalents here render PNGs
from the same artifacts, so `training.log` CSVs and `.npy` volumes remain
the interchange formats.

CLI: python -m ldm3d_torch.utils.visualize loss <training.log> [...] \
         --out loss.png
     python -m ldm3d_torch.utils.visualize volumes <a.npy> [b.npy ...] \
         --out recon.png
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional, Sequence

import numpy as np


def read_training_log(path: str) -> dict:
    """training.log CSV (epoch,loss,...) -> {column: np.ndarray}."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    def cell(r, k):
        # blank cells (columns that appeared mid-run, e.g. periodic
        # latent_fid) parse to NaN rather than dropping the column
        v = r.get(k, "")
        if v is None or v == "":
            return np.nan
        return float(v)

    cols = {}
    for k in rows[-1]:
        try:
            cols[k] = np.array([cell(r, k) for r in rows])
        except (TypeError, ValueError):
            continue
    return cols


def plot_loss_curves(log_paths: Sequence[str], out_path: str,
                     metrics: Optional[Sequence[str]] = None,
                     logy: bool = True) -> str:
    """Render loss curves from one or more training.log files
    (reference notebooks/Visualize_Loss.ipynb)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for path in log_paths:
        cols = read_training_log(path)
        if not cols:
            continue
        x = cols.get("epoch", np.arange(len(next(iter(cols.values())))))
        run = os.path.basename(os.path.dirname(os.path.abspath(path)))
        names = metrics or [k for k in cols if k != "epoch"]
        for k in names:
            if k in cols:
                label = f"{run}:{k}" if len(log_paths) > 1 else k
                ax.plot(x, cols[k], label=label)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend(fontsize=7)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def _mid_slices(vol: np.ndarray) -> List[np.ndarray]:
    """Axial / coronal / sagittal mid-planes of one [H,W,D(,C)] volume."""
    if vol.ndim == 4:
        vol = vol[..., 0]
    h, w, d = vol.shape
    return [vol[h // 2, :, :], vol[:, w // 2, :], vol[:, :, d // 2]]


def plot_volume_grid(npy_paths: Sequence[str], out_path: str,
                     max_items: int = 8) -> str:
    """Slice-montage browser over saved volumes (reference
    notebooks/Visualize_Images.ipynb): one row per volume (batch items
    flattened), columns = axial/coronal/sagittal mid-slices."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = []
    for path in npy_paths:
        arr = np.load(path)
        vols = arr if arr.ndim >= 4 else arr[None]
        for b in range(vols.shape[0]):
            rows.append((f"{os.path.basename(path)}[{b}]", vols[b]))
            if len(rows) >= max_items:
                break
        if len(rows) >= max_items:
            break

    fig, axes = plt.subplots(len(rows), 3, figsize=(9, 3 * len(rows)),
                             squeeze=False)
    for r, (name, vol) in enumerate(rows):
        for c, sl in enumerate(_mid_slices(np.asarray(vol, np.float32))):
            axes[r][c].imshow(sl.T, cmap="gray", origin="lower")
            axes[r][c].axis("off")
        axes[r][0].set_title(name, fontsize=7, loc="left")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser("ldm3d_torch.utils.visualize")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_loss = sub.add_parser("loss")
    p_loss.add_argument("logs", nargs="+")
    p_loss.add_argument("--out", default="loss.png")
    p_loss.add_argument("--metrics", nargs="*", default=None)
    p_loss.add_argument("--linear", action="store_true")
    p_vol = sub.add_parser("volumes")
    p_vol.add_argument("volumes", nargs="+")
    p_vol.add_argument("--out", default="volumes.png")
    p_vol.add_argument("--max_items", type=int, default=8)
    args = ap.parse_args(argv)
    if args.cmd == "loss":
        out = plot_loss_curves(args.logs, args.out, metrics=args.metrics,
                               logy=not args.linear)
    else:
        out = plot_volume_grid(args.volumes, args.out,
                               max_items=args.max_items)
    print("wrote", out)


if __name__ == "__main__":
    main()

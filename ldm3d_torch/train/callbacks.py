"""Training callbacks: the port of `ldm3d.train.callbacks`.

  - CSVLogger                 one row per epoch in `training.log`, the
                              Keras CSVLogger format, byte for byte the
                              JAX package's (so `ldm3d.utils.visualize`
                              reads either package's log)
  - MetricsLogger             one JSON line per record in `metrics.jsonl`,
                              the JAX package's records
  - ReduceLROnPlateau         Keras plateau scheduler over a torch
                              optimizer's learning rate
  - DelayedReduceLROnPlateau  the same, from `start_epoch` on
  - ImageLogger               mid-slice montages of rendered volumes every
                              `log_freq` epochs, as PNG files

The learning rate is held rounded to float32, as the JAX optimizer's
hyper-parameter is, so that a schedule takes the same decisions in both
packages. ImageLogger writes its PNG with zlib (the GPU machine has no
matplotlib): one row per volume, the three mid-planes of each, every
slice scaled to its own range as matplotlib's `imshow` does; the pixels
are not matplotlib's rendering.
"""

from __future__ import annotations

import csv
import json
import os
import struct
import time
import zlib
from typing import Any, Dict

import numpy as np


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = float(np.float32(lr))
    return optimizer


class ReduceLROnPlateau:
    """Keras-semantics plateau scheduler: after `patience` epochs without
    an improvement of `min_delta` in `monitor`, multiply the learning rate
    by `factor`, down to `min_lr`."""

    def __init__(self, monitor: str = "loss", factor: float = 0.5,
                 patience: int = 10, min_lr: float = 1e-6,
                 min_delta: float = 1e-4, start_epoch: int = 0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.start_epoch = start_epoch
        self._best = float("inf")
        self._wait = 0

    def __call__(self, epoch: int, metrics: Dict[str, float],
                 optimizer) -> tuple[Any, bool]:
        """Returns (optimizer, reduced?)."""
        if epoch < self.start_epoch or self.monitor not in metrics:
            return optimizer, False
        value = float(metrics[self.monitor])
        if value < self._best - self.min_delta:
            self._best = value
            self._wait = 0
            return optimizer, False
        self._wait += 1
        if self._wait < self.patience:
            return optimizer, False
        self._wait = 0
        old = get_learning_rate(optimizer)
        new = max(old * self.factor, self.min_lr)
        # relative tolerance: the float32 min_lr must not count as a
        # reduction once the floor is reached
        if new < old * (1.0 - 1e-6):
            return set_learning_rate(optimizer, new), True
        return optimizer, False


class DelayedReduceLROnPlateau(ReduceLROnPlateau):
    """Plateau scheduler that starts at `start_epoch`."""

    def __init__(self, start_epoch: int, **kwargs):
        super().__init__(start_epoch=start_epoch, **kwargs)


class CSVLogger:
    """Appends one row per epoch to training.log (Keras CSVLogger format).
    Columns that first appear mid-run widen the header: the file is
    rewritten once, earlier rows with blanks; `append=True` adopts an
    existing file's header."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fieldnames = None
        if not append and os.path.exists(path):
            os.remove(path)

    def __call__(self, epoch: int, metrics: Dict[str, float]):
        row = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        new_file = not os.path.exists(self.path)
        if self._fieldnames is None:
            if not new_file:
                with open(self.path, newline="") as f:
                    header = next(csv.reader(f), None)
                self._fieldnames = header or list(row.keys())
            else:
                self._fieldnames = list(row.keys())
        late = [k for k in row if k not in self._fieldnames]
        if late:
            self._fieldnames = self._fieldnames + late
            if not new_file:
                with open(self.path, newline="") as f:
                    old_rows = list(csv.DictReader(f))
                with open(self.path, "w", newline="") as f:
                    writer = csv.DictWriter(f, fieldnames=self._fieldnames)
                    writer.writeheader()
                    for r in old_rows:
                        writer.writerow(r)
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            if new_file:
                writer.writeheader()
            writer.writerow(row)


def _png(path: str, gray: np.ndarray) -> str:
    """Write an 8-bit grayscale image [H, W] as a PNG file."""
    h, w = gray.shape
    raw = b"".join(b"\x00" + gray[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))
    return path


def volume_montage(vols: np.ndarray, max_items: int = 8) -> np.ndarray:
    """uint8 montage of the axial, coronal and sagittal mid-planes (one
    row per volume of [B, H, W, D(, C)] or [H, W, D(, C)]), each plane
    transposed with its origin at the bottom and scaled to [0, 255]."""
    vols = np.asarray(vols, np.float32)
    if vols.ndim == 5 or (vols.ndim == 4 and vols.shape[-1] != 1):
        items = list(vols[:max_items])
    else:
        items = [vols]
    rows = []
    for vol in items:
        if vol.ndim == 4:
            vol = vol[..., 0]
        h, w, d = vol.shape
        planes = []
        for sl in (vol[h // 2], vol[:, w // 2], vol[:, :, d // 2]):
            img = sl.T[::-1]
            lo, hi = float(img.min()), float(img.max())
            scale = 255.0 / (hi - lo) if hi > lo else 0.0
            planes.append(np.round((img - lo) * scale).astype(np.uint8))
        height = max(p.shape[0] for p in planes)
        rows.append(np.concatenate(
            [np.pad(p, ((0, height - p.shape[0]), (0, 0))) for p in planes],
            axis=1))
    width = max(r.shape[1] for r in rows)
    return np.concatenate(
        [np.pad(r, ((0, 0), (0, width - r.shape[1]))) for r in rows], axis=0)


class ImageLogger:
    """Every `log_freq` epochs, `render_fn(trainer) -> {name: volumes}`
    and one montage per name, `{out_dir}/epoch{N}_{name}.png`. With
    `write=False` (every process but 0 of a multi-process run) it renders,
    since a render may hold collectives, and writes nothing."""

    def __init__(self, out_dir: str, render_fn, log_freq: int = 10,
                 write: bool = True):
        self.out_dir = out_dir
        self.render_fn = render_fn
        self.log_freq = max(1, log_freq)
        self.write = write
        if write:
            os.makedirs(out_dir, exist_ok=True)

    def __call__(self, epoch: int, trainer) -> None:
        if (epoch + 1) % self.log_freq:
            return
        for name, vol in self.render_fn(trainer).items():
            if self.write:
                _png(os.path.join(self.out_dir,
                                  f"epoch{epoch + 1}_{name}.png"),
                     volume_montage(vol))


class MetricsLogger:
    """JSONL metric stream, one record per call: {"run", "step", "time",
    metrics...}."""

    def __init__(self, path: str, run_name: str = "run"):
        self.path = path
        self.run_name = run_name
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def __call__(self, step: int, metrics: Dict[str, float],
                 prefix: str = ""):
        rec = {"run": self.run_name, "step": step, "time": time.time()}
        rec.update({(prefix + k): float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

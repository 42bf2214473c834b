"""The epoch training loop: the port of `ldm3d.train.loop` (`fit`,
`fit_with_recovery`).

The port's trainer holds its own state, so the loop passes batches to a
step function and checkpoints `trainer.state_dict()`; the JAX loop
threads a state pytree through instead. Steps run one by one (the JAX
package's fused one-program epoch is ROADMAP queue 1 item 3(c)); each
step's metrics stay on the device until the epoch ends, when they are
fetched in one transfer. Between epochs, in the JAX loop's order: the
validation pass, the VQ-GAN's epoch counter, unused-code replacement, the
plateau schedule, the epoch callback, logging and the checkpoint.

Across processes every process runs the loop (the trainers reduce each
step's metrics, so every process sees the global ones), the caller gives
the loggers and the checkpoint manager to process 0 only, and the others
wait at a barrier at the end of each epoch while it writes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ldm3d_torch.parallel.distributed import barrier, is_primary
from ldm3d_torch.train.callbacks import (CSVLogger, MetricsLogger,
                                         ReduceLROnPlateau, get_learning_rate)
from ldm3d_torch.train.checkpoint import CheckpointManager

# best-metric checkpoint pinning: the first metric of this list that the
# epoch reports decides; a new best epoch is saved and pinned
_PIN_RULES = (("latent_fid", "min"), ("val_psnr", "max"))


def eval_seed(epoch: int, batch: int) -> int:
    """The seed of a VQ-GAN validation batch's frames: one per epoch and
    batch, so that the validation frames move between epochs."""
    return ((1000 + epoch) << 20) + batch


def _mean_metrics(history: List[Dict[str, torch.Tensor]]
                  ) -> Dict[str, float]:
    """Per-key means of an epoch's step metrics, fetched in one transfer
    (one stacked tensor per device) and averaged in float64."""
    keys = list(history[0])
    rows = [torch.stack([torch.as_tensor(h[k], dtype=torch.float32)
                         .reshape(()) for k in keys]) for h in history]
    vals = torch.stack(rows).cpu().numpy()
    return {k: float(np.mean(vals[:, i].astype(np.float64)))
            for i, k in enumerate(keys)}


def fit(trainer, train_loader, epochs: int,
        val_loader=None,
        ckpt: Optional[CheckpointManager] = None,
        csv_logger: Optional[CSVLogger] = None,
        metrics_logger: Optional[MetricsLogger] = None,
        lr_schedule: Optional[ReduceLROnPlateau] = None,
        replace_codebook_freq: int = 0,
        initial_epoch: int = 0,
        ckpt_freq: int = 1,
        step_fn: Optional[Callable] = None,
        image_logger=None,
        epoch_callback: Optional[Callable] = None,
        is_gan: bool = False,
        verbose: bool = True) -> Dict[str, float]:
    """Train `trainer` from `initial_epoch` to `epochs`; returns the last
    epoch's metrics.

    - `step_fn(batch) -> metrics` defaults to
      `trainer.train_step(vol, context)` of a (vol, mask, context) batch.
    - With `val_loader`, each epoch ends with `trainer.eval_step(vol,
      mask)` over it, logged as `val_<name>`; with `is_gan` (a
      `GANTrainer`) each batch's frames come from a seed of its own per
      epoch and batch, and `trainer.next_epoch()` follows.
    - `replace_codebook_freq` N > 0 (a `VQTrainer`): every N epochs
      `trainer.replace_unused(num_batches)`, logged as
      `codebooks_replaced`.
    - `lr_schedule(epoch, metrics, trainer.optimizer)` may lower the
      learning rate.
    - `epoch_callback(epoch, trainer) -> dict` runs after the epoch; its
      entries join the logged metrics (the latent-FID of --train_dm).
    - A checkpoint is saved every `ckpt_freq` epochs, at the last epoch,
      and at every new best of the first `_PIN_RULES` metric the epoch
      reports (pinned: retention never drops it); its metric for
      save_best_only is val_loss, else loss.
    - Across processes, only process 0 prints; every process waits for
      the others at the end of each epoch.
    """
    verbose = verbose and is_primary()
    last_metrics: Dict[str, float] = {}
    best_pin: Dict[str, float] = {}
    for epoch in range(initial_epoch, epochs):
        t0 = time.time()
        history = []
        for batch in train_loader:
            if step_fn is not None:
                metrics = step_fn(batch)
            else:
                metrics = trainer.train_step(batch[0], batch[2])
            history.append(metrics)
        if not history:
            raise ValueError("empty training loader")
        num_batches = len(history)
        last_metrics = _mean_metrics(history)

        if val_loader is not None:
            vh = [trainer.eval_step(batch[0], batch[1],
                                    seed=eval_seed(epoch, i))
                  if is_gan else trainer.eval_step(batch[0], batch[1])
                  for i, batch in enumerate(val_loader)]
            if vh:
                last_metrics.update({f"val_{k}": v for k, v in
                                     _mean_metrics(vh).items()})
        if is_gan:
            trainer.next_epoch()
        if (replace_codebook_freq
                and (epoch + 1) % replace_codebook_freq == 0):
            last_metrics["codebooks_replaced"] = float(
                trainer.replace_unused(num_batches))
        if lr_schedule is not None:
            _, reduced = lr_schedule(epoch, last_metrics, trainer.optimizer)
            if reduced and verbose:
                print(f"epoch {epoch + 1}: lr -> "
                      f"{get_learning_rate(trainer.optimizer):.2e}")

        if epoch_callback is not None:
            extra = epoch_callback(epoch, trainer)
            if extra:
                last_metrics.update({k: float(v) for k, v in extra.items()})

        if csv_logger is not None:
            csv_logger(epoch, last_metrics)
        if metrics_logger is not None:
            metrics_logger(epoch, last_metrics)
        if image_logger is not None:
            image_logger(epoch, trainer)
        pin = None
        if ckpt is not None:
            for name, mode in _PIN_RULES:
                if name not in last_metrics:
                    continue
                v = last_metrics[name]
                prev = best_pin.get(name)
                if prev is None or (v < prev if mode == "min" else v > prev):
                    best_pin[name] = v
                    pin = f"best_{name}"
                break
        if ckpt is not None and (pin is not None
                                 or (epoch + 1) % max(ckpt_freq, 1) == 0
                                 or epoch + 1 == epochs):
            ckpt.save(epoch + 1, trainer.state_dict(),
                      metric=last_metrics.get("val_loss",
                                              last_metrics.get("loss")),
                      pin=pin)
            if pin is not None:
                last_metrics["pinned_best"] = 1.0
                if metrics_logger is not None:
                    metrics_logger(epoch, {pin: best_pin[name],
                                           "pinned_epoch": epoch + 1})
        barrier()
        if verbose:
            dt = time.time() - t0
            msg = " ".join(f"{k}={v:.5f}" for k, v in last_metrics.items()
                           if isinstance(v, float))
            print(f"epoch {epoch + 1}/{epochs} [{dt:.1f}s "
                  f"{num_batches} steps] {msg}")
    return last_metrics


def _cpu_copy(tree):
    """A copy of a state dict with every tensor cloned to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    return tree


def fit_with_recovery(trainer, train_loader, epochs: int,
                      ckpt: Optional[CheckpointManager],
                      max_restarts: int = 2, initial_epoch: int = 0,
                      verbose: bool = True, **fit_kwargs
                      ) -> Dict[str, float]:
    """`fit`, restarted after an exception from the latest checkpoint (or,
    with none yet, from the state the trainer had when this was called),
    up to `max_restarts` times."""
    start = _cpu_copy(trainer.state_dict())
    restarts = 0
    while True:
        try:
            return fit(trainer, train_loader, epochs, ckpt=ckpt,
                       initial_epoch=initial_epoch, verbose=verbose,
                       **fit_kwargs)
        except Exception as e:   # any failure of a step or a callback
            restarts += 1
            if restarts > max_restarts or ckpt is None:
                raise
            try:
                state, initial_epoch = ckpt.restore()
            except FileNotFoundError:
                state, initial_epoch = start, 0
            trainer.load_state_dict(state)
            if verbose:
                print(f"recovered from '{type(e).__name__}: {e}' — "
                      f"resuming at epoch {initial_epoch} "
                      f"(restart {restarts}/{max_restarts})")

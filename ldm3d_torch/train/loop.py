"""The epoch training loop: the port of `ldm3d.train.loop` (`fit`,
`fit_with_recovery`).

The port's trainer holds its own state, so the loop passes batches to a
step function and checkpoints `trainer.state_dict()`; the JAX loop
threads a state pytree through instead. Steps run one by one (the JAX
package's fused one-program epoch is ROADMAP queue 4 item 3(c)); each
step's metrics stay on the device until the epoch ends, when they are
fetched in one transfer. Between epochs, in the JAX loop's order: the
validation pass, the VQ-GAN's epoch counter, unused-code replacement, the
plateau schedule, the epoch callback, logging and the checkpoint.

Across processes every process runs the loop (the trainers reduce each
step's metrics, so every process sees the global ones) and decides each
save (the best-metric pins included): every process takes the trainer's
state, which under tensor parallelism gathers its shards, and process 0
alone writes it (its `CheckpointManager` writes, the others' only read)
and the loggers' files. The epoch ends with one small all-reduce over
the processes, which also waits for process 0's writes.

`fit_with_recovery` makes failures collective: each process holds an
exception raised where every process stands outside a collective (while
a batch is fetched, in the epoch's own work, its logging and its save)
until the next agreement, one all-reduce of a flag per process, after
the fetch and before the step, and twice at the epoch's end. Then every
process raises, and every process restores the epoch process 0 saved
last. A failure inside a step on one process alone, between two of the
step's collectives, is not caught so: the others wait in the collective.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ldm3d_torch.parallel.distributed import (barrier, is_initialized,
                                              is_primary, process_count,
                                              process_index)
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


class PeerFailure(RuntimeError):
    """Raised by `fit`, with agreement on, on the processes that did not
    fail when another did."""


def _agree(err: Optional[BaseException]) -> None:
    """One all-reduce over every process of a flag each: raises `err` on
    the process that failed and `PeerFailure` on the others when any
    did; a barrier otherwise. Without a process group, raises `err`."""
    if is_initialized():
        flags = torch.zeros(process_count(), dtype=torch.int32)
        flags[process_index()] = err is not None
        dist.all_reduce(flags)
        failed = flags.nonzero().flatten().tolist()
        if failed and err is None:
            raise PeerFailure(f"process {failed} failed")
    if err is not None:
        raise err


class _Held:
    """The exceptions of blocks that every process runs (`hold`), kept
    until `agree` when `on`, else raised at once. A process whose block
    failed goes on with the blocks after it, so that it joins their
    collectives."""

    def __init__(self, on: bool):
        self.on, self.err = on, None

    @contextlib.contextmanager
    def hold(self):
        if not self.on:
            yield
            return
        try:
            yield
        except Exception as e:       # held: raised by `agree`
            self.err = self.err or e

    def agree(self) -> None:
        err, self.err = self.err, None
        if self.on:
            _agree(err)


def _batches(loader, agree: bool):
    """The batches of `loader`; with `agree`, each fetch (its failure or
    its end) agreed on by every process before the step."""
    it = iter(loader)
    while True:
        held = _Held(agree)
        batch = end = None
        with held.hold():
            try:
                batch = next(it)
            except StopIteration:
                end = True
        held.agree()
        if end:
            return
        yield batch


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
        verbose: bool = True, agree: bool = False) -> Dict[str, float]:
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
      the others at the end of each epoch. With `agree` (from
      `fit_with_recovery`) failures are agreed on by every process (see
      the module docstring).
    """
    verbose = verbose and is_primary()
    last_metrics: Dict[str, float] = {}
    best_pin: Dict[str, float] = {}
    for epoch in range(initial_epoch, epochs):
        t0 = time.time()
        history = []
        for batch in _batches(train_loader, agree):
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
        held = _Held(agree)
        with held.hold():
            if is_gan:
                trainer.next_epoch()
            if (replace_codebook_freq
                    and (epoch + 1) % replace_codebook_freq == 0):
                last_metrics["codebooks_replaced"] = float(
                    trainer.replace_unused(num_batches))
            if lr_schedule is not None:
                _, reduced = lr_schedule(epoch, last_metrics,
                                         trainer.optimizer)
                if reduced and verbose:
                    print(f"epoch {epoch + 1}: lr -> "
                          f"{get_learning_rate(trainer.optimizer):.2e}")
            if epoch_callback is not None:
                extra = epoch_callback(epoch, trainer)
                if extra:
                    last_metrics.update({k: float(v)
                                         for k, v in extra.items()})
        # the epoch's rows are written only once it stands on every process
        held.agree()

        with held.hold():
            if csv_logger is not None:
                csv_logger(epoch, last_metrics)
            if metrics_logger is not None:
                metrics_logger(epoch, last_metrics)
        with held.hold():
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
            # every process: the state gathers tensor-parallel shards
            state = trainer.state_dict()
            with held.hold():
                ckpt.save(epoch + 1, state,
                          metric=last_metrics.get("val_loss",
                                                  last_metrics.get("loss")),
                          pin=pin)
                if pin is not None:
                    last_metrics["pinned_best"] = 1.0
                    if metrics_logger is not None:
                        metrics_logger(epoch, {pin: best_pin[name],
                                               "pinned_epoch": epoch + 1})
            del state
        # every process waits here for process 0's writes
        if agree:
            held.agree()
        else:
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
    up to `max_restarts` times. Across processes the failures are agreed
    on (`fit`'s `agree`), every process restores the epoch process 0
    saved last, and each prints its recovery. `train_loader` goes back to
    the restored epoch's order when it can (`seek`)."""
    start = _cpu_copy(trainer.state_dict())
    first = initial_epoch
    seek = getattr(train_loader, "seek", None)
    base = getattr(train_loader, "epoch", 0)
    restarts = 0
    while True:
        try:
            return fit(trainer, train_loader, epochs, ckpt=ckpt,
                       initial_epoch=initial_epoch, verbose=verbose,
                       agree=True, **fit_kwargs)
        except Exception as e:   # any failure of a step or a callback
            restarts += 1
            if restarts > max_restarts or ckpt is None:
                raise
            latest = _latest_saved(ckpt)
            if latest is None:
                state, initial_epoch = start, first
            else:
                state, initial_epoch = ckpt.restore(latest)
            trainer.load_state_dict(state)
            if seek is not None:
                seek(base + initial_epoch - first)
            if verbose:
                where = f" (process {process_index()})" \
                    if process_count() > 1 else ""
                print(f"recovered from '{type(e).__name__}: {e}'{where} — "
                      f"resuming at epoch {initial_epoch} "
                      f"(restart {restarts}/{max_restarts})", flush=True)


def _latest_saved(ckpt: CheckpointManager) -> Optional[int]:
    """The latest epoch in `ckpt`'s directory as process 0 sees it,
    broadcast to every process (None: nothing saved)."""
    latest = ckpt.latest_epoch() if is_primary() else None
    if is_initialized():
        got = [latest]
        dist.broadcast_object_list(got, src=0)
        latest = got[0]
    return latest

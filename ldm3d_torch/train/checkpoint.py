"""Epoch checkpoints of a whole training state: the port of
`ldm3d.train.checkpoint` (same API and retention rules; no orbax).

One file per epoch, `{directory}/{epoch}.pt`, holding what it is given to
save, as a rule `DiffusionTrainer.state_dict()`: the model, the EMA
U-Net, Adam's state, the step, the generator's state and the latent
scale, so that a restored trainer goes on as if it had never stopped. A
save is written under a temporary name and moved into place with
`os.replace`, so a crash leaves the previous epochs whole. Saves are
synchronous: `wait` and `close` have nothing to wait for.

Retention keeps the newest `keep` epochs and every pinned epoch (the
best-metric epochs of `loop.fit`, recorded in `pinned.json`, which a new
manager on the same directory honours).

Across processes each holds a manager on the one directory; process 0's
writes (`write=True`) and the others' only read: their `save` takes the
same decisions (save_best_only, pins) and writes nothing.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import torch

_FILE = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """Epoch-indexed checkpoints with retention and pinning."""

    def __init__(self, directory: str, keep: int = 5,
                 save_best_only: bool = False, write: bool = True):
        self.directory = os.path.abspath(directory)
        self.write = write
        if write:
            os.makedirs(self.directory, exist_ok=True)
        self.save_best_only = save_best_only
        self.keep = keep
        self._best = float("inf")
        self._pin_path = os.path.join(self.directory, "pinned.json")
        self._pinned: dict[str, int] = {}
        if os.path.exists(self._pin_path):
            try:
                with open(self._pin_path) as f:
                    self._pinned = {k: int(v)
                                    for k, v in json.load(f).items()}
            except (OSError, ValueError):
                self._pinned = {}

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    def all_epochs(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _FILE.match, os.listdir(self.directory)) if m)

    def save(self, epoch: int, state: Any,
             metric: Optional[float] = None,
             pin: Optional[str] = None) -> bool:
        """Save `state` at `epoch`; with save_best_only, skip unless
        `metric` improved. `pin` names a best-metric slot: this epoch
        replaces the slot's previous holder and is kept whatever `keep`
        says until a better epoch takes the slot. Returns whether it
        saved (a manager that does not write returns what one that
        writes would, and writes nothing)."""
        if self.save_best_only and metric is not None:
            if metric >= self._best:
                return False
            self._best = metric
        if not self.write:
            if pin is not None:
                self._pinned[pin] = epoch
            return True
        final = self.path(epoch)
        tmp = final + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, final)
        if pin is not None:
            self._pinned[pin] = epoch
            tmp = self._pin_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._pinned, f)
            os.replace(tmp, self._pin_path)
        self._prune()
        return True

    def pinned(self) -> dict[str, int]:
        """Current pin slots: {slot_name: epoch}."""
        return dict(self._pinned)

    def _prune(self) -> None:
        """Delete all but the newest `keep` epochs and the pinned ones."""
        if not self.keep:
            return
        epochs = self.all_epochs()
        keep = set(epochs[-self.keep:]) | set(self._pinned.values())
        for e in epochs:
            if e not in keep:
                os.remove(self.path(e))

    def restore(self, epoch: Optional[int] = None) -> tuple[Any, int]:
        """(state, epoch) of `epoch`, or of the latest when None; raises
        FileNotFoundError when there is none. Tensors come back on the
        CPU, memory-mapped from the file, so a caller that loads part of
        the state (a sampling-only trainer) reads only that part; a
        trainer's `load_state_dict` copies them onto its device."""
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(
                    f"no checkpoint found in {self.directory}")
        path = self.path(epoch)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint of epoch {epoch} in "
                                    f"{self.directory}")
        state = torch.load(path, map_location="cpu", weights_only=True,
                           mmap=True)
        return state, epoch

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open between calls."""

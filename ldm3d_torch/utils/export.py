"""Compact weight snapshots (.npz) in the JAX package's layout: the port
of `ldm3d.utils.export`.

A snapshot holds the sampling state of a `DiffusionTrainer` (the weights,
the EMA U-Net, and the quantizer's and BatchNorm's statistics) or of a
`VQTrainer` (the stage-1 weights, `vq_stats` and `batch_stats`), float16
(bool stays bool), plus a JSON `__meta__` blob; no optimizer state. Keys
are exactly the JAX package's: '/'-joined flax paths under their
collection, `params/unet/down_res_0_0/conv1/kernel`,
`ema_params/down_res_0_0/...`, `batch_stats/unet/...`,
`vq_stats/vqvae/quantizer/codebooks_used` (a stage-1:
`params/encoder/...`, `vq_stats/quantizer/...`; a VQ-GAN:
`params/{ae,disc3d,disc2d,lpips}/...`, `vq_stats/quantizer/...`), in the
flax layout (`convert.flax_state`). So a snapshot written here loads in the
JAX package's `load_state_npz`, and one written there loads here. Loading
is strict, as there: a missing, extra or reshaped array raises.

`load_stage1_npz` reads the snapshot of a stage-1 VQ-VAE (keys
`params/encoder/...`, `params/quantizer/codebook`, `params/decoder/...`,
its `vq_stats` and `batch_stats`) into a trainer's frozen VQ-VAE: the
port's `--vqvae_load_ckpt`.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ldm3d_torch.convert import convert_state, flax_state
from ldm3d_torch.parallel.tp import model_sharding

_COLLECTIONS = ("params", "ema_params", "vq_stats", "batch_stats")


def _arrays(module: nn.Module, prefix: str = "") -> Dict[str, np.ndarray]:
    """{collection/flax path: array} of a module's weights and buffers
    (a module with a `flax_state()` of its own, the VQ-GAN's networks,
    maps itself)."""
    tree = module.flax_state() if hasattr(module, "flax_state") \
        else flax_state(module, prefix)
    return {f"{coll}/{path}": arr for coll, t in tree.items()
            for path, arr in t.items()}


def state_arrays(trainer) -> Dict[str, np.ndarray]:
    """A trainer's sampling state (`trainer.snapshot_modules()`: the model
    and an EMA U-Net or None) in the snapshot layout, float32; whole
    arrays under tensor parallelism (a collective over the model group)."""
    model, ema = trainer.snapshot_modules()
    with torch.no_grad(), model_sharding(getattr(trainer, "mesh", None)):
        out = _arrays(model)
        if ema is not None:
            out.update({"ema_params/" + k.split("/", 1)[1]: a
                        for k, a in _arrays(ema).items()
                        if k.startswith("params/")})
    return out


def save_state_npz(path: str, trainer, meta: Optional[dict] = None,
                   dtype=np.float16) -> dict:
    """Write a trainer's sampling state to `path` (.npz), float arrays cast
    to `dtype`. Returns the metadata dict written."""
    arrays = {}
    for key, arr in state_arrays(trainer).items():
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(dtype)
        arrays[key] = arr
    meta = dict(meta or {})
    meta["collections"] = sorted({k.split("/", 1)[0] for k in arrays})
    meta["num_arrays"] = len(arrays)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return meta


def load_meta_npz(path: str) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"].tobytes()).decode())


def _match(path: str, template: Dict[str, np.ndarray]
           ) -> Dict[str, np.ndarray]:
    """The snapshot's arrays for every key of `template`, float32; strict
    per collection, as the JAX package's `load_state_npz`."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    out = {}
    for coll in _COLLECTIONS:
        keys = [k for k in template if k.startswith(coll + "/")]
        if not keys:
            extra = [k for k in arrays if k.startswith(coll + "/")]
            if extra:
                raise ValueError(
                    f"snapshot has {coll} ({len(extra)} arrays) but the "
                    f"trainer does not; rebuild it with the matching "
                    f"config (e.g. ema_decay > 0)")
            continue
        for key in keys:
            if key not in arrays:
                raise KeyError(f"snapshot missing {key}")
            arr = arrays.pop(key)
            if arr.shape != template[key].shape:
                raise ValueError(f"{key}: snapshot shape {arr.shape} != "
                                 f"template {template[key].shape}")
            out[key] = arr if arr.dtype == np.bool_ \
                else arr.astype(np.float32)
    stray = [k for k in arrays if k.split("/", 1)[0] in _COLLECTIONS]
    if stray:
        raise ValueError(f"snapshot has {len(stray)} arrays the trainer "
                         f"does not: {stray[:3]}...")
    return out


def load_state_npz(path: str, trainer):
    """Load a snapshot into `trainer` (weights, statistics, and the EMA
    U-Net when the snapshot has one); its optimizer, step and generator
    are left as they are (a snapshot is for sampling). Returns the
    trainer."""
    convert = getattr(trainer, "convert_snapshot", convert_state)
    trainer.load_state_dicts(*convert(_match(path, state_arrays(trainer))))
    return trainer


def load_stage1_npz(path: str, trainer) -> dict:
    """Load a stage-1 VQ-VAE snapshot into `trainer`'s frozen VQ-VAE
    (strict). Returns the snapshot's metadata."""
    arrays = _match(path, _arrays(trainer.model.vqvae))
    state, _ = convert_state({k.split("/", 1)[0] + "/vqvae/"
                              + k.split("/", 1)[1]: a
                              for k, a in arrays.items()})
    trainer.model.vqvae.load_state_dict(
        {k[len("vqvae."):]: v for k, v in state.items()}, strict=True)
    return load_meta_npz(path)

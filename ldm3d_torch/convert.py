"""Convert between the JAX package's parameters and the port's state dicts.

Input is the state of a `DiffusionTrainer` as numpy arrays: either a nested
dict of collections (`params`, `batch_stats`, `vq_stats`, `ema_params`) or
the flat '/'-joined keys that `ldm3d.utils.export.save_state_npz` writes
(`params/unet/down_res_0_0/conv1/kernel`, ...). This module imports no JAX.

The port names its modules after the flax tree, so a flax path maps to a
torch key by joining with '.', renaming the leaf, and changing the layout:
  - conv kernel (kd, kh, kw, in, out)            -> weight (out, in, kd, kh, kw)
  - transposed-conv kernel (kd, kh, kw, OUT, IN) -> weight (IN, OUT, kd, kh, kw)
    (the Keras layout of `conv3d_transpose`; PyTorch's conv_transpose3d
    weight, no flip: both are the adjoint of a cross-correlation)
    Both are the same axis permutation (4, 3, 0, 1, 2); a VALID
    transposed conv (the VQ-GAN's SamePadConvTranspose3D) too.
  - 2D conv kernel (kh, kw, in, out) -> weight (out, in, kh, kw): the
    VQ-GAN's frame critic and LPIPS.
  - Dense kernel (in, out) -> weight (out, in); the dense critic head
    flattens channels-last, as flax does, so its rows need no reordering.
  - norm scale -> weight (BatchNorm_0, GroupNorm_0 and LayerNorm_0 of a
    `Norm`, the cross-attention's LayerNorms); BatchNorm statistics mean /
    var -> running_mean / running_var; Embed embedding -> weight; PReLU
    alpha -> alpha.
  - the quantizers keep their names and layout: the parameters `codebook`
    [K, D] (ste, nsvq) and `codebooks` [S, K, D] (rnsvq), and the
    `vq_stats` collection, which is buffers here: `codebooks_used` ([K],
    or [S, K]), and the EMA kinds' `codebook`, `ema_cluster_size`,
    `ema_w` and `need_init` (bool).
Diffusion states (`vqvae/encoder/**`, the quantizer, the decoder, the
U-Net) and stage-1 states (`encoder/**`, `quantizer/**`, `decoder/**`)
are both mapped. A VQ-GAN state (`params/{ae,disc3d,disc2d,lpips}/**`,
`batch_stats/{ae,disc3d,disc2d}/**` and the autoencoder's `vq_stats`)
goes through `convert_gan_state` / `gan_flax_state`.

`flax_state` is the inverse map: a port module's parameters and buffers
as the flax collections, numpy, for comparing a port state with a JAX one.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


_VQ_STATS = ("codebooks_used", "codebook", "ema_cluster_size", "ema_w",
             "need_init")


def _leaf(path: str, arr: np.ndarray, stats: bool) -> Tuple[str, np.ndarray]:
    *mods, name = path.split("/")
    if stats:
        name = {"mean": "running_mean", "var": "running_var"}[name]
    elif name == "kernel":
        name = "weight"
        if arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"unexpected kernel rank at {path}: {arr.shape}")
    elif name in ("scale", "embedding"):
        name = "weight"
    elif name not in ("bias", "alpha", "codebooks") + _VQ_STATS:
        raise ValueError(f"unknown parameter {path}")
    return ".".join(mods + [name]), arr


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A C-contiguous float32 copy (bool stays bool: the EMA quantizer's
    `need_init`). A writable array (a snapshot's, or a transposed view of
    one) is cast and laid out by torch in one pass."""
    arr = np.asarray(arr)
    if not arr.flags.writeable:      # torch.from_numpy wants writable
        dtype = np.bool_ if arr.dtype == np.bool_ else np.float32
        return torch.from_numpy(np.array(arr, dtype=dtype, order="C"))
    src = torch.from_numpy(arr)
    dtype = torch.bool if src.dtype == torch.bool else torch.float32
    return torch.empty(src.shape, dtype=dtype).copy_(src)


def module_state(params: Mapping, batch_stats: Optional[Mapping] = None
                 ) -> Dict[str, torch.Tensor]:
    """The state dict of one module from its flax subtree, e.g. the
    `params` / `batch_stats` of a `CrossAttentionBlock` or a `Decoder`."""
    out = {}
    for coll, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, arr in flatten(tree or {}).items():
            name, arr = _leaf(path, arr, coll == "batch_stats")
            out[name] = _tensor(arr)
    return out


_COLLECTIONS = ("params", "batch_stats", "vq_stats", "ema_params")


def convert_state(state: Mapping) -> Tuple[Dict[str, torch.Tensor],
                                           Optional[Dict[str, torch.Tensor]]]:
    """Returns (model_state, ema_unet_state) for `LatentDiffusion` and, when
    the input has `ema_params`, for the EMA copy of its U-Net (which reads
    the same BatchNorm statistics)."""
    flat = flatten(state) if any(isinstance(v, Mapping)
                                 for v in state.values()) else dict(state)
    model: Dict[str, torch.Tensor] = {}
    ema: Dict[str, torch.Tensor] = {}
    unet_stats: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        coll, _, path = key.partition("/")
        if coll not in _COLLECTIONS:
            continue                  # metadata: not read here
        name, arr = _leaf(path, np.asarray(arr), coll == "batch_stats")
        if coll == "ema_params":
            ema[name] = _tensor(arr)
            continue
        model[name] = _tensor(arr)
        if coll == "batch_stats" and name.startswith("unet."):
            unet_stats[name[len("unet."):]] = model[name]
    if not ema:
        return model, None
    ema.update(unet_stats)
    return model, ema


def load_npz(path: str) -> Tuple[Dict[str, torch.Tensor],
                                 Optional[Dict[str, torch.Tensor]]]:
    """`convert_state` of a snapshot written by `save_state_npz`."""
    with np.load(path) as z:
        return convert_state({k: z[k] for k in z.files if k != "__meta__"})


def _flax_name(module: nn.Module, name: str, t: torch.Tensor
               ) -> Tuple[str, str, Optional[Tuple[int, ...]]]:
    """(collection, flax leaf name, the permutation to the flax layout or
    None) of one parameter or buffer."""
    if name == "running_mean":
        return "batch_stats", "mean", None
    if name == "running_var":
        return "batch_stats", "var", None
    if name in _VQ_STATS and name in module._buffers:
        return "vq_stats", name, None
    if name in ("bias", "alpha", "codebook", "codebooks"):
        return "params", name, None
    if name != "weight":
        raise ValueError(f"unknown parameter {name} of {type(module)}")
    if isinstance(module, nn.Embedding):
        return "params", "embedding", None
    perm = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}.get(t.dim())
    return "params", ("kernel" if perm else "scale"), perm   # scale: a norm's


def _flax_leaf(module: nn.Module, name: str, t: torch.Tensor,
               dtype: torch.dtype = torch.float32
               ) -> Tuple[str, str, np.ndarray]:
    """(collection, flax leaf name, array) of one parameter or buffer: a
    C-contiguous copy in the flax layout, floats in `dtype` (the layout
    and the cast done where the tensor lives, before it is copied out)."""
    coll, leaf, perm = _flax_name(module, name, t)
    t = t.detach() if t.dtype == torch.bool else t.detach().to(dtype)
    if perm is not None:
        t = t.permute(perm)
    arr = t.clone(memory_format=torch.contiguous_format).cpu().numpy()
    return coll, leaf, arr


def flax_state(module: nn.Module, prefix: str = "",
               dtype: torch.dtype = torch.float32
               ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of `convert_state` for one module: its parameters and
    buffers as {collection: {flax path: array}} in the flax layout, floats
    in `dtype`, paths '/'-joined under `prefix` (e.g. "unet"). For an EMA
    copy of the U-Net, take the "params" collection. A tensor-parallel
    module's shards are gathered whole (inside
    `parallel.tp.model_sharding`; a collective)."""
    from ldm3d_torch.parallel import tp
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for mod_name, mod in module.named_modules():
        items = [(n, tp.full(mod, n))
                 for n, _ in mod.named_parameters(recurse=False)] \
            + list(mod.named_buffers(recurse=False))
        for name, t in items:
            coll, leaf, arr = _flax_leaf(mod, name, t, dtype)
            path = "/".join(p for p in (prefix, *mod_name.split("."), leaf)
                            if p)
            out.setdefault(coll, {})[path] = arr
    return out


def convert_gan_state(state: Mapping) -> Dict[str, torch.Tensor]:
    """The state dict of a `gan_trainer.VQGANModules` from a JAX
    `GANTrainState`'s collections (nested or flat): its `vq_stats` are the
    autoencoder's, so they move under `ae`."""
    flat = flatten(state) if any(isinstance(v, Mapping)
                                 for v in state.values()) else dict(state)
    moved = {}
    for key, arr in flat.items():
        coll, _, path = key.partition("/")
        moved[f"vq_stats/ae/{path}" if coll == "vq_stats" else key] = arr
    return convert_state(moved)[0]


def gan_flax_state(modules: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of `convert_gan_state`: a `VQGANModules`' parameters and
    buffers as the JAX GAN state's collections, the autoencoder's
    `vq_stats` at the collection's root."""
    out = flax_state(modules)
    if "vq_stats" in out:
        out["vq_stats"] = {k[len("ae/"):]: a
                           for k, a in out["vq_stats"].items()}
    return out

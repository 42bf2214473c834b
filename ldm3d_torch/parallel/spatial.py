"""Spatial parallelism of the models: the port of `ldm3d.parallel.spatial`.

The depth axis of every volume activation is split over the mesh's
'space' axis: JAX's axis 3 of [B, H, W, D, C] (`SPATIAL_AXIS`), the port's
axis 4 of NCDHW (`DEPTH`). Where JAX pins each activation with a GSPMD
constraint and lets XLA exchange halos, the port computes each process's
slab explicitly: inside `spatial_sharding(mesh)` every layer of
`models.layers` takes and returns this process's depth slab and fetches
the rows it needs from its neighbours (`parallel.halo`), GroupNorm sums
its statistics over the space group, and BatchNorm and the quantizers
over the data x space processes. The state lives in this thread-local
context, as in JAX, never on the modules, so that copies of a model (the
EMA U-Net) are sharded as the model is.

The sharding rule (`shards`): a depth is split when it divides by the
space degree; `fits` adds that each slab must hold the halo of the op
that reads it (and divide by its stride). A level of a model whose depth
fails `shards` runs whole on every process of the space group inside
`whole()`, as GSPMD replicates it; an op whose slab fails `fits` gathers
its input, computes the whole output and keeps its slab. This is a rule
of the design: a failed exchange raises.

Inside `whole()` (the critics, LPIPS, SSIM, the model families JAX does
not shard) tensors are the whole volume, equal on every process of the
space group, and norms take the data group's statistics only.

The objective under spatial sharding: each process's loss is its slab's
mean (terms computed whole count whole on every process), the sum of
which over the space group is `space` times the global objective, and
the trainers average gradients and metrics over the data x space group
(`parallel.mesh.batch_group`); the gradients of the collectives
(`halo`, `gather_space`, the norms' sums) route each process's share to
the process that owns the rows.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

from ldm3d_torch.parallel.halo import gather_space, slice_space
from ldm3d_torch.parallel.mesh import BATCH, DATA_AXIS, SPACE_AXIS, Mesh

# The sharded axis of [B, H, W, D, C] volumes (the JAX package's, and the
# port's at model boundaries); `DEPTH` is the same axis of NCDHW.
SPATIAL_AXIS = 3
DEPTH = 4

_ctx = threading.local()


@contextmanager
def spatial_sharding(mesh: Optional[Mesh]):
    """Run model code inside as depth slabs over `mesh`'s 'space' axis. A
    None mesh or a space degree of 1 makes the whole context a no-op."""
    active = mesh is not None and mesh.shape.get(SPACE_AXIS, 1) > 1
    prev = (getattr(_ctx, "mesh", None), getattr(_ctx, "whole", False))
    _ctx.mesh, _ctx.whole = (mesh if active else None), False
    try:
        yield
    finally:
        _ctx.mesh, _ctx.whole = prev


def state() -> tuple:
    """The context's state, for `restoring` on another thread (the
    recomputation of a checkpointed unit in the backward pass)."""
    return getattr(_ctx, "mesh", None), getattr(_ctx, "whole", False)


@contextmanager
def restoring(saved: tuple):
    """Run the block under a `state()` taken elsewhere."""
    prev = state()
    _ctx.mesh, _ctx.whole = saved
    try:
        yield
    finally:
        _ctx.mesh, _ctx.whole = prev


def active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `spatial_sharding`, None outside one."""
    return getattr(_ctx, "mesh", None)


def with_spatial(mesh: Optional[Mesh], fn):
    """`fn` run inside `spatial_sharding(mesh)`: the trainers' hook at
    each step, as the JAX package's at its `jax.jit` sites."""
    def wrapped(*args, **kwargs):
        with spatial_sharding(mesh):
            return fn(*args, **kwargs)
    return wrapped


def sharded() -> Optional[Mesh]:
    """The mesh when layers take depth slabs: inside `spatial_sharding`
    and outside `whole()`; else None."""
    if getattr(_ctx, "whole", False):
        return None
    return active_mesh()


@contextmanager
def whole(on: bool = True):
    """With `on`, layers inside take whole tensors (equal on every
    process of the space group) until the block ends."""
    prev = getattr(_ctx, "whole", False)
    _ctx.whole = prev or on
    try:
        yield
    finally:
        _ctx.whole = prev


def space_size() -> int:
    mesh = sharded()
    return 1 if mesh is None else mesh.shape[SPACE_AXIS]


def shards(depth: int) -> bool:
    """Whether an activation of global depth `depth` is held as slabs:
    under `sharded()` and when the depth divides by the space degree."""
    n = space_size()
    return n > 1 and depth % n == 0


def fits(rows: int, left: int = 0, right: int = 0, stride: int = 1) -> bool:
    """Whether a slab of `rows` rows serves an op locally: it holds the
    op's halo and divides by its stride."""
    return rows >= max(left, right, 1) and rows % stride == 0


def stats_group(own):
    """The group of a norm's or quantizer's batch statistics: the mesh's
    data x space group over slabs, else `own` (the data group the module
    was attached to, or None)."""
    mesh = sharded()
    return own if mesh is None else mesh.group(BATCH)


def data_rows_group(own):
    """The data group (the rows of the global batch) under sharding,
    else `own`."""
    mesh = sharded()
    return own if mesh is None else mesh.group(DATA_AXIS)


def gather(x: torch.Tensor, axis: int = DEPTH) -> torch.Tensor:
    """The whole tensor of the slabs along `axis`; `x` as it is when not
    sharded."""
    mesh = sharded()
    return x if mesh is None else gather_space(x, axis, mesh)


def scatter(x: torch.Tensor, axis: int = DEPTH) -> torch.Tensor:
    """This process's slab of a whole `x` along `axis`; `x` as it is when
    not sharded."""
    mesh = sharded()
    return x if mesh is None else slice_space(x, axis, mesh)


def shard_spatial(x: torch.Tensor, axis: int = SPATIAL_AXIS
                  ) -> torch.Tensor:
    """This process's depth slab of a whole activation `x` ([B, ..., C],
    the depth at `axis`) when a `spatial_sharding` context is active and
    the depth splits (`shards`); `x` itself otherwise. The entry of whole
    tensors (a batch of latents, the sampler's state) into the sharded
    models."""
    if sharded() is None or x.dim() < 3 or not shards(x.shape[axis]):
        return x
    return scatter(x, axis)


def gather_volume(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The whole volumes [B, H, W, D, C] of this process's depth slabs
    under `mesh` (for a caller outside the trainers' steps, as the image
    loggers); `x` itself without a space axis."""
    with spatial_sharding(mesh):
        return gather(x, SPATIAL_AXIS)


def gathered(fn, *args, axis: int = DEPTH, out_axis: Optional[int] = None):
    """`fn(*args)` computed whole: the slabs of each tensor argument
    gathered along `axis`, `fn` run inside `whole()`, and this process's
    slab of its output (along `out_axis`, by default `axis`) kept. The
    gather rule of an op whose slab cannot serve it."""
    if sharded() is None:
        return fn(*args)
    args = [gather(a, axis) if isinstance(a, torch.Tensor) else a
            for a in args]
    with whole():
        out = fn(*args)
    return scatter(out, axis if out_axis is None else out_axis)

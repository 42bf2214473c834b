"""The process mesh: the port of `ldm3d.parallel.mesh`.

One process per device, laid out data-major as a (data, space, model)
mesh: process r sits at (r // (space * model), r // model % space,
r % model). Each axis has a process group per line of the mesh along it;
`Mesh.group(axis)` is this process's, None where the axis has size 1;
`Mesh.group(BATCH)` is the group of the processes that hold one global
batch between them (data x space), over which gradients, metrics and
BatchNorm / codebook statistics are reduced.

  - "data":  synchronous data parallelism. Each process holds its rows of
             every global batch (`shard_batch`, the loaders'
             `local_batch_rows`); the trainers all-reduce gradients,
             BatchNorm and codebook statistics and metrics over the data
             group, so that N processes compute what one process computes
             on the global batch.
  - "space": the depth axis of every volume (JAX's axis 3 of NDHWC, the
             port's axis 4 of NCDHW): each process holds a slab of it
             (`shard_batch(..., spatial_axis=3)`, `local_depth`), and the
             models exchange halo rows at conv edges under
             `parallel.spatial.spatial_sharding` (`parallel.halo`).
  - "model": tensor parallelism. The wide conv kernels and vectors of
             the trained networks are split over it (`parallel.tp`):
             each process of a model line holds its slices, the same
             rows and depth slab as the others, and the whole
             activations; gradients are reduced over `BATCH` alone.

`mesh_shape` holds the decisions of `make_mesh` as a pure function of
the device and process counts.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Tuple

import torch

from ldm3d_torch.core.config import MeshConfig

DATA_AXIS = "data"
SPACE_AXIS = "space"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SPACE_AXIS, MODEL_AXIS)
# the group of `Mesh.group` over the data and space axes together
BATCH = "batch"


def mesh_shape(cfg: Optional[MeshConfig], n: int,
               batch_size: Optional[int] = None,
               num_processes: int = 1) -> Tuple[int, int, int]:
    """(data, space, model) of a mesh over `n` devices held by
    `num_processes` processes. With `cfg.data == -1` (use everything) and
    a `batch_size`, the data axis is clamped to gcd(batch, available), so
    a fixed-batch preset trains on a valid submesh (a warning) in one
    process; across processes a submesh would leave whole processes out,
    which is an error. An explicit data axis must cover the devices."""
    space = 1 if cfg is None else max(cfg.space, 1)
    model = 1 if cfg is None else max(cfg.model, 1)
    if cfg is None or cfg.data == -1:
        data = n // (space * model)
        if batch_size is not None and data > 1 and batch_size % data != 0:
            data = math.gcd(batch_size, data)
    else:
        data = cfg.data
    used = data * space * model
    if used > n or used < 1:
        raise ValueError(
            f"mesh {data}x{space}x{model} does not fit on {n} devices")
    if (cfg is not None and cfg.data != -1) and used != n:
        raise ValueError(
            f"mesh {data}x{space}x{model} does not cover {n} devices")
    if used != n:
        if num_processes > 1:
            raise ValueError(
                f"global batch {batch_size} only supports a "
                f"{data}x{space}x{model} mesh, which would exclude "
                f"{n - used} of {n} devices (and possibly whole hosts) "
                f"in multi-process mode; use a batch divisible by "
                f"{n // (space * model)} or set mesh axes explicitly")
        warnings.warn(
            f"batch {batch_size} is not divisible by the {n} available "
            f"devices: training on a {data}x{space}x{model} submesh, "
            f"{n - used} devices idle", stacklevel=2)
    return data, space, model


@dataclasses.dataclass
class Mesh:
    """This process's place in the mesh and its process groups."""

    shape: Dict[str, int]
    rank: int = 0
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)
    device: Optional[torch.device] = None

    @property
    def world_size(self) -> int:
        return math.prod(self.shape.values())

    def _stride(self, axis: str) -> int:
        return math.prod(self.shape[a] for a in AXES[AXES.index(axis) + 1:])

    def coord(self, axis: str) -> int:
        """This process's index along `axis`."""
        return self.rank // self._stride(axis) % self.shape[axis]

    @property
    def data_index(self) -> int:
        return self.coord(DATA_AXIS)

    @property
    def space_index(self) -> int:
        return self.coord(SPACE_AXIS)

    def group(self, axis: str):
        """The process group of this process's line along `axis` (or, for
        `BATCH`, its plane over data and space); None where it holds one
        process (no collective)."""
        return self.groups.get(axis)

    def neighbour(self, axis: str, step: int) -> Optional[int]:
        """The global rank `step` places along `axis`, None off the edge."""
        i = self.coord(axis) + step
        if not 0 <= i < self.shape[axis]:
            return None
        return self.rank + step * self._stride(axis)


def make_mesh(cfg: Optional[MeshConfig] = None,
              world_size: Optional[int] = None,
              batch_size: Optional[int] = None) -> Mesh:
    """The mesh over the run's processes (`mesh_shape` over
    `world_size`, by default the process group's size, 1 without one),
    with a process group per line of each axis longer than 1. Every
    process must call it, in the same order as the others."""
    from ldm3d_torch.parallel import distributed as pd

    actual = pd.process_count()
    n = actual if world_size is None else int(world_size)
    if n != actual:
        raise ValueError(f"a mesh over {n} processes in a run of {actual}")
    shape = dict(zip(AXES, mesh_shape(cfg, n, batch_size,
                                      num_processes=actual)))
    mesh = Mesh(shape, rank=pd.process_index(), device=pd.process_device())
    if n == 1:
        return mesh
    import torch.distributed as dist

    backend = pd.collective_backend()
    for axis in AXES:
        if shape[axis] == 1:
            continue
        # every process creates every group, in one order
        for ranks in _lines(shape, (axis,)):
            g = dist.new_group(ranks, backend=backend)
            if mesh.rank in ranks:
                mesh.groups[axis] = g
    if shape[DATA_AXIS] == 1 or shape[SPACE_AXIS] == 1:
        # the plane is a line: its group is the data or the space group
        if DATA_AXIS in mesh.groups or SPACE_AXIS in mesh.groups:
            mesh.groups[BATCH] = mesh.groups.get(
                DATA_AXIS, mesh.groups.get(SPACE_AXIS))
    else:
        for ranks in _lines(shape, (DATA_AXIS, SPACE_AXIS)):
            g = dist.new_group(ranks, backend=backend)
            if mesh.rank in ranks:
                mesh.groups[BATCH] = g
    return mesh


def _lines(shape: Dict[str, int], axes) -> list:
    """The ranks of each line (plane) of the mesh along `axes`, in rank
    order, the lines in the order of their first rank."""
    lines: Dict[tuple, list] = {}
    for r in range(math.prod(shape.values())):
        probe = Mesh(shape, rank=r)
        key = tuple(probe.coord(a) for a in AXES if a not in axes)
        lines.setdefault(key, []).append(r)
    return list(lines.values())


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel size {n}")
    return global_batch // n


def local_depth(mesh: Optional[Mesh], depth: int) -> Optional[range]:
    """This process's slab of a depth axis of length `depth` split over
    the mesh's 'space' axis; None without one. Raises when the depth does
    not split, as JAX's `device_put` of a depth-sharded batch does."""
    if mesh is None or mesh.shape[SPACE_AXIS] == 1:
        return None
    n = mesh.shape[SPACE_AXIS]
    if depth % n:
        raise ValueError(f"depth {depth} not divisible by the mesh's "
                         f"space axis ({n})")
    rows = depth // n
    return range(mesh.space_index * rows, (mesh.space_index + 1) * rows)


def shard_batch(mesh: Optional[Mesh], batch,
                spatial_axis: Optional[int] = None):
    """This process's rows of a global batch: a tensor, or a tuple, list
    or dict of them (None passes through); the whole batch in one
    process. With `spatial_axis` (3, the depth of NDHWC volumes), tensors
    of 5 or more dims keep only this process's depth slab
    (`local_depth`). The counterpart of `device_put` with
    `batch_sharding(mesh, spatial_axis)`."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b, spatial_axis)
                           for b in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, spatial_axis)
                for k, v in batch.items()}
    if batch is None or mesh is None or mesh.world_size == 1:
        return batch
    from ldm3d_torch.parallel.distributed import local_batch_rows
    rows = local_batch_rows(mesh, batch.shape[0])
    batch = batch[rows.start:rows.stop]
    if spatial_axis is not None and batch.dim() >= 5:
        slab = local_depth(mesh, batch.shape[spatial_axis])
        if slab is not None:
            batch = batch.narrow(spatial_axis, slab.start, len(slab))
    return batch


def data_group(mesh: Optional[Mesh]):
    """The data-parallel group of `mesh`, None in one process."""
    return None if mesh is None else mesh.group(DATA_AXIS)


def batch_group(mesh: Optional[Mesh]):
    """The group of the processes that hold one global batch between them
    (data x space): gradients and metrics are reduced over it. None in
    one process."""
    return None if mesh is None else mesh.group(BATCH)


def data_shard(mesh: Optional[Mesh]) -> Optional[Tuple[int, int]]:
    """(index, count) along 'data' for per-row random draws
    (`models.quantizers.Draws`), None without data parallelism."""
    if mesh is None or mesh.shape[DATA_AXIS] == 1:
        return None
    return mesh.data_index, mesh.shape[DATA_AXIS]


def attach_data_group(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Point every BatchNorm and quantizer of `module` at the mesh's data
    group, so that their training statistics are those of the global
    batch (None: local). Under spatial sharding they take the
    data x space group from `parallel.spatial` instead, where they see
    depth slabs."""
    from ldm3d_torch.models.layers import _BatchNorm
    from ldm3d_torch.models.quantizers import Quantizer
    group = data_group(mesh)
    for m in module.modules():
        if isinstance(m, (_BatchNorm, Quantizer)):
            m.group = group

"""Multi-process training: the port of `ldm3d.parallel.distributed`.

`initialize` joins this process to the others of a run through
`torch.distributed`; `parallel.mesh.make_mesh` then lays the processes
out as a (data, space, model) mesh, and each loader reads only this
process's rows of every global batch (`local_batch_rows`). There is one
process per device: process i drives `cuda:(i % torch.cuda.device_count())`
on the card, the CPU with --platform cpu.

Environment variables (or the matching CLI flags):
  LDM3D_COORDINATOR   host:port of process 0
  LDM3D_NUM_PROCESSES total process count
  LDM3D_PROCESS_ID    this process's rank

The default process group is always gloo: barriers and the exchange of
host objects go through it. The mesh's collectives (gradients, BatchNorm
and codebook statistics) use `collective_backend()`: NCCL when the
processes run on the card and no two of them share one, gloo otherwise
(on the CPU, and where processes share one card: gloo all-reduces CUDA
tensors through the host, and the tensors stay on the card).

The collectives below move tensors with `all_reduce` only, the one
collective gloo offers for CUDA tensors as well as CPU ones; gathers are
all-reduces of zero-padded buffers, which are exact.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

# set once by `initialize`: the collective backend and this process's device
_RUN: dict = {}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               platform: Optional[str] = None) -> bool:
    """Join the run's process group from the arguments or the LDM3D_*
    variables. Returns True when a multi-process run was initialized,
    False without a coordinator (one process). `platform` "cpu" keeps the
    process on the CPU; otherwise it takes the card `process_device`
    names. Must run before this process touches a device."""
    coordinator_address = (coordinator_address
                           or os.environ.get("LDM3D_COORDINATOR"))
    if coordinator_address is None:
        return False
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("LDM3D_NUM_PROCESSES", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("LDM3D_PROCESS_ID", "0"))
    if num_processes <= 1:
        # a coordinator with a 1-process spec is a misconfigured launch;
        # running on would train N independent copies that clobber each
        # other's checkpoints
        raise ValueError(
            f"coordinator {coordinator_address} configured but "
            f"num_processes={num_processes}; pass --num_processes/"
            f"LDM3D_NUM_PROCESSES >= 2 (and a unique process_id per host)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in "
                         f"[0, {num_processes})")
    device = torch.device("cpu")
    if platform != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ldm3d_torch: no CUDA device is visible; pass --platform "
                "cpu to run the processes on the CPU")
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=30))
    backend = "gloo"
    if device.type == "cuda":
        where = [None] * num_processes
        dist.all_gather_object(where, (socket.gethostname(), device.index))
        if len(set(where)) == num_processes:
            backend = "nccl"
    _RUN.update(backend=backend, device=device)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """Whether this process writes the run's files (process 0)."""
    return process_index() == 0


def collective_backend() -> str:
    """The backend of the mesh's groups (see the module docstring)."""
    return _RUN.get("backend", "gloo")


def process_device() -> Optional[torch.device]:
    """The device `initialize` chose, or None in one process."""
    return _RUN.get("device")


def barrier() -> None:
    """Wait for every process; nothing in one process."""
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (end of a multi-process command)."""
    if is_initialized():
        dist.destroy_process_group()
    _RUN.clear()


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a coordinator of local
    processes."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def local_batch_rows(mesh, global_batch: int) -> Optional[range]:
    """This process's rows of a global batch under `mesh` (batch over
    'data'); None in one process, where the caller reads everything.
    The mesh is data-major with one device per process, so the rows are
    the data index's contiguous block (the JAX package's check for
    non-contiguous rows has nothing to find). Raises when the batch does
    not split over the data axis."""
    if mesh is None or mesh.world_size == 1:
        return None
    from ldm3d_torch.parallel.mesh import local_batch_size
    n = local_batch_size(mesh, global_batch)
    return range(mesh.data_index * n, (mesh.data_index + 1) * n)


# ---------------------------------------------------------------------------
# Collectives (autograd-aware where gradients cross processes)
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient is the sum of the group's
    gradients, so that averaging the parameters' gradients afterwards
    gives the gradient of the global objective."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over `group`, differentiable."""
    return _AllReduceSum.apply(x.contiguous(), group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's `x`s (equal shapes) stacked along dim 0 in rank order,
    differentiable (each rank's gradient is the sum of the group's
    gradients of its rows)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    rows = x.shape[0]
    pad = [x.new_zeros((i * rows,) + x.shape[1:]), x,
           x.new_zeros(((n - 1 - i) * rows,) + x.shape[1:])]
    return all_reduce_sum(torch.cat(pad), group)


def reduce_gradients(params, group, average: bool = True,
                     bucket_bytes: int = 256 << 20) -> None:
    """All-reduce the `.grad` of every parameter over `group` in flat
    buckets of about `bucket_bytes`; divided by the group's size with
    `average` (gradients of local means), summed without it (gradients of
    terms that already divide by the global batch)."""
    grads = [p.grad for p in params if p.grad is not None]
    n = dist.get_world_size(group)
    bucket, size = [], 0
    for g in grads + [None]:
        if g is not None:
            bucket.append(g)
            size += g.numel() * g.element_size()
        if bucket and (g is None or size >= bucket_bytes):
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            if average:
                flat /= n
            offset = 0
            for b in bucket:
                b.copy_(flat[offset:offset + b.numel()].view_as(b))
                offset += b.numel()
            bucket, size = [], 0


def reduce_metrics(metrics: dict, group, keep=(), sums=()) -> dict:
    """Global values of a step's 0-dim metrics, in one all-reduce: the
    mean over the group, the sum for keys in `sums`, and keys in `keep`
    (already global, equal on every rank) as they are."""
    keys = [k for k in metrics if k not in keep]
    if not keys:
        return dict(metrics)
    n = dist.get_world_size(group)
    vals = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys])
    dist.all_reduce(vals, group=group)
    out = dict(metrics)
    for j, k in enumerate(keys):
        out[k] = vals[j] if k in sums else vals[j] / n
    return out

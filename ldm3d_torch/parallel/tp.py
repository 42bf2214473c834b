"""Tensor parallelism of the models: the port of `ldm3d.parallel.tp`.

JAX declares it: `tp_state_shardings` places each parameter leaf of the
trainers' states (and its Adam moments) by `_leaf_rule`, a 5-D kernel
split on its last dim over the mesh's 'model' axis when that dim is at
least `min_features` (64) and divides by the degree, a 1-D vector of such
a width split too, everything else replicated; GSPMD then inserts the
collectives. The port applies the same rule to each parameter read in
JAX's layout (`tp_plan`) and computes with the shards explicitly:

  - `layers.Conv3d` (weight [O, I, k, k, k], JAX's (k, k, k, I, O)):
    split on its output channels, dim 0. The layer convolves its input
    into its slab of output channels and gathers the slabs along C.
  - `layers.ConvTranspose3d` (weight [IN, OUT, k, k, k], JAX's
    (k, k, k, OUT, IN), flax's `transpose_kernel` layout): JAX's last dim
    is the layer's *input* channels, dim 0 again. The layer convolves its
    slice of the input's channels into a partial sum of the whole output
    and sums the partials over the model group.
  - 1-D parameters (biases, norm scales and offsets, PReLU slopes, the
    dense layers' biases): split on dim 0 and gathered where they are
    used. 2-D dense kernels, 4-D 2-D-conv kernels, codebooks, embeddings
    and buffers stay whole on every process.

Activations are whole on every process of the model group: each sharded
op gathers (or sums) right after it, so norms, activations and attention
see whole channels, and everything between two sharded ops runs the same
on every process of the group. The collectives' gradients follow from
that: a gather's gradient keeps this process's slab (every process holds
the whole gradient of what it gathered), a sum of partials passes its
gradient through, and an input read by a sharded op sums its gradient
over the group (each process's op saw all of it). No gradient is reduced
over the model group afterwards: the trainers reduce over the data x
space processes of their model coordinate alone (`mesh.batch_group`).

`shard_module` replaces each planned parameter by this process's slice
of it and records the split on the module that owns it (`_tp`), so that
a copy of the module (the EMA U-Net) is sharded as it is; the mesh comes
from the thread-local context `model_sharding(mesh)` that the trainers
enter around their steps, as `parallel.spatial.spatial_sharding`.
`whole_state` / `sliced_state` and their optimizer counterparts move a
state dict between its shards and the whole tensors one process holds,
so that a tensor-parallel checkpoint has one process's keys and shapes.

Frozen trees (the diffusion trainer's VQ-VAE, LPIPS) stay whole on every
process: JAX places them by the same rule because they sit in its
`params`, but they have no optimizer state, so only memory differs.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ldm3d_torch.parallel.mesh import MODEL_AXIS, Mesh

MIN_FEATURES = 64

_ctx = threading.local()


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------


def _leaf_rule(ndim: int, width: int, size: int, min_features: int
               ) -> Optional[int]:
    """JAX's `_leaf_rule` on a port parameter of `ndim` dims whose dim 0
    is JAX's split dim (a conv kernel's last dim, a vector's only one):
    0 when it splits over `size` processes, else None."""
    if size == 1 or ndim not in (1, 5):
        return None
    return 0 if width >= min_features and width % size == 0 else None


def tp_plan(module: nn.Module, size: int,
            min_features: int = MIN_FEATURES) -> Dict[str, Optional[int]]:
    """{parameter name: the dim of the port's tensor split over a 'model'
    axis of `size`, or None (whole)} for a module with whole parameters.
    The port's 5-D parameters are conv and transposed-conv kernels, whose
    dim 0 is the last dim of JAX's layout (see the module docstring);
    4-D and 2-D kernels are whole, as in JAX."""
    return {name: _leaf_rule(p.dim(), p.shape[0] if p.dim() else 1, size,
                             min_features)
            for name, p in module.named_parameters()}


def split_dim(module: nn.Module, name: str) -> Optional[int]:
    """The dim along which `module`'s parameter `name` is sharded, None
    when it is whole."""
    return module.__dict__.get("_tp", {}).get(name)


def _owned(module: nn.Module):
    """(qualified name, owning module, local name, parameter) of every
    parameter of `module`."""
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            yield (f"{mname}.{pname}" if mname else pname), m, pname, p


def sharded_names(module: nn.Module) -> Dict[str, int]:
    """{qualified parameter name: split dim} of a sharded module."""
    return {q: split_dim(m, n) for q, m, n, _ in _owned(module)
            if split_dim(m, n) is not None}


def param_dims(module: nn.Module) -> Dict[int, int]:
    """{id(parameter): split dim} of a sharded module's parameters (an
    optimizer's state is keyed by its parameters)."""
    return {id(p): split_dim(m, n) for _, m, n, p in _owned(module)
            if split_dim(m, n) is not None}


def _model(mesh: Mesh):
    """(index, count, group) of `mesh`'s model axis."""
    return (mesh.coord(MODEL_AXIS), mesh.shape[MODEL_AXIS],
            mesh.group(MODEL_AXIS))


def _slice(t: torch.Tensor, dim: int, index: int, count: int
           ) -> torch.Tensor:
    n = t.shape[dim] // count
    return t.narrow(dim, index * n, n)


@torch.no_grad()
def shard_module(module: nn.Module, mesh: Optional[Mesh],
                 min_features: int = MIN_FEATURES) -> nn.Module:
    """Replace every parameter that `tp_plan` splits by this process's
    slice of it (the same Parameter object, so an optimizer built before
    keeps it), in place; nothing without a 'model' axis or on a module
    that is sharded already. Returns `module`."""
    if mesh is None or mesh.shape[MODEL_AXIS] == 1 or sharded_names(module):
        return module
    plan = tp_plan(module, mesh.shape[MODEL_AXIS], min_features)
    _reshard(module, {q: d for q, d in plan.items() if d is not None}, mesh)
    return module


@torch.no_grad()
def unshard_module(module: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """The inverse of `shard_module`: every sharded parameter gathered
    whole over the model group (a collective: every process of the group
    calls it), in place. Returns `module`."""
    for _, m, n, p in list(_owned(module)):
        dim = split_dim(m, n)
        if dim is not None:
            p.data = gather_tensor(p.data, dim, mesh)
            m._tp = {k: v for k, v in m._tp.items() if k != n}
    return module


# ---------------------------------------------------------------------------
# The context
# ---------------------------------------------------------------------------


@contextmanager
def model_sharding(mesh: Optional[Mesh]):
    """Run model code inside with the sharded parameters of `mesh`'s model
    axis (the layers' collectives run over its model group). A None mesh
    or a model degree of 1 makes the context a no-op."""
    prev = state()
    _ctx.mesh = mesh if mesh is not None and \
        mesh.shape.get(MODEL_AXIS, 1) > 1 else None
    try:
        yield
    finally:
        _ctx.mesh = prev


def state() -> Optional[Mesh]:
    """The context's mesh, for `restoring` on another thread (the
    recomputation of a checkpointed unit in the backward pass)."""
    return getattr(_ctx, "mesh", None)


@contextmanager
def restoring(saved: Optional[Mesh]):
    """Run the block under a `state()` taken elsewhere."""
    prev = state()
    _ctx.mesh = saved
    try:
        yield
    finally:
        _ctx.mesh = prev


def _active() -> Mesh:
    mesh = state()
    if mesh is None:
        raise RuntimeError("a tensor-parallel module runs only inside "
                           "parallel.tp.model_sharding(mesh)")
    return mesh


# ---------------------------------------------------------------------------
# The collectives: each one's gradient is its conjugate's forward, so that
# second-order gradients (R1) go through them too
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, dim: int, index: int, count: int, group
            ) -> torch.Tensor:
    """The group's slabs of `x` along `dim`, in rank order: one all-reduce
    of a zero-padded buffer (exact)."""
    shape = list(x.shape)
    shape[dim] *= count
    out = x.new_zeros(shape)
    _slice(out, dim, index, count).copy_(x)
    dist.all_reduce(out, group=group)
    return out


class _Gather(torch.autograd.Function):
    """Forward: the slabs gathered along `dim`; backward: this process's
    slab of the (whole, equal on every process) gradient."""

    @staticmethod
    def forward(ctx, x, dim, model):
        ctx.dim, ctx.model = dim, model
        return _gather(x, dim, *model)

    @staticmethod
    def backward(ctx, grad):
        return _Slice.apply(grad, ctx.dim, ctx.model), None, None


class _Slice(torch.autograd.Function):
    """Forward: this process's slab along `dim` of a whole tensor;
    backward: the slabs' gradients gathered (the whole gradient on every
    process)."""

    @staticmethod
    def forward(ctx, x, dim, model):
        ctx.dim, ctx.model = dim, model
        return _slice(x, dim, model[0], model[1]).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad.contiguous(), ctx.dim, ctx.model), \
            None, None


class _Sum(torch.autograd.Function):
    """Forward: the sum of the group's partial results; backward: the
    gradient as it is (every process holds the whole of it)."""

    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        out = x.detach().clone()
        dist.all_reduce(out, group=model[2])
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Copy.apply(grad, ctx.model), None


class _Copy(torch.autograd.Function):
    """Forward: the (whole, equal on every process) input as it is, read
    by a sharded op; backward: the sum of the group's gradients, each of
    which covers this process's share of the op."""

    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _Sum.apply(grad.contiguous(), ctx.model), None


def gather_tensor(t: torch.Tensor, dim: int, mesh: Optional[Mesh] = None
                  ) -> torch.Tensor:
    """The whole tensor of the model group's slabs of `t` along `dim`
    (under `mesh`, else the context's), differentiable."""
    return _Gather.apply(t.contiguous(), dim, _model(mesh or _active()))


def full(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """`module`'s parameter `name` whole: gathered over the model group
    where it is sharded, itself otherwise (or None)."""
    t = getattr(module, name)
    dim = None if t is None else split_dim(module, name)
    return t if dim is None else gather_tensor(t, dim)


def column(x: torch.Tensor) -> torch.Tensor:
    """The input of an op whose weight is split on its outputs: `x` as it
    is, its gradient summed over the model group."""
    return _Copy.apply(x, _model(_active()))


def gather_channels(y: torch.Tensor) -> torch.Tensor:
    """The whole channels (dim 1) of this process's slab `y`."""
    return gather_tensor(y, 1)


def input_slice(x: torch.Tensor) -> torch.Tensor:
    """This process's slice of the channels (dim 1) of a whole `x`, the
    input of an op whose weight is split on its inputs."""
    return _Slice.apply(x, 1, _model(_active()))


def sum_partials(y: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of each process's partial `y`. A
    partial below float32 (a bfloat16 activation) is summed in float32
    and rounded once: one process rounds the whole contraction once, and
    a bfloat16 sum would round again at every addition and drop the
    smaller partial's low bits."""
    if y.dtype.itemsize >= 4:
        return _Sum.apply(y.contiguous(), _model(_active()))
    return _Sum.apply(y.float().contiguous(), _model(_active())).to(y.dtype)


# ---------------------------------------------------------------------------
# State dicts: whole tensors in, whole tensors out
# ---------------------------------------------------------------------------


def whole_state(module: nn.Module, state: Dict[str, torch.Tensor],
                mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """`module.state_dict()`'s output with every sharded parameter
    gathered whole over `mesh`'s model group (a collective), so that it
    has one process's keys and shapes; `state` itself when nothing is
    sharded."""
    names = sharded_names(module)
    if not names:
        return state
    with torch.no_grad():
        return {k: gather_tensor(v, names[k], mesh) if k in names else v
                for k, v in state.items()}


def sliced_state(module: nn.Module, state: Dict[str, torch.Tensor],
                 mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """A whole state dict (one process's) cut to this process's shards of
    `module`'s sharded parameters, for `module.load_state_dict`."""
    names = sharded_names(module)
    if not names:
        return state
    index, count, _ = _model(mesh)
    return {k: _slice(v, names[k], index, count) if k in names else v
            for k, v in state.items()}


def _optimizer_params(optimizer: torch.optim.Optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def _map_moments(optimizer, state: dict, dims: Dict[int, int], fn) -> dict:
    """`optimizer.state_dict()`-shaped `state` with `fn(tensor, dim)` on
    each tensor of a sharded parameter's state (Adam's moments; not its
    0-dim step count)."""
    if not dims:
        return state
    params = _optimizer_params(optimizer)
    out = dict(state, state={})
    for i, s in state["state"].items():
        dim = dims.get(id(params[int(i)]))
        out["state"][i] = s if dim is None else {
            k: fn(v, dim) if torch.is_tensor(v) and v.dim() else v
            for k, v in s.items()}
    return out


def whole_optimizer_state(optimizer: torch.optim.Optimizer, state: dict,
                          dims: Dict[int, int], mesh: Optional[Mesh]
                          ) -> dict:
    """`optimizer.state_dict()`'s output with the moments of the sharded
    parameters (`param_dims` of the model) gathered whole (a
    collective)."""
    with torch.no_grad():
        return _map_moments(optimizer, state, dims,
                            lambda v, d: gather_tensor(v, d, mesh))


def sliced_optimizer_state(optimizer: torch.optim.Optimizer, state: dict,
                           dims: Dict[int, int], mesh: Optional[Mesh]
                           ) -> dict:
    """A whole optimizer state (one process's) cut to this process's
    shards, for `optimizer.load_state_dict`."""
    if not dims:
        return state
    index, count, _ = _model(mesh)
    return _map_moments(optimizer, state, dims,
                        lambda v, d: _slice(v, d, index, count).clone())


# ---------------------------------------------------------------------------
# The trainers' hooks
# ---------------------------------------------------------------------------


@torch.no_grad()
def _reshard(module: nn.Module, names: Dict[str, int], mesh: Mesh) -> None:
    """Cut the whole parameters `names` ({qualified name: dim}) of
    `module` to this process's slices, recording each split."""
    index, count, _ = _model(mesh)
    for q, m, n, p in _owned(module):
        if q in names:
            p.data = _slice(p.data, names[q], index, count).clone()
            m._tp = {**m.__dict__.get("_tp", {}), n: names[q]}


@contextmanager
def whole_parameters(module: nn.Module, mesh: Optional[Mesh]):
    """`module`'s sharded parameters whole inside the block (gathered: a
    collective), cut again to this process's slices after it, what the
    block wrote into them included (a seeded init of the whole model)."""
    names = sharded_names(module)
    if not names:
        yield
        return
    unshard_module(module, mesh)
    try:
        yield
    finally:
        _reshard(module, names, mesh)


@contextmanager
def mesh_sharding(mesh: Optional[Mesh]):
    """`spatial.spatial_sharding` and `model_sharding` of `mesh` together:
    the context of the trainers' steps."""
    from ldm3d_torch.parallel.spatial import spatial_sharding
    with spatial_sharding(mesh), model_sharding(mesh):
        yield

"""Halo exchange of a spatially sharded volume: the port of
`ldm3d.parallel.halo`, and the collectives that spatial sharding of the
models is built on (`parallel.spatial`).

One spatial axis of a volume is split over the mesh's 'space' axis: each
process holds a slab of equal length. Before a TF-'same' conv of kernel k
and stride s (the local length divisible by s), each process fetches
`left` rows from its left neighbour and `right` rows from its right one,

  pad_total = max(k - s, 0); left = pad_total // 2; right = pad_total - left

(zeros at the two ends of the axis, which is TF-'same' zero padding; the
edge-inclusive mirror at the ends for a SYMMETRIC pad), and a VALID conv
along the sharded axis of the padded slab gives its exact output slab.
A TF-'same' transposed conv needs `transposed_halo` rows instead.

The exchange is one all-reduce over the space group, the one collective
gloo offers for CUDA tensors as well as CPU ones: each process writes its
first `right` and last `left` rows into its slot of a zero-filled buffer
and takes its halos from its neighbours' slots. The backward pass sends
each halo's gradient back to the process that owns those rows the same
way. `gather_space` / `slice_space` move a tensor between its slabs and
the whole of it, differentiably.

Each of these all-reduces adds zeros to the rows one process wrote, so
it is exact in any dtype: a bfloat16 activation is exchanged and
gathered as it is. The one rounding that one process would not make is
the halo gradient's addition to its owner's rows, in the gradient's type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ldm3d_torch.parallel.distributed import all_reduce_sum
from ldm3d_torch.parallel.mesh import SPACE_AXIS, Mesh


def _halo_widths(kernel: int, stride: int) -> Tuple[int, int]:
    pad_total = max(kernel - stride, 0)
    left = pad_total // 2
    return left, pad_total - left


def transposed_halo(kernel: int, stride: int) -> Tuple[int, int, int]:
    """(left, right, start) of a TF-'same' transposed conv of a slab: the
    input rows it needs from each neighbour, and where its output slab
    (stride x the slab's length) starts in the full transposed output of
    the padded slab. Output row o reads the full output's row
    o + (k - s) // 2 = s * i + j (tap j < k) of input rows i."""
    before = max(kernel - stride, 0) // 2
    left = (kernel - 1 - before) // stride
    right = (before + stride - 1) // stride
    return left, right, stride * left + before


def _edges(x: torch.Tensor, left: int, right: int, dim: int) -> torch.Tensor:
    """A process's slot of the exchange: its first `right` rows, then its
    last `left` rows."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, right), x.narrow(dim, n - left, left)],
                     dim)


def _exchange(x, left, right, dim, reflect, index, count, group):
    """(left halo, right halo) of the slab `x`: the left neighbour's last
    `left` rows and the right neighbour's first `right` rows, one
    all-reduce over the space group; at the ends zeros, or with `reflect`
    the slab's own rows mirrored."""
    n = x.shape[dim]
    slot = _edges(x, left, right, dim)
    buf = x.new_zeros((count,) + slot.shape)
    buf[index] = slot
    if count > 1:
        dist.all_reduce(buf, group=group)

    def end(rows, start):
        part = x.narrow(dim, start, rows)
        return part.flip(dim) if reflect else torch.zeros_like(part)
    lo = buf[index - 1].narrow(dim, right, left) if index > 0 \
        else end(left, 0)
    hi = buf[index + 1].narrow(dim, 0, right) if index < count - 1 \
        else end(right, n - right)
    return lo, hi


def _return_halo_grads(g, g_lo, g_hi, left, right, dim, reflect, index,
                       count, group) -> None:
    """Add the gradients of the halos this process took (`g_lo`, `g_hi`)
    to the rows they came from: its neighbours' (one all-reduce over the
    space group, received into `g`, the slab's gradient, in place) or,
    mirrored at the ends, its own."""
    n = g.shape[dim]
    slot = list(g.shape)
    slot[dim] = left + right
    buf = g.new_zeros([count] + slot)
    if index > 0:
        buf[index - 1].narrow(dim, right, left).copy_(g_lo)
    if index < count - 1:
        buf[index + 1].narrow(dim, 0, right).copy_(g_hi)
    if count > 1:
        dist.all_reduce(buf, group=group)
    mine = buf[index]
    g.narrow(dim, 0, right).add_(mine.narrow(dim, 0, right))
    g.narrow(dim, n - left, left).add_(mine.narrow(dim, right, left))
    if reflect and index == 0:
        g.narrow(dim, 0, left).add_(g_lo.flip(dim))
    if reflect and index == count - 1:
        g.narrow(dim, n - right, right).add_(g_hi.flip(dim))


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, dim, reflect, index, count, group):
        ctx.meta = (left, right, dim, reflect, index, count, group)
        lo, hi = _exchange(x, left, right, dim, reflect, index, count,
                           group)
        return torch.cat([lo, x, hi], dim)

    @staticmethod
    def backward(ctx, grad):
        left, right, dim = ctx.meta[:3]
        n = grad.shape[dim] - left - right
        g = grad.narrow(dim, left, n).clone()
        _return_halo_grads(g, grad.narrow(dim, 0, left),
                           grad.narrow(dim, left + n, right), *ctx.meta)
        return g, None, None, None, None, None, None, None


def _space(mesh: Mesh) -> tuple:
    return mesh.space_index, mesh.shape[SPACE_AXIS], mesh.group(SPACE_AXIS)


def _check_widths(n: int, left: int, right: int) -> None:
    if left > n or right > n:
        raise ValueError(f"halo ({left}, {right}) wider than the slab "
                         f"({n} rows)")


def halo_exchange(x_local: torch.Tensor, left: int, right: int, axis: int,
                  mesh: Mesh, reflect: bool = False) -> torch.Tensor:
    """`x_local` padded along `axis` with `left` / `right` rows fetched
    from the mesh's space neighbours; at the two ends of the axis zeros,
    or with `reflect` the edge-inclusive mirror of the slab's own rows (a
    SYMMETRIC pad). Differentiable. Every process of the space group must
    call it with the same widths."""
    _check_widths(x_local.shape[axis], left, right)
    if not left and not right:
        return x_local
    axis = axis % x_local.dim()
    return _HaloExchange.apply(x_local.contiguous(), left, right, axis,
                               reflect, *_space(mesh))


class _HaloConv(torch.autograd.Function):
    """A convolution of an NCDHW depth slab with its halo rows attached
    (one exchange), which keeps only the slab, the halos and the weight
    for the backward pass: the padded slab, an activation's size, is
    built again there instead of being held (a conv of the whole volume
    holds its input only)."""

    @staticmethod
    def forward(ctx, x, weight, bias, halo, conv):
        left, right, space = halo
        lo, hi = _exchange(x, left, right, 4, False, *space)
        ctx.save_for_backward(x, weight, lo, hi)
        ctx.halo, ctx.conv = halo, conv
        ctx.has_bias = bias is not None
        return _conv_padded(torch.cat([lo, x, hi], 4), weight, bias, conv)

    @staticmethod
    def backward(ctx, grad):
        x, weight, lo, hi = ctx.saved_tensors
        left, right, space = ctx.halo
        stride, hw_pads, transposed = ctx.conv
        xp = torch.cat([lo, x, hi], 4)
        sym = all(a == b for a, b in hw_pads)
        if not sym:
            xp = F.pad(xp, [0, 0] + [p for pair in reversed(hw_pads)
                                     for p in pair])
        padding = [a for a, _ in hw_pads] + [0] if sym else [0, 0, 0]
        gxp, gw, gb = torch.ops.aten.convolution_backward(
            grad, xp, weight, [grad.shape[1]] if ctx.has_bias else None,
            list(stride), padding, [1, 1, 1], transposed, [0, 0, 0], 1,
            [True, True, ctx.has_bias])
        if not sym:
            for dim, (a, b) in zip((2, 3), hw_pads):
                gxp = gxp.narrow(dim, a, gxp.shape[dim] - a - b)
        n = x.shape[4]
        g = gxp.narrow(4, left, n).clone()
        _return_halo_grads(g, gxp.narrow(4, 0, left),
                           gxp.narrow(4, left + n, right), left, right, 4,
                           False, *space)
        return g, gw, gb, None, None


def _conv_padded(xp, weight, bias, conv):
    """The conv of `_HaloConv` on the padded slab: pads (before, after) on
    H and W, none on the depth (it carries its halo)."""
    stride, hw_pads, transposed = conv
    fn = F.conv_transpose3d if transposed else F.conv3d
    if all(a == b for a, b in hw_pads):
        return fn(xp, weight, bias, stride,
                  padding=(hw_pads[0][0], hw_pads[1][0], 0))
    xp = F.pad(xp, [0, 0] + [p for pair in reversed(hw_pads) for p in pair])
    return fn(xp, weight, bias, stride)


def halo_conv_slab(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor], left: int, right: int,
                   stride, hw_pads, mesh: Mesh,
                   transposed: bool = False) -> torch.Tensor:
    """A 3D convolution (or, `transposed`, a transposed one) of the NCDHW
    depth slab `x` with `left` / `right` halo rows of its neighbours
    attached (zeros at the ends of the volume), VALID along the depth and
    padded by `hw_pads` ((before, after) on H and W, symmetric ones given
    to the convolution). Differentiable; the halos' gradients go back to
    their owners."""
    _check_widths(x.shape[4], left, right)
    return _HaloConv.apply(x.contiguous(), weight, bias,
                           (left, right, _space(mesh)),
                           (tuple(stride), tuple(tuple(p) for p in hw_pads),
                            transposed))


def gather_space(x_local: torch.Tensor, axis: int, mesh: Mesh
                 ) -> torch.Tensor:
    """The whole tensor of the space group's slabs along `axis` (their
    concatenation in space order), on every process. Differentiable: a
    slab's gradient is the sum of the group's gradients of its rows."""
    n, i = mesh.shape[SPACE_AXIS], mesh.space_index
    rows = x_local.shape[axis]
    shape = list(x_local.shape)
    parts = []
    for count in (i * rows, (n - 1 - i) * rows):
        shape[axis] = count
        parts.append(x_local.new_zeros(shape))
    return all_reduce_sum(torch.cat([parts[0], x_local, parts[1]], axis),
                          mesh.group(SPACE_AXIS))


def slice_space(x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """This process's slab of `x` (whole and equal on every process of
    the space group) along `axis`. Differentiable: the gradient is the
    slab's, zero elsewhere, so that the group's gradients of a tensor
    computed whole on every process sum to the whole tensor's."""
    n = mesh.shape[SPACE_AXIS]
    if x.shape[axis] % n:
        raise ValueError(f"length {x.shape[axis]} does not split over "
                         f"{n} space slabs")
    rows = x.shape[axis] // n
    return x.narrow(axis, mesh.space_index * rows, rows)


def halo_conv3d(x_local: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int, mesh: Mesh,
                shard_axis: int = 1) -> torch.Tensor:
    """'same' 3D conv of this process's shard of a volume [B, H, W, D, C]
    whose `shard_axis` is split over the mesh's 'space' axis; kernel
    [kd, kh, kw, Cin, Cout] (flax DHWIO). Returns this process's shard of
    the output, equal to the unsharded conv's rows. It is
    `halo_conv_slab`, the models' conv of a depth slab, on the volume
    permuted to NCDHW with `shard_axis` last."""
    others = [a for a in (1, 2, 3) if a != shard_axis]
    order = [0, 4] + others + [shard_axis]
    weight = kernel.permute(4, 3, *(a - 1 for a in others + [shard_axis]))
    left, right = _halo_widths(kernel.shape[shard_axis - 1], stride)
    out = halo_conv_slab(
        x_local.permute(order), weight, bias, left, right, (stride,) * 3,
        [_halo_widths(kernel.shape[a - 1], stride) for a in others], mesh)
    return out.permute([order.index(a) for a in range(5)])

"""Halo-exchange 3D convolution of a spatially sharded volume: the port of
`ldm3d.parallel.halo`.

One spatial axis of an NDHWC volume is split over the mesh's 'space'
axis. Before a TF-'same' conv of kernel k and stride s (the local length
divisible by s), each process fetches `left` rows from its left
neighbour and `right` rows from its right one,

  pad_total = max(k - s, 0); left = pad_total // 2; right = pad_total - left

(zeros at the two ends of the axis, which is TF-'same' zero padding),
and a VALID conv along the sharded axis of the padded slab gives its
exact output shard. The exchange is point to point over the space group
(`dist.batch_isend_irecv`); its backward sends each halo's gradient back
to the process that owns those rows. No trainer calls it yet: it is the
op that spatial sharding of the models is to be built on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ldm3d_torch.parallel.mesh import SPACE_AXIS, Mesh


def _halo_widths(kernel: int, stride: int) -> Tuple[int, int]:
    pad_total = max(kernel - stride, 0)
    left = pad_total // 2
    return left, pad_total - left


def _swap(sends, recvs, group) -> None:
    """Post every (tensor, peer) send and receive at once and wait."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), p, group)
           for t, p in sends if p is not None]
    ops += [dist.P2POp(dist.irecv, t, p, group)
            for t, p in recvs if p is not None]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, axis, prev, nxt, group):
        ctx.meta = (left, right, axis, prev, nxt, group)
        length = x.shape[axis]
        shape = list(x.shape)
        shape[axis] = left
        left_halo = x.new_zeros(shape)
        shape[axis] = right
        right_halo = x.new_zeros(shape)
        # my left halo is the last `left` rows of my left neighbour; my
        # right halo the first `right` rows of my right neighbour
        sends, recvs = [], []
        if left:
            sends.append((x.narrow(axis, length - left, left), nxt))
            recvs.append((left_halo, prev))
        if right:
            sends.append((x.narrow(axis, 0, right), prev))
            recvs.append((right_halo, nxt))
        _swap(sends, recvs, group)
        return torch.cat([left_halo, x, right_halo], dim=axis)

    @staticmethod
    def backward(ctx, grad):
        left, right, axis, prev, nxt, group = ctx.meta
        length = grad.shape[axis] - left - right
        g_left = grad.narrow(axis, 0, left)
        g_right = grad.narrow(axis, left + length, right)
        g = grad.narrow(axis, left, length).clone()
        from_next = torch.zeros_like(g_left)     # my last `left` rows
        from_prev = torch.zeros_like(g_right)    # my first `right` rows
        sends, recvs = [], []
        if left:
            sends.append((g_left, prev))
            recvs.append((from_next, nxt))
        if right:
            sends.append((g_right, nxt))
            recvs.append((from_prev, prev))
        _swap(sends, recvs, group)
        g.narrow(axis, length - left, left).add_(from_next)
        g.narrow(axis, 0, right).add_(from_prev)
        return g, None, None, None, None, None, None


def halo_exchange(x_local: torch.Tensor, left: int, right: int, axis: int,
                  mesh: Mesh) -> torch.Tensor:
    """`x_local` padded along `axis` with `left` / `right` rows fetched
    from the mesh's space neighbours (zeros at the ends of the axis);
    differentiable."""
    if not left and not right:
        return x_local
    return _HaloExchange.apply(x_local, left, right, axis,
                               mesh.neighbour(SPACE_AXIS, -1),
                               mesh.neighbour(SPACE_AXIS, 1),
                               mesh.group(SPACE_AXIS))


def _conv3d_local(x: torch.Tensor, kernel: torch.Tensor,
                  stride: Tuple[int, int, int], shard_axis: int
                  ) -> torch.Tensor:
    """VALID conv along the sharded axis (halos attached), TF-'same'
    padding on the two other spatial axes. NDHWC in and out; kernel
    [kd, kh, kw, Cin, Cout]."""
    pads = []
    for dim in range(3):
        k, s = kernel.shape[dim], stride[dim]
        if dim == shard_axis - 1:
            pads.append((0, 0))
        else:
            total = max(k - s, 0)
            pads.append((total // 2, total - total // 2))
    xc = x.permute(0, 4, 1, 2, 3)
    # F.pad lists the last axis first
    xc = F.pad(xc, [p for pair in reversed(pads) for p in pair])
    out = F.conv3d(xc, kernel.permute(4, 3, 0, 1, 2), stride=stride)
    return out.permute(0, 2, 3, 4, 1)


def halo_conv3d(x_local: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int, mesh: Mesh,
                shard_axis: int = 1) -> torch.Tensor:
    """'same' 3D conv of this process's shard of a volume [B, H, W, D, C]
    whose `shard_axis` is split over the mesh's 'space' axis; kernel
    [kd, kh, kw, Cin, Cout] (flax DHWIO). Returns this process's shard of
    the output, equal to the unsharded conv's rows."""
    strides = (stride,) * 3
    left, right = _halo_widths(kernel.shape[shard_axis - 1], stride)
    padded = halo_exchange(x_local, left, right, shard_axis, mesh)
    out = _conv3d_local(padded, kernel, strides, shard_axis)
    return out if bias is None else out + bias

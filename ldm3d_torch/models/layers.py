"""Shared 3D building blocks of the port: convolutions with TF/flax 'SAME'
padding, the TF-exact transposed convolution (with the ICNR init of
`kernel_resize`), per-channel PReLU, norm selection and activations
(counterparts of `ldm3d.models.layers`).

Inside the port volumes are NCDHW, the layout cuDNN's `conv3d` takes; the
public functions of the port convert from and to the JAX package's NDHWC.
Parameter names mirror the flax tree (`kernel` becomes `weight`, `scale`
becomes `weight`), so that `ldm3d_torch.convert` maps one onto the other
by path.

Under `parallel.spatial.spatial_sharding` every layer here takes and
returns this process's depth slab (axis 4): the convolutions and the
SYMMETRIC pad fetch their halo rows from the neighbouring slabs
(`parallel.halo`), GroupNorm sums its statistics over the space group and
BatchNorm over the data x space processes; an op whose slab cannot serve
it (fewer rows than its halo, or not divisible by its stride) computes
the whole volume and keeps its slab (`spatial.gathered`).

Under `parallel.tp.model_sharding` a layer whose parameters
`tp.shard_module` split computes with its shards: a conv its slab of
output channels, gathered along C; a transposed conv a partial sum over
its slice of input channels, summed over the model group; a split vector
(a bias, a norm's scale or offset, a PReLU slope) is gathered where it
is used. Inputs and outputs are whole channels either way.

The compute dtype (`set_compute_dtype`, from `TrainConfig.dtype`) puts
casts where flax's `dtype=` puts them: a dense, conv or transposed conv
casts its input, weight and bias to it and returns its output in it
(flax's `promote_dtype(inputs, kernel, bias, dtype=...)`); a norm takes
its statistics and normalises in float32 and returns the compute dtype
(flax's `_normalize` with float32 reductions); an `Embed` returns its
rows in it. Parameters and BatchNorm statistics stay float32, and the
weights' gradients come back float32 through the casts. Without a
compute dtype (float32, the default) every layer computes in its input's
and parameters' type, as before.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ldm3d_torch.models.quantizers import Quantizer
from ldm3d_torch.parallel import spatial, tp
from ldm3d_torch.parallel.distributed import all_reduce_sum
from ldm3d_torch.parallel.halo import (_halo_widths, halo_conv_slab,
                                       halo_exchange, transposed_halo)
from ldm3d_torch.parallel.mesh import SPACE_AXIS

_Int3 = Union[int, Tuple[int, int, int]]


# The kernel inits of the JAX package's layers, as `init_jax_` draws them:
# "zeros" (`variance_scaling_init(0.0)`), "glorot_uniform" (`conv3d`'s
# default and `variance_scaling_init(1.0)`), "glorot_normal_icnr"
# (`conv3d_transpose(kernel_resize=True)`), "lecun_normal" (flax's default
# for `nn.Dense` and `nn.Conv`) and "constant:<value>".
KERNEL_INITS = ("zeros", "glorot_uniform", "glorot_normal_icnr",
                "lecun_normal")


def _check_init(kind: str) -> str:
    if kind.startswith("constant:"):
        float(kind.partition(":")[2])       # a malformed value raises
    elif kind not in KERNEL_INITS:
        raise ValueError(f"unknown kernel init {kind!r}")
    return kind


def _cast(module: nn.Module, *tensors):
    """`tensors` in `module`'s compute dtype (None stays None), or as they
    are where it has none: flax's `promote_dtype(..., dtype=...)`."""
    dtype = module.compute_dtype
    if dtype is None:
        return tensors
    return tuple(None if t is None else t.to(dtype) for t in tensors)


def _late_bias(module: nn.Module, bias: Optional[torch.Tensor]
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(the bias to fuse into the op, the bias to add to its output).
    Under a compute dtype flax rounds the op's output to it and then adds
    the bias (a second rounding, which a fused bias would skip); without
    one the bias is fused."""
    if module.compute_dtype is None:
        return bias, None
    return None, bias


def _plus(y: torch.Tensor, bias: Optional[torch.Tensor],
          dim: int = 1) -> torch.Tensor:
    """`y` plus a bias over its dim `dim` (channels; -1 for a dense)."""
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + bias.view(shape)


def _reduced(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A norm's input for its statistics and normalisation: at least
    float32 under a compute dtype, as flax reduces."""
    return x if module.compute_dtype is None else x.float()


def at_least_float32(t: torch.Tensor) -> torch.Tensor:
    """`t` upcast to float32 when it is narrower (an activation or a loss
    in the compute dtype), else as it is: a float64 reference keeps its
    precision."""
    return t if t.dtype.itemsize >= 4 else t.float()


def _out(module: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """A norm's or an embedding's output in the compute dtype."""
    dtype = module.compute_dtype
    return y if dtype is None else y.to(dtype)


class Dense(nn.Linear):
    """flax `nn.Dense` (`nn.Linear`, weight (out, in)); under
    `parallel.tp.model_sharding` its bias may be split, and is gathered
    here (the kernel is 2-D: whole on every process, as in JAX)."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = _cast(self, x, self.weight, tp.full(self, "bias"))
        fused, late = _late_bias(self, bias)
        return _plus(F.linear(x, weight, fused), late, -1)


class Embed(nn.Embedding):
    """flax `nn.Embed` (`nn.Embedding`, weight [tokens, features]); its
    rows come out in the compute dtype, as `Embed(dtype=...)` gives
    them."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _out(self, super().forward(x))


def with_init(module: nn.Module, kernel_init: str) -> nn.Module:
    """`module` (a `Dense`, whose default under `init_jax_` is
    glorot-uniform) with the kernel init `kernel_init`."""
    module.kernel_init = _check_init(kernel_init)
    return module


def _triple(v: _Int3) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' padding (before, after) of one spatial dim: the output has
    ceil(size / stride) positions, and the odd unit of padding goes after.
    A stride-2 k3 conv on an even input pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv3d(nn.Module):
    """3D convolution with TF/flax 'SAME' padding: the counterpart of
    `ldm3d.models.layers.conv3d` (flax `nn.Conv`, padding="SAME"), or with
    no padding for padding="VALID". Weight (out, in, kd, kh, kw); dense
    layers are `nn.Linear`, weight (out, in). `kernel_init` names the
    weight's init under `init_jax_` (`KERNEL_INITS`)."""

    compute_dtype = None

    def __init__(self, in_channels: int, features: int, kernel: _Int3 = 3,
                 stride: _Int3 = 1, use_bias: bool = True,
                 padding: str = "SAME", kernel_init: str = "glorot_uniform"):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}")
        self.kernel = _triple(kernel)
        self.stride = _triple(stride)
        self.padding = padding
        self.kernel_init = _check_init(kernel_init)
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tp.split_dim(self, "weight") is None:
            return self._conv(x)
        # split on its output channels: this process's slab, gathered
        return tp.gather_channels(self._conv(tp.column(x)))

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = _cast(self, x, self.weight, self.bias)
        fused, late = _late_bias(self, bias)
        return _plus(self._conv_with(x, weight, fused), late)

    def _conv_with(self, x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.padding == "VALID":
            # over slabs the caller has attached the halo (a SYMMETRIC
            # pad, the space-to-depth stem): the conv is local
            return F.conv3d(x, weight, bias, self.stride)
        mesh = spatial.sharded()
        if mesh is None:
            return _same_conv(F.conv3d, x, weight, bias, self.kernel,
                              self.stride)
        left, right = _halo_widths(self.kernel[2], self.stride[2])
        if not spatial.fits(x.shape[4], left, right, self.stride[2]):
            return spatial.gathered(
                lambda v: self._conv_with(v, weight, bias), x)
        pads = [same_pads(n, k, s) for n, k, s in zip(
            x.shape[2:4], self.kernel, self.stride)]
        return halo_conv_slab(x, weight, bias, left, right, self.stride,
                              pads, mesh)


def _same_conv(conv, x, weight, bias, kernel, stride) -> torch.Tensor:
    """`conv` (F.conv2d / F.conv3d) with TF 'SAME' padding: symmetric pads
    go to the convolution, uneven ones to an F.pad first."""
    pads = [same_pads(n, k, s) for n, k, s in zip(x.shape[2:], kernel,
                                                  stride)]
    if all(lo == hi for lo, hi in pads):
        return conv(x, weight, bias, stride,
                    padding=tuple(lo for lo, _ in pads))
    # F.pad lists the last dim first
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return conv(F.pad(x, flat), weight, bias, stride)


class Conv2d(nn.Module):
    """2D convolution with TF/flax 'SAME' padding (flax `nn.Conv` over
    NHWC frames; here NCHW): k = 4, s = 1 pads (1, 2), the odd unit after.
    Weight (out, in, kh, kw). flax's `nn.Conv` draws lecun-normal
    kernels unless told otherwise."""

    compute_dtype = None

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True,
                 kernel_init: str = "lecun_normal"):
        super().__init__()
        self.kernel = (kernel, kernel)
        self.stride = (stride, stride)
        self.kernel_init = _check_init(kernel_init)
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = _cast(self, x, self.weight, tp.full(self, "bias"))
        fused, late = _late_bias(self, bias)
        return _plus(_same_conv(F.conv2d, x, weight, fused, self.kernel,
                                self.stride), late)


def symmetric_pad3d(x: torch.Tensor, kernel: Tuple[int, int, int],
                    stride: Tuple[int, int, int]) -> torch.Tensor:
    """Edge-inclusive mirror padding of an NCDHW volume for a VALID conv:
    TF `SYMMETRIC` (`jnp.pad(mode="symmetric")`), which repeats the edge
    voxel, unlike `F.pad(mode="reflect")`. Per spatial dim the total pad
    is k - s, split (p // 2, p - p // 2). Built from flipped slices, so a
    pad wider than the dim is refused rather than wrapped. Over depth
    slabs the depth rows come from the neighbouring slabs, mirrored at
    the two ends of the volume."""
    mesh = spatial.sharded()
    for dim, (k, s) in enumerate(zip(kernel, stride), start=2):
        p = k - s
        lo, hi = p // 2, p - p // 2
        if not p:
            continue
        if dim == 4 and mesh is not None:
            x = halo_exchange(x, lo, hi, 4, mesh, reflect=True)
            continue
        n = x.shape[dim]
        if lo > n or hi > n:
            raise ValueError(f"symmetric pad ({lo}, {hi}) wider than the "
                             f"dim ({n})")
        parts = [x.narrow(dim, 0, lo).flip(dim)] if lo else []
        parts.append(x)
        if hi:
            parts.append(x.narrow(dim, n - hi, hi).flip(dim))
        x = torch.cat(parts, dim)
    return x


def avgpool3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Average pooling of an NCDHW volume, window = stride, VALID (flax
    `nn.avg_pool`; Keras AveragePooling3D); local on a slab that divides
    by the window."""
    if spatial.sharded() is not None and x.shape[4] % window:
        return spatial.gathered(avgpool3d, x, window)
    return F.avg_pool3d(x, window, window)


class ConvTranspose3d(nn.Module):
    """The counterpart of `ldm3d.models.layers.conv3d_transpose`, i.e.
    TF/Keras `Conv3DTranspose(padding='same')`: the gradient of the
    SAME-padded strided cross-correlation, output = input * stride (flax
    `nn.ConvTranspose` with transpose_kernel=True, padding="SAME").

    The flax kernel is stored (kd, kh, kw, OUT, IN), the Keras layout; as
    the adjoint of a forward conv from OUT to IN channels it is PyTorch's
    `conv_transpose3d` weight (IN, OUT, kd, kh, kw) with no flip. The full
    transposed output is cropped to TF's SAME window: it starts at
    pad_before = (k - s) // 2 and the odd unit is cut from the end.

    `kernel_resize` asks for the ICNR init (`icnr_init`, kernel_init
    "glorot_normal_icnr") instead of glorot-uniform, as the JAX layer's
    `kernel_resize` does.
    padding="VALID" (flax's, for k >= s) is the full transposed output,
    (n - 1) * s + k per dim, uncropped."""

    compute_dtype = None

    def __init__(self, in_channels: int, features: int, kernel: _Int3 = 4,
                 stride: _Int3 = 2, use_bias: bool = True,
                 kernel_resize: bool = False, padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}")
        self.kernel = _triple(kernel)
        self.stride = _triple(stride)
        self.kernel_resize = kernel_resize
        self.padding = padding
        self.kernel_init = "glorot_normal_icnr" if kernel_resize \
            else "glorot_uniform"
        self.weight = nn.Parameter(
            torch.empty(in_channels, features, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = _cast(self, x, self.weight, tp.full(self, "bias"))
        if tp.split_dim(self, "weight") is None:
            fused, late = _late_bias(self, bias)
            return _plus(self._conv(x, weight, fused), late)
        # split on its input channels: a partial sum over this process's
        # slice of them, summed over the model group
        y = tp.sum_partials(self._conv(tp.input_slice(x), weight, None))
        return _plus(y, bias)

    def _conv(self, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.padding == "VALID":
            # over slabs the caller padded and crops (a SYMMETRIC pad)
            return F.conv_transpose3d(x, weight, bias, self.stride)
        before = [max(k - s, 0) // 2 for k, s in zip(self.kernel, self.stride)]
        after = [max(k - s, 0) - b for k, s, b in
                 zip(self.kernel, self.stride, before)]
        common = [min(b, a) for b, a in zip(before, after)]
        starts = [b - c for b, c in zip(before, common)]
        n_out = [n * s for n, s in zip(x.shape[2:], self.stride)]
        mesh = spatial.sharded()
        if mesh is None:
            y = F.conv_transpose3d(x, weight, bias, self.stride,
                                   padding=tuple(common))
            if tuple(before) == tuple(after):
                return y
        else:
            # the slab's output needs `left` / `right` input rows of its
            # neighbours; it starts at `start` of the padded slab's full
            # transposed output
            left, right, start = transposed_halo(self.kernel[2],
                                                 self.stride[2])
            if not spatial.fits(x.shape[4], left, right):
                return spatial.gathered(
                    lambda v: self._conv(v, weight, bias), x)
            y = halo_conv_slab(x, weight, bias, left, right,
                               self.stride, [(c, c) for c in common[:2]],
                               mesh, transposed=True)
            starts[2] = start
        sl = [slice(b, b + n) for b, n in zip(starts, n_out)]
        return y[:, :, sl[0], sl[1], sl[2]]


def icnr_init(small: torch.Tensor, kernel: Tuple[int, int, int]
              ) -> torch.Tensor:
    """ICNR, checkerboard-free init of a transposed conv: a kernel drawn at
    1 / scale of the spatial size, `small` (IN, OUT, kd', kh', kw'),
    resized trilinearly (half-pixel centres, edges clamped) to `kernel`,
    as `jax.image.resize(..., "trilinear")` does when it enlarges."""
    if tuple(small.shape[2:]) == tuple(kernel):
        return small.clone()
    return F.interpolate(small, size=tuple(kernel), mode="trilinear",
                         align_corners=False)


def _icnr_(m: "ConvTranspose3d", generator: torch.Generator) -> None:
    """The JAX layer's ICNR init: flax glorot_normal (a normal truncated
    at 2 std, variance 1 / fan_avg) of the kernel at 1 / stride of its
    spatial size, then `icnr_init`."""
    scale = m.stride[0]
    small = [max(k // scale, 1) for k in m.kernel]
    ci, co = m.weight.shape[:2]
    rf = math.prod(small)
    std = math.sqrt(2.0 / (ci * rf + co * rf)) / .87962566103423978
    base = torch.empty(ci, co, *small, device=m.weight.device)
    nn.init.trunc_normal_(base, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    m.weight.copy_(icnr_init(base, m.kernel))


class PReLU(nn.Module):
    """Per-channel parametric ReLU over the channels of an NCDHW volume."""

    def __init__(self, channels: int, negative_slope_init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), negative_slope_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = tp.full(self, "alpha").to(x.dtype).view(1, -1, 1, 1, 1)
        return torch.where(x >= 0, x, alpha * x)


def get_act(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None:
        return lambda x: x
    return {
        "relu": F.relu,
        "silu": F.silu,
        "swish": F.silu,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "siren": torch.sin,
    }[name]


class _Act(nn.Module):
    def __init__(self, name: Optional[str]):
        super().__init__()
        self.name = name
        self.fn = get_act(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return str(self.name)


def act_layer(name: Optional[str], channels: int) -> nn.Module:
    """An activation module: a learnable per-channel `PReLU` for "prelu",
    else a parameter-free wrapper of `get_act(name)`."""
    if name == "prelu":
        return PReLU(channels)
    return _Act(name)


def _global_var_mean(x: torch.Tensor, dims, group):
    """(biased variance, mean) per channel over `dims` of the batch that
    `group`'s processes hold together (equal local shapes): the mean
    first, then the squared deviations from it, each summed over the
    group. `x` comes in at least float32 (`_BatchNorm` upcasts it)."""
    count = x.numel() // x.shape[1] * dist.get_world_size(group)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = all_reduce_sum(x.sum(dim=dims), group) / count
    sq = torch.square(x - mean.view(shape)).sum(dim=dims)
    return all_reduce_sum(sq, group) / count, mean


class _BatchNorm(nn.Module):
    """flax BatchNorm(momentum=0.99, epsilon=1e-3) over the channels of an
    NCDHW volume.

    Eval mode normalises with the running statistics. Training mode
    normalises with the batch's mean and *biased* variance and updates
    ra = 0.99 * ra + 0.01 * batch, as flax does. The update is computed
    here: `F.batch_norm(training=True)` would store the unbiased variance
    and reads its momentum as 1 - 0.99. `update_stats = False` (set while
    a checkpointed unit is recomputed in the backward pass) normalises the
    same way without touching the statistics.

    With `live_stats_graph` (the VQ-GAN critics), a training-mode forward
    also keeps the updated statistics as functions of the batch in
    `live_stats`, and eval-mode forwards normalise with those until
    `live_stats` is cleared: in JAX the statistics a flax update returns
    are traced values, so gradients reach the critic's parameters through
    the statistics of its real forward.

    With a process `group` (`parallel.mesh.attach_data_group`), training
    mode normalises with the mean and biased variance of the group's
    global batch (two all-reduces, differentiable), as the JAX step does
    on a data-sharded batch; the running statistics then agree on every
    process. Over depth slabs the statistics are those of the data x
    space processes (`spatial.stats_group`)."""

    momentum = 0.99
    eps = 1e-3
    compute_dtype = None

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.update_stats = True
        self.live_stats_graph = False
        self.live_stats = None
        self.group = None

    def __getstate__(self):
        # a process group neither pickles nor copies: a copy (the EMA
        # U-Net) is not attached to it (spatial sharding is not stored on
        # modules: copies are sharded as the model is)
        return {**super().__getstate__(), "group": None}

    def _normalize(self, x, mean, var):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * tp.full(self, "weight")
        return (x - mean.view(shape)) * mul.view(shape) \
            + tp.full(self, "bias").view(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _out(self, self._forward(_reduced(self, x)))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if self.live_stats is not None:
                return self._normalize(x, *self.live_stats)
            return F.batch_norm(x, self.running_mean, self.running_var,
                                tp.full(self, "weight"),
                                tp.full(self, "bias"), training=False,
                                eps=self.eps)
        dims = [0, *range(2, x.dim())]
        group = spatial.stats_group(self.group)
        if group is None:
            var, mean = torch.var_mean(x, dim=dims, correction=0)
        else:
            var, mean = _global_var_mean(x, dims, group)
        if self.update_stats:
            m = self.momentum
            new = (self.running_mean * m + mean * (1.0 - m),
                   self.running_var * m + var * (1.0 - m))
            if self.live_stats_graph and torch.is_grad_enabled():
                self.live_stats = new
            with torch.no_grad():
                self.running_mean.copy_(new[0])
                self.running_var.copy_(new[1])
        return self._normalize(x, mean, var)


class _GroupNorm(nn.Module):
    """flax GroupNorm(min(C, 32) groups, eps 1e-6). Over depth slabs each
    sample's group statistics are summed over the space group: the mean,
    then the squared deviations from it (two all-reduces,
    differentiable)."""

    eps = 1e-6
    compute_dtype = None

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.groups = min(channels, num_groups)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = spatial.sharded()
        weight, bias = tp.full(self, "weight"), tp.full(self, "bias")
        if mesh is None:
            return _out(self, F.group_norm(_reduced(self, x), self.groups,
                                           weight, bias, eps=self.eps))
        # the slab goes in as it is (the Function upcasts it, and keeps it
        # in its own type for the backward pass)
        return _out(self, _SlabGroupNorm.apply(
            x, weight, bias, self.groups, self.eps, mesh.shape[SPACE_AXIS],
            mesh.group(SPACE_AXIS)))


class _SlabGroupNorm(torch.autograd.Function):
    """GroupNorm of a depth slab with each sample's group statistics
    summed over the space group: the mean, then the squared deviations
    from it (two all-reduces); the backward pass's two group sums in one
    more. Keeps the input and the statistics for the backward pass, as
    `F.group_norm` does, and builds the normalised slab again there.
    Computes in at least float32: a bfloat16 slab is kept as it is and
    upcast in both passes, and its gradient goes back in bfloat16."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, space, group):
        b = x.shape[0]
        xg = x.reshape(b, groups, -1)
        xg = xg.to(torch.promote_types(x.dtype, torch.float32))
        count = xg.shape[-1] * space
        mean = all_reduce_sum(xg.sum(-1, keepdim=True), group) / count
        var = all_reduce_sum(torch.square(xg - mean).sum(-1, keepdim=True),
                             group) / count
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.meta = (groups, count, group)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = ((xg - mean) * rstd).reshape(x.shape)
        return y * weight.view(shape) + bias.view(shape)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        groups, count, group = ctx.meta
        b = x.shape[0]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = [0, *range(2, x.dim())]
        dy = dy.to(mean.dtype)
        xhat = (x.reshape(b, groups, -1).to(mean.dtype) - mean) * rstd
        dweight = (dy * xhat.reshape(x.shape)).sum(dims)
        dbias = dy.sum(dims)
        dxhat = (dy * weight.view(shape)).reshape(b, groups, -1)
        sums = torch.stack([dxhat.sum(-1), (dxhat * xhat).sum(-1)])
        dist.all_reduce(sums, group=group)
        m1, m2 = (t.unsqueeze(-1) / count for t in sums)
        dx = (rstd * (dxhat - m1 - xhat * m2)).reshape(x.shape)
        return dx.to(x.dtype), dweight, dbias, None, None, None, None


class LayerNorm(nn.Module):
    """flax LayerNorm over the last dim, eps 1e-6 (torch's default is
    1e-5); with `channels_first`, over dim 1 of an NCDHW volume (the
    channels-last LayerNorm of the JAX package's `Norm("layer")`)."""

    compute_dtype = None

    def __init__(self, channels: int, channels_first: bool = False):
        super().__init__()
        self.channels_first = channels_first
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.channels_first:
            x = x.movedim(1, -1)
        y = _out(self, F.layer_norm(_reduced(self, x), (x.shape[-1],),
                                    tp.full(self, "weight"),
                                    tp.full(self, "bias"), eps=1e-6))
        return y.movedim(-1, 1) if self.channels_first else y


class Norm(nn.Module):
    """Norm selector over the channels of an NCDHW volume ("batch",
    "group", "layer" or "none"). The inner module's name follows the flax
    tree (`BatchNorm_0`, `GroupNorm_0`, `LayerNorm_0`). BatchNorm follows
    the module's train/eval mode."""

    def __init__(self, kind: str, channels: int, num_groups: int = 32):
        super().__init__()
        self.kind = kind
        if kind == "batch":
            self.BatchNorm_0 = _BatchNorm(channels)
        elif kind == "group":
            self.GroupNorm_0 = _GroupNorm(channels, num_groups)
        elif kind == "layer":
            self.LayerNorm_0 = LayerNorm(channels, channels_first=True)
        elif kind != "none":
            raise ValueError(f"unknown norm kind {kind}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "batch":
            return self.BatchNorm_0(x)
        if self.kind == "group":
            return self.GroupNorm_0(x)
        if self.kind == "layer":
            return self.LayerNorm_0(x)
        return x


def upsample3d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour 3D upsample of an NCDHW volume (local on a
    slab)."""
    return (x.repeat_interleave(factor, dim=2)
            .repeat_interleave(factor, dim=3)
            .repeat_interleave(factor, dim=4))


def _fans(w: torch.Tensor) -> Tuple[int, int]:
    """flax's (fan_in, fan_out) of a port weight: (out, in, *k) for convs
    and dense layers, (in, out, *k) for a transposed conv, whose flax
    kernel (*k, out, in) swaps the two as well."""
    rf = math.prod(w.shape[2:])
    return w.shape[1] * rf, w.shape[0] * rf


def _init_common_(m: nn.Module, generator: torch.Generator) -> None:
    """Norms identity, BatchNorm statistics (0, 1), PReLU slopes 0.25 and
    each quantizer's JAX init (`Quantizer.reset_parameters`)."""
    if isinstance(m, (_BatchNorm, _GroupNorm, LayerNorm)):
        m.weight.fill_(1.0)
        m.bias.zero_()
        if isinstance(m, _BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    elif isinstance(m, PReLU):
        m.alpha.fill_(0.25)
    elif isinstance(m, Quantizer):
        m.reset_parameters(generator)


_WEIGHTED = (Conv3d, Conv2d, ConvTranspose3d, nn.Linear)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator
                 ) -> nn.Module:
    """Seeded random weights that reach the output, in place, drawn on the
    module's device: the draw of the random-weight checks and of
    `GenerationService.from_random_init`. Trainers start from `init_jax_`.

    Every conv, transposed-conv and dense weight is glorot-uniform (ICNR
    for a transposed conv with `kernel_resize`), embeddings are N(0, 1),
    biases zero, and norms, PReLU and quantizers as in `init_jax_`.
    Unlike the JAX init, no layer is zero-initialised: with random
    weights every layer, attention included, reaches the output."""
    for m in module.modules():
        if isinstance(m, _WEIGHTED):
            w = m.weight
            fan_in, fan_out = _fans(w)
            a = math.sqrt(6.0 / (fan_in + fan_out))
            w.uniform_(-a, a, generator=generator)
            if isinstance(m, ConvTranspose3d) and m.kernel_resize:
                _icnr_(m, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        else:
            _init_common_(m, generator)
    return module


@torch.no_grad()
def init_jax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's init, in place, drawn on the module's device:
    each conv, transposed-conv and dense weight by its `kernel_init`
    (glorot-uniform for an `nn.Linear` without one), every bias zero,
    embeddings flax's `nn.Embed` default (normal, std 1 / sqrt(features)),
    norms, PReLU and quantizers as flax sets them. The draws are the same
    distributions as flax's, not the same numbers."""
    for m in module.modules():
        if isinstance(m, _WEIGHTED):
            w = m.weight
            kind = getattr(m, "kernel_init", "glorot_uniform")
            fan_in, fan_out = _fans(w)
            if kind == "zeros":
                w.zero_()
            elif kind == "glorot_uniform":
                a = math.sqrt(6.0 / (fan_in + fan_out))
                w.uniform_(-a, a, generator=generator)
            elif kind == "glorot_normal_icnr":
                _icnr_(m, generator)
            elif kind == "lecun_normal":
                # a normal truncated at 2 std, rescaled to variance 1/fan_in
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            else:
                w.fill_(float(kind.partition(":")[2]))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.embedding_dim ** -0.5,
                             generator=generator)
        else:
            _init_common_(m, generator)
    return module


# the layers whose outputs take the compute dtype
_COMPUTE = (Dense, Embed, Conv3d, Conv2d, ConvTranspose3d, _BatchNorm,
            _GroupNorm, LayerNorm)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]
                      ) -> nn.Module:
    """Every layer of `module` computes in `dtype` (`core.config.
    compute_dtype` of `TrainConfig.dtype`), as flax's `dtype=` makes it:
    bfloat16 activations over float32 parameters. float32 (or None)
    takes the casts away: each layer then computes in its input's and
    parameters' type, as a float64 copy of the module does."""
    value = None if dtype in (None, torch.float32) else dtype
    for m in module.modules():
        if isinstance(m, _COMPUTE):
            m.compute_dtype = value
    return module


# `init_random(seed, scheme)` of the trainers: "jax" starts training where
# the JAX package does; "reach" is the random-weight checks' draw
INIT_SCHEMES = {"jax": init_jax_, "reach": init_params_}

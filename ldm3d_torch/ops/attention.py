"""Flash voxel attention: the port of `ldm3d.ops.attention`.

`voxel_attention` is the one entry point the U-Net calls. For tensors on
the GPU it launches the hand-written CUDA kernel (`csrc/voxel_attention.cu`,
the counterpart of the TPU kernel `_flash_kernel`); for tensors on the CPU
it computes the plain PyTorch version. A CUDA tensor never falls back to
the plain version: the kernel runs or the call raises.

The kernel is forward only and writes into a tensor autograd knows nothing
of, so when a gradient is needed the CUDA route goes through
`VoxelAttentionFn`: its forward launches the kernel, its backward
recomputes the plain version from the saved q, k, v and returns that
version's vector-Jacobian products. The TPU kernel has no backward to port
(JAX training differentiates the XLA path). Without a gradient (serving)
the kernel is called directly, which spares the Function's host work.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ldm3d_torch.ops._build import copy_bytes

KERNEL = "voxel_attention"
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel since the last reset (plain integer; the
# wrapper adds one where it launches and nowhere else), and the same
# launches by dtype ("float32", "bfloat16").
launches = 0
launches_by_dtype = {"float32": 0, "bfloat16": 0}


def reset_launches() -> None:
    global launches
    launches = 0
    for key in launches_by_dtype:
        launches_by_dtype[key] = 0


def _attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Plain version: scores and softmax in float32, probabilities cast to
    v's type before the product (`_attention_xla`); the output, and the
    gradients of q, k and v, in the inputs' type."""
    scores = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkc->bqc", probs, v)


def column_tile(c: int) -> int:
    """Output columns per block: 32 where C fits in 32, else 64. The
    kernel recomputes the scores for each column slice, so narrower slices
    cost more than the blocks they add (at the served shape 32 would give
    256 blocks instead of 128, and ran slower in trials)."""
    return 32 if c <= 32 else 64


_lib = None


def _library():
    global _lib
    if _lib is None:
        from ldm3d_torch.ops import _build
        lib = _build.load(KERNEL).lib
        lib.voxel_attention_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.voxel_attention_forward.restype = ctypes.c_int
        lib.voxel_attention_error_string.argtypes = [ctypes.c_int]
        lib.voxel_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"voxel_attention_cuda: {name} is on {t.device}")
        if t.dim() != 3:
            raise ValueError(f"voxel_attention_cuda: {name} must be "
                             f"[B, N, C], got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError("voxel_attention_cuda: q, k, v differ in dtype")
        if t.device != q.device:
            raise ValueError("voxel_attention_cuda: q, k, v differ in device")
        if not t.is_contiguous():
            raise ValueError(f"voxel_attention_cuda: {name} is not "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"voxel_attention_cuda: {name} is not 16-byte "
                             "aligned")
    if q.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"voxel_attention_cuda: dtype {q.dtype} not in "
                         f"{list(SUPPORTED_DTYPES)}")
    b, nq, c = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[2] != c \
            or v.shape != k.shape or k.shape[1] == 0 or nq == 0 or c == 0:
        raise ValueError(f"voxel_attention_cuda: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")


def voxel_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, without synchronising.
    Raises on anything the kernel does not take, and when the launch is
    refused."""
    global launches
    _check(q, k, v)
    lib = _library()
    b, nq, c = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.voxel_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq,
            k.shape[1], c, SUPPORTED_DTYPES[q.dtype], float(scale),
            column_tile(c), copy_bytes(c * q.element_size()),
            stream)
    if err != 0:
        msg = lib.voxel_attention_error_string(err).decode()
        raise RuntimeError(f"voxel_attention kernel launch failed: {msg} "
                           f"(q {tuple(q.shape)} {q.dtype})")
    launches += 1
    launches_by_dtype[str(q.dtype).removeprefix("torch.")] += 1
    return out


class VoxelAttentionFn(torch.autograd.Function):
    """Attention with a given forward and the plain version's gradient.

    `apply(q, k, v, scale, forward)`: `forward(q, k, v, scale)` computes
    the output (the CUDA kernel on the card; any function of the same
    value, e.g. the plain version in a CPU test). The backward recomputes
    `_attention_reference` under autograd from the saved inputs."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, forward: Callable) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = _attention_reference(*inputs, ctx.scale)
        grads = torch.autograd.grad(out, inputs, grad_out)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad[:3])) + (None, None)


def voxel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention over flattened voxel sequences.

    Args:
      q: [B (heads folded into B), nq, C]; k, v: [B, nkv, C].
      scale: score scale; defaults to C ** -0.5.
    """
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        return _attention_reference(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return VoxelAttentionFn.apply(q, k, v, scale, voxel_attention_cuda)
    return voxel_attention_cuda(q, k, v, scale)

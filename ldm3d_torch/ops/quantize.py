"""Codebook nearest-neighbour and the quantization ops around it: the port
of `ldm3d.ops.quantize`.

`nearest_codebook_indices` is the entry point every quantizer calls. For
tensors on the GPU it launches the hand-written CUDA kernel
(`csrc/codebook_nearest.cu`, the counterpart of the TPU kernel
`_nearest_kernel`); for tensors on the CPU it computes the plain PyTorch
version. A CUDA tensor never falls back to the plain version: the kernel
runs or the call raises.

The sums over rows that share a code (`ema_statistics`, and the gradient
of `codebook_gather`) are one-hot products in float64, so that they are
the same bits on every run: `index_add_` on the card adds with atomics in
no fixed order, and a float32 product could run on TF32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ldm3d_torch.ops._build import copy_bytes

KERNEL = "codebook_nearest"
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS_PER_BLOCK = 128     # the kernel's tile of x rows
CODES_PER_TILE = 128     # the kernel's tile of codes
BLOCKS_PER_SM = 2        # the grid the K split aims for (shared memory
                         # holds two blocks per SM)

# Launches of the CUDA kernel since the last reset (plain integer; the
# wrapper adds one where it launches and nowhere else), and the same
# launches by x's dtype ("float32", "bfloat16"): the quantizers send
# float32 on every path, under any compute dtype.
launches = 0
launches_by_dtype = {"float32": 0, "bfloat16": 0}


def reset_launches() -> None:
    global launches
    launches = 0
    for key in launches_by_dtype:
        launches_by_dtype[key] = 0


def _nearest_indices_reference(x: torch.Tensor, codebook: torch.Tensor
                               ) -> torch.Tensor:
    """Plain version: [N, D], [K, D] -> [N] int32 argmin_k of
    ||c_k||^2 - 2 x.c_k, with the codebook cast to x's type before the
    product (summed in float32) and ||c||^2 in float32 from the uncast
    codebook, as the TPU kernel does. Ties go to the first index."""
    scores = x.float() @ codebook.to(x.dtype).float().T
    c_sq = codebook.float().square().sum(-1)
    return torch.argmin(c_sq[None, :] - 2.0 * scores, dim=-1).to(torch.int32)


def k_splits(n: int, k: int, sms: int) -> int:
    """How many parts of K the kernel's grid takes, so that the row tiles
    times the splits give about BLOCKS_PER_SM blocks per SM; every split
    owns at least one tile of codes."""
    row_tiles = -(-n // ROWS_PER_BLOCK)
    code_tiles = -(-k // CODES_PER_TILE)
    want = min(code_tiles, max(1, math.ceil(BLOCKS_PER_SM * sms / row_tiles)))
    per = -(-code_tiles // want)
    return -(-code_tiles // per)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from ldm3d_torch.ops import _build
        lib = _build.load(KERNEL).lib
        lib.codebook_nearest.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.codebook_nearest.restype = ctypes.c_int
        lib.codebook_nearest_error_string.argtypes = [ctypes.c_int]
        lib.codebook_nearest_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x: torch.Tensor, codebook: torch.Tensor) -> None:
    if x.device.type != "cuda" or codebook.device != x.device:
        raise ValueError(f"codebook_nearest_cuda: x is on {x.device}, the "
                         f"codebook on {codebook.device}")
    if x.dim() != 2 or codebook.dim() != 2 \
            or codebook.shape[1] != x.shape[1]:
        raise ValueError(f"codebook_nearest_cuda: shapes x "
                         f"{tuple(x.shape)}, codebook {tuple(codebook.shape)}"
                         " must be [N, D] and [K, D]")
    if x.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"codebook_nearest_cuda: dtype {x.dtype} not in "
                         f"{list(SUPPORTED_DTYPES)}")
    if not codebook.is_floating_point():
        raise ValueError("codebook_nearest_cuda: the codebook is not float")
    n, d = x.shape
    k = codebook.shape[0]
    if n == 0 or k == 0 or d == 0:
        raise ValueError(f"codebook_nearest_cuda: N={n}, K={k}, D={d} must "
                         "be > 0")
    if max(n, k) >= 2 ** 30:
        raise ValueError("codebook_nearest_cuda: N or K too large")
    if not x.is_contiguous():
        raise ValueError("codebook_nearest_cuda: x is not contiguous")
    if x.data_ptr() % 16:
        raise ValueError("codebook_nearest_cuda: x is not 16-byte aligned")


def nearest_codebook_indices_cuda(x: torch.Tensor, codebook: torch.Tensor
                                  ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, without synchronising.
    The codebook is cast to x's type here and ||c||^2 computed in float32
    from the uncast codebook. Raises on anything the kernel does not take,
    and when the launch is refused."""
    global launches
    _check(x, codebook)
    lib = _library()
    n, d = x.shape
    k = codebook.shape[0]
    cb = codebook.detach().to(x.dtype).contiguous()
    if cb.data_ptr() % 16:
        raise ValueError("codebook_nearest_cuda: the codebook is not 16-byte "
                         "aligned")
    c_sq = codebook.detach().float().square().sum(-1).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = k_splits(n, k, sms)
    # scratch: one 64-bit (distance, index) key per split and row. Like
    # cb and c_sq it is freed at return while the kernel may still run;
    # the caching allocator hands it out again only to later work on this
    # stream.
    part = torch.empty(splits * n, dtype=torch.int64, device=x.device)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.codebook_nearest(
            x.data_ptr(), cb.data_ptr(), c_sq.data_ptr(), part.data_ptr(),
            out.data_ptr(), n, k, d, splits, SUPPORTED_DTYPES[x.dtype],
            copy_bytes(d * x.element_size()), stream)
    if err != 0:
        msg = lib.codebook_nearest_error_string(err).decode()
        raise RuntimeError(f"codebook_nearest kernel launch failed: {msg} "
                           f"(x {tuple(x.shape)} {x.dtype}, K={k})")
    launches += 1
    launches_by_dtype[str(x.dtype).removeprefix("torch.")] += 1
    return out


def nearest_codebook_indices(x: torch.Tensor, codebook: torch.Tensor
                             ) -> torch.Tensor:
    """argmin_k ||x_n - c_k||^2 for flattened activations.

    Args:
      x: [N, D] activations.
      codebook: [K, D].
    Returns: [N] int32 indices. No gradient flows through it.
    """
    x, codebook = x.detach(), codebook.detach()
    if x.device.type == "cpu":
        return _nearest_indices_reference(x, codebook)
    return nearest_codebook_indices_cuda(x.contiguous(), codebook)


def codebook_usage_counts(indices: torch.Tensor, num_embeddings: int
                          ) -> torch.Tensor:
    """Per-code usage counts, float32 [K]."""
    return torch.bincount(indices.reshape(-1).long(),
                          minlength=num_embeddings).float()


def perplexity_from_counts(counts: torch.Tensor, eps: float = 1e-10
                           ) -> torch.Tensor:
    """exp entropy of codebook usage."""
    avg = counts / torch.clamp(counts.sum(), min=1.0)
    return torch.exp(-(avg * torch.log(avg + eps)).sum())


def segment_sum(values: torch.Tensor, indices: torch.Tensor,
                num_embeddings: int) -> torch.Tensor:
    """[K, D] float32 sums of the rows of `values` [N, D] by code
    `indices` [N]: a float64 one-hot product, deterministic."""
    one_hot = torch.zeros(values.shape[0], num_embeddings,
                          dtype=torch.float64, device=values.device)
    one_hot.scatter_(1, indices.reshape(-1, 1).long(), 1.0)
    return (one_hot.T @ values.double()).float()


def ema_statistics(x_flat: torch.Tensor, indices: torch.Tensor,
                   num_embeddings: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cluster counts [K], cluster sums [K, D]), float32, for the EMA
    codebook updates."""
    return (codebook_usage_counts(indices, num_embeddings),
            segment_sum(x_flat.detach(), indices, num_embeddings))


class _Gather(torch.autograd.Function):
    """codebook[indices], with the codebook's gradient summed by
    `segment_sum` instead of an atomic scatter."""

    @staticmethod
    def forward(ctx, codebook, indices):
        ctx.save_for_backward(indices)
        ctx.num_embeddings = codebook.shape[0]
        return codebook[indices.long()]

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        return segment_sum(grad, indices, ctx.num_embeddings), None


def codebook_gather(codebook: torch.Tensor, indices: torch.Tensor
                    ) -> torch.Tensor:
    """Rows `indices` [N] of `codebook` [K, D] -> [N, D]; the gradient
    reaches the codebook, deterministically."""
    return _Gather.apply(codebook, indices.reshape(-1))


def quantize_lookup(x_flat: torch.Tensor, codebook: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(quantized [N, D], indices [N]). Gradients flow to `codebook`
    through the gather."""
    indices = nearest_codebook_indices(x_flat, codebook)
    return codebook_gather(codebook, indices), indices

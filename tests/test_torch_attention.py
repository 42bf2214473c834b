"""Voxel attention of the PyTorch port against the JAX package.

The port's plain version (`_attention_reference`, what a CPU tensor runs)
is held against `_attention_xla` and against the Pallas kernel in interpret
mode on the same numpy inputs. The CUDA kernel itself is held against the
plain version on the card by `test_cuda_kernel_matches_plain` (marked
`gpu`, skipped without a card) and by `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.ops.attention import _attention_pallas, _attention_xla
from ldm3d_torch.ops import attention as tattn
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# float32 on the CPU: both sides sum the same products in float32 in
# different orders; 2e-5 is the bound the JAX package's own Pallas-vs-XLA
# tests use (tests/test_attention.py).
F32_TOL = 2e-5


def _qkv(b, n, c, n_kv=None, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n_kv = n if n_kv is None else n_kv
    q = rng.standard_normal((b, n, c)).astype(dtype)
    k = rng.standard_normal((b, n_kv, c)).astype(dtype)
    v = rng.standard_normal((b, n_kv, c)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("b,n,n_kv,c", [
    (2, 64, None, 512),    # flagship self-attention shape, batch cut to 2
    (2, 64, 37, 512),      # cross-attention, ragged key count
    (2, 300, None, 64),    # long ragged sequence at head width 64
    (1, 256, 130, 64),     # cross-attention, nq != nkv
    (3, 8, 8, 192),        # a middle width
    (2, 64, None, 16),     # the smoke presets' attention width
    (2, 70, 33, 100),      # a width that is no multiple of 16
    (1, 64, None, 1024),   # wider than 512: many column slices
])
def test_plain_matches_xla(b, n, n_kv, c):
    q, k, v = _qkv(b, n, c, n_kv)
    scale = c ** -0.5
    ref = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale))
    out = tattn._attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n,n_kv,block", [
    (72, None, 64),        # tail of 8 keys in the last block is masked
    (200, 130, 64),        # cross-attention with a ragged key tail
])
def test_plain_matches_pallas_interpret(n, n_kv, block):
    q, k, v = _qkv(1, n, 64, n_kv, seed=1)
    scale = 64.0 ** -0.5
    ref = np.asarray(_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale, block_q=block,
                                       block_k=block, interpret=True))
    out = tattn.voxel_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n,n_kv,c", [
    (64, None, 16),        # the smoke presets' attention width
    (72, 40, 100),         # ragged keys at a width no tile divides
    (64, None, 1024),      # wider than 512
])
def test_plain_matches_pallas_interpret_at_any_width(n, n_kv, c):
    q, k, v = _qkv(2, n, c, n_kv, seed=6)
    scale = c ** -0.5
    ref = np.asarray(_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale, block_q=64,
                                       block_k=64, interpret=True))
    out = tattn.voxel_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("row_bytes,want", [
    (16 * 4, 16),          # float32 C = 16
    (100 * 4, 16),         # float32 C = 100: 400 bytes
    (10 * 4, 4),           # float32 C = 10: 40 bytes
    (33 * 2, 2),           # bfloat16 C = 33: odd
    (100 * 2, 4),          # bfloat16 C = 100: 200 bytes
    (1024 * 2, 16),        # bfloat16 C = 1024
])
def test_copy_bytes_never_straddles_rows(row_bytes, want):
    got = tattn.copy_bytes(row_bytes)
    assert got == want and row_bytes % got == 0


@pytest.mark.parametrize("c,want", [
    (512, 64),             # the flagship head width
    (1024, 64),            # wider: 16 column slices
    (100, 64),             # two slices, the second ragged
    (33, 64),
    (32, 32),              # fits in one 32-column slice
    (16, 32),              # the smoke presets' width
    (1, 32),
])
def test_column_tile(c, want):
    assert tattn.column_tile(c) == want


def test_plain_bf16_matches_xla():
    # bf16 inputs: both cast the float32 probabilities to bf16 before the
    # product and round the output to bf16; they may round differently by
    # one bf16 ulp (2^-7 relative) at |out| < 2.
    q, k, v = _qkv(2, 64, 512, 37, seed=2)
    scale = 512 ** -0.5
    ref = _attention_xla(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         scale)
    out = tattn._attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=2 ** -6)


def test_default_scale_is_inverse_sqrt_width():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 128, seed=3))
    np.testing.assert_array_equal(
        tattn.voxel_attention(q, k, v).numpy(),
        tattn._attention_reference(q, k, v, 128 ** -0.5).numpy())


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 64, 64, seed=4))
    tattn.reset_launches()
    out = tattn.voxel_attention(q, k, v, 0.125)
    assert tattn.launches == 0
    np.testing.assert_array_equal(
        out.numpy(), tattn._attention_reference(q, k, v, 0.125).numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    # The wrapper never computes the plain version: a tensor it cannot
    # launch on is an error, not a fallback.
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 64, seed=5))
    tattn.reset_launches()
    with pytest.raises(ValueError, match="cpu"):
        tattn.voxel_attention_cuda(q, k, v, 0.125)
    assert tattn.launches == 0


def test_kernel_source_names_the_tpu_kernel_and_its_bound():
    import os
    src = os.path.join(os.path.dirname(tattn.__file__), os.pardir, "csrc",
                       tattn.KERNEL + ".cu")
    with open(src) as f:
        text = f.read()
    assert "ldm3d/ops/attention.py::_flash_kernel" in text
    assert "memory-bound" in text
    assert 'extern "C" int voxel_attention_forward' in text
    assert "cudaGetLastError" in text


@pytest.mark.gpu
@pytest.mark.parametrize("b,nq,nkv,c,dtype,tol", [
    (16, 64, 64, 512, torch.float32, 1e-4),
    (16, 64, 37, 512, torch.bfloat16, 3e-2),
    (2, 300, 300, 64, torch.float32, 1e-4),
    (16, 64, 64, 16, torch.float32, 1e-4),       # C = 16
    (4, 300, 257, 100, torch.float32, 1e-4),     # C = 100, ragged
])
def test_cuda_kernel_matches_plain(b, nq, nkv, c, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, nq, c, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, nkv, c, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, nkv, c, generator=gen, device="cuda").to(dtype)
    tattn.reset_launches()
    out = tattn.voxel_attention(q, k, v, c ** -0.5)
    torch.cuda.synchronize()
    assert tattn.launches == 1
    ref = tattn._attention_reference(q, k, v, c ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= tol

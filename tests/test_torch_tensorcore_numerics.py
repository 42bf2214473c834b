"""The arithmetic of the port's tensor-core kernels, emulated on the CPU.

`csrc/voxel_attention.cu` and `csrc/codebook_nearest.cu` run float32
products as 3xTF32 on mma.sync: each operand x is split into
hi = tf32(x) (round to nearest, 10-bit mantissa) and lo = x - hi, which
the tensor core reads truncated to TF32, and a product is
lo_a hi_b + hi_a lo_b + hi_a hi_b summed in float32.
The card cannot be asked here, so these tests emulate that arithmetic in
torch, on the float32 bit pattern, at the flagship shapes with numpy
seeds, and hold it to the tolerances `chip_smoke.py` holds the kernels
to on the card (`ATTN_TOL`, `CB_DIST_TOL`). They also record what one
TF32 pass would give, the design the kernels do not use.
"""

import numpy as np
import pytest
import torch

from chip_smoke import ATTN_TOL, CB_DIST_TOL
from ldm3d_torch.ops.attention import _attention_reference
from ldm3d_torch.ops.quantize import _nearest_indices_reference


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties
    away from zero, keeping 10 mantissa bits (the low 13 bits zero)."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF      # on the magnitude's bits
    return rounded.view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor core reads from a float32 word: its top
    19 bits (the low 13 bits dropped)."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF) \
        .view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32_truncated(x.float() - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it in float32: three TF32 products,
    small terms first, summed in float32 (the products of two TF32 values
    are exact in float32)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def _attention(q, k, v, scale, matmul):
    """The kernel's attention with the given product: scores, softmax
    with the running sum of unnormalised p, P.V, then acc / l."""
    s = matmul(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return matmul(p, v) / p.sum(-1, keepdim=True)


def _flagship_qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((16, 64, 512))
                             .astype(np.float32)) for _ in range(3)]


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -11, 3.0e-39])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                         -(1.0 + 2 ** -10), 1.0 + 2 ** -9, 0.0])
    got = tf32(x)
    # the subnormal keeps its top bits: only check that it shrank to zero
    # or stayed below 2^-126
    torch.testing.assert_close(got[:-1], want[:-1], rtol=0, atol=0)
    assert 0 <= float(got[-1]) < 2 ** -126
    # hi + lo carries about 21 significant bits
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = split(v)
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2 ** -21
    assert float(((hi - v).abs() / v.abs()).max()) <= 2 ** -11


def test_3xtf32_attention_meets_the_f32_tolerance_at_the_served_shape():
    q, k, v = _flagship_qkv()
    scale = 512 ** -0.5
    ref = _attention_reference(q, k, v, scale)
    err = float((_attention(q, k, v, scale, matmul_3xtf32) - ref).abs().max())
    assert err <= ATTN_TOL[torch.float32], err


def test_one_tf32_pass_misses_the_f32_attention_tolerance_widely():
    # One TF32 pass keeps about 3 decimal digits: at [16, 64, 64, 512] the
    # output is off by 7.0e-4 with these seeds, 7 x ATTN_TOL (3xTF32:
    # 1.2e-6).
    q, k, v = _flagship_qkv()
    scale = 512 ** -0.5
    ref = _attention_reference(q, k, v, scale)
    err = float((_attention(q, k, v, scale, matmul_1xtf32) - ref).abs().max())
    assert err > 5 * ATTN_TOL[torch.float32], err


def _codebook_gap(matmul, seed=2):
    """Largest float64 distance gap between the argmin under `matmul` and
    the plain version's, at the flagship train shape, and how many rows
    pick another code."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((4096, 256)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((1024, 256)).astype(np.float32))
    c_sq = cb.square().sum(-1)
    idx = torch.argmin(c_sq[None] - 2.0 * matmul(x, cb.T), dim=-1)
    ref = _nearest_indices_reference(x, cb).long()
    dist = (cb.double() ** 2).sum(-1)[None] - 2.0 * x.double() @ cb.double().T
    rows = torch.arange(4096)
    gap = float((dist[rows, idx] - dist[rows, ref]).abs().max())
    return gap, int((idx != ref).sum())


def test_3xtf32_codebook_meets_the_distance_tolerance_at_the_train_shape():
    gap, _ = _codebook_gap(matmul_3xtf32)
    assert gap <= CB_DIST_TOL, gap


def test_one_tf32_pass_flips_codebook_argmins():
    # Recorded, not a wide miss: with these seeds one TF32 pass picks
    # another code in 3 of 4096 rows, at a float64 distance gap of 0.021,
    # 2 x CB_DIST_TOL; 3xTF32 picks the plain version's code in every row.
    gap_1, differ_1 = _codebook_gap(matmul_1xtf32)
    gap_3, differ_3 = _codebook_gap(matmul_3xtf32)
    assert differ_1 > differ_3 == 0 and gap_1 > gap_3, (gap_1, differ_1)


@pytest.mark.parametrize("matmul", [matmul_3xtf32, matmul_1xtf32])
def test_emulated_products_are_exact_on_tf32_inputs(matmul):
    # Inputs already in TF32 with small integers: every product and sum is
    # exact in float32, so both emulations equal the plain product.
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-8, 8, (16, 32)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-8, 8, (32, 8)).astype(np.float32))
    torch.testing.assert_close(matmul(a, b), a @ b, rtol=0, atol=0)

"""Codebook nearest-neighbour of the PyTorch port against the JAX package.

The port's plain version (`_nearest_indices_reference`, what a CPU tensor
runs) is held against `_nearest_indices_xla` and against the Pallas kernel
`_nearest_indices_pallas` run in TPU interpret mode, on the same numpy
inputs. The CUDA kernel is held against the plain version on the card by
`test_cuda_kernel_matches_plain` (marked `gpu`, skipped without a card)
and by `chip_smoke.py`.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldm3d.ops.quantize import (_nearest_indices_pallas,
                                _nearest_indices_xla,
                                codebook_usage_counts as j_counts,
                                perplexity_from_counts as j_perplexity,
                                quantize_lookup as j_lookup)
from ldm3d_torch.core.config import QuantizerConfig
from ldm3d_torch.models.quantizers import make_quantizer
from ldm3d_torch.ops import quantize as tq
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

K, D = 16, 8   # the tiny flagship codebook

# An argmin is only defined up to the rounding of the distances: both sides
# sum D = 8 float32 products of O(1) values in different orders, an error
# of a few float32 ulps of distances of O(10), far below 1e-4. Rows whose
# best two float64 distances lie within GAP_EPS of each other may pick
# either; every other row must pick the same index.
GAP_EPS = 1e-4


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    cb = rng.standard_normal((K, D)).astype(np.float32)
    return x, cb


def _distances(x, cb, cb_norm=None):
    """float64 ||c||^2 - 2 x.c of the values both sides use: the product
    with `cb` (the codebook cast to x's type), ||c||^2 of `cb_norm` (the
    uncast codebook; `cb` when not given)."""
    cb_norm = cb if cb_norm is None else cb_norm
    return ((cb_norm.astype(np.float64) ** 2).sum(-1)[None, :]
            - 2.0 * x.astype(np.float64) @ cb.astype(np.float64).T)


def assert_same_argmin(out, ref, dist, eps=GAP_EPS):
    """Indices equal where the top-2 gap exceeds eps; elsewhere both picks
    lie within eps of the minimum."""
    out, ref = np.asarray(out), np.asarray(ref)
    part = np.sort(dist, axis=1)
    clear = part[:, 1] - part[:, 0] > eps
    np.testing.assert_array_equal(out[clear], ref[clear])
    rows = np.arange(len(out))
    for idx in (out, ref):
        assert (dist[rows, idx] - part[:, 0] <= eps).all()
    return int((~clear).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 2048, 2049])
def test_plain_matches_xla_and_pallas_interpret(n, dtype):
    x, cb = _data(n, seed=n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj = jnp.asarray(x, jdt)
    out = tq.nearest_codebook_indices(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(cb))
    assert out.dtype == torch.int32 and out.shape == (n,)
    # the values multiplied: x in its type, the codebook cast to it
    xv = np.array(xj.astype(jnp.float32))
    cbv = np.array(jnp.asarray(cb, jdt).astype(jnp.float32))
    dist = _distances(xv, cbv, cb)
    with pltpu.force_tpu_interpret_mode():
        pallas = _nearest_indices_pallas(xj, jnp.asarray(cb))
    assert_same_argmin(out.numpy(), np.asarray(pallas), dist)
    # the XLA path multiplies by the uncast codebook: give it the cast one
    # (and its ||c||^2 then differs from the kernel's, so compare on its
    # own distances)
    xla = _nearest_indices_xla(xj, jnp.asarray(cbv))
    out_cast = tq.nearest_codebook_indices(torch.from_numpy(x).to(tdt),
                                           torch.from_numpy(cbv))
    assert_same_argmin(out_cast.numpy(), np.asarray(xla),
                       _distances(xv, cbv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_xla_and_pallas_interpret_at_d20(dtype):
    # D = 20: a depth no 16-element tile divides
    rng = np.random.default_rng(8)
    x = rng.standard_normal((300, 20)).astype(np.float32)
    cb = rng.standard_normal((40, 20)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj = jnp.asarray(x, jdt)
    out = tq.nearest_codebook_indices(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(cb))
    xv = np.array(xj.astype(jnp.float32))
    cbv = np.array(jnp.asarray(cb, jdt).astype(jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        pallas = _nearest_indices_pallas(xj, jnp.asarray(cb))
    assert_same_argmin(out.numpy(), np.asarray(pallas), _distances(xv, cbv, cb))
    xla = _nearest_indices_xla(xj, jnp.asarray(cbv))
    out_cast = tq.nearest_codebook_indices(torch.from_numpy(x).to(tdt),
                                           torch.from_numpy(cbv))
    assert_same_argmin(out_cast.numpy(), np.asarray(xla),
                       _distances(xv, cbv))


def test_duplicate_codes_give_the_first_index():
    rng = np.random.default_rng(3)
    cb = rng.standard_normal((K, D)).astype(np.float32)
    cb[7] = cb[3]
    cb[12] = cb[3]
    cb[9] = cb[5]
    x = np.concatenate([cb[[3, 7, 12, 5, 9]],
                        cb[[3, 5]] + 1e-3 * rng.standard_normal(
                            (2, D)).astype(np.float32)])
    want = [3, 3, 3, 5, 5, 3, 5]
    out = tq.nearest_codebook_indices(torch.from_numpy(x),
                                      torch.from_numpy(cb))
    np.testing.assert_array_equal(out.numpy(), want)
    with pltpu.force_tpu_interpret_mode():
        pallas = _nearest_indices_pallas(jnp.asarray(x), jnp.asarray(cb))
    np.testing.assert_array_equal(np.asarray(pallas), want)


def test_quantize_lookup_counts_and_perplexity_match():
    x, cb = _data(200, seed=5)
    q_ref, idx_ref = j_lookup(jnp.asarray(x), jnp.asarray(cb))
    cb_t = torch.from_numpy(cb).requires_grad_(True)
    q, idx = tq.quantize_lookup(torch.from_numpy(x), cb_t)
    assert_same_argmin(idx.numpy(), np.asarray(idx_ref), _distances(x, cb))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(q_ref))
    # gradients reach the codebook through the gather: d sum(q) / d c_k is
    # the count of rows that picked code k
    q.sum().backward()
    counts = tq.codebook_usage_counts(idx, K)
    np.testing.assert_array_equal(cb_t.grad.numpy(),
                                  np.repeat(counts.numpy()[:, None], D, 1))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(j_counts(idx_ref, K)))
    # perplexity: exp of a sum of K float32 terms; 1e-6 relative
    for c in (counts, torch.tensor([1.0, 1.0, 1.0, 1.0]),
              torch.zeros(K)):
        np.testing.assert_allclose(
            tq.perplexity_from_counts(c).numpy(),
            np.asarray(j_perplexity(jnp.asarray(c.numpy()))), rtol=1e-6)


@pytest.mark.parametrize("n,k,sms,want", [
    (4096, 1024, 132, 8),     # flagship train batch: 32 row tiles
    (32768, 1024, 132, 2),    # a large encode batch: 256 row tiles
    (37, 16, 132, 1),         # one code tile cannot be split
    (512, 1024, 132, 8),      # a small batch splits K into single tiles
    (4096, 1000, 132, 8),     # ragged K
])
def test_k_splits_fill_the_card(n, k, sms, want):
    splits = tq.k_splits(n, k, sms)
    assert splits == want
    # the CUDA entry's own check: each split owns at least one code tile
    tiles = -(-k // tq.CODES_PER_TILE)
    per = -(-tiles // splits)
    assert -(-tiles // per) == splits


def test_cpu_tensors_take_the_plain_version_without_counting():
    x, cb = _data(64, seed=6)
    tq.reset_launches()
    out = tq.nearest_codebook_indices(torch.from_numpy(x),
                                      torch.from_numpy(cb))
    assert tq.launches == 0
    np.testing.assert_array_equal(
        out.numpy(), tq._nearest_indices_reference(
            torch.from_numpy(x), torch.from_numpy(cb)).numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    # The wrapper never computes the plain version: a tensor it cannot
    # launch on is an error, not a fallback.
    x, cb = _data(8, seed=7)
    tq.reset_launches()
    with pytest.raises(ValueError, match="cpu"):
        tq.nearest_codebook_indices_cuda(torch.from_numpy(x),
                                         torch.from_numpy(cb))
    assert tq.launches == 0


@pytest.mark.parametrize("kind,cls", [
    ("ste", "VectorQuantizerSTE"), ("ema", "VectorQuantizerEMA"),
    ("ema_sonnet", "VectorQuantizerEMASonnet"), ("nsvq", "NSVQ"),
    ("rnsvq", "RNSVQ")])
def test_make_quantizer_builds_every_kind(kind, cls):
    q = make_quantizer(QuantizerConfig(kind=kind, num_embeddings=K,
                                       embedding_dim=D, num_stages=3))
    assert type(q).__name__ == cls
    # the EMA kinds' codebook is state, not a parameter
    params = dict(q.named_parameters())
    assert ("codebook" in params) == (kind in ("ste", "nsvq"))
    assert ("codebooks" in params) == (kind == "rnsvq")
    with pytest.raises(ValueError, match="unknown quantizer kind"):
        make_quantizer(QuantizerConfig(kind=kind + "x"))


def test_kernel_source_names_the_tpu_kernel_and_its_bound():
    src = os.path.join(os.path.dirname(tq.__file__), os.pardir, "csrc",
                       tq.KERNEL + ".cu")
    with open(src) as f:
        text = f.read()
    assert "ldm3d/ops/quantize.py::_nearest_kernel" in text
    assert "bound by operations" in text
    assert 'extern "C" int codebook_nearest(' in text
    assert "cudaGetLastError" in text
    assert "sm_90a" in text


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d,dtype", [
    (4096, 1024, 256, torch.float32),   # flagship train shape
    (4095, 1024, 256, torch.bfloat16),  # ragged N
    (37, 16, 8, torch.float32),         # the tiny slice
    (4096, 1024, 20, torch.float32),    # D = 20, no multiple of 8
])
def test_cuda_kernel_matches_plain(n, k, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    cb = torch.randn(k, d, generator=gen, device="cuda")
    cb[k // 2] = cb[1]                       # a duplicate: the first wins
    x[0] = cb[1].to(dtype)
    tq.reset_launches()
    out = tq.nearest_codebook_indices(x, cb)
    torch.cuda.synchronize()
    assert tq.launches == 1
    ref = tq._nearest_indices_reference(x, cb)
    assert int(out[0]) == 1
    cbv = cb.to(dtype).double()
    dist = (cb.double() ** 2).sum(-1)[None] - 2.0 * x.double() @ cbv.T
    rows = torch.arange(n, device="cuda")
    gap = (dist[rows, out.long()] - dist[rows, ref.long()]).abs().max()
    assert torch.equal(out, ref) or float(gap) <= 1e-3

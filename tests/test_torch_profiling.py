"""The port's profiling helpers (`ldm3d_torch.utils.profiling`) against
the JAX package's, on the CPU: `StepTimer`'s summary keys and arithmetic,
`flops_estimate` of a Dense and of a conv3d against JAX's (XLA's cost
analysis), `cost_estimate`'s bytes, and `trace` writing a Chrome trace.
`profile_steps` measures the GPU; here it refuses, and its card run is
`chip_smoke.py`'s profile phase.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ldm3d.utils import profiling as jprof
from ldm3d_torch.utils import profiling as prof
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# XLA's cost analysis counts a dense layer's bias add (one flop per
# output) and the matmul at 2 per multiply-add; FlopCounterMode counts
# the matmul only: 1 / (2 * fan_in) apart, 1.6 % at fan_in 32; 5 %.
# Convolutions differ by the padding: XLA counts the taps that fall
# inside the input, FlopCounterMode the whole window at every output
# position (23 % more at 8^3, k3, SAME). The conv test states both
# counts exactly.
FLOPS_RTOL = 0.05


def test_step_timer_keys_equal_jax():
    ours, ref = prof.StepTimer(warmup=1), jprof.StepTimer(warmup=1)
    x = torch.randn(64, 64)
    for _ in range(4):
        out, dt = ours.time_step(torch.matmul, x, x)
        ref.time_step(jnp.matmul, jnp.ones((64, 64)), jnp.ones((64, 64)))
        assert out.shape == (64, 64) and dt > 0
    got = ours.summary()
    assert list(got) == list(ref.summary())
    assert got["steps"] == 3.0
    times = np.asarray(ours._times)
    assert got["mean_s"] == pytest.approx(times.mean())
    assert got["steps_per_s"] == pytest.approx(1.0 / times.mean())
    assert prof.StepTimer().summary() == jprof.StepTimer().summary() == {}


@pytest.mark.parametrize("b,fin,fout", [(8, 32, 64), (16, 256, 128)])
def test_dense_flops_equal_jax(b, fin, fout):
    x, w = np.ones((b, fin), np.float32), np.ones((fin, fout), np.float32)
    bias = np.ones(fout, np.float32)
    ref = jprof.flops_estimate(lambda x, w, c: x @ w + c, x, w, bias)
    got = prof.flops_estimate(F.linear, torch.from_numpy(x),
                              torch.from_numpy(w.T.copy()),
                              torch.from_numpy(bias))
    assert got == 2 * b * fin * fout
    np.testing.assert_allclose(got, ref, rtol=FLOPS_RTOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3d_flops_equal_jax(stride):
    x = np.ones((2, 8, 8, 8, 4), np.float32)
    w = np.ones((3, 3, 3, 4, 16), np.float32)

    def jconv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (stride,) * 3, "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    ref = jprof.flops_estimate(jconv, x, w)
    got = prof.flops_estimate(
        lambda a, k: F.conv3d(a, k, stride=stride, padding=1),
        torch.from_numpy(x).permute(0, 4, 1, 2, 3),
        torch.from_numpy(w).permute(4, 3, 0, 1, 2))
    out = 8 // stride
    assert got == 2 * 2 * out ** 3 * 16 * 4 * 27
    # taps inside the input per dim, summed over the output positions
    lo = max((out - 1) * stride + 3 - 8, 0) // 2
    valid = sum(0 <= i * stride - lo + k < 8 for i in range(out)
                for k in range(3))
    assert ref == 2 * 2 * valid ** 3 * 16 * 4


def test_cost_estimate_counts_every_op_bytes():
    """The unfused upper bound: each op's inputs and outputs, so a matmul
    and an add count the intermediate twice (written, then read)."""
    a, b = torch.ones(4, 8), torch.ones(8, 2)
    c = torch.ones(4, 2)
    got = prof.cost_estimate(lambda: torch.matmul(a, b) + c)
    assert got["flops"] == 2 * 4 * 8 * 2
    mm = 4 * (a.numel() + b.numel() + c.numel())        # a, b in; 4x2 out
    add = 4 * 3 * c.numel()                             # two in, one out
    assert got["bytes_accessed"] == mm + add


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with prof.trace(logdir):
        torch.matmul(torch.ones(32, 32), torch.ones(32, 32))
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names


def test_profile_steps_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        prof.profile_steps(lambda: None, 1, 1.0)


@pytest.mark.gpu
def test_profile_steps_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(256, 256, device="cuda")
    out = prof.profile_steps(lambda: torch.relu(x @ x), 3, 1.0)
    assert out["kernels_per_step"] >= 2
    assert out["groups_ms_per_step"]["gemm (cuBLAS)"] > 0

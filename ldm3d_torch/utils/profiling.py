"""Profiling: the port of `ldm3d.utils.profiling`.

  - `trace(logdir)`: a `torch.profiler` trace of the host and, where a GPU
    is visible, the device, written as a Chrome trace under `logdir`
    (the CLI's `--profile`; open it in Perfetto or chrome://tracing).
  - `StepTimer`: wall-clock step timing that synchronises the device
    before it reads the clock, so asynchronous launches do not fake the
    numbers; p50 / p90 and steps/s with the JAX package's keys.
  - `flops_estimate` / `cost_estimate`: operations (and bytes) of one call,
    counted while it runs.
  - `profile_steps`: device time by kernel over a few steps, grouped by
    kind, and the device's busy share.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


def _activities() -> list:
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write `<host>_<pid>.<ns>.pt.trace.json`
    (a Chrome trace) under `logdir`."""
    from torch.profiler import profile, tensorboard_trace_handler
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities(),
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Times steps correctly: the device is synchronised before the clock
    is read. The first `warmup` steps are timed but not summarised."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: List[float] = []
        self._seen = 0

    def time_step(self, fn, *args, **kwargs):
        _sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync()
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)
        return out, dt

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": float(len(arr)),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "steps_per_s": float(1.0 / arr.mean()),
        }


def flops_estimate(fn, *args) -> float:
    """Floating-point operations of `fn(*args)`, counted by
    `torch.utils.flop_counter.FlopCounterMode` while it runs: matrix
    products and convolutions at 2 per multiply-add; elementwise work
    (bias adds, activations, norms) is not counted."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.nelement() * t.element_size()
        return out


def cost_estimate(fn, *args) -> Dict[str, float]:
    """{"flops": `flops_estimate`'s count, "bytes_accessed": the sum over
    the aten ops `fn(*args)` runs of each op's input and output bytes}.
    The bytes are an unfused upper bound: every op is counted as if it
    read its inputs from and wrote its outputs to device memory, views
    included, where a fused program (XLA's, whose analysis the JAX package
    reports) keeps intermediates on chip."""
    with FlopCounterMode(display=False) as counter, _BytesMode() as moved:
        fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float(moved.bytes)}


# Kernel groups of `profile_steps`: the first whose words match a kernel's
# name (lower case, by substring) takes its time; TOP_KERNELS are listed.
TOP_KERNELS = 15
KERNEL_GROUPS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("voxel_attention kernel", ("voxel_attention",)),
    ("codebook kernel", ("codebook_nearest",)),
    ("adam + ema (foreach)", ("multi_tensor_apply",)),
    ("norm", ("norm", "welford", "bn_fw", "bn_bw")),
    ("layout (cuDNN NCHW <-> NHWC)", ("nchwtonhwc", "nhwctonchw")),
    ("conv (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad")),
    ("gemm (cuBLAS)", ("gemm", "gemv", "kernel2")),
    ("reduce", ("reduce",)),
    ("copy / cat / pad", ("copy", "cat", "pad", "index", "gather",
                          "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_steps(fn: Callable[[], object], steps: int,
                  step_ms: float) -> dict:
    """Device time by kernel over `steps` calls of `fn` (torch.profiler,
    host and device), grouped by kind (`KERNEL_GROUPS`), with the kernels
    and device ms per step, the TOP_KERNELS longest, and the device's busy
    share against `step_ms`, the step's time measured without the
    profiler (whose own host work slows the step). Needs a GPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise RuntimeError("profile_steps measures the GPU: none is visible")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and e.self_device_time_total > 0), key=lambda k: -k[1])
    by_group: Dict[str, float] = {name: 0.0 for name, _ in KERNEL_GROUPS}
    by_group["other"] = 0.0
    for name, ms, _ in kernels:
        group = next((g for g, words in KERNEL_GROUPS
                      if any(w in name.lower() for w in words)), "other")
        by_group[group] += ms
    device_ms = sum(ms for _, ms, _ in kernels)
    return dict(steps=steps, step_ms=step_ms,
                profiled_wall_ms_per_step=wall_ms / steps,
                device_ms_per_step=device_ms,
                busy_share=device_ms / step_ms,
                kernels_per_step=sum(n for _, _, n in kernels),
                groups_ms_per_step=by_group,
                top=[[name[:90], ms, n] for name, ms, n in
                     kernels[:TOP_KERNELS]])


"""Build and load the port's CUDA kernels.

Each kernel is one `csrc/*.cu` file with a plain `extern "C"` interface (no
PyTorch headers), compiled by `nvcc` for sm_90a into a shared library and
loaded with `ctypes`; the kernels share `csrc/*.cuh`. The library goes
into `ldm3d_torch/_build/` under a name that carries a hash of the source,
the shared headers and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is. The compiler writes to a
temporary name that is renamed into place: there is no lock file.
`load_all` starts one nvcc per missing source, all at once, and waits for
each.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def copy_bytes(row_bytes: int) -> int:
    """Byte width of one shared-memory staging copy, as the kernels take it,
    for matrix rows of `row_bytes` bytes: 16 where the rows allow it, else
    4, else 2 (bfloat16 of odd width), so that no copy straddles two
    rows."""
    return 16 if row_bytes % 16 == 0 else 4 if row_bytes % 4 == 0 else 2


@dataclass
class Built:
    name: str
    path: str            # the shared library
    seconds: float       # time spent building (0 when it was already built)
    ptxas: str           # what `-Xptxas -v` printed: registers, smem, spills
    lib: ctypes.CDLL


_LOADED: Dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


@dataclass
class _Job:
    name: str
    so: str
    log: str
    tmp: str = ""
    proc: Optional[subprocess.Popen] = None
    t0: float = 0.0


def _start(name: str) -> _Job:
    """Start nvcc on `csrc/<name>.cu` unless its library is built."""
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")
    job = _Job(name, so, so + ".ptxas.txt")
    if not os.path.exists(so):
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, job.tmp = tempfile.mkstemp(prefix=f".{name}_", suffix=".so",
                                       dir=BUILD_DIR)
        os.close(fd)
        job.t0 = time.perf_counter()
        job.proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", job.tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return job


def _finish(job: _Job) -> Built:
    """Wait for the job's nvcc (if any) and load the library."""
    seconds, ptxas = 0.0, ""
    if job.proc is not None:
        try:
            _, ptxas = job.proc.communicate()
            if job.proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {job.name}.cu:\n{ptxas}")
            os.replace(job.tmp, job.so)
        finally:
            if os.path.exists(job.tmp):
                os.remove(job.tmp)
        seconds = time.perf_counter() - job.t0
        with open(job.log, "w") as f:
            f.write(ptxas)
    elif os.path.exists(job.log):
        with open(job.log) as f:
            ptxas = f.read()
    return Built(job.name, job.so, seconds, ptxas, ctypes.CDLL(job.so))


def load_all(names: Sequence[str]) -> List[Built]:
    """The kernel libraries `csrc/<name>.cu`, built at first use: one nvcc
    per missing source, all started together, each waited for."""
    jobs, failure = [], None
    for name in dict.fromkeys(names):
        if name not in _LOADED:
            try:
                jobs.append(_start(name))
            except Exception as e:   # wait for the started ones first
                failure = e
                break
    for job in jobs:
        try:
            _LOADED[job.name] = _finish(job)
        except Exception as e:
            failure = failure or e
    if failure is not None:
        raise failure
    return [_LOADED[n] for n in names]


def load(name: str) -> Built:
    """The kernel library `csrc/<name>.cu`, built at first use."""
    return load_all([name])[0]

"""ctypes binding of the port's native cache reader (`csrc/dataio.cpp`):
the port of `ldm3d.data.native`.

The library is built with g++ at first use into `ldm3d_torch/_build/`,
under a name that carries a hash of the source and the flags. The compiler
writes to a temporary name that is renamed into place, so processes that
start together (test workers) each build or load a whole library, never a
half-written one. Without a compiler, or when the build fails,
`NativeReader.maybe_create` returns None and the loaders read with numpy,
as the JAX package's do.
"""

from __future__ import annotations

import ast
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dataio.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> str:
    """Where the library for this source and these flags lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libldm3d_dataio_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".dataio_", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ldm3d_pool_create.restype = ctypes.c_void_p
    lib.ldm3d_pool_create.argtypes = [ctypes.c_int]
    lib.ldm3d_pool_destroy.restype = None
    lib.ldm3d_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.ldm3d_pool_submit_raw.restype = None
    lib.ldm3d_pool_submit_raw.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.ldm3d_pool_wait.restype = ctypes.c_int64
    lib.ldm3d_pool_wait.argtypes = [ctypes.c_void_p]
    lib.ldm3d_read_f16_as_f32.restype = ctypes.c_int
    lib.ldm3d_read_f16_as_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The reader's library, built first if needed; None when it cannot be
    built or loaded (then every later call returns None at once)."""
    global _lib, _failed
    with _lock:
        if _lib is None and not _failed:
            path = library_path()
            try:
                if not os.path.exists(path):
                    _build(path)
                _lib = _bind(ctypes.CDLL(path))
            except (OSError, subprocess.SubprocessError):
                _failed = True
    return _lib


def npy_f16_layout(path: str) -> Tuple[int, Tuple[int, ...]]:
    """(data_offset, shape) of a little-endian float16 C-order .npy file.
    Raises ValueError for anything else (the cache always writes f16)."""
    with open(path, "rb") as f:
        if f.read(6) != b"\x93NUMPY":
            raise ValueError(f"{path}: not a .npy file")
        major = f.read(2)[0]
        hlen = int.from_bytes(f.read(2 if major == 1 else 4), "little")
        header = f.read(hlen).decode("latin1")
        offset = f.tell()
    d = ast.literal_eval(header)
    if not isinstance(d, dict):
        raise ValueError(f"{path}: malformed .npy header")
    if d.get("descr") not in ("<f2", "|f2"):
        raise ValueError(f"{path}: dtype {d.get('descr')} is not float16")
    if d.get("fortran_order"):
        raise ValueError(f"{path}: fortran order unsupported")
    return offset, tuple(d["shape"])


class NativeReader:
    """A thread pool of the native library: `read_npy(path)` reads one
    volume widened to float32, `read_batch_f16(paths, out)` a batch at
    cache precision (the loader's path)."""

    def __init__(self, lib: ctypes.CDLL, n_threads: int = 4):
        self._lib = lib
        self._pool = lib.ldm3d_pool_create(n_threads)
        self._layouts: Dict[str, Tuple[int, Tuple[int, ...]]] = {}

    @classmethod
    def maybe_create(cls, n_threads: int = 4) -> Optional["NativeReader"]:
        lib = load_library()
        return cls(lib, n_threads) if lib is not None else None

    def close(self) -> None:
        if self._pool:
            self._lib.ldm3d_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        if getattr(self, "_pool", None):
            self.close()

    def _layout(self, path: str) -> Tuple[int, Tuple[int, ...]]:
        out = self._layouts.get(path)
        if out is None:
            out = self._layouts[path] = npy_f16_layout(path)
        return out

    def read_npy(self, path: str) -> np.ndarray:
        """One cached volume, widened to float32."""
        offset, shape = self._layout(path)
        out = np.empty(shape, np.float32)
        rc = self._lib.ldm3d_read_f16_as_f32(
            path.encode(), offset,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
        if rc != 0:
            raise OSError(f"native read failed ({rc}): {path}")
        return out

    def read_batch_f16(self, paths: Sequence[str], out: np.ndarray) -> None:
        """Fill out[i] from paths[i] in parallel at cache precision (out:
        a C-contiguous [N, ...] float16 array; raw reads)."""
        if out.dtype != np.float16 or not out.flags.c_contiguous \
                or len(out) != len(paths):
            raise ValueError(f"out must be a C-contiguous float16 array of "
                             f"{len(paths)} rows")
        per = int(np.prod(out.shape[1:]))
        layouts = [self._layout(path) for path in paths]
        for path, (_, shape) in zip(paths, layouts):
            if int(np.prod(shape)) != per:
                raise ValueError(f"{path}: shape {shape} != batch slot")
        # every job is checked before the first is queued: none may write
        # into `out` after this call has raised
        for i, (path, (offset, _)) in enumerate(zip(paths, layouts)):
            dst = ctypes.cast(out.ctypes.data + i * per * 2,
                              ctypes.POINTER(ctypes.c_uint8))
            self._lib.ldm3d_pool_submit_raw(self._pool, path.encode(),
                                            offset, dst, per * 2)
        errors = self._lib.ldm3d_pool_wait(self._pool)
        if errors:
            raise OSError(f"{errors} native reads failed")

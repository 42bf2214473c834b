"""The port's native cache reader (`ldm3d_torch/data/native.py` over
`ldm3d_torch/csrc/dataio.cpp`) against `np.load` and the JAX package's
reader, on the CPU: the `.npy` layout parser, single reads widened to
float32, raw float16 batches (the loader's path), the `DataLoader` on
the native path, and six processes building the library at once.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldm3d.data import native as jnative
from ldm3d_torch.core.config import DataConfig
from ldm3d_torch.data import native, pipeline
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cache"))
    pipeline.write_synthetic_cache(d, 5, SIZE, seed=1, num_classes=4,
                                   device="cpu")
    return d


@pytest.fixture(scope="module")
def reader():
    r = native.NativeReader.maybe_create()
    assert r is not None, "the native reader did not build"
    return r


def _files(cache):
    return sorted(os.path.join(cache, n) for n in os.listdir(cache)
                  if n.endswith(".npy"))


@pytest.mark.parametrize("shape,version", [((4, 3, 2, 1), (1, 0)),
                                           ((7,), (2, 0)), ((), (1, 0))])
def test_layout_parser_equals_jax(tmp_path, shape, version):
    path = str(tmp_path / "a.npy")
    arr = np.arange(int(np.prod(shape)), dtype=np.float16).reshape(shape)
    with open(path, "wb") as f:
        np.lib.format.write_array(f, arr, version=version)
    got = native.npy_f16_layout(path)
    assert got == jnative.npy_f16_layout(path)
    offset, parsed = got
    assert parsed == shape
    assert os.path.getsize(path) == offset + 2 * arr.size


def test_layout_parser_refuses_other_files(tmp_path):
    for name, arr in (("f32.npy", np.zeros(3, np.float32)),
                      ("fortran.npy", np.asfortranarray(
                          np.zeros((2, 3), np.float16)))):
        np.save(tmp_path / name, arr)
        with pytest.raises(ValueError):
            native.npy_f16_layout(str(tmp_path / name))
    (tmp_path / "text.npy").write_bytes(b"not a numpy file")
    with pytest.raises(ValueError, match="not a .npy file"):
        native.npy_f16_layout(str(tmp_path / "text.npy"))


def test_read_npy_equals_np_load_and_jax(cache, reader):
    jreader = jnative.NativeReader.maybe_create()
    for path in _files(cache):
        got = reader.read_npy(path)
        ref = np.load(path)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref.astype(np.float32))
        if jreader is not None:
            np.testing.assert_array_equal(got, jreader.read_npy(path))


def test_batches_equal_np_load(cache, reader):
    paths = _files(cache)[:4]
    ref = np.stack([np.load(p) for p in paths])
    raw = np.empty(ref.shape, np.float16)
    reader.read_batch_f16(paths, raw)
    assert raw.tobytes() == ref.tobytes()
    with pytest.raises(ValueError, match="float16"):
        reader.read_batch_f16(paths, np.empty(ref.shape, np.float32))
    with pytest.raises(ValueError, match="batch slot"):
        reader.read_batch_f16(paths, np.empty((4, 3), np.float16))
    with pytest.raises(OSError):
        reader.read_npy(os.path.join(cache, "missing.npy"))


@pytest.mark.parametrize("augment", [False, True])
def test_dataloader_reads_natively(cache, augment):
    """The loader on the native path equals the numpy path, bit for bit,
    and says which reader it used."""
    cfg = DataConfig(volume_size=SIZE, augment=augment)
    loaders = []
    for use_native in (True, False):
        vc = pipeline.VolumeCache(cache)
        if not use_native:
            vc.reader = None
        loaders.append(pipeline.DataLoader(vc, 2, cfg, seed=3, train=True,
                                           device="cpu"))
    assert [ld.reader for ld in loaders] == ["native", "numpy"]
    for _ in range(2):
        for a, b in zip(*(list(ld) for ld in loaders)):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x, y)


_BUILD = """
import sys
sys.path.insert(0, {repo!r})
from ldm3d_torch.data import native
native.BUILD_DIR = {build!r}
lib = native.load_library()
assert lib is not None
print(native.library_path())
"""


def test_six_processes_build_at_once(tmp_path):
    """Six processes that find no library build it together: each loads a
    whole library, and one file is left, no temporary ones."""
    build = str(tmp_path / "build")
    code = _BUILD.format(repo=REPO, build=build)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert os.listdir(build) == [os.path.basename(paths.pop())]

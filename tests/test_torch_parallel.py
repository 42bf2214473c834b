"""The port's `parallel/` package on the CPU: the mesh's decisions against
`ldm3d.parallel.mesh.make_mesh`, `initialize`'s refusal, each process's
batch rows, the loaders' rows against the one-process batch, and
`halo_conv3d` over two gloo processes (tests/torch_dist_workers.py)
against JAX's `halo_conv3d` on a 2-device 'space' mesh and the unsharded
conv, forward and backward.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ldm3d.core.config import MeshConfig as JMeshConfig
from ldm3d.parallel import mesh as jmesh
from ldm3d.parallel.halo import halo_conv3d as j_halo_conv3d
from ldm3d_torch.core.config import DataConfig, MeshConfig
from ldm3d_torch.data.pipeline import (DataLoader, DeviceSyntheticLoader,
                                       LatentLoader, VolumeCache,
                                       write_synthetic_cache)
from ldm3d_torch.parallel import distributed as pdist
from ldm3d_torch.parallel.mesh import (Mesh, local_batch_size, make_mesh,
                                       mesh_shape, shard_batch)
from torch_dist_workers import launch

# (devices, MeshConfig fields, global batch)
MESHES = [
    (8, {}, None), (8, {}, 12), (8, dict(data=4, space=2), None),
    (8, dict(space=2), 6), (2, dict(data=2), 4), (4, dict(model=2), 4),
    (6, {}, 4), (4, dict(data=3), None), (2, dict(data=4), None),
    (1, {}, 3),
]


def _outcome(fn):
    """("shape", tuple) or ("error", message), and the warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = ("shape", tuple(fn()))
        except ValueError as e:
            out = ("error", str(e))
    return out, [str(w.message) for w in caught
                 if issubclass(w.category, UserWarning)]


@pytest.mark.parametrize("processes", [1, 2])
@pytest.mark.parametrize("n,fields,batch", MESHES)
def test_mesh_shape_matches_jax(n, fields, batch, processes, monkeypatch):
    """Shapes, the submesh warning (one process) or the "exclude" error
    (several), "does not fit" and "does not cover", as JAX decides them
    over the first n of the conftest's virtual devices."""
    monkeypatch.setattr(jax, "process_count", lambda: processes)
    ref = _outcome(lambda: jmesh.make_mesh(
        JMeshConfig(**fields), devices=jax.devices()[:n],
        batch_size=batch).devices.shape)
    got = _outcome(lambda: mesh_shape(MeshConfig(**fields), n, batch,
                                      num_processes=processes))
    assert got == ref


def test_make_mesh_in_one_process():
    mesh = make_mesh(MeshConfig(), batch_size=8)
    assert mesh.shape == {"data": 1, "space": 1, "model": 1}
    assert mesh.world_size == 1 and mesh.groups == {}
    assert shard_batch(mesh, torch.arange(4)).tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="does not fit on 1 devices"):
        make_mesh(MeshConfig(data=2))
    with pytest.raises(ValueError, match="a mesh over 2 processes"):
        make_mesh(MeshConfig(), world_size=2)


def test_initialize_refuses_a_coordinator_without_processes(monkeypatch):
    for var in ("LDM3D_COORDINATOR", "LDM3D_NUM_PROCESSES",
                "LDM3D_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert pdist.initialize() is False
    with pytest.raises(ValueError, match="num_processes"):
        pdist.initialize("127.0.0.1:1", 1, 0, platform="cpu")
    monkeypatch.setenv("LDM3D_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="num_processes"):
        pdist.initialize(platform="cpu")
    assert not pdist.is_initialized()


def _mesh(rank, data=2, space=1):
    return Mesh({"data": data, "space": space, "model": 1}, rank=rank)


def test_local_batch_rows():
    assert pdist.local_batch_rows(None, 8) is None
    assert pdist.local_batch_rows(make_mesh(), 8) is None
    assert pdist.local_batch_rows(_mesh(0), 8) == range(0, 4)
    assert pdist.local_batch_rows(_mesh(1), 8) == range(4, 8)
    # data-major: the two space neighbours of a data row share its rows
    assert [pdist.local_batch_rows(_mesh(r, 2, 2), 8)
            for r in range(4)] == [range(0, 4)] * 2 + [range(4, 8)] * 2
    assert local_batch_size(_mesh(0), 8) == 4
    with pytest.raises(ValueError, match="not divisible"):
        pdist.local_batch_rows(_mesh(1), 7)
    x = torch.arange(16).reshape(8, 2)
    assert torch.equal(shard_batch(_mesh(1), {"x": x, "n": None})["x"],
                       x[4:])


def _batches(loader):
    return [tuple(t.clone() for t in b) for b in loader]


def test_loaders_give_each_process_its_rows_of_the_batch(tmp_path):
    """Each process's batches, augmentation draws included, are its rows
    of the one-process batches, bit for bit: the cache loader, the
    device-data loader (train and val order) and the latent loader."""
    cfg = DataConfig(volume_size=16, augment=True, augment_fraction=1.0)
    write_synthetic_cache(str(tmp_path), 8, 16, seed=3, device="cpu")
    cache = VolumeCache(str(tmp_path))
    lat = torch.randn(10, 2, 2, 2, 4)
    ctx = torch.arange(10)

    def loaders(mesh):
        return [DataLoader(cache, 4, cfg, seed=1, device="cpu", mesh=mesh),
                DeviceSyntheticLoader(8, 4, cfg, corpus_seed=3, seed=1,
                                      device="cpu", mesh=mesh),
                DeviceSyntheticLoader(8, 4, cfg, corpus_seed=3, seed=1,
                                      train=False, device="cpu", mesh=mesh),
                LatentLoader(lat, ctx, 4, seed=2, mesh=mesh)]

    for whole, *parts in zip(*(loaders(m) for m in
                               (None, _mesh(0), _mesh(1)))):
        for epoch in range(2):
            ref = _batches(whole)
            got = [_batches(p) for p in parts]
            assert len(ref) == len(got[0]) == len(got[1]) == len(whole)
            for i, batch in enumerate(ref):
                for j, t in enumerate(batch):
                    assert torch.equal(
                        torch.cat([got[0][i][j], got[1][i][j]]), t), \
                        (type(whole).__name__, epoch, i, j)


HALO_CASES = [(3, 1), (4, 2), (1, 1), (4, 1)]


def _ref_conv(x, k, b, stride):
    """Unsharded TF-'same' conv in torch: NDHWC, kernel DHWIO."""
    pads = []
    for kk in reversed(k.shape[:3]):
        total = max(kk - stride, 0)
        pads += [total // 2, total - total // 2]
    xc = F.pad(x.permute(0, 4, 1, 2, 3), pads)
    out = F.conv3d(xc, k.permute(4, 3, 0, 1, 2), stride=stride)
    return out.permute(0, 2, 3, 4, 1) + b


@pytest.fixture(scope="module")
def halo(tmp_path_factory):
    """Each case's inputs, JAX's sharded output, and the two workers'
    output rows and gradients."""
    d = tmp_path_factory.mktemp("halo")
    rng = np.random.default_rng(0)
    jm = jmesh.make_mesh(JMeshConfig(data=1, space=2),
                         devices=jax.devices()[:2])
    spec, jax_out = [], []
    for kernel, stride in HALO_CASES:
        x = rng.standard_normal((2, 16, 8, 8, 3)).astype(np.float32)
        k = (0.1 * rng.standard_normal((kernel,) * 3 + (3, 5))).astype(
            np.float32)
        b = (0.1 * rng.standard_normal(5)).astype(np.float32)
        g = rng.standard_normal((2, 16 // stride, 8 // stride, 8 // stride,
                                 5)).astype(np.float32)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(
            jm, P(None, jmesh.SPACE_AXIS, None, None, None)))
        jax_out.append(np.asarray(j_halo_conv3d(xs, jnp.asarray(k),
                                                jnp.asarray(b), stride, jm,
                                                shard_axis=1)))
        spec.append({"x": torch.from_numpy(x), "kernel": torch.from_numpy(k),
                     "bias": torch.from_numpy(b), "g": torch.from_numpy(g),
                     "stride": stride})
    torch.save(spec, d / "halo_in.pt")
    return spec, jax_out, launch("halo", d)


@pytest.mark.parametrize("case", range(len(HALO_CASES)),
                         ids=[f"k{k}s{s}" for k, s in HALO_CASES])
def test_halo_conv3d_matches_jax_and_the_unsharded_conv(halo, case):
    spec, jax_out, ranks = halo
    c = spec[case]
    y = torch.cat([r[case]["y"] for r in ranks], dim=1)
    dx = torch.cat([r[case]["dx"] for r in ranks], dim=1)
    # the tolerance of JAX's own halo test (tests/test_parallel.py)
    np.testing.assert_allclose(y.numpy(), jax_out[case], rtol=2e-5,
                               atol=2e-5)
    x, k, b = (c[key].clone().requires_grad_(True)
               for key in ("x", "kernel", "bias"))
    ref = _ref_conv(x, k, b, c["stride"])
    (ref * c["g"]).sum().backward()
    for got, want in ((y, ref.detach()), (dx, x.grad),
                      (ranks[0][case]["dk"], k.grad),
                      (ranks[0][case]["db"], b.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-5)
    # the kernel's and bias's gradients are equal on both ranks
    assert torch.equal(ranks[0][case]["dk"], ranks[1][case]["dk"])

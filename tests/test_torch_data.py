"""The port's data layer against the JAX package, on the CPU.

Synthetic volumes (each class, JAX's draws injected), the class draw, the
cache format in both directions, the `DataLoader`'s order and batches,
the augmentation with JAX's draws, `LatentLoader` and `train_val_split`,
and the NIfTI reader and transforms on files written in `tmp_path`.
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.core.config import DataConfig as JDataConfig
from ldm3d.data import nifti as jnifti
from ldm3d.data import pipeline as jpipe
from ldm3d.data.synthetic import _batch_classes as j_batch_classes
from ldm3d.data.synthetic import _one_volume as j_one_volume
from ldm3d_torch.core.config import DataConfig
from ldm3d_torch.data import nifti, pipeline
from ldm3d_torch.data.synthetic import (_batch_classes, _one_volume,
                                        synthetic_batch)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

SIZE = 16
# Synthetic volumes: the texture is sin(x * f * pi + phase) with arguments
# up to 15 pi + 2 pi = 53, whose float32 spacing is 3.8e-6; XLA's fused
# sine and torch's round such an argument's product and sine differently,
# and the grid (jnp.linspace against torch.linspace) differs by up to
# 1.8e-7. At amplitude 0.3 that moves a voxel by about 1e-6 per factor;
# up to 2.9e-6 was measured at 16^3 and 32^3 after the min-max
# normalisation. 5e-6 absolute; the masks are equal.
SYNTH_ATOL = 5e-6
# Augmentation: a per-volume mean of 16^3 float32 values in other orders
# than XLA's, then one product and two clips; 1e-6 absolute.
AUG_ATOL = 1e-6
# NIfTI transforms: the same numpy and scipy calls on both sides.
NIFTI_ATOL = 1e-6


def _jax_volume_draws(key):
    """`_one_volume`'s draws from its key, in JAX's split order."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return dict(radii=np.array(jax.random.uniform(k1, (3,))),
                center=np.array(jax.random.normal(k2, (3,))),
                freq=np.array(jax.random.uniform(k3, (3,))),
                phase=np.array(jax.random.uniform(k4, (3,))))


@pytest.mark.parametrize("cls", [0, 1, 2, 3])
def test_one_volume_matches_jax(cls):
    one = jax.jit(j_one_volume, static_argnums=2)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        jv, jm = one(key, jnp.int32(cls), SIZE)
        draws = {k: torch.from_numpy(v)
                 for k, v in _jax_volume_draws(key).items()}
        v, m = _one_volume(cls, SIZE, draws, device="cpu")
        assert v.shape == (SIZE, SIZE, SIZE, 1) == m.shape
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                                   atol=SYNTH_ATOL)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


@pytest.mark.parametrize("num_classes", [2, 4])
def test_batch_classes_match_jax(num_classes):
    rng = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(jax.random.fold_in(rng, 7), (64,)))
    ref = np.asarray(j_batch_classes(rng, 64, 0.5, num_classes))
    got = _batch_classes(torch.from_numpy(u), 0.5, num_classes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(got.tolist()) <= set(range(num_classes))


def test_synthetic_batch_draws_and_injection():
    """A seed gives one corpus; injected draws reproduce it."""
    g = torch.Generator().manual_seed(0)
    u = torch.rand(3, generator=g)
    from ldm3d_torch.data.synthetic import volume_draws
    draws = [volume_draws(g) for _ in range(3)]
    a = synthetic_batch(torch.Generator().manual_seed(0), 3, 8,
                        num_classes=4, device="cpu")
    b = synthetic_batch(None, 3, 8, num_classes=4, device="cpu", class_u=u,
                        draws=draws)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].shape == (3, 8, 8, 8, 1) and a[2].dtype == torch.int32
    assert 0.0 <= float(a[0].min()) and float(a[0].max()) <= 1.0


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_cache"))
    jpipe.write_synthetic_cache(d, 5, SIZE, seed=0, num_classes=4)
    return d


@pytest.fixture(scope="module")
def port_cache(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_cache"))
    pipeline.write_synthetic_cache(d, 5, SIZE, seed=0, num_classes=4,
                                   device="cpu")
    return d


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_readable_by_both(writer, jax_cache, port_cache):
    d = jax_cache if writer == "jax" else port_cache
    jc, pc = jpipe.VolumeCache(d), pipeline.VolumeCache(d)
    assert len(jc) == len(pc) == 5 and pc.volume_size == SIZE
    man = _manifest(d)
    assert set(man) == {"entries", "volume_size", "num_classes"}
    for i in range(5):
        ji, jm, jctx = jc.read(i)
        pi, pm, pctx = pc.read(i)
        assert pi.dtype == np.float16 and pi.shape == (SIZE, SIZE, SIZE, 1)
        np.testing.assert_array_equal(pi, np.asarray(ji))
        np.testing.assert_array_equal(pm, np.asarray(jm))
        assert pctx == jctx == man["entries"][i]["context"]


def test_cache_files_identical_layout(jax_cache, port_cache):
    """The same file names, .npy headers and manifest keys, bit for bit
    where the content is the same: the port's writer re-saving JAX's
    arrays reproduces JAX's files."""
    assert sorted(os.listdir(jax_cache)) == sorted(os.listdir(port_cache))
    jm, pm = _manifest(jax_cache), _manifest(port_cache)
    assert [e["stem"] for e in jm["entries"]] == \
        [e["stem"] for e in pm["entries"]]
    assert {k for e in jm["entries"] for k in e} == \
        {k for e in pm["entries"] for k in e}
    for name in os.listdir(jax_cache):
        if not name.endswith(".npy"):
            continue
        with open(os.path.join(jax_cache, name), "rb") as f:
            jraw = f.read()
        with open(os.path.join(port_cache, name), "rb") as f:
            praw = f.read()
        assert len(jraw) == len(praw)
        hdr = 128   # numpy 1.0-format header of these files
        assert jraw[:hdr] == praw[:hdr]


def _port_loader(d, train, indices, augment=False, bs=2):
    cfg = DataConfig(volume_size=SIZE, augment=augment)
    return pipeline.DataLoader(pipeline.VolumeCache(d), bs, cfg, seed=3,
                               train=train, indices=indices, device="cpu")


def _jax_loader(d, train, indices, bs=2):
    cfg = JDataConfig(volume_size=SIZE)
    return jpipe.DataLoader(jpipe.VolumeCache(d), bs, cfg, seed=3,
                            train=train, indices=indices)


@pytest.mark.parametrize("train", [True, False])
def test_dataloader_order_matches_jax(jax_cache, train):
    tr, _ = pipeline.train_val_split(5, 0.2, seed=3)
    pl, jl = _port_loader(jax_cache, train, tr), _jax_loader(jax_cache,
                                                             train, tr)
    assert len(pl) == len(jl) == 2
    for _ in range(2):   # two epochs: the shuffle moves with the epoch
        pb, jb = list(pl), list(jl)
        assert len(pb) == len(jb) == 2
        for (pv, pm, pc), (jv, jm, jc) in zip(pb, jb):
            assert pv.dtype == torch.float32 and pc.dtype == torch.int32
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
            np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


def test_dataloader_augments_and_raises_reader_errors(port_cache):
    pl = _port_loader(port_cache, True, None, augment=True)
    plain = _port_loader(port_cache, True, None)
    for (v, m, _), (v0, m0, _) in zip(pl, plain):
        assert 0.0 <= float(v.min()) and float(v.max()) <= 1.0
        assert not torch.equal(v, v0)   # brightness/contrast moved it
    os.rename(os.path.join(port_cache, "vol_00001_img.npy"),
              os.path.join(port_cache, "moved.npy"))
    try:
        with pytest.raises(FileNotFoundError):
            list(_port_loader(port_cache, False, None))
    finally:
        os.rename(os.path.join(port_cache, "moved.npy"),
                  os.path.join(port_cache, "vol_00001_img.npy"))


def test_augment_matches_jax_draws():
    b = 6
    rng = np.random.default_rng(0)
    vol = rng.random((b, SIZE, SIZE, SIZE, 1), dtype=np.float32)
    mask = (rng.random((b, SIZE, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    cfg = JDataConfig()
    key = jax.random.PRNGKey(5)
    jv, jm = jpipe.augment_batch(key, jnp.asarray(vol), jnp.asarray(mask),
                                 cfg)
    k1, k2, k3 = jax.random.split(key, 3)
    shape = (b, 1, 1, 1, 1)
    u = np.array(jax.random.uniform(k1, shape))
    bright = np.array(jax.random.uniform(k2, shape, minval=0.9, maxval=1.1))
    cont = np.array(jax.random.uniform(k3, shape, minval=0.9, maxval=1.1))
    assert (u < cfg.flip_chance).any() and (u >= cfg.flip_chance).any()
    pv, pm = pipeline.augment_batch(
        torch.from_numpy(vol), torch.from_numpy(mask), DataConfig(),
        flip_u=torch.from_numpy(u), brightness=torch.from_numpy(bright),
        contrast=torch.from_numpy(cont))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0,
                               atol=AUG_ATOL)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


def test_latent_loader_matches_jax():
    n, bs = 7, 2
    lat = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    ctx = np.arange(n, dtype=np.int32)
    jl = jpipe.LatentLoader(jnp.asarray(lat), jnp.asarray(ctx), bs, seed=4)
    pl = pipeline.LatentLoader(torch.from_numpy(lat), torch.from_numpy(ctx),
                               bs, seed=4)
    assert len(pl) == len(jl) == 3
    for _ in range(3):
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 3
        for (jlat, jctx), (plat, pctx) in zip(jb, pb):
            np.testing.assert_array_equal(plat.numpy(), np.asarray(jlat))
            np.testing.assert_array_equal(pctx.numpy(), np.asarray(jctx))
    with pytest.raises(ValueError):
        pipeline.LatentLoader(torch.zeros(1, 3), torch.zeros(1), 2)


@pytest.mark.parametrize("n,frac,seed", [(24, 0.1, 0), (6, 0.34, 0),
                                         (10, 0.0, 1), (5, 0.2, 3)])
def test_train_val_split_matches_jax(n, frac, seed):
    assert pipeline.train_val_split(n, frac, seed) == \
        jpipe.train_val_split(n, frac, seed)


def _write(path, vol, voxsize=(1.0, 1.0, 1.0)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    nifti.save_nifti(path, vol, voxsize=voxsize)


@pytest.fixture(scope="module")
def nifti_tree(tmp_path_factory):
    """The reference's directory layout, written with the port's
    save_nifti: CC359 with its STAPLE mask, BraTS with its segmentation,
    HCP, NFBS with its brain mask."""
    d = str(tmp_path_factory.mktemp("mri"))
    rng = np.random.default_rng(0)
    vol = rng.uniform(0.0, 100.0, size=(24, 20, 28)).astype(np.float32)
    m = np.zeros_like(vol)
    m[6:18, 5:15, 7:21] = 1.0
    seg = np.zeros_like(vol)
    seg[8:12, 8:12, 8:12] = 4.0
    j = os.path.join
    _write(j(d, "CC359", "Original", "s1.nii.gz"), vol)
    _write(j(d, "CC359", "STAPLE", "s1_staple.nii.gz"), m)
    _write(j(d, "BraTS2021", "c1", "c1_t1.nii.gz"), vol, (2, 2, 2))
    _write(j(d, "BraTS2021", "c1", "c1_seg.nii.gz"), seg, (2, 2, 2))
    _write(j(d, "HCP_T1", "T1", "h1.nii.gz"), vol, (1.2, 1.0, 0.9))
    nfbs = j(d, "NFBS_Dataset", "a", "sub-1_ses-NFB3_T1w_brain.nii.gz")
    _write(nfbs, vol)
    _write(nfbs[:-7] + "mask.nii.gz", m)
    return d


@pytest.mark.parametrize("kind", ["CC", "BraTS", "HCP", "NFBS"])
def test_load_transform_img_matches_jax(nifti_tree, kind):
    path = nifti.get_dataset_list(kind, dataset_dir=nifti_tree)[0]
    pv, pm, pc = nifti.load_transform_img(path)
    jv, jm, jc = jnifti.load_transform_img(path)
    assert pv.shape == (128, 128, 128, 1) and pc == jc
    assert pc == (1 if kind == "BraTS" else 0)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=NIFTI_ATOL)
    np.testing.assert_allclose(pm, jm, rtol=0, atol=NIFTI_ATOL)


def test_get_dataset_list_matches_jax(nifti_tree):
    for kind in ("CC", "NFBS", "HCP", "BraTS", "all", "all-T"):
        for test_run in (False, True):
            assert nifti.get_dataset_list(kind, test_run, nifti_tree) == \
                jnifti.get_dataset_list(kind, test_run, nifti_tree)
    assert len(nifti.get_dataset_list("all-T", dataset_dir=nifti_tree)) == 4


def test_load_nifti_qform_and_big_endian(tmp_path):
    """The qform affine (sform_code 0, a rotation quaternion, qfac -1) and
    a big-endian file read as the JAX reader reads them."""
    vol = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
    raw = bytearray(nifti.nifti_bytes(vol, voxsize=(1.5, 2.0, 2.5)))
    struct.pack_into("<2h", raw, 252, 1, 0)           # qform only
    struct.pack_into("<6f", raw, 256, 0.1, 0.2, 0.3, 4.0, -5.0, 6.0)
    struct.pack_into("<f", raw, 76, -1.0)             # qfac
    little = str(tmp_path / "q.nii")
    with open(little, "wb") as f:
        f.write(bytes(raw))
    # the same file big-endian: header fields and data byte-swapped
    big = bytearray(352)
    for off, fmt in ((0, "i"), (40, "8h"), (70, "h"), (72, "h"),
                     (76, "8f"), (108, "f"), (112, "f"), (252, "2h"),
                     (256, "6f"), (280, "12f")):
        struct.pack_into(">" + fmt, big, off,
                         *struct.unpack_from("<" + fmt, raw, off))
    big[344:348] = raw[344:348]
    data = np.frombuffer(bytes(raw[352:]), "<f4").astype(">f4").tobytes()
    bpath = str(tmp_path / "b.nii.gz")
    import gzip
    with gzip.open(bpath, "wb") as f:
        f.write(bytes(big) + data)
    for path in (little, bpath):
        pv, pa, ps = nifti.load_nifti(path, return_voxsize=True)
        jv, ja, js = jnifti.load_nifti(path, return_voxsize=True)
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pa, ja)
        assert ps == js == (1.5, 2.0, 2.5)
        np.testing.assert_array_equal(pv, vol)
    assert not np.allclose(pa[:3, :3], np.diag([1.5, 2.0, 2.5]))


def test_build_cache_matches_jax(nifti_tree, tmp_path):
    paths = nifti.get_dataset_list("CC", dataset_dir=nifti_tree)
    pcfg = DataConfig(cache_dir=str(tmp_path / "p"))
    jcfg = JDataConfig(cache_dir=str(tmp_path / "j"))
    pipeline.build_cache(pcfg, paths, verbose=False)
    jpipe.build_cache(jcfg, paths, verbose=False)
    assert _manifest(pcfg.cache_dir) == _manifest(jcfg.cache_dir)
    pc, jc = pipeline.VolumeCache(pcfg.cache_dir), \
        jpipe.VolumeCache(jcfg.cache_dir)
    for i in range(len(pc)):
        for a, b in zip(pc.read(i)[:2], jc.read(i)[:2]):
            np.testing.assert_array_equal(a, np.asarray(b))

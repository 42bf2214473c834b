"""`DeviceSyntheticLoader` (`--device_data`) against `DataLoader` over the
port's own cache (`write_synthetic_cache` for the same seed), on the CPU:
the same batches bit for bit, in order, over the same split, with the
same per-epoch shuffle and the same augmentation, for 2 and 4 classes;
the epoch's length; and `synthetic_volumes_at` against the cache files.

The JAX package's loader is held to the JAX package's files, which come
from other random number generators; the port's to the port's.
"""

import os

import numpy as np
import pytest
import torch

from ldm3d_torch.core.config import DataConfig
from ldm3d_torch.data import pipeline
from ldm3d_torch.data.synthetic import (corpus_draws, one_at,
                                        synthetic_batch, synthetic_dataset,
                                        synthetic_volumes_at)

SIZE, N, SEED = 8, 11, 5


@pytest.fixture(scope="module", params=[2, 4])
def corpus(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(f"cache{request.param}"))
    pipeline.write_synthetic_cache(d, N, SIZE, seed=SEED,
                                   num_classes=request.param, device="cpu")
    return d, request.param


def _loaders(d, num_classes, train, indices, augment, bs):
    cfg = DataConfig(volume_size=SIZE, augment=augment,
                     num_classes=num_classes)
    cached = pipeline.DataLoader(pipeline.VolumeCache(d), bs, cfg, seed=3,
                                 train=train, indices=indices, device="cpu")
    device = pipeline.DeviceSyntheticLoader(
        N, bs, cfg, corpus_seed=SEED, seed=3, train=train, indices=indices,
        device="cpu")
    return cached, device


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_batches_equal_the_cache_loader(corpus, train, augment):
    d, num_classes = corpus
    tr, va = pipeline.train_val_split(N, 0.3, seed=3)
    idx = tr if train else va
    cached, device = _loaders(d, num_classes, train, idx, augment, bs=3)
    assert len(device) == len(cached) == len(idx) // 3
    for _ in range(3):            # the shuffle moves with the epoch
        a, b = list(cached), list(device)
        assert len(a) == len(b) == len(device)
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and u.shape == v.shape
                assert torch.equal(u, v)


def test_shuffle_and_length(corpus):
    d, num_classes = corpus
    _, device = _loaders(d, num_classes, True, None, False, bs=4)
    assert len(device) == N // 4
    ctx = [[int(c) for _, _, cs in device for c in cs] for _ in range(2)]
    assert ctx[0] != ctx[1] or len(set(ctx[0])) == 1
    contexts = [c for c, _ in corpus_draws(SEED, N,
                                           num_classes=num_classes)]
    order = np.arange(N)
    np.random.default_rng(3).shuffle(order)
    assert ctx[0] == [contexts[i] for i in order[:len(ctx[0])]]


def test_volumes_at_equal_the_cache_files(corpus):
    d, num_classes = corpus
    draws = corpus_draws(SEED, N, num_classes=num_classes)
    vol, mask, ctx = synthetic_volumes_at(draws, [0, 9, 3], SIZE, "cpu")
    assert vol.dtype == torch.float32 and ctx.dtype == torch.int32
    for row, i in enumerate([0, 9, 3]):
        stem = os.path.join(d, f"vol_{i:05d}")
        np.testing.assert_array_equal(vol[row].numpy(),
                                      np.load(stem + "_img.npy")
                                      .astype(np.float32))
        np.testing.assert_array_equal(mask[row].numpy(),
                                      np.load(stem + "_mask.npy")
                                      .astype(np.float32))
    v, m, c = one_at(draws, 9, SIZE, "cpu")
    assert c == int(ctx[1]) and v.shape == (SIZE,) * 3 + (1,)


def test_corpus_draws_replay_synthetic_batch():
    """The first group of the corpus is `synthetic_batch`'s draw from the
    same seed; `synthetic_dataset` draws batches in sequence."""
    draws = corpus_draws(SEED, 3, gen_batch=3, num_classes=4)
    ref = synthetic_batch(torch.Generator().manual_seed(SEED), 3, SIZE,
                          num_classes=4, device="cpu")
    for i in range(3):
        vol, mask, cls = one_at(draws, i, SIZE, "cpu")
        assert torch.equal(vol, ref[0][i]) and torch.equal(mask, ref[1][i])
        assert cls == int(ref[2][i])
    batches = list(synthetic_dataset(SEED, 2, 3, SIZE, device="cpu"))
    gen = torch.Generator().manual_seed(SEED)
    for batch in batches:
        for x, y in zip(batch, synthetic_batch(gen, 3, SIZE, device="cpu")):
            assert torch.equal(x, y)

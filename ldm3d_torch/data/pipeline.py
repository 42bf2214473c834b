"""Preprocess-once volume cache and the loaders of training: the port of
`ldm3d.data.pipeline`.

The cache is the JAX package's, in both directions: one float16 `.npy`
pair per volume (`vol_00000_img.npy`, `vol_00000_mask.npy`, [S, S, S, 1])
and a `manifest.json` of entries {stem, context, source} and the volume
size. `DataLoader` visits a cache in the JAX loader's order: the epoch's
shuffle is `np.random.default_rng(seed + epoch)`, and the augmentation
generator is seeded from that generator's next `integers(2**31)` draw.
Batches are read on a thread (a bounded queue of `prefetch` batches), by
the native reader's thread pool (`data/native.py`) where it builds and by
numpy otherwise, moved to the device at the cache's float16 and widened
there. `DeviceSyntheticLoader` (`--device_data`) computes the synthetic
corpus's batches on the device instead, equal to `DataLoader`'s over the
cache `write_synthetic_cache` writes for the same seed. `LatentLoader`
serves the latents of `--cache_latents` from the device, in one
`np.random.default_rng(seed).permutation` per epoch, dropping the ragged
tail as the JAX loader does.

With a `mesh` of several processes (`parallel.mesh.make_mesh`), every
process walks the same seeded global order and yields only its rows of
each global batch (`parallel.distributed.local_batch_rows`), the
augmentation's draws included: those are made for the global batch and
sliced, so that the processes' batches together are the one-process
batch, bit for bit.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ldm3d_torch.core.config import DataConfig
from ldm3d_torch.core.device import resolve_device
from ldm3d_torch.parallel.distributed import local_batch_rows
from ldm3d_torch.parallel.mesh import local_depth

MANIFEST = "manifest.json"


# ---------------------------------------------------------------------------
# Cache construction (--create_dataset)
# ---------------------------------------------------------------------------


def build_cache(cfg: DataConfig, paths: Optional[Sequence[str]] = None,
                verbose: bool = True) -> str:
    """Preprocess NIfTI files once into `cfg.cache_dir`
    (`nifti.load_transform_img` of each; the dataset's files by default)."""
    from ldm3d_torch.data.nifti import get_dataset_list, load_transform_img

    os.makedirs(cfg.cache_dir, exist_ok=True)
    if paths is None:
        paths = get_dataset_list(cfg.dataset, cfg.test_run, cfg.dataset_dir)
    entries = []
    for i, path in enumerate(paths):
        vol, mask, context = load_transform_img(path)
        stem = f"vol_{i:05d}"
        np.save(os.path.join(cfg.cache_dir, stem + "_img.npy"),
                vol.astype(np.float16))
        np.save(os.path.join(cfg.cache_dir, stem + "_mask.npy"),
                mask.astype(np.float16))
        entries.append({"stem": stem, "context": context, "source": path})
        if verbose and (i + 1) % 25 == 0:
            print(f"cached {i + 1}/{len(paths)} volumes")
    with open(os.path.join(cfg.cache_dir, MANIFEST), "w") as f:
        json.dump({"entries": entries, "volume_size": cfg.volume_size}, f)
    return cfg.cache_dir


def write_synthetic_cache(cache_dir: str, num_volumes: int, size: int = 64,
                          seed: int = 0, gen_batch: int = 8,
                          num_classes: int = 2, device=None) -> str:
    """Write a synthetic corpus (`synthetic.synthetic_batch`) as a cache.
    The draws come from one CPU generator seeded with `seed`, in groups of
    `gen_batch` volumes; the volumes are computed on `device` (the GPU
    unless "cpu" is given)."""
    from ldm3d_torch.data.synthetic import synthetic_batch

    device = resolve_device(device)
    os.makedirs(cache_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    entries = []
    for start in range(0, num_volumes, gen_batch):
        b = min(gen_batch, num_volumes - start)
        vol, mask, ctx = synthetic_batch(gen, b, size,
                                         num_classes=num_classes,
                                         device=device)
        vol = vol.to(torch.float16).cpu().numpy()
        mask = mask.to(torch.float16).cpu().numpy()
        for j in range(b):
            stem = f"vol_{start + j:05d}"
            np.save(os.path.join(cache_dir, stem + "_img.npy"), vol[j])
            np.save(os.path.join(cache_dir, stem + "_mask.npy"), mask[j])
            entries.append({"stem": stem, "context": int(ctx[j]),
                            "source": "synthetic"})
    with open(os.path.join(cache_dir, MANIFEST), "w") as f:
        json.dump({"entries": entries, "volume_size": size,
                   "num_classes": num_classes}, f)
    return cache_dir


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


class VolumeCache:
    """Random-access view over a cache directory. `reader` is the native
    reader (`data/native.py`), or None where it does not build."""

    def __init__(self, cache_dir: str):
        from ldm3d_torch.data.native import NativeReader

        with open(os.path.join(cache_dir, MANIFEST)) as f:
            manifest = json.load(f)
        self.cache_dir = cache_dir
        self.entries = manifest["entries"]
        self.volume_size = manifest["volume_size"]
        self.reader = NativeReader.maybe_create()

    def paths(self, idx: int) -> Tuple[str, str]:
        stem = os.path.join(self.cache_dir, self.entries[idx]["stem"])
        return stem + "_img.npy", stem + "_mask.npy"

    def __len__(self) -> int:
        return len(self.entries)

    def read(self, idx: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """(img, mask) as cached, float16, and the context."""
        img, mask = self.paths(idx)
        return np.load(img), np.load(mask), self.entries[idx]["context"]


def _epoch_plan(loader) -> Tuple[np.ndarray, torch.Generator]:
    """The next epoch of a volume loader: its visiting order (shuffled
    with `np.random.default_rng(seed + epoch)` when training) and its
    augmentation generator, seeded from that generator's next draw."""
    rng = np.random.default_rng(loader.seed + loader.epoch)
    loader.epoch += 1
    order = np.array(loader.indices)
    if loader.train:
        rng.shuffle(order)
    return order, torch.Generator(device=loader.device).manual_seed(
        int(rng.integers(2 ** 31)))


class DataLoader:
    """Shuffled, batched loader with host prefetch on a thread and
    augmentation on the device. Yields (vol [B, S, S, S, 1] float32,
    mask float32, context [B] int32), all on `device` (the GPU unless
    "cpu" is given); drops the ragged tail. `reader` says what reads the
    files: "native" (the cache's `NativeReader`) or "numpy". `batch_size`
    is the global batch; with a `mesh` each batch holds this process's
    rows of it, and over a 'space' axis its depth slab of each volume
    (the rows are read and augmented whole, since the contrast factor
    reads each volume's mean, then sliced on the device)."""

    def __init__(self, cache: VolumeCache, batch_size: int, cfg: DataConfig,
                 seed: int = 0, train: bool = True,
                 indices: Optional[Sequence[int]] = None,
                 prefetch: int = 2, device=None, mesh=None):
        self.cache = cache
        self.batch_size = batch_size
        self.rows = local_batch_rows(mesh, batch_size)
        self.depth = local_depth(mesh, cache.volume_size)
        self.cfg = cfg
        self.seed = seed
        self.train = train
        self.indices = list(indices if indices is not None
                            else range(len(cache)))
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self.reader = "native" if cache.reader is not None else "numpy"
        self.epoch = 0

    def seek(self, epoch: int) -> None:
        """Make the next pass the loader's `epoch`-th (0 is the first):
        its order and augmentation (a recovered run replays an epoch)."""
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.indices) // self.batch_size

    def _host_batches(self, order: np.ndarray) -> Iterator:
        """(img, mask, ctx) numpy batches, float16 as cached; they are
        widened on the device."""
        bs_global, reader = self.batch_size, self.cache.reader
        s = self.cache.volume_size
        for i in range(len(order) // bs_global):
            idxs = [int(j) for j in _rows_of(order, i, bs_global, self.rows)]
            bs = len(idxs)
            ctx = np.asarray([self.cache.entries[j]["context"]
                              for j in idxs], np.int32)
            if reader is None:
                rows = [self.cache.read(j) for j in idxs]
                yield (np.stack([r[0] for r in rows]),
                       np.stack([r[1] for r in rows]), ctx)
                continue
            imgs, masks = (np.empty((bs, s, s, s, 1), np.float16)
                           for _ in range(2))
            paths = [self.cache.paths(j) for j in idxs]
            reader.read_batch_f16([p[0] for p in paths], imgs)
            reader.read_batch_f16([p[1] for p in paths], masks)
            yield imgs, masks, ctx

    def __iter__(self) -> Iterator:
        order, aug_gen = _epoch_plan(self)

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._host_batches(order):
                    if not put(batch):
                        return
                put(done)
            except Exception as e:  # handed to the consumer, which raises
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                vol, mask, ctx = (torch.from_numpy(a).to(self.device)
                                  for a in item)
                vol, mask = vol.float(), mask.float()   # widen on device
                if self.train and self.cfg.augment:
                    vol, mask = augment_batch(vol, mask, self.cfg,
                                              generator=aug_gen,
                                              rows=self.rows,
                                              batch=self.batch_size)
                yield _slab(vol, self.depth), _slab(mask, self.depth), ctx
        finally:
            stop.set()
            t.join(timeout=10)


class DeviceSyntheticLoader:
    """The synthetic corpus of `write_synthetic_cache(seed=corpus_seed)`
    without the cache: each batch's volumes are computed on `device` from
    the corpus's draws (`synthetic.corpus_draws`, replayed once on the
    host), rounded to float16 and widened. Same order, split, per-epoch
    shuffle and augmentation as `DataLoader`, so the batches are equal to
    a `DataLoader`'s over that cache, bit for bit, on one device. With a
    `mesh`, this process's rows and depth slab, as `DataLoader`."""

    def __init__(self, num_volumes: int, batch_size: int, cfg: DataConfig,
                 corpus_seed: int = 0, seed: int = 0, train: bool = True,
                 indices: Optional[Sequence[int]] = None, device=None,
                 mesh=None):
        from ldm3d_torch.data.synthetic import corpus_draws

        self.batch_size = batch_size
        self.rows = local_batch_rows(mesh, batch_size)
        self.depth = local_depth(mesh, cfg.volume_size)
        self.cfg = cfg
        self.seed = seed
        self.train = train
        self.indices = list(indices if indices is not None
                            else range(num_volumes))
        self.device = resolve_device(device)
        self.corpus = corpus_draws(corpus_seed, num_volumes,
                                   num_classes=cfg.num_classes)
        self.epoch = 0

    def seek(self, epoch: int) -> None:
        """Make the next pass the loader's `epoch`-th (0 is the first):
        its order and augmentation (a recovered run replays an epoch)."""
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.indices) // self.batch_size

    def __iter__(self) -> Iterator:
        from ldm3d_torch.data.synthetic import synthetic_volumes_at

        order, aug_gen = _epoch_plan(self)
        bs = self.batch_size
        for i in range(len(order) // bs):
            vol, mask, ctx = synthetic_volumes_at(
                self.corpus, _rows_of(order, i, bs, self.rows),
                self.cfg.volume_size, self.device)
            if self.train and self.cfg.augment:
                vol, mask = augment_batch(vol, mask, self.cfg,
                                          generator=aug_gen, rows=self.rows,
                                          batch=bs)
            yield _slab(vol, self.depth), _slab(mask, self.depth), ctx


class LatentLoader:
    """The cached latents of `--cache_latents`, on their device: (latents
    [B, ...], context [B]) batches in a fresh permutation per epoch from
    `np.random.default_rng(seed)`, dropping the ragged tail. With a
    `mesh`, `latents` is the whole corpus on every process and each batch
    holds this process's rows of the global batch."""

    def __init__(self, latents: torch.Tensor, context: torch.Tensor,
                 batch_size: int, seed: int = 0, mesh=None):
        self.latents = latents
        self.context = context
        self.batch_size = int(batch_size)
        self.rows = local_batch_rows(mesh, self.batch_size)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.epoch = 0
        self.n = int(latents.shape[0])
        if self.n < self.batch_size:
            raise ValueError(
                f"{self.n} cached latents < batch size {self.batch_size}")

    def __len__(self):
        return self.n // self.batch_size

    def seek(self, epoch: int) -> None:
        """Make the next pass the loader's `epoch`-th (0 is the first)."""
        self._rng = np.random.default_rng(self.seed)
        for _ in range(epoch):
            self._rng.permutation(self.n)
        self.epoch = epoch

    def __iter__(self):
        order = torch.from_numpy(self._rng.permutation(self.n)).to(
            self.latents.device)
        self.epoch += 1
        bs = self.batch_size
        for i in range(self.n // bs):
            idx = _rows_of(order, i, bs, self.rows)
            yield (self.latents.index_select(0, idx),
                   self.context.index_select(0, idx))


def _slab(vol: torch.Tensor, depth: Optional[range]) -> torch.Tensor:
    """The depth slab `depth` of NDHWC volumes (all of them without)."""
    if depth is None:
        return vol
    return vol[:, :, :, depth.start:depth.stop].contiguous()


def _rows_of(order, i: int, bs: int, rows: Optional[range]):
    """Batch `i` of `order` in batches of `bs`: all of it, or its `rows`."""
    batch = order[i * bs:(i + 1) * bs]
    return batch if rows is None else batch[rows.start:rows.stop]


def train_val_split(cache, val_fraction: float, seed: int = 0):
    """(train indices, val indices), a seeded permutation split.
    `cache` is a VolumeCache or a volume count."""
    n = cache if isinstance(cache, int) else len(cache)
    order = np.random.default_rng(seed).permutation(n)
    n_val = max(int(n * val_fraction), 1) if val_fraction > 0 else 0
    return order[n_val:].tolist(), order[:n_val].tolist()


def augment_batch(vol: torch.Tensor, mask: torch.Tensor, cfg: DataConfig,
                  generator: Optional[torch.Generator] = None,
                  flip_u: Optional[torch.Tensor] = None,
                  brightness: Optional[torch.Tensor] = None,
                  contrast: Optional[torch.Tensor] = None,
                  rows: Optional[range] = None, batch: Optional[int] = None):
    """Per volume: flip axis 1 unless u < flip_chance, scale by the
    brightness factor and clip to [0, 1], then contrast c:
    clip((1 + c)(vol - mean) + mean, 0, 1). The draws, [B] or
    [B, 1, 1, 1, 1] (u in [0, 1), the factors in their ranges), come from
    `generator` unless injected. With `rows`, `vol` is those rows of a
    global batch of `batch` volumes: the draws are made for the global
    batch and sliced."""
    b, dev = vol.shape[0], vol.device
    shape = (b, 1, 1, 1, 1)

    def draw(x, lo, hi):
        if x is None:
            if rows is None:
                u = torch.rand(shape, generator=generator, device=dev)
            else:
                u = torch.rand((batch, 1, 1, 1, 1), generator=generator,
                               device=dev)[rows.start:rows.stop]
            return u if lo is None else lo + (hi - lo) * u
        return torch.as_tensor(x, dtype=torch.float32).to(dev).reshape(shape)

    keep = draw(flip_u, None, None) < cfg.flip_chance
    vol = torch.where(keep, vol, torch.flip(vol, dims=[1]))
    mask = torch.where(keep, mask, torch.flip(mask, dims=[1]))
    factor = draw(brightness, *cfg.brightness_range)
    vol = torch.clamp(vol * factor, 0.0, 1.0)
    cf = draw(contrast, *cfg.contrast_range)
    mean = vol.mean(dim=(1, 2, 3, 4), keepdim=True)
    vol = torch.clamp((1.0 + cf) * (vol - mean) + mean, 0.0, 1.0)
    return vol, mask

"""Synthetic MRI-like volumes: the port of `ldm3d.data.synthetic`.

A smooth ellipsoidal "brain" with internal texture, a binary mask channel
and a class token, normalised to [0, 1]:
  0  healthy brain (low-frequency texture)
  1  a focal lesion at a fixed site
  2  texture at 2.5x the frequency and half the amplitude
  3  two larger lesions at fixed sites and an elongated brain

The formulas are the JAX package's. Each volume's random draws (radii u,
centre normal, frequencies u, phases u) and each batch's class draw u can
be injected, so a test can hand over JAX's draws. Drawn here, they come
from a CPU `torch.Generator`, so a corpus does not depend on the device it
is computed on. The same seed gives a different corpus from the JAX
package's, because the two random number generators differ; the on-disk
cache format is shared (`pipeline.write_synthetic_cache`), so a corpus
written by either package trains both.

`corpus_draws` replays the generator of `write_synthetic_cache` for a
whole corpus (a few scalars per volume), and `synthetic_volumes_at`
computes any of its volumes from those draws on the device, rounded to
float16 and widened as the cache delivers them (`--device_data`).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ldm3d_torch.core.device import resolve_device

# fixed sites of the class-1 and class-3 lesions
_LESION = 0.3
_C3A = (-0.35, -0.2, 0.25)
_C3B = (0.05, 0.4, -0.3)


def volume_draws(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One volume's draws, in the JAX package's order of use: radii
    U[0, 1) x 3, centre N(0, 1) x 3, frequencies U[0, 1) x 3, phases
    U[0, 1) x 3 (float32, CPU)."""
    return dict(radii=torch.rand(3, generator=generator),
                center=torch.randn(3, generator=generator),
                freq=torch.rand(3, generator=generator),
                phase=torch.rand(3, generator=generator))


def _coords(size: int, device) -> torch.Tensor:
    """[size, size, size, 3] grid over [-1, 1]^3, indexing "ij"."""
    lin = torch.linspace(-1.0, 1.0, size, dtype=torch.float32,
                         device=device)
    return torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1)


def _one_volume(cls: int, size: int, draws: Dict[str, torch.Tensor],
                device=None):
    """One volume [size^3, 1] and its mask [size^3, 1] (float32, on
    `device`: the GPU unless "cpu" is given) of class `cls` from its draws
    (`volume_draws`)."""
    device = resolve_device(device)
    d = {k: torch.as_tensor(v, dtype=torch.float32).to(device)
         for k, v in draws.items()}
    coords = _coords(size, device)
    radii = 0.55 + 0.2 * d["radii"]
    if cls == 3:   # elongated, smaller brain
        radii = radii * torch.tensor([0.8, 1.15, 0.72], device=device)
    center = 0.1 * d["center"]
    dist = torch.sum(((coords - center) / radii) ** 2, dim=-1)
    brain = torch.sigmoid((1.0 - dist) * 12.0)
    freq = 3.0 + 3.0 * d["freq"]
    if cls == 2:
        freq = freq * 2.5
    phase = 2.0 * torch.pi * d["phase"]
    tex = (torch.sin(coords[..., 0] * freq[0] * torch.pi + phase[0])
           * torch.sin(coords[..., 1] * freq[1] * torch.pi + phase[1])
           * torch.sin(coords[..., 2] * freq[2] * torch.pi + phase[2]))
    amp = 0.15 if cls == 2 else 0.3
    vol = brain * (0.7 + amp * tex)
    mask = (brain > 0.5).float()
    if cls == 1:
        lesion = torch.sigmoid(
            (1.0 - torch.sum(((coords - _LESION) / 0.15) ** 2, dim=-1))
            * 20.0)
        vol = vol + 0.5 * lesion
        mask = torch.maximum(mask, (lesion > 0.5).float())
    elif cls == 3:
        ca = torch.tensor(_C3A, device=device)
        cb = torch.tensor(_C3B, device=device)
        l3 = (torch.sigmoid((1.0 - torch.sum(((coords - ca) / 0.22) ** 2,
                                             dim=-1)) * 20.0)
              + torch.sigmoid((1.0 - torch.sum(((coords - cb) / 0.18) ** 2,
                                               dim=-1)) * 20.0))
        vol = vol + 0.45 * l3
        mask = torch.maximum(mask, (l3 > 0.5).float())
    vol = (vol - vol.min()) / (vol.max() - vol.min() + 1e-8)
    return vol[..., None], mask[..., None]


def _batch_classes(u: torch.Tensor, tumor_fraction: float,
                   num_classes: int) -> torch.Tensor:
    """Class labels (int32) from one U[0, 1) draw per volume: with 2
    classes u < tumor_fraction, else floor(u * num_classes) capped at
    num_classes - 1."""
    if num_classes == 2:
        return (u < tumor_fraction).to(torch.int32)
    return torch.clamp((u * num_classes).to(torch.int32),
                       max=num_classes - 1)


def synthetic_batch(generator: Optional[torch.Generator], batch: int,
                    size: int = 128, tumor_fraction: float = 0.5,
                    num_classes: int = 2, device=None,
                    class_u: Optional[torch.Tensor] = None,
                    draws: Optional[list] = None):
    """(vol [B, S, S, S, 1], mask [B, S, S, S, 1], context [B] int32), the
    volumes on `device` (the GPU unless "cpu" is given). The class draw `class_u` [B] and the
    per-volume `draws` (a list of `volume_draws` dicts) come from the CPU
    `generator` unless injected: first the classes, then each volume's."""
    if class_u is None:
        class_u = torch.rand(batch, generator=generator)
    cls = _batch_classes(torch.as_tensor(class_u, dtype=torch.float32),
                         tumor_fraction, num_classes)
    if draws is None:
        draws = [volume_draws(generator) for _ in range(batch)]
    vols, masks = zip(*(_one_volume(int(c), size, dr, device)
                        for c, dr in zip(cls.tolist(), draws)))
    return torch.stack(vols), torch.stack(masks), cls


def corpus_draws(seed: int, num_volumes: int, gen_batch: int = 8,
                 tumor_fraction: float = 0.5, num_classes: int = 2
                 ) -> List[Tuple[int, Dict[str, torch.Tensor]]]:
    """(class, `volume_draws`) of every volume of the corpus
    `pipeline.write_synthetic_cache(seed=seed)` writes: one CPU generator
    seeded with `seed`, drawn in groups of `gen_batch` volumes, each group
    its class draws and then each volume's, as `synthetic_batch` draws."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for start in range(0, num_volumes, gen_batch):
        b = min(gen_batch, num_volumes - start)
        cls = _batch_classes(torch.rand(b, generator=gen), tumor_fraction,
                             num_classes)
        out += [(c, volume_draws(gen)) for c in cls.tolist()]
    return out


def one_at(corpus: Sequence, idx: int, size: int, device=None):
    """Volume `idx` of a corpus (`corpus_draws`): (vol [S, S, S, 1], mask
    [S, S, S, 1], class), float32 on `device`."""
    cls, draws = corpus[idx]
    return (*_one_volume(cls, size, draws, device), cls)


def synthetic_volumes_at(corpus: Sequence, idxs: Sequence[int], size: int,
                         device=None):
    """The corpus's volumes `idxs`, computed on `device` (the GPU unless
    "cpu" is given): (vol [B, S, S, S, 1], mask, context [B] int32),
    rounded to float16 and widened, so equal to what a loader over the
    cache delivers."""
    device = resolve_device(device)
    vols, masks, cls = zip(*(one_at(corpus, int(i), size, device)
                             for i in idxs))
    return (torch.stack(vols).half().float(),
            torch.stack(masks).half().float(),
            torch.tensor(cls, dtype=torch.int32, device=device))


def synthetic_dataset(seed: int, num_batches: int, batch: int,
                      size: int = 128, device=None) -> Iterator:
    """`num_batches` synthetic (vol, mask, context) batches
    (`synthetic_batch`) from one CPU generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(num_batches):
        yield synthetic_batch(gen, batch, size, device=device)

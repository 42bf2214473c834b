"""Vector quantizers: the port of `ldm3d.models.quantizers`.

The five kinds of `QuantizerConfig.kind`:
  - "ste"         VectorQuantizerSTE: straight-through, commitment beta +
                  codebook loss, codebook a parameter
  - "ema"         VectorQuantizerEMA: codebook updated by EMA cluster
                  statistics, with a data-dependent init on the first
                  training batch and random restart of dead codes
  - "ema_sonnet"  VectorQuantizerEMASonnet: EMA with Laplace-smoothed
                  cluster sizes and a commitment cost
  - "nsvq"        NSVQ: noise substitution in place of the straight-through
                  estimator
  - "rnsvq"       RNSVQ: residual multi-stage NSVQ, one codebook per stage

What the JAX package keeps in its "vq_stats" collection is buffers here
(`codebooks_used`; the EMA kinds' `codebook`, `ema_cluster_size`, `ema_w`
and `need_init`), changed in training mode only; the EMA kinds' codebook
is no parameter. Every quantizer takes x [..., D] (channels last) and
returns the quantized tensor of the same shape and a `QuantAux`.

Randomness comes from a `Draws` passed to `forward`: drawn from an
explicit `torch.Generator`, or injected (the tests feed the JAX package's
own draws this way). `replace_unused_codebooks` and its per-stage version
re-seed dead codes between epochs.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ldm3d_torch.ops.quantize import (codebook_gather, codebook_usage_counts,
                                      ema_statistics,
                                      nearest_codebook_indices,
                                      perplexity_from_counts)
from ldm3d_torch.parallel import spatial
from ldm3d_torch.parallel.distributed import all_gather_rows, all_reduce_sum


class QuantAux(NamedTuple):
    loss: torch.Tensor          # quantization loss term for the train loss
    perplexity: torch.Tensor    # exp entropy of code usage
    indices: torch.Tensor       # [...] int32 code indices (input minus D)
                                # ([..., S] for RNSVQ)
    usage_counts: torch.Tensor  # [K] ([S, K] for RNSVQ) float32 counts


class Draws:
    """The random draws of a training-mode pass, named after the JAX
    functions that make them: `bernoulli` (dropout keep masks), `normal`,
    `permutation`, `choice` and `randint` (the VQ-GAN's frame indices).
    Each comes from `generator` (which lives on
    the tensors' device), or, for a kind given as a list, from that list
    in call order.

    A draw made with `rows=True` has one row per batch row (dim 0 of
    `shape`). Under data parallelism `shard` is (index, count) along the
    data axis: such a draw is made (or injected) for the global batch,
    count x shape[0] rows, and this process takes its index-th block, so
    that N processes draw what one process draws on the global batch.
    A per-voxel draw names its depth axis (`depth`): over depth slabs
    (`parallel.spatial`) it is made for the whole depth, in the global
    order, and this process takes its slab. Per-sample draws are equal on
    every process of the space group."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 shard: Optional[Tuple[int, int]] = None,
                 **injected: List):
        self.generator = generator
        self.shard = shard
        self._injected = {k: list(v) for k, v in injected.items()}

    def _global(self, shape, rows: bool, depth: Optional[int] = None):
        shape = list(shape)
        if rows and self.shard is not None:
            shape[0] *= self.shard[1]
        if depth is not None:
            shape[depth] *= spatial.space_size()
        return tuple(shape)

    def _local(self, value: torch.Tensor, rows: bool,
               depth: Optional[int] = None) -> torch.Tensor:
        if rows and self.shard is not None:
            i, n = self.shard
            m = value.shape[0] // n
            value = value[i * m:(i + 1) * m]
        if depth is not None:
            value = spatial.scatter(value, depth)
        return value

    def _take(self, kind: str, make, device):
        if kind in self._injected:
            if not self._injected[kind]:
                raise ValueError(f"no injected {kind} draw left")
            value = self._injected[kind].pop(0)
            if isinstance(value, np.ndarray):
                value = value.copy()        # torch takes writable arrays
            return torch.as_tensor(value, device=device)
        if self.generator is None:
            raise ValueError(f"a {kind} draw needs a generator or an "
                             "injected value")
        return make(self.generator)

    def bernoulli(self, p: float, shape, device, rows: bool = False,
                  depth: Optional[int] = None) -> torch.Tensor:
        """bool [shape], True with probability p."""
        full = self._global(shape, rows, depth)
        return self._local(self._take("bernoulli", lambda g: torch.rand(
            full, generator=g, device=device) < p, device).bool(), rows,
            depth)

    def normal(self, shape, device, rows: bool = False,
               depth: Optional[int] = None) -> torch.Tensor:
        full = self._global(shape, rows, depth)
        return self._local(self._take("normal", lambda g: torch.randn(
            full, generator=g, device=device), device).float(), rows,
            depth)

    def permutation(self, n: int, device) -> torch.Tensor:
        return self._take("permutation", lambda g: torch.randperm(
            n, generator=g, device=device), device).long()

    def randint(self, low: int, high: int, shape, device,
                rows: bool = False) -> torch.Tensor:
        """Integers uniform in [low, high)."""
        full = self._global(shape, rows)
        return self._local(self._take("randint", lambda g: torch.randint(
            low, high, full, generator=g, device=device), device).long(),
            rows)

    def choice(self, p: torch.Tensor, num: int) -> torch.Tensor:
        """[num] indices drawn with replacement with probabilities p."""
        return self._take("choice", lambda g: torch.multinomial(
            p, num, replacement=True, generator=g), p.device).long()


def _draws(draws: Optional[Draws], who: str) -> Draws:
    if draws is None:
        raise ValueError(f"{who} in training mode needs its draws (a Draws "
                         "with a generator)")
    return draws


class Quantizer(nn.Module):
    """Base of the quantizers: `reset_parameters(generator)` is the JAX
    package's init, drawn from `generator`.

    With a process `group` (`parallel.mesh.attach_data_group`) the
    statistics JAX takes over the global batch are those of the group's
    batch: the usage counts (and so the perplexity and `codebooks_used`)
    in every mode, and in training the EMA kinds' cluster statistics and
    their random rows, drawn from the group's rows in rank order. The
    codebooks then stay equal on every process. Over depth slabs
    (`parallel.spatial`) the statistics are the data x space processes',
    and the random rows are drawn from the global batch's rows in its own
    order: each volume's depth gathered first, then the data group's
    rows."""

    group = None

    def __getstate__(self):
        # a process group neither pickles nor copies: a copy (the EMA
        # U-Net) is not attached to it
        return {**super().__getstate__(), "group": None}

    def _counts(self, indices: torch.Tensor) -> torch.Tensor:
        counts = codebook_usage_counts(indices, self.num_embeddings)
        group = spatial.stats_group(self.group)
        return counts if group is None else all_reduce_sum(counts, group)

    def _ema_statistics(self, flat, indices):
        counts, sums = ema_statistics(flat, indices, self.num_embeddings)
        group = spatial.stats_group(self.group)
        if group is not None:
            counts = all_reduce_sum(counts, group)
            if self.training:
                sums = all_reduce_sum(sums, group)
        return counts, sums

    def _global_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's rows [N, D] of x [..., D] in its order."""
        if x.dim() == 5:
            x = spatial.gather(x, spatial.SPATIAL_AXIS)
        flat = x.reshape(-1, x.shape[-1]).float()
        group = spatial.data_rows_group(self.group)
        return flat if group is None else all_gather_rows(flat, group)

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError


def _fan_in_uniform_(t: torch.Tensor, fan_in: int,
                     generator: torch.Generator) -> None:
    """flax variance_scaling(2.0, "fan_in", "uniform")."""
    a = math.sqrt(6.0 / fan_in)
    t.uniform_(-a, a, generator=generator)


class VectorQuantizerSTE(Quantizer):
    """Straight-through VQ with commitment + codebook loss; codebook
    [K, D]."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 beta: float = 0.25):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.beta = beta
        # the JAX init: variance_scaling(2.0, "fan_in", "uniform") with
        # fan_in = K for a [K, D] parameter
        a = math.sqrt(6.0 / num_embeddings)
        self.codebook = nn.Parameter(
            torch.empty(num_embeddings, embedding_dim).uniform_(-a, a))
        self.register_buffer("codebooks_used", torch.zeros(num_embeddings))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            _fan_in_uniform_(self.codebook, self.num_embeddings, generator)
            self.codebooks_used.zero_()

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None):
        flat = x.reshape(-1, self.embedding_dim)
        indices = nearest_codebook_indices(flat.float(), self.codebook)
        quantized = codebook_gather(self.codebook, indices).reshape(x.shape)

        commitment = torch.mean(torch.square(quantized.detach() - x))
        codebook_loss = torch.mean(torch.square(quantized - x.detach()))
        loss = self.beta * commitment + codebook_loss

        quantized = x + (quantized - x).detach()    # straight through

        counts = self._counts(indices)
        if self.training:
            with torch.no_grad():
                self.codebooks_used += counts
        aux = QuantAux(loss, perplexity_from_counts(counts),
                       indices.reshape(x.shape[:-1]), counts)
        return quantized, aux


def random_rows(flat: torch.Tensor, num: int, draws: Draws) -> torch.Tensor:
    """`num` random rows of `flat` [N, D]: when N < num the rows are first
    tiled to cover num and jittered with N(0, (0.01 / sqrt(D))^2) noise.
    Draws: one `normal` (only when tiling), one `permutation`."""
    n, d = flat.shape
    if n < num:
        tiled = flat.repeat(-(-num // n), 1)
        std = float(np.float32(0.01) / np.sqrt(np.float32(d)))
        flat = tiled + std * draws.normal(tiled.shape, flat.device)
        n = flat.shape[0]
    perm = draws.permutation(n, flat.device)[:num]
    return flat[perm]


class VectorQuantizerEMA(Quantizer):
    """EMA quantizer with a data-dependent init on the first training
    batch and random restart of dead codes. The codebook is a buffer,
    updated from EMA cluster statistics in training mode.

    On the initialising batch the codebook is the batch's random rows, and
    the codebook loss's gradient reaches the encoder through them, as in
    JAX; after it, through nothing. Draws in training mode: the init's
    random rows (every training step, as JAX), then the restart's (unless
    no_random_restart)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 beta: float = 0.25, decay: float = 0.99,
                 restart_thres: float = 1.0,
                 no_random_restart: bool = False):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.beta = beta
        self.decay = decay
        self.restart_thres = restart_thres
        self.no_random_restart = no_random_restart
        k, d = num_embeddings, embedding_dim
        self.register_buffer("codebook", torch.zeros(k, d))
        self.register_buffer("ema_cluster_size", torch.zeros(k))
        self.register_buffer("ema_w", torch.zeros(k, d))
        self.register_buffer("need_init", torch.tensor(True))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(-0.05, 0.05) codebook and EMA sums, zero cluster sizes, and
        the init still to come."""
        with torch.no_grad():
            self.codebook.uniform_(-0.05, 0.05, generator=generator)
            self.ema_w.uniform_(-0.05, 0.05, generator=generator)
            self.ema_cluster_size.zero_()
            self.need_init.fill_(True)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None):
        k, d = self.num_embeddings, self.embedding_dim
        flat = x.reshape(-1, d).float()
        codebook = self.codebook
        if self.training:
            draws = _draws(draws, "VectorQuantizerEMA")
            flat_all = self._global_rows(x)
            k_rand = random_rows(flat_all, k, draws)
            init = self.need_init.clone()   # saved for the backward
            codebook = torch.where(init, k_rand, self.codebook)
            with torch.no_grad():
                self.ema_w.copy_(torch.where(init, k_rand, self.ema_w))
                self.ema_cluster_size.copy_(torch.where(
                    init, torch.ones_like(self.ema_cluster_size),
                    self.ema_cluster_size))
                self.codebook.copy_(codebook)
                self.need_init.fill_(False)

        indices = nearest_codebook_indices(flat, codebook)
        quantized = codebook_gather(codebook, indices).reshape(x.shape)
        quantized = quantized.to(x.dtype)

        commitment = torch.mean(torch.square(quantized.detach() - x))
        codebook_term = torch.mean(torch.square(x.detach() - quantized))
        loss = self.beta * commitment + codebook_term

        counts, sums = self._ema_statistics(flat, indices)
        if self.training:
            with torch.no_grad():
                ecs = self.ema_cluster_size * self.decay \
                    + counts * (1 - self.decay)
                self.ema_cluster_size.copy_(ecs)
                self.ema_w.copy_(self.ema_w * self.decay
                                 + sums * (1 - self.decay))
                n = torch.sum(ecs)
                weights = (ecs + 1e-7) / (n + k * 1e-7) * n
                new_codebook = self.ema_w / weights[:, None]
                if not self.no_random_restart:
                    k_rand = random_rows(flat_all.detach(), k, draws)
                    alive = ecs >= self.restart_thres
                    new_codebook = torch.where(alive[:, None], new_codebook,
                                               k_rand)
                self.codebook.copy_(new_codebook)

        quantized = x + (quantized - x).detach()
        aux = QuantAux(loss, perplexity_from_counts(counts),
                       indices.reshape(x.shape[:-1]), counts)
        return quantized, aux


class VectorQuantizerEMASonnet(Quantizer):
    """Sonnet-style EMA quantizer with Laplace-smoothed cluster sizes; the
    codebook is a buffer. No draws."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 6.0, decay: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.decay = decay
        self.epsilon = epsilon
        k, d = num_embeddings, embedding_dim
        self.register_buffer("codebook", torch.zeros(k, d))
        self.register_buffer("ema_cluster_size", torch.zeros(k))
        self.register_buffer("ema_w", torch.zeros(k, d))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(-0.05, 0.05) codebook, EMA sums a copy of it, zero sizes."""
        with torch.no_grad():
            self.codebook.uniform_(-0.05, 0.05, generator=generator)
            self.ema_w.copy_(self.codebook)
            self.ema_cluster_size.zero_()

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None):
        k, d = self.num_embeddings, self.embedding_dim
        flat = x.reshape(-1, d).float()
        indices = nearest_codebook_indices(flat, self.codebook)
        quantized = self.codebook[indices.long()].reshape(x.shape)
        quantized = quantized.to(x.dtype)

        counts, sums = self._ema_statistics(flat, indices)
        if self.training:
            with torch.no_grad():
                ecs = self.ema_cluster_size * self.decay \
                    + (1 - self.decay) * counts
                self.ema_cluster_size.copy_(ecs)
                self.ema_w.copy_(self.ema_w * self.decay
                                 + (1 - self.decay) * sums)
                n = torch.sum(ecs)
                smoothed = (ecs + self.epsilon) / (n + k * self.epsilon) * n
                self.codebook.copy_(self.ema_w / smoothed[:, None])

        e_latent_loss = torch.mean(torch.square(quantized.detach() - x))
        loss = self.commitment_cost * e_latent_loss
        quantized = x + (quantized - x).detach()
        aux = QuantAux(loss, perplexity_from_counts(counts),
                       indices.reshape(x.shape[:-1]), counts)
        return quantized, aux


def _noise_substitute(x: torch.Tensor, hard: torch.Tensor, draws: Draws,
                      eps: float) -> torch.Tensor:
    """x + ||x - hard|| / (||noise|| + eps) * noise, norms per vector."""
    noise = draws.normal(x.shape, x.device, rows=True,
                         depth=spatial.SPATIAL_AXIS if x.dim() == 5
                         else None).to(x.dtype)
    res_norm = torch.sqrt(torch.sum(torch.square(x - hard), dim=-1,
                                    keepdim=True))
    noise_norm = torch.sqrt(torch.sum(torch.square(noise), dim=-1,
                                      keepdim=True))
    return x + res_norm / (noise_norm + eps) * noise


class NSVQ(Quantizer):
    """Noise-substitution VQ: in training the output is x plus noise scaled
    to the quantization error's norm, so gradients reach the codebook
    through that norm; in eval the nearest codes. One `normal` draw per
    training pass."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 eps: float = 1e-12):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.eps = eps
        a = math.sqrt(6.0 / num_embeddings)
        self.codebook = nn.Parameter(
            torch.empty(num_embeddings, embedding_dim).uniform_(-a, a))
        self.register_buffer("codebooks_used", torch.zeros(num_embeddings))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            _fan_in_uniform_(self.codebook, self.num_embeddings, generator)
            self.codebooks_used.zero_()

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None):
        k, d = self.num_embeddings, self.embedding_dim
        flat = x.reshape(-1, d)
        indices = nearest_codebook_indices(flat.float(), self.codebook)
        hard = codebook_gather(self.codebook, indices).reshape(x.shape)
        if self.training:
            quantized = _noise_substitute(x, hard, _draws(draws, "NSVQ"),
                                          self.eps)
        else:
            quantized = hard
        loss = torch.mean(torch.square(x - quantized))
        counts = self._counts(indices)
        if self.training:
            with torch.no_grad():
                self.codebooks_used += counts
        aux = QuantAux(loss, perplexity_from_counts(counts),
                       indices.reshape(x.shape[:-1]), counts)
        return quantized, aux


class RNSVQ(Quantizer):
    """Residual multi-stage NSVQ: stage i quantizes the residual left by
    stages 0..i-1 with its own codebook (one codebook-kernel call per
    stage), and noise substitution is applied to the sum. Codebooks
    [S, K, D]; usage [S, K]; indices [..., S]; the perplexity is the mean
    of the stages'. One `normal` draw per training pass."""

    def __init__(self, num_stages: int, num_embeddings: int,
                 embedding_dim: int, eps: float = 1e-12):
        super().__init__()
        self.num_stages = num_stages
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.eps = eps
        s, k, d = num_stages, num_embeddings, embedding_dim
        a = math.sqrt(6.0 / (s * k))
        self.codebooks = nn.Parameter(torch.empty(s, k, d).uniform_(-a, a))
        self.register_buffer("codebooks_used", torch.zeros(s, k))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's fan_in of an [S, K, D] parameter is S * K."""
        with torch.no_grad():
            _fan_in_uniform_(self.codebooks,
                             self.num_stages * self.num_embeddings, generator)
            self.codebooks_used.zero_()

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None):
        k, d = self.num_embeddings, self.embedding_dim
        flat = x.reshape(-1, d)
        residual = flat
        total = torch.zeros_like(flat)
        counts, indices = [], []
        for i in range(self.num_stages):
            idx = nearest_codebook_indices(residual.float(),
                                           self.codebooks[i])
            q = codebook_gather(self.codebooks[i], idx)
            total = total + q
            residual = residual - q.detach()
            counts.append(self._counts(idx))
            indices.append(idx.reshape(x.shape[:-1]))
        hard = total.reshape(x.shape)
        if self.training:
            quantized = _noise_substitute(x, hard, _draws(draws, "RNSVQ"),
                                          self.eps)
        else:
            quantized = hard
        loss = torch.mean(torch.square(x - quantized))
        counts = torch.stack(counts)
        if self.training:
            with torch.no_grad():
                self.codebooks_used += counts
        perplexity = torch.stack([perplexity_from_counts(c)
                                  for c in counts]).mean()
        aux = QuantAux(loss, perplexity, torch.stack(indices, dim=-1),
                       counts)
        return quantized, aux


# ---------------------------------------------------------------------------
# Unused-code replacement, between epochs
# ---------------------------------------------------------------------------


@torch.no_grad()
def replace_unused_codebooks(codebook: torch.Tensor,
                             usage_counts: torch.Tensor, num_batches: int,
                             draws: Draws, threshold: float = 0.05,
                             eps: float = 1e-10):
    """Re-seed codes whose usage per batch fell below `threshold` from used
    codes drawn uniformly (with replacement) plus eps N(0, 1) noise; with no
    code in use, jitter every code. Draws: one `choice` of K donors, one
    `normal` [K, D].

    Returns (new codebook [K, D], zeroed usage [K], number replaced)."""
    k = codebook.shape[0]
    used = usage_counts / max(num_batches, 1) >= threshold
    num_used = int(used.sum())
    p = used.float()
    p = p / max(float(p.sum()), 1.0) if num_used > 0 \
        else torch.full_like(p, 1.0 / k)
    donors = draws.choice(p, k)
    noise = eps * draws.normal(codebook.shape, codebook.device)
    if num_used > 0:
        new = torch.where(used[:, None], codebook, codebook[donors] + noise)
    else:
        new = codebook + noise
    return new, torch.zeros_like(usage_counts), k - num_used


def replace_unused_codebooks_staged(codebooks: torch.Tensor,
                                    usage_counts: torch.Tensor,
                                    num_batches: int, draws: Draws,
                                    threshold: float = 0.01):
    """`replace_unused_codebooks` per residual stage, donors from the
    stage's own used codes: codebooks [S, K, D], usage [S, K]; the draws
    stage by stage. Returns (new codebooks, zeroed usage, total
    replaced)."""
    new, total = [], 0
    for cb, us in zip(codebooks, usage_counts):
        c, _, n = replace_unused_codebooks(cb, us, num_batches, draws,
                                           threshold)
        new.append(c)
        total += n
    return torch.stack(new), torch.zeros_like(usage_counts), total


def make_quantizer(cfg) -> Quantizer:
    """Factory over `QuantizerConfig.kind`."""
    if cfg.kind == "ste":
        return VectorQuantizerSTE(cfg.num_embeddings, cfg.embedding_dim,
                                  beta=cfg.beta)
    if cfg.kind == "ema":
        return VectorQuantizerEMA(cfg.num_embeddings, cfg.embedding_dim,
                                  beta=cfg.beta, decay=cfg.ema_decay,
                                  restart_thres=cfg.restart_thres,
                                  no_random_restart=cfg.no_random_restart)
    if cfg.kind == "ema_sonnet":
        return VectorQuantizerEMASonnet(cfg.num_embeddings,
                                        cfg.embedding_dim,
                                        commitment_cost=cfg.commitment_cost,
                                        decay=cfg.ema_decay)
    if cfg.kind == "nsvq":
        return NSVQ(cfg.num_embeddings, cfg.embedding_dim)
    if cfg.kind == "rnsvq":
        return RNSVQ(cfg.num_stages, cfg.num_embeddings, cfg.embedding_dim)
    raise ValueError(f"unknown quantizer kind: {cfg.kind}")

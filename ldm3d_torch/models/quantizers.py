"""Vector quantizers: the port of `ldm3d.models.quantizers`.

Only the straight-through quantizer (`kind="ste"`) is ported; the EMA,
Sonnet-EMA, NSVQ and RNSVQ quantizers raise "not ported yet". The usage
counter that the JAX package keeps in its "vq_stats" collection is the
buffer `codebooks_used`, added to in training mode only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn

from ldm3d_torch.ops.quantize import (codebook_usage_counts,
                                      nearest_codebook_indices,
                                      perplexity_from_counts)


class QuantAux(NamedTuple):
    loss: torch.Tensor          # quantization loss term for the train loss
    perplexity: torch.Tensor    # exp entropy of code usage
    indices: torch.Tensor       # [...] int32 code indices (input minus D)
    usage_counts: torch.Tensor  # [K] float32 usage counts of this batch


class VectorQuantizerSTE(nn.Module):
    """Straight-through VQ with commitment + codebook loss; codebook
    [K, D]. Takes x [..., D] (channels last) and returns the quantized
    tensor of the same shape and a `QuantAux`."""

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

    def forward(self, x: torch.Tensor):
        flat = x.reshape(-1, self.embedding_dim)
        indices = nearest_codebook_indices(flat.float(), self.codebook)
        quantized = self.codebook[indices.long()].reshape(x.shape)

        commitment = torch.mean(torch.square(quantized.detach() - x))
        codebook_loss = torch.mean(torch.square(quantized - x.detach()))
        loss = self.beta * commitment + codebook_loss

        quantized = x + (quantized - x).detach()    # straight through

        counts = codebook_usage_counts(indices, self.num_embeddings)
        if self.training:
            with torch.no_grad():
                self.codebooks_used += counts
        aux = QuantAux(loss, perplexity_from_counts(counts),
                       indices.reshape(x.shape[:-1]), counts)
        return quantized, aux


def make_quantizer(cfg) -> nn.Module:
    """Factory over `QuantizerConfig.kind`."""
    if cfg.kind == "ste":
        return VectorQuantizerSTE(cfg.num_embeddings, cfg.embedding_dim,
                                  beta=cfg.beta)
    if cfg.kind in ("ema", "ema_sonnet", "nsvq", "rnsvq"):
        raise ValueError(f"quantizer kind {cfg.kind!r}: not ported yet")
    raise ValueError(f"unknown quantizer kind: {cfg.kind}")

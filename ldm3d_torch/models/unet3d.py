"""3D diffusion U-Net with time conditioning and context cross-attention:
the port of `ldm3d.models.unet3d`.

Submodule names follow the flax tree (`down_res_0_1`, `xattn_mid`,
`ctx_mlp_up_1_2`, ...). Inside, volumes are NCDHW; `UNet3D.forward` takes
and returns NDHWC like the JAX module. Voxel sequences are flattened in
(h, w, d) order, the order of an NDHWC reshape, and every attention call
goes through `ldm3d_torch.ops.attention.voxel_attention`.

flax infers layer input sizes at the first call; here they are computed at
construction, so `UNet3D` takes the latent's channels and spatial size.

Under `parallel.spatial.spatial_sharding` the U-Net runs on depth slabs
(JAX's `shard_spatial` sites): a level whose depth divides by the space
degree is held as slabs, any other runs whole on every process
(`spatial.whole`), and the input is a slab when its depth divides
(`spatial.shard_spatial`). The attention blocks attend this slab's
voxels (queries) to the whole sequence (keys and values gathered over
the space group, in the whole volume's order); the context grid of
`ContextMLP` is whole.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ldm3d_torch.core.config import UNetConfig
from ldm3d_torch.models.layers import (Conv3d, Dense, Embed, LayerNorm,
                                       Norm, upsample3d, with_init)
from ldm3d_torch.ops.attention import voxel_attention
from ldm3d_torch.parallel import spatial


def _to_seq(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W, D] -> [B, H*W*D, C] in NDHWC flatten order."""
    return x.flatten(2).transpose(1, 2).contiguous()


def _from_seq(x: torch.Tensor, spatial) -> torch.Tensor:
    """[B, H*W*D, C] -> [B, C, H, W, D]."""
    b, _, c = x.shape
    return x.transpose(1, 2).reshape(b, c, *spatial)


def _whole_seq(x: torch.Tensor, seq: torch.Tensor, fn=None) -> torch.Tensor:
    """The whole volume's voxel sequence of the NCDHW `x` (through `fn`, a
    per-voxel map) when `x` is a depth slab, gathered in the whole
    volume's order; else `seq`, the same sequence of `x` itself."""
    if spatial.sharded() is None:
        return seq
    whole = _to_seq(spatial.gather(x))
    return whole if fn is None else fn(whole)


class TimeEmbedding(nn.Module):
    """Sinusoidal timestep embedding; the frequency divisor is half - 1.
    float32 under any compute dtype, until the time MLP's first Dense."""

    def __init__(self, dim: int, max_period: int = 10000):
        super().__init__()
        self.dim = dim
        self.max_period = max_period

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(
            torch.arange(half, dtype=torch.float32, device=t.device)
            * -(math.log(self.max_period) / (half - 1)))
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimeMLP(nn.Module):
    def __init__(self, in_features: int, units: int):
        super().__init__()
        self.Dense_0 = Dense(in_features, units)
        self.Dense_1 = Dense(units, units)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.silu(self.Dense_0(t)))


class ResidualBlock(nn.Module):
    """norm -> swish -> conv3 (+ time embedding) -> norm -> swish -> conv3,
    residual add (through a 1x1 conv when the width changes)."""

    def __init__(self, in_channels: int, width: int, temb_dim: int,
                 norm: str = "batch"):
        super().__init__()
        if in_channels != width:
            self.skip_proj = Conv3d(in_channels, width, 1)
        else:
            self.skip_proj = None
        self.temb_proj = Dense(temb_dim, width)
        self.norm1 = Norm(norm, in_channels)
        self.conv1 = Conv3d(in_channels, width, 3)
        self.norm2 = Norm(norm, width)
        self.conv2 = Conv3d(width, width, 3, kernel_init="zeros")

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        residual = x if self.skip_proj is None else self.skip_proj(x)
        t = self.temb_proj(F.silu(temb))[:, :, None, None, None]
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + t
        h = self.conv2(F.silu(self.norm2(h)))
        return h + residual


class AttentionBlock(nn.Module):
    """Self-attention over the voxel grid. The residual adds the
    *normalized* input, as the JAX module does."""

    def __init__(self, units: int, norm: str = "batch"):
        super().__init__()
        self.units = units
        self.norm = Norm(norm, units)
        self.query = Dense(units, units)
        self.key = Dense(units, units)
        self.value = Dense(units, units)
        self.proj = with_init(Dense(units, units), "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = self.norm(x)
        seq = _to_seq(xn)
        kv = _whole_seq(xn, seq)
        out = voxel_attention(self.query(seq), self.key(kv),
                              self.value(kv),
                              scale=float(self.units) ** -0.5)
        out = self.proj(out)
        return xn + _from_seq(out, x.shape[2:])


class CrossAttentionBlock(nn.Module):
    """Self attention, cross attention to the context sequence, and an MLP,
    over the voxel sequence. Self and cross attention share the q/k/v
    projections, and the score scale is units ** -0.5 even with heads."""

    def __init__(self, units: int, num_heads: int = 1, norm: str = "batch"):
        super().__init__()
        self.units = units
        self.num_heads = num_heads
        self.norm = Norm(norm, units)
        self.proj_in = Conv3d(units, units, 1)
        # flax's default Dense init: lecun normal
        self.query = with_init(Dense(units, units), "lecun_normal")
        self.key = with_init(Dense(units, units), "lecun_normal")
        self.value = with_init(Dense(units, units), "lecun_normal")
        self.norm1 = LayerNorm(units)
        self.norm2 = LayerNorm(units)
        self.norm3 = LayerNorm(units)
        self.mlp1 = with_init(Dense(units, units * 4), "lecun_normal")
        self.mlp2 = with_init(Dense(units * 4, units), "lecun_normal")
        self.proj_out = Conv3d(units, units, 1)

    def _attend(self, x_seq: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
        """Attention of `x_seq`'s voxels to the sequence `src`."""
        b, n, _ = x_seq.shape
        q, k, v = self.query(x_seq), self.key(src), self.value(src)
        if self.num_heads > 1:
            hd = self.units // self.num_heads

            def split(t):
                return (t.reshape(b, -1, self.num_heads, hd).transpose(1, 2)
                        .reshape(b * self.num_heads, -1, hd).contiguous())
            q, k, v = split(q), split(k), split(v)
        out = voxel_attention(q, k, v, scale=float(self.units) ** -0.5)
        if self.num_heads > 1:
            hd = self.units // self.num_heads
            out = (out.reshape(b, self.num_heads, n, hd).transpose(1, 2)
                   .reshape(b, n, self.units))
        return out

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        residual = x
        xn = F.relu(self.proj_in(self.norm(x)))
        x_seq = _to_seq(xn)
        ctx_seq = context.reshape(x.shape[0], -1, context.shape[-1])

        n1 = self.norm1(x_seq)
        # over slabs the keys are the whole sequence's (norm1 is per voxel)
        y = self._attend(n1, _whole_seq(xn, n1, self.norm1)) + x_seq
        y = self._attend(self.norm2(x_seq), ctx_seq) + y
        m = self.mlp2(F.relu(self.mlp1(self.norm3(x_seq))))
        y = m + y
        y = self.proj_out(_from_seq(y, x.shape[2:]))
        return F.relu(y) + residual


class ContextMLP(nn.Module):
    """Projects the context embedding to a full grid, NDHWC [B, h, w, d, C]
    (the Dense output is read in (h, w, d, C) order)."""

    def __init__(self, in_features: int, spatial: Tuple[int, int, int],
                 channels: int):
        super().__init__()
        self.spatial = tuple(spatial)
        self.channels = channels
        self.Dense_0 = with_init(
            Dense(in_features, math.prod(spatial) * channels),
            "lecun_normal")

    def forward(self, cemb: torch.Tensor) -> torch.Tensor:
        out = F.silu(self.Dense_0(cemb))
        return out.reshape(-1, *self.spatial, self.channels)


class UNet3D(nn.Module):
    """The denoiser; `cfg.context_dim=None` gives the unconditional variant
    (self-attention blocks), an int the conditional one (cross-attention
    blocks, a context embedding with a null row when cfg_dropout > 0)."""

    def __init__(self, cfg: UNetConfig, out_channels: int, in_channels: int,
                 latent_size: int):
        super().__init__()
        self.cfg = cfg
        self.conditional = cfg.context_dim is not None
        widths = cfg.widths
        stem = cfg.first_conv_channels
        temb_dim = stem * 4
        nrb = cfg.num_res_blocks

        self.stem = Conv3d(in_channels, stem, 3)
        self.time_embedding = TimeEmbedding(temb_dim)
        self.time_mlp = TimeMLP(temb_dim, temb_dim)
        if self.conditional:
            n_tokens = cfg.context_dim + 1 + (1 if cfg.cfg_dropout > 0 else 0)
            self.context_embed = Embed(n_tokens, temb_dim)

        def attend(name: str, width: int, size: int):
            if self.conditional:
                self.add_module(f"ctx_mlp_{name}",
                                ContextMLP(temb_dim, (size,) * 3, width))
                self.add_module(f"xattn_{name}",
                                CrossAttentionBlock(width, cfg.num_heads,
                                                    cfg.norm))
            else:
                self.add_module(f"attn_{name}",
                                AttentionBlock(width, cfg.norm))

        # Down path; the channel counts of the skips are tracked for the
        # up path's concatenations.
        size, ch = latent_size, stem
        self.sizes: List[int] = []      # the depth of each level
        skips: List[int] = [ch]
        for i, w in enumerate(widths):
            self.sizes.append(size)
            for j in range(nrb):
                self.add_module(f"down_res_{i}_{j}",
                                ResidualBlock(ch, w, temb_dim, cfg.norm))
                ch = w
                if cfg.has_attention[i]:
                    attend(f"down_{i}_{j}", w, size)
                skips.append(ch)
            if w != widths[-1]:
                self.add_module(f"down_sample_{i}", Conv3d(ch, w, 3, stride=2))
                size = -(-size // 2)
                skips.append(ch)

        self.mid_res1 = ResidualBlock(ch, widths[-1], temb_dim, cfg.norm)
        ch = widths[-1]
        attend("mid", ch, size)
        self.mid_res2 = ResidualBlock(ch, widths[-1], temb_dim, cfg.norm)

        for i in reversed(range(len(widths))):
            for j in range(nrb + 1):
                self.add_module(
                    f"up_res_{i}_{j}",
                    ResidualBlock(ch + skips.pop(), widths[i], temb_dim,
                                  cfg.norm))
                ch = widths[i]
                if cfg.has_attention[i]:
                    attend(f"up_{i}_{j}", ch, size)
            if i != 0:
                self.add_module(f"up_sample_{i}", Conv3d(ch, widths[i], 3))
                size *= 2

        self.head_norm = Norm(cfg.norm, ch)
        self.head = Conv3d(ch, out_channels, 3, kernel_init="zeros")

    def _attend(self, h, name, cemb):
        if self.conditional:
            ctx = getattr(self, f"ctx_mlp_{name}")(cemb)
            return getattr(self, f"xattn_{name}")(h, ctx)
        return getattr(self, f"attn_{name}")(h)

    def _between(self, h: torch.Tensor, layer, sharded: List[bool],
                 src: int, dst: int, up: bool = False) -> torch.Tensor:
        """`layer` (a resampling conv, after a 2x upsample with `up`) from
        level `src` to level `dst`, the activation moved between slabs and
        the whole volume where the two levels differ."""
        if sharded[src] and not sharded[dst]:
            h = spatial.gather(h)
        with spatial.whole(not (sharded[src] and sharded[dst])):
            h = layer(upsample3d(h, 2) if up else h)
        if sharded[dst] and not sharded[src]:
            h = spatial.scatter(h)
        return h

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, h, w, d, C] (NDHWC), t [B] int, context [B] int tokens.
        Returns the prediction, NDHWC. Over depth slabs x and the
        prediction are this process's slabs when the latent depth divides
        by the space degree."""
        cfg = self.cfg
        widths = cfg.widths
        sharded = [spatial.shards(s) for s in self.sizes]

        def level(i):
            return spatial.whole(not sharded[i])
        with level(0):
            h = self.stem(x.permute(0, 4, 1, 2, 3).contiguous())
        temb = self.time_mlp(self.time_embedding(t))

        cemb = None
        if self.conditional:
            if context is None:
                raise ValueError("conditional UNet requires a context token")
            cemb = self.context_embed(context.long())
            if cfg.context_in_time:
                temb = temb + cemb.to(temb.dtype)

        skips = [h]
        for i, w in enumerate(widths):
            with level(i):
                for j in range(cfg.num_res_blocks):
                    h = getattr(self, f"down_res_{i}_{j}")(h, temb)
                    if cfg.has_attention[i]:
                        h = self._attend(h, f"down_{i}_{j}", cemb)
                    skips.append(h)
            if w != widths[-1]:
                h = self._between(h, getattr(self, f"down_sample_{i}"),
                                  sharded, i, i + 1)
                skips.append(h)

        with level(len(widths) - 1):
            h = self.mid_res1(h, temb)
            h = self._attend(h, "mid", cemb)
            h = self.mid_res2(h, temb)

        for i in reversed(range(len(widths))):
            with level(i):
                for j in range(cfg.num_res_blocks + 1):
                    h = torch.cat([h, skips.pop()], dim=1)
                    h = getattr(self, f"up_res_{i}_{j}")(h, temb)
                    if cfg.has_attention[i]:
                        h = self._attend(h, f"up_{i}_{j}", cemb)
            if i != 0:
                h = self._between(h, getattr(self, f"up_sample_{i}"),
                                  sharded, i, i - 1, up=True)

        with level(0):
            h = self.head(F.silu(self.head_norm(h)))
        return h.permute(0, 2, 3, 4, 1).contiguous()

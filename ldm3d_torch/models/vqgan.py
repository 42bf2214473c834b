"""The VQ-GAN family: the port of `ldm3d.models.vqgan`.

Four autoencoders, chosen by `VQVAEConfig.arch`:
  - "attn_cp" (`VQGANEncoder` / `VQGANDecoder`): pre-norm GroupNorm/SiLU
    residual units, a k3 stem and k4-s2 downsampling convs, a 1x1 conv to
    the latent width; the decoder mirrors it with k4-s2 transposed convs
    and two residual units per level
  - "attn" (`AttnEncoder` / `AttnDecoder`): the same plan over SYMMETRIC
    mirror-padded VALID convs (`SamePadConv3D`), the transposed ones
    centre-cropped to stride x n (`SamePadConvTranspose3D`)
  - "stride" (`StrideEncoder` / `StrideDecoder`): residual units before
    stride-1 k4 convs, average-pool downsampling, nearest upsampling
  - "monai": the VQ-VAE's `Encoder` / `Decoder` (`models.vqvae`)
and the EMA or straight-through quantizer between them. Two PatchGAN
critics, `Discriminator3D` over volumes and `Discriminator2D` over frames
(BatchNorm + LeakyReLU(0.2) ladders with a conv or a dense head), return
their logits and the intermediate features that feature matching reads.
The GAN losses (`hinge_d_loss`, `vanilla_d_loss`) and `adopt_weight` are
here; the two-optimizer step is `train.gan_trainer.GANTrainer`.

Module names follow the flax tree, so `ldm3d_torch.convert` maps one onto
the other. Volumes are NCDHW inside; `VQGANAutoencoder` takes and returns
NDHWC as the JAX module does; the critics take channels-first tensors.

Under `parallel.spatial.spatial_sharding` the "monai", "attn" and
"attn_cp" autoencoders run on depth slabs (JAX's `shard_spatial` sites);
the "stride" family, which JAX does not shard, runs on the gathered
volume; the critics and LPIPS are given gathered volumes by
`train.gan_trainer`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ldm3d_torch.core.config import DiscriminatorConfig, VQVAEConfig
from ldm3d_torch.models.layers import (Conv2d, Conv3d, ConvTranspose3d, Dense,
                                       Norm, act_layer, avgpool3d,
                                       symmetric_pad3d, upsample3d, with_init)
from ldm3d_torch.models.quantizers import Draws, QuantAux, make_quantizer
from ldm3d_torch.models.vqvae import (Decoder, Encoder, VQVAEResidualUnit,
                                      _dropout, _ncdhw, _ndhwc, _run_unit)
from ldm3d_torch.parallel import spatial


class GNResidualUnit(nn.Module):
    """Pre-norm SiLU residual unit: x + conv(silu(gn(conv(silu(gn(x))))))."""

    def __init__(self, channels: int, res_channels: int):
        super().__init__()
        self.norm1 = Norm("group", channels)
        self.conv1 = Conv3d(channels, res_channels, 3)
        self.norm2 = Norm("group", res_channels)
        self.conv2 = Conv3d(res_channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return x + h


class VQGANEncoder(nn.Module):
    """"attn_cp": k3 stem, then per further level a k4-s2 conv and one
    residual unit; GroupNorm, SiLU and a 1x1 conv to the latent width."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        ch_in = cfg.in_channels
        for i, ch in enumerate(cfg.num_channels):
            if i == 0:
                self.stem = Conv3d(ch_in, ch, 3)
            else:
                self.add_module(f"down_{i}", Conv3d(ch_in, ch, 4, stride=2))
                self.add_module(f"res_{i}", GNResidualUnit(
                    ch, cfg.num_res_channels[i]))
            ch_in = ch
        self.head_norm = Norm("group", ch_in)
        self.to_latent = Conv3d(ch_in, cfg.quantizer.embedding_dim, 1)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
        x = self.stem(x)
        for i in range(1, self.cfg.num_levels):
            x = getattr(self, f"down_{i}")(x)
            x = _run_unit(self.cfg, getattr(self, f"res_{i}"), x)
        return self.to_latent(F.silu(self.head_norm(x)))


class VQGANDecoder(nn.Module):
    """"attn_cp": 1x1 stem, GroupNorm, SiLU; per level a k4-s2 transposed
    conv and two residual units; a k3 conv to the output channels."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        rev = list(reversed(cfg.num_channels)) + [cfg.out_channels]
        self.stem = Conv3d(cfg.quantizer.embedding_dim, rev[0], 1)
        self.stem_norm = Norm("group", rev[0])
        for i in range(1, len(rev)):
            if i == len(rev) - 1:
                self.head = Conv3d(rev[i - 1], cfg.out_channels, 3)
            else:
                self.add_module(f"up_{i}", ConvTranspose3d(
                    rev[i - 1], rev[i], 4, stride=2,
                    kernel_resize=cfg.kernel_resize))
                self.add_module(f"res_{i}_1", GNResidualUnit(rev[i], rev[i]))
                self.add_module(f"res_{i}_2", GNResidualUnit(rev[i], rev[i]))
        self.levels = len(rev)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
        x = F.silu(self.stem_norm(self.stem(x)))
        for i in range(1, self.levels - 1):
            x = getattr(self, f"up_{i}")(x)
            x = _run_unit(self.cfg, getattr(self, f"res_{i}_1"), x)
            x = _run_unit(self.cfg, getattr(self, f"res_{i}_2"), x)
        return self.head(x)


class SamePadConv3D(nn.Module):
    """SYMMETRIC mirror pad of k - s per dim, then a VALID conv."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel, self.stride = (kernel,) * 3, (stride,) * 3
        self.conv = Conv3d(in_channels, features, kernel, stride=stride,
                           use_bias=use_bias, padding="VALID")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.kernel[2] - self.stride[2]
        if spatial.sharded() is not None and not spatial.fits(
                x.shape[4], p // 2, p - p // 2, self.stride[2]):
            return spatial.gathered(self.forward, x)
        return self.conv(symmetric_pad3d(x, self.kernel, self.stride))


class SamePadConvTranspose3D(nn.Module):
    """SYMMETRIC mirror pad of k - s per dim, a VALID transposed conv, and
    a centre crop of the (k - s)(s + 1) excess voxels per dim, so that the
    output is stride x n (torch `padding=k-1` for k = 4, s = 2)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 4,
                 stride: int = 2, use_bias: bool = True):
        super().__init__()
        self.kernel, self.stride = (kernel,) * 3, (stride,) * 3
        self.convt = ConvTranspose3d(in_channels, features, kernel,
                                     stride=stride, use_bias=use_bias,
                                     padding="VALID")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel[0], self.stride[0]
        e = (k - s) * (s + 1)
        lo, hi = e // 2, e - e // 2
        # a slab's crop is the whole volume's when its first output row
        # reads rows of the padded slab only: lo >= k - 1 (k = 4, s = 2)
        if spatial.sharded() is not None and not (
                lo >= k - 1 and lo <= s * (k - s) and spatial.fits(
                    x.shape[4], (k - s) // 2, k - s - (k - s) // 2)):
            return spatial.gathered(self.forward, x)
        x = self.convt(symmetric_pad3d(x, self.kernel, self.stride))
        if e:
            x = x[:, :, lo:-hi, lo:-hi, lo:-hi]
        return x


class SymResidualUnit(nn.Module):
    """Pre-norm SiLU residual unit over SYMMETRIC-pad convs, with a 1x1
    shortcut where the channel count changes."""

    def __init__(self, in_channels: int, channels: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm1 = Norm("group", in_channels)
        self.conv1 = SamePadConv3D(in_channels, channels, 3)
        self.norm2 = Norm("group", channels)
        self.conv2 = SamePadConv3D(channels, channels, 3)
        if in_channels != channels:
            self.shortcut = SamePadConv3D(in_channels, channels, 1)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = _dropout(h, self.dropout, self.training, draws)
        h = self.conv2(F.silu(self.norm2(h)))
        shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
        return h + shortcut


class AttnEncoder(nn.Module):
    """"attn": SYMMETRIC-pad k3 stem at num_channels[0], per further level
    a k4-s2 SamePadConv3D and one residual unit, GroupNorm + SiLU, and the
    1x1 projection to the latent width."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        ch_in = cfg.num_channels[0]
        self.stem = SamePadConv3D(cfg.in_channels, ch_in, 3)
        for i, ch in enumerate(cfg.num_channels[1:], start=1):
            self.add_module(f"down_{i}", SamePadConv3D(ch_in, ch, 4, 2))
            self.add_module(f"res_{i}", SymResidualUnit(ch, ch, cfg.dropout))
            ch_in = ch
        self.head_norm = Norm("group", ch_in)
        self.to_latent = Conv3d(ch_in, cfg.quantizer.embedding_dim, 1)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
        x = self.stem(x)
        for i in range(1, self.cfg.num_levels):
            x = getattr(self, f"down_{i}")(x)
            x = getattr(self, f"res_{i}")(x, draws)
        return self.to_latent(F.silu(self.head_norm(x)))


class AttnDecoder(nn.Module):
    """"attn": 1x1 post-VQ conv, GroupNorm + SiLU, per level a k4-s2
    SamePadConvTranspose3D and two residual units, a k3 SamePadConv3D to
    the output channels."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        rev = list(reversed(cfg.num_channels))
        emb = cfg.quantizer.embedding_dim
        self.post_vq = Conv3d(emb, emb, 1)
        self.stem_norm = Norm("group", emb)
        ch_in = emb
        for i, ch in enumerate(rev[1:], start=1):
            self.add_module(f"up_{i}", SamePadConvTranspose3D(ch_in, ch))
            self.add_module(f"res_{i}_1", SymResidualUnit(ch, ch, cfg.dropout))
            self.add_module(f"res_{i}_2", SymResidualUnit(ch, ch, cfg.dropout))
            ch_in = ch
        self.head = SamePadConv3D(ch_in, cfg.out_channels, 3)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
        x = F.silu(self.stem_norm(self.post_vq(x)))
        for i in range(1, self.cfg.num_levels):
            x = getattr(self, f"up_{i}")(x)
            x = getattr(self, f"res_{i}_1")(x, draws)
            x = getattr(self, f"res_{i}_2")(x, draws)
        return self.head(x)


class StrideEncoder(nn.Module):
    """"stride": per level num_res_layers residual units, a stride-1 k4
    conv, the activation and a 2x average pool; a k3 conv to the latent
    width."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        ch_in = cfg.in_channels
        for i, ch in enumerate(cfg.num_channels):
            for j in range(cfg.num_res_layers):
                self.add_module(f"res_{i}_{j}", VQVAEResidualUnit(
                    ch_in, cfg.num_res_channels[i], act=cfg.act,
                    norm=cfg.norm))
            self.add_module(f"conv_{i}", Conv3d(ch_in, ch, 4))
            self.add_module(f"act_{i}", act_layer(cfg.act, ch))
            ch_in = ch
        self.to_latent = Conv3d(ch_in, cfg.quantizer.embedding_dim, 3)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        for i in range(cfg.num_levels):
            for j in range(cfg.num_res_layers):
                x = _run_unit(cfg, getattr(self, f"res_{i}_{j}"), x)
            x = getattr(self, f"act_{i}")(getattr(self, f"conv_{i}")(x))
            x = avgpool3d(x, 2)
        return self.to_latent(x)


class StrideDecoder(nn.Module):
    """"stride": a k3 stem, then per level residual units, a 2x nearest
    upsample and a stride-1 k4 conv (the activation between levels)."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        rev = list(reversed(cfg.num_channels))
        rev_res = list(reversed(cfg.num_res_channels))
        n = len(rev)
        self.stem = Conv3d(cfg.quantizer.embedding_dim, rev[0], 3)
        for i in range(n):
            for j in range(cfg.num_res_layers):
                self.add_module(f"res_{i}_{j}", VQVAEResidualUnit(
                    rev[i], rev_res[i], act=cfg.act, norm=cfg.norm))
            out_ch = cfg.out_channels if i == n - 1 else rev[i + 1]
            self.add_module(f"conv_{i}", Conv3d(rev[i], out_ch, 4))
            if i != n - 1:
                self.add_module(f"act_{i}", act_layer(cfg.act, out_ch))

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        n = cfg.num_levels
        x = self.stem(x)
        for i in range(n):
            for j in range(cfg.num_res_layers):
                x = _run_unit(cfg, getattr(self, f"res_{i}_{j}"), x)
            x = getattr(self, f"conv_{i}")(upsample3d(x, 2))
            if i != n - 1:
                x = getattr(self, f"act_{i}")(x)
        return x


_ARCHS = {"monai": (Encoder, Decoder), "stride": (StrideEncoder,
                                                  StrideDecoder),
          "attn": (AttnEncoder, AttnDecoder),
          "attn_cp": (VQGANEncoder, VQGANDecoder)}


class VQGANAutoencoder(nn.Module):
    """Encoder -> quantizer -> decoder of `cfg.arch` (the generator)."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        if cfg.arch not in _ARCHS:
            raise ValueError(f"unknown VQ-GAN arch {cfg.arch!r}")
        enc, dec = _ARCHS[cfg.arch]
        self.cfg = cfg
        self.encoder = enc(cfg)
        self.decoder = dec(cfg)
        self.quantizer = make_quantizer(cfg.quantizer)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> Tuple[torch.Tensor, QuantAux]:
        """Volumes [B, H, W, D, in] (NDHWC) -> (reconstruction NDHWC,
        QuantAux); `draws` gives training mode's randomness."""
        q, aux = self.encode_quantize(x, draws)
        return self.decode(q, draws), aux

    def encode_quantize(self, x: torch.Tensor,
                        draws: Optional[Draws] = None
                        ) -> Tuple[torch.Tensor, QuantAux]:
        if self._whole():
            x = spatial.gather(x, spatial.SPATIAL_AXIS)
        with spatial.whole(self._whole()):
            return self.quantizer(_ndhwc(self.encoder(_ncdhw(x), draws)),
                                  draws)

    def decode(self, z: torch.Tensor, draws: Optional[Draws] = None
               ) -> torch.Tensor:
        whole = self._whole()
        with spatial.whole(whole):
            out = _ndhwc(self.decoder(_ncdhw(z), draws))
        return spatial.scatter(out, spatial.SPATIAL_AXIS) if whole else out

    def _whole(self) -> bool:
        """The "stride" family runs on the gathered volume under spatial
        sharding (JAX has no `shard_spatial` in it); its latents are then
        whole on every process."""
        return self.cfg.arch == "stride" and spatial.sharded() is not None


class _Critic(nn.Module):
    """The PatchGAN ladder shared by both critics: k4-s2 convs (BatchNorm
    after all but the first), LeakyReLU(0.2), a k4-s1 tail with BatchNorm,
    and the head."""

    def __init__(self, cfg: DiscriminatorConfig, in_channels: int, conv):
        super().__init__()
        self.cfg = cfg
        ch_in = in_channels
        for i, ch in enumerate(cfg.num_channels):
            self.add_module(f"down_{i}", conv(ch_in, ch, 4, stride=2))
            if i > 0:
                self.add_module(f"norm_{i}", Norm("batch", ch))
            ch_in = ch
        self.tail = conv(ch_in, ch_in, 4)
        self.tail_norm = Norm("batch", ch_in)

    def ladder(self, x: torch.Tensor) -> Tuple[torch.Tensor,
                                               List[torch.Tensor]]:
        feats = []
        for i in range(len(self.cfg.num_channels)):
            x = getattr(self, f"down_{i}")(x)
            if i > 0:
                x = getattr(self, f"norm_{i}")(x)
            x = F.leaky_relu(x, 0.2)
            feats.append(x)
        x = F.leaky_relu(self.tail_norm(self.tail(x)), 0.2)
        feats.append(x)
        return x, feats

    def finish(self, logits: torch.Tensor, feats: List[torch.Tensor]):
        if self.cfg.use_sigmoid:
            logits = torch.sigmoid(logits)
        feats.append(logits)
        return logits, (feats if self.cfg.get_interm_feat else [])


class Discriminator3D(_Critic):
    """PatchGAN over volumes [B, C, H, W, D] -> (logits, features). The
    "dense" head flattens in the JAX package's channels-last order, so
    that `dense1`'s rows are the converted flax kernel's."""

    def __init__(self, cfg: DiscriminatorConfig, in_channels: int = 1,
                 volume_size: Optional[int] = None):
        super().__init__(cfg, in_channels, Conv3d)
        if cfg.head == "dense":
            if volume_size is None:
                raise ValueError("the dense head needs the volume size")
            side = volume_size
            for _ in cfg.num_channels:
                side = -(-side // 2)
            self.dense1 = with_init(
                Dense(cfg.num_channels[-1] * side ** 3, 64),
                "lecun_normal")
            self.dense2 = with_init(Dense(64, 1), "lecun_normal")
        else:
            ch = cfg.num_channels[-1]
            self.head = Conv3d(ch, 1, 4)

    def forward(self, x: torch.Tensor):
        x, feats = self.ladder(x)
        if self.cfg.head == "dense":
            h = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
            logits = self.dense2(F.leaky_relu(self.dense1(h), 0.2))
        else:
            logits = self.head(x)
        return self.finish(logits, feats)


class Discriminator2D(_Critic):
    """PatchGAN over frames [B, C, W, D] -> (logits, features); always the
    conv head, as in the JAX package."""

    def __init__(self, cfg: DiscriminatorConfig, in_channels: int = 1):
        super().__init__(cfg, in_channels, Conv2d)
        self.head = Conv2d(cfg.num_channels[-1], 1, 4)

    def forward(self, x: torch.Tensor):
        x, feats = self.ladder(x)
        return self.finish(self.head(x), feats)


# -- GAN losses -------------------------------------------------------------


def hinge_d_loss(target_ones: bool, logits: torch.Tensor) -> torch.Tensor:
    if target_ones:
        return torch.mean(F.relu(1.0 - logits))
    return torch.mean(F.relu(1.0 + logits))


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The stable sigmoid cross-entropy of optax / TF:
    relu(l) - l * y + log1p(exp(-|l|))."""
    zeros = torch.zeros_like(logits)
    cond = logits >= zeros
    relu_logits = torch.where(cond, logits, zeros)
    neg_abs = torch.where(cond, -logits, logits)
    return relu_logits - logits * labels + torch.log1p(torch.exp(neg_abs))


def vanilla_d_loss(target_ones: bool, logits: torch.Tensor) -> torch.Tensor:
    labels = torch.ones_like(logits) if target_ones \
        else torch.zeros_like(logits)
    return torch.mean(sigmoid_ce(logits, labels))


def adopt_weight(weight: float, epoch: int, threshold: int) -> float:
    """The adversarial weight, 0 before `threshold` epochs."""
    return weight if epoch >= threshold else 0.0

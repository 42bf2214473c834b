"""Configuration dataclasses of the PyTorch port.

Copies of the fields of `ldm3d.core.config` that the ported modules read,
with the same names and defaults, so that a config built for the JAX
package can be rebuilt here field by field. The port keeps its own copy:
it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class QuantizerConfig:
    """Codebook settings of the five quantizers: "ste" (straight-through,
    commitment beta + codebook loss), "ema" (EMA codebook with a
    data-dependent init and random restart), "ema_sonnet" (EMA with
    Laplace smoothing), "nsvq" (noise substitution), "rnsvq" (residual
    multi-stage noise substitution)."""

    kind: str = "ste"
    num_embeddings: int = 512
    embedding_dim: int = 256
    beta: float = 0.25                 # commitment weight (ste / ema)
    ema_decay: float = 0.99
    commitment_cost: float = 6.0       # ema_sonnet's commitment weight
    restart_thres: float = 1.0         # EMA random-restart usage threshold
    no_random_restart: bool = False
    discarding_threshold: float = 0.05  # unused-code replacement threshold
    num_stages: int = 4                # rnsvq residual stages
    quantize_loss_weight: float = 1.0  # the quantizer loss's weight


@dataclass(frozen=True)
class VQVAEConfig:
    """MONAI-style 3D VQ-VAE."""

    in_channels: int = 2
    out_channels: int = 2
    num_channels: Tuple[int, ...] = (32, 64, 128)
    num_res_channels: Tuple[int, ...] = (32, 64, 128)
    num_res_layers: int = 3
    downsample_stride: Tuple[int, ...] = (2, 2, 2)
    downsample_kernel: Tuple[int, ...] = (4, 4, 4)
    upsample_stride: Tuple[int, ...] = (2, 2, 2)
    upsample_kernel: Tuple[int, ...] = (4, 4, 4)
    dropout: float = 0.0
    kernel_resize: bool = False        # ICNR init of the transposed convs
    norm: str = "batch"                # "batch" | "group"
    act: str = "relu"
    output_act: Optional[str] = None
    # the autoencoder inside a VQ-GAN: "attn_cp" (GroupNorm/SiLU, k3 stem
    # and k4-s2 downs), "monai" (this VQ-VAE's encoder and decoder),
    # "stride" (residual units before stride-1 convs, average-pool downs,
    # nearest-upsample decoder), "attn" (SYMMETRIC-pad convs)
    arch: str = "attn_cp"
    # model trained standalone: "monai", "legacy" (the functional VQ-VAE
    # of --vqvae_mode; legacy_mode 2 is the residual variant,
    # legacy_down 2 or 3 downsamples) or "ema_skip" (the skip-connection
    # EMA VQ-VAE)
    family: str = "monai"
    legacy_mode: int = 1
    legacy_down: int = 3
    # level-0 k4-s2 conv as zero-pad + space-to-depth(2) + k2 VALID conv
    stem_s2d: bool = False
    # recompute each residual unit in the backward pass
    # (torch.utils.checkpoint); "conv" keeps the convolutions' outputs and
    # recomputes only the norm and activation tail
    remat: bool = False
    remat_policy: str = "full"         # "full" | "conv"
    quantizer: QuantizerConfig = field(default_factory=QuantizerConfig)

    @property
    def num_levels(self) -> int:
        return len(self.num_channels)

    @property
    def spatial_factor(self) -> int:
        f = 1
        for s in self.downsample_stride:
            f *= s
        return f


@dataclass(frozen=True)
class DiscriminatorConfig:
    """The PatchGAN critics, 3D over volumes and 2D over frames."""

    num_channels: Tuple[int, ...] = (32, 64, 128)
    use_sigmoid: bool = False
    get_interm_feat: bool = True
    head: str = "conv"                 # "conv" (PatchGAN) | "dense"


@dataclass(frozen=True)
class VQGANConfig:
    """A VQ-GAN: the autoencoder, both critics, LPIPS and the loss
    weights of `train.gan_trainer.GANTrainer`."""

    ae: VQVAEConfig = field(default_factory=lambda: VQVAEConfig(
        norm="group", act="silu",
        quantizer=QuantizerConfig(kind="ema")))
    disc: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    disc_threshold: int = 40           # epochs before the critics start
    disc_loss_fn: str = "vanilla"      # "vanilla" | "hinge"
    g_adv_style: str = "wgan"          # "wgan": -mean(fake) | "bce"
    disc_wt: float = 0.8
    lpips_wt: float = 4.0
    gan_feat_wt: float = 4.0
    g_loss_adv_wt: float = 1.0
    recon_loss: str = "l1"
    frame_idx_range: Tuple[int, int] = (30, 120)  # the random 2D frame
    lpips_image_size: int = 128
    # the adaptive generator weight ||grad_rec|| / (||grad_adv|| + 1e-6),
    # clipped to [0, adaptive_g_max], at the generator's output
    adaptive_g_weight: bool = False
    adaptive_g_max: float = 1e4
    # epochs after disc_threshold during which only the critics train
    g_adv_delay: int = 0
    # R1 penalty gamma / 2 * E||grad_x D(x)||^2 on real inputs; 0 = off
    r1_gamma: float = 0.0


@dataclass(frozen=True)
class UNetConfig:
    """3D diffusion U-Net."""

    widths: Tuple[int, ...] = (64, 128, 256)
    has_attention: Tuple[bool, ...] = (False, False, True, True)
    num_res_blocks: int = 2
    first_conv_channels: int = 64
    context_dim: Optional[int] = None  # None => unconditional
    num_heads: int = 1
    norm: str = "batch"
    # probability of the null context token at train time; > 0 allocates
    # one extra embedding row (null index = context_dim + 1)
    cfg_dropout: float = 0.0
    # add the context embedding to the time embedding as well
    context_in_time: bool = False


@dataclass(frozen=True)
class DiffusionConfig:
    """DDPM schedule and sampling settings."""

    timesteps: int = 300
    beta_start: float = 1e-4
    beta_end: float = 0.02
    latent_size: int = 8
    latent_channels: int = 256
    prediction_type: str = "eps"      # "eps" | "v"
    min_snr_gamma: Optional[float] = None
    # gradient loss: "mean" MSE, or "ref" = SUM-MSE / (batch * lc^4)
    loss_reduction: str = "mean"
    latent_scale: float = 1.0
    clip_sample_range: float = 1.0     # <= 0 disables clipping
    unet: UNetConfig = field(default_factory=UNetConfig)
    vqvae: VQVAEConfig = field(default_factory=lambda: VQVAEConfig(
        in_channels=1, out_channels=1,
        num_channels=(32, 64, 128, 256), num_res_channels=(32, 64, 128, 256),
        num_res_layers=5,
        downsample_stride=(2, 2, 2, 2), downsample_kernel=(4, 4, 4, 4),
        upsample_stride=(2, 2, 2, 2), upsample_kernel=(4, 4, 4, 4),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=1024,
                                  embedding_dim=256)))

    @property
    def volume_size(self) -> int:
        return self.latent_size * self.vqvae.spatial_factor


@dataclass(frozen=True)
class MeshConfig:
    """The process mesh of training (`parallel.mesh.make_mesh`): data
    parallelism over 'data', spatial sharding over 'space', conv-channel
    sharding over 'model'. -1 on 'data' uses every process."""

    data: int = -1
    space: int = 1
    model: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """The optimizer, EMA, seed and mesh settings of training."""

    batch_size: int = 8                # global batch ("ref" loss divisor)
    learning_rate: float = 1e-4
    disc_learning_rate: float = 1e-4   # the VQ-GAN critics' Adam
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    seed: int = 0
    # EMA of the U-Net weights, used for sampling when > 0
    ema_decay: float = 0.0
    epochs: int = 200
    val_fraction: float = 0.1
    # compute dtype of the trainers' networks; params stay float32
    # (`compute_dtype`)
    dtype: str = "bfloat16"
    replace_codebook_freq: int = 10    # epochs between unused-code replacement
    checkpoint_every: int = 1
    keep_checkpoints: int = 5
    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass(frozen=True)
class DataConfig:
    """NIfTI ingest and the preprocessed volume cache."""

    dataset: str = "all"               # CC | NFBS | HCP | BraTS | all | all-T
    dataset_dir: str = "/data/mri"
    cache_dir: str = "./cache"
    volume_size: int = 128
    augment: bool = False
    augment_fraction: float = 0.04
    flip_chance: float = 0.6           # probability of KEEPING the original
    brightness_range: Tuple[float, float] = (0.9, 1.1)
    contrast_range: Tuple[float, float] = (0.9, 1.1)
    test_run: bool = False             # truncate to 24 files
    # host -> device batch dtype: the cache is float16, so moving float16
    # and widening on the device is exact and halves the bytes moved
    transfer_dtype: str = "float16"    # the port moves float16 only
    # synthetic-corpus class count (`data/synthetic.py`)
    num_classes: int = 2


@dataclass(frozen=True)
class ExperimentConfig:
    """One run of the command line: a stage-1 VQ-VAE (`vqvae`) or VQ-GAN
    (`vqgan`, when `model` is "vqgan") for --train_vq / --test_vq, a
    diffusion model, their training, the data and where checkpoints go."""

    name: str = "default"
    # the JAX package's model name: "vqgan" trains `vqgan` in the stage-1
    # modes; the diffusion modes read whether it is "conditional_dm" (one
    # sample file per context)
    model: str = "vqvae"
    vqvae: VQVAEConfig = field(default_factory=VQVAEConfig)
    vqgan: VQGANConfig = field(default_factory=VQGANConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    ckpt_dir: str = "./checkpoints"


def replace(cfg, **kwargs):
    """`dataclasses.replace` over the frozen config tree."""
    return dataclasses.replace(cfg, **kwargs)


def flagship_cfg(tiny: bool = False) -> DiffusionConfig:
    """The flagship conditional latent-diffusion model: T=500 eps-prediction
    DDPM on 8^3 x 256 latents of a 128^3 volume, stem 256 / widths
    (256, 512) U-Net with cross-attention at the 4^3 level and in the
    middle, 4 classes plus a null row, a 4-level GroupNorm VQ-VAE and an
    STE quantizer with K=1024, D=256.
    `tiny=True` gives the small variant the parity tests run on the CPU
    (T=8, 4^3 x 8 latents, 16^3 volumes, K=16)."""
    if tiny:
        vq = VQVAEConfig(
            in_channels=1, out_channels=1,
            num_channels=(4, 8), num_res_channels=(4, 8), num_res_layers=1,
            downsample_stride=(2, 2), downsample_kernel=(4, 4),
            upsample_stride=(2, 2), upsample_kernel=(4, 4),
            quantizer=QuantizerConfig(kind="ste", num_embeddings=16,
                                      embedding_dim=8))
        unet = UNetConfig(widths=(8, 16), has_attention=(False, True),
                          num_res_blocks=1, first_conv_channels=8,
                          context_dim=1)
        return DiffusionConfig(timesteps=8, latent_size=4, latent_channels=8,
                               unet=unet, vqvae=vq)
    unet = UNetConfig(widths=(256, 512),
                      has_attention=(False, True, True),
                      num_res_blocks=2, first_conv_channels=256,
                      context_dim=3, cfg_dropout=0.1)
    vq = VQVAEConfig(
        in_channels=1, out_channels=1, num_res_layers=5, norm="group",
        num_channels=(32, 64, 128, 256),
        num_res_channels=(32, 64, 128, 256),
        downsample_stride=(2, 2, 2, 2), downsample_kernel=(4, 4, 4, 4),
        upsample_stride=(2, 2, 2, 2), upsample_kernel=(4, 4, 4, 4),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=1024,
                                  embedding_dim=256))
    return DiffusionConfig(timesteps=500, latent_size=8,
                           latent_channels=256, unet=unet, vqvae=vq,
                           latent_scale=20.834, clip_sample_range=0.0)


def compute_dtype(name: str):
    """The torch dtype of `TrainConfig.dtype`: bfloat16 for "bfloat16",
    float32 for anything else, as the JAX trainers read the field."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32

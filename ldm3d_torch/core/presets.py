"""Named experiment presets: the port's copy of the stage-1 and diffusion
presets of `ldm3d.core.presets`, with the same names and values.

  - vqvae_b8_all             3-level 32/64/128 VQ-VAE, K=512, D=256,
                             2 channels (volume and mask)
  - vqvae_5level_test        5-level, K=1024, D=512
  - vqvae_dm_stage1          the 4-level stage-1 of the diffusion models
                             (K=1024, D=256, 8^3 latents of 128^3)
  - nsvqvae / rnsvqvae       noise-substitution quantizers (4 and 3
                             levels; RNSVQ with 4 residual stages)
  - dm3d / conditional_dm3d  unconditional T=300 and conditional T=500
                             latent diffusion over a frozen 4-level VQ-VAE
                             (K=1024, D=256, 8^3 latents of 128^3 volumes)
  - emavqvae                 the skip-connection EMA VQ-VAE (8/16/32
                             filters, K=512, D=128)
  - vqvae_legacy             the legacy functional VQ-VAE (K=64, D=16)
  - vqgan_attn               the VQ-GAN: GroupNorm/SiLU "attn_cp"
                             autoencoder (32/64/128, EMA K=512, D=256,
                             32^3 latents of 128^3), conv-head critics,
                             Adam(0.5, 0.9), critics from epoch 40
  - vqgan_attn_sym           the SYMMETRIC-pad "attn" family (64/128, EMA
                             K=128, D=64), 64/128/256 critics
  - vqgan_baseline / vqgan_gnorm  the MONAI autoencoder (BatchNorm +
                             PReLU, or GroupNorm), dense-head critics,
                             BCE generator loss
  - vqgan_stride             residual units before stride-1 convs,
                             average-pool downs
  - smoke / smoke_cond       CPU-sized versions (T=8, 4^3 x 8 latents of
                             16^3 volumes, float32)
"""

from __future__ import annotations

from typing import Callable, Dict

from ldm3d_torch.core.config import (DataConfig, DiffusionConfig,
                                     DiscriminatorConfig, ExperimentConfig,
                                     QuantizerConfig, TrainConfig,
                                     UNetConfig, VQGANConfig, VQVAEConfig,
                                     replace)

_REGISTRY: Dict[str, Callable[[], ExperimentConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_preset(name: str) -> ExperimentConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown preset '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_presets():
    return sorted(_REGISTRY)


def _levels(channels, k=4, s=2):
    n = len(channels)
    return dict(num_channels=tuple(channels),
                num_res_channels=tuple(channels),
                downsample_stride=(s,) * n, downsample_kernel=(k,) * n,
                upsample_stride=(s,) * n, upsample_kernel=(k,) * n)


@register("vqvae_b8_all")
def _vqvae_b8_all() -> ExperimentConfig:
    vq = VQVAEConfig(
        remat=True, in_channels=2, out_channels=2, num_res_layers=3,
        **_levels((32, 64, 128)),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=512,
                                  embedding_dim=256))
    return ExperimentConfig(name="vqvae_b8_all", model="vqvae", vqvae=vq,
                            train=TrainConfig(batch_size=8,
                                              learning_rate=1e-4))


@register("vqvae_5level_test")
def _vqvae_5level() -> ExperimentConfig:
    vq = VQVAEConfig(
        remat=True, in_channels=2, out_channels=2, num_res_layers=3,
        **_levels((32, 64, 128, 256, 512)),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=1024,
                                  embedding_dim=512))
    return ExperimentConfig(name="vqvae_5level_test", model="vqvae", vqvae=vq)


@register("vqvae_dm_stage1")
def _vqvae_dm_stage1() -> ExperimentConfig:
    """The stage-1 of dm3d / conditional_dm3d: with --norm group it is the
    flagship's."""
    vq = VQVAEConfig(
        remat=True, in_channels=1, out_channels=1, num_res_layers=5,
        **_levels((32, 64, 128, 256)),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=1024,
                                  embedding_dim=256))
    return ExperimentConfig(name="vqvae_dm_stage1", model="vqvae", vqvae=vq)


@register("nsvqvae")
def _nsvqvae() -> ExperimentConfig:
    vq = VQVAEConfig(
        remat=True, in_channels=1, out_channels=1, num_res_layers=3,
        **_levels((32, 64, 128, 256)), act="swish",
        quantizer=QuantizerConfig(kind="nsvq", num_embeddings=512,
                                  embedding_dim=256,
                                  discarding_threshold=0.01,
                                  quantize_loss_weight=1e2))
    return ExperimentConfig(name="nsvqvae", model="nsvqvae", vqvae=vq)


@register("rnsvqvae")
def _rnsvqvae() -> ExperimentConfig:
    vq = VQVAEConfig(
        remat=True, in_channels=1, out_channels=1, num_res_layers=3,
        **_levels((32, 64, 128)),
        quantizer=QuantizerConfig(kind="rnsvq", num_embeddings=256,
                                  embedding_dim=128, num_stages=4,
                                  discarding_threshold=0.01,
                                  quantize_loss_weight=1e2))
    return ExperimentConfig(name="rnsvqvae", model="rnsvqvae", vqvae=vq)


@register("emavqvae")
def _emavqvae() -> ExperimentConfig:
    vq = VQVAEConfig(
        in_channels=1, out_channels=1, family="ema_skip",
        **_levels((8, 16, 32, 64)),
        quantizer=QuantizerConfig(kind="ema_sonnet", num_embeddings=512,
                                  embedding_dim=128, commitment_cost=6.0))
    return ExperimentConfig(name="emavqvae", model="emavqvae", vqvae=vq)


def _gan_train(disc_lr: float = 1e-4, b1: float = 0.9,
               b2: float = 0.999) -> TrainConfig:
    return TrainConfig(batch_size=2, learning_rate=1e-4,
                       disc_learning_rate=disc_lr, adam_b1=b1, adam_b2=b2)


@register("vqgan_attn")
def _vqgan_attn() -> ExperimentConfig:
    ae = VQVAEConfig(
        remat=True, in_channels=2, out_channels=2, num_res_layers=1,
        norm="group", act="silu", **_levels((32, 64, 128)),
        quantizer=QuantizerConfig(kind="ema", num_embeddings=512,
                                  embedding_dim=256))
    gan = VQGANConfig(ae=ae,
                      disc=DiscriminatorConfig(num_channels=(32, 64, 128)),
                      disc_threshold=40)
    return ExperimentConfig(name="vqgan_attn", model="vqgan", vqgan=gan,
                            train=_gan_train(b1=0.5, b2=0.9))


@register("vqgan_attn_sym")
def _vqgan_attn_sym() -> ExperimentConfig:
    ae = VQVAEConfig(
        remat=True, in_channels=2, out_channels=2, num_res_layers=1,
        norm="group", act="silu", arch="attn",
        num_channels=(64, 128), num_res_channels=(64, 128),
        quantizer=QuantizerConfig(kind="ema", num_embeddings=128,
                                  embedding_dim=64))
    gan = VQGANConfig(
        ae=ae, disc=DiscriminatorConfig(num_channels=(64, 128, 256)),
        disc_threshold=40, disc_loss_fn="vanilla")
    return ExperimentConfig(name="vqgan_attn_sym", model="vqgan", vqgan=gan,
                            train=_gan_train(b1=0.5, b2=0.9))


@register("vqgan_baseline")
def _vqgan_baseline() -> ExperimentConfig:
    ae = VQVAEConfig(
        remat=True, in_channels=2, out_channels=2, num_res_layers=3,
        norm="batch", act="prelu", arch="monai",
        **_levels((32, 64, 128)),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=512,
                                  embedding_dim=256))
    gan = VQGANConfig(
        ae=ae, disc=DiscriminatorConfig(num_channels=(32, 64, 128),
                                        head="dense"),
        disc_threshold=40, g_adv_style="bce", disc_loss_fn="vanilla")
    return ExperimentConfig(name="vqgan_baseline", model="vqgan", vqgan=gan,
                            train=_gan_train(disc_lr=1e-5))


@register("vqgan_gnorm")
def _vqgan_gnorm() -> ExperimentConfig:
    ae = VQVAEConfig(
        remat=True, in_channels=2, out_channels=2, num_res_layers=3,
        norm="group", arch="monai", **_levels((32, 64, 128)),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=512,
                                  embedding_dim=256))
    gan = VQGANConfig(
        ae=ae, disc=DiscriminatorConfig(num_channels=(32, 64, 128),
                                        head="dense"),
        disc_threshold=40, g_adv_style="bce",
        disc_wt=0.8, lpips_wt=4.0, gan_feat_wt=4.0, g_loss_adv_wt=1.0)
    return ExperimentConfig(name="vqgan_gnorm", model="vqgan", vqgan=gan,
                            train=_gan_train())


@register("vqgan_stride")
def _vqgan_stride() -> ExperimentConfig:
    ae = VQVAEConfig(
        remat=True, in_channels=2, out_channels=2, num_res_layers=3,
        norm="batch", arch="stride", **_levels((32, 64, 128)),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=512,
                                  embedding_dim=256))
    gan = VQGANConfig(
        ae=ae, disc=DiscriminatorConfig(num_channels=(32, 64, 128)),
        disc_threshold=40, g_adv_style="bce")
    return ExperimentConfig(name="vqgan_stride", model="vqgan", vqgan=gan,
                            train=_gan_train())


def _dm(conditional: bool, timesteps: int) -> ExperimentConfig:
    # stem 256 on a 256-channel latent for the conditional model: the
    # reference's 32-channel stem floors the eps-MSE (see the JAX preset)
    unet = UNetConfig(
        widths=(256, 512) if conditional else (64, 128, 256),
        has_attention=(False, True, True) if conditional
        else (False, False, True, True),
        num_res_blocks=2,
        first_conv_channels=256 if conditional else 64,
        context_dim=1 if conditional else None)
    vq = VQVAEConfig(
        remat=True, in_channels=1, out_channels=1, num_res_layers=5,
        **_levels((32, 64, 128, 256)),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=1024,
                                  embedding_dim=256))
    diff = DiffusionConfig(timesteps=timesteps, latent_size=8,
                           latent_channels=256, unet=unet, vqvae=vq)
    name = "conditional_dm3d" if conditional else "dm3d"
    return ExperimentConfig(name=name,
                            model="conditional_dm" if conditional else "dm",
                            diffusion=diff,
                            train=TrainConfig(batch_size=8,
                                              learning_rate=1e-4))


@register("dm3d")
def _dm3d() -> ExperimentConfig:
    return _dm(conditional=False, timesteps=300)


@register("conditional_dm3d")
def _conditional_dm3d() -> ExperimentConfig:
    return _dm(conditional=True, timesteps=500)


@register("vqvae_legacy")
def _vqvae_legacy() -> ExperimentConfig:
    vq = VQVAEConfig(
        in_channels=1, out_channels=1, family="legacy", legacy_mode=1,
        legacy_down=3,
        quantizer=QuantizerConfig(kind="ste", num_embeddings=64,
                                  embedding_dim=16))
    return ExperimentConfig(name="vqvae_legacy", model="vqvae", vqvae=vq,
                            train=TrainConfig(batch_size=8,
                                              learning_rate=1e-4))


@register("smoke")
def _smoke() -> ExperimentConfig:
    """CPU-runnable smoke config: a 2-channel stage-1 (`vqvae`, for
    --train_vq) and a diffusion model over a 1-channel stage-1
    (`diffusion`)."""
    vq = VQVAEConfig(
        in_channels=2, out_channels=2, num_res_layers=1,
        **_levels((4, 8)),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=16,
                                  embedding_dim=8))
    unet = UNetConfig(widths=(8, 16), has_attention=(False, True),
                      num_res_blocks=1, first_conv_channels=8,
                      context_dim=1)
    dm_vq = VQVAEConfig(
        in_channels=1, out_channels=1, num_res_layers=1,
        **_levels((4, 8)),
        quantizer=QuantizerConfig(kind="ste", num_embeddings=16,
                                  embedding_dim=8))
    diff = DiffusionConfig(timesteps=8, latent_size=4, latent_channels=8,
                           unet=unet, vqvae=dm_vq)
    return ExperimentConfig(
        name="smoke", model="vqvae", vqvae=vq, diffusion=diff,
        train=TrainConfig(batch_size=2, epochs=2, dtype="float32"),
        data=DataConfig(volume_size=16, test_run=True))


@register("smoke_cond")
def _smoke_cond() -> ExperimentConfig:
    """Conditional counterpart of `smoke`."""
    return replace(_smoke(), name="smoke_cond", model="conditional_dm")

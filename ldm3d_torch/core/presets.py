"""Named experiment presets: the port's copy of the diffusion presets of
`ldm3d.core.presets`, with the same names and values.

  - dm3d / conditional_dm3d  unconditional T=300 and conditional T=500
                             latent diffusion over a frozen 4-level VQ-VAE
                             (K=1024, D=256, 8^3 latents of 128^3 volumes)
  - smoke / smoke_cond       CPU-sized versions (T=8, 4^3 x 8 latents of
                             16^3 volumes, float32)

The JAX package's stage-1 presets (VQ-VAE, NSVQ, RNSVQ, EMA-VQ-VAE,
legacy) and VQ-GAN presets are known by name and refused: stage-1 training
and the VQ-GAN family are not ported yet (ROADMAP queue 1 items 6 and 7).
"""

from __future__ import annotations

from typing import Callable, Dict

from ldm3d_torch.core.config import (DataConfig, DiffusionConfig,
                                     ExperimentConfig, QuantizerConfig,
                                     TrainConfig, UNetConfig, VQVAEConfig,
                                     replace)

_REGISTRY: Dict[str, Callable[[], ExperimentConfig]] = {}

# presets of the JAX package whose model the port cannot build yet
STAGE1_PRESETS = ("vqvae_b8_all", "vqvae_5level_test", "vqvae_dm_stage1",
                  "nsvqvae", "rnsvqvae", "emavqvae", "vqvae_legacy")
VQGAN_PRESETS = ("vqgan_attn", "vqgan_attn_sym", "vqgan_baseline",
                 "vqgan_gnorm", "vqgan_stride")


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_preset(name: str) -> ExperimentConfig:
    if name in STAGE1_PRESETS or name in VQGAN_PRESETS:
        raise NotImplementedError(
            f"preset '{name}' is a stage-1 VQ-VAE or VQ-GAN model, which "
            f"ldm3d_torch does not port yet (ROADMAP queue 1 items 6 and "
            f"7: stage-1 training, the VQ-GAN family); the port has "
            f"{sorted(_REGISTRY)}")
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
        in_channels=1, out_channels=1, num_res_layers=5,
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


@register("smoke")
def _smoke() -> ExperimentConfig:
    """CPU-runnable smoke config. Its model name is the JAX preset's
    ("vqvae", the stage-1 smoke model); the diffusion modes use its
    `diffusion` subtree."""
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
        name="smoke", model="vqvae", diffusion=diff,
        train=TrainConfig(batch_size=2, epochs=2, dtype="float32"),
        data=DataConfig(volume_size=16, test_run=True))


@register("smoke_cond")
def _smoke_cond() -> ExperimentConfig:
    """Conditional counterpart of `smoke`."""
    return replace(_smoke(), name="smoke_cond", model="conditional_dm")

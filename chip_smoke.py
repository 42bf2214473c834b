#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                        # every phase below
    python3 chip_smoke.py --train-compare-check  # device, build, train and
                                                 # train_compare_check only,
                                                 # with the float32-island
                                                 # bisection of the card's
                                                 # gap against float64
    python3 chip_smoke.py --gan-compare-check    # device, build, and the
                                                 # VQ-GAN steps at 64^3: the
                                                 # card and a float32 CPU
                                                 # twin against float64
    python3 chip_smoke.py --ddp-check            # device, build, and the
                                                 # ddp phase's two steps,
                                                 # cuDNN default and
                                                 # deterministic, each
                                                 # one-process step against
                                                 # itself and (stage 2,
                                                 # deterministic) float64,
                                                 # printed
    python3 chip_smoke.py --spatial-check        # device, build, and the
                                                 # spatial phase's two
                                                 # steps, each and its
                                                 # one-process twin against
                                                 # float64 CPU steps,
                                                 # printed
    python3 chip_smoke.py --spatial-check --seed 1   # the same from
                                                 # another seed (inputs and
                                                 # weights)
    python3 chip_smoke.py --tp-check             # device, build, and the
                                                 # tp phase's two steps
                                                 # with their gates,
                                                 # printed, not judged
    python3 chip_smoke.py --bf16-check           # device, build, and the
                                                 # bf16 phase (a)-(f)
    python3 chip_smoke.py --bf16-gate-faults     # device, build, and the
                                                 # bf16 phase's (g) step
                                                 # over data, space and
                                                 # model meshes, clean and
                                                 # with faults planted:
                                                 # each fault must fail its
                                                 # gate
    python3 chip_smoke.py --s1-gate-faults       # device, build, and the
                                                 # spatial and tp phases'
                                                 # stage-1 step under its
                                                 # float64 gate, clean and
                                                 # with faults planted: each
                                                 # fault must fail by 2x
    python3 chip_smoke.py --mesh-check           # device, build, and the
                                                 # mesh phase's gated steps
                                                 # with their gates,
                                                 # printed, not judged
    python3 chip_smoke.py --mesh-gate-faults     # device, build, and the
                                                 # mesh phase's steps with
                                                 # MESH_GATE_FAULTS planted
                                                 # one at a time: each
                                                 # fault must fail by 2x
    python3 chip_smoke.py --seed 1               # every phase from
                                                 # another seed

Phases, one line each (flush=True); any failure raises and the exit code is
not 0:
  1. device     the card, and nvidia-smi's name and power limit
  2. build      nvcc builds every CUDA kernel of the two paths from
                ldm3d_torch/csrc, one compiler per source, all at once
  3. kernel     each kernel against its plain PyTorch version on the card,
                with CUDA-event times beside its bound and a library yardstick:
                device time from a replayed CUDA graph of 200 calls, and
                eager time (host work per call included) beside it
     kernel_shapes  both kernels at odd shapes (widths that are no multiple
                of 16 bytes, one row, many key and code tiles) against the
                plain versions, untimed
  4. attention_grad  gradients through the attention kernel's autograd
                Function against plain autograd, at the train shape
     init       the trainers' JAX init (init_random, scheme "jax") at full
                width on the card: flagship stage 2, flagship stage 1 and
                vqgan_attn with its critics and LPIPS; every zero-init
                tensor exactly zero, each kind's standard deviation within
                10 % (the random-weight checks below use scheme "reach")
  5. unet_step  one full-width U-Net step on the card against the CPU, f32
                with TF32 off
  6. serve      main path 1: GenerationService at full flagship width from a
                seeded random init answers a DDPM request and its repeat
                in process; the launch counters are zeroed before the
                first and read after the last
  7. breakdown  a request's U-Net step and decode times
     serve_profile  one unguided DDPM step (U-Net + sampler) at batch 16,
                timed with utils/profiling's StepTimer and profiled with
                its profile_steps: kernels per step, device ms, the busy
                share, the kernel groups
     serve_samplers  main path 3: the same service answers DDIM, DPM++ and
                DPM++ SDE requests, guided ones (the U-Net at 2 x num) and
                one through a v-prediction twin of the weights, and the
                trainer samples latents only (decode=False); the counters
                are zeroed before the first and read after the last; then
                U-Net step times at batch 16 and 32
     sampler_compare  guided DDIM (eta 0.5) and DPM++ SDE, 3 steps at
                num 2 with injected noise, on the card (kernel) against
                the CPU (plain), f32 with TF32 off
     fidelity   main path 4: real features of two batches of 8 seeded
                volumes (the codebook kernel), then fidelity_eval at its
                defaults (64 samples, batch 16, 4 contexts, DDIM 25 steps)
                with per-class splits; the counters are zeroed before and
                read after
     bf16       main path 11: the JAX default compute dtype, bfloat16
                activations over float32 parameters (every other phase
                runs float32). The bf16 attention kernel at the paths'
                shapes; (a) the full-width U-Net at batch 16 against the
                card's float32 forward, and its dtype census; (b) a
                served T=500 DDPM request and its repeat on cuDNN's
                global defaults (6,000 bf16 attention launches each, no
                codebook launch; within 1e-5: generate decodes with the
                deterministic algorithms), that decode's cost in both
                dtypes, and the serve step's profile; (c) a guided DDIM
                50 request, and a v-prediction DDIM 50 request through a
                v twin of the weights and its repeat (within 1e-5),
                beside float32's; (d)
                three latent steps beside a float32 twin of the same
                weights; (e) the stage-1 step with remat full and off
                (codebook launches float32); (f) both vqgan_attn programs
                (train_vq and train_gan time their float32 steps). (g),
                a sharded bf16 latent step against one process, runs in
                the ddp, spatial and tp workers
  8. encode     the full-width encoder + STE quantizer on the card against
                the CPU, f32 with TF32 off
  9. train      main path 2: a seeded full-width DiffusionTrainer encodes two
                batches of 8 volumes (as --cache_latents does), derives the
                latent scale, and takes 3 steps on volumes and 3 on cached
                latents; the counters are zeroed before and read after
 10. train_compare  one latent step at batch 2 on the card against a
                float64 CPU step with injected draws: loss, gradients,
                parameter changes
 11. train_breakdown  encode and step times, attention's share of a step,
                and a torch.profiler table of two latent steps (device time
                by kernel, the device's busy share)
 12. cli        main path 5: the command line in process, at full flagship
                width, in a temporary directory removed at the end (it
                checks the free disk first): the conditional_dm3d preset
                and flags equal flagship_cfg() (its stage-1 with remat
                on); --create_dataset
                --synthetic (24 volumes, 128^3); --train_dm --cache_latents
                for one epoch at --lbs 8 (codebook launches = the split's
                batches, 12 attention launches per U-Net call); the
                epoch-1 checkpoint restored into a fresh trainer equals the
                saving one and takes the same step; --resume_ckpt -1 to
                epoch 2; --test_dm DDIM 10; --fidelity_sweep over DDIM 10 /
                DPM++ 10 x unguided / guided 3 at 16 samples with per-class
                FID (four rows, both kernels); --test_dm --profile (DDIM 2),
                whose Chrome trace must name the attention kernel;
                from_checkpoint serves DDIM 20 at num 16 within 1e-5 of the
                trainer's own generate; then the serve CLI as a user
                starts it (python -m ldm3d_torch.serve --preset
                conditional_dm3d --norm group --ckpt_dir <the run's>
                --port 0; the GPU, bfloat16) in a process of its own:
                the card's used memory grows as it starts, it answers
                GET /healthz, one POST /generate per sampler at num 16
                (DDPM T=500, guided DDIM 50, DPM++ 20, DPM++ SDE 50),
                the guided one again (within 1e-5), a .nii.gz answer, a
                refused request (400) and a good one after it (200),
                each finite and of the right shape, with its status,
                bytes, wall and vol/min; it has the CUDA driver and the
                attention kernel's library mapped; the guided answer
                within 1e-5 of the same request to a service built in
                this process as the CLI builds it (600 bf16 attention
                launches, counted), the HTTP front's cost; SIGINT stops
                it with exit code 0
     quantizers  (after encode) each of the five quantizer kinds, one
                training-mode forward and backward at 1,024 rows, K = 64,
                on the card against the CPU with injected draws
 13. train_vq   main path 6: the flagship's stage-1 (vqvae_dm_stage1
                --norm group) from the command line in process, in a
                temporary directory: --create_dataset --synthetic (24 x
                128^3), --train_vq one epoch at --lbs 8 with a validation
                batch, image montages and codebook replacement (2 steps +
                1 eval + 1 montage = 4 codebook launches), a bitwise resume
                check, --test_vq (2 launches: eval, reconstruct), SSIM /
                PSNR card vs CPU, --train_dm --cache_latents
                --vqvae_load_ckpt <that stage-1> --test_run one epoch (2
                codebook, 24 attention launches), one step each of
                a --sweep over two learning rates (one epoch each, 2 x 3
                launches); one --train_vq --synthetic --device_data epoch
                (3), and the DeviceSyntheticLoader's first batch equal to
                the cache DataLoader's, bit for bit, on the native reader;
                nsvqvae (1 launch) and rnsvqvae (4); then, uncounted, the
                stage-1 step's time and peak memory with remat full, conv
                and off (2 steps each on one trainer) and its profile
     ddp        main path 8: data parallelism. Two processes of this script
                (--ddp-worker) on the one card, joined by gloo over
                localhost ports: the flagship's latent step at global batch
                8 (4 rows each, global draws injected; 12 attention
                launches each) and its stage-1 at 128^3, global batch 4
                (remat full; one codebook launch each), each against the
                one-process step of a twin on process 0 (TF32 off and
                cuDNN deterministic on both sides: loss, every gradient
                to its group's bound, BatchNorm statistics) and
                bitwise equal across the processes; the step's time, the
                gradients' all-reduce alone, the peak memory of each
                process; (g), the latent step in bfloat16 (12 bf16
                attention launches each) against a one-process bfloat16
                step; then --train_dm --cache_latents from the command
                line with --num_processes 2 at --lbs 4 (the cli phase's
                global batch 8), one epoch and --resume_ckpt -1 to a
                second: one checkpoint directory, process 0's epoch-1 loss
                against the cli phase's one-process epoch
     spatial    main path 9: spatial parallelism. Two processes of this
                script (--spatial-worker) on the one card, a data 1 x
                space 2 mesh over gloo, each one depth slab of every
                volume: the flagship's stage-1 at 128^3, global batch 2
                (remat full; one codebook launch each), and its latent
                step at global batch 8 (12 attention launches each, on
                the 4^3 level's 2-row slabs), each against the
                one-process step of a twin and a float64 step on process
                0 (TF32 off, cuDNN deterministic; the bounds of SPATIAL_*
                under F64_FACTOR) and bitwise equal
                across the processes; the step times with the halo
                exchanges', the statistics' and the gradients'
                all-reduces timed apart; the stage-1 step's peak with
                remat off below 0.9 of one process's; `generate` (DDIM 3,
                2 samples) from the EMA U-Net with the decode over slabs
                against the twin's; then --train_vq at a space axis of 2 from
                the command line, one epoch on 6 volumes (4 codebook
                launches each)
     tp         main path 10: tensor parallelism. Two processes of this
                script (--tp-worker) on the one card, a data 1 x model 2
                mesh over gloo, each holding half of every conv kernel and
                vector of 64 or more channels of the trained networks and
                every row: the flagship's latent step at global batch 8
                (12 attention launches each) and its stage-1 at 128^3,
                global batch 2 (remat full; one codebook launch each),
                each against a one-process twin on process 0 (TF32 off,
                cuDNN deterministic; both judged against a float64
                step) and bitwise equal across the processes; step times
                with the gathers' and sums' share, parameter + Adam bytes
                and peak memory per process against one process's; then
                from the command line with a model = 2 preset mesh:
                --train_dm --cache_latents one epoch (a checkpoint of one
                process's keys and shapes), --train_vq one epoch, and the
                same with --auto_resume 1 and process 1 failing at the
                epoch's end (both recover and resume at epoch 0; the log
                equals the other run's)
     mesh       main path 12: the JAX package's multi-axis meshes
                (__graft_entry__.dryrun_multichip's data x space x model).
                Launch A, four processes of this script (--mesh-worker)
                on the one card: on data 2 x space 2 the flagship's
                stage-1 at 128^3, global batch 4 (one codebook launch
                each), and its latent step at global batch 8 (12
                attention launches each; BatchNorm statistics and
                gradients over the data x space plane), on data 1 x
                space 4 its stage-1 at global batch 2 with remat full and
                off (32-row slabs, two with a neighbour on each side; the
                remat-off peak per process below 0.9 of one process's);
                then one --train_vq epoch over the plane from the command
                line (12 volumes: 2 steps, an eval batch, a montage, 4
                codebook launches each), its checkpoint restored in one
                process. Launch B, eight processes started with launch A
                (each warms up on one tiny latent step and waits for A to
                end): the latent step on data 2 x space 2 x model 2 (12
                attention launches each), parameter + Adam bytes and peak
                per process against one process's. Every step under the
                float64 gate, its processes equal on what they hold;
                step ms with the collectives timed by kind; then the two
                kernels at the new per-process shapes
     ddp, spatial, tp and mesh judge stage 2, spatial, tp and mesh stage
                1 against a float64 step on the card (F64_FACTOR; stage
                1's float64 twin takes the codes the one-process float32
                step chose)
 14. train_gan  main path 7: the VQ-GAN. A warm and an adversarial step of
                vqgan_attn at full width (R1 and the adaptive weight on,
                32^3) on the card, f32 with TF32 off, against a float64
                twin on the CPU;
                --preset vqgan_attn --train_vq --disc_threshold 1 for 2
                epochs at 128^3 (warm, then adversarial; 2 steps and a
                validation batch each: 6 codebook launches), a bitwise
                resume check, --test_vq (2); one step of each other
                VQ-GAN preset, emavqvae and vqvae_legacy (--vqvae_mode 1
                and 2) at 128^3 (1 each); attention launches 0
                throughout; then, uncounted, the 128^3 warm, adversarial
                and R1 + adaptive step times, the eval time and the peak
                memory, and the R1 + adaptive step's profile and split (R1
                and the adaptive weight each on and off, VGG16 alone)
 15. kernels    one JSON line with the whole run's kernel numbers
 16. last line  {"ok": true, "device": {...}}
Sockets only on localhost, between the ddp, spatial and tp phases' (and
--bf16-gate-faults' and --s1-gate-faults') two processes and the mesh
phase's four and eight, which end (or are killed at DDP_TIMEOUT /
SPATIAL_TIMEOUT / TP_TIMEOUT / MESH_TIMEOUT) before their phase does,
and to the cli phase's serve CLI process, stopped by SIGINT (killed if
anything fails) before the phase ends; one profiler
trace, written in the cli phase's temporary directory; the threads are
the CLI's data loader prefetchers, joined when their epoch ends, and the
native reader's pool. Nothing is written but the builds under
ldm3d_torch/_build/ (the kernels and the native reader) and the cli,
train_vq, ddp, spatial, tp, mesh and train_gan phases' temporary
directories.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import glob
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
import warnings
from functools import partial
from typing import Dict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import ldm3d_torch.ops.attention as attn  # noqa: E402
import ldm3d_torch.ops.quantize as cbq  # noqa: E402
from ldm3d_torch.cli import main as cli  # noqa: E402
from ldm3d_torch.core.config import (QuantizerConfig,  # noqa: E402
                                     TrainConfig, flagship_cfg, replace)
from ldm3d_torch.core.presets import get_preset  # noqa: E402
from ldm3d_torch.data.nifti import load_nifti  # noqa: E402
from ldm3d_torch.data.pipeline import (  # noqa: E402
    DeviceSyntheticLoader, train_val_split)
from ldm3d_torch.models import quantizers, unet3d  # noqa: E402
from ldm3d_torch.models.layers import (Conv3d, _fans,  # noqa: E402
                                       init_params_)
from ldm3d_torch.models.quantizers import Draws, make_quantizer  # noqa: E402
from ldm3d_torch.models.unet3d import (AttentionBlock,  # noqa: E402
                                       CrossAttentionBlock, TimeEmbedding,
                                       UNet3D)
from ldm3d_torch.models.vqvae import VQVAE  # noqa: E402
from ldm3d_torch.ops import _build  # noqa: E402
from ldm3d_torch.ops.metrics import volume_psnr, volume_ssim  # noqa: E402
from ldm3d_torch.parallel import distributed as pdist  # noqa: E402
from ldm3d_torch.serve import GenerationService  # noqa: E402
from ldm3d_torch.train.checkpoint import CheckpointManager  # noqa: E402
from ldm3d_torch.train.dm_trainer import (DiffusionTrainer,  # noqa: E402
                                          LatentDiffusion, auto_latent_scale)
from ldm3d_torch.train.gan_trainer import GANTrainer  # noqa: E402
from ldm3d_torch.train.vq_trainer import VQTrainer  # noqa: E402
from ldm3d_torch.utils import profiling  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense), at a 700 W limit:
# the tensor cores' rate for each input type (float32 at the TF32 rate,
# the fastest units that can do the work), and float32 FMA outside them.
# Every phase but bf16 computes in float32, the dtype its gate and its
# timed figures were set for (they stay comparable across PRs); the bf16
# phase runs the JAX default, TrainConfig().dtype.
F32, BF16 = "float32", "bfloat16"


def _f32(tc: TrainConfig) -> TrainConfig:
    return replace(tc, dtype=F32)


HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
FMA_FLOPS = 67e12
SEED = 0
# a request and its repeat, 500 steps each: the script's time limit holds
# no more (context 0 is served in serve_samplers and fidelity)
REQUESTS = [dict(num=16, context=1, seed=1), dict(num=16, context=1, seed=1)]
# Tolerances, max |kernel - plain| over the output:
#  float32: both sum in float32 in different orders; scores are O(1) and
#           outputs are averages of N(0, 1) values.
#  bfloat16: the kernel rounds unnormalised probabilities to bf16 (as the
#           TPU kernel does), the plain version rounds normalised ones, and
#           both round the output; 4 bf16 ulps at |out| <= 4.
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
UNET_REL_TOL = 1e-4   # card vs CPU, f32 without TF32, relative to max |cpu|
REPEAT_REL_TOL = 1e-5  # the repeated request vs the first
# Main path 3, in this order (the second repeats the first); guided
# requests run the U-Net at 2 x num. V_REQUEST goes through a v-prediction
# twin of the same weights; the decode=False call samples LATENT_STEPS of
# DDIM at batch 16.
SAMPLER_REQUESTS = [
    dict(num=16, context=1, sampler="ddim", sample_steps=50, seed=11),
    dict(num=16, context=1, sampler="ddim", sample_steps=50, seed=11),
    dict(num=16, context=2, sampler="dpmpp", sample_steps=20, seed=12),
    dict(num=16, context=3, sampler="dpmpp_sde", sample_steps=50, seed=13),
    dict(num=16, context=1, sampler="ddim", sample_steps=50,
         guidance_scale=3.0, seed=14),
    dict(num=16, context=0, sampler="ddim", sample_steps=5,
         guidance_scale=0.0, seed=15),
    dict(num=32, context=2, sampler="ddim", sample_steps=5,
         guidance_scale=3.0, seed=16),
]
V_REQUEST = dict(num=16, context=1, sampler="ddim", sample_steps=50, seed=17)
LATENT_STEPS = 25
# Samplers, card (kernel, f32 without TF32) vs CPU (plain), 3 chained steps
# at num 2 from the same injected noise, relative to max |cpu latents|.
# Each U-Net call agrees to UNET_REL_TOL of its largest output (6.1e-6 was
# measured on an H100); guidance at scale 3 multiplies an eps error by at
# most |1 - s| + |s| = 5; the DDIM steps at tau = 499, 250, 0 (eta 0.5)
# move an eps error into x with weights 5.9, 1.6 and 0.01 and carry x's
# error on with 6.6, 1.9 and 1.0, while x itself grows by the same 6.6 and
# 1.9. At the measured per-step agreement that is about 1e-4 of max |x|;
# 1e-3 leaves a factor 10 for the U-Net's sensitivity to its input, which
# random weights do not bound.
SAMPLER_REL_TOL = 1e-3
SAMPLER_COMPARE_STEPS = 3
FIDELITY_VOLUMES = 8   # per real batch; two batches
FIDELITY_SAMPLES, FIDELITY_BATCH = 64, 16   # fidelity_eval's defaults
# Codebook indices, kernel vs plain: equal, or else the float64 distances
# of the two picks differ by at most CB_DIST_TOL. Both sum D = 256 float32
# products of O(1) values in other orders; at distances of O(500) that is
# an error of a few 1e-4, so only near-ties may pick differently.
CB_DIST_TOL = 1e-2
# Attention gradients, kernel Function vs plain autograd at [8, 64, 512]:
# the backward recomputes the plain version, so only the forward's
# rounding (1e-4 at most, ATTN_TOL) can reach them, through nothing: the
# backward never reads the kernel's output.
ATTN_GRAD_TOL = 1e-5
ENCODE_SIZE = 128      # the volume the encode phase checks against the CPU
TRAIN_BATCH = 8        # TrainConfig.batch_size
TRAIN_STEPS = 3        # steps on volumes, then as many on cached latents
# Train step, card (f32 without TF32) vs a float64 CPU step, from one
# state with a fresh optimizer:
#  - the loss to 1e-4 relative (5e-6 is the forward's agreement);
#  - Adam's first moment (0.1 x the gradient) to 1e-3 of its largest
#    value: the card sums weight gradients over up to 2 x 8^3 x 27
#    products in float32 (1.1e-4 measured on an H100 80GB HBM3). The
#    reference was the CPU's float32 step until the check run
#    (--train-compare-check) showed that step 4.3e-4 from float64 where the
#    card is 5e-8 from it;
#  - parameter changes, lr * g / (|g| + 1e-8) after one step, to 1e-2 lr
#    where |g| >= 1e-6: there a gradient error of 1e-6 of the largest
#    gradient moves the step by under 1e-2 lr; below, Adam scales float32
#    noise (e.g. of a conv bias that BatchNorm removes) to any step.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_DELTA_ATOL = 1e-2 * TrainConfig().learning_rate
PROFILE_STEPS = 3      # steps under the profiler, per profiled step
PROFILE_TIMED = 10     # steps timed by StepTimer, after 2 untimed
# The init phase: the standard deviation of each tensor of at least
# INIT_MIN_N elements against its kind's (two draws of n >= 4,096
# elements differ by about sqrt(2 / n) < 2.3 %), and exact zeros.
INIT_MIN_N, INIT_STD_RTOL = 4096, 0.10
# Main path 5 (`cli`): the port's command line, in process. These flags
# make the conditional_dm3d preset the flagship (the phase checks that the
# DiffusionConfig equals flagship_cfg()).
CLI_FLAGSHIP = ["--preset", "conditional_dm3d", "--norm", "group",
                "--num_classes", "4", "--cfg_dropout", "0.1", "--ema_decay",
                "0.999", "--latent_scale", "20.834", "--clip_sample_range",
                "0", "--dtype", F32]
CLI_DEVICE = "cuda"
CLI_VOLUMES, CLI_LBS = 24, 8   # the synthetic corpus, the batch
CLI_KEEP = 2                   # checkpoints kept: at most two saves
CLI_TEST_STEPS = 10            # --test_dm --sampler ddim --sample_steps
CLI_REQUEST = dict(num=16, context=1, sampler="ddim", sample_steps=20,
                   seed=21)
# --fidelity_sweep on the checkpoint: 2 samplers x 2 guidance scales at
# 16 samples (4 per class, one batch of 16 per class); --test_dm
# --profile with few steps, so that the trace stays small
CLI_FIDELITY_STEPS = 10
CLI_FIDELITY_SWEEP = ["--sweep_samplers", "ddim:10,dpmpp:10",
                      "--guidance_grid", "none,3", "--fidelity_samples",
                      "16", "--fidelity_by_class"]
CLI_PROFILE_STEPS = 2
# Resume: a restored trainer and the one that saved it take one latent
# step from the same state with the same injected draws, cuDNN
# deterministic: 0 is expected (the same kernels on the same inputs);
# anything left is a nondeterministic kernel outside cuDNN, and up to 1e-6
# of each tensor's largest value is accepted.
CLI_RESUME_REL_TOL = 1e-6
# The served request against the training trainer's own generate at the
# same seed from the same EMA weights: the same computation twice.
CLI_SERVE_REL_TOL = 1e-5
# The serve CLI over HTTP on the run's checkpoint, as a user starts it:
# `python -m ldm3d_torch.serve` in a process of its own, on the card (no
# --platform) and in the service's bfloat16 (the serve CLI has no
# --dtype, as the JAX one has none). One request per sampler at num 16
# (the DDPM one the run's full T), the guided DDIM one again with its
# seed, a NIfTI answer, a refused request (400) and one answered after
# it (200). The guided DDIM answer is held to REPEAT_REL_TOL of its
# repeat and of the same request to an in-process service built as the
# CLI builds it (`serve.server_from_args`).
HTTP_GUIDED = dict(num=16, context=1, sampler="ddim", sample_steps=50,
                   guidance_scale=3.0, seed=42)
HTTP_REQUESTS = [
    ("ddpm", dict(num=16, context=1, sampler="ddpm", seed=41), 200),
    ("ddim_guided", HTTP_GUIDED, 200),
    ("dpmpp", dict(num=16, context=2, sampler="dpmpp", sample_steps=20,
                   seed=43), 200),
    ("dpmpp_sde", dict(num=16, context=3, sampler="dpmpp_sde",
                       sample_steps=50, seed=44), 200),
    ("ddim_guided_repeat", HTTP_GUIDED, 200),
    ("nii", dict(num=1, context=0, sampler="dpmpp", sample_steps=20,
                 seed=45, format="nii"), 200),
    ("refused", dict(num=16, context=1, sampler="nope", seed=46), 400),
    ("after_refused", dict(num=1, context=1, sampler="ddim",
                           sample_steps=10, seed=47), 200),
]
HTTP_START_TIMEOUT = 300   # s: the process's start, the checkpoint read
HTTP_REQUEST_TIMEOUT = 300
HTTP_STOP_TIMEOUT = 60
# The quantizers phase: each kind, one training-mode forward and backward
# at [2, 8, 8, 8, 32] (1,024 rows) and K = 64 (3 stages for rnsvq), card
# against CPU from the same buffers and injected draws. The card picks
# codes with the kernel (3xTF32), the CPU with the plain version: the
# indices must be equal (against the seeded codebooks the rows' two
# nearest codes lie at least 4.2e-5 apart in float64, at distances of
# O(1): far above float32 rounding, the kernel's error). Everything
# else is float32 arithmetic summed in other orders (the one-hot sums in
# float64 on both sides): 1e-5 of each tensor's largest value.
QUANT_KINDS = ("ste", "ema", "ema_sonnet", "nsvq", "rnsvq")
QUANT_SHAPE, QUANT_K = (2, 8, 8, 8, 32), 64
QUANT_REL_TOL = 1e-5
# Main path 6 (`train_vq`): the flagship's stage-1 from the command line.
# vqvae_dm_stage1 --norm group is flagship_cfg().vqvae with remat on.
TRAIN_VQ_FLAGS = ["--preset", "vqvae_dm_stage1", "--norm", "group",
                  "--dtype", F32]
TRAIN_VQ_VOLUMES, TRAIN_VQ_LBS = 24, 8
TRAIN_VQ_VAL = 0.34        # 8 held-out volumes: one validation batch
TRAIN_VQ_SIZE = 128        # the volume of the direct steps (nsvq, rnsvq,
                           # remat on / off)
REMAT_STEPS = 2            # timed stage-1 steps per remat setting
# --sweep inside train_vq: a grid of two learning rates, one epoch each
TRAIN_VQ_SWEEP = ("method: grid\nmetric:\n  name: val_loss\n"
                  "  goal: minimize\nparameters:\n  lr:\n"
                  "    values: [0.0001, 0.0003]\n  epochs:\n"
                  "    value: 1\n")
# SSIM and PSNR of the card against the CPU on the same volumes: the
# window's sums in float32 in other orders; SSIM 1e-5 absolute, PSNR
# 1e-5 relative.
SSIM_ATOL, PSNR_RTOL = 1e-5, 1e-5
# Main path 7 (`train_gan`): the VQ-GAN. The card-against-CPU steps run
# vqgan_attn's full widths with R1 and the adaptive weight on a 32^3
# volume at batch 2: the card in float32 with TF32 off, the CPU in
# float64 (a twin of the same weights), from one state with injected
# draws. Not 64^3: there the decoder head bias's gradient, a sum over
# 2 x 64^3 voxels of L1 signs and a few large LPIPS frame terms, is
# ill-conditioned in float32 (a float32 CPU step lies 1.2e-3 of the
# largest gradient from float64), and a float64 step at 64^3 takes the
# CPU about 25 s. Tolerances:
#  - every metric to 1e-4 relative (a float32 step is a few 1e-8 from
#    float64 at 32^3; the adaptive weight, a ratio of two gradient norms,
#    1e-5 at seed 0), or, where the card's metric lies past that, to
#    GAN_F64_FACTOR times the distance of a float32 CPU step of the same
#    state and draws from float64: the adaptive weight's conditioning
#    follows the weights (at seed 1 the card lay 2.33e-4 from float64,
#    PERF.md §6), and a card step whose float32 sums are in other orders
#    lies as far as the CPU's;
#  - each subtree's gradients (ae, disc3d, disc2d) to 1e-3 of the
#    subtree's largest, as the diffusion step's (TRAIN_GRAD_RTOL); a
#    float32 CPU step is within 1e-4 of float64 here;
#  - the critics' BatchNorm statistics and the EMA quantizer's buffers to
#    1e-4 of each tensor's largest value.
GAN_FLAGS = ["--preset", "vqgan_attn", "--dtype", F32]
GAN_COMPARE_SIZE, GAN_BATCH = 32, 2
GAN_CHECK_SIZE = 64          # --gan-compare-check: the card at 64^3
GAN_METRIC_RTOL, GAN_GRAD_RTOL, GAN_STATS_RTOL = 1e-4, 1e-3, 1e-4
GAN_F64_FACTOR = 2.0
# the command line at 128^3: 6 volumes, --val_perc 0.34 -> 4 training
# volumes (2 steps at the preset's batch 2) and one validation batch;
# --disc_threshold 1: epoch 1 warm, epoch 2 adversarial
GAN_VOLUMES, GAN_VAL = 6, 0.34
GAN_CLI = ["--disc_threshold", "1", "--epochs", "2"]
GAN_TIMED_STEPS = 2          # timed steps per program at 128^3
GAN_SPLIT_STEPS = 2          # timed steps per variant of the R1 split
# one step each at 128^3: (preset, extra flags, adversarial)
GAN_OTHERS = [("vqgan_attn_sym", [], True), ("vqgan_baseline", [], True),
              ("vqgan_gnorm", [], True), ("vqgan_stride", [], True),
              ("emavqvae", [], False), ("vqvae_legacy", [], False),
              ("vqvae_legacy", ["--vqvae_mode", "2"], False)]
# Main path 11 (`bf16`): the JAX default compute dtype, bfloat16
# activations over float32 parameters (TrainConfig().dtype), on the paths
# the float32 phases above time. Its attention kernel cases at the main
# path's shapes, bfloat16 in and out (ATTN_TOL's 3e-2 against the plain
# version): served [16, 64, 64, 512], guided [32, ...], train [8, ...].
BF16_ATTN_SHAPES = [("self_bf16", 16, 64, 64, 512, torch.bfloat16),
                    ("guided_bf16", 32, 64, 64, 512, torch.bfloat16),
                    ("train_bf16", 8, 64, 64, 512, torch.bfloat16)]
# (a) The full-width U-Net at batch 16, bfloat16 against the card's own
# float32 forward (TF32 off) from the same weights: max |difference| over
# max |float32|. JAX's bfloat16 U-Net lies 1.0e-2 of that from its float32
# one at the tiny config on the CPU; the deeper and wider flagship rounds
# more often, and 5e-2 bounds it.
BF16_UNET_REL_TOL = 5e-2
# (b) The served requests run on cuDNN's global defaults; `generate`
# decodes with the deterministic algorithms (with the defaults the bf16
# decode's transposed convs did not repeat: 8.9e-3-1.1e-2 of the largest
# voxel, PERF.md §5). Its cost: the decode of one request's latents,
# DECODE_RUNS times each way in turns, in each dtype.
DECODE_RUNS = 3
# (c) A guided request: DDIM 50 at scale 3 (the U-Net at 2 x num).
BF16_GUIDED = dict(num=16, context=1, sampler="ddim", sample_steps=50,
                   guidance_scale=3.0, seed=19)
# (d) The latent step's loss, bfloat16 against float32 from one state with
# one set of draws: a mean over 8 x 8^3 x 256 squared errors of a bfloat16
# U-Net, measured 5.8e-5 and 6.8e-5 relative (seeds 0 and 1, PERF.md §5);
# 1e-3, about 15 times that.
BF16_TRAIN_LOSS_RTOL = 1e-3
BF16_TRAIN_STEPS = 3
# (g) The ddp, spatial and tp phases' workers each take one more latent
# step at global batch DDP_BATCH in bfloat16 over their mesh, held against
# a one-process bfloat16 step of the same init and draws (TF32 off, cuDNN
# deterministic on both). Both round bfloat16 activations, in other
# orders (half batches, slab convolutions, other algorithms, the model
# group's float32 sum of partials), so the sharded step is judged
# against bfloat16, not float64: the loss to BF16_S2_LOSS_RTOL relative, and the U-Net's
# gradients (their L2 distance over the one-process norm) to
# BF16_S2_GRAD_FACTOR times bfloat16's own rounding at this step, the
# one-process bfloat16 step's distance from the one-process float32 step.
# A fixed 5e-2 was predicted; the sharded step lay 6.0e-2 / 6.7e-2 (seeds
# 1 / 0, PERF.md §6) from one process, the stem's kernel the worst, and
# bfloat16's own rounding sets that scale.
BF16_S2_LOSS_RTOL, BF16_S2_GRAD_FACTOR = 5e-3, 2.0
# --bf16-gate-faults: (g)'s step alone over each mesh, clean and with one
# fault planted at run time in both workers; every fault must fail the
# gate. The data mesh's fault: the gradients not averaged over the data
# group (each process steps on its own rows' gradient).
# tp.sum_partials is not on the latent step's path (only
# ConvTranspose3d sums partials), so the model mesh's fault is in the
# gradient of a column-split conv's input.
BF16_GATE_FAULTS = [("ddp", None), ("ddp", "grads_unreduced"),
                    ("spatial", None), ("spatial", "drop_halo_grad"),
                    ("spatial", "zero_halo"), ("tp", None),
                    ("tp", "column_grad_unsummed")]
# --s1-gate-faults: the spatial and tp phases' stage-1 step alone over
# each mesh, under its float64 gate, clean and with one fault planted at
# run time in both workers: the halos' gradients not sent back at the
# 32-row slabs (the 64^3 level of a 128^3 volume over two slabs), a
# column-split conv's input gradient not summed over the model group, and
# a transposed conv's partial sums not summed. Each fault must fail the
# gate by S1_FAULT_MARGIN or more (its worst group's distance over its
# limit), each clean step pass it.
S1_GATE_FAULTS = [("spatial", None), ("spatial", "drop_halo_grad_32"),
                  ("tp", None), ("tp", "column_grad_unsummed"),
                  ("tp", "partials_unsummed")]
S1_FAULT_MARGIN = 2.0
# Main path 8 (`ddp`): data parallelism over DDP_PROCESSES processes of
# this script on the one card (gloo, through the host: NCCL needs a card
# per process). Stage 2 at global batch DDP_BATCH, stage 1 at
# DDP_VQ_BATCH volumes of TRAIN_VQ_SIZE^3, the CLI at --lbs DDP_CLI_LBS
# per process (the cli phase's global batch).
DDP_PROCESSES, DDP_BATCH, DDP_VQ_BATCH, DDP_CLI_LBS = 2, 8, 4, 4
DDP_DEVICE, DDP_TINY = "cuda", False
DDP_TIMEOUT = 480                 # seconds for the workers, all of them
# The compared steps run with TF32 off and cuDNN deterministic on both
# sides (the one-process step then repeats bit for bit); --ddp-check
# measured the gaps (PERF.md, §6). The loss: 0 (stage 2) and 2.2e-7
# (stage 1) measured, held to TRAIN_LOSS_RTOL. Each gradient against its
# tensor's largest value, or DDP_GRAD_FLOOR of the model's largest where
# that is smaller (a conv bias before BatchNorm has an exact gradient of
# 0), a tensor taking the bound of the first name pattern it matches:
# stage 1 measured 5.8e-5, held to 1e-3. Stage 2, each group held to
# about 3x its largest measured gap: the cross-attention MLPs
# (xattn_*.mlp1/mlp2) are ill-conditioned in float32 (the one-process
# card step lies up to 9.2e-2 of such a tensor from a float64 CPU step,
# the data-parallel step, another summation order, 7.0e-2 from the
# one-process one), held to 0.1; the other cross-attention tensors
# measured 6.5e-3 (xattn_down_1_0.proj_out.weight), held to 2e-2; the
# rest of the U-Net measured 2.9e-3 (down_res_1_0.conv2.weight), held
# to 1e-2. All together, DDP_MODEL_GRAD_RTOL of the model's largest
# gradient (measured 1.44e-3; one process against float64 1.0e-3).
DDP_LOSS_RTOL = TRAIN_LOSS_RTOL
DDP_GRAD_FLOOR = 1e-3
DDP_S1_GRAD_RTOL = ((None, 1e-3),)
DDP_S2_GRAD_RTOL = ((r"^xattn_[^.]*\.mlp\d\.", 0.1), (r"^xattn_", 2e-2),
                    (None, 1e-2))
DDP_MODEL_GRAD_RTOL = 2e-3
# the CLI's epoch-1 loss against the cli phase's (TF32 convolutions at
# batch 4 and at batch 8; measured 5.1e-7)
DDP_CLI_LOSS_RTOL = 1e-4
# Main path 9 (`spatial`): spatial parallelism over SPATIAL_PROCESSES
# processes of this script on the one card, a data 1 x space 2 mesh (each
# process one depth slab of every volume; gloo, through the host). Stage 1
# (TRAIN_VQ_FLAGS, TRAIN_VQ_SIZE^3) at global batch SPATIAL_VQ_BATCH,
# stage 2's latent step at DDP_BATCH, `generate` (DDIM, SPATIAL_GEN_STEPS
# steps, SPATIAL_GEN_NUM samples) with a sharded decode, and one --train_vq
# epoch of the CLI with a space = 2 preset mesh on SPATIAL_CLI_VOLUMES
# volumes at global batch SPATIAL_VQ_BATCH (--lbs is per process, global =
# lbs x processes, as the JAX CLI's per device). The compared steps run
# TF32 off and cuDNN deterministic on both sides; the loss and BatchNorm
# statistics hold the ddp phase's DDP_LOSS_RTOL, the whole model
# DDP_MODEL_GRAD_RTOL of its largest gradient. Each tensor: the spatial
# step does not repeat the one-process arithmetic (GroupNorm's sums over
# slabs, cuDNN's algorithms for the slab's shapes), and `--spatial-check`
# measured that float32 alone moves these gradients that far (PERF.md
# §6): stage 1 lies 1.11e-2 of a tensor's largest from one process, where
# the one-process step lies 1.02e-2 from a float64 CPU step and the
# spatial step 9.8e-3; the one-process step with GroupNorm's slab
# arithmetic alone lies 9.2e-3 from itself, with cuDNN's default
# algorithms 3.7e-3. Held to 3e-2. Stage 2, per group (the ddp phase's
# groups): the cross-attention MLPs 9.20e-2 from one process (one process
# from float64 9.21e-2, the spatial step 2.2e-2), held to 0.1 as in the
# ddp phase; the other cross-attention tensors 3.09e-2 (one process from
# float64 3.14e-2, spatial 3.18e-2), held to 0.1; the rest 3.3e-3, held
# to 1e-2 as in the ddp phase. These per-tensor bounds hold float32
# noise: a fault of a halo or a gather confined to a few rows can hide
# under them, and is caught by the whole-model bound (measured 7.0e-4 /
# 1.0e-3 of the largest gradient) and by tests/test_torch_spatial.py on
# the CPU (each tensor within 1e-4 of its largest). The decoded volumes:
# SAMPLER_REL_TOL of their largest value (the samplers' card-vs-CPU
# bound). The stage-1 step with remat off must peak below
# SPATIAL_MEMORY_RATIO of the one-process step's peak at the same global
# batch (the JAX package's own contract, __graft_entry__.py).
SPATIAL_S1_GRAD_RTOL = ((None, 3e-2),)
SPATIAL_S2_GRAD_RTOL = ((r"^xattn_[^.]*\.mlp\d\.", 0.1), (r"^xattn_", 0.1),
                        (None, 1e-2))
SPATIAL_PROCESSES, SPATIAL_VQ_BATCH = 2, 2
SPATIAL_GEN_NUM, SPATIAL_GEN_STEPS = 2, 3
SPATIAL_CLI_VOLUMES = 6
SPATIAL_MEMORY_RATIO = 0.9
SPATIAL_TIMEOUT = 480             # seconds for the workers, all of them
# The float64 gate (`_f64_gate`) of the ddp, spatial and tp phases'
# stage-2 steps and of the spatial and tp phases' stage-1 steps: the
# sharded step and the one-process float32 step are both held against a
# float64 step of the same state and draws, taken on the card (stage 2:
# `_float64_twin`, its attention in float64, `_float64_attention`; stage
# 1: `_float64_s1_twin`, which takes the codes the one-process float32
# step chose, `_injected_codes`: the codebook kernel takes float32 and
# bfloat16, and the gate compares arithmetic, not near-ties), and each
# group of DDP_S2_GRAD_RTOL / SPATIAL_S2_GRAD_RTOL / SPATIAL_S1_GRAD_RTOL
# / TP_S1_GRAD_RTOL (and the whole model, DDP_MODEL_GRAD_RTOL) passes
# when the sharded step lies at most the larger of its bound and
# F64_FACTOR times the one-process step's own distance from float64. A
# sharded step sums the same float32 terms in another order, so its
# error is of the one-process step's size, and that size passes the
# bounds: on an H100 the one-process step lies 9.5e-2 (the other
# cross-attention tensors, bound 2e-2) and 3.1e-3 (the model, bound
# 2e-3) from float64 at seed 0, 0.136 (the MLPs, bound 0.1) at seed 1
# (PERF.md §6), which a gate against the one-process step blamed on the
# sharding. In stage 1 the one-process step lies 1.02e-2 of a tensor's
# largest from float64, the spatial and tp steps 9.8e-3 and 9.6e-3.
F64_FACTOR = 2.0
# Main path 10 (`tp`): tensor parallelism over TP_PROCESSES processes of
# this script on the one card, a data 1 x model 2 mesh (the trained
# networks' conv kernels and vectors of 64 or more channels split over
# the two; gloo, through the host; each process holds every row).
# Stage 2's latent step at DDP_BATCH under the float64 gate above (the
# ddp phase's groups); stage 1 (TRAIN_VQ_FLAGS, TRAIN_VQ_SIZE^3, remat
# full) at SPATIAL_VQ_BATCH under it too (TF32 off, cuDNN deterministic;
# the loss DDP_LOSS_RTOL against the one-process twin's, each tensor
# TP_S1_GRAD_RTOL, the model DDP_MODEL_GRAD_RTOL): the tensor-parallel
# step convolves channel slabs and sums partial transposed convolutions,
# other float32 sums than one process's (cuDNN picks other algorithms
# for half-width convolutions): 4.6e-3 of a tensor's largest at seed 0,
# 4.1e-3 at seed 1 (H100, PERF.md §6), held to about 3x that. Then, from
# the command line with a model = 2 preset mesh: --train_dm --cache_latents
# (the cli phase's flags and corpus, --lbs DDP_CLI_LBS per process), and
# --train_vq on SPATIAL_CLI_VOLUMES volumes without and with
# --auto_resume 1 and a failure on process 1 at the epoch's end (the
# recovered run's log against the other's: DDP_CLI_LOSS_RTOL).
TP_PROCESSES = 2
TP_S1_GRAD_RTOL = ((None, 1.5e-2),)
TP_TIMEOUT = 480                  # seconds for the workers, all of them
# Main path 12 (`mesh`): the JAX package's multi-axis meshes
# (`__graft_entry__.dryrun_multichip`: data x space x model 2 x 2 x 2 on
# eight devices, 2 x 2 on four) over processes of this script on the one
# card (gloo, through the host). Launch A, four processes, makes the data
# 2 x space 2 plane and the data 1 x space 4 line in that order: on the
# plane the latent step at DDP_BATCH (BatchNorm statistics and gradients
# over the plane's group) and stage 1 (TRAIN_VQ_SIZE^3, remat full) at
# MESH_VQ_BATCH, then on the line stage 1 at SPATIAL_VQ_BATCH with remat
# full and off (slabs of 32 rows at 128^3, two of them with a neighbour on
# each side; the remat-off peak per process against one process's,
# SPATIAL_MEMORY_RATIO); after the steps one --train_vq epoch from the
# command line with the preset's mesh set to the plane, on
# MESH_CLI_VOLUMES volumes at global batch MESH_VQ_BATCH, its checkpoint
# restored in one process. Launch B, eight processes, the data 2 x space
# 2 x model 2 cube: the latent step at DDP_BATCH, its parameter + Adam
# bytes and peak per process against one process's. Every gated step
# runs under the float64 gate (F64_FACTOR; SPATIAL_S2_GRAD_RTOL,
# SPATIAL_S1_GRAD_RTOL), its one-process twin and float64 step on process
# 0 after the sharded trainer is freed on every process (the gate
# compares gradients kept on the host). --mesh-gate-faults plants
# MESH_GATE_FAULTS one at a time (each launch A with that step alone):
# each must fail its gate by S1_FAULT_MARGIN or more.
MESH_PLANE, MESH_LINE, MESH_CUBE = (2, 2, 1), (1, 4, 1), (2, 2, 2)
MESH_VQ_BATCH, MESH_CLI_VOLUMES = 4, 12
MESH_TIMEOUT = 600                # seconds for one launch's workers
MESH_GATE_FAULTS = [("plane_stage2", "grads_over_data_line"),
                    ("plane_stage2", "bn_over_space_line"),
                    ("line_stage1", "interior_right_halo_zero")]


_T0 = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One JSON line; "t" is the script's wall time so far, in s."""
    print(json.dumps({"phase": phase, "t": time.perf_counter() - _T0,
                      **kv}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Eager time per call: `iters` calls back to back between two CUDA
    events, so the host's per-call work (Python, checks, allocation, the
    launch) counts wherever it is longer than the kernel."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_capture_stream = None


def graph_ms(fn, iters: int, warmup: int = 5, replays: int = 3) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph,
    replayed between two CUDA events, which leaves the host's per-call
    work out. Warm-up and capture share one stream for the whole run: each
    new stream that runs a matmul gets a cuBLAS workspace that is never
    freed, which would inflate the served phase's peak memory."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    side = _capture_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    graph.reset()
    torch.cuda.empty_cache()
    return ms


def _bound(t_bytes: float, ops: float, dtype) -> dict:
    """The least time for `ops` operations moving `t_bytes` seconds of
    HBM traffic: at the type's tensor-core peak (bound_ms, bound_by), and
    at the float32 FMA peak (fma_bound_ms)."""
    t_ops = ops / PEAK_FLOPS[dtype]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                fma_bound_ms=1e3 * max(t_bytes, ops / FMA_FLOPS))


def attention_bound(b, nq, nkv, c, dtype) -> dict:
    """Each input read once and the output written once over HBM, and
    4 * b * nq * nkv * c operations."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (2 * b * nq * c + 2 * b * nkv * c) * item / HBM_BYTES_PER_S
    return _bound(t_bytes, 4 * b * nq * nkv * c, dtype)


class _NoTF32:
    """float32 without TF32 for convolutions and matmuls inside the block;
    PyTorch's defaults (TF32 convolutions, full-f32 matmuls) after it."""

    def __enter__(self):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False


def codebook_bound(n, k, d, dtype) -> dict:
    """x and the codebook read once, ||c||^2 read and the indices written
    once over HBM, and 2 * n * d * k operations."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = ((n + k) * d * item + 4 * k + 4 * n) / HBM_BYTES_PER_S
    return _bound(t_bytes, 2 * n * d * k, dtype)


def attention_calls_per_step(unet: UNet3D) -> int:
    """Two calls per cross-attention block (self, then cross), one per
    self-attention block: 12 for the flagship."""
    return sum(2 if isinstance(m, CrossAttentionBlock) else 1
               for m in unet.modules()
               if isinstance(m, (CrossAttentionBlock, AttentionBlock)))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    print(card, flush=True)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    for built in _build.load_all([attn.KERNEL, cbq.KERNEL]):
        usage = [ln.split(":", 1)[-1].strip()
                 for ln in built.ptxas.splitlines()
                 if "registers" in ln or "spill" in ln]
        say("build", kernel=built.name, nvcc_s=round(built.seconds, 3),
            ptxas=sorted(set(usage)))
    say("build", total_s=round(time.perf_counter() - t0, 3))


def phase_kernel(card: str) -> Dict[str, dict]:
    """Kernel against `_attention_reference` at the paths' shapes; returns
    the numbers of each case."""
    cases = [  # name, B, nq, nkv, C, dtype
        ("self_f32", 16, 64, 64, 512, torch.float32),     # served path
        ("guided_f32", 32, 64, 64, 512, torch.float32),   # guided, num 16
        ("train_f32", 8, 64, 64, 512, torch.float32),     # train path
        # the ddp path: 4 rows per process (stage-2 step, CLI at --lbs 4)
        ("ddp_f32", 4, 64, 64, 512, torch.float32),
        # the spatial path: a 2-row slab's 32 queries of the 4^3 level
        # against its 64 keys (stage-2 step at batch 8)
        ("spatial_f32", 8, 32, 64, 512, torch.float32),
        # the tp path: every row on each process (stage-2 step at batch
        # 8, the CLI at --lbs 4 x 2 processes)
        ("tp_f32", 8, 64, 64, 512, torch.float32),
        *BF16_ATTN_SHAPES,
        ("cross_ragged_f32", 16, 64, 37, 512, torch.float32),
        ("cross_ragged_bf16", 16, 64, 37, 512, torch.bfloat16),
        ("long_c64_f32", 2, 4096, 4096, 64, torch.float32),
        ("long_c64_bf16", 2, 4096, 4096, 64, torch.bfloat16),
        ("smoke_c16_f32", 16, 64, 64, 16, torch.float32),  # smoke presets
        ("odd_c100_f32", 4, 300, 257, 100, torch.float32),
        ("wide_c1024_bf16", 2, 64, 64, 1024, torch.bfloat16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return {case[0]: _attention_case(gen, card, *case) for case in cases}


def _attention_case(gen, card: str, name: str, b: int, nq: int, nkv: int,
                    c: int, dt) -> dict:
    """One case of the attention kernel against its plain version on seeded
    inputs: its error, device and eager ms, the plain version's, SDPA's,
    and the bound."""
    q = torch.randn(b, nq, c, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, nkv, c, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, nkv, c, generator=gen, device="cuda").to(dt)
    scale = c ** -0.5
    out = attn.voxel_attention_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    ref = attn._attention_reference(q, k, v, scale)
    err = (out.float() - ref.float()).abs().max().item()
    ok = err <= ATTN_TOL[dt] and bool(torch.isfinite(out).all())
    kernel = partial(attn.voxel_attention_cuda, q, k, v, scale)
    plain = partial(attn._attention_reference, q, k, v, scale)
    library = partial(torch.nn.functional.scaled_dot_product_attention,
                      q, k, v, scale=scale)
    ms, plain_ms, lib_ms = (graph_ms(kernel, 200), graph_ms(plain, 50),
                            graph_ms(library, 200))
    eager = dict(ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 50),
                 library_ms=cuda_ms(library, 200))
    bound = attention_bound(b, nq, nkv, c, dt)
    say("kernel", case=name, shape=[b, nq, nkv, c], dtype=str(dt),
        max_abs_err=err, tol=ATTN_TOL[dt], ok=ok, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, eager=eager, **bound, card=card)
    if not ok:
        raise RuntimeError(f"voxel_attention {name}: max_abs_err {err} "
                           f"> {ATTN_TOL[dt]}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, eager_ms=eager["ms"], **bound,
                shape=[b, nq, nkv, c], dtype=str(dt))


def _codebook_case(gen, n, k, d, dtype, dup: bool):
    x = torch.randn(n, d, generator=gen, device="cuda")
    cb = torch.randn(k, d, generator=gen, device="cuda")
    if dup:   # codes 1, k/2 and k-1 equal; 64 rows sit exactly on them
        cb[k // 2] = cb[1]
        cb[k - 1] = cb[1]
        x[:64] = cb[1]
    return x.to(dtype), cb


def phase_codebook(card: str) -> Dict[str, dict]:
    """Codebook kernel against `_nearest_indices_reference` at the train
    shape [4096, 256] x [1024, 256], in f32 and bf16, with a ragged N and
    with duplicated codes (which must give the first index exactly), at
    the nsvqvae, rnsvqvae and vqgan_attn stage-1 shapes and at the ddp,
    spatial and tp paths' per-process shapes."""
    cases = [  # name, N, K, D, dtype, duplicated codes
        ("train_f32", 4096, 1024, 256, torch.float32, False),  # train path
        ("train_bf16", 4096, 1024, 256, torch.bfloat16, False),
        ("ragged_f32", 4095, 1024, 256, torch.float32, False),
        ("duplicates_f32", 4096, 1024, 256, torch.float32, True),
        ("d20_f32", 4096, 1024, 20, torch.float32, False),
        # stage-1 training at batch 8 and 128^3: rnsvqvae's 16^3 x 128
        # latents, one call per residual stage; nsvqvae's 8^3 x 256
        ("rnsvq_f32", 32768, 256, 128, torch.float32, False),
        ("nsvq_f32", 4096, 512, 256, torch.float32, False),
        # the VQ-GAN: vqgan_attn's 32^3 x 256 latents at batch 2, 128^3
        ("vqgan_attn_f32", 65536, 512, 256, torch.float32, False),
        # the ddp path, per process: the stage-1 step (2 volumes of 8^3
        # latents) and the CLI's encode at --lbs 4
        ("ddp_stage1_f32", 1024, 1024, 256, torch.float32, False),
        ("ddp_cli_f32", 2048, 1024, 256, torch.float32, False),
        # the spatial path, per process: 2 volumes' 8 x 8 x 4 latent slabs
        # (the stage-1 step, the CLI's steps, eval and montage)
        ("spatial_f32", 512, 1024, 256, torch.float32, False),
        # the tp path, per process: every row (the stage-1 step's 2
        # volumes, the CLI's encode of 8)
        ("tp_stage1_f32", 1024, 1024, 256, torch.float32, False),
        ("tp_cli_f32", 4096, 1024, 256, torch.float32, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return {case[0]: _codebook_timing(gen, card, *case) for case in cases}


def _codebook_timing(gen, card: str, name: str, n: int, k: int, d: int,
                     dt, dup: bool) -> dict:
    """One case of the codebook kernel against its plain version on seeded
    inputs: its distance gap, device and eager ms, the plain version's,
    addmm + argmin's, and the bound."""
    x, cb = _codebook_case(gen, n, k, d, dt, dup)
    idx = cbq.nearest_codebook_indices_cuda(x, cb)
    torch.cuda.synchronize()
    ref = cbq._nearest_indices_reference(x, cb)
    # float64 distances of the values multiplied
    dist = (cb.double() ** 2).sum(-1)[None, :] \
        - 2.0 * x.double() @ cb.to(dt).double().T
    rows = torch.arange(n, device="cuda")
    gap = (dist[rows, idx.long()] - dist[rows, ref.long()]).abs()
    err = float(gap.max())
    differ = int((idx != ref).sum())
    ok = err <= CB_DIST_TOL and idx.dtype == torch.int32 \
        and idx.shape == (n,)
    if dup:
        ok = ok and bool((idx[:64] == 1).all())
    c_sq = cb.float().square().sum(-1)
    cb_t = cb.to(dt).T.contiguous()
    kernel = partial(cbq.nearest_codebook_indices_cuda, x, cb)
    plain = partial(cbq._nearest_indices_reference, x, cb)

    def library():   # addmm + argmin on the precomputed ||c||^2
        return torch.argmin(torch.addmm(c_sq.to(dt), x, cb_t, alpha=-2),
                            dim=1)
    ms, plain_ms, lib_ms = (graph_ms(kernel, 200), graph_ms(plain, 50),
                            graph_ms(library, 200))
    eager = dict(ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 50),
                 library_ms=cuda_ms(library, 200))
    bound = codebook_bound(n, k, d, dt)
    say("kernel", kernel=cbq.KERNEL, case=name, shape=[n, k, d],
        dtype=str(dt), indices_differ=differ, max_abs_err=err,
        tol=CB_DIST_TOL, first_index_on_ties=dup or None, ok=ok, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, eager=eager, **bound,
        card=card)
    if not ok:
        raise RuntimeError(f"codebook_nearest {name}: distance gap "
                           f"{err} > {CB_DIST_TOL} or ties broken "
                           "wrongly")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, eager_ms=eager["ms"], **bound,
                shape=[n, k, d], dtype=str(dt))


# Odd shapes, untimed: each takes a path of the kernels' staging that the
# timed cases do not.
ATTN_SHAPES = [  # B, nq, nkv, C, dtype
    (3, 1, 1, 1, torch.float32),          # one query and key, C = 1
    (1, 65, 1000, 10, torch.float32),     # 4-byte copies, resident Q tile
    (2, 70, 130, 33, torch.bfloat16),     # odd bf16 rows: 2-byte copies
    (2, 130, 200, 100, torch.bfloat16),   # 4-byte copies, resident Q tile
    (1, 17, 33, 600, torch.float32),      # a ragged last column slice
    (2, 200, 300, 256, torch.float32),    # Q streamed over 5 key tiles
    (64, 64, 64, 512, torch.float32),     # guided at num 32 (2 x 32)
    (4, 64, 64, 512, torch.float32),      # cli --test_dm at batch 4
    (2, 32, 64, 512, torch.float32),      # spatial generate, 2 samples
]
CB_SHAPES = [  # N, K, D, dtype
    (37, 16, 8, torch.float32),           # the tiny slice
    (100, 300, 7, torch.bfloat16),        # odd bf16 rows: 2-byte copies
    (1000, 513, 3, torch.float32),        # 4-byte copies, ragged code tile
    (257, 1000, 130, torch.bfloat16),     # 4-byte copies
    (64, 2048, 520, torch.float32),       # 16 code tiles, 17 depth slices
    (524288, 128, 64, torch.float32),     # vqgan_attn_sym, 64^3 x 64
]


def phase_kernel_shapes() -> None:
    """Both kernels at ATTN_SHAPES and CB_SHAPES against the plain
    versions, with the tolerances of the timed cases."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for b, nq, nkv, c, dt in ATTN_SHAPES:
        q, k, v = (torch.randn(b, n, c, generator=gen, device="cuda").to(dt)
                   for n in (nq, nkv, nkv))
        out = attn.voxel_attention_cuda(q, k, v, c ** -0.5)
        torch.cuda.synchronize()
        ref = attn._attention_reference(q, k, v, c ** -0.5)
        err = (out.float() - ref.float()).abs().max().item()
        ok = err <= ATTN_TOL[dt] and bool(torch.isfinite(out).all())
        say("kernel_shapes", kernel=attn.KERNEL, shape=[b, nq, nkv, c],
            dtype=str(dt), max_abs_err=err, tol=ATTN_TOL[dt], ok=ok)
        if not ok:
            raise RuntimeError(f"voxel_attention {[b, nq, nkv, c]} {dt}: "
                               f"max_abs_err {err}")
    for n, k, d, dt in CB_SHAPES:
        x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        cb = torch.randn(k, d, generator=gen, device="cuda")
        idx = cbq.nearest_codebook_indices_cuda(x, cb)
        torch.cuda.synchronize()
        ref = cbq._nearest_indices_reference(x, cb)
        dist = (cb.double() ** 2).sum(-1)[None, :] \
            - 2.0 * x.double() @ cb.to(dt).double().T
        rows = torch.arange(n, device="cuda")
        gap = float((dist[rows, idx.long()] - dist[rows, ref.long()])
                    .abs().max())
        ok = gap <= CB_DIST_TOL and idx.dtype == torch.int32
        say("kernel_shapes", kernel=cbq.KERNEL, shape=[n, k, d],
            dtype=str(dt), indices_differ=int((idx != ref).sum()),
            max_abs_err=gap, tol=CB_DIST_TOL, ok=ok)
        if not ok:
            raise RuntimeError(f"codebook_nearest {[n, k, d]} {dt}: "
                               f"distance gap {gap}")


def phase_attention_grad() -> None:
    """Gradients of q, k, v through the kernel's autograd Function against
    plain autograd at the train shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v = (torch.randn(8, 64, 512, generator=gen, device="cuda")
               .requires_grad_(True) for _ in range(3))
    g = torch.randn(8, 64, 512, generator=gen, device="cuda")
    before = attn.launches
    out = attn.voxel_attention(q, k, v)
    launched = attn.launches - before
    grads = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(attn._attention_reference(q, k, v,
                                                        512 ** -0.5),
                              (q, k, v), g)
    errs = [(a - b).abs().max().item() for a, b in zip(grads, ref)]
    ok = out.requires_grad and launched == 1 and max(errs) <= ATTN_GRAD_TOL
    say("attention_grad", shape=[8, 64, 512], requires_grad=out.requires_grad,
        launches=launched, max_abs_err_qkv=errs, tol=ATTN_GRAD_TOL, ok=ok)
    if not ok:
        raise RuntimeError(f"attention_grad: {errs}, launches {launched}")


def phase_unet_step(trainer: DiffusionTrainer) -> None:
    cfg = trainer.cfg
    unet = trainer.model.unet
    cpu_unet = UNet3D(cfg.unet, cfg.latent_channels, cfg.latent_channels,
                      cfg.latent_size).eval()
    cpu_unet.load_state_dict({k: t.cpu() for k, t in
                              unet.state_dict().items()})
    rng = np.random.default_rng(SEED)
    s = cfg.latent_size
    x = torch.from_numpy(rng.standard_normal(
        (2, s, s, s, cfg.latent_channels)).astype(np.float32))
    t = torch.tensor([cfg.timesteps - 1, 17])
    null = cfg.unet.context_dim + 1 if cfg.unet.cfg_dropout > 0 else 0
    c = torch.tensor([1, null])   # a class, and the null row if there is one
    with torch.no_grad(), _NoTF32():
        before = attn.launches
        out = unet(x.cuda(), t.cuda(), c.cuda()).cpu()
        step_launches = attn.launches - before
        ref = cpu_unet(x, t, c)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    ok = rel <= UNET_REL_TOL and bool(torch.isfinite(out).all())
    say("unet_step", batch=2, attention_launches=step_launches,
        max_abs_err=(out - ref).abs().max().item(),
        max_abs_ref=ref.abs().max().item(), rel_err=rel, tol=UNET_REL_TOL,
        ok=ok)
    if not ok or step_launches != attention_calls_per_step(unet):
        raise RuntimeError(f"unet_step: rel_err {rel}, attention launches "
                           f"{step_launches}")


def _init_report(module: torch.nn.Module) -> dict:
    """Per kernel init kind of `module` (`init_jax_`): the tensors, the
    zero-initialised ones that are not exactly zero, and the worst ratio
    of measured to expected standard deviation over the tensors of at
    least INIT_MIN_N elements (glorot-uniform limit / sqrt 3, lecun-normal
    1 / sqrt(fan_in), embeddings 1 / sqrt(features))."""
    out: Dict[str, dict] = {}
    for name, m in module.named_modules():
        if isinstance(m, torch.nn.Embedding):
            kind, expect = "embed", m.embedding_dim ** -0.5
        else:
            kind = getattr(m, "kernel_init", None)
            if kind is None and isinstance(m, torch.nn.Linear):
                kind = "glorot_uniform"
            if kind is None:
                continue
            fan_in, fan_out = _fans(m.weight)
            expect = {"glorot_uniform": (2.0 / (fan_in + fan_out)) ** 0.5,
                      "lecun_normal": fan_in ** -0.5}.get(kind)
        w = m.weight.detach()
        e = out.setdefault(kind, dict(tensors=0, nonzero=[],
                                      worst_std_ratio=1.0, checked=0))
        e["tensors"] += 1
        if kind == "zeros":
            if w.any():
                e["nonzero"].append(name)
            continue
        if expect is None or w.numel() < INIT_MIN_N:
            continue
        ratio = float(w.float().std()) / expect
        e["checked"] += 1
        if abs(ratio - 1.0) > abs(e["worst_std_ratio"] - 1.0):
            e["worst_std_ratio"] = ratio
    return out


def phase_init(card: str) -> None:
    """The trainers' JAX init (`init_random`, scheme "jax") at full width
    on the card: the flagship stage 2, the flagship stage 1 and vqgan_attn
    with its critics and LPIPS (calibrated after init). Every
    zero-initialised tensor must be exactly zero and every checked
    standard deviation within INIT_STD_RTOL of its kind's."""
    cfg = flagship_cfg()
    s1 = get_preset("vqvae_dm_stage1")
    gan = get_preset("vqgan_attn")
    builds = (
        ("stage2", lambda: DiffusionTrainer(cfg, device="cuda",
                                            train_cfg=TrainConfig(dtype=F32))
         .init_random(SEED), lambda tr: tr.model),
        ("stage1", lambda: VQTrainer(replace(cfg.vqvae, remat=True),
                                     _f32(s1.train), device="cuda")
         .init_random(SEED), lambda tr: tr.model),
        ("vqgan_attn", lambda: GANTrainer(gan.vqgan, _f32(gan.train),
                                          device="cuda",
                                          volume_size=gan.data.volume_size)
         .init_random(SEED), lambda tr: tr.model))
    bad = []
    for name, build, model in builds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # the LPIPS surrogate
            tr = build()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        report = _init_report(model(tr))
        params = sum(p.numel() for p in model(tr).parameters())
        say("init", trainer=name, scheme="jax", init_s=init_s,
            parameters=params, kinds=report, tol=INIT_STD_RTOL, card=card)
        for kind, e in report.items():
            if e["nonzero"] or abs(e["worst_std_ratio"] - 1) > INIT_STD_RTOL:
                bad.append((name, kind, e["nonzero"][:3],
                            e["worst_std_ratio"]))
        if "zeros" not in report and name == "stage2":
            bad.append((name, "no zero-initialised layer"))
        del tr
        torch.cuda.empty_cache()
    if bad:
        raise RuntimeError(f"init: {bad}")


def phase_serve_profile(trainer: DiffusionTrainer, card: str,
                        phase: str = "serve_profile") -> dict:
    """Where the served step's time goes, after the counted path: one
    unguided DDPM step of the U-Net and the sampler at the served batch
    (`generate` down to T - 1, no decode), timed with `StepTimer` and
    profiled over PROFILE_STEPS steps (kernels by kind, the device's busy
    share). Launches here are not counted."""
    cfg = trainer.cfg
    num = REQUESTS[0]["num"]
    shape = _latent_shape(cfg, num)
    ctx = torch.full((num,), REQUESTS[0]["context"], dtype=torch.long,
                     device=trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 50)

    def step():
        return trainer.generate(shape, ctx, generator=gen, sampler="ddpm",
                                last_step=cfg.timesteps - 1, decode=False)
    timer = profiling.StepTimer(warmup=2)
    for _ in range(PROFILE_TIMED + 2):
        timer.time_step(step)
    timed = timer.summary()
    prof = profiling.profile_steps(step, PROFILE_STEPS,
                                   1e3 * timed["p50_s"])
    say(phase, batch=num, sampler="ddpm", guided=False,
        dtype=trainer.train_cfg.dtype, step_timer=timed, **prof, card=card)
    return dict(step_timer=timed, **prof)


def phase_serve(svc: GenerationService, card: str) -> tuple:
    cfg = svc.cfg
    calls_per_request = attention_calls_per_step(svc.trainer.model.unet) \
        * cfg.timesteps
    size = cfg.volume_size
    say("serve", trained_weights=False, init=f"seeded random, seed {SEED}",
        config="flagship", dtype="float32",
        tf32_conv=torch.backends.cudnn.allow_tf32,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    say("serve", resident_bytes=torch.cuda.memory_allocated())
    outs, walls = [], []
    attn.reset_launches()   # the main path starts here
    cbq.reset_launches()
    for req in REQUESTS:
        before = attn.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vols = svc.generate(**req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = attn.launches - before
        finite = bool(np.isfinite(vols).all())
        shape_ok = vols.shape == (req["num"], size, size, size, 1)
        say("serve", request=req, wall_s=wall,
            vol_per_min=60.0 * req["num"] / wall, attention_launches=n,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            shape=list(vols.shape), finite=finite,
            std=float(vols.std()), card=card)
        if not (finite and shape_ok and n == calls_per_request):
            raise RuntimeError(f"serve {req}: finite {finite}, shape "
                               f"{vols.shape}, launches {n}")
        outs.append(vols)
        walls.append(wall)
    total = attn.launches   # read right after the main path
    codebook = cbq.launches
    rel = float(np.abs(outs[-1] - outs[0]).max() / np.abs(outs[0]).max())
    say("serve", repeat_rel_err=rel, tol=REPEAT_REL_TOL,
        attention_launches=total,
        expected=calls_per_request * len(REQUESTS))
    if rel > REPEAT_REL_TOL or total != calls_per_request * len(REQUESTS) \
            or codebook != 0:
        raise RuntimeError(f"serve: repeat rel_err {rel}, launches {total}, "
                           f"codebook launches {codebook}")
    return {attn.KERNEL: total, cbq.KERNEL: codebook}, walls[0]


def phase_breakdown(trainer: DiffusionTrainer, main: dict) -> None:
    """Where a request's time goes: one U-Net step and one decode at the
    served batch, CUDA-event timed (launches here are not counted)."""
    cfg = trainer.cfg
    s, b = cfg.latent_size, REQUESTS[0]["num"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(b, s, s, s, cfg.latent_channels, generator=gen,
                    device="cuda")
    t = torch.full((b,), 250, device="cuda")
    c = torch.ones(b, dtype=torch.long, device="cuda")
    with torch.no_grad():
        step_ms = cuda_ms(lambda: trainer.model.unet(x, t, c), 10, warmup=2)
        decode_ms = cuda_ms(lambda: trainer.model.decode(x), 2, warmup=1)
    calls = attention_calls_per_step(trainer.model.unet)
    say("breakdown", unet_step_ms=step_ms, steps=cfg.timesteps,
        sampling_ms=step_ms * cfg.timesteps, decode_ms=decode_ms,
        attention_ms_per_step=calls * main["ms"],
        attention_share=calls * main["ms"] / step_ms,
        attention_eager_ms_per_step=calls * main["eager_ms"],
        attention_eager_share=calls * main["eager_ms"] / step_ms)


def _latent_shape(cfg, num: int) -> tuple:
    s = cfg.latent_size
    return (num, s, s, s, cfg.latent_channels)


def _v_twin(trainer: DiffusionTrainer) -> DiffusionTrainer:
    """The same weights read as a v-prediction model."""
    twin = DiffusionTrainer(dataclasses.replace(trainer.cfg,
                                                prediction_type="v"),
                            device=trainer.device,
                            train_cfg=trainer.train_cfg)
    twin.model.load_state_dict(trainer.model.state_dict())
    return twin


def phase_serve_samplers(svc: GenerationService, card: str) -> dict:
    """Main path 3: SAMPLER_REQUESTS through the service, V_REQUEST through
    a v-prediction twin, and one decode=False call; each runs the U-Net
    once per step, guided or not, so attention launches 12 x steps."""
    trainer, cfg = svc.trainer, svc.cfg
    calls = attention_calls_per_step(trainer.model.unet)
    size = cfg.volume_size
    v_svc = GenerationService(dataclasses.replace(cfg, prediction_type="v"),
                              _v_twin(trainer), name="flagship-v")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    ctx = torch.ones(16, dtype=torch.long, device="cuda")
    latents_only = dict(num=16, context=1, sampler="ddim",
                        sample_steps=LATENT_STEPS, decode=False)
    runs = [(req, partial(svc.generate, **req),
             (req["num"], size, size, size, 1)) for req in SAMPLER_REQUESTS]
    runs.append((dict(V_REQUEST, prediction_type="v"),
                 partial(v_svc.generate, **V_REQUEST),
                 (V_REQUEST["num"], size, size, size, 1)))
    runs.append((latents_only, lambda: trainer.generate(
        _latent_shape(cfg, 16), ctx, generator=gen, sampler="ddim",
        sample_steps=LATENT_STEPS, decode=False).cpu().numpy(),
        _latent_shape(cfg, 16)))
    outs = []
    attn.reset_launches()   # the main path starts here
    cbq.reset_launches()
    for req, run, want in runs:
        before = attn.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = attn.launches - before
        finite = bool(np.isfinite(out).all())
        guided = req.get("guidance_scale") is not None
        say("serve_samplers", request=req,
            unet_batch=req["num"] * (2 if guided else 1), wall_s=wall,
            vol_per_min=60.0 * req["num"] / wall, attention_launches=n,
            expected=calls * req["sample_steps"],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            shape=list(out.shape), finite=finite, std=float(out.std()),
            card=card)
        if not (finite and out.shape == want
                and n == calls * req["sample_steps"]):
            raise RuntimeError(f"serve_samplers {req}: finite {finite}, "
                               f"shape {out.shape}, launches {n}")
        outs.append(out)
    total = attn.launches   # read right after the main path
    codebook = cbq.launches
    expected = calls * sum(req["sample_steps"] for req, _, _ in runs)
    rel = float(np.abs(outs[1] - outs[0]).max() / np.abs(outs[0]).max())
    say("serve_samplers", repeat_rel_err=rel, tol=REPEAT_REL_TOL,
        attention_launches=total, expected=expected,
        codebook_launches=codebook)
    if rel > REPEAT_REL_TOL or total != expected or codebook != 0:
        raise RuntimeError(f"serve_samplers: repeat rel_err {rel}, launches "
                           f"{total} (expected {expected}), codebook "
                           f"launches {codebook}")
    del v_svc, runs
    torch.cuda.empty_cache()
    step_ms = {}
    with torch.no_grad():
        for b in (16, 32):
            x = torch.randn(_latent_shape(cfg, b), generator=gen,
                            device="cuda")
            t = torch.full((b,), 250, device="cuda")
            c = torch.ones(b, dtype=torch.long, device="cuda")
            step_ms[b] = cuda_ms(lambda: trainer.model.unet(x, t, c), 10,
                                 warmup=2)
    say("serve_samplers", unet_step_ms_by_batch=step_ms, card=card)
    return {attn.KERNEL: total, cbq.KERNEL: codebook}


def phase_sampler_compare(trainer: DiffusionTrainer) -> None:
    """Guided DDIM (scale 3, eta 0.5) and DPM++ SDE, SAMPLER_COMPARE_STEPS
    steps at num 2 with injected noise, latents only: the card (kernel, f32
    without TF32) against a CPU twin (plain version)."""
    cfg = trainer.cfg
    cpu = DiffusionTrainer(cfg, device="cpu", train_cfg=trainer.train_cfg)
    cpu.model.load_state_dict({k: t.cpu() for k, t in
                               trainer.model.state_dict().items()})
    rng = np.random.default_rng(SEED + 9)
    shape = _latent_shape(cfg, 2)
    x_t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    noise = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for _ in range(SAMPLER_COMPARE_STEPS)]
    ctx = torch.tensor([1, 2])
    for case in (dict(sampler="ddim", eta=0.5, guidance_scale=3.0),
                 dict(sampler="dpmpp_sde")):
        kw = dict(sample_steps=SAMPLER_COMPARE_STEPS, decode=False, **case)
        with torch.no_grad(), _NoTF32():
            out = trainer.generate(
                shape, ctx.cuda(), init_noise=x_t.cuda(),
                step_noise=lambda i: noise[i].cuda(), **kw).cpu()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = cpu.generate(shape, ctx, init_noise=x_t,
                               step_noise=noise.__getitem__, **kw)
            cpu_s = time.perf_counter() - t0
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        ok = rel <= SAMPLER_REL_TOL and bool(torch.isfinite(out).all())
        say("sampler_compare", **case, steps=SAMPLER_COMPARE_STEPS, num=2,
            max_abs_err=err, max_abs_ref=float(ref.abs().max()),
            rel_err=rel, tol=SAMPLER_REL_TOL, cpu_s=cpu_s, ok=ok)
        if not ok:
            raise RuntimeError(f"sampler_compare {case}: rel_err {rel}")


def phase_fidelity(trainer: DiffusionTrainer, card: str) -> dict:
    """Main path 4: latent features of two batches of seeded volumes (one
    codebook launch each), then `fidelity_eval` at its defaults with the
    real rows labelled 0..context_dim in turn."""
    cfg = trainer.cfg
    rng = np.random.default_rng(SEED + 8)
    vols = [_seeded_volumes(rng, FIDELITY_VOLUMES, cfg.volume_size).cuda()
            for _ in range(2)]
    n_ctx = cfg.unet.context_dim + 1
    labels = np.arange(2 * FIDELITY_VOLUMES) % n_ctx
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    torch.cuda.synchronize()
    attn.reset_launches()   # the main path starts here
    cbq.reset_launches()
    t0 = time.perf_counter()
    real = np.concatenate([trainer.latent_features(v) for v in vols])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scores = trainer.fidelity_eval(real, gen, num_samples=FIDELITY_SAMPLES,
                                   batch=FIDELITY_BATCH, real_ctx=labels)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {attn.KERNEL: attn.launches, cbq.KERNEL: cbq.launches}
    steps = max(cfg.timesteps // 20, 1)   # fidelity_eval's DDIM default
    per_ctx = max(FIDELITY_SAMPLES // n_ctx, 1)
    batches = n_ctx * -(-per_ctx // FIDELITY_BATCH)
    expected = {attn.KERNEL: batches * steps
                * attention_calls_per_step(trainer.model.unet),
                cbq.KERNEL: len(vols)}
    finite = all(np.isfinite(v) for v in scores.values())
    splits = all(f"fid_same_c{c}" in scores for c in range(n_ctx))
    say("fidelity", real=list(real.shape), features_s=t1 - t0,
        fidelity_eval_s=t2 - t1, ddim_steps=steps, sample_batches=batches,
        scores=scores, launches=counts, expected=expected, finite=finite,
        card=card)
    if not (finite and splits and counts == expected):
        raise RuntimeError(f"fidelity: finite {finite}, splits {splits}, "
                           f"launches {counts}")
    return counts


def _seeded_volumes(rng, b: int, size: int) -> torch.Tensor:
    """Seeded volumes in [0, 1], NDHWC float32 [b, size^3, 1]."""
    return torch.from_numpy(rng.random((b, size, size, size, 1),
                                       dtype=np.float32))


def phase_encode() -> None:
    """The full-width encoder + STE quantizer on the card against the CPU
    at batch 1, f32 with TF32 off."""
    cfg = flagship_cfg()
    gen = torch.Generator().manual_seed(SEED)
    cpu_vq = init_params_(VQVAE(cfg.vqvae), gen).eval()
    card_vq = VQVAE(cfg.vqvae).cuda().eval()
    card_vq.load_state_dict(cpu_vq.state_dict())
    vol = _seeded_volumes(np.random.default_rng(SEED), 1, ENCODE_SIZE)
    with torch.no_grad(), _NoTF32():
        z = card_vq.encode(vol.cuda())
        q, aux = card_vq.quantizer(z)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z_ref = cpu_vq.encode(vol)
        q_ref, aux_ref = cpu_vq.quantizer(z_ref)
        cpu_s = time.perf_counter() - t0
    z, q, idx = z.cpu(), q.cpu(), aux.indices.cpu().reshape(-1)
    idx_ref = aux_ref.indices.reshape(-1)
    rel = float((z - z_ref).abs().max() / z_ref.abs().max())
    # a pick may differ only at a near-tie of the distances
    cb = cpu_vq.quantizer.codebook.detach().double()
    flat = z_ref.reshape(-1, cb.shape[1]).double()
    dist = (cb ** 2).sum(-1)[None] - 2.0 * flat @ cb.T
    rows = torch.arange(flat.shape[0])
    gap = float((dist[rows, idx.long()] - dist[rows, idx_ref.long()])
                .abs().max())
    same = idx == idx_ref
    q_err = float((q.reshape(-1, cb.shape[1])[same]
                   - q_ref.reshape(-1, cb.shape[1])[same]).abs().max())
    s = ENCODE_SIZE // cfg.vqvae.spatial_factor
    ok = (rel <= UNET_REL_TOL and gap <= CB_DIST_TOL and q_err <= 1e-4
          and bool(torch.isfinite(q).all())
          and q.shape == (1, s, s, s, cfg.vqvae.quantizer.embedding_dim))
    say("encode", volume=[1, ENCODE_SIZE, ENCODE_SIZE, ENCODE_SIZE, 1],
        latents=list(q.shape), cpu_s=cpu_s, rel_err_z=rel, tol=UNET_REL_TOL,
        indices_differ=int((~same).sum()), distance_gap=gap,
        gap_tol=CB_DIST_TOL, max_abs_err_quantized=q_err,
        perplexity=float(aux.perplexity), ok=ok)
    if not ok:
        raise RuntimeError(f"encode: rel_err {rel}, gap {gap}, q_err {q_err}")


def phase_train(card: str) -> dict:
    """Main path 2: a seeded full-width trainer encodes two batches of
    volumes (--cache_latents), derives the latent scale, and takes
    TRAIN_STEPS steps on volumes and as many on cached latents."""
    cfg = flagship_cfg()
    tc = TrainConfig(batch_size=TRAIN_BATCH, ema_decay=0.999, seed=SEED,
                     dtype=F32)
    trainer = DiffusionTrainer(cfg, device="cuda",
                               train_cfg=tc).init_random(SEED, "reach")
    rng = np.random.default_rng(SEED + 3)
    size = cfg.volume_size
    vols = [_seeded_volumes(rng, TRAIN_BATCH, size).cuda() for _ in range(2)]
    ctxs = [torch.from_numpy(rng.integers(0, cfg.unet.context_dim + 1,
                                          TRAIN_BATCH)).cuda()
            for _ in range(2)]
    say("train", trained_weights=False, init=f"seeded random, seed {SEED}",
        config="flagship", batch=TRAIN_BATCH, volume=size, dtype="float32",
        tf32_conv=torch.backends.cudnn.allow_tf32,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        ema_decay=tc.ema_decay, learning_rate=tc.learning_rate)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_launches()   # the main path starts here
    cbq.reset_launches()
    t0 = time.perf_counter()
    lat = torch.cat([trainer.encode_latents(v) for v in vols])
    torch.cuda.synchronize()
    encode_ms = 1e3 * (time.perf_counter() - t0) / len(vols)
    lat_std = float(lat.std())
    new_cfg = auto_latent_scale(lat_std, trainer.cfg)
    rescaled = new_cfg is not trainer.cfg
    if rescaled:
        lat = lat * (new_cfg.latent_scale / trainer.cfg.latent_scale)
        trainer.set_latent_scale(new_cfg.latent_scale,
                                 new_cfg.clip_sample_range)
    say("train", encoded=list(lat.shape), encode_ms_per_batch=encode_ms,
        latent_std=lat_std, auto_latent_scale_rescaled=rescaled,
        latent_scale=trainer.cfg.latent_scale,
        clip_sample_range=trainer.cfg.clip_sample_range)
    step_ms: Dict[str, list] = {"volume": [], "latents": []}
    losses: Dict[str, list] = {"volume": [], "latents": []}
    for kind in ("volume", "latents"):
        for i in range(TRAIN_STEPS):
            j = i % 2
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "volume":
                m = trainer.train_step(vols[j], ctxs[j])
            else:
                m = trainer.train_step_latents(
                    lat[j * TRAIN_BATCH:(j + 1) * TRAIN_BATCH], ctxs[j])
            torch.cuda.synchronize()
            step_ms[kind].append(1e3 * (time.perf_counter() - t0))
            losses[kind].append({k: float(v) for k, v in m.items()})
    counts = {attn.KERNEL: attn.launches, cbq.KERNEL: cbq.launches}
    peak = torch.cuda.max_memory_allocated()   # read right after the path
    calls = attention_calls_per_step(trainer.model.unet)
    expected = {attn.KERNEL: calls * 2 * TRAIN_STEPS,
                cbq.KERNEL: len(vols) + TRAIN_STEPS}
    finite = all(np.isfinite(v) for kind in losses for m in losses[kind]
                 for v in m.values())
    say("train", step_ms=step_ms, losses=losses, launches=counts,
        expected=expected, max_memory_allocated=peak, finite=finite,
        card=card)
    if not finite or counts != expected:
        raise RuntimeError(f"train: finite {finite}, launches {counts}")
    return dict(trainer=trainer, latents=lat, vols=vols, counts=counts,
                encode_ms=encode_ms, step_ms=step_ms, peak=peak)


def _twin(trainer: DiffusionTrainer, device: str,
          batch: int = 2) -> DiffusionTrainer:
    tc = TrainConfig(batch_size=batch,
                     ema_decay=trainer.train_cfg.ema_decay,
                     dtype=trainer.train_cfg.dtype)
    twin = DiffusionTrainer(trainer.cfg, device=device, train_cfg=tc)
    twin.model.load_state_dict(trainer.model.state_dict())
    return twin


def _compare_inputs(trainer: DiffusionTrainer, lat: torch.Tensor):
    """Batch-2 latents, context and injected draws of the compare step."""
    rng = np.random.default_rng(SEED + 4)
    x = lat[:2].cpu()
    draws = dict(t=torch.from_numpy(rng.integers(0, trainer.cfg.timesteps,
                                                 2)),
                 noise=torch.from_numpy(rng.standard_normal(
                     tuple(x.shape)).astype(np.float32)),
                 drop=torch.tensor([False, True]))
    return x, torch.tensor([1, 0]), draws


def _float64_twin(trainer: DiffusionTrainer, batch: int = 2,
                  device: str = "cpu") -> DiffusionTrainer:
    """A twin (on the CPU unless `device`) whose U-Net, Adam state and
    gradients are float64. The step's inputs stay as the float32 runs
    make them (the noised latents, the sinusoidal time embedding) and are
    widened where they enter; the loss is formed in float32
    (`pred.float()`), which rounds only the upstream gradient's first
    factor, to 1e-7. On the card its step runs inside
    `_float64_attention` (the kernel takes float32 and bfloat16)."""
    twin = _twin(trainer, device, batch)
    unet = twin.model.unet.double()
    unet.register_forward_pre_hook(
        lambda m, args: (args[0].double(),) + tuple(args[1:]))
    for m in unet.modules():
        if isinstance(m, TimeEmbedding):
            m.register_forward_hook(lambda m, i, out: out.double())
    return twin


def _step_errors(card: DiffusionTrainer, ref: DiffusionTrainer,
                 before: Dict[str, torch.Tensor]) -> dict:
    """Card step against a reference step from the same weights: Adam's
    first moment (0.1 x the gradient) relative to the reference's largest,
    and the parameter changes where the reference's |g| >= 1e-6."""
    pairs = [(n, p, q) for (n, p), q in zip(card.model.unet.named_parameters(),
                                            ref.model.unet.parameters())]
    mu = {n: (card.optimizer.state[p]["exp_avg"].cpu().double(),
              ref.optimizer.state[q]["exp_avg"].double())
          for n, p, q in pairs}
    scale = max(float(b.abs().max()) for _, b in mu.values())
    grad_errs = {n: float((a - b).abs().max()) / scale
                 for n, (a, b) in mu.items()}
    worst = max(grad_errs, key=grad_errs.get)
    delta_err, delta_worst, compared, total = 0.0, None, 0, 0
    for n, p, q in pairs:
        # |g| after one step: sqrt(v / (1 - b2))
        g = ref.optimizer.state[q]["exp_avg_sq"].sqrt() / (1 - 0.999) ** 0.5
        sure = g >= 1e-6
        d_card = p.detach().cpu().double() - before[n]
        d_ref = q.detach().double() - before[n]
        if sure.any():
            err = float((d_card - d_ref)[sure].abs().max())
            if err > delta_err:
                delta_err, delta_worst = err, n
        compared += int(sure.sum())
        total += sure.numel()
    return dict(grad_rel_err=grad_errs[worst], grad_worst=worst,
                grad_errs=grad_errs, max_delta_err=delta_err,
                delta_worst=delta_worst, deltas_compared=compared,
                weights=total)


def _card_step(card: DiffusionTrainer, x, ctx, draws) -> dict:
    with _NoTF32():
        m = card.train_step_latents(
            x.cuda(), ctx.cuda(), **{k: v.cuda() for k, v in draws.items()})
        torch.cuda.synchronize()
    return m


def phase_train_compare(trainer: DiffusionTrainer, lat: torch.Tensor
                        ) -> None:
    """One latent step at batch 2 on the card (f32, TF32 off) against the
    same step on the CPU in float64, from the train phase's weights with a
    fresh optimizer and injected draws: the loss, Adam's first moment
    (0.1 x the gradient) and every U-Net parameter's change. The reference
    is float64 because the CPU's own float32 step was shown to be the less
    accurate side (--train-compare-check)."""
    card, ref = _twin(trainer, "cuda"), _float64_twin(trainer)
    x, ctx, draws = _compare_inputs(trainer, lat)
    before = {n: p.detach().clone()
              for n, p in ref.model.unet.named_parameters()}
    m_card = _card_step(card, x, ctx, draws)
    m_ref = ref.train_step_latents(x, ctx, **draws)
    loss_rel = abs(float(m_card["loss"]) - float(m_ref["loss"])) \
        / abs(float(m_ref["loss"]))
    e = _step_errors(card, ref, before)
    ok = (loss_rel <= TRAIN_LOSS_RTOL and e["grad_rel_err"] <= TRAIN_GRAD_RTOL
          and e["max_delta_err"] <= TRAIN_DELTA_ATOL
          and e["deltas_compared"] > 0)
    e.pop("grad_errs")
    say("train_compare", batch=2, reference="float64 CPU step",
        loss_card=float(m_card["loss"]), loss_ref=float(m_ref["loss"]),
        loss_rel_err=loss_rel, loss_tol=TRAIN_LOSS_RTOL,
        grad_tol=TRAIN_GRAD_RTOL, delta_tol=TRAIN_DELTA_ATOL, **e, ok=ok)
    if not ok:
        raise RuntimeError(f"train_compare: loss {loss_rel}, {e}")


def _plain_forward_attention(q, k, v, scale=None):
    """voxel_attention with the plain version as the forward on the card
    (gradients as the kernel's Function gives them)."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    return attn.VoxelAttentionFn.apply(q, k, v, scale,
                                       attn._attention_reference)


def phase_train_compare_check(trainer: DiffusionTrainer, lat: torch.Tensor
                              ) -> None:
    """Where the card-vs-CPU gradient error comes from: the compare step
    with cuDNN deterministic and TF32 off on the card, against the CPU in
    float32 (with and without oneDNN) and in float64, each reference
    compared with the card as train_compare compares, and the float32
    references with the float64 one; and the card's step once more with
    the plain attention forward in place of the kernel's, against
    float64."""
    x, ctx, draws = _compare_inputs(trainer, lat)
    card, card_plain = _twin(trainer, "cuda"), _twin(trainer, "cuda")
    refs = {"cpu": _twin(trainer, "cpu"), "cpu_no_onednn": _twin(trainer,
                                                                  "cpu"),
            "cpu64": _float64_twin(trainer)}
    before = {n: p.detach().double().clone()
              for n, p in refs["cpu"].model.unet.named_parameters()}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        _card_step(card, x, ctx, draws)
        unet3d.voxel_attention = _plain_forward_attention
        _card_step(card_plain, x, ctx, draws)
    finally:
        unet3d.voxel_attention = attn.voxel_attention
        torch.backends.cudnn.deterministic = False
    for name, ref in refs.items():
        with torch.backends.mkldnn.flags(enabled=name != "cpu_no_onednn"):
            ref.train_step_latents(x, ctx, **draws)
    report = {}
    for name, ref in refs.items():
        e = _step_errors(card, ref, before)
        report[f"card_vs_{name}"] = e
    for name in ("cpu", "cpu_no_onednn"):
        report[f"{name}_vs_cpu64"] = _step_errors(refs[name], refs["cpu64"],
                                                  before)
    report["card_plain_attention_vs_cpu64"] = _step_errors(
        card_plain, refs["cpu64"], before)
    at = report["card_vs_cpu"]["grad_worst"]
    for e in report.values():
        e["at_card_vs_cpu_worst"] = e.pop("grad_errs")[at]
    say("train_compare_check", cudnn_deterministic=True, tf32=False,
        **report)
    t0 = time.perf_counter()
    bisect = _bisect_xattn(trainer, x, ctx, draws)
    say("train_compare_bisect", reference="float64 step on the card",
        cudnn_deterministic=torch.backends.cudnn.deterministic, tf32=False,
        wall_s=time.perf_counter() - t0, **bisect)
    t0 = time.perf_counter()
    own = _conv_own_errors(trainer, x, ctx, draws)
    say("train_compare_conv_errors", reference="float64 on the card",
        tf32=False, wall_s=time.perf_counter() - t0, convs=own)


# --train-compare-check's bisection of the card's float32 gap: a float64
# step on the card in which one op (or one kind of op) computes in float32
# (`_float32_islands`), its error carried to this gradient, relative to
# the model's largest gradient (train_compare's measure).
BISECT_BLOCK = "xattn_up_1_0"
BISECT_AT = BISECT_BLOCK + ".mlp1.weight"


@contextlib.contextmanager
def _setting(owner, name: str, value):
    """`owner.name` set to `value` inside the block (a torch.backends
    flag), restored after it."""
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


@contextlib.contextmanager
def _float32_islands(modules, attention_in=(),
                     within=contextlib.nullcontext):
    """Inside the block each module of `modules` computes in float32 in a
    float64 model: its inputs rounded to float32, its parameters and
    floating buffers read as float32 copies (gradients reach the float64
    ones), its output widened back; autograd runs its backward in float32
    too. The attention calls of the blocks `attention_in` (modules of the
    U-Net) take float32 inputs and the card's kernel
    (`attn.voxel_attention`), their outputs widened back. So each op sees
    float64-exact inputs and adds only its own float32 error, forward and
    backward. The islands' forwards run inside `within()` (a setting)."""
    def narrow(t):
        return t.float() if torch.is_tensor(t) and t.is_floating_point() \
            else t

    def island(m):
        fwd = m.forward

        def forward(*args, **kw):
            subs = list(m.modules())
            saved = [(sm, dict(sm._parameters), dict(sm._buffers))
                     for sm in subs]
            for sm in subs:
                for d in (sm._parameters, sm._buffers):
                    for n, t in d.items():
                        if t is not None and t.is_floating_point():
                            d[n] = t.float()
            try:
                with within():
                    out = fwd(*[narrow(a) for a in args],
                              **{k: narrow(v) for k, v in kw.items()})
            finally:
                for sm, p, b in saved:
                    sm._parameters.update(p)
                    sm._buffers.update(b)
            return out.double() if out.is_floating_point() else out
        return forward

    def attention_island(m):
        fwd = m.forward

        def forward(*args, **kw):
            real = unet3d.voxel_attention
            unet3d.voxel_attention = lambda q, k, v, scale=None: \
                attn.voxel_attention(q.float(), k.float(), v.float(),
                                     scale=scale).double()
            try:
                return fwd(*args, **kw)
            finally:
                unet3d.voxel_attention = real
        return forward

    for m in modules:
        m.forward = island(m)
    for m in attention_in:
        m.forward = attention_island(m)
    try:
        yield
    finally:
        for m in list(modules) + list(attention_in):
            del m.forward


def _bisect_cases(unet: UNet3D) -> dict:
    """name -> (modules that compute in float32, blocks whose attention
    calls do[, the setting their forwards run in]): every op of each kind
    over the whole U-Net (the convolutions also with cuDNN off, PyTorch's
    own CUDA convolution, and with cuDNN's deterministic algorithms), then
    each op of BISECT_BLOCK and its ContextMLP one at a time."""
    leaves = [(n, m) for n, m in unet.named_modules()
              if n and not list(m.children())]

    def kind(cls):
        return [m for _, m in leaves if isinstance(m, cls)]
    blocks = [m for m in unet.modules()
              if isinstance(m, (AttentionBlock, CrossAttentionBlock))]
    block = getattr(unet, BISECT_BLOCK)
    ctx_mlp = getattr(unet, "ctx_mlp_" + BISECT_BLOCK.removeprefix("xattn_"))
    cudnn = torch.backends.cudnn
    cases = {"whole U-Net": ([m for _, m in leaves], blocks),
             "every conv (cuDNN)": (kind(Conv3d), ()),
             "every dense (cuBLAS)": (kind(torch.nn.Linear), ()),
             "every norm": ([m for _, m in leaves
                             if "Norm" in type(m).__name__], ()),
             "every attention call (kernel)": ((), blocks),
             "every conv, cuDNN off": (kind(Conv3d), (), partial(
                 _setting, cudnn, "enabled", False)),
             "every conv, cuDNN deterministic": (kind(Conv3d), (), partial(
                 _setting, cudnn, "deterministic", True))}
    for name, m in block.named_children():
        cases[f"{BISECT_BLOCK}.{name}"] = ([m], ())
    cases[f"{BISECT_BLOCK} attention calls"] = ((), [block])
    cases[f"{BISECT_BLOCK} ContextMLP"] = ([ctx_mlp], ())
    for name, m in leaves:
        if isinstance(m, Conv3d):
            cases[f"conv {name}"] = ([m], ())
    return cases


def _relu_inputs(unet: UNet3D, seen: dict):
    """Forward hooks that keep BISECT_BLOCK's two ReLU inputs (the
    outputs of `proj_in` and `mlp1`) in `seen`; returns the handles."""
    block = getattr(unet, BISECT_BLOCK)
    return [getattr(block, n).register_forward_hook(
        lambda m, args, out, n=n: seen.__setitem__(n, out.detach().clone()))
        for n in ("proj_in", "mlp1")]


def _conv_own_errors(trainer: DiffusionTrainer, x, ctx, draws) -> dict:
    """Each convolution of the U-Net alone: its input and its output's
    gradient caught in the float64 compare step on the card, then the
    conv in float32 on those rounded to float32, with cuDNN's default
    algorithms and with cuDNN off (PyTorch's own CUDA convolution): the
    forward's, the input gradient's and the weight gradient's largest
    error, each relative to the float64 result's largest value."""
    tw = _float64_twin(trainer, 2, "cuda")
    unet = tw.model.unet
    convs = [(n, m) for n, m in unet.named_modules() if isinstance(m, Conv3d)]
    caught = {n: {} for n, _ in convs}

    def keep(n):
        def hook(m, args, out):
            caught[n]["x"] = args[0].detach().clone()
            out.register_hook(lambda g: caught[n].__setitem__(
                "g", g.detach().clone()))
        return hook
    handles = [m.register_forward_hook(keep(n)) for n, m in convs]
    on = {k: v.cuda() for k, v in draws.items()}
    with _NoTF32(), _float64_attention():
        tw.train_step_latents(x.cuda(), ctx.cuda(), **on)
    for h in handles:
        h.remove()

    def run(m, xin, gout):
        xin = xin.clone().requires_grad_(True)
        with torch.enable_grad():
            y = m(xin)
            dx, dw = torch.autograd.grad(y, (xin, m.weight), gout)
        return y.detach().double(), dx.double(), dw.double()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
    out = {}
    cudnn = torch.backends.cudnn
    with _NoTF32():
        for n, m in convs:
            c = caught[n]
            ref = run(m, c["x"], c["g"])
            m32 = copy.deepcopy(m).float()
            row = {}
            for name, setting in (("cudnn", contextlib.nullcontext()),
                                  ("cudnn_off", _setting(cudnn, "enabled",
                                                         False))):
                with setting:
                    got = run(m32, c["x"].float(), c["g"].float())
                row[name] = dict(zip(("y", "dx", "dw"), (
                    rel(a, b) for a, b in zip(got, ref))))
            out[n] = dict(shape=list(c["x"].shape),
                          kernel=list(m.kernel), **row)
    del tw, caught
    torch.cuda.empty_cache()
    return out


def _bisect_xattn(trainer: DiffusionTrainer, x, ctx, draws) -> dict:
    """The float64 compare step on the card, then once per case of
    `_bisect_cases` with that case's ops in float32: each case's error at
    BISECT_AT (and its worst tensor), relative to the float64 step's
    largest gradient; and the card's whole float32 step's, for the gap
    to account for. TF32 off throughout."""
    on = {k: v.cuda() for k, v in draws.items()}
    relu64 = {}

    def step(islands=None):
        tw = _float64_twin(trainer, 2, "cuda")
        unet = tw.model.unet
        mods, blocks, *within = islands(unet) if islands else ((), ())
        handles = [] if islands else _relu_inputs(unet, relu64)
        with _NoTF32(), _float64_attention(), \
                _float32_islands(mods, blocks, *within):
            tw.train_step_latents(x.cuda(), ctx.cuda(), **on)
            torch.cuda.synchronize()
        for h in handles:
            h.remove()
        grads = {n: p.grad.detach().clone()
                 for n, p in unet.named_parameters() if p.grad is not None}
        del tw
        torch.cuda.empty_cache()
        return grads
    ref = step()
    top = max(float(g.abs().max()) for g in ref.values())

    def errors(grads):
        errs = {n: float((grads[n].double() - g).abs().max()) / top
                for n, g in ref.items()}
        worst = max(errs, key=errs.get)
        return dict(at=errs[BISECT_AT], worst=worst, worst_err=errs[worst])
    card, relu32 = _twin(trainer, "cuda"), {}
    handles = _relu_inputs(card.model.unet, relu32)
    _card_step(card, x, ctx, draws)
    for h in handles:
        h.remove()
    out = {"card float32 step": errors(
        {n: p.grad for n, p in card.model.unet.named_parameters()})}
    # ReLU inputs of the block whose sign the card's float32 step flips
    flips = {n: dict(flipped=int((torch.sign(relu32[n].double())
                                  != torch.sign(relu64[n])).sum()),
                     elements=relu64[n].numel(),
                     closest_to_zero=float(relu64[n].abs().min()))
             for n in relu64}
    del card
    torch.cuda.empty_cache()
    names = list(_bisect_cases(trainer.model.unet))
    for name in names:
        out[name] = errors(step(lambda u, n=name: _bisect_cases(u)[n]))
    ops = [n for n in names if n.startswith(BISECT_BLOCK)]
    convs = [n for n in names if n.startswith("conv ")]
    gap = out["card float32 step"]["at"]
    return dict(at=BISECT_AT, cases=out, relu_sign_flips=flips,
                accounts_for_the_gap=[n for n in names
                                      if out[n]["at"] >= 0.9 * gap],
                largest_in_block=max(ops, key=lambda n: out[n]["at"]),
                largest_kind=max([n for n in names if n.startswith("every ")],
                                 key=lambda n: out[n]["at"]),
                largest_conv=max(convs, key=lambda n: out[n]["at"]))


def phase_train_breakdown(train: dict, attn_case: dict) -> None:
    """Where a train step's time goes, after the counted path: steady-state
    encode and step times, the attention calls' forward (kernel) and
    forward + backward (plain-version backward) at the train shape, and a
    profile of two latent steps; launches here are not counted."""
    trainer, lat, vols = train["trainer"], train["latents"], train["vols"]
    ctx = torch.ones(TRAIN_BATCH, dtype=torch.long, device="cuda")
    batch = lat[:TRAIN_BATCH]
    encode_ms = cuda_ms(lambda: trainer.encode_latents(vols[0]), 3,
                        warmup=1)
    lat_ms = cuda_ms(lambda: trainer.train_step_latents(batch, ctx), 3,
                     warmup=1)
    vol_ms = cuda_ms(lambda: trainer.train_step(vols[0], ctx), 3, warmup=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, k, v = (torch.randn(TRAIN_BATCH, 64, 512, generator=gen,
                           device="cuda").requires_grad_(True)
               for _ in range(3))
    g = torch.randn(TRAIN_BATCH, 64, 512, generator=gen, device="cuda")

    def fwd_bwd():
        torch.autograd.grad(attn.voxel_attention(q, k, v), (q, k, v), g)
    fwd_bwd_ms = cuda_ms(fwd_bwd, 50)
    calls = attention_calls_per_step(trainer.model.unet)
    say("train_breakdown", encode_ms_per_batch=encode_ms,
        volume_step_ms=vol_ms, latent_step_ms=lat_ms,
        counted_path_step_ms=train["step_ms"],
        attention_calls_per_step=calls,
        attention_fwd_ms_per_step=calls * attn_case["ms"],
        attention_fwd_bwd_eager_ms_per_step=calls * fwd_bwd_ms,
        attention_share_of_latent_step=calls * fwd_bwd_ms / lat_ms,
        max_memory_allocated=train["peak"])
    say("train_profile", **profiling.profile_steps(
        lambda: trainer.train_step_latents(batch, ctx), 2, lat_ms))


def _checkpoint_bytes(cfg) -> int:
    """float32 bytes of one checkpoint: the model (VQ-VAE, U-Net and
    statistics), the EMA U-Net and Adam's two moments of the U-Net."""
    with torch.device("meta"):
        model = LatentDiffusion(cfg.diffusion)
    numel = sum(t.numel() for t in model.state_dict().values())
    unet = sum(p.numel() for p in model.unet.parameters())
    unet_all = sum(t.numel() for t in model.unet.state_dict().values())
    return 4 * (numel + unet_all + 2 * unet)


def _state_equal(a: DiffusionTrainer, b: DiffusionTrainer) -> list:
    """Names of the state entries (model, EMA, Adam, step, generator)
    that differ between two trainers."""
    diff = []

    def walk(prefix, x, y):
        if isinstance(x, torch.Tensor):
            if not (x.shape == y.shape and torch.equal(x.cpu(), y.cpu())):
                diff.append(prefix)
        elif isinstance(x, dict):
            if x.keys() != y.keys():
                diff.append(prefix + "/keys")
            for k in x:
                walk(f"{prefix}/{k}", x[k], y.get(k))
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(f"{prefix}/{i}", u, v)
        elif x != y:
            diff.append(prefix)
    walk("", a.state_dict(), b.state_dict())
    return diff


def _resume_step_error(saver: DiffusionTrainer, restored: DiffusionTrainer,
                       lat: torch.Tensor, ctx: torch.Tensor,
                       device: str) -> dict:
    """One latent step on both trainers with the same injected draws,
    cuDNN deterministic: the largest relative difference of any U-Net
    parameter, EMA weight or Adam moment afterwards."""
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    b = lat.shape[0]
    draws = dict(t=torch.randint(0, saver.cfg.timesteps, (b,), generator=gen,
                                 device=device),
                 noise=torch.randn(lat.shape, generator=gen, device=device),
                 drop=torch.rand(b, generator=gen, device=device) < 0.1)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for tr in (saver, restored):
            tr.train_step_latents(lat, ctx, **draws)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    worst, where = 0.0, None
    pairs = [(f"unet.{n}", p, q) for (n, p), q in zip(
        saver.model.unet.named_parameters(),
        restored.model.unet.parameters())]
    pairs += [(f"ema.{n}", p, q) for (n, p), q in zip(
        saver.ema_unet.named_parameters(), restored.ema_unet.parameters())]
    for (name, p), q in zip(saver.model.unet.named_parameters(),
                            restored.model.unet.parameters()):
        for slot in ("exp_avg", "exp_avg_sq"):
            pairs.append((f"adam.{slot}.{name}",
                          saver.optimizer.state[p][slot],
                          restored.optimizer.state[q][slot]))
    for name, x, y in pairs:
        x, y = x.detach(), y.detach()
        diff = float((x - y).abs().max())
        scale = float(x.abs().max())
        err = diff / scale if scale > 0 else diff
        if where is None or err > worst:
            worst, where = err, name
    return dict(max_rel_err=worst, at=where, bitwise=worst == 0.0,
                tensors=len(pairs))


def _log_rows(path: str) -> list:
    """training.log's rows, values as floats."""
    import csv
    with open(path) as f:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def _card_processes() -> dict:
    """What nvidia-smi shows of the card's compute processes: their
    "pid, used memory" lines and the card's used memory, MiB. (On the
    card's machine it lists each process as pid 1: it sees another PID
    namespace than ours.)"""
    def smi(query):
        return subprocess.run(["nvidia-smi", query, "--format=csv,noheader"
                               ",nounits"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
    return dict(compute_apps=smi("--query-compute-apps=pid,used_memory"),
                memory_used_mib=int(smi("--query-gpu=memory.used")[0]))


def _maps(pid: int, names) -> dict:
    """Whether each of `names` is in a shared object that process `pid`
    has mapped (/proc/<pid>/maps)."""
    with open(f"/proc/{pid}/maps") as f:
        text = f.read()
    return {name: name in text for name in names}


def _await_serving(proc, log_path: str, timeout: float) -> str:
    """The URL the serve CLI prints once its socket is bound (read from
    its log); raises if the process ends or `timeout` s pass first."""
    deadline = time.monotonic() + timeout
    while True:
        with open(log_path) as f:
            text = f.read()
        found = re.search(r"^serving \S+ \(epoch \d+\) on (http://\S+)$",
                          text, re.M)
        if found:
            return found.group(1)
        if proc.poll() is not None or time.monotonic() > deadline:
            raise RuntimeError(f"cli serve_cli: exit code {proc.returncode}, "
                               f"no URL after {timeout} s:\n{text[-6000:]}")
        time.sleep(0.2)


_NO_PROXY = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _http(url: str, body: dict = None) -> tuple:
    """(status, payload, wall s) of POST `url` with `body` as JSON, or of
    GET `url` without it; on localhost, whatever proxy the environment
    names."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with _NO_PROXY.open(req, timeout=HTTP_REQUEST_TIMEOUT) as r:
            code, payload = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, payload = e.code, e.read()
    return code, payload, time.perf_counter() - t0


def _volumes(req: dict, payload: bytes, tmp: str) -> np.ndarray:
    """The volumes of a 200 answer, [num, H, W, D, 1]: the .npy payload,
    or the one volume of a .nii.gz one."""
    if req.get("format") != "nii":
        return np.load(io.BytesIO(payload))
    path = os.path.join(tmp, "answer.nii.gz")
    with open(path, "wb") as f:
        f.write(payload)
    return load_nifti(path)[0][None, ..., None]


def _serve_cli(argv: list, tmp: str, dev: str, size: int, card: str,
               counts: dict) -> None:
    """The serve CLI over HTTP (HTTP_REQUESTS) on a `--train_dm` run's
    checkpoint: `python -m ldm3d_torch.serve` with `argv` as a process of
    its own, on the card (the card's used memory grows as it starts; it
    maps the CUDA driver and the attention kernel's library), GET
    /healthz, each request's status, payload, wall time and volumes
    (finite, of the right shape); the guided DDIM answer against its
    repeat and against
    the same request to an in-process service built as the CLI builds it
    (counted into `counts`: 12 attention launches a step, every one
    bfloat16, no codebook launch), and the HTTP front's cost; then SIGINT
    must stop the process with exit code 0. The process is killed if
    anything fails on the way."""
    from ldm3d_torch import serve as serve_cli
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    log_path = os.path.join(tmp, "serve_cli.log")
    command = [sys.executable, "-m", "ldm3d_torch.serve", *argv]
    before = _card_processes() if dev == "cuda" else None
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(command, cwd=root, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        url = _await_serving(proc, log_path, HTTP_START_TIMEOUT)
        start_s = time.perf_counter() - t0
        after = _card_processes() if dev == "cuda" else None
        code, payload, health_s = _http(url + "/healthz")
        health = json.loads(payload)
        # the server holds its weights on the card: the card's used memory
        # grows (nvidia-smi cannot name its pid there)
        ok = code == 200 and health.get("status") == "ok" and (
            dev != "cuda"
            or after["memory_used_mib"] > before["memory_used_mib"])
        say("cli", step="serve_cli_start", command=command[1:], url=url,
            start_s=start_s, pid=proc.pid, card_before=before,
            card_serving=after, server_mib=None if after is None else
            after["memory_used_mib"] - before["memory_used_mib"],
            healthz_status=code, healthz=health, healthz_s=health_s, ok=ok,
            card=card)
        if not ok:
            raise RuntimeError(f"cli serve_cli: compute processes {before} "
                               f"then {after}, /healthz {code} {health}")
        answers = {}
        for name, req, want in HTTP_REQUESTS:
            code, payload, wall = _http(url + "/generate", req)
            line = dict(name=name, request=req, status=code,
                        expected_status=want, payload_bytes=len(payload),
                        wall_s=wall)
            if code == 200:
                vols = _volumes(req, payload, tmp)
                num = 1 if req.get("format") == "nii" else req["num"]
                finite = bool(np.isfinite(vols).all())
                ok = code == want and finite and vols.shape == (
                    num, size, size, size, 1)
                line.update(shape=list(vols.shape), finite=finite,
                            vol_per_min=60.0 * num / wall)
                answers[name] = (vols, wall)
            else:
                error = json.loads(payload).get("error", "")
                ok = code == want and "sampler" in error
                line.update(error=error)
            say("cli", step="serve_cli_request", **line, ok=ok, card=card)
            if not ok:
                raise RuntimeError(f"cli serve_cli {name}: {line}")
        if dev == "cuda":
            # the server's answers came from the card: it has the CUDA
            # driver and the attention kernel's library mapped
            mapped = _maps(proc.pid, ["libcuda.so", os.path.join(
                "_build", attn.KERNEL + "_")])
            say("cli", step="serve_cli_on_card", pid=proc.pid,
                mapped=mapped, ok=all(mapped.values()), card=card)
            if not all(mapped.values()):
                raise RuntimeError(f"cli serve_cli: mapped {mapped}")

        # the same guided request to a service in this process, built by
        # the CLI's own code from the same arguments (its socket closed)
        svc, server = serve_cli.server_from_args(argv)
        server.server_close()
        own, own_wall, got = _counted(counts, svc.generate, **HTTP_GUIDED)
        by_dtype = dict(attn.launches_by_dtype)    # zeroed by _counted
        # uncounted: the request again, warm, beside the HTTP repeat
        _sync(dev)
        t1 = time.perf_counter()
        svc.generate(**HTTP_GUIDED)
        _sync(dev)
        warm_wall = time.perf_counter() - t1
        counts[attn.KERNEL + ".bfloat16"] = counts.get(
            attn.KERNEL + ".bfloat16", 0) + by_dtype["bfloat16"]
        calls = attention_calls_per_step(svc.trainer.model.unet)
        steps = HTTP_GUIDED["sample_steps"]
        expect = {attn.KERNEL: calls * steps, cbq.KERNEL: 0}
        (first, first_wall), (repeat, repeat_wall) = (
            answers[k] for k in ("ddim_guided", "ddim_guided_repeat"))
        rel_repeat = float(np.abs(repeat - first).max()
                           / np.abs(first).max())
        rel_own = float(np.abs(first - own).max() / np.abs(own).max())
        dtype = svc.trainer.train_cfg.dtype
        ok = (rel_repeat <= REPEAT_REL_TOL and rel_own <= REPEAT_REL_TOL
              and got == expect and dtype == BF16
              and by_dtype[BF16] == sum(by_dtype.values()) == calls * steps)
        say("cli", step="serve_cli_vs_in_process", request=HTTP_GUIDED,
            dtype=dtype, repeat_rel_err=rel_repeat,
            in_process_rel_err=rel_own, tol=REPEAT_REL_TOL,
            in_process_wall_s=dict(first=own_wall, repeat=warm_wall),
            http_wall_s=dict(first=first_wall, repeat=repeat_wall),
            http_front_s=dict(first=first_wall - own_wall,
                              repeat=repeat_wall - warm_wall),
            payload_bytes=int(first.nbytes), launches=got, expected=expect,
            attention_launches_by_dtype=by_dtype, ok=ok, card=card)
        del svc, own
        if dev == "cuda":
            torch.cuda.empty_cache()
        if not ok:
            raise RuntimeError(f"cli serve_cli: repeat {rel_repeat}, in "
                               f"process {rel_own}, launches {got} "
                               f"{by_dtype}, dtype {dtype}")

        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        try:
            code = proc.wait(timeout=HTTP_STOP_TIMEOUT)
        except subprocess.TimeoutExpired:
            code = None
        stop_s = time.perf_counter() - t1
        with open(log_path) as f:
            text = f.read()
        ok = code == 0 and "stopped" in text
        say("cli", step="serve_cli_stop", signal="SIGINT", exit_code=code,
            stop_s=stop_s, ok=ok, log=text[-3000:], card=card)
        if not ok:
            raise RuntimeError(f"cli serve_cli: SIGINT left exit code "
                               f"{code}:\n{text[-6000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_cli(card: str) -> dict:
    """Main path 5: the port's command line at full flagship width, in
    process, in a temporary directory removed at the end: the flagship
    config from the conditional_dm3d preset and flags, --create_dataset
    --synthetic at 128^3, --train_dm --cache_latents for one epoch, an
    exact-resume check, --resume_ckpt -1 to a second epoch, --test_dm with
    DDIM, and GenerationService.from_checkpoint serving one request. The
    counters are zeroed before each of those user-facing steps and read
    after it; the checks between them (the resume step, the trainer's own
    generate) are not counted. Returns the launch counts and the first
    epoch's training.log row (the ddp phase's one-process reference)."""
    tmp = tempfile.mkdtemp(prefix="ldm3d_cli_")
    dev = CLI_DEVICE
    counts = {attn.KERNEL: 0, cbq.KERNEL: 0}
    counted = partial(_counted, counts)

    def argv(*extra):
        return CLI_FLAGSHIP + ["--cache_dir", os.path.join(tmp, "cache"),
                               "--ckpt_dir", os.path.join(tmp, "ckpt"),
                               "--out_dir", os.path.join(tmp, "out"),
                               "--platform", "gpu" if dev == "cuda"
                               else "cpu", *extra]

    def parse(*extra):
        args = cli.build_parser().parse_args(argv(*extra))
        return cli.apply_overrides(get_preset(args.preset), args), args

    real_encode, real_save = cli._encode_corpus, CheckpointManager.save
    real_restore = CheckpointManager.restore
    # torch_load_s: the checkpoint file opened (memory-mapped) and
    # unpickled; the tensors are read when a trainer loads them
    timing: Dict[str, list] = {"encode_s": [], "save_s": [],
                               "torch_load_s": []}
    encoded = {}

    def timed_encode(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat, ctx = real_encode(*a, **kw)
        torch.cuda.synchronize()
        timing["encode_s"].append(time.perf_counter() - t0)
        timing.setdefault("epoch_start", []).append(time.perf_counter())
        encoded["lat"], encoded["ctx"] = lat, ctx
        return lat, ctx

    def timed_save(self, epoch, state, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timing.setdefault("epoch_end", []).append(t0)
        out = real_save(self, epoch, state, *a, **kw)
        timing["save_s"].append(time.perf_counter() - t0)
        return out

    def timed_restore(self, *a, **kw):
        t0 = time.perf_counter()
        out = real_restore(self, *a, **kw)
        timing["torch_load_s"].append(time.perf_counter() - t0)
        return out

    cli._encode_corpus = timed_encode
    CheckpointManager.save = timed_save
    CheckpointManager.restore = timed_restore
    try:
        cfg, _ = parse()
        # the preset's stage-1 has remat on, which only acts where
        # gradients flow (stage-1 training), never in the frozen stage-1
        want = flagship_cfg()
        want = replace(want, vqvae=replace(want.vqvae, remat=True))
        differ = [f.name for f in dataclasses.fields(want)
                  if getattr(cfg.diffusion, f.name) != getattr(want, f.name)]
        ckpt_bytes = _checkpoint_bytes(cfg)
        free = shutil.disk_usage(tmp).free
        need = (CLI_KEEP + 1) * ckpt_bytes + 2 * 2 ** 30
        say("cli", config_equals_flagship=not differ, differ=differ,
            preset=CLI_FLAGSHIP[1], flags=CLI_FLAGSHIP, tmp=tmp,
            disk_free=free, disk_needed=need,
            checkpoint_bytes_expected=ckpt_bytes, card=card)
        if differ:
            raise RuntimeError(f"cli: config differs from flagship_cfg() "
                               f"in {differ}")
        if free < need:
            raise RuntimeError(f"cli: {free} bytes free in {tmp}, "
                               f"{need} needed for {CLI_KEEP} checkpoints")

        cfg, args = parse("--create_dataset", "--synthetic",
                          "--num_synthetic", str(CLI_VOLUMES))
        _, corpus_s, got = counted(cli.run_create_dataset, cfg, args)
        say("cli", step="create_dataset", volumes=CLI_VOLUMES,
            volume=cfg.data.volume_size, corpus_write_s=corpus_s,
            launches=got, card=card)

        cfg, args = parse("--train_dm", "--cache_latents", "--epochs", "1",
                          "--lbs", str(CLI_LBS))
        cfg = replace(cfg, train=replace(cfg.train,
                                         keep_checkpoints=CLI_KEEP))
        torch.cuda.reset_peak_memory_stats()
        saver, train_s, got1 = counted(cli.run_train_dm, cfg, args)
        peak_train = torch.cuda.max_memory_allocated()
        tr_idx, _ = train_val_split(CLI_VOLUMES, cfg.train.val_fraction,
                                    cfg.train.seed)
        batches = len(tr_idx) // CLI_LBS   # encoded; one step each
        steps = batches
        calls = attention_calls_per_step(saver.model.unet)
        expect = {attn.KERNEL: calls * steps, cbq.KERNEL: batches}
        ckpt_dir = os.path.join(tmp, "ckpt", f"{cfg.name}_dm")
        path1 = os.path.join(ckpt_dir, "1.pt")
        size1 = os.path.getsize(path1)
        epoch_s = timing["epoch_end"][0] - timing["epoch_start"][0]
        say("cli", step="train_dm", epochs=1, batch=CLI_LBS,
            encoded=list(encoded["lat"].shape),
            encode_s=timing["encode_s"][0], epoch_s=epoch_s, steps=steps,
            run_s=train_s, checkpoint_bytes=size1,
            save_s=timing["save_s"][0], launches=got1, expected=expect,
            max_memory_allocated=peak_train, card=card)
        if got1 != expect or saver.step != steps:
            raise RuntimeError(f"cli train_dm: launches {got1}, expected "
                               f"{expect}, step {saver.step}")
        train_log = _log_rows(os.path.join(ckpt_dir, "training.log"))[0]

        # resume is exact: restore epoch 1 into a fresh trainer
        fresh = DiffusionTrainer(cfg.diffusion, device=dev,
                                 train_cfg=cfg.train)
        t0 = time.perf_counter()
        state, ep = CheckpointManager(ckpt_dir).restore(1)
        fresh.load_state_dict(state)
        del state
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        differ = _state_equal(saver, fresh)
        restored_step = fresh.step
        lat = encoded["lat"][:CLI_LBS]
        ctx = encoded["ctx"][:CLI_LBS]
        err = _resume_step_error(saver, fresh, lat, ctx, dev)
        say("cli", step="resume_check", restored_epoch=ep,
            restored_step=restored_step, state_differs=differ,
            restore_s=restore_s, **err,
            tol=CLI_RESUME_REL_TOL, card=card)
        if differ or err["max_rel_err"] > CLI_RESUME_REL_TOL:
            raise RuntimeError(f"cli resume: state differs in {differ[:5]}, "
                               f"step error {err}")
        del fresh, saver
        torch.cuda.empty_cache()

        cfg, args = parse("--train_dm", "--cache_latents", "--epochs", "2",
                          "--lbs", str(CLI_LBS), "--resume_ckpt", "-1")
        cfg = replace(cfg, train=replace(cfg.train,
                                         keep_checkpoints=CLI_KEEP))
        out = io.StringIO()   # the CLI's own lines, shown after the run
        with contextlib.redirect_stdout(out):
            trainer, resume_s, got2 = counted(cli.run_train_dm, cfg, args)
        text = out.getvalue()
        print(text, end="", flush=True)
        started = re.findall(r"^epoch (\d+)/2 ", text, re.M)
        kept = CheckpointManager(ckpt_dir).all_epochs()
        say("cli", step="resume", resumed_from=1, epochs_run=started,
            run_s=resume_s, encode_s=timing["encode_s"][-1],
            epoch_s=timing["epoch_end"][-1] - timing["epoch_start"][-1],
            save_s=timing["save_s"][-1],
            torch_load_s=timing["torch_load_s"][-1], checkpoints=kept,
            trainer_step=trainer.step, launches=got2, expected=expect,
            card=card)
        if ("resumed from epoch 1" not in text or started != ["2"]
                or got2 != expect or trainer.step != 2 * steps
                or kept != [1, 2]):
            raise RuntimeError(f"cli resume: epochs {started}, launches "
                               f"{got2}, step {trainer.step}, kept {kept}")

        cfg, args = parse("--test_dm", "--sampler", "ddim",
                          "--sample_steps", str(CLI_TEST_STEPS))
        paths, test_s, got3 = counted(cli.run_test_dm, cfg, args)
        vols = [np.load(p) for p in paths]
        size = cfg.data.volume_size
        shapes_ok = len(vols) == cfg.diffusion.unet.context_dim + 1 and all(
            v.shape == (4, size, size, size, 1) for v in vols)
        finite = all(bool(np.isfinite(v).all()) for v in vols)
        expect3 = {attn.KERNEL: calls * CLI_TEST_STEPS * len(vols),
                   cbq.KERNEL: 0}
        say("cli", step="test_dm", sampler="ddim", steps=CLI_TEST_STEPS,
            files=[os.path.basename(p) for p in paths],
            shapes=[list(v.shape) for v in vols], finite=finite,
            test_dm_s=test_s, torch_load_s=timing["torch_load_s"][-1],
            launches=got3, expected=expect3, card=card)
        if not (shapes_ok and finite and got3 == expect3):
            raise RuntimeError(f"cli test_dm: shapes {shapes_ok}, finite "
                               f"{finite}, launches {got3}")
        del vols

        cfg, args = parse("--fidelity_sweep", "--lbs", str(CLI_LBS),
                          *CLI_FIDELITY_SWEEP)
        rows, sweep_s, got5 = counted(cli.run_fidelity_sweep, cfg, args)
        tr_idx, va_idx = train_val_split(CLI_VOLUMES, cfg.train.val_fraction,
                                         cfg.train.seed)
        real = va_idx if len(va_idx) >= CLI_LBS else tr_idx
        n_ctx = cfg.diffusion.unet.context_dim + 1
        samples = int(CLI_FIDELITY_SWEEP[
            CLI_FIDELITY_SWEEP.index("--fidelity_samples") + 1])
        gens = n_ctx * -(-(samples // n_ctx) // min(samples, 16))
        expect5 = {attn.KERNEL: calls * CLI_FIDELITY_STEPS * gens
                   * len(rows), cbq.KERNEL: len(real) // CLI_LBS}
        names = [os.path.basename(p) for p in glob.glob(
            os.path.join(tmp, "out", "fidelity_sweep_*"))]
        rows_ok = len(rows) == 4 and all(
            np.isfinite(r["latent_fid"]) and "fid_class_sep" in r
            for r in rows)
        say("cli", step="fidelity_sweep", flags=CLI_FIDELITY_SWEEP,
            rows=rows, files=sorted(names), wall_s=sweep_s, launches=got5,
            expected=expect5, card=card)
        if not rows_ok or got5 != expect5 or len(names) != 2:
            raise RuntimeError(f"cli fidelity_sweep: rows {rows}, launches "
                               f"{got5}, files {names}")

        profiled = ("--test_dm", "--sampler", "ddim", "--sample_steps",
                    str(CLI_PROFILE_STEPS), "--profile")
        cfg, _ = parse(*profiled)
        _, prof_s, got6 = counted(cli.main, argv(*profiled))
        expect6 = {attn.KERNEL: calls * CLI_PROFILE_STEPS * n_ctx,
                   cbq.KERNEL: 0}
        traces = glob.glob(os.path.join(cfg.ckpt_dir, "trace",
                                        "*.pt.trace.json"))
        kernels = set()
        for path in traces:
            with open(path) as f:
                kernels |= {e.get("name", "") for e in
                            json.load(f).get("traceEvents", [])
                            if e.get("cat") == "kernel"}
        named = sorted(k for k in kernels if attn.KERNEL in k)
        say("cli", step="test_dm_profile", wall_s=prof_s,
            traces=[os.path.basename(t) for t in traces],
            trace_bytes=[os.path.getsize(t) for t in traces],
            device_kernel_names=len(kernels), attention_kernels=named,
            launches=got6, expected=expect6, card=card)
        if len(traces) != 1 or not named or got6 != expect6:
            raise RuntimeError(f"cli --profile: traces {traces}, attention "
                               f"kernels {named}, launches {got6}")

        meta_cfg = cli._adopt_dm_meta(*parse())
        svc = GenerationService.from_checkpoint(meta_cfg, ckpt_dir, ema=True,
                                                device=dev)
        torch.cuda.reset_peak_memory_stats()
        served, serve_s, got4 = counted(svc.generate, **CLI_REQUEST)
        peak_serve = torch.cuda.max_memory_allocated()
        shape = (CLI_REQUEST["num"],) + (cfg.diffusion.latent_size,) * 3 \
            + (cfg.diffusion.latent_channels,)
        gen = torch.Generator(device=dev).manual_seed(CLI_REQUEST["seed"])
        own = trainer.generate(
            shape, torch.full((CLI_REQUEST["num"],), CLI_REQUEST["context"],
                              dtype=torch.long, device=dev),
            generator=gen, sampler="ddim",
            sample_steps=CLI_REQUEST["sample_steps"]).cpu().numpy()
        rel = float(np.abs(served - own).max() / np.abs(own).max())
        expect4 = {attn.KERNEL: calls * CLI_REQUEST["sample_steps"],
                   cbq.KERNEL: 0}
        say("cli", step="serve_from_checkpoint", epoch=svc.epoch,
            request=CLI_REQUEST, wall_s=serve_s,
            vol_per_min=60.0 * CLI_REQUEST["num"] / serve_s,
            rel_err_vs_trainer=rel, tol=CLI_SERVE_REL_TOL,
            finite=bool(np.isfinite(served).all()),
            max_memory_allocated=peak_serve, launches=got4,
            expected=expect4, card=card)
        if rel > CLI_SERVE_REL_TOL or got4 != expect4 \
                or not np.isfinite(served).all():
            raise RuntimeError(f"cli serve: rel_err {rel}, launches {got4}")
        del svc, trainer, served, own
        if dev == "cuda":
            torch.cuda.empty_cache()
        # --preset and --norm as trained: train_meta.json records the
        # sampling invariants, not the stage-1's norm
        _serve_cli(CLI_FLAGSHIP[:4] + ["--ckpt_dir", ckpt_dir, "--port", "0"]
                   + ([] if dev == "cuda" else ["--platform", "cpu"]),
                   tmp, dev, cfg.data.volume_size, card, counts)
        say("cli", launches=counts, peak_train=peak_train,
            peak_serve=peak_serve, card=card)
        return dict(counts=counts, train_log=train_log)
    finally:
        cli._encode_corpus = real_encode
        CheckpointManager.save = real_save
        CheckpointManager.restore = real_restore
        shutil.rmtree(tmp, ignore_errors=True)


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| relative to max |b| (b the CPU reference)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale > 0 else \
        float((a - b).abs().max())


def _quantizer_pass(q, x, w, draws: dict, dev: str) -> dict:
    """One training-mode forward and backward of sum(out * w) + loss."""
    xt = torch.from_numpy(x).to(dev).requires_grad_(True)
    injected = {k: [torch.from_numpy(a) for a in v] for k, v in draws.items()}
    out, aux = q.train()(xt, Draws(**injected))
    (torch.sum(out * torch.from_numpy(w).to(dev)) + aux.loss).backward()
    return dict(out=out, loss=aux.loss, perplexity=aux.perplexity,
                indices=aux.indices, x_grad=xt.grad,
                **{f"grad.{n}": p.grad for n, p in q.named_parameters()},
                **{f"buffer.{n}": b for n, b in q.named_buffers()})


def phase_quantizers() -> None:
    """Each quantizer kind, one training-mode forward and backward on the
    card (the codebook kernel) against the CPU (the plain version), from
    the same initial buffers with the same injected draws (the NSVQ and
    RNSVQ noise, the EMA quantizer's two row permutations): output, loss,
    indices, gradients and the updated usage and EMA state."""
    rng = np.random.default_rng(SEED + 11)
    x = rng.standard_normal(QUANT_SHAPE).astype(np.float32)
    w = rng.standard_normal(QUANT_SHAPE).astype(np.float32)
    n = int(np.prod(QUANT_SHAPE[:-1]))
    draws = dict(normal=[rng.standard_normal(QUANT_SHAPE).astype(np.float32)],
                 permutation=[rng.permutation(n), rng.permutation(n)])
    for kind in QUANT_KINDS:
        cfg = QuantizerConfig(kind=kind, num_embeddings=QUANT_K,
                              embedding_dim=QUANT_SHAPE[-1], num_stages=3)
        cpu_q = make_quantizer(cfg)
        cpu_q.reset_parameters(torch.Generator().manual_seed(SEED))
        card_q = make_quantizer(cfg).cuda()
        card_q.load_state_dict(cpu_q.state_dict())
        ref = _quantizer_pass(cpu_q, x, w, draws, "cpu")
        got = _quantizer_pass(card_q, x, w, draws, "cuda")
        torch.cuda.synchronize()
        same_indices = torch.equal(got.pop("indices").cpu(),
                                   ref.pop("indices"))
        errs = {k: _max_rel(got[k], ref[k]) for k in ref}
        worst = max(errs, key=errs.get)
        ok = same_indices and errs[worst] <= QUANT_REL_TOL
        say("quantizers", kind=kind, rows=n, K=QUANT_K,
            indices_equal=same_indices, max_rel_err=errs[worst], at=worst,
            tol=QUANT_REL_TOL, compared=sorted(errs), ok=ok)
        if not ok:
            raise RuntimeError(f"quantizers {kind}: indices equal "
                               f"{same_indices}, {worst} {errs[worst]}")


def _counted(totals: Dict[str, int], fn, *a, **kw):
    """Run one user-facing piece of a main path with the launch counters
    zeroed just before and read just after; (result, wall s, counts)."""
    torch.cuda.synchronize()
    attn.reset_launches()   # a piece of the main path starts here
    cbq.reset_launches()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {attn.KERNEL: attn.launches, cbq.KERNEL: cbq.launches}
    for k in totals:
        totals[k] += got[k]
    return out, wall, got


def _vq_batch(rng, b: int, size: int, dev: str):
    vol = _seeded_volumes(rng, b, size).to(dev)
    return vol, (vol > 0.5).float()


def _remat_steps(tr: VQTrainer, vol, mask, steps: int, **remat) -> dict:
    """`steps` train steps of `tr` with its encoder and decoder switched to
    the remat setting `remat`: each step's wall ms, the peak memory over
    them, the launches of all the steps (by kernel, and the codebook's by
    the dtype it received), the last step's metrics."""
    for part in (tr.model.encoder, tr.model.decoder):
        part.cfg = replace(part.cfg, **remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    launches = {attn.KERNEL: 0, cbq.KERNEL: 0}
    codebook_by_dtype = dict.fromkeys(cbq.launches_by_dtype, 0)
    for _ in range(steps):
        m, wall, _ = _counted(launches, tr.train_step, vol, mask)
        walls.append(1e3 * wall)
        for k, n in cbq.launches_by_dtype.items():
            codebook_by_dtype[k] += n
    return dict(step_ms=walls, median_step_ms=float(np.median(walls)),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                steps=steps, launches=launches,
                codebook_by_dtype=codebook_by_dtype,
                metrics={k: float(v) for k, v in m.items()})


def phase_train_vq(card: str) -> dict:
    """Main path 6: the flagship's stage-1 trained from the command line
    at full width, in process, in a temporary directory removed at the
    end: --create_dataset --synthetic (24 volumes, 128^3); --train_vq
    --epochs 1 at --lbs 8 with a validation batch, image montages and
    unused-code replacement after the epoch; an exact-resume check;
    --test_vq; --train_dm --cache_latents --vqvae_load_ckpt <that stage-1>
    for one epoch (--test_run: no 6.3 GB checkpoint); one train step each
    of nsvqvae and rnsvqvae at batch 8. Then, uncounted: SSIM / PSNR card
    against CPU, and the stage-1 step's time and peak memory with remat
    full, conv and off."""
    tmp = tempfile.mkdtemp(prefix="ldm3d_train_vq_")
    dev = CLI_DEVICE
    counts = {attn.KERNEL: 0, cbq.KERNEL: 0}

    def parse(flags, *extra):
        argv = flags + ["--cache_dir", os.path.join(tmp, "cache"),
                        "--ckpt_dir", os.path.join(tmp, "ckpt"),
                        "--out_dir", os.path.join(tmp, "out"),
                        "--platform", "gpu" if dev == "cuda" else "cpu",
                        *extra]
        args = cli.build_parser().parse_args(argv)
        return cli.apply_overrides(get_preset(args.preset), args), args

    timing: Dict[str, list] = {"train_step_ms": [], "eval_ms": [],
                               "save_s": []}
    real_step, real_eval = VQTrainer.train_step, VQTrainer.eval_step
    real_save = CheckpointManager.save

    def timed(fn, key, scale):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timing[key].append(scale * (time.perf_counter() - t0))
            return out
        return run

    VQTrainer.train_step = timed(real_step, "train_step_ms", 1e3)
    VQTrainer.eval_step = timed(real_eval, "eval_ms", 1e3)
    CheckpointManager.save = timed(real_save, "save_s", 1.0)
    try:
        cfg, _ = parse(TRAIN_VQ_FLAGS)
        want = flagship_cfg().vqvae
        same = cfg.vqvae == replace(want, remat=True)
        say("train_vq", preset=TRAIN_VQ_FLAGS[1], flags=TRAIN_VQ_FLAGS,
            config_equals_flagship_stage1=same, remat=cfg.vqvae.remat,
            tmp=tmp, disk_free=shutil.disk_usage(tmp).free, card=card)
        if not same:
            raise RuntimeError(f"train_vq: {cfg.vqvae} is not the flagship "
                               "stage-1")

        cfg, args = parse(TRAIN_VQ_FLAGS, "--create_dataset", "--synthetic",
                          "--num_synthetic", str(TRAIN_VQ_VOLUMES))
        _, corpus_s, _ = _counted(counts, cli.run_create_dataset, cfg, args)

        cfg, args = parse(TRAIN_VQ_FLAGS, "--train_vq", "--epochs", "1",
                          "--lbs", str(TRAIN_VQ_LBS), "--val_perc",
                          str(TRAIN_VQ_VAL), "--image_log_freq", "1")
        cfg = replace(cfg, train=replace(cfg.train, replace_codebook_freq=1))
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            saver, train_s, got1 = _counted(counts, cli.run_train_vq, cfg,
                                            args)
        text = out.getvalue()
        print(text, end="", flush=True)
        peak = torch.cuda.max_memory_allocated()
        tr_idx, va_idx = train_val_split(TRAIN_VQ_VOLUMES,
                                         cfg.train.val_fraction,
                                         cfg.train.seed)
        steps = len(tr_idx) // TRAIN_VQ_LBS
        val_batches = len(va_idx) // TRAIN_VQ_LBS
        # one launch per train step, eval batch and montage reconstruction
        expect1 = {attn.KERNEL: 0, cbq.KERNEL: steps + val_batches + 1}
        ckpt_dir = os.path.join(tmp, "ckpt", f"{cfg.name}_vq")
        size1 = os.path.getsize(os.path.join(ckpt_dir, "1.pt"))
        n_params = sum(p.numel() for p in saver.model.parameters())
        n_state = sum(t.numel() for t in saver.model.state_dict().values())
        images = sorted(os.listdir(os.path.join(ckpt_dir, "images")))
        log_header = open(os.path.join(ckpt_dir, "training.log")).readline()
        val_cols = all(c in log_header for c in ("val_loss", "val_ssim",
                                                 "val_psnr",
                                                 "codebooks_replaced"))
        say("train_vq", step="train_vq", epochs=1, batch=TRAIN_VQ_LBS,
            volume=cfg.data.volume_size, steps=steps,
            val_batches=val_batches, run_s=train_s,
            train_step_ms=timing["train_step_ms"][:steps],
            eval_ms_per_batch=timing["eval_ms"][:val_batches],
            checkpoint_bytes=size1, checkpoint_bytes_float32=4 * (
                n_state + 2 * n_params), parameters=n_params,
            save_s=timing["save_s"][0], images=images,
            log_has_val_and_replacement=val_cols, corpus_write_s=corpus_s,
            launches=got1, expected=expect1, max_memory_allocated=peak,
            remat=cfg.vqvae.remat, card=card)
        if (got1 != expect1 or saver.step != steps or not val_cols
                or "epoch 1/1" not in text or len(images) != 2):
            raise RuntimeError(f"train_vq: launches {got1}, expected "
                               f"{expect1}, step {saver.step}, log columns "
                               f"{val_cols}, images {images}")

        # resume is exact: restore epoch 1 into a fresh trainer
        fresh = VQTrainer(cfg.vqvae, cfg.train, device=dev)
        t0 = time.perf_counter()
        state, ep = CheckpointManager(ckpt_dir).restore(1)
        fresh.load_state_dict(state)
        del state
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        differ = _state_equal(saver, fresh)
        rng = np.random.default_rng(SEED + 12)
        vol, mask = _vq_batch(rng, TRAIN_VQ_LBS, cfg.data.volume_size, dev)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            for tr in (saver, fresh):
                tr.train_step(vol, mask)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        after = _state_equal(saver, fresh)
        say("train_vq", step="resume_check", restored_epoch=ep,
            restore_s=restore_s, state_differs=differ,
            differs_after_one_step=after, bitwise=not differ and not after,
            card=card)
        if differ or after:
            raise RuntimeError(f"train_vq resume: state differs in "
                               f"{(differ + after)[:5]}")
        del fresh, saver
        torch.cuda.empty_cache()

        cfg, args = parse(TRAIN_VQ_FLAGS, "--test_vq", "--lbs",
                          str(TRAIN_VQ_LBS), "--val_perc", str(TRAIN_VQ_VAL))
        (paths, mse), test_s, got2 = _counted(counts, cli.run_test_vq, cfg,
                                              args)
        expect2 = {attn.KERNEL: 0, cbq.KERNEL: 2 * val_batches}
        orig = torch.from_numpy(np.load(os.path.join(tmp, "out",
                                                     "original_0.npy")))
        recon = torch.from_numpy(np.load(os.path.join(tmp, "out",
                                                      "reconst_0.npy")))
        finite = bool(torch.isfinite(recon).all())
        shapes_ok = orig.shape == recon.shape == (TRAIN_VQ_LBS,) + (
            cfg.data.volume_size,) * 3 + (1,)
        ssim_card = float(volume_ssim(recon.to(dev), orig.to(dev)))
        psnr_card = float(volume_psnr(recon.to(dev), orig.to(dev)))
        ssim_cpu, psnr_cpu = float(volume_ssim(recon, orig)), \
            float(volume_psnr(recon, orig))
        metrics_ok = (ssim_card <= 1.0
                      and abs(ssim_card - ssim_cpu) <= SSIM_ATOL
                      and abs(psnr_card - psnr_cpu)
                      <= PSNR_RTOL * abs(psnr_cpu))
        say("train_vq", step="test_vq", files=sorted(
            os.path.basename(p) for p in paths), mean_mse=mse,
            test_vq_s=test_s, shapes_ok=shapes_ok, finite=finite,
            ssim_card=ssim_card, ssim_cpu=ssim_cpu, ssim_tol=SSIM_ATOL,
            psnr_card=psnr_card, psnr_cpu=psnr_cpu, psnr_rtol=PSNR_RTOL,
            launches=got2, expected=expect2, card=card)
        if not (shapes_ok and finite and metrics_ok and got2 == expect2
                and len(paths) == 2 * val_batches):
            raise RuntimeError(f"train_vq test_vq: shapes {shapes_ok}, "
                               f"finite {finite}, ssim {ssim_card} / "
                               f"{ssim_cpu}, psnr {psnr_card} / {psnr_cpu}, "
                               f"launches {got2}")

        cfg, args = parse(CLI_FLAGSHIP, "--train_dm", "--cache_latents",
                          "--epochs", "1", "--lbs", str(CLI_LBS),
                          "--test_run", "--vqvae_load_ckpt", ckpt_dir)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            dm, dm_s, got3 = _counted(counts, cli.run_train_dm, cfg, args)
        text = out.getvalue()
        print(text, end="", flush=True)
        tr_idx, _ = train_val_split(TRAIN_VQ_VOLUMES, cfg.train.val_fraction,
                                    cfg.train.seed)
        dm_steps = len(tr_idx) // CLI_LBS
        expect3 = {attn.KERNEL: attention_calls_per_step(dm.model.unet)
                   * dm_steps, cbq.KERNEL: dm_steps}
        loaded = "loaded stage-1 VQ-VAE weights from epoch 1" in text
        say("train_vq", step="train_dm_on_stage1", run_s=dm_s,
            stage1_loaded=loaded, steps=dm.step,
            latent_scale=dm.cfg.latent_scale, launches=got3,
            expected=expect3, card=card)
        if not loaded or got3 != expect3 or dm.step != dm_steps:
            raise RuntimeError(f"train_vq train_dm: loaded {loaded}, "
                               f"launches {got3}, step {dm.step}")
        del dm
        torch.cuda.empty_cache()

        # --sweep over two learning rates, one epoch each, on the corpus
        spec = os.path.join(tmp, "sweep.yaml")
        with open(spec, "w") as f:
            f.write(TRAIN_VQ_SWEEP)
        cfg, args = parse(TRAIN_VQ_FLAGS, "--sweep", spec, "--lbs",
                          str(TRAIN_VQ_LBS), "--val_perc", str(TRAIN_VQ_VAL),
                          "--ckpt_dir", os.path.join(tmp, "sweep"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            recs, sweep_s, got4 = _counted(counts, cli.run_sweep, cfg, args)
        print(out.getvalue(), end="", flush=True)
        expect4 = {attn.KERNEL: 0,
                   cbq.KERNEL: len(recs) * (steps + val_batches)}
        recs_ok = len(recs) == 2 and all(
            "error" not in r and np.isfinite(r["metrics"].get("val_loss",
                                                              np.nan))
            for r in recs)
        say("train_vq", step="sweep", records=recs, wall_s=sweep_s,
            launches=got4, expected=expect4, card=card)
        if not recs_ok or got4 != expect4:
            raise RuntimeError(f"train_vq sweep: records {recs}, launches "
                               f"{got4}")

        # --device_data: the same corpus computed on the card, one epoch
        dd = (TRAIN_VQ_FLAGS, "--synthetic", "--device_data", "--lbs",
              str(TRAIN_VQ_LBS), "--val_perc", str(TRAIN_VQ_VAL),
              "--num_synthetic", str(TRAIN_VQ_VOLUMES))
        cfg, args = parse(*dd, "--train_vq", "--epochs", "1", "--ckpt_dir",
                          os.path.join(tmp, "device_data"))
        m_dd, dd_s, got5 = _counted(counts, cli.run_train_vq, cfg, args)
        expect5 = {attn.KERNEL: 0, cbq.KERNEL: steps + val_batches}
        dev_train, _ = cli._loaders(cfg, args, torch.device(dev))
        cfg_c, args_c = parse(TRAIN_VQ_FLAGS, "--lbs", str(TRAIN_VQ_LBS),
                              "--val_perc", str(TRAIN_VQ_VAL))
        cache_train, _ = cli._loaders(cfg_c, args_c, torch.device(dev))
        a, b = (next(iter(ld)) for ld in (cache_train, dev_train))
        same = all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(a, b))
        say("train_vq", step="device_data", loader=type(dev_train).__name__,
            cache_loader_reader=cache_train.reader,
            first_batch_bitwise=same, run_s=dd_s, steps=m_dd.step,
            launches=got5, expected=expect5, card=card)
        if (got5 != expect5 or not same or m_dd.step != steps
                or cache_train.reader != "native"
                or not isinstance(dev_train, DeviceSyntheticLoader)):
            raise RuntimeError(f"train_vq device_data: launches {got5}, "
                               f"first batch equal {same}, reader "
                               f"{cache_train.reader}")
        del m_dd, a, b
        torch.cuda.empty_cache()

        rng = np.random.default_rng(SEED + 13)
        vol, mask = _vq_batch(rng, TRAIN_VQ_LBS, TRAIN_VQ_SIZE, dev)
        others = {}
        for preset, per_step in (("nsvqvae", 1), ("rnsvqvae", 4)):
            pcfg = get_preset(preset)
            tc = replace(pcfg.train, batch_size=TRAIN_VQ_LBS, dtype=F32)
            tr = VQTrainer(pcfg.vqvae, tc, device=dev).init_random(
                SEED, "reach")
            m, wall, got = _counted(counts, tr.train_step, vol, mask)
            finite = all(np.isfinite(float(v)) for v in m.values())
            others[preset] = dict(step_ms=1e3 * wall, launches=got,
                                  expected={attn.KERNEL: 0,
                                            cbq.KERNEL: per_step},
                                  finite=finite,
                                  metrics={k: float(v) for k, v in m.items()})
            del tr
            torch.cuda.empty_cache()
            if got != others[preset]["expected"] or not finite:
                raise RuntimeError(f"train_vq {preset}: launches {got}, "
                                   f"finite {finite}")
        say("train_vq", step="nsvq_rnsvq", batch=TRAIN_VQ_LBS,
            volume=TRAIN_VQ_SIZE, **others, card=card)

        # uncounted: the flagship stage-1 step with remat full, conv and
        # off, on one trainer whose first step (Adam's state, cuDNN's
        # set-up) is not timed; REMAT_STEPS timed steps each
        cfg, _ = parse(TRAIN_VQ_FLAGS)
        tc = replace(cfg.train, batch_size=TRAIN_VQ_LBS)
        tr = VQTrainer(cfg.vqvae, tc, device=dev).init_random(SEED, "reach")
        tr.train_step(vol, mask)
        memory = {name: _remat_steps(tr, vol, mask, REMAT_STEPS, **kw)
                  for name, kw in (
                      ("full", dict(remat=True, remat_policy="full")),
                      ("conv", dict(remat=True, remat_policy="conv")),
                      ("off", dict(remat=False)))}
        say("train_vq", step="remat_memory", batch=TRAIN_VQ_LBS,
            volume=TRAIN_VQ_SIZE, **memory, card=card)
        # the step as the CLI trains it (remat full), profiled
        _remat_steps(tr, vol, mask, 1, remat=True, remat_policy="full")
        say("train_vq", step="profile", batch=TRAIN_VQ_LBS,
            volume=TRAIN_VQ_SIZE, remat="full", **profiling.profile_steps(
                lambda: tr.train_step(vol, mask), 2,
                memory["full"]["median_step_ms"]),
            card=card)
        del tr
        torch.cuda.empty_cache()
        say("train_vq", launches=counts, card=card)
        return counts
    finally:
        VQTrainer.train_step, VQTrainer.eval_step = real_step, real_eval
        CheckpointManager.save = real_save
        shutil.rmtree(tmp, ignore_errors=True)


def _gan_copy(src: GANTrainer, dst: GANTrainer) -> None:
    """dst takes src's networks, both Adams and the epoch."""
    dst.model.load_state_dict(src.model.state_dict())
    dst.optimizer.load_state_dict(src.optimizer.state_dict())
    dst.disc_optimizer.load_state_dict(src.disc_optimizer.state_dict())
    dst.epoch = src.epoch


def _gan_draws(rng, n_rows: int, lo: int, hi: int) -> dict:
    """One step's draws: the EMA quantizer's two row permutations (init
    and restart) and one frame index per item."""
    return dict(permutation=[rng.permutation(n_rows) for _ in range(2)],
                randint=[rng.integers(lo, hi, GAN_BATCH)])


def _gan_step_errors(card: GANTrainer, ref: GANTrainer, mc: dict,
                     mr: dict) -> dict:
    """Relative errors of one step, card against CPU: each metric, each
    subtree's gradients, the critics' statistics and the quantizer."""
    errs = {f"metric.{k}": abs(float(mc[k]) - float(mr[k]))
            / max(abs(float(mr[k])), 1e-30) for k in mr}
    for sub in ("ae", "disc3d", "disc2d"):
        pc = dict(getattr(card, sub).named_parameters())
        pr = dict(getattr(ref, sub).named_parameters())
        scale = max(float(p.grad.abs().max()) for p in pr.values())
        err = max(float((pc[n].grad.cpu() - p.grad).abs().max())
                  for n, p in pr.items())
        errs[f"grad.{sub}"] = err / scale if scale > 0 else err
    sc, sr = card.model.state_dict(), ref.model.state_dict()
    for k, t in sr.items():
        if "running" in k or ".quantizer." in k:
            errs[f"state.{k}"] = _max_rel(sc[k].float(), t.float())
    return errs


def _gan_compare(card_name: str, size: int = GAN_COMPARE_SIZE,
                 check: bool = False) -> dict:
    """A warm and an adversarial step of vqgan_attn (R1, adaptive weight)
    at `size` on the card (the codebook kernel, f32 without TF32) against
    a float64 twin on the CPU (the plain version), each from one state
    with the same injected draws. With `check`, a float32 CPU twin takes
    the same steps, both are reported against float64, and nothing is
    held to the tolerances."""
    cfg = get_preset("vqgan_attn")
    gan = replace(cfg.vqgan, disc_threshold=1, r1_gamma=1.0,
                  adaptive_g_weight=True)
    tc = replace(cfg.train, batch_size=GAN_BATCH, dtype=F32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the LPIPS surrogate
        ref = GANTrainer(gan, tc, device="cpu", volume_size=size) \
            .init_random(SEED, "reach")
    card = GANTrainer(gan, tc, device="cuda", volume_size=size)
    cpu32 = GANTrainer(gan, tc, device="cpu", volume_size=size)
    # the quantizer computes in float32 in both (its restart threshold,
    # usage >= 1, is met exactly by 0.99 + 0.01 in float32)
    ref.model.double()
    ref.ae.quantizer.float()
    rng = np.random.default_rng(SEED + 40)
    vol, mask = _vq_batch(rng, GAN_BATCH, size, "cpu")
    # "attn_cp": a k3 stem, then one k4-s2 conv per further width
    n_rows = GAN_BATCH * (size >> (len(cfg.vqgan.ae.num_channels) - 1)) ** 3
    lo, hi = gan.frame_idx_range
    hi = min(hi, size)
    lo = min(lo, hi - 1)
    out = {}
    for program in ("warm", "adversarial"):
        draws = _gan_draws(rng, n_rows, lo, hi)
        _gan_copy(ref, card)
        with _NoTF32():
            mc = card.train_step(vol.cuda(), mask.cuda(), Draws(**{
                k: list(v) for k, v in draws.items()}))
            torch.cuda.synchronize()
        _gan_copy(ref, cpu32)

        def cpu32_step():
            return cpu32.train_step(vol, mask, Draws(**{
                k: list(v) for k, v in draws.items()}))
        if check:
            m32 = cpu32_step()
        mr = ref.train_step(vol, mask, Draws(**draws))
        errs = _gan_step_errors(card, ref, mc, mr)
        if check:
            errs32 = _gan_step_errors(cpu32, ref, m32, mr)
            worst = {f"{side}_{g[:-1]}_max": max(
                (e for k, e in es.items() if k.startswith(g)), default=0.0)
                for side, es in (("card", errs), ("cpu_float32", errs32))
                for g in ("metric.", "grad.", "state.")}
            say("gan_compare_check", program=program, volume=size,
                batch=GAN_BATCH, reference="cpu float64", **worst,
                card_grad_rel_err={k: e for k, e in errs.items()
                                   if k.startswith("grad.")},
                cpu_float32_grad_rel_err={k: e for k, e in errs32.items()
                                          if k.startswith("grad.")},
                tol=dict(metric=GAN_METRIC_RTOL, grad=GAN_GRAD_RTOL,
                         state=GAN_STATS_RTOL), card=card_name)
            if program == "warm":
                ref.next_epoch()
                cpu32.next_epoch()
            out[program] = worst
            continue
        tol = {k: GAN_METRIC_RTOL if k.startswith("metric.") else
               GAN_GRAD_RTOL if k.startswith("grad.") else GAN_STATS_RTOL
               for k in errs}
        own = {}
        if any(k.startswith("metric.") and not errs[k] <= tol[k]
               for k in errs):
            # the float32 CPU step's own distance from float64
            errs32 = _gan_step_errors(cpu32, ref, cpu32_step(), mr)
            own = {k: e for k, e in errs32.items() if k.startswith("metric.")}
            tol.update({k: max(tol[k], GAN_F64_FACTOR * e)
                        for k, e in own.items()})
        bad = sorted(k for k in errs if not errs[k] <= tol[k])
        worst = {g: max((e for k, e in errs.items() if k.startswith(g)),
                        default=0.0)
                 for g in ("metric.", "grad.", "state.")}
        say("train_gan", step=f"compare_{program}", volume=size,
            batch=GAN_BATCH, reference="cpu float64", r1_gamma=gan.r1_gamma,
            adaptive_g_weight=True,
            metrics_cpu={k: float(v) for k, v in mr.items()},
            grad_rel_err={k: errs[k] for k in errs
                          if k.startswith("grad.")},
            max_metric_rel_err=worst["metric."],
            max_state_rel_err=worst["state."],
            cpu_float32_metric_rel_err=own or None,
            metric_tol={k: tol[k] for k in errs if k.startswith("metric.")
                        and tol[k] != GAN_METRIC_RTOL} or None,
            tol=dict(metric=GAN_METRIC_RTOL, grad=GAN_GRAD_RTOL,
                     state=GAN_STATS_RTOL), failed=bad, ok=not bad,
            card=card_name)
        if bad:
            raise RuntimeError(f"train_gan compare {program}: "
                               f"{[(k, errs[k]) for k in bad[:5]]}")
        if program == "warm":
            if float(mr["disc_loss"]) != 0.0:
                raise RuntimeError("train_gan: the warm step ran a critic")
            ref.next_epoch()
        out[program] = worst
    del card, ref
    torch.cuda.empty_cache()
    return out


def _gan_split(tr: GANTrainer, vol, mask) -> dict:
    """Where the R1 + adaptive step's extra time goes, on one warmed
    trainer (the adversarial program): its profile (kernels by kind, busy
    share); the step timed with R1 and the adaptive weight each on and
    off (R1 adds the critics' second-order pass, the adaptive weight two
    more backward passes, one through LPIPS's VGG16 and the decoder's
    output, one through both critics); and VGG16 alone on the step's
    frames, forward and forward + backward to its input."""
    full = tr.cfg
    step_ms = {}
    for name, over in (("r1_adaptive", {}),
                       ("r1_only", dict(adaptive_g_weight=False)),
                       ("adaptive_only", dict(r1_gamma=0.0)),
                       ("neither", dict(adaptive_g_weight=False,
                                        r1_gamma=0.0))):
        tr.cfg = replace(full, **over)
        timer = profiling.StepTimer(warmup=1)
        for _ in range(GAN_SPLIT_STEPS + 1):
            timer.time_step(tr.train_step, vol, mask, warm=False)
        step_ms[name] = 1e3 * timer.summary()["p50_s"]
    tr.cfg = full
    prof = profiling.profile_steps(
        lambda: tr.train_step(vol, mask, warm=False), 2,
        step_ms["r1_adaptive"])
    frames = vol[:, vol.shape[1] // 2].permute(0, 3, 1, 2).expand(
        -1, 3, -1, -1).contiguous()
    recon = (frames + 0.01).requires_grad_(True)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: tr.lpips(frames, recon), 3, warmup=1)
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        tr.lpips(frames, recon).mean(), recon), 3, warmup=1)
    base = step_ms["neither"]
    return dict(step_ms=step_ms, profile=prof,
                r1_ms=step_ms["r1_only"] - base,
                adaptive_ms=step_ms["adaptive_only"] - base,
                both_ms=step_ms["r1_adaptive"] - base,
                vgg16_frames=list(frames.shape),
                vgg16_forward_ms=fwd_ms, vgg16_forward_backward_ms=fwd_bwd_ms,
                vgg16_backward_ms=fwd_bwd_ms - fwd_ms)


def _gan_timings(cfg, size: int) -> dict:
    """Wall ms of GAN_TIMED_STEPS steps of each program at `size` (the
    warm one, the adversarial one, and with R1 and the adaptive weight),
    eval ms per batch, and the peak memory over them; the first step of
    each trainer (Adam's state, cuDNN's set-up) is not timed."""
    rng = np.random.default_rng(SEED + 41)
    vol, mask = _vq_batch(rng, cfg.train.batch_size, size, "cuda")
    out = {}
    torch.cuda.reset_peak_memory_stats()
    for name, over, warm in (
            ("warm", {}, True), ("adversarial", {}, False),
            ("adversarial_r1_adaptive", dict(r1_gamma=1.0,
                                             adaptive_g_weight=True),
             False)):
        gan = replace(cfg.vqgan, **over)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tr = GANTrainer(gan, cfg.train, device="cuda",
                            volume_size=size).init_random(SEED, "reach")
        tr.epoch = 0 if warm else gan.disc_threshold   # the critics on
        tr.train_step(vol, mask, warm=warm)
        walls = []
        for _ in range(GAN_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(vol, mask, warm=warm)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        out[name] = dict(step_ms=walls, median_step_ms=float(
            np.median(walls)), finite=all(np.isfinite(float(v))
                                          for v in m.values()))
        if name == "adversarial_r1_adaptive":
            tr.eval_step(vol, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.eval_step(vol, mask)
            torch.cuda.synchronize()
            out["eval_ms_per_batch"] = 1e3 * (time.perf_counter() - t0)
            out["r1_adaptive_split"] = _gan_split(tr, vol, mask)
        del tr
        torch.cuda.empty_cache()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if not all(v["finite"] for k, v in out.items()
               if isinstance(v, dict) and k != "r1_adaptive_split"):
        raise RuntimeError(f"train_gan timings: non-finite metrics {out}")
    return out


def phase_train_gan(card: str) -> dict:
    """Main path 7: the VQ-GAN. (a) A warm and an adversarial step of
    vqgan_attn at its full widths on the card against a float64 CPU twin
    (32^3, see GAN_COMPARE_SIZE). (b) In process, in a temporary
    directory removed at the end: --create_dataset --synthetic (6
    volumes, 128^3), --preset vqgan_attn --train_vq --disc_threshold 1
    --epochs 2 (epoch 1 warm, epoch 2 adversarial; 2 steps each and a
    validation batch), an exact-resume check, --test_vq. (c) One step
    of each other VQ-GAN preset (adversarial), of emavqvae and of
    vqvae_legacy (--vqvae_mode 1 and 2), at 128^3. The counters are
    zeroed before each user-facing piece of (b) and (c) and read after
    it: the codebook kernel launches once per step, eval batch and
    reconstruction, attention never. Then, uncounted, (d) the 128^3 step
    times and peak memory."""
    compare = _gan_compare(card)
    tmp = tempfile.mkdtemp(prefix="ldm3d_train_gan_")
    dev = CLI_DEVICE
    counts = {attn.KERNEL: 0, cbq.KERNEL: 0}

    def parse(flags, *extra):
        argv = flags + ["--cache_dir", os.path.join(tmp, "cache"),
                        "--ckpt_dir", os.path.join(tmp, "ckpt"),
                        "--out_dir", os.path.join(tmp, "out"),
                        "--val_perc", str(GAN_VAL),
                        "--platform", "gpu" if dev == "cuda" else "cpu",
                        *extra]
        args = cli.build_parser().parse_args(argv)
        return cli.apply_overrides(get_preset(args.preset), args), args

    try:
        cfg, args = parse(GAN_FLAGS, "--create_dataset", "--synthetic",
                          "--num_synthetic", str(GAN_VOLUMES))
        _counted(counts, cli.run_create_dataset, cfg, args)
        cfg, args = parse(GAN_FLAGS, "--train_vq", *GAN_CLI)
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            saver, train_s, got1 = _counted(counts, cli.run_train_vq, cfg,
                                            args)
        text = out.getvalue()
        print(text, end="", flush=True)
        peak = torch.cuda.max_memory_allocated()
        tr_idx, va_idx = train_val_split(GAN_VOLUMES, cfg.train.val_fraction,
                                         cfg.train.seed)
        steps = len(tr_idx) // cfg.train.batch_size
        val_batches = len(va_idx) // cfg.train.batch_size
        epochs = cfg.train.epochs
        expect1 = {attn.KERNEL: 0, cbq.KERNEL: epochs * (steps + val_batches)}
        ckpt_dir = os.path.join(tmp, "ckpt", f"{cfg.name}_vq")
        log = open(os.path.join(ckpt_dir, "training.log")).read()
        rows = [r.split(",") for r in log.splitlines()]
        col = rows[0].index("disc_loss")
        disc = [float(r[col]) for r in rows[1:]]
        ok = (got1 == expect1 and saver.step == epochs * steps
              and saver.epoch == epochs and len(disc) == epochs
              and disc[0] == 0.0 and disc[1] > 0.0
              and f"epoch {epochs}/{epochs}" in text)
        say("train_gan", step="train_vq", flags=GAN_FLAGS + GAN_CLI,
            volume=cfg.data.volume_size, batch=cfg.train.batch_size,
            steps_per_epoch=steps, val_batches=val_batches, run_s=train_s,
            disc_loss_by_epoch=disc, launches=got1, expected=expect1,
            checkpoint_bytes=os.path.getsize(os.path.join(ckpt_dir,
                                                          "1.pt")),
            max_memory_allocated=peak, lpips_pretrained=saver
            .lpips_pretrained, card=card)
        if not ok:
            raise RuntimeError(f"train_gan train_vq: launches {got1} "
                               f"(expected {expect1}), step {saver.step}, "
                               f"epoch {saver.epoch}, disc_loss {disc}")

        # resume is exact: the last epoch restored into a fresh trainer
        # equals the one that saved it, and both take the same step
        fresh = GANTrainer(cfg.vqgan, cfg.train, device=dev,
                           volume_size=cfg.data.volume_size)
        state, ep = CheckpointManager(ckpt_dir).restore(epochs)
        fresh.load_state_dict(state)
        del state
        differ = _state_equal(saver, fresh)
        rng = np.random.default_rng(SEED + 42)
        vol, mask = _vq_batch(rng, cfg.train.batch_size,
                              cfg.data.volume_size, dev)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            for tr in (saver, fresh):
                tr.train_step(vol, mask)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        after = _state_equal(saver, fresh)
        say("train_gan", step="resume_check", restored_epoch=ep,
            state_differs=differ, differs_after_one_step=after,
            bitwise=not differ and not after, card=card)
        if differ or after:
            raise RuntimeError(f"train_gan resume: state differs in "
                               f"{(differ + after)[:5]}")
        del fresh, saver
        torch.cuda.empty_cache()

        cfg, args = parse(GAN_FLAGS, "--test_vq")
        (paths, mse), test_s, got2 = _counted(counts, cli.run_test_vq, cfg,
                                              args)
        expect2 = {attn.KERNEL: 0, cbq.KERNEL: 2 * val_batches}
        recon = np.load(os.path.join(tmp, "out", "reconst_0.npy"))
        shapes_ok = recon.shape == (cfg.train.batch_size,) + (
            cfg.data.volume_size,) * 3 + (1,)
        finite = bool(np.isfinite(recon).all())
        say("train_gan", step="test_vq", mean_mse=mse, test_vq_s=test_s,
            shapes_ok=shapes_ok, finite=finite, launches=got2,
            expected=expect2, card=card)
        if not (shapes_ok and finite and got2 == expect2):
            raise RuntimeError(f"train_gan test_vq: shapes {shapes_ok}, "
                               f"finite {finite}, launches {got2}")

        others = {}
        rng = np.random.default_rng(SEED + 43)
        for preset, extra, adversarial in GAN_OTHERS:
            pcfg, _ = parse(["--preset", preset, "--dtype", F32], *extra)
            b = pcfg.train.batch_size if pcfg.model == "vqgan" else 2
            vol, mask = _vq_batch(rng, b, cfg.data.volume_size, dev)
            if pcfg.model == "vqgan":
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    tr = GANTrainer(pcfg.vqgan, pcfg.train, device=dev,
                                    volume_size=cfg.data.volume_size) \
                        .init_random(SEED, "reach")
                tr.epoch = pcfg.vqgan.disc_threshold
            else:
                tr = VQTrainer(pcfg.vqvae, replace(pcfg.train, batch_size=b),
                               device=dev).init_random(SEED, "reach")
            torch.cuda.reset_peak_memory_stats()
            m, wall, got = _counted(counts, tr.train_step, vol, mask)
            finite = all(np.isfinite(float(v)) for v in m.values())
            key = preset + "".join(extra).replace("--vqvae_mode", "_mode")
            others[key] = dict(
                batch=b, step_ms=1e3 * wall, launches=got, finite=finite,
                adversarial=adversarial and float(m["disc_loss"]) > 0.0,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                metrics={k: float(v) for k, v in m.items()})
            del tr
            torch.cuda.empty_cache()
            want = {attn.KERNEL: 0, cbq.KERNEL: 1}
            if got != want or not finite or (
                    adversarial and not others[key]["adversarial"]):
                raise RuntimeError(f"train_gan {key}: launches {got}, "
                                   f"finite {finite}")
        say("train_gan", step="other_presets", volume=cfg.data.volume_size,
            **others, card=card)

        timings = _gan_timings(cfg, cfg.data.volume_size)
        say("train_gan", step="timings", volume=cfg.data.volume_size,
            batch=cfg.train.batch_size, **timings, card=card)
        if counts[cbq.KERNEL] <= 0 or counts[attn.KERNEL] != 0:
            raise RuntimeError(f"train_gan: launches {counts}")
        say("train_gan", launches=counts, compare=compare, card=card)
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal digests on two
    processes mean bitwise equal tensors."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def _launches() -> Dict[str, int]:
    return {attn.KERNEL: attn.launches, cbq.KERNEL: cbq.launches}


def _reset_launches() -> None:
    attn.reset_launches()
    cbq.reset_launches()


def _grad_dict(model) -> Dict[str, torch.Tensor]:
    """{name: gradient} of a module's parameters (a dict passes as it
    is: the whole gradients of a tensor-parallel module)."""
    if isinstance(model, dict):
        return model
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


def _grad_errors(model, ref_model, tols) -> dict:
    """Each parameter's gradient against the reference's (a module or a
    `_grad_dict`): max |a - b| over the larger of the reference tensor's
    largest |b| and DDP_GRAD_FLOOR of the model's largest (a conv bias
    before BatchNorm has an exact gradient of 0 and float32 noise on both
    sides). `tols` is a sequence of (name pattern, bound): a tensor takes
    the bound of the first pattern its name matches (None matches every
    name), and each group's worst tensor is reported beside its bound."""
    ref = _grad_dict(ref_model)
    top = max(float(g.abs().max()) for g in ref.values())
    groups = [dict(tensors=pat or "rest", tol=tol, rel_err=0.0, worst=None,
                   count=0) for pat, tol in tols]
    errs, rows = {}, []
    for n, grad in _grad_dict(model).items():
        b = ref[n].double()
        own = float(b.abs().max())
        err = float((grad.double().to(b.device) - b).abs().max())
        errs[n] = err / max(own, DDP_GRAD_FLOOR * top)
        rows.append((errs[n], n, err, own))
        g = next(g for g, (pat, _) in zip(groups, tols)
                 if pat is None or re.search(pat, n))
        g["count"] += 1
        if g["worst"] is None or errs[n] > g["rel_err"]:
            g["rel_err"], g["worst"] = errs[n], n
    worst = max(errs, key=errs.get)
    return dict(grad_rel_err=errs[worst], grad_worst=worst,
                grad_groups=groups,
                grad_ok=all(g["rel_err"] <= g["tol"] for g in groups),
                grads_compared=len(errs), grad_top=top,
                grad_model_rel_err=max(r[2] for r in rows) / top,
                grad_worst5=[dict(name=n, rel=r, abs_err=e, tensor_max=o)
                             for r, n, e, o in sorted(rows)[-5:]],
                grad_rel_errs=errs)


def _stats_error(model, ref_model) -> float:
    """The BatchNorm running statistics against the reference's, relative
    to each tensor's largest value."""
    ref = dict(ref_model.named_buffers())
    return max([float((b.double() - ref[n].double()).abs().max())
                / max(float(ref[n].abs().max()), 1e-30)
                for n, b in model.named_buffers() if "running" in n],
               default=0.0)


def _float64_attention_fn(q, k, v, scale=None):
    """The plain attention in its inputs' type (float64 on the card for
    the reference step; the kernel takes float32 and bfloat16)."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    return torch.softmax(q @ k.transpose(1, 2) * scale, dim=-1) @ v


@contextlib.contextmanager
def _float64_attention():
    """The U-Net's attention as `_float64_attention_fn` inside the block
    (the float64 reference step; no kernel launches)."""
    real = unet3d.voxel_attention
    unet3d.voxel_attention = _float64_attention_fn
    try:
        yield
    finally:
        unet3d.voxel_attention = real


@contextlib.contextmanager
def _recorded_codes():
    """The codes each search of a quantizer returns inside the block, in
    call order (the one-process float32 stage-1 step's, for its float64
    twin)."""
    real, codes = quantizers.nearest_codebook_indices, []

    def record(x, codebook):
        codes.append(real(x, codebook))
        return codes[-1]
    quantizers.nearest_codebook_indices = record
    try:
        yield codes
    finally:
        quantizers.nearest_codebook_indices = real


def _float64_codes(x: torch.Tensor, codebook: torch.Tensor
                   ) -> torch.Tensor:
    """The plain search in float64: argmin_k ||x_n - c_k||^2 (any device,
    no kernel)."""
    x, codebook = x.detach().double(), codebook.detach().double()
    scores = codebook.square().sum(-1)[None, :] - 2.0 * x @ codebook.T
    return torch.argmin(scores, dim=-1).to(torch.int32)


@contextlib.contextmanager
def _injected_codes(codes):
    """The float64 stage-1 twin's code search inside the block: each
    search returns the next of `codes` (the float32 step's, in call
    order) and launches nothing; the list it yields gets, per search, the
    rows where the plain float64 search of the same rows
    (`_float64_codes`) picks another code."""
    real, todo, changed = quantizers.nearest_codebook_indices, \
        list(codes), []

    def inject(x, codebook):
        idx = todo.pop(0).to(x.device)
        changed.append(int((_float64_codes(x, codebook) != idx).sum()))
        return idx
    quantizers.nearest_codebook_indices = inject
    try:
        yield changed
    finally:
        quantizers.nearest_codebook_indices = real
    if todo:
        raise RuntimeError(f"float64 stage-1 twin: {len(todo)} recorded "
                           "code searches not replayed")


def _float64_s1_twin(inp: dict, dev: str) -> VQTrainer:
    """A twin of `_ddp_s1_one_process` on `dev` whose model (weights,
    buffers), Adam state and gradients are float64, from the same init
    and generator; the volumes are widened where they enter. The
    reconstruction loss is formed from the reconstruction rounded to
    float32 (`VQTrainer._losses`), which rounds only the upstream
    gradient's first factor, to 1e-7, and the codebook's gradient (a
    float32 one-hot sum, `segment_sum`) to 6e-8. Its step runs inside
    `_injected_codes` (the codebook kernel takes float32 and bfloat16)."""
    twin = VQTrainer(inp["vcfg"], inp["tc"], device=dev).init_random(SEED)
    twin.model.double()
    twin._batch = lambda v, m: (v.to(dev, torch.float64),
                                m.to(dev, torch.float64))
    return twin


def _s1_gate_fields(ref: dict) -> dict:
    """The stage-1 line's gate fields from rank 0's numbers: the float64
    gate (it decides), the float64 step's seconds and the rows whose code
    its own search would change, and the sharded step against the
    one-process twin (printed, not judged)."""
    return dict(grad_gate=ref["gate"], float64_step_s=ref["float64_step_s"],
                float64_codes_changed=ref["float64_codes_changed"],
                code_rows=ref["code_rows"], seed=SEED,
                vs_one_process=ref["vs_one_process"],
                grad_floor=DDP_GRAD_FLOOR,
                usage_equal_to_one_process=ref["usage_equal_1p"])


def _s1_references(spec: dict, inp: dict, sharded, usage: torch.Tensor,
                   tols) -> dict:
    """On process 0: the one-process float32 stage-1 step of a twin (TF32
    off, cuDNN as set; its codes recorded) and the float64 step on the
    card of the same init and volumes with those codes; the float64 gate
    of `sharded` (the sharded trainer's model or its whole gradients),
    the old comparison with the one-process twin (printed, not judged),
    the twin's loss, peak device memory and state bytes, and whether its
    codebook usage equals `usage`, the sharded step's. With a dict
    spec["float64_steps"] the float64 step is kept there and taken once
    for a batch and its codes (the mesh phase's remat-off step reuses the
    remat-full one's: the same arithmetic)."""
    dev = spec["device"]
    twin, m1 = _ddp_s1_one_process(spec, inp), []
    with _NoTF32(), _recorded_codes() as codes:
        peak = _peak_step(dev, lambda: m1.append(twin.train_step(
            inp["vol"].to(dev), inp["mask"].to(dev))))
    cache = spec.get("float64_steps", {})
    key = (SEED, spec["vq_size"], len(inp["vol"]))
    cached = cache.get(key)
    if cached is not None and len(cached[0]) == len(codes) and all(
            torch.equal(a.cpu(), b) for a, b in zip(codes, cached[0])):
        # this process's float64 step of the same volumes and codes,
        # taken at another remat setting (the same arithmetic)
        _, f64_grads, f64_s, changed = cached
    else:
        f64 = _float64_s1_twin(inp, dev)
        t0 = time.perf_counter()
        with _injected_codes(codes) as changed:
            f64.train_step(inp["vol"], inp["mask"])
            _sync(dev)
        f64_s = time.perf_counter() - t0
        f64_grads = {n: g.cpu() for n, g in _grad_dict(f64.model).items()}
        del f64
        cache[key] = ([c.cpu() for c in codes], f64_grads, f64_s, changed)
    one = _grad_errors(sharded, twin.model, tols)
    out = dict(gate=_f64_gate(sharded, twin.model, f64_grads, tols),
               float64_step_s=f64_s, float64_codes_changed=sum(changed),
               code_rows=sum(int(c.numel()) for c in codes),
               vs_one_process={k: one[k] for k in (
                   "grad_rel_err", "grad_worst", "grad_model_rel_err",
                   "grad_worst5")},
               loss_1p=float(m1[0]["loss"]), twin_peak_bytes=peak,
               state_bytes_1p=_state_bytes(twin.model.parameters(),
                                           twin.optimizer),
               usage_equal_1p=bool(torch.equal(
                   usage.cpu(), twin.model.quantizer.codebooks_used.cpu())))
    del twin
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _s1_sharded_step(spec: dict, rank: int, mesh, kind: str,
                     batch: int = SPATIAL_VQ_BATCH, remat=None) -> tuple:
    """The flagship's stage-1 (TRAIN_VQ_FLAGS, remat as the preset has it
    unless `remat` is given) at global batch `batch` of TRAIN_VQ_SIZE^3
    volumes over `mesh`, counted: over a "spatial" mesh each rank its
    depth slab, over a "tp" one every row with the wide kernels split,
    over a "mesh" one (any axes) its rows and depth slab (TF32 off, cuDNN
    deterministic as the worker sets it); then on rank 0 its float64 gate
    (`_s1_references`, the bounds `tols` of TP_S1_GRAD_RTOL over a "tp"
    mesh, SPATIAL_S1_GRAD_RTOL otherwise). Returns (this process's
    numbers, its trainer, the inputs, its batch)."""
    from ldm3d_torch.parallel.mesh import shard_batch

    dev = spec["device"]
    tols = TP_S1_GRAD_RTOL if kind == "tp" else SPATIAL_S1_GRAD_RTOL
    inp = _ddp_s1_inputs(spec, batch)
    if remat is not None:
        inp["vcfg"] = replace(inp["vcfg"], remat=remat)
    tr = VQTrainer(inp["vcfg"], inp["tc"], device=dev,
                   mesh=mesh).init_random(SEED)
    batch = (inp["vol"], inp["mask"])
    if kind != "tp":
        batch = shard_batch(mesh, batch, spatial_axis=3)
    v, mk = (t.to(dev) for t in batch)
    m, out = _tp_counted(dev, lambda: tr.train_step(v, mk))
    q = tr.model.quantizer
    out.update(loss=float(m["loss"]), perplexity=float(m["perplexity"]),
               remat=inp["vcfg"].remat, usage=_digest([q.codebooks_used]),
               codebook=_digest([q.codebook]))
    grads = _whole_grads(kind, mesh)(tr.model)
    if rank == 0:
        ref = _s1_references(spec, inp, grads, q.codebooks_used, tols)
        out.update(ref, loss_rel_err=abs(out["loss"] - ref["loss_1p"])
                   / abs(ref["loss_1p"]))
    del grads
    pdist.barrier()
    return out, tr, inp, (v, mk)


def _f64_gate(sharded, one, f64, tols) -> dict:
    """The float64 gate (see F64_FACTOR): the sharded step's gradients
    (a module or a `_grad_dict`) and the one-process step's, each against
    the float64 step's; per group and for the whole model, both
    distances, the limit and the verdict."""
    es, e1 = _grad_errors(sharded, f64, tols), _grad_errors(one, f64, tols)
    groups = []
    for gs, g1 in zip(es["grad_groups"], e1["grad_groups"]):
        limit = max(gs["tol"], F64_FACTOR * g1["rel_err"])
        groups.append(dict(tensors=gs["tensors"], sharded=gs["rel_err"],
                           one_process=g1["rel_err"], worst=gs["worst"],
                           bound=gs["tol"], limit=limit,
                           ok=gs["rel_err"] <= limit))
    model_limit = max(DDP_MODEL_GRAD_RTOL,
                      F64_FACTOR * e1["grad_model_rel_err"])
    model = dict(sharded=es["grad_model_rel_err"],
                 one_process=e1["grad_model_rel_err"],
                 bound=DDP_MODEL_GRAD_RTOL, limit=model_limit,
                 ok=es["grad_model_rel_err"] <= model_limit)
    return dict(reference="float64 step on the card", factor=F64_FACTOR,
                groups=groups, model=model,
                sharded_worst5=es["grad_worst5"],
                ok=model["ok"] and all(g["ok"] for g in groups))


def _ddp_s2_inputs(spec: dict) -> dict:
    """The stage-2 step's config, global batch and injected draws (made
    alike on every process from SEED)."""
    cfg, b = flagship_cfg(tiny=spec["tiny"]), DDP_BATCH
    rng = np.random.default_rng(SEED + 7)
    shape = (b,) + (cfg.latent_size,) * 3 + (cfg.latent_channels,)
    lat = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ctx = torch.from_numpy(rng.integers(0, cfg.unet.context_dim + 1, b))
    draws = dict(t=torch.from_numpy(rng.integers(0, cfg.timesteps, b)),
                 noise=torch.from_numpy(
                     rng.standard_normal(shape).astype(np.float32)),
                 drop=torch.from_numpy(rng.random(b)
                                       < cfg.unet.cfg_dropout))
    return dict(cfg=cfg, lat=lat, ctx=ctx, draws=draws,
                on={k: v.to(spec["device"]) for k, v in draws.items()},
                tc=TrainConfig(batch_size=b, ema_decay=0.999, seed=SEED,
                               dtype=F32))


def _ddp_s2_one_process(spec: dict, inp: dict) -> DiffusionTrainer:
    """A one-process twin of the stage-2 trainer, from the same init."""
    return DiffusionTrainer(inp["cfg"], device=spec["device"],
                            train_cfg=inp["tc"]).init_random(SEED, "reach")


def _ddp_s2_step(tr: DiffusionTrainer, inp: dict, dev: str) -> dict:
    """The one-process step on the whole global batch (TF32 off)."""
    with _NoTF32():
        m = tr.train_step_latents(inp["lat"].to(dev), inp["ctx"].to(dev),
                                  **inp["on"])
        _sync(dev)
    return m


def _s2_references(spec: dict, inp: dict, sharded, others=None) -> dict:
    """On process 0: the one-process float32 step of a twin (TF32 off,
    cuDNN as set) and the float64 step on the card, from the same init
    and draws; the gate of `sharded` (the sharded trainer's U-Net or its
    whole gradients), and of each of `others` ({name: whole gradients of
    another sharded step of the same inputs}) under "others", and the
    one-process step's loss and BatchNorm statistics, and the process's
    peak device memory in the twin's step. Returns the numbers and the
    twin."""
    dev = spec["device"]
    twin = _ddp_s2_one_process(spec, inp)
    held = _allocated(dev)
    f64 = _float64_twin(twin, DDP_BATCH, dev)    # of the twin's init
    held = _allocated(dev) - held
    m1 = []
    # the twin's peak: the float64 twin's bytes, alive through it, apart
    peak = _peak_step(dev, lambda: m1.append(
        _ddp_s2_step(twin, inp, dev))) - held
    m1 = m1[0]
    t0 = time.perf_counter()
    with _float64_attention():
        f64.train_step_latents(inp["lat"].to(dev), inp["ctx"].to(dev),
                               **inp["on"])
        _sync(dev)
    out = dict(gate=_f64_gate(sharded, twin.model.unet, f64.model.unet,
                             spec["s2_tols"]),
               float64_step_s=time.perf_counter() - t0,
               loss_1p=float(m1["loss"]), peak_bytes_1p=peak)
    if others:
        out["others"] = {name: _f64_gate(g, twin.model.unet, f64.model.unet,
                                         spec["s2_tols"])
                         for name, g in others.items()}
    del f64
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out, twin


def _ddp_stage2(spec: dict, rank: int) -> tuple:
    """The flagship's latent step at global batch DDP_BATCH over the
    mesh, each rank its rows, the draws the global batch's (injected);
    rank 0 then takes the one-process step on a twin. TF32 off for both
    (the comparison measures the data-parallel step, not TF32), cuDNN
    deterministic as the worker sets it. Returns this process's numbers,
    its trainer (the counted step's gradients) and the inputs."""
    from ldm3d_torch.parallel.mesh import shard_batch

    dev, inp = spec["device"], _ddp_s2_inputs(spec)
    mesh = _ddp_mesh()
    tr = DiffusionTrainer(inp["cfg"], device=dev, train_cfg=inp["tc"],
                          mesh=mesh).init_random(SEED, "reach")
    inp["mesh"] = mesh
    inp["x"], inp["c"] = (t.to(dev) for t in shard_batch(
        mesh, (inp["lat"], inp["ctx"])))
    with _NoTF32():
        _sync(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _reset_launches()        # the main path's step starts here
        t0 = time.perf_counter()
        m = tr.train_step_latents(inp["x"], inp["c"], **inp["on"])
        _sync(dev)
        first_ms = 1e3 * (time.perf_counter() - t0)
        got = _launches()
    out = dict(loss=float(m["loss"]), noise_mse=float(m["noise_mse"]),
               launches=got, first_step_ms=first_ms,
               attention_calls=attention_calls_per_step(tr.model.unet),
               params=_digest(tr.model.unet.parameters()),
               buffers=_digest(tr.model.unet.buffers()),
               ema=_digest(tr.ema_unet.parameters()))
    if rank == 0:
        ref, twin = _s2_references(dict(spec, s2_tols=DDP_S2_GRAD_RTOL),
                                   inp, tr.model.unet)
        out.update(ref, loss_rel_err=abs(out["loss"] - ref["loss_1p"])
                   / abs(ref["loss_1p"]),
                   stats_rel_err=_stats_error(tr.model.unet,
                                              twin.model.unet))
        del twin
    pdist.barrier()
    return out, tr, inp


def _ddp_stage2_timing(spec: dict, tr: DiffusionTrainer, inp: dict,
                       out: dict) -> None:
    """Uncounted: a second step with the defaults (TF32 convolutions,
    cuDNN's own choice of algorithms), and the gradients' all-reduce."""
    from ldm3d_torch.parallel.mesh import data_group

    dev = spec["device"]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    _sync(dev)
    t0 = time.perf_counter()
    tr.train_step_latents(inp["x"], inp["c"], **inp["on"])
    _sync(dev)
    out["step_ms"] = 1e3 * (time.perf_counter() - t0)
    torch.backends.cudnn.deterministic = det
    t0 = time.perf_counter()
    pdist.reduce_gradients(tr.model.unet.parameters(),
                           data_group(inp["mesh"]))
    _sync(dev)
    out["grad_allreduce_ms"] = 1e3 * (time.perf_counter() - t0)
    out["grad_bytes"] = sum(p.numel() * p.element_size()
                            for p in tr.model.unet.parameters())
    if dev == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()


def _ddp_s1_inputs(spec: dict, batch: int = DDP_VQ_BATCH) -> dict:
    """The stage-1 step's config and global batch (made alike on every
    process from SEED)."""
    args = cli.build_parser().parse_args(spec["vq_flags"])
    rng = np.random.default_rng(SEED + 8)
    vol = _seeded_volumes(rng, batch, spec["vq_size"])
    return dict(vcfg=cli.apply_overrides(get_preset(args.preset),
                                         args).vqvae,
                tc=TrainConfig(batch_size=batch, seed=SEED, dtype=F32),
                vol=vol, mask=(vol > 0.5).float())


def _ddp_s1_one_process(spec: dict, inp: dict) -> VQTrainer:
    """A one-process twin of the stage-1 trainer, from the same init."""
    return VQTrainer(inp["vcfg"], inp["tc"],
                     device=spec["device"]).init_random(SEED)


def _ddp_s1_step(tr: VQTrainer, inp: dict, dev: str) -> dict:
    """The one-process step on the whole global batch (TF32 off)."""
    with _NoTF32():
        m = tr.train_step(inp["vol"].to(dev), inp["mask"].to(dev))
        _sync(dev)
    return m


def _ddp_stage1(spec: dict, rank: int) -> tuple:
    """The flagship's stage-1 (remat full) at global batch DDP_VQ_BATCH of
    TRAIN_VQ_SIZE^3 volumes over the mesh; rank 0 then takes the
    one-process step on a twin (TF32 off for both, cuDNN deterministic
    as the worker sets it). Returns this process's numbers, its trainer
    and the inputs."""
    from ldm3d_torch.parallel.mesh import make_mesh, shard_batch

    dev, inp = spec["device"], _ddp_s1_inputs(spec)
    mesh = make_mesh(cfg=None, batch_size=DDP_VQ_BATCH)
    tr = VQTrainer(inp["vcfg"], inp["tc"], device=dev,
                   mesh=mesh).init_random(SEED)
    lv, lm = (t.to(dev) for t in shard_batch(mesh, (inp["vol"],
                                                    inp["mask"])))
    with _NoTF32():
        _sync(dev)
        _reset_launches()        # the main path's step starts here
        t0 = time.perf_counter()
        m = tr.train_step(lv, lm)
        _sync(dev)
        step_ms = 1e3 * (time.perf_counter() - t0)
        got = _launches()
    q = tr.model.quantizer
    out = dict(loss=float(m["loss"]), perplexity=float(m["perplexity"]),
               launches=got, step_ms=step_ms, remat=inp["vcfg"].remat,
               remat_policy=inp["vcfg"].remat_policy,
               usage=_digest([q.codebooks_used]),
               codebook=_digest([q.codebook]),
               params=_digest(tr.model.parameters()))
    if rank == 0:
        twin = _ddp_s1_one_process(spec, inp)
        m1 = _ddp_s1_step(twin, inp, dev)
        out.update(_grad_errors(tr.model, twin.model, DDP_S1_GRAD_RTOL),
                   loss_1p=float(m1["loss"]),
                   loss_rel_err=abs(float(m["loss"]) - float(m1["loss"]))
                   / abs(float(m1["loss"])),
                   usage_equal_1p=bool(torch.equal(
                       q.codebooks_used, twin.model.quantizer.codebooks_used)))
        del twin
    pdist.barrier()
    return out, tr, inp


def _ddp_check_extras(spec: dict, rank: int, stage: str, tr,
                      inp: dict) -> dict:
    """--ddp-check only, on process 0: the one-process step twice (the
    second against the first), and in stage 2 with cuDNN deterministic
    the data-parallel and the one-process steps against a float64 CPU
    step."""
    dev, out = spec["device"], {}
    if rank == 0:
        if stage == "stage2":
            one = partial(_ddp_s2_one_process, spec, inp)
            step, tols = _ddp_s2_step, DDP_S2_GRAD_RTOL

            def model(t):
                return t.model.unet
        else:
            one = partial(_ddp_s1_one_process, spec, inp)
            step, tols = _ddp_s1_step, DDP_S1_GRAD_RTOL

            def model(t):
                return t.model
        first = one()
        f64 = _float64_twin(first, DDP_BATCH) if stage == "stage2" \
            and torch.backends.cudnn.deterministic else None
        step(first, inp, dev)
        again = one()
        step(again, inp, dev)
        out["one_process_again"] = _grad_errors(model(again), model(first),
                                                tols)
        del again
        if f64 is not None:
            f64.train_step_latents(inp["lat"], inp["ctx"], **inp["draws"])
            out["dp_vs_float64"] = _grad_errors(model(tr), model(f64), tols)
            out["one_process_vs_float64"] = _grad_errors(
                model(first), model(f64), tols)
    pdist.barrier()
    return out


def _ddp_cli(spec: dict, rank: int) -> dict:
    """--train_dm --cache_latents over the processes from the command line
    (each process calls the CLI's main with --coordinator): one epoch,
    then --resume_ckpt -1 to a second; counted per run."""
    tmp, dev = spec["tmp"], spec["device"]
    argv = spec["cli_flags"] + [
        "--cache_dir", os.path.join(tmp, "cache"), "--ckpt_dir",
        os.path.join(tmp, "ckpt"), "--out_dir", os.path.join(tmp, "out"),
        "--platform", "gpu" if dev == "cuda" else "cpu", "--train_dm",
        "--cache_latents", "--synthetic", "--num_synthetic",
        str(spec["cli_volumes"]), "--lbs", str(DDP_CLI_LBS),
        "--num_processes", str(DDP_PROCESSES), "--process_id", str(rank)]
    out = {}
    for run, (port, extra) in enumerate(zip(
            spec["cli_ports"], (["--epochs", "1"],
                                ["--epochs", "2", "--resume_ckpt", "-1"]))):
        _sync(dev)
        _reset_launches()        # a run of the main path starts here
        t0 = time.perf_counter()
        cli.main(argv + ["--coordinator", f"127.0.0.1:{port}"] + extra)
        _sync(dev)
        out[f"run{run + 1}"] = dict(wall_s=time.perf_counter() - t0,
                                    launches=_launches())
    return out


def _ddp_mesh():
    """The data 2 mesh of the ddp phase's stage-2 steps."""
    from ldm3d_torch.parallel.mesh import make_mesh
    return make_mesh(cfg=None, batch_size=DDP_BATCH)


def _ddp_main_path(spec: dict, rank: int) -> dict:
    """The ddp phase's steps (cuDNN deterministic): stage 1, stage 2 and
    its timing, then (g), stage 2 in bfloat16. Stage 1 goes first: a
    process's first training step pays for loading what every later one
    uses, 12 s when it is the latent step and 1-4 s when it is stage 1
    (PERF.md §6)."""
    torch.backends.cudnn.deterministic = True
    s1 = _ddp_stage1(spec, rank)[0]
    torch.cuda.empty_cache()
    s2, tr, inp = _ddp_stage2(spec, rank)
    _ddp_stage2_timing(spec, tr, inp, s2)
    del tr, inp
    torch.cuda.empty_cache()
    bf = _s2_bf16(spec, rank, _ddp_mesh(), _whole_grads("ddp", None))
    torch.backends.cudnn.deterministic = False
    return dict(stage2=s2, stage1=s1, stage2_bf16=bf)


def _ddp_check(spec: dict, rank: int) -> dict:
    """--ddp-check's steps: with cuDNN's default algorithms, then
    deterministic, each step followed by its extras; nothing judged."""
    out = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        key = "_deterministic" if det else ""
        for stage, run in (("stage2", _ddp_stage2), ("stage1", _ddp_stage1)):
            res, tr, inp = run(spec, rank)
            res.update(_ddp_check_extras(spec, rank, stage, tr, inp))
            out[stage + key] = res
            del tr, inp
            torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


def ddp_worker(spec_path: str, rank: str) -> None:
    """One process of the ddp phase: joins the others, runs stage 1,
    stage 2, (g) and the command line (with --ddp-check: the check's steps
    alone), and writes its numbers as JSON."""
    global SEED
    with open(spec_path) as f:
        spec = json.load(f)
    rank, SEED = int(rank), spec["seed"]
    if spec["device"] == "cuda":
        _build.load_all([attn.KERNEL, cbq.KERNEL])   # built by the parent
    out = {}
    pdist.initialize(f"127.0.0.1:{spec['ports'][0]}", DDP_PROCESSES, rank,
                     platform="gpu" if spec["device"] == "cuda" else "cpu")
    try:
        out["backend"] = pdist.collective_backend()
        out["device"] = str(pdist.process_device())
        steps = _ddp_check if spec["check"] else _ddp_main_path
        out.update(steps(spec, rank))
    finally:
        pdist.shutdown()
    if not spec["check"]:
        out["cli"] = _ddp_cli(spec, rank)
        if spec["device"] == "cuda":   # since the stage-2 step, CLI included
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    with open(os.path.join(spec["tmp"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_ddp(card: str, cli_row: dict, check: bool = False) -> dict:
    """Main path 8: data parallelism. Two processes of this script on the
    one card, joined over gloo on localhost ports: the flagship's latent
    step at global batch 8 (4 rows each) and its stage-1 at 128^3, global
    batch 4, each against the one-process step of a twin on process 0;
    (g), the latent step in bfloat16, against a one-process bfloat16 step;
    then --train_dm --cache_latents from the command line in both, one
    epoch and a resume to a second, against the cli phase's one-process
    epoch. Each process zeroes its launch counters before each run of the
    main path and reads them after; the phase adds both processes'. With
    `check` (--ddp-check) only the two steps run, with cuDNN's default
    algorithms and then deterministic, each one-process step also
    against itself, and the numbers are printed, not judged."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ldm3d_ddp_")
    torch.cuda.empty_cache()
    ports = []
    while len(ports) < 3:    # three distinct ports
        port = pdist.free_port()
        ports += [] if port in ports else [port]
    cli_cfg = cli.apply_overrides(get_preset(CLI_FLAGSHIP[1]),
                                  cli.build_parser().parse_args(CLI_FLAGSHIP))
    spec = dict(device=DDP_DEVICE, tiny=DDP_TINY, check=check, tmp=tmp,
                ports=ports[:1],
                cli_ports=ports[1:], cli_flags=CLI_FLAGSHIP,
                cli_volumes=CLI_VOLUMES, vq_flags=TRAIN_VQ_FLAGS,
                vq_size=TRAIN_VQ_SIZE, seed=SEED)
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    try:
        free = shutil.disk_usage(tmp).free
        need = 2 * _checkpoint_bytes(cli_cfg) + 2 * 2 ** 30
        if DDP_DEVICE == "cuda" and free < need:
            raise RuntimeError(f"ddp: {free} bytes free in {tmp}, {need} "
                               "needed")
        ranks = _run_workers("ddp", path, tmp, DDP_PROCESSES, DDP_TIMEOUT)
        if check:
            for key, res in ranks[0].items():
                say("ddp_check", part=key, result=res, card=card)
            return {}
        with open(os.path.join(tmp, "rank0.log")) as f:
            rank0_text = f.read()
        return _ddp_report(card, ranks, rank0_text, cli_row, cli_cfg, tmp,
                           time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run_workers(phase: str, spec_path: str, tmp: str, n: int,
                 timeout: float) -> list:
    """`n` processes of this script (`--{phase}-worker spec_path rank`),
    each writing its output to rank{r}.log and its numbers to rank{r}.json
    in `tmp`; killed past `timeout` seconds. Returns the numbers in rank
    order; raises (printing the logs) when a worker fails."""
    return _wait_workers(_start_workers(phase, spec_path, tmp, n, timeout))


def _start_workers(phase: str, spec_path: str, tmp: str, n: int,
                   timeout: float) -> tuple:
    """`_run_workers`' processes, started; `_wait_workers` waits for
    them."""
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--{phase}-worker",
         spec_path, str(r)], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(n)]
    return phase, tmp, n, timeout, procs, logs, time.monotonic() + timeout


def _wait_workers(started: tuple) -> list:
    """The numbers of `_start_workers`' processes in rank order, once all
    have ended (killed past their deadline); raises (printing the logs)
    when one failed."""
    phase, tmp, n, timeout, procs, logs, deadline = started
    try:
        for p in procs:   # past the deadline: killed, exit code < 0
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        print(f"{phase}: the workers outlived {timeout} s", flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                print(f"--- {phase} rank {r} (exit {procs[r].returncode})\n"
                      + f.read()[-6000:], flush=True)
        raise RuntimeError(f"{phase}: workers exited "
                           f"{[p.returncode for p in procs]}")
    ranks = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def _ddp_report(card, ranks, rank0_text, cli_row, cli_cfg, tmp,
                wall_s) -> dict:
    """The ddp phase's checks and lines; returns both processes' launch
    counts."""
    s2 = [r["stage2"] for r in ranks]
    s1 = [r["stage1"] for r in ranks]
    calls = s2[0]["attention_calls"]
    on_card = DDP_DEVICE == "cuda"
    # per process: stage 2 one step, stage 1 one step; the CLI encodes its
    # rows of the split's global batches and takes one step per batch, in
    # each of its two runs
    tr_idx, _ = train_val_split(CLI_VOLUMES, cli_cfg.train.val_fraction,
                                cli_cfg.train.seed)
    batches = len(tr_idx) // (DDP_CLI_LBS * DDP_PROCESSES)
    want = {"stage2": {attn.KERNEL: calls, cbq.KERNEL: 0},
            "stage1": {attn.KERNEL: 0, cbq.KERNEL: 1},
            "cli": {attn.KERNEL: calls * batches, cbq.KERNEL: batches}}
    if not on_card:   # the plain versions run on the CPU: no launches
        want = {k: {attn.KERNEL: 0, cbq.KERNEL: 0} for k in want}
    got = {"stage2": [r["stage2"]["launches"] for r in ranks],
           "stage1": [r["stage1"]["launches"] for r in ranks],
           "cli": [r["cli"][run]["launches"] for r in ranks
                   for run in ("run1", "run2")]}
    launches_ok = all(g == want[k] for k, gs in got.items() for g in gs)
    backend = sorted({r["backend"] for r in ranks})
    s2_equal = all(s2[0][k] == s2[1][k] for k in ("params", "buffers", "ema",
                                                  "loss", "noise_mse"))
    s2_ok = (s2_equal and s2[0]["loss_rel_err"] <= DDP_LOSS_RTOL
             and s2[0]["gate"]["ok"]
             and s2[0]["stats_rel_err"] <= DDP_LOSS_RTOL)
    step_ms = max(r["step_ms"] for r in s2)
    ar_ms = max(r["grad_allreduce_ms"] for r in s2)
    say("ddp", step="stage2", processes=DDP_PROCESSES, backend=backend,
        devices=[r["device"] for r in ranks], batch=DDP_BATCH,
        rows_per_process=DDP_BATCH // DDP_PROCESSES,
        loss=s2[0]["loss"], loss_1p=s2[0]["loss_1p"],
        loss_rel_err=s2[0]["loss_rel_err"], loss_tol=DDP_LOSS_RTOL,
        grad_gate=s2[0]["gate"], grad_floor=DDP_GRAD_FLOOR,
        float64_step_s=s2[0]["float64_step_s"], seed=SEED,
        stats_rel_err=s2[0]["stats_rel_err"], stats_tol=DDP_LOSS_RTOL,
        ranks_bitwise_equal=s2_equal, first_step_ms=s2[0]["first_step_ms"],
        step_ms=step_ms, grad_allreduce_ms=ar_ms,
        grad_allreduce_share=ar_ms / step_ms,
        grad_bytes=s2[0]["grad_bytes"],
        max_memory_allocated=[r.get("max_memory_allocated") for r in s2],
        max_memory_allocated_with_cli=[r.get("max_memory_allocated")
                                       for r in ranks],
        launches=got["stage2"], expected=want["stage2"], card=card)
    s1_equal = all(s1[0][k] == s1[1][k] for k in ("usage", "codebook",
                                                  "params", "loss"))
    s1_ok = (s1_equal and s1[0]["loss_rel_err"] <= DDP_LOSS_RTOL
             and s1[0]["grad_ok"]
             and s1[0]["grad_model_rel_err"] <= DDP_MODEL_GRAD_RTOL)
    say("ddp", step="stage1", batch=DDP_VQ_BATCH, volume=TRAIN_VQ_SIZE,
        remat=s1[0]["remat"], remat_policy=s1[0]["remat_policy"],
        loss=s1[0]["loss"], loss_1p=s1[0]["loss_1p"],
        loss_rel_err=s1[0]["loss_rel_err"], loss_tol=DDP_LOSS_RTOL,
        grad_rel_err=s1[0]["grad_rel_err"], grad_worst=s1[0]["grad_worst"],
        grad_groups=s1[0]["grad_groups"],
        grad_model_rel_err=s1[0]["grad_model_rel_err"],
        usage_equal_to_one_process=s1[0]["usage_equal_1p"],
        ranks_bitwise_equal=s1_equal, step_ms=[r["step_ms"] for r in s1],
        launches=got["stage1"], expected=want["stage1"], card=card)
    ckpt = os.path.join(tmp, "ckpt")
    dirs = sorted(os.listdir(ckpt))
    log = _log_rows(os.path.join(ckpt, dirs[0], "training.log"))
    kept = CheckpointManager(os.path.join(ckpt, dirs[0])).all_epochs()
    cli_rel = abs(log[0]["loss"] - cli_row["loss"]) / abs(cli_row["loss"])
    cli_ok = (len(dirs) == 1 and kept == [1, 2] and len(log) == 2
              and rank0_text.count("resumed from epoch 1") == 1
              and cli_rel <= DDP_CLI_LOSS_RTOL
              and all(np.isfinite(list(row.values())).all() for row in log))
    say("ddp", step="cli", flags=CLI_FLAGSHIP, lbs=DDP_CLI_LBS,
        global_batch=DDP_CLI_LBS * DDP_PROCESSES, checkpoint_dirs=dirs,
        checkpoints=kept, log_rows=len(log), loss=log[0]["loss"],
        loss_one_process=cli_row["loss"], loss_rel_err=cli_rel,
        tol=DDP_CLI_LOSS_RTOL, epoch2_loss=log[1]["loss"],
        wall_s={run: [r["cli"][run]["wall_s"] for r in ranks]
                for run in ("run1", "run2")},
        launches=got["cli"], expected=want["cli"], card=card)
    counts = {attn.KERNEL: 0, cbq.KERNEL: 0}
    for gs in got.values():
        for g in gs:
            for k in counts:
                counts[k] += g[k]
    bf_ok, bf_counts = _bf16_s2_report("ddp", ranks, card)
    counts = {k: counts.get(k, 0) + bf_counts.get(k, 0)
              for k in {**counts, **bf_counts}}
    ok = s2_ok and s1_ok and cli_ok and launches_ok and bf_ok
    say("ddp", backend=backend, launches=counts, wall_s=wall_s, ok=ok,
        card=card)
    if not ok:
        raise RuntimeError(f"ddp: stage2 {s2_ok}, stage1 {s1_ok}, cli "
                           f"{cli_ok}, bf16 {bf_ok}, launches {got} against "
                           f"{want}")
    return counts


class _CollectiveTimer:
    """Times every `torch.distributed.all_reduce` inside the block (the
    card synchronised before and after each), by caller: "halo" (the
    exchanges of `parallel.halo`), "tp_gather" and "tp_sum" (the
    gathers and the sums of `parallel.tp`), "grads" (`reduce_gradients`),
    "metrics" (`reduce_metrics`) and "stats" (the norms' and quantizers'
    sums, the gathers). The synchronisation costs time of its own: the
    shares are of the instrumented step."""

    def __init__(self, dev: str):
        self.dev = dev
        self.ms: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}

    def _kind(self, frame) -> str:
        if frame.f_code.co_filename.endswith("halo.py"):
            return "halo"
        if frame.f_code.co_filename.endswith("tp.py"):
            return "tp_gather" if frame.f_code.co_name == "_gather" \
                else "tp_sum"
        return {"reduce_gradients": "grads",
                "reduce_metrics": "metrics"}.get(frame.f_code.co_name,
                                                 "stats")

    def __enter__(self):
        import torch.distributed as dist
        self.real = dist.all_reduce

        def timed(t, *a, **kw):
            kind = self._kind(sys._getframe(1))
            _sync(self.dev)
            t0 = time.perf_counter()
            out = self.real(t, *a, **kw)
            _sync(self.dev)
            self.ms[kind] = self.ms.get(kind, 0.0) \
                + 1e3 * (time.perf_counter() - t0)
            self.calls[kind] = self.calls.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0) \
                + t.numel() * t.element_size()
            return out
        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.all_reduce = self.real


def _spatial_timing(step, dev: str, plain: bool = True) -> dict:
    """Uncounted: one step with the defaults (TF32 convolutions, cuDNN's
    own algorithms) for its time, then one with every all-reduce timed;
    without `plain` only the second, whose time is then the step's."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        step_ms = None
        if plain:
            _sync(dev)
            t0 = time.perf_counter()
            step()
            _sync(dev)
            step_ms = 1e3 * (time.perf_counter() - t0)
        with _CollectiveTimer(dev) as timer:
            t0 = time.perf_counter()
            step()
            _sync(dev)
            timed_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.deterministic = det
    return dict(step_ms=timed_ms if step_ms is None else step_ms,
                instrumented_step_ms=timed_ms,
                collective_ms=timer.ms, collective_calls=timer.calls,
                collective_bytes=timer.bytes,
                halo_share=timer.ms.get("halo", 0.0) / timed_ms,
                grad_allreduce_share=timer.ms.get("grads", 0.0) / timed_ms)


def _spatial_mesh():
    from ldm3d_torch.core.config import MeshConfig
    from ldm3d_torch.parallel.mesh import make_mesh
    return make_mesh(MeshConfig(data=1, space=SPATIAL_PROCESSES))


def _allocated(dev: str) -> int:
    """The device's bytes allocated now (0 on the CPU)."""
    return torch.cuda.memory_allocated() if dev == "cuda" else 0


def _peak_step(dev: str, step) -> int:
    """The device's peak allocation during `step` (0 on the CPU)."""
    if dev != "cuda":
        step()
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _spatial_stage1(spec: dict, rank: int, mesh) -> dict:
    """The flagship's stage-1 at global batch SPATIAL_VQ_BATCH over the
    space mesh, each rank its depth slab (remat as the preset has it),
    under the float64 gate on rank 0 (`_s1_sharded_step`); its timing;
    then the step with remat off and its peak memory, and on rank 0 the
    one-process step's."""
    dev = spec["device"]
    out, tr, inp, (lv, lm) = _s1_sharded_step(spec, rank, mesh, "spatial")
    out.update(slab=list(lv.shape), params=_digest(tr.model.parameters()))
    out["timing"] = _spatial_timing(lambda: tr.train_step(lv, lm), dev)
    del tr
    # memory: the step with remat off, over the slabs and in one process
    off = replace(inp["vcfg"], remat=False)
    tr = VQTrainer(off, inp["tc"], device=dev, mesh=mesh).init_random(SEED)
    tr.train_step(lv, lm)            # Adam's state exists from here on
    out["peak_bytes"] = _peak_step(dev, lambda: tr.train_step(lv, lm))
    del tr
    pdist.barrier()
    if rank == 0:
        one = VQTrainer(off, inp["tc"], device=dev).init_random(SEED)
        v, mk = inp["vol"].to(dev), inp["mask"].to(dev)
        one.train_step(v, mk)
        out["peak_bytes_1p"] = _peak_step(dev, lambda: one.train_step(v, mk))
        del one
    pdist.barrier()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _spatial_stage2(spec: dict, rank: int, mesh) -> tuple:
    """The flagship's latent step at global batch DDP_BATCH over the
    space mesh (the latents whole, each rank's U-Net on its depth slab,
    the draws the global batch's, injected), against a one-process twin
    on rank 0; its timing. Returns the numbers, the trainer and the
    twin (rank 0) or None."""
    dev, inp = spec["device"], _ddp_s2_inputs(spec)
    tr = DiffusionTrainer(inp["cfg"], device=dev, train_cfg=inp["tc"],
                          mesh=mesh).init_random(SEED, "reach")
    x, c = inp["lat"].to(dev), inp["ctx"].to(dev)
    with _NoTF32():
        _sync(dev)
        _reset_launches()        # the main path's step starts here
        t0 = time.perf_counter()
        m = tr.train_step_latents(x, c, **inp["on"])
        _sync(dev)
        first_ms = 1e3 * (time.perf_counter() - t0)
        got = _launches()
    out = dict(loss=float(m["loss"]), noise_mse=float(m["noise_mse"]),
               launches=got, first_step_ms=first_ms,
               attention_calls=attention_calls_per_step(tr.model.unet),
               params=_digest(tr.model.unet.parameters()),
               buffers=_digest(tr.model.unet.buffers()),
               ema=_digest(tr.ema_unet.parameters()))
    twin = None
    if rank == 0:
        ref, twin = _s2_references(dict(spec, s2_tols=SPATIAL_S2_GRAD_RTOL),
                                   inp, tr.model.unet)
        out.update(ref, loss_rel_err=abs(out["loss"] - ref["loss_1p"])
                   / abs(ref["loss_1p"]),
                   stats_rel_err=_stats_error(tr.model.unet,
                                              twin.model.unet))
    pdist.barrier()
    out["timing"] = _spatial_timing(
        lambda: tr.train_step_latents(x, c, **inp["on"]), dev)
    return out, tr, twin


def _spatial_generate(spec: dict, rank: int, tr: DiffusionTrainer,
                      twin) -> dict:
    """`generate` from the stage-2 trainer's EMA U-Net over the space
    mesh (DDIM, injected noise, decode=True): the whole volume on every
    rank; on rank 0 the one-process twin, given the same weights, samples
    the same noise (TF32 off on both sides)."""
    dev, cfg = spec["device"], tr.cfg
    shape = _latent_shape(cfg, SPATIAL_GEN_NUM)
    rng = np.random.default_rng(SEED + 9)
    init = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev)
    noise = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             .to(dev) for _ in range(SPATIAL_GEN_STEPS)]
    ctx = torch.arange(SPATIAL_GEN_NUM, device=dev) % (
        cfg.unet.context_dim + 1)
    kw = dict(init_noise=init, step_noise=noise.__getitem__,
              sampler="ddim", sample_steps=SPATIAL_GEN_STEPS, eta=0.5,
              decode=True)
    with _NoTF32():
        _sync(dev)
        _reset_launches()        # the main path's request starts here
        t0 = time.perf_counter()
        vols = tr.generate(shape, ctx, **kw)
        _sync(dev)
        gen_ms = 1e3 * (time.perf_counter() - t0)
        got = _launches()
    out = dict(launches=got, generate_ms=gen_ms, shape=list(vols.shape),
               finite=bool(torch.isfinite(vols).all()),
               volumes=_digest([vols]))
    if rank == 0:
        twin.model.load_state_dict(tr.model.state_dict())
        twin.ema_unet.load_state_dict(tr.ema_unet.state_dict())
        with _NoTF32():
            ref = twin.generate(shape, ctx, **kw)
            _sync(dev)
        out["rel_err"] = _max_rel(vols, ref)
    pdist.barrier()
    return out


def _spatial_cli(spec: dict, rank: int) -> dict:
    """One --train_vq epoch of the flagship's stage-1 from the command
    line with the preset's mesh set to data 1 x space SPATIAL_PROCESSES
    (each process calls the CLI's main with --coordinator), counted."""
    import ldm3d_torch.core.presets as presets
    from ldm3d_torch.core.config import MeshConfig
    tmp, dev = spec["tmp"], spec["device"]
    argv = spec["vq_flags"] + [
        "--cache_dir", os.path.join(tmp, "cache"), "--ckpt_dir",
        os.path.join(tmp, "ckpt"), "--out_dir", os.path.join(tmp, "out"),
        "--platform", "gpu" if dev == "cuda" else "cpu", "--train_vq",
        "--synthetic", "--num_synthetic", str(SPATIAL_CLI_VOLUMES),
        "--volume_size", str(spec["vq_size"]), "--val_perc",
        str(TRAIN_VQ_VAL), "--lbs",
        str(SPATIAL_VQ_BATCH // SPATIAL_PROCESSES), "--epochs", "1",
        "--image_log_freq", "1",
        "--coordinator", f"127.0.0.1:{spec['cli_port']}",
        "--num_processes", str(SPATIAL_PROCESSES), "--process_id",
        str(rank)]
    mesh = MeshConfig(data=1, space=SPATIAL_PROCESSES)

    def preset(name):
        cfg = get_preset(name)
        return replace(cfg, train=replace(cfg.train, mesh=mesh))
    presets.get_preset = preset
    try:
        _sync(dev)
        _reset_launches()        # the main path's run starts here
        t0 = time.perf_counter()
        cli.main(argv)
        _sync(dev)
    finally:
        presets.get_preset = get_preset
    return dict(wall_s=time.perf_counter() - t0, launches=_launches())


def _explicit_group_norm(self, x):
    """GroupNorm's arithmetic of a slab in one process: the mean, then
    the squared deviations from it (`--spatial-check`)."""
    b = x.shape[0]
    xg = x.reshape(b, self.groups, -1)
    mean = xg.mean(-1, keepdim=True)
    var = torch.square(xg - mean).mean(-1, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return y * self.weight.view(shape) + self.bias.view(shape)


def _spatial_check(spec: dict, rank: int, mesh) -> dict:
    """--spatial-check: each stage's spatial step (cuDNN deterministic,
    TF32 off) and, on rank 0, the float32 steps it is compared with
    against float64 CPU steps from the same state: the one-process step,
    the same with cuDNN's default algorithms and (stage 1) with
    GroupNorm's slab arithmetic; printed, not judged."""
    from ldm3d_torch.models import layers
    from ldm3d_torch.parallel.mesh import shard_batch

    dev, out = spec["device"], {}
    torch.backends.cudnn.deterministic = True
    # stage 1
    inp = _ddp_s1_inputs(spec, SPATIAL_VQ_BATCH)
    tr = VQTrainer(inp["vcfg"], inp["tc"], device=dev,
                   mesh=mesh).init_random(SEED)
    lv, lm = (t.to(dev) for t in shard_batch(
        mesh, (inp["vol"], inp["mask"]), spatial_axis=3))
    with _NoTF32():
        tr.train_step(lv, lm)
    if rank == 0:
        def errs(a, b):
            e = _grad_errors(a, b, SPATIAL_S1_GRAD_RTOL)
            return {k: e[k] for k in ("grad_rel_err", "grad_worst",
                                      "grad_model_rel_err", "grad_worst5")}
        one = _ddp_s1_one_process(spec, inp)
        f64 = VQTrainer(inp["vcfg"], inp["tc"], device="cpu")
        f64.model.load_state_dict({k: v.cpu() for k, v in
                                   one.model.state_dict().items()})
        f64.model.double()
        f64._batch = lambda v, m: (v.cpu().double(), m.cpu().double())
        _ddp_s1_step(one, inp, dev)
        f64.train_step(inp["vol"], inp["mask"])
        res = {"spatial_vs_one_process": errs(tr.model, one.model),
               "spatial_vs_float64": errs(tr.model, f64.model),
               "one_process_vs_float64": errs(one.model, f64.model)}
        torch.backends.cudnn.deterministic = False
        other = _ddp_s1_one_process(spec, inp)
        _ddp_s1_step(other, inp, dev)
        res["cudnn_default_vs_one_process"] = errs(other.model, one.model)
        torch.backends.cudnn.deterministic = True
        real = layers._GroupNorm.forward
        layers._GroupNorm.forward = _explicit_group_norm
        try:
            other = _ddp_s1_one_process(spec, inp)
            _ddp_s1_step(other, inp, dev)
        finally:
            layers._GroupNorm.forward = real
        res["slab_groupnorm_arithmetic_vs_one_process"] = errs(other.model,
                                                               one.model)
        out["stage1"] = res
        del one, f64, other
    del tr
    pdist.barrier()
    # stage 2
    inp = _ddp_s2_inputs(spec)
    tr = DiffusionTrainer(inp["cfg"], device=dev, train_cfg=inp["tc"],
                          mesh=mesh).init_random(SEED, "reach")
    with _NoTF32():
        tr.train_step_latents(inp["lat"].to(dev), inp["ctx"].to(dev),
                              **inp["on"])
    if rank == 0:
        def errs2(a, b):
            e = _grad_errors(a.model.unet, b.model.unet, DDP_S2_GRAD_RTOL)
            return {k: e[k] for k in ("grad_groups", "grad_model_rel_err",
                                      "grad_worst5")}
        one = _ddp_s2_one_process(spec, inp)
        f64 = _float64_twin(one, DDP_BATCH)
        _ddp_s2_step(one, inp, dev)
        f64.train_step_latents(inp["lat"], inp["ctx"], **inp["draws"])
        out["stage2"] = {"spatial_vs_one_process": errs2(tr, one),
                         "spatial_vs_float64": errs2(tr, f64),
                         "one_process_vs_float64": errs2(one, f64)}
    pdist.barrier()
    torch.backends.cudnn.deterministic = False
    return out


def spatial_worker(spec_path: str, rank: str) -> None:
    """One process of the spatial phase: joins the other on a data 1 x
    space 2 mesh, runs stage 1, stage 2, `generate` and the command line
    (with --spatial-check: the check's steps alone), and writes its
    numbers as JSON."""
    global SEED
    with open(spec_path) as f:
        spec = json.load(f)
    rank, SEED = int(rank), spec["seed"]
    dev = spec["device"]
    if dev == "cuda":
        _build.load_all([attn.KERNEL, cbq.KERNEL])   # built by the parent
    out = {}
    pdist.initialize(f"127.0.0.1:{spec['port']}", SPATIAL_PROCESSES, rank,
                     platform="gpu" if dev == "cuda" else "cpu")
    try:
        out["backend"] = pdist.collective_backend()
        out["device"] = str(pdist.process_device())
        mesh = _spatial_mesh()
        if spec["check"]:
            out.update(_spatial_check(spec, rank, mesh))
            with open(os.path.join(spec["tmp"], f"rank{rank}.json"),
                      "w") as f:
                json.dump(out, f)
            return
        torch.backends.cudnn.deterministic = True
        out["stage1"] = _spatial_stage1(spec, rank, mesh)
        out["stage2"], tr, twin = _spatial_stage2(spec, rank, mesh)
        out["generate"] = _spatial_generate(spec, rank, tr, twin)
        del tr, twin
        out["stage2_bf16"] = _s2_bf16(spec, rank, mesh,
                                      _whole_grads("spatial", mesh))
        torch.backends.cudnn.deterministic = False
    finally:
        pdist.shutdown()
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["cli"] = _spatial_cli(spec, rank)
    with open(os.path.join(spec["tmp"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_spatial(card: str, check: bool = False) -> dict:
    """Main path 9: spatial parallelism. Two processes of this script on
    the one card, a data 1 x space 2 mesh over gloo on localhost ports,
    each holding one depth slab of every volume: the flagship's stage-1
    at 128^3 (global batch 2) and its latent step (global batch 8), each
    under the float64 gate (a one-process twin and a float64 step of the
    same state on process 0); the stage-1
    step's peak memory with remat off against the one-process step's;
    `generate` from the EMA U-Net with a sharded decode against the twin's;
    one --train_vq epoch from the command line at a space axis of 2. Each
    process zeroes its launch counters before each run of the main path
    and reads them after; the phase adds both processes'. With `check`
    (--spatial-check) only the compared steps run, and their distances
    from float64 steps are printed, not judged."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ldm3d_spatial_")
    torch.cuda.empty_cache()
    ports = []
    while len(ports) < 2:
        port = pdist.free_port()
        ports += [] if port in ports else [port]
    spec = dict(device=DDP_DEVICE, tiny=DDP_TINY, tmp=tmp, port=ports[0],
                cli_port=ports[1], vq_flags=TRAIN_VQ_FLAGS,
                vq_size=TRAIN_VQ_SIZE, check=check, seed=SEED)
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    try:
        ranks = _run_workers("spatial", path, tmp, SPATIAL_PROCESSES,
                             SPATIAL_TIMEOUT)
        if check:
            for key in ("stage1", "stage2"):
                say("spatial_check", part=key, seed=SEED,
                    result=ranks[0][key], card=card)
            return {}
        return _spatial_report(card, ranks, tmp,
                               time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spatial_report(card, ranks, tmp, wall_s) -> dict:
    """The spatial phase's checks and lines; returns both processes'
    launch counts."""
    s1, s2 = [r["stage1"] for r in ranks], [r["stage2"] for r in ranks]
    gen = [r["generate"] for r in ranks]
    on_card = DDP_DEVICE == "cuda"
    ckpt = os.path.join(tmp, "ckpt")
    dirs = sorted(os.listdir(ckpt))
    cli_cfg = cli.apply_overrides(get_preset(TRAIN_VQ_FLAGS[1]),
                                  cli.build_parser().parse_args(
                                      TRAIN_VQ_FLAGS))
    tr_idx, va_idx = train_val_split(SPATIAL_CLI_VOLUMES, TRAIN_VQ_VAL,
                                     cli_cfg.train.seed)
    steps = len(tr_idx) // SPATIAL_VQ_BATCH
    val_batches = len(va_idx) // SPATIAL_VQ_BATCH
    want = {"stage1": {attn.KERNEL: 0, cbq.KERNEL: 1},
            "stage2": {attn.KERNEL: s2[0]["attention_calls"],
                       cbq.KERNEL: 0},
            "generate": {attn.KERNEL: s2[0]["attention_calls"]
                         * SPATIAL_GEN_STEPS, cbq.KERNEL: 0},
            # a launch per train step, eval batch and montage
            "cli": {attn.KERNEL: 0, cbq.KERNEL: steps + val_batches + 1}}
    if not on_card:   # the plain versions run on the CPU: no launches
        want = {k: {attn.KERNEL: 0, cbq.KERNEL: 0} for k in want}
    got = {k: [r[k]["launches"] for r in ranks] for k in want}
    launches_ok = all(g == want[k] for k, gs in got.items() for g in gs)
    backend = sorted({r["backend"] for r in ranks})

    s1_equal = all(s1[0][k] == s1[1][k] for k in ("usage", "codebook",
                                                  "params", "loss"))
    peak = max(r["peak_bytes"] for r in s1)
    ratio = peak / s1[0]["peak_bytes_1p"] if on_card else None
    memory_ok = not on_card or ratio < SPATIAL_MEMORY_RATIO
    s1_ok = (s1_equal and s1[0]["loss_rel_err"] <= DDP_LOSS_RTOL
             and s1[0]["gate"]["ok"])
    say("spatial", step="stage1", processes=SPATIAL_PROCESSES,
        mesh="data 1 x space 2", backend=backend,
        devices=[r["device"] for r in ranks], batch=SPATIAL_VQ_BATCH,
        volume=TRAIN_VQ_SIZE, slab=s1[0]["slab"], remat=s1[0]["remat"],
        loss=s1[0]["loss"], loss_1p=s1[0]["loss_1p"],
        loss_rel_err=s1[0]["loss_rel_err"], loss_tol=DDP_LOSS_RTOL,
        **_s1_gate_fields(s1[0]),
        ranks_bitwise_equal=s1_equal,
        first_step_ms=[r["first_step_ms"] for r in s1],
        timing=[r["timing"] for r in s1],
        peak_bytes_remat_off=[r["peak_bytes"] for r in s1],
        peak_bytes_remat_off_one_process=s1[0].get("peak_bytes_1p"),
        peak_ratio=ratio, peak_ratio_tol=SPATIAL_MEMORY_RATIO,
        launches=got["stage1"], expected=want["stage1"], card=card)
    s2_equal = all(s2[0][k] == s2[1][k] for k in ("params", "buffers", "ema",
                                                  "loss", "noise_mse"))
    s2_ok = (s2_equal and s2[0]["loss_rel_err"] <= DDP_LOSS_RTOL
             and s2[0]["gate"]["ok"]
             and s2[0]["stats_rel_err"] <= DDP_LOSS_RTOL)
    say("spatial", step="stage2", batch=DDP_BATCH,
        loss=s2[0]["loss"], loss_1p=s2[0]["loss_1p"],
        loss_rel_err=s2[0]["loss_rel_err"], loss_tol=DDP_LOSS_RTOL,
        grad_gate=s2[0]["gate"], float64_step_s=s2[0]["float64_step_s"],
        seed=SEED, stats_rel_err=s2[0]["stats_rel_err"],
        ranks_bitwise_equal=s2_equal,
        first_step_ms=[r["first_step_ms"] for r in s2],
        timing=[r["timing"] for r in s2],
        launches=got["stage2"], expected=want["stage2"], card=card)
    gen_ok = (gen[0]["volumes"] == gen[1]["volumes"] and gen[0]["finite"]
              and gen[0]["rel_err"] <= SAMPLER_REL_TOL)
    say("spatial", step="generate", sampler="ddim",
        sample_steps=SPATIAL_GEN_STEPS, num=SPATIAL_GEN_NUM,
        shape=gen[0]["shape"], decode="over depth slabs, gathered",
        rel_err=gen[0]["rel_err"], tol=SAMPLER_REL_TOL,
        ranks_bitwise_equal=gen[0]["volumes"] == gen[1]["volumes"],
        generate_ms=[g["generate_ms"] for g in gen],
        launches=got["generate"], expected=want["generate"], card=card)
    log = _log_rows(os.path.join(ckpt, dirs[0], "training.log")) \
        if len(dirs) == 1 else []
    kept = CheckpointManager(os.path.join(ckpt, dirs[0])).all_epochs() \
        if len(dirs) == 1 else []
    cli_ok = (len(dirs) == 1 and kept == [1] and len(log) == 1
              and all(np.isfinite(list(row.values())).all() for row in log))
    say("spatial", step="cli", flags=TRAIN_VQ_FLAGS,
        mesh={"data": 1, "space": SPATIAL_PROCESSES},
        lbs=SPATIAL_VQ_BATCH // SPATIAL_PROCESSES,
        volumes=SPATIAL_CLI_VOLUMES, steps=steps, val_batches=val_batches,
        checkpoint_dirs=dirs, checkpoints=kept, log=log,
        wall_s=[r["cli"]["wall_s"] for r in ranks], launches=got["cli"],
        expected=want["cli"], card=card)
    counts = {attn.KERNEL: 0, cbq.KERNEL: 0}
    for gs in got.values():
        for g in gs:
            for k in counts:
                counts[k] += g[k]
    bf_ok, bf_counts = _bf16_s2_report("spatial", ranks, card)
    counts = {k: counts.get(k, 0) + bf_counts.get(k, 0)
              for k in {**counts, **bf_counts}}
    ok = (s1_ok and memory_ok and s2_ok and gen_ok and cli_ok and launches_ok
          and bf_ok)
    say("spatial", backend=backend, launches=counts, wall_s=wall_s, ok=ok,
        card=card)
    if not ok:
        raise RuntimeError(
            f"spatial: stage1 {s1_ok}, memory {memory_ok} ({ratio}), "
            f"stage2 {s2_ok}, generate {gen_ok}, cli {cli_ok}, bf16 "
            f"{bf_ok}, launches {got} against {want}")
    return counts


# ---------------------------------------------------------------------------
# Main path 10: tensor parallelism
# ---------------------------------------------------------------------------


def _tp_mesh():
    from ldm3d_torch.core.config import MeshConfig
    from ldm3d_torch.parallel.mesh import make_mesh
    return make_mesh(MeshConfig(data=1, space=1, model=TP_PROCESSES))


def _tp_whole_grads(model, mesh) -> Dict[str, torch.Tensor]:
    """Every gradient of a tensor-parallel module, whole (the sharded ones
    gathered over the model group: a collective), on the CPU."""
    from ldm3d_torch.parallel import tp
    out = {}
    for name, m in model.named_modules():
        for n, p in m.named_parameters(recurse=False):
            if p.grad is None:
                continue
            dim = tp.split_dim(m, n)
            g = p.grad if dim is None else tp.gather_tensor(p.grad, dim,
                                                            mesh)
            out[f"{name}.{n}" if name else n] = g.cpu()
    return out


def _state_bytes(params, optimizer) -> int:
    """Bytes of the parameters and of the optimizer's state."""
    return sum(p.numel() * p.element_size() for p in params) + sum(
        v.numel() * v.element_size() for st in optimizer.state.values()
        for v in st.values() if torch.is_tensor(v))


def _tp_counted(dev: str, step) -> dict:
    """The main path's step (TF32 off, cuDNN as set), its launches, time
    and the process's peak device memory."""
    with _NoTF32():
        _sync(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _reset_launches()        # the main path's step starts here
        t0 = time.perf_counter()
        m = step()
        _sync(dev)
        out = dict(first_step_ms=1e3 * (time.perf_counter() - t0),
                   launches=_launches())
    out["peak_bytes"] = torch.cuda.max_memory_allocated() \
        if dev == "cuda" else 0
    return m, out


def _tp_stage2(spec: dict, rank: int, mesh) -> dict:
    """The flagship's latent step at global batch DDP_BATCH on the data 1
    x model 2 mesh (the whole batch on each process, the U-Net's wide
    kernels split), the draws injected; its timing; then on rank 0 the
    one-process twin and the float64 step of the stage-2 gate, and the
    one-process step's peak and state bytes."""
    from ldm3d_torch.parallel import tp
    dev, inp = spec["device"], _ddp_s2_inputs(spec)
    tr = DiffusionTrainer(inp["cfg"], device=dev, train_cfg=inp["tc"],
                          mesh=mesh).init_random(SEED, "reach")
    x, c = inp["lat"].to(dev), inp["ctx"].to(dev)
    m, out = _tp_counted(dev, lambda: tr.train_step_latents(x, c,
                                                            **inp["on"]))
    unet = tr.model.unet
    out.update(loss=float(m["loss"]), noise_mse=float(m["noise_mse"]),
               attention_calls=attention_calls_per_step(unet),
               sharded=len(tp.sharded_names(unet)),
               state_bytes=_state_bytes(unet.parameters(), tr.optimizer),
               ema_bytes=sum(p.numel() * p.element_size()
                             for p in tr.ema_unet.parameters()))
    grads = _tp_whole_grads(unet, mesh)
    state = tr.state_dict()          # whole tensors: a collective
    out.update(params=_digest(state["model"].values()),
               ema=_digest(state["ema_unet"].values()))
    del state
    out["timing"] = _spatial_timing(
        lambda: tr.train_step_latents(x, c, **inp["on"]), dev)
    pdist.barrier()
    del tr, unet
    if dev == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        ref, twin = _s2_references(dict(spec, s2_tols=DDP_S2_GRAD_RTOL),
                                   inp, grads)
        out.update(ref, loss_rel_err=abs(out["loss"] - ref["loss_1p"])
                   / abs(ref["loss_1p"]),
                   state_bytes_1p=_state_bytes(
                       twin.model.unet.parameters(), twin.optimizer))
        del twin
    del grads
    pdist.barrier()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _tp_stage1(spec: dict, rank: int, mesh) -> dict:
    """The flagship's stage-1 (remat full) at global batch
    SPATIAL_VQ_BATCH of 128^3 volumes on the mesh, under the float64 gate
    on rank 0 (`_s1_sharded_step`; the one-process twin's peak and state
    bytes beside it); its timing."""
    from ldm3d_torch.parallel import tp
    dev = spec["device"]
    out, tr, _, (v, mk) = _s1_sharded_step(spec, rank, mesh, "tp")
    out.update(sharded=len(tp.sharded_names(tr.model)),
               state_bytes=_state_bytes(tr.model.parameters(),
                                        tr.optimizer),
               params=_digest(tr.state_dict()["model"].values()))
    out["timing"] = _spatial_timing(lambda: tr.train_step(v, mk), dev)
    pdist.barrier()
    del tr
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _tp_cli(spec: dict, rank: int) -> dict:
    """From the command line, each process calling the CLI's main with
    --coordinator and the preset's mesh set to data 1 x model 2: one
    --train_dm --cache_latents epoch of the flagship; one --train_vq epoch
    of its stage-1; the same --train_vq epoch with --auto_resume 1, process
    1 failing at the epoch's end (its plateau schedule raises once), its
    agreements on failures timed. Each run counted."""
    import ldm3d_torch.core.presets as presets
    from ldm3d_torch.core.config import MeshConfig
    from ldm3d_torch.train import callbacks, loop
    tmp, dev = spec["tmp"], spec["device"]
    common = ["--platform", "gpu" if dev == "cuda" else "cpu",
              "--cache_dir", os.path.join(tmp, "cache"), "--synthetic",
              "--num_processes", str(TP_PROCESSES), "--process_id",
              str(rank)]
    # the two --train_vq runs are compared: cuDNN deterministic for both
    vq = spec["vq_flags"] + common + [
        "--cache_dir", os.path.join(tmp, "vq_cache"), "--train_vq",
        "--num_synthetic", str(SPATIAL_CLI_VOLUMES), "--volume_size",
        str(spec["vq_size"]), "--val_perc", str(TRAIN_VQ_VAL), "--lbs",
        str(SPATIAL_VQ_BATCH // TP_PROCESSES), "--epochs", "1"]
    runs = {
        "dm": spec["cli_flags"] + common + [
            "--train_dm", "--cache_latents", "--num_synthetic",
            str(spec["cli_volumes"]), "--lbs", str(DDP_CLI_LBS), "--epochs",
            "1", "--ckpt_dir", os.path.join(tmp, "ckpt_dm")],
        "vq": vq + ["--ckpt_dir", os.path.join(tmp, "ckpt_vq")],
        "vq_recovered": vq + ["--ckpt_dir", os.path.join(tmp, "ckpt_rec"),
                              "--auto_resume", "1"],
    }
    mesh = MeshConfig(data=1, space=1, model=TP_PROCESSES)

    def preset(name):
        cfg = get_preset(name)
        return replace(cfg, train=replace(cfg.train, mesh=mesh))
    real = callbacks.ReduceLROnPlateau.__call__

    def failing(self, epoch, *a, **kw):
        callbacks.ReduceLROnPlateau.__call__ = real     # once
        raise RuntimeError("injected fault")
    agree, agreed = loop._agree, []

    def timed_agree(err):
        t0 = time.perf_counter()
        try:
            agree(err)
        finally:
            agreed.append(time.perf_counter() - t0)
    out = {}
    presets.get_preset = preset
    try:
        for (name, argv), port in zip(runs.items(), spec["cli_ports"]):
            if name == "vq_recovered":
                loop._agree = timed_agree
                if rank == 1:
                    callbacks.ReduceLROnPlateau.__call__ = failing
            printed = io.StringIO()
            torch.backends.cudnn.deterministic = name != "dm"
            _sync(dev)
            _reset_launches()        # a run of the main path starts here
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                cli.main(argv + ["--coordinator", f"127.0.0.1:{port}"])
            _sync(dev)
            callbacks.ReduceLROnPlateau.__call__ = real
            loop._agree = agree
            print(printed.getvalue(), flush=True)
            out[name] = dict(wall_s=time.perf_counter() - t0,
                             launches=_launches(),
                             recovered=[ln for ln in printed.getvalue()
                                        .splitlines()
                                        if ln.startswith("recovered from")])
    finally:
        presets.get_preset = get_preset
        callbacks.ReduceLROnPlateau.__call__ = real
        loop._agree = agree
        torch.backends.cudnn.deterministic = False
    out["vq_recovered"].update(agreements=len(agreed),
                               agreement_ms=[1e3 * t for t in agreed])
    return out


def tp_worker(spec_path: str, rank: str) -> None:
    """One process of the tp phase: joins the other on a data 1 x model 2
    mesh, runs stage 1 and stage 2 and the command line (with --tp-check:
    the steps alone), and writes its numbers as JSON."""
    global SEED
    with open(spec_path) as f:
        spec = json.load(f)
    rank, SEED = int(rank), spec["seed"]
    dev = spec["device"]
    if dev == "cuda":
        _build.load_all([attn.KERNEL, cbq.KERNEL])   # built by the parent
    out = {}
    pdist.initialize(f"127.0.0.1:{spec['port']}", TP_PROCESSES, rank,
                     platform="gpu" if dev == "cuda" else "cpu")
    try:
        out["backend"] = pdist.collective_backend()
        out["device"] = str(pdist.process_device())
        mesh = _tp_mesh()
        torch.backends.cudnn.deterministic = True
        # stage 1 first, as in the ddp phase (`_ddp_main_path`)
        out["stage1"] = _tp_stage1(spec, rank, mesh)
        out["stage2"] = _tp_stage2(spec, rank, mesh)
        if not spec["check"]:
            out["stage2_bf16"] = _s2_bf16(spec, rank, mesh,
                                          _whole_grads("tp", mesh))
        torch.backends.cudnn.deterministic = False
    finally:
        pdist.shutdown()
    if not spec["check"]:
        out["cli"] = _tp_cli(spec, rank)
    with open(os.path.join(spec["tmp"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_tp(card: str, check: bool = False) -> dict:
    """Main path 10: tensor parallelism. Two processes of this script on
    the one card, a data 1 x model 2 mesh over gloo on localhost ports,
    each holding half of every wide conv kernel and vector of the trained
    networks: the flagship's latent step (global batch 8) under the
    float64 gate and its stage-1 at 128^3 (global batch 2, remat full)
    under its own; then --train_dm --cache_latents, and
    --train_vq without and with --auto_resume and a failure on process 1,
    from the command line. Each process zeroes its launch counters before
    each run of the main path and reads them after; the phase adds both
    processes'. With `check` (--tp-check) only the steps run and their
    numbers are printed, not judged."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ldm3d_tp_")
    torch.cuda.empty_cache()
    ports = []
    while len(ports) < 4:
        port = pdist.free_port()
        ports += [] if port in ports else [port]
    spec = dict(device=DDP_DEVICE, tiny=DDP_TINY, tmp=tmp, port=ports[0],
                cli_ports=ports[1:], cli_flags=CLI_FLAGSHIP,
                cli_volumes=CLI_VOLUMES, vq_flags=TRAIN_VQ_FLAGS,
                vq_size=TRAIN_VQ_SIZE, check=check, seed=SEED)
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    try:
        cli_cfg = cli.apply_overrides(
            get_preset(CLI_FLAGSHIP[1]),
            cli.build_parser().parse_args(CLI_FLAGSHIP))
        free = shutil.disk_usage(tmp).free
        need = _checkpoint_bytes(cli_cfg) + 2 * 2 ** 30
        if DDP_DEVICE == "cuda" and free < need and not check:
            raise RuntimeError(f"tp: {free} bytes free in {tmp}, {need} "
                               "needed")
        ranks = _run_workers("tp", path, tmp, TP_PROCESSES, TP_TIMEOUT)
        if check:
            for key in ("stage2", "stage1"):
                say("tp_check", part=key, seed=SEED, result=ranks[0][key],
                    card=card)
            return {}
        return _tp_report(card, ranks, tmp, cli_cfg,
                          time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _tp_checkpoint_ok(path: str, cli_cfg) -> bool:
    """The --train_dm checkpoint holds one process's model keys and
    shapes (a state of `LatentDiffusion` built on the meta device)."""
    state, _ = CheckpointManager(path).restore(1)
    with torch.device("meta"):
        want = LatentDiffusion(cli_cfg.diffusion).state_dict()
    got = state["model"]
    return got.keys() == want.keys() and all(
        got[k].shape == t.shape for k, t in want.items())


def _tp_report(card, ranks, tmp, cli_cfg, wall_s) -> dict:
    """The tp phase's checks and lines; returns both processes' launch
    counts."""
    s2, s1 = [r["stage2"] for r in ranks], [r["stage1"] for r in ranks]
    cli_runs = [r["cli"] for r in ranks]
    on_card = DDP_DEVICE == "cuda"
    tr_idx, _ = train_val_split(CLI_VOLUMES, cli_cfg.train.val_fraction,
                                cli_cfg.train.seed)
    batches = len(tr_idx) // (DDP_CLI_LBS * TP_PROCESSES)
    vq_cfg = cli.apply_overrides(get_preset(TRAIN_VQ_FLAGS[1]),
                                 cli.build_parser().parse_args(
                                     TRAIN_VQ_FLAGS))
    vtr, vva = train_val_split(SPATIAL_CLI_VOLUMES, TRAIN_VQ_VAL,
                               vq_cfg.train.seed)
    vq_launches = len(vtr) // SPATIAL_VQ_BATCH + len(vva) // SPATIAL_VQ_BATCH
    calls = s2[0]["attention_calls"]
    want = {"stage2": {attn.KERNEL: calls, cbq.KERNEL: 0},
            "stage1": {attn.KERNEL: 0, cbq.KERNEL: 1},
            # each process encodes and steps on every row (data 1)
            "cli_dm": {attn.KERNEL: calls * batches, cbq.KERNEL: batches},
            "cli_vq": {attn.KERNEL: 0, cbq.KERNEL: vq_launches},
            # the failed epoch's steps and eval, then the epoch again
            "cli_vq_recovered": {attn.KERNEL: 0,
                                 cbq.KERNEL: 2 * vq_launches}}
    if not on_card:   # the plain versions run on the CPU: no launches
        want = {k: {attn.KERNEL: 0, cbq.KERNEL: 0} for k in want}
    got = {"stage2": [r["launches"] for r in s2],
           "stage1": [r["launches"] for r in s1]}
    for run in ("dm", "vq", "vq_recovered"):
        got[f"cli_{run}"] = [c[run]["launches"] for c in cli_runs]
    launches_ok = all(g == want[k] for k, gs in got.items() for g in gs)
    backend = sorted({r["backend"] for r in ranks})

    def share(t):
        ms = t["collective_ms"]
        return (ms.get("tp_gather", 0.0) + ms.get("tp_sum", 0.0)) \
            / t["instrumented_step_ms"]
    s2_equal = all(s2[0][k] == s2[1][k] for k in ("params", "ema", "loss",
                                                  "noise_mse"))
    s2_ok = (s2_equal and s2[0]["sharded"] > 0
             and s2[0]["loss_rel_err"] <= DDP_LOSS_RTOL
             and s2[0]["gate"]["ok"])
    say("tp", step="stage2", processes=TP_PROCESSES,
        mesh="data 1 x model 2", backend=backend,
        devices=[r["device"] for r in ranks], batch=DDP_BATCH,
        sharded_tensors=s2[0]["sharded"], loss=s2[0]["loss"],
        loss_1p=s2[0]["loss_1p"], loss_rel_err=s2[0]["loss_rel_err"],
        loss_tol=DDP_LOSS_RTOL, grad_gate=s2[0]["gate"],
        float64_step_s=s2[0]["float64_step_s"], seed=SEED,
        ranks_bitwise_equal=s2_equal,
        first_step_ms=[r["first_step_ms"] for r in s2],
        step_ms=[r["timing"]["step_ms"] for r in s2],
        timing=[r["timing"] for r in s2],
        collective_share=[share(r["timing"]) for r in s2],
        state_bytes=[r["state_bytes"] for r in s2],
        state_bytes_one_process=s2[0]["state_bytes_1p"],
        ema_bytes=[r["ema_bytes"] for r in s2],
        peak_bytes=[r["peak_bytes"] for r in s2],
        peak_bytes_one_process=s2[0]["peak_bytes_1p"],
        launches=got["stage2"], expected=want["stage2"], card=card)
    s1_equal = all(s1[0][k] == s1[1][k] for k in ("usage", "codebook",
                                                  "params", "loss"))
    s1_ok = (s1_equal and s1[0]["sharded"] > 0 and s1[0]["gate"]["ok"]
             and s1[0]["loss_rel_err"] <= DDP_LOSS_RTOL
             and s1[0]["usage_equal_1p"])
    say("tp", step="stage1", batch=SPATIAL_VQ_BATCH, volume=TRAIN_VQ_SIZE,
        remat=s1[0]["remat"], sharded_tensors=s1[0]["sharded"],
        loss=s1[0]["loss"], loss_1p=s1[0]["loss_1p"],
        loss_rel_err=s1[0]["loss_rel_err"], loss_tol=DDP_LOSS_RTOL,
        **_s1_gate_fields(s1[0]),
        ranks_bitwise_equal=s1_equal,
        first_step_ms=[r["first_step_ms"] for r in s1],
        step_ms=[r["timing"]["step_ms"] for r in s1],
        timing=[r["timing"] for r in s1],
        collective_share=[share(r["timing"]) for r in s1],
        state_bytes=[r["state_bytes"] for r in s1],
        state_bytes_one_process=s1[0]["state_bytes_1p"],
        peak_bytes=[r["peak_bytes"] for r in s1],
        peak_bytes_one_process=s1[0]["twin_peak_bytes"],
        launches=got["stage1"], expected=want["stage1"], card=card)
    # the command line
    dm_dir = os.path.join(tmp, "ckpt_dm", cli_cfg.name + "_dm")
    dm_log = _log_rows(os.path.join(dm_dir, "training.log"))
    dm_kept = CheckpointManager(dm_dir).all_epochs()
    dm_ok = (dm_kept == [1] and len(dm_log) == 1
             and all(np.isfinite(list(row.values())).all() for row in dm_log)
             and _tp_checkpoint_ok(dm_dir, cli_cfg))
    vq_dir, rec_dir = (os.path.join(tmp, d, vq_cfg.name + "_vq")
                       for d in ("ckpt_vq", "ckpt_rec"))
    vq_log, rec_log = (_log_rows(os.path.join(d, "training.log"))
                       for d in (vq_dir, rec_dir))
    rec_rel = max(abs(rec_log[0][k] - v) / max(abs(v), 1e-12)
                  for k, v in vq_log[0].items()) if len(rec_log) == 1 \
        and rec_log[0].keys() == vq_log[0].keys() else float("inf")
    recovered = [c["vq_recovered"]["recovered"] for c in cli_runs]
    rec_ok = (len(vq_log) == 1 and len(rec_log) == 1
              and rec_rel <= DDP_CLI_LOSS_RTOL
              and all(len(r) == 1 and "resuming at epoch 0" in r[0]
                      for r in recovered)
              and CheckpointManager(rec_dir).all_epochs() == [1])
    agree_ms = [c["vq_recovered"]["agreement_ms"] for c in cli_runs]
    say("tp", step="cli", dm_flags=CLI_FLAGSHIP, dm_lbs=DDP_CLI_LBS,
        dm_global_batch=DDP_CLI_LBS * TP_PROCESSES,
        dm_checkpoints=dm_kept, dm_log=dm_log,
        dm_checkpoint_one_process_shapes=dm_ok, vq_flags=TRAIN_VQ_FLAGS,
        vq_volumes=SPATIAL_CLI_VOLUMES, vq_log=vq_log,
        recovered_log=rec_log, recovered_rel_err=rec_rel,
        recovered_tol=DDP_CLI_LOSS_RTOL, recovered=recovered,
        agreements=[len(a) for a in agree_ms],
        agreement_bytes=4 * TP_PROCESSES,
        agreement_median_ms=[float(np.median(a)) if a else None
                             for a in agree_ms],
        agreement_total_ms=[float(np.sum(a)) for a in agree_ms],
        wall_s={run: [c[run]["wall_s"] for c in cli_runs]
                for run in ("dm", "vq", "vq_recovered")},
        launches={k: got[k] for k in got if k.startswith("cli")},
        expected={k: want[k] for k in want if k.startswith("cli")},
        card=card)
    counts = {attn.KERNEL: 0, cbq.KERNEL: 0}
    for gs in got.values():
        for g in gs:
            for k in counts:
                counts[k] += g[k]
    bf_ok, bf_counts = _bf16_s2_report("tp", ranks, card)
    counts = {k: counts.get(k, 0) + bf_counts.get(k, 0)
              for k in {**counts, **bf_counts}}
    ok = s2_ok and s1_ok and dm_ok and rec_ok and launches_ok and bf_ok
    say("tp", backend=backend, launches=counts, wall_s=wall_s, ok=ok,
        card=card)
    if not ok:
        raise RuntimeError(
            f"tp: stage2 {s2_ok}, stage1 {s1_ok}, cli dm {dm_ok}, "
            f"auto_resume {rec_ok}, bf16 {bf_ok}, launches {got} against "
            f"{want}")
    return counts


# ---------------------------------------------------------------------------
# Main path 12: the multi-axis meshes
# ---------------------------------------------------------------------------


def _make_mesh(shape):
    from ldm3d_torch.core.config import MeshConfig
    from ldm3d_torch.parallel.mesh import make_mesh
    return make_mesh(MeshConfig(*shape))


def _device_digest(tensors) -> str:
    """sha256 over checksums taken on the tensors' device: each tensor's
    words (4-byte, or 2- and 1-byte for narrower types) summed in int64
    (modulo 2^64), plainly and weighted by their position modulo 65521.
    Tensors that differ give equal digests only by a checksum's
    coincidence; `_digest` hashes every byte on the host instead, seconds
    a gigabyte."""
    import hashlib
    sums = []
    for t in tensors:
        flat = t.detach().contiguous().view(-1)
        size = flat.numel() * flat.element_size()
        word = next(w for w in (torch.int32, torch.int16, torch.uint8)
                    if size % torch.tensor([], dtype=w).element_size() == 0)
        words = flat.view(torch.uint8).view(word).to(torch.int64)
        weight = torch.arange(words.numel(), device=words.device) % 65521 + 1
        sums.append(torch.stack([words.sum(), (words * weight).sum()]))
    h = hashlib.sha256()
    h.update(torch.stack(sums).cpu().numpy().tobytes() if sums else b"")
    return h.hexdigest()


def _gate_grads(model, mesh, rank: int):
    """The whole gradients of `model` on the host for process 0's gate:
    gathered over the model axis by process 0's model line alone (its
    collective), None on every other process."""
    from ldm3d_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS
    if mesh.coord(DATA_AXIS) or mesh.coord(SPACE_AXIS):
        return None
    grads = _tp_whole_grads(model, mesh)
    return grads if rank == 0 else None


def _mesh_stage2(spec: dict, rank: int, mesh) -> dict:
    """The flagship's latent step at global batch DDP_BATCH over `mesh`
    (each rank its rows; over 'space' the U-Net on its depth slab, over
    'model' its shards of the wide kernels), the draws injected; its
    timing; then, the sharded trainer freed on every rank, on rank 0 the
    one-process twin and the float64 step of the float64 gate. With
    spec["defer"] rank 0 keeps its gradients, statistics and loss in a
    file for the next launch's rank 0 to judge beside its own (the same
    references); with spec["judge"] it judges that file's step too."""
    from ldm3d_torch.parallel import tp
    from ldm3d_torch.parallel.mesh import MODEL_AXIS, shard_batch
    dev, inp = spec["device"], _ddp_s2_inputs(spec)
    parts, t0 = {}, time.perf_counter()
    tr = DiffusionTrainer(inp["cfg"], device=dev, train_cfg=inp["tc"],
                          mesh=mesh).init_random(SEED, "reach")
    x, c = (t.to(dev) for t in shard_batch(mesh, (inp["lat"], inp["ctx"])))
    parts["init"] = time.perf_counter() - t0
    m, out = _tp_counted(dev, lambda: tr.train_step_latents(x, c,
                                                            **inp["on"]))
    parts["step"] = time.perf_counter() - t0 - sum(parts.values())
    unet = tr.model.unet
    out.update(loss=float(m["loss"]), noise_mse=float(m["noise_mse"]),
               rows=x.shape[0],
               attention_calls=attention_calls_per_step(unet),
               sharded=len(tp.sharded_names(unet)),
               model_index=mesh.coord(MODEL_AXIS),
               state_bytes=_state_bytes(unet.parameters(), tr.optimizer),
               # this process's own tensors: equal on every process of
               # its model coordinate
               params=_device_digest(tr.model.state_dict().values()),
               ema=_device_digest(tr.ema_unet.state_dict().values()))
    grads = _gate_grads(unet, mesh, rank)
    stats = {n: b.to("cpu", copy=True) for n, b in unet.named_buffers()
             if "running" in n}
    parts["whole"] = time.perf_counter() - t0 - sum(parts.values())
    if not spec["check"]:
        out["timing"] = _spatial_timing(
            lambda: tr.train_step_latents(x, c, **inp["on"]), dev,
            plain=False)
    parts["timing"] = time.perf_counter() - t0 - sum(parts.values())
    del tr, unet
    pdist.barrier()
    if dev == "cuda":
        torch.cuda.empty_cache()
    parts["barrier"] = time.perf_counter() - t0 - sum(parts.values())
    out["parts_s"] = parts
    deferred = os.path.join(spec["tmp"], "deferred_stage2.pt")
    if rank == 0 and spec.get("defer"):
        torch.save(dict(grads=grads, stats=stats, loss=out["loss"]),
                   deferred)
    elif rank == 0:
        other = torch.load(deferred) if spec.get("judge") else None
        ref, twin = _s2_references(
            dict(spec, s2_tols=SPATIAL_S2_GRAD_RTOL), inp, grads,
            others=None if other is None else {"deferred": other["grads"]})
        ref_stats = dict(twin.model.unet.named_buffers())

        def judged(loss, stats):
            return dict(loss_1p=ref["loss_1p"],
                        loss_rel_err=abs(loss - ref["loss_1p"])
                        / abs(ref["loss_1p"]),
                        stats_rel_err=max(
                            [float((b.double() - ref_stats[n].double()
                                    .cpu()).abs().max())
                             / max(float(ref_stats[n].abs().max()), 1e-30)
                             for n, b in stats.items()], default=0.0))
        common = dict(float64_step_s=ref["float64_step_s"],
                      peak_bytes_1p=ref["peak_bytes_1p"],
                      state_bytes_1p=_state_bytes(
                          twin.model.unet.parameters(), twin.optimizer))
        out.update(**common, **judged(out["loss"], stats), gate=ref["gate"])
        if other is not None:
            out["deferred"] = dict(common, **judged(other["loss"],
                                                    other["stats"]),
                                   gate=ref["others"]["deferred"])
        del twin, other
    del grads
    pdist.barrier()
    if dev == "cuda":
        torch.cuda.empty_cache()
    parts["references"] = time.perf_counter() - t0 - sum(parts.values())
    return out


def _mesh_stage1(spec: dict, rank: int, mesh, batch: int,
                 remat=None) -> dict:
    """The flagship's stage-1 at global batch `batch` over `mesh`, each
    rank its rows and depth slab, under the float64 gate on rank 0
    (`_s1_sharded_step`); its timing."""
    dev = spec["device"]
    t0 = time.perf_counter()
    out, tr, _, (v, mk) = _s1_sharded_step(spec, rank, mesh, "mesh",
                                           batch=batch, remat=remat)
    out.update(slab=list(v.shape),
               params=_device_digest(tr.model.state_dict().values()))
    t1 = time.perf_counter()
    if not spec["check"]:
        out["timing"] = _spatial_timing(lambda: tr.train_step(v, mk), dev,
                                        plain=False)
    out["parts_s"] = dict(step_and_references=t1 - t0,
                          timing=time.perf_counter() - t1)
    del tr
    pdist.barrier()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


# the steps of a mesh worker: (the mesh they run on, the step)
MESH_STEPS = {
    "plane_stage1": (MESH_PLANE, partial(_mesh_stage1, batch=MESH_VQ_BATCH)),
    "plane_stage2": (MESH_PLANE, _mesh_stage2),
    "line_stage1": (MESH_LINE, partial(_mesh_stage1,
                                       batch=SPATIAL_VQ_BATCH)),
    "line_stage1_remat_off": (MESH_LINE, partial(
        _mesh_stage1, batch=SPATIAL_VQ_BATCH, remat=False)),
    "cube_stage2": (MESH_CUBE, _mesh_stage2),
}


def _mesh_cli(spec: dict, rank: int) -> dict:
    """One --train_vq epoch of the flagship's stage-1 from the command
    line with the preset's mesh set to the data 2 x space 2 plane (each
    process calls the CLI's main with --coordinator), counted."""
    import ldm3d_torch.core.presets as presets
    from ldm3d_torch.core.config import MeshConfig
    tmp, dev = spec["tmp"], spec["device"]
    n = spec["processes"]
    argv = spec["vq_flags"] + [
        "--cache_dir", os.path.join(tmp, "cache"), "--ckpt_dir",
        os.path.join(tmp, "ckpt"), "--out_dir", os.path.join(tmp, "out"),
        "--platform", "gpu" if dev == "cuda" else "cpu", "--train_vq",
        "--synthetic", "--num_synthetic", str(MESH_CLI_VOLUMES),
        "--volume_size", str(spec["vq_size"]), "--val_perc",
        str(TRAIN_VQ_VAL), "--lbs", str(MESH_VQ_BATCH // n), "--epochs",
        "1", "--image_log_freq", "1",
        "--coordinator", f"127.0.0.1:{spec['cli_port']}",
        "--num_processes", str(n), "--process_id", str(rank)]
    mesh = MeshConfig(*MESH_PLANE)

    def preset(name):
        cfg = get_preset(name)
        return replace(cfg, train=replace(cfg.train, mesh=mesh))
    presets.get_preset = preset
    try:
        _sync(dev)
        _reset_launches()        # the main path's run starts here
        t0 = time.perf_counter()
        cli.main(argv)
        _sync(dev)
    finally:
        presets.get_preset = get_preset
    return dict(wall_s=time.perf_counter() - t0, launches=_launches())


def mesh_worker(spec_path: str, rank: str) -> None:
    """One process of a launch of the mesh phase: joins the others, makes
    the spec's meshes in order, plants the spec's fault (if any), runs
    the spec's steps and then, with "cli", the command line, and writes
    its numbers as JSON."""
    global SEED
    with open(spec_path) as f:
        spec = json.load(f)
    rank, SEED = int(rank), spec["seed"]
    dev, n = spec["device"], spec["processes"]
    if dev == "cuda":
        _build.load_all([attn.KERNEL, cbq.KERNEL])   # built by the parent
    out, port = {}, spec["port"]
    if spec.get("go"):
        # started while the launch before runs: warm up, then wait for the
        # file that says it has ended, which holds the coordinator's port
        t0 = time.perf_counter()
        _warm_up(dev)
        out["warm_up_s"] = time.perf_counter() - t0
        while not os.path.exists(spec["go"]):
            time.sleep(0.05)
        with open(spec["go"]) as f:
            port = int(f.read())
    pdist.initialize(f"127.0.0.1:{port}", n, rank,
                     platform="gpu" if dev == "cuda" else "cpu")
    try:
        out["backend"] = pdist.collective_backend()
        out["device"] = str(pdist.process_device())
        meshes = {tuple(shape): _make_mesh(shape)
                  for shape in spec["meshes"]}
        spec["float64_steps"] = {}     # this process's, `_s1_references`
        if spec["fault"]:
            _plant_fault(spec["fault"], meshes[MESH_PLANE])
        torch.backends.cudnn.deterministic = True
        for step in spec["steps"]:
            shape, run = MESH_STEPS[step]
            t0 = time.perf_counter()
            out[step] = run(spec, rank, meshes[shape])
            out[step]["wall_s"] = time.perf_counter() - t0
        torch.backends.cudnn.deterministic = False
    finally:
        pdist.shutdown()
    if spec["cli"]:
        if dev == "cuda":
            torch.cuda.empty_cache()
        out["cli"] = _mesh_cli(spec, rank)
    with open(os.path.join(spec["logs"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _warm_up(dev: str) -> None:
    """One latent step of the tiny flagship (`flagship_cfg(tiny=True)`)
    in one process, TF32 off and cuDNN deterministic as the mesh steps
    run: the libraries and code paths a first training step loads, loaded
    before the mesh's first step (uncounted; a few MB)."""
    if dev != "cuda":
        return
    torch.backends.cudnn.deterministic = True
    cfg = flagship_cfg(tiny=True)
    tr = DiffusionTrainer(cfg, device=dev, train_cfg=TrainConfig(
        batch_size=2, ema_decay=0.999, dtype=F32)).init_random(SEED, "reach")
    lat = torch.randn((2,) + (cfg.latent_size,) * 3
                      + (cfg.latent_channels,), device=dev)
    with _NoTF32():
        tr.train_step_latents(lat, torch.tensor([0, 1], device=dev))
        torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    _reset_launches()
    del tr, lat
    torch.cuda.empty_cache()


def _mesh_start(tmp: str, n: int, steps, cli_run: bool, check: bool,
                fault=None, **extra) -> tuple:
    """`n` --mesh-worker processes running `steps` (and the command line
    with `cli_run`; `extra` into their spec), started; their logs and
    numbers in a directory of `tmp` of their own."""
    ports = []
    while len(ports) < 2:
        port = pdist.free_port()
        ports += [] if port in ports else [port]
    meshes = []
    for step in steps:
        if MESH_STEPS[step][0] not in meshes:
            meshes.append(MESH_STEPS[step][0])
    if fault and MESH_PLANE not in meshes:
        meshes.insert(0, MESH_PLANE)
    logs = os.path.join(tmp, f"launch{n}")
    os.makedirs(logs, exist_ok=True)
    spec = dict(device=DDP_DEVICE, tiny=DDP_TINY, tmp=tmp, logs=logs,
                port=ports[0], cli_port=ports[1], processes=n, meshes=meshes,
                steps=steps, cli=cli_run, check=check, fault=fault,
                vq_flags=TRAIN_VQ_FLAGS, vq_size=TRAIN_VQ_SIZE, seed=SEED,
                **extra)
    path = os.path.join(logs, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return _start_workers("mesh", path, logs, n, MESH_TIMEOUT)


def phase_mesh(card: str, check: bool = False) -> dict:
    """Main path 12: the JAX package's multi-axis meshes. Launch A, four
    processes of this script on the one card: on data 2 x space 2 the
    flagship's stage-1 at 128^3 (global batch 4) and its latent step
    (global batch 8), on data 1 x space 4 its stage-1 (global batch 2)
    with remat full and off, each under the float64 gate, then one
    --train_vq epoch from the command line over the plane, its checkpoint
    restored in one process; launch B, eight processes: the latent step
    on data 2 x space 2 x model 2 under the gate, its bytes and peak per
    process. Launch B's processes start with launch A's, warm up and wait
    for it to end (`mesh_worker`); its rank 0 judges the plane's latent
    step beside the cube's (the same references). Each process zeroes
    its launch counters before each run of the main path and reads them
    after; the phase adds every process's. Then the kernels at the new
    per-process shapes. With `check` (--mesh-check) only the gated steps
    run, and their distances from float64 are printed, not judged."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ldm3d_mesh_")
    torch.cuda.empty_cache()
    steps_a = ["plane_stage1", "plane_stage2", "line_stage1",
               "line_stage1_remat_off"]
    go = os.path.join(tmp, "go")
    started_b = _mesh_start(tmp, 8, ["cube_stage2"], False, check,
                            judge=True, go=go)
    try:
        ranks_a = _wait_workers(_mesh_start(tmp, 4, steps_a, not check,
                                            check, defer=True))
        wall_a = time.perf_counter() - t_phase
        with open(go + ".tmp", "w") as f:
            f.write(str(pdist.free_port()))
        os.replace(go + ".tmp", go)
        t0 = time.perf_counter()
        ranks_b = _wait_workers(started_b)
        wall_b = time.perf_counter() - t0
        ranks_a[0]["plane_stage2"].update(
            ranks_b[0]["cube_stage2"].pop("deferred"))
        if check:
            for ranks, steps in ((ranks_a, steps_a),
                                 (ranks_b, ["cube_stage2"])):
                for step in steps:
                    say("mesh_check", part=step, seed=SEED,
                        result=ranks[0][step], card=card)
            return {}
        if DDP_DEVICE == "cuda":
            gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
            _attention_case(gen, card, "mesh_f32", 4, 32, 64, 512,
                            torch.float32)
            _codebook_timing(gen, card, "mesh_plane_f32", 512, 1024, 256,
                             torch.float32, False)
            _codebook_timing(gen, card, "mesh_line_f32", 256, 1024, 256,
                             torch.float32, False)
        return _mesh_report(card, ranks_a, ranks_b, tmp, dict(
            launch_a=wall_a, launch_b_after_a=wall_b,
            launch_b_warm_up=[r["warm_up_s"] for r in ranks_b],
            phase=time.perf_counter() - t_phase))
    finally:
        for p in started_b[4]:      # launch B's processes, if A failed
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in started_b[5]:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _mesh_restored(tmp: str) -> bool:
    """The plane's --train_vq checkpoint restores into a one-process
    trainer: one process's keys and shapes, every tensor finite."""
    cfg = cli.apply_overrides(get_preset(TRAIN_VQ_FLAGS[1]),
                              cli.build_parser().parse_args(TRAIN_VQ_FLAGS))
    path = os.path.join(tmp, "ckpt", cfg.name + "_vq")
    state, _ = CheckpointManager(path).restore(1)
    one = VQTrainer(cfg.vqvae, replace(cfg.train, dtype=F32),
                    device=DDP_DEVICE)
    want = {k: t.shape for k, t in one.model.state_dict().items()}
    one.load_state_dict(state)
    got = one.model.state_dict()
    ok = ({k: t.shape for k, t in got.items()} == want
          and all(bool(torch.isfinite(t).all()) for t in got.values()
                  if t.is_floating_point()))
    del one
    return ok


def _mesh_report(card, ranks_a, ranks_b, tmp, wall_s) -> dict:
    """The mesh phase's checks and lines; returns every process's launch
    counts."""
    on_card = DDP_DEVICE == "cuda"
    vq_cfg = cli.apply_overrides(get_preset(TRAIN_VQ_FLAGS[1]),
                                 cli.build_parser().parse_args(
                                     TRAIN_VQ_FLAGS))
    vtr, vva = train_val_split(MESH_CLI_VOLUMES, TRAIN_VQ_VAL,
                               vq_cfg.train.seed)
    steps = len(vtr) // MESH_VQ_BATCH
    val_batches = len(vva) // MESH_VQ_BATCH
    calls = ranks_a[0]["plane_stage2"]["attention_calls"]
    stage2 = {attn.KERNEL: calls, cbq.KERNEL: 0}
    stage1 = {attn.KERNEL: 0, cbq.KERNEL: 1}
    want = {"plane_stage2": stage2, "plane_stage1": stage1,
            "line_stage1": stage1, "line_stage1_remat_off": stage1,
            # a launch per train step, eval batch and montage
            "cli": {attn.KERNEL: 0, cbq.KERNEL: steps + val_batches + 1},
            "cube_stage2": stage2}
    if not on_card:   # the plain versions run on the CPU: no launches
        want = {k: {attn.KERNEL: 0, cbq.KERNEL: 0} for k in want}
    ranks_of = {k: ranks_b if k == "cube_stage2" else ranks_a for k in want}
    got = {k: [r[k]["launches"] for r in ranks_of[k]] for k in want}
    launches_ok = all(g == want[k] for k, gs in got.items() for g in gs)
    backend = sorted({r["backend"] for r in ranks_a + ranks_b})
    names = {MESH_PLANE: "data 2 x space 2", MESH_LINE: "data 1 x space 4",
             MESH_CUBE: "data 2 x space 2 x model 2"}

    def share(t):
        return (sum(t["collective_ms"].values())
                / t["instrumented_step_ms"])
    oks = {}
    for step in ("plane_stage2", "cube_stage2"):
        rs = [r[step] for r in ranks_of[step]]
        ref = rs[0]
        # every process against the first of its model coordinate (the
        # processes that hold the same tensors)
        first = {}
        for r in rs:
            first.setdefault(r["model_index"], r)
        equal = all(r[k] == first[r["model_index"]][k] for r in rs
                    for k in ("params", "ema", "loss", "noise_mse"))
        ratio = max(r["state_bytes"] for r in rs) / ref["state_bytes_1p"]
        oks[step] = (equal and ref["gate"]["ok"]
                     and ref["loss_rel_err"] <= DDP_LOSS_RTOL
                     and ref["stats_rel_err"] <= DDP_LOSS_RTOL
                     and (step != "cube_stage2"
                          or not on_card or (ref["sharded"] > 0
                                             and ratio < 1.0)))
        say("mesh", step=step, mesh=names[MESH_STEPS[step][0]],
            processes=len(rs), backend=backend, batch=DDP_BATCH,
            rows_per_process=ref["rows"], sharded_tensors=ref["sharded"],
            loss=ref["loss"], loss_1p=ref["loss_1p"],
            loss_rel_err=ref["loss_rel_err"], loss_tol=DDP_LOSS_RTOL,
            grad_gate=ref["gate"], float64_step_s=ref["float64_step_s"],
            seed=SEED, stats_rel_err=ref["stats_rel_err"],
            stats_tol=DDP_LOSS_RTOL, ranks_bitwise_equal=equal,
            first_step_ms=[r["first_step_ms"] for r in rs],
            step_ms=[r["timing"]["step_ms"] for r in rs],
            collective_share=[share(r["timing"]) for r in rs],
            timing=[r["timing"] for r in rs],
            state_bytes=[r["state_bytes"] for r in rs],
            state_bytes_one_process=ref["state_bytes_1p"],
            state_bytes_ratio=ratio,
            peak_bytes=[r["peak_bytes"] for r in rs],
            peak_bytes_one_process=ref["peak_bytes_1p"],
            peak_ratio=(max(r["peak_bytes"] for r in rs)
                        / ref["peak_bytes_1p"]) if on_card else None,
            wall_s=ref["wall_s"], parts_s=ref["parts_s"],
            launches=got[step], expected=want[step], ok=oks[step],
            card=card)
    for step in ("plane_stage1", "line_stage1", "line_stage1_remat_off"):
        rs = [r[step] for r in ranks_a]
        ref = rs[0]
        equal = all(r[k] == ref[k] for r in rs
                    for k in ("usage", "codebook", "params", "loss"))
        peak = max(r["peak_bytes"] for r in rs)
        ratio = peak / ref["twin_peak_bytes"] if on_card else None
        memory_ok = (step != "line_stage1_remat_off" or not on_card
                     or ratio < SPATIAL_MEMORY_RATIO)
        oks[step] = (equal and ref["gate"]["ok"] and memory_ok
                     and ref["loss_rel_err"] <= DDP_LOSS_RTOL
                     and ref["usage_equal_1p"])
        say("mesh", step=step, mesh=names[MESH_STEPS[step][0]],
            processes=len(rs), batch=(MESH_VQ_BATCH if step.startswith(
                "plane") else SPATIAL_VQ_BATCH), volume=TRAIN_VQ_SIZE,
            slab=ref["slab"], remat=ref["remat"], loss=ref["loss"],
            loss_1p=ref["loss_1p"], loss_rel_err=ref["loss_rel_err"],
            loss_tol=DDP_LOSS_RTOL, **_s1_gate_fields(ref),
            ranks_bitwise_equal=equal,
            first_step_ms=[r["first_step_ms"] for r in rs],
            step_ms=[r["timing"]["step_ms"] for r in rs],
            collective_share=[share(r["timing"]) for r in rs],
            timing=[r["timing"] for r in rs],
            peak_bytes=[r["peak_bytes"] for r in rs],
            peak_bytes_one_process=ref["twin_peak_bytes"],
            peak_ratio=ratio, peak_ratio_tol=(
                SPATIAL_MEMORY_RATIO if step == "line_stage1_remat_off"
                else None),
            wall_s=ref["wall_s"], parts_s=ref["parts_s"],
            launches=got[step], expected=want[step], ok=oks[step],
            card=card)
    ckpt = os.path.join(tmp, "ckpt")
    dirs = sorted(os.listdir(ckpt))
    log = _log_rows(os.path.join(ckpt, dirs[0], "training.log")) \
        if len(dirs) == 1 else []
    kept = CheckpointManager(os.path.join(ckpt, dirs[0])).all_epochs() \
        if len(dirs) == 1 else []
    restored = len(dirs) == 1 and _mesh_restored(tmp)
    oks["cli"] = (kept == [1] and len(log) == 1 and restored
                  and all(np.isfinite(list(row.values())).all()
                          for row in log))
    say("mesh", step="cli", flags=TRAIN_VQ_FLAGS,
        mesh=dict(zip(("data", "space", "model"), MESH_PLANE)),
        lbs=MESH_VQ_BATCH // len(ranks_a), volumes=MESH_CLI_VOLUMES,
        steps=steps, val_batches=val_batches, checkpoint_dirs=dirs,
        checkpoints=kept, restored_in_one_process=restored, log=log,
        wall_s=[r["cli"]["wall_s"] for r in ranks_a], launches=got["cli"],
        expected=want["cli"], ok=oks["cli"], card=card)
    counts = {attn.KERNEL: 0, cbq.KERNEL: 0}
    for gs in got.values():
        for g in gs:
            for k in counts:
                counts[k] += g[k]
    ok = all(oks.values()) and launches_ok
    say("mesh", backend=backend, launches=counts, wall_s=wall_s,
        steps_ok=oks, launches_ok=launches_ok, ok=ok, card=card)
    if not ok:
        raise RuntimeError(f"mesh: {oks}, launches {got} against {want}")
    return counts


def phase_mesh_gate_faults(card: str) -> None:
    """--mesh-gate-faults: each of MESH_GATE_FAULTS planted in launch A's
    four processes, its step alone under the float64 gate; each must fail
    the gate by S1_FAULT_MARGIN or more."""
    wrong = []
    for step, fault in MESH_GATE_FAULTS:
        tmp = tempfile.mkdtemp(prefix="ldm3d_mesh_gate_")
        try:
            ranks = _wait_workers(_mesh_start(tmp, 4, [step], False, True,
                                              fault))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        gate = ranks[0][step]["gate"]
        margin = _gate_margin(gate)
        ok = margin >= S1_FAULT_MARGIN
        say("mesh_gate_faults", step=step, fault=fault,
            gate_passed=gate["ok"], fails_by=margin,
            margin_tol=S1_FAULT_MARGIN, gate=gate, ok=ok, card=card)
        if not ok:
            wrong.append((step, fault))
    if wrong:
        raise RuntimeError(f"mesh_gate_faults: wrong verdicts for {wrong}")


def _whole_grads(kind: str, mesh):
    """A function of a module that gives its whole gradients on the CPU
    over a `kind` ("ddp", "spatial", "tp" or "mesh") mesh: each process's
    own, already reduced over the data axis or computed over depth slabs;
    gathered over a model axis (a collective)."""
    if kind in ("tp", "mesh"):
        return lambda unet: _tp_whole_grads(unet, mesh)
    return lambda unet: {n: p.grad.cpu() for n, p in unet.named_parameters()
                         if p.grad is not None}


def _s2_bf16(spec: dict, rank: int, mesh, whole_grads) -> dict:
    """(g) of the bf16 phase: the flagship latent step at global batch
    DDP_BATCH in bfloat16 over `mesh` (each process its rows of the batch
    over a data axis, the whole batch otherwise), and on rank 0 a
    one-process bfloat16 step of the same init and draws (TF32 off; the
    workers run cuDNN deterministic): the losses and the U-Net's
    gradients, whole (`whole_grads(unet)`, a collective under a model
    axis)."""
    from ldm3d_torch.parallel.mesh import shard_batch

    t0 = time.perf_counter()
    dev, inp = spec["device"], _ddp_s2_inputs(spec)
    tc = replace(inp["tc"], dtype=BF16)
    x, c = inp["lat"].to(dev), inp["ctx"].to(dev)
    tr = DiffusionTrainer(inp["cfg"], device=dev, train_cfg=tc,
                          mesh=mesh).init_random(SEED, "reach")
    with _NoTF32():
        _sync(dev)
        _reset_launches()        # the main path's step starts here
        m = tr.train_step_latents(*shard_batch(mesh, (x, c)), **inp["on"])
        _sync(dev)
        out = dict(loss=float(m["loss"]),
                   launches_by_dtype=dict(attn.launches_by_dtype),
                   attention_calls=attention_calls_per_step(tr.model.unet))
    grads = whole_grads(tr.model.unet)
    del tr
    pdist.barrier()
    if rank == 0:
        one = {}
        for dtype in (BF16, F32):
            tr1 = DiffusionTrainer(inp["cfg"], device=dev, train_cfg=replace(
                tc, dtype=dtype)).init_random(SEED, "reach")
            with _NoTF32():
                m1 = tr1.train_step_latents(x, c, **inp["on"])
                _sync(dev)
            one[dtype] = (float(m1["loss"]), {
                n: p.grad.float().cpu() for n, p in
                tr1.model.unet.named_parameters() if p.grad is not None})
            del tr1
        (loss_1p, ref), (_, ref32) = one[BF16], one[F32]

        def l2(a, b):
            diff = {n: float((a[n].float() - g).square().sum())
                    for n, g in b.items()}
            norm = sum(float(g.square().sum()) for g in b.values())
            return float(np.sqrt(sum(diff.values()) / norm)), \
                max(diff, key=diff.get)
        err, worst = l2(grads, ref)
        out.update(loss_1p=loss_1p,
                   loss_rel_err=abs(out["loss"] - loss_1p) / abs(loss_1p),
                   grad_rel_err=err, grad_worst=worst,
                   own_grad_rel_err=l2(ref, ref32)[0],
                   grad_rel_err_float32=l2(grads, ref32)[0],
                   grads_compared=len(ref), grads_sharded=len(grads))
        del one
    del grads
    pdist.barrier()
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def _bf16_s2_report(phase: str, ranks, card: str):
    """(g)'s line in `phase`: (ok, the steps' launch counts)."""
    steps = [r["stage2_bf16"] for r in ranks]
    ref = steps[0]
    want = dict(float32=0, bfloat16=ref["attention_calls"])
    on_card = DDP_DEVICE == "cuda"
    launches_ok = not on_card or all(s["launches_by_dtype"] == want
                                     for s in steps)
    grad_tol = BF16_S2_GRAD_FACTOR * ref["own_grad_rel_err"]
    ok = (launches_ok and ref["grads_compared"] == ref["grads_sharded"]
          and ref["loss_rel_err"] <= BF16_S2_LOSS_RTOL
          and ref["grad_rel_err"] <= grad_tol)
    say(phase, step="stage2_bf16", batch=DDP_BATCH, dtype=BF16,
        reference="one-process bfloat16 step", loss=ref["loss"],
        loss_1p=ref["loss_1p"], loss_rel_err=ref["loss_rel_err"],
        loss_tol=BF16_S2_LOSS_RTOL, grad_rel_err=ref["grad_rel_err"],
        grad_tol=grad_tol, grad_over_tol=ref["grad_rel_err"] / grad_tol,
        wall_s=ref["wall_s"], grad_worst=ref["grad_worst"],
        one_process_bf16_vs_float32=ref["own_grad_rel_err"],
        sharded_bf16_vs_float32=ref["grad_rel_err_float32"],
        launches_by_dtype=[s["launches_by_dtype"] for s in steps],
        expected=want, ok=ok, card=card)
    n = sum(s["launches_by_dtype"]["bfloat16"] for s in steps)
    return ok, {attn.KERNEL: n, attn.KERNEL + ".bfloat16": n}


def _plant_fault(fault: str, mesh=None) -> None:
    """Break this process's sharding on purpose (--bf16-gate-faults,
    --s1-gate-faults, --mesh-gate-faults; `mesh` the plane of the mesh
    phase's faults)."""
    from ldm3d_torch.models import layers
    from ldm3d_torch.parallel import halo, spatial, tp
    from ldm3d_torch.train import dm_trainer, vq_trainer
    if fault == "drop_halo_grad":       # the halos' gradients not sent back
        halo._return_halo_grads = lambda *a, **kw: None
    elif fault == "drop_halo_grad_32":  # the same, at 32-row slabs only
        send = halo._return_halo_grads

        def drop_at_32(g, g_lo, g_hi, left, right, dim, *a):
            if g.shape[dim] != 32:
                send(g, g_lo, g_hi, left, right, dim, *a)
        halo._return_halo_grads = drop_at_32
    elif fault == "partials_unsummed":  # each process keeps its partial
        tp.sum_partials = lambda y: y
    elif fault == "zero_halo":          # halos exchanged, zeros used
        exchange = halo._exchange

        def zero_halos(x, *a):
            lo, hi = exchange(x, *a)
            return torch.zeros_like(lo), torch.zeros_like(hi)
        halo._exchange = zero_halos
    elif fault == "column_grad_unsummed":   # not summed over the group
        tp._Copy.backward = staticmethod(lambda ctx, grad: (grad, None))
    elif fault == "grads_unreduced":    # each process keeps its own rows'
        dm_trainer.reduce_gradients = lambda *a, **kw: None
    elif fault == "grads_over_data_line":   # not over the whole plane
        def over_data(params, group, **kw):
            pdist.reduce_gradients(params, mesh.group("data"), **kw)
        dm_trainer.reduce_gradients = over_data
        vq_trainer.reduce_gradients = over_data
    elif fault == "bn_over_space_line":     # BatchNorm's over a slab line
        moments = layers._global_var_mean

        def over_space(x, dims, group):
            line = spatial.sharded()
            return moments(x, dims, group if line is None
                           else line.group("space"))
        layers._global_var_mean = over_space
    elif fault == "interior_right_halo_zero":   # at space 4 and more
        exchange = halo._exchange

        def zero_right(x, left, right, dim, reflect, index, count, group):
            lo, hi = exchange(x, left, right, dim, reflect, index, count,
                              group)
            if 0 < index < count - 1:
                hi = torch.zeros_like(hi)
            return lo, hi
        halo._exchange = zero_right
    else:
        raise ValueError(f"unknown fault {fault!r}")


def gate_worker(spec_path: str, rank: str) -> None:
    """One process of a --bf16-gate-faults or --s1-gate-faults run: the
    spec's step ("stage2_bf16": (g)'s; "stage1": the stage-1 step under
    its float64 gate) alone over the spec's mesh, with the spec's fault
    (if any) planted first."""
    global SEED
    with open(spec_path) as f:
        spec = json.load(f)
    rank, SEED = int(rank), spec["seed"]
    if spec["fault"]:
        _plant_fault(spec["fault"])
    dev = spec["device"]
    if dev == "cuda":
        _build.load_all([attn.KERNEL, cbq.KERNEL])   # built by the parent
    pdist.initialize(f"127.0.0.1:{spec['port']}", 2, rank,
                     platform="gpu" if dev == "cuda" else "cpu")
    try:
        torch.backends.cudnn.deterministic = True
        mesh = {"ddp": _ddp_mesh, "spatial": _spatial_mesh,
                "tp": _tp_mesh}[spec["mesh"]]()
        if spec["step"] == "stage2_bf16":
            out = {"stage2_bf16": _s2_bf16(
                spec, rank, mesh, _whole_grads(spec["mesh"], mesh))}
        else:
            out = {"stage1": _s1_sharded_step(spec, rank, mesh,
                                              spec["mesh"])[0]}
    finally:
        pdist.shutdown()
    with open(os.path.join(spec["tmp"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _gate_margin(gate: dict) -> float:
    """How far a float64 gate's sharded step lies past its limit: the
    largest distance over limit of its groups and its whole model."""
    return max(g["sharded"] / g["limit"]
               for g in gate["groups"] + [gate["model"]])


def phase_gate_faults(card: str, step: str, faults) -> None:
    """A gate against planted faults: for each (mesh, fault) of `faults`
    the `step` ("stage2_bf16": (g)'s step and gate; "stage1": the stage-1
    step under its float64 gate) over that mesh; the clean step must pass
    its gate, each fault fail it (stage 1: by S1_FAULT_MARGIN or more)."""
    wrong, phase = [], ("bf16_gate_faults" if step == "stage2_bf16"
                        else "s1_gate_faults")
    for mesh, fault in faults:
        tmp = tempfile.mkdtemp(prefix="ldm3d_gate_")
        try:
            spec = dict(device=DDP_DEVICE, tiny=DDP_TINY, tmp=tmp,
                        port=pdist.free_port(), seed=SEED, mesh=mesh,
                        fault=fault, step=step, vq_flags=TRAIN_VQ_FLAGS,
                        vq_size=TRAIN_VQ_SIZE)
            path = os.path.join(tmp, "spec.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            ranks = _run_workers("gate", path, tmp, 2, DDP_TIMEOUT)
            if step == "stage2_bf16":
                passed, _ = _bf16_s2_report(phase, ranks, card)
                ok, detail = passed == (fault is None), {}
            else:
                gate = ranks[0]["stage1"]["gate"]
                passed, margin = gate["ok"], _gate_margin(gate)
                ok = passed if fault is None else margin >= S1_FAULT_MARGIN
                detail = dict(fails_by=margin, margin_tol=S1_FAULT_MARGIN,
                              gate=gate, float64_codes_changed=ranks[0][
                                  "stage1"]["float64_codes_changed"])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        say(phase, mesh=mesh, fault=fault, gate_passed=passed, ok=ok,
            **detail, card=card)
        if not ok:
            wrong.append((mesh, fault))
    if wrong:
        raise RuntimeError(f"{phase}: wrong verdicts for {wrong}")


def _dtype_census(unet: UNet3D, *args) -> dict:
    """The output dtype of every module of `unet` on one forward: the
    counts by dtype and the modules that are not bfloat16. flax's census
    of the JAX U-Net at bfloat16 has one float32 output, the sinusoidal
    time embedding (tests/test_torch_bf16.py holds the port to it)."""
    seen = {}

    def hook(name):
        def record(module, inputs, output):
            seen.setdefault(name, str(output.dtype).removeprefix("torch."))
        return record
    handles = [m.register_forward_hook(hook(n))
               for n, m in unet.named_modules() if n]
    try:
        with torch.no_grad():
            out = unet(*args)
    finally:
        for h in handles:
            h.remove()
    counts = {d: list(seen.values()).count(d) for d in set(seen.values())}
    return dict(counts=counts, output=str(out.dtype).removeprefix("torch."),
                not_bfloat16=sorted(n for n, d in seen.items()
                                    if d != "bfloat16"))


def _bf16_unet(f32: DiffusionTrainer, bf: DiffusionTrainer, card: str):
    """(a) One full-width U-Net forward at the served batch, bfloat16
    against the card's own float32 one (TF32 off), and the bfloat16 U-Net's
    dtype census; its and the float32 U-Net's step times at batch 16 and
    32 with cuDNN's default algorithms, and at batch 16 with its
    deterministic ones."""
    cfg = f32.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    out = {}
    for num in (REQUESTS[0]["num"], 2 * REQUESTS[0]["num"]):
        x = torch.randn(_latent_shape(cfg, num), generator=gen,
                        device="cuda")
        t = torch.randint(0, cfg.timesteps, (num,), generator=gen,
                          device="cuda")
        c = torch.randint(0, cfg.unet.context_dim + 1, (num,),
                          generator=gen, device="cuda")
        with torch.no_grad():
            steps = {tr.train_cfg.dtype: cuda_ms(
                partial(tr.model.unet, x, t, c), 30, warmup=5)
                for tr in (f32, bf)}
        out[f"unet_step_ms_batch{num}"] = steps
        if num != REQUESTS[0]["num"]:
            continue
        # (b) times its requests with cuDNN's deterministic algorithms:
        # the served step's cost of that choice, in each dtype
        torch.backends.cudnn.deterministic = True
        try:
            with torch.no_grad():
                out[f"unet_step_ms_batch{num}_cudnn_deterministic"] = {
                    tr.train_cfg.dtype: cuda_ms(partial(
                        tr.model.unet, x, t, c), 30, warmup=5)
                    for tr in (f32, bf)}
        finally:
            torch.backends.cudnn.deterministic = False
        with torch.no_grad(), _NoTF32():
            y32 = f32.model.unet(x, t, c)
            ybf = bf.model.unet(x, t, c)
        out["rel_err"] = float((ybf.float() - y32).abs().max()
                               / y32.abs().max())
        out["census"] = _dtype_census(bf.model.unet, x, t, c)
    census = out["census"]
    ok = (out["rel_err"] <= BF16_UNET_REL_TOL
          and census["not_bfloat16"] == ["time_embedding"]
          and census["output"] == "bfloat16")
    say("bf16", step="unet", batch=REQUESTS[0]["num"],
        reference="card float32, TF32 off", tol=BF16_UNET_REL_TOL, ok=ok,
        **out, card=card)
    if not ok:
        raise RuntimeError(f"bf16 unet: rel_err {out['rel_err']}, census "
                           f"{census}")
    return out


def _bf16_serve(bf: DiffusionTrainer, card: str) -> tuple:
    """(b) The served request as the JAX main path runs it (bench.py):
    batch 16, T = 500 DDPM, decoded, bfloat16, and its repeat; (c) a
    guided DDIM 50 request. All three with cuDNN's global defaults, as the
    float32 serve phase's requests (`generate` itself decodes with the
    deterministic algorithms, so that the repeat holds). Every attention
    launch bfloat16, the codebook kernel never."""
    svc = GenerationService(bf.cfg, bf, name="flagship_bf16")
    per_step = attention_calls_per_step(bf.model.unet)
    outs, n_bf, walls = [], 0, []
    _reset_launches()          # the bf16 main path starts here
    for req in REQUESTS + [BF16_GUIDED]:
        before = dict(attn.launches_by_dtype)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vols = svc.generate(**req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: attn.launches_by_dtype[k] - before[k] for k in before}
        steps = req.get("sample_steps") or bf.cfg.timesteps
        finite = bool(np.isfinite(vols).all())
        say("bf16", step="serve", request=req, wall_s=wall,
            cudnn_deterministic=torch.backends.cudnn.deterministic,
            vol_per_min=60.0 * req["num"] / wall,
            attention_launches_by_dtype=got,
            expected=dict(float32=0, bfloat16=per_step * steps),
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            finite=finite, std=float(vols.std()), card=card)
        if not finite or got != dict(float32=0, bfloat16=per_step * steps):
            raise RuntimeError(f"bf16 serve {req}: finite {finite}, "
                               f"launches {got}")
        n_bf += got["bfloat16"]
        outs.append(vols)
        walls.append(wall)
    codebook = cbq.launches
    rel = float(np.abs(outs[1] - outs[0]).max() / np.abs(outs[0]).max())
    say("bf16", step="serve", repeat_rel_err=rel, tol=REPEAT_REL_TOL,
        attention_launches=attn.launches, codebook_launches=codebook)
    if rel > REPEAT_REL_TOL or codebook != 0 or attn.launches != n_bf:
        raise RuntimeError(f"bf16 serve: repeat rel_err {rel}, codebook "
                           f"launches {codebook}")
    return {attn.KERNEL: n_bf, attn.KERNEL + ".bfloat16": n_bf,
            cbq.KERNEL: 0}, walls[0]


def _bf16_v_request(f32: DiffusionTrainer, bf: DiffusionTrainer,
                    card: str) -> dict:
    """(c) continued: V_REQUEST, a v-prediction DDIM 50 request, through
    v-prediction twins of the same weights (`_v_twin`): in bfloat16 and
    its seeded repeat (counted: every attention launch bfloat16, the
    codebook kernel never), and in float32 beside it (uncounted), with
    the bfloat16 answer's distance from the float32 one."""
    per_step = attention_calls_per_step(bf.model.unet)
    want = dict(float32=0, bfloat16=per_step * V_REQUEST["sample_steps"])
    cfg = dataclasses.replace(bf.cfg, prediction_type="v")

    def serve_v(svc) -> tuple:
        """(volumes, attention launches by dtype, codebook launches)."""
        before, codebook = dict(attn.launches_by_dtype), cbq.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vols = svc.generate(**V_REQUEST)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: attn.launches_by_dtype[k] - before[k] for k in before}
        say("bf16", step="serve_v", dtype=svc.trainer.train_cfg.dtype,
            request=V_REQUEST, prediction_type="v", wall_s=wall,
            vol_per_min=60.0 * V_REQUEST["num"] / wall,
            attention_launches_by_dtype=got,
            codebook_launches=cbq.launches - codebook,
            finite=bool(np.isfinite(vols).all()), std=float(vols.std()),
            card=card)
        return vols, got, cbq.launches - codebook

    svc = GenerationService(cfg, _v_twin(bf), name="flagship-v")
    runs = [serve_v(svc), serve_v(svc)]
    del svc
    torch.cuda.empty_cache()
    svc = GenerationService(cfg, _v_twin(f32), name="flagship-v")
    (a, _, _), (b, _, _), (c, _, _) = runs + [serve_v(svc)]
    del svc
    torch.cuda.empty_cache()
    rel = float(np.abs(b - a).max() / np.abs(a).max())
    vs32 = float(np.abs(a - c).max() / np.abs(c).max())
    ok = rel <= REPEAT_REL_TOL and all(
        np.isfinite(v).all() and got == want and codebook == 0
        for v, got, codebook in runs)
    say("bf16", step="serve_v", repeat_rel_err=rel, tol=REPEAT_REL_TOL,
        bf16_vs_float32_rel=vs32, expected=want, ok=ok, card=card)
    if not ok:
        raise RuntimeError(f"bf16 serve_v: repeat rel_err {rel}, launches "
                           f"{[r[1:] for r in runs]}")
    n = 2 * want["bfloat16"]
    return {attn.KERNEL: n, attn.KERNEL + ".bfloat16": n, cbq.KERNEL: 0}


def _decode_cost(f32: DiffusionTrainer, bf: DiffusionTrainer,
                 walls: dict, card: str) -> None:
    """What the deterministic decode costs a served request: the decode of
    one request's latents in each dtype, DECODE_RUNS times with cuDNN's
    default algorithms and as many with the deterministic ones, in turns
    (uncounted), against the request's wall time (`walls`, by dtype); and
    whether each setting's decodes repeat bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 65)
    lat = torch.randn(_latent_shape(f32.cfg, REQUESTS[0]["num"]),
                      generator=gen, device="cuda") * f32.cfg.latent_scale
    out = {}
    for tr in (f32, bf):
        ms = {"default": [], "deterministic": []}
        vols = {}
        with torch.no_grad():
            for _ in range(DECODE_RUNS):
                for name in ms:
                    with _setting(torch.backends.cudnn, "deterministic",
                                  name == "deterministic"):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        v = tr.model.decode(lat)
                        torch.cuda.synchronize()
                    ms[name].append(1e3 * (time.perf_counter() - t0))
                    vols.setdefault(name, []).append(v.float())
        cost = float(np.median(ms["deterministic"]) - np.median(
            ms["default"]))
        dtype = tr.train_cfg.dtype
        out[dtype] = dict(
            decode_ms=ms, cost_ms=cost,
            cost_of_request=(cost / (1e3 * walls[dtype])
                             if walls[dtype] else None),
            repeats_bitwise={k: all(torch.equal(x, v[0]) for x in v[1:])
                             for k, v in vols.items()})
        del vols
    say("bf16", step="decode_cost", runs=DECODE_RUNS,
        request_wall_s=walls, **out, card=card)


def _bf16_train(f32: DiffusionTrainer, card: str) -> dict:
    """(d) BF16_TRAIN_STEPS latent steps at batch TRAIN_BATCH in bfloat16
    and in float32 from one state and one set of draws: the first step's
    losses, then each dtype's step ms and peak memory."""
    cfg = f32.cfg
    rng = np.random.default_rng(SEED + 61)
    shape = _latent_shape(cfg, TRAIN_BATCH)
    lat = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ctx = torch.from_numpy(rng.integers(0, cfg.unet.context_dim + 1,
                                        TRAIN_BATCH))
    draws = dict(t=torch.from_numpy(rng.integers(0, cfg.timesteps,
                                                 TRAIN_BATCH)),
                 noise=torch.from_numpy(rng.standard_normal(shape).astype(
                     np.float32)),
                 drop=torch.from_numpy(rng.random(TRAIN_BATCH)
                                       < cfg.unet.cfg_dropout))
    draws = {k: v.cuda() for k, v in draws.items()}
    out, counts = {}, {}
    for dtype in (BF16, F32):
        tc = TrainConfig(batch_size=TRAIN_BATCH, ema_decay=0.999, seed=SEED,
                         dtype=dtype)
        tr = DiffusionTrainer(cfg, device="cuda", train_cfg=tc)
        tr.model.load_state_dict(f32.model.state_dict())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        for _ in range(BF16_TRAIN_STEPS):
            m, wall, got = _counted(counts.setdefault(dtype, {
                attn.KERNEL: 0, cbq.KERNEL: 0}), tr.train_step_latents,
                lat.cuda(), ctx.cuda(), **draws)
            walls.append(1e3 * wall)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        out[dtype] = dict(step_ms=walls, losses=losses,
                          max_memory_allocated=peak,
                          launches=counts[dtype],
                          attention_by_dtype=dict(attn.launches_by_dtype))
        del tr
        torch.cuda.empty_cache()
    rel = abs(out[BF16]["losses"][0] - out[F32]["losses"][0]) \
        / abs(out[F32]["losses"][0])
    want = attention_calls_per_step(f32.model.unet)
    ok = (rel <= BF16_TRAIN_LOSS_RTOL
          and out[BF16]["attention_by_dtype"] == dict(float32=0,
                                                      bfloat16=want)
          and all(np.isfinite(out[BF16]["losses"])))
    say("bf16", step="train", batch=TRAIN_BATCH, loss_rel_err=rel,
        tol=BF16_TRAIN_LOSS_RTOL, ok=ok, **out, card=card)
    if not ok:
        raise RuntimeError(f"bf16 train: loss rel_err {rel}, {out[BF16]}")
    n = counts[BF16][attn.KERNEL]
    return {attn.KERNEL: n, attn.KERNEL + ".bfloat16": n, cbq.KERNEL: 0}


def _bf16_stage1(card: str) -> dict:
    """(e) The flagship stage-1 step at batch TRAIN_VQ_LBS, 128^3, remat
    full and off, in bfloat16: ms and peak memory (train_vq times the
    float32 step in the same run); the codebook kernel is launched once
    per step, on float32 only, counted over every timed step."""
    args = cli.build_parser().parse_args(TRAIN_VQ_FLAGS)
    cfg = cli.apply_overrides(get_preset(args.preset), args)
    rng = np.random.default_rng(SEED + 62)
    vol, mask = _vq_batch(rng, TRAIN_VQ_LBS, TRAIN_VQ_SIZE, "cuda")
    out, launched = {}, 0
    tc = replace(cfg.train, batch_size=TRAIN_VQ_LBS, dtype=BF16)
    tr = VQTrainer(cfg.vqvae, tc, device="cuda").init_random(SEED, "reach")
    tr.train_step(vol, mask)     # Adam's state, cuDNN's set-up
    for name, kw in (("remat_full", dict(remat=True,
                                         remat_policy="full")),
                     ("remat_off", dict(remat=False))):
        out[name] = r = _remat_steps(tr, vol, mask, REMAT_STEPS, **kw)
        launched += r["launches"][cbq.KERNEL]
    del tr
    torch.cuda.empty_cache()
    want = dict(float32=REMAT_STEPS, bfloat16=0)
    ok = all(r["codebook_by_dtype"] == want
             and r["launches"] == {attn.KERNEL: 0, cbq.KERNEL: REMAT_STEPS}
             and np.isfinite(r["metrics"]["loss"]) for r in out.values())
    say("bf16", step="stage1", batch=TRAIN_VQ_LBS, volume=TRAIN_VQ_SIZE,
        expected_codebook_by_dtype=want, ok=ok, **out, card=card)
    if not ok:
        raise RuntimeError(f"bf16 stage1: {out}")
    return {attn.KERNEL: 0, cbq.KERNEL: launched}


def _bf16_gan(card: str) -> dict:
    """(f) One vqgan_attn step of each program (warm, adversarial) at its
    batch, 128^3, in bfloat16: ms (after an untimed first step) and peak
    memory (train_gan times the float32 steps in the same run)."""
    args = cli.build_parser().parse_args(GAN_FLAGS)
    cfg = cli.apply_overrides(get_preset(args.preset), args)
    size = cfg.data.volume_size
    rng = np.random.default_rng(SEED + 63)
    vol, mask = _vq_batch(rng, cfg.train.batch_size, size, "cuda")
    out, launched = {}, 0
    for program, warm in (("warm", True), ("adversarial", False)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # the LPIPS surrogate
            tr = GANTrainer(cfg.vqgan, replace(cfg.train, dtype=BF16),
                            device="cuda", volume_size=size) \
                .init_random(SEED, "reach")
        tr.epoch = 0 if warm else cfg.vqgan.disc_threshold
        tr.train_step(vol, mask, warm=warm)
        torch.cuda.reset_peak_memory_stats()
        m, wall, got = _counted({attn.KERNEL: 0, cbq.KERNEL: 0},
                                tr.train_step, vol, mask, warm=warm)
        out[program] = dict(
            step_ms=1e3 * wall, launches=got,
            codebook_by_dtype=dict(cbq.launches_by_dtype),
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            loss=float(m["loss"]))
        launched += got[cbq.KERNEL]
        del tr
        torch.cuda.empty_cache()
    ok = all(np.isfinite(r["loss"]) and r["codebook_by_dtype"]["bfloat16"]
             == 0 for r in out.values())
    say("bf16", step="vqgan_attn", batch=cfg.train.batch_size, volume=size,
        ok=ok, **out, card=card)
    if not ok:
        raise RuntimeError(f"bf16 vqgan_attn: {out}")
    return {attn.KERNEL: 0, cbq.KERNEL: launched}


def phase_bf16(card: str, attn_cases: Dict[str, dict],
               f32_wall: float = None) -> dict:
    """Main path 11: the JAX default compute dtype. The attention kernel in
    bfloat16 at the main path's shapes (where the kernel phase has not
    measured them), then (a) to (f) above, and after (b) the deterministic
    decode's cost against each dtype's served request (`f32_wall`, the
    serve phase's, when it ran); (g) runs inside the ddp, spatial and tp
    phases. Returns the launch counts of its main-path pieces, each read
    right after it (the float32 twins' launches are not counted)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 64)
    for case in BF16_ATTN_SHAPES:
        if case[0] not in attn_cases:
            attn_cases[case[0]] = _attention_case(gen, card, *case)
    cfg = flagship_cfg()
    f32 = DiffusionTrainer(cfg, device="cuda",
                           train_cfg=TrainConfig(dtype=F32)).init_random(
        SEED, "reach")
    bf = DiffusionTrainer(cfg, device="cuda")       # TrainConfig(): bf16
    bf.model.load_state_dict(f32.model.state_dict())
    say("bf16", dtype=bf.train_cfg.dtype, params=str(
        next(bf.model.parameters()).dtype), card=card)
    _bf16_unet(f32, bf, card)
    counts, wall = _bf16_serve(bf, card)
    v_counts = _bf16_v_request(f32, bf, card)
    _decode_cost(f32, bf, {F32: f32_wall, BF16: wall}, card)
    phase_serve_profile(bf, card, phase="bf16_serve_profile")
    del bf
    torch.cuda.empty_cache()
    train = _bf16_train(f32, card)
    del f32
    torch.cuda.empty_cache()
    stage1 = _bf16_stage1(card)
    gan = _bf16_gan(card)
    total = {k: sum(c.get(k, 0) for c in (counts, v_counts, train, stage1,
                                          gan))
             for k in (attn.KERNEL, attn.KERNEL + ".bfloat16", cbq.KERNEL)}
    say("bf16", launches=total, wall_s=time.perf_counter() - t0, card=card)
    return total


def _kernel_line(name, source, replaces, counts, case, library,
                 bf16_cases=()):
    """The kernel's entry of the `kernels` line: its launches on the main
    paths (by path, and by dtype: the bf16 phase's pieces count their
    bfloat16 launches, every other phase computes in float32), the
    numbers of `case`, and those of its bfloat16 cases."""
    total = sum(c.get(name, 0) for c in counts.values())
    bf16 = sum(c.get(name + ".bfloat16", 0) for c in counts.values())
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": total,
        "launches_by_dtype": {"float32": total - bf16, "bfloat16": bf16},
        "launches_by_path": {p: c.get(name, 0) for p, c in counts.items()},
        "bfloat16_cases": {c["shape"][0]: {k: c[k] for k in (
            "shape", "max_abs_err", "ms", "eager_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")} for c in bf16_cases},
        "max_abs_err": case["max_abs_err"],
        "ms": case["ms"], "kernel_ms": case["ms"],
        "eager_ms": case["eager_ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_us": 1e3 * case["bound_ms"],
        "bound_by": case["bound_by"], "fma_bound_ms": case["fma_bound_ms"],
        "library_ms": case["library_ms"],
        "library": library, "shape": case["shape"], "dtype": case["dtype"],
    }


def main() -> None:
    global SEED
    t_start = time.perf_counter()
    argv = sys.argv[1:]
    if "--seed" in argv:
        SEED = int(argv[argv.index("--seed") + 1])
    card = phase_device()
    phase_build()
    if "--gan-compare-check" in sys.argv[1:]:
        _gan_compare(card, GAN_CHECK_SIZE, check=True)
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    if "--ddp-check" in sys.argv[1:]:
        phase_ddp(card, {}, check=True)
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    if "--spatial-check" in sys.argv[1:]:
        phase_spatial(card, check=True)
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    if "--tp-check" in sys.argv[1:]:
        phase_tp(card, check=True)
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    if "--bf16-check" in sys.argv[1:]:
        phase_bf16(card, {})
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    if "--bf16-gate-faults" in sys.argv[1:]:
        phase_gate_faults(card, "stage2_bf16", BF16_GATE_FAULTS)
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    if "--s1-gate-faults" in sys.argv[1:]:
        phase_gate_faults(card, "stage1", S1_GATE_FAULTS)
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    if "--mesh-check" in sys.argv[1:]:
        phase_mesh(card, check=True)
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    if "--mesh-gate-faults" in sys.argv[1:]:
        phase_mesh_gate_faults(card)
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    if "--train-compare-check" in sys.argv[1:]:
        train = phase_train(card)
        phase_train_compare_check(train["trainer"], train["latents"])
        say("done", wall_s=time.perf_counter() - t_start, card=card)
        return
    attn_cases = phase_kernel(card)
    cb_cases = phase_codebook(card)
    phase_kernel_shapes()
    phase_attention_grad()
    phase_init(card)
    trainer = DiffusionTrainer(flagship_cfg(), device="cuda",
                               train_cfg=TrainConfig(dtype=F32)).init_random(
        SEED, "reach")
    phase_unet_step(trainer)
    svc = GenerationService(trainer.cfg, trainer, name="flagship")
    counts = {}
    counts["serve"], serve_wall = phase_serve(svc, card)
    phase_breakdown(trainer, attn_cases["self_f32"])
    phase_serve_profile(trainer, card)
    counts["serve_samplers"] = phase_serve_samplers(svc, card)
    phase_sampler_compare(trainer)
    counts["fidelity"] = phase_fidelity(trainer, card)
    del svc, trainer
    torch.cuda.empty_cache()
    counts["bf16"] = phase_bf16(card, attn_cases, serve_wall)
    torch.cuda.empty_cache()
    phase_encode()
    phase_quantizers()
    train = phase_train(card)
    counts["train"] = train["counts"]
    phase_train_compare(train["trainer"], train["latents"])
    phase_train_breakdown(train, attn_cases["train_f32"])
    del train
    torch.cuda.empty_cache()
    cli_run = phase_cli(card)
    counts["cli"] = cli_run["counts"]
    torch.cuda.empty_cache()
    counts["train_vq"] = phase_train_vq(card)
    torch.cuda.empty_cache()
    counts["ddp"] = phase_ddp(card, cli_run["train_log"])
    torch.cuda.empty_cache()
    counts["spatial"] = phase_spatial(card)
    torch.cuda.empty_cache()
    counts["tp"] = phase_tp(card)
    torch.cuda.empty_cache()
    counts["mesh"] = phase_mesh(card)
    torch.cuda.empty_cache()
    counts["train_gan"] = phase_train_gan(card)
    kernels = [
        _kernel_line(attn.KERNEL, "ldm3d_torch/csrc/voxel_attention.cu",
                     "ldm3d/ops/attention.py:38", counts,
                     attn_cases["self_f32"],
                     "torch.nn.functional.scaled_dot_product_attention",
                     [attn_cases[c[0]] for c in BF16_ATTN_SHAPES]),
        _kernel_line(cbq.KERNEL, "ldm3d_torch/csrc/codebook_nearest.cu",
                     "ldm3d/ops/quantize.py:48", counts,
                     cb_cases["train_f32"],
                     "torch.addmm + torch.argmin (plain version's two "
                     "library calls)"),
    ]
    say("done", wall_s=time.perf_counter() - t_start, card=card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(*sys.argv[2:])
    elif sys.argv[1:2] == ["--spatial-worker"]:
        spatial_worker(*sys.argv[2:])
    elif sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(*sys.argv[2:])
    elif sys.argv[1:2] == ["--gate-worker"]:
        gate_worker(*sys.argv[2:])
    elif sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(*sys.argv[2:])
    else:
        main()

"""train_meta.json: the sampling invariants a trained checkpoint records,
written by the training CLI beside its checkpoints and adopted by the
training CLI, the serve CLI and the tools for every flag the user did not
pass. The file's keys and values are those of the JAX package's CLI.

Also the port's copies of what the JAX package's `bench.py` reads from a
`--train_dm` run directory: the best-latent-FID epoch (`best_fid_epoch`)
and that epoch's logged fidelity (`fidelity_from_jsonl`), both from the
run's `metrics.jsonl`."""

from __future__ import annotations

import json
import os
from typing import Optional

from ldm3d_torch.core.config import replace


def train_meta(cfg) -> dict:
    """The sampling invariants a restore must rebuild (train_meta.json)."""
    d, u = cfg.diffusion, cfg.diffusion.unet
    return {"latent_scale": d.latent_scale,
            "clip_sample_range": d.clip_sample_range,
            "timesteps": d.timesteps,
            "prediction_type": d.prediction_type,
            "context_in_time": u.context_in_time,
            "cfg_dropout": u.cfg_dropout,
            "context_dim": u.context_dim,
            "ema_decay": float(cfg.train.ema_decay),
            "unet_stem": u.first_conv_channels,
            "unet_widths": list(u.widths),
            "unet_attention": list(u.has_attention)}


def load_meta(path: str) -> dict:
    """The train_meta.json at `path`; {} when it is missing or
    unreadable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def adopt_meta(cfg, args, meta: dict):
    """Adopt a trained checkpoint's sampling invariants from `meta` (a
    train_meta.json's, `load_meta`, or a snapshot's) for every flag the
    user did NOT pass: latent_scale, clip_sample_range, timesteps,
    prediction_type, context_in_time, cfg_dropout, context_dim, the
    U-Net's stem, widths and attention, ema_decay. `args` may lack any of
    those flags (the serve CLI has fewer; an empty `argparse.Namespace`
    adopts every one)."""
    def unset(flag):
        return getattr(args, flag, None) is None

    diff, unet, train = cfg.diffusion, cfg.diffusion.unet, cfg.train
    adopted = []
    if unset("latent_scale") and "latent_scale" in meta:
        diff = replace(diff, latent_scale=float(meta["latent_scale"]))
        adopted.append(f"latent_scale={meta['latent_scale']:.4f}")
    if unset("clip_sample_range") and "clip_sample_range" in meta:
        diff = replace(diff,
                       clip_sample_range=float(meta["clip_sample_range"]))
        adopted.append(f"clip_sample_range={meta['clip_sample_range']:g}")
    if unset("timesteps") and "timesteps" in meta:
        diff = replace(diff, timesteps=int(meta["timesteps"]))
        adopted.append(f"timesteps={meta['timesteps']}")
    if unset("prediction_type") and "prediction_type" in meta:
        diff = replace(diff, prediction_type=meta["prediction_type"])
    if unset("context_in_time") and meta.get("context_in_time"):
        unet = replace(unet, context_in_time=True)
        adopted.append("context_in_time")
    if unset("cfg_dropout") and "cfg_dropout" in meta:
        unet = replace(unet, cfg_dropout=float(meta["cfg_dropout"]))
    if (unset("num_classes") and "context_dim" in meta
            and meta["context_dim"] != unet.context_dim):
        unet = replace(unet, context_dim=int(meta["context_dim"]))
        adopted.append(f"context_dim={meta['context_dim']}")
    if unset("unet_stem") and "unet_stem" in meta:
        unet = replace(unet, first_conv_channels=int(meta["unet_stem"]))
    if unset("unet_widths") and "unet_widths" in meta:
        unet = replace(unet, widths=tuple(int(w)
                                          for w in meta["unet_widths"]))
        adopted.append("unet_widths=" + ",".join(
            str(w) for w in meta["unet_widths"]))
    if unset("unet_attention") and "unet_attention" in meta:
        unet = replace(unet, has_attention=tuple(
            bool(v) for v in meta["unet_attention"]))
    if unset("ema_decay") and "ema_decay" in meta:
        train = replace(train, ema_decay=float(meta["ema_decay"]))
        if meta["ema_decay"]:
            adopted.append(f"ema_decay={meta['ema_decay']:g}")
    diff = replace(diff, unet=unet)
    if adopted:
        print("adopted from train_meta.json: " + ", ".join(adopted))
    return replace(cfg, diffusion=diff, train=train)


def _fidelity_rows(path: str):
    """The records of `{path}/metrics.jsonl` that hold a latent_fid, in
    order; none when the file is missing (unreadable lines skipped)."""
    try:
        with open(os.path.join(path, "metrics.jsonl")) as f:
            lines = f.readlines()
    except OSError:
        return
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if "latent_fid" in rec:
            yield rec


def best_fid_epoch(path: str) -> Optional[int]:
    """The checkpointed epoch of the `--train_dm` run in `path` with the
    lowest logged latent-FID, or None (= the latest) when no fidelity row
    matches a saved epoch. Fidelity rows log `step` = epoch - 1 (the end
    of epoch step + 1). The port of `bench._best_fid_epoch`."""
    from ldm3d_torch.train.checkpoint import CheckpointManager

    saved = CheckpointManager(path, write=False)
    best = None
    for rec in _fidelity_rows(path):
        if "step" not in rec:
            continue
        ep = int(rec["step"]) + 1
        if os.path.exists(saved.path(ep)) and (
                best is None or rec["latent_fid"] < best[1]):
            best = (ep, rec["latent_fid"])
    return best[0] if best else None


def fidelity_from_jsonl(path: str, epoch: int) -> dict:
    """The logged fidelity (`--fidelity_freq`) of `epoch` of the run in
    `path`, or else of its first fidelity row: latent_fid, its epoch, the
    sampler it was scored with ("ddim-T": the training loop's probe), and
    fid_class_sep and latent_mmd where logged; {} without fidelity rows.
    The port of `bench._fidelity_from_jsonl`."""
    out = {}
    for rec in _fidelity_rows(path):
        if int(rec.get("step", -2)) + 1 == epoch or not out:
            out = {"latent_fid": round(rec["latent_fid"], 2),
                   "latent_fid_epoch": int(rec.get("step", -1)) + 1,
                   "latent_fid_sampler": "ddim-T"}
            if "fid_class_sep" in rec:
                out["fid_class_sep"] = round(rec["fid_class_sep"], 3)
            if "latent_mmd" in rec:
                out["latent_mmd"] = round(rec["latent_mmd"], 3)
    return out

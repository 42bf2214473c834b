"""Volume-generation service: the port of `ldm3d.serve`.

One model on one device answers requests, in process or over HTTP:

    svc = GenerationService.from_random_init(flagship_cfg(), seed=0)
    vols = svc.generate(num=16, context=1, sampler="ddim", sample_steps=50,
                        guidance_scale=3.0, seed=7)   # [16, H, W, D, 1]

    server = serve(svc, "127.0.0.1", 8777)   # an http.server.HTTPServer
    server.serve_forever()

  POST /generate {"num": 4, "context": 1, "sampler": "ddim",
                  "sample_steps": 50, "guidance_scale": null,
                  "seed": 7, "format": "npy"}
    -> application/octet-stream (.npy payload, shape [num, H, W, D, 1]);
       "format": "nii" returns a .nii.gz of the first volume; a request
       the service refuses gets 400 and {"error": ...}.
  GET  /healthz  -> {"status": "ok", "model": ..., "compiled": [...]}

Every request the JAX service accepts is accepted, with its validation
and messages: samplers "ddpm" (the full T-step chain; `sample_steps` is
ignored), "ddim", "dpmpp" and "dpmpp_sde" (`sample_steps` in [1, T],
default T // 20), and classifier-free guidance (`guidance_scale` rounded
to 0.1 in [0, 20]; 1.0 is the unguided chain; it needs a model trained
with cfg_dropout > 0). The port compiles no programs: "compiled" lists
the last MAX_SIGNATURES (num, sampler, sample_steps, guidance)
signatures served, as the JAX service lists its cached programs.

Requests are served one at a time (one device). The service is built
over a checkpoint of a `--train_dm` run (`from_checkpoint`), over seeded
random weights (`from_random_init`), or by the caller over a trainer
loaded with `convert.load_npz`'s state dicts.

CLI (the GPU unless `--platform cpu`; adopts the run's train_meta.json,
or a snapshot's meta, for every flag not given; SIGINT, ^C, stops it with
exit code 0):
    python -m ldm3d_torch.serve --preset conditional_dm3d \
        --ckpt_dir ./checkpoints/conditional_dm3d_dm --port 8777
    python -m ldm3d_torch.serve --preset conditional_dm3d --norm group \
        --ckpt_dir runs/flagship/flagship_f16.npz --port 8777
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import os
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional

import numpy as np
import torch

from ldm3d_torch.core.config import DiffusionConfig, TrainConfig, replace
from ldm3d_torch.data.nifti import nifti_bytes
from ldm3d_torch.train.dm_trainer import SAMPLERS, DiffusionTrainer


class GenerationService:
    """Owns a `DiffusionTrainer` and serialises requests on its device."""

    MAX_BATCH = 32
    MAX_SIGNATURES = 8

    def __init__(self, cfg: DiffusionConfig, trainer: DiffusionTrainer,
                 name: str = "ldm3d"):
        self.cfg = cfg
        self.name = name
        self.trainer = trainer
        self.epoch: Optional[int] = None   # the checkpoint's, if any
        self._lock = threading.Lock()
        self._counter = 0
        # (num, sampler, sample_steps, guidance), most recent last; its own
        # lock, so that /healthz does not wait for a generation
        self._signatures: "OrderedDict[tuple, None]" = OrderedDict()
        self._signatures_lock = threading.Lock()

    @classmethod
    def from_random_init(cls, cfg: DiffusionConfig, seed: int = 0,
                         device=None, name: str = "ldm3d"):
        """A service over seeded random weights (no trained checkpoint),
        computing in `TrainConfig()`'s dtype, bfloat16, as the JAX
        service does. For another dtype, build the trainer and pass it to
        the constructor."""
        trainer = DiffusionTrainer(cfg, device=device).init_random(
            seed, scheme="reach")
        return cls(cfg, trainer, name=name)

    @classmethod
    def from_checkpoint(cls, exp_cfg, ckpt_dir: str,
                        epoch: Optional[int] = None, ema: bool = False,
                        device=None):
        """Restore the newest (or a given) epoch of a `--train_dm` run's
        checkpoints in `ckpt_dir` (a `CheckpointManager` directory).

        `ema=True` samples from the EMA weights, which the checkpoint must
        then hold; without it a checkpoint that holds them is refused, as
        the JAX service refuses the tree mismatch. The optimizer state is
        not loaded. The service computes in `exp_cfg.train.dtype`
        (bfloat16 unless the preset or `--dtype` says otherwise)."""
        from ldm3d_torch.train.checkpoint import CheckpointManager

        trainer = DiffusionTrainer(exp_cfg.diffusion, device=device,
                                   train_cfg=TrainConfig(
                                       dtype=exp_cfg.train.dtype))
        state, ep = CheckpointManager(ckpt_dir).restore(epoch)
        if ema != (state["ema_unet"] is not None):
            raise ValueError(
                f"checkpoint epoch {ep} in {ckpt_dir} "
                + ("has no EMA weights: restore it without ema"
                   if ema else "holds EMA weights: restore it with ema=True"
                   " (--ema)"))
        trainer.load_state_dict(state, optimizer=False)
        svc = cls(trainer.cfg, trainer, name=exp_cfg.name)
        svc.epoch = ep
        return svc

    @classmethod
    def from_snapshot(cls, exp_cfg, path: str, device=None):
        """Load a `.npz` snapshot (`utils.export`; the JAX package's layout,
        as `tools.export_flagship` writes it) into a trainer of
        `exp_cfg.diffusion`, computing in `exp_cfg.train.dtype`. Its EMA
        weights are loaded, and sampled from, when its meta records
        ema_decay > 0, as an exported train_meta.json does (strict both
        ways, as the JAX package's `load_state_npz`). The caller adopts
        the snapshot's meta (`export.load_meta_npz`) into `exp_cfg`
        first."""
        from ldm3d_torch.utils.export import load_meta_npz, load_state_npz

        meta = load_meta_npz(path)
        trainer = DiffusionTrainer(exp_cfg.diffusion, device=device,
                                   train_cfg=TrainConfig(
                                       dtype=exp_cfg.train.dtype,
                                       ema_decay=float(meta.get(
                                           "ema_decay", 0.0))))
        load_state_npz(path, trainer)
        svc = cls(trainer.cfg, trainer, name=exp_cfg.name)
        svc.epoch = meta.get("epoch")
        return svc

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def generate(self, num: int = 1, context: Optional[int] = None,
                 sampler: str = "ddpm", sample_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 seed: Optional[int] = None) -> np.ndarray:
        """Sample `num` volumes, float32 [num, H, W, D, out] (NDHWC)."""
        num = int(num)
        if not 1 <= num <= self.MAX_BATCH:
            raise ValueError(f"num must be in [1, {self.MAX_BATCH}]")
        if sampler not in SAMPLERS:
            raise ValueError("sampler must be 'ddpm', 'ddim', 'dpmpp' "
                             "or 'dpmpp_sde'")
        if sampler == "ddpm":
            sample_steps = None   # the full chain has no stride
        if sample_steps is not None:
            sample_steps = int(sample_steps)
            if not 1 <= sample_steps <= self.cfg.timesteps:
                raise ValueError(
                    f"sample_steps must be in [1, {self.cfg.timesteps}]")
        if guidance_scale is not None:
            guidance_scale = round(float(guidance_scale), 1)
            if not 0.0 <= guidance_scale <= 20.0:
                raise ValueError("guidance_scale must be in [0, 20]")
            if guidance_scale == 1.0:
                guidance_scale = None   # the unguided chain
            elif self.cfg.unet.cfg_dropout == 0.0:
                raise ValueError(   # the JAX service's message
                    "guidance_scale requires a model trained with "
                    "cfg_dropout > 0 (restore one via --cfg_dropout)")
        if self.trainer.conditional:
            context = 0 if context is None else int(context)
            max_ctx = self.cfg.unet.context_dim
            if not 0 <= context <= max_ctx:
                raise ValueError(f"context must be in [0, {max_ctx}]")

        with self._signatures_lock:
            key = (num, sampler, sample_steps, guidance_scale)
            self._signatures.pop(key, None)
            self._signatures[key] = None
            while len(self._signatures) > self.MAX_SIGNATURES:
                self._signatures.popitem(last=False)
        with self._lock:  # one device: serialise device work
            if seed is None:
                self._counter += 1
                seed = self._counter
            dev = self.device
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            ctx = None
            if self.trainer.conditional:
                ctx = torch.full((num,), context, dtype=torch.long, device=dev)
            c = self.cfg
            shape = (num, c.latent_size, c.latent_size, c.latent_size,
                     c.latent_channels)
            out = self.trainer.generate(
                shape, ctx, generator=gen, sampler=sampler,
                sample_steps=sample_steps, guidance_scale=guidance_scale)
            return out.float().cpu().numpy()

    def compiled_signatures(self):
        """[num, sampler, sample_steps, guidance] of the signatures served
        most recently, oldest first."""
        with self._signatures_lock:
            return [list(k) for k in self._signatures]


def _make_handler(svc: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "model": svc.name,
                                 "compiled": svc.compiled_signatures()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            # A bad request of any kind (body, JSON, field, validation)
            # is answered with 400 and the server keeps serving.
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                vols = svc.generate(
                    num=int(req.get("num", 1)),
                    context=req.get("context"),
                    sampler=req.get("sampler", "ddpm"),
                    sample_steps=req.get("sample_steps"),
                    guidance_scale=req.get("guidance_scale"),
                    seed=req.get("seed"))
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            if req.get("format", "npy") == "nii":
                payload = gzip.compress(nifti_bytes(vols[0]))
            else:
                buf = io.BytesIO()
                np.save(buf, vols)
                payload = buf.getvalue()
            self._send(200, payload, "application/octet-stream")

    return Handler


def serve(svc: GenerationService, host: str = "127.0.0.1",
          port: int = 8777) -> HTTPServer:
    """An HTTPServer over `svc`, bound and not yet serving: the caller runs
    `serve_forever()` (in a thread if it must go on) and `server_close()`.
    Port 0 binds a free port (`server.server_address[1]`)."""
    return HTTPServer((host, port), _make_handler(svc))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("ldm3d_torch.serve")
    ap.add_argument("--preset", default="conditional_dm3d")
    ap.add_argument("--ckpt_dir", required=True,
                    help="checkpoint dir of the --train_dm run "
                         "({ckpt_dir}/{name}_dm of its CLI), or a .npz "
                         "snapshot of one (tools.export_flagship)")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--cfg_dropout", type=float, default=None)
    ap.add_argument("--prediction_type", default=None,
                    choices=["eps", "v"])
    ap.add_argument("--latent_scale", type=float, default=None)
    ap.add_argument("--clip_sample_range", type=float, default=None)
    ap.add_argument("--context_in_time", action="store_true",
                    default=None)
    ap.add_argument("--ema", action="store_true",
                    help="sample from the EMA weights (the default when "
                         "train_meta.json records ema_decay > 0; a "
                         "snapshot's meta decides for it)")
    ap.add_argument("--norm", default=None, choices=["batch", "group"])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="the GPU by default; cpu serves from the CPU")
    return ap


def server_from_args(argv=None):
    """(service, bound HTTPServer) of the serve CLI's arguments: the
    preset, the flags given, and the run's train_meta.json (in
    `--ckpt_dir`) for every sampling invariant not given."""
    from ldm3d_torch.core.device import resolve_device
    from ldm3d_torch.core.presets import get_preset
    from ldm3d_torch.train.meta import adopt_meta, load_meta
    from ldm3d_torch.utils.export import load_meta_npz

    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    cfg = get_preset(args.preset)
    diff = cfg.diffusion
    if args.cfg_dropout is not None:
        diff = replace(diff, unet=replace(diff.unet,
                                          cfg_dropout=args.cfg_dropout))
    if args.prediction_type is not None:
        diff = replace(diff, prediction_type=args.prediction_type)
    if args.context_in_time:
        diff = replace(diff, unet=replace(diff.unet, context_in_time=True))
    if args.latent_scale is not None:
        diff = replace(diff, latent_scale=args.latent_scale)
    if args.clip_sample_range is not None:
        diff = replace(diff, clip_sample_range=args.clip_sample_range)
    if args.norm is not None:
        diff = replace(diff, vqvae=replace(diff.vqvae, norm=args.norm))
    snapshot = os.path.isfile(args.ckpt_dir)
    meta = load_meta_npz(args.ckpt_dir) if snapshot else load_meta(
        os.path.join(args.ckpt_dir, "train_meta.json"))
    cfg = adopt_meta(replace(cfg, diffusion=diff), args, meta)
    if snapshot:
        svc = GenerationService.from_snapshot(cfg, args.ckpt_dir, device)
    else:
        svc = GenerationService.from_checkpoint(
            cfg, args.ckpt_dir, args.epoch,
            ema=args.ema or cfg.train.ema_decay > 0, device=device)
    return svc, serve(svc, args.host, args.port)


def main(argv=None):
    """Serve until interrupted (SIGINT, ^C): the socket is closed and the
    process exits with 0."""
    svc, server = server_from_args(argv)
    host, port = server.server_address[:2]
    print(f"serving {svc.name} (epoch {svc.epoch}) on "
          f"http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("stopped", flush=True)
    finally:
        server.server_close()


if __name__ == "__main__":
    main()

"""Worker processes of the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_multiprocess.py,
tests/test_torch_spatial.py, tests/test_torch_tp.py,
tests/test_torch_cli.py).

    python tests/torch_dist_workers.py <job> <rank> <processes> <port> <dir>

Each worker joins a gloo group on 127.0.0.1:<port> through
`ldm3d_torch.parallel.distributed.initialize`, reads the job's inputs from
`<dir>/<job>_in.pt` (written by the test), computes its share on the CPU
and saves what it computed to `<dir>/<job>_out<rank>.pt` (a job of
`JOINING` joins the group through the code it runs instead). It imports
nothing of JAX, so that it starts in the time torch takes to import.
`launch` starts the workers of a job from a test and waits for them.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def launch(job: str, directory, n: int = 2, timeout: float = 120.0):
    """Run `job` in `n` worker processes; returns their outputs in rank
    order. Fails when a worker fails or outlives `timeout` seconds (all
    are then killed)."""
    from ldm3d_torch.parallel.distributed import free_port
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(n),
         str(port), str(directory)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{job}: a worker outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job} rank {r} failed:\n{log}"
    return [torch.load(os.path.join(str(directory), f"{job}_out{r}.pt"),
                       weights_only=False) for r in range(n)]


# ---------------------------------------------------------------------------
# Jobs: each takes its inputs and its mesh and returns what it computed
# ---------------------------------------------------------------------------


def _train_cfg(case):
    """The case's TrainConfig: float32, the dtype the compared steps are
    held at, unless the case names another."""
    from ldm3d_torch.core.config import TrainConfig
    return TrainConfig(**{"dtype": "float32", **case["train"]})


def job_halo(spec):
    """`halo_conv3d` of each case on a (1, 2, 1) space mesh: this rank's
    output rows and the gradients of sum(out * g) (input rows; kernel and
    bias summed over the space group)."""
    from ldm3d_torch.core.config import MeshConfig
    from ldm3d_torch.parallel.distributed import all_reduce_sum
    from ldm3d_torch.parallel.halo import halo_conv3d
    from ldm3d_torch.parallel.mesh import SPACE_AXIS, make_mesh

    mesh = make_mesh(MeshConfig(data=1, space=2))
    i, n = mesh.coord(SPACE_AXIS), mesh.shape[SPACE_AXIS]
    out = []
    for case in spec:
        x, k, b, g = (case[key] for key in ("x", "kernel", "bias", "g"))
        rows = x.shape[1] // n
        x = x[:, i * rows:(i + 1) * rows].clone().requires_grad_(True)
        k = k.clone().requires_grad_(True)
        b = b.clone().requires_grad_(True)
        y = halo_conv3d(x, k, b, case["stride"], mesh, shard_axis=1)
        g_rows = g.shape[1] // n
        (y * g[:, i * g_rows:(i + 1) * g_rows]).sum().backward()
        group = mesh.group(SPACE_AXIS)
        out.append(dict(y=y.detach(), dx=x.grad,
                        dk=all_reduce_sum(k.grad, group),
                        db=all_reduce_sum(b.grad, group)))
    return out


def _adam_moment(trainer_params, optimizer, slot):
    return {n: optimizer.state[p][slot].clone()
            for n, p in trainer_params if p in optimizer.state}


def job_steps(spec):
    """One data-parallel step of each trainer case of `spec` on this
    rank's rows (`shard_batch`), from the state the test gives."""
    from ldm3d_torch.core.config import MeshConfig, TrainConfig
    from ldm3d_torch.models.quantizers import Draws, make_quantizer
    from ldm3d_torch.parallel.mesh import (attach_data_group, data_shard,
                                           make_mesh, shard_batch)
    from ldm3d_torch.train.dm_trainer import DiffusionTrainer
    from ldm3d_torch.train.gan_trainer import GANTrainer
    from ldm3d_torch.train.vq_trainer import VQTrainer

    out = {}
    for name, case in spec.items():
        mesh = make_mesh(MeshConfig(), batch_size=case["batch"])
        kind = case["kind"]
        if kind == "vq":
            tr = VQTrainer(case["cfg"], _train_cfg(case),
                           device="cpu", mesh=mesh)
            tr.model.load_state_dict(case["state"], strict=True)
            vol, mask = shard_batch(mesh, (case["vol"], case["mask"]))
            draws = Draws(shard=data_shard(mesh), **case["draws"]) \
                if case.get("draws") else None
            m = tr.train_step(vol, mask, draws)
            res = dict(metrics={k: float(v) for k, v in m.items()},
                       state={k: t.clone() for k, t in
                              tr.model.state_dict().items()},
                       mu=_adam_moment(tr.model.named_parameters(),
                                       tr.optimizer, "exp_avg"))
            if "eval_state" in case:
                tr.model.load_state_dict(case["eval_state"], strict=True)
            res["eval"] = {k: float(v) for k, v in
                           tr.eval_step(vol, mask).items()}
            if "replace" in case:
                res["replaced"] = tr.replace_unused(
                    2, Draws(**case["replace"]))
                res["after_replace"] = {k: t.clone() for k, t in
                                        tr.model.state_dict().items()}
        elif kind == "dm":
            tr = DiffusionTrainer(case["cfg"], device="cpu",
                                  train_cfg=_train_cfg(case),
                                  mesh=mesh)
            tr.load_state_dicts(case["state"], case["ema"])
            lat, ctx = shard_batch(mesh, (case["lat"], case["ctx"]))
            m = tr.train_step_latents(lat, ctx, **case["draws"])
            unet = tr.model.unet
            res = dict(metrics={k: float(v) for k, v in m.items()},
                       state={k: t.clone() for k, t in
                              tr.model.state_dict().items()},
                       ema={k: t.clone() for k, t in
                            tr.ema_unet.state_dict().items()},
                       mu=_adam_moment(unet.named_parameters(),
                                       tr.optimizer, "exp_avg"),
                       nu=_adam_moment(unet.named_parameters(),
                                       tr.optimizer, "exp_avg_sq"))
        elif kind == "gan":
            tr = GANTrainer(case["cfg"], _train_cfg(case),
                            device="cpu", volume_size=case["size"],
                            mesh=mesh).init_random(case["seed"])
            tr.epoch = case["epoch"]
            vol, mask = shard_batch(mesh, (case["vol"], case["mask"]))
            m = tr.train_step(vol, mask)
            res = dict(metrics={k: float(v) for k, v in m.items()},
                       grads={n: p.grad.clone() for n, p in
                              tr.model.named_parameters()
                              if p.grad is not None},
                       state={k: t.clone() for k, t in
                              tr.model.state_dict().items()})
        elif kind == "quantizer":
            q = make_quantizer(case["cfg"])
            q.reset_parameters(torch.Generator().manual_seed(case["seed"]))
            attach_data_group(q, mesh)
            q.train()
            gen = torch.Generator().manual_seed(case["seed"] + 1)
            res = dict(steps=[])
            for x in case["xs"]:
                x = shard_batch(mesh, x).clone().requires_grad_(True)
                y, aux = q(x, Draws(gen, shard=data_shard(mesh)))
                (y.square().mean() + aux.loss).backward()
                res["steps"].append(dict(
                    y=y.detach(), dx=x.grad, perplexity=float(aux.perplexity),
                    counts=aux.usage_counts.clone(),
                    buffers={k: b.clone() for k, b in q.named_buffers()}))
        else:
            raise ValueError(f"unknown case kind {kind!r}")
        out[name] = res
    return out


class Apply(torch.nn.Module):
    """A function of `ldm3d_torch.models.layers` as a module (a picklable
    op case of `job_spatial`)."""

    def __init__(self, name: str, **kw):
        super().__init__()
        self.name, self.kw = name, kw

    def forward(self, x):
        from ldm3d_torch.models import layers
        return getattr(layers, self.name)(x, **self.kw)


class First(torch.nn.Module):
    """A model's first output (a reconstruction) as an op case."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x)[0]


def _spatial_op(case, mesh):
    """An op on this rank's depth slab (`axis` of x) under
    `spatial_sharding`: its output slab, the input slab's gradient of
    sum(out * g) and this rank's share of the parameters' gradients."""
    from ldm3d_torch.parallel.mesh import local_depth
    from ldm3d_torch.parallel.spatial import spatial_sharding

    def slab(t, axis):
        r = local_depth(mesh, t.shape[axis])
        return t.narrow(axis, r.start, len(r))
    m, axis = case["module"], case["axis"]
    m.train(case.get("train", False))
    x = slab(case["x"], axis).clone().requires_grad_(True)
    with spatial_sharding(mesh):
        y = m(x, *case.get("args", ()))
        loss = (y * slab(case["g"], axis)).sum()
        if case.get("thread"):
            # the backward pass on a thread that does not see the context
            # (as on the card, where autograd runs a thread per device)
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        else:
            loss.backward()
    assert x.grad is not None
    return dict(y=y.detach(), dx=x.grad,
                grads={n: p.grad.clone() for n, p in m.named_parameters()
                       if p.grad is not None},
                buffers={n: b.clone() for n, b in m.named_buffers()})


def _state(module):
    return {k: t.clone() for k, t in module.state_dict().items()}


def _grads(module):
    return {n: p.grad.clone() for n, p in module.named_parameters()
            if p.grad is not None}


def _spatial_step(case, mesh):
    """One trainer step on this rank's depth slabs from the given state;
    the diffusion case then samples from its EMA U-Net and decodes."""
    from ldm3d_torch.core.config import TrainConfig
    from ldm3d_torch.models.quantizers import Draws
    from ldm3d_torch.parallel.mesh import data_shard, shard_batch
    from ldm3d_torch.train.dm_trainer import DiffusionTrainer
    from ldm3d_torch.train.gan_trainer import GANTrainer
    from ldm3d_torch.train.vq_trainer import VQTrainer

    kind, train = case["kind"], _train_cfg(case)
    draws = Draws(shard=data_shard(mesh), **case["draws"]) \
        if case.get("draws") else None
    if kind in ("vq", "gan"):
        if kind == "vq":
            tr = VQTrainer(case["cfg"], train, device="cpu", mesh=mesh)
        else:
            tr = GANTrainer(case["cfg"], train, device="cpu",
                            volume_size=case["size"], mesh=mesh)
            tr.epoch = case["epoch"]
        tr.model.load_state_dict(case["state"], strict=True)
        vol, mask = shard_batch(mesh, (case["vol"], case["mask"]),
                                spatial_axis=3)
        res = {}
        if kind == "vq":        # from the given state
            res["eval"] = {k: float(v) for k, v in
                           tr.eval_step(vol, mask).items()}
        m = tr.train_step(vol, mask, draws)
        res.update(metrics={k: float(v) for k, v in m.items()},
                   grads=_grads(tr.model), state=_state(tr.model))
        return res
    tr = DiffusionTrainer(case["cfg"], device="cpu", train_cfg=train,
                          mesh=mesh)
    tr.load_state_dicts(case["state"], case["ema"])
    lat, ctx = shard_batch(mesh, (case["lat"], case["ctx"]))
    m = tr.train_step_latents(lat, ctx, **case["step_draws"])
    res = dict(metrics={k: float(v) for k, v in m.items()},
               grads=_grads(tr.model.unet), state=_state(tr.model),
               ema=_state(tr.ema_unet))
    gen = case["generate"]
    res["volumes"] = tr.generate(
        gen["shape"], gen["ctx"], init_noise=gen["init_noise"],
        step_noise=gen["step_noise"].__getitem__, sampler="ddim",
        sample_steps=gen["steps"], eta=gen["eta"], decode=True)
    return res


def _spatial_quantizer(case, mesh):
    """Training passes of a quantizer on this rank's depth slabs of
    [B, H, W, D, C] latents."""
    from ldm3d_torch.models.quantizers import Draws, make_quantizer
    from ldm3d_torch.parallel.mesh import shard_batch
    from ldm3d_torch.parallel.spatial import spatial_sharding

    q = make_quantizer(case["cfg"])
    q.reset_parameters(torch.Generator().manual_seed(case["seed"]))
    q.train()
    gen = torch.Generator().manual_seed(case["seed"] + 1)
    steps = []
    for x in case["xs"]:
        x = shard_batch(mesh, x, spatial_axis=3).clone().requires_grad_(True)
        with spatial_sharding(mesh):
            y, aux = q(x, Draws(gen))
            (y.square().mean() + aux.loss).backward()
        steps.append(dict(y=y.detach(), dx=x.grad,
                          perplexity=float(aux.perplexity),
                          counts=aux.usage_counts.clone(),
                          buffers={k: b.clone()
                                   for k, b in q.named_buffers()}))
    return dict(steps=steps)


def job_spatial(spec):
    """Every case of `spec` on a data 1 x space 2 mesh: ops on depth
    slabs, trainer steps, quantizer passes."""
    from ldm3d_torch.core.config import MeshConfig
    from ldm3d_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data=1, space=2))
    run = {"op": _spatial_op, "quantizer": _spatial_quantizer}
    return {name: run.get(case["kind"], _spatial_step)(case, mesh)
            for name, case in spec.items()}


def fail_at_epoch_end(epoch: int) -> None:
    """Make this process's plateau schedule raise once, when it is called
    at the end of epoch `epoch` (0-based): a failure at the epoch's end
    on this process alone."""
    from ldm3d_torch.train import callbacks

    real = callbacks.ReduceLROnPlateau.__call__
    done = []

    def call(self, e, *args, **kwargs):
        if e == epoch and not done:
            done.append(e)
            raise RuntimeError("injected fault")
        return real(self, e, *args, **kwargs)
    callbacks.ReduceLROnPlateau.__call__ = call


def local_process_failing(index, argv, n, port) -> None:
    """Process `index` of a --cpu_devices run (`cli._local_process`),
    process 1 failing at the end of its second epoch."""
    from ldm3d_torch.cli import main as cli
    if index == 1:
        fail_at_epoch_end(1)
    cli._local_process(index, argv, n, port)


def widened(cfg, mesh=None, widths=None):
    """`cfg` with its mesh and, given `widths`, its U-Net's widths (wide
    enough for the model axis to split something) replaced."""
    from ldm3d_torch.core.config import replace
    if mesh is not None:
        cfg = replace(cfg, train=replace(cfg.train, mesh=mesh))
    if widths is not None:
        cfg = replace(cfg, diffusion=replace(cfg.diffusion, unet=replace(
            cfg.diffusion.unet, widths=tuple(widths))))
    return cfg


def _run_port(directory, i, rank, port):
    """The coordinator port of run `i` of a "runs" spec: the launcher's
    for the first; then one that process 0 takes free right before its
    run and hands to the others through a file in `directory` (a port
    picked in advance could be taken meanwhile, by a gloo pair of an
    earlier run)."""
    from ldm3d_torch.parallel.distributed import free_port
    if i == 0:
        return int(port)
    path = os.path.join(str(directory), f"cli_port{i}")
    if rank == 0:
        with open(path + ".tmp", "w") as f:
            f.write(str(free_port()))
        os.replace(path + ".tmp", path)
    while not os.path.exists(path):
        time.sleep(0.05)
    with open(path) as f:
        return int(f.read())


def job_cli(spec, rank, n, port, directory):
    """The command line's main with `spec["argv"]`, this process joining
    the run through --coordinator as the CLI's own processes do, the
    preset's mesh replaced by `MeshConfig(**spec["mesh"])` (and its
    U-Net's widths by `spec["widths"]`, when given; with `spec["fail"]`
    = (rank, epoch), that rank fails at that epoch's end); returns what
    it printed and the shapes of the meshes it made. A spec of "runs"
    runs each of them in turn in these processes, each joining a group of
    its own (`_run_port`), and returns their results in order."""
    import contextlib
    import io

    from ldm3d_torch.cli import main as cli
    from ldm3d_torch.core import presets
    from ldm3d_torch.core.config import MeshConfig
    from ldm3d_torch.parallel import mesh as pmesh

    if "runs" in spec:
        return [job_cli(run, rank, n, _run_port(directory, i, rank, port),
                        directory) for i, run in enumerate(spec["runs"])]
    get_preset, make_mesh, shapes = presets.get_preset, pmesh.make_mesh, []

    def preset(name):
        return widened(get_preset(name), MeshConfig(**spec["mesh"]),
                       spec.get("widths"))

    if spec.get("fail") and spec["fail"][0] == rank:
        fail_at_epoch_end(spec["fail"][1])

    def mesh(*args, **kwargs):
        made = make_mesh(*args, **kwargs)
        shapes.append(dict(made.shape))
        return made

    presets.get_preset, pmesh.make_mesh = preset, mesh
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(spec["argv"] + [
                "--coordinator", f"127.0.0.1:{port}", "--num_processes",
                str(n), "--process_id", str(rank)])
    finally:
        presets.get_preset, pmesh.make_mesh = get_preset, make_mesh
    return dict(stdout=out.getvalue(), meshes=shapes)


def _whole_grads(module, mesh):
    """Every parameter's gradient, whole: a sharded one gathered over the
    model group."""
    from ldm3d_torch.parallel import tp
    out = {}
    for name, m in module.named_modules():
        for n, p in m.named_parameters(recurse=False):
            if p.grad is None:
                continue
            dim = tp.split_dim(m, n)
            g = p.grad if dim is None else tp.gather_tensor(p.grad, dim,
                                                            mesh)
            out[f"{name}.{n}" if name else n] = g.clone()
    return out


def _tp_op(case, mesh):
    """A module sharded over the model group under `mesh_sharding`: its
    output, the input's gradient of sum(out * g) and the parameters'
    gradients (whole), on this rank's rows and depth slab."""
    import copy as copy_mod

    from ldm3d_torch.parallel import tp
    from ldm3d_torch.parallel.mesh import local_depth, shard_batch
    m = tp.shard_module(copy_mod.deepcopy(case["module"]), mesh)
    x, g = shard_batch(mesh, (case["x"], case["g"]))
    r = local_depth(mesh, x.shape[4])
    if r is not None:
        x, g = (t.narrow(4, r.start, len(r)) for t in (x, g))
    x = x.clone().requires_grad_(True)
    with tp.mesh_sharding(mesh):
        y = m(x)
        (y * g).sum().backward()
    return dict(y=y.detach(), dx=x.grad, grads=_whole_grads(m, mesh),
                sharded=tp.sharded_names(m))


def _tp_trainer(case, mesh):
    from ldm3d_torch.core.config import TrainConfig
    from ldm3d_torch.train.dm_trainer import DiffusionTrainer
    from ldm3d_torch.train.gan_trainer import GANTrainer
    from ldm3d_torch.train.vq_trainer import VQTrainer
    train = _train_cfg(case)
    if case["kind"] == "vq":
        return VQTrainer(case["cfg"], train, device="cpu", mesh=mesh)
    if case["kind"] == "gan":
        return GANTrainer(case["cfg"], train, device="cpu",
                          volume_size=case["size"], mesh=mesh)
    return DiffusionTrainer(case["cfg"], device="cpu", train_cfg=train,
                            mesh=mesh)


def _tp_step(case, mesh):
    """A trainer's step on a tensor-parallel mesh from the whole state the
    test gives (`load_state_dict`): its metrics, whole gradients, whole
    state (`state_dict`), the sharded names and this rank's shards; with
    "again",
    a second step. The diffusion case first samples from the EMA U-Net
    it was given."""
    import copy

    from ldm3d_torch.parallel import tp
    from ldm3d_torch.parallel.mesh import shard_batch
    tr = _tp_trainer(case, mesh)
    tr.load_state_dict(case["state"])
    model = tr.model.unet if case["kind"] == "dm" else tr.model
    volumes = None
    if case["kind"] == "dm":
        gen = case["generate"]
        volumes = tr.generate(
            gen["shape"], gen["ctx"], init_noise=gen["init_noise"],
            step_noise=gen["step_noise"].__getitem__, sampler="ddim",
            sample_steps=gen["steps"], eta=gen["eta"], decode=True)
        lat, ctx = shard_batch(mesh, (case["lat"], case["ctx"]))

        def step():
            return tr.train_step_latents(lat, ctx, **case["draws"])
    else:
        vol, mask = shard_batch(mesh, (case["vol"], case["mask"]))

        def step():
            return tr.train_step(vol, mask)
    m = step()
    res = dict(metrics={k: float(v) for k, v in m.items()},
               grads=_whole_grads(model, mesh),
               state=copy.deepcopy(tr.state_dict()),
               sharded=tp.sharded_names(tr.model),
               local={k: t.clone() for k, t in tr.model.state_dict().items()})
    if case.get("again"):
        res["again"] = {k: float(v) for k, v in step().items()}
    if volumes is not None:
        res["volumes"] = volumes
    return res


def job_tp(spec):
    """Every case of `spec` on a data 1 x model 2 mesh (or the mesh a case
    names): sharded ops and trainer steps."""
    from ldm3d_torch.core.config import MeshConfig
    from ldm3d_torch.parallel.mesh import make_mesh

    meshes = {}
    out = {}
    for name, case in spec.items():
        shape = tuple(case.get("mesh", (1, 1, 2)))
        if shape not in meshes:      # every rank makes them in one order
            meshes[shape] = make_mesh(MeshConfig(*shape))
        run = _tp_op if case["kind"] == "op" else _tp_step
        out[name] = run(case, meshes[shape])
    return out


JOBS = {"halo": job_halo, "steps": job_steps, "spatial": job_spatial,
        "tp": job_tp}
# jobs that join the process group themselves (rank, processes, port,
# directory)
JOINING = {"cli": job_cli}


def main(argv) -> None:
    job, rank, n, port, directory = argv
    torch.set_num_threads(2)
    if job in JOINING:
        spec = torch.load(os.path.join(directory, f"{job}_in.pt"),
                          weights_only=False)
        out = JOINING[job](spec, int(rank), int(n), port, directory)
        torch.save(out, os.path.join(directory, f"{job}_out{rank}.pt"))
        return
    from ldm3d_torch.parallel import distributed as pdist

    pdist.initialize(f"127.0.0.1:{port}", int(n), int(rank),
                     platform="cpu")
    try:
        spec = torch.load(os.path.join(directory, f"{job}_in.pt"),
                          weights_only=False)
        out = JOBS[job](spec)
        torch.save(out, os.path.join(directory, f"{job}_out{rank}.pt"))
        pdist.barrier()
    finally:
        pdist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])

"""Slurm launcher for GPU nodes: sbatch scripts for the canonical jobs of
the port's command line (`python -m ldm3d_torch.cli.main`). The port of
`tools/emit_sbatch.py`, with one process per card.

Every job is one CLI invocation, so the Slurm integration is a generator:
it emits an sbatch wrapper for any preset and flags. A node runs
--gpus_per_node tasks (`--gres=gpu:G`, one process per card); a job of
more than one process (several nodes, or several cards on one) joins
them as the port's CLI joins processes: `--coordinator` at node 0,
`--num_processes $SLURM_NTASKS`, `--process_id $SLURM_PROCID` (process i
takes card i % G of its node).

    python -m ldm3d_torch.tools.emit_sbatch --preset vqgan_attn \\
        --train_vq --epochs 400 --lbs 2 --out sb_vqgan.sbatch
    python -m ldm3d_torch.tools.emit_sbatch --preset conditional_dm3d \\
        --train_dm --nodes 2 --gpus_per_node 4 --out sb_cond_dm3d.sbatch
    python -m ldm3d_torch.tools.emit_sbatch --all --out_dir slurm/

Unknown flags pass through verbatim to the CLI, so any CLI surface works;
`--preset`/`--all`/`--nodes`/`--gpus_per_node`/`--time`/`--partition`/
`--out`/`--out_dir` are consumed here.
"""

from __future__ import annotations

import argparse
import os

HEADER = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={gpus}
#SBATCH --gres=gpu:{gpus}
#SBATCH --cpus-per-task=16
#SBATCH --time={time}
{partition}#SBATCH --output={name}-%j.out
#SBATCH --error={name}-%j.err

set -euo pipefail
cd "$SLURM_SUBMIT_DIR"
"""

SINGLE = """
srun python -m ldm3d_torch.cli.main {args}
"""

# More than one process: node 0 is the process group's coordinator; every
# task runs the identical command with its own rank.
MULTI = """
COORD_HOST=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
export LDM3D_COORDINATOR="$COORD_HOST:8476"

srun bash -c 'python -m ldm3d_torch.cli.main {args} \\
    --coordinator "$LDM3D_COORDINATOR" \\
    --num_processes "$SLURM_NTASKS" \\
    --process_id "$SLURM_PROCID"'
"""

# preset -> canonical extra flags, the JAX tool's matrix
CANONICAL = {
    "vqvae_b8_all": ["--train_vq", "--kernel_resize", "--epochs", "200",
                     "--lbs", "8"],
    "vqgan_attn": ["--train_vq", "--epochs", "400", "--lbs", "2",
                   "--disc_threshold", "40"],
    "vqgan_baseline": ["--train_vq", "--epochs", "400", "--lbs", "2"],
    "vqgan_gnorm": ["--train_vq", "--epochs", "400", "--lbs", "2"],
    "vqgan_stride": ["--train_vq", "--epochs", "400", "--lbs", "2"],
    "nsvqvae": ["--train_vq", "--epochs", "200", "--lbs", "8"],
    "rnsvqvae": ["--train_vq", "--epochs", "200", "--lbs", "8"],
    "dm3d": ["--train_dm", "--timesteps", "300", "--epochs", "100",
             "--lbs", "3"],
    "conditional_dm3d": ["--train_dm", "--timesteps", "500", "--epochs",
                         "100", "--lbs", "3", "--augment",
                         "--save_best_only"],
    "vqvae_dm_stage1": ["--train_vq", "--epochs", "60", "--lbs", "8"],
}


def emit(preset: str, cli_args: list, nodes: int, time: str,
         partition: str, gpus_per_node: int = 1) -> str:
    name = f"ldm3d_{preset}"
    args = " ".join(["--preset", preset] + [str(a) for a in cli_args])
    part = f"#SBATCH --partition={partition}\n" if partition else ""
    body = MULTI if nodes * gpus_per_node > 1 else SINGLE
    return (HEADER.format(name=name, nodes=nodes, gpus=gpus_per_node,
                          time=time, partition=part)
            + body.format(args=args))


def main(argv=None):
    ap = argparse.ArgumentParser("ldm3d_torch.tools.emit_sbatch")
    ap.add_argument("--preset", default=None)
    ap.add_argument("--all", action="store_true",
                    help="emit one sbatch per canonical preset job")
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--gpus_per_node", type=int, default=1,
                    help="cards per node, one process each")
    ap.add_argument("--time", default="2-00:00:00")
    ap.add_argument("--partition", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--out_dir", default="slurm")
    args, passthrough = ap.parse_known_args(argv)

    if args.all:
        os.makedirs(args.out_dir, exist_ok=True)
        for preset, flags in CANONICAL.items():
            path = os.path.join(args.out_dir, f"sb_{preset}.sbatch")
            with open(path, "w") as f:
                f.write(emit(preset, flags + passthrough, args.nodes,
                             args.time, args.partition, args.gpus_per_node))
            print("wrote", path)
        return

    if not args.preset:
        ap.error("--preset or --all required")
    flags = passthrough or CANONICAL.get(args.preset, [])
    text = emit(args.preset, flags, args.nodes, args.time, args.partition,
                args.gpus_per_node)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print("wrote", args.out)
    else:
        print(text)


if __name__ == "__main__":
    main()

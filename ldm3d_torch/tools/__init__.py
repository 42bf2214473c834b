"""The repository's tools on the port: the counterparts of the scripts in
`tools/` that drive the JAX package, each run as
`python -m ldm3d_torch.tools.<name>` with the JAX tool's flags, defaults
and output, and a `main(argv=None)` that tests call in process.

  export_flagship  a trained `--train_dm` run's sampling state, at its
                   best-latent-FID epoch, to a float16 `.npz` snapshot in
                   the JAX package's layout
  recalibrate_bn   a BatchNorm stage-1 checkpoint's running statistics
                   re-estimated over the corpus, saved to `<ckpt_dir>_bnr`
  context_effect   how far the context token moves the denoiser's eps
  r5_diag          eps-MSE per timestep bucket, single-batch overfits and
                   a full-corpus arm of a trained denoiser
  emit_sbatch      Slurm scripts for GPU nodes, one process per card
  quality_report, gan_ab, dm_comparison
                   markdown reports (and plots) of `training.log` files

The device tools run on the GPU unless given `--platform cpu` (r5_diag
passes it, as every flag it does not know, to the command line it
builds). None imports JAX, the JAX package, `bench.py`,
`__graft_entry__.py` or `tools/`. `tools/conditioning_ab.py`,
`tools/export_lpips_weights.py` and `tools/lpips_check.py` import nothing
of either package and serve both as they are.
"""

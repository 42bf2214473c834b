"""Hyper-parameter sweeps, local and egress-free: the port of
`ldm3d.core.sweep` (pure Python; for the same spec, seed and observations
it proposes the same points).

The reference runs `wandb agent` over `sweep.yaml` / `sweep_nsvqvae.yaml`
(method: bayes over channel_list / num_embedding / embedding_dim / lbs,
metric val_loss min; reference sweep.yaml:1-23, sb_sweep.sbatch). Here the
same YAML schema is parsed without wandb: `grid` enumerates the product,
`random` samples `count` configurations, and `bayes` runs a sequential
TPE optimizer (`BayesSearch`) over the discrete grid — the reference's
sweep method, honored for real.

Safety note: the reference parses channel_list with `eval()`
(main_exp_vqgan_attn.py:71); here it is a strict literal parse.
"""

from __future__ import annotations

import ast
import itertools
import math
import random as pyrandom
from typing import Any, Dict, List, Optional


def _parse_scalar(v: Any) -> Any:
    if isinstance(v, str) and v.strip().startswith("("):
        parsed = ast.literal_eval(v)   # strict: tuples of ints only
        if not (isinstance(parsed, tuple)
                and all(isinstance(x, int) for x in parsed)):
            raise ValueError(f"bad channel_list literal: {v!r}")
        return parsed
    return v


def parse_sweep_yaml(text: str) -> Dict[str, Any]:
    """Minimal YAML-subset parser for the W&B sweep schema (no external
    yaml dependency): top-level keys, `metric:` block, `parameters:` blocks
    with `value:` or `values: [...]`."""
    spec: Dict[str, Any] = {"parameters": {}}
    current_param: Optional[str] = None
    section = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        val = val.strip()
        if indent == 0:
            section = key
            if key in ("metric", "parameters"):
                spec.setdefault(key, {} if key == "metric" else {})
            elif val:
                spec[key] = val
        elif section == "metric":
            spec["metric"][key] = val
        elif section == "parameters":
            if indent == 2:
                current_param = key
                spec["parameters"][current_param] = {}
            elif current_param is not None:
                if key == "values":
                    items = ast.literal_eval(val) if val.startswith("[") \
                        else [val]
                    spec["parameters"][current_param]["values"] = [
                        _parse_scalar(x) for x in items]
                elif key == "value":
                    spec["parameters"][current_param]["value"] = \
                        _parse_scalar(ast.literal_eval(val)
                                      if val and val[0] in "0123456789[-(\"'"
                                      else val)
    return spec


def expand_sweep(spec: Dict[str, Any], count: Optional[int] = None,
                 seed: int = 0) -> List[Dict[str, Any]]:
    """Expand a parsed sweep spec into a list of flat override dicts."""
    params = spec.get("parameters", {})
    fixed = {k: v["value"] for k, v in params.items() if "value" in v}
    grids = {k: v["values"] for k, v in params.items() if "values" in v}
    method = spec.get("method", "grid")

    keys = sorted(grids)
    all_combos = [dict(zip(keys, combo))
                  for combo in itertools.product(*(grids[k] for k in keys))]
    if method == "grid" or count is None or count >= len(all_combos):
        chosen = all_combos
        if count is not None:
            chosen = chosen[:count]
    else:
        rng = pyrandom.Random(seed)
        chosen = rng.sample(all_combos, count)
    return [{**fixed, **c} for c in chosen]


class BayesSearch:
    """Sequential TPE (tree-structured Parzen estimator) over the discrete
    sweep grid — implements the reference's `method: bayes`
    (reference sweep.yaml:2) instead of degrading to random search.

    Categorical TPE (Bergstra et al., "Algorithms for Hyper-Parameter
    Optimization", NeurIPS 2011): after `n_init` random seeding trials,
    observations are split at the `gamma`-quantile of the metric into
    good/bad sets, every not-yet-tried grid cell is scored by
    sum_k log P(x_k | good) - log P(x_k | bad) with Laplace smoothing,
    and the best-scoring cell is proposed next. Minimizes by default;
    pass goal="maximize" to flip (metric values are negated internally).
    """

    def __init__(self, spec: Dict[str, Any], seed: int = 0,
                 n_init: int = 4, gamma: float = 0.25,
                 goal: Optional[str] = None):
        params = spec.get("parameters", {})
        self.fixed = {k: v["value"] for k, v in params.items()
                      if "value" in v}
        self.grids = {k: list(v["values"]) for k, v in params.items()
                      if "values" in v}
        self.keys = sorted(self.grids)
        self.candidates = [dict(zip(self.keys, c)) for c in
                           itertools.product(*(self.grids[k]
                                               for k in self.keys))]
        self.rng = pyrandom.Random(seed)
        self.n_init = n_init
        self.gamma = gamma
        goal = goal or spec.get("metric", {}).get("goal", "minimize")
        self.sign = -1.0 if str(goal).startswith("max") else 1.0
        self.obs: List[tuple] = []
        self._seen = set()

    def _cell(self, point: Dict[str, Any]) -> tuple:
        return tuple(point[k] for k in self.keys)

    def suggest(self) -> Optional[Dict[str, Any]]:
        """Next configuration to try, or None when the grid is exhausted."""
        unseen = [c for c in self.candidates
                  if self._cell(c) not in self._seen]
        if not unseen:
            return None
        if len(self.obs) < self.n_init:
            choice = self.rng.choice(unseen)
        else:
            vals = sorted(v for _, v in self.obs)
            cut = vals[max(0, math.ceil(self.gamma * len(vals)) - 1)]
            good = [p for p, v in self.obs if v <= cut]
            bad = [p for p, v in self.obs if v > cut] or good

            def prob(plist, k, val):
                n = sum(1 for p in plist if p[k] == val)
                return (n + 1.0) / (len(plist) + len(self.grids[k]))

            def score(c):
                return sum(math.log(prob(good, k, c[k]))
                           - math.log(prob(bad, k, c[k]))
                           for k in self.keys)

            choice = max(unseen, key=score)
        self._seen.add(self._cell(choice))
        return {**self.fixed, **choice}

    def observe(self, point: Dict[str, Any], value: float) -> None:
        cell = {k: point[k] for k in self.keys}
        self.obs.append((cell, self.sign * float(value)))

    def best(self) -> Optional[Dict[str, Any]]:
        if not self.obs:
            return None
        cell, _ = min(self.obs, key=lambda pv: pv[1])
        return {**self.fixed, **cell}


def apply_sweep_point(cfg, point: Dict[str, Any]):
    """Fold one sweep point's overrides into an ExperimentConfig
    (channel_list / num_embedding / embedding_dim / lr / lbs / epochs)."""
    from ldm3d_torch.core.config import replace

    vq = cfg.vqvae
    q = vq.quantizer
    if "channel_list" in point:
        ch = tuple(point["channel_list"])
        n = len(ch)
        vq = replace(vq, num_channels=ch, num_res_channels=ch,
                     downsample_stride=(2,) * n, downsample_kernel=(4,) * n,
                     upsample_stride=(2,) * n, upsample_kernel=(4,) * n)
    if "num_embedding" in point:
        q = replace(q, num_embeddings=int(point["num_embedding"]))
    if "embedding_dim" in point:
        q = replace(q, embedding_dim=int(point["embedding_dim"]))
    vq = replace(vq, quantizer=q)
    cfg = replace(cfg, vqvae=vq)

    train = cfg.train
    if "lr" in point:
        train = replace(train, learning_rate=float(point["lr"]))
    if "lbs" in point:
        train = replace(train, batch_size=int(point["lbs"]))
    if "epochs" in point:
        train = replace(train, epochs=int(point["epochs"]))
    cfg = replace(cfg, train=train)
    if "dataset" in point:
        cfg = replace(cfg, data=replace(cfg.data,
                                        dataset=str(point["dataset"])))
    name = cfg.name + "-" + "-".join(
        f"{k}{point[k]}" for k in sorted(point)
        if k in ("channel_list", "num_embedding", "embedding_dim", "lbs"))
    return replace(cfg, name=name.replace(" ", ""))

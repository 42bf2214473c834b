"""Sample-fidelity metrics in the frozen stage-1 latent space: the port's
own copy of `ldm3d.ops.fid` (numpy in float64, no scipy).

  - `pool_latent_features`: the quantized latent grid pooled to one [2C]
    vector per volume (spatial mean ++ spatial std), the role InceptionV3's
    pool3 plays in image FID, with the stage-1 encoder as the extractor.
  - `frechet_distance`: FID over those features (biased at small N like
    every FID estimate; report N beside it).
  - `kernel_mmd`: unbiased MMD^2 with a multi-scale RBF kernel
    (KID-style, Binkowski et al. 2018).

Everything here runs on the host; the caller's encoder is the only device
work.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np


def pool_latent_features(latents) -> np.ndarray:
    """[B, h, w, d, C] latent grid -> [B, 2C] (spatial mean ++ std)."""
    lat = np.asarray(latents, np.float64)
    b = lat.shape[0]
    flat = lat.reshape(b, -1, lat.shape[-1])
    return np.concatenate([flat.mean(axis=1), flat.std(axis=1)], axis=-1)


def _mean_cov(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(cov)


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Frechet distance |mu_a - mu_b|^2 + tr(Ca + Cb - 2 (Ca Cb)^(1/2)).

    The matrix square root is computed via eigendecompositions of the
    symmetric PSD matrices (sqrt(Ca) Cb sqrt(Ca) has the same nonzero
    spectrum as Ca Cb), with negative eigenvalues from numerical noise
    clipped to zero — no scipy dependency.
    """
    mu_a, cov_a = _mean_cov(np.asarray(feats_a, np.float64))
    mu_b, cov_b = _mean_cov(np.asarray(feats_b, np.float64))

    w, v = np.linalg.eigh(cov_a)
    w = np.clip(w, 0.0, None)
    sqrt_a = (v * np.sqrt(w)) @ v.T
    m = sqrt_a @ cov_b @ sqrt_a
    evals = np.linalg.eigvalsh((m + m.T) / 2.0)
    tr_sqrt = np.sum(np.sqrt(np.clip(evals, 0.0, None)))

    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b)
                 - 2.0 * tr_sqrt)


def kernel_mmd(feats_a: np.ndarray, feats_b: np.ndarray,
               sigmas: Optional[Iterable[float]] = None) -> float:
    """Unbiased squared MMD with a sum-of-RBF kernel.

    `sigmas=None` uses the median heuristic (median pairwise distance of
    the joint sample) at scales {0.5, 1, 2} — scale-free across feature
    spaces. Can be slightly negative at small N (unbiased estimator);
    callers should treat ~0 as "indistinguishable".
    """
    a = np.asarray(feats_a, np.float64)
    b = np.asarray(feats_b, np.float64)

    def sq_dists(x, y):
        xx = (x * x).sum(-1)[:, None]
        yy = (y * y).sum(-1)[None, :]
        return np.clip(xx + yy - 2.0 * x @ y.T, 0.0, None)

    d_aa, d_bb, d_ab = sq_dists(a, a), sq_dists(b, b), sq_dists(a, b)
    if sigmas is None:
        joint = np.concatenate([
            d_aa[np.triu_indices_from(d_aa, 1)],
            d_bb[np.triu_indices_from(d_bb, 1)],
            d_ab.ravel()])
        med = np.sqrt(np.median(joint)) + 1e-12
        sigmas = [0.5 * med, med, 2.0 * med]

    def kern(d):
        return sum(np.exp(-d / (2.0 * s * s)) for s in sigmas)

    k_aa, k_bb, k_ab = kern(d_aa), kern(d_bb), kern(d_ab)
    n, m = a.shape[0], b.shape[0]
    np.fill_diagonal(k_aa, 0.0)
    np.fill_diagonal(k_bb, 0.0)
    mmd2 = (k_aa.sum() / (n * (n - 1)) + k_bb.sum() / (m * (m - 1))
            - 2.0 * k_ab.mean())
    return float(mmd2)


def latent_fidelity(real_feats: np.ndarray, gen_feats: np.ndarray) -> dict:
    """Both fidelity numbers plus the sample counts that qualify them."""
    return {
        "latent_fid": frechet_distance(real_feats, gen_feats),
        "latent_mmd": kernel_mmd(real_feats, gen_feats),
        "n_real": int(np.asarray(real_feats).shape[0]),
        "n_gen": int(np.asarray(gen_feats).shape[0]),
    }

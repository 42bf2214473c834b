"""The port's four stage-1 quantizers, `ema_statistics` and the unused-code
replacement against the JAX package, on the CPU.

Each quantizer (EMA with its data-dependent init still to come and after
it, Sonnet-EMA, NSVQ, RNSVQ; the straight-through one is in
test_torch_encoder.py) runs one forward and backward in training and in
eval mode on both sides from the same codebooks and `vq_stats`. JAX's own
random draws (`jax.random.normal` / `permutation`, recorded while its
module runs eagerly) are injected into the port through `Draws`, so the
two compute the same function: output, loss, perplexity, indices,
gradients (of sum(out * w) + loss, to x and to the codebook parameters)
and the updated state are compared. The replacement's draws are
re-derived from its key with JAX's split sequence.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d.models import quantizers as jq
from ldm3d.ops.quantize import ema_statistics as j_ema_statistics
from ldm3d_torch.core.config import QuantizerConfig
from ldm3d_torch.models import quantizers as tq
from ldm3d_torch.ops.quantize import ema_statistics
from test_torch_quantize import _distances, assert_same_argmin

K, D, S = 16, 8, 3
X_SHAPE = (2, 4, 4, 4, D)        # 128 rows, as the tiny stage-1's latents
# Outputs, losses and gradients: the same float32 arithmetic on both sides
# but for sums over D = 8 (norms) or over 128 rows (means, the one-hot
# sums, which the port forms in float64): 2e-6 relative to the largest
# value of each tensor.
REL_TOL = 2e-6


@contextlib.contextmanager
def recorded(monkeypatch, *names):
    """Record the outputs of `jax.random.<name>` calls, in call order."""
    rec = {n: [] for n in names}
    for n in names:
        real = getattr(jax.random, n)

        def wrap(*a, _real=real, _n=n, **kw):
            out = _real(*a, **kw)
            rec[_n].append(np.array(out))
            return out
        monkeypatch.setattr(jax.random, n, wrap)
    try:
        yield rec
    finally:
        monkeypatch.undo()


def _close(out, ref, tol=REL_TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(out - ref).max()
    assert err <= tol * scale, (err, scale)


def _modules(kind):
    if kind.startswith("ema") and kind != "ema_sonnet":
        return jq.VectorQuantizerEMA(K, D), tq.VectorQuantizerEMA(K, D)
    if kind == "ema_sonnet":
        return (jq.VectorQuantizerEMASonnet(K, D),
                tq.VectorQuantizerEMASonnet(K, D))
    if kind == "nsvq":
        return jq.NSVQ(K, D), tq.NSVQ(K, D)
    return jq.RNSVQ(S, K, D), tq.RNSVQ(S, K, D)


def _variables(kind, jmod, x, rng):
    """A JAX init with its state moved off the init: EMA statistics
    perturbed, usage counts nonzero; `ema_init` keeps need_init True."""
    v = jax.device_get(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                 training=False))
    v = jax.tree_util.tree_map(np.array, v)
    stats = v["vq_stats"]
    if "ema_cluster_size" in stats:
        stats["ema_cluster_size"] = rng.random(K).astype(np.float32) * 3.0
        stats["ema_w"] = stats["ema_w"] + 0.1 * rng.standard_normal(
            (K, D)).astype(np.float32)
    if kind == "ema":
        stats["need_init"] = np.array(False)
        # restart fires for the codes below restart_thres = 1
        stats["codebook"] = (0.3 * rng.standard_normal((K, D))).astype(
            np.float32)
    if "codebooks_used" in stats:
        stats["codebooks_used"] = rng.integers(
            0, 5, stats["codebooks_used"].shape).astype(np.float32)
    return v


def _load(tmod, v):
    state = {**v.get("params", {}), **v["vq_stats"]}
    tmod.load_state_dict({k: torch.from_numpy(np.array(a))
                          for k, a in state.items()}, strict=True)


SEEDS = {"ema_init": 0, "ema": 1, "ema_sonnet": 2, "nsvq": 3, "rnsvq": 4}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["ema_init", "ema", "ema_sonnet", "nsvq",
                                  "rnsvq"])
def test_quantizer_matches(kind, training, monkeypatch):
    rng = np.random.default_rng(SEEDS[kind])
    x = (0.5 * rng.standard_normal(X_SHAPE)).astype(np.float32)
    w = rng.standard_normal(X_SHAPE).astype(np.float32)
    jmod, tmod = _modules(kind)
    v = _variables(kind, jmod, x, rng)
    params = v.get("params", {})

    def f(xin, p):
        (out, aux), upd = jmod.apply(
            {**v, "params": p} if p else v, xin, training=training,
            mutable=["vq_stats"], rngs={"noise": jax.random.PRNGKey(7)})
        return jnp.sum(out * w) + aux.loss, (out, aux, upd)

    with recorded(monkeypatch, "normal", "permutation") as draws:
        (_, (ref, aux, upd)), grads = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)
    _load(tmod, v)
    tmod.train(training)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, taux = tmod(xt, tq.Draws(**draws))
    (torch.sum(out * torch.from_numpy(w)) + taux.loss).backward()

    _close(out.detach().numpy(), ref)
    np.testing.assert_allclose(taux.loss.item(), float(aux.loss), rtol=1e-5)
    np.testing.assert_allclose(taux.perplexity.item(), float(aux.perplexity),
                               rtol=1e-6)
    np.testing.assert_array_equal(taux.indices.numpy(),
                                  np.asarray(aux.indices))
    np.testing.assert_array_equal(taux.usage_counts.numpy(),
                                  np.asarray(aux.usage_counts))
    _close(xt.grad.numpy(), grads[0])
    for name, g in grads[1].items():
        _close(getattr(tmod, name).grad.numpy(), g)
    # the state after the pass: moved in training mode only
    for name, a in upd["vq_stats"].items():
        got = getattr(tmod, name).numpy()
        if a.dtype == np.bool_ or name == "codebooks_used":
            np.testing.assert_array_equal(got, np.asarray(a))
        else:
            _close(got, a)
        if not training:
            np.testing.assert_array_equal(got, v["vq_stats"][name])


def test_ste_and_nsvq_pick_as_jax():
    # The straight-through and NSVQ lookups choose the JAX package's codes
    # (exact unless a near-tie of the float distances).
    rng = np.random.default_rng(3)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    jmod, tmod = _modules("nsvq")
    v = jax.device_get(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                 training=False))
    _, aux = jmod.apply(v, jnp.asarray(x), training=False)
    _load(tmod, jax.tree_util.tree_map(np.array, v))
    _, taux = tmod.eval()(torch.from_numpy(x))
    cb = np.asarray(v["params"]["codebook"])
    assert_same_argmin(taux.indices.reshape(-1).numpy(),
                       np.asarray(aux.indices).reshape(-1),
                       _distances(x.reshape(-1, D), cb))


def test_ema_statistics_matches():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, D)).astype(np.float32)
    idx = rng.integers(0, K, 300).astype(np.int32)
    idx[:5] = 3
    counts, sums = ema_statistics(torch.from_numpy(x), torch.from_numpy(idx),
                                  K)
    j_counts, j_sums = j_ema_statistics(jnp.asarray(x), jnp.asarray(idx), K)
    assert counts.dtype == sums.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    # float32 sums of up to 300 terms against float64 ones rounded once
    _close(sums.numpy(), j_sums, tol=1e-6)


@pytest.mark.parametrize("n", [40, 7])    # 7 < K: the rows are tiled
def test_random_rows_matches(n, monkeypatch):
    rng = np.random.default_rng(n)
    flat = rng.standard_normal((n, D)).astype(np.float32)
    with recorded(monkeypatch, "normal", "permutation") as draws:
        ref = jq.VectorQuantizerEMA(K, D)._random_rows(
            jnp.asarray(flat), jax.random.PRNGKey(n))
    assert len(draws["normal"]) == (n < K)
    out = tq.random_rows(torch.from_numpy(flat), K, tq.Draws(**draws))
    assert out.shape == (K, D)
    _close(out.numpy(), ref, tol=1e-7)


def _replacement_draws(key, usage, k, shape, threshold, num_batches):
    """JAX's draws of `replace_unused_codebooks(..., key)`."""
    used = usage / max(num_batches, 1) >= threshold
    p = used.astype(np.float32)
    p = p / max(p.sum(), 1.0) if used.any() else np.full(k, 1.0 / k,
                                                          np.float32)
    choice_rng, noise_rng = jax.random.split(key)
    donors = jax.random.choice(choice_rng, k, shape=(k,), p=jnp.asarray(p))
    noise = jax.random.normal(noise_rng, shape, jnp.float32)
    return np.asarray(donors), np.asarray(noise)


@pytest.mark.parametrize("case", ["some_used", "none_used"])
def test_replace_unused_codebooks_matches(case):
    rng = np.random.default_rng(5)
    cb = rng.standard_normal((K, D)).astype(np.float32)
    usage = rng.integers(0, 3, K).astype(np.float32) \
        if case == "some_used" else np.zeros(K, np.float32)
    key = jax.random.PRNGKey(11)
    ref_cb, ref_usage, ref_n = jq.replace_unused_codebooks(
        jnp.asarray(cb), jnp.asarray(usage), 4, key, 0.3)
    donors, noise = _replacement_draws(key, usage, K, cb.shape, 0.3, 4)
    new, new_usage, n = tq.replace_unused_codebooks(
        torch.from_numpy(cb), torch.from_numpy(usage), 4,
        tq.Draws(choice=[donors], normal=[noise]), 0.3)
    np.testing.assert_array_equal(new.numpy(), np.asarray(ref_cb))
    np.testing.assert_array_equal(new_usage.numpy(), np.asarray(ref_usage))
    assert n == int(ref_n) and (n == K) == (case == "none_used")


def test_replace_unused_codebooks_staged_matches():
    rng = np.random.default_rng(6)
    cbs = rng.standard_normal((S, K, D)).astype(np.float32)
    usage = rng.integers(0, 3, (S, K)).astype(np.float32)
    usage[1] = 0.0                        # a dead stage: all jittered
    key = jax.random.PRNGKey(12)
    ref_cb, ref_usage, ref_n = jq.replace_unused_codebooks_staged(
        jnp.asarray(cbs), jnp.asarray(usage), 2, key, 0.5)
    choices, normals = [], []
    for i, sub in enumerate(jax.random.split(key, S)):
        d, z = _replacement_draws(sub, usage[i], K, (K, D), 0.5, 2)
        choices.append(d)
        normals.append(z)
    new, new_usage, n = tq.replace_unused_codebooks_staged(
        torch.from_numpy(cbs), torch.from_numpy(usage), 2,
        tq.Draws(choice=choices, normal=normals), 0.5)
    np.testing.assert_array_equal(new.numpy(), np.asarray(ref_cb))
    np.testing.assert_array_equal(new_usage.numpy(), np.asarray(ref_usage))
    assert n == int(ref_n)


def test_replacement_from_a_generator_keeps_used_codes():
    # Drawn from a generator (the trainer's way): used rows stay, dead ones
    # become used rows plus eps noise.
    cb = torch.arange(K * D, dtype=torch.float32).reshape(K, D)
    usage = torch.zeros(K)
    usage[[2, 5]] = 4.0
    gen = torch.Generator().manual_seed(0)
    new, _, n = tq.replace_unused_codebooks(cb, usage, 1, tq.Draws(gen))
    assert n == K - 2
    assert torch.equal(new[[2, 5]], cb[[2, 5]])
    dead = [i for i in range(K) if i not in (2, 5)]
    near = torch.minimum((new[dead] - cb[2]).abs().amax(1),
                         (new[dead] - cb[5]).abs().amax(1))
    assert float(near.max()) < 1e-8


def test_training_mode_needs_draws():
    for kind in ("nsvq", "rnsvq", "ema"):
        q = tq.make_quantizer(QuantizerConfig(kind=kind, num_embeddings=K,
                                              embedding_dim=D))
        with pytest.raises(ValueError, match="draws"):
            q(torch.zeros(X_SHAPE))
        q.eval()(torch.zeros(X_SHAPE))      # eval draws nothing

"""Batched 1D Gaussian-mixture EM: every (group, component-count, restart)
model in ONE device program.

The reference fits its intensity-level mixtures one model at a time with
old scikit-learn, fanning the per-num_fluors fits over a process Pool
(/root/reference/MCsimlib.py:3209-3304 [_gmm_photometries(_MP)]) and the
per-cycle fits over another (:3307-3375 [_per_cycle_gmm_MP]) — the last of
SURVEY section 2.4's P4 parameter-space fan-outs without a batched
equivalent.

Design: a 1D GMM's EM iteration is nothing but dense reductions, so
ALL models fit simultaneously as one array program:

  models   (G, B, K)   G groups (e.g. cycles; each has its own data) x
                       B = component-choices x restarts, padded to
                       K = max components with an active-component mask
  E-step   (G, B, c, K) responsibilities per data chunk; a lax.scan over
                       chunks accumulates the three sufficient statistics
                       (Nk, Sk, Qk) so memory stays bounded at any N
  M-step   closed form from the statistics — a handful of (G, B, K)
                       vector ops

Iterations run in lockstep under lax.fori_loop (the reference caps at
n_iter=100 with no adaptive stopping either). Data is standardized per
group on host (float64), so float32 device math operates on O(1) values;
log-likelihoods and BICs are reported back on the ORIGINAL scale
(LL_orig = LL_std - N*log(s)). Restart selection (best final
log-likelihood, sklearn's n_init rule) and BIC model selection happen on
host over the fetched (G, B) results.

The model axis is pure data parallelism: with ``mesh`` the B axis shards
over the mesh's first axis (no collectives — each model's EM is
self-contained), exactly like the other P-pattern collapses in this
package (ops/lognormal.py, ops/stepfit_batch.py).
"""

from __future__ import annotations

import functools
import math

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
import numpy as np

_LOG_2PI = math.log(2.0 * math.pi)


@functools.partial(jax.jit, static_argnames=("n_iter",))
def _em_batched(z, valid, w0, mu0, var0, comp_mask, n_iter, reg):
    """Run n_iter lockstep EM iterations for every model.

    z, valid: (nch, G, c) float32 — chunked standardized data + 0/1 mask.
    w0, mu0, var0: (G, B, K) float32 initial parameters.
    comp_mask: (G, B, K) bool — active components (k varies across B).
    reg: variance floor on the standardized scale (sklearn reg_covar).

    Returns (w, mu, var, loglik): final parameters and the per-model
    total log-likelihood (G, B) under them.
    """
    n_valid = valid.sum(axis=(0, 2))                      # (G,)
    neg_inf = jnp.asarray(-1e30, z.dtype)

    def e_stats(params, zc, vc):
        """Sufficient statistics + loglik of one (G, c) data chunk."""
        w, mu, var = params
        logw = jnp.where(comp_mask, jnp.log(jnp.maximum(w, 1e-30)), neg_inf)
        diff = zc[:, None, :, None] - mu[:, :, None, :]   # (G, B, c, K)
        logp = (logw[:, :, None, :]
                - 0.5 * (jnp.log(var)[:, :, None, :] + _LOG_2PI)
                - 0.5 * diff * diff / var[:, :, None, :])
        lse = jax.scipy.special.logsumexp(logp, axis=-1)  # (G, B, c)
        resp = jnp.exp(logp - lse[..., None]) * vc[:, None, :, None]
        nk = resp.sum(axis=2)                             # (G, B, K)
        sk = (resp * zc[:, None, :, None]).sum(axis=2)
        qk = (resp * (zc * zc)[:, None, :, None]).sum(axis=2)
        ll = (lse * vc[:, None, :]).sum(axis=2)           # (G, B)
        return nk, sk, qk, ll

    def iteration(_, params):
        def chunk_step(carry, xs):
            nk0, sk0, qk0 = carry
            nk, sk, qk, _ = e_stats(params, *xs)
            return (nk0 + nk, sk0 + sk, qk0 + qk), None
        zero = jnp.zeros_like(w0)
        (nk, sk, qk), _ = jax.lax.scan(chunk_step, (zero, zero, zero),
                                       (z, valid))
        nk_safe = jnp.maximum(nk, 1e-10)
        mu = sk / nk_safe
        var = jnp.maximum(qk / nk_safe - mu * mu, 0.0) + reg
        w = jnp.where(comp_mask, nk / n_valid[:, None, None], 0.0)
        w = w / jnp.maximum(w.sum(-1, keepdims=True), 1e-30)
        return (w,
                jnp.where(comp_mask, mu, 0.0),
                jnp.where(comp_mask, var, 1.0))

    params = jax.lax.fori_loop(0, n_iter, iteration, (w0, mu0, var0))

    def ll_step(acc, xs):
        return acc + e_stats(params, *xs)[3], None

    loglik, _ = jax.lax.scan(ll_step, jnp.zeros(w0.shape[:2], z.dtype),
                             (z, valid))
    return params[0], params[1], params[2], loglik


def _init_params(z_groups, n_valid, ks, n_init, K, rng):
    """Host-side initial parameters for every (group, k-choice, restart).

    Restart 0 seeds component means at the data quantiles (a deterministic
    good start); the rest draw means from the group's data points (the
    classic random-restart init). Variances start at 1 (standardized
    scale), weights uniform over the k active components.
    """
    G = len(z_groups)
    J = len(ks)
    B = J * n_init
    w0 = np.zeros((G, B, K), np.float32)
    mu0 = np.zeros((G, B, K), np.float32)
    var0 = np.ones((G, B, K), np.float32)
    comp_mask = np.zeros((G, B, K), bool)
    for g in range(G):
        zv = np.sort(z_groups[g][:n_valid[g]])
        if zv.size == 0:
            zv = np.zeros(1)
        for j, k in enumerate(ks):
            for r in range(n_init):
                b = j * n_init + r
                comp_mask[g, b, :k] = True
                w0[g, b, :k] = 1.0 / k
                if r == 0:
                    pos = ((np.arange(k) + 0.5) / k * (zv.size - 1))
                else:
                    # Random QUANTILE positions (sorted): restarts stay
                    # spread over the data mass instead of occasionally
                    # stacking two components in one cluster — measurably
                    # closes the worst-restart gap vs kmeans-seeded
                    # sklearn at over-parameterized k.
                    pos = np.sort(rng.random(k)) * (zv.size - 1)
                # ROUND, don't truncate: with truncation a size-k group
                # seeds every mean at index 0 (n=2, k=2: quantiles 0.25
                # and 0.75 both floor to 0) and the symmetric EM never
                # separates them; rounding reaches the last data point.
                mu0[g, b, :k] = zv[np.floor(pos + 0.5).astype(int)]
    return w0, mu0, var0, comp_mask


def gmm_fit_batched(groups, ks, n_init=10, n_iter=100, reg=1e-6,
                    seed=0, chunk=2048, mesh=None):
    """Fit 1D GMMs with every component count in ``ks`` to every data
    group, n_init restarts each, in one batched device program.

    Arguments:
        groups: sequence of 1D arrays (may be ragged — each group is its
            own dataset, e.g. one sequencing cycle's intensities).
        ks: component counts to fit (the reference uses num_fluors + 1
            for num_fluors in [min_fluors, max_fluors]).
        n_init / n_iter: restarts and EM iterations (reference defaults
            10 / 100, MCsimlib.py:3209).
        reg: variance floor on the standardized scale.
        seed: restart-initialization seed (deterministic).
        chunk: data chunk length of the E-step scan.
        mesh: optional jax.sharding.Mesh — shards the model axis over the
            mesh's first axis (pure data parallelism, no collectives).

    Returns a dict of host arrays, best-over-restarts per (group, k):
        weights, means, vars: (G, J, K_max) float64, original scale,
            entries beyond k zero;
        loglik: (G, J) float64 total log-likelihood (original scale);
        bic / aic: (G, J) float64 (sklearn's conventions: p = 3k - 1
            parameters for a full-covariance 1D mixture);
        counts: (G,) int — data points per group.
    """
    groups = [np.asarray(g, np.float64).ravel() for g in groups]
    if not groups or any(g.size == 0 for g in groups):
        raise ValueError("every group needs at least one data point")
    ks = [int(k) for k in ks]
    if not ks or min(ks) < 1:
        raise ValueError("ks must be positive component counts")
    short = [g for g, arr in enumerate(groups) if arr.size < max(ks)]
    if short:
        # sklearn raises the same way ("n_samples >= n_components"); a
        # k-component mixture of fewer points would silently return a
        # collapsed degenerate fit.
        raise ValueError(
            f"groups {short} have fewer data points than the largest "
            f"component count ({max(ks)}); a mixture needs n_samples >= "
            "n_components")
    G = len(groups)
    J = len(ks)
    K = max(ks)
    n_valid = np.array([g.size for g in groups])
    N = int(n_valid.max())

    # Standardize per group on host (float64): device math sees O(1).
    mean_g = np.array([g.mean() for g in groups])
    std_g = np.array([max(float(g.std()), 1e-12) for g in groups])
    n_pad = -(-N // chunk) * chunk
    z = np.zeros((G, n_pad), np.float32)
    valid = np.zeros((G, n_pad), np.float32)
    for g, arr in enumerate(groups):
        z[g, :arr.size] = (arr - mean_g[g]) / std_g[g]
        valid[g, :arr.size] = 1.0

    rng = np.random.default_rng(seed)
    w0, mu0, var0, comp_mask = _init_params(
        [z[g] for g in range(G)], n_valid, ks, n_init, K, rng)
    B = w0.shape[1]

    nch = n_pad // chunk
    z_c = np.ascontiguousarray(
        z.reshape(G, nch, chunk).transpose(1, 0, 2))
    valid_c = np.ascontiguousarray(
        valid.reshape(G, nch, chunk).transpose(1, 0, 2))

    pad_b = 0
    place_model = jnp.asarray
    place_data = jnp.asarray
    if mesh is not None:
        from ..utils.dispatch import mesh_row_sharding
        from jax.sharding import NamedSharding, PartitionSpec as P

        row_sharding, n_dev = mesh_row_sharding(mesh)
        axis = row_sharding.spec[0]
        pad_b = (-B) % n_dev
        if pad_b:
            # Filler models (k=1 on the first data chunk's worth of
            # zeros): sliced off after the fetch.
            def pad(a, fill):
                return np.concatenate(
                    [a, np.broadcast_to(fill, (G, pad_b, K)).astype(a.dtype)],
                    axis=1)
            w0 = pad(w0, 0.0)
            mu0 = pad(mu0, 0.0)
            var0 = pad(var0, 1.0)
            comp_mask = np.concatenate(
                [comp_mask,
                 np.tile((np.arange(K) == 0)[None, None], (G, pad_b, 1))],
                axis=1)
        model_sharding = NamedSharding(mesh, P(None, axis, None))
        place_model = lambda a: jax.device_put(a, model_sharding)
        place_data = lambda a: jax.device_put(
            a, NamedSharding(mesh, P()))

    w, mu, var, ll = _em_batched(
        place_data(z_c), place_data(valid_c), place_model(w0),
        place_model(mu0), place_model(var0), place_model(comp_mask),
        int(n_iter), np.float32(reg))
    # Slice off mesh filler models (if any) before restart selection.
    w = np.asarray(w, np.float64)[:, :B]
    mu = np.asarray(mu, np.float64)[:, :B]
    var = np.asarray(var, np.float64)[:, :B]
    ll = np.asarray(ll, np.float64)[:, :B]

    # Best restart per (group, k-choice) by final log-likelihood
    # (sklearn's n_init selection rule).
    ll = ll.reshape(G, J, n_init)
    best_r = ll.argmax(axis=-1)                            # (G, J)
    gj = np.ix_(range(G), range(J))

    def take(a):
        return a.reshape(G, J, n_init, K)[gj + (best_r,)]

    w_best = take(w)
    mu_best = take(mu)
    var_best = take(var)
    ll_std = np.take_along_axis(ll, best_r[..., None], axis=-1)[..., 0]

    # Back-transform to the original scale; LL picks up the Jacobian
    # -N*log(s) of the standardization.
    means = mean_g[:, None, None] + std_g[:, None, None] * mu_best
    vars_ = (std_g[:, None, None] ** 2) * var_best
    active = np.zeros((J, K), bool)
    for j, k in enumerate(ks):
        active[j, :k] = True
    means = np.where(active[None], means, 0.0)
    vars_ = np.where(active[None], vars_, 0.0)
    ll_orig = ll_std - (n_valid * np.log(std_g))[:, None]
    p = np.array([3 * k - 1 for k in ks], np.float64)
    bic = -2.0 * ll_orig + p[None] * np.log(n_valid)[:, None]
    aic = -2.0 * ll_orig + 2.0 * p[None]
    return {"weights": w_best, "means": means, "vars": vars_,
            "loglik": ll_orig, "bic": bic, "aic": aic, "counts": n_valid}

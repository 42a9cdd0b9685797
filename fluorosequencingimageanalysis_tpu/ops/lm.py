"""Batched bounded Levenberg–Marquardt for 2D Gaussian PSF fits.

The reference fits every 5x5 candidate patch *one at a time* with the MINPACK
-lineage ``mpfit`` trust-region LM (/root/reference/agpy/mpfit/mpfit.py:1030-
1341; <=200 iterations x ~8 residual evaluations each, per spot). Here we
instead run thousands of fits as one lockstep array program inside a single
``lax.fori_loop``.

Layout: everything is *lane-major* structure-of-arrays — parameters are
seven (N,) vectors, pixel quantities are (25, N), and the normal matrix is
(7, 7, N) — so the fit-batch axis N is the contiguous, vectorized axis and
every op is a full-width elementwise op. The naive batch-major layout ((N, 25, 5x5)
tensors + batched LU solves) pads its minor dims onto (8, 128) tiles with
~18x waste and is an order of magnitude slower. The 7x7 SPD system is solved
by a compile-time-unrolled Cholesky (no LU, no scalar loops), and the
Jacobian is closed-form.

Bound semantics follow mpfit's parinfo model:
- box constraints enforced by projecting trial steps into [lo, hi]
  (mpfit.py:1177-1231 clips steps to limits),
- parameters *pegged* at a bound with the gradient pushing outward have their
  Jacobian column zeroed (mpfit.py:1072-1091),
and the objective is the plain sum of squared residuals, so tightly-converged
solutions match mpfit's to within the 1e-3 target (interior optima are
algorithm-independent stationary points).

Default bounds/inits replicate pflib's empirical setup
(/root/reference/pflib.py:199-214):
    p0 = (median, max, 2.5, 2.5, 1, 1, 0)
    lo = (0, (max-mean)/3, 2, 2, 0.75, 0.75, 0)
    hi = (inf, inf, 3, 3, 2, 2, 360)
"""

from __future__ import annotations

import functools

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
from jax import lax

_BIG = 1e30  # stand-in for +inf in bounds (keeps arithmetic finite)
_DEG2RAD = jnp.pi / 180.0


def default_fit_init(patches):
    """Per-patch initial parameters, parity with pflib.py:199-206.

    patches: (N, S, S) float array.
    Returns (N, 7) initial parameter vectors.
    """
    med = jnp.median(patches.reshape(patches.shape[0], -1), axis=-1)
    amax = jnp.max(patches.reshape(patches.shape[0], -1), axis=-1)
    n = patches.shape[0]
    ones = jnp.ones((n,), patches.dtype)
    c = (patches.shape[-1] / 2.0) * ones  # 2.5 for 5x5
    return jnp.stack(
        [med, amax, c, c, ones, ones, jnp.zeros((n,), patches.dtype)], axis=-1)


def default_fit_bounds(patches):
    """Per-patch (lo, hi) bounds, parity with pflib.py:204-212.

    The amplitude lower bound is data-dependent: (max - mean) / 3.
    """
    flat = patches.reshape(patches.shape[0], -1)
    amax = jnp.max(flat, axis=-1)
    amean = jnp.mean(flat, axis=-1)
    n = patches.shape[0]
    dt = patches.dtype
    zeros = jnp.zeros((n,), dt)
    lo = jnp.stack([zeros, (amax - amean) / 3.0,
                    2.0 * jnp.ones((n,), dt), 2.0 * jnp.ones((n,), dt),
                    0.75 * jnp.ones((n,), dt), 0.75 * jnp.ones((n,), dt),
                    zeros], axis=-1)
    hi = jnp.stack([jnp.full((n,), _BIG, dt), jnp.full((n,), _BIG, dt),
                    3.0 * jnp.ones((n,), dt), 3.0 * jnp.ones((n,), dt),
                    2.0 * jnp.ones((n,), dt), 2.0 * jnp.ones((n,), dt),
                    360.0 * jnp.ones((n,), dt)], axis=-1)
    return lo, hi


def _model_and_jac(p, hg, wg, want_jac=True):
    """Model values and closed-form Jacobian, lane-major.

    p: list of 7 (N,) parameter vectors [H, A, c2, c3, sh, sw, theta_deg].
    hg, wg: (25, 1) pixel index grids (broadcast against N).
    Returns model (25, N) and, if want_jac, J as a list of 7 (25, N) arrays.
    """
    H, A, c2, c3, sh, sw, th = p
    rota = th * _DEG2RAD
    cos_r = jnp.cos(rota)
    sin_r = jnp.sin(rota)
    # du = rcx - xp = (c3 - h)cos - (c2 - w)sin ; dv = rcy - yp (25, N)
    dh = c3[None, :] - hg
    dw = c2[None, :] - wg
    du = dh * cos_r[None, :] - dw * sin_r[None, :]
    dv = dh * sin_r[None, :] + dw * cos_r[None, :]
    u = du / sh[None, :]
    v = dv / sw[None, :]
    E = jnp.exp(-(u * u + v * v) * 0.5)
    AE = A[None, :] * E
    model = H[None, :] + AE
    if not want_jac:
        return model, None
    us = u / sh[None, :]
    vs = v / sw[None, :]
    jH = jnp.ones_like(E)
    jA = E
    # d(du)/dc2 = -sin, d(dv)/dc2 = cos ; d(du)/dc3 = cos, d(dv)/dc3 = sin
    jc2 = AE * (u * sin_r[None, :] / sh[None, :] -
                v * cos_r[None, :] / sw[None, :])
    jc3 = -AE * (u * cos_r[None, :] / sh[None, :] +
                 v * sin_r[None, :] / sw[None, :])
    jsh = AE * u * us
    jsw = AE * v * vs
    # d(du)/d(theta_r) = -dv, d(dv)/d(theta_r) = du
    jth = _DEG2RAD * AE * u * v * (sw / sh - sh / sw)[None, :]
    return model, [jH, jA, jc2, jc3, jsh, jsw, jth]


def _cholesky_solve_7(Amat, g):
    """Solve A x = g for a 7x7 SPD system, fully unrolled, lane-major.

    Amat: list-of-lists with (N,) entries (symmetric, only [i][j] for j<=i
    used). g: list of 7 (N,) vectors. Returns list of 7 (N,) solutions.
    """
    n = 7
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        s = Amat[i][i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-30))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, n):
            s = Amat[j][i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv_d
    # forward substitution L y = g
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


@functools.partial(jax.jit, static_argnames=("num_iters", "theta_starts"))
def fit_gaussians_batched(patches, p0=None, lo=None, hi=None, num_iters=60,
                          lam0=1e-3, lam_up=4.0, lam_down=0.25,
                          theta_starts=1):
    """Fit the reference 2D Gaussian to a batch of square patches.

    Arguments:
        patches: (N, S, S) float array of pixel patches (raw intensity units).
        p0: optional (N, 7) initial parameters; defaults to pflib's empirical
            init (pflib.py:199-206).
        lo, hi: optional (N, 7) box bounds; default to pflib's parinfo bounds
            (pflib.py:204-212).
        num_iters: fixed LM iteration count (batch runs in lockstep; the
            reference allows up to 200 mpfit iterations, mpfit.py:602).

    Returns:
        params: (N, 7) fitted ``(H, A, h_0, w_0, sigma_h, sigma_w, theta)`` in
            patch coordinates and raw intensity units (reference convention,
            see ops.gaussian for the axis quirk).
        cost: (N,) final sum of squared residuals (raw units squared).

    Numerical note: each patch is normalized by its max absolute value before
    optimization (the model is linear in H and A, so only those two parameters
    and their bounds are rescaled). This keeps the LM well-conditioned in
    float32 regardless of camera bit depth.
    """
    patches = jnp.asarray(patches)
    if not jnp.issubdtype(patches.dtype, jnp.floating):
        # Integer patches (raw camera dtypes) must not set the COMPUTE
        # dtype: lam0=1e-3 truncates to 0 in an integer lam buffer,
        # silently disabling damping (floor-damped Gauss-Newton stalls
        # on ill-conditioned patches). The detect wrappers cast before
        # calling; direct ops users get the same treatment here.
        patches = patches.astype(jnp.float32)
    dt = patches.dtype
    n, S = patches.shape[0], patches.shape[-1]
    npix = S * S
    if p0 is None:
        p0 = default_fit_init(patches)
    if lo is None or hi is None:
        dlo, dhi = default_fit_bounds(patches)
        lo = dlo if lo is None else lo
        hi = dhi if hi is None else hi
    # mpfit refuses out-of-range starts; gaussfit clips them in
    # (gaussfitter.py:201-204). Replicate.
    p0 = jnp.clip(p0, lo, hi)

    # Per-patch intensity normalization (affects only H and A linearly).
    scale = jnp.maximum(
        jnp.max(jnp.abs(patches.reshape(n, -1)), axis=-1), 1e-12)
    intensity = [True, True, False, False, False, False, False]

    # Lane-major layout: data (npix, N); params/bounds as lists of (N,).
    data = patches.reshape(n, npix).T / scale[None, :]
    p = [jnp.where(intensity[i], p0[:, i] / scale, p0[:, i])
         for i in range(7)]
    lo_l = [jnp.where(intensity[i], lo[:, i] / scale, lo[:, i])
            for i in range(7)]
    hi_l = [jnp.where(intensity[i], hi[:, i] / scale, hi[:, i])
            for i in range(7)]

    idx = jnp.arange(npix)
    hg = (idx // S).astype(dt)[:, None]
    wg = (idx % S).astype(dt)[:, None]

    def cost_of(plist):
        m, _ = _model_and_jac(plist, hg, wg, want_jac=False)
        r = m - data
        return jnp.sum(r * r, axis=0)

    def body(_it, state):
        p, lam, cost = state
        m, J = _model_and_jac(p, hg, wg, want_jac=True)
        r = m - data
        g = [jnp.sum(J[i] * r, axis=0) for i in range(7)]
        # mpfit pegging (mpfit.py:1072-1091): zero Jacobian columns of
        # parameters at a bound whose gradient pushes outward.
        free = []
        for i in range(7):
            eps_lo = jnp.maximum(jnp.abs(lo_l[i]), 1.0) * 1e-7
            eps_hi = jnp.maximum(jnp.abs(hi_l[i]), 1.0) * 1e-7
            pegged = (((p[i] <= lo_l[i] + eps_lo) & (g[i] > 0)) |
                      ((p[i] >= hi_l[i] - eps_hi) & (g[i] < 0)))
            free.append(~pegged)
        Jf = [jnp.where(free[i][None, :], J[i], 0.0) for i in range(7)]
        gf = [jnp.where(free[i], g[i], 0.0) for i in range(7)]
        A = [[None] * 7 for _ in range(7)]
        for i in range(7):
            for j in range(i + 1):
                A[i][j] = jnp.sum(Jf[i] * Jf[j], axis=0)
        diag = [A[i][i] for i in range(7)]
        diag_max = diag[0]
        for i in range(1, 7):
            diag_max = jnp.maximum(diag_max, diag[i])
        # Marquardt scaling. Degenerate directions (e.g. theta for circular
        # spots) have ~zero curvature; floor their damping relative to the
        # dominant diagonal so the junk component of the step stays bounded.
        floor = jnp.maximum(1e-8 * diag_max, 1e-12)
        for i in range(7):
            A[i][i] = diag[i] + lam * jnp.maximum(diag[i], floor) + floor
        delta = _cholesky_solve_7(A, gf)
        p_new = [jnp.clip(p[i] - delta[i], lo_l[i], hi_l[i])
                 for i in range(7)]
        new_cost = cost_of(p_new)
        accept = new_cost < cost
        p = [jnp.where(accept, p_new[i], p[i]) for i in range(7)]
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept,
                        jnp.maximum(lam * lam_down, 1e-12),
                        jnp.minimum(lam * lam_up, 1e12))
        return p, lam, cost

    # Fixed-trip fori_loop, not an early-exit while_loop: lockstep batches
    # essentially never have EVERY fit converge early (noise patches wander
    # at their bounds), so a convergence test only adds a cross-lane
    # reduction per iteration.
    lam_init = jnp.full((n,), lam0, dt)
    state0 = (p, lam_init, cost_of(p))
    p, _, cost = lax.fori_loop(0, num_iters, body, state0)

    if theta_starts > 1:
        # Multi-start over theta (opt-in; pflib/mpfit single-start from
        # theta0=0 is the reference behavior). The model satisfies
        # (sh, sw, theta) == (sw, sh, theta+90): optima across the 0/360
        # wraparound are unreachable from theta0=0 (theta pegs at the
        # bound); a second start at theta0=90 with swapped sigma inits
        # covers them. Per-patch lowest cost wins.
        # Restart from p0 (NOT the converged p), only theta/sigmas change.
        p90 = [jnp.where(intensity[i], p0[:, i] / scale, p0[:, i])
               for i in range(7)]
        p90[4], p90[5] = p90[5], p90[4]
        # Re-clip the swapped sigmas into their OWN bounds: with
        # asymmetric user sigma bounds the swap can start (and, on a
        # patch no step improves, finish) out of bounds.
        p90[4] = jnp.clip(p90[4], lo_l[4], hi_l[4])
        p90[5] = jnp.clip(p90[5], lo_l[5], hi_l[5])
        p90[6] = jnp.clip(jnp.full((n,), 90.0, dt), lo_l[6], hi_l[6])
        state90 = (p90, jnp.full((n,), lam0, dt), cost_of(p90))
        q, _, cost90 = lax.fori_loop(0, num_iters, body, state90)
        better = cost90 < cost
        p = [jnp.where(better, q[i], p[i]) for i in range(7)]
        cost = jnp.where(better, cost90, cost)

    params = jnp.stack(
        [p[i] * scale if intensity[i] else p[i] for i in range(7)], axis=-1)
    return params, cost * scale ** 2

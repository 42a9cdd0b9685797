"""Device-batched Kerssemakers chi-squared step fitting (VERDICT r4 #8).

The reference's ``chi_squared_step_fitter``
(/root/reference/stepfitting_library.py:342-505) is a sequential
best-fit/counter-fit chain per trace. Round 4 batched it across traces in
C++ (native/chisqfit.cpp, bit-equal to the host oracle). This module is
the DEVICE alternative: the split evaluations at every candidate position
are forbidden-set-independent range statistics — exactly the property the
C++ range cache exploits — so one [N, T] pass per growth step evaluates
every trace's every split at once (cumsum/cummax segment algebra, no
scans), and the growth loop is a statically-unrolled
``num_plateaus``-deep chain inside ONE jitted program. Chain assembly
(plateau triples with the host's exact ``np.mean`` heights) happens on
host from the fetched winning starts masks.

Numerics contract: the native core is bit-equal to the host chain and
remains the ORACLE. This engine computes range residuals with fp-rounded
means in the input dtype (float64 by default) — equal to the host in
exact arithmetic but not in float op order (the host mixes numpy pairwise
means with Python sequential residual sums, an order no batched device
program can reproduce). Divergence is therefore confined to near-tied
split decisions; tests/test_chisq_device.py measures the agreement rate
on noisy workloads (exact plateau equality trace-for-trace) and documents
quantized-tie divergence. Engine selection is a per-backend constant
(utils/probes.chisq_engine): the native core won the A/B on an H100 host
(PERF.md); the device engine exists for deployments where host cores,
not devices, are the scarce resource.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _segment_bounds(starts):
    """Per-position segment bounds from a starts mask. starts: [T] bool
    with starts[0] True. Returns (a, b): inclusive start/stop index of
    the segment containing each position."""
    T = starts.shape[0]
    idx = jnp.arange(T)
    a = jax.lax.cummax(jnp.where(starts, idx, -1))
    ends = jnp.concatenate([starts[1:], jnp.ones((1,), bool)])
    b = jax.lax.cummin(jnp.where(ends, idx, T), reverse=True)
    return a, b


def _split_step(x, cs1, cs2, starts, msl, msm, big, extra_forbidden=None):
    """One best-split growth step for ONE trace (vmapped over N).

    Evaluates every split position u (a split separates u from u+1 inside
    u's current plateau), applies the reference's validity rules
    (stepfitting_library.py:113-271):

    - min_step_length: u - a < msl or b - u < msl is forbidden;
    - min_step_magnitude: |mean_left - mean_right| < msm is forbidden;
    - total residual must beat ``big`` = T * span^2 STRICTLY
      (_best_split's initial best_residuals; _split_plateau's 2*big
      initialization is subsumed);
    - ``extra_forbidden`` [T] masks counterfit-constrained positions.

    Winner = lexicographic min of (total, plateau_start, -u): within one
    plateau the reference's ``<=`` keeps the LAST tied split; across
    plateaus its strict ``<`` keeps the FIRST tied plateau.

    Returns (new_starts, grew).
    """
    T = x.shape[0]
    u = jnp.arange(T)
    a, b = _segment_bounds(starts)

    cnt_l = (u - a + 1).astype(x.dtype)
    sum_l = cs1[u + 1] - cs1[a]
    ssq_l = cs2[u + 1] - cs2[a]
    cnt_r = (b - u).astype(x.dtype)
    sum_r = cs1[b + 1] - cs1[u + 1]
    ssq_r = cs2[b + 1] - cs2[u + 1]

    # In-plateau split positions only: u+1 must be in the same segment.
    can_split = (u < T - 1) & (b > u)
    cnt_r_safe = jnp.maximum(cnt_r, 1.0)
    mean_l = sum_l / cnt_l
    mean_r = sum_r / cnt_r_safe
    # Residual with the fp-rounded mean substituted back (the host
    # computes sum((x - mean)**2) AFTER rounding mean; expanding that
    # square keeps the same rounded mean in every term). Clamped at 0:
    # the host's direct sum of squares is nonnegative by construction,
    # while the expanded form can cancel to a tiny NEGATIVE on constant
    # segments — which would beat a big = T*span^2 = 0 gate on a flat
    # trace and split where the host never does.
    res_l = jnp.maximum(
        ssq_l - 2.0 * mean_l * sum_l + cnt_l * mean_l * mean_l, 0.0)
    res_r = jnp.maximum(
        ssq_r - 2.0 * mean_r * sum_r + cnt_r * mean_r * mean_r, 0.0)
    tot = res_l + res_r

    # min_step_length rule (stepfitting_library.py:216-221): a split at u
    # is forbidden when u - start < msl or stop - u < msl.
    valid = can_split & (u - a >= msl) & (b - u >= msl)
    valid &= jnp.abs(mean_l - mean_r) >= msm
    valid &= tot < big
    if extra_forbidden is not None:
        valid &= ~extra_forbidden

    # Lexicographic (tot, a, -u) argmin over valid positions.
    inf = jnp.asarray(jnp.inf, x.dtype)
    tot_m = jnp.where(valid, tot, inf)
    best_tot = jnp.min(tot_m)
    tie = valid & (tot_m == best_tot)
    a_m = jnp.where(tie, a, T)
    best_a = jnp.min(a_m)
    tie &= a == best_a
    u_m = jnp.where(tie, u, -1)
    best_u = jnp.max(u_m)
    grew = jnp.isfinite(best_tot)
    new_starts = jnp.where(
        grew, starts | (u == best_u + 1), starts)
    return new_starts, grew


def _fit_residual(x, cs1, cs2, starts):
    """Total squared residual of a fit (sum over plateaus of
    sum((x - mean)^2)), with fp-rounded per-plateau means."""
    a, b = _segment_bounds(starts)
    cnt = (b - a + 1).astype(x.dtype)
    s = cs1[b + 1] - cs1[a]
    mean = s / cnt
    return jnp.sum((x - mean) ** 2)


def _counterfit_forbidden(bf_starts, cf_starts):
    """The counterfit constraint mask (stepfitting_library.py:182-211
    with bestfit_plateaus given): splits AT best-fit boundaries are
    forbidden, and every position inside a best-fit plateau that already
    contains a counterfit start is forbidden."""
    T = bf_starts.shape[0]
    u = jnp.arange(T)
    # (stop_i, start_{i+1}) pairs: u+1 is a best-fit start.
    boundary = jnp.concatenate([bf_starts[1:], jnp.zeros((1,), bool)])
    segid = jnp.cumsum(bf_starts.astype(jnp.int32)) - 1
    seg_has_cf = jax.ops.segment_max(cf_starts.astype(jnp.int32), segid,
                                     num_segments=T)
    inside_claimed = seg_has_cf[segid] > 0
    # Rule 2 forbids u in range(start, stop) of the claimed plateau —
    # every in-plateau split position; u == stop itself is never an
    # in-plateau split (can_split already excludes it), so masking the
    # whole segment is exact.
    del u
    return boundary | inside_claimed


@functools.partial(jax.jit, static_argnames=("num_plateaus",
                                             "min_step_length",
                                             "ignore_counterfits"))
def _chisq_device_program(traces, num_plateaus, min_step_length,
                          min_step_magnitude, ignore_counterfits):
    """The whole best-fit/counter-fit chain for an [N, T] batch in one
    program. Returns (pick [N] int32, all_starts [N, P, T] bool,
    valid [N, P] bool): the winning entry per trace and every entry's
    starts mask (pick indexes into the P axis).

    Structure: an outer ``lax.scan`` over the P best-fit entries whose
    body contains an inner ``lax.scan`` over counterfit growth steps
    (inactive steps masked). Compile cost is therefore CONSTANT in P —
    a statically-unrolled form would compile O(P^2) split-step bodies."""
    x = traces
    N, T = x.shape
    P = num_plateaus
    msl = min_step_length
    msm = jnp.asarray(min_step_magnitude, x.dtype)

    zeros = jnp.zeros((N, 1), x.dtype)
    cs1 = jnp.concatenate([zeros, jnp.cumsum(x, axis=1)], axis=1)
    cs2 = jnp.concatenate([zeros, jnp.cumsum(x * x, axis=1)], axis=1)
    span = jnp.max(x, axis=1) - jnp.min(x, axis=1)
    big = (T * span * span).astype(x.dtype)

    split = jax.vmap(_split_step,
                     in_axes=(0, 0, 0, 0, None, None, 0, 0))
    no_extra = jnp.zeros((N, T), bool)
    cf0 = jnp.zeros((N, T), bool).at[:, 0].set(True)

    def outer_body(carry, p):
        best, alive = carry
        new_best, grew = split(x, cs1, cs2, best, msl, msm, big, no_extra)
        # p == 1 needs no growth (the 1-plateau fit always exists); the
        # host breaks the p loop when the best fit stops growing
        # (chi_squared_step_fitter:223-224): entries after the first
        # stall never exist.
        alive = alive & jnp.where(p > 1, grew, True)
        best = jnp.where(((p > 1) & alive)[:, None], new_best, best)
        bf_res = jax.vmap(_fit_residual)(x, cs1, cs2, best)

        def cf_body(cf, step):
            extra = jax.vmap(_counterfit_forbidden)(best, cf)
            new_cf, _ = split(x, cs1, cs2, cf, 0, msm, big, extra)
            # Entry p's counterfit targets p + 1 plateaus = p growth
            # steps; later steps are no-ops.
            return jnp.where(step < p, new_cf, cf), None

        cf, _ = jax.lax.scan(cf_body, cf0, jnp.arange(P))
        cf_res = jax.vmap(_fit_residual)(x, cs1, cs2, cf)
        S = jnp.where(bf_res != 0, cf_res / jnp.where(bf_res != 0,
                                                      bf_res, 1.0),
                      jnp.asarray(1e10, x.dtype))
        return (best, alive), (S, best, alive)

    init = (cf0, jnp.ones((N,), bool))
    _, (S_all, starts_all, valid) = jax.lax.scan(
        outer_body, init, jnp.arange(1, P + 1))
    S_all = jnp.moveaxis(S_all, 0, 1)            # [N, P]
    starts_all = jnp.moveaxis(starts_all, 0, 1)  # [N, P, T]
    valid = jnp.moveaxis(valid, 0, 1)            # [N, P]
    if ignore_counterfits:
        # Largest plateau count = last valid entry (stable reverse sort
        # by len == last index where valid).
        idx = jnp.arange(P)
        pick = jnp.max(jnp.where(valid, idx, -1), axis=1)
    else:
        # sorted(..., key=S, reverse=True) is stable: first max wins.
        S_masked = jnp.where(valid, S_all, -jnp.inf)
        pick = jnp.argmax(S_masked, axis=1)
    return pick.astype(jnp.int32), starts_all, valid


def chi_squared_fit_device(traces, num_steps=None, num_steps_multiplier=1,
                           min_step_length=2, min_step_magnitude=0.0,
                           ignore_counterfits=False):
    """Device-batched chi-squared step fits for an (N, T) trace stack.

    Same surface as ``stepfitting.chi_squared_fit_batch`` minus the
    ``num_steps = T - 1`` ValueError edge (callers route that to the
    host/native engines — see chi_squared_fit_batch). Heights are
    computed ON HOST with the reference's exact ``np.mean`` over each
    winning plateau's raw photometries, so any device/host divergence is
    confined to near-tied split POSITIONS, never to heights given the
    same positions.
    """
    traces = np.ascontiguousarray(traces, dtype=np.float64)
    N, T = traces.shape
    if N == 0:
        return []
    if not 0 < num_steps_multiplier <= 1:
        raise ValueError("num_steps_multiplier has an invalid value of " +
                         str(num_steps_multiplier))
    if num_steps is None:
        num_steps = min(int(np.ceil(num_steps_multiplier * T)), T - 2)
    if not 0 < num_steps <= T - 2:
        raise ValueError(f"chi_squared_fit_device needs 0 < num_steps <= "
                         f"T - 2 (got {num_steps} for T={T})")
    with jax.enable_x64(True):
        pick, starts_all, valid = _chisq_device_program(
            jnp.asarray(traces), num_steps + 1, int(min_step_length),
            float(min_step_magnitude), bool(ignore_counterfits))
        pick = np.asarray(pick)
        starts = np.asarray(
            jnp.take_along_axis(starts_all, jnp.asarray(pick)[:, None, None],
                                axis=1)[:, 0])
    out = []
    for i in range(N):
        idxs = np.flatnonzero(starts[i])
        stops = np.append(idxs[1:] - 1, T - 1)
        out.append([
            (int(s), int(e), float(np.mean(traces[i, s:e + 1])))
            for s, e in zip(idxs, stops)])
    return out

"""Batched step fitting across many traces at once.

The host chain (stepfitting.py, exact port of the reference's
stepfitting_library.py) costs O(T·|windows|·M) Python per trace; an
experiment step-fits thousands of traces (flexlibrary.py:3642-3713). Here
the two hot stages run as single jitted device calls over an (N, T) trace
stack:

- :func:`chung_kennedy_batch` — the Chung & Kennedy forward/backward
  predictor filter (stepfitting_library.py:1081-1273) as cumulative-sum
  sliding windows, all traces in lockstep;
- :func:`sliding_t_masks` — the sliding-window Welch's-t step detector
  (stepfitting_library.py:929-1066) with p-values from the regularized
  incomplete beta, intersected across radii, as one boolean (N, T) mask.

Plateau assembly / merge filters are raggy and cheap (a handful of plateaus
per trace) and stay on host, reusing stepfitting.py so semantics are shared
by construction. :func:`stepfit_batched` reproduces the full
Trace.stepfit_photometries chain (flexlibrary.py:1380-1469).

Lane-major note: traces are (N, T) with T on lanes; all window reductions
are cumsum-difference forms, so each stage is a few vector ops regardless
of window size.
"""

from __future__ import annotations

from functools import partial

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
import numpy as np

from .. import stepfitting


@partial(jax.jit, static_argnames=("window_lengths", "M", "p"))
def chung_kennedy_batch(traces, window_lengths=(2, 4, 8, 16), M=10, p=2):
    """Chung-Kennedy filter over an (N, T) stack of traces.

    Matches stepfitting.chung_kennedy_filter (itself the exact port of
    stepfitting_library.py:1081-1273) including its edge truncations:
    the rear weight window drops its first frame when L < M, the front
    weight window drops its last frame when L + M >= T - 1, and frames
    0 / T-1 use only the one-sided predictor.
    """
    lum = jnp.asarray(traces)
    N, T = lum.shape
    if T <= 2:
        # Same loud error as the host chain (stepfitting.py:417 /
        # stepfitting_library.py:1130): with <= 2 frames the one-sided
        # predictors would silently swap the two samples instead.
        raise ValueError("luminosities must have len(luminosities) > 2")
    L = jnp.arange(T)
    # Exclusive prefix sums: c[:, i] = sum(lum[:, :i]).
    c = jnp.concatenate([jnp.zeros((N, 1), lum.dtype),
                         jnp.cumsum(lum, axis=1)], axis=1)

    num = jnp.zeros_like(lum)
    tot = jnp.zeros((N, T), lum.dtype)
    for w in window_lengths:
        # front predictor: mean of lum[max(L-w-1,0):L] (strictly before L).
        lo = jnp.maximum(L - w - 1, 0)
        cnt_f = (L - lo).astype(lum.dtype)
        fp = jnp.where(cnt_f > 0, (c[:, L] - c[:, lo]) /
                       jnp.maximum(cnt_f, 1), 0.0)
        # back predictor: mean of lum[L+1:L+w+1] (strictly after L).
        hi = jnp.minimum(L + w + 1, T)
        cnt_b = (hi - (L + 1)).astype(lum.dtype)
        bp = jnp.where(cnt_b > 0, (c[:, hi] - c[:, jnp.minimum(L + 1, T)]) /
                       jnp.maximum(cnt_b, 1), 0.0)

        # Prediction-error windows (window M, reference edge truncations).
        # Zero the undefined edge frames by column concat, not .at[].set
        # (a concat fuses; a scatter into column 0 does not).
        z1 = jnp.zeros((N, 1), lum.dtype)
        sqf = jnp.concatenate([z1, ((lum - fp) ** 2)[:, 1:]], axis=1)
        csqf = jnp.concatenate([z1, jnp.cumsum(sqf, axis=1)], axis=1)
        sqb = jnp.concatenate([((lum - bp) ** 2)[:, :T - 1], z1], axis=1)
        csqb = jnp.concatenate([z1, jnp.cumsum(sqb, axis=1)], axis=1)

        # rear window [lo2, L]: lo2 = L-M+1, but the reference drops the
        # first frame when L < M (stepfitting_library.py edge truncation).
        lo2 = jnp.where(L >= M, L - M + 1, 1)
        b_diff = csqf[:, L + 1] - csqf[:, jnp.minimum(lo2, L + 1)]
        # front window [L, hi2): hi2 = min(L+M, T), minus one when
        # L + M >= T - 1 (dropped even when the slice misses T-1).
        hi2 = jnp.where(L + M >= T - 1, jnp.minimum(L + M, T) - 1,
                        jnp.minimum(L + M, T))
        f_diff = csqb[:, jnp.maximum(hi2, L)] - csqb[:, L]

        b_zero = b_diff == 0
        f_zero = f_diff == 0
        fw = jnp.where(b_zero & ~f_zero, 1.0,
                       jnp.where(~b_zero & f_zero, 0.0,
                                 jnp.where(b_zero & f_zero, 1.0,
                                           jnp.where(b_diff > 0,
                                                     b_diff, 1.0) **
                                           (-float(p)))))
        bw = jnp.where(b_zero & ~f_zero, 0.0,
                       jnp.where(~b_zero & f_zero, 1.0,
                                 jnp.where(b_zero & f_zero, 0.0,
                                           jnp.where(f_diff > 0,
                                                     f_diff, 1.0) **
                                           (-float(p)))))
        # Edge frames: one-sided.
        fw = jnp.where(L == 0, 0.0, jnp.where(L == T - 1, 1.0, fw))
        bw = jnp.where(L == 0, 1.0, jnp.where(L == T - 1, 0.0, bw))

        num = num + fw * fp + bw * bp
        tot = tot + fw + bw
    return num / tot


def _welch_p(mean_l, var_l, n_l, mean_r, var_r, n_r):
    """Two-tailed Welch's-t p-value; nan where either window has < 2
    samples (matching scipy.stats.ttest_ind on degenerate windows)."""
    vl = var_l / n_l
    vr = var_r / n_r
    denom = vl + vr
    t2 = jnp.where(denom > 0, (mean_l - mean_r) ** 2 / jnp.where(
        denom > 0, denom, 1.0), jnp.inf)
    df = jnp.where(denom > 0,
                   denom ** 2 / (jnp.where(n_l > 1, vl ** 2 / (n_l - 1), 0) +
                                 jnp.where(n_r > 1, vr ** 2 / (n_r - 1), 0) +
                                 1e-300),
                   1.0)
    x = df / (df + t2)
    p = jax.scipy.special.betainc(df / 2.0, 0.5, jnp.clip(x, 0.0, 1.0))
    # Degenerate: zero pooled variance — scipy gives p=0 for differing
    # means (t=inf), nan for identical (0/0).
    p = jnp.where(denom > 0, p,
                  jnp.where(mean_l == mean_r, jnp.nan, 0.0))
    # Windows with < 2 samples: variance undefined -> nan p (no step).
    return jnp.where((n_l >= 2) & (n_r >= 2), p, jnp.nan)


@partial(jax.jit, static_argnames=("window_radius", "p_threshold"))
def sliding_t_masks(traces, window_radius=6, p_threshold=0.001):
    """Boolean (N, T) mask of step positions: p < p_threshold at every
    radius in range(5, window_radius), with the reference's Python-slice
    window semantics (stepfitting_library.py:929-1037):

    - left window seq[f-radius:f] is EMPTY for f < radius (nan p);
    - right window seq[f:f+radius] truncates at the trace end.
    """
    seq = jnp.asarray(traces)
    N, T = seq.shape
    f = jnp.arange(T)
    # Center each trace before the cumulative sums: Welch's t is
    # shift-invariant, but the (sum_sq - sum^2/n) variance form is NOT
    # numerically — at real photometry magnitudes (DC ~6e4, steps ~1e3)
    # the f32 cumsum-of-squares cancels catastrophically and flips
    # borderline step bits vs the float64 host chain (stepfitting.py
    # rejects the same form on float64 for the same reason). Centered,
    # the squares are O(step^2) and the masks match the host exactly.
    seq = seq - jnp.mean(seq, axis=1, keepdims=True)
    c = jnp.concatenate([jnp.zeros((N, 1), seq.dtype),
                         jnp.cumsum(seq, axis=1)], axis=1)
    c2 = jnp.concatenate([jnp.zeros((N, 1), seq.dtype),
                          jnp.cumsum(seq ** 2, axis=1)], axis=1)
    # An empty radius range (window_radius <= 5) means NO step positions,
    # exactly like the host chain's empty step_intersection — not all.
    mask = jnp.full((N, T), window_radius > 5, dtype=bool)
    for radius in range(5, window_radius):
        n_l = jnp.where(f >= radius, radius, 0).astype(seq.dtype)
        lo = jnp.maximum(f - radius, 0)
        sum_l = c[:, f] - c[:, lo]
        sq_l = c2[:, f] - c2[:, lo]
        n_r = jnp.minimum(radius, T - f).astype(seq.dtype)
        hi = jnp.minimum(f + radius, T)
        sum_r = c[:, hi] - c[:, f]
        sq_r = c2[:, hi] - c2[:, f]
        safe_nl = jnp.maximum(n_l, 1.0)
        safe_nr = jnp.maximum(n_r, 1.0)
        mean_l = sum_l / safe_nl
        mean_r = sum_r / safe_nr
        var_l = jnp.maximum(sq_l - sum_l ** 2 / safe_nl, 0.0) / \
            jnp.maximum(n_l - 1.0, 1.0)
        var_r = jnp.maximum(sq_r - sum_r ** 2 / safe_nr, 0.0) / \
            jnp.maximum(n_r - 1.0, 1.0)
        p = _welch_p(mean_l, var_l, safe_nl, mean_r, var_r, safe_nr)
        p = jnp.where((n_l >= 2) & (n_r >= 2), p, jnp.nan)
        mask = mask & (p < p_threshold)
    return mask


@partial(jax.jit, static_argnames=("window_lengths", "window_radius",
                                   "p_threshold"))
def _ck_and_masks(traces, window_lengths=(2, 4, 8, 16), window_radius=6,
                  p_threshold=0.001):
    """Fused CK filter + sliding-t detector: one dispatch per chunk.

    Keeping the CK output on device for the t-stage saves a full
    host round trip (fetch + re-upload) per chunk. Bit-equal to the
    two-dispatch form (the intermediate is f32 either way)."""
    ck = chung_kennedy_batch(traces, window_lengths=window_lengths)
    return ck, sliding_t_masks(ck, window_radius=window_radius,
                               p_threshold=p_threshold)


def _plateaus_from_mask(seq, mask):
    """Host plateau assembly from a step mask: last of each consecutive
    group of step positions (stepfitting_library.py:1033-1037)."""
    positions = np.flatnonzero(mask)
    groups = stepfitting._consecutive_integers(positions.tolist())
    step_positions = [g[-1] for g in groups]
    seq = list(seq)
    if step_positions:
        plateaus = [stepfitting._fit_plateau(seq, 0, step_positions[0] - 1)]
        for f1, f2 in zip(step_positions, step_positions[1:]):
            plateaus.append(stepfitting._fit_plateau(seq, f1, f2 - 1))
        plateaus.append(
            stepfitting._fit_plateau(seq, step_positions[-1], len(seq) - 1))
    else:
        plateaus = [stepfitting._fit_plateau(seq, 0, len(seq) - 1)]
    return plateaus


def stepfit_batched(photometries, mirror_start=0, chung_kennedy=0,
                    p_threshold=0.01, window_radius=6, mesh=None,
                    chunk=None):
    """Batched Trace.stepfit_photometries chain (flexlibrary.py:1380-1469)
    over an (N, T) array of trace photometries.

    Returns a list of N tuples ``(photometries, un_ck, un_plateaus, un_t)``
    matching the host chain: mirror -> CK(2,4,8,16) -> sliding-t(radius<6)
    -> refit on raw -> drop_sort t-test merge -> unmirror.

    mesh: optional jax.sharding.Mesh — the trace axis of every device
    dispatch is sharded over the mesh's first axis (pure data
    parallelism; all window math is within-row).
    chunk: row cap per device dispatch (power-of-two bucketed below it).
    None (default) takes the per-backend constant
    (utils/probes.stepfit_chunk). Results are chunk-invariant
    (CI-tested).
    """
    if chunk is None:
        from ..utils import probes

        chunk = probes.stepfit_chunk()
    phot = np.asarray(photometries, dtype=np.float64)
    N, T0 = phot.shape
    if N == 0:
        return []
    mirrored = np.concatenate([phot[:, :mirror_start][:, ::-1], phot], axis=1)

    from ..utils.dispatch import pow2_bucket, mesh_row_sharding

    n_dev = 1
    if mesh is not None:
        row_sharding, n_dev = mesh_row_sharding(mesh)

    # Chunk the device dispatches at power-of-two row buckets (cap
    # ``chunk``): every call shape hits an already-compiled program. All
    # chunks are queued before any result is fetched so the device
    # pipelines them (JAX dispatch is async). fn may return one array or
    # a tuple of same-leading-dim arrays.
    def run_chunked(fn, x):
        from ..utils import profiling

        n = x.shape[0]
        pending = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            m = hi - lo
            bucket = pow2_bucket(m, chunk, multiple_of=n_dev)
            piece = x[lo:hi]
            if bucket != m:
                piece = np.concatenate(
                    [piece, np.zeros((bucket - m,) + x.shape[1:], x.dtype)])
            if mesh is not None:
                # Direct sharded upload — jnp.asarray first would stage the
                # chunk on the default device and copy again.
                dev = jax.device_put(piece, row_sharding)
            else:
                dev = jnp.asarray(piece)
            profiling.bump("ledger/uploads")
            profiling.bump("ledger/upload_bytes", int(piece.nbytes))
            profiling.bump("ledger/step_dispatches")
            out = fn(dev)
            pending.append((m, out if isinstance(out, tuple) else (out,)))
        # n >= 1 always holds here (the N == 0 early return above), so
        # pending is never empty.
        cols = []
        for j in range(len(pending[0][1])):
            parts = []
            for m, d in pending:
                a_full = np.asarray(d[j])
                profiling.bump("ledger/result_fetches")
                # Bucket padding transfers too: count what crossed the
                # link, not the post-slice view.
                profiling.bump("ledger/fetch_bytes", int(a_full.nbytes))
                parts.append(a_full[:m])
            cols.append(np.concatenate(parts))
        cols = tuple(cols)
        return cols if len(cols) > 1 else cols[0]

    if chung_kennedy > 0:
        # The reference re-filters the *mirrored* input each round
        # (flexlibrary.py:1432-1436), so repetition does not compound.
        # Fused kernel: the CK output feeds the t-stage on device.
        ck, masks = run_chunked(
            lambda x: _ck_and_masks(x, window_lengths=(2, 4, 8, 16),
                                    window_radius=window_radius,
                                    p_threshold=p_threshold), mirrored)
    else:
        ck = mirrored
        masks = run_chunked(
            lambda x: sliding_t_masks(x, window_radius=window_radius,
                                      p_threshold=p_threshold), ck)

    from ..native import stepchain
    if stepchain.have_native():
        # The per-trace post-pass (plateau assembly -> refit -> iterated
        # drop-sort Welch-t merge) in C++: ~50x the Python loop, exact
        # same plateau structures (differential-tested in
        # tests/test_stepfit_batch.py and test_native.py).
        (rf_n, rf_s, rf_e, rf_h, tf_n, tf_s, tf_e, tf_h) = \
            stepchain.stepfit_postpass(mirrored, masks, p_threshold,
                                       mirror_start)
        # Bulk-convert once and unmirror in numpy: per-element numpy
        # scalar access and 2N unmirror_plateaus calls in a 4096-trace
        # loop cost more than the native pass itself. unmirror_plateaus
        # semantics (stepfitting.py:640-652): shift by -mirror_start,
        # drop plateaus entirely inside the mirror (both ends < 0 — a
        # row PREFIX, plateaus are ordered), clamp the boundary
        # plateau's start to 0. Equality with the call-per-trace form is
        # enforced by the native-vs-fallback tests.
        phot_rows = phot.tolist()

        def unmirror_lists(n, s, e, h):
            # Per-row [(start, stop, height), ...] after unmirroring
            # (shift by -mirror_start, drop plateaus entirely inside the
            # mirror, clamp the boundary start to 0 —
            # stepfitting.unmirror_plateaus semantics), built as ONE
            # flat zip over all kept plateaus: a per-row zip/slice loop
            # measured ~10x slower at 4k traces (0.15 s of a 0.5 s
            # call). Only the first n[i] entries per row are real; rows
            # are sliced out of the flat list by cumulative counts.
            w = max(int(n.max()), 1) if n.size else 1
            s, e, h = s[:, :w], e[:, :w], h[:, :w]
            kmask = np.arange(w)[None, :] < n[:, None]
            keep = kmask & ((e - mirror_start) >= 0)
            rows, cols = np.nonzero(keep)  # row-major: rows stay grouped
            flat = list(zip(
                np.maximum(s[rows, cols] - mirror_start, 0).tolist(),
                (e[rows, cols] - mirror_start).tolist(),
                h[rows, cols].tolist()))
            bounds = np.zeros(keep.shape[0] + 1, np.int64)
            np.cumsum(keep.sum(axis=1), out=bounds[1:])
            return [flat[bounds[i]:bounds[i + 1]]
                    for i in range(keep.shape[0])]

        rf_lists = unmirror_lists(rf_n, rf_s, rf_e, rf_h)
        tf_lists = unmirror_lists(tf_n, tf_s, tf_e, tf_h)
        ck_un = ck[:, mirror_start:]
        out = []
        for i in range(N):
            # list(ck_un[i]) == unmirror_photometries(list(ck[i]),
            # mirror_start): a list of numpy scalars (the type the host
            # chain produces).
            out.append((tuple(phot_rows[i]), list(ck_un[i]),
                        rf_lists[i], tf_lists[i]))
        return out

    out = []
    for i in range(N):
        plateaus = _plateaus_from_mask(ck[i], masks[i])
        plateaus = stepfitting.refit_plateaus(list(mirrored[i]), plateaus)
        t_filtered = stepfitting.t_test_filter(
            luminosities=list(mirrored[i]), plateaus=plateaus,
            p_threshold=p_threshold, drop_sort=True,
            no_merge_start=mirror_start)
        un_ck = stepfitting.unmirror_photometries(list(ck[i]),
                                                  mirror_size=mirror_start)
        un_plateaus = stepfitting.unmirror_plateaus(plateaus,
                                                    mirror_size=mirror_start)
        un_t = stepfitting.unmirror_plateaus(t_filtered,
                                             mirror_size=mirror_start)
        out.append((tuple(phot[i].tolist()), un_ck, un_plateaus, un_t))
    return out

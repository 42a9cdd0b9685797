"""Batched exhaustive plateau fitting (the v1 fluor-count fitter).

The reference fits every trace by brute force: for every drop-position
combination (``itertools.product(range(T), repeat=max_num_drops)``) it
builds per-segment means and keeps the best R^2 under an order-dependent
preference for fewer plateaus (MCsimlib.py:2597-2673; host port:
inference/photometries.py:_plateau_fit). That is O(T^d) numpy calls per
trace, per trace.

Here the heavy part runs once for ALL traces: the T^d product collapses
to the ~sum_k C(T-1, k) distinct segmentations, scored for every trace at
once; the reference's sequential selection rule (including its revisit
order and the ``delta_r_2`` asymmetry for larger fits) is then replayed
exactly, vectorized across traces — T^d scalar steps each updating (N,)
arrays.

Two scoring backends:

- ``scores='exact'`` (default): host numpy, BIT-IDENTICAL to the
  per-trace ``_plateau_fit`` scoring. Exactness hinges on numpy reduction
  order: ``np.mean(x[:, l:h], axis=1)`` and ``(...).sum(axis=-1)`` on a
  row-contiguous array run the same pairwise reduction per row as the
  scalar ``np.mean(row[l:h])`` / ``np.sum(...)`` calls the host makes, so
  every score matches to the last ulp — and so does every order-dependent
  selection, including mathematical ties (integer-valued photometries
  make exact score ties common).
- ``scores='device'``: the jitted einsum scorer — the device path for very
  large N. Scoring runs in float64 only when ``jax_enable_x64`` is set;
  in the production configuration (x64 unset) it runs in float32. Rows are mean-centered on host in f64
  first (R^2 and the downstep comparisons are shift-invariant), which
  keeps the f32 scores at ~1e-6 relative accuracy at raw photometry
  magnitudes instead of losing ~7 digits to cancellation — but
  NEAR-TIED segmentations (within that error), not just mathematically
  tied ones, may still select differently than the host under f32. In
  f64 the divergence window is the last ulp (summation ORDER differs
  from the host's, so exact mathematical ties may keep a different
  equally-scoring fit; everything else, including the single-plateau
  score — forced to its mathematically exact 0 — is equivalent). Use
  the default ``'exact'`` whenever bit parity matters. Scores are
  chunked over rows; only (N, C) arrays ever materialize.
"""

from __future__ import annotations

import functools
import itertools

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=64)
def _segmentations(T, max_num_drops):
    """(combo_table, product_combo_ids):

    combo_table: list of tuples of plateau start indices (0 always first);
    product_combo_ids: for each tuple of itertools.product(range(T), d),
        the index into combo_table of its deduped segmentation.
    """
    table = {}
    order = []
    ids = []
    for drops in itertools.product(range(T), repeat=max_num_drops):
        starts = tuple(sorted(set(drops) | {0}))
        if starts not in table:
            table[starts] = len(order)
            order.append(starts)
        ids.append(table[starts])
    return order, np.asarray(ids, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def _combo_structure(T, max_num_drops):
    """(seg_id (C, T) int32, n_segs (C,) int32) for the deduped combos."""
    combos, _ = _segmentations(T, max_num_drops)
    C = len(combos)
    seg_id = np.zeros((C, T), dtype=np.int32)
    n_segs = np.zeros((C,), dtype=np.int32)
    for c, starts in enumerate(combos):
        bounds = list(starts) + [T]
        for s in range(len(starts)):
            seg_id[c, bounds[s]:bounds[s + 1]] = s
        n_segs[c] = len(starts)
    return seg_id, n_segs


def _scores_host(x, T, max_num_drops):
    """Bit-exact host scoring: (r2 (N, C) float64, n_segs, downstep_ok).

    Reproduces _plateau_fit's arithmetic per combo: distinct segments
    (at most T*(T+1)/2 across all combos) get their np.mean once for all
    traces; fits assemble by gather (no arithmetic); residual/total sums
    reduce along the contiguous axis exactly like the scalar np.sum
    calls.
    """
    combos, _ = _segmentations(T, max_num_drops)
    N = x.shape[0]
    C = len(combos)
    seg_means = {}
    for starts in combos:
        bounds = list(starts) + [T]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if (lo, hi) not in seg_means:
                seg_means[(lo, hi)] = np.mean(x[:, lo:hi], axis=1)
    tot = ((x - np.mean(x, axis=1, keepdims=True)) ** 2).sum(axis=1)
    r2 = np.empty((N, C), np.float64)
    n_segs = np.zeros((C,), np.int32)
    downstep_ok = np.empty((N, C), bool)
    fit = np.empty_like(x)
    for c, starts in enumerate(combos):
        bounds = list(starts) + [T]
        n_segs[c] = len(starts)
        ok = np.ones(N, bool)
        prev = None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            m = seg_means[(lo, hi)]
            fit[:, lo:hi] = m[:, None]
            if prev is not None:
                # host _check_no_downsteps: any(p1[0] < p2[0]) fails
                ok &= ~(prev < m)
            prev = m
        res = ((x - fit) ** 2).sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            r2[:, c] = 1.0 - res / tot
        downstep_ok[:, c] = ok
    return r2, n_segs, downstep_ok


@functools.partial(jax.jit, static_argnames=("T", "max_num_drops"))
def _scores_device(x, T, max_num_drops):
    """Device einsum scoring for one row chunk: (r2, downstep_ok).

    ``x`` arrives mean-centered per row and in the compute dtype the
    caller resolved explicitly (f64 under x64, f32 in production — see
    _all_scores); R^2 and the segment-mean downstep comparisons are
    shift-invariant, and centering is what keeps f32 scoring accurate at
    raw photometry magnitudes. The (N, C, T) fit tensor lives only
    inside the fusion (not an output), so memory stays O(N*C). The
    single-segment combo's score is forced to its mathematically exact 0
    (fit == row mean implies res == tot; einsum rounding would otherwise
    leave ~1e-16, which flips the reference's adjusted-R^2 boundary at
    exactly -1).
    """
    seg_id, n_segs = _combo_structure(T, max_num_drops)
    max_segs = int(seg_id.max()) + 1
    x = jnp.asarray(x)
    member = (seg_id[:, :, None] ==
              np.arange(max_segs)[None, None, :]).astype(x.dtype)
    seg_len = member.sum(axis=1)                                # (C, S)
    avg = member / np.maximum(seg_len, 1.0)[:, None, :]         # (C, T, S)
    member_j = jnp.asarray(member)
    avg_j = jnp.asarray(avg)
    hi = jax.lax.Precision.HIGHEST  # TF32 breaks the segment means
    seg_mean = jnp.einsum("nt,cts->ncs", x, avg_j, precision=hi)  # (N,C,S)
    fit = jnp.einsum("ncs,cts->nct", seg_mean, member_j, precision=hi)
    res = jnp.sum((x[:, None, :] - fit) ** 2, axis=-1)          # (N, C)
    tot = jnp.sum((x - jnp.mean(x, axis=1, keepdims=True)) ** 2,
                  axis=1)                                       # (N,)
    r2 = 1.0 - res / tot[:, None]
    single = jnp.asarray(n_segs == 1)
    r2 = jnp.where(single[None, :], 0.0, r2)
    up = seg_mean[:, :, :-1] < seg_mean[:, :, 1:]               # (N, C, S-1)
    pair_real = jnp.asarray(
        (np.arange(max_segs - 1)[None, :] < (n_segs - 1)[:, None])
        .astype(bool))                                          # (C, S-1)
    downstep_ok = ~jnp.any(up & pair_real[None, :, :], axis=-1)
    return r2, downstep_ok


def _all_scores(x, T, max_num_drops, scores, chunk=4096, dtype=None):
    """(r2 (N, C) float64, n_segs (C,), downstep_ok (N, C)) via the
    selected backend; the device backend is row-chunked.

    ``dtype`` pins the device compute dtype (tests force the production
    float32 configuration under the x64-enabled suite); by default it is
    resolved EXPLICITLY from ``jax_enable_x64`` rather than relying on
    jnp.asarray's silent downcast. Rows are mean-centered on host in f64
    before the cast — an identity for R^2 and the downstep comparisons —
    so f32 scoring does not cancel away its mantissa on large-magnitude
    photometries."""
    if scores == "exact":
        return _scores_host(x, T, max_num_drops)
    if scores != "device":
        raise ValueError("scores must be 'exact' or 'device'")
    if dtype is None:
        dtype = jnp.float64 if jax.config.read("jax_enable_x64") \
            else jnp.float32
    _, n_segs = _combo_structure(T, max_num_drops)
    xc = x - x.mean(axis=1, keepdims=True)
    r2_parts, ok_parts = [], []
    pending = []
    for lo in range(0, x.shape[0], chunk):
        pending.append(_scores_device(
            jnp.asarray(xc[lo:lo + chunk], dtype=dtype), T,
            max_num_drops))
    for r2_c, ok_c in pending:
        r2_parts.append(np.asarray(r2_c, dtype=np.float64))
        ok_parts.append(np.asarray(ok_c))
    return (np.concatenate(r2_parts), n_segs, np.concatenate(ok_parts))


def plateau_fit_batched(intensities, max_num_drops,
                        include_original_intensities=False,
                        downsteps_only=False, use_adjusted_r_2=False,
                        delta_r_2=0.05, original_intensities_only=True,
                        scores="exact"):
    """Batched _plateau_fit over an (N, T) intensity array.

    Returns a list of N ``(best_fit, best_r_2)`` tuples identical to
    inference.photometries._plateau_fit on each row (same output format
    switches, same order-dependent selection) — bit-identical with
    ``scores='exact'`` (the default; see module docstring for the
    'device' backend's tie caveat). Rows where every segmentation is
    rejected reproduce the host behavior faithfully, including its
    TypeError when an output-formatting flag would iterate the None fit.
    """
    if include_original_intensities and original_intensities_only:
        raise Exception
    x = np.asarray(intensities, dtype=np.float64)
    N, T = x.shape
    combos, product_ids = _segmentations(T, max_num_drops)
    r2, n_segs, downstep_ok = _all_scores(x, T, max_num_drops, scores)

    score = r2
    if use_adjusted_r_2:
        k = 2.0 * n_segs - 1.0
        with np.errstate(divide="ignore", invalid="ignore"):
            score = 1.0 - (1.0 - r2) * (T - 1.0) / (T - k - 1.0)[None, :]

    valid = ~np.isnan(score)
    if downsteps_only:
        valid = valid & downstep_ok

    # Replay the reference's sequential selection, vectorized over traces.
    best_id = np.full(N, -1, dtype=np.int64)
    best_len = np.zeros(N, dtype=np.int64)
    best_score = np.full(N, -1.0)
    # Revisited combos MUST be replayed: once the best moves to a larger
    # fit, a previously-losing smaller combo becomes eligible again through
    # the plain > rule (the reference iterates the raw product sequence).
    for cid in product_ids:
        cid = int(cid)
        s = score[:, cid]
        v = valid[:, cid]
        none = best_id < 0
        le = n_segs[cid] <= best_len
        upd = v & ((none | le) & (s > best_score) |
                   (~none & ~le) & (s > best_score + delta_r_2))
        best_id = np.where(upd, cid, best_id)
        best_len = np.where(upd, n_segs[cid], best_len)
        best_score = np.where(upd, s, best_score)

    out = []
    for i in range(N):
        row = x[i]
        if len(set(row.tolist())) == 1:
            # Reference typo parity (MCsimlib.py:2604 assigns a dead
            # `best_adjusted_r2`): under use_adjusted_r_2 a uniform trace
            # reports r_2 == -1, not 1.0.
            best_fit = [[v for v in row.tolist()]]
            br = -1 if use_adjusted_r_2 else 1.0
        elif best_id[i] < 0:
            # Host parity: best_fit stays None and falls through the SAME
            # formatting branches — iterating it raises the host's exact
            # TypeError when a formatting flag is set, and both-flags-off
            # returns (None, -1) like the host does.
            best_fit = None
            br = -1
        else:
            starts = combos[best_id[i]]
            bounds = list(starts) + [T]
            plateaus = [row[bounds[s]:bounds[s + 1]].tolist()
                        for s in range(len(starts))]
            best_fit = [[float(np.mean(p))] * len(p) for p in plateaus]
            br = float(best_score[i])
        if include_original_intensities:
            j = 0
            formatted = []
            for plateau in best_fit:
                formatted.append([])
                for v in plateau:
                    formatted[-1].append((v, row[j]))
                    j += 1
            best_fit = formatted
        elif original_intensities_only:
            j = 0
            formatted = []
            for plateau in best_fit:
                formatted.append([])
                for v in plateau:
                    formatted[-1].append(row[j])
                    j += 1
            best_fit = formatted
        out.append((best_fit, br))
    return out


def all_plateau_fits_batched(intensities, max_num_drops,
                             storage_r_2_cutoff=0.7, scores="exact"):
    """Batched _all_plateau_fits over an (N, T) array
    (MCsimlib.py:2676-2720; host port inference/photometries.py).

    Scores every segmentation for every trace once (bit-exactly with the
    default backend), then emits — in the reference's raw product order,
    duplicates included — every fit whose R^2 clears the cutoff, in the
    reference's ``(fit_with_originals, r_2, adj_r_2)`` tuple format.
    """
    x = np.asarray(intensities, dtype=np.float64)
    N, T = x.shape
    combos, product_ids = _segmentations(T, max_num_drops)
    r2, n_segs, _ = _all_scores(x, T, max_num_drops, scores)
    k = 2.0 * n_segs - 1.0
    with np.errstate(divide="ignore", invalid="ignore"):
        adj = 1.0 - (1.0 - r2) * (T - 1.0) / (T - k - 1.0)[None, :]

    out = []
    for i in range(N):
        row = x[i]
        if len(set(row.tolist())) == 1:
            out.append([(tuple([[(v, v) for v in row.tolist()]]), 1.0, 1.0)])
            continue
        fits = []
        means_cache = {}
        for cid in product_ids:
            cid = int(cid)
            if r2[i, cid] < storage_r_2_cutoff:
                continue
            if cid not in means_cache:
                starts = combos[cid]
                bounds = list(starts) + [T]
                formatted = []
                j = 0
                for s in range(len(starts)):
                    seg = row[bounds[s]:bounds[s + 1]]
                    m = float(np.mean(seg))
                    formatted.append([(m, row[j + t])
                                      for t in range(len(seg))])
                    j += len(seg)
                means_cache[cid] = tuple(formatted)
            fits.append((means_cache[cid], float(r2[i, cid]),
                         float(adj[i, cid])))
        out.append(fits)
    return out

"""Consolidation of competing PSF fits (quality-ranked non-max suppression).

Reference semantics (/root/reference/pflib.py:478-519): fitted PSFs whose
centers lie within ``consolidation_radius`` of each other compete, and only
the best-R^2 fit survives. The reference walks a Python-2 dict in hash order,
deleting inferior rivals as it goes — an order-dependent procedure whose
order (Py2 tuple-hash iteration) is unreproducible by construction. We use
the deterministic equivalent: greedy keep-best, i.e. process fits in
descending R^2 (raster tie-break) and keep one iff no already-kept fit lies
within the radius. For isolated rival pairs (the generic case, since spots
are sparse) this yields exactly the reference outcome; for chains it picks
one of the outcomes the reference could produce under some hash order.

Implemented as a lax.scan over the ranked list with a running kept-mask, so
it jits with static shapes; N here is the number of R^2-passing fits
(hundreds), not raw candidates.
"""

from __future__ import annotations

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
import numpy as np
from jax import lax


def _score(r2, valid):
    """Canonical ranking score: invalid AND NaN entries map to -inf.

    NaN R^2 (flat/saturated patches, kept by the reference's fit filter)
    compares false both ways under IEEE, which would make a NaN fit and
    its rival mutually non-suppressing — but the reference's scan
    (pflib.py:507-511) deletes exactly ONE member of any rival pair under
    every dict order (a NaN comparison always takes the delete-self
    branch). Ranking NaN at -inf (index tie-break) deterministically
    picks the finite survivor — one of the reference's reachable
    outcomes — and exactly one member of an all-NaN rival group.
    """
    neg_inf = jnp.array(-jnp.inf, r2.dtype)
    return jnp.where(valid & ~jnp.isnan(r2), r2, neg_inf)


def _rank(centers_h, centers_w, r2, valid):
    """Descending-r2 ordering (invalids last), shared by both backends."""
    score = _score(r2, valid)
    order = jnp.argsort(-score, stable=True)
    n = r2.shape[0]
    inv = jnp.zeros((n,), dtype=order.dtype).at[order].set(jnp.arange(n))
    return (centers_h[order], centers_w[order], valid[order], inv)


@jax.jit
def consolidate(centers_h, centers_w, r2, valid, radius=4.0,
                cand_h=None, cand_w=None):
    """Greedy quality-ranked NMS.

    Arguments:
        centers_h, centers_w: (N,) fitted centers in image coordinates.
        r2: (N,) fit quality used for ranking.
        valid: (N,) bool; invalid entries never compete and are never kept.
        radius: rivals are pairs with Euclidean distance <= radius
            (the reference skips pairs with dist^2 > radius^2,
            pflib.py:505-506, so the boundary is inclusive).
        cand_h, cand_w: optional (N,) CANDIDATE pixel coordinates. The
            reference only ever compares fits whose candidate pixels lie
            within a Chebyshev window of radius+2 of each other
            (pflib.py:491-495); for the LM path this gate is implied by
            the bounded centers, but the monte-carlo fitter's centers
            can drift up to ~2.5 px, where skipping it suppresses pairs
            the reference never compares.

    Returns:
        keep: (N,) bool mask of surviving fits.

    Computed as a parallel fixpoint rather than a sequential scan: the
    greedy rule "keep i iff no kept higher-priority rival within radius" is
    a dependency DAG whose depth is the longest rival chain (tiny for
    sparse spot fields), so label propagation converges in a few (N,)-wide
    vector rounds instead of N sequential scan steps — identical output,
    ~5-10x faster at N=2048 (see _consolidate_scan for the direct form).
    """
    ch, cw, v = centers_h, centers_w, valid
    n = ch.shape[0]
    idx = jnp.arange(n)
    d2 = ((ch[:, None] - ch[None, :]) ** 2 +
          (cw[:, None] - cw[None, :]) ** 2)
    r2_sq = jnp.asarray(radius, ch.dtype) ** 2
    # adj[i, j]: valid higher-priority rival j of i. Priority is encoded
    # directly in the predicate (higher r2 wins, index breaks ties — the
    # same order a stable sort by descending r2 would give), which avoids a
    # device sort + permutation gathers entirely. The barrier forces XLA to
    # materialize adj once instead of refusing the O(N^2) distance
    # computation into every while-loop round.
    score = _score(r2, v)
    higher = (score[None, :] > score[:, None]) | \
        ((score[None, :] == score[:, None]) & (idx[None, :] < idx[:, None]))
    adj = (d2 <= r2_sq) & higher & v[None, :]
    if cand_h is not None:
        cheb = jnp.maximum(jnp.abs(cand_h[:, None] - cand_h[None, :]),
                           jnp.abs(cand_w[:, None] - cand_w[None, :]))
        adj &= cheb <= radius + 2
    adj = lax.optimization_barrier(adj)

    def cond(state):
        _, undecided = state
        return jnp.any(undecided)

    def body(state):
        kept, undecided = state
        # i can be KEPT once no higher-priority rival is kept or pending;
        # SUPPRESSED as soon as some higher-priority rival is kept. The
        # top-ranked undecided entry always resolves, so this terminates.
        blocked = jnp.any(adj & (kept | undecided)[None, :], axis=1)
        new_kept = undecided & ~blocked
        suppressed = undecided & jnp.any(adj & kept[None, :], axis=1)
        return kept | new_kept, undecided & ~new_kept & ~suppressed

    kept, _ = lax.while_loop(cond, body,
                             (jnp.zeros((n,), dtype=bool), v))
    return kept


@jax.jit
def _consolidate_scan(centers_h, centers_w, r2, valid, radius=4.0):
    """Direct sequential form of the greedy NMS (the executable spec the
    fixpoint version is tested against)."""
    ch, cw, v, inv = _rank(centers_h, centers_w, r2, valid)
    n = ch.shape[0]
    r2_sq = jnp.asarray(radius, ch.dtype) ** 2

    def step(kept, i):
        d2 = (ch - ch[i]) ** 2 + (cw - cw[i]) ** 2
        rival = kept & (d2 <= r2_sq)
        keep_i = v[i] & ~jnp.any(rival)
        kept = kept.at[i].set(keep_i)
        return kept, keep_i

    kept, _ = lax.scan(step, jnp.zeros((n,), dtype=bool), jnp.arange(n))
    return kept[inv]


def consolidate_host(centers_h, centers_w, r2, valid, radius=4.0):
    """NumPy greedy NMS — identical output to :func:`consolidate` /
    ``_consolidate_scan`` (property-tested), for candidate sets whose size
    exceeds a single device bucket (the exhaustive chunked detect path,
    models/detect.detect_and_fit_exhaustive).

    Spatial binning (cell = radius, 3x3 neighborhood probe of KEPT spots)
    makes it O(N x rivals) instead of O(N^2); ~10k spots take ~10 ms.
    Distances are computed in the centers' own float dtype, exactly like
    the device kernel (which compares in ``ch.dtype``), so boundary cases
    (d^2 == radius^2 exactly) cannot diverge for float32 OR float64
    inputs. Caveat: "the device kernel's dtype" means the dtype the
    array actually HAS on device — without jax.enable_x64, jax silently
    downcasts float64 inputs to float32 at jnp.asarray, so f64 parity
    with the device scan requires x64 (the pinned test enables it);
    the production detect paths feed float32 everywhere.
    """
    dt = (np.float64 if np.asarray(centers_h).dtype == np.float64
          else np.float32)
    ch = np.asarray(centers_h, dt)
    cw = np.asarray(centers_w, dt)
    r2a = np.asarray(r2, dt)
    v = np.asarray(valid, bool)
    n = ch.shape[0]
    score = np.where(v & ~np.isnan(r2a), r2a, -np.inf)
    order = np.argsort(-score, kind="stable")
    keep = np.zeros(n, bool)
    rad2 = dt(float(radius)) ** 2
    cell = max(float(radius), 1e-6)
    grid: dict = {}
    for i in order:
        if not v[i]:
            # Invalids rank last and are never kept; stable argsort keeps
            # the remaining iteration order identical to the device rank.
            continue
        hi, wi = ch[i], cw[i]
        if not (np.isfinite(hi) and np.isfinite(wi)):
            # NaN/inf-centered fits: every distance comparison is False on
            # device (NaN <= r^2 is False), so they never rival anything —
            # kept if valid, and never suppress others.
            keep[i] = True
            continue
        bh = int(np.floor(hi / cell))
        bw = int(np.floor(wi / cell))
        rival = False
        for dh in (-1, 0, 1):
            if rival:
                break
            for dw in (-1, 0, 1):
                for j in grid.get((bh + dh, bw + dw), ()):
                    d2 = (hi - ch[j]) ** 2 + (wi - cw[j]) ** 2
                    if d2 <= rad2:
                        rival = True
                        break
                if rival:
                    break
        if not rival:
            keep[i] = True
            grid.setdefault((bh, bw), []).append(i)
    return keep

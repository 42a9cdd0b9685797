"""Candidate-pixel detection: median filter, template correlation, threshold.

Reference algorithm (/root/reference/pflib.py:217-258, steps 1-2 of
find_peptides):
1. background removal: ``image - min(median_filter(image, k), image)``
   (scipy.ndimage.median_filter, default 'reflect' boundary),
2. correlate with a square PSF template (scipy.signal.correlate mode='same',
   zero padding), clip at 0,
3. keep pixels with correlation >= mean + c_std * std (population std),
   excluding a 2-pixel border.

Design: the per-pixel Python loop becomes a fused array program — the
median filter is a 25-way selection over shifted views, the template
correlation a lax conv (correlation; XLA convs don't flip kernels), and the
candidate set is extracted with a static-shape top-k so the downstream fit
runs on a padded [max_candidates] bucket with a validity mask.
"""

from __future__ import annotations

import functools

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
from jax import lax
import numpy as np

# Empirical 5x5 PSF correlation template (/root/reference/pflib.py:48-52).
DEFAULT_CORRELATION_MATRIX = np.array(
    [[-5935, -5935, -5935, -5935, -5935],
     [-5935,  8027,  8027,  8027, -5935],
     [-5935,  8027, 30742,  8027, -5935],
     [-5935,  8027,  8027,  8027, -5935],
     [-5935, -5935, -5935, -5935, -5935]], dtype=np.float64)


class HashableArray:
    """Static (hashable) array wrapper for compile-time kernel weights."""

    def __init__(self, arr):
        self.arr = np.asarray(arr)
        self._key = (self.arr.tobytes(), self.arr.shape, str(self.arr.dtype))

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, HashableArray) and self._key == other._key


@functools.lru_cache(maxsize=None)
def _oddeven_merge_pairs(n: int):
    """Compare-exchange pairs (lo, hi) of Batcher's odd-even merge sort
    over n inputs, n a power of two."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def median_filter_2d(image, size: int):
    """Square median filter with scipy-'reflect' (jnp 'symmetric') boundary.

    Even sizes follow scipy.ndimage.median_filter exactly — the
    reference calls it directly (pflib.py:244) — which means TWO
    conventions beyond the naive form: the extra tap sits on the
    NEGATIVE side (window offsets -(size//2) .. size//2 - 1), and the
    "median" is scipy's rank filter at rank n//2 (the UPPER median of an
    even-count window, not the middle-two average). For odd sizes both
    reduce to the ordinary centered median.

    The rank is selected by a min/max sorting network over the size**2
    shifted views, which XLA fuses into one elementwise pass (a
    jnp.sort over the stacked views gives bit-identical output and was
    73x slower on an H100, PERF.md). Missing network inputs (padding up
    to a power of two) act as +inf and are folded away at trace time,
    and XLA drops the compare-exchanges the selected rank does not need.
    NaN pixels propagate through min/max instead of sorting last."""
    r_lo = size // 2
    r_hi = (size - 1) // 2
    padded = jnp.pad(image, ((r_lo, r_hi), (r_lo, r_hi)), mode="symmetric")
    h, w = image.shape
    v = [padded[i:i + h, j:j + w] for i in range(size) for j in range(size)]
    n = len(v)
    v += [None] * ((1 << (n - 1).bit_length()) - n)  # None = +inf
    for lo, hi in _oddeven_merge_pairs(len(v)):
        a, b = v[lo], v[hi]
        if b is None:
            continue
        if a is None:
            v[lo], v[hi] = b, None
        else:
            v[lo], v[hi] = jnp.minimum(a, b), jnp.maximum(a, b)
    return v[n // 2]


def correlate_2d_same(image, kernel):
    """2D cross-correlation, zero-padded 'same' (scipy.signal.correlate)."""
    img4 = image[None, None, :, :]
    ker4 = kernel[None, None, :, :].astype(image.dtype)
    out = lax.conv_general_dilated(
        img4, ker4, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST)
    return out[0, 0]


def candidate_map(image, median_filter_size=5, correlation_matrix=None,
                  c_std=2.0):
    """Correlation image and candidate mask.

    Returns (image_cm, mask) where mask marks candidate pixels. Pixels within
    2 of the border are excluded (5x5 fit patches must stay in-bounds,
    pflib.py:252-253).
    """
    if correlation_matrix is None:
        correlation_matrix = DEFAULT_CORRELATION_MATRIX
    kernel = jnp.asarray(correlation_matrix, dtype=image.dtype)
    image = image.astype(kernel.dtype)
    med = median_filter_2d(image, median_filter_size)
    image_mf = image - jnp.minimum(med, image)
    image_cm = jnp.maximum(correlate_2d_same(image_mf, kernel), 0.0)
    threshold = jnp.mean(image_cm) + c_std * jnp.std(image_cm)
    h, w = image.shape
    hh = jnp.arange(h)[:, None]
    ww = jnp.arange(w)[None, :]
    interior = ((hh >= 2) & (hh < h - 2) & (ww >= 2) & (ww < w - 2))
    mask = (image_cm >= threshold) & interior
    return image_cm, mask


def _pad_topk(top_scores, top_idx, max_candidates):
    """Pad a k<max_candidates top_k result back to the static bucket
    (tiny images: top_k requires k <= pixel count; padding keeps the
    output shape contract)."""
    short = max_candidates - top_scores.shape[-1]
    if short <= 0:
        return top_scores, top_idx
    pad = [(0, 0)] * (top_scores.ndim - 1) + [(0, short)]
    return (jnp.pad(top_scores, pad, constant_values=-jnp.inf),
            jnp.pad(top_idx, pad))


def _threshold_and_extract(image_cm, max_candidates, c_std):
    """Shared masking + static-shape extraction from a correlation map."""
    h, w = image_cm.shape
    threshold = jnp.mean(image_cm) + c_std * jnp.std(image_cm)
    hh = jnp.arange(h)[:, None]
    ww = jnp.arange(w)[None, :]
    interior = ((hh >= 2) & (hh < h - 2) & (ww >= 2) & (ww < w - 2))
    mask = (image_cm >= threshold) & interior
    flat_scores = jnp.where(mask, image_cm, -jnp.inf).reshape(-1)
    count = jnp.sum(mask.astype(jnp.int32))
    k = min(max_candidates, flat_scores.shape[0])
    top_scores, top_idx = _pad_topk(*lax.top_k(flat_scores, k),
                                    max_candidates)
    valid = top_scores > -jnp.inf
    hs = jnp.where(valid, top_idx // w, 2).astype(jnp.int32)
    ws = jnp.where(valid, top_idx % w, 2).astype(jnp.int32)
    return hs, ws, valid, count


def _topk_sparse(flat, k, block_m=16):
    """Exact hierarchical top-k over sparse (-inf-masked) batched scores.

    A flat ``lax.top_k`` over H*W pixels is a full sort and dominates the
    candidate stage. Above-threshold pixels are sparse (mean + c_std*sigma
    threshold), so instead: take the top ``block_m`` of every 128-pixel
    lane block, then top-k over the merged (8x smaller) set. When every
    block holds <= block_m above-threshold pixels the per-block top is the
    complete above-threshold set, so the merge is EXACT; a lax.cond falls
    back to the flat top_k in the (rare) overflowing case. Tie ordering at
    exactly equal scores can differ from the flat sort — candidate order
    is semantically irrelevant downstream (the fit/NMS rank by R^2).
    """
    B, n = flat.shape
    pad = (-n) % 128
    flat_p = jnp.pad(flat, ((0, 0), (0, pad)),
                     constant_values=-jnp.inf) if pad else flat
    blocks = flat_p.reshape(B, -1, 128)
    nb = blocks.shape[1]

    if k > nb * block_m or n <= nb * block_m:
        return lax.top_k(flat, k)
    blk_counts = jnp.sum(blocks > -jnp.inf, axis=2)
    cheap_is_exact = jnp.max(blk_counts) <= block_m

    def cheap(_):
        bs, bi = lax.top_k(blocks, block_m)
        base = (jnp.arange(nb, dtype=bi.dtype) * 128)[None, :, None]
        merged_idx = (bi + base).reshape(B, -1)
        ts, ti = lax.top_k(bs.reshape(B, -1), k)
        return ts, jnp.take_along_axis(merged_idx, ti, axis=1)

    def full(_):
        ts, ti = lax.top_k(flat, k)
        return ts, ti

    return lax.cond(cheap_is_exact, cheap, full, None)


def _candidate_mask_batch(cms, c_std):
    """Threshold mask over batched correlation maps (pflib.py:250-253):
    cm >= mean + c_std * population std, 2-px border excluded."""
    B, h, w = cms.shape
    mean = jnp.mean(cms, axis=(1, 2), keepdims=True)
    std = jnp.std(cms, axis=(1, 2), keepdims=True)
    hh = jnp.arange(h)[:, None]
    ww = jnp.arange(w)[None, :]
    interior = ((hh >= 2) & (hh < h - 2) & (ww >= 2) & (ww < w - 2))
    return (cms >= mean + c_std * std) & interior


def _threshold_and_extract_batch(cms, max_candidates, c_std, block_m=16):
    """Batched extraction via the exact hierarchical top-k."""
    B, h, w = cms.shape
    mask = _candidate_mask_batch(cms, c_std)
    flat = jnp.where(mask, cms, -jnp.inf).reshape(B, -1)
    count = jnp.sum(mask.reshape(B, -1).astype(jnp.int32), axis=1)
    k = min(max_candidates, flat.shape[1])  # top_k needs k <= n (tiny imgs)
    top_scores, top_idx = _topk_sparse(flat, k, block_m)
    top_scores, top_idx = _pad_topk(top_scores, top_idx, max_candidates)
    valid = top_scores > -jnp.inf
    hs = jnp.where(valid, top_idx // w, 2).astype(jnp.int32)
    ws = jnp.where(valid, top_idx % w, 2).astype(jnp.int32)
    return hs, ws, valid, count


@functools.partial(jax.jit, static_argnames=("chunk", "c_std", "block_m"))
def extract_candidates_chunk(cms, excluded, chunk, c_std, block_m=16):
    """One chunk of EXHAUSTIVE candidate extraction.

    The reference has no candidate cap at all (pflib.py:217-258 fits every
    above-threshold pixel); a single static [K] bucket caps K. Chunking
    removes the cap: every dispatch extracts the top-``chunk``
    not-yet-extracted candidates, carrying a device-resident ``excluded``
    [B, H*W] mask between calls — k dispatches of ONE compiled program
    cover any candidate count.

    Chunks concatenate in the exact order a single big top-k would
    produce (scores strictly ordered across chunks; index tie-break
    within each), so downstream order-sensitive semantics (psfs-dict
    first-occurrence dedup, NMS index tie-break) match the single-bucket
    program.

    Returns (hs, ws, valid, remaining, new_excluded): ``remaining``
    counts the above-threshold pixels not yet excluded at ENTRY — the
    first call's value is the total candidate count.
    """
    B, h, w = cms.shape
    mask = _candidate_mask_batch(cms, c_std) & ~excluded.reshape(B, h, w)
    flat = jnp.where(mask, cms, -jnp.inf).reshape(B, -1)
    remaining = jnp.sum(mask.reshape(B, -1).astype(jnp.int32), axis=1)
    k = min(chunk, flat.shape[1])
    top_scores, top_idx = _topk_sparse(flat, k, block_m)
    top_scores, top_idx = _pad_topk(top_scores, top_idx, chunk)
    valid = top_scores > -jnp.inf
    rows = jnp.arange(B)[:, None]
    new_excluded = excluded.at[rows, top_idx].max(valid)
    hs = jnp.where(valid, top_idx // w, 2).astype(jnp.int32)
    ws = jnp.where(valid, top_idx % w, 2).astype(jnp.int32)
    return hs, ws, valid, remaining, new_excluded


def _correlation_maps(images, median_filter_size, corr_np):
    """Traced body: per-image correlation maps (median-filter background
    removal + template correlation, clipped at 0) — pflib.py:242-248."""
    kernel = jnp.asarray(corr_np, images.dtype)

    def one_cm(image):
        med = median_filter_2d(image, median_filter_size)
        image_mf = image - jnp.minimum(med, image)
        return jnp.maximum(correlate_2d_same(image_mf, kernel), 0.0)

    return jax.vmap(one_cm)(images)


@functools.partial(jax.jit, static_argnames=(
    "median_filter_size", "correlation_matrix"))
def candidate_maps_batch(images, median_filter_size=5,
                         correlation_matrix=None):
    """Jitted batched correlation maps (no extraction) — the shared front
    half of find_candidates_batch, exposed so the exhaustive chunked
    driver computes the maps ONCE and extracts chunk-by-chunk."""
    if correlation_matrix is None:
        correlation_matrix = HashableArray(DEFAULT_CORRELATION_MATRIX)
    return _correlation_maps(images, median_filter_size,
                             correlation_matrix.arr)


@functools.partial(jax.jit, static_argnames=(
    "median_filter_size", "correlation_matrix", "c_std", "max_candidates"))
def find_candidates_batch(images, median_filter_size=5,
                          correlation_matrix=None, c_std=2.0,
                          max_candidates=4096):
    """Batched static-shape candidate extraction over (B, H, W) images.

    Returns (hs, ws, valid, count) with leading batch dimension.
    """
    if correlation_matrix is None:
        correlation_matrix = HashableArray(DEFAULT_CORRELATION_MATRIX)
    cms = _correlation_maps(images, median_filter_size,
                            correlation_matrix.arr)
    return _threshold_and_extract_batch(cms, max_candidates=max_candidates,
                                        c_std=float(c_std))


@functools.partial(jax.jit, static_argnames=(
    "median_filter_size", "c_std", "max_candidates"))
def find_candidates(image, median_filter_size=5, correlation_matrix=None,
                    c_std=2.0, max_candidates=4096):
    """Static-shape candidate extraction.

    Returns:
        hs, ws: (max_candidates,) int32 candidate pixel coordinates (padded
            entries point at (2, 2) so patch gathers stay in-bounds).
        valid: (max_candidates,) bool validity mask.
        count: scalar int32, true number of candidates (may exceed
            max_candidates; compare to detect overflow — never silently).
    """
    image_cm, _ = candidate_map(image, median_filter_size,
                                correlation_matrix, c_std)
    return _threshold_and_extract(image_cm, max_candidates, float(c_std))


def gather_patches(image, hs, ws, radius=2):
    """Gather (2r+1)x(2r+1) patches centered at (hs, ws).

    One fused XLA gather (advanced indexing). Centers must be at least
    `radius` from every edge.
    """
    d = jnp.arange(-radius, radius + 1)
    return image[hs[:, None, None] + d[None, :, None],
                 ws[:, None, None] + d[None, None, :]]


def gather_patches_dynslice(image, hs, ws, radius):
    """Per-patch dynamic_slice gather — faster than one big XLA gather for
    LARGE windows (e.g. the 19x19 photometry squares)."""
    size = 2 * radius + 1

    def one(h, w):
        return lax.dynamic_slice(image, (h - radius, w - radius),
                                 (size, size))

    return jax.vmap(one)(hs, ws)

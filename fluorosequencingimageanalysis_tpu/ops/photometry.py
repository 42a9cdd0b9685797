"""Photometry kernels — batched measurements of spot flux.

Reference metrics (/root/reference/flexlibrary.py:160-317):
- simple: sum of the spot's square of pixels (:160-170),
- mexican_hat: sum(crown) - n_crown * median(brim) over a (2*radius+1)^2
  square whose outer `brim_size` pixels form the brim (:172-210; defaults
  brim_size=6, radius=9 -> 19x19 square, 7x7 crown),
- gaussian_volume: scaling * A * sigma_h * sigma_w from the stored fit
  (:212-230),
- sigmas: scaling * sigma_h * sigma_w (:232-241),
- maximum: sum of the top-k pixels in the square, optionally
  median-subtracted (:264-284).

Design: one batched gather of patches per (image, radius) + masked
reductions; the median over the 312-pixel brim is a sort-based reduction.
All interior spots of a frame are measured in a single dispatch; edge spots
(truncated squares) fall back to an exact host implementation that
reproduces the reference's truncation semantics.
"""

from __future__ import annotations

import functools

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
import numpy as np

from .candidates import gather_patches_dynslice as gather_patches


def crown_flat_indices(radius: int, brim_size: int) -> np.ndarray:
    """Static flat indices of the crown box inside a (2r+1)^2 patch."""
    d = 2 * radius + 1
    m = np.zeros((d, d), dtype=bool)
    m[brim_size:d - brim_size, brim_size:d - brim_size] = True
    return np.nonzero(m.reshape(-1))[0]


def brim_flat_indices(radius: int, brim_size: int) -> np.ndarray:
    d = 2 * radius + 1
    m = np.ones((d, d), dtype=bool)
    m[brim_size:d - brim_size, brim_size:d - brim_size] = False
    return np.nonzero(m.reshape(-1))[0]


def patch_reduction(method, radius, brim_size=6, top=1):
    """The metric's reduction over flattened (N, (2r+1)^2) patch rows.

    One definition of each metric's math, shared by the per-image batch
    kernels below and the whole-stack experiment kernel
    (pipeline/fast_experiment.py) so the formulas cannot drift.
    """
    if method == "mexican_hat":
        crown_idx = crown_flat_indices(radius, brim_size)
        brim_idx = brim_flat_indices(radius, brim_size)

        def reduce(flat):
            crown_sum = jnp.sum(flat[:, crown_idx], axis=-1)
            brim_median = jnp.median(flat[:, brim_idx], axis=-1)
            return crown_sum - crown_idx.size * brim_median
    elif method == "simple":
        def reduce(flat):
            return jnp.sum(flat, axis=-1)
    elif method == "maximum":
        def reduce(flat):
            return jnp.sum(jax.lax.top_k(flat, top)[0], axis=-1)
    else:
        raise ValueError("unknown patch metric: " + repr(method))
    return reduce


@functools.partial(jax.jit, static_argnames=("radius", "brim_size"))
def mexican_hat_batch(image, hs, ws, brim_size=6, radius=9):
    """(N,) mexican-hat photometries for interior spots at (hs, ws).

    Callers must ensure all (h, w) are at least `radius` from every edge;
    use the host fallback for truncated squares.
    """
    patches = gather_patches(image, hs, ws, radius=radius)
    flat = patches.reshape(patches.shape[0], -1)
    return patch_reduction("mexican_hat", radius, brim_size=brim_size)(flat)


@functools.partial(jax.jit, static_argnames=("radius",))
def simple_batch(image, hs, ws, radius=2):
    patches = gather_patches(image, hs, ws, radius=radius)
    return patch_reduction("simple", radius)(
        patches.reshape(patches.shape[0], -1))


@functools.partial(jax.jit, static_argnames=("radius", "top"))
def maximum_batch(image, hs, ws, radius=5, top=1, median_adjust=False):
    """Sum of the top-k pixels in each square; optional additive background
    adjustment by the whole-image median (flexlibrary.py:264-284)."""
    patches = gather_patches(image, hs, ws, radius=radius)
    flat = patches.reshape(patches.shape[0], -1)
    if median_adjust:
        flat = flat - jnp.median(image)
    return patch_reduction("maximum", radius, top=top)(flat)


@functools.partial(jax.jit, static_argnames=("radius", "with_sn"))
def luminosity_centroid_batch(image, hs, ws, radius=3, with_sn=True):
    """Centroid of pixel mass + Illumina S/N in squares around (hs, ws).

    Used by the timetrace tracker (flexlibrary.py:1172-1259): returns
    (centroid_h, centroid_w) in absolute image coordinates and the S/N of
    the (2*radius+1)^2 slice. Interior spots only.

    with_sn=False skips the S/N reduction and returns None in its slot —
    the tracker's GATE measures S/N at the ROUNDED centroid on the
    spot's own slice (flexlibrary.py:1247), not on this pre-centroid
    window, so computing it here would be pure waste for that caller.
    """
    patches = gather_patches(image, hs, ws, radius=radius)
    d = 2 * radius + 1
    dt = patches.dtype
    total = jnp.sum(patches.reshape(patches.shape[0], -1), axis=-1)
    idx = jnp.arange(d, dtype=dt)
    ch = jnp.sum(patches * idx[None, :, None], axis=(-2, -1)) / total
    cw = jnp.sum(patches * idx[None, None, :], axis=(-2, -1)) / total
    if with_sn:
        from .quality import illumina_s_n
        sn = illumina_s_n(patches)
    else:
        sn = None
    abs_h = ch + hs.astype(dt) - radius
    abs_w = cw + ws.astype(dt) - radius
    return abs_h, abs_w, sn


# ---------------------------------------------------------------------------
# Host fallbacks with exact edge-truncation semantics
# ---------------------------------------------------------------------------

def mexican_hat_host(image, h, w, brim_size=6, radius=9):
    """Exact reference semantics incl. edge truncation.

    The reference slices the (possibly truncated) square and assigns
    crown/brim membership by position *within the truncated slice*
    (flexlibrary.py:195-209), which we reproduce for edge spots.
    """
    image = np.asarray(image)
    sl = image[max(0, h - radius):min(image.shape[0], h + radius + 1),
               max(0, w - radius):min(image.shape[1], w + radius + 1)]
    d = 2 * radius + 1
    hh, ww = np.indices(sl.shape)
    crown = ((brim_size <= hh) & (hh < d - brim_size) &
             (brim_size <= ww) & (ww < d - brim_size))
    crown_pixels = sl[crown]
    brim_pixels = sl[~crown]
    return float(crown_pixels.sum() - crown_pixels.size *
                 np.median(brim_pixels))


def simple_host(image, h, w, radius=2):
    image = np.asarray(image)
    sl = image[max(0, h - radius):min(image.shape[0], h + radius + 1),
               max(0, w - radius):min(image.shape[1], w + radius + 1)]
    return float(sl.sum())


def maximum_host(image, h, w, radius=5, top=1, background_adjust="none"):
    image = np.asarray(image)
    sl = image[max(0, h - radius):min(image.shape[0], h + radius + 1),
               max(0, w - radius):min(image.shape[1], w + radius + 1)]
    r = np.sort(sl.ravel())
    if background_adjust == "additive":
        r = r - np.median(image)
    elif background_adjust == "multiplicative":
        raise NotImplementedError(
            "Not sure what to do if median is 0. This may be a poor metric.")
    elif background_adjust != "none":
        raise ValueError(str(background_adjust) + " is not a valid option.")
    return float(np.sum(r[-top:]))

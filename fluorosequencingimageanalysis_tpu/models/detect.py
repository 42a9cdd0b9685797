"""Whole-field spot detection + PSF fitting — the flagship compute pipeline.

This composes the kernel layer into one jitted program per field:

    candidates -> 5x5 patch gather -> batched bounded LM fit -> R^2 filter
    -> quality metrics -> consolidation NMS

replacing the reference's per-candidate Python loop around mpfit
(/root/reference/pflib.py:284-520, ``find_peptides``). The host-facing
:func:`find_peptides` preserves the reference's dict output contract
({(rounded h, rounded w): 12-tuple}, pflib.py:395-428) so the experiment
layer and artifact writers are drop-in compatible.

All intermediate arrays have static shapes ([max_candidates] buckets with
validity masks) so XLA compiles one program regardless of spot count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.candidates import (DEFAULT_CORRELATION_MATRIX, find_candidates,
                              find_candidates_batch, gather_patches)
from ..ops.consolidate import consolidate
from ..ops.gaussian import gauss2d_image
from ..ops.lm import fit_gaussians_batched
from ..ops.quality import illumina_s_n, r_squared, rmse
from ..utils.rounding import py2_round


def _fit_quality_core(images, hs, ws, num_iters, theta_starts):
    """Traced body shared by detect_and_fit_batch and the exhaustive
    chunked driver: 5x5 patch gather -> batched LM fit -> quality
    metrics -> image-coordinate centers. hs/ws: (B, K)."""
    B, K = hs.shape
    patches = jax.vmap(
        lambda img, h, w: gather_patches(img, h, w, radius=2))(
            images, hs, ws)
    flat = patches.reshape(B * K, 5, 5)
    params, _cost = fit_gaussians_batched(flat, num_iters=num_iters,
                                          theta_starts=theta_starts)

    fit_imgs = gauss2d_image(params, (5, 5), dtype=images.dtype)
    r2 = r_squared(flat, fit_imgs).reshape(B, K)
    rm = rmse(flat, fit_imgs).reshape(B, K)
    sn = illumina_s_n(flat).reshape(B, K)
    params = params.reshape(B, K, 7)

    # Patch -> image coordinates (pflib.py:456-461): the patch center pixel
    # sits at 2.5 in the bounded fit window, so center = p + fitted - 2.5.
    center_h = params[:, :, 2] + hs.astype(params.dtype) - 2.5
    center_w = params[:, :, 3] + ws.astype(params.dtype) - 2.5
    return params, center_h, center_w, rm, r2, sn


class SpotFindResult(NamedTuple):
    """Static-shape result of detect_and_fit (all length max_candidates)."""
    cand_h: jnp.ndarray        # (K,) int32 candidate pixel row
    cand_w: jnp.ndarray        # (K,) int32 candidate pixel col
    params: jnp.ndarray        # (K, 7) (H, A, p2, p3, sh, sw, theta), patch coords
    center_h: jnp.ndarray      # (K,) fitted center row in image coords
    center_w: jnp.ndarray      # (K,) fitted center col in image coords
    rmse: jnp.ndarray          # (K,)
    r2: jnp.ndarray            # (K,)
    s_n: jnp.ndarray           # (K,)
    keep: jnp.ndarray          # (K,) bool: passed R^2 filter + consolidation
    cand_valid: jnp.ndarray    # (K,) bool: real candidate (not padding)
    cand_count: jnp.ndarray    # () int32: true candidate count (overflow check)


@functools.partial(jax.jit, static_argnames=(
    "median_filter_size", "correlation_matrix", "c_std", "r_2_threshold",
    "consolidation_radius", "max_candidates", "num_iters",
    "theta_starts"))
def detect_and_fit_batch(images, median_filter_size=5,
                         correlation_matrix=None, c_std=2.0,
                         r_2_threshold=0.7, consolidation_radius=4.0,
                         max_candidates=4096, num_iters=60,
                         theta_starts=1):
    """Jitted batched detection + fit. images: (B, H, W) float array.

    All per-image candidate buckets are fused into ONE batched LM call
    (B*K fits).
    """
    from ..ops.candidates import HashableArray
    images = jnp.asarray(images)
    B = images.shape[0]
    if correlation_matrix is None:
        correlation_matrix = HashableArray(DEFAULT_CORRELATION_MATRIX)
    elif not isinstance(correlation_matrix, HashableArray):
        correlation_matrix = HashableArray(correlation_matrix)
    hs, ws, valid, count = find_candidates_batch(
        images, median_filter_size=median_filter_size,
        correlation_matrix=correlation_matrix,
        c_std=float(c_std), max_candidates=max_candidates)

    params, center_h, center_w, rm, r2, sn = _fit_quality_core(
        images, hs, ws, num_iters, theta_starts)

    # ~(r2 < thr), NOT (r2 >= thr): the reference's gate is "discard if
    # r_2 < threshold" (pflib.py:465-467), and a NaN R^2 (flat saturated
    # patch: ss_tot == ss_res == 0) fails that comparison — the fit is
    # KEPT. consolidate ranks NaN scores at -inf, so a NaN fit survives
    # when isolated and loses to any rival (the reference's scan deletes
    # exactly one member of every rival pair even under NaN comparisons;
    # see ops/consolidate._score).
    passed = valid & ~(r2 < r_2_threshold)
    keep = jax.vmap(
        lambda ch, cw, r, p: consolidate(ch, cw, r, p,
                                         radius=consolidation_radius))(
        center_h, center_w, r2, passed)
    return SpotFindResult(hs, ws, params, center_h, center_w, rm, r2, sn,
                          keep, valid, count)


@functools.partial(jax.jit, static_argnames=("max_spots", "coord_dtype"))
def pack_spot_buckets(res: SpotFindResult, max_spots: int,
                      coord_dtype=jnp.int16):
    """Keep-first transfer compaction of a batched SpotFindResult.

    The full result schema fetches every candidate slot's fit product —
    [B, K] x 9 float arrays — but the reference's product per image is
    only the CONSOLIDATED R^2-passing fits (pflib.py:479-519 returns the
    surviving dict entries; rejected candidates never leave
    find_peptides), so fetching all K slots moves mostly unused bytes.
    This packs each image's slots KEPT-FIRST (stable within
    each class, so kept spots preserve candidate order) and slices to
    ``max_spots``, emitting THREE transfer arrays:

      f32 [B, S, 12]: center_h, center_w, rmse, r2, s_n, params[0..6]
      ints [B, S, 2]: cand_h, cand_w (``coord_dtype``; int16 is exact
                      for images narrower than 32768 px)
      flags [B, S, 2]: keep, cand_valid  (bool)

    plus spot_count [B] (exact per-image keep totals — the overflow
    check: spot_count > max_spots means kept fits were truncated, in
    CANDIDATE order: the slots beyond max_spots are dropped regardless
    of fit quality) and
    the pass-through cand_count [B]. At S=2048 this is ~4.4x fewer
    fetch bytes than the full K=8192 schema, with bit-identical values
    for every kept slot.
    """
    order = jnp.argsort(~res.keep, axis=1, stable=True)[:, :max_spots]

    def take(a):
        return jnp.take_along_axis(a, order, axis=1)

    dt = res.params.dtype
    f32 = jnp.stack(
        [take(res.center_h).astype(dt), take(res.center_w).astype(dt),
         take(res.rmse).astype(dt), take(res.r2).astype(dt),
         take(res.s_n).astype(dt)] +
        [jnp.take_along_axis(res.params[:, :, i], order, axis=1)
         for i in range(7)], axis=-1)
    ints = jnp.stack([take(res.cand_h).astype(coord_dtype),
                      take(res.cand_w).astype(coord_dtype)], axis=-1)
    flags = jnp.stack([take(res.keep), take(res.cand_valid)], axis=-1)
    spot_count = res.keep.sum(axis=1).astype(jnp.int32)
    return f32, ints, flags, spot_count, res.cand_count


def unpack_spot_buckets(f32, ints, flags, spot_count, cand_count):
    """Host-side inverse of :func:`pack_spot_buckets`: rebuild the
    SpotFindResult field dict (numpy, spot-major keep-first arrays)."""
    f32 = np.asarray(f32)
    ints = np.asarray(ints)
    flags = np.asarray(flags)
    return {
        "cand_h": ints[..., 0].astype(np.int32),
        "cand_w": ints[..., 1].astype(np.int32),
        "params": f32[..., 5:12],
        "center_h": f32[..., 0],
        "center_w": f32[..., 1],
        "rmse": f32[..., 2],
        "r2": f32[..., 3],
        "s_n": f32[..., 4],
        "keep": flags[..., 0],
        "cand_valid": flags[..., 1],
        "spot_count": np.asarray(spot_count),
        "cand_count": np.asarray(cand_count),
    }


@functools.partial(jax.jit, static_argnames=("num_iters", "theta_starts"))
def _fit_chunk_packed(images, hs, ws, valid, num_iters=60, theta_starts=1):
    """One candidate chunk's fits, packed into a single [B, K, 15] array
    (the images' float dtype) so each chunk costs ONE device->host
    transfer (per-array fetches are full link round trips). Columns:
    center_h, center_w, r2, valid, rmse, s_n, cand_h, cand_w,
    params[0..6]. Coordinates are < 2^24 so the float pack is exact."""
    params, ch, cw, rm, r2, sn = _fit_quality_core(
        images, hs, ws, num_iters, theta_starts)
    dt = params.dtype
    cols = [ch.astype(dt), cw.astype(dt), r2.astype(dt),
            valid.astype(dt), rm.astype(dt), sn.astype(dt),
            hs.astype(dt), ws.astype(dt)]
    cols += [params[:, :, i] for i in range(7)]
    return jnp.stack(cols, axis=-1)


def detect_and_fit_exhaustive(images, median_filter_size=5,
                              correlation_matrix=None, c_std=2.0,
                              r_2_threshold=0.7, consolidation_radius=4.0,
                              chunk=None, num_iters=60, theta_starts=1,
                              max_chunks=None):
    """Uncapped detect + fit: EVERY above-threshold candidate is fitted,
    matching the reference's no-cap semantics (pflib.py:217-258) with
    programs of one fixed chunk shape.

    Design: the correlation maps compile once (candidate_maps_batch);
    extraction dispatches the ONE compiled ``chunk``-sized top-k program
    k times with a device-resident exclusion mask (never a big top-k);
    each chunk's 5x5 LM fits + quality metrics run through the one
    compiled ``_fit_chunk_packed`` program with async result copies; the
    quality-ranked NMS runs on HOST over the chunk union
    (ops.consolidate.consolidate_host — property-tested identical to the
    device fixpoint). Chunked == single-bucket parity is CI-tested.

    ``max_chunks``: None (default) = truly unlimited — every candidate
    is fitted no matter the density (the reference has no cap either);
    an integer bounds the rounds with a loud truncation warning.

    Returns a batch SpotFindResult (leading B axis) as NUMPY arrays with
    K = n_chunks * chunk; ``cand_count`` is the per-image true count.
    """
    from ..ops.candidates import (candidate_maps_batch,
                                  extract_candidates_chunk)
    from ..ops.consolidate import consolidate_host

    images_np = np.asarray(images) if not isinstance(images, jax.Array) \
        else images
    if chunk is None:
        # Per-backend constant (utils/probes.detect_chunk); results are
        # chunk-size invariant (parity-tested).
        from ..utils import probes

        chunk = probes.detect_chunk()
    imgs = jnp.asarray(images_np)
    if not jnp.issubdtype(imgs.dtype, jnp.floating):
        imgs = imgs.astype(jnp.float32)  # raw camera dtypes cast on device
    B, H, W = imgs.shape
    chunk = min(chunk, max(H * W, 1))
    cms = candidate_maps_batch(
        imgs, median_filter_size=median_filter_size,
        correlation_matrix=_prep_correlation_matrix(correlation_matrix))
    excluded = jnp.zeros((B, H * W), bool)
    hs, ws, valid, remaining, excluded = extract_candidates_chunk(
        cms, excluded, chunk, float(c_std))
    counts = np.asarray(remaining)              # first call: TRUE counts
    n_chunks = max(1, -(-int(counts.max()) // chunk))
    if max_chunks is not None and n_chunks > max_chunks:
        import logging
        logging.getLogger(__name__).warning(
            "detect_and_fit_exhaustive: %d candidates need %d chunks; "
            "capping at max_chunks=%d (weakest-correlation candidates "
            "dropped). Raise max_chunks for exhaustive coverage.",
            int(counts.max()), n_chunks, max_chunks)
        n_chunks = max_chunks
    packs, cand_hs, cand_ws, valids = [], [], [], []
    for i in range(n_chunks):
        if i > 0:
            hs, ws, valid, _rem, excluded = extract_candidates_chunk(
                cms, excluded, chunk, float(c_std))
        pack = _fit_chunk_packed(imgs, hs, ws, valid,
                                 num_iters=num_iters,
                                 theta_starts=theta_starts)
        pack.copy_to_host_async()
        packs.append(pack)
    packed = np.concatenate([np.asarray(p) for p in packs], axis=1)
    center_h = packed[:, :, 0]
    center_w = packed[:, :, 1]
    r2 = packed[:, :, 2]
    cand_valid = packed[:, :, 3] > 0
    rm = packed[:, :, 4]
    sn = packed[:, :, 5]
    cand_h = packed[:, :, 6].astype(np.int32)
    cand_w = packed[:, :, 7].astype(np.int32)
    params = packed[:, :, 8:15]
    # NaN R^2 is KEPT by the reference's discard-if-less gate — same
    # comparison as detect_and_fit_batch.
    passed = cand_valid & ~(r2 < r_2_threshold)
    keep = np.stack([
        consolidate_host(center_h[b], center_w[b], r2[b], passed[b],
                         radius=float(consolidation_radius))
        for b in range(B)])
    return SpotFindResult(cand_h, cand_w, params, center_h, center_w,
                          rm, r2, sn, keep, cand_valid,
                          counts.astype(np.int32))


def _prep_correlation_matrix(correlation_matrix):
    """Validate + make hashable for the jitted static argument.

    The reference rejects non-square / even-sided kernels loudly
    (pflib.py:235-239); an even kernel would otherwise silently shift
    the SAME-padded correlation map by half a pixel."""
    from ..ops.candidates import HashableArray
    if correlation_matrix is None:
        return None
    arr = (correlation_matrix.arr
           if isinstance(correlation_matrix, HashableArray)
           else np.asarray(correlation_matrix))
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1] or \
            arr.shape[0] % 2 == 0:
        raise ValueError("correlation_matrix must be square, with an odd "
                         "number of rows and columns")
    return (correlation_matrix
            if isinstance(correlation_matrix, HashableArray)
            else HashableArray(arr))


def detect_and_fit(image, median_filter_size=5, correlation_matrix=None,
                   c_std=2.0, r_2_threshold=0.7, consolidation_radius=4.0,
                   max_candidates=4096, num_iters=60):
    """Single-field detection + fit (batch of one). Image: (H, W)."""
    correlation_matrix = _prep_correlation_matrix(correlation_matrix)
    res = detect_and_fit_batch(
        jnp.asarray(image)[None], median_filter_size=median_filter_size,
        correlation_matrix=correlation_matrix, c_std=float(c_std),
        r_2_threshold=float(r_2_threshold),
        consolidation_radius=float(consolidation_radius),
        max_candidates=max_candidates, num_iters=num_iters)
    return SpotFindResult(*(x[0] for x in res))


def find_peptides(image, median_filter_size=5, correlation_matrix=None,
                  candidate_pixels=None, c_std=2, r_2_threshold=0.7,
                  consolidation_radius=4, fit_type="gauss", N_iter=10 ** 3,
                  max_candidates=None, num_iters=60, dtype=np.float32,
                  rng_seed=0):
    """Host-facing spot finder with the reference's output contract.

    Returns {(round(h_0), round(w_0)): (h_0, w_0, H, A, sigma_h, sigma_w,
    theta, sub_img, fit_img, rmse, r_2, s_n)} exactly as
    /root/reference/pflib.py:395-428 documents. sub_img is the int64 copy of
    the 5x5 patch; fit_img the model evaluated on the patch grid.

    max_candidates=None (the default) is EXHAUSTIVE, like the reference
    (pflib.py:217-258 has no candidate cap): the chunked driver fits
    every above-threshold candidate regardless of count. An integer caps
    the bucket (single device program; loud truncation warning when the
    image exceeds it).

    fit_type='monte_carlo' replicates the normalized random-search fitter
    (pflib.py:117-177) vectorized over candidates and samples; its fit image
    is the best sampled surface (the reference returns the last sampled one —
    an apparent bug we do not reproduce). The MC path keeps a 4096 cap
    when max_candidates is None.
    """
    if consolidation_radius < 2:
        raise ValueError("consolidation_radius must be at least 2")
    # candidate_pixels parity: the reference documents it "Not yet
    # implemented" and unconditionally overwrites it with _psf_candidates'
    # output (pflib.py:374, 434) — i.e. a passed value is SILENTLY ignored.
    # Reproduced (with a warning, which the reference omits).
    if candidate_pixels is not None:
        import logging
        logging.getLogger(__name__).warning(
            "find_peptides: candidate_pixels is ignored (reference parity; "
            "pflib.py documents it as not implemented and overwrites it).")
    image = np.asarray(image)
    img_dev = jnp.asarray(image.astype(dtype))
    correlation_matrix = _prep_correlation_matrix(correlation_matrix)

    if fit_type == "monte_carlo":
        if max_candidates is None:
            max_candidates = 4096
        res = _detect_and_fit_monte_carlo(
            img_dev, median_filter_size=median_filter_size,
            correlation_matrix=(None if correlation_matrix is None
                                else correlation_matrix.arr), c_std=c_std,
            r_2_threshold=r_2_threshold,
            consolidation_radius=consolidation_radius,
            max_candidates=max_candidates, n_iter=N_iter, rng_seed=rng_seed)
    elif max_candidates is None:
        res_b = detect_and_fit_exhaustive(
            img_dev[None], median_filter_size=median_filter_size,
            correlation_matrix=correlation_matrix, c_std=float(c_std),
            r_2_threshold=float(r_2_threshold),
            consolidation_radius=float(consolidation_radius),
            num_iters=num_iters)
        res = SpotFindResult(*(x[0] for x in res_b))
    else:
        res = detect_and_fit(
            img_dev, median_filter_size=median_filter_size,
            correlation_matrix=correlation_matrix, c_std=float(c_std),
            r_2_threshold=float(r_2_threshold),
            consolidation_radius=float(consolidation_radius),
            max_candidates=max_candidates, num_iters=num_iters)

    count = int(res.cand_count)
    if max_candidates is not None and count > max_candidates:
        import logging
        logging.getLogger(__name__).warning(
            "find_peptides: %d candidates exceed max_candidates=%d; the "
            "weakest-correlation candidates were dropped. Re-run with a "
            "larger max_candidates for exhaustive coverage.",
            count, max_candidates)

    keep = np.asarray(res.keep)
    idx = np.nonzero(keep)[0]
    params = np.asarray(res.params)
    center_h = np.asarray(res.center_h)
    center_w = np.asarray(res.center_w)
    rm = np.asarray(res.rmse)
    r2 = np.asarray(res.r2)
    sn = np.asarray(res.s_n)
    cand_h = np.asarray(res.cand_h)
    cand_w = np.asarray(res.cand_w)

    return _psfs_from_arrays(image, idx, params, center_h, center_w, rm,
                             r2, sn, cand_h, cand_w, fit_type=fit_type)


@jax.jit
def _fit_images_jit(params):
    """Batched 5x5 fit-image evaluation (one compiled program per dtype)."""
    return gauss2d_image(params, (5, 5), dtype=params.dtype)


@jax.jit
def _lean_pack(keep, center_h, center_w, params, cand_count):
    """Pack the detect outputs a tracker needs into ONE [K, 11] array so
    a single device->host transfer suffices.

    Columns: center_h, center_w, keep, cand_count (broadcast; counts are
    exact in f32 up to 2^24), then the 7 fit params.
    """
    K = keep.shape[0]
    cols = [center_h, center_w, keep.astype(jnp.float32),
            jnp.full((K,), cand_count, jnp.float32)]
    cols += [params[:, i] for i in range(7)]
    return jnp.stack(cols, axis=1)


def _center_keys(keep_idx, center_h, center_w, params):
    """Py2-rounded first-occurrence key dedup over kept fits in candidate
    order (pflib.py:513-519). Shared by both find_peptide_centers paths."""
    seen = set()
    h0, w0, fits = [], [], []
    for i in keep_idx:
        ch, cw = float(center_h[i]), float(center_w[i])
        key = (py2_round(ch), py2_round(cw))
        if key in seen:
            continue
        seen.add(key)
        h0.append(key[0])
        w0.append(key[1])
        p = params[i]
        fits.append((ch, cw, float(p[0]), float(p[1]), float(p[4]),
                     float(p[5]), float(p[6])))
    return np.asarray(h0), np.asarray(w0), fits


def find_peptide_centers(image, median_filter_size=5, c_std=2.0,
                         r_2_threshold=0.7, consolidation_radius=4.0,
                         max_candidates=None, num_iters=60):
    """Lean find_peptides: the psfs-dict KEY semantics (Py2-rounded
    first-occurrence dedup in kept-candidate order, pflib.py:513-519)
    without materializing sub/fit images — one device dispatch + one
    fetch. Returns (h0, w0, fits, count): float centers and 7-tuple fits
    (h_0, w_0, H, A, sigma_h, sigma_w, theta — indices 0-6 of the psfs
    tuple) per unique rounded key, plus the true candidate count.

    max_candidates=None (default) is EXHAUSTIVE via the chunked driver —
    the reference's no-cap semantics with zero truncation regardless of
    candidate count; an integer caps the bucket (one dispatch, loud
    truncation warning on overflow)."""
    if consolidation_radius < 2:
        # find_peptides / reference guard (pflib.py:431-432): key-
        # uniqueness of the rounded-center dedup requires radius >= 2.
        raise ValueError("consolidation_radius must be at least 2")
    image = jnp.asarray(image)
    if image.dtype != jnp.float32:
        image = image.astype(jnp.float32)  # raw camera dtypes cast on device
    if max_candidates is None:
        res_b = detect_and_fit_exhaustive(
            image[None], median_filter_size=median_filter_size,
            c_std=float(c_std), r_2_threshold=float(r_2_threshold),
            consolidation_radius=float(consolidation_radius),
            num_iters=num_iters)
        count = int(res_b.cand_count[0])
        h0, w0, fits = _center_keys(np.nonzero(res_b.keep[0])[0],
                                    res_b.center_h[0], res_b.center_w[0],
                                    res_b.params[0])
        return h0, w0, fits, count
    res = detect_and_fit(
        image, median_filter_size=median_filter_size,
        c_std=float(c_std), r_2_threshold=float(r_2_threshold),
        consolidation_radius=float(consolidation_radius),
        max_candidates=max_candidates, num_iters=num_iters)
    packed = np.asarray(_lean_pack(res.keep, res.center_h, res.center_w,
                                   res.params, res.cand_count))
    count = int(packed[0, 3]) if packed.shape[0] else 0
    if count > max_candidates:
        import logging
        logging.getLogger(__name__).warning(
            "find_peptide_centers: %d candidates exceed max_candidates=%d; "
            "the weakest-correlation candidates were dropped. Re-run with "
            "a larger max_candidates for exhaustive coverage.",
            count, max_candidates)
    h0, w0, fits = _center_keys(np.nonzero(packed[:, 2] > 0)[0],
                                packed[:, 0], packed[:, 1], packed[:, 4:11])
    return h0, w0, fits, count


def _psfs_from_arrays(image, idx, params, center_h, center_w, rm, r2, sn,
                      cand_h, cand_w, fit_type="gauss"):
    """Kept-fit arrays -> the reference psfs dict (pflib.py:395-428)."""
    out = {}
    fit_imgs = None
    if fit_type != "monte_carlo" and len(idx):
        # ONE batched model evaluation + ONE fetch for all kept spots
        # instead of a dispatch and a round trip per spot. The batch is
        # padded to a power-of-two bucket so every call hits an
        # already-compiled (persistent-cached) program.
        from ..utils.dispatch import pow2_bucket

        n = len(idx)
        pp = params[idx]
        bucket = pow2_bucket(n, 1 << 20)
        if bucket != n:
            pp = np.concatenate([pp, np.ones((bucket - n, 7), pp.dtype)])
        # Honest dtype request: without x64 jax silently canonicalizes a
        # float64 ask down to float32, so the tested configuration
        # (conftest enables x64) would differ from production. Same
        # pattern as ops/registration.py:124.
        dt = (jnp.float64 if jax.config.read("jax_enable_x64")
              else jnp.float32)
        fit_imgs = np.asarray(_fit_images_jit(jnp.asarray(pp, dt)))[:n]
    for j, i in enumerate(idx):
        h, w = int(cand_h[i]), int(cand_w[i])
        sub_img = image[h - 2:h + 3, w - 2:w + 3].astype(np.int64)
        if fit_type == "monte_carlo":
            # MC path fits the normalized patch; sub_img in the output tuple
            # is the normalized copy (parity: pflib.py:444-450 normalizes
            # sub_img in place before fitting and stores it).
            smin = sub_img.min()
            shifted = (sub_img - smin).astype(np.float64)
            sub_img = shifted / max(float(shifted.max()), 1e-300)
        p = params[i]
        fit_img = fit_imgs[j] if fit_imgs is not None else _mc_fit_image(p)
        h_0, w_0 = float(center_h[i]), float(center_w[i])
        psf = (h_0, w_0, float(p[0]), float(p[1]), float(p[4]), float(p[5]),
               float(p[6]), sub_img, fit_img, float(rm[i]), float(r2[i]),
               float(sn[i]))
        # Py2 half-away-from-zero rounding keeps keys identical to the
        # reference's (pflib.py:513-519 under Python 2 round()).
        key = (py2_round(h_0), py2_round(w_0))
        out.setdefault(key, psf)
    return out


def warn_candidate_overflow(cand_count, max_candidates, where):
    """Loud (never silent) candidate-bucket truncation report, shared by
    the batch front doors (find_peptides_batch, api.Pipeline.run_zstack)."""
    import logging

    n_over = int((np.asarray(cand_count) > max_candidates).sum())
    if n_over:
        logging.getLogger(__name__).warning(
            "%s: %d image(s) exceed max_candidates=%d; the weakest-"
            "correlation candidates were dropped.",
            where, n_over, max_candidates)


def psfs_dicts_from_batch(images, keep, params, center_h, center_w,
                          rmse, r2, s_n, cand_h, cand_w,
                          consolidation_radius):
    """Per-image reference psfs dicts (pflib.py:395-428 contract) from
    batched kept-fit arrays — shared by find_peptides_batch and
    api.Pipeline.run_zstack(psfs=True) so the dict build and its
    key-uniqueness precondition live in one place."""
    if consolidation_radius < 2:
        # Same guard as find_peptides / the reference (pflib.py:431-432):
        # below 2 the rounded-key-uniqueness invariant of the psfs dict
        # no longer holds, and the dedup would silently drop spots.
        raise ValueError("consolidation_radius must be at least 2")
    return [
        _psfs_from_arrays(images[b], np.nonzero(keep[b])[0], params[b],
                          center_h[b], center_w[b], rmse[b], r2[b], s_n[b],
                          cand_h[b], cand_w[b])
        for b in range(len(images))
    ]


def find_peptides_batch(images, median_filter_size=5, correlation_matrix=None,
                        c_std=2, r_2_threshold=0.7, consolidation_radius=4,
                        max_candidates=None, num_iters=60, dtype=np.float32):
    """find_peptides over a same-shape image stack in ONE device program.

    The reference's parallel_image_batch exists to spread its per-image
    Python cost over processes (pflib.py:1000-1111); here the equivalent
    is batching the whole stack through detect_and_fit_batch. Returns a
    list of psfs dicts, one per image, identical to per-image
    find_peptides (fit_type='gauss').

    max_candidates=None (default) is EXHAUSTIVE (the reference's no-cap
    semantics) via the chunked driver; an integer caps the per-image
    bucket with a loud truncation warning on overflow.
    """
    if consolidation_radius < 2:
        # Same guard as find_peptides / the reference (pflib.py:431-432):
        # below 2 the rounded-key-uniqueness invariant of the psfs dict
        # no longer holds, and the dedup would silently drop spots.
        raise ValueError("consolidation_radius must be at least 2")
    images = np.asarray(images)
    if max_candidates is None:
        res = detect_and_fit_exhaustive(
            jnp.asarray(images.astype(dtype)),
            median_filter_size=median_filter_size,
            correlation_matrix=_prep_correlation_matrix(correlation_matrix),
            c_std=float(c_std), r_2_threshold=float(r_2_threshold),
            consolidation_radius=float(consolidation_radius),
            num_iters=num_iters)
    else:
        res = detect_and_fit_batch(
            jnp.asarray(images.astype(dtype)),
            median_filter_size=median_filter_size,
            correlation_matrix=_prep_correlation_matrix(correlation_matrix),
            c_std=float(c_std),
            r_2_threshold=float(r_2_threshold),
            consolidation_radius=float(consolidation_radius),
            max_candidates=max_candidates, num_iters=num_iters)
        warn_candidate_overflow(res.cand_count, max_candidates,
                                "find_peptides_batch")
    return psfs_dicts_from_batch(
        images, np.asarray(res.keep), np.asarray(res.params),
        np.asarray(res.center_h), np.asarray(res.center_w),
        np.asarray(res.rmse), np.asarray(res.r2), np.asarray(res.s_n),
        np.asarray(res.cand_h), np.asarray(res.cand_w),
        consolidation_radius)


# ---------------------------------------------------------------------------
# Monte-Carlo fit path (reference pflib.py:117-177, fit_type='monte_carlo')
# ---------------------------------------------------------------------------

def _mc_model(params, h_grid, w_grid):
    """Circular Gaussian the MC fitter samples (pflib.py:93-115).

    Note the reference's _2d_gaussian_function ignores sigma_w and theta —
    it is circular with sigma_h only.
    """
    H = params[..., 0, None, None]
    A = params[..., 1, None, None]
    h0 = params[..., 2, None, None]
    w0 = params[..., 3, None, None]
    sh = params[..., 4, None, None]
    a = (h_grid - h0) ** 2
    b = (w_grid - w0) ** 2
    return A * jnp.exp(-(a + b) / (2.0 * sh ** 2)) + H


def _mc_fit_image(p):
    """Best-sample MC fit surface, normalized by its max (pflib.py:159-161)."""
    h_grid, w_grid = np.meshgrid(np.arange(5.0), np.arange(5.0), indexing="ij")
    g = p[1] * np.exp(-(((h_grid - p[2]) ** 2) + ((w_grid - p[3]) ** 2))
                      / (2.0 * p[4] ** 2)) + p[0]
    return g / g.max()


@functools.partial(jax.jit, static_argnames=(
    "median_filter_size", "c_std", "r_2_threshold", "consolidation_radius",
    "max_candidates", "n_iter"))
def _detect_and_fit_monte_carlo(image, median_filter_size=5,
                                correlation_matrix=None, c_std=2.0,
                                r_2_threshold=0.7, consolidation_radius=4.0,
                                max_candidates=4096, n_iter=1000, rng_seed=0):
    if correlation_matrix is None:
        correlation_matrix = DEFAULT_CORRELATION_MATRIX
    hs, ws, valid, count = find_candidates(
        image, median_filter_size=median_filter_size,
        correlation_matrix=jnp.asarray(correlation_matrix, image.dtype),
        c_std=c_std, max_candidates=max_candidates)
    raw = gather_patches(image, hs, ws, radius=2)
    # Normalize each patch to [0, 1] (pflib.py:446-447).
    flat = raw.reshape(raw.shape[0], -1)
    pmin = jnp.min(flat, axis=-1)[:, None, None]
    shifted = raw - pmin
    pmax = jnp.maximum(jnp.max(shifted.reshape(raw.shape[0], -1), axis=-1),
                       1e-12)[:, None, None]
    patches = shifted / pmax

    dt = image.dtype
    h_grid, w_grid = jnp.meshgrid(jnp.arange(5, dtype=dt),
                                  jnp.arange(5, dtype=dt), indexing="ij")

    # Seed distributions (pflib.py:125-157): centers around the argmax pixel.
    argmax = jnp.argmax(patches.reshape(patches.shape[0], -1), axis=-1)
    h0_mean = (argmax // 5).astype(dt)
    w0_mean = (argmax % 5).astype(dt)

    key = jax.random.PRNGKey(rng_seed)
    kH, kA, kh, kw, ksh, ksw = jax.random.split(key, 6)
    n = patches.shape[0]
    shape = (n_iter, n)
    H_s = jnp.abs(0.1 * jax.random.normal(kH, shape, dt))
    A_s = jnp.abs(1.0 + 0.2 * jax.random.normal(kA, shape, dt))
    h0_s = jnp.clip(h0_mean[None, :] + 0.3 * jax.random.normal(kh, shape, dt),
                    0.01, 4.99)
    w0_s = jnp.clip(w0_mean[None, :] + 0.3 * jax.random.normal(kw, shape, dt),
                    0.01, 4.99)
    sh_s = jnp.abs(1.2 + 0.3 * jax.random.normal(ksh, shape, dt))
    sw_s = jnp.abs(1.0 + 0.3 * jax.random.normal(ksw, shape, dt))

    def score_chunk(carry, xs):
        best_rms, best_p = carry
        Hc, Ac, h0c, w0c, shc, swc = xs
        # 6-vector: model uses slots 0-4; slot 5 (sampled sigma_w) rides
        # along for reporting parity (the reference stores the sampled
        # sigma_w although its model ignores it, pflib.py:113-177).
        p = jnp.stack([Hc, Ac, h0c, w0c, shc, swc], axis=-1)  # (n, 6)
        g = _mc_model(p, h_grid, w_grid)
        g = g / jnp.max(g.reshape(n, -1), axis=-1)[:, None, None]
        rms = jnp.sqrt(jnp.sum((patches - g) ** 2, axis=(-2, -1)))
        better = rms < best_rms
        best_rms = jnp.where(better, rms, best_rms)
        best_p = jnp.where(better[:, None], p, best_p)
        return (best_rms, best_p), None

    init = (jnp.full((n,), jnp.inf, dt), jnp.zeros((n, 6), dt))
    (best_rms, best_p), _ = jax.lax.scan(
        score_chunk, init, (H_s, A_s, h0_s, w0_s, sh_s, sw_s))

    params = jnp.stack([best_p[:, 0], best_p[:, 1], best_p[:, 2],
                        best_p[:, 3], best_p[:, 4], best_p[:, 5],
                        jnp.zeros((n,), dt)], axis=-1)

    g = _mc_model(best_p, h_grid, w_grid)
    g = g / jnp.max(g.reshape(n, -1), axis=-1)[:, None, None]
    r2 = r_squared(patches, g)
    rm = rmse(patches, g)
    sn = illumina_s_n(patches)

    center_h = params[:, 2] + hs.astype(dt) - 2.5
    center_w = params[:, 3] + ws.astype(dt) - 2.5
    # ~(r2 < thr): NaN R^2 is KEPT, like the reference's discard-if-less
    # gate (pflib.py:465-467) — see detect_and_fit_batch.
    passed = valid & ~(r2 < r_2_threshold)
    # Candidate-window gate matters HERE: MC centers drift up to
    # ~2.5 px, so center distance alone could compare fits the reference
    # never pits against each other (pflib.py:491-495).
    keep = consolidate(center_h, center_w, r2, passed,
                       radius=consolidation_radius,
                       cand_h=hs.astype(dt), cand_w=ws.astype(dt))
    return SpotFindResult(hs, ws, params, center_h, center_w, rm, r2, sn,
                          keep, valid, count)

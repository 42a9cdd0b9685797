"""Batched SExtractor mesh background estimation over image stacks.

Device redesign of the host ``pipeline.spots._mesh_background`` (the
photutils ``Background`` stand-in the sextractor photometry metric uses,
validated against the photutils spec in tests/test_sextractor_numerics.py;
reference call site: flexlibrary.py:446-486). BASELINE.json config 2 is
exactly this workload — background estimation + batched multi-spot PSF
fits over a z/time stack — so the whole estimator runs as ONE jitted
program over a ``[frames, H, W]`` stack:

- per-box sigma clipping and the SExtractor mode estimator are masked
  lane-parallel reductions over ALL (frame, box) rows at once (the fixed
  ``fori_loop`` is semantically identical to the host's early-exit loop:
  a box with nothing left to reject is a fixpoint of the update);
- the mesh median filter is a static reflect-index gather + sort
  (scipy ``median_filter`` rank convention: element ``k*k // 2`` of the
  sorted window, window spanning ``[i - k//2, i + (k-1)//2]``);
- the cubic ``BkgZoomInterpolator`` upsample becomes two matmuls
  against host-precomputed spline basis matrices: ``scipy.ndimage.zoom``
  is LINEAR in the mesh, so applying it to identity basis vectors once
  per (n, box_size, order) yields matrices that reproduce it exactly
  (verified to 2e-15 on host; the f32 device matmuls at HIGHEST
  precision match the f64 host path to ~1e-6 relative).

The frame axis is pure data parallelism: ``stack_background(mesh=...)``
shards it over the mesh's first axis with no collectives.
"""

from __future__ import annotations

import functools

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
import numpy as np

_REFLECT_INDEX_CACHE: dict = {}
_PAIR_BASIS_CACHE: dict = {}


def pairwise_zoom_bases(nh: int, nw: int, box_size: int) -> tuple:
    """(A_h [nh*box, nh], A_w [nw*box, nw]) reproducing the HOST mesh
    upsample (pipeline.spots._mesh_background's zoom branch) as two
    matmuls, exactly.

    The host recipe is per-axis spline orders min(3, n-1) via one 2-D
    zoom (equal orders) or two sequential passes (mixed orders). Either
    way the operator is verified-linear and EXACTLY separable (rank-1 in
    the (h,i)x(w,j) pairing, checked by SVD of the full small-case
    operator) — but its axis factors include scipy's approximate IIR
    prefilter boundary handling (error ~pole^n on short axes: 1.7e-3 at
    n=2 for cubic), which a plain per-axis 1-D zoom basis does not
    capture; the defect even breaks exact constant reproduction
    (zoom(ones) != ones at the boundary). So each factor is extracted
    from the actual host computation with single-box basis meshes
    against a fixed reference box: f(e_i x e_j0)[:, w0] = A_h[:, i] *
    A_w[w0, j0] isolates A_h's columns up to ONE shared scalar
    (symmetrically for A_w), and that scalar — the tensor element
    A_h[h0, i0]*A_w[w0, j0] = f(e_i0 x e_j0)[h0, w0] — divides out.
    Cached per (nh, nw, box_size); float64.
    """
    key = (nh, nw, box_size)
    if key not in _PAIR_BASIS_CACHE:
        from scipy.ndimage import zoom

        order_h = min(3, nh - 1)
        order_w = min(3, nw - 1)

        def host_zoom(mesh):
            # Mirror of pipeline.spots._mesh_background's branch.
            if order_h == order_w:
                return zoom(mesh, box_size, order=order_h,
                            mode="reflect", grid_mode=True)
            up = zoom(mesh, (1.0, float(box_size)), order=order_w,
                      mode="reflect", grid_mode=True)
            return zoom(up, (float(box_size), 1.0), order=order_h,
                        mode="reflect", grid_mode=True)

        # Reference box at the mesh center, sampled at its center pixel
        # (the spline basis peaks there — well-conditioned division).
        i0, j0 = nh // 2, nw // 2
        h0 = i0 * box_size + box_size // 2
        w0 = j0 * box_size + box_size // 2

        def basis(i, j):
            m = np.zeros((nh, nw))
            m[i, j] = 1.0
            return host_zoom(m)

        Ah = np.empty((nh * box_size, nh), np.float64)
        for i in range(nh):
            Ah[:, i] = basis(i, j0)[:, w0]      # A_h[:, i] * A_w[w0, j0]
        Aw = np.empty((nw * box_size, nw), np.float64)
        for j in range(nw):
            Aw[:, j] = basis(i0, j)[h0, :]      # A_w[:, j] * A_h[h0, i0]
        gamma = Ah[h0, i0]                       # = A_h[h0,i0] * A_w[w0,j0]
        Ah /= gamma                              # divides the shared scale
        # Loud build-time check of the tensor factorization on a random
        # mesh (never silently wrong if a scipy version breaks the
        # per-axis structure).
        probe = np.random.default_rng(0).normal(size=(nh, nw))
        want = host_zoom(probe)
        got = Ah @ probe @ Aw.T
        err = np.abs(want - got).max() / max(1.0, np.abs(want).max())
        if err > 1e-10:
            raise AssertionError(
                f"zoom basis factorization failed for {key}: {err}")
        _PAIR_BASIS_CACHE[key] = (Ah, Aw)
    return _PAIR_BASIS_CACHE[key]


def reflect_window_index(n: int, k: int) -> np.ndarray:
    """[n, k] int32 gather map for a size-k scipy filter window along an
    axis of length n with mode='reflect' ((d c b a | a b c d | d c b a),
    scipy's default boundary). Window offsets follow scipy's even-size
    origin convention: [i - k//2, i + (k-1)//2]."""
    key = (n, k)
    if key not in _REFLECT_INDEX_CACHE:
        idx = np.arange(n)[:, None] + (np.arange(k) - k // 2)[None, :]
        p = np.mod(idx, 2 * n)
        _REFLECT_INDEX_CACHE[key] = np.where(
            p < n, p, 2 * n - 1 - p).astype(np.int32)
    return _REFLECT_INDEX_CACHE[key]


def _masked_median(v, valid):
    """np.nanmedian over the last axis with ``valid`` as the non-NaN mask
    (averages the two middle elements for even valid counts)."""
    s = jnp.sort(jnp.where(valid, v, jnp.inf), axis=-1)
    n = valid.sum(axis=-1)
    lo = jnp.take_along_axis(s, ((n - 1) // 2)[..., None], axis=-1)[..., 0]
    hi = jnp.take_along_axis(s, (n // 2)[..., None], axis=-1)[..., 0]
    return 0.5 * (lo + hi)


def _masked_mean_std(v, valid):
    """np.nanmean / np.nanstd (population, two-pass centered so f32 does
    not cancel catastrophically on bright backgrounds)."""
    n = valid.sum(axis=-1).astype(v.dtype)
    mean = jnp.where(valid, v, 0).sum(axis=-1) / n
    var = jnp.where(valid, (v - mean[..., None]) ** 2, 0).sum(axis=-1) / n
    return mean, jnp.sqrt(var)


@functools.partial(
    jax.jit,
    static_argnames=("box_size", "filter_size", "clip_sigma",
                     "clip_maxiters"))
def stack_background_jit(stack, box_size=10, filter_size=10,
                         clip_sigma=3.0, clip_maxiters=10):
    """SExtractor background maps for a [T, H, W] stack, one jitted
    program (see module docstring). Returns [T, H, W] in the compute
    dtype: float32 for any input except float64, which stays float64
    (exact-decision parity with the f64 host oracle under x64).

    Spec parity (host oracle: pipeline.spots._mesh_background, itself
    proven against the photutils recipe in tests/test_sextractor_numerics):
    pad to a box multiple by edge replication, 3-sigma clip each box
    (median-centered bounds, nanstd spread, <=10 fixpoint iterations),
    SExtractor mode 2.5*median - 1.5*mean with the crowded(|mean-med| >
    0.3*std -> median) and flat(std == 0 -> mean) fallbacks, median-filter
    the mesh, cubic-spline zoom back to full resolution, crop the pad.
    """
    T, H, W = stack.shape
    # f32 is the production compute dtype; f64 inputs (possible only under
    # jax_enable_x64) keep f64 so the hard sigma-clip / crowded-box
    # threshold comparisons make the SAME accept/reject decisions as the
    # f64 host oracle — in f32 a pixel within one ulp of med±3σ can flip,
    # shifting that box's mode by ~noise/N (tolerance-tested either way).
    dt = jnp.float64 if stack.dtype == jnp.float64 else jnp.float32
    x = stack.astype(dt)
    nh = -(-H // box_size)
    nw = -(-W // box_size)
    x = jnp.pad(x, ((0, 0), (0, nh * box_size - H), (0, nw * box_size - W)),
                mode="edge")
    boxes = (x.reshape(T, nh, box_size, nw, box_size)
             .transpose(0, 1, 3, 2, 4)
             .reshape(T, nh * nw, box_size * box_size))

    def clip_once(_, valid):
        med = _masked_median(boxes, valid)
        _, std = _masked_mean_std(boxes, valid)
        keep = ((boxes >= (med - clip_sigma * std)[..., None])
                & (boxes <= (med + clip_sigma * std)[..., None]))
        return valid & keep

    valid = jax.lax.fori_loop(
        0, clip_maxiters, clip_once,
        jnp.ones(boxes.shape, dtype=bool))

    med = _masked_median(boxes, valid)
    mean, std = _masked_mean_std(boxes, valid)
    mode = 2.5 * med - 1.5 * mean
    mode = jnp.where(std == 0, mean,
                     jnp.where(jnp.abs(mean - med) > 0.3 * std, med, mode))
    mesh = mode.reshape(T, nh, nw)

    k = min(filter_size, nh, nw)
    if k > 1:
        ih = jnp.asarray(reflect_window_index(nh, k))
        iw = jnp.asarray(reflect_window_index(nw, k))
        wins = mesh[:, ih, :][:, :, :, iw]          # [T, nh, k, nw, k]
        wins = wins.transpose(0, 1, 3, 2, 4).reshape(T, nh, nw, k * k)
        mesh = jnp.sort(wins, axis=-1)[..., (k * k) // 2]

    Ah_np, Aw_np = pairwise_zoom_bases(nh, nw, box_size)
    Ah = jnp.asarray(Ah_np, dt)
    Aw = jnp.asarray(Aw_np, dt)
    up = jnp.einsum("ia,tab,jb->tij", Ah, mesh, Aw,
                    precision=jax.lax.Precision.HIGHEST)
    return up[:, :H, :W]


def stack_background(stack, box_size=10, filter_size=10, clip_sigma=3.0,
                     clip_maxiters=10, mesh=None):
    """Host-facing SExtractor background estimation.

    Accepts one [H, W] image or a [T, H, W] z/time stack (numpy in any
    camera dtype, or an already-device-resident jax.Array — the latter
    skips the upload). With ``mesh`` the frame axis is sharded over the
    mesh's first axis (frames are independent; no collectives). Returns
    background map(s) shaped like the input, in the kernel's compute
    dtype (float32; float64 for float64 inputs under x64).
    """
    single = (getattr(stack, "ndim", None) == 2)
    if not isinstance(stack, jax.Array):
        stack = np.asarray(stack)
    if single:
        stack = stack[None]
    T = stack.shape[0]
    if mesh is None:
        out = stack_background_jit(
            jnp.asarray(stack), box_size=box_size, filter_size=filter_size,
            clip_sigma=float(clip_sigma), clip_maxiters=int(clip_maxiters))
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = mesh.axis_names[0]
        n_dev = int(mesh.shape[axis])
        pad = (-T) % n_dev
        arr = jnp.asarray(stack)  # one upload; pad reuses the device copy
        if pad:
            # Even shards: replicate the last frame; padded rows are
            # computed redundantly and sliced off below.
            arr = jnp.concatenate(
                [arr, jnp.repeat(arr[-1:], pad, axis=0)], axis=0)
        sharding = NamedSharding(mesh, P(axis, None, None))
        dev = jax.device_put(arr, sharding)
        out = stack_background_jit(
            dev, box_size=box_size, filter_size=filter_size,
            clip_sigma=float(clip_sigma), clip_maxiters=int(clip_maxiters))
        out = out[:T]
    return out[0] if single else out


def subtract_background_stack(stack, box_size=10, filter_size=10,
                              clip_sigma=3.0, clip_maxiters=10, mesh=None):
    """stack - stack_background(stack), device-resident, in the kernel's
    compute dtype.

    Convenience composition for library callers who only want subtracted
    frames. api.Pipeline.run_zstack subtracts INLINE instead (it needs
    the background map separately for ``return_background``); this
    function and that path share stack_background_jit, so the estimator
    spec lives in one place.
    """
    single = (getattr(stack, "ndim", None) == 2)
    if not isinstance(stack, jax.Array):
        stack = jnp.asarray(np.asarray(stack))
    bg = stack_background(stack, box_size=box_size, filter_size=filter_size,
                          clip_sigma=clip_sigma, clip_maxiters=clip_maxiters,
                          mesh=mesh)
    return stack.astype(bg.dtype) - bg

"""Array-native timetrace workflow (the movie front door).

The reference's movie flow (basic_timetrace_script.py -> flexlibrary
TimetraceExperiment, flexlibrary.py:3266-3713) is: detect spots on the
first frame, follow each spot frame-to-frame by luminosity centroid with
an S/N gate (flexlibrary.py:1172-1317), measure a photometry trace per
track, and step-fit every trace.

Device-first redesign: the WHOLE tracking recursion runs as one jitted
``lax.scan`` over the movie — per frame, all live spots' centroid
windows, S/N windows, and gating decisions are batched array ops, so a
T-frame movie costs one device dispatch instead of 2T (the class path's
per-frame batches) or N*T host iterations (the reference's loop).
Photometry then reuses the chunked whole-stack gather kernels, and
step fitting the batched CK + sliding-t + refit + merge chain
(ops/stepfit_batch.py).

Semantic parity with the class path (proven in
tests/test_fast_timetrace.py):
- window origins truncate the (possibly float) prior center like the
  reference's ``int()`` casts (flexlibrary.py:1216-1222),
- candidate acceptance is Spot.__init__'s 5x5 fit (gaussian_fit=None:
  no quirk fallback),
- the S/N gate measures Illumina S/N on the 5x5 slice at the ROUNDED
  centroid; failures fall back to a spot at the prior center's
  Py2-rounded position when that fits, else None,
- a None frame does not kill the track — the walk continues from the
  last accepted spot (flexlibrary.py:1303-1310).
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from ..utils.rounding import py2_round

# Edge mask of a 5x5 slice (the 16 border pixels illumina_s_n reduces
# over) — a host constant, NOT an in-jit scatter.
_EDGE_MASK_5 = np.ones((5, 5), bool)
_EDGE_MASK_5[1:4, 1:4] = False


@functools.partial(jax.jit,
                   static_argnames=("search_radius", "s_n_cutoff"))
def _lc_track_scan(movie, trunc0_h, trunc0_w, round0_h, round0_w,
                   search_radius=3, s_n_cutoff=3.0):
    import jax.numpy as jnp

    T, H, W = movie.shape
    r = search_radius
    d = 2 * r + 1
    movie_f = movie.astype(jnp.float32)

    def gather(img, hs, ws, radius):
        dd = jnp.arange(-radius, radius + 1)
        return img[hs[:, None, None] + dd[None, :, None],
                   ws[:, None, None] + dd[None, None, :]]

    from ..utils.rounding import py2_round_device_i32

    def step(state, img):
        trunc_h, trunc_w, round_h, round_w = state
        in_bounds = ((r <= trunc_h) & (trunc_h < H - r) &
                     (r <= trunc_w) & (trunc_w < W - r))
        th = jnp.clip(trunc_h, r, H - r - 1)
        tw = jnp.clip(trunc_w, r, W - r - 1)
        patches = gather(img, th, tw, r)
        total = jnp.sum(patches.reshape(patches.shape[0], -1), axis=-1)
        # CENTERED index weights: with raw offsets 0..d-1 the f32 moment
        # sum of a bright uint16 window exceeds 2^24 (65535 * 49 * 6 ~
        # 1.9e7) and rounds, so a symmetric blob whose exact centroid is
        # x.5 can flip the Py2 rounding below vs the host's float64
        # center_of_mass. Centered (idx - r in [-r, r]), every partial
        # sum of an integer-valued movie stays under 2^24 at the default
        # search_radius — both moments are then EXACT in f32.
        idx = jnp.arange(d, dtype=jnp.float32) - r
        ch = jnp.sum(patches * idx[None, :, None], axis=(-2, -1)) / total
        cw = jnp.sum(patches * idx[None, None, :], axis=(-2, -1)) / total
        rc_h = py2_round_device_i32(ch + th.astype(jnp.float32))
        rc_w = py2_round_device_i32(cw + tw.astype(jnp.float32))
        cand_fits = ((2 <= rc_h) & (rc_h < H - 2) &
                     (2 <= rc_w) & (rc_w < W - 2))
        # Illumina S/N of the 5x5 slice at the rounded centroid
        # (Spot.illumina_s_n; ops/quality.py math).
        sl = gather(img, jnp.clip(rc_h, 2, H - 3), jnp.clip(rc_w, 2, W - 3),
                    2)
        edge = sl.reshape(sl.shape[0], 25)[:, _EDGE_MASK_5.reshape(25)]
        e_mean = jnp.mean(edge, axis=-1)
        e_std = jnp.std(edge, axis=-1)
        sn = (jnp.max(sl.reshape(sl.shape[0], 25), axis=-1) - e_mean) / e_std
        # NaN S/N (flat slice: e_std == 0 and max == mean, e.g. saturated
        # uint16 regions) KEEPS the candidate, because the host gate is
        # "fall back if s_n < cutoff" (flexlibrary.py:1247) and NaN < x is
        # False — so the gate must be ~(sn < cutoff), not (sn >= cutoff).
        sn_fails = sn < s_n_cutoff
        good = in_bounds & cand_fits & ~sn_fails
        fb_fits = ((2 <= round_h) & (round_h < H - 2) &
                   (2 <= round_w) & (round_w < W - 2))
        fallback = in_bounds & cand_fits & sn_fails & fb_fits
        present = good | fallback
        rec_h = jnp.where(good, rc_h, jnp.where(fallback, round_h, -1))
        rec_w = jnp.where(good, rc_w, jnp.where(fallback, round_w, -1))
        new_state = (jnp.where(present, rec_h, trunc_h),
                     jnp.where(present, rec_w, trunc_w),
                     jnp.where(present, rec_h, round_h),
                     jnp.where(present, rec_w, round_w))
        return new_state, (rec_h, rec_w, present)

    init = (trunc0_h, trunc0_w, round0_h, round0_w)
    _, (rec_h, rec_w, present) = jax.lax.scan(step, init, movie_f[1:])
    return rec_h, rec_w, present


def _initial_centers(h0, w0):
    """Host prep of the float initial centers shared by lc_track and
    lc_track_and_photometry: ``int()`` truncation (reference:
    ``int(spot.h - offset)``) and Py2 rounding happen on HOST in
    float64 — exact. Returns int32 (trunc_h, trunc_w, round_h, round_w)."""
    h0 = np.asarray(h0, np.float64)
    w0 = np.asarray(w0, np.float64)
    trunc_h = np.trunc(h0).astype(np.int32)
    trunc_w = np.trunc(w0).astype(np.int32)
    round_h = np.asarray([py2_round(v) for v in h0], np.int32)
    round_w = np.asarray([py2_round(v) for v in w0], np.int32)
    return trunc_h, trunc_w, round_h, round_w


def lc_track(movie, h0, w0, search_radius=3, s_n_cutoff=3.0, mesh=None):
    """Batched LC tracking over a [T, H, W] movie from float initial
    centers (h0, w0). Returns (rec_h, rec_w, present): [T, N] arrays;
    frame 0 records the truncated initial centers (the positions the
    class path's photometry batching uses for the float-centered
    initial Spots).

    mesh: optional jax.sharding.Mesh — tracks are independent walks, so
    the spot axis shards over the mesh's first axis (the movie
    replicates; SURVEY P2 data parallelism, no collectives). Results
    are bit-equal to the unsharded scan (tested on the 8-device CPU
    mesh)."""
    import jax.numpy as jnp

    trunc0_h, trunc0_w, round0_h, round0_w = _initial_centers(h0, w0)
    N = len(trunc0_h)
    pad = 0
    if mesh is not None and N:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = mesh.axis_names[0]
        n_dev = int(mesh.shape[axis])
        pad = (-N) % n_dev
        if pad:
            # Interior-safe filler walks (sliced off below).
            fill_h = np.full(pad, search_radius + 2, np.int32)
            trunc0_h = np.concatenate([trunc0_h, fill_h])
            trunc0_w = np.concatenate([trunc0_w, fill_h])
            round0_h = np.concatenate([round0_h, fill_h])
            round0_w = np.concatenate([round0_w, fill_h])
        row = NamedSharding(mesh, P(axis))
        dev = lambda x: jax.device_put(x, row)
        # One transfer: device_put straight into the replicated sharding.
        # A host movie uploads exactly once (jnp.asarray first would
        # commit it to device 0 and pay the 30 MB/s link twice); an
        # already-device-resident movie (api.run_timetrace's path) must
        # NOT bounce through np.asarray — that would be a full
        # device->host->device round trip.
        movie_dev = jax.device_put(
            movie if isinstance(movie, jax.Array) else np.asarray(movie),
            NamedSharding(mesh, P()))
    else:
        dev = jnp.asarray
        movie_dev = jnp.asarray(movie)
    rec_h, rec_w, present = _lc_track_scan(
        movie_dev, dev(trunc0_h), dev(trunc0_w),
        dev(round0_h), dev(round0_w),
        search_radius=search_radius, s_n_cutoff=float(s_n_cutoff))
    rec_h = np.concatenate([trunc0_h[None], np.asarray(rec_h)])[:, :N]
    rec_w = np.concatenate([trunc0_w[None], np.asarray(rec_w)])[:, :N]
    present = np.concatenate([np.ones((1, N + pad), bool),
                              np.asarray(present)])[:, :N]
    return rec_h, rec_w, present


@functools.partial(jax.jit, static_argnames=("radius", "bucket", "H", "W"))
def _positions_for_photometry(t0h, t0w, rec_h, rec_w, present,
                              radius, bucket, H, W):
    """Device-side position prep for the fused track -> photometry path:
    prepend the frame-0 row, clip every position into the gather-interior
    box, and flatten to (bucket,)-padded index arrays for the shared
    photometry kernel (fast_experiment._get_photometry_kernel). Clipped
    out-of-window and absent positions are overridden on host afterwards
    (exact edge fallbacks / zeros), so the clip only has to keep the
    gather in bounds."""
    import jax.numpy as jnp

    Tm1, N = rec_h.shape
    T = Tm1 + 1
    full_h = jnp.concatenate([t0h[None], rec_h])
    full_w = jnp.concatenate([t0w[None], rec_w])
    present_full = jnp.concatenate([jnp.ones((1, N), bool), present])
    hc = jnp.clip(full_h, radius, H - 1 - radius).reshape(-1)
    wc = jnp.clip(full_w, radius, W - 1 - radius).reshape(-1)
    img_id = jnp.repeat(jnp.arange(T, dtype=jnp.int32), N)
    pad = bucket - T * N
    hc = jnp.concatenate([hc, jnp.full((pad,), radius, hc.dtype)])
    wc = jnp.concatenate([wc, jnp.full((pad,), radius, wc.dtype)])
    img_id = jnp.concatenate([img_id, jnp.zeros((pad,), jnp.int32)])
    return (full_h, full_w, present_full, hc.astype(jnp.int32),
            wc.astype(jnp.int32), img_id)


def lc_track_and_photometry(movie_dev, h0, w0, method, search_radius=3,
                            s_n_cutoff=3.0, photometry_radius=9,
                            photometry_brim=6, photometry_min=None,
                            photometry_top=1, chunk=65536):
    """Fused movie path: LC tracking and whole-movie photometry with NO
    host round trip between them.

    The two-step path (lc_track -> timetrace_photometries) fetches the
    tracked positions, builds gather indices on host, and re-uploads
    them — three serialized link round trips that dominate the movie
    front door on remote-device links. Here the scan's device outputs
    feed a device-side position prep (_positions_for_photometry) and
    then the SAME chunked photometry kernel the experiment path uses
    (fast_experiment._get_photometry_kernel — so interior values are
    bit-identical to timetrace_photometries'), and all four results are
    fetched with overlapping async copies.

    Only the window metrics (mexican_hat / simple / maximum) take this
    path; callers fall back to the two-step functions for the others.
    Movies with T*N > chunk dispatch the photometry kernel in
    chunk-sized slices (one compile, slices are static shapes).

    Returns (rec_h, rec_w, present, photometries): the [T, N] host
    arrays of lc_track plus the (N, T) float64 photometry matrix of
    timetrace_photometries (None frames 0, exact host edge fallbacks,
    photometry_min applied).
    """
    import jax.numpy as jnp

    from ..ops import photometry as phot_ops
    from .fast_experiment import _get_photometry_kernel
    from ..utils.dispatch import pow2_bucket

    T, H, W = movie_dev.shape
    win_r = {"mexican_hat": photometry_radius, "simple": 2,
             "maximum": 5}[method]
    trunc0_h, trunc0_w, round0_h, round0_w = _initial_centers(h0, w0)
    N = len(trunc0_h)

    t0h = jnp.asarray(trunc0_h)
    t0w = jnp.asarray(trunc0_w)
    rec_h_d, rec_w_d, present_d = _lc_track_scan(
        movie_dev, t0h, t0w, jnp.asarray(round0_h), jnp.asarray(round0_w),
        search_radius=search_radius, s_n_cutoff=float(s_n_cutoff))
    total = T * N
    # One pow2 bucket for a single dispatch; a whole multiple of chunk
    # when the movie needs several (each slice compiles once at (chunk,)).
    bucket = (pow2_bucket(total, chunk) if total <= chunk
              else -(-total // chunk) * chunk)
    full_h, full_w, present_full, hc, wc, img_id = _positions_for_photometry(
        t0h, t0w, rec_h_d, rec_w_d, present_d, win_r, bucket, H, W)
    kern = _get_photometry_kernel(method, win_r, photometry_brim,
                                  photometry_top)
    if bucket <= chunk:
        phot_d = kern(movie_dev, img_id, hc, wc)
    else:
        phot_d = jnp.concatenate([
            kern(movie_dev, img_id[i:i + chunk], hc[i:i + chunk],
                 wc[i:i + chunk])
            for i in range(0, bucket, chunk)])
    for arr in (full_h, full_w, present_full, phot_d):
        arr.copy_to_host_async()
    from ..utils import profiling
    profiling.bump("ledger/step_dispatches")
    profiling.bump("ledger/result_fetches", 4)
    rec_h = np.asarray(full_h)
    rec_w = np.asarray(full_w)
    present = np.asarray(present_full)
    vals = np.asarray(phot_d)[:T * N].astype(np.float64).reshape(T, N)
    profiling.bump("ledger/fetch_bytes",
                   int(rec_h.nbytes + rec_w.nbytes + present.nbytes +
                       np.asarray(phot_d).nbytes))

    interior = ((rec_h >= win_r) & (rec_h < H - win_r) &
                (rec_w >= win_r) & (rec_w < W - win_r))
    out = np.where((present & interior).T, vals.T, 0.0)
    # Present-but-edge positions: the exact host truncation fallbacks
    # (same semantics as timetrace_photometries' non-interior loop).
    frame_cache = {}
    for f, n in zip(*np.nonzero(present & ~interior)):
        if f not in frame_cache:
            frame_cache[f] = np.asarray(movie_dev[f])
        img = frame_cache[f]
        h, w = int(rec_h[f, n]), int(rec_w[f, n])
        if method == "mexican_hat":
            v = phot_ops.mexican_hat_host(img, h, w,
                                          brim_size=photometry_brim,
                                          radius=win_r)
        elif method == "simple":
            v = phot_ops.simple_host(img, h, w, radius=win_r)
        else:
            v = phot_ops.maximum_host(img, h, w, radius=win_r)
        out[n, f] = v
    if photometry_min is not None:
        out = np.maximum(out, photometry_min)
    return rec_h, rec_w, present, out


def timetrace_photometries(movie, rec_h, rec_w, present, method,
                           initial_fits=None, photometry_radius=9,
                           photometry_brim=6, photometry_min=None,
                           aperture_radius=3, box_size=10, filter_size=10,
                           chunk=65536):
    """(N, T) photometry traces at the tracked positions.

    None frames are 0 (Trace.photometries, flexlibrary.py:1339-1346);
    interior positions batch on device; edge positions use the exact
    host truncation fallbacks; the fit-product metrics take the initial
    frame's fit values and the fit-less defaults afterwards (tracked
    Spots carry gaussian_fit=None). photometry_min rounds everything up
    afterwards, like Trace.photometries.
    """
    from ..ops import photometry as phot_ops
    from .fast_experiment import _dispatch_photometry

    T, N = rec_h.shape
    H, W = movie.shape[1:]
    out = np.zeros((N, T), np.float64)
    if method in ("gaussian_volume", "sigmas"):
        default = 0.0 if method == "gaussian_volume" else -1e9
        out[:, :] = np.where(present.T, default, 0.0)
        if initial_fits is not None:
            for i, gf in enumerate(initial_fits):
                if gf is None:
                    out[i, 0] = default
                elif method == "gaussian_volume":
                    out[i, 0] = 1e6 * gf[3] * gf[4] * gf[5]
                else:
                    out[i, 0] = 1e6 * gf[4] * gf[5]
    elif method == "sextractor":
        from .spots import sextractor_aperture_sums

        movie_np = np.asarray(movie)
        for f in range(T):
            idx = np.nonzero(present[f])[0]
            if idx.size == 0:
                continue
            out[idx, f] = sextractor_aperture_sums(
                movie_np[f], rec_h[f, idx], rec_w[f, idx],
                aperture_radius, box_size, filter_size)
    else:
        win_r = {"mexican_hat": photometry_radius, "simple": 2,
                 "maximum": 5}[method]
        f_idx, n_idx = np.nonzero(present)
        hs = rec_h[f_idx, n_idx]
        ws = rec_w[f_idx, n_idx]
        interior = ((hs >= win_r) & (hs < H - win_r) &
                    (ws >= win_r) & (ws < W - win_r))
        if interior.any():
            # [T, H, W] -> [T, 1, H, W]: one "cycle" per frame, so the
            # whole-stack gather kernel's img_id is just the frame index.
            vals = _dispatch_photometry(
                movie.reshape(T, 1, H, W),
                f_idx[interior], hs[interior], ws[interior], method,
                win_r, photometry_brim, 1, chunk)
            out[n_idx[interior], f_idx[interior]] = vals
        # Fetch ONLY the frames that have edge positions (the fused path's
        # pattern): np.asarray(movie) would pull the entire movie across
        # the link to read a handful of border patches.
        frame_cache = {}
        for k in np.nonzero(~interior)[0]:
            f = int(f_idx[k])
            if f not in frame_cache:
                frame_cache[f] = np.asarray(movie[f])
            img = frame_cache[f]
            h, w = int(hs[k]), int(ws[k])
            if method == "mexican_hat":
                v = phot_ops.mexican_hat_host(img, h, w,
                                              brim_size=photometry_brim,
                                              radius=win_r)
            elif method == "simple":
                v = phot_ops.simple_host(img, h, w, radius=win_r)
            else:
                v = phot_ops.maximum_host(img, h, w, radius=win_r)
            out[n_idx[k], f_idx[k]] = v
    if photometry_min is not None:
        out = np.maximum(out, photometry_min)
    return out

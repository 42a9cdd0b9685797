"""Device-mesh parallelism for whole-experiment processing.

The reference scales with single-node multiprocessing.Pool fan-outs,
load-balanced by candidate counts (/root/reference/pflib.py:1000-1111 and
friends — SURVEY.md section 2.4). Here all of those collapse into sharded
array programs: one experiment is a ``f32[fields, cycles, H, W]`` stack,
sharded across a device mesh on two axes:

- ``data``: fields — embarrassingly parallel, no cross-field communication;
- ``model``: extra parallelism for the detection + LM fit, the FLOP-heavy
  stage. On a 1-field-shard mesh GSPMD shards the candidate bucket axis
  over 'model'; on multi-chip data meshes the flattened (field, cycle)
  image batch itself shards over BOTH axes (each chip detects a distinct
  image subset), so 'model' devices never recompute another chip's fits.
  (The reference's load-balancer exists only because of MIMD raggedness;
  under SIMD padding every field costs the same.)

XLA inserts the (minimal) collectives; the only cross-device data motion is
the resharding around the fit stage and the final gather of fitted
parameters.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # compiles happen below; see utils/jaxcache


def make_mesh(n_devices=None, data_axis=None, model_axis=None):
    """Create a ('data', 'model') mesh over the available devices.

    By default all devices go to 'data' (fields axis) — the right layout for
    many-field experiments. Pass explicit axis sizes for other splits.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if data_axis is None and model_axis is None:
        data_axis, model_axis = n_devices, 1
    elif data_axis is None:
        data_axis = n_devices // model_axis
    elif model_axis is None:
        model_axis = n_devices // data_axis
    if data_axis * model_axis != n_devices:
        raise ValueError("data_axis * model_axis must equal n_devices")
    return Mesh(devices.reshape(data_axis, model_axis), ("data", "model"))


def shard_fields(stack, mesh):
    """Place a [fields, ...] array with the fields axis sharded on 'data'."""
    spec = P("data", *([None] * (stack.ndim - 1)))
    return jax.device_put(stack, NamedSharding(mesh, spec))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "median_filter_size", "c_std", "r_2_threshold",
                     "consolidation_radius", "max_candidates", "max_spots",
                     "num_iters", "theta_starts",
                     "upsample_factor", "photometry_method",
                     "photometry_radius", "photometry_brim",
                     "photometry_min"))
def experiment_step_sharded(stack, mesh, median_filter_size=5, c_std=2.0,
                            r_2_threshold=0.7, consolidation_radius=4.0,
                            max_candidates=256, max_spots=None,
                            num_iters=30, theta_starts=1,
                            upsample_factor=20,
                            photometry_method="mexican_hat",
                            photometry_radius=9, photometry_brim=6,
                            photometry_min=None):
    """One full experiment step over a [fields, cycles, H, W] stack.

    Stages (all inside one jitted program, partitioned over the mesh):
      1. registration: phase-correlate consecutive cycles per field
         (upsample_factor default 20 = the reference experiment
         configuration, flexlibrary.py:1735-1739),
      2. detection + batched LM PSF fit on every (field, cycle) image
         (median_filter_size/c_std/r_2_threshold/consolidation_radius/
         theta_starts plumb straight into models.detect.detect_and_fit_batch),
      3. compaction of surviving spots into a [max_spots] bucket,
      4. photometry at the surviving spots only (photometry_method one of
         'mexican_hat', 'simple', 'maximum', 'gaussian_volume', 'sigmas';
         a photometry_min floor is applied when set, flexlibrary.py:3471
         — with the reference's max(photometry_min, rp) semantics, so a
         NaN photometry floors to photometry_min).

    Multi-chip precondition: when the mesh's 'data' axis has more than one
    device, F*C must divide evenly by the data-axis size (by data*model
    when both axes are multi-device and F*C permits) — api.Pipeline pads
    the fields axis for callers; direct callers must pad themselves.

    Returns a dict of sharded arrays:
      offsets_h/w:   [F, C] per-cycle offsets
      params:        [F, C, K, 7] PSF fits
      keep:          [F, C, K] surviving-fit mask
      r2:            [F, C, K] fit R^2 (the keep gate's score)
      center_h/w:    [F, C, K] fitted centers in image coordinates
      cand_count:    [F, C] true candidate count (> max_candidates means
                     the weakest candidates were dropped)
      spot_h/w:      [F, C, S] compacted surviving-spot centers (float)
      spot_cand_idx: [F, C, S] int32 candidate index of each bucket slot
      spot_valid:    [F, C, S]
      spot_rh/rw:    [F, C, S] int16 Py2-rounded centers (the
                     transfer-lean tracking identity; bit-matched to the
                     host float64 py2_round)
      spot_state:    [F, C, S] int8: 0 empty, 1 valid-but-Spot-rejected,
                     2 tracked, 3 wild (non-finite or non-int16
                     center on a kept fit — consumers must raise, like
                     the reference's int(py2_round(nan)))
      spot_cand_c:   [F, C, S] spot_cand_idx narrowed to int16 when
                     max_candidates permits (the compact download)
      spot_count:    [F, C] surviving-fit count (> max_spots means the
                     lowest-R^2 survivors were dropped from the bucket —
                     never silently: check spot_overflow)
      spot_overflow: [F, C] bool, spot_count > max_spots
      photometry:    [F, C, S] photometries at the kept spots (0 in
                     empty slots)
      photometry_interior: [F, C, S] bool — False where the spot sits
                     within the photometry window radius of the frame
                     border, so the static-shape kernel measured a
                     CLIPPED (shifted) window instead of the
                     reference's in-place truncation; re-measure those
                     on host (ops.photometry.*_host) if exact edge
                     values matter
    """
    from ..models.detect import detect_and_fit_batch
    from ..ops.registration import phase_correlate_stack
    from ..ops import photometry as phot_ops

    F, C, H, W = stack.shape
    data_spec = NamedSharding(mesh, P("data", None, None, None))
    stack = jax.lax.with_sharding_constraint(stack, data_spec)
    # Accept raw detector dtypes (uint16 camera frames) and cast on device:
    # uploading 16-bit pixels halves the host->device transfer. The cast
    # fuses into the first consumer.
    if stack.dtype != jnp.float32:
        stack = stack.astype(jnp.float32)

    # 1. Registration: vmap over fields; each field registers its C cycles.
    off_h, off_w, _, _ = jax.vmap(
        lambda frames: phase_correlate_stack(frames, upsample_factor))(stack)

    # 2. Detection + fit, batched over all (field, cycle) images in ONE
    # lane-major LM call. On multi-chip meshes detection runs under
    # shard_map with the flattened image batch sharded over BOTH mesh
    # axes when F*C divides evenly (each chip fits a DISTINCT image
    # subset — a 'model'-axis device never recomputes another chip's
    # detection), falling back to 'data'-only sharding (images
    # replicated over 'model') otherwise. On a single-data-shard mesh
    # GSPMD shards the candidate bucket axis of the fit over 'model'
    # instead.
    imgs = stack.reshape(F * C, H, W)
    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]

    def detect_shard(im):
        return detect_and_fit_batch(
            im, median_filter_size=median_filter_size, c_std=c_std,
            r_2_threshold=r_2_threshold,
            consolidation_radius=consolidation_radius,
            max_candidates=max_candidates, num_iters=num_iters,
            theta_starts=theta_starts)

    if n_data > 1:
        import inspect
        try:
            from jax import shard_map
        except ImportError:  # older jax
            from jax.experimental.shard_map import shard_map
        # jax >= 0.8 renamed check_rep -> check_vma.
        _kw = ("check_vma" if "check_vma" in
               inspect.signature(shard_map).parameters else "check_rep")

        axes = (("data", "model")
                if n_model > 1 and (F * C) % (n_data * n_model) == 0
                else "data")
        example = jax.eval_shape(detect_shard, imgs)
        out_specs = jax.tree_util.tree_map(
            lambda s: P(*([axes] + [None] * (len(s.shape) - 1))), example)
        res = shard_map(detect_shard, mesh=mesh,
                        in_specs=P(axes, None, None),
                        out_specs=out_specs, **{_kw: False})(imgs)
    else:
        res = detect_shard(imgs)
    params = jax.lax.with_sharding_constraint(
        res.params.reshape(F, C, max_candidates, 7),
        NamedSharding(mesh, P("data", None, "model", None)))
    keep = res.keep.reshape(F, C, max_candidates)
    ch = res.center_h.reshape(F, C, max_candidates)
    cw = res.center_w.reshape(F, C, max_candidates)

    # 3. Compact surviving spots into a small static bucket so photometry
    # only touches real spots (typically ~10% of candidates). Overflow is
    # REPORTED (spot_count/spot_overflow), mirroring the candidate stage's
    # cand_count contract — no silent truncation.
    if max_spots is None:
        # Never above max_candidates: top_k(k > n) is an invalid program.
        max_spots = min(max_candidates, 512)
    elif max_spots > max_candidates:
        raise ValueError(
            f"max_spots={max_spots} exceeds max_candidates="
            f"{max_candidates}: the spot bucket compacts the candidate "
            "bucket, so it can never hold more entries")
    keep_flat = keep.reshape(F * C, max_candidates)
    spot_count = jnp.sum(keep_flat, axis=-1, dtype=jnp.int32)
    # NaN R^2 fits are KEPT by the reference's gate (saturated-flat
    # patches; models/detect.py) — rank them below every finite R^2 in
    # the bucket (a deterministic order; NaN inside top_k would both
    # poison the sort and read as invalid under the > -inf test).
    r2_flat = res.r2.reshape(F * C, -1)
    r2_rank = jnp.where(jnp.isnan(r2_flat), -jnp.inf, r2_flat)
    score = jnp.where(keep_flat, jnp.maximum(r2_rank, -1e30), -jnp.inf)
    top_score, top_idx = jax.lax.top_k(score, max_spots)
    spot_valid = top_score > -jnp.inf
    ch_flat = res.center_h.reshape(F * C, -1)
    cw_flat = res.center_w.reshape(F * C, -1)
    sh = jnp.take_along_axis(ch_flat, top_idx, axis=-1)
    sw = jnp.take_along_axis(cw_flat, top_idx, axis=-1)

    # Transfer-lean bucket encodings, computed on device so the host
    # tracking layer can skip the float32 center downloads entirely:
    # Py2-rounded int16 centers, int16 candidate indices, and a
    # tri-state validity that folds in the Spot.__init__ box quirk.
    # py2_round_device_i32 rounds halves AWAY FROM ZERO, bit-for-bit the
    # host float64 py2_round of the same float32 value (see its docs).
    from ..utils.rounding import py2_round_device_i32
    rh_i = py2_round_device_i32(sh)
    rw_i = py2_round_device_i32(sw)
    # Spot.__init__ validity (fast_experiment._spot_lists semantics):
    # plain 5x5 box on the ROUNDED center, or the reference's buggy
    # fallback that admits an out-of-box spot unless (h_0 outside AND
    # w_0 inside) — evaluated on the FLOAT centers, f32-exact.
    r_box = 2
    ok_plain = ((rh_i >= r_box) & (rh_i + r_box < H) &
                (rw_i >= r_box) & (rw_i + r_box < W))
    in_h = (sh >= r_box) & (sh < H - r_box)
    in_w = (sw >= r_box) & (sw < W - r_box)
    quirk_keep = ok_plain | ~(~in_h & in_w)
    # 0 = empty bucket slot, 1 = valid but Spot-rejected, 2 = tracked,
    # 3 = wild: a kept fit whose center is non-finite or outside int16
    # range. int(py2_round(nan)) raises in the reference; narrowing such
    # a center to int16 would instead WRAP it into a valid-looking
    # coordinate (NaN -> i32 INT_MIN -> i16 0), silently tracking a
    # phantom spot at (0, 0). Consumers of the compact layout must raise
    # on state 3 (fast_experiment._spot_lists does).
    wild = (~(jnp.isfinite(sh) & jnp.isfinite(sw)) |
            (jnp.abs(rh_i) > 0x7FFF) | (jnp.abs(rw_i) > 0x7FFF))
    rh_i = jnp.where(wild, 0, rh_i)
    rw_i = jnp.where(wild, 0, rw_i)
    spot_state = (spot_valid.astype(jnp.int8) *
                  (1 + quirk_keep.astype(jnp.int8)))
    spot_state = jnp.where(wild & spot_valid, jnp.int8(3), spot_state)
    cand_dtype = jnp.int16 if max_candidates <= 0x7FFF else jnp.int32

    # 4. Photometry at the (rounded) kept-spot centers.
    if photometry_method not in ("mexican_hat", "simple", "maximum",
                                 "gaussian_volume", "sigmas"):
        raise ValueError("unknown photometry_method: " +
                         repr(photometry_method))
    if photometry_method in ("gaussian_volume", "sigmas"):
        # Pure fit-parameter products (flexlibrary.py:212-241) — no image
        # access needed: A * sigma_h * sigma_w * 1e6 (gaussian_volume) or
        # sigma_h * sigma_w * 1e6 (sigmas).
        p_flat = res.params.reshape(F * C, max_candidates, 7)
        pk = jax.vmap(lambda p, i: jnp.take(p, i, axis=0))(p_flat, top_idx)
        # Multiplication order IS the reference's left-to-right
        # float(scaling)*gf[3]*gf[4]*gf[5] / *gf[4]*gf[5]
        # (flexlibrary.py:212-241): FP multiply is not reassociation-
        # safe, and the host paths use the same grouping.
        if photometry_method == "gaussian_volume":
            phot = 1e6 * pk[..., 1] * pk[..., 4] * pk[..., 5]
        else:
            phot = 1e6 * pk[..., 4] * pk[..., 5]
        phot_interior = jnp.ones(phot.shape, bool)
    else:
        r = {"mexican_hat": photometry_radius, "simple": 2,
             "maximum": 5}[photometry_method]
        # The exact Py2-rounded centers (rh_i/rw_i above) keep the
        # bucket photometry measured at the SAME integer pixel the
        # tracking layer assigns the spot (utils.rounding.py2_round of
        # spot_h/spot_w), letting run_experiment reuse these values for
        # detected frames instead of re-gathering patches
        # (flexlibrary.py:90-101 spot identity).
        rch = jnp.clip(rh_i, r, H - r - 1)
        rcw = jnp.clip(rw_i, r, W - r - 1)
        # Static shapes force the clip, so a kept spot within r of the
        # border is measured at a SHIFTED window center — unlike the
        # reference, which truncates the window in place
        # (flexlibrary.py:172-210). Never silently: photometry_interior
        # marks which bucket values are true-center measurements.
        # (run_experiment discards such trace positions via its own
        # window check and re-measures with the exact host fallbacks.)
        phot_interior = (rch == rh_i) & (rcw == rw_i)

        if photometry_method == "mexican_hat":
            def phot_one(img, hs, ws):
                return phot_ops.mexican_hat_batch(
                    img, hs, ws, brim_size=photometry_brim,
                    radius=photometry_radius)
        elif photometry_method == "simple":
            def phot_one(img, hs, ws):
                return phot_ops.simple_batch(img, hs, ws, radius=2)
        else:  # "maximum" — the whitelist above already validated
            def phot_one(img, hs, ws):
                return phot_ops.maximum_batch(img, hs, ws, radius=5)
        phot = jax.vmap(phot_one)(imgs, rch, rcw)
    if photometry_min is not None:
        # The reference floors via max(photometry_min, rp)
        # (flexlibrary.py:1375-1376): Python max returns photometry_min
        # whenever rp > photometry_min is False — INCLUDING rp = NaN.
        # jnp.maximum would propagate the NaN instead.
        phot = jnp.where(phot > photometry_min, phot, photometry_min)
    # Zero empty bucket slots with a select, not a multiply: NaN * 0 is
    # NaN under IEEE (the CPU backend), leaking fit garbage into slots
    # the contract says are zeroed.
    phot = jnp.where(spot_valid.reshape(F, C, -1),
                     phot.reshape(F, C, max_spots), 0.0)

    return {
        "offsets_h": off_h, "offsets_w": off_w,
        "params": params, "keep": keep,
        "r2": res.r2.reshape(F, C, max_candidates),
        "center_h": ch, "center_w": cw,
        "cand_count": res.cand_count.reshape(F, C),
        "spot_h": sh.reshape(F, C, max_spots),
        "spot_w": sw.reshape(F, C, max_spots),
        "spot_cand_idx": top_idx.reshape(F, C, max_spots),
        "spot_valid": spot_valid.reshape(F, C, max_spots),
        "spot_rh": rh_i.astype(jnp.int16).reshape(F, C, max_spots),
        "spot_rw": rw_i.astype(jnp.int16).reshape(F, C, max_spots),
        "spot_state": spot_state.reshape(F, C, max_spots),
        "spot_cand_c": top_idx.astype(cand_dtype).reshape(F, C, max_spots),
        "spot_count": spot_count.reshape(F, C),
        "spot_overflow": (spot_count > max_spots).reshape(F, C),
        "photometry": phot,
        "photometry_interior": phot_interior.reshape(F, C, max_spots),
    }

"""High-level API: the one-stop facade over the framework.

The compat shims (pflib/flexlibrary/MCsimlib/...) give reference users their
exact old surface; this module is the redesigned front door. One object wires
together the sharded compute step (parallel/mesh.py), typed configs
(config.py), the content-hash artifact store (utils/checkpoint.py), and the
stage profiler (utils/profiling.py):

    from fluorosequencingimageanalysis_tpu.api import Pipeline
    pipe = Pipeline()                          # default config, full mesh
    out = pipe.run_stack(stack)                # [F, C, H, W] -> arrays
    fits = pipe.stepfit(photometries)          # (N, T) -> plateaus
    signals, *_ = pipe.fluor_counts("tracks.csv", beta=30000, beta_sigma=0.2)

Everything returns plain numpy on host; device placement, sharding, and
jit caching are internal.
"""

from __future__ import annotations

import logging

import numpy as np

from .config import PipelineConfig

# Dtypes the device step accepts natively: float32, plus raw camera
# integer dtypes which upload as-is (half the bytes of float32 for uint16)
# and cast on device. Anything else pre-casts to float32 on host.
_NATIVE_STACK_DTYPES = ("float32", "uint8", "uint16", "int16", "int32")


_SESSION_MESH = object()  # lazy "use the session mesh" default sentinel


def _normalize_stack(stack):
    """Host-side dtype normalization for an image stack (see
    _NATIVE_STACK_DTYPES); jax.Arrays pass through untouched."""
    import jax

    if isinstance(stack, jax.Array):
        return stack
    stack = np.asarray(stack)
    if stack.dtype.name not in _NATIVE_STACK_DTYPES:
        stack = stack.astype(np.float32)
    return stack


class Pipeline:
    """Config-driven, mesh-aware, optionally artifact-cached pipeline."""

    def __init__(self, config: PipelineConfig | None = None, mesh=None,
                 store=None, profile: bool = False):
        """
        Arguments:
            config: PipelineConfig (defaults mirror the reference's).
            mesh: a jax.sharding.Mesh, or None for all local devices on
                the 'data' axis.
            store: utils.checkpoint.ArtifactStore for run caching, or None.
            profile: record stage timings into utils.profiling's registry.
        """
        self.config = config if config is not None else PipelineConfig()
        self._mesh = mesh
        self.store = store
        self.profile = profile

    @property
    def mesh(self):
        if self._mesh is None:
            from .parallel.mesh import make_mesh
            self._mesh = make_mesh()
        return self._mesh

    def _stage(self, name):
        if self.profile:
            from .utils.profiling import stage
            return stage(name)
        import contextlib
        return contextlib.nullcontext()

    def _device_phot_method(self):
        """Effective device-bucket photometry method for the grouped /
        delegated paths: sextractor measures host-side on background-
        subtracted images, so the device bucket carries the (free)
        sigmas fit product instead of making the device step raise."""
        m = self.config.photometry.method
        return "sigmas" if m == "sextractor" else m

    def _run_stack_key(self, stack, stack_key, mc, max_spots, keys,
                       device_method, photometry_min="config"):
        """The shared run_stack/_stack_step_groups store key, returned as
        (key, stack_key) so callers keep the (possibly just-computed)
        stack hash instead of re-fetching the stack to rehash it. The
        effective device-bucket method is part of the key: the two paths
        intentionally share entries, and a direct sextractor call
        (which raises) must never hit the sigmas-substituted entry the
        groups path writes."""
        from .utils.checkpoint import content_key
        if stack_key is None:
            stack_key = content_key(np.asarray(stack))
        return content_key("run_stack", stack_key, self.config.asdict(),
                           mc, max_spots,
                           sorted(keys) if keys is not None else None,
                           device_method, photometry_min), stack_key

    # -- imaging ------------------------------------------------------------

    def run_stack(self, stack, max_candidates=None, max_spots=None,
                  keys=None, stack_key=None, photometry_method=None,
                  photometry_min="config"):
        """Full align + detect + fit + photometry over a [F, C, H, W] stack.

        Returns a dict of host numpy arrays (offsets, params, keep masks,
        spot centers, photometry) — see
        parallel.mesh.experiment_step_sharded for the schema. Cached in the
        artifact store (keyed by stack content + config) when one is set.

        ``stack`` may be a numpy array or an already-device-resident
        jax.Array — the latter skips the host->device upload
        (run_experiment uploads once and shares the buffer with the
        photometry stage). Integer dtypes (raw uint16
        camera frames) upload as-is and are cast to float32 on device —
        half the transfer of a pre-cast float stack.

        ``keys``: optional iterable of output names to fetch; other
        outputs are neither transferred to host nor returned (the
        [F, C, max_candidates] fit arrays dominate the device->host
        transfer when only the compacted spots are needed).

        ``stack_key``: optional precomputed content hash of the stack
        (utils.checkpoint.content_key of the host array). With an
        artifact store set and a device-resident ``stack``, providing it
        avoids pulling the whole stack back to host just to hash it.

        ``photometry_method``: override of config.photometry.method for
        the device bucket (run_experiment's sextractor flow passes
        "sigmas" here — sextractor itself measures host-side and the
        device step would reject it). Direct calls with a sextractor
        config and no override keep the device step's loud ValueError
        rather than silently returning fit products labeled
        "photometry".

        ``photometry_min``: override of config.photometry.photometry_min
        for the device bucket. run_experiment passes None: the
        reference's track-photometries CSV is never floored
        (flexlibrary.py:2848-2866 — photometry_min belongs to the
        Trace.photometries/stepfit surface), so experiment rows must
        come from an unfloored bucket.
        """
        import jax
        import jax.numpy as jnp
        from .parallel.mesh import experiment_step_sharded, shard_fields

        stack = _normalize_stack(stack)
        if stack.ndim != 4 or stack.shape[0] == 0:
            raise ValueError("stack must be a non-empty [fields, cycles, "
                             f"H, W] array (got shape {stack.shape})")
        if keys is not None:
            # Materialize once: a one-shot iterable would be exhausted by
            # the store key's sorted(keys) and then filter out EVERY
            # output in compute(), caching an empty dict for this key.
            keys = tuple(keys)
        det = self.config.detect
        reg = self.config.registration
        phot = self.config.photometry
        if photometry_min == "config":
            photometry_min = phot.photometry_min
        mc = max_candidates if max_candidates is not None \
            else det.max_candidates

        def compute():
            with self._stage("api/run_stack"):
                mesh = self.mesh
                # Pad the fields axis up to a multiple of the data-axis size
                # (sharding needs even shards); padding replicates the last
                # field and is sliced off the outputs below.
                F = stack.shape[0]
                n_data = mesh.shape["data"]
                pad = (-F) % n_data
                xp = jnp if isinstance(stack, jax.Array) else np
                padded = stack if pad == 0 else xp.concatenate(
                    [stack, xp.repeat(stack[-1:], pad, axis=0)])
                x = shard_fields(jnp.asarray(padded), mesh)
                with mesh:
                    out = experiment_step_sharded(
                        x, mesh,
                        median_filter_size=det.median_filter_size,
                        c_std=det.c_std,
                        r_2_threshold=det.r_2_threshold,
                        consolidation_radius=det.consolidation_radius,
                        max_candidates=mc, max_spots=max_spots,
                        num_iters=det.num_iters,
                        theta_starts=det.theta_starts,
                        upsample_factor=reg.upsample_factor,
                        photometry_method=(photometry_method
                                           if photometry_method is not None
                                           else phot.method),
                        photometry_radius=phot.radius,
                        photometry_brim=phot.brim_size,
                        photometry_min=photometry_min)
                return {k: np.asarray(v)[:F] for k, v in out.items()
                        if keys is None or k in keys}

        if self.store is not None:
            key, stack_key = self._run_stack_key(
                stack, stack_key, mc, max_spots, keys,
                photometry_method if photometry_method is not None
                else phot.method, photometry_min)
            return self.store.get_or_compute(key, compute,
                                             meta={"stage": "run_stack"})
        return compute()

    def _stack_step_groups(self, stack, keys, max_candidates=None,
                           max_spots=None, stack_key=None,
                           group_fields=None, dispatch="eager", pack=False):
        """Generator form of run_stack: the host->device upload is split
        into field groups and EVERYTHING is dispatched up front (upload
        k+1 is in flight while the step on group k computes); groups are
        then yielded in order as ``(out_group, device_group, lo)``,
        fetching each group's outputs only at yield time — so the
        caller's host work on group k overlaps the transfer/compute of
        groups k+1..n. On a bandwidth-limited link the whole experiment
        collapses to ~max(total transfer, total compute + host work).

        out_group holds host arrays sliced to the group's true field
        count; device_group is the device-resident (padded) [g, C, H, W]
        slice for downstream kernels to reuse. With an artifact store
        the concatenated outputs are cached under the SAME key as
        run_stack (a hit yields one (full_out, None, 0) tuple).
        """
        import jax
        import jax.numpy as jnp
        from .parallel.mesh import experiment_step_sharded, shard_fields

        det = self.config.detect
        reg = self.config.registration
        phot = self.config.photometry
        mc = max_candidates if max_candidates is not None \
            else det.max_candidates
        keys = tuple(keys) if keys is not None else None

        device_method = self._device_phot_method()
        key = None
        if self.store is not None:
            key, stack_key = self._run_stack_key(stack, stack_key, mc,
                                                 max_spots, keys,
                                                 device_method, None)
            if self.store.exists(key):
                yield self.store.load(key), None, 0
                return

        if isinstance(stack, jax.Array):  # already uploaded: nothing to
            out = self.run_stack(stack, max_candidates=max_candidates,  # overlap
                                 max_spots=max_spots, keys=keys,
                                 stack_key=stack_key,
                                 photometry_method=device_method,
                                 photometry_min=None)
            yield out, stack, 0
            return

        with self._stage("api/run_stack"):
            mesh = self.mesh
            n_data = mesh.shape["data"]
            F = stack.shape[0]
            if group_fields is None:
                # Probed from the SESSION link (utils/probes): groups
                # sized so per-group upload time dominates round-trip
                # latency, replacing the frozen group_fields=8.
                from .utils import probes
                field_mb = stack[0].nbytes / (1024 * 1024)
                g = probes.upload_group_items(field_mb, n_data, F)
            else:
                g = max(int(group_fields), n_data)
                g += (-g) % n_data
            step_kwargs = dict(
                median_filter_size=det.median_filter_size, c_std=det.c_std,
                r_2_threshold=det.r_2_threshold,
                consolidation_radius=det.consolidation_radius,
                max_candidates=mc, max_spots=max_spots,
                num_iters=det.num_iters, theta_starts=det.theta_starts,
                upsample_factor=reg.upsample_factor,
                photometry_method=device_method,
                photometry_radius=phot.radius,
                photometry_brim=phot.brim_size,
                # Experiment rows are UNFLOORED, like the reference's
                # track-photometries CSV (flexlibrary.py:2848-2866);
                # photometry_min is a Trace.photometries/stepfit-surface
                # parameter, not a track-CSV one.
                photometry_min=None)
            lows = list(range(0, F, g))

            pack = pack and keys is not None

            def _dispatch(lo):
                from .utils import profiling

                hi = min(lo + g, F)
                grp = stack[lo:hi]
                if hi - lo < g:  # pad the tail group (sliced off below)
                    grp = np.concatenate(
                        [grp, np.repeat(grp[-1:], g - (hi - lo), axis=0)])
                profiling.bump("ledger/uploads")
                profiling.bump("ledger/upload_bytes", int(grp.nbytes))
                profiling.bump("ledger/step_dispatches")
                with mesh:
                    x = shard_fields(grp, mesh)
                    o = experiment_step_sharded(x, mesh, **step_kwargs)
                    if pack:
                        # Pack the result dict into per-byte-width blobs
                        # (utils/transfer) and start the device->host
                        # copies NOW (they queue right behind this
                        # group's step, ahead of later uploads): <= 3
                        # fetches per group instead of one per key,
                        # bit-exact (bitcasts, no rounding).
                        from .utils.transfer import pack_for_transfer
                        blobs, spec = pack_for_transfer(
                            {k: o[k] for k in keys})
                        for b in blobs.values():
                            b.copy_to_host_async()
                        return (blobs, spec), hi - lo, x
                    return o, hi - lo, x
            # dispatch='eager' (default) enqueues every group's upload +
            # step up front; 'window' keeps a sliding window of 2 in
            # flight and defers the rest. Measured A/B on the bench chip
            # (32x8x512x512 uint16, 2 runs each): eager 5.32/5.39
            # fields/s vs window 3.70/4.38. Window's deferred uploads
            # land in the middle of the caller's per-group photometry
            # round trips (track+photometry 3.9-4.1 s vs eager's
            # 1.6-1.8 s), which costs far more than eager's
            # first-fetch-waits-longer effect saves. Keep 'window' only
            # for callers with no per-group device work and severe HBM
            # pressure.
            n_prime = 2 if dispatch == "window" else len(lows)
            pending = [_dispatch(lo) for lo in lows[:n_prime]]
            names = (list(keys) if pack
                     else [k for k in pending[0][0]
                           if keys is None or k in keys])
        parts = [] if key is not None else None
        for gi, lo in enumerate(lows):
            o, ga, dev = pending[gi]
            with self._stage("api/run_stack"):
                from .utils import profiling

                # np.asarray blocks only on THIS group's step.
                if pack:
                    from .utils.transfer import (transfer_nbytes,
                                                 unpack_transfer)
                    blobs, spec = o
                    grp_out = {k: v[:ga] for k, v in
                               unpack_transfer(blobs, spec).items()}
                    profiling.bump("ledger/result_fetches", len(blobs))
                    # Padded group rows transfer too: count the blob
                    # bytes that crossed the link, not the sliced views.
                    profiling.bump("ledger/fetch_bytes",
                                   transfer_nbytes(blobs))
                else:
                    full = {k: np.asarray(o[k]) for k in names}
                    grp_out = {k: v[:ga] for k, v in full.items()}
                    profiling.bump("ledger/result_fetches", len(names))
                    profiling.bump("ledger/fetch_bytes",
                                   sum(int(v.nbytes)
                                       for v in full.values()))
                if gi + n_prime < len(lows):
                    pending.append(_dispatch(lows[gi + n_prime]))
            if parts is not None:
                parts.append(grp_out)
            pending[gi] = None  # release the step outputs
            yield grp_out, dev, lo
        if key is not None:
            full = {k: np.concatenate([p[k] for p in parts])
                    for k in names}
            self.store.save(key, full, meta={"stage": "run_stack"})

    def run_zstack(self, stack, box_size=10, filter_size=10,
                   max_candidates=None, return_background=False,
                   psfs=False, stack_key=None, lean=False,
                   max_spots=None):
        """Background estimation + batched PSF fits over a z/time stack
        (BASELINE.json config 2: one field observed over a z or time axis).

        Per-frame SExtractor mesh backgrounds (ops.background: sigma-
        clipped mode boxes, median-filtered mesh, matmul spline-basis
        upsample — the device redesign of the photutils recipe at
        flexlibrary.py:446-486) are estimated and SUBTRACTED on device,
        then every frame's spots are detected and PSF-fitted in one
        batched program (models.detect.detect_and_fit_batch, the
        pflib.py:284-520 redesign), with the frame axis sharded over the
        session mesh. Nothing bounces through the host between the raw
        camera frames and the fitted spot buckets.

        ``stack``: [T, H, W] numpy array (any camera dtype — integer
        frames upload raw and cast on device) or an already-device-
        resident jax.Array.

        ``max_candidates``: None = config.detect's bucket (one compiled
        program, loud truncation warning on overflow); an integer sets
        the bucket; the string ``"exhaustive"`` fits EVERY above-
        threshold candidate of every frame through the chunked driver
        (models.detect.detect_and_fit_exhaustive — the reference's
        uncapped semantics at any spot density; backgrounds still
        estimate/subtract on device per pipelined group).

        ``lean``: keep-first compacted fetch (integer-bucket mode only).
        Every candidate is still detected and fitted on device, but only
        ``max_spots`` slots per frame cross the link, kept fits first
        (models.detect.pack_spot_buckets) — the reference's product per
        image is the consolidated fits (pflib.py:479-519), so the other
        slots need not be fetched. Returned arrays are then [T, max_spots]
        spot-major (kept-first; ``keep``/``cand_valid`` still mask), with
        an extra ``spot_count`` [T] (exact keep totals — values above
        max_spots mean kept fits were truncated; a loud warning fires).

        Returns a dict of host numpy arrays — the SpotFindResult schema
        batched over frames: cand_h/cand_w [T, K] int32, params [T, K, 7],
        center_h/center_w/rmse/r2/s_n [T, K], keep/cand_valid [T, K] bool,
        cand_count [T] int32 — plus "background" [T, H, W] float32 when
        ``return_background`` and "psfs" (per-frame reference-contract
        psfs dicts, built host-side from the background-subtracted
        frames) when ``psfs``. Artifact-store caching applies only to
        the array outputs (``psfs=True`` runs always compute).
        """
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .models.detect import (_prep_correlation_matrix,
                                    detect_and_fit_batch,
                                    psfs_dicts_from_batch,
                                    warn_candidate_overflow)
        from .ops.background import stack_background_jit

        stack = _normalize_stack(stack)
        if stack.ndim != 3 or stack.shape[0] == 0:
            raise ValueError("stack must be a non-empty [frames, H, W] "
                             f"array (got shape {stack.shape})")
        det = self.config.detect
        if psfs and det.consolidation_radius < 2:
            # Fail before any device work: the psfs-dict build below has
            # the same key-uniqueness precondition as find_peptides_batch
            # (models/detect.py) and would silently drop spots.
            raise ValueError("consolidation_radius must be at least 2")
        exhaustive = max_candidates == "exhaustive"
        mc = (det.max_candidates if (max_candidates is None or exhaustive)
              else max_candidates)
        if lean and (exhaustive or psfs):
            # The lean pack compacts a fixed-bucket device result; the
            # exhaustive driver has its own chunked transfer scheme, and
            # the psfs build needs the full per-candidate schema.
            raise ValueError("lean=True requires an integer "
                             "max_candidates bucket and psfs=False")
        n_spots_bucket = int(max_spots) if max_spots is not None else 2048
        key = None
        if self.store is not None and not psfs:
            from .utils.checkpoint import content_key
            if stack_key is None:
                stack_key = content_key(np.asarray(stack))
            key = content_key("run_zstack", stack_key, self.config.asdict(),
                              box_size, filter_size,
                              "exhaustive" if exhaustive else mc,
                              return_background,
                              *((("lean", n_spots_bucket),) if lean
                                else ()))
            if self.store.exists(key):
                return self.store.load(key)
        T = stack.shape[0]
        mesh = self.mesh
        axis = mesh.axis_names[0]
        n_dev = int(mesh.shape[axis])
        sharding = NamedSharding(mesh, P(axis, None, None))

        # Frame groups pipeline host->device transfer against compute:
        # all groups' uploads + programs dispatch eagerly (JAX dispatch
        # is async), so group k's background+detect run while group k+1
        # uploads. Group size is sized from the SESSION link probes
        # (utils/probes.upload_group_items): big enough that per-group
        # transfer time dominates the measured round-trip latency, small
        # enough to keep at least two groups in flight; rounded to a
        # mesh-axis multiple so every dispatch hits ONE compiled program
        # (tail groups pad with the last frame, sliced off after the
        # fetch). A device-resident stack has no upload to overlap and
        # dispatches whole.
        if isinstance(stack, jax.Array):
            g = T + (-T) % n_dev
        else:
            from .utils import probes
            frame_mb = stack[0].nbytes / (1024 * 1024)
            g = probes.upload_group_items(frame_mb, n_dev, T)

        from .utils import profiling

        lean_spec = {}  # per-group transfer spec (identical across groups)

        def _dispatch_group(grp):
            n = grp.shape[0]
            if n < g:
                if isinstance(grp, jax.Array):
                    grp = jnp.concatenate(
                        [grp, jnp.repeat(grp[-1:], g - n, axis=0)], axis=0)
                else:
                    grp = np.concatenate(
                        [grp, np.repeat(grp[-1:], g - n, axis=0)], axis=0)
            if not isinstance(grp, jax.Array):
                profiling.bump("ledger/uploads")
                profiling.bump("ledger/upload_bytes", int(grp.nbytes))
            profiling.bump("ledger/step_dispatches")
            dev = jax.device_put(grp, sharding)
            background = stack_background_jit(
                dev, box_size=box_size, filter_size=filter_size)
            subtracted = dev.astype(jnp.float32) - background
            if exhaustive:
                # Defer detection: the chunked exhaustive driver runs
                # once over the whole subtracted stack below (uploads
                # and background programs still pipeline per group).
                fetch = {}
                if return_background:
                    fetch["background"] = background
                    background.copy_to_host_async()
                return n, fetch, subtracted
            res = detect_and_fit_batch(
                subtracted,
                median_filter_size=det.median_filter_size,
                correlation_matrix=_prep_correlation_matrix(None),
                c_std=float(det.c_std),
                r_2_threshold=float(det.r_2_threshold),
                consolidation_radius=float(det.consolidation_radius),
                max_candidates=mc, num_iters=det.num_iters,
                theta_starts=det.theta_starts)
            # Start the device->host copies at dispatch time so the
            # per-fetch link latency overlaps later groups' work; the
            # full-resolution maps transfer only when actually needed
            # (background is [T, H, W] float32 — 32 MB on the bench
            # shape).
            if lean:
                from .models.detect import pack_spot_buckets
                from .utils.transfer import pack_for_transfer
                coord_dt = (jnp.int16
                            if max(stack.shape[1:]) <= 32767 else jnp.int32)
                f32b, intsb, flagsb, spotc, candc = pack_spot_buckets(
                    res, n_spots_bucket, coord_dtype=coord_dt)
                # One fetch per byte width instead of five (each fetch is
                # a full link round trip — utils/transfer).
                blobs, spec = pack_for_transfer(
                    {"_lean_f32": f32b, "_lean_ints": intsb,
                     "_lean_flags": flagsb, "_lean_spot_count": spotc,
                     "_lean_cand_count": candc})
                lean_spec["spec"] = spec
                fetch = {f"_blob{size}": b for size, b in blobs.items()}
            else:
                fetch = dict(res._asdict())
            if return_background:
                fetch["background"] = background
            if psfs:
                fetch["subtracted"] = subtracted
            for v in fetch.values():
                v.copy_to_host_async()
            return n, fetch, None

        with self._stage("api/run_zstack"):
            if exhaustive:
                # One-ahead window: group k+1's upload + background
                # dispatch while the chunked driver (which synchronizes
                # on per-image candidate counts) runs on group k, so
                # device residency stays at ~2 groups of frames instead
                # of the whole subtracted stack (a 1000-frame stack
                # would otherwise hold ~2x its size on device before
                # detection even starts).
                from .models.detect import detect_and_fit_exhaustive

                groups = [stack[lo:min(lo + g, T)]
                          for lo in range(0, T, g)]
                cur = _dispatch_group(groups[0])
                parts = []
                for gi in range(len(groups)):
                    n, fetch, sub = cur
                    if gi + 1 < len(groups):
                        cur = _dispatch_group(groups[gi + 1])
                    res = detect_and_fit_exhaustive(
                        sub[:n], median_filter_size=det.median_filter_size,
                        c_std=float(det.c_std),
                        r_2_threshold=float(det.r_2_threshold),
                        consolidation_radius=float(
                            det.consolidation_radius),
                        num_iters=det.num_iters,
                        theta_starts=det.theta_starts)
                    extra = {}
                    for k, v in fetch.items():
                        a_full = np.asarray(v)
                        profiling.bump("ledger/result_fetches")
                        profiling.bump("ledger/fetch_bytes",
                                       int(a_full.nbytes))
                        extra[k] = a_full[:n]
                    if psfs:
                        extra["subtracted"] = np.asarray(sub[:n])
                    parts.append((res, extra))
                # Per-group candidate widths differ (K = chunks * chunk);
                # pad to the max before concatenating — pad entries are
                # invalid/unkept, exactly like in-driver padding.
                k_max = max(r.cand_h.shape[1] for r, _ in parts)

                def _pad_k(a, fill):
                    pad = k_max - a.shape[1]
                    if pad == 0:
                        return a
                    width = [(0, 0), (0, pad)] + \
                        [(0, 0)] * (a.ndim - 2)
                    return np.pad(a, width, constant_values=fill)

                fills = {"cand_h": 2, "cand_w": 2, "keep": False,
                         "cand_valid": False}
                out = {}
                for key_name in parts[0][0]._fields:
                    if key_name == "cand_count":
                        out[key_name] = np.concatenate(
                            [getattr(r, key_name) for r, _ in parts])
                        continue
                    out[key_name] = np.concatenate(
                        [_pad_k(getattr(r, key_name),
                                fills.get(key_name, 0))
                         for r, _ in parts])
                for key_name in parts[0][1]:
                    out[key_name] = np.concatenate(
                        [extra[key_name] for _, extra in parts])
            else:
                pending = [_dispatch_group(stack[lo:min(lo + g, T)])
                           for lo in range(0, T, g)]
                fetched = {}
                for k in pending[0][1]:
                    parts_k = []
                    for n, fetch, _ in pending:
                        a_full = np.asarray(fetch[k])
                        profiling.bump("ledger/result_fetches")
                        # Padded rows transfer too: count what crossed
                        # the link, not the post-slice view.
                        profiling.bump("ledger/fetch_bytes",
                                       int(a_full.nbytes))
                        parts_k.append(a_full[:n])
                    fetched[k] = np.concatenate(parts_k)
                if lean:
                    from .models.detect import unpack_spot_buckets
                    from .utils.transfer import unpack_transfer
                    blobs = {int(k[len("_blob"):]): fetched.pop(k)
                             for k in list(fetched)
                             if k.startswith("_blob")}
                    # Blob rows concatenated across groups: widen the
                    # per-group spec's leading axis to the total frames.
                    T_total = next(iter(blobs.values())).shape[0]
                    spec = tuple((k, (T_total,) + shape[1:], dt)
                                 for (k, shape, dt) in lean_spec["spec"])
                    parts = unpack_transfer(blobs, spec)
                    out = unpack_spot_buckets(
                        parts["_lean_f32"], parts["_lean_ints"],
                        parts["_lean_flags"], parts["_lean_spot_count"],
                        parts["_lean_cand_count"])
                    out.update(fetched)  # background, if requested
                else:
                    out = fetched
        if not exhaustive:
            warn_candidate_overflow(out["cand_count"], mc, "run_zstack")
            if lean and (out["spot_count"] > n_spots_bucket).any():
                import warnings
                worst = int(out["spot_count"].max())
                warnings.warn(
                    f"run_zstack(lean=True): {worst} kept fits exceed "
                    f"max_spots={n_spots_bucket}; kept fits beyond the "
                    "first max_spots (in candidate order, NOT by "
                    "quality) were dropped from the transfer. Re-run "
                    "with a larger max_spots (or lean=False) for full "
                    "coverage.", stacklevel=2)
        if psfs:
            sub = out.pop("subtracted")
            out["psfs"] = psfs_dicts_from_batch(
                sub, out["keep"], out["params"], out["center_h"],
                out["center_w"], out["rmse"], out["r2"], out["s_n"],
                out["cand_h"], out["cand_w"], det.consolidation_radius)
        if key is not None:
            self.store.save(key, out, meta={"stage": "run_zstack"})
        return out

    def run_experiment(self, stacks, csv_path=None, max_candidates=None,
                       max_spots=None, candidate_radius=2,
                       category_csv_path=None, category_csv_filtered=True,
                       category_csv_collate_fields=False, mdma=False,
                       adjustment_function=None, save_averages=False,
                       keep_invalid=False,
                       remainder_threshold=None, remainder_channels=None,
                       dispatch="eager"):
        """The flagship workflow, one call: align + detect/fit + track +
        interpolate + categorize + track-photometries CSV.

        Arguments:
            stacks: a [F, C, H, W] array (single channel, named 'ch1') or a
                dict {channel_name: [F, C, H, W] array}.
            csv_path: if given, write the reference-schema
                ``CHANNEL,FIELD,H,W,CATEGORY,FRAME i...`` CSV there
                (flexlibrary.py:2755-2892 with save_averages=False,
                interpolate=True — the basic_experiment_script config).
            category_csv_path: if given, also write the
                ``Pattern[,Field],Channel,Count`` category-counts CSV
                (flexlibrary.py:2948-3024; filtered keeps only one-drop
                monotone patterns, like basic_experiment_script).
            mdma: apply multiplicative-delta-median adjustments — the
                per-frame photometric drift factors Af derived from each
                field's persistent remainders (all-frames-ON traces),
                I_adj = I * (1 - Af). Same math, same remainder set
                (post-discard valid traces), and same application point
                (every row, remainders included, interpolated defaults
                included) as SequenceExperiment.
                multiplicative_delta_median_adjustments +
                mdma_adjustment fed to track_photometries_as_csv
                (flexlibrary.py:2131-2212).
            adjustment_function: custom per-photometry adjustment hook —
                called as fn(photometry=..., frame=..., adjustments=...)
                on every row value, exactly like
                binary_trace_categories_photometry's parameter
                (flexlibrary.py:2088-2124). ``adjustments`` is the
                field's photometry-adjustments dict: {"mdma": (Af per
                frame)} when ``mdma`` is also set, else None (the class
                attribute's default before
                multiplicative_delta_median_adjustments runs). When
                given, it REPLACES the built-in mdma multiply — the
                reference applies mdma only through this hook
                (mdma_adjustment IS the stock adjustment_function).
            save_averages: the reference's OTHER track-photometries CSV
                format (track_photometries_as_csv(save_averages=True),
                flexlibrary.py:2855-2882): one AVERAGE_INTENSITY column
                — the mean over the trace's DETECTED frames only
                (interpolate=False: absent frames contribute
                (None, None, None) and are skipped by the mean) — and
                H/W from frame 0 whether or not the trace is detected
                there (the reference's always-true identity guard,
                flexlibrary.py:2872-2874), i.e. None/None for traces
                absent at frame 0. ``rows`` then carry the mean as
                their last element. A custom adjustment_function is fed
                photometry=None at absent frames exactly like the
                reference (so a hook that assumes a float raises there,
                as flexlibrary's stock mdma_adjustment does);
                non-None returns for those frames DO enter the mean.
                No device hole gathers are dispatched on this path
                (hole values cannot reach the CSV; the sextractor host
                sweep still measures all filled positions and masks
                holes out before averaging).
            keep_invalid: the experiment script's --keep_invalid surface
                (basic_experiment_script.py:472-476 skips
                discard_invalid_traces): EVERY trace emits a row.
                Out-of-5x5-box interpolated holes are the reference's
                None Spots — their entries are None in ``rows`` and '0'
                in the CSV (flexlibrary.py:2884-2886); edge positions
                whose photometry window is truncated are measured with
                the reference's clipped-slice semantics
                (Spot.photometry(return_invalid=True)) on host. A custom
                adjustment_function is fed photometry=None at None-Spot
                frames, exactly like the reference (and like the
                reference, its None returns write '0'); built-in
                ``mdma`` multiplies the non-None entries (the
                reference's stock hook would raise on the Nones — this
                convenience flag extends it). H/W go None when frame 0
                is a None Spot (the photometry[0][:2] quirk).
                Device-resident stacks download per group for the
                clipped edge measurements. sextractor rows measure
                clipped edge apertures inside the host sweep itself
                (aperture truncation at the frame is exactly the
                kernel's zero padding) and write '0' at None Spots like
                every other metric.
            remainder_threshold: if set, QC-mask fields whose remainder
                count falls below it in any of ``remainder_channels``
                (default: all channels) — remainder_threshold_fields
                semantics (flexlibrary.py:3231-3263, min_remainders=5
                there). Masked fields keep their category_counts but
                their rows are dropped from ``rows`` and the CSV, like
                track_photometries_as_csv(ignore_invalid_fields=True).
            dispatch: group-upload scheduling, forwarded to
                _stack_step_groups. "eager" (default) enqueues every
                group's upload+step up front — the round-3 on-chip A/B
                winner (5.3 vs 3.7-4.4 fields/s; the windowed variant's
                deferred uploads landed mid-flight of the caller's
                photometry round trips). "window" keeps only 2 groups in
                flight for callers with severe HBM pressure.

        Returns a dict:
            rows: list of (channel, field, h, w, category, photometries)
            category_counts: {channel: {field: {category: count}}}
            filtered_category_counts: same, one-drop monotone patterns only
                (tuple(sorted(bt, reverse=True)) == bt,
                flexlibrary.py:2894-2946)
            offsets: {channel: (off_h [F, C], off_w [F, C])}
            summary: {channel: {spot_count, trace_count, singleton_count}}
                — the experiment script's printed summary stats.
                trace_count/singleton_count match the classes
                (post-discard valid traces). spot_count counts DETECTED
                spots; the class path's number additionally grows every
                time fill_in_trace runs, because the reference's
                interpolate_spots appends its interpolated (and bookend)
                Spots to the frames (flexlibrary.py:1931-1944) — a
                path-dependent accumulation artifact this redesigned
                surface deliberately does not reproduce.
            remainder_counts: {channel: [per-field remainder count]}
            mdma_adjustments: {channel: {field: (Af per frame)}} when
                ``mdma`` (else None)
            invalid_fields_mask: per-field QC mask when
                ``remainder_threshold`` is set (else None)
            csv_path: echo of the written file (or None)

        Equality with the class-based path (SequenceExperiment ->
        MultifieldMultichannelSequenceExperiment.track_photometries_as_csv)
        is proven row-by-row in tests/test_fast_experiment.py. The
        photometry method comes from config.photometry.method: mexican_hat,
        simple, maximum, gaussian_volume, sigmas, or sextractor (the
        aperture/background parameters ride config.photometry's
        aperture_radius/box_size/filter_size).
        """
        from .pipeline.fast_experiment import _spot_lists, \
            flush_hole_queue, run_experiment_stack

        if not isinstance(stacks, dict):
            stacks = {"ch1": stacks}
        # Normalize up-front and require one cycle count across channels
        # (the experiment classes enforce the same invariant in
        # MultifieldMultichannelSequenceExperiment.__init__); the CSV
        # frame header depends on it.
        stacks = {ch: _normalize_stack(s) for ch, s in stacks.items()}
        for ch, s in stacks.items():
            if s.ndim != 4 or s.shape[0] == 0:
                raise ValueError(
                    f"channel {ch!r}: stack must be a non-empty "
                    f"[fields, cycles, H, W] array (got shape {s.shape})")
        cycle_counts = {s.shape[1] for s in stacks.values()}
        if len(cycle_counts) != 1:
            raise ValueError("every channel must have the same cycle "
                             f"count (got {sorted(cycle_counts)})")
        n_cycles = cycle_counts.pop()
        if remainder_threshold is not None:
            field_counts = {s.shape[0] for s in stacks.values()}
            if len(field_counts) != 1:
                raise ValueError(
                    "remainder_threshold needs one field count across "
                    f"channels (got {sorted(field_counts)})")
        phot = self.config.photometry
        rows = []
        category_counts = {}
        offsets_out = {}
        summary = {}
        remainder_counts = {}
        mdma_adjustments = {}
        for channel, stack in stacks.items():
            # Grouped async upload per channel: the device step runs on
            # field group k while group k+1's transfer is in flight, and
            # the photometry stage reuses the device-resident buffer (raw
            # integer camera dtypes stay integer — see _normalize_stack,
            # already applied above). The cache key (when a store is set)
            # hashes the host array BEFORE upload so nothing round-trips.
            stack_key = None
            if self.store is not None and isinstance(stack, np.ndarray):
                from .utils.checkpoint import content_key
                stack_key = content_key(stack)
            F, C, H, W = stack.shape
            # Every metric rides the device step's per-spot photometry
            # bucket: fit products (gaussian_volume, sigmas) have no
            # image kernel at all, and the image metrics reuse the
            # bucket for detected frames so only interpolated holes
            # dispatch patch gathers.
            # The compact bucket encodings (int16 rounded centers +
            # int8 tri-state + int16 candidate order) instead of the
            # float32 centers: device->host bytes are the config-4
            # critical path, and tracking only needs integer identity.
            # cand_count ([F, C] int32, ~KBs) rides along so candidate-
            # bucket overflow is WARNED like spot-bucket overflow below —
            # never silently dropped spots relative to the class path.
            keys = ("offsets_h", "offsets_w", "spot_rh", "spot_rw",
                    "spot_state", "spot_cand_c", "spot_overflow",
                    "cand_count", "photometry")
            # sextractor measures on host (background-subtracted
            # images) — hand it the host stack so nothing downloads,
            # and skip fetching the device photometry bucket it would
            # discard (float32 x max_spots: more link bytes than all
            # the compact spot arrays combined).
            host_phot = phot.method == "sextractor"
            if host_phot:
                keys = tuple(k for k in keys if k != "photometry")
            per_field = []
            off_parts_h, off_parts_w = [], []
            n_over = 0
            n_cand_over = 0
            mc_eff = (max_candidates if max_candidates is not None
                      else self.config.detect.max_candidates)
            spot_count = 0
            # Pipelined: host tracking+photometry on group k runs while
            # groups k+1.. are still uploading/computing on device. The
            # interpolated-hole patch gathers are DEFERRED to one flush
            # after the loop (hole_queue): they are the only per-group
            # device round trips, and on a serial transfer link they
            # would otherwise queue behind the in-flight uploads of
            # later groups, stalling the host for a full group upload
            # per fetch (the measured failure mode of the round-3
            # windowed-dispatch A/B).
            hole_queue = [] if not (host_phot or save_averages) else None
            for out_grp, dev_grp, lo in self._stack_step_groups(
                    stack, keys, max_candidates=max_candidates,
                    max_spots=max_spots, stack_key=stack_key,
                    dispatch=dispatch, pack=True):
                Fg = out_grp["offsets_h"].shape[0]
                rhs, rws, spot_values = _spot_lists(out_grp, Fg, C, H, W,
                                                    with_values=True)
                n_over += int(out_grp["spot_overflow"].sum())
                n_cand_over += int((out_grp["cand_count"] > mc_eff).sum())
                off_parts_h.append(out_grp["offsets_h"])
                off_parts_w.append(out_grp["offsets_w"])
                spot_count += sum(len(rh) for per_c in rhs for rh in per_c)
                with self._stage("api/run_experiment/track+photometry"):
                    per_field += run_experiment_stack(
                        stack[lo:lo + Fg] if host_phot or dev_grp is None
                        else dev_grp,
                        out_grp["offsets_h"], out_grp["offsets_w"],
                        (rhs, rws),
                        photometry_method=phot.method,
                        photometry_radius=phot.radius,
                        photometry_brim=phot.brim_size,
                        candidate_radius=candidate_radius,
                        spot_values=None if host_phot else spot_values,
                        aperture_radius=phot.aperture_radius,
                        box_size=phot.box_size,
                        filter_size=phot.filter_size,
                        hole_queue=hole_queue,
                        skip_hole_gathers=save_averages,
                        keep_invalid=keep_invalid,
                        # Lazy slice: _host_clipped_photometry asarray's
                        # it only when the group actually has truncated-
                        # window positions, so trunc-free groups skip the
                        # device->host image fetch entirely. The
                        # sextractor branch never reads it (clipped edges
                        # ride its zero-padded aperture kernel), so skip
                        # the slice op for host_phot runs.
                        host_images=(stack[lo:lo + Fg]
                                     if keep_invalid and not host_phot
                                     else None))
            if hole_queue:
                with self._stage("api/run_experiment/track+photometry"):
                    flush_hole_queue(hole_queue)
            if keep_invalid:
                # NaN markers are the reference's None Spots: surface
                # them as None values, and apply the H/W header quirk
                # (photometry[0][:2] -> None/None when frame 0 is such
                # a Spot, flexlibrary.py:2872-2874).
                for f, field_rows in enumerate(per_field):
                    new_rows = []
                    for (cat, h0, w0, ph) in field_rows:
                        vals = tuple(None if np.isnan(v) else float(v)
                                     for v in ph)
                        if vals[0] is None and not cat[0]:
                            h0 = w0 = None
                        new_rows.append((cat, h0, w0, vals))
                    per_field[f] = new_rows
            if n_over:
                logging.getLogger(__name__).warning(
                    "run_experiment: %d (field, cycle) images overflowed "
                    "the max_spots bucket — their lowest-R^2 spots were "
                    "dropped; raise max_spots for complete tracking",
                    n_over)
            if n_cand_over:
                logging.getLogger(__name__).warning(
                    "run_experiment: %d (field, cycle) images found more "
                    "than max_candidates=%d peaks — the weakest-"
                    "correlation candidates were dropped; raise "
                    "max_candidates for exhaustive coverage", n_cand_over,
                    mc_eff)
            offsets_out[channel] = (np.concatenate(off_parts_h),
                                    np.concatenate(off_parts_w))
            # Pre-create every (channel, field) entry: the reference's
            # binary_trace_categories does (experiment.py:685 /
            # flexlibrary.py:2682-2688), so zero-trace fields still emit
            # count-0 rows in the collated category CSV.
            for f in range(F):
                category_counts.setdefault(channel, {}).setdefault(f, {})
            with self._stage("api/run_experiment/track+photometry"):
                # Persistent remainders per field: all-frames-ON valid
                # traces (count_remainders over post-discard spot_traces).
                remainder_counts[channel] = [
                    sum(1 for (cat, _, _, _) in field_rows if all(cat))
                    for field_rows in per_field]
                if mdma or adjustment_function is not None:
                    adjs = {}
                    for f, field_rows in enumerate(per_field):
                        adjustments = None
                        if mdma:
                            rem = [ph for (cat, _, _, ph) in field_rows
                                   if all(cat)]
                            if rem:
                                # Per-remainder: (I_f - median_f(I)) /
                                # median; per-frame: median of those
                                # ratios — flexlibrary.py:2188-2198.
                                rr = np.stack([(np.asarray(ph, np.float64)
                                                - np.median(ph))
                                               / np.median(ph)
                                               for ph in rem])
                                af = np.median(rr, axis=0)
                            else:
                                af = np.zeros(n_cycles)
                            adjs[f] = tuple(float(a) for a in af)
                            adjustments = {"mdma": adjs[f]}
                        if adjustment_function is not None:
                            # The custom hook is the ONLY application
                            # (flexlibrary.py:2120-2124): mdma, when also
                            # requested, rides in through ``adjustments``
                            # exactly as photometry_adjustments does. On
                            # the save_averages (uninterpolated) surface
                            # absent frames feed photometry=None, like
                            # the reference's (None, None, None) entries.
                            per_field[f] = [
                                (cat, h0, w0,
                                 tuple(adjustment_function(
                                     photometry=(ph_i if (not save_averages
                                                          or cat[i])
                                                 else None), frame=i,
                                     adjustments=adjustments)
                                     for i, ph_i in enumerate(ph)))
                                for (cat, h0, w0, ph) in field_rows]
                        elif save_averages:
                            # Built-in mdma on detected frames only
                            # (holes are None and never reach the
                            # multiply — the reference's stock hook
                            # raises on them instead; see docstring).
                            per_field[f] = [
                                (cat, h0, w0,
                                 tuple(float(ph[i]) * (1.0 - af[i])
                                       if cat[i] else None
                                       for i in range(n_cycles)))
                                for (cat, h0, w0, ph) in field_rows]
                        elif keep_invalid:
                            # Same convenience on the keep_invalid rows:
                            # multiply the non-None entries, keep the
                            # None Spots as None.
                            per_field[f] = [
                                (cat, h0, w0,
                                 tuple(v * (1.0 - af[i]) if v is not None
                                       else None
                                       for i, v in enumerate(ph)))
                                for (cat, h0, w0, ph) in field_rows]
                        else:
                            per_field[f] = [
                                (cat, h0, w0, np.asarray(ph, np.float64)
                                 * (1.0 - af))
                                for (cat, h0, w0, ph) in field_rows]
                    if mdma:
                        mdma_adjustments[channel] = adjs
                elif save_averages:
                    # Uninterpolated surface with no adjustments: absent
                    # frames become None (trace_to_photometry's
                    # (None, None, None) rows) so the mean below skips
                    # them, flexlibrary.py:2875-2878.
                    for f, field_rows in enumerate(per_field):
                        per_field[f] = [
                            (cat, h0, w0,
                             tuple(float(ph[i]) if cat[i] else None
                                   for i in range(n_cycles)))
                            for (cat, h0, w0, ph) in field_rows]
                n_traces = n_singletons = 0
                for f, field_rows in enumerate(per_field):
                    for (cat, h0, w0, ph) in field_rows:
                        if save_averages:
                            vals = [v for v in ph if v is not None]
                            mean = (float(np.mean(vals)) if vals
                                    else float("nan"))
                            # H/W from frame 0 regardless of presence
                            # (reference's always-true identity guard).
                            if not cat[0]:
                                h0 = w0 = None
                            ph = mean
                        rows.append((channel, f, h0, w0, cat, ph))
                        category_counts.setdefault(channel, {}) \
                            .setdefault(f, {}).setdefault(cat, 0)
                        category_counts[channel][f][cat] += 1
                        n_traces += 1
                        n_singletons += sum(cat) == 1
                summary[channel] = {
                    "spot_count": int(spot_count),
                    "trace_count": n_traces,
                    "singleton_count": n_singletons,
                }
        invalid_fields_mask = None
        if remainder_threshold is not None:
            n_fields = len(next(iter(remainder_counts.values())))
            if remainder_channels is None:
                chans = list(remainder_counts)
            else:
                missing = [c for c in remainder_channels
                           if c not in remainder_counts]
                if missing:
                    # A typo'd channel list would otherwise pass every
                    # field (vacuous any()) — QC silently disabled. The
                    # reference fails loudly on a missing channel key
                    # (flexlibrary.py:3231-3263 indexes by channel).
                    raise ValueError(
                        "remainder_channels %r not in experiment channels %r"
                        % (missing, sorted(remainder_counts)))
                chans = [c for c in remainder_counts
                         if c in remainder_channels]
            invalid_fields_mask = [
                not any(remainder_counts[c][f] < remainder_threshold
                        for c in chans)
                for f in range(n_fields)]
            rows = [r for r in rows if invalid_fields_mask[r[1]]]
        from .pipeline.fast_experiment import (filter_monotone_categories,
                                               write_track_rows_csv)

        filtered = filter_monotone_categories(category_counts)
        if csv_path is not None:
            write_track_rows_csv(rows, n_cycles, csv_path,
                                 save_averages=save_averages)
        if category_csv_path is not None:
            from .pipeline.experiment import write_category_counts_csv
            to_save = filtered if category_csv_filtered else category_counts
            write_category_counts_csv(
                to_save, category_csv_path,
                collate_fields=category_csv_collate_fields)
        return {"rows": rows, "category_counts": category_counts,
                "filtered_category_counts": filtered,
                "offsets": offsets_out, "summary": summary,
                "remainder_counts": remainder_counts,
                "mdma_adjustments": mdma_adjustments if mdma else None,
                "invalid_fields_mask": invalid_fields_mask,
                "csv_path": csv_path,
                "category_csv_path": category_csv_path}

    def run_timetrace(self, movie, csv_path=None, search_radius=3,
                      s_n_cutoff=3.0, max_candidates=None,
                      photometry_min="config", mirror_start=None,
                      chung_kennedy=None, p_threshold=None,
                      include_step_fits=True, include_intermediates=True):
        """The movie workflow, one call: first-frame detect -> batched
        luminosity-centroid tracking (one lax.scan dispatch for the whole
        movie) -> per-trace photometry -> batched step fitting -> the
        timetrace CSV.

        Semantics are basic_timetrace_script's (initial spots from the
        device detector's psfs with their float centers; LC tracking per
        flexlibrary.py:1172-1317; Trace.photometries zeros for None
        frames; the mirror -> Chung-Kennedy -> sliding-t -> refit ->
        t-merge chain per flexlibrary.py:3642-3713); CSV rows equal the
        classes' TimetraceExperiment.save_experiment_as_csv — proven in
        tests/test_fast_timetrace.py.

        Arguments:
            movie: [T, H, W] array — one continuously-filmed field.
            max_candidates: None (default) defers to
                config.detect.single_field_cap — itself None by default,
                meaning EXHAUSTIVE detection: the chunked driver fits
                every above-threshold candidate (the reference's
                uncapped semantics, zero truncation at any spot
                density). An integer (per-call or via the config field)
                caps a single-dispatch bucket with a loud truncation
                warning on overflow.
                (The BATCHED stack surfaces — run_stack/run_experiment/
                run_zstack — keep integer buckets inside their one
                compiled program; None means config.detect's bucket
                there.)
            csv_path: if given, write the Trace#/Hcoord/Wcoord/Frame#/
                Photometry [...] CSV there (include_step_fits /
                include_intermediates add the reference's step-fit and
                intermediate columns).
            search_radius / s_n_cutoff: LC tracking parameters
                (flexlibrary lc_create_traces defaults).
            mirror_start / chung_kennedy / p_threshold: step-fit chain
                parameters; None means config.stepfit's values.
            photometry_min: floor applied to the per-frame photometries
                before step fitting (flexlibrary stepfit_tracks'
                photometry_min); defaults to
                config.photometry.photometry_min, pass None to disable
                flooring regardless of config.

        Returns a dict: traces {h, w, present, rec_h, rec_w},
        photometries (N, T), step_fits, step_fit_intermediates,
        trace_count, csv_path.
        """
        from .models.detect import find_peptide_centers
        from .pipeline.fast_timetrace import lc_track, \
            timetrace_photometries
        from .pipeline.traces import PhotometryTrace, PlateauTrace
        from .ops.stepfit_batch import stepfit_batched

        sf = self.config.stepfit
        phot = self.config.photometry
        mirror_start = (sf.mirror_start if mirror_start is None
                        else mirror_start)
        chung_kennedy = (sf.chung_kennedy if chung_kennedy is None
                         else chung_kennedy)
        p_threshold = sf.p_threshold if p_threshold is None else p_threshold
        if isinstance(photometry_min, str):  # the "config" sentinel
            photometry_min = phot.photometry_min

        movie = _normalize_stack(movie)
        if movie.ndim != 3:
            raise ValueError("movie must be [frames, H, W]")
        import jax
        import jax.numpy as jnp
        if isinstance(movie, jax.Array):
            movie_dev = movie
            movie0_dev = movie_dev[0]
        else:
            # Frame 0 ships FIRST (its own small transfer), so the detect
            # dispatch + fetch below overlap the rest of the movie's
            # upload instead of waiting behind it (detect only needs
            # frame 0).
            from .utils import profiling
            movie0_dev = jnp.asarray(movie[0])
            movie_dev = jnp.asarray(movie)
            profiling.bump("ledger/uploads", 2)
            profiling.bump("ledger/upload_bytes",
                           int(movie.nbytes + movie[0].nbytes))
        if movie_dev.dtype != jnp.float32:
            # Raw camera dtypes upload as-is (half the bytes for uint16)
            # and cast on device, like run_stack.
            movie_dev = movie_dev.astype(jnp.float32)
            movie0_dev = movie0_dev.astype(jnp.float32)
        with self._stage("api/run_timetrace/detect"):
            det = self.config.detect
            # Lean arrays path: the psfs-dict key semantics without the
            # sub/fit-image materialization (one dispatch + one fetch).
            # max_candidates=None defers to config.detect.single_field_cap
            # (default None = EXHAUSTIVE chunked detect — the reference's
            # uncapped semantics, zero truncation at any candidate
            # count); an int (per-call or config) caps the
            # single-dispatch bucket.
            h0, w0, fits, _count = find_peptide_centers(
                movie0_dev,
                median_filter_size=det.median_filter_size, c_std=det.c_std,
                r_2_threshold=det.r_2_threshold,
                consolidation_radius=det.consolidation_radius,
                max_candidates=(max_candidates if max_candidates is not None
                                else det.single_field_cap),
                num_iters=det.num_iters)
        if len(h0) == 0:
            if csv_path is not None:
                # The class path still writes a header-only CSV for an
                # empty experiment; a promised file must exist.
                from .pipeline.experiment import TimetraceExperiment
                TimetraceExperiment(
                    frames=[None] * movie.shape[0], spot_traces=[],
                    step_fits={}, step_fit_intermediates={}
                ).save_experiment_as_csv(
                    csv_path, include_step_fits=include_step_fits,
                    # intermediate columns are keyed off the first
                    # trace's dict (reference flexlibrary.py:3544
                    # popitem) — with zero traces there are none.
                    include_intermediates=None,
                    photometry_method=phot.method)
            return {"traces": {"h": [], "w": [], "present": None,
                               "rec_h": None, "rec_w": None},
                    "photometries": np.zeros((0, movie.shape[0])),
                    "step_fits": {}, "step_fit_intermediates": {},
                    "trace_count": 0, "csv_path": csv_path}
        mesh = self.mesh
        n_track_shards = (int(mesh.shape[mesh.axis_names[0]])
                          if mesh is not None else 1)
        # The fused path chunks its photometry dispatches itself, so the
        # gate is purely method (window metrics only) + sharding (the
        # mesh tracker is its own fan-out).
        fused = (phot.method in ("mexican_hat", "simple", "maximum")
                 and n_track_shards == 1)
        if fused:
            # Fused path: tracking results stay on device and feed the
            # photometry kernel directly — no positions round trip
            # (pipeline/fast_timetrace.lc_track_and_photometry; values
            # identical to the two-step path, which remains the oracle
            # in tests/test_fast_timetrace.py).
            from .pipeline.fast_timetrace import lc_track_and_photometry
            with self._stage("api/run_timetrace/track+photometry"):
                rec_h, rec_w, present, photometries = \
                    lc_track_and_photometry(
                        movie_dev, h0, w0, phot.method,
                        search_radius=search_radius,
                        s_n_cutoff=s_n_cutoff,
                        photometry_radius=phot.radius,
                        photometry_brim=phot.brim_size,
                        photometry_min=photometry_min)
        else:
            with self._stage("api/run_timetrace/track"):
                rec_h, rec_w, present = lc_track(
                    movie_dev, h0, w0, search_radius=search_radius,
                    s_n_cutoff=s_n_cutoff, mesh=self.mesh)
            with self._stage("api/run_timetrace/photometry"):
                photometries = timetrace_photometries(
                    movie_dev, rec_h, rec_w, present, phot.method,
                    initial_fits=fits, photometry_radius=phot.radius,
                    photometry_brim=phot.brim_size,
                    photometry_min=photometry_min,
                    aperture_radius=phot.aperture_radius,
                    box_size=phot.box_size, filter_size=phot.filter_size)
        with self._stage("api/run_timetrace/stepfit"):
            results = stepfit_batched(photometries,
                                      mirror_start=mirror_start,
                                      chung_kennedy=chung_kennedy,
                                      p_threshold=p_threshold,
                                      window_radius=sf.window_radius,
                                      mesh=self.mesh)
        step_fits = {}
        intermediates = {}
        spot_traces = []
        for i, (hh, ww) in enumerate(zip(h0, w0)):
            hw = (hh, ww)
            if hw in step_fits:
                raise Exception("Two tracks have initial Spots with "
                                "identical (h, w).")
            phots, ck, plateaus, t_filtered = results[i]
            step_fits[hw] = PlateauTrace(t_filtered, hh, ww)
            intermediates[hw] = {
                "photometries": PhotometryTrace(phots, hh, ww),
                "ck_filtered_photometries": PhotometryTrace(ck, hh, ww),
                "plateaus": PlateauTrace(plateaus, hh, ww),
                "t_filtered_plateaus": PlateauTrace(t_filtered, hh, ww),
            }
            spot_traces.append(PhotometryTrace(
                tuple(float(v) for v in photometries[i]), hh, ww))
        if csv_path is not None:
            from .pipeline.experiment import TimetraceExperiment
            tte = TimetraceExperiment(
                frames=[None] * movie.shape[0], spot_traces=spot_traces,
                step_fits=step_fits, step_fit_intermediates=intermediates)
            tte.save_experiment_as_csv(
                csv_path, include_step_fits=include_step_fits,
                include_intermediates=include_intermediates,
                photometry_method=phot.method)
        return {"traces": {"h": h0, "w": w0, "present": present,
                           "rec_h": rec_h, "rec_w": rec_w},
                "photometries": photometries, "step_fits": step_fits,
                "step_fit_intermediates": intermediates,
                "trace_count": len(spot_traces), "csv_path": csv_path}

    def run_timetraces(self, movies, csv_paths=None, prefetch=None,
                       **kwargs):
        """Batch movie front door: run_timetrace over a SEQUENCE of
        movies (a TIRF session produces many movie fields).

        prefetch=True device_puts movie k+1 (raw camera dtype, async)
        while movie k computes, hiding its upload behind device work.
        On a slow serial link uploads and result fetches contend, and
        prefetch can lose. prefetch=None (default) asks the probe
        registry (utils/probes.timetrace_prefetch): prefetch turns on at
        >= 400 MB/s measured upload bandwidth.

        Arguments:
            movies: iterable of [T, H, W] arrays (dtypes may differ).
            csv_paths: optional list, one output CSV path per movie.
            prefetch: upload one movie ahead of compute (None = probed).
            kwargs: forwarded to run_timetrace.

        Returns a list of run_timetrace result dicts, in order.
        """
        import jax.numpy as jnp

        if prefetch is None:
            from .utils import probes

            prefetch = probes.timetrace_prefetch()
        if "csv_path" in kwargs:
            raise TypeError(
                "run_timetraces takes csv_paths (one per movie), "
                "not csv_path")
        movies = [_normalize_stack(m) for m in movies]
        if csv_paths is not None and len(csv_paths) != len(movies):
            raise ValueError("csv_paths must have one entry per movie")
        outs = []
        dev = None
        if prefetch and movies:
            dev = jnp.asarray(movies[0])
        for i in range(len(movies)):
            cur = dev if dev is not None else movies[i]
            if prefetch:
                dev = (jnp.asarray(movies[i + 1])
                       if i + 1 < len(movies) else None)
            outs.append(self.run_timetrace(
                cur, csv_path=None if csv_paths is None else csv_paths[i],
                **kwargs))
        return outs

    def run_files(self, paths_by_cycle, **kwargs):
        """Like run_stack, from image files: paths_by_cycle is a list (per
        cycle) of lists (per field) of image paths."""
        from .utils.imageio import read_image_array
        cycles = [[read_image_array(p) for p in cycle]
                  for cycle in paths_by_cycle]
        n_fields = {len(c) for c in cycles}
        if len(n_fields) != 1:
            raise ValueError("every cycle must have the same field count")
        stack = np.stack([np.stack(c) for c in cycles], axis=1)
        return self.run_stack(stack, **kwargs)

    # -- traces --------------------------------------------------------------

    def stepfit(self, photometries):
        """Batched step fitting over an (N, T) photometry array.

        Returns a list of N (photometries, ck_filtered, plateaus,
        t_filtered_plateaus) tuples (ops.stepfit_batch.stepfit_batched).
        """
        from .ops.stepfit_batch import stepfit_batched
        sf = self.config.stepfit
        with self._stage("api/stepfit"):
            return stepfit_batched(np.asarray(photometries, np.float64),
                                   mirror_start=sf.mirror_start,
                                   chung_kennedy=sf.chung_kennedy,
                                   p_threshold=sf.p_threshold,
                                   window_radius=sf.window_radius,
                                   mesh=self.mesh)

    def chi_squared_stepfit(self, photometries, num_steps_multiplier=1,
                            num_steps=None, min_step_length=2,
                            min_step_magnitude=0.0,
                            ignore_counterfits=False):
        """Batched Kerssemakers chi-squared step fitting over an (N, T)
        photometry array (the reference's alternative step-fit method,
        stepfitting_library.py:342-505). Returns a list of N step fits
        (plateau-triple lists), bit-equal per trace to
        stepfitting.chi_squared_step_fitter; the native core threads the
        batch (stepfitting.chi_squared_fit_batch)."""
        from .stepfitting import chi_squared_fit_batch

        with self._stage("api/chi_squared_stepfit"):
            return chi_squared_fit_batch(
                np.asarray(photometries, np.float64),
                num_steps_multiplier=num_steps_multiplier,
                num_steps=num_steps, min_step_length=min_step_length,
                min_step_magnitude=min_step_magnitude,
                ignore_counterfits=ignore_counterfits)

    # -- inference -----------------------------------------------------------

    def fluor_counts(self, tracks, beta, beta_sigma, quench_factors=None,
                     alpha_adjust=0.0, **kwargs):
        """v8 lognormal fluor counting.

        ``tracks`` is a track-CSV path (dict-free native ingestion) or a
        photometries dict. Returns (signals, total, none_count, fit_info).
        """
        ln = self.config.lognormal
        if quench_factors is None:
            # config.lognormal.quench_factors when set, else no quenching
            # (the reference's quench_factor=0 default).
            quench_factors = (tuple(ln.quench_factors) or
                              (0.0,) * (ln.max_possible + 2))
        # mesh=None in kwargs opts out of mesh sharding; default is the
        # session mesh, resolved LAZILY so an explicit opt-out never
        # triggers device discovery.
        mesh = kwargs.pop("mesh", _SESSION_MESH)
        if mesh is _SESSION_MESH:
            mesh = self.mesh
        with self._stage("api/fluor_counts"):
            if isinstance(tracks, str):
                from .inference.lognormal import lognormal_fit_v8_from_csv
                return lognormal_fit_v8_from_csv(
                    tracks, beta, beta_sigma,
                    max_possible=ln.max_possible,
                    allow_upsteps=ln.allow_upsteps,
                    allow_multidrop=ln.allow_multidrop,
                    max_deviation=(ln.max_deviation
                                   if ln.max_deviation is not None else 3),
                    quench_factors=quench_factors,
                    alpha_adjust=alpha_adjust, mesh=mesh, **kwargs)
            from .inference.lognormal import photometries_lognormal_fit_v8
            if kwargs:
                # The remaining kwargs are CSV-reader options
                # (downstep_filtered, head/tail_truncate); silently
                # dropping them against a dict would fit different data
                # than the caller asked for.
                raise TypeError(
                    "fluor_counts with a photometries dict accepts no "
                    "CSV-reader options: " + ", ".join(sorted(kwargs)))
            if alpha_adjust:
                from .inference.photometries import (
                    alpha_adjust_photometries)
                tracks = alpha_adjust_photometries(tracks, alpha_adjust)
            return photometries_lognormal_fit_v8(
                tracks, beta, beta_sigma, max_possible=ln.max_possible,
                allow_upsteps=ln.allow_upsteps,
                allow_multidrop=ln.allow_multidrop,
                max_deviation=(ln.max_deviation
                               if ln.max_deviation is not None else 3),
                quench_factors=quench_factors, mesh=mesh)

    def fluor_counts_calibrated(self, tracks, channel="ch1", beta=None,
                                beta_sigma=0.2, truncate=0, ddif=0.0,
                                max_possible=5, allow_multidrop=True,
                                adjustment=True):
        """Auto-calibrated v8 fluor counting: the lognormal_fitter_v2
        flow (lognormal_fitter_v2.py:119-212 in the reference) on the
        batched matmul scorer.

        alpha comes from the first-two-mode histogram separation
        (_get_m0Dm1[7]); beta from the last-drop method v2 on the
        truncated alpha-adjusted photometries; an optional ON/OFF
        re-adjustment pass (grab_ON_OFFS -> ON_OFF_adjust_photometries)
        recalibrates before the final fit. Passing ``beta`` pins it (the
        reference's --beta override). Like the reference, BOTH fits use
        the caller's ``beta_sigma`` (default 0.2) — the last-drop sigma
        estimates are derived but never fed into the fit
        (lognormal_fitter_v2.py:199-212); they are reported in the
        calibration dict as beta_sigma_estimate / original_beta_sigma.

        Returns (signals, total_count, none_count, all_fit_info,
        calibration) where calibration = {alpha, beta, beta_sigma (the
        value the fits used), beta_sigma_estimate, original_beta,
        original_beta_sigma}.
        """
        from collections import defaultdict

        from .inference.calibration import _get_m0Dm1, last_drop_method_v2
        from .inference.lognormal import photometries_lognormal_fit_v8
        from .inference.photometries import (read_track_photometries_csv,
                                             unwind_photometries)
        from . import notebook as jd

        with self._stage("api/fluor_counts_calibrated"):
            if isinstance(tracks, str):
                photometries, _ = read_track_photometries_csv(
                    tracks, head_truncate=0, tail_truncate=0,
                    downstep_filtered=True, channels=[channel])
            else:
                photometries = tracks
            raw = tuple(i for (_, _, _, _, _, ints, _)
                        in unwind_photometries(photometries)
                        for i in ints)
            alpha = _get_m0Dm1(raw_photometries=raw,
                               optimal_bin_number=None)[7]
            alpha_adjusted = defaultdict(dict)
            truncated = defaultdict(dict)
            for (ch, field, h, w, category, ints,
                 row) in unwind_photometries(photometries):
                adj = tuple(i - alpha for i in ints)
                (alpha_adjusted[ch].setdefault(field, {})
                 .setdefault((h, w), (category, adj, row)))
                (truncated[ch].setdefault(field, {})
                 .setdefault((h, w), (category[truncate:], ints[truncate:],
                                      row)))
            original_beta, original_bs = last_drop_method_v2(
                photometries=dict(truncated))
            if beta is not None:
                original_beta = beta
            quench = tuple([0.0] + [ddif] * (max_possible + 1))
            first = photometries_lognormal_fit_v8(
                dict(alpha_adjusted), original_beta, beta_sigma,
                max_possible=max_possible, allow_upsteps=False,
                allow_multidrop=allow_multidrop, max_deviation=3,
                quench_factors=quench, mesh=self.mesh)
            on_offs = jd.grab_ON_OFFS(first[3], alpha_adjust=0)
            if adjustment:
                # Unconditional like the reference
                # (lognormal_fitter_v2.py:186-191): with empty ON_OFFS
                # the adjuster's per-cycle dict never matches, so the
                # RAW intensities feed the final beta estimate + fit.
                adj_photometries = jd.ON_OFF_adjust_photometries(
                    photometries=photometries, ON_OFFS=on_offs, alpha=alpha)
            else:
                adj_photometries = dict(alpha_adjusted)
            adj_beta, adj_bs = last_drop_method_v2(
                photometries=adj_photometries)
            if beta is not None:
                adj_beta = beta
            signals, total, none_count, fit_info = \
                photometries_lognormal_fit_v8(
                    adj_photometries, adj_beta, beta_sigma,
                    max_possible=max_possible, allow_upsteps=False,
                    allow_multidrop=allow_multidrop, max_deviation=3,
                    quench_factors=quench, mesh=self.mesh)
        # Faithful to lognormal_fitter_v2.py:199-212: BOTH fits use the
        # caller's beta_sigma; last_drop_method_v2's sigma estimates are
        # derived but never fed back. Report the estimate separately so
        # the record is honest about which value the fit actually used.
        calibration = {"alpha": float(alpha), "beta": float(adj_beta),
                       "beta_sigma": float(beta_sigma),
                       "beta_sigma_estimate": float(adj_bs),
                       "original_beta": float(original_beta),
                       "original_beta_sigma": float(original_bs)}
        return signals, total, none_count, fit_info, calibration

    def per_cycle_gmm(self, photometries, min_fluors=1, max_fluors=5,
                      n_init=10, n_iter=100, cycles=None, lower_bound=None,
                      seed=0):
        """BIC-selected per-cycle intensity GMMs, every (cycle,
        component-count, restart) model fitted in ONE batched device
        program (ops/gmm_batch.py) — the batched form of the
        reference's nested Pool fan-out (_per_cycle_gmm_MP,
        MCsimlib.py:3307-3375). Returns (all_fit_scores, all_fits,
        raw_photometries) in the reference's structure, with
        BatchedGMM1D fits (means_/covars_/weights_/bic)."""
        from .inference.gmm import per_cycle_gmm_batched
        with self._stage("api/per_cycle_gmm"):
            return per_cycle_gmm_batched(
                photometries, min_fluors=min_fluors, max_fluors=max_fluors,
                n_init=n_init, n_iter=n_iter, cycles=cycles,
                lower_bound=lower_bound, seed=seed, mesh=self.mesh)

    # -- simulation ----------------------------------------------------------

    def simulate_signals(self, peptides, p, b, u, windows, sample_size=100,
                         random_seed=None):
        """Monte-Carlo signal trie (native C++ sampler when available).

        Availability is probed explicitly (``have_native()``) rather than
        by catching exceptions from the native call: a runtime error from
        the native sampler is a real bug/input problem and must surface,
        not silently rerun on the Python fallback with a different RNG
        stream."""
        with self._stage("api/simulate_signals"):
            try:
                from .native import have_native, monte_carlo_trie_native
            except ImportError:
                have_native = None
            if have_native is not None and have_native():
                return monte_carlo_trie_native(
                    peptides, p, b, u, windows, sample_size=sample_size,
                    random_seed=random_seed)
            from .sim.signals import monte_carlo_trie
            return monte_carlo_trie(peptides, p, b, u, windows,
                                    sample_size=sample_size,
                                    random_seed=random_seed)

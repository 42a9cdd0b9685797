"""Multi-host (DCN) scaling: one experiment sharded across processes.

The reference is strictly single-node — its entire distributed story is
``multiprocessing.Pool`` with pickle IPC (/root/reference/pflib.py:1000-1111
and SURVEY section 2.4), and the one place cross-process state would be
needed is explicitly unimplemented
(/root/reference/flexlibrary.py:2673-2689). Here the story beyond one
GPU host is multi-process SPMD: every host runs THIS SAME program,
contributes the fields it loaded locally, and ``jax.distributed`` + GSPMD
execute the one sharded experiment step over the global ('data', 'model')
mesh. Fields are purely data-parallel, so the only inter-host (DCN) traffic
is the coordination handshake and the final result gather — the hot compute
and the fit-stage reshard stay on each host's GPUs (NVLink within a host).

Usage — identical on every host::

    from fluorosequencingimageanalysis_tpu.parallel import multihost

    multihost.initialize(coordinator_address="host0:1234",
                         num_processes=2, process_id=rank)
    local_fields = load_my_shard()          # [F_local, C, H, W]
    out = multihost.run_experiment_step(local_fields, max_candidates=256)
    # out: host-replicated dict of np arrays over ALL processes' fields,
    # in process order.

Tested end-to-end with real multi-process execution (Gloo collectives over
two 4-virtual-device CPU processes) in tests/test_multihost.py; on GPU
hosts the same code path runs with NCCL collectives. A GPU cluster that
no scheduler describes needs the explicit coordinator address, process
count and process id.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import experiment_step_sharded, make_mesh

_INITIALIZED = False


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """Join this process to a multi-host JAX cluster (idempotent).

    With no arguments, ``jax.distributed.initialize`` auto-detects the
    cluster from the environment where a scheduler describes one (SLURM,
    for example). Explicit arguments support every other cluster: plain
    GPU hosts, and the CPU test cluster.
    Safe to call when already initialized or when single-process.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    # Already initialized by the host program (a launcher, another
    # library): a plain no-op. is_initialized() is safe pre-XLA.
    if jax.distributed.is_initialized():
        _INITIALIZED = True
        return
    # NOTE: no jax.* backend queries before this call — jax.distributed
    # must run before anything initializes XLA (even jax.process_count()).
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id,
            local_device_ids=local_device_ids)
    except ValueError:
        # Auto-detect found no cluster (jax raises
        # "coordinator_address should be defined"): on a plain
        # single-process machine that IS the promised no-op. ANY explicit
        # argument means the caller intended a real cluster (e.g.
        # process_id given but coordinator_address forgotten) — swallowing
        # that would silently degrade a multi-host launch into independent
        # single-process runs with host-divergent results.
        if (coordinator_address is not None or num_processes is not None
                or process_id is not None or local_device_ids is not None):
            raise
    _INITIALIZED = True


def global_mesh(data_axis=None, model_axis=None):
    """A ('data', 'model') mesh over ALL devices of ALL processes.

    ``jax.devices()`` is already cluster-global after ``initialize()``, so
    this is ``make_mesh`` with the multi-host contract documented: device
    order groups each process's local devices together, which is what maps
    each process's locally-contributed fields onto its own chips in
    :func:`shard_fields_from_local`.
    """
    return make_mesh(data_axis=data_axis, model_axis=model_axis)


def shard_fields_from_local(local_stack, mesh):
    """Build one global [F_global, ...] array from per-process field shards.

    Every process passes its own ``[F_local, ...]`` block (equal F_local on
    all processes); the result is a global ``jax.Array`` whose leading axis
    is sharded on the mesh's 'data' axis, with each process's fields
    resident on its own devices — no data moves over DCN.
    """
    local_stack = np.asarray(local_stack)
    spec = P("data", *([None] * (local_stack.ndim - 1)))
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local_stack)


def allgather(tree):
    """Replicate a (possibly non-addressable) sharded result on every host.

    Returns NumPy arrays; this is the one DCN-wide data movement of the
    pipeline — the reduced per-spot results, not the raw frames.
    """
    from jax.experimental import multihost_utils
    return multihost_utils.process_allgather(tree, tiled=True)


def _allgather_pickled(obj):
    """Allgather one Python object per process (pickle -> padded uint8
    rows -> one DCN allgather); returns the per-process list in process
    order. Used for the per-field row payloads — kilobytes, not frames."""
    import pickle

    from jax.experimental import multihost_utils

    payload = np.frombuffer(pickle.dumps(obj, protocol=4), np.uint8)
    nproc = jax.process_count()
    if nproc == 1:
        return [obj]
    lens = np.asarray(
        multihost_utils.process_allgather(np.int64(payload.size)))
    padded = np.zeros(int(lens.max()), np.uint8)
    padded[:payload.size] = payload
    stacked = np.asarray(
        multihost_utils.process_allgather(padded, tiled=False))
    return [pickle.loads(stacked[p, :int(lens[p])].tobytes())
            for p in range(nproc)]


def run_experiment(local_stacks, csv_path=None, config=None, mesh=None,
                   max_candidates=None, max_spots=None, candidate_radius=2,
                   channel="ch1"):
    """Whole-experiment multihost front door (the basic_experiment_script
    configuration: interpolate=True, no MDMA/averages/keep_invalid).

    ``local_stacks``: this process's ``[F_local, C, H, W]`` fields —
    one array (channel name from ``channel``) or a dict
    ``{channel: [F_local, C, H, W]}`` like ``Pipeline.run_experiment``.

    1. ONE sharded experiment step per channel runs over the global
       mesh — every process's locally-loaded fields stay on its own
       chips (:func:`run_experiment_step`);
    2. the HOST layer (psfs-dict reconstruction, tracking, trace
       interpolation, photometry reuse + hole gathers) runs per process
       for its OWN fields — frames never cross DCN;
    3. the per-field row payloads allgather (kilobytes), so EVERY host
       assembles the full row set in channel order / global field order
       and, when ``csv_path`` is given, writes an identical
       track-photometries CSV (the reference's output contract,
       flexlibrary.py:2755-2892).

    Byte-identical to a single-process ``Pipeline.run_experiment`` over
    the concatenated stacks when mesh shapes match — proven with real
    two-process execution in tests/test_multihost.py.

    Returns {rows, category_counts, filtered_category_counts, csv_path}.
    """
    from ..api import Pipeline
    from ..pipeline.fast_experiment import (_spot_lists, flush_hole_queue,
                                            run_experiment_stack)

    if not isinstance(local_stacks, dict):
        local_stacks = {channel: local_stacks}
    local_stacks = {ch: np.asarray(s) for ch, s in local_stacks.items()}
    for ch, s in local_stacks.items():
        if s.ndim != 4:
            raise ValueError(
                f"channel {ch!r}: local stack must be [F_local, C, H, W]")
    cycle_counts = {s.shape[1] for s in local_stacks.values()}
    if len(cycle_counts) != 1:
        raise ValueError("every channel must have the same cycle count "
                         f"(got {sorted(cycle_counts)})")
    n_cycles = cycle_counts.pop()
    field_counts = {s.shape[0] for s in local_stacks.values()}
    if len(field_counts) != 1:
        # The global field indexing below (lo = pid * f_local and the
        # category_counts field range) assumes ONE local field count
        # across channels; a mismatch would mis-index rows after all the
        # device work completed.
        raise ValueError("every channel must have the same local field "
                         f"count (got {sorted(field_counts)})")
    pipe = Pipeline(config=config)
    det = pipe.config.detect
    reg = pipe.config.registration
    phot = pipe.config.photometry
    mc = max_candidates if max_candidates is not None else det.max_candidates
    step_kwargs = dict(
        median_filter_size=det.median_filter_size, c_std=det.c_std,
        r_2_threshold=det.r_2_threshold,
        consolidation_radius=det.consolidation_radius,
        max_candidates=mc, max_spots=max_spots,
        num_iters=det.num_iters, theta_starts=det.theta_starts,
        upsample_factor=reg.upsample_factor,
        photometry_method=pipe._device_phot_method(),
        photometry_radius=phot.radius, photometry_brim=phot.brim_size,
        photometry_min=None)
    if mesh is None:
        mesh = global_mesh()
    host_phot = phot.method == "sextractor"
    keys = ("offsets_h", "offsets_w", "spot_rh", "spot_rw", "spot_state",
            "spot_cand_c", "spot_overflow", "cand_count") + \
        (() if host_phot else ("photometry",))

    pid = jax.process_index()
    rows_local_by_ch = {}
    n_fields_global = None
    import logging

    for ch, local in local_stacks.items():
        gathered = run_experiment_step(local, mesh=mesh, gather=True,
                                       keys=keys, **step_kwargs)
        # Bucket overflow must be LOUD here like in the single-process
        # front door (api.run_experiment) — truncation would otherwise
        # silently drop rows from the "byte-identical" CSV.
        n_over = int(np.asarray(gathered["spot_overflow"]).sum())
        if n_over:
            logging.getLogger(__name__).warning(
                "multihost.run_experiment[%s]: %d (field, cycle) images "
                "overflowed the max_spots bucket — their lowest-R^2 "
                "spots were dropped; raise max_spots for complete "
                "tracking", ch, n_over)
        n_cand_over = int((np.asarray(gathered["cand_count"]) > mc).sum())
        if n_cand_over:
            logging.getLogger(__name__).warning(
                "multihost.run_experiment[%s]: %d (field, cycle) images "
                "found more than max_candidates=%d peaks — the weakest-"
                "correlation candidates were dropped; raise "
                "max_candidates for exhaustive coverage", ch,
                n_cand_over, mc)
        f_local = local.shape[0]
        lo = pid * f_local
        n_fields_global = f_local * jax.process_count()
        local_out = {k: v[lo:lo + f_local] for k, v in gathered.items()}
        Fg, C, H, W = local.shape
        rhs, rws, spot_values = _spot_lists(local_out, Fg, C, H, W,
                                            with_values=not host_phot)
        hole_queue = [] if not host_phot else None
        per_field = run_experiment_stack(
            local, local_out["offsets_h"], local_out["offsets_w"],
            (rhs, rws),
            photometry_method=phot.method, photometry_radius=phot.radius,
            photometry_brim=phot.brim_size,
            candidate_radius=candidate_radius,
            spot_values=None if host_phot else spot_values,
            aperture_radius=phot.aperture_radius, box_size=phot.box_size,
            filter_size=phot.filter_size, hole_queue=hole_queue)
        if hole_queue:
            flush_hole_queue(hole_queue)
        ch_rows = []
        for f, field_rows in enumerate(per_field):
            for (cat, h0, w0, ph) in field_rows:
                ch_rows.append((ch, lo + f, h0, w0, cat, ph))
        rows_local_by_ch[ch] = ch_rows

    # One allgather of the whole per-channel payload; rows assemble in
    # channel order, then process (= global field) order — the same
    # iteration Pipeline.run_experiment produces.
    all_payloads = _allgather_pickled(rows_local_by_ch)
    rows = []
    for ch in local_stacks:
        for proc_payload in all_payloads:
            rows.extend(proc_payload[ch])
    category_counts = {ch: {f: {} for f in range(n_fields_global)}
                       for ch in local_stacks}
    for (ch, f, h0, w0, cat, ph) in rows:
        category_counts[ch][f].setdefault(cat, 0)
        category_counts[ch][f][cat] += 1
    from ..pipeline.fast_experiment import (filter_monotone_categories,
                                            write_track_rows_csv)

    filtered = filter_monotone_categories(category_counts)
    if csv_path is not None:
        # The SAME writer as api.run_experiment — byte-identity between
        # the multihost and single-process CSVs holds by construction.
        write_track_rows_csv(rows, n_cycles, csv_path)
    return {"rows": rows, "category_counts": category_counts,
            "filtered_category_counts": filtered, "csv_path": csv_path}


def run_timetrace(movie, csv_path=None, config=None, mesh=None,
                  search_radius=3, s_n_cutoff=3.0, max_candidates=None,
                  photometry_min="config", mirror_start=None,
                  chung_kennedy=None, p_threshold=None,
                  include_step_fits=True, include_intermediates=True):
    """Whole-movie multihost front door — the timetrace workflow
    (basic_timetrace_script.py; flexlibrary.py:3266-3709) across
    processes.

    Every process passes the SAME ``[T, H, W]`` movie (one continuously
    filmed field — replicated per process, like :func:`lc_track`'s
    layout). Flow:

    1. frame-0 detection runs on each process's local devices; process
       0's spot list is then broadcast to all (one kilobyte-scale DCN
       allgather), so cross-host float nondeterminism can never fork the
       sharded tracker's inputs;
    2. LC tracking shards the SPOT axis over the global mesh
       (:func:`lc_track`); tracked positions replicate to every host;
    3. per-trace photometry and the batched step-fit chain (CK ->
       sliding-t -> refit -> t-merge) run per process on its CONTIGUOUS
       spot share only, against its local movie copy — pure data
       parallelism over traces (SURVEY P2), frames never cross DCN;
    4. the per-share products allgather (kilobytes), every host
       assembles the full trace set in global spot order and, when
       ``csv_path`` is given, writes an identical
       ``save_experiment_as_csv`` CSV — the reference's whole-experiment
       movie output contract (flexlibrary.py:3550-3709, plateau-start
       caching included via the class writer).

    Byte-identical to a single-process ``Pipeline.run_timetrace`` —
    proven with real two-process execution in tests/test_multihost.py.

    Returns the ``Pipeline.run_timetrace`` result dict (traces,
    photometries, step_fits, step_fit_intermediates, trace_count,
    csv_path).
    """
    from ..api import Pipeline, _normalize_stack
    from ..models.detect import find_peptide_centers
    from ..ops.stepfit_batch import stepfit_batched
    from ..pipeline.fast_timetrace import timetrace_photometries
    from ..pipeline.traces import PhotometryTrace, PlateauTrace

    pipe = Pipeline(config=config)
    det = pipe.config.detect
    phot = pipe.config.photometry
    sf = pipe.config.stepfit
    mirror_start = (sf.mirror_start if mirror_start is None
                    else mirror_start)
    chung_kennedy = (sf.chung_kennedy if chung_kennedy is None
                     else chung_kennedy)
    p_threshold = sf.p_threshold if p_threshold is None else p_threshold
    if isinstance(photometry_min, str):  # the "config" sentinel
        photometry_min = phot.photometry_min

    movie = _normalize_stack(movie)
    movie = np.asarray(movie)
    if movie.ndim != 3:
        raise ValueError("movie must be [frames, H, W]")
    import jax.numpy as jnp
    movie_dev = jnp.asarray(movie)
    if movie_dev.dtype != jnp.float32:
        movie_dev = movie_dev.astype(jnp.float32)

    # 1. frame-0 detect (local devices), process 0's list wins.
    h0_l, w0_l, fits_l, _count = find_peptide_centers(
        movie_dev[0],
        median_filter_size=det.median_filter_size, c_std=det.c_std,
        r_2_threshold=det.r_2_threshold,
        consolidation_radius=det.consolidation_radius,
        max_candidates=(max_candidates if max_candidates is not None
                        else det.single_field_cap),
        num_iters=det.num_iters)
    h0, w0, fits = _allgather_pickled((h0_l, w0_l, fits_l))[0]
    N = len(h0)
    if N == 0:
        if csv_path is not None:
            from ..pipeline.experiment import TimetraceExperiment
            TimetraceExperiment(
                frames=[None] * movie.shape[0], spot_traces=[],
                step_fits={}, step_fit_intermediates={}
            ).save_experiment_as_csv(
                csv_path, include_step_fits=include_step_fits,
                include_intermediates=None,
                photometry_method=phot.method)
        return {"traces": {"h": [], "w": [], "present": None,
                           "rec_h": None, "rec_w": None},
                "photometries": np.zeros((0, movie.shape[0])),
                "step_fits": {}, "step_fit_intermediates": {},
                "trace_count": 0, "csv_path": csv_path}

    # 2. spot axis over the global mesh.
    rec_h, rec_w, present = lc_track(movie, h0, w0,
                                     search_radius=search_radius,
                                     s_n_cutoff=s_n_cutoff, mesh=mesh)

    # 3. this process's contiguous spot share.
    nproc = jax.process_count()
    pidx = jax.process_index()
    share = -(-N // nproc)
    lo, hi = pidx * share, min(N, (pidx + 1) * share)
    phot_local = timetrace_photometries(
        movie_dev, rec_h[:, lo:hi], rec_w[:, lo:hi], present[:, lo:hi],
        phot.method, initial_fits=[fits[i] for i in range(lo, hi)],
        photometry_radius=phot.radius, photometry_brim=phot.brim_size,
        photometry_min=photometry_min,
        aperture_radius=phot.aperture_radius, box_size=phot.box_size,
        filter_size=phot.filter_size)
    results_local = stepfit_batched(phot_local, mirror_start=mirror_start,
                                    chung_kennedy=chung_kennedy,
                                    p_threshold=p_threshold,
                                    window_radius=sf.window_radius)

    # 4. kilobyte-scale product allgather; global spot order.
    parts = _allgather_pickled((phot_local, results_local))
    photometries = np.concatenate(
        [p[0] for p in parts if p[0].shape[0]], axis=0)
    results = []
    for p in parts:
        results.extend(p[1])

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
        from ..pipeline.experiment import TimetraceExperiment
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


def lc_track(movie, h0, w0, search_radius=3, s_n_cutoff=3.0, mesh=None):
    """Multihost LC tracking (the timetrace front door's sharded tracker,
    pipeline/fast_timetrace.lc_track, over a MULTI-PROCESS mesh).

    Every process passes the SAME movie (replicated onto its own chips —
    movies are one field, small) and the SAME full spot list; the spot
    axis shards over the global mesh's first axis (pure data parallelism,
    SURVEY P2), and the tracked [T, N] results allgather to every host.
    Bit-equal to the single-process scan (tests/test_multihost.py).
    """
    from ..pipeline import fast_timetrace as ftt

    if mesh is None:
        mesh = global_mesh()
    axis = mesh.axis_names[0]
    n_shard = int(mesh.shape[axis])
    t0h, t0w, r0h, r0w = ftt._initial_centers(h0, w0)
    N = len(t0h)
    pad = (-N) % n_shard
    fill = np.full(pad, search_radius + 2, np.int32)
    padded = [np.concatenate([a, fill]) for a in (t0h, t0w, r0h, r0w)]
    row = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    nproc = jax.process_count()
    pidx = jax.process_index()
    share = (N + pad) // nproc

    def shard_rows(a):
        return jax.make_array_from_process_local_data(
            row, a[pidx * share:(pidx + 1) * share], a.shape)

    movie_np = np.asarray(movie)
    movie_g = jax.make_array_from_process_local_data(rep, movie_np,
                                                     movie_np.shape)
    rec_h, rec_w, present = ftt._lc_track_scan(
        movie_g, *[shard_rows(a) for a in padded],
        search_radius=search_radius, s_n_cutoff=float(s_n_cutoff))
    g = allgather((rec_h, rec_w, present))
    rec_h = np.concatenate([padded[0][None], np.asarray(g[0])])[:, :N]
    rec_w = np.concatenate([padded[1][None], np.asarray(g[1])])[:, :N]
    present = np.concatenate([np.ones((1, N + pad), bool),
                              np.asarray(g[2])])[:, :N]
    return rec_h, rec_w, present


def stack_background(local_frames, box_size=10, filter_size=10,
                     clip_sigma=3.0, clip_maxiters=10, mesh=None):
    """Multihost z-stack SExtractor background (ops/background, BASELINE
    config 2) — each process contributes its locally-loaded frames, the
    frame axis shards over the global mesh, and the background maps
    allgather back in process order (padding removed)."""
    from ..ops.background import stack_background_jit

    local = np.asarray(local_frames)
    if mesh is None:
        mesh = global_mesh()
    axis = mesh.axis_names[0]
    nproc = jax.process_count()
    n_dev = int(mesh.shape[axis])
    share = n_dev // nproc
    f_local = local.shape[0]
    pad = (-f_local) % share
    if pad:
        local = np.concatenate([local, np.repeat(local[-1:], pad, axis=0)])
    spec = NamedSharding(mesh, P(axis, None, None))
    T_global = local.shape[0] * nproc
    x = jax.make_array_from_process_local_data(
        spec, local, (T_global,) + local.shape[1:])
    out = stack_background_jit(x, box_size=box_size,
                               filter_size=filter_size,
                               clip_sigma=float(clip_sigma),
                               clip_maxiters=int(clip_maxiters))
    g = np.asarray(allgather(out))
    f_padded = f_local + pad
    keep = np.concatenate([np.arange(p * f_padded, p * f_padded + f_local)
                           for p in range(nproc)])
    return g[keep]


def run_experiment_step(local_fields, mesh=None, gather=True, keys=None,
                        **step_kwargs):
    """Run the sharded experiment step over every process's fields.

    Args:
        local_fields: this process's ``[F_local, C, H, W]`` stack (raw
            camera dtypes welcome — cast happens on device). F_local must
            be the same on every process.
        mesh: a global mesh from :func:`global_mesh` (default: all devices
            to 'data').
        gather: when True (default) the per-field results are replicated to
            every host as NumPy arrays, padding removed, fields in process
            order. When False the raw global sharded dict is returned
            (leading axis includes per-process padding).
        **step_kwargs: forwarded to
            :func:`..mesh.experiment_step_sharded`.

    Data-axis padding: the 'data' axis needs the global field count to
    split evenly, so each process zero-pads its block to the next multiple
    of its data-axis share; padded rows are dropped again after the gather.
    """
    local = np.asarray(local_fields)
    if mesh is None:
        mesh = global_mesh()
    nproc = jax.process_count()
    n_data = mesh.shape["data"]
    if n_data % nproc:
        raise ValueError(
            f"data axis ({n_data}) must be a multiple of the process count "
            f"({nproc}) so every process owns whole data-axis shards")
    share = n_data // nproc
    f_local = local.shape[0]
    if nproc > 1:
        # The keep-index math below assumes every process contributed the
        # SAME field count; a mismatch that still lands on a consistent
        # global shape would return silently wrong, host-divergent rows.
        # One tiny DCN allgather turns that into a loud error.
        from jax.experimental import multihost_utils
        counts = np.asarray(
            multihost_utils.process_allgather(np.int64(f_local)))
        if not (counts == f_local).all():
            raise ValueError(
                "run_experiment_step needs the same F_local on every "
                f"process; got per-process field counts {counts.tolist()}")
    pad = (-f_local) % share
    if pad:
        local = np.concatenate(
            [local, np.zeros((pad,) + local.shape[1:], local.dtype)])
    x = shard_fields_from_local(local, mesh)
    with mesh:
        out = experiment_step_sharded(x, mesh, **step_kwargs)
    if keys is not None:
        # Gather only what the caller consumes (the compact spot bucket
        # is KBs; the full fit arrays are the big ones).
        out = {k: out[k] for k in keys}
    if not gather:
        return out
    gathered = allgather(out)
    f_padded = f_local + pad
    if pad:
        keep = np.concatenate([np.arange(p * f_padded, p * f_padded + f_local)
                               for p in range(nproc)])
        gathered = {k: np.asarray(v)[keep] for k, v in gathered.items()}
    else:
        gathered = {k: np.asarray(v) for k, v in gathered.items()}
    return gathered

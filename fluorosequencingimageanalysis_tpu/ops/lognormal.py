"""Batched lognormal fluor-count sequence scoring (the "v8" fitter core).

The reference scores every monotone (non-increasing) fluor-count sequence
against a trace's per-cycle log-intensities with a product of normal pdfs,
one spot at a time in a Pool worker
(/root/reference/MCsimlib.py:5387-5493, _intensities_to_signal_lognormal_v8;
enumeration cost C(n_cycles + max_fluors, n_cycles) per trace).

Design: the sequence set depends only on (n_cycles, max_fluors), so it
is enumerated ONCE into a static table and every trace scores every sequence
in a single matmul:

  contrib[t, f, v]  per-trace/frame/fluor-value log-pdf contributions
  M[f*(K+1)+v, s]   0/1 membership of value v at frame f in sequence s
  scores = contrib.reshape(T, F*(K+1)) @ M          # (T, S)

Validity (category consistency, multidrop, max-deviation) rides the same
matmul as a violation count. Scoring is done in log space — argmax is
unchanged, and ties resolve to the first enumerated sequence exactly like
the reference's strict ``>`` update.
"""

from __future__ import annotations

import functools
import itertools
import math

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
import numpy as np

_TABLE_CACHE = {}


def sequence_table(n_frames: int, max_value: int,
                   allow_upsteps: bool = False) -> np.ndarray:
    """(S, n_frames) int32 table of candidate fluor-count sequences, in the
    reference's enumeration order (MCsimlib.py:5426-5431)."""
    key = (n_frames, max_value, allow_upsteps)
    if key not in _TABLE_CACHE:
        values = list(reversed(range(max_value + 1)))
        if allow_upsteps:
            n_seqs = (max_value + 1) ** n_frames
            if n_seqs > 2_000_000:
                raise ValueError(
                    f"allow_upsteps with {n_seqs} sequences is intractable "
                    "(the reference would enumerate the same count).")
            seqs = itertools.product(values, repeat=n_frames)
        else:
            seqs = itertools.combinations_with_replacement(values, n_frames)
        _TABLE_CACHE[key] = np.array(list(seqs), dtype=np.int32)
    return _TABLE_CACHE[key]


@functools.partial(jax.jit, static_argnames=("allow_multidrop",))
def _score_batch(log_intensities, categories, seq_tab, log_fluor_means,
                 beta_sigma, max_deviation, allow_multidrop):
    """Score all sequences for a batch of traces.

    log_intensities: (T, F) float32 (log of adjusted intensities; <=0
        intensities encoded as -10000 like the reference, MCsimlib.py:5423).
    categories: (T, F) bool.
    seq_tab: (S, F) int32.
    log_fluor_means: (Kmax,) float32, entry v-1 is the mean for value v.

    Returns (best_idx (T,), found (T,), best_logscore (T,)).
    """
    T, F = log_intensities.shape
    S = seq_tab.shape[0]
    K = int(log_fluor_means.shape[0])  # values 1..K usable
    nv = K + 1                         # values 0..K

    # Per-(trace, frame, value) log-pdf contributions; value 0 scores
    # log(1.0) = 0 (MCsimlib.py:5455-5459).
    x = log_intensities[:, :, None]                       # (T, F, 1)
    mu = log_fluor_means[None, None, :]                   # (1, 1, K)
    dev = jnp.abs(x - mu) / beta_sigma                    # (T, F, K)
    log_norm = -jnp.log(beta_sigma * jnp.sqrt(2.0 * jnp.pi))
    logpdf = log_norm - 0.5 * ((x - mu) / beta_sigma) ** 2
    contrib = jnp.concatenate(
        [jnp.zeros((T, F, 1), logpdf.dtype), logpdf], axis=-1)  # (T, F, nv)

    # Per-(trace, frame, value) validity:
    #  - category consistency (MCsimlib.py:5436-5439),
    #  - max-deviation for v>0 (MCsimlib.py:5444-5451).
    cat = categories[:, :, None]
    vals = jnp.arange(nv)[None, None, :]
    consistent = jnp.where(vals == 0, ~cat, cat)
    dev_ok = jnp.concatenate(
        [jnp.ones((T, F, 1), bool), dev <= max_deviation], axis=-1)
    invalid = ~(consistent & dev_ok)                      # (T, F, nv)

    # Membership matmul: M[(f, v), s] = 1 iff seq_tab[s, f] == v.
    one_hot = jax.nn.one_hot(seq_tab, nv, dtype=contrib.dtype)  # (S, F, nv)
    M = one_hot.reshape(S, F * nv).T                      # (F*nv, S)
    # HIGHEST: TF32 rounding of contrib flips winners on near-ties
    # (measured on an H100: 8 of 65,536 traces).
    scores = jnp.dot(contrib.reshape(T, F * nv), M,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    violations = jnp.dot(invalid.astype(contrib.dtype).reshape(T, F * nv), M,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
    valid = violations < 0.5                              # (T, S)

    # Static multidrop mask per sequence (MCsimlib.py:5440-5443).
    if not allow_multidrop and seq_tab.shape[1] > 1:
        drops = seq_tab[:, :-1] - seq_tab[:, 1:]
        seq_ok = jnp.max(drops, axis=-1) <= 1
        valid = valid & seq_ok[None, :]

    # Valid sequences floor at a huge-but-finite score so they always beat
    # invalid ones, even when their own log-score underflowed.
    key = jnp.where(valid, jnp.maximum(scores, -1e30), -jnp.inf)
    best_idx = jnp.argmax(key, axis=-1)
    found = jnp.any(valid, axis=-1)
    best_logscore = jnp.take_along_axis(scores, best_idx[:, None],
                                        axis=-1)[:, 0]
    return best_idx, found, best_logscore


@functools.partial(jax.jit, static_argnames=("allow_multidrop",))
def score_chunk_device(intensities, counts, seq_tab, log_fluor_means,
                       beta_sigma, max_deviation, allow_multidrop):
    """Device-resident chunk scoring for the chained simulate->fit
    closure: the log prep (intensity > 0 -> log, else -10000;
    MCsimlib.py:5423) and the category derivation (count != 0) run on
    device so the (N, F) intensities never cross the host link — only
    the per-trace winners do. Same _score_batch math as score_traces'
    host path.

    Precision boundary (documented, not hidden): the host path logs in
    float64 and casts to f32; this path logs in f32 on device. The two
    can differ by an ulp, so a trace whose two best sequence hypotheses
    score within ~1 ulp could flip winners between the chained and
    two-step paths — a measure-zero event for lognormal data
    (beta_sigma >= 0.1 separates hypotheses by many ulps). Closure
    equality with the two-step path is pinned at fixed seeds in
    tests/test_sim.py / test_closure_full_stack.py; on an accelerator an
    isolated near-tie flip would change which of two
    equally-well-scoring signals a single molecule reports."""
    cats = counts != 0
    log_int = jnp.where(intensities > 0, jnp.log(intensities),
                        -10000.0).astype(jnp.float32)
    return _score_batch(log_int, cats, seq_tab, log_fluor_means,
                        beta_sigma, max_deviation, allow_multidrop)


def score_traces(intensities, categories, log_fluor_means, beta_sigma,
                 max_possible=5, allow_multidrop=True, allow_upsteps=False,
                 max_deviation=3, chunk=None, mesh=None):
    """Batched v8 scoring for T traces of F cycles each.

    intensities: (T, F) raw adjusted intensities (host array).
    categories: (T, F) bool.
    mesh: optional jax.sharding.Mesh — the trace axis of every chunk is
        sharded over the mesh's first axis (the reference's per-spot Pool
        fan-out, SURVEY P2, as pure data parallelism; the sequence-table
        matmul replicates and no collectives are needed).
    Returns (best_seqs (T, F) int array, found (T,) bool,
             best_logscore (T,) float).

    Ragged tails pad to power-of-two buckets so every call shape hits a
    compiled program, and all chunks are queued before any result is
    fetched so the device pipelines them. chunk=None (default) takes the
    per-backend constant (utils/probes.v8_chunk). Results are
    chunk-invariant.
    """
    if chunk is None:
        from ..utils import probes

        chunk = probes.v8_chunk()
    if len(log_fluor_means) < max_possible:
        # Sequence values above len(log_fluor_means) would fall outside
        # the one-hot score range and contribute neither score nor
        # violations — a silent 0.0-logscore winner. The reference dies
        # with IndexError on the same input (MCsimlib.py:5452-5462); be
        # loud and clear instead.
        raise ValueError(
            f"log_fluor_means has {len(log_fluor_means)} entries but "
            f"max_possible={max_possible} needs at least that many")
    intensities = np.asarray(intensities, dtype=np.float64)
    T, F = intensities.shape
    lmii = max_possible
    tab = sequence_table(F, lmii, allow_upsteps)
    log_int = np.where(intensities > 0,
                       np.log(np.maximum(intensities, 1e-300)),
                       -10000.0).astype(np.float32)
    cats = np.asarray(categories, dtype=bool)
    lfm = np.asarray(log_fluor_means[:lmii], dtype=np.float32)
    tab_dev = jnp.asarray(tab)

    from ..utils.dispatch import pow2_bucket, mesh_row_sharding

    n_dev = 1
    if mesh is not None:
        row_sharding, n_dev = mesh_row_sharding(mesh)

    def place(x):
        if mesh is None:
            return jnp.asarray(x)
        # Direct sharded upload from host — jnp.asarray first would stage
        # on the default device and copy a second time.
        return jax.device_put(x, row_sharding)

    best_idx = np.zeros((T,), np.int64)
    found = np.zeros((T,), bool)
    best_ls = np.zeros((T,), np.float64)
    pending = []
    for lo in range(0, T, chunk):
        hi = min(lo + chunk, T)
        n = hi - lo
        bucket = pow2_bucket(n, chunk, multiple_of=n_dev)
        li = log_int[lo:hi]
        ca = cats[lo:hi]
        if bucket != n:
            li = np.concatenate(
                [li, np.full((bucket - n, F), -10000.0, np.float32)])
            ca = np.concatenate([ca, np.zeros((bucket - n, F), bool)])
        pending.append((lo, hi, _score_batch(
            place(li), place(ca), tab_dev,
            jnp.asarray(lfm), float(beta_sigma), float(max_deviation),
            bool(allow_multidrop))))
    for lo, hi, (bi, fo, bl) in pending:
        n = hi - lo
        best_idx[lo:hi] = np.asarray(bi)[:n]
        found[lo:hi] = np.asarray(fo)[:n]
        best_ls[lo:hi] = np.asarray(bl)[:n]
    return tab[best_idx], found, best_ls


def seq_to_signal(best_seq):
    """Convert a fluor-count sequence to the signal tuple convention.

    Parity: MCsimlib.py:5467-5493 — drops of size d at cycle i+1 emit
    ``('A', i+1)`` d times; an empty drop list becomes ``(('A', 0),)``;
    is_zero marks sequences ending at 0 fluors.
    """
    best_seq = [int(v) for v in best_seq]
    starting_intensity = best_seq[0]
    signal = []
    for i, nxt in enumerate(best_seq[1:]):
        tf = best_seq[i] - nxt
        if tf > 0:
            signal += [("A", i + 1)] * tf
        elif tf < 0:
            return None, None, starting_intensity
    signal = tuple(signal) if signal else (("A", 0),)
    is_zero = best_seq[-1] == 0
    return signal, is_zero, starting_intensity

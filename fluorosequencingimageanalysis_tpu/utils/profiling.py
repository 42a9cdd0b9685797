"""First-class tracing / per-stage timers.

The reference has only ad-hoc wall-clock prints (gaussfitter.py:519-544,
MCsimlib.py:70-84, stepfitting_library.py:460-462). Here profiling is a
subsystem: a process-wide stage-timer registry with context managers, an
optional JAX profiler trace wrapper for device timeline capture, and a
device-timing helper that forces a host transfer so asynchronous dispatch
cannot fake timings.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict

import numpy as np

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())

_lock = threading.Lock()
_stats: dict = defaultdict(lambda: {"count": 0, "total": 0.0, "max": 0.0})


@contextlib.contextmanager
def stage(name: str):
    """Time a named pipeline stage; accumulates into the registry.

    >>> with stage("detect"):
    ...     run_detection()
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            s = _stats[name]
            s["count"] += 1
            s["total"] += dt
            s["max"] = max(s["max"], dt)
        logger.debug("stage %s: %.4fs", name, dt)


def timings() -> dict:
    """Snapshot of {stage: {count, total, max, mean}}."""
    with _lock:
        out = {}
        for name, s in _stats.items():
            out[name] = dict(s, mean=s["total"] / max(s["count"], 1))
        return out


def reset_timings() -> None:
    with _lock:
        _stats.clear()


_counts: dict = defaultdict(int)


def bump(name: str, n: int = 1) -> None:
    """Count a link/dispatch event (upload, step dispatch, result fetch,
    bytes moved). The config-4 transfer ledger (DESIGN.md section 15b)
    is built from these: every host<->device round trip in the hot paths
    calls bump, so ``counters()`` after a run is the exact dispatch
    census, not an estimate."""
    with _lock:
        _counts[name] += n


def counters() -> dict:
    with _lock:
        return dict(_counts)


def reset_counters() -> None:
    with _lock:
        _counts.clear()


def report() -> str:
    """Human-readable stage-timing table (sorted by total, descending)."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1]["total"])
    lines = [f"{'stage':<28} {'count':>7} {'total_s':>10} {'mean_s':>10} "
             f"{'max_s':>10}"]
    for name, s in rows:
        lines.append(f"{name:<28} {s['count']:>7} {s['total']:>10.4f} "
                     f"{s['mean']:>10.4f} {s['max']:>10.4f}")
    return "\n".join(lines)


@contextlib.contextmanager
def jax_trace(log_dir: str):
    """Capture a JAX/XLA profiler trace (view with TensorBoard/Perfetto).
    No-ops gracefully if the profiler cannot start (e.g. already active)."""
    import jax
    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception as e:  # pragma: no cover - depends on runtime state
        logger.warning("jax profiler unavailable: %s", e)
    try:
        yield
    finally:
        if started:
            jax.profiler.stop_trace()


def device_time(fn, *args, warmup: int = 1, iters: int = 3, **kwargs):
    """Wall-clock a device computation honestly: every timed call is
    followed by a host transfer of the result, a completion barrier that
    also covers the host copy. Returns (best_seconds, out)."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args, **kwargs)
        _force(out)
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _force(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def _force(tree):
    import jax
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "dtype"):
            np.asarray(leaf)

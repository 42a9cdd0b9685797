"""Per-backend dispatch constants and in-process link probes.

Chunk caps and the Kerssemakers engine are constants per platform, set
from A/B runs on the card (PERF.md, bring-up findings); results are
chunk- and engine-invariant (CI-tested), so these are pure performance
choices:

- ``stepfit_chunk()``: rows per fused CK + sliding-t dispatch;
- ``v8_chunk()``: trace rows per v8 scoring dispatch;
- ``detect_chunk()``: candidates per round of the exhaustive detect driver;
- ``chisq_engine()``: 'native' (the C++ core) or 'device'.

The CPU keeps small chunks: it is the test platform, and bigger chunks
there only trade host memory for nothing.

Link properties (upload/fetch bandwidth, round-trip latency) are measured
in-process, once per process, and size the pipelined upload groups
(``upload_group_items``) and the movie prefetch (``timetrace_prefetch``).
``FSIA_PROBES=off`` skips those measurements and keeps static defaults.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())

_SESSION: dict = {}        # per-PROCESS link measurements

# platform -> (stepfit_chunk, v8_chunk, detect_chunk, chisq_engine).
# The accelerator row was measured on an H100 (PERF.md).
_CPU_CONSTANTS = (2048, 32768, 2048, "native")
_ACCELERATOR_CONSTANTS = (8192, 65536, 4096, "native")
_PREFETCH_MIN_MBPS = 400.0


def _mode() -> str:
    return os.environ.get("FSIA_PROBES", "").strip().lower()


def _is_cpu() -> bool:
    import jax

    return jax.default_backend() == "cpu"


def _constants():
    return _CPU_CONSTANTS if _is_cpu() else _ACCELERATOR_CONSTANTS


def stepfit_chunk() -> int:
    """Row cap per fused CK + sliding-t dispatch (ops/stepfit_batch)."""
    return _constants()[0]


def v8_chunk() -> int:
    """Trace rows per v8 scoring dispatch (ops/lognormal, sim/dye_sim)."""
    return _constants()[1]


def detect_chunk() -> int:
    """Candidate-chunk size of the exhaustive detection driver
    (models/detect.detect_and_fit_exhaustive)."""
    return _constants()[2]


def chisq_engine() -> str:
    """Kerssemakers batch engine: 'native' (the C++ core, bit-equal to
    the host oracle) or 'device' (ops/chisq_batch_device, equal in exact
    arithmetic but free to differ on last-ulp-tied splits)."""
    return _constants()[3]


def _session_probe(name: str, fn):
    """Memoized SESSION probe: run fn() once per process, never persisted
    — the measured quantity (link health) varies between sessions."""
    if name not in _SESSION:
        _SESSION[name] = fn()
        logger.info("session probe %s = %r", name, _SESSION[name])
    return _SESSION[name]


def refresh_session() -> None:
    """Drop this process's session measurements (the next decision
    re-measures). For long-lived processes that outlive a link phase."""
    _SESSION.clear()


def link_bandwidth_MBps() -> float:
    """Host->device upload bandwidth (measured once per process)."""
    def run():
        import jax

        host = np.zeros(8 * 1024 * 1024 // 2, np.uint16)  # 8 MB
        best = float("inf")
        for i in range(3):
            t0 = time.perf_counter()
            x = jax.device_put(host)
            np.asarray(x[:1])
            dt = time.perf_counter() - t0
            if i:  # first round pays allocator warmup
                best = min(best, dt)
            del x
        return 8.0 / best

    return float(_session_probe("link_bandwidth_MBps", run))


def fetch_bandwidth_MBps() -> float:
    """Device->host fetch bandwidth (measured once per process; links
    can be asymmetric, so it is measured apart from the upload)."""
    def run():
        import jax
        import jax.numpy as jnp

        x = jax.device_put(jnp.zeros(8 * 1024 * 1024 // 2, jnp.uint16))
        np.asarray(x[:1])  # materialize on device
        best = float("inf")
        for i in range(3):
            # Fresh buffer each round: jax.Array caches its host copy,
            # so re-fetching the same array times a memcpy, not the link.
            y = x + jnp.uint16(i)
            np.asarray(y[:1])
            t0 = time.perf_counter()
            np.asarray(y)
            dt = time.perf_counter() - t0
            if i:
                best = min(best, dt)
            del y
        return 8.0 / best

    return float(_session_probe("fetch_bandwidth_MBps", run))


def link_latency_s() -> float:
    """Per-round-trip host<->device latency (measured once per process)."""
    def run():
        import jax
        import jax.numpy as jnp

        x = jax.device_put(jnp.zeros((8,), jnp.float32))
        np.asarray(x)  # warm
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            np.asarray(x + 0)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    return float(_session_probe("link_latency_s", run))


_GROUP_LATENCY_MULT = 4.0   # per-group transfer time >= 4x link latency
_GROUP_FLOOR_ITEMS = 8


def upload_group_items(item_mb: float, n_dev: int, total: int,
                       floor: int = _GROUP_FLOOR_ITEMS) -> int:
    """Items (frames/fields) per pipelined host->device upload group.

    The reference's analog is the candidate-count load balancer
    (pflib.py:1000-1111), which sized work per process instead of per
    transfer. Sizing rule from the SESSION link measurements: per-group
    upload time must be at least ``_GROUP_LATENCY_MULT`` x the round-trip
    latency, while keeping >= 2 groups in flight when the workload
    allows so upload still overlaps compute. Rounded up to a mesh-axis
    multiple so every dispatch hits one compiled program.
    """
    if _mode() == "off" or _is_cpu():
        g = max(floor, n_dev)
    else:
        lat = link_latency_s()
        bw = link_bandwidth_MBps()
        g = int(np.ceil(_GROUP_LATENCY_MULT * lat * bw /
                        max(item_mb, 1e-6)))
        g = max(g, floor, n_dev)
        two_groups = -(-total // 2)  # ceil: the 2-in-flight cap
        if two_groups >= max(floor, n_dev):
            g = min(g, two_groups)
    # Never exceed the workload itself (rounded up to the mesh): the
    # latency-derived g is unbounded, and a tiny stack padded to it
    # would multiply upload bytes and compile a one-off inflated shape.
    cap = total + (-total) % max(n_dev, 1)
    if cap >= max(n_dev, 1):
        g = min(g, cap)
    g += (-g) % max(n_dev, 1)
    return g


def timetrace_prefetch() -> bool:
    """Upload-ahead for run_timetraces: on for links of at least
    400 MB/s measured upload bandwidth. CPU keeps it off without
    measuring — its "link" is a host memcpy, and prefetch there only
    doubles peak movie memory."""
    if _mode() == "off" or _is_cpu():
        return False
    return link_bandwidth_MBps() >= _PREFETCH_MIN_MBPS


def snapshot() -> dict:
    """The session's link measurements and every dispatch decision
    (bench.py records this next to its numbers)."""
    return {
        "link_bandwidth_MBps": round(link_bandwidth_MBps(), 1),
        "fetch_bandwidth_MBps": round(fetch_bandwidth_MBps(), 1),
        "link_latency_ms": round(link_latency_s() * 1e3, 2),
        "stepfit_chunk": stepfit_chunk(),
        "v8_chunk": v8_chunk(),
        "detect_chunk": detect_chunk(),
        "chisq_engine": chisq_engine(),
        "timetrace_prefetch": timetrace_prefetch(),
    }

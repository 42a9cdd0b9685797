"""Atomic writes for jax's persistent compile cache.

jax's on-disk cache (jax._src.lru_cache.LRUCache.put, jax 0.9) writes
entries with a bare ``Path.write_bytes`` — NOT tmp + rename. Two
processes compiling the same shape race: P1 starts writing, P2 sees the
path exists and skips its own write, and every later reader loads the
TORN entry — ``backend.deserialize_executable`` then SEGFAULTS the
process (observed: a full pytest run killed by a half-written CPU cache
entry after an overlapping bench run compiled the same stepfit shape).
Concurrent compiles of one shape are this framework's NORMAL state:
multi-process runs (parallel tests, multihost) compile identical programs.

:func:`ensure_atomic_cache_writes` monkeypatches ``LRUCache.put`` to
write to a pid-suffixed temp file and ``os.replace`` it into place —
readers see the old state or the complete entry, never a torn one. The
patch is idempotent, verifies the attributes it relies on, and backs
off silently (leaving jax stock) on any mismatch with a future jax.
"""

from __future__ import annotations

import logging
import os
import sys

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())

_APPLIED = False


def ensure_atomic_cache_writes() -> None:
    """Idempotently make jax's persistent-cache writes atomic.

    Safe to call any time after jax is importable; a no-op when jax is
    not loaded yet (callers at compute chokepoints all run post-import).
    """
    global _APPLIED
    if _APPLIED or "jax" not in sys.modules:
        return
    try:
        from jax._src import lru_cache as _lru

        cls = _lru.LRUCache
        if getattr(cls, "_fluoro_atomic_put", False):
            _APPLIED = True
            return
        # The patch reimplements put() against jax's current internals.
        # Verify the ORIGINAL put still looks like the function being
        # replaced (the bare non-atomic write and every attribute the
        # reimplementation touches); any drift in a future jax — a
        # rename, or an upstream fix making the write atomic — leaves
        # jax stock instead of installing a stale reimplementation.
        import inspect

        orig_src = inspect.getsource(cls.put)
        for needle in ("cache_path.write_bytes(val)", "self.path",
                       "self.eviction_enabled", "self._evict_if_needed",
                       "self.lock", "self.lock_timeout_secs",
                       "self.max_size"):
            if needle not in orig_src:
                raise AttributeError(
                    f"jax LRUCache.put drifted (missing {needle!r})")
        suffix = _lru._CACHE_SUFFIX
        atime_suffix = _lru._ATIME_SUFFIX
        import time
        import warnings

        def put(self, key, val):
            if not key:
                raise ValueError("key cannot be empty")
            if self.eviction_enabled and len(val) > self.max_size:
                warnings.warn(
                    f"Cache value for key {key!r} of size {len(val)} "
                    f"bytes exceeds the maximum cache size of "
                    f"{self.max_size} bytes")
                return
            cache_path = self.path / f"{key}{suffix}"
            if self.eviction_enabled:
                self.lock.acquire(timeout=self.lock_timeout_secs)
            tmp = self.path / f"{key}.{os.getpid()}.tmp"
            try:
                if cache_path.exists():
                    return
                self._evict_if_needed(additional_size=len(val))
                tmp.write_bytes(val)
                os.replace(tmp, cache_path)
                if self.eviction_enabled:
                    timestamp = time.time_ns().to_bytes(8, "little")
                    atime_path = self.path / f"{key}{atime_suffix}"
                    atime_path.write_bytes(timestamp)
            finally:
                if tmp.exists():
                    try:
                        tmp.unlink()
                    except OSError:
                        pass
                if self.eviction_enabled:
                    self.lock.release()

        cls.put = put
        cls._fluoro_atomic_put = True
        _APPLIED = True
        logger.debug("jax persistent-cache writes patched to be atomic")
    except Exception:  # pragma: no cover - future-jax drift
        logger.warning(
            "could not make jax compile-cache writes atomic; concurrent "
            "compiles of one shape can tear cache entries (segfault on "
            "later reads)", exc_info=True)
        _APPLIED = True  # do not retry every call

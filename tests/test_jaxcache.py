"""Atomic jax compile-cache writes (utils/jaxcache).

jax's stock LRUCache.put is a bare write_bytes — two processes compiling
the same shape can tear an entry and every later reader SEGFAULTS on
deserialize (observed killing a full pytest run). The patch makes the
write tmp + os.replace."""

import os

import numpy as np


def test_lru_cache_put_is_atomic(tmp_path):
    import jax  # noqa: F401  (patch requires jax loaded)
    from fluorosequencingimageanalysis_tpu.utils.jaxcache import (
        ensure_atomic_cache_writes)

    ensure_atomic_cache_writes()
    from jax._src import lru_cache

    assert getattr(lru_cache.LRUCache, "_fluoro_atomic_put", False), \
        "patch did not apply to this jax version"
    cache = lru_cache.LRUCache(str(tmp_path), max_size=-1)
    cache.put("k1", b"hello world")
    assert cache.get("k1") == b"hello world"
    # No temp remnants; exactly the entry file.
    names = sorted(os.listdir(tmp_path))
    assert not any(n.endswith(".tmp") for n in names), names
    # Existing entries are never overwritten (jax's contract).
    cache.put("k1", b"different")
    assert cache.get("k1") == b"hello world"


def test_patch_is_idempotent():
    import jax  # noqa: F401
    from fluorosequencingimageanalysis_tpu.utils import jaxcache

    jaxcache.ensure_atomic_cache_writes()
    from jax._src import lru_cache

    put_before = lru_cache.LRUCache.put
    jaxcache.ensure_atomic_cache_writes()
    assert lru_cache.LRUCache.put is put_before


def _cache_config_in_child(env_update, import_jax_first):
    """(env var, jax config) of the compile cache after importing the
    package in a fresh process."""
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "PYTHONPATH")}
    env.update(env_update)
    code = ("import json, os\n" +
            ("import jax\n" if import_jax_first else "") +
            "import fluorosequencingimageanalysis_tpu as pkg\n"
            "import jax\n"
            "print(json.dumps([os.environ.get('JAX_COMPILATION_CACHE_DIR'),"
            " jax.config.jax_compilation_cache_dir,"
            " pkg.compile_cache_dir()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1]), root


import pytest  # noqa: E402


@pytest.mark.parametrize("import_jax_first", [False, True])
def test_compile_cache_env_set_is_used_as_is(tmp_path, import_jax_first):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and no other
    directory is configured."""
    want = str(tmp_path / "cache")
    (env, cfg, chosen), _ = _cache_config_in_child(
        {"JAX_COMPILATION_CACHE_DIR": want}, import_jax_first)
    assert env == cfg == chosen == want


@pytest.mark.parametrize("import_jax_first", [False, True])
def test_compile_cache_env_unset_uses_checkout_dir(import_jax_first):
    """Without the env var the cache is the fixed <checkout>/.jax_cache
    (the path is part of the cache key, so it must not move)."""
    (env, cfg, chosen), root = _cache_config_in_child({}, import_jax_first)
    want = os.path.join(root, ".jax_cache")
    assert cfg == chosen == want
    if not import_jax_first:
        assert env == want  # handed to jax through its env var

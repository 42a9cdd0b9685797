import os

# Multi-device CPU mesh for sharding tests; XLA reads this at backend init.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

# Unit tests run on the host CPU whatever accelerator the machine has (set
# before any jax use). Tests that need a GPU carry the ``gpu`` marker and
# run chip_smoke.py in a child process.
jax.config.update("jax_platforms", "cpu")

# Golden-parity tests compare against float64 NumPy/SciPy oracles.
jax.config.update("jax_enable_x64", True)


import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_jax_process_state():
    """Clear jax's in-process executable caches between test MODULES.

    The full suite compiles hundreds of programs into one process; with
    all of them resident, a late big compile (the fused CK kernel in
    test_stepfit_batch) segfaults inside XLA:CPU's compiler —
    reproducibly at full-suite scale, never in any half-suite subset
    (see DESIGN.md, round 4 stability note). Clearing per module bounds
    the resident-program count; cross-module recompiles of shared
    shapes are absorbed by the persistent disk cache.
    """
    yield
    jax.clear_caches()
    gc.collect()

"""
fluorosequencingimageanalysis_tpu
=================================

A JAX framework for fluorosequencing image analysis, providing the
capabilities of the reference pipeline (marcottelab/FluorosequencingImageAnalysis)
redesigned as batched, sharded XLA programs (run on NVIDIA GPUs):

- Spot (peptide PSF) detection and batched 2D-Gaussian PSF fitting
  (reference: pflib.py) as fused, vmapped array programs.
- Subpixel FFT phase-correlation registration (reference: phase_correlate.py)
  as batched XLA FFTs + matrix-multiply upsampled DFTs.
- Experiment data model, particle tracking and photometry
  (reference: flexlibrary.py).
- Intensity-trace step fitting (reference: stepfitting_library.py) vectorized
  across traces.
- Monte-Carlo dye simulation and lognormal fluor-count inference
  (reference: MCsimlib.py, peptide_simulator.py) as vectorized RNG programs.

Layout:
    ops/       pure jittable kernels (candidates, LM fit, FFT registration,
               photometry, step fitting, lognormal scoring)
    models/    composed compute pipelines (whole-field detect+fit, etc.)
    parallel/  mesh / sharding helpers for multi-chip execution
    pipeline/  host-side experiment layer (Spots, Images, Traces, Experiments)
    inference/ calibration + lognormal fitting + background correction
    sim/       Monte-Carlo peptide simulator
    native/    C++ runtime components (ctypes C ABI)
    utils/     hashing, IO, visualization, profiling, checkpointing
    api.py     Pipeline facade; config.py typed configs

Reference-compatible CLI entry points live as top-level scripts
(basic_image_script.py etc.), matching the reference's layout.
"""

__version__ = "0.1.0"


def compile_cache_dir():
    """Directory of the persistent XLA compile cache: the
    ``JAX_COMPILATION_CACHE_DIR`` environment variable when it is set,
    else ``.jax_cache/`` in the checkout that holds this package. The
    path is part of the cache key, so it stays fixed."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


def _enable_persistent_compile_cache():
    """Persistent XLA compile cache, on by default.

    Compiles of the big programs (512x512 detect, chunked stepfit / v8
    buckets) cost seconds each; the disk cache makes every later process
    load them instead. Opt out with FLUORO_TPU_NO_COMPILE_CACHE=1.
    Every compiled program is cached (minimum compile time 0), so a
    warm process compiles nothing.

    Importing this package must stay jax-free (CLI --help, sim-only
    consumers), so when jax is not yet loaded the cache is configured
    through the JAX_* env vars jax reads at its own import time; only
    an already-imported jax is configured directly.
    """
    import os
    import sys

    if os.environ.get("FLUORO_TPU_NO_COMPILE_CACHE"):
        return
    cache_dir = compile_cache_dir()
    min_secs = os.environ.setdefault(
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
    if "jax" in sys.modules:
        jax = sys.modules["jax"]
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          float(min_secs))
        # Concurrent compiles of one shape happen (multi-process tests
        # and hosts); jax's stock cache write is torn-entry-prone
        # (utils/jaxcache docstring).
        from .utils.jaxcache import ensure_atomic_cache_writes
        ensure_atomic_cache_writes()
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = cache_dir


_enable_persistent_compile_cache()


def __getattr__(name):
    # Lazy top-level exports (keep `import fluorosequencingimageanalysis_tpu`
    # free of jax initialization).
    if name == "Pipeline":
        from .api import Pipeline
        return Pipeline
    if name == "PipelineConfig":
        from .config import PipelineConfig
        return PipelineConfig
    raise AttributeError(name)

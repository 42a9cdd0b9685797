"""Dataclass configs for the pipeline stages.

The reference keeps algorithm defaults as function-signature defaults
scattered across modules (pflib.py:284-287, stepfitting_library.py:929-931,
MCsimlib.py:5496-5502) plus per-script argparse with free-form
``ast.literal_eval`` dict flags (basic_image_script.py:47-54,95-98). Here
the defaults live in typed dataclasses that mirror those signatures, can be
built from those same CLI dict strings, and splat into the corresponding
kernels via ``asdict``-style kwargs.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field


def _from_cli(cls, text: str | None, **overrides):
    """Build a config from a reference-style CLI dict literal
    (e.g. ``"{'c_std': 3, 'r_2_threshold': 0.5}"``), applying overrides."""
    values = {}
    if text:
        parsed = ast.literal_eval(text)
        if not isinstance(parsed, dict):
            raise ValueError("expected a dict literal, got " + repr(text))
        values.update(parsed)
    values.update(overrides)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - names)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {unknown}")
    return cls(**values)


@dataclass(frozen=True)
class DetectConfig:
    """Candidate finding + PSF fitting (pflib.find_peptides defaults,
    pflib.py:284-287)."""
    median_filter_size: int = 5
    c_std: float = 2.0
    r_2_threshold: float = 0.7
    consolidation_radius: float = 4.0
    max_candidates: int = 1024
    # Cap for the SINGLE-FIELD surfaces (run_timetrace's first-frame
    # detect): None = exhaustive chunked detection, the reference's
    # uncapped semantics (pflib.py:217-258). max_candidates above stays
    # the [K] bucket of the batched stack programs (run_stack /
    # run_experiment / run_zstack), which compile one fixed shape.
    single_field_cap: int | None = None
    num_iters: int = 60
    # 2 adds a theta0=90 restart covering optima across the 0/360
    # wraparound (beyond-reference accuracy at ~2x LM cost).
    theta_starts: int = 1

    from_cli = classmethod(_from_cli)


@dataclass(frozen=True)
class RegistrationConfig:
    """Subpixel FFT alignment (flexlibrary.py:1717-1741)."""
    upsample_factor: int = 20

    from_cli = classmethod(_from_cli)


@dataclass(frozen=True)
class PhotometryConfig:
    """Spot photometry (flexlibrary.py:172-210 defaults; the sextractor
    trio mirrors sextractor_photometry_metric's radius/box_size/
    filter_size, flexlibrary.py:243-262)."""
    method: str = "mexican_hat"
    radius: int = 9
    brim_size: int = 6
    photometry_min: float | None = None
    aperture_radius: float = 3
    box_size: int = 10
    filter_size: int = 10

    from_cli = classmethod(_from_cli)


@dataclass(frozen=True)
class StepfitConfig:
    """Trace step fitting (flexlibrary.py:1380-1469 +
    stepfitting_library.py:929-931 defaults)."""
    mirror_start: int = 0
    chung_kennedy: int = 0
    p_threshold: float = 0.01
    window_radius: int = 6
    batched: bool = True

    from_cli = classmethod(_from_cli)


@dataclass(frozen=True)
class LognormalConfig:
    """v8 lognormal sequence fitting (MCsimlib.py:5496-5502 defaults)."""
    max_possible: int = 5
    quench_factors: tuple = ()
    allow_multidrop: bool = False
    allow_upsteps: bool = False
    max_deviation: float | None = None

    from_cli = classmethod(_from_cli)


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle for experiment_step_sharded and the CLI apps."""
    detect: DetectConfig = field(default_factory=DetectConfig)
    registration: RegistrationConfig = field(
        default_factory=RegistrationConfig)
    photometry: PhotometryConfig = field(default_factory=PhotometryConfig)
    stepfit: StepfitConfig = field(default_factory=StepfitConfig)
    lognormal: LognormalConfig = field(default_factory=LognormalConfig)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

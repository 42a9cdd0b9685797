"""Batched exhaustive plateau fitting vs the host _plateau_fit."""

import time

import numpy as np
import pytest

from fluorosequencingimageanalysis_tpu.inference.photometries import (
    _plateau_fit)
from fluorosequencingimageanalysis_tpu.ops.plateau_batch import (
    plateau_fit_batched)


def _traces(n=30, t=8, seed=0):
    rng = np.random.default_rng(seed)
    levels = np.where(np.arange(t) < 3, 50000.0,
                      np.where(np.arange(t) < 6, 25000.0, 1000.0))
    x = levels[None] + rng.normal(0, 800, (n, t))
    x[min(5, n - 1)] = 7.0  # constant trace exercises the special case
    return x


def _flatten(fit):
    return [v for plateau in fit for v in plateau]


def test_plateau_fit_batched_matches_host():
    x = _traces()
    for kwargs in ({}, {"downsteps_only": True}, {"use_adjusted_r_2": True},
                   {"original_intensities_only": False},
                   {"include_original_intensities": True,
                    "original_intensities_only": False},
                   {"delta_r_2": 0.0}, {"delta_r_2": 0.3}):
        batched = plateau_fit_batched(x, max_num_drops=3, **kwargs)
        for i in range(x.shape[0]):
            ref_fit, ref_r2 = _plateau_fit(list(x[i]), max_num_drops=3,
                                           **kwargs)
            b_fit, b_r2 = batched[i]
            assert abs(b_r2 - ref_r2) < 1e-9, (i, kwargs)
            assert [len(p) for p in b_fit] == [len(p) for p in ref_fit]
            if kwargs.get("include_original_intensities"):
                assert _flatten(b_fit) == _flatten(ref_fit)
            else:
                np.testing.assert_allclose(_flatten(b_fit),
                                           _flatten(ref_fit))


def test_plateau_fit_batched_means_output():
    # original_intensities_only=False without originals returns the means
    x = _traces(n=4)
    out = plateau_fit_batched(x, max_num_drops=2,
                              original_intensities_only=False)
    for (fit, r2), row in zip(out, x):
        for plateau in fit:
            assert len(set(np.round(plateau, 9))) == 1  # constant per seg
        assert -1 <= r2 <= 1.0 + 1e-12


def test_plateau_fit_batched_faster_than_host():
    x = _traces(n=64, t=10)
    plateau_fit_batched(x, max_num_drops=3)  # warm compile
    t0 = time.perf_counter()
    plateau_fit_batched(x, max_num_drops=3)
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(x.shape[0]):
        _plateau_fit(list(x[i]), max_num_drops=3)
    t_h = time.perf_counter() - t0
    assert t_b < t_h, (t_b, t_h)


def test_all_plateau_fits_batched_matches_host():
    from fluorosequencingimageanalysis_tpu.inference.photometries import (
        _all_plateau_fits)
    from fluorosequencingimageanalysis_tpu.ops.plateau_batch import (
        all_plateau_fits_batched)
    x = _traces(n=10, t=7)
    batched = all_plateau_fits_batched(x, max_num_drops=2,
                                       storage_r_2_cutoff=0.7)
    for i in range(x.shape[0]):
        ref = _all_plateau_fits(list(x[i]), max_num_drops=2,
                                storage_r_2_cutoff=0.7)
        b = batched[i]
        assert len(ref) == len(b)
        for (rf, rr2, radj), (bf, br2, badj) in zip(ref, b):
            assert abs(rr2 - br2) < 1e-9 and abs(radj - badj) < 1e-9
            rflat = [(m, o) for p in rf for (m, o) in p]
            bflat = [(m, o) for p in bf for (m, o) in p]
            np.testing.assert_allclose(np.asarray(rflat), np.asarray(bflat))


def test_exact_scoring_matches_host_on_ties_and_rejections():
    """The review's confirmed divergence repros: mathematically tied
    segmentations (integer-like data makes exact ties common) and the
    adjusted-R^2 == -1 rejection boundary must replay the host's exact
    selection — the 'exact' backend reproduces the host's numpy
    reduction order, so scores AND ties are bit-identical."""
    from fluorosequencingimageanalysis_tpu.inference.photometries import (
        _plateau_fit)
    from fluorosequencingimageanalysis_tpu.ops.plateau_batch import (
        plateau_fit_batched)

    rows = [
        [0.0, 3.0, 0.0, 2.8, 1.6, 0.0],    # confirmed tie repro
        [1.0, 3.0, 0.0, 0.0, 2.0, 8.4, 0.0],
        [5.0, 5.0, 1.0, 1.0, 3.0, 3.0, 0.0],  # integer plateaus: many ties
        [2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 0.0],
    ]
    for kwargs in ({"max_num_drops": 1},
                   {"max_num_drops": 3, "use_adjusted_r_2": True},
                   {"max_num_drops": 2, "downsteps_only": True}):
        for i, row in enumerate(rows):
            batched = plateau_fit_batched(
                np.asarray([row], dtype=np.float64), **kwargs)
            host = _plateau_fit(tuple(row), **kwargs)
            assert batched[0][0] == host[0], (i, kwargs)
            assert batched[0][1] == host[1] or (
                np.isnan(batched[0][1]) and np.isnan(host[1])), (i, kwargs)

    # T=3 adjusted-R^2: single-plateau adj == -1 exactly, never > -1 —
    # every combo rejected. Host raises TypeError iterating the None fit
    # (original_intensities_only formatting); the batched path must too.
    # Strictly-rising trace + downsteps_only + adjusted R^2: the single
    # plateau scores exactly -1 (never > -1) and every split is an
    # upstep — ALL combos rejected.
    bad = np.asarray([[0.0, 1.0, 2.0]])
    reject_kw = dict(max_num_drops=1, use_adjusted_r_2=True,
                     downsteps_only=True)
    with pytest.raises(TypeError):
        _plateau_fit((0.0, 1.0, 2.0), **reject_kw)
    with pytest.raises(TypeError):
        plateau_fit_batched(bad, **reject_kw)
    # Both-formatting-flags-off: host RETURNS (None, -1); so must we.
    host_none = _plateau_fit((0.0, 1.0, 2.0),
                             original_intensities_only=False, **reject_kw)
    got = plateau_fit_batched(bad, original_intensities_only=False,
                              **reject_kw)
    assert got[0] == host_none == (None, -1)


def test_device_scoring_single_plateau_exact_zero():
    """The device backend forces the no-drop combo's R^2 to its exact 0
    so the adjusted-R^2 rejection boundary at exactly -1 matches the
    host (einsum rounding left ~1e-16, admitting fits the host
    rejects)."""
    from fluorosequencingimageanalysis_tpu.ops.plateau_batch import (
        _all_scores, _segmentations)

    rng = np.random.default_rng(0)
    x = rng.normal(100.0, 30.0, (16, 3))
    combos, _ = _segmentations(3, 1)
    r2, n_segs, _ = _all_scores(x, 3, 1, "device")
    single = [c for c, starts in enumerate(combos) if len(starts) == 1]
    assert (r2[:, single] == 0.0).all()


def test_device_scoring_f32_production_configuration():
    """The production configuration (jax_enable_x64 unset) scores in
    float32. With host-side f64 row centering the
    f32 scores must stay within ~1e-5 of the exact host scores at raw
    photometry magnitudes, and the selected fits must match the host on
    non-tied data. Regression: the device backend silently downcast
    uncentered f64 rows, cancelling ~7 digits at magnitude ~6e4 — and
    only the x64 (test-suite) configuration was ever exercised."""
    import jax
    from fluorosequencingimageanalysis_tpu.ops.plateau_batch import (
        _all_scores, plateau_fit_batched)

    rng = np.random.default_rng(7)
    T = 8
    # Raw-magnitude stepped traces: the cancellation-prone regime.
    levels = rng.integers(1, 4, 32)
    x = np.empty((32, T))
    for i in range(32):
        drop = rng.integers(2, T - 1)
        x[i, :drop] = 30000.0 * levels[i]
        x[i, drop:] = 30000.0 * (levels[i] - 1)
        x[i] += rng.normal(0, 400.0, T)
    exact, _, ok_e = _all_scores(x, T, 2, "exact")
    f32, _, ok_32 = _all_scores(x, T, 2, "device", dtype=np.float32)
    finite = np.isfinite(exact)
    assert (np.abs(f32 - exact)[finite] < 1e-5).all(), \
        np.abs(f32 - exact)[finite].max()
    assert (ok_e == ok_32).all()

    # End-to-end under the REAL production dtype resolution: disable x64
    # around the device-scored fit and require host-identical selection.
    host_fits = plateau_fit_batched(x, 2, scores="exact")
    jax.config.update("jax_enable_x64", False)
    try:
        dev_fits = plateau_fit_batched(x, 2, scores="device")
    finally:
        jax.config.update("jax_enable_x64", True)
    for (hf, hr), (df, dr) in zip(host_fits, dev_fits):
        assert hf == df
        assert abs(hr - dr) < 1e-5

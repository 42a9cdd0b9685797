"""Tests for the inference layer: v8 fitter, calibration, background."""

import math

import numpy as np
import pytest

from fluorosequencingimageanalysis_tpu.inference import (
    _intensities_to_signal_lognormal_v8, photometries_lognormal_fit_v8,
    read_track_photometries_csv, write_photometries_dict_to_csv,
    optimal_bin_size_MP, _get_m0Dm1, last_drop_method_v2, background)
from fluorosequencingimageanalysis_tpu.inference.photometries import (
    _remainder_adjust_2, _plateau_fit)
from fluorosequencingimageanalysis_tpu.ops.lognormal import (
    sequence_table, seq_to_signal)


BETA = 30000.0
BETA_SIGMA = 0.2


def _lfm(max_possible=5, quench_factors=None):
    if quench_factors is None:
        quench_factors = [0.0] * (max_possible + 2)
    return [math.log(BETA) + math.log(i + 1.0) - quench_factors[i]
            for i in range(max_possible + 2)]


def _simulate_trace(rng, seq):
    """Intensities from a fluor-count sequence under the lognormal model."""
    return [float(rng.lognormal(math.log(BETA) + math.log(v), BETA_SIGMA))
            if v > 0 else float(rng.normal(0, 100))
            for v in seq]


def test_sequence_table_order_and_count():
    tab = sequence_table(4, 2)
    # C(4 + 2, 2) = 15 non-increasing sequences over values {0,1,2}.
    assert tab.shape == (15, 4)
    assert list(tab[0]) == [2, 2, 2, 2]
    assert list(tab[-1]) == [0, 0, 0, 0]
    for row in tab:
        assert all(row[i] >= row[i + 1] for i in range(3))


def test_seq_to_signal():
    assert seq_to_signal([2, 2, 1, 0]) == ((("A", 2), ("A", 3)), True, 2)
    assert seq_to_signal([3, 1, 1, 1]) == ((("A", 1), ("A", 1)), False, 3)
    assert seq_to_signal([1, 1, 1]) == ((("A", 0),), False, 1)
    assert seq_to_signal([0, 0]) == ((("A", 0),), True, 0)


def test_single_trace_v8_recovers_truth():
    rng = np.random.default_rng(0)
    truth = (2, 2, 1, 1, 0, 0)
    intensities = _simulate_trace(rng, truth)
    categories = tuple(v > 0 for v in truth)
    (signal, is_zero, best_seq, lmii, best_score, scores,
     si) = _intensities_to_signal_lognormal_v8(
        intensities, BETA, BETA_SIGMA, max_possible=5, categories=categories,
        log_fluor_means=_lfm())
    assert best_seq == truth
    assert signal == (("A", 2), ("A", 4))
    assert is_zero is True and si == 2


def test_batched_v8_matches_single_trace():
    rng = np.random.default_rng(1)
    lfm = _lfm()
    photometries = {"ch1": {0: {}}}
    expected = []
    for t in range(40):
        k = rng.integers(0, 4)
        n_frames = 8
        seq = sorted(rng.integers(0, 4, n_frames), reverse=True)
        intensities = _simulate_trace(rng, seq)
        categories = tuple(v > 0 for v in seq)
        photometries["ch1"][0][(t, t)] = (categories, tuple(intensities), t)
        expected.append(_intensities_to_signal_lognormal_v8(
            intensities, BETA, BETA_SIGMA, max_possible=5,
            categories=categories, log_fluor_means=lfm))
    signals, total, none_count, info = photometries_lognormal_fit_v8(
        photometries, BETA, BETA_SIGMA, max_possible=5,
        quench_factors=[0.0] * 7)
    assert total == 40
    by_hw = {(i[2], i[3]): i for i in info}
    for t, exp in enumerate(expected):
        got = by_hw[(t, t)]
        # (signal, is_zero, best_seq) must match the exact implementation.
        assert got[7] == exp[0], (t, got[7], exp[0])
        assert got[8] == exp[1]
        assert got[9] == exp[2]
        if exp[4] > 0:
            np.testing.assert_allclose(got[11], exp[4], rtol=1e-4)
    # Aggregate counts line up.
    exp_signals = {}
    exp_none = 0
    for exp in expected:
        if exp[0] is None:
            exp_none += 1
        else:
            key = (exp[0], exp[1], exp[6])
            exp_signals[key] = exp_signals.get(key, 0) + 1
    assert none_count == exp_none
    assert signals == exp_signals


def test_batched_v8_no_multidrop_and_category_masks():
    rng = np.random.default_rng(2)
    lfm = _lfm()
    # A 3->1 drop trace: allowed with multidrop, masked without.
    seq = (3, 3, 1, 1)
    ints = _simulate_trace(rng, seq)
    cats = tuple(v > 0 for v in seq)
    with_md = _intensities_to_signal_lognormal_v8(
        ints, BETA, BETA_SIGMA, categories=cats, log_fluor_means=lfm,
        allow_multidrop=True)
    no_md = _intensities_to_signal_lognormal_v8(
        ints, BETA, BETA_SIGMA, categories=cats, log_fluor_means=lfm,
        allow_multidrop=False)
    assert with_md[2] == seq
    assert no_md[2] != seq  # the 2-drop is forbidden
    if no_md[2] is not None:
        diffs = [no_md[2][i] - no_md[2][i + 1] for i in range(3)]
        assert max(diffs) <= 1


def test_optimal_bin_size_finds_reasonable_bins():
    rng = np.random.default_rng(3)
    data = rng.normal(0, 1, 3000)
    min_result, results, cost, raw_cost = optimal_bin_size_MP(
        data, min_n_bins=10, max_n_bins=100)
    assert 10 <= min_result[1] <= 100


def test_get_m0Dm1_bimodal():
    rng = np.random.default_rng(4)
    zeros = rng.normal(1000, 300, 4000)
    ones = rng.normal(20000, 3000, 2000)
    data = np.concatenate([zeros, ones])
    out = _get_m0Dm1(data, optimal_bin_number=100)
    alpha_phot, beta_phot, gamma_phot = out[7], out[8], out[9]
    assert abs(alpha_phot - 1000) < 1500       # m0 near the zero peak
    assert abs(beta_phot - 20000) < 3000       # m1 near the one-fluor peak
    assert 2000 < gamma_phot < 19000           # valley in between


def test_last_drop_method_v2():
    rng = np.random.default_rng(5)
    phot = {"ch1": {0: {}}}
    for t in range(400):
        # ON at beta for 3 cycles then OFF.
        ints = [float(rng.lognormal(math.log(BETA), BETA_SIGMA))
                for _ in range(3)] + [0.0]
        cats = (True, True, True, False)
        phot["ch1"][0][(t, 0)] = (cats, tuple(ints), t)
    beta, beta_sigma = last_drop_method_v2(phot)
    assert abs(beta - BETA) / BETA < 0.25
    assert 0.0 < beta_sigma < 0.6


def test_csv_roundtrip(tmp_path):
    phot = {"ch1": {0: {(5, 6): ((True, True, False), (100, 90, 3), 1),
                        (7, 8): ((True, False, False), (50, 2, 1), 2)}}}
    path = tmp_path / "tracks.csv"
    n = write_photometries_dict_to_csv(phot, str(path))
    assert n == 2
    d, d2 = read_track_photometries_csv(str(path))
    assert d["ch1"][0][(5, 6)][0] == (True, True, False)
    assert d["ch1"][0][(5, 6)][1] == (100, 90, 3)
    # downstep filter keeps monotone-ON-first categories only.
    d3, _ = read_track_photometries_csv(str(path), downstep_filtered=True)
    assert set(d3["ch1"][0]) == {(5, 6), (7, 8)}


def test_signals_algebra():
    s1 = {((("A", 1),), True, 1): 10, ((("A", 2),), True, 1): 30}
    s2 = {((("A", 1),), True, 1): 20, ((("A", 3),), True, 1): 20}
    pct = background.counts_to_percent(s1)
    assert abs(pct[((("A", 1),), True, 1)] - 0.25) < 1e-12
    avg = background.average_signals([s1, s2])
    assert abs(avg[((("A", 1),), True, 1)] - (0.25 + 0.5) / 2) < 1e-12
    std = background.signals_std([s1, s2])
    assert abs(std[((("A", 3),), True, 1)] - np.std([0, 0.5])) < 1e-12
    assert background.is_multidrop((("A", 1), ("A", 1))) is True
    assert background.is_multidrop((("A", 1), ("A", 2))) is False
    ht = background.head_truncate({((("A", 3),), True, 1): 5}, num_cycles=1)
    assert ht == {((("A", 2),), True, 1): 5}
    assert background.discard_late_signals(
        {((("A", 9),), True, 1): 5}, max_cycle=8) == {}


def test_adjacent_positions_and_interpolation():
    target = ((("A", 3),), True, 1)
    adj = background.generate_adjacent_positions(target)
    assert set(adj) == {(2,), (4,)}
    signals = {((("A", 2),), True, 1): 10, ((("A", 4),), True, 1): 30}
    v = background.interpolate_signal(signals, target, num_cycles=8)
    assert v == 20.0


def test_iterative_peak_finding_v3_removes_outlier():
    keys = [((("A", i),), True, 1) for i in range(1, 7)]
    ac_counts = {k: 100 for k in keys}
    experiments = []
    rng = np.random.default_rng(6)
    for _ in range(4):
        experiments.append({k: 100 + int(rng.integers(-10, 10))
                            for k in keys})
    ac_avg = background.average_signals(experiments)
    ac_std = background.signals_std(experiments)
    # boc has a huge peak at cycle 3.
    boc_raw = {k: 100 for k in keys}
    boc_raw[((("A", 3),), True, 1)] = 1000
    boc_pct = background.counts_to_percent(boc_raw)
    peaks, undef, corrected_raw, corrected_pct = \
        background.iterative_peak_finding_v3(
            boc_raw, boc_pct, ac_avg, ac_std, num_cycles=6,
            sigma_threshold=3)
    assert corrected_raw[((("A", 3),), True, 1)] < 1000


def test_remainder_adjust_2():
    phot = {"ch1": {0: {}}}
    # 6 remainders with a systematic +10% drift in frame 1.
    for t in range(6):
        ints = (1000.0, 1100.0, 1000.0)
        phot["ch1"][0][(t, 0)] = ((True, True, True), ints, t)
    adjusted, ratios = _remainder_adjust_2(phot, num_frames=3,
                                           minimum_r_per_field=5)
    r = ratios["ch1"][0]
    assert abs(r[0]) < 1e-9 and abs(r[1] - 0.1) < 1e-9
    a_ints = adjusted["ch1"][0][(0, 0)][1]
    assert abs(a_ints[1] - 1100.0 * 0.9) < 1e-6


def test_plateau_fit_exhaustive():
    ints = [100, 100, 50, 50]
    fit, r2 = _plateau_fit(ints, max_num_drops=2)
    assert fit == [[100, 100], [50, 50]]
    assert r2 == 1.0


def test_lognormal_fit_v8_from_csv(tmp_path):
    """The dict-free CSV->v8 path must match the dict-driver output."""
    import csv
    import math
    from fluorosequencingimageanalysis_tpu.inference.lognormal import (
        lognormal_fit_v8_from_csv, photometries_lognormal_fit_v8)
    from fluorosequencingimageanalysis_tpu.inference.photometries import (
        read_track_photometries_csv)

    rng = np.random.default_rng(0)
    beta, beta_sigma = 30000.0, 0.2
    path = str(tmp_path / "tracks.csv")
    n_frames = 5
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(n_frames)])
        for t in range(30):
            seq = (2, 1, 1, 0, 0) if t % 2 == 0 else (1, 1, 0, 0, 0)
            ints = [int(rng.lognormal(math.log(beta * v), beta_sigma))
                    if v else int(rng.normal(0, 200)) for v in seq]
            cat = tuple(v > 0 for v in seq)
            w.writerow(["ch1", 0, 10 + t, 20 + t,
                        "(" + ", ".join(str(c) for c in cat) + ")"] + ints)

    qf = (0.0,) * 7
    sig_a, total_a, none_a, info_a = lognormal_fit_v8_from_csv(
        path, beta, beta_sigma, quench_factors=qf)
    photometries, _ = read_track_photometries_csv(path)
    sig_b, total_b, none_b, info_b = photometries_lognormal_fit_v8(
        photometries, beta, beta_sigma, quench_factors=qf)
    assert total_a == total_b == 30
    assert none_a == none_b
    assert sig_a == sig_b
    # fit_info parity includes the intensity TYPES: both paths emit the
    # CSV reader's parsed ints with no alpha adjustment (regression: the
    # native path reported float64, so hashed/CSV'd fit_info differed by
    # whether the native toolchain was present).
    assert info_a == info_b
    # the dominant fitted signals match the planted sequences
    top = max(sig_a, key=sig_a.get)
    assert top[0] in (((("A", 1), ("A", 3))), ((("A", 2),),))


def test_v8_batched_matches_host_at_reference_shape():
    """Config-5 shape (n_cycles=12, max_fluors=5 -> 6,188 sequences/trace,
    the reference's cost warning MCsimlib.py:5426-5466): the matmul scorer
    must agree with the exact host loop trace-for-trace."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from bench import make_v8_workload
    from fluorosequencingimageanalysis_tpu.ops.lognormal import score_traces
    from fluorosequencingimageanalysis_tpu.inference.lognormal import (
        _intensities_to_signal_lognormal_v8)

    T, F, K = 300, 12, 5
    intensities, categories, lfm = make_v8_workload(T, F, K, seed=5)
    seqs, found, _ = score_traces(intensities, categories,
                                  log_fluor_means=lfm, beta_sigma=0.2,
                                  max_possible=K, allow_multidrop=True,
                                  max_deviation=3, chunk=128)
    n_checked = 0
    for i in range(T):
        ref = _intensities_to_signal_lognormal_v8(
            intensities[i].tolist(), beta=30000.0, beta_sigma=0.2,
            max_possible=K, allow_multidrop=True, max_deviation=3,
            categories=categories[i].tolist(), log_fluor_means=lfm.tolist())
        ref_seq = ref[2]
        if ref_seq is None:
            assert not found[i], i
            continue
        assert found[i], i
        assert tuple(int(v) for v in seqs[i]) == ref_seq, \
            (i, tuple(seqs[i]), ref_seq)
        n_checked += 1
    assert n_checked > 250  # nearly all traces must be fittable


def _write_tracks_csv(path, rows, nf=4):
    import csv as _csv
    with open(path, "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(nf)])
        for r in rows:
            w.writerow(r)


def test_v8_csv_native_multichannel_matches_dict_restriction(tmp_path):
    """The native arrays path must refuse multi-channel CSVs exactly
    like the dict path (single beta/quench calibration cannot span
    channels). Regression: it silently fit them together."""
    import pytest
    from fluorosequencingimageanalysis_tpu.inference.lognormal import (
        lognormal_fit_v8_from_csv)

    path = str(tmp_path / "multi.csv")
    cat = "(True, True, False, False)"
    _write_tracks_csv(path, [
        ["ch1", 0, 10, 20, cat, 30000, 29000, 300, 310],
        ["ch2", 0, 11, 21, cat, 30000, 29000, 300, 310]])
    with pytest.raises(NotImplementedError, match="multiple"):
        lognormal_fit_v8_from_csv(path, 30000.0, 0.2,
                                  quench_factors=(0.0,) * 7)


def test_v8_csv_native_dedupes_first_wins_like_dict(tmp_path):
    """Duplicate (channel, field, h, w) rows collapse FIRST-WINS in the
    dict reader (setdefault, MCsimlib.py:2572); the native arrays path
    must match. Regression: it fit every row."""
    from fluorosequencingimageanalysis_tpu.inference.lognormal import (
        lognormal_fit_v8_from_csv, photometries_lognormal_fit_v8)
    from fluorosequencingimageanalysis_tpu.inference.photometries import (
        read_track_photometries_csv)

    path = str(tmp_path / "dup.csv")
    cat = "(True, True, False, False)"
    _write_tracks_csv(path, [
        ["ch1", 0, 10, 20, cat, 31000, 30000, 300, 310],
        ["ch1", 0, 10, 20, cat, 62000, 61000, 600, 620],  # duplicate key
        ["ch1", 0, 15, 25, cat, 29500, 30500, 280, 305]])
    qf = (0.0,) * 7
    native = lognormal_fit_v8_from_csv(path, 30000.0, 0.2,
                                       quench_factors=qf)
    pdict, _ = read_track_photometries_csv(path, head_truncate=0,
                                           tail_truncate=0,
                                           downstep_filtered=False)
    viadict = photometries_lognormal_fit_v8(pdict, 30000.0, 0.2,
                                            quench_factors=qf)
    assert native[1] == viadict[1] == 2  # duplicate dropped on BOTH paths
    assert native[0] == viadict[0]
    assert sorted(native[3]) == sorted(viadict[3])


def test_v8_csv_malformed_cell_raises(tmp_path):
    """A corrupted numeric cell must be loud on both ingestion paths:
    the strict native parser aborts to the Python reader, which raises
    ValueError. Regression: strtod silently parsed '12a45' as 12."""
    import pytest
    from fluorosequencingimageanalysis_tpu.inference.lognormal import (
        lognormal_fit_v8_from_csv)

    path = str(tmp_path / "bad.csv")
    cat = "(True, True, False, False)"
    _write_tracks_csv(path, [
        ["ch1", 0, 10, 20, cat, "12a45", 30000, 300, 310]])
    with pytest.raises(ValueError):
        lognormal_fit_v8_from_csv(path, 30000.0, 0.2,
                                  quench_factors=(0.0,) * 7)

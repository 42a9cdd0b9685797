"""High-level Pipeline facade tests."""

import numpy as np
import pytest

from fluorosequencingimageanalysis_tpu import Pipeline, PipelineConfig
from fluorosequencingimageanalysis_tpu.config import StepfitConfig


def _stack(F=2, C=2, H=64, W=64, seed=0):
    rng = np.random.default_rng(seed)
    stack = rng.normal(400.0, 5.0, (F, C, H, W)).astype(np.float32)
    hh, ww = np.mgrid[0:H, 0:W].astype(np.float64)
    for (h, w) in [(20.3, 30.6), (40.7, 50.2)]:
        stack += (3000.0 * np.exp(-(((hh - h) ** 2) + ((ww - w) ** 2)) /
                                  (2 * 1.3 ** 2))).astype(np.float32)[None,
                                                                     None]
    return stack


def test_pipeline_run_stack_and_cache(tmp_path):
    from fluorosequencingimageanalysis_tpu.utils.checkpoint import \
        ArtifactStore
    from fluorosequencingimageanalysis_tpu.parallel.mesh import make_mesh
    store = ArtifactStore(str(tmp_path / "store"), use_orbax=False)
    pipe = Pipeline(mesh=make_mesh(1), store=store, profile=True)
    stack = _stack()
    out = pipe.run_stack(stack, max_candidates=64)
    assert out["params"].shape[:2] == (2, 2)
    assert out["keep"].any()
    # second call loads from the store (same content key)
    keys = list(store.keys())
    assert len(keys) == 1
    out2 = pipe.run_stack(stack, max_candidates=64)
    np.testing.assert_allclose(out["photometry"], out2["photometry"])
    from fluorosequencingimageanalysis_tpu.utils.profiling import timings
    assert "api/run_stack" in timings()
    # keys= filters the fetched outputs AND gets its own cache entry, so a
    # later full-output call cannot collide with the subset.
    sub = pipe.run_stack(stack, max_candidates=64, keys=("spot_h", "keep"))
    assert set(sub.keys()) == {"spot_h", "keep"}
    np.testing.assert_array_equal(sub["spot_h"], out["spot_h"])
    assert len(list(store.keys())) == 2
    # stack_key short-circuits the content hash (same key -> cache hit).
    from fluorosequencingimageanalysis_tpu.utils.checkpoint import \
        content_key
    sub2 = pipe.run_stack(stack, max_candidates=64,
                          keys=("spot_h", "keep"),
                          stack_key=content_key(np.asarray(stack)))
    np.testing.assert_array_equal(sub2["spot_h"], out["spot_h"])
    assert len(list(store.keys())) == 2


def test_pipeline_stepfit_and_fluor_counts(tmp_path):
    import csv
    import math
    rng = np.random.default_rng(1)
    levels = np.where(np.arange(30) < 12, 50000.0, 2000.0)
    phot = levels[None] + rng.normal(0, 500, (4, 30))
    pipe = Pipeline(config=PipelineConfig(stepfit=StepfitConfig(
        mirror_start=0, chung_kennedy=0)))
    fits = pipe.stepfit(phot)
    assert len(fits) == 4
    for _, _, plateaus, t_filtered in fits:
        assert plateaus[0][0] == 0 and plateaus[-1][1] == 29

    beta = 30000.0
    path = str(tmp_path / "tracks.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(4)])
        for t in range(20):
            seq = (1, 1, 0, 0)
            ints = [int(rng.lognormal(math.log(beta), 0.2)) if v
                    else int(abs(rng.normal(300, 50))) for v in seq]
            w.writerow(["ch1", 0, 10 + t, 20,
                        "(True, True, False, False)"] + ints)
    signals, total, none_count, info = pipe.fluor_counts(
        path, beta=beta, beta_sigma=0.2)
    assert total == 20
    top = max(signals, key=signals.get)
    assert top[0] == (("A", 2),)


def test_pipeline_simulate_signals():
    pipe = Pipeline()
    trie = pipe.simulate_signals({"P1": [("AKCAK", "")]}, 1.0, 0.0, 0.0,
                                 {"K": (1, 2, 3, 4), "C": (2, 4)},
                                 sample_size=5, random_seed=0)
    uniques = trie.find_uniques(None, 1)
    assert len(uniques) >= 1


def test_pipeline_run_files(tmp_path):
    from PIL import Image as PILImage
    from fluorosequencingimageanalysis_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(3)
    paths_by_cycle = []
    for c in range(2):
        cycle = []
        for f in range(2):
            arr = _stack(F=1, C=1, seed=10 + f)[0, 0]
            p = str(tmp_path / f"c{c}_f{f}.png")
            PILImage.fromarray(
                (arr / arr.max() * 65535).astype(np.uint16)).save(p)
            cycle.append(p)
        paths_by_cycle.append(cycle)
    pipe = Pipeline(mesh=make_mesh(1))
    out = pipe.run_files(paths_by_cycle, max_candidates=64)
    assert out["params"].shape[:2] == (2, 2)  # fields x cycles
    assert out["keep"].any()
    import pytest as _pytest
    with _pytest.raises(ValueError):
        pipe.run_files([[paths_by_cycle[0][0]], paths_by_cycle[1]])


def test_fluor_counts_dict_alpha_adjust_matches_csv(tmp_path):
    """The dict branch must honor alpha_adjust exactly like the CSV
    branch (regression: it used to be silently dropped), and must
    reject CSV-reader-only kwargs loudly."""
    import csv
    import math
    import pytest
    from fluorosequencingimageanalysis_tpu.inference.photometries import (
        read_track_photometries_csv)

    rng = np.random.default_rng(3)
    beta = 30000.0
    path = str(tmp_path / "tracks.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(4)])
        for t in range(12):
            seq = (1, 1, 0, 0)
            ints = [int(rng.lognormal(math.log(beta), 0.2)) + 500 if v
                    else int(abs(rng.normal(300, 50))) + 500 for v in seq]
            w.writerow(["ch1", 0, 10 + t, 20,
                        "(True, True, False, False)"] + ints)
    pipe = Pipeline()
    via_csv = pipe.fluor_counts(path, beta=beta, beta_sigma=0.2,
                                alpha_adjust=500.0)
    pdict, _ = read_track_photometries_csv(path, head_truncate=0,
                                           tail_truncate=0,
                                           downstep_filtered=False)
    via_dict = pipe.fluor_counts(pdict, beta=beta, beta_sigma=0.2,
                                 alpha_adjust=500.0)
    assert via_dict[0] == via_csv[0] and via_dict[1] == via_csv[1]
    unadjusted = pipe.fluor_counts(pdict, beta=beta, beta_sigma=0.2)
    assert unadjusted[3] != via_dict[3]  # fit_info reflects the shift

    with pytest.raises(TypeError, match="CSV-reader"):
        pipe.fluor_counts(pdict, beta=beta, beta_sigma=0.2,
                          downstep_filtered=True)


def test_run_timetrace_honors_window_radius_config():
    """run_timetrace's step-fit chain must use config.stepfit.window_radius
    (regression: it always ran at the default 6), agreeing with
    pipe.stepfit on the same photometries."""
    rng = np.random.default_rng(5)
    T, H, W = 20, 96, 96
    hh, ww = np.indices((H, W)).astype(np.float32)
    movie = rng.normal(400., 6., (T, H, W)).astype(np.float32)
    for k in range(6):
        lvl = 2.0
        for f in range(T):
            if f == 9 + (k % 3):
                lvl = 1.0
            movie[f] += lvl * 2600 * np.exp(
                -(((hh - 20 - 10 * k) ** 2) + ((ww - 30 - 8 * k) ** 2))
                / (2 * 1.3 ** 2))
    pipe = Pipeline(config=PipelineConfig(stepfit=StepfitConfig(
        mirror_start=0, chung_kennedy=1, p_threshold=0.01,
        window_radius=9)))
    out = pipe.run_timetrace(movie, max_candidates=64)
    assert out["trace_count"] >= 4
    refits = pipe.stepfit(out["photometries"])
    for i, hw in enumerate(zip(out["traces"]["h"], out["traces"]["w"])):
        assert out["step_fits"][hw].trace == refits[i][3], i


def test_fluor_counts_csv_channel_filter(tmp_path):
    """A multi-channel track CSV raises without a channel restriction
    (one beta cannot calibrate two channels) and fits exactly the
    selected channel's rows with ``channels=[...]`` — on the native
    arrays path AND equal to a physically single-channel CSV."""
    import csv
    import math
    rng = np.random.default_rng(7)
    beta = 30000.0

    def write(path, channels_per_row):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                       [f"FRAME {i}" for i in range(4)])
            for t, ch in enumerate(channels_per_row):
                seq = (1, 1, 0, 0) if ch == "ch1" else (1, 1, 1, 0)
                ints = [int(rng.lognormal(math.log(beta), 0.2)) if v
                        else int(abs(rng.normal(300, 50))) for v in seq]
                w.writerow([ch, 0, 10 + t, 20,
                            str(tuple(bool(v) for v in seq))] + ints)

    rows = ["ch1", "ch2"] * 8
    mixed = str(tmp_path / "mixed.csv")
    write(mixed, rows)
    pipe = Pipeline()
    with pytest.raises(NotImplementedError, match="channels"):
        pipe.fluor_counts(mixed, beta=beta, beta_sigma=0.2)
    signals, total, none_count, info = pipe.fluor_counts(
        mixed, beta=beta, beta_sigma=0.2, channels=["ch1"])
    assert total == 8
    assert all(i[0] == "ch1" for i in info)

    # Equal to reading a CSV that only ever contained ch1 (same rng rows).
    rng = np.random.default_rng(7)
    write(str(tmp_path / "both.csv"), rows)  # replay the interleaved draws
    rng = np.random.default_rng(7)
    only = str(tmp_path / "ch1_only.csv")
    with open(str(tmp_path / "both.csv")) as src, open(only, "w") as dst:
        lines = src.read().splitlines(True)
        dst.write(lines[0])
        dst.writelines(ln for ln in lines[1:] if ln.startswith("ch1"))
    signals2, total2, _, info2 = pipe.fluor_counts(
        only, beta=beta, beta_sigma=0.2)
    assert total2 == total and signals2 == signals
    assert [i[:4] for i in info2] == [i[:4] for i in info]


def test_run_stack_one_shot_keys_iterable(tmp_path):
    """keys may be a one-shot iterable: it must be materialized before
    the store key consumes it. Regression: sorted(keys) drained the
    iterator, compute() filtered out every output, and an EMPTY dict was
    cached under the same key later list-callers compute."""
    from fluorosequencingimageanalysis_tpu.utils.checkpoint import \
        ArtifactStore
    from fluorosequencingimageanalysis_tpu.parallel.mesh import make_mesh
    store = ArtifactStore(str(tmp_path / "store"), use_orbax=False)
    pipe = Pipeline(mesh=make_mesh(1), store=store)
    stack = _stack()
    out = pipe.run_stack(stack, max_candidates=64,
                         keys=iter(["spot_h", "keep"]))
    assert set(out.keys()) == {"spot_h", "keep"}
    # The cached entry serves the equivalent list-keys call.
    out2 = pipe.run_stack(stack, max_candidates=64, keys=["spot_h", "keep"])
    assert set(out2.keys()) == {"spot_h", "keep"}
    np.testing.assert_array_equal(out["spot_h"], out2["spot_h"])


def test_empty_field_stacks_raise_loudly():
    """Zero-field stacks raise a clear ValueError instead of an opaque
    IndexError deep in the group generator."""
    from fluorosequencingimageanalysis_tpu.parallel.mesh import make_mesh
    pipe = Pipeline(mesh=make_mesh(1))
    empty = np.zeros((0, 4, 64, 64), np.float32)
    with pytest.raises(ValueError, match="non-empty"):
        pipe.run_stack(empty)
    with pytest.raises(ValueError, match="non-empty"):
        pipe.run_experiment(empty)


def test_fluor_counts_honors_config_quench_factors(tmp_path):
    """config.lognormal.quench_factors must reach the fit when the call
    omits quench_factors (it was silently replaced by zeros)."""
    import csv
    import math
    from fluorosequencingimageanalysis_tpu.config import LognormalConfig

    beta = 30000.0
    path = str(tmp_path / "tracks.csv")
    rng = np.random.default_rng(5)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(4)])
        for t in range(6):
            seq = (1, 1, 0, 0)
            ints = [int(rng.lognormal(math.log(2 * beta), 0.1)) if v
                    else int(abs(rng.normal(300, 50))) for v in seq]
            w.writerow(["ch1", 0, 10 + t, 20,
                        str(tuple(bool(v) for v in seq))] + ints)

    # Strong quenching shifts every expected log-intensity, changing the
    # decoded signals/fit info vs the zero-quench default
    # (quench_factors[i] quenches count i+1: MCsimlib.py:5514-5516).
    q = (0.0, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5)
    cfg = PipelineConfig(lognormal=LognormalConfig(quench_factors=q))
    base = Pipeline().fluor_counts(path, beta=beta, beta_sigma=0.2,
                                   mesh=None)
    via_cfg = Pipeline(cfg).fluor_counts(path, beta=beta, beta_sigma=0.2,
                                         mesh=None)
    explicit = Pipeline().fluor_counts(path, beta=beta, beta_sigma=0.2,
                                       quench_factors=q, mesh=None)
    assert via_cfg[3] == explicit[3]
    assert via_cfg[3] != base[3]


def test_run_timetrace_honors_config_photometry_min():
    """config.photometry.photometry_min must floor the timetrace
    photometries (the documented fallback silently did nothing)."""
    from fluorosequencingimageanalysis_tpu.config import PhotometryConfig

    rng = np.random.default_rng(1)
    T, H, W = 6, 64, 64
    movie = rng.normal(400.0, 5.0, (T, H, W)).astype(np.float32)
    hh, ww = np.mgrid[0:H, 0:W].astype(np.float64)
    movie += (3000.0 * np.exp(-(((hh - 30.0) ** 2) + ((ww - 32.0) ** 2)) /
                              (2 * 1.3 ** 2))).astype(np.float32)[None]
    floor = 1e7  # above every raw photometry: flooring is unmistakable
    cfg = PipelineConfig(photometry=PhotometryConfig(photometry_min=floor))
    out = Pipeline(cfg).run_timetrace(movie, max_candidates=32,
                                      include_step_fits=False,
                                      include_intermediates=False)
    assert out["trace_count"] >= 1
    assert (out["photometries"] >= floor).all()
    # Explicit None disables flooring regardless of config.
    out2 = Pipeline(cfg).run_timetrace(movie, max_candidates=32,
                                       photometry_min=None,
                                       include_step_fits=False,
                                       include_intermediates=False)
    assert (out2["photometries"] < floor).any()


def test_run_zstack_exhaustive_matches_capped():
    """run_zstack(max_candidates='exhaustive'): the chunked uncapped
    driver over background-subtracted frames gives the same kept spots
    and psfs dicts as a generous single-bucket run."""
    import jax

    from fluorosequencingimageanalysis_tpu.api import Pipeline

    rng = np.random.default_rng(12)
    H = W = 80
    stack = rng.normal(500, 5, (3, H, W)).astype(np.float32)
    yy, xx = np.indices((H, W)).astype(np.float32)
    stack += 0.4 * xx
    for t in range(3):
        for _ in range(6):
            h, w = rng.integers(10, H - 10, 2)
            stack[t] += 3000 * np.exp(
                -(((yy - h) ** 2) + ((xx - w) ** 2)) / (2 * 1.2 ** 2))
    pipe = Pipeline()
    a = pipe.run_zstack(stack, box_size=8, filter_size=3,
                        max_candidates=512, psfs=True)
    b = pipe.run_zstack(stack, box_size=8, filter_size=3,
                        max_candidates="exhaustive", psfs=True)
    np.testing.assert_array_equal(a["cand_count"], b["cand_count"])
    for t in range(3):
        ka = set(zip(np.asarray(a["cand_h"])[t][
                        np.asarray(a["keep"])[t]].tolist(),
                     np.asarray(a["cand_w"])[t][
                        np.asarray(a["keep"])[t]].tolist()))
        kb = set(zip(b["cand_h"][t][b["keep"][t]].tolist(),
                     b["cand_w"][t][b["keep"][t]].tolist()))
        assert ka == kb
        assert set(a["psfs"][t]) == set(b["psfs"][t])


def test_run_zstack_lean_matches_full():
    """lean=True (keep-first compacted fetch) returns bit-identical kept
    fits and metrics to the full-schema fetch, with spot_count exact and
    ledger counters showing fewer fetch bytes."""
    from fluorosequencingimageanalysis_tpu.api import Pipeline
    from fluorosequencingimageanalysis_tpu.utils import profiling

    rng = np.random.default_rng(7)
    H = W = 80
    stack = rng.normal(500, 5, (4, H, W)).astype(np.float32)
    yy, xx = np.indices((H, W)).astype(np.float32)
    for t in range(4):
        for _ in range(5):
            h, w = rng.integers(10, H - 10, 2)
            stack[t] += 3000 * np.exp(
                -(((yy - h) ** 2) + ((xx - w) ** 2)) / (2 * 1.2 ** 2))
    pipe = Pipeline()
    profiling.reset_counters()
    full = pipe.run_zstack(stack, box_size=8, filter_size=3,
                           max_candidates=256)
    full_bytes = profiling.counters()["ledger/fetch_bytes"]
    profiling.reset_counters()
    lean = pipe.run_zstack(stack, box_size=8, filter_size=3,
                           max_candidates=256, lean=True, max_spots=64)
    lean_ledger = profiling.counters()
    assert lean_ledger["ledger/fetch_bytes"] < full_bytes
    assert lean_ledger["ledger/uploads"] >= 1

    np.testing.assert_array_equal(full["cand_count"], lean["cand_count"])
    for t in range(4):
        fk = np.asarray(full["keep"])[t].astype(bool)
        lk = lean["keep"][t].astype(bool)
        assert int(lean["spot_count"][t]) == int(fk.sum()) == int(lk.sum())
        # Kept fits: identical sets of (cand, center, params, metrics).
        def rows(out, t, m):
            return {tuple(np.asarray(x)[t][m][i] for x in
                          (out["cand_h"], out["cand_w"], out["center_h"],
                           out["center_w"], out["rmse"], out["r2"],
                           out["s_n"]))
                    for i in range(int(m.sum()))}
        assert rows(full, t, fk) == rows(lean, t, lk)


def test_run_zstack_lean_overflow_warns():
    from fluorosequencingimageanalysis_tpu.api import Pipeline

    rng = np.random.default_rng(8)
    H = W = 64
    stack = rng.normal(500, 5, (2, H, W)).astype(np.float32)
    yy, xx = np.indices((H, W)).astype(np.float32)
    for t in range(2):
        for _ in range(8):
            h, w = rng.integers(8, H - 8, 2)
            stack[t] += 3000 * np.exp(
                -(((yy - h) ** 2) + ((xx - w) ** 2)) / (2 * 1.2 ** 2))
    pipe = Pipeline()
    with pytest.warns(UserWarning, match="kept fits exceed"):
        pipe.run_zstack(stack, box_size=8, filter_size=3,
                        max_candidates=256, lean=True, max_spots=2)
    with pytest.raises(ValueError, match="lean=True requires"):
        pipe.run_zstack(stack, max_candidates="exhaustive", lean=True)


def test_run_experiment_needs_no_pillow_or_sklearn(tmp_path):
    """Importing Pipeline and running an experiment to its CSV needs only
    JAX, numpy and scipy: Pillow and scikit-learn are blocked."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"""
import sys
for name in ("PIL", "PIL.Image", "sklearn", "sklearn.mixture",
             "sklearn.cluster"):
    sys.modules[name] = None
import numpy as np
from fluorosequencingimageanalysis_tpu import Pipeline
from fluorosequencingimageanalysis_tpu.parallel.mesh import make_mesh
rng = np.random.default_rng(0)
stack = rng.normal(400.0, 8.0, (1, 2, 48, 48)).astype(np.float32)
hh, ww = np.indices((48, 48))
stack += 3000.0 * np.exp(-((hh - 20) ** 2 + (ww - 25) ** 2) / 3.4)
out = Pipeline(mesh=make_mesh(1)).run_experiment(
    stack, csv_path={str(tmp_path / "t.csv")!r}, max_candidates=64)
assert out["rows"], out
assert "PIL" not in [m for m, v in sys.modules.items() if v is not None]
print("ROWS", len(out["rows"]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ROWS" in proc.stdout

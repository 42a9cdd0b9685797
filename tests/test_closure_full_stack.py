"""Framework-wide closure test: planted fluor-count ground truth ->
rendered cycle stacks -> run_experiment (align + detect/fit + track +
interpolate + photometry + CSV) -> v8 fluor counting -> the recovered
per-trace fluor-count sequences match the plant.

This is the image-level analog of the reference's closure strategy
(SURVEY section 4: simulate with known truth, run the same fitters —
/root/reference/simulate_peptide.py:271-285 does it at the signals level;
the Zenodo Docker walkthrough at the image level). Every subsystem is on
the path: registration must undo the planted drift, detection must find
every spot, tracking must follow them through the drift, interpolation
must fill the post-bleach holes, photometry must recover the planted
intensities, and the v8 scorer must decode the fluor counts.
"""

import numpy as np
from oracles import planted_unit_psf

from fluorosequencingimageanalysis_tpu import Pipeline
from fluorosequencingimageanalysis_tpu.parallel.mesh import make_mesh


def _render_experiment(rng, F=2, C=6, H=128, W=128, beta=30000.0,
                       beta_sigma=0.1):
    """Plant a grid of spots with known fluor-count trajectories.

    Each spot starts with k0 in {1,2,3} fluors and loses exactly one at a
    known drop cycle; amplitudes are scaled so the mexican-hat photometry
    (7x7 crown, background cancelled by the brim median) reads the planted
    lognormal intensity exp(log beta + log k + N(0, beta_sigma)).
    """
    unit = planted_unit_psf()
    r = unit.shape[0] // 2
    u_crown = unit[r - 3:r + 4, r - 3:r + 4].sum()
    # Cumulative integer drift per cycle (what registration must recover).
    drift = [(0, 0), (1, -1), (2, 0), (0, 1), (-1, 2), (1, 1)][:C]

    stack = rng.normal(400.0, 8.0, (F, C, H, W))
    plants = {}  # (field, h, w) -> planted fluor-count sequence
    # A 25 x 40 px grid filling the field (12 spots at 128 x 128).
    base_pos = [(h, w) for h in range(20, H - 20, 25)
                for w in range(24, W - 20, 40)]
    for f in range(F):
        for i, (h0, w0) in enumerate(base_pos):
            h = h0 + int(rng.integers(-3, 4))
            w = w0 + int(rng.integers(-3, 4))
            k0 = 1 + (i % 3)
            drop = int(rng.integers(1, C))  # lose one fluor at this cycle
            seq = tuple(k0 if c < drop else k0 - 1 for c in range(C))
            plants[(f, h, w)] = seq
            for c, k in enumerate(seq):
                if k == 0:
                    continue
                intensity = np.exp(np.log(beta) + np.log(k) +
                                   rng.normal(0.0, beta_sigma))
                hc, wc = h + drift[c][0], w + drift[c][1]
                stack[f, c, hc - r:hc + r + 1, wc - r:wc + r + 1] += (
                    (intensity / u_crown) * unit)
    return stack.astype(np.float32), plants


def test_full_stack_closure(tmp_path):
    rng = np.random.default_rng(42)
    beta = 30000.0
    stack, plants = _render_experiment(rng, beta=beta)
    F, C = stack.shape[:2]

    pipe = Pipeline(mesh=make_mesh(1))
    csv_path = str(tmp_path / "tracks.csv")
    # candidate_radius=3 (not the reference's default 2): the agpy axis
    # quirk (pflib.py:196-213) + the r_2 coin flip among the blob of
    # above-threshold candidates around one peak (pflib.py:478-520) can
    # transpose the rounded key diagonally by (±1, ∓1) per cycle, so two
    # consecutive keys of the SAME physical spot can sit 2*sqrt(2) ~ 2.83
    # px apart in aligned coordinates — past the radius-2 gate. The
    # reference would split identically; radius 3 covers the wobble.
    out = pipe.run_experiment(stack, csv_path=csv_path, max_candidates=256,
                              candidate_radius=3)

    # Every planted spot must come back as a trace (dim noise spots that
    # survive the R^2 filter may add extra traces — real data has them
    # too; consolidation radius 4 guarantees independent spots never sit
    # on a plant).
    rows = out["rows"]
    assert len(rows) >= len(plants)

    signals, total, none_count, fit_info = pipe.fluor_counts(
        csv_path, beta=beta, beta_sigma=0.12)
    assert total == len(rows)

    # A plant may map to MORE than one trace: the agpy axis quirk
    # (reference parity — gaussfitter's transposed center, pflib.py:196-213
    # + the r_2 coin flip in consolidation, pflib.py:478-520) can wobble
    # the rounded key diagonally by (±1, ∓1) between cycles, and the
    # reference's candidate_radius=2 tracking gate then splits the trace
    # exactly as the reference would. So score per PLANT: recall = some
    # trace lands within 2 px; decode = some nearby trace recovers the
    # exact planted fluor-count sequence.
    matched, decoded = set(), set()
    for info in fit_info:
        field, h, w, best_seq = int(info[1]), info[2], info[3], info[9]
        for (pf, ph, pw), seq in plants.items():
            if pf == field and (ph - h) ** 2 + (pw - w) ** 2 <= 8:
                matched.add((pf, ph, pw))
                if best_seq is not None and tuple(best_seq) == seq:
                    decoded.add((pf, ph, pw))
                break
    # 100% recall: every plant tracked through the drift and fitted.
    assert len(matched) == len(plants), (
        sorted(set(plants) - matched), len(plants))
    # The v8 decode recovers the exact planted fluor-count sequence for
    # nearly every plant (beta separation log(2) >> beta_sigma).
    assert len(decoded) >= 0.9 * len(plants), (len(decoded), len(plants))

"""Movie-workflow closure test: planted bleach-step ground truth ->
rendered movie -> run_timetrace (detect + LC tracking + photometry +
step-fit chain) -> the recovered plateaus match the plant.

Complements tests/test_closure_full_stack.py (the cycle-stack workflow)
at the image level for the reference's timetrace workflow
(/root/reference/basic_timetrace_script.py, flexlibrary.py:3309-3709):
detection must find every spot in frame 0, luminosity-centroid tracking
must hold them (and drop them when they bleach dark), photometry must
read the planted k*beta levels, and the mirror -> Chung-Kennedy ->
sliding-t -> refit -> t-merge chain must place a step at every planted
bleach frame.
"""

import numpy as np
from oracles import planted_unit_psf

from fluorosequencingimageanalysis_tpu import Pipeline
from fluorosequencingimageanalysis_tpu.parallel.mesh import make_mesh


def _render_movie(rng, T=72, H=96, W=96, beta=20000.0, noise=8.0,
                  spacing=28, bleach_slots=None):
    """Plant a grid of spots (``spacing`` px apart; 3x3 at 96 x 96) with
    known bleach frames.

    Spot i starts with k0 in {1,2,3} fluors (capped at the number of
    bleach slots) and loses one at each of k0 known frames, drawn from
    ``bleach_slots`` (default: every 10th frame from 14 to T - 8);
    per-frame amplitude is k(t)*beta with 1% multiplicative jitter,
    scaled so the mexican-hat crown reads k(t)*beta.
    """
    if bleach_slots is None:
        # Bleach frames past the sliding-t warmup (the reference fitter
        # cannot place steps in the first window_radius frames) and >= 10
        # frames apart so every plateau outlasts the test window.
        bleach_slots = np.arange(14, T - 8, 10)
    max_k0 = min(3, len(bleach_slots))
    unit = planted_unit_psf()
    r = unit.shape[0] // 2
    u_crown = unit[r - 3:r + 4, r - 3:r + 4].sum()
    movie = rng.normal(400.0, noise, (T, H, W))
    plants = {}  # (h, w) -> (k0, bleach frames)
    base = [(h, w) for h in range(20, H - 19, spacing)
            for w in range(20, W - 19, spacing)]
    for i, (h0, w0) in enumerate(base):
        h = h0 + int(rng.integers(-2, 3))
        w = w0 + int(rng.integers(-2, 3))
        k0 = 1 + (i % max_k0)
        frames = sorted(int(f) for f in rng.choice(
            bleach_slots, size=k0, replace=False))
        k = np.full(T, k0)
        for j, bf in enumerate(frames):
            k[bf:] = k0 - 1 - j
        plants[(h, w)] = (k0, frames)
        for t in range(T):
            if k[t] == 0:
                continue
            intensity = k[t] * beta * (1.0 + 0.01 * rng.normal())
            movie[t, h - r:h + r + 1, w - r:w + r + 1] += (
                (intensity / u_crown) * unit)
    return movie.astype(np.float32), plants


def test_timetrace_closure(tmp_path):
    rng = np.random.default_rng(7)
    beta = 20000.0
    movie, plants = _render_movie(rng, beta=beta)
    T = movie.shape[0]

    pipe = Pipeline(mesh=make_mesh(1))
    csv_path = str(tmp_path / "timetrace.csv")
    out = pipe.run_timetrace(movie, csv_path=csv_path, max_candidates=256)

    # 100% recall, no phantoms: exactly one trace per planted spot.
    assert out["trace_count"] == len(plants)

    matched = set()
    for (hh, ww), pt in out["step_fits"].items():
        d2, ph, pw = min(((ph - hh) ** 2 + (pw - ww) ** 2, ph, pw)
                         for (ph, pw) in plants)
        assert d2 <= 8, f"trace at ({hh},{ww}) matches no plant"
        assert (ph, pw) not in matched
        matched.add((ph, pw))
        k0, frames = plants[(ph, pw)]
        plateaus = pt.trace
        # Recovered SIGNIFICANT down steps. LC recentering shifts the
        # mexican-hat window by a pixel now and then, which moves the
        # captured flux fraction ~1% — a real (and reference-faithful)
        # sub-steplet the t-test can legitimately split a plateau on; a
        # bleach step is >= beta, so gate on a quarter of it.
        recovered = [
            int(plateaus[j + 1][0]) for j in range(len(plateaus) - 1)
            if plateaus[j][2] - plateaus[j + 1][2] >= 0.25 * beta]
        assert recovered == frames, (
            (ph, pw), frames, recovered,
            [(s, e, round(h)) for (s, e, h) in plateaus])
        # Plateau levels read the planted k*beta within 5% (k0..1), and
        # the post-bleach tail is dark.
        k = np.full(T, k0)
        for j, bf in enumerate(frames):
            k[bf:] = k0 - 1 - j
        for t in (frames[0] - 1,
                  *[frames[j] + 1 for j in range(len(frames))]):
            level = pt.photometry(t)
            if k[t] > 0:
                assert abs(level - k[t] * beta) <= 0.05 * k[t] * beta, (
                    t, level, k[t] * beta)
            else:
                assert abs(level) < 0.01 * beta, (t, level)
    assert len(matched) == len(plants)

    # The CSV landed with one block per (trace, frame).
    with open(csv_path) as f:
        n_lines = sum(1 for _ in f)
    assert n_lines == 1 + len(plants) * T

"""Tests for candidate detection + whole-field spot finding."""

import numpy as np
from scipy.ndimage import median_filter as scipy_median_filter
from scipy.signal import correlate as scipy_correlate

from fluorosequencingimageanalysis_tpu.ops.candidates import (
    DEFAULT_CORRELATION_MATRIX, candidate_map, median_filter_2d,
    correlate_2d_same, find_candidates)
from fluorosequencingimageanalysis_tpu.models.detect import find_peptides

from oracles import gauss2d_oracle


def _synthetic_field(rng, shape=(128, 128), n_spots=12, background=400.0,
                     noise=8.0, amp=(1500, 4000)):
    """Plant well-separated Gaussian spots on a noisy background."""
    img = background + rng.normal(0, noise, shape)
    truths = []
    placed = []
    attempts = 0
    while len(truths) < n_spots and attempts < 2000:
        attempts += 1
        h = rng.integers(8, shape[0] - 8)
        w = rng.integers(8, shape[1] - 8)
        if any((h - ph) ** 2 + (w - pw) ** 2 < 18 ** 2 for ph, pw in placed):
            continue
        placed.append((h, w))
        A = rng.uniform(*amp)
        sh = rng.uniform(1.0, 1.5)
        hh, ww = np.indices(shape).astype(float)
        img += A * np.exp(-(((hh - h) ** 2) + ((ww - w) ** 2)) / (2 * sh ** 2))
        truths.append((h, w, A, sh))
    return img, truths


def test_median_filter_matches_scipy_even_size():
    """Even window sizes put the extra tap on the NEGATIVE side, like
    scipy's origin convention (regression: it sat on the positive side,
    shifting the background estimate one pixel for even sizes)."""
    rng = np.random.default_rng(8)
    img = rng.normal(400, 10, (48, 48))
    for size in (2, 4, 6):
        ours = np.asarray(median_filter_2d(img, size))
        theirs = scipy_median_filter(img, size, mode="reflect")
        np.testing.assert_allclose(ours, theirs, rtol=1e-12,
                                   err_msg=f"size={size}")


def test_median_filter_matches_scipy():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 5000, (64, 64)).astype(np.float64)
    ours = np.asarray(median_filter_2d(img, 5))
    theirs = scipy_median_filter(img, 5, mode="reflect")
    np.testing.assert_allclose(ours, theirs)


def test_correlate_matches_scipy():
    rng = np.random.default_rng(1)
    img = rng.normal(0, 100, (64, 64))
    ours = np.asarray(correlate_2d_same(
        img, np.asarray(DEFAULT_CORRELATION_MATRIX)))
    theirs = scipy_correlate(img, DEFAULT_CORRELATION_MATRIX, mode="same")
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-6)


def test_candidate_map_matches_reference_recipe():
    """End-to-end candidate mask vs a direct NumPy/SciPy transcription of the
    reference recipe (pflib.py:240-258)."""
    rng = np.random.default_rng(2)
    img, _ = _synthetic_field(rng, n_spots=6)
    img = np.round(img).astype(np.int64)

    image_mf = img - np.minimum(scipy_median_filter(img, 5, mode="reflect"),
                                img)
    image_cm = np.maximum(
        scipy_correlate(image_mf, DEFAULT_CORRELATION_MATRIX.astype(np.int64),
                        mode="same"), 0)
    thr = image_cm.mean() + 2 * image_cm.std()
    ref_mask = np.zeros(img.shape, bool)
    ref_mask[2:-2, 2:-2] = image_cm[2:-2, 2:-2] >= thr

    _, ours_mask = candidate_map(img.astype(np.float64))
    np.testing.assert_array_equal(np.asarray(ours_mask), ref_mask)


def test_find_candidates_count_and_coords():
    rng = np.random.default_rng(3)
    img, truths = _synthetic_field(rng, n_spots=6)
    hs, ws, valid, count = find_candidates(img.astype(np.float64),
                                           max_candidates=512)
    hs, ws, valid = map(np.asarray, (hs, ws, valid))
    assert int(count) == valid.sum()
    # Every planted spot center must appear among candidates.
    cand = set(zip(hs[valid].tolist(), ws[valid].tolist()))
    for h, w, *_ in truths:
        assert any((h + dh, w + dw) in cand
                   for dh in (-1, 0, 1) for dw in (-1, 0, 1)), (h, w)


def test_find_peptides_recovers_spots():
    rng = np.random.default_rng(4)
    img, truths = _synthetic_field(rng, n_spots=10)
    img = np.round(img).astype(np.uint16)
    psfs = find_peptides(img, dtype=np.float64)
    # Each planted spot yields exactly one surviving PSF near its center.
    for h, w, A, sh in truths:
        matches = [k for k in psfs
                   if (k[0] - h) ** 2 + (k[1] - w) ** 2 <= 2 ** 2]
        assert len(matches) == 1, (h, w, matches)
        key = matches[0]
        (h_0, w_0, H, Afit, sigma_h, sigma_w, theta, sub_img, fit_img,
         rmse_v, r_2, s_n) = psfs[key]
        assert r_2 >= 0.7
        assert sub_img.shape == (5, 5) and fit_img.shape == (5, 5)
        assert sub_img.dtype == np.int64
        # Reported center near the planted center. Tolerance 2.0: the agpy
        # axis quirk swaps in-patch offsets between h_0/w_0, so when the
        # winning candidate pixel is off-center the reported center can be
        # up to ~1.5 px off — faithful to the reference's own outputs.
        assert abs(h_0 - h) < 2.0 and abs(w_0 - w) < 2.0
    # No spurious far-away detections beyond the planted spots.
    for k in psfs:
        assert any((k[0] - h) ** 2 + (k[1] - w) ** 2 <= 3 ** 2
                   for h, w, *_ in truths), k


def test_no_duplicate_keys_after_consolidation():
    rng = np.random.default_rng(5)
    img, _ = _synthetic_field(rng, n_spots=10)
    psfs = find_peptides(np.round(img).astype(np.uint16), dtype=np.float64)
    keys = list(psfs)
    # Consolidation guarantees pairwise distance > radius for rounded keys.
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            d2 = ((keys[i][0] - keys[j][0]) ** 2 +
                  (keys[i][1] - keys[j][1]) ** 2)
            assert d2 > 4 ** 2


def test_monte_carlo_fit_path_runs():
    rng = np.random.default_rng(6)
    img, truths = _synthetic_field(rng, n_spots=4)
    psfs = find_peptides(np.round(img).astype(np.uint16), dtype=np.float64,
                         fit_type="monte_carlo", N_iter=300)
    assert len(psfs) >= 1
    for k, v in psfs.items():
        assert 0 <= v[10] <= 1.0 or v[10] < 0  # r_2 well-formed
        # Normalized sub_img in [0, 1] (reference normalizes in place).
        assert v[7].min() >= 0 and v[7].max() <= 1.0


def test_consolidate_fixpoint_equals_scan():
    """The parallel fixpoint NMS must match the sequential greedy scan
    exactly, including r2 ties and dense rival chains."""
    import jax.numpy as jnp
    from fluorosequencingimageanalysis_tpu.ops.consolidate import (
        consolidate, _consolidate_scan)
    rng = np.random.default_rng(42)
    for trial in range(8):
        n = 256
        span = 40 if trial % 2 == 0 else 500  # dense chains vs sparse
        ch = jnp.asarray(rng.uniform(0, span, n))
        cw = jnp.asarray(rng.uniform(0, span, n))
        r2 = jnp.asarray(np.round(rng.uniform(0, 1, n), 2))  # force ties
        valid = jnp.asarray(rng.uniform(0, 1, n) < 0.6)
        a = np.asarray(consolidate(ch, cw, r2, valid))
        b = np.asarray(_consolidate_scan(ch, cw, r2, valid))
        assert (a == b).all(), f"trial {trial}"
        assert not a[~np.asarray(valid)].any()


def test_consolidate_nan_rival_pairs():
    """NaN-R^2 fits rank at -inf: exactly one member of every rival pair
    survives (the reference's scan deletes exactly one under ANY dict
    order, pflib.py:507-511 — a NaN comparison takes the delete-self
    branch), the finite member wins a NaN/finite pair, and an isolated
    NaN fit is kept. Fixpoint and scan backends must agree. Regression:
    NaN compared false both ways in the priority predicate, so a
    NaN/finite rival pair kept BOTH spots."""
    import jax.numpy as jnp
    from fluorosequencingimageanalysis_tpu.ops.consolidate import (
        consolidate, _consolidate_scan)
    # [finite, NaN] rivals; [NaN, NaN] rivals; one isolated NaN.
    ch = jnp.asarray([10.0, 11.0, 50.0, 51.0, 100.0])
    cw = jnp.asarray([10.0, 11.0, 50.0, 51.0, 100.0])
    r2 = jnp.asarray([0.9, np.nan, np.nan, np.nan, np.nan])
    valid = jnp.ones(5, bool)
    a = np.asarray(consolidate(ch, cw, r2, valid, radius=4.0))
    b = np.asarray(_consolidate_scan(ch, cw, r2, valid, radius=4.0))
    assert (a == b).all()
    assert a.tolist() == [True, False, True, False, True]


def test_hierarchical_extraction_equals_flat():
    """The two-stage blocked top-k extraction must select the same
    candidate set as the flat top_k, including the overflow fallback."""
    import jax.numpy as jnp
    from fluorosequencingimageanalysis_tpu.ops.candidates import (
        _threshold_and_extract, _threshold_and_extract_batch)
    rng = np.random.default_rng(7)
    # heavy-tailed maps -> sparse above-threshold pixels (cheap exact path)
    cms = jnp.asarray(np.abs(rng.normal(0, 1, (3, 128, 128)) ** 3))
    hs_b, ws_b, val_b, cnt_b = _threshold_and_extract_batch(cms, 256, 2.0)
    for i in range(cms.shape[0]):
        hs, ws, val, cnt = _threshold_and_extract(cms[i], 256, 2.0)
        assert int(cnt) == int(cnt_b[i])
        flat_set = set(zip(np.asarray(hs)[np.asarray(val)].tolist(),
                           np.asarray(ws)[np.asarray(val)].tolist()))
        blk_set = set(zip(np.asarray(hs_b[i])[np.asarray(val_b[i])].tolist(),
                          np.asarray(ws_b[i])[np.asarray(val_b[i])].tolist()))
        assert flat_set == blk_set

    # dense maps: many blocks exceed block_m -> cond falls back to the
    # flat sort, still exact
    dense = jnp.asarray(rng.uniform(0.9, 1.0, (2, 64, 64)) +
                        np.where(rng.uniform(0, 1, (2, 64, 64)) < 0.5,
                                 10.0, 0.0))
    hs_b, ws_b, val_b, cnt_b = _threshold_and_extract_batch(dense, 512, 0.0)
    for i in range(2):
        hs, ws, val, cnt = _threshold_and_extract(dense[i], 512, 0.0)
        assert int(cnt) == int(cnt_b[i])
        flat_set = set(zip(np.asarray(hs)[np.asarray(val)].tolist(),
                           np.asarray(ws)[np.asarray(val)].tolist()))
        blk_set = set(zip(np.asarray(hs_b[i])[np.asarray(val_b[i])].tolist(),
                          np.asarray(ws_b[i])[np.asarray(val_b[i])].tolist()))
        assert flat_set == blk_set


def test_find_peptides_batch_matches_single():
    import jax.numpy as jnp
    from fluorosequencingimageanalysis_tpu.models.detect import (
        find_peptides, find_peptides_batch)
    rng = np.random.default_rng(5)
    imgs = rng.normal(400, 8, (3, 64, 64)).astype(np.float64)
    hh, ww = np.mgrid[0:64, 0:64].astype(np.float64)
    for b in range(3):
        for (h, w) in [(20.3, 30.6), (40.7, 50.2)]:
            imgs[b] += 3000.0 * np.exp(
                -(((hh - h) ** 2) + ((ww - w) ** 2)) / (2 * 1.3 ** 2))
    batched = find_peptides_batch(imgs, max_candidates=64, num_iters=40)
    for b in range(3):
        single = find_peptides(imgs[b], max_candidates=64, num_iters=40)
        assert set(batched[b].keys()) == set(single.keys())
        for k in single:
            np.testing.assert_allclose(batched[b][k][:7], single[k][:7],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(batched[b][k][7], single[k][7])


def test_candidate_pixels_silently_ignored_reference_parity():
    """The reference documents candidate_pixels as not implemented and
    unconditionally overwrites it (pflib.py:374, 434) — a passed value
    must be ignored, not raise."""
    import numpy as np
    from fluorosequencingimageanalysis_tpu.models.detect import find_peptides

    rng = np.random.default_rng(0)
    img = rng.normal(400.0, 8.0, (64, 64)).astype(np.float32)
    hh, ww = np.indices((64, 64)).astype(np.float32)
    img += 3000 * np.exp(-(((hh - 30) ** 2) + ((ww - 40) ** 2)) / (2 * 1.3 ** 2))
    base = find_peptides(img, max_candidates=64)
    passed = find_peptides(img, max_candidates=64,
                           candidate_pixels=[(5, 5), (10, 10)])
    assert sorted(base.keys()) == sorted(passed.keys())


def test_find_candidates_image_smaller_than_bucket():
    """Images with fewer pixels than max_candidates must work (top_k
    requires k <= n; regression: 48x48 with the default 4096 crashed)."""
    import jax.numpy as jnp
    from fluorosequencingimageanalysis_tpu.ops.candidates import (
        find_candidates, find_candidates_batch)

    rng = np.random.default_rng(0)
    img = rng.normal(400, 8, (48, 48)).astype(np.float32)
    img[20:25, 20:25] += 3000
    hs, ws, valid, count = find_candidates(jnp.asarray(img))
    assert hs.shape == (4096,) and int(count) >= 1
    assert int(valid.sum()) == int(count)
    bh, bw, bv, bc = find_candidates_batch(jnp.asarray(img[None]))
    assert bh.shape == (1, 4096) and int(bc[0]) == int(count)
    np.testing.assert_array_equal(np.sort(np.asarray(hs)[np.asarray(valid)]),
                                  np.sort(np.asarray(bh[0])[np.asarray(bv[0])]))


def test_find_candidates_batch_pallas_honors_parameters():
    """The batched candidate path honors a non-default
    median_filter_size: it matches the single-image candidate map
    (ops.candidates.candidate_map) at size 3, candidate for candidate."""
    import jax.numpy as jnp
    from fluorosequencingimageanalysis_tpu.ops.candidates import (
        find_candidates, find_candidates_batch)

    rng = np.random.default_rng(1)
    img = rng.normal(400, 8, (1, 96, 96)).astype(np.float32)
    img[0, 30:35, 40:45] += 2500
    hs, ws, valid, count = find_candidates_batch(
        jnp.asarray(img), median_filter_size=3, max_candidates=512)
    h1, w1, v1, c1 = find_candidates(jnp.asarray(img[0]),
                                     median_filter_size=3,
                                     max_candidates=512)
    assert int(count[0]) == int(c1)
    got = set(zip(np.asarray(hs[0])[np.asarray(valid[0])].tolist(),
                  np.asarray(ws[0])[np.asarray(valid[0])].tolist()))
    want = set(zip(np.asarray(h1)[np.asarray(v1)].tolist(),
                   np.asarray(w1)[np.asarray(v1)].tolist()))
    assert got == want


def test_nan_r2_fit_is_kept_like_reference(monkeypatch):
    """A fit with NaN R^2 (constant patch: ss_tot == ss_res == 0) passes
    the reference's discard-if-less gate (pflib.py:465-467: NaN < thr is
    False) — the spot is KEPT. Regression: (r2 >= thr) silently dropped
    it. The candidate finder is stubbed so a constant-image patch
    actually reaches the fit (the real candidate map zeroes flat tops)."""
    import jax.numpy as jnp
    from fluorosequencingimageanalysis_tpu.models import detect as det

    def fake_candidates(images, **kw):
        B = images.shape[0]
        mc = kw["max_candidates"]
        hs = jnp.full((B, mc), 16, jnp.int32)
        ws = jnp.full((B, mc), 16, jnp.int32)
        valid = jnp.zeros((B, mc), bool).at[:, 0].set(True)
        return hs, ws, valid, jnp.ones((B,), jnp.int32)

    monkeypatch.setattr(det, "find_candidates_batch", fake_candidates)
    # All-zero image: the LM amplitude initializes AT its lower bound
    # ((max - mean) / 3 = 0) and stays pegged, so the fit is EXACTLY the
    # data -> ss_res = ss_tot = 0 -> r2 = NaN, deterministically (a
    # nonzero constant leaves a sub-ulp residual whose f32 rounding
    # flips between NaN and -inf).
    img = np.zeros((32, 32), np.float32)
    res = det.detect_and_fit_batch(jnp.asarray(img[None]), max_candidates=3,
                                   num_iters=8)
    r2 = float(np.asarray(res.r2)[0, 0])
    assert np.isnan(r2), f"constant patch should fit exactly (r2={r2})"
    assert bool(np.asarray(res.keep)[0, 0]), \
        "NaN-R^2 fit must be kept like the reference"


def test_consolidate_host_equals_scan():
    """The host greedy NMS (the exhaustive chunked path's backend,
    ops.consolidate.consolidate_host) is identical to the device
    executable spec across dense rival chains, ties, NaN scores and
    invalid entries."""
    import jax.numpy as jnp
    from fluorosequencingimageanalysis_tpu.ops.consolidate import (
        consolidate_host, _consolidate_scan)

    rng = np.random.default_rng(11)
    for trial in range(12):
        n = int(rng.integers(3, 120))
        # Cluster centers tightly so rival chains of depth > 2 occur.
        ch = rng.uniform(0, 28, n).astype(np.float32)
        cw = rng.uniform(0, 28, n).astype(np.float32)
        r2 = rng.uniform(0, 1, n).astype(np.float32)
        # Inject exact ties and NaNs.
        if n > 10:
            r2[1] = r2[0]
            r2[2] = np.nan
        valid = rng.uniform(size=n) > 0.15
        a = consolidate_host(ch, cw, r2, valid, radius=4.0)
        b = np.asarray(_consolidate_scan(jnp.asarray(ch), jnp.asarray(cw),
                                         jnp.asarray(r2), jnp.asarray(valid),
                                         radius=4.0))
        np.testing.assert_array_equal(a, b, err_msg=f"trial={trial}")


def test_exhaustive_chunked_equals_single_bucket():
    """detect_and_fit_exhaustive with a tiny chunk (forcing many chunks +
    the host NMS) matches the single-bucket device program candidate for
    candidate — the parity contract that lets the chunked path replace
    the capped one on backends whose compiler can't build big buckets."""
    from fluorosequencingimageanalysis_tpu.models.detect import (
        detect_and_fit, detect_and_fit_exhaustive)

    rng = np.random.default_rng(5)
    img, _ = _synthetic_field(rng, shape=(96, 96), n_spots=14)
    img = img.astype(np.float32)
    ref = detect_and_fit(img, max_candidates=512, num_iters=25)
    count = int(ref.cand_count)
    assert count > 64, "field too sparse for a multi-chunk test"
    res = detect_and_fit_exhaustive(img[None], chunk=32, num_iters=25)
    assert int(res.cand_count[0]) == count
    k_ref = np.asarray(ref.keep)
    k_chk = res.keep[0]
    ref_kept = {(int(h), int(w)): (float(ch), float(cw), float(r))
                for h, w, ch, cw, r in zip(
                    np.asarray(ref.cand_h)[k_ref],
                    np.asarray(ref.cand_w)[k_ref],
                    np.asarray(ref.center_h)[k_ref],
                    np.asarray(ref.center_w)[k_ref],
                    np.asarray(ref.r2)[k_ref])}
    chk_kept = {(int(h), int(w)): (float(ch), float(cw), float(r))
                for h, w, ch, cw, r in zip(
                    res.cand_h[0][k_chk], res.cand_w[0][k_chk],
                    res.center_h[0][k_chk], res.center_w[0][k_chk],
                    res.r2[0][k_chk])}
    assert set(ref_kept) == set(chk_kept)
    for key in ref_kept:
        np.testing.assert_allclose(ref_kept[key], chk_kept[key], rtol=0,
                                   atol=0, err_msg=str(key))


def test_find_peptide_centers_exhaustive_matches_capped():
    """find_peptide_centers default (max_candidates=None, exhaustive)
    equals the big-bucket capped mode when nothing overflows — the
    reference's uncapped semantics with zero truncation."""
    from fluorosequencingimageanalysis_tpu.models.detect import (
        find_peptide_centers)

    rng = np.random.default_rng(6)
    img, _ = _synthetic_field(rng, shape=(96, 96), n_spots=8)
    img = img.astype(np.float32)
    h_a, w_a, fits_a, count_a = find_peptide_centers(img, num_iters=25)
    h_b, w_b, fits_b, count_b = find_peptide_centers(
        img, max_candidates=1024, num_iters=25)
    assert count_a == count_b
    np.testing.assert_array_equal(h_a, h_b)
    np.testing.assert_array_equal(w_a, w_b)
    assert len(fits_a) == len(fits_b)
    for fa, fb in zip(fits_a, fits_b):
        np.testing.assert_allclose(fa, fb, rtol=0, atol=1e-12)


def test_find_peptides_exhaustive_default_no_truncation(caplog):
    """find_peptides' default is now exhaustive (reference pflib.py has
    no candidate cap): no truncation warnings, dict equal to a capped
    run that fits everything."""
    import logging
    from fluorosequencingimageanalysis_tpu.models.detect import find_peptides

    rng = np.random.default_rng(7)
    img, _ = _synthetic_field(rng, shape=(96, 96), n_spots=6)
    with caplog.at_level(logging.WARNING):
        psfs = find_peptides(img, num_iters=25)
    assert not [r for r in caplog.records if "candidates exceed" in r.message]
    ref = find_peptides(img, max_candidates=1024, num_iters=25)
    assert set(psfs) == set(ref)
    for key in psfs:
        np.testing.assert_allclose(psfs[key][:7], ref[key][:7],
                                   rtol=0, atol=1e-12)


def test_exhaustive_chunked_randomized_sweep():
    """Randomized differential sweep: across random field geometries,
    spot densities and noise levels, the chunked exhaustive driver at a
    FORCED small chunk equals the single-bucket program candidate for
    candidate (keep masks, centers, quality), and covers every
    candidate (count == bucket occupancy of the generous capped run)."""
    from fluorosequencingimageanalysis_tpu.models.detect import (
        detect_and_fit, detect_and_fit_exhaustive)

    rng = np.random.default_rng(13)
    for trial in range(6):
        H = int(rng.integers(48, 112))
        W = int(rng.integers(48, 112))
        n_spots = int(rng.integers(3, 16))
        noise = float(rng.uniform(4, 12))
        img, _ = _synthetic_field(rng, shape=(H, W), n_spots=n_spots,
                                  noise=noise)
        img = img.astype(np.float32)
        ref = detect_and_fit(img, max_candidates=1024, num_iters=20)
        count = int(ref.cand_count)
        chunk = max(16, count // 3)  # force >= 3 chunks
        res = detect_and_fit_exhaustive(img[None], chunk=chunk,
                                        num_iters=20)
        assert int(res.cand_count[0]) == count, trial
        k_ref = np.asarray(ref.keep)
        k_chk = res.keep[0]
        ref_kept = {(int(h), int(w)): (float(ch), float(cw))
                    for h, w, ch, cw in zip(
                        np.asarray(ref.cand_h)[k_ref],
                        np.asarray(ref.cand_w)[k_ref],
                        np.asarray(ref.center_h)[k_ref],
                        np.asarray(ref.center_w)[k_ref])}
        chk_kept = {(int(h), int(w)): (float(ch), float(cw))
                    for h, w, ch, cw in zip(
                        res.cand_h[0][k_chk], res.cand_w[0][k_chk],
                        res.center_h[0][k_chk], res.center_w[0][k_chk])}
        assert ref_kept == chk_kept, (trial, H, W, n_spots)


def test_consolidate_host_float64_boundary_equals_scan():
    """Float64 inputs must compare distances in float64 on host exactly
    like the device scan does in the centers' own dtype (ADVICE r4): a
    center pair exactly radius apart in f64 — but not after an f32
    round — must resolve the same d^2 <= r^2 boundary both ways."""
    import jax
    import jax.numpy as jnp
    from fluorosequencingimageanalysis_tpu.ops.consolidate import (
        consolidate_host, _consolidate_scan)

    # d = 4 exactly along one axis at an f32-unrepresentable offset:
    # h = 0.1 and h = 4.1 differ by exactly 4.0 in f64 arithmetic.
    ch = np.array([0.1, 4.1, 20.0, 20.0 + 4.0000001], np.float64)
    cw = np.array([1.0, 1.0, 1.0, 1.0], np.float64)
    r2 = np.array([0.9, 0.8, 0.9, 0.95], np.float64)
    valid = np.ones(4, bool)
    with jax.enable_x64(True):
        dev = np.asarray(_consolidate_scan(
            jnp.asarray(ch), jnp.asarray(cw), jnp.asarray(r2),
            jnp.asarray(valid), radius=4.0))
    host = consolidate_host(ch, cw, r2, valid, radius=4.0)
    np.testing.assert_array_equal(host, dev)
    # The exact-boundary pair must consolidate (d^2 <= r^2 inclusive)
    # while the 4.0000001 pair must NOT (> radius in f64; an f32 path
    # would round it onto the boundary).
    assert host.tolist() == [True, False, True, True]

"""Head-to-head parity: batched device LM vs the TRUE reference mpfit.

BASELINE.md demands "PSF-fit parameter RMSE vs mpfit reference <= 1e-3".
Round 1 proved parity only against a scipy TRF stand-in; this file closes
the gap against the actual arbiter: tests/mpfit_oracle.py, the vendored
Py3 port of /root/reference/agpy/mpfit/mpfit.py, driven exactly the way
pflib drives it (init/bounds of pflib.py:199-214 through gaussfitter's
parinfo construction, gaussfitter.py:222-243).

Empirical ground truth established while building this test (documented
here because it shapes the assertions):

- On noiseless in-bounds patches the reference mpfit converges cleanly and
  our fits match to <<1e-3 on every parameter (modulo the exact (sh, sw,
  theta) -> (sw, sh, theta+90 mod 180) model symmetry, which
  ``canonicalize`` removes).
- On noisy/degenerate patches the reference mpfit frequently STALLS: its
  trust region collapses at a far-from-optimal point and it returns
  status 2 with a cost orders of magnitude above the optimum (verified
  faithful to the original: with bounds disabled the port tracks scipy's
  wrapped MINPACK lmdif bit-for-bit on converged cases, e.g. identical
  cost to 1e-10 over a 2.3e6-degree theta walk, while the stalls
  reproduce in both the bounded and unbounded driver). The reference
  pipeline lives with those stalls because find_peptides discards bad
  fits via the R^2 >= 0.7 filter (pflib.py:463-468).

Parity therefore means:
  1. our optimizer is NEVER meaningfully worse than mpfit (cost parity),
  2. wherever mpfit actually converges to the optimum we find (mutual
     convergence), the parameters agree to <= 1e-3 after canonicalizing
     the rotation symmetry, and the pegged-parameter sets agree,
  3. mpfit statuses stay positive (success, incl. 5 = maxiter like the
     reference's 200-iteration cap) so the oracle runs are valid.
"""

import numpy as np
import pytest

from fluorosequencingimageanalysis_tpu.ops.lm import fit_gaussians_batched

from oracles import gauss2d_oracle
import mpfit_oracle

LO = np.array([0.0, np.nan, 2.0, 2.0, 0.75, 0.75, 0.0])  # A-lo is per-patch
HI = np.array([np.inf, np.inf, 3.0, 3.0, 2.0, 2.0, 360.0])


def mpfit_reference_fit(patch):
    """Fit one 5x5 patch exactly as the reference does.

    Reproduces pflib._fit_2d_gaussian (pflib.py:199-214): empirical init
    (median, max, 2.5, 2.5, 1, 1, 0), limitedmin all True, limitedmax
    [F, F, T, T, T, T, T], the (max - mean)/3 amplitude floor, and
    gaussfitter's out-of-range start clipping (gaussfitter.py:201-204).

    Returns (params, status, cost).
    """
    patch = np.asarray(patch, dtype=np.float64)
    med, amax, amean = np.median(patch), patch.max(), patch.mean()
    params = np.array([med, amax, 2.5, 2.5, 1, 1, 0], float)
    minpars = np.array([0.0, (amax - amean) / 3.0, 2, 2, 0.75, 0.75, 0])
    maxpars = np.array([0.0, 0.0, 3, 3, 2, 2, 360])
    limitedmax = [0, 0, 1, 1, 1, 1, 1]
    for i in range(7):
        if limitedmax[i] and params[i] > maxpars[i]:
            params[i] = maxpars[i]
        if params[i] < minpars[i]:
            params[i] = minpars[i]

    def fcn(p, fjac=None):
        return [0, (patch - gauss2d_oracle(p, patch.shape)).ravel()]

    parinfo = [{"value": params[i], "limits": [minpars[i], maxpars[i]],
                "limited": [1, limitedmax[i]]} for i in range(7)]
    m = mpfit_oracle.mpfit(fcn, parinfo=parinfo, quiet=1)
    cost = float(np.sum(np.asarray(fcn(m.params)[1]) ** 2))
    return np.asarray(m.params, float), int(m.status), cost


def canonicalize(p):
    """Remove the exact model symmetry (sh, sw, th) == (sw, sh, th+90)
    == (sh, sw, th+180): map theta into [0, 90) with the matching sigma
    swap. Two parameter vectors describe the same Gaussian iff their
    canonical forms agree (up to the center/intensity params)."""
    p = np.array(p, dtype=float)
    th = p[6] % 180.0
    if th >= 90.0:
        th -= 90.0
        p[4], p[5] = p[5], p[4]
    p[6] = th
    return p


def pegged_mask(p, amp_lo):
    lo = LO.copy()
    lo[1] = amp_lo
    return (np.abs(p - lo) < 1e-6) | (np.abs(p - HI) < 1e-6)


def _patch_battery(n, seed, noise_levels=(1.0, 8.0)):
    """n synthetic patches cycling through the degenerate classes:
    0 = plain planted spot, 1 = rotated elliptical, 2 = saturated (clipped),
    3 = flat (pure background), 4 = edge spot (center outside the fit
    window's [2, 3] box)."""
    rng = np.random.default_rng(seed)
    patches, kinds = [], []
    for i in range(n):
        kind = i % 5
        H = rng.uniform(100, 600)
        A = rng.uniform(400, 5000)
        c2, c3 = rng.uniform(2.1, 2.9, 2)
        sh, sw = rng.uniform(0.9, 1.7, 2)
        th = rng.uniform(0, 45) if kind == 1 else 0.0
        p = np.array([H, A, c2, c3, sh, sw, th])
        img = gauss2d_oracle(p, (5, 5))
        if kind == 2:
            img = np.minimum(img, np.percentile(img, 92))
        if kind == 3:
            img = np.full((5, 5), H)
        if kind == 4:
            p2 = p.copy()
            p2[2], p2[3] = 0.5, 4.5
            img = gauss2d_oracle(p2, (5, 5))
        img = img + rng.normal(0, noise_levels[i % len(noise_levels)], (5, 5))
        patches.append(img)
        kinds.append(kind)
    return np.asarray(patches), kinds


def test_noiseless_patches_match_true_mpfit():
    """Noiseless rotated-elliptical battery.

    Observed behavior: OUR solver drives every one of these 40 exact
    problems to cost ~1e-24; the reference mpfit stalls on ~half of them
    (trust-region collapse mid-rotation, cost up to 1e6 on an exactly
    solvable problem). So the assertions are: (a) we always solve the
    problem exactly, (b) wherever mpfit also solves it, parameters agree
    to <= 1e-3 after canonicalization."""
    rng = np.random.default_rng(3)
    patches = []
    for _ in range(40):
        p = np.array([rng.uniform(100, 600), rng.uniform(400, 5000),
                      rng.uniform(2.1, 2.9), rng.uniform(2.1, 2.9),
                      rng.uniform(0.9, 1.7), rng.uniform(0.9, 1.7),
                      rng.uniform(0, 45)])
        patches.append(gauss2d_oracle(p, (5, 5)))
    patches = np.asarray(patches)
    ours, cost_ours = map(np.asarray,
                          fit_gaussians_batched(patches.astype(np.float64),
                                                num_iters=500))
    n_both = 0
    for i in range(len(patches)):
        ref, status, cost_ref = mpfit_reference_fit(patches[i])
        assert status >= 1, (i, status)  # any positive status = success
        # "Solved exactly" = cost below 1e-9 x patch power (a per-pixel
        # relative residual of ~2e-5; the fits land at ~1e-24 in practice).
        eps = 1e-9 * float(np.sum(patches[i] ** 2))
        assert cost_ours[i] < eps, (i, cost_ours[i], eps)
        if cost_ref < eps:
            n_both += 1
            po, pr = canonicalize(ours[i]), canonicalize(ref)
            np.testing.assert_allclose(po[:6], pr[:6], atol=1e-3, rtol=1e-3,
                                       err_msg=f"patch {i}")
            # theta identifiable when clearly elliptical
            if abs(pr[4] - pr[5]) > 0.1:
                assert abs(po[6] - pr[6]) < 0.5, (i, po[6], pr[6])
    # mpfit solves a substantial fraction (observed: 19/40 — it stalls on
    # the rest, which documents WHY cost-domination is the parity frame).
    assert n_both >= 15, n_both


def test_500_random_and_degenerate_patches_vs_true_mpfit():
    """The VERDICT-mandated battery: >= 500 random + degenerate patches.

    Asserts cost-domination everywhere, parameter parity (<= 1e-3 after
    canonicalization) + pegging parity on the mutually-converged subset,
    and that the subset is large enough to be meaningful.
    """
    patches, kinds = _patch_battery(500, seed=7)
    ours, cost_ours = map(np.asarray,
                          fit_gaussians_batched(patches.astype(np.float64),
                                                num_iters=200))
    n_mutual = 0
    n_peg_mismatch = 0
    ratios = []
    sq_err = []  # squared canonical param[:6] errors on the mutual subset
    for i in range(len(patches)):
        ref, status, cost_ref = mpfit_reference_fit(patches[i])
        assert status >= 1, (i, status)  # any positive status = success
        # 1. Cost domination: never worse than mpfit beyond rounding.
        # Measured on this battery: max ratio 1.011, and only 2/500 above
        # 1.001 — both pure-noise (flat) patches where the two optimizers
        # settle in different noise-chasing local minima.
        eps = 1e-12 * float(np.sum(patches[i] ** 2))
        ratio = (cost_ours[i] + eps) / (cost_ref + eps)
        ratios.append(ratio)
        assert ratio <= 1.02, (i, kinds[i], cost_ours[i], cost_ref)
        scale = max(cost_ours[i], cost_ref, 1e-12)
        if abs(cost_ours[i] - cost_ref) > 1e-6 * scale + eps:
            continue  # mpfit stalled (or rounding differs); no param claim
        n_mutual += 1
        po, pr = canonicalize(ours[i]), canonicalize(ref)
        # 2. Parameter parity. Centers/sigmas absolutely; H/A relatively
        # (they ride a flat ridge on degenerate patches where equal-cost
        # solutions differ by ~1e-3 absolute on ~1e3-magnitude values).
        np.testing.assert_allclose(po[2:6], pr[2:6], atol=2e-3,
                                   err_msg=f"patch {i} kind {kinds[i]}")
        np.testing.assert_allclose(po[:2], pr[:2], rtol=1e-3, atol=1e-2,
                                   err_msg=f"patch {i} kind {kinds[i]}")
        if abs(pr[4] - pr[5]) > 0.1:
            assert abs(po[6] - pr[6]) < 0.5, (i, po[6], pr[6])
        d = po[2:6] - pr[2:6]
        sq_err.extend((d * d).tolist())
        # 3. Pegging parity (canonicalization can move a theta peg between
        # the equivalent 0/360 representations; compare canonical vectors).
        amp_lo = (patches[i].max() - patches[i].mean()) / 3.0
        if (pegged_mask(po, amp_lo) != pegged_mask(pr, amp_lo)).any():
            n_peg_mismatch += 1
    # Tightness in the aggregate: >= 99% of fits within 0.1% of mpfit's
    # cost or better.
    ratios = np.asarray(ratios)
    assert (ratios <= 1.001).mean() >= 0.99, (ratios > 1.001).sum()
    # The mutual subset must be a substantial fraction, or the test is
    # vacuous (observed: ~40% — mpfit stalls on most noisy patches).
    assert n_mutual >= 150, n_mutual
    # BASELINE metric: parameter RMSE vs the mpfit reference <= 1e-3.
    rmse = float(np.sqrt(np.mean(sq_err)))
    assert rmse <= 1e-3, rmse
    # Pegging agrees everywhere except isolated symmetry-boundary cases.
    assert n_peg_mismatch <= 0.02 * n_mutual, (n_peg_mismatch, n_mutual)


def test_mpfit_stall_cases_are_dominated():
    """On patches where the reference mpfit stalls (trust-region collapse,
    status 2 at high cost), our fit must beat it decisively — the stalls
    are the reference's weakness, not an accuracy target."""
    patches, _ = _patch_battery(60, seed=11)
    ours, cost_ours = map(np.asarray,
                          fit_gaussians_batched(patches.astype(np.float64),
                                                num_iters=200))
    n_stall = 0
    for i in range(len(patches)):
        ref, status, cost_ref = mpfit_reference_fit(patches[i])
        if cost_ref > cost_ours[i] * 2.0:
            n_stall += 1
            assert status >= 1  # mpfit itself claims success
    # The battery reliably triggers stalls; if it stops doing so the test
    # above silently loses its subject.
    assert n_stall >= 5, n_stall


def _expdecay_fcn(p, fjac=None, x=None, y=None):
    model = p[0] * np.exp(-x / p[1]) + p[2]
    return [0, y - model]


def test_mpmaxstep_matches_vendored_mpfit():
    """parinfo['mpmaxstep'] (the round-3 caveat-starred hole): the compat
    driver's capped-step LM must land on the same optimum as the TRUE
    vendored mpfit given identical parinfo with a binding step cap."""
    from fluorosequencingimageanalysis_tpu.mpfit_compat import mpfit as ours

    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 60)
    true = (2500.0, 2.2, 400.0)
    y = true[0] * np.exp(-x / true[1]) + true[2] + rng.normal(0, 4.0, x.size)
    # Mildly-binding caps (several capped iterations, then free
    # convergence): both drivers land on the identical optimum. Under
    # SEVERELY binding caps the reference's trust-region delta collapses
    # against the cap and it stalls below the optimum (status 5) — a
    # reference pathology our LM does not reproduce (PARITY.md).
    parinfo = [
        {"value": 1800.0, "limited": [1, 0], "limits": [0.0, 0.0],
         "mpmaxstep": 300.0},
        {"value": 1.5, "limited": [1, 1], "limits": [0.1, 20.0],
         "mpmaxstep": 0.5},
        {"value": 300.0, "limited": [0, 0], "limits": [0.0, 0.0]},
    ]
    kw = {"x": x, "y": y}
    ref = mpfit_oracle.mpfit(_expdecay_fcn, parinfo=[dict(p) for p in parinfo],
                             functkw=kw, quiet=1)
    got = ours(_expdecay_fcn, parinfo=[dict(p) for p in parinfo],
               functkw=kw, quiet=1)
    assert ref.status > 0 and got.status > 0, (ref.errmsg, got.errmsg)
    np.testing.assert_allclose(got.params, ref.params, rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(got.params, true, rtol=5e-2, atol=5.0)


def test_mpmaxstep_caps_every_iteration():
    """With a binding cap the fitted parameter cannot move farther than
    niter * mpmaxstep from its start — observed via a recording fcn."""
    from fluorosequencingimageanalysis_tpu.mpfit_compat import mpfit as ours

    x = np.linspace(0.0, 10.0, 40)
    y = 50.0 * x + 7.0
    seen = []

    def fcn(p, fjac=None):
        seen.append(p.copy())
        return [0, y - (p[0] * x + p[1])]

    cap = 0.25
    parinfo = [{"value": 0.0, "mpmaxstep": cap}, {"value": 0.0}]
    got = ours(fcn, parinfo=parinfo, maxiter=12, quiet=1)
    # Every ACCEPTED move of p[0] is <= cap (FD probe evaluations use
    # tiny h and never exceed it either); total displacement is bounded
    # by iterations * cap, so the far-away optimum is NOT reached.
    diffs = np.abs(np.diff([p[0] for p in seen]))
    assert diffs.max() <= cap + 1e-9
    assert abs(got.params[0]) <= 12 * cap + 1e-9
    assert abs(got.params[0] - 50.0) > 1.0  # the cap really bound


def test_mpmaxstep_pegged_parameter_does_not_stall():
    """Regression (round-4 review): a parameter starting ON its limit
    with the step pointing outward must not collapse the whole step to
    zero and fake convergence — the other parameters keep optimizing
    (mpfit's pegged-column handling, mpfit.py:1072-1091)."""
    from fluorosequencingimageanalysis_tpu.mpfit_compat import mpfit as ours

    x = np.linspace(0, 10, 50)
    y = 0.0 * np.exp(-(x - 5) ** 2) + 100.0

    def fcn(p, fjac=None):
        return [0, y - (p[0] * np.exp(-(x - 5) ** 2) + p[1])]

    got = ours(fcn, parinfo=[
        {"value": 0.0, "limited": [1, 0], "limits": [0.0, 0.0],
         "mpmaxstep": 1.0},
        {"value": 0.0}])
    assert got.status > 0, got.errmsg
    assert abs(got.params[1] - 100.0) < 1e-6, got.params
    assert got.params[0] >= 0.0

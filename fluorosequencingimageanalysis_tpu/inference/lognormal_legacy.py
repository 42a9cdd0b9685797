"""Legacy lognormal fitter versions v1-v7 and the nearest-neighbor fitter.

Exact host ports of the reference's superseded fitter generations
(/root/reference/MCsimlib.py:3735-3885 [v1], 3982-4139 [v2], 4386-4540 [v3],
4543-4768 [v4], 4771-4925 [v5], 4928-5128 [v6], 5131-5324 [v7],
4142-4210 [nearest neighbor]). v8 (inference/lognormal.py) is the current
production fitter and the only one with a batched device path; these exist for
API completeness and for reproducing historical analyses. The _MP drivers
keep the reference signatures but run serially (each fit is microseconds;
the Pool fan-out was pure interpreter-overhead mitigation).
"""

from __future__ import annotations

import math
from functools import reduce
from itertools import combinations_with_replacement, product
from operator import mul

import numpy as np
from scipy.stats import lognorm, norm

log = math.log


def _seq_iterator(lmii, n, allow_upsteps):
    if allow_upsteps:
        return product(reversed(range(lmii + 1)), repeat=n)
    return combinations_with_replacement(reversed(range(lmii + 1)), n)


def _lmii_from_boundaries(intensities, log_fluor_boundaries, max_possible):
    log_max_intensity = log(max(max(intensities), 1))
    lmii = max_possible
    for i, lfb in enumerate(log_fluor_boundaries):
        if log_max_intensity > lfb:
            continue
        lmii = i + 2
        break
    return lmii


def _decode_seq(best_seq, with_starting_intensity, raise_on_upstep=False):
    signal = []
    for i, nxt in enumerate(best_seq[1:]):
        tf = best_seq[i] - nxt
        if tf > 0:
            signal += [("A", i + 1)] * tf
        elif tf < 0:
            if raise_on_upstep:
                raise Exception()
            signal = None
            break
    if signal is not None:
        signal = tuple(signal) if signal else (("A", 0),)
        is_zero = best_seq[-1] == 0
    else:
        is_zero = None
    if with_starting_intensity:
        return signal, is_zero, best_seq[0]
    return signal, is_zero


def _collect_mp(photometries, fit_one, signal_key_arity, si_index=-1):
    """Shared _MP driver structure: fit every trace, build signals dict and
    all_fit_info with the reference's layouts. si_index selects the
    starting_intensity element of the per-fit tuple for 3-ary keys."""
    if len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    signals = {}
    none_count = 0
    total_count = 0
    all_fit_info = []
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            for (h, w), (category, intensities, row) in fdict.items():
                total_count += 1
                out = fit_one(intensities, category)
                all_fit_info.append((channel, field, h, w, row, category,
                                     intensities) + out)
                signal, is_zero = out[0], out[1]
                if signal is None:
                    none_count += 1
                else:
                    if signal_key_arity == 2:
                        key = (signal, is_zero)
                    else:
                        key = (signal, is_zero, out[si_index])
                    signals.setdefault(key, 0)
                    signals[key] += 1
    return signals, total_count, none_count, all_fit_info


# ---------------------------------------------------------------------------
# v1 (MCsimlib.py:3735-3885)
# ---------------------------------------------------------------------------

def _intensities_to_signal_lognormal(intensities, mu_zero=0, sigma_zero=20000,
                                     mu_one=60000, max_possible=5,
                                     allow_multidrop=False):
    intensities = [i - mu_zero for i in intensities]
    zero_fluor = mu_zero + 2.0 * sigma_zero
    one_fluor = mu_one - mu_zero
    log_one, log_two = log(one_fluor), log(2.0 * one_fluor)
    half_log_fluor = np.mean((log_one, log_two)) - log_one
    boundaries = [np.mean([log(one_fluor + i * one_fluor),
                           log(one_fluor + (i + 1) * one_fluor)])
                  for i in range(max_possible + 1)]
    means = [log(one_fluor + i * one_fluor) for i in range(max_possible + 2)]
    lmii = _lmii_from_boundaries(intensities, boundaries, max_possible)
    best_seq, best_score = None, -1
    log_int = [log(i) if i > zero_fluor else -100 for i in intensities]
    best_log_score, best_scores = None, None
    for seq in combinations_with_replacement(reversed(range(lmii + 1)),
                                             len(intensities)):
        if not allow_multidrop:
            diffs = [seq[i] - s for i, s in enumerate(seq[1:])]
            if diffs and max(diffs) > 1:
                continue
        if any((i <= zero_fluor and seq[k] != 0) or
               (i > zero_fluor and seq[k] == 0)
               for k, i in enumerate(intensities)):
            continue
        scores = [norm.pdf(li, loc=means[seq[k] - 1], scale=half_log_fluor)
                  for k, li in enumerate(log_int) if li > 0]
        log_scores = [norm.logpdf(li, loc=means[seq[k] - 1],
                                  scale=half_log_fluor)
                      for k, li in enumerate(log_int) if li > 0]
        total = reduce(mul, scores, 1.0)
        if total > best_score:
            best_seq, best_score = seq, total
            best_log_score = sum(log_scores)
            best_scores = scores
    if best_seq is not None:
        signal, is_zero = _decode_seq(best_seq, False, raise_on_upstep=True)
    else:
        signal, is_zero = None, None
    return (signal, is_zero, best_seq, lmii, best_score, best_log_score,
            best_scores)


def _per_cycle_intensities_to_signal_lognormal(intensities,
                                               per_cycle_parameters,
                                               max_possible=5):
    """Unimplemented in the reference (MCsimlib.py:3821-3829)."""
    raise NotImplementedError()


def _photometries_lognormal_fit_MP(photometries, mu_zero=0, sigma_zero=20000,
                                   mu_one=60000, max_possible=5,
                                   num_processes=None,
                                   per_cycle_parameters=None,
                                   allow_multidrop=False):
    if per_cycle_parameters is not None:
        raise NotImplementedError()

    def fit_one(intensities, category):
        return _intensities_to_signal_lognormal(
            intensities, mu_zero, sigma_zero, mu_one, max_possible,
            allow_multidrop)

    return _collect_mp(photometries, fit_one, signal_key_arity=2)


# ---------------------------------------------------------------------------
# v2 (MCsimlib.py:3982-4139)
# ---------------------------------------------------------------------------

def _intensities_to_signal_lognormal_v2(intensities, alpha, beta, gamma,
                                        max_possible=5, allow_multidrop=False,
                                        allow_upsteps=False,
                                        upstep_rapid_classify=True):
    beta = beta - alpha
    gamma = gamma - alpha
    intensities = [i - alpha for i in intensities]
    if allow_upsteps and upstep_rapid_classify:
        zeros = [i >= gamma for i in intensities]
        if not (sorted(zeros, reverse=True) == zeros and zeros[0]):
            return (None, None, None, None, None, None, None)
    log_one, log_two = log(beta), log(2.0 * beta)
    half_log_fluor = np.mean((log_one, log_two)) - log_one
    boundaries = [np.mean([log(beta + i * beta), log(beta + (i + 1) * beta)])
                  for i in range(max_possible + 1)]
    means = [log(beta + i * beta) for i in range(max_possible + 2)]
    lmii = _lmii_from_boundaries(intensities, boundaries, max_possible)
    best_seq, best_score = None, -1
    log_int = [log(i) if i > gamma else -100 for i in intensities]
    best_log_score, best_scores = None, None
    if allow_upsteps:
        if upstep_rapid_classify:
            zeros_count = len([z for z in zeros if not z])
            X = ([list(range(1, lmii + 1))] *
                 (len(intensities) - zeros_count) + [[0]] * zeros_count)
            iterator = product(*X)
        else:
            iterator = product(reversed(range(lmii + 1)),
                               repeat=len(intensities))
    else:
        iterator = combinations_with_replacement(reversed(range(lmii + 1)),
                                                 len(intensities))
    for seq in iterator:
        if not allow_multidrop:
            diffs = [seq[i] - s for i, s in enumerate(seq[1:])]
            if diffs and max(diffs) > 1:
                continue
        if any((i <= gamma and seq[k] != 0) or (i > gamma and seq[k] == 0)
               for k, i in enumerate(intensities)):
            continue
        scores = [norm.pdf(li, loc=means[seq[k] - 1], scale=half_log_fluor)
                  for k, li in enumerate(log_int) if li > 0]
        log_scores = [norm.logpdf(li, loc=means[seq[k] - 1],
                                  scale=half_log_fluor)
                      for k, li in enumerate(log_int) if li > 0]
        total = reduce(mul, scores, 1.0)
        if total > best_score:
            best_seq, best_score = seq, total
            best_log_score = sum(log_scores)
            best_scores = scores
    if best_seq is not None:
        signal, is_zero = _decode_seq(best_seq, False)
    else:
        signal, is_zero = None, None
    return (signal, is_zero, best_seq, lmii, best_score, best_log_score,
            best_scores)


def _photometries_lognormal_fit_MP_v2(photometries, alpha, beta, gamma,
                                      max_possible=5, num_processes=None,
                                      allow_upsteps=False,
                                      allow_multidrop=False,
                                      upstep_rapid_classify=True):
    def fit_one(intensities, category):
        return _intensities_to_signal_lognormal_v2(
            intensities, alpha, beta, gamma, max_possible, allow_multidrop,
            allow_upsteps, upstep_rapid_classify)

    return _collect_mp(photometries, fit_one, signal_key_arity=2)


# ---------------------------------------------------------------------------
# nearest neighbor (MCsimlib.py:4142-4210)
# ---------------------------------------------------------------------------

def _lognormal_nearest_neighbor(intensities, alpha, beta, gamma,
                                max_possible=20):
    beta = beta - alpha
    gamma = gamma - alpha
    intensities = [i - alpha for i in intensities]
    means = [log(beta + i * beta) for i in range(max_possible + 2)]
    nearest_neighbors = []
    for intensity in intensities:
        if intensity < gamma:
            nearest_neighbors.append(0)
        else:
            li = log(intensity)
            distances = [abs(li - m) for m in means]
            nearest_neighbors.append(int(np.argmin(distances)) + 1)
    signal, is_zero = _decode_seq(nearest_neighbors, False)
    return signal, is_zero, nearest_neighbors


def _lognormal_nearest_neighbor_MP(photometries, alpha, beta, gamma,
                                   max_possible=20, num_processes=None):
    all_fit_info = []
    signals = {}
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            for (h, w), (category, intensities, row) in fdict.items():
                signal, is_zero, nn = _lognormal_nearest_neighbor(
                    intensities, alpha, beta, gamma, max_possible)
                all_fit_info.append((channel, field, h, w, row, category,
                                     intensities, signal, is_zero, nn, None,
                                     None, None, None))
                if signal is not None:
                    signals.setdefault((signal, is_zero), 0)
                    signals[(signal, is_zero)] += 1
    return signals, all_fit_info


# ---------------------------------------------------------------------------
# v3 (MCsimlib.py:4386-4540)
# ---------------------------------------------------------------------------

def _intensities_to_signal_lognormal_v3(intensities, alpha, beta, gamma,
                                        alpha_sigma, beta_sigma,
                                        max_possible=5, allow_multidrop=False,
                                        allow_upsteps=False):
    beta = beta - alpha
    gamma = gamma - alpha
    intensities = [i - alpha for i in intensities]
    boundaries = [np.mean([log(beta + i * beta), log(beta + (i + 1) * beta)])
                  for i in range(max_possible + 1)]
    means = [log(beta + i * beta) for i in range(max_possible + 2)]
    lmii = _lmii_from_boundaries(intensities, boundaries, max_possible)
    best_seq, best_score, best_scores = None, -1, None
    log_int = [log(i) if i > 0 else -10000 for i in intensities]
    zero_cutoff = (alpha + gamma) / 3.0
    for seq in _seq_iterator(lmii, len(intensities), allow_upsteps):
        if not allow_multidrop:
            diffs = [seq[i] - s for i, s in enumerate(seq[1:])]
            if diffs and max(diffs) > 1:
                continue
        if any(i <= zero_cutoff and seq[k] != 0
               for k, i in enumerate(intensities)):
            continue
        scores = [norm.pdf(log_int[k], loc=means[seq[k] - 1],
                           scale=beta_sigma)
                  if seq[k] > 0
                  else norm.pdf(intensities[k], loc=0.0, scale=alpha_sigma)
                  for k in range(len(intensities))]
        total = reduce(mul, scores, 1.0)
        if total > best_score:
            best_seq, best_score, best_scores = seq, total, scores
    if best_seq is not None and best_score > math.e ** -13:
        signal, is_zero, starting_intensity = _decode_seq(best_seq, True)
    else:
        signal, is_zero, starting_intensity = None, None, None
    return (signal, is_zero, best_seq, lmii, best_score, best_scores,
            starting_intensity)


def _photometries_lognormal_fit_MP_v3(photometries, alpha, beta, gamma,
                                      alpha_sigma, beta_sigma,
                                      max_possible=5, num_processes=None,
                                      allow_upsteps=False,
                                      allow_multidrop=False):
    def fit_one(intensities, category):
        return _intensities_to_signal_lognormal_v3(
            intensities, alpha, beta, gamma, alpha_sigma, beta_sigma,
            max_possible, allow_multidrop, allow_upsteps)

    return _collect_mp(photometries, fit_one, signal_key_arity=3)


# ---------------------------------------------------------------------------
# v4 (MCsimlib.py:4543-4768)
# ---------------------------------------------------------------------------

def _intensities_to_signal_lognormal_v4(intensities, alpha, beta, gamma,
                                        alpha_sigma, beta_sigma,
                                        max_possible=5, allow_multidrop=False,
                                        allow_upsteps=False,
                                        lognormal_probability_integral=1.0):
    boundaries = [np.mean([log(beta + i * beta), log(beta + (i + 1) * beta)])
                  for i in range(max_possible + 1)]
    lmii = _lmii_from_boundaries(intensities, boundaries, max_possible)
    best_seq, best_score, best_scores = None, -1, None
    zero_cutoff = (alpha + gamma) / 3.0
    score_norm = [norm.pdf(i, loc=0.0, scale=alpha_sigma) +
                  sum(lognorm.pdf(i, beta_sigma, loc=0, scale=beta * f)
                      for f in range(1, max_possible + 1))
                  for i in intensities]
    max_cache = {}
    score_cache = {}
    for seq in _seq_iterator(lmii, len(intensities), allow_upsteps):
        if not allow_multidrop:
            diffs = [seq[i] - s for i, s in enumerate(seq[1:])]
            if diffs and max(diffs) > 1:
                continue
        if any(i <= zero_cutoff and seq[k] != 0
               for k, i in enumerate(intensities)):
            continue
        scores = []
        for k, v in enumerate(seq):
            if (k, v) not in score_cache:
                if v == 0:
                    s = norm.pdf(intensities[k], loc=0.0, scale=alpha_sigma)
                else:
                    s = lognorm.pdf(intensities[k], beta_sigma, loc=0,
                                    scale=beta * v)
                score_cache[(k, v)] = s
            scores.append(score_cache[(k, v)])
        scores = [float(s) / score_norm[k] for k, s in enumerate(scores)]
        max_scores = []
        for v in seq:
            if v not in max_cache:
                if v == 0:
                    s = norm.pdf(0, loc=0.0, scale=alpha_sigma)
                else:
                    s = lognorm.pdf(float(beta) * v /
                                    math.e ** (beta_sigma ** 2), beta_sigma,
                                    loc=0, scale=beta * v)
                normalization = (
                    norm.pdf(float(beta) * v / math.e ** (beta_sigma ** 2),
                             loc=0.0, scale=alpha_sigma) +
                    sum(lognorm.pdf(float(beta) * v /
                                    math.e ** (beta_sigma ** 2), beta_sigma,
                                    loc=0, scale=beta * f)
                        for f in range(1, max_possible + 1)))
                max_cache[v] = s / float(normalization)
            max_scores.append(max_cache[v])
        total = reduce(mul, scores, 1.0) / float(reduce(mul, max_scores, 1.0))
        if total > best_score:
            best_seq, best_score, best_scores = seq, total, scores
    if best_seq is not None:
        signal, is_zero, starting_intensity = _decode_seq(best_seq, True)
    else:
        signal, is_zero, starting_intensity = None, None, None
    return (signal, is_zero, best_seq, lmii, best_score, best_scores,
            starting_intensity, None, None)


def _photometries_lognormal_fit_MP_v4(photometries, alpha, beta, gamma,
                                      alpha_sigma, beta_sigma,
                                      max_possible=5, num_processes=None,
                                      allow_upsteps=False,
                                      allow_multidrop=False):
    lognormal_probability_integral = None

    def fit_one(intensities, category):
        return _intensities_to_signal_lognormal_v4(
            intensities, alpha, beta, gamma, alpha_sigma, beta_sigma,
            max_possible, allow_multidrop, allow_upsteps,
            lognormal_probability_integral)

    # v4 returns 9 items; starting_intensity sits at index 6
    # (MCsimlib.py:4755-4766).
    out = _collect_mp(photometries, fit_one, signal_key_arity=3, si_index=6)
    return out + (lognormal_probability_integral,)


# ---------------------------------------------------------------------------
# v5 / v6 / v7 (MCsimlib.py:4771-5324)
# ---------------------------------------------------------------------------

def _quench_tables(beta, quench_factor, max_possible):
    boundaries = [np.mean([log(beta) + log(i + 1.0) -
                           quench_factor * max(i - 1, 0),
                           log(beta) + log(i + 2.0) - quench_factor * i, 0])
                  for i in range(max_possible + 1)]
    means = [log(beta) + log(i + 1.0) - quench_factor * max(i - 1, 0)
             for i in range(max_possible + 2)]
    return boundaries, means


def _intensities_to_signal_lognormal_v5(intensities, alpha, beta, gamma,
                                        alpha_sigma, beta_sigma,
                                        max_possible=5, allow_multidrop=False,
                                        allow_upsteps=False, max_deviation=3,
                                        quench_factor=0):
    boundaries, means = _quench_tables(beta, quench_factor, max_possible)
    lmii = _lmii_from_boundaries(intensities, boundaries, max_possible)
    best_seq, best_score, best_scores = None, -1, None
    log_int = [log(i) if i > 0 else -10000 for i in intensities]
    zero_cutoff = (alpha + gamma) / 3.0
    cache = {}
    sigma_ratio = float(alpha_sigma) / beta_sigma
    for seq in _seq_iterator(lmii, len(intensities), allow_upsteps):
        if not allow_multidrop:
            diffs = [seq[i] - s for i, s in enumerate(seq[1:])]
            if diffs and max(diffs) > 1:
                continue
        if any(i <= zero_cutoff and seq[k] != 0
               for k, i in enumerate(intensities)):
            continue
        deviations = [(abs(log_int[k] - means[v - 1]) / beta_sigma)
                      if v > 0 else abs(intensities[k]) / alpha_sigma
                      for k, v in enumerate(seq)]
        if max(deviations) > max_deviation:
            continue
        scores = []
        for k, v in enumerate(seq):
            if (k, v) not in cache:
                if v == 0:
                    s = norm.pdf(intensities[k] / sigma_ratio, loc=0.0,
                                 scale=beta_sigma)
                else:
                    s = norm.pdf(log_int[k], loc=means[v - 1],
                                 scale=beta_sigma)
                cache[(k, v)] = s
            scores.append(cache[(k, v)])
        total = reduce(mul, scores, 1.0)
        if total > best_score:
            best_seq, best_score, best_scores = seq, total, scores
    if best_seq is not None:
        signal, is_zero, starting_intensity = _decode_seq(best_seq, True)
    else:
        signal, is_zero, starting_intensity = None, None, None
    return (signal, is_zero, best_seq, lmii, best_score, best_scores,
            starting_intensity)


def _photometries_lognormal_fit_MP_v5(photometries, alpha, beta, gamma,
                                      alpha_sigma, beta_sigma,
                                      max_possible=5, num_processes=None,
                                      allow_upsteps=False,
                                      allow_multidrop=False, max_deviation=3,
                                      quench_factor=0):
    def fit_one(intensities, category):
        return _intensities_to_signal_lognormal_v5(
            intensities, alpha, beta, gamma, alpha_sigma, beta_sigma,
            max_possible, allow_multidrop, allow_upsteps, max_deviation,
            quench_factor)

    return _collect_mp(photometries, fit_one, signal_key_arity=3)


def _intensities_to_signal_lognormal_v6(intensities, alpha, beta, gamma,
                                        alpha_sigma, beta_sigma,
                                        max_possible=5, allow_multidrop=False,
                                        allow_upsteps=False, max_deviation=3,
                                        quench_factor=0, deltas=None,
                                        gamma_score=None):
    boundaries, means = _quench_tables(beta, quench_factor, max_possible)
    lmii = _lmii_from_boundaries(intensities, boundaries, max_possible)
    best_seq, best_score, best_scores = None, -1, None
    log_int = [log(i) if i > 0 else -10000 for i in intensities]
    zero_cutoff = (alpha + gamma) / 3.0
    cache = {}
    sigma_ratio = float(alpha_sigma) / beta_sigma
    if deltas is not None:
        delta_0, delta_1 = deltas
        gamma_score = gamma_score * norm.pdf(0, loc=0, scale=beta_sigma)
    for seq in _seq_iterator(lmii, len(intensities), allow_upsteps):
        if not allow_multidrop:
            diffs = [seq[i] - s for i, s in enumerate(seq[1:])]
            if diffs and max(diffs) > 1:
                continue
        if any(i <= zero_cutoff and seq[k] != 0
               for k, i in enumerate(intensities)):
            continue
        deviations = [(abs(log_int[k] - means[v - 1]) / beta_sigma)
                      for k, v in enumerate(seq) if v > 0]
        if deviations and max(deviations) > max_deviation:
            continue
        over_deviation = True
        for k, v in enumerate(seq):
            if v > 0:
                continue
            if (deltas is None and
                    abs(intensities[k]) / alpha_sigma > max_deviation):
                break
            elif (deltas is not None and
                  not delta_0 <= intensities[k] <= delta_1 and
                  abs(intensities[k]) / alpha_sigma > max_deviation):
                break
        else:
            over_deviation = False
        if over_deviation:
            continue
        scores = []
        for k, v in enumerate(seq):
            if (k, v) not in cache:
                if v == 0:
                    if (deltas is not None and
                            delta_0 <= intensities[k] <= delta_1):
                        s = gamma_score
                    else:
                        s = norm.pdf(intensities[k] / sigma_ratio, loc=0.0,
                                     scale=beta_sigma)
                else:
                    s = norm.pdf(log_int[k], loc=means[v - 1],
                                 scale=beta_sigma)
                cache[(k, v)] = s
            scores.append(cache[(k, v)])
        total = reduce(mul, scores, 1.0)
        if total > best_score:
            best_seq, best_score, best_scores = seq, total, scores
    if best_seq is not None:
        signal, is_zero, starting_intensity = _decode_seq(best_seq, True)
    else:
        signal, is_zero, starting_intensity = None, None, None
    return (signal, is_zero, best_seq, lmii, best_score, best_scores,
            starting_intensity)


def _find_deltas(alpha_sigma, beta, beta_sigma, gamma_score):
    """(MCsimlib.py:5056-5070)"""
    sigma_ratio = float(alpha_sigma) / beta_sigma
    f0 = norm(loc=0, scale=beta_sigma)
    f1 = norm(loc=log(beta), scale=beta_sigma)
    delta_0, delta_1 = None, None
    for photometry in range(1, int(math.ceil(beta)) + 1):
        f0_value = f0.pdf(photometry / sigma_ratio)
        f1_value = f1.pdf(log(photometry))
        if delta_0 is None and f0_value < gamma_score:
            delta_0 = photometry
        if delta_0 is not None and delta_1 is None and f1_value > gamma_score:
            delta_1 = photometry
        if delta_0 is not None and delta_1 is not None:
            break
    return delta_0, delta_1


def _photometries_lognormal_fit_MP_v6(photometries, alpha, beta, gamma,
                                      alpha_sigma, beta_sigma,
                                      max_possible=5, num_processes=None,
                                      allow_upsteps=False,
                                      allow_multidrop=False, max_deviation=3,
                                      quench_factor=0, gamma_score=None):
    deltas = _find_deltas(alpha_sigma=alpha_sigma, beta=beta,
                          beta_sigma=beta_sigma, gamma_score=gamma_score)

    def fit_one(intensities, category):
        return _intensities_to_signal_lognormal_v6(
            intensities, alpha, beta, gamma, alpha_sigma, beta_sigma,
            max_possible, allow_multidrop, allow_upsteps, max_deviation,
            quench_factor, deltas, gamma_score)

    out = _collect_mp(photometries, fit_one, signal_key_arity=3)
    return out + (deltas,)


def _intensities_to_signal_lognormal_v7(intensities, alpha, beta, gamma,
                                        alpha_sigma, beta_sigma,
                                        max_possible=5, allow_multidrop=False,
                                        allow_upsteps=False, max_deviation=3,
                                        quench_factor=0, deltas=None,
                                        gamma_score=None, categories=None):
    if categories is None:
        raise ValueError("categories required in v7")
    if deltas is not None:
        raise DeprecationWarning("v7 doesn't use deltas")
    boundaries, means = _quench_tables(beta, quench_factor, max_possible)
    lmii = _lmii_from_boundaries(intensities, boundaries, max_possible)
    best_seq, best_score, best_scores = None, -1, None
    log_int = [log(i) if i > 0 else -10000 for i in intensities]
    cache = {}
    for seq in _seq_iterator(lmii, len(intensities), allow_upsteps):
        if any((categories[k] and v == 0) or (not categories[k] and v > 0)
               for k, v in enumerate(seq)):
            continue
        if not allow_multidrop:
            diffs = [seq[i] - s for i, s in enumerate(seq[1:])]
            if diffs and max(diffs) > 1:
                continue
        deviations = [(abs(log_int[k] - means[v - 1]) / beta_sigma)
                      for k, v in enumerate(seq) if v > 0]
        if deviations and max(deviations) > max_deviation:
            continue
        scores = []
        for k, v in enumerate(seq):
            if (k, v) not in cache:
                if v == 0:
                    s = 1.0
                else:
                    s = norm.pdf(log_int[k], loc=means[v - 1],
                                 scale=beta_sigma)
                cache[(k, v)] = s
            scores.append(cache[(k, v)])
        total = reduce(mul, scores, 1.0)
        if total > best_score:
            best_seq, best_score, best_scores = seq, total, scores
    if best_seq is not None:
        signal, is_zero, starting_intensity = _decode_seq(best_seq, True)
    else:
        signal, is_zero, starting_intensity = None, None, None
    return (signal, is_zero, best_seq, lmii, best_score, best_scores,
            starting_intensity)


def _photometries_lognormal_fit_MP_v7(photometries, alpha, beta, gamma,
                                      alpha_sigma, beta_sigma,
                                      max_possible=5, num_processes=None,
                                      allow_upsteps=False,
                                      allow_multidrop=False, max_deviation=3,
                                      quench_factor=0, gamma_score=None):
    deltas = _find_deltas(alpha_sigma=alpha_sigma, beta=beta,
                          beta_sigma=beta_sigma, gamma_score=gamma_score)

    def fit_one(intensities, category):
        return _intensities_to_signal_lognormal_v7(
            intensities, alpha, beta, gamma, alpha_sigma, beta_sigma,
            max_possible, allow_multidrop, allow_upsteps, max_deviation,
            quench_factor, None, gamma_score, category)

    out = _collect_mp(photometries, fit_one, signal_key_arity=3)
    return out + (deltas,)

"""Reference oracles for golden-value tests.

These are independent NumPy/SciPy implementations of the published algorithms
the reference pipeline uses (elliptical-Gaussian least squares, Welch t-tests,
Guizar-Sicairos phase correlation, ...), written from the algorithm
definitions. The device kernels must match them to documented tolerances.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares

# Planted-spot PSF shared by the image-level closure tests
# (test_closure_full_stack.py, test_closure_timetrace.py) so the two
# suites can never drift to different spot models.
PLANT_SIGMA = 1.3


def planted_unit_psf(radius=9, sigma=PLANT_SIGMA):
    """Unit-amplitude separable Gaussian PSF for rendering planted spots."""
    d = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(d ** 2) / (2 * sigma ** 2))
    return np.outer(g, g)


def gauss2d_oracle(params, shape=(5, 5)):
    """Reference-convention 2D Gaussian on index grids (float64 NumPy).

    Same convention as fluorosequencingimageanalysis_tpu.ops.gaussian:
    p = (H, A, c2, c3, sh, sw, theta_deg); c3 pairs with the row axis and c2
    with the column axis (the agpy quirk).
    """
    H, A, c2, c3, sh, sw, th = [float(v) for v in params]
    rota = np.deg2rad(th)
    hh, ww = np.indices(shape).astype(np.float64)
    rcx = c3 * np.cos(rota) - c2 * np.sin(rota)
    rcy = c3 * np.sin(rota) + c2 * np.cos(rota)
    xp = hh * np.cos(rota) - ww * np.sin(rota)
    yp = hh * np.sin(rota) + ww * np.cos(rota)
    return H + A * np.exp(-(((rcx - xp) / sh) ** 2 +
                            ((rcy - yp) / sw) ** 2) / 2.0)


def fit_gaussian_oracle(patch, theta_fix=None):
    """Bounded least-squares fit of one patch with pflib's init and bounds.

    Uses scipy's trust-region-reflective solver; converged interior optima
    coincide with mpfit's stationary points.

    theta_fix: if given, pin theta to this value (mpfit pegs theta at its
        bound when the gradient points outside [0, 360]; TRF instead can
        travel to the wrapped-angle twin optimum, so pegged cases are
        compared with theta fixed to the pegged value).
    """
    patch = np.asarray(patch, dtype=np.float64)
    med = float(np.median(patch))
    amax = float(np.max(patch))
    amean = float(np.mean(patch))
    p0 = np.array([med, amax, 2.5, 2.5, 1.0, 1.0, 0.0])
    lo = np.array([0.0, (amax - amean) / 3.0, 2.0, 2.0, 0.75, 0.75, 0.0])
    hi = np.array([np.inf, np.inf, 3.0, 3.0, 2.0, 2.0, 360.0])
    if theta_fix is not None:
        p0[6] = theta_fix
        lo[6] = theta_fix - 1e-12
        hi[6] = theta_fix + 1e-12
    p0 = np.clip(p0, lo, hi + 0)  # mpfit-style start clipping

    def resid(p):
        return (gauss2d_oracle(p, patch.shape) - patch).ravel()

    sol = least_squares(resid, p0, bounds=(lo, hi), method="trf",
                        xtol=1e-14, ftol=1e-14, gtol=1e-14, max_nfev=2000)
    return sol.x, float(np.sum(sol.fun ** 2))


def phase_correlate_oracle(ref_image, reg_image, upsample_factor=1):
    """NumPy float64 implementation of the Guizar-Sicairos registration
    (the algorithm of /root/reference/phase_correlate.py), used as the
    golden oracle for the XLA version."""
    ref_image = np.asarray(ref_image, dtype=np.float64)
    reg_image = np.asarray(reg_image, dtype=np.float64)
    ref_f = np.fft.fft2(ref_image)
    reg_f = np.fft.fft2(reg_image)
    rows, cols = ref_f.shape
    cross = np.fft.ifft2(ref_f * reg_f.conj())
    row_max, col_max = np.unravel_index(np.argmax(cross), cross.shape)
    mid_row, mid_col = np.fix(rows / 2), np.fix(cols / 2)
    row_shift = row_max - rows if row_max > mid_row else row_max
    col_shift = col_max - cols if col_max > mid_col else col_max
    if upsample_factor == 1:
        rfzero = np.sum(np.abs(ref_f) ** 2) / (rows * cols)
        rgzero = np.sum(np.abs(reg_f) ** 2) / (rows * cols)
        ccmax = cross.max()
        error = np.sqrt(np.abs(1.0 - ccmax * ccmax.conj() / (rgzero * rfzero)))
        return row_shift, col_shift, error, np.arctan2(ccmax.imag, ccmax.real)

    u = upsample_factor
    row_shift = np.round(row_shift * u) / u
    col_shift = np.round(col_shift * u) / u
    up_px = int(np.ceil(u * 1.5))
    dftshift = np.fix(up_px / 2)

    def dftups(data, nor, noc, roff=0, coff=0):
        r, c = data.shape
        col_kernel = np.exp(
            (-1j * 2 * np.pi / (c * u)) *
            (np.fft.ifftshift(np.arange(c))[:, None] - np.floor(c / 2)).dot(
                np.arange(noc)[None, :] - coff))
        row_kernel = np.exp(
            (-1j * 2 * np.pi / (r * u)) *
            (np.arange(nor)[:, None] - roff).dot(
                np.fft.ifftshift(np.arange(r))[None, :] - np.floor(r / 2)))
        return row_kernel.dot(data).dot(col_kernel)

    cross_up = dftups(reg_f * ref_f.conj(), up_px, up_px,
                      dftshift - row_shift * u,
                      dftshift - col_shift * u).conj() / \
        (mid_row * mid_col * u ** 2)
    rm, cm = np.unravel_index(np.argmax(cross_up), cross_up.shape)
    row_shift += (rm - dftshift) / u
    col_shift += (cm - dftshift) / u
    ccmax = cross_up.max()
    rg00 = dftups(ref_f * ref_f.conj(), 1, 1) / (mid_row * mid_col * u ** 2)
    rf00 = dftups(reg_f * reg_f.conj(), 1, 1) / (mid_row * mid_col * u ** 2)
    error = np.sqrt(np.abs(1.0 - ccmax * ccmax.conj() / (rg00 * rf00)))[0, 0]
    diffphase = np.arctan2(ccmax.imag, ccmax.real)
    if mid_row == 1:
        row_shift = 0
    if mid_col == 1:
        col_shift = 0
    return row_shift, col_shift, error, diffphase


def fourier_shift(image, dh, dw):
    """Shift an image by (dh, dw) with Fourier interpolation (periodic)."""
    image = np.asarray(image, dtype=np.float64)
    f = np.fft.fft2(image)
    rows, cols = image.shape
    fr = np.fft.fftfreq(rows)[:, None]
    fc = np.fft.fftfreq(cols)[None, :]
    shifted = f * np.exp(-2j * np.pi * (fr * dh + fc * dw))
    return np.fft.ifft2(shifted).real

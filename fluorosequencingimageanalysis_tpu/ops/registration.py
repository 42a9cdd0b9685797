"""Subpixel FFT image registration (Guizar-Sicairos et al. 2008).

Efficient subpixel registration by cross-correlation: a full-image FFT
cross-power gives the integer-pixel shift; a matrix-multiply upsampled DFT
evaluated only in a 1.5*upsample neighborhood of that estimate refines it to
1/upsample_factor pixels. Reference implementation:
/root/reference/phase_correlate.py:11-196 (itself a port of Guizar-Sicairos,
Thurman & Fienup, Optics Letters 33, 156-158 (2008) — the same algorithm that
later became skimage.registration.phase_cross_correlation).

Design: fft2/ifft2 are XLA-native; the upsampled-DFT refinement is two
complex matrix products (30x512 @ 512x512 @ 512x30 for the defaults), run
at HIGHEST precision: a TF32 product moves the refined peak by one
1/upsample_factor step (measured on an H100). The whole routine jits with static shapes, and
:func:`phase_correlate_stack` vmaps it over all consecutive frame pairs of an
experiment so a whole field stack registers in one dispatch.
"""

from __future__ import annotations

import functools

import jax

from ..utils.jaxcache import ensure_atomic_cache_writes

ensure_atomic_cache_writes()  # see utils/jaxcache (torn-cache-entry hazard)
import jax.numpy as jnp
import numpy as np

# f32 and complex64 products here stay in full f32: TF32 loses the
# 1/upsample_factor subpixel step.
_matmul = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _dftups(data, up_rows: int, up_cols: int, upsample_factor: int,
            row_offset, col_offset):
    """Upsampled DFT of `data` by matrix multiplication.

    Equivalent to embedding `data` in an upsample_factor-times larger array,
    taking its FFT, and extracting an (up_rows, up_cols) window at
    (row_offset, col_offset) — without the zero-padding.
    Parity: /root/reference/phase_correlate.py:137-196.
    """
    rows, cols = data.shape
    real_dt = jnp.float64 if data.dtype == jnp.complex128 else jnp.float32
    col_base = (jnp.fft.ifftshift(jnp.arange(cols, dtype=real_dt))[:, None]
                - jnp.floor(jnp.asarray(cols / 2, real_dt)))
    col_samples = jnp.arange(up_cols, dtype=real_dt)[None, :] - col_offset
    col_kernel = jnp.exp((-2j * jnp.pi / (cols * upsample_factor)) *
                         _matmul(col_base, col_samples))
    row_samples = jnp.arange(up_rows, dtype=real_dt)[:, None] - row_offset
    row_base = (jnp.fft.ifftshift(jnp.arange(rows, dtype=real_dt))[None, :]
                - jnp.floor(jnp.asarray(rows / 2, real_dt)))
    row_kernel = jnp.exp((-2j * jnp.pi / (rows * upsample_factor)) *
                         _matmul(row_samples, row_base))
    return _matmul(_matmul(row_kernel, data), col_kernel)


@functools.partial(jax.jit, static_argnames=("upsample_factor",))
def phase_correlate_jit(ref_image, reg_image, upsample_factor: int = 1):
    """Jitted core. Returns (row_shift, col_shift, error, diffphase).

    The returned shift registers `reg_image` onto `ref_image` (opposite in
    sign to the shift that produced reg from ref).
    """
    ref_f = jnp.fft.fft2(ref_image)
    reg_f = jnp.fft.fft2(reg_image)
    rows, cols = ref_f.shape
    mid_row = jnp.floor(jnp.asarray(rows / 2.0))
    mid_col = jnp.floor(jnp.asarray(cols / 2.0))

    cross = jnp.fft.ifft2(ref_f * jnp.conj(reg_f))
    # NumPy argmax on complex orders LEXICOGRAPHICALLY: by real part,
    # then by imaginary part on exact real ties (reference behavior at
    # phase_correlate.py:73-74). Plain argmax(cross.real) would take the
    # first flat index on tied real parts (periodic/calibration-grid
    # images), shifting the integer peak by half the period. Two-pass:
    # find the max real, then argmax of imag restricted to those ties —
    # equal-imag ties fall back to the first flat index, like numpy.
    max_real = jnp.max(cross.real)
    amax = jnp.argmax(jnp.where(cross.real == max_real, cross.imag,
                                -jnp.inf))
    row_max = amax // cols
    col_max = amax % cols
    row_shift = jnp.where(row_max > mid_row, row_max - rows, row_max)
    col_shift = jnp.where(col_max > mid_col, col_max - cols, col_max)
    row_shift = row_shift.astype(ref_f.real.dtype)
    col_shift = col_shift.astype(ref_f.real.dtype)

    if upsample_factor == 1:
        rfzero = jnp.sum(jnp.abs(ref_f) ** 2) / (rows * cols)
        rgzero = jnp.sum(jnp.abs(reg_f) ** 2) / (rows * cols)
        ccmax = cross.reshape(-1)[amax]
        error = jnp.sqrt(jnp.abs(
            1.0 - ccmax * jnp.conj(ccmax) / (rgzero * rfzero)))
        diffphase = jnp.arctan2(ccmax.imag, ccmax.real)
        return row_shift, col_shift, error, diffphase

    u = upsample_factor
    row_shift = jnp.round(row_shift * u) / u
    col_shift = jnp.round(col_shift * u) / u
    up_px = int(np.ceil(u * 1.5))
    dftshift = float(np.fix(up_px / 2.0))
    cross_up = jnp.conj(_dftups(reg_f * jnp.conj(ref_f), up_px, up_px, u,
                                dftshift - row_shift * u,
                                dftshift - col_shift * u)) / \
        (mid_row * mid_col * u ** 2)
    # Lexicographic complex argmax (real, then imag) like the reference's
    # np.argmax on the complex array — see the integer-peak argmax above.
    max_real_up = jnp.max(cross_up.real)
    amax_up = jnp.argmax(jnp.where(cross_up.real == max_real_up,
                                   cross_up.imag, -jnp.inf))
    row_up = (amax_up // up_px).astype(row_shift.dtype) - dftshift
    col_up = (amax_up % up_px).astype(col_shift.dtype) - dftshift
    row_shift = row_shift + row_up / u
    col_shift = col_shift + col_up / u
    ccmax = cross_up.reshape(-1)[amax_up]
    rg00 = _dftups(ref_f * jnp.conj(ref_f), 1, 1, u, 0.0, 0.0)[0, 0] / \
        (mid_row * mid_col * u ** 2)
    rf00 = _dftups(reg_f * jnp.conj(reg_f), 1, 1, u, 0.0, 0.0)[0, 0] / \
        (mid_row * mid_col * u ** 2)
    error = jnp.sqrt(jnp.abs(1.0 - ccmax * jnp.conj(ccmax) / (rg00 * rf00)))
    diffphase = jnp.arctan2(ccmax.imag, ccmax.real)

    # Single-row/column images cannot shift along that dimension.
    row_shift = jnp.where(mid_row == 1, 0.0, row_shift)
    col_shift = jnp.where(mid_col == 1, 0.0, col_shift)
    return row_shift, col_shift, error, diffphase


def phase_correlate(ref_image, reg_image, upsample_factor: int = 1):
    """Host-facing single-pair API, reference-compatible return types.

    Parity: /root/reference/phase_correlate.py:11-134. Raises on mismatched
    or non-2D shapes like the reference.
    """
    ref_image = np.asarray(ref_image)
    reg_image = np.asarray(reg_image)
    if ref_image.shape != reg_image.shape:
        raise ValueError("Error: images must be same size for phase_correlate")
    if ref_image.ndim != 2:
        raise ValueError("Error: phase_correlate only supports 2D images")
    dt = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    r, c, e, d = phase_correlate_jit(jnp.asarray(ref_image, dt),
                                     jnp.asarray(reg_image, dt),
                                     int(upsample_factor))
    return float(r), float(c), float(e), float(d)


@functools.partial(jax.jit, static_argnames=("upsample_factor",))
def phase_correlate_stack(frames, upsample_factor: int = 20):
    """Register all consecutive frame pairs of a (F, H, W) stack at once.

    Returns (row_shifts, col_shifts, errors, diffphases), each (F,), with
    entry 0 fixed at 0 (the first frame defines the reference grid) —
    matching SequenceExperiment.offsets_from_frames
    (/root/reference/flexlibrary.py:1717-1741).
    """
    refs = frames[:-1]
    regs = frames[1:]
    r, c, e, d = jax.vmap(
        lambda a, b: phase_correlate_jit(a, b, upsample_factor))(refs, regs)
    zero = jnp.zeros((1,), r.dtype)
    return (jnp.concatenate([zero, r]), jnp.concatenate([zero, c]),
            jnp.concatenate([jnp.zeros((1,), e.dtype), e]),
            jnp.concatenate([jnp.zeros((1,), d.dtype), d]))

"""The candidate map (median-filter background removal + template
correlation, pflib.py:240-250) against the scipy oracle, at the shapes a
fused kernel's tiling would get wrong: widths off any power of two, odd
heights, and batches."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.ndimage import median_filter
from scipy.signal import correlate

from fluorosequencingimageanalysis_tpu.ops.candidates import (
    DEFAULT_CORRELATION_MATRIX, candidate_maps_batch, median_filter_2d)


def _oracle_map(img):
    img = img.astype(np.float64)
    mf = img - np.minimum(median_filter(img, 5, mode="reflect"), img)
    return np.maximum(correlate(mf, DEFAULT_CORRELATION_MATRIX,
                                mode="same"), 0.0)


def _planted(rng, shape):
    *batch, h, w = shape
    img = rng.normal(400, 10, shape).astype(np.float32)
    hh, ww = np.indices((h, w)).astype(np.float32)
    for ph, pw in [(h // 2, w // 2), (h // 5, w - 6), (h - 4, 3)]:
        img += (3000 * np.exp(-(((hh - ph) ** 2) + ((ww - pw) ** 2)) /
                              3.0)).astype(np.float32)
    return img


@pytest.mark.parametrize("shape", [
    (64, 128), (48, 100), (33, 257), (70, 130), (96, 384),  # single
    (3, 32, 128), (2, 45, 77),                              # batched
])
def test_candidate_map_matches_scipy_oracle(shape):
    rng = np.random.default_rng(sum(shape))
    img = _planted(rng, shape)
    batch = img if img.ndim == 3 else img[None]
    got = np.asarray(candidate_maps_batch(jnp.asarray(batch)))
    assert got.shape == batch.shape
    for b in range(batch.shape[0]):
        ref = _oracle_map(batch[b])
        # f32 map vs the f64 oracle: the f32 median is exact, the
        # 25-tap correlation rounds at the map's own scale.
        np.testing.assert_allclose(got[b], ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=f"shape {shape}, image {b}")


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 6, 7])
def test_median_network_equals_scipy_rank_filter(size):
    """The selection network is exact: bit-equal to scipy's median
    filter (rank n//2, reflect boundary, the extra even-size tap on the
    negative side) on data with many ties."""
    rng = np.random.default_rng(size)
    img = rng.integers(0, 6, (23, 31)).astype(np.float32)
    got = np.asarray(median_filter_2d(jnp.asarray(img), size))
    np.testing.assert_array_equal(got, median_filter(img, size,
                                                     mode="reflect"))

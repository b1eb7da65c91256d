"""The batched analytic-Jacobian undistortion must match the generic
jacfwd-based path exactly (same Newton iteration, closed-form algebra)."""

import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.residuals import camera

INTR = camera.Intrinsics(*map(jnp.float64, (458.654, 457.296, 367.215, 248.375)))
DIST = camera.DistCoeffs(*map(jnp.float64, (-0.28340811, 0.07395907, 0.0, 0.00019359, 1.76187114e-05)))


def test_fast_matches_generic():
    rng = np.random.default_rng(5)
    px = jnp.asarray(rng.uniform([50, 50], [700, 430], size=(500, 2)))
    dist_px = camera.distort_pixels(INTR, DIST, px)
    generic = camera.undistort_points_gn(INTR, DIST, dist_px)
    fast = camera.undistort_points_fast(INTR, DIST, dist_px)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(generic), atol=1e-9)
    assert np.abs(np.asarray(fast - px)).max() < 1e-6


def test_fast_any_length_f32():
    """N that is no multiple of a tile or a power of two (65536 + 77): the
    XLA path needs no padding, and f32 round trips to a few f32 ulps of
    700-px coordinates."""
    intr = camera.Intrinsics(*map(jnp.float32, (458.654, 457.296, 367.215,
                                                248.375)))
    dist = camera.DistCoeffs(*map(jnp.float32, (-0.28340811, 0.07395907, 0.0,
                                                0.00019359, 1.76187114e-05)))
    rng = np.random.default_rng(6)
    px = jnp.asarray(rng.uniform([50, 50], [700, 430],
                                 size=(65_536 + 77, 2)).astype(np.float32))
    dist_px = camera.distort_pixels(intr, dist, px)
    und = camera.undistort_points_fast(intr, dist, dist_px)
    assert und.shape == px.shape and und.dtype == jnp.float32
    assert float(jnp.max(jnp.abs(und - px))) < 1e-3

"""Non-maximum suppression as pure XLA ops.

Reference: st8-nms/src/include/nms.hpp — strided-block 1D NMS (:10-38) and 2D
block NMS with neighborhood verification (:40-81), both scalar loops there.
Accelerator-native: reduce_window max-pooling + equality mask — branch-free, fuses.
"""

import jax
import jax.numpy as jnp


def nms1d(x, radius):
    """Indices mask of strict local maxima within +-radius (nms.hpp:10-38).
    x: (N,) -> bool mask (N,)."""
    window = 2 * radius + 1
    maxes = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (window,), (1,), "SAME")
    return x >= maxes


def nms2d(img, radius, threshold=None):
    """Local-maximum mask over a 2D image with (2r+1)^2 windows (nms.hpp:40-81).
    Returns bool mask; optionally also require img > threshold."""
    window = 2 * radius + 1
    maxes = jax.lax.reduce_window(
        img, -jnp.inf, jax.lax.max, (window, window), (1, 1), "SAME")
    mask = img >= maxes
    if threshold is not None:
        mask = mask & (img > threshold)
    return mask


def top_k_peaks(img, k, radius, threshold=-jnp.inf):
    """Static-shape peak extraction: NMS then top-k by score. Returns
    (scores (k,), rows (k,), cols (k,)) — invalid peaks have score -inf."""
    mask = nms2d(img, radius)
    scores = jnp.where(mask & (img > threshold), img, -jnp.inf)
    flat = scores.reshape(-1)
    vals, idx = jax.lax.top_k(flat, k)
    w = img.shape[1]
    return vals, idx // w, idx % w

"""ORB-style features, accelerator-native: FAST-9 detection (vectorized over the
whole image), Harris ranking, intensity-centroid orientation, and rotated
binary-test descriptors matched by one matmul.

Closes the last SURVEY §2 inventory gap (reference ORB `detectAndMatch`,
st0-core/include/struct_def.hpp:113-134, used by st11 panorama). Design is
Accelerator-first rather than a port of OpenCV's ORB:

  - FAST-9: the 16 Bresenham-circle comparisons are 16 static image shifts
    + elementwise masks; the "9 contiguous" test is 16 windowed AND-products
    — all (H, W) elementwise ops, zero data-dependent control flow.
  - Ranking: Harris response at FAST corners (what ORB does), via convs.
  - Orientation: intensity-centroid moments m10/m01 computed for EVERY
    pixel with two small convolutions, gathered at keypoints.
  - Descriptor: 256 coordinate-pair intensity tests (a deterministic
    Gaussian pattern, the original BRIEF recipe) on the blurred image,
    steered by the keypoint angle; emitted as +-1/16 unit vectors so that
    all-pairs matching is ONE (N1,256)x(256,N2) matmul with
    hamming = 128 * (1 - sim).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.ops.image import gaussian_blur, sample_bilinear, sobel
from slam_tricks_tpu.ops.nms import top_k_peaks
from slam_tricks_tpu.solvers.common import HIGHEST

# 16-point Bresenham circle of radius 3, in circular order: (dx, dy)
_CIRCLE = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
           (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
           (-2, -2), (-1, -3)]
_PATCH = 15          # descriptor/orientation half-window
_NBITS = 256


def _pattern(seed=7):
    """Deterministic BRIEF test pattern: (256, 2, 2) point pairs ~ N(0, p/5),
    clipped inside the patch (the original BRIEF G-II recipe)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, _PATCH / 5.0, size=(_NBITS, 2, 2))
    return np.clip(p, -(_PATCH - 2), _PATCH - 2).astype(np.float32)


_PATTERN = _pattern()


class OrbFeatures(NamedTuple):
    xy: jnp.ndarray       # (N, 2) x,y pixel coordinates
    score: jnp.ndarray    # (N,) Harris score at the corner (-inf if padded)
    angle: jnp.ndarray    # (N,) orientation, radians
    desc: jnp.ndarray     # (N, 256) +-1/16 steered binary tests
    valid: jnp.ndarray    # (N,) bool


def _fast_mask(img, thresh):
    """FAST-9 corner mask: >= 9 CONTIGUOUS circle pixels all brighter than
    center+t or all darker than center-t."""
    shifted = [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for dx, dy in _CIRCLE]
    b = [s > img + thresh for s in shifted]
    d = [s < img - thresh for s in shifted]

    def contiguous9(masks):
        hit = jnp.zeros_like(img, dtype=bool)
        for s in range(16):
            seg = masks[s]
            for j in range(1, 9):
                seg = seg & masks[(s + j) % 16]
            hit = hit | seg
        return hit

    mask = contiguous9(b) | contiguous9(d)
    # kill the border (shifts wrap; descriptors need the patch inside too)
    H, W = img.shape
    r = jnp.arange(H)[:, None]
    c = jnp.arange(W)[None, :]
    pad = _PATCH + 1
    inside = (r >= pad) & (r < H - pad) & (c >= pad) & (c < W - pad)
    return mask & inside


def _harris_response(img, blur=1.5, kappa=0.04):
    gx, gy = sobel(img)
    gxx = gaussian_blur(gx * gx, blur)
    gyy = gaussian_blur(gy * gy, blur)
    gxy = gaussian_blur(gx * gy, blur)
    return gxx * gyy - gxy * gxy - kappa * (gxx + gyy) ** 2


def _centroid_moments(img):
    """Per-pixel circular-patch intensity moments (m10, m01) via two convs."""
    r = jnp.arange(-_PATCH, _PATCH + 1, dtype=img.dtype)
    yy, xx = jnp.meshgrid(r, r, indexing="ij")
    disk = (xx * xx + yy * yy <= _PATCH * _PATCH).astype(img.dtype)

    def conv(k):
        return jax.lax.conv_general_dilated(
            img[None, None], (k * disk)[None, None],
            window_strides=(1, 1), padding="SAME",
            precision=HIGHEST)[0, 0]

    return conv(xx), conv(yy)


@partial(jax.jit, static_argnames=("n",))
def orb_detect(img, *, n=256, fast_thresh=0.04, nms_radius=4):
    """Detect up to n ORB features (static shape; `valid` marks real ones).
    img: (H, W) grayscale in [0, 1]."""
    dtype = img.dtype
    mask = _fast_mask(img, jnp.asarray(fast_thresh, dtype))
    resp = _harris_response(img)
    resp = jnp.where(mask, resp, -jnp.inf)
    scores, rows, cols = top_k_peaks(resp, n, nms_radius, -jnp.inf)
    valid = jnp.isfinite(scores)
    rows = jnp.where(valid, rows, _PATCH + 1)
    cols = jnp.where(valid, cols, _PATCH + 1)
    xy = jnp.stack([cols, rows], axis=1).astype(dtype)

    m10, m01 = _centroid_moments(img)
    angle = jnp.arctan2(m01[rows, cols], m10[rows, cols])

    # steered binary tests on the blurred image
    smooth = gaussian_blur(img, 2.0)
    pat = jnp.asarray(_PATTERN, dtype)                      # (256, 2, 2)

    def describe(p, th):
        ca, sa = jnp.cos(th), jnp.sin(th)
        R = jnp.array([[ca, -sa], [sa, ca]], dtype)
        pts = jnp.einsum("ij,btj->bti", R, pat)             # rotate offsets
        va = sample_bilinear(smooth, p[None, :] + pts[:, 0])
        vb = sample_bilinear(smooth, p[None, :] + pts[:, 1])
        return jnp.where(va < vb, 1.0, -1.0).astype(dtype) / 16.0

    desc = jax.vmap(describe)(xy, angle)
    desc = desc * valid[:, None]
    return OrbFeatures(xy=xy, score=scores, angle=angle, desc=desc,
                       valid=valid)


def orb_match(f1: OrbFeatures, f2: OrbFeatures, *, ratio=0.9,
              max_hamming=64):
    """Mutual-best + Lowe-ratio Hamming matching via one matmul
    (hamming = 128 * (1 - <d1, d2>) for the +-1/16 encoding).
    Returns (idx2 (N1,), ok (N1,))."""
    sim = jnp.einsum("ik,jk->ij", f1.desc, f2.desc, precision=HIGHEST)
    sim = jnp.where(f2.valid[None, :], sim, -jnp.inf)
    best2 = jnp.argmax(sim, axis=1)
    top2 = jax.lax.top_k(sim, 2)[0]
    ham1 = 128.0 * (1.0 - top2[:, 0])
    ham2 = 128.0 * (1.0 - top2[:, 1])
    best1 = jnp.argmax(sim, axis=0)
    mutual = best1[best2] == jnp.arange(f1.desc.shape[0])
    ok = (mutual & f1.valid & (ham1 <= max_hamming)
          & (ham1 < ratio * jnp.maximum(ham2, 1e-6)))
    return best2, ok

"""Panorama stitching pipeline (st11): corners -> patch matching -> RANSAC
homographies -> chaining to the middle reference frame -> canvas composition.

Reference flow (st11-panorama/src/src/panorama.cpp:19-153): ORB matches ->
top-100 selection -> per-pair homography (DLT + RANSAC, projective.cpp:59-105)
-> chaining :106-118 -> bias + warpPerspective composition :120-152.

Accelerator-native substitutions: Harris-style corners (conv), normalized-cross-
correlation patch descriptors + all-pairs matching (one matmul),
the framework's vmapped-RANSAC homography, and gather-based inverse warping.
"""

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.initialization.homography import apply_h, homography_dlt
from slam_tricks_tpu.initialization.ransac import ransac
from slam_tricks_tpu.ops.image import gaussian_blur, sample_bilinear, sobel
from slam_tricks_tpu.ops.nms import top_k_peaks
from slam_tricks_tpu.solvers.common import HIGHEST


def harris_corners(img, k=256, blur=1.5, kappa=0.04, nms_radius=6):
    """Harris response + NMS top-k. Returns (scores (k,), xy (k,2))."""
    gx, gy = sobel(img)
    gxx = gaussian_blur(gx * gx, blur)
    gyy = gaussian_blur(gy * gy, blur)
    gxy = gaussian_blur(gx * gy, blur)
    resp = gxx * gyy - gxy * gxy - kappa * (gxx + gyy) ** 2
    scores, rows, cols = top_k_peaks(resp, k, nms_radius,
                                     0.001 * jnp.max(resp))
    return scores, jnp.stack([cols, rows], axis=1).astype(img.dtype)


def patch_descriptors(img, xy, patch=8):
    """Normalized patch descriptors (k, (2p+1)^2), sampled bilinearly."""
    dy, dx = jnp.meshgrid(jnp.arange(-patch, patch + 1, dtype=img.dtype),
                          jnp.arange(-patch, patch + 1, dtype=img.dtype),
                          indexing="ij")
    offs = jnp.stack([dx.reshape(-1), dy.reshape(-1)], axis=1)

    def one(p):
        v = sample_bilinear(img, p[None, :] + offs)
        v = v - jnp.mean(v)
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-6)

    return jax.vmap(one)(xy)


def match_descriptors(d1, d2, ratio=0.9, valid1=None, valid2=None, min_sim=0.6):
    """All-pairs NCC matching, mutual-best + Lowe ratio on DESCRIPTOR DISTANCE
    (d^2 = 2 - 2*sim for unit descriptors; ratio on raw similarity rejects
    nearly everything on repetitive texture).
    Returns (idx2 (k,), valid (k,)) for each descriptor in d1."""
    sim = jnp.einsum("ik,jk->ij", d1, d2, precision=HIGHEST)
    if valid2 is not None:
        sim = jnp.where(valid2[None, :], sim, -1.0)
    best2 = jnp.argmax(sim, axis=1)
    s_sorted = jax.lax.top_k(sim, 2)[0]
    dist1 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * s_sorted[:, 0], 0.0))
    dist2 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * s_sorted[:, 1], 1e-12))
    ratio_ok = dist1 < ratio * dist2
    best1 = jnp.argmax(sim, axis=0)
    mutual = best1[best2] == jnp.arange(d1.shape[0])
    ok = ratio_ok & mutual & (s_sorted[:, 0] > min_sim)
    if valid1 is not None:
        ok = ok & valid1
    return best2, ok


def pairwise_homography(key, img1, img2, n_corners=256, inlier_px=2.0,
                        features="harris"):
    """Estimate H mapping img1 coords -> img2 coords via corners+RANSAC.
    Returns (H, n_inliers). features: "harris" (NCC patches) or "orb"
    (rotation-steered binary descriptors, frontend/orb.py — the reference's
    actual feature choice, panorama.cpp ORB matches)."""
    if features == "orb":
        from slam_tricks_tpu.frontend.orb import orb_detect, orb_match

        f1 = orb_detect(img1, n=n_corners)
        f2 = orb_detect(img2, n=n_corners)
        m_idx, m_ok = orb_match(f1, f2)
        xy1, xy2 = f1.xy, f2.xy
    else:
        s1, xy1 = harris_corners(img1, n_corners)
        s2, xy2 = harris_corners(img2, n_corners)
        d1 = patch_descriptors(img1, xy1)
        d2 = patch_descriptors(img2, xy2)
        m_idx, m_ok = match_descriptors(d1, d2, valid1=jnp.isfinite(s1),
                                        valid2=jnp.isfinite(s2))
    src = xy1
    dst = xy2[m_idx]
    w = m_ok.astype(img1.dtype)

    data = {"src": src, "dst": dst, "w": w}

    def min_fit(d):
        return homography_dlt(d["src"], d["dst"], d["w"]).reshape(-1)

    def residual_sq(params, d):
        H = params.reshape(3, 3)
        pred = apply_h(H, d["src"])
        r2 = jnp.sum((pred - d["dst"]) ** 2, axis=1)
        return jnp.where(d["w"] > 0, r2, jnp.inf)

    def refit(d, weights):
        return homography_dlt(d["src"], d["dst"], weights * d["w"]).reshape(-1)

    res = ransac(key, data, min_fit=min_fit, residual_sq=residual_sq,
                 refit=refit, subset_size=5, n_hyps=256,
                 inlier_thresh_sq=inlier_px ** 2, sample_weights=w)
    return res.params.reshape(3, 3), res.n_inliers


def chain_to_middle(Hs_pairwise):
    """Chain consecutive pairwise homographies H_i->i+1 to the middle frame
    (panorama.cpp:106-118). Returns list of H_i->mid."""
    n = len(Hs_pairwise) + 1
    mid = n // 2
    Hs = [None] * n
    Hs[mid] = np.eye(3)
    for i in range(mid - 1, -1, -1):
        Hs[i] = Hs[i + 1] @ np.asarray(Hs_pairwise[i])
    for i in range(mid + 1, n):
        Hs[i] = Hs[i - 1] @ np.linalg.inv(np.asarray(Hs_pairwise[i - 1]))
    return Hs


def compose_panorama(images, Hs_to_mid):
    """Inverse-warp every image onto a common canvas (bias translation +
    warp, panorama.cpp:120-152); later images overwrite where defined."""
    corners = []
    for img, H in zip(images, Hs_to_mid):
        h, w = img.shape[:2]
        pts = np.array([[0, 0], [w, 0], [0, h], [w, h]], float)
        ph = np.concatenate([pts, np.ones((4, 1))], 1) @ np.asarray(H).T
        corners.append(ph[:, :2] / ph[:, 2:])
    allc = np.concatenate(corners)
    lo = np.floor(allc.min(axis=0)).astype(int)
    hi = np.ceil(allc.max(axis=0)).astype(int)
    W = int(hi[0] - lo[0])
    Hh = int(hi[1] - lo[1])
    canvas = jnp.zeros((Hh, W), jnp.float32)
    weight = jnp.zeros((Hh, W), jnp.float32)
    ys, xs = jnp.meshgrid(jnp.arange(Hh) + lo[1], jnp.arange(W) + lo[0],
                          indexing="ij")
    grid = jnp.stack([xs, ys], axis=-1).astype(jnp.float32)
    for img, H in zip(images, Hs_to_mid):
        Hinv = jnp.asarray(np.linalg.inv(np.asarray(H)), jnp.float32)
        src_xy = apply_h(Hinv, grid.reshape(-1, 2)).reshape(Hh, W, 2)
        h, w = img.shape
        inb = ((src_xy[..., 0] >= 0) & (src_xy[..., 0] <= w - 1)
               & (src_xy[..., 1] >= 0) & (src_xy[..., 1] <= h - 1))
        vals = sample_bilinear(jnp.asarray(img, jnp.float32), src_xy)
        canvas = jnp.where(inb, canvas * (weight > 0) * 0.0 + vals, canvas)
        weight = jnp.where(inb, 1.0, weight)
    return canvas, weight > 0


def stitch(images, seed=0):
    """Full pipeline: consecutive pairwise homographies -> chain -> compose."""
    key = jax.random.PRNGKey(seed)
    Hs_pair = []
    for i in range(len(images) - 1):
        key, k = jax.random.split(key)
        H, n_in = pairwise_homography(k, jnp.asarray(images[i], jnp.float32),
                                      jnp.asarray(images[i + 1], jnp.float32))
        Hs_pair.append(np.asarray(H))
    Hs_mid = chain_to_middle(Hs_pair)
    return compose_panorama(images, Hs_mid)

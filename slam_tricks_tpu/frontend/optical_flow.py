"""Pyramidal Lucas-Kanade optical flow — the st5 tracker re-designed for an accelerator.

Reference: st5-opticalflow/src/include/opticalflow.hpp wraps
cv::calcOpticalFlowPyrLK (:64) around grid-based seeding/replenishment
(:110-163). Here the LK solver itself is implemented: coarse-to-fine pyramid,
per-point iterative refinement with bilinear-sampled patches — each level is a
vmapped fixed-iteration loop (static shapes), the entire tracker jits into one
program. Grid seeding stays a tiny host helper.
"""

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.ops.image import gaussian_blur, sample_bilinear, sobel


def build_pyramid(img, levels=3):
    """List of images, level 0 = full resolution, each next level 2x smaller."""
    pyr = [img]
    for _ in range(levels - 1):
        blurred = gaussian_blur(pyr[-1], 1.0)
        pyr.append(blurred[::2, ::2])
    return pyr


def _lk_level(img1, img2, pts1, guess, win=7, iters=10, min_eig=1e-4):
    """One pyramid level of LK: refine flow `guess` for pts1 (N,2) in (x,y).
    Returns (flow (N,2), valid (N,))."""
    gx, gy = sobel(img1)
    dy, dx = jnp.meshgrid(jnp.arange(-win, win + 1, dtype=img1.dtype),
                          jnp.arange(-win, win + 1, dtype=img1.dtype),
                          indexing="ij")
    offs = jnp.stack([dx.reshape(-1), dy.reshape(-1)], axis=1)  # (K,2)

    def one(p, g0):
        patch_xy = p[None, :] + offs                      # (K,2)
        t = sample_bilinear(img1, patch_xy)               # template
        jx = sample_bilinear(gx, patch_xy)
        jy = sample_bilinear(gy, patch_xy)
        a = jnp.sum(jx * jx)
        b = jnp.sum(jx * jy)
        c = jnp.sum(jy * jy)
        det = a * c - b * b
        tr = a + c
        eig_min = 0.5 * (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0)))
        ok = eig_min > min_eig * offs.shape[0]
        inv_det = jnp.where(det > 1e-12, 1.0 / jnp.where(det > 1e-12, det, 1.0), 0.0)

        def body(_, flow):
            cur = sample_bilinear(img2, patch_xy + flow[None, :])
            e = cur - t
            bx = jnp.sum(jx * e)
            by = jnp.sum(jy * e)
            du = inv_det * (c * bx - b * by)
            dv = inv_det * (a * by - b * bx)
            return flow - jnp.stack([du, dv])

        flow = jax.lax.fori_loop(0, iters, body, g0)
        return jnp.where(ok, flow, g0), ok

    return jax.vmap(one)(pts1, guess)


def lk_track(img1, img2, pts1, *, levels=3, win=7, iters=10):
    """Track pts1 (N,2) from img1 to img2. Returns (pts2 (N,2), valid (N,)).

    Coarse-to-fine over `levels`; flow estimated at each level and upsampled
    (the cv::calcOpticalFlowPyrLK contract, opticalflow.hpp:64)."""
    p1 = build_pyramid(img1, levels)
    p2 = build_pyramid(img2, levels)
    scale = 2.0 ** (levels - 1)
    flow = jnp.zeros_like(pts1)
    valid = jnp.ones(pts1.shape[0], bool)
    for lv in range(levels - 1, -1, -1):
        s = 2.0 ** lv
        flow, ok = _lk_level(p1[lv], p2[lv], pts1 / s, flow, win=win, iters=iters)
        valid = valid & ok
        if lv > 0:
            flow = flow * 2.0
    pts2 = pts1 + flow
    H, W = img1.shape
    inb = ((pts2[:, 0] >= win) & (pts2[:, 0] < W - win)
           & (pts2[:, 1] >= win) & (pts2[:, 1] < H - win))
    return pts2, valid & inb


def grid_seed_points(h, w, grid=8, pts_per_cell=2, margin=12, seed=0):
    """Host helper: random seeds per grid cell (the st5 initGrids role,
    opticalflow.hpp:110-136). Returns (N,2) float32 (x,y)."""
    rng = np.random.default_rng(seed)
    pts = []
    ch, cw = (h - 2 * margin) / grid, (w - 2 * margin) / grid
    for gy in range(grid):
        for gx in range(grid):
            for _ in range(pts_per_cell):
                x = margin + (gx + rng.random()) * cw
                y = margin + (gy + rng.random()) * ch
                pts.append((x, y))
    return np.asarray(pts, np.float32)


def _lk_level_scaled(img1, img2, pts1, flow, lv, **kw):
    s = 2.0 ** lv
    return _lk_level(img1, img2, pts1 / s, flow, **kw)

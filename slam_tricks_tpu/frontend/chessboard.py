"""Chessboard corner detection — accelerator re-design of the reference's
largest component (st10-chessCorner, paper "Automatic Camera and Range Sensor
Calibration using a single Shot").

Pipeline mapping (reference detector.cpp:11-110):
 1. corner likelihood: prototype-kernel correlations composed with min/max
    (compute_likehood :211-247)          -> `corner_likelihood` (lax.conv)
 2. candidate extraction: NMS + threshold (findCorners :249-265)
                                          -> ops.nms.top_k_peaks (static top-k)
 3. orientation estimation: gradient-orientation histogram + mode finding
    (verifyCorners :267-380, meanShift helper.cpp:179-205)
                                          -> `estimate_orientations` (vmapped
    soft histogram + circular smoothing + top-2 modes)
 4. subpixel refinement: GN on gradient orthogonality (refineCorners :381-400)
                                          -> `refine_corners_subpixel` (vmapped
    closed-form 2x2 solve of the structure-tensor normal equations)
 5. chessboard growth (:469-824): greedy sequential search — a poor accelerator fit by
    design; provided as a host-side numpy routine `grow_chessboards`.

All device-side stages are static-shape and batched over a fixed candidate
budget K; invalid slots carry score -inf / weight 0.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.ops.image import conv2d, gaussian_blur, sobel
from slam_tricks_tpu.ops.nms import top_k_peaks


def _prototype_kernels(radius, angles, dtype=jnp.float32):
    """Four quadrant kernels (A,B = opposing pair; C,D = the other pair) for a
    corner prototype at the given axis angles (prototype.h:9-24 role)."""
    n = 2 * radius + 1
    ys, xs = np.meshgrid(np.arange(n) - radius, np.arange(n) - radius, indexing="ij")
    r = np.sqrt(xs ** 2 + ys ** 2)
    weight = np.exp(-0.5 * (r / (radius / 2.0)) ** 2)
    a0, a1 = angles
    n0 = np.array([-math.sin(a0), math.cos(a0)])
    n1 = np.array([-math.sin(a1), math.cos(a1)])
    s0 = xs * n0[1] + ys * n0[0]
    s1 = xs * n1[1] + ys * n1[0]
    kA = weight * ((s0 > 0.1) & (s1 > 0.1))
    kB = weight * ((s0 < -0.1) & (s1 < -0.1))
    kC = weight * ((s0 > 0.1) & (s1 < -0.1))
    kD = weight * ((s0 < -0.1) & (s1 > 0.1))
    ks = []
    for k in (kA, kB, kC, kD):
        tot = k.sum()
        ks.append(jnp.asarray((k / max(tot, 1e-9)).astype(np.float32), dtype=dtype))
    return ks


def corner_likelihood(img, radius=4):
    """Corner likelihood map via two prototypes (axis-aligned and diagonal),
    min/max composition per the paper (detector.cpp:211-247 semantics).

    img: (H,W) float in [0,1]. Returns (H,W) likelihood."""
    like = None
    for angles in ((0.0, math.pi / 2), (math.pi / 4, 3 * math.pi / 4)):
        kA, kB, kC, kD = _prototype_kernels(radius, angles, img.dtype)
        fA = conv2d(img, kA)
        fB = conv2d(img, kB)
        fC = conv2d(img, kC)
        fD = conv2d(img, kD)
        mu = 0.25 * (fA + fB + fC + fD)
        s1 = jnp.minimum(jnp.minimum(fA, fB) - mu, mu - jnp.maximum(fC, fD))
        s2 = jnp.minimum(mu - jnp.maximum(fA, fB), jnp.minimum(fC, fD) - mu)
        s = jnp.maximum(s1, s2)
        like = s if like is None else jnp.maximum(like, s)
    return jnp.maximum(like, 0.0)


def corner_likelihood_multiscale(img, radii=(4, 8, 12)):
    """Multi-scale likelihood: max over prototype radii (the single-shot
    calibration paper composes radii 4/8/12 so small and large squares both
    respond; the reference fixes one radius PROTO_HWS=10,
    detector.h:68-69 — this exceeds it)."""
    like = None
    for r in radii:
        s = corner_likelihood(img, r)
        like = s if like is None else jnp.maximum(like, s)
    return like


def detect_corners(img, k=256, radius=4, nms_radius=5, rel_threshold=0.03,
                   radii=None):
    """Stages 1+2: likelihood -> NMS -> top-k candidates.

    Pass radii=(4,8,12) for the multi-scale likelihood. Returns
    (scores (k,), xy (k,2) float pixel coords) — slots below threshold have
    score -inf."""
    if radii is not None:
        like = corner_likelihood_multiscale(img, radii)
    else:
        like = corner_likelihood(img, radius)
    thresh = rel_threshold * jnp.max(like)
    scores, rows, cols = top_k_peaks(like, k, nms_radius, thresh)
    xy = jnp.stack([cols, rows], axis=1).astype(img.dtype)
    return scores, xy


def refine_corners_subpixel(img, xy, window=10):
    """Stage 4: solve (sum g g^T) c = sum (g g^T) p over the window — the
    gradient-orthogonality normal equations (refineCorners detector.cpp:381-400).
    Returns refined (k,2) positions (unmoved where the system is degenerate)."""
    gx, gy = sobel(img)
    H, W = img.shape
    n = 2 * window + 1
    dy, dx = jnp.meshgrid(jnp.arange(-window, window + 1),
                          jnp.arange(-window, window + 1), indexing="ij")

    def one(p):
        x0 = jnp.clip(jnp.round(p[0]).astype(jnp.int32), window, W - window - 1)
        y0 = jnp.clip(jnp.round(p[1]).astype(jnp.int32), window, H - window - 1)
        ys = y0 + dy
        xs = x0 + dx
        gxx = gx[ys, xs]
        gyy = gy[ys, xs]
        # structure tensor and weighted centroid system
        a = jnp.sum(gxx * gxx)
        b = jnp.sum(gxx * gyy)
        c = jnp.sum(gyy * gyy)
        px = xs.astype(img.dtype)
        py = ys.astype(img.dtype)
        bx = jnp.sum((gxx * gxx) * px + (gxx * gyy) * py)
        by = jnp.sum((gxx * gyy) * px + (gyy * gyy) * py)
        det = a * c - b * b
        ok = det > 1e-8
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        cx = inv_det * (c * bx - b * by)
        cy = inv_det * (a * by - b * bx)
        refined = jnp.stack([cx, cy])
        # clamp runaway solutions to the window
        good = ok & (jnp.max(jnp.abs(refined - p)) < window)
        return jnp.where(good, refined, p)

    return jax.vmap(one)(xy)


def estimate_orientations(img, xy, window=10, n_bins=32):
    """Stage 3: per-candidate gradient-orientation histogram (soft binning),
    circular Gaussian smoothing, top-2 modes -> two edge angles in [0, pi).

    Returns (angles (k,2), mode_strengths (k,2))."""
    gx, gy = sobel(img)
    mag = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.mod(jnp.arctan2(gy, gx), jnp.pi)  # edge orientation mod pi
    H, W = img.shape
    dy, dx = jnp.meshgrid(jnp.arange(-window, window + 1),
                          jnp.arange(-window, window + 1), indexing="ij")
    bin_centers = jnp.arange(n_bins) * (jnp.pi / n_bins)

    def one(p):
        x0 = jnp.clip(jnp.round(p[0]).astype(jnp.int32), window, W - window - 1)
        y0 = jnp.clip(jnp.round(p[1]).astype(jnp.int32), window, H - window - 1)
        ys = y0 + dy
        xs = x0 + dx
        m = mag[ys, xs].reshape(-1)
        a = ang[ys, xs].reshape(-1)
        # soft circular binning (replaces meanShift, helper.cpp:179-205)
        d = a[:, None] - bin_centers[None, :]
        d = jnp.abs(jnp.mod(d + jnp.pi / 2, jnp.pi) - jnp.pi / 2)
        w = jnp.exp(-0.5 * (d / (jnp.pi / n_bins)) ** 2)
        hist = jnp.sum(m[:, None] * w, axis=0)
        # top-2 well-separated modes
        i1 = jnp.argmax(hist)
        sep = jnp.abs(jnp.mod(bin_centers - bin_centers[i1] + jnp.pi / 2, jnp.pi)
                      - jnp.pi / 2)
        masked = jnp.where(sep > jnp.pi / 8, hist, -jnp.inf)
        i2 = jnp.argmax(masked)
        return (jnp.stack([bin_centers[i1], bin_centers[i2]]),
                jnp.stack([hist[i1], masked[i2]]))

    return jax.vmap(one)(xy)


def verify_corners(img, xy, scores, window=10, min_mode_ratio=0.3,
                   min_separation=jnp.pi / 4):
    """Stage 3b: chessboard-corner verification — keep candidates whose
    gradient histogram shows two strong, well-separated edge modes
    (verifyCorners role, detector.cpp:267-380). Returns scores with rejected
    candidates set to -inf (static shape).

    Real-photo caveat: at small square sizes the 21x21 histogram window
    under-resolves the modes; tune `window` to ~0.5 square sizes."""
    angles, strength = estimate_orientations(img, xy, window=window)
    sep = jnp.abs(jnp.mod(angles[:, 0] - angles[:, 1] + jnp.pi / 2, jnp.pi)
                  - jnp.pi / 2)
    ratio = strength[:, 1] / jnp.maximum(strength[:, 0], 1e-9)
    ok = (ratio > min_mode_ratio) & (sep > min_separation)
    return jnp.where(ok, scores, -jnp.inf)


def _circular_gauss_taps(hist):
    """Circular 5-tap Gaussian smoothing of (..., 32) histograms — the
    reference's gaussFilter taps [.1,.2,.4,.2,.1] (helper.cpp:165-177)."""
    taps = (0.1, 0.2, 0.4, 0.2, 0.1)
    out = sum(t * jnp.roll(hist, k, axis=-1)
              for t, k in zip(taps, (-2, -1, 0, 1, 2)))
    return out


def mean_shift_modes(hist):
    """Circular mean-shift bimodal mode finding on (32,) orientation
    histograms — exact semantics of the reference's meanShift
    (helper.cpp:179-253): three seeds at bins 6/16/26, 10 iterations with
    half-window 4 then 10 with half-window 2, snap to the local peak, merge
    the two closest seeds keeping the stronger. Returns (i1, i2) int32 bins.
    Fully vmappable (fixed iteration counts, gather-only)."""
    n = hist.shape[-1]
    offs4 = jnp.arange(-4, 5)
    offs2 = jnp.arange(-2, 3)

    def shift(idx, offs):
        c = jnp.mod(jnp.round(idx).astype(jnp.int32), n)
        vals = hist[jnp.mod(c + offs, n)]
        return idx + jnp.sum(offs * vals) / jnp.maximum(jnp.sum(vals), 1e-12)

    def run(idx):
        for _ in range(10):
            idx = shift(idx, offs4)
        for _ in range(10):
            idx = shift(idx, offs2)
        # snap: better of floor/round, then best of its 3-neighborhood
        lower = jnp.mod(jnp.floor(idx).astype(jnp.int32), n)
        top = jnp.mod(jnp.round(idx).astype(jnp.int32), n)
        mid = jnp.where(hist[lower] > hist[top], lower, top)
        lo = jnp.mod(mid - 1, n)
        hi = jnp.mod(mid + 1, n)
        best = jnp.where(hist[lo] >= jnp.maximum(hist[mid], hist[hi]), lo,
                         jnp.where(hist[mid] >= hist[hi], mid, hi))
        return best

    i1 = run(jnp.asarray(6.0, hist.dtype))
    i2 = run(jnp.asarray(16.0, hist.dtype))
    i3 = run(jnp.asarray(26.0, hist.dtype))

    def cdist(a, b):
        d = jnp.abs(a - b)
        return jnp.minimum(d, n - d)

    d12, d13, d23 = cdist(i1, i2), cdist(i1, i3), cdist(i2, i3)
    dmin = jnp.minimum(jnp.minimum(d12, d13), d23)
    pick = lambda a, b: jnp.where(hist[a] > hist[b], a, b)
    m1 = jnp.where(d12 == dmin, i3, jnp.where(d13 == dmin, i2, i1))
    m2 = jnp.where(d12 == dmin, pick(i1, i2),
                   jnp.where(d13 == dmin, pick(i1, i3), pick(i2, i3)))
    return m1, m2


def _sector_prototype(radius, a1, a2, dtype):
    """Angular-sector corner prototype quadrants (prototype.cpp:5-37): pixels
    binned by polar angle into [a1,a2) -> A, [a2,a1+pi) -> C,
    [a1+pi,a2+pi) -> B, [a2+pi,a1) -> D, with Gaussian radial weight
    sigma = radius/2. a1/a2 may be traced scalars (vmappable)."""
    n = 2 * radius + 1
    ys, xs = jnp.meshgrid(jnp.arange(n) - radius, jnp.arange(n) - radius,
                          indexing="ij")
    r = jnp.sqrt((xs ** 2 + ys ** 2).astype(dtype))
    wgt = jnp.exp(-0.5 * (r / (radius / 2.0)) ** 2)
    wgt = wgt.at[radius, radius].set(0.0)
    ang = jnp.arctan2(ys.astype(dtype), xs.astype(dtype))
    two_pi = 2 * jnp.pi

    def in_range(a, lo, hi):
        return jnp.mod(a - lo, two_pi) < jnp.mod(hi - lo, two_pi)

    A = wgt * in_range(ang, a1, a2)
    C = wgt * in_range(ang, a2, a1 + jnp.pi)
    B = wgt * in_range(ang, a1 + jnp.pi, a2 + jnp.pi)
    D = wgt * in_range(ang, a2 + jnp.pi, a1)
    return A, B, C, D


def _sobel_mag(patch):
    """Gradient magnitude of a small patch via roll-based 3x3 Sobel (matches
    cv2.Sobel ksize=3 up to border rows, which the Gaussian weight already
    suppresses)."""
    sh = lambda dy, dx: jnp.roll(jnp.roll(patch, dy, axis=0), dx, axis=1)
    gx = (sh(0, -1) - sh(0, 1)) * 2 + (sh(-1, -1) - sh(-1, 1)) + (sh(1, -1) - sh(1, 1))
    gy = (sh(-1, 0) - sh(1, 0)) * 2 + (sh(-1, -1) - sh(1, -1)) + (sh(-1, 1) - sh(1, 1))
    return jnp.sqrt(gx * gx + gy * gy)


def verify_corners_meanshift(img, xy, scores, like=None, window=10,
                             rel_threshold=0.25):
    """Stage 3, reference-fidelity (verifyCorners detector.cpp:267-380):
    per-candidate 32-bin HARD gradient-orientation histogram, circular
    Gaussian smoothing, circular mean-shift bimodal mode finding, the
    mode-separation/balance gate (bin distance > 10 of 32, values within 70%),
    then the prototype-gradient correlation score

        score = likelihood(pt) * <|grad| patch, expected |grad| of the
                 two-mode sector prototype> / (norms)

    and the relative threshold scores > rel_threshold * max (the reference
    default is 0.4, detector.h:68; 0.25 keeps dim far-perspective corners on
    the in-the-wild photos without measurably hurting the clean target).

    Returns (scores_new (k,), angles (k,2) edge angles in [0,pi)) — rejected
    slots carry -inf. All stages vmapped, static shapes."""
    gx, gy = sobel(img)
    mag = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.mod(jnp.arctan2(gy, gx), jnp.pi)
    if like is None:
        like = corner_likelihood(img)
    H, W = img.shape
    n_bins = 32
    bin_size = jnp.pi / n_bins
    dy, dx = jnp.meshgrid(jnp.arange(-window, window + 1),
                          jnp.arange(-window, window + 1), indexing="ij")

    def one(p, s):
        x0 = jnp.clip(jnp.round(p[0]).astype(jnp.int32), window, W - window - 1)
        y0 = jnp.clip(jnp.round(p[1]).astype(jnp.int32), window, H - window - 1)
        ys = y0 + dy
        xs = x0 + dx
        m = mag[ys, xs]
        a = ang[ys, xs]
        bins = jnp.clip((a / bin_size).astype(jnp.int32), 0, n_bins - 1)
        hist = jnp.zeros((n_bins,), img.dtype).at[bins.reshape(-1)].add(
            m.reshape(-1))
        hist = _circular_gauss_taps(hist)
        i1, i2 = mean_shift_modes(hist)
        lo = jnp.minimum(i1, i2)
        hi = jnp.maximum(i1, i2)
        a1 = lo.astype(img.dtype) / (n_bins - 1.0) * jnp.pi
        a2 = hi.astype(img.dtype) / (n_bins - 1.0) * jnp.pi
        v1, v2 = hist[i1], hist[i2]
        dis = jnp.abs(i1 - i2)
        dis = jnp.where(dis > n_bins // 2, n_bins - dis, dis)
        gate = (dis > 10) & (jnp.abs(v1 - v2) < jnp.maximum(v1, v2) * 0.7)

        # prototype-gradient correlation
        A, B, C, D = _sector_prototype(window, a1, a2, img.dtype)
        exp_grad = jnp.maximum(jnp.maximum(_sobel_mag(A), _sobel_mag(B)),
                               jnp.maximum(_sobel_mag(C), _sobel_mag(D)))
        num = jnp.sum(m * exp_grad)
        den = jnp.sqrt(jnp.sum(m * m)) * jnp.sqrt(jnp.sum(exp_grad ** 2))
        score_grad = num / jnp.maximum(den, 1e-12)
        score = like[y0, x0] * score_grad
        ok = gate & jnp.isfinite(s)
        return jnp.where(ok, score, -jnp.inf), jnp.stack([a1, a2])

    scores_new, angles = jax.vmap(one)(xy, scores)
    smax = jnp.max(jnp.where(jnp.isfinite(scores_new), scores_new, 0.0))
    scores_new = jnp.where(scores_new > rel_threshold * smax, scores_new,
                           -jnp.inf)
    return scores_new, angles


def refine_edge_directions(img, xy, angles, window=5, rounds=2):
    """Stage 4b (detector.cpp:403-455): re-estimate each corner's two edge
    directions from the gradients in its window. Gradients nearly orthogonal
    to the current direction estimate (|cos| < 0.25 after normalization) are
    assigned to that edge; the refined direction is the null direction of
    their second-moment matrix — the reference solves this with an Nx2 SVD,
    which equals the closed-form smallest eigenvector of the 2x2 A^T A
    (vmappable, no SVD needed). Runs `rounds` fixed-point rounds.

    Returns refined angles (k,2) in [0, pi)."""
    gx, gy = sobel(img)
    H, W = img.shape
    dy, dx = jnp.meshgrid(jnp.arange(-window, window + 1),
                          jnp.arange(-window, window + 1), indexing="ij")

    def smallest_evec_angle(a, b, c, fallback):
        """Angle of the smallest eigenvector of [[a,b],[b,c]] (the edge
        direction); falls back when the selection mask was empty."""
        tr = a + c
        det = a * c - b * b
        disc = jnp.sqrt(jnp.maximum(tr * tr / 4 - det, 0.0))
        lam_min = tr / 2 - disc
        # eigenvector: (b, lam_min - a) or (lam_min - c, b)
        v1 = jnp.stack([b, lam_min - a])
        v2 = jnp.stack([lam_min - c, b])
        v = jnp.where(jnp.sum(v1 * v1) > jnp.sum(v2 * v2), v1, v2)
        ok = jnp.sum(v * v) > 1e-20
        angle = jnp.mod(jnp.arctan2(v[1], v[0]), jnp.pi)
        return jnp.where(ok, angle, fallback)

    def one(p, aa):
        x0 = jnp.clip(jnp.round(p[0]).astype(jnp.int32), window, W - window - 1)
        y0 = jnp.clip(jnp.round(p[1]).astype(jnp.int32), window, H - window - 1)
        ys = y0 + dy
        xs = x0 + dx
        g1 = gx[ys, xs].reshape(-1)
        g2 = gy[ys, xs].reshape(-1)
        norm = jnp.sqrt(g1 * g1 + g2 * g2)
        n1 = g1 / jnp.maximum(norm, 1e-12)
        n2 = g2 / jnp.maximum(norm, 1e-12)

        def refine_one(a_cur):
            v = jnp.stack([jnp.cos(a_cur), jnp.sin(a_cur)])
            sel = (jnp.abs(v[0] * n1 + v[1] * n2) < 0.25) & (norm > 1e-9)
            w = sel.astype(img.dtype)
            a_ = jnp.sum(w * g1 * g1)
            b_ = jnp.sum(w * g1 * g2)
            c_ = jnp.sum(w * g2 * g2)
            return smallest_evec_angle(a_, b_, c_, a_cur)

        out = aa
        for _ in range(rounds):
            out = jnp.stack([refine_one(out[0]), refine_one(out[1])])
        return out

    return jax.vmap(one)(xy, angles)


def detect_chessboard(img, k=256, radii=(4, 8, 12), nms_radius=5,
                      hist_window=10, refine_window=5, max_boards=4):
    """Full reference-fidelity pipeline (Detector::solve detector.cpp:11-110):
    multi-scale likelihood -> NMS top-k -> mean-shift verification with
    prototype-correlation scoring -> subpixel refinement -> SVD-equivalent
    edge-direction re-estimation -> host-side energy-gated growth.

    Returns (boards, xy_refined, scores, angles)."""
    imgj = jnp.asarray(img)
    like = corner_likelihood_multiscale(imgj, radii)
    thresh = 0.03 * jnp.max(like)
    s, rows, cols = top_k_peaks(like, k, nms_radius, thresh)
    xy = jnp.stack([cols, rows], axis=1).astype(imgj.dtype)
    scores, angles = verify_corners_meanshift(imgj, xy, s, like,
                                              window=hist_window)
    xy_ref = refine_corners_subpixel(imgj, xy, window=refine_window)
    angles = refine_edge_directions(imgj, xy_ref, angles,
                                    window=refine_window)
    boards = grow_chessboards(np.asarray(xy_ref), np.asarray(angles),
                              np.asarray(scores), max_boards=max_boards)
    return boards, xy_ref, scores, angles


def board_energy(P):
    """Chessboard structure energy of a grid of corner positions P (R,C,2):

        E = num * (max_triple ||c_i + c_k - 2 c_j|| / ||c_i - c_k||  -  1)

    over all consecutive triples along rows and columns — the reference's
    chessBoardEnergy (detector.cpp:713-744, paper eq. for E_corners +
    E_structure). More corners and straighter lines both lower E."""
    R, C = P.shape[:2]
    num = R * C
    worst = 0.0
    for A in (P, P.transpose(1, 0, 2)):          # rows, then columns
        if A.shape[1] < 3:
            continue
        ci, cj, ck = A[:, :-2], A[:, 1:-1], A[:, 2:]
        err = np.linalg.norm(ci + ck - 2 * cj, axis=2)
        den = np.linalg.norm(ci - ck, axis=2) + 1e-12
        worst = max(worst, float(np.max(err / den)))
    return num * (worst - 1.0), worst


def grow_chessboards(xy, angles, scores, max_boards=4, dist_factor=1.6,
                     init_straightness=0.3):
    """Stage 5 (host-side numpy): energy-gated growth of chessboard grids —
    the reference's seed/grow/energy pipeline (initChessBoard
    detector.cpp:602-673, growChessBoard :746-808 with the 0.85-extrapolation
    corner prediction :810-815, chessBoardEnergy gate :713-744, and the
    energy-sorted multi-board dedup of solveMutiCB :481-560).

    Returns a list of (rows, cols) index grids into `xy`, best energy first.
    Sequential pointer-chasing is a deliberate host-side step (SURVEY §7 step
    10: poor accelerator fit); the heavy stages 1-4 stay on device."""
    xy = np.asarray(xy)
    scores = np.asarray(scores)
    idxs = np.nonzero(np.isfinite(scores))[0]
    if len(idxs) < 9:
        return []
    pts = xy[idxs]
    M = len(idxs)

    def nearest_in_dir(p, direction, cos_thresh=0.85):
        d = pts - p
        dist = np.linalg.norm(d, axis=1) + 1e-9
        cosang = (d @ direction) / dist
        cand = np.where((cosang > cos_thresh) & (dist > 1e-6), dist, np.inf)
        j = int(np.argmin(cand))
        return j if np.isfinite(cand[j]) else -1

    def nearest_to(p, max_dist):
        dist = np.linalg.norm(pts - p, axis=1)
        j = int(np.argmin(dist))
        return j if dist[j] < max_dist else -1

    def init_board(seed):
        """3x3 seed board around `seed` (initChessBoard :602-673)."""
        p = pts[seed]
        d = np.linalg.norm(pts - p, axis=1)
        d[seed] = np.inf
        d[d < 1e-6] = np.inf          # zero-distance duplicates
        nn1 = int(np.argmin(d))
        if not np.isfinite(d[nn1]):
            return None
        dir1 = (pts[nn1] - p) / d[nn1]
        # second axis: nearest neighbor not collinear with dir1
        dd = pts - p
        dist = np.linalg.norm(dd, axis=1) + 1e-9
        cosang = np.abs((dd @ dir1) / dist)
        cand = np.where((cosang < 0.6) & (dist > 1e-6), dist, np.inf)
        nn2 = int(np.argmin(cand))
        if not np.isfinite(cand[nn2]):
            return None
        dir2 = (pts[nn2] - p) / dist[nn2]
        step = 0.5 * (d[nn1] + dist[nn2])

        grid = -np.ones((3, 3), np.int64)
        grid[1, 1] = seed
        for (r, c), dv in (((1, 2), dir1), ((1, 0), -dir1),
                           ((2, 1), dir2), ((0, 1), -dir2)):
            j = nearest_in_dir(p, dv)
            if j < 0 or np.linalg.norm(pts[j] - p) > dist_factor * step:
                return None
            grid[r, c] = j
        # diagonal corners by cross prediction (p + d_row + d_col)
        for (r, c), (a, b) in (((0, 0), ((1, 0), (0, 1))),
                               ((0, 2), ((1, 2), (0, 1))),
                               ((2, 0), ((1, 0), (2, 1))),
                               ((2, 2), ((1, 2), (2, 1)))):
            pred = pts[grid[a]] + pts[grid[b]] - p
            j = nearest_to(pred, 0.6 * step)
            if j < 0:
                return None
            grid[r, c] = j
        if len(set(grid.ravel().tolist())) != 9:
            return None
        e, straight = board_energy(pts[grid])
        if straight > init_straightness:
            return None
        return grid

    def grow_once(grid):
        """Try all 4 directions; return the grown grid with the lowest energy
        if any growth decreases energy (growChessBoard :746-808)."""
        e0, _ = board_energy(pts[grid])
        best = None
        taken = set(grid.ravel().tolist())
        for axis, side in ((0, 0), (0, -1), (1, 0), (1, -1)):
            A = grid if axis == 0 else grid.T
            if A.shape[0] < 2:
                continue
            edge, inner = (A[0], A[1]) if side == 0 else (A[-1], A[-2])
            # 0.85-extrapolation prediction (predictCorners :810-815); the
            # acceptance radius is PER-CORNER (its own local spacing) so
            # strong perspective foreshortening doesn't kill whole rows
            pred = pts[edge] + 0.85 * (pts[edge] - pts[inner])
            spacing = np.linalg.norm(pts[edge] - pts[inner], axis=1)
            new = []
            ok = True
            for q, sp in zip(pred, spacing):
                j = nearest_to(q, 0.5 * sp)
                if j < 0 or j in taken or j in new:
                    ok = False
                    break
                new.append(j)
            if not ok:
                continue
            row = np.asarray(new)[None, :]
            B = np.concatenate([row, A] if side == 0 else [A, row], axis=0)
            cand = B if axis == 0 else B.T
            e1, _ = board_energy(pts[cand])
            if e1 < e0 and (best is None or e1 < best[0]):
                best = (e1, cand)
        return best

    order = np.argsort(-scores[idxs])
    proposals = []
    seeded = np.zeros(M, bool)
    for seed in order:
        if seeded[seed]:
            continue
        grid = init_board(seed)
        if grid is None:
            continue
        while True:
            grown = grow_once(grid)
            if grown is None:
                break
            grid = grown[1]
        seeded[grid.ravel()] = True
        proposals.append((board_energy(pts[grid])[0], grid))

    # energy-sorted dedup of overlapping boards (solveMutiCB :481-560)
    proposals.sort(key=lambda t: t[0])
    boards, claimed = [], np.zeros(M, bool)
    for e, grid in proposals:
        if len(boards) >= max_boards:
            break
        flat = grid.ravel()
        if claimed[flat].mean() > 0.25:
            continue
        claimed[flat] = True
        boards.append(idxs[grid])
    return boards

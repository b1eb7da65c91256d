"""Normalized 8-point fundamental/essential matrix estimation + pose recovery.

Reference: st2-epipolar/src/include/epipolar.hpp (Hartley normalization :64-116,
8-point SVD solve :139-209, E = K^T F K :223-228), recovery.hpp:25-129 (4-way
decomposition + cheirality), st22-two-view/src/src/two_view_geometry.cpp:18-101.

All solvers are pure SVD pipelines — batched/vmappable, no data-dependent
shapes. Degenerate configurations surface as large residuals rather than
exceptions (masked-fallback design, SURVEY §7 "SVD differentiability").
"""

import jax
import jax.numpy as jnp

from slam_tricks_tpu.manifolds import so3
from slam_tricks_tpu.solvers.common import HIGHEST


def nullvec_normal(A):
    """Smallest right-singular vector of A (N, m) via eigh of the m x m
    normal matrix G = A^T A — one matmul + a tiny symmetric eigensolve
    instead of a tall (N,9) SVD. Squaring the condition number costs
    ~half the digits, which is immaterial for an INITIALIZATION feeding a
    refinement. Returns (v (m,), singular values (m,) descending)."""
    G = jax.lax.dot_general(A, A, (((0,), (0,)), ((), ())),
                            precision=HIGHEST)
    evals, evecs = jnp.linalg.eigh(G)          # ascending
    sv = jnp.sqrt(jnp.maximum(evals[::-1], 0.0))
    return evecs[:, 0], sv


def hartley_normalize(pts):
    """Similarity transform moving points to centroid 0 / RMS distance sqrt(2)
    (epipolar.hpp:64-116). pts (N,2) -> (pts_norm (N,2), T (3,3))."""
    mean = jnp.mean(pts, axis=0)
    centered = pts - mean
    scale = jnp.sqrt(2.0) / jnp.maximum(
        jnp.mean(jnp.linalg.norm(centered, axis=1)), 1e-12)
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=pts.dtype)
    T = T.at[0, 0].set(scale).at[1, 1].set(scale)
    T = T.at[0, 2].set(-scale * mean[0]).at[1, 2].set(-scale * mean[1])
    return centered * scale, T


def fundamental_8pt(p1, p2, weights=None, return_ok=False):
    """F from >=8 correspondences (pixels or normalized coords), Hartley
    normalized, rank-2 projected. p1/p2 (N,2). Returns F (3,3), ||F||=1."""
    n1, T1 = hartley_normalize(p1)
    n2, T2 = hartley_normalize(p2)
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=1)
    if weights is not None:
        A = A * weights[:, None]
    v, sv = nullvec_normal(A)
    F = v.reshape(3, 3)
    # rank-2 projection
    U, S, Vt2 = jnp.linalg.svd(F)
    F = (U * jnp.stack([S[0], S[1], jnp.zeros_like(S[2])])[None, :]) @ Vt2
    F = T2.T @ F @ T1
    F = F / jnp.maximum(jnp.linalg.norm(F), 1e-30)
    # masked degeneracy fallback (SURVEY §7 "SVD differentiability/edge
    # cases"; the reference bails via std::optional,
    # two_view_geometry.cpp:77-80): a unique null space needs the 8th singular
    # value well above the 9th — coplanar/pure-rotation/duplicate-point
    # configurations violate it. Degenerate inputs return identity-like F
    # with ok=False instead of NaN garbage.
    ok = (jnp.all(jnp.isfinite(F))
          & (sv[7] > 1e3 * jnp.finfo(A.dtype).eps * sv[0]))
    F = jnp.where(ok, F, jnp.eye(3, dtype=F.dtype))
    if return_ok:
        return F, ok
    return F


def essential_from_fundamental(F, K1, K2=None):
    """E = K2^T F K1 (epipolar.hpp:223-228)."""
    K2 = K1 if K2 is None else K2
    E = K2.T @ F @ K1
    return E / jnp.linalg.norm(E)


def essential_8pt(p1_norm, p2_norm, weights=None, return_ok=False):
    """E directly from normalized-plane correspondences, with the (1,1,0)
    singular-value projection. return_ok=True adds the degeneracy flag."""
    F, ok = fundamental_8pt(p1_norm, p2_norm, weights, return_ok=True)
    U, S, Vt = jnp.linalg.svd(F)
    one = jnp.ones_like(S[0])
    E = (U * jnp.stack([one, one, jnp.zeros_like(S[2])])[None, :]) @ Vt
    E = E / jnp.maximum(jnp.linalg.norm(E), 1e-30)
    if return_ok:
        return E, ok
    return E


def decompose_essential(E):
    """E -> 4 candidate (R, t): (R1,t), (R1,-t), (R2,t), (R2,-t)
    (recovery.hpp:25-129, two_view_geometry.cpp:42-101). Determinant-corrected."""
    U, _, Vt = jnp.linalg.svd(E)
    # ensure proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def triangulate_midpoint(R, t, p1, p2):
    """Two-view midpoint triangulation for cam1 = [I|0], cam2 = [R|t],
    normalized coords — CLOSED FORM: the two ray parameters solve the 3x2
    least squares [R x1, -x2] d = -t (2x2 normal equations, ~30 flops per
    point); the point is the midpoint of the two ray feet. Same semantics
    as the reference's hat-constraint DLT (st2 triangulation.hpp:21-76,
    st22 two_view_geometry.cpp:103-126) and exact on consistent rays, but
    without the per-point 4x4 null-space eigensolve (a batch of tiny eighs
    was the two-view pipeline's hot spot).
    Near-parallel rays (singular 2x2 system) return finite X with
    d1 = d2 = -1 so they FAIL the cheirality depth gates instead of
    poisoning downstream math with inf/NaN.
    Returns (X (3,), depth1, depth2)."""
    x1 = jnp.concatenate([p1, jnp.ones((1,), p1.dtype)])
    x2 = jnp.concatenate([p2, jnp.ones((1,), p2.dtype)])
    r1 = R @ x1                       # ray-1 direction in cam-2 frame
    # [r1, -x2] [d1, d2]^T ~= -t : closest approach of the two rays
    g00 = r1 @ r1
    g01 = -(r1 @ x2)
    g11 = x2 @ x2
    b0 = -(r1 @ t)
    b1 = x2 @ t
    det = g00 * g11 - g01 * g01       # >= 0 (Cauchy-Schwarz); 0 = parallel
    scale = jnp.maximum(g00 * g11, jnp.asarray(1e-30, p1.dtype))
    ok = det > 8.0 * jnp.finfo(p1.dtype).eps * scale
    det_safe = jnp.where(ok, det, 1.0)
    d1 = jnp.where(ok, (g11 * b0 - g01 * b1) / det_safe, -1.0)
    d2 = jnp.where(ok, (g00 * b1 - g01 * b0) / det_safe, -1.0)
    X1 = d1 * x1                      # foot on ray 1, cam-1 frame
    X2 = R.T @ (d2 * x2 - t)          # foot on ray 2, cam-1 frame
    X = 0.5 * (X1 + X2)
    d1 = jnp.where(ok, X[2], d1)
    d2 = jnp.where(ok, (R @ X + t)[2], d2)
    return X, d1, d2


def recover_pose(E, p1, p2, weights=None):
    """Cheirality disambiguation: pick the (R,t) with the most points in front
    of both cameras (recovery.hpp:95-129; all-pairs vote two_view_geometry.cpp:61-101).

    Returns (R, t, n_good, X (N,3) triangulated under the winner)."""
    Rs, ts = decompose_essential(E)
    w = jnp.ones(p1.shape[0], p1.dtype) if weights is None else weights

    def score(R, t):
        X, d1, d2 = jax.vmap(lambda a, b: triangulate_midpoint(R, t, a, b))(p1, p2)
        good = (d1 > 0) & (d2 > 0) & jnp.all(jnp.isfinite(X), axis=1)
        X = jnp.where(good[:, None], X, 0.0)
        return jnp.sum(good * w), X

    scores, Xs = jax.vmap(score)(Rs, ts)
    best = jnp.argmax(scores)
    return Rs[best], ts[best], scores[best], Xs[best]

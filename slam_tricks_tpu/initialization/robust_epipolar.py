"""Robust fundamental/essential estimation: vmapped RANSAC initialization +
Cauchy-IRLS polish + chi-square inlier gate.

Reference semantics covered (st2-epipolar/src/include/epipolar.hpp:139-209):
the iterative chi-square outlier-rejection loop around the 8-point solve, with
per-octave sigma^2 weighting (:56-62). The reference's drop-the-single-worst
strategy breaks under high-leverage outliers (squared loss lets them own the
fit), so this build initializes with a batched RANSAC over minimal 8-point
fits (one vmapped computation — st7/st12 machinery) and polishes with
Cauchy-weighted IRLS; the final classification is exactly the chi-square gate.
"""

import jax
import jax.numpy as jnp

from slam_tricks_tpu.initialization.eightpoint import essential_8pt, fundamental_8pt
from slam_tricks_tpu.residuals.epipolar import sampson

# chi-square(2 dof) 95% quantile — the reference gates at 1.323*sigma^2-scaled
# quantiles per octave (epipolar.hpp:176); 5.991 is the standard 2-dof 95% gate
CHI2_2DOF_95 = 5.991


def robust_fundamental(p1, p2, *, sigma2=1.0, n_rounds=6, n_hyps=256,
                       chi2_thresh=CHI2_2DOF_95, essential=False, key=None):
    """p1/p2 (N,2) correspondences (pixels for F, normalized plane for E).
    sigma2: scalar or (N,) measurement variances. Returns
    (F_or_E (3,3), inlier_mask (N,) bool, chi2 (N,))."""
    n = p1.shape[0]
    dtype = p1.dtype
    sigma2 = jnp.broadcast_to(jnp.asarray(sigma2, dtype), (n,))
    solve = essential_8pt if essential else fundamental_8pt
    if key is None:
        key = jax.random.PRNGKey(0)

    def chi2_of(F):
        return jax.vmap(lambda a, b: sampson(F, a, b))(p1, p2) / sigma2

    # --- stage 1: batched minimal-fit hypotheses, best by inlier count ---
    def one_hyp(k):
        idx = jax.random.choice(k, n, shape=(8,), replace=False)
        w = jnp.zeros(n, dtype).at[idx].set(1.0)
        F = solve(p1, p2, w)
        c2 = chi2_of(F)
        score = jnp.where(jnp.all(jnp.isfinite(F)),
                          jnp.sum(c2 < chi2_thresh), -1)
        return F, score

    Fs, scores = jax.vmap(one_hyp)(jax.random.split(key, n_hyps))
    F = Fs[jnp.argmax(scores)]

    # --- stage 2: Cauchy-IRLS polish (median-scaled) ---
    def round_(F, _):
        c2 = chi2_of(F)
        scale = jnp.maximum(jnp.median(c2), chi2_thresh)
        w = (1.0 / (1.0 + c2 / scale)).astype(dtype)
        return solve(p1, p2, w), None

    F, _ = jax.lax.scan(round_, F, None, length=n_rounds)

    # --- stage 3: hard chi-square gate + final gated refit ---
    c2 = chi2_of(F)
    w = (c2 < chi2_thresh).astype(dtype)
    enough = jnp.sum(w) >= 8
    w = jnp.where(enough, w, jnp.ones_like(w))
    F = solve(p1, p2, w)
    chi2 = chi2_of(F)
    return F, chi2 < chi2_thresh, chi2

"""Vmapped RANSAC: all hypotheses evaluated as one batched computation.

Reference semantics: vanilla RANSAC (st7-ransac/src/include/parabola.hpp:132-153)
and the generic template framework with mean-shift refinement
(st12-ransaplus/src/include/ransac.hpp:18-247 — sample -> fit -> inlier gate ->
refit -> keep best). Accelerator-first re-design: the hypothesis loop IS a vmap —
`n_hyps` minimal fits + residual evaluations run as one batched kernel; the
best hypothesis is an argmax reduce; the final refit uses the inlier mask as
weights (static shapes throughout — no dynamic compaction).
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    params: jnp.ndarray      # best model (after weighted refit)
    inlier_mask: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray
    best_hypothesis: jnp.ndarray  # raw best minimal-fit params


def ransac(key, data, *, min_fit: Callable, residual_sq: Callable,
           refit: Callable, subset_size: int, n_hyps: int = 256,
           inlier_thresh_sq: float = 1e-2, sample_weights=None):
    """Generic vmapped RANSAC.

    data: pytree whose leaves have leading axis N (the samples).
    min_fit(subset_data) -> params from a minimal subset (vmappable).
    residual_sq(params, data) -> (N,) squared residuals for all samples.
    refit(data, weights) -> params — weighted least-squares refit on inliers.
    sample_weights: optional (N,) sampling probabilities (zero excludes a row
    from minimal subsets — used when the candidate set carries invalid slots).
    """
    n = jax.tree_util.tree_leaves(data)[0].shape[0]
    # sampling w/o replacement per hypothesis (parabola.hpp:62-94): use
    # jax.random.choice per hypothesis via vmap over keys
    keys = jax.random.split(key, n_hyps)
    if sample_weights is not None:
        p_sample = sample_weights / jnp.maximum(jnp.sum(sample_weights), 1e-12)
    else:
        p_sample = None

    def one_hyp(k):
        idx = jax.random.choice(k, n, shape=(subset_size,), replace=False,
                                p=p_sample)
        subset = jax.tree_util.tree_map(lambda a: a[idx], data)
        params = min_fit(subset)
        r2 = residual_sq(params, data)
        inliers = r2 < inlier_thresh_sq
        # guard degenerate fits
        score = jnp.where(jnp.all(jnp.isfinite(params)), jnp.sum(inliers), -1)
        return params, score

    params_all, scores = jax.vmap(one_hyp)(keys)
    best = jnp.argmax(scores)
    best_params = jax.tree_util.tree_map(lambda a: a[best], params_all)
    mask = residual_sq(best_params, data) < inlier_thresh_sq
    refined = refit(data, mask.astype(jax.tree_util.tree_leaves(data)[0].dtype))
    # final inlier set under the refined model
    final_mask = residual_sq(refined, data) < inlier_thresh_sq
    return RansacResult(params=refined, inlier_mask=final_mask,
                        n_inliers=jnp.sum(final_mask), best_hypothesis=best_params)


def ransac_iterative_refit(key, data, *, min_fit, residual_sq, refit,
                           subset_size, n_hyps=256, inlier_thresh_sq=1e-2,
                           n_refine=5):
    """RANSAC + fixed-count iterate-refit-until-stable — the `solveWithMeanShift`
    strategy of the reference (st12 ransac.hpp:37-94) with a static loop."""
    res = ransac(key, data, min_fit=min_fit, residual_sq=residual_sq,
                 refit=refit, subset_size=subset_size, n_hyps=n_hyps,
                 inlier_thresh_sq=inlier_thresh_sq)

    def body(_, carry):
        params, _ = carry
        mask = residual_sq(params, data) < inlier_thresh_sq
        dtype = jax.tree_util.tree_leaves(data)[0].dtype
        params2 = refit(data, mask.astype(dtype))
        return params2, mask

    params, mask = jax.lax.fori_loop(0, n_refine, body, (res.params, res.inlier_mask))
    return RansacResult(params=params, inlier_mask=mask,
                        n_inliers=jnp.sum(mask), best_hypothesis=res.best_hypothesis)

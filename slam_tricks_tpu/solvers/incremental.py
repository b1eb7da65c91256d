"""Incremental trajectory smoothing on the banded BA layout — the
iSAM/online-smoother role (reference: theory notes only, the marginalization
discussion of st0-core/docs/notes.tex:66-74; g2o's online mode is the
classical CPU counterpart).

Streaming design:

  1. STATIC SHAPES: the full-horizon `BandedWork` is built ONCE; cameras
     "arrive" by flipping per-slot weights on (`active_weight`, a traced
     scalar compare — no reshapes, no recompilation as the trajectory
     grows within the horizon).
  2. STORED-FACTOR REUSE: the reduced camera system's super-block
     tridiagonal factor is extended, not recomputed — the sequential
     block-Cholesky scan (the solve's LATENCY chain, O(G) dependent
     Cholesky steps) runs only over the O(dC/Kb + 1) tail super-blocks
     that new arrivals can touch (`block_tridiag_factor_extend`).
  3. ANCHORED PREFIX: state updates are RESTRICTED to the affected tail
     (cameras >= arrival_head - K and landmarks rooted there), so prefix
     band blocks are BIT-IDENTICAL across arrivals (the chunked camera
     accumulation never reorders prefix contributions) and the stored
     prefix factor stays exact — the same fluid-relinearization contract
     iSAM uses between batch relinearization sweeps.

A full `solve_ba_banded` call from the streamed state is the periodic
batch relinearization; tests/test_incremental.py checks the extended
factor is exact vs a from-scratch factorization, that the reuse stream
equals a refactor-every-arrival stream, and that the streamed estimate
rebatches to (measured: beats) the batch optimum.

At the C=1024 banded scale (G=86 super-blocks of m=72) an arrival extends
the factor over a 4-super-block tail instead of refactoring all 86.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.manifolds import se3, so3
from slam_tricks_tpu.solvers.banded_flat import (
    BandedWork, TridiagFactor, _assemble_bands, _banded_quantities,
    _cam_accum, _cam_broadcast, _group_superblocks, _mat3vec_flat,
    block_tridiag_factor, block_tridiag_factor_extend, tridiag_backward,
    tridiag_forward)


def slot_c0(bw: BandedWork):
    """(Lpad,) first camera of each slot column (derived on device from the
    chunk one-hot; chunks are c0-homogeneous by construction)."""
    LB, C = bw.onehot.shape
    Lpad = bw.weight.shape[1]
    chunk = Lpad // LB
    c0 = bw.onehot @ jnp.arange(C, dtype=bw.onehot.dtype)     # (LB,)
    return jnp.broadcast_to(c0[:, None], (LB, chunk)).reshape(Lpad)


def active_weight(bw: BandedWork, n_active):
    """Streaming arrival mask: observation slot (k, l) is live iff its
    camera c0[l] + k < n_active. n_active is a TRACED scalar — one
    compiled program serves every arrival within the horizon."""
    K, Lpad = bw.weight.shape
    cam_of_slot = slot_c0(bw)[None, :] + jnp.arange(
        K, dtype=bw.weight.dtype)[:, None]
    return bw.weight * (cam_of_slot < n_active).astype(bw.weight.dtype)


class IncrementalState(NamedTuple):
    poses: se3.SE3           # (C,) current estimates (tail) / anchors (prefix)
    points_s: jnp.ndarray    # (Lpad, 3) landmark estimates, SLOT order
    fac: TridiagFactor       # stored factor matching the current system
    cost: jnp.ndarray


def gn_step_stored(poses, points_s, bw: BandedWork, C, *, lam, fixed_mask,
                   n_active=None, fac_prev=None, c_changed=0, loss=None):
    """One damped Gauss-Newton step on the (optionally arrival-masked)
    banded problem, solved through the STORED super-block factor.

    fac_prev/c_changed: reuse the prefix of a stored factor, re-factoring
    only super-blocks reachable from changes (state moves or newly active
    observations) at cameras >= c_changed. c_changed must be a static
    python int (it sets the scan length). fac_prev=None factors from
    scratch. Returns (dp (C,6), dl (Lpad,3), fac, cost)."""
    dtype = points_s.dtype
    K = bw.weight.shape[0]
    Lpad = bw.weight.shape[1]
    chunk = Lpad // bw.onehot.shape[0]
    bw_eff = bw if n_active is None else bw._replace(
        weight=active_weight(bw, n_active))

    Hpp, gp, Hll, gl, W, cost = _banded_quantities(
        poses, points_s, bw_eff, C, loss=loss)
    bands, hinv, dpp, dll, free_ = _assemble_bands(
        Hpp, Hll, W, lam, fixed_mask, bw_eff, C)

    # rhs: b = -(gp - W Hll^-1 gl)
    u = _mat3vec_flat(hinv, [gl[0], gl[1], gl[2]])
    y = jnp.zeros((C, 6), dtype)
    for k in range(K):
        cols = [sum(W[k, i * 3 + j] * u[j] for j in range(3))
                for i in range(6)]
        y = y + _cam_accum(cols, k, bw_eff.onehot, chunk)
    b = -(gp - y) * free_[:, None]

    Dm, Em, G, Kb, Cp = _group_superblocks(bands, C, K, dtype)
    m = 6 * Kb
    Em = Em if Em is not None else jnp.zeros((0, m, m), dtype)
    if fac_prev is None:
        fac = block_tridiag_factor(Dm, Em)
    else:
        # changes at cameras >= c_changed touch landmarks rooted at
        # c0 >= c_changed - K + 1, whose band contributions stay at
        # cameras >= c_changed - K + 1: super-blocks < g0 are unchanged
        g0 = max(0, (int(c_changed) - K) // Kb)
        fac = block_tridiag_factor_extend(fac_prev, Dm, Em, g0)

    if Cp > C:
        b = jnp.concatenate([b, jnp.zeros((Cp - C, 6), dtype)], axis=0)
    dp = tridiag_backward(fac, tridiag_forward(fac, b.reshape(G, m)))
    dp = dp.reshape(Cp, 6)[:C]

    # landmark back-substitution (same columns as banded_flat._solve_banded)
    t = [jnp.zeros(Lpad, dtype) for _ in range(3)]
    for k in range(K):
        dpk = _cam_broadcast(dp * free_[:, None], k, bw_eff.onehot)
        bcast = lambda col: jnp.broadcast_to(
            col[:, None], (bw_eff.onehot.shape[0], chunk)).reshape(Lpad)
        dcols = [bcast(dpk[:, i]) for i in range(6)]
        for j in range(3):
            t[j] = t[j] + sum(W[k, i * 3 + j] * dcols[i] for i in range(6))
    rhs = [-gl[j] - t[j] for j in range(3)]
    dl = jnp.stack(_mat3vec_flat(hinv, rhs), axis=1)          # (Lpad, 3)
    return dp, dl, fac, cost


def _apply_tail(poses, points_s, dp, dl, bw, c_update, n_active):
    """Retract the step ONLY on the affected tail: cameras in
    [c_update, n_active) and landmarks rooted at c0 >= c_update. Prefix
    states stay at their anchors, keeping the stored prefix factor exact."""
    C = poses.t.shape[0]
    cam_live = ((jnp.arange(C) >= c_update)
                & (jnp.arange(C) < n_active)).astype(dp.dtype)
    dp_m = dp * cam_live[:, None]
    poses_new = jax.vmap(lambda T, d: se3.SE3(
        so3.retract(T.R, d[:3]), T.t + d[3:]))(poses, dp_m)
    lm_live = (slot_c0(bw) >= c_update).astype(dl.dtype)
    return poses_new, points_s + dl * lm_live[:, None]


def _masked_cost(poses, points_s, bw_eff, C, loss=None):
    return _banded_quantities(poses, points_s, bw_eff, C, loss=loss)[5]


def smoother_init(poses0, points0, bw: BandedWork, *, lam=1e-4,
                  fixed_mask=None, n_active=None, lm_iters=20, loss=None):
    """Batch-initialize the smoother: a full LM solve (trust-region
    controlled — robust to arbitrary inits) of the first n_active
    cameras' subproblem, then one stored factorization at the converged
    linearization. Returns (state, c_dirty): c_dirty is the lowest camera
    whose linearization changed AFTER the stored factor was computed
    (C here — nothing moved, so the very first arrival is already
    incremental)."""
    from slam_tricks_tpu.solvers.banded_flat import solve_ba_banded

    C = poses0.t.shape[0]
    if fixed_mask is None:
        fixed_mask = jnp.zeros(C, bool).at[0].set(True)
    bw_eff = bw if n_active is None else bw._replace(
        weight=active_weight(bw, n_active))
    out = solve_ba_banded(poses0, points0, bw_eff, fixed_mask=fixed_mask,
                          max_iters=lm_iters, lambda_init=lam, loss=loss)
    points_s = out.points[bw.gather_idx]
    _, _, fac, cost = gn_step_stored(
        out.poses, points_s, bw, C, lam=lam, fixed_mask=fixed_mask,
        n_active=n_active, loss=loss)
    return IncrementalState(poses=out.poses, points_s=points_s, fac=fac,
                            cost=cost), C


def smoother_arrive(state: IncrementalState, bw: BandedWork, *, a_prev,
                    a_new, c_dirty, lam=1e-4, fixed_mask=None, gn_steps=2,
                    loss=None):
    """Advance the stream from a_prev to a_new active cameras: take
    gn_steps tail-restricted GN steps, extending the stored factor over
    only the tail super-blocks instead of refactoring all of them.

    c_dirty: the value returned by the previous smoother_init /
    smoother_arrive call — the lowest camera whose linearization moved
    after the stored factor was computed. a_prev/a_new/c_dirty must be
    static python ints (they set scan lengths). Returns
    (state, c_dirty_new)."""
    K = bw.weight.shape[0]
    C = state.poses.t.shape[0]
    if fixed_mask is None:
        fixed_mask = jnp.zeros(C, bool).at[0].set(True)
    poses, points_s, fac = state.poses, state.points_s, state.fac
    # changes since the stored factor: states moved at >= c_dirty (the
    # previous update head) plus observations newly active at cameras
    # >= a_prev - K + 1 (tracks rooted in the previous arrival's band)
    c_update = max(0, a_prev - K)
    c_changed = min(int(c_dirty), c_update)
    bw_eff = bw._replace(weight=active_weight(bw, a_new))
    cost = state.cost
    for _ in range(max(gn_steps, 1)):
        dp, dl, fac, cost = gn_step_stored(
            poses, points_s, bw, C, lam=lam, fixed_mask=fixed_mask,
            n_active=a_new, fac_prev=fac, c_changed=c_changed, loss=loss)
        # cost-monotone step-size backtracking: the applied step is the
        # TAIL restriction of the full-Newton step (the prefix's share of
        # the update is left unapplied, iSAM-style), which is not
        # guaranteed descent at full length — scaling the step by alpha
        # keeps lam (and so every prefix band block) untouched, so the
        # stored-prefix contract survives where an LM lam-retry would not.
        best = (cost, jnp.zeros((), dp.dtype))
        for alpha in (1.0, 0.5, 0.25, 0.125):
            p_try, s_try = _apply_tail(poses, points_s, alpha * dp,
                                       alpha * dl, bw, c_update, a_new)
            c_try = _masked_cost(p_try, s_try, bw_eff, C, loss=loss)
            better = c_try < best[0]
            best = (jnp.where(better, c_try, best[0]),
                    jnp.where(better, alpha, best[1]))
        poses, points_s = _apply_tail(poses, points_s, best[1] * dp,
                                      best[1] * dl, bw, c_update, a_new)
        cost = best[0]           # cost at the applied state
        c_changed = c_update     # later steps: only the tail moved
    return IncrementalState(poses=poses, points_s=points_s, fac=fac,
                            cost=cost), c_update


def scatter_points(points_s, bw: BandedWork, n_points):
    """Slot-order landmark estimates back to global order (L, 3)."""
    return jnp.zeros((n_points + 1, 3), points_s.dtype).at[
        bw.scatter_idx].set(points_s)[:n_points]

"""Flat-layout Schur-complement BA — the single-device flat path.

Mathematically IDENTICAL to solvers/schur.solve_ba (same damping, same gauge
handling, same Nielsen gain-ratio control — parity-tested), re-laid-out so
that no per-observation array carries tiny trailing dims ((N,2,6), (N,6,6),
(N,3,3), ...), which device memory tiles pad many times over.

Design rules here (the whole module follows them):
  1. Per-observation data is (N, k) with block dims FLATTENED (k = 2, 6, 12,
     18, 21, ...) and the small-matrix algebra unrolled into column arithmetic
     (plain elementwise ops, no (2,6)-shaped tiles).
  2. No scatters anywhere. Per-camera reductions are ONE one-hot matmul (C
     is small); per-landmark reductions are track-table gathers + masked
     sums.
  3. The off-diagonal Schur mass is one (C*6, L*3) x (L*3, C*6) matmul of
     the whitened track matrix B, built by a batched per-landmark one-hot
     contraction (gathers + dot_general only).

Replaces the role of Ceres SPARSE_SCHUR / g2o BlockSolver<6,3>+CSparse with
marginalized landmarks (st20-g2o/src/include/test_ceres.h:143-145,
test_g2o.h:94-135); the per-observation Jacobian columns are the hand
derivation of st17-ceres/src/include/solver.hpp:176-199 / st20 test_ceres.h
unrolled to flat arrays.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.manifolds import se3, so3
from slam_tricks_tpu.solvers.common import HIGHEST
from slam_tricks_tpu.solvers.schur import BAState, TrackTable, lm_accept

# symmetric (i<=j) index pairs for flat 6x6 / 3x3 blocks
_IJ6 = [(i, j) for i in range(6) for j in range(i, 6)]     # 21 entries
_IJ3 = [(i, j) for i in range(3) for j in range(i, 3)]     # 6 entries


def _sym6_expand(flat):
    """(..., 21) upper-tri columns -> (..., 6, 6) symmetric."""
    idx = np.zeros((6, 6), np.int32)
    for k, (i, j) in enumerate(_IJ6):
        idx[i, j] = k
        idx[j, i] = k
    return flat[..., idx.reshape(-1)].reshape(flat.shape[:-1] + (6, 6))


def _dot2(a0, a1, b0, b1):
    return a0 * b0 + a1 * b1


def _linearize_flat(R_flat, t, points, cam_idx, lm_idx, uv, weight,
                    loss=None):
    """Per-observation residual + Jacobian COLUMNS, all (N,) arrays.

    Returns flat arrays:
      r (2 cols), jp (list of 12: rows [0,:],[1,:] of the (2,6) pose
      Jacobian), jl (list of 6: rows of the (2,3) point Jacobian) — all
      pre-weighted — plus the per-observation cost column.
    Tangent ordering [omega, dt] (g2o VertexCamera oplus, test_g2o.h:36-39).

    loss: optional residuals.robust.Loss. The IRLS weight rho'(||d||^2) is
    folded into sqrt-weight `sw` (one extra multiply — VERDICT r2 item 6) and
    the cost column becomes 0.5*w*rho(||d||^2), so the fused trial-cost trick
    of solve_ba_flat keeps working (the Ceres LossFunction role, same scheme
    as schur.solve_ba: weights evaluated at the linearization point).
    """
    Rn = R_flat[cam_idx]                      # (N,9) rows r00..r22
    tn = t[cam_idx]                           # (N,3)
    pn = points[lm_idx]                       # (N,3)
    px, py, pz = pn[:, 0], pn[:, 1], pn[:, 2]
    r_ = [Rn[:, k] for k in range(9)]
    x = r_[0] * px + r_[1] * py + r_[2] * pz + tn[:, 0]
    y = r_[3] * px + r_[4] * py + r_[5] * pz + tn[:, 1]
    z = r_[6] * px + r_[7] * py + r_[8] * pz + tn[:, 2]
    # weight-0 padding rows can hit arbitrary camera/point pairs; keep them
    # finite so 0 * inf never makes a NaN
    z = jnp.where(weight > 0, z, 1.0)
    iz = 1.0 / z
    u = x * iz
    v = y * iz
    d0 = u - uv[:, 0]
    d1 = v - uv[:, 1]
    if loss is None:
        sw = jnp.sqrt(weight)
        cost_col = 0.5 * weight * (d0 * d0 + d1 * d1)
    else:
        sqn = d0 * d0 + d1 * d1
        sw = jnp.sqrt(weight * loss.weight(sqn))
        cost_col = 0.5 * weight * loss.rho(sqn)
    r0 = d0 * sw
    r1 = d1 * sw

    # J_point = head @ R, rows: jl[row][j] = iz*(R[row,j] - {u,v}*R[2,j])
    sziz = sw * iz
    jl0 = [(r_[j] - u * r_[6 + j]) * sziz for j in range(3)]
    jl1 = [(r_[3 + j] - v * r_[6 + j]) * sziz for j in range(3)]
    # J_omega = -J_point @ hat(p):  col0 = -(jl1*pz - jl2*py), etc.
    jo0 = [jl0[2] * py - jl0[1] * pz,
           jl0[0] * pz - jl0[2] * px,
           jl0[1] * px - jl0[0] * py]
    jo1 = [jl1[2] * py - jl1[1] * pz,
           jl1[0] * pz - jl1[2] * px,
           jl1[1] * px - jl1[0] * py]
    # J_dt = head (weighted): row0 = [iz,0,-u*iz]*sw, row1 = [0,iz,-v*iz]*sw
    zero = jnp.zeros_like(x)
    jt0 = [sziz, zero, -u * sziz]
    jt1 = [zero, sziz, -v * sziz]
    jp0 = jo0 + jt0   # row 0 of (2,6)
    jp1 = jo1 + jt1   # row 1
    return (r0, r1), (jp0, jp1), (jl0, jl1), cost_col


def _cost_flat(R_flat, t, points, cam_idx, lm_idx, uv, weight):
    Rn = R_flat[cam_idx]
    tn = t[cam_idx]
    pn = points[lm_idx]
    px, py, pz = pn[:, 0], pn[:, 1], pn[:, 2]
    x = Rn[:, 0] * px + Rn[:, 1] * py + Rn[:, 2] * pz + tn[:, 0]
    y = Rn[:, 3] * px + Rn[:, 4] * py + Rn[:, 5] * pz + tn[:, 1]
    z = Rn[:, 6] * px + Rn[:, 7] * py + Rn[:, 8] * pz + tn[:, 2]
    iz = 1.0 / z
    d0 = x * iz - uv[:, 0]
    d1 = y * iz - uv[:, 1]
    return 0.5 * jnp.sum(weight * (d0 * d0 + d1 * d1))


def _inv3x3_flat(h):
    """Closed-form inverse of symmetric 3x3 given 6 upper-tri columns
    [h00,h01,h02,h11,h12,h22] -> 6 columns of the (symmetric) inverse."""
    a, b, c, d, e, f = h  # [[a,b,c],[b,d,e],[c,e,f]]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    idet = 1.0 / det
    return [A * idet, B * idet, C * idet, D * idet, E * idet, F * idet]


def _chol3_flat(h):
    """Lower Cholesky of symmetric 3x3 from 6 upper-tri columns ->
    [l00, l10, l11, l20, l21, l22]."""
    a, b, c, d, e, f = h
    l00 = jnp.sqrt(a)
    inv00 = 1.0 / l00
    l10 = b * inv00
    l20 = c * inv00
    l11 = jnp.sqrt(d - l10 * l10)
    inv11 = 1.0 / l11
    l21 = (e - l20 * l10) * inv11
    l22 = jnp.sqrt(f - l20 * l20 - l21 * l21)
    return [l00, l10, l11, l20, l21, l22]


def _mat3vec_flat(m6, v):
    """Symmetric-3x3 (6 cols) times (...,3) columns -> 3 columns."""
    a, b, c, d, e, f = m6
    v0, v1, v2 = v
    return [a * v0 + b * v1 + c * v2,
            b * v0 + d * v1 + e * v2,
            c * v0 + e * v1 + f * v2]


class FlatWork(NamedTuple):
    """Static per-problem index structure for the flat solver."""
    table: TrackTable          # (L, K) track table; None in GRID mode
    cam_of_track: jnp.ndarray  # (L, K) int32 camera of each track slot
    oh_c: jnp.ndarray          # (N, C) one-hot of cam_idx, or None (large C)
    cam_table: jnp.ndarray     # (C, Kc) int32 obs per camera, or None
    cam_mask: jnp.ndarray      # (C, Kc), or None
    mask_lk: jnp.ndarray       # (L, K) GRID mode: obs stored in track-grid
                               # order (row l*K+k = slot k of landmark l), so
                               # every (L,K,.) "gather" is a pure reshape;
                               # None otherwise. Built by grid_order_obs +
                               # build_flat_work(grid=True).


def build_flat_work(obs, n_cams, n_points, dtype=np.float32,
                    use_cam_table=None, grid=False):
    """Host-side: track table + per-slot camera index + the camera-side
    reduction structure. Small C uses a dense (N, C) one-hot (ONE matmul
    per reduction); large C switches to a (C, Kc) camera gather table — the
    one-hot would be O(N*C) memory (6.5 GB at N=1.6M, C=1024).
    use_cam_table=None -> auto (C > 128).

    grid=True: `obs` must come from grid_order_obs — row l*K+k is slot k of
    landmark l, so the landmark-side reductions and the whitening become
    reshapes instead of 100k-row gathers."""
    from slam_tricks_tpu.solvers.schur import build_track_table

    table = build_track_table(obs.cam_idx, obs.lm_idx, obs.weight,
                              n_points=n_points, dtype=dtype)
    cam_np = np.asarray(obs.cam_idx)
    cam_of_track = jnp.asarray(cam_np[np.asarray(table.obs_idx)])
    mask_lk = None
    if grid:
        K = table.obs_idx.shape[1]
        expect = np.arange(n_points * K, dtype=np.int64).reshape(n_points, K)
        tmask = np.asarray(table.mask) > 0
        if not np.array_equal(np.asarray(table.obs_idx)[tmask],
                              expect[tmask]):
            raise ValueError("grid=True requires grid_order_obs layout")
        mask_lk = table.mask
        cam_of_track = jnp.asarray(cam_np.reshape(n_points, K))
        table = None
    if use_cam_table is None:
        use_cam_table = n_cams > 128
    if use_cam_table:
        w = np.asarray(obs.weight)
        valid = np.flatnonzero(w > 0)
        order = valid[np.argsort(cam_np[valid], kind="stable")]
        counts = np.bincount(cam_np[order], minlength=n_cams)
        Kc = int(counts.max()) if counts.size else 1
        Kc = Kc + (-Kc) % 8
        cam_table = np.zeros((n_cams, Kc), np.int32)
        cam_mask = np.zeros((n_cams, Kc), dtype)
        starts = np.zeros(n_cams + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(order.shape[0]) - starts[cam_np[order]]
        cam_table[cam_np[order], slot] = order
        cam_mask[cam_np[order], slot] = 1
        return FlatWork(table=table, cam_of_track=cam_of_track, oh_c=None,
                        cam_table=jnp.asarray(cam_table),
                        cam_mask=jnp.asarray(cam_mask), mask_lk=mask_lk)
    oh = (cam_np[:, None] == np.arange(n_cams)[None, :]).astype(dtype)
    # padding rows (weight 0) contribute zero to every reduction because all
    # per-obs quantities are pre-weighted by sqrt(weight) = 0
    return FlatWork(table=table, cam_of_track=cam_of_track,
                    oh_c=jnp.asarray(oh), cam_table=None, cam_mask=None,
                    mask_lk=mask_lk)


def _iteration_quantities(poses, points, obs, work, n_cams, n_points,
                          loss=None, psum_axis=None):
    """Linearize + assemble, flat. Returns everything the LM step needs.

    psum_axis: when running inside shard_map with observations partitioned by
    landmark locality (parallel/pcg_dist.py), the camera-side reduction is a
    per-device partial — psum it (O(C*28) bytes) so Hpp/gp/cost come out
    replicated while the landmark-side blocks stay shard-local."""
    C, L = n_cams, n_points
    dtype = points.dtype
    cam_idx, lm_idx, uv, weight = obs.cam_idx, obs.lm_idx, obs.uv, obs.weight
    R_flat = poses.R.reshape(C, 9)

    (r0, r1), (jp0, jp1), (jl0, jl1), cost_col = _linearize_flat(
        R_flat, poses.t, points, cam_idx, lm_idx, uv, weight, loss=loss)

    # ---- camera-side reduction ----
    # columns: 21 upper-tri of Jp^T Jp, 6 of Jp^T r, 1 of the (possibly
    # robustified) per-obs cost
    cols = [_dot2(jp0[i], jp1[i], jp0[j], jp1[j]) for (i, j) in _IJ6]
    cols += [_dot2(jp0[i], jp1[i], r0, r1) for i in range(6)]
    cols += [cost_col]
    cam_stack = jnp.stack(cols, axis=1)                           # (N, 28)
    if work.oh_c is not None:
        # small C: ONE (C,N)x(N,28) matmul
        cam_red = jax.lax.dot_general(work.oh_c, cam_stack,
                                      (((0,), (0,)), ((), ())),
                                      precision=HIGHEST)          # (C, 28)
    else:
        # large C: camera-table gather + masked sum (O(N) memory)
        cam_red = jnp.sum(cam_stack[work.cam_table]
                          * work.cam_mask[..., None], axis=1)     # (C, 28)
    if psum_axis is not None:
        cam_red = jax.lax.psum(cam_red, psum_axis)
    Hpp_flat = cam_red[:, :21]
    gp = cam_red[:, 21:27]
    cost = jnp.sum(cam_red[:, 27])

    # ---- landmark-side reduction: track-table gather + masked sum ----
    # columns: 6 upper-tri of Jl^T Jl, 3 of Jl^T r, 18 of W = Jp^T Jl
    lcols = [_dot2(jl0[i], jl1[i], jl0[j], jl1[j]) for (i, j) in _IJ3]
    lcols += [_dot2(jl0[i], jl1[i], r0, r1) for i in range(3)]
    lm_stack = jnp.stack(lcols, axis=1)                           # (N, 9)
    if work.table is None:   # grid layout: the gather is a reshape
        K = work.mask_lk.shape[1]
        lm_t = lm_stack.reshape(L, K, 9)
        lm_red = jnp.sum(lm_t * work.mask_lk[..., None], axis=1)  # (L, 9)
    else:
        lm_t = lm_stack[work.table.obs_idx]                       # (L, K, 9)
        lm_red = jnp.sum(lm_t * work.table.mask[..., None], axis=1)
    Hll_flat = [lm_red[:, k] for k in range(6)]
    gl = lm_red[:, 6:9]                                           # (L, 3)

    # W columns (N, 18), row-major (6, 3)
    W_cols = [_dot2(jp0[i], jp1[i], jl0[j], jl1[j])
              for i in range(6) for j in range(3)]
    W = jnp.stack(W_cols, axis=1)                                 # (N, 18)
    return Hpp_flat, gp, Hll_flat, gl, W, cost


def _solve_flat(Hpp_flat, gp, Hll_flat, gl, W, lam, fixed_mask, work,
                n_cams, n_points, prior=None):
    """Damped Schur solve from flat blocks. Returns (dp (C,6), dl (L,3),
    diag terms for the gain ratio). The reduced camera system is factored
    with jax.scipy cho_factor/cho_solve.

    prior: optional (H (P,P), g (P,)) Gaussian prior on the tangent of the
    FIRST P//6 cameras (the sliding-window marginalization prior,
    solvers/sliding_window.py): H is added to the head of the reduced camera
    system and -g to its rhs — the cameras it covers must be free."""
    dtype = gp.dtype
    C, L = n_cams, n_points
    grid = work.table is None
    tmask = work.mask_lk if grid else work.table.mask
    K = tmask.shape[1]

    # damping on flat diagonals
    dpp = [jnp.maximum(Hpp_flat[:, k], 1e-12)
           for k, (i, j) in enumerate(_IJ6) if i == j]             # 6 x (C,)
    dll = [jnp.maximum(Hll_flat[k], 1e-12) for k, (i, j) in enumerate(_IJ3)
           if i == j]                                              # 3 x (L,)
    Hpp_d = _sym6_expand(Hpp_flat)
    diag_idx = jnp.arange(6)
    Hpp_d = Hpp_d.at[:, diag_idx, diag_idx].add(
        lam * jnp.stack(dpp, axis=1))
    # empty landmark blocks (zero trace) -> identity: the eps-damped zero
    # block's det underflows f32 and poisons the solve (see schur._damp_hll);
    # empty landmarks have zero W and gl so identity contributes nothing.
    empty = (Hll_flat[0] + Hll_flat[3] + Hll_flat[5]) <= 0.0
    Hll_d = [jnp.where(empty, 1.0 if k in (0, 3, 5) else 0.0,
                       Hll_flat[k] + (lam * dll[{0: 0, 3: 1, 5: 2}[k]]
                                      if k in (0, 3, 5) else 0.0))
             for k in range(6)]
    Hll_inv = _inv3x3_flat(Hll_d)                                  # 6 cols (L,)

    # whiten: X = Ld^{-1} W^T per obs -> (N, 18) row-major (3, 6)
    lc = _chol3_flat(Hll_d)                                        # 6 cols (L,)
    # every slot of track row l belongs to landmark l -> broadcast, no gather
    lcn = [c[:, None] for c in lc]                                 # (L,1) each
    # W in track layout: (L, K, 18) row-major (6, 3) — a reshape in grid
    # mode, a gather otherwise
    W_t = (W.reshape(L, K, 18) if grid else W[work.table.obs_idx]) \
        * tmask[..., None]
    # forward substitution per column j of W^T (3 rows): for each of 6 j's
    l00, l10, l11, l20, l21, l22 = lcn
    i00 = 1.0 / l00
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    Xr = []
    w_of = lambda i, j: W_t[..., i * 3 + j]
    x0 = [w_of(j, 0) * i00 for j in range(6)]
    x1 = [(w_of(j, 1) - l10 * x0[j]) * i11 for j in range(6)]
    x2 = [(w_of(j, 2) - l20 * x0[j] - l21 * x1[j]) * i22 for j in range(6)]
    # X rows: (L, K, 3, 6) -> per-track one-hot contraction to B (L,3,C,6)
    X_t = jnp.stack([jnp.stack(x0, axis=-1),
                     jnp.stack(x1, axis=-1),
                     jnp.stack(x2, axis=-1)], axis=2)              # (L,K,3,6)
    oh_ct = (jax.nn.one_hot(work.cam_of_track, C, dtype=dtype)
             * tmask[..., None])                                   # (L,K,C)
    B = jax.lax.dot_general(
        oh_ct, X_t.reshape(L, K, 18),
        (((1,), (1,)), ((0,), (0,))), precision=HIGHEST)           # (L,C,18)
    B = B.reshape(L, C, 3, 6).transpose(0, 2, 1, 3).reshape(L * 3, C * 6)
    S_off = -jax.lax.dot_general(B, B, (((0,), (0,)), ((), ())),
                                 precision=HIGHEST)                # (C6,C6)
    S = S_off.reshape(C, 6, C, 6)
    eye_c = jnp.eye(C, dtype=dtype)[:, None, :, None]
    S = S + eye_c * Hpp_d[:, :, None, :]

    # rhs: b = -(gp - W Hll^-1 gl), camera reduction via the one-hot matmul
    u = _mat3vec_flat(Hll_inv, [gl[:, 0], gl[:, 1], gl[:, 2]])     # 3 x (L,)
    # every slot of track row l belongs to landmark l -> broadcast, no gather
    ug = [c[:, None] * tmask for c in u]                           # (L,K) x3
    # y per track-slot: (L,K,6) then reduce per camera via one-hot track
    y_t = jnp.stack([W_t[..., i * 3 + 0] * ug[0]
                     + W_t[..., i * 3 + 1] * ug[1]
                     + W_t[..., i * 3 + 2] * ug[2] for i in range(6)],
                    axis=-1)                                       # (L,K,6)
    y_c = jax.lax.dot_general(
        oh_ct.reshape(L * K, C), y_t.reshape(L * K, 6),
        (((0,), (0,)), ((), ())), precision=HIGHEST)               # (C,6)
    b = -(gp - y_c)

    free = (~fixed_mask).astype(dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S + eye_c * (fixed_mask.astype(dtype)[:, None, None, None]
                     * jnp.eye(6, dtype=dtype)[None, :, None, :])
    b = b * free[:, None]
    if prior is not None:
        Hp, gpr = prior
        P = Hp.shape[0]
        S = S.reshape(C * 6, C * 6).at[:P, :P].add(Hp).reshape(C, 6, C, 6)
        b = b.reshape(-1).at[:P].add(-gpr).reshape(C, 6)
    cf = jax.scipy.linalg.cho_factor(S.reshape(C * 6, C * 6), lower=True)
    dp = jax.scipy.linalg.cho_solve(cf, b.reshape(C * 6)).reshape(C, 6)

    # back-substitution: dl = Hll^-1 (-gl - W^T dp) via track gathers
    dp_t = dp[work.cam_of_track]                                   # (L,K,6)
    t = [jnp.sum(sum(W_t[..., i * 3 + j] * dp_t[..., i]
                     for i in range(6)), axis=1) for j in range(3)]  # 3 x (L,)
    rhs = [-gl[:, j] - t[j] for j in range(3)]
    dl = jnp.stack(_mat3vec_flat(Hll_inv, rhs), axis=1)            # (L,3)

    diag_pp = jnp.stack(dpp, axis=1)                               # (C,6)
    diag_ll = jnp.stack(dll, axis=1)                               # (L,3)
    return dp, dl, diag_pp, diag_ll


def solve_ba_flat(poses0, points0, obs, work: FlatWork, *, fixed_mask=None,
                  max_iters=30, lambda_init=1e-4, xtol=1e-12,
                  linear="dense", pcg_work=None, cg_iters=100, cg_tol=1e-6,
                  loss=None, psum_axis=None):
    """LM bundle adjustment, flat layout. Same semantics/trajectory as
    schur.solve_ba(linear_solver='dense') — parity-tested. `work` comes from
    build_flat_work(obs, C, L) (host-built once; visibility is static).

    linear: "dense" materializes + Cholesky-factors the reduced camera system
    (exact; C up to ~hundreds); "pcg" runs the scatter-free block-tridiagonal
    PCG of solvers/pcg_flat.py (large C) — pass
    pcg_work=pcg_flat.build_pcg_work(obs, C).

    loss: optional residuals.robust.Loss — robustified BA via IRLS, same
    semantics as schur.solve_ba(loss=...) (parity-tested).

    psum_axis: run this EXACT solver inside shard_map as the distributed
    large-C path (parallel/pcg_dist.py): `obs`/`work`/`pcg_work`/`points0`
    are the device-local shard (landmark-locality partitioned), poses are
    replicated, and the camera-side reductions + scalar reductions are
    psummed over the named axis. Requires linear='pcg' (the dense path would
    need the O((3L)(6C)) B matrix psummed — exactly what this path avoids)."""
    n_cams = poses0.t.shape[0]
    n_points = points0.shape[0]
    dtype = points0.dtype
    C, L = n_cams, n_points
    if fixed_mask is None:
        fixed_mask = jnp.zeros(C, bool).at[0].set(True)
    if psum_axis is not None and linear != "pcg":
        raise ValueError("psum_axis requires linear='pcg'")

    def quantities(poses, points):
        """(Hpp_flat, gp, Hll_flat tuple, gl, W, cost) at the given point."""
        Hpp_flat, gp, Hll_flat, gl, W, cost = _iteration_quantities(
            poses, points, obs, work, C, L, loss=loss, psum_axis=psum_axis)
        return (Hpp_flat, gp, tuple(Hll_flat), gl, W), cost

    def lin_solve(blocks, lam):
        Hpp_flat, gp, Hll_flat, gl, W = blocks
        if linear == "pcg":
            from slam_tricks_tpu.solvers.pcg_flat import solve_rcs_pcg_flat
            return solve_rcs_pcg_flat(
                Hpp_flat, gp, list(Hll_flat), gl, W, obs.lm_idx, lam,
                fixed_mask, work, pcg_work, C, L, cg_iters=cg_iters,
                cg_tol=cg_tol, psum_axis=psum_axis)
        return _solve_flat(Hpp_flat, gp, list(Hll_flat), gl, W, lam,
                           fixed_mask, work, C, L)

    # the state carries the CURRENT point's blocks: each iteration linearizes
    # once (at the trial point — the evaluation doubles as the trial-cost
    # computation via the fused cost column) and reuses it on acceptance, so
    # there is no separate cost pass (measured ~1 ms/iter at bench scale).
    blocks0, cost0 = quantities(poses0, points0)
    state = (BAState(poses=poses0, points=points0, cost=cost0,
                     lam=jnp.asarray(lambda_init, dtype),
                     nu=jnp.asarray(2.0, dtype),
                     it=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool)),
             blocks0)

    def cond(sb):
        s, _ = sb
        return (~s.done) & (s.it < max_iters)

    def body(sb):
        s, blocks = sb
        Hpp_flat, gp, Hll_flat, gl, W = blocks
        dp, dl, diag_pp, diag_ll = lin_solve(blocks, s.lam)

        bad = jnp.any(~jnp.isfinite(dp)) | jnp.any(~jnp.isfinite(dl))
        if psum_axis is not None:
            # a device must not zero its (replicated) dp unless ALL agree —
            # otherwise the replicated pose state diverges across devices
            bad = jax.lax.psum(bad.astype(dtype), psum_axis) > 0
        dp_s = jnp.where(bad, jnp.zeros_like(dp), dp)
        dl_s = jnp.where(bad, jnp.zeros_like(dl), dl)
        poses_try = jax.vmap(lambda T, d: se3.SE3(
            so3.retract(T.R, d[:3]), T.t + d[3:]))(s.poses, dp_s)
        points_try = s.points + dl_s
        blocks_try, cost_try = quantities(poses_try, points_try)

        # pose terms are replicated under psum_axis; landmark terms are
        # shard-local partials (each landmark owned by exactly one device)
        pred_l = jnp.sum(dl_s * (s.lam * diag_ll * dl_s - gl))
        step_l = jnp.sum(dl_s * dl_s)
        if psum_axis is not None:
            pred_l, step_l = jax.lax.psum((pred_l, step_l), psum_axis)
        pred = 0.5 * (jnp.sum(dp_s * (s.lam * diag_pp * dp_s - gp)) + pred_l)
        accept, lam_new, nu_new = lm_accept(s.cost, cost_try, s.lam, s.nu,
                                            pred, bad)
        sel = lambda a, b: jnp.where(accept, a, b)
        step_sq = jnp.sum(dp_s * dp_s) + step_l
        new_state = BAState(
            poses=jax.tree_util.tree_map(sel, poses_try, s.poses),
            points=sel(points_try, s.points),
            cost=sel(cost_try, s.cost), lam=lam_new, nu=nu_new, it=s.it + 1,
            done=accept & (step_sq < xtol * xtol))
        new_blocks = jax.tree_util.tree_map(sel, blocks_try, blocks)
        return (new_state, new_blocks)

    final, _ = jax.lax.while_loop(cond, body, state)
    return final


solve_ba_flat_jit = jax.jit(partial(solve_ba_flat),
                            static_argnames=("max_iters",))


def grid_order_obs(obs, n_points, dtype=np.float32):
    """Host-side: reorder observations into TRACK-GRID order — row l*K+k is
    the k-th observation of landmark l (weight-0 padding in unused slots, the
    padding row's lm_idx is l itself so point gathers stay in-bounds).

    Pass the result to build_flat_work(..., grid=True): every (L, K, .)
    track "gather" in the solver then becomes a pure reshape of contiguous
    data. Cost: N grows to L*K (the bench cube-room scene: +38%); win: the
    ~100k-row track gathers (10-20 ns/row each) disappear."""
    from slam_tricks_tpu.solvers.schur import build_track_table

    table = build_track_table(obs.cam_idx, obs.lm_idx, obs.weight,
                              n_points=n_points, dtype=dtype)
    idx = np.asarray(table.obs_idx)              # (L, K)
    msk = np.asarray(table.mask) > 0
    L, K = idx.shape
    flat = idx.reshape(-1)
    mflat = msk.reshape(-1)

    cam = np.asarray(obs.cam_idx)[flat].astype(np.int32)
    lm = np.repeat(np.arange(L, dtype=np.int32), K)
    uv = np.asarray(obs.uv)[flat].astype(dtype)
    w = np.where(mflat, np.asarray(obs.weight)[flat], 0.0).astype(dtype)
    cam = np.where(mflat, cam, 0).astype(np.int32)
    return type(obs)(cam_idx=jnp.asarray(cam), lm_idx=jnp.asarray(lm),
                     uv=jnp.asarray(uv), weight=jnp.asarray(w))

"""Scatter-free flat-layout PCG on the Schur reduced camera system — the
large-C BA path (SURVEY §7 step 5 "PCG with block preconditioner for larger
pose counts", VERDICT r1 item 4).

At C ~ 1000+ the dense reduced system becomes the bottleneck, and the
original matrix-free path's matvecs were segment_sum (scatter) bound. Here
EVERY reduction is a static table gather + masked sum using index tables
built host-side from the visibility structure:

  - the landmark track table (L, K)  — obs of each landmark (schur.TrackTable,
    carried in schur_flat.FlatWork)
  - a camera table (C, Kc)           — obs of each camera
  - an adjacency table (C-1, Ka)     — within-track obs pairs on consecutive
    cameras, giving the EXACT first sub-diagonal blocks of S for the
    block-tridiagonal preconditioner (trajectory problems couple adjacent
    cameras most strongly; reference problem structure: st20 spiral,
    st20-g2o/src/src/sim_data.cpp:47-96)

The preconditioner factorization/application is the lax.scan block-bidiagonal
solve shared with solvers/pcg.py (make_tridiag_precond)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.solvers.common import HIGHEST
from slam_tricks_tpu.solvers.pcg import make_tridiag_precond, pcg
from slam_tricks_tpu.solvers.schur_flat import (_IJ3, _IJ6, FlatWork,
                                                _inv3x3_flat, _mat3vec_flat,
                                                _sym6_expand)

# symmetric 3x3 column index: _SYM33[m][j] = flat col of H[m, j]
_SYM33 = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]


class PCGWork(NamedTuple):
    """Static gather tables for the scatter-free PCG path (host-built once)."""
    cam_table: jnp.ndarray   # (C, Kc) int32 obs indices per camera
    cam_mask: jnp.ndarray    # (C, Kc)
    lm_of_cam: jnp.ndarray   # (C, Kc) int32
    adj_a: jnp.ndarray       # (C-1, Ka) int32 obs at camera c+1
    adj_b: jnp.ndarray       # (C-1, Ka) int32 obs at camera c (same landmark)
    adj_mask: jnp.ndarray    # (C-1, Ka)


def build_pcg_work(obs, n_cams, dtype=np.float32):
    """Host-side: camera table + consecutive-camera adjacency table."""
    cam_idx = np.asarray(obs.cam_idx)
    lm_idx = np.asarray(obs.lm_idx)
    w = np.asarray(obs.weight)
    C = n_cams
    valid = np.flatnonzero(w > 0)

    # camera table
    order = valid[np.argsort(cam_idx[valid], kind="stable")]
    counts = np.bincount(cam_idx[order], minlength=C)
    Kc = int(counts.max()) if counts.size else 1
    Kc = Kc + (-Kc) % 8
    cam_table = np.zeros((C, Kc), np.int32)
    cam_mask = np.zeros((C, Kc), dtype)
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    for c in range(C):
        s, e = starts[c], starts[c + 1]
        cam_table[c, :e - s] = order[s:e]
        cam_mask[c, :e - s] = 1

    # adjacency: per landmark track, obs pairs on cameras (c+1, c) —
    # vectorized: lexsort by (landmark, camera); consecutive sorted entries
    # with same landmark and camera gap 1 are exactly the sub-diagonal pairs
    order_l = valid[np.lexsort((cam_idx[valid], lm_idx[valid]))]
    lm_s = lm_idx[order_l]
    cam_s = cam_idx[order_l]
    is_adj = (lm_s[1:] == lm_s[:-1]) & (cam_s[1:] == cam_s[:-1] + 1)
    pa = order_l[1:][is_adj]          # obs at camera c+1
    pb = order_l[:-1][is_adj]         # obs at camera c
    cb = cam_s[:-1][is_adj]           # = c
    rows = max(C - 1, 1)
    counts = np.bincount(cb, minlength=rows)
    Ka = max(int(counts.max()) if counts.size else 1, 1)
    Ka = max(Ka + (-Ka) % 8, 8)
    adj_a = np.zeros((rows, Ka), np.int32)
    adj_b = np.zeros((rows, Ka), np.int32)
    adj_mask = np.zeros((rows, Ka), dtype)
    o2 = np.argsort(cb, kind="stable")
    starts = np.zeros(rows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(o2.shape[0]) - starts[cb[o2]]
    adj_a[cb[o2], slot] = pa[o2]
    adj_b[cb[o2], slot] = pb[o2]
    adj_mask[cb[o2], slot] = 1
    return PCGWork(cam_table=jnp.asarray(cam_table),
                   cam_mask=jnp.asarray(cam_mask),
                   lm_of_cam=jnp.asarray(lm_idx[cam_table]),
                   adj_a=jnp.asarray(adj_a), adj_b=jnp.asarray(adj_b),
                   adj_mask=jnp.asarray(adj_mask))


def _block_mul_sym3(Wg, hcols):
    """Y = W @ Hsym for flat blocks: Wg (..., 18) row-major (6,3), hcols list
    of 6 (...,) symmetric-3x3 columns (broadcastable). Returns (..., 18)."""
    outs = []
    for i in range(6):
        for j in range(3):
            outs.append(sum(Wg[..., i * 3 + m] * hcols[_SYM33[m][j]]
                            for m in range(3)))
    return jnp.stack(outs, axis=-1)


def _pair_product(Ya, Wb):
    """sum_k Y[a] W[b]^T over the table axis: Ya, Wb (G, K, 18) ->
    (G, 6, 6)."""
    rows = []
    for i in range(6):
        row = [sum(Ya[..., i * 3 + j] * Wb[..., i2 * 3 + j] for j in range(3)
                   ).sum(axis=1) for i2 in range(6)]
        rows.append(jnp.stack(row, axis=-1))
    return jnp.stack(rows, axis=-2)


def solve_rcs_pcg_flat(Hpp_flat, gp, Hll_flat, gl, W, lm_idx, lam, fixed_mask,
                       work: FlatWork, pcgw: PCGWork, n_cams, n_points, *,
                       cg_iters=100, cg_tol=1e-6, psum_axis=None):
    """Scatter-free PCG solve of the damped reduced camera system, plus
    landmark back-substitution. Flat inputs identical to
    schur_flat._solve_flat. Returns (dp, dl, diag_pp, diag_ll).

    psum_axis: when running inside shard_map with landmark-locality-sharded
    observations (parallel/pcg_dist.py), Hpp_flat/gp are replicated, the
    landmark-side inputs are device-local, and every camera-side reduction
    (rhs, the tridiagonal preconditioner blocks, and the PCG matvec) is a
    per-device partial that gets psummed — O(C*6) bytes per CG iteration
    plus O(C*36) once per linearization, independent of L and N."""
    dtype = gp.dtype
    C, L = n_cams, n_points

    # damping (identical to schur_flat._solve_flat)
    dpp = [jnp.maximum(Hpp_flat[:, k], 1e-12)
           for k, (i, j) in enumerate(_IJ6) if i == j]
    dll = [jnp.maximum(Hll_flat[k], 1e-12) for k, (i, j) in enumerate(_IJ3)
           if i == j]
    Hpp_d = _sym6_expand(Hpp_flat)
    diag_idx = jnp.arange(6)
    Hpp_d = Hpp_d.at[:, diag_idx, diag_idx].add(lam * jnp.stack(dpp, axis=1))
    empty = (Hll_flat[0] + Hll_flat[3] + Hll_flat[5]) <= 0.0
    Hll_d = [jnp.where(empty, 1.0 if k in (0, 3, 5) else 0.0,
                       Hll_flat[k] + (lam * dll[{0: 0, 3: 1, 5: 2}[k]]
                                      if k in (0, 3, 5) else 0.0))
             for k in range(6)]
    hinv = _inv3x3_flat(Hll_d)                                  # 6 cols (L,)

    free = (~fixed_mask).astype(dtype)
    freec = free[:, None]
    fixedc = fixed_mask.astype(dtype)[:, None]

    # gathered W layouts, built once per LM iteration, reused by all matvecs
    W_t = W[work.table.obs_idx] * work.table.mask[..., None]    # (L,K,18)
    cam_t = work.cam_of_track                                   # (L,K)
    W_c = W[pcgw.cam_table] * pcgw.cam_mask[..., None]          # (C,Kc,18)
    hinv_c = [c[pcgw.lm_of_cam] for c in hinv]                  # (C,Kc) x6

    def lm_reduce(x):
        """t (3 cols of (L,)) = sum over track slots of W^T x[cam]."""
        xc = x[cam_t]                                           # (L,K,6)
        return [sum(W_t[..., i * 3 + j] * xc[..., i]
                    for i in range(6)).sum(axis=1) for j in range(3)]

    def cam_reduce(ucols):
        """y (C,6) = sum over camera slots of W u[lm]."""
        ug = [c[pcgw.lm_of_cam] for c in ucols]                 # (C,Kc) x3
        return jnp.stack(
            [sum(W_c[..., i * 3 + j] * ug[j] for j in range(3)).sum(axis=1)
             for i in range(6)], axis=1)

    def _reduce(v):
        return v if psum_axis is None else jax.lax.psum(v, psum_axis)

    # rhs: b = -(gp - W Hll^-1 gl)
    u0 = _mat3vec_flat(hinv, [gl[:, 0], gl[:, 1], gl[:, 2]])
    b = -(gp - _reduce(cam_reduce(u0))) * freec

    def matvec(x):
        xf = x * freec
        t = lm_reduce(xf)
        u = _mat3vec_flat(hinv, t)
        y = _reduce(cam_reduce(u))
        Sx = jnp.einsum("cij,cj->ci", Hpp_d, xf, precision=HIGHEST) - y
        return Sx * freec + x * fixedc

    # exact block-tridiagonal preconditioner via gathers
    Y_c = _block_mul_sym3(W_c, hinv_c)                          # (C,Kc,18)
    D = Hpp_d - _reduce(_pair_product(Y_c, W_c))                # (C,6,6)
    hinv_obs = [c[lm_idx] for c in hinv]
    Y_obs = _block_mul_sym3(W, hinv_obs)                        # (N,18)
    Ya = Y_obs[pcgw.adj_a] * pcgw.adj_mask[..., None]           # (C-1,Ka,18)
    Wb = W[pcgw.adj_b]
    E = -_reduce(_pair_product(Ya, Wb))                         # (C-1,6,6)

    eye6 = jnp.eye(6, dtype=dtype)
    fixedf = 1.0 - free
    D = D * free[:, None, None] + eye6[None] * fixedf[:, None, None]
    E = E * free[1:, None, None] * free[:-1, None, None]
    # the tridiagonal TRUNCATION of SPD S need not be SPD itself; in f32 the
    # block factorization can hit negative pivots. A relative diagonal jitter
    # keeps it SPD — it's only a preconditioner, accuracy is unaffected.
    jitter = 100.0 * jnp.asarray(jnp.finfo(dtype).eps, dtype)
    dmean = jnp.mean(jnp.abs(jnp.diagonal(D, axis1=-2, axis2=-1)))
    D = D + eye6[None] * (jitter * dmean)
    precond = make_tridiag_precond(D, E)

    dp, _ = pcg(matvec, b, precond, iters=cg_iters, tol=cg_tol)

    # back-substitution: dl = Hll^-1 (-gl - W^T dp)
    t = lm_reduce(dp)
    rhs = [-gl[:, j] - t[j] for j in range(3)]
    dl = jnp.stack(_mat3vec_flat(hinv, rhs), axis=1)
    return dp, dl, jnp.stack(dpp, axis=1), jnp.stack(dll, axis=1)

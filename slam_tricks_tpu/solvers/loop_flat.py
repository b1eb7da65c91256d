"""Loop-closure large-C BA: slot-major banded factor + exact low-rank
Woodbury correction (round-4 extension of solvers/banded_flat beyond
consecutive-camera tracks).

The banded solver requires every landmark's track to span <= max_band
CONSECUTIVE cameras — pure odometry visibility. Real SLAM problems close
loops: a landmark seen at the start of the trajectory is re-observed when
the camera returns (reference problem shape: the st20 cube-room, where
walls recur across the whole spiral, st20-g2o/src/src/sim_data.cpp:119-172).
Such a track splits into RUNS of consecutive cameras, and eliminating the
landmark couples cameras in different runs — off-band entries the banded
factorization cannot represent. Round-3's fallback (gather-table PCG)
measured 4576 ms/LM-iter at C=1024, LOSING to the 2499 ms dense comparator.

This module solves the general case EXACTLY at banded cost + a low-rank
correction:

    S  =  Hpp_d - sum_l W_l Hll_l^-1 W_l^T            (true reduced system)
       =  S_sb  -  U U^T

  S_sb = Hpp_d - sum_{single-run l} (...)   is BANDED and SPD (it subtracts
         FEWER PSD terms than S, and S > 0), factor/solve via the existing
         super-block tridiagonal cyclic reduction;
  U    = [ W_l Hll_l^-T/2 ]_{l in LC}       column-stacked loop-closure
         factors, nonzero only on rows of A = the cameras appearing in any
         LC track. When 3*M > 6*|A| the factor is COMPRESSED through its
         camera support by an LQ decomposition (QR of U_A^T) — width
         min(3M, 6|A|), exact, and backward-stable IN FACTOR SPACE (the
         computed compression is the Gram of a nearby factor, which keeps
         the implicit S = S_sb - UU^T SPD in f32 even at kappa(S) > 1e7;
         a Gram+eigh route measured 3x-above-noise-floor stalls).

  S^-1 b = S_sb^-1 b + S_sb^-1 U (I - U^T S_sb^-1 U)^-1 U^T S_sb^-1 b

with ONE multi-RHS banded solve for [b | U] (the capacitance I - U^T S_sb^-1 U
is SPD whenever S is — standard Schur-complement fact). Everything stays
gather-free: LC camera state moves through (Mpad, pA) one-hot matmuls against
the |A|-row support table; no O(N) or O(L) gathers anywhere.

Cost per LM iteration ~ banded + O(C m^2 q) for q = min(3M, 6|A|) rhs
columns + O(q^3); at the bench loop scene (C=1024, 1543 LC landmarks,
|A| = 23 support cameras) q = 144.

Same LM semantics as schur_flat.solve_ba_flat / banded_flat.solve_ba_banded
(damping, gauge, Nielsen control — parity-tested vs schur.solve_ba).
Replaces Ceres SPARSE_SCHUR / g2o BlockSolver<6,3>+CSparse for loop-closure
visibility at scales the dense reduced system cannot reach
(st20-g2o/src/include/test_ceres.h:143-145, test_g2o.h:94-135).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.manifolds import se3, so3
from slam_tricks_tpu.solvers.common import HIGHEST
from slam_tricks_tpu.solvers.banded_flat import (
    BandedWork, _assemble_bands, _banded_quantities, _cam_accum,
    _cam_broadcast, _group_superblocks, _linearize_slot,
    block_tridiag_factor, build_banded_work, tridiag_backward,
    tridiag_forward)
from slam_tricks_tpu.solvers.schur import BAState, lm_accept
from slam_tricks_tpu.solvers.schur_flat import (_IJ3, _IJ6, _chol3_flat,
                                                _inv3x3_flat, _mat3vec_flat)

_SYM33 = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]


class LoopWork(NamedTuple):
    """Host-built structure: banded layout over single-run landmarks plus the
    loop-closure (multi-run) landmark slot grid on its camera support A."""
    banded: BandedWork        # single-run landmarks (scatter into original L)
    lc_uv: jnp.ndarray        # (Klc, 2, Mpad)
    lc_weight: jnp.ndarray    # (Klc, Mpad)
    lc_aslot: jnp.ndarray     # (Klc, Mpad) int32 — slot camera's index in A
    lc_lm: jnp.ndarray        # (Mpad,) original landmark id; == L for padding
    lc_gather: jnp.ndarray    # (Mpad,) clipped into [0, L)
    onehot_A: jnp.ndarray     # (pA, C) one-hot rows of support cameras
                              # (zero rows beyond the real support size)


def build_loop_work(obs, n_cams, n_points, dtype=np.float32, chunk=32,
                    max_band=32):
    """Split every landmark's track into consecutive-camera runs; single-run
    landmarks go to the banded slot-major layout, multi-run (loop-closure)
    landmarks to the support-indexed LC grid. Works for ANY visibility
    structure (every track splits into runs); efficiency degrades gracefully
    with the loop-closure support size |A| (q = min(3M, 6|A|) extra rhs
    columns through the banded factorization)."""
    cam = np.asarray(obs.cam_idx).astype(np.int64)
    lm = np.asarray(obs.lm_idx).astype(np.int64)
    uv = np.asarray(obs.uv)
    w = np.asarray(obs.weight)
    C, L = int(n_cams), int(n_points)
    valid = np.flatnonzero(w > 0)
    cam_v, lm_v = cam[valid], lm[valid]
    key = lm_v * C + cam_v
    if np.unique(key).shape[0] != key.shape[0]:
        raise ValueError("duplicate (landmark, camera) observation")

    # per-landmark camera span -> multi-run iff span >= max_band OR the
    # track wraps in a way a single band cannot hold
    c0 = np.full(L, C, np.int64)
    cmax = np.full(L, -1, np.int64)
    np.minimum.at(c0, lm_v, cam_v)
    np.maximum.at(cmax, lm_v, cam_v)
    observed = cmax >= 0
    span = np.where(observed, cmax - c0 + 1, 1)
    is_lc = observed & (span > max_band)

    sr_sel = valid[~is_lc[lm_v]]
    lc_sel = valid[is_lc[lm_v]]

    sr_obs = type(obs)(
        cam_idx=jnp.asarray(cam[sr_sel].astype(np.int32)),
        lm_idx=jnp.asarray(lm[sr_sel].astype(np.int32)),
        uv=jnp.asarray(uv[sr_sel].astype(dtype)),
        weight=jnp.asarray(w[sr_sel].astype(dtype)))
    banded = build_banded_work(sr_obs, C, L, dtype=dtype, chunk=chunk,
                               max_band=max_band)

    # ---- loop-closure grid ----
    lc_lms = np.flatnonzero(is_lc)
    M = lc_lms.size
    Mpad = max(M + (-M) % 8, 8)
    counts = np.bincount(lm[lc_sel], minlength=L)[lc_lms] if M else \
        np.zeros(0, np.int64)
    Klc = max(int(counts.max()) if M else 1, 1)

    A = np.unique(cam[lc_sel]) if M else np.zeros(0, np.int64)
    pA_real = A.size
    pA = max(pA_real + (-pA_real) % 8, 8)
    a_of_cam = np.zeros(C, np.int64)
    a_of_cam[A] = np.arange(pA_real)

    uvg = np.zeros((Klc, 2, Mpad), dtype)
    wg = np.zeros((Klc, Mpad), dtype)
    aslot = np.zeros((Klc, Mpad), np.int64)
    lc_of = np.full(L, Mpad, np.int64)
    lc_of[lc_lms] = np.arange(M)
    if M:
        order = lc_sel[np.lexsort((cam[lc_sel], lm[lc_sel]))]
        col = lc_of[lm[order]]
        starts = np.zeros(M + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(order.size) - starts[col]
        uvg[slot, 0, col] = uv[order, 0].astype(dtype)
        uvg[slot, 1, col] = uv[order, 1].astype(dtype)
        wg[slot, col] = w[order].astype(dtype)
        aslot[slot, col] = a_of_cam[cam[order]]

    onehot_A = np.zeros((pA, C), dtype)
    onehot_A[np.arange(pA_real), A] = 1
    lc_lm = np.full(Mpad, L, np.int64)
    lc_lm[:M] = lc_lms
    return LoopWork(
        banded=banded,
        lc_uv=jnp.asarray(uvg), lc_weight=jnp.asarray(wg),
        lc_aslot=jnp.asarray(aslot.astype(np.int32)),
        lc_lm=jnp.asarray(lc_lm.astype(np.int32)),
        lc_gather=jnp.asarray(np.minimum(lc_lm, L - 1).astype(np.int32)),
        onehot_A=jnp.asarray(onehot_A))


def _lc_quantities(poses, points_lc, lw: LoopWork, C, loss=None):
    """Linearize the loop-closure observations. Camera state reaches each
    slot through TWO one-hot matmuls (C -> A support rows -> slot columns);
    no gathers. Returns (cam_red (C, 28) [21 Hpp | 6 gp | 1 cost] partial,
    Hll_lc 6 x (Mpad,), gl_lc (3, Mpad), W_lc (Klc, 18, Mpad))."""
    Klc, Mpad = lw.lc_weight.shape
    pA = lw.onehot_A.shape[0]
    dtype = points_lc.dtype
    R12 = jnp.concatenate([poses.R.reshape(C, 9), poses.t], axis=1)
    RA = jax.lax.dot_general(lw.onehot_A, R12, (((1,), (0,)), ((), ())),
                             precision=HIGHEST)                # (pA, 12)

    camA_red = jnp.zeros((pA, 28), dtype)
    Hll = [jnp.zeros(Mpad, dtype) for _ in range(6)]
    gl = [jnp.zeros(Mpad, dtype) for _ in range(3)]
    Wk = []
    for k in range(Klc):
        Ok = jax.nn.one_hot(lw.lc_aslot[k], pA, dtype=dtype)   # (Mpad, pA)
        Rt = jax.lax.dot_general(Ok, RA, (((1,), (0,)), ((), ())),
                                 precision=HIGHEST)            # (Mpad, 12)
        (r0, r1), (jp0, jp1), (jl0, jl1), cost_col = _linearize_slot(
            Rt[:, :9], Rt[:, 9:], points_lc, lw.lc_uv[k], lw.lc_weight[k],
            chunk=1, loss=loss)
        d2 = lambda a0, a1, b0, b1: a0 * b0 + a1 * b1
        cols = [d2(jp0[i], jp1[i], jp0[j], jp1[j]) for (i, j) in _IJ6]
        cols += [d2(jp0[i], jp1[i], r0, r1) for i in range(6)]
        cols += [cost_col]
        camA_red = camA_red + jax.lax.dot_general(
            Ok, jnp.stack(cols, axis=1), (((0,), (0,)), ((), ())),
            precision=HIGHEST)
        for n, (i, j) in enumerate(_IJ3):
            Hll[n] = Hll[n] + d2(jl0[i], jl1[i], jl0[j], jl1[j])
        for j in range(3):
            gl[j] = gl[j] + d2(jl0[j], jl1[j], r0, r1)
        Wk.append(jnp.stack([d2(jp0[i], jp1[i], jl0[j], jl1[j])
                             for i in range(6) for j in range(3)]))
    cam_red = jax.lax.dot_general(lw.onehot_A, camA_red,
                                  (((0,), (0,)), ((), ())),
                                  precision=HIGHEST)           # (C, 28)
    return cam_red, Hll, jnp.stack(gl), jnp.stack(Wk)


def _damp_hll(Hll, lam):
    """Shared damping scheme: empty (zero-trace) blocks -> identity,
    otherwise + lam * diag. Returns (damped 6 cols, 3 diag cols)."""
    dll = [jnp.maximum(Hll[k], 1e-12) for k, (i, j) in enumerate(_IJ3)
           if i == j]
    empty = (Hll[0] + Hll[3] + Hll[5]) <= 0.0
    Hd = [jnp.where(empty, 1.0 if k in (0, 3, 5) else 0.0,
                    Hll[k] + (lam * dll[{0: 0, 3: 1, 5: 2}[k]]
                              if k in (0, 3, 5) else 0.0))
          for k in range(6)]
    return Hd, dll


def _lc_factor(W_lc, Hll_lc_d, lw: LoopWork, freeA, dtype):
    """U_A (pA, 6, q): the loop-closure downdate factor on its camera
    support, gauge-masked. q = min(3*Mpad, 6*pA) — compressed through the
    support eigendecomposition when 3*Mpad is wider (shape-static choice)."""
    Klc, Mpad = lw.lc_weight.shape
    pA = lw.onehot_A.shape[0]
    # whiten: Y_k = W_k L^-T per slot (forward substitution in columns)
    l00, l10, l11, l20, l21, l22 = _chol3_flat(Hll_lc_d)
    i00, i11, i22 = 1.0 / l00, 1.0 / l11, 1.0 / l22
    Ua = jnp.zeros((pA, 6, Mpad, 3), dtype)
    for k in range(Klc):
        Wkk = W_lc[k]                                    # (18, Mpad)
        wof = lambda i, j: Wkk[i * 3 + j]
        y0 = [wof(i, 0) * i00 for i in range(6)]
        y1 = [(wof(i, 1) - l10 * y0[i]) * i11 for i in range(6)]
        y2 = [(wof(i, 2) - l20 * y0[i] - l21 * y1[i]) * i22
              for i in range(6)]
        Yk = jnp.stack([jnp.stack(y0), jnp.stack(y1), jnp.stack(y2)],
                       axis=1)                           # (6, 3, Mpad)
        Ok = jax.nn.one_hot(lw.lc_aslot[k], pA, dtype=dtype)  # (Mpad, pA)
        Ua = Ua + jnp.einsum("ma,ijm->aimj", Ok, Yk, precision=HIGHEST)
    Ua = Ua * freeA[:, None, None, None]
    Ua = Ua.reshape(pA, 6, 3 * Mpad)
    if 3 * Mpad <= 6 * pA:
        return Ua
    # Compress through the camera support WITHOUT squaring: LQ of Ua via
    # QR of Ua^T gives Ua = R^T Q^T with Q orthonormal, so U := R^T has
    # U U^T = Ua Ua^T as the Gram of a NEARBY factor (QR is backward-stable
    # in factor space). The earlier Gram+eigh route formed Delta = Ua Ua^T
    # with eps*||Ua||^2 FORWARD error — not a Gram of anything — which made
    # the implicit S indefinite in f32 (kappa(S) > 1/eps32 on long
    # trajectories: weak bending modes).
    dtype = Ua.dtype
    Uf = Ua.reshape(pA * 6, 3 * Mpad)
    Rq = jnp.linalg.qr(Uf.T, mode="r")               # (6pA, 6pA)
    return Rq.T.reshape(pA, 6, 6 * pA)


def _solve_loop(Hpp_flat, gp, Hll_sr, gl_sr, W_sr, Hll_lc, gl_lc, W_lc,
                lam, fixed_mask, lw: LoopWork, C, psum_axis=None):
    """Exact damped, gauge-fixed solve of the FULL reduced camera system:
    multi-RHS banded solve of S_sb^-1 [b | U] + Woodbury capacitance.
    Returns (dp, dl_sr, dl_lc, diag_pp, diag_ll_sr, diag_ll_lc).

    psum_axis: distributed mode (parallel/loop_dist.py) — the banded chunk
    axis is split across devices (band downdates and the single-run rhs
    reduction are psummed, exactly as in the banded solver) while the
    loop-closure structure is REPLICATED on every device (M and |A| are
    small); the LC contributions are therefore added AFTER the psums, once,
    identically on all devices."""
    dtype = gp.dtype
    bw = lw.banded
    K = W_sr.shape[0]
    Lpad = W_sr.shape[2]
    chunk = Lpad // bw.onehot.shape[0]
    Klc, Mpad = lw.lc_weight.shape
    pA = lw.onehot_A.shape[0]

    # banded part of S: Hpp_d(total, damped) minus single-run downdates
    bands, hinv_sr, dpp, dll_sr, free = _assemble_bands(
        Hpp_flat, Hll_sr, W_sr, lam, fixed_mask, bw, C,
        psum_axis=psum_axis)

    # loop-closure landmark blocks: damp, invert, factor
    Hll_lc_d, dll_lc = _damp_hll(Hll_lc, lam)
    hinv_lc = _inv3x3_flat(Hll_lc_d)
    freeA = jax.lax.dot_general(lw.onehot_A, free[:, None],
                                (((1,), (0,)), ((), ())),
                                precision=HIGHEST)[:, 0]        # (pA,)
    Ua = _lc_factor(W_lc, Hll_lc_d, lw, freeA, dtype)           # (pA,6,q)
    q = Ua.shape[-1]

    # rhs: b = -(gp - W Hll^-1 gl), camera reduction over BOTH parts
    u_sr = _mat3vec_flat(hinv_sr, [gl_sr[0], gl_sr[1], gl_sr[2]])
    y = jnp.zeros((C, 6), dtype)
    for k in range(K):
        cols = [sum(W_sr[k, i * 3 + j] * u_sr[j] for j in range(3))
                for i in range(6)]
        y = y + _cam_accum(cols, k, bw.onehot, chunk)
    if psum_axis is not None:
        y = jax.lax.psum(y, psum_axis)     # single-run partials only;
                                           # the replicated LC part follows
    u_lc = _mat3vec_flat(hinv_lc, [gl_lc[0], gl_lc[1], gl_lc[2]])
    yA = jnp.zeros((pA, 6), dtype)
    for k in range(Klc):
        Ok = jax.nn.one_hot(lw.lc_aslot[k], pA, dtype=dtype)
        cols = jnp.stack([sum(W_lc[k, i * 3 + j] * u_lc[j] for j in range(3))
                          for i in range(6)], axis=1)           # (Mpad, 6)
        yA = yA + jax.lax.dot_general(Ok, cols, (((0,), (0,)), ((), ())),
                                      precision=HIGHEST)
    y = y + jax.lax.dot_general(lw.onehot_A, yA, (((0,), (0,)), ((), ())),
                                precision=HIGHEST)
    b = -(gp - y) * free[:, None]

    # ONE multi-RHS forward substitution through the STORED block-Cholesky
    # factor of S_sb: with S_sb = Lt Lt^T and Ut = Lt^-1 U, the capacitance
    # is the GRAM matrix I - Ut^T Ut — computed without the catastrophic
    # cancellation of the naive I - U^T S_sb^-1 U form (whose f32
    # eigenvalues measured at -1e3 where exact arithmetic guarantees (0,1]);
    # ||Ut||_2 < 1 holds exactly, so the Gram is accurate to f32 eps.
    #   S^-1 b = Lt^-T (I - Ut Ut^T)^-1 Lt^-1 b
    #          = Lt^-T [ c + Ut (I - Ut^T Ut)^-1 Ut^T c ],   c = Lt^-1 b
    U_C = jnp.einsum("ac,aiq->ciq", lw.onehot_A, Ua,
                     precision=HIGHEST)                         # (C,6,q)
    R = jnp.concatenate([b[..., None], U_C], axis=-1)           # (C,6,1+q)
    Dm, Em, G, Kb, Cp = _group_superblocks(bands, C, K, dtype)
    m = 6 * Kb
    if Cp > C:
        R = jnp.concatenate([R, jnp.zeros((Cp - C, 6, 1 + q), dtype)],
                            axis=0)
    fac = block_tridiag_factor(Dm, Em if G > 1 else
                               jnp.zeros((0, m, m), dtype))
    Y = tridiag_forward(fac, R.reshape(G, m, 1 + q))            # (G,m,1+q)
    c0_, Ut = Y[..., 0], Y[..., 1:]
    cap = (jnp.eye(q, dtype=dtype)
           - jnp.einsum("gmq,gmr->qr", Ut, Ut, precision=HIGHEST))
    # cap's exact eigenvalues lie in (0, 1]; near-zero modes are downdates
    # that nearly cancel S_sb — weak modes of S whose Newton step is huge
    # and cost-irrelevant. f32 rounding can push them negative (NaN under
    # Cholesky -> whole step rejected); solve by eigh and CLIP instead —
    # bounded correction along those modes, graceful everywhere else.
    wc, Vc = jnp.linalg.eigh(0.5 * (cap + cap.T))
    # clip floor ~ the substitution error level of Ut (f32)
    tol = 1e3 * jnp.asarray(jnp.finfo(dtype).eps, dtype)
    w_inv = 1.0 / jnp.maximum(wc, tol)

    z = Vc @ (w_inv * (Vc.T @ jnp.einsum("gmq,gm->q", Ut, c0_,
                                         precision=HIGHEST)))
    y = c0_ + jnp.einsum("gmq,q->gm", Ut, z, precision=HIGHEST)
    dp = tridiag_backward(fac, y).reshape(Cp, 6)[:C]

    # landmark back-substitution, single-run part (slot-major)
    t = [jnp.zeros(Lpad, dtype) for _ in range(3)]
    LB = bw.onehot.shape[0]
    for k in range(K):
        dpk = _cam_broadcast(dp * free[:, None], k, bw.onehot)  # (LB, 6)
        bcast = lambda col: jnp.broadcast_to(
            col[:, None], (LB, chunk)).reshape(Lpad)
        dcols = [bcast(dpk[:, i]) for i in range(6)]
        for j in range(3):
            t[j] = t[j] + sum(W_sr[k, i * 3 + j] * dcols[i]
                              for i in range(6))
    dl_sr = jnp.stack(_mat3vec_flat(
        hinv_sr, [-gl_sr[j] - t[j] for j in range(3)]), axis=1)

    # loop-closure part
    dpA = jnp.einsum("ac,ci->ai", lw.onehot_A, dp * free[:, None],
                     precision=HIGHEST)                         # (pA, 6)
    tl = [jnp.zeros(Mpad, dtype) for _ in range(3)]
    for k in range(Klc):
        Ok = jax.nn.one_hot(lw.lc_aslot[k], pA, dtype=dtype)
        dpk = jax.lax.dot_general(Ok, dpA, (((1,), (0,)), ((), ())),
                                  precision=HIGHEST)            # (Mpad, 6)
        for j in range(3):
            tl[j] = tl[j] + sum(W_lc[k, i * 3 + j] * dpk[:, i]
                                for i in range(6))
    dl_lc = jnp.stack(_mat3vec_flat(
        hinv_lc, [-gl_lc[j] - tl[j] for j in range(3)]), axis=1)

    return (dp, dl_sr, dl_lc, jnp.stack(dpp, axis=1),
            jnp.stack(dll_sr, axis=1), jnp.stack(dll_lc, axis=1))


def solve_ba_loop(poses0, points0, lw: LoopWork, *, fixed_mask=None,
                  max_iters=30, lambda_init=1e-4, xtol=1e-12, loss=None,
                  psum_axis=None, raw_points=False):
    """LM bundle adjustment with loop closures: exact linear solves via the
    banded factor + Woodbury correction. Identical LM semantics/trajectory to
    schur_flat.solve_ba_flat (parity-tested). `points0` in ORIGINAL landmark
    order (L, 3); so is the returned state's `.points`.

    psum_axis: run inside shard_map with the banded chunk axis split across
    devices and the LC structure replicated (parallel/loop_dist.py); all
    camera-side single-run reductions and scalar reductions are psummed,
    LC contributions are replicated-deterministic. raw_points=True returns
    `.points` as the (pts_sr_local, pts_lc) pair instead of scattering into
    the global array (the distributed wrapper scatters outside)."""
    C = poses0.t.shape[0]
    dtype = points0.dtype
    bw = lw.banded
    if fixed_mask is None:
        fixed_mask = jnp.zeros(C, bool).at[0].set(True)

    pts_sr0 = points0[bw.gather_idx]                    # (Lpad, 3)
    pts_lc0 = points0[lw.lc_gather]                     # (Mpad, 3)

    def quantities(poses, pts_sr, pts_lc):
        Hpp_b, gp_b, Hll_sr, gl_sr, W_sr, cost_b = _banded_quantities(
            poses, pts_sr, bw, C, loss=loss, psum_axis=psum_axis)
        cam_lc, Hll_lc, gl_lc, W_lc = _lc_quantities(poses, pts_lc, lw, C,
                                                     loss=loss)
        Hpp = Hpp_b + cam_lc[:, :21]
        gp = gp_b + cam_lc[:, 21:27]
        cost = cost_b + jnp.sum(cam_lc[:, 27])
        return (Hpp, gp, tuple(Hll_sr), gl_sr, W_sr,
                tuple(Hll_lc), gl_lc, W_lc), cost

    blocks0, cost0 = quantities(poses0, pts_sr0, pts_lc0)
    state = (BAState(poses=poses0, points=(pts_sr0, pts_lc0), cost=cost0,
                     lam=jnp.asarray(lambda_init, dtype),
                     nu=jnp.asarray(2.0, dtype),
                     it=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool)),
             blocks0)

    def cond(sb):
        s, _ = sb
        return (~s.done) & (s.it < max_iters)

    def body(sb):
        s, blocks = sb
        Hpp, gp, Hll_sr, gl_sr, W_sr, Hll_lc, gl_lc, W_lc = blocks
        dp, dl_sr, dl_lc, diag_pp, diag_sr, diag_lc = _solve_loop(
            Hpp, gp, list(Hll_sr), gl_sr, W_sr, list(Hll_lc), gl_lc, W_lc,
            s.lam, fixed_mask, lw, C, psum_axis=psum_axis)
        bad = (jnp.any(~jnp.isfinite(dp)) | jnp.any(~jnp.isfinite(dl_sr))
               | jnp.any(~jnp.isfinite(dl_lc)))
        if psum_axis is not None:
            # all devices must agree before touching the replicated state
            bad = jax.lax.psum(bad.astype(dtype), psum_axis) > 0
        dp_s = jnp.where(bad, jnp.zeros_like(dp), dp)
        dsr = jnp.where(bad, jnp.zeros_like(dl_sr), dl_sr)
        dlc = jnp.where(bad, jnp.zeros_like(dl_lc), dl_lc)
        poses_try = jax.vmap(lambda T, d: se3.SE3(
            so3.retract(T.R, d[:3]), T.t + d[3:]))(s.poses, dp_s)
        sr_try = s.points[0] + dsr
        lc_try = s.points[1] + dlc
        blocks_try, cost_try = quantities(poses_try, sr_try, lc_try)

        pred_sr = jnp.sum(dsr * (s.lam * diag_sr * dsr - gl_sr.T))
        step_sr = jnp.sum(dsr * dsr)
        if psum_axis is not None:
            pred_sr, step_sr = jax.lax.psum((pred_sr, step_sr), psum_axis)
        pred = 0.5 * (jnp.sum(dp_s * (s.lam * diag_pp * dp_s - gp))
                      + pred_sr
                      + jnp.sum(dlc * (s.lam * diag_lc * dlc - gl_lc.T)))
        accept, lam_new, nu_new = lm_accept(s.cost, cost_try, s.lam, s.nu,
                                            pred, bad)
        sel = lambda a, b2: jnp.where(accept, a, b2)
        step_sq = (jnp.sum(dp_s * dp_s) + step_sr + jnp.sum(dlc * dlc))
        new_state = BAState(
            poses=jax.tree_util.tree_map(sel, poses_try, s.poses),
            points=(sel(sr_try, s.points[0]), sel(lc_try, s.points[1])),
            cost=sel(cost_try, s.cost), lam=lam_new, nu=nu_new, it=s.it + 1,
            done=accept & (step_sq < xtol * xtol))
        new_blocks = jax.tree_util.tree_map(sel, blocks_try, blocks)
        return (new_state, new_blocks)

    final, _ = jax.lax.while_loop(cond, body, state)
    if raw_points:
        return final
    pts_sr, pts_lc = final.points
    points_out = points0.at[bw.scatter_idx].set(pts_sr, mode="drop")
    points_out = points_out.at[lw.lc_lm].set(pts_lc, mode="drop")
    return final._replace(points=points_out)


def loop_pose_covariances(poses, points, lw: LoopWork, fixed_mask, *,
                          lam=0.0, loss=None):
    """Marginal 6x6 pose covariances at the solution for LOOP-CLOSURE
    problems — the Ceres `Covariance` role at scales the dense path cannot
    reach, for the visibility class the pure banded Takahashi recursion
    cannot represent (off-band revisit coupling).

    With S = S_sb - U U^T and S_sb = Lt Lt^T (the stored tridiagonal
    factor), Ut = Lt^-1 U:

        S^-1 = S_sb^-1 + Z cap^-1 Z^T,   Z = Lt^-T Ut,  cap = I - Ut^T Ut

    so every per-camera diagonal block is the banded Takahashi diagonal
    PLUS a rank-q correction evaluated per camera with one einsum. Exact
    (up to the same eigh-clip used by the solver). Fixed cameras get zero.
    `points` must be in ORIGINAL landmark order (as returned by
    solve_ba_loop)."""
    from slam_tricks_tpu.solvers.banded_flat import _takahashi_inverse_blocks

    C = poses.t.shape[0]
    dtype = points.dtype
    bw = lw.banded
    lam = jnp.asarray(lam, dtype)

    pts_sr = points[bw.gather_idx]
    pts_lc = points[lw.lc_gather]
    Hpp_b, _, Hll_sr, _, W_sr, _ = _banded_quantities(poses, pts_sr, bw, C,
                                                      loss=loss)
    cam_lc, Hll_lc, _, W_lc = _lc_quantities(poses, pts_lc, lw, C, loss=loss)
    Hpp = Hpp_b + cam_lc[:, :21]
    K = W_sr.shape[0]
    bands, _, _, _, free = _assemble_bands(Hpp, Hll_sr, W_sr, lam,
                                           fixed_mask, bw, C)
    Hll_lc_d, _ = _damp_hll(Hll_lc, lam)
    freeA = jax.lax.dot_general(lw.onehot_A, free[:, None],
                                (((1,), (0,)), ((), ())),
                                precision=HIGHEST)[:, 0]
    Ua = _lc_factor(W_lc, Hll_lc_d, lw, freeA, dtype)
    q = Ua.shape[-1]
    U_C = jnp.einsum("ac,aiq->ciq", lw.onehot_A, Ua, precision=HIGHEST)

    Dm, Em, G, Kb, Cp = _group_superblocks(bands, C, K, dtype)
    m = 6 * Kb
    if Cp > C:
        U_C = jnp.concatenate([U_C, jnp.zeros((Cp - C, 6, q), dtype)],
                              axis=0)
    fac = block_tridiag_factor(Dm, Em if G > 1 else
                               jnp.zeros((0, m, m), dtype))
    Ut = tridiag_forward(fac, U_C.reshape(G, m, q))
    cap = (jnp.eye(q, dtype=dtype)
           - jnp.einsum("gmq,gmr->qr", Ut, Ut, precision=HIGHEST))
    wc, Vc = jnp.linalg.eigh(0.5 * (cap + cap.T))
    tol = 1e3 * jnp.asarray(jnp.finfo(dtype).eps, dtype)
    w_inv = 1.0 / jnp.maximum(wc, tol)
    Z = tridiag_backward(fac, Ut)                        # (G,m,q) = Lt^-T Ut
    # correction diag blocks: (Z Vc sqrt(w_inv)) (.)^T per camera
    Zc = jnp.einsum("gmq,qr->gmr", Z, Vc * jnp.sqrt(w_inv)[None, :],
                    precision=HIGHEST).reshape(Cp, 6, q)
    corr = jnp.einsum("ciq,cjq->cij", Zc, Zc, precision=HIGHEST)[:C]

    P, _ = _takahashi_inverse_blocks(Dm, Em if G > 1 else None, G)
    Pr = P.reshape(G, Kb, 6, Kb, 6)
    base = jax.vmap(lambda g: jax.vmap(lambda r: Pr[g, r, :, r, :])(
        jnp.arange(Kb)))(jnp.arange(G)).reshape(Cp, 6, 6)[:C]
    return (base + corr) * free[:, None, None]

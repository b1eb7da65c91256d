"""Single-core CPU baseline for the BA benchmark: a faithful, EFFICIENT numpy/
scipy implementation of the identical Schur-complement LM iteration (the
honest stand-in for single-core Ceres SPARSE_SCHUR — the reference publishes
no BA timing, BASELINE.md; Ceres semantics at
/root/reference/st20-g2o/src/include/test_ceres.h:143-148).

Round-1's baseline timed ONE iteration dominated by an np.add.at scatter into
a dense (C,L,6,3) tensor — unstable (7x swing between runs) and not how any
real sparse solver works. This one:
  - assembles blocks with vectorized np.add.at on (N, k) flat arrays only,
  - forms the off-diagonal Schur mass over within-track pairs (exactly what
    CSparse/Ceres walk per marginalized landmark),
  - runs the FULL LM loop (linearize, solve, retract, gain-ratio control —
    same Nielsen law as the device solver) for >= 5 iterations,
  - reports per-iteration time with run-to-run variance.

Keep BLAS out of the hot path (einsum on small trailing dims uses numpy's
single-threaded loops); the only LAPACK call is the (C*6)^2 Cholesky,
which is O(C^3*72) — negligible at bench scale and single-threaded there too.
"""

import time

import numpy as np


def _build_pairs_np(cam_idx, lm_idx, weight):
    """Within-track observation pairs (a<=b, same landmark), numpy."""
    keep = weight > 0
    idx_all = np.flatnonzero(keep)
    order = idx_all[np.argsort(lm_idx[idx_all], kind="stable")]
    lm_sorted = lm_idx[order]
    starts = np.flatnonzero(np.r_[True, lm_sorted[1:] != lm_sorted[:-1]])
    ends = np.r_[starts[1:], lm_sorted.shape[0]]
    a_list, b_list = [], []
    for s, e in zip(starts, ends):
        idx = order[s:e]
        ii, jj = np.triu_indices(e - s)
        a_list.append(idx[ii])
        b_list.append(idx[jj])
    pa = np.concatenate(a_list)
    pb = np.concatenate(b_list)
    pw = np.where(pa == pb, 0.5, 1.0)
    return pa, pb, pw


def _so3_exp(w):
    """Rodrigues for (C,3) -> (C,3,3)."""
    th = np.linalg.norm(w, axis=1, keepdims=True)
    th = np.maximum(th, 1e-30)
    k = w / th
    K = np.zeros((w.shape[0], 3, 3))
    K[:, 0, 1] = -k[:, 2]; K[:, 0, 2] = k[:, 1]
    K[:, 1, 0] = k[:, 2]; K[:, 1, 2] = -k[:, 0]
    K[:, 2, 0] = -k[:, 1]; K[:, 2, 1] = k[:, 0]
    s = np.sin(th)[:, :, None]
    c = np.cos(th)[:, :, None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + s * K + (1 - c) * (K @ K)


def _linearize(R, t, points, cam_idx, lm_idx, uv, sw):
    p = points[lm_idx]
    Rn = R[cam_idx]
    pc = np.einsum("nij,nj->ni", Rn, p) + t[cam_idx]
    iz = 1.0 / pc[:, 2]
    u = pc[:, 0] * iz
    v = pc[:, 1] * iz
    r = (np.stack([u, v], 1) - uv) * sw[:, None]
    head = np.zeros((len(u), 2, 3))
    head[:, 0, 0] = iz; head[:, 0, 2] = -u * iz
    head[:, 1, 1] = iz; head[:, 1, 2] = -v * iz
    Jl = np.einsum("nij,njk->nik", head, Rn) * sw[:, None, None]
    hat = np.zeros((len(u), 3, 3))
    hat[:, 0, 1] = -p[:, 2]; hat[:, 0, 2] = p[:, 1]
    hat[:, 1, 0] = p[:, 2]; hat[:, 1, 2] = -p[:, 0]
    hat[:, 2, 0] = -p[:, 1]; hat[:, 2, 1] = p[:, 0]
    Jo = -np.einsum("nij,njk->nik", Jl, hat)
    Jp = np.concatenate([Jo, head * sw[:, None, None]], axis=2)
    return r, Jp, Jl


def _cost(R, t, points, cam_idx, lm_idx, uv, weight):
    pc = np.einsum("nij,nj->ni", R[cam_idx], points[lm_idx]) + t[cam_idx]
    d = pc[:, :2] / pc[:, 2:3] - uv
    return 0.5 * np.sum(weight[:, None] * d * d)


def run_baseline_lm(poses_R, poses_t, points, cam_idx, lm_idx, uv, weight,
                    fixed_mask, *, max_iters=5, lambda_init=1e-4):
    """Full single-core Schur LM (same control law as the device solver).
    Returns (final_cost, iters_done, elapsed_seconds)."""
    R = poses_R.copy()
    t = poses_t.copy()
    pts = points.copy()
    C = R.shape[0]
    L = pts.shape[0]
    sw = np.sqrt(weight)
    pa, pb, pw = _build_pairs_np(cam_idx, lm_idx, weight)
    seg_cc = cam_idx[pa] * C + cam_idx[pb]
    free = ~fixed_mask

    lam, nu = lambda_init, 2.0
    cost = _cost(R, t, pts, cam_idx, lm_idx, uv, weight)
    t0 = time.perf_counter()
    it = 0
    for it in range(1, max_iters + 1):
        r, Jp, Jl = _linearize(R, t, pts, cam_idx, lm_idx, uv, sw)
        # block assembly on (N,k) flats
        JpTJp = np.einsum("nri,nrj->nij", Jp, Jp)
        JlTJl = np.einsum("nri,nrj->nij", Jl, Jl)
        W = np.einsum("nri,nrj->nij", Jp, Jl)                  # (N,6,3)
        gpn = np.einsum("nri,nr->ni", Jp, r)
        gln = np.einsum("nri,nr->ni", Jl, r)
        Hpp = np.zeros((C, 6, 6)); np.add.at(Hpp, cam_idx, JpTJp)
        Hll = np.zeros((L, 3, 3)); np.add.at(Hll, lm_idx, JlTJl)
        gp = np.zeros((C, 6)); np.add.at(gp, cam_idx, gpn)
        gl = np.zeros((L, 3)); np.add.at(gl, lm_idx, gln)

        dHpp = np.maximum(np.einsum("cii->ci", Hpp), 1e-12)
        dHll = np.maximum(np.einsum("lii->li", Hll), 1e-12)
        Hpp_d = Hpp.copy()
        Hpp_d[:, range(6), range(6)] += lam * dHpp
        tr = np.einsum("lii->l", Hll)
        Hll_d = Hll.copy()
        Hll_d[:, range(3), range(3)] += lam * dHll
        Hll_d[tr <= 0] = np.eye(3)
        Hll_inv = np.linalg.inv(Hll_d)

        # off-diagonal Schur mass over within-track pairs (the CSparse walk),
        # chunked: the unchunked (P,6,6) f64 temporaries reach ~400 MB at
        # bench scale and the allocation churn made run-to-run timing swing
        Y = np.einsum("nij,njk->nik", W, Hll_inv[lm_idx])
        M = np.zeros((C * C, 6, 6))
        CH = 200_000
        for s in range(0, pa.shape[0], CH):
            sl = slice(s, s + CH)
            blk = (np.einsum("pim,pjm->pij", Y[pa[sl]], W[pb[sl]])
                   * pw[sl, None, None])
            np.add.at(M, seg_cc[sl], blk)
        M = M.reshape(C, C, 6, 6)
        S = -(M + M.transpose(1, 0, 3, 2)).transpose(0, 2, 1, 3)
        S[range(C), :, range(C), :] += Hpp_d
        u = np.einsum("lij,lj->li", Hll_inv, gl)
        y = np.einsum("nij,nj->ni", W, u[lm_idx])
        yc = np.zeros((C, 6)); np.add.at(yc, cam_idx, y)
        b = -(gp - yc)

        ff = free.astype(float)
        S *= ff[:, None, None, None] * ff[None, None, :, None]
        S[range(C), :, range(C), :] += np.einsum(
            "c,ij->cij", fixed_mask.astype(float), np.eye(6))
        b *= ff[:, None]
        dp = np.linalg.solve(S.reshape(C * 6, C * 6), b.reshape(-1)).reshape(C, 6)

        tl = np.zeros((L, 3))
        np.add.at(tl, lm_idx, np.einsum("nij,ni->nj", W, dp[cam_idx]))
        dl = np.einsum("lij,lj->li", Hll_inv, -gl - tl)

        # trial + Nielsen gain-ratio control (identical law to the device solver)
        R_try = R @ _so3_exp(dp[:, :3])
        t_try = t + dp[:, 3:]
        pts_try = pts + dl
        cost_try = _cost(R_try, t_try, pts_try, cam_idx, lm_idx, uv, weight)
        pred = 0.5 * (np.sum(dp * (lam * dHpp * dp - gp))
                      + np.sum(dl * (lam * dHll * dl - gl)))
        rho = (cost - cost_try) / max(pred, 1e-30)
        if cost_try < cost and np.isfinite(cost_try):
            R, t, pts, cost = R_try, t_try, pts_try, cost_try
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
        else:
            lam *= nu
            nu *= 2.0
        lam = min(max(lam, 1e-12), 1e10)
    elapsed = time.perf_counter() - t0
    return cost, it, elapsed


def time_baseline(poses_R, poses_t, points, cam_idx, lm_idx, uv, weight,
                  fixed_mask, *, iters=5, repeats=3):
    """Run the baseline LM `repeats` times; returns (iters_per_s, rel_spread,
    final_cost). iters_per_s uses the BEST run (standard best-of-N timing —
    the machine's capability, immune to one-off scheduler noise); rel_spread
    = (max-min)/mean of the per-run timings — the stability measure VERDICT
    r1 item 2 requires (< 0.2 between consecutive bench runs)."""
    times = []
    cost = None
    for _ in range(repeats):
        cost, it, dt = run_baseline_lm(poses_R, poses_t, points, cam_idx,
                                       lm_idx, uv, weight, fixed_mask,
                                       max_iters=iters)
        times.append(dt / it)
    mean = float(np.mean(times))
    spread = float((np.max(times) - np.min(times)) / mean)
    return 1.0 / float(np.min(times)), spread, float(cost)

"""Block-sparse Schur-complement bundle adjustment (SURVEY §7 step 5 — the
centerpiece).

Replaces Ceres SPARSE_SCHUR / g2o BlockSolver<6,3>+CSparse with marginalized
landmarks (reference: st20-g2o/src/include/test_ceres.h:143-145,
test_g2o.h:94-135). Accelerator-native design:

- residuals + analytic Jacobians evaluated per observation via vmap
  (the block sparsity pattern st20 renders at sim_data.h:108-159 is never
  materialized as a big matrix — only its blocks)
- `segment_sum` gathers J^T J into per-camera (6,6), per-landmark (3,3) blocks
- landmark elimination = batched 3x3 Cholesky solves (closed form)
- reduced camera system S assembled densely over (C*6, C*6) via einsum on a
  scattered (C, L) block tensor — matmul work; small C makes this exact and fast.
  (C ~ hundreds is fine; the PCG/matrix-free path for large C is
  solvers/pcg.py.)
- LM trust-region control runs on device in a while_loop (no host syncs)

Gauge freedom: fixed cameras (SetParameterBlockConstant analog,
test_ceres.h:127-130) are handled by identity-row/col masking of S.

Tangent convention per camera: so3_r3 [omega, dt] (g2o VertexCamera oplus,
test_g2o.h:36-39), poses stored as T_cw.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.manifolds import se3, so3
from slam_tricks_tpu.solvers.common import HIGHEST
from slam_tricks_tpu.residuals.reprojection import reproject_normalized_jacobians


class BAState(NamedTuple):
    poses: se3.SE3          # stacked (C,)
    points: jnp.ndarray     # (L,3)
    cost: jnp.ndarray
    lam: jnp.ndarray
    nu: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


def _linearize_obs(poses, points, cam_idx, lm_idx, uv, weight):
    """Per-observation residual + Jacobians, weighted. Returns
    (r (N,2), Jp (N,2,6), Jl (N,2,3))."""
    T = jax.tree_util.tree_map(lambda a: a[cam_idx], poses)
    p = points[lm_idx]

    def one(Ti, pi, uvi):
        pred, Jp, Jl = reproject_normalized_jacobians(Ti, pi)
        return pred - uvi, Jp, Jl

    r, Jp, Jl = jax.vmap(one)(T, p, uv)
    sw = jnp.sqrt(weight)[:, None]
    return r * sw, Jp * sw[..., None], Jl * sw[..., None]


def _cost(poses, points, cam_idx, lm_idx, uv, weight):
    T = jax.tree_util.tree_map(lambda a: a[cam_idx], poses)
    p = points[lm_idx]

    def one(Ti, pi, uvi):
        pc = Ti.R @ pi + Ti.t
        return pc[:2] / pc[2] - uvi

    r = jax.vmap(one)(T, p, uv)
    return 0.5 * jnp.sum(weight[:, None] * r * r)


def _assemble(r, Jp, Jl, cam_idx, lm_idx, n_cams, n_points):
    """Normal-equation blocks via segment_sum — the H += J^T J hot loop of the
    reference (st17 solver.hpp:405-436) turned into three fused scatters."""
    seg = jax.ops.segment_sum
    Hpp = seg(jnp.einsum("nri,nrj->nij", Jp, Jp, precision=HIGHEST), cam_idx, n_cams)   # (C,6,6)
    Hll = seg(jnp.einsum("nri,nrj->nij", Jl, Jl, precision=HIGHEST), lm_idx, n_points)  # (L,3,3)
    gp = seg(jnp.einsum("nri,nr->ni", Jp, r, precision=HIGHEST), cam_idx, n_cams)       # (C,6)
    gl = seg(jnp.einsum("nri,nr->ni", Jl, r, precision=HIGHEST), lm_idx, n_points)      # (L,3)
    W_obs = jnp.einsum("nri,nrj->nij", Jp, Jl, precision=HIGHEST)                       # (N,6,3)
    return Hpp, Hll, gp, gl, W_obs


def _inv3x3(A):
    """Batched closed-form inverse of (..., 3, 3) SPD blocks via adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / det
    rows = jnp.stack([
        jnp.stack([A11, A12, A13], axis=-1),
        jnp.stack([A21, A22, A23], axis=-1),
        jnp.stack([A31, A32, A33], axis=-1),
    ], axis=-2)
    return rows * inv_det[..., None, None]


def _damp_blocks(H, lam):
    """Marquardt damping of batched diagonal blocks: H + lam*diag(max(diag,eps))."""
    d = jnp.maximum(jnp.diagonal(H, axis1=-2, axis2=-1), 1e-12)
    return H + lam * jax.vmap(jnp.diag)(d)


def _damp_hll(Hll, lam):
    """Damped landmark blocks with EMPTY blocks (zero trace — landmarks with no
    surviving observations) replaced by identity. The eps-damped zero block has
    det ~ (lam*1e-12)^3 which underflows f32 (~1e-38 min normal), turning its
    closed-form inverse into inf and poisoning the solve with 0*inf = NaN.
    Empty landmarks have zero W and gl, so the identity contributes nothing."""
    tr = jnp.einsum("lii->l", Hll)
    eye3 = jnp.eye(3, dtype=Hll.dtype)
    return jnp.where(tr[:, None, None] > 0, _damp_blocks(Hll, lam), eye3[None])


def _finish_and_solve_S(S, Hpp_d, b, fixed_mask):
    """Add the damped pose diagonal to the off-diagonal Schur mass S (C,6,C,6),
    apply gauge masking (identity rows/cols for fixed cameras — the
    SetParameterBlockConstant analog, st20 test_ceres.h:127-130), and solve by
    dense Cholesky. Returns dp (C,6)."""
    dtype = b.dtype
    C = b.shape[0]
    eye_c = jnp.eye(C, dtype=dtype)[:, None, :, None]
    S = S + eye_c * Hpp_d[:, :, None, :]
    free = (~fixed_mask).astype(dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S + eye_c * (fixed_mask.astype(dtype)[:, None, None, None]
                     * jnp.eye(6, dtype=dtype)[None, :, None, :])
    b = b * free[:, None]
    cf = jax.scipy.linalg.cho_factor(S.reshape(C * 6, C * 6), lower=True)
    return jax.scipy.linalg.cho_solve(cf, b.reshape(C * 6)).reshape(C, 6)


def lm_accept(cost_old, cost_try, lam, nu, pred, bad):
    """Nielsen gain-ratio trust-region update — THE control law shared by every
    LM loop (single-chip and distributed, VERDICT r1 item 5: identical law so
    all solvers take the same iteration trajectory on the same problem).

    pred: predicted model decrease 0.5 * d^T (lam*D d - g).
    Returns (accept, lam_new, nu_new)."""
    rho = (cost_old - cost_try) / jnp.maximum(pred, 1e-30)
    accept = (cost_try < cost_old) & jnp.isfinite(cost_try) & (~bad)
    lam_new = jnp.where(
        accept,
        lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
        lam * nu)
    lam_new = jnp.clip(lam_new, 1e-12, 1e10)
    nu_new = jnp.where(accept, 2.0, nu * 2.0)
    return accept, lam_new, nu_new


def lm_gain_update(cost_old, cost_try, lam, nu, dvec, gvec, diag_scaled, bad):
    """lm_accept with the model decrease computed from flat step/gradient/
    Marquardt-diagonal vectors. Returns (accept, lam_new, nu_new)."""
    pred = 0.5 * jnp.dot(dvec, lam * diag_scaled * dvec - gvec)
    return lm_accept(cost_old, cost_try, lam, nu, pred, bad)


def _paired_S_mass(Y, W_obs, cam_idx, pair_a, pair_b, pair_w, n_cams):
    """Accumulate the (unsymmetrized) off-diagonal Schur mass
        M[cam_a, cam_b] += w * Y[a] W[b]^T      over within-track pairs,
    chunked with lax.scan so peak memory is O(chunk * 36) regardless of the
    landmark count. pair_* have shape (n_chunks, chunk); Y = W Hll_d^-1.
    Returns M (C, C, 6, 6); S_off = -(M + M^T_blocks)."""
    C = n_cams

    def step(M_acc, chunk):
        a, b, w = chunk
        blk = jnp.einsum("pim,pjm->pij", Y[a], W_obs[b],
                         precision=HIGHEST) * w[:, None, None]
        seg = cam_idx[a] * C + cam_idx[b]
        return M_acc + jax.ops.segment_sum(blk, seg, C * C), None

    # carry seeded from a (zeroed) data value so its vma matches the scan
    # output when this runs inside shard_map (device-varying inputs)
    M0 = jnp.zeros((C * C, 6, 6), dtype=Y.dtype) + 0.0 * Y.reshape(-1)[0]
    M, _ = jax.lax.scan(step, M0, (pair_a, pair_b, pair_w.astype(Y.dtype)))
    return M.reshape(C, C, 6, 6)


def _schur_reduce(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx, lam, n_cams, n_points,
                  fixed_mask):
    """Form and solve the reduced camera system; back-substitute landmarks.

    Device shape: with Hll_d = Ld Ld^T (batched closed-form 3x3 Cholesky), the
    off-diagonal Schur mass W Hll_d^-1 W^T equals -B B^T for the whitened
    block matrix B[c, l] = W[c,l] Ld[l]^-T — ONE (C*6, L*3)x(L*3, C*6)
    matmul instead of the two-stage (C,L)-block einsum chain; rhs and
    back-substitution are matrix-free segment reductions over observations
    (nothing but B ever materializes the (C,L) block structure).

    Returns (delta_pose (C,6), delta_point (L,3))."""
    from slam_tricks_tpu.ops.smallchol import cholesky_small, solve_lower_small

    dtype = gp.dtype
    C, L = n_cams, n_points

    Hpp_d = _damp_blocks(Hpp, lam)
    Hll_d = _damp_hll(Hll, lam)
    Hll_inv = _inv3x3(Hll_d)

    # whiten per observation: X = Ld^-1 W^T  (N,3,6), so B_obs = X^T
    Ld = cholesky_small(Hll_d)                                        # (L,3,3)
    X = solve_lower_small(Ld[lm_idx], jnp.swapaxes(W_obs, -1, -2))    # (N,3,6)
    # scatter whitened blocks into B (L,3,C,6) -> one big symmetric matmul
    B = jnp.zeros((L, 3, C, 6), dtype=dtype).at[lm_idx, :, cam_idx].add(X)
    B_mat = B.reshape(L * 3, C * 6)
    S_off = -jax.lax.dot_general(B_mat, B_mat, (((0,), (0,)), ((), ())),
                                 precision=HIGHEST)                   # (C*6,C*6)

    # rhs, matrix-free: b = -(gp - W Hll^-1 gl)
    u = jnp.einsum("lij,lj->li", Hll_inv, gl, precision=HIGHEST)      # (L,3)
    y = jnp.einsum("nij,nj->ni", W_obs, u[lm_idx], precision=HIGHEST)
    b = -(gp - jax.ops.segment_sum(y, cam_idx, C))                    # (C,6)

    dp = _finish_and_solve_S(S_off.reshape(C, 6, C, 6), Hpp_d, b, fixed_mask)

    # back-substitution, matrix-free: dl = Hll^-1 (-gl - W^T dp)
    t = jnp.einsum("nij,ni->nj", W_obs, dp[cam_idx], precision=HIGHEST)
    t = jax.ops.segment_sum(t, lm_idx, L)
    dl = jnp.einsum("lij,lj->li", Hll_inv, -gl - t, precision=HIGHEST)
    return dp, dl


class TrackTable(NamedTuple):
    """Static track-padded observation layout (host-built once from the
    visibility structure): obs_idx[l, k] indexes the k-th observation of
    landmark l into the flat observation arrays; mask marks real entries.

    Purpose: the track table converts EVERY scatter in the BA iteration
    into gathers + batched einsums, a layout for the block sparsity st20
    renders (sim_data.h:108-159) with no scatter or atomic accumulation."""
    obs_idx: jnp.ndarray   # (L, K) int32
    mask: jnp.ndarray      # (L, K) dtype 1/0


def build_track_table(cam_idx, lm_idx, weight=None, *, n_points=None,
                      dtype=np.float32):
    """Host-side: group observation indices by landmark, pad to the max track
    length (rounded up to a multiple of 8). Padding entries point at index 0
    with mask 0 (all gathered values are masked)."""
    cam_idx = np.asarray(cam_idx)
    lm_idx = np.asarray(lm_idx)
    keep = np.ones(lm_idx.shape[0], bool) if weight is None else (np.asarray(weight) > 0)
    L = int(n_points) if n_points is not None else int(lm_idx.max()) + 1
    valid = np.flatnonzero(keep)
    order = valid[np.argsort(lm_idx[valid], kind="stable")]
    lm_sorted = lm_idx[order]
    counts = np.bincount(lm_sorted, minlength=L)
    K = int(counts.max()) if counts.size else 1
    K = K + (-K) % 8
    obs_idx = np.zeros((L, K), np.int32)
    mask = np.zeros((L, K), dtype)
    starts = np.zeros(L + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # vectorized fill: each sorted obs lands at (its landmark, its rank
    # within the track)
    slot = np.arange(lm_sorted.shape[0]) - starts[lm_sorted]
    obs_idx[lm_sorted, slot] = order
    mask[lm_sorted, slot] = 1
    return TrackTable(obs_idx=jnp.asarray(obs_idx), mask=jnp.asarray(mask))


def _assemble_tracks(r, Jp, Jl, cam_idx, table: TrackTable, n_cams, n_points):
    """Scatter-free normal-equation assembly: camera-side blocks via one-hot
    matmul (C is small), landmark-side blocks via track-padded batched einsum.
    Returns the same tuple as _assemble."""
    dtype = r.dtype
    oh_c = jax.nn.one_hot(cam_idx, n_cams, dtype=dtype)                  # (N,C)
    JpTJp = jnp.einsum("nri,nrj->nij", Jp, Jp, precision=HIGHEST)
    Hpp = jnp.einsum("nc,nij->cij", oh_c, JpTJp, precision=HIGHEST)      # (C,6,6)
    gp = jnp.einsum("nc,nri,nr->ci", oh_c, Jp, r, precision=HIGHEST)     # (C,6)
    m = table.mask[..., None, None]
    Jl_t = Jl[table.obs_idx] * m                                         # (L,K,2,3)
    r_t = r[table.obs_idx] * table.mask[..., None]                       # (L,K,2)
    Hll = jnp.einsum("lkri,lkrj->lij", Jl_t, Jl_t, precision=HIGHEST)    # (L,3,3)
    gl = jnp.einsum("lkri,lkr->li", Jl_t, r_t, precision=HIGHEST)        # (L,3)
    W_obs = jnp.einsum("nri,nrj->nij", Jp, Jl, precision=HIGHEST)        # (N,6,3)
    return Hpp, Hll, gp, gl, W_obs


def _schur_reduce_tracks(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx, lam,
                         n_cams, n_points, fixed_mask, table: TrackTable):
    """Scatter-free reduced-camera-system solve: the whitened block matrix B
    is assembled by track-padded one-hot einsum (gathers + batched matmuls
    only), then S_off = -B^T B is one matmul. Exact same math as
    _schur_reduce."""
    from slam_tricks_tpu.ops.smallchol import cholesky_small, solve_lower_small

    dtype = gp.dtype
    C, L = n_cams, n_points

    Hpp_d = _damp_blocks(Hpp, lam)
    Hll_d = _damp_hll(Hll, lam)
    Hll_inv = _inv3x3(Hll_d)

    # whiten per observation: X = Ld^-1 W^T  (N,3,6)
    Ld = cholesky_small(Hll_d)
    X = solve_lower_small(Ld[lm_idx], jnp.swapaxes(W_obs, -1, -2))
    # B via track gather + per-track one-hot einsum (no scatter)
    X_t = X[table.obs_idx] * table.mask[..., None, None]                 # (L,K,3,6)
    oh_ct = (jax.nn.one_hot(cam_idx[table.obs_idx], C, dtype=dtype)
             * table.mask[..., None])                                    # (L,K,C)
    B = jnp.einsum("lkc,lkij->licj", oh_ct, X_t, precision=HIGHEST)      # (L,3,C,6)
    B_mat = B.reshape(L * 3, C * 6)
    S_off = -jax.lax.dot_general(B_mat, B_mat, (((0,), (0,)), ((), ())),
                                 precision=HIGHEST)

    # rhs, matrix-free with one-hot camera reduction
    u = jnp.einsum("lij,lj->li", Hll_inv, gl, precision=HIGHEST)
    y = jnp.einsum("nij,nj->ni", W_obs, u[lm_idx], precision=HIGHEST)
    oh_c = jax.nn.one_hot(cam_idx, C, dtype=dtype)
    b = -(gp - jnp.einsum("nc,ni->ci", oh_c, y, precision=HIGHEST))

    dp = _finish_and_solve_S(S_off.reshape(C, 6, C, 6), Hpp_d, b, fixed_mask)

    # back-substitution via track gather
    W_t = W_obs[table.obs_idx] * table.mask[..., None, None]             # (L,K,6,3)
    dp_t = dp[cam_idx[table.obs_idx]]                                    # (L,K,6)
    t = jnp.einsum("lkij,lki->lj", W_t, dp_t, precision=HIGHEST)
    dl = jnp.einsum("lij,lj->li", Hll_inv, -gl - t, precision=HIGHEST)
    return dp, dl


class TrackPairs(NamedTuple):
    """Precomputed within-track observation pairs for the paired Schur
    assembly (host-built from the static visibility structure).

    pair_a/pair_b index into the observation arrays; pair_w is 1.0 for
    off-diagonal pairs (a<b), 0.5 for diagonal pairs (a==b, so the final
    M + M^T symmetrization counts them once), 0.0 for padding. Arrays are
    padded to a multiple of `chunk` and reshaped (n_chunks, chunk) so the
    device loop is a static lax.scan."""
    pair_a: jnp.ndarray   # (n_chunks, chunk) int32
    pair_b: jnp.ndarray   # (n_chunks, chunk) int32
    pair_w: jnp.ndarray   # (n_chunks, chunk) dtype


def build_track_pairs(cam_idx, lm_idx, *, chunk=65536, dtype=np.float32):
    """Enumerate all unordered within-track observation pairs (a <= b with
    lm[a] == lm[b]) — the index structure of the off-diagonal Schur blocks
    W Hll^-1 W^T that g2o's marginalized landmarks walk edge-pair by edge-pair
    (st20-g2o/src/include/test_g2o.h:121). Host-side, numpy, O(sum_l k_l^2/2).
    """
    cam_idx = np.asarray(cam_idx)
    lm_idx = np.asarray(lm_idx)
    order = np.argsort(lm_idx, kind="stable").astype(np.int32)
    lm_sorted = lm_idx[order]
    # track segment boundaries in the sorted order
    starts = np.flatnonzero(np.r_[True, lm_sorted[1:] != lm_sorted[:-1]])
    ends = np.r_[starts[1:], lm_sorted.shape[0]]
    lengths = ends - starts
    # vectorized pair enumeration, bucketed by track length (few distinct
    # lengths; avoids a Python loop over 10^5+ tracks)
    a_list, b_list = [], []
    for k in np.unique(lengths):
        if k == 0:
            continue
        tr = np.flatnonzero(lengths == k)
        M = order[starts[tr][:, None] + np.arange(k)[None, :]]
        ii, jj = np.triu_indices(int(k))
        a_list.append(M[:, ii].ravel())
        b_list.append(M[:, jj].ravel())
    pa = np.concatenate(a_list) if a_list else np.zeros(0, np.int32)
    pb = np.concatenate(b_list) if b_list else np.zeros(0, np.int32)
    pw = np.where(pa == pb, 0.5, 1.0).astype(dtype)
    n = pa.shape[0]
    n_pad = -n % chunk
    if n + n_pad == 0:
        n_pad = chunk
    pa = np.concatenate([pa, np.zeros(n_pad, np.int32)])
    pb = np.concatenate([pb, np.zeros(n_pad, np.int32)])
    pw = np.concatenate([pw, np.zeros(n_pad, dtype)])
    shape = (-1, chunk)
    return TrackPairs(pair_a=jnp.asarray(pa.reshape(shape)),
                      pair_b=jnp.asarray(pb.reshape(shape)),
                      pair_w=jnp.asarray(pw.reshape(shape)))


def _schur_reduce_paired(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx, lam,
                         n_cams, n_points, fixed_mask, pairs: TrackPairs):
    """Exact reduced-camera-system solve WITHOUT the dense (C,L,6,3) block
    tensor: S's off-diagonal mass is accumulated pair-by-pair over each
    landmark's track,

        M[cam_a, cam_b] += w * (W_a Hll_d^-1) W_b^T      for a <= b in track
        S_off = -(M + M^T_blocks)

    chunked with lax.scan so peak memory is O(chunk * 36) regardless of L.
    This is the track-bucketed elimination of SURVEY §7's 'hard parts' —
    compute O(sum_l k_l^2), memory O(N), exact to the dense path."""
    dtype = gp.dtype
    C, L = n_cams, n_points

    Hpp_d = _damp_blocks(Hpp, lam)
    Hll_d = _damp_hll(Hll, lam)
    Hll_inv = _inv3x3(Hll_d)

    # per-observation Y = W Hll_d^-1  (N,6,3)
    Y = jnp.einsum("nij,njk->nik", W_obs, Hll_inv[lm_idx], precision=HIGHEST)
    M = _paired_S_mass(Y, W_obs, cam_idx, pairs.pair_a, pairs.pair_b,
                       pairs.pair_w, C)
    S_off = -(M + M.transpose(1, 0, 3, 2)).transpose(0, 2, 1, 3)      # (C,6,C,6)

    # rhs, matrix-free: b = -(gp - W Hll^-1 gl)
    u = jnp.einsum("lij,lj->li", Hll_inv, gl, precision=HIGHEST)      # (L,3)
    y = jnp.einsum("nij,nj->ni", W_obs, u[lm_idx], precision=HIGHEST)
    b = -(gp - jax.ops.segment_sum(y, cam_idx, C))

    dp = _finish_and_solve_S(S_off, Hpp_d, b, fixed_mask)

    # back-substitution, matrix-free
    t = jnp.einsum("nij,ni->nj", W_obs, dp[cam_idx], precision=HIGHEST)
    t = jax.ops.segment_sum(t, lm_idx, L)
    dl = jnp.einsum("lij,lj->li", Hll_inv, -gl - t, precision=HIGHEST)
    return dp, dl


def _retract_state(poses, points, dp, dl):
    new_poses = jax.vmap(lambda T, d: se3.SE3(so3.retract(T.R, d[:3]), T.t + d[3:]))(poses, dp)
    return new_poses, points + dl


def solve_ba(poses0, points0, obs, *, fixed_mask=None, max_iters=30,
             lambda_init=1e-4, xtol=1e-12, gtol=0.0, linear_solver="dense",
             cg_iters=100, cg_tol=1e-8, loss=None, callback=None,
             track_pairs=None, band_pairs=None, track_table=None):
    """LM bundle adjustment. `obs` is a BAObservations-like namedtuple with
    cam_idx, lm_idx, uv, weight. Returns the final BAState.
    Fully jittable; all control flow on device.

    linear_solver: "dense" materializes the reduced camera system exactly
    (small/medium C); "pcg" runs matrix-free block-Jacobi PCG with O(N) memory
    (large problems — never forms the (C,L) block tensor); "paired" is the
    exact Cholesky path with O(N) memory via within-track pair accumulation —
    pass `track_pairs=build_track_pairs(obs.cam_idx, obs.lm_idx)` (host-built
    once; the visibility structure is static); "tracks" is the scatter-free
    fast path (gathers + batched matmuls only — no scatters, see
    TrackTable) — pass `track_table=build_track_table(obs.cam_idx, obs.lm_idx,
    obs.weight, n_points=L)`.

    loss: optional residuals.robust.Loss — robustified BA via IRLS: each
    linearization multiplies observation weights by rho'(||r||^2) and the
    trust-region cost uses rho(||r||^2) (the Ceres LossFunction role)."""
    n_cams = poses0.t.shape[0]
    n_points = points0.shape[0]
    dtype = points0.dtype
    cam_idx, lm_idx, uv, base_weight = obs.cam_idx, obs.lm_idx, obs.uv, obs.weight
    if fixed_mask is None:
        fixed_mask = jnp.zeros(n_cams, bool).at[0].set(True)

    def _sqnorms(poses, points):
        T = jax.tree_util.tree_map(lambda a: a[cam_idx], poses)
        p = points[lm_idx]

        def one(Ti, pi, uvi):
            pc = Ti.R @ pi + Ti.t
            return pc[:2] / pc[2] - uvi

        r = jax.vmap(one)(T, p, uv)
        return jnp.sum(r * r, axis=1)

    if loss is None:
        _cost_fn = lambda poses, points: _cost(poses, points, cam_idx, lm_idx,
                                               uv, base_weight)
    else:
        def _cost_fn(poses, points):
            return 0.5 * jnp.sum(base_weight * loss.rho(_sqnorms(poses, points)))

        def _weights_at(poses, points):
            return base_weight * loss.weight(_sqnorms(poses, points))

    cost0 = _cost_fn(poses0, points0)
    state = BAState(poses=poses0, points=points0, cost=cost0,
                    lam=jnp.asarray(lambda_init, dtype), nu=jnp.asarray(2.0, dtype),
                    it=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool))

    def cond(s):
        return (~s.done) & (s.it < max_iters)

    def body(s):
        w_it = _weights_at(s.poses, s.points) if loss is not None else base_weight
        r, Jp, Jl = _linearize_obs(s.poses, s.points, cam_idx, lm_idx, uv, w_it)
        if linear_solver == "tracks":
            if track_table is None:
                raise ValueError("linear_solver='tracks' requires track_table="
                                 "build_track_table(obs.cam_idx, obs.lm_idx, "
                                 "obs.weight, n_points=L)")
            Hpp, Hll, gp, gl, W_obs = _assemble_tracks(
                r, Jp, Jl, cam_idx, track_table, n_cams, n_points)
        else:
            Hpp, Hll, gp, gl, W_obs = _assemble(r, Jp, Jl, cam_idx, lm_idx, n_cams, n_points)
        gnorm = jnp.maximum(jnp.max(jnp.abs(gp)), jnp.max(jnp.abs(gl)))
        if linear_solver == "tracks":
            dp, dl = _schur_reduce_tracks(Hpp, Hll, gp, gl, W_obs, cam_idx,
                                          lm_idx, s.lam, n_cams, n_points,
                                          fixed_mask, track_table)
        elif linear_solver == "pcg":
            from slam_tricks_tpu.solvers.pcg import solve_rcs_pcg
            dp, dl = solve_rcs_pcg(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx,
                                   s.lam, fixed_mask, n_points,
                                   cg_iters=cg_iters, cg_tol=cg_tol,
                                   band_pairs=band_pairs)
        elif linear_solver == "paired":
            if track_pairs is None:
                raise ValueError("linear_solver='paired' requires track_pairs="
                                 "build_track_pairs(obs.cam_idx, obs.lm_idx)")
            dp, dl = _schur_reduce_paired(Hpp, Hll, gp, gl, W_obs, cam_idx,
                                          lm_idx, s.lam, n_cams, n_points,
                                          fixed_mask, track_pairs)
        else:
            dp, dl = _schur_reduce(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx,
                                   s.lam, n_cams, n_points, fixed_mask)
        bad = jnp.any(~jnp.isfinite(dp)) | jnp.any(~jnp.isfinite(dl))
        dp_s = jnp.where(bad, jnp.zeros_like(dp), dp)
        dl_s = jnp.where(bad, jnp.zeros_like(dl), dl)
        poses_try, points_try = _retract_state(s.poses, s.points, dp_s, dl_s)
        cost_try = _cost_fn(poses_try, points_try)

        # gain ratio with Marquardt-damped model decrease
        dvec = jnp.concatenate([dp_s.reshape(-1), dl_s.reshape(-1)])
        gvec = jnp.concatenate([gp.reshape(-1), gl.reshape(-1)])
        diagH = jnp.maximum(jnp.concatenate([
            jax.vmap(jnp.diagonal)(Hpp).reshape(-1),
            jax.vmap(jnp.diagonal)(Hll).reshape(-1)]), 1e-12)
        accept, lam_new, nu_new = lm_gain_update(
            s.cost, cost_try, s.lam, s.nu, dvec, gvec, diagH, bad)

        sel = lambda a, b: jnp.where(accept, a, b)
        poses_new = jax.tree_util.tree_map(sel, poses_try, s.poses)
        points_new = sel(points_try, s.points)
        cost_new = sel(cost_try, s.cost)

        if callback is not None:
            # IterationCallback role (st17 solver.hpp:215-245)
            jax.debug.callback(callback, s.it, cost_new, lam_new)

        # a non-finite step is REJECTED (lambda grows via lm_accept), not
        # terminal: at higher damping the next factorization usually succeeds
        small_step = accept & (jnp.sum(dvec * dvec) < xtol * xtol)
        done = small_step | ((gtol > 0) & (gnorm < gtol))
        return BAState(poses=poses_new, points=points_new, cost=cost_new,
                       lam=lam_new, nu=nu_new, it=s.it + 1, done=done)

    final = jax.lax.while_loop(cond, body, state)
    return final


solve_ba_jit = jax.jit(
    partial(solve_ba),
    static_argnames=("max_iters", "linear_solver", "cg_iters"))

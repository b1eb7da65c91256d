"""Matrix-free preconditioned conjugate gradients on the Schur reduced camera
system — the scalable BA path (SURVEY §7 step 5 "PCG with block-Jacobi
preconditioner for larger pose counts").

The reduced system S x = b with S = Hpp_d - W Hll_d^-1 W^T is never formed:
one S-matvec costs three segment operations over the observation arrays,

    t_l  = sum_{obs of l} W_obs^T x[cam(obs)]        (gather + segment_sum)
    u_l  = Hll_d^-1 t_l                              (batched 3x3)
    y_c  = Hpp_d x_c - sum_{obs of c} W_obs u[lm(obs)]

so memory is O(N * 18) for the per-observation W blocks — no dense (C,L)
tensor — and every step is gather/scatter + elementwise math. Preconditioner:
block-Jacobi with the damped per-camera 6x6 blocks (unrolled Cholesky).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.ops.smallchol import (cho_solve_small, cholesky_small,
                                           solve_lower_small,
                                           solve_lower_t_small)
from slam_tricks_tpu.solvers.common import HIGHEST
from slam_tricks_tpu.solvers.schur import _damp_hll, _inv3x3


class BandPairs(NamedTuple):
    """Within-track observation pairs restricted to the first camera
    off-diagonal band — the index structure of the block-tridiagonal part of
    the reduced camera system S. Host-built once (static visibility).

    diag_*: unordered pairs with cam(a) == cam(b) (w=0.5 on a==b so the
    M + M^T symmetrization counts them once); super_*: ordered pairs with
    cam(a) == cam(b) + 1 (exact subdiagonal blocks S[c+1, c])."""
    diag_a: jnp.ndarray
    diag_b: jnp.ndarray
    diag_w: jnp.ndarray
    super_a: jnp.ndarray
    super_b: jnp.ndarray
    super_w: jnp.ndarray


def build_band_pairs(cam_idx, lm_idx, dtype=np.float32):
    """Enumerate the within-track pairs landing on S's block diagonal and
    first sub-diagonal (temporally adjacent cameras share the most landmarks
    on trajectory problems, so tridiag(S) captures the dominant coupling)."""
    cam_idx = np.asarray(cam_idx)
    lm_idx = np.asarray(lm_idx)
    order = np.argsort(lm_idx, kind="stable").astype(np.int32)
    lm_sorted = lm_idx[order]
    starts = np.flatnonzero(np.r_[True, lm_sorted[1:] != lm_sorted[:-1]])
    ends = np.r_[starts[1:], lm_sorted.shape[0]]
    da, db, sa, sb = [], [], [], []
    for s, e in zip(starts, ends):
        idx = order[s:e]
        cams = cam_idx[idx]
        k = e - s
        ii, jj = np.triu_indices(k)
        ca, cb = cams[ii], cams[jj]
        same = ca == cb
        da.append(idx[ii][same]); db.append(idx[jj][same])
        up = ca == cb + 1     # cam(a) = cam(b) + 1
        sa.append(idx[ii][up]); sb.append(idx[jj][up])
        dn = cb == ca + 1
        sa.append(idx[jj][dn]); sb.append(idx[ii][dn])
    cat = lambda lst: (np.concatenate(lst) if lst else np.zeros(0, np.int32))
    da, db, sa, sb = cat(da), cat(db), cat(sa), cat(sb)
    dw = np.where(da == db, 0.5, 1.0).astype(dtype)

    # keep at least one (zero-weight) entry so segment ops have static shape
    if da.size == 0:
        da = db = np.zeros(1, np.int32); dw = np.zeros(1, dtype)
    if sa.size == 0:
        sa = sb = np.zeros(1, np.int32)
        sw = np.zeros(1, dtype)
    else:
        sw = np.ones(sa.shape[0], dtype)
    return BandPairs(diag_a=jnp.asarray(da), diag_b=jnp.asarray(db),
                     diag_w=jnp.asarray(dw), super_a=jnp.asarray(sa),
                     super_b=jnp.asarray(sb), super_w=jnp.asarray(sw))


def make_tridiag_precond(D, E):
    """Block-tridiagonal preconditioner M = tridiag(S): block Cholesky
    factorization (one scan over cameras per linearization), application =
    PARALLEL-PREFIX bidiagonal substitutions. D (C,6,6) diagonal blocks,
    E (C-1,6,6) subdiagonal blocks S[c+1, c].

    The substitutions y_c = L_c^{-1}(r_c - F_c y_{c-1}) are affine
    recurrences; expressed as maps (A_c, b_c) with A_c = -L_c^{-1} F_c they
    compose associatively, so each apply is log2(C) rounds of batched 6x6
    matmuls (jax.lax.associative_scan) instead of 2(C-1) sequential scan
    steps: the sequential form's 2(C-1) dependent steps made the
    large-scale solve preconditioner-latency-bound."""

    L0 = cholesky_small(D[0])

    def fac_step(L_prev, inp):
        Dc, Ec = inp
        # F_c = E_c L_c^{-T}:  L_c F^T = E^T
        Ft = solve_lower_small(L_prev, jnp.swapaxes(Ec, -1, -2))
        F = jnp.swapaxes(Ft, -1, -2)
        Lc = cholesky_small(Dc - jnp.einsum("ik,jk->ij", F, F,
                                            precision=HIGHEST))
        return Lc, (Lc, F)

    _, (Ls, Fs) = jax.lax.scan(fac_step, L0, (D[1:], E))
    L = jnp.concatenate([L0[None], Ls])

    # affine-map coefficients, precomputed once (batched triangular solves):
    #   forward  y_c = A_c y_{c-1} + L_c^{-1} r_c,   A_c = -L_c^{-1} F_c
    #   backward z_c = B_c z_{c+1} + L_c^{-T} y_c,   B_c = -L_c^{-T} F_{c+1}^T
    zero1 = jnp.zeros((1, 6, 6), D.dtype)
    A = jnp.concatenate([zero1, -solve_lower_small(Ls, Fs)])
    B = -solve_lower_t_small(L[:-1], jnp.swapaxes(Fs, -1, -2))
    Brev = jnp.concatenate([zero1, B[::-1]])

    def affine_scan(As, bs):
        """Inclusive prefix of y_i = As_i y_{i-1} + bs_i (As_0 must be 0)."""
        def comb(lo, hi):
            A1, b1 = lo
            A2, b2 = hi
            return (jnp.einsum("...ij,...jk->...ik", A2, A1,
                               precision=HIGHEST),
                    jnp.einsum("...ij,...j->...i", A2, b1,
                               precision=HIGHEST) + b2)
        return jax.lax.associative_scan(comb, (As, bs))[1]

    def precond(r):
        c = solve_lower_small(L, r[..., None])[..., 0]        # (C,6)
        y = affine_scan(A, c)
        d = solve_lower_t_small(L, y[..., None])[..., 0]      # (C,6)
        return affine_scan(Brev, d[::-1])[::-1]

    return precond


def assemble_tridiag(Hpp_d, Hll_inv, W_obs, cam_idx, lm_idx, free,
                     band_pairs: BandPairs):
    """Damped, gauge-fixed diagonal + subdiagonal blocks of S via banded pair
    accumulation (exact blocks, O(band pairs) work)."""
    dtype = Hpp_d.dtype
    C = Hpp_d.shape[0]
    Y = jnp.einsum("nij,njk->nik", W_obs, Hll_inv[lm_idx], precision=HIGHEST)

    a, b, w = band_pairs.diag_a, band_pairs.diag_b, band_pairs.diag_w
    blk = jnp.einsum("pim,pjm->pij", Y[a], W_obs[b],
                     precision=HIGHEST) * w.astype(dtype)[:, None, None]
    M = jax.ops.segment_sum(blk, cam_idx[a], C)
    D = Hpp_d - (M + jnp.swapaxes(M, -1, -2))

    a, b, w = band_pairs.super_a, band_pairs.super_b, band_pairs.super_w
    blk = jnp.einsum("pim,pjm->pij", Y[a], W_obs[b],
                     precision=HIGHEST) * w.astype(dtype)[:, None, None]
    E = -jax.ops.segment_sum(blk, cam_idx[b], C)[:-1]       # E_c = S[c+1, c]

    # gauge: identity diagonal on fixed cameras, decouple adjacent E blocks
    eye6 = jnp.eye(6, dtype=dtype)
    fixedf = 1.0 - free
    D = D * free[:, None, None] + eye6[None] * fixedf[:, None, None]
    E = E * free[1:, None, None] * free[:-1, None, None]
    return D, E


def make_schur_matvec(Hpp_d, Hll_inv, W_obs, cam_idx, lm_idx, n_points):
    """Returns matvec(x (C,6)) -> (C,6) computing S x matrix-free."""

    def matvec(x):
        xc = x[cam_idx]                                              # (N,6)
        t = jnp.einsum("nij,ni->nj", W_obs, xc, precision=HIGHEST)   # (N,3)
        t = jax.ops.segment_sum(t, lm_idx, n_points)                 # (L,3)
        u = jnp.einsum("lij,lj->li", Hll_inv, t, precision=HIGHEST)  # (L,3)
        un = u[lm_idx]                                               # (N,3)
        y = jnp.einsum("nij,nj->ni", W_obs, un, precision=HIGHEST)   # (N,6)
        y = jax.ops.segment_sum(y, cam_idx, Hpp_d.shape[0])          # (C,6)
        return jnp.einsum("cij,cj->ci", Hpp_d, x, precision=HIGHEST) - y

    return matvec


def pcg(matvec, b, precond, *, iters=100, tol=1e-10):
    """Standard PCG with fixed max iterations + residual-norm early stop.
    b, x: (C,6) block vectors. precond(r) applies M^-1."""

    class CG(NamedTuple):
        x: jnp.ndarray
        r: jnp.ndarray
        z: jnp.ndarray
        p: jnp.ndarray
        rz: jnp.ndarray
        it: jnp.ndarray
        done: jnp.ndarray

    b_norm = jnp.sqrt(jnp.sum(b * b))
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    state = CG(x=x0, r=r0, z=z0, p=z0, rz=jnp.sum(r0 * z0),
               it=jnp.zeros((), jnp.int32), done=b_norm < tol)

    def cond(s):
        return (~s.done) & (s.it < iters)

    def body(s):
        Ap = matvec(s.p)
        pAp = jnp.sum(s.p * Ap)
        alpha = s.rz / jnp.maximum(pAp, 1e-30)
        x = s.x + alpha * s.p
        r = s.r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(s.rz, 1e-30)
        p = z + beta * s.p
        done = jnp.sqrt(jnp.sum(r * r)) < tol * jnp.maximum(b_norm, 1e-30)
        return CG(x=x, r=r, z=z, p=p, rz=rz_new, it=s.it + 1, done=done)

    out = jax.lax.while_loop(cond, body, state)
    return out.x, out.it


def solve_rcs_pcg(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx, lam, fixed_mask,
                  n_points, *, cg_iters=100, cg_tol=1e-8, band_pairs=None):
    """Drop-in replacement for the dense Schur reduction: solve the reduced
    camera system with PCG and back-substitute landmarks.

    Preconditioner: block-Jacobi on the damped pose blocks by default; pass
    `band_pairs=build_band_pairs(cam_idx, lm_idx)` to upgrade to the exact
    block-tridiagonal preconditioner (much faster CG convergence on
    trajectory problems where adjacent cameras co-observe landmarks).

    Returns (delta_pose (C,6), delta_point (L,3))."""
    dtype = gp.dtype
    C = gp.shape[0]

    def damp(H):
        d = jnp.maximum(jnp.diagonal(H, axis1=-2, axis2=-1), 1e-12)
        return H + lam * jax.vmap(jnp.diag)(d)

    Hpp_d = damp(Hpp)
    Hll_d = _damp_hll(Hll, lam)
    Hll_inv = _inv3x3(Hll_d)

    # rhs: b = -(gp - W Hll^-1 gl), with gauge rows zeroed
    u = jnp.einsum("lij,lj->li", Hll_inv, gl, precision=HIGHEST)
    y = jnp.einsum("nij,nj->ni", W_obs, u[lm_idx], precision=HIGHEST)
    y = jax.ops.segment_sum(y, cam_idx, C)
    b = -(gp - y)
    free = (~fixed_mask).astype(dtype)
    b = b * free[:, None]

    base_matvec = make_schur_matvec(Hpp_d, Hll_inv, W_obs, cam_idx, lm_idx, n_points)

    def matvec(x):
        # gauge projection: act on free cameras only, identity on fixed
        xf = x * free[:, None]
        y = base_matvec(xf) * free[:, None]
        return y + x * fixed_mask.astype(dtype)[:, None]

    if band_pairs is not None:
        D, E = assemble_tridiag(Hpp_d, Hll_inv, W_obs, cam_idx, lm_idx, free,
                                band_pairs)
        precond = make_tridiag_precond(D, E)
    else:
        # block-Jacobi preconditioner from the damped pose blocks
        eye6 = jnp.eye(6, dtype=dtype)
        M = Hpp_d * free[:, None, None] + eye6[None] * fixed_mask.astype(dtype)[:, None, None]

        def precond(r):
            return cho_solve_small(M, r)

    dp, n_iters = pcg(matvec, b, precond, iters=cg_iters, tol=cg_tol)

    # back-substitution
    t = jnp.einsum("nij,ni->nj", W_obs, dp[cam_idx], precision=HIGHEST)
    t = jax.ops.segment_sum(t, lm_idx, n_points)
    dl = jnp.einsum("lij,lj->li", Hll_inv, -gl - t, precision=HIGHEST)
    return dp, dl

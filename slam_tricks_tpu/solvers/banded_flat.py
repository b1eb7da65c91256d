"""Slot-major banded-direct BA — the large-C trajectory solver with ZERO
large gathers (round-3 redesign of the C >= 1024 path).

Profiling of the gather-table PCG path at C=1024/N=1.6M showed every
reduction bound by random-gather latency: each (N,)-scale gather-based
reduction, and every S-matvec of the 50 CG iterations per LM step, paid
per-row gather cost regardless of row width.

This module exploits what the large-C problem actually IS: a TRAJECTORY.
Each landmark is observed by a run of at most K consecutive cameras starting
at c0(l) (sliding-window / odometry visibility — reference problem shape:
st20 spiral, st20-g2o/src/src/sim_data.cpp:47-96, where track length is
bounded by the camera's field of view sweeping past the landmark). Two
consequences, both verified host-side by the builder:

  1. SLOT-MAJOR LAYOUT. Observations live in a (K, Lpad) grid: slot k of
     landmark l is its observation at camera c0(l)+k (weight 0 if missing).
     camera(k, l) = c0(l)+k is COMPUTED, not gathered; the landmark id is
     the position l itself. With landmarks sorted by c0 and padded so each
     c0-group is a multiple of B, every reduction becomes
        landmark-side: running sums over the K slots      (no reduction op)
        camera-side:   contiguous (LB,B) chunk-sums  ->  one (C,LB)x(LB,n)
                       one-hot matmul  ->  a row-roll by k
     and every "gather" of camera state is the same one-hot matmul applied
     to rolled (C, ...) arrays. NO gather or scatter touches an O(N) array.

  2. EXACT BANDED DIRECT SOLVE. bandwidth(S) = K-1, so grouping cameras
     into super-blocks of m = K makes the reduced camera system EXACTLY
     block-tridiagonal in (G, 6m, 6m) blocks. One block-tridiagonal Cholesky
     (lax.scan over G ~ C/K steps) + parallel-prefix substitutions solve it
     exactly — no CG loop, no preconditioner tuning, and better LM
     convergence than truncated PCG.

Same LM semantics as solvers/schur_flat.solve_ba_flat (damping, gauge,
Nielsen control — parity-tested). Replaces Ceres SPARSE_SCHUR / g2o
BlockSolver<6,3>+CSparse with marginalized landmarks for the trajectory
problem class (st20-g2o/src/include/test_ceres.h:143-145, test_g2o.h:94-135).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.manifolds import se3, so3
from slam_tricks_tpu.solvers.common import HIGHEST
from slam_tricks_tpu.solvers.schur import BAState, lm_accept
from slam_tricks_tpu.solvers.schur_flat import (_IJ3, _IJ6, _inv3x3_flat,
                                                _mat3vec_flat, _sym6_expand)

_SYM33 = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]


class BandedWork(NamedTuple):
    """Host-built slot-major problem layout (static visibility)."""
    uv: jnp.ndarray           # (K, 2, Lpad)
    weight: jnp.ndarray       # (K, Lpad)
    onehot: jnp.ndarray       # (LB, C) chunk -> c0 one-hot
    scatter_idx: jnp.ndarray  # (Lpad,) original landmark id; == L for padding
    gather_idx: jnp.ndarray   # (Lpad,) = scatter_idx clipped into [0, L)
    # chunk size B is implied: B = weight.shape[1] // onehot.shape[0]


def build_banded_work(obs, n_cams, n_points, dtype=np.float32, chunk=32,
                      max_band=32):
    """Validate trajectory structure and build the slot-major layout.

    Raises ValueError if the problem is not trajectory-structured (a landmark
    observed on non-consecutive cameras, a duplicate (landmark, camera)
    observation, or band K > max_band) — callers fall back to the general
    PCG path (solvers/pcg_flat)."""
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
    c0 = np.full(L, C, np.int64)
    cmax = np.full(L, -1, np.int64)
    np.minimum.at(c0, lm_v, cam_v)
    np.maximum.at(cmax, lm_v, cam_v)
    observed = cmax >= 0
    span = np.where(observed, cmax - c0 + 1, 1)
    K = int(span.max()) if observed.any() else 1
    if K > max_band:
        raise ValueError(f"band {K} > max_band {max_band}")
    n_slots = np.zeros(L, np.int64)
    np.add.at(n_slots, lm_v, 1)
    # consecutive <=> every camera in [c0, cmax] hit exactly once is NOT
    # required; only that span fits the band. Gaps are fine (weight-0 slots).
    c0 = np.where(observed, c0, 0)

    # landmarks sorted by c0, each c0 group padded to a multiple of `chunk`
    obs_lms = np.flatnonzero(observed)
    order = obs_lms[np.argsort(c0[obs_lms], kind="stable")]
    counts = np.bincount(c0[order], minlength=C)
    padded = counts + (-counts) % chunk
    Lpad = max(int(padded.sum()), chunk)
    LB = Lpad // chunk
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(padded, out=starts[1:])
    # slot of each real landmark inside the padded layout
    gstart = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=gstart[1:])
    pos = starts[c0[order]] + (np.arange(order.shape[0]) - gstart[c0[order]])

    scatter_idx = np.full(Lpad, L, np.int64)
    scatter_idx[pos] = order
    slot_c0 = np.zeros(Lpad, np.int64)
    for c in range(C):                      # fill padded entries' c0 too
        slot_c0[starts[c]:starts[c + 1]] = c
    chunk_c0 = slot_c0.reshape(LB, chunk)[:, 0]
    assert np.all(slot_c0.reshape(LB, chunk) == chunk_c0[:, None])

    # slot-major measurement grid
    uvg = np.zeros((K, 2, Lpad), dtype)
    wg = np.zeros((K, Lpad), dtype)
    lm_slot = np.full(L, Lpad, np.int64)
    lm_slot[scatter_idx[pos]] = pos
    k_of = cam_v - c0[lm_v]
    col = lm_slot[lm_v]
    uvg[k_of, 0, col] = uv[valid, 0].astype(dtype)
    uvg[k_of, 1, col] = uv[valid, 1].astype(dtype)
    wg[k_of, col] = w[valid].astype(dtype)

    onehot = np.zeros((LB, C), dtype)
    onehot[np.arange(LB), chunk_c0] = 1
    return BandedWork(
        uv=jnp.asarray(uvg), weight=jnp.asarray(wg),
        onehot=jnp.asarray(onehot),
        scatter_idx=jnp.asarray(scatter_idx.astype(np.int32)),
        gather_idx=jnp.asarray(np.minimum(scatter_idx, L - 1).astype(np.int32)))


def _affine_scan(As, bs):
    """Inclusive prefix of y_i = As_i y_{i-1} + bs_i (As_0 must be 0).
    bs may be (..., m) vectors or (..., m, q) multi-rhs blocks."""
    mat = bs.ndim == As.ndim
    op = "...ij,...jk->...ik" if mat else "...ij,...j->...i"

    def comb(lo, hi):
        A1, b1 = lo
        A2, b2 = hi
        return (jnp.einsum("...ij,...jk->...ik", A2, A1, precision=HIGHEST),
                jnp.einsum(op, A2, b1, precision=HIGHEST) + b2)
    return jax.lax.associative_scan(comb, (As, bs))[1]


class TridiagFactor(NamedTuple):
    """Stored block-Cholesky factorization of an SPD block-tridiagonal
    matrix T = Lt Lt^T (Lt block lower-bidiagonal: diagonal blocks `L`,
    sub-diagonal blocks `F`). Unlike cyclic reduction (which re-derives its
    elimination every solve), the stored factor supports repeated and
    NUMERICALLY STABLE substitutions: the Woodbury paths need Lt^-1 U with
    bounded entries so the capacitance Gram matrix I -/+ (Lt^-1 U)^T(Lt^-1 U)
    is computed WITHOUT catastrophic cancellation (measured: the naive
    I - U^T T^-1 U form in f32 had eigenvalues at -1e3 where exact
    arithmetic guarantees (0, 1])."""
    L: jnp.ndarray       # (G, m, m) lower-triangular diagonal blocks
    F: jnp.ndarray       # (G-1, m, m) sub-diagonal blocks (block (g, g-1))


def block_tridiag_factor(D, E):
    """Factor the SPD block-tridiagonal (D (G,m,m), E (G-1,m,m) sub-diag)
    into a TridiagFactor via the sequential block-Cholesky scan."""
    chol = jax.lax.linalg.cholesky
    tri = partial(jax.lax.linalg.triangular_solve, left_side=True, lower=True)
    G, m, _ = D.shape
    L0 = chol(D[0])
    if G == 1:
        return TridiagFactor(L=L0[None], F=jnp.zeros((0, m, m), D.dtype))

    def step(Lp, DE):
        Dg, Eg = DE
        Ft = tri(Lp, jnp.swapaxes(Eg, -1, -2))        # F^T = Lp^{-1} E^T
        F = jnp.swapaxes(Ft, -1, -2)
        Lg = chol(Dg - jnp.einsum("ik,jk->ij", F, F, precision=HIGHEST))
        return Lg, (Lg, F)

    _, (Ls, Fs) = jax.lax.scan(step, L0, (D[1:], E))
    return TridiagFactor(L=jnp.concatenate([L0[None], Ls]), F=Fs)


def block_tridiag_factor_extend(fac: TridiagFactor, D, E, g0):
    """Incrementally extend/update a stored factor (the iSAM-role online
    primitive, solvers/incremental.py): super-blocks [g0:] of the SPD
    block-tridiagonal (D (G,m,m), E (G-1,m,m)) are new or changed while
    blocks [:g0] and couplings E[:g0-1] are UNCHANGED from the matrix
    `fac` factored (the caller's contract — exactness-tested in
    tests/test_incremental.py). The block-Cholesky recursion only feeds
    forward, so the stored prefix is reused verbatim and the sequential
    scan — the factorization's LATENCY chain — runs over the O(G - g0)
    tail instead of all G super-blocks. g0 must be a static python int."""
    chol = jax.lax.linalg.cholesky
    tri = partial(jax.lax.linalg.triangular_solve, left_side=True, lower=True)
    G, m, _ = D.shape
    g0 = int(g0)
    if g0 <= 0:
        return block_tridiag_factor(D, E)
    if g0 >= G:
        return TridiagFactor(L=fac.L[:G], F=fac.F[:max(G - 1, 0)])

    def step(Lp, DE):
        Dg, Eg = DE
        Ft = tri(Lp, jnp.swapaxes(Eg, -1, -2))
        F = jnp.swapaxes(Ft, -1, -2)
        Lg = chol(Dg - jnp.einsum("ik,jk->ij", F, F, precision=HIGHEST))
        return Lg, (Lg, F)

    _, (Ls, Fs) = jax.lax.scan(step, fac.L[g0 - 1], (D[g0:], E[g0 - 1:]))
    return TridiagFactor(L=jnp.concatenate([fac.L[:g0], Ls]),
                         F=jnp.concatenate([fac.F[:g0 - 1], Fs]))


def tridiag_forward(fac: TridiagFactor, R):
    """Lt^-1 R by parallel-prefix forward substitution; R (G, m) or
    (G, m, q)."""
    tri = partial(jax.lax.linalg.triangular_solve, left_side=True, lower=True)
    G, m, _ = fac.L.shape
    if G == 1:
        return tri(fac.L[0], R[0])[None] if R.ndim == 3 else \
            tri(fac.L[0], R[0][:, None])[:, 0][None]
    zero1 = jnp.zeros((1, m, m), fac.L.dtype)
    A = jnp.concatenate([zero1, -tri(fac.L[1:], fac.F)])
    c = tri(fac.L, R if R.ndim == 3 else R[..., None])
    y = _affine_scan(A, c)
    return y if R.ndim == 3 else y[..., 0]


def tridiag_backward(fac: TridiagFactor, Y):
    """Lt^-T Y by reversed parallel-prefix substitution; Y (G, m) or
    (G, m, q)."""
    tri = partial(jax.lax.linalg.triangular_solve, left_side=True, lower=True)
    G, m, _ = fac.L.shape
    Ym = Y if Y.ndim == 3 else Y[..., None]
    if G == 1:
        out = tri(fac.L[0], Ym[0], transpose_a=True)[None]
        return out if Y.ndim == 3 else out[..., 0]
    d = tri(fac.L, Ym, transpose_a=True)
    zero1 = jnp.zeros((1, m, m), fac.L.dtype)
    B = -tri(fac.L[:-1], jnp.swapaxes(fac.F, -1, -2), transpose_a=True)
    Brev = jnp.concatenate([zero1, B[::-1]])
    out = _affine_scan(Brev, d[::-1])[::-1]
    return out if Y.ndim == 3 else out[..., 0]


def _batched_spd_inverse(A):
    """(B, m, m) SPD inverses via batched Cholesky: A^-1 = X^T X, X=L^-1."""
    Lc = jax.lax.linalg.cholesky(A)
    eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
    X = jax.lax.linalg.triangular_solve(Lc, eye, left_side=True, lower=True)
    return jnp.einsum("...ki,...kj->...ij", X, X, precision=HIGHEST)


def block_tridiag_solve_cr(D, E, r):
    """Solve the SPD block-tridiagonal system by BATCHED CYCLIC REDUCTION:
    eliminate the odd-indexed blocks (all of them at once -- batched inverses
    and matmuls), recurse on the half-size even system, back-substitute.
    log2(G) rounds of ~8 batched ops replace G sequential scan steps --
    measured 128x48: scan 3.2-4.5 ms, cyclic reduction ~0.3-0.5 ms.
    CR on an SPD block-tridiagonal matrix is block Cholesky under the
    odd-even (nested-dissection) permutation, so the intermediate systems
    stay SPD and the recursion is stable.

    r may be (G, m) -- one rhs -- or (G, m, q) for a MULTI-RHS solve (the
    Woodbury loop-closure path solves S_sb^-1 [b | U] in one factorization
    sweep, solvers/loop_flat.py); matmul-shaped rhs updates keep the extra
    q columns as matmuls."""
    vec = r.ndim == 2
    R = r[..., None] if vec else r
    X = _block_tridiag_cr_multi(D, E, R)
    return X[..., 0] if vec else X


def _block_tridiag_cr_multi(D, E, r, dense_tail=8):
    """Cyclic-reduction solve with r of shape (G, m, q) — ITERATIVE over the
    log2(G) levels (a recursive formulation traced fine but tripped CPython
    3.12's fixed C-recursion ceiling when embedded deep inside fori_loop/jit
    tracing stacks — observed as RecursionError in the bench process).

    dense_tail: stop the reduction once G <= dense_tail and solve the
    remaining block-tridiagonal system with ONE dense Cholesky — each CR
    level is a chain of small batched linalg launches whose LATENCY (not
    flops) dominates at production shapes, so trading the last ~3 levels
    for a single (tail*m)^2 factorization is a measured win."""
    G, m, _ = D.shape
    q = r.shape[-1]
    dtype = D.dtype
    mmb = lambda a, b: jnp.einsum("...ij,...jk->...ik", a, b,
                                  precision=HIGHEST)
    T = lambda a: jnp.swapaxes(a, -1, -2)

    # ---- forward elimination: halve until the dense tail ----
    stack = []          # per level: (G0, Mo, MoEe, MoEoT, Mro)
    while G > max(dense_tail, 1):
        G0 = G
        if G % 2:                      # pad to even with a decoupled identity
            D = jnp.concatenate([D, jnp.eye(m, dtype=dtype)[None]], axis=0)
            E = jnp.concatenate([E, jnp.zeros((1, m, m), dtype)], axis=0)
            r = jnp.concatenate([r, jnp.zeros((1, m, q), dtype)], axis=0)
            G += 1
        H = G // 2
        Ep = jnp.concatenate([E, jnp.zeros((1, m, m), dtype)],
                             axis=0)            # (G, m, m); E[G-1] = 0
        De, Do = D[0::2], D[1::2]               # (H, m, m) each
        Ee, Eo = Ep[0::2], Ep[1::2]             # E[2k], E[2k+1]; (H, m, m)
        re, ro = r[0::2], r[1::2]

        Mo = _batched_spd_inverse(Do)           # (H, m, m)
        MoEe = mmb(Mo, Ee)                      # M_{2k+1} E_{2k}
        MoEoT = mmb(Mo, T(Eo))                  # M_{2k+1} E_{2k+1}
        Mro = mmb(Mo, ro)

        # even diagonal updates: from i = j+1 (always) and i = j-1 (j >= 2)
        up = mmb(T(Ee), MoEe)                   # E_{2k}^T M E_{2k}
        dn = mmb(Eo, MoEoT)                     # E_{2k+1} M E_{2k+1}^T
        zero1 = jnp.zeros((1, m, m), dtype)
        D = De - up - jnp.concatenate([zero1, dn[:-1]], axis=0)
        # new couplings between even 2k and 2k+2: -E_{2k+1} M E_{2k}
        E = -mmb(Eo, MoEe)[:H - 1]
        zv = jnp.zeros((1, m, q), dtype)
        r = (re - mmb(T(Ee), Mro)
             - jnp.concatenate([zv, mmb(Eo, Mro)[:-1]], axis=0))
        stack.append((G0, MoEe, MoEoT, Mro))
        G = H

    if G == 1:
        Lc = jax.lax.linalg.cholesky(D[0])
        t = jax.lax.linalg.triangular_solve(Lc, r[0], left_side=True,
                                            lower=True)
        x = jax.lax.linalg.triangular_solve(
            Lc, t, left_side=True, lower=True, transpose_a=True)[None]
    else:
        # dense tail: one (G*m, G*m) SPD solve of the remaining tridiag
        n = G * m
        A = jnp.zeros((G, m, G, m), dtype)
        A = A.at[jnp.arange(G), :, jnp.arange(G), :].set(D)
        if G > 1:
            gi = jnp.arange(G - 1)
            A = A.at[gi + 1, :, gi, :].set(E)
            A = A.at[gi, :, gi + 1, :].set(T(E))
        cf = jax.scipy.linalg.cho_factor(A.reshape(n, n), lower=True)
        x = jax.scipy.linalg.cho_solve(cf, r.reshape(n, q)).reshape(G, m, q)

    # ---- back-substitution through the levels ----
    zv = jnp.zeros((1, m, q), dtype)
    for G0, MoEe, MoEoT, Mro in reversed(stack):
        xe = x                                   # (H, m, q) even solutions
        xe_next = jnp.concatenate([xe[1:], zv], axis=0)
        xo = Mro - mmb(MoEe, xe) - mmb(MoEoT, xe_next)
        x = jnp.stack([xe, xo], axis=1).reshape(2 * xe.shape[0], m, q)[:G0]
    return x


def block_tridiag_solve_scan(D, E, r):
    """Solve the SPD block-tridiagonal system (D diag (G,m,m), E sub-diag
    M[g+1,g] (G-1,m,m)) for r (G,m): block Cholesky (lax.scan over G) +
    PARALLEL-PREFIX bidiagonal substitutions (the m=6 version of this lives
    in solvers/pcg.make_tridiag_precond; here m = 6K is large enough that
    the batched lax.linalg primitives beat trace-time unrolling)."""
    chol = jax.lax.linalg.cholesky
    tri = partial(jax.lax.linalg.triangular_solve, left_side=True, lower=True)

    L0 = chol(D[0])

    def step(Lp, DE):
        Dg, Eg = DE
        Ft = tri(Lp, jnp.swapaxes(Eg, -1, -2))        # F^T = Lp^{-1} E^T
        F = jnp.swapaxes(Ft, -1, -2)
        Lg = chol(Dg - jnp.einsum("ik,jk->ij", F, F, precision=HIGHEST))
        return Lg, (Lg, F)

    _, (Ls, Fs) = jax.lax.scan(step, L0, (D[1:], E))
    Lall = jnp.concatenate([L0[None], Ls])

    m = D.shape[-1]
    zero1 = jnp.zeros((1, m, m), D.dtype)
    A = jnp.concatenate([zero1, -tri(Ls, Fs)])
    c = tri(Lall, r[..., None])[..., 0]
    y = _affine_scan(A, c)
    d = tri(Lall, y[..., None], transpose_a=True)[..., 0]
    B = -tri(Lall[:-1], jnp.swapaxes(Fs, -1, -2), transpose_a=True)
    Brev = jnp.concatenate([zero1, B[::-1]])
    return _affine_scan(Brev, d[::-1])[::-1]


def block_tridiag_solve(D, E, r, method="cr"):
    """Dispatch: 'cr' (batched cyclic reduction, the default) or 'scan'
    (sequential block Cholesky + prefix substitutions)."""
    if method == "cr":
        return block_tridiag_solve_cr(D, E, r)
    return block_tridiag_solve_scan(D, E, r)


def _linearize_slot(Rk, tk, points, uv_k, w_k, chunk, loss=None):
    """Linearize slot k: Rk (LB,9), tk (LB,3) chunk-broadcast camera state;
    points (Lpad,3); uv_k (2,Lpad); w_k (Lpad,). Returns the same column
    families as schur_flat._linearize_flat, all (Lpad,)."""
    LB = Rk.shape[0]
    Lpad = points.shape[0]
    bc = lambda col: jnp.broadcast_to(col[:, None],
                                      (LB, chunk)).reshape(Lpad)
    r_ = [bc(Rk[:, j]) for j in range(9)]
    tn = [bc(tk[:, j]) for j in range(3)]
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    x = r_[0] * px + r_[1] * py + r_[2] * pz + tn[0]
    y = r_[3] * px + r_[4] * py + r_[5] * pz + tn[1]
    z = r_[6] * px + r_[7] * py + r_[8] * pz + tn[2]
    # weight-0 slots may hit arbitrary camera/point combos (incl. z ~ 0);
    # keep them finite so 0 * inf never makes a NaN
    z = jnp.where(w_k > 0, z, 1.0)
    iz = 1.0 / z
    u = x * iz
    v = y * iz
    d0 = u - uv_k[0]
    d1 = v - uv_k[1]
    if loss is None:
        sw = jnp.sqrt(w_k)
        cost_col = 0.5 * w_k * (d0 * d0 + d1 * d1)
    else:
        sqn = d0 * d0 + d1 * d1
        sw = jnp.sqrt(w_k * loss.weight(sqn))
        cost_col = 0.5 * w_k * loss.rho(sqn)
    r0 = d0 * sw
    r1 = d1 * sw
    sziz = sw * iz
    jl0 = [(r_[j] - u * r_[6 + j]) * sziz for j in range(3)]
    jl1 = [(r_[3 + j] - v * r_[6 + j]) * sziz for j in range(3)]
    jo0 = [jl0[2] * py - jl0[1] * pz,
           jl0[0] * pz - jl0[2] * px,
           jl0[1] * px - jl0[0] * py]
    jo1 = [jl1[2] * py - jl1[1] * pz,
           jl1[0] * pz - jl1[2] * px,
           jl1[1] * px - jl1[0] * py]
    zero = jnp.zeros_like(x)
    jt0 = [sziz, zero, -u * sziz]
    jt1 = [zero, sziz, -v * sziz]
    jp0 = jo0 + jt0
    jp1 = jo1 + jt1
    return (r0, r1), (jp0, jp1), (jl0, jl1), cost_col


def _cam_accum(cols, k, onehot, chunk):
    """Chunk-sum (Lpad,) columns, one-hot-reduce to per-c0 rows, roll by k
    (camera = c0 + k). Wrapped rows only ever receive weight-0 zeros."""
    LB = onehot.shape[0]
    P = jnp.stack([c.reshape(LB, chunk).sum(axis=1) for c in cols], axis=1)
    part = jax.lax.dot_general(onehot, P, (((0,), (0,)), ((), ())),
                               precision=HIGHEST)            # (C, n)
    return jnp.roll(part, k, axis=0)


def _cam_broadcast(rows, k, onehot):
    """Per-chunk camera-state rows for slot k: onehot @ roll(rows, -k)."""
    return jax.lax.dot_general(onehot, jnp.roll(rows, -k, axis=0),
                               (((1,), (0,)), ((), ())),
                               precision=HIGHEST)            # (LB, n)


def _banded_quantities(poses, points_s, bw: BandedWork, C, loss=None,
                       psum_axis=None):
    """Linearize + assemble in slot-major layout. Returns
    (Hpp_flat (C,21), gp (C,6), Hll 6x(Lpad,), gl (3,Lpad), W (K,18,Lpad),
    cost).

    psum_axis: inside shard_map with the landmark-chunk axis split across
    devices (parallel/banded_dist.py), the camera-side accumulation is a
    per-device partial — ONE psum of (C,28) makes Hpp/gp/cost replicated
    while every landmark-side quantity stays shard-local."""
    K = bw.weight.shape[0]
    Lpad = bw.weight.shape[1]
    chunk = Lpad // bw.onehot.shape[0]
    dtype = points_s.dtype
    R12 = jnp.concatenate([poses.R.reshape(C, 9), poses.t], axis=1)

    cam_red = jnp.zeros((C, 28), dtype)
    Hll = [jnp.zeros(Lpad, dtype) for _ in range(6)]
    gl = [jnp.zeros(Lpad, dtype) for _ in range(3)]
    Wk = []
    for k in range(K):
        Rt = _cam_broadcast(R12, k, bw.onehot)               # (LB, 12)
        (r0, r1), (jp0, jp1), (jl0, jl1), cost_col = _linearize_slot(
            Rt[:, :9], Rt[:, 9:], points_s, bw.uv[k], bw.weight[k],
            chunk, loss=loss)
        d2 = lambda a0, a1, b0, b1: a0 * b0 + a1 * b1
        cols = [d2(jp0[i], jp1[i], jp0[j], jp1[j]) for (i, j) in _IJ6]
        cols += [d2(jp0[i], jp1[i], r0, r1) for i in range(6)]
        cols += [cost_col]
        cam_red = cam_red + _cam_accum(cols, k, bw.onehot, chunk)
        for n, (i, j) in enumerate(_IJ3):
            Hll[n] = Hll[n] + d2(jl0[i], jl1[i], jl0[j], jl1[j])
        for j in range(3):
            gl[j] = gl[j] + d2(jl0[j], jl1[j], r0, r1)
        Wk.append(jnp.stack([d2(jp0[i], jp1[i], jl0[j], jl1[j])
                             for i in range(6) for j in range(3)]))
    W = jnp.stack(Wk)                                        # (K, 18, Lpad)
    if psum_axis is not None:
        cam_red = jax.lax.psum(cam_red, psum_axis)
    Hpp_flat = cam_red[:, :21]
    gp = cam_red[:, 21:27]
    cost = jnp.sum(cam_red[:, 27])
    return Hpp_flat, gp, Hll, jnp.stack(gl), W, cost


def _assemble_bands(Hpp_flat, Hll, W, lam, fixed_mask, bw: BandedWork, C,
                    psum_axis=None):
    """Damped, gauge-fixed band blocks of the reduced camera system plus the
    landmark-inverse columns. Returns (bands list of (C,6,6), hinv, dpp,
    dll, free)."""
    dtype = Hpp_flat.dtype
    K = W.shape[0]
    Lpad = W.shape[2]
    chunk = Lpad // bw.onehot.shape[0]

    dpp = [jnp.maximum(Hpp_flat[:, k], 1e-12)
           for k, (i, j) in enumerate(_IJ6) if i == j]
    dll = [jnp.maximum(Hll[k], 1e-12) for k, (i, j) in enumerate(_IJ3)
           if i == j]
    Hpp_d = _sym6_expand(Hpp_flat)
    di = jnp.arange(6)
    Hpp_d = Hpp_d.at[:, di, di].add(lam * jnp.stack(dpp, axis=1))
    empty = (Hll[0] + Hll[3] + Hll[5]) <= 0.0
    Hll_d = [jnp.where(empty, 1.0 if k in (0, 3, 5) else 0.0,
                       Hll[k] + (lam * dll[{0: 0, 3: 1, 5: 2}[k]]
                                 if k in (0, 3, 5) else 0.0))
             for k in range(6)]
    hinv = _inv3x3_flat(Hll_d)                               # 6 x (Lpad,)

    free = (~fixed_mask).astype(dtype)

    # Y(k) = W(k) Hll^-1 : (K, 18, Lpad) columns
    yo = [[sum(W[k, i * 3 + m] * hinv[_SYM33[m][j]] for m in range(3))
           for i in range(6) for j in range(3)] for k in range(K)]

    # band blocks: band[o][c] = S[c+o, c] contribution -sum Y(k+o) W(k)^T
    bands = []
    for o in range(K):
        acc = jnp.zeros((C, 36), dtype)
        for k in range(K - o):
            cols = [sum(yo[k + o][i * 3 + j] * W[k, i2 * 3 + j]
                        for j in range(3))
                    for i in range(6) for i2 in range(6)]
            acc = acc + _cam_accum(cols, k, bw.onehot, chunk)
        bands.append(acc)
    if psum_axis is not None:
        bands = list(jax.lax.psum(jnp.stack(bands), psum_axis))
    bands = [-bo.reshape(C, 6, 6) for bo in bands]
    bands[0] = bands[0] + Hpp_d

    # gauge: zero rows/cols of fixed cameras, unit diagonal
    eye6 = jnp.eye(6, dtype=dtype)
    bands[0] = (bands[0] * (free * free)[:, None, None]
                + eye6[None] * (1.0 - free)[:, None, None])
    for o in range(1, K):
        bands[o] = bands[o] * (jnp.roll(free, -o) * free)[:, None, None]
        # rows c >= C-o of band o are padding (S[c+o,c] needs c+o < C)
        mask = (jnp.arange(C) < C - o).astype(dtype)
        bands[o] = bands[o] * mask[:, None, None]
    return bands, hinv, dpp, dll, free


def _group_superblocks(bands, C, K, dtype):
    """Group band blocks into the super-block tridiagonal (Dm (G,m,m),
    Em (G-1,m,m) or None), padding cameras to a multiple of Kb = max(K,2)
    with identity diagonal blocks."""
    eye6 = jnp.eye(6, dtype=dtype)
    Kb = max(K, 2)
    G = -(-C // Kb)
    Cp = G * Kb
    padc = Cp - C
    if padc:
        z6 = jnp.zeros((padc, 6, 6), dtype)
        bands = [jnp.concatenate([bo, z6], axis=0) for bo in bands]
        bands[0] = bands[0].at[C:, :, :].set(eye6[None])
    if K < Kb:  # K == 1: keep a zero first off-diagonal band for grouping
        bands = bands + [jnp.zeros((Cp, 6, 6), dtype)]

    m = 6 * Kb
    # D'[g] (m,m): entry (r+o, r) from bands[o][g*Kb + r], r+o < Kb
    Dg = jnp.zeros((G, Kb, Kb, 6, 6), dtype)
    Eg = jnp.zeros((G - 1, Kb, Kb, 6, 6), dtype) if G > 1 else None
    for o in range(min(len(bands), Kb)):
        blk = bands[o].reshape(G, Kb, 6, 6)
        for r in range(Kb - o):
            Dg = Dg.at[:, r + o, r].set(blk[:, r])
            if o > 0:
                Dg = Dg.at[:, r, r + o].set(
                    jnp.swapaxes(blk[:, r], -1, -2))
        if G > 1:
            for r in range(Kb - o, Kb):
                # row r+o lands in the next super-block at r+o-Kb
                Eg = Eg.at[:, r + o - Kb, r].set(blk[:-1, r])
    Dm = Dg.transpose(0, 1, 3, 2, 4).reshape(G, m, m)
    Em = (Eg.transpose(0, 1, 3, 2, 4).reshape(G - 1, m, m)
          if G > 1 else None)
    return Dm, Em, G, Kb, Cp


def _solve_banded(Hpp_flat, gp, Hll, gl, W, lam, fixed_mask, bw: BandedWork,
                  C, psum_axis=None):
    """Damped, gauge-fixed EXACT solve of the reduced camera system via the
    super-block tridiagonal factorization; landmark back-substitution.

    psum_axis: band blocks and the rhs camera reduction are per-device
    partials — two psums (K*(C,36) stacked + (C,6)); the super-block
    factorization/solve is replicated and the landmark back-substitution
    stays local."""
    dtype = gp.dtype
    K = W.shape[0]
    Lpad = W.shape[2]
    chunk = Lpad // bw.onehot.shape[0]

    bands, hinv, dpp, dll, free = _assemble_bands(
        Hpp_flat, Hll, W, lam, fixed_mask, bw, C, psum_axis=psum_axis)

    # rhs: b = -(gp - W Hll^-1 gl)
    u = _mat3vec_flat(hinv, [gl[0], gl[1], gl[2]])           # 3 x (Lpad,)
    y = jnp.zeros((C, 6), dtype)
    for k in range(K):
        cols = [sum(W[k, i * 3 + j] * u[j] for j in range(3))
                for i in range(6)]
        y = y + _cam_accum(cols, k, bw.onehot, chunk)
    if psum_axis is not None:
        y = jax.lax.psum(y, psum_axis)
    b = -(gp - y) * free[:, None]

    Dm, Em, G, Kb, Cp = _group_superblocks(bands, C, K, dtype)
    m = 6 * Kb
    if Cp > C:
        b = jnp.concatenate([b, jnp.zeros((Cp - C, 6), dtype)], axis=0)
    rm = b.reshape(G, m)
    if G > 1:
        dp = block_tridiag_solve(Dm, Em, rm).reshape(Cp, 6)[:C]
    else:
        Lc = jax.lax.linalg.cholesky(Dm[0])
        t1 = jax.lax.linalg.triangular_solve(Lc, rm[0][:, None],
                                             left_side=True, lower=True)
        dp = jax.lax.linalg.triangular_solve(
            Lc, t1, left_side=True, lower=True,
            transpose_a=True)[:, 0].reshape(Cp, 6)[:C]

    # landmark back-substitution: dl = Hll^-1 (-gl - sum_k W(k)^T dp[c0+k])
    t = [jnp.zeros(Lpad, dtype) for _ in range(3)]
    for k in range(K):
        dpk = _cam_broadcast(dp * free[:, None], k, bw.onehot)  # (LB, 6)
        bcast = lambda col: jnp.broadcast_to(
            col[:, None], (bw.onehot.shape[0], chunk)).reshape(Lpad)
        dcols = [bcast(dpk[:, i]) for i in range(6)]
        for j in range(3):
            t[j] = t[j] + sum(W[k, i * 3 + j] * dcols[i] for i in range(6))
    rhs = [-gl[j] - t[j] for j in range(3)]
    dl = jnp.stack(_mat3vec_flat(hinv, rhs), axis=1)         # (Lpad, 3)
    return dp, dl, jnp.stack(dpp, axis=1), jnp.stack(dll, axis=1)


def solve_ba_banded(poses0, points0, bw: BandedWork, *, fixed_mask=None,
                    max_iters=30, lambda_init=1e-4, xtol=1e-12, loss=None,
                    psum_axis=None, slot_points=False):
    """LM bundle adjustment on the slot-major banded layout. Identical
    semantics/trajectory to schur_flat.solve_ba_flat (parity-tested); exact
    linear solves every iteration. `points0` is in ORIGINAL landmark order
    ((L,3)); so is the returned state's `.points`.

    psum_axis: run this EXACT solver inside shard_map with the landmark
    chunks split across devices (parallel/banded_dist.py): `bw` is the
    device-local slice, camera-side accumulations and scalar reductions are
    psummed, landmark state stays shard-local. slot_points=True returns
    `.points` in LOCAL slot order (Lpad,3) instead of scattering to the
    global landmark order (the distributed wrapper scatters once outside)."""
    C = poses0.t.shape[0]
    L = points0.shape[0]
    dtype = points0.dtype
    if fixed_mask is None:
        fixed_mask = jnp.zeros(C, bool).at[0].set(True)

    points_s0 = points0[bw.gather_idx]                       # (Lpad, 3) once

    def quantities(poses, points_s):
        Hpp, gp, Hll, gl, W, cost = _banded_quantities(
            poses, points_s, bw, C, loss=loss, psum_axis=psum_axis)
        return (Hpp, gp, tuple(Hll), gl, W), cost

    blocks0, cost0 = quantities(poses0, points_s0)
    state = (BAState(poses=poses0, points=points_s0, cost=cost0,
                     lam=jnp.asarray(lambda_init, dtype),
                     nu=jnp.asarray(2.0, dtype),
                     it=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool)),
             blocks0)

    def cond(sb):
        s, _ = sb
        return (~s.done) & (s.it < max_iters)

    def body(sb):
        s, blocks = sb
        Hpp, gp, Hll, gl, W = blocks
        dp, dl, diag_pp, diag_ll = _solve_banded(
            Hpp, gp, list(Hll), gl, W, s.lam, fixed_mask, bw, C,
            psum_axis=psum_axis)
        bad = jnp.any(~jnp.isfinite(dp)) | jnp.any(~jnp.isfinite(dl))
        if psum_axis is not None:
            # all devices must agree before touching the replicated state
            bad = jax.lax.psum(bad.astype(dtype), psum_axis) > 0
        dp_s = jnp.where(bad, jnp.zeros_like(dp), dp)
        dl_s = jnp.where(bad, jnp.zeros_like(dl), dl)
        poses_try = jax.vmap(lambda T, d: se3.SE3(
            so3.retract(T.R, d[:3]), T.t + d[3:]))(s.poses, dp_s)
        points_try = s.points + dl_s
        blocks_try, cost_try = quantities(poses_try, points_try)

        pred_l = jnp.sum(dl_s * (s.lam * diag_ll * dl_s - gl.T))
        step_l = jnp.sum(dl_s * dl_s)
        if psum_axis is not None:
            pred_l, step_l = jax.lax.psum((pred_l, step_l), psum_axis)
        pred = 0.5 * (jnp.sum(dp_s * (s.lam * diag_pp * dp_s - gp)) + pred_l)
        accept, lam_new, nu_new = lm_accept(s.cost, cost_try, s.lam, s.nu,
                                            pred, bad)
        sel = lambda a, b2: jnp.where(accept, a, b2)
        step_sq = jnp.sum(dp_s * dp_s) + step_l
        new_state = BAState(
            poses=jax.tree_util.tree_map(sel, poses_try, s.poses),
            points=sel(points_try, s.points),
            cost=sel(cost_try, s.cost), lam=lam_new, nu=nu_new, it=s.it + 1,
            done=accept & (step_sq < xtol * xtol))
        new_blocks = jax.tree_util.tree_map(sel, blocks_try, blocks)
        return (new_state, new_blocks)

    final, _ = jax.lax.while_loop(cond, body, state)
    if slot_points:
        return final
    points_out = points0.at[bw.scatter_idx].set(final.points, mode="drop")
    return final._replace(points=points_out)


def _takahashi_inverse_blocks(Dm, Em, G):
    """Diagonal P_g = (S^-1)_{g,g} and sub-diagonal Bsub_g = (S^-1)_{g+1,g}
    blocks of the block-tridiagonal inverse (two-sweep Takahashi)."""
    inv = _batched_spd_inverse
    mm = lambda a, b: jnp.einsum("ij,jk->ik", a, b, precision=HIGHEST)

    if G == 1:
        return inv(Dm), None
    M0 = inv(Dm[0][None])[0]

    def fwd(Mp, DE):
        Dg, Eg = DE
        T = mm(Eg, Mp)
        Mg = inv((Dg - jnp.einsum("ik,jk->ij", T, Eg,
                                  precision=HIGHEST))[None])[0]
        return Mg, Mg

    _, Ms = jax.lax.scan(fwd, M0, (Dm[1:], Em))
    M = jnp.concatenate([M0[None], Ms])

    def bwd(Pn, ME):
        Mg, Eg = ME
        T = mm(jnp.swapaxes(Eg, 0, 1), Pn)          # E_g^T P_{g+1}
        Pg = Mg + mm(mm(Mg, mm(T, Eg)), Mg)
        return Pg, Pg

    _, Ps = jax.lax.scan(bwd, M[-1], (M[:-1], Em), reverse=True)
    P = jnp.concatenate([Ps, M[-1][None]])
    # (S^-1)_{g+1,g} = -P_{g+1} E_g M_g (block 2x2 inverse identity,
    # applied at each elimination step)
    Bsub = -jnp.einsum("gij,gjk,gkl->gil", P[1:], Em, M[:-1],
                       precision=HIGHEST)
    return P, Bsub


def _sinv_bands(P, Bsub, C, K, Kb, dtype):
    """(S^-1)[c+o, c] camera blocks for offsets o = 0..K-1 from the
    super-block diagonal/sub-diagonal inverse blocks. Returns list of
    (C, 6, 6) arrays (rows c >= C-o are zero-padded)."""
    G = P.shape[0]
    Pr = P.reshape(G, Kb, 6, Kb, 6)
    Br = (Bsub.reshape(G - 1, Kb, 6, Kb, 6) if Bsub is not None else None)
    out = []
    for o in range(K):
        rows = []
        for r in range(Kb):
            if r + o < Kb:
                blk = Pr[:, r + o, :, r, :]                  # (G, 6, 6)
            elif Br is not None:
                b = Br[:, r + o - Kb, :, r, :]               # (G-1, 6, 6)
                blk = jnp.concatenate(
                    [b, jnp.zeros((1, 6, 6), dtype)], axis=0)
            else:
                blk = jnp.zeros((G, 6, 6), dtype)
            rows.append(blk)
        band = jnp.stack(rows, axis=1).reshape(G * Kb, 6, 6)[:C]
        mask = (jnp.arange(C) < C - o).astype(dtype)
        out.append(band * mask[:, None, None])
    return out


def banded_pose_covariances(poses, points, bw: BandedWork, fixed_mask, *,
                            lam=0.0, loss=None):
    """Marginal 6x6 pose covariances at the solution for trajectory problems
    — the Ceres `Covariance` role at scales the dense path (covariance.py,
    O((6C)^3) + (C,L,6,3) memory) cannot reach.

    Exact diagonal blocks of S^-1 for the block-tridiagonal super-block
    system via the Takahashi two-sweep recursion:

      forward   M_g = (D_g - E_{g-1} M_{g-1} E_{g-1}^T)^{-1}
      backward  P_{G-1} = M_{G-1};  P_g = M_g + M_g E_g^T P_{g+1} E_g M_g

    (verified against the Woodbury identity at G=2). The (6K,6K) super-block
    diagonals contain every per-camera 6x6 marginal. Fixed cameras get zero.
    `points` must be in ORIGINAL landmark order (as returned by
    solve_ba_banded)."""
    cov, _ = banded_covariances(poses, points, bw, fixed_mask, lam=lam,
                                loss=loss, compute_landmarks=False)
    return cov


def banded_covariances(poses, points, bw: BandedWork, fixed_mask, *,
                       lam=0.0, loss=None, compute_landmarks=False):
    """(pose_cov (C,6,6), point_cov (L,3,3) or None) at the solution.

    Landmark marginals use the standard back-substitution identity
    Cov(l) = Hll^-1 + Hll^-1 W_l^T Sinv_l W_l Hll^-1 with Sinv_l the
    (span x span) camera block of S^-1 over landmark l's track — extracted
    from the Takahashi diagonal + sub-diagonal super-blocks (a track spans
    <= K consecutive cameras, so it crosses at most one super-block
    boundary). All per-landmark algebra is slot-major column arithmetic;
    the only gathers touch (C, 6, 6) band tables at CHUNK granularity."""
    C = poses.t.shape[0]
    L = points.shape[0]
    dtype = points.dtype
    points_s = points[bw.gather_idx]
    Hpp_flat, _, Hll, _, W, _ = _banded_quantities(poses, points_s, bw, C,
                                                   loss=loss)
    K = W.shape[0]
    Lpad = W.shape[2]
    chunk = Lpad // bw.onehot.shape[0]
    bands, hinv, _, _, free = _assemble_bands(
        Hpp_flat, Hll, W, jnp.asarray(lam, dtype), fixed_mask, bw, C)
    Dm, Em, G, Kb, Cp = _group_superblocks(bands, C, K, dtype)

    P, Bsub = _takahashi_inverse_blocks(Dm, Em, G)
    Pr = P.reshape(G, Kb, 6, Kb, 6)
    pose_cov = jax.vmap(lambda g: jax.vmap(lambda r: Pr[g, r, :, r, :])(
        jnp.arange(Kb)))(jnp.arange(G)).reshape(Cp, 6, 6)[:C]
    pose_cov = pose_cov * free[:, None, None]
    if not compute_landmarks:
        return pose_cov, None

    # ---- landmark marginals, slot-major ----
    sb = _sinv_bands(P, Bsub, Cp, K, Kb, dtype)       # offsets 0..K-1
    c0_chunk = jnp.argmax(bw.onehot, axis=1)          # (LB,)
    LB = c0_chunk.shape[0]

    def bc(col):                                      # (LB,) -> (Lpad,)
        return jnp.broadcast_to(col[:, None], (LB, chunk)).reshape(Lpad)

    # V(k) = W(k) Hll^-1 columns, masked at fixed cameras (their S^-1 rows
    # are spurious identity gauge blocks)
    freeCp = jnp.concatenate([free, jnp.zeros(Cp - C, dtype)])
    V = []
    for k in range(K):
        fk = bc(freeCp[jnp.clip(c0_chunk + k, 0, Cp - 1)])
        V.append([sum(W[k, i * 3 + m_] * hinv[_SYM33[m_][j]]
                      for m_ in range(3)) * fk
                  for i in range(6) for j in range(3)])

    # accumulate A[j,j'] = sum_{k,k',i,i'} V_k[i,j] Q_{k,k'}[i,i'] V_k'[i',j']
    A = [[jnp.zeros(Lpad, dtype) for _ in range(3)] for _ in range(3)]
    for k in range(K):
        for k2 in range(K):
            o = k - k2
            cam = jnp.clip(c0_chunk + min(k, k2), 0, Cp - 1)
            Qb = sb[abs(o)][cam]                      # (LB, 6, 6)
            # Q(k,k2) = (S^-1)[c0+k, c0+k2]: band gives [c+|o|, c];
            # transpose when k < k2
            if o < 0:
                Qb = jnp.swapaxes(Qb, -1, -2)
            q = [[bc(Qb[:, i, i2]) for i2 in range(6)] for i in range(6)]
            for j in range(3):
                t = [sum(V[k][i * 3 + j] * q[i][i2] for i in range(6))
                     for i2 in range(6)]
                for j2 in range(3):
                    A[j][j2] = A[j][j2] + sum(
                        t[i2] * V[k2][i2 * 3 + j2] for i2 in range(6))

    hcols = [[hinv[_SYM33[i][j]] for j in range(3)] for i in range(3)]
    cov_l = jnp.stack([jnp.stack([hcols[i][j] + A[i][j] for j in range(3)],
                                 axis=-1) for i in range(3)], axis=-2)
    observed = (jnp.sum(bw.weight, axis=0) > 0)[:, None, None]
    cov_l = cov_l * observed
    point_cov = jnp.zeros((L, 3, 3), dtype).at[bw.scatter_idx].set(
        cov_l, mode="drop")
    return pose_cov, point_cov

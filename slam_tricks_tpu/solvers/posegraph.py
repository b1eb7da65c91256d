"""SE(3) pose-graph optimization: LM over relative-pose factors.

The BASELINE "pose-graph optimization" config (no reference implementation
exists — st20's g2o usage is BA-only; this is the standard g2o/Ceres pose-graph
problem built on this framework's primitives, at the g2o-benchmark scale of
st20-g2o/src/include/test_g2o.h:94-135's role).

Two solvers:

- solve_pose_graph: dense (N,N,6,6) normal equations + Cholesky — exact and
  matmul-friendly for graphs up to a few hundred poses (the reference-grade
  comparison path).
- solve_pose_graph_chain: the 10k-100k-pose path. An odometry+loop-closure
  graph's Hessian is EXACTLY block-tridiagonal (chain edges couple i, i+1)
  plus one rank-6 PSD term per loop-closure edge: the edge Hessian
  [Ji Jj]^T[Ji Jj] restricted to rows/cols (i, j) is U_e U_e^T with
  U_e = P_i Ji^T + P_j Jj^T. So

      H + lam D  =  T  +  U U^T,     T block-tridiagonal SPD,
                                     U width 6 x (#loop edges)

  solved exactly by ONE multi-RHS substitution through the STORED
  block-Cholesky tridiagonal factor plus a (q,q) SPD Gram capacitance
  (Woodbury with a PLUS sign — loop edges ADD information, so
  I + Ut^T Ut is unconditionally SPD).
  Same machinery as the loop-closure BA path (solvers/loop_flat.py), applied
  to the pose-graph normal equations.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.manifolds import se3
from slam_tricks_tpu.residuals.posegraph import relative_se3_residual
from slam_tricks_tpu.solvers.common import HIGHEST


class PoseGraphState(NamedTuple):
    poses: se3.SE3
    cost: jnp.ndarray
    lam: jnp.ndarray
    nu: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


def _edge_linearize(poses, i_idx, j_idx, Z, sqrt_info):
    """Per-edge residual + Jacobians wrt tangent perturbations of Ti, Tj.
    Returns (r (E,6), Ji (E,6,6), Jj (E,6,6))."""
    Ti = jax.tree_util.tree_map(lambda a: a[i_idx], poses)
    Tj = jax.tree_util.tree_map(lambda a: a[j_idx], poses)

    def one(Ti_, Tj_, Z_, L_):
        def r_of(di, dj):
            return L_ @ relative_se3_residual(
                se3.retract(Ti_, di), se3.retract(Tj_, dj), Z_)

        z6 = jnp.zeros(6, dtype=Ti_.t.dtype)
        r0 = r_of(z6, z6)
        Ji = jax.jacfwd(r_of, argnums=0)(z6, z6)
        Jj = jax.jacfwd(r_of, argnums=1)(z6, z6)
        return r0, Ji, Jj

    return jax.vmap(one)(Ti, Tj, Z, sqrt_info)


def _pg_cost(poses, i_idx, j_idx, Z, sqrt_info):
    Ti = jax.tree_util.tree_map(lambda a: a[i_idx], poses)
    Tj = jax.tree_util.tree_map(lambda a: a[j_idx], poses)
    r = jax.vmap(lambda a, b, z, L: L @ relative_se3_residual(a, b, z))(
        Ti, Tj, Z, sqrt_info)
    return 0.5 * jnp.sum(r * r)


def solve_pose_graph(poses0, i_idx, j_idx, Z, sqrt_info=None, *, fixed_mask=None,
                     max_iters=50, lambda_init=1e-6, xtol=1e-12):
    """LM pose-graph solve. poses0: stacked SE3 (N,); edges (E,) index arrays
    with measurements Z (stacked SE3 (E,)) and optional (E,6,6) sqrt-information.
    Returns PoseGraphState."""
    N = poses0.t.shape[0]
    E = i_idx.shape[0]
    dtype = poses0.t.dtype
    if sqrt_info is None:
        sqrt_info = jnp.broadcast_to(jnp.eye(6, dtype=dtype), (E, 6, 6))
    if fixed_mask is None:
        fixed_mask = jnp.zeros(N, bool).at[0].set(True)

    cost0 = _pg_cost(poses0, i_idx, j_idx, Z, sqrt_info)
    state = PoseGraphState(poses=poses0, cost=cost0,
                           lam=jnp.asarray(lambda_init, dtype),
                           nu=jnp.asarray(2.0, dtype),
                           it=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool))

    def cond(s):
        return (~s.done) & (s.it < max_iters)

    def body(s):
        r, Ji, Jj = _edge_linearize(s.poses, i_idx, j_idx, Z, sqrt_info)
        ee = lambda a, b: jnp.einsum("eri,erj->eij", a, b, precision=HIGHEST)
        ev = lambda a: jnp.einsum("eri,er->ei", a, r, precision=HIGHEST)
        H = jnp.zeros((N, N, 6, 6), dtype=dtype)
        H = H.at[i_idx, i_idx].add(ee(Ji, Ji))
        H = H.at[j_idx, j_idx].add(ee(Jj, Jj))
        H = H.at[i_idx, j_idx].add(ee(Ji, Jj))
        H = H.at[j_idx, i_idx].add(ee(Jj, Ji))
        g = jnp.zeros((N, 6), dtype=dtype)
        g = g.at[i_idx].add(ev(Ji))
        g = g.at[j_idx].add(ev(Jj))

        # Marquardt damping on diagonal blocks
        diag = jnp.arange(N)
        Hd = H[diag, diag]
        d = jnp.maximum(jnp.diagonal(Hd, axis1=-2, axis2=-1), 1e-12)
        H = H.at[diag, diag].add(s.lam * jax.vmap(jnp.diag)(d))

        # gauge masking
        free = (~fixed_mask).astype(dtype)
        H = H * free[:, None, None, None] * free[None, :, None, None]
        H = H.at[diag, diag].add(
            jnp.eye(6, dtype=dtype)[None] * fixed_mask.astype(dtype)[:, None, None])
        g = g * free[:, None]

        A = H.transpose(0, 2, 1, 3).reshape(N * 6, N * 6)
        delta = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(A, lower=True), -g.reshape(N * 6))
        bad = jnp.any(~jnp.isfinite(delta))
        delta = jnp.where(bad, jnp.zeros_like(delta), delta).reshape(N, 6)

        poses_try = jax.vmap(se3.retract)(s.poses, delta)
        cost_try = _pg_cost(poses_try, i_idx, j_idx, Z, sqrt_info)
        dvec = delta.reshape(-1)
        # model decrease for (H + lam D) delta = -g: 0.5 * delta^T (lam D delta - g)
        pred = 0.5 * jnp.dot(
            dvec, s.lam * jnp.maximum(jnp.diagonal(A), 1e-12) * dvec - g.reshape(-1))
        rho = (s.cost - cost_try) / jnp.maximum(pred, 1e-30)

        accept = (cost_try < s.cost) & jnp.isfinite(cost_try) & (~bad)
        lam_new = jnp.where(
            accept, s.lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
            s.lam * s.nu)
        nu_new = jnp.where(accept, 2.0, s.nu * 2.0)
        sel = lambda a, b: jnp.where(accept, a, b)
        return PoseGraphState(
            poses=jax.tree_util.tree_map(sel, poses_try, s.poses),
            cost=sel(cost_try, s.cost),
            lam=jnp.clip(lam_new, 1e-14, 1e10), nu=nu_new, it=s.it + 1,
            done=(accept & (jnp.sum(dvec * dvec) < xtol * xtol)) | bad)

    return jax.lax.while_loop(cond, body, state)


def _compose_chain(T0, m):
    """Absolute poses from relative increments: T_k = T0 m_1 ... m_k.
    Log-depth associative scan (accelerator-friendly; f32 drift over 10k composes is
    ~log2(N) ulps, measured < 1e-5 absolute on the bench circle).
    Returns stacked SE3 of length P+1 (including T0 at index 0)."""
    def op(a, b):
        Ra, ta = a
        Rb, tb = b
        return (jnp.einsum("...ij,...jk->...ik", Ra, Rb),
                jnp.einsum("...ij,...j->...i", Ra, tb) + ta)

    Rc, tc = jax.lax.associative_scan(op, (m.R, m.t))
    Rabs = jnp.einsum("ij,kjl->kil", T0.R, Rc)
    tabs = jnp.einsum("ij,kj->ki", T0.R, tc) + T0.t[None]
    return se3.SE3(jnp.concatenate([T0.R[None], Rabs], axis=0),
                   jnp.concatenate([T0.t[None], tabs], axis=0))


class ChainGraphWork(NamedTuple):
    """Host-split edge structure for the large-scale chain+loop solver."""
    Z_chain: se3.SE3          # (N-1,) measurement i -> i+1 (identity if absent)
    info_chain: jnp.ndarray   # (N-1, 6, 6) sqrt-information (0 if absent)
    loop_i: jnp.ndarray       # (E,) int32
    loop_j: jnp.ndarray       # (E,) int32
    Z_loop: se3.SE3           # (E,)
    info_loop: jnp.ndarray    # (E, 6, 6) sqrt-information (0 for padding)


def build_chain_work(i_idx, j_idx, Z, sqrt_info, n_poses, dtype=np.float32):
    """Split general edges into the odometry chain (j == i+1, slotted by i)
    and loop-closure edges (everything else, padded to a multiple of 8).
    Host-side; index arrays must be concrete."""
    i_np = np.asarray(i_idx)
    j_np = np.asarray(j_idx)
    N = int(n_poses)
    is_chain = j_np == i_np + 1
    Rz = np.asarray(Z.R)
    tz = np.asarray(Z.t)
    info = np.asarray(sqrt_info)

    Rc = np.tile(np.eye(3, dtype=dtype), (N - 1, 1, 1))
    tc = np.zeros((N - 1, 3), dtype)
    Ic = np.zeros((N - 1, 6, 6), dtype)
    ci = i_np[is_chain]
    if np.unique(ci).size != ci.size:
        raise ValueError("duplicate chain edge")
    Rc[ci] = Rz[is_chain]
    tc[ci] = tz[is_chain]
    Ic[ci] = info[is_chain]

    li = i_np[~is_chain]
    lj = j_np[~is_chain]
    E = li.size
    Ep = max(E + (-E) % 8, 8)
    loop_i = np.zeros(Ep, np.int64)
    loop_j = np.zeros(Ep, np.int64)
    Rl = np.tile(np.eye(3, dtype=dtype), (Ep, 1, 1))
    tl = np.zeros((Ep, 3), dtype)
    Il = np.zeros((Ep, 6, 6), dtype)
    loop_i[:E] = li
    loop_j[:E] = lj
    Rl[:E] = Rz[~is_chain]
    tl[:E] = tz[~is_chain]
    Il[:E] = info[~is_chain]
    return ChainGraphWork(
        Z_chain=se3.SE3(jnp.asarray(Rc), jnp.asarray(tc)),
        info_chain=jnp.asarray(Ic),
        loop_i=jnp.asarray(loop_i.astype(np.int32)),
        loop_j=jnp.asarray(loop_j.astype(np.int32)),
        Z_loop=se3.SE3(jnp.asarray(Rl), jnp.asarray(tl)),
        info_loop=jnp.asarray(Il))


def _pg_cost_chain(poses, work: ChainGraphWork):
    N = poses.t.shape[0]
    ic = jnp.arange(N - 1)
    c1 = _pg_cost(poses, ic, ic + 1, work.Z_chain, work.info_chain)
    c2 = _pg_cost(poses, work.loop_i, work.loop_j, work.Z_loop,
                  work.info_loop)
    return c1 + c2


def solve_pose_graph_chain(poses0, work: ChainGraphWork, *, fixed_mask=None,
                           max_iters=50, lambda_init=1e-6, xtol=1e-12):
    """Exact LM pose-graph solve at chain+loop-closure scale (10k-100k
    poses): block-tridiagonal factor over the odometry chain + rank-6-per-
    loop-edge Woodbury. Identical damping/gauge/trust-region semantics to
    solve_pose_graph (parity-tested).

    Precision: an odometry chain's Hessian conditioning grows ~N^3, passing
    1/eps32 near N ~ 500-600 (measured: f32 makes no progress at N >= 600
    while f64 solves N = 10k to the noise floor). Long chains are therefore
    AUTO-UPCAST to f64 internally when x64 is enabled — pose-graph state is
    tiny (6N doubles), so the f64 cost is small next to a BA solve. Pass
    f64 inputs (or enable x64) for N > 384."""
    N_ = poses0.t.shape[0]
    if (poses0.t.dtype == jnp.float32 and N_ > 384
            and jax.config.jax_enable_x64):
        up = lambda t: jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        out = solve_pose_graph_chain(
            up(poses0), up(work), fixed_mask=fixed_mask,
            max_iters=max_iters, lambda_init=lambda_init, xtol=xtol)
        down = lambda t: jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        return down(out)
    if poses0.t.dtype == jnp.float32 and N_ > 384:
        # ADVICE r4: proceeding silently here hands the user a quietly
        # stalled solve (f32 makes no progress past N ~ 600 in this
        # absolute-state formulation).
        raise ValueError(
            f"solve_pose_graph_chain in f32 at N={N_} > 384 cannot make "
            "progress (chain Hessian condition ~N^3 exceeds 1/eps32). Use "
            "solve_pose_graph_relative (f32-native relative-state "
            "formulation), or enable x64 / pass f64 inputs.")
    from slam_tricks_tpu.solvers.banded_flat import (block_tridiag_factor,
                                                     tridiag_backward,
                                                     tridiag_forward)

    N = poses0.t.shape[0]
    E = work.loop_i.shape[0]
    q = 6 * E
    dtype = poses0.t.dtype
    if fixed_mask is None:
        fixed_mask = jnp.zeros(N, bool).at[0].set(True)
    free = (~fixed_mask).astype(dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    ic = jnp.arange(N - 1)
    ee = lambda a, b: jnp.einsum("eri,erj->eij", a, b, precision=HIGHEST)
    ev = lambda a, r: jnp.einsum("eri,er->ei", a, r, precision=HIGHEST)

    cost0 = _pg_cost_chain(poses0, work)
    state = PoseGraphState(poses=poses0, cost=cost0,
                           lam=jnp.asarray(lambda_init, dtype),
                           nu=jnp.asarray(2.0, dtype),
                           it=jnp.zeros((), jnp.int32),
                           done=jnp.zeros((), bool))

    def cond(s):
        return (~s.done) & (s.it < max_iters)

    def body(s):
        # chain linearization: no scatters, shifted adds only
        rc, Jic, Jjc = _edge_linearize(s.poses, ic, ic + 1, work.Z_chain,
                                       work.info_chain)
        z1 = jnp.zeros((1, 6, 6), dtype)
        D = (jnp.concatenate([ee(Jic, Jic), z1], axis=0)
             + jnp.concatenate([z1, ee(Jjc, Jjc)], axis=0))     # (N,6,6)
        Esub = ee(Jjc, Jic)                                     # (N-1,6,6)
        zv = jnp.zeros((1, 6), dtype)
        g = (jnp.concatenate([ev(Jic, rc), zv], axis=0)
             + jnp.concatenate([zv, ev(Jjc, rc)], axis=0))      # (N,6)

        # loop-closure linearization: scatter only E rows
        rl, Jil, Jjl = _edge_linearize(s.poses, work.loop_i, work.loop_j,
                                       work.Z_loop, work.info_loop)
        g = g.at[work.loop_i].add(ev(Jil, rl))
        g = g.at[work.loop_j].add(ev(Jjl, rl))
        HiiL = ee(Jil, Jil)
        HjjL = ee(Jjl, Jjl)

        # Marquardt damping from the TOTAL diagonal (parity with the dense
        # solver); poses with zero information get identity
        diag = jnp.diagonal(D, axis1=-2, axis2=-1)
        diag = diag.at[work.loop_i].add(
            jnp.diagonal(HiiL, axis1=-2, axis2=-1))
        diag = diag.at[work.loop_j].add(
            jnp.diagonal(HjjL, axis1=-2, axis2=-1))
        dscale = jnp.maximum(diag, 1e-12)                       # (N,6)
        untouched = jnp.sum(diag, axis=1) <= 0.0
        T = D + s.lam * jax.vmap(jnp.diag)(dscale)
        T = jnp.where(untouched[:, None, None], eye6[None], T)

        # gauge: mask rows/cols of fixed poses, unit diagonal
        T = (T * (free * free)[:, None, None]
             + eye6[None] * (1.0 - free)[:, None, None])
        Esub_m = Esub * (free[1:] * free[:-1])[:, None, None]
        g = g * free[:, None]

        # loop-edge factor U (N, 6, q), rows gauge-masked
        er = jnp.arange(E)
        U = jnp.zeros((N, 6, E, 6), dtype)
        U = U.at[work.loop_i, :, er, :].add(
            jnp.swapaxes(Jil, -1, -2) * free[work.loop_i][:, None, None])
        U = U.at[work.loop_j, :, er, :].add(
            jnp.swapaxes(Jjl, -1, -2) * free[work.loop_j][:, None, None])
        U = U.reshape(N, 6, q)

        # ONE multi-RHS forward substitution through the stored factor
        # T = Lt Lt^T; with Ut = Lt^-1 U the capacitance is the GRAM matrix
        # I + Ut^T Ut — unconditionally SPD and free of the cancellation
        # that breaks the naive I + U^T T^-1 U form in f32 (a 10k-pose
        # chain's kappa(T) far exceeds 1/eps32):
        #   (T + U U^T)^-1 b = Lt^-T [c - Ut (I + Ut^T Ut)^-1 Ut^T c]
        R = jnp.concatenate([-g[..., None], U], axis=-1)
        fac = block_tridiag_factor(T, Esub_m)
        Y = tridiag_forward(fac, R)
        c, Ut = Y[..., 0], Y[..., 1:]
        cap = (jnp.eye(q, dtype=dtype)
               + jnp.einsum("giq,gir->qr", Ut, Ut, precision=HIGHEST))
        cf = jax.scipy.linalg.cho_factor(cap, lower=True)
        z = jax.scipy.linalg.cho_solve(
            cf, jnp.einsum("giq,gi->q", Ut, c, precision=HIGHEST))
        y = c - jnp.einsum("giq,q->gi", Ut, z, precision=HIGHEST)
        delta = tridiag_backward(fac, y)

        bad = jnp.any(~jnp.isfinite(delta))
        delta = jnp.where(bad, jnp.zeros_like(delta), delta)
        poses_try = jax.vmap(se3.retract)(s.poses, delta)
        cost_try = _pg_cost_chain(poses_try, work)
        pred = 0.5 * jnp.sum(delta * (s.lam * dscale * delta - g))
        rho = (s.cost - cost_try) / jnp.maximum(pred, 1e-30)
        accept = (cost_try < s.cost) & jnp.isfinite(cost_try) & (~bad)
        lam_new = jnp.where(
            accept,
            s.lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
            s.lam * s.nu)
        nu_new = jnp.where(accept, 2.0, s.nu * 2.0)
        sel = lambda a, b: jnp.where(accept, a, b)
        return PoseGraphState(
            poses=jax.tree_util.tree_map(sel, poses_try, s.poses),
            cost=sel(cost_try, s.cost),
            lam=jnp.clip(lam_new, 1e-14, 1e10), nu=nu_new, it=s.it + 1,
            done=(accept & (jnp.sum(delta * delta) < xtol * xtol)) | bad)

    return jax.lax.while_loop(cond, body, state)


def solve_pose_graph_relative(poses0, work: ChainGraphWork, *,
                              max_iters=50, lambda_init=1e-6, xtol=1e-12):
    """Large-scale pose-graph LM in f32.

    The absolute-state chain Hessian has condition ~N^3 (past 1/eps32 near
    N~600), which is why solve_pose_graph_chain needs f64. This solver
    removes the N^3 STRUCTURALLY instead of chasing precision: the state is
    the odometry INCREMENTS m_k = T_{k-1}^{-1} T_k (the g2o/GTSAM
    "relative formulation"). Then

      - each chain factor log(Z_k^{-1} m_k) touches ONE state block:
        the chain Hessian is block-DIAGONAL (condition O(1), f32-trivial);
      - a loop closure (i,j) constrains F = m_{i+1}...m_j; perturbing
        m_g -> m_g exp(xi) gives dF = Adj(T_j^{-1} T_g) xi, so its Hessian
        is exactly U_e U_e^T with U_e rows A_{e,g} = Jabs_e Adj(T_j^-1 T_g)
        over i < g <= j — rank 6 per edge;
      - H + lam D = Dc + U U^T is solved by batched 6x6 Cholesky + a
        (6E,6E) SPD Gram capacitance (the loop_flat.py pattern: the
        PLUS-sign Woodbury I + Ut^T Ut is unconditionally SPD).

    All compute is batched 6x6 algebra + two (6P, q) matmuls + one
    log-depth compose scan — no sequential chain anywhere. The gauge is
    T_0 = const (first pose fixed, the bench/test convention).

    The LM trajectory differs from the absolute-state solvers (damping acts
    in relative coordinates), so parity is at the OPTIMUM: same final
    cost/ATE as the f64 reference path (tested), not per-iteration.

    Role model: g2o LM on 10k-pose graphs at tens-to-hundreds of ms/iter
    single-core (st20-g2o/src/include/test_g2o.h:94-135)."""
    N = poses0.t.shape[0]
    P = N - 1
    E = work.loop_i.shape[0]
    q = 6 * E
    dtype = poses0.t.dtype
    eye6 = jnp.eye(6, dtype=dtype)
    T0 = se3.SE3(poses0.R[0], poses0.t[0])

    # initial relative state from the supplied absolute initialization
    m0 = jax.vmap(lambda a, b: se3.mul(se3.inv(a), b))(
        jax.tree_util.tree_map(lambda a: a[:-1], poses0),
        jax.tree_util.tree_map(lambda a: a[1:], poses0))

    karr = jnp.arange(P)

    def chain_r_J(m):
        """Whitened chain residual + 6x6 Jacobian wrt right-perturbation of
        each m_k (the only state block the factor touches)."""
        def one(mk, Zk, Lk):
            def r_of(xi):
                return Lk @ se3.log(se3.mul(se3.inv(Zk), se3.mul(
                    mk, se3.exp(xi))))
            z6 = jnp.zeros(6, dtype=dtype)
            return r_of(z6), jax.jacfwd(r_of)(z6)
        return jax.vmap(one)(m, work.Z_chain, work.info_chain)

    def total_cost(m):
        T = _compose_chain(T0, m)
        rc, _ = chain_r_J(m)   # (cheap relative formulation: no abs needed)
        c1 = 0.5 * jnp.sum(rc * rc)
        c2 = _pg_cost(T, work.loop_i, work.loop_j, work.Z_loop,
                      work.info_loop)
        return c1 + c2

    cost0 = total_cost(m0)
    State = PoseGraphState
    state = State(poses=m0, cost=cost0,
                  lam=jnp.asarray(lambda_init, dtype),
                  nu=jnp.asarray(2.0, dtype),
                  it=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool))

    def cond(s):
        return (~s.done) & (s.it < max_iters)

    def body(s):
        m = s.poses
        T = _compose_chain(T0, m)

        # chain: block-diagonal normal equations
        rc, Jc = chain_r_J(m)
        D = jnp.einsum("kri,krj->kij", Jc, Jc, precision=HIGHEST)  # (P,6,6)
        g = jnp.einsum("kri,kr->ki", Jc, rc, precision=HIGHEST)    # (P,6)

        # loop closures: absolute-coordinates linearization, then the chain
        # rule onto the increments through Adj(T_j^{-1} T_g)
        rl, _, Jjl = _edge_linearize(T, work.loop_i, work.loop_j,
                                     work.Z_loop, work.info_loop)
        Tj = jax.tree_util.tree_map(lambda a: a[work.loop_j], T)
        Adj_inv_j = jax.vmap(lambda Tx: se3.adj(se3.inv(Tx)))(Tj)  # (E,6,6)
        B = jnp.einsum("eab,ebc->eac", Jjl, Adj_inv_j,
                       precision=HIGHEST)                          # (E,6,6)
        AdT = jax.vmap(se3.adj)(
            jax.tree_util.tree_map(lambda a: a[1:], T))            # (P,6,6)
        mask = ((karr[:, None] >= work.loop_i[None, :])
                & (karr[:, None] < work.loop_j[None, :])).astype(dtype)
        # U[k, a, (e,c)] = (A_{e,g=k+1}^T)[a,c] = sum_b Adj_g[b,a] B_e[c,b]
        U = jnp.einsum("kba,ecb->kaec", AdT, B,
                       precision=HIGHEST) * mask[:, None, :, None]
        U = U.reshape(P, 6, q)
        g = g + jnp.einsum("kaec,ec->ka", U.reshape(P, 6, E, 6), rl,
                           precision=HIGHEST)

        # Marquardt damping on the TOTAL diagonal
        dscale = jnp.maximum(
            jnp.diagonal(D, axis1=-2, axis2=-1) + jnp.sum(U * U, axis=2),
            1e-12)                                                 # (P,6)
        Dd = D + s.lam * jax.vmap(jnp.diag)(dscale)
        # increments with no chain information (absent odometry edge) still
        # get loop/damping terms; keep the block SPD regardless
        Dd = Dd + eye6[None] * 1e-10

        # Woodbury through the Gram capacitance (loop_flat.py scheme):
        # (Dd + U U^T)^-1 b = W^-T [c - Ut (I + Ut^T Ut)^-1 Ut^T c],
        # W = chol(Dd), Ut = W^-1 U, c = W^-1 b
        W = jnp.linalg.cholesky(Dd)                                # (P,6,6)
        rhs = jnp.concatenate([-g[..., None], U], axis=-1)         # (P,6,1+q)
        sol = jax.vmap(lambda Wk, Rk: jax.scipy.linalg.solve_triangular(
            Wk, Rk, lower=True))(W, rhs)
        c, Ut = sol[..., 0], sol[..., 1:]
        # Woodbury via ORTHOGONALIZED loop subspace. The naive form
        # y = c - Ut (I+Ut^T Ut)^{-1} Ut^T c is a catastrophic f32
        # cancellation when the drifted initial guess makes the whitened
        # gradient lie almost entirely in the loop subspace (measured at
        # N=2048: |c| ~ 5e4 vs |y| ~ 0.14 — six orders cancel, and the
        # capacitance solve would need ~1e-6 relative accuracy against
        # cond ~ 1e5+). QR-orthogonalize Ut = Q R first: then
        #   y = c - Q (Q^T c - w),  (I + R R^T) w = Q^T c,
        # where the solve error is relative to the SMALL output w (~|y|),
        # not the large input — measured 9% f32 step error vs 1350%
        # for the Gram form (a fine LM descent direction; f64 parity of
        # the converged optimum is tested).
        Qm, Rm = jnp.linalg.qr(Ut.reshape(P * 6, q))     # (6P,q), (q,q)
        cf = c.reshape(P * 6)
        cap = (jnp.eye(q, dtype=dtype)
               + jax.lax.dot_general(Rm, Rm, (((1,), (1,)), ((), ())),
                                     precision=HIGHEST))
        qc = Qm.T @ cf
        w = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(cap, lower=True), qc)
        y = (cf - Qm @ (qc - w)).reshape(P, 6)
        delta = jax.vmap(lambda Wk, yk: jax.scipy.linalg.solve_triangular(
            Wk, yk, lower=True, trans=1))(W, y)                    # (P,6)

        bad = jnp.any(~jnp.isfinite(delta))
        delta = jnp.where(bad, jnp.zeros_like(delta), delta)
        m_try = jax.vmap(se3.retract)(m, delta)
        cost_try = total_cost(m_try)
        import os as _os
        if _os.environ.get("SLAM_PG_DEBUG"):
            jax.debug.print(
                "it={i} cost={c:.6e} try={t:.6e} lam={l:.3e} |d|={d:.4e} "
                "bad={b}", i=s.it, c=s.cost, t=cost_try, l=s.lam,
                d=jnp.linalg.norm(delta), b=bad)
        pred = 0.5 * jnp.sum(delta * (s.lam * dscale * delta - g))
        rho = (s.cost - cost_try) / jnp.maximum(pred, 1e-30)
        accept = (cost_try < s.cost) & jnp.isfinite(cost_try) & (~bad)
        lam_new = jnp.where(
            accept,
            s.lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
            s.lam * s.nu)
        nu_new = jnp.where(accept, 2.0, s.nu * 2.0)
        sel = lambda a, b: jnp.where(accept, a, b)
        return State(
            poses=jax.tree_util.tree_map(sel, m_try, m),
            cost=sel(cost_try, s.cost),
            lam=jnp.clip(lam_new, 1e-14, 1e10), nu=nu_new, it=s.it + 1,
            done=(accept & (jnp.sum(delta * delta) < xtol * xtol)) | bad)

    out = jax.lax.while_loop(cond, body, state)
    return out._replace(poses=_compose_chain(T0, out.poses))

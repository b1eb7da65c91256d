"""Sim(3) pose-graph optimization: scale-drift-aware mono loop closing.

Monocular odometry drifts in SCALE as well as pose; an SE(3) pose graph
cannot absorb that drift (scale never enters its state), so closing a mono
loop with SE(3) factors leaves the map scale-inconsistent. The standard fix
(Strasdat et al., "Scale Drift-Aware Large Scale Monocular SLAM", RSS 2010;
ORB-SLAM's essential-graph optimization) lifts poses to Sim(3) and optimizes
relative-similarity factors r = log(Z^-1 S_i^-1 S_j) in R^7.

This is the Sim(3) twin of solvers/posegraph.py:solve_pose_graph (identical
LM trust-region/damping/gauge semantics, 7-dim tangent blocks). The
reference repo has no pose-graph implementation at all (st20's g2o usage is
BA-only, st20-g2o/src/include/test_g2o.h:94-135 is the role model); its Lie
theory docs (st21-lie/lie-group.tex, st23-lie-group-v2/doc.tex) stop at
SE(3) — Sim(3) is the one-extra-generator extension implemented in
manifolds/sim3.py.

Dense normal equations + Cholesky: exact and matmul-friendly for graphs up to a
few hundred keyframes, which is precisely the mono essential-graph regime
(loop closing runs over keyframes, not every frame). For 10k+ chains, the
relative-state/Woodbury machinery of solvers/posegraph.py applies unchanged
in 7-dim blocks — use solve_pose_graph_chain/relative after the Sim(3)
correction is folded in, or extend as needed.

Gauge note: one fixed pose removes the 7 gauge freedoms (global similarity);
with NO Sim(3) loop factor touching scale the per-pose scale would be
unobservable beyond the chain, which is why the chain factors here are
Sim(3) too (mono odometry DOES measure relative scale, just with drift).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tricks_tpu.manifolds import sim3
from slam_tricks_tpu.residuals.posegraph import relative_sim3_residual
from slam_tricks_tpu.solvers.common import HIGHEST


class Sim3GraphState(NamedTuple):
    poses: sim3.Sim3
    cost: jnp.ndarray
    lam: jnp.ndarray
    nu: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


def _edge_linearize(poses, i_idx, j_idx, Z, sqrt_info):
    """Per-edge whitened residual + Jacobians wrt tangent perturbations of
    S_i, S_j. Returns (r (E,7), Ji (E,7,7), Jj (E,7,7))."""
    Si = jax.tree_util.tree_map(lambda a: a[i_idx], poses)
    Sj = jax.tree_util.tree_map(lambda a: a[j_idx], poses)

    def one(Si_, Sj_, Z_, L_):
        def r_of(di, dj):
            return L_ @ relative_sim3_residual(
                sim3.retract(Si_, di), sim3.retract(Sj_, dj), Z_)

        z7 = jnp.zeros(7, dtype=Si_.t.dtype)
        r0 = r_of(z7, z7)
        Ji = jax.jacfwd(r_of, argnums=0)(z7, z7)
        Jj = jax.jacfwd(r_of, argnums=1)(z7, z7)
        return r0, Ji, Jj

    return jax.vmap(one)(Si, Sj, Z, sqrt_info)


def _pg_cost(poses, i_idx, j_idx, Z, sqrt_info):
    Si = jax.tree_util.tree_map(lambda a: a[i_idx], poses)
    Sj = jax.tree_util.tree_map(lambda a: a[j_idx], poses)
    r = jax.vmap(lambda a, b, z, L: L @ relative_sim3_residual(a, b, z))(
        Si, Sj, Z, sqrt_info)
    return 0.5 * jnp.sum(r * r)


def solve_pose_graph_sim3(poses0, i_idx, j_idx, Z, sqrt_info=None, *,
                          fixed_mask=None, max_iters=50, lambda_init=1e-6,
                          xtol=1e-12):
    """LM Sim(3) pose-graph solve. poses0: stacked Sim3 (N,); edges (E,)
    index arrays with stacked Sim3 measurements Z and optional (E,7,7)
    sqrt-information. Returns Sim3GraphState."""
    N = poses0.t.shape[0]
    E = i_idx.shape[0]
    dtype = poses0.t.dtype
    if sqrt_info is None:
        sqrt_info = jnp.broadcast_to(jnp.eye(7, dtype=dtype), (E, 7, 7))
    if fixed_mask is None:
        fixed_mask = jnp.zeros(N, bool).at[0].set(True)

    cost0 = _pg_cost(poses0, i_idx, j_idx, Z, sqrt_info)
    state = Sim3GraphState(poses=poses0, cost=cost0,
                           lam=jnp.asarray(lambda_init, dtype),
                           nu=jnp.asarray(2.0, dtype),
                           it=jnp.zeros((), jnp.int32),
                           done=jnp.zeros((), bool))

    def cond(s):
        return (~s.done) & (s.it < max_iters)

    def body(s):
        r, Ji, Jj = _edge_linearize(s.poses, i_idx, j_idx, Z, sqrt_info)
        ee = lambda a, b: jnp.einsum("eri,erj->eij", a, b, precision=HIGHEST)
        ev = lambda a: jnp.einsum("eri,er->ei", a, r, precision=HIGHEST)
        H = jnp.zeros((N, N, 7, 7), dtype=dtype)
        H = H.at[i_idx, i_idx].add(ee(Ji, Ji))
        H = H.at[j_idx, j_idx].add(ee(Jj, Jj))
        H = H.at[i_idx, j_idx].add(ee(Ji, Jj))
        H = H.at[j_idx, i_idx].add(ee(Jj, Ji))
        g = jnp.zeros((N, 7), dtype=dtype)
        g = g.at[i_idx].add(ev(Ji))
        g = g.at[j_idx].add(ev(Jj))

        diag = jnp.arange(N)
        Hd = H[diag, diag]
        d = jnp.maximum(jnp.diagonal(Hd, axis1=-2, axis2=-1), 1e-12)
        H = H.at[diag, diag].add(s.lam * jax.vmap(jnp.diag)(d))

        free = (~fixed_mask).astype(dtype)
        H = H * free[:, None, None, None] * free[None, :, None, None]
        H = H.at[diag, diag].add(
            jnp.eye(7, dtype=dtype)[None] * fixed_mask.astype(dtype)[:, None, None])
        g = g * free[:, None]

        A = H.transpose(0, 2, 1, 3).reshape(N * 7, N * 7)
        delta = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(A, lower=True), -g.reshape(N * 7))
        bad = jnp.any(~jnp.isfinite(delta))
        delta = jnp.where(bad, jnp.zeros_like(delta), delta).reshape(N, 7)

        poses_try = jax.vmap(sim3.retract)(s.poses, delta)
        cost_try = _pg_cost(poses_try, i_idx, j_idx, Z, sqrt_info)
        dvec = delta.reshape(-1)
        pred = 0.5 * jnp.dot(
            dvec, s.lam * jnp.maximum(jnp.diagonal(A), 1e-12) * dvec - g.reshape(-1))
        rho = (s.cost - cost_try) / jnp.maximum(pred, 1e-30)

        accept = (cost_try < s.cost) & jnp.isfinite(cost_try) & (~bad)
        lam_new = jnp.where(
            accept, s.lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
            s.lam * s.nu)
        nu_new = jnp.where(accept, 2.0, s.nu * 2.0)
        sel = lambda a, b: jnp.where(accept, a, b)
        return Sim3GraphState(
            poses=jax.tree_util.tree_map(sel, poses_try, s.poses),
            cost=sel(cost_try, s.cost),
            lam=jnp.clip(lam_new, 1e-14, 1e10), nu=nu_new, it=s.it + 1,
            done=(accept & (jnp.sum(dvec * dvec) < xtol * xtol)) | bad)

    return jax.lax.while_loop(cond, body, state)

"""Chain visual-inertial smoother at scale: block-tridiagonal LM over
(pose, velocity) keyframe states with a shared-bias Schur complement.

The dense `solve_vi_smoother` materializes the full Jacobian — fine to a
few hundred keyframes, quadratic beyond. This solver exploits the factor
graph's chain structure exactly:

  - an IMU factor touches states k and k+1 and the shared bias, so the
    state Hessian is SPD block-TRIDIAGONAL with 9-dim blocks
    ([omega, dt, dv] tangent per keyframe) — solved by the same batched
    cyclic reduction that powers the banded BA path
    (solvers/banded_flat.block_tridiag_solve, log-depth, batched matmuls);
  - the shared bias couples to every state (an arrow/bordered system);
    it is eliminated by a 6-dim Schur complement: one multi-RHS tridiag
    solve of [g | U] (7 columns) per iteration, then a 6x6 solve.

Per-factor linearization is vmapped `jacfwd` through the whitened residual
and the manifold retraction (9 residual rows x 24 tangent columns per
factor) — no hand Jacobians needed at this block size. The whole LM loop
(linearize, solve, gain-ratio trust region) runs in one `lax.while_loop`
on device, the framework's standard shape (solvers/lm.py).

Reference role: the online/batch VIO backends (GTSAM-style iSAM chains);
the reference repo has no inertial code — its preintegration theory doc
(st23-lie-group-v2/doc.tex:132-1148) is implemented in
estimation/preintegration.py, consumed here.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tricks_tpu.estimation import preintegration as pim
from slam_tricks_tpu.manifolds import se3, so3
from slam_tricks_tpu.solvers.banded_flat import block_tridiag_solve
from slam_tricks_tpu.solvers.common import HIGHEST


class ViChainState(NamedTuple):
    poses: se3.SE3        # (K,)
    vels: jnp.ndarray     # (K,3)
    bias: jnp.ndarray     # (6,)
    cost: jnp.ndarray
    lam: jnp.ndarray
    nu: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray
    lin: tuple            # (D, E, U, Hbb, g, gb) at the CURRENT state


def _retract_states(poses, vels, dx):
    """dx: (K,9) tangent [omega, dt, dv]."""
    R = jax.vmap(lambda Rk, w: Rk @ so3.exp(w))(poses.R, dx[:, 0:3])
    t = poses.t + dx[:, 3:6]
    v = vels + dx[:, 6:9]
    return se3.SE3(R, t), v


def _make_system(pre_batch, obs_poses, w_rot, w_tr, w_b,
                 bias_anchor, gravity, K, dtype):
    """Shared linearizer/cost builder for the chain VI system (used by the
    solver and by `vi_chain_covariances`)."""

    def imu_r(pre_k, Ti, vi, Tj, vj, bias, dxi, dxj, db):
        """Whitened IMU residual at perturbed states — jacfwd target."""
        Ri = se3.SE3(Ti.R @ so3.exp(dxi[0:3]), Ti.t + dxi[3:6])
        Rj = se3.SE3(Tj.R @ so3.exp(dxj[0:3]), Tj.t + dxj[3:6])
        b = bias + db
        r = pim.imu_residual(pre_k, Ri, vi + dxi[6:9], Rj, vj + dxj[6:9],
                             b[:3], b[3:], gravity)
        return pim.whiten(pre_k, r)

    def obs_r(T, T_obs, dx):
        Rp = se3.SE3(T.R @ so3.exp(dx[0:3]), T.t + dx[3:6])
        return jnp.concatenate([so3.local(T_obs.R, Rp.R) * w_rot,
                                (Rp.t - T_obs.t) * w_tr])

    z9 = jnp.zeros(9, dtype)
    z6 = jnp.zeros(6, dtype)

    def linearize(poses, vels, bias):
        Ti = jax.tree.map(lambda a: a[:-1], poses)
        Tj = jax.tree.map(lambda a: a[1:], poses)

        def imu_lin(pre_k, Ti_k, vi, Tj_k, vj):
            f = lambda dxi, dxj, db: imu_r(pre_k, Ti_k, vi, Tj_k, vj,
                                           bias, dxi, dxj, db)
            r = f(z9, z9, z6)
            Ji, Jj, Jb = jax.jacfwd(f, argnums=(0, 1, 2))(z9, z9, z6)
            return r, Ji, Jj, Jb

        r_i, Ji, Jj, Jb = jax.vmap(imu_lin)(pre_batch, Ti, vels[:-1],
                                            Tj, vels[1:])     # (K-1,9,*)

        def obs_lin(T, T_obs):
            f = lambda dx: obs_r(T, T_obs, dx)
            return f(z9), jax.jacfwd(f)(z9)

        r_o, Jo = jax.vmap(obs_lin)(poses, obs_poses)         # (K,6),(K,6,9)

        # assemble block-tridiagonal + bias border
        ein = lambda sp, *a: jnp.einsum(sp, *a, precision=HIGHEST)
        D = jnp.zeros((K, 9, 9), dtype)
        D = D.at[:-1].add(ein("kri,krj->kij", Ji, Ji))
        D = D.at[1:].add(ein("kri,krj->kij", Jj, Jj))
        D = D + ein("kri,krj->kij", Jo, Jo)
        E = ein("kri,krj->kij", Ji, Jj)   # M[k+1,k] = Jj^T Ji -> transpose!
        E = jnp.swapaxes(E, 1, 2)          # (K-1,9,9): Jj^T Ji rows x cols
        U = jnp.zeros((K, 9, 6), dtype)
        U = U.at[:-1].add(ein("kri,krb->kib", Ji, Jb))
        U = U.at[1:].add(ein("kri,krb->kib", Jj, Jb))
        Hbb = ein("krb,krc->bc", Jb, Jb) + jnp.eye(6, dtype=dtype) * w_b * w_b
        g = jnp.zeros((K, 9), dtype)
        g = g.at[:-1].add(ein("kri,kr->ki", Ji, r_i))
        g = g.at[1:].add(ein("kri,kr->ki", Jj, r_i))
        g = g + ein("kri,kr->ki", Jo, r_o)
        gb = ein("krb,kr->b", Jb, r_i) + w_b * w_b * (bias - bias_anchor)
        return D, E, U, Hbb, g, gb

    def total_cost(poses, vels, bias):
        Ti = jax.tree.map(lambda a: a[:-1], poses)
        Tj = jax.tree.map(lambda a: a[1:], poses)
        r_i = jax.vmap(lambda p, a, vi, b, vj: imu_r(p, a, vi, b, vj,
                                                     bias, z9, z9, z6))(
            pre_batch, Ti, vels[:-1], Tj, vels[1:])
        r_o = jax.vmap(lambda T, To: obs_r(T, To, z9))(poses, obs_poses)
        r_b = w_b * (bias - bias_anchor)
        return 0.5 * (jnp.sum(r_i * r_i) + jnp.sum(r_o * r_o)
                      + jnp.sum(r_b * r_b))

    return linearize, total_cost


def solve_vi_chain(pre_batch, obs_poses, poses0, vels0, bias0, *,
                   obs_rot_sigma=0.01, obs_trans_sigma=0.02,
                   bias_prior_sigma=1.0, gravity=pim.GRAVITY,
                   max_iters=30, lambda_init=1e-4, xtol=1e-12):
    """MAP smoothing over (poses, velocities, shared bias) with chain
    factors, O(K) memory and O(K log K) solve depth.

    Same problem and optimum as `vi_smoother.solve_vi_smoother` (parity
    tested); use this one when K is large. Returns
    (ViChainState-final, n_iters-implicit-in-state)."""
    K = obs_poses.t.shape[0]
    if K < 2:
        raise ValueError(f"solve_vi_chain needs >= 2 keyframes, got K={K} "
                         "(no IMU segment to constrain)")
    dtype = obs_poses.t.dtype
    w_rot = jnp.asarray(1.0 / obs_rot_sigma, dtype)
    w_tr = jnp.asarray(1.0 / obs_trans_sigma, dtype)
    w_b = jnp.asarray(1.0 / bias_prior_sigma, dtype)
    bias_anchor = jnp.concatenate([pre_batch.bg0[0], pre_batch.ba0[0]])

    linearize, total_cost = _make_system(
        pre_batch, obs_poses, w_rot, w_tr, w_b, bias_anchor, gravity,
        K, dtype)

    vels0 = vels0.astype(dtype)
    bias0 = bias0.astype(dtype)
    state = ViChainState(
        poses=poses0, vels=vels0, bias=bias0,
        cost=total_cost(poses0, vels0, bias0),
        lam=jnp.asarray(lambda_init, dtype), nu=jnp.asarray(2.0, dtype),
        it=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool),
        lin=linearize(poses0, vels0, bias0))

    def cond(s):
        return (~s.done) & (s.it < max_iters)

    def body(s):
        # linearization lives in the carry: a REJECTED step reuses it (the
        # state did not move) and only accepted steps pay the vmapped
        # jacfwd pass again — the solvers/lm.py convention
        D, E, U, Hbb, g, gb = s.lin
        # Marquardt scaling on the diagonal
        dscale = jnp.maximum(jnp.diagonal(D, axis1=-2, axis2=-1), 1e-12)
        Dd = D + s.lam * jax.vmap(jnp.diag)(dscale)
        bscale = jnp.maximum(jnp.diag(Hbb), 1e-12)
        Hbb_d = Hbb + s.lam * jnp.diag(bscale)

        # Schur on the bias: one multi-RHS tridiag solve of [-g | U]
        rhs = jnp.concatenate([-g[..., None], U], axis=-1)    # (K,9,7)
        sol = block_tridiag_solve(Dd, E, rhs)                 # (K,9,7)
        y, Z = sol[..., 0], sol[..., 1:]
        cap = Hbb_d - jnp.einsum("kib,kic->bc", U, Z, precision=HIGHEST)
        rhs_b = -gb - jnp.einsum("kib,ki->b", U, y, precision=HIGHEST)
        db = jnp.linalg.solve(cap, rhs_b)
        dx = y - Z @ db                                       # (K,9)
        poses_new, vels_new = _retract_states(s.poses, s.vels, dx)
        bias_new = s.bias + db
        cost_new = total_cost(poses_new, vels_new, bias_new)

        # gain ratio on the damped-model predicted reduction
        pred = 0.5 * (jnp.sum(dx * (s.lam * dscale * dx - g))
                      + jnp.sum(db * (s.lam * bscale * db - gb)))
        rho = (s.cost - cost_new) / jnp.maximum(pred, 1e-30)
        accept = (cost_new < s.cost) & jnp.isfinite(cost_new)

        lam_acc = s.lam * jnp.maximum(
            1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3).astype(dtype)
        take = lambda a, b: jax.tree.map(
            lambda x, y2: jnp.where(accept, x, y2), a, b)
        poses_u = take(poses_new, s.poses)
        vels_u = jnp.where(accept, vels_new, s.vels)
        bias_u = jnp.where(accept, bias_new, s.bias)
        cost_u = jnp.where(accept, cost_new, s.cost)
        lam_u = jnp.where(accept, lam_acc, s.lam * s.nu)
        nu_u = jnp.where(accept, jnp.asarray(2.0, dtype), s.nu * 2.0)
        step = jnp.sqrt(jnp.sum(dx * dx) + jnp.sum(db * db))
        done = accept & (step < xtol)
        lin_u = jax.lax.cond(
            accept, lambda: linearize(poses_u, vels_u, bias_u),
            lambda: s.lin)
        return ViChainState(poses_u, vels_u, bias_u, cost_u, lam_u, nu_u,
                            s.it + 1, done, lin_u)

    return jax.lax.while_loop(cond, body, state)


def vi_chain_covariances(pre_batch, obs_poses, poses, vels, bias, *,
                         obs_rot_sigma=0.01, obs_trans_sigma=0.02,
                         bias_prior_sigma=1.0, gravity=pim.GRAVITY):
    """Posterior marginal covariances at the smoother solution — the
    Kalman-smoother/Ceres-Covariance role for the VI chain.

    Returns (state_cov (K,9,9) in the [omega, dt, dv] tangent, bias_cov
    (6,6)). With the bordered Hessian H = [[T, U], [U^T, Hbb]] (T block-
    tridiagonal), the state marginals follow from the Woodbury identity

        (T - U Hbb^-1 U^T)^-1 = T^-1 + T^-1 U cap^-1 U^T T^-1,
        cap = Hbb - U^T T^-1 U  (the same capacitance the solver forms),

    so  state_cov_k = Takahashi_diag(T)_k + Z_k cap^-1 Z_k^T  with
    Z = T^-1 U (one multi-RHS tridiag solve), and bias_cov = cap^-1.
    Only the block-diagonal of T^-1 is ever formed (two-sweep Takahashi,
    solvers/banded_flat._takahashi_inverse_blocks)."""
    from slam_tricks_tpu.solvers.banded_flat import _takahashi_inverse_blocks

    K = obs_poses.t.shape[0]
    if K < 2:
        raise ValueError(f"vi_chain_covariances needs >= 2 keyframes, got {K}")
    dtype = obs_poses.t.dtype
    w_rot = jnp.asarray(1.0 / obs_rot_sigma, dtype)
    w_tr = jnp.asarray(1.0 / obs_trans_sigma, dtype)
    w_b = jnp.asarray(1.0 / bias_prior_sigma, dtype)
    bias_anchor = jnp.concatenate([pre_batch.bg0[0], pre_batch.ba0[0]])
    linearize, _ = _make_system(pre_batch, obs_poses, w_rot, w_tr, w_b,
                                bias_anchor, gravity, K, dtype)
    D, E, U, Hbb, _, _ = linearize(poses, vels.astype(dtype),
                                   bias.astype(dtype))
    P, _ = _takahashi_inverse_blocks(D, E, K)          # diag of T^-1
    Z = block_tridiag_solve(D, E, U)                   # (K,9,6)
    cap = Hbb - jnp.einsum("kib,kic->bc", U, Z, precision=HIGHEST)
    bias_cov = jnp.linalg.inv(cap)
    state_cov = P + jnp.einsum("kib,bc,kjc->kij", Z, bias_cov, Z,
                               precision=HIGHEST)
    return state_cov, bias_cov

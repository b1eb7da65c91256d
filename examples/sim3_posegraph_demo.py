#!/usr/bin/env python
"""Scale-drift-aware mono loop closing demo (manifolds/sim3.py +
solvers/posegraph_sim3.py): a monocular odometry chain around a circle
accumulates multiplicative scale drift; loop-closure similarity
measurements expose the accumulated scale ratio, and Sim(3) pose-graph
optimization recovers the metric trajectory AND the latent per-keyframe
scale profile — which SE(3) optimization on the identical graph
structurally cannot (Strasdat et al., RSS 2010).

Run: python examples/sim3_posegraph_demo.py [--device]
(defaults to the CPU backend so the demo runs anywhere; --device uses the
default device)."""

import sys


def main():
    import jax

    if "--device" not in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")

    import numpy as np
    import jax.numpy as jnp

    from slam_tricks_tpu.manifolds import se3, sim3
    from slam_tricks_tpu.solvers import solve_pose_graph, solve_pose_graph_sim3
    from slam_tricks_tpu.utils.logging import get_logger

    log = get_logger("sim3_demo")
    dtype = np.float32 if "--device" in sys.argv else np.float64

    # ---- simulate a mono keyframe loop with scale drift -------------------
    N, n_loops, ds = 96, 6, 0.004
    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(N) / N
    t_true = np.stack([10 * np.cos(ang), 10 * np.sin(ang),
                       0.1 * np.sin(3 * ang)], 1)
    Rt = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                             [np.sin(a), np.cos(a), 0],
                             [0, 0, 1]]) for a in ang])
    p = np.exp(-ds * np.arange(N))  # latent local map scale per keyframe
    gt = sim3.Sim3(jnp.asarray(Rt.astype(dtype)),
                   jnp.asarray(t_true.astype(dtype)),
                   jnp.asarray(p.astype(dtype)))

    ii = np.concatenate([np.arange(N - 1), rng.integers(0, N // 4, n_loops)])
    jj = np.concatenate([np.arange(1, N),
                         rng.integers(3 * N // 4, N, n_loops)])
    Si = jax.tree_util.tree_map(lambda a: a[ii], gt)
    Sj = jax.tree_util.tree_map(lambda a: a[jj], gt)
    Zc = jax.vmap(lambda a, b: sim3.mul(sim3.inv(a), b))(Si, Sj)
    xi = rng.normal(size=(len(ii), 7)) * 1e-3
    xi[N - 1:] = 0.0  # loop-closure measurements exact
    Z = jax.vmap(lambda S, x: sim3.mul(S, sim3.exp(x)))(
        Zc, jnp.asarray(xi.astype(dtype)))
    info = np.broadcast_to(np.eye(7, dtype=dtype), (len(ii), 7, 7)).copy()
    info[N - 1:] *= 10.0

    # uncorrected mono map: integrate (R, t) with no scale compensation
    Rz, tz = np.asarray(Z.R, np.float64), np.asarray(Z.t, np.float64)
    R0, t0 = [Rt[0]], [t_true[0]]
    for k in range(N - 1):
        t0.append(R0[-1] @ tz[k] + t0[-1])
        R0.append(R0[-1] @ Rz[k])
    poses0 = sim3.Sim3(jnp.asarray(np.stack(R0).astype(dtype)),
                       jnp.asarray(np.stack(t0).astype(dtype)),
                       jnp.ones(N, dtype=dtype))

    def ate(t_est):
        return float(np.sqrt(np.mean(np.sum(
            (np.asarray(t_est, np.float64) - t_true) ** 2, 1))))

    log.info("drifted mono map ATE: %.3f m (scale stretched up to %.2fx)",
             ate(poses0.t), float(1 / p[-1]))

    # ---- Sim(3) vs SE(3) on the identical graph ---------------------------
    out7 = solve_pose_graph_sim3(poses0, jnp.asarray(ii), jnp.asarray(jj),
                                 Z, jnp.asarray(info), max_iters=50)
    out6 = solve_pose_graph(se3.SE3(poses0.R, poses0.t), jnp.asarray(ii),
                            jnp.asarray(jj), se3.SE3(Z.R, Z.t),
                            jnp.asarray(info[:, :6, :6]), max_iters=50)
    s_err = np.abs(np.asarray(out7.poses.s, np.float64) / p - 1.0).max()
    log.info("Sim(3) PGO: ATE %.4f m, latent scale profile recovered to "
             "%.2f%% (cost %.3e, %d iters)", ate(out7.poses.t),
             100 * s_err, float(out7.cost), int(out7.it))
    log.info("SE(3) PGO on the same data: ATE %.4f m — scale is not in its "
             "state, so the drift-stretched odometry and the exact loops "
             "can only be compromised, not reconciled", ate(out6.poses.t))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Incremental online smoothing demo (solvers/incremental.py): cameras
arrive in groups along a trajectory; each arrival extends the stored
super-block factor over the affected tail instead of refactoring the whole
history, then takes tail-restricted GN steps. A periodic batch rebatch
polishes the estimate.

Run: python examples/incremental_demo.py [--device]
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

    from slam_tricks_tpu.evaluation import ate_rmse
    from slam_tricks_tpu.sim import make_trajectory_scene, perturb_scene
    from slam_tricks_tpu.solvers import banded_flat, incremental
    from slam_tricks_tpu.utils.logging import get_logger

    log = get_logger("incremental_demo")
    dtype = np.float32 if "--device" in sys.argv else np.float64

    C, L = 64, 960
    scene = make_trajectory_scene(n_cams=C, n_points=L, track_len=4,
                                  seed=11, dtype=dtype)
    # odometry-grade initial noise: a real frontend hands the smoother
    # locally-consistent inits (relative pose odometry, landmarks
    # triangulated from current estimates); the default perturbation is
    # a stress test for BATCH solvers, which take 20+ LM iterations —
    # far more than the few tail-restricted GN steps spent per arrival
    poses0, points0, fixed = perturb_scene(
        scene, pose_rot_noise=0.004, pose_trans_noise=0.02,
        point_noise=0.02, seed=12)
    bw = banded_flat.build_banded_work(scene.obs, C, L, dtype=dtype)

    from slam_tricks_tpu.manifolds import se3

    def reinit_tail(state, a_prev, a_new):
        """Odometry-style init of the arriving segment: compose measured
        relative increments (what a real frontend provides — here the
        increments of the noisy initial trajectory) onto the current
        estimated head, instead of keeping globally-drifted absolute
        guesses. Inactive cameras have zero live observations, so moving
        them cannot touch any stored prefix band block."""
        poses = state.poses
        for c in range(a_prev, a_new):
            Z = se3.mul(jax.tree_util.tree_map(lambda a: a[c], poses0),
                        se3.inv(jax.tree_util.tree_map(lambda a: a[c - 1],
                                                       poses0)))
            Tc = se3.mul(Z, jax.tree_util.tree_map(lambda a: a[c - 1],
                                                   poses))
            poses = se3.SE3(poses.R.at[c].set(Tc.R), poses.t.at[c].set(Tc.t))
        return state._replace(poses=poses)

    a0 = C // 4
    state, c_dirty = incremental.smoother_init(poses0, points0, bw,
                                               n_active=a0)
    log.info("init on %d cams: cost %.4e", a0, float(state.cost))
    schedule = list(range(a0, C + 1, 8))
    for a_prev, a_new in zip(schedule[:-1], schedule[1:]):
        state = reinit_tail(state, a_prev, a_new)
        state, c_dirty = incremental.smoother_arrive(
            state, bw, a_prev=a_prev, a_new=a_new, c_dirty=c_dirty,
            gn_steps=4)
        log.info("arrive -> %3d cams: cost %.4e (factor tail from cam %d)",
                 a_new, float(state.cost), c_dirty)

    pts = incremental.scatter_points(state.points_s, bw, L)
    warm = banded_flat.solve_ba_banded(state.poses, pts, bw, max_iters=20)
    batch = banded_flat.solve_ba_banded(poses0, points0, bw, max_iters=20)
    ate_stream = ate_rmse(state.poses, scene.poses_true)
    ate_warm = ate_rmse(warm.poses, scene.poses_true)
    log.info("streamed  cost %.4e | ATE %.4f", float(state.cost),
             float(ate_stream))
    log.info("rebatched cost %.4e | ATE %.4f (batch-from-scratch %.4e)",
             float(warm.cost), float(ate_warm), float(batch.cost))
    return 0


if __name__ == "__main__":
    sys.exit(main())

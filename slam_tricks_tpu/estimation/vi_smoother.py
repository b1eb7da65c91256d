"""Inertial smoothing MAP backend: keyframe states optimized over
preintegrated IMU factors + pose/position observations.

This is the factor-graph estimator the reference's theory docs point at
(st23-lie-group-v2/doc.tex preintegration section; st0-core/docs/notes.tex
factor-graph notes) with the st4 scenario's observation model (noisy pose
measurements of a smooth trajectory, st4-kalman/src/src/pose_simulation.cpp:
17-88) — implemented as one dense on-device LM solve over the product
manifold  (SO(3)+R^3)^K  x  R^{3K} (velocities)  x  R^6 (shared biases).

All K-1 IMU segments integrate as ONE vmapped scan (static samples/segment)
and all factors evaluate as one vmapped residual stack — no per-factor
Python, the device-friendly shape for a smoother of this size. For long
trajectories the same factors drop into the banded/incremental chain
solvers; this module is the reference dense formulation the chain path is
parity-tested against.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.estimation import preintegration as pim
from slam_tricks_tpu.manifolds import manifold as man
from slam_tricks_tpu.manifolds import se3, so3
from slam_tricks_tpu.solvers.lm import levenberg_marquardt


class ViSimData(NamedTuple):
    poses_true: se3.SE3      # (K,) keyframe poses (batched SE3)
    vels_true: jnp.ndarray   # (K,3)
    gyro: jnp.ndarray        # (K-1, S, 3) raw samples per segment
    accel: jnp.ndarray       # (K-1, S, 3)
    dt: float                # sample period
    obs_poses: se3.SE3       # (K,) noisy pose observations
    bg_true: jnp.ndarray     # (3,)
    ba_true: jnp.ndarray     # (3,)


def simulate_vi(n_keyframes=24, samples_per_seg=20, dt=0.005,
                omega_body=(0.15, -0.1, 0.6), radius=2.0, climb=0.3,
                turn_rate=0.9, sigma_g=0.0, sigma_a=0.0,
                bg=(0.02, -0.015, 0.01), ba=(0.08, -0.05, 0.12),
                obs_rot_noise=0.01, obs_trans_noise=0.02, seed=0,
                dtype=jnp.float64):
    """Analytic trajectory with exactly-known IMU: constant body angular
    velocity (R(t)=Exp(w0 t)) and a circular climb p(t)=r[cos,sin,0]+[0,0,ct]
    — accel/gyro follow in closed form, so the zero-noise stream round-trips
    the preintegration EXACTLY (up to integration order)."""
    rng = np.random.default_rng(seed)
    w0 = jnp.asarray(omega_body, dtype)
    g = jnp.asarray(pim.GRAVITY, dtype)
    K, S = n_keyframes, samples_per_seg

    def R_of(t):
        return so3.exp(w0 * t)

    def p_of(t):
        ang = turn_rate * t
        return jnp.stack([radius * jnp.cos(ang), radius * jnp.sin(ang),
                          climb * t])

    def v_of(t):
        ang = turn_rate * t
        return jnp.stack([-radius * turn_rate * jnp.sin(ang),
                          radius * turn_rate * jnp.cos(ang),
                          jnp.full((), climb, dtype)])

    def a_world_of(t):
        ang = turn_rate * t
        return jnp.stack([-radius * turn_rate ** 2 * jnp.cos(ang),
                          -radius * turn_rate ** 2 * jnp.sin(ang),
                          jnp.zeros((), dtype)])

    t_kf = jnp.arange(K, dtype=dtype) * (S * dt)
    poses_true = se3.SE3(jax.vmap(R_of)(t_kf), jax.vmap(p_of)(t_kf))
    vels_true = jax.vmap(v_of)(t_kf)

    # IMU sample times: midpoint of each interval, so the piecewise-constant
    # zero-order-hold integration matches the analytic trajectory to O(dt^2)
    t_s = (jnp.arange(K - 1, dtype=dtype)[:, None] * S
           + jnp.arange(S, dtype=dtype)[None, :] + 0.5) * dt
    bg_t = jnp.asarray(bg, dtype)
    ba_t = jnp.asarray(ba, dtype)

    def imu_at(t):
        R = R_of(t)
        w_m = w0 + bg_t
        a_m = R.T @ (a_world_of(t) - g) + ba_t
        return w_m, a_m

    gyro, accel = jax.vmap(jax.vmap(imu_at))(t_s)
    if sigma_g > 0:
        gyro = gyro + jnp.asarray(
            rng.normal(0, sigma_g / np.sqrt(dt), gyro.shape), dtype)
    if sigma_a > 0:
        accel = accel + jnp.asarray(
            rng.normal(0, sigma_a / np.sqrt(dt), accel.shape), dtype)

    # noisy pose observations (st4 observation model)
    dR = jnp.asarray(rng.normal(0, obs_rot_noise, (K, 3)), dtype)
    dp = jnp.asarray(rng.normal(0, obs_trans_noise, (K, 3)), dtype)
    obs_poses = se3.SE3(jax.vmap(lambda R, w: R @ so3.exp(w))(poses_true.R, dR),
                        poses_true.t + dp)
    return ViSimData(poses_true, vels_true, gyro, accel, dt, obs_poses,
                     bg_t, ba_t)


def preintegrate_segments(sim: ViSimData, bg, ba, sigma_g=1.7e-4,
                          sigma_a=2e-3):
    """All K-1 segments in one vmapped scan -> batched PreintegratedImu."""
    return jax.vmap(lambda w, a: pim.preintegrate(
        w, a, sim.dt, bg, ba, sigma_g=sigma_g, sigma_a=sigma_a))(
        sim.gyro, sim.accel)


class ViSolution(NamedTuple):
    poses: se3.SE3
    vels: jnp.ndarray
    bias: jnp.ndarray    # (6,) [bg, ba]
    cost: jnp.ndarray
    iterations: jnp.ndarray


def solve_vi_smoother(pre_batch, obs_poses, poses0, vels0, bias0,
                      obs_rot_sigma=0.01, obs_trans_sigma=0.02,
                      bias_prior_sigma=1.0, gravity=pim.GRAVITY,
                      max_iters=30, lambda_init=1e-4):
    """MAP smoothing over (poses, velocities, shared biases).

    pre_batch: batched PreintegratedImu (K-1 leading axis) integrated at the
    bias stored in its bg0/ba0 fields (first-order bias correction handles
    the offset to the current estimate). obs_poses: (K,) noisy SE3
    observations. Returns ViSolution."""
    K = obs_poses.t.shape[0]
    if K < 2:
        raise ValueError(f"solve_vi_smoother needs >= 2 keyframes, got K={K}")
    dtype = obs_poses.t.dtype
    mani = man.product(man.batched(man.so3_r3(), K),
                       man.euclidean((K, 3)),
                       man.euclidean((6,)))

    w_rot = 1.0 / obs_rot_sigma
    w_tr = 1.0 / obs_trans_sigma
    w_bias = 1.0 / bias_prior_sigma

    def residual(x):
        poses, vels, bias = x
        bg, ba = bias[:3], bias[3:]

        def factor(pre, Ri, vi, Tj, vj):
            r = pim.imu_residual(pre, Ri, vi, Tj, vj, bg, ba, gravity)
            return pim.whiten(pre, r)

        Ti = jax.tree.map(lambda a: a[:-1], poses)
        Tj = jax.tree.map(lambda a: a[1:], poses)
        r_imu = jax.vmap(factor)(pre_batch, Ti, vels[:-1], Tj, vels[1:])

        def obs_r(T, T_obs):
            return jnp.concatenate([so3.local(T_obs.R, T.R) * w_rot,
                                    (T.t - T_obs.t) * w_tr])

        r_obs = jax.vmap(obs_r)(poses, obs_poses)
        r_bias = (bias - jnp.concatenate([pre_batch.bg0[0],
                                          pre_batch.ba0[0]])) * w_bias
        return jnp.concatenate([r_imu.reshape(-1), r_obs.reshape(-1), r_bias])

    x0 = (poses0, vels0.astype(dtype), bias0.astype(dtype))
    res = levenberg_marquardt(residual, x0, mani, max_iters=max_iters,
                              lambda_init=lambda_init)
    poses, vels, bias = res.x
    return ViSolution(poses, vels, bias, res.cost, res.iterations)


def dead_reckon(pre_batch, T0, v0, bg, ba, gravity=pim.GRAVITY):
    """Forward integration of the preintegrated deltas from the first state
    — the no-smoothing baseline (and the initializer for the smoother)."""
    g = jnp.asarray(gravity, T0.t.dtype)

    def step(carry, pre):
        T, v = carry
        dR, dv, dp = pim.bias_corrected(pre, bg, ba)
        Dt = pre.dt
        t_new = T.t + v * Dt + 0.5 * g * Dt * Dt + T.R @ dp
        v_new = v + g * Dt + T.R @ dv
        T_new = se3.SE3(T.R @ dR, t_new)
        return (T_new, v_new), (T_new, v_new)

    (_, _), (poses, vels) = jax.lax.scan(step, (T0, v0), pre_batch)
    poses = se3.SE3(jnp.concatenate([T0.R[None], poses.R]),
                    jnp.concatenate([T0.t[None], poses.t]))
    vels = jnp.concatenate([v0[None], vels])
    return poses, vels


# ---------------------------------------------------------------------------
# Visual-inertial bundle adjustment: reprojection + preintegration factors
# ---------------------------------------------------------------------------

def simulate_vi_landmarks(sim: ViSimData, n_landmarks=60, shell_radius=5.0,
                          uv_noise=0.0, max_tan=2.0, seed=0):
    """Landmarks on a shell around the trajectory + their normalized-plane
    observations from every keyframe (camera = body, identity extrinsic).

    Returns (points (L,3), uv (K,L,2), weight (K,L)) with weight=0 where the
    landmark is behind the camera or outside the FOV cone — the padded/masked
    static-shape observation table (SURVEY §7 'static shapes vs ragged
    visibility')."""
    rng = np.random.default_rng(seed)
    dtype = sim.poses_true.t.dtype
    dirs = rng.normal(size=(n_landmarks, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.6 * shell_radius, shell_radius, (n_landmarks, 1))
    center = np.asarray(sim.poses_true.t).mean(axis=0)
    points = jnp.asarray(center + dirs * radii, dtype)

    def project_all(T):
        p_cam = jax.vmap(lambda X: T.R.T @ (X - T.t))(points)   # (L,3)
        z = p_cam[:, 2]
        uv = p_cam[:, :2] / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)[:, None]
        vis = (z > 0.25) & (jnp.max(jnp.abs(uv), axis=1) < max_tan)
        return uv, vis.astype(dtype)

    uv, w = jax.vmap(project_all)(sim.poses_true)
    if uv_noise > 0:
        uv = uv + jnp.asarray(rng.normal(0, uv_noise, uv.shape), dtype)
    return points, uv, w


def solve_vi_ba(pre_batch, uv, weight, poses0, vels0, bias0, points0,
                pose0_prior=None, uv_sigma=1e-3, prior_sigma=1e-4,
                gravity=pim.GRAVITY, max_iters=40, lambda_init=1e-4):
    """Visual-inertial bundle adjustment: monocular reprojection factors +
    preintegrated IMU factors over (poses, velocities, shared biases,
    landmarks).

    The accelerometer makes METRIC SCALE observable — a monocular-only BA
    leaves scale as a gauge freedom (tested: a 0.7x-scaled initialization
    stays at 0.7x without IMU, returns to 1.0x with). Only the first pose is
    pinned (6-DoF prior); everything else, including the landmark cloud and
    the bias, is free. uv: (K,L,2) normalized-plane observation table with
    (K,L) weights (0 = invisible)."""
    K = uv.shape[0]
    L = points0.shape[0]
    dtype = uv.dtype
    if pose0_prior is None:
        pose0_prior = jax.tree.map(lambda a: a[0], poses0)
    mani = man.product(man.batched(man.so3_r3(), K),
                       man.euclidean((K, 3)),
                       man.euclidean((6,)),
                       man.euclidean((L, 3)))
    w_uv = 1.0 / uv_sigma
    w_prior = 1.0 / prior_sigma

    def residual(x):
        poses, vels, bias, points = x
        bg, ba = bias[:3], bias[3:]

        def imu_factor(pre, Ri, vi, Tj, vj):
            r = pim.imu_residual(pre, Ri, vi, Tj, vj, bg, ba, gravity)
            return pim.whiten(pre, r)

        Ti = jax.tree.map(lambda a: a[:-1], poses)
        Tj = jax.tree.map(lambda a: a[1:], poses)
        r_imu = jax.vmap(imu_factor)(pre_batch, Ti, vels[:-1], Tj, vels[1:])

        def cam_residuals(T, uv_k, w_k):
            p_cam = jax.vmap(lambda X: T.R.T @ (X - T.t))(points)
            z = jnp.where(jnp.abs(p_cam[:, 2]) < 1e-6, 1e-6, p_cam[:, 2])
            pred = p_cam[:, :2] / z[:, None]
            return (pred - uv_k) * (w_k * w_uv)[:, None]

        r_uv = jax.vmap(cam_residuals)(poses, uv, weight)
        T0 = jax.tree.map(lambda a: a[0], poses)
        r_prior = jnp.concatenate([so3.local(pose0_prior.R, T0.R),
                                   T0.t - pose0_prior.t]) * w_prior
        return jnp.concatenate([r_imu.reshape(-1), r_uv.reshape(-1), r_prior])

    x0 = (poses0, vels0.astype(dtype), bias0.astype(dtype),
          points0.astype(dtype))
    res = levenberg_marquardt(residual, x0, mani, max_iters=max_iters,
                              lambda_init=lambda_init)
    poses, vels, bias, points = res.x
    return ViSolution(poses, vels, bias, res.cost, res.iterations), points

"""IMU preintegration + inertial smoother tests.

Validation strategy follows SURVEY §4: simulation round-trip against an
analytically-known trajectory (the st23 preintegration math has no reference
implementation to cross-check, so the ground truth IS the closed form), plus
Monte-Carlo covariance consistency and first-order bias-correction order
checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tricks_tpu.estimation import preintegration as pim
from slam_tricks_tpu.estimation import vi_smoother as vis
from slam_tricks_tpu.manifolds import se3, so3


def _t_rmse(ta, tb):
    """Translation-array wrapper around the library ATE metric."""
    from slam_tricks_tpu.evaluation.metrics import ate_translation_rmse

    class _P:                       # metric takes pose-like (.t) stacks
        def __init__(self, t):
            self.t = jnp.asarray(t)

    return float(ate_translation_rmse(_P(ta), _P(tb)))


def _sim(**kw):
    kw.setdefault("n_keyframes", 10)
    kw.setdefault("samples_per_seg", 40)
    kw.setdefault("dt", 0.0025)
    return vis.simulate_vi(**kw)


def test_zero_noise_residual_is_zero():
    """Exact IMU stream + true states + true biases -> residual ~ 0
    (limited only by the O(dt^2) zero-order-hold integration error)."""
    sim = _sim()
    pre = vis.preintegrate_segments(sim, sim.bg_true, sim.ba_true)
    bg, ba = sim.bg_true, sim.ba_true

    def factor(pre_k, k):
        Ti = jax.tree.map(lambda a: a[k], sim.poses_true)
        Tj = jax.tree.map(lambda a: a[k + 1], sim.poses_true)
        return pim.imu_residual(pre_k, Ti, sim.vels_true[k], Tj,
                                sim.vels_true[k + 1], bg, ba)

    for k in [0, 4, 8]:
        pre_k = jax.tree.map(lambda a: a[k], pre)
        r = factor(pre_k, k)
        assert float(jnp.max(jnp.abs(r))) < 5e-5, (k, np.asarray(r))


def test_integration_is_second_order():
    """Halving dt must quarter the dead-reckoning drift (midpoint-rotation
    integrator; the plain start-of-step ZOH is only first-order)."""
    errs = []
    for dt, S in [(0.005, 20), (0.0025, 40), (0.00125, 80)]:
        sim = vis.simulate_vi(n_keyframes=4, samples_per_seg=S, dt=dt)
        pre = vis.preintegrate_segments(sim, sim.bg_true, sim.ba_true)
        T0 = jax.tree.map(lambda a: a[0], sim.poses_true)
        poses, _ = vis.dead_reckon(pre, T0, sim.vels_true[0],
                                   sim.bg_true, sim.ba_true)
        errs.append(float(jnp.max(jnp.abs(poses.t - sim.poses_true.t))))
    assert errs[0] / errs[1] > 3.0, errs
    assert errs[1] / errs[2] > 3.0, errs


def test_preintegration_matches_whole_segment():
    """Concatenating two segments' samples = composing their deltas."""
    sim = _sim(n_keyframes=3)
    bg, ba = sim.bg_true, sim.ba_true
    g01 = jnp.concatenate([sim.gyro[0], sim.gyro[1]])
    a01 = jnp.concatenate([sim.accel[0], sim.accel[1]])
    whole = pim.preintegrate(g01, a01, sim.dt, bg, ba)
    p0 = pim.preintegrate(sim.gyro[0], sim.accel[0], sim.dt, bg, ba)
    p1 = pim.preintegrate(sim.gyro[1], sim.accel[1], sim.dt, bg, ba)
    # composition: dR = dR0 dR1, dv = dv0 + dR0 dv1, dp = dp0 + dv0 dt1 + dR0 dp1
    np.testing.assert_allclose(whole.dR, p0.dR @ p1.dR, atol=1e-12)
    np.testing.assert_allclose(whole.dv, p0.dv + p0.dR @ p1.dv, atol=1e-12)
    np.testing.assert_allclose(
        whole.dp, p0.dp + p0.dv * p1.dt + p0.dR @ p1.dp, atol=1e-12)


def test_bias_correction_is_first_order():
    """Corrected deltas at bias b+db must match re-integration at b+db to
    second order: error(s*db) ~ s^2 * error(db)."""
    sim = _sim(n_keyframes=2, samples_per_seg=80)
    bg, ba = sim.bg_true, sim.ba_true
    pre = pim.preintegrate(sim.gyro[0], sim.accel[0], sim.dt, bg, ba)

    def correction_error(scale):
        dbg = jnp.asarray([0.01, -0.02, 0.015]) * scale
        dba = jnp.asarray([0.05, 0.03, -0.04]) * scale
        exact = pim.preintegrate(sim.gyro[0], sim.accel[0], sim.dt,
                                 bg + dbg, ba + dba)
        dR, dv, dp = pim.bias_corrected(pre, bg + dbg, ba + dba)
        eR = float(jnp.linalg.norm(so3.log(dR.T @ exact.dR)))
        ev = float(jnp.linalg.norm(dv - exact.dv))
        ep = float(jnp.linalg.norm(dp - exact.dp))
        return eR + ev + ep

    e1, e2 = correction_error(1.0), correction_error(2.0)
    assert e1 < 2e-4
    assert e2 / max(e1, 1e-300) > 3.0  # ~4x = quadratic, >3 allows curvature


def test_covariance_monte_carlo():
    """Propagated 9x9 covariance vs the sample covariance of noisy
    integrations (400 trials) — diagonal agreement within 35%."""
    sim = _sim(n_keyframes=2, samples_per_seg=25, dt=0.004)
    bg, ba = sim.bg_true, sim.ba_true
    sigma_g, sigma_a = 2e-3, 2e-2
    pre = pim.preintegrate(sim.gyro[0], sim.accel[0], sim.dt, bg, ba,
                           sigma_g=sigma_g, sigma_a=sigma_a)

    rng = np.random.default_rng(7)
    T = 400
    sg_d = sigma_g / np.sqrt(sim.dt)
    sa_d = sigma_a / np.sqrt(sim.dt)
    gn = jnp.asarray(rng.normal(0, sg_d, (T,) + sim.gyro[0].shape))
    an = jnp.asarray(rng.normal(0, sa_d, (T,) + sim.accel[0].shape))

    noisy = jax.vmap(lambda g, a: pim.preintegrate(
        sim.gyro[0] + g, sim.accel[0] + a, sim.dt, bg, ba))(gn, an)

    # tangent errors vs the noiseless delta, [phi, v, p]
    dphi = jax.vmap(lambda R: so3.log(pre.dR.T @ R))(noisy.dR)
    err = jnp.concatenate([dphi, noisy.dv - pre.dv, noisy.dp - pre.dp], axis=1)
    sample_cov = np.cov(np.asarray(err).T)
    pred = np.asarray(pre.cov)
    ratio = np.diag(sample_cov) / np.diag(pred)
    assert np.all(ratio > 0.65) and np.all(ratio < 1.35), ratio


def test_dead_reckoning_matches_truth_zero_noise():
    sim = _sim()
    pre = vis.preintegrate_segments(sim, sim.bg_true, sim.ba_true)
    T0 = jax.tree.map(lambda a: a[0], sim.poses_true)
    poses, vels = vis.dead_reckon(pre, T0, sim.vels_true[0],
                                  sim.bg_true, sim.ba_true)
    np.testing.assert_allclose(poses.t, sim.poses_true.t, atol=1e-5)
    np.testing.assert_allclose(vels, sim.vels_true, atol=1e-5)


def test_vi_smoother_recovers_states_and_bias():
    """Noisy IMU + noisy pose observations + WRONG initial bias: the smoother
    must beat both dead-reckoning and the raw observations, and pull the
    shared bias toward truth."""
    sim = _sim(n_keyframes=20, samples_per_seg=100, dt=0.005, sigma_g=2e-4,
               sigma_a=2e-3, obs_rot_noise=0.005, obs_trans_noise=0.01, seed=3)
    bias_guess = jnp.zeros(6, dtype=sim.vels_true.dtype)  # truth is nonzero
    pre = vis.preintegrate_segments(sim, bias_guess[:3], bias_guess[3:],
                                    sigma_g=2e-4, sigma_a=2e-3)
    T0 = jax.tree.map(lambda a: a[0], sim.obs_poses)
    poses_dr, vels_dr = vis.dead_reckon(pre, T0, sim.vels_true[0],
                                        bias_guess[:3], bias_guess[3:])
    sol = vis.solve_vi_smoother(pre, sim.obs_poses, poses_dr, vels_dr,
                                bias_guess, obs_rot_sigma=0.005,
                                obs_trans_sigma=0.01)
    ate_dr = _t_rmse(poses_dr.t, sim.poses_true.t)
    ate_obs = _t_rmse(sim.obs_poses.t, sim.poses_true.t)
    ate_sm = _t_rmse(sol.poses.t, sim.poses_true.t)
    assert ate_sm < ate_obs * 0.7, (ate_sm, ate_obs)
    assert ate_sm < ate_dr * 0.5, (ate_sm, ate_dr)
    bias_true = jnp.concatenate([sim.bg_true, sim.ba_true])
    err0 = float(jnp.linalg.norm(bias_guess - bias_true))
    err1 = float(jnp.linalg.norm(sol.bias - bias_true))
    assert err1 < err0 * 0.1, (err1, err0)


def test_vi_smoother_f32():
    """The whole pipeline must run in f32 (the production dtype)."""
    sim = _sim(n_keyframes=8, samples_per_seg=20, sigma_g=2e-4, sigma_a=2e-3,
               obs_rot_noise=0.01, obs_trans_noise=0.02, seed=5,
               dtype=jnp.float32)
    bias_guess = jnp.zeros(6, dtype=jnp.float32)
    pre = vis.preintegrate_segments(sim, bias_guess[:3], bias_guess[3:],
                                    sigma_g=2e-4, sigma_a=2e-3)
    T0 = jax.tree.map(lambda a: a[0], sim.obs_poses)
    poses_dr, vels_dr = vis.dead_reckon(pre, T0, sim.vels_true[0],
                                        bias_guess[:3], bias_guess[3:])
    sol = vis.solve_vi_smoother(pre, sim.obs_poses, poses_dr, vels_dr,
                                bias_guess, obs_rot_sigma=0.01,
                                obs_trans_sigma=0.02)
    assert sol.poses.t.dtype == jnp.float32
    ate_obs = _t_rmse(sim.obs_poses.t, sim.poses_true.t)
    ate_sm = _t_rmse(sol.poses.t, sim.poses_true.t)
    assert ate_sm < ate_obs, (ate_sm, ate_obs)


def test_vi_ba_recovers_metric_scale():
    """The headline visual-inertial property: a monocular BA initialized at
    0.7x scale STAYS near 0.7x (scale is a gauge freedom of reprojection),
    while adding IMU factors pulls the scale back to metric 1.0x."""
    sim = _sim(n_keyframes=12, samples_per_seg=100, dt=0.005,
               sigma_g=1e-4, sigma_a=1e-3, seed=11)
    points, uv, w = vis.simulate_vi_landmarks(sim, n_landmarks=80,
                                              uv_noise=5e-4, seed=2)
    assert float(w.sum()) > 300  # enough visible observations

    # initialization: everything shrunk 0.7x about the first position
    s0 = 0.7
    c = sim.poses_true.t[0]
    poses0 = se3.SE3(sim.poses_true.R, c + s0 * (sim.poses_true.t - c))
    points0 = c + s0 * (points - c)
    vels0 = s0 * sim.vels_true
    bias0 = jnp.zeros(6, dtype=sim.vels_true.dtype)
    pre = vis.preintegrate_segments(sim, bias0[:3], bias0[3:],
                                    sigma_g=1e-4, sigma_a=1e-3)

    def scale_of(t_est):
        d_est = jnp.linalg.norm(t_est[1:] - t_est[:-1], axis=1)
        d_true = jnp.linalg.norm(sim.poses_true.t[1:] - sim.poses_true.t[:-1],
                                 axis=1)
        return float(jnp.mean(d_est / d_true))

    sol, pts_est = vis.solve_vi_ba(pre, uv, w, poses0, vels0, bias0, points0,
                                   pose0_prior=jax.tree.map(
                                       lambda a: a[0], sim.poses_true))
    s_vi = scale_of(sol.poses.t)
    assert abs(s_vi - 1.0) < 0.03, s_vi

    # monocular-only comparator: zero IMU weight via huge covariance is not
    # expressible, so solve with the same LM but reprojection+prior only
    from slam_tricks_tpu.manifolds import manifold as man
    from slam_tricks_tpu.solvers.lm import levenberg_marquardt
    K, L = uv.shape[0], points.shape[0]
    mani = man.product(man.batched(man.so3_r3(), K), man.euclidean((L, 3)))
    prior = jax.tree.map(lambda a: a[0], sim.poses_true)

    def resid_mono(x):
        poses, pts = x

        def cam(T, uv_k, w_k):
            p_cam = jax.vmap(lambda X: T.R.T @ (X - T.t))(pts)
            z = jnp.where(jnp.abs(p_cam[:, 2]) < 1e-6, 1e-6, p_cam[:, 2])
            return (p_cam[:, :2] / z[:, None] - uv_k) * (w_k * 1e3)[:, None]

        r_uv = jax.vmap(cam)(poses, uv, w)
        T0 = jax.tree.map(lambda a: a[0], poses)
        r_p = jnp.concatenate([so3.local(prior.R, T0.R),
                               T0.t - prior.t]) * 1e4
        return jnp.concatenate([r_uv.reshape(-1), r_p])

    res_mono = levenberg_marquardt(resid_mono, (poses0, points0), mani,
                                   max_iters=40)
    s_mono = scale_of(res_mono.x[0].t)
    assert abs(s_mono - s0) < 0.1, s_mono  # stayed at the wrong scale


def test_vi_initialize_recovers_scale_gravity_velocity():
    """Clean IMU + up-to-scale visual poses: the linear bootstrap recovers
    the metric scale, the world gravity vector, and every keyframe velocity
    essentially exactly."""
    from slam_tricks_tpu.estimation.vi_init import vi_initialize

    sim = _sim(n_keyframes=12, samples_per_seg=50, dt=0.005,
               bg=(0, 0, 0), ba=(0, 0, 0))
    z3 = jnp.zeros(3, sim.vels_true.dtype)
    pre = vis.preintegrate_segments(sim, z3, z3)
    alpha = 1 / 2.3
    pv = se3.SE3(sim.poses_true.R, sim.poses_true.t * alpha)
    init = vi_initialize(pre, pv)
    assert abs(float(init.scale) - 2.3) < 1e-4
    np.testing.assert_allclose(np.asarray(init.gravity), [0, 0, -9.81],
                               atol=1e-8)
    assert float(jnp.max(jnp.abs(init.vels - sim.vels_true))) < 1e-4
    # metric positions from the visual ones
    t_metric = float(init.scale) * pv.t
    np.testing.assert_allclose(t_metric, sim.poses_true.t, atol=1e-3)


def test_vi_initialize_biased_imu_close():
    """With uncorrected true biases and IMU noise the bootstrap is only
    approximate — but still within a few percent, good enough to seed the
    smoother (which then estimates the bias)."""
    from slam_tricks_tpu.estimation.vi_init import vi_initialize

    sim = _sim(n_keyframes=16, samples_per_seg=100, dt=0.005,
               sigma_g=2e-4, sigma_a=2e-3, seed=4)
    z3 = jnp.zeros(3, sim.vels_true.dtype)
    pre = vis.preintegrate_segments(sim, z3, z3)
    pv = se3.SE3(sim.poses_true.R, sim.poses_true.t / 2.3)
    init = vi_initialize(pre, pv)
    assert abs(float(init.scale) - 2.3) / 2.3 < 0.05
    g = np.asarray(init.gravity)
    assert abs(np.linalg.norm(g) - 9.81) < 1e-6          # norm constraint
    assert g[2] < -9.7                                   # direction correct


def test_vi_chain_matches_dense_smoother():
    """The block-tridiagonal + bias-Schur chain solver reaches the same
    optimum as the dense LM smoother (machine-precision pose parity)."""
    from slam_tricks_tpu.estimation.vi_chain import solve_vi_chain

    sim = _sim(n_keyframes=20, samples_per_seg=50, dt=0.005, sigma_g=2e-4,
               sigma_a=2e-3, obs_rot_noise=0.005, obs_trans_noise=0.01,
               seed=3)
    bias0 = jnp.zeros(6, dtype=sim.vels_true.dtype)
    pre = vis.preintegrate_segments(sim, bias0[:3], bias0[3:],
                                    sigma_g=2e-4, sigma_a=2e-3)
    sol_d = vis.solve_vi_smoother(pre, sim.obs_poses, sim.obs_poses,
                                  sim.vels_true, bias0, obs_rot_sigma=0.005,
                                  obs_trans_sigma=0.01, max_iters=40)
    sol_c = solve_vi_chain(pre, sim.obs_poses, sim.obs_poses, sim.vels_true,
                           bias0, obs_rot_sigma=0.005, obs_trans_sigma=0.01,
                           max_iters=40)
    np.testing.assert_allclose(float(sol_c.cost), float(sol_d.cost),
                               rtol=1e-10)
    assert float(jnp.max(jnp.abs(sol_d.poses.t - sol_c.poses.t))) < 1e-10
    assert float(jnp.max(jnp.abs(sol_d.bias - sol_c.bias))) < 1e-10


@pytest.mark.slow
def test_vi_chain_large_f32():
    """K=1000 keyframes in PURE f32: the chain solver needs no f64 (every
    state is observation-anchored, unlike absolute pose-graph chains)."""
    from slam_tricks_tpu.estimation.vi_chain import solve_vi_chain

    K = 1000
    sim = _sim(n_keyframes=K, samples_per_seg=20, dt=0.005, sigma_g=2e-4,
               sigma_a=2e-3, obs_rot_noise=0.005, obs_trans_noise=0.01,
               seed=3, dtype=jnp.float32)
    bias0 = jnp.zeros(6, jnp.float32)
    pre = vis.preintegrate_segments(sim, bias0[:3], bias0[3:],
                                    sigma_g=2e-4, sigma_a=2e-3)
    sol = solve_vi_chain(pre, sim.obs_poses, sim.obs_poses, sim.vels_true,
                         bias0, obs_rot_sigma=0.005, obs_trans_sigma=0.01,
                         max_iters=25)
    ate_obs = _t_rmse(sim.obs_poses.t, sim.poses_true.t)
    ate_sm = _t_rmse(sol.poses.t, sim.poses_true.t)
    assert ate_sm < ate_obs * 0.4, (ate_sm, ate_obs)
    bt = jnp.concatenate([sim.bg_true, sim.ba_true])
    assert float(jnp.linalg.norm(sol.bias - bt)) < 0.02


def test_vi_chain_covariances_match_dense_inverse():
    """Takahashi diag + bias-Woodbury marginals == the corresponding blocks
    of the dense bordered-Hessian inverse."""
    from slam_tricks_tpu.estimation.vi_chain import (_make_system,
                                                     solve_vi_chain,
                                                     vi_chain_covariances)

    K = 8
    sim = _sim(n_keyframes=K, samples_per_seg=30, dt=0.005, sigma_g=2e-4,
               sigma_a=2e-3, obs_rot_noise=0.005, obs_trans_noise=0.01,
               seed=3)
    bias0 = jnp.zeros(6, jnp.float64)
    pre = vis.preintegrate_segments(sim, bias0[:3], bias0[3:],
                                    sigma_g=2e-4, sigma_a=2e-3)
    sol = solve_vi_chain(pre, sim.obs_poses, sim.obs_poses, sim.vels_true,
                         bias0, obs_rot_sigma=0.005, obs_trans_sigma=0.01,
                         max_iters=30)
    sc, bc = vi_chain_covariances(pre, sim.obs_poses, sol.poses, sol.vels,
                                  sol.bias, obs_rot_sigma=0.005,
                                  obs_trans_sigma=0.01)
    anchor = jnp.concatenate([pre.bg0[0], pre.ba0[0]])
    lin, _ = _make_system(pre, sim.obs_poses, jnp.float64(1 / 0.005),
                          jnp.float64(1 / 0.01), jnp.float64(1.0), anchor,
                          (0.0, 0.0, -9.81), K, jnp.float64)
    D, E, U, Hbb, _, _ = lin(sol.poses, sol.vels, sol.bias)
    n = 9 * K
    H = np.zeros((n + 6, n + 6))
    for k in range(K):
        H[9 * k:9 * k + 9, 9 * k:9 * k + 9] = np.asarray(D[k])
        H[9 * k:9 * k + 9, n:] = np.asarray(U[k])
        H[n:, 9 * k:9 * k + 9] = np.asarray(U[k]).T
    for k in range(K - 1):
        H[9 * (k + 1):9 * (k + 2), 9 * k:9 * k + 9] = np.asarray(E[k])
        H[9 * k:9 * k + 9, 9 * (k + 1):9 * (k + 2)] = np.asarray(E[k]).T
    H[n:, n:] = np.asarray(Hbb)
    Hinv = np.linalg.inv(H)
    for k in range(K):
        np.testing.assert_allclose(
            np.asarray(sc[k]), Hinv[9 * k:9 * k + 9, 9 * k:9 * k + 9],
            atol=1e-12)
    np.testing.assert_allclose(np.asarray(bc), Hinv[n:, n:], atol=1e-12)

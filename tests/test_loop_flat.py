"""Loop-closure BA (solvers/loop_flat): banded factor + Woodbury correction.

Parity vs the dense reference solver (schur.solve_ba) on loop-closure scenes
— the visibility class where the pure banded solver raises and the PCG
fallback loses to dense (VERDICT r3 item 1). Covers both factor widths
(direct 3M and support-compressed 6|A|), the no-loop degenerate case, and
robust IRLS."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slam_tricks_tpu.sim import make_trajectory_scene, perturb_scene
from slam_tricks_tpu.sim.ba_scene import make_loop_scene
from slam_tricks_tpu.solvers import banded_flat, loop_flat, schur


def _problem(n_cams=48, n_points=800, track_len=5, seed=31, dtype=np.float64,
             **kw):
    scene = make_loop_scene(n_cams=n_cams, n_points=n_points,
                            track_len=track_len, seed=seed, dtype=dtype, **kw)
    poses0, points0, fixed = perturb_scene(
        scene, pose_rot_noise=0.002, pose_trans_noise=0.01, point_noise=0.01,
        seed=seed + 1)
    return scene, poses0, points0, fixed


def test_banded_raises_on_loop_scene():
    """The structure this module exists for: the banded builder must refuse
    tracks spanning more than the band."""
    scene, *_ = _problem()
    with pytest.raises(ValueError):
        banded_flat.build_banded_work(scene.obs, scene.n_cams, scene.n_points,
                                      dtype=np.float64, max_band=5)


def test_parity_vs_dense_compressed_factor():
    """Many loop landmarks (3M > 6|A|) -> support-compressed eigh factor."""
    dtype = np.float64
    scene, poses0, points0, fixed = _problem(dtype=dtype)
    lw = loop_flat.build_loop_work(scene.obs, scene.n_cams, scene.n_points,
                                   dtype=dtype, max_band=5)
    assert 3 * lw.lc_weight.shape[1] > 6 * lw.onehot_A.shape[0]
    it = 6
    ref = schur.solve_ba(poses0, points0, scene.obs, fixed_mask=fixed,
                         max_iters=it)
    out = loop_flat.solve_ba_loop(poses0, points0, lw, fixed_mask=fixed,
                                  max_iters=it)
    assert int(out.it) == int(ref.it)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.poses.t),
                               np.asarray(ref.poses.t), atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.points),
                               np.asarray(ref.points), atol=1e-6)


def test_parity_vs_dense_direct_factor():
    """Few loop landmarks (3M <= 6|A|) -> direct width-3M factor."""
    dtype = np.float64
    scene, poses0, points0, fixed = _problem(n_cams=40, n_points=250,
                                             track_len=4, seed=41,
                                             loop_frac=0.01, dtype=dtype)
    lw = loop_flat.build_loop_work(scene.obs, scene.n_cams, scene.n_points,
                                   dtype=dtype, max_band=4)
    assert lw.lc_weight.shape[1] >= 8
    assert 3 * lw.lc_weight.shape[1] <= 6 * lw.onehot_A.shape[0]
    it = 6
    ref = schur.solve_ba(poses0, points0, scene.obs, fixed_mask=fixed,
                         max_iters=it)
    out = loop_flat.solve_ba_loop(poses0, points0, lw, fixed_mask=fixed,
                                  max_iters=it)
    assert int(out.it) == int(ref.it)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.poses.t),
                               np.asarray(ref.poses.t), atol=1e-7)


def test_no_loop_degenerates_to_banded():
    """A pure trajectory scene routes every landmark to the banded part; the
    LC machinery must be an exact no-op (U = 0, capacitance = I)."""
    dtype = np.float64
    scene = make_trajectory_scene(n_cams=32, n_points=400, track_len=4,
                                  seed=51, dtype=dtype)
    poses0, points0, fixed = perturb_scene(
        scene, pose_rot_noise=0.002, pose_trans_noise=0.01, point_noise=0.01,
        seed=52)
    lw = loop_flat.build_loop_work(scene.obs, scene.n_cams, scene.n_points,
                                   dtype=dtype, max_band=4)
    assert float(jnp.sum(lw.lc_weight)) == 0.0
    bw = banded_flat.build_banded_work(scene.obs, scene.n_cams,
                                       scene.n_points, dtype=dtype,
                                       max_band=4)
    it = 5
    ref = banded_flat.solve_ba_banded(poses0, points0, bw, fixed_mask=fixed,
                                      max_iters=it)
    out = loop_flat.solve_ba_loop(poses0, points0, lw, fixed_mask=fixed,
                                  max_iters=it)
    assert int(out.it) == int(ref.it)
    # same math, different reassociation (the multi-RHS solve pads the rhs)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.poses.t),
                               np.asarray(ref.poses.t), atol=1e-8)


@pytest.mark.slow
def test_loop_closure_improves_drift():
    """The point of loop closures: with odometry-style noise accumulating
    along the trajectory, closing the loop must tie the far end back to the
    start. Solve the SAME noisy scene with and without the revisit
    observations; the loop-closed solution's pose error must be smaller."""
    dtype = np.float64
    scene, poses0, points0, fixed = _problem(n_cams=64, n_points=1200,
                                             track_len=5, seed=61,
                                             pix_noise=2e-3, dtype=dtype)
    lw = loop_flat.build_loop_work(scene.obs, scene.n_cams, scene.n_points,
                                   dtype=dtype, max_band=5)
    out = loop_flat.solve_ba_loop(poses0, points0, lw, fixed_mask=fixed,
                                  max_iters=30)
    # drop the LC observations -> pure odometry problem
    obs = scene.obs
    lm = np.asarray(obs.lm_idx)
    cam = np.asarray(obs.cam_idx)
    w = np.asarray(obs.weight).copy()
    lc_ids = set(np.asarray(lw.lc_lm)[np.asarray(lw.lc_weight).sum(0) > 0]
                 .tolist())
    kill = np.isin(lm, list(lc_ids)) & (cam >= scene.n_cams - 5)
    w[kill] = 0.0
    obs_odo = obs._replace(weight=jnp.asarray(w))
    bw = banded_flat.build_banded_work(obs_odo, scene.n_cams, scene.n_points,
                                       dtype=dtype, max_band=5)
    out_odo = banded_flat.solve_ba_banded(poses0, points0, bw,
                                          fixed_mask=fixed, max_iters=30)
    t_true = np.asarray(scene.poses_true.t)
    err_loop = np.sqrt(np.mean((np.asarray(out.poses.t) - t_true) ** 2))
    err_odo = np.sqrt(np.mean((np.asarray(out_odo.poses.t) - t_true) ** 2))
    assert err_loop < err_odo, (err_loop, err_odo)


def test_robust_loss_parity():
    """IRLS (Tukey) through the loop solver matches the dense robust solve."""
    from slam_tricks_tpu.residuals import robust

    dtype = np.float64
    scene, poses0, points0, fixed = _problem(n_cams=32, n_points=400,
                                             track_len=4, seed=71,
                                             dtype=dtype)
    rng = np.random.default_rng(5)
    uv = np.asarray(scene.obs.uv).copy()
    valid = np.flatnonzero(np.asarray(scene.obs.weight) > 0)
    hit = rng.choice(valid, valid.size // 40, replace=False)
    uv[hit] += rng.normal(scale=0.3, size=(hit.size, 2))
    obs = scene.obs._replace(uv=jnp.asarray(uv))

    loss = robust.tukey(0.02)
    it = 6
    ref = schur.solve_ba(poses0, points0, obs, fixed_mask=fixed,
                         max_iters=it, loss=loss)
    lw = loop_flat.build_loop_work(obs, scene.n_cams, scene.n_points,
                                   dtype=dtype, max_band=4)
    out = loop_flat.solve_ba_loop(poses0, points0, lw, fixed_mask=fixed,
                                  max_iters=it, loss=loss)
    assert int(out.it) == int(ref.it)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.poses.t),
                               np.asarray(ref.poses.t), atol=1e-6)


def test_f32_convergence():
    """f32 (the production dtype) reaches the noise floor on a
    loop-closure scene."""
    dtype = np.float32
    scene, poses0, points0, fixed = _problem(n_cams=64, n_points=1500,
                                             track_len=6, seed=81,
                                             pix_noise=1e-3, dtype=dtype)
    lw = loop_flat.build_loop_work(scene.obs, scene.n_cams, scene.n_points,
                                   dtype=dtype, max_band=6)
    out = loop_flat.solve_ba_loop(poses0, points0, lw, fixed_mask=fixed,
                                  max_iters=25)
    n_obs = float(np.sum(np.asarray(scene.obs.weight)))
    rms = np.sqrt(2.0 * float(out.cost) / n_obs)
    # reprojection RMS at the 1e-3 noise injected
    assert rms < 2e-3, rms


def test_loop_pose_covariances_vs_dense():
    """loop_pose_covariances (Takahashi + rank-q Woodbury correction) must
    match the dense S^-1 diagonal blocks (Ceres Covariance role for the
    loop-closure visibility class)."""
    from slam_tricks_tpu.solvers.covariance import ba_covariances
    from slam_tricks_tpu.solvers.loop_flat import loop_pose_covariances

    dtype = np.float64
    scene, poses0, points0, fixed = _problem(n_cams=40, n_points=500,
                                             track_len=4, seed=31,
                                             pix_noise=1e-3, dtype=dtype)
    lw = loop_flat.build_loop_work(scene.obs, scene.n_cams, scene.n_points,
                                   dtype=dtype, max_band=4)
    out = loop_flat.solve_ba_loop(poses0, points0, lw, fixed_mask=fixed,
                                  max_iters=15)
    ref_cov, _ = ba_covariances(out.poses, out.points, scene.obs, fixed,
                                lam=0.0)
    cov = loop_pose_covariances(out.poses, out.points, lw, fixed, lam=0.0)
    scale = float(np.max(np.abs(np.asarray(ref_cov))))
    err = float(np.max(np.abs(np.asarray(cov) - np.asarray(ref_cov))))
    # kappa(S)-limited agreement (the covariances themselves are ~1e5)
    assert err < 1e-4 * scale, (err, scale)

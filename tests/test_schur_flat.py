"""Flat-layout BA solver: exact block/step parity with the reference-grade
dense Schur path, full-solve convergence parity, and f32 (production-dtype)
coverage — VERDICT r1 items 1/6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tricks_tpu.sim import make_scene, perturb_scene
from slam_tricks_tpu.solvers import schur, schur_flat


def _problem(dtype=np.float64, pix_noise=0.0, seed=21):
    scene = make_scene(n_per_wall=10, n_cams=6, seed=seed, pix_noise=pix_noise,
                       dtype=dtype)
    poses0, points0, fixed = perturb_scene(scene, seed=seed + 1)
    work = schur_flat.build_flat_work(scene.obs, scene.n_cams, scene.n_points,
                                      dtype=dtype)
    return scene, poses0, points0, fixed, work


def test_blocks_match_dense_assembly():
    scene, poses0, points0, fixed, work = _problem()
    obs = scene.obs
    C, L = scene.n_cams, scene.n_points
    r, Jp, Jl = schur._linearize_obs(poses0, points0, obs.cam_idx, obs.lm_idx,
                                     obs.uv, obs.weight)
    Hpp, Hll, gp, gl, W_obs = schur._assemble(r, Jp, Jl, obs.cam_idx,
                                              obs.lm_idx, C, L)
    Hpp_f, gp_f, Hll_f, gl_f, W_f, cost_f = schur_flat._iteration_quantities(
        poses0, points0, obs, work, C, L)
    np.testing.assert_allclose(schur_flat._sym6_expand(Hpp_f), Hpp, atol=1e-12)
    np.testing.assert_allclose(gp_f, gp, atol=1e-13)
    h = Hll_f
    Hll_33 = jnp.stack([jnp.stack([h[0], h[1], h[2]], -1),
                        jnp.stack([h[1], h[3], h[4]], -1),
                        jnp.stack([h[2], h[4], h[5]], -1)], -2)
    np.testing.assert_allclose(Hll_33, Hll, atol=1e-13)
    np.testing.assert_allclose(gl_f, gl, atol=1e-13)
    np.testing.assert_allclose(W_f.reshape(-1, 6, 3), W_obs, atol=1e-13)
    np.testing.assert_allclose(
        float(cost_f),
        float(schur._cost(poses0, points0, obs.cam_idx, obs.lm_idx, obs.uv,
                          obs.weight)), rtol=1e-12)


def test_step_matches_dense_reduce():
    scene, poses0, points0, fixed, work = _problem()
    obs = scene.obs
    C, L = scene.n_cams, scene.n_points
    r, Jp, Jl = schur._linearize_obs(poses0, points0, obs.cam_idx, obs.lm_idx,
                                     obs.uv, obs.weight)
    Hpp, Hll, gp, gl, W_obs = schur._assemble(r, Jp, Jl, obs.cam_idx,
                                              obs.lm_idx, C, L)
    Hpp_f, gp_f, Hll_f, gl_f, W_f, _ = schur_flat._iteration_quantities(
        poses0, points0, obs, work, C, L)
    lam = jnp.asarray(1e-4)
    dp0, dl0 = schur._schur_reduce(Hpp, Hll, gp, gl, W_obs, obs.cam_idx,
                                   obs.lm_idx, lam, C, L, fixed)
    dp1, dl1, _, _ = schur_flat._solve_flat(Hpp_f, gp_f, Hll_f, gl_f, W_f,
                                            lam, fixed, work, C, L)
    np.testing.assert_allclose(dp1, dp0, atol=1e-12)
    np.testing.assert_allclose(dl1, dl0, atol=1e-12)


def test_full_solve_converges():
    scene, poses0, points0, fixed, work = _problem()
    single = schur.solve_ba(poses0, points0, scene.obs, fixed_mask=fixed,
                            max_iters=25)
    flat = schur_flat.solve_ba_flat(poses0, points0, scene.obs, work,
                                    fixed_mask=fixed, max_iters=25)
    assert float(flat.cost) < 1e-25, float(flat.cost)
    np.testing.assert_allclose(np.asarray(flat.points),
                               np.asarray(single.points), atol=1e-8)


def test_robust_loss_parity_and_outlier_rejection():
    """IRLS robust losses on the flat path (VERDICT r2 item 6): same final
    state as schur.solve_ba(loss=huber) on an outlier-contaminated scene, and
    the robust solve must beat the non-robust one on ground-truth recovery."""
    from slam_tricks_tpu.residuals import robust

    scene, poses0, points0, fixed, work = _problem()
    obs = scene.obs
    uv = np.asarray(obs.uv).copy()
    rng = np.random.default_rng(7)
    n_out = max(uv.shape[0] // 20, 3)
    out_idx = rng.choice(np.flatnonzero(np.asarray(obs.weight) > 0), n_out,
                         replace=False)
    uv[out_idx] += rng.normal(scale=0.5, size=(n_out, 2))   # gross outliers
    obs_c = obs._replace(uv=jnp.asarray(uv))

    loss = robust.huber(delta=0.01)
    ref = schur.solve_ba(poses0, points0, obs_c, fixed_mask=fixed,
                         max_iters=50, loss=loss)
    flat = schur_flat.solve_ba_flat(poses0, points0, obs_c, work,
                                    fixed_mask=fixed, max_iters=50, loss=loss)
    np.testing.assert_allclose(float(flat.cost), float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(flat.points), np.asarray(ref.points),
                               atol=1e-6)

    plain = schur_flat.solve_ba_flat(poses0, points0, obs_c, work,
                                     fixed_mask=fixed, max_iters=50)
    # judge robustness on the parameters the outliers should NOT drag: the
    # camera poses and the uncorrupted landmarks (a landmark whose own track
    # is corrupted legitimately moves to fit it under any loss)
    clean = np.ones(scene.n_points, bool)
    clean[np.asarray(obs.lm_idx)[out_idx]] = False
    err_rob = float(jnp.max(jnp.abs(flat.poses.t - scene.poses_true.t)))
    err_plain = float(jnp.max(jnp.abs(plain.poses.t - scene.poses_true.t)))
    assert err_rob < 0.2 * err_plain, (err_rob, err_plain)
    perr_rob = float(np.max(np.abs(
        np.asarray(flat.points)[clean] - np.asarray(scene.points_true)[clean])))
    perr_plain = float(np.max(np.abs(
        np.asarray(plain.points)[clean] - np.asarray(scene.points_true)[clean])))
    assert perr_rob < 0.2 * perr_plain, (perr_rob, perr_plain)


def test_full_solve_f32():
    """Production dtype: the flat solver must reach sub-pixel-squared cost on
    the noisy scene in pure f32 (f32 production-dtype coverage)."""
    scene, poses0, points0, fixed, work = _problem(dtype=np.float32,
                                                   pix_noise=1e-3, seed=41)
    flat = jax.jit(schur_flat.solve_ba_flat,
                   static_argnames=("max_iters",))(
        poses0, points0, scene.obs, work, fixed_mask=fixed, max_iters=30)
    assert flat.points.dtype == jnp.float32
    rms = np.sqrt(float(flat.cost) / float(jnp.sum(scene.obs.weight)))
    assert rms < 2.5e-3, rms

    # and the noise-free scene must reach near-machine-f32 optimum
    scene2, poses2, points2, fixed2, work2 = _problem(dtype=np.float32, seed=43)
    flat2 = jax.jit(schur_flat.solve_ba_flat,
                    static_argnames=("max_iters",))(
        poses2, points2, scene2.obs, work2, fixed_mask=fixed2, max_iters=30)
    rms2 = np.sqrt(float(flat2.cost) / float(jnp.sum(scene2.obs.weight)))
    assert rms2 < 1e-5, rms2


def test_grid_layout_parity():
    """Track-grid mode (gathers -> reshapes) must match the gather path
    exactly: blocks, one damped step, and the full solve."""
    from slam_tricks_tpu.solvers.schur_flat import grid_order_obs

    scene, poses0, points0, fixed, work = _problem()
    C, L = scene.n_cams, scene.n_points
    obs_g = grid_order_obs(scene.obs, L, dtype=np.float64)
    work_g = schur_flat.build_flat_work(obs_g, C, L, dtype=np.float64,
                                        grid=True)

    Hf, gpf, Hlf, glf, Wf, costf = schur_flat._iteration_quantities(
        poses0, points0, scene.obs, work, C, L)
    Hg, gpg, Hlg, glg, Wg, costg = schur_flat._iteration_quantities(
        poses0, points0, obs_g, work_g, C, L)
    np.testing.assert_allclose(float(costg), float(costf), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(Hg), np.asarray(Hf), atol=1e-11)
    np.testing.assert_allclose(np.asarray(gpg), np.asarray(gpf), atol=1e-12)
    for a, b in zip(Hlg, Hlf):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    np.testing.assert_allclose(np.asarray(glg), np.asarray(glf), atol=1e-12)

    lam = jnp.asarray(1e-4)
    dp0, dl0, _, _ = schur_flat._solve_flat(Hf, gpf, Hlf, glf, Wf, lam,
                                            fixed, work, C, L)
    dp1, dl1, _, _ = schur_flat._solve_flat(Hg, gpg, Hlg, glg, Wg, lam,
                                            fixed, work_g, C, L)
    np.testing.assert_allclose(np.asarray(dp1), np.asarray(dp0), atol=1e-11)
    np.testing.assert_allclose(np.asarray(dl1), np.asarray(dl0), atol=1e-11)

    ref = schur_flat.solve_ba_flat(poses0, points0, scene.obs, work,
                                   fixed_mask=fixed, max_iters=10)
    out = jax.jit(schur_flat.solve_ba_flat, static_argnames=("max_iters",))(
        poses0, points0, obs_g, work_g, fixed_mask=fixed, max_iters=10)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-8,
                               atol=1e-25)


@pytest.mark.parametrize("n", [64, 200, 576])
def test_reduced_camera_solve_f32_matches_numpy(n):
    """The reduced-camera factor+solve the flat solvers use
    (jax.scipy cho_factor/cho_solve) in f32, up to the 96-camera headline's
    n = 6*96 = 576, against float64 numpy."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(n, n))
    S = (A @ A.T + n * np.eye(n)).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    cf = jax.scipy.linalg.cho_factor(jnp.asarray(S), lower=True)
    x = jax.scipy.linalg.cho_solve(cf, jnp.asarray(b))
    assert x.dtype == jnp.float32
    ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    err = np.max(np.abs(np.asarray(x, np.float64) - ref)) / np.max(np.abs(ref))
    assert err < 5e-6, err

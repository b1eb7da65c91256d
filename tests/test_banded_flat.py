"""Slot-major banded-direct trajectory BA (solvers/banded_flat): layout
invariants, exact step/trajectory parity with the flat dense Schur solver,
convergence, robust-loss support, and the structure-validation fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tricks_tpu.sim import make_scene, make_trajectory_scene, perturb_scene
from slam_tricks_tpu.solvers import banded_flat, schur_flat


def _problem(dtype=np.float64, n_cams=32, n_points=600, track_len=6, seed=71):
    scene = make_trajectory_scene(n_cams=n_cams, n_points=n_points,
                                  track_len=track_len, seed=seed, dtype=dtype)
    poses0, points0, fixed = perturb_scene(
        scene, pose_rot_noise=0.002, pose_trans_noise=0.01, point_noise=0.01,
        seed=seed + 1)
    bw = banded_flat.build_banded_work(scene.obs, scene.n_cams,
                                       scene.n_points, dtype=dtype)
    return scene, poses0, points0, fixed, bw


def test_layout_covers_all_observations():
    scene, *_, bw = _problem()
    w = np.asarray(scene.obs.weight)
    assert float(np.asarray(bw.weight).sum()) == pytest.approx(w.sum())
    # the scatter indices of real slots are a permutation of observed lms
    sc = np.asarray(bw.scatter_idx)
    real = sc[sc < scene.n_points]
    lm_obs = np.unique(np.asarray(scene.obs.lm_idx)[w > 0])
    assert np.array_equal(np.sort(real), lm_obs)


def test_quantities_match_flat():
    """Hpp/gp/Hll/gl/cost must equal the flat assembly exactly (same math,
    different layout)."""
    scene, poses0, points0, fixed, bw = _problem()
    C, L = scene.n_cams, scene.n_points
    work = schur_flat.build_flat_work(scene.obs, C, L, dtype=np.float64)
    Hf, gpf, Hlf, glf, Wf, costf = schur_flat._iteration_quantities(
        poses0, points0, scene.obs, work, C, L)

    points_s = points0[bw.gather_idx]
    Hb, gpb, Hlb, glb, Wb, costb = banded_flat._banded_quantities(
        poses0, points_s, bw, C)
    np.testing.assert_allclose(float(costb), float(costf), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(Hb), np.asarray(Hf), atol=1e-10)
    np.testing.assert_allclose(np.asarray(gpb), np.asarray(gpf), atol=1e-11)
    # landmark blocks: compare through the slot permutation
    sc = np.asarray(bw.scatter_idx)
    real = sc < L
    for k in range(6):
        np.testing.assert_allclose(np.asarray(Hlb[k])[real],
                                   np.asarray(Hlf[k])[sc[real]], atol=1e-11)
    np.testing.assert_allclose(np.asarray(glb).T[real],
                               np.asarray(glf)[sc[real]], atol=1e-11)


def test_step_matches_flat_dense():
    """One damped solve must equal the exact dense Schur reduction."""
    scene, poses0, points0, fixed, bw = _problem()
    C, L = scene.n_cams, scene.n_points
    work = schur_flat.build_flat_work(scene.obs, C, L, dtype=np.float64)
    Hf, gpf, Hlf, glf, Wf, _ = schur_flat._iteration_quantities(
        poses0, points0, scene.obs, work, C, L)
    lam = jnp.asarray(1e-4)
    dp0, dl0, _, _ = schur_flat._solve_flat(Hf, gpf, Hlf, glf, Wf, lam,
                                            fixed, work, C, L)

    points_s = points0[bw.gather_idx]
    Hb, gpb, Hlb, glb, Wb, _ = banded_flat._banded_quantities(
        poses0, points_s, bw, C)
    dp1, dl1, _, _ = banded_flat._solve_banded(Hb, gpb, list(Hlb), glb, Wb,
                                               lam, fixed, bw, C)
    np.testing.assert_allclose(np.asarray(dp1), np.asarray(dp0), atol=1e-9)
    sc = np.asarray(bw.scatter_idx)
    real = sc < L
    np.testing.assert_allclose(np.asarray(dl1)[real],
                               np.asarray(dl0)[sc[real]], atol=1e-9)


def test_full_solve_matches_flat_trajectory():
    scene, poses0, points0, fixed, bw = _problem()
    C, L = scene.n_cams, scene.n_points
    work = schur_flat.build_flat_work(scene.obs, C, L, dtype=np.float64)
    kw = dict(fixed_mask=fixed, max_iters=6)
    ref = schur_flat.solve_ba_flat(poses0, points0, scene.obs, work, **kw)
    out = banded_flat.solve_ba_banded(poses0, points0, bw, **kw)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(out.poses.t),
                               np.asarray(ref.poses.t), atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.points),
                               np.asarray(ref.points), atol=1e-8)


def test_robust_loss():
    from slam_tricks_tpu.residuals import robust

    scene, poses0, points0, fixed, bw = _problem()
    C, L = scene.n_cams, scene.n_points
    work = schur_flat.build_flat_work(scene.obs, C, L, dtype=np.float64)
    loss = robust.huber(0.01)
    kw = dict(fixed_mask=fixed, max_iters=6, loss=loss)
    ref = schur_flat.solve_ba_flat(poses0, points0, scene.obs, work, **kw)
    out = banded_flat.solve_ba_banded(poses0, points0, bw, **kw)
    # rtol: the two paths reassociate sums differently; after the r5
    # half-angle cosc rewrite their last-ulp rounding diverges by ~5e-8
    # relative at this near-zero optimum (both at cost ~1e-9)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6)


def test_f32_convergence_jit():
    scene, poses0, points0, fixed, bw = _problem(dtype=np.float32, seed=73)
    out = jax.jit(banded_flat.solve_ba_banded,
                  static_argnames=("max_iters",))(
        poses0, points0, bw, fixed_mask=fixed, max_iters=10)
    assert out.points.dtype == jnp.float32
    n_obs = float(np.sum(np.asarray(scene.obs.weight)))
    rms = np.sqrt(float(out.cost) / n_obs)
    assert rms < 2.5e-3, rms


def test_rejects_non_trajectory_structure():
    scene = make_scene(n_per_wall=10, n_cams=6, seed=5)
    with pytest.raises(ValueError):
        banded_flat.build_banded_work(scene.obs, scene.n_cams, scene.n_points,
                                      max_band=3)


def test_pose_covariances_match_dense():
    """Takahashi banded covariances must equal the dense S^-1 diagonals
    (solvers/covariance.ba_covariances) at the converged solution."""
    from slam_tricks_tpu.solvers.covariance import ba_covariances

    scene, poses0, points0, fixed, bw = _problem(n_cams=20, n_points=300,
                                                 track_len=5, seed=75)
    out = banded_flat.solve_ba_banded(poses0, points0, bw, fixed_mask=fixed,
                                      max_iters=15)
    dense_cov, _ = ba_covariances(out.poses, out.points, scene.obs, fixed,
                                  lam=1e-8)
    band_cov = banded_flat.banded_pose_covariances(out.poses, out.points, bw,
                                                   fixed, lam=1e-8)
    scale = float(jnp.max(jnp.abs(dense_cov)))
    np.testing.assert_allclose(np.asarray(band_cov), np.asarray(dense_cov),
                               atol=1e-8 * scale, rtol=1e-5)


def test_short_band_k2():
    """Degenerate band width K=2 exercises the K < Kb grouping branch and
    the minimal super-block tridiagonal."""
    scene, poses0, points0, fixed, bw = _problem(n_cams=24, n_points=400,
                                                 track_len=2, seed=79)
    C, L = scene.n_cams, scene.n_points
    work = schur_flat.build_flat_work(scene.obs, C, L, dtype=np.float64)
    kw = dict(fixed_mask=fixed, max_iters=6)
    ref = schur_flat.solve_ba_flat(poses0, points0, scene.obs, work, **kw)
    out = banded_flat.solve_ba_banded(poses0, points0, bw, **kw)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6,
                               atol=1e-20)


def test_landmark_covariances_match_dense():
    """Banded landmark marginals (Takahashi diag + sub-diag blocks) must
    equal the dense Schur-inverse computation."""
    from slam_tricks_tpu.solvers.covariance import ba_covariances

    scene, poses0, points0, fixed, bw = _problem(n_cams=20, n_points=250,
                                                 track_len=5, seed=85)
    out = banded_flat.solve_ba_banded(poses0, points0, bw, fixed_mask=fixed,
                                      max_iters=15)
    dense_pc, dense_lc = ba_covariances(out.poses, out.points, scene.obs,
                                        fixed, lam=1e-8,
                                        compute_landmarks=True)
    band_pc, band_lc = banded_flat.banded_covariances(
        out.poses, out.points, bw, fixed, lam=1e-8, compute_landmarks=True)
    ps = float(jnp.max(jnp.abs(dense_pc)))
    np.testing.assert_allclose(np.asarray(band_pc), np.asarray(dense_pc),
                               atol=1e-8 * ps, rtol=1e-5)
    w = np.asarray(scene.obs.weight)
    lm = np.asarray(scene.obs.lm_idx)
    observed = np.zeros(scene.n_points, bool)
    observed[lm[w > 0]] = True
    ls = float(np.max(np.abs(np.asarray(dense_lc)[observed])))
    np.testing.assert_allclose(np.asarray(band_lc)[observed],
                               np.asarray(dense_lc)[observed],
                               atol=1e-7 * ls, rtol=1e-4)


def _tridiag_system(G, m, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    Gm = rng.normal(size=(G, m, m + 4))
    D = (Gm @ Gm.transpose(0, 2, 1) + (m / 2) * np.eye(m)[None]).astype(dtype)
    E = (0.3 * rng.normal(size=(G - 1, m, m))).astype(dtype)
    r = rng.normal(size=(G, m)).astype(dtype)
    return D, E, r


def _tridiag_dense_solve(D, E, r):
    G, m, _ = D.shape
    M = np.zeros((G, m, G, m))
    for g in range(G):
        M[g, :, g, :] = D[g]
    for g in range(G - 1):
        M[g + 1, :, g, :] = E[g]
        M[g, :, g + 1, :] = E[g].T
    return np.linalg.solve(M.reshape(G * m, G * m),
                           np.asarray(r, np.float64).reshape(-1)
                           ).reshape(G, m)


def test_cyclic_reduction_matches_dense():
    from slam_tricks_tpu.solvers.banded_flat import block_tridiag_solve_cr

    for G, m in ((1, 8), (2, 8), (7, 16), (12, 16), (13, 16)):
        D, E, r = _tridiag_system(G, m, seed=G)
        if G == 1:
            E = E.reshape(0, m, m)
        ref = _tridiag_dense_solve(D, E, r)
        x = block_tridiag_solve_cr(jnp.asarray(D), jnp.asarray(E),
                                   jnp.asarray(r))
        np.testing.assert_allclose(np.asarray(x), ref, atol=1e-9,
                                   err_msg=f"G={G}")


@pytest.mark.parametrize("method", ["cr", "scan"])
def test_block_tridiag_methods_match_dense_f64(method):
    D, E, r = _tridiag_system(12, 16)
    ref = _tridiag_dense_solve(D, E, r)
    x = banded_flat.block_tridiag_solve(jnp.asarray(D), jnp.asarray(E),
                                        jnp.asarray(r), method=method)
    np.testing.assert_allclose(np.asarray(x), ref, atol=1e-10)


def test_cyclic_reduction_f32_bench_block_width():
    """f32 at the banded solver's production block width m = 6*8 = 48."""
    D, E, r = _tridiag_system(16, 48, seed=3, dtype=np.float32)
    ref = _tridiag_dense_solve(D, E, r)
    x = banded_flat.block_tridiag_solve_cr(jnp.asarray(D), jnp.asarray(E),
                                           jnp.asarray(r))
    scale = np.abs(ref).max()
    assert np.max(np.abs(np.asarray(x, np.float64) - ref)) < 1e-4 * scale

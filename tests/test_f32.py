"""Production-dtype (f32) correctness suite — VERDICT r1 item 6.

tests/conftest.py enables x64 globally for verification parity with the
reference's Eigen/Ceres doubles, but production on the accelerator runs f32 with
HIGHEST-precision contractions. These tests pin the f32 story: every case
constructs f32 inputs explicitly, asserts the outputs STAY f32, and documents
the achievable tolerance. If someone drops the HIGHEST-precision pins in the
solvers, the BA/calibration cases fail (measured effect on-chip:
f32 PnP cost 2e-6 -> 9e-15, 40 -> 24 LM iterations — solvers/common.py).

Select with `pytest -k f32`.
"""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

# documented f32 tolerances (noise-free problems)
BA_RMS_TOL_F32 = 1e-5        # normalized-plane units; f64 reaches ~1e-13
PNP_COST_TOL_F32 = 1e-10     # per-problem final cost; f64 reaches ~1e-30
CALIB_RMS_TOL_F32 = 5e-2     # pixels (mixed-scale 9+6N problem; f64 ~1e-6)
MANIFOLD_TOL_F32 = 2e-6      # exp/log roundtrip; f64 ~1e-15


def test_f32_schur_ba_dense_and_flat():
    from slam_tricks_tpu.sim import make_scene, perturb_scene
    from slam_tricks_tpu.solvers import schur, schur_flat

    scene = make_scene(n_per_wall=20, n_cams=8, seed=61, dtype=np.float32)
    poses0, points0, fixed = perturb_scene(scene, seed=62)
    assert points0.dtype == jnp.float32
    n = float(jnp.sum(scene.obs.weight))

    out = schur.solve_ba(poses0, points0, scene.obs, fixed_mask=fixed,
                         max_iters=30)
    assert out.points.dtype == jnp.float32
    assert np.sqrt(float(out.cost) / n) < BA_RMS_TOL_F32

    work = schur_flat.build_flat_work(scene.obs, scene.n_cams, scene.n_points,
                                      dtype=np.float32)
    out2 = schur_flat.solve_ba_flat(poses0, points0, scene.obs, work,
                                    fixed_mask=fixed, max_iters=30)
    assert out2.points.dtype == jnp.float32
    assert np.sqrt(float(out2.cost) / n) < BA_RMS_TOL_F32


def test_f32_pcg_flat():
    from slam_tricks_tpu.sim import make_trajectory_scene, perturb_scene
    from slam_tricks_tpu.solvers import schur_flat
    from slam_tricks_tpu.solvers.pcg_flat import build_pcg_work

    scene = make_trajectory_scene(n_cams=24, n_points=300, track_len=6,
                                  seed=63, dtype=np.float32)
    poses0, points0, fixed = perturb_scene(
        scene, pose_rot_noise=0.002, pose_trans_noise=0.01, point_noise=0.01,
        seed=64)
    work = schur_flat.build_flat_work(scene.obs, scene.n_cams, scene.n_points,
                                      dtype=np.float32)
    pcgw = build_pcg_work(scene.obs, scene.n_cams, dtype=np.float32)
    # anchor every 8th camera: the open-arc trajectory has near-flat drift
    # modes that amplify f32 CG inexactness; anchoring pins them so the test
    # measures the solver, not the problem conditioning (poses are perturbed
    # AFTER anchoring in perturb_scene only for its own fixed set, so rebuild
    # the mask and zero those perturbations via re-fixing to truth)
    fixed = jnp.zeros(scene.n_cams, bool).at[::8].set(True)
    poses0 = jax.tree_util.tree_map(
        lambda a, b: jnp.where(
            jnp.asarray(np.arange(scene.n_cams) % 8 == 0).reshape(
                (-1,) + (1,) * (a.ndim - 1)), b, a),
        poses0, scene.poses_true)
    out = schur_flat.solve_ba_flat(
        poses0, points0, scene.obs, work, fixed_mask=fixed, max_iters=30,
        linear="pcg", pcg_work=pcgw, cg_iters=200, cg_tol=1e-7)
    assert out.points.dtype == jnp.float32
    rms = np.sqrt(float(out.cost) / float(jnp.sum(scene.obs.weight)))
    # f32 CG steps are inexact (relative residual bottoms out near 1e-7);
    # the dense f32 path reaches ~1e-5 and f64 PCG ~1e-8 (test_pcg_flat)
    assert rms < 2e-4, rms


def test_f32_batched_pnp():
    from slam_tricks_tpu.manifolds import se3
    from slam_tricks_tpu.solvers.pnp import solve_pnp_batched

    rng = np.random.default_rng(65)
    B, n_obs = 64, 24
    pts = jnp.asarray(rng.uniform([-2, -2, 4], [2, 2, 8],
                                  (B, n_obs, 3)).astype(np.float32))
    xi = jnp.asarray((rng.normal(size=(B, 6)) * 0.2).astype(np.float32))
    T_true = jax.vmap(se3.exp)(xi)
    p_cam = jax.vmap(se3.act)(T_true, pts)
    uv = p_cam[..., :2] / p_cam[..., 2:]
    T0 = jax.vmap(se3.retract)(
        T_true, jnp.asarray((rng.normal(size=(B, 6)) * 0.05).astype(np.float32)))
    out = solve_pnp_batched(T0, pts, uv)
    assert out.cost.dtype == jnp.float32
    assert float(jnp.max(out.cost)) < PNP_COST_TOL_F32


@pytest.mark.slow
def test_f32_calibration():
    from slam_tricks_tpu.pipelines.calibration import calibrate
    from slam_tricks_tpu.sim.calib_scene import make_calib_scene

    scene = make_calib_scene(n_views=6, seed=66)
    board = jnp.asarray(np.asarray(scene.board_pts, np.float32))
    imgs = jnp.asarray(np.asarray(scene.image_pts, np.float32))
    res = calibrate(board, imgs, max_iters=60)
    assert res.rms_px.dtype == jnp.float32
    assert float(res.rms_px) < CALIB_RMS_TOL_F32, float(res.rms_px)


def test_f32_manifold_roundtrips():
    from slam_tricks_tpu.manifolds import se3, so3

    rng = np.random.default_rng(67)
    w = jnp.asarray((rng.normal(size=(64, 3)) * 1.5).astype(np.float32))
    R = jax.vmap(so3.exp)(w)
    assert R.dtype == jnp.float32
    w2 = jax.vmap(so3.log)(R)
    R2 = jax.vmap(so3.exp)(w2)
    assert float(jnp.max(jnp.abs(R2 - R))) < MANIFOLD_TOL_F32

    xi = jnp.asarray((rng.normal(size=(64, 6)) * 0.8).astype(np.float32))
    T = jax.vmap(se3.exp)(xi)
    xi2 = jax.vmap(se3.log)(T)
    T2 = jax.vmap(se3.exp)(xi2)
    assert float(jnp.max(jnp.abs(T2.R - T.R))) < MANIFOLD_TOL_F32
    assert float(jnp.max(jnp.abs(T2.t - T.t))) < 10 * MANIFOLD_TOL_F32

"""Native runtime (C++ kd-tree + chessboard growth) vs scipy / Python paths."""

import numpy as np
import pytest

from slam_tricks_tpu.native import KDTree, available, grow_chessboards_native

RNG = np.random.default_rng(23)


def test_kdtree_matches_scipy():
    from scipy.spatial import cKDTree

    pts = RNG.normal(size=(2000, 3)).astype(np.float32)
    q = RNG.normal(size=(64, 3)).astype(np.float32)
    idx, d2 = KDTree(pts).query(q, k=4)
    d_ref, i_ref = cKDTree(pts).query(q, k=4)
    np.testing.assert_array_equal(idx, i_ref)
    np.testing.assert_allclose(d2, d_ref.astype(np.float32) ** 2, atol=1e-4)


def test_kdtree_2d():
    pts = RNG.uniform(0, 100, size=(500, 2)).astype(np.float32)
    idx, d2 = KDTree(pts).query(pts[:10], k=1)
    np.testing.assert_array_equal(idx[:, 0], np.arange(10))
    assert (d2 < 1e-6).all()


def test_grow_chessboards_lattice():
    xs, ys = np.meshgrid(np.arange(7), np.arange(5))
    xy = np.stack([xs.ravel() * 18.0 + 40, ys.ravel() * 18.0 + 30], 1)
    xy += RNG.normal(size=xy.shape) * 0.3
    scores = np.ones(len(xy), np.float32)
    boards = grow_chessboards_native(xy, scores)
    assert boards
    assert boards[0].size >= 28, boards[0].shape
    # every index appears at most once
    flat = boards[0].ravel()
    assert len(set(flat.tolist())) == len(flat)


@pytest.mark.skipif(not available(), reason="native toolchain unavailable")
def test_native_lib_loaded():
    assert available()


# ---------------------------------------------------------------------------
# C++ single-core sparse-Schur LM baseline (native/schur_baseline.cpp)
# ---------------------------------------------------------------------------

@pytest.mark.skipif(not available(), reason="native lib unavailable")
def test_native_schur_first_iteration_parity():
    """The C++ baseline's FIRST LM iteration must take the same step as the
    JAX flat solver (basin-insensitive assembly check: later iterations can
    diverge to different basins on sub-ulp differences, so parity is
    asserted where it is well-posed — the first accepted step)."""
    import jax.numpy as jnp

    from slam_tricks_tpu.native import schur_ba_solve_native
    from slam_tricks_tpu.sim import make_scene, perturb_scene
    from slam_tricks_tpu.solvers import schur_flat

    scene = make_scene(n_per_wall=60, n_cams=16, seed=3, dtype=np.float64)
    poses0, points0, fixed = perturb_scene(scene, seed=4)
    obs = scene.obs
    work = schur_flat.build_flat_work(obs, scene.n_cams, scene.n_points,
                                      dtype=np.float64)
    out_jax = schur_flat.solve_ba_flat(poses0, points0, obs, work,
                                       fixed_mask=fixed, max_iters=1)
    out_c = schur_ba_solve_native(
        np.asarray(poses0.R), np.asarray(poses0.t), np.asarray(points0),
        np.asarray(obs.cam_idx), np.asarray(obs.lm_idx),
        np.asarray(obs.uv), np.asarray(obs.weight), np.asarray(fixed),
        max_iters=1)
    assert out_c["iters"] == 1
    np.testing.assert_allclose(out_c["cost"], float(out_jax.cost),
                               rtol=1e-6)
    np.testing.assert_allclose(out_c["t"], np.asarray(out_jax.poses.t),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.skipif(not available(), reason="native lib unavailable")
def test_native_schur_converges_to_stationary_point():
    """After 20 iterations the C++ baseline must sit at a true stationary
    point of the reprojection cost (gradient checked with independent numpy
    linearization) with a large cost reduction."""
    from bench_baseline import _cost, _linearize
    from slam_tricks_tpu.native import schur_ba_solve_native
    from slam_tricks_tpu.sim import make_scene, perturb_scene

    scene = make_scene(n_per_wall=60, n_cams=16, seed=3, dtype=np.float64)
    poses0, points0, fixed = perturb_scene(scene, seed=4)
    obs = scene.obs
    cam_idx, lm_idx = np.asarray(obs.cam_idx), np.asarray(obs.lm_idx)
    uv = np.asarray(obs.uv, np.float64)
    w = np.asarray(obs.weight, np.float64)
    cost0 = _cost(np.asarray(poses0.R, np.float64),
                  np.asarray(poses0.t, np.float64),
                  np.asarray(points0, np.float64), cam_idx, lm_idx, uv, w)
    out = schur_ba_solve_native(
        np.asarray(poses0.R), np.asarray(poses0.t), np.asarray(points0),
        cam_idx, lm_idx, uv, w, np.asarray(fixed), max_iters=20)
    assert out["cost"] < 1e-4 * cost0
    r, Jp, Jl = _linearize(out["R"], out["t"], out["pts"], cam_idx, lm_idx,
                           uv, np.sqrt(w))
    gpn = np.einsum("nri,nr->ni", Jp, r)
    gln = np.einsum("nri,nr->ni", Jl, r)
    gp = np.zeros((scene.n_cams, 6))
    np.add.at(gp, cam_idx, gpn)
    gl = np.zeros((scene.n_points, 3))
    np.add.at(gl, lm_idx, gln)
    gp[np.asarray(fixed)] = 0.0
    assert np.abs(gp).max() < 1e-6
    assert np.abs(gl).max() < 1e-6


def test_library_is_stale_when_missing_or_older_than_a_source(tmp_path,
                                                              monkeypatch):
    import os

    from slam_tricks_tpu import native

    for f in native._SOURCES:
        (tmp_path / f).write_text("")
    lib = tmp_path / "libslam_native.so"
    monkeypatch.setattr(native, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    assert native._stale()                       # missing
    lib.write_text("")
    os.utime(lib, (2e9, 2e9))
    assert not native._stale()                   # newer than every source
    os.utime(tmp_path / "Makefile", (2e9 + 1, 2e9 + 1))
    assert native._stale()                       # build flags changed

"""Slot-major flat Schur BA (solvers/schur_flat_sm) — parity vs the l-major
flat path (identical damping/gauge/control law), both camera-op modes
(bf16 one-hot matmuls for small C, gather tables for large C)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slam_tricks_tpu.sim import make_scene, perturb_scene
from slam_tricks_tpu.solvers import schur_flat, schur_flat_sm


@pytest.fixture(scope="module")
def scene():
    sc = make_scene(n_per_wall=60, n_cams=16, seed=3, dtype=np.float32)
    poses0, points0, fixed = perturb_scene(sc, seed=4)
    return sc, poses0, points0, fixed


def _solve_ref(scene):
    sc, poses0, points0, fixed = scene
    work = schur_flat.build_flat_work(sc.obs, sc.n_cams, sc.n_points,
                                      dtype=np.float32)
    return schur_flat.solve_ba_flat(poses0, points0, sc.obs, work,
                                    fixed_mask=fixed, max_iters=15)


@pytest.mark.parametrize("use_onehot", [True, False])
def test_parity_vs_flat(scene, use_onehot):
    sc, poses0, points0, fixed = scene
    ref = _solve_ref(scene)
    swork = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                          dtype=np.float32,
                                          use_onehot=use_onehot)
    out = schur_flat_sm.solve_ba_flat_sm(poses0, points0, swork,
                                         fixed_mask=fixed, max_iters=15)
    # identical control law -> same iteration count and same optimum
    assert int(out.it) == int(ref.it)
    np.testing.assert_allclose(float(out.cost), float(ref.cost),
                               rtol=0.3, atol=1e-11)
    np.testing.assert_allclose(np.asarray(out.poses.t),
                               np.asarray(ref.poses.t), atol=5e-5)


def test_jitted_and_converges(scene):
    sc, poses0, points0, fixed = scene
    swork = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                          dtype=np.float32)
    solve = jax.jit(schur_flat_sm.solve_ba_flat_sm,
                    static_argnames=("max_iters",))
    out = solve(poses0, points0, swork, fixed_mask=fixed, max_iters=20)
    assert float(out.cost) < 1e-10


def test_robust_loss(scene):
    from slam_tricks_tpu.residuals.robust import huber

    sc, poses0, points0, fixed = scene
    swork = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                          dtype=np.float32)
    work = schur_flat.build_flat_work(sc.obs, sc.n_cams, sc.n_points,
                                      dtype=np.float32)
    loss = huber(1.0)
    ref = schur_flat.solve_ba_flat(poses0, points0, sc.obs, work,
                                   fixed_mask=fixed, max_iters=10, loss=loss)
    out = schur_flat_sm.solve_ba_flat_sm(poses0, points0, swork,
                                         fixed_mask=fixed, max_iters=10,
                                         loss=loss)
    assert int(out.it) == int(ref.it)
    np.testing.assert_allclose(float(out.cost), float(ref.cost),
                               rtol=0.05, atol=1e-12)


@pytest.mark.parametrize("use_onehot", [True, False])
def test_mixed_onehot_reductions_match_f64(use_onehot):
    """The bf16-one-hot x f32 contractions (_MIXED: the one-hot side at
    DEFAULT, the value side at HIGHEST) keep f32 accuracy: camera fetch and
    camera reduction against float64 numpy, for the standing one-hot (small
    C) and the device-built (K, L, C) one-hot (large C)."""
    sc = make_scene(n_per_wall=20, n_cams=10, seed=3, dtype=np.float32)
    work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                         dtype=np.float32,
                                         use_onehot=use_onehot)
    K, L = work.mask.shape
    C = sc.n_cams
    rng = np.random.default_rng(0)
    cam = np.asarray(work.cam_of_slot)                     # (K, L)
    mask = np.asarray(work.mask, np.float64)
    onehot = (cam[..., None] == np.arange(C)) * mask[..., None]   # (K,L,C)

    vals = rng.normal(size=(C, 5)).astype(np.float32) * 1e3 + 1.0
    got = schur_flat_sm._fetch_cam_vals(jnp.asarray(vals), work, K, L)
    ref = np.asarray(vals, np.float64)[cam]                # (K, L, 5)
    for i in range(5):
        g = np.asarray(got[i], np.float64) * mask
        np.testing.assert_allclose(g, ref[..., i] * mask, rtol=2e-7)

    # padding slots carry zero (the solver's columns are weighted by w = 0)
    cols = [jnp.asarray((rng.normal(size=(K, L)) * 1e2 * mask)
                        .astype(np.float32)) for _ in range(4)]
    red = schur_flat_sm._cam_reduce(cols, work, jnp.float32)   # (4, C)
    ref = np.stack([np.einsum("kl,klc->c", np.asarray(c, np.float64), onehot)
                    for c in cols])
    scale = np.abs(np.stack([np.asarray(c, np.float64) for c in cols])).sum()
    assert np.max(np.abs(np.asarray(red, np.float64) - ref)) < 1e-6 * scale

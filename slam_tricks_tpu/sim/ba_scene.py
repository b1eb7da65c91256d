"""Deterministic BA scene simulator — the st20 cube-room problem re-designed for
static shapes.

Reference semantics (st20-g2o/src/src/sim_data.cpp): a cube room with features
on its walls (:22-45), a spiral look-at-origin camera trajectory inside
(:47-96), a visibility-culled measurement graph (:119-172), and noisy
initialization with gauge fixing (:244-296).

Accelerator-first change: instead of a ragged per-landmark track list the measurement
graph is the FULL dense (cams x landmarks) candidate set with a visibility
mask — static shapes, no compaction gathers inside jit. A host-side
`compact()` produces index arrays (cam_idx, lm_idx, uv, weight) padded to a
chosen size for the sparse solver.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.manifolds import se3


class BAObservations(NamedTuple):
    """Padded observation arrays for the block-sparse solver."""
    cam_idx: jnp.ndarray   # (N,) int32
    lm_idx: jnp.ndarray    # (N,) int32
    uv: jnp.ndarray        # (N,2) normalized-plane measurements
    weight: jnp.ndarray    # (N,) — 0.0 for padding


class BAScene(NamedTuple):
    poses_true: se3.SE3     # (C,) T_cw stacked
    points_true: jnp.ndarray  # (L,3)
    obs: BAObservations
    n_cams: int
    n_points: int


def cube_room_points(n_per_wall=100, half=4.0, seed=0):
    """Features on the 6 walls of a cube room (sim_data.cpp:22-45)."""
    rng = np.random.default_rng(seed)
    pts = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            p = rng.uniform(-half, half, size=(n_per_wall, 3))
            p[:, axis] = sign * half
            pts.append(p)
    return np.concatenate(pts, axis=0)


def look_at(eye, target, up=np.array([0.0, 0.0, 1.0])):
    """T_cw with camera at `eye` looking at `target` (z forward, like the
    reference's look-at-origin trajectory sim_data.cpp:66-90)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    nx = np.linalg.norm(x)
    if nx < 1e-8:
        x = np.array([1.0, 0, 0])
    else:
        x = x / nx
    y = np.cross(z, x)
    R_wc = np.stack([x, y, z], axis=1)  # columns = camera axes in world
    R_cw = R_wc.T
    t_cw = -R_cw @ eye
    return R_cw, t_cw


def spiral_trajectory(n_cams=30, radius=2.0, height=1.5, turns=2.0):
    """Spiral inside the room, looking at the origin (sim_data.cpp:47-96)."""
    Rs, ts = [], []
    for i in range(n_cams):
        s = i / max(n_cams - 1, 1)
        ang = 2.0 * np.pi * turns * s
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang),
                        -height + 2 * height * s])
        R, t = look_at(eye, np.zeros(3))
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)


def make_scene(n_per_wall=100, n_cams=30, half=4.0, fov_tan=1.2, min_depth=0.25,
               pix_noise=0.0, seed=0, dtype=np.float64):
    """Build the full scene with visibility-culled, optionally noisy observations.

    Returns a BAScene with COMPACTED observation arrays (host-side, np) —
    padding only up to the true observation count rounded to a multiple of 8.
    """
    rng = np.random.default_rng(seed + 1)
    pts = cube_room_points(n_per_wall, half, seed)          # (L,3)
    Rs, ts = spiral_trajectory(n_cams)                       # (C,3,3),(C,3)

    L = pts.shape[0]
    p_cam = np.einsum("cij,lj->cli", Rs, pts) + ts[:, None, :]   # (C,L,3)
    z = p_cam[..., 2]
    u = p_cam[..., 0] / np.where(z > min_depth, z, 1.0)
    v = p_cam[..., 1] / np.where(z > min_depth, z, 1.0)
    visible = (z > min_depth) & (np.abs(u) < fov_tan) & (np.abs(v) < fov_tan)
    # drop landmarks with <2 observations (cannot be triangulated; reference
    # logs track stats at sim_data.cpp:157-171)
    track_len = visible.sum(axis=0)
    visible &= (track_len >= 2)[None, :]

    cam_idx, lm_idx = np.nonzero(visible)
    uv = np.stack([u[cam_idx, lm_idx], v[cam_idx, lm_idx]], axis=1)
    if pix_noise > 0:
        uv = uv + rng.normal(size=uv.shape) * pix_noise

    n = cam_idx.shape[0]
    pad = (-n) % 8
    cam_idx = np.concatenate([cam_idx, np.zeros(pad, np.int64)])
    lm_idx = np.concatenate([lm_idx, np.zeros(pad, np.int64)])
    uv = np.concatenate([uv, np.zeros((pad, 2))])
    w = np.concatenate([np.ones(n), np.zeros(pad)])

    obs = BAObservations(
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        lm_idx=jnp.asarray(lm_idx, jnp.int32),
        uv=jnp.asarray(uv.astype(dtype)),
        weight=jnp.asarray(w.astype(dtype)),
    )
    poses = se3.SE3(jnp.asarray(Rs.astype(dtype)), jnp.asarray(ts.astype(dtype)))
    return BAScene(poses_true=poses, points_true=jnp.asarray(pts.astype(dtype)),
                   obs=obs, n_cams=n_cams, n_points=L)


def make_trajectory_scene(n_cams=1024, n_points=200_000, track_len=8,
                          radius=50.0, seed=0, pix_noise=0.0,
                          dtype=np.float32):
    """Large-scale SLAM-like BA scene: cameras on a circle looking tangentially
    forward, each landmark observed by a WINDOW of `track_len` consecutive
    cameras (the visibility locality of a real trajectory — what makes the
    reduced camera system block-banded and the block-tridiagonal PCG
    preconditioner effective; scaling analog of the st20 problem for the
    C >> 100 regime SURVEY §7 step 5 targets with PCG).

    Observations are emitted sorted by landmark (track-contiguous). Returns a
    BAScene."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    eyes = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.zeros(n_cams)], axis=1)
    # look along the tangent
    fwd = np.stack([-np.sin(ang), np.cos(ang), np.zeros(n_cams)], axis=1)
    Rs, ts = [], []
    for i in range(n_cams):
        R, t = look_at(eyes[i], eyes[i] + fwd[i])
        Rs.append(R)
        ts.append(t)
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    # each landmark anchored ahead of the middle camera of its window
    c0 = rng.integers(0, n_cams - track_len + 1, size=n_points)
    mid = c0 + track_len // 2
    local = np.stack([
        rng.uniform(-1.5, 1.5, n_points),
        rng.uniform(-1.5, 1.5, n_points),
        rng.uniform(6.0, 14.0, n_points),
    ], axis=1)
    R_mid = Rs[mid]
    t_mid = ts[mid]
    pts = np.einsum("nji,nj->ni", R_mid, local - t_mid)    # R^T (p_cam - t)

    cam_idx = (c0[:, None] + np.arange(track_len)[None, :]).reshape(-1)
    lm_idx = np.repeat(np.arange(n_points), track_len)
    p_cam = (np.einsum("nij,nj->ni", Rs[cam_idx], pts[lm_idx])
             + ts[cam_idx])
    z = p_cam[:, 2]
    valid = z > 0.5
    uv = p_cam[:, :2] / np.where(valid, z, 1.0)[:, None]
    if pix_noise > 0:
        uv = uv + rng.normal(size=uv.shape) * pix_noise
    w = valid.astype(np.float64)

    # drop landmarks that fell below 2 valid observations
    n_valid = np.bincount(lm_idx, weights=w, minlength=n_points)
    w = w * (n_valid[lm_idx] >= 2)

    n = cam_idx.shape[0]
    pad = (-n) % 8
    obs = BAObservations(
        cam_idx=jnp.asarray(np.concatenate([cam_idx, np.zeros(pad, np.int64)]),
                            jnp.int32),
        lm_idx=jnp.asarray(np.concatenate([lm_idx, np.zeros(pad, np.int64)]),
                           jnp.int32),
        uv=jnp.asarray(np.concatenate([uv, np.zeros((pad, 2))]).astype(dtype)),
        weight=jnp.asarray(np.concatenate([w, np.zeros(pad)]).astype(dtype)),
    )
    poses = se3.SE3(jnp.asarray(Rs.astype(dtype)), jnp.asarray(ts.astype(dtype)))
    return BAScene(poses_true=poses, points_true=jnp.asarray(pts.astype(dtype)),
                   obs=obs, n_cams=n_cams, n_points=n_points)


def make_loop_scene(n_cams=1024, n_points=200_000, track_len=8,
                    loop_frac=None, radius=50.0, seed=0, pix_noise=0.0,
                    dtype=np.float32):
    """Trajectory scene WITH LOOP CLOSURES: cameras on a circle as in
    make_trajectory_scene, but landmarks anchored near the trajectory start
    are RE-OBSERVED by the final `track_len` cameras (the loop closing as the
    circle completes — the defining structure of real SLAM, and of the
    reference's cube-room where walls are seen from both ends of the spiral,
    st20-g2o/src/src/sim_data.cpp:119-172).

    loop_frac: fraction of landmarks forced to anchor in the start window
    [0, track_len) (None keeps the uniform anchor distribution, giving
    ~track_len/n_cams of landmarks as loop closures). Observations of a
    loop landmark form TWO runs of consecutive cameras: [c0, c0+track_len)
    and [n_cams-track_len, n_cams). Returns a BAScene."""
    if n_cams < 2 * track_len:
        # ADVICE r4: below this the primary run of a start-window landmark
        # overlaps its revisit run, producing duplicate (landmark, camera)
        # observations that downstream builders reject confusingly
        raise ValueError(
            f"make_loop_scene needs n_cams >= 2*track_len "
            f"(got n_cams={n_cams}, track_len={track_len}): the revisit "
            "run would overlap the primary run")
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    eyes = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.zeros(n_cams)], axis=1)
    fwd = np.stack([-np.sin(ang), np.cos(ang), np.zeros(n_cams)], axis=1)
    Rs, ts = [], []
    for i in range(n_cams):
        R, t = look_at(eyes[i], eyes[i] + fwd[i])
        Rs.append(R)
        ts.append(t)
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    c0 = rng.integers(0, n_cams - track_len + 1, size=n_points)
    if loop_frac is not None:
        n_loop = int(loop_frac * n_points)
        c0[:n_loop] = rng.integers(0, track_len, size=n_loop)
    mid = c0 + track_len // 2
    local = np.stack([
        rng.uniform(-1.5, 1.5, n_points),
        rng.uniform(-1.5, 1.5, n_points),
        rng.uniform(6.0, 14.0, n_points),
    ], axis=1)
    R_mid = Rs[mid]
    t_mid = ts[mid]
    pts = np.einsum("nji,nj->ni", R_mid, local - t_mid)

    # primary runs
    cam_idx = (c0[:, None] + np.arange(track_len)[None, :]).reshape(-1)
    lm_idx = np.repeat(np.arange(n_points), track_len)
    # revisit run: landmarks anchored in the start window get the LAST
    # track_len cameras appended (the closing cameras share the start's
    # viewpoint on the circle, so the points genuinely project)
    is_loop = c0 < track_len
    loop_lms = np.flatnonzero(is_loop)
    rev_cams = np.arange(n_cams - track_len, n_cams)
    cam_idx = np.concatenate(
        [cam_idx, np.tile(rev_cams, loop_lms.size)])
    lm_idx = np.concatenate(
        [lm_idx, np.repeat(loop_lms, track_len)])

    p_cam = (np.einsum("nij,nj->ni", Rs[cam_idx], pts[lm_idx]) + ts[cam_idx])
    z = p_cam[:, 2]
    valid = z > 0.5
    uv = p_cam[:, :2] / np.where(valid, z, 1.0)[:, None]
    if pix_noise > 0:
        uv = uv + rng.normal(size=uv.shape) * pix_noise
    w = valid.astype(np.float64)
    n_valid = np.bincount(lm_idx, weights=w, minlength=n_points)
    w = w * (n_valid[lm_idx] >= 2)

    n = cam_idx.shape[0]
    pad = (-n) % 8
    obs = BAObservations(
        cam_idx=jnp.asarray(np.concatenate([cam_idx, np.zeros(pad, np.int64)]),
                            jnp.int32),
        lm_idx=jnp.asarray(np.concatenate([lm_idx, np.zeros(pad, np.int64)]),
                           jnp.int32),
        uv=jnp.asarray(np.concatenate([uv, np.zeros((pad, 2))]).astype(dtype)),
        weight=jnp.asarray(np.concatenate([w, np.zeros(pad)]).astype(dtype)),
    )
    poses = se3.SE3(jnp.asarray(Rs.astype(dtype)), jnp.asarray(ts.astype(dtype)))
    return BAScene(poses_true=poses, points_true=jnp.asarray(pts.astype(dtype)),
                   obs=obs, n_cams=n_cams, n_points=n_points)


def perturb_scene(scene, pose_rot_noise=0.05, pose_trans_noise=0.1,
                  point_noise=0.1, seed=10, fix_first=True, fix_last=True):
    """Noisy initialization (sim_data.cpp:273-296): perturb every pose/point;
    fixed cameras keep their true value. The reference fixes the FIRST AND LAST
    cameras (SetParameterBlockConstant, test_ceres.h:127-130) — both are needed
    in monocular BA to pin the 7-DoF similarity gauge (the 7th DoF, global
    scale, is otherwise free).

    Returns (poses0, points0, pose_fixed_mask)."""
    rng = np.random.default_rng(seed)
    C = scene.n_cams
    dtype = scene.points_true.dtype
    xi = np.concatenate([
        rng.normal(size=(C, 3)) * pose_trans_noise,
        rng.normal(size=(C, 3)) * pose_rot_noise,
    ], axis=1)
    fixed = np.zeros(C, bool)
    if fix_first:
        fixed[0] = True
    if fix_last:
        fixed[C - 1] = True
    xi[fixed] = 0.0
    poses0 = jax.vmap(se3.retract)(scene.poses_true, jnp.asarray(xi.astype(dtype)))
    points0 = scene.points_true + jnp.asarray(
        rng.normal(size=(scene.n_points, 3)).astype(dtype) * point_noise)
    return poses0, points0, jnp.asarray(fixed)

"""Sensor-distortion simulators: rolling-shutter camera and spinning LiDAR on a
moving base.

Reference: st19-distortion — rolling-shutter scan loop (rolling_shut.h:44-66:
the image is exposed row-by-row while objects move) and the 1-degree-per-step
LiDAR with segment intersection (lidar.h:63-106, LineIntersection :152-182).

Accelerator-native: both are closed-form/batched instead of stepped loops —
- rolling shutter: solve the scanline-meets-moving-point equation per point
  (one fused elementwise pass over all points)
- LiDAR: all (beam x segment) intersections as one broadcast computation,
  min-positive-range reduce per beam.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tricks_tpu.manifolds import se2


def rolling_shutter_points(pts0, vel, row_time, t0=0.0):
    """Observed positions of linearly-moving points under a rolling shutter.

    pts0 (N,2) positions at t=0 (pixel coords, y = row), vel (N,2) px/s,
    row_time = seconds per scanned row (the reference's _shutSpeedInv,
    rolling_shut.h:44). Row y is exposed at t = t0 + y*row_time; each point is
    imaged where its moving y crosses the scanline:
        y_obs = y0 + vy*(t0 + y_obs*row_time)
        => y_obs = (y0 + vy*t0) / (1 - vy*row_time)
        x_obs = x0 + vx*(t0 + y_obs*row_time)
    Returns (N,2) observed positions (the classic shear/wobble distortion)."""
    x0, y0 = pts0[:, 0], pts0[:, 1]
    vx, vy = vel[:, 0], vel[:, 1]
    denom = 1.0 - vy * row_time
    y_obs = (y0 + vy * t0) / denom
    t_obs = t0 + y_obs * row_time
    x_obs = x0 + vx * t_obs
    return jnp.stack([x_obs, y_obs], axis=1)


def ray_segment_intersection(origin, direction, seg_a, seg_b):
    """Batched ray/segment intersection. origin (2,), direction (2,) unit;
    seg_a/seg_b (...,2). Returns range t (inf where no hit)."""
    d = direction
    e = seg_b - seg_a
    # solve origin + t d = a + s e ;  cross products
    denom = d[0] * e[..., 1] - d[1] * e[..., 0]
    ao = seg_a - origin
    t = (ao[..., 0] * e[..., 1] - ao[..., 1] * e[..., 0]) / jnp.where(
        jnp.abs(denom) < 1e-12, 1.0, denom)
    s = (ao[..., 0] * d[1] - ao[..., 1] * d[0]) / jnp.where(
        jnp.abs(denom) < 1e-12, 1.0, denom)
    valid = (jnp.abs(denom) > 1e-12) & (t > 1e-9) & (s >= 0.0) & (s <= 1.0)
    return jnp.where(valid, t, jnp.inf)


class LidarSweep(NamedTuple):
    angles: jnp.ndarray     # (B,) beam angles in the WORLD frame at fire time
    ranges: jnp.ndarray     # (B,) measured ranges (inf = no return)
    points_world: jnp.ndarray  # (B,2) hit points in world frame
    origins: jnp.ndarray    # (B,2) sensor origin at each fire time


def lidar_sweep(segments, base_start, base_vel, n_beams=360, sweep_time=0.1,
                beam_angle0=0.0):
    """Spinning LiDAR on a moving base (lidar.h:63-106 semantics).

    segments (S,2,2) world walls; base_start: se2.SE2 pose at sweep begin;
    base_vel (3,) [vx, vy, omega] twist during the sweep; beams fire uniformly
    over sweep_time while the scanner rotates one full turn.

    Returns LidarSweep with per-beam origin/angle/range — the distorted sweep
    the reference animates (each beam fired from a different base pose)."""
    dtype = segments.dtype
    ts = jnp.linspace(0.0, sweep_time, n_beams, endpoint=False).astype(dtype)
    rel_angles = beam_angle0 + 2.0 * jnp.pi * ts / sweep_time

    def one(t, rel_ang):
        # base pose at fire time: constant-twist integration
        xi = base_vel * t
        pose = se2.mul(base_start, se2.exp(xi))
        ang = pose.theta + rel_ang
        d = jnp.stack([jnp.cos(ang), jnp.sin(ang)])
        o = pose.t
        rngs = ray_segment_intersection(o, d, segments[:, 0], segments[:, 1])
        r = jnp.min(rngs)
        return ang, r, o + jnp.where(jnp.isfinite(r), r, 0.0) * d, o

    angles, ranges, pts, origins = jax.vmap(one)(ts, rel_angles)
    return LidarSweep(angles=angles, ranges=ranges, points_world=pts,
                      origins=origins)


def box_segments(half=4.0, dtype=jnp.float32):
    """Square room walls as 4 segments."""
    c = jnp.asarray([
        [[-half, -half], [half, -half]],
        [[half, -half], [half, half]],
        [[half, half], [-half, half]],
        [[-half, half], [-half, -half]],
    ], dtype=dtype)
    return c

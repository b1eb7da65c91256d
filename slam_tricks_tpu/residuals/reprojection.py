"""Reprojection residuals for PnP / bundle adjustment / two-view refinement.

Convention: poses are stored as T_cw (camera-from-world), so the hot path is a
single `act` with no inversion — the reference stores T_wc and inverts per
residual (st17-ceres/src/include/solver.hpp:108-124 `SE3::inverse() * p`), which
we deliberately avoid.

Residuals are on the normalized image plane (the reference's convention for
PnP/BA: st17 solver.hpp:117-123, st20-g2o/src/include/test_ceres.h:61-74) with a
pixel-plane variant for calibrated problems.

Analytic Jacobians are provided for the hot BA path (tangent ordering matches
`manifolds.so3_r3`: [omega, dt]); jacfwd-derived Jacobians through
`retract` are the generic path and the two are cross-validated in tests — the
same dual-path validation the reference uses (autodiff vs SizedCostFunction,
st17 solver.hpp:127-213).
"""

import jax
import jax.numpy as jnp

from slam_tricks_tpu.manifolds import se3, so3


def reproject_normalized(T_cw, p_world, uv_norm):
    """r = project(T_cw * p_world) - uv_norm, on the normalized plane. (2,)"""
    p_cam = se3.act(T_cw, p_world)
    return p_cam[:2] / p_cam[2] - uv_norm


def reproject_pixel(intr, T_cw, p_world, uv_pix):
    """Pixel-plane residual for known intrinsics."""
    p_cam = se3.act(T_cw, p_world)
    u = intr.fx * p_cam[0] / p_cam[2] + intr.cx
    v = intr.fy * p_cam[1] / p_cam[2] + intr.cy
    return jnp.stack([u - uv_pix[0], v - uv_pix[1]])


def _dproj_dpcam(p_cam):
    """d(normalized projection)/d(p_cam): [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]].

    The same chain-rule head the reference derives by hand
    (st17-ceres/src/include/solver.hpp:176-190, st3-calibration calib.cpp:350-380).
    """
    x, y, z = p_cam[0], p_cam[1], p_cam[2]
    iz = 1.0 / z
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([iz, zero, -x * iz2]),
        jnp.stack([zero, iz, -y * iz2]),
    ])


def reproject_normalized_jacobians(T_cw, p_world):
    """Analytic Jacobians of the normalized-plane residual.

    Perturbation convention (matching manifolds.so3_r3 retract):
      R <- R exp(hat(omega)),  t <- t + dt,  p_world <- p_world + dp.
    Returns (r_pred (2,), J_pose (2,6) for [omega, dt], J_point (2,3)).

    d p_cam/d omega = R * (-hat(p_world)),  d p_cam/d dt = I,
    d p_cam/d p_world = R  — the reference's hand derivation transposed to
    right-perturbation (st17 solver.hpp:191-199 uses left-perturbation;
    validated against jacfwd in tests/test_residuals.py).
    """
    R, t = T_cw.R, T_cw.t
    hp = jax.lax.Precision.HIGHEST  # reduced-precision matmul passes stall GN convergence
    mm = lambda a, b: jnp.matmul(a, b, precision=hp)
    p_cam = mm(R, p_world) + t
    head = _dproj_dpcam(p_cam)  # (2,3)
    J_omega = mm(head, -mm(R, so3.hat(p_world)))
    J_dt = head
    J_point = mm(head, R)
    pred = p_cam[:2] / p_cam[2]
    return pred, jnp.concatenate([J_omega, J_dt], axis=1), J_point

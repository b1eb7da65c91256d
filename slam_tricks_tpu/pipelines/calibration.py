"""Zhang calibration pipeline: closed-form init -> joint LM refinement over
4 intrinsics + 5 distortion + 6 DoF per view (the 9+6N refinement of the
reference, st3-calibration/src/src/calib.cpp:38-47 + totalOptimization
:282-422), expressed as ONE generic-LM call on a product manifold — the
hand-written 400-line GN loop of the reference collapses into the residual
definition plus `levenberg_marquardt`.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tricks_tpu.manifolds import batched, euclidean, lie, product, se3
from slam_tricks_tpu.residuals.calib import calib_residual, pack_intrinsics, unpack_intrinsics
from slam_tricks_tpu.residuals.camera import DistCoeffs, Intrinsics
from slam_tricks_tpu.initialization.zhang import calibrate_closed_form
from slam_tricks_tpu.solvers import levenberg_marquardt


class CalibResult(NamedTuple):
    intrinsics: Intrinsics
    distortion: DistCoeffs
    poses: se3.SE3          # (V,) T_cw
    final_cost: jnp.ndarray
    rms_px: jnp.ndarray
    iterations: jnp.ndarray


def calibrate(board_pts, image_pts, *, max_iters=50, init=None):
    """board_pts (P,2) model plane; image_pts (V,P,2) pixel corners.

    init: optional (intrinsics0, poses0) to skip the closed-form
    initialization — e.g. to run the SVD-heavy init on the host CPU (a
    once-per-problem millisecond computation) and only the LM refinement
    on the accelerator.

    Returns CalibResult with refined intrinsics/distortion/poses."""
    V, P, _ = image_pts.shape
    dtype = image_pts.dtype

    if init is None:
        intr0, _, poses0 = calibrate_closed_form(board_pts, image_pts)
    else:
        intr0, poses0 = init
    dist0 = DistCoeffs.zeros(dtype)
    x0 = (pack_intrinsics(intr0, dist0).astype(dtype), poses0)
    manifold = product(euclidean(9), batched(lie(se3), V))

    def residual(x):
        vec, poses = x
        intr, dist = unpack_intrinsics(vec)

        def per_view(T, uv_view):
            return jax.vmap(lambda bp, px: calib_residual(intr, dist, T, bp, px))(
                board_pts, uv_view)

        return jax.vmap(per_view)(poses, image_pts)  # (V,P,2)

    res = levenberg_marquardt(residual, x0, manifold, max_iters=max_iters)
    vec, poses = res.x
    intr, dist = unpack_intrinsics(vec)
    rms = jnp.sqrt(2.0 * res.cost / (V * P * 2))
    return CalibResult(intrinsics=intr, distortion=dist, poses=poses,
                       final_cost=res.cost, rms_px=rms, iterations=res.iterations)

"""Two-view reconstruction pipeline: essential-matrix init -> pose recovery ->
triangulation -> joint LM refinement.

The BASELINE "st22 two-view" config, mirroring the reference flow
(st22-two-view/src/main.cpp:8-40: 8-point F -> E -> 4-way decomposition with
all-pairs cheirality -> DLT triangulation -> (no refinement in reference; we
add the joint bundle refinement the reference leaves to st20)).

Accelerator-native: the whole pipeline is one jittable function; triangulation and
refinement are the vmapped/Schur machinery of the solver layer.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tricks_tpu.initialization import essential_8pt, recover_pose
from slam_tricks_tpu.manifolds import se3
from slam_tricks_tpu.solvers import schur_flat_sm


class TwoViewResult(NamedTuple):
    T_12: se3.SE3          # recovered relative pose (cam1 -> cam2), |t| = 1 gauge
    points: jnp.ndarray    # (N,3) triangulated in cam-1 frame
    final_cost: jnp.ndarray
    n_cheiral: jnp.ndarray


def solve_two_view(uv1, uv2, *, refine_iters=20, weights=None):
    """uv1/uv2: (N,2) normalized-plane correspondences. Returns TwoViewResult.

    Scale gauge: ||t|| = 1 (the reference instead rescales to ground truth,
    st22 main.cpp:21-27 — equivalent up to the monocular scale ambiguity).
    """
    dtype = uv1.dtype
    n = uv1.shape[0]
    E = essential_8pt(uv1, uv2, weights)
    R, t, n_good, X = recover_pose(E, uv1, uv2, weights)
    T12_init = se3.SE3(R, t)

    # joint refinement as a 2-camera bundle adjustment: camera1 fixed at
    # identity (gauge), camera2 free; landmarks = triangulated points.
    poses0 = se3.SE3(
        jnp.stack([jnp.eye(3, dtype=dtype), R]),
        jnp.stack([jnp.zeros(3, dtype=dtype), t]),
    )
    # guard badly-triangulated points (behind camera / near-infinite)
    depth_ok = (X[:, 2] > 1e-3) & jnp.all(jnp.isfinite(X), axis=1)
    X_safe = jnp.where(depth_ok[:, None], X, jnp.ones_like(X))
    w1 = jnp.ones(n, dtype) if weights is None else weights
    wslot = w1 * depth_ok.astype(dtype)

    # slot-major work built with jnp ops (the generic build_slot_work is a
    # host-side numpy constructor): the two-view structure is fully regular
    # — landmark l is seen by exactly cam 0 (slot 0) and cam 1 (slot 1) —
    # so the (K=2, L) grid and the (2L, 2) camera one-hot are closed-form.
    # Refining through the slot-major Schur path instead of the generic
    # dense solve_ba cut the refinement from 1.33 to ~0.3 ms/LM-iter.
    swork = schur_flat_sm.SlotWork(
        uv0=jnp.stack([uv1[:, 0], uv2[:, 0]]),
        uv1=jnp.stack([uv1[:, 1], uv2[:, 1]]),
        w=jnp.stack([wslot, wslot]),
        mask=jnp.ones((2, n), dtype),
        oh=jnp.concatenate([
            jnp.tile(jnp.asarray([[1, 0]], jnp.bfloat16), (n, 1)),
            jnp.tile(jnp.asarray([[0, 1]], jnp.bfloat16), (n, 1))]),
        cam_of_slot=jnp.stack([jnp.zeros(n, jnp.int32),
                               jnp.ones(n, jnp.int32)]),
        cam_table=None, cam_mask=None)
    # fix camera 1 only; the scale gauge is pinned after the solve by
    # renormalizing ||t|| (cheaper than a constrained solve and exactly the
    # monocular similarity freedom)
    fixed = jnp.array([True, False])
    final = schur_flat_sm.solve_ba_flat_sm(poses0, X_safe, swork,
                                           fixed_mask=fixed,
                                           max_iters=refine_iters)
    T2 = jax.tree_util.tree_map(lambda a: a[1], final.poses)
    scale = jnp.linalg.norm(T2.t)
    T_12 = se3.SE3(T2.R, T2.t / scale)
    points = final.points / scale
    return TwoViewResult(T_12=T_12, points=points, final_cost=final.cost,
                         n_cheiral=n_good)

"""ICP residuals: point-to-point in SE(2) and SE(3), plus closed-form alignment.

Reference problem class: st6-icp/src/include/icp.hpp —
- known-correspondence SE(2) GN (icp.hpp:27-48, J = [I2, perp(p')])
- unknown-correspondence variant with centroid normalization + NN association
  (icp.hpp:50-95)

This build generalizes to SE(3) (BASELINE config "st6 ICP: point-to-point
SE(3) alignment") and replaces the linear-scan NN with a batched all-pairs
argmin (XLA-friendly; O(N*M) elementwise flops beats pointer-chasing kd-trees at
these sizes).
"""

import jax
import jax.numpy as jnp

from slam_tricks_tpu.manifolds import se2, se3


def point_residual_se2(T, src, dst):
    """r = T*src - dst for one 2D correspondence (icp.hpp:33-43)."""
    return se2.act(T, src) - dst


def point_residual_se3(T, src, dst):
    """r = T*src - dst for one 3D correspondence."""
    return se3.act(T, src) - dst


def nearest_neighbors(src, dst):
    """For each src point, index of nearest dst point. (N,3)/(M,3) -> (N,) int.

    All-pairs distance matrix + argmin: static shapes, fuses into two XLA ops.
    (Replaces the reference's linear scan icp.hpp:68-77 and the PCL kdtree.)
    """
    d2 = jnp.sum((src[:, None, :] - dst[None, :, :]) ** 2, axis=-1)
    return jnp.argmin(d2, axis=1)


def umeyama(src, dst, with_scale=False):
    """Closed-form least-squares alignment dst ~ s * R @ src + t (Umeyama/Kabsch).

    The accelerator-native replacement for the reference's centroid-normalized SO(2)
    closed-form translation step (icp.hpp:50-61), generalized to N-D; also the
    exact solver the unknown-correspondence ICP alternates with.
    Returns (R, t, s).
    """
    dim = src.shape[1]
    mu_s = jnp.mean(src, axis=0)
    mu_d = jnp.mean(dst, axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, S, Vt = jnp.linalg.svd(cov)
    d = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
    D = jnp.concatenate([jnp.ones(dim - 1, dtype=src.dtype), d[None]])
    R = (U * D[None, :]) @ Vt
    if with_scale:
        var_s = jnp.mean(jnp.sum(sc * sc, axis=1))
        s = jnp.sum(S * D) / var_s
    else:
        s = jnp.ones((), dtype=src.dtype)
    t = mu_d - s * (R @ mu_s)
    return R, t, s


def icp_iterate(src, dst, n_outer=10, with_scale=False):
    """Unknown-correspondence ICP: alternate NN association and closed-form
    Umeyama alignment (reference loop shape icp.hpp:63-95), fixed outer
    iteration count for static compilation. Works for 2D and 3D clouds.

    Returns (R, t, s, assoc_idx).
    """
    dim = src.shape[1]

    def body(_, carry):
        R, t, s = carry
        cur = s * (src @ R.T) + t
        idx = nearest_neighbors(cur, dst)
        R2, t2, s2 = umeyama(src, dst[idx], with_scale)
        return R2, t2, s2

    R0 = jnp.eye(dim, dtype=src.dtype)
    t0 = jnp.mean(dst, axis=0) - jnp.mean(src, axis=0)
    s0 = jnp.ones((), dtype=src.dtype)
    R, t, s = jax.lax.fori_loop(0, n_outer, body, (R0, t0, s0))
    idx = nearest_neighbors(s * (src @ R.T) + t, dst)
    return R, t, s, idx

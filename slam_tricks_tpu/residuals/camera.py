"""Camera models: pinhole intrinsics and radial-tangential (Brown-Conrady)
distortion.

Covers the reference's L1 core camera types and the st1 distortion model:
- `Intrinsics` / `DistCoeffs`  — reference `CameraInnerParam` / `CameraDistCoeff`
  (st0-core/include/struct_def.hpp:22-80)
- `distort_normalized`          — forward radial-tangential model
  (st1-undistort/src/include/undistort_pt.hpp:45-66 math, re-derived)
- `undistort_point_gn`          — per-point iterative Gauss-Newton undistortion
  (reference algorithm shape: undistort_pt.hpp:29-88 — <=5 iterations, diagonal
  Jacobian approximation). We provide BOTH the reference's fast diagonal-Newton
  variant and a full-2x2-Jacobian Newton that converges tighter; both vmappable
  to millions of pixels (BASELINE config "st1 10k-pixel undistortion").

All functions are single-point; batch with vmap. Dtype follows the inputs.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (fx, fy, cx, cy) — `CameraInnerParam`."""
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @property
    def K(self):
        fx, fy, cx, cy = self.fx, self.fy, self.cx, self.cy
        one = jnp.ones_like(fx)
        zero = jnp.zeros_like(fx)
        return jnp.stack([
            jnp.stack([fx, zero, cx]),
            jnp.stack([zero, fy, cy]),
            jnp.stack([zero, zero, one]),
        ])

    @classmethod
    def from_K(cls, K):
        return cls(K[0, 0], K[1, 1], K[0, 2], K[1, 2])


class DistCoeffs(NamedTuple):
    """Radial (k1,k2,k3) + tangential (p1,p2) — `CameraDistCoeff`."""
    k1: jnp.ndarray
    k2: jnp.ndarray
    k3: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray

    @classmethod
    def zeros(cls, dtype=jnp.float32):
        z = jnp.zeros((), dtype=dtype)
        return cls(z, z, z, z, z)

    @classmethod
    def from_opencv(cls, d):
        """OpenCV order [k1, k2, p1, p2, k3]."""
        return cls(d[0], d[1], d[4], d[2], d[3])

    def to_opencv(self):
        return jnp.stack([self.k1, self.k2, self.p1, self.p2, self.k3])


def project(intr, p_norm):
    """Normalized plane (2,) -> pixel (2,)."""
    return jnp.stack([intr.fx * p_norm[0] + intr.cx, intr.fy * p_norm[1] + intr.cy])


def unproject(intr, px):
    """Pixel (2,) -> normalized plane (2,)."""
    return jnp.stack([(px[0] - intr.cx) / intr.fx, (px[1] - intr.cy) / intr.fy])


def perspective_divide(p_cam):
    """Camera-frame 3D point -> normalized plane."""
    return p_cam[:2] / p_cam[2]


def distort_normalized(dist, p):
    """Forward radial-tangential model on normalized coordinates.

    ud = u(1 + k1 r^2 + k2 r^4 + k3 r^6) + 2 p1 u v + p2 (r^2 + 2 u^2)
    vd = v(1 + k1 r^2 + k2 r^4 + k3 r^6) + p1 (r^2 + 2 v^2) + 2 p2 u v
    """
    u, v = p[0], p[1]
    r2 = u * u + v * v
    radial = 1.0 + r2 * (dist.k1 + r2 * (dist.k2 + r2 * dist.k3))
    du = 2.0 * dist.p1 * u * v + dist.p2 * (r2 + 2.0 * u * u)
    dv = dist.p1 * (r2 + 2.0 * v * v) + 2.0 * dist.p2 * u * v
    return jnp.stack([u * radial + du, v * radial + dv])


def distort_pixel(intr, dist, px):
    """Pixel -> distorted pixel (through normalized plane)."""
    return project(intr, distort_normalized(dist, unproject(intr, px)))


def undistort_point_gn(intr, dist, px_dist, iters=5, full_jacobian=True):
    """Iterative undistortion of a distorted pixel via Newton on the forward model.

    Reference algorithm (st1-undistort/src/include/undistort_pt.hpp:29-88): <=5
    Newton iterations on normalized coordinates using only the diagonal Jacobian
    terms Juu/Jvv. With ``full_jacobian=True`` we use the exact 2x2 Jacobian
    (via jacfwd — XLA fuses it into the same kernel), which is what lets the device
    build beat the reference in accuracy at equal iteration count.

    Fixed iteration count => static shapes => perfectly vmappable over pixels.
    """
    target = unproject(intr, px_dist)

    def body(_, p):
        f = distort_normalized(dist, p) - target
        if full_jacobian:
            J = jax.jacfwd(lambda q: distort_normalized(dist, q))(p)
            delta = jnp.linalg.solve(J, f)
        else:
            # diagonal-only decoupled Newton (reference variant, undistort_pt.hpp:52-78)
            J = jax.jacfwd(lambda q: distort_normalized(dist, q))(p)
            delta = f / jnp.stack([J[0, 0], J[1, 1]])
        return p - delta

    p = jax.lax.fori_loop(0, iters, body, target)
    return project(intr, p)


# Batched convenience wrappers (the BASELINE "10k pixels" path).
undistort_points_gn = jax.vmap(undistort_point_gn, in_axes=(None, None, 0))
distort_pixels = jax.vmap(distort_pixel, in_axes=(None, None, 0))


def _distort_and_jacobian(dist, u, v):
    """Forward model + analytic 2x2 Jacobian, fully batched over (N,) arrays.

    Hand-derived closed form (generalizing the reference's diagonal Juu/Jvv
    terms at undistort_pt.hpp:52-58 to the full 2x2) — pure elementwise arithmetic,
    no linalg, no autodiff: this is one fused elementwise kernel.
    """
    k1, k2, k3, p1, p2 = dist.k1, dist.k2, dist.k3, dist.p1, dist.p2
    r2 = u * u + v * v
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dr = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)  # d(radial)/d(r2)
    ud = u * radial + 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
    vd = v * radial + p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v
    Juu = radial + 2.0 * u * u * dr + 2.0 * p1 * v + 6.0 * p2 * u
    Juv = 2.0 * u * v * dr + 2.0 * p1 * u + 2.0 * p2 * v
    Jvu = Juv
    Jvv = radial + 2.0 * v * v * dr + 6.0 * p1 * v + 2.0 * p2 * u
    return ud, vd, Juu, Juv, Jvu, Jvv


def undistort_points_fast(intr, dist, px_dist, iters=5):
    """Fully-batched Newton undistortion: (N,2) pixels -> (N,2).

    Same math as `undistort_points_gn` but with the analytic Jacobian and a
    closed-form 2x2 solve — ~10 fused elementwise ops per iteration, no
    autodiff/linalg. This is the st1 benchmark path.
    """
    u0 = (px_dist[:, 0] - intr.cx) / intr.fx
    v0 = (px_dist[:, 1] - intr.cy) / intr.fy

    def body(_, uv):
        u, v = uv
        ud, vd, a, b, c, d = _distort_and_jacobian(dist, u, v)
        fu = ud - u0
        fv = vd - v0
        inv_det = 1.0 / (a * d - b * c)
        du = inv_det * (d * fu - b * fv)
        dv = inv_det * (a * fv - c * fu)
        return u - du, v - dv

    u, v = jax.lax.fori_loop(0, iters, body, (u0, v0))
    return jnp.stack([intr.fx * u + intr.cx, intr.fy * v + intr.cy], axis=1)

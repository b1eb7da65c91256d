"""SO(3) — rotation group, represented as 3x3 rotation matrices.

Accelerator-first design: the matrix representation makes `compose` and `act` plain
(batched) matmuls, which XLA vectorizes onto vector units and matmuls; `exp` is Rodrigues,
`log` goes through a branch-free quaternion extraction (Shepperd's method via
`jnp.where` selects) so it is robust for all angles including theta ~ pi.

Math references (reference repo doc derivations, not code):
/root/reference/st21-lie/lie-group.tex:67-279 and
/root/reference/st23-lie-group-v2/doc.tex:304-700 (exp/log/hat/vee, left/right
Jacobians). The right-perturbation retraction `R @ exp(w)` matches the reference
solvers' update convention (st17-ceres/src/include/solver.hpp:43,442).

All functions operate on single elements; batch with `jax.vmap`.
Dtype-polymorphic: f32 on the accelerator, f64 for CPU verification.
"""

import jax
import jax.numpy as jnp

from slam_tricks_tpu.manifolds import _coeffs

DIM = 3  # tangent dimension


def identity(dtype=jnp.float32):
    return jnp.eye(3, dtype=dtype)


def hat(w):
    """so(3) hat: R^3 -> 3x3 skew-symmetric (reference: antisymmetric(),
    st0-core/include/struct_def.hpp:82-89)."""
    wx, wy, wz = w[0], w[1], w[2]
    zero = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([zero, -wz, wy]),
        jnp.stack([wz, zero, -wx]),
        jnp.stack([-wy, wx, zero]),
    ])


def vee(W):
    """Inverse of hat (struct_def.hpp:98-102)."""
    return jnp.stack([W[2, 1], W[0, 2], W[1, 0]])


def exp(w):
    """Rodrigues: exp(hat(w)) = I + A K + B K^2 with K = hat(w)."""
    theta_sq = jnp.dot(w, w)
    K = hat(w)
    a = _coeffs.sinc(theta_sq)
    b = _coeffs.cosc(theta_sq)
    return jnp.eye(3, dtype=w.dtype) + a * K + b * (K @ K)


def to_quat(R):
    """Rotation matrix -> unit quaternion [w, x, y, z], w >= 0.

    Branch-free Shepperd: compute all four sqrt candidates, select the one keyed
    on the largest of (trace, R00, R11, R22) — numerically safe at every angle.
    """
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-30))

    # candidate 0: keyed on trace
    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0])
    # candidate 1: keyed on m00
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1])
    # candidate 2: keyed on m11
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2])
    # candidate 3: keyed on m22
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3])

    keys = jnp.stack([tr, m00, m11, m22])
    idx = jnp.argmax(keys)
    q = jnp.where(idx == 0, q0, jnp.where(idx == 1, q1, jnp.where(idx == 2, q2, q3)))
    # canonical sign: w >= 0
    q = q * jnp.where(q[0] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q)


def from_quat(q):
    """Unit quaternion [w, x, y, z] -> rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def log(R):
    """Robust SO(3) log via quaternion: w_log = 2*atan2(|v|, qw)/|v| * v.

    atan2 keeps full accuracy near theta=0 and theta=pi (where the classic
    acos-of-trace form loses ~half the significant digits).
    """
    q = to_quat(R)
    qw, v = q[0], q[1:]
    n_sq = jnp.dot(v, v)
    n = jnp.sqrt(jnp.where(n_sq < 1e-24, 1.0, n_sq))
    # Taylor of 2*atan2(n, qw)/n around n=0 (qw ~ 1): 2/qw - 2 n^2/(3 qw^3)
    scale_taylor = 2.0 / qw - 2.0 * n_sq / (3.0 * qw ** 3)
    scale_closed = 2.0 * jnp.arctan2(n, qw) / n
    scale = jnp.where(n_sq < 1e-24, scale_taylor, scale_closed)
    return scale * v


def jl(w):
    """Left Jacobian: Jl = I + B K + C K^2 (st23-lie-group-v2/doc.tex Jacobian
    derivations)."""
    theta_sq = jnp.dot(w, w)
    K = hat(w)
    b = _coeffs.cosc(theta_sq)
    c = _coeffs.sincc(theta_sq)
    return jnp.eye(3, dtype=w.dtype) + b * K + c * (K @ K)


def jl_inv(w):
    """Inverse left Jacobian: Jl^-1 = I - K/2 + E K^2."""
    theta_sq = jnp.dot(w, w)
    K = hat(w)
    e = _coeffs.jl_inv_coeff(theta_sq)
    return jnp.eye(3, dtype=w.dtype) - 0.5 * K + e * (K @ K)


def jr(w):
    """Right Jacobian: Jr(w) = Jl(-w)."""
    return jl(-w)


def jr_inv(w):
    return jl_inv(-w)


def mul(Ra, Rb):
    return Ra @ Rb


def inv(R):
    return R.T


def act(R, p):
    """Rotate point(s): supports p of shape (3,) or (..., 3)."""
    return p @ R.T if p.ndim > 1 else R @ p


def adj(R):
    """Adjoint of SO(3) is the matrix itself."""
    return R


def retract(R, w):
    """Right-perturbation boxplus: R * exp(w) — the update convention of the
    reference solvers (st17-ceres/src/include/solver.hpp:442-443)."""
    return R @ exp(w)


def local(Ra, Rb):
    """boxminus: log(Ra^T Rb), inverse of retract."""
    return log(Ra.T @ Rb)


def project(M):
    """Nearest rotation matrix via SVD (reference Pose re-orthonormalization,
    st16-pcl-viewer/src/include/pose.hpp and st3-calibration/src/src/calib.cpp:160-168)."""
    U, _, Vt = jnp.linalg.svd(M)
    d = jnp.linalg.det(U @ Vt)
    S = jnp.diag(jnp.stack([jnp.ones_like(d), jnp.ones_like(d), d]))
    return U @ S @ Vt


def random(key, dtype=jnp.float32):
    """Uniform random rotation (via random quaternion)."""
    q = jax.random.normal(key, (4,), dtype=dtype)
    q = q / jnp.linalg.norm(q)
    return from_quat(q * jnp.where(q[0] < 0, -1.0, 1.0))

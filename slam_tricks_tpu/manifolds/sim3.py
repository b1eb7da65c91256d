"""Sim(3) — similarity transforms (R: 3x3, t: 3, s: scalar scale).

The scale-drift group of monocular SLAM: loop-closing a mono odometry chain
must correct accumulated SCALE drift as well as rotation/translation, which
SE(3) pose-graph optimization structurally cannot (scale is a gauge freedom
of reprojection — see test_preintegration's metric-scale result). Sim(3)
relative-pose factors make the drift observable (Strasdat et al., "Scale
Drift-Aware Large Scale Monocular SLAM", RSS 2010 — the standard mono
loop-closing formulation, e.g. ORB-SLAM's essential graph).

Math references: the reference repo derives SO(3)/SE(3) exp/log/Jacobians in
/root/reference/st21-lie/lie-group.tex:67-279 and
/root/reference/st23-lie-group-v2/doc.tex:304-997; Sim(3) is the one-extra-
generator extension (tangent [rho, omega, sigma], right-perturbation
retraction matching the SE(3) convention of
st17-ceres/src/include/solver.hpp:442-443).

Accelerator-first numerics: exp/log need W(omega, sigma) = integral_0^1 e^{s sigma}
exp(s hat(omega)) ds. The closed form (Sophus-style) needs FOUR Taylor
regimes whose cancellation thresholds are dtype-dependent (the round-5
pose-graph work measured exactly this class of f32 failure in the SE(3)
coefficients, manifolds/_coeffs.py:_cancel_thr). Instead we evaluate
W = phi1(M), M = sigma*I + hat(omega) (sigma*I commutes with hat(omega))
by BRANCH-FREE scaling-and-squaring on the identity

    phi1(M) = 1/2 * phi1(M/2) (I + e^{M/2}),   phi1(z) = (e^z - 1)/z,

with fixed-depth Taylor seeds: no data-dependent control flow, no regime
switches, uniformly machine-accurate for theta <= pi, |sigma| <= ~8 in both
f32 and f64 (cross-checked against a 6x6 block-expm oracle in
tests/test_manifolds.py). Cost: ~25 unrolled 3x3 matmuls — XLA fuses the
whole thing; vmap batches it.

Single-element functions; batch with `jax.vmap`.
"""

from typing import NamedTuple

import jax.numpy as jnp

from slam_tricks_tpu.manifolds import so3

DIM = 7  # tangent dimension: [rho (translation), omega (rotation), sigma (scale)]

_PHI_SQUARINGS = 6  # ||M||/2^6 <= ~0.13 for theta<=pi, |sigma|<=5
_PHI_TAYLOR_ORDER = 7


class Sim3(NamedTuple):
    """R: (..., 3, 3) rotation, t: (..., 3) translation, s: (...) scale."""
    R: jnp.ndarray
    t: jnp.ndarray
    s: jnp.ndarray


def identity(dtype=jnp.float32):
    return Sim3(jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype=dtype),
                jnp.ones((), dtype=dtype))


def _phi1(M):
    """phi1(M) = integral_0^1 e^{sM} ds, branch-free scaling-and-squaring.

    Seeds E ~ e^{M/2^k} and P ~ phi1(M/2^k) with short Taylor series (the
    scaled norm is <= ~0.13, so order 7 is far below f32 eps), then applies
    phi1(2A) = 1/2 phi1(A)(I + e^A) and e^{2A} = (e^A)^2 k times."""
    dtype = M.dtype
    eye = jnp.eye(3, dtype=dtype)
    Ms = M * (1.0 / (1 << _PHI_SQUARINGS))
    # Taylor seeds: E = sum Ms^n / n!, P = sum Ms^n / (n+1)!
    E = eye
    P = eye
    term = eye
    for n in range(1, _PHI_TAYLOR_ORDER + 1):
        term = term @ Ms * (1.0 / n)
        E = E + term
        P = P + term * (1.0 / (n + 1))
    for _ in range(_PHI_SQUARINGS):
        P = 0.5 * (P @ (eye + E))
        E = E @ E
    return P


def _W(w, sigma):
    """W(omega, sigma) = phi1(sigma I + hat(omega)): the Sim(3) analog of the
    SO(3) left Jacobian (reduces to so3.jl at sigma=0)."""
    return _phi1(sigma * jnp.eye(3, dtype=w.dtype) + so3.hat(w))


def exp(xi):
    """xi = [rho, omega, sigma] -> Sim3(exp(omega), W(omega, sigma) rho,
    e^sigma)."""
    rho, w, sigma = xi[:3], xi[3:6], xi[6]
    return Sim3(so3.exp(w), _W(w, sigma) @ rho, jnp.exp(sigma))


def log(S):
    """Inverse of exp. rho solves W rho = t (3x3 solve — W is invertible for
    theta < 2*pi; cheaper and more robust than a closed-form W^-1)."""
    w = so3.log(S.R)
    sigma = jnp.log(S.s)
    rho = jnp.linalg.solve(_W(w, sigma), S.t)
    return jnp.concatenate([rho, w, sigma[None]])


def mul(Sa, Sb):
    return Sim3(Sa.R @ Sb.R, Sa.s * (Sa.R @ Sb.t) + Sa.t, Sa.s * Sb.s)


def inv(S):
    Rt = S.R.T
    return Sim3(Rt, -(Rt @ S.t) / S.s, 1.0 / S.s)


def act(S, p):
    """Similarity-transform point(s): s R p + t; p of shape (3,) or (..., 3)."""
    if p.ndim > 1:
        return S.s * (p @ S.R.T) + S.t
    return S.s * (S.R @ p) + S.t


def adj(S):
    """7x7 adjoint in [rho, omega, sigma] ordering:
    [[s R, hat(t) R, -t], [0, R, 0], [0, 0, 1]]."""
    dtype = S.R.dtype
    tR = so3.hat(S.t) @ S.R
    Z = jnp.zeros((3, 3), dtype=dtype)
    z3 = jnp.zeros((3, 1), dtype=dtype)
    one = jnp.ones((1, 1), dtype=dtype)
    return jnp.block([
        [S.s * S.R, tR, -S.t[:, None]],
        [Z, S.R, z3],
        [z3.T, z3.T, one],
    ])


def retract(S, xi):
    """Right perturbation S * exp(xi) (the SE(3) solvers' update convention,
    st17-ceres/src/include/solver.hpp:442-443, extended to Sim(3))."""
    return mul(S, exp(xi))


def local(Sa, Sb):
    return log(mul(inv(Sa), Sb))


def to_matrix(S):
    """4x4 matrix [[s R, t], [0, 1]]."""
    bottom = jnp.zeros((1, 4), dtype=S.R.dtype).at[0, 3].set(1.0)
    top = jnp.concatenate([S.s * S.R, S.t[:, None]], axis=1)
    return jnp.concatenate([top, bottom])


def from_matrix(M):
    """Inverse of to_matrix (scale from the row norm of the upper 3x3)."""
    A = M[:3, :3]
    s = jnp.cbrt(jnp.linalg.det(A))
    return Sim3(A / s, M[:3, 3], s)


def from_se3(T, s=None):
    """Lift an SE(3) pose (pair form, manifolds/se3.py) to Sim(3)."""
    scale = jnp.ones((), dtype=T.R.dtype) if s is None else jnp.asarray(s, T.R.dtype)
    return Sim3(T.R, T.t, scale)


def random(key, dtype=jnp.float32, trans_scale=1.0, log_scale=0.3):
    import jax
    k1, k2, k3 = jax.random.split(key, 3)
    return Sim3(so3.random(k1, dtype),
                trans_scale * jax.random.normal(k2, (3,), dtype=dtype),
                jnp.exp(log_scale * jax.random.normal(k3, (), dtype=dtype)))

"""Shared solver plumbing: tangent-space linearization and damped linear solves.

Solvers linearize `residual_fn` through the manifold retraction at delta=0:
    r(delta) = residual_fn(retract(x, delta), *args),  J = d r / d delta |_0
so Jacobians are computed directly in the tangent space (the effect Ceres gets
from LocalParameterization::ComputeJacobian products,
st17-ceres/src/include/solver.hpp:48-54 — here it is one jacfwd, fully fused by
XLA into the residual evaluation).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Accelerator matmuls may default to reduced-precision passes (TF32 or bf16
# on a GPU); Gauss-Newton normal equations amplify that error quadratically
# (cond(J)^2) and stall convergence short of the optimum. Every solver
# contraction therefore pins HIGHEST precision. Tiny matrices, so the cost
# is negligible.
HIGHEST = jax.lax.Precision.HIGHEST


def ata(J):
    """J^T J at full f32 precision."""
    return jnp.einsum("ki,kj->ij", J, J, precision=HIGHEST)


def atb(J, r):
    """J^T r at full f32 precision."""
    return jnp.einsum("ki,k->i", J, r, precision=HIGHEST)


def _dtype_of(x):
    return jax.tree_util.tree_leaves(x)[0].dtype


def linearize(residual_fn, manifold, x, args=()):
    """Returns (r0 (k,), J (k, dim)) in tangent coordinates."""
    dtype = _dtype_of(x)
    zero = jnp.zeros((manifold.dim,), dtype=dtype)

    def r_of_delta(d):
        return jnp.ravel(residual_fn(manifold.retract(x, d), *args))

    r0, jvp_mat = r_of_delta(zero), jax.jacfwd(r_of_delta)(zero)
    return r0, jvp_mat


def solve_damped_normal(H, g, lam, use_marquardt_scaling=True):
    """Solve (H + lam * D) delta = -g with D = diag(H) (Marquardt scaling, which
    keeps mixed-unit blocks like intrinsics+distortion+pose well-conditioned —
    the st3 design tension in SURVEY §7) or D = I. Cholesky; NaN-safe via
    jitter-free fallback to zero step on factorization failure."""
    dtype = H.dtype
    if use_marquardt_scaling:
        d = jnp.diagonal(H)
        D = jnp.diag(jnp.maximum(d, jnp.asarray(1e-12, dtype)))
    else:
        D = jnp.eye(H.shape[0], dtype=dtype)
    A = H + lam * D
    if H.shape[0] <= 16:
        # unrolled Cholesky: broadcasts over vmapped batches as pure elementwise ops
        # (generic cho_factor is ~10x slower when vmapped over tiny systems)
        from slam_tricks_tpu.ops.smallchol import cho_solve_small
        delta = cho_solve_small(A, -g)
    else:
        L, low = jax.scipy.linalg.cho_factor(A, lower=True)
        delta = jax.scipy.linalg.cho_solve((L, low), -g)
    bad = jnp.any(~jnp.isfinite(delta))
    return jnp.where(bad, jnp.zeros_like(delta), delta), bad


class SolveResult(NamedTuple):
    """Final state of an NLLS solve (pytree, vmappable)."""
    x: object
    cost: jnp.ndarray        # final 0.5*||r||^2
    iterations: jnp.ndarray  # iterations actually executed
    converged: jnp.ndarray   # bool
    grad_norm: jnp.ndarray   # final ||J^T r||_inf

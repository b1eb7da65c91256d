"""Unrolled Cholesky factorization/solve for small fixed-size SPD systems.

`jax.scipy.linalg.cho_factor` lowers to a generic blocked routine that is slow
when vmapped over thousands of tiny (3x3..12x12) systems — the batched-PnP hot
path. Unrolling the factorization at trace time turns it into ~n^3/3 scalar
ops that broadcast over the batch as elementwise work (the same shape a hand-written
Pallas kernel would take; XLA fuses this whole solve into the surrounding
computation).
"""

import jax.numpy as jnp


def cholesky_small(A):
    """Lower Cholesky of (..., n, n) SPD, unrolled for static n."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(s)
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    rows = [jnp.stack([L[i][j] if j <= i else jnp.zeros_like(A[..., 0, 0])
                       for j in range(n)], axis=-1) for i in range(n)]
    return jnp.stack(rows, axis=-2)


def solve_lower_small(L, B):
    """Solve L X = B with L (..., n, n) lower-triangular and B (..., n, k),
    unrolled for static n (broadcasts over batch dims elementwise)."""
    n = L.shape[-1]
    x = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * x[k]
        x[i] = s / L[..., i, i, None]
    return jnp.stack(x, axis=-2)


def solve_lower_t_small(L, B):
    """Solve L^T X = B with L (..., n, n) lower-triangular, B (..., n, k)."""
    n = L.shape[-1]
    x = [None] * n
    for i in reversed(range(n)):
        s = B[..., i, :]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    return jnp.stack(x, axis=-2)


def cho_solve_small(A, b):
    """Solve A x = b for (..., n, n) SPD A and (..., n) b via unrolled
    Cholesky + forward/back substitution."""
    n = A.shape[-1]
    L = cholesky_small(A)
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)

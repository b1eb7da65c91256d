"""Robust loss functions (M-estimators) and their IRLS weights.

The reference relies on Ceres' built-in losses plus explicit RANSAC/chi-square
gating (st2-epipolar/src/include/epipolar.hpp:139-209, st7/st12 RANSAC). The
framework applies robustness inside the (vmapped) solver via the standard
triggs-corrected rescaling: given squared residual norm s = ||r||^2, a loss
rho(s) contributes weight sqrt(rho'(s)) on the residual/Jacobian — static-shape
and branch-free (jnp.where), so it fuses into the normal-equation build.
"""

import dataclasses
from typing import Callable

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Loss:
    """rho maps squared norm s -> robustified cost; weight(s) = rho'(s)."""
    rho: Callable[[jnp.ndarray], jnp.ndarray]
    weight: Callable[[jnp.ndarray], jnp.ndarray]


def trivial():
    return Loss(rho=lambda s: s, weight=lambda s: jnp.ones_like(s))


def huber(delta=1.0):
    d2 = delta * delta

    def rho(s):
        return jnp.where(s <= d2, s, 2.0 * delta * jnp.sqrt(jnp.maximum(s, d2)) - d2)

    def weight(s):
        return jnp.where(s <= d2, 1.0, delta / jnp.sqrt(jnp.maximum(s, d2)))

    return Loss(rho, weight)


def cauchy(c=1.0):
    c2 = c * c

    def rho(s):
        return c2 * jnp.log1p(s / c2)

    def weight(s):
        return 1.0 / (1.0 + s / c2)

    return Loss(rho, weight)


def tukey(c=4.685):
    c2 = c * c

    def rho(s):
        inner = 1.0 - (1.0 - s / c2) ** 3
        return jnp.where(s <= c2, c2 / 3.0 * inner, c2 / 3.0)

    def weight(s):
        return jnp.where(s <= c2, (1.0 - s / c2) ** 2, jnp.zeros_like(s))

    return Loss(rho, weight)


def chi2_gate(threshold_sq):
    """Hard chi-square gate as a loss weight — the reference's iterative outlier
    rejection (epipolar.hpp:139-209, quantile 1.323*sigma^2) expressed as a
    zero-weight mask so it composes with the static-shape solver."""

    def rho(s):
        return jnp.where(s <= threshold_sq, s, jnp.full_like(s, threshold_sq))

    def weight(s):
        return jnp.where(s <= threshold_sq, jnp.ones_like(s), jnp.zeros_like(s))

    return Loss(rho, weight)

"""On-manifold IMU preintegration (Forster-style) — the application the
reference derives in its Lie-group theory doc but never implements
(reference: st23-lie-group-v2/doc.tex:132-1148 closes with the
IMU-preintegration derivation as the worked example of right-Jacobian
calculus; no st* project contains code for it).

Preintegrated deltas between keyframes i and j from raw gyro/accel samples:

    dR_{k+1} = dR_k Exp((w_k - bg) dt)
    dv_{k+1} = dv_k + dRm_k (a_k - ba) dt
    dp_{k+1} = dp_k + dv_k dt + 1/2 dRm_k (a_k - ba) dt^2

where dRm_k = dR_k Exp((w_k - bg) dt / 2) is the midpoint rotation — a
second-order integrator (the textbook start-of-step ZOH is only
first-order; measured in tests/test_preintegration.py)

with first-order bias Jacobians (d*/dbg, d*/dba) and a 9x9 tangent
covariance ([phi, v, p] ordering) propagated alongside in ONE `lax.scan`
— the whole segment integrates in a single compiled program and batches
over segments with `jax.vmap` (static samples-per-segment), which is the
Device shape: K segments x S samples integrate as one (K,S) scan.

Conventions:
- IMU measures w_meas = w_body + bg + n_g, a_meas = R^T (a_world - g) + ba + n_a
  with gravity g pointing down (default (0,0,-9.81)).
- `sigma_g` / `sigma_a` are CONTINUOUS-TIME noise densities
  (rad/s/sqrt(Hz), m/s^2/sqrt(Hz)); the discrete per-sample covariance is
  sigma^2/dt, the standard VIO convention.
- The factor residual (`imu_residual`) is the 9-vector

    r_R = Log((dR Exp(dRg dbg))^T R_i^T R_j)
    r_v = R_i^T (v_j - v_i - g Dt)            - (dv + dvg dbg + dva dba)
    r_p = R_i^T (p_j - p_i - v_i Dt - g Dt^2/2) - (dp + dpg dbg + dpa dba)

  whitened by the Cholesky factor of the propagated covariance.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from slam_tricks_tpu.manifolds import so3

GRAVITY = (0.0, 0.0, -9.81)


class PreintegratedImu(NamedTuple):
    """Preintegrated IMU segment (all fields batchable on a leading axis)."""
    dR: jnp.ndarray    # (3,3) rotation delta
    dv: jnp.ndarray    # (3,)  velocity delta (body-i frame)
    dp: jnp.ndarray    # (3,)  position delta (body-i frame)
    cov: jnp.ndarray   # (9,9) tangent covariance, [phi, v, p]
    dRg: jnp.ndarray   # (3,3) d Log(dR) / d bg
    dvg: jnp.ndarray   # (3,3) d dv / d bg
    dva: jnp.ndarray   # (3,3) d dv / d ba
    dpg: jnp.ndarray   # (3,3) d dp / d bg
    dpa: jnp.ndarray   # (3,3) d dp / d ba
    dt: jnp.ndarray    # ()    total segment duration
    bg0: jnp.ndarray   # (3,)  gyro bias the segment was integrated at
    ba0: jnp.ndarray   # (3,)  accel bias the segment was integrated at


def preintegrate(gyro, accel, dt, bg, ba, sigma_g=1.7e-4, sigma_a=2e-3,
                 init_cov_eps=1e-16):
    """Integrate S samples into one PreintegratedImu via lax.scan.

    gyro, accel: (S,3) raw measurements; dt: scalar or (S,) sample periods;
    bg, ba: (3,) biases to integrate at; sigma_g/sigma_a: continuous noise
    densities. Batch over segments with jax.vmap (same S per segment).
    """
    gyro = jnp.asarray(gyro)
    dtype = gyro.dtype
    accel = jnp.asarray(accel, dtype)
    S = gyro.shape[0]
    dts = jnp.broadcast_to(jnp.asarray(dt, dtype), (S,))
    bg = jnp.asarray(bg, dtype)
    ba = jnp.asarray(ba, dtype)
    I3 = jnp.eye(3, dtype=dtype)

    def step(carry, inp):
        dR, dv, dp, cov, dRg, dvg, dva, dpg, dpa, T = carry
        w_m, a_m, h = inp
        w = w_m - bg
        a = a_m - ba
        wh = w * h
        inc = so3.exp(wh)                 # Exp((w-bg) dt)
        Jr = so3.jr(wh)
        A_hat = so3.hat(a)
        # midpoint rotation for the specific-force terms: second-order
        # integrator (halving dt quarters the drift; the plain ZOH with the
        # start-of-step rotation is only first-order — measured in
        # tests/test_preintegration.py::test_integration_is_second_order)
        inc_h = so3.exp(0.5 * wh)
        dRm = dR @ inc_h
        dRa = dRm @ A_hat                 # dR_mid [a]_x (shared subexpression)
        # bias sensitivity of the midpoint rotation: the dR part transported
        # through the half step, plus the half step's own -Jr(wh/2) h/2
        dRgm = inc_h.T @ dRg - so3.jr(0.5 * wh) * (0.5 * h)

        # covariance: cov <- A cov A^T + B diag(sg2/h, sa2/h) B^T
        sg2 = jnp.asarray(sigma_g, dtype) ** 2 / h
        sa2 = jnp.asarray(sigma_a, dtype) ** 2 / h
        A = jnp.zeros((9, 9), dtype)
        A = A.at[0:3, 0:3].set(inc.T)
        A = A.at[3:6, 0:3].set(-dRa * h)
        A = A.at[3:6, 3:6].set(I3)
        A = A.at[6:9, 0:3].set(-0.5 * dRa * h * h)
        A = A.at[6:9, 3:6].set(I3 * h)
        A = A.at[6:9, 6:9].set(I3)
        B = jnp.zeros((9, 6), dtype)
        B = B.at[0:3, 0:3].set(Jr * h)
        B = B.at[3:6, 3:6].set(dRm * h)
        B = B.at[6:9, 3:6].set(0.5 * dRm * h * h)
        noise = jnp.concatenate([jnp.full((3,), sg2, dtype),
                                 jnp.full((3,), sa2, dtype)])
        cov = A @ cov @ A.T + (B * noise[None, :]) @ B.T

        # bias Jacobians (update BEFORE the state so they use the k-step dR)
        dpg = dpg + dvg * h - 0.5 * (dRa @ dRgm) * h * h
        dpa = dpa + dva * h - 0.5 * dRm * h * h
        dvg = dvg - (dRa @ dRgm) * h
        dva = dva - dRm * h
        dRg = inc.T @ dRg - Jr * h

        # state
        dp = dp + dv * h + 0.5 * (dRm @ a) * h * h
        dv = dv + (dRm @ a) * h
        dR = dR @ inc
        return (dR, dv, dp, cov, dRg, dvg, dva, dpg, dpa, T + h), None

    Z3 = jnp.zeros((3, 3), dtype)
    init = (I3, jnp.zeros(3, dtype), jnp.zeros(3, dtype),
            jnp.eye(9, dtype=dtype) * jnp.asarray(init_cov_eps, dtype),
            Z3, Z3, Z3, Z3, Z3, jnp.zeros((), dtype))
    (dR, dv, dp, cov, dRg, dvg, dva, dpg, dpa, T), _ = jax.lax.scan(
        step, init, (gyro, accel, dts))
    return PreintegratedImu(dR, dv, dp, cov, dRg, dvg, dva, dpg, dpa, T,
                            bg0=bg, ba0=ba)


def bias_corrected(pre: PreintegratedImu, bg, ba):
    """First-order corrected deltas at biases (bg, ba) != (bg0, ba0)."""
    dbg = bg - pre.bg0
    dba = ba - pre.ba0
    dR = pre.dR @ so3.exp(pre.dRg @ dbg)
    dv = pre.dv + pre.dvg @ dbg + pre.dva @ dba
    dp = pre.dp + pre.dpg @ dbg + pre.dpa @ dba
    return dR, dv, dp


def imu_residual(pre: PreintegratedImu, Ri, vi, Tj, vj, bg, ba,
                 gravity=GRAVITY):
    """Raw (unwhitened) 9-vector preintegration residual between states
    (Ri=SE3 pose i, vi) and (Tj, vj) at current biases. Ri/Tj are se3.SE3."""
    dtype = pre.dv.dtype
    g = jnp.asarray(gravity, dtype)
    Dt = pre.dt
    dRc, dvc, dpc = bias_corrected(pre, bg, ba)
    RiT = Ri.R.T
    r_R = so3.log(dRc.T @ (RiT @ Tj.R))
    r_v = RiT @ (vj - vi - g * Dt) - dvc
    r_p = RiT @ (Tj.t - Ri.t - vi * Dt - 0.5 * g * Dt * Dt) - dpc
    return jnp.concatenate([r_R, r_v, r_p])


def whiten(pre: PreintegratedImu, r, jitter=1e-12):
    """Whiten a 9-residual by the segment covariance: L^-1 r with
    cov = L L^T. Keeps the factor's weight consistent with the propagated
    uncertainty (the Ceres `sqrt_information * residual` role)."""
    dtype = r.dtype
    cov = pre.cov.astype(dtype) + jnp.eye(9, dtype=dtype) * jnp.asarray(jitter, dtype)
    L = jnp.linalg.cholesky(cov)
    return jsl.solve_triangular(L, r, lower=True)

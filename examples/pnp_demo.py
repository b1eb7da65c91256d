"""PnP solver comparison — the st17 main analog (4-way comparison,
st17-ceres/src/main.cpp:48-127): generic autodiff LM vs analytic-Jacobian GN vs
batched solves, with timing.

Run:  python examples/pnp_demo.py [--cpu]
"""

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n-obs", type=int, default=20)
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")

    from slam_tricks_tpu.manifolds import lie, se3, so3_r3
    from slam_tricks_tpu.residuals import reprojection
    from slam_tricks_tpu.solvers import gauss_newton, levenberg_marquardt
    from slam_tricks_tpu.solvers.pnp import solve_pnp, solve_pnp_batched
    from slam_tricks_tpu.utils import get_logger, time_median

    log = get_logger("pnp_demo")
    dtype = np.float64 if args.cpu else np.float32
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform([-2, -2, 4], [2, 2, 8], (args.n_obs, 3)).astype(dtype))
    T_true = se3.exp(jnp.asarray((rng.normal(size=6) * 0.3).astype(dtype)))
    pc = se3.act(T_true, pts)
    uv = pc[:, :2] / pc[:, 2:]
    T0 = se3.retract(T_true, jnp.asarray((rng.normal(size=6) * 0.1).astype(dtype)))

    def pnp_res(T, p, o):
        return jax.vmap(lambda a, b: reprojection.reproject_normalized(T, a, b))(p, o)

    # 1) autodiff LM with SE(3) exp parameterization (DynamicAutoDiff analog)
    f1 = jax.jit(lambda T: levenberg_marquardt(
        pnp_res, T, lie(se3), args=(pts, uv), max_iters=40))
    dt, _, r1 = time_median(f1, T0)
    log.info("LM + jacfwd + SE3 exp:      %.4f ms  cost %.3e  iters %d",
             dt * 1e3, float(r1.cost), int(r1.iterations))

    # 2) autodiff GN with SO3(+)R3 (g2o-vertex parameterization)
    f2 = jax.jit(lambda T: gauss_newton(
        pnp_res, T, so3_r3(), args=(pts, uv), iters=10))
    dt, _, r2 = time_median(f2, T0)
    log.info("GN + jacfwd + SO3+R3:       %.4f ms  cost %.3e", dt * 1e3, float(r2.cost))

    # 3) analytic-Jacobian GN (SelfGaussNewton analog — reference: 0.0192 ms)
    f3 = jax.jit(lambda T: solve_pnp(T0, pts, uv, iters=10))
    dt, _, r3 = time_median(f3, T0)
    log.info("GN analytic J:              %.4f ms  cost %.3e", dt * 1e3, float(r3.cost))

    # 4) 8192 problems batched (what no single-core solver can do)
    B = 8192
    ptsb = jnp.asarray(rng.uniform([-2, -2, 4], [2, 2, 8], (B, 32, 3)).astype(dtype))
    Tt = jax.vmap(se3.exp)(jnp.asarray((rng.normal(size=(B, 6)) * 0.2).astype(dtype)))
    pcb = jax.vmap(se3.act)(Tt, ptsb)
    uvb = pcb[..., :2] / pcb[..., 2:]
    T0b = jax.vmap(se3.retract)(Tt, jnp.asarray((rng.normal(size=(B, 6)) * 0.05).astype(dtype)))
    f4 = jax.jit(solve_pnp_batched)
    dt, _, r4 = time_median(f4, T0b, ptsb, uvb)
    log.info("batched x%d analytic GN:  %.1f ms total -> %.4f ms/solve, max cost %.2e",
             B, dt * 1e3, dt / B * 1e3, float(jnp.max(r4.cost)))


if __name__ == "__main__":
    sys.exit(main())

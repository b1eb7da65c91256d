"""Headline benchmark: LM iterations/s of the Schur-complement BA solver on the
production-scale st20 cube-room problem (96 cams, 2400 landmarks, ~83k
observations), plus optional per-stage breakdown, an honest single-core
baseline and large-scale (C=1024) entries.

Prints ONE JSON line per completed stage (the driver parses the LAST line):
  {"metric": "ba_lm_iters_per_s", "value": N, "unit": "iters/s",
   "vs_baseline": R, "detail": {...}}

Structure: the headline (xla-flat solve) and the CPU baseline run FIRST and
the result line is printed+flushed immediately; every later stage is
optional, wrapped in try/except, and gated on a wall-clock budget (env
SLAM_BENCH_BUDGET_S, default 1000 s) so one slow stage cannot wipe the run.

Timing: every device time is the median of repeated calls that each end in
jax.block_until_ready, after a warm-up call that absorbs compilation. The
run needs a GPU (it exits non-zero without one); SLAM_BENCH_SMOKE=1 runs
every stage at toy sizes on the CPU to check the code paths.

vs_baseline is the EXTERNAL anchor: headline LM
iters/s vs a TIMED scipy.optimize.least_squares TRF solve (sparse
finite-diff Jacobian) of the identical problem on one host core — an
independent production solver, standing in for the single-core Ceres
SPARSE_SCHUR the reference uses but never timed
(st20-g2o/src/include/test_ceres.h:143-148; BASELINE.md). The numpy twin of
our own algorithm (bench_baseline.py) remains as detail.vs_numpy_twin for
algorithm-parity. Both sides report best-of-N timing.
"""

import json
import os
import sys
import time

import numpy as np

# deep jit traces (recursive cyclic reduction inside fori_loop inside jit)
# can exceed CPython's default 1000-frame limit
sys.setrecursionlimit(10_000)

T0 = time.monotonic()
SMOKE = bool(int(os.environ.get("SLAM_BENCH_SMOKE", "0")))
BUDGET = float(os.environ.get("SLAM_BENCH_BUDGET_S",
                              "100000" if SMOKE else "1000"))


def _left():
    return BUDGET - (time.monotonic() - T0)


def _timeit(f, *args, reps=5):
    """Median wall time of `reps` calls after one warm-up call, each ending
    in block_until_ready. Returns (median_seconds, last output)."""
    from slam_tricks_tpu.utils.timer import time_median

    med, _, out = time_median(f, *args, warmup=1, reps=reps)
    return med, out


def _emit(result):
    print(json.dumps(result), flush=True)


# --------------------------------------------------------------------------
# required stages
# --------------------------------------------------------------------------

def stage_headline(detail):
    """Flat-layout Schur LM at the 96-cam bench scale, xla path only."""
    import jax

    from slam_tricks_tpu.sim import make_scene, perturb_scene
    from slam_tricks_tpu.solvers import schur_flat

    dtype = np.float32
    # Build the scene and every host-side index table on the CPU backend;
    # one explicit device_put afterwards is the only host->device transfer.
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        if SMOKE:
            scene = make_scene(n_per_wall=20, n_cams=8, seed=0, dtype=dtype)
        else:
            scene = make_scene(n_per_wall=400, n_cams=96, seed=0, dtype=dtype)
        poses0_h, points0_h, fixed_h = perturb_scene(scene, seed=1)
        C, L = scene.n_cams, scene.n_points
        # track-grid layout: obs row l*K+k = slot k of landmark l, turning
        # every (L,K,.) track gather into a reshape
        obs_h = schur_flat.grid_order_obs(scene.obs, L, dtype=dtype)
        work_h = schur_flat.build_flat_work(obs_h, C, L, dtype=dtype,
                                            grid=True)
        from slam_tricks_tpu.solvers import schur_flat_sm
        swork_h = schur_flat_sm.build_slot_work(scene.obs, C, L, dtype=dtype)
    dev = jax.devices()[0]
    poses0, points0, fixed, obs, work, swork = jax.device_put(
        (poses0_h, points0_h, fixed_h, obs_h, work_h, swork_h), dev)
    n_obs = int(np.sum(np.asarray(scene.obs.weight) > 0))
    K = work.mask_lk.shape[1]
    max_iters = 20

    # HEADLINE: the slot-major path (solvers/schur_flat_sm), one jitted
    # solve of max_iters LM iterations per call
    solve_sm = jax.jit(schur_flat_sm.solve_ba_flat_sm,
                       static_argnames=("max_iters",))
    t_solve, out = _timeit(
        lambda: solve_sm(poses0, points0, swork, fixed_mask=fixed,
                         max_iters=max_iters))
    iters = int(out.it)
    t_iter = t_solve / max(iters, 1)
    iters_per_s = 1.0 / t_iter
    it_ms = t_iter * 1e3

    # the l-major grid path on the same problem (the A/B column)
    solve = jax.jit(schur_flat.solve_ba_flat, static_argnames=("max_iters",))
    t_lm, out_ga = _timeit(
        lambda: solve(poses0, points0, obs, work, fixed_mask=fixed,
                      max_iters=max_iters))
    t_iter_lm = t_lm / max(int(out_ga.it), 1)

    # useful-FLOP estimate and achieved rate
    N = obs.cam_idx.shape[0]
    flops = (
        N * 150                      # linearize columns
        + 2 * N * C * 28             # camera one-hot reduction
        + N * (21 + 6 + 9 + 3 + 18) * 4   # block product columns
        + L * K * 9 * 2              # landmark track reduction
        + 2 * L * K * C * 18         # B build one-hot contraction
        + 2 * (3 * L) * (6 * C) ** 2  # S = -B^T B
        + (6 * C) ** 3 // 3          # dense Cholesky of S
        + N * 36 * 4                 # whiten + rhs + backsub products
    )
    achieved_tflops = flops / (it_ms * 1e-3) / 1e12
    # the ceiling this run's f32-HIGHEST matmuls actually reach on this
    # device: a large matmul chain timed in the same process
    import jax.numpy as jnp

    nmm = 1024 if SMOKE else 4096
    a = jnp.ones((nmm, nmm), np.float32)

    def mmf(reps, a):
        def body(i, x):
            y = jax.lax.dot_general(x, a, (((1,), (0,)), ((), ())),
                                    precision=jax.lax.Precision.HIGHEST)
            return y / jnp.maximum(jnp.abs(y[0, 0]), 1.0)
        return jax.lax.fori_loop(0, reps, body, a)

    mmf_j = jax.jit(mmf, static_argnums=0)
    r = 3 if SMOKE else 20
    tm, _ = _timeit(lambda: mmf_j(r, a))
    measured_peak = 2 * nmm ** 3 * r / tm / 1e12
    detail.update({
        "n_cams": C, "n_points": L, "n_obs": n_obs,
        "final_cost": float(out.cost), "lm_iters": iters,
        "ms_per_iter": round(it_ms, 3),
        "timing_method": (
            f"median of 5 calls of a {max_iters}-iteration jitted solve, "
            "each ending in block_until_ready, after one warm-up call; "
            "divided by the LM iterations it ran"),
        "headline_path": "xla-flat-slot-major (schur_flat_sm)",
        "lmajor_grid_iters_per_s": round(1.0 / t_iter_lm, 2),
        "flops_per_iter": flops,
        "achieved_tflops": round(achieved_tflops, 3),
        "measured_f32_highest_peak_tflops": round(measured_peak, 2),
        "mfu_vs_measured_peak": round(achieved_tflops
                                      / max(measured_peak, 1e-9), 4),
    })
    ctx = {"scene": scene, "poses0_h": poses0_h, "points0_h": points0_h,
           "fixed_h": fixed_h, "poses0": poses0, "points0": points0,
           "fixed": fixed, "obs": obs, "work": work, "swork": swork,
           "C": C, "L": L,
           "max_iters": max_iters, "dtype": dtype, "dev": dev,
           "xla_iters_per_s": iters_per_s}
    return iters_per_s, ctx


def stage_baseline(ctx, detail):
    """Single-core numpy LM baseline, >= 5 iterations, best-of-2 runs."""
    from bench_baseline import time_baseline

    obs = ctx["scene"].obs
    poses0, points0, fixed = ctx["poses0_h"], ctx["points0_h"], ctx["fixed_h"]
    args = (np.asarray(poses0.R, np.float64), np.asarray(poses0.t, np.float64),
            np.asarray(points0, np.float64), np.asarray(obs.cam_idx),
            np.asarray(obs.lm_idx), np.asarray(obs.uv, np.float64),
            np.asarray(obs.weight, np.float64), np.asarray(fixed))
    ips, spread, cost = time_baseline(*args, iters=5, repeats=2)
    detail.update({
        "baseline_iters_per_s": round(ips, 3),
        "baseline_run_spread": round(spread, 3),
        "baseline_cost_after_5it": cost,
    })
    return ips


# --------------------------------------------------------------------------
# optional stages (each budget-gated and exception-isolated)
# --------------------------------------------------------------------------

def stage_scipy_baseline(ctx, detail):
    """EXTERNAL timed baseline: scipy.optimize
    least_squares (TRF, sparse finite-diff Jacobian — an implementation with
    nothing in common with ours) on the SAME 96-cam problem. The numpy twin
    times our own algorithm single-core; this times an independent
    production solver. vs_baseline quotes THIS ratio; the twin moves to
    detail.vs_numpy_twin."""
    import time as _time

    from scipy.optimize import least_squares
    from scipy.sparse import coo_matrix
    from scipy.spatial.transform import Rotation

    obs = ctx["scene"].obs
    poses0, points0, fixed = ctx["poses0_h"], ctx["points0_h"], ctx["fixed_h"]
    cam_idx = np.asarray(obs.cam_idx)
    lm_idx = np.asarray(obs.lm_idx)
    uv = np.asarray(obs.uv, np.float64)
    w = np.asarray(obs.weight, np.float64)
    keep = w > 0
    cam_idx, lm_idx, uv, sw = (cam_idx[keep], lm_idx[keep], uv[keep],
                               np.sqrt(w[keep]))
    N = cam_idx.shape[0]
    L = ctx["L"]
    R0 = np.asarray(poses0.R, np.float64)
    rotvecs0 = Rotation.from_matrix(R0).as_rotvec()
    ts0 = np.asarray(poses0.t, np.float64)
    pts0 = np.asarray(points0, np.float64)
    free_cams = ~np.asarray(fixed)
    nf = int(free_cams.sum())
    cam_slot = np.cumsum(free_cams) - 1

    def unpack(x):
        rv = rotvecs0.copy()
        tt = ts0.copy()
        rv[free_cams] = x[:nf * 3].reshape(nf, 3)
        tt[free_cams] = x[nf * 3:2 * nf * 3].reshape(nf, 3)
        return rv, tt, x[2 * nf * 3:].reshape(L, 3)

    def residuals(x):
        rv, tt, pts = unpack(x)
        Rm = Rotation.from_rotvec(rv).as_matrix()
        pc = np.einsum("nij,nj->ni", Rm[cam_idx], pts[lm_idx]) + tt[cam_idx]
        return ((pc[:, :2] / pc[:, 2:3] - uv) * sw[:, None]).ravel()

    # vectorized block sparsity (2 rows/obs; 6 cols per free cam, 3 per lm)
    rows2 = np.repeat(np.arange(2 * N).reshape(N, 2), 3, axis=1)  # (N,2,3)
    fc = free_cams[cam_idx]
    s = cam_slot[cam_idx]
    blocks = []
    for base in (3 * s, 3 * nf + 3 * s):
        cols = (base[:, None] + np.arange(3)[None, :])[fc]
        blocks.append((rows2[fc].reshape(-1, 3).reshape(-1),
                       np.repeat(cols, 2, axis=0).reshape(-1)))
    colsl = (6 * nf + 3 * lm_idx)[:, None] + np.arange(3)[None, :]
    blocks.append((rows2.reshape(-1, 3).reshape(-1),
                   np.repeat(colsl, 2, axis=0).reshape(-1)))
    ri = np.concatenate([b[0] for b in blocks])
    ci = np.concatenate([b[1] for b in blocks])
    sp = coo_matrix((np.ones(ri.size, np.int8), (ri, ci)),
                    shape=(2 * N, 6 * nf + 3 * L))

    x0 = np.concatenate([rotvecs0[free_cams].ravel(),
                         ts0[free_cams].ravel(), pts0.ravel()])
    cost0 = 0.5 * float(np.sum(residuals(x0) ** 2))
    budget_evals = 2 if SMOKE else 10
    t0 = _time.perf_counter()
    res = least_squares(residuals, x0, jac_sparsity=sp, method="trf",
                        max_nfev=budget_evals)
    dt = _time.perf_counter() - t0
    iters = max(int(res.njev), 1)
    ips = iters / dt
    detail["baseline_scipy"] = {
        "solver": "scipy.least_squares TRF, sparse 2-point Jacobian",
        "wall_s": round(dt, 2), "lm_iters": iters, "nfev": int(res.nfev),
        "iters_per_s": round(ips, 4),
        "cost_start": cost0, "cost_reached": float(res.cost),
    }
    return ips


def stage_native_schur(ctx, detail):
    """The Ceres-class CPU baseline: single-core C++
    sparse-Schur LM with ANALYTIC Jacobians on the identical problem
    (native/schur_baseline.cpp — the algorithm Ceres SPARSE_SCHUR runs,
    st20-g2o/src/include/test_ceres.h:143-145). Strongest honest
    denominator: no autodiff overhead, no finite differences, no Python.

    Timing = best-of-2 full 20-iteration solves (pure solve wall, marshal
    excluded). NOTE on final cost: this 96-cam problem has (at least) two
    LM basins — a global one (~1e-10) and a local minimum at cost ~2.5e-2;
    which basin a solver lands in flips on sub-ulp differences in the
    iteration-2 step, so final costs are reported but iters/s is the
    comparable statistic (each iteration does identical algorithmic work)."""
    from slam_tricks_tpu.native import schur_ba_solve_native

    obs = ctx["scene"].obs
    poses0, points0, fixed = ctx["poses0_h"], ctx["points0_h"], ctx["fixed_h"]
    args = (np.asarray(poses0.R, np.float64), np.asarray(poses0.t, np.float64),
            np.asarray(points0, np.float64), np.asarray(obs.cam_idx),
            np.asarray(obs.lm_idx), np.asarray(obs.uv, np.float64),
            np.asarray(obs.weight, np.float64), np.asarray(fixed))
    best = None
    for _ in range(1 if SMOKE else 2):
        out = schur_ba_solve_native(*args, max_iters=5 if SMOKE else 20)
        ms = out["wall_ms"] / max(out["iters"], 1)
        if best is None or ms < best["ms_per_iter"]:
            best = {"ms_per_iter": ms, "iters": out["iters"],
                    "cost": out["cost"]}
    ips = 1e3 / best["ms_per_iter"]
    detail["baseline_native_schur"] = {
        "solver": "C++ single-core sparse-Schur LM, analytic J "
                  "(native/schur_baseline.cpp)",
        "ms_per_iter": round(best["ms_per_iter"], 2),
        "iters_per_s": round(ips, 3),
        "lm_iters": best["iters"],
        "final_cost": best["cost"],
    }
    return ips


def stage_undistort(ctx, detail):
    """st1 path: batched analytic-Newton undistortion, pixels/s."""
    import jax
    import jax.numpy as jnp

    from slam_tricks_tpu.residuals import camera

    n = 65_536 if SMOKE else 8_388_608
    rng = np.random.default_rng(3)
    intr = camera.Intrinsics(*[jnp.float32(v) for v in
                               (458.654, 457.296, 367.215, 248.375)])
    dist = camera.DistCoeffs(*[jnp.float32(v) for v in
                               (-0.28340811, 0.07395907, 0.0, 0.00019359,
                                1.76187114e-05)])
    px = jnp.asarray(rng.uniform([50, 50], [700, 430], (n, 2)).astype(np.float32))
    dist_px = jax.jit(lambda p: camera.distort_pixels(intr, dist, p))(px)
    f = jax.jit(lambda p: camera.undistort_points_fast(intr, dist, p))
    dt, out = _timeit(f, dist_px)
    detail.update({
        "undistort_px_per_s": round(n / dt),
        "undistort_max_err_px": float(jnp.max(jnp.abs(out - px))),
    })


def stage_pnp(ctx, detail):
    """st17 path: batched analytic-Jacobian PnP GN — the analog of the
    reference's hand-rolled SelfGaussNewton (0.0192 ms / 7 iters
    single-problem, BASELINE.md)."""
    import jax
    import jax.numpy as jnp

    from slam_tricks_tpu.manifolds import se3
    from slam_tricks_tpu.solvers.pnp import solve_pnp_batched

    batch = 256 if SMOKE else 8192
    n_obs, iters = 32, 10
    rng = np.random.default_rng(4)
    pts = jnp.asarray(rng.uniform([-2, -2, 4], [2, 2, 8],
                                  (batch, n_obs, 3)).astype(np.float32))
    xi_true = jnp.asarray((rng.normal(size=(batch, 6)) * 0.2).astype(np.float32))
    T_true = jax.vmap(se3.exp)(xi_true)
    p_cam = jax.vmap(se3.act)(T_true, pts)
    uv = p_cam[..., :2] / p_cam[..., 2:]
    xi0 = jnp.asarray((rng.normal(size=(batch, 6)) * 0.05).astype(np.float32))
    T0_ = jax.vmap(lambda T, d: se3.retract(T, d))(T_true, xi0)

    solve = jax.jit(solve_pnp_batched)
    dt, out = _timeit(solve, T0_, pts, uv)
    detail.update({
        "pnp_batched_gn_iters_per_s": round(batch * iters / dt),
        "pnp_solves_per_s": round(batch / dt),
        "pnp_batch_max_cost": float(jnp.max(out.cost)),
    })


def stage_configs(ctx, detail):
    """The remaining BASELINE.json configs as timed entries with COMPARATOR
    columns: st6 SE(3) ICP vs a single-core numpy twin,
    st3 Zhang (JITTED, init/refine split) vs cv2.calibrateCamera, st22
    two-view vs cv2 findEssentialMat+recoverPose+triangulatePoints."""
    import time as _time

    import jax
    import jax.numpy as jnp

    from slam_tricks_tpu.manifolds import se3
    from slam_tricks_tpu.pipelines.calibration import calibrate
    from slam_tricks_tpu.pipelines.two_view import solve_two_view
    from slam_tricks_tpu.residuals.icp import icp_iterate
    from slam_tricks_tpu.sim import make_calib_scene, make_two_view

    rng = np.random.default_rng(6)
    out = detail.setdefault("configs", {})   # incremental: a crash in one
                                             # config keeps the others

    def _cfg(name, fn):
        try:
            fn()
        except Exception as e:
            out[f"{name}_error"] = f"{type(e).__name__}: {str(e)[:160]}"

    def _cpu_best(f, reps=2):
        best = float("inf")
        r = None
        for _ in range(reps + 1):
            t0 = _time.perf_counter()
            r = f()
            best = min(best, _time.perf_counter() - t0)
        return best, r

    # st6: SE(3) ICP, unknown correspondences, NN association each sweep
    n_icp = 512 if SMOKE else 8192

    def _icp():
        src = jnp.asarray(rng.normal(size=(n_icp, 3)).astype(np.float32))
        T_true = se3.exp(jnp.asarray([0.08, -0.05, 0.1, 0.15, -0.1, 0.05],
                                     jnp.float32))
        dst = se3.act(T_true, src)
        icp_j = jax.jit(lambda s, d: icp_iterate(s, d, n_outer=10))
        dt, (R_est, t_est, _, _) = _timeit(icp_j, src, dst)
        terr = float(jnp.max(jnp.abs(t_est - T_true.t)))
        out["icp_se3_ms"] = round(dt * 1e3, 2)
        out["icp_n_points"] = n_icp
        out["icp_t_err"] = terr
        ctx["_icp_arrays"] = (src, dst)

    _cfg("icp", _icp)

    # honest CPU comparator: scipy cKDTree ICP — the
    # NORMAL single-core implementation (NN via kd-tree, as the reference
    # uses PCL's kd-tree, st10 detector.cpp:458-467), replacing the O(N^2)
    # brute-force numpy strawman as the quoted column.
    def icp_ckdtree():
        from scipy.spatial import cKDTree

        src, dst = ctx["_icp_arrays"]
        s = np.array(src, np.float32)
        d = np.array(dst, np.float32)
        tree = cKDTree(d)
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, np.float32)
        for _ in range(10):
            cur = s @ R.T + t
            _, nn = tree.query(cur, k=1)
            m = d[nn]
            mu_s, mu_m = cur.mean(0), m.mean(0)
            H = (cur - mu_s).T @ (m - mu_m)
            Uu, _, Vt = np.linalg.svd(H)
            Rd = Vt.T @ np.diag([1, 1, np.linalg.det(Vt.T @ Uu.T)]) @ Uu.T
            R = (Rd @ R).astype(np.float32)
            t = Rd @ (t - mu_s) + mu_m
        return R, t

    if "_icp_arrays" in ctx:
        def _icp_kd():
            dtk, _ = _cpu_best(icp_ckdtree, reps=2)
            out["icp_ckdtree_singlecore_ms"] = round(dtk * 1e3, 2)
        _cfg("icp_ckdtree", _icp_kd)

    # comparator: single-core numpy, SAME algorithm (10 sweeps of brute NN
    # + Kabsch — the reference's icp_no_binding role, st6-icp/src/include/
    # icp.hpp:63-95 generalized to SE(3))
    def icp_numpy():
        src, dst = ctx["_icp_arrays"]
        s = np.array(src, np.float32)
        d = np.array(dst, np.float32)
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, np.float32)
        for _ in range(10):
            cur = s @ R.T + t
            d2 = ((cur[:, None, :] - d[None, :, :]) ** 2).sum(-1)
            nn = d2.argmin(1)
            m = d[nn]
            mu_s, mu_m = cur.mean(0), m.mean(0)
            H = (cur - mu_s).T @ (m - mu_m)
            Uu, _, Vt = np.linalg.svd(H)
            Rd = Vt.T @ np.diag([1, 1, np.linalg.det(Vt.T @ Uu.T)]) @ Uu.T
            R = Rd @ R
            t = Rd @ (t - mu_s) + mu_m
        return R, t
    if not SMOKE and n_icp <= 8192 and "_icp_arrays" in ctx:
        def _icp_np():
            dtn, _ = _cpu_best(icp_numpy, reps=0)  # one run: a 48 s CPU solve needs no warm-up
            out["icp_numpy_singlecore_ms"] = round(dtn * 1e3, 2)
        _cfg("icp_numpy", _icp_np)

    # st3: Zhang calibration, jitted, with init/refine split: the
    # closed-form SVD init runs on the host CPU (a once-per-problem
    # millisecond computation), the LM refinement on the device.
    from slam_tricks_tpu.initialization.zhang import calibrate_closed_form

    cs = make_calib_scene(n_views=9, noise=0.3, seed=7, dtype=np.float32)

    def _zhang():
        cpu = jax.devices("cpu")[0]
        init_j = jax.jit(calibrate_closed_form, device=cpu)
        dt_init, (intr0, _, poses0) = _timeit(init_j, cs.board_pts,
                                              cs.image_pts)
        init_dev = jax.device_put((intr0, poses0), ctx["dev"])
        calib_j = jax.jit(lambda bp, ip, ini: calibrate(bp, ip, max_iters=30,
                                                        init=ini))
        dt, res = _timeit(calib_j, cs.board_pts, cs.image_pts, init_dev)
        out["zhang_ms"] = round((dt + dt_init) * 1e3, 2)
        out["zhang_init_cpu_ms"] = round(dt_init * 1e3, 2)
        out["zhang_refine_ms"] = round(dt * 1e3, 2)
        out["zhang_fx_err"] = float(jnp.abs(res.intrinsics.fx - cs.fx))

    _cfg("zhang", _zhang)
    try:
        import cv2

        P = cs.board_pts.shape[0]
        obj = np.concatenate([np.array(cs.board_pts, np.float32),
                              np.zeros((P, 1), np.float32)], axis=1)
        objs = [obj] * cs.image_pts.shape[0]
        imgs = [np.array(v, np.float32).reshape(-1, 1, 2)
                for v in cs.image_pts]
        size = (int(2 * float(cs.cx)), int(2 * float(cs.cy)))

        def cv2_calib():
            return cv2.calibrateCamera(objs, imgs, size, None, None)
        dtc, (rms, Kc, dc, _, _) = _cpu_best(cv2_calib, reps=1)
        out["zhang_cv2_ms"] = round(dtc * 1e3, 2)
        out["zhang_cv2_fx_err"] = float(abs(Kc[0, 0] - float(cs.fx)))
    except Exception as e:
        out["zhang_cv2_error"] = type(e).__name__

    # st22: two-view 8-point init + cheirality + triangulation + refinement
    tv = make_two_view(n_points=100 if SMOKE else 2000, noise=1e-3, seed=8,
                       dtype=np.float32)

    def _two_view():
        # full pipeline and init+triangulation only, so the cv2 column
        # (init+triangulation) compares like work
        def timed(ri):
            f = jax.jit(lambda a, b: solve_two_view(a, b, refine_iters=ri))
            return _timeit(f, tv.uv1, tv.uv2)

        dt_full, r = timed(15)
        dt_init, r0 = timed(0)
        out["two_view_ms"] = round(dt_full * 1e3, 2)
        out["two_view_init_tri_only_ms"] = round(dt_init * 1e3, 2)
        out["two_view_refine_only_ms"] = round(
            max(dt_full - dt_init, 0.0) * 1e3, 2)
        out["two_view_final_cost"] = float(r.final_cost)
        # time-to-equal-cost column: the cost our init-only output reaches
        # (what the cv2 pipeline's work level achieves) vs after refinement
        out["two_view_init_only_cost"] = float(r0.final_cost)

    _cfg("two_view", _two_view)
    try:
        import cv2

        p1 = np.array(tv.uv1, np.float64)
        p2 = np.array(tv.uv2, np.float64)
        K = np.eye(3)

        def cv2_two_view():
            E, _ = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC)
            _, Rr, tr, _ = cv2.recoverPose(E, p1, p2, K)
            P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
            P2 = np.hstack([Rr, tr])
            X = cv2.triangulatePoints(P1, P2, p1.T, p2.T)
            return Rr, tr, X
        dtc, _ = _cpu_best(cv2_two_view, reps=1)
        # cv2 column covers init+triangulation only (no joint refinement)
        out["two_view_cv2_init_tri_ms"] = round(dtc * 1e3, 2)
    except Exception as e:
        out["two_view_cv2_error"] = type(e).__name__

    # Sim(3) scale-drift pose graph (mono essential-graph regime, f32 on
    # the device): drifted odometry + exact loop similarities
    def _sim3_pgo():
        from slam_tricks_tpu.manifolds import sim3
        from slam_tricks_tpu.solvers import solve_pose_graph_sim3

        N = 32 if SMOKE else 96
        n_loops, ds = 4 if SMOKE else 6, 0.004
        r2 = np.random.default_rng(12)
        ang = 2 * np.pi * np.arange(N) / N
        tt = np.stack([10 * np.cos(ang), 10 * np.sin(ang),
                       0.1 * np.sin(3 * ang)], 1).astype(np.float32)
        Rt = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                                 [np.sin(a), np.cos(a), 0],
                                 [0, 0, 1]]) for a in ang]).astype(np.float32)
        p = np.exp(-ds * np.arange(N)).astype(np.float32)
        gt = sim3.Sim3(jnp.asarray(Rt), jnp.asarray(tt), jnp.asarray(p))
        ii = np.concatenate([np.arange(N - 1),
                             r2.integers(0, N // 4, n_loops)])
        jj = np.concatenate([np.arange(1, N),
                             r2.integers(3 * N // 4, N, n_loops)])
        Si = jax.tree_util.tree_map(lambda a: a[ii], gt)
        Sj = jax.tree_util.tree_map(lambda a: a[jj], gt)
        Zc = jax.vmap(lambda a, b: sim3.mul(sim3.inv(a), b))(Si, Sj)
        xi = (r2.normal(size=(len(ii), 7)) * 1e-3).astype(np.float32)
        xi[N - 1:] = 0.0
        Z = jax.vmap(lambda S, x: sim3.mul(S, sim3.exp(x)))(Zc, jnp.asarray(xi))
        info = np.broadcast_to(np.eye(7, dtype=np.float32),
                               (len(ii), 7, 7)).copy()
        info[N - 1:] *= 10.0
        # uncorrected mono map init: integrate (R, t), s = 1
        Rz, tz = np.array(Z.R, np.float64), np.array(Z.t, np.float64)
        R0, t0 = [Rt[0].astype(np.float64)], [tt[0].astype(np.float64)]
        for k in range(N - 1):
            t0.append(R0[-1] @ tz[k] + t0[-1])
            R0.append(R0[-1] @ Rz[k])
        poses0 = sim3.Sim3(jnp.asarray(np.stack(R0), jnp.float32),
                           jnp.asarray(np.stack(t0), jnp.float32),
                           jnp.ones(N, jnp.float32))
        ii_j, jj_j, info_j = jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(info)

        n_it = 8 if SMOKE else 40
        solve = jax.jit(lambda P, Z_, I_: solve_pose_graph_sim3(
            P, ii_j, jj_j, Z_, I_, max_iters=n_it, xtol=0.0))
        t2, o2 = _timeit(solve, poses0, Z, info_j)
        per_iter = t2 / max(int(o2.it), 1)
        s_err = float(np.abs(np.array(o2.poses.s) / p - 1.0).max())
        ate = float(np.sqrt(np.mean(np.sum(
            (np.array(o2.poses.t, np.float64) - tt) ** 2, 1))))
        out["sim3_pgo_ms_per_iter"] = round(per_iter * 1e3, 3)
        out["sim3_pgo_n_keyframes"] = N
        out["sim3_pgo_scale_err"] = round(s_err, 5)
        out["sim3_pgo_ate"] = round(ate, 4)
        out["sim3_pgo_final_cost"] = float(o2.cost)

    _cfg("sim3_pgo", _sim3_pgo)


def stage_breakdown(ctx, detail):
    """Per-stage ms of the slot-major iteration: each stage runs A2 times
    inside one jitted loop, timed as a whole and divided by A2."""
    import jax
    import jax.numpy as jnp

    from slam_tricks_tpu.solvers import schur_flat_sm

    poses0, points0, swork = ctx["poses0"], ctx["points0"], ctx["swork"]
    C, L, dtype, fixed = ctx["C"], ctx["L"], ctx["dtype"], ctx["fixed"]
    A1, A2 = (4, 12) if SMOKE else (8, 40)

    def loop_jit(stage_fn):
        def run(k, x):
            def body(i, acc):
                return acc + stage_fn(i)
            return jax.lax.fori_loop(0, k, body, jnp.asarray(0.0, dtype))
        return jax.jit(run, static_argnums=0)

    def stage_lin(i):
        # consume EVERY output: returning one element lets XLA dead-code
        # the rest of the pass (the landmark side and W). Perturb EVERY
        # input by the loop index: anything loop-invariant gets HOISTED out
        # of the amortization loop and the stage reads far too fast
        # (leaving poses constant lets XLA hoist the camera-side work).
        zi = 0.0 * i
        poses_i = jax.tree_util.tree_map(lambda a: a + zi, poses0)
        o = schur_flat_sm._quantities_sm(poses_i, points0 + zi, swork)
        return (o[0][0, 0] + o[1][0, 0] + sum(h[0] for h in o[2])
                + sum(g[0] for g in o[3]) + o[4][0, 0, 0] + o[5])

    Hf, gpf, Hlf, glf, Wf, _ = schur_flat_sm._quantities_sm(
        poses0, points0, swork)
    lam = jnp.asarray(1e-4, dtype)

    def stage_solve(i):
        # perturb every operand (see stage_lin): a constant Hf/lam lets XLA
        # hoist the reduced-system factorization out of the loop and the
        # "solve" degenerates to back-substitution only
        zi = 0.0 * i
        dp, dl, _, _ = schur_flat_sm._solve_sm(
            Hf + zi, gpf + zi, [h + zi for h in Hlf], [g + zi for g in glf],
            Wf + zi, lam + zi, fixed, swork)
        return dp[0, 0] + dl[0, 0]



    stages = detail.setdefault("stages", {})
    roof = detail.setdefault("roofline", {})
    total_bytes = 0.0
    # PLAIN single-call variants for the bytes cost model: the timing
    # variants perturb every operand to defeat loop hoisting, but those
    # perturbations materialize full copies of the operand tables in the
    # unfused single-call lowering and inflate "bytes accessed" ~3x past
    # the physical bandwidth (a fraction above 1). Bytes use the
    # unperturbed call; time uses the hoist-proof loop.
    def stage_lin_plain(i):
        o = schur_flat_sm._quantities_sm(poses0, points0 + 0.0 * i, swork)
        return (o[0][0, 0] + o[1][0, 0] + sum(h[0] for h in o[2])
                + sum(g[0] for g in o[3]) + o[4][0, 0, 0] + o[5])

    def stage_solve_plain(i):
        dp, dl, _, _ = schur_flat_sm._solve_sm(
            Hf, gpf + 0.0 * i, list(Hlf), list(glf), Wf, lam, fixed, swork)
        return dp[0, 0] + dl[0, 0]

    # the production iteration is linearize+assemble (the trial pass
    # doubles as the cost evaluation — no separate cost kernel) + solve
    for name, fn, fn_plain in (
            ("linearize_assemble_ms", stage_lin, stage_lin_plain),
            ("schur_solve_ms", stage_solve, stage_solve_plain)):
        jfn = loop_jit(fn)
        jfn_plain = loop_jit(fn_plain)   # bytes: unperturbed bodies only —
        # the timing variant's per-operand perturbations materialize operand
        # copies whose bytes scale WITH k, so loop-differencing would not
        # remove them either
        d2, _ = _timeit(lambda: jfn(A2, jnp.zeros((), dtype)))
        stages[name] = round(d2 / A2 * 1e3, 4)
        # HBM bytes from XLA's own cost model: per-stage
        # bytes accessed of the compiled amortized loop, differenced between
        # the two amortization counts (removes loop-invariant setup bytes)
        try:
            def _bytes(k):
                ca = jfn_plain.lower(k, jnp.zeros((), dtype)).compile() \
                    .cost_analysis()
                if isinstance(ca, (list, tuple)):
                    ca = ca[0]
                return float(ca.get("bytes accessed", 0.0))
            b1, b2 = _bytes(A1), _bytes(A2)
            if b2 > b1:
                by = (b2 - b1) / (A2 - A1)
                roof["bytes_method"] = "loop-differenced cost model"
            else:
                # XLA's cost model does not descend into while-loop bodies
                # (the amortization loops report ~0 bytes); count one direct,
                # unlooped stage call instead. UPPER BOUND: the unfused
                # single call re-reads every stage input and materializes
                # intermediates the fused loop keeps on-chip, so the
                # derived bandwidth_fraction is an upper bound too.
                ca = jax.jit(fn_plain).lower(jnp.asarray(0, dtype)) \
                    .compile().cost_analysis()
                if isinstance(ca, (list, tuple)):
                    ca = ca[0]
                by = float(ca.get("bytes accessed", 0.0))
                roof["bytes_method"] = ("single-call cost model (UPPER "
                                        "bound: unfused stage inputs + "
                                        "intermediates)")
            roof[name.replace("_ms", "_MB")] = round(by / 1e6, 1)
            total_bytes += by
        except Exception as e:
            roof[f"{name}_bytes_error"] = type(e).__name__

    # measured copy bandwidth ceiling: B repeated dynamic rolls of a 256 MB
    # array inside one jit. A v+1-style body
    # FUSES across iterations into a single memory pass (elementwise chains
    # collapse); a roll whose shift depends on the loop index cannot, so
    # every iteration genuinely moves 2x the array through HBM.
    nbw = 1 << 20 if SMOKE else 1 << 26

    def bwf(k, x):
        def body(i, v):
            return jnp.roll(v, i + 1)
        return jax.lax.fori_loop(0, k, body, x)

    bwf_j = jax.jit(bwf, static_argnums=0)
    xbw = jnp.ones((nbw,), np.float32)
    B = 6 if SMOKE else 64
    db, _ = _timeit(lambda: bwf_j(B, xbw))
    gbps = 2 * nbw * 4 * B / db / 1e9
    it_ms = detail.get("ms_per_iter", 0.0)
    roof.update({
        "bytes_per_iter_MB": round(total_bytes / 1e6, 1),
        "measured_copy_GBps": round(gbps, 1),
        "achieved_GBps": round(total_bytes / 1e9
                               / max(it_ms * 1e-3, 1e-9), 1),
        "bandwidth_fraction": round(
            (total_bytes / max(it_ms * 1e-3, 1e-9)) / (gbps * 1e9), 4),
    })


def stage_large_scale(ctx, detail):
    """C=1024 / L=2e5 trajectory problem, slot-major banded-direct solver
    (solvers/banded_flat): exact linear solves, zero large gathers
    (SURVEY §7 step 5 'larger pose counts')."""
    import jax

    from slam_tricks_tpu.sim import make_trajectory_scene, perturb_scene
    from slam_tricks_tpu.solvers import banded_flat

    dtype = np.float32
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        if SMOKE:
            scene = make_trajectory_scene(n_cams=32, n_points=500, track_len=6,
                                          seed=11, dtype=dtype)
        else:
            scene = make_trajectory_scene(n_cams=1024, n_points=200_000,
                                          track_len=8, seed=11, dtype=dtype)
        poses0, points0, fixed = perturb_scene(
            scene, pose_rot_noise=0.002, pose_trans_noise=0.01,
            point_noise=0.01, seed=12)
        C, L = scene.n_cams, scene.n_points
        bwork = banded_flat.build_banded_work(scene.obs, C, L, dtype=dtype)
    poses0, points0, fixed, bwork = jax.device_put(
        (poses0, points0, fixed, bwork), ctx["dev"])
    mi = 12

    solve = jax.jit(banded_flat.solve_ba_banded,
                    static_argnames=("max_iters",))
    dt, out = _timeit(lambda: solve(poses0, points0, bwork, fixed_mask=fixed,
                                    max_iters=mi))

    detail["large_scale"] = {
        "n_cams": C, "n_points": L,
        "n_obs": int(np.sum(np.asarray(scene.obs.weight) > 0)),
        "banded_ms_per_iter": round(dt * 1e3 / max(int(out.it), 1), 2),
        "banded_final_cost": float(out.cost),
        "banded_lm_iters": int(out.it),
    }
    obs_d = jax.device_put(scene.obs, ctx["dev"])
    ctx["large"] = {"scene": scene, "C": C, "L": L, "poses0": poses0,
                    "points0": points0, "fixed": fixed, "obs": obs_d}


def stage_large_scale_general(ctx, detail):
    """GENERAL long-span visibility at large C: the
    st20 cube-room structure scaled to C=1024 — every wall landmark seen
    from a large arc of the spiral (mean track ~370 of 1024 cameras), so
    the reduced camera system is genuinely DENSE and no banded/loop
    decomposition applies. Solved by the slot-major flat path in its
    large-C mode (gather-table camera ops + device-built bf16 track
    one-hot for the B build + dense (6C)^2 Schur + Cholesky).

    Comparator: the C++ single-core sparse-Schur baseline on the same
    scene (the Ceres-class number; the r4 gather-table PCG fallback that
    lost to dense is retired by this path)."""
    import jax

    from slam_tricks_tpu.sim import make_scene, perturb_scene
    from slam_tricks_tpu.solvers import schur_flat_sm

    dtype = np.float32
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        if SMOKE:
            scene = make_scene(n_per_wall=60, n_cams=24, seed=5, dtype=dtype)
        else:
            scene = make_scene(n_per_wall=1200, n_cams=1024, seed=5,
                               dtype=dtype)
        poses0, points0, fixed = perturb_scene(
            scene, pose_rot_noise=0.002, pose_trans_noise=0.01,
            point_noise=0.01, seed=6)
        C, L = scene.n_cams, scene.n_points
        swork = schur_flat_sm.build_slot_work(scene.obs, C, L, dtype=dtype,
                                              use_onehot=False)
    poses0_d, points0_d, fixed_d, swork = jax.device_put(
        (poses0, points0, fixed, swork), ctx["dev"])

    solve = jax.jit(schur_flat_sm.solve_ba_flat_sm,
                    static_argnames=("max_iters",))
    mi = 4 if SMOKE else 10
    t2, out = _timeit(
        lambda: solve(poses0_d, points0_d, swork, fixed_mask=fixed_d,
                      max_iters=mi), reps=3)
    it2 = int(out.it)
    t_iter = t2 / max(it2, 1)
    d = {
        "n_cams": C, "n_points": L,
        "n_obs": int(np.sum(np.asarray(scene.obs.weight) > 0)),
        "track_len_mean": round(float(np.mean(np.bincount(
            np.asarray(scene.obs.lm_idx)[
                np.asarray(scene.obs.weight) > 0], minlength=L))), 1),
        "sm_ms_per_iter": round(t_iter * 1e3, 2),
        "sm_final_cost": float(out.cost), "sm_lm_iters": it2,
        "structure": "dense reduced camera system (landmark span ~C/3); "
                     "every matmul HIGHEST",
    }
    detail["large_scale_general"] = d
    if not SMOKE and _left() > 240:
        try:
            from slam_tricks_tpu.native import schur_ba_solve_native
            obs = scene.obs
            nat = schur_ba_solve_native(
                np.asarray(poses0.R, np.float64),
                np.asarray(poses0.t, np.float64),
                np.asarray(points0, np.float64), np.asarray(obs.cam_idx),
                np.asarray(obs.lm_idx), np.asarray(obs.uv, np.float64),
                np.asarray(obs.weight, np.float64), np.asarray(fixed),
                max_iters=1)
            d["native_schur_singlecore_ms_per_iter"] = round(
                nat["wall_ms"] / max(nat["iters"], 1), 1)
            d["native_schur_note"] = ("pure solve time over 1 LM iteration "
                                      "(budget)")
        except Exception as e:
            d["native_error"] = type(e).__name__


def stage_loop_scale(ctx, detail):
    """C=1024 LOOP-CLOSURE scene (landmarks near the trajectory start
    re-observed by the final cameras) through the banded+Woodbury solver
    (solvers/loop_flat) — the general-visibility structure where the banded
    solver raises."""
    import jax

    from slam_tricks_tpu.sim import perturb_scene
    from slam_tricks_tpu.sim.ba_scene import make_loop_scene
    from slam_tricks_tpu.solvers import loop_flat

    dtype = np.float32
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        if SMOKE:
            scene = make_loop_scene(n_cams=32, n_points=500, track_len=6,
                                    seed=21, dtype=dtype)
            max_band = 6
        else:
            scene = make_loop_scene(n_cams=1024, n_points=200_000,
                                    track_len=8, seed=21, dtype=dtype)
            max_band = 8
        poses0, points0, fixed = perturb_scene(
            scene, pose_rot_noise=0.002, pose_trans_noise=0.01,
            point_noise=0.01, seed=22)
        C, L = scene.n_cams, scene.n_points
        lw = loop_flat.build_loop_work(scene.obs, C, L, dtype=dtype,
                                       max_band=max_band)
    poses0, points0, fixed, lw = jax.device_put(
        (poses0, points0, fixed, lw), ctx["dev"])
    mi = 12
    solve = jax.jit(loop_flat.solve_ba_loop, static_argnames=("max_iters",))
    dt, out = _timeit(lambda: solve(poses0, points0, lw, fixed_mask=fixed,
                                    max_iters=mi))
    n_lc = int(np.sum(np.asarray(lw.lc_weight).sum(0) > 0))
    detail["loop_scale"] = {
        "n_cams": C, "n_points": L,
        "n_obs": int(np.sum(np.asarray(scene.obs.weight) > 0)),
        "n_loop_landmarks": n_lc,
        "support_cams": int(np.asarray(lw.onehot_A).sum()),
        "woodbury_width": int(min(3 * lw.lc_weight.shape[1],
                                  6 * lw.onehot_A.shape[0])),
        "loop_ms_per_iter": round(dt * 1e3 / max(int(out.it), 1), 2),
        "loop_final_cost": float(out.cost),
        "loop_lm_iters": int(out.it),
    }
    banded = detail.get("large_scale", {}).get("banded_ms_per_iter")
    if banded:
        detail["loop_scale"]["vs_banded_trajectory"] = round(
            detail["loop_scale"]["loop_ms_per_iter"] / banded, 2)
    ctx["loop"] = {"scene": scene, "poses0": poses0, "points0": points0,
                   "fixed": fixed}


def stage_loop_dense_comparator(ctx, detail):
    """Exact paired-scan dense comparator on the SAME loop-closure scene —
    the honest 'beats dense' column for the Woodbury path."""
    import jax

    from slam_tricks_tpu.solvers import schur

    lp = ctx.get("loop")
    if lp is None:
        return
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        pairs = schur.build_track_pairs(lp["scene"].obs.cam_idx,
                                        lp["scene"].obs.lm_idx,
                                        dtype=np.float32)
    pairs, obs = jax.device_put((pairs, lp["scene"].obs), ctx["dev"])
    solve_dense = jax.jit(lambda p, x, f: schur.solve_ba(
        p, x, obs, fixed_mask=f, max_iters=5, linear_solver="paired",
        track_pairs=pairs))
    dt, out = _timeit(
        lambda: solve_dense(lp["poses0"], lp["points0"], lp["fixed"]), reps=1)
    detail["loop_scale"].update({
        "paired_dense_ms_per_iter": round(dt * 1e3 / max(int(out.it), 1), 2),
        "paired_dense_final_cost": float(out.cost),
    })


def stage_vi(ctx, detail):
    """IMU preintegration + visual-inertial smoothing (st23's theory doc,
    implemented in estimation/): batched-segment preintegration throughput
    (K segments x S samples as ONE vmapped scan) and the dense VI MAP
    smoother's per-LM-iteration rate. Quality columns:
    smoother ATE improvement over the raw pose observations and the
    recovered metric scale of a 0.7x-mis-scaled visual-inertial BA (a
    monocular BA cannot recover scale at all — tests/test_preintegration)."""
    import jax
    import jax.numpy as jnp

    from slam_tricks_tpu.estimation import vi_smoother as vis
    from slam_tricks_tpu.estimation.preintegration import preintegrate

    out = detail.setdefault("vi", {})
    S = 16 if SMOKE else 64
    K2 = 128 if SMOKE else 3072
    sim = vis.simulate_vi(n_keyframes=8, samples_per_seg=S, dt=0.0025,
                          sigma_g=2e-4, sigma_a=2e-3, dtype=jnp.float32)
    gyro2 = jnp.tile(sim.gyro[0], (K2, 1, 1))
    accel2 = jnp.tile(sim.accel[0], (K2, 1, 1))
    bz = jnp.zeros(3, jnp.float32)

    pj = jax.jit(jax.vmap(lambda w, a: preintegrate(w, a, 0.0025, bz, bz)))
    t2, _ = _timeit(lambda: pj(gyro2, accel2))
    seg_s = t2 / K2
    out["preint_segments_per_s"] = round(1.0 / max(seg_s, 1e-12))
    out["preint_samples_per_seg"] = S
    out["preint_imu_rate_hz"] = round(S / max(seg_s, 1e-12))

    # chain VI smoother (the production path: block-tridiag 9-dim states
    # + shared-bias Schur, estimation/vi_chain.py). The dense
    # solve_vi_smoother is its parity reference in tests.
    import functools

    from slam_tricks_tpu.estimation.vi_chain import solve_vi_chain

    K = 16 if SMOKE else 1024
    simk = vis.simulate_vi(n_keyframes=K, samples_per_seg=20, dt=0.005,
                           sigma_g=2e-4, sigma_a=2e-3, obs_rot_noise=0.005,
                           obs_trans_noise=0.01, seed=3, dtype=jnp.float32)
    bias0 = jnp.zeros(6, jnp.float32)
    pre = vis.preintegrate_segments(simk, bias0[:3], bias0[3:],
                                    sigma_g=2e-4, sigma_a=2e-3)
    run_vi = jax.jit(
        functools.partial(solve_vi_chain, obs_rot_sigma=0.005,
                          obs_trans_sigma=0.01),
        static_argnames=("max_iters",))

    n_it = 6 if SMOKE else 30
    tv2, sol = _timeit(
        lambda: run_vi(pre, simk.obs_poses, simk.obs_poses,
                       simk.vels_true, bias0, max_iters=n_it))
    it2 = int(sol.it)
    per_it = tv2 / max(it2, 1)
    out["smoother_path"] = "solve_vi_chain (block-tridiag + bias Schur, f32)"
    out["smoother_n_keyframes"] = K
    out["smoother_ms_per_lm_iter"] = round(per_it * 1e3, 3)
    out["smoother_lm_iters"] = it2

    from slam_tricks_tpu.evaluation.metrics import ate_translation_rmse

    out["smoother_ate_obs"] = round(
        float(ate_translation_rmse(simk.obs_poses, simk.poses_true)), 5)
    out["smoother_ate"] = round(
        float(ate_translation_rmse(sol.poses, simk.poses_true)), 5)


def stage_posegraph(ctx, detail):
    """10k-pose chain+loop-closure pose-graph LM on the device in f32: the
    relative-state formulation (solve_pose_graph_relative) removes the ~N^3
    chain conditioning structurally, so f32 suffices.

    External comparator: scipy SuperLU (splu) factor+solve of the SAME
    damped absolute-state normal equations (60k x 60k sparse, f64, single
    core) — the linear-algebra engine a g2o/Ceres-class CPU solver pays
    per LM iteration (anything-not-us anchor)."""
    import jax
    import jax.numpy as jnp

    from slam_tricks_tpu.manifolds import se3
    from slam_tricks_tpu.solvers.posegraph import (build_chain_work,
                                                   solve_pose_graph_relative)

    N = 512 if SMOKE else 10_000
    n_loops = 8 if SMOKE else 64
    dtype = np.float32
    rng = np.random.default_rng(17)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ang = 2 * np.pi * np.arange(N) / N
        t_true = np.stack([10 * np.cos(ang), 10 * np.sin(ang),
                           0.1 * np.sin(3 * ang)], 1)
        Rt = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                                 [np.sin(a), np.cos(a), 0],
                                 [0, 0, 1]]) for a in ang])
        poses_true = se3.SE3(jnp.asarray(Rt.astype(dtype)),
                             jnp.asarray(t_true.astype(dtype)))
        ii = np.concatenate([np.arange(N - 1),
                             rng.integers(0, N // 4, n_loops)])
        jj = np.concatenate([np.arange(1, N),
                             rng.integers(3 * N // 4, N, n_loops)])
        Ti = jax.tree_util.tree_map(lambda a: a[ii], poses_true)
        Tj = jax.tree_util.tree_map(lambda a: a[jj], poses_true)
        Zc = jax.vmap(lambda a, b: se3.mul(se3.inv(a), b))(Ti, Tj)
        scale = np.where(np.arange(len(ii)) < N - 1, 0.002, 0.0005)
        xi = rng.normal(size=(len(ii), 6)) * scale[:, None]
        Z = jax.vmap(lambda T, x: se3.mul(T, se3.exp(x)))(
            Zc, jnp.asarray(xi.astype(dtype)))
        info = jnp.broadcast_to(jnp.eye(6, dtype=dtype), (len(ii), 6, 6))
        R0, t0 = [Rt[0]], [t_true[0]]
        Zr, Zt = np.asarray(Z.R, np.float64), np.asarray(Z.t, np.float64)
        for k in range(N - 1):
            R0.append(R0[-1] @ Zr[k])
            t0.append(R0[-2] @ Zt[k] + t0[-1])
        poses0 = se3.SE3(jnp.asarray(np.stack(R0).astype(dtype)),
                         jnp.asarray(np.stack(t0).astype(dtype)))
        work = build_chain_work(ii, jj, Z, info, N, dtype=dtype)
    poses0_d, work_d = jax.device_put((poses0, work), ctx["dev"])

    solve = jax.jit(solve_pose_graph_relative,
                    static_argnames=("max_iters",))
    n_it = 6 if SMOKE else 30
    t2, out = _timeit(lambda: solve(poses0_d, work_d, max_iters=n_it))
    t_iter = t2 / max(int(out.it), 1)
    if not SMOKE:
        # quality columns from a longer solve
        out = solve(poses0_d, work_d, max_iters=80)
        jax.block_until_ready(out.cost)
    err0 = float(np.sqrt(np.mean((np.stack(t0) - t_true) ** 2)))
    err = float(np.sqrt(np.mean(
        (np.asarray(out.poses.t, np.float64) - t_true) ** 2)))
    detail["posegraph"] = {
        "backend": "f32 on the device, relative-state formulation "
                   "(solve_pose_graph_relative) — block-diagonal chain "
                   "Hessian + rank-6-per-loop Woodbury",
        "n_poses": N, "n_loop_edges": int(n_loops),
        "ms_per_iter": round(t_iter * 1e3, 2), "lm_iters": int(out.it),
        "final_cost": float(out.cost),
        "ate_before": round(err0, 4), "ate_after": round(err, 4),
    }
    # external comparator: SuperLU on the damped absolute-state normal
    # equations (the per-iteration linear algebra of a CPU sparse solver)
    try:
        import time as _time

        from scipy.sparse import coo_matrix
        from scipy.sparse.linalg import splu

        from slam_tricks_tpu.solvers.posegraph import _edge_linearize
        with jax.default_device(cpu):
            r_, Ji, Jj = _edge_linearize(
                jax.tree_util.tree_map(
                    lambda a: a.astype(jnp.float32), poses0),
                jnp.asarray(ii), jnp.asarray(jj), Z, info)
            Ji = np.asarray(Ji, np.float64)
            Jj = np.asarray(Jj, np.float64)
            rnp = np.asarray(r_, np.float64)
        E = len(ii)
        blocks, rows, cols = [], [], []
        br = np.arange(6)
        for (a_idx, Ja) in ((ii, Ji), (jj, Jj)):
            for (b_idx, Jb) in ((ii, Ji), (jj, Jj)):
                Hab = np.einsum("eri,erj->eij", Ja, Jb)
                r0 = (6 * a_idx[:, None, None] + br[None, :, None])
                c0 = (6 * b_idx[:, None, None] + br[None, None, :])
                blocks.append(Hab.ravel())
                rows.append(np.broadcast_to(r0, (E, 6, 6)).ravel())
                cols.append(np.broadcast_to(c0, (E, 6, 6)).ravel())
        H = coo_matrix((np.concatenate(blocks),
                        (np.concatenate(rows), np.concatenate(cols))),
                       shape=(6 * N, 6 * N)).tocsc()
        lam = 1e-6
        Hd = H + lam * __import__("scipy.sparse", fromlist=["eye"]).eye(
            6 * N, format="csc")
        g = np.zeros(6 * N)
        np.add.at(g, (6 * ii[:, None] + br[None]).ravel(),
                  np.einsum("eri,er->ei", Ji, rnp).ravel())
        np.add.at(g, (6 * jj[:, None] + br[None]).ravel(),
                  np.einsum("eri,er->ei", Jj, rnp).ravel())
        tb = _time.perf_counter()
        lu = splu(Hd)
        _ = lu.solve(-g)
        dt_lu = _time.perf_counter() - tb
        detail["posegraph"]["scipy_splu_factor_solve_ms"] = round(
            dt_lu * 1e3, 1)
        detail["posegraph"]["scipy_splu_note"] = (
            "single-core SuperLU factor+solve of the damped absolute-state "
            "normal equations (6N x 6N, f64) — the per-LM-iteration linear "
            "algebra of a g2o/Ceres-class CPU solver on this graph")
    except Exception as e:
        detail["posegraph"]["scipy_error"] = f"{type(e).__name__}: {e}"[:160]


def stage_large_pcg(ctx, detail):
    """LEGACY comparator: the gather-table PCG path on the trajectory
    problem. Superseded for every realistic visibility structure by the
    banded (trajectory) and banded+Woodbury (loop-closure) direct solvers —
    kept on record to document the 250x gap layout engineering closed."""
    import jax

    from slam_tricks_tpu.sim import make_trajectory_scene, perturb_scene
    from slam_tricks_tpu.solvers import schur_flat
    from slam_tricks_tpu.solvers.pcg_flat import build_pcg_work

    lg = ctx.get("large")
    if lg is None:
        return
    scene = lg["scene"]
    dtype = np.float32
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        poses0, points0, fixed = perturb_scene(
            scene, pose_rot_noise=0.002, pose_trans_noise=0.01,
            point_noise=0.01, seed=12)
        C, L = scene.n_cams, scene.n_points
        work = schur_flat.build_flat_work(scene.obs, C, L, dtype=dtype)
        pcgw = build_pcg_work(scene.obs, C, dtype=dtype)
    poses0, points0, fixed, obs, work, pcgw = jax.device_put(
        (poses0, points0, fixed, scene.obs, work, pcgw), ctx["dev"])
    mi = 5
    solve_pcg = jax.jit(lambda p, x, f: schur_flat.solve_ba_flat(
        p, x, obs, work, fixed_mask=f, max_iters=mi,
        linear="pcg", pcg_work=pcgw, cg_iters=50, cg_tol=1e-6))
    dt_pcg, out_pcg = _timeit(lambda: solve_pcg(poses0, points0, fixed),
                              reps=3)
    detail["large_scale"].update({
        "pcg_ms_per_iter": round(dt_pcg * 1e3 / max(int(out_pcg.it), 1), 2),
        "pcg_final_cost": float(out_pcg.cost),
    })


def stage_large_dense_comparator(ctx, detail):
    """Exact paired-scan dense comparator at C=1024 — O((6C)^3) replicated
    factorization; only run when budget allows (it jit-compiles two giant
    programs and solves a (6144,6144) system)."""
    import jax

    from slam_tricks_tpu.solvers import schur

    lg = ctx.get("large")
    if lg is None or "obs" not in lg:
        return
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        pairs = schur.build_track_pairs(lg["scene"].obs.cam_idx,
                                        lg["scene"].obs.lm_idx,
                                        dtype=np.float32)
    pairs = jax.device_put(pairs, ctx["dev"])
    solve_dense = jax.jit(lambda p, x, f: schur.solve_ba(
        p, x, lg["obs"], fixed_mask=f, max_iters=5, linear_solver="paired",
        track_pairs=pairs))
    dt, out = _timeit(
        lambda: solve_dense(lg["poses0"], lg["points0"], lg["fixed"]), reps=1)
    detail["large_scale"].update({
        "paired_dense_ms_per_iter": round(dt * 1e3 / max(int(out.it), 1), 2),
        "paired_dense_final_cost": float(out.cost),
    })


# --------------------------------------------------------------------------

def main():
    import jax

    if SMOKE:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        print(f"bench.py: needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r} (SLAM_BENCH_SMOKE=1 runs the toy "
              f"sizes on the CPU)", file=sys.stderr)
        return 2
    from slam_tricks_tpu.utils.runtime import device_info, enable_compile_cache

    # NLLS normal equations need true-f32 contractions (solvers/common.py);
    # this also covers XLA's internal Cholesky blocks.
    jax.config.update("jax_default_matmul_precision", "highest")
    # x64 stays off: every stage runs f32 as deployed, and turning it on
    # would silently widen the f32 SVD chains of the icp/two-view/zhang
    # stages.
    enable_compile_cache()

    detail = {"device": device_info()}
    result = {"metric": "ba_lm_iters_per_s", "value": 0.0, "unit": "iters/s",
              "vs_baseline": None, "detail": detail}

    # required: headline + baselines, then flush the first result line.
    # vs_baseline is the EXTERNAL anchor (timed scipy least_squares TRF on
    # the same problem); the numpy twin of our own
    # algorithm is kept as detail.vs_numpy_twin for algorithm-parity.
    iters_per_s, ctx = stage_headline(detail)
    result["value"] = round(iters_per_s, 2)
    try:
        twin_ips = stage_baseline(ctx, detail)
        detail["vs_numpy_twin"] = round(iters_per_s / twin_ips, 2)
    except Exception as e:
        detail["baseline_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    try:
        scipy_ips = stage_scipy_baseline(ctx, detail)
        detail["vs_scipy_trf"] = round(iters_per_s / scipy_ips, 2)
    except Exception as e:
        detail["scipy_baseline_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    # vs_baseline is the STRONGEST honest denominator:
    # the C++ single-core sparse-Schur LM with analytic Jacobians — the
    # Ceres SPARSE_SCHUR algorithm without Ceres's generic-graph overhead.
    # Fallbacks: scipy TRF (weaker external solver), then the numpy twin.
    try:
        native_ips = stage_native_schur(ctx, detail)
        result["vs_baseline"] = round(iters_per_s / native_ips, 2)
        detail["vs_native_schur"] = result["vs_baseline"]
        detail["vs_baseline_meaning"] = (
            "headline LM iters/s vs single-core C++ sparse-Schur LM with "
            "analytic Jacobians on the identical problem "
            "(native/schur_baseline.cpp — the Ceres SPARSE_SCHUR algorithm). "
            "Weaker external anchors: vs_scipy_trf times scipy "
            "least_squares TRF, whose finite-difference sparse Jacobians "
            "make each of its iterations far more expensive (nfev >> njev); "
            "vs_numpy_twin times our own algorithm in single-core numpy. "
            "scipy is timed single-run; the other sides best-of-2.")
    except Exception as e:
        detail["native_schur_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        if "vs_scipy_trf" in detail:
            result["vs_baseline"] = detail["vs_scipy_trf"]
            detail["vs_baseline_meaning"] = (
                "vs timed scipy least_squares TRF (sparse finite-diff J; "
                "nfev >> njev handicap), single core — native C++ baseline "
                "unavailable")
        elif "vs_numpy_twin" in detail:
            result["vs_baseline"] = detail["vs_numpy_twin"]
            detail["vs_baseline_meaning"] = "vs numpy twin (others failed)"
    _emit(result)

    # optional stages: (name, fn, min-budget-seconds to even start), the
    # dense comparator columns last so a short budget loses those first
    optional = [
        ("undistort", lambda: stage_undistort(ctx, detail), 60),
        ("pnp", lambda: stage_pnp(ctx, detail), 60),
        ("breakdown", lambda: stage_breakdown(ctx, detail), 60),
        ("large_scale", lambda: stage_large_scale(ctx, detail), 180),
        ("large_scale_general",
         lambda: stage_large_scale_general(ctx, detail), 200),
        ("loop_scale", lambda: stage_loop_scale(ctx, detail), 150),
        ("configs", lambda: stage_configs(ctx, detail), 90),
        ("posegraph", lambda: stage_posegraph(ctx, detail), 100),
        ("vi", lambda: stage_vi(ctx, detail), 200),
        ("large_dense_comparator",
         lambda: stage_large_dense_comparator(ctx, detail), 140),
        ("loop_dense_comparator",
         lambda: stage_loop_dense_comparator(ctx, detail), 130),
        ("large_pcg", lambda: stage_large_pcg(ctx, detail), 190),
    ]
    stage_wall = detail.setdefault("stage_wall_s", {})
    for name, fn, min_budget in optional:
        if not SMOKE and _left() < min_budget:
            detail.setdefault("skipped", []).append(name)
            continue
        t_st = time.monotonic()
        try:
            fn()
        except Exception as e:
            detail[f"{name}_error"] = f"{type(e).__name__}: {str(e)[:300]}"
        stage_wall[name] = round(time.monotonic() - t_st, 1)
        _emit(result)
    detail["bench_wall_s"] = round(time.monotonic() - T0, 1)
    _emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

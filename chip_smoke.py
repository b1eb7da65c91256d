"""Chip smoke test: the bundle-adjustment main path on the GPU, checked
against plain references.

    python chip_smoke.py          # one card: every single-card phase
    python chip_smoke.py --four   # four cards: the distributed solvers only

Run from the repository root. Each phase prints one JSON line with its
compile time, run time (median of warm repetitions, each ending in
block_until_ready), device memory and the checks it made, each with its
value, its limit and the reason for the limit. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and is printed only when every phase passed. Without a GPU the script
exits non-zero before any phase runs.

Phases on one card:
  headline    96-camera cube-room BA (~83k observations), 20 LM iterations
              on schur_flat_sm; the same code in f32 on the host CPU and
              schur.solve_ba in f64 on the host CPU as references.
  trajectory  C=1024, L=200,000, track_len=8 (~1.6M observations), 12 LM
              iterations on banded_flat; f32 noise floor, aligned ATE, and
              a C=256 parity run of the same code in f64 on the host CPU.
  long_span   C=1024 cube room (~2.7M observations, mean track ~370
              cameras) on schur_flat_sm's large-C mode: dense 6144^2
              reduced system and the device-built (K, L, C) one-hot.
  plain       the XLA stages that replaced hand-written kernels: Cholesky
              factor+solve at n=576 and 6144, block-tridiagonal cyclic
              reduction at (G, m)=(128, 48), undistortion of 8.4M pixels,
              and the headline's linearize+assemble.
Phases with --four:
  families    __graft_entry__.dryrun_multichip on four cards (all five
              distributed families against their single-device solvers).
  banded_dist parallel/banded_dist on the C=1024 trajectory scene against
              single-card banded_flat on the same problem.
"""

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

EPS32 = float(np.finfo(np.float32).eps)


class CheckFailed(AssertionError):
    def __init__(self, result):
        super().__init__("failed checks: " + ", ".join(
            c["name"] for c in result["checks"] if not c["ok"]))
        self.result = result


def _check(out, name, value, limit, reason, *, at_most=True):
    value = float(value)
    ok = bool(np.isfinite(value) and (value <= limit if at_most
                                      else value >= limit))
    out.setdefault("checks", []).append(
        {"name": name, "value": value,
         "limit": ("<= " if at_most else ">= ") + repr(float(limit)),
         "ok": ok, "reason": reason})


def _finish(out):
    if not all(c["ok"] for c in out.get("checks", [])):
        raise CheckFailed(out)
    return out


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _memory(compiled):
    """compiled.memory_analysis() as a dict of byte counts."""
    try:
        ma = compiled.memory_analysis()
    except Exception as e:  # backends without the analysis report why
        return {"error": f"{type(e).__name__}: {e}"[:200]}
    if ma is None:
        return None
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    return {f: getattr(ma, f) for f in fields if hasattr(ma, f)}


def _stats(dev, key):
    stats = dev.memory_stats()
    return None if stats is None else stats.get(key)


def _compile_and_time(fn, args, reps):
    """AOT-compile `fn` for the devices `args` live on, then time it.
    Returns (result, timing dict)."""
    import jax

    from slam_tricks_tpu.utils.timer import time_median

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    run_s, times, result = time_median(compiled, *args, reps=reps)
    return result, {"compile_s": compile_s, "run_s_median": run_s,
                    "run_s_all": times, "memory_analysis": _memory(compiled)}


def _f64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64))
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def _aligned_ate(poses, poses_true):
    from slam_tricks_tpu.evaluation.metrics import (align_trajectories,
                                                    ate_translation_rmse)

    return float(ate_translation_rmse(align_trajectories(poses, poses_true),
                                      poses_true))


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def phase_headline(dev, *, n_per_wall=400, n_cams=96, iters=20, reps=5):
    """Cube-room BA on schur_flat_sm (f32 on `dev`) against the same code in
    f32 on the host CPU and schur.solve_ba in f64 on the host CPU."""
    import jax

    from slam_tricks_tpu.sim import make_scene, perturb_scene
    from slam_tricks_tpu.solvers import schur, schur_flat_sm

    cpu = _cpu()
    with jax.default_device(cpu):
        scene = make_scene(n_per_wall=n_per_wall, n_cams=n_cams, seed=0,
                           dtype=np.float32)
        poses0, points0, fixed = perturb_scene(scene, seed=1)
        swork = schur_flat_sm.build_slot_work(
            scene.obs, scene.n_cams, scene.n_points, dtype=np.float32)
    n_obs = int(np.sum(np.asarray(scene.obs.weight) > 0))

    def solve(p, x, w, f):
        return schur_flat_sm.solve_ba_flat_sm(p, x, w, fixed_mask=f,
                                              max_iters=iters)

    host = (poses0, points0, swork, fixed)
    out_d, timing = _compile_and_time(solve, jax.device_put(host, dev), reps)
    out_c = jax.block_until_ready(jax.jit(solve)(*jax.device_put(host, cpu)))
    with jax.default_device(cpu):
        ref = jax.block_until_ready(jax.jit(
            lambda p, x, o, f: schur.solve_ba(p, x, o, fixed_mask=f,
                                              max_iters=iters))(
            _f64(poses0), _f64(points0), _f64(scene.obs), fixed))

    cost = float(out_d.cost)
    out = {"n_cams": scene.n_cams, "n_points": scene.n_points,
           "n_obs": n_obs, "lm_iters": int(out_d.it),
           "ms_per_iter": timing["run_s_median"] * 1e3 / max(int(out_d.it), 1),
           **timing, "peak_bytes_in_use": _stats(dev, "peak_bytes_in_use"),
           "final_cost": cost, "cpu_f32_cost": float(out_c.cost),
           "f64_reference_cost": float(ref.cost),
           "f64_reference_iters": int(ref.it)}
    _check(out, "result_is_f32", 0.0 if out_d.cost.dtype == np.float32
           else 1.0, 0.0, "the solve runs in f32; a promoted output means "
           "an operand was silently widened")
    floor = 0.5 * n_obs * EPS32 ** 2
    _check(out, "cost_vs_cpu_f32", cost, 10.0 * max(float(out_c.cost), floor),
           "10x the same code's f32 cost on the host CPU; below one f32 ulp "
           "per unit-scale residual (0.5*n_obs*eps32^2) the cost measures "
           "rounding order, not convergence, so that is the least limit")
    dt = np.max(np.abs(np.asarray(out_d.poses.t, np.float64)
                       - np.asarray(ref.poses.t)))
    dR = np.max(np.abs(np.asarray(out_d.poses.R, np.float64)
                       - np.asarray(ref.poses.R)))
    reason = ("f32 LM at its rounding floor sits within ~1e-6 of the f64 "
              "optimum on this well-conditioned room (5e-7 measured at 48 "
              "cameras on CPU); 1e-4 leaves room for the 96-camera "
              "conditioning while any wrong basin or TF32-rounded "
              "contraction (~1e-3 relative) fails")
    _check(out, "pose_t_vs_f64_reference", dt, 1e-4, reason)
    _check(out, "pose_R_vs_f64_reference", dR, 1e-4, reason)
    return _finish(out)


def _trajectory_problem(n_cams, n_points, seed=11):
    import jax

    from slam_tricks_tpu.sim import make_trajectory_scene, perturb_scene

    with jax.default_device(_cpu()):
        scene = make_trajectory_scene(n_cams=n_cams, n_points=n_points,
                                      track_len=8, seed=seed,
                                      dtype=np.float32)
        poses0, points0, fixed = perturb_scene(
            scene, pose_rot_noise=0.002, pose_trans_noise=0.01,
            point_noise=0.01, seed=seed + 1)
    return scene, poses0, points0, fixed


def _banded_solver(iters):
    from slam_tricks_tpu.solvers import banded_flat

    def solve(p, x, w, f):
        return banded_flat.solve_ba_banded(p, x, w, fixed_mask=f,
                                           max_iters=iters)
    return solve


def _trajectory_floor(scene, n_obs):
    """f32 rounding floor of the trajectory scene's cost: world coordinates
    up to max|p| are rounded at eps32*max|p| before the projection divides
    by the scene's least landmark depth, 6 (sim/ba_scene.py), in each of the
    two residual components."""
    pmax = float(np.max(np.abs(np.asarray(scene.points_true))))
    return n_obs * (pmax * EPS32 / 6.0) ** 2


def phase_trajectory(dev, *, n_cams=1024, n_points=200_000, iters=12,
                     parity_cams=256, parity_points=50_000, reps=5):
    """Trajectory BA on banded_flat: f32 floor and aligned ATE at full size
    on `dev`, and a reduced-size parity run of the same code in f64 on the
    host CPU."""
    import jax

    from slam_tricks_tpu.solvers import banded_flat

    cpu = _cpu()
    scene, poses0, points0, fixed = _trajectory_problem(n_cams, n_points)
    with jax.default_device(cpu):
        bwork = banded_flat.build_banded_work(scene.obs, n_cams, n_points,
                                              dtype=np.float32)
    n_obs = int(np.sum(np.asarray(scene.obs.weight) > 0))
    solve = _banded_solver(iters)
    args = jax.device_put((poses0, points0, bwork, fixed), dev)
    cost0 = float(jax.jit(_banded_solver(0))(*args).cost)
    out_d, timing = _compile_and_time(solve, args, reps)
    del args
    poses_true = jax.device_put(scene.poses_true, cpu)
    ate0 = _aligned_ate(poses0, poses_true)
    ate = _aligned_ate(jax.device_put(out_d.poses, cpu), poses_true)
    cost = float(out_d.cost)
    out = {"n_cams": n_cams, "n_points": n_points, "n_obs": n_obs,
           "lm_iters": int(out_d.it),
           "ms_per_iter": timing["run_s_median"] * 1e3 / max(int(out_d.it), 1),
           **timing, "peak_bytes_in_use": _stats(dev, "peak_bytes_in_use"),
           "initial_cost": cost0, "final_cost": cost,
           "aligned_ate_initial": ate0, "aligned_ate": ate}
    floor = _trajectory_floor(scene, n_obs)
    _check(out, "cost_at_f32_floor", cost, floor,
           "n_obs*(max|p|*eps32/6)^2: the rounding of world coordinates "
           "carried through the projection; a converged f32 solve sits "
           "at or below it")
    _check(out, "aligned_ate_m", ate, 5e-3,
           "1e-4 of the 50 m trajectory radius; f32 leaves the chain's weak "
           "bending modes (cond(S) grows as C^3) at the mm level: 2.5e-3 m "
           "measured in f32 on CPU at C=1024, L=50,000, from 1.7e-2 m")

    # reduced-size parity: the same code in f32 on `dev` and f64 on the CPU
    ps, p0s, x0s, fxs = _trajectory_problem(parity_cams, parity_points)
    with jax.default_device(cpu):
        bw32 = banded_flat.build_banded_work(ps.obs, parity_cams,
                                             parity_points, dtype=np.float32)
        bw64 = banded_flat.build_banded_work(_f64(ps.obs), parity_cams,
                                             parity_points, dtype=np.float64)
    args32 = jax.device_put((p0s, x0s, bw32, fxs), dev)
    one32 = jax.jit(_banded_solver(1))(*args32)
    o32 = jax.jit(solve)(*args32)
    with jax.default_device(cpu):
        one64 = jax.jit(_banded_solver(1))(_f64(p0s), _f64(x0s), bw64, fxs)
    rel = abs(float(one32.cost) - float(one64.cost)) / float(one64.cost)
    out.update({"parity_n_cams": parity_cams, "parity_n_points": parity_points,
                "parity_iter1_f32_cost": float(one32.cost),
                "parity_iter1_f64_cost": float(one64.cost),
                "parity_f32_final_cost": float(o32.cost)})
    _check(out, "parity_iter1_cost_rel_f32_vs_f64", rel, 5e-3,
           "one LM step from the same start, far above the floor; f32's "
           "Schur downdate cancels against Hpp (eps32*|Hpp| ~ |band|), so "
           "an f32 step reaches the f64 step's cost to ~1e-3: 3.6e-4 and "
           "4.6e-4 on CPU at C=256 and C=64, 1.9e-3 with the f32 step on "
           "an H100 at C=256, L=50,000")
    _check(out, "parity_f32_cost_at_floor", float(o32.cost),
           _trajectory_floor(ps, int(np.sum(np.asarray(ps.obs.weight) > 0))),
           "as cost_at_f32_floor, at the parity size")
    return _finish(out)


def phase_long_span(dev, *, n_per_wall=1200, n_cams=1024, iters=10, reps=5):
    """Long-span cube room on schur_flat_sm's large-C mode (gather-table
    camera fetch, device-built (K, L, C) bf16 one-hot, dense reduced
    system). The final cost is held to the ground truth's f32 cost."""
    import jax

    from slam_tricks_tpu.sim import make_scene, perturb_scene
    from slam_tricks_tpu.solvers import schur_flat_sm

    cpu = _cpu()
    with jax.default_device(cpu):
        scene = make_scene(n_per_wall=n_per_wall, n_cams=n_cams, seed=5,
                           dtype=np.float32)
        poses0, points0, fixed = perturb_scene(
            scene, pose_rot_noise=0.002, pose_trans_noise=0.01,
            point_noise=0.01, seed=6)
        swork = schur_flat_sm.build_slot_work(
            scene.obs, scene.n_cams, scene.n_points, dtype=np.float32,
            use_onehot=False)
    n_obs = int(np.sum(np.asarray(scene.obs.weight) > 0))
    K, L = swork.mask.shape

    def solve(p, x, w, f):
        return schur_flat_sm.solve_ba_flat_sm(p, x, w, fixed_mask=f,
                                              max_iters=iters)

    args = jax.device_put((poses0, points0, swork, fixed), dev)
    out_d, timing = _compile_and_time(solve, args, reps)
    true_args = jax.device_put((scene.poses_true, scene.points_true), dev)
    cost_true = float(jax.jit(
        lambda p, x, w: schur_flat_sm._quantities_sm(p, x, w)[-1])(
            *true_args, args[2]))
    cost = float(out_d.cost)
    out = {"n_cams": scene.n_cams, "n_points": L, "n_obs": n_obs,
           "max_track_len": K, "onehot_bytes": K * L * scene.n_cams * 2,
           "reduced_system_n": 6 * scene.n_cams,
           "lm_iters": int(out_d.it),
           "ms_per_iter": timing["run_s_median"] * 1e3 / max(int(out_d.it), 1),
           **timing, "peak_bytes_in_use": _stats(dev, "peak_bytes_in_use"),
           "final_cost": cost, "ground_truth_f32_cost": cost_true}
    _check(out, "cost_vs_ground_truth_floor", cost,
           10.0 * max(cost_true, 0.5 * n_obs * EPS32 ** 2),
           "10x the f32 cost of the noiseless ground truth, itself pure "
           "rounding; one f32 ulp per unit-scale residual is the least "
           "floor")
    return _finish(out)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) / np.sqrt(n)
    return A @ A.T + np.eye(n), rng.normal(size=n)


def phase_plain(dev, *, chol_sizes=(576, 6144), tridiag=(128, 48),
                n_pixels=8_388_608, n_per_wall=400, n_cams=96, reps=5):
    """The XLA stages that replaced the hand-written kernels, each timed on
    `dev` and compared with a float64 host reference."""
    import jax
    import jax.numpy as jnp

    from slam_tricks_tpu.residuals import camera
    from slam_tricks_tpu.sim import make_scene, perturb_scene
    from slam_tricks_tpu.solvers import banded_flat, schur_flat_sm

    out = {"peak_bytes_in_use": None}

    def chol(S, b):
        cf = jax.scipy.linalg.cho_factor(S, lower=True)
        return jax.scipy.linalg.cho_solve(cf, b)

    for n in chol_sizes:
        S, b = _spd(n, seed=n)
        x, t = _compile_and_time(
            chol, jax.device_put((S.astype(np.float32), b.astype(np.float32)),
                                 dev), reps)
        ref = np.linalg.solve(S, b)
        err = np.max(np.abs(np.asarray(x, np.float64) - ref)) / np.max(
            np.abs(ref))
        out[f"cho_factor_solve_n{n}"] = {**t, "rel_err": float(err)}
        _check(out, f"cho_n{n}_rel_err", err, 1e-4,
               "S = AA^T/n + I has cond(S) < 5, so f32 factor+solve is "
               "good to ~n*eps32 relative; 1e-4 fails a TF32 contraction")

    G, m = tridiag
    rng = np.random.default_rng(0)
    Gm = rng.normal(size=(G, m, m + 8))
    D = Gm @ Gm.transpose(0, 2, 1) + 8 * np.eye(m)[None]
    E = 0.3 * rng.normal(size=(G - 1, m, m))
    r = rng.normal(size=(G, m))
    x, t = _compile_and_time(
        banded_flat.block_tridiag_solve_cr,
        jax.device_put(tuple(a.astype(np.float32) for a in (D, E, r)), dev),
        reps)
    M = np.zeros((G, m, G, m))
    for g in range(G):
        M[g, :, g, :] = D[g]
    for g in range(G - 1):
        M[g + 1, :, g, :] = E[g]
        M[g, :, g + 1, :] = E[g].T
    ref = np.linalg.solve(M.reshape(G * m, G * m), r.reshape(-1)).reshape(
        G, m)
    err = np.max(np.abs(np.asarray(x, np.float64) - ref)) / np.max(
        np.abs(ref))
    out[f"block_tridiag_cr_G{G}_m{m}"] = {**t, "rel_err": float(err)}
    _check(out, "tridiag_rel_err", err, 1e-4,
           "diagonally dominant blocks; f32 cyclic reduction is good to "
           "~1e-6 relative (CPU test at (16, 48)), 1e-4 fails TF32")

    intr = camera.Intrinsics(*[np.float32(v) for v in
                               (458.654, 457.296, 367.215, 248.375)])
    dist = camera.DistCoeffs(*[np.float32(v) for v in
                               (-0.28340811, 0.07395907, 0.0, 0.00019359,
                                1.76187114e-05)])
    px = np.random.default_rng(3).uniform(
        [50, 50], [700, 430], (n_pixels, 2)).astype(np.float32)
    px_d = jax.device_put(px, dev)
    dist_px = jax.jit(lambda p: camera.distort_pixels(intr, dist, p))(px_d)
    und, t = _compile_and_time(
        lambda p: camera.undistort_points_fast(intr, dist, p), (dist_px,),
        reps)
    err = float(jnp.max(jnp.abs(und - px_d)))
    head = min(n_pixels, 65_536)
    with jax.default_device(_cpu()):
        ref = camera.undistort_points_fast(
            *_f64((intr, dist)), jnp.asarray(np.asarray(dist_px[:head],
                                                        np.float64)))
    err_ref = float(np.max(np.abs(np.asarray(und[:head], np.float64)
                                  - np.asarray(ref))))
    out["undistort_points_fast"] = {
        **t, "n_pixels": n_pixels,
        "pixels_per_s": n_pixels / t["run_s_median"],
        "round_trip_max_err_px": err, "vs_f64_max_err_px": err_ref}
    _check(out, "undistort_round_trip_px", err, 1e-3,
           "f32 pixel coordinates up to 700 px carry 6e-5 px per ulp; five "
           "Newton steps leave a few ulps (2.4e-4 px recorded earlier)")
    _check(out, "undistort_vs_f64_px", err_ref, 1e-3,
           "as the round trip, against the same code in f64 on the CPU")

    cpu = _cpu()
    with jax.default_device(cpu):
        scene = make_scene(n_per_wall=n_per_wall, n_cams=n_cams, seed=0,
                           dtype=np.float32)
        poses0, points0, _ = perturb_scene(scene, seed=1)
        swork = schur_flat_sm.build_slot_work(
            scene.obs, scene.n_cams, scene.n_points, dtype=np.float32)
    lin, t = _compile_and_time(schur_flat_sm._quantities_sm,
                               jax.device_put((poses0, points0, swork), dev),
                               reps)
    with jax.default_device(cpu):
        ref = jax.jit(schur_flat_sm._quantities_sm)(
            _f64(poses0), _f64(points0), _f64(swork))
    errs = {}
    for name, a, b in (("Hpp", lin[0], ref[0]), ("gp", lin[1], ref[1]),
                       ("Hll", jnp.stack(lin[2]), jnp.stack(ref[2])),
                       ("W", lin[4], ref[4])):
        a = np.asarray(a, np.float64)
        b = np.asarray(b)
        errs[name] = float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)),
                                                        1e-300))
    out["linearize_assemble"] = {**t, "rel_err": errs}
    _check(out, "linearize_assemble_rel_err", max(errs.values()), 1e-4,
           "f32 sums of up to a few thousand observations per camera are "
           "good to ~1e-6 relative; an operand of the bf16 one-hot "
           "products rounded to TF32 or bf16 gives ~1e-3 and fails")
    out["peak_bytes_in_use"] = _stats(dev, "peak_bytes_in_use")
    return _finish(out)


def phase_families(devs):
    """Parity of every distributed family against its single-device solver
    (__graft_entry__.dryrun_multichip) on `devs`."""
    import __graft_entry__

    return __graft_entry__.dryrun_multichip(len(devs))


def phase_banded_dist(devs, *, n_cams=1024, n_points=200_000, iters=12,
                      reps=5):
    """parallel/banded_dist over a 1-D mesh of `devs` against single-card
    banded_flat on the same trajectory problem. Shards are placed before the
    call, so each card's bytes in use show its slice."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from slam_tricks_tpu.parallel.banded_dist import (
        DistBandedWork, build_dist_banded_work, make_ba_solver_banded_dist)
    from slam_tricks_tpu.solvers import banded_flat

    D = len(devs)
    mesh = Mesh(np.array(devs), axis_names=("obs",))
    scene, poses0, points0, fixed = _trajectory_problem(n_cams, n_points)
    n_obs = int(np.sum(np.asarray(scene.obs.weight) > 0))
    with jax.default_device(_cpu()):
        dwork = build_dist_banded_work(scene.obs, n_cams, n_points, D,
                                       dtype=np.float32)
        bwork = banded_flat.build_banded_work(scene.obs, n_cams, n_points,
                                              dtype=np.float32)
    before = [_stats(d, "bytes_in_use") or 0 for d in devs]
    local = jax.device_put(dwork.local,
                           NamedSharding(mesh, PartitionSpec("obs")))
    jax.block_until_ready(local)
    after = [_stats(d, "bytes_in_use") or 0 for d in devs]
    work_bytes = sum(a.nbytes for a in jax.tree_util.tree_leaves(local))
    shard_bytes = [a - b for a, b in zip(after, before)]
    dwork = DistBandedWork(local=local, n_points=dwork.n_points)
    args1 = jax.device_put((poses0, points0, bwork, fixed), devs[0])

    out = {"n_devices": D, "n_cams": n_cams, "n_points": n_points,
           "n_obs": n_obs, "work_bytes": work_bytes,
           "shard_bytes_per_device": shard_bytes}
    p0_r, x0_r, fixed_r = jax.device_put(
        (poses0, points0, fixed), NamedSharding(mesh, PartitionSpec()))
    o_d, t_d = _compile_and_time(
        make_ba_solver_banded_dist(mesh, max_iters=iters),
        (p0_r, x0_r, dwork, fixed_r), reps)
    o_1, t_1 = _compile_and_time(_banded_solver(iters), args1, reps)
    pt = jax.device_put(scene.poses_true, _cpu())
    poses_d = jax.device_put(o_d.poses, _cpu())
    poses_1 = jax.device_put(o_1.poses, _cpu())
    out.update({"lm_iters": iters, "dist": t_d, "single": t_1,
                "dist_cost": float(o_d.cost), "single_cost": float(o_1.cost),
                "dist_iters": int(o_d.it), "single_iters": int(o_1.it)})
    floor = _trajectory_floor(scene, n_obs)
    for name, o, poses in (("dist", o_d, poses_d), ("single", o_1, poses_1)):
        ate = _aligned_ate(poses, pt)
        out[f"{name}_aligned_ate"] = ate
        _check(out, f"{name}_cost_at_f32_floor", float(o.cost), floor,
               "as the trajectory phase: n_obs*(max|p|*eps32/6)^2")
        _check(out, f"{name}_aligned_ate_m", ate, 5e-3,
               "as the trajectory phase")
    _check(out, "same_iteration_count", abs(int(o_d.it) - int(o_1.it)), 0,
           "the same LM control law on the same problem")
    _check(out, "dist_vs_single_aligned_m", _aligned_ate(poses_d, poses_1),
           5e-3, "two exact f32 solves at the rounding floor differ only "
           "along the weak bending modes, as each differs from the truth; "
           "step-level parity of the two (after two iterations, f32 at C=256 "
           "and f64 at C=64) is the families phase's banded_dist check")
    out["peak_bytes_in_use_per_device"] = [
        _stats(d, "peak_bytes_in_use") for d in devs]
    if all(b is not None for b in
           (_stats(d, "bytes_in_use") for d in devs)):
        _check(out, "least_shard_fraction",
               min(shard_bytes) / max(work_bytes / D, 1), 0.5,
               "each card holds its quarter of the sharded work, not "
               "device 0 alone", at_most=False)
    return _finish(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed phases on four cards")
    args = ap.parse_args(argv)

    # the host CPU backend holds the references: keep it beside the GPU
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    try:
        import jax
        backend = jax.default_backend()
    except Exception as e:  # no usable backend at all
        print(f"chip_smoke: JAX found no backend: {e}", file=sys.stderr)
        return 2
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's backend is {backend!r}",
              file=sys.stderr)
        return 2
    devs = jax.devices()
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 2

    from slam_tricks_tpu.utils.runtime import device_info, enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    cache = enable_compile_cache()
    info = device_info()
    for line in info["nvidia_smi"] or ["nvidia-smi: not available"]:
        print(line, flush=True)
    _emit({"phase": "device", "platform": info["platform"],
           "kind": info["kind"], "count": info["count"],
           "nvidia_smi": info["nvidia_smi"], "compile_cache": cache,
           "jax": jax.__version__})

    if args.four:
        phases = [("families", lambda: phase_families(devs[:4])),
                  ("banded_dist", lambda: phase_banded_dist(devs[:4]))]
    else:
        dev = devs[0]
        phases = [("headline", lambda: phase_headline(dev)),
                  ("trajectory", lambda: phase_trajectory(dev)),
                  ("long_span", lambda: phase_long_span(dev)),
                  ("plain", lambda: phase_plain(dev))]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
            ok = True
        except CheckFailed as e:
            res, ok = e.result, False
        except Exception as e:
            traceback.print_exc()
            res, ok = {"error": f"{type(e).__name__}: {e}"[:2000]}, False
        if not ok:
            failed.append(name)
        _emit({"phase": name, "ok": ok,
               "wall_s": time.perf_counter() - t0, **(res or {})})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    _emit({"ok": True, "device": {"platform": info["platform"],
                                  "kind": info["kind"],
                                  "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

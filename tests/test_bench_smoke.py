"""bench.py end-to-end smoke at tiny shapes on CPU (SLAM_BENCH_SMOKE=1):
catches API drift in the benchmark before it costs a chip run. Outside
smoke mode the benchmark refuses to run without a GPU."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench(smoke, timeout):
    env = dict(os.environ)
    env.pop("SLAM_BENCH_SMOKE", None)
    if smoke:
        env["SLAM_BENCH_SMOKE"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


def test_bench_smoke():
    out = _bench(smoke=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    data = json.loads(line)
    assert data["metric"] == "ba_lm_iters_per_s"
    assert data["value"] > 0
    d = data["detail"]
    for key in ("stages", "flops_per_iter", "baseline_iters_per_s",
                "large_scale", "mfu_vs_measured_peak", "vi", "device"):
        assert key in d, key
    assert d["device"]["platform"] == "cpu" and d["device"]["count"] >= 1
    assert d["vi"]["preint_segments_per_s"] > 0
    for gone in ("weak_scaling", "dispatch_const_ms",
                 "mfu_vs_f32_highest_peak", "tridiag_solver_ab"):
        assert gone not in d, gone


def test_bench_refuses_cpu_outside_smoke_mode():
    out = _bench(smoke=False, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs a GPU" in out.stderr

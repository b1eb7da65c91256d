"""chip_smoke.py: it refuses to run without a GPU, and each of its phases
runs at toy size on the CPU (or on four of the virtual CPU devices) and
passes its own parity checks. The full-size run needs the card."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, path], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


def test_refuses_cpu_backend():
    out = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_main_refuses_cpu_in_process(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four"]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def _cpu():
    return jax.devices("cpu")[0]


def _passed(res):
    assert res["checks"] and all(c["ok"] for c in res["checks"])
    json.dumps(res)                  # every phase result is printable


def test_headline_phase_toy():
    res = chip_smoke.phase_headline(_cpu(), n_per_wall=40, n_cams=12,
                                    iters=20, reps=1)
    _passed(res)
    assert res["lm_iters"] > 0 and res["compile_s"] > 0


def test_long_span_phase_toy():
    res = chip_smoke.phase_long_span(_cpu(), n_per_wall=30, n_cams=24,
                                     iters=10, reps=1)
    _passed(res)
    assert res["onehot_bytes"] == res["max_track_len"] * res["n_points"] * 48


def test_plain_phase_toy():
    res = chip_smoke.phase_plain(_cpu(), chol_sizes=(48, 96), tridiag=(8, 12),
                                 n_pixels=10_000, n_per_wall=30, n_cams=12,
                                 reps=1)
    _passed(res)
    assert set(res) >= {"cho_factor_solve_n48", "block_tridiag_cr_G8_m12",
                        "undistort_points_fast", "linearize_assemble"}


@pytest.mark.parametrize("failing", [True, False])
def test_failed_check_raises_with_its_numbers(failing):
    out = {}
    chip_smoke._check(out, "x", 2.0 if failing else 0.5, 1.0, "reason")
    if failing:
        with pytest.raises(chip_smoke.CheckFailed) as e:
            chip_smoke._finish(out)
        assert e.value.result["checks"][0]["value"] == 2.0
    else:
        assert chip_smoke._finish(out) is out

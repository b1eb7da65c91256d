"""chip_smoke.py's trajectory phase on the CPU: it passes its own parity
checks. The full-size run needs the card."""

import jax

import chip_smoke


def test_trajectory_phase_toy():
    # C=256, L=20,000 is the smallest trajectory whose f32 solve converges
    # to its rounding floor in 12 iterations with a wide margin
    res = chip_smoke.phase_trajectory(jax.devices("cpu")[0], n_cams=256,
                                      n_points=20_000, parity_cams=256,
                                      parity_points=20_000, reps=1)
    assert all(c["ok"] for c in res["checks"])
    assert res["aligned_ate"] < res["aligned_ate_initial"]

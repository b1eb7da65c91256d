"""chip_smoke.py's four-card phases on four of the virtual CPU devices: each
passes its own parity checks. The full-size run needs four cards."""

import jax

import chip_smoke


def test_banded_dist_phase_four_virtual_devices():
    devs = jax.devices("cpu")[:4]
    assert len(devs) == 4
    # the trajectory phase's toy size (see test_chip_smoke_trajectory.py)
    res = chip_smoke.phase_banded_dist(devs, n_cams=256, n_points=20_000,
                                       reps=1)
    assert all(c["ok"] for c in res["checks"])
    assert res["n_devices"] == 4

"""chip_smoke.py's families phase on four of the virtual CPU devices: the
parity checks of every distributed family pass. The full-size run needs
four cards."""

import jax

import chip_smoke


def test_families_phase_four_virtual_devices():
    res = chip_smoke.phase_families(jax.devices("cpu")[:4])
    assert set(res) == {"sharded", "landmark-local", "pcg_dist",
                        "banded_dist", "loop_dist", "banded_dist_f64"}

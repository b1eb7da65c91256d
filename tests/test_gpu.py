"""The chip-smoke phases on a GPU at reduced size. These skip without a GPU;
run them on a GPU host with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -n 0 tests/`."""

import pytest

import chip_smoke


@pytest.mark.gpu
def test_headline_phase_on_gpu(gpu_device):
    res = chip_smoke.phase_headline(gpu_device, n_per_wall=100, n_cams=32,
                                    reps=2)
    assert all(c["ok"] for c in res["checks"])


@pytest.mark.gpu
def test_plain_phase_on_gpu(gpu_device):
    res = chip_smoke.phase_plain(gpu_device, chol_sizes=(576,),
                                 tridiag=(16, 48), n_pixels=1 << 20,
                                 n_per_wall=100, n_cams=32, reps=2)
    assert all(c["ok"] for c in res["checks"])

"""Test configuration: run on CPU with 8 virtual devices (multi-chip sharding
tests without hardware) and x64 enabled (verification precision parity with the
reference's Eigen/Ceres doubles).

The platform list comes from JAX_PLATFORMS and defaults to the CPU alone.
Tests marked `gpu` take the `gpu_device` fixture, which skips them unless
JAX sees a GPU: run them on a GPU host with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -n 0 tests/`."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules: a process that
    accumulates 150+ XLA:CPU compilations reproducibly SEGFAULTS inside
    backend_compile (observed round 4 at the same suite position across
    runs; xdist workers reduced but did not eliminate it in slow mode).
    Modules rarely share compiled programs, so the cost is small."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX sees none (decided when a test
    runs, never at collection)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU; JAX sees none")
    # as bench.py and chip_smoke.py do: f32 contractions outside the
    # solvers' own pinned ones (XLA's Cholesky blocks) must not fall to
    # TF32 on the GPU
    jax.config.update("jax_default_matmul_precision", "highest")
    return gpus[0]

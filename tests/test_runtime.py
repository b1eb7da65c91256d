"""Set-up helpers (slam_tricks_tpu/utils/runtime.py): the compile
cache location and the device description."""

import jax

from slam_tricks_tpu.utils import runtime


def _restore_cache_dir(fn):
    before = jax.config.jax_compilation_cache_dir
    try:
        return fn()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_environment_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))

    def run():
        before = jax.config.jax_compilation_cache_dir
        got = runtime.enable_compile_cache(root=str(tmp_path))
        assert got == str(tmp_path / "env")
        assert jax.config.jax_compilation_cache_dir == before
        assert not (tmp_path / ".jax_cache").exists()
    _restore_cache_dir(run)


def test_cache_dir_defaults_to_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)

    def run():
        got = runtime.enable_compile_cache(root=str(tmp_path))
        assert got == str(tmp_path / ".jax_cache")
        assert (tmp_path / ".jax_cache").is_dir()
        assert jax.config.jax_compilation_cache_dir == got
    _restore_cache_dir(run)


def test_device_info_reports_what_jax_sees():
    info = runtime.device_info()
    assert info["platform"] == jax.devices()[0].platform
    assert info["kind"] == jax.devices()[0].device_kind
    assert info["count"] == len(jax.devices())
    assert info["nvidia_smi"] is None or isinstance(info["nvidia_smi"], list)

"""Process set-up shared by bench.py and chip_smoke.py: the persistent
compilation cache and the description of the device a run measured."""

import os
import subprocess

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(root=_CHECKOUT):
    """Point JAX's persistent compilation cache at a fixed directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here. Otherwise the cache is `<root>/.jax_cache` (the checkout by
    default; git ignores it). Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit():
    """`nvidia-smi --query-gpu=name,power.limit` lines, one per card, or
    None where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_info():
    """Platform, device kind and count as JAX reports them, plus the card
    name and power limit as nvidia-smi reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": gpu_name_and_power_limit()}

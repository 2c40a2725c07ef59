"""The one place that decides which JAX backend the device stages run on.

Every device stage (overlap sweep, k-mer index build, probe join) gets its
`jax` and `jax.numpy` modules from `jax_modules()`, which

  * requires a GPU unless `JAX_PLATFORMS` names a platform explicitly — a
    machine whose CUDA plugin failed to load makes JAX fall back to the CPU
    with only a warning, and the compressor must not silently run its device
    programs there (`JAX_PLATFORMS=cpu` is the opt-in the tests use);
  * turns on 64-bit types (the pg positions and hashes are int64/uint64);
  * points JAX's persistent compilation cache at `cache_dir()`.
"""
from __future__ import annotations

import functools
import os

# fixed in-checkout cache directory (listed in .gitignore): the cache key
# includes the path, so a directory that moves between runs never hits
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _probe() -> str:
    import jax

    return jax.default_backend()


def platform() -> str:
    """The backend the device stages run on; raises when it is not a GPU
    and `JAX_PLATFORMS` did not ask for another platform."""
    got = _probe()
    if os.environ.get("JAX_PLATFORMS"):
        # JAX itself fails at start-up when the requested platform is absent
        return got
    if got != "gpu":
        raise RuntimeError(
            f"no GPU backend (JAX's default backend is {got!r}); set "
            "JAX_PLATFORMS=cpu to run the device stages on the CPU")
    return got


def cache_dir() -> str | None:
    """Directory this program points the compilation cache at: None when
    `JAX_COMPILATION_CACHE_DIR` is set (JAX reads that variable itself),
    else the fixed in-checkout `.jax_cache`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _REPO_CACHE


@functools.cache
def jax_modules():
    """(jax, jax.numpy), configured for the device stages."""
    import jax

    platform()
    jax.config.update("jax_enable_x64", True)
    path = cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    import jax.numpy as jnp

    return jax, jnp


def describe() -> dict:
    """The devices the stages run on, as JAX reports them."""
    jax, _ = jax_modules()
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> str | None:
    """Each card's name and power limit as `nvidia-smi` reports them, read
    by a child process that does not touch JAX; None without nvidia-smi."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip()

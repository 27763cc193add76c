"""Process-level JAX settings shared by the entry points.

- platform(): the default backend's platform name ("cpu" or "gpu"), which
  the kernel dispatchers key on.
- enable_compile_cache(): JAX's persistent compilation cache. When
  JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing is
  changed here; otherwise the cache goes to one fixed directory inside the
  checkout (the path is part of the cache key, so it must not move).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def platform() -> str:
    """Platform of JAX's default device, lower-case ("cpu", "gpu", ...)."""
    import jax
    return jax.devices()[0].platform.lower()


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one per
    line — the label every device timing is reported with."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a stable directory and
    return it: JAX_COMPILATION_CACHE_DIR when set (left to JAX), else
    DEFAULT_CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR

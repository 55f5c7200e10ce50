"""Compile cache and kernel mode, shared by every entry point."""

from __future__ import annotations

import os
from pathlib import Path

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set; otherwise the fixed
    ``<checkout>/.jax_cache`` (the path is part of the cache key, so it
    never moves)."""
    import jax

    cache_dir = os.environ.get(CACHE_ENV) or str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir


def kernel_interpret() -> bool:
    """Whether the Pallas kernels run in interpret mode.

    Only when the caller asked for the CPU with ``JAX_PLATFORMS=cpu``
    (tests, CI). Otherwise the kernels compile for the GPU, and any other
    backend is an error rather than a silent emulation."""
    import jax

    if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        return True
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"no GPU found (JAX backend {backend!r}); set JAX_PLATFORMS=cpu "
            "to run the kernels in interpret mode on the CPU"
        )
    return False


def describe_gpu() -> dict:
    """JAX's view of the devices plus the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    reports them (the limit bounds the clocks under load, so every timing
    is reported beside it)."""
    import subprocess

    import jax

    devices = jax.devices()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": smi[0] if smi else "not available",
    }

"""Process-level JAX set-up shared by the entry points (cli.main,
bench.py, chip_smoke.py): the platform choice and the persistent compile
cache. Nothing here runs at package import; each entry point calls it
once, before its first JAX operation."""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["REPO_CACHE_DIR", "compile_cache_dir", "configure_compile_cache",
           "gpu_name_and_power_limit", "select_platform"]

# fixed, inside the checkout (and listed in .gitignore): the cache key
# includes the path, so a directory that moved would never hit
REPO_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else REPO_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def configure_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and no
    other directory is set here."""
    import jax
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def select_platform(platform: str) -> None:
    """'cpu' pins JAX to the host; 'gpu' requires JAX's default backend
    to be the GPU and raises SystemExit with the reason otherwise (the
    program never falls back to the CPU on its own)."""
    import jax
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return
    if platform != "gpu":
        raise ValueError(f"unknown platform {platform!r}")
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"--platform gpu: JAX finds no GPU (default backend is "
            f"{backend!r}); pass --platform cpu to run on the host")


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    read by a child process that never touches JAX ("" when the tool is
    absent or fails)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""

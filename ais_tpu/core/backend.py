"""Per-platform channelizer formulation and the persistent compile cache.

The polyphase channelizer (ops/fir.py) has two plain-XLA formulations
that compute the same result and differ only in speed: a direct
``einsum`` contraction, or summed per-phase ``fft`` products.  Which one
runs is decided here, from `jax.default_backend()`, and nowhere else.
A platform missing from the table is an error, never a silent default:
a choice made for one machine says nothing about another.

Every other stage has one formulation on every platform.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

_CHANNELIZER = {
    # The faster formulation on XLA's CPU backend.
    "cpu": "einsum",
    # The faster of the two timed at bench geometry on an H100
    # (tools/time_formulations.py; the times are in CHANGES.md).
    "gpu": "fft",
}


def channelizer_method(platform: str | None = None) -> str:
    """The channelizer formulation ("einsum" | "fft") used on `platform`
    (default: the process's JAX backend).  Raises ValueError for a
    platform with no measured choice."""
    name = jax.default_backend() if platform is None else platform
    try:
        return _CHANNELIZER[name]
    except KeyError:
        raise ValueError(
            f"no channelizer formulation for JAX platform {name!r} "
            f"(known: {', '.join(sorted(_CHANNELIZER))})"
        ) from None


# <checkout>/.jax_cache: a fixed path (listed in .gitignore), because the
# cache directory is part of JAX's cache key.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and
    no other directory is set here.  Otherwise the cache lives in
    `DEFAULT_CACHE_DIR`.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        cache_dir = env_dir
    else:
        cache_dir = str(DEFAULT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


def gpu_card() -> str:
    """The card's name and power limit as nvidia-smi reports them
    ("<name>, <limit> W"; several cards joined by "; "), read by a child
    process that does not import JAX; "not available" where nvidia-smi
    is missing or fails."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=30,
            check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return "; ".join(out.stdout.split("\n")).strip("; ") or "not available"

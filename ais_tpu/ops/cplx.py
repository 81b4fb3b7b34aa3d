"""Complex <-> float-plane interop at the host/device boundary.

Every complex value crosses the host/device boundary as float32 planes
(a convention kept from the build's first accelerator; whether complex64
arguments serve as well on the GPU is ROADMAP C4):

  - inputs: numpy complex64 viewed zero-copy as (..., 2) float32
    (`to_planes`), rebuilt on device with `lax.complex` (`from_planes`);
  - constants: baked as two float planes (`const_complex`);
  - outputs: the pipeline already returns only real dtypes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def to_planes(x: np.ndarray) -> np.ndarray:
    """complex64 (..., n) -> float32 (..., n, 2), zero-copy."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(*x.shape, 2)


def from_planes(v: jax.Array) -> jax.Array:
    """float32 (..., 2) -> complex64 (...) on device."""
    return jax.lax.complex(v[..., 0], v[..., 1])


def const_complex(x: np.ndarray) -> jax.Array:
    """Embed a numpy complex array as two float constants + on-device join."""
    x = np.asarray(x, dtype=np.complex64)
    return jax.lax.complex(
        jnp.asarray(x.real.astype(np.float32)),
        jnp.asarray(x.imag.astype(np.float32)),
    )


def as_complex_input(x: jax.Array) -> jax.Array:
    """Accept either complex input or float planes (..., 2)."""
    if jnp.iscomplexobj(x):
        return x
    return from_planes(x)

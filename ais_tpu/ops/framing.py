"""Gather-free overlap-save framing on device.

`x[idx]` with a (blocks, block_len) index matrix is a large gather; the
same framing is two reshapes and a concat: the core parts tile exactly,
and the halo of block b is the head of block b+1's core (plus padding at
the tail).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def slice_last(x, start: int, end: int):
    """x[..., start:end]; a complex slice with a non-zero start is taken
    on the real and imaginary planes separately and recombined."""
    if start == 0 or not jnp.iscomplexobj(x):
        return x[..., start:end]
    return jax.lax.complex(x.real[..., start:end], x.imag[..., start:end])


def frame_overlap_big(x, core: int, halo: int):
    """Like `frame_overlap` but allowing halo >= core: the window is
    assembled from ceil((core+halo)/core) shifted core-grid reshapes
    (still gather-free).  Tail windows zero-fill."""
    n = x.shape[-1]
    if n % core != 0:
        raise ValueError(f"length {n} not a multiple of core {core}")
    n_blocks = n // core
    win = core + halo
    n_seg = -(-win // core)
    lead = x.shape[:-1]
    pad = (n_blocks + n_seg) * core - n
    xp = jnp.concatenate([x, jnp.zeros(lead + (pad,), x.dtype)], axis=-1)
    segs = []
    for j in range(n_seg):
        seg = slice_last(xp, j * core, (n_blocks + j) * core).reshape(
            *lead, n_blocks, core
        )
        segs.append(seg)
    out = jnp.concatenate(segs, axis=-1)
    return out[..., :win]


def frame_overlap(x, core: int, halo: int):
    """(..., n) -> (..., n_blocks, core + halo); block b starts at b*core.

    n must be a multiple of `core` (callers pad);  the final block's halo
    is zero-filled.
    """
    n = x.shape[-1]
    if n % core != 0:
        raise ValueError(f"length {n} not a multiple of core {core}")
    n_blocks = n // core
    lead = x.shape[:-1]
    cores = x.reshape(*lead, n_blocks, core)
    shifted = jnp.concatenate(
        [slice_last(x, core, n), jnp.zeros(lead + (core,), x.dtype)], axis=-1
    ).reshape(*lead, n_blocks, core)
    if halo > core:
        raise ValueError(f"halo {halo} larger than core {core} not supported")
    return jnp.concatenate([cores, shifted[..., :halo]], axis=-1)

"""Sliding-window maximum via logarithmic shift-doubling.

The AGC envelope tracker and the correlator's non-max suppression use
this in place of `lax.reduce_window` (whether the plain form is as fast
on the GPU is ROADMAP C7): a sliding max over a width-w window
decomposes into ceil(log2 w) full-array `maximum` passes, maintaining the
invariant m_s[i] = max x[i .. i+s-1] and combining spans.  Pure
elementwise work, O(n log w), compiles in milliseconds.
"""

from __future__ import annotations

import jax.numpy as jnp


def _shift_left(x, k: int):
    """x shifted left by k along the last axis, right edge replicated."""
    if k == 0:
        return x
    pad = jnp.repeat(x[..., -1:], k, axis=-1)
    return jnp.concatenate([x[..., k:], pad], axis=-1)


def _shift_right(x, k: int):
    if k == 0:
        return x
    pad = jnp.repeat(x[..., :1], k, axis=-1)
    return jnp.concatenate([pad, x[..., :-k]], axis=-1)


def sliding_max_forward(x, window: int):
    """m[i] = max(x[i .. i+window-1]), right edge clamped (shrinking)."""
    m = x
    span = 1
    while span < window:
        step = min(span, window - span)
        m = jnp.maximum(m, _shift_left(m, step))
        span += step
    return m


def sliding_max_centered(x, radius: int):
    """m[i] = max(x[i-radius .. i+radius]), edges clamped."""
    fwd = sliding_max_forward(x, radius + 1)   # max over [i, i+radius]
    bwd = x
    span = 1
    while span < radius + 1:
        step = min(span, radius + 1 - span)
        bwd = jnp.maximum(bwd, _shift_right(bwd, step))
        span += step
    return jnp.maximum(fwd, bwd)

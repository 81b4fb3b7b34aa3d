"""Burst-scoped MSK timing recovery (D'Andrea-Mengali-Reggiannini).

Equivalent of the in-repo `msk_timing_recovery_cc` block
(reference: lib/msk_timing_recovery_cc_impl.cc:107-206) — the one truly
sequential loop in the chain.  The reference runs it free-running over
the whole stream, re-seeded by `time_est` tags at each preamble
(:126-164).  Here the loop only ever runs *per detected burst*: the
correlator seeds it (same coupling, SURVEY.md section 3.3), a bounded
`lax.scan` tracks timing across the <= few-hundred-symbol packet, and
`vmap` batches all bursts of a block onto the VPU in parallel.  Parity
is defined on decoded packets, not on the noise-only samples the
reference also (pointlessly) processes.

Loop semantics mirrored from the reference:
  - runs at 2 samples/symbol: half_sps = sps / 2 (:70);
  - MMSE fractional interpolation at (iidx, mu) (:170);
  - nonlinearity e = Re[y^2 * conj(y_prev)^2 - prev] where y_prev is the
    previous half-symbol interpolant (:170-178);
  - every second iteration: err clipped to +-3, omega += gain^2/4 * err
    with omega clamped to half_sps +- limit, mu += gain * err (:179-184);
  - every other iteration emits one output symbol (:186-191);
  - seed: mu = center from the correlator tag; if mu < 0 then mu += 1,
    start index -= 1 (:148-153).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ais_tpu.ops.interp import NTAPS, interpolate


class TimingResult(NamedTuple):
    symbols: jax.Array     # (n_symbols,) complex64 — 1 sample/symbol
    valid: jax.Array       # (n_symbols,) bool — False past the burst end
    err: jax.Array         # (n_symbols,) float32 — loop error (debug out2)
    mu: jax.Array          # (n_symbols,) float32 — loop mu (debug out3)


def msk_timing_recovery(
    burst: jax.Array,
    mu0: jax.Array,
    sps: float,
    gain: float,
    limit: float,
    n_symbols: int,
    start_index: int = 1,
) -> TimingResult:
    """Recover `n_symbols` symbol-rate samples from one burst window.

    burst: (L,) complex64, starting one sample *before* the seed point so
    the reference's mu<0 adjustment has room.  mu0: correlator's
    center-of-mass fractional offset in (-1, 1).
    """
    length = burst.shape[-1]
    half_sps = jnp.float32(sps / 2.0)
    gain = jnp.float32(gain)
    gain_omega = gain * gain * jnp.float32(0.25)
    limit = jnp.float32(limit)

    neg = mu0 < 0
    mu_init = jnp.where(neg, mu0 + 1.0, mu0).astype(jnp.float32)
    idx_init = jnp.where(neg, start_index - 1, start_index).astype(jnp.int32)

    def step(carry, _):
        iidx, mu, omega, div, prev_y, prev_nlin = carry
        in_range = iidx + NTAPS <= length
        safe_idx = jnp.clip(iidx, 0, length - NTAPS)
        y = interpolate(burst, safe_idx, mu)
        nlin = (y * y) * jnp.conj(prev_y * prev_y)
        err = jnp.real(nlin - prev_nlin)
        odd = (div % 2) == 1
        err_c = jnp.clip(err, -3.0, 3.0)
        omega_upd = half_sps + jnp.clip(omega + gain_omega * err_c - half_sps, -limit, limit)
        omega_new = jnp.where(odd, omega_upd, omega)
        mu_err = jnp.where(odd, mu + gain * err_c, mu)
        emit = jnp.logical_not(odd)
        # advance by omega (half a symbol nominal)
        mu_adv = mu_err + omega_new
        shift = jnp.floor(mu_adv)
        carry_out = (
            iidx + shift.astype(jnp.int32),
            mu_adv - shift,
            omega_new,
            div + 1,
            y,
            nlin,
        )
        return carry_out, (y, emit & in_range, err, mu)

    # Initial carries are derived from the traced inputs (instead of bare
    # literals) so their device-varying types match under shard_map.
    zero_c = burst[0] * 0.0
    init = (
        idx_init,
        mu_init,
        half_sps + mu_init * 0.0,
        jnp.int32(0),
        zero_c,
        zero_c,
    )
    _, (ys, valids, errs, mus) = jax.lax.scan(step, init, None, length=2 * n_symbols)
    # Outputs land on even iterations (div starts at 0).  Deinterleave via
    # reshape + leading index.
    def every_other(a):
        return a.reshape(n_symbols, 2, *a.shape[1:])[:, 0]

    return TimingResult(
        symbols=every_other(ys),
        valid=every_other(valids),
        err=every_other(errs).astype(jnp.float32),
        mu=every_other(mus).astype(jnp.float32),
    )

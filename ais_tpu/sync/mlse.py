"""Coherent MLSE (Viterbi) GMSK demodulation.

The reference *attempted* coherent demodulation and abandoned it — its
own header records why: "no reset input on the gr-trellis VA" and "no
provision for phase estimation" (reference: python/ais_demod.py:8-11);
the vestigial `fsm_utils.py` CPM machinery was left installed but unused.
This module completes that goal the burst-native way, using exactly the
levers the reference lacked:

  - the burst detector gives a per-packet reset point for free;
  - carrier phase is estimated from the known training sequence inside
    the trellis's own signal space;
  - residual carrier frequency is removed per-burst beforehand
    (`sync/feedforward.refine_freq`, ~1 Hz accuracy, so phase drifts
    well under a radian across a packet);
  - the Viterbi recursion itself is a `lax.scan` over a (n_states,)
    path-metric vector with all transition structure as static tables,
    and branch metrics are one (n_sym, sps) x (sps, n_states*2) matmul.

Against the reference's pi/2-discriminator + slicer this is the
classical ~2-3 dB sensitivity improvement for GMSK BT=0.4.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ais_tpu.ops.interp import DELAY, NSTEPS, NTAPS, interp_taps
from ais_tpu.utils.cpm import CpmDecomposition, gmsk_frequency_pulse, make_cpm_signals


class GmskTrellis(NamedTuple):
    n_states: int
    sps: int
    refs_r: np.ndarray       # (n_states*2, sps) Re of conj(reference waveforms)
    refs_i: np.ndarray       # (n_states*2, sps) Im of conj(reference waveforms)
    preds: np.ndarray        # (n_states, 2, 2): incoming (prev_state, symbol)
    train_paths: np.ndarray  # (4, n_train) flat (state*2+sym) genie paths of
                             # the NRZI training pattern at its 4 possible
                             # alignments (the burst detector can lock onto
                             # any lobe of the periodic preamble)
    frame_offset: int        # calibrated modulator-sample offset of interval 0


def _training_levels(n: int = 24) -> np.ndarray:
    from ais_tpu.tx.frame import TRAINING_BITS, nrzi_encode

    return nrzi_encode(TRAINING_BITS[:n], initial_level=1)


@functools.lru_cache(maxsize=4)
def gmsk_trellis(sps: int, bt: float = 0.4) -> GmskTrellis:
    d: CpmDecomposition = make_cpm_signals(
        M=2, h_num=1, h_den=2, sps=sps, pulse=gmsk_frequency_pulse(sps, bt)
    )
    ns = d.n_states
    # Incoming transitions: every state has exactly 2 (binary CPM).
    preds = np.zeros((ns, 2, 2), dtype=np.int32)
    counts = np.zeros(ns, dtype=np.int64)
    for ps in range(ns):
        for sym in range(2):
            nxt = d.next_state[ps, sym]
            preds[nxt, counts[nxt] % 2] = (ps, sym)
            counts[nxt] += 1
    assert (counts == 2).all(), "irregular trellis"

    refs = np.conj(d.signals.reshape(ns * 2, sps))

    # Genie paths of the NRZI'd training sequence (period-4 pattern) at
    # each of its 4 alignments, from state 0.
    levels0 = _training_levels()
    paths = []
    for shift in range(4):
        levels = np.roll(levels0, -shift)
        state = 0
        path = []
        for lv in levels:
            path.append(state * 2 + int(lv))
            state = int(d.next_state[state, int(lv)])
        paths.append(path)
    train_paths = np.asarray(paths, dtype=np.int32)

    # Calibrate the interval grid against this package's modulator: find
    # the sample offset q where the genie-path reference waveforms best
    # match a modulated training burst.
    from ais_tpu.tx.gmsk import modulate_bits

    wf = modulate_bits(np.tile(levels0, 3), sps).astype(np.complex128)
    sigs = d.signals.reshape(ns * 2, sps)
    best_q, best_m = 0, -1.0
    period = 4 * sps  # training pattern period
    for q in range(period):
        acc = 0.0 + 0.0j
        ok = True
        for k in range(8, 8 + 16):
            lo = q + k * sps
            if lo + sps > wf.size:
                ok = False
                break
            r = wf[lo : lo + sps]
            # path index repeats with the pattern period (4 symbols)
            s = sigs[train_paths[0, k % levels0.size]]
            acc += np.vdot(s, r)  # sum conj(s)*r
        if ok and abs(acc) > best_m:
            best_m, best_q = abs(acc), q
    return GmskTrellis(
        n_states=ns,
        sps=sps,
        refs_r=refs.real.astype(np.float32),
        refs_i=refs.imag.astype(np.float32),
        preds=preds,
        train_paths=train_paths,
        frame_offset=best_q,
    )


def mlse_levels(
    frames: jax.Array,
    trellis: GmskTrellis,
    n_train: int = 16,
    train_start: jax.Array | int = 4,
) -> jax.Array:
    """Viterbi-decode NRZI levels (+-1 float) from symbol-interval frames.

    frames: (n_sym, sps) complex64, interval-aligned (see burst_frames).
    Carrier phase is estimated from the training intervals
    [train_start, train_start + n_train) against the genie path.
    """
    n_sym = frames.shape[0]
    ns = trellis.n_states
    fr, fi = frames.real.astype(jnp.float32), frames.imag.astype(jnp.float32)
    rr = jnp.asarray(trellis.refs_r)  # conj already applied
    ri = jnp.asarray(trellis.refs_i)
    # corr[k, b] = sum_t frames[k, t] * conj(s_b[t]) in full float32:
    # a reduced-precision dot (bf16 inputs, or TF32 on a GPU) loses
    # mantissa bits and flips near-tie Viterbi branch decisions.
    hi = jax.lax.Precision.HIGHEST
    cr = jnp.dot(fr, rr.T, precision=hi) - jnp.dot(fi, ri.T, precision=hi)
    ci = jnp.dot(fr, ri.T, precision=hi) + jnp.dot(fi, rr.T, precision=hi)
    # Phase estimate from the training genie paths (accumulated-phase
    # ambiguity of the start state is absorbed here; the detector may lock
    # onto any of the 4 alignments of the periodic training pattern, so
    # all 4 candidate paths compete and the strongest wins).
    idx = jnp.asarray(trellis.train_paths[:, :n_train])  # (4, n_train)
    k = jnp.arange(n_train) + jnp.asarray(train_start, dtype=jnp.int32)
    tr_r = cr[k[None, :], idx].sum(axis=1)  # (4,)
    tr_i = ci[k[None, :], idx].sum(axis=1)
    mag = tr_r * tr_r + tr_i * tr_i
    best = jnp.argmax(mag)
    norm = jnp.sqrt(mag[best]) + 1e-12
    cphi, sphi = tr_r[best] / norm, tr_i[best] / norm
    # metric = Re(corr * e^{-j phi})
    metrics = (cr * cphi + ci * sphi).reshape(n_sym, ns, 2)

    preds = jnp.asarray(trellis.preds)  # (ns, 2, 2)
    ps_idx = preds[..., 0]  # (ns, 2)
    sym_idx = preds[..., 1]

    def step(pm, m_k):
        cand = pm[ps_idx] + m_k[ps_idx, sym_idx]  # (ns, 2)
        choice = jnp.argmax(cand, axis=1)
        return jnp.max(cand, axis=1), choice.astype(jnp.uint8)

    pm0 = jnp.zeros(ns, jnp.float32)
    pm, choices = jax.lax.scan(step, pm0, metrics)  # choices: (n_sym, ns)

    def back(state, ch_k):
        j = ch_k[state]
        ps = ps_idx[state, j]
        sym = sym_idx[state, j]
        return ps, sym

    _, syms_rev = jax.lax.scan(back, jnp.argmax(pm).astype(jnp.int32), choices[::-1])
    syms = syms_rev[::-1]
    return 2.0 * syms.astype(jnp.float32) - 1.0


def burst_frames(
    burst: jax.Array,
    center0: jax.Array,
    sps: int,
    n_symbols: int,
    bt: float = 0.4,
) -> jax.Array:
    """Interval-aligned (n_symbols, sps) frames from a burst.

    `center0` is the feedforward estimator's first symbol-center position
    (samples, fractional).  The trellis's calibrated frame_offset relates
    centers to interval starts.
    """
    tr = gmsk_trellis(sps, bt)
    from ais_tpu.sync.feedforward import _calibrate

    delta = _calibrate(sps, bt)
    # Interval start for the symbol centered at c: c - delta + frame_offset.
    start0 = center0 - delta + tr.frame_offset
    length = burst.shape[-1]
    k = jnp.arange(n_symbols * sps, dtype=jnp.float32)
    pos = start0 + k
    i0 = jnp.floor(pos).astype(jnp.int32)
    mu = pos - i0
    in_range = (i0 - DELAY >= 0) & (i0 - DELAY + NTAPS <= length)
    valid_lo = jnp.clip(i0 - DELAY, 0, length - NTAPS)
    bank = jnp.asarray(interp_taps())
    rows = bank[jnp.clip(jnp.round(mu * NSTEPS).astype(jnp.int32), 0, NSTEPS)]
    fr = burst[valid_lo[:, None] + jnp.arange(NTAPS)[None, :]]
    samples = jnp.sum(fr * rows, axis=-1)
    valid = in_range.reshape(n_symbols, sps).all(axis=-1)
    return samples.reshape(n_symbols, sps), valid

"""Single-stream AIS burst demodulator: complex baseband -> per-burst bits.

The tensor-pipeline equivalent of the reference's `ais_demod` hier block
chain (reference: python/ais_demod.py:56):

  square_and_fft_sync -> feedforward_agc -> corr_est -> msk_timing_recovery
  -> quadrature_demod -> slicer -> diff_decoder -> invert

but instead of a thread-per-block stream graph, one jitted function maps a
halo'd time block `(block_len,)` to a fixed-size table of burst records
(max_bursts x n_symbols bits + metadata).  Burst peaks are only accepted
inside the block core `[0, core_len)`; the halo `[core_len, block_len)`
guarantees every accepted burst's full packet, AGC lookahead, and
correlator lookahead lie inside the block, so consecutive blocks stepped
by `core_len` decode every packet exactly once (overlap-save framing,
SURVEY.md section 5.7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ais_tpu.core.params import BURST_GRID, DemodConfig
from ais_tpu.ops.agc import feedforward_agc
from ais_tpu.ops.demod import quadrature_demod, slice_diff_invert
from ais_tpu.ops.framing import frame_overlap_big
from ais_tpu.ops.freq import square_and_fft_sync
from ais_tpu.sync.corr import autocorr_threshold, detect_bursts, matched_filter
from ais_tpu.sync.feedforward import feedforward_symbols
from ais_tpu.sync.timing import msk_timing_recovery
from ais_tpu.tx.gmsk import preamble_waveform


class BurstRecords(NamedTuple):
    """Fixed-size per-block burst table (the tensor form of the reference's
    corr_start/time_est/phase_est/corr_est stream tags)."""

    position: jax.Array    # (K,) i32 — preamble start sample within block
    center: jax.Array      # (K,) f32 — fractional peak offset in (-1, 1)
    phase: jax.Array       # (K,) f32 — correlator phase at the peak
    mag: jax.Array         # (K,) f32 — |corr|^2 at the peak
    valid: jax.Array       # (K,) bool
    bits: jax.Array        # (K, n_symbols) u8 — NRZI-decoded bits
    bit_valid: jax.Array   # (K, n_symbols) bool
    freq_est: jax.Array    # (n_chunks,) f32 — AFC estimates (debug)
    n_detected: jax.Array  # () i32 — peaks found pre-cap; > K means the
                           # table overflowed (host logs, never silent)
    win_start: jax.Array   # (K,) i32 — block sample index of the burst's
                           # extraction window (bit b sits near
                           # win_start + b*sps): the anchor for per-frame
                           # absolute positioning on host
    rssi: jax.Array        # (K,) f32 — mean PRE-AGC power over the burst
                           # window.  The feedforward AGC normalizes every
                           # burst's envelope before correlation, so
                           # `mag` is amplitude-blind; rssi restores the
                           # received-strength axis (the reference has no
                           # equivalent — its AGC discards it too).  Used
                           # to rank same-payload sightings, e.g. I/Q
                           # image ghosts (pipeline/host.py).


def required_halo(cfg: DemodConfig) -> int:
    """Lookahead a block must carry past its core so any core-start burst
    is fully processable: burst window + correlator preamble + AGC window."""
    preamble_len = int(round(cfg.samples_per_symbol)) * 28
    return cfg.burst_len + max(cfg.agc_window, preamble_len) + 16


def burst_table_geometry(cfg: DemodConfig) -> tuple[int, int]:
    """(win_len, n_symbols) of the per-burst extraction table — the static
    shape of `BurstRecords.bits` rows.  Host-side consumers (the compact
    wire-record unpacker) need n_symbols because the packed bit planes
    round it up to whole bytes."""
    win_len = cfg.burst_len + BURST_GRID
    return win_len, int((win_len - 16) // cfg.samples_per_symbol)


def extract_windows(
    a: jax.Array, win_idx: jax.Array, grid: int, win_len: int
) -> tuple[jax.Array, jax.Array]:
    """Each burst's extraction window, gathered by a one-hot contraction.

    a: (B, block_len) complex64; win_idx: (B, K) int32 window indices on
    the `grid`-sample lattice.  Returns (bursts, onehot): bursts
    (B*K, win_len) complex64 with bursts[b*K + k] = a[b, w*grid :
    w*grid + win_len] (zero past the block end) for w = win_idx[b, k],
    and the (B*K, B*n_win) float32 selection matrix.

    All lattice windows are built gather-free (shifted reshapes) and
    each burst picks its window with a dot against a one-hot row.  The
    dots run at HIGHEST precision, so the selection is exact: a
    reduced-precision (TF32) product would round every sample.  The
    one-hot is (B*K) x (B*n_win), so its cost grows with the square of
    the blocks per call.
    """
    B = a.shape[0]
    n_win = a.shape[-1] // grid
    windows = frame_overlap_big(a, grid, win_len - grid)  # (B, n_win, win_len)
    wr = windows.real.reshape(B * n_win, win_len)
    wi = windows.imag.reshape(B * n_win, win_len)
    flat_widx = (
        win_idx + (jnp.arange(B, dtype=jnp.int32) * n_win)[:, None]
    ).reshape(-1)
    onehot = (
        flat_widx[:, None] == jnp.arange(B * n_win, dtype=jnp.int32)[None, :]
    ).astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    bursts = jax.lax.complex(
        jnp.dot(onehot, wr, preferred_element_type=jnp.float32, precision=hi),
        jnp.dot(onehot, wi, preferred_element_type=jnp.float32, precision=hi),
    )
    return bursts, onehot


def make_burst_demod(cfg: DemodConfig, block_len: int, core_len: int):
    """Build the jittable block demodulator.

    The returned function is *batch-native*: it accepts `(block_len,)` or
    `(n_blocks, block_len)` input and returns BurstRecords with matching
    leading axes.  Internally the sample-rate stages run as batched
    tensor ops and the per-burst stages as ONE flat vmap over all
    (block, burst) lanes — never nested vmaps, which vectorize worse.
    """
    if block_len % cfg.fftlen != 0:
        raise ValueError(f"block_len {block_len} not a multiple of fftlen {cfg.fftlen}")
    if core_len > block_len - required_halo(cfg):
        raise ValueError(
            f"core_len {core_len} leaves less than required halo "
            f"{required_halo(cfg)} in block_len {block_len}"
        )
    if cfg.timing_mode not in ("feedforward", "pll"):
        raise ValueError(f"unknown timing_mode {cfg.timing_mode!r}")
    if cfg.demod_mode not in ("discriminator", "mlse"):
        raise ValueError(f"unknown demod_mode {cfg.demod_mode!r}")
    sps_int = int(round(cfg.samples_per_symbol))
    wf = preamble_waveform(sps_int, cfg.gmsk_bt)
    thresh = autocorr_threshold(wf, cfg.resolved_corr_threshold)
    burst_grid = BURST_GRID
    if block_len % burst_grid != 0:
        raise ValueError(f"block_len {block_len} not a multiple of {burst_grid}")
    win_len, n_sym = burst_table_geometry(cfg)
    fs = cfg.sample_rate

    def demod(x: jax.Array) -> BurstRecords:
        # Accept complex input or float planes (..., 2) (ops/cplx.py).
        if not jnp.iscomplexobj(x):
            from ais_tpu.ops.cplx import from_planes

            x = from_planes(x)
        single = x.ndim == 1
        xb = x[None] if single else x  # (B, block_len)
        B = xb.shape[0]
        K = cfg.max_bursts_per_block

        # AGC first (commutes with the AFC's pure rotation); detection runs
        # on the per-chunk derotated stream like the reference chain, but
        # each *burst* is decoded with one constant frequency correction —
        # the (gated) estimate of the chunk holding its preamble — so a
        # packet straddling a chunk boundary never sees a mid-packet
        # carrier discontinuity (the reference does: python/gmsk_sync.py:26
        # re-rasterizes a new estimate every fftlen samples regardless).
        a = feedforward_agc(xb, cfg.agc_window, cfg.agc_reference)
        y_det, est = square_and_fft_sync(
            a, fs, cfg.bit_rate, cfg.fftlen, gate_ratio=cfg.afc_gate_ratio
        )
        corr = matched_filter(y_det, wf)
        # The CFAR constant tracks the runtime threshold knob upward
        # (set_threshold(huge) must silence detection, CFAR included)
        # but never drops below its calibrated false-alarm base — a low
        # absolute threshold (e.g. the MLSE preset) already lowers the
        # fixed path.
        cfar_k = (
            cfg.corr_cfar_k * max(1.0, cfg.resolved_corr_threshold / 0.9)
            if cfg.corr_cfar_k is not None
            else None
        )
        corr_mag2 = jnp.real(corr) ** 2 + jnp.imag(corr) ** 2
        pos, centers, phases, mags, valid, n_det = jax.vmap(
            lambda c, m: detect_bursts(
                c, thresh, cfg.nms_radius, cfg.max_bursts_per_block, core_len,
                cfar_k=cfar_k, mag2=m,
            )
        )(corr, corr_mag2)  # each (B, K); n_det (B,)

        # Seed timing recovery at peak + mark_delay, with one guard sample
        # for the mu<0 adjustment (reference lib/corr_est_cc_impl.cc:248-253
        # -> lib/msk_timing_recovery_cc_impl.cc:148-153).
        #
        # Burst extraction: starts are quantized to a `grid`-sample
        # lattice and each burst takes its lattice window
        # (`extract_windows`).  The window carries `grid` extra samples
        # so quantization never cuts the packet; the timing estimators
        # locate the burst within it.
        grid = burst_grid
        win_len = cfg.burst_len + grid
        starts = jnp.clip(pos + cfg.corr_mark_delay - 1, 0, block_len - cfg.burst_len)
        win_idx = starts // grid                      # (B, K)
        n_win = block_len // grid
        bursts, onehot_w = extract_windows(a, win_idx, grid, win_len)
        burst_offsets = (starts - win_idx * grid).reshape(B * K)  # in [0, grid)

        # Pre-AGC received power per burst (RSSI): mean |x|^2 over the
        # grid cells the extraction window covers, selected with the same
        # one-hot contraction (gather-free).  Cell sums via cumsum keep
        # this O(n_win) regardless of window length.
        p_cell = (jnp.real(xb) ** 2 + jnp.imag(xb) ** 2).reshape(
            B, n_win, grid
        ).mean(axis=-1)                               # (B, n_win)
        w_cells = win_len // grid
        cs = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.float32), jnp.cumsum(p_cell, axis=-1)], axis=-1
        )                                             # (B, n_win + 1)
        i0 = jnp.arange(n_win, dtype=jnp.int32)
        i1 = jnp.minimum(i0 + w_cells, n_win)
        win_power = (cs[:, i1] - cs[:, i0]) / jnp.maximum(
            (i1 - i0).astype(jnp.float32), 1.0
        )                                             # (B, n_win)
        rssi = jnp.dot(
            onehot_w, win_power.reshape(B * n_win),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(B, K)

        # Per-burst chunk estimate via a one-hot contraction (gather-free).
        # Reference the chunk holding the burst BODY (pos + fftlen/2 is
        # inside even a minimum-length AIS frame, 11 payload bytes ~ 720
        # samples at sps 5): a burst starting in the tail of a chunk
        # leaves that chunk without enough energy for a confident
        # estimate of its own, but the body chunk measures the actual
        # packet carrier.
        chunk_idx = jnp.clip(
            (pos + cfg.fftlen // 2) // cfg.fftlen, 0, est.shape[-1] - 1
        )  # (B, K)
        onehot = (
            chunk_idx[..., None] == jnp.arange(est.shape[-1], dtype=jnp.int32)
        ).astype(jnp.float32)
        burst_freq = jnp.einsum(
            "bkc,bc->bk", onehot, est, precision=jax.lax.Precision.HIGHEST
        ).reshape(B * K)
        k = jnp.arange(win_len, dtype=jnp.float32)
        carrier_phase = (-2.0 * jnp.pi / fs) * burst_freq[:, None] * k[None, :]
        bursts = bursts * jax.lax.complex(
            jnp.cos(carrier_phase), jnp.sin(carrier_phase)
        )

        if cfg.demod_mode == "mlse":
            # Coherent Viterbi path: per-burst fine carrier refinement,
            # tone-phase timing, interval framing, trellis decode.
            from ais_tpu.sync.feedforward import estimate_timing, refine_freq
            from ais_tpu.sync.mlse import burst_frames, gmsk_trellis, mlse_levels

            trellis = gmsk_trellis(sps_int, cfg.gmsk_bt)
            karr = jnp.arange(win_len, dtype=jnp.float32)

            def decode_one(b, off):
                w0 = refine_freq(b, cfg.samples_per_symbol, cfg.ff_seg_len)
                ph = -w0 * karr
                b2 = b * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
                base, intercept, _ = estimate_timing(
                    b2, cfg.samples_per_symbol, bt=cfg.gmsk_bt, seg_len=cfg.ff_seg_len
                )
                fr, v = burst_frames(b2, base + intercept, sps_int, n_sym, cfg.gmsk_bt)
                # Training-sequence phase anchor: the burst's preamble
                # starts `off` samples into its extraction window.
                ts = (off.astype(jnp.float32) / cfg.samples_per_symbol).astype(
                    jnp.int32
                ) + 2
                return mlse_levels(fr, trellis, train_start=ts), v

            levels, sym_valid = jax.vmap(decode_one)(bursts, burst_offsets)
            bits = slice_diff_invert(levels)
        else:
            if cfg.timing_mode == "feedforward":
                symbols, sym_valid = jax.vmap(
                    lambda b: feedforward_symbols(
                        b,
                        cfg.samples_per_symbol,
                        n_sym,
                        bt=cfg.gmsk_bt,
                        seg_len=cfg.ff_seg_len,
                    )
                )(bursts)
            else:  # pll
                tr = jax.vmap(
                    lambda b, m, off: msk_timing_recovery(
                        b,
                        m,
                        cfg.samples_per_symbol,
                        cfg.clockrec_gain,
                        cfg.omega_relative_limit,
                        n_sym,
                        start_index=off + 1,
                    )
                )(bursts, centers.reshape(B * K), burst_offsets)
                symbols, sym_valid = tr.symbols, tr.valid
            soft = quadrature_demod(symbols)
            bits = slice_diff_invert(soft)

        bits = bits.reshape(B, K, n_sym)
        sym_valid = sym_valid.reshape(B, K, n_sym)
        rec = BurstRecords(
            pos, centers, phases, mags, valid, bits, sym_valid, est, n_det,
            (win_idx * grid).astype(jnp.int32), rssi,
        )
        if single:
            rec = jax.tree.map(lambda t: t[0], rec)
        return rec

    return demod


@functools.lru_cache(maxsize=16)
def jit_burst_demod(cfg: DemodConfig, block_len: int, core_len: int):
    """Cached jit of the block demodulator for a given static shape."""
    return jax.jit(make_burst_demod(cfg, block_len, core_len))


def make_debug_taps(cfg: DemodConfig, block_len: int):
    """Intermediate-signal taps for scopes and debugging.

    The reference exposes these as optional block outputs / GUI sinks:
    the raw correlator stream (corr_est's second output,
    lib/corr_est_cc_impl.cc:174-177) and the AFC-corrected signal the
    GRC flowgraph scopes (python/ais.grc QT sinks).  Returns a jittable
    (block_len,) -> dict of named tensors.
    """
    sps_int = int(round(cfg.samples_per_symbol))
    wf = preamble_waveform(sps_int, cfg.gmsk_bt)
    fs = cfg.sample_rate

    def taps(x: jax.Array) -> dict:
        a = feedforward_agc(x, cfg.agc_window, cfg.agc_reference)
        y_det, est = square_and_fft_sync(
            a, fs, cfg.bit_rate, cfg.fftlen, gate_ratio=cfg.afc_gate_ratio
        )
        corr = matched_filter(y_det, wf)
        return {
            "agc": a,
            "derotated": y_det,
            "freq_est_hz": est,
            "corr_mag2": jnp.real(corr) ** 2 + jnp.imag(corr) ** 2,
        }

    return taps


def frame_stream(iq: np.ndarray, block_len: int, core_len: int) -> np.ndarray:
    """Overlap-save framing: (n,) -> (n_blocks, block_len), stepped by
    core_len, zero-padded at the tail.  Block b starts at b * core_len."""
    iq = np.asarray(iq, dtype=np.complex64)
    n = iq.size
    n_blocks = max(1, -(-n // core_len))
    padded = np.zeros(core_len * (n_blocks - 1) + block_len, dtype=np.complex64)
    padded[:n] = iq
    stride = padded.strides[0]
    return np.lib.stride_tricks.as_strided(
        padded, shape=(n_blocks, block_len), strides=(core_len * stride, stride)
    )

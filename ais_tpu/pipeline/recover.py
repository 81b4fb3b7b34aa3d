"""Host-side burst-table overflow recovery.

The device demodulator's burst table is a fixed-size tensor
(`DemodConfig.max_bursts_per_block`); the reference's tag stream is
unbounded — corr_est emits one tag per detection and never drops one
(reference lib/corr_est_cc_impl.cc:250-266).  When a block detects more
peaks than the table holds (`BurstRecords.n_detected > K`) the overflow
is logged, but the packets past the cap were simply dropped — a single
hot block at a busy port lost traffic.

This module closes that gap: the receiver retains each wire step's raw
bytes, and on overflow the host re-channelizes JUST the overflowed
block's raw span and re-demodulates it on the CPU backend with a larger
burst table (tiered powers of two, so the re-demod program compiles
once per tier).  Recovered packets flow through the same per-channel
deduper as the first pass, so already-decoded packets drop out and only
the previously-capped ones survive.

This is deliberately a host-side slow path: overflow means >K
simultaneous bursts in ~34 ms of channel air time — rare even at a busy
port — and the recovery cost is one small CPU demod per overflowed
block, off the device's critical path.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

# Smallest escalated burst-table size; grows by doubling until the
# detection count fits, so the (lru-cached) re-demod program compiles
# once per tier rather than once per overflow count.
_MIN_RECOVER_K = 64
_MAX_RECOVER_K = 1024


def host_iq_from_wire(raw_u8: np.ndarray, fmt: str) -> np.ndarray:
    """Numpy twin of the on-device wire decoders (ops/convert.py):
    uint8 wire bytes -> complex64 IQ.  Bit-exact same mapping."""
    v = np.asarray(raw_u8, dtype=np.uint8)
    if fmt == "ci16":
        s = v.view("<i2").astype(np.float32) * (1.0 / 32768.0)
        return (s[0::2] + 1j * s[1::2]).astype(np.complex64)
    if fmt == "ci8":
        s = v.view(np.int8).astype(np.float32) * (1.0 / 128.0)
        return (s[0::2] + 1j * s[1::2]).astype(np.complex64)
    if fmt == "ci4":
        i = (v.astype(np.int32) >> 4)
        q = (v.astype(np.int32) & 15)
        i = i - 16 * (i >= 8)
        q = q - 16 * (q >= 8)
        return ((i + 1j * q).astype(np.complex64) * np.float32(1.0 / 8.0))
    if fmt == "ci2":
        from ais_tpu.ops.convert import CI2_INNER, CI2_OUTER

        f = [(v.astype(np.int32) >> s) & 3 for s in (6, 4, 2, 0)]  # I0 Q0 I1 Q1
        re = np.stack([f[0], f[2]], axis=-1).reshape(-1)
        im = np.stack([f[1], f[3]], axis=-1).reshape(-1)

        def dec(c):
            m = c.astype(np.float32) - 1.5
            return np.sign(m) * np.where(np.abs(m) > 1.0, CI2_OUTER, CI2_INNER)

        return (dec(re) + 1j * dec(im)).astype(np.complex64)
    if fmt == "ci1":
        f = [(v.astype(np.int32) >> s) & 1 for s in (7, 5, 3, 1)]
        g = [(v.astype(np.int32) >> s) & 1 for s in (6, 4, 2, 0)]
        re = np.stack(f, axis=-1).reshape(-1).astype(np.float32) * 2.0 - 1.0
        im = np.stack(g, axis=-1).reshape(-1).astype(np.float32) * 2.0 - 1.0
        return (re + 1j * im).astype(np.complex64)
    if fmt == "cr1":
        # 1-bit fs/4-IF real stream -> baseband complex (the numpy twin
        # of ops/convert.py:iq_from_bytes_cr1): bits to ±1, then
        # multiply by (-j)^n.
        r = np.unpackbits(v).astype(np.float32) * 2.0 - 1.0
        re = np.zeros(r.size, np.float32)
        im = np.zeros(r.size, np.float32)
        re[0::4] = r[0::4]
        im[1::4] = -r[1::4]
        re[2::4] = -r[2::4]
        im[3::4] = r[3::4]
        return (re + 1j * im).astype(np.complex64)
    if fmt == "cd1":
        # Delta-coded I/Q bit planes (ops/convert.py:ci1_from_bytes_cd1);
        # undo the deltas in numpy, then decode as ci1.
        nb = v.size // 2
        n_samples = nb * 8  # may include <=4 pad samples; trim below

        def undelta(plane):
            d = np.unpackbits(plane)
            return np.bitwise_xor.accumulate(d)

        i_bits, q_bits = undelta(v[:nb]), undelta(v[nb:])
        inter = np.empty(2 * n_samples, np.uint8)
        inter[0::2], inter[1::2] = i_bits, q_bits
        ci1 = np.packbits(inter)
        # The planes carry ceil(n/8)*8 bit slots; the trailing pad (if
        # n % 8 == 4) decodes to 4 extra samples the caller's n_in
        # framing ignores — return them, the slicing is positional.
        return host_iq_from_wire(ci1, "ci1")
    if fmt == "cu8":
        s = (v.astype(np.float32) - 127.5) * (1.0 / 127.5)
        return (s[0::2] + 1j * s[1::2]).astype(np.complex64)
    raise ValueError(f"unsupported wire format {fmt!r}")


def host_channelize_span(
    iq: np.ndarray,
    taps: np.ndarray,
    offset_hz: float,
    rate: float,
    decim: int,
    abs_start: int,
) -> np.ndarray:
    """Mix `iq` down by offset_hz (carrier phased at absolute raw index
    `abs_start`, same convention as ops/fir.py:mixer_phase), correlate
    with `taps`, decimate.  out[j] = sum_k taps[k] * mixed[j*decim + k],
    matching the device channelizer's VALID geometry exactly.  Computed
    in float64 NumPy (complex128 out): the plain reference the device
    channelizer is compared with."""
    n = np.arange(abs_start, abs_start + iq.size, dtype=np.float64)
    mixed = np.asarray(iq, np.complex128) * np.exp(
        -2j * np.pi * (offset_hz / rate) * n
    )
    L = taps.size
    nfft = 1 << int(iq.size + L - 1).bit_length()
    # Correlation via convolution with reversed taps: full[j + L - 1]
    # = sum_k taps[k] * mixed[j + k].
    full = np.fft.ifft(
        np.fft.fft(mixed, nfft) * np.fft.fft(taps[::-1].astype(np.float64), nfft)
    )
    n_out = (iq.size - L) // decim + 1
    return full[L - 1 : L - 1 + (n_out - 1) * decim + 1 : decim]


def _recover_demod(demod_cfg, block_len: int, core_len: int, n_detected: int):
    """The escalated-table re-demod callable (compiled for CPU).

    Recovery runs under jax.default_device(cpu) while
    jax.default_backend() may report the accelerator; the burst demod
    has one formulation on every platform, so it compiles for the CPU
    unchanged."""
    from ais_tpu.pipeline.receiver import jit_burst_demod

    k2 = _MIN_RECOVER_K
    while k2 < n_detected and k2 < _MAX_RECOVER_K:
        k2 *= 2
    cfg2 = dataclasses.replace(demod_cfg, max_bursts_per_block=k2)
    return jit_burst_demod(cfg2, block_len, core_len), cfg2


def recover_overflow_packets(
    iq_raw: np.ndarray,
    abs_raw_start: int,
    cfg,
    overflowed,
    dedupers,
    stats: dict | None = None,
) -> list:
    """Re-demodulate overflowed blocks with a larger burst table.

    iq_raw: the step's full raw capture (n_in complex64 samples);
    abs_raw_start: absolute raw index of iq_raw[0]; cfg: WidebandConfig;
    overflowed: iterable of (channel, block, n_detected); dedupers: the
    receiver's per-channel PacketDeduper list (already primed with the
    first pass, so duplicates self-suppress); stats: optional counters
    ("recovered_blocks", "unrecovered_blocks") incremented per block.
    Returns newly recovered DecodedPackets.
    """
    import jax
    import jax.numpy as jnp

    from ais_tpu.ops.cplx import to_planes
    from ais_tpu.ops.firdes import low_pass
    from ais_tpu.pipeline.host import decode_block_records

    log = logging.getLogger("ais_tpu")
    taps = low_pass(1.0, cfg.input_rate, cfg.cutoff_hz, cfg.transition_hz)
    demod_cfg = dataclasses.replace(
        cfg.demod, samples_per_symbol=cfg.sps
    )
    block_len = cfg.block_len
    core_len = cfg.core_len
    overflowed = list(overflowed)
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        log.error(
            "overflow recovery impossible: no CPU backend available; "
            "%d overflowed block(s) keep only their first-pass packets",
            len(overflowed),
        )
        if stats is not None:
            stats["unrecovered_blocks"] += len(overflowed)
        return []
    packets = []
    for c, b, n_det in overflowed:
        i0 = b * core_len * cfg.decimation
        span = iq_raw[i0 : i0 + (block_len - 1) * cfg.decimation + taps.size]
        chan = host_channelize_span(
            span,
            taps,
            cfg.offsets_hz[c],
            cfg.input_rate,
            cfg.decimation,
            abs_raw_start + i0,
        )
        fn, cfg2 = _recover_demod(demod_cfg, block_len, core_len, int(n_det))
        if n_det > cfg2.max_bursts_per_block:
            log.warning(
                "overflow recovery: %d detections exceed even the escalated "
                "table (%d); recovering the first %d",
                int(n_det), cfg2.max_bursts_per_block, cfg2.max_bursts_per_block,
            )
        with jax.default_device(cpu):
            rec = fn(jnp.asarray(to_planes(chan)))
            rec_np = jax.tree.map(np.asarray, rec)
        recovered = decode_block_records(
            rec_np,
            abs_raw_start // cfg.decimation + b * core_len,
            designator=cfg.designators[c],
            deduper=dedupers[c] if dedupers is not None else None,
            fftlen=demod_cfg.fftlen,
            samples_per_symbol=cfg.sps,
        )
        log.info(
            "overflow recovery: block (chan %d, block %d) re-demodulated "
            "with table %d -> %d additional packets",
            c, b, cfg2.max_bursts_per_block, len(recovered),
        )
        packets.extend(recovered)
        if stats is not None:
            stats["recovered_blocks"] += 1
    return packets

"""Fused wideband pipeline: one jitted program from wideband IQ to bursts.

The performance path: XLA programs on the device channelize a wideband
capture to both AIS channels, frame the channel streams into
overlap-save blocks on device, and run the batched burst demodulator —
no host round-trips between stages, and the intermediates stay in
device memory.

Equivalent reference topology: two `ais_rx` chains hanging off one
source (python/radio.py:86-91), each a dozen threads; here it is one
tensor program.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ais_tpu.core.params import AIS_BIT_RATE, DeframerConfig, DemodConfig
from ais_tpu.ops.firdes import low_pass
from ais_tpu.ops.fir import freq_xlating_fir_decimate, mixer_phase
from ais_tpu.ops.framing import frame_overlap
from ais_tpu.pipeline.receiver import (
    BurstRecords,
    burst_table_geometry,
    make_burst_demod,
    required_halo,
)


class WidebandConfig(NamedTuple):
    input_rate: float = 2.4e6
    offsets_hz: tuple = (-25e3, +25e3)   # channel A, B around 162.0 MHz
    designators: tuple = ("A", "B")
    decimation: int = 50
    cutoff_hz: float = 11e3
    transition_hz: float = 2e3           # wideband design: fewer taps than
                                         # the reference's 1 kHz at 250 ksps
    block_len: int = 16384               # demod block at channel rate
    demod: DemodConfig = DemodConfig()
    # HDLC deframer bounds for the host back half (reference:
    # python/radio.py:64 — (11, 64); long-frame GRC variant (11, 1000),
    # python/ais.grc:1229).  max_length_bytes beyond
    # demod.max_frame_bytes is rejected at receiver construction: the
    # device extraction window would truncate such frames silently.
    deframer: DeframerConfig = DeframerConfig()
    # Drop cross-channel I/Q-image ghosts (same payload, same instant,
    # other channel, >=6 dB weaker pre-AGC power — see
    # pipeline/host.py:suppress_image_ghosts).  False restores the
    # reference behavior (it prints the ghost too).
    image_reject: bool = True
    # When a block's burst table caps out (n_detected > K), re-demod
    # that block host-side with a larger table (pipeline/recover.py) so
    # no detection is dropped — matching the reference's unbounded tag
    # stream (lib/corr_est_cc_impl.cc:250-266).  False logs only.
    overflow_recovery: bool = True
    # Valid-lane d2h compaction (0 = off): the burst table is sized for
    # the per-block worst case (K lanes per (channel, block)) but at
    # full TDMA load only ~40-50% of lanes are ever valid — the rest
    # would ship ~140 bytes each of zeros to the host.  With
    # compact_lanes=L the device gathers valid lanes to the front
    # (top_k + one-hot contraction — static shapes, see
    # pack_wire_compact) and ships only L lanes plus a lane directory;
    # a step with more than L valid lanes degrades to host-side block
    # re-demod through the overflow-recovery path, never loss.
    compact_lanes: int = 0

    @property
    def channel_rate(self) -> float:
        return self.input_rate / self.decimation

    @property
    def sps(self) -> float:
        return self.channel_rate / AIS_BIT_RATE

    @property
    def core_len(self) -> int:
        return self.block_len - required_halo(self.demod)


class WireRecords(NamedTuple):
    """Compact device->host record layout for the wire (streaming) path.

    `BurstRecords` is the right on-device working set but a poor d2h
    payload: ten leaves (ten transfers) of which two are
    `(C, B, K, n_sym)` byte planes — ~2.5 MB per call at full burst
    capacity.  WireRecords coalesces everything
    the host back half consumes into THREE dense tensors and packs the
    bit planes 8x (MSB-first, `np.unpackbits`-compatible), cutting the
    fetch to ~0.2 MB and three round trips.  The AFC chunk estimate is
    resolved to a per-burst frequency on device (the same one-hot lookup
    the demodulator applies), so the host never needs the chunk table.
    """

    meta_i: jax.Array  # (C, B, K, 4|6) i32: position, win_start, valid,
                       #   n_detected (broadcast per block); with
                       #   valid_as_run two more: bit_valid run
                       #   (first, count)
    meta_f: jax.Array  # (C, B, K, 3) f32: corr mag^2, freq_est_hz,
                       #   pre-AGC rssi (mean |x|^2 over the burst window)
    packed: jax.Array  # (C, B, K, 2, ceil(n_sym/8)) u8: [0] bits,
                       #   [1] bit_valid, MSB-first within each byte —
                       #   or (C, B, K, 1, n_pack) bits only when the
                       #   valid mask rides in meta_i (valid_as_run)


def pack_wire_records(
    rec: BurstRecords, fftlen: int, valid_as_run: bool = False
) -> WireRecords:
    """Device-side compaction of BurstRecords (leading dims preserved).

    With `valid_as_run`, the bit_valid plane is replaced by two int32
    meta columns `(first, count)`: every demod mode derives sym_valid
    from monotonically-advancing symbol positions tested against the
    window bounds (sync/feedforward.py:228, sync/timing.py:38,
    sync/mlse.py:219), so the mask is a contiguous run by construction
    and the run form is LOSSLESS.  It halves the packed payload."""
    n_sym = rec.bits.shape[-1]
    n_pack = -(-n_sym // 8)
    pad = n_pack * 8 - n_sym
    weights = jnp.array([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)

    def pack(plane):
        x = plane.astype(jnp.int32)
        if pad:
            x = jnp.concatenate(
                [x, jnp.zeros((*x.shape[:-1], pad), jnp.int32)], axis=-1
            )
        x = x.reshape(*x.shape[:-1], n_pack, 8)
        # Minor-axis (len 8) weighted reduce: backend-safe (ARCH §4).
        return jnp.sum(x * weights, axis=-1).astype(jnp.uint8)

    if valid_as_run:
        packed = pack(rec.bits)[..., None, :]  # (..., 1, n_pack)
    else:
        packed = jnp.stack([pack(rec.bits), pack(rec.bit_valid)], axis=-2)
    n_chunks = rec.freq_est.shape[-1]
    chunk = jnp.clip(rec.position // fftlen, 0, n_chunks - 1)  # (..., K)
    onehot = (
        chunk[..., None] == jnp.arange(n_chunks, dtype=jnp.int32)
    ).astype(jnp.float32)
    freq = jnp.sum(onehot * rec.freq_est[..., None, :], axis=-1)
    cols = [
        rec.position,
        rec.win_start,
        rec.valid.astype(jnp.int32),
        jnp.broadcast_to(rec.n_detected[..., None], rec.position.shape).astype(
            jnp.int32
        ),
    ]
    if valid_as_run:
        bv = rec.bit_valid.astype(jnp.int32)
        cols.append(jnp.argmax(bv, axis=-1).astype(jnp.int32))  # first (0 if none)
        cols.append(jnp.sum(bv, axis=-1))                       # count
    meta_i = jnp.stack(cols, axis=-1)
    meta_f = jnp.stack([rec.mag, freq, rec.rssi], axis=-1)
    return WireRecords(meta_i, meta_f, packed)


def le4_bytes(x_i32: jax.Array) -> jax.Array:
    """int32 -> 4 little-endian uint8 bytes along a new minor axis.

    Arithmetic >> then &255 extracts exact two's-complement bytes — the
    load-bearing property for round-tripping meta over the d2h wire.
    ONE definition for every packer (pack_wire_flat, pack_wire_compact,
    the distributed record gather)."""
    return jnp.stack(
        [(x_i32 >> s) & 255 for s in (0, 8, 16, 24)], axis=-1
    ).astype(jnp.uint8)


def pack_wire_flat(rec: BurstRecords, fftlen: int) -> jax.Array:
    """Coalesce WireRecords into ONE 1-D uint8 buffer (device side).

    Three record tensors would be three d2h transfers.  Decomposing the
    int32/float32
    meta into little-endian bytes on device (shift+mask; float32 via a
    same-width bitcast) and concatenating with the packed bit plane
    makes the whole fetch a single transfer.  The bit_valid plane rides
    as a (first, count) run in meta_i (lossless — see
    pack_wire_records); unpack_wire_flat rebuilds the plane host-side
    so every consumer of the 2-plane layout is unchanged.  Layout:
      [meta_i as (C*B*K*6) le-i32 bytes][meta_f as (C*B*K*3) le-f32
      bytes][bits plane (C*B*K*n_pack)].
    """
    w = pack_wire_records(rec, fftlen, valid_as_run=True)
    bi = le4_bytes(w.meta_i)
    bf = le4_bytes(jax.lax.bitcast_convert_type(w.meta_f, jnp.int32))
    return jnp.concatenate([bi.ravel(), bf.ravel(), w.packed.ravel()])


def unpack_wire_flat(
    buf: np.ndarray, C: int, B: int, K: int, n_pack: int
) -> WireRecords:
    """Host-side inverse of `pack_wire_flat`.

    Rebuilds the bit_valid plane from its (first, count) run columns
    (vectorized packbits over ~0.35 MB of bools, ~1 ms) and returns the
    standard 2-plane WireRecords, so decode_wire_records and the native
    batched deframer read the same layout as always."""
    buf = np.asarray(buf, dtype=np.uint8)
    ni = C * B * K * 6 * 4
    nf = C * B * K * 3 * 4
    meta_i = np.frombuffer(buf[:ni].tobytes(), "<i4").reshape(C, B, K, 6)
    meta_f = np.frombuffer(buf[ni : ni + nf].tobytes(), "<f4").reshape(C, B, K, 3)
    bits = buf[ni + nf :].reshape(C, B, K, 1, n_pack)
    first = meta_i[..., 4:5]                      # (C, B, K, 1)
    count = meta_i[..., 5:6]
    idx = np.arange(n_pack * 8, dtype=np.int32)
    mask = (idx >= first) & (idx < first + count)  # (C, B, K, n_pack*8)
    vplane = np.packbits(mask, axis=-1).reshape(C, B, K, 1, n_pack)
    return WireRecords(meta_i, meta_f, np.concatenate([bits, vplane], axis=-2))


def pack_wire_compact(rec: BurstRecords, fftlen: int, l_max: int) -> jax.Array:
    """Valid-lane-compacted d2h payload (device side; static shapes).

    `pack_wire_flat` ships every one of the C*B*K burst-table lanes even
    though full TDMA load leaves most invalid — at the bench geometry
    that is ~0.46 MB/step.  Here the device gathers the VALID lanes to
    the front and ships only `l_max` of them plus a lane directory:

      - lane order: `top_k` over ``valid * 2N - lane_index`` — valid
        lanes first, each group in ascending lane order (top_k is
        already on the hot path in burst NMS; no sort lowering issues),
      - the gather is a one-hot contraction over the per-lane byte rows
        at HIGHEST precision — exact, since every row byte <= 255 is
        integer-representable and each one-hot row selects one lane,
      - per-lane row: pos i32, win_start i32, bit_valid run (first u16,
        count u16), [mag, freq, rssi] f32, packed bits — 24 + n_pack
        bytes (~139 at the bench geometry vs ~151 uncompacted),
      - per-(channel, block) n_detected and n_valid arrays ride in full
        so the host can detect BOTH table overflow (n_detected > K) and
        directory overflow (more than l_max valid lanes in the step —
        the affected blocks are re-demodulated host-side through the
        same overflow-recovery path; degradation is latency, not loss).

    Layout (all little-endian):
      [header: total_valid, l_max, n_lanes, row_bytes — 4x i32]
      [n_detected (C*B) i32][n_valid (C*B) i32]
      [directory (l_max) i32 flat lane ids][rows (l_max, row_bytes) u8]
    """
    w = pack_wire_records(rec, fftlen, valid_as_run=True)
    C, B, K = w.meta_i.shape[:3]
    n_lanes = C * B * K
    n_pack = w.packed.shape[-1]
    l_max = min(int(l_max), n_lanes)
    row_bytes = 24 + n_pack
    le4 = le4_bytes

    def le2(x_i32):
        return jnp.stack([x_i32 & 255, (x_i32 >> 8) & 255], axis=-1).astype(
            jnp.uint8
        )

    mi = w.meta_i.reshape(n_lanes, 6)
    mf = jax.lax.bitcast_convert_type(
        w.meta_f.reshape(n_lanes, 3), jnp.int32
    )
    rows = jnp.concatenate(
        [
            le4(mi[:, 0]),                      # position
            le4(mi[:, 1]),                      # win_start
            le2(mi[:, 4]),                      # bit_valid run first
            le2(mi[:, 5]),                      # bit_valid run count
            le4(mf).reshape(n_lanes, 12),       # mag, freq, rssi
            w.packed.reshape(n_lanes, n_pack),  # packed bits
        ],
        axis=1,
    )
    valid = mi[:, 2]
    key = valid * jnp.int32(2 * n_lanes) - jnp.arange(
        n_lanes, dtype=jnp.int32
    )
    _, idx = jax.lax.top_k(key, l_max)
    onehot = (
        idx[:, None] == jnp.arange(n_lanes, dtype=jnp.int32)
    ).astype(jnp.float32)
    sel = jnp.matmul(
        onehot,
        rows.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    sel = jnp.round(sel).astype(jnp.uint8)
    n_valid_blk = jnp.sum(
        w.meta_i[..., 2].reshape(C * B, K).astype(jnp.int32), axis=-1
    )
    header = jnp.stack(
        [
            jnp.sum(valid).astype(jnp.int32),
            jnp.int32(l_max),
            jnp.int32(n_lanes),
            jnp.int32(row_bytes),
        ]
    )
    n_det = rec.n_detected.reshape(C * B).astype(jnp.int32)
    return jnp.concatenate(
        [
            le4(header).ravel(),
            le4(n_det).ravel(),
            le4(n_valid_blk).ravel(),
            le4(idx).ravel(),
            sel.ravel(),
        ]
    )


def unpack_wire_compact(
    buf: np.ndarray, C: int, B: int, K: int, n_pack: int
) -> tuple[WireRecords, list]:
    """Host-side inverse of `pack_wire_compact`.

    Scatters the shipped lanes back into the standard dense (C, B, K)
    WireRecords layout (invalid lanes zero — the host back half only
    reads valid lanes plus the n_detected column, which is rebuilt from
    the per-block array) and rebuilds the bit_valid plane from its
    (first, count) run.  Returns (records, dropped): `dropped` lists
    (channel, block, n_detected) for blocks whose valid lanes exceeded
    the directory bound and must be re-demodulated host-side."""
    buf = np.asarray(buf, dtype=np.uint8)
    total_valid, l_max, n_lanes, row_bytes = (
        int(v) for v in np.frombuffer(buf[:16].tobytes(), "<i4")
    )
    if n_lanes != C * B * K or row_bytes != 24 + n_pack:
        raise ValueError(
            f"compact wire geometry mismatch: buffer says "
            f"{n_lanes} lanes / {row_bytes} B rows, receiver expects "
            f"{C * B * K} / {24 + n_pack}"
        )
    off = 16
    n_det = np.frombuffer(buf[off : off + 4 * C * B].tobytes(), "<i4")
    n_det = n_det.reshape(C, B)
    off += 4 * C * B
    n_valid_blk = np.frombuffer(
        buf[off : off + 4 * C * B].tobytes(), "<i4"
    ).reshape(C, B)
    off += 4 * C * B
    dirs = np.frombuffer(buf[off : off + 4 * l_max].tobytes(), "<i4")
    off += 4 * l_max
    rows = buf[off : off + l_max * row_bytes].reshape(l_max, row_bytes)

    nv = min(total_valid, l_max)
    d, r = dirs[:nv], rows[:nv]
    meta_i = np.zeros((C * B * K, 6), np.int32)
    meta_f = np.zeros((C * B * K, 3), np.float32)
    bits = np.zeros((C * B * K, n_pack), np.uint8)
    meta_i[d, 0] = np.frombuffer(r[:, 0:4].tobytes(), "<i4")
    meta_i[d, 1] = np.frombuffer(r[:, 4:8].tobytes(), "<i4")
    meta_i[d, 2] = 1
    meta_i[d, 4] = np.frombuffer(r[:, 8:10].tobytes(), "<u2")
    meta_i[d, 5] = np.frombuffer(r[:, 10:12].tobytes(), "<u2")
    meta_f[d] = np.frombuffer(r[:, 12:24].tobytes(), "<f4").reshape(nv, 3)
    bits[d] = r[:, 24 : 24 + n_pack]
    meta_i = meta_i.reshape(C, B, K, 6)
    meta_i[..., 3] = n_det[..., None]
    first = meta_i[..., 4:5]
    count = meta_i[..., 5:6]
    idx = np.arange(n_pack * 8, dtype=np.int32)
    mask = (idx >= first) & (idx < first + count)
    vplane = np.packbits(mask, axis=-1).reshape(C, B, K, 1, n_pack)
    packed = np.concatenate(
        [bits.reshape(C, B, K, 1, n_pack), vplane], axis=-2
    )
    dropped = []
    if total_valid > l_max:
        got = meta_i[..., 2].sum(axis=-1)  # (C, B) lanes that made it
        for c, b in zip(*np.nonzero(got < n_valid_blk)):
            dropped.append(
                (int(c), int(b), int(max(n_det[c, b], n_valid_blk[c, b])))
            )
    return (
        WireRecords(meta_i, np.asarray(meta_f).reshape(C, B, K, 3), packed),
        dropped,
    )


def channelizer_buffers(cfg: WidebandConfig, n_in: int):
    """Device-buffer pair (carriers, hf) for `channelize`: the
    full-length mixer-carrier planes and the polyphase tap spectra."""
    from ais_tpu.ops.cplx import to_planes
    from ais_tpu.ops.fir import _mixer_carrier, polyphase_spectra

    taps = low_pass(1.0, cfg.input_rate, cfg.cutoff_hz, cfg.transition_hz)
    n_out = (n_in - taps.size) // cfg.decimation + 1
    return (
        to_planes(
            np.concatenate(
                [_mixer_carrier(off, cfg.input_rate, n_in) for off in cfg.offsets_hz]
            )
        ),
        to_planes(polyphase_spectra(taps, cfg.decimation, n_out)),
    )


def make_wideband_fns(cfg: WidebandConfig, n_in: int):
    """Build the two jittable halves of the wideband pipeline.

    Returns (channelize_fn, demod_fn):
      channelize_fn(x, phase0s, carriers, hf) -> (n_chan, n48) channels
      demod_fn(chans) -> BurstRecords with leading (n_chan, n_blocks)

    `carriers`/`hf` are the buffers from `channelizer_buffers`.  The
    halves compile as separate programs; the intermediate stays on
    device.
    """
    import dataclasses

    demod_cfg = dataclasses.replace(cfg.demod, samples_per_symbol=cfg.sps)
    taps = low_pass(1.0, cfg.input_rate, cfg.cutoff_hz, cfg.transition_hz)
    n_chan, n_blocks, core_len = wideband_geometry(cfg, n_in)
    block_demod = make_burst_demod(demod_cfg, cfg.block_len, core_len)
    halo = cfg.block_len - core_len

    def channelize(
        x: jax.Array, phase0s: jax.Array, carriers: jax.Array, hf: jax.Array
    ) -> jax.Array:
        # One fused batched mixer+polyphase pass (mixing folded into the
        # polyphase layout; tap spectra and carriers ride in as device
        # buffers).
        from ais_tpu.ops.fir import freq_xlating_polyphase

        return freq_xlating_polyphase(
            x, carriers, phase0s, taps, cfg.decimation, hf
        )

    def demod(chans: jax.Array) -> BurstRecords:
        # Gather-free overlap framing into demod blocks.
        pad = (n_blocks + 1) * core_len - chans.shape[-1]
        if pad > 0:
            chans = jnp.concatenate(
                [chans, jnp.zeros((n_chan, pad), chans.dtype)], axis=-1
            )
        blocks = frame_overlap(
            chans[..., : (n_blocks + 1) * core_len], core_len, halo
        )[..., :n_blocks, : cfg.block_len]
        # Flatten (channel, block) to one batch axis: the demodulator is
        # batch-native and a single flat batch vectorizes best.
        flat = blocks.reshape(n_chan * n_blocks, cfg.block_len)
        rec = block_demod(flat)  # batch-native
        return jax.tree.map(
            lambda a: a.reshape(n_chan, n_blocks, *a.shape[1:]), rec
        )

    return channelize, demod


def make_wideband_demod(cfg: WidebandConfig, n_in: int):
    """Single-function variant (CPU-friendly); composes the two halves."""
    channelize, demod = make_wideband_fns(cfg, n_in)

    def pipeline(x, phase0s, carriers, hf) -> BurstRecords:
        return demod(channelize(x, phase0s, carriers, hf))

    return pipeline


def wire_converter(fmt: str, n_in: int):
    """(convert, n_bytes) for one `n_in`-sample step in wire format `fmt`:
    `convert` maps the step's uint8 wire bytes to complex64 (n_in,) on
    device (ops/convert.py); `n_bytes` is the step's wire size."""
    from ais_tpu.ops.convert import (
        cd1_wire_nbytes,
        cr1_wire_nbytes,
        iq_from_bytes_cd1,
        iq_from_bytes_ci1,
        iq_from_bytes_ci2,
        iq_from_bytes_ci4,
        iq_from_bytes_ci8,
        iq_from_bytes_ci16,
        iq_from_bytes_cr1,
    )

    if fmt == "cd1":
        # Entropy-shaped ci1 (delta-coded I/Q bit planes, same byte
        # count): a cheap on-device pre-decode reconstructs the ci1
        # bytes, then the standard ci1 decode runs.  ops/convert.py
        # ci1_from_bytes_cd1 for why this helps on compressing
        # transports.
        return (lambda raw: iq_from_bytes_cd1(raw, n_in)), cd1_wire_nbytes(n_in)
    if fmt == "cr1":
        # 1 bit per complex sample (fs/4-IF bandpass sigma-delta): HALF
        # the ci1 wire bytes.  The device decode downconverts back to
        # baseband, so the standard channelizer consumes it directly.
        return (lambda raw: iq_from_bytes_cr1(raw, n_in)), cr1_wire_nbytes(n_in)
    # fmt -> (converter, wire bytes per sample as num/den).  ci4/ci2/ci1
    # are the packed formats for bandwidth-bound ingest links (ci1 is
    # sigma-delta encoded, 4 samples/byte).
    table = {
        "ci16": (iq_from_bytes_ci16, 4, 1),
        "ci8": (iq_from_bytes_ci8, 2, 1),
        "ci4": (iq_from_bytes_ci4, 1, 1),
        "ci2": (iq_from_bytes_ci2, 1, 2),
        "ci1": (iq_from_bytes_ci1, 1, 4),
    }
    if fmt not in table:
        raise ValueError(f"unsupported wire format {fmt!r}")
    conv, num, den = table[fmt]
    return conv, n_in * num // den


def wideband_geometry(cfg: WidebandConfig, n_in: int) -> tuple[int, int, int]:
    """(n_channels, n_blocks, core_len) for an input of n_in raw samples."""
    taps = num_taps(cfg)
    n48 = (n_in - taps) // cfg.decimation + 1
    core_len = cfg.core_len
    n_blocks = max(0, (n48 - cfg.block_len) // core_len + 1)
    if n_blocks == 0:
        raise ValueError(
            f"n_in {n_in} too short: yields {n48} channel samples < "
            f"block_len {cfg.block_len}"
        )
    return len(cfg.offsets_hz), n_blocks, core_len


@functools.lru_cache(maxsize=8)
def num_taps(cfg: WidebandConfig) -> int:
    return int(
        low_pass(1.0, cfg.input_rate, cfg.cutoff_hz, cfg.transition_hz).size
    )


class WidebandReceiver:
    """Streaming host wrapper around the fused wideband pipeline."""

    def __init__(self, cfg: WidebandConfig = WidebandConfig(), n_in: int | None = None):
        if cfg.deframer.max_length_bytes > cfg.demod.max_frame_bytes:
            raise ValueError(
                f"deframer.max_length_bytes={cfg.deframer.max_length_bytes} "
                f"exceeds the demod window's frame capacity "
                f"({cfg.demod.max_frame_bytes} bytes at burst_len="
                f"{cfg.demod.burst_len}) — the device extraction window "
                f"would truncate long frames before the deframer saw "
                f"them.  Scale the demod with ais_tpu.core.params."
                f"demod_for_max_frame({cfg.deframer.max_length_bytes}) and "
                f"raise block_len above burst_len + halo."
            )
        self.cfg = cfg
        # Default: ~64 demod blocks per device call.
        if n_in is None:
            core48 = cfg.core_len
            n48 = cfg.block_len + core48 * 63
            n_in = (n48 - 1) * cfg.decimation + num_taps(cfg)
        # The fused channelizer requires decim-aligned input (no padding
        # on device — see freq_xlating_polyphase); the packed wire
        # formats additionally need n_in % 8 == 0 (cr1: 8 samples/byte;
        # this also satisfies ci1's 4/byte).
        align = int(np.lcm(cfg.decimation, 8))
        n_in = -(-n_in // align) * align
        self.n_in = n_in
        self.n_chan, self.n_blocks, self.core_len = wideband_geometry(cfg, n_in)
        _chan, _demod = make_wideband_fns(cfg, n_in)
        self._chan_fn = jax.jit(_chan)
        self._demod_fn = jax.jit(_demod)
        # Channelizer buffers, shipped as float planes (ops/cplx.py).
        _car, _hf = channelizer_buffers(cfg, n_in)
        self._carriers = jax.device_put(_car)
        self._hf = jax.device_put(_hf)
        # Raw samples consumed per call (stream advance).
        self.step_raw = self.n_blocks * self.core_len * cfg.decimation
        self._buf = np.zeros(0, dtype=np.complex64)
        self._pos = 0  # absolute raw index of _buf[0]
        from ais_tpu.pipeline.host import PacketDeduper

        self._dedupers = [
            PacketDeduper() for _ in cfg.offsets_hz
        ]
        # Cumulative collect-path split (see collect()): exec = wait for
        # the device result, fetch = d2h transfer, host = HDLC/NMEA.
        self.reset_collect_stats()
        self.last_collect_s = (0.0, 0.0)
        # Overflowed blocks re-demodulated host-side (pipeline/recover.py)
        # and those it could not re-demodulate (no CPU device).
        self.recovery_stats = {"recovered_blocks": 0, "unrecovered_blocks": 0}

    # -- wire-format (integer IQ) path ---------------------------------------
    #
    # Stream contract: each submit/decode_wire call covers exactly n_in
    # raw samples but ADVANCES the stream by only step_raw (< n_in): the
    # final n_in - step_raw samples are the overlap-save halo and MUST be
    # re-presented at the start of the next call's buffer (`wire_overlap`
    # bytes).  Feeding back-to-back non-overlapping buffers silently
    # skips the halo region and breaks mixer phase continuity — use
    # `process()`/`decode()`, which buffer internally, when the source
    # cannot re-present.

    @property
    def wire_overlap_samples(self) -> int:
        """Raw samples each wire call must re-present from the previous
        call (the framing halo at input rate)."""
        return self.n_in - self.step_raw

    def stage_wire(self, raw_u8: np.ndarray, fmt: str = "ci8", pos: int | None = None):
        """Start the h2d transfer of one wire step WITHOUT dispatching
        the device program; returns a staged handle for `dispatch_wire`.

        SDRs emit int8/int16 IQ; shipping those bytes (or the packed
        ci4/ci2 forms) and converting on device (ops/convert.py) cuts
        host->device traffic 2-8x vs complex64 planes.

        `pos` overrides the stream position (absolute raw index of
        raw_u8's first sample) without touching the internal counter.
        """
        conv, want = wire_converter(fmt, self.n_in)
        if raw_u8.size != want:
            raise ValueError(
                f"{fmt} wire buffer of {raw_u8.size} bytes; n_in "
                f"{self.n_in} needs {want}"
            )
        if not hasattr(self, "_wire_fns"):
            self._wire_fns = {}
        if fmt not in self._wire_fns:
            chan, demod = make_wideband_fns(self.cfg, self.n_in)
            fftlen = self.cfg.demod.fftlen
            cfg = self.cfg
            cl = cfg.compact_lanes

            def _pack(rec: BurstRecords) -> jax.Array:
                if cl:
                    return pack_wire_compact(rec, fftlen, cl)
                return pack_wire_flat(rec, fftlen)

            def fn(raw, ph, car, hf):
                return _pack(demod(chan(conv(raw), ph, car, hf)))

            self._wire_fns[fmt] = jax.jit(fn)
        at = self._pos if pos is None else int(pos)
        phase0s = np.stack(
            [mixer_phase(off, self.cfg.input_rate, at) for off in self.cfg.offsets_hz]
        )
        # device_put starts the (async) transfer immediately.
        buf = jax.device_put(raw_u8)
        ph = jnp.asarray(phase0s)
        if pos is None:
            self._pos += self.step_raw
        # The raw bytes ride along (a reference, not a copy) so overflow
        # recovery can re-demod a capped block host-side.
        return (buf, ph, at, fmt, raw_u8)

    def dispatch_wire(self, staged):
        """Dispatch the device program on a `stage_wire` handle; returns
        a handle for `collect()` (the jitted call does not block, so the
        result is a future)."""
        buf, ph, at, fmt, raw_u8 = staged
        rec = self._wire_fns[fmt](buf, ph, self._carriers, self._hf)
        return (rec, at // self.cfg.decimation, raw_u8, fmt, at)

    def submit_wire(self, raw_u8: np.ndarray, fmt: str = "ci8", pos: int | None = None):
        """Enqueue one n_in-sample wire step (stage + dispatch); returns
        a handle for `collect()`.  Submitting step N+1 before collecting
        step N double-buffers the pipeline on backends with an async
        stream."""
        return self.dispatch_wire(self.stage_wire(raw_u8, fmt, pos))

    def fetch_wire(self, handle):
        """Block on a submit_wire handle's device result and pull it to
        host; returns an opaque fetched payload for `decode_fetched`.

        Split from `decode_fetched` so a pipelined caller can start the
        next step's h2d transfer between the d2h fetch and the host HDLC
        back half."""
        flat, chan_start, raw_u8, fmt, at = handle
        # np.asarray blocks: exec wait + d2h.
        return np.asarray(flat), chan_start, raw_u8, fmt, at

    def decode_fetched(self, fetched):
        """Host back half of `collect`: HDLC/NMEA decode of a
        `fetch_wire` payload, plus overflow recovery when a block's
        burst table capped out."""
        flat_np, chan_start, raw_u8, fmt, at = fetched
        from ais_tpu.pipeline.host import decode_wire_records

        import dataclasses

        demod_cfg = dataclasses.replace(
            self.cfg.demod, samples_per_symbol=self.cfg.sps
        )
        _, n_sym = burst_table_geometry(demod_cfg)
        n_pack = -(-n_sym // 8)
        dropped: list = []
        if self.cfg.compact_lanes:
            rec_np, dropped = unpack_wire_compact(
                flat_np,
                self.n_chan,
                self.n_blocks,
                demod_cfg.max_bursts_per_block,
                n_pack,
            )
        else:
            rec_np = unpack_wire_flat(
                flat_np,
                self.n_chan,
                self.n_blocks,
                demod_cfg.max_bursts_per_block,
                n_pack,
            )
        if dropped and not self.cfg.overflow_recovery:
            import logging

            logging.getLogger("ais_tpu").warning(
                "compact_lanes=%d dropped valid lanes in %d block(s) and "
                "overflow_recovery is off — raise compact_lanes",
                self.cfg.compact_lanes,
                len(dropped),
            )
        packets = decode_wire_records(
            rec_np,
            n_sym,
            chan_start,
            self.core_len,
            designators=self.cfg.designators,
            dedupers=self._dedupers,
            deframer=self.cfg.deframer,
            samples_per_symbol=self.cfg.sps,
        )
        if self.cfg.overflow_recovery:
            k = demod_cfg.max_bursts_per_block
            n_det = rec_np.meta_i[:, :, 0, 3]
            over = [
                (int(c), int(b), int(n_det[c, b]))
                for c, b in zip(*np.nonzero(n_det > k))
            ]
            # Directory overflow (compact_lanes): blocks whose valid
            # lanes did not fit the shipped bound re-demod host-side
            # exactly like a capped burst table.
            seen = {(c, b) for c, b, _n in over}
            over.extend(
                x for x in dropped if (x[0], x[1]) not in seen
            )
            if over:
                from ais_tpu.pipeline.recover import (
                    host_iq_from_wire,
                    recover_overflow_packets,
                )

                packets.extend(
                    recover_overflow_packets(
                        host_iq_from_wire(raw_u8, fmt),
                        at,
                        self.cfg,
                        over,
                        self._dedupers,
                        self.recovery_stats,
                    )
                )
                packets.sort(key=lambda p: p.abs_sample)
        if self.cfg.image_reject:
            from ais_tpu.pipeline.host import suppress_image_ghosts

            packets = suppress_image_ghosts(packets)
        return packets

    def collect(self, handle):
        """Block on a submit_wire handle and host-decode its packets.

        Per-step timing lands in `collect_stats`: `exec_s` is the wait
        for the device result to exist (`block_until_ready` — dispatch
        queue + execution), `fetch_s` the d2h transfer of the ready
        result, `host_s` the numpy/native HDLC back half.
        """
        import time as _time

        t0 = _time.perf_counter()
        jax.block_until_ready(handle[0])
        t1 = _time.perf_counter()
        fetched = self.fetch_wire(handle)
        t2 = _time.perf_counter()
        packets = self.decode_fetched(fetched)
        t3 = _time.perf_counter()
        self.last_collect_s = (t2 - t0, t3 - t2)
        st = self.collect_stats
        st["exec_s"] += t1 - t0
        st["fetch_s"] += t2 - t1
        st["host_s"] += t3 - t2
        st["steps"] += 1
        return packets

    def reset_dedup(self) -> None:
        """Forget dedup history.  Needed when the caller re-decodes
        EARLIER stream positions: a surviving history entry at the same
        (payload, position) would silently suppress the replayed
        packet."""
        from ais_tpu.pipeline.host import PacketDeduper

        self._dedupers = [PacketDeduper() for _ in self.cfg.offsets_hz]

    def reset_collect_stats(self) -> None:
        """Zero the cumulative collect-path split (call after warmup so
        per-step averages reflect steady state only)."""
        self.collect_stats = {
            "exec_s": 0.0, "fetch_s": 0.0, "host_s": 0.0, "steps": 0
        }

    def decode_wire(self, raw_u8: np.ndarray, fmt: str = "ci8"):
        """Decode one n_in-sample step fed as integer wire bytes
        (submit + collect; see the stream contract above)."""
        return self.collect(self.submit_wire(raw_u8, fmt))

    def _host_decode(self, rec_np, chan_start: int, iq_raw=None):
        """Shared per-(channel, block) deframe loop (host back half).

        `iq_raw`: the step's raw complex samples (for burst-table
        overflow recovery; None disables it for this step)."""
        from ais_tpu.pipeline.host import decode_block_records

        packets = []
        for c in range(self.n_chan):
            for b in range(self.n_blocks):
                r = jax.tree.map(lambda a: a[c, b], rec_np)
                packets.extend(
                    decode_block_records(
                        r,
                        chan_start + b * self.core_len,
                        designator=self.cfg.designators[c],
                        deframer=self.cfg.deframer,
                        deduper=self._dedupers[c],
                        fftlen=self.cfg.demod.fftlen,
                        samples_per_symbol=self.cfg.sps,
                    )
                )
        if self.cfg.overflow_recovery and iq_raw is not None:
            k = self.cfg.demod.max_bursts_per_block
            n_det = np.asarray(rec_np.n_detected)  # (C, B)
            over = [
                (int(c), int(b), int(n_det[c, b]))
                for c, b in zip(*np.nonzero(n_det > k))
            ]
            if over:
                from ais_tpu.pipeline.recover import recover_overflow_packets

                packets.extend(
                    recover_overflow_packets(
                        iq_raw,
                        chan_start * self.cfg.decimation,
                        self.cfg,
                        over,
                        self._dedupers,
                        self.recovery_stats,
                    )
                )
        packets.sort(key=lambda p: p.abs_sample)
        if self.cfg.image_reject:
            from ais_tpu.pipeline.host import suppress_image_ghosts

            packets = suppress_image_ghosts(packets)
        return packets

    def device_step(self, x: np.ndarray, start_raw: int):
        """One fused device call over exactly n_in raw samples."""
        phase0s = np.stack(
            [
                mixer_phase(off, self.cfg.input_rate, start_raw)
                for off in self.cfg.offsets_hz
            ]
        )
        from ais_tpu.ops.cplx import to_planes

        chans = self._chan_fn(
            jnp.asarray(to_planes(np.asarray(x, np.complex64))),
            jnp.asarray(phase0s),
            self._carriers,
            self._hf,
        )
        return self._demod_fn(chans)

    def process(self, iq: np.ndarray):
        """Feed raw samples; yields (records, channel_starts) per full step.

        `channel_starts[c]` is the absolute channel-rate index of block 0
        for geometry-aware host decode.
        """
        from ais_tpu.pipeline.host import decode_block_records  # noqa: F401

        self._buf = np.concatenate([self._buf, np.asarray(iq, np.complex64)])
        out = []
        while self._buf.size >= self.n_in:
            step_iq = self._buf[: self.n_in]  # view; kept alive for recovery
            rec = self.device_step(step_iq, self._pos)
            out.append((rec, self._pos // self.cfg.decimation, step_iq))
            self._buf = self._buf[self.step_raw :]
            self._pos += self.step_raw
        return out

    def flush(self):
        """End-of-stream: zero-pad the residual buffer to one full step
        and decode it.  Call once when the source is exhausted; packets
        in the undecoded tail (< n_in samples) are recovered.  The zero
        padding becomes part of the stream, so only flush at the end."""
        if self._buf.size == 0:
            return []
        return self.decode(
            np.zeros(max(self.n_in - self._buf.size, 0), dtype=np.complex64)
        )

    # -- checkpoint / resume --------------------------------------------------
    # The reference has none (SURVEY.md §5.4): its DSP state lives in C++
    # block members and dies with the process.  Here the receiver's whole
    # stream state is the sample buffer, the absolute stream position
    # (which also determines mixer phase — mixer_phase() derives it from
    # the position at every step), and the dedup memory: a picklable dict,
    # so kill/resume is exact (tests/test_checkpoint.py).

    def get_state(self) -> dict:
        return {
            "buf": self._buf.copy(),
            "pos": self._pos,
            "dedup_recent": [list(d._recent) for d in self._dedupers],
        }

    def set_state(self, state: dict) -> None:
        self._buf = np.asarray(state["buf"], dtype=np.complex64).copy()
        self._pos = int(state["pos"])
        for d, recent in zip(self._dedupers, state["dedup_recent"]):
            d._recent = list(recent)

    def decode(self, iq: np.ndarray):
        """Feed raw samples, return host-decoded packets from full steps."""
        packets = []
        for rec, chan_start, step_iq in self.process(iq):
            rec_np = jax.tree.map(np.asarray, rec)
            packets.extend(self._host_decode(rec_np, chan_start, step_iq))
        packets.sort(key=lambda p: p.abs_sample)
        return packets

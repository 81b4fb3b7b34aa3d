"""Host-side back half: burst bit tables -> HDLC frames -> NMEA sentences.

The stream->message boundary of the reference (hdlc_deframer's PDU output
feeding pdu_to_nmea, reference: python/radio.py:64-73) maps here to the
device->host boundary: the device produces fixed-size per-burst bit tensors;
this module deframes them, deduplicates packets that were detected twice
(e.g. a correlator double-fire on one burst), and renders AIVDM sentences.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ais_tpu.core.params import DeframerConfig
from ais_tpu.decode.hdlc import deframe
from ais_tpu.decode.nmea import frame_to_nmea


@dataclass(frozen=True)
class DecodedPacket:
    payload: bytes
    abs_sample: int        # absolute sample index of the burst's preamble
    designator: str
    corr_mag: float
    freq_est_hz: float
    # Mean pre-AGC power over the burst window (linear).  corr_mag is
    # measured AFTER the envelope-normalizing AGC and so says nothing
    # about received strength; rssi does.  0.0 when the producer
    # predates the field.
    rssi: float = 0.0

    @property
    def nmea(self) -> str:
        return frame_to_nmea(self.payload, self.designator)

    @property
    def nmea_pdu(self) -> bytes:
        """Sentence as bytes — the reference's `to_nmea` u8vector-PDU
        output port (lib/pdu_to_nmea_impl.cc:137-144)."""
        return self.nmea.encode("ascii")

    @property
    def fields(self) -> dict:
        """Parsed AIS message fields (decode/fields.py) — past the
        armoring boundary where the reference stops."""
        from ais_tpu.decode.fields import parse_fields

        return parse_fields(self.payload)


# Packets are anchored to their *own* preamble sample (frame start-bit
# arithmetic below), so two sightings of one transmission land within a
# few samples of each other while distinct packets are >= one minimum
# frame (~800 samples at 5 sps) apart.  512 cleanly separates the two.
DEDUP_WINDOW = 512

# Decoded bit index 0 sits at the burst window start = the preamble
# start; the opening HDLC flag follows the 24-bit training sequence
# (reference python/ais_demod.py:36 — [1,1,0,0]*7 pattern, first 24 bits
# before the flag).
PREAMBLE_BITS = 24


@dataclass
class PacketDeduper:
    """Drop repeats of the same payload within a sample-distance window.

    Two detections of one transmission sit within a few samples of each
    other (same preamble anchor); genuine retransmissions of identical
    payloads are at least a frame apart.
    """

    window: int = DEDUP_WINDOW
    # Packets arrive only roughly ordered: a burst window spans several
    # packet lengths, so a transmission's duplicate sighting can arrive
    # *after* packets anchored later.  Retain history well past the
    # match window so out-of-order arrivals still find their twin.
    retention: int = 16384
    _recent: list = field(default_factory=list)

    def admit(self, packet: DecodedPacket) -> bool:
        self._recent = [
            (p, s) for (p, s) in self._recent if packet.abs_sample - s < self.retention
        ]
        for payload, sample in self._recent:
            if payload == packet.payload and abs(packet.abs_sample - sample) < self.window:
                return False
        self._recent.append((packet.payload, packet.abs_sample))
        return True


def _deframe_burst(burst_bits: np.ndarray, deframer: DeframerConfig):
    """Deframe one burst's valid bits -> [(payload, start_bit)].

    Dispatches to the native C++ HDLC kernel (native/ais_native.cpp)
    when the library is available — the host back half runs concurrently
    with the next device step, so its speed sets the pipeline's floor —
    falling back to the pure-numpy `decode.hdlc.deframe` (the two are
    cross-checked bit-for-bit in tests/test_native.py).
    """
    from ais_tpu import native

    if native.available():
        return native.hdlc_deframe(
            burst_bits, deframer.min_length_bytes, deframer.max_length_bytes
        )
    return [
        (fr.payload, fr.start_bit)
        for fr in deframe(
            burst_bits, deframer.min_length_bytes, deframer.max_length_bytes
        )
    ]


def _emit_packets(
    frames,
    win_start: int,
    block_start_sample: int,
    mag: float,
    freq_hz: float,
    designator: str,
    deduper: PacketDeduper | None,
    samples_per_symbol: float,
    out: list,
    rssi: float = 0.0,
) -> None:
    """Anchor each frame to its own preamble and dedup-admit it.

    A burst window spans several packet lengths, so frames past the
    first belong to *later* transmissions — position them by their flag
    bit within the extraction window (bit b sits near win_start + b*sps;
    the opening flag follows the 24-bit training sequence)."""
    for payload, start_bit in frames:
        anchor = win_start + int(
            round((start_bit - PREAMBLE_BITS) * samples_per_symbol)
        )
        packet = DecodedPacket(
            payload=payload,
            abs_sample=block_start_sample + anchor,
            designator=designator,
            corr_mag=mag,
            freq_est_hz=freq_hz,
            rssi=rssi,
        )
        if deduper is None or deduper.admit(packet):
            out.append(packet)


def decode_wire_records(
    wire,
    n_sym: int,
    chan_start: int,
    core_len: int,
    designators=("A", "B"),
    dedupers=None,
    deframer: DeframerConfig = DeframerConfig(),
    samples_per_symbol: float = 5.0,
) -> list:
    """Decode a WireRecords fetch (pipeline/wideband.py) into packets.

    With the native library, ALL valid bursts deframe in ONE C call
    reading the packed bit planes directly
    (native.hdlc_deframe_packed_batch) — the per-burst ctypes
    marshalling this replaces dominated the host back half at full
    channel load (~400 bursts per fetch).  The numpy fallback unpacks
    the planes vectorized and deframes per burst."""
    meta_i = np.asarray(wire.meta_i)  # (C, B, K, 4)
    meta_f = np.asarray(wire.meta_f)
    packed = np.asarray(wire.packed)  # (C, B, K, 2, n_pack)
    C, B, K, _ = meta_i.shape
    log = logging.getLogger("ais_tpu")
    packets: list[DecodedPacket] = []

    # Overflow visibility (one check per (channel, block), vectorized).
    n_det = meta_i[:, :, 0, 3]
    for c, b in zip(*np.nonzero(n_det > K)):
        log.warning(
            "burst table overflow: %d peaks detected in block at sample %d "
            "but max_bursts_per_block=%d — raise "
            "DemodConfig.max_bursts_per_block",
            int(n_det[c, b]),
            chan_start + int(b) * core_len,
            K,
        )

    valid_flat = meta_i[..., 2].reshape(-1)
    lanes = np.nonzero(valid_flat)[0].astype(np.int32)
    if lanes.size == 0:
        return packets

    from ais_tpu import native

    triples = None
    if native.available():
        try:
            triples = native.hdlc_deframe_packed_batch(
                packed.reshape(C * B * K, 2, -1),
                lanes,
                n_sym,
                deframer.min_length_bytes,
                deframer.max_length_bytes,
                max_frames=8 * lanes.size + 64,
            )
        except ValueError:
            # Geometry beyond the C kernel's static bit buffer: the
            # numpy path below handles it (native is an accelerator,
            # never a requirement).
            triples = None
    if triples is not None:
        # Frames arrive in lane order (C-major) — the same c -> b -> k
        # sequence as the fallback loop, so dedup admits identically.
        for payload, start_bit, li in triples:
            lane = int(lanes[li])
            c, rem = divmod(lane, B * K)
            b, k = divmod(rem, K)
            _emit_packets(
                [(payload, start_bit)],
                int(meta_i[c, b, k, 1]),
                chan_start + b * core_len,
                float(meta_f[c, b, k, 0]),
                float(meta_f[c, b, k, 1]),
                designators[c],
                dedupers[c] if dedupers is not None else None,
                samples_per_symbol,
                packets,
                rssi=float(meta_f[c, b, k, 2]),
            )
        packets.sort(key=lambda p: p.abs_sample)
        return packets

    planes = np.unpackbits(packed, axis=-1)[..., :n_sym]  # (C,B,K,2,n_sym)
    for lane in lanes:
        c, rem = divmod(int(lane), B * K)
        b, k = divmod(rem, K)
        row = planes[c, b, k]
        burst_bits = row[0][row[1].astype(bool)]
        frames = _deframe_burst(burst_bits, deframer)
        _emit_packets(
            frames,
            int(meta_i[c, b, k, 1]),
            chan_start + b * core_len,
            float(meta_f[c, b, k, 0]),
            float(meta_f[c, b, k, 1]),
            designators[c],
            dedupers[c] if dedupers is not None else None,
            samples_per_symbol,
            packets,
            rssi=float(meta_f[c, b, k, 2]),
        )
    packets.sort(key=lambda p: p.abs_sample)
    return packets


def decode_block_records(
    records,
    block_start_sample: int,
    designator: str = "A",
    deframer: DeframerConfig = DeframerConfig(),
    deduper: PacketDeduper | None = None,
    fftlen: int = 1024,
    samples_per_symbol: float = 5.0,
) -> list[DecodedPacket]:
    """Deframe one block's BurstRecords (host numpy copies) into packets."""
    valid = np.asarray(records.valid)
    n_detected = int(np.asarray(getattr(records, "n_detected", 0)))
    if n_detected > valid.size:
        # The fixed-size burst table capped out: bursts were dropped.
        # The reference has no analogue (its tag stream is unbounded);
        # here capacity is static, so overflow must be loud.
        logging.getLogger("ais_tpu").warning(
            "burst table overflow: %d peaks detected in block at sample %d "
            "but max_bursts_per_block=%d — raise DemodConfig.max_bursts_per_block",
            n_detected,
            block_start_sample,
            valid.size,
        )
    positions = np.asarray(records.position)
    mags = np.asarray(records.mag)
    rssis = (
        np.asarray(records.rssi)
        if hasattr(records, "rssi")
        else np.zeros_like(mags)
    )
    bits = np.asarray(records.bits)
    bit_valid = np.asarray(records.bit_valid)
    freq_est = np.asarray(records.freq_est)
    packets: list[DecodedPacket] = []
    for k in np.nonzero(valid)[0]:
        burst_bits = bits[k][bit_valid[k]]
        frames = _deframe_burst(burst_bits, deframer)
        chunk = min(int(positions[k]) // fftlen, freq_est.size - 1) if freq_est.size else 0
        win_start = (
            int(np.asarray(records.win_start)[k])
            if hasattr(records, "win_start")
            else int(positions[k])
        )
        _emit_packets(
            frames,
            win_start,
            block_start_sample,
            float(mags[k]),
            float(freq_est[chunk]) if freq_est.size else 0.0,
            designator,
            deduper,
            samples_per_symbol,
            packets,
            rssi=float(rssis[k]),
        )
    return packets


# A ghost is the SAME transmission seen through the mirrored spectrum:
# its decoded bit stream is identical, so its frame anchor lands on the
# same sample (probe-exact in practice; a few samples of estimator
# jitter at most).  Distinct transmissions that merely overlap — even
# deliberate same-payload tests — start >= a slot-timing quantum apart,
# so a tight window separates the two cases where DEDUP_WINDOW cannot.
IMAGE_GHOST_WINDOW = 64


def suppress_image_ghosts(
    packets: list, window: int = IMAGE_GHOST_WINDOW, margin_db: float = 6.0
) -> list:
    """Drop I/Q-image ghosts from a merged multi-channel packet list.

    Receiver I/Q gain/phase imbalance mirrors channel A's spectrum into
    channel B's passband (and vice versa: the two AIS carriers sit
    symmetrically at +-25 kHz, python/radio.py:86-89).  The mirrored
    signal is the complex conjugate, whose FM discriminator output is
    negated — but NRZI is differentially decoded, so the inverted bit
    stream decodes to the IDENTICAL payload with a VALID CRC: at ~1 dB /
    5 deg imbalance (IRR ~ -23 dB, typical of cheap SDRs) the ghost
    passes every bit-level check.  Post-AGC correlation magnitude is
    amplitude-blind, so the only reliable discriminator is the pre-AGC
    burst power: the ghost is exactly IRR weaker.

    Two same-payload sightings on DIFFERENT channels within `window`
    samples cannot both be real transmissions (an AIS station transmits
    one channel per slot; the payload carries the MMSI), so the weaker
    is dropped when it is at least `margin_db` below the stronger —
    sightings of comparable power are both kept (never discard in the
    ambiguous case).  The reference prints both ghosts (it has no
    cross-channel view); this is a deliberate improvement
    (ARCHITECTURE.md §3).
    """
    ratio = 10.0 ** (margin_db / 10.0)
    drop: set[int] = set()
    for i, p in enumerate(packets):
        for j in range(i + 1, len(packets)):
            q = packets[j]
            if abs(q.abs_sample - p.abs_sample) >= window:
                break  # input sorted by abs_sample
            if q.designator == p.designator or q.payload != p.payload:
                continue
            weak, strong = (i, q) if p.rssi < q.rssi else (j, p)
            if strong.rssi > ratio * packets[weak].rssi > 0.0:
                drop.add(weak)
    return [p for i, p in enumerate(packets) if i not in drop]

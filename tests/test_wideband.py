"""Fused wideband pipeline (2.4 Msps dual-channel) on the CPU backend."""

import numpy as np
import pytest

from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver, num_taps
from ais_tpu.tx import aivdm_payload_to_bytes
from ais_tpu.tx.scenario import Scenario, ScenarioPacket

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
SENTENCE_A = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
SENTENCE_B = "!AIVDM,1,1,,B,14eG;o@034o8sd<L9i:a;WF>062D,0*7E"


@pytest.fixture(scope="module")
def receiver():
    cfg = WidebandConfig()
    n48 = cfg.block_len + cfg.core_len
    return WidebandReceiver(cfg, n_in=(n48 - 1) * cfg.decimation + num_taps(cfg))


def test_dual_channel_decode(receiver):
    raw = aivdm_payload_to_bytes(PAYLOAD)
    iq = Scenario(
        sample_rate=2.4e6,
        n_samples=receiver.n_in,
        noise=0.004,
        packets=[
            ScenarioPacket(raw, 200000, -25e3, phase=0.7),
            ScenarioPacket(raw, 700000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
        ],
    ).build()
    pkts = receiver.decode(iq)
    assert [p.nmea for p in pkts] == [SENTENCE_A, SENTENCE_B]


def test_geometry_alignment(receiver):
    assert receiver.n_in % receiver.cfg.decimation == 0
    assert receiver.step_raw <= receiver.n_in


def _wire_receiver():
    cfg = WidebandConfig()
    n48 = cfg.block_len + cfg.core_len
    return WidebandReceiver(cfg, n_in=(n48 - 1) * cfg.decimation + num_taps(cfg))


def test_wire_path_matches_float_path():
    """decode_wire (int8 ingest + on-device WireRecords compaction +
    native host deframe) finds the same packets as the float path.

    Both receivers must be FRESH: abs_sample is a stream position, so a
    receiver whose _pos was advanced by an earlier test would offset the
    float path's positions."""
    from ais_tpu.ops.convert import host_bytes

    flt = _wire_receiver()
    raw = aivdm_payload_to_bytes(PAYLOAD)
    iq = Scenario(
        sample_rate=2.4e6,
        n_samples=flt.n_in,
        noise=0.004,
        packets=[
            ScenarioPacket(raw, 200000, -25e3, phase=0.7),
            ScenarioPacket(raw, 700000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
        ],
    ).build()
    want = flt.decode(iq)
    rx = _wire_receiver()
    got = rx.decode_wire(host_bytes((iq * 0.7).astype(np.complex64), "ci8"), "ci8")
    assert [(p.payload, p.designator) for p in got] == [
        (p.payload, p.designator) for p in want
    ]
    # int8 quantization may move the correlation peak by a sample or two.
    assert all(abs(g.abs_sample - w.abs_sample) <= 4 for g, w in zip(got, want))


def test_wire_streaming_overlap_contract():
    """Two submit/collect steps honoring the re-present-the-halo contract:
    a packet placed in the second step's core (inside the first call's
    halo) decodes exactly once, in the step that owns it."""
    from ais_tpu.ops.convert import host_bytes

    rx = _wire_receiver()
    raw = aivdm_payload_to_bytes(PAYLOAD)
    total = rx.step_raw + rx.n_in
    core_raw = rx.core_len * rx.cfg.decimation
    iq = Scenario(
        sample_rate=2.4e6,
        n_samples=total,
        noise=0.004,
        packets=[
            ScenarioPacket(raw, 300000, -25e3, phase=0.3),
            # Straddles the first call's core/halo seam: starts in the
            # final core of step 0 and runs past step_raw.
            ScenarioPacket(raw, rx.step_raw - 40000, +25e3, phase=1.1),
            # Owned by step 1 (inside step 0's halo span).
            ScenarioPacket(raw, rx.step_raw + core_raw // 2, -25e3, phase=2.0),
        ],
    ).build()
    wire = host_bytes((iq * 0.7).astype(np.complex64), "ci8")
    per = 2  # bytes per sample, ci8
    h0 = rx.submit_wire(wire[: per * rx.n_in], "ci8")
    h1 = rx.submit_wire(wire[per * rx.step_raw : per * (rx.step_raw + rx.n_in)], "ci8")
    pkts = rx.collect(h0) + rx.collect(h1)
    assert sorted(p.nmea for p in pkts) == sorted(
        [SENTENCE_A, SENTENCE_B, SENTENCE_A]
    )
    starts = sorted(p.abs_sample * rx.cfg.decimation for p in pkts)
    want = sorted([300000, rx.step_raw - 40000, rx.step_raw + core_raw // 2])
    assert all(abs(g - w) < 2500 for g, w in zip(starts, want))


def test_empty_capture(receiver):
    rng = np.random.default_rng(9)
    iq = (
        rng.normal(size=receiver.n_in) + 1j * rng.normal(size=receiver.n_in)
    ).astype(np.complex64) * 0.05
    assert receiver.decode(iq) == []


def _random_runs(rng, shape, n_sym):
    """Random contiguous validity runs, some empty."""
    first = rng.integers(0, n_sym, size=shape)
    count = rng.integers(0, n_sym, size=shape)
    count = np.minimum(count, n_sym - first)
    idx = np.arange(n_sym)
    return (idx >= first[..., None]) & (idx < (first + count)[..., None])


def test_wire_flat_roundtrip_exact():
    """pack_wire_flat -> unpack_wire_flat is byte-exact: int32 metadata
    (incl. values with high bytes set) and float32 metadata (incl.
    negative frequencies) survive the on-device little-endian byte
    decomposition bit-for-bit."""
    import jax.numpy as jnp

    from ais_tpu.pipeline.receiver import BurstRecords
    from ais_tpu.pipeline.wideband import pack_wire_flat, unpack_wire_flat

    C, B, K, n_sym = 2, 3, 4, 37
    rng = np.random.default_rng(5)
    rec = BurstRecords(
        position=jnp.asarray(
            rng.integers(0, 2**30, size=(C, B, K)), jnp.int32
        ),
        center=jnp.zeros((C, B, K), jnp.float32),
        phase=jnp.zeros((C, B, K), jnp.float32),
        mag=jnp.asarray(
            rng.uniform(0, 1e7, size=(C, B, K)).astype(np.float32)
        ),
        valid=jnp.asarray(rng.integers(0, 2, size=(C, B, K)), bool),
        bits=jnp.asarray(rng.integers(0, 2, size=(C, B, K, n_sym)), jnp.uint8),
        # bit_valid is a CONTIGUOUS run by construction in every demod
        # mode (symbol positions advance monotonically and validity is a
        # window-bounds test) — the wire carries it as (first, count),
        # so the roundtrip contract covers runs, incl. empty ones.
        bit_valid=jnp.asarray(_random_runs(rng, (C, B, K), n_sym), bool),
        freq_est=jnp.asarray(
            rng.uniform(-4000, 4000, size=(C, B, 7)).astype(np.float32)
        ),
        n_detected=jnp.asarray(rng.integers(0, 99, size=(C, B)), jnp.int32),
        win_start=jnp.asarray(
            rng.integers(0, 2**24, size=(C, B, K)), jnp.int32
        ),
        rssi=jnp.asarray(
            rng.uniform(0, 2.0, size=(C, B, K)).astype(np.float32)
        ),
    )
    fftlen = 1024
    flat = np.asarray(pack_wire_flat(rec, fftlen))
    assert flat.dtype == np.uint8 and flat.ndim == 1
    w = unpack_wire_flat(flat, C, B, K, -(-n_sym // 8))

    # Reference packing on host.
    np.testing.assert_array_equal(w.meta_i[..., 0], np.asarray(rec.position))
    np.testing.assert_array_equal(w.meta_i[..., 1], np.asarray(rec.win_start))
    np.testing.assert_array_equal(
        w.meta_i[..., 2], np.asarray(rec.valid).astype(np.int32)
    )
    np.testing.assert_array_equal(
        w.meta_i[..., 3], np.broadcast_to(np.asarray(rec.n_detected)[..., None], (C, B, K))
    )
    # Bit-exact floats (incl. negative freq estimates).
    np.testing.assert_array_equal(w.meta_f[..., 0], np.asarray(rec.mag))
    chunk = np.clip(np.asarray(rec.position) // fftlen, 0, 6)
    want_freq = np.take_along_axis(
        np.asarray(rec.freq_est), chunk.reshape(C, B, K), axis=-1
    )
    np.testing.assert_array_equal(w.meta_f[..., 1], want_freq)
    # Bit planes round-trip through the 8x packing.
    planes = np.unpackbits(w.packed, axis=-1)[..., :n_sym]
    np.testing.assert_array_equal(planes[..., 0, :], np.asarray(rec.bits))
    np.testing.assert_array_equal(
        planes[..., 1, :], np.asarray(rec.bit_valid).astype(np.uint8)
    )


def test_bit_valid_is_contiguous_all_modes():
    """The (first, count) wire form of bit_valid (pack_wire_flat) is
    lossless ONLY because every demod mode emits a contiguous validity
    run — symbol positions advance monotonically and validity is a
    window-bounds test (sync/feedforward.py, sync/timing.py,
    sync/mlse.py).  Guard that contract directly: demod noisy bursts at
    several positions in every mode and assert each record's bit_valid
    has no interior gap."""
    import dataclasses

    import jax

    from ais_tpu.core.params import DemodConfig
    from ais_tpu.pipeline.receiver import make_burst_demod, required_halo
    from ais_tpu.tx import aivdm_payload_to_bytes, make_packet_iq

    raw = aivdm_payload_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D")
    pkt = make_packet_iq(raw, samples_per_symbol=5)
    rng = np.random.default_rng(17)

    for mode, timing in (
        ("discriminator", "feedforward"),
        ("discriminator", "pll"),
        ("mlse", "feedforward"),
    ):
        cfg = DemodConfig(demod_mode=mode, timing_mode=timing)
        block_len = 16384
        core_len = block_len - required_halo(cfg)
        iq = (
            rng.normal(size=block_len) + 1j * rng.normal(size=block_len)
        ).astype(np.complex64) * 0.05
        # Packets at a spread of offsets, incl. one jammed against the
        # core end so its window clips (the case that shortens the run).
        for at in (300, 5000, core_len - 900):
            iq[at : at + pkt.size] += pkt.astype(np.complex64)
        rec = jax.tree.map(
            np.asarray, make_burst_demod(cfg, block_len, core_len)(iq)
        )
        assert rec.valid.sum() >= 2, (mode, timing)
        for k in np.nonzero(rec.valid)[0]:
            bv = rec.bit_valid[k].astype(np.int8)
            transitions = int(np.abs(np.diff(bv)).sum())
            # A contiguous run has at most one 0->1 and one 1->0 edge.
            assert transitions <= 2, (mode, timing, int(k), transitions)


def test_packed_format_roundtrip():
    """ci4/ci2 host encode -> device decode land within half a
    quantization step of the source (ci4: step 1/8; ci2: 4-level
    quantizer with bin centers at +-0.25/+-0.75)."""
    from ais_tpu.ops.convert import (
        host_bytes,
        iq_from_bytes_ci2,
        iq_from_bytes_ci4,
    )

    rng = np.random.default_rng(3)
    iq = (
        rng.uniform(-0.85, 0.85, 2000) + 1j * rng.uniform(-0.85, 0.85, 2000)
    ).astype(np.complex64)
    r4 = np.asarray(iq_from_bytes_ci4(host_bytes(iq, "ci4")))
    assert np.abs(r4.real - iq.real).max() <= 1 / 16 + 1e-6
    assert np.abs(r4.imag - iq.imag).max() <= 1 / 16 + 1e-6
    from ais_tpu.ops.convert import CI2_INNER, CI2_OUTER, CI2_THRESH

    r2 = np.asarray(iq_from_bytes_ci2(host_bytes(iq, "ci2", ci2_dither=0.0)))
    assert r2.shape == iq.shape
    # 2-bit AGC'd Lloyd-Max: every decoded value is one of the four
    # levels, and each source value maps to the level whose RMS-scaled
    # threshold bin holds it.
    lv = np.array([-CI2_OUTER, -CI2_INNER, CI2_INNER, CI2_OUTER])
    assert np.abs(np.unique(r2.real)[:, None] - lv[None, :]).min(1).max() < 1e-5
    rms = np.sqrt(0.5 * np.mean(np.abs(iq) ** 2))
    t = CI2_THRESH * rms
    code = (iq.real > -t).astype(int) + (iq.real > 0) + (iq.real > t)
    want = np.sign(code - 1.5) * np.where(
        np.abs(code - 1.5) > 1, CI2_OUTER, CI2_INNER
    )
    np.testing.assert_allclose(r2.real, want, atol=1e-6)


def test_wire_path_ci4_decodes():
    """The bench's wire format: 4-bit packed ingest decodes both
    channels with exact payloads (quantization noise after the 50x
    channelizer is ~35 dB down — ops/convert.py:iq_from_bytes_ci4)."""
    from ais_tpu.ops.convert import host_bytes

    rx = _wire_receiver()
    raw = aivdm_payload_to_bytes(PAYLOAD)
    iq = Scenario(
        sample_rate=2.4e6,
        n_samples=rx.n_in,
        noise=0.004,
        packets=[
            ScenarioPacket(raw, 200000, -25e3, phase=0.7),
            ScenarioPacket(raw, 700000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
        ],
    ).build()
    got = rx.decode_wire(host_bytes((iq * 0.7).astype(np.complex64), "ci4"), "ci4")
    assert [p.nmea for p in got] == [SENTENCE_A, SENTENCE_B]


def test_wire_path_ci2_decodes():
    """2-bit AGC'd Lloyd-Max wire (the bench headline format): both
    channels decode with exact payloads through the dithered encoder +
    on-device 4-level reconstruction (ops/convert.py:iq_from_bytes_ci2)."""
    from ais_tpu.ops.convert import host_bytes

    rx = _wire_receiver()
    raw = aivdm_payload_to_bytes(PAYLOAD)
    iq = Scenario(
        sample_rate=2.4e6,
        n_samples=rx.n_in,
        noise=0.004,
        packets=[
            ScenarioPacket(raw, 200000, -25e3, phase=0.7),
            ScenarioPacket(raw, 700000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
        ],
    ).build()
    got = rx.decode_wire(host_bytes((iq * 0.7).astype(np.complex64), "ci2"), "ci2")
    assert [p.nmea for p in got] == [SENTENCE_A, SENTENCE_B]


def _near_far_scene(n_in, weak_amplitude):
    raw = aivdm_payload_to_bytes(PAYLOAD)
    return Scenario(
        sample_rate=2.4e6,
        n_samples=n_in,
        noise=0.002,
        packets=[
            ScenarioPacket(raw, 300000, -25e3, amplitude=weak_amplitude,
                           phase=0.7),
            ScenarioPacket(raw, 280000, +25e3, amplitude=0.8,
                           extra_freq_hz=90.0),
        ],
    ).build()


def test_near_far_adjacent_channel_selectivity(receiver):
    """A strong channel-B transmission 26 dB above a weak OVERLAPPING
    channel-A one: the channelizer's stopband must suppress the
    adjacent carrier (50 kHz away) enough that the weak packet still
    decodes — the reference relies on the same `low_pass(1, rate,
    11000, 1000)` selectivity (python/radio.py:49).  The
    peak-referenced sigma-delta ci1 wire must carry the same 26 dB
    dynamic range (its in-band noise floor sits well under the weak
    signal)."""
    from ais_tpu.ops.convert import host_bytes

    iq = _near_far_scene(receiver.n_in, weak_amplitude=0.04)
    pkts = receiver.decode(iq)
    assert sorted(p.nmea for p in pkts) == [SENTENCE_A, SENTENCE_B]

    rx2 = WidebandReceiver(receiver.cfg, n_in=receiver.n_in)
    got = rx2.decode_wire(host_bytes(iq, "ci1"), "ci1")
    assert sorted(p.nmea for p in got) == [SENTENCE_A, SENTENCE_B]


def test_near_far_cr1_at_28db(receiver):
    """The 1-bit-per-sample cr1 wire carries a 28 dB near-far imbalance:
    the second-order bandpass noise-shaping notch covers both channels,
    so the weak packet rides above the in-band quantization floor even
    when the peak-referenced scale is set by the strong carrier
    (ops/convert.py:iq_from_bytes_cr1)."""
    from ais_tpu.ops.convert import host_bytes

    iq = _near_far_scene(receiver.n_in, weak_amplitude=0.04)
    rx2 = WidebandReceiver(receiver.cfg, n_in=receiver.n_in)
    got = rx2.decode_wire(host_bytes(iq, "cr1"), "cr1")
    assert sorted(p.nmea for p in got) == [SENTENCE_A, SENTENCE_B]


def test_near_far_ci4_at_12db(receiver):
    """ci4's undithered 4-bit grid holds a 12 dB near-far imbalance
    (a weak overlapping packet one-third of a quantization step rides
    the strong carrier's self-dither).  ci2 is excluded by design: its
    Lloyd-Max AGC assumes dense near-Gaussian traffic and an on-air
    noise floor (see ops/convert.py) — sparse two-carrier scenes are
    ci1/ci4 territory."""
    from ais_tpu.ops.convert import host_bytes

    iq = _near_far_scene(receiver.n_in, weak_amplitude=0.2)
    rx2 = WidebandReceiver(receiver.cfg, n_in=receiver.n_in)
    got = rx2.decode_wire(host_bytes(iq, "ci4"), "ci4")
    assert sorted(p.nmea for p in got) == [SENTENCE_A, SENTENCE_B]


def _dual_scene(n_in):
    raw = aivdm_payload_to_bytes(PAYLOAD)
    return Scenario(
        sample_rate=2.4e6,
        n_samples=n_in,
        noise=0.004,
        packets=[
            ScenarioPacket(raw, 200000, -25e3, phase=0.7),
            ScenarioPacket(raw, 700000, +25e3, amplitude=0.6,
                           extra_freq_hz=140.0),
        ],
    ).build()


def test_sdr_dc_spike_rejected(receiver):
    """A large DC offset (the classic RTL-SDR center spike, 0.25 full
    scale — bigger than channel B's signal) sits 25 kHz from both
    channel carriers: the channelizer's stopband must remove it
    entirely.  The reference gets the same protection from its
    `low_pass(1, rate, 11000, 1000)` (python/radio.py:49) — this pins
    ours."""
    rx = WidebandReceiver(receiver.cfg, n_in=receiver.n_in)
    iq = _dual_scene(rx.n_in) + np.complex64(0.25 * (1 + 0.6j))
    assert [p.nmea for p in rx.decode(iq)] == [SENTENCE_A, SENTENCE_B]


def test_iq_imbalance_image_ghosts_suppressed():
    """Receiver I/Q imbalance (1 dB / 5 deg, IRR ~ -23 dB — a cheap-SDR
    figure) mirrors each channel into the other.  The mirrored conjugate
    GMSK FM-inverts, which differential NRZI decoding cancels, so the
    ghost decodes to the IDENTICAL payload with a VALID CRC on the wrong
    channel.  Post-AGC corr_mag cannot see the 23 dB difference; the
    pre-AGC rssi field can, and suppress_image_ghosts drops the ghosts
    on both the float and wire paths.  image_reject=False restores the
    reference behavior (it would print the ghosts too)."""
    from oracle_modulator import apply_iq_imbalance
    from ais_tpu.ops.convert import host_bytes

    cfg = WidebandConfig()
    rx = WidebandReceiver(cfg)
    iq = apply_iq_imbalance(_dual_scene(rx.n_in), 1.0, 5.0)

    assert [p.nmea for p in rx.decode(iq)] == [SENTENCE_A, SENTENCE_B]

    rx_wire = WidebandReceiver(cfg, n_in=rx.n_in)
    got = rx_wire.decode_wire(host_bytes(iq, "ci8"), "ci8")
    assert [p.nmea for p in got] == [SENTENCE_A, SENTENCE_B]

    # Reference-faithful mode: ghosts present, payload-identical, on the
    # mirror channel at the same anchor, ~IRR (20-26 dB) weaker in rssi.
    rx_off = WidebandReceiver(cfg._replace(image_reject=False), n_in=rx.n_in)
    ghosts = rx_off.decode(iq)
    assert len(ghosts) == 4
    by_pos = {}
    for p in ghosts:
        by_pos.setdefault(p.abs_sample, []).append(p)
    for pos, pair in by_pos.items():
        assert len(pair) == 2
        assert {q.designator for q in pair} == {"A", "B"}
        assert pair[0].payload == pair[1].payload
        lo, hi = sorted(q.rssi for q in pair)
        irr_db = 10 * np.log10(hi / lo)
        assert 18.0 < irr_db < 28.0


def test_rssi_tracks_received_power(receiver):
    """rssi is pre-AGC: two packets 4.4 dB apart in amplitude must show
    ~that ratio, while corr_mag (post-AGC) shows nearly none."""
    rx = WidebandReceiver(receiver.cfg, n_in=receiver.n_in)
    pkts = rx.decode(_dual_scene(rx.n_in))
    assert [p.designator for p in pkts] == ["A", "B"]
    a, b = pkts
    ratio_db = 10 * np.log10(a.rssi / b.rssi)
    # amplitude 1.0 vs 0.6 -> 4.44 dB power ratio (window noise dilutes
    # it slightly).
    assert 3.0 < ratio_db < 5.5
    mag_db = abs(10 * np.log10(a.corr_mag / b.corr_mag))
    assert mag_db < 2.0

"""Independent-oracle parity corpus.

Every capture here is synthesized by `tests/oracle_modulator.py` — a
from-spec transmit chain sharing no code with `ais_tpu` (closed-form
erf GMSK pulse, table-driven CRC, its own HDLC/NRZI) — so a tx/rx
convention error in the package cannot cancel.  The corpus covers the
reference's validation scenarios (capture-driven decode,
python/ais.grc:573) plus impairments: CFO to +-500 Hz, +-50 ppm symbol
clock, multipath, and Eb/N0 spot
checks anchoring the committed BER table (BER.md).
"""

import numpy as np
import pytest

from oracle_modulator import (
    apply_phase_noise,
    apply_rician_fading,
    aivdm_chars_to_bytes,
    apply_cfo,
    apply_clock_offset,
    apply_multipath,
    awgn,
    make_oracle_packet,
)

from ais_tpu.core.params import DemodConfig
from ais_tpu.pipeline import BasebandReceiver

PAYLOAD_STR = "14eG;o@034o8sd<L9i:a;WF>062D"
SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
FS = 48000.0


def _noise(n, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n)) * scale).astype(
        np.complex64
    )


def embed(pkt, n=48000, pos=9000, seed=0, scale=0.01):
    iq = _noise(n, seed=seed, scale=scale)
    iq[pos : pos + pkt.size] += pkt
    return iq


class TestOracleGolden:
    """The canonical sentence through the zero-shared-code transmitter."""

    def test_canonical_sentence_decodes(self):
        payload = aivdm_chars_to_bytes(PAYLOAD_STR)
        pkt = make_oracle_packet(payload, sps=5)
        assert BasebandReceiver().sentences(embed(pkt)) == [SENTENCE]

    def test_type4_base_station_report(self):
        # Type 4: 168 bits; first 6 payload bits 000100.
        rng = np.random.default_rng(4)
        payload = bytes([0x10]) + bytes(rng.integers(0, 256, 20).tolist())
        pkt = make_oracle_packet(payload, sps=5)
        got = BasebandReceiver().process(embed(pkt))
        assert [p.payload for p in got] == [payload]
        assert got[0].nmea.startswith("!AIVDM,1,1,,A,4")

    def test_type5_multifragment_roundtrip(self):
        # Type 5 static/voyage data: 424 bits = 53 octets -> 71 armored
        # chars -> TWO fragments with 2 fill bits (the reference
        # fragments at 56 chars, lib/pdu_to_nmea_impl.cc:99-125).
        rng = np.random.default_rng(5)
        payload = bytes([0x14]) + bytes(rng.integers(0, 256, 52).tolist())
        pkt = make_oracle_packet(payload, sps=5)
        import dataclasses

        from ais_tpu.core.params import DeframerConfig

        rx = BasebandReceiver(deframer=DeframerConfig(max_length_bytes=64))
        got = rx.process(embed(pkt, n=60000))
        assert len(got) == 1
        lines = got[0].nmea.splitlines()
        assert len(lines) == 2
        assert lines[0].startswith("!AIVDM,2,1,,A,")
        assert lines[1].startswith("!AIVDM,2,2,,A,")
        # Round-trip through the oracle's independent de-armoring.
        frag1 = lines[0].split(",")[5]
        frag2 = lines[1].split(",")[5]
        fill = int(lines[1].split(",")[6].split("*")[0])
        assert fill == 2
        assert aivdm_chars_to_bytes(frag1 + frag2, fill) == payload


class TestOracleImpairments:
    @pytest.fixture(scope="class")
    def pkt(self):
        return make_oracle_packet(aivdm_chars_to_bytes(PAYLOAD_STR), sps=5)

    @pytest.mark.parametrize("cfo", [-500.0, -200.0, 200.0, 500.0])
    def test_carrier_frequency_offset(self, pkt, cfo):
        iq = embed(apply_cfo(pkt, cfo, FS))
        got = BasebandReceiver().process(iq)
        assert [p.nmea for p in got] == [SENTENCE]
        # The AFC must actually report the offset (sign convention check,
        # not just survive it): estimates quantize to ~23 Hz bins.
        assert abs(got[0].freq_est_hz - cfo) < 60

    @pytest.mark.parametrize("ppm", [-50.0, -25.0, 25.0, 50.0])
    def test_symbol_clock_offset(self, pkt, ppm):
        # AIS allows 50 ppm transmitter clock error (ITU-R M.1371); the
        # drift-tracking feedforward path must hold lock across a full
        # packet.
        iq = embed(apply_clock_offset(pkt, ppm))
        assert BasebandReceiver().sentences(iq) == [SENTENCE]

    def test_two_ray_multipath(self, pkt):
        iq = embed(apply_multipath(pkt, delay=2, gain=0.3j))
        assert BasebandReceiver().sentences(iq) == [SENTENCE]

    def test_combined_cfo_clock_noise(self, pkt):
        rng = np.random.default_rng(99)
        x = apply_clock_offset(apply_cfo(pkt, 300.0, FS), -30.0)
        iq = embed(awgn(x, 20.0, 5, rng), scale=0.0)
        assert BasebandReceiver().sentences(iq) == [SENTENCE]


class TestOracleSnr:
    """Eb/N0 spot checks anchoring BER.md (tools/ber_sweep.py)."""

    def _success_rate(self, ebn0_db, demod_cfg, n_trials=10):
        payload = aivdm_chars_to_bytes(PAYLOAD_STR)
        pkt = make_oracle_packet(payload, sps=5)
        ok = 0
        for seed in range(n_trials):
            rng = np.random.default_rng(seed)
            iq = np.zeros(48000, np.complex64)
            iq[9000 : 9000 + pkt.size] = pkt
            iq = awgn(iq, ebn0_db, 5, rng)  # noise across the capture
            rx = BasebandReceiver(demod=demod_cfg)
            if rx.sentences(iq) == [SENTENCE]:
                ok += 1
        return ok / n_trials

    def test_discriminator_at_operating_snr(self):
        # The discriminator chain's waterfall sits near 17 dB Eb/N0
        # (~10 dB per-sample SNR at 5 sps — consistent with the ~9 dB
        # figure measured round 1 in per-sample units); 20 dB must be
        # essentially clean.
        assert self._success_rate(20.0, DemodConfig()) >= 0.9

    def test_mlse_gain_over_discriminator(self):
        # The coherent MLSE path decodes where the discriminator cannot
        # (>= 5-6 dB gain measured round 1, now confirmed against the
        # independent waveform: at 13 dB Eb/N0 MLSE is clean, the
        # discriminator decodes nothing).
        mlse = DemodConfig(demod_mode="mlse", corr_threshold=0.4)
        low = 13.0
        assert self._success_rate(low, mlse, n_trials=6) >= 0.8
        assert self._success_rate(low, DemodConfig(), n_trials=6) <= 0.2


class TestOracleChannelEffects:
    """Round-2 corpus widening: co-slot collisions, oscillator phase
    noise, maritime Rician fading, DC offset, Class B payloads — all
    through the zero-shared-code oracle transmitter."""

    @pytest.fixture(scope="class")
    def pkt(self):
        return make_oracle_packet(aivdm_chars_to_bytes(PAYLOAD_STR), sps=5)

    @pytest.mark.parametrize("ci_db", [6.0, 10.0])
    def test_slot_collision_capture(self, pkt, ci_db):
        # Two ships in the same TDMA slot (the long-range collision case
        # SOTDMA cannot prevent): FM capture must hand the slot to the
        # stronger carrier, and the weak interferer must never surface
        # as a CRC-valid wrong packet.
        rng = np.random.default_rng(7)
        interferer = make_oracle_packet(
            bytes([0x04]) + bytes(rng.integers(0, 256, 20).tolist()), sps=5
        )
        iq = embed(pkt)
        w = apply_cfo(interferer, 150.0, FS) * 10 ** (-ci_db / 20)
        iq[9400 : 9400 + w.size] += w.astype(np.complex64)
        assert BasebandReceiver().sentences(iq) == [SENTENCE]

    def test_oscillator_phase_noise(self, pkt):
        # Wiener LO phase noise at 0.02 rad/sample rms step — harsher
        # than any real VHF synthesizer — through the discriminator.
        rng = np.random.default_rng(11)
        iq = embed(apply_phase_noise(pkt, 0.02, rng))
        assert BasebandReceiver().sentences(iq) == [SENTENCE]

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_rician_fading(self, pkt, seed):
        # Maritime LOS + sea-scatter: K = 10 dB, 5 Hz Doppler (a 20 kn
        # vessel at 162 MHz), Jakes sum-of-sinusoids scatter.
        rng = np.random.default_rng(seed)
        iq = embed(apply_rician_fading(pkt, FS, 5.0, 10.0, rng))
        assert BasebandReceiver().sentences(iq) == [SENTENCE]

    def test_dc_offset_baseband(self, pkt):
        # In-band DC (direct-conversion leakage at channel rate); the
        # wideband path instead rejects even large spikes in the
        # channelizer (tests/test_wideband.py:test_sdr_dc_spike_rejected).
        iq = embed(pkt) + np.complex64(0.05 * (1 + 0.5j))
        assert BasebandReceiver().sentences(iq) == [SENTENCE]

    @pytest.mark.parametrize("cfo", [-500.0, 300.0])
    def test_cfo_packet_starting_at_chunk_tail(self, pkt, cfo):
        # A packet whose first samples land in the tail of an AFC chunk
        # leaves that chunk without a confident estimate of its own; the
        # burst's one-constant correction must come from the chunk
        # holding the packet BODY (pipeline/receiver.py) with the gate
        # filling from the NEAREST confident chunk (ops/freq.py) — not a
        # stale hold from the preceding noise.  Positions 2000/3040 start
        # 8-48 samples before a 1024-sample chunk boundary and decoded
        # 300 Hz off (i.e. not at all) before the round-3 fix.
        for pos in (2000, 3040, 9100):
            iq = embed(apply_cfo(pkt, cfo, FS), pos=pos)
            assert BasebandReceiver().sentences(iq) == [SENTENCE], pos

    def test_dc_offset_strong_signal(self, pkt):
        # Squaring a DC offset piles energy into the squared-spectrum DC
        # bin, which the pair search maps to a CONFIDENT bogus
        # -bit_rate/4 = -2.4 kHz estimate; without the DC notch in
        # freqest (ops/freq.py) this derotated every burst in the block
        # into garbage.  Unit-amplitude signal, 0.05 DC — failed pre-fix.
        iq = np.zeros(48000, np.complex64)
        iq[2000 : 2000 + pkt.size] = pkt
        iq += np.complex64(0.05)
        assert BasebandReceiver().sentences(iq) == [SENTENCE]

    def test_real_only_noise_floor(self, pkt):
        # Real-only (non-circular) noise also breaks the squared
        # spectrum's zero mean: E[n^2] != 0 shows up as the same DC
        # spike.  A -60 dB real noise floor killed the decode pre-notch.
        rng = np.random.default_rng(0)
        iq = np.zeros(48000, np.complex64)
        iq[2000 : 2000 + pkt.size] = pkt
        iq += (rng.normal(size=iq.size) * 1e-3).astype(np.complex64)
        assert BasebandReceiver().sentences(iq) == [SENTENCE]

    def test_type18_class_b_report(self):
        # Type 18 (Class B position report, 168 bits): armors to 'B'.
        rng = np.random.default_rng(18)
        payload = bytes([0x48]) + bytes(rng.integers(0, 256, 20).tolist())
        pkt = make_oracle_packet(payload, sps=5)
        got = BasebandReceiver().process(embed(pkt))
        assert [p.payload for p in got] == [payload]
        assert got[0].nmea.startswith("!AIVDM,1,1,,A,B")

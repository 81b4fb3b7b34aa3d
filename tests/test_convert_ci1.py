"""ci1 (sigma-delta 1-bit) wire format: encoder/decoder/e2e.

The ci1 wire carries 4 complex samples per byte.  The encoder is a
first-order sigma-delta modulator (native C++ `sigma_delta_ci1` with a
numpy twin); the device decoder is a plain ±1 map — correctness rests on
the noise shaping placing the quantization noise above the AIS channel
band.  Reference analogue: source format handling
(/root/reference/python/radio.py:151-215) — the reference never had a
sub-8-bit wire; this format exists for ingest links whose bandwidth,
not the ADC, would bind throughput (WIRE.md).
"""

import numpy as np
import pytest

from ais_tpu.ops.convert import (
    CI1_GAIN,
    _sigma_delta_ci1_numpy,
    host_bytes,
    iq_from_bytes_ci1,
)


def _tone(n, f, rate, amp=0.3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = amp * np.exp(2j * np.pi * f * t)
    x += (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.01
    return x.astype(np.complex64)


class TestEncoder:
    def test_native_matches_numpy_twin(self):
        pytest.importorskip("ais_tpu.native")
        from ais_tpu import native

        if not native.available():
            pytest.skip("native lib unavailable")
        iq = _tone(4096, 25e3, 2.4e6)
        rms = float(np.sqrt(0.5 * np.mean(np.abs(iq) ** 2)))
        scale = CI1_GAIN / rms
        got = native.sigma_delta_ci1(iq, scale)
        want = _sigma_delta_ci1_numpy(iq, scale)
        np.testing.assert_array_equal(got, want)

    def test_host_bytes_size_and_values(self):
        iq = _tone(4096, 10e3, 2.4e6)
        wire = host_bytes(iq, "ci1")
        assert wire.dtype == np.uint8 and wire.size == iq.size // 4

    def test_rejects_unaligned(self):
        with pytest.raises(ValueError):
            host_bytes(_tone(4096, 10e3, 2.4e6)[:-2], "ci1")


class TestDecoder:
    def test_levels_and_layout(self):
        # Byte 0b10_01_11_00: samples (+1,-1), (-1,+1), (+1,+1), (-1,-1).
        raw = np.array([0b10011100], np.uint8)
        got = np.asarray(iq_from_bytes_ci1(raw))
        want = np.array([1 - 1j, -1 + 1j, 1 + 1j, -1 - 1j], np.complex64)
        np.testing.assert_array_equal(got, want)

    def test_roundtrip_inband_snr(self):
        """Noise shaping: an in-band tone survives the 1-bit wire with
        >30 dB SNR after low-pass filtering, where unshaped 1-bit
        quantization of the same scene would leave it near 7 dB."""
        from ais_tpu.ops.firdes import low_pass

        rate, f = 2.4e6, 25e3
        iq = _tone(1 << 16, f, rate)
        dec = np.asarray(iq_from_bytes_ci1(host_bytes(iq, "ci1")))
        taps = low_pass(1.0, rate, 36e3, 12e3)
        flt = np.convolve(dec, taps, mode="valid")
        peak = np.percentile(np.abs(np.concatenate([iq.real, iq.imag])), 99.9)
        ref = np.convolve(iq * (CI1_GAIN / peak), taps, mode="valid")
        err = flt - ref
        snr_db = 10 * np.log10(np.mean(np.abs(ref) ** 2) / np.mean(np.abs(err) ** 2))
        assert snr_db > 30.0, snr_db


class TestWidebandE2E:
    def test_wire_path_ci1_decodes(self):
        from ais_tpu.pipeline.wideband import (
            WidebandConfig,
            WidebandReceiver,
            num_taps,
        )
        from ais_tpu.tx import aivdm_payload_to_bytes
        from ais_tpu.tx.scenario import Scenario, ScenarioPacket

        PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
        SENT_A = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
        SENT_B = "!AIVDM,1,1,,B,14eG;o@034o8sd<L9i:a;WF>062D,0*7E"
        cfg = WidebandConfig()
        n48 = cfg.block_len + cfg.core_len
        rx = WidebandReceiver(
            cfg, n_in=(n48 - 1) * cfg.decimation + num_taps(cfg)
        )
        raw = aivdm_payload_to_bytes(PAYLOAD)
        iq = Scenario(
            sample_rate=2.4e6,
            n_samples=rx.n_in,
            noise=0.004,
            packets=[
                ScenarioPacket(raw, 200000, -25e3, phase=0.7),
                ScenarioPacket(raw, 700000, +25e3, amplitude=0.6,
                               extra_freq_hz=140.0),
            ],
        ).build()
        got = rx.decode_wire(host_bytes((iq * 0.7).astype(np.complex64), "ci1"),
                             "ci1")
        assert [p.nmea for p in got] == [SENT_A, SENT_B]

"""cr1 (1-bit fs/4-IF bandpass sigma-delta) wire format.

cr1 carries ONE bit per complex sample — half the ci1 wire — by
encoding the real part of the fs/4-shifted signal with a second-order
bandpass sigma-delta whose noise-shaping notch covers the AIS channels
(ops/convert.py:iq_from_bytes_cr1 for the full rationale).  Reference
analogue: none (the reference ships complex floats between blocks);
this format exists for ingest links whose bandwidth would bind
throughput (WIRE.md).
"""

import numpy as np
import pytest

from ais_tpu.ops.convert import (
    CI1_HEADROOM,
    _sigma_delta_cr1_numpy,
    cr1_wire_nbytes,
    host_bytes,
    iq_from_bytes_cr1,
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
        scale = CI1_HEADROOM / float(np.abs(iq.real).max())
        got = native.sigma_delta_cr1(iq, scale)
        want = _sigma_delta_cr1_numpy(iq, scale)
        np.testing.assert_array_equal(got, want)

    def test_host_bytes_size(self):
        iq = _tone(4096, 10e3, 2.4e6)
        wire = host_bytes(iq, "cr1")
        assert wire.dtype == np.uint8
        assert wire.size == cr1_wire_nbytes(iq.size) == iq.size // 8
        # Padded tail when n % 8 != 0 (the bench geometry has n%8 == 4).
        assert host_bytes(_tone(4100, 10e3, 2.4e6), "cr1").size == 513

    def test_inband_snr_after_channel_filter(self):
        # A tone at +25 kHz must survive the 1-bit encode with enough
        # in-band SNR for packet decode: downconvert, mix the channel to
        # DC, low-pass (the channelizer's job), compare to the clean
        # tone.  The second-order bandpass notch should give >= 25 dB.
        n = 1 << 17
        rate = 2.4e6
        iq = _tone(n, 25e3, rate, amp=0.5, seed=2)
        rec = np.asarray(iq_from_bytes_cr1(host_bytes(iq, "cr1"), n))
        t = np.arange(n) / rate
        base = rec * np.exp(-2j * np.pi * 25e3 * t)
        want = iq * np.exp(-2j * np.pi * 25e3 * t)
        # Brick-wall low-pass via FFT (±11 kHz).
        keep = int(11e3 / rate * n)

        def lp(x):
            X = np.fft.fft(x)
            X[keep : n - keep] = 0
            return np.fft.ifft(X)

        fb, fw = lp(base), lp(want)
        # Match amplitude/phase (the 1-bit level is scale-free).
        g = np.vdot(fb, fw) / np.vdot(fb, fb)
        err = fw - g * fb
        snr_db = 10 * np.log10(np.mean(np.abs(fw) ** 2) / np.mean(np.abs(err) ** 2))
        assert snr_db > 25.0, snr_db


    def test_split_zero_ntf_beats_double_zero(self):
        # CR1_A2 places the NTF zeros (NTF = 1 + a2 z^-2 + z^-4) on the
        # two AIS channels (fs/4 ± 25 kHz) instead of doubling them at
        # fs/4.  Predicted in-band quantization-noise gain at ±25 kHz is
        # ~7 dB; assert the measured in-band SNR improves by >= 3 dB so
        # a regression to the double zero (a2 = 2.0) fails loudly.
        from ais_tpu.ops.convert import CR1_A2

        n = 1 << 16
        rate = 2.4e6
        iq = _tone(n, 25e3, rate, amp=0.5, seed=3)
        scale = 0.6 / float(np.abs(iq.real).max())
        t = np.arange(n) / rate
        keep = int(11e3 / rate * n)

        def inband_snr(a2):
            bits = np.unpackbits(_sigma_delta_cr1_numpy(iq, scale, a2))
            r = bits[:n].astype(np.float32) * 2.0 - 1.0
            # Undo the fs/4 IF: rec[n] = r[n] * (-j)^n → complex baseband.
            rec = r * np.exp(-0.5j * np.pi * np.arange(n))
            base = rec * np.exp(-2j * np.pi * 25e3 * t)
            want = iq * np.exp(-2j * np.pi * 25e3 * t)

            def lp(x):
                X = np.fft.fft(x)
                X[keep : n - keep] = 0
                return np.fft.ifft(X)

            fb, fw = lp(base), lp(want)
            g = np.vdot(fb, fw) / np.vdot(fb, fb)
            err = fw - g * fb
            return 10 * np.log10(
                np.mean(np.abs(fw) ** 2) / np.mean(np.abs(err) ** 2)
            )

        snr_split, snr_double = inband_snr(CR1_A2), inband_snr(2.0)
        assert snr_split - snr_double >= 3.0, (snr_split, snr_double)


class TestDecoder:
    def test_recover_host_twin_matches_device(self):
        from ais_tpu.pipeline.recover import host_iq_from_wire

        iq = _tone(4096, 10e3, 2.4e6)
        wire = host_bytes(iq, "cr1")
        got = host_iq_from_wire(wire, "cr1")
        want = np.asarray(iq_from_bytes_cr1(wire, iq.size))
        np.testing.assert_allclose(got[: iq.size], want, atol=0)


class TestEndToEnd:
    def test_wire_path_cr1_decodes(self):
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
        got = rx.decode_wire(host_bytes((iq * 0.7).astype(np.complex64), "cr1"),
                             "cr1")
        assert [p.nmea for p in got] == [SENT_A, SENT_B]

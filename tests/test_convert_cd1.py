"""cd1 (delta-plane sigma-delta 1-bit) wire format.

cd1 carries exactly the ci1 bit stream, re-framed for compressing
transports: I/Q bit planes separated and first-order delta-coded
(ops/convert.py:ci1_from_bytes_cd1 for the rationale and layout).  The
transform must be exactly invertible — every test here asserts
bit-exactness against the ci1 twin, then the golden e2e.  Reference
analogue: none (the reference ships complex floats between blocks);
this format exists for compressing transports, whose ingest budget is
entropy.
"""

import numpy as np

from ais_tpu.ops.convert import (
    cd1_bytes_from_ci1,
    cd1_wire_nbytes,
    ci1_from_bytes_cd1,
    host_bytes,
    iq_from_bytes_cd1,
    iq_from_bytes_ci1,
)


def _tone(n, f, rate, amp=0.3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = amp * np.exp(2j * np.pi * f * t)
    x += (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.01
    return x.astype(np.complex64)


class TestTransform:
    def test_roundtrip_bit_exact(self):
        # n % 8 == 0: planes pack with no pad.
        iq = _tone(4096, 25e3, 2.4e6)
        ci1 = host_bytes(iq, "ci1")
        cd1 = cd1_bytes_from_ci1(ci1, iq.size)
        assert cd1.size == cd1_wire_nbytes(iq.size) == ci1.size
        back = np.asarray(ci1_from_bytes_cd1(cd1, iq.size))
        np.testing.assert_array_equal(back, ci1)

    def test_roundtrip_with_plane_pad(self):
        # n % 8 == 4 (the bench geometry's case): one pad byte total.
        iq = _tone(4100, 25e3, 2.4e6)
        ci1 = host_bytes(iq, "ci1")
        cd1 = cd1_bytes_from_ci1(ci1, iq.size)
        assert cd1.size == cd1_wire_nbytes(iq.size) == ci1.size + 1
        back = np.asarray(ci1_from_bytes_cd1(cd1, iq.size))
        np.testing.assert_array_equal(back, ci1)

    def test_host_bytes_fmt(self):
        iq = _tone(4096, 10e3, 2.4e6)
        np.testing.assert_array_equal(
            host_bytes(iq, "cd1"),
            cd1_bytes_from_ci1(host_bytes(iq, "ci1"), iq.size),
        )

    def test_iq_decode_matches_ci1(self):
        iq = _tone(4096, 10e3, 2.4e6)
        got = np.asarray(iq_from_bytes_cd1(host_bytes(iq, "cd1"), iq.size))
        want = np.asarray(iq_from_bytes_ci1(host_bytes(iq, "ci1")))
        np.testing.assert_array_equal(got, want)

    def test_recover_host_twin(self):
        from ais_tpu.pipeline.recover import host_iq_from_wire

        iq = _tone(4096, 10e3, 2.4e6)
        got = host_iq_from_wire(host_bytes(iq, "cd1"), "cd1")
        want = host_iq_from_wire(host_bytes(iq, "ci1"), "ci1")
        np.testing.assert_array_equal(got[: iq.size], want)

    def test_compresses_better_than_interleaved(self):
        # The format's reason to exist: on a real modulated scene the
        # delta planes expose run structure a byte-level LZ can use.
        import zlib

        iq = _tone(65536, 25e3, 2.4e6, amp=0.5, seed=3)
        ci1 = host_bytes(iq, "ci1").tobytes()
        cd1 = host_bytes(iq, "cd1").tobytes()
        assert len(zlib.compress(cd1, 1)) < len(zlib.compress(ci1, 1))


class TestEndToEnd:
    def test_wire_path_cd1_decodes(self):
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
        got = rx.decode_wire(host_bytes((iq * 0.7).astype(np.complex64), "cd1"),
                             "cd1")
        assert [p.nmea for p in got] == [SENT_A, SENT_B]

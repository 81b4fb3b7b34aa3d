"""Streaming-continuity and radio/CLI surface tests."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ais_tpu.pipeline import BasebandReceiver
from ais_tpu.pipeline.radio import AisRadio
from ais_tpu.io.sources import FileSource, UdpSource, open_source, read_iq_file
from ais_tpu.tx import aivdm_payload_to_bytes, make_packet_iq

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"


def _noise(n, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n)) * scale).astype(np.complex64)


@pytest.fixture(scope="module")
def packet():
    return make_packet_iq(aivdm_payload_to_bytes(PAYLOAD), samples_per_symbol=5)


class TestStreamingContinuity:
    def test_packet_split_across_calls(self, packet):
        iq = _noise(40000)
        pos = 19500  # the 20k call boundary falls mid-packet
        iq[pos : pos + packet.size] += packet
        rx = BasebandReceiver()
        got = rx.process(iq[:20000]) + rx.process(iq[20000:])
        assert [p.nmea for p in got] == [SENTENCE]
        assert abs(got[0].abs_sample - pos) < 100

    def test_no_duplicates_when_fully_in_first_call(self, packet):
        iq = _noise(40000)
        iq[16000 : 16000 + packet.size] += packet
        rx = BasebandReceiver()
        got = rx.process(iq[:20000]) + rx.process(iq[20000:])
        assert [p.nmea for p in got] == [SENTENCE]

    def test_many_small_chunks(self, packet):
        iq = _noise(60000)
        for pos in (9000, 33000, 50000):
            iq[pos : pos + packet.size] += packet
        rx = BasebandReceiver()
        got = []
        for i in range(0, 60000, 6000):
            got.extend(rx.process(iq[i : i + 6000]))
        assert [p.nmea for p in got] == [SENTENCE] * 3


class TestStreaming250k:
    """The reference's installed default: continuous 250 ksps streaming
    (python/radio.py:120-121).  The fractional-rate resampler must carry
    state across process() calls so boundary-straddling packets decode
    exactly once (round-1 gap: the stateless resampler dropped its tail
    and reset the fractional phase every call)."""

    @pytest.fixture(scope="class")
    def capture_250k(self):
        import jax.numpy as jnp

        from ais_tpu.ops.resample import pfb_arb_resample

        raw = aivdm_payload_to_bytes(PAYLOAD)
        burst48 = make_packet_iq(raw, samples_per_symbol=5)
        sig48 = np.zeros(60000, dtype=np.complex64)
        pos48 = 24000  # ~125000 raw samples: mid-capture
        sig48[pos48 : pos48 + burst48.size] = burst48
        sig250 = np.asarray(pfb_arb_resample(jnp.asarray(sig48), 250.0 / 48.0))
        n = sig250.size
        t = np.arange(n) / 250e3
        iq = _noise(n, seed=7)
        iq += (sig250 * np.exp(-2j * np.pi * 25e3 * t)).astype(np.complex64)
        return iq

    @pytest.mark.parametrize("chunk", [10000, 50000, 124000])
    def test_straddling_packet_decodes_exactly_once(self, capture_250k, chunk):
        from ais_tpu.core.params import ChannelizerConfig, ReceiverConfig
        from ais_tpu.pipeline import ChannelReceiver

        rx = ChannelReceiver(
            ReceiverConfig(
                channelizer=ChannelizerConfig(input_rate=250e3, offset_hz=-25e3)
            )
        )
        assert rx.resample_rate == pytest.approx(0.96)
        got = []
        for i in range(0, capture_250k.size, chunk):
            got.extend(rx.process(capture_250k[i : i + chunk]))
        assert [p.nmea for p in got] == [SENTENCE]

    def test_checkpoint_resume_through_resampler(self, capture_250k):
        from ais_tpu.core.params import ChannelizerConfig, ReceiverConfig
        from ais_tpu.pipeline import ChannelReceiver

        cfg = ReceiverConfig(
            channelizer=ChannelizerConfig(input_rate=250e3, offset_hz=-25e3)
        )
        a = ChannelReceiver(cfg)
        got_a = list(a.process(capture_250k[:100000]))
        state = a.get_state()
        b = ChannelReceiver(cfg)
        b.set_state(state)
        got_a.extend(a.process(capture_250k[100000:]))
        got_b = list(b.process(capture_250k[100000:]))
        # The resumed receiver must finish the straddling packet too.
        assert [p.nmea for p in got_a] == [SENTENCE]
        assert [p.nmea for p in got_b] == [SENTENCE]


class TestRadio:
    def test_dual_channel_wideband(self, packet):
        # 240 ksps wideband with a packet on each channel.
        fs = 240e3
        raw = aivdm_payload_to_bytes(PAYLOAD)
        burst = make_packet_iq(raw, samples_per_symbol=25)
        t = np.arange(burst.size) / fs
        iq = _noise(int(fs), scale=0.005)
        iq[20000 : 20000 + burst.size] += (
            burst * np.exp(-2j * np.pi * 25e3 * t)
        ).astype(np.complex64)
        iq[120000 : 120000 + burst.size] += (
            burst * np.exp(+2j * np.pi * 25e3 * t)
        ).astype(np.complex64)
        radio = AisRadio(sample_rate=fs)
        # 240 ksps decimates integrally to 48 ksps: the radio must pick
        # the fused wideband program (one XLA program for both channels),
        # the same topology the benchmark measures.
        assert radio.uses_fused_wideband
        packets = radio.process(iq) + radio.flush()
        assert [(p.designator) for p in packets] == ["A", "B"]
        assert packets[0].nmea == SENTENCE
        assert packets[1].nmea == SENTENCE.replace(",A,", ",B,").replace("*7D", "*7E")

    def test_radio_run_over_file_source(self, packet, tmp_path):
        fs = 240e3
        raw = aivdm_payload_to_bytes(PAYLOAD)
        burst = make_packet_iq(raw, samples_per_symbol=25)
        t = np.arange(burst.size) / fs
        iq = _noise(int(fs) // 2, scale=0.005)
        iq[100000 : 100000 + burst.size] += (
            burst * np.exp(-2j * np.pi * 25e3 * t)
        ).astype(np.complex64)
        path = tmp_path / "capture.iq"
        iq.tofile(path)
        src = FileSource(path=str(path), sample_rate=fs)
        radio = AisRadio(sample_rate=fs)
        packets = list(radio.run(src, chunk_len=65536))
        assert [p.nmea for p in packets] == [SENTENCE]


class TestIo:
    def test_read_iq_formats(self, tmp_path):
        x = (np.arange(8) - 4 + 1j * (np.arange(8) + 1)).astype(np.complex64) / 10
        p = tmp_path / "a.fc32"
        x.tofile(p)
        np.testing.assert_array_equal(read_iq_file(p, "complex64"), x)

        i16 = np.zeros(16, dtype=np.int16)
        i16[0::2] = np.arange(8) * 1000
        i16[1::2] = -np.arange(8) * 1000
        p16 = tmp_path / "a.ci16"
        i16.tofile(p16)
        y = read_iq_file(p16, "ci16")
        np.testing.assert_allclose(y.real, np.arange(8) * 1000 / 32768.0, atol=1e-6)
        np.testing.assert_allclose(y.imag, -np.arange(8) * 1000 / 32768.0, atol=1e-6)

        u8 = np.full(8, 127, dtype=np.uint8)
        pu8 = tmp_path / "a.cu8"
        u8.tofile(pu8)
        z = read_iq_file(pu8, "cu8")
        assert np.all(np.abs(z) < 0.02)  # 127 ~ midscale

        # ci2 host read mirrors the on-device Lloyd-Max reconstruction.
        from ais_tpu.ops.convert import host_bytes, iq_from_bytes_ci2

        rng = np.random.default_rng(5)
        iq = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
        wire = host_bytes(iq, "ci2")
        p2 = tmp_path / "a.ci2"
        wire.tofile(p2)
        w = read_iq_file(p2, "ci2")
        np.testing.assert_allclose(w, np.asarray(iq_from_bytes_ci2(wire)), atol=1e-6)

        # ci1 host read mirrors the on-device sigma-delta reconstruction.
        from ais_tpu.ops.convert import iq_from_bytes_ci1

        wire1 = host_bytes(iq, "ci1")
        p1 = tmp_path / "a.ci1"
        wire1.tofile(p1)
        w1 = read_iq_file(p1, "ci1")
        np.testing.assert_allclose(w1, np.asarray(iq_from_bytes_ci1(wire1)), atol=1e-6)

        # cr1 host read mirrors the on-device IF-downconverting decode.
        from ais_tpu.ops.convert import iq_from_bytes_cr1

        wirer = host_bytes(iq, "cr1")
        pr = tmp_path / "a.cr1"
        wirer.tofile(pr)
        wr = read_iq_file(pr, "cr1")
        np.testing.assert_allclose(
            wr, np.asarray(iq_from_bytes_cr1(wirer, iq.size)), atol=1e-6
        )

    def test_open_source_dispatch(self, tmp_path):
        f = tmp_path / "x.iq"
        f.write_bytes(b"\0" * 8)
        assert isinstance(open_source(str(f), 48e3), FileSource)
        assert isinstance(open_source("127.0.0.1:5000", 48e3), UdpSource)
        with pytest.raises(RuntimeError):
            open_source("uhd", 48e3)

    def test_file_source_chunking_and_repeat(self, tmp_path):
        x = np.arange(100, dtype=np.complex64)
        p = tmp_path / "s.iq"
        x.tofile(p)
        src = FileSource(path=str(p), sample_rate=48e3)
        chunks = list(src.chunks(64))
        assert [c.size for c in chunks] == [64, 36]
        np.testing.assert_array_equal(np.concatenate(chunks), x)


class TestCli:
    def test_cli_decodes_file(self, tmp_path, packet):
        iq = _noise(48000 * 2)
        iq[30000 : 30000 + packet.size] += packet
        path = tmp_path / "c.iq"
        iq.tofile(path)
        out = subprocess.run(
            [
                sys.executable,
                "-m",
                "ais_tpu.cli.ais_rx",
                "-s",
                str(path),
                "-r",
                "48000",
                "-S",
            ],
            capture_output=True,
            text=True,
            timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert SENTENCE in out.stdout, (out.stdout, out.stderr[-2000:])

    def test_scope_renders_png(self, tmp_path, packet):
        """`ais_scope` is the GRC-GUI replacement (python/ais.grc QT
        sinks): it must render the six diagnostic panels to a PNG from a
        capture with no GUI runtime present."""
        iq = _noise(48000 * 2)
        iq[30000 : 30000 + packet.size] += packet
        path = tmp_path / "c.iq"
        iq.tofile(path)
        png = tmp_path / "scope.png"
        out = subprocess.run(
            [
                sys.executable,
                "-m",
                "ais_tpu.cli.ais_scope",
                "-s",
                str(path),
                "-S",
                "-o",
                str(png),
            ],
            capture_output=True,
            text=True,
            timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu", "MPLBACKEND": "Agg"},
        )
        assert out.returncode == 0, out.stderr[-2000:]
        data = png.read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 20000


class TestRuntimeControls:
    def test_set_threshold_rebuilds(self, packet):
        rx = BasebandReceiver()
        iq = _noise(48000)
        iq[8000 : 8000 + packet.size] += 0.5 * packet
        assert rx.sentences(iq.copy()) == [SENTENCE]
        # Crank the threshold beyond any peak: detection must stop.
        rx.set_threshold(1e6)
        assert rx.get_threshold() == 1e6
        rx2_out = rx.sentences(iq.copy())
        assert rx2_out == []

    def test_radio_pubsub_surface(self):
        radio = AisRadio(sample_rate=240e3)
        assert radio.get_rate() == 240e3
        assert radio.get_gain() == 0.0
        radio.set_gain(20)
        assert radio.get_gain() == 20
        radio.set_threshold(0.5)
        assert radio.get_threshold() == 0.5

    def test_stage_timer(self):
        from ais_tpu.utils.profiling import StageTimer

        t = StageTimer()
        with t.stage("a"):
            pass
        with t.stage("a"):
            pass
        assert t.counts["a"] == 2
        assert "a:" in t.report()


class TestCheckpointResume:
    def test_state_roundtrip_across_restart(self, packet):
        # Decode a stream split at an arbitrary point; snapshot the
        # receiver state at the split, restore into a FRESH receiver, and
        # require identical packets (the reference cannot do this at all:
        # SURVEY.md section 5.4).
        iq = _noise(40000, seed=6)
        pos = 19300  # straddles the split
        iq[pos : pos + packet.size] += packet
        rx = BasebandReceiver()
        first = rx.process(iq[:20000])
        state = rx.get_state()

        rx2 = BasebandReceiver()
        rx2.set_state(state)
        resumed = first + rx2.process(iq[20000:])
        assert [p.nmea for p in resumed] == [SENTENCE]

    def test_cli_mlse_flag(self, tmp_path, packet):
        iq = _noise(48000, scale=0.3, seed=8)
        iq[20000 : 20000 + packet.size] += packet
        path = tmp_path / "weak.iq"
        iq.tofile(path)
        out = subprocess.run(
            [
                sys.executable,
                "-m",
                "ais_tpu.cli.ais_rx",
                "-s",
                str(path),
                "-r",
                "48000",
                "-S",
                "--demod",
                "mlse",
            ],
            capture_output=True,
            text=True,
            timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert SENTENCE in out.stdout, (out.stdout, out.stderr[-1500:])


class TestPpmCorrection:
    """-e ppm handling: the reference tunes hardware to
    162.0e6*(1+ppm*1e-6) (python/radio.py:160); for soft sources the
    channelizer offsets absorb the equivalent shift."""

    def test_offset_math(self):
        from ais_tpu.pipeline.radio import ppm_offset_hz

        assert ppm_offset_hz(0.0) == 0.0
        assert abs(ppm_offset_hz(50.0) - 8100.0) < 1e-6
        assert abs(ppm_offset_hz(-10.0) + 1620.0) < 1e-6

    def _capture_with_ppm(self, ppm):
        # A device with +ppm LO error commanded to 162.0 MHz records a
        # capture whose true center is 162.0e6*(1-ppm*1e-6): channel A
        # (161.975 MHz) appears at -25 kHz + 162e6*ppm*1e-6.
        fs = 240e3
        raw = aivdm_payload_to_bytes(PAYLOAD)
        burst = make_packet_iq(raw, samples_per_symbol=25)
        t = np.arange(burst.size) / fs
        appear_hz = -25e3 + 162.0e6 * ppm * 1e-6
        iq = _noise(int(fs), scale=0.005)
        iq[20000 : 20000 + burst.size] += (
            burst * np.exp(2j * np.pi * appear_hz * t)
        ).astype(np.complex64)
        return iq

    def test_ppm_shifts_recovered_carrier(self):
        ppm = 50.0
        iq = self._capture_with_ppm(ppm)
        corrected = AisRadio(sample_rate=240e3, ppm=ppm)
        got = corrected.process(iq) + corrected.flush()
        assert [p.nmea for p in got] == [SENTENCE]
        # With the offsets corrected, the AFC sees ~no residual carrier.
        assert abs(got[0].freq_est_hz) < 400

        uncorrected = AisRadio(sample_rate=240e3, ppm=0.0)
        got0 = uncorrected.process(iq) + uncorrected.flush()
        if got0:  # the AFC may still pull in an 8.1 kHz offset...
            # ...but the recovered carrier must show the full shift.
            assert abs(got0[0].freq_est_hz - 8100.0) < 400

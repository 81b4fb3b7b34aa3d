"""Burst detection and timing recovery units."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ais_tpu.ops.demod import quadrature_demod, slice_diff_invert
from ais_tpu.sync.corr import autocorr_threshold, detect_bursts, matched_filter
from ais_tpu.sync.timing import msk_timing_recovery
from ais_tpu.tx.gmsk import modulate_bits, preamble_waveform
from ais_tpu.decode.hdlc import deframe
from ais_tpu.tx import aivdm_payload_to_bytes, make_packet_iq

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"


class TestMatchedFilter:
    def test_peak_at_preamble_start(self):
        wf = preamble_waveform(5)
        n = 4096
        x = np.zeros(n, dtype=np.complex64)
        x[1000 : 1000 + wf.size] = wf
        corr = np.asarray(matched_filter(jnp.asarray(x), wf))
        assert np.argmax(np.abs(corr)) == 1000
        # Peak magnitude = preamble energy (|p| = 1 per sample).
        assert abs(np.abs(corr[1000]) - wf.size) < 1.0

    def test_threshold_formula(self):
        wf = preamble_waveform(5)
        # unit-envelope waveform: energy = length
        assert abs(autocorr_threshold(wf, 0.9) - 0.9 * 140.0**2) < 1.0


class TestDetectBursts:
    def _detect(self, mag, **kw):
        corr = jnp.asarray(np.sqrt(mag).astype(np.complex64))
        args = dict(threshold=1.0, nms_radius=10, max_bursts=4, core_len=900)
        args.update(kw)
        return detect_bursts(corr, **args)

    def test_finds_isolated_peaks_in_order(self):
        mag = np.zeros(1000)
        mag[100] = 9.0
        mag[500] = 16.0
        pos, cen, ph, m, valid, n_det = self._detect(mag)
        assert np.asarray(pos)[:2].tolist() == [100, 500]
        assert np.asarray(valid).tolist() == [True, True, False, False]
        np.testing.assert_allclose(np.asarray(m)[:2], [9.0, 16.0])

    def test_threshold_gates(self):
        mag = np.zeros(1000)
        mag[100] = 0.5
        valid = self._detect(mag)[4]
        assert not np.asarray(valid).any()

    def test_nms_keeps_strongest(self):
        mag = np.zeros(1000)
        mag[100] = 9.0
        mag[105] = 10.0  # within radius; stronger wins
        pos, _, _, _, valid, _ = self._detect(mag)
        assert np.asarray(valid).sum() == 1
        assert np.asarray(pos)[0] == 105

    def test_core_fencing(self):
        mag = np.zeros(1000)
        mag[950] = 9.0  # in halo: must be ignored
        valid = self._detect(mag)[4]
        assert not np.asarray(valid).any()

    def test_center_of_mass(self):
        mag = np.zeros(1000)
        mag[99], mag[100], mag[101] = 4.0, 9.0, 4.0
        cen = self._detect(mag)[1]
        assert abs(float(np.asarray(cen)[0])) < 1e-6  # symmetric -> 0
        mag[101] = 8.0
        cen = self._detect(mag)[1]
        assert float(np.asarray(cen)[0]) > 0.05  # skewed right -> positive


class TestTimingRecovery:
    def test_decodes_packet_from_clean_burst(self):
        # Full burst -> symbols -> bits -> CRC-valid frame, for several
        # sub-sample timing seeds.
        raw = aivdm_payload_to_bytes(PAYLOAD)
        iq = make_packet_iq(raw, samples_per_symbol=5)
        burst = np.zeros(4096, dtype=np.complex64)
        burst[1:1 + iq.size] = iq
        for mu0 in [-0.4, 0.0, 0.4]:
            tr = msk_timing_recovery(
                jnp.asarray(burst), jnp.float32(mu0), 5.0, 0.04, 0.01, 400
            )
            bits = np.asarray(
                slice_diff_invert(quadrature_demod(tr.symbols))
            )[np.asarray(tr.valid)]
            frames = deframe(bits)
            assert len(frames) == 1 and frames[0].payload == raw, mu0

    def test_tracks_clock_rate_offset(self):
        # Transmitter clock 0.3% fast (within omega limit 0.01/2.5 = 0.4%):
        # modulate at 5 sps but play at 4.985 samples/symbol via resampling.
        raw = aivdm_payload_to_bytes(PAYLOAD)
        iq15 = make_packet_iq(raw, samples_per_symbol=15)
        # linearly interpolate at stride 2.991 of the 15-sps signal:
        # 15/2.991 = 5.015 samples/symbol, i.e. a 0.3% slow symbol clock.
        stride = 2.991
        idx = np.arange(0, iq15.size - 16, stride)
        i0 = idx.astype(int)
        frac = idx - i0
        iq = (iq15[i0] * (1 - frac) + iq15[i0 + 1] * frac).astype(np.complex64)
        burst = np.zeros(4096, dtype=np.complex64)
        burst[1:1 + iq.size] = iq[: 4095]
        tr = msk_timing_recovery(
            jnp.asarray(burst), jnp.float32(0.0), 5.0, 0.04, 0.01, 400
        )
        bits = np.asarray(slice_diff_invert(quadrature_demod(tr.symbols)))[
            np.asarray(tr.valid)
        ]
        frames = deframe(bits)
        assert len(frames) == 1 and frames[0].payload == raw

    def test_valid_mask_bounds(self):
        burst = jnp.zeros(512, dtype=jnp.complex64)
        tr = msk_timing_recovery(burst, jnp.float32(0.0), 5.0, 0.04, 0.01, 200)
        v = np.asarray(tr.valid)
        # 512 samples at 5 sps ~ 100 symbols; everything past must be masked.
        assert v[:90].all()
        assert not v[105:].any()

    def test_batch_vmap(self):
        raw = aivdm_payload_to_bytes(PAYLOAD)
        iq = make_packet_iq(raw, samples_per_symbol=5)
        burst = np.zeros(4096, dtype=np.complex64)
        burst[1:1 + iq.size] = iq
        bursts = jnp.asarray(np.stack([burst, np.roll(burst, 1)]))
        mus = jnp.asarray([0.0, 0.0], dtype=jnp.float32)
        tr = jax.vmap(
            lambda b, m: msk_timing_recovery(b, m, 5.0, 0.04, 0.01, 400)
        )(bursts, mus)
        for k in range(2):
            bits = np.asarray(
                slice_diff_invert(quadrature_demod(tr.symbols[k]))
            )[np.asarray(tr.valid[k])]
            assert len(deframe(bits)) == 1


class TestFeedforwardFftPath:
    def test_matches_bank_path_and_decodes(self):
        # The feedforward bank-interpolation path decodes a packet at a
        # random offset and carrier phase inside a noisy burst window.
        from ais_tpu.ops.demod import quadrature_demod, slice_diff_invert
        from ais_tpu.sync.feedforward import feedforward_symbols

        raw = aivdm_payload_to_bytes(PAYLOAD)
        iq = make_packet_iq(raw, samples_per_symbol=5)
        for seed in range(3):
            rng = np.random.default_rng(seed)
            burst = (rng.normal(size=4608) + 1j * rng.normal(size=4608)).astype(
                np.complex64
            ) * 0.03
            off = int(rng.integers(0, 400))
            burst[off : off + iq.size] += (iq * np.exp(1j * rng.uniform(0, 6))).astype(
                np.complex64
            )
            s, v = feedforward_symbols(jnp.asarray(burst), 5.0, 900)
            bits = np.asarray(slice_diff_invert(quadrature_demod(s)))
            frames = deframe(bits[np.asarray(v)])
            assert len(frames) == 1 and frames[0].payload == raw, seed

    @pytest.mark.parametrize("ppm", [-50.0, -25.0, 25.0, 50.0])
    def test_decodes_at_50ppm_clock_offset(self, ppm):
        """AIS allows a 50 ppm symbol-clock error (ITU-R M.1371 §2.2).

        The feedforward path fits the drift line across the burst
        (sync/feedforward.py:estimate_timing); this pins a decode at both
        spec extremes and half-way, straight through
        `feedforward_symbols` (the PLL's drift test lives in
        TestMskTimingRecovery)."""
        from ais_tpu.sync.feedforward import feedforward_symbols

        raw = aivdm_payload_to_bytes(PAYLOAD)
        iq15 = make_packet_iq(raw, samples_per_symbol=15)
        # Resample 15 sps -> 5*(1 +/- ppm) samples/symbol by linear
        # interpolation at stride 3*(1 -/+ ppm).
        stride = 3.0 * (1.0 - ppm * 1e-6)
        idx = np.arange(0, iq15.size - 16, stride)
        i0 = idx.astype(int)
        frac = (idx - i0).astype(np.float32)
        iq = (iq15[i0] * (1 - frac) + iq15[i0 + 1] * frac).astype(np.complex64)
        rng = np.random.default_rng(11)
        burst = (rng.normal(size=4608) + 1j * rng.normal(size=4608)).astype(
            np.complex64
        ) * 0.03
        burst[7 : 7 + iq.size] += iq
        s, v = feedforward_symbols(jnp.asarray(burst), 5.0, 900)
        bits = np.asarray(slice_diff_invert(quadrature_demod(s)))[np.asarray(v)]
        frames = deframe(bits)
        assert len(frames) == 1 and frames[0].payload == raw, ppm

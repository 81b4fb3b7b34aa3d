"""The FFT matched filter (sync/corr.py) against a NumPy direct
correlation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ais_tpu.sync.corr import matched_filter
from ais_tpu.tx.gmsk import preamble_waveform


def _numpy_corr(x, p):
    pc = np.conj(np.asarray(p, np.complex128))
    xx = np.asarray(x, np.complex128)
    n, L = xx.shape[-1], pc.size
    out = np.empty(xx.shape[:-1] + (n - L + 1,), np.complex128)
    for idx in np.ndindex(*xx.shape[:-1]):
        out[idx] = np.correlate(xx[idx], np.conj(pc), mode="valid")
    return out


@pytest.fixture(scope="module")
def preamble():
    return preamble_waveform(5, 0.4)


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 4096)) + 1j * rng.normal(size=(3, 4096))).astype(
        np.complex64
    ) * 0.1
    x[0, 500 : 500 + 140] += preamble_waveform(5, 0.4).astype(np.complex64)
    x[2, 3900 : 3900 + 140] += preamble_waveform(5, 0.4).astype(np.complex64)[
        : 4096 - 3900
    ]
    return x


class TestXlaPath:
    def test_matches_numpy(self, signal, preamble):
        got = np.asarray(matched_filter(jnp.asarray(signal), preamble))
        want = _numpy_corr(signal, preamble)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4)

    def test_1d_input(self, signal, preamble):
        got = np.asarray(matched_filter(jnp.asarray(signal[0]), preamble))
        want = _numpy_corr(signal[0], preamble)
        np.testing.assert_allclose(got, want, atol=2e-4)

    def test_non_multiple_of_128_length(self, preamble):
        """A row length that is neither a power of two nor a multiple of
        128 (the FFT pads to the next power of two)."""
        rng = np.random.default_rng(3)
        x = (rng.normal(size=(2, 1000)) + 1j * rng.normal(size=(2, 1000))).astype(
            np.complex64
        )
        got = np.asarray(matched_filter(jnp.asarray(x), preamble))
        want = _numpy_corr(x, preamble)
        np.testing.assert_allclose(got, want, atol=2e-4)


class TestReceiverPaths:
    def test_peak_detection_equivalence(self, signal, preamble):
        """The quantity burst detection consumes — peak position and
        value of |corr|^2 — matches the direct correlation."""
        got = np.abs(np.asarray(matched_filter(jnp.asarray(signal), preamble))[0]) ** 2
        want = np.abs(_numpy_corr(signal, preamble)[0]) ** 2
        assert np.argmax(got) == np.argmax(want) == 500
        assert np.max(got) == pytest.approx(np.max(want), rel=1e-4)

    @pytest.mark.parametrize("at", [0, 1, 8000, 16383 - 140])
    def test_detects_preamble_at_block_positions(self, preamble, at):
        """detect_bursts on the FFT correlator finds a lone preamble at
        the block's first, second, middle and last possible start, at
        the sample NumPy's correlation peaks on (position 0 sits outside
        the accepted core [1, core_len) and must not be reported)."""
        from ais_tpu.core.params import DemodConfig
        from ais_tpu.sync.corr import autocorr_threshold, detect_bursts

        cfg = DemodConfig()
        n = 16384
        rng = np.random.default_rng(at)
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.02
        x[at : at + preamble.size] += preamble
        x = x.astype(np.complex64)
        corr = matched_filter(jnp.asarray(x), preamble)
        pos, _, _, _, valid, n_det = detect_bursts(
            corr, autocorr_threshold(preamble, cfg.resolved_corr_threshold),
            cfg.nms_radius, 4, n,
        )
        want = int(np.argmax(np.abs(_numpy_corr(x, preamble)) ** 2))
        assert want == at
        found = np.asarray(pos)[np.asarray(valid)].tolist()
        assert found == ([] if at == 0 else [at]), (found, int(n_det))


@pytest.mark.parametrize("seed", [0, 1])
def test_demod_batch_shape_both_formulations_match_numpy(seed, preamble):
    """The FFT correlator against a float64 NumPy direct correlation at
    the demod batch's block length (16384 samples), with a few preambles
    per row, by the relative RMS error chip_smoke.py applies on the
    card."""
    rng = np.random.default_rng(seed)
    b, n = 3, 16384
    x = (rng.normal(size=(b, n)) + 1j * rng.normal(size=(b, n))) * 0.1
    for row in range(b):
        for at in rng.integers(0, n - preamble.size, size=4):
            x[row, at : at + preamble.size] += preamble
    x = x.astype(np.complex64)
    want = _numpy_corr(x, preamble)
    scale = np.sqrt(np.mean(np.abs(want) ** 2))
    got = np.asarray(jax.jit(lambda v: matched_filter(v, preamble))(jnp.asarray(x)))
    assert got.shape == want.shape
    err = np.sqrt(np.mean(np.abs(got - want) ** 2)) / scale
    assert err <= 1e-4, err

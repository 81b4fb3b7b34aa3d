"""Timing-recovery mode parity: the feedforward estimator vs
the faithful PLL port, swept across the impairment corpus.

The reference has exactly one timing recovery (the D'Andrea PLL,
lib/msk_timing_recovery_cc_impl.cc:107-206); this build defaults to a
feedforward tone-phase estimator (sync/feedforward.py) and keeps the
PLL as the reference-faithful option.  "Parity on decoded packets"
between the two is asserted here across the conditions AIS hardware
actually produces: carrier offsets to ±500 Hz (after AFC), ±50 ppm
transmitter symbol clocks (ITU-R M.1371 tolerance), two-ray multipath,
amplitude steps, and noise — not just a single clean case.

Waveforms come from the independent from-spec oracle
(tests/oracle_modulator.py), so this is validation against the spec,
not self-parity.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from oracle_modulator import (  # noqa: E402
    apply_cfo,
    apply_clock_offset,
    apply_multipath,
    awgn,
    make_oracle_packet,
)

from ais_tpu.core.params import DemodConfig  # noqa: E402
from ais_tpu.pipeline import BasebandReceiver  # noqa: E402
from ais_tpu.tx import aivdm_payload_to_bytes  # noqa: E402

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
FS = 48_000.0


def _embed(pkt, n=48_000, at=7_000, noise=0.02, seed=7):
    rng = np.random.default_rng(seed)
    iq = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64
    ) * noise
    iq[at : at + pkt.size] += pkt.astype(np.complex64)
    return iq


def _impair(name):
    """The corpus: name -> channel-rate capture with one known packet."""
    pkt = make_oracle_packet(aivdm_payload_to_bytes(PAYLOAD), sps=5)
    if name == "clean":
        return _embed(pkt)
    if name == "cfo+500":
        return _embed(apply_cfo(pkt, 500.0, FS))
    if name == "cfo-500":
        return _embed(apply_cfo(pkt, -500.0, FS))
    if name == "ppm+50":
        return _embed(apply_clock_offset(pkt, 50.0))
    if name == "ppm-50":
        return _embed(apply_clock_offset(pkt, -50.0))
    if name == "multipath":
        return _embed(apply_multipath(pkt, delay=2, gain=0.3j))
    if name == "cfo300+ppm30":
        return _embed(apply_clock_offset(apply_cfo(pkt, 300.0, FS), 30.0))
    if name == "weak":  # 18 dB Eb/N0 in-burst: above the discriminator
        # chain's decode floor but well below the fixed-threshold
        # detection floor the CFAR path fixed (sync/corr.py).
        rng = np.random.default_rng(5)
        iq = np.zeros(48_000, np.complex64)
        iq[7_000 : 7_000 + pkt.size] = pkt
        return awgn(iq, 18.0, 5, rng)
    raise ValueError(name)


CORPUS = [
    "clean",
    "cfo+500",
    "cfo-500",
    "ppm+50",
    "ppm-50",
    "multipath",
    "cfo300+ppm30",
    "weak",
]


def _decode(iq, mode):
    rx = BasebandReceiver(demod=DemodConfig(timing_mode=mode))
    return rx.sentences(iq)


@pytest.mark.parametrize("impairment", CORPUS)
def test_feedforward_pll_packet_parity(impairment):
    """Both modes decode the identical packet set at every corpus point.

    If the feedforward mode ever *beats* the PLL here, tighten this to
    a superset assertion and document the win — as of this round both
    decode 100% of the corpus, so strict equality holds.
    """
    iq = _impair(impairment)
    ff = _decode(iq, "feedforward")
    pll = _decode(iq, "pll")
    assert ff == [SENTENCE], f"feedforward failed at {impairment}"
    assert pll == ff, f"mode divergence at {impairment}: pll={pll}"


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="timing_mode"):
        BasebandReceiver(demod=DemodConfig(timing_mode="bogus"))

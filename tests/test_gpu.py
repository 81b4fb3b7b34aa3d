"""Card-only checks: these need an NVIDIA GPU, skip elsewhere, and are
run on the card by `python chip_smoke.py` (phase card_tests).

Whether a card is present is decided inside the `gpu` fixture, never
while the module is imported.
"""

import numpy as np
import pytest

from ais_tpu.tx import aivdm_payload_to_bytes
from ais_tpu.tx.scenario import Scenario, ScenarioPacket

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
SENTENCE_A = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
SENTENCE_B = "!AIVDM,1,1,,B,14eG;o@034o8sd<L9i:a;WF>062D,0*7E"

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py on the card)")
    return jax.devices()[0]


def _dual_scene(n_in):
    raw = aivdm_payload_to_bytes(PAYLOAD)
    return Scenario(
        sample_rate=2.4e6,
        n_samples=n_in,
        noise=0.004,
        packets=[
            ScenarioPacket(raw, 200000, -25e3, phase=0.7),
            ScenarioPacket(raw, 700000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
        ],
    ).build()


def test_gpu_uses_gpu_formulations(gpu):
    from ais_tpu.core.backend import channelizer_method

    assert channelizer_method() == channelizer_method("gpu") == "fft"


@pytest.mark.parametrize("fmt", [None, "ci8", "cr1"])
def test_dual_channel_decode_on_card(gpu, fmt):
    """The two-channel scene of tests/test_wideband.py decodes on the
    card through the float path (fmt None) and the wire path."""
    from ais_tpu.ops.convert import host_bytes
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver, num_taps

    cfg = WidebandConfig()
    n48 = cfg.block_len + cfg.core_len
    rx = WidebandReceiver(cfg, n_in=(n48 - 1) * cfg.decimation + num_taps(cfg))
    iq = _dual_scene(rx.n_in)
    if fmt is None:
        got = rx.decode(iq)
    else:
        got = rx.decode_wire(host_bytes((iq * 0.7).astype(np.complex64), fmt), fmt)
    assert [p.nmea for p in got] == [SENTENCE_A, SENTENCE_B]

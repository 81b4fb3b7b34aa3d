"""The XLA channelizer against the float64 NumPy reference at the AIS
wideband geometry (2.4 Msps, decimation 50, ±25 kHz), in both
formulations, and every wire format through the device converter plus
channelizer against the float path on the same samples."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ais_tpu.ops.convert import host_bytes
from ais_tpu.ops.cplx import to_planes
from ais_tpu.ops.fir import freq_xlating_polyphase, mixer_phase
from ais_tpu.ops.firdes import low_pass
from ais_tpu.pipeline.recover import host_channelize_span, host_iq_from_wire
from ais_tpu.pipeline.wideband import (
    WidebandConfig,
    channelizer_buffers,
    wire_converter,
)

CFG = WidebandConfig()
TAPS = low_pass(1.0, CFG.input_rate, CFG.cutoff_hz, CFG.transition_hz)
N_IN = 200_000  # a multiple of lcm(decimation, 8)


def _rel_rms(got, want):
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return np.sqrt(np.mean(np.abs(got - want) ** 2) / np.mean(np.abs(want) ** 2))


def _scene(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N_IN)
    x = (rng.normal(size=N_IN) + 1j * rng.normal(size=N_IN)) * 0.15
    for off in CFG.offsets_hz:
        x += 0.4 * np.exp(2j * np.pi * (off + rng.uniform(-5e3, 5e3)) / CFG.input_rate * t)
    return (x * 0.5).astype(np.complex64)


def _channelize(x_planes, start, method=None):
    car, hf = channelizer_buffers(CFG, N_IN)
    ph = np.stack([mixer_phase(o, CFG.input_rate, start) for o in CFG.offsets_hz])
    fn = jax.jit(
        lambda x, p, c, h: freq_xlating_polyphase(
            x, c, p, TAPS, CFG.decimation, h, method=method
        )
    )
    return np.asarray(fn(x_planes, jnp.asarray(ph), jnp.asarray(car), jnp.asarray(hf)))


def _reference(x, start):
    return np.stack(
        [
            host_channelize_span(x, TAPS, off, CFG.input_rate, CFG.decimation, start)
            for off in CFG.offsets_hz
        ]
    )


@pytest.mark.parametrize("method", ["einsum", "fft"])
@pytest.mark.parametrize("seed", [0, 1])
def test_channelizer_matches_float64_reference(seed, method):
    x = _scene(seed)
    start = 4321 * CFG.decimation * (seed + 1)
    got = _channelize(jnp.asarray(to_planes(x)), start, method)
    want = _reference(x, start)
    assert got.shape == want.shape
    assert _rel_rms(got, want) <= 1e-4


@pytest.mark.parametrize("fmt", ["ci16", "ci8", "ci4", "ci2", "ci1", "cd1", "cr1"])
def test_wire_format_through_converter_matches_float_path(fmt):
    """Wire bytes decoded on device and channelized give the float
    path's channels for the same quantized samples (the host twin of
    the converter), and both sit on the float64 reference."""
    x = _scene(3)
    raw = host_bytes(x, fmt)
    conv, n_bytes = wire_converter(fmt, N_IN)
    assert raw.size == n_bytes
    start = 777 * CFG.decimation
    wire = _channelize(conv(jnp.asarray(raw)), start)
    samples = host_iq_from_wire(raw, fmt)[:N_IN]
    flt = _channelize(jnp.asarray(to_planes(samples)), start)
    assert _rel_rms(wire, flt) <= 1e-6
    assert _rel_rms(wire, _reference(samples, start)) <= 1e-4


def test_unknown_wire_format_rejected():
    with pytest.raises(ValueError, match="unsupported wire format"):
        wire_converter("cf64", N_IN)

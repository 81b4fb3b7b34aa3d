"""Burst-table overflow recovery (pipeline/recover.py).

The reference never drops a detection (corr_est's tag stream is
unbounded, lib/corr_est_cc_impl.cc:250-266); the device burst table is
fixed-size, so when a block detects more bursts than the table holds the
receiver must re-demod that block with a larger table instead of losing
traffic.  These tests force a 3x overflow (6 packets, table of 2) and
require 100% decode.
"""

import numpy as np
import pytest

from ais_tpu.core.params import DemodConfig
from ais_tpu.ops.convert import host_bytes, iq_from_bytes_ci1, iq_from_bytes_ci2
from ais_tpu.ops.convert import iq_from_bytes_ci4, iq_from_bytes_ci8
from ais_tpu.ops.convert import iq_from_bytes_ci16, iq_from_bytes_cu8
from ais_tpu.pipeline.recover import host_iq_from_wire
from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver, num_taps
from ais_tpu.tx import aivdm_payload_to_bytes
from ais_tpu.tx.scenario import Scenario, ScenarioPacket

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"


def _overflow_scene(cfg, n_in):
    """Six distinct packets inside block 0's core on channel A — 3x the
    configured burst table."""
    raw = aivdm_payload_to_bytes(PAYLOAD)
    rng = np.random.default_rng(3)
    packets = []
    for k in range(6):
        p = bytearray(raw)
        p[1] = 10 + k
        # Channel-rate spacing 1800 samples (~real AIS slot cadence is
        # wider; this is a deliberate hot block).
        start_chan = 400 + k * 1800
        packets.append(
            ScenarioPacket(
                payload=bytes(p),
                start_sample=start_chan * cfg.decimation,
                offset_hz=float(cfg.offsets_hz[0]),
                phase=float(rng.uniform(0, 2 * np.pi)),
                extra_freq_hz=float(rng.uniform(-100, 100)),
            )
        )
    iq = Scenario(
        sample_rate=cfg.input_rate, n_samples=n_in, packets=packets, noise=0.004
    ).build()
    return iq, packets


def _small_rx(recovery: bool, max_bursts: int = 2):
    cfg = WidebandConfig(
        demod=DemodConfig(max_bursts_per_block=max_bursts),
        overflow_recovery=recovery,
    )
    n48 = cfg.block_len + cfg.core_len  # 2 demod blocks per call
    n_in = (n48 - 1) * cfg.decimation + num_taps(cfg)
    return WidebandReceiver(cfg, n_in=n_in)


def test_overflow_recovery_wire_path():
    rx = _small_rx(recovery=True)
    iq, tx = _overflow_scene(rx.cfg, rx.n_in)
    wire = host_bytes((iq * 0.7).astype(np.complex64), "ci8")
    got = rx.decode_wire(wire, "ci8")
    assert sorted(p.payload for p in got) == sorted(p.payload for p in tx)


def test_overflow_drops_without_recovery(caplog):
    rx = _small_rx(recovery=False)
    iq, tx = _overflow_scene(rx.cfg, rx.n_in)
    wire = host_bytes((iq * 0.7).astype(np.complex64), "ci8")
    import logging

    with caplog.at_level(logging.WARNING, logger="ais_tpu"):
        got = rx.decode_wire(wire, "ci8")
    # The capped table drops traffic (each burst window spans several
    # packets, so some later frames still surface) — and the overflow
    # is loud.
    assert len(got) < len(tx)
    assert any("burst table overflow" in r.message for r in caplog.records)


def test_overflow_recovery_iq_path():
    rx = _small_rx(recovery=True)
    iq, tx = _overflow_scene(rx.cfg, rx.n_in)
    got = rx.decode((iq * 0.7).astype(np.complex64))
    assert sorted(p.payload for p in got) == sorted(p.payload for p in tx)


@pytest.mark.parametrize(
    "fmt,dev",
    [
        ("ci16", iq_from_bytes_ci16),
        ("ci8", iq_from_bytes_ci8),
        ("ci4", iq_from_bytes_ci4),
        ("ci2", iq_from_bytes_ci2),
        ("ci1", iq_from_bytes_ci1),
        ("cu8", iq_from_bytes_cu8),
    ],
)
def test_host_wire_decode_matches_device(fmt, dev):
    """host_iq_from_wire is the bit-exact numpy twin of the on-device
    converters (recovery must see the same samples the device saw)."""
    rng = np.random.default_rng(11)
    iq = (
        rng.normal(size=512, scale=0.3) + 1j * rng.normal(size=512, scale=0.3)
    ).astype(np.complex64)
    wire = host_bytes(iq, fmt)
    want = np.asarray(dev(wire))
    got = host_iq_from_wire(wire, fmt)
    np.testing.assert_array_equal(got, want)


def test_recover_demod_pins_cpu_safe_corr_path(monkeypatch):
    """Overflow recovery executes under jax.default_device(cpu) while
    the process backend reports the accelerator ("gpu"): the escalated
    demod must still compile and run on the CPU device and recover
    every capped packet."""
    import dataclasses

    import jax

    from ais_tpu.pipeline.host import PacketDeduper
    from ais_tpu.pipeline.receiver import jit_burst_demod
    from ais_tpu.pipeline.recover import _recover_demod, recover_overflow_packets

    cfg = WidebandConfig(demod=DemodConfig(max_bursts_per_block=2))
    demod = dataclasses.replace(cfg.demod, samples_per_symbol=cfg.sps)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    jit_burst_demod.cache_clear()
    try:
        _fn, cfg2 = _recover_demod(demod, cfg.block_len, cfg.core_len, 31)
        assert cfg2.max_bursts_per_block >= 31
        n48 = cfg.block_len + cfg.core_len
        n_in = (n48 - 1) * cfg.decimation + num_taps(cfg)
        iq, tx = _overflow_scene(cfg, n_in)
        stats = {"recovered_blocks": 0, "unrecovered_blocks": 0}
        got = recover_overflow_packets(
            (iq * 0.7).astype(np.complex64), 0, cfg, [(0, 0, 6)],
            [PacketDeduper(), PacketDeduper()], stats,
        )
    finally:
        jit_burst_demod.cache_clear()
    assert sorted(p.payload for p in got) == sorted(p.payload for p in tx)
    assert stats == {"recovered_blocks": 1, "unrecovered_blocks": 0}


def test_recovery_without_cpu_device_is_counted(monkeypatch, caplog):
    """With no CPU device the overflowed blocks cannot be re-demodulated:
    that is logged at error level and counted, never silent."""
    import logging

    import jax

    from ais_tpu.pipeline.recover import recover_overflow_packets

    real_devices = jax.devices

    def devices(backend=None):
        if backend == "cpu":
            raise RuntimeError("no cpu backend")
        return real_devices(backend)

    monkeypatch.setattr(jax, "devices", devices)
    stats = {"recovered_blocks": 0, "unrecovered_blocks": 0}
    with caplog.at_level(logging.ERROR, logger="ais_tpu"):
        got = recover_overflow_packets(
            np.zeros(1000, np.complex64), 0, WidebandConfig(),
            [(0, 0, 40), (1, 2, 33)], None, stats,
        )
    assert got == []
    assert stats == {"recovered_blocks": 0, "unrecovered_blocks": 2}
    assert any(r.levelno == logging.ERROR for r in caplog.records)

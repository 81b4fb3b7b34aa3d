"""Dual-channel AIS radio: wideband capture -> channel A + B packets.

Equivalent of the reference's `ais_radio` top block
(reference: python/radio.py:75-98): one source centered at 162.0 MHz
feeds two `ais_rx` paths at -25 kHz (A, 161.975 MHz) and +25 kHz
(B, 162.025 MHz), or a single 0-offset path in single-channel mode.

Topology selection: when the input rate decimates integrally to the
48 ksps channel rate (e.g. 2.4 Msps), both channels run inside ONE fused
XLA program (`WidebandReceiver`: shared channelizer + batched demod) —
the same path the benchmark measures, so app users get the fast
topology, not a per-channel fallback.  Fractional rates (the reference's
250 ksps default) use per-channel `ChannelReceiver`s with the streaming
polyphase resampler.

Frequency-correction (`-e` ppm): the reference compensates hardware LO
error by commanding `162.0e6 * (1 + ppm*1e-6)` (python/radio.py:160,191).
For soft sources the capture was recorded by the *uncorrected* device, so
the true spectrum sits shifted by `-162.0e6 * ppm * 1e-6` relative to the
nominal center; the channelizer offsets absorb the shift instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from ais_tpu.core.params import (
    AIS_CENTER_HZ,
    DemodConfig,
    ReceiverConfig,
    dual_channel_configs,
)
from ais_tpu.io.sources import SampleSource
from ais_tpu.pipeline.api import ChannelReceiver
from ais_tpu.pipeline.host import DecodedPacket

# Channel rate the demodulator runs at (5 sps x 9600 bps).
_CHANNEL_RATE = 48000.0


def ppm_offset_hz(ppm: float, center_hz: float = AIS_CENTER_HZ) -> float:
    """Channelizer-offset correction for a device with `ppm` LO error.

    A device commanded to `center_hz` whose oscillator runs `ppm` high
    actually centers the capture at `center_hz * (1 - ppm*1e-6)`; a
    channel at true frequency f then appears at
    `f - center_hz + center_hz*ppm*1e-6`.  The reference applies the
    equivalent correction at tune time (python/radio.py:160).
    """
    return center_hz * ppm * 1e-6


class AisRadio:
    """Decode both AIS channels from a 162.0 MHz-centered stream."""

    def __init__(
        self,
        sample_rate: float = 250e3,
        single_channel: bool = False,
        block_len: int = 16384,
        demod: DemodConfig | None = None,
        ppm: float = 0.0,
        fused_blocks: int = 8,
    ):
        self.sample_rate = sample_rate
        self.ppm = float(ppm)
        self._demod_override = demod
        self._block_len = block_len
        self._fused_blocks = fused_blocks
        shift = ppm_offset_hz(self.ppm)
        self.wideband = None
        self.rx_paths: list[ChannelReceiver] = []
        decim = sample_rate / _CHANNEL_RATE
        fused_ok = (
            not single_channel
            and abs(decim - round(decim)) < 1e-9
            and round(decim) >= 2
        )
        if fused_ok:
            self.wideband = self._build_wideband(demod)
        elif single_channel:
            cfg = ReceiverConfig().with_offset(0.0 + shift, "A")
            cfg = dataclasses.replace(
                cfg,
                channelizer=dataclasses.replace(
                    cfg.channelizer, input_rate=sample_rate
                ),
            )
            configs = (cfg,)
            if demod is not None:
                configs = tuple(
                    dataclasses.replace(c, demod=demod) for c in configs
                )
            self.rx_paths = [
                ChannelReceiver(c, block_len=block_len) for c in configs
            ]
        else:
            configs = tuple(
                c.with_offset(c.channelizer.offset_hz + shift, c.designator)
                for c in dual_channel_configs(sample_rate)
            )
            if demod is not None:
                configs = tuple(
                    dataclasses.replace(c, demod=demod) for c in configs
                )
            self.rx_paths = [
                ChannelReceiver(c, block_len=block_len) for c in configs
            ]

    def _build_wideband(self, demod: DemodConfig | None):
        from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver, num_taps

        shift = ppm_offset_hz(self.ppm)
        cfg = WidebandConfig(
            input_rate=self.sample_rate,
            offsets_hz=(-25e3 + shift, +25e3 + shift),
            decimation=int(round(self.sample_rate / _CHANNEL_RATE)),
            block_len=self._block_len,
            demod=demod if demod is not None else DemodConfig(),
        )
        n48 = cfg.block_len + cfg.core_len * (self._fused_blocks - 1)
        n_in = (n48 - 1) * cfg.decimation + num_taps(cfg)
        return WidebandReceiver(cfg, n_in=n_in)

    @property
    def uses_fused_wideband(self) -> bool:
        return self.wideband is not None

    def process(self, iq: np.ndarray) -> list[DecodedPacket]:
        if self.wideband is not None:
            return self.wideband.decode(iq)
        packets: list[DecodedPacket] = []
        for rx in self.rx_paths:
            packets.extend(rx.process(iq))
        packets.sort(key=lambda p: p.abs_sample)
        if len(self.rx_paths) > 1:
            from ais_tpu.pipeline.host import suppress_image_ghosts

            packets = suppress_image_ghosts(packets)
        return packets

    # -- pubsub-style runtime controls (reference: python/radio.py:93-149).
    # Gain/rate are hardware-source properties; for file/UDP ingest they
    # are bookkeeping, mirroring the reference's non-live-source behavior
    # (get_gain returns 0, python/radio.py:145-146).

    def set_threshold(self, threshold: float) -> None:
        """Working version of the reference's broken set_threshold
        (python/radio.py:141-143)."""
        if self.wideband is not None:
            demod = dataclasses.replace(
                self.wideband.cfg.demod, corr_threshold=threshold
            )
            self._demod_override = demod
            old = self.wideband
            self.wideband = self._build_wideband(demod)
            # Preserve stream state across the rebuild.
            self.wideband._buf = old._buf
            self.wideband._pos = old._pos
            self.wideband._dedupers = old._dedupers
            return
        for rx in self.rx_paths:
            rx.baseband.set_threshold(threshold)

    def get_threshold(self) -> float:
        if self.wideband is not None:
            return self.wideband.cfg.demod.resolved_corr_threshold
        return self.rx_paths[0].baseband.get_threshold()

    def set_gain(self, gain: float) -> float:
        """Forwarded to a live hardware source when one is attached
        (rtl_tcp tuner gain), mirroring the reference's pubsub "gain"
        subscription commanding the SDR (python/radio.py:93-98,134)."""
        self._gain = gain
        src = getattr(self, "_source", None)
        if src is not None and hasattr(src, "set_gain"):
            src.set_gain(gain)
        return self.get_gain()

    def get_gain(self) -> float:
        return getattr(self, "_gain", 0.0)

    def get_rate(self) -> float:
        return self.sample_rate

    def set_rate(self, rate: float) -> float:
        """Working version of the reference's broken `set_rate`
        (python/radio.py:131-139 references an undefined `rx_path1` and
        calls a method `ais_rx` never defines).  Rebuilds the receive
        topology for the new input rate; stream state does NOT carry
        across a rate change (the sample grid itself changed), matching
        a hardware retune's reality — decoding resynchronizes at the
        next burst preamble, as the reference's self-synchronizing
        design does after any disruption (SURVEY.md §5.4)."""
        if rate == self.sample_rate:
            return self.sample_rate
        self.__init__(
            sample_rate=float(rate),
            single_channel=bool(self.rx_paths) and self.wideband is None
            and len(self.rx_paths) == 1,
            block_len=self._block_len,
            demod=self._demod_override,
            ppm=self.ppm,
            fused_blocks=self._fused_blocks,
        )
        src = getattr(self, "_source", None)
        if src is not None and hasattr(src, "set_sample_rate"):
            src.set_sample_rate(rate)
        return self.sample_rate

    # -- checkpoint / resume ---------------------------------------------
    # Whole-radio snapshot: delegates to the active topology's receivers
    # (WidebandReceiver buf/pos/dedupers, or per-channel ChannelReceiver
    # tails + resampler + baseband carry).  The dict pickles, so a killed
    # process resumes exactly (tests/test_checkpoint.py).

    def get_state(self) -> dict:
        if self.wideband is not None:
            return {"topology": "wideband", "state": self.wideband.get_state()}
        return {
            "topology": "channels",
            "state": [rx.get_state() for rx in self.rx_paths],
        }

    def set_state(self, state: dict) -> None:
        if state["topology"] == "wideband":
            if self.wideband is None:
                raise ValueError("checkpoint is from a fused-wideband radio")
            self.wideband.set_state(state["state"])
            return
        if len(state["state"]) != len(self.rx_paths):
            raise ValueError("checkpoint channel count mismatch")
        for rx, s in zip(self.rx_paths, state["state"]):
            rx.set_state(s)

    def run(
        self,
        source: SampleSource,
        chunk_len: int = 1 << 20,
        on_packet: Callable[[DecodedPacket], None] | None = None,
    ) -> Iterator[DecodedPacket]:
        """Stream from a source, yielding packets as they decode.

        The reference equivalent is `tb.run()` handing control to the GR
        scheduler (apps/ais_rx:19); here the host loop pulls chunks and
        the device pipeline drains them.
        """
        self._source = source
        for chunk in source.chunks(chunk_len):
            for p in self.process(chunk):
                if on_packet is not None:
                    on_packet(p)
                yield p
        for p in self.flush():
            if on_packet is not None:
                on_packet(p)
            yield p

    def flush(self) -> list[DecodedPacket]:
        """Decode any buffered tail at end-of-stream (fused path only;
        the per-channel path processes every chunk fully as it arrives)."""
        if self.wideband is not None:
            return self.wideband.flush()
        return []

"""ais_tpu — an AIS receiver framework in JAX / XLA.

A from-scratch rebuild of the capabilities of the reference receiver gr-ais
(bistromath/gr-ais): RF/IQ ingest -> wideband channelization -> square-and-FFT
frequency offset estimation -> burst AGC -> FFT matched-filter preamble
detection -> MSK timing recovery -> GMSK quadrature demodulation -> NRZI
decode -> HDLC deframing (CRC-16) -> NMEA !AIVDM output.

Unlike the reference (a GNU Radio thread-per-block streaming graph), the
signal chain here is a *batched tensor pipeline* over overlap-save time
blocks: every DSP stage is a pure function over `(batch, time)` tensors,
burst synchronization state rides in explicit per-burst records instead of
stream tags, and the whole front half runs as jitted XLA programs on the
accelerator.

Subpackage map (reference layer -> here):

==========================  =========================================
gr-ais / GNU Radio layer    ais_tpu subpackage
==========================  =========================================
runtime scheduler (L0)      jit'd block pipeline: `ais_tpu.pipeline`
lib/ C++ DSP blocks (L1)    `ais_tpu.ops`, `ais_tpu.sync`
python hier blocks (L4)     `ais_tpu.pipeline`
apps/ais_rx CLI (L5)        `ais_tpu.cli`
sources (UHD/file/UDP)      `ais_tpu.io` (+ native C++ loaders)
hdlc_deframer / pdu_to_nmea `ais_tpu.decode`
gmsk_mod / modulate_vector  `ais_tpu.tx`
(none: new) multi-chip      `ais_tpu.parallel`
==========================  =========================================
"""

__version__ = "0.1.0"

from ais_tpu.core.params import (  # noqa: F401
    AIS_BIT_RATE,
    AIS_CHANNEL_A_HZ,
    AIS_CHANNEL_B_HZ,
    AIS_CENTER_HZ,
    ChannelizerConfig,
    DemodConfig,
    ReceiverConfig,
)

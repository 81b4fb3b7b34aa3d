#!/usr/bin/env python3
"""Which sent packets a multi-step full-load stream misses, and why.

Decodes consecutive full-load bench-geometry wire steps (the stream that
`chip_smoke.py --four-cards` shards) one after another on one device,
three ways:

  fft      — the step grid at 0, the GPU's channelizer (FFT polyphase);
  einsum   — the same grid, the einsum polyphase channelizer;
  shifted  — the FFT channelizer with the step grid moved by `--shift`
             raw samples, so every packet lands elsewhere in its call,
             demod block and AFC chunk.

A packet every run misses is a fault of the receiver chain at that
scene; one only the FFT or only the einsum run misses points at that
channelizer; one the shifted grid decodes depends on where the call
window places it.  Prints one JSON line per run (the missed packets
with step, demod block and offset in the block) and a summary line,
with the device and the card's name and power limit.

    python tools/full_load_misses.py [--steps 4] [--fmt ci8] [--shift 777000]
                                     [--blocks 96]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _describe(t, step: int, cfg, shift: int) -> dict:
    """A missed packet's place in the stream: step, demod block and
    channel-sample offset within that block's core."""
    rel = t.start_sample - shift
    in_step = rel % step
    pos48 = in_step // cfg.decimation
    return {
        "channel": "A" if t.offset_hz < 0 else "B",
        "raw": int(t.start_sample),
        "step": int(rel // step),
        "block": int(pos48 // cfg.core_len),
        "in_block": int(pos48 % cfg.core_len),
        "payload": t.payload.hex(),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--fmt", default="ci8")
    ap.add_argument("--shift", type=int, default=777000)
    ap.add_argument("--blocks", type=int, default=96, help="demod blocks per step")
    args = ap.parse_args(argv)

    import jax

    import chip_smoke
    from ais_tpu.core import backend
    from ais_tpu.pipeline.wideband import WidebandReceiver

    backend.enable_compile_cache()
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": backend.gpu_card(),
    }
    plat = jax.default_backend()

    t0 = time.time()
    cfg, rx, wire, tx = chip_smoke.full_load_stream(
        args.steps, n_blocks=args.blocks, fmt=args.fmt, extra=args.shift
    )
    synth_s = time.time() - t0
    step = rx.step_raw
    runs = {
        "fft": ("fft", 0),
        "einsum": ("einsum", 0),
        "shifted": ("fft", args.shift),
    }
    missed = {}
    for name, (method, shift) in runs.items():
        rx = WidebandReceiver(cfg, n_in=rx.n_in)
        # The shifted grid starts late, so it owns only the packets
        # from `shift` on.
        sent = [t for t in tx if t.start_sample >= shift]
        t0 = time.time()
        found = []
        with mock.patch.dict(backend._CHANNELIZER, {plat: method}):
            for span in chip_smoke.step_spans(rx, wire, args.fmt, args.steps, shift):
                found.extend(rx.decode_wire(span, args.fmt))
        miss = chip_smoke.missed_packets(found, sent)
        missed[name] = {(t.payload, t.offset_hz): t.start_sample for t in miss}
        print(
            json.dumps(
                {
                    "run": name,
                    "channelizer": method,
                    "shift": shift,
                    "sent": len(sent),
                    "decoded": len(found),
                    "missed": [_describe(t, step, cfg, shift) for t in miss],
                    "recovery": dict(rx.recovery_stats),
                    "decode_s": round(time.time() - t0, 1),
                    "device": device,
                }
            ),
            flush=True,
        )
    fft, ein, sh = missed["fft"], missed["einsum"], missed["shifted"]
    fft_owned = {k for k, at in fft.items() if at >= args.shift}
    print(
        json.dumps(
            {
                "summary": True,
                "synth_s": round(synth_s, 1),
                "fft_missed": len(fft),
                "einsum_missed": len(ein),
                "same_misses_fft_einsum": fft.keys() == ein.keys(),
                "fft_misses_the_shifted_grid_owns": len(fft_owned),
                "of_those_decoded_on_shifted_grid": len(fft_owned - sh.keys()),
                "shifted_missed": len(sh),
                "device": device,
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

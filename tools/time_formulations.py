#!/usr/bin/env python3
"""Time the two XLA channelizer formulations at bench geometry.

`ais_tpu.core.backend` keeps one channelizer formulation per platform;
this script measures both candidates on the current device so the table
can be filled from a measurement:

  channelizer — freq_xlating_polyphase, method "fft" vs "einsum", on one
                96-block call (~57 M input samples, both channels), and
                wire decode + channelizer for ci8 and cr1 (one form).

Prints one JSON line per stage: median and spread of warm calls per
candidate (ms, each ending in block_until_ready), compile seconds, and
the device with the card's name and power limit.

    python tools/time_formulations.py [--reps 9]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time(fn, args, reps: int) -> dict:
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return {
        "median_ms": round(float(med), 3),
        "iqr_ms": [round(float(q1), 3), round(float(q3), 3)],
        "compile_and_first_s": round(first, 2),
    }, out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--blocks", type=int, default=96)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ais_tpu.core.backend import enable_compile_cache, gpu_card
    from ais_tpu.ops.cplx import to_planes
    from ais_tpu.ops.fir import freq_xlating_polyphase, mixer_phase
    from ais_tpu.ops.firdes import low_pass
    from ais_tpu.pipeline.wideband import (
        WidebandConfig,
        channelizer_buffers,
        num_taps,
        wire_converter,
    )

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": gpu_card(),
    }
    rng = np.random.default_rng(0)

    def emit(stage, shape, results, diff=None):
        line = {"stage": stage, "shape": shape, "device": device, **results}
        if diff is not None:
            line["rel_rms_between"] = diff
        print(json.dumps(line), flush=True)

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.sqrt(np.mean(np.abs(a - b) ** 2) / np.mean(np.abs(b) ** 2)))

    # Channelizer at the bench call geometry.
    cfg = WidebandConfig()
    n48 = cfg.block_len + cfg.core_len * (args.blocks - 1)
    n_in = (n48 - 1) * cfg.decimation + num_taps(cfg)
    n_in = -(-n_in // 200) * 200
    taps = low_pass(1.0, cfg.input_rate, cfg.cutoff_hz, cfg.transition_hz)
    x = jax.device_put(
        to_planes(
            ((rng.normal(size=n_in) + 1j * rng.normal(size=n_in)) * 0.2).astype(
                np.complex64
            )
        )
    )
    ph = jnp.asarray(
        np.stack([mixer_phase(o, cfg.input_rate, 777) for o in cfg.offsets_hz])
    )
    car, hf = (jax.device_put(b) for b in channelizer_buffers(cfg, n_in))
    res, outs = {}, {}
    for method in ("fft", "einsum"):
        fn = jax.jit(
            lambda x, ph, car, hf, m=method: freq_xlating_polyphase(
                x, car, ph, taps, cfg.decimation, hf, method=m
            )
        )
        res[method], outs[method] = _time(fn, (x, ph, car, hf), args.reps)
    emit("channelizer", [n_in], res, rel(outs["einsum"], outs["fft"]))

    # Wire decode + channelizer: the plain XLA form of a fused ingest
    # stage, in the platform's channelizer formulation.
    res = {}
    for fmt in ("ci8", "cr1"):
        conv, n_bytes = wire_converter(fmt, n_in)
        raw = jax.device_put(
            rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
        )
        fn = jax.jit(
            lambda raw, ph, car, hf, conv=conv: freq_xlating_polyphase(
                conv(raw), car, ph, taps, cfg.decimation, hf
            )
        )
        res[fmt], _ = _time(fn, (raw, ph, car, hf), args.reps)
    emit("wire_decode_channelize", [n_in], res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python
"""One process of a SUSTAINED multi-host streaming decode (tool worker).

Usage:
  multihost_stream_worker.py <coordinator|none> <num_procs> <proc_id>
                             <out.json> [calls] [blocks_per_call]

Joins the jax.distributed group (DCN/TCP), then streams a looping
synthesized capture through `DistributedStreamDecoder` for `calls`
rolling device calls — cross-call carry, absolute positions, and a
persistent deduper all live across calls, so this exercises BASELINE
config 5's "continuous stream", not a one-shot batch.  Packets are
placed so several straddle call boundaries.  Writes sustained
throughput + the decoded packet list (payload hex, position) as JSON;
the harness asserts every process and every mesh shape produced the
identical set.
"""

from __future__ import annotations

import json
import sys
import time


def main() -> int:
    coordinator, num_procs, proc_id, out_path = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
        sys.argv[4],
    )
    calls = int(sys.argv[5]) if len(sys.argv) > 5 else 120
    blocks_per_call = int(sys.argv[6]) if len(sys.argv) > 6 else 32

    import jax

    # The workers run on the CPU backend.
    jax.config.update("jax_platforms", "cpu")
    if coordinator != "none":
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_procs,
            process_id=proc_id,
        )
    import numpy as np

    from ais_tpu.core.params import DemodConfig
    from ais_tpu.parallel.distributed import DistributedStreamDecoder
    from ais_tpu.tx import aivdm_payload_to_bytes, make_packet_iq

    cfg = DemodConfig()
    sd = DistributedStreamDecoder(
        cfg, 16384, blocks_per_call=blocks_per_call
    )
    assert sd.block.n_devices == 8, "harness expects 8 global devices"

    # A looping scene exactly 2 calls long, with packets straddling the
    # call boundary (preamble just before it) and the loop seam; payload
    # bytes vary per loop so the deduper never suppresses a fresh loop.
    pkt_payload = bytearray(aivdm_payload_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D"))
    scene_len = 2 * sd.step
    rng = np.random.default_rng(100)
    noise = ((rng.normal(size=scene_len) + 1j * rng.normal(size=scene_len)) * 0.01).astype(
        np.complex64
    )
    offsets = [
        9_000,
        sd.step - 900,          # straddles the call 0 -> 1 boundary
        sd.step + 50_000,
        scene_len - 1_500,      # straddles the loop seam
    ]

    def _scene(loop_idx: int) -> np.ndarray:
        iq = noise.copy()
        for j, off in enumerate(offsets):
            p = bytearray(pkt_payload)
            p[1] = (loop_idx * 17 + j) % 256
            burst = make_packet_iq(bytes(p), samples_per_symbol=5)
            end = min(scene_len, off + burst.size)
            iq[off:end] += burst[: end - off]
            if end < off + burst.size:  # wrap into the next loop's head
                iq[: off + burst.size - end] += burst[end - off :]
        return iq

    # Pre-synthesize a ring of scenes OUTSIDE the timed window: every
    # process on this one test machine otherwise GMSK-modulates scenes
    # concurrently inside the measurement, and that host-CPU contention
    # (absent on real separate hosts, which each own their cores) was
    # charged to the DCN path.  Payloads repeat with the ring period;
    # positions advance by scene_len per loop, far beyond the dedup
    # window, so the packet stream stays unique-per-loop.
    RING = 6
    ring = [_scene(i) for i in range(RING)]

    def scene(loop_idx: int) -> np.ndarray:
        return ring[loop_idx % RING]

    chunk = sd.step // 3 + 1_013  # deliberately unaligned chunks
    packets = []
    t0 = t0_pos = None
    done_calls = 0
    loop_idx = 0
    warm_calls = 2
    while done_calls < calls + warm_calls:
        iq = scene(loop_idx)
        loop_idx += 1
        for lo in range(0, scene_len, chunk):
            before = sd._pos
            packets.extend(sd.process(iq[lo : lo + chunk]))
            done_calls += (sd._pos - before) // sd.step
            if done_calls >= warm_calls and t0 is None:
                t0 = time.time()  # sustained window starts after warmup
                t0_pos = sd._pos
    dt = time.time() - t0
    consumed = sd._pos - t0_pos
    out = {
        "n_devices": sd.block.n_devices,
        "procs": num_procs,
        "calls": done_calls,
        "sustained_s": dt,
        "consumed_samples": int(consumed),
        "chan_msps": consumed / dt / 1e6,
        "packets": sorted(
            (p.payload.hex(), int(p.abs_sample)) for p in packets
        ),
    }
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

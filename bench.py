#!/usr/bin/env python
"""Headline benchmark: wideband dual-channel AIS decode on one GPU.

Synthesizes a 2.4 Msps capture centered at 162.0 MHz at FULL AIS channel
load — every 26.67 ms TDMA slot on both channels carries a packet with a
distinct payload (~75 packets/s across A+B) — runs the
wire-decode->channelize->AFC->AGC->correlate->timing->bits pipeline on
the device, verifies CONTENT parity (payload bytes + channel + position,
not just position proximity), and reports sustained input throughput.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}
vs_baseline is against the reference's implied operating point —
real-time decode of a 250 ksps capture (SURVEY.md section 6), i.e.
0.25 Msamples/s.  `detail` names the device (platform, device_kind,
device count, card name and power limit).

The measurement runs only on a GPU: on any other platform the script
exits non-zero without a result.  The synthesized wire steps persist in
.bench_cache/ and compiled programs in the persistent compile cache
(ais_tpu.core.backend.enable_compile_cache).
"""

from __future__ import annotations

import json
import os
import signal
import time

BASELINE_MSPS = 0.25  # gr-ais: 2 channels from one 250 ksps SDR, real time
SLOT_SAMPLES_2P4M = 64000  # 26.67 ms AIS TDMA slot at 2.4 Msps

REPO = os.path.dirname(os.path.abspath(__file__))
BENCH_CACHE = os.path.join(REPO, ".bench_cache")
SCENE_VERSION = "v2"  # bump when _scene / encoder constants change
# v2: cr1 encoder NTF zeros split onto the two channels (CR1_A2)

# Wall-clock budget for the measurement windows: windows stop once less
# than this remains.
BUDGET_S = float(os.environ.get("AIS_TPU_BENCH_BUDGET_S", "1500"))
DEADLINE = time.time() + BUDGET_S


def _remaining() -> float:
    return DEADLINE - time.time()


WIRE_FMT = os.environ.get("AIS_TPU_WIRE_FMT", "cr1")
#   cr1: fs/4-IF bandpass sigma-delta at ONE bit per complex sample —
#   half the bytes of ci1 (8 samples/byte vs 4), with a noise-shaping
#   notch that keeps the in-band quantization noise out of both AIS
#   channels.  Impairment corpus: tests/test_wire_corpus.py; headroom
#   and sensitivity: WIRE.md; 28 dB near-far envelope:
#   tests/test_wideband.py; auto-fallback guard:
#   convert.select_wire_format.  ci1 (2 bits/sample) remains for
#   sensitivity-critical deployments below ~18 dB Eb/N0; cd1 is
#   entropy-shaped ci1; ci2/ci4 for front ends without a sigma-delta
#   path; ci8/ci16/cu8 are what SDRs emit.

# Distinct step contents cycled through every window: a real SDR stream
# never repeats bytes, so the bench must not hand the device the same
# buffer twice in a row.
N_WIRES = 4


def _scene(cfg, n_in, n_core):
    """Full-load TDMA scene: distinct payloads in every slot, both channels.

    Packets are confined to the call's core span `n_core` (= step_raw):
    a packet starting in the trailing halo belongs to the NEXT stream
    step by the overlap-save ownership rule and cannot be decoded by a
    single call.
    """
    import numpy as np

    from ais_tpu.tx import aivdm_payload_to_bytes
    from ais_tpu.tx.scenario import Scenario, ScenarioPacket

    base = bytearray(aivdm_payload_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D"))
    rng = np.random.default_rng(7)
    packets = []
    burst_len = 62500 + 2000  # ~231 bits at 250 sps + ramp margin
    for ci, off in enumerate(cfg.offsets_hz):
        slot0 = 3000 + ci * 17000  # de-phase the two channels' slot grids
        k = 0
        while slot0 + k * SLOT_SAMPLES_2P4M + burst_len < n_core:
            p = bytearray(base)
            # Distinct payload per packet: vary MMSI-ish bytes.
            p[1] = (k * 7 + ci) % 256
            p[2] = (k * 131) % 256
            p[3] = (k >> 8) % 256
            packets.append(
                ScenarioPacket(
                    payload=bytes(p),
                    start_sample=slot0 + k * SLOT_SAMPLES_2P4M,
                    offset_hz=float(off),
                    phase=float(rng.uniform(0, 2 * np.pi)),
                    extra_freq_hz=float(rng.uniform(-200, 200)),
                )
            )
            k += 1
    iq = Scenario(
        sample_rate=cfg.input_rate, n_samples=n_in, packets=packets, noise=0.004
    ).build()
    return iq, packets


def _load_wires(cfg, n_in, step_raw):
    """Wire steps + tx packet list for the full-load scene, disk-cached.

    Scene synthesis (GMSK-modulating ~1200 packets into a 37.9 Msample
    capture) plus N_WIRES sigma-delta encodes costs minutes of host
    time; it is deterministic, so a warm bench loads it in ~1 s.
    """
    import numpy as np

    key = f"{SCENE_VERSION}_{WIRE_FMT}_{n_in}_{N_WIRES}"
    path = os.path.join(BENCH_CACHE, f"scene_{key}.npz")
    if os.path.exists(path):
        try:
            z = np.load(path, allow_pickle=True)
            wires = [z[f"wire{k}"] for k in range(N_WIRES)]
            pk = z["packets"]  # (n, 3) object array: payload, start, off
            from ais_tpu.tx.scenario import ScenarioPacket

            tx_packets = [
                ScenarioPacket(
                    payload=bytes(p), start_sample=int(s), offset_hz=float(o)
                )
                for p, s, o in pk
            ]
            return wires, tx_packets
        except Exception:  # noqa: BLE001 — rebuild below
            pass

    from ais_tpu.ops.convert import host_bytes

    iq, tx_packets = _scene(cfg, n_in, step_raw)
    iq = (iq * 0.7).astype("complex64")
    # N_WIRES distinct step contents: circular shifts by a prime offset
    # (every packet stays inside the core span; the sigma-delta restarts
    # so the bytes differ everywhere).
    wires = [
        host_bytes(np.roll(iq, 977 * k) if k else iq, WIRE_FMT)
        for k in range(N_WIRES)
    ]
    try:
        os.makedirs(BENCH_CACHE, exist_ok=True)
        np.savez(
            path + ".tmp.npz",
            packets=np.array(
                [(p.payload, p.start_sample, p.offset_hz) for p in tx_packets],
                dtype=object,
            ),
            **{f"wire{k}": w for k, w in enumerate(wires)},
        )
        os.replace(path + ".tmp.npz", path)
    except Exception:  # noqa: BLE001 — cache is an optimization only
        pass
    return wires, tx_packets


def _content_parity(found, tx_packets, decim):
    """Fraction of transmitted packets decoded with exact payload bytes on
    the right channel near the right position."""
    chan_of = {-25e3: "A", 25e3: "B"}
    by_key: dict = {}
    for fp in found:
        by_key.setdefault((fp.payload, fp.designator), []).append(fp.abs_sample)
    matched = 0
    for tp in tx_packets:
        want_pos = tp.start_sample // decim
        positions = by_key.get((tp.payload, chan_of.get(tp.offset_hz, "A")), [])
        hit = next(
            (i for i, pos in enumerate(positions) if abs(pos - want_pos) < 300),
            None,
        )
        if hit is not None:
            matched += 1
            positions.pop(hit)
    return matched / max(len(tx_packets), 1)


def _geometry(n_blocks: int | None = None):
    """(WidebandConfig, n_in) of one benched device call."""
    import dataclasses

    from ais_tpu.pipeline.wideband import WidebandConfig, num_taps

    # Right-size the burst table: full TDMA load measures up to 17
    # detections per (channel, block) (one per 26.67 ms slot in an
    # 11760-channel-sample core, plus correlator double-fires) — K=16
    # trips overflow recovery at host cost, so K=24 carries the measured
    # peak with ~40% margin; overflow recovery (pipeline/recover.py)
    # backstops pathological blocks instead of dropping packets.
    cfg = WidebandConfig()
    cfg = cfg._replace(
        demod=dataclasses.replace(cfg.demod, max_bursts_per_block=24)
    )
    # Valid-lane d2h compaction (pipeline/wideband.py:pack_wire_compact):
    # full load measures ~11 valid lanes per (channel, block), so 14 per
    # (channel, block) holds the peak with ~25% margin.  The bound
    # scales with the call geometry; steps beyond it re-demod the
    # affected blocks via overflow recovery.  AIS_TPU_COMPACT_LANES=0
    # restores the dense fetch.
    # 96 demod blocks per device call (~24 s of air time).  The call
    # geometry has not been re-derived on the GPU yet (ROADMAP A6).
    if n_blocks is None:
        n_blocks = int(os.environ.get("AIS_TPU_BENCH_BLOCKS", "96"))
    cl = int(
        os.environ.get("AIS_TPU_COMPACT_LANES", str(14 * 2 * n_blocks))
    )
    cfg = cfg._replace(compact_lanes=cl)
    n48 = cfg.block_len + cfg.core_len * (n_blocks - 1)
    n_in = (n48 - 1) * cfg.decimation + num_taps(cfg)
    return cfg, n_in


def _split(stats: dict | None) -> dict | None:
    """Render a collect_stats dict as per-step ms + fetch fraction."""
    if not stats or not stats.get("steps"):
        return None
    n = stats["steps"]
    tot = stats["fetch_s"] + stats["host_s"]
    return {
        "exec_ms_per_step": round(stats["exec_s"] / n * 1e3, 1),
        "fetch_ms_per_step": round(stats["fetch_s"] / n * 1e3, 1),
        "host_ms_per_step": round(stats["host_s"] / n * 1e3, 1),
        "fetch_frac_of_collect": round(stats["fetch_s"] / tot, 3) if tot else None,
        "steps": n,
    }


_BEST: dict | None = None  # latest complete result


def _on_term(signum, frame):  # noqa: ARG001 — signal API
    """External kill: print the best result so far, if any."""
    if _BEST is not None:
        print(json.dumps(_BEST), flush=True)
        os._exit(0)
    os._exit(1)


def _result(msps, parity, extra: dict) -> dict:
    detail = {
        "wire_format": WIRE_FMT,
        "realtime_multiple_at_2p4Msps": round(msps / 2.4, 1),
        "packet_parity_warmup": round(parity, 4),
    }
    detail.update(extra)
    if parity < 1.0:
        detail["warning"] = "packet parity below 1.0"
    return {
        "metric": "wideband_iq_msamples_per_sec_per_chip",
        "value": round(msps, 2),
        "unit": "Msamples/s (2.4 Msps dual-channel AIS decode, end-to-end)",
        "vs_baseline": round(msps / BASELINE_MSPS, 1),
        "detail": detail,
    }


def measure() -> dict:
    """The GPU measurement; returns the result dict."""
    global _BEST
    import jax

    from ais_tpu.core.backend import enable_compile_cache, gpu_card

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"bench.py measures a GPU; JAX reports {devices[0].platform!r} "
            f"({devices})"
        )
    enable_compile_cache()

    from ais_tpu.pipeline.wideband import WidebandReceiver

    cfg, n_in = _geometry()
    rx = WidebandReceiver(cfg, n_in=n_in)
    n_in = rx.n_in  # decim-aligned

    t0 = time.time()
    wires, tx_packets = _load_wires(cfg, n_in, rx.step_raw)
    scene_s = time.time() - t0

    # Warm-up: compile + content-parity check.
    t0 = time.time()
    found = rx.decode_wire(wires[0], WIRE_FMT)
    compile_s = time.time() - t0
    parity = _content_parity(found, tx_packets, cfg.decimation)

    base_detail = {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": gpu_card(),
        "tx_packets_per_call": len(tx_packets),
        "n_in_per_call": n_in,
        "scene_s": round(scene_s, 1),
        "compile_s": round(compile_s, 1),
    }

    # Steady state, two loop shapes per window:
    #   serial   — submit/collect one step at a time;
    #   depth-2  — submit N+1 before collecting N, overlapping host
    #     decode with device compute.
    iters, max_windows = 8, 3

    def run_window(depth: int):
        pkts, host_s, sub = 0, 0.0, 0

        def submit():
            nonlocal sub
            h = rx.submit_wire(wires[sub % N_WIRES], WIRE_FMT)
            sub += 1
            return h

        t0 = time.time()
        pending = [submit() for _ in range(depth)]
        done = 0
        while pending:
            th = time.time()
            pkts += len(rx.collect(pending.pop(0)))
            host_s += time.time() - th
            done += 1
            if done + len(pending) < iters:
                pending.append(submit())
        return time.time() - t0, pkts, host_s

    windows: list[float] = []  # per-window msps
    best = None  # (dt, pkts, host_s, depth, split)
    for _w in range(max_windows):
        for depth in (1, 2):
            rx.reset_collect_stats()
            dt, pkts, host_s = run_window(depth)
            windows.append(n_in * iters / dt / 1e6)
            if best is None or dt < best[0]:
                best = (dt, pkts, host_s, depth, dict(rx.collect_stats))
            _BEST = _result(
                n_in * iters / best[0] / 1e6, parity,
                {**base_detail, "window_msps": [round(v, 1) for v in windows]},
            )
        if _remaining() < 90:
            break
    best_dt, total_pkts, host_s, best_depth, best_split = best
    msps = n_in * iters / best_dt / 1e6
    median = sorted(windows)[len(windows) // 2]
    return _result(
        msps,
        parity,
        {
            **base_detail,
            "packets_per_sec": round(total_pkts * msps * 1e6 / (n_in * iters), 1),
            "median_msps": round(median, 2),
            "window_msps": [round(v, 1) for v in windows],
            "collect_frac": round(host_s / best_dt, 3),
            "collect_split": _split(best_split),
            "recovery": dict(rx.recovery_stats),
            "pipeline_depth": best_depth,
        },
    )


def main() -> int:
    signal.signal(signal.SIGTERM, _on_term)
    try:
        result = measure()
    except Exception as e:  # noqa: BLE001 — report, exit non-zero
        print(json.dumps({"error": f"{type(e).__name__}: {e}"[:300]}), flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke check of the wideband AIS receiver on an NVIDIA GPU.

Drives the main decode path once at bench geometry — a 2.4 Msps capture
at 162.0 MHz with both AIS channels (±25 kHz), full ITU-R M.1371 TDMA
load, 96 demod blocks (~57 M input samples) per device call — compares
each device stage with its plain float64 NumPy reference, and runs the
`ais_rx` command line on a synthesized RTL-SDR capture.  Everything is
generated from fixed seeds.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the 4-card time-mesh phase and
                                       # its single-device comparison only

Phases (one card):
  device   — JAX must report a GPU; prints the card's name and power limit
  golden   — BasebandReceiver decodes the published AIVDM example
  stages   — channelizer and correlator within 1e-4 relative RMS of
             float64 NumPy; one-hot burst extraction bit-exact
  scene    — full-load scene through WidebandReceiver.decode_wire in ci8
             and cr1: content parity 1.0, identical payloads
  ais_rx   — ais_rx on a cu8 capture prints exactly the sent sentences
  card_tests — the tests marked `gpu` (tests/test_gpu.py), in-process

The last line of standard output is, on success only,
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
The script exits non-zero without that line when JAX finds no GPU or any
phase fails.  Times it prints are single-call smoke timings, not
benchmark numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
GOLDEN = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
REL_RMS_LIMIT = 1e-4  # float32 at HIGHEST reads ~1e-6; a TF32 product ~1e-3
SINGLE_CARD_PHASES = ("golden", "stages", "scene", "ais_rx", "card_tests")


def phases(four_cards: bool) -> tuple[str, ...]:
    """The phases a run executes, after the device check."""
    return ("mesh",) if four_cards else SINGLE_CARD_PHASES


def ok_line(devices) -> str:
    """The contract's last line for `devices` (jax.devices())."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": devices[0].platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
            },
        }
    )


def rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    """RMS of the error relative to the RMS of the reference."""
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(
        np.sqrt(np.mean(np.abs(got - want) ** 2) / np.mean(np.abs(want) ** 2))
    )


def _bench():
    sys.path.insert(0, REPO)
    import bench

    return bench


# -- stage checks against the plain reference --------------------------------


def check_channelizer(cfg, n_in: int, seed: int = 0, span: int = 4096) -> float:
    """Relative RMS error of the platform's channelizer on one `n_in`
    call against the float64 NumPy mixer + FIR
    (pipeline/recover.py:host_channelize_span), over three output spans
    (start, middle, end) of each channel."""
    import jax

    from ais_tpu.ops.cplx import to_planes
    from ais_tpu.ops.firdes import low_pass
    from ais_tpu.ops.fir import mixer_phase
    from ais_tpu.pipeline.recover import host_channelize_span
    from ais_tpu.pipeline.wideband import channelizer_buffers, make_wideband_fns

    rng = np.random.default_rng(seed)
    t = np.arange(n_in)
    x = (rng.normal(size=n_in) + 1j * rng.normal(size=n_in)) * 0.2
    for off in cfg.offsets_hz:  # in-band content on both channels
        x += 0.5 * np.exp(2j * np.pi * (off + 3e3) / cfg.input_rate * t)
    x = x.astype(np.complex64)
    start = 12345 * cfg.decimation  # a stream position with nonzero phase
    phase0s = np.stack(
        [mixer_phase(off, cfg.input_rate, start) for off in cfg.offsets_hz]
    )
    chan, _ = make_wideband_fns(cfg, n_in)
    car, hf = channelizer_buffers(cfg, n_in)
    got = np.asarray(
        jax.jit(chan)(
            to_planes(x), phase0s, jax.device_put(car), jax.device_put(hf)
        )
    )
    taps = low_pass(1.0, cfg.input_rate, cfg.cutoff_hz, cfg.transition_hz)
    n_out = got.shape[-1]
    span = min(span, n_out)
    gots, wants = [], []
    for c, off in enumerate(cfg.offsets_hz):
        for j0 in (0, (n_out - span) // 2, n_out - span):
            i0 = j0 * cfg.decimation
            seg = x[i0 : i0 + (span - 1) * cfg.decimation + taps.size]
            wants.append(
                host_channelize_span(
                    seg, taps, off, cfg.input_rate, cfg.decimation, start + i0
                )
            )
            gots.append(got[c, j0 : j0 + span])
    return rel_rms(np.concatenate(gots), np.concatenate(wants))


def check_correlator(batch: int = 192, n: int = 16384, seed: int = 0) -> float:
    """Relative RMS error of the matched filter on a (batch, n) demod
    batch against a NumPy direct correlation."""
    import jax

    from ais_tpu.sync.corr import matched_filter
    from ais_tpu.tx.gmsk import preamble_waveform

    p = np.asarray(preamble_waveform(5, 0.4), np.complex128)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, n)) + 1j * rng.normal(size=(batch, n))) * 0.1
    for row in range(batch):
        at = rng.integers(0, n - p.size)
        x[row, at : at + p.size] += p
    x = x.astype(np.complex64)
    got = np.asarray(jax.jit(lambda v: matched_filter(v, p))(x))
    want = np.stack(
        [np.correlate(row.astype(np.complex128), p, mode="valid") for row in x]
    )
    return rel_rms(got, want)


def check_extraction(
    batch: int = 192, k: int = 24, block_len: int = 16384,
    grid: int = 512, win_len: int = 4608, seed: int = 0,
) -> bool:
    """One-hot burst extraction (pipeline/receiver.py:extract_windows)
    bit-exact against NumPy slicing."""
    import jax

    from ais_tpu.pipeline.receiver import extract_windows

    rng = np.random.default_rng(seed)
    a = (
        rng.normal(size=(batch, block_len)) + 1j * rng.normal(size=(batch, block_len))
    ).astype(np.complex64)
    win_idx = rng.integers(0, block_len // grid, size=(batch, k)).astype(np.int32)
    got, _ = jax.jit(lambda v, w: extract_windows(v, w, grid, win_len))(a, win_idx)
    padded = np.concatenate([a, np.zeros((batch, win_len), np.complex64)], axis=1)
    want = np.stack(
        [
            padded[b, w * grid : w * grid + win_len]
            for b in range(batch)
            for w in win_idx[b]
        ]
    )
    return bool(np.array_equal(np.asarray(got), want))


# -- phases -------------------------------------------------------------------


def phase_golden() -> None:
    from ais_tpu.pipeline import BasebandReceiver
    from ais_tpu.tx import aivdm_payload_to_bytes, make_packet_iq

    iq0 = make_packet_iq(aivdm_payload_to_bytes(GOLDEN_PAYLOAD), 5)
    rng = np.random.default_rng(1)
    cap = ((rng.normal(size=20000) + 1j * rng.normal(size=20000)) * 0.02).astype(
        np.complex64
    )
    cap[5000 : 5000 + iq0.size] += iq0.astype(np.complex64)
    got = BasebandReceiver().sentences(cap)
    print(f"golden: {got}")
    if got != [GOLDEN]:
        raise AssertionError(f"expected [{GOLDEN}]")


def phase_stages(cfg, n_in: int) -> None:
    from ais_tpu.core.backend import channelizer_method

    print(f"stages: channelizer formulation {channelizer_method()!r}")
    t0 = time.time()
    err = check_channelizer(cfg, n_in)
    print(f"stages: channelizer n_in={n_in} rel_rms={err:.3e} ({time.time() - t0:.1f} s)")
    cerr = check_correlator()
    print(f"stages: correlator (192, 16384) rel_rms={cerr:.3e}")
    exact = check_extraction()
    print(f"stages: one-hot extraction (192 blocks, K=24) bit_exact={exact}")
    if not (err <= REL_RMS_LIMIT and cerr <= REL_RMS_LIMIT and exact):
        raise AssertionError("a stage is outside its reference tolerance")


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: not available"
    keys = (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
    )
    return "memory_analysis: " + ", ".join(
        f"{k}={getattr(m, k)}" for k in keys if hasattr(m, k)
    )


def phase_scene(n_blocks: int = 96) -> None:
    import jax

    from ais_tpu.ops.convert import host_bytes
    from ais_tpu.pipeline.wideband import WidebandReceiver

    bench = _bench()
    cfg, n_in = bench._geometry(n_blocks)
    rx = WidebandReceiver(cfg, n_in=n_in)
    t0 = time.time()
    iq, tx = bench._scene(cfg, rx.n_in, rx.step_raw)
    iq = (iq * 0.7).astype(np.complex64)
    print(
        f"scene: {len(tx)} packets, n_in={rx.n_in}, "
        f"synthesized in {time.time() - t0:.1f} s"
    )
    decoded = {}
    for fmt in ("ci8", "cr1"):
        raw = host_bytes(iq, fmt)
        rx.reset_dedup()
        staged = rx.stage_wire(raw, fmt, pos=0)
        t0 = time.time()
        compiled = (
            rx._wire_fns[fmt].lower(staged[0], staged[1], rx._carriers, rx._hf)
            .compile()
        )
        compile_s = time.time() - t0
        t0 = time.time()
        found = rx.collect(rx.dispatch_wire(staged))
        first_s = time.time() - t0
        parity = bench._content_parity(found, tx, cfg.decimation)
        rx.reset_dedup()
        t0 = time.time()
        rx.decode_wire(raw, fmt)
        warm_s = time.time() - t0
        stats = jax.devices()[0].memory_stats() or {}
        print(
            f"scene {fmt}: parity={parity} decoded={len(found)} "
            f"compile {compile_s:.1f} s, first call {first_s:.1f} s; "
            f"smoke timing (one warm call, not a benchmark) {warm_s:.3f} s; "
            f"peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}; "
            f"recovery={rx.recovery_stats}"
        )
        print(f"scene {fmt}: {_memory_line(compiled)}")
        if parity != 1.0:
            raise AssertionError(f"{fmt} content parity {parity} != 1.0")
        decoded[fmt] = sorted((p.designator, p.payload) for p in found)
    if decoded["ci8"] != decoded["cr1"]:
        raise AssertionError("ci8 and cr1 decoded different payloads")
    print(f"scene: ci8 and cr1 payloads identical ({len(decoded['ci8'])})")


def phase_ais_rx(seconds: float = 6.0) -> None:
    from ais_tpu.cli import ais_rx
    from ais_tpu.decode.nmea import frame_to_nmea
    from ais_tpu.ops.convert import host_bytes
    from ais_tpu.tx import aivdm_payload_to_bytes
    from ais_tpu.tx.scenario import Scenario, ScenarioPacket

    rate = 2.4e6
    n = int(seconds * rate)
    base = bytearray(aivdm_payload_to_bytes(GOLDEN_PAYLOAD))
    packets, want = [], set()
    for k in range(8):
        p = bytearray(base)
        p[1], p[2] = 40 + k, 3 * k
        chan = "AB"[k % 2]
        packets.append(
            ScenarioPacket(
                bytes(p), int((0.2 + 0.6 * k) * rate),
                -25e3 if chan == "A" else 25e3, amplitude=0.5, phase=0.4 * k,
            )
        )
        want.add(frame_to_nmea(bytes(p), chan))
    iq = Scenario(sample_rate=rate, n_samples=n, packets=packets, noise=0.02).build()
    path = os.path.join(REPO, ".bench_cache", "smoke_capture.cu8")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    host_bytes(iq, "cu8").tofile(path)
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = ais_rx.main(["-s", path, "-r", str(int(rate)), "-F", "cu8"])
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("!AIVDM")]
    print(
        f"ais_rx: rc={rc} {len(lines)} sentences from a {seconds:.0f} s cu8 "
        f"capture in {time.time() - t0:.1f} s; first: {lines[:1]}"
    )
    if rc != 0 or sorted(lines) != sorted(want):
        raise AssertionError(
            f"ais_rx printed {sorted(set(lines) ^ want)} beyond/instead of "
            f"the {len(want)} sent sentences"
        )


def phase_card_tests() -> None:
    import pytest

    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:xdist",
         os.path.join(REPO, "tests", "test_gpu.py")]
    )
    print(f"card_tests: pytest exit code {int(rc)}")
    if rc != 0:
        raise AssertionError("a card test failed")


def full_load_stream(n_steps: int, n_blocks: int = 96, fmt: str = "ci8",
                     extra: int = 0):
    """A full-load capture long enough for `n_steps` consecutive
    bench-geometry wire steps plus `extra` raw samples, with every sent
    packet starting in the first `n_steps` step cores.  Returns (cfg,
    rx, wire, tx): a fresh WidebandReceiver, the capture's wire bytes in
    `fmt`, and the sent ScenarioPackets."""
    from ais_tpu.ops.convert import host_bytes
    from ais_tpu.pipeline.wideband import WidebandReceiver

    bench = _bench()
    cfg, n_in = bench._geometry(n_blocks)
    rx = WidebandReceiver(cfg, n_in=n_in)
    n_in, step = rx.n_in, rx.step_raw
    total = extra + step * n_steps + (n_in - step)
    iq, tx = bench._scene(cfg, total, step * n_steps)
    return cfg, rx, host_bytes((iq * 0.7).astype(np.complex64), fmt), tx


def step_spans(rx, wire, fmt: str, n_steps: int, shift: int = 0) -> list:
    """The wire bytes of `n_steps` consecutive steps of `rx`'s geometry
    (each `rx.n_in` samples, `rx.step_raw` apart), the first starting
    `shift` raw samples into `wire`."""
    from ais_tpu.pipeline.wideband import wire_converter

    per = wire_converter(fmt, 8)[1] / 8  # wire bytes per sample
    starts = [shift + d * rx.step_raw for d in range(n_steps)]
    return [
        np.array(wire[int(a * per) : int((a + rx.n_in) * per)]) for a in starts
    ]


def missed_packets(found, tx) -> list:
    """The sent packets that `found` holds no decode of (same payload
    and channel; payloads are distinct within a scene)."""
    got = {(p.payload, p.designator) for p in found}
    return [
        t for t in tx if (t.payload, "A" if t.offset_hz < 0 else "B") not in got
    ]


def mesh_packet_sets(n_dev: int, n_blocks: int = 96, fmt: str = "ci8"):
    """Decode `n_dev` consecutive wire steps of one full-load stream two
    ways: one after another on one device, and as one program sharded
    over an `n_dev`-device time mesh (parallel/pipeline.py:
    make_sharded_wire_pipeline).  Returns (single, sharded, parity of
    each set against the sent packets)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ais_tpu.ops.fir import mixer_phase
    from ais_tpu.parallel import make_sharded_wire_pipeline, make_time_mesh
    from ais_tpu.pipeline.wideband import channelizer_buffers

    bench = _bench()
    cfg, rx, wire, tx = full_load_stream(n_dev, n_blocks, fmt)
    spans = step_spans(rx, wire, fmt, n_dev)
    n_in, step = rx.n_in, rx.step_raw
    single = []
    for span in spans:
        single.extend(rx.decode_wire(span, fmt))

    mesh = make_time_mesh(n_dev)
    fn = make_sharded_wire_pipeline(cfg, n_in, mesh, fmt=fmt)
    car, hf = channelizer_buffers(cfg, n_in)
    ph = np.stack(
        [
            [mixer_phase(off, cfg.input_rate, d * step) for off in cfg.offsets_hz]
            for d in range(n_dev)
        ]
    )
    shard = NamedSharding(mesh, P("time"))
    out = np.asarray(
        fn(
            jax.device_put(np.stack(spans), shard),
            jax.device_put(ph, shard),
            jax.device_put(car),
            jax.device_put(hf),
        )
    )
    rx.reset_dedup()
    sharded = []
    for d in range(n_dev):
        sharded.extend(
            rx.decode_fetched(
                (out[d], d * step // cfg.decimation, spans[d], fmt, d * step)
            )
        )

    def key(pkts):
        return sorted((p.payload, p.abs_sample, p.designator) for p in pkts)

    parity = {
        "single": bench._content_parity(single, tx, cfg.decimation),
        "sharded": bench._content_parity(sharded, tx, cfg.decimation),
    }
    for name, found in (("single", single), ("sharded", sharded)):
        for t in missed_packets(found, tx)[:12]:
            print(
                f"mesh: {name} missed sent packet at raw {t.start_sample} "
                f"(step {t.start_sample // step}, +{t.start_sample % step}) "
                f"offset {t.offset_hz:+.0f} Hz"
            )
    print(f"mesh: recovery {rx.recovery_stats}")
    return key(single), key(sharded), parity


def phase_mesh(n_dev: int = 4) -> None:
    t0 = time.time()
    single, sharded, parity = mesh_packet_sets(n_dev)
    exact = sharded == single
    print(
        f"mesh: {n_dev}-device time mesh, ci8, {len(sharded)} packets sharded "
        f"vs {len(single)} single-device; identical={exact}; "
        f"parity against the sent packets {parity}; {time.time() - t0:.1f} s"
    )
    if not exact:
        a, b = set(single), set(sharded)
        for name, only in (("single only", a - b), ("sharded only", b - a)):
            print(f"mesh: {name} ({len(only)}):")
            for payload, pos, chan in sorted(only, key=lambda t: t[1])[:24]:
                print(f"  {chan} @{pos} {payload.hex()}")
        raise AssertionError("sharded packet set differs from single-device")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the 4-card time-mesh phase and its comparison",
    )
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX reports {devices[0].platform!r}",
            file=sys.stderr,
        )
        return 1
    from ais_tpu.core.backend import enable_compile_cache, gpu_card

    print(f"card: {gpu_card()}")
    print(f"devices: {len(devices)} x {devices[0].device_kind}")
    if args.four_cards and len(devices) < 4:
        print("chip_smoke: --four-cards needs 4 devices", file=sys.stderr)
        return 1
    print(f"compile cache: {enable_compile_cache()}")

    cfg, n_in = _bench()._geometry(96)
    align = int(np.lcm(cfg.decimation, 8))  # as WidebandReceiver aligns
    n_in = -(-n_in // align) * align
    run = {
        "golden": phase_golden,
        "stages": lambda: phase_stages(cfg, n_in),
        "scene": phase_scene,
        "ais_rx": phase_ais_rx,
        "card_tests": phase_card_tests,
        "mesh": phase_mesh,
    }
    failed = []
    for name in phases(args.four_cards):
        t0 = time.time()
        try:
            run[name]()
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failed.append(name)
            print(f"FAIL {name} ({time.time() - t0:.1f} s)")
        else:
            print(f"PASS {name} ({time.time() - t0:.1f} s)")
        sys.stdout.flush()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(ok_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python
"""SUSTAINED multi-host streaming decode measurement (BASELINE config 5).

The round-2 scaling number was one 128-block batch; this harness runs a
continuous rolling-call stream (DistributedStreamDecoder: cross-call
carry, absolute positions, persistent deduper, packets straddling call
boundaries) for many device calls on two mesh shapes at equal global
devices:

  1 process  x 8 local devices   (no process boundary)
  2 processes x 4 local devices  (jax.distributed over TCP = DCN path)

and reports SUSTAINED throughput (warmup calls excluded) plus the
efficiency ratio.  Throughput is in channel-rate Msps consumed by the
sharded demod; the input-rate-equivalent column scales by the
wideband channelizer's decimation (50) — per-host channelization is
embarrassingly parallel and measured separately (bench.py), so the
quantity the multi-host layer adds is exactly what this times.

Packet-set equality is asserted between processes AND between mesh
shapes (the straddle packets decode exactly once everywhere).

Usage: python tools/multihost_streaming.py [--calls 120] [--blocks 32]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_stream_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(local_devices: int) -> dict:
    # The children run on the CPU backend.
    return {
        **os.environ,
        "PYTHONPATH": REPO,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={local_devices}",
    }


def run_config(n_procs: int, calls: int, blocks: int, timeout: int = 1800):
    local = 8 // n_procs
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    with tempfile.TemporaryDirectory() as td:
        outs = [os.path.join(td, f"p{i}.json") for i in range(n_procs)]
        procs = [
            subprocess.Popen(
                [
                    sys.executable,
                    WORKER,
                    coordinator if n_procs > 1 else "none",
                    str(n_procs),
                    str(i),
                    outs[i],
                    str(calls),
                    str(blocks),
                ],
                env=_env(local),
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                cwd=REPO,
            )
            for i in range(n_procs)
        ]
        for p in procs:
            _stdout, stderr = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"worker rc={p.returncode}: {stderr[-2000:]}")
        results = [json.load(open(o)) for o in outs]
    pk = results[0]["packets"]
    for r in results[1:]:
        if r["packets"] != pk:
            raise RuntimeError("processes decoded different packet sets")
    # The slowest process gates the stream.
    msps = min(r["chan_msps"] for r in results)
    return msps, results[0]["sustained_s"], pk


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=120)
    ap.add_argument("--blocks", type=int, default=32)
    args = ap.parse_args()

    # 1/2/4 processes at EQUAL global devices (8): perfect scaling is a
    # flat line, so efficiency_N = msps_N / msps_1 isolates exactly what
    # the process boundary (jax.distributed over TCP = the DCN path)
    # costs — per-process ingest and the record gather.
    out = {"metric": "multihost_sustained_streaming",
           "calls": args.calls, "blocks_per_call": args.blocks}
    pk_ref = None
    m1 = None
    for n in (1, 2, 4):
        m, t, pk = run_config(n, args.calls, args.blocks)
        if pk_ref is None:
            pk_ref, m1 = pk, m
        elif pk != pk_ref:
            raise RuntimeError(f"{n}-process packet set differs from 1-process")
        out[f"chan_msps_{n}proc"] = round(m, 2)
        out[f"sustained_s_{n}proc"] = round(t, 1)
        if n > 1:
            out[f"efficiency_{n}proc"] = round(m / m1, 3)
            out[f"input_equiv_msps_{n}proc"] = round(m * 50, 1)
    out["sustained_efficiency"] = out["efficiency_2proc"]  # back-compat
    out["packets_per_run"] = len(pk_ref)
    out["packets_equal"] = True
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

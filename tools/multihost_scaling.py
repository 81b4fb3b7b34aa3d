#!/usr/bin/env python
"""Multi-host scaling-efficiency measurement (BASELINE config 5).

Runs the SAME global problem (a fixed stream sharded over 8 CPU devices)
two ways on this machine:

  1 process  x 8 local devices   (no process boundary)
  2 processes x 4 local devices  (jax.distributed over TCP = the DCN path)

Total device count is identical, so perfect scaling means equal wall
time; efficiency = t_1proc / t_2proc isolates exactly the cost the
multi-host design adds — the per-block record all-gather over DCN plus
group setup — which is the quantity BASELINE's >=80% target constrains
(per-host ingest compute is embarrassingly parallel by construction:
the jitted program has no collectives, see
ais_tpu/parallel/distributed.py module docstring).

Usage: python tools/multihost_scaling.py [--blocks 32] [--iters 3]
Prints one JSON line and (with --status) appends nothing — copy the
number into STATUS.md.
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
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


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


def run_config(n_procs: int, blocks: int, iters: int, timeout: int = 900):
    """Launch n_procs workers over a (n_procs x 8/n_procs)-device mesh;
    return the mean steady-state seconds per decode of the global stream."""
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
                    str(blocks),
                    str(iters),
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
            stdout, stderr = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"worker rc={p.returncode}: {stderr[-2000:]}")
        results = [json.load(open(o)) for o in outs]
    assert all(r["n_devices"] == 8 for r in results)
    # Slowest process gates the pipeline.
    return max(r["steady_s"] for r in results), results[0]["packets"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    t1, pk1 = run_config(1, args.blocks, args.iters)
    t2, pk2 = run_config(2, args.blocks, args.iters)
    if pk1 != pk2:
        raise RuntimeError("1-process and 2-process packet sets differ")
    eff = t1 / t2
    print(
        json.dumps(
            {
                "metric": "multihost_scaling_efficiency",
                "value": round(eff, 3),
                "unit": "t_1proc/t_2proc at equal global devices (8)",
                "t_1proc_s": round(t1, 3),
                "t_2proc_s": round(t2, 3),
                "blocks": args.blocks,
                "iters": args.iters,
                "packets_equal": True,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

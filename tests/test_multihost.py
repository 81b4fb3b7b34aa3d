"""Real multi-process distributed decode (VERDICT round-1 item 4).

Round 1 only ever ran one process with 8 virtual devices; this test
launches TWO OS processes that form a jax.distributed group over TCP
(the DCN path), decode one stream over the global 2x4-device `time`
mesh, and must both produce the packet set a single process produces.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env() -> dict:
    # The children run on the CPU backend with 4 virtual devices each.
    return {
        **os.environ,
        "PYTHONPATH": REPO,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
    }


class TestTwoProcessDecode:
    def test_two_processes_match_single_process(self, tmp_path):
        port = _free_port()
        coordinator = f"127.0.0.1:{port}"
        outs = [str(tmp_path / f"p{i}.json") for i in range(2)]
        procs = [
            subprocess.Popen(
                [sys.executable, WORKER, coordinator, "2", str(i), outs[i]],
                env=_worker_env(),
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                cwd=REPO,
            )
            for i in range(2)
        ]
        results = []
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=420)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("multihost worker timed out")
            assert p.returncode == 0, stderr[-3000:]
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))

        # Both processes saw the global mesh and agree exactly.
        for r in results:
            assert r["n_processes"] == 2
            assert r["n_devices"] == 8
            assert r["local_devices"] == 4
        assert results[0]["packets"] == results[1]["packets"]

        # And the distributed result equals a single-process decode of
        # the same stream (this process: 8 virtual devices, 1 process).
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from multihost_worker import synthesize

        from ais_tpu.parallel.distributed import DistributedBlockDecoder

        dec = DistributedBlockDecoder()
        iq, _ = synthesize(dec.core_len * 8)
        expected = [
            {"nmea": p.nmea, "abs_sample": p.abs_sample}
            for p in dec.decode_stream(iq)
        ]
        assert len(expected) == 4  # incl. the shard-boundary straddler
        assert results[0]["packets"] == expected

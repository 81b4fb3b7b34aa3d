"""chip_smoke.py on the CPU: it refuses to run without a GPU, its last
line is the exact contract, its reference comparisons pass at a small
size, and --four-cards selects the mesh phase alone.  The full run
needs the card (python chip_smoke.py)."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_cpu_platform():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, SCRIPT], capture_output=True, text=True,
        timeout=300, env=env, cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_last_line_contract(smoke):
    line = smoke.ok_line(jax.devices())
    assert json.loads(line) == {
        "ok": True,
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        },
    }
    assert "\n" not in line


def test_reference_checks_pass_small(smoke):
    from ais_tpu.pipeline.wideband import WidebandConfig, num_taps

    cfg = WidebandConfig()
    n_in = (cfg.block_len - 1) * cfg.decimation + num_taps(cfg)
    n_in = -(-n_in // 200) * 200
    assert smoke.check_channelizer(cfg, n_in, span=2048) <= smoke.REL_RMS_LIMIT
    assert smoke.check_correlator(batch=2) <= smoke.REL_RMS_LIMIT
    assert smoke.check_extraction(batch=2, k=5)


def test_four_cards_selects_mesh_phase_only(smoke):
    assert smoke.phases(four_cards=True) == ("mesh",)
    assert "mesh" not in smoke.phases(four_cards=False)

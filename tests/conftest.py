"""Test environment: the JAX CPU backend with 8 virtual devices, so
multi-device sharding paths run without accelerator hardware (see
SURVEY.md section 4 on the rebuilt test strategy).

Both are defaults: an explicit JAX_PLATFORMS or device-count flag in the
environment wins.  Tests that need a GPU carry the `gpu` marker and skip
elsewhere (tests/test_gpu.py); `python chip_smoke.py` runs them on the
card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

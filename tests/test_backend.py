"""Platform -> channelizer formulation table, compile-cache helper, and
matmul precision on the device programs (ais_tpu/core/backend.py)."""

import os

import jax
import numpy as np
import pytest

from ais_tpu.core.backend import channelizer_method, enable_compile_cache


@pytest.mark.parametrize("platform,want", [("cpu", "einsum"), ("gpu", "fft")])
def test_known_platforms(platform, want, monkeypatch):
    assert channelizer_method(platform) == want
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert channelizer_method() == want


@pytest.mark.parametrize("platform", ["tpu", "metal-unknown"])
def test_unknown_platforms_raise(platform, monkeypatch):
    with pytest.raises(ValueError, match=platform):
        channelizer_method(platform)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(ValueError, match=platform):
        channelizer_method()


@pytest.fixture
def restore_cache_config():
    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_env_set(monkeypatch, tmp_path, restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets no directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a closed jaxpr, sub-jaxprs
    included."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for p in eqn.params.values():
                for sub in p if isinstance(p, (tuple, list)) else (p,):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _all_highest(precisions):
    hi = jax.lax.Precision.HIGHEST
    return all(
        p is not None and tuple(p) == (hi, hi) for p in precisions
    )


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_burst_demod_dots_are_highest(platform, monkeypatch):
    """A float32 dot without a precision may run as TF32 on a GPU; every
    dot of the burst demod (one-hot extraction, RSSI, per-burst
    frequency) asks for HIGHEST, whichever platform the backend
    reports."""
    from ais_tpu.core.params import DemodConfig
    from ais_tpu.pipeline.receiver import make_burst_demod, required_halo

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    cfg = DemodConfig()
    block_len = 16384
    fn = make_burst_demod(cfg, block_len, block_len - required_halo(cfg))
    x = jax.ShapeDtypeStruct((2, block_len, 2), np.float32)
    prec = _dot_precisions(jax.make_jaxpr(fn)(x))
    assert prec and _all_highest(prec), prec


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_wideband_wire_program_dots_are_highest(platform, monkeypatch):
    from ais_tpu.ops.convert import host_bytes
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver, num_taps

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    cfg = WidebandConfig()._replace(compact_lanes=56)
    rx = WidebandReceiver(
        cfg, n_in=(cfg.block_len - 1) * cfg.decimation + num_taps(cfg)
    )
    raw = host_bytes(np.zeros(rx.n_in, np.complex64), "ci8")
    buf, ph, *_ = rx.stage_wire(raw, "ci8")
    prec = _dot_precisions(
        jax.make_jaxpr(rx._wire_fns["ci8"])(buf, ph, rx._carriers, rx._hf)
    )
    assert prec and _all_highest(prec), prec

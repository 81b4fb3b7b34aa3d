"""Sharded block demodulation via shard_map over a device mesh.

Sequence parallelism for a streaming signal (SURVEY.md sections 2.4, 5.7):
the stream is framed into overlap-save blocks `(n_blocks, block_len)`
stepped by `core_len`, each block carrying its own halo.  Sharding the
block axis over the mesh's `time` axis makes every device decode its
blocks independently — the halo duplication at framing time replaces any
runtime neighbor exchange, so the jitted program contains zero
collectives and scales linearly.  The dedup rule (a burst belongs to the
block whose *core* holds its preamble start) guarantees each packet is
decoded exactly once across devices.

A second `stream` mesh axis shards independent IQ streams (many
captures decoded in one batch).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ais_tpu.core.params import DemodConfig
from ais_tpu.pipeline.receiver import make_burst_demod


def make_sharded_demod(
    cfg: DemodConfig,
    block_len: int,
    core_len: int,
    mesh: jax.sharding.Mesh,
    time_axis: str = "time",
):
    """(n_blocks, block_len) -> BurstRecords with leading block axis,
    block axis sharded over `time_axis`.  n_blocks must be a multiple of
    the mesh axis size."""
    demod = make_burst_demod(cfg, block_len, core_len)  # batch-native
    fn = shard_map(
        demod,
        mesh=mesh,
        in_specs=P(time_axis),
        out_specs=P(time_axis),
    )
    return jax.jit(fn)


def make_halo_exchange_demod(
    cfg: DemodConfig,
    block_len: int,
    core_len: int,
    mesh: jax.sharding.Mesh,
    n_blocks: int,
    time_axis: str = "time",
):
    """Sharded demod over HALO-FREE framing: `(n_blocks, core_len)` disjoint
    cores in, halos exchanged between neighbor shards with `ppermute`
    inside the jitted program.

    The default path (`make_sharded_demod`) duplicates each block's halo
    at framing time: simple, collective-free, but ships
    `block_len / core_len` (~1.4x) more bytes to the devices and stores
    the duplicates in device memory.  This variant feeds each device only its
    disjoint core samples; each shard rebuilds its blocks from the local
    contiguous stream plus ONE ring `ppermute` carrying the first `halo`
    samples of the next shard (inter-device traffic: halo/core ~ 3% of
    the ingest).  The trailing shard's last block wraps to shard 0's head —
    callers pad the stream tail with noise/zeros, which the overlap-save
    ownership rule ignores anyway.

    Returns a jitted fn: planes `(n_blocks, core_len, 2)` float32 ->
    BurstRecords, bit-identical to the duplication path (tested in
    test_parallel.py).
    """
    halo = block_len - core_len
    if halo > core_len:
        raise ValueError("halo exceeds core_len: one-neighbor exchange breaks")
    n_shards = mesh.shape[time_axis]
    if n_blocks % n_shards:
        raise ValueError(f"n_blocks {n_blocks} not divisible by {n_shards}")
    local = n_blocks // n_shards
    demod = make_burst_demod(cfg, block_len, core_len)
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def fn(planes):  # local shard: (local, core_len, 2)
        from ais_tpu.ops.cplx import from_planes

        flat = planes.reshape(local * core_len, 2)
        head = flat[:halo]
        # Ring exchange: every shard sends its stream head to the
        # previous shard, which needs it as its last block's halo.
        recv = jax.lax.ppermute(head, time_axis, perm)
        ext = jnp.concatenate([flat, recv], axis=0)
        idx = (
            jnp.arange(local)[:, None] * core_len
            + jnp.arange(block_len)[None, :]
        )
        return demod(from_planes(ext[idx]))  # (local, block_len) complex

    sharded = shard_map(
        fn, mesh=mesh, in_specs=P(time_axis), out_specs=P(time_axis),
    )
    return jax.jit(sharded)


def make_sharded_wire_pipeline(
    wcfg,
    n_in: int,
    mesh: jax.sharding.Mesh,
    fmt: str = "cr1",
    time_axis: str = "time",
):
    """Shard the benched wire program — wire-byte decode -> channelize ->
    demod -> d2h record pack — over the mesh's `time` axis.

    Each shard owns one full overlap-save wire step: raw span
    [d*step_raw, d*step_raw + n_in), the same step contract as
    `WidebandReceiver.submit_wire`, so the program needs zero collectives —
    halos are duplicated at framing time and the core-ownership rule
    partitions the packet set.  Per-shard mixer phases ride in as a
    sharded (n_shards, n_offsets) array (phase continuity is a function
    of the absolute stream position, receiver.stage_wire).

    `wcfg` is a WidebandConfig; honors `wcfg.compact_lanes` so the
    sharded fetch is the same compacted payload the single-chip bench
    ships.  Returns a jitted fn:
      (raw (n_shards, wire_bytes), phase0s (n_shards, n_off),
       carriers, hf) -> (n_shards, flat_len) uint8
    whose rows decode with WidebandReceiver.decode_fetched — packet-set
    equality vs the single-device stream is asserted in
    tests/test_parallel.py.
    """
    from ais_tpu.pipeline.wideband import (
        make_wideband_fns,
        pack_wire_compact,
        pack_wire_flat,
        wire_converter,
    )

    chan, demod = make_wideband_fns(wcfg, n_in)
    fftlen = wcfg.demod.fftlen
    conv, _ = wire_converter(fmt, n_in)

    def local(raw, ph, car, hf):
        # shard_map hands each shard its (1, ...) block of the sharded
        # leading axis; the wire program is rank-1 per shard.
        rec = demod(chan(conv(raw[0]), ph[0], car, hf))
        flat = (
            pack_wire_compact(rec, fftlen, wcfg.compact_lanes)
            if wcfg.compact_lanes
            else pack_wire_flat(rec, fftlen)
        )
        return flat[None]

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(time_axis), P(time_axis), P(), P()),
        out_specs=P(time_axis),
    )
    return jax.jit(sharded)


def make_sharded_stream_demod(
    cfg: DemodConfig,
    block_len: int,
    core_len: int,
    mesh: jax.sharding.Mesh,
    stream_axis: str = "stream",
    time_axis: str = "time",
):
    """(n_streams, n_blocks, block_len) -> BurstRecords, streams sharded
    over `stream_axis` and blocks over `time_axis`."""
    demod = jax.vmap(make_burst_demod(cfg, block_len, core_len))  # vmap streams; batch-native over blocks
    fn = shard_map(
        demod,
        mesh=mesh,
        in_specs=P(stream_axis, time_axis),
        out_specs=P(stream_axis, time_axis),
    )
    return jax.jit(fn)

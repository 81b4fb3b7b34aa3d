"""Multi-host distributed decode (BASELINE.json config 5).

The reference is strictly single-process (SURVEY.md §2.4).  Here a pod
slice decodes one continuous stream cooperatively:

  - `jax.distributed` forms the process group over DCN;
  - the global mesh is (host, chip) flattened into one `time` axis (or
    (stream, time) when multiple independent streams exist);
  - each host's ingest feeds its local shard of overlap-save blocks —
    because every block carries its own halo from framing, *no sample
    data ever crosses hosts*: the only cross-host traffic is the
    per-block burst-record gather, a few KB/s;
  - the dedup rule (a packet belongs to the block whose core holds its
    preamble start) holds globally, so each packet is decoded exactly
    once across the pod.

Scaling efficiency is therefore bounded only by ingest balance, not by
collective bandwidth — the jitted program contains no collectives.
"""

from __future__ import annotations

import numpy as np

import jax

from ais_tpu.core.params import DemodConfig
from ais_tpu.parallel.mesh import make_time_mesh
from ais_tpu.parallel.pipeline import make_sharded_demod
from ais_tpu.pipeline.receiver import frame_stream, required_halo


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join (or no-op single-process) the jax.distributed process group."""
    if coordinator_address is None:
        return  # single host
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


class DistributedBlockDecoder:
    """Shard a stream's overlap-save blocks over every device in the mesh.

    Single-host multi-chip today; with `init_distributed` the same code
    runs over a multi-host mesh (jax.make_mesh spans all processes'
    devices and each host supplies its local block shard).
    """

    def __init__(
        self,
        demod: DemodConfig = DemodConfig(),
        block_len: int = 16384,
        n_devices: int | None = None,
    ):
        self.cfg = demod
        self.block_len = block_len
        self.core_len = block_len - required_halo(demod)
        self.mesh = make_time_mesh(n_devices)
        self.n_devices = self.mesh.devices.size
        self._fn = make_sharded_demod(demod, block_len, self.core_len, self.mesh)
        # Multi-process: the per-call record gather is the ONLY
        # cross-host traffic, so compact it on device before it rides
        # DCN — the same 8x bit-plane packing the wire path uses
        # (pipeline/wideband.py:pack_wire_records), ~7x smaller than raw
        # BurstRecords.  Sustained rolling-call efficiency lives and
        # dies on this per-call cost (tools/multihost_streaming.py).
        from ais_tpu.pipeline.receiver import burst_table_geometry

        _, self._n_sym = burst_table_geometry(demod)
        self._n_pack = -(-self._n_sym // 8)

        def _pack(rec):
            # ONE gatherable tensor per call: per-block byte rows
            # (block axis stays the sharded axis — no cross-shard
            # reshape, so the jitted program still has zero
            # collectives).  bit_valid rides as its lossless
            # (first, count) run (pack_wire_records valid_as_run) and
            # the AFC chunk table is resolved to per-burst frequencies
            # on device, so the old 4-leaf gather (meta_i, meta_f,
            # 2-plane packed, freq_est) becomes a single allgather of
            # K*(36+n_pack) bytes per block — the r5 profile showed the
            # per-call gather latency, not bandwidth, gating the
            # 2-process sustained efficiency.
            import jax.numpy as jnp

            from ais_tpu.pipeline.wideband import (
                le4_bytes as le4,
                pack_wire_records,
            )

            w = pack_wire_records(rec, demod.fftlen, valid_as_run=True)
            B, K = w.meta_i.shape[:2]
            bi = le4(w.meta_i).reshape(B, K * 24)
            bf = le4(
                jax.lax.bitcast_convert_type(w.meta_f, jnp.int32)
            ).reshape(B, K * 12)
            bp = w.packed.reshape(B, K * self._n_pack)
            return jnp.concatenate([bi, bf, bp], axis=1)

        self._pack = jax.jit(_pack)

    def _unpack(self, flat: np.ndarray):
        """Host inverse of _pack: (B, K*(36+n_pack)) bytes ->
        BurstRecords (center/phase zeroed — nothing downstream of the
        device demod reads them; the freq chunk table is synthesized
        from the per-burst resolved frequencies)."""
        from ais_tpu.pipeline.receiver import BurstRecords

        B = flat.shape[0]
        K = flat.shape[1] // (36 + self._n_pack)
        bi, bf, bp = np.split(flat, [K * 24, K * 36], axis=1)
        meta_i = np.frombuffer(
            np.ascontiguousarray(bi).tobytes(), "<i4"
        ).reshape(B, K, 6)
        meta_f = np.frombuffer(
            np.ascontiguousarray(bf).tobytes(), "<f4"
        ).reshape(B, K, 3)
        bits = np.unpackbits(
            bp.reshape(B, K, self._n_pack), axis=-1
        )[..., : self._n_sym]
        first = meta_i[..., 4:5]
        count = meta_i[..., 5:6]
        idx = np.arange(self._n_sym, dtype=np.int32)
        bit_valid = (idx >= first) & (idx < first + count)
        # Synthesize the chunk table the host deframe loop resolves
        # against: bursts in the same chunk share the same estimate by
        # construction, so scattering per-burst values back is exact.
        n_chunks = self.block_len // self.cfg.fftlen
        freq_est = np.zeros((B, n_chunks), np.float32)
        chunk = np.clip(meta_i[..., 0] // self.cfg.fftlen, 0, n_chunks - 1)
        b_idx = np.broadcast_to(np.arange(B)[:, None], chunk.shape)
        val = meta_i[..., 2].astype(bool)  # only real bursts scatter
        freq_est[b_idx[val], chunk[val]] = meta_f[..., 1][val]
        zeros = np.zeros((B, K), np.float32)
        return BurstRecords(
            position=meta_i[..., 0],
            center=zeros,
            phase=zeros,
            mag=meta_f[..., 0],
            valid=meta_i[..., 2].astype(bool),
            bits=bits,
            bit_valid=bit_valid,
            freq_est=freq_est,
            n_detected=meta_i[:, 0, 3],
            win_start=meta_i[..., 1],
            rssi=meta_f[..., 2],
        )

    def decode_blocks(self, blocks: np.ndarray):
        """(n_blocks, block_len) -> BurstRecords; n_blocks must divide
        evenly over the mesh (pad with zero blocks if needed).

        Multi-process (after `init_distributed`): every process passes
        the same global `blocks` array; each supplies only its local
        shard to the device mesh (`make_array_from_callback` reads just
        the addressable indices), the jitted program runs with zero
        collectives, and the small per-block record tensors are
        all-gathered back to every host over DCN — the only cross-host
        traffic, a few KB per second of signal.
        """
        n = blocks.shape[0]
        pad = (-n) % self.n_devices
        if pad:
            blocks = np.concatenate(
                [blocks, np.zeros((pad, self.block_len), blocks.dtype)]
            )
        from ais_tpu.ops.cplx import to_planes

        sharding = jax.sharding.NamedSharding(
            self.mesh, jax.sharding.PartitionSpec("time")
        )
        planes = to_planes(blocks)
        if jax.process_count() > 1:
            xs = jax.make_array_from_callback(
                planes.shape, sharding, lambda idx: planes[idx]
            )
            w = self._pack(self._fn(xs))  # ONE per-block byte tensor
            from jax.experimental import multihost_utils

            flat = np.asarray(
                multihost_utils.process_allgather(w, tiled=True)
            )
            return self._unpack(flat), n
        xs = jax.device_put(planes, sharding)
        return self._fn(xs), n  # caller slices records back to n blocks

    def decode_stream(self, iq: np.ndarray, designator: str = "A"):
        """Convenience: frame + decode + host-deframe one contiguous array."""
        from ais_tpu.pipeline.host import PacketDeduper, decode_block_records

        blocks = frame_stream(iq, self.block_len, self.core_len)
        records, n = self.decode_blocks(blocks)
        records = jax.tree.map(np.asarray, records)
        dedup = PacketDeduper()
        packets = []
        for b in range(n):
            rec_b = jax.tree.map(lambda a: a[b], records)
            packets.extend(
                decode_block_records(
                    rec_b,
                    b * self.core_len,
                    designator=designator,
                    deduper=dedup,
                    fftlen=self.cfg.fftlen,
                )
            )
        return packets


class DistributedStreamDecoder:
    """SUSTAINED streaming decode over the device mesh (BASELINE
    config 5's "continuous stream", not a one-shot batch).

    Wraps `DistributedBlockDecoder` in a rolling-call harness with
    cross-call state: an input carry (the framing halo re-presented to
    the next call), an absolute stream position, and a persistent
    deduper — so a packet straddling a *call* boundary decodes exactly
    once, the same core-ownership rule that already governs block
    boundaries inside a call.  Every process of a jax.distributed group
    feeds the identical stream; the framing is a strided view (no copy)
    and each process materializes only its addressable block shard
    (`decode_blocks`), so ingest bandwidth per host stays shard-sized.
    """

    def __init__(
        self,
        demod: DemodConfig = DemodConfig(),
        block_len: int = 16384,
        n_devices: int | None = None,
        blocks_per_call: int | None = None,
        designator: str = "A",
    ):
        from ais_tpu.pipeline.host import PacketDeduper

        self.block = DistributedBlockDecoder(demod, block_len, n_devices)
        self.block_len = block_len
        self.core_len = self.block.core_len
        self.blocks_per_call = blocks_per_call or 2 * self.block.n_devices
        if self.blocks_per_call % self.block.n_devices:
            raise ValueError(
                f"blocks_per_call {self.blocks_per_call} must divide over "
                f"{self.block.n_devices} devices"
            )
        self.designator = designator
        # Fresh samples consumed per device call; the remaining
        # block_len - core_len samples are the carry.
        self.step = self.blocks_per_call * self.core_len
        self._need = self.step + (block_len - self.core_len)
        self._buf = np.zeros(0, np.complex64)
        self._pos = 0  # absolute sample index of _buf[0]
        self._deduper = PacketDeduper()

    def process(self, iq: np.ndarray) -> list:
        """Feed a chunk that continues the stream; returns packets from
        every full device call it completes."""
        from ais_tpu.pipeline.host import decode_block_records

        self._buf = np.concatenate([self._buf, np.asarray(iq, np.complex64)])
        packets = []
        while self._buf.size >= self._need:
            span = self._buf[: self._need]
            stride = span.strides[0]
            blocks = np.lib.stride_tricks.as_strided(
                span,
                shape=(self.blocks_per_call, self.block_len),
                strides=(self.core_len * stride, stride),
            )
            records, n = self.block.decode_blocks(blocks)
            records = jax.tree.map(np.asarray, records)
            for b in range(n):
                rec_b = jax.tree.map(lambda a: a[b], records)
                packets.extend(
                    decode_block_records(
                        rec_b,
                        self._pos + b * self.core_len,
                        designator=self.designator,
                        deduper=self._deduper,
                        fftlen=self.block.cfg.fftlen,
                        samples_per_symbol=self.block.cfg.samples_per_symbol,
                    )
                )
            self._buf = self._buf[self.step :]
            self._pos += self.step
        return packets

    def flush(self) -> list:
        """End-of-stream: zero-pad the residual to one full call."""
        if self._buf.size == 0:
            return []
        return self.process(
            np.zeros(max(self._need - self._buf.size, 0), np.complex64)
        )

"""Sharded decoding on a virtual 8-device CPU mesh.

The reference has no distributed anything (SURVEY.md section 2.4); these
tests pin the new capability: block-sharded (sequence-parallel) and
stream-sharded decode must produce exactly the single-device results.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ais_tpu.core.params import DemodConfig
from ais_tpu.parallel import (
    make_halo_exchange_demod,
    make_sharded_demod,
    make_sharded_stream_demod,
    make_stream_time_mesh,
    make_time_mesh,
)
from ais_tpu.pipeline import decode_block_records, frame_stream, make_burst_demod
from ais_tpu.tx import aivdm_payload_to_bytes, make_packet_iq

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"

CFG = DemodConfig()
BLOCK, CORE = 16384, 11264


def _stream_with_packets(offsets, n, seed=0):
    rng = np.random.default_rng(seed)
    iq = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64) * 0.01
    pkt = make_packet_iq(aivdm_payload_to_bytes(PAYLOAD), samples_per_symbol=5)
    for off in offsets:
        iq[off : off + pkt.size] += pkt
    return iq


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


class TestTimeSharded:
    def test_matches_single_device_and_decodes(self, eight_devices):
        # 8 blocks spanning ~1.9s with packets scattered across shards.
        offsets = [5000, 30000, 55000, 80000]
        n = CORE * 8
        iq = _stream_with_packets(offsets, n)
        blocks = frame_stream(iq, BLOCK, CORE)
        assert blocks.shape[0] == 8

        mesh = make_time_mesh(8)
        sharded = make_sharded_demod(CFG, BLOCK, CORE, mesh)
        xs = jax.device_put(blocks, NamedSharding(mesh, P("time")))
        rec_sharded = jax.tree.map(np.asarray, sharded(xs))

        single = jax.jit(make_burst_demod(CFG, BLOCK, CORE))
        rec_single = jax.tree.map(np.asarray, single(jnp.asarray(blocks)))

        np.testing.assert_array_equal(rec_sharded.valid, rec_single.valid)
        np.testing.assert_array_equal(rec_sharded.position, rec_single.position)
        np.testing.assert_array_equal(rec_sharded.bits, rec_single.bits)

        # Host decode of the sharded records finds every packet once.
        packets = []
        for b in range(8):
            recs_b = jax.tree.map(lambda a: a[b], rec_sharded)
            packets.extend(decode_block_records(recs_b, b * CORE))
        got = sorted(p.abs_sample for p in packets)
        assert len(got) == len(offsets)
        assert all(abs(g - o) < 100 for g, o in zip(got, offsets))
        assert all(p.nmea == SENTENCE for p in packets)


class TestHaloExchange:
    def test_matches_duplication_path(self, eight_devices):
        """The ppermute halo-exchange framing (disjoint cores in, halos
        exchanged over the ring inside the program) must be bit-identical
        to the framing-time halo-duplication path."""
        halo = BLOCK - CORE
        offsets = [6000, 30000, 55000, 80000, CORE * 7 - 2000]
        n = CORE * 8
        iq = _stream_with_packets(offsets, n)
        # Zero the stream head: the ring wraps the final block's halo to
        # shard 0's first `halo` samples, while the duplication path pads
        # the stream tail with zeros — making the head zeros makes the
        # two paths see identical data everywhere, so the comparison can
        # demand bit-identity (the production stream framer arranges the
        # same equivalence by right-aligning the tail pad).
        iq[:halo] = 0

        # Duplication path: halo'd blocks built on host.
        blocks = frame_stream(iq, BLOCK, CORE)
        mesh = make_time_mesh(8)
        dup = make_sharded_demod(CFG, BLOCK, CORE, mesh)
        xs = jax.device_put(blocks, NamedSharding(mesh, P("time")))
        rec_dup = jax.tree.map(np.asarray, dup(xs))

        # Exchange path: disjoint cores only, 1.4x less data shipped.
        cores = iq.view(np.float32).reshape(8, CORE, 2)
        exch = make_halo_exchange_demod(CFG, BLOCK, CORE, mesh, n_blocks=8)
        cs = jax.device_put(np.ascontiguousarray(cores), NamedSharding(mesh, P("time")))
        rec_ex = jax.tree.map(np.asarray, exch(cs))

        np.testing.assert_array_equal(rec_ex.valid, rec_dup.valid)
        np.testing.assert_array_equal(rec_ex.position, rec_dup.position)
        np.testing.assert_array_equal(rec_ex.bits, rec_dup.bits)

        from ais_tpu.pipeline.host import PacketDeduper

        deduper = PacketDeduper()
        packets = []
        for b in range(8):
            recs_b = jax.tree.map(lambda a: a[b], rec_ex)
            packets.extend(decode_block_records(recs_b, b * CORE, deduper=deduper))
        got = sorted(p.abs_sample for p in packets)
        assert len(got) == len(offsets)
        assert all(p.nmea == SENTENCE for p in packets)


class TestStreamSharded:
    def test_two_streams_times_four_blocks(self, eight_devices):
        mesh = make_stream_time_mesh(2, 4)
        fn = make_sharded_stream_demod(CFG, BLOCK, CORE, mesh)
        n = CORE * 4
        s0 = _stream_with_packets([5000], n, seed=0)
        s1 = _stream_with_packets([20000, 40000], n, seed=1)
        blocks = np.stack([frame_stream(s0, BLOCK, CORE), frame_stream(s1, BLOCK, CORE)])
        xs = jax.device_put(blocks, NamedSharding(mesh, P("stream", "time")))
        rec = jax.tree.map(np.asarray, fn(xs))
        counts = []
        for s in range(2):
            found = []
            for b in range(4):
                recs = jax.tree.map(lambda a: a[s, b], rec)
                found.extend(decode_block_records(recs, b * CORE))
            counts.append(len(found))
            assert all(p.nmea == SENTENCE for p in found)
        assert counts == [1, 2]


class TestDistributedDecoder:
    def test_decode_stream_over_mesh(self, eight_devices):
        from ais_tpu.parallel.distributed import DistributedBlockDecoder

        offsets = [5000, 40000, 77000]
        iq = _stream_with_packets(offsets, CORE * 8, seed=4)
        dec = DistributedBlockDecoder()
        packets = dec.decode_stream(iq)
        found = sorted(p.abs_sample for p in packets)
        assert len(found) == len(offsets)
        for off, got in zip(offsets, found):
            assert abs(got - (off + 50)) < 120  # peak lands on a training lobe
        assert all(p.nmea == SENTENCE for p in packets)

    def test_uneven_blocks_padded(self, eight_devices):
        from ais_tpu.parallel.distributed import DistributedBlockDecoder

        iq = _stream_with_packets([9000], CORE * 3, seed=5)  # 3 blocks, 8 devs
        dec = DistributedBlockDecoder()
        packets = dec.decode_stream(iq)
        assert [p.nmea for p in packets] == [SENTENCE]


class TestSustainedStreaming:
    """DistributedStreamDecoder: rolling calls with cross-call state
    (BASELINE config 5's continuous stream, VERDICT r2 item 4)."""

    def test_rolling_calls_match_one_shot(self, eight_devices):
        from ais_tpu.parallel.distributed import (
            DistributedBlockDecoder,
            DistributedStreamDecoder,
        )

        sd = DistributedStreamDecoder(CFG, BLOCK, blocks_per_call=8)
        step = sd.step
        n = 3 * step
        # Packets straddling BOTH call boundaries (preamble just before
        # the cut, body extending into the next call's span) plus
        # mid-call ones.
        offsets = [5000, step - 700, step + 40_000, 2 * step - 650,
                   2 * step + 90_000]
        iq = _stream_with_packets(offsets, n, seed=4)

        one_shot = DistributedBlockDecoder(CFG, BLOCK).decode_stream(iq)
        want = sorted((p.payload, p.abs_sample) for p in one_shot)
        assert len(want) == len(offsets)

        got = []
        chunk = 70_001  # unaligned chunks: exercises the carry
        for lo in range(0, n, chunk):
            got.extend(sd.process(iq[lo : lo + chunk]))
        got.extend(sd.flush())
        assert sorted((p.payload, p.abs_sample) for p in got) == want

    def test_state_carries_across_calls(self, eight_devices):
        from ais_tpu.parallel.distributed import DistributedStreamDecoder

        sd = DistributedStreamDecoder(CFG, BLOCK, blocks_per_call=8)
        # Feed less than one call: nothing decodes, everything buffers.
        iq = _stream_with_packets([2000], sd.step // 2, seed=6)
        assert sd.process(iq) == []
        assert sd._buf.size == sd.step // 2
        # The rest of the stream completes the call; the packet appears.
        rest = _stream_with_packets([], sd.step, seed=7)
        got = sd.process(rest)
        assert len(got) == 1 and abs(got[0].abs_sample - 2000) < 64


class TestWirePipelineSharded:
    def test_wire_program_packet_set_equality(self, eight_devices):
        """The BENCHED wire program (cr1 decode -> channelize -> demod ->
        compacted d2h pack) sharded over a 4-device time mesh decodes
        the identical packet set to the single-device stream over the
        same spans (VERDICT r4 item 7: the dryrun previously covered
        only the demod half)."""
        from ais_tpu.ops.convert import host_bytes
        from ais_tpu.ops.fir import mixer_phase
        from ais_tpu.parallel import make_sharded_wire_pipeline
        from ais_tpu.pipeline.wideband import (
            WidebandConfig,
            WidebandReceiver,
            channelizer_buffers,
            num_taps,
        )
        from ais_tpu.tx.scenario import Scenario, ScenarioPacket

        n_shards = 4
        # Wider transition: fewer channelizer taps, same topology.
        cfg = WidebandConfig(transition_hz=12e3)._replace(compact_lanes=48)
        n48 = cfg.block_len  # one demod block per shard
        rx = WidebandReceiver(
            cfg, n_in=(n48 - 1) * cfg.decimation + num_taps(cfg)
        )
        n_in, step_raw = rx.n_in, rx.step_raw
        assert step_raw % 8 == 0 and n_in % 8 == 0  # cr1 byte alignment

        total = step_raw * n_shards + (n_in - step_raw)
        raw = aivdm_payload_to_bytes(PAYLOAD)
        packets = [
            ScenarioPacket(
                raw,
                40_000 + d * step_raw + 11_000 * d,
                cfg.offsets_hz[d % 2],
                phase=0.3 * d,
            )
            for d in range(n_shards)
        ]
        iq = Scenario(
            sample_rate=cfg.input_rate,
            n_samples=total,
            packets=packets,
            noise=0.004,
        ).build()
        wire = host_bytes((iq * 0.7).astype(np.complex64), "cr1")

        spans = [
            np.array(wire[d * step_raw // 8 : d * step_raw // 8 + n_in // 8])
            for d in range(n_shards)
        ]
        want = []
        for span in spans:
            want.extend(rx.decode_wire(span, "cr1"))
        want_set = sorted(
            (p.payload, p.abs_sample, p.designator) for p in want
        )
        assert len(want) >= n_shards  # the scene itself decodes

        mesh = make_time_mesh(n_shards)
        fn = make_sharded_wire_pipeline(cfg, n_in, mesh, fmt="cr1")
        car, hf = channelizer_buffers(cfg, n_in)
        ph = np.stack(
            [
                np.stack(
                    [
                        mixer_phase(off, cfg.input_rate, d * step_raw)
                        for off in cfg.offsets_hz
                    ]
                )
                for d in range(n_shards)
            ]
        )
        out = np.asarray(
            fn(
                jax.device_put(
                    np.stack(spans), NamedSharding(mesh, P("time"))
                ),
                jax.device_put(ph, NamedSharding(mesh, P("time"))),
                jax.device_put(car),
                jax.device_put(hf),
            )
        )

        rx2 = WidebandReceiver(cfg, n_in=n_in)
        got = []
        for d in range(n_shards):
            got.extend(
                rx2.decode_fetched(
                    (
                        out[d],
                        (d * step_raw) // cfg.decimation,
                        spans[d],
                        "cr1",
                        d * step_raw,
                    )
                )
            )
        got_set = sorted(
            (p.payload, p.abs_sample, p.designator) for p in got
        )
        assert got_set == want_set

    def test_wire_program_ci8_matches_single_device(self, eight_devices):
        """chip_smoke.py --four-cards at one demod block per shard: the
        full-load scene in ci8 (the SDR-native format) through the wire
        program sharded over a 4-device time mesh decodes the packet set
        the single-device stream decodes, and every sent packet."""
        import importlib.util
        import os

        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "chip_smoke.py",
        )
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        single, sharded, parity = smoke.mesh_packet_sets(4, n_blocks=1)
        assert len(single) > 0
        assert sharded == single
        assert parity == {"single": 1.0, "sharded": 1.0}

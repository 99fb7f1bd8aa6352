#!/usr/bin/env python
"""Characterize the coded-QPSK acquisition floor vs probe length
(VERDICT r3 weak #3) -> docs/sync_floor_coded.jsonl.

At 3-4 dB the conv-coded link DECODES (soft Viterbi floor ~3 dB in
isolation) but the round-3 sweep showed 2/3 seeds never *sync* at 3 dB
with the default probe_frames=4: the soft CRC hunt scores only ~probe
packets, and at PER_probe ~ 0.5-0.9 the true hypothesis is
indistinguishable from noise.  This sweeps probe_frames 4/8/16 over the
low-SNR points, 3 seeds each, recording sync_score and PER so the floor
is attributed (probe-length-limited or not) with the same soak rigor as
the 8PSK acquisition study.

Usage: python tools/run_sync_floor.py [--out docs/sync_floor_coded.jsonl]
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from qpsk_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

SNRS = [2.0, 3.0, 4.0, 5.0, 6.0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "sync_floor_coded.jsonl"))
    ap.add_argument("--probes", default="4,8,16")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--nframes", type=int, default=350)
    args = ap.parse_args()

    from qpsk_tpu.config import ModemConfig
    from qpsk_tpu.eval import per_vs_snr
    from qpsk_tpu.packet import PacketConfig

    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=30, fec="conv")
    rows = []
    for probe in map(int, args.probes.split(",")):
        for seed in map(int, args.seeds.split(",")):
            recs = per_vs_snr(cfg, pcfg, SNRS, nframes=args.nframes,
                              seed=seed, probe_frames=probe)
            for r in recs:
                row = {"probe_frames": probe, "seed": seed,
                       "snr_db": r["snr_db"], "sync_score": r["sync_score"],
                       "packets": r["packets"], "per": round(r["per"], 5),
                       "synced": r["sync_score"] > 0}
                rows.append(row)
                print(json.dumps(row), flush=True)
            print(f"probe={probe} seed={seed} done", file=sys.stderr,
                  flush=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

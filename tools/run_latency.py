#!/usr/bin/env python
"""Streaming-latency sweep -> docs/latency.jsonl.

Grid over the StreamDemodulator's latency knobs (bucket_frames,
sync_skip_frames, probe_frames) at the reference operating point
(2400 baud QPSK, +50 Hz, AWGN 10 dB), two seeds per point;
benchmarks.latency_benchmark verifies every decoded payload bit-exact, so
a row in the artifact is also a decode-success witness.

  python tools/run_latency.py [--out docs/latency.jsonl]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/latency.jsonl")
    ap.add_argument("--buckets", default="1,2,4,8")
    ap.add_argument("--skips", default="2,4,8")
    ap.add_argument("--probes", default="4")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--snr", type=float, default=10.0)
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    args = ap.parse_args()

    import jax

    from qpsk_tpu.utils.compile_cache import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    from qpsk_tpu.benchmarks import latency_benchmark

    rows = []
    for b in map(int, args.buckets.split(",")):
        for s in map(int, args.skips.split(",")):
            for p in map(int, args.probes.split(",")):
                for seed in range(args.seeds):
                    r = latency_benchmark(bucket_frames=b,
                                          sync_skip_frames=s,
                                          probe_frames=p, seed=seed,
                                          snr_db=args.snr)
                    r["seed"] = seed
                    rows.append(r)
                    print(json.dumps(r), flush=True)
    mode = "a" if args.append else "w"
    with open(args.out, mode) as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

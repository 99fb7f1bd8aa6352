#!/usr/bin/env python
"""Benchmark entry point: one JSON line for ``rx_demod_throughput``.

Runs ``benchmarks.rx_throughput`` at its GPU operating point (8192
channels x 8 frames) in ``_WINDOWS`` measurement windows and prints the
median with every window and their spread, beside the card it ran on
(``device_kind``, device count, power limit).  Exits non-zero without a
GPU.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

_WINDOWS = 5


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from qpsk_tpu.utils.compile_cache import enable_compile_cache

    import jax

    import qpsk_tpu.benchmarks as B

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform!r})", file=sys.stderr)
        return 1
    runs = [B.rx_throughput() for _ in range(_WINDOWS)]
    vals = [r["value"] for r in runs]
    med = statistics.median(vals)
    rec = {k: runs[0][k] for k in ("metric", "unit", "channels", "frames")}
    rec.update(value=med, windows=vals,
               spread=(max(vals) - min(vals)) / med,
               device_kind=dev.device_kind, device_count=len(jax.devices()),
               power_limit=power_limit())
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""FDM operating-point sweep on the GPU (same-process, interleaved
rounds): nslots x frames, wideband GS/s with the filterbank/modem
decomposition record.

Run: python tools/sweep_fdm.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from qpsk_tpu import benchmarks  # noqa: E402
from qpsk_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
if jax.devices()[0].platform != "gpu":
    sys.exit(f"sweep_fdm: no GPU (JAX found {jax.devices()[0].platform!r})")

POINTS = [(256, 16), (256, 32), (512, 16), (512, 8), (1024, 8)]
results = []
for rnd in range(2):
    for nslots, frames in POINTS:
        r = benchmarks.fdm_throughput(nslots=nslots, frames=frames)
        rec = {"round": rnd, "nslots": nslots, "frames": frames,
               "wide_gsps": round(r["value"] / 1e9, 2), "fdm": r["fdm"]}
        results.append(rec)
        print(json.dumps(rec), flush=True)

for nslots, frames in POINTS:
    rows = [r["wide_gsps"] for r in results
            if (r["nslots"], r["frames"]) == (nslots, frames)]
    print(f"nslots={nslots} frames={frames}: {min(rows)}-{max(rows)}")

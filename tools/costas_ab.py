#!/usr/bin/env python
"""Costas lowering A/B on the GPU: ``rx_stream`` end to end with the fused
kernel (``costas_impl="pallas"``) against the ``lax.scan`` lowering
(``costas_impl="scan"``), at the aggregate shape (8192 channels x 8
frames) and the single stream (1 channel x 64 frames), in turns kernel,
scan, scan, kernel; plus ``frontend_xla`` alone at 8192 x 8 and its share
of the kernel-path ``rx_stream`` time.

    python tools/costas_ab.py            # one JSON line per measurement

Fails without a GPU.  Each time is the median of ``--reps`` calls after a
warm-up, each call ended by ``jax.block_until_ready``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _median_time(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), (max(ts) - min(ts)) / statistics.median(ts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    from qpsk_tpu.utils.compile_cache import enable_compile_cache

    import jax
    import jax.numpy as jnp

    from qpsk_tpu import ModemConfig, rx_init
    from qpsk_tpu.modem import frontend_xla, rx_stream

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"costas_ab: no GPU (JAX found {dev.platform!r})",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    base = {"device_kind": dev.device_kind, "card": card}
    cfg = ModemConfig()

    for channels, frames in ((8192, 8), (1, 64)):
        shape = (channels, frames, cfg.frame_size)
        pcm = (jax.random.normal(jax.random.key(0), shape)
               * 8000.0).astype(jnp.int16)
        st = rx_init(cfg, batch_shape=(channels,))
        fns = {impl: jax.jit(lambda s, x, c=dataclasses.replace(
            cfg, costas_impl=impl): rx_stream(c, s, x))
            for impl in ("pallas", "scan")}
        res = {"pallas": [], "scan": []}
        for impl in ("pallas", "scan", "scan", "pallas"):
            res[impl].append(_median_time(fns[impl], (st, pcm), args.reps))
        n = channels * frames * cfg.frame_size
        for impl, runs in res.items():
            print(json.dumps(dict(base, metric="rx_stream_costas_ab",
                                  costas_impl=impl, channels=channels,
                                  frames=frames,
                                  ms=[r[0] * 1e3 for r in runs],
                                  spread=[r[1] for r in runs],
                                  samples_per_s=[n / r[0] for r in runs])),
                  flush=True)
        if channels == 8192:
            fe = jax.jit(lambda x, p, t: frontend_xla(cfg, x, p, t))
            t_fe, sp_fe = _median_time(fe, (pcm, st.nco_phase, st.fir_tail),
                                       args.reps)
            t_rx = min(r[0] for r in res["pallas"])
            print(json.dumps(dict(base, metric="frontend_xla",
                                  channels=channels, frames=frames,
                                  ms=t_fe * 1e3, spread=sp_fe,
                                  samples_per_s=n / t_fe,
                                  share_of_rx_stream=t_fe / t_rx)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

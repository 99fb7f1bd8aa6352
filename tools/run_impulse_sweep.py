#!/usr/bin/env python
"""Regenerate docs/per_vs_impulse.jsonl — PER vs impulsive-burst rate.

Documents the FEC + golden-prime-interleaver value case: full-scale
8-sample bursts at ``rate`` events/s over a 14 dB AWGN floor, uncoded vs
conv-coded (soft Viterbi), 3 seeds per point.

Usage: python tools/run_impulse_sweep.py [docs_dir]
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from qpsk_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

RATES_HZ = [0.0, 5.0, 10.0, 20.0, 40.0]
SNR_DB = 14.0
SEEDS = (0, 1, 2)
NFRAMES = 40


def main() -> None:
    from qpsk_tpu import ModemConfig, rx_init, tx_init
    from qpsk_tpu.channel import awgn_pcm, impulse_noise_pcm
    from qpsk_tpu.modem import rx_stream, tx_stream
    from qpsk_tpu.ops.cplx import CF32
    from qpsk_tpu.ops.modmap import demod_soft
    from qpsk_tpu.packet import PacketConfig, assemble_packet
    from qpsk_tpu.sync import (default_max_lag,
                               extract_packets_soft_tracked,
                               extract_packets_tracked, find_sync)

    cfg = ModemConfig()

    def trial(fec, rate: float, seed: int):
        rng = np.random.default_rng(seed)
        pcfg = PacketConfig(payload_bytes=(29 if fec else 30), fec=fec)
        pay = jnp.asarray(rng.integers(0, 2, (NFRAMES, 8 * pcfg.payload_bytes),
                                       dtype=np.int32))
        _, pcm = tx_stream(cfg, tx_init(cfg), assemble_packet(pcfg, pay),
                           tx_offset_hz=50.0)
        sp = float(jnp.mean((pcm.astype(jnp.float32) / cfg.pcm_scale) ** 2))
        noisy = awgn_pcm(jax.random.key(seed + 1), pcm, snr_db=SNR_DB,
                         signal_power=sp, pcm_scale=cfg.pcm_scale)
        flat = impulse_noise_pcm(jax.random.key(seed + 5),
                                 noisy.reshape(-1), rate, cfg.fs)
        flat = jnp.concatenate(
            [flat, jnp.zeros(((-flat.size) % cfg.frame_size,), flat.dtype)])
        _, out = rx_stream(cfg, rx_init(cfg),
                           flat.reshape(-1, cfg.frame_size))
        b = out.bits.ravel()
        skip = 8 * pcfg.frame_bits
        sync = find_sync(pcfg, b[skip:], max_lag=default_max_lag(pcfg),
                         probe_frames=4)
        nav = (b.size - skip - int(sync.bit_lag)) // pcfg.frame_bits
        if int(sync.score) < 2:
            return 0, nav
        if fec:
            llrs = demod_soft(CF32(out.symbols.re.reshape(-1),
                                   out.symbols.im.reshape(-1)))
            rx = extract_packets_soft_tracked(pcfg, llrs[skip:], sync, nav)
        else:
            rx = extract_packets_tracked(pcfg, b[skip:], sync, nav)
        # guard against CRC collisions / duplicated frames: a packet
        # counts only if its payload is one the TX actually sent (the
        # same discipline as eval.per_vs_snr)
        tx_set = {np.asarray(pay)[j].astype(np.int32).tobytes()
                  for j in range(NFRAMES)}
        ok = np.asarray(rx.crc_ok)
        pays = np.asarray(rx.payload_bits).astype(np.int32)
        good = sum(1 for j in range(nav)
                   if ok[j] and pays[j].tobytes() in tx_set)
        return good, nav

    docs = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")
    recs = []
    for rate in RATES_HZ:
        rec = {"rate_hz": rate, "snr_db": SNR_DB, "seeds": len(SEEDS)}
        for name, fec in (("uncoded", False), ("conv", "conv")):
            oks, navs = 0, 0
            for s in SEEDS:
                ok, nav = trial(fec, rate, s)
                oks += ok
                navs += nav
            rec[f"per_{name}"] = round(1.0 - oks / max(navs, 1), 4)
            rec[f"packets_{name}"] = navs
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    with open(os.path.join(docs, "per_vs_impulse.jsonl"), "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    print("wrote", os.path.join(docs, "per_vs_impulse.jsonl"))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Regenerate docs/lock_range.jsonl — measured carrier-offset lock range.

The reference demonstrates lock at one +50 Hz offset with a hand-tuned
loop bandwidth (README.md:12, qpsk.c:320).  This sweep measures, at
10 dB SNR, where the chain actually decodes: cold-start (Costas pulls in
alone, the reference's situation) vs FFT-acquisition-seeded (the default
``acquisition="fft"``).  Both polarities, CRC-fraction per point.

Usage: python tools/run_lock_range.py [docs_dir]
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

OFFSETS_HZ = [50, 100, 150, 200, 250, 300, 350, 400]
SNR_DB = 10.0
SEEDS = (0, 1, 2)
# generic-family operating SNRs (uncoded floors + margin)
MOD_SNR = {"qpsk": 10.0, "bpsk": 10.0, "8psk": 20.0, "16qam": 22.0}


def main() -> None:
    from qpsk_tpu import ModemConfig, rx_init, tx_init
    from qpsk_tpu.channel import awgn_pcm
    from qpsk_tpu.modem import rx_acquire_hz, rx_stream, tx_stream
    from qpsk_tpu.ops.acquire import hz_to_costas_freq
    from qpsk_tpu.packet import PacketConfig, assemble_packet
    from qpsk_tpu.sync import (default_max_lag, extract_packets_tracked,
                               find_sync)

    modulation = "qpsk"
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    for a in sys.argv[1:]:
        if a.startswith("--modulation="):
            modulation = a.split("=", 1)[1]
    sys.argv = [sys.argv[0]] + args
    cfg = ModemConfig(modulation=modulation,
                      agc=(modulation == "16qam"))
    pcfg = PacketConfig(payload_bytes=30)
    snr_db = MOD_SNR[modulation]

    from qpsk_tpu.ops.acquire import sweep_candidates_hz

    def trial(offset: float, mode: str, seed: int) -> float:
        rng = np.random.default_rng(seed)
        payload = jnp.asarray(rng.integers(0, 2, (30, 240), dtype=np.int32))
        chan = assemble_packet(pcfg, payload).ravel()
        mfb = cfg.bits_per_frame
        npad = (-chan.size) % mfb
        if npad:
            chan = jnp.concatenate(
                [chan, jnp.asarray(rng.integers(0, 2, (npad,), np.int32))])
        _, pcm = tx_stream(cfg, tx_init(cfg), chan.reshape(-1, mfb),
                           tx_offset_hz=float(offset))
        sp = float(jnp.mean((pcm.astype(jnp.float32) / cfg.pcm_scale) ** 2))
        noisy = awgn_pcm(jax.random.key(seed + 10), pcm, snr_db=snr_db,
                         signal_power=sp)
        # candidate fallback (ops/acquire.acquire_freq_candidates): the
        # M-power spur can out-peak the carrier line; the CRC-scored sync
        # disambiguates — try candidate 0, then candidate 1.  "sweep"
        # additionally walks the static seed grid after both FFT
        # candidates reject (the StreamDemodulator rotation behavior):
        # at |offset| >= 250 Hz the 8PSK spectrum parks BOTH candidates
        # on spurs on a growing fraction of draws (round-5 scan: 2/4 at
        # 325-375, 4/4 at 400) — no clean M-power line exists, and only
        # a seed near the truth acquires.
        if mode == "cold":
            cands = np.asarray([0.0])
        else:
            cands = np.asarray(rx_acquire_hz(cfg, noisy,
                                             candidates=2)).ravel()
            if mode == "sweep":
                cands = np.concatenate([cands, sweep_candidates_hz()])
        for est in cands:
            acq = hz_to_costas_freq(jnp.float32(est), cfg.rs) \
                if mode != "cold" else 0.0
            _, out = rx_stream(cfg, rx_init(cfg, acq_freq=acq), noisy)
            b = out.bits.ravel()
            skip = 8 * pcfg.frame_bits
            skip -= skip % cfg.bits_per_symbol   # symbol-aligned (generic)
            sync = find_sync(pcfg, b[skip:], max_lag=default_max_lag(pcfg),
                             probe_frames=4, modulation=modulation)
            if int(sync.score) < 3:
                continue
            nav = (b.size - skip - int(sync.bit_lag)) // pcfg.frame_bits
            rx = extract_packets_tracked(pcfg, b[skip:], sync, nav,
                                         modulation=modulation)
            return float(np.asarray(rx.crc_ok).mean())
        return 0.0

    docs = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")
    recs = []
    for off in OFFSETS_HZ:
        for sign in (1, -1):
            rec = {"offset_hz": sign * off, "snr_db": snr_db,
                   "seeds": len(SEEDS)}
            if modulation != "qpsk":
                rec["modulation"] = modulation
            for name, mode in (("cold", "cold"), ("fft_acq", "fft"),
                               ("sweep", "sweep")):
                fr = [trial(sign * off, mode, s) for s in SEEDS]
                rec[f"crc_frac_{name}"] = round(float(np.mean(fr)), 4)
            recs.append(rec)
            print(json.dumps(rec), flush=True)
    fname = ("lock_range.jsonl" if modulation == "qpsk"
             else f"lock_range_{modulation}.jsonl")
    with open(os.path.join(docs, fname), "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    print("wrote", os.path.join(docs, fname))


if __name__ == "__main__":
    main()

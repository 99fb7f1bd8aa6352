#!/usr/bin/env python
"""On-card smoke test: drive the modem's main path once on one GPU and
check that what comes out decodes.

    python chip_smoke.py               # one GPU, every phase below
    python chip_smoke.py --four-cards  # the sharded gate on four GPUs only

Phases (one process, one card; each checks decoded results against what
was sent, and prints its steady-state rate beside the card's name and
power limit):

* ``rx``       — 8192 channels x 24 frames of CRC'd packets, +50 Hz, AWGN
                 12 dB (the uncoded PER-0 floor, docs/per_vs_snr.jsonl;
                 at 10 dB the recorded PER is 0.3%), three chained
                 8-frame ``rx_stream`` calls; sync and
                 tracked extraction on 64 channels across the batch: PER 0,
                 payloads bit-exact;
* ``gpu_cpu``  — the same ``rx_stream`` on the CPU backend (scan Costas,
                 f32 FIR) over a 64-channel slice: same decoded payloads,
                 timing picks, pre-Costas picks within tolerance;
* ``costas``   — the fused Costas kernel against the ``lax.scan`` on the
                 card, every mode, at 8192 ch x 1024 sym and 1 ch x 8192;
* ``modfam``   — 8PSK and 16QAM+AGC through ``rx_stream`` at their
                 uncoded PER-0 floors (docs/ARTIFACTS.md);
* ``coded``    — ``viterbi_decode`` and ``ldpc_decode`` on 4096 packets,
                 and one coded modem link of each kind at 9 dB;
* ``tx``       — ``tx_stream`` at 2048 channels x 16 frames, decoded back;
* ``stream``   — ``StreamDemodulator.push`` over a live stream;
* ``fdm``      — ``FdmReceiver`` on one 256-slot wideband stream.

The last line of standard output is one JSON object naming the device.
Any failed phase, or a first device that is not a GPU, exits non-zero
without it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
SKIP_FRAMES = 8        # Costas transient + decimator/FIR delay, in frames
RX_SNR_DB = 12.0       # uncoded QPSK PER-0 floor (docs/per_vs_snr.jsonl)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def steady_time(fn, *args, reps: int = 5) -> float:
    """Median wall time of ``fn(*args)`` after a warm-up call, each call
    ended by ``jax.block_until_ready`` on its device outputs."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


class Report:
    def __init__(self, card: str):
        self.card = card

    def phase(self, name: str, result: str, rate: str | None = None):
        tail = f" | {rate} ({self.card})" if rate else ""
        print(f"[{name}] {result}{tail}", flush=True)


# --------------------------------------------------------------------------
# links

def make_link(cfg, pcfg, channels: int, frames: int, snr_db: float,
              offset_hz: float, key):
    """Per-channel random payloads -> packets -> tx_stream -> AWGN.
    Returns (payload (C, F', 8*payload_bytes) host array, noisy PCM
    (C, F, frame_size) on device).  Packets are laid end to end on each
    channel's bit stream (coded packets need not fill whole frames)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qpsk_tpu import tx_init
    from qpsk_tpu.channel import awgn_pcm
    from qpsk_tpu.modem import tx_stream
    from qpsk_tpu.packet import assemble_packet

    mfb = cfg.bits_per_frame
    npk = frames * mfb // pcfg.frame_bits
    kp, kf, kn = jax.random.split(key, 3)
    payload = jax.random.bernoulli(
        kp, 0.5, (channels, npk, 8 * pcfg.payload_bytes)).astype(jnp.int32)
    bits = assemble_packet(pcfg, payload).reshape(channels, -1)
    fill = jax.random.bernoulli(
        kf, 0.5, (channels, frames * mfb - bits.shape[1])).astype(jnp.int32)
    bits = jnp.concatenate([bits, fill], axis=1).reshape(channels, frames,
                                                         mfb)
    tx = jax.jit(lambda st, b: tx_stream(cfg, st, b, tx_offset_hz=offset_hz))
    _, pcm = tx(tx_init(cfg, batch_shape=(channels,)), bits)
    sp = float(jnp.mean((pcm.astype(jnp.float32) / cfg.pcm_scale) ** 2))
    noisy = awgn_pcm(kn, pcm, snr_db=snr_db, signal_power=sp)
    return np.asarray(payload), noisy


def decode_channel(cfg, pcfg, bits, payload, skip_frames: int = SKIP_FRAMES):
    """Hunt sync on one channel's hard-bit stream, extract every packet
    after the transient, and match payloads against what was sent.
    Returns (packets extracted, CRC-ok, bit-exact payloads, ok list)."""
    import jax.numpy as jnp
    import numpy as np

    from qpsk_tpu.sync import (default_max_lag, extract_packets_tracked,
                               find_sync)

    skip = skip_frames * cfg.bits_per_frame
    b = jnp.asarray(bits[skip:])
    sync = find_sync(pcfg, b, max_lag=default_max_lag(pcfg), probe_frames=4,
                     modulation=cfg.modulation)
    if int(sync.score) == 0:
        return 0, 0, 0, []
    navail = (b.size - int(sync.bit_lag)) // pcfg.frame_bits
    rx = extract_packets_tracked(pcfg, b, sync, navail,
                                 modulation=cfg.modulation)
    ok = np.asarray(rx.crc_ok)
    got = np.asarray(rx.payload_bits)
    want = {p.tobytes(): k for k, p in enumerate(payload.astype(np.int32))}
    exact = sum(bool(ok[j]) and got[j].astype(np.int32).tobytes() in want
                for j in range(navail))
    return navail, int(ok.sum()), exact, [
        got[j].astype(np.int32).tobytes() for j in range(navail) if ok[j]]


def rx_chained(cfg, state, pcm, calls: int):
    """``calls`` chained rx_stream calls over equal frame slices; returns
    (state, [RxOut per call])."""
    import functools

    import jax

    from qpsk_tpu.modem import rx_stream

    rx = jax.jit(functools.partial(rx_stream, cfg))
    f = pcm.shape[-2] // calls
    outs = []
    for i in range(calls):
        state, out = rx(state, pcm[..., i * f:(i + 1) * f, :])
        outs.append(out)
    return state, outs


# --------------------------------------------------------------------------
# phases

def phase_rx(rep: Report, channels=8192, frames=24, check=64):
    """Main path at the headline operating point; returns what the
    gpu_cpu phase compares against."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qpsk_tpu import ModemConfig, rx_init
    from qpsk_tpu.modem import rx_stream
    from qpsk_tpu.packet import PacketConfig

    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=30)
    payload, pcm = make_link(cfg, pcfg, channels, frames, RX_SNR_DB, 50.0,
                             jax.random.key(SEED))
    st0 = rx_init(cfg, batch_shape=(channels,))
    _, outs = rx_chained(cfg, st0, pcm, 3)
    bits = np.asarray(jnp.concatenate([o.bits for o in outs], axis=1)
                      ).reshape(channels, -1)
    # the per-frame readback jitters with the loop noise: each
    # channel's mean over the last call within 5 Hz, the batch's within 1
    freq = np.asarray(jnp.mean(outs[-1].freq_hz, axis=1))
    assert np.all(np.abs(freq - 50.0) < 5.0) and \
        abs(freq.mean() - 50.0) < 1.0, \
        f"detected offset off: {freq.min():.2f}..{freq.max():.2f} Hz"
    sel = np.arange(0, channels, max(1, channels // check))[:check]
    tot = okn = exact = 0
    for c in sel:
        n, k, e, _ = decode_channel(cfg, pcfg, bits[c], payload[c])
        assert n > 0, f"channel {c}: no sync"
        tot, okn, exact = tot + n, okn + k, exact + e
    assert okn == tot and exact == tot, \
        f"PER {1 - exact / tot:.4f} ({exact}/{tot} bit-exact)"
    rx8 = jax.jit(lambda s, x: rx_stream(cfg, s, x))
    dt = steady_time(rx8, st0, pcm[:, :8])
    rate = channels * 8 * cfg.frame_size / dt
    rep.phase("rx", f"{channels} ch x {frames} frames at {RX_SNR_DB:g} dB, "
              f"{len(sel)} ch checked: PER 0 ({exact}/{tot} packets bit-exact), offset "
              f"{freq.mean():.2f} Hz",
              f"rx_stream {channels}x8: {rate / 1e9:.3f} GS/s, "
              f"{dt * 1e3:.3f} ms/call")
    return cfg, pcfg, payload, pcm, bits, sel


def phase_gpu_cpu(rep: Report, cfg, pcfg, payload, pcm, gpu_bits, sel):
    """The card's rx_stream against the CPU backend on a channel slice.

    Tolerances: the card runs the FIR as TF32 matmuls (fir_precision
    "fast" = Precision.DEFAULT; 10-bit mantissa), the CPU in f32, so
    the pre-Costas picks differ by the TF32 rounding of a 127-tap sum,
    ~1e-3 of their RMS; 2e-3 bounds it.  Timing picks are argmaxes of
    near-equal phase energies and may flip on a near-tie (<= 0.1% of
    frames).  Decoded payloads must be identical."""
    import dataclasses

    import jax
    import numpy as np

    from qpsk_tpu import rx_init
    from qpsk_tpu.modem import frontend_xla

    cpu = jax.devices("cpu")[0]
    x_gpu = pcm[sel]
    n = len(sel)
    st0 = rx_init(cfg, batch_shape=(n,))
    _, outs_g = rx_chained(cfg, st0, x_gpu, 3)
    cfg_c = dataclasses.replace(cfg, costas_impl="scan")
    with jax.default_device(cpu):
        x_cpu = jax.device_put(x_gpu, cpu)
        _, outs_c = rx_chained(cfg_c, rx_init(cfg_c, batch_shape=(n,)),
                               x_cpu, 3)
        st_c = rx_init(cfg_c, batch_shape=(n,))
        fe_c = jax.jit(lambda x, p, t: frontend_xla(cfg_c, x, p, t))(
            x_cpu[:, :8], st_c.nco_phase, st_c.fir_tail)
    fe_g = jax.jit(lambda x, p, t: frontend_xla(cfg, x, p, t))(
        x_gpu[:, :8], st0.nco_phase, st0.fir_tail)
    idx_g = np.concatenate([np.asarray(o.timing_index) for o in outs_g], 1)
    idx_c = np.concatenate([np.asarray(o.timing_index) for o in outs_c], 1)
    same_idx = float(np.mean(idx_g == idx_c))
    assert same_idx >= 0.999, f"timing picks agree on {same_idx:.4%}"
    pg = np.asarray(fe_g[0].re) + 1j * np.asarray(fe_g[0].im)
    pc = np.asarray(fe_c[0].re) + 1j * np.asarray(fe_c[0].im)
    same = np.asarray(fe_g[1]) == np.asarray(fe_c[1])        # (n, 8)
    rms = np.sqrt(np.mean(np.abs(pc) ** 2))
    rel = float(np.max(np.abs(pg - pc)[same]) / rms)
    assert rel <= 2e-3, f"pre-Costas picks differ by {rel:.2e} of RMS"
    bits_c = np.concatenate([np.asarray(o.bits) for o in outs_c],
                            1).reshape(n, -1)
    for i, c in enumerate(sel):
        pl_g = decode_channel(cfg, pcfg, gpu_bits[c], payload[c])[3]
        pl_c = decode_channel(cfg, pcfg, bits_c[i], payload[c])[3]
        assert pl_g == pl_c, f"channel {c}: decoded payloads differ"
    hard = float(np.mean(gpu_bits[sel] == bits_c))
    rep.phase("gpu_cpu", f"{n} ch x 24 frames: payloads identical, timing "
              f"picks equal on {same_idx:.4%} of frames, pre-Costas picks "
              f"max rel diff {rel:.2e} (limit 2e-3), hard bits equal "
              f"{hard:.5%}")


def _costas_inputs(kind: str, c: int, t: int, key, nsf: int = 128):
    """Synthetic post-MF symbols (T, C) for one detector mode: random
    constellation points at the chain's 1.45 scale, a 0.01 rad/symbol
    carrier offset, AWGN at ~20 dB."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qpsk_tpu.ops import modfam

    kl, kn1, kn2, kg = jax.random.split(key, 4)
    if kind in ("qpsk", "gear", "agc"):
        pre = np.cos(np.pi / 4 + np.pi / 2 * np.arange(4))
        pim = np.sin(np.pi / 4 + np.pi / 2 * np.arange(4))
    else:
        m = modfam.get(kind)
        pre, pim = m.points_re, m.points_im
    lab = jax.random.randint(kl, (t, c), 0, len(pre))
    s = 1.45 * (jnp.asarray(pre, jnp.float32)[lab]
                + 1j * jnp.asarray(pim, jnp.float32)[lab])
    rot = jnp.exp(1j * (0.3 + 0.01 * jnp.arange(t, dtype=jnp.float32)))
    z = s * rot[:, None] + 0.145 * (jax.random.normal(kn1, (t, c))
                                    + 1j * jax.random.normal(kn2, (t, c)))
    gains = None
    if kind == "agc":
        gains = jax.random.uniform(kg, (t // nsf, c), jnp.float32, 0.8, 1.2)
    return (jnp.real(z).astype(jnp.float32), jnp.imag(z).astype(jnp.float32),
            gains)


def compare_costas(kind: str, c: int, t: int, interpret: bool = False):
    """Fused kernel against the scan for one mode and shape; returns
    (share of equal hard decisions, |final freq diff|, max |derot diff|,
    kernel call, scan call, inputs)."""
    import math

    import jax
    import jax.numpy as jnp
    import numpy as np

    from qpsk_tpu.ops import costas as costas_ops
    from qpsk_tpu.ops import modfam, modmap
    from qpsk_tpu.ops.cplx import CF32
    from qpsk_tpu.ops.pallas.costas_kernel import costas_run_tm

    nsf = 128 if t % 128 == 0 else t
    zr, zi, gains = _costas_inputs(kind, c, t, jax.random.key(7), nsf)
    params = costas_ops.costas_params(2 * math.pi / 100)
    gear = costas_ops.costas_gear(2 * math.pi / 200) if kind == "gear" \
        else None
    dd = (kind, 1.45) if kind in ("bpsk", "8psk", "16qam") else None
    st0 = costas_ops.costas_init((c,), freq=0.008, gear=gear is not None)

    def kern(zr, zi, g):
        st, d, _ = costas_run_tm(st0, zr, zi, params, gear=gear,
                                 trace_every=nsf, dd=dd, gains=g,
                                 interpret=interpret)
        return st.freq, d

    def scan(zr, zi, g):
        if g is not None:
            rep_g = jnp.repeat(g, nsf, axis=0)
            zr, zi = zr * rep_g, zi * rep_g
        sym = CF32(zr.T, zi.T)
        if gear is not None:
            st, d = costas_ops.costas_run_gear(st0, sym, params, gear,
                                               unroll=8)
        else:
            det = (modfam.dd_detector(modfam.get(dd[0]), dd[1]) if dd
                   else costas_ops.phase_detector)
            st, d = costas_ops.costas_run(st0, sym, params, unroll=8,
                                          detector=det)
        return st.freq, CF32(d.re.T, d.im.T)

    kern_j, scan_j = jax.jit(kern), jax.jit(scan)
    fk, dk = kern_j(zr, zi, gains)
    fs, ds = scan_j(zr, zi, gains)

    def hard(d):
        if dd is None:
            return modmap.demod_bits(CF32(d.re.T, d.im.T))
        return modfam.demod_bits_cmp(CF32(d.re.T, d.im.T),
                                     modfam.get(dd[0]), scale=dd[1])

    agree = float(jnp.mean((hard(dk) == hard(ds)).astype(jnp.float32)))
    dfreq = float(jnp.max(jnp.abs(fk - fs)))
    dmax = float(jnp.maximum(jnp.max(jnp.abs(dk.re - ds.re)),
                             jnp.max(jnp.abs(dk.im - ds.im))))
    return agree, dfreq, dmax, kern_j, scan_j, (zr, zi, gains)


def phase_costas(rep: Report):
    """Kernel vs scan on the card, every mode, both shapes."""
    worst = (1.0, 0.0, 0.0)
    rates = []
    for c, t in ((8192, 1024), (1, 8192)):
        for kind in ("qpsk", "gear", "agc", "bpsk", "8psk", "16qam"):
            agree, dfreq, dmax, kj, sj, args = compare_costas(kind, c, t)
            assert agree >= 0.9999, f"{kind} {c}x{t}: decisions {agree:.6f}"
            assert dfreq <= 1e-5, f"{kind} {c}x{t}: freq diff {dfreq:.2e}"
            worst = (min(worst[0], agree), max(worst[1], dfreq),
                     max(worst[2], dmax))
            if kind in ("qpsk", "16qam"):
                tk = steady_time(kj, *args, reps=3)
                ts = steady_time(sj, *args, reps=3)
                rates.append(f"{kind} {c}x{t}: kernel {c * t / tk / 1e9:.4f}"
                             f" / scan {c * t / ts / 1e9:.4f} Gsym/s")
            print(f"  costas {kind:5s} {c}x{t}: decisions equal "
                  f"{agree:.6%}, |dfreq| {dfreq:.2e} rad/sym, max |dderot| "
                  f"{dmax:.2e}", flush=True)
    rep.phase("costas", f"kernel vs scan, 6 modes x 2 shapes: decisions "
              f"equal >= {worst[0]:.6%}, max |dfreq| {worst[1]:.2e} "
              f"rad/sym, max |dderot| {worst[2]:.2e}", "; ".join(rates))


def phase_modfam(rep: Report, channels=1024, frames=24, check=16,
                 rate_channels=8192):
    """8PSK and 16QAM+AGC at their uncoded PER-0 floors."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qpsk_tpu import ModemConfig, rx_init
    from qpsk_tpu.modem import rx_acquire_hz, rx_stream
    from qpsk_tpu.ops.acquire import hz_to_costas_freq
    from qpsk_tpu.packet import PacketConfig

    pcfg = PacketConfig(payload_bytes=30)
    for name, snr in (("8psk", 16.0), ("16qam", 18.0)):
        cfg = ModemConfig(modulation=name, agc=(name == "16qam"))
        payload, pcm = make_link(cfg, pcfg, channels, frames, snr, 20.0,
                                 jax.random.key(SEED + 1))
        est = jax.jit(lambda x: rx_acquire_hz(cfg, x))(pcm)
        st = rx_init(cfg, batch_shape=(channels,),
                     acq_freq=hz_to_costas_freq(est, cfg.rs))
        _, outs = rx_chained(cfg, st, pcm, 3)
        bits = np.asarray(jnp.concatenate([o.bits for o in outs], axis=1)
                          ).reshape(channels, -1)
        tot = exact = 0
        for c in np.arange(0, channels, channels // check)[:check]:
            n, _, e, _ = decode_channel(cfg, pcfg, bits[c], payload[c],
                                        skip_frames=10)
            assert n > 0, f"{name} channel {c}: no sync"
            tot, exact = tot + n, exact + e
        assert exact == tot, f"{name}: PER {1 - exact / tot:.4f}"
        pcm_r = jnp.tile(pcm[:, :8], (rate_channels // channels, 1, 1))
        st_r = rx_init(cfg, batch_shape=(rate_channels,))
        dt = steady_time(jax.jit(lambda s, x: rx_stream(cfg, s, x)),
                         st_r, pcm_r)
        rep.phase(f"modfam_{name}",
                  f"{snr:g} dB, {check} ch checked: PER 0 "
                  f"({exact}/{tot} bit-exact)",
                  f"rx_stream {rate_channels}x8: "
                  f"{rate_channels * 8 * cfg.frame_size / dt / 1e9:.3f} GS/s")


def phase_coded(rep: Report, packets=4096):
    """Decoder rates at 4096 packets (QPSK at Es/N0 9 dB, i.e. per-bit
    LLRs of unit mean and noise sigma 10^-0.45, through the full soft
    deframe: deinterleave, descramble, decode, CRC), and one coded modem
    link per code at 9 dB."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qpsk_tpu import ModemConfig
    from qpsk_tpu.eval import per_vs_snr
    from qpsk_tpu.packet import (PacketConfig, assemble_packet,
                                 disassemble_packet_soft)

    for kind in ("conv", "ldpc"):
        pcfg = PacketConfig(payload_bytes=30, fec=kind)
        kp, kn = jax.random.split(jax.random.key(SEED + 2))
        payload = jax.random.bernoulli(
            kp, 0.5, (packets, 8 * pcfg.payload_bytes)).astype(jnp.int32)
        bits = assemble_packet(pcfg, payload)
        llrs = (1.0 - 2.0 * bits.astype(jnp.float32)
                + 10 ** -0.45 * jax.random.normal(kn, bits.shape))
        dec = jax.jit(lambda x: disassemble_packet_soft(pcfg, x))
        out = dec(llrs)
        ok = np.asarray(out.crc_ok)
        exact = np.all(np.asarray(out.payload_bits) == np.asarray(payload),
                       axis=1)
        assert ok.all() and exact.all(), \
            f"{kind}: {int((~(ok & exact)).sum())}/{packets} packets lost"
        dt = steady_time(dec, llrs)
        link = per_vs_snr(ModemConfig(), pcfg, (9.0,), nframes=60,
                          offset_hz=50.0, seed=1)[0]
        assert link["sync_score"] > 0 and link["per"] == 0.0, link
        rep.phase(f"coded_{kind}",
                  f"{packets} packets at Es/N0 9 dB: PER 0; modem link "
                  f"9 dB: PER 0 over {link['packets']} packets",
                  f"soft deframe+decode {packets} pkts: "
                  f"{packets * 8 * pcfg.payload_bytes / dt / 1e6:.2f} "
                  f"Minfo-bit/s, {dt * 1e3:.2f} ms/batch")


def phase_tx(rep: Report, channels=2048, frames=16, check=4):
    """tx_stream at 2048 x 16, decoded back on a few channels."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qpsk_tpu import ModemConfig, rx_init, tx_init
    from qpsk_tpu.modem import tx_stream
    from qpsk_tpu.packet import PacketConfig, assemble_packet

    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=30)
    payload = jax.random.bernoulli(jax.random.key(SEED + 3), 0.5,
                                   (channels, frames, 240)).astype(jnp.int32)
    bits = assemble_packet(pcfg, payload)
    tx = jax.jit(lambda st, b: tx_stream(cfg, st, b, tx_offset_hz=50.0))
    st0 = tx_init(cfg, batch_shape=(channels,))
    _, pcm = tx(st0, bits)
    sel = np.arange(0, channels, channels // check)[:check]
    _, outs = rx_chained(cfg, rx_init(cfg, batch_shape=(check,)),
                         pcm[sel], 1)
    rb = np.asarray(outs[0].bits).reshape(check, -1)
    pl = np.asarray(payload)
    for i, c in enumerate(sel):
        n, k, e, _ = decode_channel(cfg, pcfg, rb[i], pl[c], skip_frames=4)
        assert n > 0 and k == n and e == n, f"TX channel {c}: {e}/{n}"
    dt = steady_time(tx, st0, bits)
    rep.phase("tx", f"{channels} ch x {frames} frames, {check} ch decoded "
              "back bit-exact",
              f"tx_stream {channels}x{frames}: "
              f"{channels * frames * cfg.frame_size / dt / 1e9:.3f} GS/s")


def phase_stream(rep: Report, frames=48, chunk=480):
    """StreamDemodulator at the runtime defaults over one live stream."""
    import jax
    import numpy as np

    from qpsk_tpu import ModemConfig
    from qpsk_tpu.packet import PacketConfig
    from qpsk_tpu.runtime import StreamDemodulator

    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=30)
    payload, pcm = make_link(cfg, pcfg, 1, frames, RX_SNR_DB, 50.0,
                             jax.random.key(SEED + 4))
    pcm = np.asarray(pcm).ravel()
    want = {p.tobytes() for p in payload[0].astype(np.int32)}

    def run():
        d = StreamDemodulator(cfg, pcfg)
        got, times = [], []
        for p in range(0, pcm.size, chunk):
            t0 = time.perf_counter()
            got.extend(d.push(pcm[p:p + chunk]))
            times.append(time.perf_counter() - t0)
        got.extend(d.flush())
        return got, times

    run()                                       # compile every shape
    got, times = run()
    ok = [p for p in got if p.crc_ok]
    assert len(ok) >= frames - 12, f"{len(ok)} packets of {frames}"
    bad = [p for p in ok if np.asarray(p.payload).astype(np.int32).tobytes()
           not in want]
    assert not bad, f"{len(bad)} CRC-ok payloads not sent"
    rtf = pcm.size / cfg.fs / sum(times)
    times.sort()
    rep.phase("stream", f"{len(ok)}/{frames} packets bit-exact",
              f"realtime factor {rtf:.1f}, push p50 "
              f"{times[len(times) // 2] * 1e3:.2f} ms, p99 "
              f"{times[int(len(times) * 0.99)] * 1e3:.2f} ms")


def phase_fdm(rep: Report, nslots=256, frames=16):
    """FdmReceiver on one wideband stream at 256 slots."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qpsk_tpu import ModemConfig, tx_init
    from qpsk_tpu.channel import awgn_pcm
    from qpsk_tpu.fdm import FdmConfig, FdmReceiver, fdm_mux
    from qpsk_tpu.modem import tx_stream
    from qpsk_tpu.packet import PacketConfig, assemble_packet

    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=30)
    fcfg = FdmConfig(nslots=nslots)
    n = fcfg.nchan
    payload = jax.random.bernoulli(jax.random.key(SEED + 5), 0.5,
                                   (n, frames, 240)).astype(jnp.int32)
    _, pcm = tx_stream(cfg, tx_init(cfg, batch_shape=(n,)),
                       assemble_packet(pcfg, payload), tx_offset_hz=50.0)
    wide = fdm_mux(fcfg, pcm.reshape(n, -1))
    sp = float(jnp.mean((wide.astype(jnp.float32) / cfg.pcm_scale) ** 2))
    wide = np.asarray(awgn_pcm(jax.random.key(SEED + 6), wide, snr_db=18.0,
                               signal_power=sp))
    pl = np.asarray(payload)

    def run(stream):
        rx = FdmReceiver(fcfg, cfg, pcfg)
        got = [[] for _ in range(n)]
        step = 1 << 18
        t0 = time.perf_counter()
        for p in range(0, stream.size, step):
            for c, pk in enumerate(rx.push(stream[p:p + step])):
                got[c].extend(pk)
        for c, pk in enumerate(rx.flush()):
            got[c].extend(pk)
        return got, time.perf_counter() - t0

    # one bucket and the flush compile every shape the timed run uses
    run(wide[:8 * cfg.frame_size * nslots])
    got, dt = run(wide)
    worst = frames
    for c in range(n):
        want = {p.tobytes() for p in pl[c]}
        ok = [p for p in got[c] if p.crc_ok]
        assert all(np.asarray(p.payload).astype(np.int32).tobytes() in want
                   for p in ok), f"subchannel {c}: payload not sent"
        worst = min(worst, len(ok))
    assert worst >= frames - 6, f"a subchannel decoded {worst}/{frames}"
    rep.phase("fdm", f"{nslots} slots ({n} subchannels): every subchannel "
              f">= {worst}/{frames} packets bit-exact",
              f"FdmReceiver: {wide.size / dt / 1e6:.2f} M wide samples/s, "
              f"realtime factor {wide.size / fcfg.wide_fs / dt:.2f}")


def phase_four_cards(rep: Report):
    """The sharded decode gate on a (2, 2) dp x sp mesh of four cards."""
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    rep.phase("four_cards", "dryrun_multichip(4) on a (2, 2) mesh: sharded "
              "decode == single-device decode, CRC sync and time-parallel "
              f"decode pass ({time.perf_counter() - t0:.1f} s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded gate, on four GPUs")
    args = ap.parse_args()

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import qpsk_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the qpsk_tpu package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    from qpsk_tpu.utils.compile_cache import enable_compile_cache

    import jax

    enable_compile_cache()
    devs = jax.devices()
    want = 4 if args.four_cards else 1
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    if len(devs) < want:
        print(f"chip_smoke: {want} GPUs needed, found {len(devs)}",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}",
          flush=True)
    rep = Report(card)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(rep)
    else:
        cfg, pcfg, payload, pcm, bits, sel = phase_rx(rep)
        phase_gpu_cpu(rep, cfg, pcfg, payload, pcm, bits, sel)
        del pcm
        phase_costas(rep)
        phase_modfam(rep)
        phase_coded(rep)
        phase_tx(rep)
        phase_stream(rep)
        phase_fdm(rep)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": want}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

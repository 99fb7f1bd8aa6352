"""Link-evaluation harness: PER/BER/EVM vs SNR curves (BASELINE config #3).

Every SNR point is a *channel* on the batch axis,
so one fused ``rx_stream`` call evaluates the whole curve; only packet sync
(a tiny host-side search per point) runs outside the jit.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.channel import awgn_pcm
from qpsk_tpu.config import ModemConfig
from qpsk_tpu.metrics import evm
from qpsk_tpu.modem import rx_stream, tx_stream
from qpsk_tpu.ops.cplx import CF32
from qpsk_tpu.ops.modmap import demod_soft
from qpsk_tpu.packet import PacketConfig, assemble_packet
from qpsk_tpu.state import rx_init, tx_init
from qpsk_tpu.sync import (_mod_geometry, default_max_lag,
                           extract_packets_soft_tracked,
                           extract_packets_soft_tracked_mod,
                           extract_packets_tracked, find_sync,
                           find_sync_streams, rotate_soft, rotated_streams)


def per_vs_snr(cfg: ModemConfig, pcfg: PacketConfig,
               snr_db: Sequence[float], nframes: int = 120,
               offset_hz: float = 50.0, seed: int = 0,
               skip_frames: int = 8, paths=None,
               probe_frames: int = 4) -> list[dict]:
    """Packet/bit error rates across SNR points, one fused RX pass.

    Returns one record per SNR: {snr_db, per, ber, evm_rms, detected_hz,
    packets, sync_score}.  Packets need not fill a whole number of modem
    frames (coded packets don't): the channel-bit stream is padded to the
    frame grid.  With ``pcfg.fec`` the extraction runs in the soft domain
    (LLRs from the demod symbols -> soft decoder).  ``paths`` adds static
    multipath (channel.multipath_pcm) before the AWGN — pair with
    ``ModemConfig(eq_taps=...)`` to sweep the equalized link.
    """
    snr = np.asarray(list(snr_db), np.float32)
    ns = snr.size
    rng = np.random.default_rng(seed)
    payload = jnp.asarray(rng.integers(
        0, 2, (nframes, 8 * pcfg.payload_bytes), dtype=np.int32))
    chan_bits = assemble_packet(pcfg, payload).ravel()
    mframe_bits = cfg.bits_per_frame
    npad = (-chan_bits.size) % mframe_bits
    if npad:
        chan_bits = jnp.concatenate(
            [chan_bits,
             jnp.asarray(rng.integers(0, 2, (npad,), dtype=np.int32))])
    chan_bits = chan_bits.reshape(-1, mframe_bits)

    _, pcm = tx_stream(cfg, tx_init(cfg), chan_bits,
                       tx_offset_hz=offset_hz)          # (F, frame)
    if paths:
        from qpsk_tpu.channel import multipath_pcm
        pcm = multipath_pcm(pcm.reshape(-1), paths).reshape(pcm.shape)
    pcm = jnp.broadcast_to(pcm, (ns,) + pcm.shape)      # (S, F, frame)
    sp = float(jnp.mean((pcm[0].astype(jnp.float32) / cfg.pcm_scale) ** 2))
    noisy = awgn_pcm(jax.random.key(seed), pcm, snr_db=jnp.asarray(snr),
                     signal_power=sp, pcm_scale=cfg.pcm_scale)

    acq = 0.0
    if cfg.modulation != "qpsk" and cfg.acquisition == "fft":
        # generic-family receive recipe (same as the CLI): FFT-acquire per
        # SNR point before the narrower decision-directed loop — at the
        # default 50 Hz stimulus the cold DD pull-in is not guaranteed
        from qpsk_tpu.modem import rx_acquire_hz
        from qpsk_tpu.ops.acquire import hz_to_costas_freq
        acq = hz_to_costas_freq(rx_acquire_hz(cfg, noisy), cfg.rs)
    state = rx_init(cfg, batch_shape=(ns,), acq_freq=acq)
    _, out = jax.jit(lambda s, x: rx_stream(cfg, s, x))(state, noisy)

    if cfg.modulation == "qpsk":
        m = evm(CF32(out.symbols.re[:, skip_frames:],
                     out.symbols.im[:, skip_frames:]))
        evm_rms = np.asarray(jnp.mean(m.evm_rms, axis=-1))
    else:
        from qpsk_tpu.ops import modfam
        mod = modfam.get(cfg.modulation)
        evm_rms = np.asarray(modfam.evm_mod(
            CF32(out.symbols.re[:, skip_frames:].reshape(ns, -1),
                 out.symbols.im[:, skip_frames:].reshape(ns, -1)), mod))
    det = np.asarray(jnp.mean(out.freq_hz[:, -10:], axis=-1))

    bits = np.asarray(out.bits).reshape(ns, -1)
    # LLRs of the absolute demod symbols align with the hard bit stream only
    # in coherent (non-differential) mode; differential bits come from the
    # turn-difference decode, so coded DQPSK falls back to hard-input
    # Viterbi inside disassemble_packet (mirrors StreamDemodulator._use_soft)
    use_soft = pcfg.fec and not cfg.differential
    soft_src = None
    if use_soft and cfg.modulation == "qpsk":
        soft_src = np.asarray(demod_soft(CF32(
            out.symbols.re.reshape(ns, -1), out.symbols.im.reshape(ns, -1))))
    elif use_soft:
        # generic family: the (nsym, M) score matrix carries every
        # rotation hypothesis' LLR stream (sync.rotated_streams)
        soft_src = np.asarray(modfam.symbol_scores(
            CF32(out.symbols.re.reshape(ns, -1),
                 out.symbols.im.reshape(ns, -1)), mod,
            scale=cfg.agc_target))
    want = np.asarray(payload)
    results = []
    skip_bits = skip_frames * mframe_bits  # modem frames, not packets
    skip_syms = skip_bits // cfg.bits_per_symbol
    for i in range(ns):
        stream = jnp.asarray(bits[i, skip_bits:])
        if use_soft:
            # soft-decision sync hunt: the hard-input hunt misses ~2 dB
            # above the soft decode floor (see find_sync_streams)
            if cfg.modulation == "qpsk":
                llrs_i = jnp.asarray(soft_src[i, skip_bits:])
                rows = jnp.stack([rotate_soft(llrs_i, r) for r in range(4)])
            else:
                rows = rotated_streams(
                    None, cfg.modulation,
                    soft=jnp.asarray(soft_src[i, skip_syms:]))
            sync = find_sync_streams(
                pcfg, rows, max_lag=default_max_lag(pcfg),
                probe_frames=probe_frames,
                lag_step=_mod_geometry(cfg.modulation)[2], soft=True)
        else:
            sync = find_sync(pcfg, stream, max_lag=default_max_lag(pcfg),
                             probe_frames=probe_frames,
                             modulation=cfg.modulation)
        navail = (stream.shape[0] - int(sync.bit_lag)) // pcfg.frame_bits
        rec = {"snr_db": float(snr[i]), "evm_rms": float(evm_rms[i]),
               "detected_hz": float(det[i]), "sync_score": int(sync.score),
               "packets": 0, "per": 1.0, "ber": 0.5}
        if int(sync.score) > 0 and navail > 0:
            if use_soft and cfg.modulation == "qpsk":
                rx = extract_packets_soft_tracked(
                    pcfg, jnp.asarray(soft_src[i, skip_bits:]), sync, navail)
            elif use_soft:
                rx = extract_packets_soft_tracked_mod(
                    pcfg, jnp.asarray(soft_src[i, skip_syms:]), sync,
                    navail, cfg.modulation)
            else:
                rx = extract_packets_tracked(pcfg, stream, sync, navail,
                                             modulation=cfg.modulation)
            ok = np.asarray(rx.crc_ok)
            got = np.asarray(rx.payload_bits)
            # anchor the stream offset on CRC-ok packets: try each until one
            # matches a TX payload (a lone CRC collision or a mid-probe slip
            # must not poison the whole SNR point)
            want_index = {w.tobytes(): k for k, w in enumerate(want)}
            k0 = None
            for i0 in np.flatnonzero(ok):
                k = want_index.get(got[int(i0)].tobytes())
                if k is not None:
                    k0 = k - int(i0)
                    break
            errs, nbits, npk, nok = 0, 0, 0, 0
            for j in range(navail):
                if k0 is None or not (0 <= j + k0 < want.shape[0]):
                    continue
                npk += 1
                ref = want[j + k0]
                errs += int(np.sum(got[j] ^ ref))
                nbits += ref.size
                nok += int(ok[j] and np.array_equal(got[j], ref))
            if npk:
                rec.update(packets=npk, per=1.0 - nok / npk,
                           ber=errs / max(nbits, 1))
        results.append(rec)
    return results

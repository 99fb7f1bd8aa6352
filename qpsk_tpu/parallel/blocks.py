"""Block-parallel single-stream demodulation on one chip.

The Costas recurrence caps a *single* stream at the serial loop rate,
however idle the rest of the device is.  This
module breaks that cap the same way the multi-device time-parallel path
does (parallel/stream.py), but *within* one device: the decimated symbol
stream is split into B overlapping blocks that ride the batch axis —
each block 4th-power-re-acquires carrier from its overlap head, runs its
own Costas loop (one batched scan or fused-kernel launch), and discards the
overlap warmup.  Block boundaries behave like burst starts: each block has
an independent 90° ambiguity and a fresh transient, both absorbed by the
CRC-tracked packet extraction (qpsk_tpu.sync.extract_packets_tracked).

This is the "block-parallel reformulation of the per-sample feedback
loop" (SURVEY.md §7 hard-part #1): exactness is traded at block seams for
B-fold parallelism; the overlap length controls the trade.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.config import ModemConfig
from qpsk_tpu.modem import _pick_block, _prec, _tmat_for, _use_costas_kernel
from qpsk_tpu.ops import acquire, costas as costas_ops, modmap, nco
from qpsk_tpu.ops import rrc as rrc_ops, timing as timing_ops
from qpsk_tpu.ops.cplx import CF32

__all__ = ["rx_stream_blockparallel"]


def rx_stream_blockparallel(cfg: ModemConfig, pcm: jnp.ndarray,
                            nblocks: int, overlap_sym: int = 64):
    """Demodulate one (nframes, frame_size) PCM stream with the Costas
    loop block-parallelized over ``nblocks``.

    Returns (symbols CF32 (nsym,), bits (2*nsym,), freq_hz (nblocks,)).
    The emitted symbols are *undelayed* (no one-frame decimation delay —
    blocks decode independently, like bursts).  ``nsym`` must divide by
    ``nblocks``; ``overlap_sym`` extra symbols are prepended to each block
    (except the first) for acquisition + loop settling and dropped from
    the output.
    """
    if cfg.modulation != "qpsk":
        # the block demod below is QPSK-hardcoded (4th-power acquisition,
        # sign-detector Costas, QPSK slicer); a generic-family config would
        # produce silent garbage bits
        raise ValueError(
            f"rx_stream_blockparallel is QPSK-only, got {cfg.modulation!r}")
    if pcm.ndim != 2:
        raise ValueError(
            f"single stream expected: (nframes, frame_size), got {pcm.shape}")
    nframes, fsz = pcm.shape[-2], pcm.shape[-1]
    n = nframes * fsz
    nsf = cfg.symbols_per_frame
    nsym = nframes * nsf
    if nsym % nblocks != 0:
        raise ValueError(f"nblocks={nblocks} must divide {nsym} symbols")
    L = nsym // nblocks
    W = min(overlap_sym, L)

    # --- serial-exact front-end (fully parallel ops, no recurrence) ---
    flat = pcm.reshape(n).astype(jnp.float32) / jnp.float32(cfg.pcm_scale)
    x = CF32(flat, jnp.zeros_like(flat))
    x, _ = nco.mix(x, nco.nco_init(), -cfg.omega_center, "fast")
    blk = _pick_block(fsz)
    tmat = jnp.asarray(_tmat_for(cfg, blk))
    x, _ = rrc_ops.fir_block(x, rrc_ops.fir_init_tail(cfg.ntaps), tmat,
                             cfg.gain, blk, precision=_prec(cfg))
    frames = CF32(x.re.reshape(nframes, fsz), x.im.reshape(nframes, fsz))
    picks, _ = timing_ops.estimate_and_decimate(frames, cfg.cycles,
                                                cfg.timing_mode)
    sym = CF32(picks.re.reshape(-1), picks.im.reshape(-1))  # (nsym,)

    # --- overlapping block windows on the batch axis ---
    # pad W zeros at the head so every block's window is [b*L - W, b*L + L)
    # in stream coordinates; block 0 warms up on silence (a cold start).
    # The windows are regular, so they are two aligned reshape views (the
    # W-history slice and the block body) — no gather on the lane axis.
    assert W <= L, (W, L)
    pad = jnp.zeros((W,), jnp.float32)

    def windows(plane):
        pre = jnp.concatenate([pad, plane])           # (nsym + W,)
        hist = pre[:nsym].reshape(nblocks, L)[:, :W]  # [b*L - W, b*L)
        body = plane.reshape(nblocks, L)              # [b*L, b*L + L)
        return jnp.concatenate([hist, body], axis=1)  # (B, W + L)

    zb = CF32(windows(sym.re), windows(sym.im))

    # --- per-block re-acquisition on PRE-decimation samples at fs ---
    # (4th power at the symbol rate would alias beyond |f| = rs/8; at fs
    # the unambiguous range is fs/8, matching the serial acquisition path)
    spb = L * cfg.cycles
    nfft = min(cfg.nfft, spb)
    heads = CF32(x.re.reshape(nblocks, spb)[:, :nfft],
                 x.im.reshape(nblocks, spb)[:, :nfft])
    f_hz = acquire.acquire_freq_hz(heads, cfg.fs, nfft=nfft)
    freq0 = jnp.clip(acquire.hz_to_costas_freq(f_hz, cfg.rs),
                     cfg.min_freq, cfg.max_freq)
    gear = costas_ops.gear_for(cfg.loop_bw_track, cfg.damping)
    cstate = costas_ops.costas_init_from_freq(freq0, gear is not None)

    params = costas_ops.costas_params(cfg.loop_bw, cfg.damping,
                                      cfg.min_freq, cfg.max_freq)
    if _use_costas_kernel(cfg):
        from qpsk_tpu.ops.pallas import costas_kernel
        cstate, derot = costas_kernel.costas_run_pallas(cstate, zb, params,
                                                        gear=gear)
    elif gear is not None:
        cstate, derot = costas_ops.costas_run_gear(cstate, zb, params, gear,
                                                   unroll=8)
    else:
        cstate, derot = costas_ops.costas_run(cstate, zb, params, unroll=8)

    # drop each block's W-symbol warmup: the remaining L outputs land
    # exactly on stream symbols [b*L, (b+1)*L)
    out = CF32(derot.re[:, W:].reshape(nsym),
               derot.im[:, W:].reshape(nsym))
    bits = (modmap.demod_bits(out) if cfg.slicer == "diagonal"
            else modmap.demod_bits_reference(out))
    return out, bits, costas_ops.freq_to_hz(cstate.freq, cfg.rs)

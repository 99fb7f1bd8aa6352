"""Frame-level modem pipeline: TX and RX chains as pure jittable functions.

TX (tx_frame, mirrors qpsk.c:221-264):
  symbols -> zero-stuff x cycles -> RRC shape -> NCO mix up -> Re * 16384
  -> int16 PCM.

RX (rx_frame, mirrors qpsk.c:81-218):
  PCM / 16384 -> NCO mix down -> RRC matched filter -> timing estimate ->
  decimate (one-frame delay) -> Costas derotate -> Gray slice -> bits,
  plus metrics (detected frequency offset in Hz, timing index).

All functions take ``cfg`` as a static argument, thread explicit state
(``TxState`` / ``RxState``) and broadcast over arbitrary leading batch axes
(channels).  Signals are CF32 split-plane complex; the RRC FIR runs as a
banded Toeplitz matmul (ops/rrc.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.config import TAU, ModemConfig
from qpsk_tpu.ops import costas as costas_ops
from qpsk_tpu.ops import differential, modmap, nco
from qpsk_tpu.ops import rrc as rrc_ops
from qpsk_tpu.ops import timing as timing_ops
from qpsk_tpu.ops.cplx import CF32
from qpsk_tpu.state import RxState, TxState


@functools.lru_cache(maxsize=None)
def taps_for(cfg: ModemConfig) -> np.ndarray:
    return rrc_ops.rrc_design(cfg.fs, cfg.rs, cfg.alpha, cfg.ntaps, cfg.gain)


def _pick_block(n: int) -> int:
    for b in (512, 256, 128):
        if n % b == 0:
            return b
    return n


@functools.lru_cache(maxsize=None)
def _tmat_for(cfg: ModemConfig, block: int) -> np.ndarray:
    return rrc_ops.toeplitz_taps(taps_for(cfg), block)


@functools.lru_cache(maxsize=None)
def _tmat_mod_for(cfg: ModemConfig, block: int) -> tuple:
    """(re, im) Toeplitz planes of the RX *modulated* taps
    (ops/frontend.py: the mix folded into the filter)."""
    from qpsk_tpu.ops.frontend import modulated_taps_np
    key = tuple(np.asarray(taps_for(cfg)).tolist())
    hm = modulated_taps_np(key, float(-cfg.omega_center))
    return (rrc_ops.toeplitz_taps(hm[0], block),
            rrc_ops.toeplitz_taps(hm[1], block))


def _prec(cfg: ModemConfig):
    """FIR matmul precision from the config (see ModemConfig.fir_precision)."""
    return (jax.lax.Precision.DEFAULT if cfg.fir_precision == "fast"
            else jax.lax.Precision.HIGHEST)


def _gear_for(cfg: ModemConfig):
    """CostasGear for the config, or None (single-bandwidth loop)."""
    return costas_ops.gear_for(cfg.loop_bw_track, cfg.damping)


def _mod_for(cfg: ModemConfig):
    """modfam.Modulation for a generic-family config, None for the QPSK
    flagship (which keeps the bit-exact ops/modmap slicers)."""
    if cfg.modulation == "qpsk":
        return None
    from qpsk_tpu.ops import modfam
    return modfam.get(cfg.modulation)


@functools.lru_cache(maxsize=None)
def _detector_for(cfg: ModemConfig):
    """Costas phase-error function: the reference QPSK sign detector, or
    the generic decision-directed error for the modulation family.  The
    constellation scale is ``cfg.agc_target`` — the chain's nominal post-MF
    symbol magnitude (double-GAIN ~1.45), which the AGC also normalizes to
    (only 16QAM decisions actually depend on it)."""
    mod = _mod_for(cfg)
    if mod is None:
        return costas_ops.phase_detector
    from qpsk_tpu.ops import modfam
    return modfam.dd_detector(mod, scale=cfg.agc_target)


def _slice_bits(cfg: ModemConfig, derot: CF32) -> jnp.ndarray:
    """Hard-slice derotated symbols per the config's modulation/slicer."""
    mod = _mod_for(cfg)
    if mod is not None:
        # comparison-program slicer: the decision the DD loop itself makes
        # (modfam.slice_labels_cmp; score-argmax decisions can flip on
        # near-ties between compilers — CLAUDE.md)
        from qpsk_tpu.ops import modfam
        return modfam.demod_bits_cmp(derot, mod, scale=cfg.agc_target)
    if cfg.slicer == "diagonal":
        return modmap.demod_bits(derot)
    return modmap.demod_bits_reference(derot)


class RxOut(NamedTuple):
    symbols: CF32            # (..., nsym) Costas-derotated constellation pts
    bits: jnp.ndarray        # (..., bits_per_symbol*nsym) sliced bits
    freq_hz: jnp.ndarray     # (...,) detected carrier offset, Hz (qpsk.c:217)
    timing_index: jnp.ndarray  # (...,) decimation phase picked


def tx_frame(cfg: ModemConfig, state: TxState, symbols: CF32,
             tx_offset_hz: float = 0.0):
    """Modulate one frame of symbols to int16 PCM (qpsk.c:225-264).

    ``tx_offset_hz`` is added to the carrier (the reference transmits at
    CENTER+50 Hz as the Costas test stimulus, qpsk.c:320-321).
    """
    sig = modmap.upsample_zero_stuff(symbols, cfg.cycles)
    n = sig.shape[-1]
    block = _pick_block(n)
    tmat = jnp.asarray(_tmat_for(cfg, block))
    sig, fir_tail = rrc_ops.fir_block(sig, state.fir_tail, tmat, cfg.gain, block,
                                      precision=_prec(cfg))
    omega = TAU * (cfg.center + tx_offset_hz) / cfg.fs
    sig, phase = nco.mix(sig, state.nco_phase, omega, cfg.nco_mode)
    # (int16)(Re * 16384.0f): C float->int conversion truncates toward zero.
    pcm = (sig.re * jnp.float32(cfg.pcm_scale)).astype(jnp.int16)
    return state._replace(fir_tail=fir_tail, nco_phase=phase), pcm


def tx_bits_frame(cfg: ModemConfig, state: TxState, bits: jnp.ndarray,
                  tx_offset_hz: float = 0.0):
    """Bits -> PCM, with the reference dibit packing (qpsk.c:273-285).
    In differential mode the dibits are phase *changes* (ops/differential);
    generic-family modulations map through their Gray tables (ops/modfam)."""
    if cfg.differential:
        sym, diff_phase = differential.diff_encode_bits(bits, state.diff_phase)
        state, pcm = tx_frame(cfg, state, sym, tx_offset_hz)
        return state._replace(diff_phase=diff_phase), pcm
    mod = _mod_for(cfg)
    if mod is not None:
        from qpsk_tpu.ops import modfam
        return tx_frame(cfg, state, modfam.bits_to_symbols_mod(bits, mod),
                        tx_offset_hz)
    return tx_frame(cfg, state, modmap.bits_to_symbols(bits), tx_offset_hz)


def tx_stream(cfg: ModemConfig, state: TxState, bits: jnp.ndarray,
              tx_offset_hz: float = 0.0, doppler_hz_per_s: float = 0.0):
    """Fused TX over (..., nframes, bits_per_frame) bit frames.

    One zero-stuff + one block FIR + one carrier mix for the whole stream
    (the TX twin of the fused RX path).  ``doppler_hz_per_s`` adds a linear
    carrier chirp — the quadratic-phase closed form
    ``θ_k = ω·(k+1) + ½·dω·k²`` — used to synthesize the Doppler-ramp test
    stimulus (BASELINE config #2).  With a chirp the carried NCO phase is
    only exact within one call (one-shot simulation usage); without it the
    output chains bit-identically with repeated ``tx_frame`` calls.
    """
    batch = bits.shape[:-2]
    nframes = bits.shape[-2]
    nsym = bits.shape[-1] // cfg.bits_per_symbol
    diff_phase = state.diff_phase
    mod = _mod_for(cfg)
    if cfg.differential:
        flat, diff_phase = differential.diff_encode_bits(
            bits.reshape(batch + (nframes * bits.shape[-1],)), diff_phase)
    elif mod is not None:
        from qpsk_tpu.ops import modfam
        sym = modfam.bits_to_symbols_mod(bits, mod)  # (..., F, nsym)
        flat = CF32(sym.re.reshape(batch + (nframes * nsym,)),
                    sym.im.reshape(batch + (nframes * nsym,)))
    else:
        sym = modmap.bits_to_symbols(bits)          # (..., F, nsym)
        flat = CF32(sym.re.reshape(batch + (nframes * nsym,)),
                    sym.im.reshape(batch + (nframes * nsym,)))
    sig = modmap.upsample_zero_stuff(flat, cfg.cycles)
    n = sig.shape[-1]
    # block from the per-frame sample count (NOT cfg.frame_size): callers
    # may pass frames of any symbol length, like tx_frame does
    block = _pick_block(nsym * cfg.cycles)
    tmat = jnp.asarray(_tmat_for(cfg, block))
    sig, fir_tail = rrc_ops.fir_block(sig, state.fir_tail, tmat, cfg.gain, block,
                                      precision=_prec(cfg))

    omega = TAU * (cfg.center + tx_offset_hz) / cfg.fs
    if doppler_hz_per_s:
        domega = TAU * doppler_hz_per_s / (cfg.fs * cfg.fs)
        sig, phase = nco.mix_chirp(sig, state.nco_phase, omega, domega)
    else:
        sig, phase = nco.mix(sig, state.nco_phase, omega, cfg.nco_mode)

    pcm = (sig.re * jnp.float32(cfg.pcm_scale)).astype(jnp.int16)
    pcm = pcm.reshape(batch + (nframes, nsym * cfg.cycles))
    return state._replace(fir_tail=fir_tail, nco_phase=phase,
                          diff_phase=diff_phase), pcm


def rx_acquire_hz(cfg: ModemConfig, pcm: jnp.ndarray,
                  candidates: int = 0) -> jnp.ndarray:
    """Coarse carrier-offset estimate (Hz) from the first frames of PCM —
    the front half of the RX chain (mix-down + matched filter) feeding the
    4th-power FFT estimator (ops/acquire.py).  Use it to warm-start the
    Costas loop: ``rx_init(cfg, acq_freq=hz_to_costas_freq(est, cfg.rs))``.

    Capability upgrade over the reference, whose loop cold-starts and must
    be hand-tuned to pull in offsets (README.md:12).

    ``candidates=k`` > 0 returns the top-k candidate offsets (..., k)
    instead of the single estimate — the M-power spectrum carries
    deterministic symbol-rate-displaced spurs that can out-peak the
    carrier line at some offsets (ops/acquire.acquire_freq_candidates);
    consumers disambiguate with the CRC-scored sync hunt.
    """
    from qpsk_tpu.ops.modfam import ACQUIRE_POWER
    power = ACQUIRE_POWER[cfg.modulation]
    # weak-line modulations need 4x the coherent integration AND Welch
    # averaging: the 8PSK 8th-power strip amplifies RRC inter-symbol
    # samples into a noise floor that buries the 8f line at nfft=512
    # (and the 16QAM 4th-power line is itself weak, E[c^4] = -0.68 vs
    # 1.0 for QPSK) — 2048-point blocks fix the floor, but single-block
    # peak picks still swapped to image/harmonic lines on ~1/3 of
    # (seed, SNR) draws at 10-18 dB; averaging the PSD over up to 8
    # blocks recovered every measured case (ops/acquire.acquire_freq_hz)
    generic = cfg.modulation in ("8psk", "16qam")
    nfft_want = cfg.nfft * (4 if generic else 1)
    avg_want = 8 if generic else 1
    flat = pcm.reshape(pcm.shape[:-2] + (-1,)) if pcm.ndim >= 2 else pcm
    block = _pick_block(cfg.frame_size)
    n = min(flat.shape[-1],
            max(4 * cfg.nfft, avg_want * nfft_want + 2 * block, block))
    n -= n % block
    if n == 0:
        raise ValueError(
            f"acquisition needs at least {block} samples, got "
            f"{flat.shape[-1]}")
    xr = flat[..., :n].astype(jnp.float32) / jnp.float32(cfg.pcm_scale)
    x = CF32(xr, jnp.zeros_like(xr))
    x, _ = nco.mix(x, nco.nco_init(xr.shape[:-1]), -cfg.omega_center, "fast")
    tmat = jnp.asarray(_tmat_for(cfg, block))
    x, _ = rrc_ops.fir_block(
        x, rrc_ops.fir_init_tail(cfg.ntaps, xr.shape[:-1]), tmat,
        cfg.gain, block)
    from qpsk_tpu.ops import acquire
    nfft = min(nfft_want, n)
    # skip the filter's fill-in transient, then as many whole PSD blocks
    # as the stream affords (short flush buckets degrade to avg=1)
    start = min(cfg.ntaps, max(0, n - nfft))
    avg = max(1, min(avg_want, (n - start) // nfft))
    seg = CF32(x.re[..., start:start + avg * nfft],
               x.im[..., start:start + avg * nfft])
    if candidates:
        return acquire.acquire_freq_candidates(
            seg, cfg.fs, nfft=nfft, power=power, avg=avg,
            ncand=candidates)
    return acquire.acquire_freq_hz(seg, cfg.fs, nfft=nfft, power=power,
                                   avg=avg)


def rx_frame(cfg: ModemConfig, state: RxState, pcm: jnp.ndarray):
    """Demodulate one FRAME_SIZE block of int16 PCM (qpsk.c:88-218).

    Note the reference's one-frame decimation delay (qpsk.c:186-191): the
    symbols/bits returned belong to the *previous* frame's samples.
    """
    n = pcm.shape[-1]
    xr = pcm.astype(jnp.float32) / jnp.float32(cfg.pcm_scale)
    x = CF32(xr, jnp.zeros_like(xr))
    # RX NCO runs at -CENTER (cmplxconj rect, qpsk.c:342)
    x, nco_phase = nco.mix(x, state.nco_phase, -cfg.omega_center, cfg.nco_mode)
    block = _pick_block(n)
    tmat = jnp.asarray(_tmat_for(cfg, block))
    x, fir_tail = rrc_ops.fir_block(x, state.fir_tail, tmat, cfg.gain, block,
                                    precision=_prec(cfg))

    timing_state = state.timing
    if cfg.timing_mode == "tracking":
        meas = timing_ops.timing_fractional(x, cfg.cycles)
        tau, timing_state = timing_ops.timing_track_step(
            timing_state, meas, cfg.cycles)
        picks = timing_ops.decimate_fractional(x, tau, cfg.cycles)
        index = jnp.round(tau).astype(jnp.int32)
    else:
        picks, index = timing_ops.estimate_and_decimate(x, cfg.cycles,
                                                        cfg.timing_mode)
    # one-frame delay line (qpsk.c:182-191): emit the previous frame's picks
    symbols, decim_delay = state.decim_delay, picks

    agc_state = state.agc
    if cfg.agc:
        from qpsk_tpu.ops import agc as agc_ops
        agc_state, symbols = agc_ops.agc_frame(agc_state, symbols,
                                               cfg.agc_target, cfg.agc_mu)
    eq_state = state.eq
    if cfg.eq_taps > 0:
        from qpsk_tpu.ops import equalizer as eq_ops
        eq_state, symbols = eq_ops.cma_frame(eq_state, symbols,
                                             cfg.eq_mu, cfg.eq_modulus)

    params = costas_ops.costas_params(cfg.loop_bw, cfg.damping,
                                      cfg.min_freq, cfg.max_freq)
    gear = _gear_for(cfg)
    if gear is not None:
        cstate, derot = costas_ops.costas_run_gear(state.costas, symbols,
                                                   params, gear)
    else:
        cstate, derot = costas_ops.costas_run(state.costas, symbols, params,
                                              detector=_detector_for(cfg))
    diff_prev = state.diff_prev
    if cfg.differential:
        bits, diff_prev = differential.diff_decode_symbols(derot, diff_prev)
    else:
        bits = _slice_bits(cfg, derot)
    out = RxOut(symbols=derot, bits=bits,
                freq_hz=costas_ops.freq_to_hz(cstate.freq, cfg.rs),
                timing_index=index)
    new_state = state._replace(fir_tail=fir_tail, nco_phase=nco_phase,
                               costas=cstate, decim_delay=decim_delay,
                               diff_prev=diff_prev, timing=timing_state,
                               eq=eq_state, agc=agc_state)
    return new_state, out


def rx_stream(cfg: ModemConfig, state: RxState, pcm: jnp.ndarray):
    """Demodulate (..., nframes, frame_size) PCM.

    Two lowerings with identical frame semantics:

    * **fused** (default): the whole stream is one mix + one block FIR +
      batched per-frame timing/decimation + ONE Costas scan across all
      symbols.  Only the Costas recurrence is sequential; every fixed cost
      is paid once.  The Costas loop runs as the fused kernel on the GPU
      (ops/pallas/costas_kernel.py) and as a ``lax.scan`` elsewhere.
    * **frame scan** (parity mode, ``nco_mode == "exact"``): scans
      ``rx_frame`` like the C loop, renormalizing the NCO once per frame
      (qpsk.c:120) — bit-faithful to the reference's per-frame seams.
    """
    if cfg.nco_mode == "exact":
        return _rx_stream_scan(cfg, state, pcm)
    return _rx_stream_fused(cfg, state, pcm)


def _rx_stream_scan(cfg: ModemConfig, state: RxState, pcm: jnp.ndarray):
    xs = jnp.moveaxis(pcm, -2, 0)

    def step(st, frame):
        st, out = rx_frame(cfg, st, frame)
        return st, out

    state, outs = jax.lax.scan(step, state, xs)
    # scan stacks frames on axis 0; put the frame axis next to the per-frame
    # payload axis for symbol/bit arrays, last for scalar metrics.
    outs = RxOut(
        symbols=CF32(jnp.moveaxis(outs.symbols.re, 0, -2),
                     jnp.moveaxis(outs.symbols.im, 0, -2)),
        bits=jnp.moveaxis(outs.bits, 0, -2),
        freq_hz=jnp.moveaxis(outs.freq_hz, 0, -1),
        timing_index=jnp.moveaxis(outs.timing_index, 0, -1))
    return state, outs


def frontend_xla(cfg: ModemConfig, pcm: jnp.ndarray, nco_phase: CF32,
                 fir_tail: CF32):
    """Staged XLA front-end over (..., nframes, frame_size) int16 PCM,
    mix-free (modulated taps, ops/frontend.py): raw PCM -> complex
    matched filter -> power timing -> decimate -> per-pick carrier phasor.

    Covers the power-timing fast path (fir_precision "fast", nco "fast");
    the state contract matches the other lowerings (mixed-domain
    ``fir_tail``, unit NCO phasor), so calls chain interchangeably with
    the per-frame scan.  Returns
    (picks CF32 (..., nframes, nsym), index (..., nframes) int32,
    new_nco_phase, new_fir_tail).
    """
    from qpsk_tpu.ops import frontend as fe

    batch = pcm.shape[:-2]
    nframes, fsz = pcm.shape[-2], pcm.shape[-1]
    n = nframes * fsz
    omega = float(-cfg.omega_center)

    flat = pcm.reshape(batch + (n,)).astype(jnp.float32) / jnp.float32(
        cfg.pcm_scale)
    raw_tail = fe.unmix_tail(fir_tail, nco_phase, omega)
    block = _pick_block(fsz)
    tre, tim = _tmat_mod_for(cfg, block)
    u, _ = rrc_ops.fir_block_modulated(flat, raw_tail, jnp.asarray(tre),
                                       jnp.asarray(tim), cfg.gain, block)
    frames = CF32(u.re.reshape(batch + (nframes, fsz)),
                  u.im.reshape(batch + (nframes, fsz)))
    picks_u, index = timing_ops.estimate_and_decimate(frames, cfg.cycles,
                                                      "power")
    picks = fe.rotate_picks(picks_u, index, nco_phase, omega, fsz,
                            cfg.cycles)
    new_phase = fe.advance_phase(nco_phase, omega, n)
    new_tail = fe.remix_tail(flat, nco_phase, omega, cfg.ntaps - 1)
    return picks, index, new_phase, new_tail


def _use_modulated_xla(cfg: ModemConfig) -> bool:
    """The mix-free staged chain covers the default fast path; anything
    else (parity precision, exact NCO, fractional/tracking timing — the
    interpolated VALUES are not carrier-invariant) keeps the full-rate
    mix staging."""
    return (cfg.timing_mode == "power"
            and cfg.fir_precision == "fast"
            and cfg.nco_mode == "fast")


def _use_costas_kernel(cfg: ModemConfig) -> bool:
    """The fused Costas kernel (ops/pallas/costas_kernel.py) or the
    ``lax.scan`` lowering.  "auto" takes the kernel on the GPU only; a
    forced "pallas" off the GPU raises in the kernel unless the caller
    asked for interpret mode."""
    if cfg.costas_impl == "pallas":
        return True
    return cfg.costas_impl == "auto" and jax.default_backend() == "gpu"


def _rx_stream_fused(cfg: ModemConfig, state: RxState, pcm: jnp.ndarray,
                     interpret: bool = False):
    batch = pcm.shape[:-2]
    nframes, fsz = pcm.shape[-2], pcm.shape[-1]
    nsf = cfg.symbols_per_frame
    n = nframes * fsz

    params = costas_ops.costas_params(cfg.loop_bw, cfg.damping,
                                      cfg.min_freq, cfg.max_freq)
    gear = _gear_for(cfg)
    use_kernel = _use_costas_kernel(cfg)

    timing_state = state.timing
    if _use_modulated_xla(cfg):
        picks, index, nco_phase, fir_tail = frontend_xla(
            cfg, pcm, state.nco_phase, state.fir_tail)
    else:
        flat = pcm.reshape(batch + (n,)).astype(jnp.float32) / jnp.float32(
            cfg.pcm_scale)
        x = CF32(flat, jnp.zeros_like(flat))
        x, nco_phase = nco.mix(x, state.nco_phase, -cfg.omega_center, "fast")
        block = _pick_block(fsz)
        tmat = jnp.asarray(_tmat_for(cfg, block))
        x, fir_tail = rrc_ops.fir_block(x, state.fir_tail, tmat, cfg.gain,
                                        block, precision=_prec(cfg))

        frames = CF32(x.re.reshape(batch + (nframes, fsz)),
                      x.im.reshape(batch + (nframes, fsz)))
        if cfg.timing_mode == "tracking":
            tau, timing_state = timing_ops.timing_track(frames, cfg.cycles,
                                                        timing_state)
            picks = timing_ops.decimate_fractional(frames, tau, cfg.cycles)
            index = jnp.round(tau).astype(jnp.int32)
        else:
            picks, index = timing_ops.estimate_and_decimate(
                frames, cfg.cycles, cfg.timing_mode)

    # per-frame decimation picks feed the one-frame delay in batch:
    # outputs for frame f are the picks of frame f-1 (qpsk.c:186-191)
    delayed = CF32(
        jnp.concatenate([state.decim_delay.re[..., None, :],
                         picks.re[..., :-1, :]], axis=-2),
        jnp.concatenate([state.decim_delay.im[..., None, :],
                         picks.im[..., :-1, :]], axis=-2))
    decim_delay = CF32(picks.re[..., -1, :], picks.im[..., -1, :])

    # the kernel applies the frame-rate AGC gains as it loads each symbol;
    # the CMA equalizer sits between the AGC and the loop, so with it on
    # the gains are applied here
    agc_in_kernel = use_kernel and cfg.agc and cfg.eq_taps == 0
    agc_state = state.agc
    if cfg.agc and not agc_in_kernel:
        # frame-rate AGC (ops/agc.py): normalize unknown input levels to
        # the nominal symbol RMS before the amplitude-sensitive stages
        # (Costas error gain, CMA modulus target)
        from qpsk_tpu.ops import agc as agc_ops
        agc_state, delayed = agc_ops.agc_stream(
            agc_state, delayed, cfg.agc_target, cfg.agc_mu)

    eq_state = state.eq
    if cfg.eq_taps > 0:
        # blind CMA channel equalizer on the pre-Costas symbols
        # (ops/equalizer.py): carrier-phase invariant, so it sits between
        # decimation and carrier recovery; frame-rate block updates keep
        # the sequential chain nframes long
        from qpsk_tpu.ops import equalizer as eq_ops
        eq_state, delayed = eq_ops.equalize_stream(
            eq_state, delayed, cfg.eq_mu, cfg.eq_modulus)

    symbols = CF32(delayed.re.reshape(batch + (nframes * nsf,)),
                   delayed.im.reshape(batch + (nframes * nsf,)))
    if use_kernel:
        from qpsk_tpu.ops.pallas import costas_kernel
        # the kernel wants time-major (T, C) planes: flatten the batch
        c = int(np.prod(batch, dtype=np.int64))
        t = nframes * nsf
        zr = symbols.re.reshape(c, t).T
        zi = symbols.im.reshape(c, t).T
        gains = None
        if agc_in_kernel:
            from qpsk_tpu.ops import agc as agc_ops
            est, gains = agc_ops.agc_gains_tm(
                state.agc.reshape(c), zr, zi, nframes, cfg.agc_target,
                cfg.agc_mu)
            agc_state = est.reshape(batch)
        mod = _mod_for(cfg)
        cstate, derot_tm, freq_frames = costas_kernel.costas_run_tm(
            jax.tree.map(lambda x: x.reshape(c), state.costas), zr, zi,
            params, gear=gear, trace_every=nsf,
            dd=(cfg.modulation, cfg.agc_target) if mod is not None else None,
            gains=gains, interpret=interpret)
        cstate = jax.tree.map(lambda x: x.reshape(batch), cstate)
        derot = CF32(derot_tm.re.T.reshape(batch + (t,)),
                     derot_tm.im.T.reshape(batch + (t,)))
        freq_frames = freq_frames.reshape(batch + (nframes,))
    elif gear is not None:
        cstate, derot, freq_trace = costas_ops.costas_run_gear_traced(
            state.costas, symbols, params, gear, unroll=8)
        freq_frames = freq_trace.reshape(batch + (nframes, nsf))[..., -1]
    else:
        cstate, derot, freq_trace = costas_ops.costas_run_traced(
            state.costas, symbols, params, unroll=8,
            detector=_detector_for(cfg))
        freq_frames = freq_trace.reshape(batch + (nframes, nsf))[..., -1]

    # slice, read the frequency back per frame boundary (qpsk.c:217)
    diff_prev = state.diff_prev
    if cfg.differential:
        bits, diff_prev = differential.diff_decode_symbols(derot, diff_prev)
    else:
        bits = _slice_bits(cfg, derot)
    out = RxOut(
        symbols=CF32(derot.re.reshape(batch + (nframes, nsf)),
                     derot.im.reshape(batch + (nframes, nsf))),
        bits=bits.reshape(batch + (nframes, cfg.bits_per_symbol * nsf)),
        freq_hz=costas_ops.freq_to_hz(freq_frames, cfg.rs),
        timing_index=index)
    new_state = state._replace(fir_tail=fir_tail, nco_phase=nco_phase,
                               costas=cstate, decim_delay=decim_delay,
                               diff_prev=diff_prev, timing=timing_state,
                               eq=eq_state, agc=agc_state)
    return new_state, out

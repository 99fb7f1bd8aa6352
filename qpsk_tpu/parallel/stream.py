"""Sequence (time-block) parallelism for one long sample stream
(BASELINE config #5) — the modem-world analogue of context parallelism.

A length-n PCM stream is split into S contiguous blocks, one per device on
the mesh's 'sp' axis.  Per block:

* **NCO mix-down** — the free-running RX NCO is a pure geometric phasor
  sequence, so each block's start phase is the closed form
  ``exp(-j·ω·s·L)`` (computed host-side in float64 and passed in sharded;
  no recurrence crosses the boundary).
* **RRC matched filter** — overlap-save: each shard needs the previous
  shard's last ``ntaps-1`` mixed samples; one ``lax.ppermute`` neighbor
  shift delivers the halo between devices (shard 0 receives zeros,
  matching the cold delay line, qpsk.c:37).  After the halo, the FIR is the
  same Toeplitz matmul as the serial path — outputs are **bit-identical** to the
  single-device chain.
* **timing + decimation** — per-frame, local.  This mode emits *undelayed*
  symbols (the reference's one-frame decimation delay, qpsk.c:186-191, is
  an output-alignment artifact of its streaming loop, meaningless when
  blocks are decoded independently).
* **Costas** — the loop-carried recurrence is the one truly serial piece
  (SURVEY.md §7 hard-part #1).  Here each block *re-acquires* carrier
  independently: a 4th-power FFT estimate (ops/acquire.py) warm-starts the
  block's loop, so blocks decode in parallel at the cost of a short
  per-block convergence transient and an independent 90°-ambiguity per
  block — both resolved by the packet layer's CRC sync (qpsk_tpu.sync),
  exactly like a burst receiver.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from qpsk_tpu.config import TAU, ModemConfig
from qpsk_tpu.modem import _pick_block, _prec, _tmat_for
from qpsk_tpu.ops import costas as costas_ops
from qpsk_tpu.ops import acquire, modmap, nco, timing as timing_ops
from qpsk_tpu.ops import rrc as rrc_ops
from qpsk_tpu.ops.cplx import CF32

__all__ = ["rx_frontend_timeparallel", "rx_stream_timeparallel"]


def _start_phases(omega: float, nshards: int, block_len: int) -> np.ndarray:
    """Per-shard NCO start phasor exp(j·ω·s·L), float64-wrapped to keep
    precision for large sample offsets."""
    ang = np.mod(omega * np.arange(nshards, dtype=np.float64) * block_len, TAU)
    return np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)


def _halo_from_left(tail: CF32, axis: str) -> CF32:
    """Shift each shard's FIR tail to its right neighbor; shard 0 gets
    zeros (ppermute leaves unmatched receivers zero-filled)."""
    n = jax.lax.axis_size(axis)
    perm = [(i, i + 1) for i in range(n - 1)]
    return CF32(jax.lax.ppermute(tail.re, axis, perm),
                jax.lax.ppermute(tail.im, axis, perm))


def _mixdown_fir_local(cfg: ModemConfig, pcm_local: jnp.ndarray,
                       phase0: jnp.ndarray, axis: str) -> CF32:
    """Shared front-end body: PCM → mixed-down → halo → matched filter.

    The halo only feeds the FIRST output tile's tail matmul, but calling
    ``fir_block`` with the exchanged halo concats it into the batched
    ``prev`` operand — a FALSE dependency that stalls every tile's matmul
    on the ``ppermute``.  Here the split-matmul fast path is inlined with
    tile 0's tail contribution split out, so the bulk of the FIR (and the
    interior tails, which are local slices) has no dataflow edge from the
    collective and XLA can overlap it with the exchange — the fixed
    per-launch collective cost the round-4 sp decomposition identified.
    Bit-identical to ``fir_block``: the same two partial sums per output
    in the same association ((tail @ T1) + (block @ T2), then * gain;
    splitting the tail matmul's tile batch does not reorder any per-tile
    K accumulation).
    """
    L = pcm_local.shape[-1]
    ntm1 = cfg.ntaps - 1
    xr = pcm_local.astype(jnp.float32) / jnp.float32(cfg.pcm_scale)
    # fast NCO ramp from this block's closed-form start phase
    ph0 = CF32(phase0[..., 0], phase0[..., 1])
    x, _ = nco.mix(CF32(xr, jnp.zeros_like(xr)), ph0,
                   -cfg.omega_center, "fast")

    tail = CF32(x.re[..., L - ntm1:], x.im[..., L - ntm1:])
    block = _pick_block(L)
    tmat = jnp.asarray(_tmat_for(cfg, block))
    prec = _prec(cfg)
    if prec != jax.lax.Precision.DEFAULT or block < ntm1:
        # parity-precision path keeps the windowed single-accumulation
        # fir_block (the halo lands in the window concat; exactness over
        # overlap)
        halo = _halo_from_left(tail, axis)
        y, _ = rrc_ops.fir_block(x, halo, tmat, cfg.gain, block,
                                 precision=prec)
        return y
    nb = L // block
    g = jnp.float32(cfg.gain)

    def bulk(plane):
        blocks = plane.reshape(nb, block)
        b = jnp.matmul(blocks, tmat[ntm1:],
                       preferred_element_type=jnp.float32, precision=prec)
        a_int = jnp.matmul(blocks[:-1, block - ntm1:], tmat[:ntm1],
                           preferred_element_type=jnp.float32,
                           precision=prec)
        return b, a_int

    br, air = bulk(x.re)
    bi, aii = bulk(x.im)
    halo = _halo_from_left(tail, axis)         # issued after the bulk FIR

    def finish(b, a_int, h):
        a0 = jnp.matmul(h[None, :], tmat[:ntm1],
                        preferred_element_type=jnp.float32, precision=prec)
        a = jnp.concatenate([a0, a_int], axis=0)
        return ((a + b) * g).reshape(L)

    return CF32(finish(br, air, halo.re), finish(bi, aii, halo.im))


def rx_frontend_timeparallel(cfg: ModemConfig, pcm: jnp.ndarray, mesh: Mesh,
                             axis: str = "sp") -> CF32:
    """Mix-down + RRC matched filter of a (n,) PCM stream, time-sharded.

    Bit-identical to the serial front-end (the halo exchange reproduces the
    streaming delay line exactly); used directly by tests as the sharding
    correctness anchor.
    """
    nshards = mesh.shape[axis]
    n = pcm.shape[-1]
    assert n % nshards == 0, (n, nshards)
    L = n // nshards
    phases = jnp.asarray(_start_phases(-cfg.omega_center, nshards, L))

    def body(pcm_local, phase0):
        y = _mixdown_fir_local(cfg, pcm_local[0], phase0[0], axis)
        return y.re[None], y.im[None]

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(axis), P(axis)),
                   out_specs=(P(axis), P(axis)))
    re, im = fn(pcm.reshape(nshards, L), phases)
    return CF32(re.reshape(n), im.reshape(n))


def rx_stream_timeparallel(cfg: ModemConfig, pcm: jnp.ndarray, mesh: Mesh,
                           axis: str = "sp"):
    """Demodulate a (n,) PCM stream with time blocks across the mesh.

    Returns (symbols CF32 (nsym,), bits (2*nsym,), freq_hz (S,)): each
    block's Costas is warm-started by its own FFT acquisition; block
    boundaries behave like burst starts (resolve rotation with
    qpsk_tpu.sync per block region).
    """
    if cfg.modulation != "qpsk":
        # block-local demod below is QPSK-hardcoded (4th-power acquisition,
        # sign-detector Costas, QPSK slicer)
        raise ValueError(
            f"rx_stream_timeparallel is QPSK-only, got {cfg.modulation!r}")
    nshards = mesh.shape[axis]
    n = pcm.shape[-1]
    assert n % (nshards * cfg.frame_size) == 0, (n, nshards, cfg.frame_size)
    L = n // nshards
    nsym_local = L // cfg.cycles
    phases = jnp.asarray(_start_phases(-cfg.omega_center, nshards, L))
    params = costas_ops.costas_params(cfg.loop_bw, cfg.damping,
                                      cfg.min_freq, cfg.max_freq)

    def body(pcm_local, phase0):
        y = _mixdown_fir_local(cfg, pcm_local[0], phase0[0], axis)

        # per-frame timing, one index per frame, local to the block
        frames = CF32(y.re.reshape(-1, cfg.frame_size),
                      y.im.reshape(-1, cfg.frame_size))
        p, _ = timing_ops.estimate_and_decimate(frames, cfg.cycles,
                                                cfg.timing_mode)
        picks = CF32(p.re.reshape(-1), p.im.reshape(-1))

        # block-local carrier re-acquisition → warm Costas
        nfft = min(cfg.nfft, L)
        f_hz = acquire.acquire_freq_hz(CF32(y.re[:nfft], y.im[:nfft]),
                                       cfg.fs, nfft=nfft)
        freq0 = acquire.hz_to_costas_freq(f_hz, cfg.rs)
        # phase derives from freq0 (not a replicated constant) so the scan
        # carry's varying-manual-axes match under shard_map (see
        # costas_init_from_freq)
        gear = costas_ops.gear_for(cfg.loop_bw_track, cfg.damping)
        cstate = costas_ops.costas_init_from_freq(
            jnp.clip(freq0, cfg.min_freq, cfg.max_freq), gear is not None)
        if gear is not None:
            cstate, derot = costas_ops.costas_run_gear(cstate, picks, params,
                                                       gear)
        else:
            cstate, derot = costas_ops.costas_run(cstate, picks, params)
        bits = modmap.demod_bits(derot)
        fhz = costas_ops.freq_to_hz(cstate.freq, cfg.rs)
        return (derot.re[None], derot.im[None], bits[None], fhz[None])

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(axis), P(axis)),
                   out_specs=(P(axis), P(axis), P(axis), P(axis)))
    re, im, bits, fhz = fn(pcm.reshape(nshards, L), phases)
    nsym = n // cfg.cycles
    return (CF32(re.reshape(nsym), im.reshape(nsym)),
            bits.reshape(2 * nsym), fhz.reshape(nshards))

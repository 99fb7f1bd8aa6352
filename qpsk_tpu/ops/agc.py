"""Automatic gain control (frame-rate), on the decimated symbol stream.

Capability extension — the reference assumes its own fixed TX scaling: RX
divides by the exact int16 full-scale the TX multiplied by (qpsk.c:113,
qpsk.c:260), so a real link with unknown audio levels breaks two
amplitude-sensitive stages:

* the Costas loop's decision-directed error ``sign(Re)·Im − sign(Im)·Re``
  (costas_loop.c:44-47) scales linearly with symbol amplitude, so the
  effective loop bandwidth scales with input level — 20 dB low and the
  hand-tuned alpha/beta (README.md:12) are 10x too slow to pull in;
  20 dB hot and the loop over-corrects into instability;
* the CMA equalizer's constant-modulus target R (ops/equalizer.py) is an
  absolute amplitude.

Design (the same shape as the frame-rate timing PLL and the block-CMA
equalizer): a per-frame RMS measurement over the decimated symbols
(nsym-wide, fully batched) drives a one-pole gain
estimate carried across frames/chunks; each frame is scaled by
``target / rms_est``.  The sequential chain is nframes long (one `lax.scan`
already paid for by the equalizer path), not nsamples.  Timing estimation,
FFT acquisition and the CRC sync are scale-invariant, so the AGC sits
where the amplitude first matters: after decimation, before the
equalizer / Costas loop.

State is a single (...,) float32 smoothed-RMS estimate; 0 means "unset"
(the first frame seeds it with its own measurement — instant coarse
acquisition, then ``mu``-smoothed tracking).

**Cross-layout determinism**: the fused Costas kernel applies the gains
computed from time-major planes (``agc_gains_tm``) as it loads each symbol,
while the scan path scales the channel-major planes in XLA, and a 1-ULP
gain difference between the two would diverge the carrier-loop
trajectories from that frame on.  So every
value-producing reduction here is a FIXED expression tree of elementwise
ops — a halving-tree power sum (layout cannot reorder elementwise adds,
unlike an XLA ``reduce``) with the squares and the one-pole update's
product pinned by ``lax.optimization_barrier`` (FMA contraction is
per-compilation-context even within one compiler).  Both paths then feed
bit-identical gains into one IEEE multiply per symbol.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32


def agc_init(batch_shape=()) -> jnp.ndarray:
    """Carried smoothed symbol-RMS estimate; 0 = unset (seeded by the first
    frame's own measurement)."""
    return jnp.zeros(batch_shape, jnp.float32)


def _frame_power(re: jnp.ndarray, im: jnp.ndarray,
                 axis: int = -1) -> jnp.ndarray:
    """Mean |z|^2 over the symbol ``axis`` as a fixed halving tree of
    elementwise adds — bit-identical for any memory layout (and any
    ``axis`` placement) of the same logical values: an XLA ``reduce`` is
    free to pick a layout-dependent summation order, but each output
    element of the tree is a fixed expression over its own pairs
    ``p[.., 2i, ..] + p[.., 2i+1, ..]`` regardless of which axis carries
    the symbols.  The squares are staged through an optimization barrier
    so ``re*re + im*im`` cannot FMA-contract differently between
    compilation contexts.  The axis generality lets the time-major caller
    (``agc_gains_tm``) reduce (F, nsf, C) over axis 1 in place instead of
    materializing a (C, F, nsf) transpose of the full symbol planes."""
    pr, pi = jax.lax.optimization_barrier((re * re, im * im))
    p = pr + pi
    axis = axis % p.ndim
    n = p.shape[axis]
    inv = np.float32(1.0 / n)
    # HALVES pairing (p[..k..] + p[..k + n/2..]): contiguous slices, the
    # same tree whatever axis carries the symbols
    while n > 1 and n % 2 == 0:
        lo = jax.lax.slice_in_dim(p, 0, n // 2, axis=axis)
        hi = jax.lax.slice_in_dim(p, n // 2, n, axis=axis)
        p = lo + hi
        n //= 2
    if n > 1:   # odd residue (no real config: nsym/frame is a power of 2)
        p = jnp.sum(p, axis=axis)
    else:
        p = jnp.squeeze(p, axis=axis)
    return p * inv


def _est_update(rms_est: jnp.ndarray, rms: jnp.ndarray, mu: float):
    """One-pole smoothed-RMS update; 0 estimate seeds from the measurement.
    The ``mu * (rms - est)`` product is barrier-pinned (see module doc)."""
    d = jax.lax.optimization_barrier(jnp.float32(mu) * (rms - rms_est))
    return jnp.where(rms_est > 0.0, rms_est + d, rms)


def _gain(est: jnp.ndarray, target: float) -> jnp.ndarray:
    return jnp.float32(target) / jnp.maximum(est, 1e-6)


def agc_frame(rms_est: jnp.ndarray, frame: CF32, target: float, mu: float):
    """Scale one (..., nsym) frame of symbols to the target RMS.

    Returns (new_rms_est, scaled_frame).  The frame is scaled by the
    *updated* estimate (feedforward with smoothing): the first frame after
    cold start is already corrected by its own measurement rather than
    passing through at the wrong level.
    """
    p = _frame_power(frame.re, frame.im)
    rms = jnp.sqrt(p + 1e-12)
    est = _est_update(rms_est, rms, mu)
    gx = _gain(est, target)[..., None]
    return est, CF32(frame.re * gx, frame.im * gx)


def agc_gains(rms_est: jnp.ndarray, power: jnp.ndarray, target: float,
              mu: float):
    """Run the gain recursion over per-frame powers (..., nframes).

    Returns (new_rms_est, gains (..., nframes)) — the shared core of
    ``agc_stream`` (which then scales in XLA) and ``agc_gains_tm`` (which
    hands the gains to the fused Costas kernel to apply in-register)."""

    def step(est, p):
        rms = jnp.sqrt(p + 1e-12)
        est = _est_update(est, rms, mu)
        return est, _gain(est, target)

    # unroll: the body is a handful of (C,)-wide ops with a pinned
    # product — as a rolled scan each step lowers to its own tiny launch;
    # unrolling fuses the chain without touching the op sequence
    rms_est, g = jax.lax.scan(step, rms_est, jnp.moveaxis(power, -1, 0),
                              unroll=min(int(power.shape[-1]), 16))
    return rms_est, jnp.moveaxis(g, 0, -1)


def agc_stream(rms_est: jnp.ndarray, frames: CF32, target: float, mu: float):
    """Run the frame-rate AGC over (..., nframes, nsym) symbols.

    The per-symbol math is batched; only the scalar gain estimate scans
    over the frame axis.  Returns (new_rms_est, scaled (..., nframes, nsym)).
    """
    p = _frame_power(frames.re, frames.im)          # (..., nframes)
    rms_est, g = agc_gains(rms_est, p, target, mu)
    gx = g[..., None]
    return rms_est, CF32(frames.re * gx, frames.im * gx)


def agc_gains_tm(rms_est: jnp.ndarray, zr_tm: jnp.ndarray,
                 zi_tm: jnp.ndarray, nframes: int, target: float,
                 mu: float):
    """Per-frame AGC gains from TIME-MAJOR (T, C) symbol planes (the fused
    Costas kernel's input layout) — for its in-kernel gain application
    (``costas_kernel.costas_run_tm(gains=)``).

    Returns (new_rms_est (C,), gains (nframes, C)), with values
    bit-identical to what ``agc_stream`` computes on the same logical
    symbols in channel-major layout (the fixed-tree power sum is
    layout-invariant; see module doc)."""
    t, c = zr_tm.shape
    nsf = t // nframes
    # reduce the symbol axis IN the tm layout (axis 1 of (F, nsf, C)) —
    # the value tree is identical to the channel-major reduction, and no
    # full-rate transpose of the symbol planes ever materializes (the
    # first version transposed to (C, F, nsf) and cost 16QAM+AGC ~20%
    # of the whole RX rate in plane copies)
    p = _frame_power(zr_tm.reshape(nframes, nsf, c),
                     zi_tm.reshape(nframes, nsf, c), axis=1)   # (F, C)
    rms_est, g = agc_gains(rms_est, p.T, target, mu)           # (C, F)
    return rms_est, g.T                                        # (F, C)

"""Numerically-controlled oscillators (carrier mixers).

The reference runs two free-running complex NCOs, one per direction, as a
sequential per-sample phasor product ``phase *= rect`` (qpsk.c:115, 248-251)
renormalized once per frame to stop magnitude drift (qpsk.c:120, 253).

Design: the phasor sequence is a pure geometric series, so the
mixer is the closed form ``phase0 * exp(j * omega * (1 + arange(n)))`` — an
embarrassingly parallel ramp with a single complex phasor carry
(``mode="fast"``).  ``mode="exact"`` reproduces the C sequential float32
product in a ``lax.scan`` for parity testing; the two agree to ~1e-4 over a
frame (the C version accumulates one rounding per sample and is renormalized
per frame).

State is the current phasor (CF32 scalar per channel, unit magnitude),
matching the C globals ``fbb_tx_phase``/``fbb_rx_phase`` (qpsk.c:45-50).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32, cmul, cnormalize


def nco_init(batch_shape=()) -> CF32:
    """phase = cmplx(0) = 1+0j (qpsk.c:316, 341)."""
    return CF32(jnp.ones(batch_shape, jnp.float32),
                jnp.zeros(batch_shape, jnp.float32))


def mix(x: CF32, phase: CF32, omega: float, mode: str = "fast"):
    """Mix ``x`` (..., n) with the NCO at ``omega`` rad/sample, advancing the
    carried phasor.  TX uses ``+TAU*(CENTER+offset)/FS`` (qpsk.c:320), RX the
    conjugate at CENTER (qpsk.c:342) — pass negative omega for that.

    Matches the C update order: the phase is advanced *before* each sample is
    multiplied (qpsk.c:114-118, 248-251), and the carry is renormalized at
    block end (qpsk.c:120, 253).

    Returns (y, new_phase); ``phase`` broadcasts over leading batch axes.
    """
    n = x.shape[-1]
    if mode == "fast":
        steps = np.arange(1, n + 1, dtype=np.float64)
        ramp = CF32(jnp.asarray(np.cos(omega * steps), jnp.float32),
                    jnp.asarray(np.sin(omega * steps), jnp.float32))
        phasors = cmul(CF32(phase.re[..., None], phase.im[..., None]), ramp)
        y = cmul(x, phasors)
        new_phase = cnormalize(CF32(phasors.re[..., -1], phasors.im[..., -1]))
        return y, new_phase
    elif mode == "exact":
        rect = CF32(jnp.float32(np.cos(omega)), jnp.float32(np.sin(omega)))

        def step(ph, xi):
            ph = cmul(ph, rect)
            return ph, cmul(ph, CF32(*xi))

        ph, (yr, yi) = jax.lax.scan(
            step, phase, (jnp.moveaxis(x.re, -1, 0), jnp.moveaxis(x.im, -1, 0)))
        y = CF32(jnp.moveaxis(yr, 0, -1), jnp.moveaxis(yi, 0, -1))
        return y, cnormalize(ph)
    raise ValueError(f"unknown nco mode {mode!r}")


def mix_chirp(x: CF32, phase: CF32, omega: float, domega: float):
    """Mix with a linearly-chirping carrier: the quadratic-phase closed
    form ``theta_k = omega*(k+1) + 0.5*domega*k^2`` (Doppler-ramp
    stimulus).  Same advance-before-multiply convention as ``mix``; the
    carried phase is only exact within one call (the instantaneous
    frequency at the block end is not folded back into ``omega``)."""
    n = x.shape[-1]
    k = np.arange(n, dtype=np.float64)
    theta = omega * (k + 1.0) + 0.5 * domega * k * k
    ramp = CF32(jnp.asarray(np.cos(theta), jnp.float32),
                jnp.asarray(np.sin(theta), jnp.float32))
    phasors = cmul(CF32(phase.re[..., None], phase.im[..., None]), ramp)
    y = cmul(x, phasors)
    new_phase = cnormalize(CF32(phasors.re[..., -1], phasors.im[..., -1]))
    return y, new_phase

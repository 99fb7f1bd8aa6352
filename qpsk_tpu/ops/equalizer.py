"""Blind adaptive channel equalizer (CMA), frame-rate block updates.

Capability extension — the reference assumes a flat channel (its loopback
is a noiseless spool file, qpsk.c:289-359).  Real audio-band radio links
(the reference's target medium, README.md:2) see multipath: a two-ray HF/
VHF channel smears symbols into their neighbors and the Costas+slicer
chain alone cannot decode through it (see qpsk_tpu/channel.multipath_pcm).

Design (the same shape as the frame-rate timing PLL,
ops/timing.timing_track):

* **Constant-modulus algorithm** (Godard), symbol-spaced, running on the
  decimated symbol stream *before* the Costas loop.  CMA's cost
  ``(|y|^2 - R)^2`` is carrier-phase invariant, so it converges on the
  still-rotating pre-Costas symbols — no decisions needed, no carrier
  coupling; the Costas loop then locks on the equalized constellation.
  A residual carrier offset only rotates the converged taps by a static
  per-tap phase (absorbed by the adaptation).
* **Block (frame-rate) adaptation**: within a frame every output
  ``y_i = sum_k w_k x_{i-k}`` and the CMA gradient are computed fully
  batched (L shifted slices, no gathers); the tap update is
  applied once per frame.  The sequential chain is nframes long, not
  nsymbols — 128x shorter than a per-symbol LMS scan, and it rides the
  same ``lax.scan`` the stream already pays for nothing extra.
* State is an explicit pytree ``(w, hist)`` — taps + the last L-1 symbols
  of the previous frame (cross-frame ISI continuity), vmappable over
  channels and shardable like every other RxState leaf.

Scale note: CMA drives ``|y| -> sqrt(R)``.  The slicer and Costas detector
are sign-based (scale-free), so R only sets the output amplitude; the
default matches the modem's nominal post-matched-filter symbol modulus
(~1.45, the double-GAIN passband gain of rrc_fir.c:28,74).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from qpsk_tpu.ops.cplx import CF32


def eq_init(taps: int, batch_shape=()) -> tuple:
    """(w, hist): center-spike taps (w[center] = 1) + zero history."""
    assert taps >= 1
    center = taps // 2
    w_re = jnp.zeros(batch_shape + (taps,), jnp.float32).at[..., center].set(1.0)
    w = CF32(w_re, jnp.zeros(batch_shape + (taps,), jnp.float32))
    hist = CF32(jnp.zeros(batch_shape + (taps - 1,), jnp.float32),
                jnp.zeros(batch_shape + (taps - 1,), jnp.float32))
    return (w, hist)


def _filter_frame(w: CF32, xext: CF32, nsym: int, taps: int) -> CF32:
    """y_i = sum_k w_k * x_{i-k} over one tail-extended frame
    (xext = [hist | frame], length taps-1+nsym) as L shifted
    slice-multiplies — static slices, no gathers."""
    yr = jnp.zeros(xext.shape[:-1] + (nsym,), jnp.float32)
    yi = jnp.zeros_like(yr)
    for k in range(taps):
        s = taps - 1 - k
        xr = xext.re[..., s:s + nsym]
        xi = xext.im[..., s:s + nsym]
        wr = w.re[..., k:k + 1]
        wi = w.im[..., k:k + 1]
        yr = yr + wr * xr - wi * xi
        yi = yi + wr * xi + wi * xr
    return CF32(yr, yi)


def cma_frame(state: tuple, frame: CF32, mu: float, modulus2: float):
    """Equalize one frame of symbols and apply one block-CMA tap update.

    Args:
      state: (w CF32 (..., L), hist CF32 (..., L-1)).
      frame: (..., nsym) decimated (pre-Costas) symbols.
      mu: adaptation step (per frame, normalized by nsym and input power).
      modulus2: CMA target R = |y|^2 at convergence.

    Returns (new_state, y CF32 (..., nsym)) — y uses the *incoming* taps
    (output first, then adapt: the update never rewrites history).
    """
    w, hist = state
    taps = w.shape[-1]
    nsym = frame.shape[-1]
    xext = CF32(jnp.concatenate([hist.re, frame.re], axis=-1),
                jnp.concatenate([hist.im, frame.im], axis=-1))
    y = _filter_frame(w, xext, nsym, taps)

    # CMA error e_i = y_i (|y_i|^2 - R); gradient g_k = mean_i e_i conj(x_{i-k})
    p = y.re * y.re + y.im * y.im
    err = p - jnp.float32(modulus2)
    er = y.re * err
    ei = y.im * err
    # normalized step: invariant to input scale (R mis-set only changes
    # output amplitude, not stability)
    xp = jnp.mean(xext.re * xext.re + xext.im * xext.im,
                  axis=-1, keepdims=True) + 1e-6
    step = jnp.float32(mu) / (jnp.float32(nsym) * xp * xp)

    gr = []
    gi = []
    for k in range(taps):
        s = taps - 1 - k
        xr = xext.re[..., s:s + nsym]
        xi = xext.im[..., s:s + nsym]
        # e_i * conj(x): (er + j ei)(xr - j xi)
        gr.append(jnp.sum(er * xr + ei * xi, axis=-1, keepdims=True))
        gi.append(jnp.sum(ei * xr - er * xi, axis=-1, keepdims=True))
    grad = CF32(jnp.concatenate(gr, axis=-1), jnp.concatenate(gi, axis=-1))
    new_w = CF32(w.re - step * grad.re, w.im - step * grad.im)
    new_hist = CF32(xext.re[..., nsym:], xext.im[..., nsym:])
    return (new_w, new_hist), y


def equalize_stream(state: tuple, frames: CF32, mu: float, modulus2: float):
    """Run the frame-rate CMA over (..., nframes, nsym) symbols.

    All per-symbol math is batched; only the L-tap update scans over the
    frame axis.  Returns (new_state, y (..., nframes, nsym))."""

    def step(st, fr):
        st, y = cma_frame(st, CF32(*fr), mu, modulus2)
        return st, (y.re, y.im)

    xs = (jnp.moveaxis(frames.re, -2, 0), jnp.moveaxis(frames.im, -2, 0))
    state, (yr, yi) = jax.lax.scan(step, state, xs)
    return state, CF32(jnp.moveaxis(yr, 0, -2), jnp.moveaxis(yi, 0, -2))

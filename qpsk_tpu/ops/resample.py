"""Polyphase rational resampler (sample-rate conversion at the IO edge).

Capability extension — the reference runs end-to-end at exactly FS=9600 S/s
(qpsk.h:16) and assumes the audio device does too.  Real sound cards run at
44.1/48 kHz: a deployable modem needs a rate converter between the device
rate and the modem rate.  This module converts by any rational factor L/M
(48000/9600 = 5/1, 9600/44100 = 32/147, ...) with one anti-alias/anti-image
Kaiser-windowed-sinc prototype.

Design:

* **One matmul, no gathers, no zero-stuffing.**  The textbook structure
  (upsample xL -> FIR -> downsample xM) wastes (L-1)/L of its MACs on
  structural zeros and materializes an L-times-inflated signal.  Here the
  input is reshaped into M-sample groups and each group's L output samples
  are one row of a ``(..., n/M, (Q+1)*M) @ ((Q+1)*M, L)`` matmul against a
  static polyphase matrix (Q = ceil((K-1)/M) history groups for K taps per
  phase): y[jL+p] = sum_k h[(pM)%L + kL] * x[jM + floor(pM/L) - k].  The
  overlapping windows are static shifted slices of the group array (the
  ``rrc.fir_block`` split-matmul idiom), so the whole converter is matmul
  work at the *input* rate.
* **Streaming state** is the last Q*M input samples — chunked calls chain
  bit-exactly with the one-shot transform (same guarantee as the modem's
  FIR tail).
* The prototype is designed in f64 on host (cached per (L, M, K, beta))
  and cut off at min(fs_in, fs_out)/2: one filter serves as anti-image
  (upsampling) and anti-alias (downsampling).

This is an IO-edge adapter (runs once per stream at the audio rate), not a
modem hot-path kernel; the matmul form keeps it fast without a Pallas
lowering.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np


def rational_ratio(fs_in: float, fs_out: float, max_den: int = 1024):
    """(l, m) with fs_out/fs_in == l/m exactly (raises if not rational
    within max_den — e.g. 9600 -> 44100 gives (147, 32))."""
    fr = Fraction(fs_out / fs_in).limit_denominator(max_den)
    if abs(float(fr) * fs_in - fs_out) > 1e-6 * fs_out:
        raise ValueError(
            f"{fs_in} -> {fs_out} is not a rational ratio with denominator "
            f"<= {max_den}")
    return fr.numerator, fr.denominator


@functools.lru_cache(maxsize=None)
def resampler_taps(l: int, m: int, taps_per_phase: int = 16,
                   beta: float = 8.0) -> np.ndarray:
    """Prototype lowpass, f64-designed: Kaiser-windowed sinc cut at the
    narrower of the two Nyquists, normalized so the phase-average DC gain
    is exactly 1 (sum = L).

    Length scales with max(L, M) (rounded up to a multiple of L for the
    polyphase split): the filter must span ~taps_per_phase samples of the
    *narrower* band, so a decimator (M > L) needs M-times more taps at the
    upsampled rate than an interpolator of the same quality."""
    n = -(-taps_per_phase * max(l, m) // l) * l
    c = (n - 1) / 2.0
    fc = 1.0 / max(l, m)     # in units of the upsampled Nyquist
    i = np.arange(n, dtype=np.float64)
    h = fc * np.sinc(fc * (i - c)) * np.kaiser(n, beta)
    return (h * (l / h.sum())).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _poly_matrix(l: int, m: int, taps_per_phase: int, beta: float):
    """(G, Q): the ((Q+1)*M, L) polyphase matrix and the history-group
    count.  Window row r of group j is input sample x[(j-Q)*M + r];
    G[r, p] holds the tap multiplying it in output y[j*L + p]."""
    h = resampler_taps(l, m, taps_per_phase, beta)
    k_taps = len(h) // l
    q = max(1, math.ceil((k_taps - 1) / m))
    g = np.zeros(((q + 1) * m, l), np.float64)
    for p in range(l):
        base = (p * m) % l
        off = (p * m) // l
        for k in range(k_taps):
            r = q * m + off - k
            assert 0 <= r < (q + 1) * m, (r, p, k)
            g[r, p] = h[base + k * l]
    return g.astype(np.float32), q


def resample_init(l: int, m: int, taps_per_phase: int = 16,
                  batch_shape=()) -> jnp.ndarray:
    """Carried input history (..., Q*M) — zeros = silence before the
    stream (the converter's group delay is (len(taps)-1)/(2*L) input
    samples of fill-in transient)."""
    _, q = _poly_matrix(l, m, taps_per_phase, 8.0)
    return jnp.zeros(batch_shape + (q * m,), jnp.float32)


def resample_stream(x: jnp.ndarray, state: jnp.ndarray, l: int, m: int,
                    taps_per_phase: int = 16, beta: float = 8.0):
    """Convert (..., n) float32 samples by L/M; n must divide by M.

    Returns (y (..., n*L/M), new_state).  Chunked calls chain with one call
    over the concatenated input: bit-exactly when the chunks are large
    enough that XLA picks the same matmul tiling (the tested 1600+-sample
    chunks), and to float32 rounding (~1 ulp) in general — tiny chunks
    lower to a differently-tiled (often vector-matrix) product.
    """
    g_np, q = _poly_matrix(l, m, taps_per_phase, beta)
    n = x.shape[-1]
    if n % m != 0:
        raise ValueError(
            f"input length {n} must be a multiple of M={m} (pad the final "
            "chunk with silence)")
    j = n // m
    batch = x.shape[:-1]
    groups = x.reshape(batch + (j, m))
    hist = state.reshape(batch + (q, m))
    ext = jnp.concatenate([hist, groups], axis=-2)       # (..., J+Q, M)
    # window of group j = [groups[j-Q] .. groups[j]] = ext[j .. j+Q]:
    # Q+1 static shifted slices, concatenated on the tap axis
    w = jnp.concatenate([ext[..., s:s + j, :] for s in range(q + 1)],
                        axis=-1)                         # (..., J, (Q+1)M)
    y = jnp.matmul(w, jnp.asarray(g_np),
                   preferred_element_type=jnp.float32)   # (..., J, L)
    # Next call's history is the last Q*M input samples *including* the
    # carried state: a chunk shorter than Q*M (n - q*m < 0) must keep the
    # tail of the previous history, so slice ext, not x.
    new_state = ext.reshape(batch + ((j + q) * m,))[..., -q * m:]
    return y.reshape(batch + (j * l,)), new_state


def resample(x: jnp.ndarray, l: int, m: int, taps_per_phase: int = 16,
             beta: float = 8.0) -> jnp.ndarray:
    """One-shot L/M conversion of (..., n) float32 (n % M == 0)."""
    state = resample_init(l, m, taps_per_phase, x.shape[:-1])
    y, _ = resample_stream(x, state, l, m, taps_per_phase, beta)
    return y


def resample_pcm(pcm: jnp.ndarray, fs_in: float, fs_out: float,
                 taps_per_phase: int = 16) -> jnp.ndarray:
    """int16 PCM rate conversion fs_in -> fs_out (IO-edge convenience:
    pads the tail to a whole M-group with silence, rounds/clips back to
    int16)."""
    l, m = rational_ratio(fs_in, fs_out)
    x = pcm.astype(jnp.float32)
    npad = (-x.shape[-1]) % m
    if npad:
        x = jnp.concatenate(
            [x, jnp.zeros(x.shape[:-1] + (npad,), jnp.float32)], axis=-1)
    y = resample(x, l, m, taps_per_phase)
    return jnp.clip(jnp.round(y), -32768, 32767).astype(jnp.int16)

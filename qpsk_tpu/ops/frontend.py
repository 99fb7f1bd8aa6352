"""Shared math for the mix-free ("modulated taps") RX front-end.

For a constant-frequency NCO the per-sample carrier mix commutes with the
(LTI) matched filter:

    y[m] = Phi[m] * sum_k h[k] * e^{-j*w*k'} * x[m-k],
    Phi[m] = phase0 * e^{j*w*(m+1)}     (the mix convention of ops/nco.py,
                                         qpsk.c:114-118: advance-then-mul)

so the full-rate mix of the staged chain (qpsk.c:114-118 -> rrc_fir.c:17)
disappears into a static complex tap design ``hm[k] = h[k]*e^{j*w*(k-D)}``
(D = group delay): the matched filter runs directly on the RAW real PCM —
one real input plane instead of two mixed planes — and the carrier phasor
is applied only at the decimated symbol picks (1/cycles rate).  Energies
for the timing search are carrier-invariant (|Phi| == 1), so the whole
timing/decimation stage also runs mix-free.

The staged XLA chain (``qpsk_tpu.modem.frontend_xla``) builds on these
helpers.

The carried RxState contract is unchanged: ``fir_tail`` stays in the
*mixed* domain (the parity/scan paths and the time-parallel halo exchange
filter mixed signal), so the boundary helpers here un-mix the incoming
tail to raw PCM and re-mix the outgoing one.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32, cnormalize


@functools.lru_cache(maxsize=None)
def modulated_taps_np(taps_key: tuple, omega: float) -> np.ndarray:
    """Complex "modulated" RRC taps ``hm[k] = h[k] * e^{j*omega*(k - D)}``,
    D = ntaps-1 (the filter convention of ops/rrc.py: output t consumes
    inputs x[t - D .. t], rrc_fir.c:18-28).  f64-designed, (2, ntaps) f32.
    """
    taps = np.asarray(taps_key, np.float64)
    k = np.arange(taps.shape[0], dtype=np.float64) - (taps.shape[0] - 1)
    ang = omega * k
    return np.stack([taps * np.cos(ang), taps * np.sin(ang)]).astype(
        np.float32)


def _tail_phasors(phase0: CF32, omega: float, offsets: np.ndarray):
    """phase0 (x) e^{j*omega*s} for a static vector of sample offsets."""
    tr = jnp.asarray(np.cos(np.mod(omega * offsets, 2 * np.pi)), jnp.float32)
    ti = jnp.asarray(np.sin(np.mod(omega * offsets, 2 * np.pi)), jnp.float32)
    pr = phase0.re[..., None] * tr - phase0.im[..., None] * ti
    pi = phase0.re[..., None] * ti + phase0.im[..., None] * tr
    return pr, pi


def unmix_tail(fir_tail: CF32, phase0: CF32, omega: float) -> jnp.ndarray:
    """Mixed-domain carried FIR tail -> the raw real PCM samples it came
    from.  Tail sample k (k = 0..ntaps-2) sits at stream offset
    s = k - (ntaps-1) relative to this call's first sample; its mix phasor
    was ``phase0 * e^{j*omega*(s+1)}``.  PCM is real, so
    raw = Re(mixed * conj(phasor)) = m_re*p_re + m_im*p_im (unit phasor).
    """
    ntaps_m1 = fir_tail.shape[-1]
    offs = np.arange(-(ntaps_m1 - 1), 1, dtype=np.float64)  # s+1
    pr, pi = _tail_phasors(phase0, omega, offs)
    return fir_tail.re * pr + fir_tail.im * pi


def remix_tail(flat_raw: jnp.ndarray, phase0: CF32, omega: float,
               ntaps_m1: int) -> CF32:
    """The outgoing mixed-domain tail: this call's last ntaps-1 raw samples
    re-mixed with their phasors ``phase0 * e^{j*omega*(s+1)}``,
    s = n-(ntaps-1) .. n-1."""
    n = flat_raw.shape[-1]
    offs = np.arange(n - ntaps_m1, n, dtype=np.float64) + 1.0
    pr, pi = _tail_phasors(phase0, omega, offs)
    last = flat_raw[..., n - ntaps_m1:]
    return CF32(last * pr, last * pi)


def advance_phase(phase0: CF32, omega: float, n: int) -> CF32:
    """Closed-form NCO carry across n samples:
    ``normalize(phase0 * e^{j*omega*n})`` (the per-block renormalize of
    qpsk.c:120)."""
    ang = float(np.mod(omega * n, 2.0 * np.pi))
    er, ei = jnp.float32(np.cos(ang)), jnp.float32(np.sin(ang))
    return cnormalize(CF32(phase0.re * er - phase0.im * ei,
                           phase0.re * ei + phase0.im * er))


@functools.lru_cache(maxsize=None)
def _pick_base_np(omega: float, nframes: int, nsym: int, fsz: int,
                  cycles: int) -> np.ndarray:
    """Static per-(frame, symbol) phasor table
    A[f, i] = e^{j*omega*(f*fsz + i*cycles + 1)} (f64-designed)."""
    pos = (np.arange(nframes, dtype=np.float64)[:, None] * fsz
           + np.arange(nsym, dtype=np.float64)[None, :] * cycles + 1.0)
    ang = np.mod(omega * pos, 2.0 * np.pi)
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


def rotate_picks(picks_u: CF32, index: jnp.ndarray, phase0: CF32,
                 omega: float, fsz: int, cycles: int) -> CF32:
    """Apply the carrier phasor to mix-free decimated picks.

    ``picks_u``: (..., nframes, nsym) filtered-raw picks (u-domain);
    ``index``: (..., nframes) int32 decimation phase; pick (f, i) sits at
    stream sample ``f*fsz + i*cycles + index[f]``, so
    y = phase0 (x) A[f, i] (x) e^{j*omega*index} (x) u.
    """
    nframes, nsym = picks_u.shape[-2:]
    a = _pick_base_np(omega, nframes, nsym, fsz, cycles)
    ar, ai = jnp.asarray(a[0]), jnp.asarray(a[1])        # (nframes, nsym)

    # e^{j*omega*p} selected by the integer phase, via a one-hot
    # contraction over the tiny cycles axis (no gathers)
    pang = np.mod(omega * np.arange(cycles, dtype=np.float64), 2 * np.pi)
    oh = (index[..., None] ==
          jnp.arange(cycles, dtype=index.dtype)).astype(jnp.float32)
    rr = oh @ jnp.asarray(np.cos(pang), jnp.float32)     # (..., nframes)
    ri = oh @ jnp.asarray(np.sin(pang), jnp.float32)

    # combine phase0 (batch) x rot (frame) -> (..., nframes), then x A
    cr = phase0.re[..., None] * rr - phase0.im[..., None] * ri
    ci = phase0.re[..., None] * ri + phase0.im[..., None] * rr
    fr = cr[..., None] * ar - ci[..., None] * ai         # (..., nframes, nsym)
    fi = cr[..., None] * ai + ci[..., None] * ar
    return CF32(picks_u.re * fr - picks_u.im * fi,
                picks_u.re * fi + picks_u.im * fr)

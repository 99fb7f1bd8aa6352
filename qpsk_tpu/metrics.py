"""Link-quality metrics (capability extension — the reference records one
metric, the detected frequency offset, and never prints it; qpsk.c:217,211).

All meters are pure reductions, batched over leading axes, cheap enough to
live inside the jitted RX graph and be ``psum``-aggregated across a mesh.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32

_IDEAL_MAG = 1.0


class LinkMetrics(NamedTuple):
    evm_rms: jnp.ndarray      # (...,) RMS error vector magnitude (fraction)
    phase_err_rms: jnp.ndarray  # (...,) rad
    power: jnp.ndarray        # (...,) mean |sym|^2


def ber(bits_hat: jnp.ndarray, bits_ref: jnp.ndarray) -> jnp.ndarray:
    """Bit error rate over the last axis."""
    errs = (jnp.asarray(bits_hat, jnp.int32) ^ jnp.asarray(bits_ref, jnp.int32))
    return jnp.mean(errs.astype(jnp.float32), axis=-1)


def per(crc_ok: jnp.ndarray) -> jnp.ndarray:
    """Packet error rate from a (..., npackets) CRC verdict array."""
    return 1.0 - jnp.mean(crc_ok.astype(jnp.float32), axis=-1)


def snr_estimate_db(symbols: CF32) -> jnp.ndarray:
    """Blind per-channel SNR estimate (dB) from derotated symbols — the
    M2M4 moments estimator, exact for constant-modulus (PSK) signals in
    AWGN: with M2 = E|y|^2, M4 = E|y|^4, the signal power is
    S = sqrt(2 M2^2 - M4) and the noise N = M2 - S.  No pilots, no
    decisions, scale-free — a pure reduction that lives inside the jitted
    RX graph (feeds link adaptation / the observability dict)."""
    p = symbols.re ** 2 + symbols.im ** 2
    m2 = jnp.mean(p, axis=-1)
    m4 = jnp.mean(p * p, axis=-1)
    s = jnp.sqrt(jnp.maximum(2.0 * m2 * m2 - m4, 1e-30))
    n = jnp.maximum(m2 - s, 1e-30 * m2 + 1e-30)
    return 10.0 * jnp.log10(s / n)


def snr_estimate_db_host(re: np.ndarray, im: np.ndarray) -> float:
    """NumPy twin of :func:`snr_estimate_db` for host-side link counters.

    The streaming runtime downloads the (tiny) symbol block once and
    computes the M2M4 moments here instead of dispatching ~8 eager device
    ops per bucket (qpsk_tpu.runtime.StreamDemodulator._demod)."""
    p = np.asarray(re, np.float64) ** 2 + np.asarray(im, np.float64) ** 2
    m2 = float(p.mean())
    m4 = float((p * p).mean())
    s = math.sqrt(max(2.0 * m2 * m2 - m4, 1e-30))
    n = max(m2 - s, 1e-30 * m2 + 1e-30)
    return 10.0 * math.log10(s / n)


def evm(symbols: CF32, normalize: bool = True) -> LinkMetrics:
    """EVM of derotated QPSK symbols against the nearest ideal point.

    The decision grid is the 45°-rotated constellation the slicer uses
    (qpsk.c:74-79): ideal points are (±m, ±m)/√2 · √2 = sign-matched corners
    of magnitude ``m``.  With ``normalize`` the symbol cloud is first scaled
    to unit RMS so the chain's passband gain (the reference's double-GAIN
    ≈ 1.85², SURVEY.md C6) doesn't read as error.
    """
    p = jnp.mean(symbols.re ** 2 + symbols.im ** 2, axis=-1)
    scale = jnp.where(p > 0, 1.0 / jnp.sqrt(p), 1.0) if normalize else 1.0
    re = symbols.re * (scale[..., None] if normalize else 1.0)
    im = symbols.im * (scale[..., None] if normalize else 1.0)
    c = jnp.float32(1.0 / math.sqrt(2.0))
    ir = jnp.where(re >= 0, c, -c)
    ii = jnp.where(im >= 0, c, -c)
    err2 = (re - ir) ** 2 + (im - ii) ** 2
    evm_rms = jnp.sqrt(jnp.mean(err2, axis=-1))  # ideal power is 1
    phase = jnp.arctan2(im, re) - jnp.arctan2(ii, ir)
    phase = jnp.mod(phase + math.pi, 2 * math.pi) - math.pi
    return LinkMetrics(evm_rms=evm_rms,
                       phase_err_rms=jnp.sqrt(jnp.mean(phase ** 2, axis=-1)),
                       power=p)

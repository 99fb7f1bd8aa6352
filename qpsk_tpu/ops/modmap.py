"""Gray-coded QPSK symbol mapping and slicing.

Replicates the reference constellation and bit conventions exactly:

* constellation {1, +j, -j, -1} indexed by ``(b1 << 1) | b0`` (qpsk.c:58-63,
  269-271) — adjacent quadrants differ in one bit (Gray code);
* the TX dibit packing *swap*: ``dibit[0] = tx_bits[s+1]``,
  ``dibit[1] = tx_bits[s]`` (qpsk.c:278-279), so the constellation index for
  symbol ``i`` is ``(tx_bits[2i] << 1) | tx_bits[2i+1]``;
* the slicer: rotate by +45 degrees then sign-test,
  ``b0 = Re < 0``, ``b1 = Im < 0`` (qpsk.c:74-79).

Everything is vectorized over arbitrary leading batch axes and uses the
split-plane CF32 representation (no complex dtypes).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32, cmul

TAU = 2.0 * math.pi
ROTATE45 = math.pi / 4.0

# constellation[(b1<<1)|b0] (qpsk.c:58-63)
CONSTELLATION = np.array([1.0 + 0.0j, 0.0 + 1.0j, 0.0 - 1.0j, -1.0 + 0.0j],
                         dtype=np.complex64)
_CONST_RE = np.real(CONSTELLATION).astype(np.float32)
_CONST_IM = np.imag(CONSTELLATION).astype(np.float32)


def mod_symbols(indices: jnp.ndarray) -> CF32:
    """Constellation lookup for integer indices in [0, 4)."""
    return CF32(jnp.asarray(_CONST_RE)[indices], jnp.asarray(_CONST_IM)[indices])


def bits_to_symbols(bits: jnp.ndarray) -> CF32:
    """Pack a bit stream (..., 2*n) into n QPSK symbols with the reference
    dibit order (qpsk.c:273-285): index = (bits[2i] << 1) | bits[2i+1].

    Gather-free: for dibit (u, v) the constellation {1, +j, -j, -1} is the
    closed form ``re = (1-d)*s, im = d*s`` with ``s = 1-2u`` (sign) and
    ``d = u XOR v`` (axis select) — pure elementwise arithmetic, no
    table gather."""
    b = bits.reshape(bits.shape[:-1] + (-1, 2)).astype(jnp.float32)
    u, v = b[..., 0], b[..., 1]
    s = 1.0 - 2.0 * u
    d = u + v - 2.0 * u * v
    return CF32(((1.0 - d) * s).astype(jnp.float32),
                (d * s).astype(jnp.float32))


def demod_bits(symbols: CF32) -> jnp.ndarray:
    """Slice Costas-locked symbols (..., n) back to bits (..., 2*n).

    The decision-directed Costas detector (costas_loop.c:44-47) has its
    stable lock points on the **diagonals**: in steady state a TX symbol
    ``s`` arrives as ``s * e^{j(45° + k*90°)}`` (the reference's own scatter
    shows four clusters at (±1, ±1)).  The correct slicer therefore maps
    quadrants directly: for the canonical ``k = 0`` lock,

        b1 = Im < 0,  b0 = Re < 0,   index = (b1 << 1) | b0

    which inverts ``bits_to_symbols`` exactly (Gray property preserved; the
    residual 4-fold ``k`` ambiguity is resolved one layer up,
    qpsk_tpu.sync).  NOTE this deliberately *fixes* a reference defect:
    qpsk.c:74-79 rotates by +45° first, which puts the diagonal lock back
    onto the axes where one sign test is decided by noise — one bit per
    symbol becomes a coin toss (the README's "hit and miss" decode,
    README.md:10).  ``demod_bits_reference`` reproduces that behavior for
    parity testing.
    """
    b0 = (symbols.re < 0.0)
    b1 = (symbols.im < 0.0)
    bits = jnp.stack([b1, b0], axis=-1).astype(jnp.int32)
    return bits.reshape(symbols.shape[:-1] + (-1,))


def demod_soft(symbols: CF32, scale=1.0) -> jnp.ndarray:
    """Soft-decision twin of ``demod_bits``: LLR stream (..., 2*n), positive
    = bit 0, elementwise aligned with the hard bit stream ([b1, b0] per
    symbol).  For the diagonal Costas lock the per-bit decision statistics
    are simply the I/Q coordinates: ``llr(b1) = scale*im``,
    ``llr(b0) = scale*re`` (the exact LLR is ``2*sqrt(2)*A/sigma^2`` times
    the coordinate; max-sum FEC decoding (packet/fec.py) is invariant to
    positive scaling, so ``scale`` only matters if mixing streams of
    different SNR)."""
    llr = jnp.stack([symbols.im, symbols.re], axis=-1) * jnp.float32(scale)
    return llr.reshape(symbols.shape[:-1] + (-1,))


def demod_bits_reference(symbols: CF32) -> jnp.ndarray:
    """The reference's slicer, bug included (qpsk.c:74-79): rotate +45°,
    then b0 = Re < 0, b1 = Im < 0, stream order [b1, b0].  Against the
    diagonal Costas lock this leaves the rotated symbols on the axes, so
    one of the two sign tests is noise-decided.  Kept for behavioral parity
    with the C modem only."""
    rot45 = CF32(jnp.float32(math.cos(ROTATE45)), jnp.float32(math.sin(ROTATE45)))
    rot = cmul(symbols, rot45)
    b0 = (rot.re < 0.0)
    b1 = (rot.im < 0.0)
    bits = jnp.stack([b1, b0], axis=-1).astype(jnp.int32)
    return bits.reshape(symbols.shape[:-1] + (-1,))


def upsample_zero_stuff(symbols: CF32, cycles: int) -> CF32:
    """Zero-stuff upsample by ``cycles`` (qpsk.c:232-237): the symbol lands on
    phase 0 of each group, the remaining ``cycles - 1`` slots are zero."""

    def one(plane):
        # concat + reshape, not scatter: this form is pure layout
        zeros = jnp.zeros(plane.shape + (cycles - 1,), dtype=plane.dtype)
        out = jnp.concatenate([plane[..., None], zeros], axis=-1)
        return out.reshape(plane.shape[:-1] + (plane.shape[-1] * cycles,))

    return CF32(one(symbols.re), one(symbols.im))

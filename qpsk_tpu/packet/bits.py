"""Bit/byte/dibit packing helpers.

Canonical bit order is **LSB-first within each byte**, matching the
reference's packet primitives: the interleaver indexes bit ``i`` of a buffer
as ``(buf[i / 8] >> (i % 8)) & 1`` (interleave.c:67-74) and the scrambler
clocks the two LSBs of each dibit byte in order ``i = 0, 1``
(bit-scramble.c:57-69).

All functions are pure jnp ops over arbitrary leading batch axes; bits are
int32 arrays of 0/1 (cheap, and simpler than packed uint8 for the
XOR/permute ops downstream).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def bytes_to_bits(data: jnp.ndarray) -> jnp.ndarray:
    """(..., n) uint8 -> (..., 8n) bits, LSB-first per byte."""
    data = jnp.asarray(data)
    shifts = jnp.arange(8, dtype=jnp.int32)
    bits = (data[..., None].astype(jnp.int32) >> shifts) & 1
    return bits.reshape(data.shape[:-1] + (data.shape[-1] * 8,))


def bits_to_bytes(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., 8n) bits -> (..., n) uint8, LSB-first per byte."""
    bits = jnp.asarray(bits, jnp.int32)
    n = bits.shape[-1] // 8
    b = bits.reshape(bits.shape[:-1] + (n, 8))
    weights = (1 << jnp.arange(8, dtype=jnp.int32))
    return jnp.sum(b * weights, axis=-1).astype(jnp.uint8)


def bits_to_dibits(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., 2n) bits -> (..., n) dibit values, LSB of the dibit first
    (bit-scramble.c clocks i=0 then i=1 of each 2-bit group)."""
    bits = jnp.asarray(bits, jnp.int32)
    b = bits.reshape(bits.shape[:-1] + (-1, 2))
    return b[..., 0] | (b[..., 1] << 1)


def dibits_to_bits(dibits: jnp.ndarray) -> jnp.ndarray:
    """(..., n) dibit values -> (..., 2n) bits, LSB-first."""
    dibits = jnp.asarray(dibits, jnp.int32)
    bits = jnp.stack([dibits & 1, (dibits >> 1) & 1], axis=-1)
    return bits.reshape(dibits.shape[:-1] + (dibits.shape[-1] * 2,))


def np_bytes_to_bits(data: np.ndarray) -> np.ndarray:
    """Host-side twin of bytes_to_bits (numpy)."""
    data = np.asarray(data, np.uint8)
    return ((data[..., None] >> np.arange(8)) & 1).reshape(
        data.shape[:-1] + (data.shape[-1] * 8,)).astype(np.int32)


def np_bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, np.int32)
    n = bits.shape[-1] // 8
    b = bits.reshape(bits.shape[:-1] + (n, 8))
    return (b * (1 << np.arange(8))).sum(-1).astype(np.uint8)

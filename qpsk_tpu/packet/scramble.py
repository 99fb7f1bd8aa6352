"""DVB additive bit scrambler (polynomial 1 + X^14 + X^15, seed 0x4A80).

The reference clocks a 15-bit LFSR two bits at a time with the register in a
file-scope static (bit-scramble.c:41-69): per bit,

    out  = (mem >> 1 & 1) ^ (mem & 1)          # keystream bit
    bit ^= out
    mem  = (mem >> 1) | (out << 14)

The keystream is **input-independent** (additive scrambler), so the
design precomputes the whole keystream for a frame once (host-side numpy,
cached by (seed, length)) and the scramble itself is one vectorized XOR —
no recurrence on device.  Scramble and descramble are the same operation
(self-synchronizing additive design), and the per-frame reseed
(bit-scramble.h "Sync Seed is reset at the start of each frame") means the
same cached keystream serves every frame.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def keystream(nbits: int, seed: int = 0x4A80) -> np.ndarray:
    """First ``nbits`` LFSR output bits from ``seed`` (bit-scramble.c:57-69)."""
    out = np.zeros(nbits, dtype=np.int32)
    mem = seed
    for i in range(nbits):
        s = ((mem >> 1) & 1) ^ (mem & 1)
        out[i] = s
        mem = (mem >> 1) | (s << 14)
    return out


def scramble_bits(bits: jnp.ndarray, seed: int = 0x4A80) -> jnp.ndarray:
    """XOR a (..., nbits) bit stream with the frame keystream.  Involutory:
    applying it twice (same seed) returns the input, which is how RX
    descrambles (scramble == descramble, bit-scramble.c design)."""
    ks = jnp.asarray(keystream(int(bits.shape[-1]), seed))
    return jnp.asarray(bits, jnp.int32) ^ ks

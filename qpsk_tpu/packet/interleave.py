"""Golden-prime bit interleaver.

Reference semantics (interleave.c:33-74): with ``nbits = 8 * nbytes`` and
``b`` = the largest prime < nbits from a 69-entry table capped at 347,
bit ``i`` of the input moves to position ``j = (b * i) mod nbits``;
DEINTERLEAVE swaps (i, j).  Bits are addressed LSB-first within bytes
(interleave.c:67-74).

Design: the permutation depends only on ``nbits``, so it is precomputed
host-side (cached) and applied as a single ``jnp.take`` gather over the bit
axis — O(1) depth, trivially batched, and fuses with the surrounding XORs.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

# Same prime table as interleave.c:33-41.
_PRIMES = np.array([
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29,
    31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
    127, 131, 137, 139, 149, 151, 157, 163, 167, 173,
    179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
    233, 239, 241, 251, 257, 263, 269, 271, 277, 281,
    283, 293, 307, 311, 313, 317, 331, 337, 347], dtype=np.int64)


def golden_prime(nbits: int) -> int:
    """b = largest table prime < nbits (interleave.c:52-55; saturates at 347
    for frames longer than the table, matching the reference's index clamp)."""
    index = 1
    imax = len(_PRIMES)
    while index < imax and _PRIMES[index] < nbits:
        index += 1
    return int(_PRIMES[index - 1])


def _check_bijective(b: int, nbits: int) -> None:
    """The map i -> (b*i) mod nbits is a bijection iff gcd(b, nbits) == 1.
    The reference never checks (interleave.c silently destroys data when
    the saturated table prime divides nbits, e.g. nbits = 2776 = 8*347);
    we refuse such frame sizes instead."""
    import math
    if math.gcd(b, nbits) != 1:
        raise ValueError(
            f"golden prime {b} divides frame size {nbits} bits — the "
            f"interleaver permutation would not be invertible; choose a "
            f"frame size coprime with {b}")


@functools.lru_cache(maxsize=None)
def interleave_permutation(nbits: int) -> np.ndarray:
    """``perm`` such that ``out = in[perm]`` reproduces INTERLEAVE:
    out[(b*i) % nbits] = in[i]  ⇒  perm[(b*i) % nbits] = i."""
    b = golden_prime(nbits)
    _check_bijective(b, nbits)
    i = np.arange(nbits, dtype=np.int64)
    j = (b * i) % nbits
    perm = np.zeros(nbits, dtype=np.int32)
    perm[j] = i
    return perm


@functools.lru_cache(maxsize=None)
def deinterleave_permutation(nbits: int) -> np.ndarray:
    """Inverse gather: out[i] = in[(b*i) % nbits] (interleave.c:61-65)."""
    b = golden_prime(nbits)
    _check_bijective(b, nbits)
    i = np.arange(nbits, dtype=np.int64)
    return ((b * i) % nbits).astype(np.int32)


def interleave_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """Interleave the last axis of a (..., nbits) bit array."""
    perm = jnp.asarray(interleave_permutation(int(bits.shape[-1])))
    return jnp.take(bits, perm, axis=-1)


def deinterleave_bits(bits: jnp.ndarray) -> jnp.ndarray:
    perm = jnp.asarray(deinterleave_permutation(int(bits.shape[-1])))
    return jnp.take(bits, perm, axis=-1)

"""Complex arithmetic as explicit (I, Q) float32 pairs.

The reference leans on C99 ``complex float`` (qpsk.h:32-36).  Here complex
signals are split real/imaginary float32 planes: every complex multiply is
plain float ops that fuse with their neighbours, and complex x real-matrix
products (the RRC FIR, the DFT) become pairs of dense float32 matmuls.

``CF32`` is a NamedTuple — hence a pytree — of two equal-shaped float32
arrays.  All ops are free functions; slicing is done on the fields
(``CF32(z.re[..., :n], z.im[..., :n])``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class CF32(NamedTuple):
    re: jnp.ndarray
    im: jnp.ndarray

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim


def czeros(shape) -> CF32:
    return CF32(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))


def cones(shape) -> CF32:
    """Unit phasors at angle 0 (cmplx(0.0f) == 1+0j, qpsk.c:316)."""
    return CF32(jnp.ones(shape, jnp.float32), jnp.zeros(shape, jnp.float32))


def cfull(shape, value: complex) -> CF32:
    return CF32(jnp.full(shape, np.float32(value.real)),
                jnp.full(shape, np.float32(value.imag)))


def from_parts(re, im) -> CF32:
    return CF32(jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32))


def from_real(re) -> CF32:
    re = jnp.asarray(re, jnp.float32)
    return CF32(re, jnp.zeros_like(re))


def from_complex(z) -> CF32:
    """Host boundary: numpy complex -> CF32 (device-safe)."""
    z = np.asarray(z)
    return CF32(jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))


def to_complex(z: CF32) -> np.ndarray:
    """Host boundary: CF32 -> numpy complex64 (pulls to host)."""
    return np.asarray(z.re).astype(np.complex64) + 1j * np.asarray(z.im)


def cadd(a: CF32, b: CF32) -> CF32:
    return CF32(a.re + b.re, a.im + b.im)


def csub(a: CF32, b: CF32) -> CF32:
    return CF32(a.re - b.re, a.im - b.im)


def cmul(a: CF32, b: CF32) -> CF32:
    """(a.re + j a.im)(b.re + j b.im); same op order as C complex mul."""
    return CF32(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cmul_conj(a: CF32, b: CF32) -> CF32:
    """a * conj(b)."""
    return CF32(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def cscale(a: CF32, s) -> CF32:
    return CF32(a.re * s, a.im * s)


def cconj(a: CF32) -> CF32:
    return CF32(a.re, -a.im)


def cneg(a: CF32) -> CF32:
    return CF32(-a.re, -a.im)


def cabs2(a: CF32) -> jnp.ndarray:
    return a.re * a.re + a.im * a.im


def cabs(a: CF32) -> jnp.ndarray:
    return jnp.sqrt(cabs2(a))


def cnormalize(a: CF32) -> CF32:
    """a / |a| — the per-frame NCO renormalization (qpsk.c:120, 253)."""
    inv = 1.0 / cabs(a)
    return CF32(a.re * inv, a.im * inv)


def cexp(theta) -> CF32:
    """cmplx(theta) = cos + j sin (qpsk.h:35)."""
    theta = jnp.asarray(theta, jnp.float32)
    return CF32(jnp.cos(theta), jnp.sin(theta))


def cexp_conj(theta) -> CF32:
    """cmplxconj(theta) = cos - j sin (qpsk.h:36)."""
    theta = jnp.asarray(theta, jnp.float32)
    return CF32(jnp.cos(theta), -jnp.sin(theta))


def cangle(a: CF32) -> jnp.ndarray:
    return jnp.arctan2(a.im, a.re)


def cstack(parts, axis=0) -> CF32:
    return CF32(jnp.stack([p.re for p in parts], axis=axis),
                jnp.stack([p.im for p in parts], axis=axis))


def cconcat(parts, axis=-1) -> CF32:
    return CF32(jnp.concatenate([p.re for p in parts], axis=axis),
                jnp.concatenate([p.im for p in parts], axis=axis))


def ctake(a: CF32, idx, axis=-1) -> CF32:
    return CF32(jnp.take(a.re, idx, axis=axis), jnp.take(a.im, idx, axis=axis))


def ctake_along_axis(a: CF32, idx, axis=-1) -> CF32:
    return CF32(jnp.take_along_axis(a.re, idx, axis=axis),
                jnp.take_along_axis(a.im, idx, axis=axis))


def cmoveaxis(a: CF32, src, dst) -> CF32:
    return CF32(jnp.moveaxis(a.re, src, dst), jnp.moveaxis(a.im, src, dst))


def creshape(a: CF32, shape) -> CF32:
    return CF32(a.re.reshape(shape), a.im.reshape(shape))


def cslice_last(a: CF32, start: int, stop: int) -> CF32:
    return CF32(a.re[..., start:stop], a.im[..., start:stop])


def cwhere(pred, a: CF32, b: CF32) -> CF32:
    return CF32(jnp.where(pred, a.re, b.re), jnp.where(pred, a.im, b.im))


def cbroadcast_to(a: CF32, shape) -> CF32:
    return CF32(jnp.broadcast_to(a.re, shape), jnp.broadcast_to(a.im, shape))

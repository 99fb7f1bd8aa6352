"""DFT with the reference's normalization convention, as matmuls.

Convention (algorithms/fft.c): the forward ``fft``/``fftn`` divide by N
(fft.c:105-107, 117-119) while ``ifft``/``ifftn`` do **not** normalize
(fft.c:122-136) — so ``ifft(fft(x)) == x`` with all the 1/N in the forward
transform.  We reproduce exactly that convention.

Implementation: no complex dtypes — a DFT of the split-plane CF32 signal is
two dense real matmuls against precomputed cos/sin matrices.  For the
modem's transform sizes (NFFT = 512 for acquisition, fft.h:44) the O(N^2)
matmul DFT is a few hundred kFLOPs per transform.  Host-side numpy twins
use np.fft.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32


@functools.lru_cache(maxsize=None)
def _dft_mats(n: int, inverse: bool):
    """(cos, sin) of the DFT matrix W[k, t] = exp(-j*2pi*k*t/n) (or +j for
    the inverse).  float32 HOST arrays, cached per size — caching device
    arrays here would capture a tracer-context constant on first use under
    jit and leak it into later traces."""
    k = np.arange(n, dtype=np.float64)
    angle = 2.0 * np.pi * np.outer(k, k) / n
    if inverse:
        return (np.cos(angle).astype(np.float32),
                np.sin(angle).astype(np.float32))
    return (np.cos(angle).astype(np.float32),
            (-np.sin(angle)).astype(np.float32))


def _apply(x: CF32, cos_m, sin_m, scale: float | None) -> CF32:
    # (a + jb)(C + jS) pair-of-matmuls; x is (..., n), mats are (n, n) with
    # W[k, t] so y[k] = sum_t x[t] W[k, t]  ==  x @ W^T; W symmetric in (k,t).
    pet = jnp.float32
    hi = jax.lax.Precision.HIGHEST
    yr = (jnp.matmul(x.re, cos_m, preferred_element_type=pet, precision=hi)
          - jnp.matmul(x.im, sin_m, preferred_element_type=pet, precision=hi))
    yi = (jnp.matmul(x.re, sin_m, preferred_element_type=pet, precision=hi)
          + jnp.matmul(x.im, cos_m, preferred_element_type=pet, precision=hi))
    if scale is not None:
        s = jnp.float32(scale)
        yr, yi = yr * s, yi * s
    return CF32(yr, yi)


def fft(x: CF32) -> CF32:
    """Forward DFT over the last axis, scaled by 1/N (fft.c convention)."""
    n = x.shape[-1]
    cos_m, sin_m = _dft_mats(n, inverse=False)
    return _apply(x, cos_m, sin_m, 1.0 / n)


def ifft(x: CF32) -> CF32:
    """Unnormalized inverse DFT over the last axis (fft.c convention)."""
    n = x.shape[-1]
    cos_m, sin_m = _dft_mats(n, inverse=True)
    return _apply(x, cos_m, sin_m, None)


def fft_np(x: np.ndarray) -> np.ndarray:
    """Host twin: complex in/out, fft.c convention."""
    return np.fft.fft(x, axis=-1) / x.shape[-1]


def ifft_np(x: np.ndarray) -> np.ndarray:
    return np.fft.ifft(x, axis=-1) * x.shape[-1]

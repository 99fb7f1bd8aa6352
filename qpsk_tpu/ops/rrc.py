"""Root-raised-cosine pulse shaping.

Two pieces:

* ``rrc_design`` — host-side coefficient designer matching the reference
  closed form (rrc_fir.c:32-76) including its quirks: the three singularity
  branches, and the normalization that bakes GAIN into the taps
  (rrc_fir.c:73-75) *on top of* a second per-output GAIN multiply in the
  filter itself (rrc_fir.c:28), for an effective passband gain of
  GAIN**2 ~ 3.42.

* ``fir_block`` — the streaming 127-tap complex FIR (rrc_fir.c:17-30)
  re-designed as matmuls.  The C code is a per-sample shift-and-MAC
  delay line; here the convolution over each tile of ``B`` outputs is a dense
  real matmul ``Y = X_window @ T`` with a banded Toeplitz tap matrix
  ``T[j + k, j] = c[k]`` of shape ``(B + ntaps - 1, B)``, which XLA tiles
  straight onto the 128x128 systolic array — one matmul per I/Q plane.
  Cross-block state is the explicit ``ntaps - 1`` sample tail the C code
  keeps in its static delay lines (qpsk.c:36-37), carried functionally so
  frames/shards chain without drift (and exchanged between shards by
  ``ppermute`` in the time-parallel path, qpsk_tpu/parallel/stream.py).

The C filter indexing is ``y[t] = sum_k c[k] * x[t - (ntaps-1) + k]``
(rrc_fir.c:18-28: the newest sample sits at the *end* of the delay line), i.e.
a full ``ntaps - 1`` = 126-sample group delay; we replicate the same
alignment.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32


def rrc_design(fs: float, rs: float, alpha: float, ntaps: int = 127,
               gain: float = 1.85) -> np.ndarray:
    """RRC tap designer; same closed form + normalization as rrc_fir.c:32-76.

    Returns float32 taps with ``sum(taps) == gain`` (the reference bakes its
    GAIN constant into the taps, rrc_fir.c:73-75).
    """
    spb = fs / rs
    half = ntaps // 2  # C int division NTAPS/2 (rrc_fir.c:43)
    coeffs = np.zeros(ntaps, dtype=np.float64)
    for i in range(ntaps):
        xindx = float(i - half)
        x1 = np.pi * xindx / spb
        x2 = 4.0 * alpha * xindx / spb
        x3 = x2 * x2 - 1.0
        if abs(x3) >= 1e-6:  # away from the +-spb/(4 alpha) singularities
            if i != half:
                num = (np.cos((1.0 + alpha) * x1)
                       + np.sin((1.0 - alpha) * x1) / (4.0 * alpha * xindx / spb))
            else:
                num = np.cos((1.0 + alpha) * x1) + (1.0 - alpha) * np.pi / (4.0 * alpha)
            den = x3 * np.pi
        else:
            if alpha == 1.0:
                coeffs[i] = -1.0
                continue
            x3s = (1.0 - alpha) * x1
            x2s = (1.0 + alpha) * x1
            num = (np.sin(x2s) * (1.0 + alpha) * np.pi
                   - np.cos(x3s) * ((1.0 - alpha) * np.pi * spb) / (4.0 * alpha * xindx)
                   + np.sin(x3s) * spb * spb / (4.0 * alpha * xindx * xindx))
            den = -32.0 * np.pi * alpha * alpha * xindx / spb
        coeffs[i] = 4.0 * alpha * num / den
    scale = coeffs.sum()
    coeffs = coeffs * gain / scale
    return coeffs.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _toeplitz_np(taps_key, ntaps: int, block: int) -> np.ndarray:
    taps = np.asarray(taps_key, dtype=np.float32)
    rows = block + ntaps - 1
    tmat = np.zeros((rows, block), dtype=np.float32)
    for j in range(block):
        tmat[j:j + ntaps, j] = taps
    return tmat


def toeplitz_taps(taps: np.ndarray, block: int) -> np.ndarray:
    """Banded Toeplitz matrix T with T[j + k, j] = taps[k].

    ``y_tile = x_window @ T`` where ``x_window`` holds ``block + ntaps - 1``
    input samples ending at the newest sample of the last output.
    """
    taps = np.asarray(taps, dtype=np.float32)
    return _toeplitz_np(tuple(taps.tolist()), taps.shape[0], block)


def fir_init_tail(ntaps: int, batch_shape=()) -> CF32:
    """Zero delay-line tail, the functional analogue of the static
    ``tx_filter``/``rx_filter`` arrays (qpsk.c:36-37)."""
    shape = batch_shape + (ntaps - 1,)
    return CF32(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))


def _windows(plane: jnp.ndarray, nb: int, block: int, width: int) -> jnp.ndarray:
    idx = (np.arange(nb)[:, None] * block + np.arange(width)[None, :])
    return jnp.take(plane, jnp.asarray(idx), axis=-1)


def fir_block(x: CF32, tail: CF32, tmat: jnp.ndarray, gain: float,
              block: int = 256, precision=None):
    """Apply the streaming RRC FIR over a block of samples.

    Args:
      x: ``(..., n)`` CF32 input samples; ``n`` must divide by ``block``.
      tail: ``(..., ntaps-1)`` carried delay-line tail (previous samples).
      tmat: ``(block + ntaps - 1, block)`` Toeplitz tap matrix (float32).
      gain: the per-output GAIN multiply (rrc_fir.c:28) — applied *in
        addition* to the gain baked into the taps, matching the reference's
        double-GAIN quirk.
      block: output tile width (a multiple of 128).
      precision: matmul precision; defaults to HIGHEST (parity-grade f32).
        DEFAULT (TF32 on the GPU, ~3 decimal digits) is far below any
        channel noise floor but outside the golden-parity tolerance, so
        parity mode must keep HIGHEST.

    Returns:
      (y, new_tail): filtered samples ``(..., n)`` and the tail to carry.
    """
    n = x.shape[-1]
    ntaps_m1 = tail.shape[-1]
    assert tmat.shape == (block + ntaps_m1, block), (tmat.shape, block, ntaps_m1)
    assert n % block == 0, (n, block)
    nb = n // block
    width = block + ntaps_m1
    if precision is None:
        precision = jax.lax.Precision.HIGHEST

    if precision == jax.lax.Precision.DEFAULT and block >= ntaps_m1:
        # Fast path: split the banded matmul at the tail/block seam so the
        # block operand is a *free* reshape of x instead of a gathered
        # (width/block)-inflated window copy — the window materialization
        # was ~25% of the front-end's HBM traffic.  Each output tile sums
        # tail_part @ T[:ntaps-1] + block_part @ T[ntaps-1:], where
        # tail_part is the previous block's last ntaps-1 samples (a slice),
        # algebraically the same products as the windowed matmul grouped
        # into two f32 partial sums (fast-mode tolerance only; parity mode
        # keeps the single-accumulation windowed path below).
        def one(plane, tl):
            blocks = plane.reshape(plane.shape[:-1] + (nb, block))
            prev = jnp.concatenate(
                [tl[..., None, :], blocks[..., :-1, block - ntaps_m1:]],
                axis=-2)                              # (..., nb, ntaps-1)
            y = (jnp.matmul(prev, tmat[:ntaps_m1],
                            preferred_element_type=jnp.float32,
                            precision=precision)
                 + jnp.matmul(blocks, tmat[ntaps_m1:],
                              preferred_element_type=jnp.float32,
                              precision=precision))
            return y.reshape(plane.shape[:-1] + (n,))
        g = jnp.float32(gain)
        y = CF32(one(x.re, tail.re) * g, one(x.im, tail.im) * g)
        new_tail = CF32(x.re[..., n - ntaps_m1:], x.im[..., n - ntaps_m1:])
        return y, new_tail

    ext_re = jnp.concatenate([tail.re, x.re], axis=-1)
    ext_im = jnp.concatenate([tail.im, x.im], axis=-1)
    wr = _windows(ext_re, nb, block, width)  # (..., nb, width)
    wi = _windows(ext_im, nb, block, width)
    yr = jnp.matmul(wr, tmat, preferred_element_type=jnp.float32,
                    precision=precision)
    yi = jnp.matmul(wi, tmat, preferred_element_type=jnp.float32,
                    precision=precision)
    g = jnp.float32(gain)
    y = CF32((yr * g).reshape(x.shape[:-1] + (n,)),
             (yi * g).reshape(x.shape[:-1] + (n,)))
    new_tail = CF32(ext_re[..., n:], ext_im[..., n:])
    return y, new_tail


def fir_block_modulated(x: jnp.ndarray, tail: jnp.ndarray,
                        tmat_re: jnp.ndarray, tmat_im: jnp.ndarray,
                        gain: float, block: int):
    """Mix-free matched filter: REAL input, complex *modulated* taps
    (ops/frontend.py: ``hm[k] = h[k] * e^{j*omega*(k - D)}``), producing
    the baseband signal up to the per-pick carrier phasor applied later.

    Same split-matmul fast path as ``fir_block``'s DEFAULT branch — the
    block operand is a free reshape of ``x``, the tail operand a slice —
    but the two matmuls per tile are the re/im tap planes over ONE real
    input plane instead of one tap plane over two mixed planes: identical
    matmul work, half the input-side memory traffic, and no full-rate mix.

    Args:
      x: ``(..., n)`` float32 RAW samples; ``n`` must divide by ``block``.
      tail: ``(..., ntaps-1)`` carried raw tail (see frontend.unmix_tail).
      tmat_re/tmat_im: ``(block + ntaps - 1, block)`` Toeplitz planes of
        the modulated taps.
      gain: per-output GAIN multiply (the double-GAIN quirk, rrc_fir.c:28).

    Returns (u CF32 ``(..., n)``, new_raw_tail ``(..., ntaps-1)``).
    """
    n = x.shape[-1]
    ntaps_m1 = tail.shape[-1]
    assert tmat_re.shape == (block + ntaps_m1, block), (tmat_re.shape, block)
    assert n % block == 0 and block >= ntaps_m1, (n, block, ntaps_m1)
    nb = n // block

    blocks = x.reshape(x.shape[:-1] + (nb, block))
    prev = jnp.concatenate(
        [tail[..., None, :], blocks[..., :-1, block - ntaps_m1:]],
        axis=-2)                                      # (..., nb, ntaps-1)

    def one(tmat):
        y = (jnp.matmul(prev, tmat[:ntaps_m1],
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.DEFAULT)
             + jnp.matmul(blocks, tmat[ntaps_m1:],
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.DEFAULT))
        return y.reshape(x.shape[:-1] + (n,))

    g = jnp.float32(gain)
    u = CF32(one(tmat_re) * g, one(tmat_im) * g)
    return u, x[..., n - ntaps_m1:]


def fir_reference_order(x: CF32, tail: CF32, taps: jnp.ndarray, gain: float) -> CF32:
    """Bit-faithful FIR for parity tests: accumulates taps in the same
    ascending order as the C MAC loop (rrc_fir.c:24-26), via a scan over
    samples.  Slow; used only to validate ``fir_block``."""

    def step(mem, xj):
        mem_re, mem_im = mem
        xr, xi = xj
        mem_re = jnp.concatenate([mem_re[1:], xr[None]])
        mem_im = jnp.concatenate([mem_im[1:], xi[None]])
        yr = jnp.sum(mem_re * taps)
        yi = jnp.sum(mem_im * taps)
        return (mem_re, mem_im), (yr * jnp.float32(gain), yi * jnp.float32(gain))

    # The C delay line holds the previous ntaps inputs; our carried tail is
    # only the newest ntaps-1 of them — the oldest slot is shifted out before
    # it is ever read, so a zero placeholder is equivalent.
    mem0_re = jnp.concatenate([jnp.zeros((1,), jnp.float32), tail.re])
    mem0_im = jnp.concatenate([jnp.zeros((1,), jnp.float32), tail.im])
    _, (yr, yi) = jax.lax.scan(step, (mem0_re, mem0_im), (x.re, x.im))
    return CF32(yr, yi)

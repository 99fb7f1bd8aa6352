"""Symbol-timing estimation and decimation.

Two estimators:

* ``timing_histogram`` — exact replica of the reference's preamble-free
  amplitude-histogram estimator (qpsk.c:131-180), including its quirks: the
  leaky I/Q averages that are never reset within a frame (qpsk.c:133-138),
  the running maxima updated *before* the histogram thresholds are computed
  (qpsk.c:140-146), 8 buckets with bucket 0 unused and no bucket taken when
  the group average *is* the new maximum (the ``k < 8`` loop bound,
  qpsk.c:152-166), and first-wins argmax over the summed histogram
  (qpsk.c:169-180).  The reference README calls this estimator "unreliable"
  (README.md:4); it is kept as the parity mode.

* ``timing_power`` — the robust default: squared-envelope (Oerder&Meyr
  style) phase selection, i.e. pick the decimation phase with maximum mean
  energy after the matched filter.  Data-parallel, no sequential state.

Decimation replicates the reference's one-frame delay line (qpsk.c:182-191):
the symbols handed to the Costas loop are the *previous* frame's picks, and
the timing index may exceed ``cycles - 1`` (up to 7), in which case the C
code reads past the frame buffer (undefined behavior); we clamp to the last
sample instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32, cabs2


def timing_histogram(frame: CF32, cycles: int) -> jnp.ndarray:
    """Reference histogram timing index for (..., frame_size) filtered
    samples.  Returns int32 index, batch-shaped."""
    batch_shape = frame.shape[:-1]
    nsym = frame.shape[-1] // cycles
    abs_i = jnp.abs(frame.re).reshape(batch_shape + (nsym, cycles))
    abs_q = jnp.abs(frame.im).reshape(batch_shape + (nsym, cycles))
    sum_i = jnp.moveaxis(abs_i.sum(-1), -1, 0)  # (nsym, ...)
    sum_q = jnp.moveaxis(abs_q.sum(-1), -1, 0)

    zeros = jnp.zeros(batch_shape, jnp.float32)
    hist0 = jnp.zeros(batch_shape + (8,), jnp.float32)
    ks = jnp.arange(1, 8, dtype=jnp.float32)  # buckets 1..7 (bucket 0 unused)

    def bucket_add(hist, av, mx):
        hv = mx / 8.0
        cond = av[..., None] <= hv[..., None] * ks  # (..., 7)
        hit = jnp.any(cond, axis=-1)
        k = 1 + jnp.argmax(cond, axis=-1)           # first k with av <= hv*k
        onehot = jax.nn.one_hot(k, 8, dtype=jnp.float32)
        return hist + onehot * hit[..., None].astype(jnp.float32)

    def step(carry, xs):
        av_i, av_q, max_i, max_q, hist_i, hist_q = carry
        s_i, s_q = xs
        av_i = (av_i + s_i) / cycles   # leaky average (qpsk.c:133-138)
        av_q = (av_q + s_q) / cycles
        max_i = jnp.maximum(max_i, av_i)  # max updated first (qpsk.c:140-146)
        max_q = jnp.maximum(max_q, av_q)
        hist_i = bucket_add(hist_i, av_i, max_i)
        hist_q = bucket_add(hist_q, av_q, max_q)
        return (av_i, av_q, max_i, max_q, hist_i, hist_q), None

    carry0 = (zeros, zeros, zeros, zeros, hist0, hist0)
    (_, _, _, _, hist_i, hist_q), _ = jax.lax.scan(step, carry0, (sum_i, sum_q))

    hist = hist_i + hist_q
    # first-wins strict argmax with hmax starting at 0 → index 0 if all zero
    hmax = jnp.max(hist, axis=-1)
    idx = jnp.argmax(hist, axis=-1).astype(jnp.int32)
    return jnp.where(hmax > 0, idx, 0).astype(jnp.int32)


def timing_power(frame: CF32, cycles: int) -> jnp.ndarray:
    """Max-energy decimation phase: argmax_p mean |x[i*cycles + p]|^2."""
    batch_shape = frame.shape[:-1]
    nsym = frame.shape[-1] // cycles
    e = cabs2(frame).reshape(batch_shape + (nsym, cycles))
    energy = jnp.mean(e, axis=-2)  # (..., cycles)
    return jnp.argmax(energy, axis=-1).astype(jnp.int32)


def timing_fractional(frame: CF32, cycles: int) -> jnp.ndarray:
    """Oerder&Meyr squared-envelope fractional timing estimate in samples,
    in [0, cycles).  Used by the resampling (robust) path."""
    n = frame.shape[-1]
    e = cabs2(frame)
    cos_t = jnp.asarray(np.cos(-2 * np.pi * np.arange(n) / cycles), jnp.float32)
    sin_t = jnp.asarray(np.sin(-2 * np.pi * np.arange(n) / cycles), jnp.float32)
    cr = jnp.sum(e * cos_t, axis=-1)
    ci = jnp.sum(e * sin_t, axis=-1)
    tau = -jnp.arctan2(ci, cr) / (2.0 * np.pi) * cycles
    return jnp.mod(tau, float(cycles))


def timing_track_init(batch_shape=()):
    """State of the frame-rate timing PLL: (tau samples, dtau samples/frame)."""
    return (jnp.zeros(batch_shape, jnp.float32),
            jnp.zeros(batch_shape, jnp.float32))


def _wrap_half_cycle(x: jnp.ndarray, cycles: int) -> jnp.ndarray:
    """Wrap a timing error into [-cycles/2, cycles/2) — tau is circular."""
    h = cycles / 2.0
    return jnp.mod(x + h, float(cycles)) - h


def timing_track_step(state, meas: jnp.ndarray, cycles: int,
                      alpha: float = 0.5, beta: float = 0.08):
    """One update of the second-order timing loop (the Gardner-class
    tracking capability, realized in parallel form: the timing-error detector is
    the *block* O&M estimate per frame, so the sequential part runs at
    frame rate — 128x slower than a per-symbol Gardner scan — while all
    per-sample math stays parallel).

    ``alpha`` is the proportional gain (phase), ``beta`` the integral gain
    (clock-rate); error halves roughly every frame, so pull-in from the
    worst case (half a symbol) takes ~6 frames.  Returns
    (tau_used (...,) in [0, cycles), new_state).
    """
    tau, dtau = state
    e = _wrap_half_cycle(meas - tau, cycles)
    dtau = dtau + jnp.float32(beta) * e
    tau_used = tau + jnp.float32(alpha) * e
    tau_next = jnp.mod(tau_used + dtau, float(cycles))
    return jnp.mod(tau_used, float(cycles)), (tau_next, dtau)


def timing_track(frames: CF32, cycles: int, state,
                 alpha: float = 0.5, beta: float = 0.08):
    """Run the timing PLL over (..., nframes, frame_size) filtered samples.

    All per-frame O&M measurements are computed batched first; only the
    tiny scalar smoother scans over the frame axis.  Returns
    (tau_used (..., nframes), new_state)."""
    meas = timing_fractional(frames, cycles)          # (..., nframes)
    ms = jnp.moveaxis(meas, -1, 0)

    def step(carry, m):
        tau_used, carry = timing_track_step(carry, m, cycles, alpha, beta)
        return carry, tau_used

    state, used = jax.lax.scan(step, state, ms)
    return jnp.moveaxis(used, 0, -1), state


def estimate_and_decimate(frames: CF32, cycles: int, mode: str):
    """Dispatch the configured timing estimator + matching decimation over
    (..., nframes, frame_size) filtered samples.  The single place the
    mode switch lives — every RX path (fused, per-frame, time-parallel,
    block-parallel) calls this so the modes can't silently diverge.

    Returns (picks (..., nframes, nsym), index (..., nframes) int32).
    """
    if mode == "histogram":
        index = timing_histogram(frames, cycles)
        picks = decimate_select(frames, index, cycles)
    elif mode in ("fractional", "tracking"):
        # "tracking" reaching here means the caller has no cross-block carry
        # to thread (block-parallel / re-acquisition paths): it degrades to
        # the stateless feedforward fractional estimate, which is what those
        # paths' per-block independence requires.  The stateful loop lives in
        # timing_track / timing_track_step (modem rx paths).  Surface the
        # degradation — a user selecting "tracking" for a clock-ppm-hostile
        # link must not silently lose the rate loop.
        if mode == "tracking":
            import warnings
            warnings.warn(
                "timing_mode='tracking' has no cross-block carry on this "
                "path (block-/time-parallel or per-block re-acquisition): "
                "degrading to the feedforward 'fractional' estimator, which "
                "does not follow sample-clock *rate* offsets",
                RuntimeWarning, stacklevel=3)
        tau = timing_fractional(frames, cycles)
        picks = decimate_fractional(frames, tau, cycles)
        index = jnp.round(tau).astype(jnp.int32)
    elif mode == "power":
        index = timing_power(frames, cycles)
        picks = decimate_select(frames, index, cycles)
    else:
        raise ValueError(f"unknown timing mode {mode!r}")
    return picks, index


def decimate_fractional(frame: CF32, tau: jnp.ndarray, cycles: int) -> CF32:
    """Interpolating decimation at a *fractional* timing phase.

    ``tau`` (batch-shaped float32, in [0, cycles)) is the Oerder&Meyr
    estimate from ``timing_fractional``; each symbol is taken at sample
    position ``s*cycles + tau`` via piecewise-cubic (Catmull-Rom, i.e.
    Farrow-structure) interpolation of the matched-filter output.  This is
    the robust upgrade over the reference's integer-phase pick: off-grid
    symbol clocks (sample-rate error, non-integer delays) no longer cost
    up to half a sample of timing error.

    Shape: like ``decimate_select`` the dynamic pick is a one-hot
    contraction over the 2*cycles integer base phases (no gathers); the
    four Catmull-Rom taps are four shifted one-hot picks blended by the
    polynomial weights — all elementwise work.
    """
    i0 = jnp.clip(jnp.floor(tau).astype(jnp.int32), 0, 2 * cycles - 2)
    mu = tau - i0.astype(jnp.float32)                 # in [0, 1)
    mu = mu[..., None]

    # Catmull-Rom weights for points at offsets (-1, 0, +1, +2)
    w_m1 = 0.5 * (-mu ** 3 + 2 * mu ** 2 - mu)
    w_0 = 0.5 * (3 * mu ** 3 - 5 * mu ** 2 + 2)
    w_p1 = 0.5 * (-3 * mu ** 3 + 4 * mu ** 2 + mu)
    w_p2 = 0.5 * (mu ** 3 - mu ** 2)

    def pick(idx):
        return decimate_select(frame, jnp.clip(idx, 0, 2 * cycles - 1), cycles)

    pm1, p0, pp1, pp2 = pick(i0 - 1), pick(i0), pick(i0 + 1), pick(i0 + 2)
    return CF32(w_m1 * pm1.re + w_0 * p0.re + w_p1 * pp1.re + w_p2 * pp2.re,
                w_m1 * pm1.im + w_0 * p0.im + w_p1 * pp1.im + w_p2 * pp2.im)


def decimate_select(frame: CF32, index: jnp.ndarray, cycles: int) -> CF32:
    """Gather-free decimation: pick sample ``s*cycles + index`` per symbol.

    ``index`` (batch-shaped int32) ranges over [0, 2*cycles): the reference
    histogram can emit up to 7 (8 buckets), which reads into the *next*
    symbol group (and past the frame for the last symbol — UB in C,
    qpsk.c:188-189; here the last group clamps to itself).

    The dynamic pick is a one-hot contraction over the 2*cycles candidate
    phases rather than a ``take_along_axis`` gather (which form is faster
    on the GPU is not measured yet — ROADMAP).
    """
    nsym = frame.shape[-1] // cycles
    batch_frame = frame.shape[:-1]

    def one(plane):
        r = plane.reshape(batch_frame + (nsym, cycles))
        r_next = jnp.concatenate([r[..., 1:, :], r[..., -1:, :]], axis=-2)
        r8 = jnp.concatenate([r, r_next], axis=-1)        # (..., nsym, 2c)
        onehot = jax.nn.one_hot(index, 2 * cycles, dtype=plane.dtype)
        return jnp.einsum("...sc,...c->...s", r8, onehot)

    return CF32(one(frame.re), one(frame.im))


def decimate_delayed(frame: CF32, delay: CF32, index: jnp.ndarray, cycles: int):
    """Pick one sample per symbol at phase ``index`` through the reference's
    one-frame delay line (qpsk.c:182-191).

    Args:
      frame: (..., frame_size) filtered samples.
      delay: (..., nsym) previous frame's picks (state).
      index: batch-shaped int32 timing index (may exceed cycles-1).
    Returns:
      (symbols_out, new_delay): the previous frame's symbols, and this
      frame's picks to carry.
    """
    picks = decimate_select(frame, index, cycles)
    return delay, picks

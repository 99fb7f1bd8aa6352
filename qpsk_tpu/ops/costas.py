"""Costas-loop carrier recovery.

The reference is a 2nd-order decision-directed PLL taken from GNU Radio
(costas_loop.c) with all state in file-scope statics — one global loop
instance.  Here the loop is a pure ``(state, symbol) -> (state, out)``
recurrence run under ``jax.lax.scan``, with the state as an explicit pytree so
it can be vmapped per channel and sharded with pjit.  The scan is sequential
in time but arbitrarily wide in channels.  On the GPU each scan step costs
at least one kernel launch, so the fused kernel
(ops/pallas/costas_kernel.py) runs the same step inside one launch.

Exact semantics replicated (for parity with the C chain):

* derotation uses the phase *before* the update: ``out = z * e^{-j phase}``
  (qpsk.c:197 reads the phase advanced at qpsk.c:205 of the previous symbol);
* phase detector ``sign+(Re)*Im - sign+(Im)*Re`` where ``sign+(v) = v > 0 ?
  1 : -1`` (costas_loop.c:44-47);
* loop update order ``freq += beta*err; phase += freq + alpha*err``
  (costas_loop.c:56-59, left-to-right float adds);
* phase wrap to +-TAU by repeated subtraction (costas_loop.c:61-67) — the
  per-step increment is bounded, so two conditional subtractions suffice;
* frequency clamp to [min_freq, max_freq] (costas_loop.c:69-74);
* gain schedule alpha = 4 d w / denom, beta = 4 w^2 / denom,
  denom = 1 + 2 d w + w^2 (costas_loop.c:49-54).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32, cexp_conj, cmul

TAU = 2.0 * math.pi


class CostasParams(NamedTuple):
    """Static loop gains (from bandwidth + damping, costas_loop.c:49-54)."""
    alpha: jnp.ndarray
    beta: jnp.ndarray
    max_freq: jnp.ndarray
    min_freq: jnp.ndarray


class CostasGear(NamedTuple):
    """Gear-shift (dual-bandwidth) extension of the loop.

    The reference README warns the loop bandwidth must be hand-tuned in
    TAU/100..TAU/200 (README.md:12): wide enough to pull in the carrier
    offset, narrow enough not to jitter at the lock point — one knob,
    two jobs.  The gear shift splits them: the loop runs at the (wide)
    acquisition bandwidth of ``CostasParams`` until a lock detector —
    a leaky average ``lev`` of the *normalized* decision error
    ``|err| / (|Re| + |Im|)`` (scale-free: the double-GAIN chain's 1.45x
    symbol magnitude cancels) — falls below ``enter``, then shifts to the
    (narrow) tracking gains; it shifts back up if ``lev`` rises past
    ``exit`` (a slip / signal loss re-arms acquisition).  Measured levels:
    unlocked ~0.44, locked 0.06 @ 20 dB .. 0.27 @ 7 dB, so the default
    0.32/0.40 hysteresis band separates cleanly over the modem's whole
    operating range.
    """
    alpha_trk: jnp.ndarray
    beta_trk: jnp.ndarray
    gamma: jnp.ndarray      # lock-level smoothing (time const ~1/gamma syms)
    enter: jnp.ndarray      # shift down (track) when lev < enter
    exit: jnp.ndarray       # shift up (re-acquire) when lev > exit


class CostasState(NamedTuple):
    """Dynamic loop state (costas_loop.c:13-15); rad/symbol units.

    ``lev``/``locked`` carry the gear-shift lock detector (smoothed
    normalized error level + latched gear flag); ``None`` — the default,
    which vanishes from the pytree — means the fixed-bandwidth loop.
    """
    phase: jnp.ndarray
    freq: jnp.ndarray
    lev: Any = None
    locked: Any = None


def costas_params(loop_bw: float, damping: float = math.sqrt(2.0) / 2.0,
                  min_freq: float = -1.0, max_freq: float = 1.0) -> CostasParams:
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = 4.0 * damping * loop_bw / denom
    beta = 4.0 * loop_bw * loop_bw / denom
    # numpy scalars, not device arrays: they stay concrete under jit, so
    # the fused kernel can compile them in as constants
    return CostasParams(
        alpha=np.float32(alpha), beta=np.float32(beta),
        max_freq=np.float32(max_freq), min_freq=np.float32(min_freq))


def costas_init(batch_shape=(), phase=0.0, freq=0.0,
                gear: bool = False) -> CostasState:
    """Cold start (qpsk.c:302: phase=0, freq=0); pass an acquisition
    estimate as ``freq`` (rad/symbol) to warm-start.  ``gear=True`` adds
    the lock-detector state (starts unlocked, in the acquisition gear)."""
    def bc(v):
        return jnp.broadcast_to(jnp.asarray(v, jnp.float32), batch_shape)
    return CostasState(
        phase=bc(phase), freq=bc(freq),
        lev=bc(1.0) if gear else None,
        locked=bc(0.0) if gear else None)


def gear_for(loop_bw_track: float, damping: float = math.sqrt(2.0) / 2.0):
    """CostasGear for a config's (loop_bw_track, damping), or None when
    gear-shifting is off — the ONE place the enable rule lives (the modem
    and both parallel paths share it, so they can never run different
    gears for the same config)."""
    if loop_bw_track <= 0:
        return None
    return costas_gear(loop_bw_track, damping)


def costas_init_from_freq(freq0: jnp.ndarray, gear: bool) -> "CostasState":
    """Warm-started loop state at per-channel ``freq0`` with zero phase.
    Every plane derives from ``freq0`` rather than replicated constants —
    required for the carry's varying-manual-axes to match under
    ``shard_map`` (parallel/stream.py) — and the unlocked gear cold-start
    (lev=1, locked=0) lives here, next to ``costas_init``'s."""
    return CostasState(phase=freq0 * 0.0, freq=freq0,
                       lev=freq0 * 0.0 + 1.0 if gear else None,
                       locked=freq0 * 0.0 if gear else None)


def costas_gear(loop_bw_trk: float,
                damping: float = math.sqrt(2.0) / 2.0,
                gamma: float = 1.0 / 64.0, enter: float = 0.32,
                exit: float = 0.40) -> CostasGear:
    """Tracking-gear gains (same gain schedule as costas_params) plus the
    lock-detector constants.  See ``CostasGear``.

    ``gamma`` defaults to a power of two so ``gamma * (lev - errn)`` is an
    exact float op (pure exponent shift): the lock-level recurrence then
    rounds only once per step regardless of FMA contraction, keeping the
    scan and Pallas lowerings bit-identical (a non-power-of-two gamma
    drifts by ULPs between compilers and could, at a threshold crossing,
    shift the gear change by one symbol)."""
    denom = 1.0 + 2.0 * damping * loop_bw_trk + loop_bw_trk * loop_bw_trk
    return CostasGear(
        alpha_trk=np.float32(4.0 * damping * loop_bw_trk / denom),
        beta_trk=np.float32(4.0 * loop_bw_trk * loop_bw_trk / denom),
        gamma=np.float32(gamma), enter=np.float32(enter),
        exit=np.float32(exit))


def phase_detector(z: CF32) -> jnp.ndarray:
    """QPSK decision-directed error (costas_loop.c:44-47)."""
    sr = jnp.where(z.re > 0.0, jnp.float32(1.0), jnp.float32(-1.0))
    si = jnp.where(z.im > 0.0, jnp.float32(1.0), jnp.float32(-1.0))
    return sr * z.im - si * z.re


def _wrap_phase(phase: jnp.ndarray) -> jnp.ndarray:
    # costas_loop.c:61-67; |increment| per step is < TAU so two rounds cover it.
    phase = jnp.where(phase > TAU, phase - jnp.float32(TAU), phase)
    phase = jnp.where(phase > TAU, phase - jnp.float32(TAU), phase)
    phase = jnp.where(phase < -TAU, phase + jnp.float32(TAU), phase)
    phase = jnp.where(phase < -TAU, phase + jnp.float32(TAU), phase)
    return phase


def _advance(phase, freq, err, alpha, beta, params: CostasParams):
    """Loop filter, wrap and clamp (costas_loop.c:56-74)."""
    freq = freq + beta * err
    phase = (phase + freq) + alpha * err
    phase = _wrap_phase(phase)
    freq = jnp.clip(freq, params.min_freq, params.max_freq)
    return phase, freq


def costas_step(state: CostasState, z: CF32, params: CostasParams,
                detector=phase_detector):
    """One symbol tick: derotate, detect, advance (qpsk.c:196-212).

    ``detector`` swaps the phase-error function: the default is the
    reference's QPSK sign detector; the generic modulation family passes
    its decision-directed error (ops/modfam.dd_detector)."""
    out = cmul(z, cexp_conj(state.phase))
    err = detector(out)
    phase, freq = _advance(state.phase, state.freq, err, params.alpha,
                           params.beta, params)
    return CostasState(phase=phase, freq=freq), out


def gear_update(state: CostasState, out: CF32, params: CostasParams,
                gear: CostasGear):
    """The gear-shift half of one tick, given the derotated symbol: lock
    detector, gear select, advance.  Shared by ``costas_step_gear`` and
    the fused kernel (ops/pallas/costas_kernel.py)."""
    err = phase_detector(out)
    errn = jnp.abs(err) / (jnp.abs(out.re) + jnp.abs(out.im)
                           + jnp.float32(1e-9))
    lev = state.lev + gear.gamma * (errn - state.lev)
    locked = jnp.where(lev < gear.enter, jnp.float32(1.0),
                       jnp.where(lev > gear.exit, jnp.float32(0.0),
                                 state.locked))
    alpha = jnp.where(locked > 0.5, gear.alpha_trk, params.alpha)
    beta = jnp.where(locked > 0.5, gear.beta_trk, params.beta)
    phase, freq = _advance(state.phase, state.freq, err, alpha, beta, params)
    return CostasState(phase=phase, freq=freq, lev=lev, locked=locked)


def costas_step_gear(state: CostasState, z: CF32, params: CostasParams,
                     gear: CostasGear):
    """One symbol tick with the gear-shift lock detector (see CostasGear).

    Identical to ``costas_step`` except the (alpha, beta) applied each
    step are selected by the latched gear flag, updated from this symbol's
    normalized error *before* the loop advance (one-symbol-faster gear
    response; the detector itself is ~1/gamma symbols slow, so ordering is
    immaterial to behavior).

    The optimization barrier pins ONE evaluation of the derotated symbol:
    without it XLA may duplicate ``out`` into separate fusions (the
    returned output vs the ``errn`` consumer) whose multiply-adds
    FMA-contract differently, so the lock level would see other bits than
    the output."""
    out = cmul(z, cexp_conj(state.phase))
    out = CF32(*jax.lax.optimization_barrier((out.re, out.im)))
    return gear_update(state, out, params, gear), out


def costas_run_gear_traced(state: CostasState, symbols: CF32,
                           params: CostasParams, gear: CostasGear,
                           unroll: int = 1):
    """Gear-shift twin of ``costas_run_traced``: returns
    (new_state, derotated, freq_trace)."""
    xs = CF32(jnp.moveaxis(symbols.re, -1, 0), jnp.moveaxis(symbols.im, -1, 0))

    def step(st, z):
        st, out = costas_step_gear(st, CF32(*z), params, gear)
        return st, (out, st.freq)

    new_state, (out, freq) = jax.lax.scan(step, state, tuple(xs),
                                          unroll=unroll)
    return new_state, CF32(jnp.moveaxis(out.re, 0, -1),
                           jnp.moveaxis(out.im, 0, -1)), jnp.moveaxis(freq, 0, -1)


def costas_run_gear(state: CostasState, symbols: CF32, params: CostasParams,
                    gear: CostasGear, unroll: int = 1):
    st, out, _ = costas_run_gear_traced(state, symbols, params, gear, unroll)
    return st, out


def costas_run(state: CostasState, symbols: CF32, params: CostasParams,
               unroll: int = 1, detector=phase_detector):
    """Track a block of symbols.

    Args:
      state: batch-shaped loop state.
      symbols: ``(..., t)`` CF32, batch shape matching ``state``.
      unroll: ``lax.scan`` unroll factor (amortizes per-step overhead;
        semantics unchanged).
      detector: phase-error function (see ``costas_step``).
    Returns:
      (new_state, derotated symbols ``(..., t)``).
    """
    xs = CF32(jnp.moveaxis(symbols.re, -1, 0), jnp.moveaxis(symbols.im, -1, 0))

    def step(st, z):
        return costas_step(st, CF32(*z), params, detector)

    new_state, out = jax.lax.scan(step, state, tuple(xs), unroll=unroll)
    return new_state, CF32(jnp.moveaxis(out.re, 0, -1),
                           jnp.moveaxis(out.im, 0, -1))


def costas_run_traced(state: CostasState, symbols: CF32, params: CostasParams,
                      unroll: int = 1, detector=phase_detector):
    """Like ``costas_run`` but also emits the per-symbol frequency trace
    (rad/symbol), for frame-boundary metric readback in the fused stream
    path (qpsk.c:217 reads the loop frequency once per frame)."""
    xs = CF32(jnp.moveaxis(symbols.re, -1, 0), jnp.moveaxis(symbols.im, -1, 0))

    def step(st, z):
        st, out = costas_step(st, CF32(*z), params, detector)
        return st, (out, st.freq)

    new_state, (out, freq) = jax.lax.scan(step, state, tuple(xs),
                                          unroll=unroll)
    return new_state, CF32(jnp.moveaxis(out.re, 0, -1),
                           jnp.moveaxis(out.im, 0, -1)), jnp.moveaxis(freq, 0, -1)


def freq_to_hz(freq_rad_per_symbol: jnp.ndarray, rs: float) -> jnp.ndarray:
    """Detected offset in Hz at the symbol rate (qpsk.c:217)."""
    return freq_rad_per_symbol * jnp.float32(rs / TAU)


class CostasLoop:
    """Object-style facade mirroring the reference's full control-loop API
    (costas_loop.h:16-43: create_control_loop + 8 setters / 8 getters),
    for users porting code from the C modem.  The functional core
    (CostasParams/CostasState + costas_run) stays the canonical interface;
    this class just owns one (params, state) pair and re-derives the gains
    on bandwidth/damping changes exactly like update_gains
    (costas_loop.c:49-54).
    """

    def __init__(self, loop_bw: float, min_freq: float = -1.0,
                 max_freq: float = 1.0,
                 damping: float = math.sqrt(2.0) / 2.0, batch_shape=()):
        self._bw = float(loop_bw)
        self._damping = float(damping)
        self._min = float(min_freq)
        self._max = float(max_freq)
        self._alpha = None  # explicit overrides (set_alpha/set_beta)
        self._beta = None
        self.state = costas_init(batch_shape)

    # --- gains (costas_loop.c:49-54, 79-115) ---
    def _params(self) -> CostasParams:
        p = costas_params(self._bw, self._damping, self._min, self._max)
        if self._alpha is not None:
            p = p._replace(alpha=jnp.float32(self._alpha))
        if self._beta is not None:
            p = p._replace(beta=jnp.float32(self._beta))
        return p

    def set_loop_bandwidth(self, bw: float):
        self._bw = float(bw)
        self._alpha = self._beta = None     # update_gains recomputes both

    def set_damping_factor(self, d: float):
        self._damping = float(d)
        self._alpha = self._beta = None

    def set_alpha(self, a: float):
        self._alpha = float(a)

    def set_beta(self, b: float):
        self._beta = float(b)

    def set_frequency(self, f):
        p = self._params()
        self.state = self.state._replace(
            freq=jnp.clip(jnp.broadcast_to(jnp.float32(f),
                                           self.state.freq.shape),
                          p.min_freq, p.max_freq))

    def set_phase(self, ph):
        self.state = self.state._replace(
            phase=_wrap_phase(jnp.broadcast_to(jnp.float32(ph),
                                               self.state.phase.shape)))

    def set_max_freq(self, f: float):
        self._max = float(f)

    def set_min_freq(self, f: float):
        self._min = float(f)

    def get_loop_bandwidth(self) -> float:
        return self._bw

    def get_damping_factor(self) -> float:
        return self._damping

    def get_alpha(self):
        return float(self._params().alpha)

    def get_beta(self):
        return float(self._params().beta)

    def get_frequency(self):
        return self.state.freq

    def get_phase(self):
        return self.state.phase

    def get_max_freq(self) -> float:
        return self._max

    def get_min_freq(self) -> float:
        return self._min

    def __call__(self, symbols: CF32) -> CF32:
        """Track a block of symbols, advancing the owned state."""
        self.state, out = costas_run(self.state, symbols, self._params())
        return out

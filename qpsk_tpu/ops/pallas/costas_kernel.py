"""Fused Costas-loop kernel (Pallas, Triton route, for the GPU).

The Costas recurrence (costas_loop.c:56-74 semantics, see ops/costas.py) is
the modem's one serial computation: each symbol's derotation uses the phase
updated by the previous symbol.  ``lax.scan`` is correct, but on the GPU
every scan step launches the step's fused kernels again, so a pass costs a
launch per symbol (or per unrolled group) whatever the channel count.  This
kernel runs the whole loop inside ONE launch.

Layout and schedule:

* the symbol planes are time-major ``(T, C)`` (flattened), so the channel
  rows a step reads are contiguous and every load is coalesced;
* the grid is one program per block of ``bc`` channels (a power of two,
  masked past ``C``): one channel per thread, one warp per program, so
  8192 channels give 256 programs across the card's SMs and a lone
  channel still runs;
* the time loop runs inside the program (``lax.fori_loop``) with the loop
  state in registers.  Time rows are loaded in chunks of ``tc`` (a power
  of two): the rows of chunk k+1 are issued while chunk k steps, so their
  latency hides behind the serial chain.  ``T`` need not be a multiple of
  ``tc``: the remainder is a static tail after the loop.

The step is the scan's own (``costas_ops.costas_step`` with the config's
detector, or ``costas_ops.gear_update`` for the gear-shift loop), so every
mode ``rx_stream`` uses runs here: the QPSK sign detector, the gear shift,
the decision-directed detector of the generic family, and per-frame AGC
gains applied to each symbol as it is loaded.  Slicing stays in XLA.  The
two lowerings agree to rounding (the compilers contract multiply-adds
differently), not bit for bit.

Off the GPU the kernel runs only in Pallas interpret mode, and only when the
caller asks for it (``interpret=True``); tests do.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from qpsk_tpu.ops import costas as costas_ops
from qpsk_tpu.ops.costas import CostasGear, CostasParams, CostasState
from qpsk_tpu.ops.cplx import CF32, cexp_conj, cmul

_TC = 16     # time rows per chunk


def _pick_bc(c: int) -> int:
    """Channels per program: one warp's worth (32), fewer for tiny batches
    (never below 16, Triton's smallest comfortable block)."""
    bc = 16
    while bc < 32 and bc < c:
        bc *= 2
    return bc


def _kernel(*refs, t_len: int, c_len: int, bc: int, tc: int, every: int,
            ns: int, agc_nsf: int, step):
    # refs: zr, zi, state_in[ns], [gains] | out_re, out_im, ftrace,
    # state_out[ns]; every plane flattened time-major (t * C + channel)
    zr_ref, zi_ref = refs[0], refs[1]
    st_in = refs[2:2 + ns]
    g_ref = refs[2 + ns] if agc_nsf else None
    outs = refs[2 + ns + (1 if agc_nsf else 0):]
    or_ref, oi_ref, ft_ref = outs[0], outs[1], outs[2]
    st_out = outs[3:3 + ns]

    ch = pl.program_id(0) * bc + jnp.arange(bc, dtype=jnp.int32)
    cmask = ch < c_len

    def load_rows(t0, n, live):
        rows = []
        for j in range(n):
            t = t0 + j
            m = cmask & live
            zr = pltr.load(zr_ref.at[t * c_len + ch], mask=m, other=0.0)
            zi = pltr.load(zi_ref.at[t * c_len + ch], mask=m, other=0.0)
            if agc_nsf:
                # frame-rate AGC gain: one multiply per symbol, off the
                # serial chain
                g = pltr.load(
                    g_ref.at[jax.lax.div(t, agc_nsf) * c_len + ch],
                    mask=m, other=0.0)
                zr, zi = zr * g, zi * g
            rows.append((zr, zi))
        return tuple(rows)

    def run_rows(t0, rows, st):
        for j, (zr, zi) in enumerate(rows):
            t = t0 + j
            st, out = step(st, CF32(zr, zi))
            pltr.store(or_ref.at[t * c_len + ch], out.re, mask=cmask)
            pltr.store(oi_ref.at[t * c_len + ch], out.im, mask=cmask)
            # post-update frequency after symbols k*every - 1 (the
            # frame-boundary readback of qpsk.c:217)
            k = jnp.maximum(jax.lax.div(t + 1, every) - 1, 0)
            pltr.store(ft_ref.at[k * c_len + ch], st.freq,
                       mask=cmask & (jax.lax.rem(t + 1, every) == 0))
        return st

    st = CostasState(*(pltr.load(r.at[ch], mask=cmask, other=0.0)
                       for r in st_in))
    n_full = t_len // tc
    if n_full:
        def body(k, carry):
            st, rows = carry
            nxt = load_rows((k + 1) * tc, tc, (k + 1) < n_full)
            return run_rows(k * tc, rows, st), nxt

        st, _ = jax.lax.fori_loop(
            0, n_full, body, (st, load_rows(jnp.int32(0), tc, True)))
    tail = t_len - n_full * tc
    if tail:
        t0 = jnp.int32(n_full * tc)
        st = run_rows(t0, load_rows(t0, tail, True), st)
    for r, v in zip(st_out, st):
        pltr.store(r.at[ch], v, mask=cmask)


def _floats(nt) -> tuple:
    """Concrete scalars of a params/gear tuple as Python floats: they are
    compiled into the kernel as constants."""
    return tuple(float(np.asarray(v)) for v in nt)


@functools.partial(jax.jit, static_argnames=(
    "params", "gear", "dd", "every", "agc_nsf", "interpret"))
def _costas_call(zr, zi, state0, gains, *, params, gear, dd, every,
                 agc_nsf, interpret):
    t, c = zr.shape
    ns = len(state0)
    p = CostasParams(*params)
    g = CostasGear(*gear) if gear is not None else None
    if g is not None:
        def step(st, z):
            out = cmul(z, cexp_conj(st.phase))
            return costas_ops.gear_update(st, out, p, g), out
    else:
        det = costas_ops.phase_detector
        if dd is not None:
            from qpsk_tpu.ops import modfam
            det = modfam.dd_detector(modfam.get(dd[0]), scale=dd[1])

        def step(st, z):
            return costas_ops.costas_step(st, z, p, det)

    bc = _pick_bc(c)
    inputs = [zr.reshape(-1), zi.reshape(-1), *state0]
    if agc_nsf:
        inputs.append(gains.reshape(-1))
    plane = jax.ShapeDtypeStruct((t * c,), jnp.float32)
    out_shape = (plane, plane,
                 jax.ShapeDtypeStruct(((t // every) * c,), jnp.float32)) \
        + (jax.ShapeDtypeStruct((c,), jnp.float32),) * ns
    out = pl.pallas_call(
        functools.partial(_kernel, t_len=t, c_len=c, bc=bc,
                          tc=min(_TC, t), every=every, ns=ns,
                          agc_nsf=agc_nsf, step=step),
        grid=(pl.cdiv(c, bc),),
        out_shape=out_shape,
        compiler_params=pltr.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="costas_loop",
    )(*inputs)
    return (out[0].reshape(t, c), out[1].reshape(t, c),
            out[2].reshape(t // every, c), out[3:])


def costas_run_tm(state: CostasState, zr_tm: jnp.ndarray,
                  zi_tm: jnp.ndarray, params: CostasParams,
                  gear: CostasGear | None = None,
                  trace_every: int | None = None, dd=None,
                  gains: jnp.ndarray | None = None,
                  interpret: bool = False):
    """Run the loop over time-major ``(T, C)`` symbol planes.

    Returns ``(new_state, derot CF32 (T, C), ftrace)`` where ``ftrace`` is
    the post-update loop frequency (rad/symbol), ``(C, T)`` per symbol when
    ``trace_every`` is None, else ``(C, T // trace_every)``: the values
    after symbols ``k*trace_every - 1``.  ``gear`` selects the gear-shift
    loop (state from ``costas_init(..., gear=True)``); ``dd`` = (modulation
    name, constellation scale) the generic decision-directed detector;
    ``gains`` a ``(T // nsf, C)`` per-frame AGC gain plane, each symbol
    scaled by its frame's gain before the loop sees it.

    Raises off the GPU unless ``interpret=True`` (Pallas interpret mode)."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the fused Costas kernel compiles for the GPU only (backend is "
            f"{jax.default_backend()!r}); use costas_impl='scan', or pass "
            "interpret=True to run it in Pallas interpret mode")
    t, c = zr_tm.shape
    every = trace_every or 1
    if t % every:
        raise ValueError(f"trace_every={every} must divide T={t}")
    if gear is not None:
        if dd is not None:
            raise ValueError("the gear-shift loop is QPSK-only")
        if state.lev is None or state.locked is None:
            raise ValueError("gear mode needs costas_init(..., gear=True)")
        state0 = (state.phase, state.freq, state.lev, state.locked)
    else:
        state0 = (state.phase, state.freq)
    agc_nsf = 0
    if gains is not None:
        nf = gains.shape[0]
        if gains.shape != (nf, c) or t % nf:
            raise ValueError(f"gains {gains.shape} do not tile ({t}, {c})")
        agc_nsf = t // nf
    outr, outi, ft, fin = _costas_call(
        zr_tm, zi_tm, tuple(state0), gains, params=_floats(params),
        gear=_floats(gear) if gear is not None else None,
        dd=(dd[0], float(dd[1])) if dd is not None else None,
        every=every, agc_nsf=agc_nsf, interpret=interpret)
    return CostasState(*fin), CF32(outr, outi), ft.T


def costas_run_pallas(state: CostasState, symbols: CF32,
                      params: CostasParams, gear: CostasGear | None = None,
                      interpret: bool = False):
    """Drop-in twin of ``costas_run`` / ``costas_run_gear`` on (C, T)
    symbol batches: returns (new_state, derotated (C, T))."""
    st, derot, _ = costas_run_tm(state, symbols.re.T, symbols.im.T, params,
                                 gear=gear, trace_every=symbols.shape[-1],
                                 interpret=interpret)
    return st, CF32(derot.re.T, derot.im.T)

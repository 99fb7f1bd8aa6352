"""Convolutional FEC: rate-1/2 encoder + soft-decision Viterbi decoder.

Capability extension (the reference has no FEC; its packet primitives stop
at CRC16 + interleave + scramble — SURVEY.md §3.5).  The default code is
the ubiquitous K=7 (133, 171) NASA/Voyager code (d_free = 10, ~5 dB coding
gain with soft decisions at QPSK rates), which pairs naturally with the
golden-prime interleaver already in the frame pipeline.

Design — the decoder is where the structure matters:

* The trellis is static: predecessor indices and branch-output signs for
  all 64 states are precomputed host-side (numpy, cached per code) and
  enter the computation as constants.
* The add-compare-select recursion runs as one ``lax.scan`` over time with
  the **64 states vectorized on the last axis** (and arbitrary batch axes —
  packets, lag/rotation hypotheses — broadcast in front).  Per step it is
  a reshape+repeat (the butterfly predecessor map ``pred(s', p) =
  p*(S/2) + (s' >> 1)`` needs NO gather), two FMAs, one max: pure
  elementwise work, no data-dependent
  control flow.
* Path metrics are renormalized by their per-step max (float32 stays
  bounded); decisions are stored as the scan's stacked output and walked
  back by a second (reverse) scan whose only dynamic access is a one-hot
  contraction over the 64 states — no gathers on the traceback either.
* Soft input is LLRs with the convention of ``modmap.demod_soft``:
  positive = bit 0.  Max-sum Viterbi is invariant to positive scaling, so
  no noise-variance normalization is needed.  Hard-decision decoding is
  the special case ``llr = 1 - 2*bit``.

Encoding is input-independent XOR algebra: each output stream is the mod-2
convolution of the input with a static tap pattern — a handful of shifted
XORs, fully parallel.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class ConvCode:
    """Rate 1/(len(polys)) convolutional code, octal generator polys."""
    constraint: int = 7
    polys: tuple = (0o133, 0o171)

    @property
    def nstates(self) -> int:
        return 1 << (self.constraint - 1)

    @property
    def rate_den(self) -> int:
        return len(self.polys)

    def coded_bits(self, nbits: int) -> int:
        """Coded length for ``nbits`` payload bits, tail-terminated."""
        return self.rate_den * (nbits + self.constraint - 1)


@functools.lru_cache(maxsize=None)
def _trellis(code: ConvCode):
    """Static trellis tables.

    State s packs the last K-1 input bits, newest in the LSB:
    ``s' = ((s << 1) | u) & (S-1)``; the register seen by the taps is
    ``r = (s << 1) | u`` (bit i = input i steps ago).  For each next-state
    s': its input bit is ``u = s' & 1``, its two predecessors are
    ``(s' >> 1) | (p << (K-2))`` for p in {0,1}, and sgn[j][s', p] =
    ``1 - 2*out_j(pred_p, u)`` is the branch-metric sign for output j.
    """
    k, s_count = code.constraint, code.nstates
    sp = np.arange(s_count, dtype=np.int64)
    u = sp & 1
    preds = np.stack([(sp >> 1), (sp >> 1) | (1 << (k - 2))], axis=1)  # (S,2)
    sgns = []
    for g in code.polys:
        r = (preds << 1) | u[:, None]            # (S, 2) 7-bit registers
        out = np.zeros_like(r)
        for bit in range(k):
            if (g >> bit) & 1:
                out ^= (r >> bit) & 1
        sgns.append((1 - 2 * out).astype(np.float32))
    return preds.astype(np.int32), np.stack(sgns, axis=0)  # (S,2), (rd,S,2)


def conv_encode(code: ConvCode, bits: jnp.ndarray) -> jnp.ndarray:
    """Encode (..., n) payload bits -> (..., rate_den*(n+K-1)) coded bits,
    tail-terminated (K-1 zero flush bits drive the encoder back to state 0,
    which is what lets the decoder's traceback start from a known state)."""
    k = code.constraint
    b = jnp.asarray(bits, jnp.int32)
    flushed = jnp.concatenate(
        [b, jnp.zeros(b.shape[:-1] + (k - 1,), jnp.int32)], axis=-1)
    padded = jnp.concatenate(
        [jnp.zeros(b.shape[:-1] + (k - 1,), jnp.int32), flushed], axis=-1)
    n = flushed.shape[-1]
    outs = []
    for g in code.polys:
        acc = jnp.zeros_like(flushed)
        for bit in range(k):
            if (g >> bit) & 1:
                acc = acc ^ padded[..., k - 1 - bit: k - 1 - bit + n]
        outs.append(acc)
    return jnp.stack(outs, axis=-1).reshape(b.shape[:-1] + (code.rate_den * n,))


def viterbi_decode(code: ConvCode, llrs: jnp.ndarray,
                   nbits: int) -> jnp.ndarray:
    """Soft-decision Viterbi decode of (..., rate_den*(nbits+K-1)) LLRs
    (positive = bit 0) back to (..., nbits) hard bits: a ``lax.scan`` of
    add-compare-select steps over the trellis, packets batched on the
    leading axes."""
    k, s_count, rd = code.constraint, code.nstates, code.rate_den
    nsteps = nbits + k - 1
    assert llrs.shape[-1] == rd * nsteps, (llrs.shape, rd * nsteps)
    _, sgns_np = _trellis(code)
    # (rd, 2, S): branch-metric signs with the predecessor choice p leading
    sgns = jnp.asarray(np.moveaxis(sgns_np, -1, 1))
    batch = llrs.shape[:-1]

    ll = jnp.moveaxis(
        llrs.astype(jnp.float32).reshape(batch + (nsteps, rd)), -2, 0)

    # start in state 0 (encoder starts zeroed): big negative elsewhere
    pm0 = jnp.full(batch + (s_count,), -1e9, jnp.float32)
    pm0 = pm0.at[..., 0].set(0.0)

    def acs(pm, l):
        # branch metric for (pred_p -> s'): 0.5 * sum_j sgn_j * llr_j
        bm = 0.5 * sum(sgns[j] * l[..., j:j + 1, None] for j in range(rd))
        # predecessor metrics WITHOUT a gather: pred(s', p) =
        # p*(S/2) + (s' >> 1)  (_trellis), so the (..., 2, S) grid of
        # pm[pred] is just pm split in halves with every element repeated
        # twice — reshape + broadcast, exact and lane-gather-free
        # (CLAUDE.md: lane-axis gathers are ~10x the surrounding compute)
        pred_vals = jnp.repeat(pm.reshape(batch + (2, s_count // 2)), 2,
                               axis=-1)                 # (..., 2, S)
        cand = pred_vals + bm
        d = cand[..., 1, :] > cand[..., 0, :]
        pm = jnp.maximum(cand[..., 0, :], cand[..., 1, :])
        pm = pm - jnp.max(pm, axis=-1, keepdims=True)   # bound float32
        return pm, d

    _, decisions = jax.lax.scan(acs, pm0, ll)           # (T, ..., S) bool

    # traceback from state 0 (tail-terminated), newest decision first
    def back(s, d):
        u = s & 1  # the newest bit in the state IS the consumed input bit
        won = jnp.sum(jax.nn.one_hot(s, s_count, dtype=jnp.float32)
                      * d.astype(jnp.float32), axis=-1) > 0.5
        s_prev = (s >> 1) | (won.astype(jnp.int32) << (k - 2))
        return s_prev, u

    s0 = jnp.zeros(batch, jnp.int32)
    _, us = jax.lax.scan(back, s0, decisions, reverse=True)
    bits = jnp.moveaxis(us, 0, -1).astype(jnp.int32)    # (..., T) in order
    return bits[..., :nbits]


def hard_llrs(bits: jnp.ndarray) -> jnp.ndarray:
    """Hard bits -> unit LLRs (positive = bit 0), for hard-input decoding."""
    return (1 - 2 * jnp.asarray(bits, jnp.int32)).astype(jnp.float32)

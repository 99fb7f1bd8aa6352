"""Rate-1/2 LDPC (IRA structure) with a batched min-sum decoder.

Second FEC family next to the K=7 convolutional code (packet/fec.py) —
capability extension; the reference ships no FEC at all.  The design:

* **Code structure: irregular repeat-accumulate** (the DVB-S2 family).
  ``H = [A | B]`` where A (m x k) has column weight ``dv`` (greedy
  row-balanced, girth-4-free vs both A and the accumulator), and B is the
  lower-bidiagonal accumulator.  Encoding is therefore one dense GF(2)
  matmul plus a prefix-XOR (``cumsum mod 2``) — no generator-matrix
  inversion.
* **Decoder: normalized min-sum over a COMPACT edge layout with one-hot
  contractions for gather/scatter.**  A dense masked (m, n) message
  array would be ~100x the code's actual edge count (H has ~5 nonzeros
  per row of n = 2k columns).  Instead, messages live in a
  ``(..., dmax, m)`` block (dmax = max check degree); the variable-node
  scatter-add and the check-node gather are each ONE matmul against a
  static 0/1 edge matrix (``(dmax*m, n)``) with f32 accumulation, and the
  row min/submin/sign-parity reductions run over the tiny dmax axis.
  That matmul costs m*n per iteration, not the edge count: a gather plus
  ``segment_sum`` message pass is the sparse form worth measuring on the
  GPU (ROADMAP).
  The iteration loop is a ``lax.scan`` with static shapes; packets batch
  on the leading axes.
* **Decode-free frame sync**: the parity-check syndrome weight
  (``ldpc_syndrome_weight``) separates aligned from misaligned frames
  (~0.16*m vs ~0.5*m at operating SNR) with one int matmul, so
  ``sync.find_sync``'s 4-rotation x lag hypothesis sweep never has to run
  BP (the convolutional path has no such shortcut and pays a Viterbi per
  hypothesis).

LLR convention matches ops/modmap.demod_soft: positive = bit 0.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(1e30)


@dataclasses.dataclass(frozen=True)
class LdpcCode:
    """Rate-1/2 IRA LDPC for ``k`` message bits (n = 2k, m = k checks)."""
    k: int
    dv: int = 3          # message-column weight
    seed: int = 1        # deterministic construction seed
    iters: int = 25      # min-sum iterations
    alpha: float = 0.8   # min-sum normalization

    @property
    def m(self) -> int:
        return self.k

    @property
    def n(self) -> int:
        return 2 * self.k


@functools.lru_cache(maxsize=None)
def _matrices(k: int, dv: int, seed: int):
    """(A, H) numpy uint8: A (m x k) message part, H = [A | B] (m x n).

    Greedy balanced construction: each message column takes the ``dv``
    least-loaded check rows, re-drawn if any row *pair* is already used by
    another column or collides with an accumulator pair (i, i+1) — that
    keeps the Tanner graph free of 4-cycles, which short-length BP is
    sensitive to."""
    m = k
    rng = np.random.default_rng(seed)
    a = np.zeros((m, k), np.uint8)
    load = np.zeros(m, np.int64)
    used = {(i, i + 1) for i in range(m - 1)}   # accumulator pairs
    for j in range(k):
        for _ in range(200):
            order = np.argsort(load + rng.uniform(0.0, 0.9, m))
            rows = np.sort(order[:dv])
            pairs = [(int(rows[x]), int(rows[y]))
                     for x in range(dv) for y in range(x + 1, dv)]
            if all(p not in used for p in pairs):
                break
        used.update(pairs)
        a[rows, j] = 1
        load[rows] += 1
    b = np.eye(m, dtype=np.uint8)
    b[np.arange(1, m), np.arange(0, m - 1)] = 1   # accumulator
    h = np.concatenate([a, b], axis=1)
    return a, h


def ldpc_encode(code: LdpcCode, bits: jnp.ndarray) -> jnp.ndarray:
    """(..., k) message bits -> (..., 2k) systematic codeword [u | p]:
    s = A u (GF(2) dense matmul), p = prefix-XOR(s) (the accumulator)."""
    a, _ = _matrices(code.k, code.dv, code.seed)
    u = jnp.asarray(bits, jnp.int32)
    assert u.shape[-1] == code.k, (u.shape, code.k)
    s = (u @ jnp.asarray(a.T, jnp.int32)) % 2
    p = jnp.cumsum(s, axis=-1) % 2
    return jnp.concatenate([u, p], axis=-1)


def ldpc_syndrome_weight(code: LdpcCode, bits: jnp.ndarray) -> jnp.ndarray:
    """Number of violated parity checks of (..., n) hard bits — the
    decode-free sync/quality metric (0 for a valid codeword)."""
    _, h = _matrices(code.k, code.dv, code.seed)
    c = jnp.asarray(bits, jnp.int32)
    return jnp.sum((c @ jnp.asarray(h.T, jnp.int32)) % 2, axis=-1)


@functools.lru_cache(maxsize=None)
def _edges(k: int, dv: int, seed: int):
    """Compact edge tables for the min-sum decoder.

    Returns (scat, valid, dmax): ``scat`` is the (dmax*m, n) 0/1 scatter
    matrix — row ``s*m + i`` is the one-hot of the variable that check i's
    slot s connects to (all-zero for padded slots past the check's degree);
    ``valid`` (dmax, m) masks real slots.  ``scat`` does double duty:
    ``e_flat @ scat`` is the variable-node scatter-add and
    ``total @ scat.T`` the check-node gather — both matmuls, no
    dynamic indexing anywhere."""
    _, h = _matrices(k, dv, seed)
    m, n = h.shape
    deg = h.sum(axis=1)
    dmax = int(deg.max())
    scat = np.zeros((dmax * m, n), np.float32)
    valid = np.zeros((dmax, m), np.float32)
    for i in range(m):
        cs = np.flatnonzero(h[i])
        for s, v in enumerate(cs):
            scat[s * m + i, v] = 1.0
            valid[s, i] = 1.0
    return scat, valid, dmax


def ldpc_decode(code: LdpcCode, llrs: jnp.ndarray,
                iters: int | None = None) -> jnp.ndarray:
    """Normalized min-sum decode of (..., n) LLRs -> (..., k) hard bits.

    Messages ride a compact (..., dmax, m) block — the m checks on the
    last axis, the <=dmax edge slots before it (see module docstring);
    check updates are min/submin + sign-parity reductions over the dmax
    axis, and the gather/scatter between checks and variables are one-hot
    matmuls with f32 accumulation.  Fixed iteration count (static shapes;
    a syndrome early-exit would put data-dependent control flow inside
    jit for no throughput gain at batch sizes where the slowest packet
    gates the step anyway)."""
    scat_np, valid_np, dmax = _edges(code.k, code.dv, code.seed)
    scat = jnp.asarray(scat_np)                         # (dmax*m, n)
    valid = jnp.asarray(valid_np)                       # (dmax, m)
    m, n = code.m, code.n
    its = code.iters if iters is None else iters
    llrs = jnp.asarray(llrs, jnp.float32)
    assert llrs.shape[-1] == n, (llrs.shape, n)
    batch = llrs.shape[:-1]
    alpha = jnp.float32(code.alpha)
    slot = jnp.arange(dmax, dtype=jnp.int32)[:, None]   # (dmax, 1)

    def gather(total):
        """(..., n) variable totals -> (..., dmax, m) per-edge values."""
        flat = jnp.matmul(total, scat.T,
                          preferred_element_type=jnp.float32)
        return flat.reshape(batch + (dmax, m))

    def check_update(mm):
        """Check-node min-sum: (..., dmax, m) var->check messages ->
        (..., dmax, m) check->var messages."""
        amag = jnp.where(valid > 0, jnp.abs(mm), _BIG)
        am = jnp.argmin(amag, axis=-2)                  # (..., m)
        m1 = jnp.min(amag, axis=-2)
        m2 = jnp.min(jnp.where(slot == am[..., None, :], _BIG, amag),
                     axis=-2)
        neg = jnp.where((mm < 0) & (valid > 0), 1.0, 0.0)
        srow = 1.0 - 2.0 * (jnp.sum(neg, axis=-2) % 2.0)   # (..., m)
        sj = jnp.where(mm < 0, -1.0, 1.0)
        mag = jnp.where(slot == am[..., None, :], m2[..., None, :],
                        m1[..., None, :])
        return alpha * srow[..., None, :] * sj * mag * valid

    mm = gather(llrs) * valid                           # var->check init

    def bp(mm, _):
        e = check_update(mm)
        total = llrs + jnp.matmul(e.reshape(batch + (dmax * m,)), scat,
                                  preferred_element_type=jnp.float32)
        mm = gather(total) - e                          # exclude own msg
        return mm, None

    mm, _ = jax.lax.scan(bp, mm, None, length=its - 1)
    # final half-iteration: posterior totals from the last messages
    e = check_update(mm)
    total = llrs + jnp.matmul(e.reshape(batch + (dmax * m,)), scat,
                              preferred_element_type=jnp.float32)
    return (total[..., :code.k] < 0).astype(jnp.int32)

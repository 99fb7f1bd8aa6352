"""The surviving FEC decoders against plain numpy references: the
``lax.scan`` soft Viterbi against a textbook add-compare-select loop over
the explicit trellis (hard-LLR ties included: both pick predecessor 0 on
a tie), and the one-hot-matmul min-sum against an edge-list min-sum with
index gathers and ``np.add.at`` scatters."""

import jax.numpy as jnp
import numpy as np
import pytest

from qpsk_tpu.packet.fec import (ConvCode, _trellis, conv_encode, hard_llrs,
                                 viterbi_decode)
from qpsk_tpu.packet.ldpc import LdpcCode, _edges, ldpc_decode, ldpc_encode

CODE = ConvCode()


def np_viterbi(code, llrs, nbits):
    """Max-metric Viterbi over (B, rd*(nbits+K-1)) LLRs, float32, start
    and end in state 0, ties to predecessor 0."""
    k, s_count, rd = code.constraint, code.nstates, code.rate_den
    preds, sgns = _trellis(code)                 # (S, 2), (rd, S, 2)
    t_len = nbits + k - 1
    ll = np.asarray(llrs, np.float32).reshape(-1, t_len, rd)
    b = ll.shape[0]
    pm = np.full((b, s_count), -1e9, np.float32)
    pm[:, 0] = 0.0
    dec = np.zeros((t_len, b, s_count), bool)
    for t in range(t_len):
        bm = np.float32(0.5) * sum(sgns[j][None] * ll[:, t, j, None, None]
                                   for j in range(rd))
        cand = pm[:, preds] + bm                  # (B, S, 2)
        dec[t] = cand[..., 1] > cand[..., 0]
        pm = np.maximum(cand[..., 0], cand[..., 1])
        pm = pm - pm.max(axis=-1, keepdims=True)
    s = np.zeros(b, np.int64)
    out = np.zeros((b, t_len), np.int32)
    for t in reversed(range(t_len)):
        out[:, t] = s & 1
        won = dec[t, np.arange(b), s]
        s = (s >> 1) | (won.astype(np.int64) << (k - 2))
    return out[:, :nbits]


def _conv_noisy(rng, nbits, batch, sigma):
    u = jnp.asarray(rng.integers(0, 2, batch + (nbits,), dtype=np.int64))
    x = 1.0 - 2.0 * np.asarray(conv_encode(CODE, u), np.float32)
    return u, x + rng.normal(0, sigma, x.shape).astype(np.float32)


@pytest.mark.parametrize("nbits,batch", [(256, (48,)), (238, (5,)),
                                         (100, (3, 7))])
def test_viterbi_matches_numpy_soft(nbits, batch):
    rng = np.random.default_rng(nbits)
    _, llrs = _conv_noisy(rng, nbits, batch, 0.7)
    got = np.asarray(viterbi_decode(CODE, jnp.asarray(llrs), nbits))
    want = np_viterbi(CODE, llrs.reshape(-1, llrs.shape[-1]), nbits)
    np.testing.assert_array_equal(got.reshape(-1, nbits), want)


def test_viterbi_matches_numpy_hard_ties():
    """Hard LLRs (+-1) tie constantly: the tie rule must match."""
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.integers(0, 2, (32, 256), dtype=np.int64))
    c = np.asarray(conv_encode(CODE, u))
    flips = (rng.random(c.shape) < 0.03).astype(np.int64)
    llrs = hard_llrs(jnp.asarray((c + flips) % 2))
    got = np.asarray(viterbi_decode(CODE, llrs, 256))
    np.testing.assert_array_equal(got, np_viterbi(CODE, llrs, 256))
    assert (got == np.asarray(u)).mean() > 0.99


def np_min_sum(code, llrs, iters=None):
    """Flooding normalized min-sum over explicit edge lists."""
    scat, valid, dmax = _edges(code.k, code.dv, code.seed)
    m = code.m
    slot, chk = np.nonzero(valid)                 # edges (slot, check)
    var = np.argmax(scat[slot * m + chk], axis=1)  # variable of each edge
    llrs = np.asarray(llrs, np.float32).reshape(-1, code.n)
    b = llrs.shape[0]
    its = code.iters if iters is None else iters
    big = np.float32(1e30)

    def check_update(mm):                         # (B, E) var->check
        full = np.full((b, dmax, m), big, np.float32)
        full[:, slot, chk] = np.abs(mm)
        am = np.argmin(full, axis=1)              # (B, m)
        m1 = np.min(full, axis=1)
        full2 = full.copy()
        np.put_along_axis(full2, am[:, None, :], big, axis=1)
        m2 = np.min(full2, axis=1)
        neg = np.zeros((b, m), np.int64)
        np.add.at(neg, (slice(None), chk), (mm < 0).astype(np.int64))
        srow = np.where(neg % 2 == 1, -1.0, 1.0).astype(np.float32)
        mag = np.where(am[:, chk] == slot, m2[:, chk], m1[:, chk])
        sj = np.where(mm < 0, -1.0, 1.0).astype(np.float32)
        return np.float32(code.alpha) * srow[:, chk] * sj * mag

    def totals(e):
        tot = llrs.copy()
        np.add.at(tot, (slice(None), var), e)
        return tot

    mm = llrs[:, var]
    for _ in range(its - 1):
        e = check_update(mm)
        mm = totals(e)[:, var] - e
    return (totals(check_update(mm))[:, :code.k] < 0).astype(np.int32)


@pytest.mark.parametrize("k,batch,sigma,iters", [
    (256, (16,), 0.7, None), (128, (3, 5), 0.6, 8), (64, (9,), 0.8, None)])
def test_ldpc_matches_numpy_min_sum(k, batch, sigma, iters):
    rng = np.random.default_rng(k)
    code = LdpcCode(k=k)
    u = jnp.asarray(rng.integers(0, 2, batch + (k,), dtype=np.int64))
    x = 1.0 - 2.0 * np.asarray(ldpc_encode(code, u), np.float32)
    llrs = x + rng.normal(0, sigma, x.shape).astype(np.float32)
    got = np.asarray(ldpc_decode(code, jnp.asarray(llrs), iters=iters))
    want = np_min_sum(code, llrs, iters).reshape(got.shape)
    # the two sum variable totals in different f32 orders: allow the odd
    # tie flip
    assert (got == want).mean() >= 0.999, (got == want).mean()
    assert got.shape == batch + (k,)

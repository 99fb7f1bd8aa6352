"""Generic linear-modulation family: BPSK / 8PSK / 16QAM.

The reference is a QPSK-only modem (qpsk.c:58-79 hardcodes the 4-point
constellation and its slicer).  QPSK stays the specialized flagship here —
``ops/modmap.py`` is bit-exact against the C
chain and is NOT routed through this module.  This module generalizes the
same frame/packet stack (RRC pulse shaping, timing, decision-directed
carrier recovery, CRC/scramble/interleave/FEC framing, sync hunt) to the
other constellations an audio-band packet-modem deployment actually wants:
BPSK for the low-SNR end, 8PSK / 16QAM for the high-rate end.

Shapes, no gathers on hot paths:

* mapping is a one-hot contraction ``(..., n, M) @ (M,)`` (the 4-entry
  table gather was the round-2 TX compile pathology; CLAUDE.md);
* slicing / LLRs are dense ``(..., n, M)`` score matrices — M <= 16 rides
  the last axis, argmax/max reductions are exact f32;
* soft output is max-log LLRs (sign convention: positive = bit 0, matching
  ``modmap.demod_soft``), computed from the same score matrix under any
  rotation hypothesis by pure relabeling — the distances never change, so
  an n_rot-way ambiguity search costs bookkeeping, not arithmetic.

Conventions shared with the QPSK path:

* bits serialize MSB-first per symbol (QPSK emits [b1, b0] per symbol,
  qpsk.c:278-279); label = sum(bits[i] << (bps-1-i));
* constellations are unit average power; the post-matched-filter chain
  magnitude is ~1.45x (the reference's double-GAIN, SURVEY.md C6) — PSK
  decisions are scale-free, 16QAM passes ``scale`` (= ``cfg.agc_target``,
  the level the AGC normalizes to);
* the decision-directed carrier loop leaves an n_rot-fold phase ambiguity
  (the constellation's rotational symmetry order); ``rot_labels`` maps a
  decided label back to the TX label under hypothesis r, resolved one
  layer up by the CRC-scored sync hunt (qpsk_tpu.sync).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.cplx import CF32


class Modulation(NamedTuple):
    """One constellation: Gray-labeled points + its ambiguity group.

    ``rot_labels[r][k]`` is the TX-label hypothesis for decided label ``k``
    when the carrier lock sits ``r`` ambiguity steps (of ``tau/n_rot``) away
    from the TX constellation — precomputed inverse-rotation permutations,
    ``rot_labels[0]`` is the identity.
    """
    name: str
    bps: int                 # bits per symbol
    points_re: np.ndarray    # (M,) float32, indexed by Gray label
    points_im: np.ndarray    # (M,)
    n_rot: int               # rotational-symmetry / ambiguity order
    rot_labels: np.ndarray   # (n_rot, M) int32 label relabeling per hypothesis

    @property
    def M(self) -> int:
        return 1 << self.bps


def _nearest_label(pre: np.ndarray, pim: np.ndarray, re: float,
                   im: float) -> int:
    return int(np.argmin((pre - re) ** 2 + (pim - im) ** 2))


def _build(name: str, bps: int, pre: np.ndarray, pim: np.ndarray,
           n_rot: int) -> Modulation:
    m = 1 << bps
    assert pre.shape == (m,) and pim.shape == (m,)
    step = 2.0 * np.pi / n_rot
    c, s = np.cos(step), np.sin(step)
    # P[k] = label decided when TX label k arrives rotated one step CCW.
    perm = np.array([_nearest_label(pre, pim, c * pre[k] - s * pim[k],
                                    s * pre[k] + c * pim[k])
                     for k in range(m)], dtype=np.int32)
    assert sorted(perm.tolist()) == list(range(m)), (
        f"{name}: constellation not invariant under its ambiguity step")
    inv = np.argsort(perm).astype(np.int32)   # TX label from decided label
    rot = [np.arange(m, dtype=np.int32)]
    for _ in range(n_rot - 1):
        rot.append(inv[rot[-1]])
    assert np.array_equal(inv[rot[-1]], rot[0]), f"{name}: group order wrong"
    return Modulation(name=name, bps=bps,
                      points_re=pre.astype(np.float32),
                      points_im=pim.astype(np.float32),
                      n_rot=n_rot,
                      rot_labels=np.stack(rot))


def _make_bpsk() -> Modulation:
    return _build("bpsk", 1, np.array([1.0, -1.0]), np.zeros(2), 2)


def _make_8psk() -> Modulation:
    # circle position k at angle (2k+1)*pi/8, Gray label k ^ (k >> 1):
    # decision regions are the [k*pi/4, (k+1)*pi/4) sectors, adjacent
    # sectors differ in one bit.
    k = np.arange(8)
    ang = (2 * k + 1) * np.pi / 8.0
    gray = k ^ (k >> 1)
    pre, pim = np.zeros(8), np.zeros(8)
    pre[gray] = np.cos(ang)
    pim[gray] = np.sin(ang)
    return _build("8psk", 3, pre, pim, 8)


def _make_16qam() -> Modulation:
    # Gray per axis: levels [-3,-1,+1,+3]/sqrt(10) carry axis-labels
    # [0,1,3,2]; symbol label = (gray_I << 2) | gray_Q, unit average power.
    lev = np.array([-3.0, -1.0, 1.0, 3.0]) / np.sqrt(10.0)
    gray2 = np.array([0, 1, 3, 2])
    pre, pim = np.zeros(16), np.zeros(16)
    for i in range(4):
        for q in range(4):
            lab = (gray2[i] << 2) | gray2[q]
            pre[lab] = lev[i]
            pim[lab] = lev[q]
    return _build("16qam", 4, pre, pim, 4)


MODULATIONS: dict[str, Modulation] = {
    m.name: m for m in (_make_bpsk(), _make_8psk(), _make_16qam())}

# the acquisition M-power per modulation: raising to this power strips the
# modulation, leaving a spectral line at power * offset (ops/acquire.py).
# 16QAM keeps a (weaker) 4th-power line — the classic quadriphase estimator.
ACQUIRE_POWER = {"bpsk": 2, "qpsk": 4, "8psk": 8, "16qam": 4}


def get(name: str) -> Modulation:
    try:
        return MODULATIONS[name]
    except KeyError:
        raise ValueError(f"unknown modulation {name!r} "
                         f"(generic family: {sorted(MODULATIONS)})") from None


# ---------------------------------------------------------------------------
# mapping (TX)

def bits_to_labels(bits: jnp.ndarray, mod: Modulation) -> jnp.ndarray:
    """(..., bps*n) bits -> (..., n) int32 labels, MSB-first per symbol."""
    b = jnp.asarray(bits, jnp.int32)
    assert b.shape[-1] % mod.bps == 0, (b.shape, mod.bps)
    g = b.reshape(b.shape[:-1] + (-1, mod.bps))
    w = jnp.asarray([1 << (mod.bps - 1 - i) for i in range(mod.bps)],
                    jnp.int32)
    return jnp.sum(g * w, axis=-1)


def labels_to_bits(labels: jnp.ndarray, mod: Modulation) -> jnp.ndarray:
    """(..., n) labels -> (..., bps*n) bits, MSB-first per symbol."""
    lab = jnp.asarray(labels, jnp.int32)
    sh = jnp.asarray([mod.bps - 1 - i for i in range(mod.bps)], jnp.int32)
    bits = (lab[..., None] >> sh) & 1
    return bits.reshape(lab.shape[:-1] + (lab.shape[-1] * mod.bps,))


def labels_to_symbols(labels: jnp.ndarray, mod: Modulation) -> CF32:
    """Constellation lookup as a one-hot contraction (gather-free)."""
    oh = (labels[..., None] == jnp.arange(mod.M, dtype=jnp.int32)).astype(
        jnp.float32)
    return CF32(oh @ jnp.asarray(mod.points_re),
                oh @ jnp.asarray(mod.points_im))


def bits_to_symbols_mod(bits: jnp.ndarray, mod: Modulation) -> CF32:
    """(..., bps*n) bits -> (..., n) unit-average-power symbols."""
    return labels_to_symbols(bits_to_labels(bits, mod), mod)


# ---------------------------------------------------------------------------
# slicing (RX)

def symbol_scores(sym: CF32, mod: Modulation, scale=1.0) -> jnp.ndarray:
    """(..., n) symbols -> (..., n, M) nearest-point scores.

    ``score_k = 2*s*(z . c_k) - s^2*|c_k|^2 = |z|^2 - |z - s*c_k|^2``:
    argmax is the minimum-distance decision; score DIFFERENCES equal
    (negated) squared-distance differences, so max-log LLRs come straight
    off this matrix.  For PSK (equal |c_k|) the argmax is scale-free.
    """
    s = jnp.float32(scale)
    cre = jnp.asarray(mod.points_re) * s
    cim = jnp.asarray(mod.points_im) * s
    return (2.0 * (sym.re[..., None] * cre + sym.im[..., None] * cim)
            - (cre * cre + cim * cim))


def slice_labels(sym: CF32, mod: Modulation, scale=1.0) -> jnp.ndarray:
    """Minimum-distance decisions: (..., n) int32 labels."""
    return jnp.argmax(symbol_scores(sym, mod, scale), axis=-1).astype(
        jnp.int32)


def demod_bits_mod(sym: CF32, mod: Modulation, scale=1.0,
                   rotation=0) -> jnp.ndarray:
    """(..., n) symbols -> (..., bps*n) hard bits under rotation hypothesis
    ``rotation`` (static int; 0 = trust the lock)."""
    lab = slice_labels(sym, mod, scale)
    if rotation:
        lab = jnp.asarray(mod.rot_labels[rotation])[lab]
    return labels_to_bits(lab, mod)


def rotate_bits_mod(bits: jnp.ndarray, r, mod: Modulation) -> jnp.ndarray:
    """Re-slice a SYMBOL-ALIGNED demodulated bit stream (..., bps*n) under
    rotation hypothesis ``r`` — the generic twin of ``sync.rotate_dibits``.
    ``r`` may be a static int or traced scalar."""
    lab = bits_to_labels(bits, mod)
    table = jnp.asarray(mod.rot_labels)     # (n_rot, M)
    perm = table[r] if isinstance(r, int) else jnp.take(table, r, axis=0)
    return labels_to_bits(perm[lab], mod)


# ---------------------------------------------------------------------------
# soft output

def _bit_masks(mod: Modulation, rotation: int) -> np.ndarray:
    """(M, bps) float32: bit b (MSB-first) of the TX-label hypothesis for
    decided label k under ``rotation``."""
    lab = mod.rot_labels[rotation]
    return np.stack([(lab >> (mod.bps - 1 - b)) & 1
                     for b in range(mod.bps)], axis=-1).astype(np.float32)


_BIG = np.float32(1e30)


def soft_from_scores(scores: jnp.ndarray, mod: Modulation,
                     rotation: int = 0) -> jnp.ndarray:
    """(..., n, M) scores -> (..., bps*n) max-log LLRs (positive = bit 0)
    under rotation hypothesis ``rotation`` (static int).

    llr_b = max_{k: bit_b=0} score_k - max_{k: bit_b=1} score_k
          = min_{bit_b=1} |z-c|^2 - min_{bit_b=0} |z-c|^2.
    """
    masks = jnp.asarray(_bit_masks(mod, rotation))          # (M, bps)
    s = scores[..., None]                                   # (..., n, M, 1)
    llr = (jnp.max(s - _BIG * masks, axis=-2)
           - jnp.max(s - _BIG * (1.0 - masks), axis=-2))    # (..., n, bps)
    return llr.reshape(scores.shape[:-2] + (scores.shape[-2] * mod.bps,))


def demod_soft_mod(sym: CF32, mod: Modulation, scale=1.0,
                   rotation: int = 0) -> jnp.ndarray:
    """(..., n) symbols -> (..., bps*n) max-log LLRs (positive = bit 0)."""
    return soft_from_scores(symbol_scores(sym, mod, scale), mod, rotation)


# ---------------------------------------------------------------------------
# decision-directed carrier-recovery error (the generic Costas detector)

def dd_constants(mod: Modulation, scale=1.0) -> np.ndarray:
    """Flat float32 detector constants — scaled constellation re/im,
    |c|^2, then per-family extras — shared verbatim by the scan detector,
    the fused Costas kernel (ops/pallas/costas_kernel.py) and the hard
    slicer: all run ``dd_err_ops`` on the SAME float32 values.

    Layout: ``[cre(M), cim(M), 1/p2(M)] + extras`` where extras is the
    16QAM axis-decision threshold (one scalar) and empty otherwise."""
    s = float(scale)
    cre = (mod.points_re * np.float32(s)).astype(np.float32)
    cim = (mod.points_im * np.float32(s)).astype(np.float32)
    # INVERSE |c|^2: the error term multiplies by this instead of
    # dividing — a division by a loop-invariant scalar is strength-
    # reduced to a reciprocal multiply by some compilers but not others,
    # a 1-ULP slack between lowerings; precomputing the inverse makes
    # every path multiply
    ip2 = (np.float32(1.0)
           / ((mod.points_re ** 2 + mod.points_im ** 2)
              * np.float32(s * s) + np.float32(1e-12))).astype(np.float32)
    extras = []
    if mod.name == "16qam":
        # inner/outer level boundary per axis: 2/sqrt(10) * scale
        extras = [np.float32(np.float32(2.0 / np.sqrt(10.0))
                             * np.float32(s))]
    return np.concatenate([cre, cim, ip2, np.asarray(extras, np.float32)])


def dd_err_ops(name: str, m: int, outr, outi, get,
               want_label: bool = False):
    """The per-step decision-directed error, as ONE literal op program
    shared by the ``lax.scan`` detector, the fused Costas kernel (which
    runs the scan's detector) and the hard slicer.
    With ``want_label`` also returns the decided Gray LABEL (int32, same
    shape) — the comparison decisions already pick it, so emitting it is
    pure int selects that never touch the float error chain (the hard
    slicer ``slice_labels_cmp`` uses them).  Returns ``err`` or
    ``(err, label)``.

    One hazard shapes this code (CLAUDE.md):

    * **Decisions use boundary-exact comparisons only** — sign and |a|>|b|
      tests on the derotated symbol, never score arithmetic: a score like
      ``2*(re*c + im*s) - p2`` contains a fusable mul-add whose FMA
      contraction differs BETWEEN compilers (Triton vs XLA:GPU vs
      XLA:CPU) and BETWEEN shapes, so score-compared decisions can flip
      on near-ties one lowering sees and the other doesn't.  All three
      family constellations decide exactly: BPSK by sign, 8PSK by octant
      (sign(re), sign(im), |im|>|re| — its boundaries ARE the axes and
      diagonals), 16QAM per-axis (sign + |axis|>threshold).

    The error products ``u - v`` may be FMA-contracted by one compiler
    and not another, so the kernel and the scan agree to rounding
    (measured within 3e-6 on the card), not bit for bit.

    ``get(i)`` reads the i-th ``dd_constants`` scalar (numpy closure in
    every caller); constants selected through exact comparisons are
    identical everywhere.
    """
    def const_like(i):
        return jnp.full_like(outr, get(i))

    def ret(err, lab):
        if want_label:
            return err, lab.astype(jnp.int32)
        return err

    if name == "bpsk":
        # labels: 0 -> +1, 1 -> -1 (cim = 0)
        neg = outr < 0.0
        cr = jnp.where(neg, const_like(1), const_like(0))
        u, v = outi * cr, outr * 0.0
        return ret((u - v) * const_like(2 * m),
                   jnp.where(neg, 1, 0) if want_label else None)
    if name == "8psk":
        # octant decision: boundaries at the axes and diagonals, all
        # exact comparisons.  The sector position is the reflected-Gray
        # walk of the three boundary bits, so the Gray LABEL has the
        # closed form (s_im << 2) | (s_re << 1) | diag — and the ring
        # constants select through a 3-deep where tree on the same bits
        # (the old 7-octant mask sweep put ~35 dependent ops on the
        # serial DD chain; this is ~16 for the same decisions and
        # the SAME selected f32 constants, so trajectories are
        # bit-identical).
        s_im = outi < 0.0
        s_re = outr < 0.0
        diag = jnp.abs(outi) > jnp.abs(outr)

        def tree(base):
            def pick(a, b):
                return jnp.where(diag, const_like(base + a),
                                 const_like(base + b))
            return jnp.where(s_im,
                             jnp.where(s_re, pick(7, 6), pick(5, 4)),
                             jnp.where(s_re, pick(3, 2), pick(1, 0)))

        cr = tree(0)
        ci = tree(m)
        lab_arr = None
        if want_label:
            lab_arr = ((s_im.astype(jnp.int32) << 2)
                       | (s_re.astype(jnp.int32) << 1)
                       | diag.astype(jnp.int32))
        u, v = outi * cr, outr * ci
        # 1/|c|^2 uniform on the ring
        return ret((u - v) * const_like(2 * m), lab_arr)
    if name == "16qam":
        # per-axis Gray decision: level index by sign + threshold, labels
        # (gray_I << 2) | gray_Q.  The constellation is a PRODUCT, so the
        # error constants select per axis: cre[(g<<2)|q] is q-invariant
        # (the I level) and cim[(i<<2)|g] i-invariant, and 1/|c|^2 depends
        # only on the two far/near flags — 9 selects total instead of the
        # old 16-mask per-label sweep (~64 dependent ops on the serial
        # DD chain).  Same comparisons,
        # same selected f32 table values: trajectories are bit-identical.
        thr = const_like(3 * m)
        neg_i, far_i = outr < 0.0, jnp.abs(outr) > thr
        neg_q, far_q = outi < 0.0, jnp.abs(outi) > thr
        # level -> gray axis label (-3 -> 0, -1 -> 1, +1 -> 3, +3 -> 2)
        cr = jnp.where(neg_i,
                       jnp.where(far_i, const_like(0 << 2),
                                 const_like(1 << 2)),
                       jnp.where(far_i, const_like(2 << 2),
                                 const_like(3 << 2)))
        ci = jnp.where(neg_q,
                       jnp.where(far_q, const_like(m + 0), const_like(m + 1)),
                       jnp.where(far_q, const_like(m + 2), const_like(m + 3)))
        ic2 = jnp.where(far_i,
                        jnp.where(far_q, const_like(2 * m + 0),
                                  const_like(2 * m + 1)),
                        jnp.where(far_q, const_like(2 * m + 4),
                                  const_like(2 * m + 5)))
        lab = None
        if want_label:
            gi = jnp.where(neg_i, jnp.where(far_i, 0, 1),
                           jnp.where(far_i, 2, 3))
            gq = jnp.where(neg_q, jnp.where(far_q, 0, 1),
                           jnp.where(far_q, 2, 3))
            lab = (gi << 2) | gq
        u, v = outi * cr, outr * ci
        return ret((u - v) * ic2, lab)
    raise ValueError(f"no decision program for modulation {name!r}")


def slice_labels_cmp(sym: CF32, mod: Modulation, scale=1.0) -> jnp.ndarray:
    """Minimum-distance decisions via the COMPARISON program — the exact
    decision the DD carrier loop itself makes (``dd_err_ops``), so the hard
    bit stream always agrees with the loop's decisions, and every decision
    is a boundary-exact sign/|a|>|b|/threshold comparison (score-argmax
    decisions do not survive cross-lowering FMA differences; CLAUDE.md).  Geometrically
    identical to ``slice_labels`` (the Gray regions ARE the min-distance
    regions for the whole family); the two can differ only on exact
    floating-point boundary ties."""
    consts = dd_constants(mod, scale)
    _, lab = dd_err_ops(mod.name, mod.M, sym.re, sym.im,
                        get=lambda i: consts[i], want_label=True)
    return lab


def demod_bits_cmp(sym: CF32, mod: Modulation, scale=1.0,
                   rotation=0) -> jnp.ndarray:
    """Hard bits via the comparison-program slicer (the modem RX default;
    ``demod_bits_mod`` is the score-argmax twin)."""
    lab = slice_labels_cmp(sym, mod, scale)
    if rotation:
        lab = jnp.asarray(mod.rot_labels[rotation])[lab]
    return labels_to_bits(lab, mod)


def dd_detector(mod: Modulation, scale=1.0):
    """Decision-directed phase detector for ``ops.costas.costas_run``:
    ``err = Im(z * conj(c_hat)) / |c_hat|^2`` with ``c_hat`` the
    minimum-distance decision — approximately the phase error in radians
    (scaled by |z|/|c_hat|), stable lock points ON the constellation with
    an ``n_rot``-fold ambiguity.  The QPSK flagship keeps the reference's
    sign-based detector (costas_loop.c:44-47, locks on the diagonals);
    this generic form covers the rest of the family (for 16QAM run the
    AGC so |z| matches ``scale`` — the ring decisions are scale-true).
    Bit-identical to the fused kernel's DD mode: see ``dd_err_ops``.
    """
    # NUMPY constants in the closure (each jit trace lifts them afresh):
    # capturing device arrays here would leak the first trace's tracers
    # through the lru_cache'd closure into later traces
    consts = dd_constants(mod, scale)

    def detector(z: CF32) -> jnp.ndarray:
        return dd_err_ops(mod.name, mod.M, z.re, z.im,
                          get=lambda i: consts[i])

    return detector


# ---------------------------------------------------------------------------
# metrics

def evm_mod(sym: CF32, mod: Modulation, normalize: bool = True):
    """EVM against the nearest constellation point (generic twin of
    ``metrics.evm``): with ``normalize`` the cloud is first scaled to the
    constellation's unit RMS so chain gain doesn't read as error."""
    p = jnp.mean(sym.re ** 2 + sym.im ** 2, axis=-1)
    sc = jnp.where(p > 0, 1.0 / jnp.sqrt(p), 1.0)[..., None] if normalize \
        else jnp.float32(1.0)
    z = CF32(sym.re * sc, sym.im * sc)
    lab = slice_labels(z, mod, scale=1.0)
    ideal = labels_to_symbols(lab, mod)
    err2 = (z.re - ideal.re) ** 2 + (z.im - ideal.im) ** 2
    return jnp.sqrt(jnp.mean(err2, axis=-1))

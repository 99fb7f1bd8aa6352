"""Frame synchronization: phase-ambiguity resolution + packet alignment.

The Costas loop locks QPSK with a 4-fold (90°) phase ambiguity, and the RX
symbol stream is offset from packet boundaries by a systematic delay (TX+RX
FIR group delay of ``ntaps - 1`` samples, the decimator's one-frame delay
(qpsk.c:186-191), and the data-dependent timing index).  The reference never
resolves either — its demod bits are discarded (qpsk.c:211).  This module
makes packets recoverable:

* ``rotate_dibits`` applies a 90°·r constellation rotation *after* slicing —
  a 4-entry permutation on dibit indices, so all four hypotheses come from
  one demod pass;
* ``find_sync`` scans (rotation × bit-lag) hypotheses over a probe window
  and scores each by CRC pass count (the scrambler whitens payloads, so a
  wrong hypothesis passes a 16-bit CRC with p = 2^-16) — one batched
  evaluation, no Python-level search on device;
* ``extract_packets`` slices the aligned stream into frames and runs the
  packet disassembly.

Everything is jnp; ``find_sync`` evaluates all hypotheses as one batched
gather + CRC scan (hypotheses ride the batch axis).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from qpsk_tpu.packet.frame import (PacketConfig, RxPacket, disassemble_packet,
                                   disassemble_packet_soft)

# One 90° CCW rotation of the received constellation permutes sliced dibit
# indices 0→1→3→2→0 (quadrant walk of the diagonal lock; see
# ops/modmap.demod_bits).  _ROT_POW[r] is the permutation for r steps.
_ROT_STEP = np.array([1, 3, 0, 2], dtype=np.int32)
_ROT_POW = np.stack([np.arange(4, dtype=np.int32),
                     _ROT_STEP,
                     _ROT_STEP[_ROT_STEP],
                     _ROT_STEP[_ROT_STEP][_ROT_STEP]])


def default_max_lag(pcfg: PacketConfig) -> int:
    """Lag window that always covers a full packet: the systematic RX delay
    is bounded, but the first aligned packet boundary can sit up to one full
    frame into the stream — a hard-coded window smaller than ``frame_bits``
    (large / coded payloads) would park the true lag outside the search and
    fail sync silently."""
    return max(2 * pcfg.frame_bits, 600)


def rotated_streams(bits: jnp.ndarray, modulation: str = "qpsk",
                    soft=None) -> jnp.ndarray:
    """All rotation hypotheses of a SYMBOL-ALIGNED 1-D demod stream:
    (n_rot, n) — hard bits re-sliced per hypothesis, or (with ``soft``
    given instead, an (nsym, M) score matrix from
    ``modfam.symbol_scores``) max-log LLR streams per hypothesis.

    The packet grid is NOT symbol-aligned in general (frame_bits % bps != 0
    for 8PSK), so the generic machinery rotates the whole stream once and
    slices at arbitrary bit lags — for QPSK this equals the historical
    gather-then-``rotate_dibits`` order (relabeling commutes with
    symbol-aligned slicing)."""
    if modulation == "qpsk":
        assert soft is None
        return jnp.stack([rotate_dibits(bits, r) for r in range(4)])
    from qpsk_tpu.ops import modfam
    mod = modfam.get(modulation)
    if soft is not None:
        return jnp.stack([modfam.soft_from_scores(soft, mod, r)
                          for r in range(mod.n_rot)])
    return jnp.stack([modfam.rotate_bits_mod(bits, r, mod)
                      for r in range(mod.n_rot)])


def _mod_geometry(modulation: str):
    """(n_rot, bps, lag_step) of a modulation's hypothesis grid.  QPSK
    keeps the historical even-lag search (frame grids are dibit-aligned);
    generic modulations search every bit lag (e.g. 8PSK's frame_bits is
    not a multiple of 3, so packet boundaries roam over symbol phase)."""
    if modulation == "qpsk":
        return 4, 2, 2
    from qpsk_tpu.ops import modfam
    mod = modfam.get(modulation)
    return mod.n_rot, mod.bps, 1


class SyncResult(NamedTuple):
    rotation: jnp.ndarray   # int32 scalar, 90° steps
    bit_lag: jnp.ndarray    # int32 scalar, bits into the stream
    score: jnp.ndarray      # int32: CRC passes among probe frames


def rotate_dibits(bits: jnp.ndarray, r) -> jnp.ndarray:
    """Re-slice a demodulated bit stream (..., 2n) under rotation hypothesis
    ``r`` (0..3).  bits are per-symbol [b1, b0] pairs (modmap.demod_bits)."""
    b = jnp.asarray(bits, jnp.int32)
    pairs = b.reshape(b.shape[:-1] + (-1, 2))
    m = (pairs[..., 0] << 1) | pairs[..., 1]
    perm = jnp.asarray(_ROT_POW)[r]
    m2 = perm[m]
    out = jnp.stack([(m2 >> 1) & 1, m2 & 1], axis=-1)
    return out.reshape(b.shape)


def rotate_soft(llrs: jnp.ndarray, r) -> jnp.ndarray:
    """Soft-domain twin of ``rotate_dibits``: re-slice an LLR stream
    (..., 2n) under rotation hypothesis ``r``.  One 90-deg CCW step maps a
    symbol (re, im) -> (-im, re), i.e. the per-symbol LLR pair
    (l1, l0) = (im, re) -> (l0, -l1).  Applied with static ``jnp.where``
    over the 4 hypotheses when ``r`` is traced."""
    l = jnp.asarray(llrs, jnp.float32)
    pairs = l.reshape(l.shape[:-1] + (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    cands = []
    for _ in range(4):
        cands.append(jnp.stack([a, b], axis=-1))
        a, b = b, -a
    out = jnp.stack(cands)[r] if isinstance(r, int) else jnp.select(
        [jnp.asarray(r) == k for k in range(4)], cands)
    return out.reshape(l.shape)


def extract_packets_soft(pcfg: PacketConfig, llrs: jnp.ndarray,
                         sync: "SyncResult", nframes: int) -> RxPacket:
    """Soft-decision twin of ``extract_packets``: slice ``nframes`` aligned
    frames out of a 1-D LLR stream (``modmap.demod_soft`` of the demod
    symbols — elementwise aligned with the hard bit stream) and disassemble
    them in the soft domain (soft Viterbi when ``pcfg.fec``)."""
    fb = pcfg.frame_bits
    idx = sync.bit_lag + jnp.arange(nframes * fb, dtype=jnp.int32)
    aligned = rotate_soft(llrs[idx], sync.rotation)
    return disassemble_packet_soft(pcfg, aligned.reshape(nframes, fb))


def extract_packets_soft_mod(pcfg: PacketConfig, scores: jnp.ndarray,
                             sync: SyncResult, nframes: int,
                             modulation: str) -> RxPacket:
    """Generic-modulation twin of ``extract_packets_soft``: soft
    extraction from an (nsym, M) score matrix (``modfam.symbol_scores``
    of the demod symbols) — per-rotation LLR streams are relabelings of
    the one score matrix (see ``rotated_streams``)."""
    fb = pcfg.frame_bits
    streams = rotated_streams(None, modulation, soft=scores)
    idx = sync.bit_lag + jnp.arange(nframes * fb, dtype=jnp.int32)
    aligned = streams[sync.rotation][idx]
    return disassemble_packet_soft(pcfg, aligned.reshape(nframes, fb))


def find_sync(pcfg: PacketConfig, bits: jnp.ndarray, max_lag: int = 512,
              probe_frames: int = 4, modulation: str = "qpsk") -> SyncResult:
    """Search rotation × bit-lag for the hypothesis with the most CRC
    passes over ``probe_frames`` consecutive frames.

    ``bits``: 1-D symbol-aligned demodulated stream, length ≥ max_lag +
    probe_frames * frame_bits.  For QPSK lags are even (frame grids are
    dibit-aligned); generic-family modulations search every bit lag and
    all n_rot rotations.  Returns the winning hypothesis; a score of 0
    means no sync.
    """
    assert bits.ndim == 1, bits.shape
    _, _, lag_step = _mod_geometry(modulation)
    return find_sync_streams(pcfg, rotated_streams(bits, modulation),
                             max_lag=max_lag, probe_frames=probe_frames,
                             lag_step=lag_step)


def find_sync_streams(pcfg: PacketConfig, streams: jnp.ndarray,
                      max_lag: int = 512, probe_frames: int = 4,
                      lag_step: int = 2, soft: bool = False) -> SyncResult:
    """``find_sync`` over PRE-ROTATED streams (R, n) — each row is the
    demod stream re-sliced under one rotation hypothesis
    (``rotated_streams``).  The streaming runtime buffers these rows so
    arbitrary bit-offset consumption never disturbs the per-symbol
    rotation grouping (a raw generic-family stream can only be rotated
    from a symbol-aligned head).

    ``soft``: the rows are per-rotation LLR streams and the conv-coded
    probe decodes SOFT-input Viterbi — the coded PER sweeps showed the
    hard-input hunt is what limits a coded link's low-SNR end (seeds
    decoded clean wherever they synced, but ~2 dB above the soft decode
    floor the hunt itself starts missing); soft scoring costs the same
    trellis work per hypothesis as the hard hunt already pays.  LDPC
    sync stays the decode-free syndrome metric (on the LLR signs)."""
    fb = pcfg.frame_bits
    nrot = streams.shape[0]
    # clamp the lag search to what the stream can support
    avail = int(streams.shape[-1]) - probe_frames * fb
    if avail < 2:
        raise ValueError(
            f"find_sync needs at least {probe_frames * fb + 2} bits "
            f"({probe_frames} probe frames of {fb} bits + a lag window), "
            f"got {streams.shape[-1]}")
    max_lag = min(max_lag, avail)
    lags = jnp.arange(0, max_lag, lag_step, dtype=jnp.int32)   # (L,)
    window = jnp.arange(probe_frames * fb, dtype=jnp.int32)    # (W,)
    # all rotations of every lag window: (R, L, W)
    cand = streams[:, lags[:, None] + window[None, :]]
    frames = cand.reshape(nrot, lags.shape[0], probe_frames, fb)
    if soft and pcfg.fec_kind != "ldpc":
        ok = disassemble_packet_soft(pcfg, frames).crc_ok      # (R, L, P)
        score = ok.sum(-1).astype(jnp.int32)                   # (R, L)
        flat = jnp.argmax(score)
        r = (flat // lags.shape[0]).astype(jnp.int32)
        li = flat % lags.shape[0]
        return SyncResult(rotation=r, bit_lag=lags[li],
                          score=score.reshape(-1)[flat])
    if soft:
        frames = jnp.where(frames < 0, 1, 0)   # LLR signs -> hard bits
    if pcfg.fec_kind == "ldpc":
        # decode-free sync: the parity-check syndrome weight of the
        # unwrapped hard bits separates aligned (~0.16*m at operating SNR)
        # from misaligned (~0.5*m) frames with one int matmul — running
        # min-sum BP over every rotation x lag hypothesis would be ~100x
        # the work of the whole search (packet/ldpc.py docstring)
        from qpsk_tpu.packet.frame import unwrap_bits
        from qpsk_tpu.packet.ldpc import ldpc_syndrome_weight
        code = pcfg.ldpc_code()
        syn = ldpc_syndrome_weight(code, unwrap_bits(pcfg, frames))
        ok = syn < int(0.35 * code.m)                          # (R, L, P)
    else:
        ok = disassemble_packet(pcfg, frames).crc_ok           # (R, L, P)
    score = ok.sum(-1).astype(jnp.int32)                       # (R, L)
    flat = jnp.argmax(score)
    r = (flat // lags.shape[0]).astype(jnp.int32)
    li = flat % lags.shape[0]
    return SyncResult(rotation=r, bit_lag=lags[li], score=score.reshape(-1)[flat])


def extract_packets(pcfg: PacketConfig, bits: jnp.ndarray, sync: SyncResult,
                    nframes: int, modulation: str = "qpsk") -> RxPacket:
    """Slice ``nframes`` aligned frames out of a 1-D symbol-aligned bit
    stream and disassemble them.  ``nframes`` must be static."""
    fb = pcfg.frame_bits
    idx = sync.bit_lag + jnp.arange(nframes * fb, dtype=jnp.int32)
    if modulation == "qpsk":
        aligned = rotate_dibits(bits[idx], sync.rotation)
    else:
        # generic frames are not symbol-aligned (fb % bps != 0): rotate the
        # whole stream under the hypothesis, then slice at the bit lag
        from qpsk_tpu.ops import modfam
        mod = modfam.get(modulation)
        aligned = modfam.rotate_bits_mod(bits, sync.rotation, mod)[idx]
    return disassemble_packet(pcfg, aligned.reshape(nframes, fb))


class TrackedPackets(NamedTuple):
    payload_bits: jnp.ndarray  # (nframes, 8*payload_bytes)
    crc_ok: jnp.ndarray        # (nframes,) bool
    rotation: jnp.ndarray      # (nframes,) int32 — rotation used per packet
    shift: jnp.ndarray = None  # (nframes,) int32 — bit-lag shift used
                               # (None-free: always filled; 0 when untracked)


def walk_step(ok_j: np.ndarray, shifts: np.ndarray, cur_r: int,
              cur_s: int, max_step: int = 2) -> tuple[bool, int, int]:
    """One packet's hypothesis walk, shared by the batch tracker below and
    the streaming ``StreamDemodulator._drain``: if the tracked (rotation,
    shift-index) fails CRC, try candidate shifts ordered by distance from
    the track (capped at one symbol = ``max_step`` bits per packet — how
    timing slips actually accrue), any rotation.  ``ok_j`` is the
    (n_rot, S) CRC verdict grid for this packet.  Returns (good, rotation,
    shift_index); on failure the tracked hypothesis is returned unchanged
    (decode at the track)."""
    if ok_j[cur_r, cur_s]:
        return True, cur_r, cur_s
    for si in sorted(range(len(shifts)),
                     key=lambda k: (abs(shifts[k] - shifts[cur_s]), k)):
        if abs(shifts[si] - shifts[cur_s]) > max_step:
            continue
        passing = np.flatnonzero(ok_j[:, si])
        if passing.size:
            return True, int(passing[0]), si
    return False, cur_r, cur_s


def _track_hypotheses(rx: RxPacket, start_rot: int, shifts: np.ndarray,
                      max_step: int = 2) -> TrackedPackets:
    """Host-side (rotation × lag-shift) tracker shared by the hard and soft
    extractors: given all-hypothesis verdicts (n_rot, S, nframes), per
    packet a hypothesis passing CRC wins and updates the track; CRC-failed
    packets decode at the tracked hypothesis.  Preference order: the
    tracked hypothesis itself, then the tracked shift at another rotation
    (carrier cycle slip), then the nearest shift (symbol slip — the lag
    track may only walk, |Δshift| ≤ one symbol = ``max_step`` bits per
    packet, matching how timing slips actually accrue)."""
    ok = np.asarray(rx.crc_ok)                     # (R, S, nframes)
    payloads = np.asarray(rx.payload_bits)         # (R, S, nframes, bits)
    nframes = ok.shape[2]
    cur_r, cur_s = start_rot, int(np.flatnonzero(shifts == 0)[0])
    rot_used = np.zeros(nframes, np.int32)
    shift_used = np.zeros(nframes, np.int32)
    out_ok = np.zeros(nframes, bool)
    out_payload = np.zeros((nframes, payloads.shape[-1]), payloads.dtype)
    for j in range(nframes):
        good, r, s = walk_step(ok[:, :, j], shifts, cur_r, cur_s, max_step)
        out_ok[j] = good
        if good:
            cur_r, cur_s = r, s
        rot_used[j] = r
        shift_used[j] = shifts[s]
        out_payload[j] = payloads[r, s, j]
    return TrackedPackets(payload_bits=jnp.asarray(out_payload),
                          crc_ok=jnp.asarray(out_ok),
                          rotation=jnp.asarray(rot_used),
                          shift=jnp.asarray(shift_used))


def _shift_set(max_slip: int, bps: int = 2) -> np.ndarray:
    """Symbol-granular bit-lag shifts covering ±max_slip symbol slips
    (one symbol = ``bps`` bits), 0 first-class."""
    return np.arange(-bps * max_slip, bps * max_slip + 1, bps,
                     dtype=np.int32)


def _tracked_from_streams(pcfg: PacketConfig, streams: jnp.ndarray,
                          sync: SyncResult, nframes: int, shifts: np.ndarray,
                          bps: int, soft: bool) -> TrackedPackets:
    """Shared tracked-extraction core: gather every (rotation × lag-shift)
    hypothesis span from per-rotation streams (R, n), disassemble all of
    them in one batched pass, then walk the CRC track."""
    fb = pcfg.frame_bits
    base = sync.bit_lag + jnp.arange(nframes * fb, dtype=jnp.int32)
    idx = jnp.clip(base[None, :] + jnp.asarray(shifts)[:, None],
                   0, streams.shape[-1] - 1)                # (S, nframes*fb)
    cand = streams[:, idx].reshape(streams.shape[0], len(shifts),
                                   nframes, fb)             # (R, S, F, fb)
    rx = (disassemble_packet_soft(pcfg, cand) if soft
          else disassemble_packet(pcfg, cand))
    return _track_hypotheses(rx, int(sync.rotation), shifts, max_step=bps)


def extract_packets_tracked(pcfg: PacketConfig, bits: jnp.ndarray,
                            sync: SyncResult, nframes: int,
                            max_slip: int = 0,
                            modulation: str = "qpsk") -> TrackedPackets:
    """Like ``extract_packets`` but recovers from carrier **cycle slips**:
    at low SNR the loop occasionally slips one ambiguity step (90° for
    QPSK), rotating every subsequent symbol.  All n_rot rotation
    hypotheses of every packet are disassembled in one batched pass
    (cheap: label permutation + XOR + CRC scan); per packet, a hypothesis
    passing CRC wins and updates the tracked rotation, and CRC-failed
    packets are decoded at the tracked rotation — so one slip costs at
    most the packet it lands in, not the rest of the stream.  A 16-bit
    CRC accepts a wrong hypothesis with p = 2^-16.

    ``max_slip`` > 0 additionally recovers from **symbol slips** (a
    timing-phase wrap under sustained clock-rate offset drops or repeats
    one symbol, shifting the whole downstream framing by ±bps bits): the
    hypothesis set becomes rotation × bit-lag shift over
    ±bps·max_slip bits (still one batched pass, (2·max_slip+1)× the work)
    and the tracker walks the accumulated shift at ≤ one symbol per
    packet.  Leave headroom of bps·max_slip bits at the stream end (the
    last packet of the +max shift hypothesis reads that far ahead)."""
    _, bps, _ = _mod_geometry(modulation)
    return _tracked_from_streams(
        pcfg, rotated_streams(bits, modulation), sync, nframes,
        _shift_set(max_slip, bps), bps, soft=False)


def extract_packets_soft_tracked(pcfg: PacketConfig, llrs: jnp.ndarray,
                                 sync: SyncResult, nframes: int,
                                 max_slip: int = 0) -> TrackedPackets:
    """Soft-decision twin of ``extract_packets_tracked`` (QPSK LLR
    streams; generic modulations use
    ``extract_packets_soft_tracked_mod``): all rotation (and with
    ``max_slip`` > 0, lag-shift) hypotheses ride the batch axis through
    the soft disassembly (incl. the Viterbi scan when ``pcfg.fec``), then
    the same tracker picks per packet.  This is the robust low-SNR soft
    path — exactly where FEC operates, cycle slips are routine, so the
    soft extractor needs slip recovery even more than the hard one."""
    streams = jnp.stack([rotate_soft(llrs, r) for r in range(4)])
    return _tracked_from_streams(pcfg, streams, sync, nframes,
                                 _shift_set(max_slip), 2, soft=True)


def extract_packets_soft_tracked_mod(pcfg: PacketConfig, scores: jnp.ndarray,
                                     sync: SyncResult, nframes: int,
                                     modulation: str,
                                     max_slip: int = 0) -> TrackedPackets:
    """Generic-modulation soft tracked extraction from an (nsym, M)
    score matrix (``modfam.symbol_scores`` of the demod symbols, symbol-
    aligned with the hard stream): per-rotation max-log LLR streams are
    pure relabelings of the one score matrix, so the full rotation ×
    lag-shift hypothesis search costs bookkeeping, not re-demodulation."""
    _, bps, _ = _mod_geometry(modulation)
    streams = rotated_streams(None, modulation, soft=scores)
    return _tracked_from_streams(pcfg, streams, sync, nframes,
                                 _shift_set(max_slip, bps), bps, soft=True)

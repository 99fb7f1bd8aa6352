"""Streaming runtime: push-mode demodulation with automatic sync.

The batch API (``rx_stream`` + ``find_sync`` + ``extract_packets_tracked``)
asks the caller to manage state, alignment, and packet framing.  This
module wraps it all into the receiver object a deployment actually wants:

    demod = StreamDemodulator(ModemConfig(), PacketConfig(payload_bytes=30))
    for chunk in audio_source:          # int16 PCM, any chunk size
        for pkt in demod.push(chunk):   # bit-exact payloads as they decode
            handle(pkt.payload)

Behavior:

* arbitrary chunk sizes — samples are buffered to whole frames (the
  native ring buffer in qpsk_tpu.io serves the real-time capture side);
  ``push`` is eager (buffers and demodulates even if the returned packet
  list is discarded);
* FFT acquisition warm-starts the Costas loop on the first frames (when
  ``cfg.acquisition == "fft"``; parity mode cold-starts like the C loop);
  when the CRC hunt rejects both FFT candidates (a deterministic M-power
  spur parked on top, or SNR below the acquisition floor) the candidate
  rotation walks into a static seed-sweep grid covering the band plan's
  offset range — a spur-parked receiver always recovers (``sweep_hz``
  tunes the grid; ``ops.acquire.sweep_candidates_hz``);
* packet sync (rotation + alignment) happens automatically once enough
  post-transient bits accumulate — a sliding hunt across the bit stream —
  and is CRC-tracked thereafter: Costas cycle slips (90° rotations) and,
  with ``slip_track`` > 0, timing symbol slips (±2-bit framing shifts
  under sustained clock drift) each cost one packet, not the stream; each
  drained span disassembles all rotation × lag-shift hypotheses in ONE
  batched device pass;
* with ``pcfg.fec`` the receiver buffers LLRs alongside the hard bits and
  drains packets through soft-decision Viterbi (~2 dB over hard-input
  decoding) — hard bits still drive the CRC-scored sync hunt;
* ``flush()`` drains remaining whole packets; counters expose link metrics
  (frames, packets, CRC failures, detected offset, blind carrier-SNR
  estimate);
* squelch / carrier detect: with ``squelch_db`` set, each demodulated
  bucket updates a blind M2M4 SNR estimate (3 dB hysteresis) and the
  squelch verdict is applied PER BUCKET — a squelched bucket's dead-air
  bits are discarded (after any carrier-present bits buffered ahead of
  them are hunted/drained) and the loop state cold-restarts so the next
  carrier onset re-runs FFT acquisition; ``counters.carrier_detect`` is
  the DCD line;
* signal gaps: if CRC failures persist for ``resync_after`` consecutive
  packets the receiver drops sync and re-acquires — the failure-detect/
  re-arm behavior the reference lacks (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from qpsk_tpu.config import ModemConfig
from qpsk_tpu.metrics import snr_estimate_db_host
from qpsk_tpu.modem import rx_acquire_hz, rx_stream, tx_stream
from qpsk_tpu.ops.acquire import hz_to_costas_freq
from qpsk_tpu.ops.cplx import CF32
from qpsk_tpu.ops.modmap import demod_soft
from qpsk_tpu.packet.frame import (PacketConfig, assemble_packet,
                                   disassemble_packet,
                                   disassemble_packet_soft)
from qpsk_tpu.state import rx_init, tx_init
from qpsk_tpu.sync import (SyncResult, _mod_geometry, default_max_lag,
                           find_sync_streams, rotate_soft, rotated_streams,
                           walk_step)


class Packet(NamedTuple):
    payload: np.ndarray   # (8*payload_bytes,) bits
    crc_ok: bool
    stream_index: int     # packet index within the current sync epoch


@dataclasses.dataclass
class LinkCounters:
    frames: int = 0
    packets: int = 0
    crc_failures: int = 0
    resyncs: int = 0
    detected_offset_hz: float = 0.0
    synced: bool = False
    # blind M2M4 SNR estimate of the last demodulated bucket (dB,
    # metrics.snr_estimate_db) and the squelch/DCD verdict derived from it
    carrier_snr_db: float = float("nan")
    carrier_detect: bool = False


class StreamModulator:
    """Push-mode packet transmitter — the TX twin of ``StreamDemodulator``:

        mod = StreamModulator(ModemConfig(), PacketConfig(payload_bytes=30))
        for payloads in source:            # (npkts, 8*payload_bytes) bits
            audio_sink(mod.push(payloads)) # int16 PCM, filter-continuous

    The TX filter tail and NCO phase carry across calls (the cross-frame
    delay-line behavior of qpsk.c:36-37): chunked pushes match one
    ``tx_stream`` over the concatenated packets to within 1 int16 LSB
    (the carried unit phasor re-associates one extra complex multiply per
    call boundary; measured <0.1% of samples off by 1).

    A push of N packets modulates in power-of-two frame batches (greedy
    64, 32, ..., 1) — O(log N) dispatches from a bounded static-shape set,
    not one dispatch per packet (per-packet dispatch makes streaming TX
    dispatch-bound — the serialization anti-pattern the RX side's bucket
    batching exists to avoid).  ``tx_stream`` is filter-continuous
    across the frames of one call, so batching changes dispatch count
    only, not the waveform contract."""

    #: largest frames-per-dispatch batch (shapes compiled: 1, 2, ..., CAP)
    _BATCH_CAP = 64

    def __init__(self, cfg: ModemConfig, pcfg: PacketConfig,
                 tx_offset_hz: float = 0.0):
        self.cfg = cfg
        self.pcfg = pcfg
        self._state = tx_init(cfg)
        self._tx = jax.jit(functools.partial(
            tx_stream, cfg, tx_offset_hz=tx_offset_hz))
        # generic-family constellations: frame_bits need not divide
        # bits-per-symbol (8PSK), so channel bits carry in a pending
        # buffer and modulate in whole-symbol chunk rows; QPSK keeps the
        # exact per-packet row shape (frame_bits is always even)
        bps = cfg.bits_per_symbol
        self._aligned = pcfg.frame_bits % bps == 0
        self._chunk_bits = bps * ((pcfg.frame_bits + bps - 1) // bps)
        self._pend = np.zeros(0, np.int32)

    @classmethod
    def _pow2_batches(cls, n: int):
        """Greedy power-of-two batch sizes summing to n (largest first)."""
        while n > 0:
            k = cls._BATCH_CAP
            while k > n:
                k //= 2
            yield k
            n -= k

    def push(self, payload_bits) -> np.ndarray:
        """Modulate (npkts, 8*payload_bytes) (or a single flat packet of)
        payload bits; returns the int16 passband PCM.  For constellations
        whose bits/symbol does not divide the packet length, a sub-symbol
        bit remainder stays pending — call ``flush()`` at stream end."""
        p = np.asarray(payload_bits, np.int32)
        if p.ndim == 1:
            p = p[None, :]
        assert p.shape[-1] == 8 * self.pcfg.payload_bytes, p.shape
        # keep everything device-side inside the loop (one host download
        # at the end): per-iteration np.asarray would serialize every
        # dispatch on a host round trip
        chan = assemble_packet(self.pcfg, jnp.asarray(p))
        out = []
        if self._aligned:
            rows, rb = chan, self.pcfg.frame_bits
        else:
            self._pend = np.concatenate(
                [self._pend, np.asarray(chan).ravel()])
            cb = self._chunk_bits
            nrows = self._pend.size // cb
            rows = jnp.asarray(self._pend[:nrows * cb].reshape(nrows, cb))
            self._pend = self._pend[nrows * cb:]
            rb = cb
        i = 0
        for k in self._pow2_batches(rows.shape[0]):
            # one static (k, rb) shape per power-of-two batch size
            self._state, pcm = self._tx(self._state, rows[i:i + k])
            out.append(pcm.reshape(-1))
            i += k
        if not out:
            return np.zeros(0, np.int16)
        return np.asarray(jnp.concatenate(out))

    def save(self, path: str) -> None:
        """Checkpoint the transmitter: carried TX pytree state (filter
        tail, NCO phasor, differential phase) + pending sub-symbol bits.
        Resume with ``load`` on a StreamModulator built with the same
        cfg/pcfg/offset; the PCM stream continues filter-continuously."""
        import jax

        from qpsk_tpu.utils.checkpoint import savez_exact

        arrays = {"pend": self._pend}
        for i, leaf in enumerate(jax.tree.leaves(self._state)):
            arrays[f"tx_leaf_{i}"] = np.asarray(leaf)
        savez_exact(path, **arrays)

    def load(self, path: str) -> None:
        """Restore a checkpoint written by ``save``."""
        import jax

        data = np.load(path)
        self._pend = data["pend"].astype(np.int32)
        like = tx_init(self.cfg)
        leaves = [jnp.asarray(data[f"tx_leaf_{i}"])
                  for i in range(len(jax.tree.leaves(like)))]
        self._state = jax.tree.unflatten(jax.tree.structure(like), leaves)

    def flush(self) -> np.ndarray:
        """Modulate any pending sub-chunk bits, zero-padded to a whole
        symbol (filler after the last packet; the receiver just ignores
        it).  QPSK never buffers, so this is a no-op there."""
        if not self._pend.size:
            return np.zeros(0, np.int16)
        bps = self.cfg.bits_per_symbol
        pad = (-self._pend.size) % bps
        bits = np.concatenate([self._pend, np.zeros(pad, np.int32)])
        self._pend = self._pend[:0]
        self._state, pcm = self._tx(self._state, jnp.asarray(bits[None, :]))
        return np.asarray(pcm).reshape(-1)


@functools.lru_cache(maxsize=None)
def _rx_jits(cfg: ModemConfig):
    """(jitted rx_stream, jitted 2-candidate acquisition) for a config."""
    return (jax.jit(functools.partial(rx_stream, cfg)),
            jax.jit(functools.partial(rx_acquire_hz, cfg, candidates=2)))


class StreamDemodulator:
    """Push-mode packet receiver (see module docstring).

    Modulation-generic: the bit/LLR buffers hold PRE-ROTATED streams
    (n_rot, n) — each row the demod stream re-sliced under one carrier
    rotation hypothesis (``sync.rotated_streams``), computed per bucket
    while the stream head is still symbol-aligned.  Consumption then
    works at arbitrary bit offsets (generic constellations' frame_bits
    need not divide bits-per-symbol) without ever re-grouping symbols;
    for QPSK the rows are ``rotate_dibits`` relabelings and the behavior
    is identical to rotating at decode time (all consumption offsets are
    dibit-aligned)."""

    def __init__(self, cfg: ModemConfig, pcfg: PacketConfig,
                 sync_skip_frames: int = 2, probe_frames: int | None = None,
                 resync_after: int = 8, bucket_frames: int = 8,
                 slip_track: int = 1, squelch_db: float | None = None,
                 sweep_hz=None):
        self.cfg = cfg
        self.pcfg = pcfg
        # sync_skip default 2 (round 4, was 8): the post-onset transient
        # with FFT acquisition is < 2 packet frames, and the latency sweep
        # (tools/run_latency.py) showed skip=8 buys nothing at 10 dB while
        # DOUBLING cold start (0.90 s -> 0.45 s at bucket 8: the first
        # bucket now holds skip + a full probe window) and eating 6 more
        # packets per cold start.  The hunt is CRC-scored, so hunting over
        # transient bits costs work, never a false sync.
        self.sync_skip = sync_skip_frames * pcfg.frame_bits
        self._sync_skip0 = self.sync_skip
        # probe default: 8 frames for coded links, 4 uncoded.  Measured
        # (docs/sync_floor_coded.jsonl): the soft hunt's score over 4
        # probe packets is indistinguishable from noise right where the
        # coded link still decodes (PER ~0.85 at 3 dB); 8 probes move the
        # sync floor down ~1 dB to the decode floor, and once synced the
        # PER is identical — the extra probe only costs hunt width.
        if probe_frames is None:
            probe_frames = 8 if pcfg.fec else 4
        self.probe_frames = probe_frames
        self.resync_after = resync_after
        self.bucket_frames = bucket_frames
        # squelch / carrier detect (DCD): with ``squelch_db`` set, each
        # demodulated bucket updates a blind M2M4 SNR estimate
        # (metrics.snr_estimate_db — rotation-invariant, so it detects a
        # QPSK carrier *before* Costas lock) and the CRC-scored sync hunt
        # only runs while the estimate says a carrier is present (open at
        # squelch_db, close at squelch_db - 3 dB of hysteresis).  On dead
        # air the noise bits are discarded instead of hunted through —
        # every real modem's squelch, which the batch extractors don't
        # need but a 24/7 receiver does.  None = always hunt (the
        # pre-squelch behavior); the SNR estimate is recorded either way.
        self.squelch_db = squelch_db
        # slip_track > 0: per-drain hypotheses also span bit-lag shifts of
        # ±2*slip_track, so a SYMBOL slip (timing-phase wrap under clock
        # drift repeats/drops one symbol, shifting all later framing by
        # 2 bits) costs one packet instead of resync_after packets + a
        # full re-hunt.  The adopted shift folds into the buffer offset at
        # each span end (sync.extract_packets_tracked is the batch twin).
        self.slip_track = slip_track
        # modulation geometry: rotation-hypothesis count, bits/symbol,
        # and the sync hunt's lag stride (2 for QPSK's dibit grid)
        self._nrot, self._bps, self._lag_step = _mod_geometry(cfg.modulation)
        self._hw = self._bps * slip_track   # bit headroom at each end
        self.counters = LinkCounters()
        # Exactly TWO static rx_stream shapes ever compile, regardless of
        # the chunk sizes pushed: (bucket_frames, frame) for steady-state
        # draining and (1, frame) for the flush() remainder — jitting on
        # whatever nframes arrives would compile per chunk size.  The
        # jitted functions are shared by every demodulator of one config
        # (an FdmReceiver holds hundreds), so each shape traces once.
        self._rx_jit, self._acquire_jit = _rx_jits(cfg)
        # jitted acquisition: cold starts re-run it per bucket during
        # squelched dead air.
        # candidates=2: the M-power spectrum carries deterministic
        # symbol-rate-displaced spurs that can out-peak the carrier line
        # (ops/acquire.acquire_freq_candidates) — a single-estimate
        # receiver would re-acquire the SAME wrong peak forever; here the
        # hunt's failure to sync rotates to the next candidate.
        # sweep fallback (round 5): when BOTH FFT candidates reject, the
        # spectrum itself is compromised (a deterministic interferer on
        # the M-power line, or SNR below the acquisition floor) and
        # re-peaking it any number of times re-finds the same wrong
        # lines — so candidate rotation continues into a STATIC seed grid
        # spanning the band plan's offset range at sub-pull-in steps
        # (ops/acquire.sweep_candidates_hz).  The CRC hunt scores every
        # seed the same way it scores the FFT candidates.
        # ``sweep_hz``: an explicit seed grid (any iterable of Hz offsets;
        # empty disables the fallback), default the ±300 Hz grid at
        # sub-pull-in steps
        from qpsk_tpu.ops.acquire import sweep_candidates_hz
        self._sweep_hz = (sweep_candidates_hz() if sweep_hz is None
                          else np.asarray(sweep_hz, np.float32))
        self._acq_idx = 0    # which candidate the current epoch uses
        self._acq_bits = 0   # bits the hunt REJECTED on this candidate
        # buffer prefix demodulated under the PREVIOUS candidate after a
        # rotation: hunt rejections of those stale bits say nothing about
        # the NEW candidate, so they must not count toward _acq_bits —
        # otherwise >= 2 hunt windows of stale bits rotate the receiver
        # straight past the correct candidate before any bits demodulated
        # under it ever reach the hunt.
        self._acq_stale = 0
        # two rejected hunt windows per candidate before rotating
        self._acq_rotate_bits = 2 * default_max_lag(pcfg)

        self._pcm_buf = np.zeros(0, np.int16)
        self._bit_buf = np.zeros((self._nrot, 0), np.int32)
        # with FEC, a parallel LLR buffer (elementwise aligned with the bit
        # buffer) feeds soft-decision Viterbi — ~2 dB over hard-input.
        # Differential bits come from the turn-difference decode, so
        # per-bit LLRs of the absolute symbols don't apply there: FEC
        # falls back to hard-input Viterbi inside disassemble_packet.
        self._use_soft = pcfg.fec and not cfg.differential
        self._llr_buf = np.zeros((self._nrot, 0), np.float32)
        self._state = None
        self._sync: SyncResult | None = None
        self._rotation = 0
        self._consecutive_bad = 0
        self._pkt_index = 0
        # last bps*slip_track consumed bits per rotation row (negative-
        # shift hypotheses read back into them); zeros at an epoch start
        self._lead = np.zeros((self._nrot, self._hw), np.int32)
        self._lead_llr = np.zeros((self._nrot, self._hw), np.float32)

    # ------------------------------------------------------------------
    def push(self, pcm: np.ndarray) -> list[Packet]:
        """Feed int16 PCM of any length; returns packets decoded so far.
        Eager: buffering and demodulation happen even if the returned list
        is ignored.  Frames demodulate in fixed ``bucket_frames`` buckets
        (one static jit shape); a sub-bucket remainder stays buffered until
        more samples arrive or ``flush()``."""
        pcm = np.asarray(pcm, np.int16).ravel()
        self._pcm_buf = np.concatenate([self._pcm_buf, pcm])
        fsz = self.cfg.frame_size
        bucket = self.bucket_frames * fsz
        out: list[Packet] = []
        while self._pcm_buf.size >= bucket:
            out.extend(self._demod(
                self._pcm_buf[:bucket].reshape(self.bucket_frames, fsz)))
            self._pcm_buf = self._pcm_buf[bucket:]
        out.extend(self._drain())
        return out

    def _demod(self, chunk: np.ndarray) -> list[Packet]:
        """Run one fixed-shape rx_stream pass and buffer its bits/LLRs.

        Squelch is applied HERE, per bucket (not once per ``push`` in
        ``_drain``): a push carrying a burst followed by dead air must
        first hunt/drain the carrier-present buckets' bits before the
        squelched bucket's noise bits are dropped — gating the drop on the
        last bucket's carrier verdict alone would silently discard the
        decodable burst buffered ahead of it.  Returns any packets a
        pre-squelch drain emitted."""
        nframes = chunk.shape[0]
        if (self._sync is None and self._state is not None
                and self.cfg.acquisition == "fft"
                and self._acq_bits >= self._acq_rotate_bits):
            # a full hunt's worth of bits demodulated on this acquisition
            # candidate without a sync: the loop may be parked on an
            # M-power spur (a deterministic wrong peak that re-acquiring
            # the same way would pick again) — cold-restart THIS bucket on
            # the next candidate.  Buffered bits stay (they may hold a
            # late burst demodulated under a fine acquisition; garbage
            # slides out of the bounded hunt anyway).
            self._acq_idx += 1
            self._acq_bits = 0
            # everything buffered so far was demodulated under the OLD
            # candidate — rejections of it don't indict the new one
            self._acq_stale = self._bit_buf.shape[1]
            self._state = None
        if self._state is None:
            acq = 0.0
            if self.cfg.acquisition == "fft":
                try:
                    cands = np.asarray(
                        self._acquire_jit(jnp.asarray(chunk))).ravel()
                    i = self._acq_idx % (cands.size + self._sweep_hz.size)
                    est = (float(cands[i]) if i < cands.size
                           else float(self._sweep_hz[i - cands.size]))
                    acq = hz_to_costas_freq(est, self.cfg.rs)
                except ValueError:
                    pass  # chunk too short: cold-start, acquire later
            self._state = rx_init(self.cfg, acq_freq=acq)

        self._state, out = self._rx_jit(self._state, jnp.asarray(chunk))
        self.counters.frames += nframes
        self.counters.detected_offset_hz = float(np.mean(
            np.asarray(out.freq_hz)[-min(10, nframes):]))
        # blind M2M4 SNR on the host: the symbol block is tiny (~8 KB) so
        # one download beats ~8 eager device ops
        snr = snr_estimate_db_host(np.asarray(out.symbols.re).ravel(),
                                   np.asarray(out.symbols.im).ravel())
        self.counters.carrier_snr_db = snr
        if self.squelch_db is None:
            self.counters.carrier_detect = True
        elif self.counters.carrier_detect:
            self.counters.carrier_detect = snr >= self.squelch_db - 3.0
        else:
            self.counters.carrier_detect = snr >= self.squelch_db

        pkts: list[Packet] = []
        if self.squelch_db is not None and not self.counters.carrier_detect:
            # squelched: hunt/drain whatever bits are already buffered from
            # earlier buckets FIRST (a burst buffered ahead of this dead-air
            # bucket must decode; an established epoch must get the chance
            # to end through its own resync_after CRC-failure path) ...
            pkts = self._drain()
            if self._sync is None:
                # ... then, still un-synced, drop the noise (this bucket's
                # bits never enter the buffer), re-arm the post-onset
                # transient skip, and cold-restart the loop state so the
                # next bucket re-runs FFT acquisition — during long dead
                # air the Costas frequency register would otherwise
                # random-walk on noise beyond pull-in range.
                self._bit_buf = self._bit_buf[:, :0]
                self._llr_buf = self._llr_buf[:, :0]
                self.sync_skip = self._sync_skip0
                self._state = None
                self._acq_bits = 0
                self._acq_stale = 0
                self._acq_idx = 0   # fresh carrier: fresh candidate order
                return pkts
            # the drain established sync mid-flush: an ESTABLISHED sync is
            # never squelch-dropped — fall through and buffer this bucket's
            # bits; only resync_after CRC failures end the epoch.
        # buffer all rotation hypotheses of this bucket's bits/LLRs (the
        # bucket is whole symbols, so relabeling here is always aligned)
        self._bit_buf = np.concatenate(
            [self._bit_buf,
             np.asarray(rotated_streams(out.bits.ravel(),
                                        self.cfg.modulation))], axis=1)
        if self._use_soft:
            sym = CF32(out.symbols.re.reshape(-1), out.symbols.im.reshape(-1))
            if self.cfg.modulation == "qpsk":
                llrs = demod_soft(sym)
                lstreams = jnp.stack([rotate_soft(llrs, r) for r in range(4)])
            else:
                from qpsk_tpu.ops import modfam
                scores = modfam.symbol_scores(
                    sym, modfam.get(self.cfg.modulation),
                    scale=self.cfg.agc_target)
                lstreams = rotated_streams(None, self.cfg.modulation,
                                           soft=scores)
            self._llr_buf = np.concatenate(
                [self._llr_buf, np.asarray(lstreams)], axis=1)
        return pkts

    # ------------------------------------------------------------------
    def _try_sync(self) -> bool:
        fb = self.pcfg.frame_bits
        window = default_max_lag(self.pcfg)
        probe_bits = self.probe_frames * fb + 64
        while True:
            if self._bit_buf.shape[1] - self.sync_skip < probe_bits:
                return False
            # soft hunt when the LLR rows exist: the hard-input hunt is
            # what limits a coded link's acquisition SNR (find_sync_streams)
            if self._use_soft:
                streams = jnp.asarray(self._llr_buf[:, self.sync_skip:])
            else:
                streams = jnp.asarray(self._bit_buf[:, self.sync_skip:])
            sync = find_sync_streams(self.pcfg, streams, max_lag=window,
                                     probe_frames=self.probe_frames,
                                     lag_step=self._lag_step,
                                     soft=self._use_soft)
            # acceptance threshold: a CRC-scored hypothesis with 3 hits is
            # already collision-proof (~2^-48 false rate); demanding
            # probe-1 hits with the longer coded probe (8) would require
            # 7/8 packet successes — unreachable exactly at the low-SNR
            # points the longer probe exists to acquire
            if int(sync.score) >= max(2, min(self.probe_frames - 1, 3)):
                # consume everything before the first aligned packet
                cut = self.sync_skip + int(sync.bit_lag)
                self._bit_buf = self._bit_buf[:, cut:]
                if self._use_soft:
                    self._llr_buf = self._llr_buf[:, cut:]
                self._sync = sync
                self._rotation = int(sync.rotation)
                self.counters.synced = True
                self.sync_skip = 0  # future resyncs hunt from the head
                self._acq_bits = 0  # this candidate acquired the carrier
                self._acq_stale = 0
                self._pkt_index = 0  # stream_index restarts per sync epoch
                # fresh epoch: the lead window's continuity is gone
                self._lead = np.zeros((self._nrot, self._hw), np.int32)
                self._lead_llr = np.zeros((self._nrot, self._hw), np.float32)
                return True
            # no sync in [sync_skip, sync_skip + window): those bits are
            # dead — slide the hunt forward if more stream remains, and
            # trim the dead prefix so the buffer stays bounded
            if self._bit_buf.shape[1] - self.sync_skip > probe_bits + window:
                cut = self.sync_skip + window
                self._bit_buf = self._bit_buf[:, cut:]
                if self._use_soft:
                    self._llr_buf = self._llr_buf[:, cut:]
                # rejected bits are evidence against the current
                # acquisition candidate (see _demod's rotation) — but only
                # the bits demodulated AFTER the last rotation; the stale
                # prefix [0, _acq_stale) came from the previous candidate
                stale_overlap = max(0, min(cut, self._acq_stale)
                                    - self.sync_skip)
                self._acq_bits += window - stale_overlap
                self._acq_stale = max(0, self._acq_stale - cut)
                self.sync_skip = 0
                continue
            return False

    def _drain(self) -> list[Packet]:
        fb = self.pcfg.frame_bits
        st = self.slip_track
        hw = self._hw                   # bit headroom at each end
        shifts = np.arange(-hw, hw + 1, self._bps, dtype=np.int64)
        out: list[Packet] = []
        while True:
            # NOTE: squelch drops happen per bucket in _demod (before this
            # buffer ever sees dead-air bits); anything buffered here came
            # from carrier-present buckets (or an established epoch) and is
            # always hunted/drained.
            if self._sync is None and not self._try_sync():
                return out
            nf = self._bit_buf.shape[1] // fb
            if nf <= 0:
                return out
            # hypothesis spans at every bit-lag shift: the lead window
            # serves the negative shifts, zero right-padding the positive
            # ones (a +shift hypothesis on the final packet reads padding
            # and just fails CRC); nothing is consumed until the walk
            # below decides how far the track actually advanced.  The
            # buffers already hold every rotation row, so one batched pass
            # covers all frames x n_rot rotations x shifts.
            ext = np.concatenate(
                [self._lead, self._bit_buf,
                 np.zeros((self._nrot, hw), np.int32)], axis=1)
            if self._use_soft:
                ext_l = np.concatenate(
                    [self._lead_llr, self._llr_buf,
                     np.zeros((self._nrot, hw), np.float32)], axis=1)
                spans_l = np.stack(
                    [ext_l[:, hw + s: hw + s + nf * fb] for s in shifts],
                    axis=1)                          # (R, S, nf*fb)
                cand = jnp.asarray(spans_l.reshape(
                    self._nrot, len(shifts), nf, fb))
                rx = disassemble_packet_soft(self.pcfg, cand)
            else:
                spans = np.stack(
                    [ext[:, hw + s: hw + s + nf * fb] for s in shifts],
                    axis=1)                          # (R, S, nf*fb)
                cand = jnp.asarray(spans.reshape(
                    self._nrot, len(shifts), nf, fb))
                rx = disassemble_packet(self.pcfg, cand)
            ok = np.asarray(rx.crc_ok)               # (R, S, nf)
            payloads = np.asarray(rx.payload_bits)   # (4, S, nf, bits)
            cur_si = st                              # grid index of shift 0
            stop_j = None
            for j in range(nf):
                # shared per-packet (rotation x shift) walk — one policy for
                # the streaming and batch extractors (sync.walk_step)
                good, r, si = walk_step(ok[:, :, j], shifts,
                                        self._rotation, cur_si,
                                        max_step=self._bps)
                if good:
                    self._rotation, cur_si = r, si
                    self._consecutive_bad = 0
                else:
                    self.counters.crc_failures += 1
                    self._consecutive_bad += 1
                out.append(Packet(payloads[r, si, j], good, self._pkt_index))
                self._pkt_index += 1
                self.counters.packets += 1
                if self._consecutive_bad >= self.resync_after:
                    stop_j = j
                    break
            # consume through the last emitted packet, folding the adopted
            # shift into the buffer offset, and refresh the lead window.
            # A +shift on the very last bits would consume past the buffer:
            # cap it — the walk simply re-adopts the shift from the next
            # span's hypotheses (one extra CRC miss, no packet lost).
            last = nf if stop_j is None else stop_j + 1
            consumed = min(last * fb + int(shifts[cur_si]),
                           self._bit_buf.shape[1])
            self._lead = ext[:, consumed: consumed + hw].astype(np.int32)
            self._bit_buf = self._bit_buf[:, consumed:]
            if self._use_soft:
                self._lead_llr = ext_l[:, consumed: consumed + hw].astype(
                    np.float32)
                self._llr_buf = self._llr_buf[:, consumed:]
            if stop_j is None:
                return out
            # lost the channel: drop sync and re-arm (SURVEY.md §5); the
            # unconsumed remainder stays buffered for the re-hunt
            self._sync = None
            self.counters.synced = False
            self.counters.resyncs += 1
            self._consecutive_bad = 0

    def flush(self) -> list[Packet]:
        """Demodulate any buffered whole frames (the sub-bucket remainder,
        one frame per pass — the second and last static shape), then decode
        whatever whole packets remain."""
        fsz = self.cfg.frame_size
        out: list[Packet] = []
        while self._pcm_buf.size >= fsz:
            out.extend(self._demod(self._pcm_buf[:fsz].reshape(1, fsz)))
            self._pcm_buf = self._pcm_buf[fsz:]
        out.extend(self._drain())
        return out

    # ------------------------------------------------------------------
    # checkpoint / resume (SURVEY.md §5 A4, the 24/7-receiver half): the
    # modem pytree state was always serializable (utils/checkpoint); this
    # captures the RECEIVER around it — sample/bit/LLR buffers, the sync
    # epoch, the slip-track lead window, counters — so a long-running
    # process can restart mid-stream without re-acquiring.

    def save(self, path: str) -> None:
        """Serialize the full receiver state to a dependency-free .npz.
        Resume with ``load`` on a StreamDemodulator built with the SAME
        cfg/pcfg/knobs; the next ``push`` continues the stream exactly
        where this one stopped (same packets, same counters)."""
        import dataclasses as _dc

        import jax

        arrays = {
            "pcm_buf": self._pcm_buf, "bit_buf": self._bit_buf,
            "llr_buf": self._llr_buf, "lead": self._lead,
            "lead_llr": self._lead_llr,
            "scalars": np.asarray([
                self.sync_skip, self._rotation, self._consecutive_bad,
                self._pkt_index, 1 if self._sync is not None else 0,
                0 if self._sync is None else int(self._sync.rotation),
                0 if self._sync is None else int(self._sync.bit_lag),
                0 if self._sync is None else int(self._sync.score),
                1 if self._state is not None else 0,
                # acquisition-candidate epoch: a receiver saved while
                # hunting on the spur-fallback candidate must resume on
                # it, not re-park on the deterministic spur candidate 0
                self._acq_idx, self._acq_bits, self._acq_stale,
            ], np.int64),
            "counters": np.asarray(
                [float(v) for v in _dc.astuple(self.counters)], np.float64),
        }
        if self._state is not None:
            for i, leaf in enumerate(jax.tree.leaves(self._state)):
                arrays[f"rx_leaf_{i}"] = np.asarray(leaf)
        from qpsk_tpu.utils.checkpoint import savez_exact
        savez_exact(path, **arrays)

    def load(self, path: str) -> None:
        """Restore a receiver checkpoint written by ``save`` (onto a
        demodulator constructed with the same cfg/pcfg/knobs)."""
        import dataclasses as _dc

        import jax

        from qpsk_tpu.state import rx_init

        data = np.load(path)
        self._pcm_buf = data["pcm_buf"].astype(np.int16)
        self._bit_buf = data["bit_buf"].astype(np.int32)
        self._llr_buf = data["llr_buf"].astype(np.float32)
        self._lead = data["lead"].astype(np.int32)
        self._lead_llr = data["lead_llr"].astype(np.float32)
        s = data["scalars"]
        self.sync_skip = int(s[0])
        self._rotation = int(s[1])
        self._consecutive_bad = int(s[2])
        self._pkt_index = int(s[3])
        self._sync = (SyncResult(jnp.int32(s[5]), jnp.int32(s[6]),
                                 jnp.int32(s[7])) if s[4] else None)
        if s.size > 9:   # r5+ checkpoints carry the acquisition epoch
            self._acq_idx = int(s[9])
            self._acq_bits = int(s[10])
            self._acq_stale = int(s[11])
        fields = [f.name for f in _dc.fields(LinkCounters)]
        vals = data["counters"]
        for name, v in zip(fields, vals):
            cur = getattr(self.counters, name)
            setattr(self.counters, name,
                    bool(v > 0.5) if isinstance(cur, bool)
                    else type(cur)(float(v)))
        if s[8]:
            like = rx_init(self.cfg)
            leaves = [jnp.asarray(data[f"rx_leaf_{i}"])
                      for i in range(len(jax.tree.leaves(like)))]
            self._state = jax.tree.unflatten(
                jax.tree.structure(like), leaves)
        else:
            self._state = None

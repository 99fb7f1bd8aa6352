"""FDM multi-carrier: many QPSK subchannels in one wideband PCM stream.

Capability extension (the reference is strictly single-carrier: one 2400
baud signal on one 1500 Hz carrier, qpsk.h:16-18).  This module
frequency-division-multiplexes ``nchan`` *independent, unmodified* modem
channels — each the standard real 9600 S/s passband signal ``tx_stream``
emits — into one real wideband stream at ``nslots * fs`` samples/s, and
splits it back.  The per-channel modem (sync, Costas, packets, FEC) is
untouched: the batched RX processes all subchannels as its ordinary
channel axis, the axis the device batches and the mesh shards.

Design — a critically-sampled polyphase-DFT filterbank in
which every stage is a matmul or a static-shift FIR (no gathers, no
complex dtypes, no per-sample loops):

* **Band plan.**  Slot ``c`` of an ``N = nslots`` bank sits at
  ``c * fs`` Hz of the wideband rate ``N * fs``; a real subchannel
  occupies its slot plus the conjugate mirror, so the usable channels are
  slots ``1 .. N/2 - 1`` (the DC and Nyquist slots are unusable for real
  passband FDM).  Each modem signal occupies ~3.24 kHz of its 9.6 kHz
  slot, the same occupancy the single-carrier reference has.
* **Synthesis** (``fdm_mux``): because the slot carrier
  ``cos(2*pi*c*n/N)`` depends only on ``n mod N``, modulate-then-sum
  collapses to ONE cosine-matrix matmul across channels
  ``t[m, r] = sum_c x_c[m] cos(2*pi*c*(r)/N)`` followed by the polyphase
  interpolation FIR of a shared Kaiser prototype (per-phase static
  shifted-slice MACs, the ``rrc.fir_block`` idiom) — the N-times-rate
  zero-stuffed signal never exists.
* **Analysis** (``fdm_demux``): the dual — polyphase branch FIRs over the
  phase-reversed wideband blocks, then one DFT-cosine matmul produces
  every slot's mixed-down, lowpassed, N-decimated output at once.  For a
  real input the full complex mix ``e^{-j w_c n}`` + lowpass + decimate
  leaves ``x_c / 2`` in the real part (the ``e^{-2j w_c n}`` image lands
  out of band), so one real matmul suffices and a factor 2 restores unit
  gain.
* **Streaming**: both directions carry their FIR branch history
  explicitly (``FdmState``), so chunked calls chain with one-shot calls
  the same way the modem FIR and the rational resampler do.

The prototype filters are the rational-resampler designs
(``ops.resample.resampler_taps``): analysis = the 1/N decimator
prototype, synthesis = the N/1 interpolator prototype (gain N), both cut
at the slot Nyquist ``fs/2``.

Headroom: ``fdm_mux`` scales the sum by ``1/nchan`` so the int16 wideband
cannot clip regardless of channel phase alignment; ``fdm_demux`` undoes
it.  A real deployment would replace this with per-channel power control.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from qpsk_tpu.ops.resample import resampler_taps


@dataclasses.dataclass(frozen=True)
class FdmConfig:
    """Band plan for an ``nslots``-slot DFT bank over slot width ``fs``."""
    nslots: int = 8
    fs: float = 9600.0
    taps_per_branch: int = 16
    beta: float = 8.0

    def __post_init__(self):
        if self.nslots < 4 or self.nslots % 2:
            raise ValueError("nslots must be even and >= 4")

    @property
    def nchan(self) -> int:
        """Usable subchannels (slots 1 .. nslots/2 - 1)."""
        return self.nslots // 2 - 1

    @property
    def wide_fs(self) -> float:
        return self.nslots * self.fs

    def slot_center_hz(self, chan: int, modem_center: float) -> float:
        """Absolute carrier frequency of channel ``chan`` (0-based) in the
        wideband spectrum (its slot offset plus the modem's own carrier)."""
        return (chan + 1) * self.fs + modem_center


class FdmState(NamedTuple):
    """Carried streaming state (a pytree — jit/scan-friendly): ``hist`` =
    (Q-1, N) rows of branch-FIR input history (both directions); ``tail``
    = the previous chunk's last N-1 wideband samples (demux only — the
    phase-reversed blocks straddle chunk boundaries by N-1 samples)."""
    hist: jnp.ndarray
    tail: jnp.ndarray


@functools.lru_cache(maxsize=None)
def _bank(nslots: int, taps_per_branch: int, beta: float):
    """(g2, h2, wc_syn, wc_ana): synthesis/analysis polyphase taps (Q, N)
    and the cosine matrices for the channel<->phase matmuls."""
    n = nslots
    g = resampler_taps(n, 1, taps_per_branch, beta)   # interp proto, sum=N
    h = resampler_taps(1, n, taps_per_branch, beta)   # decim proto, sum=1
    q = len(g) // n
    g2 = g.reshape(q, n).astype(np.float32)           # g[q*N + r]
    h2 = h.reshape(q, n).astype(np.float32)           # h[q*N + p]
    c = np.arange(n)
    # synthesis: t[m, r] = sum_c x_c[m] cos(2*pi*(c+1)*r / N)  (slot c+1)
    r = np.arange(n)
    usable = np.arange(1, n // 2)                     # slots 1..N/2-1
    wc_syn = np.cos(2.0 * np.pi * np.outer(usable, r) / n).astype(np.float32)
    # analysis: y_c[m] = sum_p u[m, p] cos(2*pi*(c+1)*p / N)
    wc_ana = np.cos(2.0 * np.pi * np.outer(r, usable) / n).astype(np.float32)
    return g2, h2, wc_syn, wc_ana


def fdm_init(fcfg: FdmConfig) -> FdmState:
    """Zero history (silence before the stream), either direction."""
    q = fdm_taps_per_branch(fcfg)
    return FdmState(hist=jnp.zeros((q - 1, fcfg.nslots), jnp.float32),
                    tail=jnp.zeros((fcfg.nslots - 1,), jnp.float32))


def fdm_taps_per_branch(fcfg: FdmConfig) -> int:
    g2, _, _, _ = _bank(fcfg.nslots, fcfg.taps_per_branch, fcfg.beta)
    return g2.shape[0]


def _branch_fir(v: jnp.ndarray, taps: np.ndarray,
                state: FdmState) -> tuple[jnp.ndarray, FdmState]:
    """Per-phase FIR over the block axis: (M, N) blocks x (Q, N) taps ->
    (M, N), with carried (Q-1, N) history.  Static shifted slices — the
    split-matmul idiom, no gathers."""
    q = taps.shape[0]
    vv = jnp.concatenate([state.hist, v], axis=0)        # (M+Q-1, N)
    m = v.shape[0]
    out = jnp.zeros_like(v)
    for k in range(q):
        # u[m] += taps[k] * vv[m + (Q-1) - k]
        out = out + jnp.asarray(taps[k]) * vv[q - 1 - k: q - 1 - k + m]
    return out, state._replace(hist=vv[-(q - 1):])


def fdm_mux_stream(fcfg: FdmConfig, pcm: jnp.ndarray, state: FdmState):
    """Multiplex (nchan, M) int16 subchannel PCM into (M * nslots,) int16
    wideband PCM.  Chunked calls chain with one-shot via ``state``."""
    g2, _, wc_syn, _ = _bank(fcfg.nslots, fcfg.taps_per_branch, fcfg.beta)
    x = pcm.astype(jnp.float32)
    assert x.shape[0] == fcfg.nchan, (x.shape, fcfg.nchan)
    # channel -> phase matmul: t (M, N)
    t = jnp.matmul(x.T, jnp.asarray(wc_syn),
                   preferred_element_type=jnp.float32)
    t = t / jnp.float32(fcfg.nchan)                      # clip headroom
    y, state = _branch_fir(t, g2, state)                 # (M, N)
    wide = y.reshape(-1)
    return (jnp.clip(jnp.round(wide), -32768, 32767).astype(jnp.int16),
            state)


def fdm_demux_stream(fcfg: FdmConfig, wide: jnp.ndarray, state: FdmState):
    """Split (M * nslots,) int16 wideband PCM back into (nchan, M) int16
    subchannel PCM (each the standard modem-rate passband signal)."""
    _, h2, _, wc_ana = _bank(fcfg.nslots, fcfg.taps_per_branch, fcfg.beta)
    n = fcfg.nslots
    w = wide.astype(jnp.float32)
    assert w.shape[-1] % n == 0, (w.shape, n)
    mtot = w.shape[-1] // n
    # z[m*N + (N-1-p)] = x[m*N - p]: the previous chunk's last N-1
    # samples in front (zeros at stream start), then phase-reverse the
    # lanes
    z = jnp.concatenate([state.tail, w])
    state = state._replace(tail=z[-(n - 1):])
    v = z[: mtot * n].reshape(mtot, n)[:, ::-1]          # (M, N)
    u, state = _branch_fir(v, h2, state)
    y = jnp.matmul(u, jnp.asarray(wc_ana),
                   preferred_element_type=jnp.float32)   # (M, nchan)
    # x2: real-part of the complex mix leaves x_c/2; x nchan: undo the mux
    # headroom backoff
    y = y * jnp.float32(2.0 * fcfg.nchan)
    return (jnp.clip(jnp.round(y.T), -32768, 32767).astype(jnp.int16),
            state)


class FdmReceiver:
    """Push-mode wideband receiver: ``fdm_demux_stream`` feeding one
    ``StreamDemodulator`` per subchannel.

        rx = FdmReceiver(FdmConfig(nslots=8), ModemConfig(), pcfg)
        for chunk in wideband_source:        # int16, any chunk size
            for chan, pkts in enumerate(rx.push(chunk)):
                ...

    Wideband samples buffer to a fixed bucket (one static jit shape for
    the demux matmuls — the same shape-bucketing discipline as
    ``StreamDemodulator.push``); each bucket demuxes once and pushes every
    subchannel's PCM into its demodulator.
    """

    def __init__(self, fcfg: FdmConfig, cfg, pcfg,
                 bucket_blocks: int = 4096, **demod_kwargs):
        import jax

        from qpsk_tpu.runtime import StreamDemodulator

        self.fcfg = fcfg
        self._state = fdm_init(fcfg)
        self.demods = [StreamDemodulator(cfg, pcfg, **demod_kwargs)
                       for _ in range(fcfg.nchan)]
        self._bucket = bucket_blocks * fcfg.nslots
        self._buf = np.zeros(0, np.int16)
        self._demux = jax.jit(functools.partial(fdm_demux_stream, fcfg))

    def push(self, wide) -> list[list]:
        """Feed wideband int16 PCM; returns per-channel packet lists."""
        wide = np.asarray(wide, np.int16).ravel()
        self._buf = np.concatenate([self._buf, wide])
        out = [[] for _ in range(self.fcfg.nchan)]
        while self._buf.size >= self._bucket:
            pcm, self._state = self._demux(
                jnp.asarray(self._buf[:self._bucket]), self._state)
            self._buf = self._buf[self._bucket:]
            pcm = np.asarray(pcm)
            for c, d in enumerate(self.demods):
                out[c].extend(d.push(pcm[c]))
        return out

    def flush(self) -> list[list]:
        """Demux the buffered remainder (zero-padded to one bucket) and
        flush every subchannel demodulator."""
        out = [[] for _ in range(self.fcfg.nchan)]
        if self._buf.size:
            pad = np.zeros(self._bucket - self._buf.size, np.int16)
            pcm, self._state = self._demux(
                jnp.asarray(np.concatenate([self._buf, pad])), self._state)
            self._buf = np.zeros(0, np.int16)
            pcm = np.asarray(pcm)
            for c, d in enumerate(self.demods):
                out[c].extend(d.push(pcm[c]))
        for c, d in enumerate(self.demods):
            out[c].extend(d.flush())
        return out

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint the wideband receiver: the filterbank state, the
        wideband sample buffer, and every subchannel demodulator
        (StreamDemodulator.save) — one .npz; resume with ``load`` on an
        FdmReceiver built with the same configs."""
        import io

        import jax

        arrays = {"wide_buf": self._buf}
        for i, leaf in enumerate(jax.tree.leaves(self._state)):
            arrays[f"fb_leaf_{i}"] = np.asarray(leaf)
        for c, d in enumerate(self.demods):
            buf = io.BytesIO()
            d.save(buf)
            arrays[f"chan_{c}"] = np.frombuffer(buf.getvalue(), np.uint8)
        from qpsk_tpu.utils.checkpoint import savez_exact
        savez_exact(path, **arrays)

    def load(self, path: str) -> None:
        """Restore a checkpoint written by ``save``."""
        import io

        import jax

        data = np.load(path)
        self._buf = data["wide_buf"].astype(np.int16)
        like = fdm_init(self.fcfg)
        leaves = [jnp.asarray(data[f"fb_leaf_{i}"])
                  for i in range(len(jax.tree.leaves(like)))]
        self._state = jax.tree.unflatten(jax.tree.structure(like), leaves)
        for c, d in enumerate(self.demods):
            d.load(io.BytesIO(data[f"chan_{c}"].tobytes()))


def fdm_mux(fcfg: FdmConfig, pcm: jnp.ndarray) -> jnp.ndarray:
    """One-shot ``fdm_mux_stream`` from silence."""
    wide, _ = fdm_mux_stream(fcfg, pcm, fdm_init(fcfg))
    return wide


def fdm_demux(fcfg: FdmConfig, wide: jnp.ndarray) -> jnp.ndarray:
    """One-shot ``fdm_demux_stream`` from silence."""
    pcm, _ = fdm_demux_stream(fcfg, wide, fdm_init(fcfg))
    return pcm


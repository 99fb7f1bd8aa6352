"""The staged TX chain (``tx_stream``: zero-stuff -> one block RRC FIR ->
one carrier mix -> int16) against the per-frame ``tx_frame`` chain that
mirrors the C loop, and its carried-state contract."""

import jax.numpy as jnp
import numpy as np
import pytest

from qpsk_tpu import ModemConfig, tx_init
from qpsk_tpu.config import config_1200
from qpsk_tpu.modem import tx_bits_frame, tx_frame, tx_stream
from qpsk_tpu.ops import modmap


def _bits(c, nframes, nsym, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 2, (c, nframes, 2 * nsym),
                                    dtype=np.int32))


def _assert_pcm_close(a, b, lsb=2):
    """The stream's one long FIR and the frame chain's per-frame FIRs sum
    in different orders: int16 PCM may differ by a couple of LSB at
    +-16384 full scale."""
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert d.max() <= lsb, f"PCM differs by up to {d.max()} LSB"


@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("base", ["2400", "1200"])
def test_tx_stream_matches_frame_chain(base, c):
    cfg = ModemConfig() if base == "2400" else config_1200()
    nframes, nsym = 4, cfg.symbols_per_frame
    bits = _bits(c, nframes, nsym, seed=c)
    st = tx_init(cfg, batch_shape=(c,))
    st_s, pcm_s = tx_stream(cfg, st, bits, tx_offset_hz=50.0)
    frames = []
    st_f = st
    for f in range(nframes):
        st_f, p = tx_frame(cfg, st_f, modmap.bits_to_symbols(bits[:, f]),
                           tx_offset_hz=50.0)
        frames.append(np.asarray(p))
    assert pcm_s.shape == (c, nframes, cfg.frame_size)
    _assert_pcm_close(pcm_s, np.stack(frames, axis=1))
    np.testing.assert_allclose(np.asarray(st_s.nco_phase.re),
                               np.asarray(st_f.nco_phase.re), atol=1e-4)
    np.testing.assert_allclose(np.asarray(st_s.fir_tail.re),
                               np.asarray(st_f.fir_tail.re), atol=1e-6)


@pytest.mark.parametrize("base", ["2400", "1200"])
def test_tx_stream_chains_across_calls(base):
    """Two chained tx_stream calls == one call over the concatenation."""
    cfg = ModemConfig() if base == "2400" else config_1200()
    c, nsym = 8, cfg.symbols_per_frame
    bits = _bits(c, 4, nsym, seed=3)
    st = tx_init(cfg, batch_shape=(c,))
    st1, p1 = tx_stream(cfg, st, bits[:, :2], tx_offset_hz=50.0)
    _, p2 = tx_stream(cfg, st1, bits[:, 2:], tx_offset_hz=50.0)
    _, p = tx_stream(cfg, st, bits, tx_offset_hz=50.0)
    _assert_pcm_close(np.concatenate([np.asarray(p1), np.asarray(p2)], 1),
                      p, lsb=3)


def test_tx_stream_generic_family_and_differential():
    """The family mappers and DQPSK ride the same staged chain: PCM
    equals the frame chain of their symbols."""
    for cfg in (ModemConfig(modulation="8psk"),
                ModemConfig(differential=True)):
        c, nframes = 2, 3
        rng = np.random.default_rng(4)
        bits = jnp.asarray(rng.integers(0, 2, (c, nframes,
                                               cfg.bits_per_frame),
                                        dtype=np.int32))
        st = tx_init(cfg, batch_shape=(c,))
        _, pcm = tx_stream(cfg, st, bits, tx_offset_hz=20.0)
        st_f, frames = st, []
        for f in range(nframes):
            st_f, p = tx_bits_frame(cfg, st_f, bits[:, f], tx_offset_hz=20.0)
            frames.append(np.asarray(p))
        _assert_pcm_close(pcm, np.stack(frames, axis=1))

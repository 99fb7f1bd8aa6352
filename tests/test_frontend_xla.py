"""The staged XLA front-end (``modem.frontend_xla``: modulated-taps
matched filter -> power-timing decimation -> pick phasor) against two
independent oracles: the classic full-rate-mix staging, and the per-frame
``rx_frame`` chain that mirrors the C loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qpsk_tpu import ModemConfig, rx_init
from qpsk_tpu.config import config_1200
from qpsk_tpu.modem import (_pick_block, _tmat_for, frontend_xla, rx_frame,
                            rx_stream)
from qpsk_tpu.ops import nco, rrc as rrc_ops, timing as timing_ops
from qpsk_tpu.ops.cplx import CF32


def _pcm(cfg, c, nframes, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(-12000, 12000,
                                    (c, nframes, cfg.frame_size),
                                    dtype=np.int16))


def _mix_staged_frontend(cfg, pcm, nco_phase, fir_tail):
    """The classic full-rate-mix staging (mix -> real-tap FIR -> timing),
    kept as an independent numerical oracle for the mix-free lowerings."""
    c, nframes, fsz = pcm.shape
    n = nframes * fsz
    flat = pcm.reshape(c, n).astype(jnp.float32) / jnp.float32(cfg.pcm_scale)
    x = CF32(flat, jnp.zeros_like(flat))
    x, phase = nco.mix(x, nco_phase, -cfg.omega_center, "fast")
    block = _pick_block(fsz)
    tmat = jnp.asarray(_tmat_for(cfg, block))
    x, tail = rrc_ops.fir_block(x, fir_tail, tmat, cfg.gain, block,
                                precision=jax.lax.Precision.DEFAULT)
    frames = CF32(x.re.reshape(c, nframes, fsz),
                  x.im.reshape(c, nframes, fsz))
    picks, index = timing_ops.estimate_and_decimate(frames, cfg.cycles,
                                                    "power")
    return picks, index, phase, tail


def test_frontend_xla_matches_mix_staging():
    """The mix-free staged chain (modulated taps + pick phasor) equals the
    classic mix-then-filter staging: same timing picks, same symbols (to
    f32 reassociation), same carried state."""
    cfg = ModemConfig()
    c, nframes = 8, 4
    pcm = _pcm(cfg, c, nframes, seed=11)
    st = rx_init(cfg, batch_shape=(c,))
    m_picks, m_idx, m_ph, m_tail = _mix_staged_frontend(
        cfg, pcm, st.nco_phase, st.fir_tail)
    u_picks, u_idx, u_ph, u_tail = frontend_xla(
        cfg, pcm, st.nco_phase, st.fir_tail)
    np.testing.assert_array_equal(np.asarray(u_idx), np.asarray(m_idx))
    np.testing.assert_allclose(np.asarray(u_picks.re),
                               np.asarray(m_picks.re), atol=2e-4)
    np.testing.assert_allclose(np.asarray(u_picks.im),
                               np.asarray(m_picks.im), atol=2e-4)
    np.testing.assert_allclose(np.asarray(u_ph.re), np.asarray(m_ph.re),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(u_tail.re), np.asarray(m_tail.re),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(u_tail.im), np.asarray(m_tail.im),
                               atol=2e-4)


@pytest.mark.parametrize("c,base,agc", [
    (1, "2400", False), (3, "2400", True), (128, "2400", False),
    (1, "1200", True), (3, "1200", False), (128, "1200", True)])
def test_rx_stream_matches_frame_chain(c, base, agc):
    """rx_stream over frontend_xla (one FIR over the stream, batched
    timing) == rx_frame scanned frame by frame like the C loop: same
    timing picks, same bits, readback and symbols to f32 reassociation."""
    cfg = dataclasses.replace(
        ModemConfig() if base == "2400" else config_1200(), agc=agc)
    nframes = 4
    pcm = _pcm(cfg, c, nframes, seed=c)
    st0 = rx_init(cfg, batch_shape=(c,))
    st_s, out_s = jax.jit(lambda s, x: rx_stream(cfg, s, x))(st0, pcm)

    def step(st, frame):
        return rx_frame(cfg, st, frame)

    st_f, out_f = jax.jit(lambda s, x: jax.lax.scan(
        step, s, jnp.moveaxis(x, 1, 0)))(st0, pcm)
    np.testing.assert_array_equal(np.asarray(out_s.timing_index),
                                  np.asarray(out_f.timing_index).T)
    np.testing.assert_array_equal(np.asarray(out_s.bits),
                                  np.moveaxis(np.asarray(out_f.bits), 0, 1))
    np.testing.assert_allclose(
        np.asarray(out_s.symbols.re),
        np.moveaxis(np.asarray(out_f.symbols.re), 0, 1), atol=2e-3)
    np.testing.assert_allclose(np.asarray(out_s.freq_hz),
                               np.asarray(out_f.freq_hz).T, atol=0.05)
    np.testing.assert_allclose(np.asarray(st_s.costas.phase),
                               np.asarray(st_f.costas.phase), atol=2e-3)

"""The kernel's time-major entry and the RX stream through it: the fused
Costas kernel reads (T, C) planes, writes the frequency trace at frame
rate, and leaves slicing to XLA.  Interpret mode on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from qpsk_tpu import ModemConfig, rx_init
from qpsk_tpu.ops.costas import costas_init, costas_params, gear_for
from qpsk_tpu.ops.cplx import CF32
from qpsk_tpu.ops.pallas.costas_kernel import costas_run_pallas, costas_run_tm

CFG = ModemConfig()


def test_costas_trace_every_matches_per_symbol():
    """trace_every returns exactly the frame-boundary values of the
    per-symbol trace, and derot/state are bit-identical between the two
    trace modes (the trace changes stores, not arithmetic) — plain and
    gear-shift loops; T = 640 = 5 x 128 is not a power of two."""
    c, nsf = 40, 128
    rng = np.random.default_rng(4)
    params = costas_params(loop_bw=2.0 * np.pi / 100.0)
    for t, gear in ((512, None), (640, None),
                    (512, gear_for(2.0 * np.pi / 200.0, np.sqrt(0.5)))):
        zr = jnp.asarray(rng.normal(size=(t, c)), jnp.float32)
        zi = jnp.asarray(rng.normal(size=(t, c)), jnp.float32)
        st = costas_init(batch_shape=(c,), gear=gear is not None)
        s_a, d_a, tr_a = costas_run_tm(st, zr, zi, params, gear=gear,
                                       interpret=True)
        s_b, d_b, tr_b = costas_run_tm(st, zr, zi, params, gear=gear,
                                       trace_every=nsf, interpret=True)
        np.testing.assert_array_equal(np.asarray(d_a.re), np.asarray(d_b.re))
        np.testing.assert_array_equal(np.asarray(d_a.im), np.asarray(d_b.im))
        np.testing.assert_array_equal(np.asarray(s_a.freq),
                                      np.asarray(s_b.freq))
        np.testing.assert_array_equal(np.asarray(s_a.phase),
                                      np.asarray(s_b.phase))
        want = np.asarray(tr_a).reshape(c, t // nsf, nsf)[..., -1]
        np.testing.assert_array_equal(np.asarray(tr_b), want)


def test_costas_tm_entry_matches_channel_major():
    """costas_run_tm on (T, C) planes == costas_run_pallas on the (C, T)
    symbols, bit-exact."""
    c, t = 64, 256
    rng = np.random.default_rng(5)
    sym = CF32(jnp.asarray(rng.normal(size=(c, t)), jnp.float32),
               jnp.asarray(rng.normal(size=(c, t)), jnp.float32))
    params = costas_params(loop_bw=2.0 * np.pi / 100.0)
    st = costas_init(batch_shape=(c,))
    s_a, d_a = costas_run_pallas(st, sym, params, interpret=True)
    s_b, d_b, _ = costas_run_tm(st, sym.re.T, sym.im.T, params,
                                interpret=True)
    np.testing.assert_array_equal(np.asarray(d_a.re),
                                  np.asarray(d_b.re).T)
    np.testing.assert_array_equal(np.asarray(d_a.im),
                                  np.asarray(d_b.im).T)
    np.testing.assert_array_equal(np.asarray(s_a.freq), np.asarray(s_b.freq))


def test_rx_stream_padded_matches_unpadded():
    """rx_stream through the kernel on a channel count off the program
    width (5 of 16 lanes live) equals the scan lowering: same bits, and
    symbols, readback and state to the interpret-mode tolerance."""
    from qpsk_tpu import modem as modem_mod

    c, nframes = 5, 8
    rng = np.random.default_rng(7)
    pcm = jnp.asarray(rng.integers(-12000, 12000,
                                   (c, nframes, CFG.frame_size),
                                   dtype=np.int16))
    cfg = dataclasses.replace(CFG, costas_impl="pallas")
    st_p, out_p = modem_mod._rx_stream_fused(
        cfg, rx_init(cfg, batch_shape=(c,)), pcm, interpret=True)
    st_r, out_r = modem_mod.rx_stream(CFG, rx_init(CFG, batch_shape=(c,)),
                                      pcm)
    np.testing.assert_array_equal(np.asarray(out_p.bits),
                                  np.asarray(out_r.bits))
    np.testing.assert_allclose(np.asarray(out_p.symbols.re),
                               np.asarray(out_r.symbols.re), atol=1e-3)
    np.testing.assert_allclose(np.asarray(out_p.freq_hz),
                               np.asarray(out_r.freq_hz), atol=0.1)
    np.testing.assert_allclose(np.asarray(st_p.costas.phase),
                               np.asarray(st_r.costas.phase), atol=1e-3)
    np.testing.assert_allclose(np.asarray(st_p.decim_delay.re),
                               np.asarray(st_r.decim_delay.re), atol=1e-3)
    assert out_p.bits.shape[0] == c


def test_rx_stream_padded_channel_less_stream():
    """A channel-less (nframes, frame_size) stream through the kernel
    decodes identically to the scan lowering and keeps its channel-less
    shapes."""
    from qpsk_tpu import modem as modem_mod

    nframes = 8
    rng = np.random.default_rng(8)
    pcm = jnp.asarray(rng.integers(-12000, 12000,
                                   (nframes, CFG.frame_size),
                                   dtype=np.int16))
    cfg = dataclasses.replace(CFG, costas_impl="pallas")
    st_p, out_p = modem_mod._rx_stream_fused(cfg, rx_init(cfg), pcm,
                                             interpret=True)
    st_r, out_r = modem_mod.rx_stream(CFG, rx_init(CFG), pcm)
    assert out_p.bits.shape == out_r.bits.shape == (nframes,
                                                    2 * CFG.symbols_per_frame)
    np.testing.assert_array_equal(np.asarray(out_p.bits),
                                  np.asarray(out_r.bits))
    np.testing.assert_allclose(np.asarray(out_p.symbols.re),
                               np.asarray(out_r.symbols.re), atol=1e-3)
    np.testing.assert_allclose(np.asarray(st_p.costas.phase),
                               np.asarray(st_r.costas.phase), atol=1e-3)
    assert np.asarray(st_p.nco_phase.re).shape == ()
    assert np.asarray(st_p.costas.freq).shape == ()


def test_costas_emit_bits_matches_slicer():
    """The XLA slicer on the kernel's derot planes gives the scan's hard
    decisions bit for bit, plain and gear loops."""
    from qpsk_tpu.ops import costas as costas_ops
    from qpsk_tpu.ops.modmap import demod_bits

    c, t = 48, 512
    rng = np.random.default_rng(9)
    zr = jnp.asarray(rng.normal(size=(t, c)), jnp.float32)
    zi = jnp.asarray(rng.normal(size=(t, c)), jnp.float32)
    params = costas_params(loop_bw=2.0 * np.pi / 100.0)
    for gear in (None, gear_for(2.0 * np.pi / 200.0, np.sqrt(0.5))):
        st = costas_init(batch_shape=(c,), gear=gear is not None)
        _, derot_tm, _ = costas_run_tm(st, zr, zi, params, gear=gear,
                                       trace_every=128, interpret=True)
        bits = demod_bits(CF32(derot_tm.re.T, derot_tm.im.T))
        sym = CF32(zr.T, zi.T)
        if gear is None:
            _, ref = costas_ops.costas_run(st, sym, params)
        else:
            _, ref = costas_ops.costas_run_gear(st, sym, params, gear)
        assert bits.shape == (c, 2 * t)
        np.testing.assert_array_equal(np.asarray(bits),
                                      np.asarray(demod_bits(ref)))

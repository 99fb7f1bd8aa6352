"""Decision-directed mode of the fused Costas kernel against the
`lax.scan` twin (costas_run with modfam.dd_detector) for every
generic-family constellation — both paths run the SAME op program
(modfam.dd_err_ops, boundary-exact comparison decisions), in Pallas
interpret mode on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qpsk_tpu.ops import costas as costas_ops
from qpsk_tpu.ops import modfam
from qpsk_tpu.ops.cplx import CF32
from qpsk_tpu.ops.pallas import costas_kernel


def kernel_traced(state, z, params, **kw):
    """(C, T) twin of costas_run_traced through the kernel."""
    st, d, ft = costas_kernel.costas_run_tm(state, z.re.T, z.im.T, params,
                                            interpret=True, **kw)
    return st, CF32(d.re.T, d.im.T), ft

PARAMS = costas_ops.costas_params(0.0628, 0.7071, -1.0, 1.0)


def _noisy_symbols(name, c, t, scale=1.45, sigma=0.07, seed=0):
    mod = modfam.get(name)
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    lab = jax.random.randint(k1, (c, t), 0, mod.M)
    pts = modfam.labels_to_symbols(lab, mod)
    re = pts.re * scale + sigma * jax.random.normal(k2, (c, t))
    im = pts.im * scale + sigma * jax.random.normal(k3, (c, t))
    return CF32(re.astype(jnp.float32), im.astype(jnp.float32))


@pytest.mark.parametrize("name", ["bpsk", "8psk", "16qam"])
def test_dd_kernel_matches_scan(name):
    """Interpret-mode closeness: trajectories track to ~1 ULP/step (the
    phase-update FMA-contraction choice is per-compilation-context on
    XLA:CPU, so exact interpret equality is not a stable invariant).
    chip_smoke.py compares the two lowerings on the card."""
    c, t = 256, 512
    sym = _noisy_symbols(name, c, t)
    st0 = costas_ops.costas_init((c,), freq=0.01)
    det = modfam.dd_detector(modfam.get(name), scale=1.45)
    st_a, out_a, tr_a = costas_ops.costas_run_traced(st0, sym, PARAMS,
                                                     detector=det)
    dd = (name, 1.45)
    st_b, out_b, tr_b = kernel_traced(st0, sym, PARAMS, dd=dd)
    np.testing.assert_allclose(np.asarray(out_a.re), np.asarray(out_b.re),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_a.im), np.asarray(out_b.im),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(st_a.phase),
                               np.asarray(st_b.phase), atol=1e-5)
    np.testing.assert_allclose(np.asarray(st_a.freq),
                               np.asarray(st_b.freq), atol=1e-6)
    np.testing.assert_allclose(np.asarray(tr_a), np.asarray(tr_b),
                               atol=1e-6)


def test_dd_kernel_block_trace_matches_scan_boundaries():
    """trace_every returns the frame-boundary freq values the stream path
    reads back.  Closeness, not bit-equality: XLA:CPU's FMA-contraction
    choice for the phase update is per-compilation-context (the scan and
    the interpret-mode kernel can round 1 ULP apart per step at some
    inputs)."""
    c, t, every = 128, 512, 128
    sym = _noisy_symbols("8psk", c, t, seed=3)
    st0 = costas_ops.costas_init((c,), freq=-0.02)
    det = modfam.dd_detector(modfam.get("8psk"), scale=1.45)
    _, _, tr = costas_ops.costas_run_traced(st0, sym, PARAMS, detector=det)
    dd = ("8psk", 1.45)
    _, _, trb = kernel_traced(st0, sym, PARAMS, dd=dd, trace_every=every)
    np.testing.assert_allclose(
        np.asarray(tr)[:, every - 1::every], np.asarray(trb), atol=1e-6)


def test_rx_stream_forced_pallas_dd_matches_scan():
    """Whole fused RX stream with costas_impl='pallas' (DD kernel engaged
    on the generic family, interpret mode) decodes bit-identically to the
    scan config."""
    from qpsk_tpu import ModemConfig, rx_init, tx_init
    from qpsk_tpu.modem import _rx_stream_fused, tx_stream

    base = dict(modulation="8psk")
    rng = np.random.default_rng(5)
    cfg = ModemConfig(**base)
    nframes = 4
    bits = jnp.asarray(rng.integers(
        0, 2, (128, nframes, cfg.bits_per_frame), dtype=np.int32))
    _, pcm = tx_stream(cfg, tx_init(cfg, batch_shape=(128,)), bits,
                       tx_offset_hz=12.0)
    outs = {}
    for impl in ("scan", "pallas"):
        c = ModemConfig(**base, costas_impl=impl)
        _, out = _rx_stream_fused(c, rx_init(c, batch_shape=(128,)),
                                  pcm.reshape(128, nframes, cfg.frame_size),
                                  interpret=True)
        outs[impl] = out
    # decode (bits) must agree exactly; the symbol/freq trajectories are
    # allowed interpret-mode ULP drift (XLA:CPU FMA-contraction context,
    # see test_dd_kernel_block_trace_matches_scan_boundaries)
    np.testing.assert_array_equal(np.asarray(outs["scan"].bits),
                                  np.asarray(outs["pallas"].bits))
    np.testing.assert_allclose(np.asarray(outs["scan"].symbols.re),
                               np.asarray(outs["pallas"].symbols.re),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(outs["scan"].freq_hz),
                               np.asarray(outs["pallas"].freq_hz),
                               atol=1e-3)

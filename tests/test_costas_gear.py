"""Gear-shift (dual-bandwidth) Costas loop tests.

The reference README warns its single loop bandwidth must be hand-tuned in
TAU/100..TAU/200 (README.md:12) — wide to acquire, narrow to not jitter.
The gear shift (ops/costas.CostasGear) runs both: acquisition gains until
the lock detector settles, then tracking gains, shifting back on signal
loss.  These tests pin the detector behavior, the tracking-jitter win over
the single-bandwidth loop, and scan/Pallas equivalence.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp

from qpsk_tpu import ModemConfig, rx_init, tx_init
from qpsk_tpu.modem import rx_stream, tx_bits_frame
from qpsk_tpu.ops import costas, modmap
from qpsk_tpu.ops.cplx import CF32, from_complex, to_complex
from qpsk_tpu.ops.pallas.costas_kernel import costas_run_tm

TAU = 2.0 * math.pi


def _qpsk_stream(freq_offset_radsym, nsym, seed=0, snr_db=None):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=2 * nsym).astype(np.int32)
    syms = to_complex(modmap.bits_to_symbols(jnp.asarray(bits)))
    rot = syms * np.exp(1j * freq_offset_radsym * np.arange(nsym))
    if snr_db is not None:
        sigma = math.sqrt(0.5 / (10 ** (snr_db / 10.0)))
        rot = rot + sigma * (rng.standard_normal(nsym)
                             + 1j * rng.standard_normal(nsym))
    return from_complex(rot.astype(np.complex64))


DIAG = modmap.CONSTELLATION * np.exp(1j * np.pi / 4).astype(np.complex64)


def _evm(points):
    dist = np.min(np.abs(points[:, None] - DIAG[None, :]), axis=1)
    return float(np.sqrt(np.mean(dist ** 2)))


def test_gear_disabled_matches_plain():
    """With an unreachable enter threshold the gear never shifts: the
    trajectory must be bit-identical to the single-bandwidth loop."""
    z = _qpsk_stream(0.13, 1500, snr_db=12)
    p = costas.costas_params(TAU / 100.0)
    g = costas.costas_gear(TAU / 200.0, enter=-1.0, exit=2.0)
    st_ref, out_ref = costas.costas_run(costas.costas_init(), z, p)
    st_g, out_g = costas.costas_run_gear(costas.costas_init(gear=True), z,
                                         p, g)
    np.testing.assert_array_equal(np.asarray(out_ref.re), np.asarray(out_g.re))
    np.testing.assert_array_equal(np.asarray(out_ref.im), np.asarray(out_g.im))
    np.testing.assert_array_equal(np.asarray(st_ref.freq), np.asarray(st_g.freq))
    assert float(st_g.locked) == 0.0


def test_gear_locks_and_holds_frequency():
    """+50 Hz at 2400 baud, 12 dB: the detector must latch the tracking
    gear and the loop must hold the true frequency."""
    offset = TAU * 50.0 / 2400.0
    z = _qpsk_stream(offset, 3000, snr_db=12)
    p = costas.costas_params(TAU / 100.0)
    g = costas.costas_gear(TAU / 200.0)
    st, out = costas.costas_run_gear(costas.costas_init(gear=True), z, p, g)
    assert float(st.locked) == 1.0
    assert float(st.lev) < float(g.enter)
    assert abs(float(st.freq) - offset) < 0.01
    assert _evm(to_complex(out)[2000:]) < 0.4


def test_gear_tracks_tighter_than_wide_loop():
    """The point of the gear shift: post-lock phase jitter at the narrow
    tracking bandwidth beats the wide acquisition-only loop.  Measured as
    tail EVM at 8 dB SNR (seed-averaged)."""
    offset = TAU * 50.0 / 2400.0
    p = costas.costas_params(TAU / 100.0)
    g = costas.costas_gear(TAU / 200.0)
    wide, geared = [], []
    for seed in range(3):
        z = _qpsk_stream(offset, 4000, seed=seed, snr_db=8)
        _, out_w = costas.costas_run(costas.costas_init(), z, p)
        _, out_g = costas.costas_run_gear(costas.costas_init(gear=True), z,
                                          p, g)
        wide.append(_evm(to_complex(out_w)[2000:]))
        geared.append(_evm(to_complex(out_g)[2000:]))
    assert np.mean(geared) < np.mean(wide)


def test_gear_rearms_on_signal_loss():
    """After lock, noise-only input must raise the error level past the
    exit threshold and drop back to the acquisition gear."""
    offset = TAU * 30.0 / 2400.0
    z = _qpsk_stream(offset, 2000, snr_db=15)
    p = costas.costas_params(TAU / 100.0)
    g = costas.costas_gear(TAU / 200.0)
    st, _ = costas.costas_run_gear(costas.costas_init(gear=True), z, p, g)
    assert float(st.locked) == 1.0
    rng = np.random.default_rng(42)
    noise = from_complex((0.3 * (rng.standard_normal(1500)
                                 + 1j * rng.standard_normal(1500))
                          ).astype(np.complex64))
    st2, _ = costas.costas_run_gear(st, noise, p, g)
    assert float(st2.locked) == 0.0
    assert float(st2.lev) > float(g.exit)


def test_pallas_gear_matches_scan_bitexact():
    """Gear-mode fused kernel vs the scan, including the lock-state carry
    across the kernel's time chunks (interpret mode)."""
    c, t = 256, 256
    rng = np.random.default_rng(5)
    offset = TAU * 50.0 / 2400.0
    bits = rng.integers(0, 2, size=(c, 2 * t)).astype(np.int32)
    syms = to_complex(modmap.bits_to_symbols(jnp.asarray(bits)))
    rot = (syms * np.exp(1j * offset * np.arange(t))).astype(np.complex64)
    rot += (0.2 * (rng.standard_normal((c, t))
                   + 1j * rng.standard_normal((c, t)))).astype(np.complex64)
    z = from_complex(rot)
    p = costas.costas_params(TAU / 100.0)
    g = costas.costas_gear(TAU / 200.0)
    st0 = costas.costas_init((c,), gear=True)
    st_ref, out_ref, ft_ref = costas.costas_run_gear_traced(st0, z, p, g)
    st_p, out_tm, ft_p = costas_run_tm(st0, z.re.T, z.im.T, p, gear=g,
                                       interpret=True)
    out_p = CF32(out_tm.re.T, out_tm.im.T)
    np.testing.assert_array_equal(np.asarray(out_ref.re), np.asarray(out_p.re))
    np.testing.assert_array_equal(np.asarray(out_ref.im), np.asarray(out_p.im))
    np.testing.assert_array_equal(np.asarray(ft_ref), np.asarray(ft_p))
    np.testing.assert_array_equal(np.asarray(st_ref.phase), np.asarray(st_p.phase))
    np.testing.assert_array_equal(np.asarray(st_ref.freq), np.asarray(st_p.freq))
    np.testing.assert_array_equal(np.asarray(st_ref.lev), np.asarray(st_p.lev))
    np.testing.assert_array_equal(np.asarray(st_ref.locked),
                                  np.asarray(st_p.locked))
    # the lock must actually engage somewhere in the batch for this to be
    # a meaningful gear test
    assert np.asarray(st_ref.locked).mean() > 0.9


def test_rx_stream_gear_end_to_end():
    """Full modem loopback with the gear shift enabled decodes bit-exact
    and ends locked (the ModemConfig.loop_bw_track wiring)."""
    cfg = ModemConfig(loop_bw_track=TAU / 200.0)
    rng = np.random.default_rng(11)
    nframes = 30
    bits = jnp.asarray(rng.integers(0, 2, (nframes, 256), dtype=np.int32))

    def tx_one(st, b):
        st, pcm = tx_bits_frame(cfg, st, b, tx_offset_hz=50.0)
        return st, pcm

    _, pcm = jax.lax.scan(tx_one, tx_init(cfg), bits)
    state, out = rx_stream(cfg, rx_init(cfg),
                           pcm.reshape(-1, cfg.frame_size))
    assert float(state.costas.locked) == 1.0
    assert abs(float(out.freq_hz[-1]) - 50.0) < 3.0
    # post-transient bits match under one of the 4 lock rotations: compare
    # via the EVM of derotated symbols instead (rotation-agnostic)
    tail = to_complex(CF32(out.symbols.re[8:], out.symbols.im[8:])).ravel()
    tail = tail / np.sqrt(np.mean(np.abs(tail) ** 2))  # 1.45x chain gain
    assert _evm(tail) < 0.3

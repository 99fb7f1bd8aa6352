"""Fused Costas kernel (Pallas, Triton route) vs the lax.scan reference,
in Pallas interpret mode on the CPU.  Interpret mode runs the kernel's
step through the same XLA:CPU compiler as the scan, so plain-loop
trajectories agree bit for bit here; on the card the two compilers
contract multiply-adds differently and chip_smoke.py holds them to its
stated tolerances."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from qpsk_tpu import ModemConfig, rx_init
from qpsk_tpu.ops import costas as costas_ops
from qpsk_tpu.ops.cplx import CF32
from qpsk_tpu.ops.pallas.costas_kernel import (_pick_bc, costas_run_pallas,
                                               costas_run_tm)


def _random_symbols(c, t, seed=0):
    rng = np.random.default_rng(seed)
    return CF32(jnp.asarray(rng.normal(size=(c, t)).astype(np.float32)),
                jnp.asarray(rng.normal(size=(c, t)).astype(np.float32)))


def kernel_traced(state, z, params, **kw):
    """(C, T) twin of costas_run_traced through the kernel."""
    st, d, ft = costas_run_tm(state, z.re.T, z.im.T, params,
                              interpret=True, **kw)
    return st, CF32(d.re.T, d.im.T), ft


def test_pallas_matches_scan_bitexact():
    c, t = 256, 256
    params = costas_ops.costas_params(0.0628)
    state = costas_ops.costas_init((c,), freq=0.05)
    z = _random_symbols(c, t)
    st_ref, out_ref, ft_ref = costas_ops.costas_run_traced(state, z, params)
    st_p, out_p, ft_p = kernel_traced(state, z, params)
    np.testing.assert_array_equal(np.asarray(out_ref.re), np.asarray(out_p.re))
    np.testing.assert_array_equal(np.asarray(out_ref.im), np.asarray(out_p.im))
    np.testing.assert_array_equal(np.asarray(ft_ref), np.asarray(ft_p))
    np.testing.assert_array_equal(np.asarray(st_ref.phase), np.asarray(st_p.phase))
    np.testing.assert_array_equal(np.asarray(st_ref.freq), np.asarray(st_p.freq))


def test_pallas_multi_tile_grid():
    """Several channel programs and several time chunks (grid > 1, the
    chunk prefetch carried through the loop) preserve the carry."""
    c, t = 384, 96   # 12 programs of 32 channels, 6 chunks of 16 rows
    params = costas_ops.costas_params(0.0628)
    state = costas_ops.costas_init((c,), phase=0.3, freq=-0.02)
    z = _random_symbols(c, t, seed=1)
    st_ref, out_ref = costas_ops.costas_run(state, z, params)
    st_p, out_p = costas_run_pallas(state, z, params, interpret=True)
    np.testing.assert_array_equal(np.asarray(out_ref.re), np.asarray(out_p.re))
    np.testing.assert_array_equal(np.asarray(st_ref.freq), np.asarray(st_p.freq))


def test_pallas_wide_channel_tile():
    """Wide batches split into one-warp programs of 32 channels (4096
    channels -> 128 programs) and stay bit-exact against the scan."""
    c, t = 4096, 16
    assert _pick_bc(c) == 32
    params = costas_ops.costas_params(0.0628)
    state = costas_ops.costas_init((c,), phase=0.1, freq=0.03)
    z = _random_symbols(c, t, seed=2)
    st_ref, out_ref = costas_ops.costas_run(state, z, params)
    st_p, out_p = costas_run_pallas(state, z, params, interpret=True)
    np.testing.assert_array_equal(np.asarray(out_ref.re), np.asarray(out_p.re))
    np.testing.assert_array_equal(np.asarray(out_ref.im), np.asarray(out_p.im))
    np.testing.assert_array_equal(np.asarray(st_ref.phase), np.asarray(st_p.phase))
    np.testing.assert_array_equal(np.asarray(st_ref.freq), np.asarray(st_p.freq))


@pytest.mark.parametrize("c,t", [(1, 37), (5, 300), (33, 129)])
def test_kernel_masks_channels_and_time_tail(c, t):
    """Channel counts off the program width (masked lanes) and T off the
    chunk size (the static tail after the loop): every live channel and
    every symbol matches the scan."""
    params = costas_ops.costas_params(0.0628)
    state = costas_ops.costas_init((c,), freq=0.02)
    z = _random_symbols(c, t, seed=c)
    st_ref, out_ref, ft_ref = costas_ops.costas_run_traced(state, z, params)
    st_p, out_p, ft_p = kernel_traced(state, z, params)
    assert out_p.re.shape == (c, t) and ft_p.shape == (c, t)
    np.testing.assert_array_equal(np.asarray(out_ref.re), np.asarray(out_p.re))
    np.testing.assert_array_equal(np.asarray(out_ref.im), np.asarray(out_p.im))
    np.testing.assert_array_equal(np.asarray(ft_ref), np.asarray(ft_p))
    np.testing.assert_array_equal(np.asarray(st_ref.freq), np.asarray(st_p.freq))


@pytest.mark.parametrize("gear", [False, True])
def test_kernel_state_chains_across_calls(gear):
    """Two chained kernel calls == one call over the concatenation: the
    final state (gear lock level and flag included) hands off exactly."""
    c, t = 40, 256
    params = costas_ops.costas_params(0.0628)
    g = costas_ops.costas_gear(0.0314) if gear else None
    st0 = costas_ops.costas_init((c,), freq=0.01, gear=gear)
    z = _random_symbols(c, t, seed=11)
    h = t // 2
    st1, d1 = costas_run_pallas(st0, CF32(z.re[:, :h], z.im[:, :h]), params,
                                gear=g, interpret=True)
    st2, d2 = costas_run_pallas(st1, CF32(z.re[:, h:], z.im[:, h:]), params,
                                gear=g, interpret=True)
    st, d = costas_run_pallas(st0, z, params, gear=g, interpret=True)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(d1.re), np.asarray(d2.re)], axis=1),
        np.asarray(d.re))
    for a, b in zip(st2, st):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_forced_kernel_off_gpu_raises():
    """Off the GPU the kernel runs only when the caller asks for
    interpret mode: forcing it (directly, or through costas_impl) must
    raise, never fall back quietly."""
    from qpsk_tpu.modem import rx_stream

    params = costas_ops.costas_params(0.0628)
    z = _random_symbols(4, 16)
    with pytest.raises(ValueError, match="GPU"):
        costas_run_tm(costas_ops.costas_init((4,)), z.re.T, z.im.T, params)
    cfg = ModemConfig(costas_impl="pallas")
    pcm = jnp.zeros((2, 2, cfg.frame_size), jnp.int16)
    with pytest.raises(ValueError, match="GPU"):
        rx_stream(cfg, rx_init(cfg, batch_shape=(2,)), pcm)


@pytest.mark.parametrize("impl,want", [("auto", False), ("scan", False),
                                       ("pallas", True)])
def test_costas_dispatch_off_gpu(impl, want):
    """'auto' takes the scan on the CPU (the kernel only on the GPU);
    'pallas' forces the kernel."""
    from qpsk_tpu.modem import _use_costas_kernel

    assert jax.default_backend() == "cpu"
    assert _use_costas_kernel(ModemConfig(costas_impl=impl)) is want

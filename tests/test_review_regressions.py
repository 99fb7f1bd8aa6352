"""Regression tests for defects found in the round-1 self-review."""

import struct

import numpy as np
import jax.numpy as jnp
import pytest

from qpsk_tpu import ModemConfig, tx_init
from qpsk_tpu.modem import rx_acquire_hz, tx_bits_frame, tx_stream
from qpsk_tpu.packet import PacketConfig, interleave_bits
from qpsk_tpu.sync import SyncResult, find_sync


def test_config_rejects_frame_not_divisible_by_cycles():
    with pytest.raises(ValueError, match="divisible by"):
        ModemConfig(rs=3200.0)  # cycles=3 doesn't divide 512


def test_interleaver_rejects_non_bijective_size():
    # 2776 bits = 8 * 347: the saturated golden prime divides nbits, which
    # the reference would silently corrupt (interleave.c has no check)
    bits = jnp.zeros(2776, jnp.int32)
    with pytest.raises(ValueError, match="coprime"):
        interleave_bits(bits)


def test_packet_345_bytes_raises_not_corrupts():
    from qpsk_tpu.packet import assemble_packet
    pcfg = PacketConfig(payload_bytes=345)
    payload = jnp.zeros(8 * 345, jnp.int32)
    with pytest.raises(ValueError):
        assemble_packet(pcfg, payload)


def test_acquire_small_nfft_and_short_pcm():
    cfg = ModemConfig(nfft=64)
    rng = np.random.default_rng(0)
    bits = jnp.asarray(rng.integers(0, 2, (8, 256), dtype=np.int32))
    _, pcm = tx_stream(cfg, tx_init(cfg), bits, tx_offset_hz=80.0)
    est = float(rx_acquire_hz(cfg, pcm))
    assert abs(est - 80.0) < 30.0  # coarse (64-bin FFT), but sane
    with pytest.raises(ValueError, match="at least"):
        rx_acquire_hz(cfg, pcm.ravel()[:100])


def test_tx_stream_odd_frame_length_matches_frame_chain():
    """64-symbol frames (128 bits): the fused TX must handle frame sizes
    other than cfg.frame_size, exactly like per-frame TX does."""
    cfg = ModemConfig()
    rng = np.random.default_rng(1)
    bits = jnp.asarray(rng.integers(0, 2, (3, 128), dtype=np.int32))
    _, pcm_fused = tx_stream(cfg, tx_init(cfg), bits, tx_offset_hz=50.0)
    st = tx_init(cfg)
    frames = []
    for k in range(3):
        st, p = tx_bits_frame(cfg, st, bits[k], tx_offset_hz=50.0)
        frames.append(np.asarray(p))
    d = np.abs(np.asarray(pcm_fused).astype(np.int32)
               - np.stack(frames).astype(np.int32))
    assert d.max() <= 1


def test_find_sync_short_stream_raises_cleanly():
    pcfg = PacketConfig(payload_bytes=30)
    with pytest.raises(ValueError, match="find_sync needs"):
        find_sync(pcfg, jnp.zeros(100, jnp.int32))


def test_find_sync_clamps_max_lag():
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(2)
    # enough for the probe window plus a small lag range only
    bits = jnp.asarray(rng.integers(0, 2, 4 * 256 + 64, dtype=np.int32))
    sync = find_sync(pcfg, bits, max_lag=600, probe_frames=4)
    assert isinstance(sync, SyncResult)  # no assert/shape blowup


def test_wav_read_skips_extra_chunks(tmp_path):
    """Real-world WAVs carry LIST/fact chunks between fmt and data."""
    from qpsk_tpu.io import read_wav

    rng = np.random.default_rng(3)
    pcm = rng.integers(-1000, 1000, 256, dtype=np.int16)
    data = pcm.tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, 9600, 19200, 2, 16)
    info = b"INFOISFT\x0a\x00\x00\x00synthetic\x00"
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
              + b"LIST" + struct.pack("<I", len(info)) + info
              + b"data" + struct.pack("<I", len(data)) + data)
    blob = b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks
    path = tmp_path / "extra_chunks.wav"
    path.write_bytes(blob)
    got, sr = read_wav(str(path))
    assert sr == 9600
    np.testing.assert_array_equal(got, pcm)


def test_wav_read_18byte_fmt(tmp_path):
    from qpsk_tpu.io import read_wav

    pcm = np.arange(-50, 50, dtype=np.int16)
    data = pcm.tobytes()
    fmt18 = struct.pack("<HHIIHHH", 1, 1, 9600, 19200, 2, 16, 0)
    chunks = (b"fmt " + struct.pack("<I", len(fmt18)) + fmt18
              + b"data" + struct.pack("<I", len(data)) + data)
    blob = b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks
    path = tmp_path / "fmt18.wav"
    path.write_bytes(blob)
    got, sr = read_wav(str(path))
    assert sr == 9600
    np.testing.assert_array_equal(got, pcm)


def test_timeparallel_fractional_mode_supported():
    """The sharded stream honors timing_mode='fractional' (it previously
    fell back to integer timing silently)."""
    import jax
    from jax.sharding import Mesh
    from qpsk_tpu.modem import rx_stream
    from qpsk_tpu import rx_init
    from qpsk_tpu.packet import assemble_packet
    from qpsk_tpu.parallel.stream import rx_stream_timeparallel

    cfg = ModemConfig(timing_mode="fractional")
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(4)
    payload = jnp.asarray(rng.integers(0, 2, (16, 240), dtype=np.int32))
    _, pcm = tx_stream(cfg, tx_init(cfg), assemble_packet(pcfg, payload),
                       tx_offset_hz=50.0)
    mesh = Mesh(np.asarray(jax.devices()), ("sp",))
    syms, bits, fhz = rx_stream_timeparallel(cfg, pcm.reshape(-1), mesh)
    assert bits.shape == (16 * 256,)
    np.testing.assert_allclose(np.asarray(fhz), 50.0, atol=15.0)


def test_checkpoint_tolerates_treedef_repr_drift(tmp_path):
    """A saved state whose pytree class later gained None fields must
    still load (leaf count/shapes align); genuine drift still raises
    (review r2)."""
    import jax

    from qpsk_tpu.state import rx_init
    from qpsk_tpu.utils.checkpoint import load_state, save_state

    cfg = ModemConfig()
    st = rx_init(cfg)
    path = str(tmp_path / "st.npz")
    save_state(path, st)
    # simulate an older checkpoint whose treedef repr differs: clobber the
    # stored repr blob — load must not depend on it when leaves align
    data = dict(np.load(path))
    data["treedef"] = np.frombuffer(b"old-repr", dtype=np.uint8)
    np.savez(path, **data)
    restored = load_state(path, st)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

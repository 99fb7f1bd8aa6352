"""Round-2 hardening: sync-window sizing, eval gating, checkpoint truth,
shape-stable streaming, native-interleave guards, 1200-baud end-to-end."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qpsk_tpu import ModemConfig, rx_init, tx_init
from qpsk_tpu.channel import awgn_pcm
from qpsk_tpu.config import config_1200
from qpsk_tpu.modem import rx_stream, tx_stream
from qpsk_tpu.packet import PacketConfig, assemble_packet
from qpsk_tpu.runtime import StreamDemodulator
from qpsk_tpu.sync import default_max_lag, extract_packets_tracked, find_sync


def _loopback_bits(cfg, pcfg, nframes, seed=0, snr=None, offset=50.0):
    """TX packets -> channel -> RX; returns (payload, demod bit stream)."""
    rng = np.random.default_rng(seed)
    payload = jnp.asarray(rng.integers(
        0, 2, (nframes, 8 * pcfg.payload_bytes), dtype=np.int32))
    chan_bits = assemble_packet(pcfg, payload).ravel()
    mframe_bits = 2 * cfg.symbols_per_frame
    npad = (-chan_bits.size) % mframe_bits
    if npad:
        chan_bits = jnp.concatenate(
            [chan_bits, jnp.asarray(rng.integers(0, 2, (npad,), np.int32))])
    _, pcm = tx_stream(cfg, tx_init(cfg), chan_bits.reshape(-1, mframe_bits),
                       tx_offset_hz=offset)
    if snr is not None:
        sp = float(jnp.mean((pcm.astype(jnp.float32) / cfg.pcm_scale) ** 2))
        pcm = awgn_pcm(jax.random.key(seed), pcm, snr_db=snr, signal_power=sp,
                       pcm_scale=cfg.pcm_scale)
    _, out = rx_stream(cfg, rx_init(cfg), pcm)
    return np.asarray(payload), out.bits.ravel()


def test_large_coded_packet_sync():
    """payload_bytes=64 + FEC makes frame_bits=1068 > the old hard-coded
    600-bit window; the derived window must still find sync (VERDICT #7)."""
    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=64, fec=True)
    assert pcfg.frame_bits > 600
    assert default_max_lag(pcfg) >= 2 * pcfg.frame_bits
    payload, bits = _loopback_bits(cfg, pcfg, nframes=24, snr=14.0)
    skip = 8 * 2 * cfg.symbols_per_frame
    stream = jnp.asarray(np.asarray(bits)[skip:])
    sync = find_sync(pcfg, stream, max_lag=default_max_lag(pcfg),
                     probe_frames=4)
    assert int(sync.score) >= 3, int(sync.score)
    navail = (stream.shape[0] - int(sync.bit_lag)) // pcfg.frame_bits
    rx = extract_packets_tracked(pcfg, stream, sync, navail)
    ok = np.asarray(rx.crc_ok)
    assert ok.mean() > 0.8, ok
    wanted = {w.tobytes() for w in payload.astype(np.uint8)}
    got = np.asarray(rx.payload_bits).astype(np.uint8)
    assert all(got[j].tobytes() in wanted for j in np.flatnonzero(ok))


def test_eval_coded_differential_decodes():
    """per_vs_snr with fec + differential must fall back to the hard-input
    Viterbi path (ADVICE r1): soft LLRs of absolute symbols don't align
    with the differential bit stream."""
    from qpsk_tpu.eval import per_vs_snr
    cfg = ModemConfig(differential=True)
    pcfg = PacketConfig(payload_bytes=13, fec=True)
    recs = per_vs_snr(cfg, pcfg, [14.0], nframes=40, seed=1)
    assert recs[0]["packets"] > 10, recs
    assert recs[0]["per"] < 0.3, recs
    assert recs[0]["ber"] < 0.05, recs


def test_checkpoint_structure_mismatch_raises(tmp_path):
    from qpsk_tpu.utils.checkpoint import load_state, save_state
    cfg = ModemConfig()
    path = str(tmp_path / "st.npz")
    save_state(path, rx_init(cfg))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(path, tx_init(cfg))


def test_checkpoint_sharded_roundtrip(tmp_path):
    """Sharded modem state survives save/load with its mesh placement."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from qpsk_tpu.utils.checkpoint import load_state, save_state
    cfg = ModemConfig()
    mesh = Mesh(np.asarray(jax.devices()), ("dp",))
    sh = NamedSharding(mesh, P("dp"))
    state = jax.device_put(rx_init(cfg, batch_shape=(8,)), sh)
    # advance it so the state is nontrivial
    pcm = jnp.zeros((8, 2, cfg.frame_size), jnp.int16)
    state, _ = rx_stream(cfg, state, pcm)
    path = str(tmp_path / "st.npz")
    save_state(path, state)
    restored = load_state(path, state)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert b.sharding == a.sharding, (a.sharding, b.sharding)


def test_native_interleave_nonbijective_raises():
    """2776 bits saturates the prime table at 347, which divides 2776:
    the native path must refuse like the Python twin (ADVICE r1)."""
    from qpsk_tpu.io import native_interleave_bits
    bits = np.zeros(2776, np.uint8)
    with pytest.raises(ValueError, match="not bijective"):
        native_interleave_bits(bits)
    # a bijective size still round-trips
    rng = np.random.default_rng(0)
    b = rng.integers(0, 2, 480, dtype=np.uint8)
    fwd = native_interleave_bits(b)
    back = native_interleave_bits(fwd, deinterleave=True)
    np.testing.assert_array_equal(back, b)


def test_stream_demodulator_two_shapes():
    """Arbitrary chunk sizes must compile at most TWO rx_stream shapes
    (the bucket and the 1-frame flush remainder) — every extra shape is
    another compile."""
    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(5)
    payload = jnp.asarray(rng.integers(0, 2, (40, 240), dtype=np.int32))
    _, pcm = tx_stream(cfg, tx_init(cfg), assemble_packet(pcfg, payload),
                       tx_offset_hz=50.0)
    pcm = np.asarray(pcm).ravel()
    demod = StreamDemodulator(cfg, pcfg)
    got, pos = [], 0
    while pos < pcm.size:
        n = int(rng.integers(37, 4001))
        got.extend(demod.push(pcm[pos:pos + n]))
        pos += n
    got.extend(demod.flush())
    assert demod._rx_jit._cache_size() <= 2, demod._rx_jit._cache_size()
    ok = [p for p in got if p.crc_ok]
    assert len(ok) >= 25, len(ok)
    wanted = {w.tobytes() for w in np.asarray(payload).astype(np.uint8)}
    assert all(p.payload.astype(np.uint8).tobytes() in wanted for p in ok)


def test_tracking_degrade_warns():
    """Selecting timing_mode='tracking' on a carry-less path must warn, not
    silently run the feedforward estimator (VERDICT weak #9)."""
    from qpsk_tpu.ops.cplx import CF32
    from qpsk_tpu.ops.timing import estimate_and_decimate
    frames = CF32(jnp.ones((2, 512), jnp.float32),
                  jnp.zeros((2, 512), jnp.float32))
    with pytest.warns(RuntimeWarning, match="tracking"):
        estimate_and_decimate(frames, 4, "tracking")


def test_1200_baud_end_to_end():
    """1200-baud 10 m mode (README.md:2): cycles=8 changes the whole
    decimation/tile geometry; packets must still decode (VERDICT #6)."""
    cfg = config_1200()
    assert cfg.cycles == 8
    pcfg = PacketConfig(payload_bytes=30)
    payload, bits = _loopback_bits(cfg, pcfg, nframes=40, snr=14.0, seed=2)
    skip = 8 * 2 * cfg.symbols_per_frame
    stream = jnp.asarray(np.asarray(bits)[skip:])
    sync = find_sync(pcfg, stream, max_lag=default_max_lag(pcfg),
                     probe_frames=4)
    assert int(sync.score) >= 3, int(sync.score)
    navail = (stream.shape[0] - int(sync.bit_lag)) // pcfg.frame_bits
    rx = extract_packets_tracked(pcfg, stream, sync, navail)
    ok = np.asarray(rx.crc_ok)
    assert ok.mean() > 0.8, ok.mean()
    wanted = {w.tobytes() for w in payload.astype(np.uint8)}
    got = np.asarray(rx.payload_bits).astype(np.uint8)
    assert all(got[j].tobytes() in wanted for j in np.flatnonzero(ok))


def test_cli_sweep_fec(capsys):
    """`sweep --fec` must actually run a coded sweep (ADVICE r1)."""
    from qpsk_tpu.cli import main
    rc = main(["sweep", "--fec", "--snr-db", "12", "--frames", "30",
               "--seed", "1"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["packets"] > 5, rec
    assert rec["per"] < 0.3, rec

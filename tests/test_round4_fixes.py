"""Round-4 features and ADVICE fixes:

* comparison-program slicer (modfam.slice_labels_cmp / demod_bits_cmp) —
  the DD loop's own decisions as the hard slicer, geometrically identical
  to the score-argmax twin;
* the fused Costas kernel's DD derotation sliced by demod_bits_cmp gives
  the scan's decisions;
* frame-rate AGC gains from time-major planes (ops/agc.agc_gains_tm) and
  their in-kernel application, bit-identical to the composed agc_stream;
* StreamDemodulator slip walk uses max_step = bits-per-symbol (ADVICE r3:
  the default max_step=2 silently disabled symbol-slip adoption for
  8PSK/16QAM and let BPSK walk two symbols per packet).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qpsk_tpu import ModemConfig, rx_init, tx_init
from qpsk_tpu.channel import awgn_pcm
from qpsk_tpu.modem import rx_stream, tx_stream
from qpsk_tpu.ops import agc as agc_ops
from qpsk_tpu.ops import costas as costas_ops
from qpsk_tpu.ops import modfam
from qpsk_tpu.ops.cplx import CF32
from qpsk_tpu.ops.pallas import costas_kernel
from qpsk_tpu.packet import PacketConfig, assemble_packet
from qpsk_tpu.runtime import StreamDemodulator


# ---------------------------------------------------------------------------
# comparison-program slicer

@pytest.mark.parametrize("name", ["bpsk", "8psk", "16qam"])
def test_cmp_slicer_matches_argmax(name):
    """slice_labels_cmp == slice_labels on noisy symbols (the Gray regions
    are the min-distance regions for the whole family), and the bit twin
    agrees under every rotation hypothesis."""
    m = modfam.get(name)
    rng = np.random.default_rng(0)
    n, sc = 4000, 1.45
    lab = rng.integers(0, m.M, n)
    sym = CF32(
        jnp.asarray((m.points_re[lab] * sc
                     + 0.12 * rng.standard_normal(n)).astype(np.float32)),
        jnp.asarray((m.points_im[lab] * sc
                     + 0.12 * rng.standard_normal(n)).astype(np.float32)))
    np.testing.assert_array_equal(
        np.asarray(modfam.slice_labels(sym, m, scale=sc)),
        np.asarray(modfam.slice_labels_cmp(sym, m, scale=sc)))
    for r in range(m.n_rot):
        np.testing.assert_array_equal(
            np.asarray(modfam.demod_bits_mod(sym, m, scale=sc, rotation=r)),
            np.asarray(modfam.demod_bits_cmp(sym, m, scale=sc, rotation=r)))


@pytest.mark.parametrize("name", ["bpsk", "8psk", "16qam"])
def test_dd_err_ops_label_does_not_change_error(name):
    """want_label=True adds int selects only — the float error chain is
    the identical op program (bitwise-equal error values)."""
    m = modfam.get(name)
    rng = np.random.default_rng(1)
    z = CF32(jnp.asarray(rng.standard_normal(512).astype(np.float32)),
             jnp.asarray(rng.standard_normal(512).astype(np.float32)))
    consts = modfam.dd_constants(m, 1.45)
    e0 = modfam.dd_err_ops(name, m.M, z.re, z.im, get=lambda i: consts[i])
    e1, lab = modfam.dd_err_ops(name, m.M, z.re, z.im,
                                get=lambda i: consts[i], want_label=True)
    np.testing.assert_array_equal(np.asarray(e0), np.asarray(e1))
    np.testing.assert_array_equal(
        np.asarray(lab),
        np.asarray(modfam.slice_labels_cmp(z, m, scale=1.45)))


# ---------------------------------------------------------------------------
# kernel packed-label emission

@pytest.mark.parametrize("name", ["bpsk", "8psk", "16qam"])
def test_kernel_packed_labels(name):
    """demod_bits_cmp on the kernel's DD derot symbols == the same slicer
    on the scan's, bit-for-bit (interpret mode; the kernel leaves slicing
    to XLA)."""
    m = modfam.get(name)
    rng = np.random.default_rng(2)
    c, t, sc = 64, 256, 1.45
    lab = rng.integers(0, m.M, (t, c))
    zr = jnp.asarray((m.points_re[lab] * sc
                      + 0.05 * rng.standard_normal((t, c))).astype(np.float32))
    zi = jnp.asarray((m.points_im[lab] * sc
                      + 0.05 * rng.standard_normal((t, c))).astype(np.float32))
    params = costas_ops.costas_params(0.0628, np.sqrt(0.5), -1.0, 1.0)
    st0 = costas_ops.costas_init((c,))
    _, derot_tm, _ = costas_kernel.costas_run_tm(
        st0, zr, zi, params, dd=(name, sc), interpret=True)
    bits = modfam.demod_bits_cmp(CF32(derot_tm.re.T, derot_tm.im.T), m,
                                 scale=sc)
    _, ref = costas_ops.costas_run(
        st0, CF32(zr.T, zi.T), params,
        detector=modfam.dd_detector(m, scale=sc))
    np.testing.assert_array_equal(
        np.asarray(bits), np.asarray(modfam.demod_bits_cmp(ref, m, scale=sc)))
    assert bits.shape == (c, m.bps * t)


# ---------------------------------------------------------------------------
# AGC gains from time-major planes

def test_agc_gains_tm_matches_stream():
    """agc_gains_tm on (T, C) planes == agc_stream's gains/estimate on the
    same logical symbols in channel-major layout, bitwise (the fixed-tree
    power sum is layout-invariant)."""
    rng = np.random.default_rng(3)
    c, f, nsf = 128, 12, 128
    re = (0.8 + 0.2 * rng.standard_normal((c, f, nsf))).astype(np.float32)
    im = (0.2 * rng.standard_normal((c, f, nsf))).astype(np.float32)
    est0 = agc_ops.agc_init((c,))
    est_a, scaled = agc_ops.agc_stream(est0, CF32(jnp.asarray(re),
                                                  jnp.asarray(im)),
                                       1.45, 0.25)
    t = f * nsf
    zr_tm = jnp.asarray(re.reshape(c, t).T)
    zi_tm = jnp.asarray(im.reshape(c, t).T)
    est_b, gains = agc_ops.agc_gains_tm(est0, zr_tm, zi_tm, f, 1.45, 0.25)
    np.testing.assert_array_equal(np.asarray(est_a), np.asarray(est_b))
    sc_tm = np.asarray(zr_tm) * np.asarray(gains).repeat(nsf, axis=0)
    np.testing.assert_array_equal(np.asarray(scaled.re).reshape(c, t).T,
                                  sc_tm)


def test_kernel_agc_gains_match_prescaled():
    """In-kernel per-frame gain application == scaling the planes first
    (one IEEE multiply either way), bitwise through the whole DD loop."""
    rng = np.random.default_rng(4)
    c, f, nsf = 40, 8, 32
    t = f * nsf
    zr = jnp.asarray((0.6 + 0.1 * rng.standard_normal((t, c))
                      ).astype(np.float32))
    zi = jnp.asarray((0.1 * rng.standard_normal((t, c))).astype(np.float32))
    _, gains = agc_ops.agc_gains_tm(agc_ops.agc_init((c,)), zr, zi, f,
                                    1.45, 0.25)
    gx = jnp.asarray(np.asarray(gains).repeat(nsf, axis=0))
    params = costas_ops.costas_params(0.0628, np.sqrt(0.5), -1.0, 1.0)
    st0 = costas_ops.costas_init((c,))
    st_a, d_a, tr_a = costas_kernel.costas_run_tm(
        st0, zr * gx, zi * gx, params, dd=("16qam", 1.45), trace_every=nsf,
        interpret=True)
    st_b, d_b, tr_b = costas_kernel.costas_run_tm(
        st0, zr, zi, params, dd=("16qam", 1.45), trace_every=nsf,
        gains=gains, interpret=True)
    np.testing.assert_array_equal(np.asarray(d_a.re), np.asarray(d_b.re))
    np.testing.assert_array_equal(np.asarray(d_a.im), np.asarray(d_b.im))
    np.testing.assert_array_equal(np.asarray(st_a.freq), np.asarray(st_b.freq))
    np.testing.assert_array_equal(np.asarray(tr_a), np.asarray(tr_b))


# ---------------------------------------------------------------------------
# batched StreamModulator

@pytest.mark.parametrize("name", ["qpsk", "8psk"])
def test_stream_modulator_batched_dispatch(name):
    """A push of N packets modulates in O(log N) power-of-two batches (not
    one dispatch per packet), and the PCM still matches one tx_stream over
    the concatenated packets within 1 int16 LSB."""
    from qpsk_tpu.runtime import StreamModulator

    cfg = ModemConfig(modulation=name)
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(7)
    npkts = 37
    payload = rng.integers(0, 2, (npkts, 240), dtype=np.int64)

    mod = StreamModulator(cfg, pcfg, tx_offset_hz=50.0)
    calls = []
    inner = mod._tx
    mod._tx = lambda st, rows: calls.append(rows.shape) or inner(st, rows)
    pcm = mod.push(payload)
    pcm = np.concatenate([pcm, mod.flush()])
    # greedy 32+4+1 = 3 dispatches for 37 rows (8PSK has one fewer whole
    # chunk row in the push; the remainder flushes)
    assert len(calls) <= 4, calls
    assert sorted({s[0] for s in calls} - {1, 2, 4, 8, 16, 32, 64}) == []

    chan = assemble_packet(pcfg, jnp.asarray(payload.astype(np.int32)))
    if name == "qpsk":
        rows = chan
    else:
        flat = np.asarray(chan).ravel()
        cb = mod._chunk_bits
        pad = (-flat.size) % cb
        rows = jnp.asarray(np.concatenate(
            [flat, np.zeros(pad, np.int32)]).reshape(-1, cb))
    _, one = tx_stream(cfg, tx_init(cfg), rows, tx_offset_hz=50.0)
    one = np.asarray(one).ravel()
    n = min(one.size, pcm.size)
    d = np.abs(pcm[:n].astype(np.int32) - one[:n].astype(np.int32))
    assert d.max() <= 1 and (d != 0).mean() < 0.01


# ---------------------------------------------------------------------------
# streaming symbol-slip walk for bps != 2 (ADVICE r3 medium)

@pytest.mark.slow
def test_stream_slip_8psk_adopts_shift():
    """Deleting one symbol period of PCM mid-stream shifts all later
    framing by bps=3 bits; with the walk capped at max_step=bps the
    tracker adopts the shift for the cost of ~a packet — no resync.
    (Pre-fix, walk_step's default max_step=2 rejected every 3-bit shift
    and the stream was lost to a full re-hunt.)"""
    cfg = ModemConfig(modulation="8psk")
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(6)
    npkts = 40
    payload = rng.integers(0, 2, (npkts, 8 * pcfg.payload_bytes),
                           dtype=np.int32)
    chan = assemble_packet(pcfg, jnp.asarray(payload)).ravel()
    mfb = cfg.bits_per_frame
    npad = (-chan.size) % mfb
    chan = jnp.concatenate(
        [chan, jnp.asarray(rng.integers(0, 2, (npad,), dtype=np.int32))])
    _, pcm = tx_stream(cfg, tx_init(cfg), chan.reshape(-1, mfb),
                       tx_offset_hz=30.0)
    pcm = np.asarray(pcm).ravel()
    # delete exactly one symbol period (cycles samples) mid-stream: the
    # timing phase is preserved, later symbols shift by one position
    cut = (pcm.size // 2 // cfg.frame_size) * cfg.frame_size + 64
    pcm = np.concatenate([pcm[:cut], pcm[cut + cfg.cycles:]])

    demod = StreamDemodulator(cfg, pcfg, slip_track=1)
    got = list(demod.push(pcm)) + list(demod.flush())
    ok = [p for p in got if p.crc_ok]
    assert demod.counters.resyncs == 0, demod.counters
    # ~8 packets consumed by the hunt at the head; the slip itself costs
    # ~a packet or two (shift adopted, not a resync)
    assert len(ok) >= npkts - 12, (len(ok), len(got))
    wanted = {p.tobytes() for p in payload.astype(np.uint8)}
    assert all(p.payload.astype(np.uint8).tobytes() in wanted for p in ok)


# ---------------------------------------------------------------------------
# streaming checkpoint / resume

@pytest.mark.parametrize("fec", [False, "conv"])
def test_stream_demodulator_checkpoint_resume(tmp_path, fec):
    """save/load mid-stream: a restarted receiver continues the epoch
    exactly — the resumed second half emits the same packets (payloads,
    CRC verdicts, stream indices) as an uninterrupted run."""
    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=30, fec=fec)
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 2, (40, 240), dtype=np.int32)
    chan = assemble_packet(pcfg, jnp.asarray(payload)).ravel()
    mfb = cfg.bits_per_frame
    npad = (-chan.size) % mfb
    if npad:
        chan = jnp.concatenate(
            [chan, jnp.asarray(rng.integers(0, 2, (npad,), np.int32))])
    _, pcm = tx_stream(cfg, tx_init(cfg), chan.reshape(-1, mfb),
                       tx_offset_hz=50.0)
    sp = float(jnp.mean((pcm.astype(jnp.float32) / 16384.0) ** 2))
    pcm = np.asarray(awgn_pcm(jax.random.key(9), pcm, snr_db=10.0,
                              signal_power=sp)).ravel()
    cut = (pcm.size // 2 // 512) * 512 + 173   # mid-bucket, odd offset

    ref = StreamDemodulator(cfg, pcfg)
    ref_pkts = list(ref.push(pcm)) + list(ref.flush())

    d1 = StreamDemodulator(cfg, pcfg)
    first = list(d1.push(pcm[:cut]))
    path = str(tmp_path / "rx.npz")
    d1.save(path)

    d2 = StreamDemodulator(cfg, pcfg)
    d2.load(path)
    second = list(d2.push(pcm[cut:])) + list(d2.flush())

    got = first + second
    assert len(got) == len(ref_pkts), (len(got), len(ref_pkts))
    for a, b in zip(got, ref_pkts):
        assert a.crc_ok == b.crc_ok
        assert a.stream_index == b.stream_index
        np.testing.assert_array_equal(a.payload, b.payload)
    assert d2.counters.packets == ref.counters.packets
    assert d2.counters.detected_offset_hz == ref.counters.detected_offset_hz


@pytest.mark.parametrize("name", ["qpsk", "8psk"])
def test_stream_modulator_checkpoint_resume(tmp_path, name):
    """StreamModulator.save/load mid-stream: the resumed transmitter's
    PCM equals the uninterrupted stream exactly (carried filter/NCO state
    and the 8PSK sub-symbol pending bits round-trip)."""
    from qpsk_tpu.runtime import StreamModulator

    cfg = ModemConfig(modulation=name)
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 2, (20, 240), dtype=np.int64)

    ref = StreamModulator(cfg, pcfg, tx_offset_hz=50.0)
    pcm_ref = np.concatenate([ref.push(payload[:9]), ref.push(payload[9:]),
                              ref.flush()])

    m1 = StreamModulator(cfg, pcfg, tx_offset_hz=50.0)
    first = m1.push(payload[:9])
    path = str(tmp_path / "tx.npz")
    m1.save(path)
    m2 = StreamModulator(cfg, pcfg, tx_offset_hz=50.0)
    m2.load(path)
    rest = np.concatenate([m2.push(payload[9:]), m2.flush()])
    pcm = np.concatenate([first, rest])
    np.testing.assert_array_equal(pcm, pcm_ref)


# ---------------------------------------------------------------------------
# M-power acquisition spur: candidate fallback

def _tx_8psk_offset(offset_hz, seed, npkts=40, snr=20.0):
    cfg = ModemConfig(modulation="8psk")
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (npkts, 240), dtype=np.int32)
    chan = assemble_packet(pcfg, jnp.asarray(payload)).ravel()
    mfb = cfg.bits_per_frame
    npad = (-chan.size) % mfb
    chan = jnp.concatenate(
        [chan, jnp.asarray(rng.integers(0, 2, (npad,), np.int32))])
    _, pcm = tx_stream(cfg, tx_init(cfg), chan.reshape(-1, mfb),
                       tx_offset_hz=float(offset_hz))
    sp = float(jnp.mean((pcm.astype(jnp.float32) / 16384.0) ** 2))
    pcm = np.asarray(awgn_pcm(jax.random.key(seed + 10), pcm, snr_db=snr,
                              signal_power=sp)).ravel()
    return cfg, pcfg, payload, pcm


def test_acquire_candidates_contain_true_offset_at_spur():
    """The measured deterministic 8PSK acquisition failure (+250 Hz,
    seed 0: the 8th-power spur at 8Δf − rs out-peaks the carrier line, so
    the single estimate is exactly 300 Hz off): the 2-candidate API must
    hold the TRUE offset in its candidate set."""
    from qpsk_tpu.modem import rx_acquire_hz

    cfg, _, _, pcm = _tx_8psk_offset(250.0, seed=0)
    single = float(rx_acquire_hz(cfg, jnp.asarray(pcm)))
    cands = np.asarray(rx_acquire_hz(cfg, jnp.asarray(pcm),
                                     candidates=2)).ravel()
    assert cands.shape == (2,)
    assert abs(cands[0] - single) < 1.0          # candidate 0 == old estimate
    assert abs(single - 250.0) > 100.0           # ...which is the spur
    assert min(abs(c - 250.0) for c in cands) < 10.0, cands


@pytest.mark.slow
def test_stream_demodulator_acquisition_spur_fallback():
    """Streaming 8PSK at +250 Hz, the deterministic spur draw: a
    single-estimate receiver re-acquires the same wrong peak forever;
    the candidate rotation (two dead hunt windows -> next candidate)
    locks and decodes."""
    cfg, pcfg, payload, pcm = _tx_8psk_offset(250.0, seed=0, npkts=200)
    demod = StreamDemodulator(cfg, pcfg)
    got = []
    pos = 0
    while pos < pcm.size:       # live-stream pacing: the rotation needs
        got.extend(demod.push(pcm[pos:pos + 20480]))  # samples to remain
        pos += 20480
    got.extend(demod.flush())
    ok = [p for p in got if p.crc_ok]
    assert demod._acq_idx >= 1, "fallback never rotated candidates"
    # the candidate churn costs the stream head (~2 rotation cycles of
    # skip + dead windows + re-acquisition buckets); everything after the
    # eventual lock decodes.  Pre-fix this was 0 forever.
    assert demod.counters.synced
    assert len(ok) >= 60, (len(ok), len(got))
    wanted = {p.tobytes() for p in payload.astype(np.uint8)}
    assert all(p.payload.astype(np.uint8).tobytes() in wanted for p in ok)

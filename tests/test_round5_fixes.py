"""Round-5 ADVICE fixes:

* checkpoint paths are used VERBATIM (np.savez silently appends '.npz' to
  string paths missing the suffix, so ``--state-file foo.state`` wrote
  foo.state.npz while resume checked foo.state — the 24/7-receiver resume
  silently never happened for non-.npz names);
* the receiver checkpoint carries the acquisition-candidate epoch
  (_acq_idx/_acq_bits/_acq_stale) so a save mid-hunt on the spur-fallback
  candidate resumes on it instead of re-parking on the spur;
* hunt rejections of bits demodulated under a ROTATED-AWAY candidate no
  longer count toward the new candidate's rejection budget (stale bits
  could rotate straight past the correct candidate);
* acquisition candidate peaks interpolate against the ORIGINAL psd, not
  the guard-masked copy (a runner-up adjacent to a guard edge had a zeroed
  neighbor, biasing its offset by up to ~half a bin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qpsk_tpu import ModemConfig
from qpsk_tpu.packet import PacketConfig
from qpsk_tpu.runtime import StreamDemodulator, StreamModulator
from qpsk_tpu.sync import default_max_lag


# ---------------------------------------------------------------------------
# checkpoint path handling

def test_state_file_exact_path(tmp_path):
    """save() writes to the exact path given — no silent '.npz' append —
    and load() round-trips from it (the CLI --state-file contract)."""
    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=8)
    path = str(tmp_path / "receiver.state")   # deliberately not .npz

    demod = StreamDemodulator(cfg, pcfg)
    demod.counters.frames = 7
    demod.save(path)
    assert (tmp_path / "receiver.state").exists()
    assert not (tmp_path / "receiver.state.npz").exists()
    fresh = StreamDemodulator(cfg, pcfg)
    fresh.load(path)
    assert fresh.counters.frames == 7

    mod = StreamModulator(cfg, pcfg)
    mpath = str(tmp_path / "sender.state")
    mod.save(mpath)
    assert (tmp_path / "sender.state").exists()
    StreamModulator(cfg, pcfg).load(mpath)


def test_save_state_exact_path(tmp_path):
    from qpsk_tpu import rx_init
    from qpsk_tpu.utils.checkpoint import load_state, save_state

    cfg = ModemConfig()
    st = rx_init(cfg)
    path = str(tmp_path / "modem.ckpt")
    save_state(path, st)
    assert (tmp_path / "modem.ckpt").exists()
    assert not (tmp_path / "modem.ckpt.npz").exists()
    load_state(path, st)


def test_fdm_receiver_exact_path(tmp_path):
    from qpsk_tpu.fdm import FdmConfig, FdmReceiver

    fcfg = FdmConfig(nslots=4)
    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=8)
    rx = FdmReceiver(fcfg, cfg, pcfg)
    path = str(tmp_path / "fdm.state")
    rx.save(path)
    assert (tmp_path / "fdm.state").exists()
    assert not (tmp_path / "fdm.state.npz").exists()
    FdmReceiver(fcfg, cfg, pcfg).load(path)


# ---------------------------------------------------------------------------
# acquisition-candidate epoch in the checkpoint

def test_checkpoint_preserves_acq_epoch(tmp_path):
    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=8)
    demod = StreamDemodulator(cfg, pcfg)
    demod._acq_idx = 1
    demod._acq_bits = 437
    demod._acq_stale = 64
    path = str(tmp_path / "hunting.npz")
    demod.save(path)
    fresh = StreamDemodulator(cfg, pcfg)
    fresh.load(path)
    assert fresh._acq_idx == 1
    assert fresh._acq_bits == 437
    assert fresh._acq_stale == 64


# ---------------------------------------------------------------------------
# stale bits after candidate rotation

def test_stale_bits_do_not_count_toward_rotation():
    """A hunt-window rejection of bits demodulated under the PREVIOUS
    acquisition candidate must not advance _acq_bits: with >= 2 windows of
    stale bits buffered, the old accounting rotated straight past the new
    candidate before any of its own bits were ever hunted."""
    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=8)
    demod = StreamDemodulator(cfg, pcfg)
    window = default_max_lag(pcfg)
    probe_bits = demod.probe_frames * pcfg.frame_bits + 64
    # enough random (never-syncing) bits for exactly two window rejections
    n = demod.sync_skip + 2 * window + probe_bits + 2
    rng = np.random.default_rng(0)
    demod._bit_buf = rng.integers(0, 2, (demod._nrot, n)).astype(np.int32)
    # everything buffered is stale (just rotated candidates)
    demod._acq_stale = n
    assert demod._try_sync() is False
    assert demod._acq_bits == 0, (
        "stale-bit rejections counted toward the new candidate")
    # fresh bits appended after the rotation DO count
    demod._bit_buf = np.concatenate(
        [demod._bit_buf,
         rng.integers(0, 2, (demod._nrot, window)).astype(np.int32)], axis=1)
    assert demod._try_sync() is False
    assert 0 < demod._acq_bits <= window


# ---------------------------------------------------------------------------
# acquisition sweep fallback

def test_sweep_candidates_grid():
    from qpsk_tpu.ops.acquire import sweep_candidates_hz

    g = sweep_candidates_hz(max_hz=300.0, step_hz=75.0)
    assert list(g) == [0.0, 75.0, -75.0, 150.0, -150.0,
                       225.0, -225.0, 300.0, -300.0]


def test_runtime_sweep_fallback_acquires():
    """When spectral acquisition is compromised (both FFT candidates are
    spurs — here forced via a stubbed acquire), the candidate rotation
    walks into the static sweep grid and the link still acquires: the
    8PSK failure mode measured at |offset| >= 250 Hz where BOTH top-2
    M-power peaks are deterministic spurs."""
    import jax

    from qpsk_tpu.channel import awgn_pcm

    cfg = ModemConfig(modulation="8psk")
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(3)
    npkts = 240
    payloads = rng.integers(0, 2, (npkts, 240)).astype(np.int32)
    mod = StreamModulator(cfg, pcfg, tx_offset_hz=150.0)
    pcm = np.concatenate([mod.push(payloads), mod.flush()])
    sp = float(np.mean((pcm.astype(np.float32) / 16384.0) ** 2))
    pcm = np.asarray(awgn_pcm(jax.random.key(0), jnp.asarray(pcm),
                              snr_db=20.0, signal_power=sp))

    demod = StreamDemodulator(cfg, pcfg)
    # spur-parked acquisition: both candidates far outside pull-in
    demod._acquire_jit = lambda chunk: jnp.asarray([420.0, -420.0])
    # stream in bucket-sized pushes: candidate rotation happens at
    # bucket boundaries (a single giant push rotates at most once)
    got = []
    step = demod.bucket_frames * cfg.frame_size
    for i in range(0, pcm.size, step):
        got += list(demod.push(pcm[i:i + step]))
    got += list(demod.flush())
    ok = [p for p in got if p.crc_ok]
    assert demod._acq_idx >= 2, "sweep fallback never engaged"
    assert len(ok) >= npkts // 3, (len(ok), npkts)
    tx_set = {row.tobytes() for row in payloads.astype(np.uint8)}
    matched = sum(1 for p in ok
                  if p.payload.astype(np.uint8).tobytes() in tx_set)
    assert matched == len(ok), "decoded payloads not bit-exact"


# ---------------------------------------------------------------------------
# candidate peak interpolation against the original PSD

def test_candidate_interp_uses_original_psd():
    """A runner-up line adjacent to the guard edge interpolates against
    the pre-masked psd: its offset must equal the offset _peak_hz finds on
    the original psd with the main peak removed by hand."""
    import jax.numpy as jnp

    from qpsk_tpu.ops.acquire import _peak_hz

    nfft, fs, power, guard = 512, 9600.0, 4, 16
    psd = np.full(nfft, 0.01, np.float32)
    psd[99:102] = [5.0, 9.0, 5.0]          # main peak, bin 100
    psd[116:119] = [4.0, 6.0, 2.0]         # runner-up, bin 117 (asymmetric)

    # ground truth: original psd with the main peak excised far away
    truth = psd.copy()
    truth[84:117] = 0.01
    truth[116] = 4.0
    f_true, k_true = _peak_hz(jnp.asarray(truth), nfft, fs, power)
    assert int(k_true) == 117

    # candidate-search view: guard window around bin 100 zeroed, which
    # zeroes the runner-up's km neighbor (bin 116)
    masked = psd.copy()
    masked[100 - guard:100 + guard + 1] = 0.0
    f_fixed, k = _peak_hz(jnp.asarray(masked), nfft, fs, power,
                          interp_psd=jnp.asarray(psd))
    assert int(k) == 117
    np.testing.assert_allclose(float(f_fixed), float(f_true), atol=1e-4)
    # and the old behavior really was biased (guards the regression)
    f_old, _ = _peak_hz(jnp.asarray(masked), nfft, fs, power)
    assert abs(float(f_old) - float(f_true)) > 0.1 * fs / nfft / power


def test_candidate_interp_delta_clamped():
    """Against the ORIGINAL psd a runner-up adjacent to a stronger line's
    skirt can read a neighbor ABOVE its own peak — the parabolic fit then
    flips and delta grows unboundedly.  The fit must stay within the half
    bin it refines (review find, round 5)."""
    import jax.numpy as jnp

    from qpsk_tpu.ops.acquire import _peak_hz

    nfft, fs, power = 512, 9600.0, 4
    psd = np.full(nfft, 0.01, np.float32)
    psd[95:101] = [3.0, 9.0, 5.0, 3.2, 2.4, 1.9]   # main line + skirt
    psd[101:103] = [1.5, 0.2]                      # runner-up at 101 with
    # skirt neighbor psd[100]=1.9 > its own peak 1.5: pm-2*p0+pp > 0
    masked = psd.copy()
    masked[96 - 4:96 + 5] = 0.0                    # guard the main line
    f, k = _peak_hz(jnp.asarray(masked), nfft, fs, power,
                    interp_psd=jnp.asarray(psd))
    assert int(k) == 101
    bin_hz = fs / nfft / power
    assert abs(float(f) - 101 * bin_hz) <= 0.5 * bin_hz + 1e-6


# ---------------------------------------------------------------------------
# bench entry point: median of the windows + spread, named device

def test_bench_entry_reports_best_window(monkeypatch, capsys):
    """bench.py runs its measurement windows and reports the MEDIAN with
    every window and the spread visible, beside the device it ran on (a
    fake GPU here: the rate function is stubbed)."""
    import importlib
    import json
    import sys
    import types
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    bench = importlib.import_module("bench")
    vals = iter([20e9, 28e9, 24e9, 26e9, 22e9])

    def fake_rx():
        return {"metric": "rx_demod_throughput", "value": next(vals),
                "unit": "samples/s", "channels": 8192, "frames": 8}

    import qpsk_tpu.benchmarks as B
    gpu = types.SimpleNamespace(platform="gpu", device_kind="FAKE GPU")
    monkeypatch.setattr(B, "rx_throughput", fake_rx)
    monkeypatch.setattr(jax, "devices", lambda *a: [gpu])
    monkeypatch.setattr(bench, "power_limit", lambda: "700.00 W")
    assert bench.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, "bench.py must print exactly ONE JSON line"
    rec = json.loads(out[0])
    assert rec["value"] == 24e9
    assert rec["windows"] == [20e9, 28e9, 24e9, 26e9, 22e9]
    assert abs(rec["spread"] - (28 - 20) / 24) < 1e-9
    assert rec["device_kind"] == "FAKE GPU" and rec["device_count"] == 1
    assert rec["power_limit"] == "700.00 W"
    assert "vs_baseline" not in rec


# ---------------------------------------------------------------------------
# CW interferer stimulus

def test_tone_pcm_level_and_acquisition_hijack():
    """channel.tone_pcm adds a CW line at the requested relative power,
    and at 0 dB in-band it hijacks the M-power acquisition — the measured
    fact behind the sweep fallback's scope note (an interferer that breaks
    top-2 acquisition also breaks dense-constellation decode)."""
    import jax

    from qpsk_tpu import ModemConfig, tx_init
    from qpsk_tpu.channel import tone_pcm
    from qpsk_tpu.modem import rx_acquire_hz, tx_stream
    from qpsk_tpu.packet import assemble_packet

    cfg = ModemConfig(modulation="8psk")
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(0)
    payload = jnp.asarray(rng.integers(0, 2, (30, 240), dtype=np.int32))
    chan = assemble_packet(pcfg, payload).ravel()
    mfb = cfg.bits_per_frame
    npad = (-chan.size) % mfb
    chan = jnp.concatenate(
        [chan, jnp.asarray(rng.integers(0, 2, (npad,), np.int32))])
    _, pcm = tx_stream(cfg, tx_init(cfg), chan.reshape(-1, mfb),
                       tx_offset_hz=150.0)
    sp = float(jnp.mean((pcm.astype(jnp.float32) / cfg.pcm_scale) ** 2))

    # level check: adding a 0 dB tone roughly doubles the analog power
    noisy = tone_pcm(pcm, 2200.0, 0.0, sp)
    sp2 = float(jnp.mean((np.asarray(noisy).astype(np.float32)
                          / cfg.pcm_scale) ** 2))
    assert 1.7 < sp2 / sp < 2.3, sp2 / sp

    # acquisition hijack: both candidates leave the ±50 Hz pull-in of the
    # true +150 Hz carrier (the measured 0 dB in-band failure mode)
    cands = np.asarray(rx_acquire_hz(cfg, noisy, candidates=2)).ravel()
    assert min(abs(c - 150.0) for c in cands) > 50.0, cands

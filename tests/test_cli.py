"""CLI smoke tests: every subcommand end-to-end at small sizes (the CLI
is the L5 harness, cf. main() qpsk.c:289-359 — these pin the argument
wiring, not DSP quality, which the library tests own)."""

import json

import pytest

import numpy as np

from qpsk_tpu import cli


def _run(capsys, argv):
    rc = cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, (argv, rc)
    return [json.loads(line) for line in out]


def test_loopback_and_payload_bytes(capsys):
    (rec,) = _run(capsys, ["loopback", "--frames", "20", "--snr-db", "14"])
    assert rec["per"] == 0.0 and rec["sync_score"] >= 3
    assert abs(rec["detected_offset_hz"] - 50.0) < 3.0
    # multi-frame packets via --payload-bytes (spans 2+ frames)
    (rec,) = _run(capsys, ["loopback", "--frames", "20", "--snr-db", "14",
                           "--payload-bytes", "64"])
    assert rec["per"] == 0.0


def test_tx_rx_roundtrip_file(tmp_path, capsys):
    spool = str(tmp_path / "s.raw")
    _run(capsys, ["tx", "--frames", "20", "--out", spool])
    (rec,) = _run(capsys, ["rx", spool])
    assert rec["per"] == 0.0 and rec["sync_score"] >= 3


def test_fdm_subcommand(capsys):
    (rec,) = _run(capsys, ["fdm", "--frames", "16", "--snr-db", "18"])
    assert rec["nchan"] == 3
    for ch in rec["channels"]:
        assert ch["per"] == 0.0 and ch["sync_score"] >= 3


def test_sweep_emits_points(capsys):
    recs = _run(capsys, ["sweep", "--snr-db", "12,14", "--frames", "24"])
    assert [r["snr_db"] for r in recs] == [12.0, 14.0]
    assert recs[1]["per"] == 0.0


def test_bench_suite_record(capsys):
    """bench times the GPU operating points: off the GPU it refuses with
    its own exit code and prints no record (the suites themselves run at
    toy sizes in test_benchmarks.py)."""
    rc = cli.main(["bench", "--suite", "serial"])
    cap = capsys.readouterr()
    assert rc == 3 and "no GPU" in cap.err and cap.out == ""


def test_rx_stream_mode(tmp_path, capsys):
    """rx --stream: push-mode decode of a spool file — hex payload lines
    on stdout, counters JSON on stderr, payloads match the tx bytes."""
    spool = str(tmp_path / "s.raw")
    _run(capsys, ["tx", "--frames", "30", "--seed", "5", "--out", spool])
    rc = cli.main(["rx", spool, "--stream", "--chunk", "3000"])
    cap = capsys.readouterr()
    assert rc == 0
    lines = cap.out.strip().splitlines()
    counters = json.loads(cap.err.strip().splitlines()[-1])
    assert counters["crc_ok"] == len(lines) >= 18
    assert counters["synced"] and counters["crc_failures"] <= 4
    assert abs(counters["detected_offset_hz"] - 50.0) < 5.0
    # payloads are the tx generator's bytes (tx --seed 5 payload stream)
    from qpsk_tpu.packet.bits import np_bits_to_bytes
    rng = np.random.default_rng(5)
    tx_bits = rng.integers(0, 2, (30, 240), dtype=np.int32)
    wanted = {np_bits_to_bytes(b).tobytes().hex() for b in tx_bits}
    assert all(ln in wanted for ln in lines)


def test_rx_stream_squelch_and_io_rate(tmp_path, capsys):
    """rx --stream with dead air + --squelch-db drops the noise and still
    decodes the burst; --io-rate exercises the chunked resampler."""
    spool = str(tmp_path / "s.raw")
    _run(capsys, ["tx", "--frames", "35", "--seed", "6", "--out", spool])
    pcm = np.fromfile(spool, np.int16)
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 600.0, 20 * 512).astype(np.int16)
    mixed = str(tmp_path / "m.raw")
    np.concatenate([noise, pcm]).tofile(mixed)
    rc = cli.main(["rx", mixed, "--stream", "--squelch-db", "5"])
    cap = capsys.readouterr()
    assert rc == 0
    counters = json.loads(cap.err.strip().splitlines()[-1])
    # the squelch re-arms the post-onset transient skip, so the hunt
    # starts ~8 frames into the burst
    assert counters["crc_ok"] >= 18, counters
    assert counters["carrier_detect"]

    # 48 kHz capture of the same burst, streaming-resampled to 9600
    from qpsk_tpu.ops.resample import resample_pcm
    import jax.numpy as jnp
    hi = str(tmp_path / "hi.raw")
    np.asarray(resample_pcm(jnp.asarray(pcm), 9600, 48000)).astype(
        np.int16).tofile(hi)
    rc = cli.main(["rx", hi, "--stream", "--io-rate", "48000",
                   "--chunk", "9600"])
    cap = capsys.readouterr()
    assert rc == 0
    counters = json.loads(cap.err.strip().splitlines()[-1])
    assert counters["crc_ok"] >= 18, counters


def test_tx_stream_rx_stream_duplex(tmp_path, capsys):
    """tx --stream-in (hex payload lines -> PCM) into rx --stream (PCM ->
    hex payload lines): the duplex pipe round-trips byte-exact."""
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, 30, dtype=np.uint8).tobytes().hex()
                for _ in range(30)]
    pfile = str(tmp_path / "p.hex")
    with open(pfile, "w") as f:
        f.write("\n".join(payloads) + "\n")
    spool = str(tmp_path / "s.raw")
    rc = cli.main(["tx", "--stream-in", pfile, "--out", spool])
    cap = capsys.readouterr()
    assert rc == 0
    import json as _json
    txc = _json.loads(cap.err.strip().splitlines()[-1])
    assert txc["packets"] == 30

    rc = cli.main(["rx", spool, "--stream"])
    cap = capsys.readouterr()
    assert rc == 0
    got = cap.out.strip().splitlines()
    assert len(got) >= 20
    assert all(g in set(payloads) for g in got)


def test_tx_stream_io_rate_no_mid_stream_padding(tmp_path, capsys):
    """Review fix: tx --stream-in --io-rate carries the sub-M resampler
    remainder across lines instead of padding each line — at 8000 S/s
    (M=6, which does not divide the 512-sample packet) per-line padding
    shifted the framing and decoded 0 packets."""
    rng = np.random.default_rng(13)
    payloads = [rng.integers(0, 256, 30, dtype=np.uint8).tobytes().hex()
                for _ in range(30)]
    pfile = str(tmp_path / "p.hex")
    with open(pfile, "w") as f:
        f.write("\n".join(payloads) + "\n")
    spool = str(tmp_path / "s8k.raw")
    rc = cli.main(["tx", "--stream-in", pfile, "--out", spool,
                   "--io-rate", "8000"])
    capsys.readouterr()
    assert rc == 0
    rc = cli.main(["rx", spool, "--stream", "--io-rate", "8000"])
    cap = capsys.readouterr()
    assert rc == 0
    got = cap.out.strip().splitlines()
    assert len(got) >= 15, json.loads(cap.err.strip().splitlines()[-1])
    assert all(g in set(payloads) for g in got)


def test_rx_stream_survives_truncated_capture(tmp_path, capsys):
    """Review fix: a raw capture ending mid-sample (odd byte count) drops
    the partial sample instead of crashing the receiver."""
    spool = str(tmp_path / "s.raw")
    _run(capsys, ["tx", "--frames", "20", "--seed", "7", "--out", spool])
    with open(spool, "rb") as f:
        data = f.read()
    trunc = str(tmp_path / "t.raw")
    with open(trunc, "wb") as f:
        f.write(data[:len(data) - 3])     # odd length
    rc = cli.main(["rx", trunc, "--stream", "--chunk", "1001"])
    cap = capsys.readouterr()
    assert rc == 0
    counters = json.loads(cap.err.strip().splitlines()[-1])
    assert counters["crc_ok"] >= 8


def test_tx_stream_malformed_hex_line(tmp_path, capsys):
    """Review fix: a non-hex payload line errors cleanly (rc 2), like the
    wrong-length case."""
    pfile = str(tmp_path / "bad.hex")
    with open(pfile, "w") as f:
        f.write("zz-not-hex\n")
    rc = cli.main(["tx", "--stream-in", pfile, "--out",
                   str(tmp_path / "o.raw")])
    cap = capsys.readouterr()
    assert rc == 2 and "not hex" in cap.err


def test_bench_suite_fdm_reachable(capsys):
    """Review fix: --suite fdm is an accepted choice (the parser takes it;
    off the GPU the run itself is refused, not the argument)."""
    assert cli.main(["bench", "--suite", "fdm"]) == 3
    assert "no GPU" in capsys.readouterr().err


def test_rx_stream_fec_wiring(tmp_path, capsys):
    """--fec + --stream: the streaming receiver decodes coded spools
    through the soft-Viterbi buffers (wiring check; DSP quality is owned
    by the library tests)."""
    spool = str(tmp_path / "c.raw")
    _run(capsys, ["tx", "--frames", "25", "--seed", "8", "--fec",
                  "--out", spool])
    rc = cli.main(["rx", spool, "--stream", "--fec"])
    cap = capsys.readouterr()
    assert rc == 0
    counters = json.loads(cap.err.strip().splitlines()[-1])
    assert counters["crc_ok"] >= 12, counters
    assert len(cap.out.strip().splitlines()) == counters["crc_ok"]


def test_loopback_modulation_flag(capsys):
    """--modulation routes the generic family through the whole harness
    (8PSK frame_bits is not symbol-aligned: the re-framed TX path, the
    every-bit-lag sync hunt, and the n_rot=8 rotation search all engage)."""
    (rec,) = _run(capsys, ["loopback", "--modulation", "8psk", "--frames",
                           "20", "--snr-db", "22", "--offset-hz", "30"])
    assert rec["per"] == 0.0 and rec["sync_score"] >= 3
    assert abs(rec["detected_offset_hz"] - 30.0) < 3.0


def test_duplex_pipe_8psk(tmp_path, capsys):
    """The streaming duplex surface over a generic modulation: the
    StreamModulator carries the sub-symbol bit remainder across payload
    lines (flush() drains it), and the StreamDemodulator's pre-rotated
    buffers decode the pipe byte-exact."""
    rng = np.random.default_rng(13)
    payloads = [rng.integers(0, 256, 30, dtype=np.uint8).tobytes().hex()
                for _ in range(25)]
    pfile = str(tmp_path / "p.hex")
    with open(pfile, "w") as f:
        f.write("\n".join(payloads) + "\n")
    spool = str(tmp_path / "s.raw")
    rc = cli.main(["tx", "--modulation", "8psk", "--stream-in", pfile,
                   "--out", spool, "--offset-hz", "30"])
    cap = capsys.readouterr()
    assert rc == 0
    assert json.loads(cap.err.strip().splitlines()[-1])["packets"] == 25

    rc = cli.main(["rx", spool, "--stream", "--modulation", "8psk"])
    cap = capsys.readouterr()
    assert rc == 0
    got = cap.out.strip().splitlines()
    assert len(got) >= 15, got
    assert all(g in set(payloads) for g in got)


@pytest.mark.slow
def test_rx_stream_state_file_resume(tmp_path, capsys):
    """rx --stream --state-file: a receiver restarted mid-stream resumes
    its sync epoch from the checkpoint and the two runs together decode
    the same payload lines as one uninterrupted run."""
    spool = str(tmp_path / "s.raw")
    _run(capsys, ["tx", "--frames", "40", "--seed", "8", "--out", spool])
    pcm = np.fromfile(spool, np.int16)

    rc = cli.main(["rx", spool, "--stream"])
    cap = capsys.readouterr()
    assert rc == 0
    ref_lines = cap.out.strip().splitlines()

    cut = pcm.size // 2 + 777
    a, b = str(tmp_path / "a.raw"), str(tmp_path / "b.raw")
    pcm[:cut].tofile(a)
    pcm[cut:].tofile(b)
    state = str(tmp_path / "rx_state.npz")
    rc = cli.main(["rx", a, "--stream", "--state-file", state])
    cap1 = capsys.readouterr()
    assert rc == 0
    rc = cli.main(["rx", b, "--stream", "--state-file", state])
    cap2 = capsys.readouterr()
    assert rc == 0
    got = (cap1.out.strip().splitlines() + cap2.out.strip().splitlines())
    # the resumed run may leave a final partial packet buffered in the
    # state file (no flush); everything that decoded matches in order
    assert len(got) >= len(ref_lines) - 2, (len(got), len(ref_lines))
    assert got == ref_lines[:len(got)]

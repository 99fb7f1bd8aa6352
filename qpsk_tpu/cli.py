"""Command-line harness: the L5 layer (cf. main() qpsk.c:289-359).

Subcommands:

* ``loopback`` — TX → channel → RX in one process (the reference's whole
  main(), but with reproducible PRNG seeds, AWGN, metrics, and an optional
  scatter artifact replacing the octave plot, Makefile:10-12).
* ``tx``       — payload packets → int16 PCM spool file (qpsk.h:14 analogue).
* ``rx``       — PCM spool file → packets + metrics.
* ``bench``    — the throughput benchmark (same code path as /bench.py).

Usage: ``python -m qpsk_tpu loopback --frames 100 --snr-db 10``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_common(p):
    p.add_argument("--baud", type=float, default=2400.0,
                   help="symbol rate (2400 VHF / 1200 10m, README.md:2)")
    p.add_argument("--offset-hz", type=float, default=50.0,
                   help="TX carrier offset stimulus (qpsk.c:320)")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--parity", action="store_true",
                   help="reference-parity mode (histogram timing, exact NCO)")
    p.add_argument("--modulation", type=str, default="qpsk",
                   choices=["qpsk", "bpsk", "8psk", "16qam"],
                   help="constellation: qpsk is the reference-parity "
                        "flagship; bpsk/8psk/16qam route the same packet "
                        "stack through the generic family (ops/modfam.py; "
                        "pair 16qam with --agc on uncalibrated levels)")
    p.add_argument("--differential", action="store_true",
                   help="DQPSK: rotation-immune decode, no CRC rotation search")
    p.add_argument("--timing", type=str, default="power",
                   choices=["power", "fractional", "tracking", "histogram"],
                   help="symbol-timing estimator (tracking = frame-rate PLL)")
    p.add_argument("--eq-taps", type=int, default=0,
                   help="blind CMA channel equalizer length (0 = off); "
                        "decodes through static multipath")
    p.add_argument("--agc", action="store_true",
                   help="frame-rate automatic gain control: decode streams "
                        "at unknown levels (pair with loopback --level-db)")
    p.add_argument("--fec", nargs="?", const="conv", default=False,
                   choices=("conv", "ldpc"),
                   help="rate-1/2 FEC: 'conv' = K=7 + soft Viterbi (the "
                        "default when the flag is given bare), 'ldpc' = "
                        "IRA LDPC + min-sum")
    p.add_argument("--payload-bytes", type=int, default=30,
                   help="packet payload size (default 30: one uncoded "
                        "packet fills one 256-symbol frame with its "
                        "CRC16; larger packets span multiple frames)")


def _cfg(args):
    from qpsk_tpu.config import ModemConfig, config_parity
    if getattr(args, "parity", False):
        return config_parity()
    return ModemConfig(rs=args.baud,
                       modulation=getattr(args, "modulation", "qpsk"),
                       differential=getattr(args, "differential", False),
                       timing_mode=getattr(args, "timing", "power"),
                       eq_taps=getattr(args, "eq_taps", 0),
                       agc=getattr(args, "agc", False))


def _pcfg(args):
    from qpsk_tpu.packet import PacketConfig
    return PacketConfig(payload_bytes=getattr(args, "payload_bytes", 30),
                        fec=getattr(args, "fec", False))


def cmd_loopback(args) -> int:
    import jax
    import jax.numpy as jnp

    from qpsk_tpu import rx_init, tx_init
    from qpsk_tpu.channel import awgn_pcm
    from qpsk_tpu.metrics import evm, per
    from qpsk_tpu.modem import rx_stream
    from qpsk_tpu.ops.cplx import CF32
    from qpsk_tpu.packet import assemble_packet
    from qpsk_tpu.sync import (_mod_geometry, default_max_lag,
                               extract_packets_soft_tracked,
                               extract_packets_tracked, find_sync)

    cfg = _cfg(args)
    pcfg = _pcfg(args)
    rng = np.random.default_rng(args.seed)
    payload = jnp.asarray(
        rng.integers(0, 2, (args.frames, 8 * pcfg.payload_bytes), dtype=np.int32))
    chan_bits = assemble_packet(pcfg, payload).ravel()
    # re-frame the packet stream into whole MODEM frames (symbol-aligned:
    # generic-family bits/symbol need not divide the packet frame_bits),
    # padding the tail with filler bits
    mfb = cfg.bits_per_frame
    npad = (-chan_bits.size) % mfb
    if npad:
        chan_bits = jnp.concatenate(
            [chan_bits,
             jnp.asarray(rng.integers(0, 2, (npad,), dtype=np.int32))])
    chan_bits = chan_bits.reshape(-1, mfb)

    from qpsk_tpu.modem import tx_stream
    _, pcm = tx_stream(cfg, tx_init(cfg), chan_bits,
                       tx_offset_hz=args.offset_hz,
                       doppler_hz_per_s=args.doppler)
    if getattr(args, "phase_noise_hz", 0.0):
        from qpsk_tpu.channel import phase_noise_pcm
        pcm = phase_noise_pcm(jax.random.key(args.seed + 1), pcm.reshape(-1),
                              args.phase_noise_hz, cfg.fs).reshape(pcm.shape)
    if getattr(args, "multipath", None):
        from qpsk_tpu.channel import multipath_pcm
        paths = [(int(p.split(":")[0]), float(p.split(":")[1]))
                 for p in args.multipath.split(",")]
        pcm = multipath_pcm(pcm.reshape(-1), paths).reshape(pcm.shape)
    if args.snr_db is not None:
        sp = float(jnp.mean((pcm.astype(jnp.float32) / cfg.pcm_scale) ** 2))
        pcm = awgn_pcm(jax.random.key(args.seed), pcm,
                       snr_db=args.snr_db, signal_power=sp,
                       pcm_scale=cfg.pcm_scale)
    if getattr(args, "impulse_rate", 0.0):
        # impulsive interference (static crashes / ignition noise): pair
        # with --fec — the interleaver spreads each burst across codewords
        from qpsk_tpu.channel import impulse_noise_pcm
        pcm = impulse_noise_pcm(jax.random.key(args.seed + 2),
                                pcm.reshape(-1), args.impulse_rate,
                                cfg.fs).reshape(pcm.shape)
    if getattr(args, "level_db", 0.0):
        # mis-set audio level AFTER the channel (an RX-side gain error):
        # pair with --agc to decode anyway
        g = 10.0 ** (args.level_db / 20.0)
        pcm = jnp.clip(jnp.round(pcm.astype(jnp.float32) * jnp.float32(g)),
                       -32768, 32767).astype(jnp.int16)
    if getattr(args, "clock_ppm", 0.0):
        # RX A/D clock mismatch (pair with --timing tracking)
        from qpsk_tpu.channel import clock_offset_pcm
        pcm = clock_offset_pcm(pcm.reshape(-1), args.clock_ppm * 1e-6)

    # packet PCM length need not divide the RX frame: pad with silence
    flat = pcm.reshape(-1)
    npad = (-flat.size) % cfg.frame_size
    if npad:
        flat = jnp.concatenate([flat, jnp.zeros((npad,), flat.dtype)])
    # generic-family carriers: FFT-acquire before the (narrower-pull-in)
    # decision-directed loop — same receive recipe as eval.per_vs_snr
    acq = 0.0
    if cfg.modulation != "qpsk" and cfg.acquisition == "fft":
        from qpsk_tpu.modem import rx_acquire_hz
        from qpsk_tpu.ops.acquire import hz_to_costas_freq
        acq = hz_to_costas_freq(rx_acquire_hz(cfg, flat), cfg.rs)
    _, out = rx_stream(cfg, rx_init(cfg, acq_freq=acq),
                       flat.reshape(-1, cfg.frame_size))

    min_frames = 16 if pcfg.fec else 8
    if args.frames < min_frames:
        print(f"error: --frames must be >= {min_frames} (packet sync needs "
              f"a probe window past the Costas transient; coded links probe "
              f"8 packet frames), got {args.frames}", file=sys.stderr)
        return 2
    skip = min(8, args.frames // 4)
    bits = out.bits.ravel()
    # generic-family bit streams must be sliced SYMBOL-aligned (rotation
    # hypotheses re-group bits per symbol); for QPSK any even offset works
    # and packet frame_bits is even, so this is the historical offset
    bps = cfg.bits_per_symbol
    skip_bits = skip * pcfg.frame_bits
    skip_bits -= skip_bits % bps
    use_soft = args.fec and not cfg.differential
    llrs = scores = None
    if use_soft:
        # soft source first: both the sync hunt and the extraction run
        # soft-decision (the hard-input hunt limits acquisition ~2 dB
        # above the soft decode floor — sync.find_sync_streams)
        from qpsk_tpu.sync import (_mod_geometry, find_sync_streams,
                                   rotate_soft, rotated_streams)
        if cfg.modulation == "qpsk":
            from qpsk_tpu.ops.modmap import demod_soft
            llrs = demod_soft(CF32(out.symbols.re.reshape(-1),
                                   out.symbols.im.reshape(-1)))
            rows = jnp.stack([rotate_soft(llrs[skip_bits:], r)
                              for r in range(4)])
        else:
            from qpsk_tpu.ops import modfam
            scores = modfam.symbol_scores(
                CF32(out.symbols.re.reshape(-1), out.symbols.im.reshape(-1)),
                modfam.get(cfg.modulation), scale=cfg.agc_target)
            rows = rotated_streams(None, cfg.modulation,
                                   soft=scores[skip_bits // bps:])
        # coded links probe 8 frames: the 4-probe hunt is score-starved
        # exactly at the soft decode floor (docs/sync_floor_coded.jsonl)
        sync = find_sync_streams(pcfg, rows, max_lag=default_max_lag(pcfg),
                                 probe_frames=8, soft=True,
                                 lag_step=_mod_geometry(cfg.modulation)[2])
    else:
        sync = find_sync(pcfg, bits[skip_bits:],
                         max_lag=default_max_lag(pcfg),
                         probe_frames=8 if pcfg.fec else 4,
                         modulation=cfg.modulation)
    navail = (bits.size - skip_bits - int(sync.bit_lag)) // pcfg.frame_bits
    # sustained clock drift can wrap the timing phase and slip the symbol
    # grid: let the tracked extractors walk the bit-lag too
    max_slip = 2 if getattr(args, "clock_ppm", 0.0) else 0
    if use_soft:
        if cfg.modulation == "qpsk":
            rx = extract_packets_soft_tracked(
                pcfg, llrs[skip_bits:], sync, navail, max_slip=max_slip)
        else:
            from qpsk_tpu.sync import extract_packets_soft_tracked_mod
            rx = extract_packets_soft_tracked_mod(
                pcfg, scores[skip_bits // bps:], sync, navail,
                cfg.modulation, max_slip=max_slip)
    else:
        # differential bits come from the turn-difference decode, so
        # per-bit LLRs of the absolute symbols don't apply: FEC (if on)
        # decodes hard-input inside disassemble_packet (~2 dB off soft)
        rx = extract_packets_tracked(pcfg, bits[skip_bits:], sync, navail,
                                     max_slip=max_slip,
                                     modulation=cfg.modulation)
    from qpsk_tpu.metrics import snr_estimate_db
    post = CF32(out.symbols.re[skip:], out.symbols.im[skip:])
    if cfg.modulation == "qpsk":
        evm_rms = float(jnp.mean(evm(post).evm_rms))
    else:
        from qpsk_tpu.ops import modfam
        evm_rms = float(jnp.mean(modfam.evm_mod(
            CF32(post.re.reshape(1, -1), post.im.reshape(1, -1)),
            modfam.get(cfg.modulation))))
    est_snr = float(snr_estimate_db(CF32(post.re.ravel(), post.im.ravel())))

    result = {
        "frames": args.frames,
        "snr_db": args.snr_db,
        "offset_hz": args.offset_hz,
        "detected_offset_hz": round(float(jnp.mean(out.freq_hz[-10:])), 2),
        "sync_rotation_deg": int(sync.rotation) * (
            360 // _mod_geometry(cfg.modulation)[0]),
        "sync_score": int(sync.score),
        "packets": int(np.asarray(rx.crc_ok).size),
        "per": round(float(per(rx.crc_ok)), 5),
        "evm_rms": round(evm_rms, 5),
        "est_snr_db": round(est_snr, 2),
    }
    print(json.dumps(result))

    if args.scatter:
        _scatter_png(args.scatter, out.symbols, skip)
        print(f"scatter written to {args.scatter}", file=sys.stderr)
    return 0


def _scatter_png(path: str, symbols, skip: int) -> None:
    """Constellation artifact (replaces the octave plot, Makefile:10-12).
    matplotlib is needed for ``--scatter`` only."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("--scatter needs matplotlib, which is not "
                         "installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    re = np.asarray(symbols.re)[skip:].ravel()
    im = np.asarray(symbols.im)[skip:].ravel()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(re, im, s=2, alpha=0.3)
    ax.set_xlabel("I")
    ax.set_ylabel("Q")
    ax.set_title("Costas-locked constellation")
    ax.set_aspect("equal")
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _cmd_tx_stream(args) -> int:
    """Push-mode modulator (the TX twin of ``rx --stream``): read hex
    payload lines (payload_bytes each) from a file or stdin, modulate
    through ``StreamModulator`` (filter/NCO state carried across lines),
    and write raw int16 PCM to ``--out`` ('-' = stdout) as it goes —
    ``qpsk_tpu tx --stream-in - | qpsk_tpu rx - --stream`` is a live
    duplex pipe."""
    from qpsk_tpu.packet.bits import np_bytes_to_bits
    from qpsk_tpu.runtime import StreamModulator

    cfg = _cfg(args)
    pcfg = _pcfg(args)
    mod = StreamModulator(cfg, pcfg, tx_offset_hz=args.offset_hz)
    rate = int(args.io_rate or cfg.fs)
    rs = None
    if rate != int(cfg.fs):
        from qpsk_tpu.ops.resample import (rational_ratio, resample_init,
                                           resample_stream)
        try:
            l, m = rational_ratio(cfg.fs, rate)
        except ValueError:
            print(f"error: cannot resample {int(cfg.fs)} -> {rate} S/s "
                  "(not a small rational ratio)", file=sys.stderr)
            return 2
        rs = {"l": l, "m": m, "state": resample_init(l, m)}
    src = sys.stdin if args.stream_in == "-" else open(args.stream_in)
    sink = (sys.stdout.buffer if args.out == "-"
            else open(args.out, "wb"))
    npkts = nsamp = 0
    rs_buf = np.zeros(0, np.float32)

    def convert_out(pcm16: np.ndarray, last: bool = False) -> np.ndarray:
        """Modem rate -> device rate, streaming: whole M-groups per call,
        the sub-M remainder CARRIES to the next line (padding each line
        would insert cumulative mid-stream silence and shift the framing
        wherever M does not divide the packet length); only the stream
        tail pads."""
        nonlocal rs_buf
        if rs is None:
            return pcm16
        import jax.numpy as jnp
        rs_buf = np.concatenate([rs_buf, pcm16.astype(np.float32)])
        n = rs_buf.size - (rs_buf.size % rs["m"])
        if last and rs_buf.size % rs["m"]:
            rs_buf = np.concatenate(
                [rs_buf, np.zeros(rs["m"] - rs_buf.size % rs["m"],
                                  np.float32)])
            n = rs_buf.size
        if n == 0:
            return np.zeros(0, np.int16)
        y, rs["state"] = resample_stream(jnp.asarray(rs_buf[:n]),
                                         rs["state"], rs["l"], rs["m"])
        rs_buf = rs_buf[n:]
        return np.clip(np.rint(np.asarray(y)), -32768, 32767).astype(
            np.int16)

    try:
        for line in src:
            line = line.strip()
            if not line:
                continue
            try:
                data = bytes.fromhex(line)
            except ValueError:
                print(f"error: payload line is not hex: {line[:40]!r}",
                      file=sys.stderr)
                return 2
            if len(data) != pcfg.payload_bytes:
                print(f"error: payload line has {len(data)} bytes, "
                      f"expected {pcfg.payload_bytes}", file=sys.stderr)
                return 2
            pcm = convert_out(
                mod.push(np_bytes_to_bits(np.frombuffer(data, np.uint8))))
            sink.write(pcm.tobytes())
            sink.flush()
            npkts += 1
            nsamp += pcm.size
        # drain the modulator's sub-symbol bit remainder (generic-family
        # constellations), then the resampler's carry
        tail = np.concatenate([convert_out(mod.flush()),
                               convert_out(np.zeros(0, np.int16),
                                           last=True)])
        sink.write(tail.tobytes())
        sink.flush()
        nsamp += tail.size
    finally:
        if src is not sys.stdin:
            src.close()
        if sink is not sys.stdout.buffer:
            sink.close()
    print(json.dumps({"packets": npkts, "samples": nsamp,
                      "sample_rate": rate}), file=sys.stderr)
    return 0


def cmd_tx(args) -> int:
    if args.stream_in is not None:
        return _cmd_tx_stream(args)
    import jax.numpy as jnp

    from qpsk_tpu import tx_init
    from qpsk_tpu.modem import tx_stream
    from qpsk_tpu.packet import assemble_packet

    cfg = _cfg(args)
    pcfg = _pcfg(args)
    rng = np.random.default_rng(args.seed)
    payload = jnp.asarray(
        rng.integers(0, 2, (args.frames, 8 * pcfg.payload_bytes), dtype=np.int32))
    chan_bits = assemble_packet(pcfg, payload).ravel()
    mfb = cfg.bits_per_frame       # whole symbol-aligned modem frames
    npad = (-chan_bits.size) % mfb
    if npad:
        chan_bits = jnp.concatenate(
            [chan_bits,
             jnp.asarray(rng.integers(0, 2, (npad,), dtype=np.int32))])
    _, pcm = tx_stream(cfg, tx_init(cfg), chan_bits.reshape(-1, mfb),
                       tx_offset_hz=args.offset_hz)
    rate = int(args.io_rate or cfg.fs)
    if rate != int(cfg.fs):
        # sound-card device rate: polyphase-resample the modem-rate PCM
        from qpsk_tpu.ops.resample import resample_pcm
        pcm = resample_pcm(pcm.reshape(-1), cfg.fs, rate)[None, :]
    pcm = np.asarray(pcm)
    if args.out.endswith(".wav"):
        from qpsk_tpu.io import write_wav
        write_wav(args.out, pcm.reshape(-1), rate)
    else:
        from qpsk_tpu.io import SpoolWriter
        with SpoolWriter(args.out, pcm.shape[-1]) as w:
            w.write(pcm)
    print(json.dumps({"samples": int(pcm.size), "file": args.out,
                      "sample_rate": rate}))
    return 0


def _cmd_rx_stream(args) -> int:
    """Push-mode decode (the 24/7 receiver surface): read raw int16 PCM
    from a file or stdin in chunks, push through ``StreamDemodulator``
    (automatic sync, CRC tracking, optional squelch), print one hex
    payload line per CRC-good packet AS IT DECODES, and a final
    counters JSON line to stderr."""
    import jax.numpy as jnp

    from qpsk_tpu.runtime import StreamDemodulator

    cfg = _cfg(args)
    pcfg = _pcfg(args)
    if args.infile.endswith(".wav"):
        print("error: --stream reads raw int16 (headerless); convert WAV "
              "first or use the one-shot rx", file=sys.stderr)
        return 2
    sr = int(args.io_rate or cfg.fs)
    rs = None
    if sr != int(cfg.fs):
        from qpsk_tpu.ops.resample import (rational_ratio, resample_init,
                                           resample_stream)
        try:
            l, m = rational_ratio(sr, cfg.fs)
        except ValueError:
            print(f"error: cannot resample {sr} -> {int(cfg.fs)} S/s "
                  "(not a small rational ratio)", file=sys.stderr)
            return 2
        rs = {"l": l, "m": m, "state": resample_init(l, m),
              "buf": np.zeros(0, np.float32)}

    demod = StreamDemodulator(cfg, pcfg, squelch_db=args.squelch_db)
    state_file = getattr(args, "state_file", None)
    if state_file:
        import os as _os
        if _os.path.exists(state_file):
            # resume a prior epoch: buffers, sync, counters all continue
            demod.load(state_file)
    src = sys.stdin.buffer if args.infile == "-" else open(args.infile, "rb")
    npkts = nok = 0

    from qpsk_tpu.packet.bits import np_bits_to_bytes

    def emit(pkts) -> None:
        nonlocal npkts, nok
        for p in pkts:
            npkts += 1
            if p.crc_ok:
                nok += 1
                print(np_bits_to_bytes(np.asarray(p.payload)).tobytes()
                      .hex(), flush=True)

    def convert(pcm16: np.ndarray, last: bool = False) -> np.ndarray:
        """Device-rate capture -> modem rate, streaming (whole M-groups
        per call; the remainder carries to the next chunk)."""
        if rs is None:
            return pcm16
        rs["buf"] = np.concatenate([rs["buf"],
                                    pcm16.astype(np.float32)])
        n = rs["buf"].size - (rs["buf"].size % rs["m"])
        if last and rs["buf"].size % rs["m"]:
            pad = rs["m"] - rs["buf"].size % rs["m"]
            rs["buf"] = np.concatenate([rs["buf"],
                                        np.zeros(pad, np.float32)])
            n = rs["buf"].size
        if n == 0:
            return np.zeros(0, np.int16)
        y, rs["state"] = resample_stream(jnp.asarray(rs["buf"][:n]),
                                         rs["state"], rs["l"], rs["m"])
        rs["buf"] = rs["buf"][n:]
        return np.clip(np.rint(np.asarray(y)), -32768, 32767).astype(
            np.int16)

    try:
        carry = b""
        while True:
            buf = src.read(2 * args.chunk)
            if not buf:
                break
            buf = carry + buf
            # pipes/truncated captures can end (or split) mid-sample:
            # carry the odd byte to the next read; a trailing odd byte at
            # EOF is a dropped partial sample, not a dead receiver
            carry = buf[len(buf) - (len(buf) % 2):]
            buf = buf[:len(buf) - (len(buf) % 2)]
            emit(demod.push(convert(np.frombuffer(buf, dtype="<i2"))))
        emit(demod.push(convert(np.zeros(0, np.int16), last=True)))
        if state_file:
            # checkpoint BEFORE flush: flush consumes partial frames the
            # resumed process would rather re-assemble with new samples
            demod.save(state_file)
        else:
            emit(demod.flush())
    finally:
        if src is not sys.stdin.buffer:
            src.close()
    c = demod.counters
    print(json.dumps({
        "frames": c.frames, "packets": npkts, "crc_ok": nok,
        "crc_failures": c.crc_failures, "resyncs": c.resyncs,
        "synced": c.synced,
        "detected_offset_hz": round(c.detected_offset_hz, 2),
        "carrier_snr_db": round(c.carrier_snr_db, 2),
        "carrier_detect": c.carrier_detect,
    }), file=sys.stderr)
    return 0


def cmd_rx(args) -> int:
    if args.stream:
        return _cmd_rx_stream(args)
    import jax.numpy as jnp

    from qpsk_tpu import rx_init
    from qpsk_tpu.metrics import per
    from qpsk_tpu.modem import rx_stream
    from qpsk_tpu.sync import (default_max_lag, extract_packets_tracked,
                               find_sync)

    cfg = _cfg(args)
    pcfg = _pcfg(args)
    if args.infile.endswith(".wav"):
        from qpsk_tpu.io import read_wav
        pcm, sr = read_wav(args.infile)
        if args.io_rate and int(args.io_rate) != sr:
            print(f"error: {args.infile} header says {sr} S/s but "
                  f"--io-rate {int(args.io_rate)} was given", file=sys.stderr)
            return 2
    else:
        import os
        from qpsk_tpu.io import SpoolReader
        sr = int(args.io_rate or cfg.fs)
        navail = os.path.getsize(args.infile) // (2 * cfg.frame_size)
        with SpoolReader(args.infile, cfg.frame_size) as r:
            pcm = r.read(max(navail, 1)).reshape(-1)
    if sr != int(cfg.fs):
        # device-rate capture: rate-convert down/up to the modem rate
        from qpsk_tpu.ops.resample import rational_ratio, resample_pcm
        try:
            rational_ratio(sr, cfg.fs)
        except ValueError:
            print(f"error: cannot resample {sr} -> {int(cfg.fs)} S/s "
                  "(not a small rational ratio)", file=sys.stderr)
            return 2
        pcm = np.asarray(resample_pcm(jnp.asarray(pcm), sr, cfg.fs))
    nframes = pcm.size // cfg.frame_size
    pcm = jnp.asarray(pcm[:nframes * cfg.frame_size].reshape(nframes,
                                                             cfg.frame_size))
    if nframes < 8:
        print(f"error: {args.infile} holds only {nframes} frames; packet "
              f"sync needs at least 8", file=sys.stderr)
        return 2
    acq = 0.0
    if cfg.modulation != "qpsk" and cfg.acquisition == "fft":
        from qpsk_tpu.modem import rx_acquire_hz
        from qpsk_tpu.ops.acquire import hz_to_costas_freq
        acq = hz_to_costas_freq(rx_acquire_hz(cfg, pcm.reshape(-1)), cfg.rs)
    _, out = rx_stream(cfg, rx_init(cfg, acq_freq=acq), pcm)
    bits = out.bits.ravel()
    skip = min(8, nframes // 4) * pcfg.frame_bits
    skip -= skip % cfg.bits_per_symbol   # symbol-aligned (generic family)
    sync = find_sync(pcfg, bits[skip:], max_lag=default_max_lag(pcfg),
                     probe_frames=8 if pcfg.fec else 4,
                     modulation=cfg.modulation)
    navail = (bits.size - skip - int(sync.bit_lag)) // pcfg.frame_bits
    rx = extract_packets_tracked(pcfg, bits[skip:], sync, navail,
                                 modulation=cfg.modulation)
    print(json.dumps({
        "frames": nframes,
        "detected_offset_hz": round(float(np.mean(np.asarray(out.freq_hz)[-10:])), 2),
        "sync_score": int(sync.score),
        "packets": navail,
        "per": round(float(per(rx.crc_ok)), 5),
    }))
    return 0


def cmd_fdm(args) -> int:
    """Multi-carrier loopback: C independent packet streams share one
    wideband via the polyphase-DFT bank (qpsk_tpu/fdm.py)."""
    import jax
    import jax.numpy as jnp

    from qpsk_tpu import rx_init, tx_init
    from qpsk_tpu.channel import awgn_pcm
    from qpsk_tpu.fdm import FdmConfig, fdm_demux, fdm_mux
    from qpsk_tpu.metrics import per
    from qpsk_tpu.modem import rx_stream, tx_stream
    from qpsk_tpu.ops.cplx import CF32
    from qpsk_tpu.ops.modmap import demod_soft
    from qpsk_tpu.packet import assemble_packet
    from qpsk_tpu.sync import (default_max_lag, extract_packets_soft_tracked,
                               extract_packets_tracked, find_sync)

    cfg = _cfg(args)
    pcfg = _pcfg(args)
    fcfg = FdmConfig(nslots=args.nslots, fs=cfg.fs)
    c_n = fcfg.nchan
    if args.frames < 8:
        print("error: --frames must be >= 8", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    payload = jnp.asarray(rng.integers(
        0, 2, (c_n, args.frames, 8 * pcfg.payload_bytes), dtype=np.int32))
    chan_bits = assemble_packet(pcfg, payload).reshape(c_n, -1)
    mfb = cfg.bits_per_frame       # whole symbol-aligned modem frames
    npad = (-chan_bits.shape[-1]) % mfb
    if npad:
        chan_bits = jnp.concatenate(
            [chan_bits, jnp.asarray(rng.integers(
                0, 2, (c_n, npad), dtype=np.int32))], axis=-1)
    _, pcm = tx_stream(cfg, tx_init(cfg, batch_shape=(c_n,)),
                       chan_bits.reshape(c_n, -1, mfb),
                       tx_offset_hz=args.offset_hz)
    wide = fdm_mux(fcfg, pcm.reshape(c_n, -1))
    if args.snr_db is not None:
        sp = float(jnp.mean((wide.astype(jnp.float32) / cfg.pcm_scale) ** 2))
        wide = awgn_pcm(jax.random.key(args.seed), wide,
                        snr_db=args.snr_db, signal_power=sp,
                        pcm_scale=cfg.pcm_scale)
    back = fdm_demux(fcfg, wide)
    npad = (-back.shape[-1]) % cfg.frame_size
    back = jnp.concatenate(
        [back, jnp.zeros((c_n, npad), back.dtype)], axis=-1)
    _, out = rx_stream(cfg, rx_init(cfg, batch_shape=(c_n,)),
                       back.reshape(c_n, -1, cfg.frame_size))
    chans = []
    skip = min(8, args.frames // 4) * pcfg.frame_bits
    skip -= skip % cfg.bits_per_symbol   # symbol-aligned (generic family)
    use_soft = args.fec and not cfg.differential
    for c in range(c_n):
        b = out.bits[c].ravel()
        sync = find_sync(pcfg, b[skip:], max_lag=default_max_lag(pcfg),
                         probe_frames=8 if pcfg.fec else 4,
                         modulation=cfg.modulation)
        navail = (b.size - skip - int(sync.bit_lag)) // pcfg.frame_bits
        if use_soft and cfg.modulation == "qpsk":
            # soft-decision extraction, like loopback (hard-input decode
            # would forfeit ~2 dB of the coded gain)
            llrs = demod_soft(CF32(out.symbols.re[c].reshape(-1),
                                   out.symbols.im[c].reshape(-1)))
            rx = extract_packets_soft_tracked(pcfg, llrs[skip:], sync,
                                              navail)
        elif use_soft:
            from qpsk_tpu.ops import modfam
            from qpsk_tpu.sync import extract_packets_soft_tracked_mod
            scores = modfam.symbol_scores(
                CF32(out.symbols.re[c].reshape(-1),
                     out.symbols.im[c].reshape(-1)),
                modfam.get(cfg.modulation), scale=cfg.agc_target)
            rx = extract_packets_soft_tracked_mod(
                pcfg, scores[skip // cfg.bits_per_symbol:], sync, navail,
                cfg.modulation)
        else:
            rx = extract_packets_tracked(pcfg, b[skip:], sync, navail,
                                         modulation=cfg.modulation)
        chans.append({
            "chan": c,
            "carrier_hz": fcfg.slot_center_hz(c, cfg.center),
            "sync_score": int(sync.score),
            "packets": navail,
            "per": round(float(per(rx.crc_ok)), 5),
            "detected_offset_hz": round(
                float(np.mean(np.asarray(out.freq_hz)[c, -10:])), 2),
        })
    print(json.dumps({"nslots": args.nslots, "nchan": c_n,
                      "wide_fs": fcfg.wide_fs, "snr_db": args.snr_db,
                      "channels": chans}))
    return 0


def main(argv=None) -> int:
    from qpsk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="qpsk_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("loopback", help="TX→channel→RX simulation")
    _add_common(lp)
    lp.add_argument("--snr-db", type=float, default=None,
                    help="AWGN SNR; omit for the reference's noiseless loop")
    lp.add_argument("--multipath", type=str, default=None,
                    help="static multipath paths as 'delay:gain,...' in "
                         "samples (e.g. '0:1.0,4:0.5'); pair with "
                         "--eq-taps to decode through it")
    lp.add_argument("--doppler", type=float, default=0.0,
                    help="carrier chirp rate, Hz/s (Doppler ramp stimulus)")
    lp.add_argument("--level-db", type=float, default=0.0,
                    help="RX-side level error in dB (e.g. -26 for a quiet "
                         "input); pair with --agc")
    lp.add_argument("--clock-ppm", type=float, default=0.0,
                    help="TX/RX sample-clock mismatch in ppm; pair with "
                         "--timing tracking")
    lp.add_argument("--impulse-rate", type=float, default=0.0,
                    help="impulsive interference bursts per second "
                         "(full-scale, 8-sample); pair with --fec")
    lp.add_argument("--phase-noise-hz", type=float, default=0.0,
                    help="TX oscillator phase-noise linewidth, Hz (Wiener "
                         "walk)")
    lp.add_argument("--scatter", type=str, default=None,
                    help="write a constellation PNG artifact")
    lp.set_defaults(fn=cmd_loopback)

    tx = sub.add_parser("tx", help="modulate packets to an int16 PCM file")
    _add_common(tx)
    tx.add_argument("--out", type=str, default="/tmp/qpsk_tpu_spool.raw",
                    help="output PCM path ('-' = stdout with --stream-in)")
    tx.add_argument("--stream-in", type=str, default=None,
                    help="push-mode modulation: read hex payload lines "
                         "(payload_bytes each) from this file ('-' = "
                         "stdin) and write raw int16 PCM to --out as "
                         "they arrive (filter/NCO state carried)")
    tx.add_argument("--io-rate", type=float, default=0.0,
                    help="device sample rate (e.g. 48000): write PCM at "
                         "this rate via the polyphase resampler (0 = modem "
                         "rate)")
    tx.set_defaults(fn=cmd_tx)

    rx = sub.add_parser("rx", help="demodulate an int16 PCM file")
    _add_common(rx)
    rx.add_argument("infile", type=str,
                    help="int16 PCM file ('-' = stdin with --stream)")
    rx.add_argument("--io-rate", type=float, default=0.0,
                    help="device sample rate of the input (raw files; WAV "
                         "carries its own): resampled to the modem rate")
    rx.add_argument("--stream", action="store_true",
                    help="push-mode decode (StreamDemodulator): read in "
                         "chunks, print one hex payload line per CRC-good "
                         "packet as it decodes, counters JSON to stderr")
    rx.add_argument("--squelch-db", type=float, default=None,
                    help="--stream carrier-detect squelch threshold (dB "
                         "blind SNR): dead-air bits are discarded, not "
                         "hunted")
    rx.add_argument("--state-file", type=str, default=None,
                    help="--stream checkpoint path: resumed at start if it "
                         "exists, written at input end (instead of a final "
                         "flush) — a restarted 24/7 receiver continues its "
                         "sync epoch mid-stream")
    rx.add_argument("--chunk", type=int, default=32768,
                    help="--stream read size in int16 samples")
    rx.set_defaults(fn=cmd_rx)

    def _sweep(a) -> int:
        from qpsk_tpu.eval import per_vs_snr
        from qpsk_tpu.packet import PacketConfig
        cfg = _cfg(a)
        # size the payload so one packet ~ one modem frame: uncoded frames
        # fill it exactly (payload + CRC16); coded frames halve the payload
        # for the rate-1/2 codes (conv adds 6 tail bits, so slightly under)
        bpf = cfg.bits_per_frame
        if a.fec == "conv":
            pb = (bpf // 2 - 16 - 6) // 8
        elif a.fec == "ldpc":
            pb = (bpf // 2 - 16) // 8
        else:
            pb = (bpf - 16) // 8
        pcfg = PacketConfig(payload_bytes=pb, fec=a.fec)
        try:
            snrs = [float(s) for s in a.snr_db.split(",")]
        except ValueError:
            print(f"error: --snr-db expects comma-separated numbers, "
                  f"got {a.snr_db!r}", file=sys.stderr)
            return 2
        for rec in per_vs_snr(cfg, pcfg, snrs, nframes=a.frames,
                              offset_hz=a.offset_hz, seed=a.seed):
            print(json.dumps(rec))
        return 0

    sw = sub.add_parser("sweep", help="PER/BER vs SNR curve")
    _add_common(sw)
    sw.add_argument("--snr-db", type=str, default="0,3,6,9,12",
                    help="comma-separated SNR points")
    sw.set_defaults(fn=_sweep)

    fd = sub.add_parser("fdm", help="multi-carrier wideband loopback")
    _add_common(fd)
    fd.add_argument("--nslots", type=int, default=8,
                    help="DFT bank size N; usable channels = N/2 - 1 "
                         "(wideband rate = N * fs)")
    fd.add_argument("--snr-db", type=float, default=None,
                    help="wideband AWGN SNR; omit for noiseless")
    fd.set_defaults(fn=cmd_fdm)

    def _bench(a) -> int:
        import jax

        from qpsk_tpu import benchmarks as B
        from qpsk_tpu.config import ModemConfig as _MC
        if jax.devices()[0].platform != "gpu":
            # the suites' default sizes are the GPU's operating points;
            # a CPU-sized run is not a device measurement
            print("bench: no GPU (JAX found "
                  f"{jax.devices()[0].platform!r})", file=sys.stderr)
            return 3
        suites = {
            "rx": B.rx_throughput,
            "tx": B.tx_throughput,
            "frontend": B.frontend_throughput,
            "costas": lambda: [B.costas_throughput("pallas"),
                               B.costas_throughput("scan")],
            "fec": lambda: [B.fec_throughput("conv"),
                            B.fec_throughput("ldpc")],
            # COMPOSED coded receive (demod + soft deframe + FEC in one
            # pipeline); the 8PSK+LDPC row is the high-rate coded link
            "coded": lambda: [B.coded_rx_throughput("conv"),
                              B.coded_rx_throughput("ldpc"),
                              B.coded_rx_throughput("ldpc",
                                                    modulation="8psk")],
            "serial": B.single_stream_serial_throughput,
            "blockparallel": B.single_stream_blockparallel_throughput,
            "fdm": B.fdm_throughput,
            # generic family end to end (DD Costas, 16QAM with the AGC)
            "modfam": lambda: [
                B.rx_throughput(cfg=_MC(modulation="8psk")),
                B.rx_throughput(cfg=_MC(modulation="16qam", agc=True))],
            # streaming push-to-packet latency (the real-time half)
            "latency": B.latency_benchmark,
        }
        if a.suite == "scaling":
            for rec in B.scaling_efficiency():
                print(json.dumps(rec))
            return 0
        names = list(suites) if a.suite == "all" else [a.suite]
        for name in names:
            recs = suites[name]()
            for rec in recs if isinstance(recs, list) else [recs]:
                print(json.dumps(rec))
        return 0

    be = sub.add_parser("bench", help="throughput benchmark")
    be.add_argument("--suite", type=str, default="rx",
                    choices=["rx", "tx", "frontend", "costas", "fec",
                             "coded", "serial", "blockparallel", "fdm",
                             "modfam", "latency", "scaling", "all"],
                    help="which benchmark to run (all = every throughput "
                         "suite; scaling = weak-scaling efficiency sweep)")
    be.set_defaults(fn=_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""Throughput benchmarks.

``rx_throughput`` measures the aggregate demod rate — RRC matched filter +
timing + decimation + Costas + slicing — in samples/second, channels on the
batch axis, (if >1 device) channel axis sharded over a 'dp' mesh.  The
other suites time TX, the front-end alone, the Costas loop alone, the FEC
decoders, the composed coded receive, the single stream, the FDM wideband
receive, weak scaling and streaming latency.

Measurement discipline:

* inputs are generated on the device (``jax.random``);
* each timed call chains ``inner`` steps in one ``lax.fori_loop`` with the
  state carried and the outputs checksummed into the carry, so nothing is
  dead-code-eliminated and one dispatch covers many steps;
* completion is ``jax.block_until_ready`` on the device-side checksum.

Default sizes are the GPU's operating points; off the GPU every size must
be passed explicitly (tests do, at toy sizes that check the harness, not a
device).  Every record names the device it ran on.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np


def _device() -> dict:
    """The device fields every record carries."""
    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind, "device_count": len(devs)}


def _size(value, gpu_default):
    """An explicit size, or the GPU operating point; off the GPU there is
    no default (a CPU-sized run is not a device measurement)."""
    if value is not None:
        return value
    if jax.devices()[0].platform != "gpu":
        raise ValueError(
            "benchmark sizes default to the GPU operating point; off the "
            f"GPU (platform {jax.devices()[0].platform!r}) pass every size")
    return gpu_default


def _time_chained(step, state0, x, iters: int, warmup: int = 3) -> float:
    """Wall time of ``iters`` chained step() dispatches after ``warmup``
    calls (compile, autotuning, clock ramp), ended by
    ``jax.block_until_ready`` on the last checksum."""
    for _ in range(warmup):
        _, chk = step(state0, x)
    jax.block_until_ready(chk)
    t0 = time.perf_counter()
    st = state0
    for _ in range(iters):
        st, chk = step(st, x)
    jax.block_until_ready(chk)
    return time.perf_counter() - t0


def tx_throughput(channels: int | None = None, frames: int | None = None,
                  iters: int | None = None, inner: int | None = None,
                  cfg=None) -> dict:
    """Aggregate TX modulation rate (mod + zero-stuff + RRC + mix + PCM)."""
    from qpsk_tpu import ModemConfig, tx_init
    from qpsk_tpu.modem import tx_stream

    cfg = cfg or ModemConfig()
    channels = _size(channels, 2048)
    frames = _size(frames, 16)
    iters = _size(iters, 60)
    inner = _size(inner, 10)
    nsym = cfg.symbols_per_frame
    nsamples = channels * frames * cfg.frame_size

    key = jax.random.key(0)
    bits = (jax.random.uniform(key, (channels, frames, 2 * nsym))
            < 0.5).astype(jnp.int32)
    state = tx_init(cfg, batch_shape=(channels,))

    @jax.jit
    def step(st, b):
        def body(_, carry):
            st, acc = carry
            st, pcm = tx_stream(cfg, st, b, tx_offset_hz=50.0)
            return st, acc + jnp.sum(pcm.astype(jnp.int32))
        st, acc = jax.lax.fori_loop(
            0, inner, body, (st, jnp.zeros((), jnp.int32)))
        return st, acc

    dt = _time_chained(step, state, bits, iters)
    sps = nsamples * inner * iters / dt
    return {"metric": "tx_mod_throughput", "value": round(sps, 1),
            "unit": "samples/s", **_device(), "channels": channels}


def rx_throughput(channels: int | None = None, frames: int | None = None,
                  iters: int | None = None, inner: int | None = None,
                  cfg=None) -> dict:
    from qpsk_tpu import ModemConfig, rx_init
    from qpsk_tpu.modem import rx_stream

    cfg = cfg or ModemConfig()
    ndev = len(jax.devices())
    # operating point: 8192 channels x 8 frames (README)
    channels = _size(channels, 8192)
    frames = _size(frames, 8)
    iters = _size(iters, 60)
    inner = _size(inner, 10)
    nsamples = channels * frames * cfg.frame_size

    key = jax.random.key(0)
    pcm = (jax.random.normal(key, (channels, frames, cfg.frame_size))
           * 8000.0).astype(jnp.int16)
    state = rx_init(cfg, batch_shape=(channels,))

    def _chained(st, x, acc0=None):
        def body(_, carry):
            st, acc = carry
            st, out = rx_stream(cfg, st, x)
            return st, acc + jnp.sum(out.bits)
        if acc0 is None:
            acc0 = jnp.zeros((), jnp.int32)
        return jax.lax.fori_loop(0, inner, body, (st, acc0))

    if ndev > 1:
        from jax import shard_map
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        mesh = Mesh(np.asarray(jax.devices()), ("dp",))
        pcm = jax.device_put(pcm, NamedSharding(mesh, P("dp")))
        state = jax.device_put(state, NamedSharding(mesh, P("dp")))

        # shard_map, not just sharding annotations: the body traces with
        # LOCAL per-device shapes, so the Costas kernel launches per card
        # with no cross-device partitioning questions (channels are
        # independent; the only collective is the checksum psum) — the
        # same discipline as parallel.channels.make_channel_demod
        def sharded(st, x):
            # the checksum carry becomes device-varying on the first add;
            # the fori carry type must start that way (shard-map VMA rule)
            acc0 = jax.lax.pcast(jnp.zeros((), jnp.int32), ("dp",),
                                 to="varying")
            st, acc = _chained(st, x, acc0)
            return st, jax.lax.psum(acc, "dp")

        step = jax.jit(shard_map(sharded, mesh=mesh,
                                 in_specs=(P("dp"), P("dp")),
                                 out_specs=(P("dp"), P())))
    else:
        step = jax.jit(_chained)

    dt = _time_chained(step, state, pcm, iters)
    sps = nsamples * inner * iters / dt
    rec = {
        "metric": "rx_demod_throughput",
        "value": round(sps, 1),
        "unit": "samples/s",
        **_device(),
        "channels": channels,
        "frames": frames,
    }
    if cfg.modulation != "qpsk":
        rec["modulation"] = cfg.modulation
    return rec


def frontend_throughput(channels: int | None = None,
                        frames: int | None = None, iters: int | None = None,
                        inner: int | None = None) -> dict:
    """Front-end-only rate (``modem.frontend_xla``: int16 -> modulated-taps
    FIR -> timing -> decimate).  On a device with published peaks
    (utils/roofline.PEAKS) the measured-vs-roofline record is attached."""
    from qpsk_tpu import ModemConfig, rx_init
    from qpsk_tpu.modem import frontend_xla
    from qpsk_tpu.utils import roofline

    cfg = ModemConfig()
    channels = _size(channels, 8192)
    frames = _size(frames, 8)
    iters = _size(iters, 60)
    inner = _size(inner, 10)
    nsamples = channels * frames * cfg.frame_size

    pcm = (jax.random.normal(jax.random.key(0),
                             (channels, frames, cfg.frame_size))
           * 8000.0).astype(jnp.int16)
    st = rx_init(cfg, batch_shape=(channels,))
    state0 = (st.nco_phase, st.fir_tail)

    @jax.jit
    def step(carry, x):
        def body(_, carry):
            (phase, tail), acc = carry
            picks, idx, phase, tail = frontend_xla(cfg, x, phase, tail)
            return (phase, tail), acc + jnp.sum(picks.re) + jnp.sum(
                idx.astype(jnp.float32))
        return jax.lax.fori_loop(0, inner, body,
                                 (carry, jnp.zeros((), jnp.float32)))

    dt = _time_chained(step, state0, pcm, iters)
    per_pass = dt / (inner * iters)
    rec = {"metric": "frontend_throughput",
           "value": round(nsamples * inner * iters / dt, 1),
           "unit": "samples/s", **_device(), "channels": channels}
    kind = jax.devices()[0].device_kind
    if kind in roofline.PEAKS:
        rec["roofline"] = roofline.frontend_report(
            cfg, channels, frames, per_pass, roofline.peaks_for(kind))
    return rec


def fdm_throughput(nslots: int | None = None, frames: int | None = None,
                   iters: int | None = None, inner: int | None = None) -> dict:
    """Full wideband receive rate: polyphase-DFT analysis filterbank
    (``fdm_demux_stream``) + the batched modem RX over every subchannel,
    in WIDEBAND samples/second (the rate the antenna-side stream runs
    at).  The subchannel axis rides the modem's ordinary channel batch
    (nchan = nslots/2 - 1 real slots)."""
    from qpsk_tpu import ModemConfig, rx_init
    from qpsk_tpu.fdm import FdmConfig, fdm_demux_stream, fdm_init
    from qpsk_tpu.modem import rx_stream

    cfg = ModemConfig()
    nslots = _size(nslots, 2048)
    frames = _size(frames, 8)
    iters = _size(iters, 40)
    inner = _size(inner, 8)
    fcfg = FdmConfig(nslots=nslots)
    nchan = fcfg.nchan
    nwide = nslots * frames * cfg.frame_size

    wide = (jax.random.normal(jax.random.key(0), (nwide,))
            * 8000.0).astype(jnp.int16)
    state0 = (fdm_init(fcfg), rx_init(cfg, batch_shape=(nchan,)))

    @jax.jit
    def step(st, w):
        def body(_, carry):
            (fst, rst), acc = carry
            chans, fst = fdm_demux_stream(fcfg, w, fst)
            rst, out = rx_stream(
                cfg, rst, chans.reshape(nchan, frames, cfg.frame_size))
            return (fst, rst), acc + jnp.sum(out.bits)
        return jax.lax.fori_loop(0, inner, body,
                                 (st, jnp.zeros((), jnp.int32)))

    dt = _time_chained(step, state0, wide, iters)
    sps = nwide * inner * iters / dt

    # decomposition (the bound record every other headline row carries):
    # filterbank-only and modem-only twins at the same shapes, same
    # process — names whether the wideband rate is bound by the
    # polyphase-DFT analysis bank or by the under-occupied modem batch
    # (nchan = nslots/2 - 1 channels)
    @jax.jit
    def step_fb(st, w):
        def body(_, carry):
            fst, acc = carry
            chans, fst = fdm_demux_stream(fcfg, w, fst)
            return fst, acc + jnp.sum(chans[:, -1])
        return jax.lax.fori_loop(0, inner, body,
                                 (st, jnp.zeros((), jnp.float32)))

    chans0, _ = fdm_demux_stream(fcfg, wide, fdm_init(fcfg))
    chans0 = chans0.reshape(nchan, frames, cfg.frame_size)

    @jax.jit
    def step_md(st, ch):
        def body(_, carry):
            rst, acc = carry
            rst, out = rx_stream(cfg, rst, ch)
            return rst, acc + jnp.sum(out.bits)
        return jax.lax.fori_loop(0, inner, body,
                                 (st, jnp.zeros((), jnp.int32)))

    dt_fb = _time_chained(step_fb, fdm_init(fcfg), wide, iters)
    dt_md = _time_chained(step_md, rx_init(cfg, batch_shape=(nchan,)),
                          chans0, iters)
    fb_frac = dt_fb / (dt_fb + dt_md)
    rec = {"metric": "fdm_wideband_throughput", "value": round(sps, 1),
           "unit": "wide_samples/s", **_device(),
           "nslots": nslots, "nchan": nchan}
    rec["fdm"] = {
        "fb_only_gsps": round(nwide * inner * iters / dt_fb / 1e9, 4),
        "modem_only_gsps": round(nwide * inner * iters / dt_md / 1e9, 4),
        "composed_gsps": round(sps / 1e9, 4),
        "fb_fraction": round(fb_frac, 3),
        "bound": "filterbank" if fb_frac > 0.5 else "modem-batch",
    }
    return rec


def costas_throughput(impl: str = "pallas", channels: int | None = None,
                      nsym: int | None = None, iters: int | None = None,
                      inner: int | None = None,
                      interpret: bool = False) -> dict:
    """Costas-loop-only rate in *symbols*/second for one lowering
    (``impl`` = "pallas" fused kernel on time-major planes / "scan"
    lax.scan).  Channels are parallel; the recurrence is the serial axis.
    ``interpret`` runs the kernel in Pallas interpret mode (tests)."""
    from qpsk_tpu.ops.costas import costas_init, costas_params, costas_run
    from qpsk_tpu.ops.cplx import CF32

    channels = _size(channels, 8192)
    nsym = _size(nsym, 1024)
    iters = _size(iters, 60)
    inner = _size(inner, 10)

    kr, ki = jax.random.split(jax.random.key(0))
    params = costas_params(loop_bw=2.0 * np.pi / 100.0)
    state0 = costas_init(batch_shape=(channels,))

    if impl == "pallas":
        from qpsk_tpu.ops.pallas.costas_kernel import costas_run_tm
        z = (jax.random.normal(kr, (nsym, channels), jnp.float32),
             jax.random.normal(ki, (nsym, channels), jnp.float32))

        def run(st, z):
            st, out, _ = costas_run_tm(st, z[0], z[1], params,
                                       trace_every=nsym, interpret=interpret)
            return st, out.re[-1]
    else:
        z = CF32(jax.random.normal(kr, (channels, nsym), jnp.float32),
                 jax.random.normal(ki, (channels, nsym), jnp.float32))

        def run(st, z):
            st, out = costas_run(st, z, params)
            return st, out.re[..., -1]

    @jax.jit
    def step(st, z):
        def body(_, carry):
            st, acc = carry
            st, last = run(st, z)
            return st, acc + jnp.sum(last)
        return jax.lax.fori_loop(0, inner, body,
                                 (st, jnp.zeros((), jnp.float32)))

    dt = _time_chained(step, state0, z, iters)
    sps = channels * nsym * inner * iters / dt
    rec = {"metric": f"costas_throughput_{impl}", "value": round(sps, 1),
           "unit": "symbols/s", **_device(),
           "channels": channels, "nsym": nsym}
    if impl == "pallas" and not interpret:
        from qpsk_tpu.utils.roofline import costas_report
        rec["costas"] = costas_report(channels, nsym,
                                      measured_pass_s=dt / (iters * inner))
    return rec


def fec_throughput(kind: str = "conv", packets: int | None = None,
                   iters: int | None = None, inner: int | None = None) -> dict:
    """Soft-decision FEC decoder rate in *information bits*/second at the
    packet sizes the frame pipeline actually uses (one coded packet = one
    256-symbol frame, cf. cli sweep sizing), packets batched on the leading
    axis.  ``kind`` = "conv" (K=7 soft Viterbi) or "ldpc" (IRA min-sum).
    The coded RX chain is demod + this: at 2400 baud a real-time channel
    needs 2400 info-bit/s, so value/2400 ~ the number of coded channels one
    device can decode live."""
    packets = _size(packets, 4096)
    iters = _size(iters, 30)
    inner = _size(inner, 4)

    key = jax.random.key(0)
    if kind == "conv":
        from qpsk_tpu.packet.fec import ConvCode, viterbi_decode
        code = ConvCode()
        nbits = 256          # the pipeline's decode: payload+CRC of a
        nllr = code.coded_bits(nbits)   # 30-byte packet (frame.py)
        llrs = jax.random.normal(key, (packets, nllr), jnp.float32)

        def decode(l):
            return viterbi_decode(code, l, nbits)
    elif kind == "ldpc":
        from qpsk_tpu.packet.ldpc import LdpcCode, ldpc_decode
        code = LdpcCode(k=256)           # one 512-bit frame codeword
        nbits = code.k
        llrs = jax.random.normal(key, (packets, code.n), jnp.float32)

        def decode(l):
            return ldpc_decode(code, l)
    else:
        raise ValueError(f"unknown FEC kind {kind!r}")

    @jax.jit
    def step(acc, l):
        def body(i, a):
            # vary the input with the carry so the inner decodes can't be
            # collapsed into one
            bits = decode(l + a.astype(jnp.float32) * 1e-9)
            return a + jnp.sum(bits)
        acc = jax.lax.fori_loop(0, inner, body, acc)
        return acc, acc

    dt = _time_chained(step, jnp.zeros((), jnp.int32), llrs, iters)
    bps = packets * nbits * inner * iters / dt
    rec = {"metric": f"fec_throughput_{kind}", "value": round(bps, 1),
           "unit": "info_bits/s", **_device(),
           "packets": packets, "nbits": nbits}
    return rec


def coded_rx_throughput(kind: str = "conv", channels: int | None = None,
                        frames: int | None = None, iters: int | None = None,
                        inner: int | None = None,
                        payload_bytes: int = 30,
                        modulation: str = "qpsk") -> dict:
    """COMPOSED coded receive rate: FE + Costas + soft LLRs + deframe +
    FEC decode in ONE timed pipeline, in input samples/second.

    The isolated demod and FEC rows do not say which one bounds a coded
    link; this row measures the composed number and attaches the
    decomposition (same-process demod-only time vs composed time) so the
    bound is a regenerable fact.

    Every demodulated bit is decoded: the pass's LLR stream is reshaped
    into ceil(bits/frame_bits) packets (the final packet zero-padded), so
    decode work is never undercounted.  Random PCM is fine — Viterbi and
    min-sum run fixed-iteration schedules, so the work is data-independent.
    """
    from qpsk_tpu import ModemConfig, rx_init
    from qpsk_tpu.modem import rx_stream
    from qpsk_tpu.ops.cplx import CF32
    from qpsk_tpu.ops.modmap import demod_soft
    from qpsk_tpu.packet.frame import PacketConfig, disassemble_packet_soft

    cfg = ModemConfig(modulation=modulation, agc=(modulation == "16qam"))
    pcfg = PacketConfig(payload_bytes=payload_bytes, fec=kind)
    # 1024 channels: the FEC batch lands near fec_throughput's 4096-packet
    # shape
    channels = _size(channels, 1024)
    frames = _size(frames, 8)
    iters = _size(iters, 20)
    inner = _size(inner, 4)
    fsz = cfg.frame_size
    nsym = fsz // cfg.cycles
    nsamples = channels * frames * fsz
    fb = pcfg.frame_bits
    total_bits = channels * frames * nsym * cfg.bits_per_symbol
    npkt = -(-total_bits // fb)                   # ceil
    pad = npkt * fb - total_bits

    pcm = (jax.random.normal(jax.random.key(0), (channels, frames, fsz))
           * 8000.0).astype(jnp.int16)
    state = rx_init(cfg, batch_shape=(channels,))

    def composed(st, x, acc):
        st, out = rx_stream(cfg, st, x)
        sym = CF32(out.symbols.re.reshape(-1), out.symbols.im.reshape(-1))
        if modulation == "qpsk":
            llr = demod_soft(sym)
        else:
            # generic-family soft path: score matrix -> max-log LLRs
            from qpsk_tpu.ops import modfam
            m = modfam.get(modulation)
            llr = modfam.soft_from_scores(
                modfam.symbol_scores(sym, m, scale=cfg.agc_target), m)
        llr = jnp.concatenate([llr, jnp.zeros((pad,), jnp.float32)])
        rx = disassemble_packet_soft(pcfg, llr.reshape(npkt, fb))
        return st, acc + jnp.sum(rx.payload_bits) + jnp.sum(
            rx.crc_ok.astype(jnp.int32))

    @jax.jit
    def step(st, x):
        def body(_, carry):
            st, acc = carry
            return composed(st, x, acc)
        return jax.lax.fori_loop(0, inner, body,
                                 (st, jnp.zeros((), jnp.int32)))

    # demod-only twin at the SAME shapes in the same process — the
    # decomposition that names the bound
    @jax.jit
    def step_demod(st, x):
        def body(_, carry):
            st, acc = carry
            st, out = rx_stream(cfg, st, x)
            return st, acc + jnp.sum(out.bits)
        return jax.lax.fori_loop(0, inner, body,
                                 (st, jnp.zeros((), jnp.int32)))

    dt = _time_chained(step, state, pcm, iters)
    dt_demod = _time_chained(step_demod, state, pcm, iters)
    sps = nsamples * inner * iters / dt
    info_bps = npkt * 8 * payload_bytes * inner * iters / dt
    fec_s = max(dt - dt_demod, 0.0) / (iters * inner)
    suffix = kind if modulation == "qpsk" else f"{kind}_{modulation}"
    rec = {"metric": f"coded_rx_throughput_{suffix}",
           "value": round(sps, 1), "unit": "samples/s",
           **_device(), "channels": channels,
           "info_bits_per_s": round(info_bps, 1),
           "packets_per_pass": int(npkt),
           "demod_only_gsps": round(nsamples * inner * iters / dt_demod
                                    / 1e9, 2),
           "composed_gsps": round(sps / 1e9, 2),
           "fec_slowdown_x": round(dt / dt_demod, 1),
           "fec_fraction": round((dt - dt_demod) / dt, 3),
           "bound": "fec-decoder" if dt > 2 * dt_demod else "demod"}
    return rec


def single_stream_serial_throughput(frames: int | None = None,
                                    iters: int | None = None,
                                    inner: int | None = None) -> dict:
    """Single-stream demod rate: ONE channel, the Costas recurrence still
    strictly sequential — the rate a lone stream gets without
    block-parallelism (the serialization SURVEY.md §7 names hard-part #1;
    cf. the per-symbol loop qpsk.c:196-212)."""
    from qpsk_tpu import ModemConfig, rx_init
    from qpsk_tpu.modem import rx_stream

    cfg = ModemConfig()
    frames = _size(frames, 64)
    iters = _size(iters, 15)
    inner = _size(inner, 4)
    nsamples = frames * cfg.frame_size

    pcm = (jax.random.normal(jax.random.key(0), (frames, cfg.frame_size))
           * 8000.0).astype(jnp.int16)
    state = rx_init(cfg)

    @jax.jit
    def step(st, x):
        def body(_, carry):
            st, acc = carry
            st, out = rx_stream(cfg, st, x)
            return st, acc + jnp.sum(out.bits)
        return jax.lax.fori_loop(0, inner, body,
                                 (st, jnp.zeros((), jnp.int32)))

    dt = _time_chained(step, state, pcm, iters)
    sps = nsamples * inner * iters / dt
    return {"metric": "single_stream_serial_throughput",
            "value": round(sps, 1), "unit": "samples/s",
            **_device(), "frames": frames}


def single_stream_blockparallel_throughput(frames: int | None = None,
                                           nblocks: int | None = None,
                                           iters: int | None = None,
                                           inner: int | None = None) -> dict:
    """Block-parallel single-stream rate: the Costas loop split into
    re-acquiring overlap blocks riding the batch axis
    (parallel/blocks.py) — the single-stream serialization breaker."""
    from qpsk_tpu import ModemConfig
    from qpsk_tpu.parallel.blocks import rx_stream_blockparallel

    cfg = ModemConfig()
    frames = _size(frames, 512)
    nblocks = _size(nblocks, 128)
    iters = _size(iters, 60)
    inner = _size(inner, 8)
    nsamples = frames * cfg.frame_size

    pcm = (jax.random.normal(jax.random.key(0), (frames, cfg.frame_size))
           * 8000.0).astype(jnp.int16)

    @jax.jit
    def chained(acc, x):
        def body(_, a):
            # perturb the input with the carry so the body is NOT
            # loop-invariant — otherwise XLA's while-loop invariant code
            # motion hoists the whole demod out and the loop measures
            # nothing (caught in review: the un-perturbed form reported
            # inner-times the real rate)
            xx = x + (a & 1).astype(jnp.int16)
            _, bits, _ = rx_stream_blockparallel(cfg, xx, nblocks)
            return a + jnp.sum(bits)
        acc = jax.lax.fori_loop(0, inner, body, acc)
        return acc, acc

    dt = _time_chained(chained, jnp.zeros((), jnp.int32), pcm, iters)
    sps = nsamples * inner * iters / dt
    return {"metric": "single_stream_blockparallel_throughput",
            "value": round(sps, 1), "unit": "samples/s",
            **_device(), "frames": frames, "nblocks": nblocks}


def scaling_efficiency(device_counts=None, channels_per_device: int = 8,
                       frames: int = 8, iters: int = 3,
                       inner: int = 2, modes=("dp", "sp")) -> list[dict]:
    """Weak-scaling sweep over the mesh (BASELINE.md ≥80 % target).

    Two parallel axes, each measured at 1..N devices with the per-device
    work held constant (weak scaling: perfect = flat time, efficiency =
    T1/TN):

    * ``dp`` — independent channels sharded over the mesh (config #4);
    * ``sp`` — one long stream in time blocks with the ppermute FIR-halo
      exchange (config #5, parallel/stream.py).

    Returns one record per (mode, devices); the same harness runs
    unchanged on a real multi-chip mesh.  CPU-mesh numbers rehearse the
    procedure and catch sharding regressions, not silicon truth.
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from qpsk_tpu import ModemConfig, rx_init
    from qpsk_tpu.modem import rx_stream
    from qpsk_tpu.parallel.stream import rx_stream_timeparallel

    cfg = ModemConfig()
    devs = jax.devices()
    counts = list(device_counts or
                  [n for n in (1, 2, 4, 8) if n <= len(devs)])
    records = []

    # --- dp: weak scaling over channels ---
    for n in counts if "dp" in modes else ():
        mesh = Mesh(np.asarray(devs[:n]), ("dp",))
        sh = NamedSharding(mesh, P("dp"))
        channels = channels_per_device * n
        pcm = (jax.random.normal(jax.random.key(0),
                                 (channels, frames, cfg.frame_size))
               * 8000.0).astype(jnp.int16)
        pcm = jax.device_put(pcm, sh)
        state = jax.device_put(rx_init(cfg, batch_shape=(channels,)), sh)

        @jax.jit
        def step(st, x):
            def body(_, carry):
                st, acc = carry
                st, out = rx_stream(cfg, st, x)
                return st, acc + jnp.sum(out.bits)
            return jax.lax.fori_loop(0, inner, body,
                                     (st, jnp.zeros((), jnp.int32)))

        dt = _time_chained(step, state, pcm, iters)
        nsamples = channels * frames * cfg.frame_size * inner * iters
        records.append({"mode": "dp", "devices": n, "channels": channels,
                        "time_s": round(dt, 4),
                        "throughput_sps": round(nsamples / dt, 1)})

    # --- sp: weak scaling over stream length ---
    for n in counts if "sp" in modes else ():
        mesh = Mesh(np.asarray(devs[:n]), ("sp",))
        nsamp = n * frames * cfg.frame_size
        pcm = (jax.random.normal(jax.random.key(1), (nsamp,))
               * 8000.0).astype(jnp.int16)

        @jax.jit
        def step(acc, x):
            _, bits, _ = rx_stream_timeparallel(cfg, x, mesh)
            acc = acc + jnp.sum(bits)
            return acc, acc

        dt = _time_chained(step, jnp.zeros((), jnp.int32), pcm, iters)
        records.append({"mode": "sp", "devices": n, "samples": nsamp,
                        "time_s": round(dt, 4),
                        "throughput_sps": round(nsamp * iters / dt, 1)})

    # weak-scaling efficiency vs the 1-device time of the same mode
    t1 = {m: next(r["time_s"] for r in records
                  if r["mode"] == m and r["devices"] == counts[0])
          for m in modes}
    for r in records:
        r["efficiency"] = round(t1[r["mode"]] / r["time_s"], 3)
        r.update(_device())
    return records


# a small-message NCCL collective between cards of one NVLink host: an
# assumption for the sp bound, not a measurement
NVLINK_ASSUMED_LATENCY_S = 10e-6


def sp_bound_record(device_counts=(1, 2, 4), frames: int = 64,
                    iters: int = 30) -> list[dict]:
    """Measure the FIXED per-launch cost of the sp halo exchange and
    compute the efficiency bound it implies — the decomposition-backed
    record behind the sp weak-scaling rows (VERDICT r4 #3).

    Two microbenches per device count, identical except for the
    collective: a shard_map launch whose body does one ppermute of an
    (ntaps-1)-sample tail plus a trivial reduce, and the same body with
    the ppermute replaced by a local copy.  Their difference isolates the
    per-launch collective/sync constant ``t_fixed(n)`` (on the CPU
    backend this is thread wakeup + barrier, not bandwidth — the halo is
    ~1 KB).  The record then computes:

    * ``eff_bound`` — t_block / (t_block + t_fixed) with t_block the
      measured per-device block time of the real sp body at the
      operating size: the ceiling the CPU mesh allows, independent of
      this host's run-to-run noise;
    * ``real_mesh_eff`` — the same bound with the halo exchange priced
      for NVLink (an ASSUMED ~10 us small-message collective latency +
      the halo at 450 GB/s, not measured) against the measured block
      time: the halo term vanishes at production block sizes.
    """
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    from qpsk_tpu import ModemConfig
    from qpsk_tpu.parallel.stream import rx_stream_timeparallel

    cfg = ModemConfig()
    devs = jax.devices()
    ntm1 = cfg.ntaps - 1
    records = []
    for n in device_counts:
        if n > len(devs):
            continue
        mesh = Mesh(np.asarray(devs[:n]), ("sp",))
        tails = jax.random.normal(jax.random.key(0), (n, ntm1), jnp.float32)

        def body_coll(t):
            perm = [(i, i + 1) for i in range(n - 1)]
            h = jax.lax.ppermute(t, "sp", perm)
            return jnp.sum(h, keepdims=True)

        def body_local(t):
            return jnp.sum(t * 1.0000001, keepdims=True)

        def timed(body):
            fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("sp"),),
                                   out_specs=P("sp")))

            def step(acc, t):
                out = fn(t + acc)
                return out, jnp.sum(out)
            return _time_chained(step, jnp.zeros((n, 1), jnp.float32),
                                 tails, iters) / iters

        t_coll = timed(body_coll)
        t_local = timed(body_local)
        t_fixed = max(t_coll - t_local, 0.0)

        # the real sp body at the operating size, per launch
        nsamp = n * frames * cfg.frame_size

        @jax.jit
        def step(acc, x):
            _, bits, _ = rx_stream_timeparallel(cfg, x, mesh)
            return acc + jnp.sum(bits), acc

        pcm = (jax.random.normal(jax.random.key(1), (nsamp,))
               * 8000.0).astype(jnp.int16)
        t_block = _time_chained(step, jnp.zeros((), jnp.int32), pcm,
                                max(iters // 3, 3)) / max(iters // 3, 3)
        # NVLink: assumed small-message collective latency + halo bytes
        link_fixed = NVLINK_ASSUMED_LATENCY_S + (8.0 * ntm1) / 450e9
        records.append({
            "mode": "sp_bound", "devices": n,
            "t_launch_collective_s": round(t_coll, 6),
            "t_launch_local_s": round(t_local, 6),
            "t_fixed_s": round(t_fixed, 6),
            "t_block_s": round(t_block, 6),
            "eff_bound": round(t_block / (t_block + t_fixed), 3),
            "real_mesh_eff": round(t_block / (t_block + link_fixed), 5),
            "nvlink_assumed_fixed_s": link_fixed,
            **_device(), "frames_per_dev": frames,
        })
    return records


def latency_benchmark(bucket_frames: int | None = None,
                      sync_skip_frames: int | None = None,
                      probe_frames: int | None = None,
                      chunk: int | None = None, snr_db: float = 10.0,
                      npkts: int = 80, seed: int = 0,
                      cfg=None, pcfg=None) -> dict:
    """Streaming push-to-packet latency — the other half of real-time
    performance (the reference is a 9600 S/s real-time modem,
    qpsk.c:344-355; throughput alone doesn't say whether a receiver is
    *usable* live).

    Feeds a TX->AWGN packet stream into a fresh ``StreamDemodulator`` in
    ``chunk``-sample pushes (default 480 samples = 50 ms of live audio at
    9600 S/s) and measures:

    * **cold_latency_s** — stream samples consumed before the FIRST packet
      emerges, in seconds of air time at fs.  This is the algorithmic
      cold-start: bucket quantization + post-onset transient skip
      (``sync_skip_frames``) + the CRC hunt's probe window.  Independent
      of host speed.
    * **skipped_packets** — how many leading TX packets the cold start
      consumed (the first decoded payload's TX index).
    * **proc_p50_ms / proc_p99_ms** — wall-clock compute per push at
      steady state (post-sync), the jitter a real-time caller sees.
    * **realtime_factor** — stream air time / total compute time (>1
      means the receiver keeps up live).
    * **steady_buffer_s** — the steady-state buffering latency floor,
      ``bucket_frames * frame_size / fs`` (a packet's last bit waits for
      its bucket to fill before demodulation can see it).

    All decoded payloads are verified bit-exact against TX as a guard —
    a latency number from a broken decode would be meaningless.
    """
    from qpsk_tpu import ModemConfig, tx_init
    from qpsk_tpu.channel import awgn_pcm
    from qpsk_tpu.modem import tx_stream
    from qpsk_tpu.packet import PacketConfig, assemble_packet
    from qpsk_tpu.runtime import StreamDemodulator

    cfg = cfg or ModemConfig()
    pcfg = pcfg or PacketConfig(payload_bytes=30)
    bucket_frames = bucket_frames or 8
    # mirror the StreamDemodulator defaults (runtime.py): skip=2 is the
    # round-4 default chosen FROM this benchmark's sweep
    sync_skip_frames = 2 if sync_skip_frames is None else sync_skip_frames
    probe_frames = probe_frames or 4
    chunk = chunk or 480

    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (npkts, 8 * pcfg.payload_bytes),
                           dtype=np.int32)
    chan = assemble_packet(pcfg, jnp.asarray(payload)).ravel()
    mfb = cfg.bits_per_frame
    npad = (-chan.size) % mfb
    if npad:
        chan = jnp.concatenate(
            [chan, jnp.asarray(rng.integers(0, 2, (npad,), np.int32))])
    _, pcm = tx_stream(cfg, tx_init(cfg), chan.reshape(-1, mfb),
                       tx_offset_hz=50.0)
    sp = float(jnp.mean((pcm.astype(jnp.float32) / cfg.pcm_scale) ** 2))
    pcm = np.asarray(awgn_pcm(jax.random.key(seed), pcm, snr_db=snr_db,
                              signal_power=sp)).ravel()

    def run(stream):
        d = StreamDemodulator(cfg, pcfg, bucket_frames=bucket_frames,
                              sync_skip_frames=sync_skip_frames,
                              probe_frames=probe_frames)
        p = 0
        while p < stream.size:
            d.push(stream[p:p + chunk])
            p += chunk
        d.flush()

    # warmup pass: compile every shape the stream will exercise (rx bucket,
    # acquisition, the drain's disassembly widths) so the timed pass
    # measures dispatch + compute, not compiles
    run(pcm)

    demod = StreamDemodulator(cfg, pcfg, bucket_frames=bucket_frames,
                              sync_skip_frames=sync_skip_frames,
                              probe_frames=probe_frames)
    first_at = None          # samples consumed when the first packet emerged
    first_wall = None        # compute seconds spent up to that point
    push_times = []          # (pos, wall_s) per push
    got = []
    pos = 0
    wall = 0.0
    while pos < pcm.size:
        t0 = time.perf_counter()
        pkts = demod.push(pcm[pos:pos + chunk])
        dt = time.perf_counter() - t0
        pos += chunk
        wall += dt
        push_times.append((pos, dt, bool(demod.counters.synced)))
        got.extend(pkts)
        if first_at is None and pkts:
            first_at, first_wall = pos, wall
    got.extend(demod.flush())

    wanted = {p.tobytes(): i for i, p in enumerate(payload.astype(np.uint8))}
    ok = [p for p in got if p.crc_ok]
    assert ok, "no packets decoded - latency undefined"
    for p in ok:
        assert p.payload.astype(np.uint8).tobytes() in wanted
    skipped = wanted[ok[0].payload.astype(np.uint8).tobytes()]

    steady = sorted(dt for _, dt, synced in push_times if synced)
    if not steady:
        steady = sorted(dt for _, dt, _ in push_times)
    p50 = steady[len(steady) // 2]
    p99 = steady[min(len(steady) - 1, int(len(steady) * 0.99))]
    stream_s = pcm.size / cfg.fs
    return {"metric": "streaming_latency", "unit": "s",
            "value": round(first_at / cfg.fs, 4),
            "cold_latency_s": round(first_at / cfg.fs, 4),
            "cold_compute_s": round(first_wall, 4),
            "skipped_packets": int(skipped),
            "decoded": len(ok), "sent": npkts,
            "proc_p50_ms": round(1e3 * p50, 3),
            "proc_p99_ms": round(1e3 * p99, 3),
            "realtime_factor": round(stream_s / wall, 2),
            "steady_buffer_s": round(
                bucket_frames * cfg.frame_size / cfg.fs, 4),
            "bucket_frames": bucket_frames,
            "sync_skip_frames": sync_skip_frames,
            "probe_frames": probe_frames, "chunk": chunk,
            "snr_db": snr_db, **_device()}


def sp_scaling_decomposition(device_counts=(1, 2, 4),
                             frames_per_dev=(16, 64),
                             iters: int = 8) -> list[dict]:
    """Decompose the sp (time-parallel) weak-scaling inefficiency.

    The round-3 artifact read sp efficiency ~0.76 at 2-4 devices (below
    the >=0.8 BASELINE target) with no attribution.  This measures, at
    each device count and TWO workload sizes:

    * ``sp_full``     — rx_stream_timeparallel (halo exchange + per-block
                        FFT re-acquisition + Costas + slicer);
    * ``sp_frontend`` — rx_frontend_timeparallel (the halo exchange and
                        filter only — bit-identical to serial, no
                        acquisition/loop);
    * ``block_rest``  — derived full-minus-frontend time: per-block work
                        with NO communication at all (acquisition + scan
                        + slicing are block-local).

    Reading: if a component's efficiency rises with the larger workload,
    its deficit is a FIXED per-launch cost (collective setup / dispatch /
    sync) amortizing away — the expectation for a real-mesh run with
    production block sizes.  If it stays flat, the deficit scales with
    the work (bandwidth or serialization) and would survive on hardware.
    """
    from jax.sharding import Mesh

    from qpsk_tpu import ModemConfig
    from qpsk_tpu.parallel.stream import (rx_frontend_timeparallel,
                                          rx_stream_timeparallel)

    cfg = ModemConfig()
    devs = jax.devices()
    records = []
    for fpd in frames_per_dev:
        for n in device_counts:
            if n > len(devs):
                continue
            mesh = Mesh(np.asarray(devs[:n]), ("sp",))
            nsamp = n * fpd * cfg.frame_size
            pcm = (jax.random.normal(jax.random.key(1), (nsamp,))
                   * 8000.0).astype(jnp.int16)

            @jax.jit
            def full(acc, x):
                _, bits, _ = rx_stream_timeparallel(cfg, x, mesh)
                return acc + jnp.sum(bits), acc

            @jax.jit
            def frontend(acc, x):
                y = rx_frontend_timeparallel(cfg, x, mesh)
                return acc + jnp.sum(y.re[-8:]), acc

            t_full = _time_chained(
                lambda a, x: full(a, x), jnp.zeros((), jnp.int32), pcm,
                iters)
            t_fe = _time_chained(
                lambda a, x: frontend(a, x), jnp.zeros((), jnp.float32),
                pcm, iters)
            records.append({
                "mode": "sp_decomp", "devices": n, "frames_per_dev": fpd,
                "samples": nsamp,
                "t_full_s": round(t_full / iters, 5),
                "t_frontend_s": round(t_fe / iters, 5),
                "t_block_rest_s": round((t_full - t_fe) / iters, 5),
                **_device(),
            })
    # weak-scaling efficiency per component vs the 1-device row of the
    # same workload size
    for fpd in frames_per_dev:
        rows = [r for r in records if r["frames_per_dev"] == fpd]
        base = rows[0]
        for r in rows:
            for comp in ("t_full_s", "t_frontend_s", "t_block_rest_s"):
                r["eff_" + comp[2:-2]] = round(
                    base[comp] / max(r[comp], 1e-12), 3)
    return records

"""Benchmark-harness structure tests: every suite must run end-to-end on
the CPU mesh and emit the records the docs/driver consume (tiny, explicit
sizes — these validate the harness, not a device)."""

import numpy as np
import pytest

from qpsk_tpu.benchmarks import (costas_throughput, fec_throughput,
                                 frontend_throughput, rx_throughput,
                                 scaling_efficiency,
                                 single_stream_blockparallel_throughput,
                                 single_stream_serial_throughput,
                                 tx_throughput)


def test_rx_tx_throughput_records():
    for fn, metric in ((rx_throughput, "rx_demod_throughput"),
                       (tx_throughput, "tx_mod_throughput")):
        r = fn(channels=8, frames=2, iters=1, inner=1)
        assert r["metric"] == metric
        assert r["value"] > 0
        assert r["unit"] == "samples/s"


def test_single_stream_records():
    r = single_stream_serial_throughput(frames=4, iters=1, inner=1)
    assert r["metric"] == "single_stream_serial_throughput" and r["value"] > 0
    r = single_stream_blockparallel_throughput(frames=8, nblocks=4,
                                               iters=1, inner=1)
    assert (r["metric"] == "single_stream_blockparallel_throughput"
            and r["value"] > 0)


def test_scaling_efficiency_records():
    recs = scaling_efficiency(device_counts=(1, 2), channels_per_device=4,
                              frames=2, iters=1, inner=1)
    modes = {(r["mode"], r["devices"]) for r in recs}
    assert modes == {("dp", 1), ("dp", 2), ("sp", 1), ("sp", 2)}
    for r in recs:
        assert r["efficiency"] > 0
        assert r["throughput_sps"] > 0
        if r["devices"] == 1:
            assert r["efficiency"] == 1.0


def test_costas_throughput_records():
    for impl in ("scan", "pallas"):
        r = costas_throughput(impl=impl, channels=128, nsym=16,
                              iters=1, inner=1, interpret=impl == "pallas")
        assert r["metric"] == f"costas_throughput_{impl}"
        assert r["value"] > 0
        assert r["unit"] == "symbols/s"


def test_fec_throughput_records():
    for kind in ("conv", "ldpc"):
        r = fec_throughput(kind=kind, packets=8, iters=1, inner=1)
        assert r["metric"] == f"fec_throughput_{kind}"
        assert r["value"] > 0
        assert r["unit"] == "info_bits/s"


def test_frontend_throughput_roofline():
    """The front-end suite runs; its roofline record prices the staged
    chain against the card's published peaks (attached only on a device
    in the peaks table), and an unknown device is an error."""
    from qpsk_tpu import ModemConfig
    from qpsk_tpu.utils.roofline import (PEAKS, frontend_cost,
                                         frontend_report, peaks_for)
    r = frontend_throughput(channels=8, frames=2, iters=1, inner=1)
    assert r["metric"] == "frontend_throughput" and r["value"] > 0
    assert r["device_kind"] not in PEAKS and "roofline" not in r
    with pytest.raises(ValueError, match="no published peaks"):
        peaks_for(r["device_kind"])
    h100 = peaks_for("NVIDIA H100 80GB HBM3")
    cfg = ModemConfig()
    cost = frontend_cost(cfg, 8192, 8, h100)
    # ~2.5 kFLOP and ~34 B of traffic per sample (modem.frontend_xla)
    n = 8192 * 8 * cfg.frame_size
    assert 2400 < cost.matmul_flops / n < 2700
    assert 30 < cost.hbm_bytes / n < 40
    rec = frontend_report(cfg, 8192, 8, 1e-3, h100)
    assert rec["bound"] in ("hbm", "matmul")
    assert 0 < rec["roofline_fraction"] < 1
    # exact precision prices the FIR at the non-tensor-core f32 rate
    exact = frontend_cost(ModemConfig(fir_precision="exact"), 8192, 8, h100)
    assert exact.ideal_matmul_s > 7 * cost.ideal_matmul_s


@pytest.mark.parametrize("fn", ["rx_throughput", "tx_throughput",
                                "costas_throughput", "fec_throughput"])
def test_default_sizes_need_gpu(fn):
    """Default sizes are the GPU operating points: off the GPU a suite
    called without sizes refuses instead of timing a CPU-sized run."""
    import qpsk_tpu.benchmarks as B
    with pytest.raises(ValueError, match="GPU"):
        getattr(B, fn)()


def test_fdm_throughput_record():
    from qpsk_tpu.benchmarks import fdm_throughput
    r = fdm_throughput(nslots=8, frames=2, iters=1, inner=1)
    assert r["metric"] == "fdm_wideband_throughput"
    assert r["value"] > 0 and r["nchan"] == 3
    assert r["unit"] == "wide_samples/s"
    # decomposition record (VERDICT r4 #6): the bound is named, with the
    # same-process filterbank-only / modem-only split behind it
    fdm = r["fdm"]
    assert fdm["bound"] in ("filterbank", "modem-batch")
    assert fdm["fb_only_gsps"] > 0 and fdm["modem_only_gsps"] > 0
    assert 0.0 < fdm["fb_fraction"] < 1.0


def test_coded_rx_throughput_record():
    from qpsk_tpu.benchmarks import coded_rx_throughput
    for kind in ("conv", "ldpc"):
        r = coded_rx_throughput(kind=kind, channels=8, frames=4,
                                iters=1, inner=1)
        assert r["metric"] == f"coded_rx_throughput_{kind}"
        assert r["value"] > 0 and r["unit"] == "samples/s"
        assert r["packets_per_pass"] > 0
        assert r["bound"] in ("fec-decoder", "demod")
        assert r["fec_slowdown_x"] >= 1.0
    # generic-family composed coded row (the 8PSK+LDPC high-rate link)
    r = coded_rx_throughput(kind="ldpc", modulation="8psk", channels=8,
                            frames=4, iters=1, inner=1)
    assert r["metric"] == "coded_rx_throughput_ldpc_8psk"
    assert r["value"] > 0 and r["packets_per_pass"] > 0


def test_sp_bound_record():
    from qpsk_tpu.benchmarks import sp_bound_record
    recs = sp_bound_record(device_counts=(1, 2), frames=4, iters=3)
    assert len(recs) == 2
    for r in recs:
        assert r["mode"] == "sp_bound"
        assert 0.0 < r["eff_bound"] <= 1.0
        assert r["real_mesh_eff"] > 0.98
        assert r["t_block_s"] > 0


def test_costas_report_fields():
    from qpsk_tpu.utils.roofline import costas_report
    rec = costas_report(2048, 1024, measured_pass_s=1.6e-4,
                        step_ns_by_channels={1024: 150.0, 2048: 156.0})
    assert rec["serial_steps_per_pass"] == 1024
    assert rec["ns_per_step"] > 0 and rec["symbols_per_step"] == 2048
    assert rec["bound"] == "serial-step-latency"
    assert 0.9 < rec["step_time_flatness"] <= 1.0

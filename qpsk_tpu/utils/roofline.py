"""Roofline accounting against the card's published peaks.

``PEAKS`` holds one entry per ``device_kind`` with its source; a device
that is not in the table is an error, not a default.  The front-end
(int16 -> modulated-taps RRC FIR -> timing -> decimate, ``modem.frontend_xla``)
is priced analytically so a measured time can be judged against the
card's ceiling:

* traffic per input sample per channel: int16 in (2 B), the f32 raw plane
  written and re-read by the FIR (8 B), the filtered CF32 planes written
  (8 B), re-read by the timing energy (8 B) and by the decimation (8 B),
  picks written (8/cycles B);
* matmul work: the banded-Toeplitz FIR computes ``2 planes x 2 x
  (B + halo)`` FLOPs per output sample, B the block's output columns
  (512 at the default frame) — ~2.5 kFLOP per sample, of which only
  ``2 x 2 x ntaps`` is useful filter math (``useful_flops``).  With
  ``fir_precision="fast"`` the matmuls run as TF32 on the tensor cores.

The Costas loop is priced by its serial step (``costas_report``): one
pass is ``nsym`` dependent steps whatever the channel count.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    tf32_flops: float      # dense tensor-core TF32
    f32_flops: float       # float32 outside the tensor cores
    hbm_bps: float         # device memory bandwidth
    source: str


PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(
        tf32_flops=495e12, f32_flops=67e12, hbm_bps=3.35e12,
        source="NVIDIA H100 SXM data sheet, dense rates at the 700 W "
               "power limit"),
}


def peaks_for(device_kind: str) -> Peaks:
    """Published peaks of a device, by ``jax.Device.device_kind``."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; add it to "
            "qpsk_tpu.utils.roofline.PEAKS with its source") from None


@dataclasses.dataclass(frozen=True)
class FrontendCost:
    hbm_bytes: float           # total device-memory traffic, bytes
    matmul_flops: float        # dense matmul FLOPs actually issued
    useful_flops: float        # ntaps-only filter FLOPs (the physics)
    ideal_hbm_s: float         # traffic / peak bandwidth
    ideal_matmul_s: float      # dense FLOPs / peak matmul rate
    bound: str                 # "hbm" or "matmul"

    @property
    def ideal_s(self) -> float:
        return max(self.ideal_hbm_s, self.ideal_matmul_s)


def frontend_cost(cfg, channels: int, nframes: int,
                  peaks: Peaks) -> FrontendCost:
    """Analytic cost of one ``frontend_xla`` pass over
    (channels, nframes, frame_size) int16 PCM."""
    fsz = cfg.frame_size
    n = channels * nframes * fsz          # total samples
    halo = 128
    block = min(fsz, 512)
    per_sample = 2.0 + 8.0 + 8.0 + 8.0 + 8.0 + 8.0 / cfg.cycles
    flops = 2.0 * 2.0 * (block + halo) * n
    useful = 2.0 * 2.0 * cfg.ntaps * n
    hbm = per_sample * n
    rate = peaks.tf32_flops if cfg.fir_precision == "fast" \
        else peaks.f32_flops
    ih, im_ = hbm / peaks.hbm_bps, flops / rate
    return FrontendCost(hbm_bytes=hbm, matmul_flops=flops,
                        useful_flops=useful, ideal_hbm_s=ih,
                        ideal_matmul_s=im_,
                        bound="hbm" if ih > im_ else "matmul")


def frontend_report(cfg, channels: int, nframes: int, measured_s: float,
                    peaks: Peaks) -> dict:
    """Measured-vs-roofline record for one front-end configuration."""
    c = frontend_cost(cfg, channels, nframes, peaks)
    return {
        "channels": channels,
        "samples": channels * nframes * cfg.frame_size,
        "measured_s": round(measured_s, 9),
        "ideal_s": round(c.ideal_s, 9),
        "bound": c.bound,
        "roofline_fraction": round(c.ideal_s / measured_s, 3),
        "hbm_gbps": round(c.hbm_bytes / measured_s / 1e9, 1),
        "matmul_tflops": round(c.matmul_flops / measured_s / 1e12, 2),
        "peaks_source": peaks.source,
    }


def costas_report(channels: int, nsym: int, measured_pass_s: float,
                  step_ns_by_channels: dict | None = None) -> dict:
    """Measured serial-step record for the fused Costas kernel.

    The kernel's serial axis is the symbol recurrence (costas_loop.c:56-74:
    each symbol's derotation reads the phase updated by the previous one);
    channels run on parallel threads, so one pass executes ``nsym``
    dependent steps whatever the channel count.  The floor is the latency
    of one step's dependency chain (derotate -> detector -> loop filter ->
    wrap/clamp), not bandwidth or FLOPs: ``step_ns_by_channels`` — measured
    ns/step across channel widths — stays ~flat while the card has
    threads to spare, and wider batches decode more symbols per step at
    the same step time."""
    ns = measured_pass_s / nsym * 1e9
    rec = {
        "serial_steps_per_pass": int(nsym),
        "ns_per_step": round(ns, 1),
        "symbols_per_step": int(channels),
        "bound": "serial-step-latency",
    }
    if step_ns_by_channels:
        rec["step_ns_by_channels"] = {
            str(c): round(v, 1) for c, v in step_ns_by_channels.items()}
        vals = list(step_ns_by_channels.values())
        rec["step_time_flatness"] = round(min(vals) / max(vals), 3)
    return rec

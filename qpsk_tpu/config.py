"""Modem configuration.

The reference (/root/reference) hardcodes every parameter as a compile-time
``#define`` (qpsk.h:16-30, rrc_fir.h:13-14, bit-scramble.h:13, fft.h:44) and a
hand-edited loop-bandwidth literal (qpsk.c:302).  Here the whole system is a
single frozen (hashable) dataclass so it can be passed as a static argument to
``jax.jit`` and swapped per mode preset.
"""

from __future__ import annotations

import dataclasses
import math

TAU = 2.0 * math.pi
ROTATE45 = math.pi / 4.0


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """Static parameters of one QPSK modem instance.

    Defaults reproduce the reference design point: 2400 baud QPSK at
    9600 samples/s on a 1500 Hz carrier (qpsk.h:16-18), 127-tap RRC with
    alpha=0.35 and GAIN=1.85 (rrc_fir.h:13-14, qpsk.c:308), Costas loop
    bandwidth TAU/100 with damping sqrt(2)/2 and +/-1 rad/sample frequency
    clamp (qpsk.c:302, costas_loop.c:38).
    """

    fs: float = 9600.0           # sample rate, Hz            (qpsk.h:16)
    rs: float = 2400.0           # symbol rate, baud          (qpsk.h:17)
    center: float = 1500.0       # carrier center, Hz         (qpsk.h:18)
    alpha: float = 0.35          # RRC roll-off               (qpsk.c:308)
    ntaps: int = 127             # RRC taps                   (rrc_fir.h:13)
    gain: float = 1.85           # RRC passband gain knob     (rrc_fir.h:14)
    frame_size: int = 512        # RX block, samples          (qpsk.h:23)
    loop_bw: float = TAU / 100.0  # Costas bandwidth, rad/sym (qpsk.c:302)
    # loop_bw_track > 0 enables the gear-shift (dual-bandwidth) Costas
    # loop: acquire at loop_bw, then shift to this narrower tracking
    # bandwidth once the lock detector settles (ops/costas.CostasGear).
    # Resolves the reference's one-knob tension (README.md:12: bandwidth
    # must be hand-tuned in TAU/100..TAU/200 — wide to pull in, narrow to
    # not jitter).  0 = single-bandwidth loop (reference behavior).
    loop_bw_track: float = 0.0
    damping: float = math.sqrt(2.0) / 2.0   # (costas_loop.c:38)
    min_freq: float = -1.0       # Costas freq clamp, rad/sym (qpsk.c:302)
    max_freq: float = 1.0
    pcm_scale: float = 16384.0   # int16 full-scale @ .5      (qpsk.c:260)

    # --- mode switches (new capability, not in reference) ---
    # modulation: "qpsk" is the flagship — bit-exact against the C
    # reference (ops/modmap.py).  "bpsk" / "8psk" / "16qam" route the same frame/packet
    # stack through the generic family (ops/modfam.py): generic
    # decision-directed carrier recovery (n_rot-fold ambiguity resolved by
    # the CRC-scored sync hunt), max-log LLRs for the soft/FEC path, and
    # the M-power acquisition matching the constellation.  16QAM decisions
    # are amplitude-true: run agc=True (the slicer/detector use agc_target
    # as the constellation scale; default 1.45 = the chain's double-GAIN
    # post-MF magnitude, so a calibrated full-scale link works unaided).
    modulation: str = "qpsk"
    # timing: "histogram" replicates qpsk.c:131-180 exactly (the estimator the
    # reference README calls unreliable); "power" is the robust
    # Oerder&Meyr-style squared-envelope integer-phase estimator (default);
    # "fractional" adds cubic-interpolating decimation at the O&M fractional
    # estimate (robust to off-grid symbol clocks).
    # "tracking" closes a second-order timing loop over the per-frame O&M
    # fractional estimates (frame-rate timing PLL): robust to sample-clock
    # *rate* offsets, which every feedforward per-frame estimator is not.
    timing_mode: str = "power"
    # nco: "fast" uses closed-form phasor ramps (embarrassingly parallel);
    # "exact" replicates the C sequential phase product (qpsk.c:115) in a scan
    # for bit-level parity testing.
    nco_mode: str = "fast"
    # slicer: "diagonal" slices the Costas diagonal lock directly (correct);
    # "reference" replicates the C rotate-45-then-sign slicer (qpsk.c:74-79)
    # whose decisions are noise-decided at the lock points — parity mode
    # only (see ops/modmap.demod_bits docstrings).
    slicer: str = "diagonal"
    # carrier acquisition: "none" = cold-start Costas like the reference;
    # "fft" = 4th-power FFT coarse estimate seeding the Costas loop.
    acquisition: str = "fft"
    # differential: encode dibits as phase *changes* (DQPSK,
    # ops/differential.py) — constellation-rotation-immune decode, no CRC
    # rotation search needed, a Costas cycle slip costs one symbol instead
    # of the rest of the stream.  Default off (reference parity: absolute).
    differential: bool = False
    # costas_impl: "auto" runs the Costas loop as the fused Pallas kernel
    # on the GPU (ops/pallas/costas_kernel.py) and as a lax.scan anywhere
    # else; "scan" / "pallas" force one.  The two agree to rounding.
    costas_impl: str = "auto"
    # fir_precision: "fast" = the backend's default matmul precision (TF32
    # on the GPU, ~3 decimal digits, far below any channel noise); "exact"
    # = HIGHEST-precision f32 (parity-grade, required by the golden-vector
    # tests).
    fir_precision: str = "fast"
    # eq_taps > 0 enables the blind CMA channel equalizer
    # (ops/equalizer.py): an eq_taps-long symbol-spaced adaptive filter on
    # the pre-Costas symbol stream with frame-rate block updates — decodes
    # through static multipath (channel.multipath_pcm) the bare chain
    # cannot.  0 = off (reference behavior: flat channel assumed).
    eq_taps: int = 0
    eq_mu: float = 0.2           # CMA step (power-normalized, per frame)
    eq_modulus: float = 2.1      # CMA |y|^2 target (nominal post-MF ~1.45^2)
    # agc enables the frame-rate automatic gain control (ops/agc.py) on the
    # decimated symbol stream: unknown input levels (real audio links — the
    # reference assumes RX divides by the exact scale TX multiplied by,
    # qpsk.c:113/260) are normalized to agc_target RMS before the
    # amplitude-sensitive stages (Costas error gain, CMA modulus target).
    # Default off (reference behavior: calibrated full-scale assumed).
    agc: bool = False
    agc_target: float = 1.45     # nominal post-MF symbol modulus (2x GAIN)
    agc_mu: float = 0.5          # per-frame RMS-estimate smoothing step
    nfft: int = 512              # acquisition FFT size       (fft.h:44)

    # --- packet layer (reference algorithms/, dormant there) ---
    scramble_seed: int = 0x4A80  # DVB LFSR sync seed         (bit-scramble.h:13)

    def __post_init__(self):
        if self.fs % self.rs != 0:
            raise ValueError(f"fs={self.fs} must be an integer multiple of rs={self.rs}")
        if self.frame_size % int(self.fs / self.rs) != 0:
            raise ValueError(
                f"frame_size={self.frame_size} must be divisible by "
                f"cycles={int(self.fs / self.rs)} (samples per symbol) — "
                "the timing/decimation pipeline reshapes frames into whole "
                "symbol groups")
        if self.ntaps % 2 != 1:
            raise ValueError("ntaps must be odd")
        if self.timing_mode not in ("histogram", "power", "fractional",
                                    "tracking"):
            raise ValueError(f"unknown timing_mode {self.timing_mode!r}")
        if self.modulation not in ("qpsk", "bpsk", "8psk", "16qam"):
            raise ValueError(f"unknown modulation {self.modulation!r}")
        if self.modulation != "qpsk":
            # QPSK-specific machinery: DQPSK differential encode, the
            # reference's rotate-45 parity slicer, and the gear-shift lock
            # detector (thresholds measured on the QPSK error statistic)
            if self.differential:
                raise ValueError(
                    f"differential=True is the DQPSK mode; "
                    f"modulation={self.modulation!r} is coherent-only")
            if self.slicer == "reference":
                raise ValueError(
                    "slicer='reference' replicates the C QPSK slicer; "
                    f"not meaningful for modulation={self.modulation!r}")
            if self.loop_bw_track > 0:
                raise ValueError(
                    "loop_bw_track (gear-shift Costas) is tuned on the "
                    "QPSK lock statistic; set 0 for "
                    f"modulation={self.modulation!r}")
        if self.nco_mode not in ("fast", "exact"):
            raise ValueError(f"unknown nco_mode {self.nco_mode!r}")
        if self.slicer not in ("diagonal", "reference"):
            raise ValueError(f"unknown slicer {self.slicer!r}")
        if self.costas_impl not in ("auto", "scan", "pallas"):
            raise ValueError(f"unknown costas_impl {self.costas_impl!r}")
        if self.fir_precision not in ("fast", "exact"):
            raise ValueError(f"unknown fir_precision {self.fir_precision!r}")
        if self.acquisition not in ("none", "fft"):
            raise ValueError(f"unknown acquisition {self.acquisition!r}")
        if self.loop_bw_track < 0 or self.loop_bw_track > self.loop_bw:
            raise ValueError(
                f"loop_bw_track={self.loop_bw_track} must be in "
                f"[0, loop_bw={self.loop_bw}] — the tracking gear is the "
                "narrower bandwidth (0 disables the gear shift)")
        if self.eq_taps < 0:
            raise ValueError(f"eq_taps={self.eq_taps} must be >= 0")
        if not 0.0 < self.agc_mu <= 1.0:
            raise ValueError(f"agc_mu={self.agc_mu} must be in (0, 1]")
        if self.agc_target <= 0.0:
            raise ValueError(f"agc_target={self.agc_target} must be > 0")

    @property
    def cycles(self) -> int:
        """Samples per symbol (qpsk.h:21)."""
        return int(self.fs / self.rs)

    @property
    def bits_per_symbol(self) -> int:
        if self.modulation == "qpsk":
            return 2
        from qpsk_tpu.ops.modfam import get
        return get(self.modulation).bps

    @property
    def bits_per_frame(self) -> int:
        """Channel bits carried by one modem frame."""
        return self.bits_per_symbol * self.symbols_per_frame

    @property
    def symbols_per_frame(self) -> int:
        return self.frame_size // self.cycles

    @property
    def omega_center(self) -> float:
        """Carrier phase increment, rad/sample (qpsk.c:342)."""
        return TAU * self.center / self.fs


def config_2400() -> ModemConfig:
    """Reference design point: 2400 baud VHF/UHF mode (README.md:2)."""
    return ModemConfig()


def config_1200() -> ModemConfig:
    """1200 baud 10 m band mode (README.md:2)."""
    return ModemConfig(rs=1200.0)


def config_parity() -> ModemConfig:
    """Bit/behavior parity with the C reference: histogram timing
    (qpsk.c:131-180), sequential NCO rounding (qpsk.c:115), cold-start
    Costas (qpsk.c:302), rotate-45 slicer (qpsk.c:74-79)."""
    return ModemConfig(timing_mode="histogram", nco_mode="exact",
                       acquisition="none", slicer="reference",
                       fir_precision="exact")

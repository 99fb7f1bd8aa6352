"""Test harness: run everything on a virtual 8-device CPU mesh so sharding
tests exercise real collectives without accelerator hardware (the on-card
checks live in chip_smoke.py)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# If jax was imported before this file ran, it has latched JAX_PLATFORMS
# from the original env; update the live config as well — backends are not
# initialized yet at conftest time, so this still takes effect.
import jax  # noqa: E402
import pytest  # noqa: E402

from qpsk_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# the suite is compile-bound on CPU: persist compiles across runs
enable_compile_cache()
assert jax.device_count() == 8, (
    f"test harness expected an 8-device CPU mesh, got {jax.devices()}; "
    "XLA_FLAGS was read too late — check for pre-initialized backends")

# Long soak/stream tests (>~15 s each on an idle host), centrally marked so
# `-m "not slow"` is a real ~2-minute subset.  Parametrized variants match
# by base name.
_SLOW = {
    "test_streaming_buffers_stay_bounded_on_endless_noise",
    "test_timeparallel_fractional_mode_supported",
    "test_timeparallel_burst_decode",
    "test_rx_stream_fec_wiring",
    "test_soft_sync_hunt_beats_hard_at_low_snr",
    "test_stream_demodulator_fec_low_snr",
    "test_loopback_and_payload_bytes",
    "test_fec_rides_through_impulse_noise",
    "test_per_vs_snr_coded_soft",
    "test_large_coded_packet_sync",
    "test_coded_link_beats_uncoded",
    "test_stream_demodulator_rides_through_symbol_slip",
    "test_loopback_modulation_flag",
    "test_stream_demodulator_8psk_fec_soft",
    "test_rx_stream_squelch_and_io_rate",
    "test_squelch_burst_then_trailing_noise_one_push",
    "test_fdm_subcommand",
    "test_stream_demodulator_8psk_resync_after_gap",
}


def pytest_collection_modifyitems(items):
    for it in items:
        if it.name.split("[")[0] in _SLOW:
            it.add_marker(pytest.mark.slow)

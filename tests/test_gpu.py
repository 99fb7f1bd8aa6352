"""On-card comparisons (marker ``gpu``): the fused Costas kernel compiled
for the GPU against the ``lax.scan`` on the same card.  They skip off the
GPU — whether a GPU is present is decided inside the fixture, never at
import — and ``chip_smoke.py`` runs the same checks at full width."""

import importlib
import sys
from pathlib import Path

import jax
import pytest


@pytest.fixture
def on_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    return importlib.import_module("chip_smoke")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["qpsk", "gear", "agc", "bpsk", "8psk",
                                  "16qam"])
def test_kernel_matches_scan_on_card(on_gpu, kind):
    agree, dfreq, _, _, _, _ = _chip_smoke().compare_costas(kind, 256, 1024)
    assert agree >= 0.9999 and dfreq <= 1e-5

"""qpsk_tpu — a QPSK packet-modem framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
MonsieurETM/QPSK C reference modem: 2400-baud Gray-coded QPSK with RRC pulse
shaping, preamble-free timing recovery, Costas-loop carrier recovery, and a
full packet layer (CRC16, DVB scrambler, golden-prime interleaver, FFT
acquisition), scaled over device meshes with pjit/shard_map.
"""

from qpsk_tpu.config import ModemConfig, config_1200, config_2400, config_parity
from qpsk_tpu.modem import (rx_acquire_hz, rx_frame, rx_stream,
                            tx_bits_frame, tx_frame, tx_stream)
from qpsk_tpu.runtime import StreamDemodulator, StreamModulator
from qpsk_tpu.state import RxState, TxState, rx_init, tx_init

__version__ = "0.5.0"

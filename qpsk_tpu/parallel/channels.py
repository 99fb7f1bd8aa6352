"""Data parallelism over independent channels (BASELINE config #4).

256 independent QPSK channels = a batch axis on every pipeline op (the whole
modem broadcasts over leading axes by construction), sharded across the mesh
with NamedSharding.  The Costas recurrence stays a ``lax.scan`` over time,
but its carry is a (channels,) vector — channels run in parallel on each
device and across the mesh, hiding the serial recurrence (SURVEY.md §7
hard-part #1).

No collectives are needed in steady state (channels are independent); XLA
inserts them only for metric reductions the caller asks for.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qpsk_tpu.config import ModemConfig
from qpsk_tpu.modem import rx_stream
from qpsk_tpu.state import RxState, rx_init


def default_mesh(axis: str = "dp") -> Mesh:
    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_channel_state(state: RxState, mesh: Mesh, axis: str = "dp") -> RxState:
    """Place per-channel state with the channel axis sharded over ``axis``."""
    return jax.device_put(state, NamedSharding(mesh, P(axis)))


def make_channel_demod(cfg: ModemConfig, mesh: Mesh, axis: str = "dp"):
    """Build a jitted (state, pcm) -> (state, RxOut) over (channels, frames,
    frame_size) PCM with channels sharded over the mesh.

    Implemented with shard_map (not just sharding annotations) so the body
    traces with *local* per-device shapes — the Pallas Costas kernel then
    launches per device with no cross-device partitioning questions, and
    channels stay fully independent (no collectives in steady state).
    """
    from jax import shard_map

    def body(state: RxState, pcm):
        return rx_stream(cfg, state, pcm)

    fn = shard_map(body, mesh=mesh, in_specs=(P(axis), P(axis)),
                   out_specs=(P(axis), P(axis)))
    return jax.jit(fn)


def init_channels(cfg: ModemConfig, nchannels: int, mesh: Mesh,
                  axis: str = "dp") -> RxState:
    return shard_channel_state(rx_init(cfg, batch_shape=(nchannels,)),
                               mesh, axis)

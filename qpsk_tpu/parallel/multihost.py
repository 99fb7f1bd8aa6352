"""Multi-host execution helpers.

The reference has no distribution of any kind (SURVEY.md §2); the
framework scales across hosts with JAX's multi-controller runtime: every
host runs the same program, ``jax.distributed.initialize`` wires the
cluster, and XLA compiles the collectives (on GPUs, NCCL carries them:
the halo ``ppermute`` in parallel/stream.py rides NVLink between the
cards of a host and the network between hosts).

Typical use on each host of a cluster:

    from qpsk_tpu.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=0)
    mesh = multihost.global_mesh(("dp", "sp"), (jax.device_count() // 2, 2))
    ... build sharded arrays with jax.make_array_from_process_local_data ...

Single-process (tests, one chip) everything degrades gracefully: calling
``initialize`` is skipped, and ``global_mesh`` is an ordinary local mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Wire the multi-host runtime.  Must be called before any JAX call
    that initializes the XLA backend (even ``jax.devices()``) — that is a
    jax.distributed requirement, so this function deliberately makes no
    backend-touching probes itself.

    On GPU and CPU clusters pass all three arguments explicitly (JAX
    finds no cluster from the environment there).  No-op when called twice, or when
    called with no arguments outside any recognizable cluster environment
    (single-process runs and tests stay zero-config).
    """
    import os

    if getattr(initialize, "_done", False):
        return
    env_driven = bool(os.environ.get("JAX_COORDINATOR_ADDRESS")
                      or os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address is None and num_processes is None and not env_driven:
        return  # single-process run: nothing to do
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    initialize._done = True


def global_mesh(axis_names: tuple[str, ...],
                axis_sizes: tuple[int, ...] | None = None) -> Mesh:
    """Mesh over all devices of all processes.  Defaults to one axis over
    every device; with two axes the convention is ('dp', 'sp') =
    (channels, time-blocks)."""
    devs = np.asarray(jax.devices())
    if axis_sizes is None:
        axis_sizes = (devs.size,) if len(axis_names) == 1 else None
    assert axis_sizes is not None, "axis_sizes required for multi-axis mesh"
    assert int(np.prod(axis_sizes)) == devs.size, (axis_sizes, devs.size)
    return Mesh(devs.reshape(axis_sizes), axis_names)


def replicate(mesh: Mesh, tree):
    """Place a pytree fully replicated on the mesh."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


def aggregate_metrics(mesh: Mesh, axis: str):
    """Returns a jitted ``psum``-mean reducer for per-shard metric dicts —
    BER/PER/EVM aggregation across the mesh in-graph."""
    from jax import shard_map

    def agg(tree):
        def body(local):
            n = jax.lax.axis_size(axis)
            # leaves carry a leading per-shard axis; reduce it locally,
            # then mean across the mesh
            return jax.tree.map(
                lambda x: jax.lax.psum(jnp.mean(x, axis=0), axis) / n, local)

        return shard_map(body, mesh=mesh, in_specs=P(axis),
                         out_specs=P())(tree)

    return jax.jit(agg)

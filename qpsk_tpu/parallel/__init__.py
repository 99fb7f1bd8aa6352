"""Distributed execution: sharding the modem over a device mesh.

The reference is strictly single-threaded C (SURVEY.md §2: no threads, no
SIMD, no comm).  Scale-out is therefore *added capability*, along the two
axes that exist in a sample-stream modem:

* ``channels``  — data parallel over independent channels (BASELINE #4):
  per-channel filter/NCO/Costas state rides the batch axis, sharded over
  the mesh's 'dp' axis with NamedSharding.
* ``stream``    — sequence parallel over time blocks of one long stream
  (BASELINE #5): overlap-save FIR with a ppermute halo exchange of the
  (ntaps-1)-sample tail, closed-form per-block NCO phase, and per-block
  Costas re-acquisition.
"""

from qpsk_tpu.parallel.blocks import rx_stream_blockparallel
from qpsk_tpu.parallel.channels import make_channel_demod, shard_channel_state
from qpsk_tpu.parallel.stream import rx_stream_timeparallel

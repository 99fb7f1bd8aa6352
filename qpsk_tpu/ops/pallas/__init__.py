"""Pallas kernels for the GPU (Triton route).

The only serial computation in the RX chain is the Costas loop; on the GPU a
``lax.scan`` pays a kernel launch per step, so the loop is fused into one
kernel with channels across threads (ops/pallas/costas_kernel.py).
Everything else in the pipeline is matmuls and elementwise work that XLA
compiles well as it stands.
"""

"""dpgo_tpu_torch: the PyTorch / CUDA port of dpgo_tpu.

Distributed pose-graph optimization by Riemannian block-coordinate descent
on one device: the single-device JACOBI solve (``models.rbcd.solve_rbcd``)
runs on an NVIDIA GPU, with every agent's local trust-region step fused
into one hand-written CUDA kernel (``ops.rtr_kernel``).  The JAX package
``dpgo_tpu`` stays the reference; this package imports none of it.
"""

__version__ = "0.1.0"

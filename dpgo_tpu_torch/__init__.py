"""dpgo_tpu_torch: the PyTorch / CUDA port of dpgo_tpu.

Distributed pose-graph optimization by Riemannian block-coordinate descent
on one device: the single-device solve (``models.rbcd.solve_rbcd``: every
schedule, Nesterov acceleration, GNC) runs on an NVIDIA GPU, with every
agent's local trust-region step fused into one hand-written CUDA kernel
(``ops.rtr_kernel``).  The per-robot deployment runtime (``agent``,
``comms``) runs each robot's step as one launch of that kernel.  The JAX
package ``dpgo_tpu`` stays the reference; this package imports none of it.
The top-level names are the JAX package's re-exports.
"""

from .config import (
    AgentParams,
    RobustCostParams,
    RobustCostType,
    ROptAlg,
    Schedule,
    SolverParams,
)
from .types import EdgeSet, Measurements, edge_set_from_measurements
from .utils.g2o import read_g2o

__version__ = "0.1.0"

__all__ = [
    "AgentParams",
    "RobustCostParams",
    "RobustCostType",
    "ROptAlg",
    "Schedule",
    "SolverParams",
    "EdgeSet",
    "Measurements",
    "edge_set_from_measurements",
    "read_g2o",
]

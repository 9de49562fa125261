"""Configuration dataclasses, the PyTorch port's copy of ``dpgo_tpu.config``.

Same fields and defaults as the JAX package (which mirror the reference's
``PGOAgentParameters``, ``include/DPGO/PGOAgent.h:59-160``, and
``RobustCostParameters``, ``include/DPGO/DPGO_robust.h:34-68``), so a
configuration written for one package means the same thing in the other.
Knobs that only shaped the TPU kernel are accepted and documented as no-ops.
"""

from __future__ import annotations

import dataclasses
import enum


class ROptAlg(enum.Enum):
    """Local solver choice (reference ``DPGO_types.h:28-32``)."""

    RTR = "RTR"  # Riemannian trust region with truncated CG
    RGD = "RGD"  # Riemannian gradient descent (fixed step)


class RobustCostType(enum.Enum):
    """Robust cost functions (reference ``DPGO_robust.h:20-27``)."""

    L2 = "L2"
    L1 = "L1"
    TLS = "TLS"
    Huber = "Huber"
    GM = "GM"
    GNC_TLS = "GNC_TLS"


class Schedule(enum.Enum):
    """Block-update schedule for distributed RBCD.

    JACOBI updates every agent each round.  GREEDY (one agent per round by
    largest block gradient norm), ASYNC (independent Bernoulli clocks) and
    COLORED (one color class of the agent coloring per round) are defined
    so configurations stay interchangeable with the JAX package; the port's
    round raises ``NotImplementedError`` for them until they are ported.
    """

    GREEDY = "greedy"
    JACOBI = "jacobi"
    ASYNC = "async"
    COLORED = "colored"


@dataclasses.dataclass(frozen=True)
class RobustCostParams:
    """Defaults mirror reference ``DPGO_robust.h:48-55``."""

    cost_type: RobustCostType = RobustCostType.L2
    gnc_max_iters: int = 100
    gnc_barc: float = 10.0
    gnc_mu_step: float = 1.4
    gnc_init_mu: float = 1e-4
    huber_threshold: float = 3.0
    tls_threshold: float = 10.0


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Local trust-region / gradient solver knobs.

    Defaults follow the per-iteration budget the reference agent uses
    inside RBCD (``PGOAgent.cpp:1131-1137``): one outer RTR iteration, at
    most 10 truncated-CG iterations, gradient-norm tolerance 1e-2, initial
    radius 100, and the shrink-on-reject loop of
    ``QuadraticOptimizer.cpp:92-110`` (radius /= 4, at most 10 tries).
    """

    algorithm: ROptAlg = ROptAlg.RTR
    grad_norm_tol: float = 1e-2
    max_outer_iters: int = 1
    max_inner_iters: int = 10
    initial_radius: float = 100.0
    max_rejections: int = 10
    # tCG convergence: ||r|| <= ||r0|| * min(kappa, ||r0||^theta)
    tcg_kappa: float = 0.1
    tcg_theta: float = 1.0
    # Riemannian gradient descent step (reference gradientDescent,
    # QuadraticOptimizer.cpp:124-149).
    rgd_stepsize: float = 1e-3
    # Tikhonov shift of the block-Jacobi preconditioner, the reference's
    # Q + 0.1 I factorization (QuadraticProblem.cpp:31-42).
    precond_shift: float = 0.1
    # Run the whole local RTR step in the hand-written CUDA kernel
    # (``ops.rtr_kernel``).  None = auto: on for float32 problems on a CUDA
    # device; True forces it (on CPU tensors the kernel's plain PyTorch
    # version runs, and a configuration the kernel cannot take raises);
    # False runs the plain edge-list formulation.
    pallas_tcg: bool | None = None
    # TPU selection-matmul precision knobs.  Accepted so configurations stay
    # interchangeable, and ignored: the CUDA kernel's gathers are exact
    # float32 loads, so there is no one-hot matmul whose precision to pick.
    pallas_bf16_select: bool = False
    pallas_sel_mode: str = ""
    # Dense connection-Laplacian formulation; not ported (raises).
    dense_quadratic: bool = False


@dataclasses.dataclass(frozen=True)
class AgentParams:
    """Distributed RBCD parameters (reference ``PGOAgent.h:59-160``)."""

    d: int = 3
    r: int = 5
    num_robots: int = 1
    solver: SolverParams = SolverParams()
    # Nesterov acceleration (RA-L 2020)
    acceleration: bool = False
    restart_interval: int = 30
    # Robust optimization (GNC)
    robust: RobustCostParams = RobustCostParams()
    robust_init_min_inliers: int = 2
    robust_opt_num_weight_updates: int = 0
    robust_opt_inner_iters: int = 30
    robust_opt_warm_start: bool = True
    robust_opt_min_convergence_ratio: float = 0.8
    # Termination
    max_num_iters: int = 500
    rel_change_tol: float = 5e-3
    status_fetch_every: int = 1
    # Terminal certification: "off" only in the port so far.
    certify_mode: str = "off"
    certify_eta: float = 1e-5
    schedule: Schedule = Schedule.JACOBI
    async_update_prob: float = 0.5
    verbose: bool = False
    log_data: bool = False
    log_directory: str = ""

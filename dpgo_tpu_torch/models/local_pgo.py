"""Single-agent (centralized) pose-graph optimization (port of
``dpgo_tpu.models.local_pgo``).

Equivalent of reference ``PGOAgent::localPoseGraphOptimization``
(``PGOAgent.cpp:964-1005``) and the ``single-robot-example`` driver
(``examples/SingleRobotExample.cpp``): chordal (or odometry)
initialization followed by a Riemannian trust-region solve of the full
problem on one device, plus the lifting and rounding between SE(d) and the
rank-r relaxation.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SolverParams
from ..device import resolve_device
from ..ops import chordal, quadratic, solver
from ..types import EdgeSet, Measurements, edge_set_from_measurements
from ..utils.lie import lifting_matrix, project_to_rotation


def lift(T: torch.Tensor, ylift: torch.Tensor) -> torch.Tensor:
    """X_i = YLift T_i: [n, d, d+1] -> [n, r, d+1]
    (reference ``PGOAgent.cpp:183,415``)."""
    return torch.einsum("rd,nde->nre", ylift, T)


def round_solution(X: torch.Tensor, ylift: torch.Tensor) -> torch.Tensor:
    """T = YLift^T X, rotation blocks projected to SO(d)
    (reference ``PGOAgent::roundSolution``, ``PGOAgent.cpp:487-494``)."""
    T = torch.einsum("rd,nre->nde", ylift, X)
    d = ylift.shape[1]
    return torch.cat([project_to_rotation(T[..., :d]), T[..., d:]], dim=-1)


def make_problem(edges: EdgeSet, n: int,
                 precond_shift: float = 0.1) -> solver.Problem:
    """Solver closures for a single-buffer problem (all edges private; the
    buffer is exactly the n local poses).  The incidence of the edges is
    built once here and every gradient, Hessian-vector product and
    diagonal block sums through it."""
    inc = quadratic.edge_incidence(edges, n)
    chol = quadratic.precond_factors(quadratic.diag_blocks(edges, *inc),
                                     precond_shift)
    return solver.Problem(
        cost=lambda X: quadratic.cost(X, edges),
        egrad=lambda X: quadratic.egrad(X, edges, inc=inc),
        ehess=lambda X, V: quadratic.hessvec(V, edges, n, inc=inc),
        precond=lambda X, V: quadratic.precond_apply(chol, V),
    )


@dataclasses.dataclass
class LocalSolveResult:
    T: torch.Tensor  # [n, d, d+1] rounded SE(d) trajectory
    X: torch.Tensor  # [n, r, d+1] lifted solution
    cost: float
    grad_norm: float
    iters: int


def initial_poses(edges: EdgeSet, n: int, init: str) -> torch.Tensor:
    """T0 [n, d, d+1] from the chordal or the odometry initialization."""
    if init == "chordal":
        return chordal.chordal_initialization(edges, n)
    if init == "odometry":
        return chordal.odometry_from_edges(edges, n)
    raise ValueError(f"unknown init {init!r}")


def solve_local(meas: Measurements, rank: int | None = None,
                params: SolverParams | None = None, max_iters: int = 100,
                grad_norm_tol: float = 1e-1, init: str = "chordal",
                dtype=torch.float64, device="cuda") -> LocalSolveResult:
    """Centralized PGO solve of a full measurement set on ``device``.

    Defaults mirror the reference's local solve configuration
    (``PGOAgent.cpp:979-987``: RTR, gradnorm tol 1e-1; rank r = d means no
    relaxation).  ``rank > d`` gives the lifted (Burer-Monteiro) solve."""
    dev = resolve_device(device)
    params = params or SolverParams(initial_radius=1e1, max_inner_iters=50)
    n = meas.num_poses
    d = meas.d
    rank = d if rank is None else rank
    edges = edge_set_from_measurements(meas, dtype=dtype, device=dev)
    ylift = lifting_matrix(rank, d, dtype, dev)
    X0 = lift(initial_poses(edges, n, init), ylift)
    problem = make_problem(edges, n, params.precond_shift)
    out = solver.rtr_solve(problem, X0, params, max_iters=max_iters,
                           grad_norm_tol=grad_norm_tol)
    return LocalSolveResult(T=round_solution(out.X, ylift), X=out.X,
                            cost=float(out.f),
                            grad_norm=float(out.grad_norm),
                            iters=int(out.iters))

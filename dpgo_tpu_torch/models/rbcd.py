"""Multi-agent Riemannian block-coordinate descent (RBCD) on one device —
the PyTorch port of ``dpgo_tpu.models.rbcd``.

All agents' states live in one batched tensor ``X: [A, n_max, r, d+1]``;
a round exchanges the public poses into each agent's neighbor buffer and
solves every agent's local problem at once.  The JAX package vmaps the
per-agent solve; here the agent axis is a leading batch dimension, and on
a CUDA device the whole local RTR step of every agent is one launch of the
hand-written kernel of ``ops.rtr_kernel``.

Ported: the whole round of the JAX package's ``_rbcd_round`` on one
device — the JACOBI, GREEDY, ASYNC and COLORED schedules, Nesterov
acceleration with restarts, GNC and the other robust costs — its fused
stepping (``rbcd_steps``, ``rbcd_segment``, with no host sync inside a
segment) and the per-eval outer loop.  The device-resident verdict loop,
certification, ``solve_rbcd_robust_iterated``, the odometry and
distributed inits and the dense-Q formulation raise ``NotImplementedError``
naming the ROADMAP item that ports them.

One deliberate deviation: ASYNC's Bernoulli clocks draw from a
``torch.Generator`` seeded from ``(seed, iteration)`` (``_async_fired``),
not from JAX's threefry key chain — the same distribution, another stream.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import robust
from ..config import AgentParams, ROptAlg, RobustCostType, Schedule
from ..device import default_dtype, resolve_device
from ..ops import chordal, manifold, quadratic, rtr_kernel, solver
from ..types import EdgeSet, Measurements, edge_set_from_measurements
from ..utils.graph_plan import color_agents, plan_python
from ..utils.lie import lifting_matrix as _lifting_matrix
from ..utils.partition import Partition, partition_contiguous
from .local_pgo import lift, round_solution

#: Edge-tile width of the tile-major edge layout (the JAX package's
#: ``pallas_tcg.TILE``); halved for pose buffers above 1024 slots.
TILE = 256


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to dpgo_tpu_torch yet ({item} in ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class GraphMeta:
    """Static shape metadata."""

    num_robots: int
    n_max: int
    e_max: int
    s_max: int  # neighbor slots per agent
    p_max: int  # public poses per agent
    d: int
    rank: int
    num_colors: int = 1


class MultiAgentGraph(NamedTuple):
    """Batched per-agent problem data ([A, ...] tensors on one device)."""

    edges: EdgeSet  # fields [A, E_max]; i/j index the [n_max + S_max] buffer
    meas_id: torch.Tensor  # [A, E_max] global measurement id
    n: torch.Tensor  # [A] int32 pose counts
    pose_mask: torch.Tensor  # [A, n_max]
    pub_idx: torch.Tensor  # [A, P_max] local indices of public poses
    pub_mask: torch.Tensor  # [A, P_max]
    nbr_robot: torch.Tensor  # [A, S_max]
    nbr_pub: torch.Tensor  # [A, S_max] slot in that robot's public row
    nbr_mask: torch.Tensor  # [A, S_max]
    global_index: torch.Tensor  # [A, n_max] local -> global pose (0 for pad)
    # ELL incidence of local poses: slot e = endpoint i of edge e, slot
    # E_max + e = endpoint j (``quadratic.egrad_ell`` and the kernel).
    inc_slot: torch.Tensor  # [A, n_max, K] int32
    inc_mask: torch.Tensor  # [A, n_max, K]
    # Tile-major edge arrays of the kernel (``ops.rtr_kernel``): edges
    # padded to nt * T, padding index n_max + s_max.
    eidx_i: torch.Tensor  # [A, nt, 1, T] int32
    eidx_j: torch.Tensor  # [A, nt, 1, T] int32
    rot_t: torch.Tensor  # [A, nt, d*d, T] float32
    trn_t: torch.Tensor  # [A, nt, d, T] float32
    color: torch.Tensor  # [A] int32 greedy agent coloring


class RBCDState(NamedTuple):
    """The solver state.  ``iteration`` is a host int, so COLORED's class
    and GNC's freeze ordinal are host arithmetic, never a sync."""

    X: torch.Tensor  # [A, n_max, r, d+1]
    weights: torch.Tensor  # [A, E_max] per-edge weights
    iteration: int
    rel_change: torch.Tensor  # [A]
    ready: torch.Tensor  # [A] bool
    chol: torch.Tensor | None = None  # [A, n_max, d+1, d+1] precond factors
    V: torch.Tensor | None = None  # Nesterov sequence (acceleration only)
    gamma: torch.Tensor | None = None  # [A] Nesterov step parameters
    alpha: torch.Tensor | None = None  # [A]
    mu: torch.Tensor | None = None  # 0-dim GNC control parameter
    X_init: torch.Tensor | None = None  # initial guess (GNC, no warm start)
    seed: int = 0  # ASYNC clocks draw from (seed, iteration)


def edge_tile_shape(n_max: int, s_max: int, e_max: int) -> tuple[int, int]:
    """(T, nt) of the tile-major edge layout, as the JAX package's f32
    kernel lays it out."""
    T = TILE if (n_max + s_max) <= 1024 else TILE // 2
    return T, max(1, -(-e_max // T))


def build_graph(part: Partition, rank: int, dtype=torch.float64,
                device="cuda") -> tuple[MultiAgentGraph, GraphMeta]:
    """Padded per-agent arrays from a partitioned measurement set: each
    shared measurement appears in both endpoint agents' edge lists with the
    remote endpoint redirected to a neighbor slot (``PGOAgent.cpp:228-
    248``).  Topology from the Python planner (``utils.graph_plan``)."""
    dev = resolve_device(device)
    A = part.num_robots
    meas = part.meas
    d = meas.d
    n_max = part.n_max

    plan = plan_python(meas.r1, meas.p1, meas.r2, meas.p2, A, n_max)
    e_max, s_max, p_max = plan.e_max, plan.s_max, plan.p_max
    cls = part.classify()  # 0 odo, 1 private LC, 2 shared

    valid = plan.emask
    kk = plan.meas_id[valid]
    eR = np.tile(np.eye(d), (A, e_max, 1, 1))
    et = np.zeros((A, e_max, d))
    ekap = np.zeros((A, e_max))
    etau = np.zeros((A, e_max))
    eis_lc = np.zeros((A, e_max))
    efix = np.zeros((A, e_max))
    eweight = np.ones((A, e_max))
    eR[valid] = meas.R[kk]
    et[valid] = meas.t[kk]
    ekap[valid] = meas.kappa[kk]
    etau[valid] = meas.tau[kk]
    eis_lc[valid] = (cls[kk] != 0).astype(np.float64)
    efix[valid] = np.asarray(meas.is_known_inlier, bool)[kk].astype(np.float64)
    eweight[valid] = meas.weight[kk]

    T, nt = edge_tile_shape(n_max, s_max, e_max)
    Ep = nt * T
    pad_idx = n_max + s_max  # matches neither the local nor neighbor range
    idx_i = np.full((A, Ep), pad_idx, np.int32)
    idx_j = np.full((A, Ep), pad_idx, np.int32)
    idx_i[:, :e_max][valid] = plan.ei[valid]
    idx_j[:, :e_max][valid] = plan.ej[valid]
    rot_flat = np.zeros((A, d * d, Ep), np.float32)
    trn_flat = np.zeros((A, d, Ep), np.float32)
    rot_flat[:, :, :e_max] = eR.transpose(0, 2, 3, 1).reshape(A, d * d, e_max)
    trn_flat[:, :, :e_max] = et.transpose(0, 2, 1)
    pose_mask = (np.arange(n_max)[None, :] < part.n[:, None]).astype(
        np.float64)
    color, num_colors = color_agents(plan.nbr_robot, plan.nbr_mask, A)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=dev)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32), device=dev)

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

    edges = EdgeSet(i=i64(plan.ei), j=i64(plan.ej), R=f(eR), t=f(et),
                    kappa=f(ekap), tau=f(etau), weight=f(eweight),
                    mask=f(valid), is_lc=f(eis_lc), fixed_weight=f(efix))
    graph = MultiAgentGraph(
        edges=edges,
        meas_id=i64(plan.meas_id),
        n=i32(part.n),
        pose_mask=f(pose_mask),
        pub_idx=i64(np.maximum(plan.pub_idx, 0)),
        pub_mask=f(plan.pub_mask),
        nbr_robot=i64(plan.nbr_robot),
        nbr_pub=i64(plan.nbr_pub),
        nbr_mask=f(plan.nbr_mask),
        global_index=i64(np.maximum(part.global_index, 0)),
        inc_slot=i32(plan.inc_slot),
        inc_mask=f(plan.inc_mask),
        eidx_i=i32(idx_i.reshape(A, nt, 1, T)),
        eidx_j=i32(idx_j.reshape(A, nt, 1, T)),
        rot_t=f32(rot_flat.reshape(A, d * d, nt, T).transpose(0, 2, 1, 3)),
        trn_t=f32(trn_flat.reshape(A, d, nt, T).transpose(0, 2, 1, 3)),
        color=i32(color))
    meta = GraphMeta(num_robots=A, n_max=n_max, e_max=e_max, s_max=s_max,
                     p_max=p_max, d=d, rank=rank, num_colors=num_colors)
    return graph, meta


def with_weights(graph: MultiAgentGraph, weights) -> MultiAgentGraph:
    """Graph with ``edges.weight`` replaced by ``weights [A, E_max]`` — to
    evaluate or refine the objective a robust (GNC) solve minimized
    (``RBCDState.weights``): weight updates live in the state, not in the
    build-time graph."""
    w = graph.edges.weight
    return graph._replace(edges=graph.edges._replace(
        weight=torch.as_tensor(weights, dtype=w.dtype, device=w.device)))


# ---------------------------------------------------------------------------
# Global <-> per-agent layout and the pose exchange
# ---------------------------------------------------------------------------

def scatter_to_agents(Xg: torch.Tensor, graph: MultiAgentGraph):
    """Global pose array [N, ...] -> per-agent [A, n_max, ...]."""
    return Xg[graph.global_index]


def gather_to_global(Xa: torch.Tensor, graph: MultiAgentGraph,
                     n_total: int) -> torch.Tensor:
    """Per-agent [A, n_max, ...] -> global [N, ...] (padding dropped)."""
    flat = Xa.reshape((-1,) + Xa.shape[2:])
    w = graph.pose_mask.reshape((-1,) + (1,) * (Xa.dim() - 2))
    out = torch.zeros((n_total,) + Xa.shape[2:], dtype=Xa.dtype,
                      device=Xa.device)
    return out.index_add_(0, graph.global_index.reshape(-1), flat * w)


def public_table(X: torch.Tensor, graph: MultiAgentGraph) -> torch.Tensor:
    """Each agent's public poses, [A, P_max, r, d+1] — the message payload
    (``getSharedPoseDict``, ``PGOAgent.cpp:95-105``)."""
    return quadratic.take(X, graph.pub_idx)


def neighbor_buffer(Xpub: torch.Tensor,
                    graph: MultiAgentGraph) -> torch.Tensor:
    """Neighbor slots resolved from the public table, [A, S_max, r, d+1]
    (``updateNeighborPoses``, ``PGOAgent.cpp:434-458``)."""
    Z = Xpub[graph.nbr_robot, graph.nbr_pub]
    return Z * graph.nbr_mask[:, :, None, None]


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------

def precond_chol(edges: EdgeSet, graph: MultiAgentGraph,
                 params: AgentParams) -> torch.Tensor:
    """Block-Jacobi preconditioner factors for all agents [A, n_max, k, k],
    from ``edges`` (the graph's, or reweighted) over its ELL incidence."""
    blocks = quadratic.diag_blocks(edges, graph.inc_slot, graph.inc_mask)
    return quadratic.precond_factors(blocks, params.solver.precond_shift)


def _formulation(meta: GraphMeta, params: AgentParams | None,
                 graph: MultiAgentGraph, dtype: torch.dtype,
                 device: torch.device, rtr: bool | None = None) -> str:
    """Which local-solve formulation a round runs: ``"kernel"`` (the fused
    RTR step of ``ops.rtr_kernel``) or ``"ell"`` (plain PyTorch over the
    ELL incidence).  The kernel runs on CUDA, for RTR in float32 — the
    JAX package's rule at its ``rbcd.py:666``; on CUDA there is no other
    condition, so a problem the kernel does not take raises in its wrapper
    instead of running plain PyTorch.  ``pallas_tcg=True`` forces the
    kernel's formulation and raises when it cannot run; on CPU tensors its
    wrapper runs the kernel's plain version.  ``rtr`` says whether the
    round is an RTR step; by default ``params.solver.algorithm`` decides
    (a refine round always is one, ``models.refine``)."""
    if params is None:
        return "ell"
    if params.solver.dense_quadratic:
        raise _not_ported("dense_quadratic", "Queue A item 5")
    if rtr is None:
        rtr = params.solver.algorithm == ROptAlg.RTR
    kernel_ok = rtr and dtype == torch.float32
    if params.solver.pallas_tcg is True:
        if not kernel_ok:
            reason = "algorithm is not RTR" if not rtr else (
                f"the kernel is float32-only and the problem is {dtype}")
            raise ValueError(f"pallas_tcg=True cannot run: {reason}")
        return "kernel"
    if params.solver.pallas_tcg is None and kernel_ok \
            and device.type == "cuda":
        return "kernel"
    return "ell"


def kernel_operands(X: torch.Tensor, Z: torch.Tensor, edges: EdgeSet,
                    chol: torch.Tensor, graph: MultiAgentGraph) -> tuple:
    """The positional operands of ``ops.rtr_kernel.rtr_full`` for one round
    at ``X`` with neighbor buffers ``Z``, in the kernel's layouts.  The
    weighted precisions are plain tensor work outside the kernel, as in the
    JAX package (its ``rbcd.py:735-737``)."""
    A, nt, _, T = graph.eidx_i.shape
    n_max, k = X.shape[-3], X.shape[-1]
    w = edges.mask * edges.weight
    return (graph.eidx_i, graph.eidx_j, graph.rot_t, graph.trn_t,
            rtr_kernel.edge_tiles((w * edges.kappa).float(), nt, T),
            rtr_kernel.edge_tiles((w * edges.tau).float(), nt, T),
            rtr_kernel.comp_major(X.float()),
            rtr_kernel.comp_major(Z.float()),
            chol.float().permute(0, 2, 3, 1).reshape(A, k * k, n_max)
            .contiguous(),
            graph.inc_slot, graph.inc_mask.float().contiguous(), graph.n)


def kernel_options(params: AgentParams, meta: GraphMeta) -> dict:
    """The keyword options of ``ops.rtr_kernel.rtr_full``."""
    sp = params.solver
    return dict(r=meta.rank, d=meta.d, e_max=meta.e_max,
                max_iters=sp.max_inner_iters, kappa=sp.tcg_kappa,
                theta=sp.tcg_theta, initial_radius=sp.initial_radius,
                max_rejections=sp.max_rejections,
                grad_tol=sp.grad_norm_tol)


def _agent_update(X: torch.Tensor, Z: torch.Tensor, edges: EdgeSet,
                  params: AgentParams, chol: torch.Tensor,
                  graph: MultiAgentGraph, meta: GraphMeta,
                  kernel: bool = False):
    """One local solver step for every agent: ``X [A, n, r, k]`` with
    neighbor buffers ``Z [A, s, r, k]``.  Returns the updated blocks and
    the block gradient norms at the starting point [A].

    ``kernel`` runs the fused RTR step (``ops.rtr_kernel.rtr_full``, one
    launch for all agents); otherwise the plain RTR step of ``ops.solver``
    runs over the ELL incidence."""
    n_max = X.shape[-3]
    if params.solver.algorithm == ROptAlg.RGD:
        # Fixed-step projected gradient + retraction, preconditioning off
        # (reference gradientDescent, QuadraticOptimizer.cpp:124-149).
        g = manifold.rgrad(X, _local_egrad(X, Z, edges, graph))
        return (manifold.retract(X, -params.solver.rgd_stepsize * g),
                manifold.norm(g))
    if kernel:
        out = rtr_kernel.rtr_full(
            *kernel_operands(X, Z, edges, chol, graph),
            **kernel_options(params, meta))
        X_new = rtr_kernel.comp_minor(out.X, meta.rank, meta.d + 1)
        return X_new.to(X.dtype).contiguous(), out.stats[:, 4].to(X.dtype)
    inc_slot, inc_mask = graph.inc_slot, graph.inc_mask
    n_buf = n_max + Z.shape[-3]

    def buf(Xl):
        return torch.cat([Xl, Z], dim=-3)

    problem = solver.Problem(
        cost=lambda Xl: quadratic.cost(buf(Xl), edges),
        egrad=lambda Xl: quadratic.egrad_ell(buf(Xl), edges, inc_slot,
                                             inc_mask),
        ehess=lambda Xl, V: quadratic.hessvec_ell(V, edges, inc_slot,
                                                  inc_mask, n_buf),
        precond=lambda Xl, V: quadratic.precond_apply(chol, V))
    out = solver.rtr_single_step(problem, X, params.solver,
                                 final_grad_norm=False)
    return out.X, out.grad_norm_init


def _local_egrad(X: torch.Tensor, Z: torch.Tensor, edges: EdgeSet,
                 graph: MultiAgentGraph) -> torch.Tensor:
    """Every agent's Euclidean gradient at ``[X | Z]`` over the ELL
    incidence, in the iterate's dtype."""
    return quadratic.egrad_ell(torch.cat([X, Z], dim=-3), edges,
                               graph.inc_slot, graph.inc_mask)


def gradient_pass(X: torch.Tensor, graph: MultiAgentGraph, meta: GraphMeta):
    """The exchange and the ELL gradient pass at ``X``, batched over agents
    (the round ablation's ``grad_part``, ``experiments/measure_r3.py:117-
    133``): the Riemannian gradient ``g [A, n, r, k]``, its norm ``gn0 [A]``
    and the curvature term ``S = sym(Y^T G_Y) [A, n, d, d]``."""
    Z = neighbor_buffer(public_table(X, graph), graph)
    eg = _local_egrad(X, Z, graph.edges, graph)
    g = manifold.rgrad(X, eg)
    d = meta.d
    S = manifold.sym(X[..., :d].transpose(-1, -2) @ eg[..., :d])
    return g, manifold.norm(g), S


def b3_operands(X: torch.Tensor, Z: torch.Tensor, g: torch.Tensor,
                S: torch.Tensor, edges: EdgeSet, chol: torch.Tensor,
                graph: MultiAgentGraph) -> tuple:
    """The positional operands of ``ops.rtr_kernel.rtr`` at ``X`` with
    neighbor buffers ``Z``, gradient ``g`` and curvature term ``S``
    (``gradient_pass``): ``kernel_operands`` with the component-major
    ``Sc [A, d*d, n]`` and ``gc [A, r(d+1), n]`` in the kernel's order."""
    ops = kernel_operands(X, Z, edges, chol, graph)
    A, n, d = X.shape[0], X.shape[-3], S.shape[-1]
    Sc = S.float().permute(0, 2, 3, 1).reshape(A, d * d, n).contiguous()
    return (*ops[:8], Sc, ops[8], rtr_kernel.comp_major(g.float()),
            *ops[9:])


def _edge_residuals(X: torch.Tensor, Z: torch.Tensor,
                    edges: EdgeSet) -> torch.Tensor:
    """Unweighted per-edge residual norms sqrt(kappa |rR|^2 + tau |rt|^2)
    for every agent [A, E_max] — ``computeMeasurementError``
    (``DPGO_utils.cpp:509-515``) in the lifted space, as
    ``updateLoopClosuresWeights`` evaluates it (``PGOAgent.cpp:1181-
    1245``)."""
    rR, rt = quadratic._edge_terms(torch.cat([X, Z], dim=-3), edges)
    sq = edges.kappa * torch.sum(rR * rR, dim=(-2, -1)) + \
        edges.tau * torch.sum(rt * rt, dim=-1)
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _gnc_update_weights(X, Z, edges: EdgeSet, mu,
                        params: AgentParams) -> torch.Tensor:
    """Robust weights of every loop-closure edge from the residuals at the
    current iterate and neighbor poses; odometry and known-inlier edges
    keep theirs.  Both endpoint agents of a shared edge evaluate the same
    gathered poses, so their copies agree without the reference's
    ownership rule (``PGOAgent.cpp:1201-1221``)."""
    w_new = robust.weight(_edge_residuals(X, Z, edges), params.robust, mu)
    update = edges.mask * edges.is_lc * (1.0 - edges.fixed_weight)
    return torch.where(update > 0, w_new, edges.weight)


def _converged_weight_ratio(edges: EdgeSet, params: AgentParams):
    """Per-agent fraction of updatable loop closures whose weight is in
    {0, 1} (``computeConvergedLoopClosureRatio``, ``PGOAgent.cpp:1247-
    1289``); None unless the cost is GNC_TLS."""
    if params.robust.cost_type != RobustCostType.GNC_TLS:
        return None
    lc = edges.mask * edges.is_lc * (1.0 - edges.fixed_weight)
    conv = robust.is_weight_converged(edges.weight).to(lc.dtype)
    tot = torch.sum(lc, dim=-1)
    return torch.where(tot > 0, torch.sum(lc * conv, dim=-1)
                       / torch.clamp(tot, min=1.0), torch.ones_like(tot))


def _async_fired(seed: int, iteration: int, num_robots: int, prob: float,
                 device: torch.device) -> torch.Tensor:
    """ASYNC's Bernoulli(``prob``) clock of every agent for the round after
    ``iteration``, drawn on ``device`` from a generator seeded from
    ``(seed, iteration)`` — no host sync.  The one seam the draws pass
    through (the CPU tests replay the JAX package's draws here)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) + iteration)
    return torch.rand(num_robots, generator=gen, device=device) < prob


def _select_agents(tree, sel: torch.Tensor):
    """Rows ``sel`` (a device index) of every tensor of a tensor or
    NamedTuple tree; no host sync."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, sel)
    items = [_select_agents(t, sel) for t in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def _rbcd_round(state: RBCDState, graph: MultiAgentGraph, meta: GraphMeta,
                params: AgentParams, update_weights: bool = False,
                restart: bool = False) -> RBCDState:
    """One RBCD round over all agents (the JAX package's ``_rbcd_round``
    on one device): the public-pose exchange (of X, and of the Nesterov
    point when accelerated), the GNC weight update on flagged rounds, the
    local solves of the agents the schedule fires, and the per-agent status
    (masked relative change, ``PGOAgent.cpp:703-716``, gated by the
    converged-weight ratio under GNC).

    ``update_weights`` and ``restart`` are the host's schedule flags
    (``schedule_bounds``).  A restart round is a plain step followed by the
    collapse of the auxiliary sequences (``restartNesterovAcceleration``,
    ``PGOAgent.cpp:1040-1052``).  Nothing here reads a device value on the
    host."""
    if params.certify_mode != "off":
        raise _not_ported("terminal certification", "Queue A item 4")
    if params.acceleration and state.V is None:
        raise ValueError(
            "params.acceleration is set but the state has no V sequence — "
            "build the state with init_state(..., params=params)")
    robust_on = params.robust.cost_type != RobustCostType.L2
    if robust_on and not params.robust_opt_warm_start \
            and state.X_init is None:
        raise ValueError(
            "robust_opt_warm_start=False requires the state to carry the "
            "initial guess — build it with init_state(..., params=params)")
    accel = params.acceleration
    schedule = params.schedule
    if accel and schedule == Schedule.ASYNC:
        # The reference forbids it (PGOAgent.cpp:863): Nesterov momentum
        # assumes lockstep gamma sequences.
        raise ValueError(
            "acceleration is not supported with the ASYNC schedule")
    X, weights, mu = state.X, state.weights, state.mu
    V, gamma, alpha = state.V, state.gamma, state.alpha
    A = meta.num_robots

    def exchange(Xa):
        return neighbor_buffer(public_table(Xa, graph), graph)

    # The neighbor buffer of X: always un-accelerated; accelerated rounds
    # need it only on weight-update and restart rounds.
    Z = exchange(X) if (not accel or restart or update_weights) else None

    chol = state.chol
    if update_weights:
        # GNC weight update before the pose update (PGOAgent.cpp:654-668),
        # with the freeze decided on the device: from the third flagged
        # round on, once the converged-weight ratio of the PRE-update
        # weights reaches the reference's minimum over all agents, a
        # flagged round computes exactly a plain round.
        edges_r = graph.edges._replace(weight=weights)
        w_new = _gnc_update_weights(X, Z, edges_r, mu, params)
        ratio_pre = _converged_weight_ratio(edges_r, params)
        ordinal = (state.iteration + 1) // params.robust_opt_inner_iters
        if ratio_pre is None or ordinal < 3:
            frozen = torch.zeros((), dtype=torch.bool, device=X.device)
        else:
            frozen = torch.min(ratio_pre) \
                >= params.robust_opt_min_convergence_ratio
        weights = torch.where(frozen, weights, w_new)
        mu = torch.where(frozen, mu, robust.gnc_update_mu(mu, params.robust))
        if state.X_init is not None:
            # Warm start off: restart from the initial guess
            # (PGOAgent.cpp:657-662), which refreshes the exchange.
            X = torch.where(frozen, X, state.X_init)
            Z = exchange(X)
        if accel:  # initializeAcceleration (PGOAgent.cpp:1054-1063)
            V = torch.where(frozen, V, X)
            gamma = torch.where(frozen, gamma, torch.zeros_like(gamma))
            alpha = torch.where(frozen, alpha, torch.zeros_like(alpha))
    edges = graph.edges._replace(weight=weights)
    form = _formulation(meta, params, graph, X.dtype, X.device)
    if update_weights or chol is None:
        # Reweighted Q: refactor the preconditioner (PGOAgent.cpp:1110-
        # 1112); a state built without params factors here too.
        chol = precond_chol(edges, graph, params)

    # Nesterov bookkeeping (PGOAgent.cpp:1065-1091).
    if accel and not restart:
        gamma = (1.0 + torch.sqrt(1.0 + 4.0 * (A * gamma) ** 2)) / (2.0 * A)
        alpha = 1.0 / (gamma * A)
        a = alpha[:, None, None, None]
        Ynes = manifold.project((1.0 - a) * X + a * V)
        start, Zuse = Ynes, exchange(Ynes)
    else:
        start, Zuse = X, Z

    kernel = form == "kernel"
    if schedule == Schedule.GREEDY:
        # One agent fires (the reference demo's argmax of the block
        # gradient norms, MultiRobotExample.cpp:242-256), selected by an
        # ELL pass in the iterate dtype — not the kernel's f32 gn0, so
        # near-ties resolve as in the JAX package — and only it is solved:
        # on CUDA float32, one launch with A = 1 on its slices.
        gn = manifold.norm(manifold.rgrad(
            start, _local_egrad(start, Zuse, edges, graph)))
        sel = torch.argmax(gn).reshape(1)
        x1, z1, e1, c1, g1 = _select_agents((start, Zuse, edges, chol,
                                             graph), sel)
        upd, _ = _agent_update(x1, z1, e1, params, c1, g1, meta,
                               kernel=kernel)
        fired = torch.arange(A, device=X.device) == sel
        X_upd = torch.where(fired[:, None, None, None], upd, start)
    else:
        X_upd, _ = _agent_update(start, Zuse, edges, params, chol, graph,
                                 meta, kernel=kernel)
        if schedule == Schedule.JACOBI:
            fired = None
        elif schedule == Schedule.ASYNC:
            fired = _async_fired(state.seed, state.iteration, A,
                                 params.async_update_prob, X.device)
        elif schedule == Schedule.COLORED:
            # One class of mutually non-adjacent agents per round, cycling.
            fired = graph.color == state.iteration % meta.num_colors
        else:
            raise ValueError(f"unknown schedule {schedule}")
    fired_b = None if fired is None else fired[:, None, None, None]

    if accel and not restart:
        # Agents that did not fire take the momentum point (updateX(false,
        # true), PGOAgent.cpp:1094-1098); V advances for everyone.
        X_next = X_upd if fired_b is None else torch.where(fired_b, X_upd,
                                                           Ynes)
        V = manifold.project(V + gamma[:, None, None, None] * (X_next - Ynes))
    else:
        X_next = X_upd if fired_b is None else torch.where(fired_b, X_upd, X)
        if accel:  # restart round: collapse the auxiliary sequences
            V = X_next
            gamma = torch.zeros_like(gamma)
            alpha = torch.zeros_like(alpha)

    # Status: only fired agents refresh theirs (iterate(false) keeps it).
    diff = (X_next - X) * graph.pose_mask[:, :, None, None]
    rel_new = torch.sqrt(torch.sum(diff * diff, dim=(1, 2, 3))
                         / torch.clamp(graph.n.to(X.dtype), min=1.0))
    ready_new = rel_new <= params.rel_change_tol
    ratio = _converged_weight_ratio(edges, params)
    if ratio is not None:
        ready_new = ready_new & (ratio
                                 >= params.robust_opt_min_convergence_ratio)
    if fired is None:
        rel, ready = rel_new, ready_new
    else:
        rel = torch.where(fired, rel_new, state.rel_change)
        ready = torch.where(fired, ready_new, state.ready)
    return state._replace(X=X_next, weights=weights,
                          iteration=state.iteration + 1, rel_change=rel,
                          ready=ready, chol=chol, V=V, gamma=gamma,
                          alpha=alpha, mu=mu)


#: A round (the JAX package's jitted ``rbcd_step``; PyTorch runs eagerly).
rbcd_step = _rbcd_round


def rbcd_steps(state: RBCDState, graph: MultiAgentGraph, num_rounds: int,
               meta: GraphMeta, params: AgentParams) -> RBCDState:
    """``num_rounds`` consecutive plain rounds (no weight update, no
    restart) — the JAX package's fused ``fori_loop``, here a Python loop
    over the same round that enqueues every launch without a host sync."""
    for _ in range(num_rounds):
        state = _rbcd_round(state, graph, meta, params)
    return state


def rbcd_segment(state: RBCDState, graph: MultiAgentGraph, num_rounds: int,
                 meta: GraphMeta, params: AgentParams,
                 first_update_weights: bool = False,
                 first_restart: bool = False) -> RBCDState:
    """One schedule segment: a (possibly flagged) first round and
    ``num_rounds - 1`` plain rounds.  On CUDA in float32, where every local
    solve is one kernel launch, a segment has no host sync — what a later
    CUDA graph captures.  With both flags False this is ``rbcd_steps``."""
    state = _rbcd_round(state, graph, meta, params,
                        update_weights=first_update_weights,
                        restart=first_restart)
    return rbcd_steps(state, graph, num_rounds - 1, meta, params)


# ---------------------------------------------------------------------------
# Initialization, rounding, and the outer loop
# ---------------------------------------------------------------------------

def init_state(graph: MultiAgentGraph, meta: GraphMeta, X0: torch.Tensor,
               params: AgentParams | None = None, seed: int = 0) -> RBCDState:
    """Fresh solver state at ``X0``: the preconditioner factors are baked
    when the solver params are known; ``V = X0`` when accelerated
    (``initializeAcceleration``); ``X_init = X0`` under a robust cost
    without warm start; ``seed`` keys the ASYNC clocks."""
    A = meta.num_robots
    dtype, dev = X0.dtype, X0.device
    robust_on = params is not None and \
        params.robust.cost_type != RobustCostType.L2
    chol = precond_chol(graph.edges, graph, params) \
        if params is not None else None
    mu0 = params.robust.gnc_init_mu if params is not None else 1e-4
    return RBCDState(
        X=X0, weights=graph.edges.weight, iteration=0,
        rel_change=torch.full((A,), float("inf"), dtype=dtype, device=dev),
        ready=torch.zeros((A,), dtype=torch.bool, device=dev),
        chol=chol,
        V=X0 if params is not None and params.acceleration else None,
        gamma=torch.zeros((A,), dtype=dtype, device=dev),
        alpha=torch.zeros((A,), dtype=dtype, device=dev),
        mu=torch.tensor(mu0, dtype=dtype, device=dev),
        X_init=X0 if robust_on and not params.robust_opt_warm_start
        else None,
        seed=seed)


def lifting_matrix(meta: GraphMeta, dtype=torch.float64,
                   device="cuda") -> torch.Tensor:
    """The shared lifting matrix YLift for this problem's (rank, d)."""
    return _lifting_matrix(meta.rank, meta.d, dtype, device)


def centralized_chordal_init(part: Partition, meta: GraphMeta,
                             graph: MultiAgentGraph,
                             dtype=torch.float64) -> torch.Tensor:
    """Centralized chordal init, lifted and scattered to agents (the demo
    initialization of ``MultiRobotExample.cpp:158-165``), on the graph's
    device."""
    dev = graph.global_index.device
    edges_g = edge_set_from_measurements(part.meas_global, dtype=dtype,
                                         device=dev)
    T0 = chordal.chordal_initialization(edges_g, part.meas_global.num_poses)
    X0g = lift(T0, lifting_matrix(meta, dtype, dev))
    return scatter_to_agents(X0g, graph)


def round_global(Xg: torch.Tensor, ylift: torch.Tensor) -> torch.Tensor:
    """Round a global lifted solution to SE(d) in the frame of pose 0
    (``getTrajectoryInGlobalFrame``, ``PGOAgent.cpp:500-519``)."""
    T = round_solution(Xg, ylift)
    d = ylift.shape[1]
    R, t = T[..., :d], T[..., d]
    Ra_inv = R[0].T
    R_out = Ra_inv @ R
    t_out = (t - t[0]) @ Ra_inv.T
    return torch.cat([R_out, t_out[..., None]], dim=-1)


@dataclasses.dataclass
class RBCDResult:
    T: torch.Tensor  # [N, d, d+1] rounded global trajectory
    X: torch.Tensor  # [A, n_max, r, d+1]
    cost_history: list
    grad_norm_history: list
    iterations: int
    terminated_by: str
    weights: torch.Tensor | None = None  # [M] per-measurement weights
    state: RBCDState | None = None


def global_weights(weights: torch.Tensor, graph: MultiAgentGraph,
                   num_meas: int) -> torch.Tensor:
    """Per-agent edge weights [A, E_max] -> per-measurement [M] (masked
    mean over the copies a shared measurement has)."""
    ids = graph.meas_id.reshape(-1)
    m = graph.edges.mask.reshape(-1)
    num = torch.zeros((num_meas,), dtype=weights.dtype,
                      device=weights.device)
    num.index_add_(0, ids, weights.reshape(-1) * m)
    den = torch.zeros_like(num).index_add_(0, ids, m)
    return torch.where(den > 0, num / torch.clamp(den, min=1.0),
                       torch.ones_like(num))


def schedule_bounds(n_done: int, nwu: int, *, max_iters: int,
                    eval_every: int, params: AgentParams | None,
                    robust_on: bool, accel_on: bool):
    """Flags for round ``n_done + 1`` and the end of its segment: the plain
    rounds run to (exclusive) the next weight-update or restart round,
    capped (inclusive) at the next eval boundary — the JAX package's
    host-side schedule arithmetic, unchanged."""
    cap = params.robust_opt_num_weight_updates if params is not None else 0
    updates_remaining = robust_on and (cap <= 0 or nwu < cap)
    uw = updates_remaining and \
        (n_done + 1) % params.robust_opt_inner_iters == 0
    rs = accel_on and (n_done + 1) % params.restart_interval == 0
    n0 = n_done + 1
    end = max_iters
    if updates_remaining:
        end = min(end, (n0 // params.robust_opt_inner_iters + 1)
                  * params.robust_opt_inner_iters - 1)
    if accel_on:
        end = min(end, (n0 // params.restart_interval + 1)
                  * params.restart_interval - 1)
    end = min(max(end, n0),
              ((n0 - 1) // eval_every + 1) * eval_every, max_iters)
    return uw, rs, end


def run_rbcd(state: RBCDState, graph: MultiAgentGraph, meta: GraphMeta,
             segment, part: Partition, max_iters: int,
             grad_norm_tol: float = 0.1, eval_every: int = 1,
             dtype=torch.float64, params: AgentParams | None = None,
             verdict_every: int | None = None) -> RBCDResult:
    """The per-eval outer loop (``MultiRobotExample.cpp:175-264``): rounds
    run in schedule segments — ``segment(state, k, update_weights,
    restart)`` runs ``k`` rounds, the first one flagged (weight update or
    restart, from ``schedule_bounds``), up to the next flag or eval
    boundary — and every ``eval_every`` rounds the centralized cost and
    Riemannian gradient norm are read back (one stacked host transfer, the
    only sync of the loop).  The solve stops at ``grad_norm_tol`` or when
    every agent is ready (consensus)."""
    if verdict_every is not None:
        raise _not_ported("the device-resident verdict loop",
                          "Queue A item 4")
    dev = state.X.device
    n_total = part.meas_global.num_poses
    num_meas = len(part.meas_global)
    edges_g = edge_set_from_measurements(part.meas_global, dtype=dtype,
                                         device=dev)
    inc_g = quadratic.incidence(n_total, torch.cat([edges_g.i, edges_g.j]))
    robust_on = params is not None and \
        params.robust.cost_type != RobustCostType.L2
    accel_on = params is not None and params.acceleration

    def metrics(s: RBCDState) -> torch.Tensor:
        Xg = gather_to_global(s.X, graph, n_total)
        eg = edges_g._replace(weight=global_weights(s.weights, graph,
                                                    num_meas))
        f = quadratic.cost(Xg, eg)
        g = manifold.rgrad(Xg, quadratic.egrad_ell(Xg, eg, *inc_g))
        return torch.stack([f, manifold.norm(g),
                            torch.all(s.ready).to(f.dtype)])

    cost_hist, gn_hist = [], []
    terminated_by = "max_iters"
    it = 0
    nwu = 0
    while it < max_iters:
        target = min(((it // eval_every) + 1) * eval_every, max_iters)
        while it < target:
            uw, rs, end = schedule_bounds(
                it, nwu, max_iters=max_iters, eval_every=eval_every,
                params=params, robust_on=robust_on, accel_on=accel_on)
            nwu += int(uw)
            state = segment(state, end - it, uw, rs)
            it = end
        f, gn, consensus = metrics(state).tolist()  # the one host sync
        cost_hist.append(f)
        gn_hist.append(gn)
        if gn < grad_norm_tol:
            terminated_by = "grad_norm"
            break
        if consensus > 0:
            terminated_by = "consensus"
            break

    Xg = gather_to_global(state.X, graph, n_total)
    T = round_global(Xg, lifting_matrix(meta, Xg.dtype, dev))
    return RBCDResult(T=T, X=state.X, cost_history=cost_hist,
                      grad_norm_history=gn_hist, iterations=it,
                      terminated_by=terminated_by,
                      weights=global_weights(state.weights, graph, num_meas),
                      state=state)


@dataclasses.dataclass(frozen=True)
class PreparedProblem:
    """A built, dispatch-ready problem: partition, per-agent graph on its
    device, metadata and the initial lifted state."""

    part: Partition
    graph: MultiAgentGraph
    meta: GraphMeta
    params: AgentParams
    dtype: torch.dtype
    X0: torch.Tensor | None = None


def prepare_problem(meas: Measurements, num_robots: int,
                    params: AgentParams | None = None, dtype=None,
                    part: Partition | None = None,
                    init: str | None = "chordal",
                    device="cuda") -> PreparedProblem:
    """Problem build: partition, per-agent graph assembly on ``device``
    and (unless ``init=None``) the centralized chordal initial state.
    ``dtype`` defaults to float32 on CUDA and float64 on the CPU."""
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    params = params or AgentParams(d=meas.d, r=5, num_robots=num_robots)
    part = part or partition_contiguous(meas, num_robots)
    graph, meta = build_graph(part, params.r, dtype, dev)
    X0 = None
    if init == "chordal":
        X0 = centralized_chordal_init(part, meta, graph, dtype)
    elif init is not None:
        raise _not_ported(f"init={init!r}", "Queue A item 4")
    return PreparedProblem(part=part, graph=graph, meta=meta, params=params,
                           dtype=dtype, X0=X0)


def dispatch_prepared(prob: PreparedProblem, max_iters: int | None = None,
                      grad_norm_tol: float = 0.1, eval_every: int = 1,
                      state: RBCDState | None = None,
                      verdict_every: int | None = None) -> RBCDResult:
    """Solve a prepared problem with the outer loop; ``state`` overrides
    the fresh ``init_state`` (e.g. to resume)."""
    params = prob.params
    max_iters = params.max_num_iters if max_iters is None else max_iters
    if state is None:
        if prob.X0 is None:
            raise ValueError("prepared problem has no initial state — "
                             "prepare with init=... or pass state=")
        state = init_state(prob.graph, prob.meta, prob.X0, params=params)
    graph, meta = prob.graph, prob.meta

    def seg(s, k, uw, rs):
        return rbcd_segment(s, graph, k, meta, params,
                            first_update_weights=uw, first_restart=rs)

    return run_rbcd(state, graph, meta, seg, prob.part, max_iters,
                    grad_norm_tol, eval_every, prob.dtype, params=params,
                    verdict_every=verdict_every)


def solve_rbcd(meas: Measurements, num_robots: int,
               params: AgentParams | None = None,
               max_iters: int | None = None, grad_norm_tol: float = 0.1,
               eval_every: int = 1, dtype=None,
               part: Partition | None = None, init: str = "chordal",
               verdict_every: int | None = None,
               device="cuda") -> RBCDResult:
    """Distributed solve on one device with centralized monitoring —
    ``prepare_problem`` + ``dispatch_prepared``.  Runs on CUDA unless
    ``device="cpu"`` is asked for."""
    prob = prepare_problem(meas, num_robots, params=params, dtype=dtype,
                           part=part, init=init, device=device)
    return dispatch_prepared(prob, max_iters=max_iters,
                             grad_norm_tol=grad_norm_tol,
                             eval_every=eval_every,
                             verdict_every=verdict_every)


def solve_rbcd_robust_iterated(meas: Measurements, num_robots: int,
                               params: AgentParams | None = None,
                               passes: int = 2, reject_thresh: float = 0.5,
                               **solve_kw):
    """Iterated GNC (robust solve, drop rejected loop closures, re-anneal);
    not ported yet."""
    raise _not_ported("solve_rbcd_robust_iterated", "Queue A item 4")

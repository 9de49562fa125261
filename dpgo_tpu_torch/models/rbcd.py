"""Multi-agent Riemannian block-coordinate descent (RBCD) on one device —
the PyTorch port of ``dpgo_tpu.models.rbcd``.

All agents' states live in one batched tensor ``X: [A, n_max, r, d+1]``;
a round exchanges the public poses into each agent's neighbor buffer and
solves every agent's local problem at once.  The JAX package vmaps the
per-agent solve; here the agent axis is a leading batch dimension, and on
a CUDA device the whole local RTR step of every agent is one launch of the
hand-written kernel of ``ops.rtr_kernel``.

Ported so far: the JACOBI schedule with the L2 cost, un-accelerated, and
the per-eval outer loop.  GREEDY / ASYNC / COLORED, Nesterov
acceleration, GNC, the device-resident verdict loop, certification and the
dense-Q formulation raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

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
    X: torch.Tensor  # [A, n_max, r, d+1]
    weights: torch.Tensor  # [A, E_max] per-edge weights
    iteration: int
    rel_change: torch.Tensor  # [A]
    ready: torch.Tensor  # [A] bool
    chol: torch.Tensor | None = None  # [A, n_max, d+1, d+1] precond factors


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

def precond_chol(edges: EdgeSet, n_max: int, s_max: int,
                 params: AgentParams) -> torch.Tensor:
    """Block-Jacobi preconditioner factors for all agents [A, n_max, k, k]."""
    blocks = quadratic.diag_blocks(edges, n_max + s_max, n_out=n_max)
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
        buf = torch.cat([X, Z], dim=-3)
        g = manifold.rgrad(X, quadratic.egrad(buf, edges, n_out=n_max))
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


def _check_ported(params: AgentParams, update_weights: bool,
                  restart: bool) -> None:
    if params.schedule != Schedule.JACOBI:
        raise _not_ported(f"Schedule.{params.schedule.name}",
                          "Queue A item 4")
    if params.acceleration or restart:
        raise _not_ported("Nesterov acceleration", "Queue A item 4")
    if params.robust.cost_type != RobustCostType.L2 or update_weights:
        raise _not_ported("robust costs and GNC weight updates",
                          "Queue A item 4")
    if params.certify_mode != "off":
        raise _not_ported("terminal certification", "Queue A item 4")


def _rbcd_round(state: RBCDState, graph: MultiAgentGraph, meta: GraphMeta,
                params: AgentParams, update_weights: bool = False,
                restart: bool = False) -> RBCDState:
    """One synchronous JACOBI round over all agents: the public-pose
    exchange, every agent's local RTR step, and the per-agent status
    (masked relative change, reference ``PGOAgent.cpp:703-716``)."""
    _check_ported(params, update_weights, restart)
    X = state.X
    Z = neighbor_buffer(public_table(X, graph), graph)
    edges = graph.edges._replace(weight=state.weights)
    chol = state.chol
    if chol is None:
        chol = precond_chol(edges, meta.n_max, meta.s_max, params)
    form = _formulation(meta, params, graph, X.dtype, X.device)
    X_next, _ = _agent_update(X, Z, edges, params, chol, graph, meta,
                              kernel=form == "kernel")
    diff = (X_next - X) * graph.pose_mask[:, :, None, None]
    rel = torch.sqrt(torch.sum(diff * diff, dim=(1, 2, 3))
                     / torch.clamp(graph.n.to(X.dtype), min=1.0))
    return state._replace(X=X_next, iteration=state.iteration + 1,
                          rel_change=rel,
                          ready=rel <= params.rel_change_tol, chol=chol)


#: A round (the JAX package's jitted ``rbcd_step``; PyTorch runs eagerly).
rbcd_step = _rbcd_round


# ---------------------------------------------------------------------------
# Initialization, rounding, and the outer loop
# ---------------------------------------------------------------------------

def init_state(graph: MultiAgentGraph, meta: GraphMeta, X0: torch.Tensor,
               params: AgentParams | None = None) -> RBCDState:
    """Fresh solver state at ``X0``; the preconditioner factors are baked
    when the solver params are known."""
    A = meta.num_robots
    chol = precond_chol(graph.edges, meta.n_max, meta.s_max, params) \
        if params is not None else None
    return RBCDState(
        X=X0, weights=graph.edges.weight, iteration=0,
        rel_change=torch.full((A,), float("inf"), dtype=X0.dtype,
                              device=X0.device),
        ready=torch.zeros((A,), dtype=torch.bool, device=X0.device),
        chol=chol)


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
             step, part: Partition, max_iters: int,
             grad_norm_tol: float = 0.1, eval_every: int = 1,
             dtype=torch.float64, params: AgentParams | None = None,
             verdict_every: int | None = None) -> RBCDResult:
    """The per-eval outer loop (``MultiRobotExample.cpp:175-264``):
    ``step(state, update_weights, restart)`` runs one round; every
    ``eval_every`` rounds the centralized cost and Riemannian gradient norm
    are read back (one stacked host transfer) and the solve stops at
    ``grad_norm_tol`` or when every agent is ready (consensus)."""
    if verdict_every is not None:
        raise _not_ported("the device-resident verdict loop",
                          "Queue A item 4")
    dev = state.X.device
    n_total = part.meas_global.num_poses
    num_meas = len(part.meas_global)
    edges_g = edge_set_from_measurements(part.meas_global, dtype=dtype,
                                         device=dev)
    robust_on = params is not None and \
        params.robust.cost_type != RobustCostType.L2
    accel_on = params is not None and params.acceleration

    def metrics(s: RBCDState) -> torch.Tensor:
        Xg = gather_to_global(s.X, graph, n_total)
        eg = edges_g._replace(weight=global_weights(s.weights, graph,
                                                    num_meas))
        f = quadratic.cost(Xg, eg)
        g = manifold.rgrad(Xg, quadratic.egrad(Xg, eg))
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
            state = step(state, uw, rs)
            for _ in range(end - it - 1):
                state = step(state, False, False)
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

    def step(s, uw, rs):
        return _rbcd_round(s, graph, meta, params, update_weights=uw,
                           restart=rs)

    return run_rbcd(state, graph, meta, step, prob.part, max_iters,
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

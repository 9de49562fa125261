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
segment), both drivers of ``run_rbcd`` (the per-eval loop and the
device-resident verdict loop, each with its depth-1 speculation), the
terminal epilogue with the device or host certificate
(``certify_mode``), the telemetry of both drivers (``obs``: metric
events, the health monitor, the flight recorder, the sync-rate metric),
the chordal and odometry inits and
``solve_rbcd_robust_iterated``, the distributed init
(``models.dist_init``) and the dense-Q formulation (the local problem as
matmuls against the materialized per-agent Q, ``dense_q_all``).  With a
``mesh`` (``parallel.sharded``) a round is one rank's share of the
sharded round: the exchange plans (``plan_ppermute``, ``_exchange_for``)
and the pipelined halo of ``rbcd_steps(overlap=True)``.

One deliberate deviation: ASYNC's Bernoulli clocks draw from a
``torch.Generator`` seeded from ``(seed, iteration)`` (``_async_fired``),
not from JAX's threefry key chain — the same distribution, another stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import obs, robust
from ..config import AgentParams, ROptAlg, RobustCostType, Schedule
from ..device import default_dtype, resolve_device, sync_free
from ..obs import recorder, trace
from ..obs.health import HealthConfig
from ..ops import manifold, quadratic, rtr_kernel, solver
from ..types import (EdgeSet, Measurements, edge_set_from_measurements,
                     loop_closure_mask)
from ..utils.graph_plan import color_agents, plan_topology
from ..utils.lie import lifting_matrix as _lifting_matrix
from ..utils.partition import (Partition, gather_poses_to_global,
                               partition_contiguous)
from .local_pgo import initial_poses, lift, round_solution

#: Edge-tile width of the tile-major edge layout (the JAX package's
#: ``pallas_tcg.TILE``); halved for pose buffers above 1024 slots.
TILE = 256


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
    # Block incidence of the dense Q over the [n_max + S_max] buffer
    # (``quadratic.dense_q_incidence``: target, slot, mask).
    dense_inc: tuple | None = None


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
    # [A, (d+1)(n_max+s_max), (d+1)(n_max+s_max)] materialized buffer
    # Laplacians (``dense_q_all``) of the dense-Q formulation; None unless
    # it runs.  Same refresh schedule as ``chol``.
    Qbuf: torch.Tensor | None = None


def edge_tile_shape(n_max: int, s_max: int, e_max: int) -> tuple[int, int]:
    """(T, nt) of the tile-major edge layout, as the JAX package's f32
    kernel lays it out."""
    T = TILE if (n_max + s_max) <= 1024 else TILE // 2
    return T, max(1, -(-e_max // T))


def edge_tile_layout(ei, ej, R, t, valid, n_max: int, s_max: int,
                     device) -> dict:
    """The kernel's tile-major edge fields of a graph (``eidx_i``,
    ``eidx_j``, ``rot_t``, ``trn_t``) from its host edge rows ``ei, ej
    [A, E]``, ``R [A, E, d, d]``, ``t [A, E, d]`` and row mask ``valid
    [A, E]`` (None: every row), on ``device``: rows padded to
    ``edge_tile_shape(n_max, s_max, E)``, the endpoints of masked and
    padded rows at the index ``n_max + s_max`` (neither a local pose nor a
    neighbor slot), rotations and translations in float32.  The one
    builder of ``build_graph``, ``agent_graph``, the serving plane's
    ``serve.bucketing.pad_problem`` and ``models.incremental.LiveProblem``,
    so a padded or delta-updated graph carries the layout a fresh build
    would."""
    ei = np.asarray(ei)
    ej = np.asarray(ej)
    R = np.asarray(R)
    t = np.asarray(t)
    A, E = ei.shape
    d = R.shape[-1]
    valid = np.ones((A, E), bool) if valid is None \
        else np.asarray(valid).astype(bool)
    T, nt = edge_tile_shape(n_max, s_max, E)
    Ep = nt * T
    idx_i = np.full((A, Ep), n_max + s_max, np.int32)
    idx_j = np.full((A, Ep), n_max + s_max, np.int32)
    idx_i[:, :E][valid] = ei[valid]
    idx_j[:, :E][valid] = ej[valid]
    rot = np.zeros((A, d * d, Ep), np.float32)
    trn = np.zeros((A, d, Ep), np.float32)
    rot[:, :, :E] = R.transpose(0, 2, 3, 1).reshape(A, d * d, E)
    trn[:, :, :E] = t.transpose(0, 2, 1)

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return dict(
        eidx_i=put(idx_i.reshape(A, nt, 1, T)),
        eidx_j=put(idx_j.reshape(A, nt, 1, T)),
        rot_t=put(rot.reshape(A, d * d, nt, T).transpose(0, 2, 1, 3)),
        trn_t=put(trn.reshape(A, d, nt, T).transpose(0, 2, 1, 3)))


def build_graph(part: Partition, rank: int, dtype=torch.float64,
                device="cuda", planner: str = "auto"
                ) -> tuple[MultiAgentGraph, GraphMeta]:
    """Padded per-agent arrays from a partitioned measurement set: each
    shared measurement appears in both endpoint agents' edge lists with the
    remote endpoint redirected to a neighbor slot (``PGOAgent.cpp:228-
    248``).  Topology from the planner (``utils.graph_plan.plan_topology``
    with ``backend=planner``: native C++ when it builds, else Python —
    identical output)."""
    dev = resolve_device(device)
    A = part.num_robots
    meas = part.meas
    d = meas.d
    n_max = part.n_max

    plan = plan_topology(meas.r1, meas.p1, meas.r2, meas.p2, A, n_max,
                         backend=planner)
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
        **edge_tile_layout(plan.ei, plan.ej, eR, et, valid, n_max, s_max,
                           dev),
        color=i32(color),
        dense_inc=quadratic.dense_q_incidence(plan.ei, plan.ej,
                                              n_max + s_max, dev))
    meta = GraphMeta(num_robots=A, n_max=n_max, e_max=e_max, s_max=s_max,
                     p_max=p_max, d=d, rank=rank, num_colors=num_colors)
    return graph, meta


def agent_graph(edges: EdgeSet, n: int, s: int,
                rank: int) -> tuple[MultiAgentGraph, GraphMeta]:
    """The A=1 view of ONE robot's problem that the round's operands read
    (``kernel_operands``, ``_agent_local_problem``): ``edges`` is the
    robot's own edge list over its ``[n + s]`` buffer (own poses, then
    ``s`` neighbor slots; ``agent.PGOAgent``), unbatched.  Returns the
    edges batched to ``[1, E]``, the ELL incidence of the ``n`` local poses
    (slot ``e`` for endpoint i of edge e, ``E + e`` for endpoint j, in edge
    order), the tile-major kernel arrays at ``edge_tile_shape(n, s, E)``
    (padding index ``n + s``) and ``n``; the exchange tables are single
    placeholders, as a robot exchanges through its transport.  The port's
    counterpart of the JAX package's ``_edge_tile_shape`` +
    ``agent_edge_tiles`` (its ``rbcd.py:518-620``)."""
    dev = edges.R.device
    d = edges.d
    E = int(edges.i.shape[0])
    ei = edges.i.cpu().numpy().astype(np.int64)
    ej = edges.j.cpu().numpy().astype(np.int64)
    inc: list[list[int]] = [[] for _ in range(n)]
    for e in range(E):
        if ei[e] < n:
            inc[ei[e]].append(e)
        if ej[e] < n:
            inc[ej[e]].append(E + e)
    K = max(1, max((len(r) for r in inc), default=1))
    inc_slot = np.zeros((1, n, K), np.int32)
    inc_mask = np.zeros((1, n, K), np.float64)
    for v, row in enumerate(inc):
        inc_slot[0, v, :len(row)] = row
        inc_mask[0, v, :len(row)] = 1.0
    fdt = edges.R.dtype

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32),
                               device=dev)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=fdt,
                               device=dev)

    graph = MultiAgentGraph(
        edges=EdgeSet(*(t[None] for t in edges)),
        meas_id=i64(np.arange(E)[None]),
        n=i32([n]),
        pose_mask=f(np.ones((1, n))),
        pub_idx=i64(np.zeros((1, 1))),
        pub_mask=f(np.zeros((1, 1))),
        nbr_robot=i64(np.zeros((1, s))),
        nbr_pub=i64(np.zeros((1, s))),
        nbr_mask=f(np.ones((1, s))),
        global_index=i64(np.arange(n)[None]),
        inc_slot=i32(inc_slot),
        inc_mask=f(inc_mask),
        **edge_tile_layout(ei[None], ej[None], edges.R.cpu().numpy()[None],
                           edges.t.cpu().numpy()[None], None, n, s, dev),
        color=i32([0]))
    meta = GraphMeta(num_robots=1, n_max=n, e_max=E, s_max=s,
                     p_max=1, d=d, rank=rank)
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


class PPermutePlan(NamedTuple):
    """Per-agent routing of the shift-based pose exchange ([A, S_max]
    tensors, sharded over agents like the rest of the graph): ``src``
    indexes the stacked tables (0 = this rank's own, ``1 + i`` = the one
    received at ``shifts[i]``), ``lrobot`` is the neighbor robot's index on
    its home rank."""

    src: torch.Tensor
    lrobot: torch.Tensor


def plan_ppermute(graph: MultiAgentGraph, num_robots: int, n_dev: int):
    """Host-side routing plan of the shift-based neighbor exchange (the
    JAX package's ``plan_ppermute``): the nonzero ring offsets between the
    ranks of two agents joined by an edge, with agents in contiguous
    blocks of ``num_robots // n_dev`` per rank (``parallel.shard_problem``
    lays them out so).  Returns ``(shifts, plan)``: one point-to-point
    exchange per shift, and the per-agent routing tensors on the graph's
    device."""
    if num_robots % n_dev != 0:
        raise ValueError(
            f"num_robots={num_robots} must be a multiple of n_dev={n_dev} "
            "(contiguous agent blocks per device, as shard_problem lays out)")
    A_loc = num_robots // n_dev
    nbr_robot = graph.nbr_robot.cpu().numpy()
    nbr_mask = graph.nbr_mask.cpu().numpy() > 0
    dev_of = np.arange(num_robots) // A_loc
    s = np.where(nbr_mask, (dev_of[:, None] - dev_of[nbr_robot]) % n_dev, 0)
    shifts = tuple(sorted(set(s[nbr_mask].astype(int).tolist()) - {0}))
    pos = {0: 0, **{sh: i + 1 for i, sh in enumerate(shifts)}}
    src = np.zeros_like(s)
    for sh, p in pos.items():
        src[s == sh] = p
    dev = graph.nbr_robot.device
    plan = PPermutePlan(src=torch.as_tensor(src, dtype=torch.int64,
                                            device=dev),
                        lrobot=torch.as_tensor(nbr_robot % A_loc,
                                               dtype=torch.int64, device=dev))
    return shifts, plan


def _ppermute_start(Xl: torch.Tensor, graph: MultiAgentGraph,
                    plan: PPermutePlan, shifts: tuple, mesh):
    """Start the neighbor exchange by one point-to-point transfer per
    planned shift (rank i sends its public table to ``i + s``); the
    returned callable waits and resolves the slots — the same buffer as
    the all-gather route, bit for bit."""
    T = public_table(Xl, graph)
    recv = mesh.ppermute_start(T, shifts)

    def resolve():
        stacked = torch.stack([T, *recv()])
        Z = stacked[plan.src, plan.lrobot, graph.nbr_pub]
        return Z * graph.nbr_mask[:, :, None, None]

    return resolve


#: Collective fault-injection hook (``parallel.resilience``): when set,
#: every exchange built by ``_exchange_for`` passes through it, so chaos
#: tests can corrupt halo payloads at the seam itself.
_exchange_wrap = None


def _exchange_for(graph: MultiAgentGraph, mesh,
                  plan: PPermutePlan | None, shifts: tuple):
    """The pose exchange of a round as ``start(Xl)``, which issues the
    collective and returns a callable that waits for it and gives the
    neighbor buffer: the all-gathered public table (v1), the shift-based
    point-to-point route when a ``plan`` is given, plain gathers with
    ``mesh=None``.  Split so the overlapped loop (``rbcd_steps(overlap=
    True)``) can issue the next round's exchange right after the Stiefel
    update and wait for it in the next round."""
    if mesh is None:
        if plan is not None:
            raise ValueError("ppermute exchange requires a mesh")

        def start(Xl):
            Z = neighbor_buffer(public_table(Xl, graph), graph)
            return lambda: Z
    elif plan is None:
        def start(Xl):
            pending = mesh.all_gather_start(public_table(Xl, graph))
            return lambda: neighbor_buffer(pending(), graph)
    else:
        def start(Xl):
            return _ppermute_start(Xl, graph, plan, shifts, mesh)

    if _exchange_wrap is not None:
        wrapped = _exchange_wrap(lambda Xl, _s=start: _s(Xl)())

        def start(Xl, _w=wrapped):
            Z = _w(Xl)
            return lambda: Z
    return start


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------

def precond_chol(edges: EdgeSet, graph: MultiAgentGraph,
                 params: AgentParams) -> torch.Tensor:
    """Block-Jacobi preconditioner factors for all agents [A, n_max, k, k],
    from ``edges`` (the graph's, or reweighted) over its ELL incidence."""
    blocks = quadratic.diag_blocks(edges, graph.inc_slot, graph.inc_mask)
    return quadratic.precond_factors(blocks, params.solver.precond_shift)


#: Dense-Q memory budget: the [A, K, K] buffer Laplacians (K = (d+1)
#: (n_max + s_max)) must fit beside the rest of the problem (the sphere2500
#: stand-in at 8 agents takes 347.6 MB in float32).
DENSE_Q_BUDGET_BYTES = 1 << 30


def use_dense_q(meta: GraphMeta, params: AgentParams | None,
                itemsize: int) -> bool:
    """Whether the (opt-in) dense-Q formulation applies: requested through
    ``SolverParams.dense_quadratic`` and within ``DENSE_Q_BUDGET_BYTES`` at
    the problem's ``itemsize`` (4 for float32, 8 for float64)."""
    if params is None or not params.solver.dense_quadratic:
        return False
    K = (meta.d + 1) * (meta.n_max + meta.s_max)
    return meta.num_robots * K * K * itemsize <= DENSE_Q_BUDGET_BYTES


def _dense(meta: GraphMeta, params: AgentParams | None,
           dtype: torch.dtype) -> bool:
    """Whether ``_formulation`` picks "dense" for an RBCD round (a forced
    kernel comes first); never raises, so ``init_state`` can ask it."""
    return params is not None and params.solver.pallas_tcg is not True \
        and params.solver.algorithm == ROptAlg.RTR \
        and use_dense_q(meta, params, dtype.itemsize)


def _formulation(meta: GraphMeta, params: AgentParams | None,
                 graph: MultiAgentGraph, dtype: torch.dtype,
                 device: torch.device, rtr: bool | None = None) -> str:
    """Which local-solve formulation a round runs, in the JAX package's
    order (its ``rbcd.py:651-690``): a forced kernel, then the dense-Q
    opt-in (``"dense"``, when ``use_dense_q`` allows it), then the
    automatic kernel, then ``"ell"`` (plain PyTorch over the ELL
    incidence).  ``"kernel"`` is the fused RTR step of ``ops.rtr_kernel``:
    it runs on CUDA, for RTR in float32, with no other condition, so a
    problem the kernel does not take raises in its wrapper instead of
    running plain PyTorch.  ``pallas_tcg=True`` forces it and raises when
    it cannot run; on CPU tensors its wrapper runs the kernel's plain
    version.  ``rtr`` says whether the round is an RTR step; by default
    ``params.solver.algorithm`` decides.  A refine round passes
    ``rtr=True``: it always is one, and has no dense form."""
    if params is None:
        return "ell"
    rbcd_round = rtr is None
    if rtr is None:
        rtr = params.solver.algorithm == ROptAlg.RTR
    kernel_ok = rtr and dtype == torch.float32
    if params.solver.pallas_tcg is True:
        if not kernel_ok:
            reason = "algorithm is not RTR" if not rtr else (
                f"the kernel is float32-only and the problem is {dtype}")
            raise ValueError(f"pallas_tcg=True cannot run: {reason}")
        return "kernel"
    if rbcd_round and _dense(meta, params, dtype):
        return "dense"
    if params.solver.pallas_tcg is None and kernel_ok \
            and device.type == "cuda":
        return "kernel"
    return "ell"


def dense_q_all(graph_edges: EdgeSet, meta: GraphMeta,
                inc=None) -> torch.Tensor:
    """Buffer Laplacians of all agents [A, K, K] (``quadratic.dense_q``),
    summed through the graph's ``dense_inc`` where it is given."""
    return quadratic.dense_q(graph_edges, meta.n_max + meta.s_max, inc)


def kernel_operands(X: torch.Tensor, Z: torch.Tensor, edges: EdgeSet,
                    chol: torch.Tensor, graph: MultiAgentGraph) -> tuple:
    """The positional operands of ``ops.rtr_kernel.rtr_full`` for one round
    at ``X`` with neighbor buffers ``Z``, in the kernel's layouts.  The
    weighted precisions are plain tensor work outside the kernel, as in the
    JAX package (its ``rbcd.py:735-737``)."""
    if graph.eidx_i is None:
        raise ValueError(
            "the graph carries no tile-major edge fields (eidx_i, eidx_j, "
            "rot_t, trn_t), which the kernel reads; build it with "
            "build_graph, or pad it with serve.bucketing.pad_problem")
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


def _agent_local_problem(Z: torch.Tensor, edges: EdgeSet, chol: torch.Tensor,
                         graph: MultiAgentGraph, n_max: int,
                         qbuf: torch.Tensor | None = None,
                         X0: torch.Tensor | None = None) -> solver.Problem:
    """Every agent's local problem with its neighbor buffer ``Z`` fixed.

    With ``qbuf`` (the materialized buffer Laplacians, ``dense_q_all``):
    gradient and Hessian-vector product are matmuls against ``Q_ll`` and
    the linear term ``G = Z Q_nl`` of the round — the reference's own
    ``f = 0.5 <Q, X^T X> + <X, G>`` form (``QuadraticProblem.cpp:50-73``).
    The cost is that quadratic expanded about the round's start ``X0``:
    ``f(X0) + <X0 Q_ll + G, U> + 0.5 <U Q_ll, U>`` with ``U = X - X0``
    and ``f(X0)`` the edge sum — the same function, but in float32 the
    JAX package's ``0.5 <X Q, X> + <X, G> + 0.5 <Z Q_nn, Z>`` is the small
    difference of terms ~1e8 times larger at the sphere2500 stand-in's
    scale, and loses every digit the trust-region test reads.  Otherwise
    the ELL edge path (``quadratic.egrad_ell``)."""
    n_buf = n_max + Z.shape[-3]
    if qbuf is not None:
        nl = n_max * Z.shape[-1]
        Qll = qbuf[..., :nl, :nl].contiguous()
        G = quadratic.to_mat(Z) @ qbuf[..., nl:, :nl]  # [A, r, (d+1) n]
        X0m = quadratic.to_mat(X0)
        f0 = quadratic.cost(torch.cat([X0, Z], dim=-3), edges)
        E0 = X0m @ Qll + G

        def cost_d(Xl):
            U = quadratic.to_mat(Xl) - X0m
            return f0 + torch.sum((E0 + 0.5 * (U @ Qll)) * U, dim=(-2, -1))

        def egrad_d(Xl):
            return quadratic.from_mat(quadratic.to_mat(Xl) @ Qll + G, n_max)

        def ehess_d(Xl, V):
            return quadratic.from_mat(quadratic.to_mat(V) @ Qll, n_max)

        return solver.Problem(
            cost=cost_d, egrad=egrad_d, ehess=ehess_d,
            precond=lambda Xl, V: quadratic.precond_apply(chol, V))
    inc_slot, inc_mask = graph.inc_slot, graph.inc_mask

    def buf(Xl):
        return torch.cat([Xl, Z], dim=-3)

    return solver.Problem(
        cost=lambda Xl: quadratic.cost(buf(Xl), edges),
        egrad=lambda Xl: quadratic.egrad_ell(buf(Xl), edges, inc_slot,
                                             inc_mask),
        ehess=lambda Xl, V: quadratic.hessvec_ell(V, edges, inc_slot,
                                                  inc_mask, n_buf),
        precond=lambda Xl, V: quadratic.precond_apply(chol, V))


def _agent_update(X: torch.Tensor, Z: torch.Tensor, edges: EdgeSet,
                  params: AgentParams, chol: torch.Tensor,
                  graph: MultiAgentGraph, meta: GraphMeta,
                  kernel: bool = False, qbuf: torch.Tensor | None = None):
    """One local solver step for every agent: ``X [A, n, r, k]`` with
    neighbor buffers ``Z [A, s, r, k]``.  Returns the updated blocks and
    the block gradient norms at the starting point [A].

    ``kernel`` runs the fused RTR step (``ops.rtr_kernel.rtr_full``, one
    launch for all agents); otherwise the plain RTR step of ``ops.solver``
    runs over the ELL incidence, or with ``qbuf`` over the dense Q.  On a
    CUDA device the dense step runs its loops to their fixed bounds, the
    finished lanes frozen, so it reads nothing on the host."""
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
    problem = _agent_local_problem(Z, edges, chol, graph, n_max, qbuf, X)
    out = solver.rtr_single_step(
        problem, X, params.solver, final_grad_norm=False,
        fixed_bounds=qbuf is not None and sync_free(X))
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


def _per_agent(v: torch.Tensor, A: int, ndim: int = 1) -> torch.Tensor:
    """A per-problem value at every agent row, broadcastable against a
    tensor of ``ndim`` dimensions: a 0-dim value (one problem) as it is,
    a ``[B]`` one (the members of a served batch, ``serve.runner``)
    repeated over each member's ``A`` agents."""
    if v.dim() == 0:
        return v
    return v.repeat_interleave(A).reshape((-1,) + (1,) * (ndim - 1))


def _rbcd_round(state: RBCDState, graph: MultiAgentGraph, meta: GraphMeta,
                params: AgentParams, update_weights: bool = False,
                restart: bool = False, mesh=None,
                plan: PPermutePlan | None = None, shifts: tuple = (),
                halo=None, return_halo: bool = False):
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
    host.

    The same round steps a served batch of ``B`` problems
    (``serve.runner``): ``graph`` holds every member's agents in one
    ``[B*A, ...]`` axis (``meta`` stays one member's, A = its
    ``num_robots``), ``state.mu`` is ``[B]``, and what the JAX package's
    vmap keeps per member stays per member here: GNC's freeze test and
    ``mu``, Nesterov's ``A``, GREEDY's argmax, COLORED's classes and
    ASYNC's clocks.  The local step is still one launch for all
    ``B*A`` agents.

    With ``mesh`` (a ``parallel.sharded.Mesh``; the JAX package's
    ``axis_name``) the round is one rank's share of a sharded round: the
    state and graph hold this rank's ``A_loc`` contiguous agents, the
    public tables are all-gathered over the mesh (or sent along the
    ``plan``/``shifts`` of ``plan_ppermute``), GNC's freeze takes the
    minimum ratio over all ranks, GREEDY the argmax of the gathered block
    gradient norms, and ASYNC's clocks and the agent ids are global.  The
    local step is still one launch, over the rank's agents.  ``halo`` (a
    callable from the exchange's ``start``; plain rounds only) supplies the
    current iterate's neighbor buffer, and ``return_halo`` also returns the
    next round's, issued right after the Stiefel update — the pipelined
    halo of ``rbcd_steps(overlap=True)``; the values are the same."""
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
    A_loc = X.shape[0]
    # Members of a served batch (``serve.runner``); a shard is one member.
    B = 1 if mesh is not None else A_loc // A
    offset = mesh.rank * A_loc if mesh is not None else 0
    start_exchange = _exchange_for(graph, mesh, plan, shifts)

    def exchange(Xa):
        return start_exchange(Xa)()

    if halo is not None and update_weights:
        raise ValueError(
            "a precomputed halo cannot serve a weight-update round: the "
            "warm-start-off path resets X and must re-exchange")
    # The neighbor buffer of X: always un-accelerated; accelerated rounds
    # need it only on weight-update and restart rounds.
    Z = None
    if not accel or restart or update_weights:
        Z = halo() if halo is not None else exchange(X)

    chol = state.chol
    qbuf = state.Qbuf
    if update_weights:
        # GNC weight update before the pose update (PGOAgent.cpp:654-668),
        # with the freeze decided on the device: from the third flagged
        # round on, once the converged-weight ratio of the PRE-update
        # weights reaches the reference's minimum over all agents, a
        # flagged round computes exactly a plain round.
        # A batch's members each keep their own mu and freeze test.
        edges_r = graph.edges._replace(weight=weights)
        w_new = _gnc_update_weights(X, Z, edges_r, _per_agent(mu, A, 2),
                                    params)
        ratio_pre = _converged_weight_ratio(edges_r, params)
        ordinal = (state.iteration + 1) // params.robust_opt_inner_iters
        if ratio_pre is None or ordinal < 3:
            frozen = torch.zeros((), dtype=torch.bool, device=X.device)
        elif mesh is not None:
            frozen = mesh.all_reduce(ratio_pre.amin(), "min") \
                >= params.robust_opt_min_convergence_ratio
        else:
            frozen = ratio_pre.reshape(B, A).amin(dim=1).reshape(mu.shape) \
                >= params.robust_opt_min_convergence_ratio
        weights = torch.where(_per_agent(frozen, A, 2), weights, w_new)
        mu = torch.where(frozen, mu, robust.gnc_update_mu(mu, params.robust))
        frozen_x = _per_agent(frozen, A, 4)
        if state.X_init is not None:
            # Warm start off: restart from the initial guess
            # (PGOAgent.cpp:657-662), which refreshes the exchange.
            X = torch.where(frozen_x, X, state.X_init)
            Z = exchange(X)
        if accel:  # initializeAcceleration (PGOAgent.cpp:1054-1063)
            V = torch.where(frozen_x, V, X)
            frozen_a = _per_agent(frozen, A)
            gamma = torch.where(frozen_a, gamma, torch.zeros_like(gamma))
            alpha = torch.where(frozen_a, alpha, torch.zeros_like(alpha))
    edges = graph.edges._replace(weight=weights)
    form = _formulation(meta, params, graph, X.dtype, X.device)
    if form == "dense" and qbuf is None:
        # An explicit opt-in that cannot run does not fall back.
        raise ValueError(
            "dense_quadratic=True but the state carries no Qbuf — build it "
            "with init_state(..., params=...) using the same params, or "
            "refresh_problem() after changing them")
    if update_weights or chol is None:
        # Reweighted Q: refactor the preconditioner (PGOAgent.cpp:1110-
        # 1112); a state built without params factors here too.
        chol = precond_chol(edges, graph, params)
    if update_weights and (form == "dense" or qbuf is not None):
        # ... and rebuild the dense Q (kept, refreshed, when carried while
        # this round's params resolve elsewhere).
        qbuf = dense_q_all(edges, meta, graph.dense_inc)

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
    q_use = qbuf if form == "dense" else None
    if schedule == Schedule.GREEDY:
        # One agent fires (the reference demo's argmax of the block
        # gradient norms, MultiRobotExample.cpp:242-256), selected by an
        # ELL pass in the iterate dtype — not the kernel's f32 gn0, so
        # near-ties resolve as in the JAX package — and only it is solved:
        # on CUDA float32, one launch on its slices (one agent per member
        # of a batch).
        # On a mesh, every rank solves its local slot of the global argmax
        # (one launch each) and only the owner's update is kept.
        gn = manifold.norm(manifold.rgrad(
            start, _local_egrad(start, Zuse, edges, graph)))
        if mesh is not None:
            gn = mesh.all_gather(gn)
        arg = torch.argmax(gn.reshape(B, A), dim=1)
        sel = arg % A_loc if mesh is not None else \
            arg + torch.arange(B, device=X.device) * A
        x1, z1, e1, c1, g1, q1 = _select_agents((start, Zuse, edges, chol,
                                                 graph, q_use), sel)
        upd, _ = _agent_update(x1, z1, e1, params, c1, g1, meta,
                               kernel=kernel, qbuf=q1)
        if mesh is not None:
            fired = torch.arange(offset, offset + A_loc,
                                 device=X.device) == arg
            X_upd = torch.where(fired[:, None, None, None], upd, start)
        else:
            fired = (torch.arange(A, device=X.device)
                     == arg[:, None]).reshape(-1)
            X_upd = torch.where(fired.reshape(B, A, 1, 1, 1), upd[:, None],
                                start.reshape((B, A) + start.shape[1:])
                                ).reshape(start.shape)
    else:
        X_upd, _ = _agent_update(start, Zuse, edges, params, chol, graph,
                                 meta, kernel=kernel, qbuf=q_use)
        if schedule == Schedule.JACOBI:
            fired = None
        elif schedule == Schedule.ASYNC:
            # Every member draws the same clocks, as identical keys do
            # under the JAX package's vmap.
            # A shard takes its slice of the global draw.
            fired = _async_fired(state.seed, state.iteration, A,
                                 params.async_update_prob, X.device
                                 ).repeat(B)[offset:offset + A_loc]
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
    new_state = state._replace(X=X_next, weights=weights,
                               iteration=state.iteration + 1,
                               rel_change=rel, ready=ready, chol=chol, V=V,
                               gamma=gamma, alpha=alpha, mu=mu, Qbuf=qbuf)
    if not return_halo:
        return new_state
    # The next round's halo, issued here so the collective runs while the
    # caller goes on; it feeds nothing in this round.
    return new_state, start_exchange(X_next)


#: A round (the JAX package's jitted ``rbcd_step``; PyTorch runs eagerly).
rbcd_step = _rbcd_round


def rbcd_steps(state: RBCDState, graph: MultiAgentGraph, num_rounds: int,
               meta: GraphMeta, params: AgentParams, mesh=None,
               plan: PPermutePlan | None = None, shifts: tuple = (),
               overlap: bool = False) -> RBCDState:
    """``num_rounds`` consecutive plain rounds (no weight update, no
    restart) — the JAX package's fused ``fori_loop``, here a Python loop
    over the same round that enqueues every launch without a host sync.

    ``overlap`` (mesh path, un-accelerated schedules; the JAX package's
    ``_rbcd_rounds(overlap=True)``) carries each round's halo: the
    exchange of ``X_k`` is issued at the end of round ``k - 1``, right
    after its Stiefel update, and waited for in round ``k``.  The values
    are the same round for round; the loop costs one extra exchange (its
    prologue).  Accelerated rounds exchange the momentum point, so they
    take the plain loop."""
    accel = params.acceleration and state.V is not None
    if overlap and mesh is not None and not accel and num_rounds > 0:
        halo = _exchange_for(graph, mesh, plan, shifts)(state.X)
        for _ in range(num_rounds):
            state, halo = _rbcd_round(state, graph, meta, params, mesh=mesh,
                                      plan=plan, shifts=shifts, halo=halo,
                                      return_halo=True)
        halo()  # the last issued exchange completes before its buffers go
        return state
    for _ in range(num_rounds):
        state = _rbcd_round(state, graph, meta, params, mesh=mesh,
                            plan=plan, shifts=shifts)
    return state


def rbcd_segment(state: RBCDState, graph: MultiAgentGraph, num_rounds: int,
                 meta: GraphMeta, params: AgentParams,
                 first_update_weights: bool = False,
                 first_restart: bool = False, mesh=None,
                 plan: PPermutePlan | None = None, shifts: tuple = (),
                 overlap: bool = False) -> RBCDState:
    """One schedule segment: a (possibly flagged) first round and
    ``num_rounds - 1`` plain rounds.  On CUDA in float32, where every local
    solve is one kernel launch, a segment has no host sync — what a later
    CUDA graph captures.  With both flags False this is ``rbcd_steps``.
    ``mesh``/``plan``/``shifts``/``overlap`` as in ``_rbcd_round`` and
    ``rbcd_steps``."""
    state = _rbcd_round(state, graph, meta, params,
                        update_weights=first_update_weights,
                        restart=first_restart, mesh=mesh, plan=plan,
                        shifts=shifts)
    return rbcd_steps(state, graph, num_rounds - 1, meta, params, mesh=mesh,
                      plan=plan, shifts=shifts, overlap=overlap)


# ---------------------------------------------------------------------------
# Initialization, rounding, and the outer loop
# ---------------------------------------------------------------------------

def init_state(graph: MultiAgentGraph, meta: GraphMeta, X0: torch.Tensor,
               params: AgentParams | None = None, seed: int = 0) -> RBCDState:
    """Fresh solver state at ``X0``: the preconditioner factors (and the
    dense Q when ``_formulation`` says "dense") are baked when the solver
    params are known; ``V = X0`` when accelerated
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
        seed=seed,
        Qbuf=dense_q_all(graph.edges, meta, graph.dense_inc)
        if _dense(meta, params, dtype)
        else None)


def refresh_problem(state: RBCDState, graph: MultiAgentGraph,
                    meta: GraphMeta, params: AgentParams) -> RBCDState:
    """Recompute the carried factors (the preconditioner, and the dense Q
    when that formulation runs under ``params`` or the state carries one)
    from ``state.weights`` — after setting weights from outside, e.g. when
    resuming a GNC solve, since a round refreshes them only on its
    weight-update rounds."""
    edges = graph.edges._replace(weight=state.weights)
    qbuf = dense_q_all(edges, meta, graph.dense_inc) \
        if _dense(meta, params, state.X.dtype) or state.Qbuf is not None \
        else None
    return state._replace(chol=precond_chol(edges, graph, params), Qbuf=qbuf)


def lifting_matrix(meta: GraphMeta, dtype=torch.float64,
                   device="cuda") -> torch.Tensor:
    """The shared lifting matrix YLift for this problem's (rank, d)."""
    return _lifting_matrix(meta.rank, meta.d, dtype, device)


def lifted_init(edges_g: EdgeSet, graph: MultiAgentGraph, meta: GraphMeta,
                n_total: int, init: str = "chordal") -> torch.Tensor:
    """Centralized lifted init on a global edge set, scattered to agents:
    ``"chordal"`` or ``"odometry"`` (``local_pgo.initial_poses``), on the
    edges' device and dtype."""
    T0 = initial_poses(edges_g, n_total, init)
    X0g = lift(T0, lifting_matrix(meta, T0.dtype, T0.device))
    return scatter_to_agents(X0g, graph)


def _global_edges(part: Partition, graph: MultiAgentGraph,
                  dtype) -> EdgeSet:
    return edge_set_from_measurements(part.meas_global, dtype=dtype,
                                      device=graph.global_index.device)


def centralized_chordal_init(part: Partition, meta: GraphMeta,
                             graph: MultiAgentGraph,
                             dtype=torch.float64) -> torch.Tensor:
    """Centralized chordal init, lifted and scattered to agents (the demo
    initialization of ``MultiRobotExample.cpp:158-165``), on the graph's
    device."""
    return lifted_init(_global_edges(part, graph, dtype), graph, meta,
                       part.meas_global.num_poses, "chordal")


def centralized_odometry_init(part: Partition, meta: GraphMeta,
                              graph: MultiAgentGraph,
                              dtype=torch.float64) -> torch.Tensor:
    """Odometry-chain init, lifted and scattered to agents (reference
    ``odometryInitialization``, ``DPGO_utils.cpp:426-447``): the outlier-
    safe start for robust runs, at the price of drift on long chains."""
    return lifted_init(_global_edges(part, graph, dtype), graph, meta,
                       part.meas_global.num_poses, "odometry")


def initial_state_for(init: str, part: Partition, meta: GraphMeta,
                      graph: MultiAgentGraph, params: AgentParams,
                      dtype) -> torch.Tensor:
    """Initial lifted state by policy: ``"chordal"`` (the centralized
    chordal init), ``"odometry"`` (the odometry chain) or ``"distributed"``
    (per-agent local inits and robust frame alignment, no centralized
    solve: ``models.dist_init``, ``PGOAgent.cpp:250-432``)."""
    if init == "chordal":
        return centralized_chordal_init(part, meta, graph, dtype)
    if init == "odometry":
        return centralized_odometry_init(part, meta, graph, dtype)
    if init == "distributed":
        from .dist_init import distributed_initialization
        return distributed_initialization(part, meta, graph, params, dtype)
    raise ValueError(f"unknown init policy {init!r}")


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
    # Terminal certification (certify.CertificateResult) when
    # params.certify_mode is "device" or "host", else None.
    certificate: object = None
    # Set by the serving plane when the solve completed from a session
    # snapshot after a worker died mid-batch (``serve.session``), and by
    # the sharded plane after a rewind (``parallel.resilience``).
    recovered: bool = False
    # The sharded plane's resilience summary (``CheckpointSupervisor
    # .finish``) when ``solve_rbcd_sharded(resilience=...)`` ran.
    resilience: dict | None = None


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


def rounds_enqueued(iterations: int, *, max_iters: int, eval_every: int,
                    params: AgentParams | None = None,
                    verdict_every: int | None = None) -> int:
    """The rounds a ``run_rbcd`` call from iteration 0 enqueued on the
    device, speculation included, given the ``iterations`` it reported:
    the per-eval loop adds the one discarded segment past an early
    terminal eval (``schedule_bounds`` at it); the verdict loop runs to
    the end of the K-round window holding the latched eval, plus its
    speculative window.  Launch accounting: every round launches the local
    step once."""
    if iterations >= max_iters:
        return iterations
    if verdict_every is not None:
        K = verdict_every
        it_pre = min(-(-iterations // K) * K, max_iters)
        return min(it_pre + K, max_iters) if it_pre < max_iters else it_pre
    robust_on = params is not None and \
        params.robust.cost_type != RobustCostType.L2
    accel_on = params is not None and params.acceleration
    it = nwu = 0
    while True:
        uw, _, end = schedule_bounds(it, nwu, max_iters=max_iters,
                                     eval_every=eval_every, params=params,
                                     robust_on=robust_on, accel_on=accel_on)
        if it == iterations:
            return end
        nwu += int(uw)
        it = end


# ---------------------------------------------------------------------------
# The device->host seam
# ---------------------------------------------------------------------------

class _Pending(NamedTuple):
    """A device->host copy in flight: the host tree (pinned tensors for
    CUDA leaves) and the event recorded after the copies."""

    host: object
    done: object  # torch.cuda.Event | None


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_tree_map(fn, t) for t in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return tree


def _start_fetch(tree) -> _Pending:
    """Enqueue the copy of every tensor of ``tree`` into pinned host memory
    and record an event after it — no host sync.  Work enqueued later (the
    speculative window) does not delay the event.  CPU tensors are read as
    they are."""
    on_cuda = []

    def copy(t):
        if t.device.type != "cuda":
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        on_cuda.append(t)
        return h

    host = _tree_map(copy, tree)
    done = None
    if on_cuda:
        done = torch.cuda.Event()
        done.record()
    return _Pending(host, done)


def _host_fetch(x):
    """THE device->host transfer seam of the driver loops: every readback
    of ``run_rbcd`` (the per-eval row, the verdict word, the terminal
    epilogue) is one call here, so tests and benchmarks count host syncs by
    patching it.  ``x`` is a tree of tensors or a ``_Pending`` copy from
    ``_start_fetch``; the call waits on that copy's event only, never on
    the stream, and returns the tree with host (CPU) tensors."""
    p = x if isinstance(x, _Pending) else _start_fetch(x)
    if p.done is not None:
        p.done.synchronize()
    return p.host


# ---------------------------------------------------------------------------
# Device-resident verdict loop
# ---------------------------------------------------------------------------
#
# The verdict word is one packed int32 the host reads back every K rounds in
# place of the full per-eval scalar stack:
#
#   bits 0-2   status        0 RUNNING | 1 GRAD_NORM | 2 CONSENSUS
#   bits 3-5   anomaly class 0 none | 1 cost_spike | 2 stall
#                            | 3 grad_explosion | 4 non_finite
#                            (highest-severity class seen so far, latched)
#   bits 6+    GNC stage index (robust.gnc_stage_index, 0 when not robust)
#
# Termination latches on the device at the first eval whose gradient norm
# clears the tolerance (or whose agents reach consensus); the host learns
# of it at the next K-round fetch, so the returned iterate may carry up to
# K - eval_every extra polish rounds past the terminal eval.  Histories and
# ``iterations`` are truncated at the latched eval, so the reported
# trajectory is the per-eval loop's.

VERDICT_RUNNING = 0
VERDICT_GRAD_NORM = 1
VERDICT_CONSENSUS = 2
_VERDICT_STATUS = {VERDICT_RUNNING: "running",
                   VERDICT_GRAD_NORM: "grad_norm",
                   VERDICT_CONSENSUS: "consensus"}

ANOMALY_NONE = 0
ANOMALY_COST_SPIKE = 1
ANOMALY_STALL = 2
ANOMALY_GRAD_EXPLOSION = 3
ANOMALY_NON_FINITE = 4
_VERDICT_ANOMALY = {ANOMALY_NONE: None, ANOMALY_COST_SPIKE: "cost_spike",
                    ANOMALY_STALL: "stall",
                    ANOMALY_GRAD_EXPLOSION: "grad_explosion",
                    ANOMALY_NON_FINITE: "non_finite"}


def pack_verdict(status: int, anomaly: int = 0, stage: int = 0) -> int:
    """Host-side packer (tests / documentation of the word layout)."""
    return int(status) | (int(anomaly) << 3) | (int(stage) << 6)


def unpack_verdict(word: int) -> dict:
    """Decode a fetched verdict word into named fields."""
    word = int(word)
    return {"status": _VERDICT_STATUS.get(word & 7, "?"),
            "anomaly": _VERDICT_ANOMALY.get((word >> 3) & 7),
            "stage": word >> 6}


class VerdictState(NamedTuple):
    """Device-resident control and health state carried across evals (0-dim
    tensors on the solve's device).  ``hist`` holds the exact per-eval
    metric rows of ``_central_metrics_body``."""

    word: torch.Tensor        # int32 packed verdict
    eval_idx: torch.Tensor    # int32 number of eval rows recorded
    term_eval: torch.Tensor   # int32 eval index of the terminal eval (-1)
    term_it: torch.Tensor     # int32 iteration of the terminal eval (-1)
    best_cost: torch.Tensor   # stage-best cost (cost_spike baseline)
    min_gn: torch.Tensor      # stage-min gradient norm (explosion baseline)
    stage: torch.Tensor       # int32 GNC stage index
    stall_anchor: torch.Tensor  # cost at the stall window anchor
    stall_len: torch.Tensor     # int32 evals since the anchor
    stall_fired: torch.Tensor   # bool, once per stage
    hist: torch.Tensor        # [max_evals, W] per-eval metric rows


def init_verdict_state(max_evals: int, num_robots: int, dtype,
                       telemetry: bool, device="cuda") -> VerdictState:
    """Fresh verdict state sized for ``max_evals`` eval boundaries.  Row
    width matches ``_central_metrics_body``: 3 scalars, +3 GNC scalars and
    the per-agent relative change with telemetry on."""
    dev = resolve_device(device)
    W = (6 + num_robots) if telemetry else 3

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    def inf():
        return torch.full((), math.inf, dtype=dtype, device=dev)

    return VerdictState(
        word=i32(0), eval_idx=i32(0), term_eval=i32(-1), term_it=i32(-1),
        best_cost=inf(), min_gn=inf(), stage=i32(0), stall_anchor=inf(),
        stall_len=i32(0),
        stall_fired=torch.zeros((), dtype=torch.bool, device=dev),
        hist=torch.zeros((max_evals, W), dtype=dtype, device=dev))


def fold_verdict(word, term_eval, term_it, eval_idx, iteration: int, gn,
                 consensus, anomaly, stage, grad_norm_tol: float):
    """Fold one eval into packed verdict words and latch the first terminal
    eval, elementwise (0-dim for a solve, ``[B]`` for a served batch):
    the convergence test (``gn`` against ``grad_norm_tol``, then
    ``consensus``) gives the status until a terminal eval is latched, the
    anomaly code is the largest seen, ``stage`` rides the high bits.
    ``eval_idx`` is a tensor; ``iteration`` is the host's round index.
    Returns ``(word, term_eval, term_it)``."""
    status_now = torch.where(
        gn < grad_norm_tol, VERDICT_GRAD_NORM,
        torch.where(consensus > 0, VERDICT_CONSENSUS,
                    VERDICT_RUNNING)).to(torch.int32)
    status = torch.where(term_eval >= 0, word & 7, status_now)
    first_term = (term_eval < 0) & (status != VERDICT_RUNNING)
    term_eval = torch.where(first_term, eval_idx, term_eval)
    term_it = torch.where(first_term, term_it.new_full((), int(iteration)),
                          term_it)
    anom = torch.maximum((word >> 3) & 7, anomaly)
    word = (status | (anom << 3) | (stage << 6)).to(torch.int32)
    return word, term_eval, term_it


def _device_gnc_stage(mu: torch.Tensor, mu0: float, step: float,
                      kmax: int) -> torch.Tensor:
    """Device twin of ``robust.gnc_stage_index`` (same clamp semantics):
    round half to even, as ``jnp.round``; the log ratio is divided in
    float64, as the JAX package divides by a float64 numpy scalar."""
    if mu0 <= 0 or step <= 1.0:
        return torch.zeros((), dtype=torch.int32, device=mu.device)
    lr = torch.log(torch.clamp(mu, min=mu0) / mu0).to(torch.float64)
    k = torch.round(lr / math.log(step))
    return torch.clamp(k.to(torch.int32), 0, kmax)


def _central_metrics_body(graph: MultiAgentGraph, edges_g: EdgeSet,
                          n_total: int, num_meas: int, telemetry: bool):
    """The per-eval metric row, shared by the per-eval loop and the verdict
    program so both write the same rows bit for bit: the centralized cost,
    the Riemannian gradient norm (its Euclidean gradient summed over the
    ELL incidence of the global edges, an order fixed by the indices) and
    consensus; with ``telemetry``, + GNC mu, the inlier fraction, the mean
    weight of the updatable loop closures and the per-agent relative
    change.  The incidence is built here, once per solve."""
    inc_g = quadratic.edge_incidence(edges_g, n_total)

    def central_metrics(Xa, weights, ready, mu, rel_change):
        Xg = gather_to_global(Xa, graph, n_total)
        eg = edges_g._replace(weight=global_weights(weights, graph,
                                                    num_meas))
        f = quadratic.cost(Xg, eg)
        g = manifold.rgrad(Xg, quadratic.egrad_ell(Xg, eg, *inc_g))
        vals = [f, manifold.norm(g), torch.all(ready).to(f.dtype)]
        if telemetry:
            e = graph.edges
            upd = e.mask * e.is_lc * (1.0 - e.fixed_weight)
            n_upd = torch.clamp(torch.sum(upd), min=1.0)
            vals += [mu.to(f.dtype), torch.sum((weights > 0.5) * upd) / n_upd,
                     torch.sum(weights * upd) / n_upd]
            return torch.cat([torch.stack(vals), rel_change.to(f.dtype)])
        return torch.stack(vals)

    return central_metrics


def make_verdict_program(graph: MultiAgentGraph, edges_g: EdgeSet,
                         n_total: int, num_meas: int, telemetry: bool, *,
                         grad_norm_tol: float, robust_params=None,
                         health_cfg: HealthConfig | None = None,
                         metrics_body=None):
    """The per-eval program of the device-resident loop: evaluates the
    metric row (``_central_metrics_body``, or ``metrics_body``, which must
    match its signature and width), appends it to the device-side history,
    folds the convergence test and the health predicates (``health_cfg``,
    default ``obs.health.HealthConfig()``; the telemetry-on driver passes
    its monitor's) into the packed word, and latches the
    first terminal eval — the JAX package's ``make_verdict_program``, as
    plain tensor ops with no host sync (``iteration`` is the host's round
    index, written with a fill).  The stall window is block-aligned (the
    anchor cost refreshed every ``stall_window`` evals), as there.  The
    history's length is ``init_verdict_state``'s."""
    health_cfg = health_cfg if health_cfg is not None else HealthConfig()
    body = metrics_body if metrics_body is not None else \
        _central_metrics_body(graph, edges_g, n_total, num_meas, telemetry)
    spike_rtol = float(health_cfg.cost_spike_rtol)
    spike_atol = float(health_cfg.cost_spike_atol)
    expl_factor = float(health_cfg.grad_explosion_factor)
    gn_floor = float(health_cfg.grad_floor)
    stall_window = int(health_cfg.stall_window)
    stall_rtol = float(health_cfg.stall_rtol)

    def code(flag, anomaly):
        return flag.to(torch.int32) * anomaly

    def verdict_step(Xa, weights, ready, mu, rel_change, iteration: int,
                     vs: VerdictState) -> VerdictState:
        vec = body(Xa, weights, ready, mu, rel_change)
        f, gn, consensus = vec[0], vec[1], vec[2]
        if robust_params is not None:
            stage = _device_gnc_stage(mu, float(robust_params.gnc_init_mu),
                                      float(robust_params.gnc_mu_step),
                                      int(robust_params.gnc_max_iters))
        else:
            stage = torch.zeros_like(vs.stage)

        # Per-stage baselines reset on stage transitions; the stall anchor
        # also seeds itself on the first finite cost.
        fresh = stage != vs.stage
        inf = vec.new_full((), math.inf)
        best = torch.where(fresh, inf, vs.best_cost)
        ming = torch.where(fresh, inf, vs.min_gn)
        seed = fresh | ~torch.isfinite(vs.stall_anchor)
        anchor = torch.where(seed, f, vs.stall_anchor)
        slen = torch.where(seed, 0, vs.stall_len)
        sfired = vs.stall_fired & ~fresh

        finite = torch.isfinite(f) & torch.isfinite(gn) \
            & torch.all(torch.isfinite(rel_change))
        # Judged against the pre-update baselines, on finite evals only.
        spike = finite & torch.isfinite(best) \
            & (f > best * (1.0 + spike_rtol) + spike_atol)
        expl = finite & torch.isfinite(ming) \
            & (gn > expl_factor * torch.clamp(ming, min=gn_floor))
        if stall_window > 1:
            slen = slen + 1
            full = slen >= stall_window
            stalled = finite & full & ~sfired \
                & (anchor - f <= stall_rtol * torch.abs(anchor))
            sfired = sfired | stalled
            anchor = torch.where(full, f, anchor)
            slen = torch.where(full, 0, slen)
        else:
            stalled = torch.zeros_like(finite)

        anom = torch.maximum(
            torch.maximum(code(spike, ANOMALY_COST_SPIKE),
                          code(stalled, ANOMALY_STALL)),
            torch.maximum(code(expl, ANOMALY_GRAD_EXPLOSION),
                          code(~finite, ANOMALY_NON_FINITE)))
        word, term_eval, term_it = fold_verdict(
            vs.word, vs.term_eval, vs.term_it, vs.eval_idx, iteration, gn,
            consensus, anom, stage, grad_norm_tol)

        best = torch.where(finite, torch.minimum(best, f), best)
        ming = torch.where(finite, torch.minimum(ming, gn), ming)
        # A device index: no host read of eval_idx.
        hist = vs.hist.index_copy(0, vs.eval_idx.reshape(1).long(),
                                  vec[None, :].to(vs.hist.dtype))
        return VerdictState(word=word, eval_idx=vs.eval_idx + 1,
                            term_eval=term_eval, term_it=term_it,
                            best_cost=best, min_gn=ming, stage=stage,
                            stall_anchor=anchor, stall_len=slen,
                            stall_fired=sfired, hist=hist)

    return verdict_step


def make_terminal_epilogue(graph: MultiAgentGraph, edges_g: EdgeSet,
                           n_total: int, num_meas: int, meta: GraphMeta, *,
                           certify_mode: str = "off",
                           certify_seed: int = 0, assemble=None):
    """The terminal program of a solve: gather, rounding and anchoring
    (``round_global``), the weight collapse, and — with
    ``certify_mode="device"`` — the gauge-deflated device certificate
    eigensolve (``certify.device_certificate_payload``) on the gathered
    global iterate with the collapsed weights, all as tensor ops with no
    host sync.  ``epilogue(Xa, weights, extras)`` returns ``{"T",
    "w_glob", **extras}``, plus ``Xg`` (the certificate operand, and the
    host f64 REFUSE fallback's input) for ``"device"``/``"host"`` and
    ``cert`` (the payload) for ``"device"``; the verdict loop rides its
    history and latched indices in ``extras``, so the driver's whole
    epilogue is one ``_host_fetch``.  The host decision on the fetched
    dict is ``_epilogue_certificate``.  The lifting matrix and the global
    edges' incidence are built here, once, so the program itself copies
    nothing to the device.  ``assemble(Xa, weights) -> (Xg, w_glob)``
    replaces the gather and the weight collapse (the sharded plane's,
    whose ranks each hold a shard of the agents)."""
    if certify_mode not in ("off", "device", "host"):
        raise ValueError(f"unknown certify_mode {certify_mode!r}")
    device_cert = certify_mode == "device"
    want_xg = certify_mode in ("device", "host")
    ylift = lifting_matrix(meta, edges_g.R.dtype, edges_g.R.device)
    if device_cert:
        from . import certify as certify_mod

        inc_g = quadratic.edge_incidence(edges_g, n_total)

    def epilogue(Xa, weights, extras: dict) -> dict:
        if assemble is not None:
            Xg, w_glob = assemble(Xa, weights)
        else:
            Xg = gather_to_global(Xa, graph, n_total)
            w_glob = global_weights(weights, graph, num_meas)
        out = {"T": round_global(Xg, ylift.to(Xg.dtype)), "w_glob": w_glob,
               **extras}
        if want_xg:
            out["Xg"] = Xg
        if device_cert:
            out["cert"] = certify_mod.device_certificate_payload(
                Xg, edges_g._replace(weight=w_glob), certify_seed,
                inc=inc_g)
        return out

    return epilogue


def _epilogue_certificate(fin: dict, edges_g: EdgeSet, params, dtype):
    """Host decision on a fetched epilogue dict: the ``CertificateResult``
    of ``RBCDResult.certificate``.  ``certify_mode="device"``: decide the
    fetched payload (``certify.decide_device_certificate``); the host f64
    path runs only on a REFUSE, fed from the fetched ``Xg``/``w_glob``.
    ``"host"``: the post-hoc ``certify_solution`` on the solve's device,
    kept for parity runs."""
    from . import certify as certify_mod

    certify_mode = getattr(params, "certify_mode", "off")
    eta = float(getattr(params, "certify_eta", 1e-5))
    if certify_mode == "host":
        dev = edges_g.weight.device
        eg = edges_g._replace(weight=fin["w_glob"].to(dev))
        return certify_mod.certify_solution(fin["Xg"].to(dev), eg, eta=eta)
    pay = fin["cert"]
    tol = eta * float(pay["wscale"])
    # Read by the host f64 fallback only (a REFUSE): the fetched weights.
    eg = edges_g._replace(weight=fin["w_glob"])
    f64_solve = certify_mod.host_f64_solve(fin["Xg"], eg, tol,
                                           warm=pay["direction"])
    return certify_mod.decide_device_certificate(
        pay, eta, float(torch.finfo(dtype).eps), f64_solve=f64_solve)


def _package_version() -> str:
    """The port's version for run fingerprints (lazy import — the package
    ``__init__`` is not a dependency of this module at import time)."""
    from .. import __version__

    return str(__version__)


def _sel_mode(params: AgentParams) -> str:
    """The JAX package's ``resolved_sel_mode`` of ``params`` (a
    fingerprint field: ``pallas_sel_mode`` when set, else derived from
    ``pallas_bf16_select``); the port's kernel has no selection matmuls,
    so it records the configuration only."""
    m = params.solver.pallas_sel_mode
    if m:
        if m not in ("f32", "bf16", "bf16x3"):
            raise ValueError(f"unknown pallas_sel_mode {m!r}")
        return m
    return "bf16" if params.solver.pallas_bf16_select else "f32"


@contextlib.contextmanager
def _crash_dump_scope(flight_rec):
    """Dump the attached flight recorder's black box when the driver loop
    dies — a crash is exactly the moment the ring buffer pays for itself.
    ``FlightRecorder.dump`` is first-write-wins, so an anomaly dump that
    already fired (e.g. the abort policy raising SolverHealthError) is
    not overwritten by the crash handler."""
    try:
        yield
    except Exception:
        if flight_rec is not None:
            flight_rec.dump("crash")
        raise


def _emit_sync_rate(obs_run, fetches: int, rounds: int) -> None:
    """Record the measured in-loop host-sync rate
    (``host_syncs_per_100_rounds``; lower is better, gated by
    ``obs.regress``).  Counts only the driver-loop fetches through the
    ``_host_fetch`` seam — the per-eval loop's terminal epilogue read is
    excluded, as it is paid once per solve regardless of loop design."""
    rate = 100.0 * fetches / max(rounds, 1)
    obs_run.gauge("host_syncs_per_100_rounds",
                  "driver-loop device->host fetches per 100 RBCD rounds"
                  ).set(rate)
    obs_run.metric("host_syncs_per_100_rounds", rate, phase="solve",
                   fetches=fetches, rounds=rounds)


def run_rbcd(state: RBCDState, graph: MultiAgentGraph, meta: GraphMeta,
             segment, part: Partition, max_iters: int,
             grad_norm_tol: float = 0.1, eval_every: int = 1,
             dtype=torch.float64, params: AgentParams | None = None,
             verdict_every: int | None = None, metrics_body_factory=None,
             start_iteration: int = 0, start_num_weight_updates: int = 0,
             boundary_cb=None, assemble=None) -> RBCDResult:
    """The driver loop (``MultiRobotExample.cpp:175-264``): rounds run in
    schedule segments — ``segment(state, k, update_weights, restart)`` runs
    ``k`` rounds, the first one flagged (weight update or restart, from
    ``schedule_bounds``), up to the next flag or eval boundary.  The solve
    stops at ``grad_norm_tol`` or when every agent is ready (consensus).

    Per-eval loop (``verdict_every=None``): at every eval boundary the
    metric row is enqueued with its copy to the host, one speculative
    segment past the boundary is enqueued, and only then is the row read
    (``_host_fetch``, one per eval) — the device works through the
    speculation while the host waits.  A termination discards the
    speculative state.

    ``verdict_every`` (K, a positive multiple of ``eval_every``) runs the
    device-resident verdict loop (``_run_verdict_loop``): one packed word
    read per K rounds and one terminal epilogue fetch.

    Telemetry (``obs``) is resolved once per solve from ``obs.get_run()``.
    Off, neither loop touches the registry, emits an event or adds a
    transfer.  On, the per-eval row carries the telemetry scalars (GNC mu,
    the inlier fraction, the mean weight, the per-agent relative change)
    in the same fetch, feeding gauges, ``metric`` events, the health
    monitor and an attached flight recorder (``_emit_eval``); the verdict
    loop adds one counted fetch of the history rows per non-terminal
    boundary, so both loops emit the same event stream.

    ``metrics_body_factory(telemetry)`` replaces the metric row's body in
    both loops.  ``start_iteration`` / ``start_num_weight_updates`` resume
    the verdict loop at an absolute round index, and ``boundary_cb(it, nwu,
    state, word, terminal)`` fires at every verdict boundary with the
    pre-speculation state; all three need the verdict loop.
    ``assemble`` goes to ``make_terminal_epilogue``."""
    if verdict_every is None and (start_iteration or start_num_weight_updates
                                  or boundary_cb is not None):
        raise ValueError(
            "start_iteration / start_num_weight_updates / boundary_cb "
            "are resilience hooks of the verdict loop; pass "
            "verdict_every=K to use them")
    dev = state.X.device
    n_total = part.meas_global.num_poses
    num_meas = len(part.meas_global)
    edges_g = edge_set_from_measurements(part.meas_global, dtype=dtype,
                                         device=dev)
    obs_run = obs.get_run()
    telemetry = obs_run is not None
    central_metrics = metrics_body_factory(telemetry) \
        if metrics_body_factory is not None else \
        _central_metrics_body(graph, edges_g, n_total, num_meas, telemetry)
    robust_on = params is not None and \
        params.robust.cost_type != RobustCostType.L2
    accel_on = params is not None and params.acceleration

    def bounds(n_done, nwu):
        return schedule_bounds(n_done, nwu, max_iters=max_iters,
                               eval_every=eval_every, params=params,
                               robust_on=robust_on, accel_on=accel_on)

    health_mon = flight_rec = emit_eval = None
    if telemetry:
        from ..obs import health as health_mod

        # The health monitor judges the scalars the row already carries;
        # an attached flight recorder registers the problem so its black
        # box is self-contained and replayable.
        health_mon = health_mod.monitor_for(obs_run)
        flight_rec = getattr(obs_run, "recorder", None)
        if flight_rec is not None:
            flight_rec.set_problem(part, meta, params, dtype,
                                   eval_every=eval_every,
                                   grad_norm_tol=grad_norm_tol,
                                   max_iters=max_iters)
        obs_run.set_fingerprint(
            version=_package_version(),
            solver="run_rbcd",
            num_robots=meta.num_robots, rank=meta.rank, d=meta.d,
            n_poses=n_total, n_meas=num_meas,
            dtype=recorder.dtype_name(dtype),
            schedule=params.schedule.value if params is not None else None,
            robust_cost=params.robust.cost_type.value
            if params is not None else None,
            sel_mode=_sel_mode(params) if params is not None else None,
            eval_every=eval_every)
        obs_run.event("solve_start", phase="solve",
                      num_robots=meta.num_robots, max_iters=max_iters,
                      eval_every=eval_every, grad_norm_tol=grad_norm_tol,
                      robust=robust_on, acceleration=accel_on)
        emit_eval = _make_emit_eval(obs_run, params, robust_on, health_mon,
                                    flight_rec)

    certify_mode = getattr(params, "certify_mode", "off") \
        if params is not None else "off"
    epilogue = make_terminal_epilogue(graph, edges_g, n_total, num_meas,
                                      meta, certify_mode=certify_mode,
                                      assemble=assemble)
    if verdict_every is not None:
        return _run_verdict_loop(
            state, graph, meta, segment, max_iters=max_iters,
            grad_norm_tol=grad_norm_tol, eval_every=eval_every,
            verdict_every=verdict_every, dtype=dtype, params=params,
            edges_g=edges_g, n_total=n_total, num_meas=num_meas,
            bounds=bounds, robust_on=robust_on, epilogue=epilogue,
            metrics_body=central_metrics, start_iteration=start_iteration,
            start_nwu=start_num_weight_updates, boundary_cb=boundary_cb,
            certify_mode=certify_mode, obs_run=obs_run,
            health_mon=health_mon, flight_rec=flight_rec,
            emit_eval=emit_eval)

    cost_hist, gn_hist = [], []
    terminated_by = "max_iters"
    it = 0
    nwu = 0
    host_fetches = 0  # the loop's reads through the ``_host_fetch`` seam
    with _crash_dump_scope(flight_rec):
        spec = None  # (state, it, uw) one segment past the last eval boundary
        t_solve0 = t_window = time.perf_counter()
        it_window = 0
        while it < max_iters:
            target = min(((it // eval_every) + 1) * eval_every, max_iters)
            if spec is not None:
                state, it, uw = spec
                nwu += int(uw)
                spec = None
            while it < target:
                uw, rs, end = bounds(it, nwu)
                nwu += int(uw)
                state = segment(state, end - it, uw, rs)
                it = end
            row = _start_fetch(central_metrics(state.X, state.weights,
                                               state.ready, state.mu,
                                               state.rel_change))
            if it < max_iters:
                # Depth-1 speculation: flags are host functions of the
                # round index, so the next segment is known before the row
                # is read.
                uw, rs, end = bounds(it, nwu)
                spec = (segment(state, end - it, uw, rs), end, uw)
            if telemetry:
                t_rb_m, t_rb_w = time.monotonic(), time.time()
            vec = _host_fetch(row)
            host_fetches += 1
            if telemetry:
                # The eval readback span: how much of the fetch stayed
                # hidden behind the speculative segment.
                trace.emit_span(obs_run, "eval_readback", t_rb_m, t_rb_w,
                                time.monotonic() - t_rb_m, phase="eval",
                                iteration=it)
            f, gn, consensus = vec[:3].tolist()
            cost_hist.append(f)
            gn_hist.append(gn)
            if telemetry:
                # Host-side bookkeeping on the fetched row only.
                now = time.perf_counter()
                dt, t_window = now - t_window, now
                rounds = max(it - it_window, 1)
                it_window = it
                emit_eval(it, vec.numpy(), rounds, dt / rounds, state=state,
                          nwu=nwu)
            if gn < grad_norm_tol:
                terminated_by = "grad_norm"
                break
            if consensus > 0:
                terminated_by = "consensus"
                break

    fin = epilogue(state.X, state.weights, {})
    certificate = None
    if certify_mode != "off":
        # The one terminal read: the trajectory, the weights, Xg and the
        # certificate payload in one fetch (the REFUSE fallback's inputs
        # included); with certification off the results stay on the
        # device.
        fin = _host_fetch(fin)
        certificate = _epilogue_certificate(fin, edges_g, params, dtype)
    if telemetry:
        _emit_sync_rate(obs_run, host_fetches, it)
        obs_run.event(
            "solve_end", phase="solve", iterations=it,
            terminated_by=terminated_by,
            duration_s=time.perf_counter() - t_solve0,
            cost=cost_hist[-1] if cost_hist else None,
            grad_norm=gn_hist[-1] if gn_hist else None,
            num_weight_updates=nwu)
    return RBCDResult(T=fin["T"], X=state.X, cost_history=cost_hist,
                      grad_norm_history=gn_hist, iterations=it,
                      terminated_by=terminated_by, weights=fin["w_glob"],
                      state=state, certificate=certificate)


def _make_emit_eval(obs_run, params, robust_on: bool, health_mon,
                    flight_rec):
    """One eval's telemetry — gauges, metric events, the flight-recorder
    ring, the health verdict — shared verbatim by the per-eval loop and
    the verdict loop (which feeds it fetched history rows), so both emit
    the same event stream.  ``vec`` is a host-side (numpy) telemetry-width
    metric row; ``state`` is passed only when an exact snapshot is at hand
    (the per-eval loop)."""
    g_cost = obs_run.gauge("solver_cost", "centralized SE(d) cost")
    g_gn = obs_run.gauge("solver_grad_norm",
                         "centralized Riemannian gradient norm")
    c_rounds = obs_run.counter("solver_rounds", "RBCD rounds executed")
    c_evals = obs_run.counter("solver_evals",
                              "centralized metric evaluations")
    h_round = obs_run.histogram(
        "round_latency_seconds",
        "wall-clock per RBCD round at phase boundaries", unit="s")
    g_agent_lat = obs_run.gauge(
        "agent_round_latency_seconds",
        "per-agent round latency (lockstep rounds: the eval-window "
        "wall-clock over rounds, identical across agents)", unit="s")
    g_agent_rel = obs_run.gauge("agent_rel_change",
                                "per-agent iterate relative change")
    if robust_on:
        g_mu = obs_run.gauge("gnc_mu", "GNC control parameter")
        g_inl = obs_run.gauge("gnc_inlier_fraction",
                              "fraction of updatable LC edges at w>0.5")

    def emit_eval(it_ev, vec, rounds, per_round, state=None, nwu=0):
        f, gn = float(vec[0]), float(vec[1])
        mu_v, inl, mean_w = (float(x) for x in vec[3:6])
        rel = vec[6:]
        g_cost.set(f)
        g_gn.set(gn)
        c_rounds.inc(rounds)
        c_evals.inc()
        h_round.observe(per_round)
        for a in range(rel.shape[0]):
            g_agent_lat.set(per_round, agent=a)
            g_agent_rel.set(float(rel[a]), agent=a)
        ev = {"iteration": it_ev, "round_latency_s": per_round,
              "rel_change_max": float(rel.max()) if rel.size else None}
        obs_run.metric("solver_cost", f, phase="eval", **ev)
        obs_run.metric("solver_grad_norm", gn, phase="eval", **ev)
        if robust_on:
            g_mu.set(mu_v)
            g_inl.set(inl)
            obs_run.metric("gnc_mu", mu_v, phase="eval", iteration=it_ev)
            obs_run.metric("gnc_inlier_fraction", inl, phase="eval",
                           iteration=it_ev, mean_weight=mean_w)
        # Flight recorder first (so an anomaly dump includes this eval),
        # then the health verdict — which may dump and, per the abort
        # policy, raise SolverHealthError.
        if flight_rec is not None:
            flight_rec.record_eval(
                it_ev, {"cost": f, "grad_norm": gn,
                        "mu": mu_v, "inlier_frac": inl,
                        "rel_change": rel},
                state=state, num_weight_updates=nwu)
        if health_mon is not None:
            health_mon.observe_solver(
                it_ev, f, gn,
                mu=mu_v if robust_on else None,
                inlier_frac=inl if robust_on else None,
                rel_change=rel,
                stage=robust.gnc_stage_index(mu_v, params.robust)
                if robust_on else None)

    return emit_eval


def _run_verdict_loop(state, graph, meta, segment, *, max_iters,
                      grad_norm_tol, eval_every, verdict_every, dtype,
                      params, edges_g, n_total, num_meas, bounds, robust_on,
                      epilogue, metrics_body=None, start_iteration=0,
                      start_nwu=0, boundary_cb=None, certify_mode="off",
                      obs_run=None, health_mon=None, flight_rec=None,
                      emit_eval=None):
    """Body of ``run_rbcd``'s device-resident mode.

    Per verdict boundary (every K rounds): the segments and the verdict
    evals up to the boundary are enqueued (``advance``, no host sync); the
    boundary's word starts its copy to pinned host memory (with telemetry
    on, the history rows' copy with it); the next boundary's window is
    enqueued (depth-1 speculation); then the host waits on the word's copy
    only (``_host_fetch``), so the speculative window runs meanwhile.
    With telemetry on, each non-terminal boundary reads its history rows
    (one more counted ``_host_fetch``) and replays them through
    ``emit_eval``; the verdict program and the epilogue run under
    ``devprof.profiled_program``.  At the terminal boundary one fused
    fetch brings back the rounded trajectory, the weights, the history
    rows and the latched indices; the histories and ``iterations`` are
    truncated at the latched eval.

    Resumption (``start_iteration``/``start_nwu``) re-enters at an
    absolute round index with a fresh verdict state: every schedule
    quantity is a function of that index."""
    if verdict_every <= 0 or verdict_every % eval_every != 0:
        raise ValueError(
            f"verdict_every={verdict_every} must be a positive multiple "
            f"of eval_every={eval_every}")
    telemetry = obs_run is not None
    dev = state.X.device
    max_evals = -(-max_iters // eval_every)
    verdict_step = make_verdict_program(
        graph, edges_g, n_total, num_meas, telemetry,
        grad_norm_tol=grad_norm_tol,
        robust_params=params.robust if robust_on else None,
        health_cfg=health_mon.config if health_mon is not None else None,
        metrics_body=metrics_body)
    vs = init_verdict_state(max_evals, meta.num_robots, dtype, telemetry,
                            device=dev)
    profiled = []
    if telemetry:
        # First-call accounting of the two programs (wall, kernel
        # launches, CUDA-event device time), published once their device
        # work has finished — no host sync of its own.
        from ..obs import devprof

        verdict_step = devprof.profiled_program(
            obs_run, verdict_step, key=f"verdict/k{verdict_every}",
            label="verdict_step", plane="solve")
        epilogue = devprof.profiled_program(
            obs_run, epilogue, key="epilogue/terminal",
            label="terminal_epilogue", plane="solve")
        profiled = [verdict_step, epilogue]
    eval_its: list[int] = []
    fetches = 0

    def advance(st, it, nwu, vs, target):
        """Enqueue segments and verdict evals up to ``target``."""
        while it < target:
            ev_t = min(((it // eval_every) + 1) * eval_every, target)
            while it < ev_t:
                uw, rs, end = bounds(it, nwu)
                nwu += int(uw)
                st = segment(st, end - it, uw, rs)
                it = end
            vs = verdict_step(st.X, st.weights, st.ready, st.mu,
                              st.rel_change, st.iteration, vs)
            eval_its.append(it)
        return st, it, nwu, vs

    def bound(i):
        return min(((i // verdict_every) + 1) * verdict_every, max_iters)

    t_solve0 = t_window = time.perf_counter()
    it_window = int(start_iteration)
    fed = 0
    hist_rows = None
    n_keep = 0
    with _crash_dump_scope(flight_rec):
        it, nwu = int(start_iteration), int(start_nwu)
        state, it, nwu, vs = advance(state, it, nwu, vs, bound(it))
        n_pre = len(eval_its)
        while True:
            state_pre, it_pre, nwu_pre, vs_pre = state, it, nwu, vs
            word_copy = _start_fetch(vs_pre.word)
            hist_copy = _start_fetch(vs_pre.hist) if telemetry else None
            if it < max_iters:
                state, it, nwu, vs = advance(state, it, nwu, vs, bound(it))
            word = int(_host_fetch(word_copy))
            fetches += 1
            status = word & 7
            terminal = status != VERDICT_RUNNING or it_pre >= max_iters
            if boundary_cb is not None:
                boundary_cb(it_pre, nwu_pre, state_pre, word, terminal)
            if telemetry and not terminal:
                # The lazy history fetch: the per-eval rows the telemetry
                # consumers see, counted like the word; at termination the
                # rows ride the fused epilogue fetch instead.
                hist_rows = _host_fetch(hist_copy).numpy()
                fetches += 1
            if terminal:
                fin = _host_fetch(epilogue(
                    state_pre.X, state_pre.weights,
                    {"hist": vs_pre.hist,
                     "tail": torch.stack([vs_pre.term_eval,
                                          vs_pre.term_it])}))
                hist_rows = fin["hist"].numpy()
                fetches += int(telemetry)
                term_eval, term_it = (int(v) for v in fin["tail"])
                if term_eval >= 0:
                    n_keep, it_final = term_eval + 1, term_it
                    terminated_by = _VERDICT_STATUS.get(status, "max_iters")
                else:
                    n_keep, it_final = n_pre, it_pre
                    terminated_by = "max_iters"
            feed_to = min(n_pre, n_keep) if terminal else n_pre
            if telemetry and feed_to > fed:
                now = time.perf_counter()
                dt, t_window = now - t_window, now
                rounds_w = max(it_pre - it_window, 1)
                it_window = it_pre
                per_round = dt / rounds_w
                for r in range(fed, feed_to):
                    rounds_r = eval_its[r] - (eval_its[r - 1] if r
                                              else int(start_iteration))
                    emit_eval(eval_its[r], hist_rows[r], max(rounds_r, 1),
                              per_round)
                fed = feed_to
                if flight_rec is not None and not terminal:
                    # Exact-state snapshot at the verdict boundary (the
                    # K-cadence analog of record_eval's snapshot path).
                    rows_finite = np.isfinite(hist_rows[:feed_to]).all()
                    flight_rec.snapshot_state(
                        it_pre, state_pre, nwu_pre,
                        healthy=bool(rows_finite))
            if terminal:
                state = state_pre
                break
            n_pre = len(eval_its)

    hist = fin["hist"]
    # The certificate payload crossed in the terminal fetch above; what
    # remains is host math (the decision ladder), which reads the device
    # again only on a REFUSE.
    certificate = _epilogue_certificate(fin, edges_g, params, dtype) \
        if certify_mode != "off" else None
    cost_hist = [float(hist[r, 0]) for r in range(n_keep)]
    gn_hist = [float(hist[r, 1]) for r in range(n_keep)]
    if telemetry:
        for prog in profiled:
            prog.flush()
        _emit_sync_rate(obs_run, fetches,
                        max(it_pre - int(start_iteration), 1))
        obs_run.event(
            "solve_end", phase="solve", iterations=it_final,
            terminated_by=terminated_by,
            duration_s=time.perf_counter() - t_solve0,
            cost=cost_hist[-1] if cost_hist else None,
            grad_norm=gn_hist[-1] if gn_hist else None,
            num_weight_updates=nwu_pre,
            verdict_every=verdict_every, verdict=unpack_verdict(word))
    return RBCDResult(T=fin["T"], X=state.X, cost_history=cost_hist,
                      grad_norm_history=gn_hist, iterations=it_final,
                      terminated_by=terminated_by, weights=fin["w_glob"],
                      state=state, certificate=certificate)


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

    @property
    def n_total(self) -> int:
        """Global pose count."""
        return self.part.meas_global.num_poses

    @property
    def num_meas(self) -> int:
        """Global measurement count."""
        return len(self.part.meas_global)


def prepare_problem(meas: Measurements, num_robots: int,
                    params: AgentParams | None = None, dtype=None,
                    part: Partition | None = None,
                    init: str | None = "chordal",
                    device="cuda") -> PreparedProblem:
    """Problem build: partition, per-agent graph assembly on ``device``
    and (unless ``init=None``) the initial lifted state
    (``initial_state_for``).  ``dtype`` defaults to float32 on CUDA and
    float64 on the CPU."""
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    params = params or AgentParams(d=meas.d, r=5, num_robots=num_robots)
    part = part or partition_contiguous(meas, num_robots)
    graph, meta = build_graph(part, params.r, dtype, dev)
    X0 = initial_state_for(init, part, meta, graph, params, dtype) \
        if init is not None else None
    return PreparedProblem(part=part, graph=graph, meta=meta, params=params,
                           dtype=dtype, X0=X0)


def dispatch_prepared(prob: PreparedProblem, max_iters: int | None = None,
                      grad_norm_tol: float = 0.1, eval_every: int = 1,
                      state: RBCDState | None = None,
                      verdict_every: int | None = None) -> RBCDResult:
    """Solve a prepared problem with the driver loop; ``state`` overrides
    the fresh ``init_state`` (e.g. to resume), ``verdict_every`` opts into
    the device-resident verdict loop."""
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
    """Iterated GNC: robust solve, hard-drop the rejected loop closures,
    re-anneal on the kept edges — ``passes`` times (beyond the reference,
    whose GNC is single-pass, ``PGOAgent.cpp:1181-1245``).  Between passes,
    dropped edges whose residual at the new solution is back inside the
    TLS inlier boundary (``gnc_barc``) are reinstated.  Only loop closures
    are ever dropped, so the odometry chain stays intact.

    Returns ``(result_of_last_pass, weights_full, kept_mask)``:
    ``weights_full [M]`` maps the last pass's weights to the original
    measurement indices (dropped edges report 0), ``kept_mask [M]`` marks
    the measurements the last pass solved over, and ``result.iterations``
    is the total round count.  ``solve_kw`` goes to ``solve_rbcd``
    (``device=`` included).

    One deliberate deviation: the JAX package checks for a cost that is
    not robust after a pass (``res.weights is None``), which its driver
    never returns; here the same misuse raises before the first pass."""
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    if "part" in solve_kw:
        # solve_rbcd prefers a supplied Partition over its meas argument,
        # which would silently undo the per-pass edge filtering.
        raise ValueError("solve_rbcd_robust_iterated re-partitions each "
                         "pass; 'part' cannot be supplied")
    if passes > 1 and (params is None
                       or params.robust.cost_type == RobustCostType.L2):
        raise ValueError(
            "solve_rbcd_robust_iterated needs a GNC-weighted cost "
            "(params.robust.cost_type GNC_TLS); an L2 solve has no weights "
            "to reject by")
    lc = loop_closure_mask(meas)
    kept = np.ones(len(meas), bool)
    total_rounds = 0
    for p in range(passes):
        sub = meas.select(kept) if not kept.all() else meas
        res = solve_rbcd(sub, num_robots, params, **solve_kw)
        total_rounds += res.iterations
        w_full = np.zeros(len(meas))
        w_full[kept] = res.weights.detach().cpu().numpy()
        if p == passes - 1:
            break
        drop = (w_full < reject_thresh) & kept & lc
        # Re-test every previously dropped edge against the new iterate.
        reinstate = np.zeros(len(meas), bool)
        dropped = ~kept
        if dropped.any():
            rn = _global_residual_norms(res, meas, num_robots)
            reinstate = dropped & (rn < params.robust.gnc_barc)
            w_full[reinstate] = 1.0
        new_kept = (kept & ~drop) | reinstate
        if (new_kept == kept).all():
            break
        kept = new_kept
    res = dataclasses.replace(res, iterations=total_rounds)
    return res, w_full, kept


def _global_residual_norms(res: RBCDResult, meas: Measurements,
                           num_robots: int) -> np.ndarray:
    """Per-measurement residual norms sqrt(kappa ||rR||^2 + tau ||rt||^2)
    of the full original measurement set at a result's iterate, in float32
    on the host as the JAX package computes them (the iterate lives on
    the filtered problem; edge filtering leaves the pose layout as it
    is)."""
    edges_g = edge_set_from_measurements(meas, dtype=torch.float32,
                                         device="cpu")
    part = partition_contiguous(meas, num_robots)
    Xg = gather_poses_to_global(
        res.X.detach().to("cpu", torch.float32).numpy(), part)
    rR, rt = quadratic._edge_terms(torch.as_tensor(Xg), edges_g)
    sq = edges_g.kappa * torch.sum(rR * rR, dim=(-2, -1)) \
        + edges_g.tau * torch.sum(rt * rt, dim=-1)
    return np.sqrt(np.maximum(sq.numpy(), 0.0))

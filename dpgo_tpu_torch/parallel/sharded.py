"""Sharded RBCD: agents distributed over the ranks of a ``torch.distributed``
process group — the port of ``dpgo_tpu.parallel.sharded``.

The JAX package shards agents over a device mesh under ``shard_map``; here
a mesh is a process group (``Mesh``), each rank holds one contiguous block
of ``A / world_size`` agents, and every rank runs the same Python driver
(SPMD, as ``torch.distributed`` code does) and returns the same replicated
result.  The collectives map one to one:

* the public-pose exchange (``getSharedPoseDict`` -> ``updateNeighborPoses``,
  reference ``PGOAgent.cpp:95-105``, ``434-458``) is one
  ``all_gather_into_tensor`` of the padded public-pose table, or with
  ``exchange="ppermute"`` one ``batch_isend_irecv`` pair per ring offset
  that carries an edge;
* every ``psum`` (the owner-scatter of the global iterate, the weight
  collapse, consensus, the GN tail's and the certificate's dot products)
  is an ``all_reduce``; GNC's freeze is a MIN ``all_reduce``;
* the lifting matrix and global anchor are replicated tensors.

The per-rank round body is ``models.rbcd._rbcd_round`` with ``mesh`` set —
the same code as the single-device path, so at world size 1 the sharded
solve equals ``rbcd.solve_rbcd`` bit for bit.  On a CUDA device the
group's backend is NCCL, on the CPU gloo; a gloo group never moves CUDA
tensors.  Each rank's local step is one launch of the fused RTR kernel
over its ``A_loc`` agents.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..config import AgentParams
from ..device import default_dtype, resolve_device
from ..models import rbcd, refine
from ..models.rbcd import GraphMeta, MultiAgentGraph, RBCDState, init_state
from ..ops import manifold, quadratic, smallmat
from ..types import Measurements, edge_set_from_measurements
from ..utils.partition import Partition, partition_contiguous
from ..utils.profiling import RoundTimer
from . import resilience as resilience_mod

AXIS = "agent"

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}


class Mesh:
    """A 1-D (or ``("dcn", "ici")``) mesh over the ranks of a process
    group: agents shard over the flattened rank order in equal contiguous
    blocks.  ``rank`` is this process's position in the group (-1 when it
    is not a member), ``devices`` the rank grid in the mesh's shape (so
    ``mesh.devices.size`` is its size, as for a JAX mesh), ``device`` the
    torch device its tensors live on.  The collective methods are what
    ``rbcd._rbcd_round(mesh=...)`` calls."""

    def __init__(self, group, ranks, device: torch.device,
                 axis_names: tuple = (AXIS,), shape: tuple | None = None):
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.device = device
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None else (len(self.ranks),)
        self.devices = np.arange(len(self.ranks)).reshape(self.shape)
        me = dist.get_rank()
        self.member = me in self.ranks
        self.rank = self.ranks.index(me) if self.member else -1

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return (f"Mesh(size={self.size}, axes={self.axis_names}, "
                f"rank={self.rank}, device={self.device})")

    def all_gather_start(self, t: torch.Tensor):
        """Issue the tiled all-gather of ``t`` along dim 0 over the group;
        the returned callable waits for it (on NCCL a stream wait, no host
        sync) and gives the ``[size * t.shape[0], ...]`` result."""
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        work = dist.all_gather_into_tensor(out, t, group=self.group,
                                           async_op=True)

        def wait():
            work.wait()
            return out

        return wait

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.bool:
            return self.all_gather(t.to(torch.uint8)).to(torch.bool)
        return self.all_gather_start(t)()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` ("sum", "min", "max") over the group, out of place."""
        out = t.reshape(-1).clone()
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=self.group)
        return out.reshape(t.shape)

    def ppermute_start(self, t: torch.Tensor, shifts: tuple):
        """Send ``t`` to the rank ``s`` positions ahead and receive from the
        one ``s`` behind, for every ``s`` in ``shifts`` (one
        ``batch_isend_irecv``); the returned callable waits and gives the
        received tensors in ``shifts`` order."""
        t = t.contiguous()
        n = self.size
        ops, recvs = [], []
        for s in shifts:
            r = torch.empty_like(t)
            recvs.append(r)
            ops.append(dist.P2POp(dist.isend, t,
                                  self.ranks[(self.rank + s) % n],
                                  group=self.group))
            ops.append(dist.P2POp(dist.irecv, r,
                                  self.ranks[(self.rank - s) % n],
                                  group=self.group))
        works = dist.batch_isend_irecv(ops) if ops else []

        def wait():
            for w in works:
                w.wait()
            return recvs

        return wait

    def barrier(self) -> None:
        """A collective every rank of the group passes together."""
        self.all_reduce(torch.zeros(1, device=self.device))

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` of the group's rank ``src`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[src],
                                   group=self.group,
                                   device=self.device
                                   if self.device.type == "cuda" else None)
        return box[0]


#: Subgroups of the default group by (size, backend), so repeated meshes
#: and a shrink reuse one communicator.
_SUBGROUPS: dict = {}


def _mesh_device(device) -> torch.device:
    """The mesh's device (raising without CUDA unless the CPU is asked
    for), after making sure of a default group that can move its tensors:
    with none, a world of size 1 (NCCL on CUDA, gloo on the CPU) from an
    in-process store."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    backend = str(dist.get_backend()).lower()
    if dev.type == "cuda" and "nccl" not in backend:
        raise ValueError(
            f"a mesh on {dev} needs an NCCL process group, the default "
            f"group's backend is {backend!r} (gloo never moves CUDA "
            "tensors here)")
    if dev.type != "cuda" and "gloo" not in backend:
        raise ValueError(
            f"a mesh on {dev} needs a gloo process group, the default "
            f"group's backend is {backend!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _group_of(n: int):
    """The default group, or the subgroup of its first ``n`` ranks."""
    world = dist.get_world_size()
    if n == world:
        return dist.group.WORLD
    key = (n, str(dist.get_backend()))
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = dist.new_group(ranks=list(range(n)),
                                         use_local_synchronization=True)
    return _SUBGROUPS[key]


def make_mesh(num_devices: int | None = None, device="cuda") -> Mesh:
    """A 1-D mesh over the ``"agent"`` axis: the initialized default group,
    or the subgroup of its first ``num_devices`` ranks; with no group, a
    world of size 1 on the caller's ``device`` is initialized first.
    Every rank of the default group calls this (SPMD).  Raises without
    CUDA unless ``device="cpu"``."""
    dev = _mesh_device(device)
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n > world or n < 1:
        raise ValueError(
            f"requested {n} devices but only {world} are available")
    return Mesh(_group_of(n), range(n), dev)


def make_multislice_mesh(num_slices: int, device="cuda") -> Mesh:
    """A 2-D ``("dcn", "ici")`` mesh over the default group: ``num_slices``
    slices x ranks per slice.  Agents shard over the flattened product (the
    same layout and program as the 1-D mesh; the point-to-point exchange
    refuses it, as in the JAX package)."""
    dev = _mesh_device(device)
    world = dist.get_world_size()
    if world % num_slices != 0:
        raise ValueError(
            f"{world} devices do not split into {num_slices} slices")
    return Mesh(dist.group.WORLD, range(world), dev, ("dcn", "ici"),
                (num_slices, world // num_slices))


def _slice_tree(tree, lo: int, hi: int, device):
    """Rows ``lo:hi`` of every tensor of ``tree`` with at least one
    dimension, on ``device``; 0-dim tensors and host scalars replicate."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree[lo:hi] if tree.dim() >= 1 else tree
        return t.to(device).contiguous()
    if isinstance(tree, (tuple, list)):
        items = [_slice_tree(t, lo, hi, device) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def shard_problem(mesh: Mesh, state: RBCDState, graph: MultiAgentGraph):
    """This rank's share of the state and graph: the contiguous block of
    ``A / mesh.size`` agents at its position, on the mesh's device.
    ``num_robots`` must be a multiple of the mesh size."""
    A = state.X.shape[0]
    n_dev = mesh.size
    if A % n_dev != 0:
        raise ValueError(
            f"num_robots={A} must be a multiple of mesh size {n_dev}; "
            "pick a divisible robot count or a smaller mesh")
    A_loc = A // n_dev
    lo = max(mesh.rank, 0) * A_loc
    return (_slice_tree(state, lo, lo + A_loc, mesh.device),
            _slice_tree(graph, lo, lo + A_loc, mesh.device))


def gather_state(mesh: Mesh, state: RBCDState) -> RBCDState:
    """The whole ``[A, ...]`` state on every rank from the ranks' blocks
    (identity at mesh size 1)."""
    if mesh.size == 1:
        return state

    def g(t):
        if isinstance(t, torch.Tensor) and t.dim() >= 1:
            return mesh.all_gather(t)
        return t

    return RBCDState(*(g(t) for t in state))


def _local_block(mesh: Mesh, tree, num_robots: int):
    """``tree`` (a tensor or a graph) as this rank's block on the mesh's
    device: sliced when it holds all ``num_robots`` agents and the mesh
    has more than one rank, else moved as it is."""
    lead = tree if isinstance(tree, torch.Tensor) else tree.n
    if mesh.size > 1 and lead.shape[0] == num_robots:
        A_loc = num_robots // mesh.size
        lo = mesh.rank * A_loc
        return _slice_tree(tree, lo, lo + A_loc, mesh.device)
    return _slice_tree(tree, 0, None, mesh.device)


def _exchange_plan(mesh: Mesh, meta: GraphMeta, graph_host: MultiAgentGraph,
                   exchange: str):
    """Resolve the pose-exchange backend: ``"all_gather"`` (v1, the full
    public table to every rank) or ``"ppermute"`` (one point-to-point
    exchange per rank shift that carries an edge).  ``graph_host`` is the
    whole graph; returns ``(shifts, plan)`` with this rank's rows of the
    plan."""
    if exchange == "all_gather":
        return (), None
    if exchange != "ppermute":
        raise ValueError(f"unknown exchange backend {exchange!r}")
    if len(mesh.axis_names) > 1:
        raise ValueError(
            "ppermute exchange plans device-ring shifts over a 1-D mesh; "
            "use exchange='all_gather' on a multi-slice mesh")
    shifts, plan = rbcd.plan_ppermute(graph_host, meta.num_robots,
                                      mesh.size)
    A_loc = meta.num_robots // mesh.size
    lo = max(mesh.rank, 0) * A_loc
    return shifts, _slice_tree(plan, lo, lo + A_loc, mesh.device)


def make_sharded_step(mesh: Mesh, meta: GraphMeta, params: AgentParams,
                      shifts: tuple = (), plan=None):
    """The sharded RBCD round: ``step(state, graph, update_weights=False,
    restart=False)`` on this rank's block (``rbcd._rbcd_round`` with the
    mesh).  ``shifts``/``plan`` (``_exchange_plan``) select the
    point-to-point exchange; default is the all-gather v1."""

    def step(state: RBCDState, graph: MultiAgentGraph,
             update_weights: bool = False, restart: bool = False):
        return rbcd._rbcd_round(state, graph, meta, params,
                                update_weights=update_weights,
                                restart=restart, mesh=mesh, plan=plan,
                                shifts=shifts)

    return step


def make_sharded_multi_step(mesh: Mesh, meta: GraphMeta, params: AgentParams,
                            shifts: tuple = (), plan=None,
                            overlap: bool = True):
    """``k`` plain sharded rounds in one call (``rbcd.rbcd_steps`` with the
    mesh), no host sync inside.  ``overlap`` (default on) pipelines the
    halo exchange: each round's exchange is issued right after the
    previous round's Stiefel update, so the collective runs under the
    trailing status/momentum work (identical values round for round)."""

    def steps(state: RBCDState, graph: MultiAgentGraph, num_rounds: int):
        return rbcd.rbcd_steps(state, graph, num_rounds, meta, params,
                               mesh=mesh, plan=plan, shifts=shifts,
                               overlap=overlap)

    return steps


def make_sharded_segment(mesh: Mesh, meta: GraphMeta, params: AgentParams,
                         shifts: tuple = (), plan=None,
                         overlap: bool = True):
    """One sharded schedule segment: a (possibly flagged) first round and
    the plain stretch (``rbcd.rbcd_segment`` with the mesh); ``overlap``
    pipelines the stretch's halo exchange."""

    def seg(state: RBCDState, graph: MultiAgentGraph, num_rounds: int,
            update_weights: bool = False, restart: bool = False):
        return rbcd.rbcd_segment(state, graph, num_rounds, meta, params,
                                 first_update_weights=update_weights,
                                 first_restart=restart, mesh=mesh,
                                 plan=plan, shifts=shifts, overlap=overlap)

    return seg


def comm_bytes_per_round(meta: GraphMeta, mesh_size: int,
                         shifts: tuple | None = None,
                         accel: bool = False, itemsize: int = 4,
                         greedy: bool = False) -> int:
    """Modeled per-rank interconnect bytes for one round's pose exchange
    (the mesh analog of the reference driver's hand-counted communication
    bytes, ``MultiRobotExample.cpp:60,143,195,209,274-279``).

    The all-gather (``shifts=None``) moves each rank's public table to
    every other rank: ``mesh_size - 1`` table hops on a ring.  The
    point-to-point route moves it once per planned shift.  Nesterov
    acceleration doubles the volume (aux poses exchanged too); ``greedy``
    adds the greedy schedule's [A]-float gradient-norm all-gather."""
    if meta.num_robots % mesh_size != 0:
        raise ValueError(
            f"num_robots={meta.num_robots} must be a multiple of "
            f"mesh_size={mesh_size} (shard_problem's layout)")
    A_loc = meta.num_robots // mesh_size
    table = A_loc * meta.p_max * meta.rank * (meta.d + 1) * itemsize
    hops = (mesh_size - 1) if shifts is None else len(shifts)
    exchanges = 2 if accel else 1
    greedy_gather = (mesh_size - 1) * A_loc * itemsize if greedy else 0
    return exchanges * hops * table + greedy_gather


# ---------------------------------------------------------------------------
# Sharded verdict program (the device-resident loop on the mesh)
# ---------------------------------------------------------------------------

def _gather_exchange(graph: MultiAgentGraph, mesh: Mesh):
    """Neighbor-buffer exchange of any ``[A_loc, n, p, d+1]`` block: the
    solver round's all-gather exchange (``rbcd._exchange_for`` without a
    plan, so ``rbcd._exchange_wrap`` reaches it too), waited for at once."""
    start = rbcd._exchange_for(graph, mesh, None, ())
    return lambda Vl: start(Vl)()


def local_grad_rows(V, Vz, graph: MultiAgentGraph):
    """Complete local gradient rows of the global linear map ``V Q`` for
    every agent of this rank: the per-agent edge list applied to the
    ``[local | neighbor]`` buffer through the ELL incidence
    (``quadratic.egrad_ell`` is linear, so it is also the ``Q`` matvec on
    probe blocks).  Shared edges appear in both endpoint agents' lists
    with the remote endpoint in a neighbor slot, so local rows accumulate
    exactly the global rows — the matvec of the sharded certificate and
    of the sharded GN-CG tail."""
    return quadratic.egrad_ell(torch.cat([V, Vz], dim=1), graph.edges,
                               graph.inc_slot, graph.inc_mask)


def _global_assembly(mesh: Mesh, graph: MultiAgentGraph, n_total: int,
                     num_meas: int):
    """``(Xa, weights) -> (Xg, w_glob)`` on every rank: the all-reduce of
    each rank's owner scatter (disjoint supports — each global pose has
    one owner agent, so the sum adds one value to zeros and is exact) and
    of the per-measurement weight numerators and denominators (a
    measurement has at most two copies, with identical weights)."""
    ids = graph.meas_id.reshape(-1)
    m = graph.edges.mask.reshape(-1)

    def assemble(Xa, weights):
        Xg = mesh.all_reduce(rbcd.gather_to_global(Xa, graph, n_total))
        nd = torch.zeros((2, num_meas), dtype=weights.dtype,
                         device=weights.device)
        nd[0].index_add_(0, ids, weights.reshape(-1) * m)
        nd[1].index_add_(0, ids, m)
        num, den = mesh.all_reduce(nd)
        w_glob = torch.where(den > 0, num / torch.clamp(den, min=1.0),
                             torch.ones_like(num))
        return Xg, w_glob

    return assemble


def make_sharded_metrics_body(mesh: Mesh, graph: MultiAgentGraph,
                              edges_g, n_total: int, num_meas: int,
                              telemetry: bool):
    """The per-eval metric row on the mesh — ``rbcd._central_metrics_body``
    with every centralized reduction a collective: the global iterate and
    the weight collapse (``_global_assembly``, exact), consensus as an
    all-reduce of the not-ready count, the telemetry extras as all-reduced
    partial sums and the per-agent relative change as an all-gather in
    agent order.  The cost and gradient then evaluate replicated from the
    assembly — the single-device body's math, so the verdict word, the
    history rows and the termination latch carry over unchanged.  Fed to
    ``rbcd.run_rbcd`` through its ``metrics_body_factory`` seam."""
    assemble = _global_assembly(mesh, graph, n_total, num_meas)
    inc_g = quadratic.edge_incidence(edges_g, n_total)

    def metrics_body(Xa, weights, ready, mu, rel):
        Xg, w_glob = assemble(Xa, weights)
        eg = edges_g._replace(weight=w_glob)
        f = quadratic.cost(Xg, eg)
        g = manifold.rgrad(Xg, quadratic.egrad_ell(Xg, eg, *inc_g))
        not_ready = mesh.all_reduce(
            torch.sum(torch.logical_not(ready).to(torch.int32)))
        vals = [f, manifold.norm(g), (not_ready == 0).to(f.dtype)]
        if telemetry:
            e = graph.edges
            upd = e.mask * e.is_lc * (1.0 - e.fixed_weight)
            sums = mesh.all_reduce(torch.stack([
                torch.sum(upd), torch.sum((weights > 0.5) * upd),
                torch.sum(weights * upd)]))
            n_upd = torch.clamp(sums[0], min=1.0)
            vals += [mu.to(f.dtype), sums[1] / n_upd, sums[2] / n_upd]
            rel_all = mesh.all_gather(rel.to(f.dtype))
            return torch.cat([torch.stack(vals), rel_all])
        return torch.stack(vals)

    return metrics_body


# ---------------------------------------------------------------------------
# Sharded device-resident Gauss-Newton-CG tail
# ---------------------------------------------------------------------------
#
# ``refine.gn_tail`` assembles S = Q - Lambda on the host in f64.  Here the
# same algorithm runs on the mesh: the S matvec is each rank's local ELL
# edge product plus the halo exchange (``local_grad_rows``), every CG dot
# product is an all-reduce, the block-Jacobi preconditioner is
# ``refine.gn_precond_blocks`` per rank, factored by the sync-free
# ``smallmat`` Cholesky, and one outer step — CG and backtracking included
# — is one call that reads nothing on the host: both loops run to their
# bounds with the finished lanes frozen (the same values and counts as
# stopping early), on the card and on the CPU alike.  The driver reads the
# gate norm and one stats vector per outer step through ``rbcd._host_fetch``.


def _gn_outer_shard(X, graph: MultiAgentGraph, *, mesh: Mesh,
                    meta: GraphMeta, cfg: "refine.GNTailConfig"):
    """One GN outer step on this rank's block: gradient, preconditioned
    Steihaug-CG Newton solve, backtracking projective retraction —
    ``refine.gn_tail``'s per-outer-iteration math.  Returns ``(X_new
    [A_loc, ...], stats [7])`` with stats = [cost, grad_norm, cg_iters,
    neg_curv, accepted, new_cost, step], the same on every rank."""
    d = meta.d
    n_max = meta.n_max
    dtype = X.dtype

    def psum(v):
        return mesh.all_reduce(v)

    def pdot(u, w):
        return psum(torch.sum(u * w))

    exchange = _gather_exchange(graph, mesh)
    pmask = graph.pose_mask[..., None, None]
    edges = graph.edges
    # Each cross-robot measurement appears in BOTH endpoint agents' edge
    # lists, so the global cost halves the shared copies.
    shared = ((edges.i >= n_max) | (edges.j >= n_max)).to(dtype)
    cscale = edges.mask * edges.weight * (1.0 - 0.5 * shared)

    def grad_rows(V):
        return local_grad_rows(V, exchange(V), graph)

    def cost_of(V):
        rR, rt = quadratic._edge_terms(torch.cat([V, exchange(V)], dim=1),
                                       edges)
        per = 0.5 * torch.sum(
            cscale * (edges.kappa * torch.sum(rR * rR, dim=(-2, -1))
                      + edges.tau * torch.sum(rt * rt, dim=-1)), dim=-1)
        return psum(torch.sum(per))

    def tangent(W):
        return manifold.tangent_project(X, W) * pmask

    # G = rows of X Q; Lambda_i = sym(Y_i^T G_Y,i); rgrad = G - [Y Lambda|0].
    G = grad_rows(X)
    lam = manifold.sym(X[..., :d].transpose(-1, -2) @ G[..., :d])

    def lam_of(V):
        return torch.cat([V[..., :d] @ lam, torch.zeros_like(V[..., -1:])],
                         dim=-1)

    grad = tangent(G - lam_of(X))
    f0 = cost_of(X)
    gn = torch.sqrt(pdot(grad, grad))

    blocks = refine.gn_precond_blocks(edges, lam, graph.inc_slot,
                                      graph.inc_mask, d, cfg.precond_shift)
    L = smallmat.cholesky_small(blocks)

    def Av(V):
        W = grad_rows(V) - lam_of(V)
        if cfg.damping:
            W = W + cfg.damping * V
        return tangent(W)

    def Minv(V):
        W = smallmat.cho_solve_small(L, V.transpose(-1, -2))
        return tangent(W.transpose(-1, -2))

    # Preconditioned CG on the tangent space, Steihaug exit.
    b = -grad
    b_norm = torch.sqrt(pdot(b, b))
    z0 = Minv(b)
    eps = 1e-300 if dtype == torch.float64 else 1e-30
    k = torch.zeros((), dtype=torch.int32, device=X.device)
    v = torch.zeros_like(b)
    res, p, rz = b, z0, pdot(b, z0)
    done = torch.zeros((), dtype=torch.bool, device=X.device)
    neg_seen = torch.zeros_like(done)
    for it in range(int(cfg.cg_max_iters)):
        Ap = Av(p)
        pAp = pdot(p, Ap)
        neg = pAp <= 0
        # Negative curvature on the very first iteration: fall back to the
        # gradient direction; later: keep the accumulated step.
        v_fallback = b if it == 0 else v
        alpha = rz / torch.where(neg, torch.ones_like(pAp), pAp)
        v_new = v + alpha * p
        res_new = res - alpha * Ap
        small = torch.sqrt(pdot(res_new, res_new)) <= cfg.cg_rtol * b_norm
        z = Minv(res_new)
        rz_new = pdot(res_new, z)
        p_new = z + (rz_new / torch.clamp(rz, min=eps)) * p
        stop = neg | small
        v_it = torch.where(neg, v_fallback, v_new)
        res_it = torch.where(neg, res, res_new)
        p_it = torch.where(stop, p, p_new)
        rz_it = torch.where(stop, rz, rz_new)
        # Frozen once done: the lanes keep their values, k stops.
        live = ~done
        k = k + live.to(k.dtype)
        v = torch.where(live, v_it, v)
        res = torch.where(live, res_it, res)
        p = torch.where(live, p_it, p)
        rz = torch.where(live, rz_it, rz)
        neg_seen = neg_seen | (neg & live)
        done = done | stop
    cg_iters = k

    # Backtracking projective retraction on the true (all-reduced) cost.
    step = torch.ones((), dtype=dtype, device=X.device)
    X_new, f_new = X, f0
    accepted = torch.zeros((), dtype=torch.bool, device=X.device)
    for _ in range(int(cfg.max_backtracks)):
        Xc = manifold.project(X + step * v)
        fc = cost_of(Xc)
        live = ~accepted
        ok = torch.isfinite(fc) & (fc < f0) & live
        X_new = torch.where(ok, Xc, X_new)
        f_new = torch.where(ok, fc, f_new)
        step = torch.where(live, step * cfg.step_shrink, step)
        accepted = accepted | ok

    stats = torch.stack([f0, gn, cg_iters.to(dtype), neg_seen.to(dtype),
                         accepted.to(dtype), f_new, step])
    return X_new, stats


def _gn_gradnorm_shard(X, graph: MultiAgentGraph, *, mesh: Mesh,
                       meta: GraphMeta):
    """The centralized Riemannian gradient norm of the sharded iterate
    (the GN tail's gate quantity) — one matvec."""
    d = meta.d
    G = local_grad_rows(X, _gather_exchange(graph, mesh)(X), graph)
    lam = manifold.sym(X[..., :d].transpose(-1, -2) @ G[..., :d])
    S_rot = G[..., :d] - X[..., :d] @ lam
    grad = torch.cat([S_rot, G[..., -1:]], dim=-1)
    grad = manifold.tangent_project(X, grad) \
        * graph.pose_mask[..., None, None]
    return torch.sqrt(mesh.all_reduce(torch.sum(grad * grad)))


def _gn_programs(mesh: Mesh, meta: GraphMeta, cfg):
    """``(outer, gradnorm)``: one GN outer step and the gate norm on the
    mesh (plain Python; nothing is compiled or cached)."""

    def outer(X, graph):
        return _gn_outer_shard(X, graph, mesh=mesh, meta=meta, cfg=cfg)

    def gradnorm(X, graph):
        return _gn_gradnorm_shard(X, graph, mesh=mesh, meta=meta)

    return outer, gradnorm


def _gn_tail_local(X, graph: MultiAgentGraph, meta: GraphMeta, mesh: Mesh,
                   cfg, log=None, fetch_deadline_s: float | None = None):
    """The GN tail on this rank's block: ``(X_local, GNTailResult)``."""
    outer, gradnorm = _gn_programs(mesh, meta, cfg)
    cost_hist: list = []
    gn_hist: list = []
    cg_total = 0
    outer_done = 0
    terminated_by = "max_outer"
    with contextlib.ExitStack() as stack:
        if fetch_deadline_s is not None:
            # The two reads below go through rbcd._host_fetch, which the
            # guard deadline-wraps.
            stack.enter_context(resilience_mod.fetch_guard(
                resilience_mod.Watchdog(fetch_deadline_s), None,
                ["gn_tail"], close=True))
        for k in range(int(cfg.max_outer) + 1):
            # One scalar per outer step (the gate) and one stats vector:
            # the CG loop itself never reads the host.
            gn = float(rbcd._host_fetch(gradnorm(X, graph)))
            gn_hist.append(gn)
            if log is not None:
                cst = cost_hist[-1] if cost_hist else float("nan")
                log(f"  gn_tail_sharded outer {k}: cost {cst:.9g} "
                    f"gn {gn:.4g}")
            if gn < cfg.grad_norm_tol:
                terminated_by = "grad_norm"
                break
            if k == int(cfg.max_outer):
                break  # budget exhausted; final point's gate value recorded
            X_new, stats = outer(X, graph)
            st = rbcd._host_fetch(stats)
            f0, _gn_s, cg_iters, _neg, accepted, f_new, _step = \
                (float(v) for v in st)
            if not cost_hist:
                cost_hist.append(f0)
            cg_total += int(cg_iters)
            outer_done = k + 1
            if accepted <= 0:
                cost_hist.append(f0)
                terminated_by = "no_decrease"
                break
            cost_hist.append(f_new)
            X = X_new

    n_total = int(mesh.all_reduce(graph.global_index.max(), "max")) + 1
    Xg = mesh.all_reduce(rbcd.gather_to_global(X, graph, n_total))
    result = refine.GNTailResult(
        X=Xg.detach().cpu().numpy().astype(np.float64),
        cost_history=cost_hist, grad_norm_history=gn_hist,
        outer_iterations=outer_done, cg_iterations=cg_total,
        converged=terminated_by == "grad_norm", terminated_by=terminated_by)
    return X, result


def gn_tail_sharded(X, graph: MultiAgentGraph, meta: GraphMeta,
                    mesh: Mesh | None = None,
                    cfg: "refine.GNTailConfig | None" = None,
                    weights=None, log=None,
                    fetch_deadline_s: float | None = None, device="cuda"):
    """Sharded Gauss-Newton-CG polish of an agent-partitioned iterate —
    ``refine.gn_tail`` without the host-f64 scipy round trip.

    ``X [A, n_max, r, d+1]``, ``graph`` and ``weights [A, E]`` (which
    replaces ``graph.edges.weight`` — the final GNC weights of a robust
    solve) hold every agent, or this rank's block; the default mesh is
    ``make_mesh(device=device)``.  Per outer step the host reads the gate
    norm and one stats vector (``rbcd._host_fetch``); the CG loop and the
    backtracking run on the device.  ``fetch_deadline_s`` arms a
    ``parallel.resilience.Watchdog`` around those reads.

    Returns ``(X_agents [A, ...], refine.GNTailResult)``: the polished
    iterate of every agent (the same on every rank) and the host record
    (global f64 assembly, histories, totals) in ``gn_tail``'s schema."""
    mesh = mesh or make_mesh(device=device)
    cfg = cfg or refine.GNTailConfig()
    A = meta.num_robots
    graph = _local_block(mesh, graph, A)
    if weights is not None:
        graph = rbcd.with_weights(graph, _local_block(
            mesh, torch.as_tensor(weights), A))
    X = _local_block(mesh, torch.as_tensor(X), A)
    X, result = _gn_tail_local(X, graph, meta, mesh, cfg, log=log,
                               fetch_deadline_s=fetch_deadline_s)
    return (mesh.all_gather(X) if mesh.size > 1 else X), result


#: Fused rounds per arm of the ``overlap="auto"`` calibration, timed
#: repetitions per arm (best-of, alternating), and the A/B efficiency the
#: overlapped arm must clear to win — hysteresis above the noise band of
#: short best-of-N walls on a shared host (the JAX package's constants).
_AUTO_CALIB_ROUNDS = 8
_AUTO_CALIB_REPS = 3
_AUTO_THRESHOLD = 0.25


def _resolve_overlap_auto(mesh: Mesh, state, graph, meta, params, exchange,
                          graph_host=None,
                          calib_rounds: int = _AUTO_CALIB_ROUNDS) -> bool:
    """The adaptive overlap gate: a bounded lockstep-vs-overlapped
    calibration on the real sharded problem, arbitrated by
    ``obs.devprof.decide_overlap`` and broadcast from the mesh's first
    rank, so every rank takes the same loop (their collectives must pair).

    Each arm warms once, then times ``calib_rounds``-round calls to a
    device fence (``devprof.time_arm``), alternating arms, best of
    ``_AUTO_CALIB_REPS``, with no profiler active.  With telemetry on, one
    more call per arm runs under a ``DeviceTraceWindow`` so the
    ``overlap_decision`` event carries the device-time evidence.  The
    calibration's states are discarded: the solve starts from the
    untouched initial state, so forced ``overlap=True/False`` stay
    bitwise references."""
    from ..obs import devprof

    run = obs.get_run()
    size = mesh.size
    if size == 1:
        # No collectives to hide on one device — nothing to calibrate.
        if run is not None:
            run.event("overlap_decision", phase="setup", mesh_size=size,
                      exchange=exchange, overlap=False,
                      reason="single_device_mesh", calib_rounds=0)
        return False
    shifts, plan = _exchange_plan(mesh, meta, graph_host, exchange)
    names = ("lockstep", "overlapped")
    multis = {}
    arms = {}
    for name, ov in zip(names, (False, True)):
        multis[name] = make_sharded_multi_step(mesh, meta, params, shifts,
                                               plan, overlap=ov)
        devprof.time_arm(multis[name], state, graph, calib_rounds)  # warm
        arms[name] = {"seconds": float("inf"), "rounds": calib_rounds,
                      "attribution": None}
    for _rep in range(_AUTO_CALIB_REPS):
        for name in names:
            dt = devprof.time_arm(multis[name], state, graph, calib_rounds)
            arms[name]["seconds"] = min(arms[name]["seconds"], dt)
    if run is not None:
        for name in names:
            window = devprof.DeviceTraceWindow(
                os.path.join(run.run_dir, f"devprof_auto_{name}"),
                plane="sharded").start()
            devprof.time_arm(multis[name], state, graph, calib_rounds)
            arms[name]["attribution"] = window.stop(
                num_rounds=calib_rounds, label=f"auto_{name}")
    decision = mesh.broadcast_object(
        devprof.decide_overlap(arms, threshold=_AUTO_THRESHOLD))
    if run is not None:
        run.event("overlap_decision", phase="setup", mesh_size=size,
                  exchange=exchange, **decision)
    return bool(decision["overlap"])


def _resume_from_store(sup, mesh, graph_host, meta, params, run):
    """Warm entry of ``solve_rbcd_sharded(resume=True)``: the newest usable
    snapshot of the supervisor's session, resharded onto the caller's mesh
    (snapshots do not depend on the mesh), or ``None`` for a cold start.
    The same refresh-then-shard order as fault recovery, so a same-mesh
    resume is bitwise."""
    flush = getattr(sup.store, "flush", None)
    if flush is not None:
        flush()
    snap = sup.store.load_newest(sup.session_id)
    if snap is None:
        return None
    if snap.global_index is not None and not np.array_equal(
            np.asarray(snap.global_index), sup._gidx):
        return None  # different problem layout — fail open to cold start
    host_state = rbcd.refresh_problem(
        _on_device(snap.state, graph_host.n.device), graph_host, meta,
        params)
    state, graph = shard_problem(mesh, host_state, graph_host)
    if run is not None:
        run.event("mesh_resume", phase="resilience",
                  session=sup.session_id, iteration=int(snap.iteration),
                  mesh_size=mesh.size)
    return state, graph, int(snap.iteration), int(snap.num_weight_updates)


def _on_device(state: RBCDState, device) -> RBCDState:
    return RBCDState(*(t.to(device) if isinstance(t, torch.Tensor) else t
                       for t in state))


def _replicate(res: "rbcd.RBCDResult", mesh: Mesh) -> "rbcd.RBCDResult":
    """A result whose state and iterate cover every agent (gathered from
    the ranks' blocks), the same on every rank."""
    if mesh.size == 1:
        return res
    state = gather_state(mesh, res.state)
    return dataclasses.replace(res, X=state.X, state=state)


def solve_rbcd_sharded(
    meas: Measurements,
    num_robots: int,
    mesh: Mesh | None = None,
    params: AgentParams | None = None,
    max_iters: int | None = None,
    grad_norm_tol: float = 0.1,
    eval_every: int = 1,
    dtype=None,
    part: Partition | None = None,
    init: str = "chordal",
    exchange: str = "all_gather",
    verdict_every: int | None = None,
    overlap: "bool | str" = True,
    gn_tail: "refine.GNTailConfig | None" = None,
    resilience: "resilience_mod.ResilienceConfig | None" = None,
    boundary_cb=None,
    resume: bool = False,
    device="cuda",
) -> rbcd.RBCDResult:
    """Distributed solve over a process-group mesh — the deployment path
    (``models.rbcd.solve_rbcd`` is the single-device path).  Every rank of
    the default group calls it (SPMD) and every rank returns the same
    replicated result: the histories, ``T``, the per-measurement weights,
    and the iterate and state of all ``num_robots`` agents.  It shares the
    driver loop (``rbcd.run_rbcd``); only the placement, the round and
    the metric row differ.  ``mesh`` defaults to ``make_mesh(device=
    device)`` (the card unless ``device="cpu"``); ``dtype`` to float32 on
    CUDA, float64 on the CPU.

    ``exchange``: ``"all_gather"`` (v1) or ``"ppermute"`` (one
    point-to-point exchange per ring offset that carries a cross-rank
    edge).  ``verdict_every`` (K, a positive multiple of ``eval_every``)
    runs the device-resident verdict loop, the metric row as collectives
    (``make_sharded_metrics_body``): one replicated word read per K rounds.
    ``overlap`` (default on) pipelines the halo exchange in the plain
    stretches; ``"auto"`` calibrates lockstep against overlapped on the
    problem (``_resolve_overlap_auto``) and records an
    ``overlap_decision`` event.  ``gn_tail`` (a ``refine.GNTailConfig``)
    appends the sharded GN-CG polish (``gn_tail_sharded``), extending the
    histories and re-finalizing the trajectory from the polished iterate.

    ``resilience`` (a ``resilience_mod.ResilienceConfig``, requires the
    verdict loop) arms checkpoints at verdict boundaries, watchdog
    deadlines on every blocking fetch, and a supervisor that rewinds to
    the last good checkpoint on a latched anomaly or a ``MeshFaultError``
    — after a device loss on a smaller mesh: every rank builds the
    subgroup of the first ``new_size`` ranks, the ranks outside it leave
    the solve, and the result is broadcast over the default group at the
    end.  ``boundary_cb(it, nwu, state, word, terminal)`` (verdict loop)
    runs before the supervisor's own at every boundary, with this rank's
    block of the state; ``resume=True`` (requires ``resilience``) enters
    at the newest usable checkpoint of ``resilience.session_id``."""
    if mesh is None:
        mesh = make_mesh(device=device)
    dev = mesh.device
    mesh_size = mesh.size
    if num_robots % mesh_size != 0:
        raise ValueError(
            f"num_robots={num_robots} is not divisible by the mesh size "
            f"{mesh_size}: solve_rbcd_sharded lays agents out in equal "
            f"contiguous blocks per device.  Pick num_robots as a "
            f"multiple of {mesh_size}, or build a smaller mesh "
            f"(make_mesh(n) with n dividing {num_robots}).")
    if resilience is not None and verdict_every is None:
        raise ValueError(
            "resilience=ResilienceConfig(...) rides the verdict-boundary "
            "contract (checkpoints at word-fetch boundaries); pass "
            "verdict_every=K to use it")
    if boundary_cb is not None and verdict_every is None:
        raise ValueError(
            "boundary_cb is a verdict-boundary hook; pass verdict_every=K "
            "to use it")
    if resume and resilience is None:
        raise ValueError(
            "resume=True restores from the resilience checkpoint store; "
            "pass resilience=ResilienceConfig(...) to use it")
    if overlap != "auto" and not isinstance(overlap, bool):
        raise ValueError(
            f"overlap={overlap!r}: expected True, False, or 'auto'")
    dtype = default_dtype(dev) if dtype is None else dtype
    params = params or AgentParams(d=meas.d, r=5, num_robots=num_robots)
    max_iters = params.max_num_iters if max_iters is None else max_iters
    world = dist.get_world_size()

    # Telemetry: per-phase setup timings and the per-rank communication
    # model; with no ambient run the timer is never created.
    run = obs.get_run()
    timer = RoundTimer() if run is not None else None

    part = part or partition_contiguous(meas, num_robots)
    if timer is not None:
        timer.start("build_graph")
    graph_host, meta = rbcd.build_graph(part, params.r, dtype, dev)
    if timer is not None:
        timer.stop("build_graph")
        timer.start("init")
    X0 = rbcd.initial_state_for(init, part, meta, graph_host, params, dtype)
    state_host0 = init_state(graph_host, meta, X0, params=params)
    if timer is not None:
        timer.stop("init", sync=obs.materialize(state_host0.X))
        timer.start("shard")
    state, graph = shard_problem(mesh, state_host0, graph_host)
    if timer is not None:
        timer.stop("shard")
        run.event("phase_timings", phase="setup", timings=timer.as_dict())

    if overlap == "auto" and mesh.member:
        overlap = _resolve_overlap_auto(mesh, state, graph, meta, params,
                                        exchange, graph_host)

    n_total = part.meas_global.num_poses
    num_meas = len(part.meas_global)
    certify_mode = getattr(params, "certify_mode", "off")
    edges_g = edge_set_from_measurements(part.meas_global, dtype=dtype,
                                         device=dev)

    def _attempt(mesh_a, state_a, graph_a, start_it, start_nwu,
                 boundary_cb, injector):
        """One driver entry on one mesh from an absolute round index; the
        supervisor loop re-enters here after a rewind, possibly on a
        smaller mesh."""
        size_a = mesh_a.size
        shifts, plan = _exchange_plan(mesh_a, meta, graph_host, exchange)
        sharded_seg = make_sharded_segment(mesh_a, meta, params, shifts,
                                           plan, overlap=overlap)
        if run is not None:
            from ..obs import devprof

            sharded_seg = devprof.profiled_program(
                run, sharded_seg, key=f"sharded/{size_a}/segment",
                label="sharded_segment", plane="sharded",
                static_names=("update_weights", "restart"),
                mesh_size=size_a)
        A_loc = num_robots // size_a
        offset = mesh_a.rank * A_loc
        if injector is not None:
            # Chaos seam: the injector counts dispatched rounds and may
            # poison a seeded public pose — an async device op.
            def seg(s, k, uw, rs):
                return sharded_seg(injector.before_dispatch(
                    s, k, offset=offset, num_robots=num_robots), graph_a, k,
                    update_weights=uw, restart=rs)
        else:
            def seg(s, k, uw, rs):
                return sharded_seg(s, graph_a, k, update_weights=uw,
                                   restart=rs)
        metrics_factory = lambda telemetry: make_sharded_metrics_body(
            mesh_a, graph_a, edges_g, n_total, num_meas, telemetry)
        if run is not None:
            bytes_round = comm_bytes_per_round(
                meta, size_a,
                shifts=shifts if exchange == "ppermute" else None,
                accel=params.acceleration,
                itemsize=torch.finfo(dtype).bits // 8,
                greedy=params.schedule.value == "greedy")
            run.event("sharded_solve", phase="setup", mesh_size=size_a,
                      mesh_axes=list(mesh_a.axis_names), exchange=exchange,
                      num_robots=num_robots,
                      agents_per_shard=num_robots // size_a,
                      comm_bytes_per_round=bytes_round,
                      overlap=overlap, verdict_every=verdict_every,
                      start_iteration=int(start_it))
            run.gauge("sharded_comm_bytes_per_round",
                      "modeled per-device interconnect bytes per round",
                      unit="bytes").set(bytes_round)
            # Mesh identity into the run fingerprint: solves on meshes of
            # different sizes are not comparable runs for the regression
            # gate.
            run.set_fingerprint(solver="solve_rbcd_sharded",
                                mesh_size=size_a, exchange=exchange)
        return rbcd.run_rbcd(
            state_a, graph_a, meta, seg, part, max_iters, grad_norm_tol,
            eval_every, dtype, params=params, verdict_every=verdict_every,
            metrics_body_factory=metrics_factory,
            start_iteration=start_it, start_num_weight_updates=start_nwu,
            boundary_cb=boundary_cb,
            assemble=_global_assembly(mesh_a, graph_a, n_total, num_meas))

    def _append_gn_tail(res, graph_a, mesh_a):
        """The GN-CG polish on the terminal iterate, on the weighted
        objective the solve minimized; the trajectory (and with a certify
        mode, the certificate) re-finalized from the polished iterate."""
        Xa, tail = _gn_tail_local(
            res.state.X, rbcd.with_weights(graph_a, res.state.weights),
            meta, mesh_a, gn_tail)
        if run is not None:
            run.event("gn_tail", phase="refine", sharded=True,
                      outer_iterations=tail.outer_iterations,
                      cg_iterations=tail.cg_iterations,
                      terminated_by=tail.terminated_by,
                      cost=tail.cost_history[-1]
                      if tail.cost_history else None,
                      grad_norm=tail.grad_norm_history[-1]
                      if tail.grad_norm_history else None)
        epilogue = rbcd.make_terminal_epilogue(
            graph_a, edges_g, n_total, num_meas, meta,
            certify_mode=certify_mode,
            assemble=_global_assembly(mesh_a, graph_a, n_total, num_meas))
        fin = epilogue(Xa, res.state.weights, {})
        certificate = res.certificate
        if certify_mode != "off":
            fin = rbcd._host_fetch(fin)
            certificate = rbcd._epilogue_certificate(fin, edges_g, params,
                                                     dtype)
        return dataclasses.replace(
            res, T=fin["T"], X=Xa, weights=fin["w_glob"],
            cost_history=res.cost_history + tail.cost_history,
            grad_norm_history=res.grad_norm_history
            + tail.grad_norm_history,
            terminated_by=tail.terminated_by if tail.converged
            else res.terminated_by,
            state=res.state._replace(X=Xa),
            certificate=certificate)

    if resilience is None:
        res = None
        if mesh.member:
            res = _attempt(mesh, state, graph, 0, 0, boundary_cb, None)
            if gn_tail is not None:
                res = _append_gn_tail(res, graph, mesh)
            res = _replicate(res, mesh)
        return _broadcast_result(res, mesh_size < world, dev)

    # -- the rewind supervisor (parallel.resilience) ------------------------
    cfg = resilience
    store = cfg.resolve_store(device=dev)
    sup = resilience_mod.CheckpointSupervisor(cfg, store, graph_host)
    injector = cfg.injector
    if injector is not None:
        injector.arm(graph_host)
    watchdog = resilience_mod.Watchdog(cfg.fetch_deadline_s) \
        if cfg.fetch_deadline_s is not None else None
    phase = ["sharded_verdict"]
    mesh_cur, state_cur, graph_cur = mesh, state, graph
    start_it = start_nwu = 0
    if boundary_cb is None:
        chained_cb = sup.boundary_cb
    else:
        def chained_cb(it, nwu, st, word, terminal, _ext=boundary_cb):
            # External hook first: the multihost lockstep must agree the
            # boundary is clean across processes before a checkpoint.
            _ext(it, nwu, st, word, terminal)
            sup.boundary_cb(it, nwu, st, word, terminal)

    def attach(m):
        sup.attach_mesh(m.size)
        sup.gather = lambda st, _m=m: gather_state(_m, st)
        sup.writer = m.rank == 0
        sup.barrier = m.barrier

    if resume and mesh_cur.member:
        restored = _resume_from_store(sup, mesh_cur, graph_host, meta,
                                      params, run)
        if restored is not None:
            state_cur, graph_cur, start_it, start_nwu = restored
    attach(mesh_cur)
    res = None
    shrunk = mesh_size < world
    try:
        with resilience_mod.fetch_guard(watchdog, injector, phase):
            while mesh_cur.member:
                try:
                    res = _attempt(mesh_cur, state_cur, graph_cur,
                                   start_it, start_nwu, chained_cb,
                                   injector)
                    break
                except (resilience_mod.AnomalyRewind,
                        resilience_mod.MeshFaultError) as e:
                    t0 = time.perf_counter()
                    if injector is not None:
                        # Unblock any simulated hang so abandoned
                        # watchdog workers can exit.
                        injector.release_hangs()
                    new_size, host_state, start_it, start_nwu = \
                        sup.recover(e, mesh_cur.size, num_robots)
                    if new_size != mesh_cur.size:
                        mesh_cur = make_mesh(new_size, device=dev)
                        shrunk = True
                    if host_state is None:
                        # Cold restart: back to the initial guess.
                        host_state = state_host0
                    else:
                        # Rebake the factors from the stored weights
                        # BEFORE sharding — the initial build's order, so
                        # a same-mesh resume is bitwise.
                        host_state = rbcd.refresh_problem(
                            _on_device(host_state, dev), graph_host, meta,
                            params)
                    state_cur, graph_cur = shard_problem(
                        mesh_cur, host_state, graph_host)
                    attach(mesh_cur)
                    sup.note_overhead(time.perf_counter() - t0)
            if res is not None:
                if gn_tail is not None:
                    phase[0] = "gn_tail"
                    res = _append_gn_tail(res, graph_cur, mesh_cur)
                res = _replicate(res, mesh_cur)
    finally:
        if injector is not None:
            injector.release_hangs()
        if watchdog is not None:
            watchdog.close()
    if res is not None:
        res = dataclasses.replace(
            res, recovered=res.recovered or sup.recoveries > 0,
            resilience=sup.finish(injector))
    return _broadcast_result(res, shrunk, dev)


def _broadcast_result(res, needed: bool, dev):
    """``res`` from the default group's rank 0 on every rank, when some
    ranks left the solve (or never were in its mesh); else as it is."""
    if not needed:
        return res
    box = [_result_to(res, "cpu") if res is not None else None]
    dist.broadcast_object_list(box, src=0)
    return res if res is not None else _result_to(box[0], dev)


def _result_to(res: "rbcd.RBCDResult", dev) -> "rbcd.RBCDResult":
    """``res`` with its tensors (trajectory, iterate, weights, state) on
    ``dev``."""
    return dataclasses.replace(
        res, **{f: rbcd._tree_map(lambda t: t.detach().to(dev),
                                  getattr(res, f))
                for f in ("T", "X", "weights", "state")})

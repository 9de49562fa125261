"""Re-centered terminal refinement: float64-grade gaps from float32 device
arithmetic — the PyTorch port of ``dpgo_tpu.models.refine``.

Float32 descent stalls at a gap floor: near the optimum the Riemannian
gradient is the small difference of large quantities, and f32 rounding of
the large terms drowns the descent direction.  Refinement holds the iterate
as ``X = R + D``:

* ``R``, a reference point kept in float64 on the host and refreshed every
  cycle (fold ``D`` in, project to the manifold, recompute the constants);
* ``D``, the small float32 correction, the only thing the device updates.

The large cancellations are computed once per cycle on the host in float64
and shipped as float32 constants (``RefineConstants``): the Riemannian
gradient ``g0`` and the edge residuals ``rho`` at R (both small near the
optimum), and ``S0 = sym(R_Y^T G_Y(R))`` and ``G_ref = G(R)``, which on the
device only multiply ``D``-sized quantities.  Every f32 rounding error then
scales with ``|D|``.

A round is the Jacobi RBCD round on ``D``: the exchange of ``D``, then one
re-centered RTR step per agent.  On a CUDA device that step is one launch
of the hand-written kernel ``ops.rtr_kernel.rtr_refine_full`` for all
agents (the "kernel" formulation); the "ell" formulation is the plain copy
of the JAX package's XLA path.  The multi-round functions are plain
Python loops of eager rounds with no host sync (the momentum's restart
flag stays on the device); a cycle reads ``D`` back once, and its
recenter reads the graph's index arrays.

The Gauss-Newton-CG tail (``GNTailConfig``, ``gn_tail``, host f64 on the
certificate operator; ``gn_precond_blocks`` for the sharded tail of
``parallel.sharded.gn_tail_sharded``; ``stall_handoff``) closes the file.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import AgentParams
from ..ops import manifold, quadratic, rtr_kernel, solver
from ..types import EdgeSet, edge_set_from_measurements
from . import rbcd

#: Refine rounds run (every formulation): on a CUDA device each one
#: launches the kernel once, so ``ops.rtr_kernel.REFINE_LAUNCHES`` keeps pace.
ROUNDS = 0


class RefineConstants(NamedTuple):
    """Per-recenter device constants (float32, leading [A] agent axis)."""

    R: torch.Tensor       # [A, n, r, k] reference point (local poses)
    Rz: torch.Tensor      # [A, s, r, k] reference neighbor buffer
    G_ref: torch.Tensor   # [A, n, r, k] Euclidean gradient at R
    g0: torch.Tensor      # [A, n, r, k] Riemannian gradient at R (from f64)
    S0: torch.Tensor      # [A, n, d, d] sym(R_Y^T G_Y(R))
    chol: torch.Tensor    # [A, n, k, k] block-Jacobi factors
    # The kernel's layouts (``ops.rtr_kernel.rtr_refine_full``): reference
    # residuals over the edge tiles, the weight tiles, and the pose
    # constants component-major.  ``recenter`` always builds them; None
    # only in constants carried over from a JAX graph without edge tiles.
    rho_rot_t: torch.Tensor | None = None  # [A, nt, r*d, T]
    rho_trn_t: torch.Tensor | None = None  # [A, nt, r, T]
    Rc: torch.Tensor | None = None         # [A, r*k, n]
    wk_t: torch.Tensor | None = None       # [A, nt, 1, T]
    wt_t: torch.Tensor | None = None       # [A, nt, 1, T]
    g0_c: torch.Tensor | None = None       # [A, r*k, n]
    Gref_c: torch.Tensor | None = None     # [A, r*k, n]
    S0_c: torch.Tensor | None = None       # [A, d*d, n]
    Lc: torch.Tensor | None = None         # [A, k*k, n] preconditioner factors
    # The graph's ELL incidence mask in float32 (the graph's own tensor
    # when it is float32 already); the JAX package has no such field.
    inc_mask_f: torch.Tensor | None = None  # [A, n, K]


class RefineRef(NamedTuple):
    """Host-side f64 reference state."""

    Xg: np.ndarray         # [N, r, k] global reference iterate (f64)
    f_ref: float           # global cost at Xg (f64)
    consts: RefineConstants


def _np(x) -> np.ndarray:
    """A host numpy array from a tensor (on any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Host-side f64 recentering (numpy)
# ---------------------------------------------------------------------------

def _np_edge_terms(Xbuf, ei, ej, R, t):
    """f64 numpy mirror of ``quadratic._edge_terms`` ([A] batched)."""
    a = np.arange(Xbuf.shape[0])[:, None]
    Xi = Xbuf[a, ei]
    Xj = Xbuf[a, ej]
    Yi, pi = Xi[..., :-1], Xi[..., -1]
    Yj, pj = Xj[..., :-1], Xj[..., -1]
    rR = Yj - Yi @ R
    rt = pj - pi - np.einsum("aerd,aed->aer", Yi, t)
    return rR, rt


def _np_egrad(Xbuf, edges_np, n_out):
    """f64 numpy mirror of ``quadratic.egrad_ell`` ([A] batched scatter)."""
    ei, ej = edges_np["i"], edges_np["j"]
    rR, rt = _np_edge_terms(Xbuf, ei, ej, edges_np["R"], edges_np["t"])
    w = edges_np["mask"] * edges_np["weight"]
    wk = (w * edges_np["kappa"])[..., None, None]
    wt = (w * edges_np["tau"])[..., None]
    gj = np.concatenate([wk * rR, (wt * rt)[..., None]], axis=-1)
    giY = -(wk * rR) @ np.swapaxes(edges_np["R"], -1, -2) \
        - (wt * rt)[..., None] * edges_np["t"][:, :, None, :]
    gi = np.concatenate([giY, -(wt * rt)[..., None]], axis=-1)
    A, _, r, k = gi.shape
    N = Xbuf.shape[1]
    out = np.zeros((A, N, r, k))
    a = np.arange(A)[:, None]
    np.add.at(out, (a, ei), gi)
    np.add.at(out, (a, ej), gj)
    return out[:, :n_out], rR, rt, w


def _np_sym(M):
    return 0.5 * (M + np.swapaxes(M, -1, -2))


def _np_chol_blocks(edges_np, n_max, d, shift):
    """Host block-Jacobi factors (numpy mirror of ``rbcd.precond_chol``)."""
    A, E = edges_np["kappa"].shape
    k = d + 1
    w = edges_np["mask"] * edges_np["weight"]
    wk = w * edges_np["kappa"]
    wt = w * edges_np["tau"]
    t = edges_np["t"]
    Bi = np.zeros((A, E, k, k))
    Bi[..., :d, :d] = wk[..., None, None] * np.eye(d) \
        + wt[..., None, None] * t[..., :, None] * t[..., None, :]
    Bi[..., :d, d] = wt[..., None] * t
    Bi[..., d, :d] = wt[..., None] * t
    Bi[..., d, d] = wt
    diag_j = np.concatenate([np.repeat(wk[..., None], d, -1),
                             wt[..., None]], axis=-1)
    Bj = diag_j[..., None] * np.eye(k)
    n_buf_blocks = np.zeros((A, n_max + 1, k, k))  # +1 catch-all for >=n
    a = np.arange(A)[:, None]
    np.add.at(n_buf_blocks, (a, np.minimum(edges_np["i"], n_max)), Bi)
    np.add.at(n_buf_blocks, (a, np.minimum(edges_np["j"], n_max)), Bj)
    blocks = n_buf_blocks[:, :n_max] + shift * np.eye(k)
    return np.linalg.cholesky(blocks)


def _np_project_manifold(Xg64: np.ndarray, d: int) -> np.ndarray:
    """f64 manifold projection (per-pose Stiefel polar via SVD, numpy).

    LAPACK's divide-and-conquer gesdd can fail to converge on rare
    near-degenerate blocks; the polar factor is also U(V^T) of the
    symmetric eigendecomposition of Y^T Y, which is the per-block
    fallback."""
    Y = Xg64[..., :d]
    try:
        U, _, Vh = np.linalg.svd(Y, full_matrices=False)
        return np.concatenate([U @ Vh, Xg64[..., d:]], axis=-1)
    except np.linalg.LinAlgError:
        pass
    out = Xg64.copy()
    for i in range(Y.shape[0]):
        try:
            U, _, Vh = np.linalg.svd(Y[i], full_matrices=False)
            out[i, :, :d] = U @ Vh
        except np.linalg.LinAlgError:
            # Polar via eigh of the (symmetric PSD) Gram — always converges.
            w, V = np.linalg.eigh(Y[i].T @ Y[i])
            inv_sqrt = V @ np.diag(1.0 / np.sqrt(np.maximum(w, 1e-300))) @ V.T
            out[i, :, :d] = Y[i] @ inv_sqrt
    return out


def recenter(Xg64: np.ndarray, graph, meta, params: AgentParams,
             edges_global, chol=None, weights=None,
             pre_projected: bool = False,
             f_ref: float | None = None) -> RefineRef:
    """Build the f64 reference and its device constants from a global
    iterate ``Xg64 [N, r, k]`` (projected to the manifold in f64 first
    unless ``pre_projected``); ``edges_global`` is the global EdgeSet
    (host or device tensors, or numpy) for ``f_ref``.

    ``chol`` ([A, n, k, k] on the graph's device) is reused when given: the
    factors depend only on the edge weights, so it must come from the SAME
    weights this call refines under.  ``weights [A, E]`` replaces
    ``graph.edges.weight`` (the final GNC weights of a robust solve);
    ``edges_global`` must then carry the matching per-measurement weights
    (``rbcd.global_weights``).  ``f_ref`` reuses a cost the caller just
    computed at the same point.

    The constants are computed in float64 on the host and shipped as
    float32 in one packed host-to-device copy onto the graph's device."""
    if weights is not None:
        graph = rbcd.with_weights(graph, weights)
    d = meta.d
    if not pre_projected:
        Xg64 = _np_project_manifold(Xg64, d)

    # Per-agent reference buffers (local + neighbor) from the global point.
    R_loc = Xg64[_np(graph.global_index)]                    # [A, n, r, k]
    pub = np.take_along_axis(
        R_loc, _np(graph.pub_idx)[:, :, None, None], axis=1)
    Rz = pub[_np(graph.nbr_robot), _np(graph.nbr_pub)]
    Rz = Rz * _np(graph.nbr_mask)[:, :, None, None]
    Rbuf = np.concatenate([R_loc, Rz], axis=1)

    e = graph.edges
    edges_np = {f: _np(getattr(e, f)).astype(np.float64)
                for f in ("R", "t", "kappa", "tau", "weight", "mask")}
    edges_np["i"], edges_np["j"] = _np(e.i), _np(e.j)

    G_ref, rrR, rrt, w = _np_egrad(Rbuf, edges_np, meta.n_max)
    RY = R_loc[..., :d]
    S0 = _np_sym(np.swapaxes(RY, -1, -2) @ G_ref[..., :d])
    g0 = G_ref.copy()
    g0[..., :d] -= RY @ S0

    if f_ref is None:
        f_ref = global_cost(Xg64, edges_global)

    fields = dict(R=R_loc, Rz=Rz, G_ref=G_ref, g0=g0, S0=S0)
    if chol is None:
        fields["chol"] = _np_chol_blocks(edges_np, meta.n_max, d,
                                         params.solver.precond_shift)

    # The kernel's layouts: reference residuals over the edge tiles, the
    # weight tiles (weights are fixed during refinement) and the pose
    # constants component-major.
    A, nt, _, T = graph.eidx_i.shape
    E = edges_np["kappa"].shape[1]
    r = rrR.shape[-2]
    pad = nt * T - E

    def tile_cm(arr, rows):  # [A, E, ...] -> [A, nt, rows, T]
        flat = arr.reshape(A, E, rows).transpose(0, 2, 1)
        flat = np.pad(flat, ((0, 0), (0, 0), (0, pad)))
        return flat.reshape(A, rows, nt, T).transpose(0, 2, 1, 3)

    def wtile(vals):  # [A, E] -> [A, nt, 1, T]
        return np.pad(vals, ((0, 0), (0, pad))).reshape(A, nt, 1, T)

    def cm(arr):  # [A, n, r, k] -> [A, r*k, n] component-major
        return arr.transpose(0, 2, 3, 1).reshape(A, -1, meta.n_max)

    fields.update(
        rho_rot_t=tile_cm(rrR, r * d),
        rho_trn_t=tile_cm(rrt, r),
        Rc=cm(R_loc),
        wk_t=wtile(w * edges_np["kappa"]),
        wt_t=wtile(w * edges_np["tau"]),
        g0_c=cm(g0),
        Gref_c=cm(G_ref),
        S0_c=S0.transpose(0, 2, 3, 1).reshape(A, d * d, meta.n_max),
    )
    layout = tuple((name, arr.shape) for name, arr in fields.items())
    packed = np.concatenate(
        [np.ascontiguousarray(arr, np.float32).ravel()
         for arr in fields.values()])
    dev = graph.global_index.device
    consts = _unpack_consts(torch.from_numpy(packed).to(dev), chol, layout)
    consts = consts._replace(
        inc_mask_f=graph.inc_mask.to(torch.float32).contiguous())
    return RefineRef(Xg=Xg64, f_ref=f_ref, consts=consts)


def _unpack_consts(packed: torch.Tensor, chol, layout) -> RefineConstants:
    """Slice the packed recenter buffer back into named constants (views
    of the one device buffer); derives the kernel's ``Lc`` from chol."""
    out = {}
    off = 0
    for name, shape in layout:
        size = math.prod(shape)
        out[name] = packed[off:off + size].view(shape)
        off += size
    chol = out.pop("chol") if chol is None else chol.to(torch.float32)
    A, n, k, _ = chol.shape
    out["Lc"] = chol.permute(0, 2, 3, 1).reshape(A, k * k, n).contiguous()
    return RefineConstants(chol=chol, **out)


def np_edges_batched(edges) -> dict:
    """The ``[1, ...]``-batched f64 edge dict ``_np_egrad``/
    ``_np_edge_terms`` consume, from any EdgeSet-like (tensors or
    arrays)."""
    e = {f: _np(getattr(edges, f)).astype(np.float64)[None]
         for f in ("R", "t", "kappa", "tau", "weight", "mask")}
    e["i"] = _np(edges.i)[None]
    e["j"] = _np(edges.j)[None]
    return e


def host_edges_f64(meas) -> EdgeSet:
    """A host-side float64 EdgeSet over global pose indices — the gap
    oracle's edge data."""
    return edge_set_from_measurements(meas, dtype=torch.float64,
                                      device="cpu")


def scatter_owned(Xg64: np.ndarray, D, graph) -> np.ndarray:
    """Add each owner's correction rows ``D [A, n, r, k]`` into a global f64
    iterate (reads ``D`` back to the host)."""
    Dg = np.zeros_like(Xg64)
    gi_np = _np(graph.global_index)
    mask = _np(graph.pose_mask) > 0
    Dnp = _np(D).astype(np.float64)
    Dg[gi_np[mask]] = Dnp[mask]
    return Xg64 + Dg


def global_x(ref: RefineRef, D, graph) -> np.ndarray:
    """Assemble the current global f64 iterate R + D (owners' D)."""
    return scatter_owned(ref.Xg, D, graph)


def global_cost(X64: np.ndarray, edges_global) -> float:
    """f64 global cost (host oracle for gap evaluation)."""
    eg = {f: _np(getattr(edges_global, f)).astype(np.float64)
          for f in ("R", "t", "kappa", "tau", "weight", "mask")}
    rR, rt = _np_edge_terms(X64[None], _np(edges_global.i)[None],
                            _np(edges_global.j)[None],
                            eg["R"][None], eg["t"][None])
    w = eg["mask"] * eg["weight"]
    return 0.5 * float(np.sum(
        w * (eg["kappa"] * np.sum(rR[0] ** 2, axis=(-2, -1))
             + eg["tau"] * np.sum(rt[0] ** 2, axis=-1))))


def central_gradnorm64(Xg64p: np.ndarray, e64, n_out: int,
                       d: int) -> float:
    """f64 centralized Riemannian gradient norm of a global iterate — the
    stationarity yardstick of ``polish`` (``e64`` from
    ``np_edges_batched``)."""
    G = _np_egrad(Xg64p[None], e64, n_out)[0][0]
    Y = Xg64p[..., :d]
    S1 = _np_sym(np.swapaxes(Y, -1, -2) @ G[..., :d])
    rg = G.copy()
    rg[..., :d] -= Y @ S1
    return float(np.sqrt((rg * rg).sum()))


# ---------------------------------------------------------------------------
# The device-side re-centered round
# ---------------------------------------------------------------------------

#: f(R + D) - f(R) from the correction buffer and the reference residuals.
_delta_cost = quadratic.delta_cost
#: D_new with R + D_new = polar(R + D + eta), by the polar-correction series.
_retract_d = manifold.retract_correction


def refine_kernel_operands(D, Dz, consts: RefineConstants, graph) -> tuple:
    """The positional operands of ``ops.rtr_kernel.rtr_refine_full`` for
    one round at the corrections ``D`` with neighbor slots ``Dz``."""
    if consts.Rc is None or consts.inc_mask_f is None:
        raise ValueError("the refine constants carry no kernel layouts: "
                         "build them with refine.recenter")
    return (graph.eidx_i, graph.eidx_j, graph.rot_t, graph.trn_t,
            consts.wk_t, consts.wt_t, consts.rho_rot_t, consts.rho_trn_t,
            consts.Rc, rtr_kernel.comp_major(D), rtr_kernel.comp_major(Dz),
            consts.g0_c, consts.Gref_c, consts.S0_c, consts.Lc,
            graph.inc_slot, consts.inc_mask_f, graph.n)


def _agent_refine(D, Dz, consts: RefineConstants, edges: EdgeSet, graph,
                  meta, params: AgentParams, kernel: bool):
    """The single-step re-centered RTR of every agent on the corrections
    ``D [A, n, r, k]`` with neighbor slots ``Dz``; returns the new
    corrections and the gradient norms at the start [A].

    ``kernel`` runs ``ops.rtr_kernel.rtr_refine_full`` (one launch for
    all agents); otherwise the plain formulation below computes the
    re-centered gradient over the ELL incidence, as the JAX package's XLA
    path does, and shares the attempt loop (``solver.refine_attempts``)."""
    if kernel:
        out = rtr_kernel.rtr_refine_full(
            *refine_kernel_operands(D, Dz, consts, graph),
            **rbcd.kernel_options(params, meta))
        return rtr_kernel.comp_minor(out.D, meta.rank, meta.d + 1), \
            out.stats[:, 4]
    R, Rz, G_ref, g0, S0, chol = consts[:6]
    inc_slot, inc_mask = graph.inc_slot, graph.inc_mask
    n_buf = D.shape[-3] + Dz.shape[-3]
    d = meta.d
    sp = params.solver
    Y = R + D

    # Re-centered Riemannian gradient:
    #   rgrad(Y) = g0 + dG - R S1 - D (S0 + S1),  (translation rows: + dG_t)
    #   S1 = sym(D_Y^T G_refY + Y_Y^T dG_Y).
    dG = quadratic.egrad_ell(torch.cat([D, Dz], dim=-3), edges, inc_slot,
                             inc_mask)
    DY = D[..., :d]
    S1 = manifold.sym(DY.transpose(-1, -2) @ G_ref[..., :d]
                      + Y[..., :d].transpose(-1, -2) @ dG[..., :d])
    S = S0 + S1  # curvature term at the expansion point Y
    g = g0 + dG
    g = manifold.join(g[..., :d] - R[..., :d] @ S1 - DY @ S, g[..., d])

    def pre(V):
        return manifold.tangent_project(Y, quadratic.precond_apply(chol, V))

    def hvp(V):
        HV = quadratic.hessvec_ell(V, edges, inc_slot, inc_mask, n_buf)
        HV = manifold.join(HV[..., :d] - V[..., :d] @ S, HV[..., d])
        return manifold.tangent_project(Y, HV)

    # Refinement steps live at the |D| scale: the trust region starts near
    # the preconditioned-gradient (Cauchy) scale.
    radius0 = torch.clamp(10.0 * manifold.norm(pre(g)),
                          max=sp.initial_radius)
    rhoR, rhot = quadratic._edge_terms(torch.cat([R, Rz], dim=-3), edges)
    out = solver.refine_attempts(
        Y, D, g, radius0, hvp, pre,
        lambda V: _delta_cost(torch.cat([V, Dz], dim=-3), rhoR, rhot, edges),
        lambda eta: _retract_d(D, eta, R), max_iters=sp.max_inner_iters,
        kappa=sp.tcg_kappa, theta=sp.tcg_theta,
        max_rejections=sp.max_rejections, grad_tol=sp.grad_norm_tol)
    return out.D, out.grad_norm


def refine_round(D, consts: RefineConstants, graph, meta,
                 params: AgentParams, active=None):
    """One re-centered round: exchange ``D``, solve each agent's correction
    with its neighbors fixed.  Returns ``(D_new, gradnorms)``.

    ``active [A] bool`` restricts the update to a subset of agents (colored
    Gauss-Seidel, ``refine_rounds_colored``); by default every agent moves
    (Jacobi)."""
    global ROUNDS
    ROUNDS += 1
    Dz = rbcd.neighbor_buffer(rbcd.public_table(D, graph), graph)
    # B2's rule for a float32 RTR round: the refine round always is one.
    kernel = rbcd._formulation(meta, params, graph, torch.float32, D.device,
                               rtr=True) == "kernel"
    D_new, gn = _agent_refine(D, Dz, consts, graph.edges, graph, meta,
                              params, kernel)
    if active is not None:
        D_new = torch.where(active[:, None, None, None], D_new, D)
    return D_new, gn


def refine_rounds(D, consts: RefineConstants, graph, meta,
                  params: AgentParams, num_rounds: int):
    """``num_rounds`` Jacobi re-centered rounds."""
    for _ in range(num_rounds):
        D = refine_round(D, consts, graph, meta, params)[0]
    return D


def refine_rounds_colored(D, consts: RefineConstants, graph, meta,
                          params: AgentParams, num_rounds: int):
    """Colored Gauss-Seidel re-centered rounds: round i updates only color
    class i mod the number of colors (``graph.color``), so adjacent blocks
    never move at once — for strongly coupled graphs where simultaneous
    (Jacobi) updates of the correction oscillate."""
    nc = max(meta.num_colors, 1)
    for i in range(num_rounds):
        D = refine_round(D, consts, graph, meta, params,
                         active=graph.color == (i % nc))[0]
    return D


def _retract_d0(U, R):
    """Map a raw correction U to a feasible one (R + D on the manifold): the
    zero-step polar correction."""
    return _retract_d(U, torch.zeros_like(U), R)


def _momentum_carry(D):
    return (D, D, torch.zeros((), dtype=D.dtype, device=D.device),
            torch.zeros((), dtype=torch.bool, device=D.device))


def _momentum_step(carry, consts: RefineConstants, base, A_eff: int):
    """One Nesterov step on the carry ``(D, V, gamma, restart)`` around the
    base operator ``base`` (a Jacobi round or a colored sweep).  The
    restart flag stays a device tensor: no host sync."""
    D, V, gamma, restart = carry
    # Collapse the aux sequence when last round's test fired.
    V = torch.where(restart, D, V)
    gamma = torch.where(restart, torch.zeros_like(gamma), gamma)
    gamma = (1.0 + torch.sqrt(1.0 + 4.0 * (A_eff * gamma) ** 2)) \
        / (2.0 * A_eff)
    alpha = 1.0 / (gamma * A_eff)
    Ynes = _retract_d0((1.0 - alpha) * D + alpha * V, consts.R)
    D_new = base(Ynes)
    V = _retract_d0(V + gamma * (D_new - Ynes), consts.R)
    # Adaptive restart on the actual step vs the momentum lead; >= 0, so a
    # zero step (every attempt rejected, or the early exit) restarts.
    restart = torch.sum((Ynes - D_new) * (D_new - D)) >= 0.0
    return D_new, V, gamma, restart


def accel_round_carry(carry, consts: RefineConstants, graph, meta,
                      params: AgentParams):
    """One accelerated re-centered round on the momentum carry
    ``(D, V, gamma, restart)`` (the RBCD acceleration, reference
    ``PGOAgent.cpp:1054-1091``, on the correction, with adaptive
    restart)."""
    return _momentum_step(
        carry, consts,
        lambda Y: refine_round(Y, consts, graph, meta, params)[0],
        meta.num_robots)


def accel_sweep_carry(carry, consts: RefineConstants, graph, meta,
                      params: AgentParams):
    """One accelerated FULL COLORED SWEEP on the momentum carry: the base
    operator is ``num_colors`` sequential color rounds, which update every
    block once, so the momentum recursion is the single-block one
    (A_eff = 1)."""
    nc = max(meta.num_colors, 1)
    return _momentum_step(
        carry, consts,
        lambda Y: refine_rounds_colored(Y, consts, graph, meta, params, nc),
        1)


def refine_rounds_accel(D, consts: RefineConstants, graph, meta,
                        params: AgentParams, num_rounds: int):
    """Nesterov-accelerated re-centered rounds with adaptive restart
    (O'Donoghue & Candes-style: collapse the momentum when
    ``<Y - D_new, D_new - D_prev> >= 0``); feasibility is kept by the
    polar-correction series, never by projecting R + D in f32."""
    carry = _momentum_carry(D)
    for _ in range(num_rounds):
        carry = accel_round_carry(carry, consts, graph, meta, params)
    return carry[0]


def refine_rounds_accel_chunked(D, consts: RefineConstants, graph, meta,
                                params: AgentParams, num_rounds: int,
                                chunk: int = 100):
    """``refine_rounds_accel``.  The JAX package splits the rounds into
    ``chunk``-round device programs with the carry preserved; eager rounds
    need no split, and ``chunk`` does not change the result."""
    del chunk
    return refine_rounds_accel(D, consts, graph, meta, params, num_rounds)


def refine_rounds_accel_colored_chunked(D, consts: RefineConstants, graph,
                                        meta, params: AgentParams,
                                        num_rounds: int, chunk: int = 100):
    """Accelerated colored sweeps; ``num_rounds`` counts color rounds, so
    the sweep count is ``num_rounds // num_colors`` (at least one).
    ``chunk`` does not change the result (see
    ``refine_rounds_accel_chunked``)."""
    del chunk
    nc = max(meta.num_colors, 1)
    carry = _momentum_carry(D)
    for _ in range(max(1, num_rounds // nc)):
        carry = accel_sweep_carry(carry, consts, graph, meta, params)
    return carry[0]


def _zeros_like_consts(consts: RefineConstants) -> torch.Tensor:
    return torch.zeros(consts.R.shape, dtype=torch.float32,
                       device=consts.R.device)


def polish(Xg64: np.ndarray, graph, meta, params: AgentParams, meas,
           cycles: int = 3, rounds_per_cycle: int = 200, chunk: int = 100,
           gn_tol: float = 0.0, colored: bool = True):
    """Drive the centralized f64 GRADNORM down with re-centered refine
    cycles — the stationarity polish before a certificate.  Returns
    ``(Xg64_polished, gn_history)`` with one f64 centralized gradient norm
    per cycle boundary; the best-gn iterate is returned.  ``colored``
    selects momentum over full colored sweeps when the graph has more than
    one color, plain Jacobi momentum otherwise."""
    edges_np = host_edges_f64(meas)
    e64 = np_edges_batched(edges_np)
    n_out = Xg64.shape[0]
    d = meta.d

    def gn64(Xp):
        return central_gradnorm64(Xp, e64, n_out, d)

    use_colored = colored and graph.color is not None \
        and meta.num_colors > 1
    chol = None
    best = None
    hist = []
    Xg64 = _np_project_manifold(np.asarray(Xg64, np.float64), d)
    for _ in range(cycles):
        if not np.isfinite(Xg64).all():
            # Divergence safeguard: revert to the best verified iterate
            # (or the entry iterate when the first cycle diverged), stop.
            if best is not None:
                Xg64 = best[1]
            break
        gn = gn64(Xg64)
        hist.append(gn)
        if best is None or gn < best[0]:
            best = (gn, Xg64)
        if gn_tol and gn < gn_tol:
            break
        ref = recenter(Xg64, graph, meta, params, edges_np, chol=chol,
                       pre_projected=True)
        chol = ref.consts.chol
        rounds = refine_rounds_accel_colored_chunked if use_colored \
            else refine_rounds_accel_chunked
        D = rounds(_zeros_like_consts(ref.consts), ref.consts, graph, meta,
                   params, rounds_per_cycle, chunk=chunk)
        Xg64 = _np_project_manifold(global_x(ref, D, graph), d)
    if np.isfinite(Xg64).all():
        gn = gn64(Xg64)
        hist.append(gn)
        if best is None or gn < best[0]:
            best = (gn, Xg64)
    if best is None:   # non-finite entry iterate (or cycles = 0 on one)
        raise ValueError("polish: entry iterate is non-finite")
    return best[1], hist


def solve_refine(Xg64: np.ndarray, graph, meta, params: AgentParams,
                 edges_global, f_opt: float, rel_gap: float = 1e-6,
                 rounds_per_cycle: int = 50, max_cycles: int = 12,
                 weights=None, accel: bool = True,
                 on_verify: Callable[[np.ndarray], None] | None = None):
    """Drive re-centered refinement until the f64 global gap reaches
    ``rel_gap`` (or ``max_cycles`` recenters).  Returns
    ``(X64, gap, cycles, history)``.

    ``weights [A, E]``: final GNC weights of the solve being refined (see
    ``recenter``); ``edges_global`` must carry the matching global weights.
    ``accel`` selects the adaptively restarted Nesterov rounds over plain
    Jacobi rounds.  ``history`` holds one ``(rel_gap, elapsed_s)`` per
    VERIFY pass, one at every cycle boundary; the best verified point is
    returned.  An accelerated cycle that worsens the verified gap (or goes
    non-finite) is reverted and refinement continues un-accelerated; when
    the last cycles contract too slowly to reach the target, it returns
    early.  ``on_verify``, when given, receives the projected f64 iterate
    of every finite verify pass, in the order of ``history``."""
    if weights is not None:
        graph = rbcd.with_weights(graph, weights)
    accel_on = accel
    history = []
    t0 = time.perf_counter()
    target = f_opt * (1.0 + rel_gap)
    chol = None
    best = None  # (gap, X64) — accelerated tails can overshoot slightly
    last_revert = -10  # cycle index of the most recent safeguard revert
    for cyc in range(max_cycles + 1):
        if not np.all(np.isfinite(Xg64)):
            if best is None:
                raise ValueError("initial iterate is non-finite")
            accel_on = False
            Xg64 = best[1]
            last_revert = cyc
            history.append((float("inf"), time.perf_counter() - t0))
            continue
        Xg64 = _np_project_manifold(Xg64, meta.d)
        f = global_cost(Xg64, edges_global)
        gap_now = f / f_opt - 1.0
        history.append((gap_now, time.perf_counter() - t0))
        if on_verify is not None:
            on_verify(Xg64)
        if best is not None and accel_on and \
                (not np.isfinite(gap_now)
                 or gap_now > best[0] + 1e-12 * max(1.0, abs(best[0]))):
            # Cycle-level safeguard: a worsened accelerated cycle is
            # reverted, and refinement continues un-accelerated.
            accel_on = False
            Xg64 = best[1]
            last_revert = cyc
            continue
        if best is None or gap_now < best[0]:
            best = (gap_now, Xg64)
        if f <= target or cyc == max_cycles:
            return best[1], best[0], cyc, history
        # Condition-limited early exit: the last two cycles together
        # contracted less than ~0.1 decades and several decades remain.
        # Skipped for 3 cycles after a revert.
        if cyc >= 2 and len(history) >= 3 and rel_gap > 0 \
                and cyc >= last_revert + 3:
            g2, g1, g0 = (history[-3][0], history[-2][0], history[-1][0])
            if np.isfinite(g2) and np.isfinite(g1) and np.isfinite(g0) \
                    and g0 > 30 * rel_gap:
                gained = math.log10(max(g2, 1e-300) / g0)
                need = math.log10(g0 / (rel_gap * 0.3))
                if gained < 0.1 and need > gained * (max_cycles - cyc):
                    return best[1], best[0], cyc, history
        ref = recenter(Xg64, graph, meta, params, edges_global, chol=chol,
                       pre_projected=True, f_ref=f)
        chol = ref.consts.chol  # weight-only: constant across recenters
        rounds_fn = refine_rounds_accel if accel_on else refine_rounds
        D = rounds_fn(_zeros_like_consts(ref.consts), ref.consts, graph,
                      meta, params, rounds_per_cycle)
        Xg64 = global_x(ref, D, graph)
    # Only reachable when the safeguard fired on the last verify pass.
    return best[1], best[0], max_cycles, history


# ---------------------------------------------------------------------------
# Gauss-Newton-CG tail
# ---------------------------------------------------------------------------
#
# The lifted PGO cost is quadratic in X, so its Riemannian Hessian at X is
# the certificate operator S = Q - Lambda (``certify.sparse_certificate``,
# host f64): one sparse matrix gives the exact gradient (X S, Lambda being
# the tangent-projection multiplier) and the exact Newton model.  A
# preconditioned CG solve of P (V S) = -grad on the tangent space and a
# backtracking projective retraction make one second-order step at O(E)
# memory — the polish that breaks the block-coordinate floor.


@dataclasses.dataclass(frozen=True)
class GNTailConfig:
    """Knobs of the Gauss-Newton-CG tail (``gn_tail``)."""

    max_outer: int = 20          # outer GN steps
    grad_norm_tol: float = 0.1   # stop below this centralized grad norm
    cg_max_iters: int = 400      # CG iterations per outer step
    cg_rtol: float = 0.05        # relative residual target per CG solve
    damping: float = 0.0         # Levenberg-style shift added to S
    precond_shift: float = 0.1   # block-Jacobi factorization shift
    step_shrink: float = 0.25    # backtracking factor
    max_backtracks: int = 8


@dataclasses.dataclass
class GNTailResult:
    X: np.ndarray                # [n, r, d+1] f64 polished iterate
    cost_history: list
    grad_norm_history: list      # per outer step, INCLUDING the final point
    outer_iterations: int
    cg_iterations: int
    converged: bool
    terminated_by: str           # grad_norm | max_outer | no_decrease


def _gn_diag_blocks(S, n: int, dh: int, shift: float) -> np.ndarray:
    """Per-pose (d+1)x(d+1) diagonal blocks of the sparse certificate
    operator plus a Tikhonov shift — the block-Jacobi preconditioner of
    the tail's CG (a vectorized COO filter and scatter-add)."""
    C = S.tocoo()
    m = (C.row // dh) == (C.col // dh)
    blocks = np.zeros((n, dh, dh))
    np.add.at(blocks, (C.row[m] // dh, C.row[m] % dh, C.col[m] % dh),
              C.data[m])
    blocks += shift * np.eye(dh)
    return blocks


def gn_precond_blocks(edges: EdgeSet, lam: torch.Tensor,
                      inc_slot: torch.Tensor, inc_mask: torch.Tensor,
                      d: int, shift: float) -> torch.Tensor:
    """Per-pose (d+1)x(d+1) diagonal blocks of ``S = Q - Lambda`` for a
    batch of agents — ``_gn_diag_blocks`` on the device, for the sharded
    tail.  ``edges`` is the per-agent EdgeSet ([A, E] fields,
    buffer-indexed) and ``inc_slot``/``inc_mask`` its ELL incidence of the
    local poses, so neighbor-slot endpoints drop out and a shared edge
    contributes one block per endpoint across the fleet.  ``lam [A, n, d,
    d]`` carries the per-pose dual blocks ``sym(Y^T (XQ)_Y)``."""
    blocks = quadratic.diag_blocks(edges, inc_slot, inc_mask)
    k = d + 1
    pad = torch.zeros(blocks.shape, dtype=blocks.dtype, device=blocks.device)
    pad[..., :d, :d] = lam
    eye = torch.eye(k, dtype=blocks.dtype, device=blocks.device)
    return (blocks - pad) + shift * eye


def _gn_tangent(X: np.ndarray, V: np.ndarray, d: int) -> np.ndarray:
    """Tangent projection at X (numpy twin of ``manifold.tangent_project``):
    rotation columns lose their Y sym(Y^T W) component, translations pass."""
    Y = X[..., :d]
    W = V[..., :d]
    YtW = np.einsum("nrd,nre->nde", Y, W)
    sym = 0.5 * (YtW + np.swapaxes(YtW, -1, -2))
    out = V.copy()
    out[..., :d] = W - np.einsum("nrd,nde->nre", Y, sym)
    return out


def gn_tail(X64: np.ndarray, edges_global,
            cfg: GNTailConfig | None = None, log=None) -> GNTailResult:
    """Preconditioned Gauss-Newton-CG polish of a lifted global iterate
    (host f64, scipy).  Opt-in: run it after the BCD/momentum stages
    stall (``stall_handoff``) when an absolute gradient-norm gate matters.

    Per outer step: assemble ``S = Q - Lambda(X)``
    (``certify.sparse_certificate``; the Riemannian gradient is ``X S``
    and the Hessian-vector product ``P(V S)``), solve the Newton system by
    block-Jacobi-preconditioned CG on the tangent space (negative-
    curvature guard for indefinite saddles), and take a backtracking
    projective retraction accepted only on true f64 cost decrease.  The
    reported gradient norm is the ``manifold.norm(rgrad)`` the
    ``run_rbcd`` gate reads."""
    from .certify import sparse_certificate

    cfg = cfg or GNTailConfig()
    X = np.asarray(X64, np.float64).copy()
    n, r, dh = X.shape
    d = dh - 1
    cost = global_cost(X, edges_global)
    cost_hist = [cost]
    gn_hist: list = []
    cg_total = 0
    terminated_by = "max_outer"
    outer_done = 0

    for outer in range(int(cfg.max_outer)):
        S = sparse_certificate(X, edges_global)
        Xf = X.transpose(1, 0, 2).reshape(r, n * dh)
        grad = (Xf @ S).reshape(r, n, dh).transpose(1, 0, 2)
        # X S is already tangent; re-project before measuring the gate.
        grad = _gn_tangent(X, grad, d)
        gn = float(np.sqrt(np.sum(grad * grad)))
        gn_hist.append(gn)
        if log is not None:
            log(f"  gn_tail outer {outer}: cost {cost:.9g} gn {gn:.4g}")
        if gn < cfg.grad_norm_tol:
            terminated_by = "grad_norm"
            break
        outer_done = outer + 1

        blocks = _gn_diag_blocks(S, n, dh, cfg.precond_shift)

        def A(V):
            Vf = V.transpose(1, 0, 2).reshape(r, n * dh)
            W = (Vf @ S).reshape(r, n, dh).transpose(1, 0, 2)
            if cfg.damping:
                W = W + cfg.damping * V
            return _gn_tangent(X, W, d)

        def Minv(V):
            W = np.linalg.solve(blocks, V.transpose(0, 2, 1))
            return _gn_tangent(X, W.transpose(0, 2, 1), d)

        # Preconditioned CG on the tangent space, Steihaug-style negative
        # curvature exit (the accumulated step, or steepest descent on the
        # very first iteration).
        b = -grad
        v = np.zeros_like(b)
        res = b.copy()
        z = Minv(res)
        p = z.copy()
        rz = float(np.sum(res * z))
        b_norm = float(np.sqrt(np.sum(b * b)))
        for k in range(int(cfg.cg_max_iters)):
            Ap = A(p)
            pAp = float(np.sum(p * Ap))
            cg_total += 1
            if pAp <= 0:
                if k == 0:
                    v = b.copy()  # gradient direction
                break
            alpha = rz / pAp
            v = v + alpha * p
            res = res - alpha * Ap
            if float(np.sqrt(np.sum(res * res))) <= cfg.cg_rtol * b_norm:
                break
            z = Minv(res)
            rz_new = float(np.sum(res * z))
            p = z + (rz_new / rz) * p
            rz = rz_new

        # Backtracking projective retraction on the true f64 cost.
        step = 1.0
        accepted = False
        for _ in range(int(cfg.max_backtracks)):
            Xc = _np_project_manifold(X + step * v, d)
            c_new = global_cost(Xc, edges_global)
            if np.isfinite(c_new) and c_new < cost:
                X, cost = Xc, c_new
                accepted = True
                break
            step *= cfg.step_shrink
        cost_hist.append(cost)
        if not accepted:
            terminated_by = "no_decrease"
            break
    else:
        # max_outer exhausted: measure the final point's gate value.
        S = sparse_certificate(X, edges_global)
        Xf = X.transpose(1, 0, 2).reshape(r, n * dh)
        grad = _gn_tangent(
            X, (Xf @ S).reshape(r, n, dh).transpose(1, 0, 2), d)
        gn_hist.append(float(np.sqrt(np.sum(grad * grad))))

    return GNTailResult(
        X=X, cost_history=cost_hist, grad_norm_history=gn_hist,
        outer_iterations=outer_done, cg_iterations=cg_total,
        converged=terminated_by == "grad_norm",
        terminated_by=terminated_by)


def stall_handoff(gn_history, window: int = 8, rtol: float = 1e-2,
                  grad_norm_tol: float = 0.1) -> bool:
    """The GN-tail trigger: True when the BCD gradient-norm trajectory has
    plateaued ABOVE the absolute gate — no relative improvement over the
    trailing ``window`` evals (the health layer's stall test on the
    gradient norm), so the driver hands the iterate to ``gn_tail`` when
    more BCD rounds stopped paying."""
    hist = [float(g) for g in gn_history]
    if len(hist) < window:
        return False
    if hist[-1] < grad_norm_tol:
        return False  # already through the gate — nothing to break
    first, last = hist[-window], hist[-1]
    if not (np.isfinite(first) and np.isfinite(last)):
        return False
    return first - last <= rtol * abs(first)

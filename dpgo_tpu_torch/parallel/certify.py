"""Distributed solution certification over the agent mesh — the port of
``dpgo_tpu.parallel.certify``.

``models.certify`` evaluates the dual certificate on the assembled global
solution.  Here the minimum eigenvalue of ``S = Q - Lambda`` is computed by
a distributed block LOBPCG over the same process-group mesh the RBCD
solver runs on, with no rank holding the global problem (the
certification half of "Distributed Certifiably Correct Pose-Graph
Optimization", T-RO 2021, which the reference never implemented):

* ``S``'s matvec shards like the RBCD gradient: each rank applies its
  agents' edge lists after a public-pose exchange of the probe block
  (``sharded._gather_exchange``, ``sharded.local_grad_rows``);
* the dual blocks ``Lambda_i = sym(Y_i^T (XQ)_i)`` are per-pose, from each
  agent's complete gradient rows;
* every global scalar (norms, p x p Gram and Rayleigh-Ritz matrices) is an
  all-reduce of local masked contractions; the small factorizations run
  replicated on every rank — on a card with the sync-free Jacobi
  ``ops.smallmat.eigh_small``, so it never reads the host inside the
  eigensolve.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs
from ..models import rbcd
from ..models.rbcd import MultiAgentGraph
from ..device import sync_free
from ..ops import manifold, smallmat
from .sharded import (Mesh, _gather_exchange, _local_block,  # noqa: F401
                      gather_state, local_grad_rows, make_mesh)


def _egrad_local(V, Vz, graph: MultiAgentGraph):
    """Complete local gradient rows of the global map ``V Q`` for every
    agent of this rank (``sharded.local_grad_rows``; linear, so it is also
    the ``Q`` matvec on probe blocks)."""
    return local_grad_rows(V, Vz, graph)


def _eigh(A: torch.Tensor):
    """Ascending eigenpairs of a small symmetric matrix: the sync-free
    Jacobi ``smallmat.eigh_small`` on a card, LAPACK on the CPU (where a
    host read costs nothing)."""
    if sync_free(A):
        return smallmat.eigh_small(A)
    return torch.linalg.eigh(A)


def _probe_draws(seed: int, rank: int, A_loc: int, n: int, dh: int,
                 num_probe: int, dtype, device):
    """THE seam of the sharded certificate's random draws on one rank: the
    power iteration's start ``v [A_loc, n, 1, d+1]``, LOBPCG's initial
    block ``V0`` and conjugate block ``P0`` (``[A_loc, n, num_probe,
    d+1]``), standard normal from a generator seeded by ``(seed, rank)``
    (the JAX package folds the mesh position into its key the same way).
    Tests replace it to feed the JAX package's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) << 16) + int(rank))
    shape = (A_loc, n, num_probe, dh)
    v = torch.randn((A_loc, n, 1, dh), generator=gen, dtype=dtype,
                    device=device)
    V0 = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    P0 = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return v, V0, P0


def _certificate_shard(X, graph: MultiAgentGraph, seed: int, *, mesh: Mesh,
                       num_probe: int, power_iters: int, sub_iters: int):
    """Distributed lambda_min(S) at the iterate ``X [A_loc, n, r, d+1]``
    (this rank's agents).  Returns ``(lambda_min, sigma, stat, direction
    [A_loc, n, d+1])``, the scalars the same on every rank."""
    A_loc, n, r, dh = X.shape
    d = dh - 1
    dtype = X.dtype
    mask = graph.pose_mask[..., None, None]  # [A, n, 1, 1]
    exchange = _gather_exchange(graph, mesh)

    def psum(v):
        return mesh.all_reduce(v)

    # Dual blocks from each agent's complete local gradient rows.
    G = _egrad_local(X, exchange(X), graph)
    lam = manifold.sym(X[..., :d].transpose(-1, -2) @ G[..., :d])

    def S(V):  # [A, n, p, dh] -> [A, n, p, dh]
        QV = _egrad_local(V, exchange(V), graph)
        LV = torch.cat([V[..., :-1] @ lam, torch.zeros_like(V[..., -1:])],
                       dim=-1)
        return (QV - LV) * mask

    def inner_block(U, W):  # local contribution to the [p, q] Gram
        return torch.einsum("anpd,anqd->pq", U * mask, W)

    v, V0, P0 = _probe_draws(seed, mesh.rank, A_loc, n, dh, num_probe,
                             dtype, X.device)

    # Spectral shift: power iteration on S for the dominant |lambda|.
    v = v * mask

    def power_body(v):
        w = S(v)
        nrm = torch.sqrt(psum(torch.sum(w * w)))
        return w / torch.clamp(nrm, min=1e-30)

    v = power_body(v)  # normalize the random start
    for _ in range(power_iters):
        v = power_body(v)
    lam_dom = psum(torch.sum(v * S(v)))
    sigma = 1.1 * torch.abs(lam_dom) + 1e-3

    # LOBPCG on (sigma I - S)/sigma: spectrum in [0, ~1], top eigenvalue
    # 1 - lambda_min(S)/sigma; the normalization keeps the Gram matrices
    # O(1) whatever the problem's scale.
    def Aop(V):
        return (V - S(V) / sigma) * mask

    eps = torch.finfo(dtype).eps

    def _svqb(V):
        # SVQB whitening of the all-reduced Gram, its spectrum clamped at
        # eps * lam_max: a rank-deficient block collapses onto the clamp
        # instead of producing NaN.
        gram = psum(inner_block(V, V))
        w, U = _eigh(0.5 * (gram + gram.T))
        w = torch.maximum(w, 100 * eps * w[-1] + 1e-30)
        C = U * torch.rsqrt(w)[None, :]
        return torch.einsum("xnpd,pq->xnqd", V, C)

    def ortho_block(V):
        # Two passes restore O(eps) orthogonality (CholeskyQR2's argument).
        return _svqb(_svqb(V))

    def rotate(V, C):  # apply a [p_in, p_out] coefficient matrix
        return torch.einsum("xnpd,pq->xnqd", V, C)

    p = num_probe
    # Warm start: near a stationary iterate the r rows of X^T nearly span
    # ker(S); seed min(p-1, r) probes with them, the last stays random.
    V0 = V0 * mask
    n_warm = min(p - 1, r)
    if n_warm > 0:
        V0 = torch.cat([X[:, :, :n_warm, :] * mask, V0[:, :, n_warm:, :]],
                       dim=2)
    V = ortho_block(V0)
    P = ortho_block(P0 * mask)

    def colnorm(U):
        # Unit columns keep the joint [V, R, P] Gram O(1)-conditioned.
        nrm = torch.sqrt(psum(torch.einsum("anpd,anpd->p", U * mask, U)))
        return U / torch.clamp(nrm, min=1e-30)[None, None, :, None]

    for _ in range(sub_iters):
        W = Aop(V)
        Hv = psum(inner_block(V, W))
        R = colnorm(W - rotate(V, Hv))   # block residual, unit columns
        Zb = ortho_block(torch.cat([V, R, P], dim=2))
        Hz = psum(inner_block(Zb, Aop(Zb)))
        Hz = 0.5 * (Hz + Hz.T)
        _, C = _eigh(Hz)   # ascending
        Ctop = C[:, -p:]
        V_new = ortho_block(rotate(Zb, Ctop))
        # Conjugate block: the R/P components of the new Ritz vectors.
        Ctail = torch.cat([torch.zeros_like(Ctop[:p]), Ctop[p:]], dim=0)
        P = ortho_block(rotate(Zb, Ctail))
        V = V_new

    # Final Rayleigh-Ritz on the converged block.
    H = psum(inner_block(V, Aop(V)))
    H = 0.5 * (H + H.T)
    theta, Q = _eigh(H)    # ascending
    lam_min = sigma * (1.0 - theta[-1])  # Aop spectrum is lambda/sigma
    direction = torch.einsum("xnpd,p->xnd", V, Q[:, -1])

    # Stationarity residual ||X S|| (X's r rows ride as probe rows).
    XS = S(X)
    stat = torch.sqrt(psum(torch.sum(XS * XS)))
    return lam_min, sigma, stat, direction


def make_sharded_certificate(mesh: Mesh, num_probe: int = 4,
                             power_iters: int = 50, sub_iters: int = 100):
    """The distributed certificate on ``mesh``: ``cert(X, graph, seed)``
    computes lambda_min(S) (plus shift, stationarity residual and the
    minimal eigendirection) for this rank's block of an agent-sharded
    iterate."""

    def cert(X, graph: MultiAgentGraph, seed: int):
        return _certificate_shard(X, graph, seed, mesh=mesh,
                                  num_probe=num_probe,
                                  power_iters=power_iters,
                                  sub_iters=sub_iters)

    return cert


def certify_sharded(X, graph: MultiAgentGraph, mesh: Mesh | None = None,
                    eta: float = 1e-5, seed: int = 0, num_probe: int = 4,
                    power_iters: int = 50, sub_iters: int = 100,
                    weights=None, global_ctx=None, device="cuda"):
    """Distributed dual certificate of an agent-partitioned iterate.

    ``X [A, n_max, r, d+1]``, ``graph`` and ``weights [A, E]`` hold every
    agent; each rank certifies over its block of them (default mesh:
    ``make_mesh(device=device)``).
    Returns a ``models.certify.CertificateResult`` whose ``direction`` is
    the per-agent ``[A, n_max, d+1]`` eigendirection of every agent (the
    same on every rank).

    ``global_ctx = (Xg64 [N, r, d+1], edges_global)``: when the eigensolve's
    dtype error cannot resolve the weight-scale tolerance, the minimum
    eigenvalue is re-verified on the host in f64 from this global
    assembly; without it such a certificate is refused rather than
    over-claimed.  ``weights [A, E]`` replaces ``graph.edges.weight`` —
    the final GNC weights when certifying a robust solve."""
    from ..models.certify import (CertificateResult, _tally_cert,
                                  _timed_f64, decide_certificate,
                                  lambda_min_f64, weight_scale)

    mesh = mesh or make_mesh(device=device)
    num_robots = int(graph.n.shape[0])
    graph = _local_block(mesh, graph, num_robots)
    if weights is not None:
        graph = rbcd.with_weights(graph, _local_block(
            mesh, torch.as_tensor(weights), num_robots))
    X = _local_block(mesh, torch.as_tensor(X), num_robots)
    cert = make_sharded_certificate(mesh, num_probe=num_probe,
                                    power_iters=power_iters,
                                    sub_iters=sub_iters)
    lam_min, sigma, stat, direction = cert(X, graph, seed)
    lam_min_f = float(lam_min)
    sigma_f = float(sigma)
    # Weight-scale tolerance: the per-agent edge table holds each cross
    # edge in both endpoint agents, which leaves the median unchanged.
    full = _full_edges(mesh, graph)
    wscale = weight_scale(full[0])
    tol = eta * wscale
    direction = mesh.all_gather(direction) if mesh.size > 1 else direction

    def f64_solve(t):
        # Host f64 verification on the GLOBAL operator (caller-supplied).
        Xg64, edges_global = global_ctx
        e_full, meas_id, gidx, pmask = full
        if weights is not None:
            # The certificate is of the WEIGHTED objective: fold the
            # per-agent weights back to global measurement ids.
            mid = meas_id.ravel()
            msk = e_full.mask.cpu().numpy().ravel() > 0
            w_glob = np.ones(int(mid.max()) + 1)
            w_glob[mid[msk]] = e_full.weight.cpu().numpy().ravel()[msk]
            w0 = edges_global.weight
            w0 = w0.cpu().numpy() if isinstance(w0, torch.Tensor) \
                else np.asarray(w0)
            edges_g = edges_global._replace(weight=torch.as_tensor(
                w0 * w_glob))
        else:
            edges_g = edges_global
        dirn = direction.detach().cpu().numpy().astype(np.float64)
        Xg = Xg64.cpu().numpy() if isinstance(Xg64, torch.Tensor) \
            else np.asarray(Xg64, np.float64)
        warm = np.zeros((Xg.shape[0], Xg.shape[2]))
        warm[gidx[pmask]] = dirn[pmask]
        lam64, v64, resid = lambda_min_f64(Xg, edges_g, warm=warm, tol=t,
                                           tol_cert=tol)
        vec_pa = None
        if v64 is not None:
            vec_pa = np.zeros(dirn.shape, np.float64)
            vec_pa[pmask] = np.asarray(v64, np.float64)[gidx[pmask]]
        return lam64, vec_pa, resid

    run = obs.get_run()
    f64_secs: list = []
    chosen_f64 = f64_solve if global_ctx is not None else None
    if run is not None and chosen_f64 is not None:
        chosen_f64 = _timed_f64(chosen_f64, f64_secs)
    certified, decidable, _, lam_f64, vec64 = decide_certificate(
        lam_min_f, sigma_f, tol, float(torch.finfo(X.dtype).eps),
        chosen_f64)
    if vec64 is not None:
        direction = torch.as_tensor(vec64, dtype=direction.dtype,
                                    device=direction.device)
    if run is not None:
        lam_used = lam_f64 if lam_f64 is not None else lam_min_f
        _tally_cert(run, certified, decidable, f64_secs,
                    source="certify_sharded")
        run.event("certificate", phase="certify", sharded=True,
                  certified=certified, decidable=decidable,
                  lambda_min=lam_min_f, lambda_min_f64=lam_f64,
                  eigenvalue_gap=lam_used + tol, tol=tol, sigma=sigma_f,
                  f64_fallback_s=sum(f64_secs) if f64_secs else None,
                  stationarity_gap=float(stat))
        from ..obs.health import monitor_for

        monitor_for(run).observe_certificate(
            certified=certified, decidable=decidable, lambda_min=lam_used,
            source="certify_sharded")
    return CertificateResult(
        certified=certified, lambda_min=lam_min_f, direction=direction,
        stationarity_gap=float(stat), sigma=sigma_f, tol=tol,
        weight_scale=wscale, decidable=decidable, lambda_min_f64=lam_f64)


def _full_edges(mesh: Mesh, graph: MultiAgentGraph):
    """Every agent's edge rows on the host: ``(EdgeSet [A, E], meas_id,
    global_index, pose_mask > 0)`` as numpy where indexed."""
    def g(t):
        return mesh.all_gather(t) if mesh.size > 1 else t

    e = graph.edges._replace(weight=g(graph.edges.weight),
                             mask=g(graph.edges.mask),
                             kappa=g(graph.edges.kappa),
                             tau=g(graph.edges.tau))
    return (e, g(graph.meas_id).cpu().numpy(),
            g(graph.global_index).cpu().numpy(),
            g(graph.pose_mask).cpu().numpy() > 0)


def solve_staircase_sharded(meas, num_robots: int, mesh: Mesh | None = None,
                            r_min: int | None = None, r_max: int = 10,
                            rounds_per_rank: int = 300,
                            grad_norm_tol: float = 1e-8,
                            eta: float = 1e-5, dtype=None, X0=None,
                            accel: bool = False,
                            restart_interval: int = 100,
                            verbose: bool = False, device="cuda"):
    """Distributed certifiably correct PGO on the mesh: the sharded RBCD
    solve, the distributed certificate, and on failure the saddle escape
    to rank r+1 applied per agent (the lift ``X+ = [[X], [alpha v^T]]`` is
    per pose; only the backtracking sweep consults the global cost).
    ``models.certify.solve_staircase`` is the centralized counterpart.

    Returns ``(T, X_agents, rank, CertificateResult, history)`` with ``T``
    the rounded global trajectory, ``X_agents`` every agent's iterate and
    ``history`` per-rank tuples ``(rank, cost_f64, lambda_min,
    wall_seconds)``."""
    from ..config import AgentParams, SolverParams
    from ..device import default_dtype
    from ..models import refine
    from ..models.certify import _recover_rounding_basis
    from ..models.local_pgo import round_solution
    from ..types import edge_set_from_measurements
    from ..utils.partition import partition_contiguous
    from .sharded import make_sharded_multi_step, shard_problem

    mesh = mesh or make_mesh(device=device)
    dev = mesh.device
    d = meas.d
    r_min = d + 1 if r_min is None else r_min
    dtype = dtype or default_dtype(dev)
    part = partition_contiguous(meas, num_robots)
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=torch.float64, device="cpu")
    n_total = part.meas_global.num_poses

    def to_global(Xa_full, graph):
        # On the host in float64, wherever the agents' iterate lives.
        return rbcd.gather_to_global(
            torch.as_tensor(Xa_full).to("cpu", torch.float64),
            rbcd._tree_map(lambda t: t.cpu(), graph), n_total).numpy()

    Xa = None if X0 is None else torch.as_tensor(X0)
    history = []
    for r in range(r_min, r_max + 1):
        t_rank = time.perf_counter()
        params = AgentParams(
            d=d, r=r, num_robots=num_robots, rel_change_tol=0.0,
            acceleration=accel, restart_interval=restart_interval,
            solver=SolverParams(grad_norm_tol=grad_norm_tol,
                                max_inner_iters=10))
        graph, meta = rbcd.build_graph(part, r, dtype, dev)
        if Xa is None:
            Xa = rbcd.centralized_chordal_init(part, meta, graph, dtype)
        state = rbcd.init_state(graph, meta, Xa.to(dev, dtype),
                                params=params)
        state, graph_s = shard_problem(mesh, state, graph)
        steps = make_sharded_multi_step(mesh, meta, params)
        left = rounds_per_rank
        while left > 0:
            k = min(100, left)
            state = steps(state, graph_s, k)
            left -= k
        Xa = gather_state(mesh, state).X
        # One readback per staircase rank.
        Xg = to_global(Xa, graph)
        # Stationarity polish before certifying an f32 solve: lambda_min
        # at a non-stationary X carries a -O(||rgrad||) term.
        if dtype == torch.float32:
            Xg, gn_hist = refine.polish(Xg, graph, meta, params,
                                        part.meas_global, cycles=3,
                                        rounds_per_cycle=200)
            Xa = rbcd.scatter_to_agents(torch.as_tensor(Xg, dtype=dtype,
                                                        device=dev), graph)
            if verbose:
                print(f"[staircase-sharded] rank {r}: polish gn "
                      f"{gn_hist[0]:.2e} -> {gn_hist[-1]:.2e}")
        f = refine.global_cost(Xg, edges_g)
        cert = certify_sharded(Xa, graph, mesh=mesh, eta=eta, seed=r,
                               global_ctx=(Xg, edges_g))
        history.append((r, f, cert.lambda_min,
                        round(time.perf_counter() - t_rank, 2)))
        if verbose:
            print(f"[staircase-sharded] rank {r}: cost {f:.6f}, "
                  f"lambda_min {cert.lambda_min:.3e}, "
                  f"certified={cert.certified}")
        if cert.certified or r == r_max:
            X64 = torch.as_tensor(Xg)
            T = round_solution(X64, _recover_rounding_basis(X64, d))
            return T, Xa, r, cert, history

        # Saddle escape per agent: append the negative-curvature row, the
        # direction normalized to unit max per-pose row norm, and take the
        # best alpha of a geometric sweep on the global cost.
        v = cert.direction.detach().cpu().numpy().astype(np.float64)
        v = v / max(np.sqrt((v * v).sum(-1).max()), 1e-30)
        Xa_np = Xa.detach().cpu().numpy().astype(np.float64)

        def lifted(alpha):
            Xp = np.concatenate([Xa_np, alpha * v[:, :, None, :]], axis=2)
            return manifold.project(torch.as_tensor(Xp))

        best_alpha, best_f = 0.0, f
        for p in range(22):
            alpha = 2.0 ** (-p)                           # 1.0 ... ~2.4e-7
            f_p = refine.global_cost(to_global(lifted(alpha), graph),
                                     edges_g)
            if f_p < best_f:
                best_alpha, best_f = alpha, f_p
        Xa = lifted(best_alpha)
    raise AssertionError("unreachable")

"""Chordal and odometry initialization (port of ``dpgo_tpu.ops.chordal``;
reference ``chordalInitialization`` / ``recoverTranslations`` /
``odometryInitialization``, ``DPGO_utils.cpp:377-476``).

Both least-squares stages are Jacobi-preconditioned conjugate gradients on
the normal equations with the graph operators applied edge-wise.  The CG is
written out: it is the loop of ``jax.scipy.sparse.linalg.cg`` (zero start,
stop when ``||r||^2 <= tol^2 ||b||^2`` or at ``maxiter``), so both packages
stop at the same iteration for the same data.
"""

from __future__ import annotations

import torch

from ..types import EdgeSet
from ..utils.lie import project_to_rotation
from .quadratic import ell_sum, incidence


def _pin0(x: torch.Tensor) -> torch.Tensor:
    """Zero the slot-0 block (the anchored pose)."""
    x = x.clone()
    x[0] = 0.0
    return x


def _cg(matvec, b, precond, maxiter: int, tol: float) -> torch.Tensor:
    bs = torch.sum(b * b)
    atol2 = tol * tol * bs
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    gamma = torch.sum(r * z)
    k = 0
    while k < maxiter and bool(torch.sum(r * r) > atol2):
        Ap = matvec(p)
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        gamma_n = torch.sum(r * z)
        p = z + (gamma_n / gamma) * p
        gamma = gamma_n
        k += 1
    return x


def _adjoint_incidence(edges: EdgeSet, n: int):
    """The incidence of the edge-to-pose adjoints: terms ``[j-side |
    i-side]`` into the endpoints ``[edges.j | edges.i]``, built once per
    stage."""
    return incidence(n, torch.cat([edges.j, edges.i]))


def chordal_rotations(edges: EdgeSet, n: int, maxiter: int = 2000,
                      tol: float = 1e-10) -> torch.Tensor:
    """Chordal rotation relaxation with R_0 = I pinned, projected to SO(d):
    [n, d, d]."""
    d = edges.d
    dtype, dev = edges.R.dtype, edges.R.device
    wk = edges.mask * edges.weight * edges.kappa

    inc = _adjoint_incidence(edges, n)

    def residual_op(Rs):
        return Rs[edges.j] - Rs[edges.i] @ edges.R

    def residual_adjoint(res):
        wres = wk[:, None, None] * res
        return ell_sum(torch.cat(
            [wres, -(wres @ edges.R.transpose(-1, -2))]), *inc)

    def H(Rs):
        return _pin0(residual_adjoint(residual_op(_pin0(Rs))))

    R_fixed = torch.zeros((n, d, d), dtype=dtype, device=dev)
    R_fixed[0] = torch.eye(d, dtype=dtype, device=dev)
    b = _pin0(-residual_adjoint(residual_op(R_fixed)))
    deg = torch.clamp(ell_sum(torch.cat([wk, wk]), *inc), min=1e-12)
    sol = _cg(H, b, lambda Rs: _pin0(Rs / deg[:, None, None]), maxiter, tol)
    sol[0] = torch.eye(d, dtype=dtype, device=dev)
    return project_to_rotation(sol)


def recover_translations(edges: EdgeSet, Rs: torch.Tensor, n: int,
                         maxiter: int = 2000,
                         tol: float = 1e-10) -> torch.Tensor:
    """Least-squares translations given rotations, t_0 = 0: [n, d]."""
    wt = edges.mask * edges.weight * edges.tau
    inc = _adjoint_incidence(edges, n)

    def residual_adjoint(res):
        wres = wt[:, None] * res
        return ell_sum(torch.cat([wres, -wres]), *inc)

    def H(ts):
        ts = _pin0(ts)
        return _pin0(residual_adjoint(ts[edges.j] - ts[edges.i]))

    offs = (Rs[edges.i] @ edges.t[:, :, None])[..., 0]
    b = _pin0(residual_adjoint(offs))
    deg = torch.clamp(ell_sum(torch.cat([wt, wt]), *inc), min=1e-12)
    return _cg(H, b, lambda ts: _pin0(ts / deg[:, None]), maxiter, tol)


def chordal_initialization(edges: EdgeSet, n: int, maxiter: int = 2000,
                           tol: float = 1e-10) -> torch.Tensor:
    """Full chordal init: T [n, d, d+1] = [R_i | t_i] per pose."""
    Rs = chordal_rotations(edges, n, maxiter, tol)
    ts = recover_translations(edges, Rs, n, maxiter, tol)
    return torch.cat([Rs, ts[..., None]], dim=-1)


def odometry_from_edges(edges: EdgeSet, n: int) -> torch.Tensor:
    """Select the odometry chain (k -> k+1) out of an arbitrary edge set and
    chain-propagate it; returns T [n, d, d+1].

    Among candidate edges with ``j == i + 1`` an edge flagged as odometry
    (``is_lc == 0``) wins over a consecutive loop closure, ties broken by
    edge order (a scatter-min of priorities, which repeats on every
    device).  A pose with no incoming odometry edge gets an identity step.
    """
    E = edges.i.shape[0]
    d = edges.d
    dtype, dev = edges.R.dtype, edges.R.device
    cand = (edges.j == edges.i + 1) & (edges.mask > 0) & (edges.i < n - 1)
    big = 2 * E + 1
    # priority = is_lc * E + edge_index: odometry-flagged first, then stable.
    prio = (edges.is_lc > 0).long() * E + torch.arange(E, device=dev)
    prio = torch.where(cand, prio, big)
    i_safe = torch.where(cand, edges.i, 0)
    best = torch.full((n - 1,), big, dtype=torch.long, device=dev)
    best = best.scatter_reduce(0, i_safe, prio, "amin")
    valid = best < big
    idx = torch.where(valid, best % max(E, 1), 0)
    eye = torch.eye(d, dtype=dtype, device=dev)
    R_odo = torch.where(valid[:, None, None], edges.R[idx], eye)
    t_odo = torch.where(valid[:, None], edges.t[idx], 0.0)
    return odometry_initialization(R_odo, t_odo)


def _compose(a, b):
    """SE(d) composition of (Ra, ta) then the relative (Rb, tb)."""
    Ra, ta = a
    Rb, tb = b
    return Ra @ Rb, ta + (Ra @ tb[..., None])[..., 0]


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` at the even positions, ``b`` at the odd ones."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + a.shape[1:])
    out[0::2] = a
    out[1::2] = b
    return out


def _scan(elems):
    """Inclusive scan of ``_compose`` over the leading axis with the
    recursion of ``jax.lax.associative_scan`` (pairs combined, the half
    scanned, the even positions filled in): log-depth, a few batched
    launches per level, and the association order of the JAX package."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = _compose([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _scan(reduced)
    if n % 2 == 0:
        even = _compose([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = _compose(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def odometry_initialization(R_odo: torch.Tensor,
                            t_odo: torch.Tensor) -> torch.Tensor:
    """Chain-propagate odometry; returns T [n, d, d+1], pose 0 = identity.
    ``R_odo [n-1, d, d]``, ``t_odo [n-1, d]`` are the measurements
    k -> k+1 (reference ``odometryInitialization``,
    ``DPGO_utils.cpp:426-447``), as a log-depth scan of SE(d)
    compositions instead of a sequential chain."""
    d = R_odo.shape[-1]
    eye = torch.eye(d, dtype=R_odo.dtype, device=R_odo.device)[None]
    Rs = torch.cat([eye, R_odo])
    ts = torch.cat([t_odo.new_zeros((1, d)), t_odo])
    R_acc, t_acc = _scan([Rs, ts])
    return torch.cat([R_acc, t_acc[..., None]], dim=-1)

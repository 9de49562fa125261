"""Chordal initialization (port of ``dpgo_tpu.ops.chordal``; reference
``chordalInitialization`` / ``recoverTranslations``,
``DPGO_utils.cpp:377-476``).

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
from .quadratic import scatter_add


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


def chordal_rotations(edges: EdgeSet, n: int, maxiter: int = 2000,
                      tol: float = 1e-10) -> torch.Tensor:
    """Chordal rotation relaxation with R_0 = I pinned, projected to SO(d):
    [n, d, d]."""
    d = edges.d
    dtype, dev = edges.R.dtype, edges.R.device
    wk = edges.mask * edges.weight * edges.kappa

    def residual_op(Rs):
        return Rs[edges.j] - Rs[edges.i] @ edges.R

    def residual_adjoint(res):
        wres = wk[:, None, None] * res
        return scatter_add(n, edges.j, wres) + \
            scatter_add(n, edges.i, -(wres @ edges.R.transpose(-1, -2)))

    def H(Rs):
        return _pin0(residual_adjoint(residual_op(_pin0(Rs))))

    R_fixed = torch.zeros((n, d, d), dtype=dtype, device=dev)
    R_fixed[0] = torch.eye(d, dtype=dtype, device=dev)
    b = _pin0(-residual_adjoint(residual_op(R_fixed)))
    deg = scatter_add(n, edges.i, wk) + scatter_add(n, edges.j, wk)
    deg = torch.clamp(deg, min=1e-12)
    sol = _cg(H, b, lambda Rs: _pin0(Rs / deg[:, None, None]), maxiter, tol)
    sol[0] = torch.eye(d, dtype=dtype, device=dev)
    return project_to_rotation(sol)


def recover_translations(edges: EdgeSet, Rs: torch.Tensor, n: int,
                         maxiter: int = 2000,
                         tol: float = 1e-10) -> torch.Tensor:
    """Least-squares translations given rotations, t_0 = 0: [n, d]."""
    wt = edges.mask * edges.weight * edges.tau

    def residual_adjoint(res):
        wres = wt[:, None] * res
        return scatter_add(n, edges.j, wres) + scatter_add(n, edges.i, -wres)

    def H(ts):
        ts = _pin0(ts)
        return _pin0(residual_adjoint(ts[edges.j] - ts[edges.i]))

    offs = (Rs[edges.i] @ edges.t[:, :, None])[..., 0]
    b = _pin0(residual_adjoint(offs))
    deg = scatter_add(n, edges.i, wt) + scatter_add(n, edges.j, wt)
    deg = torch.clamp(deg, min=1e-12)
    return _cg(H, b, lambda ts: _pin0(ts / deg[:, None]), maxiter, tol)


def chordal_initialization(edges: EdgeSet, n: int, maxiter: int = 2000,
                           tol: float = 1e-10) -> torch.Tensor:
    """Full chordal init: T [n, d, d+1] = [R_i | t_i] per pose."""
    Rs = chordal_rotations(edges, n, maxiter, tol)
    ts = recover_translations(edges, Rs, n, maxiter, tol)
    return torch.cat([Rs, ts[..., None]], dim=-1)

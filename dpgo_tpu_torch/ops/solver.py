"""Riemannian trust-region step with Steihaug truncated CG, batched over
agents (port of ``dpgo_tpu.ops.solver``).

The JAX package vmaps a ``lax.while_loop`` over agents; here the agent axis
is a leading batch dimension and each loop runs in Python until no batch
element is active, updating only the active elements — the same values the
vmapped loop produces.  With no batch dimension the loops are the plain
single-problem ones.  This is the plain ("ell") formulation of the local
solve and the reference for the arithmetic of the CUDA kernel
(``ops.rtr_kernel``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import SolverParams
from . import manifold


class Problem(NamedTuple):
    """cost(X) -> [...]; egrad(X) -> ambient gradient; ehess(X, V) ->
    ambient Hessian-vector product; precond(X, V) -> preconditioned V."""

    cost: Callable
    egrad: Callable
    ehess: Callable
    precond: Callable


class TCGResult(NamedTuple):
    eta: torch.Tensor
    heta: torch.Tensor
    iters: torch.Tensor
    hit_boundary: torch.Tensor


def _sel(cond: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """``where(cond, new, old)`` with ``cond`` over the leading batch axes."""
    c = cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim()))
    return torch.where(c, new, old)


def truncated_cg(X, grad, hvp, precond, radius, max_iters: int,
                 kappa: float = 0.1, theta: float = 1.0) -> TCGResult:
    """Preconditioned Steihaug-Toint truncated CG on the tangent space at X:
    ``min <grad, eta> + 0.5 <eta, H eta>`` s.t. ``||eta|| <= radius``."""
    dtype = grad.dtype
    eps = torch.tensor(1e-30, dtype=dtype, device=grad.device)
    radius = torch.as_tensor(radius, dtype=dtype, device=grad.device)

    r = grad
    z = precond(r)
    delta = -z
    rz = manifold.inner(r, z)
    r0n = manifold.norm(r)
    target = r0n * torch.clamp(r0n ** theta, max=kappa)
    eta = torch.zeros_like(grad)
    Heta = torch.zeros_like(grad)
    k = torch.zeros(rz.shape, dtype=torch.int32, device=grad.device)
    done = rz <= 0
    hit = torch.zeros(rz.shape, dtype=torch.bool, device=grad.device)
    while True:
        active = (k < max_iters) & ~done
        if not bool(active.any()):
            break
        Hd = hvp(delta)
        d_Hd = manifold.inner(delta, Hd)
        alpha = rz / torch.where(torch.abs(d_Hd) < eps, eps, d_Hd)
        e_e = manifold.inner(eta, eta)
        e_d = manifold.inner(eta, delta)
        d_d = manifold.inner(delta, delta)
        e_e_next = e_e + 2.0 * alpha * e_d + alpha * alpha * d_d
        crossing = (d_Hd <= 0) | (e_e_next >= radius * radius)
        disc = torch.clamp(e_d * e_d + d_d * (radius * radius - e_e), min=0.0)
        tau = (-e_d + torch.sqrt(disc)) / torch.where(d_d < eps, eps, d_d)
        step = torch.where(crossing, tau, alpha)
        a = lambda s: s.reshape(s.shape + (1, 1, 1))  # noqa: E731
        eta_n = eta + a(step) * delta
        Heta_n = Heta + a(step) * Hd
        r_n = r + a(alpha) * Hd
        z_n = precond(r_n)
        rz_n = manifold.inner(r_n, z_n)
        converged = manifold.norm(r_n) <= target
        beta = rz_n / torch.where(torch.abs(rz) < eps, eps, rz)
        delta_n = -z_n + a(beta) * delta

        eta = _sel(active, eta_n, eta)
        Heta = _sel(active, Heta_n, Heta)
        r = _sel(active, r_n, r)
        z = _sel(active, z_n, z)
        delta = _sel(active, delta_n, delta)
        rz = _sel(active, rz_n, rz)
        done = _sel(active, done | crossing | converged, done)
        hit = _sel(active, hit | crossing, hit)
        k = _sel(active, k + 1, k)
    return TCGResult(eta=eta, heta=Heta, iters=k, hit_boundary=hit)


class RTRState(NamedTuple):
    X: torch.Tensor
    radius: torch.Tensor
    f: torch.Tensor
    grad_norm: torch.Tensor
    grad_norm_init: torch.Tensor
    iters: torch.Tensor
    accepted: torch.Tensor
    done: torch.Tensor


def _rtr_attempt(problem: Problem, X, fX, g, eg, radius, params: SolverParams):
    """One tCG solve + acceptance test at ``radius``; returns
    (X_new, f_new, accepted)."""
    hvp = lambda V: manifold.ehess_to_rhess(  # noqa: E731
        X, eg, problem.ehess(X, V), V)
    pre = lambda V: manifold.tangent_project(  # noqa: E731
        X, problem.precond(X, V))
    res = truncated_cg(X, g, hvp, pre, radius, params.max_inner_iters,
                       params.tcg_kappa, params.tcg_theta)
    X_prop = manifold.retract(X, res.eta)
    f_prop = problem.cost(X_prop)
    mdec = -(manifold.inner(g, res.eta)
             + 0.5 * manifold.inner(res.eta, res.heta))
    rho = (fX - f_prop) / torch.clamp(mdec, min=1e-30)
    accept = (rho > 0.1) & (f_prop <= fX)
    return _sel(accept, X_prop, X), torch.where(accept, f_prop, fX), accept


def rtr_single_step(problem: Problem, X0: torch.Tensor, params: SolverParams,
                    final_grad_norm: bool = True) -> RTRState:
    """The RBCD local update (reference ``QuadraticOptimizer.cpp:92-110``):
    try a step at the current radius; on rejection shrink it by 4 and retry,
    at most ``max_rejections`` times, else keep the input.  Exits at once
    when the gradient norm is below ``grad_norm_tol`` (``:65-69``)."""
    f = problem.cost(X0)
    eg = problem.egrad(X0)
    g = manifold.rgrad(X0, eg)
    gn0 = manifold.norm(g)
    X = X0
    radius = torch.full_like(gn0, params.initial_radius)
    iters = torch.zeros(gn0.shape, dtype=torch.int32, device=gn0.device)
    accepted = torch.zeros(gn0.shape, dtype=torch.bool, device=gn0.device)
    done = gn0 < params.grad_norm_tol
    while True:
        active = (iters < params.max_rejections) & ~done
        if not bool(active.any()):
            break
        X_new, f_new, acc = _rtr_attempt(problem, X, f, g, eg, radius, params)
        X = _sel(active, X_new, X)
        f = _sel(active, f_new, f)
        radius = _sel(active, torch.where(acc, radius, radius / 4.0), radius)
        iters = _sel(active, iters + 1, iters)
        accepted = _sel(active, acc, accepted)
        done = _sel(active, acc, done)
    gn = gn0
    if final_grad_norm:
        gn = manifold.norm(manifold.rgrad(X, problem.egrad(X)))
    return RTRState(X=X, radius=radius, f=f, grad_norm=gn,
                    grad_norm_init=gn0, iters=iters, accepted=accepted,
                    done=done)

"""Riemannian trust-region (RTR) with Steihaug truncated CG, and RGD
(port of ``dpgo_tpu.ops.solver``).

The JAX package vmaps a ``lax.while_loop`` over agents; here the agent axis
is a leading batch dimension and each loop runs in Python until no batch
element is active, updating only the active elements — the same values the
vmapped loop produces.  With no batch dimension the loops are the plain
single-problem ones.  This is the plain ("ell") formulation of the local
solve and the reference for the arithmetic of the CUDA kernel
(``ops.rtr_kernel``).

The centralized solvers (``rtr_solve``, ``rgd_linesearch``) are Python
loops over device tensors too: each loop test is one host read, so an
``rtr_solve`` outer iteration reads the host once for its stop test and
once per truncated-CG iteration plus one (the tCG's own loop tests).
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


def identity_precond(X, V):
    return V


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
                 kappa: float = 0.1, theta: float = 1.0,
                 fixed_bounds: bool = False) -> TCGResult:
    """Preconditioned Steihaug-Toint truncated CG on the tangent space at X:
    ``min <grad, eta> + 0.5 <eta, H eta>`` s.t. ``||eta|| <= radius``.
    ``fixed_bounds`` runs all ``max_iters`` iterations with the finished
    lanes frozen instead of reading the host to stop early: the same
    result, and no host sync.  The caller sets it from
    ``device.sync_free`` where the loop runs inside a sync-free window
    (the dense round); the centralized solve reads the host every outer
    iteration anyway, and the plain "ell" round is the kernel's plain
    version, so both keep the early exit."""
    dtype = grad.dtype
    eps = torch.full((), 1e-30, dtype=dtype, device=grad.device)
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
    for _ in range(max_iters):
        active = (k < max_iters) & ~done
        if not fixed_bounds and not bool(active.any()):
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


def _rtr_attempt(problem: Problem, X, fX, g, eg, radius, params: SolverParams,
                 fixed_bounds: bool = False):
    """One tCG solve + acceptance test at ``radius``; returns
    (X_new, f_new, accepted, hit_boundary, rho)."""
    hvp = lambda V: manifold.ehess_to_rhess(  # noqa: E731
        X, eg, problem.ehess(X, V), V)
    pre = lambda V: manifold.tangent_project(  # noqa: E731
        X, problem.precond(X, V))
    res = truncated_cg(X, g, hvp, pre, radius, params.max_inner_iters,
                       params.tcg_kappa, params.tcg_theta, fixed_bounds)
    X_prop = manifold.retract(X, res.eta)
    f_prop = problem.cost(X_prop)
    mdec = -(manifold.inner(g, res.eta)
             + 0.5 * manifold.inner(res.eta, res.heta))
    rho = (fX - f_prop) / torch.clamp(mdec, min=1e-30)
    accept = (rho > 0.1) & (f_prop <= fX)
    return (_sel(accept, X_prop, X), torch.where(accept, f_prop, fX), accept,
            res.hit_boundary, rho)


def rtr_solve(problem: Problem, X0: torch.Tensor, params: SolverParams,
              max_iters: int | None = None,
              grad_norm_tol: float | None = None) -> RTRState:
    """Full RTR loop (centralized solves; reference ``trustRegion`` with
    Max_Iteration > 1, ``QuadraticOptimizer.cpp:61-116``): the radius
    shrinks x0.25 when rho < 0.25 and grows x2, up to 5x the initial
    radius, when rho > 0.75 at the boundary; the loop stops at the
    gradient-norm tolerance or after ``max_iters`` iterations.  The
    Euclidean gradient of each iterate is evaluated once."""
    max_iters = params.max_outer_iters if max_iters is None else max_iters
    gtol = params.grad_norm_tol if grad_norm_tol is None else grad_norm_tol
    max_radius = 5.0 * params.initial_radius  # QuadraticOptimizer.cpp:81
    X = X0
    f = problem.cost(X0)
    eg = problem.egrad(X0)
    g = manifold.rgrad(X0, eg)
    gn0 = manifold.norm(g)
    gn = gn0
    radius = torch.full_like(gn0, params.initial_radius)
    accepted = torch.zeros(gn0.shape, dtype=torch.bool, device=gn0.device)
    done = gn0 < gtol
    iters = 0
    while iters < max_iters and not bool(done):
        X, f, accepted, hit, rho = _rtr_attempt(problem, X, f, g, eg,
                                                radius, params)
        radius = torch.where(
            rho < 0.25, radius * 0.25,
            torch.where((rho > 0.75) & hit,
                        torch.clamp(2.0 * radius, max=max_radius), radius))
        eg = problem.egrad(X)
        g = manifold.rgrad(X, eg)
        gn = manifold.norm(g)
        done = gn < gtol
        iters += 1
    return RTRState(X=X, radius=radius, f=f, grad_norm=gn,
                    grad_norm_init=gn0,
                    iters=torch.full((), iters, dtype=torch.int32,
                                     device=gn0.device),
                    accepted=accepted, done=done)


def rtr_single_step(problem: Problem, X0: torch.Tensor, params: SolverParams,
                    final_grad_norm: bool = True,
                    fixed_bounds: bool = False) -> RTRState:
    """The RBCD local update (reference ``QuadraticOptimizer.cpp:92-110``):
    try a step at the current radius; on rejection shrink it by 4 and retry,
    at most ``max_rejections`` times, else keep the input.  Exits at once
    when the gradient norm is below ``grad_norm_tol`` (``:65-69``).
    ``fixed_bounds`` runs every loop (attempts and tCG) to its bound with
    the finished lanes frozen: the same result with no host read."""
    f = problem.cost(X0)
    eg = problem.egrad(X0)
    g = manifold.rgrad(X0, eg)
    gn0 = manifold.norm(g)
    X = X0
    radius = torch.full_like(gn0, params.initial_radius)
    iters = torch.zeros(gn0.shape, dtype=torch.int32, device=gn0.device)
    accepted = torch.zeros(gn0.shape, dtype=torch.bool, device=gn0.device)
    done = gn0 < params.grad_norm_tol
    for _ in range(params.max_rejections):
        active = (iters < params.max_rejections) & ~done
        if not fixed_bounds and not bool(active.any()):
            break
        X_new, f_new, acc, _, _ = _rtr_attempt(problem, X, f, g, eg, radius,
                                               params, fixed_bounds)
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


def rgd_step(problem: Problem, X0: torch.Tensor,
             stepsize: float) -> torch.Tensor:
    """One fixed-step Riemannian gradient descent step (reference
    ``gradientDescent``, ``QuadraticOptimizer.cpp:124-149``: project, scale
    by -stepsize, retract; preconditioning deliberately off)."""
    g = manifold.rgrad(X0, problem.egrad(X0))
    return manifold.retract(X0, -stepsize * g)


def rgd_linesearch(problem: Problem, X0: torch.Tensor, max_iters: int = 10,
                   grad_norm_tol: float = 1e-2, initial_step: float = 1.0,
                   backtrack: float = 0.5, armijo: float = 1e-4,
                   max_backtracks: int = 25) -> torch.Tensor:
    """Armijo line-search Riemannian steepest descent (ROPTLIB's RSD as
    used by ``gradientDescentLS``, ``QuadraticOptimizer.cpp:151-172``):
    the step backtracks from ``initial_step`` until the Armijo condition
    holds (at most ``max_backtracks`` tries), and a step that raises the
    cost is not taken."""
    X = X0
    f = problem.cost(X0)
    g = manifold.rgrad(X0, problem.egrad(X0))
    gn = manifold.norm(g)
    k = 0
    while k < max_iters and bool(gn >= grad_norm_tol):
        gsq = manifold.inner(g, g)
        step = torch.full_like(f, initial_step)
        for _ in range(max_backtracks):
            f_try = problem.cost(manifold.retract(X, -step * g))
            if bool(f_try <= f - armijo * step * gsq):
                break
            step = step * backtrack
        X_new = manifold.retract(X, -step * g)
        f_new = problem.cost(X_new)
        keep = f_new <= f
        X = torch.where(keep, X_new, X)
        f = torch.where(keep, f_new, f)
        g = manifold.rgrad(X, problem.egrad(X))
        gn = manifold.norm(g)
        k += 1
    return X


class RefineStep(NamedTuple):
    D: torch.Tensor         # [A, n, r, k] accepted correction (or the input)
    attempts: torch.Tensor  # [A]
    accepted: torch.Tensor  # [A] bool
    df0: torch.Tensor       # [A] f(R + D) - f(R) at the input
    df: torch.Tensor        # [A] the same at the output
    grad_norm: torch.Tensor  # [A] gn0
    iters: torch.Tensor     # [A] int32 tCG iterations over all attempts


def refine_attempts(Y, D, g, radius0, hvp, precond, dcost, retract, *,
                    max_iters: int, kappa: float, theta: float,
                    max_rejections: int, grad_tol: float) -> RefineStep:
    """The re-centered single-step RTR on the correction ``D`` (expansion
    point ``Y = R + D``, Riemannian gradient ``g``), batched over agents:
    the early exit when ``|g| < grad_tol``, then at most ``max_rejections``
    attempts of {tCG at the radius, ``retract(eta)``, the cost increment
    ``dcost``, accept when rho > 0.1 and the increment did not rise, else
    radius / 4} from ``radius0`` — the loop of the JAX package's
    ``refine._agent_refine`` and of its fused kernel."""
    gn0 = manifold.norm(g)
    df0 = dcost(D)
    k_att = torch.where(gn0 < grad_tol, float(max_rejections), 0.0).to(
        g.dtype)
    radius = radius0
    D_best, df_best = D, df0
    accepted = torch.zeros(gn0.shape, dtype=torch.bool, device=g.device)
    iters = torch.zeros(gn0.shape, dtype=torch.int32, device=g.device)
    while True:
        active = (k_att < max_rejections) & ~accepted
        if not bool(active.any()):
            break
        res = truncated_cg(Y, g, hvp, precond, radius, max_iters, kappa,
                           theta)
        D_prop = retract(res.eta)
        df_prop = dcost(D_prop)
        mdec = -(manifold.inner(g, res.eta)
                 + 0.5 * manifold.inner(res.eta, res.heta))
        rho = (df0 - df_prop) / torch.clamp(mdec, min=1e-30)
        ok = (rho > 0.1) & (df_prop <= df0) & active
        D_best = _sel(ok, D_prop, D_best)
        df_best = torch.where(ok, df_prop, df_best)
        radius = torch.where(active & ~ok, radius / 4.0, radius)
        k_att = torch.where(active, k_att + 1.0, k_att)
        iters = torch.where(active, iters + res.iters, iters)
        accepted = accepted | ok
    return RefineStep(D_best, k_att, accepted, df0, df_best, gn0, iters)
